from .running_mean_std import RunningMeanStd
