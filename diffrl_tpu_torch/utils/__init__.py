from .average_meter import AverageMeter
from .common import print_info
from .dataset import CriticDataset
from .running_mean_std import RunningMeanStd
from .time_report import TimeReport, Timer
