from .average_meter import AverageMeter
from .common import (
    get_time_stamp,
    parse_diff_env_kwargs,
    print_error,
    print_info,
    print_ok,
    print_warning,
    seeding,
)
from .dataset import CriticDataset
from .running_mean_std import RunningMeanStd
from .time_report import TimeReport, Timer
from . import profiling
