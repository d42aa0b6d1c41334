"""Data-parallel training and sharded evaluation over a process group, the
port of ``sipmask_tpu/parallel``."""

from .collect import collect_results_cpu, collect_results_gather
from .mesh import (all_reduce_sum_, barrier, destroy_distributed,
                   global_sum, init_distributed, process_shard_args,
                   rank_device)
