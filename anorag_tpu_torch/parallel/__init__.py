from anorag_tpu_torch.parallel.engine import ParallelEngine, ParallelTask, Strategy, TaskProcessor
from anorag_tpu_torch.parallel.interface import ParallelInterface, create_parallel_interface
from anorag_tpu_torch.parallel.mesh import make_mesh, shard_rows

__all__ = ["ParallelEngine", "ParallelTask", "Strategy", "TaskProcessor",
           "ParallelInterface", "create_parallel_interface", "make_mesh",
           "shard_rows"]
