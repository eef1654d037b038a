"""Distribution layer over ``torch.distributed``: ranks and collectives
(``launch``), the ``(data, model)`` mesh and its layouts (``mesh``), the
GPipe schedule (``pipeline``) and the multi-rank dry run (``dryrun``)."""
from packppi_torch.parallel.mesh import (Mesh, ShardedParams, batch_rows,  # noqa: F401
                                         gather_rows, make_mesh, param_shards,
                                         seq_batch_shards)
from packppi_torch.parallel.pipeline import pipeline_apply  # noqa: F401
