"""The pipeline engine (the port of ``repro.pipeline``): folded onto one
device on a ``LocalMesh``, one process a mesh position on a
``RankMesh`` (``ranks.RankPool`` or ``torchrun`` start the processes;
``sharding.param_shardings`` says which shard each rank holds)."""
from repro_torch.pipeline.sharding import (AXIS_DATA, AXIS_POD, AXIS_STAGE,
                                           AXIS_TENSOR, block_specs,
                                           cache_specs, gather_params,
                                           param_shardings, shard_params)
from repro_torch.pipeline.pipeline_step import (pipeline_forward,
                                                pipeline_decode,
                                                make_train_step,
                                                make_serve_step)
