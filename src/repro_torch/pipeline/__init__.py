"""The pipeline engine on one device (the port of ``repro.pipeline``).
``param_shardings`` (``NamedSharding`` over a device mesh) is not here: it
waits for the multi-GPU backend of ROADMAP Queue 1 item 12."""
from repro_torch.pipeline.sharding import (AXIS_DATA, AXIS_POD, AXIS_STAGE,
                                           AXIS_TENSOR, block_specs,
                                           cache_specs)
from repro_torch.pipeline.pipeline_step import (pipeline_forward,
                                                pipeline_decode,
                                                make_train_step,
                                                make_serve_step)
