"""Multi-process layouts over `torch.distributed` (port of
`video_llava_seg_tpu/parallel/`): the mesh and its parameter rules
(`mesh.py`), the process-group helpers and tensor collectives
(`collectives.py`), tensor parallelism of the LLM for serving and
training (`tensor_parallel.py`), data-parallel / FSDP training on the
data x model mesh (`fsdp.py`) and ring-attention context parallelism
over a 'seq' group (`ring_attention.py`).
"""

from video_llava_seg_torch.parallel.collectives import (  # noqa: F401
    all_gather_objects,
    initialize_distributed,
    is_main_process,
    print_once,
    process_index,
    reduce_dict,
    synchronize,
)
from video_llava_seg_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    gather_params,
    param_specs,
    shard_params,
)
from video_llava_seg_torch.parallel.ring_attention import (  # noqa: F401
    cp_forward,
    create_seq_mesh,
    ring_attention_local,
)
