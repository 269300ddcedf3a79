"""Device-parallel sweeps (counterpart of `colormipsearch_tpu/parallel/`):
the two-phase sweep over a process's devices, the dense engine's sweeps
over a ("mask", "target") mesh, and the multi-process layer over
torch.distributed (gloo)."""

from .mesh import make_pair_mesh
from .sweep import (local_pixel_sweep, merge_topk, sharded_pixel_sweep,
                    sharded_pixel_sweep_topk, sharded_shape_scores)
from .multihost import (distribute, global_pair_mesh,
                        maybe_init_distributed, process_block)
