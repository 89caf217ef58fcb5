"""Parallelism over torch.distributed process groups (counterpart of
ktransformers_tpu/parallel/): a (dp, ep, tp) grid of ranks with one
process group per axis (mesh.py), the context that the model forward
reads (context.py), the collectives the layers call, with their gradients
(collectives.py), expert parallelism that serves and trains (ep.py),
per-rank parameter and cache slices for tensor parallelism (shardings.py),
pipeline parallelism over a pp axis, forward and gradient (pp.py), and the
multi-process start (distributed.py). The ZeRO-1 trainer over dp is
sft/train.py's Trainer(mesh=...).

The JAX package leaves tensor parallelism to GSPMD; here each rank holds
its own slice and the layers run the collectives themselves: an
all-reduce over tp after every row-parallel product (o_proj, each MLP's
down), an all-gather over tp of the logits, and over ep the combine of the
expert shards. A rank computes on the card unless its caller names the
CPU.
"""

from ktransformers_tpu_torch.parallel.mesh import MeshConfig, make_mesh

__all__ = ["MeshConfig", "make_mesh"]
