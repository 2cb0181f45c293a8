"""ambigram_tpu — a JAX Breakage-Fusion-Bridge (BFB) reconstruction engine
that runs its search on a GPU.

A from-scratch, JAX/XLA re-design of the capabilities of
deepomicslab/Ambigram (reference surveyed in /root/repo/SURVEY.md):

- LH/JUNCS/PROP ingestion into dense array representations
  (reference: src/Graph.cpp:109-405).
- Pattern/loop enumeration and the BFB copy-number fitting program as
  constraint *tensors* rather than a COIN-OR matrix
  (reference: src/LocalGenomicMap.cpp:4397-4752).
- A JAX-native solver (batched matmul scoring on the device + branch
  and bound)
  replacing the external `cbc` process (reference: localhap.cpp:179-181).
- Exact host-side path replay (DAG, topological orders, splicing)
  matching the reference's output strings byte for byte
  (reference: src/LocalGenomicMap.cpp:3276-3697).
- Data-parallel sharding of independent cases / search branches over a
  `jax.sharding.Mesh` (no analog in the single-threaded reference).
"""

__version__ = "0.1.0"

from ambigram_tpu.model.genome import Genome  # noqa: F401
