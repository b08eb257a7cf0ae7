"""The parallel layer on ``torch.distributed`` (counterpart of
``alink_tpu/parallel/``).

The JAX package runs one controller over a (data, model) ``Mesh`` of
devices, with ``shard_map`` bodies and ``psum`` / ``ppermute``.  Here one
rank drives one device: a ``DeviceMesh`` with the dimension names
("data", "model"), ``all_reduce`` over one axis's group in place of
``psum``, ``all_gather`` to reassemble outputs, ``batch_isend_irecv`` in
place of ``ppermute`` and ``DTensor`` with ``Shard(0)`` / ``Replicate()``
in place of a ``NamedSharding``-ed array.  NCCL carries CUDA tensors,
gloo CPU tensors.

Every sharded op is called by every rank of the mesh with the same full
input; each rank computes its own shard on its own device and returns the
full result.  A multi-rank run is ``torchrun --nproc-per-node N`` (or
``python -m alink_tpu_torch.tools.dryrun_multichip --ranks N``, which
spawns a gloo world on the CPU).
"""

from alink_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    create_mesh,
    replicated_sharding,
    shard_batch,
)
from alink_tpu_torch.parallel.distributed import (  # noqa: F401
    create_multihost_mesh,
    global_batch_from_local,
    initialize,
    process_shard,
)
from alink_tpu_torch.parallel.ops import (  # noqa: F401
    sharded_committee_probs,
    sharded_face_pipeline,
    sharded_featurize,
)
from alink_tpu_torch.parallel.tp import (  # noqa: F401
    arcface_tp_apply,
    tp_param_specs,
)
from alink_tpu_torch.parallel.pp import arcface_pp_apply  # noqa: F401
