"""Data layer (counterpart of ``alink_tpu.data``): DFW manifests, person-
padded stacks, index-space pair sampling, synthetic trees.  numpy and PIL
only; the JAX package's ``data`` cannot be imported here because its
``__init__`` pulls in jax.
"""

from alink_tpu_torch.data.loader import PersonStacks, load_person_stacks
from alink_tpu_torch.data.manifest import DFWPerson, lookup_file, scan_dfw
from alink_tpu_torch.data.pairs import (all_pairs_index,
                                        balanced_pair_batches,
                                        split_disguise_data)
from alink_tpu_torch.data.synth import (dfw_test_mask, make_synthetic_dfw,
                                        make_synthetic_dfw_test)

__all__ = ["PersonStacks", "load_person_stacks", "DFWPerson", "lookup_file",
           "scan_dfw", "all_pairs_index", "balanced_pair_batches",
           "split_disguise_data", "make_synthetic_dfw",
           "make_synthetic_dfw_test", "dfw_test_mask"]
