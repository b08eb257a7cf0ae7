"""Data layer (counterpart of ``alink_tpu.data``): DFW and Multi-PIE
manifests, person-padded stacks, index-space pair sampling, synthetic trees
(numpy and PIL), and the device-feed prefetcher (``prefetch``).  The JAX
package's ``data`` cannot be imported here because its ``__init__`` pulls
in jax.
"""

from alink_tpu_torch.data.loader import PersonStacks, load_person_stacks
from alink_tpu_torch.data.manifest import (DFWPerson, lookup_file,
                                           mtp_qualifies, scan_dfw, scan_mtp)
from alink_tpu_torch.data.prefetch import (DevicePrefetcher,
                                           prefetch_to_device)
from alink_tpu_torch.data.pairs import (all_pairs_index,
                                        all_pairs_minibatch,
                                        balanced_pair_batches, gather_pairs,
                                        mtp_all_pairs_index,
                                        mtp_all_pairs_minibatch,
                                        split_disguise_data)
from alink_tpu_torch.data.synth import (dfw_test_mask, make_synthetic_dfw,
                                        make_synthetic_dfw_test,
                                        make_synthetic_mtp)

__all__ = ["PersonStacks", "load_person_stacks", "DFWPerson", "lookup_file",
           "mtp_qualifies", "scan_dfw", "scan_mtp", "all_pairs_index",
           "all_pairs_minibatch", "balanced_pair_batches", "gather_pairs",
           "mtp_all_pairs_index", "mtp_all_pairs_minibatch",
           "split_disguise_data", "make_synthetic_dfw",
           "make_synthetic_dfw_test", "make_synthetic_mtp", "dfw_test_mask",
           "DevicePrefetcher", "prefetch_to_device"]
