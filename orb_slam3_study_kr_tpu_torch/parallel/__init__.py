"""Multi-device scale-out: the landmark-sharded Schur BA over several
shards (devices of this process, and processes of a torch.distributed
group), its reduced camera system summed across them."""

from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import (
    distributed_bundle_adjust, make_ba_mesh,
)
