from dkt_stereo_tpu_torch.eval.metrics import D1_metric, EPE_metric, Thres_metric
from dkt_stereo_tpu_torch.eval.validate import (
    make_forward_fn,
    validate_booster,
    validate_eth3d,
    validate_kitti,
    validate_middlebury,
    validate_things,
)
