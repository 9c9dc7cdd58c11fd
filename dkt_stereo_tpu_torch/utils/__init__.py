from dkt_stereo_tpu_torch.utils.visualization import (
    disp_error_map,
    disp_to_color,
    epe_on_depth,
)
