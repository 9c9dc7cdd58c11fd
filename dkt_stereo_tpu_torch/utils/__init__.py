from dkt_stereo_tpu_torch.utils.visualization import (
    disp_error_map,
    disp_to_color,
    epe_on_depth,
)
from dkt_stereo_tpu_torch.utils.logging import Logger, save_images, save_scalars
