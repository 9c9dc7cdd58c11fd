from dkt_stereo_tpu_torch.train.state import DKTHyperParams, DKTTrainState, make_optimizer
from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
