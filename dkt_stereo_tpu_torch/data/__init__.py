from dkt_stereo_tpu_torch.data import png, readers
