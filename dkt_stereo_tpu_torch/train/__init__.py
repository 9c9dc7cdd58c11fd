from dkt_stereo_tpu_torch.train.state import DKTHyperParams, DKTTrainState, make_optimizer


def __getattr__(name):
    # the step (and through it the models) loads at first use: the models
    # import this package's profiling spans
    if name in ("create_dkt_state", "make_dkt_train_step"):
        from dkt_stereo_tpu_torch.train import dkt_step

        return getattr(dkt_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
