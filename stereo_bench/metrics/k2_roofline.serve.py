"""K2 (``csrc/encoder_stage.cu``), the fused feature encoder's four stages
a frame on both images: launches times a stage's bound over their device
time, in percent (:func:`stereo_bench.bounds.k2_fwd_roofline`)."""

from stereo_bench.bounds import k2_fwd_roofline as read  # noqa: F401
