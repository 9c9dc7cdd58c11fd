#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dkt_stereo_tpu_torch) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its result on a line of its own; any failure or
out-of-tolerance result raises and exits non-zero:

  1. device: the card's name and power limit; builds the kernels from
     dkt_stereo_tpu_torch/csrc with nvcc (in parallel), times the build and
     prints each kernel's registers, spills and static shared memory as
     ptxas reported them, and the dynamic shared memory of K2's forward and
     K3 blocks, and of the K1 forward and backward, K4 forward and backward
     and K5 forward and backward blocks (each checked against the
     wrapper's plan);
  2. K1 (corr lookup) vs its plain version, the output's dtype and strides
     those of plain.permute(0, 3, 1, 2).to(dt), bf16 within one bf16 step of
     the plain value rounded once: at the frame's 1x184x320 (W2
     320/160/80/40), the training step's 8x80x180 (180/90/45/22) and a
     ragged 2x7x37 (37/18/9/4), every pairing of fp32 and bf16 levels and
     outputs at the ragged shape, 5 levels with radius 12; coordinates far
     out of range and NaN (NaN outputs where the plain version has them);
     device times (a CUDA graph of launches) beside the host's time a call,
     the bound, the bytes the windows' 32-byte sectors move, the plain
     version and F.grid_sample over the four levels, at the frame and the
     step;
  3. K2 (encoder stage) vs its plain version, every variant (plain, v,
     emit_h, relu_u off, and all three together) with positive biases, so
     that a halo the prologue did not zero fails at every border pixel, at
     a ragged (3, 37, 45, 64) and at (2, 13, 61, 64), whose tiles straddle
     samples; at (2, 736, 1280, 64) bf16 every variant, the plain stage and
     the one with v and emit_h timed with their bounds, with cuDNN's conv
     of the same shape as yardstick;
  4. full-model parity, kernels vs plain path (the plain path is the CPU's),
     fp32 with TF32 off, 1x256x512, 2 iterations;
  5. the main path: configs/raft_stereo/pallas.json, bf16, 1x736x1280,
     32 iterations, seeded random weights, through make_forward_fn/_run_one,
     counting the kernel launches of the timed frames;
  6. a per-kernel profile of one main-path frame (torch.profiler);
  7. K1's backward (corr lookup bwd) vs its plain version at the training
     step, the frame and the ragged shape of phase 2 and at 5 levels with
     radius 12, bf16 and fp32 gradients and levels, NaN coordinates (NaN
     rows where the plain version has them), two launches bit for bit, and
     the adjoint check <K1(v), g> = <v, K1^T(g)> against the forward
     kernel; device times at the step and the frame beside the bound, the
     plain version and grid_sample's backward, and the time autograd spends
     summing the per-iteration d/dpyramid;
     K2's VJP (EncoderStage's backward: the adjoint conv as one launch of
     its own wgmma + TMA kernel in bf16, of the fp32 stage kernel without
     statistics in fp32, the rest PyTorch) vs its plain twin, all seven
     cotangents, plain and residual+emit_h forms, at the training shape
     (16, 320, 720, 64) bf16, a small fp32 case with TF32 off and a ragged
     (3, 37, 45, 64) bf16; the adjoint kernel alone at (2, 13, 61, 64),
     whose tiles straddle samples; the adjoint check <K2(x), g> = <x,
     K2^T(g)> in fp32; the times of the adjoint launch, the whole stage
     backward and the plain twin, with cuDNN's dgrad and wgrad as
     yardsticks;
  8. DKT train-step parity, kernels (card) vs plain path (CPU): fp32, TF32
     off, 1x64x128, 2 student and 2 teacher iterations, same weights and
     draws; losses, and gradients by module (fnet, cnet, update block);
  9. the training path: configs/raft_stereo/train.json as shipped (bf16,
     reg_cuda, remat_iters), B=8, 320x720, 16 student and 32 teacher
     iterations, through create_dkt_state/make_dkt_train_step on seeded
     synthetic batches: 1 warm-up and 5 timed steps with the time of each
     part, exact K1 launch counts, the gradients K1's backward had to copy
     to dense (0 with cuDNN's channels-last gradients), a profile of one
     step and an estimate of the untraced idle share;
 10. K4 (IGEV geo lookup) vs its plain version at the IGEV main path's
     shapes (1x184x320, geo D 48/24 x 8 channels, corr W2 320/160) and past
     the kernels' former caps (5 levels at radius 12), bf16 and fp32
     pyramids, disparities far out of range, negative, above D and NaN
     included (NaN outputs exactly where the plain version has them);
     device times (a CUDA graph) at this frame and at the IGEV
     training step's 8x80x184 beside their bounds, the plain version and
     upstream IGEV's grid_sample form (one call a volume and level); the
     register window against the sliding window at radius 4, the latter
     built from the kernel's source with the register path turned off,
     in turns (register, sliding, register, sliding);
 11. K4's backward (the dgeo and the dcorr kernel) vs its plain version at
     the IGEV training shapes (8x80x184, geo D 48/24 x 8, corr W2 184/92)
     and at 5 levels with radius 12, bf16 and fp32 pyramids, the same
     hostile disparities (a NaN one gives NaN rows where the plain version
     has them), the adjoint check <K4(v), g> = <v, K4^T(g)> against the
     forward kernel at both, over the finite pixels; device times (a CUDA
     graph) beside the bound, the plain version and grid_sample's backward
     for the volumes; and the time autograd spends summing the
     per-iteration d/dgeo in bf16;
 12. IGEV parity, kernels (card) vs plain path (CPU): fp32, corr_dtype
     float32, TF32 off, 1x256x512, 2 iterations;
 13. the IGEV main path: configs/igev_stereo/pallas.json as shipped, bf16,
     1x736x1280, 32 iterations, seeded random weights, through
     make_forward_fn/_run_one, with exact launch counts (32 K4 a frame, no
     K1 or K2), and a profile of one frame
     (chiprun_out/chip_smoke_igev_profile.txt);
 14. IGEV DKT train-step parity, kernels (card) vs plain path (CPU): fp32,
     TF32 off, 1x64x128, 2 student and 2 teacher iterations,
     freeze_backbone off so that both backward kernels run (exact counts
     8/2/2), same weights and draws; losses, and gradients by module;
 15. the IGEV training path: configs/igev_stereo/train.json as shipped
     (bf16, reg_cuda, remat_iters, freeze_backbone), B=8, 320x736, 16
     student and 32 teacher iterations: 1 warm-up and 5 timed steps with
     the time of each part, exact launch counts (96 K4, 16 dgeo, 0 dcorr a
     step, no K1 or K2), a profile of one step
     (chiprun_out/chip_smoke_igev_train_profile.txt) and an estimate of the
     untraced idle share;
 16. K3 (the correlation lookup without a volume) vs its plain version at
     the full-resolution path's 1x496x720 (D 256, widths 720/360/180/90)
     and at a ragged 2x7x37 (widths 37/18/9/4), bf16 and fp32 features:
     random coordinates, far out of range, negative and NaN included (NaN
     where the plain version has NaN; bands of many pieces), a frame's coordinates, and nearly
     constant ones (every band one piece); at 2x5x150 depths 3 and 20 (no
     TMA) and 5 levels with radius 12; timed at random and at frame
     coordinates, each beside its bound, with the materialized route
     (fused pyramid + K1) at the same shapes as yardstick;
 17. K3's VJP (the recompute backward of CorrLookupAlt) vs autograd of the
     plain version on the card, at 2x40x90, fp32 and bf16, NaN coordinates
     included (the forward's and the gradients' NaN where the plain
     version's are);
 18. parity of RAFT with alt_cuda (K3, card) and with alt (plain, card) vs
     the plain path on the CPU: fp32, TF32 off, 1x256x512, 2 iterations;
 19. the full-resolution path: configs/raft_stereo/alt_pallas.json as
     shipped (bf16, alt_cuda, pallas_encoder), B=1, 1984x2880, 32
     iterations, through make_forward_fn/_run_one: K2 vs its plain version
     at this shape, the plain stage and the one with v and emit_h, each
     timed beside its bound, 1 warm-up and 5 timed frames with exact launch
     counts (32 K3 and 4 K2 a frame), peak memory, the corr section's
     persistent bytes against the volume pyramid, a profile of one frame
     (chiprun_out/chip_smoke_alt_profile.txt) with K3's and K2's time a
     launch, and one pallas.json (reg_cuda) frame at the same size;
 20. K5 (PCVNet's Gaussian row sampling, every level in one launch,
     writing the motion encoder's folded input in the compute dtype) vs
     fold_lookup(plain).to(dt), bit for bit, dtype, shape and strides
     included, at base.json's 1/4 grid of 736x1280 (1x184x320, widths
     320/80/20), fast.json's 1/8 grid (1x92x160, widths 160/80/40), the PCV
     training step's 8x80x180 (180/45/11) and a ragged 2x7x37 (37/9/2), fp32
     and bf16 volumes and outputs, positions of a
     random mixture plus negative, past-the-row, far out of range,
     exact-integer and NaN ones (NaN where the plain version has NaN);
     device times (a CUDA graph) at the frame and the step beside their
     bounds, the plain version, grid_sample over the three levels and a
     device copy of the kernel's bytes; the motion encoder on the kernel's
     channels-last output and on an NCHW copy of it (device time, kernels by
     bucket); K5's autograd Function launching the backward, and copying an
     NCHW gradient once; 5 levels that need a gradient, forward and backward
     through the kernels (the backward once took at most 4);
 21. PCVNet parity: base.json and fast.json in fp32, TF32 off, 1x256x512,
     2 iterations, exactly 2 K5 launches each; K5 vs the plain lookup with
     the rest of the model on the card, and kernels (card) vs plain path
     (CPU) with the plain-on-card vs CPU floor;
 22. the PCV main path: configs/pcvnet/base.json as shipped (bf16, K5),
     B=1, 736x1280, 32 iterations, through make_forward_fn/_run_one: 1
     warm-up and 20 timed frames with exact launch counts (32 K5 a frame,
     no other kernel), peak memory and a profile of one frame
     (chiprun_out/chip_smoke_pcv_profile.txt); then fast.json at the same
     size, 1 warm-up and 5 timed frames, 32 K5 a frame;
 23. K5's backward (csrc/row_sample_bwd.cu: dvol of every level and dpos in
     one launch, a warp a pixel, taps binned by column, g read folded and
     in the compute dtype, a level table for up to 32 levels) vs its plain
     version at the PCV training grid (8x80x180, widths 180/45/11), the
     inference grid (1x184x320), a ragged 2x7x37, and at 5 (2x7x37) and 8
     levels (2x8x300, cf 2), bf16 and fp32 levels and gradients, the hostile
     positions of phase 20 (a NaN one gives NaN in its pixel's rows of
     every level and 0 dpos, as the plain version), two launches bit for
     bit, the adjoint check <K5(v), g> = <v, K5^T(g)> against the
     forward kernel, device times (a CUDA graph) beside the bound, the
     plain version and grid_sample's backward over the three levels, the
     unfold copy and fp32 cast that an unfolded gradient would need, and
     the time autograd spends summing the per-iteration dvol in bf16;
 24. PCV DKT train-step parity: base.json in fp32, TF32 off, 1x64x128, 2
     student and 2 teacher iterations (exact counts: 6 K5, 2 K5 backward),
     kernels vs the plain lookup both on the card and card vs the CPU with
     the plain-on-card floor; losses and gradients by module; then the
     student's gradient at 4 iterations through the kernels, the plain
     lookup and with the positions cut, which must move the update
     block's gradient;
 25. the PCV training path: configs/pcvnet/base.json as shipped in train
     mode (bf16), B=8, 320x720, 16 student and 32 teacher iterations,
     through create_dkt_state/make_dkt_train_step on seeded synthetic
     batches: 1 warm-up and 5 timed steps with the time of each part, exact
     launch counts (80 K5 and 16 K5 backward a step), peak memory and a
     profile of one step (chiprun_out/chip_smoke_pcv_train_profile.txt);
 26. the JAX package's ENCODER_VJP_r05.json protocol: every parameter
     gradient of BasicEncoder(instance, downsample 2) at 2x320x704 through
     the fused path (K2 and its VJP, 4 + 4 launches) vs the unfused port
     path, fp32 with TF32 off (worst leaf <= 1e-2) and bf16 against the
     fp32 truth (fused deviation <= 2 x unfused + 1e-3); the stem and
     layer1 conv biases get no gradient;
 27. DKT train-step parity as phase 8 for train.json with pallas_encoder
     merged in (exact counts 8 K1, 2 K1 bwd, 12 K2, 4 K2 adjoint), with a
     nonzero gradient on the fnet's layer1;
 28. the fused training paths at B=8, 320x720, 16 student / 32 teacher
     iterations, exact launch counts on each: train.json with
     pallas_encoder merged in (96 K1, 16 K1 bwd, 12 K2, 4 K2 adjoint a
     step; 1 warm-up and 5 timed steps, peak memory, the unfused step's
     mean of phase 9 beside it, a profile with the K2 adjoint in a bucket
     of its own, chiprun_out/chip_smoke_fused_train_profile.txt),
     alt_pallas.json as shipped (80 K3, 12 K2, 4 adjoint; 1 + 3 steps) and
     pallas.json as shipped (80 K1, 16 K1 bwd, 12 K2, 4 adjoint; one step);
28a. GWCNet and CGI-Stereo parity: configs/gwcnet/base_g.json, base_gc.json
     and configs/cgi/base.json, the card vs the CPU from the same seeded
     weights, fp32 with TF32 off, 1x256x512, maxdisp 192 (GWCNet's batch
     norms calibrated: shifts 1, running statistics moved toward the pair's
     own by the port's train_bn update): GWCNet's disparity within 5e-2 px;
     CGI's pre-regression cost within 5e-4, its disparity's p90 within 1e-4
     px and its max below 4 px + 1e-3 (top-2 tie flips); no port kernel
     launched (neither model has one);
28b. the three as shipped (bf16), B=1, 736x1280 (the JAX zoo bench's
     geometry), seeded random weights, through make_forward_fn/_run_one: 1
     warm-up and 20 timed frames, peak memory and a profile of one frame
     each (chiprun_out/chip_smoke_{gwc_g,gwc_gc,cgi}_profile.txt);
28c. one DKT step of base_gc.json and of cgi/base.json, card vs CPU, fp32,
     TF32 off, 1x64x128, same weights, batch and draws: losses within 1e-3
     relative, gradients by module within 0.1 relative L2 (0.05 over all),
     or twice the CPU's own chaos floor from a 1e-5 weight nudge;
28d. the DKT step as shipped (bf16, frozen BN) at B=8: base_gc.json at the
     CLI's 320x720, cgi/base.json at 320x736 (its hourglass, like IGEV's,
     needs multiples of 32): 1 warm-up and 5 timed steps with the device
     time of each part, ok on every step, every student tensor with a
     gradient moved, the teacher and BN statistics bit-identical, peak
     memory and a profile of one step
     (chiprun_out/chip_smoke_{gwc_gc,cgi}_train_profile.txt);
 29. the eval path: a synthetic KITTI-2015 tree of 56 frames at KITTI's
     375x1242 written with data/png.py (shifted pairs, uint16 disp_occ_0
     maps with invalid pixels) and a seeded random RAFT .pth written with
     torch.save, through cli.eval.main on the card: pallas.json, 32
     iterations, fp32 (the eval protocol) and with --mixed_precision, each
     with EPE, D1, the validator's kitti-2015-fps (frames 52-56), ms/frame,
     peak memory and exact launches (32 K1 and 4 K2 a frame); then
     base.json on 2 frames at 2 iterations on the card and on the CPU (EPE
     within 5e-3 px, D1 within the share of pixels whose CPU error lies
     within 5e-3 px of 3 px);
 30. IGEV pallas.json and PCVNet base.json through cli.eval.main, seeded
     random .pth files, one frame, 32 iterations: finite metrics, exactly
     32 K4 and 32 K5 launches; GWCNet base_gc.json and CGI base.json on the
     same frame from a .pth through cli.export's round trip (the seeded
     .pth into a port checkpoint and back, bit for bit), no port kernel;
 31. cli.demo.main on 2 pairs with --save_numpy --save_ply (base.json, 32
     iterations): the PNG decodes to disp_to_color of the .npy, the .npy is
     -1 x the eval forward's output on the card within 1e-3 px, the PLY
     has a vertex for every pixel with a nonzero disparity;
 32. dkt_stereo_tpu_torch.bench in-process (pallas.json, 1x736x1280, 32
     iterations, 3 warm-up frames and 5 batches of 10), its JSON line
     printed.

The training side (phases 33-38, in the same temporary directory), then the
"kernels" JSON line and the card's line:

 33. the host data path: a synthetic Booster quarter-resolution tree
     (6 scenes at 752x1028, disp_00.npy) and a Scene Flow TRAIN tree
     (540x960, PFM), their PNGs written with adaptive filters; the host
     seconds a sample takes to read and to augment on one worker (Booster
     sparse at the RAFT recipe's 480x896 crop, Scene Flow dense at
     320x720); the loader's batches a second at batch 2 with the CLI's
     --num_workers over the tree as the CLI builds it; the RAFT recipe's
     step fed by the loader with 0 workers (batches built in the step's
     process: the step's own time without the workers' load) and 4 (the
     wait for the batch and the step's own host time beside them);
     a batch's keys, shapes, dtypes, ranges and pinned memory;
 34. run_scripts/raft_stereo/ft_booster.sh through cli.train (train.json,
     batch 2, 480x896, 16 iterations, lr 1e-5, seeded random .pth, 4
     loader workers): stage 1 in a subprocess killed after its mid-run
     save and that save's
     validation, the same command with --auto_resume in this process (the
     save restored bit for bit: step, weights, optimizer state; the run
     ends at step_{num_steps+1}), stage 2 with --restore_weights_only and
     --restore_ckpt_T (step 0, a fresh optimizer, the teacher the .pth bit
     for bit), cli.export of stage 2's student, and cli.eval on two Booster
     frames with the export and with stage 2's checkpoint --which ema; per
     stage ms/step, the loader's wait, the step's own time, peak memory and
     the validators' keys; exactly 96 K1 and 16 K1-backward launches a
     step (the subprocess's counters are its own and not read);
 35. IGEV's ft_kitti.sh stage 1 (kitti_mix on phase 29's KITTI tree, batch
     4, 320x736), and PCVNet base.json, GWCNet base_gc.json (both 320x720)
     and CGI base.json (320x736) on the Scene Flow tree at batch 8, through
     cli.train, 4 loader workers, 3 steps each: exactly 96 K4 and 16 dgeo,
     80 K5 and 16 K5-backward, and no launch a step; ms/step, wait, peak.

NeRF-Stereo training (configs/raft_stereo/ns.json, loss_func ns_loss):

 36. one NS step (nb = nt = 1 at 1x64x128 a modality, 2 iterations, fp32,
     TF32 off) with K1 on the card vs the plain path on the CPU, and the
     plain lookup on the card vs the CPU as the floor: the losses within
     1e-3 relative, the gradients within 0.1 relative L2 per module and
     0.05 over all (or twice the floor); exactly 2 K1 and 2 K1-backward
     launches;
 37. ns.json as shipped (bf16, reg, no remat) in the NS step at B=8,
     320x720, 16 iterations, all 8 rows trinocular and then nb = nt = 4:
     1 warm-up and 5 timed steps each, ms/step, device ms of each part
     (EMA, forward, loss, backward, clip and AdamW), peak memory, exactly
     16 K1 and 16 K1-backward launches a step; a profile of one
     all-trinocular step (chiprun_out/chip_smoke_ns_train_profile.txt), and
     ns_loss's forward and backward alone at the step's shapes (time,
     kernels, chiprun_out/chip_smoke_ns_loss_profile.txt);
 38. ns.json through cli.train (batch 8, 320x720, 4 loader workers, 3
     steps from a seeded random .pth) on a synthetic NeRF-Stereo tree (8
     triplets at 540x960, 16-bit disparity and confidence), then
     nerf_stereo with phase 33's Scene Flow tree at --ns_num_tri 4: exactly
     16 K1 and 16 K1-backward launches a step, ok and a finite loss, the
     CLI's timing line, a checkpoint.

The profiler, banded evaluation and multi-process training (ROADMAP.md
Queue 1 item 11):

 39. train.json through cli.train on phase 33's Scene Flow tree (batch 8,
     320x720, 4 loader workers, 4 steps) with --profile_start 1
     --profile_steps 2: the trace holds exactly 2 ProfilerStep ranges and
     2 x 96 K1 forward and 2 x 16 K1 backward kernel events; the window's
     device-busy share, the top 15 device operations by time
     (chiprun_out/chip_smoke_cli_train_trace_top.txt) and the step's own
     host time traced and untraced;
 40. sequential banded evaluation (eval/tiled.py::banded_forward) of
     alt_pallas.json at 1x1984x2880, fp32, 32 iterations, halo 64: one band
     within 1e-5 px of the unbanded frame; 2 and 4 bands with ms/frame, peak
     memory, exactly 32 K3 and 4 K2 a band, and max/mean |d| against the
     unbanded frame (approximate by design);
 41. exact banded evaluation (banded_forward_exact) on two ranks that share
     cuda:0 over gloo (parallel/mesh.py::run_ranks; NCCL refuses two ranks
     on one device), fp32, TF32 off: alt_pallas.json with pallas_encoder
     off at 1x1984x2880, halo 128, 2 iterations (flow head damped by 0.02,
     the JAX test's protocol) within max 1e-3 and mean 1e-4 px of the
     unbanded frame; 32 iterations with ms/frame, each rank's peak memory
     and 32 K3 a band; IGEV pallas.json at 1x736x1280, 2 iterations, halo
     64 (disparity head scaled by 0.05), max below 0.02 x its scale + 1 px,
     2 K4 a band;
 42. (a) in the same two ranks, one DKT step (train.json, fp32, 1x64x128 a
     rank, 2 + 2 iterations) and one NS step (ns.json, nb = nt = 2 global),
     rank 1's valid half zeros, against one process's step on the global
     batch on the card: losses within 1e-3 relative, gradients within 0.1
     relative L2 a module and 0.05 over all, both ranks' weights
     bit-identical, 8/2 and 2/2 K1 launches a rank; (b) train.json at
     8x320x720 in a process group of one over NCCL (the step's collectives
     run), 1 warm-up and 3 timed steps, 96 K1 and 16 K1 backward a step,
     beside phase 9's one-process step; then cli.train's broadcast of the
     state from rank 0 (parallel/mesh.py::replicate), bit-identical.

RAFT-Stereo's remaining options, batched teachers, GWCNet's ptrans head and
the confidence tools (ROADMAP.md Queue 1 items 1 and 2):

 43. RAFT's options in test mode on pallas.json ({**pallas.json, option} in
     memory): cosine, mix_fmap_image, interpolate with reg_cuda and with
     alt_cuda, shared_backbone and fast_in_stats (with pallas_encoder),
     each card vs plain on the CPU, fp32, TF32 off, 1x256x512, 2 iterations
     (5e-3 px), with exact launches (2 K1 or 2 K3; 4 K2 where the fnet runs
     fused); K1 on a cosine pyramid (values in [-1, 1]) and K3 at D 3 vs
     their plain twins at 1x184x320; then cosine and interpolate + alt_cuda
     at 1x736x1280, 32 iterations, bf16, 20 frames, and fast_in_stats 5
     frames, with exact counts (32 K1 + 4 K2, 32 K3, 32 K1 + 4 K2 a frame);
 44. the DKT step with the new options, train.json at 8x320x720, 16/32
     iterations: (a) mix_fmap_image, one step card vs CPU at 1x64x128 with
     the draws fixed (phase 8's bounds), then 1 warm-up + 5 timed steps
     with 96 K1 and 16 K1 backward a step; (b) batched_teachers: the two
     slots bit-identical from equal weights (2 K1 launches for both
     teachers' 2 iterations), one batched step against the unbatched one
     (loss 1e-3 relative, weights within 2.5 x the first AdamW move), then
     1 + 5 timed steps with 64 K1 (the teachers' 2 x 32 in 32 launches) and
     16 backward a step, beside phase 9's step, a profile of one
     (chiprun_out/chip_smoke_batched_train_profile.txt), and the teachers'
     forward alone, the two models in turn against the batched one, timed
     in turns and profiled by bucket; (c) cli.train
     --batched_teachers, 3 steps on phase 33's Scene Flow tree, 64/16 a
     step;
 45. GWCNet base_gc.json with ptrans in train mode: card vs CPU at
     1x64x128 (z_ps within 1e-4, unit rows within 1e-5, disparities within
     5e-2 px); B=8 at 320x720 with 32 patches x 4 views of 64x64 a side,
     ms and peak; PTrans's host seconds a 320x720 sample; the confidence
     tools card vs CPU at 2x320x720 (1e-4 of the values' scale; uniqueness
     and agreement exact).

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result. Whatever the outcome, every process the phases started (the
loaders' forkserver, workers and resource tracker, the killed stage 1's
orphans, which this process adopts, the ranks of phases 41-42) is stopped
and reaped before it exits.
"""

from __future__ import annotations

import copy
import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 non-tensor
MAIN_FRAMES = 20


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


def adopt_orphans():
    """Make this process the parent of its descendants' orphans: a loader
    worker, forkserver or resource tracker whose parent died (phase 34 kills
    stage 1) becomes a child here, where stop_children finds it."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _children(pgid=None):
    """Pids of this process's children, zombies included (from /proc), only
    those of process group ``pgid`` where it is given."""
    me, pids = os.getpid(), []
    for entry in os.scandir("/proc"):
        if not entry.name.isdigit():
            continue
        try:
            stat = Path(entry.path, "stat").read_text()
        except OSError:  # gone meanwhile
            continue
        ppid, group = stat[stat.rindex(")") + 2:].split()[1:3]
        if int(ppid) == me and (pgid is None or int(group) == pgid):
            pids.append(int(entry.name))
    return pids


def _reaped(pid):
    try:
        return os.waitpid(pid, os.WNOHANG)[0] == pid
    except ChildProcessError:
        return True


def stop_children(pgid=None, grace=10.0):
    """Stop and reap every child of this process (of process group ``pgid``
    where given): SIGTERM, then SIGKILL to whatever is left after ``grace``
    seconds, in rounds, since a stopped child's own children come here.

    Without ``pgid`` it first ends the multiprocessing machinery of this
    process's loaders in order: the forkserver (it leaves when its pipe
    closes), multiprocessing's exit finalizers (the queues' semaphores are
    unlinked through the resource tracker while it still runs, and none is
    left to start a new tracker at interpreter exit), the workers, then the
    resource tracker (it ignores SIGTERM and leaves when its pipe closes).
    Returns the number of processes it had to signal."""
    from multiprocessing import forkserver, resource_tracker, util

    tracker = None
    if pgid is None:
        import gc

        gc.collect()
        forkserver._forkserver._stop()
        util._exit_function()
        tracker = resource_tracker._resource_tracker._pid
    stopped = 0
    for _ in range(5):
        pids = [p for p in _children(pgid) if p != tracker]
        if not pids:
            break
        stopped += len(pids)
        for sig in (signal.SIGTERM, signal.SIGKILL):
            for p in pids:
                try:
                    os.kill(p, sig)
                except ProcessLookupError:
                    pass
            deadline = time.monotonic() + grace
            while pids and time.monotonic() < deadline:
                pids = [p for p in pids if not _reaped(p)]
                if pids:
                    time.sleep(0.05)
            if not pids:
                break
    if pgid is None:
        resource_tracker._resource_tracker._stop()
    return stopped


def cuda_ms(torch, fn, n):
    """Mean device time of one call over ``n`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _wrappers():
    """Every kernel wrapper; each adds one to its ``launches`` where it
    launches its kernel, and nowhere else."""
    from dkt_stereo_tpu_torch.ops.cuda.corr_alt import corr_lookup_alt
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup, corr_lookup_bwd
    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage, encoder_stage_bwd
    from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import (
        geo_lookup, geo_lookup_bwd_corr, geo_lookup_bwd_geo)
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import (
        gaussian_row_sample, gaussian_row_sample_bwd)

    return (corr_lookup, corr_lookup_bwd, encoder_stage, encoder_stage_bwd, geo_lookup,
            geo_lookup_bwd_geo, geo_lookup_bwd_corr, corr_lookup_alt, gaussian_row_sample,
            gaussian_row_sample_bwd)


def kernel_counts():
    """Launch counts by the kernels line's names."""
    return {f.__name__: f.launches for f in _wrappers()}


def zero_counts():
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup_bwd

    for f in _wrappers():
        f.launches = 0
    corr_lookup_bwd.g_copies = 0


def _diff(after, before):
    return {k: after[k] - before[k] for k in after}


def _kernel_name(mangled):
    """The kernel's identifier and raw template arguments in a mangled
    name: the identifier ending in _kernel after its length prefix."""
    import re

    for d in re.finditer(r"\d+", mangled):
        for j in range(d.start(), d.end()):
            ident = mangled[d.end():d.end() + int(mangled[j:d.end()])]
            if ident.endswith("_kernel"):
                args = re.match(r"I(\w*?)E", mangled[d.end() + len(ident):])
                return ident + (f"<{args.group(1)}>" if args else "")
    return mangled


def ptxas_line(libs):
    """Registers and spilled bytes of every kernel, from the reports ptxas
    gave when the libraries were built."""
    import re

    from dkt_stereo_tpu_torch.ops.cuda import _build

    rows = []
    for lib in libs:
        for line in _build.ptxas_path(lib).read_text().splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                rows.append([_kernel_name(m.group(1)), "?", "?", "0"])
            elif rows and (m := re.search(r"(\d+) bytes spill stores", line)):
                rows[-1][2] = m.group(1)
            elif rows and (m := re.search(r"Used (\d+) registers", line)):
                rows[-1][1] = m.group(1)
                if m := re.search(r"(\d+) bytes smem", line):
                    rows[-1][3] = m.group(1)
    return " | ".join(f"{n} {r} registers, {s} B spilled, {sm} B static shared memory"
                      for n, r, s, sm in rows)


def smem_line():
    """The dynamic shared memory of the redesigned kernels' blocks, as
    their launchers compute it."""
    from dkt_stereo_tpu_torch.ops.cuda import _build
    from dkt_stereo_tpu_torch.ops.cuda.corr_alt import smem_bytes

    fwd = _build.load("encoder_stage").encoder_stage_fwd_smem_bytes
    k3 = _build.load("corr_alt").corr_alt_smem_bytes
    k3_bytes = k3(ALT_D, 1, 4)
    check(k3_bytes == smem_bytes(ALT_D, True, 4), "K3's shared-memory plan differs from the "
          "wrapper's mirror")
    # K1's plans: the launchers' byte counts against the wrappers' mirrors
    from dkt_stereo_tpu_torch.ops.cuda import corr_lookup as k1

    k1f = _build.load("corr_lookup").corr_lookup_smem_bytes
    k1b = _build.load("corr_lookup_bwd").corr_lookup_bwd_smem_bytes
    k1f.restype = k1b.restype = ctypes.c_longlong
    k1_rows = []
    for L, r, vb, ob in ((4, 4, 1, 1), (4, 4, 0, 0), (4, 4, 0, 1), (5, 12, 1, 1), (5, 12, 0, 0),
                         (4, 60, 0, 0)):
        pf, fbytes = k1.fwd_plan(L, r, 2 if vb else 4, 2 if ob else 4)
        pb, bbytes = k1.bwd_plan(L, r)
        check(k1f(L, r, vb, ob, pf) == fbytes and k1b(L, r, pb) == bbytes,
              f"K1's shared-memory plan at L {L} r {r} differs from the wrapper's mirror")
        k1_rows.append(f"L {L} r {r} {'bf16' if vb else 'fp32'}->{'bf16' if ob else 'fp32'} "
                       f"fwd {pf} pixels {fbytes} B, bwd {pb} pixels {bbytes} B")
    # K4's and K5's plans likewise
    from dkt_stereo_tpu_torch.ops.cuda import geo_lookup as k4
    from dkt_stereo_tpu_torch.ops.cuda import row_sample as k5

    k4f = _build.load("geo_lookup").geo_lookup_smem_bytes
    k4b = _build.load("geo_lookup_bwd").geo_lookup_bwd_smem_bytes
    k5f = _build.load("row_sample").row_sample_smem_bytes
    k4f.restype = k4b.restype = k5f.restype = ctypes.c_longlong
    k4_rows = []
    for L, r in ((2, 4), (5, 12)):
        check(k4f(L, r) == k4.fwd_smem_bytes(L, r), f"K4's forward plan at L {L} r {r} differs")
        row = f"L {L} r {r} fwd {k4.fwd_smem_bytes(L, r)} B"
        for part, size in (("geo", 48), ("corr", 184)):
            pixels, nbytes = k4.bwd_plan(L, r, 8, part, size, 2)
            check(k4b(L, r, 8, int(part == "geo"), pixels, size, 1) == nbytes,
                  f"K4's d{part} plan at L {L} r {r} differs from the wrapper's mirror")
            row += f", d{part} (size {size}, bf16) {pixels} pixels {nbytes} B"
        k4_rows.append(row)
    k5_rows = []
    for widths, vb, ob in (((180, 45, 11), 1, 1), ((320, 80, 20), 1, 1), ((320, 80, 20), 0, 0),
                           ((160, 80, 40), 1, 1), ((37, 9, 2), 0, 1)):
        pixels, nbytes = k5.fwd_plan(widths, PCV_G * PCV_S, PCV_G, 2 if vb else 4, 2 if ob else 4)
        arr = (ctypes.c_int * len(widths))(*widths)
        check(k5f(arr, len(widths), PCV_G * PCV_S, PCV_G, vb, ob, pixels) == nbytes,
              f"K5's plan at widths {widths} differs from the wrapper's mirror")
        k5_rows.append(f"widths {widths} {'bf16' if vb else 'fp32'}->{'bf16' if ob else 'fp32'}"
                       f" {pixels} pixels {nbytes} B")
    # K5's backward: its level table and warps' areas, 3 to 8 levels
    k5b = _build.load("row_sample_bwd").row_sample_bwd_smem_bytes
    for widths, elem in (((180, 45, 11), 2), ((320, 80, 20), 4), ((37, 18, 9, 4, 2), 2),
                         ((300, 150, 75, 37, 18, 9, 4, 2), 4)):
        pixels, nbytes = k5.bwd_plan(widths, PCV_G * PCV_S, elem)
        arr = (ctypes.c_int * len(widths))(*widths)
        check(k5b(arr, len(widths), PCV_G * PCV_S, elem, pixels) == nbytes,
              f"K5's backward plan at widths {widths} differs from the wrapper's mirror")
        k5_rows.append(f"bwd widths {widths} {'bf16' if elem == 2 else 'fp32'} {pixels} pixels "
                       f"{nbytes} B")
    return (f"encoder_stage_fwd_kernel {fwd(0)} B (3 u stages), with v {fwd(1)} B (2 u + 1 v "
            f"stages) | corr_alt_kernel at D {ALT_D} bf16 r 4 {k3_bytes} B, fp32 "
            f"{k3(ALT_D, 0, 4)} B | K1 " + "; ".join(k1_rows) + " | K4 (C 8) "
            + "; ".join(k4_rows) + " | K5 (K 36) " + "; ".join(k5_rows))


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fn, n, reps=3):
    """Device time of one call of ``fn``: ``n`` calls captured in one CUDA
    graph, replayed ``reps`` times between two events, so that the host's
    time per call (checks, allocation, the launch) is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (n * reps)


def bf16_steps(torch, got, want):
    """The largest |got - want rounded to bf16|, in bf16 steps at |want|."""
    _, ex = torch.frexp(want.abs().clamp_min(2.0**-126))  # |want| in [2^(ex-1), 2^ex)
    step = torch.ldexp(torch.ones_like(want), ex - 8)
    return float(((got.float() - want.to(torch.bfloat16).float()).abs() / step).max())


K1_FRAME = (1, 184, 320)  # 1/4 grid of the 736x1280 main path
K1_FRAME_W2 = (320, 160, 80, 40)
K1_RAGGED = (2, 7, 37)
K1_RAGGED_W2 = (37, 18, 9, 4)
BF16, F32 = "bfloat16", "float32"


def k1_inputs(torch, gen, shape, widths, vol_dtype):
    """Seeded levels and coordinates in [-20, W1 + 20], with far out of
    range, negative, integer and last-column coordinates and three NaN."""
    B, H, W1 = shape
    coords = torch.rand((B, H, W1, 1), generator=gen, device="cuda") * (W1 + 40) - 20
    coords.view(-1)[:11] = torch.tensor([-1e9, 1e9, 3e7, -0.5, -1.0, 0.0, 17.0, W1 - 1.0]
                                        + [float("nan")] * 3)
    pyr = [torch.randn((B, H, W1, w), generator=gen, device="cuda").to(vol_dtype)
           for w in widths]
    return pyr, coords


def k1_fwd_bytes(torch, pyr, coords, r, dtype):
    """Bytes the forward must move for these inputs: the in-range values of
    each (pixel, level) window read once (a NaN coordinate reads nothing),
    the coordinates, the output in ``dtype`` written once."""
    c = coords[~torch.isnan(coords)]
    taps_read = 0
    for i, v in enumerate(pyr):
        w2 = v.shape[-1]
        x0 = torch.floor((c / 2**i).clamp(-(r + 2), w2 + r + 1) - r)
        idx = x0[:, None] + torch.arange(2 * r + 2, device="cuda")
        taps_read += int(((idx >= 0) & (idx < w2)).sum()) * v.element_size()
    out_bytes = coords.numel() * len(pyr) * (2 * r + 1) * dtype.itemsize
    return taps_read + coords.numel() * 4 + out_bytes


def k1_sector_bytes(torch, pyr, coords, r):
    """The windows' reads in whole 32-byte sectors, the least the L2 can
    fetch from device memory (windows of neighbouring rows share some)."""
    c = coords[~torch.isnan(coords)]
    pix = torch.arange(coords.numel(), device="cuda")[~torch.isnan(coords.view(-1))]
    total = 0
    for i, v in enumerate(pyr):
        w2, es = v.shape[-1], v.element_size()
        xs = (c / 2**i).clamp(-(r + 2), w2 + r + 1)
        lo = torch.floor(xs - r).clamp_min(0).long()
        hi = (torch.floor(xs + r) + 1).clamp_max(w2 - 1).long()
        ok = lo <= hi
        first = (pix[ok] * w2 + lo[ok]) * es // 32
        last = (pix[ok] * w2 + hi[ok]) * es // 32
        n = int((last - first).max()) + 1
        sectors = first[:, None] + torch.arange(n, device="cuda")
        total += int(torch.unique(sectors[sectors <= last[:, None]]).numel()) * 32
    return total


def k1_library(torch, pyr, coords, r):
    """The yardstick: one ``F.grid_sample`` a level on fp32 copies of the
    levels, (N, 1, 1, W2) with an (N, 1, 2r+1, 2) grid, upstream
    RAFT-Stereo's ``bilinear_sampler`` form of this lookup; fp32, because a
    bf16 grid cannot hold the positions. Returns the forward, the levels
    and the grids."""
    import torch.nn.functional as F

    n = coords.numel()
    dx = torch.arange(-r, r + 1, dtype=torch.float32, device="cuda")
    lib_in = [v.float().reshape(n, 1, 1, v.shape[-1]) for v in pyr]
    grids = []
    for i, v in enumerate(lib_in):
        x = (coords.reshape(n, 1) / 2**i + dx).reshape(n, 1, 2 * r + 1, 1)
        x = 2 * x / (v.shape[-1] - 1) - 1
        grids.append(torch.cat([x, torch.zeros_like(x)], dim=-1))

    def forward():
        return [F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=True)
                for v, g in zip(lib_in, grids)]

    return forward, lib_in, grids


def phase_k1(torch):
    """K1 vs its plain version: every level count, dtype pair and shape
    below, the output's dtype and strides those of
    ``plain.permute(0, 3, 1, 2).to(dt)``; device times (a CUDA graph) at the
    frame and the training step beside their bounds, the plain version and
    grid_sample."""
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup, corr_lookup_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}

    def hold(label, pyr, coords, r, dt):
        got = corr_lookup(pyr, coords, r, dt)
        plain = corr_lookup_plain(pyr, coords, r).permute(0, 3, 1, 2)
        want = plain.to(dt)
        check(got.dtype == dt and got.shape == want.shape and got.stride() == want.stride(),
              f"K1 {label}: {got.dtype} {tuple(got.shape)} strides {got.stride()}, want "
              f"{want.dtype} {tuple(want.shape)} {want.stride()}")
        nan = torch.isnan(plain)
        check(torch.equal(torch.isnan(got), nan), f"K1 {label}: NaN differs from the plain twin")
        check(int(nan.sum()) == 3 * plain.shape[1], f"K1 {label}: {int(nan.sum())} NaN outputs")
        err = float((got.float()[~nan] - want.float()[~nan]).abs().max())
        if dt == torch.float32:
            # the kernel rounds as the plain version does, tap by tap; 1e-4
            # of the volume's scale is the JAX package's bound between its
            # Pallas and materialized lookups (tests/test_pallas_corr.py:105)
            tol, steps = 1e-4 * max(float(v.abs().max()) for v in pyr), 0.0
            check(err <= tol, f"K1 {label} max-abs {err} > {tol}")
        else:
            # bf16: the plain fp32 value rounded once, within one bf16 step
            tol, steps = 0.0, bf16_steps(torch, got[~nan], plain[~nan])
            check(steps <= 1, f"K1 {label}: {steps} bf16 steps from the plain value rounded once")
        res[label] = (err, tol, steps, bool(torch.equal(got[~nan], want[~nan])))

    for shape, widths, pairs in (
            (K1_RAGGED, K1_RAGGED_W2, ((F32, F32), (BF16, BF16), (F32, BF16), (BF16, F32))),
            (K1_FRAME, K1_FRAME_W2, ((F32, F32), (BF16, BF16), (F32, BF16))),
            (TRAIN_SHAPE, TRAIN_W2, ((F32, F32), (BF16, BF16)))):
        for vol, out in pairs:
            pyr, coords = k1_inputs(torch, gen, shape, widths, getattr(torch, vol))
            hold(f"{'x'.join(map(str, shape))} {vol}->{out}", pyr, coords, 4,
                 getattr(torch, out))
    # beyond RAFT's 4 levels and radius 4: 5 levels, radius 12
    for vol, out in ((F32, F32), (BF16, BF16)):
        pyr, coords = k1_inputs(torch, gen, (2, 16, 180), (180, 90, 45, 22, 11),
                                getattr(torch, vol))
        hold(f"2x16x180 L 5 r 12 {vol}->{out}", pyr, coords, 12, getattr(torch, out))

    r = 4
    times = {}
    for name, shape, widths in (("frame", K1_FRAME, K1_FRAME_W2), ("step", TRAIN_SHAPE, TRAIN_W2)):
        pyr, coords = k1_inputs(torch, gen, shape, widths, torch.bfloat16)
        bf = torch.bfloat16

        def run():
            return corr_lookup(pyr, coords, r, bf)

        def plain():
            return corr_lookup_plain(pyr, coords, r).permute(0, 3, 1, 2).to(bf)

        library, lib_in, grids = k1_library(torch, pyr, coords, r)
        lib = torch.cat([o.view(*shape, 2 * r + 1) for o in library()], dim=-1)
        ok = ~torch.isnan(coords[..., 0])
        lib_err = float((lib[ok] - corr_lookup_plain(pyr, coords, r)[ok]).abs().max())
        nbytes = k1_fwd_bytes(torch, pyr, coords, r, bf)
        out_bytes = coords.numel() * len(pyr) * (2 * r + 1) * 2
        sector_bytes = k1_sector_bytes(torch, pyr, coords, r) + coords.numel() * 4 + out_bytes
        times[name] = dict(sector_ms=sector_bytes / HBM_BYTES_PER_S * 1e3,
                           sector_mb=sector_bytes / 1e6,
                           
            ms=graph_ms(torch, run, 50), kernel_ms=cuda_ms(torch, run, 200),
            plain_ms=graph_ms(torch, plain, 5), library_ms=graph_ms(torch, library, 20),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, mb=nbytes / 1e6, lib_err=lib_err)
        del pyr, coords, lib_in, grids, lib
    errs = " | ".join(f"{k} {e:.2e} (" + (f"{s:.0f} bf16 steps, tol 1" if "->bf" in k else
                                             f"tol {t:.1e}") + f"{', bit-equal' if eq else ''})"
                      for k, (e, t, s, eq) in res.items())
    print(f"K1 corr_lookup: max_abs vs plain.permute(0, 3, 1, 2).to(dt) {errs}; NaN "
          f"coordinates NaN in all their outputs as in the plain version")
    for name, t in times.items():
        shape = K1_FRAME if name == "frame" else TRAIN_SHAPE
        print(f"K1 corr_lookup at the {name}, bf16 -> bf16 {shape}: device ms {t['ms']:.4f} "
              f"(one CUDA graph of 50 launches) | kernel_ms {t['kernel_ms']:.4f} (200 calls "
              f"back to back: the host's time a call) | plain_ms {t['plain_ms']:.4f} | "
              f"library_ms {t['library_ms']:.4f} (grid_sample over the four levels, fp32; "
              f"max_abs vs plain {t['lib_err']:.2e}) | bound_ms {t['bound_ms']:.4f} (bytes, "
              f"{t['mb']:.2f} MB), {t['bound_ms'] / t['ms']:.0%} of it | the same reads in "
              f"32-byte sectors: {t['sector_mb']:.2f} MB, {t['sector_ms']:.4f} ms, "
              f"{t['sector_ms'] / t['ms']:.0%} of the kernel's time")
    f = times["frame"]
    return dict(ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"], bound_by="bytes",
                library_ms=f["library_ms"], max_abs_err=max(e for e, *_ in res.values()),
                step={k: times["step"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")})


def k2_bound(B, H, W, v_and_h):
    """(bound ms, bound_by) of one bf16 stage: u read and y written once
    (and v read, h written), the taps, the affines and the statistics; the
    conv's multiply-adds at the bf16 tensor-core rate."""
    C = 64
    act = B * H * W * C * 2
    nbytes = 2 * act + C * C * 9 * 2 + 4 * B * C * 4
    if v_and_h:
        nbytes += 2 * act + 2 * B * C * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * H * W * C * C * 9 / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k2_inputs(torch, g, B, H, W):
    """u, a1, b1 and the v stream's kwargs in bf16. Both biases are
    positive: the prologue maps u = 0 outside the image to relu(b1) > 0,
    so a kernel that did not zero h there fails at every border pixel."""
    C = 64
    u, v = (torch.randn((B, H, W, C), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    a1, a2 = (0.5 + torch.rand((B, C), generator=g, device="cuda") for _ in range(2))
    b1, b2 = (0.05 + 0.2 * torch.rand((B, C), generator=g, device="cuda") for _ in range(2))
    return u, a1, b1, dict(v=v, a2=a2, b2=b2)


def k2_errors(torch, name, args, kw):
    """Relative max-abs error of each output against the plain version
    (over the largest |value|), and the absolute max-abs error of y/h; the
    plain conv in full fp32."""
    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage, encoder_stage_plain

    got = encoder_stage(*args, **kw)
    torch.backends.cudnn.allow_tf32 = False
    want = encoder_stage_plain(*args, **kw)
    torch.backends.cudnn.allow_tf32 = True
    # y and h are bf16 roundings of fp32 values summed in another order:
    # a rounding boundary can flip one bf16 ulp (2^-8 relative); the
    # statistics are fp32 sums over up to 5.7M pixels
    rel, abs_err = {}, 0.0
    for k, gt, wt in zip(("y", "sum", "sumsq", "h"), got, want):
        diff = float((gt.float() - wt.float()).abs().max())
        rel[k] = diff / float(wt.float().abs().max())
        if k in ("y", "h"):
            abs_err = max(abs_err, diff)
    tol = {"y": 2**-7, "h": 2**-7, "sum": 1e-4, "sumsq": 1e-4}
    for k, e in rel.items():
        check(e <= tol[k], f"K2 {name} {k} relative error {e} > {tol[k]}")
    return rel, abs_err


def _fmt_rel(rel):
    return " ".join(f"{k} {e:.2e}" for k, e in rel.items())


def phase_k2(torch):
    import torch.nn.functional as F

    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage, encoder_stage_plain

    C = 64
    g = torch.Generator(device="cuda").manual_seed(2)
    w = torch.randn((C, C, 3, 3), generator=g, device="cuda") * (2.0 / (9 * C)) ** 0.5
    # every variant at ragged edges (tiles that overhang the image on the
    # right and bottom) and at tiles that straddle samples (3 x 2 tiles a
    # sample, 6 tiles for 132 blocks), with positive biases
    for shape in ((3, 37, 45), (2, 13, 61)):
        u, a1, b1, vkw = k2_inputs(torch, g, *shape)
        for name, kw in (("plain", {}), ("v", vkw), ("emit_h", dict(emit_h=True)),
                         ("relu_u off", dict(relu_u=False)),
                         ("v+emit_h+relu_u off", dict(vkw, emit_h=True, relu_u=False))):
            rel, _ = k2_errors(torch, f"{shape} {name}", (u, a1, b1, w), kw)
            print(f"K2 encoder_stage [{name}] {(*shape, C)} bf16, positive biases: rel max_abs "
                  f"{_fmt_rel(rel)}")

    B, H, W = 2, 736, 1280
    u, a1, b1, vkw = k2_inputs(torch, g, B, H, W)
    variants = {"plain": dict(), "residual+emit_h": dict(vkw, emit_h=True),
                "emit_h": dict(emit_h=True), "relu_u off": dict(relu_u=False)}
    results = {}
    for name, kw in variants.items():
        rel, abs_err = k2_errors(torch, name, (u, a1, b1, w), kw)
        if name not in ("plain", "residual+emit_h"):
            print(f"K2 encoder_stage [{name}] (2,736,1280,64) bf16: rel max_abs {_fmt_rel(rel)}")
            continue
        ms = cuda_ms(torch, lambda: encoder_stage(u, a1, b1, w, **kw), 10)
        plain_ms = cuda_ms(torch, lambda: encoder_stage_plain(u, a1, b1, w, **kw), 3)
        bound_ms, bound_by = k2_bound(B, H, W, "v" in kw)
        results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=abs_err, rel=rel)
    # cuDNN's conv of the same shape alone, as a yardstick the port never calls
    x = u.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    lib_ms = cuda_ms(torch, lambda: F.conv2d(x, wl, padding=1), 10)
    for name, r in results.items():
        r["library_ms"] = lib_ms
        print(f"K2 encoder_stage [{name}] (2,736,1280,64) bf16: rel max_abs {_fmt_rel(r.pop('rel'))} "
              f"| max_abs {r['max_abs_err']:.3e} | kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.3f} library_ms {lib_ms:.4f} (cuDNN conv2d alone) "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    return results


def phase_parity(torch, config):
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**config, "mixed_precision": False, "corr_dtype": "float32"}
    # two iterations: with random weights the GRU amplifies fp32 rounding
    # differences each iteration; on the CPU alone the fused and unfused
    # encoder paths drift apart by 1.4e-4, 8.5e-4, 1.8e-2 and 3.9 px after 1,
    # 2, 4 and 8 iterations at this size, so a longer run tests the weights,
    # not the kernels
    iters = 2
    gpu = create_model(cfg, iters=iters, device="cuda", seed=0)
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.default_rng(3)
    img1, img2 = (rng.uniform(0, 255, (256, 512, 3)).astype(np.float32) for _ in range(2))
    d_gpu, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
    d_cpu, _ = _run_one(make_forward_fn(cpu, device="cpu"), img1, img2)
    err = float(np.abs(d_gpu - d_cpu).max())
    scale = float(np.abs(d_cpu).max())
    # the JAX package's bound between its fused and unfused encoder paths
    # (tests/test_pallas_encoder.py:123)
    tol = 5e-3
    print(f"full-model parity (fp32, TF32 off, 1x256x512, {iters} iters): disp_up max_abs "
          f"kernels-vs-plain {err:.3e} px (max |disp| {scale:.1f} px, tol {tol})")
    check(np.isfinite(d_gpu).all() and err <= tol, f"full-model parity {err} > {tol}")
    torch.backends.cudnn.allow_tf32 = True
    del gpu, cpu


def phase_main(torch, config, card):
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    iters = 32
    model = create_model(config, iters=iters, seed=0)
    forward = make_forward_fn(model)
    rng = np.random.default_rng(0)
    img1, img2 = (rng.uniform(0, 255, (736, 1280, 3)).astype(np.float32) for _ in range(2))
    _run_one(forward, img1, img2)  # warm-up
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    times = []
    for _ in range(MAIN_FRAMES):
        disp, dt = _run_one(forward, img1, img2)
        times.append(dt)
    launches = kernel_counts()

    check(disp.shape == (736, 1280), f"disp shape {disp.shape}")
    check(bool(np.isfinite(disp).all()), "non-finite disparity")
    want = {**dict.fromkeys(launches, 0), "corr_lookup": iters * MAIN_FRAMES,
            "encoder_stage": 4 * MAIN_FRAMES}
    check(launches == want, f"launch counts {launches} != {want}")
    ms = 1e3 * np.asarray(times)
    print(f"main path (pallas.json, bf16, 1x736x1280, {iters} iters, {MAIN_FRAMES} frames): "
          f"ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f} min {ms.min():.2f} "
          f"max {ms.max():.2f} | frames/s {1e3 / ms.mean():.3f} | "
          f"launches {launches} | peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"| disp range [{disp.min():.2f}, {disp.max():.2f}] | {card}")
    return model, forward, (img1, img2), launches


# device-time buckets of a profile, by kernel name; the first match wins
BUCKETS = (
    ("K3", r"corr_alt_kernel"),
    ("K4 bwd", r"geo_lookup_bwd"),
    ("K4", r"geo_lookup_kernel"),
    ("K1 bwd", r"corr_lookup_bwd_kernel"),
    ("K1", r"corr_lookup_kernel"),
    ("K5 bwd", r"row_sample_bwd_kernel"),
    ("K5", r"row_sample_kernel"),
    # the adjoint conv of K2's VJP: its own kernel in bf16, the fp32 stage
    # kernel's instantiation without statistics in fp32
    ("K2 adjoint", r"encoder_stage_adjoint_kernel|encoder_stage_f32_kernel<false>"),
    ("K2", r"encoder_stage"),
    ("convolutions/GEMMs", r"xmma|cutlass|gemm|nvjet|conv|wgrad|dgrad|fprop"),
    ("cuDNN layout transforms", r"nchwToNhwc|nhwcToNchw|AddPadding"),
    ("strided bf16 adds", r"elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast"
                          r"<at::native::CUDAFunctor_add<c10::BFloat16>"),
    ("casts/copies", r"copy_kernel|Memcpy|Memset|CatArray"),
    ("batch norm", r"batch_norm"),
    ("reductions", r"reduce_kernel"),
    # the NS loss's disparity warps (gathers) and SSIM's reflection padding
    ("gathers/reflection pads", r"scatter_gather|reflection_pad"),
    ("resize/pool/softmax", r"upsample|pool|SoftMax"),
    ("optimizer", r"Optimizer|multi_tensor"),
    ("other elementwise", r""),
)


def bucket_line(by_name):
    """``name ms/launches`` per bucket of a {kernel name: (ms, launches)}."""
    import re

    tot = {b: [0.0, 0] for b, _ in BUCKETS}
    for name, (t, n) in by_name.items():
        b = next(b for b, pat in BUCKETS if re.search(pat, name))
        tot[b][0] += t
        tot[b][1] += n
    return " | ".join(f"{b} {t:.2f} ms/{n}" for b, (t, n) in tot.items())


def device_profile(torch, run, name):
    """Profile one call of ``run`` (which returns its own wall seconds):
    device time by kernel into the output directory's ``name``, and the
    share of the wall time in which no kernel ran. Returns (wall ms, busy
    ms, lines, bucket line)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy = sum(t for t, _ in by_name.values())
    lines = [f"{t:9.3f} ms {n:6d}x  {name}" for name, (t, n) in ranked]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / name).write_text("\n".join(lines) + "\n")
    return wall * 1e3, busy, lines, bucket_line(by_name)


def phase_profile(torch, forward, images):
    """Device time by kernel over one main-path frame, and the share of the
    frame's host-clock time in which no kernel ran."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one

    wall, busy, lines, buckets = device_profile(torch, lambda: _run_one(forward, *images)[1],
                                                "chip_smoke_profile.txt")
    print(f"profile of one frame (profiler on): wall {wall:.2f} ms, kernels {busy:.2f} ms, "
          f"device idle share {1 - busy / wall:.3f}; by bucket: {buckets}; top kernels:")
    for line in lines[:12]:
        print("  " + line[:160])


TRAIN_IMAGE = (8, 320, 720)  # cli/train.py:49,53 defaults
TRAIN_SHAPE = (8, 80, 180)  # 1/4 resolution of the 8x320x720 training crops
TRAIN_W2 = (180, 90, 45, 22)


def k1_bwd_bytes(torch, coords, widths, r, g_dtype, vol_dtype):
    """Bytes the backward must move for these inputs: every d/dvolume entry
    written once (zeros included), the g taps that land on at least one
    in-range entry (all of a NaN coordinate's), the coordinates."""
    taps = 2 * r + 1
    out_bytes = coords.numel() * sum(widths) * vol_dtype.itemsize
    nan = torch.isnan(coords)
    c = coords.nan_to_num(0.0)
    k = torch.arange(taps, device="cuda")
    g_read = 0
    for i, w2 in enumerate(widths):
        x0 = torch.floor((c / 2**i).clamp(-(r + 2), w2 + r + 1) - r) + k
        read = ((x0 >= 0) & (x0 < w2)) | ((x0 + 1 >= 0) & (x0 + 1 < w2)) | nan
        g_read += int(read.sum()) * g_dtype.itemsize
    return out_bytes + g_read + coords.numel() * 4


def phase_k1_bwd(torch):
    """K1 backward vs its plain version at the training step, the frame, a
    ragged shape and 5 levels with radius 12, NaN coordinates included; two
    launches bit for bit; the adjoint check against the forward kernel;
    device times beside the bound, the plain version and grid_sample's
    backward."""
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import (
        corr_lookup, corr_lookup_bwd, corr_lookup_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(4)
    res = {}

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    def hold(label, shape, widths, r, g_dt, vol_dt):
        _, coords = k1_inputs(torch, gen, shape, (), vol_dt)
        g = torch.randn((*shape, len(widths) * (2 * r + 1)), generator=gen,
                        device="cuda").to(g_dt)
        meta = [((*shape, w2), vol_dt) for w2 in widths]
        got = corr_lookup_bwd(meta, coords, g, r)
        again = corr_lookup_bwd(meta, coords, g, r)
        want = corr_lookup_bwd_plain(meta, coords, g, r)
        check([d.dtype for d in got] == [vol_dt] * len(widths),
              f"K1 bwd {label}: output dtypes {[d.dtype for d in got]}")
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)),
              f"K1 bwd {label}: two launches differ")
        nan_pix = torch.isnan(coords[..., 0])
        errs = []
        for a, b in zip(got, want):
            nan = torch.isnan(b)
            check(torch.equal(torch.isnan(a), nan) and bool(nan[nan_pix].all()),
                  f"K1 bwd {label}: NaN rows differ from the plain twin's")
            errs.append(float((a.float()[~nan] - b.float()[~nan]).abs().max()))
        if vol_dt == torch.float32:
            # the kernel and the plain version weight each tap from the
            # same rounded position; their fp32 sums differ in the last bits
            tol = 1e-4 * float(g.float().abs().max())
        else:
            # one bf16 rounding of fp32 sums that may differ in their last
            # bits: one bf16 step (2^-8) can flip
            tol = 2**-7 * max(float(b.float()[~torch.isnan(b)].abs().max()) for b in want)
        check(max(errs) <= tol, f"K1 bwd {label} max-abs {max(errs)} > {tol}")
        res[label] = (max(errs), tol)

    for shape, widths, pairs in (
            (TRAIN_SHAPE, TRAIN_W2, ((F32, F32), (BF16, BF16), (F32, BF16))),
            (K1_FRAME, K1_FRAME_W2, ((F32, F32), (BF16, BF16))),
            (K1_RAGGED, K1_RAGGED_W2, ((F32, F32), (BF16, BF16), (F32, BF16), (BF16, F32)))):
        for g_dt, vol_dt in pairs:
            hold(f"{'x'.join(map(str, shape))} g {g_dt} vol {vol_dt}", shape, widths, 4,
                 getattr(torch, g_dt), getattr(torch, vol_dt))
    for dt in (F32, BF16):
        hold(f"2x16x180 L 5 r 12 {dt}", (2, 16, 180), (180, 90, 45, 22, 11), 12,
             getattr(torch, dt), getattr(torch, dt))

    # adjoint: <K1(v), g> == <v, K1^T(g)>, both kernels, fp32, fp64 sums
    # (finite coordinates: a NaN one makes both sides NaN)
    r = 4
    pyr, coords = k1_inputs(torch, gen, TRAIN_SHAPE, TRAIN_W2, torch.float32)
    coords = coords.nan_to_num(7.5)
    g = torch.randn((*TRAIN_SHAPE, len(TRAIN_W2) * (2 * r + 1)), generator=gen, device="cuda")
    with torch.no_grad():
        out = corr_lookup(pyr, coords, r)
    dv = corr_lookup_bwd([(v.shape, v.dtype) for v in pyr], coords, g, r)
    lhs = float((out.permute(0, 2, 3, 1).double() * g.double()).sum())
    rhs = float(sum((v.double() * d.double()).sum() for v, d in zip(pyr, dv)))
    adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    check(adj <= 1e-5, f"K1 adjoint check: relative {adj} > 1e-5")
    del pyr, out, dv

    times = {}
    bf = torch.bfloat16
    for name, shape, widths in (("step", TRAIN_SHAPE, TRAIN_W2), ("frame", K1_FRAME, K1_FRAME_W2)):
        pyr, coords = k1_inputs(torch, gen, shape, widths, bf)
        g = torch.randn((*shape, len(widths) * (2 * r + 1)), generator=gen, device="cuda").to(bf)
        meta = [(v.shape, v.dtype) for v in pyr]

        def run():
            return corr_lookup_bwd(meta, coords, g, r)

        def plain():
            return corr_lookup_bwd_plain(meta, coords, g, r)

        # the yardstick: grid_sample's backward for the volumes, one call a
        # level, on phase 2's fp32 copies, its d/dvolume in fp32
        _, lib_in, grids = k1_library(torch, pyr, coords.nan_to_num(0.0), r)
        gouts = [t.reshape(-1, 1, 1, 2 * r + 1).float().contiguous()
                 for t in g.split(2 * r + 1, dim=-1)]

        def library():
            return [torch.ops.aten.grid_sampler_2d_backward(
                go, v, gr, 0, 0, True, [True, False])[0]
                for go, v, gr in zip(gouts, lib_in, grids)]

        nbytes = k1_bwd_bytes(torch, coords, widths, r, bf, bf)
        times[name] = dict(
            ms=graph_ms(torch, run, 20), kernel_ms=cuda_ms(torch, run, 100),
            plain_ms=graph_ms(torch, plain, 2, 1), library_ms=graph_ms(torch, library, 5),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, mb=nbytes / 1e6,
            written=coords.numel() * sum(widths) * 2 / 1e6)
        if name == "step":
            # what autograd adds per iteration: summing one iteration's four
            # dense d/dvolume tensors into the running d/dpyramid (15 such
            # sums per step)
            acc, new = run(), run()
            times[name]["accum_ms"] = cuda_ms(torch, lambda: [a.add_(b) for a, b in zip(acc, new)],
                                              20)
            del acc, new
        del pyr, coords, g, lib_in, grids, gouts
    errs = " | ".join(f"{k} {e:.2e} (tol {t:.1e})" for k, (e, t) in res.items())
    print(f"K1 corr_lookup_bwd: max_abs vs plain {errs} (tol 1e-4 x max|g| fp32 levels, "
          f"2^-7 x max|dvol| bf16); NaN rows as in the plain version; two launches bit for bit "
          f"| adjoint rel {adj:.2e} (tol 1e-5)")
    for name, t in times.items():
        shape, widths = (TRAIN_SHAPE, TRAIN_W2) if name == "step" else (K1_FRAME, K1_FRAME_W2)
        accum = (f" | autograd's sum of one iteration's d/dpyramid into the running one: "
                 f"{t['accum_ms']:.4f} ms (x15 per step: {15 * t['accum_ms']:.3f} ms)"
                 if "accum_ms" in t else "")
        print(f"K1 corr_lookup_bwd at the {name}, g bf16, levels bf16 {shape} W2 {widths}: "
              f"device ms {t['ms']:.4f} (one CUDA graph of 20 launches) | kernel_ms "
              f"{t['kernel_ms']:.4f} (100 calls back to back) | plain_ms {t['plain_ms']:.3f} | "
              f"library_ms {t['library_ms']:.4f} (grid_sample's backward for the volumes, fp32, "
              f"one call a level) | bound_ms {t['bound_ms']:.4f} (bytes, {t['mb']:.2f} MB: "
              f"{t['written']:.2f} written), {t['bound_ms'] / t['ms']:.0%} of it{accum}")
    st = times["step"]
    return dict(ms=st["ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"], bound_by="bytes",
                library_ms=st["library_ms"], max_abs_err=max(e for e, _ in res.values()),
                frame={k: times["frame"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")})


K2_VJP_IMAGE = (16, 320, 720)  # the fnet's pair batch of the 8x320x720 training crops


def _stage_case(torch, gen, B, H, W, dt, residual):
    """Inputs, forward outputs (y and h from the K2 forward) and random
    output cotangents of one encoder stage."""
    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage

    C = 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u = randn(B, H, W, C).to(dt)
    a1, b1 = 0.5 + torch.rand((B, C), generator=gen, device="cuda"), 0.3 * randn(B, C)
    w = randn(C, C, 3, 3) * (2.0 / (9 * C)) ** 0.5
    kw = {}
    if residual:
        kw = dict(v=randn(B, H, W, C).to(dt), a2=0.5 + torch.rand((B, C), generator=gen,
                                                                device="cuda"),
                  b2=0.3 * randn(B, C))
    with torch.no_grad():
        y, _, _, h = encoder_stage(u, a1, b1, w, emit_h=True, **kw)
    cts = dict(gy=randn(B, H, W, C).to(dt), gs=randn(B, C), gss=randn(B, C),
               gh_out=randn(B, H, W, C).to(dt) if residual else None)
    return (u, a1, b1, w, y, h), kw, cts


VJP_NAMES = ("g_u", "g_a1", "g_b1", "g_w", "g_v", "g_a2", "g_b2")


def _vjp_errors(torch, args, kw, cts, tol_rel, label):
    """Each cotangent of the stage's VJP through the kernel vs the plain
    twin on the same inputs: max-abs error over max|plain|."""
    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import (
        encoder_stage_bwd, encoder_stage_bwd_plain)

    got = encoder_stage_bwd(*args, **kw, **cts)
    want = encoder_stage_bwd_plain(*args, **kw, **cts)
    rel = {}
    for name, g, w in zip(VJP_NAMES, got, want):
        if w is None:
            check(g is None, f"K2 VJP {label}: {name} should be None")
            continue
        check(g.dtype == w.dtype and g.shape == w.shape, f"K2 VJP {label}: {name} dtype/shape")
        rel[name] = float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
        check(rel[name] <= tol_rel, f"K2 VJP {label}: {name} relative {rel[name]} > {tol_rel}")
    return rel


def phase_k2_vjp(torch):
    """K2's VJP (EncoderStage's backward: the adjoint conv through its
    kernel, the rest PyTorch) vs its plain twin on the card, the adjoint
    check, and the times of the adjoint launch, the whole stage backward,
    the plain twin and cuDNN's dgrad and wgrad at the training shape."""
    import torch.nn.functional as F

    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import (
        encoder_stage, encoder_stage_adjoint, encoder_stage_adjoint_plain, encoder_stage_bwd,
        encoder_stage_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(26)
    C = 64
    forms = (("plain", False), ("residual+emit_h", True))
    # a small fp32 case with TF32 off, then a ragged bf16 one that the
    # forward's 8x16 and the adjoint's 8x30 tiles do not divide; bf16: one
    # bf16 step (2^-8) of g_h can flip where the kernel and cuDNN sum the
    # 576 products in another order
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = {name: _vjp_errors(torch, *_stage_case(torch, gen, 2, 40, 72, torch.float32, res),
                               1e-4, f"fp32 {name}") for name, res in forms}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    ragged = {name: _vjp_errors(torch, *_stage_case(torch, gen, 3, 37, 45, torch.bfloat16, res),
                                2**-7, f"ragged bf16 {name}") for name, res in forms}
    # the bf16 adjoint kernel alone where its 8x30 tiles straddle: the
    # bottom tiles' boxes reach past a sample's last row (where the next
    # sample lies in memory), the last column tile holds one column
    g = torch.randn((2, 13, 61, C), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((C, C, 3, 3), generator=gen, device="cuda") * (2.0 / (9 * C)) ** 0.5
    want = encoder_stage_adjoint_plain(g, w).float()
    straddle = float((encoder_stage_adjoint(g, w).float() - want).abs().max())
    straddle /= float(want.abs().max())
    check(straddle <= 2**-7, f"K2 adjoint (2,13,61,64) bf16: relative {straddle} > 2^-7")
    B, H, W = K2_VJP_IMAGE
    train = {}
    for name, res in forms:
        train[name] = _vjp_errors(torch, *_stage_case(torch, gen, B, H, W, torch.bfloat16, res),
                                  2**-7, f"training bf16 {name}")
        torch.cuda.empty_cache()

    def fmt(rel):
        return " ".join(f"{k} {e:.2e}" for k, e in rel.items())

    print(f"K2 adjoint kernel (2,13,61,64) bf16, tiles straddling samples and a 1-column "
          f"tile: relative max-abs vs plain {straddle:.2e} (tol 2^-7)")
    for label, res in (("fp32 (2,40,72,64), TF32 off, tol 1e-4", small),
                       ("bf16 ragged (3,37,45,64), tol 2^-7", ragged),
                       (f"bf16 training {(B, H, W, C)}, tol 2^-7", train)):
        for name, rel in res.items():
            print(f"K2 VJP [{name}] {label}: relative max-abs vs plain {fmt(rel)}")

    # adjoint: <K2(x), g> == <x, K2^T(g)>, identity affine, no ReLU, fp32
    # (the fp32 kernels use no TF32), fp64 sums
    x = torch.randn((B, H, W, C), generator=gen, device="cuda")
    g = torch.randn((B, H, W, C), generator=gen, device="cuda")
    w = torch.randn((C, C, 3, 3), generator=gen, device="cuda") * (2.0 / (9 * C)) ** 0.5
    ones, zeros = torch.ones((B, C), device="cuda"), torch.zeros((B, C), device="cuda")
    with torch.no_grad():
        kx = encoder_stage(x, ones, zeros, w, relu_u=False)[0]
    ktg = encoder_stage_adjoint(g, w)
    lhs = float((kx.double() * g.double()).sum())
    rhs = float((x.double() * ktg.double()).sum())
    adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    check(adj <= 1e-5, f"K2 adjoint check: relative {adj} > 1e-5")
    del x, g, kx, ktg
    torch.cuda.empty_cache()

    # times at the training shape, bf16, plain form
    args, kw, cts = _stage_case(torch, gen, B, H, W, torch.bfloat16, False)
    w, h = args[3], args[5]
    gq = cts["gy"]
    got = encoder_stage_adjoint(gq, w)
    want = encoder_stage_adjoint_plain(gq, w)
    adj_err = float((got.float() - want.float()).abs().max())
    adj_rel = adj_err / float(want.float().abs().max())
    check(adj_rel <= 2**-7, f"K2 adjoint launch vs plain: relative {adj_rel} > 2^-7")
    del got, want
    ms = cuda_ms(torch, lambda: encoder_stage_adjoint(gq, w), 20)
    plain_ms = cuda_ms(torch, lambda: encoder_stage_adjoint_plain(gq, w), 3)
    bwd_ms = cuda_ms(torch, lambda: encoder_stage_bwd(*args, **cts), 5)
    bwd_plain_ms = cuda_ms(torch, lambda: encoder_stage_bwd_plain(*args, **cts), 3)
    # cuDNN's dgrad and wgrad of the same conv, channels-last bf16, as
    # yardsticks the port never calls: convolution_backward with one output
    # each; torch.nn.grad.conv2d_input, which makes an NCHW dgrad, beside it
    gn, hn = gq.permute(0, 3, 1, 2), h.permute(0, 3, 1, 2)  # NCHW views of NHWC memory
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def conv_bwd(mask):
        return torch.ops.aten.convolution_backward(gn, hn, wl, None, [1, 1], [1, 1], [1, 1],
                                                   False, [0, 0], 1, mask)

    lib_ms = cuda_ms(torch, lambda: conv_bwd([True, False, False]), 10)
    nchw_ms = cuda_ms(torch, lambda: torch.nn.grad.conv2d_input((B, C, H, W), wl, gn, padding=1),
                      10)
    wgrad_ms = cuda_ms(torch, lambda: conv_bwd([False, True, False]), 10)
    # the adjoint launch reads g and writes g_h once (bf16) and the taps;
    # 2 * 9 * 64 * 64 operations a pixel on the bf16 tensor cores
    nbytes = 2 * gq.numel() * gq.element_size() + w.numel() * 2
    flops = 2.0 * B * H * W * C * C * 9
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"K2 VJP adjoint check <K2(x), g> = <x, K2^T(g)> (fp32, {(B, H, W, C)}): relative "
          f"{adj:.2e} (tol 1e-5) | adjoint launch vs plain at {(B, H, W, C)} bf16: max_abs "
          f"{adj_err:.3e} (relative {adj_rel:.2e}) | adjoint kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.3f} library_ms {lib_ms:.4f} (cuDNN dgrad, convolution_backward, "
          f"channels-last bf16; torch.nn.grad.conv2d_input {nchw_ms:.4f}) bound_ms "
          f"{bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.1f} GFLOP) | "
          f"whole stage backward {bwd_ms:.3f} ms (plain twin {bwd_plain_ms:.3f}) | cuDNN wgrad "
          f"(convolution_backward, channels-last bf16) {wgrad_ms:.4f} ms")
    del args, kw, cts, gq, gn, hn, h
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, max_abs_err=adj_err)


def _train_batch(torch, gen, B, H, W, device):
    """Synthetic DKT batch: clean pairs in [0, 255], the augmented pair a
    per-image gain of the clean one, negative disparity in [-64, 0] and a
    valid mask of about 70 % ones."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=gen.device).to(device)

    b = {"img1_clean": 255 * rand(B, H, W, 3), "img2_clean": 255 * rand(B, H, W, 3)}
    for k in ("img1", "img2"):
        b[k] = (b[k + "_clean"] * (0.8 + 0.4 * rand(B, 1, 1, 1))).clamp(0, 255)
    b["flow"] = -64 * rand(B, H, W)
    b["valid"] = (rand(B, H, W) < 0.7).float()
    return b


def _grad_rel(named, want):
    """Relative L2 error of ``named``'s gradients against ``want``'s, by
    top-level module and over all."""
    err2, norm2 = {}, {}
    for k, p in named:
        if p.grad is None:
            continue
        group = k.split(".")[0]
        err2[group] = err2.get(group, 0.0) + float((p.grad.cpu() - want[k].grad.cpu()).square().sum())
        norm2[group] = norm2.get(group, 0.0) + float(want[k].grad.cpu().square().sum())
    rel = {gr: (err2[gr] / norm2[gr]) ** 0.5 for gr in err2}
    rel["all"] = (sum(err2.values()) / sum(norm2.values())) ** 0.5
    return rel


def phase_train_parity(torch, train_cfg, label="train-step parity", want=None):
    """One DKT step with the kernels on the card vs the plain path on the
    CPU, from the same weights, batch and draws, fp32 with TF32 off, with
    exact launch counts ``want`` (default: train.json's K1 only)."""
    from dkt_stereo_tpu_torch.train.dkt_step import (
        create_dkt_state, fande_draws, make_dkt_train_step)
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**train_cfg, "mixed_precision": False, "corr_dtype": "float32"}
    hyper = DKTHyperParams(train_iters=2, teacher_iters=2)
    gpu = create_dkt_state(cfg, hyper, seed=0, device="cuda")
    to_cpu = {k: v.to("cpu", copy=True) for k, v in gpu.student.state_dict().items()}
    cpu = create_dkt_state(cfg, hyper, params=to_cpu, device="cpu")
    gen = torch.Generator().manual_seed(5)
    batch = _train_batch(torch, gen, 1, 64, 128, "cpu")
    draws = fande_draws(1, "cpu", gen)
    step = make_dkt_train_step(cfg, hyper)
    zero_counts()
    gpu, m_gpu = step(gpu, {k: v.cuda() for k, v in batch.items()},
                      draws={k: v.cuda() for k, v in draws.items()})
    torch.cuda.synchronize()
    launches = kernel_counts()
    cpu, m_cpu = step(cpu, batch, draws=draws)
    # the chaos floor: the same CPU step from weights scaled by
    # 1 + 1e-5 N(0, 1), which moves the losses by about as much as fp32
    # reordering between the card and the CPU does
    noise = torch.Generator().manual_seed(7)
    nudged = {k: v * (1 + 1e-5 * torch.randn(v.shape, generator=noise))
              if v.is_floating_point() else v for k, v in to_cpu.items()}
    cpu2, _ = step(create_dkt_state(cfg, hyper, params=nudged, device="cpu"), batch, draws=draws)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    check(m_gpu["ok"] == m_cpu["ok"] == 1.0, f"{label}: ok gpu {m_gpu['ok']} cpu {m_cpu['ok']}")
    # teachers 2 + 2, student 2, remat recompute 2; backward 2
    want = {**dict.fromkeys(launches, 0), **(want or {"corr_lookup": 8, "corr_lookup_bwd": 2})}
    check(launches == want, f"{label}: launches {launches} != {want}")
    loss_err = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                for k in ("loss", "loss_GT", "loss_PL")}
    for k, e in loss_err.items():
        check(e <= 1e-3, f"{label} {k}: relative {e} > 1e-3")
    # gradients (after the step's clipping) by module: relative L2 error.
    # Random-weight RAFT is chaotic, and a gradient is a sum of per-pixel
    # terms of both signs: one pixel whose L1 sign or F&E mask flips under
    # fp32 reordering moves a module's gradient by ~2/sqrt(8192) = 2 %. The
    # 1e-5 nudge above shows the floor without the card. A wrong or missing
    # backward kernel moves the fnet's gradient by order 1.
    want_grads = dict(cpu.student.named_parameters())
    rel = _grad_rel(gpu.student.named_parameters(), want_grads)
    floor = _grad_rel(cpu2.student.named_parameters(), want_grads)
    for g, e in rel.items():
        check(e <= (0.05 if g == "all" else 0.1), f"{label} gradient of {g}: relative {e}")

    def norm(state, prefix):
        return float(torch.stack([p.grad.norm().cpu() for k, p in state.student.named_parameters()
                                  if k.startswith(prefix) and p.grad is not None]).norm())

    reached = {f"{dev} {m}": norm(st, m) for dev, st in (("card", gpu), ("cpu", cpu))
               for m in ("fnet.", "fnet.layer1.")}
    check(all(v > 0 for v in reached.values()), f"{label}: no fnet gradient: {reached}")
    print(f"{label} (fp32, TF32 off, 1x64x128, 2+2 iters), kernels vs plain: loss "
          f"{m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f}, relative errors "
          + " ".join(f"{k} {e:.2e}" for k, e in loss_err.items()) + " (tol 1e-3) | gradient "
          "relative L2 error by module " + " ".join(f"{g} {e:.2e}" for g, e in rel.items())
          + " (tol 0.1 per module, 0.05 all; chaos floor on the CPU from a 1e-5 weight nudge: "
          + " ".join(f"{g} {e:.2e}" for g, e in floor.items())
          + ") | gradient norms " + " ".join(f"{m} {v:.3e}" for m, v in reached.items())
          + f" | launches {launches}")
    del gpu, cpu, cpu2


TRAIN_STEPS = 5
TRAIN_PARTS = ("ema", "teachers", "fande", "student", "optimizer")


def snapshot(state, label):
    """Copies of a DKT state's teacher and student and of the student's
    batch-norm statistics, which must exist."""
    def snap(m, keep=lambda k: True):
        return {k: v.detach().clone() for k, v in m.state_dict().items() if keep(k)}

    out = dict(teacher=snap(state.teacher), student=snap(state.student),
               bn=snap(state.student, lambda k: "running" in k))
    check(len(out["bn"]) > 0, f"{label} has no batch norm statistics")
    return out


def check_moved_and_frozen(torch, state, before, label, moved=True, still_ok=()):
    """Against a :func:`snapshot`: every student tensor moved (unless
    ``moved`` is False) except exactly those named in ``still_ok``, while
    the frozen teacher and the student's batch-norm statistics are
    bit-identical."""
    if moved:
        still = [k for k, v in state.student.named_parameters()
                 if torch.equal(v, before["student"][k])]
        check(still == list(still_ok),
              f"{label} student tensors that did not move: {still[:5]} (expected {still_ok})")
    check(all(torch.equal(v, before["teacher"][k]) for k, v in state.teacher.state_dict().items()),
          f"the frozen {label} teacher changed")
    student = state.student.state_dict()
    check(all(torch.equal(student[k], v) for k, v in before["bn"].items()),
          f"{label} student BN running statistics changed")


def timed_steps(torch, state, step, gen, image, label, steps=TRAIN_STEPS, make_batch=None,
                parts=TRAIN_PARTS, step_kw=None):
    """1 warm-up step, which must be ok, then ``steps`` timed DKT steps on
    seeded synthetic batches of ``image`` (B, H, W), all launch counters
    zeroed first. Returns the state and a dict: host ms per step, the mean
    device ms of each part (CUDA events from the step's ``mark`` hook),
    the launches of each step and of all of them, the metrics and the
    peak memory in GiB of the timed steps. ``make_batch``, ``parts`` and
    ``step_kw`` serve another step (the NS step: its batches, its parts,
    no F&E generator)."""
    B, H, W = image
    make_batch = make_batch or (lambda: _train_batch(torch, gen, B, H, W, "cuda"))
    step_kw = {"generator": gen} if step_kw is None else step_kw
    state, m = step(state, make_batch(), **step_kw)
    check(m["ok"] == 1.0, f"{label} warm-up step not ok: {m}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    times, part_ms, per_step, metrics = [], {p: [] for p in parts}, [], []
    for _ in range(steps):
        batch = make_batch()
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        before = kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        state, m = step(state, batch, mark=mark, **step_kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        prev = "start"
        for p in parts:
            part_ms[p].append(events[prev].elapsed_time(events[p]))
            prev = p
        per_step.append(_diff(kernel_counts(), before))
        metrics.append(m)
    check(all(x["ok"] == 1.0 for x in metrics),
          f"a {label} step was not ok: {[x['ok'] for x in metrics]}")
    check(all(np.isfinite(x["loss"]) for x in metrics), f"non-finite {label} loss")
    return state, dict(ms=1e3 * np.asarray(times),
                       part_ms={p: float(np.mean(v)) for p, v in part_ms.items()},
                       per_step=per_step, launches=kernel_counts(), metrics=metrics,
                       peak=torch.cuda.max_memory_allocated() / 2**30)


def step_line(run):
    """The timed steps' ms/step, device ms per part, peak memory, launches
    and losses, for a phase's result line."""
    ms = run["ms"]
    return (f"ms/step median {np.median(ms):.2f} mean {ms.mean():.2f} min {ms.min():.2f} max "
            f"{ms.max():.2f} | device ms per part (mean) "
            + " ".join(f"{p} {t:.2f}" for p, t in run["part_ms"].items())
            + f" | peak mem {run['peak']:.2f} GiB | launches {run['launches']} | loss "
            + ", ".join(f"{x['loss']:.3f}" for x in run["metrics"]))


def profile_step(torch, state, step, gen, image, mean_ms, name, label, make_batch=None,
                 step_kw=None):
    """A profile of one more DKT step (or, with ``make_batch`` and
    ``step_kw``, another step) into the output directory's ``name``, and an
    estimate of the untraced idle share against the timed steps'
    ``mean_ms``."""
    B, H, W = image
    make_batch = make_batch or (lambda: _train_batch(torch, gen, B, H, W, "cuda"))
    step_kw = {"generator": gen} if step_kw is None else step_kw

    def one_step():
        batch = make_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, **step_kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, busy, lines, buckets = device_profile(torch, one_step, name)
    print(f"profile of one {label} step (profiler on): wall {wall:.2f} ms, kernels "
          f"{busy:.2f} ms, device idle share {1 - busy / wall:.3f}; by bucket: {buckets}; "
          "top kernels:")
    for line in lines[:15]:
        print("  " + line[:160])
    # not a measurement: the profiled step's kernel time against the timed
    # steps' host time, which the profiler cannot see
    print(f"untraced device idle share, estimated as 1 - profiled kernel ms / timed mean "
          f"ms/step: {1 - busy / mean_ms:.3f}")


def phase_train(torch, train_cfg, card):
    """train.json at full width: 1 warm-up and TRAIN_STEPS timed DKT steps
    at B=8, 320x720, 16 student / 32 teacher iterations."""
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    B, H, W = TRAIN_IMAGE
    hyper = DKTHyperParams(train_iters=16, teacher_iters=32)
    state = create_dkt_state(train_cfg, hyper, seed=0)
    step = make_dkt_train_step(train_cfg, hyper)
    gen = torch.Generator(device="cuda").manual_seed(6)

    before = snapshot(state, "train.json's cnet")

    state, run = timed_steps(torch, state, step, gen, (B, H, W), "RAFT")
    per_step, launches, metrics = run["per_step"], run["launches"], run["metrics"]
    # 2 x 32 teacher iterations + 16 student + 16 recomputed by remat; 16
    # backward; no K2 (pallas_encoder off) and no K4
    want = {**dict.fromkeys(launches, 0), "corr_lookup": 96, "corr_lookup_bwd": 16}
    check(all(c == want for c in per_step), f"launches per step {per_step} != {want}")
    check_moved_and_frozen(torch, state, before, "RAFT")

    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup_bwd

    print(f"training path (train.json, bf16, remat, B={B} {H}x{W}, {hyper.train_iters}/"
          f"{hyper.teacher_iters} iters, {TRAIN_STEPS} steps after 1 warm-up): "
          f"{step_line(run)} | lr {metrics[-1]['learning_rate']:.3e} | K1 gradients copied to "
          f"dense before the backward kernel: {corr_lookup_bwd.g_copies} | {card}")
    profile_step(torch, state, step, gen, (B, H, W), run["ms"].mean(),
                 "chip_smoke_train_profile.txt", "training")
    del state, step
    torch.cuda.empty_cache()
    return launches, float(run["ms"].mean())


IGEV_SHAPE = (1, 184, 320)  # 1/4 resolution of the 736x1280 main path
IGEV_D = 48  # max_disp 192 / 4
# IGEV trains at 320x736, not the trainer's default 320x720: its hourglass
# halves the 1/4 grid three times and concatenates each upsampled level with
# the one before, so the image must be a multiple of 32 (at 720 the 1/32
# level is 22.5 wide, and the JAX model fails the same way). 736 is
# upstream IGEV-Stereo's own training width.
IGEV_TRAIN_IMAGE = (8, 320, 736)
IGEV_TRAIN_SHAPE = (8, 80, 184)  # its 1/4 grid
IGEV_TRAIN_D = (IGEV_D, IGEV_D // 2)  # geo pyramid depths
IGEV_TRAIN_W2 = (IGEV_TRAIN_SHAPE[2], IGEV_TRAIN_SHAPE[2] // 2)  # init-corr pyramid widths
# past the kernels' former caps of 4 levels and radius 8
K4_WIDE = dict(shape=(2, 6, 96), depths=(48, 24, 12, 6, 3), widths=(96, 48, 24, 12, 6), r=12)


def k4_inputs(torch, gen, shape, depths, widths, dt, C=8):
    """Seeded geo and corr pyramids in ``dt`` and disparities over [-10, D +
    10], with far out of range, negative, past-D and NaN ones; coords the
    pixel's column."""
    B, H, W1 = shape
    disp = torch.rand((B, H, W1, 1), generator=gen, device="cuda") * (depths[0] + 20) - 10
    disp.view(-1)[:9] = torch.tensor([-1e9, 1e9, -3.0, -0.5, 0.0, 17.0, depths[0] - 1.0,
                                      depths[0] + 0.25, float("nan")])
    coords = torch.arange(W1, dtype=torch.float32, device="cuda").view(1, 1, W1, 1)
    coords = coords.expand(B, H, W1, 1).contiguous()
    geo = [torch.randn((B, H, W1, d, C), generator=gen, device="cuda").to(dt) for d in depths]
    cor = [(4 * torch.randn((B, H, W1, w), generator=gen, device="cuda")).to(dt) for w in widths]
    return geo, cor, disp, coords


def k4_bytes(torch, geo, cor, disp, coords, r):
    """(bytes, output bytes) one K4 launch must move for these inputs: the
    in-range geo slots (C values each) and corr entries that the taps read,
    disp and coords, the fp32 output."""
    B, H, W1, _, C = geo[0].shape
    taps = 2 * r + 1
    taps_read = 0
    j = torch.arange(taps + 1, device="cuda")
    d = disp.clamp(-1e6, 1e6)
    for i in range(len(geo)):
        for x, n, per in ((d / 2**i, geo[i].shape[3], C),
                          ((coords - d) / 2**i, cor[i].shape[3], 1)):
            idx = torch.floor(x - r) + j
            taps_read += int(((idx >= 0) & (idx < n)).sum()) * per * geo[i].element_size()
    out_bytes = B * H * W1 * len(geo) * (C + 1) * taps * 4
    return taps_read + 2 * disp.numel() * 4 + out_bytes, out_bytes


def k4_library(torch, geo, cor, disp, coords, r):
    """The yardstick: upstream IGEV-Stereo's form of this lookup
    (``Combined_Geo_Encoding_Volume`` through ``bilinear_sampler``), one
    ``F.grid_sample`` a volume and level on fp32 copies, (N, C, 1, D_i) and
    (N, 1, 1, W2_i) with (N, 1, 2r+1, 2) grids. Returns the forward (four
    outputs at two levels, geo then corr a level), the inputs and the
    grids."""
    import torch.nn.functional as F

    n, taps = disp.numel(), 2 * r + 1
    dx = torch.arange(-r, r + 1, dtype=torch.float32, device="cuda")
    lib_in, grids = [], []
    for i, (gv, cv) in enumerate(zip(geo, cor)):
        D, C = gv.shape[3], gv.shape[4]
        lib_in += [gv.float().reshape(n, D, C).permute(0, 2, 1).reshape(n, C, 1, D).contiguous(),
                   cv.float().reshape(n, 1, 1, cv.shape[3])]
        for x, size in ((disp.reshape(n, 1) / 2**i + dx, D),
                        ((coords - disp).reshape(n, 1) / 2**i + dx, cv.shape[3])):
            x = (2 * x / (size - 1) - 1).reshape(n, 1, taps, 1)
            grids.append(torch.cat([x, torch.zeros_like(x)], dim=-1))

    def forward():
        return [F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=True)
                for v, g in zip(lib_in, grids)]

    return forward, lib_in, grids


def k4_wide_variant():
    """K4's forward built from its source with the sliding two-value window
    at every radius (the register window's test turned off), for an A/B of
    the two windows at the shipped radius; the loaded library."""
    from dkt_stereo_tpu_torch.ops.cuda import _build

    src = (_build.CSRC / "geo_lookup.cu").read_text()
    test = "const bool wide = radius > kMaxRadius;"
    check(src.count(test) == 1, "K4's source has no single register-window test to turn off")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "geo_lookup_wide_ab.cu"
    cu.write_text(src.replace(test, "const bool wide = true;"))
    so = _build.BUILD_DIR / "libgeo_lookup_wide_ab.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(str(so))


def phase_k4(torch):
    """K4 vs its plain version at the IGEV main path's shapes and past the
    former caps (5 levels, radius 12); device times (a CUDA graph) at the
    frame and the training step beside their bounds, the plain version and
    upstream's grid_sample form; the register window against the sliding
    window at the shipped radius, alternated in one process."""
    from dkt_stereo_tpu_torch.ops.cuda import _build
    from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import geo_lookup, geo_lookup_plain

    C, r = 8, 4
    taps = 2 * r + 1
    gen = torch.Generator(device="cuda").manual_seed(8)
    res = {}
    frame_w2 = (IGEV_SHAPE[2], IGEV_SHAPE[2] // 2)
    cases = [(f"{'x'.join(map(str, IGEV_SHAPE))} {dt}", IGEV_SHAPE, IGEV_TRAIN_D, frame_w2, r, dt)
             for dt in (F32, BF16)]
    cases += [(f"{'x'.join(map(str, K4_WIDE['shape']))} L 5 r 12 {dt}", K4_WIDE["shape"],
               K4_WIDE["depths"], K4_WIDE["widths"], K4_WIDE["r"], dt) for dt in (F32, BF16)]
    for label, shape, depths, widths, rr, dt in cases:
        geo, cor, disp, coords = k4_inputs(torch, gen, shape, depths, widths, getattr(torch, dt))
        finite = torch.isfinite(disp[..., 0])
        got = geo_lookup(geo, cor, disp, coords, rr)
        want = geo_lookup_plain(geo, cor, disp, coords, rr)
        check(got.shape == (*shape, len(depths) * (C + 1) * (2 * rr + 1)),
              f"K4 {label} output shape {tuple(got.shape)}")
        # a NaN disparity gives NaN in every output of its pixel, in the
        # kernel as in the plain version
        check(torch.equal(torch.isnan(got), torch.isnan(want)),
              f"K4 {label}: NaN differs from the plain version")
        check(bool(torch.isnan(got[~finite]).all()) and not bool(torch.isnan(got[finite]).any()),
              f"K4 {label}: a NaN disparity did not give NaN in exactly its pixel")
        err = float((got[finite] - want[finite]).abs().max())
        # the kernel shares one fractional weight across the taps of a
        # (pixel, level, channel); the plain version rounds each tap position
        # on its own: at positions < 512 that moves a weight by <= 2^-15
        tol = 1e-4 * max(float(v.abs().max()) for v in geo + cor)
        check(err <= tol, f"K4 {label} max-abs {err} > {tol}")
        res[label] = (err, tol)
        del geo, cor, got, want

    times = {}
    bf = torch.bfloat16
    shipped, wide = _build.load("geo_lookup"), k4_wide_variant()

    def window_ab(run):
        """(register, sliding, register, sliding) device ms and the two
        outputs' max-abs difference."""
        outs, ab = [], []
        for lib in (shipped, wide, shipped, wide):
            _build._loaded["geo_lookup"] = lib
            try:
                outs.append(run())
                ab.append(graph_ms(torch, run, 50))
            finally:
                _build._loaded["geo_lookup"] = shipped
        return ab, float((outs[0] - outs[1]).abs().max())

    for name, shape, widths in (("frame", IGEV_SHAPE, frame_w2),
                                ("step", IGEV_TRAIN_SHAPE, IGEV_TRAIN_W2)):
        geo, cor, disp, coords = k4_inputs(torch, gen, shape, IGEV_TRAIN_D, widths, bf)
        finite = torch.isfinite(disp.view(-1))
        ab, ab_err = window_ab(lambda: geo_lookup(geo, cor, disp, coords, r))
        library, lib_in, grids = k4_library(torch, geo, cor, disp, coords, r)
        n = disp.numel()
        lib = torch.cat([o.reshape(n, -1) for o in library()], dim=-1)
        want = geo_lookup_plain(geo, cor, disp, coords, r).reshape(n, -1)
        nbytes, out_bytes = k4_bytes(torch, geo, cor, disp, coords, r)
        times[name] = dict(
            ms=graph_ms(torch, lambda: geo_lookup(geo, cor, disp, coords, r), 50),
            plain_ms=graph_ms(torch, lambda: geo_lookup_plain(geo, cor, disp, coords, r), 2, 1),
            library_ms=graph_ms(torch, library, 20), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            mb=nbytes / 1e6, written=out_bytes / 1e6,
            lib_err=float((lib[finite] - want[finite]).abs().max()), ab=ab, ab_err=ab_err)
        del geo, cor, lib_in, grids, lib, want
    errs = " | ".join(f"{k} {e:.3e} (tol {t:.1e})" for k, (e, t) in res.items())
    print(f"K4 geo_lookup: max_abs vs plain {errs} (tol 1e-4 x the volumes' scale; NaN "
          f"disparity -> NaN where the plain version has NaN)")
    for name, t in times.items():
        shape = IGEV_SHAPE if name == "frame" else IGEV_TRAIN_SHAPE
        print(f"K4 geo_lookup at the {name}, bf16 {shape} geo D {IGEV_TRAIN_D} x {C}: device ms "
              f"{t['ms']:.4f} (one CUDA graph of 50 launches) | plain_ms {t['plain_ms']:.3f} | "
              f"library_ms {t['library_ms']:.4f} (grid_sample a volume and level, four calls, "
              f"fp32, upstream IGEV's form; max_abs vs plain {t['lib_err']:.2e}) | bound_ms "
              f"{t['bound_ms']:.4f} (bytes, {t['mb']:.2f} MB: {t['written']:.2f} written), "
              f"{t['bound_ms'] / t['ms']:.0%} of it; the kernel {t['ms'] / t['library_ms']:.2f}x "
              f"grid_sample's time | window A/B at r {r}, register / sliding / register / "
              f"sliding: " + " / ".join(f"{x:.4f}" for x in t["ab"]) + " ms (CUDA graphs of 50; "
              f"outputs differ by {t['ab_err']:.1e})")
    f = times["frame"]
    return dict(ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"], bound_by="bytes",
                library_ms=f["library_ms"], max_abs_err=max(e for e, _ in res.values()),
                step={k: times["step"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")})


def phase_k4_bwd(torch):
    """K4's backward (dgeo and dcorr kernels) vs its plain version at the
    IGEV training shapes and past the former caps (5 levels, radius 12), the
    adjoint check against the forward kernel at both; device times (a CUDA
    graph) beside the bound, the plain version and grid_sample's backward;
    autograd's bf16 sum of one iteration's d/dgeo into the running one."""
    from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import (
        geo_lookup, geo_lookup_bwd_corr, geo_lookup_bwd_geo, geo_lookup_bwd_plain)

    C, r = 8, 4
    gen = torch.Generator(device="cuda").manual_seed(11)
    parts = {"geo": geo_lookup_bwd_geo, "corr": geo_lookup_bwd_corr}
    res = {}
    adj = {}
    for label, shape, depths, widths, rr in (
            ("step", IGEV_TRAIN_SHAPE, IGEV_TRAIN_D, IGEV_TRAIN_W2, r),
            ("L 5 r 12", K4_WIDE["shape"], K4_WIDE["depths"], K4_WIDE["widths"], K4_WIDE["r"])):
        B, H, W1 = shape
        L = len(depths)
        _, _, disp, coords = k4_inputs(torch, gen, shape, depths[:1], widths[:1], torch.float32)
        finite = torch.isfinite(disp[..., 0])
        g = torch.randn((B, H, W1, L * (C + 1) * (2 * rr + 1)), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            geo_meta = [((B, H, W1, d, C), dt) for d in depths]
            corr_meta = [((B, H, W1, w2), dt) for w2 in widths]
            plain = geo_lookup_bwd_plain(geo_meta, corr_meta, disp, coords, g, rr)
            for (part, fn), want in zip(parts.items(), plain):
                got = fn(geo_meta, corr_meta, disp, coords, g, rr)
                check([d.dtype for d in got] == [dt] * L,
                      f"K4 bwd {part} {label} dtypes {[d.dtype for d in got]}")
                check(all(tuple(a.shape) == tuple(b.shape) for a, b in zip(got, want)),
                      f"K4 bwd {part} {label} shapes")
                # a NaN disparity gives NaN in its pixel's rows, in the
                # kernels as in the plain version
                check(all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(got, want)),
                      f"K4 bwd {part} {label}: NaN differs from the plain version")
                check(all(bool(torch.isnan(d[~finite]).all())
                          and not bool(torch.isnan(d[finite]).any()) for d in got),
                      f"K4 bwd {part} {label}: a NaN disparity did not give NaN rows")
                err = max(float((a[finite].float() - b[finite].float()).abs().max())
                          for a, b in zip(got, want))
                scale = max(float(b[finite].float().abs().max()) for b in want)
                # fp32: the kernels share one fractional weight per (pixel,
                # level); the plain version rounds each tap position on its
                # own. bf16: one rounding of fp32 sums that may differ in
                # their last bits: one bf16 step (2^-8) can flip
                tol = (1e-4 if dt == torch.float32 else 2**-7) * scale
                check(err <= tol, f"K4 bwd {part} {label} {dt} max-abs {err} > {tol}")
                res[(part, label, str(dt).split(".")[-1])] = (err, tol)
            del plain

        # adjoint: <K4(v), g> == <v, K4^T(g)>, the forward and both backward
        # kernels, fp32 pyramids, fp64 sums over the finite pixels (a NaN
        # pixel's outputs and rows are NaN on both sides)
        geo, cor, _, _ = k4_inputs(torch, gen, shape, depths, widths, torch.float32)
        with torch.no_grad():
            out = geo_lookup(geo, cor, disp, coords, rr)
        meta_g, meta_c = [(v.shape, v.dtype) for v in geo], [(v.shape, v.dtype) for v in cor]
        grads = (geo_lookup_bwd_geo(meta_g, meta_c, disp, coords, g, rr)
                 + geo_lookup_bwd_corr(meta_g, meta_c, disp, coords, g, rr))
        lhs = float((out[finite].double() * g[finite].double()).sum())
        rhs = float(sum((v[finite].double() * d[finite].double()).sum()
                        for v, d in zip(geo + cor, grads)))
        adj[label] = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
        check(adj[label] <= 1e-5, f"K4 adjoint check {label}: relative {adj[label]} > 1e-5")
        del geo, cor, out, grads

    B, H, W1 = IGEV_TRAIN_SHAPE
    bf = torch.bfloat16
    geo, cor, disp, coords = k4_inputs(torch, gen, IGEV_TRAIN_SHAPE, IGEV_TRAIN_D, IGEV_TRAIN_W2,
                                       bf)
    finite = torch.isfinite(disp[..., 0])
    g = torch.randn((B, H, W1, 2 * (C + 1) * (2 * r + 1)), generator=gen, device="cuda")
    geo_meta, corr_meta = [(v.shape, bf) for v in geo], [(v.shape, bf) for v in cor]
    # what autograd adds per student iteration: summing one iteration's
    # bf16 d/dgeo into the running d/dpyramid (15 such sums a step)
    acc = geo_lookup_bwd_geo(geo_meta, corr_meta, disp, coords, g, r)
    new = geo_lookup_bwd_geo(geo_meta, corr_meta, disp, coords, g, r)
    accum_ms = graph_ms(torch, lambda: [a.add_(b) for a, b in zip(acc, new)], 10)
    del acc, new
    # the yardstick: grid_sample's backward for the volumes, one call a
    # volume and level on phase 10's fp32 copies, its gradient in fp32
    _, lib_in, grids = k4_library(torch, geo, cor, disp.nan_to_num(0.0), coords, r)
    n, taps = disp.numel(), 2 * r + 1
    gl = g.reshape(n, 2, C + 1, taps)
    gouts = []
    for i in range(2):
        gouts += [gl[:, i, :C].reshape(n, C, 1, taps).contiguous(),
                  gl[:, i, C:].reshape(n, 1, 1, taps).contiguous()]
    # bytes each kernel must move: every output element written once (zeros
    # included), the g taps that land on at least one in-range element, disp
    # (and coords for dcorr) read once
    k = torch.arange(taps, device="cuda")
    d = disp.clamp(-1e6, 1e6)
    results = {}
    for pi, (part, fn) in enumerate(parts.items()):
        sizes = IGEV_TRAIN_D if part == "geo" else IGEV_TRAIN_W2
        per = C if part == "geo" else 1
        out_bytes = sum(B * H * W1 * n_ * per * 2 for n_ in sizes)
        g_read = 0
        for i, n_ in enumerate(sizes):
            x = d / 2**i if part == "geo" else (coords - d) / 2**i
            x0 = torch.floor((x - r).clamp(-(taps + 2), n_ + 1)) + k
            hit = ((x0 >= 0) & (x0 < n_)) | ((x0 + 1 >= 0) & (x0 + 1 < n_))
            g_read += int((hit & finite[..., None]).sum()) * per * 4
        nbytes = out_bytes + g_read + disp.numel() * 4 * (1 if part == "geo" else 2)
        sel = [2 * i + pi for i in range(2)]

        def library(sel=sel):
            return [torch.ops.aten.grid_sampler_2d_backward(
                gouts[j], lib_in[j], grids[j], 0, 0, True, [True, False])[0] for j in sel]

        results[part] = dict(
            ms=graph_ms(torch, lambda: fn(geo_meta, corr_meta, disp, coords, g, r), 20),
            # the plain version differentiates with autograd: host-timed
            plain_ms=cuda_ms(torch, lambda: geo_lookup_bwd_plain(
                geo_meta, corr_meta, disp, coords, g, r, need_geo=part == "geo",
                need_corr=part == "corr"), 3),
            library_ms=graph_ms(torch, library, 5), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", max_abs_err=max(e for (p_, *_), (e, _) in res.items() if p_ == part))
        t = results[part]
        errs = " ".join(f"{lab} {dt_} {e:.3e} (tol {tl:.1e})"
                        for (p_, lab, dt_), (e, tl) in res.items() if p_ == part)
        print(f"K4 geo_lookup_bwd_{part}: max_abs vs plain {errs} (tol 1e-4*max|dplain| fp32, "
              f"2^-7*max|dplain| bf16; NaN disparity -> NaN rows as the plain version) | "
              f"adjoint rel "
              + " ".join(f"{k_} {v:.2e}" for k_, v in adj.items()) + " (tol 1e-5, both kernels) "
              f"| bf16 {IGEV_TRAIN_SHAPE} {'D' if part == 'geo' else 'W2'} {sizes}: device ms "
              f"{t['ms']:.4f} (one CUDA graph of 20 launches) | plain_ms {t['plain_ms']:.3f} | "
              f"library_ms {t['library_ms']:.4f} (grid_sample's backward for the volumes, fp32, "
              f"a call a level) | bound_ms {t['bound_ms']:.4f} ({nbytes / 1e6:.2f} MB: "
              f"{out_bytes / 1e6:.2f} written, {g_read / 1e6:.2f} of g read), "
              f"{t['bound_ms'] / t['ms']:.0%} of it")
    results["geo"]["accum_ms"] = accum_ms
    print(f"autograd's bf16 sum of one iteration's d/dgeo into the running one: {accum_ms:.4f} "
          f"ms (one CUDA graph; x15 per step: {15 * accum_ms:.3f} ms)")
    del geo, cor, lib_in, grids, gouts
    return results


def phase_igev_parity(torch, config):
    """IGEV with the kernels on the card vs the plain path on the CPU, fp32
    with TF32 off, 2 iterations; and the plain path on the card vs the CPU,
    which measures what fp32 reordering alone moves."""
    import dkt_stereo_tpu_torch.models.igev_stereo as igev
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import geo_lookup, geo_lookup_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**config, "mixed_precision": False, "corr_dtype": "float32"}
    iters = 2
    gpu = create_model(cfg, iters=iters, device="cuda", seed=0)
    # the disparity head's last conv scaled by 0.05, as in the CPU test
    # (tests/test_torch_igev.py): an iteration then moves the disparity by a
    # few px, as a trained model's does, rather than by tens to hundreds of
    # px, where fp32 reordering alone grows with every iteration
    with torch.no_grad():
        gpu.update_block.disp_head.conv2.weight.mul_(0.05)
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.default_rng(9)
    img1, img2 = (rng.uniform(0, 255, (256, 512, 3)).astype(np.float32) for _ in range(2))
    n = geo_lookup.launches
    d_gpu, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
    check(geo_lookup.launches - n == iters, f"K4 launches {geo_lookup.launches - n} != {iters}")
    d_cpu, _ = _run_one(make_forward_fn(cpu, device="cpu"), img1, img2)
    igev.geo_lookup = geo_lookup_plain  # the plain lookup on the card, for the floor only
    try:
        d_plain, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
    finally:
        igev.geo_lookup = geo_lookup
    torch.backends.cudnn.allow_tf32 = True
    err = float(np.abs(d_gpu - d_cpu).max())
    floor = float(np.abs(d_plain - d_cpu).max())
    # the JAX package's bound between its reg and Pallas lookups
    # (tests/test_pallas_geo.py) and its packed and direct aggregation
    # (tests/test_igev_packed.py); twice the plain-vs-plain difference
    # where fp32 reordering alone comes near it
    tol = max(1e-3, 2 * floor)
    print(f"IGEV parity (fp32, corr_dtype float32, TF32 off, 1x256x512, {iters} iters): disp_up "
          f"max_abs kernels-vs-plain {err:.3e} px (max |disp| {np.abs(d_cpu).max():.1f} px, tol "
          f"{tol:.1e}) | plain on the card vs plain on the CPU {floor:.3e} px")
    check(np.isfinite(d_gpu).all() and err <= tol, f"IGEV parity {err} > {tol}")
    del gpu, cpu


def phase_igev_main(torch, config, card):
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    iters = 32
    model = create_model(config, iters=iters, seed=0)
    forward = make_forward_fn(model)
    rng = np.random.default_rng(10)
    img1, img2 = (rng.uniform(0, 255, (736, 1280, 3)).astype(np.float32) for _ in range(2))
    _run_one(forward, img1, img2)  # warm-up
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    times = []
    for _ in range(MAIN_FRAMES):
        disp, dt = _run_one(forward, img1, img2)
        times.append(dt)
    launches = kernel_counts()

    check(disp.shape == (736, 1280), f"IGEV disp shape {disp.shape}")
    check(bool(np.isfinite(disp).all()), "IGEV: non-finite disparity")
    want = {**dict.fromkeys(launches, 0), "geo_lookup": iters * MAIN_FRAMES}
    check(launches == want, f"IGEV launch counts {launches} != {want}")
    ms = 1e3 * np.asarray(times)
    print(f"IGEV main path (igev_stereo/pallas.json, bf16, 1x736x1280, {iters} iters, "
          f"{MAIN_FRAMES} frames): ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f} "
          f"min {ms.min():.2f} max {ms.max():.2f} | frames/s {1e3 / ms.mean():.3f} | "
          f"launches {launches} | peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"| disp range [{disp.min():.2f}, {disp.max():.2f}] | {card}")

    wall, busy, lines, buckets = device_profile(
        torch, lambda: _run_one(forward, img1, img2)[1], "chip_smoke_igev_profile.txt")
    print(f"profile of one IGEV frame (profiler on): wall {wall:.2f} ms, kernels {busy:.2f} ms, "
          f"device idle share {1 - busy / wall:.3f}; by bucket: {buckets}; top kernels:")
    for line in lines[:12]:
        print("  " + line[:160])
    return launches


IGEV_TRUNK = ("feature.", "stem_2.", "stem_4.", "conv.", "desc.")
# the batch norm the reference creates and never runs (weights.py:_UNUSED_BN)
IGEV_UNUSED = ("cost_agg.conv1_up.bn.",)


def phase_igev_train_parity(torch, train_cfg):
    """One IGEV DKT step with the kernels on the card vs the plain path on
    the CPU, from the same weights, batch and draws, fp32 with TF32 off,
    with freeze_backbone off so that both backward kernels run."""
    from dkt_stereo_tpu_torch.train.dkt_step import (
        create_dkt_state, fande_draws, make_dkt_train_step)
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**train_cfg, "mixed_precision": False, "corr_dtype": "float32",
           "freeze_backbone": False}
    hyper = DKTHyperParams(train_iters=2, teacher_iters=2)
    seed_state = create_dkt_state(cfg, hyper, seed=0, device="cuda")
    params = seed_state.student.state_dict()
    # the disparity head's last conv scaled by 0.05, as in phase 12 and the
    # CPU tests: random IGEV weights are chaotic under fp32 reordering
    params["update_block.disp_head.conv2.weight"].mul_(0.05)
    to_cpu = {k: v.to("cpu", copy=True) for k, v in params.items()}
    gpu = create_dkt_state(cfg, hyper, params=params, device="cuda")
    cpu = create_dkt_state(cfg, hyper, params=to_cpu, device="cpu")
    del seed_state
    gen = torch.Generator().manual_seed(12)
    batch = _train_batch(torch, gen, 1, 64, 128, "cpu")
    draws = fande_draws(1, "cpu", gen)
    step = make_dkt_train_step(cfg, hyper)
    before = kernel_counts()
    gpu, m_gpu = step(gpu, {k: v.cuda() for k, v in batch.items()},
                      draws={k: v.cuda() for k, v in draws.items()})
    torch.cuda.synchronize()
    launches = _diff(kernel_counts(), before)
    cpu, m_cpu = step(cpu, batch, draws=draws)
    # the chaos floor: the same CPU step from weights scaled by
    # 1 + 1e-5 N(0, 1)
    noise = torch.Generator().manual_seed(7)
    nudged = {k: v * (1 + 1e-5 * torch.randn(v.shape, generator=noise))
              if v.is_floating_point() else v for k, v in to_cpu.items()}
    cpu2, _ = step(create_dkt_state(cfg, hyper, params=nudged, device="cpu"), batch, draws=draws)
    torch.backends.cudnn.allow_tf32 = True

    check(m_gpu["ok"] == m_cpu["ok"] == 1.0, f"IGEV ok gpu {m_gpu['ok']} cpu {m_cpu['ok']}")
    # teachers 2 + 2, student 2, remat recompute 2; one dgeo and one dcorr
    # launch per student iteration
    want = {**dict.fromkeys(launches, 0), "geo_lookup": 8, "geo_lookup_bwd_geo": 2,
            "geo_lookup_bwd_corr": 2}
    check(launches == want, f"IGEV train parity launches {launches} != {want}")
    loss_err = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                for k in ("loss", "loss_GT", "loss_PL")}
    for k, e in loss_err.items():
        check(e <= 1e-3, f"IGEV train parity {k}: relative {e} > 1e-3")
    want_grads = dict(cpu.student.named_parameters())
    rel = _grad_rel(gpu.student.named_parameters(), want_grads)
    floor = _grad_rel(cpu2.student.named_parameters(), want_grads)
    for g, e in rel.items():
        check(e <= (0.05 if g == "all" else 0.1),
              f"IGEV train parity gradient of {g}: relative {e}")

    def norm(state, prefix):
        return float(torch.stack([p.grad.norm().cpu() for k, p in state.student.named_parameters()
                                  if k.startswith(prefix) and p.grad is not None]).norm())

    reached = {m: norm(gpu, m + ".") for m in ("cost_agg", "conv", "desc")}
    # cost_agg is reached only through dgeo and the init term; conv and
    # desc through the GWC volume and dcorr
    check(all(v > 0 for v in reached.values()), f"no gradient on the card: {reached}")
    print(f"IGEV train-step parity (fp32, TF32 off, freeze_backbone off, 1x64x128, 2+2 iters), "
          f"kernels vs plain: loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f}, relative errors "
          + " ".join(f"{k} {e:.2e}" for k, e in loss_err.items()) + " (tol 1e-3) | gradient "
          "relative L2 error by module " + " ".join(f"{g} {e:.2e}" for g, e in rel.items())
          + " (tol 0.1 per module, 0.05 all; chaos floor on the CPU from a 1e-5 weight nudge: "
          + " ".join(f"{g} {e:.2e}" for g, e in floor.items())
          + ") | card gradient norms " + " ".join(f"{m} {v:.3e}" for m, v in reached.items())
          + f" | launches {launches}")
    del gpu, cpu, cpu2


def phase_igev_train(torch, train_cfg, card):
    """igev_stereo/train.json at full width: 1 warm-up and TRAIN_STEPS timed
    DKT steps at B=8, 320x736, 16 student / 32 teacher iterations."""
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    B, H, W = IGEV_TRAIN_IMAGE
    hyper = DKTHyperParams(train_iters=16, teacher_iters=32)
    state = create_dkt_state(train_cfg, hyper, seed=0)
    step = make_dkt_train_step(train_cfg, hyper)
    gen = torch.Generator(device="cuda").manual_seed(13)

    before = snapshot(state, "IGEV")

    state, run = timed_steps(torch, state, step, gen, (B, H, W), "IGEV")
    per_step, launches, metrics = run["per_step"], run["launches"], run["metrics"]
    # 2 x 32 teacher iterations + 16 student + 16 recomputed by remat; one
    # dgeo launch per student iteration; no dcorr (the frozen backbone
    # detaches the descriptors, so the corr pyramid needs no gradient)
    want = {**dict.fromkeys(launches, 0), "geo_lookup": 96, "geo_lookup_bwd_geo": 16}
    check(all(c == want for c in per_step), f"IGEV launches per step {per_step} != {want}")
    # every tensor outside the detached trunk and the unused slots gets a
    # gradient (a non-zero Adam first moment) and moves, unless its gradient
    # is below Adam's eps (1e-8) everywhere: AdamW's step, about lr*g/eps,
    # is then below fp32's resolution of the weight. With random weights
    # that is the 1/32-scale attention of the hourglass, whose input, the
    # random MobileNetV2's x32 map, is ~1e-7 in size
    params = dict(state.student.named_parameters())
    graded = [k for k in params if not k.startswith(IGEV_TRUNK + IGEV_UNUSED)]
    moment = {k: float(state.optimizer.state[params[k]]["exp_avg"].abs().max()) for k in graded}
    check(all(m > 0 for m in moment.values()),
          f"student tensors without gradient: {[k for k, m in moment.items() if m == 0][:5]}")
    student0 = before["student"]
    still = [k for k in graded if torch.equal(params[k], student0[k])]
    check(all(moment[k] < 1e-8 for k in still),
          f"student tensors with a gradient that did not move: "
          f"{[(k, moment[k]) for k in still if moment[k] >= 1e-8][:5]}")
    # a tensor without a gradient moves by AdamW's weight decay alone: a
    # zero tensor stays zero
    zeros = [k for k in params if k not in graded and not bool(student0[k].any())]
    check(all(not bool(params[k].any()) for k in zeros), "a zero tensor without gradient moved")
    check_moved_and_frozen(torch, state, before, "IGEV", moved=False)

    print(f"IGEV training path (igev_stereo/train.json, bf16, remat, freeze_backbone, B={B} "
          f"{H}x{W}, {hyper.train_iters}/{hyper.teacher_iters} iters, {TRAIN_STEPS} steps after "
          f"1 warm-up): {step_line(run)} | init_epe "
          + ", ".join(f"{x['init_epe']:.3f}" for x in metrics) + f" | epe {metrics[-1]['epe']:.3f} "
          f"| {len(graded)} student tensors with a gradient, {len(graded) - len(still)} moved; "
          f"not moved, gradient below Adam's eps: "
          + (", ".join(f"{k} (|m| {moment[k]:.1e})" for k in still) or "none")
          + f" | lr {metrics[-1]['learning_rate']:.3e} | {card}")
    profile_step(torch, state, step, gen, (B, H, W), run["ms"].mean(),
                 "chip_smoke_igev_train_profile.txt", "IGEV training")
    return launches


ALT_IMAGE = (1984, 2880)  # Middlebury-F geometry, the JAX package's MEMORY_r02.json
ALT_SHAPE = (1, 496, 720)  # its 1/4 grid
ALT_D = 256  # fnet width
ALT_FRAMES = 5


def _alt_inputs(torch, gen, B, H, W, dt, L=4, D=ALT_D):
    """fmap1, fmap2 and its pooled pyramid (B, H, W, D) in ``dt``, and
    coordinates in [-10, W+10] with far out-of-range, negative and NaN
    entries; returns a mask of the finite pixels too."""
    from dkt_stereo_tpu_torch.ops.corr import fmap_pyramid

    f1, f2 = (torch.randn((B, H, W, D), generator=gen, device="cuda").to(dt)
              for _ in range(2))
    coords = torch.rand((B, H, W, 1), generator=gen, device="cuda") * (W + 20) - 10
    coords.view(-1)[:9] = torch.tensor([-1e9, 1e9, 3e7, -0.5, -1.0, 0.0, 17.0, W - 1.0,
                                        float("nan")])
    return f1, f2, fmap_pyramid(f2, L), coords, torch.isfinite(coords[..., 0])


def frame_coords(torch, B, H, W):
    """The coordinates of a frame on the 1/4 grid: x - d with d = 16 +
    160 y/H + 8 sin(2 pi x/90), 16-184 px, Middlebury-F's disparity range at
    1/4 resolution."""
    y = torch.arange(H, device="cuda", dtype=torch.float32)[:, None]
    x = torch.arange(W, device="cuda", dtype=torch.float32)[None, :]
    d = 16 + 160 * y / H + 8 * torch.sin(2 * np.pi * x / 90)
    return (x - d).expand(B, H, W)[..., None].contiguous()


def alt_bound(torch, f1, pyr, coords, r):
    """(bound ms, bound_by, MB, fp32-core ms) of one K3 launch on these
    inputs: fmap1, coords and the output once, and each in-range column of
    a row's pooled features that some pixel of the row reads, once; the
    products that touch an in-range column, at the features' peak rate."""
    B, H, W1, D = f1.shape
    taps = 2 * r + 1
    size = f1.element_size()
    j = torch.arange(taps + 1, device=coords.device)
    c = coords.clamp(-1e6, 1e6)  # NaN stays NaN and reads nothing
    cols = products = 0
    for i, v in enumerate(pyr):
        w2 = v.shape[2]
        idx = torch.floor(c / 2**i - r) + j
        hit = (idx >= 0) & (idx < w2)
        products += int(hit.sum()) * D
        seen = torch.zeros((B * H, w2 + 1), dtype=torch.bool, device=coords.device)
        seen.scatter_(1, torch.where(hit, idx, float(w2)).long().view(B * H, -1), True)
        cols += int(seen[:, :w2].sum())
    nbytes = (f1.numel() + cols * D) * size + coords.numel() * 4 + B * H * W1 * len(pyr) * taps * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * products / PEAK_FLOPS[str(f1.dtype).split(".")[-1]] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes / 1e6,
            2 * products / PEAK_FLOPS["float32"] * 1e3)


def phase_k3(torch):
    """K3 vs its plain version at the full-resolution path's shapes and at
    ragged ones, at random coordinates (bands wider than a piece), at a
    frame's coordinates and at nearly constant ones (a band of one piece),
    at depths 3 and 20 and at 5 levels with radius 12; times at random and
    frame coordinates, and the materialized route."""
    from dkt_stereo_tpu_torch.ops.corr import corr_pyramid_fused
    from dkt_stereo_tpu_torch.ops.cuda.corr_alt import corr_lookup_alt, corr_lookup_alt_plain
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's fp32 products
    gen = torch.Generator(device="cuda").manual_seed(14)
    res = {}

    def hold(label, f1, pyr, coords, finite, r):
        L = len(pyr)
        got = corr_lookup_alt(f1, pyr, coords, r)
        want = corr_lookup_alt_plain(f1, pyr, coords, r)
        check(got.shape == (*coords.shape[:3], L * (2 * r + 1)),
              f"K3 {label}: output shape {tuple(got.shape)}")
        # a NaN coordinate gives NaN in all its taps, as in the plain version
        check(torch.equal(torch.isnan(got), torch.isnan(want)),
              f"K3 {label}: NaN differs from the plain version")
        check(bool(torch.isnan(got[~finite]).all()) and not bool(torch.isnan(got[finite]).any()),
              f"K3 {label}: a NaN coordinate did not give NaN in exactly its pixel")
        err = float((got[finite] - want[finite]).abs().max())
        # fp32 sums of the same products in another order; the kernel
        # shares one fractional weight per (pixel, level), where the plain
        # version rounds each tap position x/2^i + k - r on its own: a
        # weight moves by up to one fp32 ulp of the position (6e-5 at
        # 512-1024)
        tol = 1e-4 * float(want[finite].abs().max())
        check(err <= tol, f"K3 {label} max-abs {err} > {tol}")
        res[label] = (err, tol)

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        for shape in ((2, 7, 37), ALT_SHAPE):
            f1, f2, pyr, coords, finite = _alt_inputs(torch, gen, *shape, dt)
            hold(f"{'x'.join(map(str, shape))} {name} random", f1, pyr, coords, finite, 4)
        # the same features at a frame's coordinates, and at nearly constant
        # ones: every block's band is one piece at every level
        for kind, c in (("frame", frame_coords(torch, *ALT_SHAPE)),
                        ("narrow", 200.0 + 0.05 * coords.nan_to_num(0.0).clamp(-10, 730))):
            hold(f"{'x'.join(map(str, ALT_SHAPE))} {name} {kind}", f1, pyr, c,
                 torch.ones(c.shape[:3], dtype=torch.bool, device="cuda"), 4)
        del f1, f2, pyr, coords, finite
        # beyond the first kernel's caps: depths that are not a multiple of
        # 8 (no bulk copies in bf16) and 5 levels with radius 12
        for D, L, r in ((3, 4, 4), (20, 4, 4), (ALT_D, 5, 12)):
            f1, _, pyr, coords, finite = _alt_inputs(torch, gen, 2, 5, 150, dt, L, D)
            hold(f"2x5x150 {name} D {D} L {L} r {r}", f1, pyr, coords, finite, r)

    r, L = 4, 4
    f1, f2, pyr, coords, _ = _alt_inputs(torch, gen, *ALT_SHAPE, torch.bfloat16)
    ms = cuda_ms(torch, lambda: corr_lookup_alt(f1, pyr, coords, r), 50)
    plain_ms = cuda_ms(torch, lambda: corr_lookup_alt_plain(f1, pyr, coords, r), 2)
    fc = frame_coords(torch, *ALT_SHAPE)
    frame_ms = cuda_ms(torch, lambda: corr_lookup_alt(f1, pyr, fc, r), 50)
    frame_bound, frame_by, frame_mb, _ = alt_bound(torch, f1, pyr, fc, r)
    # the materialized route for the same lookup: the fused volume pyramid
    # (cuBLAS, fp32 products, stored bf16) and one K1 launch
    reg_ms = cuda_ms(torch, lambda: corr_lookup(
        corr_pyramid_fused(f1, f2, L, out_dtype=f1.dtype), coords, r), 5)
    bound_ms, bound_by, mb, f32_ms = alt_bound(torch, f1, pyr, coords, r)
    errs = " ".join(f"{k} {e:.3e} (tol {t:.2e})" for k, (e, t) in res.items())
    print(f"K3 corr_lookup_alt: max_abs {errs} (tol 1e-4 x max|plain|; NaN coordinate -> "
          f"NaN as the plain version) | bf16 {ALT_SHAPE} D {ALT_D} widths "
          f"{[v.shape[2] for v in pyr]}: random "
          f"coordinates kernel_ms {ms:.4f} plain_ms {plain_ms:.3f} bound_ms {bound_ms:.4f} "
          f"({bound_by}, {mb:.2f} MB; products on the fp32 cores {f32_ms:.4f} ms) | frame "
          f"coordinates kernel_ms {frame_ms:.4f} bound_ms {frame_bound:.4f} ({frame_by}, "
          f"{frame_mb:.2f} MB) | library_ms none (no single PyTorch call computes the "
          f"four-level lookup without a volume) reg_route_ms {reg_ms:.3f} (fused pyramid + K1)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, reg_route_ms=reg_ms, frame_ms=frame_ms,
                frame_bound_ms=frame_bound, max_abs_err=max(e for e, _ in res.values()))


def phase_k3_vjp(torch):
    """Gradients through CorrLookupAlt (kernel forward, recompute backward)
    vs autograd of the plain version, on the card."""
    from dkt_stereo_tpu_torch.ops.cuda.corr_alt import corr_lookup_alt, corr_lookup_alt_plain

    B, H, W = 2, 40, 90
    r, L = 4, 4
    gen = torch.Generator(device="cuda").manual_seed(15)
    g = torch.randn((B, H, W, L * (2 * r + 1)), generator=gen, device="cuda")
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        # NaN coordinates kept: the kernel's forward gives NaN where the plain
        # one does, and the recompute backward NaN where autograd of the
        # plain version does
        f1, _, pyr, coords, _ = _alt_inputs(torch, gen, B, H, W, dt, L)
        leaves = [t.detach().requires_grad_(True) for t in (f1, *pyr)]
        n = corr_lookup_alt.launches
        out = corr_lookup_alt(leaves[0], leaves[1:], coords, r)
        check(corr_lookup_alt.launches == n + 1, "K3 VJP: the forward did not launch K3")
        got = torch.autograd.grad(out, leaves, g)
        plain = corr_lookup_alt_plain(leaves[0], leaves[1:], coords, r)
        check(torch.equal(torch.isnan(out), torch.isnan(plain)),
              "K3 VJP: the forward's NaN differs from the plain version's")
        want = torch.autograd.grad(plain, leaves, g)
        check([d.dtype for d in got] == [dt] * (L + 1), f"K3 VJP dtypes {[d.dtype for d in got]}")
        check(all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(got, want)),
              "K3 VJP: NaN differs from autograd of the plain version")
        check(any(bool(torch.isnan(b).any()) for b in want), "K3 VJP: no NaN gradient")
        err = max(float((a.float() - b.float()).nan_to_num(0.0).abs().max())
                  for a, b in zip(got, want))
        scale = max(float(b.float().nan_to_num(0.0).abs().max()) for b in want)
        # fp32: sums in another order (scatter-add atomics); bf16: one
        # rounding of fp32 sums that may differ in their last bits
        tol = (1e-4 if dt == torch.float32 else 2**-7) * scale
        check(err <= tol, f"K3 VJP {dt} max-abs {err} > {tol}")
        res[dt] = (err, scale)
    print(f"K3 VJP (recompute backward) vs autograd of plain, {B}x{H}x{W} D {ALT_D}: max_abs "
          + " ".join(f"{str(d).split('.')[-1]} {e:.3e} (max|grad| {s:.3e})"
                     for d, (e, s) in res.items()) + " (tol fp32 1e-4, bf16 2^-7 x max|grad|; "
          "NaN coordinates: NaN where autograd of plain has NaN)")


def phase_alt_parity(torch, config):
    """RAFT with alt_cuda (K3 on the card) and with alt (plain on the card)
    vs the plain path on the CPU, fp32 with TF32 off, 2 iterations."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.ops.cuda.corr_alt import corr_lookup_alt

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    iters = 2
    rng = np.random.default_rng(16)
    img1, img2 = (rng.uniform(0, 255, (256, 512, 3)).astype(np.float32) for _ in range(2))
    out = {}
    for mode in ("alt_cuda", "alt"):
        cfg = {**config, "mixed_precision": False, "corr_dtype": "float32",
               "corr_implementation": mode}
        gpu = create_model(cfg, iters=iters, device="cuda", seed=0)
        cpu = copy.deepcopy(gpu).to("cpu")
        n = corr_lookup_alt.launches
        d_gpu, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
        k3 = corr_lookup_alt.launches - n
        check(k3 == (iters if mode == "alt_cuda" else 0), f"{mode} parity: {k3} K3 launches")
        d_cpu, _ = _run_one(make_forward_fn(cpu, device="cpu"), img1, img2)
        err = float(np.abs(d_gpu - d_cpu).max())
        # RAFT's kernels-vs-plain bound (phase 4; PERF.md section 2)
        check(np.isfinite(d_gpu).all() and err <= 5e-3, f"{mode} parity {err} > 5e-3")
        out[mode] = (err, float(np.abs(d_cpu).max()), k3)
        del gpu, cpu
    torch.backends.cudnn.allow_tf32 = True
    print("alt parity (fp32, TF32 off, 1x256x512, 2 iters), card vs plain on the CPU: "
          + " | ".join(f"{m} disp_up max_abs {e:.3e} px (max |disp| {s:.1f} px, K3 launches "
                       f"{k})" for m, (e, s, k) in out.items()) + " (tol 5e-3)")


def phase_k2_fullres(torch):
    """K2 vs its plain version at the full-resolution fnet's shape, the
    plain stage and the one with v and emit_h, each timed beside its
    bound."""
    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage

    B, (H, W), C = 2, ALT_IMAGE, 64
    gen = torch.Generator(device="cuda").manual_seed(17)
    u, a1, b1, vkw = k2_inputs(torch, gen, B, H, W)
    w = torch.randn((C, C, 3, 3), generator=gen, device="cuda") * (2.0 / (9 * C)) ** 0.5
    out = []
    for name, kw in (("plain", {}), ("v+emit_h", dict(vkw, emit_h=True))):
        # as phase 3: one bf16 flip in y, fp32 statistics over 5.7M pixels a sample
        rel, _ = k2_errors(torch, f"{(B, H, W, C)} {name}", (u, a1, b1, w), kw)
        torch.cuda.empty_cache()
        ms = cuda_ms(torch, lambda: encoder_stage(u, a1, b1, w, **kw), 5)
        bound_ms, bound_by = k2_bound(B, H, W, "v" in kw)
        out.append(f"[{name}] rel max_abs {_fmt_rel(rel)} kernel_ms {ms:.4f} bound_ms "
                   f"{bound_ms:.4f} ({bound_by})")
    print(f"K2 encoder_stage at the full-resolution fnet's {(B, H, W, C)} bf16 "
          f"({u.numel() / 1e6:.0f} M elements): " + " | ".join(out)
          + " (tol y, h 2^-7, statistics 1e-4)")
    del u, vkw
    torch.cuda.empty_cache()


def phase_alt_main(torch, config, reg_config, card):
    """alt_pallas.json at full resolution: 1 warm-up and ALT_FRAMES timed
    frames with exact launch counts, a profile, and one reg_cuda frame."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    phase_k2_fullres(torch)
    torch.cuda.empty_cache()
    iters = 32
    H, W = ALT_IMAGE
    model = create_model(config, iters=iters, seed=0)
    forward = make_forward_fn(model)
    rng = np.random.default_rng(18)
    img1, img2 = (rng.uniform(0, 255, (H, W, 3)).astype(np.float32) for _ in range(2))
    _run_one(forward, img1, img2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    times, per_frame = [], []
    for _ in range(ALT_FRAMES):
        before = kernel_counts()
        disp, dt = _run_one(forward, img1, img2)
        times.append(dt)
        per_frame.append(_diff(kernel_counts(), before))
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    check(disp.shape == (H, W), f"alt disp shape {disp.shape}")
    check(bool(np.isfinite(disp).all()), "alt: non-finite disparity")
    want = {**dict.fromkeys(launches, 0), "corr_lookup_alt": iters, "encoder_stage": 4}
    check(all(c == want for c in per_frame), f"alt launches per frame {per_frame} != {want}")
    # what the corr section keeps for the whole frame: fmap1 and the pooled
    # right features (bf16), against the volume pyramid of reg_cuda
    Hc, Wc = H // 4, W // 4
    feats = Hc * Wc * ALT_D * 2 + sum(Hc * (Wc >> i) * ALT_D * 2 for i in range(4))
    volume = sum(Hc * Wc * (Wc >> i) * 2 for i in range(4))
    ms = 1e3 * np.asarray(times)
    print(f"alt path (alt_pallas.json, bf16, alt_cuda, 1x{H}x{W}, {iters} iters, {ALT_FRAMES} "
          f"frames after 1 warm-up): ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f} "
          f"min {ms.min():.2f} max {ms.max():.2f} | frames/s {1e3 / ms.mean():.3f} | launches "
          f"{launches} | peak mem {peak:.2f} GiB | corr section persistent {feats / 1e9:.3f} GB "
          f"(fmap1 + pooled pyramid) vs volume pyramid {volume / 1e9:.3f} GB | disp range "
          f"[{disp.min():.2f}, {disp.max():.2f}] | {card}")

    def whole_frame():
        # the wall clock also covers _run_one's copy of the images to the
        # card (30 ms of pageable copies at this size), which the profile
        # counts as device time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _run_one(forward, img1, img2)
        return time.perf_counter() - t0

    wall, busy, lines, buckets = device_profile(torch, whole_frame, "chip_smoke_alt_profile.txt")
    import re

    per_launch = " ".join(f"{k} {float(t) / int(n):.4f} ms" for k, t, n in
                          re.findall(r"(K3|K2) ([\d.]+) ms/(\d+)", buckets) if int(n))
    print(f"profile of one alt frame, image copies included (profiler on): wall {wall:.2f} ms, "
          f"kernels and copies {busy:.2f} ms, device idle share {1 - busy / wall:.3f}; a "
          f"launch: {per_launch}; by bucket: {buckets}; top kernels:")
    for line in lines[:12]:
        print("  " + line[:160])
    del model, forward
    torch.cuda.empty_cache()

    # the same frame through pallas.json (reg_cuda: the volume pyramid)
    forward = make_forward_fn(create_model(reg_config, iters=iters, seed=0))
    _run_one(forward, img1, img2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    reg_disp, reg_dt = _run_one(forward, img1, img2)
    reg_launches = kernel_counts()
    want = {**dict.fromkeys(reg_launches, 0), "corr_lookup": iters, "encoder_stage": 4}
    check(reg_launches == want, f"reg_cuda launches {reg_launches} != {want}")
    check(bool(np.isfinite(reg_disp).all()), "reg_cuda: non-finite disparity")
    print(f"the same frame through pallas.json (reg_cuda): {1e3 * reg_dt:.2f} ms | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches {reg_launches} | "
          f"{card}")
    del forward
    torch.cuda.empty_cache()
    return launches


PCV_IMAGE = (736, 1280)
PCV_SHAPE = (1, 184, 320)  # base.json's 1/4 grid of the main path
PCV_FAST_SHAPE = (1, 92, 160)  # fast.json's 1/8 grid
PCV_G, PCV_S, PCV_L = 4, 9, 3  # gauss_num, sample_num, corr_levels of both configs
PCV_FAST_FRAMES = 5


def _k5_inputs(torch, gen, shape, cf, dt, L=PCV_L):
    """``L`` levels of widths W, W/cf, W/cf^2, ... in ``dt`` and the level-0
    positions mu + sigma*dx of a random mixture (sigma in [0.1, 16], mu over
    and beyond the row), with far out-of-range, negative, past-the-row,
    exact-integer (0 and W2-1 among them) and NaN positions; and the mask of
    the output entries whose position is finite."""
    from dkt_stereo_tpu_torch.nn.pcv import gaussian_positions

    B, H, W = shape
    levels = [(4 * torch.randn((B, H, W, W // cf**i), generator=gen, device="cuda")).to(dt)
              for i in range(L)]
    mu = torch.rand((B, PCV_G, H, W), generator=gen, device="cuda") * (W + 40) - 20
    sigma = 0.1 + 15.9 * torch.rand((B, PCV_G, H, W), generator=gen, device="cuda")
    pos = gaussian_positions(mu, sigma, PCV_S)
    pos.view(-1)[:12] = torch.tensor([-1e9, 1e9, 3e7, -0.5, -1.0, -3.0, 0.0, 17.0, W - 1.0,
                                      W + 0.25, float(2 * cf**2), float("nan")])
    return levels, pos, torch.isfinite(pos).repeat(1, 1, 1, L)


def k5_bound(torch, levels, pos, cf, out_itemsize=2):
    """(bound ms, MB) of one K5 launch on these inputs: the positions and
    the output (in the compute dtype) once, and each in-range volume entry
    that some tap of its row reads, once (non-finite positions read
    nothing)."""
    B, H, W1, K = pos.shape
    n = B * H * W1
    p = pos.nan_to_num(0.0, 1e6, -1e6).clamp(-1e6, 1e6)
    read = 0
    for i, v in enumerate(levels):
        w2 = v.shape[-1]
        x0 = torch.floor(p / cf**i)
        idx = torch.stack([x0, x0 + 1], dim=-1)
        hit = (idx >= 0) & (idx < w2) & torch.isfinite(pos)[..., None]
        seen = torch.zeros((n, w2 + 1), dtype=torch.bool, device=pos.device)
        seen.scatter_(1, torch.where(hit, idx, float(w2)).long().view(n, -1), True)
        read += int(seen[:, :w2].sum()) * v.element_size()
    nbytes = read + pos.numel() * 4 + n * len(levels) * K * out_itemsize
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes / 1e6


def k5_library(torch, levels, pos, cf):
    """The yardstick: one ``F.grid_sample`` a level on an (N, 1, 1, W2) fp32
    copy with an (N, 1, K, 2) grid, the reference's own form of the lookup;
    fp32, because a bf16 grid cannot hold the positions (8 bits of mantissa
    at positions up to 340). Returns the forward, the inputs and the grids."""
    import torch.nn.functional as F

    B, H, W1, K = pos.shape
    n = B * H * W1
    lib_in = [v.float().reshape(n, 1, 1, v.shape[-1]) for v in levels]
    grids = []
    for i, v in enumerate(lib_in):
        x = (pos.clamp(-1e6, 1e6) / cf**i).reshape(n, 1, K, 1)
        x = 2 * x / (v.shape[-1] - 1) - 1
        grids.append(torch.cat([x, torch.zeros_like(x)], dim=-1))

    def forward():
        return [F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=True)
                for v, g in zip(lib_in, grids)]

    return forward, lib_in, grids


def _kernel_launches(torch, fn):
    """Device kernels and copies of one call of ``fn`` by bucket, from the
    profiler: {bucket: launches}."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    tot = {b: 0 for b, _ in BUCKETS}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot[next(b for b, pat in BUCKETS if re.search(pat, e.name))] += 1
    return {b: n for b, n in tot.items() if n}


def phase_k5(torch):
    """K5 vs ``fold_lookup(plain).to(dt)`` at both PCV grids, the training
    step's and a ragged shape, bit for bit; device times (a CUDA graph)
    beside the bound, the plain version and grid_sample at the frame and the
    step; the motion encoder on the kernel's output and on an NCHW copy;
    K5's autograd Function launching the backward; the backward's limits
    checked before the forward."""
    from dkt_stereo_tpu_torch.nn.pcv import BasicMotionEncoderPCV
    from dkt_stereo_tpu_torch.ops.cuda import row_sample as k5
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import (
        fold_lookup, gaussian_row_sample, gaussian_row_sample_bwd,
        gaussian_row_sample_bwd_plain, gaussian_row_sample_folded_plain,
        gaussian_row_sample_plain, unfold_lookup)

    gen = torch.Generator(device="cuda").manual_seed(19)
    G = PCV_G
    res = {}

    def hold(label, levels, pos, cf, dt):
        got = k5._launch_fwd(levels, pos, cf, G, dt)
        plain = gaussian_row_sample_plain(levels, pos, cf)
        want = fold_lookup(plain, PCV_L, G).to(dt)
        check(got.dtype == want.dtype and got.shape == want.shape
              and got.stride() == want.stride(),
              f"K5 {label}: {got.dtype} {tuple(got.shape)} strides {got.stride()}, want "
              f"{want.dtype} {tuple(want.shape)} {want.stride()}")
        nan = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan), f"K5 {label}: NaN differs from the plain twin")
        check(int(nan.sum()) == int((~torch.isfinite(pos)).sum()) * PCV_L,
              f"K5 {label}: {int(nan.sum())} NaN outputs")
        # the plain twin's fp32 operations tap by tap, rounded once: equal
        err = float((got[~nan].float() - want[~nan].float()).abs().max())
        check(err == 0.0, f"K5 {label}: max-abs {err} against fold(plain).to(dt)")
        res[label] = err

    for shape, cf, pairs in (((2, 7, 37), 4, ((F32, F32), (BF16, BF16), (F32, BF16), (BF16, F32))),
                             (PCV_FAST_SHAPE, 2, ((F32, F32), (BF16, BF16))),
                             (PCV_SHAPE, 4, ((F32, F32), (BF16, BF16), (F32, BF16))),
                             (TRAIN_SHAPE, 4, ((F32, F32), (BF16, BF16)))):
        for vol, out in pairs:
            levels, pos, _ = _k5_inputs(torch, gen, shape, cf, getattr(torch, vol))
            label = f"{'x'.join(map(str, shape))} {vol}->{out}"
            hold(label, levels, pos, cf, getattr(torch, out))
            del levels, pos

    times = {}
    bf = torch.bfloat16
    for name, shape in (("frame", PCV_SHAPE), ("step", TRAIN_SHAPE)):
        levels, pos, finite = _k5_inputs(torch, gen, shape, 4, bf)
        library, lib_in, grids = k5_library(torch, levels, pos, 4)
        B, H, W1, K = pos.shape
        lib = torch.cat([o.view(B, H, W1, K) for o in library()], dim=-1)
        plain = gaussian_row_sample_plain(levels, pos, 4)
        bound_ms, mb = k5_bound(torch, levels, pos, 4)
        # the bytes the kernel moves with its rows read whole, and a device
        # copy moving as many (half read, half written): the card's rate
        whole = (sum(v.numel() * v.element_size() for v in levels) + pos.numel() * 4
                 + plain.numel() * 2)
        src = torch.empty(whole // 4, dtype=bf, device="cuda")
        dst = torch.empty_like(src)
        times[name] = dict(
            ms=graph_ms(torch, lambda: gaussian_row_sample(levels, pos, 4, G, bf), 50),
            plain_ms=graph_ms(torch, lambda: gaussian_row_sample_folded_plain(
                levels, pos, 4, G, bf), 5),
            library_ms=graph_ms(torch, library, 20), bound_ms=bound_ms, mb=mb,
            lib_err=float((lib[finite] - plain[finite]).abs().max()),
            widths=[v.shape[-1] for v in levels], whole_mb=whole / 1e6,
            copy_ms=graph_ms(torch, lambda: dst.copy_(src), 20))
        del src, dst
        if name == "step":
            # the motion encoder on K5's channels-last output and on an NCHW
            # copy of it, its corr convs' weights in the same layout, bf16
            # autocast with fp32 weights as in the model
            enc = BasicMotionEncoderPCV(G, PCV_S, PCV_L).cuda().eval()
            mix = [torch.rand((B, G, H, W1), generator=gen, device="cuda").to(bf)
                   for _ in range(3)]
            probe = {}
            corr_cl = gaussian_row_sample(levels, pos, 4, G, bf)
            for cl in (True, False):
                corr = corr_cl if cl else corr_cl.contiguous()
                for conv in (enc.convc1, enc.convc2, enc.convc3):  # weights in the same layout
                    conv.to(memory_format=torch.channels_last if cl else
                            torch.contiguous_format)

                def run(corr=corr):
                    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16,
                                                         cache_enabled=False):
                        return enc(mix[0], corr, mix[1], mix[2])

                probe["channels-last" if cl else "NCHW"] = (graph_ms(torch, run, 10),
                                                            _kernel_launches(torch, run))
            times[name]["probe"] = probe
            del enc, mix, corr, corr_cl
        del levels, pos, lib_in, grids, lib, plain

    # with inputs that require grad, the autograd Function launches the
    # forward once and the backward once, and its gradients are the plain
    # backward's; a gradient in the other layout costs one counted copy
    small = [torch.randn((1, 2, 3, 8), device="cuda", requires_grad=True),
             torch.randn((1, 2, 3, 2), device="cuda", requires_grad=True)]
    p = (10 * torch.rand((1, 2, 3, 4), device="cuda") - 1).requires_grad_(True)
    gs = fold_lookup(torch.randn((1, 2, 3, 8), device="cuda"), 2, 2)
    counts = kernel_counts()
    copies = gaussian_row_sample_bwd.g_copies
    gaussian_row_sample(small, p, 4, 2).backward(gs)
    counts = _diff(kernel_counts(), counts)
    check(counts["gaussian_row_sample"] == 1 and counts["gaussian_row_sample_bwd"] == 1
          and gaussian_row_sample_bwd.g_copies == copies,
          f"K5 autograd launches {counts}, g copies {gaussian_row_sample_bwd.g_copies - copies}")
    dv, dp = gaussian_row_sample_bwd_plain([v.detach() for v in small], p.detach(),
                                           unfold_lookup(gs, 2, 2), 4)
    for got_g, want_g in zip([*(v.grad for v in small), p.grad], [*dv, dp]):
        check(float((got_g - want_g).abs().max()) <= 1e-5 * float(want_g.abs().max()) + 1e-7,
              "K5 autograd gradients differ from the plain backward")
    gaussian_row_sample(small, p, 4, 2).backward(gs.contiguous())
    check(gaussian_row_sample_bwd.g_copies == copies + 1,
          "K5: an NCHW gradient was not copied once to the folded layout")
    # past the backward's former 4-level parameter block: 5 levels that need
    # a gradient run forward and backward through the kernels, with the
    # plain backward's gradients
    five = [torch.randn((1, 2, 3, 8), device="cuda", requires_grad=True) for _ in range(5)]
    p5 = p.detach().clone().requires_grad_(True)
    g5 = fold_lookup(torch.randn((1, 2, 3, 20), device="cuda"), 5, 2)
    counts = kernel_counts()
    out5 = gaussian_row_sample(five, p5, 2, 2)
    check(out5.shape == (2, 10, 2, 3), f"K5: 5 levels gave {tuple(out5.shape)}")
    out5.backward(g5)
    counts = _diff(kernel_counts(), counts)
    check(counts["gaussian_row_sample"] == 1 and counts["gaussian_row_sample_bwd"] == 1,
          f"K5: 5 levels that need a gradient launched {counts}")
    dv, dp = gaussian_row_sample_bwd_plain([v.detach() for v in five], p5.detach(),
                                           unfold_lookup(g5, 5, 2), 2)
    for got_g, want_g in zip([*(v.grad for v in five), p5.grad], [*dv, dp]):
        check(float((got_g - want_g).abs().max()) <= 1e-5 * float(want_g.abs().max()) + 1e-7,
              "K5: 5 levels' gradients differ from the plain backward")
    del five, out5

    print("K5 gaussian_row_sample: max_abs vs fold_lookup(plain).to(dt), output dtype, shape "
          "and strides those of it, NaN where it has NaN: "
          + " | ".join(f"{k} {e:.1e}" for k, e in res.items()) + " (tol 0: bit-equal) | with "
          "inputs that require grad: 1 forward and 1 backward launch, gradients equal to the "
          "plain backward's, an NCHW gradient copied once; 5 levels that need a gradient "
          "run forward and backward (1 launch each) with the plain backward's gradients")
    for name, t in times.items():
        shape = PCV_SHAPE if name == "frame" else TRAIN_SHAPE
        print(f"K5 gaussian_row_sample at the {name}, bf16 -> bf16 {shape} K {PCV_G * PCV_S} "
              f"widths {t['widths']}: device ms {t['ms']:.4f} (one CUDA graph of 50 launches) | "
              f"plain_ms {t['plain_ms']:.3f} | library_ms {t['library_ms']:.4f} (grid_sample over "
              f"the three levels, fp32; max_abs vs plain {t['lib_err']:.2e}) | bound_ms "
              f"{t['bound_ms']:.4f} (bytes, {t['mb']:.2f} MB), {t['bound_ms'] / t['ms']:.0%} of "
              f"it; the kernel {t['ms'] / t['library_ms']:.2f}x grid_sample's time | with the "
              f"rows read whole it moves {t['whole_mb']:.2f} MB; a device copy moving as many "
              f"bytes takes {t['copy_ms']:.4f} ms")
    print("the motion encoder (bf16 autocast) on K5's output at the step "
          f"{TRAIN_SHAPE}: " + " | ".join(
              f"{k} {ms:.4f} ms (one CUDA graph of 10 calls), kernels by bucket {n}"
              for k, (ms, n) in times["step"]["probe"].items()))
    f = times["frame"]
    return dict(ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"], bound_by="bytes",
                library_ms=f["library_ms"], max_abs_err=max(res.values()),
                step={k: times["step"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                     "copy_ms")})


def phase_pcv_parity(torch, configs):
    """PCVNet with K5 on the card vs the plain path on the CPU, fp32 with
    TF32 off, 2 iterations, both configs; and the plain lookup on the card
    vs the CPU, which measures what fp32 reordering alone moves."""
    import dkt_stereo_tpu_torch.models.pcvnet as pcv
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import (
        gaussian_row_sample, gaussian_row_sample_folded_plain)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    iters = 2
    rng = np.random.default_rng(20)
    img1, img2 = (rng.uniform(0, 255, (256, 512, 3)).astype(np.float32) for _ in range(2))
    out = {}
    for name, config in configs.items():
        gpu = create_model({**config, "mixed_precision": False}, iters=iters, device="cuda",
                           seed=0)
        cpu = copy.deepcopy(gpu).to("cpu")
        n = gaussian_row_sample.launches
        d_gpu, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
        k5 = gaussian_row_sample.launches - n
        check(k5 == iters, f"PCV {name} parity: {k5} K5 launches != {iters}")
        d_cpu, _ = _run_one(make_forward_fn(cpu, device="cpu"), img1, img2)
        pcv.gaussian_row_sample = gaussian_row_sample_folded_plain  # for the floor only
        try:
            d_plain, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
        finally:
            pcv.gaussian_row_sample = gaussian_row_sample
        err = float(np.abs(d_gpu - d_cpu).max())
        floor = float(np.abs(d_plain - d_cpu).max())
        same = float(np.abs(d_gpu - d_plain).max())
        # the JAX package's bound between its XLA and Pallas PCV lookups at 2
        # iterations on one device (tests/test_pallas_row_sample.py:61-80):
        # the closed-form mixture updates amplify fp32 rounding. It holds K5
        # against the plain lookup with everything else on the card; against
        # the CPU, where the convolutions' fp32 reordering alone moves the
        # disparity by as much, it is twice the plain-vs-plain difference
        check(np.isfinite(d_gpu).all() and same <= 2e-2,
              f"PCV {name}: K5 vs the plain lookup on the card {same} > 2e-2")
        tol = max(2e-2, 2 * floor)
        check(err <= tol, f"PCV {name} parity {err} > {tol}")
        out[name] = (same, err, floor, tol, float(np.abs(d_cpu).max()), k5)
        del gpu, cpu
    torch.backends.cudnn.allow_tf32 = True
    print("PCV parity (fp32, TF32 off, 1x256x512, 2 iters): "
          + " | ".join(f"{n}.json disp_up max_abs K5 vs the plain lookup, both on the card, "
                       f"{m:.3e} px (tol 2e-2); kernels (card) vs plain (CPU) {e:.3e} px (tol "
                       f"{t:.1e}); plain on the card vs plain on the CPU {f:.3e} px; max |disp| "
                       f"{s:.1f} px; K5 launches {k}" for n, (m, e, f, t, s, k) in out.items()))


def _pcv_frames(torch, forward, images, frames, iters, label):
    """1 warm-up, then ``frames`` timed frames with exactly ``iters`` K5
    launches each and no other kernel; returns (ms array, launches, peak
    GiB, last disparity)."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one

    _run_one(forward, *images)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, per_frame = [], []
    for _ in range(frames):
        before = kernel_counts()
        disp, dt = _run_one(forward, *images)
        times.append(dt)
        per_frame.append(_diff(kernel_counts(), before))
    launches = kernel_counts()
    check(disp.shape == PCV_IMAGE, f"{label} disp shape {disp.shape}")
    check(bool(np.isfinite(disp).all()), f"{label}: non-finite disparity")
    want = {**dict.fromkeys(launches, 0), "gaussian_row_sample": iters}
    check(all(c == want for c in per_frame), f"{label} launches per frame {per_frame} != {want}")
    return 1e3 * np.asarray(times), launches, torch.cuda.max_memory_allocated() / 2**30, disp


def phase_pcv_main(torch, config, fast_config, card):
    """base.json as shipped at 736x1280, 32 iterations: 20 timed frames and
    a profile; then fast.json at the same size, 5 timed frames."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    iters = 32
    rng = np.random.default_rng(21)
    images = tuple(rng.uniform(0, 255, (*PCV_IMAGE, 3)).astype(np.float32) for _ in range(2))
    forward = make_forward_fn(create_model(config, iters=iters, seed=0))
    ms, launches, peak, disp = _pcv_frames(torch, forward, images, MAIN_FRAMES, iters, "PCV")
    print(f"PCV main path (pcvnet/base.json, bf16, K5, 1x{PCV_IMAGE[0]}x{PCV_IMAGE[1]}, {iters} "
          f"iters, {MAIN_FRAMES} frames after 1 warm-up): ms/frame median {np.median(ms):.2f} "
          f"mean {ms.mean():.2f} min {ms.min():.2f} max {ms.max():.2f} | frames/s "
          f"{1e3 / ms.mean():.3f} | launches {launches} | peak mem {peak:.2f} GiB | disp range "
          f"[{disp.min():.2f}, {disp.max():.2f}] | {card}")
    wall, busy, lines, buckets = device_profile(
        torch, lambda: _run_one(forward, *images)[1], "chip_smoke_pcv_profile.txt")
    print(f"profile of one PCV frame (profiler on): wall {wall:.2f} ms, kernels {busy:.2f} ms, "
          f"device idle share {1 - busy / wall:.3f}; by bucket: {buckets}; top kernels:")
    for line in lines[:12]:
        print("  " + line[:160])
    del forward
    torch.cuda.empty_cache()

    forward = make_forward_fn(create_model(fast_config, iters=iters, seed=0))
    ms, fast, peak, disp = _pcv_frames(torch, forward, images, PCV_FAST_FRAMES, iters,
                                       "PCV fast")
    print(f"PCV fast path (pcvnet/fast.json, bf16, K5, 1x{PCV_IMAGE[0]}x{PCV_IMAGE[1]}, "
          f"{iters} iters, {PCV_FAST_FRAMES} frames after 1 warm-up): ms/frame median "
          f"{np.median(ms):.2f} mean {ms.mean():.2f} min {ms.min():.2f} max {ms.max():.2f} | "
          f"launches {fast} | peak mem {peak:.2f} GiB | disp range [{disp.min():.2f}, "
          f"{disp.max():.2f}] | {card}")
    del forward
    torch.cuda.empty_cache()
    return launches, fast


def k5_bwd_bound(torch, levels, pos, cf, g_itemsize=2):
    """(bound ms, MB) of one K5 backward launch on these inputs: what the
    forward's bound counts (the positions, the taps these positions read,
    and g, in the compute dtype, in place of the output), plus every dvol
    element and dpos written once."""
    _, fwd_mb = k5_bound(torch, levels, pos, cf, g_itemsize)
    nbytes = fwd_mb * 1e6 + sum(v.numel() * v.element_size() for v in levels) + pos.numel() * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes / 1e6


def phase_k5_bwd(torch):
    """K5's backward (dvol of every level and dpos in one launch, g read
    folded and in the compute dtype) vs its plain version at the training
    grid, the inference grid and a ragged shape, with the hostile positions
    of phase 20; the adjoint check against the forward kernel; two launches
    bit for bit; device times (a CUDA graph) beside the bound, the plain
    version and grid_sample's backward; and the time autograd spends summing
    the per-iteration dvol into a bf16 pyramid's gradient."""
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import (
        fold_lookup, gaussian_row_sample, gaussian_row_sample_bwd,
        gaussian_row_sample_bwd_plain, unfold_lookup)

    gen = torch.Generator(device="cuda").manual_seed(23)
    cf, G, LK = 4, PCV_G, PCV_L * PCV_G * PCV_S
    res = {}

    def folded_g(shape, dt, L=PCV_L):
        return fold_lookup(torch.randn((*shape, L * PCV_G * PCV_S), generator=gen,
                                       device="cuda"), L, G).to(dt)

    # the PCV configs' 3 levels (cf 4), then 5 and 8 levels (cf 2), past the
    # kernel's former 4-level parameter block
    for shape, L, cff, pairs in (((2, 7, 37), PCV_L, cf, ((F32, F32), (BF16, BF16), (F32, BF16))),
                                 (PCV_SHAPE, PCV_L, cf, ((F32, F32), (BF16, BF16))),
                                 (TRAIN_SHAPE, PCV_L, cf, ((F32, F32), (BF16, BF16))),
                                 ((2, 7, 37), 5, 2, ((F32, F32), (BF16, BF16))),
                                 ((2, 8, 300), 8, 2, ((F32, F32), (BF16, BF16)))):
        for vol, gdt in pairs:
            dt = getattr(torch, vol)
            levels, pos, _ = _k5_inputs(torch, gen, shape, cff, dt, L)
            g = folded_g(shape, getattr(torch, gdt), L)
            dv, dp = gaussian_row_sample_bwd(levels, pos, g, cff, G)
            dv2, dp2 = gaussian_row_sample_bwd(levels, pos, g, cff, G)
            check(all(torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
                      and torch.equal(a.isnan(), b.isnan())
                      for a, b in zip([*dv, dp], [*dv2, dp2])),
                  f"K5 bwd {shape} L {L} {vol} g {gdt}: two launches differ")
            want_v, want_p = gaussian_row_sample_bwd_plain(levels, pos,
                                                           unfold_lookup(g, L, G), cff)
            check([d.dtype for d in dv] == [dt] * L and dp.dtype == torch.float32,
                  f"K5 bwd output dtypes {[d.dtype for d in dv]} {dp.dtype}")
            nan_pix = torch.isnan(pos).any(dim=-1)
            errs = []
            for a, b in zip(dv, want_v):
                # a NaN position gives NaN in its pixel's whole row, in the
                # kernel as in the plain version (and JAX); the rest finite
                check(torch.equal(torch.isnan(a), torch.isnan(b)),
                      f"K5 bwd {shape} L {L} {vol}: NaN differs from the plain version")
                check(bool(torch.isnan(a[nan_pix]).all()) and bool(nan_pix.any())
                      and bool(torch.isfinite(a[~nan_pix]).all()),
                      f"K5 bwd {shape} L {L} {vol}: NaN rows are not exactly the NaN pixels'")
                fin = torch.isfinite(b)
                err = float((a.float()[fin] - b.float()[fin]).abs().max())
                # fp32: the same taps, weights and roundings summed in another
                # order; bf16: one rounding of fp32 sums that may differ in
                # their last bits, one bf16 step (2^-8) with margin
                tol = (1e-4 if dt == torch.float32 else 2**-7) * float(b.float()[fin].abs().max())
                check(err <= tol, f"K5 bwd dvol {shape} L {L} {vol} g {gdt} max-abs {err} > {tol}")
                errs.append((err, tol))
            # a NaN position's dpos is 0, in the kernel as in the plain version
            check(bool(torch.isfinite(dp).all()) and bool((dp[torch.isnan(pos)] == 0).all()),
                  f"K5 bwd {shape} L {L}: dpos not finite, or not 0 at NaN positions")
            err = float((dp - want_p).abs().max())
            tol = 1e-4 * float(want_p.abs().max())
            check(err <= tol, f"K5 bwd dpos {shape} L {L} {vol} g {gdt} max-abs {err} > {tol}")
            errs.append((err, tol))
            res[(shape, L, vol, gdt)] = (max(e for e, _ in errs), errs)
            del dv, dp, dv2, dp2, want_v, want_p

    # adjoint: <K5(v), g> == <v, K5^T(g)>, both kernels, fp32, fp64 sums, at
    # the training grid with finite positions (a NaN one makes the forward's
    # side NaN)
    levels, pos, _ = _k5_inputs(torch, gen, TRAIN_SHAPE, cf, torch.float32)
    pos = pos.nan_to_num(3.5)
    g = folded_g(TRAIN_SHAPE, torch.float32)
    with torch.no_grad():
        out = gaussian_row_sample(levels, pos, cf, G)
    dv, _ = gaussian_row_sample_bwd(levels, pos, g, cf, G, need_pos=False)
    lhs = float((out.double() * g.double()).sum())
    rhs = float(sum((v.double() * d.double()).sum() for v, d in zip(levels, dv)))
    adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    check(adj <= 1e-5, f"K5 adjoint check: relative {adj} > 1e-5")
    del out, dv

    # the training path's launch: bf16 levels and g at the training grid
    bf = torch.bfloat16
    levels, pos, _ = _k5_inputs(torch, gen, TRAIN_SHAPE, cf, bf)
    g = folded_g(TRAIN_SHAPE, bf)
    ms = graph_ms(torch, lambda: gaussian_row_sample_bwd(levels, pos, g, cf, G), 20)
    gu = unfold_lookup(g, PCV_L, G)
    # the glue that reading g folded and in bf16 removed: the fold's copy
    # back to (B, H, W, L*K) and the cast to the fp32 an unfolded kernel read
    glue_ms = graph_ms(torch, lambda: unfold_lookup(g, PCV_L, G).float(), 20)
    plain_ms = graph_ms(torch, lambda: gaussian_row_sample_bwd_plain(levels, pos, gu, cf), 2, 1)
    bound_ms, mb = k5_bwd_bound(torch, levels, pos, cf)
    # what autograd adds per iteration: summing one iteration's three bf16
    # dvol tensors into the running gradient of the pyramid (15 such sums a
    # step at 16 iterations)
    acc, _ = gaussian_row_sample_bwd(levels, pos, g, cf, G, need_pos=False)
    new, _ = gaussian_row_sample_bwd(levels, pos, g, cf, G, need_pos=False)
    accum_ms = graph_ms(torch, lambda: [a.add_(b) for a, b in zip(acc, new)], 10)
    del acc, new
    # the yardstick: grid_sample's backward, one call a level (fp32, as
    # phase 20's forward yardstick), with respect to the volumes and grids
    _, lib_in, grids = k5_library(torch, levels, pos, cf)
    B, H, W1, K = pos.shape
    n = B * H * W1
    gouts = [gi.reshape(n, 1, 1, K).float().contiguous() for gi in gu.split(K, dim=-1)]

    def library():
        return [torch.ops.aten.grid_sampler_2d_backward(go, v, gr, 0, 0, True, [True, True])
                for go, v, gr in zip(gouts, lib_in, grids)]

    lib_ms = graph_ms(torch, library, 5)
    del lib_in, grids, gouts, gu

    errs = " | ".join(
        f"{s[0]}x{s[1]}x{s[2]} L {L} {vol} g {gdt}: dvol per level "
        + " ".join(f"{e:.2e}" for e, _ in es[:-1]) + f", dpos {es[-1][0]:.2e} (tol "
        + " ".join(f"{t:.1e}" for _, t in es) + ")"
        for (s, L, vol, gdt), (_, es) in res.items())
    print(f"K5 gaussian_row_sample_bwd: max_abs {errs} (tol 1e-4 x max|dplain| fp32, 2^-7 x "
          f"max|dplain| bf16; NaN position -> NaN row in every level and 0 dpos, as the plain "
          f"version; two launches bit-identical) | "
          f"adjoint rel {adj:.2e} (tol 1e-5) | bf16 levels and folded g {TRAIN_SHAPE} K {K} "
          f"widths {[v.shape[-1] for v in levels]}, dvol and dpos: device ms {ms:.4f} (one CUDA "
          f"graph of 20 launches) | the unfold copy and fp32 cast an unfolded g would need: "
          f"{glue_ms:.4f} ms (one CUDA graph of 20) | plain_ms {plain_ms:.3f} | library_ms "
          f"{lib_ms:.4f} (backward "
          f"of grid_sample over the three levels, fp32, volumes and grids) | bound_ms "
          f"{bound_ms:.4f} (bytes, {mb:.2f} MB), {bound_ms / ms:.0%} of it | autograd's sum of "
          f"one iteration's bf16 dvol into the running one: {accum_ms:.4f} ms (x15 per step: "
          f"{15 * accum_ms:.3f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=lib_ms, max_abs_err=max(e for e, _ in res.values()))


PCV_MODULES = ("cnet", "conv2", "context_zqr_convs", "FDM", "refineNet")


def phase_pcv_train_parity(torch, config):
    """One PCV DKT step with the kernels on the card vs the plain lookup on
    the card and vs the plain path on the CPU, from the same weights, batch
    and draws, fp32 with TF32 off, 2 student and 2 teacher iterations; then
    the student's gradient at 4 iterations, where the position gradient
    reaches the updater, through the kernels, through the plain lookup and
    with the positions cut."""
    import dkt_stereo_tpu_torch.models.pcvnet as pcv
    from dkt_stereo_tpu_torch.losses.pcv import sequence_loss_pcvnet
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import (
        gaussian_row_sample, gaussian_row_sample_folded_plain)
    from dkt_stereo_tpu_torch.train.dkt_step import (
        create_dkt_state, fande_draws, make_dkt_train_step)
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**config, "mixed_precision": False}
    hyper = DKTHyperParams(train_iters=2, teacher_iters=2)
    seed_state = create_dkt_state(cfg, hyper, seed=0, device="cuda")
    params = {k: v.detach().clone() for k, v in seed_state.student.state_dict().items()}
    del seed_state
    to_cpu = {k: v.to("cpu", copy=True) for k, v in params.items()}
    gen = torch.Generator().manual_seed(24)
    batch = _train_batch(torch, gen, 1, 64, 128, "cpu")
    draws = fande_draws(1, "cpu", gen)
    step = make_dkt_train_step(cfg, hyper)
    on_card = ({k: v.cuda() for k, v in batch.items()}, {k: v.cuda() for k, v in draws.items()})

    gpu = create_dkt_state(cfg, hyper, params=params, device="cuda")
    before = kernel_counts()
    gpu, m_gpu = step(gpu, on_card[0], draws=on_card[1])
    torch.cuda.synchronize()
    launches = _diff(kernel_counts(), before)
    pcv.gaussian_row_sample = gaussian_row_sample_folded_plain  # the plain lookup on the card
    try:
        plain = create_dkt_state(cfg, hyper, params=params, device="cuda")
        plain, m_plain = step(plain, on_card[0], draws=on_card[1])
    finally:
        pcv.gaussian_row_sample = gaussian_row_sample
    cpu = create_dkt_state(cfg, hyper, params=to_cpu, device="cpu")
    cpu, m_cpu = step(cpu, batch, draws=draws)
    torch.backends.cudnn.allow_tf32 = True

    check(m_gpu["ok"] == m_plain["ok"] == m_cpu["ok"] == 1.0,
          f"PCV ok card {m_gpu['ok']} plain {m_plain['ok']} cpu {m_cpu['ok']}")
    # teachers 2 + 2, student 2; one backward launch per student iteration
    want = {**dict.fromkeys(launches, 0), "gaussian_row_sample": 6, "gaussian_row_sample_bwd": 2}
    check(launches == want, f"PCV train parity launches {launches} != {want}")
    losses = ("loss", "loss_GT", "loss_PL")

    def loss_rel(a, b):
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in losses}

    k_vs_p = loss_rel(m_gpu, m_plain)
    c_vs_c = loss_rel(m_gpu, m_cpu)
    floor_l = loss_rel(m_plain, m_cpu)
    rel = _grad_rel(gpu.student.named_parameters(), dict(plain.student.named_parameters()))
    rel_cpu = _grad_rel(gpu.student.named_parameters(), dict(cpu.student.named_parameters()))
    floor = _grad_rel(plain.student.named_parameters(), dict(cpu.student.named_parameters()))
    check(set(rel) == {*PCV_MODULES, "all"}, f"PCV gradient modules {sorted(rel)}")
    for k in losses:
        check(k_vs_p[k] <= 1e-3, f"PCV train parity {k}, kernels vs plain on the card: "
                                 f"relative {k_vs_p[k]} > 1e-3")
        tol = max(1e-3, 2 * floor_l[k])
        check(c_vs_c[k] <= tol, f"PCV train parity {k}, card vs CPU: relative {c_vs_c[k]} > {tol}")
    for gr, e in rel.items():
        bound = 0.05 if gr == "all" else 0.1
        check(e <= bound, f"PCV train parity gradient of {gr}, kernels vs plain on the card: {e}")
        tol = max(bound, 2 * floor[gr])
        check(rel_cpu[gr] <= tol, f"PCV train parity gradient of {gr}, card vs CPU: "
                                  f"{rel_cpu[gr]} > {tol}")
    del gpu, plain, cpu

    # the position gradient: 4 student iterations (the first update clips
    # sigma's step at every pixel, so it reaches the updater from the third
    # lookup on), one forward and backward of the PCV loss against the
    # batch's GT, through the kernels, the plain lookup and the kernels
    # with the positions cut
    torch.backends.cudnn.allow_tf32 = False

    def grads(lookup):
        model = create_model(cfg, iters=4, device="cuda", test_mode=False)
        model.load_state_dict(params, strict=True)
        pcv.gaussian_row_sample = lookup
        try:
            out = model(on_card[0]["img1"], on_card[0]["img2"])
            sequence_loss_pcvnet(out["output_list"], on_card[0]["flow"],
                                 on_card[0]["valid"])[0].backward()
        finally:
            pcv.gaussian_row_sample = gaussian_row_sample
        torch.cuda.synchronize()
        return dict(model.named_parameters())

    before = kernel_counts()
    kern = grads(gaussian_row_sample)
    launches4 = _diff(kernel_counts(), before)
    plain4 = grads(gaussian_row_sample_folded_plain)
    cut = grads(lambda levels, pos, *args: gaussian_row_sample(levels, pos.detach(), *args))
    torch.backends.cudnn.allow_tf32 = True
    check(launches4["gaussian_row_sample"] == 4 and launches4["gaussian_row_sample_bwd"] == 4,
          f"PCV 4-iteration launches {launches4}")
    rel4 = _grad_rel(kern.items(), plain4)
    moved = _grad_rel(cut.items(), kern)
    for gr, e in rel4.items():
        check(e <= (0.05 if gr == "all" else 0.1),
              f"PCV 4-iteration gradient of {gr}, kernels vs plain on the card: {e}")
    check(moved["FDM"] > 0.1, f"cutting the position gradient moved FDM's gradient by only "
                              f"{moved['FDM']}")
    print(f"PCV train-step parity (base.json fp32, TF32 off, 1x64x128, 2+2 iters): loss "
          f"{m_gpu['loss']:.6f} card / {m_plain['loss']:.6f} plain on the card / "
          f"{m_cpu['loss']:.6f} cpu; relative errors kernels vs plain (card) "
          + " ".join(f"{k} {e:.2e}" for k, e in k_vs_p.items()) + " (tol 1e-3), card vs CPU "
          + " ".join(f"{k} {e:.2e}" for k, e in c_vs_c.items()) + " (plain-on-card vs CPU "
          + " ".join(f"{k} {e:.2e}" for k, e in floor_l.items()) + ") | gradient relative L2 "
          "by module, kernels vs plain (card) " + " ".join(f"{g} {e:.2e}" for g, e in rel.items())
          + " (tol 0.1 per module, 0.05 all); card vs CPU "
          + " ".join(f"{g} {e:.2e}" for g, e in rel_cpu.items()) + " (floor, plain on the card "
          "vs CPU: " + " ".join(f"{g} {e:.2e}" for g, e in floor.items()) + f") | launches "
          f"{launches} | 4 student iterations, kernels vs plain (card): "
          + " ".join(f"{g} {e:.2e}" for g, e in rel4.items()) + "; with the positions cut, the "
          "gradient moves by " + " ".join(f"{g} {e:.2e}" for g, e in moved.items())
          + f" (FDM must move > 0.1) | launches {launches4}")


def phase_pcv_train(torch, config, card):
    """pcvnet/base.json as shipped in train mode: 1 warm-up and TRAIN_STEPS
    timed DKT steps at B=8, 320x720, 16 student / 32 teacher iterations,
    exact K5 launch counts, peak memory and a profile of one step."""
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    B, H, W = TRAIN_IMAGE
    hyper = DKTHyperParams(train_iters=16, teacher_iters=32)
    state = create_dkt_state(config, hyper, seed=0)
    step = make_dkt_train_step(config, hyper)
    gen = torch.Generator(device="cuda").manual_seed(25)

    before = snapshot(state, "PCVNet")

    state, run = timed_steps(torch, state, step, gen, (B, H, W), "PCV")
    per_step, launches, metrics = run["per_step"], run["launches"], run["metrics"]
    # 2 x 32 teacher iterations + 16 student (+16 recomputed with remat);
    # one backward launch per student iteration; no other kernel
    remat = bool(config.get("remat_iters", False))
    want = {**dict.fromkeys(launches, 0), "gaussian_row_sample": 96 if remat else 80,
            "gaussian_row_sample_bwd": 16}
    check(all(c == want for c in per_step), f"PCV launches per step {per_step} != {want}")
    check_moved_and_frozen(torch, state, before, "PCV")

    print(f"PCV training path (pcvnet/base.json in train mode, bf16, remat {remat}, B={B} "
          f"{H}x{W}, {hyper.train_iters}/{hyper.teacher_iters} iters, {TRAIN_STEPS} steps "
          f"after 1 warm-up): {step_line(run)} | epe {metrics[-1]['epe']:.3f} | lr "
          f"{metrics[-1]['learning_rate']:.3e} | {card}")
    profile_step(torch, state, step, gen, (B, H, W), run["ms"].mean(),
                 "chip_smoke_pcv_train_profile.txt", "PCV training")
    del state, step
    torch.cuda.empty_cache()
    return launches


# the parameters the fused fnet never reads: instance norm cancels the stem's
# and layer1's conv biases, so their gradient is zero (JAX's too)
FUSED_UNUSED = ["conv1.bias"] + [f"layer1.{i}.conv{j}.bias" for i in (0, 1) for j in (1, 2)]


def phase_encoder_vjp(torch):
    """The protocol of the JAX package's ENCODER_VJP_r05.json on the card:
    every parameter gradient of BasicEncoder(instance, downsample 2) at
    2x320x704 through the fused path (K2 and its VJP) vs the unfused port
    path; fp32 with TF32 off, and bf16 against the fp32 truth."""
    from dkt_stereo_tpu_torch.models.registry import init_weights
    from dkt_stereo_tpu_torch.nn.blocks import BasicEncoder

    B, H, W = 2, 320, 704
    unfused = BasicEncoder(256, "instance", 2)
    init_weights(unfused, torch.Generator().manual_seed(27))
    unfused.cuda()
    fused = copy.deepcopy(unfused)
    fused.fused_fullres = True
    gen = torch.Generator(device="cuda").manual_seed(27)
    x = 2 * torch.rand((B, 3, H, W), generator=gen, device="cuda") - 1

    def grads(model, dt):
        model.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dt == torch.bfloat16):
            out = model(x.to(dt))
        out.float().square().sum().backward()
        return {k: p.grad for k, p in model.named_parameters()}

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    zero_counts()
    truth = grads(unfused, torch.float32)
    g32 = grads(fused, torch.float32)
    launches = kernel_counts()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    want = {**dict.fromkeys(launches, 0), "encoder_stage": 4, "encoder_stage_bwd": 4}
    check(launches == want, f"encoder VJP protocol launches {launches} != {want}")
    check([k for k, g in g32.items() if g is None] == FUSED_UNUSED,
          f"fused fnet: parameters without gradient {[k for k, g in g32.items() if g is None]}")
    # every conv bias in front of an instance norm has a zero gradient in
    # exact arithmetic; the head's (conv2) is the only bias that trains
    zero_math = [k for k in truth if k.endswith(".bias") and k != "conv2.bias"]
    leaves = [k for k in truth if k not in zero_math]

    def dev(g):
        """Worst leaf: max-abs error over the truth's max |g|."""
        errs = {k: float((g[k] - truth[k]).abs().max()) / float(truth[k].abs().max())
                for k in leaves}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    def zero_ok(g):
        scale = max(float(truth[k].abs().max()) for k in leaves)
        return all(g[k] is None or float(g[k].abs().max()) <= 1e-3 * scale for k in zero_math)

    worst32, leaf32 = dev(g32)
    check(worst32 <= 1e-2, f"encoder VJP fp32: worst leaf {leaf32} relative {worst32} > 1e-2")
    check(zero_ok(g32) and zero_ok(truth), "encoder VJP fp32: a zero-gradient bias is not ~0")
    unfused_dev, unfused_leaf = dev(grads(unfused, torch.bfloat16))
    g16 = grads(fused, torch.bfloat16)
    fused_dev, fused_leaf = dev(g16)
    check(fused_dev <= 2 * unfused_dev + 1e-3,
          f"encoder VJP bf16: fused deviation {fused_dev} > 2 x unfused {unfused_dev} + 1e-3")
    # in bf16 the biases in front of the later instance norms keep the
    # rounding noise of both paths; only the unread ones are exactly zero
    check(all(g16[k] is None for k in FUSED_UNUSED),
          "encoder VJP bf16: an unread bias got a gradient")
    print(f"encoder VJP protocol (ENCODER_VJP_r05.json's, BasicEncoder(instance, 2), "
          f"{B}x{H}x{W}): fp32 TF32 off fused vs unfused worst leaf {leaf32} {worst32:.3e} "
          f"(tol 1e-2) | bf16 deviation from fp32 truth: fused {fused_dev:.4f} ({fused_leaf}), "
          f"unfused {unfused_dev:.4f} ({unfused_leaf}) (tol fused <= 2 x unfused + 1e-3) | "
          f"zero-gradient biases: fused {FUSED_UNUSED} none (fp32 and bf16), the rest <= 1e-3 of "
          f"the gradient scale in fp32 | launches {launches}")
    del unfused, fused, truth, g32, g16
    torch.cuda.empty_cache()


def phase_fused_train(torch, train_cfg, alt_cfg, pallas_cfg, card, unfused_ms):
    """The DKT step with the fused fnet in train mode at B=8, 320x720, 16
    student / 32 teacher iterations: train.json with pallas_encoder merged
    in (1 warm-up and TRAIN_STEPS timed steps, a profile), alt_pallas.json
    as shipped (1 + 3 steps) and pallas.json as shipped (one step), each
    with exact launch counts."""
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    B, H, W = TRAIN_IMAGE
    hyper = DKTHyperParams(train_iters=16, teacher_iters=32)
    unused = ["fnet." + k for k in FUSED_UNUSED]
    # K2: 4 stages for each of the two teachers and the student, whose
    # backward adds 4 adjoint launches; remat recomputes only the GRU
    # iterations
    k2 = {"encoder_stage": 12, "encoder_stage_bwd": 4}
    paths = {}
    for name, cfg, steps, want in (
            ("fused_training", {**train_cfg, "pallas_encoder": True}, TRAIN_STEPS,
             {"corr_lookup": 96, "corr_lookup_bwd": 16}),
            ("alt_training", alt_cfg, 3, {"corr_lookup_alt": 80}),
            ("pallas_training", pallas_cfg, 0, {"corr_lookup": 80, "corr_lookup_bwd": 16})):
        remat = bool(cfg.get("remat_iters", False))
        state = create_dkt_state(cfg, hyper, seed=0)
        step = make_dkt_train_step(cfg, hyper)
        gen = torch.Generator(device="cuda").manual_seed(28)
        before = snapshot(state, name)
        if steps:
            state, run = timed_steps(torch, state, step, gen, (B, H, W), name, steps)
            per_step, launches = run["per_step"], run["launches"]
        else:
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            state, m = step(state, _train_batch(torch, gen, B, H, W, "cuda"), generator=gen)
            torch.cuda.synchronize()
            launches = kernel_counts()
            per_step = [launches]
            check(m["ok"] == 1.0 and np.isfinite(m["loss"]), f"{name} step not ok: {m}")
        want = {**dict.fromkeys(launches, 0), **want, **k2}
        check(all(c == want for c in per_step), f"{name} launches per step {per_step} != {want}")
        # the fused fnet's unread biases get a zero gradient; from their zero
        # init AdamW's decay leaves them at zero, as optax does
        check_moved_and_frozen(torch, state, before, name, still_ok=unused)
        label = (f"{name} ({cfg['model']} {cfg.get('corr_implementation')}, pallas_encoder, bf16, "
                 f"remat {remat}, B={B} {H}x{W}, {hyper.train_iters}/{hyper.teacher_iters} iters")
        if steps:
            print(f"{label}, {steps} steps after 1 warm-up): {step_line(run)} | {card}")
        else:
            print(f"{label}, one step): loss {m['loss']:.3f} ok {m['ok']} | peak mem "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches {launches} "
                  f"| {card}")
        if name == "fused_training":
            print(f"the unfused train.json step (phase 9, same call): mean {unfused_ms:.2f} "
                  f"ms/step; fused / unfused {run['ms'].mean() / unfused_ms:.3f}")
            profile_step(torch, state, step, gen, (B, H, W), run["ms"].mean(),
                         "chip_smoke_fused_train_profile.txt", "fused training")
        paths[name] = launches
        del state, step
        torch.cuda.empty_cache()
    return paths


GWC_CGI = (("gwc_g", "configs/gwcnet/base_g.json"), ("gwc_gc", "configs/gwcnet/base_gc.json"),
           ("cgi", "configs/cgi/base.json"))
GWC_CGI_TRAIN = GWC_CGI[1:]
# the training crops: the CLI's default 320x720 for GWCNet; CGI's hourglass,
# as IGEV's, needs multiples of 32 (320x720 fails in the JAX model too)
GWC_CGI_CROP = {"gwc_gc": TRAIN_IMAGE, "cgi": IGEV_TRAIN_IMAGE}
# the modules the reference builds and CGI's forward never runs
# (dkt_stereo_tpu_torch/weights.py): no gradient, moved by AdamW's decay only
CGI_UNUSED = ("feature.deconv32_16.", "hourglass_fusion.conv1_up.bn.")


def _config(path):
    return json.loads((ROOT / path).read_text())


def calibrate_gwc(torch, model, img1, img2, rounds):
    """GWCNet's batch norms made non-degenerate, as in the CPU tests
    (tests/test_torch_gwcnet.py): every shift set to 1, then the running
    statistics moved toward the images' own by the port's ``train_bn``
    update (flax's momentum 0.9), ``rounds`` times. With unit statistics
    and random weights the trunk's features grow until the softmax over
    disparity is one-hot: the gradients vanish, and fp32 reordering flips
    whole bins. ``img1``/``img2``: NHWC in [0, 255] on the model's device."""
    import dataclasses

    from dkt_stereo_tpu_torch.models.gwcnet import GWCNet

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                m.bias.fill_(1.0)
    updating = GWCNet(dataclasses.replace(model.cfg, train_bn=True), test_mode=False)
    updating.load_state_dict(model.state_dict())
    updating.to(img1.device).train()
    with torch.no_grad():
        for _ in range(rounds):
            updating(img1, img2)
    model.load_state_dict(updating.state_dict())
    return model


def phase_gwc_parity(torch):
    """Phase 28a: GWCNet base_g and base_gc and CGI-Stereo base.json, the
    card vs the CPU from the same seeded weights, fp32 with TF32 off,
    1x256x512, maxdisp 192; GWCNet's batch norms calibrated on the card
    (``calibrate_gwc``, 30 rounds on this pair). No kernel of the port is on
    either model's path: every launch counter must stay 0."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(30)
    img1, img2 = (rng.uniform(0, 255, (256, 512, 3)).astype(np.float32) for _ in range(2))
    for name, path in GWC_CGI:
        gpu = create_model({**_config(path), "mixed_precision": False}, device="cuda", seed=0)
        if name != "cgi":
            calibrate_gwc(torch, gpu, *(torch.tensor(x, device="cuda")[None] for x in (img1, img2)),
                          rounds=30)
        cpu = copy.deepcopy(gpu).to("cpu")
        costs = {}
        if name == "cgi":
            for dev, m in (("cuda", gpu), ("cpu", cpu)):
                m.hourglass_fusion.register_forward_hook(
                    lambda mod, i, o, d=dev: costs.__setitem__(d, o[:, 0].float().cpu().numpy()))
        zero_counts()
        d_gpu, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
        launches = kernel_counts()
        t0 = time.perf_counter()
        d_cpu, _ = _run_one(make_forward_fn(cpu, device="cpu"), img1, img2)
        cpu_s = time.perf_counter() - t0
        check(not any(launches.values()), f"{name} parity launched port kernels: {launches}")
        check(d_gpu.shape == d_cpu.shape == (256, 512) and np.isfinite(d_gpu).all(),
              f"{name} parity: shape {d_gpu.shape} or non-finite")
        diff = np.abs(d_gpu - d_cpu)
        head = (f"{name} parity ({path}, fp32, TF32 off, 1x256x512, maxdisp 192), card vs CPU: "
                f"disp max_abs {diff.max():.3e} px, p90 {np.percentile(diff, 90):.3e}, max "
                f"|disp| {np.abs(d_cpu).max():.1f} px")
        if name == "cgi":
            cerr = float(np.abs(costs["cuda"] - costs["cpu"]).max())
            scale = float(np.abs(costs["cpu"]).max())
            print(f"{head} | pre-regression cost max_abs {cerr:.3e} (scale {scale:.3e}; tol "
                  f"5e-4, tests/test_cgi_parity.py:82-83) | disparity by the tie-flip rule: p90 "
                  f"<= 1e-4, max < 4 px + 1e-3 | CPU forward {cpu_s:.1f} s")
            check(cerr <= 5e-4, f"CGI cost {cerr} > 5e-4")
            check(np.percentile(diff, 90) <= 1e-4 and diff.max() < 4 + 1e-3,
                  f"CGI disparity outside the tie-flip rule: {diff.max()}")
        else:
            frac = np.abs(d_cpu - np.round(d_cpu))
            print(f"{head} (tol 5e-2 px, tests/test_gwcnet.py:165) | the soft-argmin's distance "
                  f"to the nearest bin: mean {frac.mean():.3f} px | CPU forward {cpu_s:.1f} s")
            check(diff.max() <= 5e-2, f"{name} parity {diff.max()} > 5e-2")
        del gpu, cpu
    torch.backends.cudnn.allow_tf32 = True


def phase_gwc_main(torch, card):
    """Phase 28b: the three configs as shipped (bf16), B=1, 736x1280 (the JAX
    zoo bench's geometry), seeded random weights, through
    make_forward_fn/_run_one: 1 warm-up and MAIN_FRAMES timed frames, no
    port kernel launched, peak memory and a profile of one frame."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    rng = np.random.default_rng(31)
    img1, img2 = (rng.uniform(0, 255, (736, 1280, 3)).astype(np.float32) for _ in range(2))
    paths = {}
    for name, path in GWC_CGI:
        forward = make_forward_fn(create_model(_config(path), seed=0))
        _run_one(forward, img1, img2)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times = []
        for _ in range(MAIN_FRAMES):
            disp, dt = _run_one(forward, img1, img2)
            times.append(dt)
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(disp.shape == (736, 1280) and bool(np.isfinite(disp).all()),
              f"{name}: disparity {disp.shape} or non-finite")
        check(not any(launches.values()), f"{name} launched port kernels: {launches}")
        ms = 1e3 * np.asarray(times)
        print(f"{name} main path ({path} as shipped, bf16, 1x736x1280, {MAIN_FRAMES} frames): "
              f"ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f} min {ms.min():.2f} max "
              f"{ms.max():.2f} | frames/s {1e3 / ms.mean():.3f} | peak mem {peak:.2f} GiB | disp "
              f"range [{disp.min():.2f}, {disp.max():.2f}] | {card}")
        wall, busy, lines, buckets = device_profile(
            torch, lambda: _run_one(forward, img1, img2)[1], f"chip_smoke_{name}_profile.txt")
        print(f"profile of one {name} frame (profiler on): wall {wall:.2f} ms, kernels "
              f"{busy:.2f} ms, device idle share {1 - busy / wall:.3f}; by bucket: {buckets}; "
              "top kernels:")
        for line in lines[:8]:
            print("  " + line[:160])
        paths[f"{name}_inference"] = launches
        del forward
        torch.cuda.empty_cache()
    return paths


def phase_gwc_train_parity(torch):
    """Phase 28c: one DKT step of GWCNet base_gc and of CGI base.json on the
    card vs the CPU, from the same weights, batch and draws, fp32 with TF32
    off, 1x64x128, maxdisp 192 (GWCNet's batch norms calibrated on the
    batch's clean pair); losses and gradients by module, with the CPU's
    chaos floor from a 1e-5 weight nudge."""
    from dkt_stereo_tpu_torch.train.dkt_step import (
        create_dkt_state, fande_draws, make_dkt_train_step)
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hyper = DKTHyperParams()
    for name, path in GWC_CGI_TRAIN:
        cfg = {**_config(path), "mixed_precision": False}
        gen = torch.Generator().manual_seed(32)
        batch = _train_batch(torch, gen, 1, 64, 128, "cpu")
        draws = fande_draws(1, "cpu", gen)
        seed_state = create_dkt_state(cfg, hyper, seed=0, device="cuda")
        if name != "cgi":
            calibrate_gwc(torch, seed_state.student, batch["img1_clean"].cuda(),
                          batch["img2_clean"].cuda(), rounds=30)
        params = seed_state.student.state_dict()
        to_cpu = {k: v.to("cpu", copy=True) for k, v in params.items()}
        gpu = create_dkt_state(cfg, hyper, params=params, device="cuda")
        cpu = create_dkt_state(cfg, hyper, params=to_cpu, device="cpu")
        del seed_state
        step = make_dkt_train_step(cfg, hyper)
        zero_counts()
        gpu, m_gpu = step(gpu, {k: v.cuda() for k, v in batch.items()},
                          draws={k: v.cuda() for k, v in draws.items()})
        torch.cuda.synchronize()
        launches = kernel_counts()
        cpu, m_cpu = step(cpu, batch, draws=draws)
        noise = torch.Generator().manual_seed(7)
        nudged = {k: v * (1 + 1e-5 * torch.randn(v.shape, generator=noise))
                  if v.is_floating_point() else v for k, v in to_cpu.items()}
        cpu2, _ = step(create_dkt_state(cfg, hyper, params=nudged, device="cpu"), batch,
                       draws=draws)
        check(m_gpu["ok"] == m_cpu["ok"] == 1.0, f"{name} ok gpu {m_gpu['ok']} cpu {m_cpu['ok']}")
        check(not any(launches.values()), f"{name} step launched port kernels: {launches}")
        loss_err = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                    for k in ("loss", "loss_GT", "loss_PL")}
        for k, e in loss_err.items():
            check(e <= 1e-3, f"{name} train parity {k}: relative {e} > 1e-3")
        want_grads = dict(cpu.student.named_parameters())
        rel = _grad_rel(gpu.student.named_parameters(), want_grads)
        floor = _grad_rel(cpu2.student.named_parameters(), want_grads)
        # IGEV's bounds (phase 14), or twice the CPU's own floor where fp32
        # reordering alone comes near them (phase 12's rule)
        tol = {g: max(0.05 if g == "all" else 0.1, 2 * floor[g]) for g in rel}
        for g, e in rel.items():
            check(e <= tol[g], f"{name} train parity gradient of {g}: {e} > {tol[g]}")
        print(f"{name} train-step parity ({path}, fp32, TF32 off, 1x64x128), card vs CPU: loss "
              f"{m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f}, relative errors "
              + " ".join(f"{k} {e:.2e}" for k, e in loss_err.items()) + " (tol 1e-3) | gradient "
              "relative L2 error by module " + " ".join(f"{g} {e:.2e}" for g, e in rel.items())
              + " (tol 0.1 per module, 0.05 all, or twice the chaos floor on the CPU from a "
              "1e-5 weight nudge: " + " ".join(f"{g} {e:.2e}" for g, e in floor.items()) + ")")
        del gpu, cpu, cpu2
    torch.backends.cudnn.allow_tf32 = True


def phase_gwc_train(torch, card):
    """Phase 28d: the DKT step of GWCNet base_gc and CGI base.json as shipped
    (bf16, frozen batch norm) at B=8, 320x720, the CLI's default crop (CGI
    320x736, ``GWC_CGI_CROP``): 1 warm-up and TRAIN_STEPS timed steps with
    the device time of each part, no port kernel launched, every student
    tensor with a gradient moved, the teacher and the BN statistics
    bit-identical, peak memory and a profile of one step. GWCNet's batch
    norms are calibrated on a batch first (``calibrate_gwc``, 10 rounds),
    so that its gradients do not vanish."""
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    hyper = DKTHyperParams()
    paths = {}
    for name, path in GWC_CGI_TRAIN:
        B, H, W = GWC_CGI_CROP[name]
        cfg = _config(path)
        gen = torch.Generator(device="cuda").manual_seed(33)
        state = create_dkt_state(cfg, hyper, seed=0)
        if name != "cgi":
            b = _train_batch(torch, gen, B, H, W, "cuda")
            calibrate_gwc(torch, state.student, b["img1_clean"], b["img2_clean"], rounds=10)
            state = create_dkt_state(cfg, hyper, params=state.student.state_dict())
        step = make_dkt_train_step(cfg, hyper)
        before = snapshot(state, name)
        state, run = timed_steps(torch, state, step, gen, (B, H, W), name)
        check(all(not any(c.values()) for c in run["per_step"]),
              f"{name} steps launched port kernels: {run['per_step']}")
        unused = CGI_UNUSED if name == "cgi" else ()
        params = dict(state.student.named_parameters())
        graded = [k for k in params if not k.startswith(unused)]
        moment = {k: float(state.optimizer.state[params[k]]["exp_avg"].abs().max())
                  for k in params}
        check(all(moment[k] > 0 for k in graded),
              f"{name} tensors without gradient: {[k for k in graded if moment[k] == 0][:5]}")
        check(all(moment[k] == 0 for k in params if k not in graded),
              f"{name}: a module the reference never runs got a gradient")
        still = [k for k in graded if torch.equal(params[k], before["student"][k])]
        check(all(moment[k] < 1e-8 for k in still),
              f"{name} tensors with a gradient that did not move: "
              f"{[(k, moment[k]) for k in still if moment[k] >= 1e-8][:5]}")
        check_moved_and_frozen(torch, state, before, name, moved=False)
        print(f"{name} training path ({path} as shipped, bf16, frozen BN, B={B} {H}x{W}, "
              f"{TRAIN_STEPS} steps after 1 warm-up): {step_line(run)} | epe "
              + ", ".join(f"{x['epe']:.3f}" for x in run["metrics"]) + f" | {len(graded)} "
              f"student tensors with a gradient, {len(graded) - len(still)} moved | {card}")
        profile_step(torch, state, step, gen, (B, H, W), run["ms"].mean(),
                     f"chip_smoke_{name}_train_profile.txt", f"{name} training")
        paths[f"{name}_training"] = run["launches"]
        del state, step
        torch.cuda.empty_cache()
    return paths


KITTI_IMAGE = (375, 1242)  # KITTI 2015's own frame size
KITTI_FRAMES = 56  # the validator's 51 warm-up frames and 5 timed ones
EVAL_ITERS = 32


KITTI_SUBDIRS = ("image_2", "image_3", "disp_occ_0")


def write_kitti_tree(root):
    """A synthetic KITTI-2015 training tree under ``root`` written with the
    port's PNG encoder: textured left images, right images that are the
    left shifted by the true disparity, and uint16 ``disp_occ_0`` maps (x
    256) with the top rows and a band of pixels 0 (invalid), as KITTI's
    sparse maps have. Two distinct frames, copied to KITTI_FRAMES names."""
    import shutil

    from dkt_stereo_tpu_torch.data import png

    H, W = KITTI_IMAGE
    rng = np.random.default_rng(29)
    base = Path(root) / "KITTI" / "KITTI_2015" / "training"
    for sub in KITTI_SUBDIRS:
        (base / sub).mkdir(parents=True, exist_ok=True)
    for i in range(KITTI_FRAMES):
        name = f"{i:06d}_10.png"
        if i < 2:
            tex = rng.integers(0, 256, (H, W + 128, 3), dtype=np.uint8)
            tex = ((tex.astype(np.uint16) + np.roll(tex, 1, 1) + np.roll(tex, 1, 0)) // 3)
            yy, xx = np.mgrid[:H, :W]
            disp = (20 + 40 * yy / H + 10 * np.sin(xx / 60 + i)).astype(np.float32)
            left = tex[:, 64:64 + W].astype(np.uint8)
            cols = np.clip(np.rint(64 + xx - disp).astype(np.int64), 0, W + 127)
            right = tex[yy, cols].astype(np.uint8)
            d16 = np.rint(disp * 256).astype(np.uint16)
            d16[:H // 3] = 0
            d16[:, 200:260] = 0
            png.write(base / "image_2" / name, left)
            png.write(base / "image_3" / name, right)
            png.write(base / "disp_occ_0" / name, d16)
        else:
            for sub in KITTI_SUBDIRS:
                shutil.copyfile(base / sub / f"{i % 2:06d}_10.png", base / sub / name)
    return str(root)


def kitti_subset(data, root, frames):
    """A KITTI tree under ``root`` with the first ``frames`` frames of the
    one under ``data``."""
    import shutil

    sub = Path("KITTI") / "KITTI_2015" / "training"
    for d in KITTI_SUBDIRS:
        (root / sub / d).mkdir(parents=True)
        for i in range(frames):
            name = f"{i:06d}_10.png"
            shutil.copyfile(Path(data) / sub / d / name, root / sub / d / name)
    return root


def seeded_pth(torch, config, path):
    """A reference-format .pth of ``config``'s model with seeded random
    weights, written with torch.save as a user's checkpoint is."""
    from dkt_stereo_tpu_torch.models.registry import create_model

    model = create_model(config, iters=1, device="cpu", seed=0)
    torch.save(model.state_dict(), path)
    return str(path)


class _FrameTimes:
    """Records the seconds of every ``_run_one`` call the validators make
    while it is entered (the frame's forward, unpad and copy back)."""

    def __init__(self):
        from dkt_stereo_tpu_torch.eval import validate

        self.mod, self.seconds = validate, []

    def __enter__(self):
        self.orig = self.mod._run_one

        def timed(*a, **kw):
            out = self.orig(*a, **kw)
            self.seconds.append(out[1])
            return out

        self.mod._run_one = timed
        return self

    def __exit__(self, *exc):
        self.mod._run_one = self.orig


def _capture_forward(torch):
    """Patch ``run_validator`` to record the forward the eval CLI builds;
    returns (the list it fills, a function that restores it)."""
    from dkt_stereo_tpu_torch.eval import validate

    seen, orig = [], validate.run_validator

    def run_validator(name, forward, *a, **kw):
        seen.append(forward)
        return orig(name, forward, *a, **kw)

    validate.run_validator = run_validator

    def restore():
        validate.run_validator = orig

    return seen, restore


def phase_eval(torch, card, tmp):
    """The eval path through ``cli.eval.main`` on the synthetic KITTI tree
    at 375x1242: pallas.json fp32 (the protocol) and with
    --mixed_precision, 32 iterations, 56 frames, exact K1 and K2 launches;
    then base.json on the first 2 frames at 2 iterations on the card and on
    the CPU."""
    from dkt_stereo_tpu_torch.cli.config import load_model_config
    from dkt_stereo_tpu_torch.cli.eval import main as eval_main
    from dkt_stereo_tpu_torch.eval import validate

    t0 = time.perf_counter()
    data = write_kitti_tree(tmp / "data")
    write_s = time.perf_counter() - t0
    pallas = str(ROOT / "configs/raft_stereo/pallas.json")
    pth = seeded_pth(torch, load_model_config(pallas), tmp / "raft_pallas.pth")
    paths, rows = {}, []
    for label, extra in (("fp32", []), ("bf16", ["--mixed_precision"])):
        args = ["--config", pallas, "--restore_ckpt", pth, "--valid_iters", str(EVAL_ITERS),
                "--datasets", "kitti-2015", "--data_root", data] + extra
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with _FrameTimes() as ft:
            res = eval_main(args)
        launches = kernel_counts()
        want = {**dict.fromkeys(launches, 0), "corr_lookup": EVAL_ITERS * KITTI_FRAMES,
                "encoder_stage": 4 * KITTI_FRAMES}
        check(launches == want, f"eval {label} launch counts {launches} != {want}")
        check(len(ft.seconds) == KITTI_FRAMES and "kitti-2015-fps" in res
              and all(np.isfinite(v) for v in res.values()), f"eval {label}: {res}")
        ms = 1e3 * np.asarray(ft.seconds)
        paths[f"eval_kitti_{label}"] = launches
        rows.append(
            f"eval path (cli.eval, pallas.json {label}, kitti-2015 {KITTI_FRAMES} frames "
            f"{KITTI_IMAGE[0]}x{KITTI_IMAGE[1]}, {EVAL_ITERS} iters): EPE "
            f"{res['kitti-2015-epe']:.4f} px D1 {res['kitti-2015-d1']:.3f} % "
            f"kitti-2015-fps {res['kitti-2015-fps']:.3f} (frames 52-56) | ms/frame median "
            f"{np.median(ms):.2f} min {ms.min():.2f} max {ms.max():.2f} (frames 52-56: median "
            f"{np.median(ms[51:]):.2f}) | peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches a frame: K1 "
            f"{launches['corr_lookup'] // KITTI_FRAMES}, K2 "
            f"{launches['encoder_stage'] // KITTI_FRAMES} | {card}")
        print(rows[-1], flush=True)

    # base.json, 2 frames at 2 iterations, on the card and on the CPU: the
    # card's kernels against the plain path, fp32 with TF32 off
    small = kitti_subset(data, tmp / "data2", 2)
    base = str(ROOT / "configs/raft_stereo/base.json")
    base_pth = seeded_pth(torch, load_model_config(base), tmp / "raft_base.pth")
    args = ["--config", base, "--restore_ckpt", base_pth, "--valid_iters", "2", "--datasets",
            "kitti-2015", "--data_root", str(small)]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card_res = eval_main(args)
        seen, restore = _capture_forward(torch)
        try:
            cpu_res = eval_main(args, device="cpu")
        finally:
            restore()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    ds = validate.KITTI(None, root=str(small / "KITTI"), split="2015")
    near = total = 0
    for i in range(len(ds)):
        img1, img2, flow_gt, valid_gt = ds.get_sample(i)
        pred, _ = validate._run_one(seen[0], img1, img2, 32)
        val = (valid_gt >= 0.5) & (flow_gt > -192) & (flow_gt < 0)
        err = np.abs(pred - flow_gt)[val]
        near += int((np.abs(err - 3.0) <= 5e-3).sum())
        total += err.size
    epe_gap = abs(card_res["kitti-2015-epe"] - cpu_res["kitti-2015-epe"])
    d1_gap = abs(card_res["kitti-2015-d1"] - cpu_res["kitti-2015-d1"])
    d1_tol = 100 * near / total
    # 5e-3 px: the RAFT card-vs-CPU bound of phase 4
    check(epe_gap <= 5e-3, f"eval base.json card vs CPU EPE gap {epe_gap} > 5e-3")
    check(d1_gap <= d1_tol + 1e-9, f"eval base.json card vs CPU D1 gap {d1_gap} > {d1_tol}")
    print(f"eval parity (cli.eval, base.json fp32, TF32 off, 2 frames {KITTI_IMAGE[0]}x"
          f"{KITTI_IMAGE[1]}, 2 iters): card EPE {card_res['kitti-2015-epe']:.5f} D1 "
          f"{card_res['kitti-2015-d1']:.4f} | CPU EPE {cpu_res['kitti-2015-epe']:.5f} D1 "
          f"{cpu_res['kitti-2015-d1']:.4f} | EPE gap {epe_gap:.2e} px (tol 5e-3) | D1 gap "
          f"{d1_gap:.2e} % (tol {d1_tol:.2e} %: pixels whose CPU error is within 5e-3 px of 3 "
          f"px) | the tree written in {write_s:.1f} s")
    return paths, data


def phase_eval_models(torch, card, tmp, data):
    """Phase 30: IGEV pallas.json and PCVNet base.json through
    ``cli.eval.main`` on one frame of the KITTI tree, 32 iterations, on the
    card: finite metrics, exact K4 and K5 launches; then GWCNet base_gc.json
    and CGI base.json (no port kernel) from a reference-format .pth that
    went through ``cli.export``'s round trip: the seeded .pth into a port
    checkpoint (``create_dkt_state`` + ``save_checkpoint``) and back out
    with itself as the template, bit for bit."""
    from dkt_stereo_tpu_torch.cli.config import load_model_config
    from dkt_stereo_tpu_torch.cli.eval import main as eval_main
    from dkt_stereo_tpu_torch.cli.export import main as export_main
    from dkt_stereo_tpu_torch.train.checkpoint import save_checkpoint
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    one = kitti_subset(data, tmp / "data1", 1)
    paths = {}
    for name, config, kernel in (("igev", "configs/igev_stereo/pallas.json", "geo_lookup"),
                                 ("pcv", "configs/pcvnet/base.json", "gaussian_row_sample"),
                                 ("gwc_gc", "configs/gwcnet/base_gc.json", None),
                                 ("cgi", "configs/cgi/base.json", None)):
        cfg = str(ROOT / config)
        pth = seeded_pth(torch, load_model_config(cfg), tmp / f"{name}.pth")
        note = ""
        if kernel is None:
            seeded = torch.load(pth, map_location="cpu", weights_only=True)
            state = create_dkt_state(load_model_config(cfg), DKTHyperParams(), params=seeded,
                                     device="cpu")
            ckpt = save_checkpoint(tmp / f"{name}_run", state)
            exported = tmp / f"{name}_exported.pth"
            export_main(["--restore_ckpt", ckpt, "--template", pth, "--out", str(exported)])
            _equal_tree(torch, torch.load(exported, map_location="cpu", weights_only=True), seeded,
                        f"{name} export round trip")
            pth, note = str(exported), f" from cli.export's round trip ({len(seeded)} tensors)"
            del state
        zero_counts()
        t0 = time.perf_counter()
        res = eval_main(["--config", cfg, "--restore_ckpt", pth, "--valid_iters",
                         str(EVAL_ITERS), "--datasets", "kitti-2015", "--data_root", str(one)])
        secs = time.perf_counter() - t0
        launches = kernel_counts()
        want = {**dict.fromkeys(launches, 0), **({kernel: EVAL_ITERS} if kernel else {})}
        check(launches == want, f"eval {name} launch counts {launches} != {want}")
        check(all(np.isfinite(v) for v in res.values()), f"eval {name}: {res}")
        paths[f"eval_{name}"] = launches
        iters = f"{EVAL_ITERS} iters, " if kernel else ""
        print(f"eval path (cli.eval, {config} fp32, 1 frame {KITTI_IMAGE[0]}x{KITTI_IMAGE[1]}, "
              f"{iters}seeded random weights{note}): EPE {res['kitti-2015-epe']:.3f} px "
              f"D1 {res['kitti-2015-d1']:.2f} % | {kernel or 'no port kernel'} launches "
              f"{launches[kernel] if kernel else sum(launches.values())} | {secs:.1f} s with the "
              f"model's build | {card}", flush=True)
    return paths


def phase_demo(torch, tmp, data):
    """``cli.demo.main`` on 2 pairs of the KITTI tree with --save_numpy and
    --save_ply (base.json, 32 iterations): the PNG is ``disp_to_color`` of
    the .npy, the .npy is -1 x the eval forward's output for the pair on the
    card, and the PLY has a vertex for every pixel with a nonzero
    disparity."""
    from dkt_stereo_tpu_torch.cli.config import load_model_config
    from dkt_stereo_tpu_torch.cli.demo import main as demo_main
    from dkt_stereo_tpu_torch.data import png
    from dkt_stereo_tpu_torch.data.readers import read_image_rgb
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.utils.visualization import disp_to_color
    from dkt_stereo_tpu_torch.weights import load_reference_pth

    base = str(ROOT / "configs/raft_stereo/base.json")
    pth = str(tmp / "raft_base.pth")
    imgs = Path(data) / "KITTI" / "KITTI_2015" / "training"
    out = tmp / "demo"
    zero_counts()
    t0 = time.perf_counter()
    written = demo_main(["--config", base, "--restore_ckpt", pth, "--valid_iters",
                         str(EVAL_ITERS), "-l", str(imgs / "image_2" / "00000[01]_10.png"),
                         "-r", str(imgs / "image_3" / "00000[01]_10.png"), "-o", str(out),
                         "--save_numpy", "--save_ply"])
    secs = time.perf_counter() - t0
    launches = kernel_counts()
    check(len(written) == 2 and launches["corr_lookup"] == 2 * EVAL_ITERS,
          f"demo wrote {written}, launches {launches}")
    model = create_model(load_model_config(base), iters=EVAL_ITERS)
    forward = make_forward_fn(load_reference_pth(model, pth))
    gaps, verts = [], []
    for p in written:
        disp = np.load(p.with_suffix(".npy"))
        rgb, _ = disp_to_color(disp)
        check(np.array_equal(png.read(p), rgb[0].transpose(1, 2, 0).astype(np.uint8)),
              f"demo {p.name}: the PNG is not disp_to_color of the .npy")
        left = read_image_rgb(str(imgs / "image_2" / p.name)).astype(np.float32)
        right = read_image_rgb(str(imgs / "image_3" / p.name)).astype(np.float32)
        pred, _ = _run_one(forward, left, right)
        gaps.append(float(np.abs(disp + pred).max()))
        check(gaps[-1] <= 1e-3, f"demo {p.name}: .npy vs -forward {gaps[-1]} > 1e-3 px")
        header = p.with_suffix(".ply").read_text().split("end_header")[0]
        verts.append(int((np.abs(disp) > 0).sum()))
        check(f"element vertex {verts[-1]}\n" in header, f"demo {p.name}: PLY vertices")
    print(f"demo (cli.demo, base.json bf16, 2 pairs {KITTI_IMAGE[0]}x{KITTI_IMAGE[1]}, "
          f"{EVAL_ITERS} iters, --save_numpy --save_ply): PNG = disp_to_color(.npy) | .npy vs "
          f"-forward max_abs " + " ".join(f"{g:.1e}" for g in gaps) + " px (tol 1e-3) | PLY "
          f"vertices {verts} | {secs:.1f} s with the model's build")


def phase_bench(torch):
    """``dkt_stereo_tpu_torch.bench`` in-process; its JSON line is printed
    on a line of its own."""
    from dkt_stereo_tpu_torch import bench

    zero_counts()
    res = bench.run()
    launches = kernel_counts()
    frames = bench.WARMUP + bench.BATCHES * bench.FRAMES
    check(launches["corr_lookup"] == bench.ITERS * frames
          and launches["encoder_stage"] == 4 * frames, f"bench launches {launches}")
    check(res["value"] > 0 and res["mean_fps"] > 0, f"bench {res}")
    print(json.dumps(res), flush=True)
    return {"bench": launches}



# --- the training side: the host data path and the recipes through cli.train -------

BOOSTER_IMAGE = (752, 1028)  # Booster's quarter resolution (3008x4112 / 4)
BOOSTER_SCENES = 6
SCENEFLOW_IMAGE = (540, 960)  # Scene Flow's own frame size
RECIPE_ARGS = ["--config", str(ROOT / "configs/raft_stereo/train.json"), "--train_datasets",
               "booster",
               "--batch_size", "2", "--image_size", "480", "896", "--train_iters", "16",
               "--lr", "1e-5", "--tau_pl", "3.0",  # run_scripts/raft_stereo/ft_booster.sh
               # as scripts/drive_recipe_fixture.sh, a worker count for the host (phase 33)
               "--num_workers", "4"]
TRAIN_WORKERS = "4"
HOST_SAMPLES = 2
LOADER_BATCHES = 8
FED_WORKERS = (0, 4)  # loader processes beside the step (0: built in the step's process)
FED_STEPS = 3


def _textured_pair(rng, H, W, disp):
    """A smoothed-noise left image and the right image it gives at ``disp``
    px of disparity, uint8."""
    tex = rng.integers(0, 256, (H, W + 256, 3), dtype=np.uint8).astype(np.uint16)
    tex = ((tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 0)) // 3).astype(np.uint8)
    yy, xx = np.mgrid[:H, :W]
    cols = np.clip(np.rint(128 + xx - disp).astype(np.int64), 0, W + 255)
    return tex[:, 128:128 + W], tex[yy, cols]


def write_training_trees(root):
    """Under ``root``: a Booster quarter-resolution tree (BOOSTER_SCENES
    scenes at 752x1028, ``disp_00.npy`` with an invalid band) and a Scene
    Flow TRAIN tree (2 FlyingThings3D frames in both passes at 540x960, PFM
    disparities), the PNGs written with adaptive filters as dataset files
    are. Returns the seconds it took."""
    from dkt_stereo_tpu_torch.data import png
    from dkt_stereo_tpu_torch.data.readers import writePFM

    t0 = time.perf_counter()
    rng = np.random.default_rng(33)
    H, W = BOOSTER_IMAGE
    yy, xx = np.mgrid[:H, :W]
    for s in range(BOOSTER_SCENES):
        scene = Path(root) / "Booster_dataset/quarter/train/balanced" / f"scene{s}"
        disp = (30 + 60 * yy / H + 15 * np.sin(xx / 70 + s)).astype(np.float32)
        left, right = _textured_pair(rng, H, W, disp)
        for cam, img in (("camera_00", left), ("camera_02", right)):
            (scene / cam).mkdir(parents=True)
            png.write(scene / cam / "0000.png", img, adaptive=True)
        disp[:, :40] = 0  # no ground truth at the left border
        np.save(scene / "disp_00.npy", disp)
    H, W = SCENEFLOW_IMAGE
    yy, xx = np.mgrid[:H, :W]
    things = Path(root) / "sceneflow/FlyingThings3D"
    for i in range(2):
        disp = (10 + 80 * xx / W + 5 * np.cos(yy / 40 + i)).astype(np.float32)
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            left, right = _textured_pair(rng, H, W, disp)
            for side, img in (("left", left), ("right", right)):
                d = things / dstype / "TRAIN" / f"A/000{i}" / side
                d.mkdir(parents=True)
                png.write(d / "0006.png", img, adaptive=True)
        d = things / "disparity/TRAIN" / f"A/000{i}/left"
        d.mkdir(parents=True)
        writePFM(str(d / "0006.pfm"), disp)
    return time.perf_counter() - t0


def _host_seconds(ds, n):
    """Host seconds a sample takes in this process: reading its files (a
    pair and its disparity, or a NeRF-Stereo triplet and its two 16-bit
    maps), and the whole augmented ``get_sample`` (augmenting is the
    rest)."""
    from dkt_stereo_tpu_torch.data import png, readers

    read, total = [], []
    for i in range(n):
        t0 = time.perf_counter()
        paths = ds.image_list[i % len(ds)]
        if hasattr(ds, "disparity_list"):
            ds.disparity_reader(ds.disparity_list[i % len(ds)])
        else:  # NerfStereo: three views, then disparity and confidence
            paths, maps = paths[:3], paths[3:]
            for path in maps:
                png.read(path)
        for path in paths:
            readers.read_image_rgb(path)
        t1 = time.perf_counter()
        ds.get_sample(i, np.random.default_rng(i))
        total.append(time.perf_counter() - t1)
        read.append(t1 - t0)
    read, total = np.asarray(read), np.asarray(total)
    return float(np.median(read)), float(np.median(total - read))


def _loader_rate(torch, ds, batch, workers, batches):
    """Batches a second of a StereoLoader over ``ds``: the seconds to the
    first batch (the workers' start), then ``batches`` more, across
    epochs; returns (first s, batches/s, the first batch)."""
    from dkt_stereo_tpu_torch.data.loader import StereoLoader

    loader = StereoLoader(ds, batch_size=batch, num_workers=workers, seed=1234)
    try:
        t0 = time.perf_counter()
        it = iter(loader)
        first = next(it)
        t1 = time.perf_counter()
        n = 0
        while n < batches:
            for _ in it:
                n += 1
                if n == batches:
                    break
            it = iter(loader)
        return t1 - t0, batches / (time.perf_counter() - t1), first
    finally:
        loader.close()


def _fed_steps(torch, ds, workers, steps):
    """The RAFT recipe's loop in miniature: ``steps`` DKT steps of
    train.json (2x480x896, 16/32 iterations, seeded random weights) fed by
    a StereoLoader of ``workers`` processes over ``ds``, as cli.train runs
    them. Returns host ms of the wait in ``next`` and of the step's own
    part (copy, step, metrics) for the steps after the first, and the
    seconds to the first batch."""
    from dkt_stereo_tpu_torch.data.loader import StereoLoader
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    config = json.loads((ROOT / "configs/raft_stereo/train.json").read_text())
    hyper = DKTHyperParams(lr=1e-5, train_iters=16)
    state = create_dkt_state(config, hyper, seed=0)
    step = make_dkt_train_step(config, hyper)
    gen = torch.Generator().manual_seed(0)
    loader = StereoLoader(ds, batch_size=2, num_workers=workers, seed=1234)

    def stream():
        while True:
            yield from loader

    wait, own = [], []
    try:
        batches = stream()
        t_start = time.perf_counter()
        for _ in range(steps + 1):
            t0 = time.perf_counter()
            cpu = next(batches)
            t1 = time.perf_counter()
            state, m = step(state, {k: v.to("cuda", non_blocking=True) for k, v in cpu.items()},
                            generator=gen)
            check(m["ok"] == 1.0, f"fed step not ok: {m}")
            wait.append(t1 - t0)
            own.append(time.perf_counter() - t1)
        first = wait[0]
    finally:
        loader.close()
    del state, step
    torch.cuda.empty_cache()
    return 1e3 * np.asarray(wait[1:]), 1e3 * np.asarray(own[1:]), first


def phase_data(torch, tmp, card):
    """Phase 33, the host data path: the training trees, the seconds a
    sample takes to read and to augment (Booster, sparse, at the RAFT
    recipe's 480x896 crop; Scene Flow, dense, at PCVNet's 320x720), the
    loader's batches a second at the recipe's batch 2 with the CLI's
    --num_workers, and a batch's keys, shapes, dtypes, ranges and pinned
    memory."""
    from dkt_stereo_tpu_torch.cli.train import parse_args
    from dkt_stereo_tpu_torch.data.datasets import fetch_dataset

    data = tmp / "train_data"
    write_s = write_training_trees(data)
    booster = fetch_dataset(["booster"], (480, 896), data_root=str(data))
    sceneflow = fetch_dataset(["sceneflow"], (320, 720), data_root=str(data))
    b_read, b_aug = _host_seconds(booster, HOST_SAMPLES)
    s_read, s_aug = _host_seconds(sceneflow, HOST_SAMPLES)
    workers = parse_args(["--config", "x"]).num_workers
    first_s, rate, batch = _loader_rate(torch, booster, 2, workers, LOADER_BATCHES)
    fed = []
    for n in FED_WORKERS:
        wait, own, first = _fed_steps(torch, booster, n, FED_STEPS)
        fed.append(f"{n} workers: wait median {np.median(wait):.1f} max {wait.max():.1f} ms, "
                   f"the step's own median {np.median(own):.1f} ms, iteration median "
                   f"{np.median(wait + own):.1f} ms (first batch after {first:.1f} s)")
    want = {"img1": (2, 480, 896, 3), "img2": (2, 480, 896, 3), "img1_clean": (2, 480, 896, 3),
            "img2_clean": (2, 480, 896, 3), "flow": (2, 480, 896), "valid": (2, 480, 896)}
    check({k: tuple(v.shape) for k, v in batch.items()} == want, f"batch shapes {batch}")
    for k, v in batch.items():
        check(v.dtype == torch.float32 and v.device.type == "cpu" and v.is_pinned(),
              f"batch {k}: {v.dtype} {v.device} pinned {v.is_pinned()}")
        check(bool(torch.isfinite(v).all()), f"batch {k} not finite")
    check(all(0 <= float(batch[k].min()) and float(batch[k].max()) <= 255
              for k in ("img1", "img2", "img1_clean", "img2_clean")), "image range")
    valid = batch["valid"]
    check(set(torch.unique(valid).tolist()) <= {0.0, 1.0} and float(valid.mean()) > 0,
          f"valid mean {float(valid.mean())}")
    check(float(batch["flow"][valid > 0].max()) < 0, "flow is not negative disparity")
    print(f"host data path (numpy on the host; {os.cpu_count()} CPUs): the trees written in "
          f"{write_s:.1f} s (adaptive PNG filters) | a sample on one worker, median of "
          f"{HOST_SAMPLES}: Booster {BOOSTER_IMAGE[0]}x{BOOSTER_IMAGE[1]} sparse -> 480x896: "
          f"read {b_read:.3f} s, augment {b_aug:.3f} s; Scene Flow {SCENEFLOW_IMAGE[0]}x"
          f"{SCENEFLOW_IMAGE[1]} dense -> 320x720: read {s_read:.3f} s, augment {s_aug:.3f} s "
          f"| loader, batch 2 at 480x896, {workers} workers (--num_workers default), the "
          f"tree as the CLI builds it (3 batches an epoch): {rate:.2f} batches/s over "
          f"{LOADER_BATCHES} batches after the first, which came {first_s:.1f} s after the "
          f"loader started | RAFT recipe steps (train.json, 2x480x896) fed by the loader, "
          f"{FED_STEPS} steps after the first: " + "; ".join(fed)
          + f" | batch: keys, shapes, float32, pinned, ranges ok | {card}", flush=True)
    return data


class _StepProbe:
    """While entered, ``cli.train`` builds its step (``factory``, the DKT
    step's or the NS step's) through a wrapper that keeps a CPU copy of the
    state the first step is handed and the launch counts and metrics of
    every step."""

    def __init__(self, torch, factory="make_dkt_train_step"):
        from dkt_stereo_tpu_torch.cli import train as cli

        self.torch, self.cli, self.factory = torch, cli, factory
        self.orig = getattr(cli, factory)
        self.first, self.per_step, self.metrics = None, [], []

    def __enter__(self):
        def make(config, hyper, **kw):
            step = self.orig(config, hyper, **kw)

            def step_fn(state, batch, **kw):
                if self.first is None:
                    self.first = _state_to_cpu(self.torch, state)
                before = kernel_counts()
                state, m = step(state, batch, **kw)
                self.per_step.append(_diff(kernel_counts(), before))
                self.metrics.append(m)
                return state, m

            return step_fn

        setattr(self.cli, self.factory, make)
        return self

    def __exit__(self, *exc):
        setattr(self.cli, self.factory, self.orig)


def _to_cpu(torch, x):
    if isinstance(x, dict):
        return {k: _to_cpu(torch, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_cpu(torch, v) for v in x]
    return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else copy.deepcopy(x)


def _state_to_cpu(torch, state):
    return {"step": state.step, "student": _to_cpu(torch, state.student.state_dict()),
            "ema": _to_cpu(torch, state.ema.state_dict()),
            "teacher": _to_cpu(torch, state.teacher.state_dict()),
            "optimizer": _to_cpu(torch, state.optimizer.state_dict())}


def _equal_tree(torch, a, b, where):
    if isinstance(b, dict):
        check(set(a) == set(b), f"{where}: keys differ")
        for k in b:
            _equal_tree(torch, a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        check(len(a) == len(b), f"{where}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tree(torch, x, y, f"{where}[{i}]")
    elif isinstance(b, torch.Tensor):
        check(torch.equal(torch.as_tensor(a), b), f"{where}: tensors differ")
    else:
        check(a == b, f"{where}: {a} != {b}")


def _ckpt(torch, path):
    from dkt_stereo_tpu_torch.train.checkpoint import CHECKPOINT_FILE

    return torch.load(Path(path) / CHECKPOINT_FILE, map_location="cpu", weights_only=True)


def _stage_line(label, timing, per_step, validation, card):
    ms, wait, own = timing["ms_per_step"], timing["wait_ms"], timing["step_ms"]
    launches = ({k: v for k, v in per_step[0].items() if v} if per_step else
                "not read (another process)")
    return (f"{label}: {timing['steps']} steps | ms/step (host clock around the loop's "
            f"iteration, steps after the first) median {ms['median']:.1f} min {ms['min']:.1f} "
            f"max {ms['max']:.1f} | loader wait median {wait['median']:.1f} min "
            f"{wait['min']:.1f} max {wait['max']:.1f} ms | the step's own median "
            f"{own['median']:.1f} ms | peak mem {timing.get('peak_gib', float('nan')):.2f} GiB "
            f"| launches a step {launches} | validators {sorted(validation) or 'none run'} | {card}")


def _in_process(torch, argv, label, want, card, factory="make_dkt_train_step"):
    """``cli.train.main(argv)`` on the card with every launch counter zeroed
    first; each step (built by ``factory``) must launch exactly ``want`` and
    be ok. Returns the CLI's result, the probe and the counts of the whole
    run."""
    from dkt_stereo_tpu_torch.cli.train import main as train_main

    zero_counts()
    with _StepProbe(torch, factory) as probe:
        res = train_main(argv)
    launches = kernel_counts()
    full = {**dict.fromkeys(launches, 0), **want}
    check(probe.per_step and all(c == full for c in probe.per_step),
          f"{label} launches a step {probe.per_step} != {full}")
    check(all(m["ok"] == 1.0 and np.isfinite(m["loss"]) for m in probe.metrics),
          f"{label} step not ok: {[(m['ok'], m['loss']) for m in probe.metrics]}")
    print(_stage_line(label, res["timing"], probe.per_step, res["validation"], card), flush=True)
    torch.cuda.empty_cache()
    return res, probe, launches


def phase_booster_recipe(torch, tmp, data, card):
    """Phase 34, run_scripts/raft_stereo/ft_booster.sh through cli.train at
    full width (batch 2, 480x896, 16 iterations, from a seeded random .pth;
    4 loader workers, as scripts/drive_recipe_fixture.sh sets its own):
    stage 1 in a subprocess, killed once its mid-run save (step_3, after
    step 2) and that save's validation exist; the same command with
    --auto_resume in this process, which must restore the save bit for bit
    and end at step_{num_steps+1}; stage 2 with --restore_weights_only and
    --restore_ckpt_T; cli.export of stage 2's student with the .pth as
    template; cli.eval on two Booster frames with the export and with stage
    2's checkpoint --which ema. Exactly 96 K1 and 16 K1-backward launches a
    step (the subprocess's counters are its own and not read). The killed
    stage's forkserver, resource tracker and workers are stopped and reaped
    with it."""
    import re

    from dkt_stereo_tpu_torch.cli.config import load_model_config
    from dkt_stereo_tpu_torch.cli.eval import main as eval_main
    from dkt_stereo_tpu_torch.cli.export import main as export_main

    ws = tmp / "recipe"
    pth = seeded_pth(torch, load_model_config(str(ROOT / "configs/raft_stereo/train.json")),
                     tmp / "raft_train.pth")
    stage1 = RECIPE_ARGS + ["--data_root", str(data), "--ema_decay", "0.9999", "--num_steps",
                            "4", "--validation_frequency", "3", "--save_dir",
                            str(ws / "stage1"), "--restore_ckpt", pth]
    want = {"corr_lookup": 96, "corr_lookup_bwd": 16}

    log = tmp / "stage1.log"
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "dkt_stereo_tpu_torch.cli.train", *stage1],
                                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        deadline = time.perf_counter() + 300
        while time.perf_counter() < deadline and proc.poll() is None:
            if (ws / "stage1/step_3").is_dir() and "validation {" in log.read_text():
                break
            time.sleep(0.25)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(timeout=60)
        stop_children(pgid=proc.pid)
    text = log.read_text()
    check(proc.returncode == -signal.SIGTERM and (ws / "stage1/step_3").is_dir()
          and not (ws / "stage1/step_5").exists(),
          f"stage 1 was not killed after its mid-run save (exit {proc.returncode}): "
          f"{text[-3000:]}")
    timing = json.loads(re.findall(r"timing (\{.*\})", text)[-1])
    validation = json.loads(re.findall(r"validation (\{.*\})", text)[-1])
    print(_stage_line(f"recipe stage 1 (subprocess, killed after step_3 and its validation, "
                      f"{time.perf_counter() - t0:.1f} s with its start)", timing, None,
                      validation, card), flush=True)

    saved = _ckpt(torch, ws / "stage1/step_3")
    res, probe, resume_launches = _in_process(
        torch, stage1 + ["--auto_resume"], "recipe stage 1, --auto_resume", want, card)
    check(saved["step"] == 2 and probe.first["step"] == 2, f"resumed at {probe.first['step']}")
    for part in ("student", "ema", "teacher", "optimizer"):
        _equal_tree(torch, probe.first[part], saved[part], f"resume {part}")
    check(res["checkpoint"] == str(ws / "stage1/step_5") and _ckpt(torch, res["checkpoint"])[
        "step"] == 5, f"resumed run ended at {res['checkpoint']}")

    ref = torch.load(pth, map_location="cpu", weights_only=True)
    stage2 = RECIPE_ARGS + ["--data_root", str(data), "--ema_decay", "0.99999", "--num_steps",
                            "2", "--validation_frequency", "3", "--save_dir", str(ws / "stage2"),
                            "--restore_ckpt", res["checkpoint"], "--restore_weights_only",
                            "--restore_ckpt_T", pth]
    res2, probe2, stage2_launches = _in_process(torch, stage2, "recipe stage 2", want, card)
    last = _ckpt(torch, res["checkpoint"])
    check(probe2.first["step"] == 0 and probe2.first["optimizer"]["state"] == {},
          "stage 2 did not start at step 0 with a fresh optimizer")
    _equal_tree(torch, probe2.first["teacher"], ref, "stage 2 teacher vs the .pth")
    _equal_tree(torch, probe2.first["student"], last["student"], "stage 2 student")
    check(res2["checkpoint"] == str(ws / "stage2/step_3") and res2["validation"],
          f"stage 2: {res2['checkpoint']} {res2['validation']}")

    exported = tmp / "exported.pth"
    export_main(["--restore_ckpt", res2["checkpoint"], "--template", pth, "--out",
                 str(exported)])
    two = tmp / "booster2"
    for s in range(2):
        sub = f"Booster_dataset/quarter/train/balanced/scene{s}"
        (two / sub).parent.mkdir(parents=True, exist_ok=True)
        os.symlink(data / sub, two / sub)
    args = ["--config", str(ROOT / "configs/raft_stereo/train.json"), "--datasets", "booster-Q",
            "--data_root", str(two)]
    zero_counts()
    from_pth = eval_main(args + ["--restore_ckpt", str(exported)])
    from_ckpt = eval_main(args + ["--restore_ckpt", res2["checkpoint"], "--which", "ema"])
    eval_launches = kernel_counts()
    check(all(np.isfinite(v) for r in (from_pth, from_ckpt) for v in r.values()),
          f"eval {from_pth} {from_ckpt}")
    check(eval_launches["corr_lookup"] == 2 * 2 * EVAL_ITERS, f"eval launches {eval_launches}")
    print(f"recipe export and eval: {exported.name} ({len(torch.load(exported))} tensors), "
          f"cli.eval booster-Q on 2 frames, {EVAL_ITERS} iters: the exported student EPE "
          f"{from_pth['Booster-epe']:.3f} D1 {from_pth['Booster-d1']:.2f} % | stage 2's "
          f"checkpoint --which ema EPE {from_ckpt['Booster-epe']:.3f} D1 "
          f"{from_ckpt['Booster-d1']:.2f} % | {card}", flush=True)
    return {"train_cli_booster_resume": resume_launches,
            "train_cli_booster_stage2": stage2_launches, "train_cli_booster_eval": eval_launches}


def phase_train_models(torch, kitti, data, card):
    """Phase 35: run_scripts/igev/ft_kitti.sh's stage 1 (IGEV train.json,
    kitti_mix on the KITTI tree, batch 4, 320x736, EMA 0.99) and PCVNet
    base.json, GWCNet base_gc.json and CGI base.json on Scene Flow at batch
    8, 320x720 (CGI 320x736), through cli.train from seeded random .pth files, 4 loader
    workers, 3 steps each: exactly 96 K4 and 16 dgeo, and 80 K5 and 16
    K5-backward launches a step, none for GWCNet and CGI."""
    from dkt_stereo_tpu_torch.cli.config import load_model_config

    paths = {}
    for name, config, extra, want in (
            ("igev", "configs/igev_stereo/train.json",
             ["--train_datasets", "kitti_mix", "--data_root", str(kitti), "--batch_size", "4",
              "--image_size", "320", "736", "--lr", "2e-4", "--ema_decay", "0.99",
              "--tau_pl", "3.0", "--num_workers", TRAIN_WORKERS],
             {"geo_lookup": 96, "geo_lookup_bwd_geo": 16}),
            ("pcv", "configs/pcvnet/base.json",
             ["--train_datasets", "sceneflow", "--data_root", str(data), "--batch_size", "8",
              "--image_size", "320", "720", "--num_workers", TRAIN_WORKERS],
             {"gaussian_row_sample": 80, "gaussian_row_sample_bwd": 16}),
            *((name, path, ["--train_datasets", "sceneflow", "--data_root", str(data),
                            "--batch_size", "8", "--image_size",
                            *(str(x) for x in GWC_CGI_CROP[name][1:]), "--num_workers",
                            TRAIN_WORKERS], {}) for name, path in GWC_CGI_TRAIN)):
        cfg = str(ROOT / config)
        pth = seeded_pth(torch, load_model_config(cfg), Path(data).parent / f"{name}_train.pth")
        argv = ["--config", cfg, *extra, "--num_steps", "2", "--validation_frequency",
                "100000", "--save_dir", str(Path(data).parent / f"run_{name}"),
                "--restore_ckpt", pth]
        res, _, launches = _in_process(torch, argv, f"{name} through cli.train ({config})",
                                       want, card)
        check(res["checkpoint"].endswith("step_3"), f"{name} ended at {res['checkpoint']}")
        paths[f"train_cli_{name}"] = launches
    return paths

NS_CONFIG = ROOT / "configs/raft_stereo/ns.json"
NS_PARTS = ("ema", "forward", "loss", "backward", "optimizer")
NS_SPLITS = ((0, 8), (4, 4))  # (nb, nt) of the timed steps: all trinocular, then mixed
NS_TRIPLETS = 8
NS_CLI_STEPS = "2"  # steps 0-2: 3 steps through cli.train


def _nested(x, fn):
    return {k: _nested(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _ns_batch(torch, gen, nb, nt, H, W, device):
    """A synthetic batch in ``collate_mixed``'s form: the forward pair of
    ``nb + nt`` rows in [0, 255]; ``nb`` binocular rows' negative disparity
    in [-64, 0] and a valid mask of about 70 % ones; ``nt`` trinocular
    rows' negative disparity in [-64, 0], confidence in [0, 1] and clean
    triplet in [0, 255]."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=gen.device).to(device)

    batch = {"im1_forward": 255 * rand(nb + nt, H, W, 3),
             "im2_forward": 255 * rand(nb + nt, H, W, 3), "bi": {}, "tri": {}}
    if nb:
        batch["bi"] = {"flow": -64 * rand(nb, H, W), "valid": (rand(nb, H, W) < 0.7).float()}
    if nt:
        batch["tri"] = {"flow": -64 * rand(nt, H, W), "conf": rand(nt, H, W),
                        **{k: 255 * rand(nt, H, W, 3) for k in ("im0", "im1", "im2")}}
    return batch


def phase_ns_parity(torch, ns_cfg):
    """Phase 36: one NS step of ns.json (nb = nt = 1, 1x64x128 a modality,
    2 iterations, fp32, TF32 off) with K1 on the card vs the plain path on
    the CPU, from the same weights and batch: exactly 2 K1 and 2
    K1-backward launches. The floor is the same step with the plain lookup
    on the card vs the CPU. Bounds, the DKT step's: the losses 1e-3
    relative; the gradients 0.1 relative L2 per module and 0.05 over all,
    or twice the floor where that is larger."""
    import dkt_stereo_tpu_torch.models.raft_stereo as raft
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup, corr_lookup_plain
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state
    from dkt_stereo_tpu_torch.train.ns_step import make_ns_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**ns_cfg, "mixed_precision": False, "corr_dtype": "float32"}
    hyper = DKTHyperParams(train_iters=2)
    seed_state = create_dkt_state(cfg, hyper, seed=0, device="cuda")
    params = {k: v.detach().clone() for k, v in seed_state.student.state_dict().items()}
    del seed_state
    batch = _ns_batch(torch, torch.Generator().manual_seed(36), 1, 1, 64, 128, "cpu")
    on_card = _nested(batch, lambda t: t.cuda())
    step = make_ns_train_step(cfg, hyper, nb=1, nt=1)

    gpu = create_dkt_state(cfg, hyper, params=params, device="cuda")
    zero_counts()
    gpu, m_gpu = step(gpu, on_card)
    torch.cuda.synchronize()
    launches = kernel_counts()
    raft.corr_lookup = (lambda pyr, c, r, dt:  # the plain lookup on the card, for the floor
                        corr_lookup_plain(pyr, c, r).permute(0, 3, 1, 2).to(dt))
    try:
        plain, m_plain = step(create_dkt_state(cfg, hyper, params=params, device="cuda"),
                              on_card)
    finally:
        raft.corr_lookup = corr_lookup
    cpu, m_cpu = step(create_dkt_state(cfg, hyper, params={k: v.cpu() for k, v in
                                                           params.items()}, device="cpu"),
                      batch)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    check(m_gpu["ok"] == m_plain["ok"] == m_cpu["ok"] == 1.0,
          f"NS parity ok: card {m_gpu['ok']} plain {m_plain['ok']} cpu {m_cpu['ok']}")
    want = {**dict.fromkeys(launches, 0), "corr_lookup": 2, "corr_lookup_bwd": 2}
    check(launches == want, f"NS parity launches {launches} != {want}")
    losses = ("loss", "ns_loss", "bi_epe", "epe")

    def loss_rel(a, b):
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in losses}

    err, floor_l = loss_rel(m_gpu, m_cpu), loss_rel(m_plain, m_cpu)
    want_grads = dict(cpu.student.named_parameters())
    rel = _grad_rel(gpu.student.named_parameters(), want_grads)
    floor = _grad_rel(plain.student.named_parameters(), want_grads)
    for k in losses:
        tol = max(1e-3, 2 * floor_l[k])
        check(err[k] <= tol, f"NS parity {k}: relative {err[k]} > {tol}")
    for g, e in rel.items():
        tol = max(0.05 if g == "all" else 0.1, 2 * floor[g])
        check(e <= tol, f"NS parity gradient of {g}: relative {e} > {tol}")
    print("NS step parity (ns.json, fp32, TF32 off, nb = nt = 1 at 64x128, 2 iters), K1 on "
          "the card vs plain on the CPU: " + " ".join(
              f"{k} {m_gpu[k]:.6f} vs {m_cpu[k]:.6f} (rel {err[k]:.2e}, floor "
              f"{floor_l[k]:.2e})" for k in losses) + " (tol 1e-3) | gradient relative L2 "
          "error by module " + " ".join(f"{g} {e:.2e}" for g, e in rel.items())
          + " (tol 0.1 per module, 0.05 all; floor, the plain lookup on the card vs the CPU: "
          + " ".join(f"{g} {e:.2e}" for g, e in floor.items()) + f") | launches {launches}",
          flush=True)
    del gpu, plain, cpu
    torch.cuda.empty_cache()


def _ns_loss_alone(torch, gen, B, H, W, iters):
    """ns_loss's forward and backward alone at the step's shapes (``iters``
    predictions of B x H x W): device ms from CUDA events (mean of 3 after a
    warm-up), and the kernels of one call from a profile."""
    from dkt_stereo_tpu_torch.losses.nerf import ns_loss

    tri = _ns_batch(torch, gen, 0, B, H, W, "cuda")["tri"]
    preds = (-64 * torch.rand(iters, B, H, W, generator=gen, device="cuda")).requires_grad_()

    def once():
        loss = ns_loss(preds, tri["flow"], tri["conf"], tri["im0"], tri["im1"], tri["im2"])[0]
        loss.backward()

    once()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        once()
    end.record()
    torch.cuda.synchronize()

    def profiled():
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    _, busy, lines, buckets = device_profile(torch, profiled, "chip_smoke_ns_loss_profile.txt")
    launches = sum(int(line.split(" ms ")[1].split("x")[0]) for line in lines)
    return start.elapsed_time(end) / 3, busy, launches, buckets


def phase_ns_train(torch, ns_cfg, card):
    """Phase 37: ns.json as shipped (bf16, reg, 3 GRU layers of 128, 4
    levels of radius 4, no remat) in the NS step at B=8, 320x720, 16
    iterations: all 8 rows trinocular, then nb = nt = 4; 1 warm-up and
    TRAIN_STEPS timed steps each, with the device ms of each part (CUDA
    events), peak memory and exactly 16 K1 and 16 K1-backward launches a
    step; the student moves, batch norm and the teacher stay; a profile of
    one all-trinocular step; ns_loss's forward and backward alone at the
    step's shapes. A step that does not fit the card is reported and the
    split is measured with remat_iters (32 K1 a step then)."""
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state
    from dkt_stereo_tpu_torch.train.ns_step import make_ns_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    B, H, W = TRAIN_IMAGE
    hyper = DKTHyperParams(train_iters=16)
    gen = torch.Generator(device="cuda").manual_seed(37)
    paths = {}
    for nb, nt in NS_SPLITS:
        label = f"NS step nb={nb} nt={nt}"
        for cfg in (ns_cfg, {**ns_cfg, "remat_iters": True}):
            state = create_dkt_state(cfg, hyper, seed=0)
            before = snapshot(state, "ns.json's cnet")
            step = make_ns_train_step(cfg, hyper, nb=nb, nt=nt)
            make = (lambda nb=nb, nt=nt: _ns_batch(torch, gen, nb, nt, H, W, "cuda"))
            try:
                state, run = timed_steps(torch, state, step, gen, (B, H, W), label,
                                         make_batch=make, parts=NS_PARTS, step_kw={})
                break
            except torch.cuda.OutOfMemoryError as e:
                check(not cfg.get("remat_iters"), f"{label} with remat_iters: {e}")
                print(f"{label} does not fit the card without remat_iters ({e}); measuring "
                      "it with remat_iters", flush=True)
                del state, step
                torch.cuda.empty_cache()
        fwd = 16 * (2 if cfg.get("remat_iters") else 1)
        want = {**dict.fromkeys(run["launches"], 0), "corr_lookup": fwd, "corr_lookup_bwd": 16}
        check(all(c == want for c in run["per_step"]),
              f"{label} launches a step {run['per_step']} != {want}")
        check_moved_and_frozen(torch, state, before, label)
        m = run["metrics"][-1]
        print(f"{label} (ns.json, bf16, reg, remat {bool(cfg.get('remat_iters'))}, B={B} "
              f"{H}x{W}, {hyper.train_iters} iters, {TRAIN_STEPS} steps after 1 warm-up): "
              f"{step_line(run)} | ns_loss {m.get('ns_loss', float('nan')):.4f} | lr "
              f"{m['learning_rate']:.3e} | {card}", flush=True)
        paths["ns_training" if nb == 0 else "ns_mixed_training"] = run["launches"]
        if nb == 0:
            profile_step(torch, state, step, gen, (B, H, W), run["ms"].mean(),
                         "chip_smoke_ns_train_profile.txt", "NS (all trinocular)",
                         make_batch=make, step_kw={})
            loss_ms, loss_busy, loss_launches, loss_buckets = _ns_loss_alone(
                torch, gen, B, H, W, hyper.train_iters)
            print(f"ns_loss alone (16 x {B}x{H}x{W} predictions, forward and backward): "
                  f"{loss_ms:.2f} ms of device time (CUDA events, mean of 3), "
                  f"{loss_launches} kernels, {loss_busy:.2f} ms of them in the profile; "
                  f"{loss_ms / run['ms'].mean():.3f} of the step's mean ms; by bucket: "
                  f"{loss_buckets} | {card}", flush=True)
        del state, step
        torch.cuda.empty_cache()
    return paths


def write_ns_tree(root, rng):
    """Under ``root``: a NeRF-Stereo tree of NS_TRIPLETS triplets at
    Scene Flow's 540x960 (``core/stereo_datasets.py:374-401``'s layout):
    textured views, the left and right ones displaced by a smooth disparity,
    16-bit disparity (x 64) and confidence (x 65536) maps written by
    ``data/png.py``, and ``trainingQ.txt``. Returns the seconds it took."""
    from dkt_stereo_tpu_torch.data import png

    t0 = time.perf_counter()
    H, W = SCENEFLOW_IMAGE
    yy, xx = np.mgrid[:H, :W]
    base = Path(root) / "nerf-stereo"
    lines = []
    for s in range(NS_TRIPLETS):
        d = base / "training_set" / f"scene{s}"
        d.mkdir(parents=True)
        disp = (12 + 50 * xx / W + 6 * np.sin(yy / 50 + s)).astype(np.float32)
        left, center = _textured_pair(rng, H, W, disp)
        _, right = _textured_pair(rng, H, W, 2 * disp)
        for name, img in (("im0", left), ("im1", center), ("im2", right)):
            png.write(d / f"{name}.png", img)
        png.write(d / "disp.png", np.rint(disp * 64).astype(np.uint16))
        conf = np.clip(0.3 + 0.7 * rng.random((H, W)), 0, 65535 / 65536)
        png.write(d / "conf.png", np.rint(conf * 65536).astype(np.uint16))
        lines.append(" ".join(f"scene{s}/{n}.png" for n in ("im0", "im1", "im2", "disp",
                                                          "conf")))
    (base / "trainingQ.txt").write_text("\n".join(lines) + "\n")
    return time.perf_counter() - t0


def phase_ns_cli(torch, train_data, card):
    """Phase 38: ns.json as shipped through cli.train (batch 8, 320x720, 16
    iterations, 4 loader workers, 3 steps from a seeded random .pth): on a
    synthetic NeRF-Stereo tree alone (--train_datasets nerf_stereo), then
    mixed with phase 33's Scene Flow tree at --ns_num_tri 4. Every step ok
    with exactly 16 K1 and 16 K1-backward launches, a finite logged loss,
    the CLI's timing line and a checkpoint at step_3; and the host seconds a
    triplet takes to read and to augment on one worker."""
    from dkt_stereo_tpu_torch.cli.config import load_model_config
    from dkt_stereo_tpu_torch.data.datasets import fetch_dataset

    write_s = write_ns_tree(train_data, np.random.default_rng(38))
    read_s, aug_s = _host_seconds(fetch_dataset(["nerf_stereo"], (320, 720),
                                                data_root=str(train_data)), HOST_SAMPLES)
    print(f"NeRF-Stereo tree: {NS_TRIPLETS} triplets at {SCENEFLOW_IMAGE[0]}x"
          f"{SCENEFLOW_IMAGE[1]}, 16-bit disparity and confidence, written in {write_s:.1f} s "
          f"| a triplet on one worker, median of {HOST_SAMPLES}: read {read_s:.3f} s, augment "
          f"to 320x720 {aug_s:.3f} s ({os.cpu_count()} CPUs)", flush=True)
    pth = seeded_pth(torch, load_model_config(str(NS_CONFIG)), Path(train_data).parent /
                     "ns_train.pth")
    want = {"corr_lookup": 16, "corr_lookup_bwd": 16}
    paths = {}
    for name, datasets in (("ns", ["nerf_stereo"]),
                           ("ns_mixed", ["nerf_stereo", "sceneflow", "--ns_num_tri", "4"])):
        argv = ["--config", str(NS_CONFIG), "--train_datasets", *datasets, "--data_root",
                str(train_data), "--batch_size", "8", "--image_size", "320", "720",
                "--num_workers", TRAIN_WORKERS, "--num_steps", NS_CLI_STEPS,
                "--validation_frequency", "100000", "--save_dir",
                str(Path(train_data).parent / f"run_{name}"), "--restore_ckpt", pth]
        res, probe, launches = _in_process(
            torch, argv, f"{name} through cli.train (configs/raft_stereo/ns.json, "
            f"{' '.join(datasets)})", want, card, factory="make_ns_train_step")
        check(res["checkpoint"].endswith(f"step_{int(NS_CLI_STEPS) + 1}"),
              f"{name} ended at {res['checkpoint']}")
        check(all("ns_loss" in m for m in probe.metrics), f"{name}: no ns_loss metric")
        paths[f"train_cli_{name}"] = launches
    return paths



# --- item 11: the profiler, banded evaluation, multi-process training (39-42) ----------

PROFILE_TOP = 15
BAND_COUNTS = (1, 2, 4)  # phase 40's sequential bands
BAND_HALO = 64
EXACT_HALO = 128  # phase 41's halo: JAX's for the shipped 3-GRU config
IGEV_BAND_IMAGE = (736, 1280)
RANK_TIMEOUT = 600  # seconds a group of ranks may take


def _trace_window(path):
    """From a ``cli.train`` trace: its ProfilerStep ranges, the kernel
    events and the device's busy share of the window (the union of its
    kernels', copies' and sets' intervals over the window's span)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    steps = [e for e in events if str(e.get("name", "")).startswith("ProfilerStep#")
             and not str(e.get("cat", "")).startswith("gpu_")]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not steps:
        return steps, device, float("nan"), 0.0
    t0 = min(e["ts"] for e in steps)
    t1 = max(e["ts"] + e["dur"] for e in steps)
    busy, end = 0.0, t0
    for s, d in sorted((e["ts"], e["dur"]) for e in device):
        s, f = max(s, end), min(s + d, t1)
        if f > s:
            busy += f - s
            end = f
    return steps, device, busy / (t1 - t0), (t1 - t0) / 1e3


def phase_profiled_train(torch, train_data, card):
    """Phase 39: train.json through cli.train at the recipe's 8x320x720 on
    the Scene Flow tree, 4 loader workers, 4 steps, --profile_start 1
    --profile_steps 2: the trace holds exactly 2 ProfilerStep ranges, 2 x 96
    K1 forward and 2 x 16 K1 backward kernels; the window's device-busy
    share, the top device operations by time (also in
    chiprun_out/chip_smoke_cli_train_trace_top.txt) and the step's own host
    time inside the window and after it."""
    import re

    trace_dir = Path(train_data).parent / "trace"
    argv = ["--config", str(ROOT / "configs/raft_stereo/train.json"), "--train_datasets",
            "sceneflow", "--data_root", str(train_data), "--batch_size", "8", "--image_size",
            "320", "720", "--num_workers", TRAIN_WORKERS, "--num_steps", "3",
            "--validation_frequency", "100000", "--save_dir",
            str(Path(train_data).parent / "run_profiled"), "--profile_dir", str(trace_dir),
            "--profile_start", "1", "--profile_steps", "2"]
    res, probe, launches = _in_process(
        torch, argv, "profiled cli.train (train.json, Scene Flow, 8x320x720, steps 1-2 traced)",
        {"corr_lookup": 96, "corr_lookup_bwd": 16}, card)
    check(res["trace"] is not None and Path(res["trace"]).exists(), f"no trace: {res['trace']}")
    steps, device, busy, span_ms = _trace_window(res["trace"])
    names = sorted(e["name"] for e in steps)
    check(names == ["ProfilerStep#1", "ProfilerStep#2"], f"trace steps {names}")
    k1 = sum(1 for e in device if e.get("cat") == "kernel"
             and re.search(r"corr_lookup_kernel", e["name"]))
    k1b = sum(1 for e in device if e.get("cat") == "kernel"
              and re.search(r"corr_lookup_bwd_kernel", e["name"]))
    check((k1, k1b) == (2 * 96, 2 * 16), f"trace K1 kernels {k1} fwd, {k1b} bwd != 192, 32")
    by_name = {}
    for e in device:
        t, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"] / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    lines = [f"{t:9.3f} ms {n:6d}x  {name}" for name, (t, n) in ranked]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_cli_train_trace_top.txt").write_text("\n".join(lines) + "\n")
    own = 1e3 * np.asarray(res["step_seconds"])
    size_mb = Path(res["trace"]).stat().st_size / 1e6
    print(f"profiled cli.train window: {len(steps)} ProfilerStep ranges {names}, K1 kernels "
          f"{k1} fwd / {k1b} bwd (2 x 96 / 2 x 16), window {span_ms:.1f} ms, device busy share "
          f"{busy:.3f} (idle {1 - busy:.3f}), {sum(n for _, n in by_name.values())} device "
          f"ops, trace {size_mb:.1f} MB | the step's own host ms: warm-up {own[0]:.1f}, traced "
          f"{own[1]:.1f} {own[2]:.1f}, untraced {own[3]:.1f} (profiler overhead "
          f"{np.mean(own[1:3]) / own[3] - 1:+.1%}) | by bucket: {bucket_line(by_name)} | "
          f"{card}; top {PROFILE_TOP} device ops:", flush=True)
    for line in lines[:PROFILE_TOP]:
        print("  " + line[:160])
    shutil.rmtree(trace_dir, ignore_errors=True)
    return {"profiled_training": launches}


def phase_banded(torch, alt_cfg, card):
    """Phase 40: sequential banded evaluation (eval/tiled.py::banded_forward)
    of alt_pallas.json at 1x1984x2880, fp32 (the eval protocol), 32
    iterations, halo 64. One band hands the model the unbanded eval's
    padded frame bit for bit; its output is reported against the unbanded
    frame beside the unbanded frame's own run-to-run difference (K2's
    statistics are fp32 atomics, and random-weight RAFT amplifies that over
    32 iterations). 2 and 4 bands with ms/frame, peak memory, launches (32
    K3 and 4 K2 a band) and their difference from the unbanded frame,
    which is approximate by design (no cross-band statistics)."""
    from dkt_stereo_tpu_torch.eval.tiled import banded_forward
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.ops.pad import pad_input

    iters = 32
    H, W = ALT_IMAGE
    model_forward = make_forward_fn(create_model({**alt_cfg, "mixed_precision": False},
                                                 iters=iters, seed=0))
    seen = []

    def forward(x1, x2):
        seen.append((x1, x2))
        return model_forward(x1, x2)

    forward.device = model_forward.device
    rng = np.random.default_rng(40)
    img1, img2 = (rng.uniform(0, 255, (H, W, 3)).astype(np.float32) for _ in range(2))

    def run(fn):
        fn()  # warm-up at this band shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        return out, 1e3 * dt, torch.cuda.max_memory_allocated() / 2**30, kernel_counts()

    full, full_ms, full_peak, full_counts = run(lambda: _run_one(forward, img1, img2)[0])
    want = {**dict.fromkeys(full_counts, 0), "corr_lookup_alt": iters, "encoder_stage": 4}
    check(full_counts == want, f"unbanded fp32 launches {full_counts} != {want}")
    check(bool(np.isfinite(full).all()), "unbanded fp32 frame not finite")
    floor = np.abs(_run_one(forward, img1, img2)[0] - full)
    rows = [f"unbanded {full_ms:.1f} ms, peak {full_peak:.2f} GiB, run to run |d| max "
            f"{floor.max():.4g} mean {floor.mean():.4g} px"]
    launches = {}
    for n in BAND_COUNTS:
        seen.clear()
        disp, ms, peak, counts = run(lambda: banded_forward(forward, img1, img2, n_bands=n,
                                                            halo=BAND_HALO))
        want = {**dict.fromkeys(counts, 0), "corr_lookup_alt": iters * n, "encoder_stage": 4 * n}
        check(counts == want, f"{n} bands: launches {counts} != {want}")
        check(disp.shape == (H, W) and bool(np.isfinite(disp).all()), f"{n} bands: bad output")
        err = np.abs(disp - full)
        if n == 1:
            for x, img in zip(seen[-1], (img1, img2)):
                padded, _ = pad_input(torch.as_tensor(img, device="cuda")[None], 32, "sintel")
                check(torch.equal(x, padded), "one band is not the unbanded eval's padded frame")
        launches[f"banded_{n}_alt_inference"] = counts
        rows.append(f"{n} band{'s' if n > 1 else ''}: {ms:.1f} ms, peak {peak:.2f} GiB "
                    f"({peak / full_peak:.2f}x), K3 {counts['corr_lookup_alt']} K2 "
                    f"{counts['encoder_stage']}, |d| vs unbanded max {err.max():.4g} mean "
                    f"{err.mean():.4g} px")
    print(f"sequential banded eval (alt_pallas.json, fp32, 1x{H}x{W}, {iters} iters, halo "
          f"{BAND_HALO}; one warm-up at each band shape; one band is the unbanded padded "
          f"frame bit for bit): " + " | ".join(rows) + f" | {card}", flush=True)
    del forward, model_forward, seen
    torch.cuda.empty_cache()
    return launches


def _damped(model, damp):
    """Scale the parameters whose name holds ``damp[0]`` by ``damp[1]``."""
    import torch

    if damp:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if damp[0] in name:
                    p.mul_(damp[1])
    return model


def _frame(seed, H, W):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (H, W, 3)).astype(np.float32) for _ in range(2)]


def _exact_case(torch, case):
    """One exact-banding case on this rank: ``reps`` frames after one
    warm-up, their host ms, this process's peak memory and its launches
    a frame."""
    from dkt_stereo_tpu_torch.eval.tiled import banded_forward_exact
    from dkt_stereo_tpu_torch.models.registry import create_model

    model = _damped(create_model(case["config"], iters=case["iters"], seed=0),
                    case.get("damp"))
    img1, img2 = _frame(case["seed"], *case["image"])
    disp = banded_forward_exact(model, img1, img2, halo=case["halo"])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for _ in range(case["reps"]):
        t0 = time.perf_counter()
        disp = banded_forward_exact(model, img1, img2, halo=case["halo"])
        times.append(1e3 * (time.perf_counter() - t0))
    counts = {k: v // case["reps"] for k, v in kernel_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    torch.cuda.empty_cache()
    return disp, times, peak, counts


def _dp_step(torch, kind, cfg, batch_seed, rank, size):
    """One data-parallel step (the DKT step of ``cfg`` or the NS step) on
    this rank's rows of a seeded global batch, from the state of seed 0:
    metrics, the student's gradients (CPU), a digest of its weights and
    the launches."""
    import hashlib

    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.ns_step import make_ns_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    hyper = DKTHyperParams(train_iters=2, teacher_iters=2)
    state = create_dkt_state(cfg, hyper, seed=0, device="cuda")
    zero_counts()
    if kind == "dkt":
        batch = _dp_batch(torch, batch_seed)
        local = {k: v.chunk(size)[rank].contiguous().cuda() for k, v in batch.items()}
        state, m = make_dkt_train_step(cfg, hyper)(
            state, local, generator=torch.Generator().manual_seed(11))
    else:
        blocks = _dp_ns_blocks(torch, batch_seed, size)
        state, m = make_ns_train_step(cfg, hyper, nb=2, nt=2)(
            state, _nested(blocks[rank], lambda t: t.cuda()))
    torch.cuda.synchronize()
    counts = kernel_counts()
    digest = hashlib.sha256()
    for v in state.student.state_dict().values():
        digest.update(v.detach().cpu().numpy().tobytes())
    grads = {k: p.grad.detach().cpu() for k, p in state.student.named_parameters()
             if p.grad is not None}
    return m, grads, digest.hexdigest(), counts


def _dp_batch(torch, seed, B=2, H=64, W=128):
    """The global DKT batch of phase 42(a), on the CPU: rank 1's row has no
    valid pixel in its top half, so the ranks' valid counts differ."""
    gen = torch.Generator().manual_seed(seed)
    b = _train_batch(torch, gen, B, H, W, "cpu")
    b["valid"][1, :H // 2] = 0
    return b


def _dp_ns_blocks(torch, seed, size, H=64, W=128):
    """The global NS batch of nb = nt = 2 on the CPU as ``size`` host blocks
    (each: its binocular rows, then its trinocular rows; one block is one
    process's layout), rank 1's binocular valid half zeros."""
    batch = _ns_batch(torch, torch.Generator().manual_seed(seed), 2, 2, H, W, "cpu")
    batch["bi"]["valid"][1, :H // 2] = 0
    nb_l = nt_l = 2 // size
    blocks = []
    for r in range(size):
        rows = list(range(r * nb_l, (r + 1) * nb_l)) + [2 + i for i in range(r * nt_l,
                                                                             (r + 1) * nt_l)]
        blocks.append({"im1_forward": batch["im1_forward"][rows],
                       "im2_forward": batch["im2_forward"][rows],
                       "bi": {k: v[r * nb_l:(r + 1) * nb_l] for k, v in batch["bi"].items()},
                       "tri": {k: v[r * nt_l:(r + 1) * nt_l] for k, v in batch["tri"].items()}})
    return blocks


def _rank_jobs(rank, jobs):
    """A rank of phases 41 and 42(a), on cuda:0 beside the other rank (gloo
    runs all_reduce on CUDA tensors; NCCL refuses two ranks on one device):
    fp32 with TF32 off; every job's result in order."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for kind, arg in jobs:
        if kind == "exact":
            out.append(_exact_case(torch, arg))
        else:
            out.append(_dp_step(torch, kind, arg[0], arg[1], rank, dist.get_world_size()))
    return out


def _unbanded(torch, case):
    """The unbanded frame of an exact-banding case, in this process."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    model = _damped(create_model(case["config"], iters=case["iters"], seed=0), case.get("damp"))
    forward = make_forward_fn(model)
    disp, _ = _run_one(forward, *_frame(case["seed"], *case["image"]))
    del model, forward
    torch.cuda.empty_cache()
    return disp


def phase_exact_and_dp(torch, alt_cfg, igev_cfg, train_cfg, ns_cfg, card):
    """Phases 41 and 42(a) in one group of two ranks sharing cuda:0 over
    gloo (parallel/mesh.py::run_ranks), fp32 with TF32 off.

    41: banded_forward_exact of alt_pallas.json with pallas_encoder off at
    1x1984x2880, halo 128: at 2 iterations with the flow head damped by 0.02
    (the JAX test's protocol, tests/test_parallel.py:276-330) within max
    1e-3 and mean 1e-4 px of the unbanded frame; at 32 iterations ms/frame,
    each rank's peak memory and 32 K3 a band; IGEV pallas.json at
    1x736x1280, 2 iterations, halo 64, its disparity head scaled by 0.05
    (as phase 12): max < 0.02 x scale + 1 px (JAX's bound; the 3-D
    hourglass exchanges no halo), K4 2 a band.

    42(a): one DKT step (train.json, 1x64x128 a rank, 2 + 2 iterations) and
    one NS step (ns.json, nb = nt = 2 global), rank 1's valid half zeros,
    against the one-process step on the global batch on the card: losses
    within 1e-3 relative, gradients within 0.1 relative L2 a module and
    0.05 over all (phase 8's bounds); both ranks' weights bit-identical."""
    from dkt_stereo_tpu_torch.parallel.mesh import run_ranks

    H, W = ALT_IMAGE
    exact_cfg = {**alt_cfg, "pallas_encoder": False, "mixed_precision": False}
    cases = {
        "raft_2it": dict(config=exact_cfg, iters=2, seed=41, image=(H, W), halo=EXACT_HALO,
                         damp=("flow_head", 0.02), reps=1),
        "raft_32it": dict(config=exact_cfg, iters=32, seed=41, image=(H, W), halo=EXACT_HALO,
                          reps=2),
        "igev": dict(config={**igev_cfg, "mixed_precision": False}, iters=2, seed=42,
                     image=IGEV_BAND_IMAGE, halo=BAND_HALO,
                     damp=("update_block.disp_head.conv2.weight", 0.05), reps=1),
    }
    fp32 = lambda c: {**c, "mixed_precision": False, "corr_dtype": "float32"}  # noqa: E731
    jobs = [("exact", c) for c in cases.values()] + [
        ("dkt", (fp32(train_cfg), 420)), ("ns", (fp32(ns_cfg), 421))]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(_rank_jobs, 2, jobs, backend="gloo", timeout=RANK_TIMEOUT)
    ranks_s = time.perf_counter() - t0

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    paths = {}
    try:
        for i, (name, case) in enumerate(cases.items()):
            (d0, t0_, p0, c0), (d1, t1_, p1, c1) = ranks[0][i], ranks[1][i]
            check(np.array_equal(d0, d1), f"{name}: the ranks assembled different frames")
            iters = case["iters"]
            kernel = "geo_lookup" if name == "igev" else "corr_lookup_alt"
            want = {**dict.fromkeys(c0, 0), kernel: iters}
            check(c0 == c1 == want, f"{name}: launches a band {c0} / {c1} != {want}")
            paths[f"exact_banded_{name}"] = {k: c0[k] + c1[k] for k in c0}
            line = (f"exact banded {name} (2 ranks on cuda:0 over gloo, fp32, TF32 off, "
                    f"1x{case['image'][0]}x{case['image'][1]}, {iters} iters, halo "
                    f"{case['halo']}): ms/frame {' '.join(f'{t:.1f}' for t in t0_)} (rank 0) "
                    f"{' '.join(f'{t:.1f}' for t in t1_)} (rank 1) | peak rank 0 {p0:.2f} "
                    f"rank 1 {p1:.2f} GiB | {kernel} a band {c0[kernel]}")
            if name != "raft_32it":
                full = _unbanded(torch, case)
                err, scale = np.abs(d0 - full), float(np.abs(full).max())
                if name == "igev":
                    mid = err[case["image"][0] // 2 - 4:case["image"][0] // 2 + 4].max()
                    check(err.max() < 0.02 * scale + 1.0,
                          f"igev banded max {err.max()} >= 0.02 x {scale} + 1")
                    line += (f" | vs unbanded max {err.max():.4g} mean {err.mean():.4g} px on "
                             f"a {scale:.1f} px scale (bound {0.02 * scale + 1:.3f}), at the "
                             f"boundary {mid:.4g}, top rows {err[:32].max():.4g}")
                else:
                    check(err.max() <= 1e-3 and err.mean() <= 1e-4,
                          f"exact banded RAFT max {err.max()} mean {err.mean()} px")
                    # where the worst pixel lies against the bands' boundary
                    # (the padded frame's row 992 at 1984 rows, two bands)
                    row = int(np.unravel_index(err.argmax(), err.shape)[0])
                    edge = -(-H // 64) * 32
                    far = np.abs(np.arange(H) - edge) > case["halo"]
                    line += (f" | vs unbanded max {err.max():.4g} mean {err.mean():.4g} px "
                             f"(bound 1e-3 / 1e-4) on a {scale:.3f} px scale, worst at row "
                             f"{row} (boundary {edge}), beyond the halo of the boundary max "
                             f"{err[far].max():.4g}")
            print(line + f" | {card}", flush=True)

        for j, kind in enumerate(("dkt", "ns"), start=len(cases)):
            (m0, g0, h0, c0), (m1, g1, h1, c1) = ranks[0][j], ranks[1][j]
            check(h0 == h1, f"{kind}: the ranks' weights differ after the step")
            check(m0 == m1, f"{kind}: the ranks' metrics differ {m0} / {m1}")
            m, grads, _, counts = _dp_step(torch, kind, jobs[j][1][0], jobs[j][1][1], 0, 1)
            check(m0["ok"] == m["ok"] == 1.0, f"{kind}: ok {m0['ok']} / {m['ok']}")
            keys = ("loss", "loss_GT", "loss_PL") if kind == "dkt" else ("loss", "ns_loss")
            loss_err = {k: abs(m0[k] - m[k]) / max(abs(m[k]), 1e-12) for k in keys}
            check(all(e <= 1e-3 for e in loss_err.values()), f"{kind} losses {loss_err}")
            rel = _grad_rel([(k, _Grad(v)) for k, v in g0.items()],
                            {k: _Grad(v) for k, v in grads.items()})
            for g, e in rel.items():
                check(e <= (0.05 if g == "all" else 0.1), f"{kind} gradient of {g}: {e}")
            # DKT: teachers 2 + 2, student 2, its remat recompute 2; NS: 2 (no
            # remat); 2 backward either way
            want = {**dict.fromkeys(c0, 0), "corr_lookup": 8 if kind == "dkt" else 2,
                    "corr_lookup_bwd": 2}
            check(c0 == c1 == want, f"{kind} launches a rank {c0} / {c1} != {want}")
            paths[f"dp_{kind}_step"] = {k: c0[k] + c1[k] for k in c0}
            print(f"data-parallel {kind} step (2 ranks on cuda:0 over gloo, fp32, TF32 off, "
                  f"1x64x128 a rank, rank 1's valid half zeros) vs one process on the global "
                  f"batch: losses relative " + " ".join(f"{k} {e:.2e}" for k, e in
                                                      loss_err.items())
                  + " (tol 1e-3) | gradient relative L2 by module "
                  + " ".join(f"{g} {e:.2e}" for g, e in rel.items())
                  + f" (tol 0.1, 0.05 all) | weights bit-identical on both ranks | launches a "
                  f"rank {c0} | {card}", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    print(f"phases 41 and 42(a) ranks: {ranks_s:.1f} s (two processes, start-up included)",
          flush=True)
    # cli.eval --spatial_bands N wants N devices, one a rank; this card has one
    from dkt_stereo_tpu_torch.parallel.mesh import make_mesh

    try:
        make_mesh(torch.cuda.device_count() + 1)
        check(False, "make_mesh accepted more ranks than devices")
    except ValueError as e:
        print(f"cli.eval --spatial_bands {torch.cuda.device_count() + 1} on this machine: "
              f"refused ({e})", flush=True)
    return paths


class _Grad:
    """A gradient held as a parameter's ``.grad`` for ``_grad_rel``."""

    def __init__(self, grad):
        self.grad = grad


def phase_dp_world_of_one(torch, train_cfg, card, unfused_ms, tmp):
    """Phase 42(b): train.json at full width (8x320x720, 16/32 iterations,
    bf16) in a process group of one over NCCL, so that the step's
    collectives run (the gradients' all_reduce, ok and the loss values, the
    losses' counts): 1 warm-up and 3 timed steps, 96 K1 and 16 K1 backward a
    step, beside phase 9's one-process step; then the state broadcast from
    rank 0 (cli.train's replicate), bit-identical."""
    import torch.distributed as dist

    from dkt_stereo_tpu_torch.parallel.mesh import replicate
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    dist.init_process_group("nccl", init_method=f"file://{tmp / 'world_of_one'}", world_size=1,
                            rank=0)
    try:
        hyper = DKTHyperParams(train_iters=16, teacher_iters=32)
        state = create_dkt_state(train_cfg, hyper, seed=0)
        step = make_dkt_train_step(train_cfg, hyper)
        gen = torch.Generator(device="cuda").manual_seed(6)
        state, run = timed_steps(torch, state, step, gen, TRAIN_IMAGE, "RAFT (world of one)",
                                 steps=3)
        want = {**dict.fromkeys(run["launches"], 0), "corr_lookup": 96, "corr_lookup_bwd": 16}
        check(all(c == want for c in run["per_step"]),
              f"world-of-one launches a step {run['per_step']} != {want}")
        # cli.train's broadcast of the state from rank 0 over NCCL, the
        # optimizer's CPU step counts through the card: a no-op for one rank
        before = _state_to_cpu(torch, state)
        t0 = time.perf_counter()
        replicate(state.student, state.ema, state.teacher, state.optimizer)
        torch.cuda.synchronize()
        replicate_ms = 1e3 * (time.perf_counter() - t0)
        _equal_tree(torch, _state_to_cpu(torch, state), before, "replicated state")
        print(f"training path in a process group of one over NCCL (train.json, bf16, B=8 "
              f"320x720, 16/32 iters, 3 steps after 1 warm-up): {step_line(run)} | phase 9's "
              f"one-process mean {unfused_ms:.2f} ms/step, this {run['ms'].mean():.2f} "
              f"({run['ms'].mean() / unfused_ms - 1:+.1%}) | replicate of the state "
              f"{replicate_ms:.1f} ms, bit-identical | {card}", flush=True)
        launches = run["launches"]
        del state, step
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"world_of_one_training": launches}


# --- phases 43-45: RAFT's remaining options, batched teachers, ptrans ----

OPTION_CASES = (
    ("cosine", {"corr_implementation": "cosine"}),
    ("mix_fmap_image", {"corr_implementation": "mix_fmap_image"}),
    ("interpolate_reg_cuda", {"backbone_type": "interpolate", "corr_implementation": "reg_cuda"}),
    ("interpolate_alt_cuda", {"backbone_type": "interpolate", "corr_implementation": "alt_cuda"}),
    ("shared_backbone", {"shared_backbone": True}),
    ("fast_in_stats", {"fast_in_stats": True}),
)
# the options timed at full width, full depth, and their frames
OPTION_TIMED = (("cosine", MAIN_FRAMES), ("interpolate_alt_cuda", MAIN_FRAMES),
                ("fast_in_stats", 5))


def _option_launches(model, iters):
    """The launches a test-mode frame of ``model`` must make: the lookup
    (K3 for alt_cuda, else K1) every iteration, and K2's four stages where
    the fnet runs fused."""
    cfg = model.cfg
    lookup = "corr_lookup_alt" if cfg.corr_implementation == "alt_cuda" else "corr_lookup"
    fused = hasattr(model, "fnet") and cfg.pallas_encoder
    return {**dict.fromkeys(kernel_counts(), 0), lookup: iters, "encoder_stage": 4 * fused}


def phase_options(torch, config, card):
    """Phase 43: RAFT's options in test mode on pallas.json ({**pallas.json,
    option} in memory). Parity of each, kernels on the card vs the plain path
    on the CPU, fp32, TF32 off, 1x256x512, 2 iterations, with its exact
    launches; K1 on a cosine pyramid and K3 at D = 3 vs their plain twins at
    the 1/4 grid of 736x1280; then cosine, interpolate + alt_cuda and
    fast_in_stats at 1x736x1280, 32 iterations, bf16, timed with exact
    launch counts."""
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.ops.corr import corr_pyramid_fused, fmap_pyramid
    from dkt_stereo_tpu_torch.ops.cuda.corr_alt import corr_lookup_alt, corr_lookup_alt_plain
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup, corr_lookup_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    iters = 2
    rng = np.random.default_rng(43)
    img1, img2 = (rng.uniform(0, 255, (256, 512, 3)).astype(np.float32) for _ in range(2))
    rows = []
    for name, override in OPTION_CASES:
        cfg = {**config, **override, "mixed_precision": False, "corr_dtype": "float32"}
        gpu = create_model(cfg, iters=iters, device="cuda", seed=0)
        cpu = copy.deepcopy(gpu).to("cpu")
        zero_counts()
        d_gpu, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
        launches = kernel_counts()
        d_cpu, _ = _run_one(make_forward_fn(cpu, device="cpu"), img1, img2)
        want = _option_launches(gpu, iters)
        check(launches == want, f"{name} parity: launches {launches} != {want}")
        err = float(np.abs(d_gpu - d_cpu).max())
        # RAFT's kernels-vs-plain bound (phase 4)
        check(np.isfinite(d_gpu).all() and err <= 5e-3, f"{name} parity {err} > 5e-3")
        rows.append(f"{name} {err:.3e} px (max |disp| {np.abs(d_cpu).max():.1f})")
        del gpu, cpu
    print("RAFT options parity (pallas.json + option, fp32, TF32 off, 1x256x512, 2 iters), "
          "card vs plain on the CPU, disp_up max_abs: " + " | ".join(rows)
          + " (tol 5e-3; launches exact: 2 K1 or 2 K3, 4 K2 where the fnet runs fused)")

    # the kernels on this slice's new inputs: K1 on the cosine pyramid
    # (values in [-1, 1]), K3 at D = 3 (the resized images' features)
    gen = torch.Generator(device="cuda").manual_seed(43)
    B, H, W = K1_FRAME
    f1, f2 = (torch.randn((B, H, W, 256), generator=gen, device="cuda") for _ in range(2))
    coords = torch.rand((B, H, W, 1), generator=gen, device="cuda") * (W + 40) - 20
    errs = []
    for vdt, odt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
        pyr = corr_pyramid_fused(f1.to(vdt), f2.to(vdt), 4, out_dtype=vdt, normalize=True)
        check(max(float(v.float().abs().max()) for v in pyr) <= 1.0 + 2**-7,
              "the cosine pyramid leaves [-1, 1]")
        got = corr_lookup(pyr, coords, 4, odt)
        want = corr_lookup_plain(pyr, coords, 4).permute(0, 3, 1, 2)
        if odt == torch.float32:
            e = float((got - want).abs().max())
            check(e <= 1e-4 * float(want.abs().max()), f"K1 on the cosine pyramid: {e}")
            errs.append(f"fp32 max_abs {e:.3e}")
        else:
            e = bf16_steps(torch, got, want)
            check(e <= 1.0, f"K1 on the bf16 cosine pyramid: {e} bf16 steps")
            errs.append(f"bf16 {e:.2f} bf16 steps")
    for dt in (torch.float32, torch.bfloat16):
        g1, g2 = (torch.rand((B, H, W, 3), generator=gen, device="cuda").to(dt) * 2 - 1
                  for _ in range(2))
        lv = fmap_pyramid(g2, 4)
        got = corr_lookup_alt(g1, lv, coords, 4)
        want = corr_lookup_alt_plain(g1, lv, coords, 4)
        e = float((got - want).abs().max())
        check(e <= 1e-4 * float(want.abs().max()), f"K3 at D 3 {dt}: {e}")
        errs.append(f"K3 D 3 {str(dt).split('.')[-1]} max_abs {e:.3e}")
    print(f"K1 on a cosine pyramid and K3 at D 3, {K1_FRAME}: " + " | ".join(errs)
          + " (tol 1e-4 x max|plain|, bf16 one bf16 step)")
    torch.backends.cudnn.allow_tf32 = True
    del f1, f2

    # full width, full depth: 1 warm-up and the frames a case is timed over
    iters = 32
    rng = np.random.default_rng(0)
    img1, img2 = (rng.uniform(0, 255, (736, 1280, 3)).astype(np.float32) for _ in range(2))
    paths = {}
    for name, frames in OPTION_TIMED:
        override = dict(OPTION_CASES)[name]
        model = create_model({**config, **override}, iters=iters, seed=0)
        forward = make_forward_fn(model)
        _run_one(forward, img1, img2)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times = [_run_one(forward, img1, img2) for _ in range(frames)]
        launches = kernel_counts()
        disp = times[-1][0]
        want = {k: v * frames for k, v in _option_launches(model, iters).items()}
        check(launches == want, f"{name} frames: launches {launches} != {want}")
        check(disp.shape == (736, 1280) and bool(np.isfinite(disp).all()),
              f"{name}: disparity {disp.shape} or non-finite")
        ms = 1e3 * np.asarray([t for _, t in times])
        print(f"option {name} (pallas.json + {override}, bf16, 1x736x1280, {iters} iters, "
              f"{frames} frames): ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f} min "
              f"{ms.min():.2f} max {ms.max():.2f} | launches {launches} | peak mem "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
        paths[f"option_{name}"] = launches
        del model, forward
        torch.cuda.empty_cache()
    return paths


def _teachers_alone(torch, cfg, hyper, state, gen, image):
    """The teachers' forward alone on one clean pair of ``image``: the two
    test-mode models called in turn and the batched forward, timed in turns
    (unbatched, batched, batched, unbatched; 3 calls each) and profiled by
    bucket (chiprun_out/chip_smoke_teachers_{unbatched,batched}_profile.txt)."""
    from dkt_stereo_tpu_torch.train.dkt_step import batched_teachers

    B, H, W = image
    img1, img2 = (255 * torch.rand((B, H, W, 3), generator=gen, device="cuda")
                  for _ in range(2))
    both = batched_teachers(cfg, hyper)

    @torch.no_grad()
    def unbatched():
        state.teacher(img1, img2)
        state.ema(img1, img2)

    @torch.no_grad()
    def batched():
        both(state.teacher, state.ema, img1, img2)

    def host_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    ms = {"unbatched": [], "batched": []}
    for name in ("unbatched", "batched", "batched", "unbatched"):
        ms[name].append(host_ms(unbatched if name == "unbatched" else batched))
    lines = []
    for name, fn in (("unbatched", unbatched), ("batched", batched)):
        def run(fn=fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        wall, busy, _, buckets = device_profile(torch, run,
                                                f"chip_smoke_teachers_{name}_profile.txt")
        lines.append(f"{name}: ms {' '.join(f'{t:.1f}' for t in ms[name])}, profiled wall "
                     f"{wall:.1f} kernels {busy:.1f}; by bucket: {buckets}")
    print(f"the teachers' forward alone (train.json, bf16, B={B} {H}x{W}, "
          f"{hyper.teacher_iters} iters, both teachers; host ms a call in turns): "
          + " || ".join(lines))


# the batched bf16 teachers' disparities may differ from their own forwards
# by this multiple of what a 1e-3 nudge of the left image moves those, max
# and mean (0.60-0.73 on an H100)
BF16_TEACHERS_NUDGE = 1.5


def _module_outputs(torch, model, call, slot=None):
    """``[(module name, output)]`` in the order ``call()`` ran the modules of
    ``model``; under ``vmap`` (``slot`` given) each output is that slot of
    the mapped tensor. The first tensor of a tuple or list output."""
    seen = []

    def hook(name):
        def record(module, args, out):
            while isinstance(out, (tuple, list)):
                out = out[0]
            if not isinstance(out, torch.Tensor):
                return
            if slot is not None:
                dim = torch._C._functorch.maybe_get_bdim(out)
                out = torch._C._functorch.get_unwrapped(out).movedim(dim, 0)[slot]
            seen.append((name, out.detach().clone()))
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()]
    try:
        call()
    finally:
        for h in handles:
            h.remove()
    return seen


def _bf16_teachers(torch, train_cfg):
    """The batched teachers in bf16 on the card, train.json, the EMA's
    weights the teacher's times 1 + 0.02 N(0, 1). (1) torch.autocast in
    place of ``nn/precision.py``'s policy (a mapped conv alone, then the
    batched teachers at 1x64x128): printed, as the reason for the policy.
    (2) The policy's lists against CUDA's autocast, op by op
    (``policy_mismatches``): none may differ. (3) At 1x64x128, 2
    iterations, each slot against its model's own forward under
    torch.autocast, module by module in the order they ran: every dtype
    must agree, and the first output that differs must lie within one bf16
    step (2^-7) of its largest value. (4) At 8x320x720, 32 iterations, the
    flow head x0.02 (random weights otherwise run the disparity to 1,000
    px, where any rounding moves it by ~80 px): each slot's disparity
    against its own forward's, beside what a 1e-3 nudge of the left image
    moves that forward's and how far it lies from fp32 (TF32 off); the
    first two must stay within ``BF16_TEACHERS_NUDGE`` of the third, max
    and mean."""
    import torch.nn.functional as F

    from dkt_stereo_tpu_torch.nn import precision
    from dkt_stereo_tpu_torch.train.dkt_step import batched_teachers, create_dkt_state
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    gen = torch.Generator(device="cuda").manual_seed(45)

    def pair(B, H, W):
        return [255 * torch.rand((B, H, W, 3), generator=gen, device="cuda") for _ in range(2)]

    def teachers(config, hyper):
        state = create_dkt_state(config, hyper, seed=0, device="cuda")
        with torch.no_grad():
            for p in state.ema.parameters():
                p.mul_(1 + 0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
        return state, batched_teachers(config, hyper)

    config = {**train_cfg, "remat_iters": False}
    hyper = DKTHyperParams(train_iters=2, teacher_iters=2, batched_teachers=True)
    state, fn = teachers(config, hyper)
    img1, img2 = pair(1, 64, 128)

    # (1)
    x = torch.randn((1, 4, 16, 16), generator=gen, device="cuda")
    w = torch.randn((2, 8, 4, 3, 3), generator=gen, device="cuda")
    with torch.autocast("cuda", dtype=torch.bfloat16):
        conv = torch.func.vmap(F.conv2d, in_dims=(None, 0))(x, w)
    policy = precision._AutocastPolicy
    precision._AutocastPolicy = lambda device_type: torch.autocast(device_type,
                                                                   dtype=torch.bfloat16)
    try:
        with torch.no_grad():
            fn(state.teacher, state.ema, img1, img2)
        plain = "runs"
    except RuntimeError as e:
        plain = f"raises {str(e).splitlines()[0][:120]}"
    finally:
        precision._AutocastPolicy = policy
    print(f"torch.autocast under vmap on the card: a mapped conv2d of fp32 operands gives "
          f"{conv.dtype}; the batched teachers with torch.autocast in place of the policy "
          f"{plain}")

    # (2)
    mism = precision.policy_mismatches("cuda")
    check(not mism, f"the autocast policy differs from CUDA's autocast: {mism}")

    # (3)
    lines = []
    with torch.no_grad():
        for slot, model in enumerate((state.teacher, state.ema)):
            want = _module_outputs(torch, model, lambda: model(img1, img2))
            got = _module_outputs(torch, fn.model,
                                  lambda: fn(state.teacher, state.ema, img1, img2), slot)
            check([n for n, _ in got] == [n for n, _ in want],
                  "batched bf16 teachers ran other modules than their own forwards")
            bad = [n for (n, a), (_, b) in zip(got, want) if a.dtype != b.dtype]
            check(not bad, f"batched bf16 teachers: dtypes differ at {bad[:5]}")
            first = next(((n, a, b) for (n, a), (_, b) in zip(got, want)
                          if not torch.equal(a, b)), None)
            if first is None:
                lines.append(f"slot {slot}: all {len(got)} module outputs bit-identical")
                continue
            n, a, b = first
            rel = float((a.float() - b.float()).abs().max()) / float(b.abs().max())
            check(rel <= 2**-7, f"batched bf16 teachers: {n} differs by {rel} of its largest "
                                "value, more than a bf16 step")
            lines.append(f"slot {slot}: {len(got)} module outputs of equal dtypes, the first "
                         f"that differs {n} ({type(fn.model.get_submodule(n)).__name__}, "
                         f"{a.dtype}) by {rel:.3g} of its largest value (tol 2^-7)")
    print("the autocast policy gives each listed op CUDA autocast's dtype and values; batched "
          "bf16 teachers vs their own forwards (train.json, 1x64x128, 2 iters): "
          + " | ".join(lines))
    del state, fn

    # (4)
    B, H, W = TRAIN_IMAGE
    hyper = DKTHyperParams(train_iters=16, teacher_iters=32, batched_teachers=True)
    state, fn = teachers(config, hyper)
    fp32 = create_dkt_state({**config, "mixed_precision": False, "corr_dtype": "float32"},
                            hyper, seed=0, device="cuda")
    for model, twin in ((state.teacher, fp32.teacher), (state.ema, fp32.ema)):
        _damped(model, ("flow_head", 0.02))
        twin.load_state_dict(model.state_dict())
    img1, img2 = pair(B, H, W)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        got = fn(state.teacher, state.ema, img1, img2)
        rows = [(model(img1, img2)[1], model(img1 + 1e-3, img2)[1], twin(img1, img2)[1])
                for model, twin in ((state.teacher, fp32.teacher), (state.ema, fp32.ema))]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    lines = []
    for slot, (a, (u, nudged, f)) in enumerate(zip(got, rows)):
        d, n, e = ((x - u).abs() for x in (a, nudged, f))
        for stat in ("max", "mean"):
            got_s, floor = float(getattr(d, stat)()), float(getattr(n, stat)())
            check(got_s <= BF16_TEACHERS_NUDGE * floor,
                  f"batched bf16 slot {slot}: {stat} |diff| {got_s} px > {BF16_TEACHERS_NUDGE} x "
                  f"the nudge's {floor}")
        lines.append(f"slot {slot}: batched max {float(d.max()):.4g} mean {float(d.mean()):.4g} "
                     f"px, nudge max {float(n.max()):.4g} mean {float(n.mean()):.4g}, fp32 max "
                     f"{float(e.max()):.4g} mean {float(e.mean()):.4g}, |disp| max "
                     f"{float(u.abs().max()):.4g}")
    print(f"batched bf16 teachers vs their own forwards under torch.autocast (train.json, flow "
          f"head x0.02, B={B} {H}x{W}, 32 iters; tol {BF16_TEACHERS_NUDGE} x the 1e-3 nudge's "
          f"max and mean): " + " | ".join(lines))
    del state, fn, fp32, got, rows
    torch.cuda.empty_cache()


def phase_options_train(torch, train_cfg, card, unfused_ms, train_data):
    """Phase 44: the DKT step with the new options, train.json at 8x320x720,
    16/32 iterations. (a) mix_fmap_image: one step card vs CPU at 1x64x128
    with the draws (blend weights included) fixed, then 1 warm-up and 5
    timed steps with exactly 96 K1 forward and 16 backward a step; (b)
    batched_teachers: the two slots bit-identical from equal weights, one
    batched step against the unbatched one on the card (losses 1e-3
    relative, weights within 2.5 x the first AdamW move, the bounds of the
    JAX package's tests/test_dkt.py:322), the bf16 policy and module
    dtypes (``_bf16_teachers``), then 1 + 5 timed steps with exactly 64 K1
    forward (the teachers' 2 x 32 lookups in 32 launches) and 16 backward,
    beside phase 9's unbatched step, a profile of one, and the teachers'
    forward alone batched and not, their bf16 disparities held against the
    unbatched forwards' (``_teachers_alone``); (c)
    cli.train --batched_teachers for 3 steps on phase 33's Scene Flow
    tree."""
    from dkt_stereo_tpu_torch.train.dkt_step import (
        batched_teachers, create_dkt_state, fande_draws, make_dkt_train_step)
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    paths = {}
    mix_cfg = {**train_cfg, "corr_implementation": "mix_fmap_image"}
    phase_train_parity(torch, mix_cfg, "mix_fmap_image train-step parity")

    B, H, W = TRAIN_IMAGE
    for label, cfg, hyper_kw, want in (
            ("mix_fmap_image", mix_cfg, {}, {"corr_lookup": 96, "corr_lookup_bwd": 16}),
            ("batched_teachers", train_cfg, {"batched_teachers": True},
             {"corr_lookup": 64, "corr_lookup_bwd": 16})):
        if label == "batched_teachers":
            # (b) on the card, fp32, TF32 off: the slots and the step parity
            torch.backends.cudnn.allow_tf32 = False
            small = {**train_cfg, "mixed_precision": False, "corr_dtype": "float32"}
            kw = dict(train_iters=2, teacher_iters=2, num_steps=100)
            seq, bat = DKTHyperParams(**kw), DKTHyperParams(**kw, batched_teachers=True)
            gen = torch.Generator().manual_seed(44)
            batch = {k: v.cuda() for k, v in _train_batch(torch, gen, 1, 64, 128, "cpu").items()}
            draws = {k: v.cuda() for k, v in fande_draws(1, "cpu", gen).items()}
            states = [create_dkt_state(small, h, seed=0, device="cuda") for h in (seq, bat)]
            zero_counts()
            with torch.no_grad():
                d_pl, d_ema = batched_teachers(small, bat)(
                    states[1].teacher, states[1].ema, batch["img1_clean"], batch["img2_clean"])
            torch.cuda.synchronize()
            slot_launches = kernel_counts()["corr_lookup"]
            check(torch.equal(d_pl, d_ema), "batched teachers: equal weights, unequal slots")
            check(slot_launches == 2, f"batched teachers: {slot_launches} K1 for 2 iterations")
            out = [make_dkt_train_step(small, h)(s, batch, draws=draws)
                   for h, s in zip((seq, bat), states)]
            (s_seq, m_seq), (s_bat, m_bat) = out
            rel = abs(m_bat["loss"] - m_seq["loss"]) / abs(m_seq["loss"])
            moved = max(float((x.detach() - y.detach()).abs().max())
                        for x, y in zip(s_bat.student.parameters(), s_seq.student.parameters()))
            lr0 = seq.lr / 25.0
            check(m_bat["ok"] == 1.0 and rel <= 1e-3, f"batched step loss: relative {rel}")
            check(moved < 2.5 * lr0, f"batched step weights {moved} >= 2.5 lr0 {2.5 * lr0}")
            print(f"batched teachers on the card (train.json, fp32, TF32 off, 1x64x128, 2+2 "
                  f"iters): slots bit-identical from equal weights, {slot_launches} K1 launches "
                  f"for both teachers' 2 iterations | step vs unbatched: loss {m_bat['loss']:.6f} "
                  f"vs {m_seq['loss']:.6f} (relative {rel:.2e}, tol 1e-3), weights max |diff| "
                  f"{moved:.3e} (tol 2.5 lr0 = {2.5 * lr0:.1e})")
            torch.backends.cudnn.allow_tf32 = True
            del states, out, s_seq, s_bat
            _bf16_teachers(torch, train_cfg)
        hyper = DKTHyperParams(train_iters=16, teacher_iters=32, **hyper_kw)
        state = create_dkt_state(cfg, hyper, seed=0)
        step = make_dkt_train_step(cfg, hyper)
        gen = torch.Generator(device="cuda").manual_seed(6)
        state, run = timed_steps(torch, state, step, gen, (B, H, W), label)
        full = {**dict.fromkeys(run["launches"], 0), **want}
        check(all(c == full for c in run["per_step"]),
              f"{label} launches per step {run['per_step']} != {full}")
        print(f"{label} training (train.json + option, bf16, remat, B={B} {H}x{W}, 16/32 "
              f"iters, {TRAIN_STEPS} steps after 1 warm-up): {step_line(run)} | the unbatched, "
              f"unmixed train.json step (phase 9, same call): mean {unfused_ms:.2f} ms/step, "
              f"this / that {run['ms'].mean() / unfused_ms:.3f} | {card}")
        paths[f"{label}_training"] = run["launches"]
        if label == "batched_teachers":
            profile_step(torch, state, step, gen, (B, H, W), run["ms"].mean(),
                         "chip_smoke_batched_train_profile.txt", "batched-teacher")
            _teachers_alone(torch, cfg, hyper, state, gen, (B, H, W))
        del state, step
        torch.cuda.empty_cache()

    # (c) the CLI flag, through cli.train on the Scene Flow tree
    from dkt_stereo_tpu_torch.cli.config import load_model_config

    cfg_path = str(ROOT / "configs/raft_stereo/train.json")
    pth = seeded_pth(torch, load_model_config(cfg_path),
                     Path(train_data).parent / "batched_train.pth")
    argv = ["--config", cfg_path, "--train_datasets", "sceneflow", "--data_root",
            str(train_data), "--batch_size", "8", "--image_size", "320", "720", "--num_workers",
            TRAIN_WORKERS, "--num_steps", "2", "--validation_frequency", "100000", "--save_dir",
            str(Path(train_data).parent / "run_batched"), "--restore_ckpt", pth,
            "--batched_teachers"]
    res, _, launches = _in_process(torch, argv, "cli.train --batched_teachers (train.json)",
                                   {"corr_lookup": 64, "corr_lookup_bwd": 16}, card)
    check(res["checkpoint"].endswith("step_3"), f"batched cli.train ended at {res['checkpoint']}")
    paths["train_cli_batched"] = launches
    return paths


PTRANS_PATCHES = (32, 4, 64)  # the JAX PTrans defaults: patches, views, crop size
PTRANS_IMAGE = (320, 720)  # the CLI's training crop


def phase_ptrans(torch, card):
    """Phase 45: GWCNet base_gc.json with ptrans in train mode. Parity with
    the card against the CPU at 1x64x128 (2 patches x 2 views of 32x32,
    fp32, TF32 off, batch norms calibrated as phase 28a's): z_ps and every
    embedding of unit norm; then B=8 at 320x720 with the JAX defaults (32
    patches, 4 views, 64x64 crops, bf16): the forward's ms and peak. PTrans's
    host seconds a sample at 320x720 on this machine's CPU; the confidence
    tools on the card against the CPU."""
    from dkt_stereo_tpu_torch.data.ptrans import PTrans
    from dkt_stereo_tpu_torch.dkt import confidence
    from dkt_stereo_tpu_torch.models.registry import create_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**_config("configs/gwcnet/base_gc.json"), "ptrans": True}
    gen = torch.Generator().manual_seed(45)
    img1, img2 = (255 * torch.rand((1, 64, 128, 3), generator=gen) for _ in range(2))
    a1, a2 = (255 * torch.rand((1, 2, 2, 32, 32, 3), generator=gen) for _ in range(2))
    gpu = create_model({**cfg, "mixed_precision": False}, device="cuda", seed=0,
                       test_mode=False)
    calibrate_gwc(torch, gpu, img1.cuda(), img2.cuda(), rounds=30)
    cpu = copy.deepcopy(gpu).to("cpu")
    zero_counts()
    with torch.no_grad():
        out_gpu = gpu(img1.cuda(), img2.cuda(), None, a1.cuda(), a2.cuda())
        out_cpu = cpu(img1, img2, None, a1, a2)
    launches = kernel_counts()
    z_err = float((out_gpu["z_ps"].cpu() - out_cpu["z_ps"]).abs().max())
    d_err = float((out_gpu["disp_preds"].cpu() - out_cpu["disp_preds"]).abs().max())
    unit = float((out_gpu["z_ps"].norm(dim=-1) - 1).abs().max())
    check(not any(launches.values()), f"ptrans launched port kernels: {launches}")
    check(out_gpu["z_ps"].shape == (1, 2, 4, 256), f"z_ps {tuple(out_gpu['z_ps'].shape)}")
    # unit vectors after the PSM trunk, a pool and two linear layers: fp32
    # sums in another order; the disparities as phase 28a (5e-2 px)
    check(z_err <= 1e-4 and unit <= 1e-5 and d_err <= 5e-2,
          f"ptrans parity: z_ps {z_err}, unit norm {unit}, disparity {d_err}")
    print(f"GWCNet ptrans parity (base_gc.json + ptrans, fp32, TF32 off, 1x64x128, 2 patches "
          f"x 2 views of 32x32), card vs CPU: z_ps max_abs {z_err:.3e} (tol 1e-4), unit norm "
          f"within {unit:.2e} (tol 1e-5), disp_preds max_abs {d_err:.3e} px (tol 5e-2)")
    torch.backends.cudnn.allow_tf32 = True
    del gpu, cpu

    NP, NV, P = PTRANS_PATCHES
    B, H, W = TRAIN_IMAGE
    model = create_model(cfg, device="cuda", seed=0, test_mode=False)
    g = torch.Generator(device="cuda").manual_seed(45)
    views = [255 * torch.rand((B, NP, NV, P, P, 3), generator=g, device="cuda") for _ in range(2)]
    pair = [255 * torch.rand((B, H, W, 3), generator=g, device="cuda") for _ in range(2)]
    model(*pair, None, *views)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*pair, None, *views)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        del out
    launches = kernel_counts()
    check(not any(launches.values()), f"ptrans forward launched port kernels: {launches}")
    with torch.no_grad():
        z = model(*pair, None, *views)["z_ps"]
    unit = float((z.float().norm(dim=-1) - 1).abs().max())
    check(z.shape == (B, NP, 2 * NV, 256) and unit <= 1e-5, f"z_ps {tuple(z.shape)}, {unit}")
    print(f"GWCNet ptrans train-mode forward (base_gc.json + ptrans, bf16, B={B} {H}x{W}, "
          f"{NP} patches x {NV} views of {P}x{P} a side, {B * NP * 2 * NV} views through the "
          f"trunk): ms median {np.median(times):.2f} min {min(times):.2f} max {max(times):.2f} "
          f"| peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | z_ps "
          f"{tuple(z.shape)}, unit norm within {unit:.2e} | {card}")
    del model, views, pair, z
    torch.cuda.empty_cache()

    rng = np.random.default_rng(45)
    Hs, Ws = PTRANS_IMAGE
    left, right = (rng.integers(0, 256, (Hs, Ws, 3), dtype=np.uint8) for _ in range(2))
    disp = rng.uniform(0, 64, (Hs, Ws)).astype(np.float32)
    pt = PTrans(num_patch=NP, num_view=NV, cropscale=P, rng=np.random.default_rng(0))
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = pt(left, right, disp)
        secs.append(time.perf_counter() - t0)
    check(outs[2].shape == (NP, NV, P, P, 3), f"PTrans views {outs[2].shape}")
    print(f"PTrans host seconds a sample ({Hs}x{Ws}, {NP} patches x {NV} views a side, numpy on "
          f"this machine's CPU, {os.cpu_count()} CPUs): " + " ".join(f"{s:.3f}" for s in secs))

    # the confidence tools: plain PyTorch on the card against the CPU
    torch.backends.cudnn.allow_tf32 = False
    a, b = (torch.rand((2, H, W, 3), generator=gen) for _ in range(2))
    d = -64 * torch.rand((2, H, W, 1), generator=gen)
    di = 48 * torch.rand((2, H, W), generator=gen)
    res, scale = {}, {}
    for name, fn, args in (("ssim_gaussian", confidence.ssim_gaussian, (a, b)),
                           ("reprojection_error", confidence.reprojection_error, (a, b, d)),
                           ("uniqueness", confidence.uniqueness, (di,)),
                           ("agreement", lambda x: confidence.agreement(x, 2, 1.0), (di,))):
        want = fn(*args)
        got = fn(*(x.cuda() for x in args)).cpu()
        res[name], scale[name] = float((got - want).abs().max()), float(want.abs().max())
    torch.backends.cudnn.allow_tf32 = True
    check(res["uniqueness"] == 0.0 and res["agreement"] == 0.0,
          f"uniqueness/agreement differ on the card: {res}")
    # the reprojection error adds one L1 mean over the 1.4 M values of the
    # pair, an fp32 sum in another order on the card (1.013e-5 on values up
    # to ~0.5 in PR 18's first run): 1e-4 of the values' scale
    check(res["ssim_gaussian"] <= 1e-4 * scale["ssim_gaussian"]
          and res["reprojection_error"] <= 1e-4 * scale["reprojection_error"],
          f"SSIM/reprojection differ on the card: {res} (scales {scale})")
    print(f"confidence tools (2x{H}x{W}, fp32, TF32 off), card vs CPU max_abs: "
          + " ".join(f"{k} {v:.3e} (max {scale[k]:.3e})" for k, v in res.items())
          + " (tol 1e-4 x max; uniqueness and agreement exact)")
    return {}


def main():
    """Every phase, then every process the phases started is stopped."""
    adopt_orphans()
    try:
        return run()
    finally:
        stopped = stop_children()
        if stopped:
            print(f"chip_smoke: stopped {stopped} leftover processes", file=sys.stderr)


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from dkt_stereo_tpu_torch.ops.cuda import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1

    card = gpu_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {[p.name for p in libs]}")
    print(f"ptxas: {ptxas_line(libs)}")
    print(f"dynamic shared memory a block: {smem_line()}")

    k1 = phase_k1(torch)
    k2 = phase_k2(torch)
    config = json.loads((ROOT / "configs/raft_stereo/pallas.json").read_text())
    phase_parity(torch, config)
    _, forward, images, infer = phase_main(torch, config, card)
    phase_profile(torch, forward, images)

    k1b = phase_k1_bwd(torch)
    k2b = phase_k2_vjp(torch)
    train_cfg = json.loads((ROOT / "configs/raft_stereo/train.json").read_text())
    phase_train_parity(torch, train_cfg)
    train, unfused_ms = phase_train(torch, train_cfg, card)

    k4 = phase_k4(torch)
    k4b = phase_k4_bwd(torch)
    igev_cfg = json.loads((ROOT / "configs/igev_stereo/pallas.json").read_text())
    phase_igev_parity(torch, igev_cfg)
    igev = phase_igev_main(torch, igev_cfg, card)
    igev_train_cfg = json.loads((ROOT / "configs/igev_stereo/train.json").read_text())
    phase_igev_train_parity(torch, igev_train_cfg)
    igev_train = phase_igev_train(torch, igev_train_cfg, card)

    k3 = phase_k3(torch)
    phase_k3_vjp(torch)
    alt_cfg = json.loads((ROOT / "configs/raft_stereo/alt_pallas.json").read_text())
    phase_alt_parity(torch, alt_cfg)
    alt = phase_alt_main(torch, alt_cfg, config, card)

    k5 = phase_k5(torch)
    pcv_cfgs = {n: json.loads((ROOT / f"configs/pcvnet/{n}.json").read_text())
                for n in ("base", "fast")}
    phase_pcv_parity(torch, pcv_cfgs)
    pcv, pcv_fast = phase_pcv_main(torch, pcv_cfgs["base"], pcv_cfgs["fast"], card)

    k5b = phase_k5_bwd(torch)
    phase_pcv_train_parity(torch, pcv_cfgs["base"])
    pcv_train = phase_pcv_train(torch, pcv_cfgs["base"], card)

    phase_encoder_vjp(torch)
    phase_train_parity(torch, {**train_cfg, "pallas_encoder": True}, "fused train-step parity",
                       {"corr_lookup": 8, "corr_lookup_bwd": 2, "encoder_stage": 12,
                        "encoder_stage_bwd": 4})
    fused_paths = phase_fused_train(torch, train_cfg, alt_cfg, config, card, unfused_ms)

    phase_gwc_parity(torch)
    gwc_paths = phase_gwc_main(torch, card)
    phase_gwc_train_parity(torch)
    gwc_paths.update(phase_gwc_train(torch, card))

    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        tmp = Path(tmp)
        eval_paths, data = phase_eval(torch, card, tmp)
        eval_paths.update(phase_eval_models(torch, card, tmp, data))
        phase_demo(torch, tmp, data)
        eval_paths.update(phase_bench(torch))
        train_data = phase_data(torch, tmp, card)
        eval_paths.update(phase_booster_recipe(torch, tmp, train_data, card))
        eval_paths.update(phase_train_models(torch, data, train_data, card))

        ns_cfg = json.loads(NS_CONFIG.read_text())
        phase_ns_parity(torch, ns_cfg)
        eval_paths.update(phase_ns_train(torch, ns_cfg, card))
        eval_paths.update(phase_ns_cli(torch, train_data, card))

        eval_paths.update(phase_profiled_train(torch, train_data, card))
        eval_paths.update(phase_banded(torch, alt_cfg, card))
        eval_paths.update(phase_exact_and_dp(torch, alt_cfg, igev_cfg, train_cfg, ns_cfg, card))
        eval_paths.update(phase_dp_world_of_one(torch, train_cfg, card, unfused_ms, tmp))

        eval_paths.update(phase_options(torch, config, card))
        eval_paths.update(phase_options_train(torch, train_cfg, card, unfused_ms, train_data))
        eval_paths.update(phase_ptrans(torch, card))

    def launches(name):
        by_path = {"inference": infer.get(name, 0), "training": train.get(name, 0),
                   "igev_inference": igev.get(name, 0),
                   "igev_training": igev_train.get(name, 0),
                   "alt_inference": alt.get(name, 0), "pcv_inference": pcv.get(name, 0),
                   "pcv_fast_inference": pcv_fast.get(name, 0),
                   "pcv_training": pcv_train.get(name, 0),
                   **{path: c.get(name, 0) for path, c in fused_paths.items()},
                   **{path: c.get(name, 0) for path, c in gwc_paths.items()},
                   **{path: c.get(name, 0) for path, c in eval_paths.items()}}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    k2p = k2["plain"]
    kernels = [
        dict(name="corr_lookup", route="cuda", source="dkt_stereo_tpu_torch/csrc/corr_lookup.cu",
             replaces="dkt_stereo_tpu/ops/pallas/corr_lookup.py:290",
             **launches("corr_lookup"), **k1),
        dict(name="corr_lookup_bwd", route="cuda",
             source="dkt_stereo_tpu_torch/csrc/corr_lookup_bwd.cu",
             replaces="dkt_stereo_tpu/ops/pallas/corr_lookup.py:254",
             **launches("corr_lookup_bwd"), **k1b),
        dict(name="encoder_stage", route="cuda",
             source="dkt_stereo_tpu_torch/csrc/encoder_stage.cu",
             replaces="dkt_stereo_tpu/ops/pallas/encoder_conv.py:274",
             **launches("encoder_stage"),
             max_abs_err=max(r["max_abs_err"] for r in k2.values()),
             **{k: k2p[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="encoder_stage_bwd", route="cuda",
             source="dkt_stereo_tpu_torch/csrc/encoder_stage.cu",
             replaces="dkt_stereo_tpu/ops/pallas/encoder_conv.py:476",
             **launches("encoder_stage_bwd"), **k2b),
        dict(name="geo_lookup", route="cuda", source="dkt_stereo_tpu_torch/csrc/geo_lookup.cu",
             replaces="dkt_stereo_tpu/ops/pallas/geo_lookup.py:302",
             **launches("geo_lookup"), **k4),
        dict(name="geo_lookup_bwd_geo", route="cuda",
             source="dkt_stereo_tpu_torch/csrc/geo_lookup_bwd.cu",
             replaces="dkt_stereo_tpu/ops/pallas/geo_lookup.py:261",
             **launches("geo_lookup_bwd_geo"), **k4b["geo"]),
        dict(name="geo_lookup_bwd_corr", route="cuda",
             source="dkt_stereo_tpu_torch/csrc/geo_lookup_bwd.cu",
             replaces="dkt_stereo_tpu/ops/pallas/geo_lookup.py:285",
             **launches("geo_lookup_bwd_corr"), **k4b["corr"]),
        dict(name="corr_lookup_alt", route="cuda", source="dkt_stereo_tpu_torch/csrc/corr_alt.cu",
             replaces="dkt_stereo_tpu/ops/pallas/corr_alt.py:162",
             **launches("corr_lookup_alt"), **k3),
        dict(name="row_sample", route="cuda", source="dkt_stereo_tpu_torch/csrc/row_sample.cu",
             replaces="dkt_stereo_tpu/ops/pallas/row_sample.py:145",
             **launches("gaussian_row_sample"), **k5),
        dict(name="row_sample_bwd", route="cuda",
             source="dkt_stereo_tpu_torch/csrc/row_sample_bwd.cu",
             replaces="dkt_stereo_tpu/ops/pallas/row_sample.py:108",
             **launches("gaussian_row_sample_bwd"), **k5b),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
