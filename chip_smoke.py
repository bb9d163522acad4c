#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``intrepppid_tpu_torch``) on one
NVIDIA card, from a checkout of the repository:

    python3 chip_smoke.py

Phases, each printing one JSON line (a failed check raises, and the script
exits non-zero with no result):

1. build — compile every kernel from ``intrepppid_tpu_torch/csrc`` with
   ``nvcc`` (and the native tokenizer with ``g++``) in parallel, and print
   the ``-Xptxas -v`` summary (registers, shared memory, spills);
2. kernel — the bidirectional-LSTM layer forward (eval variant) against its
   plain PyTorch version on the card, at the serve path's shapes (800 rows,
   T = 1500, H = 64, layer 0 at E = 64 and layer 1 at E = 2 x 64) in f32
   (``bilstm_fwd_f32``, three tf32 passes on the tensor cores) and bf16
   (``bilstm_fwd_mma``), with lengths mixing 0, 1, T and random values,
   plus H = 32 at a smaller size; then the kernel (twice), the plain
   version and cuDNN's ``nn.LSTM(bidirectional=True)`` (a yardstick the
   port never calls) timed with CUDA events at full lengths;
3. serve — ``Serve.start`` at the manuscript width (vocab 250, E = 64,
   2 layers, f32) with seeded random weights written as a reference-layout
   ``.ckpt``, answering real HTTP requests on 127.0.0.1; probabilities are
   checked against the port's CPU plain forward, and the f32 tensor-core
   forward's launch counter must rise during the requests and the bf16
   one's stay at 0;
4. train_kernel — the train step's kernels (the forward in both variants,
   the two backward sweeps and the weight-gradient kernel) against their
   plain versions at the train shapes (400 rows in 5 weight groups of 80,
   T = 1500, H = 64, layer 0 at E = 64 with grouped W_hh and layer 1 at
   E = 2 x 64) in f32 and bf16, lengths mixing 0, 1, T, random values and
   per-group maxima: in bf16 the forward, the sweep and wgrad are the
   tensor-core kernels (``bilstm_layer_fwd(_train)_mma``,
   ``bilstm_bwd_mma``, ``bilstm_wgrad_mma``), in f32 the forward, the sweep
   and wgrad are the 3xTF32 tensor-core kernels
   (``bilstm_layer_fwd(_train)_f32``, ``bilstm_bwd_f32``,
   ``bilstm_wgrad_f32``), and the CUDA-core sweep ``bilstm_bwd.cu``, asked
   for by name, is held too, and the twins with their products in one tf32 pass are
   recorded beside them (a control for the f32 tolerance); ragged cases (27
   rows in 3 groups, T = 1, rows of length 0; the one-stage f32 sweep at
   E = H = 80, T = 1 and 5; the forward at E = H = 80 and the one-block
   lite sweep at H = 96 in both dtypes, the bf16 forward at E = H = 72,
   T = 1 and 5); at their own main path's shapes (layer 0 of the two-layer
   model at embedding 80: E = H = 80, 5 groups, two dy streams a direction)
   the 3xTF32 forward ``bilstm_fwd_f32`` (both variants, its 320-thread
   instance) in f32 and the tensor-core forward ``bilstm_fwd_mma`` (its
   <80, 80> instance) in bf16, ``bilstm_wgrad_f32`` (its 64 x 160 tile;
   each tile of ``WGRAD_TILES_80`` pinned too, in turns with the
   dispatch's) in f32 and ``bilstm_wgrad_mma`` (its last gate tile masked)
   in bf16, the one-stage 3xTF32 sweep ``bilstm_bwd_f32_onestage`` in f32
   (in turns with ``bilstm_bwd.cu`` by name) and the tensor-core sweep
   ``bilstm_bwd_mma`` (its <80, 80> instance) in bf16; then each kernel
   (the sweeps in turns with ``bilstm_bwd.cu``: new, old, old, new, in the
   same run), and a PyTorch yardstick
   (cuDNN training and inference forward and backward-data in f32 and in
   bf16, cuBLAS products in the same dtype) timed with CUDA events at full
   lengths, TF32 off; the plain versions are timed once, in the check;
5. train — ``intrepppid_network(compute_dtype=bfloat16,
   optimizer_type="ranger21_xx")`` on the card and the port's ``Trainer``
   on synthetic quintuplet batches (80 pairs, T = 1500, dropout on): 2
   warm-up steps, 12 timed steps and an eval step, a profiled step, and
   each kernel's launch count: the tensor-core forward (both variants),
   ``bilstm_bwd_mma`` and ``bilstm_wgrad_mma`` must be > 0 and the
   CUDA-core sweep and the f32 tensor-core kernels 0;
   then 2 steps of the same model in f32 (and a profiled one), which must
   run ``bilstm_layer_fwd_train_f32``, ``bilstm_bwd_f32`` and
   ``bilstm_wgrad_f32``, and 2
   steps and an eval step of the two-layer model at embedding 80 in f32 and
   in bf16: layer 0's forward (both variants) ``bilstm_fwd_f32`` in f32
   and ``bilstm_fwd_mma`` in bf16, its wgrad
   ``bilstm_wgrad_f32``'s 64-row tile in f32 and ``bilstm_wgrad_mma`` in
   bf16 (in bf16 no ``dW_ih`` products: the stacked layer's weight
   gradients whole at 96), its sweep ``bilstm_bwd_f32_onestage`` in
   f32 and ``bilstm_bwd_mma`` in bf16 (``bilstm_bwd.cu`` never); the
   stacked layer padded to H = 96 on the wide route (the tensor-core
   gates, the one-block wide forward, ``bilstm_fwd_wide_f32_resident`` in
   f32 and ``bilstm_fwd_wide_mma_resident`` in bf16, and the one-block
   lite sweep,
   ``bilstm_bwd_lite_f32_resident`` in f32 and
   ``bilstm_bwd_lite_mma_resident`` in bf16, never ``bilstm_bwd_lite.cu``);
   then one step's gradients (and at embedding 80 an eval step)
   on the card held against the port's CPU plain path at a small size, in
   f32 and bf16 (also at embedding 80, two layers);
5a. fit — ``Trainer.fit`` at the manuscript width (bf16, ``ranger21_xx``,
   dropout on, SWA on, every checkpoint kept in a temporary directory):
   3 epochs of 6 batches (5 of 80 pairs and one of 40, T = 1500), a val
   pass of 2 batches each, then ``test("best")`` on 2 test batches, over an
   in-memory data module (``FitModule``); each epoch's seconds, pairs/s
   (beside phase train's step rate) and losses, each checkpoint save's ms
   and bytes, the launch counts (the bf16 tensor-core kernels > 0, the
   f32 and CUDA-core ones 0); ``test("best")`` against eval steps of a
   fresh network loaded from the best checkpoint's ``state.pt``; and a
   fresh trainer's ``fit`` from the epoch-0 checkpoint, whose final
   weights and SWA average must lie within 2^-7 x max(1, max|w|) of the
   straight run's (whether bit for bit is reported, and where not, the
   parameters whose gradients differ between two identical steps);
5b. train_cli — ``train e2e_rnn_triplet`` through the CLI dispatcher at the
   manuscript width (bf16, the CLI's defaults: ``ranger21``, dropout 0.3,
   SWA), 3 epochs of 440 pairs (5 x 80 + 40), T up to 1500, on seeded
   synthetic tables in the INTREPPPID schema (1,200 sequences of 50-1,500
   residues, ~300 orthologue groups; ``synthetic_tables`` stands in for
   ``ppi_oma.read_split`` during the phase, as the card's machine has no
   ``h5py``), tokenised batch by batch with ``golden_spm.model`` (subword
   sampling on in training) through the data module and the input
   pipeline; then ``eval e2e_rnn_triplet`` on the best checkpoint's test
   split, which must equal the run's ``test_results`` within 1e-6 x max(1,
   |v|); every loss finite; the bf16 tensor-core kernels launched (the
   eval forward in ``eval``), no f32 or CUDA-core one; the run's
   artifacts; each epoch's seconds and pairs/s beside phase fit's and
   phase train's, the seconds each epoch's ``_make_batch`` took on the
   host, the T buckets and the eval command's seconds;
5c. data_parallel — ``parallel/`` and ``--profile_dir`` (child processes of
   this script, each with its own timeout; one that fails or hangs fails
   the phase): an NCCL group of one process takes 2 bf16 steps bit for
   bit the steps without a group, and reports which collectives a gloo
   group takes on CUDA tensors; two gloo ranks share ``cuda:0`` (NCCL
   refuses two ranks on one card): 3 steps on their rows of 79-pair
   global batches (an uneven split, dropout on), bit-equal to each other
   and within 2^-7 x max(1, max|w|) of one process's steps, then ``train
   e2e_rnn_triplet --n_data_parallel 2`` over phase train_cli's tables (2
   epochs): one run name and seed, final weights bit-equal, rank zero
   alone writing files, each rank's bf16 tensor-core kernels launched;
   its epoch seconds (two ranks on one card: no multi-card rate); then a
   one-process ``train ... --profile_dir`` run of 3 epochs: one
   ``*.pt.trace.json`` of epoch 0's steps holding device events of
   ``bilstm_fwd_mma``, ``bilstm_bwd_mma`` and ``bilstm_wgrad_mma``, and
   its epoch 0 seconds beside epochs 1-2;
5d. variational — the ablation configuration (``BASELINE.json``
   ``configs[2]``: variational dropout at 0.3, ``use_projection``,
   ``bi_reduce`` mean) at the manuscript width: layer 0's eval forward on
   grouped ``w_hh (2, G, 4H, H)`` (one row mask per encoder call, at eval
   too) against its plain version on the same weights at G = 2 x 400 rows
   and 5 x 80, f32 (``bilstm_fwd_f32``) and bf16 (``bilstm_fwd_mma``),
   timed beside its bound; a gradient and an eval step (8 pairs, T = 64)
   against the CPU from the same row masks, f32 and bf16; the scoring
   engine (f32) on one 400-pair request three times, bit-equal, its pairs/s
   beside phase serve's, layer 0 of every call on the grouped eval forward
   (phase serve's network, without variational dropout, launches none);
   ``train e2e_rnn_triplet --variational_dropout true --use_projection
   true --bi_reduce mean`` over the synthetic tables (bf16, 3 epochs),
   then ``eval`` of its best checkpoint twice, bit-equal, the grouped
   forwards launched in both; the counts read as ``grouped_launches``;
5e. export — ``export torch_ckpt`` of phase fit's best checkpoint: the
   ``.ckpt``'s ``hyper_parameters``, ``epoch`` and ``global_step``, and a
   fresh network loaded from it scoring 400 pairs (T = 1500, bf16)
   bit-equal to the network loaded from the checkpoint's ``state.pt``; the
   export's ms and bytes;
5f. orbax — the JAX package's checkpoint directory of the manuscript
   network (``tests/fixtures/jax_orbax_manuscript/``: 2 epochs of
   ``ranger21`` at lr 1e-3 with SWA, written on the CPU by
   ``tools/make_jax_orbax_fixture.py``) read without JAX: (a) the read's
   seconds (twice), the directory's bytes and the seconds spent in zstd;
   (b) ``infer``'s loader and the scoring engine in f32 on the 64 pairs
   the JAX engine scored, within 1e-6 of its probabilities, while the
   same weights with each LSTM layer's two directions swapped (a planted
   fault) score further off than that, with
   ``bilstm_layer_fwd_f32`` launched and the bf16 forward not; (c) ``export
   torch_ckpt`` of the directory, its weights read back bit-equal to the
   directory's; (d) ``Trainer.resume`` from it (start epoch, step,
   Ranger21's count and ``swa_n`` as the fixture's record says), that
   state written by the port as a ``state.pt`` checkpoint, then ``train
   e2e_rnn_triplet --checkpoint_path`` from each: one epoch of phase
   train_cli's synthetic tables at vocab 250 through the fixture's
   tokenizer (bf16, ``ranger21``, SWA), the weights, the SWA average and
   the epoch's checkpoint bit-equal, the bf16 tensor-core kernels
   launched and no f32 or CUDA-core one;
5g. widths — the layers the width repairs open (``ops/lstm_cuda.py:
   padded_width``, ``padded_parts``: the stacked layer at embedding 80, run
   at H = 96; both layers at embedding 112 and 100, run at 128 with parts
   of 112; layer 0 at embedding 50, run at H = 64 with E = 56 in f32 and
   64 in bf16; both layers at 272, run at 288), 400 rows, T = 1500, f32 and
   bf16: ``layer_fwd`` and ``layer_bwd`` against the plain layer at the
   true widths, the kernels they ran, their times beside their bounds at
   the true and the padded widths and cuDNN at the true ones; the
   two-layer model at embedding 100 and 272 at the train shape (80 pairs,
   T = 1500, dropout on: 2 steps and an eval step) in f32 and bf16 (at 272
   in bf16 the tensor-core forward and lite sweep, never the CUDA-core
   ones; in f32 at both the f32 tensor-core gates, wide forward and lite
   sweep, never the CUDA-core ones), each with the kernels it must launch
   and must not; the f32 tensor-core lite sweep on layer 0 at embedding
   272 (H = 288), of the scaled configuration (256) and at embedding 100
   (128), against its twin, at each row tile, beside its bound and cuDNN;
   the f32 tensor-core gates and wide forward (both variants) on layer 0
   and the stacked layer at embedding 272 (288), layer 0 of the scaled
   configuration and at embedding 100 (128), against their twins, beside
   their bounds, ``addmm`` and cuDNN, the forward at each row tile in
   turns with the dispatch; the f32 lite sweep on its main path (the
   stacked layer at embedding 80, H = 96), the one-block
   ``bilstm_bwd_lite_f32_resident``, beside its bounds and cuDNN; layer 0
   of the bf16 model at embedding 72 (E = H = 72): the tensor-core sweep
   ``bilstm_bwd_mma`` (its <72, 72> instance) and forward
   ``bilstm_fwd_mma`` (both variants, its <72, 72> instance), beside their
   bounds and cuDNN; the tensor-core sweep on both layers of the bf16 model
   at embedding 16 (its <16, 32> instance on the stacked layer, E = 16 +
   16, K = 48 run as 64, ``bilstm_bwd.cu``'s main path before it, and its
   <16, 16> one on layer 0), each held against the twin with the run-time
   build and ``bilstm_bwd.cu`` by name, then timed in turns with both,
   beside its bounds and cuDNN, and the sweep's instances' registers and
   spills; the tensor-core forward's <56, 56> and <56, 112> instances on
   both layers of the bf16 model at embedding 56, beside their bounds and
   cuDNN; every instance of ``K8_FWD_SHAPES`` (``k8_fwd``: both variants
   against the twin at 27 rows in 3 groups, T = 1 and 5, then the train
   variant at the train shape beside cuDNN bf16 at its E and H; registers
   and spills) and the f32 wgrad's
   64-row tile at each of ``NARROW_WGRAD_SHAPES`` (``narrow_wgrad``:
   against the twin at T = 300 and at 27 rows, then at the train shape,
   beside its bounds at 495/3 and 67 and cuBLAS f32; each tile's
   registers, spills and blocks an SM); the bf16 two-layer model at
   embedding 72 at the train shape (2 steps and an eval step, timed: layer
   0 on ``bilstm_fwd_mma`` and ``bilstm_bwd_mma``, the stacked layer on
   ``bilstm_bwd_lite_mma_resident``, never ``bilstm_bwd.cu``); the
   wide forward (both variants: in bf16 the one-block
   ``bilstm_fwd_wide_mma_resident``, in f32 the one-block
   ``bilstm_fwd_wide_f32_resident`` in three tf32 passes, also at 5 weight
   groups)
   and lite sweep (the one-block ones) at the stacked layer at embedding 80
   (run at H = 96) in bf16 and in f32, against their twins, timed beside
   their bounds and cuDNN; at 288 the
   tensor-core forward (both variants) ``bilstm_fwd_wide(_train)_mma``
   and lite sweep ``bilstm_bwd_lite_mma`` (their instances for uneven
   unit groups), which the dispatch names there, against their twins and
   timed, the forward also at each of its row tiles; the two-layer
   models at embedding 160 at the train shape in f32 and bf16 (2 steps and
   an eval step each, timed) and layer 0 at E = H = 160, 192, 224: in f32
   ``bilstm_fwd_wide_f32`` (both variants, each row tile in turns with
   the dispatch) and ``bilstm_bwd_lite_f32``, in bf16
   ``bilstm_fwd_wide(_train)_mma`` (its kernel for uneven unit groups, each
   row tile, with its registers, spills and blocks an SM) and
   ``bilstm_bwd_lite_mma``, beside their bounds and cuDNN; then a
   gradient step and
   an eval step on the card against the CPU at small size (8 pairs,
   T = 64), in f32 and bf16, of two-layer models at embedding 48, 50, 100,
   112, (bf16) 272, (bf16) 72, whose layer 0 is the main path of the
   tensor-core forward's and sweep's <72, 72> instances, (bf16) 16, whose
   layers are the tensor-core sweep's <16, 16> and <16, 32> instances
   (``bilstm_bwd.cu`` never), (f32) 16, 48 and 80, whose weight gradients
   are the f32 wgrad's 64-row tile's, (bf16) 56, whose layers are the
   tensor-core forward's <56, 56> and <56, 112> instances, and 160, whose layers
   run the f32 tensor-core
   forward and lite sweep in f32, the bf16 tensor-core forward, lite
   sweep and split wgrad in bf16, and of the recurrence backend at
   embedding 80 (run at 96: the tensor-core
   ``lstm_recurrence_{fwd,bwd}_mid_f32`` in f32 and
   ``lstm_recurrence_{fwd,bwd}_mid_mma`` in bf16), each
   with the kernels it must launch (and, where given, must not);
6. wide_kernel — the wide route's kernels (input gates, the cluster
   forward in both variants, the lite sweep) and the weight-gradient
   kernel against their plain versions at the scaled configuration's
   shapes (400 rows in 5 groups of 80, T = 1500, H = 256, layer 0 at
   E = 256 with grouped W_hh and a stacked layer at E = 2 x 256) in f32 and
   bf16, at H = 128 (T = 300), and the resident forward, sweep and wgrad at
   H = 32 (T = 300); in bf16 the input gates are ``bilstm_gates_mma``, the
   wide forward ``bilstm_fwd_wide(_train)_mma``, the lite sweep
   ``bilstm_bwd_lite_mma`` and wgrad ``bilstm_wgrad_mma``, in f32 (three
   tf32 passes) ``bilstm_gates_f32``, ``bilstm_fwd_wide(_train)_f32``,
   ``bilstm_bwd_lite_f32`` and ``bilstm_wgrad_f32``; the
   input gates computed twice must agree bit for bit (the backward
   recomputes them), and so must the tensor-core forwards' hs in their two
   variants; ragged cases of the tensor-core kernels (27 rows in 3 groups
   and in 1, T = 1 and 5, every row tile of the forward and the sweep, the
   f32 gates and forward at 128, 256 and 288 at every row tile; wgrad
   in both dtypes); then each timed with CUDA events at full lengths beside
   its plain version and a PyTorch yardstick in the same dtype (cuBLAS
   ``addmm``, in bf16 with ``out_dtype=float32``; cuDNN), TF32 off; in bf16
   the forward and the sweep at each of their row tiles;
   and the bf16 wide route's split weight gradient (``dW_ih`` on cuBLAS,
   ``dW_hh`` on ``bilstm_wgrad_mma`` with no input part) against its twin
   at the train shape on the wide layers at 96 (the stacked layers at
   embedding 80 and 72: the whole kernel is the dispatch's there), 160,
   256 and 288, timed in turns with the whole kernel (split, whole, whole,
   split) beside its two parts alone, cuBLAS and the bounds
   (``wgrad_split``);
7. train_scaled — the scaled configuration (embedding 256, 3 layers,
   bf16, ``ranger21_xx``, 80 pairs, T = 1500, dropout on): 2 warm-up
   steps, 6 timed steps and one eval step, whose launches must go through
   ``bilstm_gates_mma``, ``bilstm_fwd_wide(_train)_mma``,
   ``bilstm_bwd_lite_mma``, ``bilstm_wgrad_mma`` and the ``dW_ih`` products
   (``bilstm_wgrad_ih``) and never through the
   resident kernels or the CUDA-core gates, forward, sweep and wgrad, a
   profiled step and peak memory; then one step's gradients at embedding
   256 and 3 layers held against the CPU plain path in f32, with an eval
   step after it (which must run ``bilstm_gates_f32``,
   ``bilstm_fwd_wide(_train)_f32``, ``bilstm_bwd_lite_f32`` and
   ``bilstm_wgrad_f32``, never the CUDA-core ones) and in bf16 (which must
   run the tensor-core ones);
8. recurrence_kernel — the time-major recurrence op's kernels (forward,
   sweep, weight gradient) against their plain versions at T = 1500,
   D = 2, 400 rows: H = 64 with 5 weight groups and with 1, H = 256 with 5
   groups, and H = 32 at T = 300; f32 and bf16; masks built from lengths
   (mixing 0, 1, T and random values; a suffix for the reverse direction)
   and a random mask with holes, an all-zero and an all-one row. At H = 64
   and 32 the sweep and the forward are tensor-core kernels
   (``lstm_recurrence_{bwd,fwd}_mma`` in bf16,
   ``lstm_recurrence_{bwd,fwd}_f32`` in f32, three tf32 passes; each
   forward the same bits twice), and so is the weight gradient
   (``lstm_recurrence_wgrad_mma`` in bf16, ``lstm_recurrence_wgrad_f32``
   in f32, three tf32 passes); the CUDA-core wgrad, asked for by name, is
   held and timed beside them (new, old, old, new); ragged cases (27 rows
   in 3 groups, T = 1, 2 and 5, the forwards at D = 1-3, both wgrads);
   ``wgrad_f32``: the f32 wgrad's two tiles at H = 64, 128 and 288 at the
   train shape, each against its twin at T = 300 and 27 rows, then in
   turns with the CUDA-core wgrad by name, beside its bounds (bytes, and
   operations at 495/3 and at 67) and cuBLAS f32, with registers, spills,
   splits and blocks an SM; the op at H = 128, 5 groups, the shapes of its
   main paths (``op_h128``: the tensor-core sweep and forward,
   ``lstm_recurrence_{bwd,fwd}_mid_f32`` in f32, three tf32 passes, and
   ``lstm_recurrence_{bwd,fwd}_mid_mma`` in bf16, both masks, the same
   bits twice); the
   f32 sweep and forward at each width 96-288 (``mid_f32``: the sweep held
   against its twin at T = 300, each instance of the forward, by blocks a
   cluster, fragments resident or read from L2, and row tile, held against
   its twin at T = 300 (both masks) and 27 rows, twice; then each
   instance of either timed in turns with the dispatch at T = 1500, with
   registers, spills, the clusters the card holds and cuDNN f32 at each
   width); the bf16 sweep and forward at each width 96-288 (``mid_mma``:
   each instance, by blocks a cluster and row tile, held against its twin
   at T = 300 with masks from lengths and with holes and computed twice
   (the same bits), then timed in turns with the dispatch at T = 1500,
   cuDNN bf16 at each width). At H = 256 the sweeps and forwards are the
   tensor-core ones of 96-288 too. Each is timed
   with CUDA events beside its plain version and a PyTorch yardstick (one
   bidirectional ``nn.LSTM`` layer at full lengths, in f32 and bf16,
   which also does the input projection; for the weight
   gradient one batched cuBLAS product on the rounded operands and, in
   bf16, the rounding, layout and product together); then the op past 256
   units (H = 288 on the tensor-core kernels of 96-288, 512 and
   1024 on the tensor-core kernels ``lstm_recurrence_{fwd,bwd}_wide_mma``
   in bf16 and ``lstm_recurrence_{fwd,bwd}_wide_f32`` in f32) against its
   twins, the bf16 tensor-core kernels alone at H = 320, 512 and 1024 with
   masks from lengths and with holes (2^-7 x max(1, max|ref|)), the f32
   tensor-core forward and sweep (three tf32 passes) alone at the same
   widths and masks (1e-4 x max(1, max|ref|)), and one call at H = 512
   (400 rows, T = 300) timed beside its bound and cuDNN, the f32 forward
   at each of its row tiles, the f32 kernels' bounds at 495/3 TFLOP/s
   beside the ones at 67;
9. recurrence_path — with ``ops.lstm.DEFAULT_BACKEND = "recurrence"``, the
   manuscript-width bf16 train step of phase 5 (2 warm-up and 4 timed
   steps, one eval step): ``lstm_recurrence_fwd_mma``,
   ``lstm_recurrence_bwd_mma`` and ``lstm_recurrence_wgrad_mma`` must be
   > 0, the other forwards and sweeps, the CUDA-core wgrad and the layer
   kernels 0; then 2 f32 steps (and a profiled one), whose forward, sweep
   and wgrad must be ``lstm_recurrence_fwd_f32``, ``lstm_recurrence_bwd_f32``
   and ``lstm_recurrence_wgrad_f32`` alone, and 2 steps of a one-layer model at
   embedding 128, in f32 (its forward, sweep and wgrad
   ``lstm_recurrence_{fwd,bwd}_mid_f32`` and ``lstm_recurrence_wgrad_f32``)
   and in bf16 (its forward and sweep ``lstm_recurrence_{fwd,bwd}_mid_mma``),
   each profiled; the f32 manuscript step and the f32 step at embedding 128
   in turns with the wgrad pinned to ``lstm_recurrence_wgrad.cu``
   (``wgrad_pinned_turns``); a profiled
   step, peak memory, and the card's gradients against the CPU's on the
   same backend, in f32 and in bf16; then, on the default backend (which
   takes the op past 288 units a layer), 2 f32 steps and an eval step of a
   one-layer model at embedding 320, timed, and the card's gradients of
   that model against the CPU's (in f32 the tensor-core forward, sweep and
   wgrad past 288, three tf32 passes; in bf16 the tensor-core kernels past
   288; no layer kernel);
10. infer — ``python -m intrepppid_tpu_torch infer from_csv`` on a
    synthetic proteome (1200 sequences of 200-3000 residues, 4000 pairs,
    ``tests/fixtures/golden_spm.model``, manuscript width, ``trunc_len``
    1500, batch 64, seeded weights): 4000 rows in input order, the first
    batch's 64 probabilities against the same command on the CPU, the
    f32 tensor-core eval forward's launch count (the bf16 one's must stay
    0); file-to-file seconds and pairs/s, and where the time goes;
11. the ``kernels`` line (thirty-seven kernels, each with launches > 0 on
    a main path and every key of the contract; the bf16 tensor-core
    forward (both variants), sweep and wgrad with ``fit_launches``,
    ``train_cli_launches`` and ``data_parallel_launches``, their launches
    in phases fit, train_cli and data_parallel (both ranks); the
    f32 and bf16 eval forwards with ``variational_launches`` (phase
    variational's launches on grouped weights) and ``grouped_*`` fields
    (its checks and times); the tensor-core forward and lite sweep at 288
    and the f32 forward, bf16 forward, sweep and wgrad at H = 80 as
    ``h288_*`` and ``h80_*`` fields of their kernels' entries, the bf16
    forward and sweep at E = H = 72 as ``h72_*``; the op's bf16
    tensor-core forward at H = 64 as an entry of its own, and its f32 one
    from the f32 recurrence-backend steps, and its f32 wgrad
    ``lstm_recurrence_wgrad_f32`` from them (its tiles at 64, 128 and 288,
    the steps in turns with the wgrad pinned to ``lstm_recurrence_wgrad.cu``,
    which runs on no path, by name beside it: ``cuda_core_ms``); the bf16
    sweep at embedding 16 as ``h16_*`` / ``h16s_*`` fields of
    ``bilstm_bwd_mma``'s entry (``bilstm_bwd.cu``, on no path, by name
    beside them); the bf16 forward's instances at embedding 56 as ``h56_*``
    / ``h56s_*`` and the others that took shapes from the deleted
    ``bilstm_fwd.cu`` as ``k8_*`` fields of its entries; the f32 wgrad's
    64-row tile at embedding 80 as ``h80_*`` (its tiles) and at the other
    f32 shapes as ``narrow_*`` fields of its entry; the one-block f32 wide forward's
    main path f32 at 96; the op's f32 sweep and forward at 96-288 from the
    f32 one-layer model at embedding 128, and its bf16 sweep and forward
    from the bf16 one; the
    bf16 tensor-core forward at 160-224 as ``hN_*`` fields of its entries;
    the split bf16 weight gradient (``dW_hh`` on ``bilstm_wgrad_mma``,
    ``dW_ih`` on cuBLAS) as ``split_hN_*`` fields of ``bilstm_wgrad_mma``'s
    entry (phase wide_kernel's ``wgrad_split``); the bf16 op
    past 288, the f32 forward and sweep past 288, the f32 tensor-core lite
    sweep, the one-block lite sweeps at 96 and the f32 tensor-core gates
    and wide forward as entries of their own, the last with ``hN_*`` fields
    at 288, 256 and 128), the card's name and power limit, and the result.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the repository beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# serve path: bulk rung of 400 pairs = 800 encoder rows, top bucket 1500
B_SERVE, T_SERVE, H_SERVE, E_SERVE = 800, 1500, 64, 64
# train path: 80 pairs x 5 encoder calls = 400 rows in 5 weight groups
PAIRS_TRAIN, G_TRAIN = 80, 5
B_TRAIN = PAIRS_TRAIN * G_TRAIN
T_TRAIN = 1500
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the scaled configuration: BASELINE.json configs[4],
# tools/experiment_scaled_config.py:27-33 (embedding = hidden 256, 3 layers)
E_SCALED, LAYERS_SCALED = 256, 3
# H100 SXM published peaks (dense): f32 on CUDA cores, bf16 and tf32 on
# tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
AAS = "ACDEFGHIKLMNPQRSTVWY"
# the bf16 resident shapes (H, E) the tensor-core forward took from the
# deleted bilstm_fwd.cu: both layers of the models of 1-56 units (K = E + H ends in
# a k8 step at five of them: 24 twice, 72, 120, 168)
K8_FWD_SHAPES = ((8, 8), (8, 16), (16, 8), (24, 24), (24, 48), (40, 40), (40, 80), (48, 80),
                 (48, 112), (56, 56), (56, 112))
# the f32 layers (Hp, E parts) that took the 3xTF32 wgrad's 64-row tile
# from the deleted bilstm_wgrad.cu, and the tiles timed at E = H = 80
NARROW_WGRAD_SHAPES = ((16, (8,)), (16, (8, 8)), (16, (16,)), (16, (16, 16)), (48, (40,)),
                       (48, (40, 40)), (48, (48,)), (48, (48, 48)), (80, (72,)), (80, (80,)))
WGRAD_TILES_80 = ((64, 160), (128, 160), (64, 64), (128, 128))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ build
def phase_build() -> dict:
    from intrepppid_tpu_torch.native import load_spm_library
    from intrepppid_tpu_torch.ops import _build
    from intrepppid_tpu_torch.ops.lstm_cuda import (
        FWD_WIDE_F32_WIDTHS,
        FWD_WIDE_MMA_ROWS,
        FWD_WIDE_MMA_WIDTHS,
        GATES_F32_SMEM,
        GATES_MMA_SMEM,
        LITE_F32_ROWS,
        LITE_F32_WIDTHS,
        LITE_MMA_ROWS,
        LITE_MMA_UNEVEN_ROWS,
        LITE_MMA_WIDTHS,
        REC_FWD_MID_F32_INSTANCES,
        REC_FWD_MID_F32_ROWS,
        REC_MID_MMA_INSTANCES,
        REC_MID_MMA_ROWS,
        REC_WGRAD_MMA_SMEM,
        REC_WIDE_F32_FWD_ROWS,
        REC_WIDE_F32_ROWS,
        REC_WIDE_MMA_ROWS,
        SMEM_LIMIT,
        WGRAD_F32_SMEM,
        WGRAD_F32_TILES,
        WGRAD_MMA_SMEM,
        bwd_f32_onestage_plan,
        bwd_f32_plan,
        bwd_launch_plan,
        bwd_mma_plan,
        fwd_f32_plan,
        fwd_mma_plan,
        fwd_wide_f32_rows,
        lite_f32_resident_plan,
        lite_mma_resident_plan,
        recurrence_f32_smem,
        recurrence_fwd_f32_smem,
        recurrence_mid_f32_fwd_stages,
        recurrence_mid_f32_smem,
        recurrence_mid_mma_smem,
        recurrence_mma_smem,
        recurrence_wgrad_f32_smem,
        recurrence_wide_f32_smem,
        recurrence_wide_mma_smem,
        wgrad_f32_smem,
        wide_smem,
    )

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        native = pool.submit(load_spm_library)
        libs = _build.build()
        native_ok = native.result() is not None
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for name, log in _build.build_logs.items()
    }
    # the kernel's shared memory is dynamic, so ptxas does not report it
    smem = {
        f"bwd {str(dtype).replace('torch.', '')} E={E}": bwd_launch_plan([E], H_SERVE, dtype)[2]
        for dtype in (torch.float32, torch.bfloat16)
        for E in (E_SERVE, 2 * H_SERVE)
    }
    for E_parts in ([E_SERVE], [H_SERVE, H_SERVE]):
        smem[f"bwd_mma bfloat16 E={sum(E_parts)}"] = bwd_mma_plan(
            E_parts, H_SERVE, torch.bfloat16)[1]
        smem[f"fwd_mma (static) bfloat16 E={sum(E_parts)}"] = fwd_mma_plan(
            E_parts, H_SERVE, torch.bfloat16)[1]
        smem[f"bwd_f32 float32 E={sum(E_parts)}"] = bwd_f32_plan(
            E_parts, H_SERVE, torch.float32)[1]
        for rows in (8, 16):
            smem[f"fwd_f32 float32 E={sum(E_parts)} rows={rows}"] = fwd_f32_plan(
                E_parts, H_SERVE, torch.float32, rows)[1]
    smem["bwd_f32_onestage float32 E=H=80"] = bwd_f32_onestage_plan([80], 80, torch.float32)[1]
    # the bf16 tensor-core sweep at K % 32 == 16 (K run to the next multiple of 32)
    for E_parts, H in (([8], 16), ([16], 16), ([16, 16], 16), ([8, 8], 32), ([24], 48)):
        smem[f"bwd_mma bfloat16 H={H} E={sum(E_parts)}"] = bwd_mma_plan(
            E_parts, H, torch.bfloat16)[1]
    smem["fwd_f32 float32 E=H=80 rows=8"] = fwd_f32_plan([80], 80, torch.float32, 8)[1]
    smem["bwd_lite_f32_resident float32 H=96"] = lite_f32_resident_plan(96, torch.float32)[1]
    smem["bwd_lite_mma_resident bfloat16 H=96"] = lite_mma_resident_plan(96, torch.bfloat16)[1]
    for H in (80, 72):
        smem[f"fwd_mma (static) bfloat16 E=H={H}"] = fwd_mma_plan([H], H, torch.bfloat16)[1]
    for H, E in K8_FWD_SHAPES:
        smem[f"fwd_mma (static) bfloat16 H={H} E={E}"] = fwd_mma_plan([E], H, torch.bfloat16)[1]
    smem[f"recurrence_bwd_mma H={H_SERVE}"] = recurrence_mma_smem(H_SERVE)
    smem[f"recurrence_bwd_f32 H={H_SERVE}"] = recurrence_f32_smem(H_SERVE)
    for H in (32, H_SERVE):
        smem[f"recurrence_fwd_f32 H={H}"] = recurrence_fwd_f32_smem(H)
    smem["wgrad_mma"] = WGRAD_MMA_SMEM
    smem["wgrad_f32"] = WGRAD_F32_SMEM
    for tile in WGRAD_F32_TILES:
        smem[f"wgrad_f32 {tile[0]}x{tile[1]}"] = wgrad_f32_smem(tile)
    smem["recurrence_wgrad_mma"] = REC_WGRAD_MMA_SMEM
    for tile_n in (128, 64):
        smem[f"recurrence_wgrad_f32 64x{tile_n}"] = recurrence_wgrad_f32_smem(tile_n)
    smem["gates_mma"] = GATES_MMA_SMEM
    for H in LITE_MMA_WIDTHS:
        for rows in LITE_MMA_ROWS if H % 128 == 0 else LITE_MMA_UNEVEN_ROWS:
            if wide_smem("lite_mma", H, rows) <= SMEM_LIMIT:
                smem[f"bwd_lite_mma H={H} rows={rows}"] = wide_smem("lite_mma", H, rows)
    for H in FWD_WIDE_MMA_WIDTHS:
        for rows in FWD_WIDE_MMA_ROWS:
            smem[f"fwd_wide_mma H={H} rows={rows}"] = wide_smem("fwd_mma", H, rows)
    for kind in ("fwd", "bwd"):
        for H in (320, 512, 1024):
            # the bf16 tensor-core kernels past 288, at each row tile they take
            for rows in REC_WIDE_MMA_ROWS[kind][1 if H <= 512 else 2]:
                smem[f"recurrence_{kind}_wide_mma H={H} rows={rows}"] = \
                    recurrence_wide_mma_smem(kind, H, rows)
            # the f32 tensor-core forward and sweep past 288
            table = REC_WIDE_F32_ROWS if kind == "bwd" else REC_WIDE_F32_FWD_ROWS
            for rows in table[1 if H <= 512 else 2]:
                smem[f"recurrence_{kind}_wide_f32 H={H} rows={rows}"] = \
                    recurrence_wide_f32_smem(H, rows, kind)
    for H in LITE_F32_WIDTHS:
        for rows in LITE_F32_ROWS:
            smem[f"bwd_lite_f32 H={H} rows={rows}"] = wide_smem("lite_f32", H, rows)
    smem["gates_f32"] = GATES_F32_SMEM
    for H in FWD_WIDE_F32_WIDTHS:
        for R in fwd_wide_f32_rows(H):
            smem[f"fwd_wide_f32 H={H} rows={R}"] = wide_smem("fwd_f32", H, R)
    # the op's bf16 tensor-core sweep and forward at 96-288, each instance
    for kind in ("bwd", "fwd"):
        for cluster, mid_widths in REC_MID_MMA_INSTANCES.items():
            for H in mid_widths:
                for rows in REC_MID_MMA_ROWS:
                    smem[f"recurrence_{kind}_mid_mma H={H} cluster={cluster} rows={rows}"] = \
                        recurrence_mid_mma_smem(kind, H, rows, cluster)
    # the op's f32 tensor-core forward at 96-288, each instance (its ring's
    # stages where fewer than five fit)
    for (cluster, resident), mid_widths in REC_FWD_MID_F32_INSTANCES.items():
        for H in mid_widths:
            for rows in REC_FWD_MID_F32_ROWS:
                stages = recurrence_mid_f32_fwd_stages(rows, cluster, -(-H // (8 * cluster)),
                                                       resident)
                if stages:
                    smem[f"recurrence_fwd_mid_f32 H={H} cluster={cluster} "
                         f"{'resident' if resident else 'l2'} rows={rows} stages={stages}"] = \
                        recurrence_mid_f32_smem(H, rows, cluster, resident, "fwd")
    out = {"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
           "kernels": sorted(libs), "ptxas": ptxas,
           "dynamic_smem_bytes": smem, "native_tokenizer": native_ok}
    emit(out)
    return out


# ----------------------------------------------------------------- kernel
def layer_inputs(B, T, E_parts, H, dtype, dev, seed, full_lengths=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = tuple(
        (torch.rand(T, B, e, generator=g, device=dev) * 2 - 1).to(dtype)
        for e in E_parts
    )
    k = 1.0 / H ** 0.5

    def u(*shape):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * k

    w_ih = u(2, 4 * H, sum(E_parts)).to(dtype).contiguous()
    w_hh = u(2, 4 * H, H).to(dtype).contiguous()
    bias = (u(2, 4 * H) + u(2, 4 * H)).contiguous()
    if full_lengths:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:
        lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[0], lengths[1], lengths[2] = 0, 1, T
        lengths[3::4] = T
    return parts, lengths, w_ih, w_hh, bias


def rel_err(got, want, tol):
    """(max abs error, whether it is within tol x max(1, max|want|))."""
    a, b = got.float(), want.float()
    e, scale = float((a - b).abs().max()), max(1.0, float(b.abs().max()))
    return e, e <= tol * scale


def scaled_err(got, want) -> float:
    """max |got - want| / max(1, max|want|): what the tolerances bound."""
    a, b = got.float(), want.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def time_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_work(B, T, E, H, size) -> tuple:
    """(flops, bytes) one bidirectional layer needs at full lengths:
    4H * (E + H) multiply-adds per row, step and direction; each input read
    once and each output written once."""
    flops = 2 * 2 * B * T * 4 * H * (E + H)
    nbytes = (T * B * E * size + 2 * T * B * H * size + B * 4
              + 2 * 4 * H * (E + H) * size + 2 * 4 * H * 4 + 2 * 2 * B * H * 4)
    return flops, nbytes


def phase_kernel(dev) -> dict:
    from intrepppid_tpu_torch.ops.lstm_cuda import (
        bilstm_layer_fwd,
        bilstm_layer_fwd_plain,
        fwd_kernel,
    )

    checks = []
    cases = [
        (B_SERVE, T_SERVE, H_SERVE, parts, dtype)
        for dtype in (torch.float32, torch.bfloat16)
        for parts in ([E_SERVE], [H_SERVE, H_SERVE])
    ] + [
        (96, 300, 32, parts, dtype)
        for dtype in (torch.float32, torch.bfloat16)
        for parts in ([32], [32, 32])
    ]
    for i, (B, T, H, E_parts, dtype) in enumerate(cases):
        args = layer_inputs(B, T, E_parts, H, dtype, dev, SEED + i)
        got = bilstm_layer_fwd(*args, dtype)
        want = bilstm_layer_fwd_plain(*args, dtype)
        torch.cuda.synchronize()
        names = ("hs_f", "hs_b", "hn", "cn")
        errs = {name: float((a.float() - b.float()).abs().max())
                for name, a, b in zip(names, got, want)}
        check = {"B": B, "T": T, "H": H, "E_parts": E_parts,
                 "dtype": str(dtype).replace("torch.", ""),
                 "kernel": fwd_kernel(E_parts, H, dtype),
                 "max_abs_err": errs, "tol": TOL[dtype]}
        checks.append(check)
        del got, want, args
        if not max(errs.values()) <= TOL[dtype]:
            emit({"phase": "kernel", "failed": check})
            raise AssertionError(f"bilstm kernel disagrees with its plain version: {check}")

    # the dispatched kernel (in f32 the 3xTF32 forward, in bf16 the
    # tensor-core one), timed twice
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        t = {"kernel": fwd_kernel([E_SERVE], H_SERVE, dtype), "kernel_ms": 0.0,
             "kernel_ms_again": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0}
        for E_parts in ([E_SERVE], [H_SERVE, H_SERVE]):
            args = layer_inputs(B_SERVE, T_SERVE, E_parts, H_SERVE, dtype, dev,
                                SEED, full_lengths=True)
            t["kernel_ms"] += time_ms(lambda: bilstm_layer_fwd(*args, dtype), 5)
            t["kernel_ms_again"] += time_ms(lambda: bilstm_layer_fwd(*args, dtype), 5)
            t["plain_ms"] += time_ms(lambda: bilstm_layer_fwd_plain(*args, dtype), 2)
            f, nb = layer_work(B_SERVE, T_SERVE, sum(E_parts), H_SERVE, size)
            t["flops"], t["bytes"] = t["flops"] + f, t["bytes"] + nb
            del args
        t["bound_ms"], t["bound_by"] = bound(
            [(t["flops"], t["bytes"], kernel_peak(dtype, t["kernel"]))])
        timings[name] = t

    # the kernel at the H = 32 width it also serves (the shapes of TPU
    # kernel row 3, lstm_pallas_layer.py:376 _fwd_pallas, at 2H != 128)
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        t = {"kernel": fwd_kernel([32], 32, dtype), "kernel_ms": 0.0, "kernel_ms_again": 0.0,
             "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0, "B": 96, "T": 300}
        for E_parts in ([32], [32, 32]):
            args = layer_inputs(96, 300, E_parts, 32, dtype, dev, SEED, full_lengths=True)
            t["kernel_ms"] += time_ms(lambda: bilstm_layer_fwd(*args, dtype), 5)
            t["kernel_ms_again"] += time_ms(lambda: bilstm_layer_fwd(*args, dtype), 5)
            t["plain_ms"] += time_ms(lambda: bilstm_layer_fwd_plain(*args, dtype), 2)
            f, nb = layer_work(96, 300, sum(E_parts), 32, size)
            t["flops"], t["bytes"] = t["flops"] + f, t["bytes"] + nb
        t["bound_ms"], t["bound_by"] = bound(
            [(t["flops"], t["bytes"], kernel_peak(dtype, t["kernel"]))])
        lstm = torch.nn.LSTM(32, 32, num_layers=2, bidirectional=True).to(dev).to(dtype)
        x = (torch.rand(300, 96, 32, device=dev) * 2 - 1).to(dtype)
        with torch.inference_mode():
            t["library_ms"] = time_ms(lambda: lstm(x), 5)
        del lstm, x
        timings[f"h32_{str(dtype).replace('torch.', '')}"] = t

    # cuDNN yardstick: the same two-layer bidirectional stack, full lengths
    lstm = torch.nn.LSTM(E_SERVE, H_SERVE, num_layers=2, bidirectional=True).to(dev)
    x = torch.rand(T_SERVE, B_SERVE, E_SERVE, device=dev) * 2 - 1
    with torch.inference_mode():
        lib_ms = time_ms(lambda: lstm(x), 5)
    del lstm, x
    timings["float32"]["library_ms"] = lib_ms
    out = {"phase": "kernel", "checks": checks, "timings": timings,
           "shape": {"B": B_SERVE, "T": T_SERVE, "H": H_SERVE,
                     "layers": "E=64 + E=2x64 (one bulk dispatch)"}}
    emit(out)
    return out


# ------------------------------------------------------------------ serve
def random_jax_params(seed: int, V=250, E=64, L=2) -> dict:
    """Seeded random weights in the JAX package's params-tree layout
    (numpy leaves), with torch's default initialisation."""
    rng = np.random.default_rng(seed)

    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def lin(i, o):
        return {"w": u(i ** -0.5, o, i), "b": u(i ** -0.5, o)}

    emb = rng.standard_normal((V, E)).astype(np.float32)
    emb[0] = 0.0
    k = E ** -0.5
    lstm = [
        {d: {"w_ih": u(k, 4 * E, E if l == 0 else 2 * E), "w_hh": u(k, 4 * E, E),
             "b_ih": u(k, 4 * E), "b_hh": u(k, 4 * E)} for d in ("fwd", "bwd")}
        for l in range(L)
    ]
    d = (2 * E - E) // 3
    proj = [lin(E, E + d), lin(E + d, E + 2 * d), lin(E + 2 * d, 2 * E)]
    return {
        "encoder": {"embedding": emb, "lstm": lstm, "fc": lin(E, E),
                    "projection": proj},
        "head": {"fc1": lin(E, E // 2), "fc2": lin(E // 2, 1)},
        "triplet_projection": lin(E, E),
    }


def profile_device(fn, top: int = 6, groups=None) -> dict:
    """Wall and device time of ``fn()`` under ``torch.profiler``: the sum
    of the kernels' and copies' durations (one stream, so they do not overlap),
    the idle share of the wall time, the device time by kernel name, and
    the host operators' own time (what keeps the host from feeding the
    device). ``groups`` maps a label to a substring of kernel names (or a
    tuple of them); the device time of each group, and of the rest, is
    summed too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name: dict = {}
    for evt in prof.events():
        # kernels and copies only: a user annotation (the optimizer's
        # "Optimizer.step#..." span) is mirrored onto the device timeline
        # and would count the kernels under it twice
        if evt.device_type == torch.autograd.DeviceType.CUDA and not (
                getattr(evt, "is_user_annotation", False) or evt.name.startswith("Optimizer.")):
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    device_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(((e.key, e.self_cpu_time_total) for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
           "idle_share": 1.0 - device_us / wall_us,
           "top_device_ms": {name[:80]: us / 1e3 for name, us in ranked},
           "top_host_self_ms": {name[:80]: us / 1e3 for name, us in host}}
    if groups:
        split = {label: 0.0 for label in groups}
        split["rest"] = 0.0
        for name, us in by_name.items():
            label = next((k for k, subs in groups.items()
                          if any(sub in name for sub in
                                 ((subs,) if isinstance(subs, str) else subs))), "rest")
            split[label] += us / 1e3
        out["device_ms_by_group"] = split
    return out


def http(base: str, path: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def phase_serve(dev, trunc_len=1500, bulk=400, n_concurrent=8) -> dict:
    from intrepppid_tpu_torch.cli.serve import Serve
    from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.ops.lstm_cuda import bilstm_layer_fwd_f32, bilstm_layer_fwd_mma
    from intrepppid_tpu_torch.serve import ScoringEngine
    from intrepppid_tpu_torch.utils.convert import (
        load_reference_checkpoint,
        save_reference_checkpoint,
    )

    spm = ROOT / "tests" / "fixtures" / "tiny_spm.model"
    rng = np.random.default_rng(SEED)

    def seq(n):
        return "".join(rng.choice(list(AAS), int(n)))

    small = [(seq(rng.integers(20, 300)), seq(rng.integers(20, 300)))
             for _ in range(4)]
    lens = rng.integers(50, trunc_len + 1, size=(bulk, 2))
    lens[0] = trunc_len
    big = [(seq(a), seq(b)) for a, b in lens]
    concurrent = [[(seq(rng.integers(20, 400)), seq(rng.integers(20, 400)))
                   for _ in range(4)] for _ in range(n_concurrent)]

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "model.ckpt"
        save_reference_checkpoint(random_jax_params(SEED), ckpt)
        t0 = time.perf_counter()
        server = Serve.start(
            weights_path=ckpt, spm_path=spm, host="127.0.0.1", port=0,
            trunc_len=trunc_len, batch_size=16, bulk_batch_size=bulk,
            device=str(dev), _block=False,
        )
        startup_s = time.perf_counter() - t0
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            # the main path: every request below goes through the f32
            # tensor-core forward, and none through the bf16 one
            bilstm_layer_fwd_mma.launches = bilstm_layer_fwd_f32.launches = 0
            bilstm_layer_fwd_f32.grouped_launches = 0
            health = http(base, "/healthz")
            p_small = http(base, "/score", {"pairs": small})["probabilities"]
            big_s, p_big = [], None
            for _ in range(3):
                t = time.perf_counter()
                p_big = http(base, "/score", {"pairs": big})["probabilities"]
                big_s.append(time.perf_counter() - t)
            with ThreadPoolExecutor(n_concurrent) as pool:
                p_conc = list(pool.map(
                    lambda req: http(base, "/score", {"pairs": req})["probabilities"],
                    concurrent,
                ))
            stats = http(base, "/statsz")
            launches, bf16_launches = bilstm_layer_fwd_f32.launches, bilstm_layer_fwd_mma.launches
            grouped = bilstm_layer_fwd_f32.grouped_launches
            # where a bulk request's time goes, without HTTP and JSON: the
            # engine call alone (token cache warm), then under the profiler
            engine_s = []
            for _ in range(3):
                t = time.perf_counter()
                server.engine.score_pairs(big)
                engine_s.append(time.perf_counter() - t)
            breakdown = profile_device(lambda: server.engine.score_pairs(big))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)

        probs = np.asarray(p_small + p_big + sum(p_conc, []), np.float64)
        if probs.shape != (4 + bulk + 4 * n_concurrent,) \
                or not np.all(np.isfinite(probs)) \
                or not np.all((probs > 0) & (probs < 1)):
            raise AssertionError("served probabilities are not finite values in (0, 1)")
        if launches <= 0 or bf16_launches != 0 or grouped != 0:
            raise AssertionError(
                f"the requests launched the f32 tensor-core forward {launches} times "
                f"({grouped} on grouped weights) and the bf16 one {bf16_launches} times "
                f"(want > 0 (0) and 0)")
        if health.get("status") != "ok" or health["model"]["device"] != str(dev):
            raise AssertionError(f"unexpected /healthz: {health}")

        # the port's CPU plain forward on the same ids: a CPU engine gives
        # the 400-pair request the same chunk, bucket and truncation
        t = time.perf_counter()
        cpu_net = intrepppid_network(0, use_projection=True, device="cpu")
        cpu_engine = ScoringEngine(
            cpu_net, load_reference_checkpoint(ckpt), SentencePieceTokenizer(spm),
            trunc_len=trunc_len, batch_size=16, bulk_batch_size=bulk,
        )
        ref = np.concatenate([cpu_engine.score_pairs(small),
                              cpu_engine.score_pairs(big)[:8]])
        cpu_s = time.perf_counter() - t
    got = np.concatenate([p_small, p_big[:8]])
    err = float(np.abs(got - ref).max())
    if not err <= 1e-4:
        raise AssertionError(f"served probabilities differ from the CPU forward by {err}")
    out = {
        "phase": "serve", "startup_s": startup_s,
        "requests": stats["requests"], "pairs_scored": stats["pairs_scored"],
        "errors": stats["errors"], "bulk_request_s": big_s,
        "pairs_per_s": bulk / float(np.median(big_s)),
        "p50_latency_ms": stats["latency_ms"]["p50"],
        "launches": launches, "bf16_launches": bf16_launches, "grouped_launches": grouped,
        "max_abs_err_vs_cpu": err, "cpu_reference_s": cpu_s,
        "engine_bulk_s": engine_s, "engine_bulk_profile": breakdown,
    }
    emit(out)
    return out


# ----------------------------------------------------------- train kernels
def train_layer_inputs(E_parts, H, G, dtype, dev, seed, full_lengths=False, T=T_TRAIN,
                       ny=None):
    """One train layer's operands at B_TRAIN rows: forward inputs, and the
    backward's dy streams (``ny`` per direction; by default two for the
    lower layer of the two-layer stack, one for the top) and final-state
    cotangents."""
    parts, lengths, w_ih, _, bias = layer_inputs(
        B_TRAIN, T, E_parts, H, dtype, dev, seed, full_lengths)
    g = torch.Generator(device=dev).manual_seed(seed + 100)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 2 - 1

    w_hh = (u(2, G, 4 * H, H) * H ** -0.5).to(dtype).contiguous()
    if not full_lengths:
        # the main path's per-call truncation gives every row of a group the
        # group's longest length: groups 0-2 at 0, 1 and T; 3-4 keep random
        # per-row values
        Bg = B_TRAIN // G_TRAIN
        lengths[: 3 * Bg] = torch.tensor([0, 1, T], dtype=torch.int32,
                                         device=dev).repeat_interleave(Bg)
    if ny is None:
        ny = 2 if len(E_parts) == 1 else 1
    dyf = tuple(u(T, B_TRAIN, H).to(dtype) for _ in range(ny))
    dyb = tuple(u(T, B_TRAIN, H).to(dtype) for _ in range(ny))
    return parts, lengths, w_ih, w_hh, bias, dyf, dyb, u(2, B_TRAIN, H), u(2, B_TRAIN, H)


def train_layer_work(E, H, size, ny, T=T_TRAIN, G=G_TRAIN):
    """(flops, bytes) of each train kernel for one layer at full lengths:
    multiply-adds x 2 over both directions, each input read once and each
    output written once."""
    rows = 2 * B_TRAIN * T  # (direction, row, step) triples
    stream = B_TRAIN * T * size
    weights = 2 * 4 * H * (E + G * H) * size + 2 * 4 * H * 4
    fwd = (2 * rows * 4 * H * (E + H),
           stream * E + weights + B_TRAIN * 4 + 4 * stream * H + 2 * 2 * B_TRAIN * H * 4)
    # the eval variant writes no cell streams
    fwd_eval = (fwd[0], fwd[1] - 2 * stream * H)
    # sweep: gate recompute 4H(E+H), dx 4H E, dh 4H H per (direction, row, step)
    bwd = (2 * rows * 4 * H * (2 * E + 2 * H),
           stream * E + 4 * stream * H + 2 * ny * stream * H + weights + B_TRAIN * 4
           + 2 * 2 * B_TRAIN * H * 4 + 2 * stream * E + 2 * stream * 4 * H)
    wgrad = (2 * rows * 4 * H * (E + H),
             2 * stream * 4 * H + stream * E + 2 * stream * H
             + 2 * 4 * H * (E + G * H) * 4)
    return {"fwd": fwd, "fwd_eval": fwd_eval, "bwd": bwd, "wgrad": wgrad}


def wgrad_library(dgc, parts, hs_f, hs_b, G):
    """cuBLAS products of the wgrad kernel's operands (its yardstick):
    dW_ih over all rows, dW_hh per weight group."""
    from intrepppid_tpu_torch.ops.lstm import prev_states

    T, B, H4 = dgc.shape[1:]
    N, Bg = T * B, B // G
    x = torch.cat(parts, dim=-1).reshape(N, -1)
    d = dgc.reshape(2, N, H4).transpose(1, 2)
    dg = dgc.view(2, T, G, Bg, H4).permute(0, 2, 4, 1, 3).reshape(2, G, H4, T * Bg)
    hp = prev_states(hs_f, hs_b).view(2, T, G, Bg, H4 // 4).permute(0, 2, 1, 3, 4).reshape(
        2, G, T * Bg, H4 // 4)
    return lambda: (torch.matmul(d, x), torch.matmul(dg, hp))


# the f32 kernels on the tensor cores: three tf32 products for each f32 one
TF32_X3 = ("bilstm_bwd_f32", "bilstm_fwd_f32", "lstm_recurrence_bwd_f32", "bilstm_wgrad_f32",
           "bilstm_bwd_f32_onestage", "lstm_recurrence_bwd_wide_f32",
           "lstm_recurrence_fwd_wide_f32", "bilstm_bwd_lite_f32", "bilstm_gates_f32",
           "bilstm_fwd_wide_f32", "bilstm_bwd_lite_f32_resident", "bilstm_fwd_wide_f32_resident",
           "lstm_recurrence_bwd_mid_f32", "lstm_recurrence_fwd_f32", "lstm_recurrence_fwd_mid_f32",
           "lstm_recurrence_wgrad_f32")


def kernel_peak(dtype, name: str = "") -> float:
    """Peak rate of a kernel's products: the f32 tensor-core kernels
    (``TF32_X3``) do three tf32 products for each f32 one (3xTF32); every
    other kernel runs at its dtype's rate (f32 on the CUDA cores)."""
    if name in TF32_X3:
        return PEAK_TF32_FLOPS / 3
    return PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def bound(parts) -> tuple:
    """(ms, bound_by): the least time the card could take for work done as
    ``parts``, each (flops, bytes, peak FLOP/s): the operations over their
    peaks or all bytes over the HBM rate, whichever is larger."""
    ops_ms = sum(f / p for f, _, p in parts) * 1e3
    bytes_ms = sum(b for _, b, _ in parts) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def add_bounds(t: dict, work: dict, dtype, peaks=None) -> None:
    """For each kernel k with work[k] = (flops, bytes): its bound (``bound``)
    at the dtype's peak, or at ``peaks[k]`` where given."""
    for k, (f, b) in work.items():
        peak = (peaks or {}).get(k, kernel_peak(dtype))
        t[f"{k}_flops"], t[f"{k}_bytes"] = f, b
        t[f"{k}_bound_ms"], t[f"{k}_bound_by"] = bound([(f, b, peak)])


def cudnn_stack_times(dev, dtype, E=E_SERVE, H=H_SERVE, layers=2) -> dict:
    """cuDNN yardstick: a bidirectional ``nn.LSTM`` (by default the
    manuscript two layers) at the train shape in ``dtype``, TF32 off: the
    training-mode forward, then the backward for the input alone and for
    input and weights (each the forward and backward together, less the
    forward), and the inference forward."""
    lstm = torch.nn.LSTM(E, H, num_layers=layers, bidirectional=True).to(dev).to(dtype)
    lstm.flatten_parameters()
    x = (torch.rand(T_TRAIN, B_TRAIN, E, device=dev) * 2 - 1).to(dtype).requires_grad_()
    dy = (torch.rand(T_TRAIN, B_TRAIN, 2 * H, device=dev) * 2 - 1).to(dtype)
    fwd_ms = time_ms(lambda: lstm(x), 5)
    full_ms = time_ms(lambda: torch.autograd.grad(lstm(x)[0], [x, *lstm.parameters()], dy), 5)
    for p in lstm.parameters():
        p.requires_grad_(False)
    data_ms = time_ms(lambda: torch.autograd.grad(lstm(x)[0], [x], dy), 5)
    with torch.inference_mode():
        inference_ms = time_ms(lambda: lstm(x), 5)
    # the training forward once more, last: whether the first reading held
    # more than the forward (a first call's algorithm search or allocation)
    fwd_again_ms = time_ms(lambda: lstm(x), 5)
    return {"cudnn_fwd_ms": fwd_ms, "cudnn_fwd_bwd_ms": full_ms,
            "cudnn_bwd_data_ms": data_ms - fwd_ms, "cudnn_bwd_ms": full_ms - fwd_ms,
            "cudnn_inference_ms": inference_ms, "cudnn_fwd_again_ms": fwd_again_ms}


def sweep_names(dxf, dxb):
    """Names of a sweep's outputs, in the order (*dxf, *dxb, dgc, dbias)."""
    return ([f"dxf{k}" for k in range(len(dxf))] + [f"dxb{k}" for k in range(len(dxb))]
            + ["dgc", "dbias"])


def ragged_sweep_check(dev) -> list:
    """The tensor-core sweeps against their twin where no size is round: 27
    rows in 3 weight groups of 9 (a short tile in each group), T = 1, rows
    of length 0, both layer shapes, in bf16 (``bilstm_bwd_mma``) and in f32
    (``bilstm_bwd_f32``); and the one-stage f32 sweep
    (``bilstm_bwd_f32_onestage``) at E = H = 80, T = 1 and 5."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_sweep

    B, G = 27, 3
    cases = [(cd, i, E_parts, H_SERVE, 1) for cd in (torch.bfloat16, torch.float32)
             for i, E_parts in enumerate(([E_SERVE], [H_SERVE, H_SERVE]))]
    cases += [(torch.float32, 0, [80], 80, T) for T in (1, 5)]
    out = []
    for cd, i, E_parts, H, T in cases:
        kernel = (L.bilstm_bwd_mma if cd == torch.bfloat16 else
                  L.bilstm_bwd_f32 if H <= 64 else L.bilstm_bwd_f32_onestage)
        g = torch.Generator(device=dev).manual_seed(SEED + 70 + i if H == H_SERVE else
                                                    SEED + 90 + T)

        def u(*shape, scale=1.0):
            return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * scale

        parts = tuple(u(T, B, e).to(cd) for e in E_parts)
        w_ih = u(2, 4 * H, sum(E_parts), scale=H ** -0.5).to(cd)
        w_hh = u(2, G, 4 * H, H, scale=H ** -0.5).to(cd)
        bias = u(2, 4 * H)
        lengths = torch.ones(B, dtype=torch.int32, device=dev)
        lengths[1::4] = T
        lengths[2::7] = min(3, T)
        lengths[::5] = 0
        ny = 2 - i
        dyf = tuple(u(T, B, H).to(cd) for _ in range(ny))
        dyb = tuple(u(T, B, H).to(cd) for _ in range(ny))
        hs_f, hs_b, _, _, cs_f, cs_b = bidir_layer(parts, lengths, w_ih, w_hh, bias, cd,
                                                   with_states=True)
        args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                u(2, B, H), u(2, B, H), cd)
        got, want = kernel(*args), bidir_layer_sweep(*args)
        torch.cuda.synchronize()
        flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
        res = {n: rel_err(a, b, TOL[cd])
               for n, a, b in zip(sweep_names(*got[:2]), flat(got), flat(want))}
        check = {"kernel": kernel.__name__, "B": B, "G": G, "T": T, "H": H, "E_parts": E_parts,
                 "dtype": str(cd).replace("torch.", ""),
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "train_kernel", "failed": check})
            raise AssertionError(f"the ragged sweep disagrees with its plain version: {check}")
    return out


def ragged_fwd_wgrad_check(dev) -> list:
    """The tensor-core forwards (both variants) and wgrad against their
    twins where no size is round: 27 rows in 3 weight groups of 9 (a short
    tile in each group), T = 1, rows of length 0, both layer shapes; the
    forward and wgrad in bf16, the 3xTF32 forward and wgrad in f32."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_wgrad

    H, B, G, T = H_SERVE, 27, 3, 1
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    out = []
    for cd, i, E_parts in ((cd, i, E_parts) for cd in (torch.bfloat16, torch.float32)
                           for i, E_parts in enumerate(([E_SERVE], [H, H]))):
        bf16 = cd == torch.bfloat16
        fwd_eval, fwd_train = ((L.bilstm_layer_fwd_mma, L.bilstm_layer_fwd_train_mma) if bf16
                               else (L.bilstm_layer_fwd_f32, L.bilstm_layer_fwd_train_f32))
        wgrad = L.bilstm_wgrad_mma if bf16 else L.bilstm_wgrad_f32
        g = torch.Generator(device=dev).manual_seed(SEED + 75 + i)

        def u(*shape, scale=1.0):
            return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * scale

        parts = tuple(u(T, B, e).to(cd) for e in E_parts)
        w_ih = u(2, 4 * H, sum(E_parts), scale=H ** -0.5).to(cd)
        w_hh = u(2, G, 4 * H, H, scale=H ** -0.5).to(cd)
        bias = u(2, 4 * H)
        lengths = torch.ones(B, dtype=torch.int32, device=dev)
        lengths[::4] = 0
        args = (parts, lengths, w_ih, w_hh, bias, cd)
        want = bidir_layer(*args, with_states=True)
        res = {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(names, fwd_train(*args), want)}
        res.update({f"eval_{n}": rel_err(a, b, TOL[cd])
                    for n, a, b in zip(names, fwd_eval(*args), want[:4])})
        hs_f, hs_b = want[:2]
        dgc = u(2, T, B, 4 * H).to(cd)
        ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
        got = wgrad(dgc, parts, hs_f, hs_b, G)
        res["dW_ih"], res["dW_hh"] = (rel_err(got[0], ref[0], TOL[cd]),
                                      rel_err(got[1], ref[1], TOL[cd]))
        torch.cuda.synchronize()
        check = {"kernel": ("bilstm_fwd_mma, bilstm_wgrad_mma" if bf16
                            else "bilstm_fwd_f32, bilstm_wgrad_f32"),
                 "B": B, "G": G, "T": T, "H": H,
                 "E_parts": E_parts, "dtype": str(cd).replace("torch.", ""),
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "train_kernel", "failed": check})
            raise AssertionError(f"a ragged forward or wgrad disagrees with its twin: {check}")
    return out


def ragged_80_96_check(dev) -> list:
    """The forward at E = H = 80 (both variants: in f32 ``bilstm_fwd_f32``'s
    320-thread instance, in bf16 ``bilstm_fwd_mma``'s <80, 80> one; in
    bf16 also its <72, 72> one), the one-block lite sweep at H = 96 (in
    f32 ``bilstm_bwd_lite_f32_resident``, in bf16
    ``bilstm_bwd_lite_mma_resident``), the one-block bf16 wide forward at
    96 (both variants, ``bilstm_fwd_wide_mma_resident``) and its f32 twin
    in three tf32 passes (``bilstm_fwd_wide_f32_resident``), the f32
    tensor-core lite sweep and wide forward (both variants) and the bf16
    tensor-core lite sweep at 160, 192 and 224 (``bilstm_bwd_lite_f32``,
    ``bilstm_fwd_wide_f32``, ``bilstm_bwd_lite_mma``) against their twins
    where no size is round: 27 rows in 3 weight groups
    of 9 (a short tile in each group), T = 1 and 5, rows of length 0, 1 and
    T, the 9 rows of the second group (a whole row tile) ending at T // 3 at
    most, the sweeps with two dy streams and with none; 1e-4 x max(1,
    max|ref|) in f32, 3e-2 in bf16."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import (
        bidir_layer,
        bidir_layer_sweep_lite,
        bidir_recurrence,
        input_gates,
    )

    B, G, out = 27, 3, []
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    for T in (1, 5):
        g = torch.Generator(device=dev).manual_seed(SEED + 180 + T)

        def u(*shape, scale=1.0):
            return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * scale

        lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
        lengths[:3] = torch.tensor([0, 1, T], dtype=torch.int32, device=dev)
        lengths[9:18] = torch.clamp(lengths[9:18], max=T // 3)
        for kernel, H, E_parts, cd in (
                ("bilstm_fwd_f32", 80, [80], torch.float32),
                ("bilstm_bwd_lite_f32_resident", 96, [48, 48], torch.float32),
                ("bilstm_fwd_mma", 80, [80], torch.bfloat16),
                ("bilstm_fwd_mma", 72, [72], torch.bfloat16),
                ("bilstm_bwd_lite_mma_resident", 96, [48, 48], torch.bfloat16),
                ("bilstm_fwd_wide_mma_resident", 96, [48, 48], torch.bfloat16),
                ("bilstm_fwd_wide_f32_resident", 96, [48, 48], torch.float32),
                ("bilstm_bwd_lite_f32", 160, [160], torch.float32),
                ("bilstm_bwd_lite_f32", 192, [96, 96], torch.float32),
                ("bilstm_bwd_lite_f32", 224, [224], torch.float32),
                ("bilstm_fwd_wide_f32", 160, [160], torch.float32),
                ("bilstm_fwd_wide_f32", 192, [96, 96], torch.float32),
                ("bilstm_fwd_wide_f32", 224, [224], torch.float32),
                ("bilstm_bwd_lite_mma", 160, [160], torch.bfloat16),
                ("bilstm_bwd_lite_mma", 192, [96, 96], torch.bfloat16),
                ("bilstm_bwd_lite_mma", 224, [224], torch.bfloat16),
                ("bilstm_fwd_wide_mma", 160, [160], torch.bfloat16),
                ("bilstm_fwd_wide_mma", 192, [96, 96], torch.bfloat16),
                ("bilstm_fwd_wide_mma", 224, [224], torch.bfloat16)):
            parts = tuple(u(T, B, e).to(cd) for e in E_parts)
            w_ih = u(2, 4 * H, sum(E_parts), scale=H ** -0.5).to(cd)
            w_hh = u(2, G, 4 * H, H, scale=H ** -0.5).to(cd)
            bias = u(2, 4 * H)
            if kernel.startswith("bilstm_fwd_wide"):
                xg = input_gates(parts, w_ih, bias, cd)
                want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
                got = getattr(L, kernel.replace("_wide", "_wide_train"))(xg, lengths, w_hh, cd)
                ev = getattr(L, kernel)(xg, lengths, w_hh, cd)
                res = {f"fwd_{n}": rel_err(a, b, TOL[cd]) for n, a, b in zip(names, got, want)}
                res.update({f"fwd_eval_{n}": rel_err(a, b, TOL[cd])
                            for n, a, b in zip(names, ev, want)})
                res["fwd_eval_vs_train_hs"] = (0.0, bool(torch.equal(ev[0], got[0])
                                                         and torch.equal(ev[1], got[1])))
                del got, ev, want
            elif kernel.startswith("bilstm_fwd"):
                sfx = kernel[len("bilstm_fwd"):]
                args = (parts, lengths, w_ih, w_hh, bias, cd)
                want = bidir_layer(*args, with_states=True)
                res = {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(
                    names, getattr(L, f"bilstm_layer_fwd_train{sfx}")(*args), want)}
                res.update({f"eval_{n}": rel_err(a, b, TOL[cd]) for n, a, b in zip(
                    names, getattr(L, f"bilstm_layer_fwd{sfx}")(*args), want)})
            else:
                xg = input_gates(parts, w_ih, bias, cd)
                hs_f, hs_b, _, _, cs_f, cs_b = bidir_recurrence(xg, lengths, w_hh, cd,
                                                                with_states=True)
                res = {}
                for ny in (2, 0):
                    dyf = tuple(u(T, B, H).to(cd) for _ in range(ny))
                    dyb = tuple(u(T, B, H).to(cd) for _ in range(ny))
                    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, u(2, B, H),
                            u(2, B, H), cd)
                    res[f"ny{ny}_dgates"] = rel_err(getattr(L, kernel)(*args),
                                                    bidir_layer_sweep_lite(*args), TOL[cd])
            torch.cuda.synchronize()
            check = {"kernel": kernel, "B": B, "G": G, "T": T, "H": H, "E_parts": E_parts,
                     "dtype": str(cd).replace("torch.", ""),
                     "max_abs_err": {n: e for n, (e, _) in res.items()},
                     "tol": f"{TOL[cd]} x max(1, max|ref|)"}
            out.append(check)
            if not all(ok for _, ok in res.values()):
                emit({"phase": "train_kernel", "failed": check})
                raise AssertionError(f"a ragged kernel at 72-224 disagrees: {check}")
    return out


def embedding_80_kernels(dev) -> dict:
    """Layer 0 of the two-layer model at embedding 80 (E = H = 80, 5 weight
    groups, two dy streams a direction from the stacked layer above, 400
    rows, T = 1500), the main path of these kernels, in f32 and bf16: in
    f32 the forward (both variants) ``bilstm_fwd_f32.cu`` (its 320-thread
    instance, three tf32 passes), the sweep ``bilstm_bwd_f32_onestage.cu``
    (three tf32 passes) and wgrad ``bilstm_wgrad_f32.cu`` (its 64 x 160
    tile, three tf32 passes); in bf16 the tensor-core forward
    ``bilstm_fwd_mma.cu`` and sweep ``bilstm_bwd_mma.cu`` (their <80, 80>
    instances) and ``bilstm_wgrad_mma.cu`` (its last gate tile masked: 4H =
    320). Each is held against its plain twin with the main path's lengths
    (groups at 0, 1 and T; in f32 ``bilstm_bwd.cu`` by name too, and the
    wgrad at each tile of ``WGRAD_TILES_80``; the bf16 forward the same bits
    twice), then
    timed at full lengths beside the twin (timed once, in the check), its
    bound (the f32 tensor-core kernels at 495/3 TFLOP/s, the others at
    their dtype's rate; the f32 wgrad's at 67 too), cuDNN's one-layer
    training forward, inference forward and backward for the input in the
    same dtype, and cuBLAS's products for wgrad, TF32 off; the f32 sweep in
    turns with ``bilstm_bwd.cu`` by name (new, old, old, new); in f32 each
    tile of ``WGRAD_TILES_80`` pinned, in turns with the dispatch's tile,
    with its splits and the blocks an SM the card holds. One dict per dtype
    and kernel: "fwd", "fwd_eval", "bwd", "wgrad"."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep, bidir_layer_wgrad

    E_parts, H, G, ny = [80], 80, G_TRAIN, 2
    picked = {torch.float32: ("bilstm_fwd_f32", "bilstm_bwd_f32_onestage", "bilstm_wgrad_f32"),
              torch.bfloat16: ("bilstm_fwd_mma", "bilstm_bwd_mma", "bilstm_wgrad_mma")}
    # the CUDA-core kernel asked for by name on the same operands, by (kernel, dtype)
    by_name = {("bwd", torch.float32): "bilstm_bwd"}
    wgrad_lib = L._kernels("bilstm_wgrad_f32")
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
    result = {}
    for cd in (torch.float32, torch.bfloat16):
        f32 = cd == torch.float32
        kernels = (L.fwd_kernel(E_parts, H, cd), L.sweep_kernel(E_parts, H, cd),
                   L.wgrad_kernel(E_parts, H, cd))
        if kernels != picked[cd]:
            raise AssertionError(f"embedding 80's forward, sweep and wgrad in {cd} are {kernels}")
        shape = {"B": B_TRAIN, "T": T_TRAIN, "H": H, "G": G, "E_parts": E_parts, "ny": ny,
                 "dtype": str(cd).replace("torch.", ""), "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out = {k: {"kernel": name, **shape} for k, name in (
            ("fwd", f"{picked[cd][0]} (train)"), ("fwd_eval", f"{picked[cd][0]} (eval)"),
            ("bwd", picked[cd][1]), ("wgrad", picked[cd][2]))}
        size = torch.empty((), dtype=cd).element_size()
        work = train_layer_work(sum(E_parts), H, size, ny)
        peaks = {"fwd": kernel_peak(cd, picked[cd][0]), "fwd_eval": kernel_peak(cd, picked[cd][0]),
                 "bwd": kernel_peak(cd, picked[cd][1]), "wgrad": kernel_peak(cd, picked[cd][2])}
        for full in (False, True):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, cd, dev, SEED + 30, full_lengths=full, ny=ny)
            fwd_args = (parts, lengths, w_ih, w_hh, bias, cd)
            calls = {"fwd": lambda: L.bilstm_layer_fwd_train(*fwd_args),
                     "fwd_eval": lambda: L.bilstm_layer_fwd(*fwd_args)}
            hs_f, hs_b, _, _, cs_f, cs_b = calls["fwd"]()
            args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn,
                    dcn, cd)
            calls["bwd"] = lambda: L.bilstm_bwd(*args)
            dgc = calls["bwd"]()[2]
            calls["wgrad"] = lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)
            # the CUDA-core kernel asked for by name on the same operands
            old = {"bwd": lambda: L.bilstm_bwd(*args, kernel="bilstm_bwd")}
            if full:
                for k, call in calls.items():
                    if (k, cd) in by_name:
                        # new, old, old, new: both kernels in one run, on one card
                        out[k]["ms"], out[k]["ms_again"], out[k]["cuda_core_ms"] = in_turns(
                            call, old[k], 3)
                        out[k]["cuda_core_bound_ms"], _ = bound(
                            [(*work[k], kernel_peak(torch.float32, by_name[k, cd]))])
                    else:
                        out[k]["ms"] = time_ms(call, 3)
                    add_bounds(out[k], {k: work[k]}, cd, peaks)
                out["wgrad"]["library_ms"] = time_ms(wgrad_library(dgc, parts, hs_f, hs_b, G), 3)
                if f32:
                    out["wgrad"]["wgrad_bound_67_ms"], _ = bound(
                        [(*work["wgrad"], PEAK_F32_FLOPS)])
                    # each tile pinned, in turns with the dispatch's
                    out["wgrad"]["tiles"] = {}
                    for tile in WGRAD_TILES_80:
                        a, b, c = in_turns(
                            lambda: L.bilstm_wgrad_f32(dgc, parts, hs_f, hs_b, G, tile=tile),
                            calls["wgrad"], 3)
                        m_t, n_t, splits = L.wgrad_f32_plan(T_TRAIN, B_TRAIN, G, E_parts, H,
                                                            L._sm_count(dev), tile)
                        out["wgrad"]["tiles"][f"{tile[0]}x{tile[1]}"] = {
                            "ms": a, "ms_again": b, "dispatch_ms": c, "splits": splits,
                            "blocks": m_t * n_t * splits * 2 * G,
                            "blocks_an_sm": wgrad_lib.bilstm_wgrad_f32_occupancy(*tile),
                            "stages": L.wgrad_f32_stages(tile),
                            "smem": L.wgrad_f32_smem(tile)}
            else:
                want, out["fwd"]["plain_ms"] = timed_once(
                    lambda: L.bilstm_layer_fwd_plain(*fwd_args, with_states=True))
                _, out["fwd_eval"]["plain_ms"] = timed_once(
                    lambda: L.bilstm_layer_fwd_plain(*fwd_args))
                ref, out["bwd"]["plain_ms"] = timed_once(lambda: bidir_layer_sweep(*args))
                ref_w, out["wgrad"]["plain_ms"] = timed_once(
                    lambda: bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G))
                gnames = sweep_names(*ref[:2])
                res = {"fwd": {n: rel_err(a, b, TOL[cd])
                               for n, a, b in zip(names, calls["fwd"](), want)},
                       "fwd_eval": {n: rel_err(a, b, TOL[cd])
                                    for n, a, b in zip(names, calls["fwd_eval"](), want)},
                       "bwd": {n: rel_err(a, b, TOL[cd])
                               for n, a, b in zip(gnames, flat(calls["bwd"]()), flat(ref))},
                       "wgrad": {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(
                           ("dW_ih", "dW_hh"), calls["wgrad"](), ref_w)}}
                if f32:
                    res["bwd"].update({f"cuda_core_{n}": rel_err(a, b, TOL[cd])
                                       for n, a, b in zip(gnames, flat(old["bwd"]()), flat(ref))})
                    for k in ("fwd", "fwd_eval"):
                        out[k]["scaled_err"] = max(scaled_err(a, b)
                                                   for a, b in zip(calls[k](), want))
                    ev, tr = calls["fwd_eval"](), calls["fwd"]()
                    res["fwd_eval"]["eval_vs_train_hs"] = (
                        max(float((a - b).abs().max()) for a, b in zip(ev[:2], tr[:2])),
                        all(torch.equal(a, b) for a, b in zip(ev[:2], tr[:2])))
                    del ev, tr
                out["bwd"]["scaled_err"] = max(scaled_err(a, b) for a, b in zip(
                    flat(calls["bwd"]()), flat(ref)))
                out["wgrad"]["scaled_err"] = max(scaled_err(a, b) for a, b in zip(
                    calls["wgrad"](), ref_w))
                if f32:
                    for tile in WGRAD_TILES_80:
                        res["wgrad"].update({
                            f"tile_{tile[0]}x{tile[1]}_{n}": rel_err(a, b, TOL[cd])
                            for n, a, b in zip(("dW_ih", "dW_hh"), L.bilstm_wgrad_f32(
                                dgc, parts, hs_f, hs_b, G, tile=tile), ref_w)})
                if not f32:
                    for k in ("fwd", "fwd_eval"):
                        got_f = calls[k]()
                        res[k]["twice"] = (0.0, all(torch.equal(a, b)
                                                    for a, b in zip(calls[k](), got_f)))
                        out[k]["scaled_err"] = max(scaled_err(a, b) for a, b in zip(got_f, want))
                        del got_f
                torch.cuda.synchronize()
                for k, r in res.items():
                    out[k]["max_abs_err"] = {n: e for n, (e, _) in r.items()}
                    if not all(ok for _, ok in r.values()):
                        emit({"phase": "train_kernel", "failed": out[k]})
                        raise AssertionError(
                            f"{out[k]['kernel']} disagrees with its twin: {out[k]}")
                del want, ref, ref_w, res
            del parts, hs_f, hs_b, cs_f, cs_b, args, fwd_args, calls, dgc, old
        lib = cudnn_stack_times(dev, cd, E=80, H=80, layers=1)
        for k, key in (("fwd", "cudnn_fwd_ms"), ("fwd_eval", "cudnn_inference_ms"),
                       ("bwd", "cudnn_bwd_data_ms")):
            out[k]["library_ms"] = lib[key]
        result[shape["dtype"]] = out
    return result


def in_turns(new, old, reps: int) -> tuple:
    """Two kernels on the same operands timed new, old, old, new in one run
    on one card: (first new ms, second new ms, mean old ms)."""
    a, b, c, d = time_ms(new, reps), time_ms(old, reps), time_ms(old, reps), time_ms(new, reps)
    return a, d, 0.5 * (b + c)


def phase_train_kernel(dev) -> dict:
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep, bidir_layer_wgrad

    layers = [([E_SERVE], G_TRAIN), ([H_SERVE, H_SERVE], 1)]
    H = H_SERVE
    err = rel_err
    checks = []
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    # the kernels the dispatch names: bf16 the tensor-core ones; f32 the
    # 3xTF32 tensor-core forward, sweep and wgrad
    picked = {torch.float32: ("bilstm_fwd_f32", "bilstm_bwd_f32", "bilstm_wgrad_f32"),
              torch.bfloat16: ("bilstm_fwd_mma", "bilstm_bwd_mma", "bilstm_wgrad_mma")}
    # the plain versions (Python loops over T) are timed here, once each
    plain_ms = {dtype: {"fwd": 0.0, "fwd_eval": 0.0, "bwd": 0.0, "wgrad": 0.0}
                for dtype in (torch.float32, torch.bfloat16)}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for i, (E_parts, G) in enumerate(layers):
            if (L.fwd_kernel(E_parts, H, dtype), L.sweep_kernel(E_parts, H, dtype),
                    L.wgrad_kernel(E_parts, H, dtype)) != picked[dtype]:
                raise AssertionError(f"unexpected kernels for {E_parts}, {dtype}")
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, dtype, dev, SEED + 10 + i)
            fwd_args = (parts, lengths, w_ih, w_hh, bias, dtype)
            got = L.bilstm_layer_fwd_train(*fwd_args)
            want, ms = timed_once(lambda: L.bilstm_layer_fwd_plain(*fwd_args, with_states=True))
            plain_ms[dtype]["fwd"] += ms
            res = {n: err(a, b, TOL[dtype]) for n, a, b in zip(names, got, want)}
            got = L.bilstm_layer_fwd(*fwd_args)
            res.update({f"eval_{n}": err(a, b, TOL[dtype]) for n, a, b in zip(names, got, want)})
            _, ms = timed_once(lambda: L.bilstm_layer_fwd_plain(*fwd_args))
            plain_ms[dtype]["fwd_eval"] += ms
            del got
            hs_f, hs_b, _, _, cs_f, cs_b = want
            bwd_args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                        dhn, dcn, dtype)
            ref, ms = timed_once(lambda: bidir_layer_sweep(*bwd_args))
            plain_ms[dtype]["bwd"] += ms
            ref_w, ms = timed_once(lambda: bidir_layer_wgrad(ref[2], parts, hs_f, hs_b, G))
            plain_ms[dtype]["wgrad"] += ms
            refs = list(ref[0]) + list(ref[1]) + list(ref[2:])
            gnames = sweep_names(*ref[:2])
            # the sweep the dispatch picks (a tensor-core kernel in either
            # dtype), and the CUDA-core kernel by name
            dxf, dxb, dgc, dbias = L.bilstm_bwd(*bwd_args)
            got = list(dxf) + list(dxb) + [dgc, dbias]
            res.update({n: err(a, b, TOL[dtype]) for n, a, b in zip(gnames, got, refs)})
            scaled = {}
            if not bf16:
                # the control the f32 tolerance must tell apart from the
                # kernels: the twins with their products in one tf32 pass (cuBLAS)
                torch.backends.cuda.matmul.allow_tf32 = True
                one_pass = bidir_layer_sweep(*bwd_args)
                one_pass_fwd = L.bilstm_layer_fwd_plain(*fwd_args, with_states=True)
                torch.backends.cuda.matmul.allow_tf32 = False
                fwd_got = L.bilstm_layer_fwd_train(*fwd_args)
                scaled = {"scaled_err": max(scaled_err(a, b) for a, b in zip(got, refs)),
                          "tf32_one_pass_scaled_err": max(scaled_err(a, b) for a, b in zip(
                              list(one_pass[0]) + list(one_pass[1]) + list(one_pass[2:]),
                              refs)),
                          "fwd_scaled_err": max(scaled_err(a, b) for a, b in zip(fwd_got, want)),
                          "fwd_tf32_one_pass_scaled_err": max(
                              scaled_err(a, b) for a, b in zip(one_pass_fwd, want))}
                del one_pass, one_pass_fwd, fwd_got
            del got
            old = L.bilstm_bwd(*bwd_args, kernel="bilstm_bwd")
            res.update({f"cuda_core_{n}": err(a, b, TOL[dtype]) for n, a, b in zip(
                gnames, list(old[0]) + list(old[1]) + list(old[2:]), refs)})
            del old
            dw_ih, dw_hh = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)
            res["dW_ih"], res["dW_hh"] = (err(dw_ih, ref_w[0], TOL[dtype]),
                                          err(dw_hh, ref_w[1], TOL[dtype]))
            if not bf16:
                scaled["wgrad_scaled_err"] = max(scaled_err(dw_ih, ref_w[0]),
                                                 scaled_err(dw_hh, ref_w[1]))
            torch.cuda.synchronize()
            check = {"layer": i, "B": B_TRAIN, "T": T_TRAIN, "H": H, "G": G,
                     "E_parts": E_parts, "dtype": str(dtype).replace("torch.", ""),
                     "kernels": picked[dtype],
                     "max_abs_err": {n: e for n, (e, _) in res.items()}, **scaled,
                     "tol": f"{TOL[dtype]} x max(1, max|ref|)"}
            checks.append(check)
            del parts, want, ref, ref_w, refs, dgc, dxf, dxb, bwd_args
            if not all(ok for _, ok in res.values()):
                emit({"phase": "train_kernel", "failed": check})
                raise AssertionError(f"a train kernel disagrees with its plain version: {check}")
    ragged = ragged_sweep_check(dev) + ragged_fwd_wgrad_check(dev) + ragged_80_96_check(dev)

    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        name = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        keys = ["fwd", "fwd_eval", "bwd", "wgrad"]
        t = {f"{k}_ms": 0.0 for k in keys}
        t["wgrad_library_ms"] = 0.0
        t.update({f"{k}_plain_ms": v for k, v in plain_ms[dtype].items() if v})
        # each kernel twice; the sweep in turns with the CUDA-core one
        t.update({f"{k}_ms_again": 0.0 for k in keys})
        t["bwd_cuda_core_ms"] = 0.0
        work = {k: [0.0, 0.0] for k in keys}
        for i, (E_parts, G) in enumerate(layers):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, dtype, dev, SEED + 20 + i, full_lengths=True)
            fwd_args = (parts, lengths, w_ih, w_hh, bias, dtype)
            hs_f, hs_b, _, _, cs_f, cs_b = L.bilstm_layer_fwd_train(*fwd_args)
            bwd_args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                        dhn, dcn, dtype)
            dgc = L.bilstm_bwd(*bwd_args)[2]
            calls = {
                "fwd": lambda: L.bilstm_layer_fwd_train(*fwd_args),
                "fwd_eval": lambda: L.bilstm_layer_fwd(*fwd_args),
                "bwd": lambda: L.bilstm_bwd(*bwd_args),
                "wgrad": lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G),
            }
            for k, new in calls.items():
                if k == "bwd":
                    # new, old, old, new: both kernels in one run, on one card
                    a, b, c = in_turns(new, lambda: L.bilstm_bwd(*bwd_args, kernel="bilstm_bwd"),
                                       3)
                    t["bwd_cuda_core_ms"] += c
                else:
                    a, b = time_ms(new, 5), time_ms(new, 5)
                t[f"{k}_ms"] += a
                t[f"{k}_ms_again"] += b
            t["wgrad_library_ms"] += time_ms(wgrad_library(dgc, parts, hs_f, hs_b, G), 5)
            for k, (f, b) in train_layer_work(sum(E_parts), H, size, len(dyf)).items():
                work[k][0] += f
                work[k][1] += b
            del parts, hs_f, hs_b, cs_f, cs_b, dgc, fwd_args, bwd_args, calls
        add_bounds(t, work, dtype, {"fwd": kernel_peak(dtype, picked[dtype][0]),
                                    "fwd_eval": kernel_peak(dtype, picked[dtype][0]),
                                    "bwd": kernel_peak(dtype, picked[dtype][1]),
                                    "wgrad": kernel_peak(dtype, picked[dtype][2])})
        t["kernels"] = picked[dtype]
        # the yardstick the port never calls: cuDNN in the same dtype
        t.update(cudnn_stack_times(dev, dtype))
        timings[name] = t

    out = {"phase": "train_kernel", "checks": checks, "ragged_checks": ragged,
           "timings": timings, "embedding_80": embedding_80_kernels(dev),
           "shape": {"B": B_TRAIN, "groups": G_TRAIN, "T": T_TRAIN, "H": H,
                     "layers": "E=64 (grouped W_hh) + E=2x64"}}
    emit(out)
    return out


# ------------------------------------------------------------------ train
def quintuplet_batch(rng, B, T, vocab=250) -> dict:
    """Synthetic quintuplet batch as bench.py builds it: ids in [1, vocab),
    lengths uniform in [T/2, T] with the first row at full length, random
    labels."""
    def ids():
        a = rng.integers(1, vocab, size=(B, T))
        lens = rng.integers(T // 2, T + 1, size=B)
        lens[0] = T
        for i, n in enumerate(lens):
            a[i, n:] = 0
        return a.astype(np.int32)

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = (rng.random(B) > 0.5).astype(np.int32)
    return batch


def train_counters():
    from intrepppid_tpu_torch.ops import lstm_cuda as L

    return {"bilstm_layer_fwd_train": L.bilstm_layer_fwd_train,
            "bilstm_layer_fwd_train_mma": L.bilstm_layer_fwd_train_mma,
            "bilstm_bwd": L.bilstm_bwd, "bilstm_bwd_mma": L.bilstm_bwd_mma,
            "bilstm_bwd_f32": L.bilstm_bwd_f32,
            "bilstm_bwd_f32_onestage": L.bilstm_bwd_f32_onestage,
            "bilstm_wgrad": L.bilstm_wgrad, "bilstm_wgrad_mma": L.bilstm_wgrad_mma,
            "bilstm_layer_fwd": L.bilstm_layer_fwd,
            "bilstm_layer_fwd_mma": L.bilstm_layer_fwd_mma,
            "bilstm_layer_fwd_f32": L.bilstm_layer_fwd_f32,
            "bilstm_layer_fwd_train_f32": L.bilstm_layer_fwd_train_f32,
            "bilstm_gates_mma": L.bilstm_gates_mma,
            "bilstm_wgrad_ih": L.bilstm_wgrad_ih,
            "bilstm_bwd_lite_mma": L.bilstm_bwd_lite_mma,
            "bilstm_fwd_wide_train_mma": L.bilstm_fwd_wide_train_mma,
            "bilstm_fwd_wide_mma": L.bilstm_fwd_wide_mma,
            "bilstm_wgrad_f32": L.bilstm_wgrad_f32,
            "lstm_recurrence_fwd": L.lstm_recurrence_fwd,
            "lstm_recurrence_fwd_mma": L.lstm_recurrence_fwd_mma,
            "lstm_recurrence_bwd": L.lstm_recurrence_bwd,
            "lstm_recurrence_bwd_mma": L.lstm_recurrence_bwd_mma,
            "lstm_recurrence_bwd_f32": L.lstm_recurrence_bwd_f32,
            "lstm_recurrence_wgrad": L.lstm_recurrence_wgrad,
            "lstm_recurrence_wgrad_mma": L.lstm_recurrence_wgrad_mma,
            "lstm_recurrence_wgrad_f32": L.lstm_recurrence_wgrad_f32,
            "lstm_recurrence_fwd_wide_mma": L.lstm_recurrence_fwd_wide_mma,
            "lstm_recurrence_bwd_wide_mma": L.lstm_recurrence_bwd_wide_mma,
            "lstm_recurrence_bwd_wide_f32": L.lstm_recurrence_bwd_wide_f32,
            "lstm_recurrence_fwd_wide_f32": L.lstm_recurrence_fwd_wide_f32,
            "bilstm_bwd_lite_f32": L.bilstm_bwd_lite_f32,
            "bilstm_bwd_lite_f32_resident": L.bilstm_bwd_lite_f32_resident,
            "bilstm_bwd_lite_mma_resident": L.bilstm_bwd_lite_mma_resident,
            "bilstm_gates_f32": L.bilstm_gates_f32,
            "bilstm_fwd_wide_train_f32": L.bilstm_fwd_wide_train_f32,
            "bilstm_fwd_wide_f32": L.bilstm_fwd_wide_f32,
            "bilstm_fwd_wide_train_mma_resident": L.bilstm_fwd_wide_train_mma_resident,
            "bilstm_fwd_wide_mma_resident": L.bilstm_fwd_wide_mma_resident,
            "bilstm_fwd_wide_train_f32_resident": L.bilstm_fwd_wide_train_f32_resident,
            "bilstm_fwd_wide_f32_resident": L.bilstm_fwd_wide_f32_resident,
            "lstm_recurrence_bwd_mid_f32": L.lstm_recurrence_bwd_mid_f32,
            "lstm_recurrence_bwd_mid_mma": L.lstm_recurrence_bwd_mid_mma,
            "lstm_recurrence_fwd_mid_mma": L.lstm_recurrence_fwd_mid_mma,
            "lstm_recurrence_fwd_f32": L.lstm_recurrence_fwd_f32,
            "lstm_recurrence_fwd_mid_f32": L.lstm_recurrence_fwd_mid_f32}


def phase_train(dev, warmup=2, steps=12) -> dict:
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.train import Trainer

    rng = np.random.default_rng(SEED)
    net = intrepppid_network(steps_per_epoch=100, compute_dtype=torch.bfloat16,
                             optimizer_type="ranger21_xx", device=dev, seed=SEED)
    trainer = Trainer(net, seed=SEED)
    batches = [quintuplet_batch(rng, PAIRS_TRAIN, T_TRAIN) for _ in range(4)]
    counters = train_counters()
    # the main path: every train step and the eval step below go through the kernels
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t = time.perf_counter()
        aux = trainer.train_step(batches[i % len(batches)])
        losses.append(aux["loss"].item())
        if i >= warmup:
            step_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    eval_loss = trainer.eval_step(batches[0])["loss"].item()
    eval_ms = (time.perf_counter() - t) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    breakdown = profile_device(
        lambda: trainer.train_step(batches[0])["loss"].item(), top=10,
        groups={"fwd_mma": "bilstm_fwd_mma_kernel", "fwd_f32": "bilstm_fwd_f32_kernel",
                "sweep_mma": "bilstm_bwd_mma_kernel", "sweep_f32": "bilstm_bwd_f32_",
                "sweep_cuda_core": "bilstm_bwd_kernel",
                "wgrad_mma": "bilstm_wgrad_mma_kernel", "wgrad_f32": "bilstm_wgrad_f32_kernel"})
    if not all(np.isfinite(losses + [eval_loss])):
        raise AssertionError(f"non-finite train loss: {losses}, eval {eval_loss}")
    new = ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma", "bilstm_bwd_mma",
           "bilstm_wgrad_mma")
    old = ("bilstm_layer_fwd_train", "bilstm_layer_fwd", "bilstm_bwd", "bilstm_bwd_f32",
           "bilstm_bwd_f32_onestage", "bilstm_wgrad", "bilstm_wgrad_f32", "bilstm_layer_fwd_f32",
           "bilstm_layer_fwd_train_f32")
    missing = [n for n in new if launches[n] <= 0]
    ran_old = [n for n in old if launches[n] != 0]
    if missing or ran_old:
        raise AssertionError(
            f"the bf16 train and eval steps never launched {missing}, or ran the CUDA-core "
            f"{ran_old}")
    del trainer, net
    f32 = f32_steps(dev, batches,
                    ("bilstm_layer_fwd_train_f32", "bilstm_bwd_f32", "bilstm_wgrad_f32"),
                    ("bilstm_layer_fwd_train_mma", "bilstm_bwd_mma", "bilstm_wgrad_mma",
                     "bilstm_wgrad", "bilstm_bwd", "bilstm_layer_fwd_train", "bilstm_layer_fwd",
                     "bilstm_bwd_f32_onestage"))
    # the default two-layer model at embedding 80, an eval step after its
    # train steps: layer 0 (E = H = 80) is resident, its forward (both
    # variants) the 3xTF32 bilstm_fwd_f32.cu in f32 and the tensor-core
    # bilstm_fwd_mma.cu (its <80, 80> instance) in bf16, its wgrad
    # bilstm_wgrad_f32.cu's 64-row tile in f32 and bilstm_wgrad_mma.cu (the masked
    # gate tile) in bf16, its sweep the one-stage 3xTF32 kernel in f32 and
    # the tensor-core bilstm_bwd_mma.cu in bf16, never bilstm_bwd.cu; the
    # stacked layer (E = 2 x 80) runs padded to H = 96 on the wide route:
    # the tensor-core input gates (in f32 bilstm_gates_f32), the forward (the
    # one-block bilstm_fwd_wide_f32_resident.cu in f32, three tf32 passes,
    # and bilstm_fwd_wide_mma_resident.cu in bf16, never bilstm_fwd_wide.cu), and the
    # one-block lite sweep, in f32 the 3xTF32 bilstm_bwd_lite_f32_resident.cu
    # and in bf16 bilstm_bwd_lite_mma_resident.cu; its weight gradients whole
    # (in bf16 not split at 96: no dW_ih products on cuBLAS)
    e80_expect = {
        torch.float32: ("bilstm_layer_fwd_train_f32", "bilstm_layer_fwd_f32",
                        "bilstm_bwd_f32_onestage", "bilstm_gates_f32",
                        "bilstm_fwd_wide_train_f32_resident", "bilstm_fwd_wide_f32_resident",
                        "bilstm_bwd_lite_f32_resident", "bilstm_wgrad_f32"),
        torch.bfloat16: ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma", "bilstm_bwd_mma",
                         "bilstm_gates_mma", "bilstm_fwd_wide_train_mma_resident",
                         "bilstm_fwd_wide_mma_resident", "bilstm_bwd_lite_mma_resident",
                         "bilstm_wgrad_mma")}
    e80_never = {
        torch.float32: ("bilstm_layer_fwd_train", "bilstm_layer_fwd", "bilstm_wgrad_ih",
                        "bilstm_wgrad",
                        "bilstm_bwd", "bilstm_bwd_f32", "bilstm_bwd_mma", "bilstm_gates_mma",
                        "bilstm_wgrad_mma", "bilstm_fwd_wide_f32", "bilstm_fwd_wide_train_f32",
                        "bilstm_layer_fwd_mma", "bilstm_bwd_lite_mma", "bilstm_bwd_lite_f32",
                        "bilstm_bwd_lite_mma_resident", "bilstm_fwd_wide_train_mma_resident",
                        "bilstm_fwd_wide_mma_resident"),
        torch.bfloat16: ("bilstm_layer_fwd_f32", "bilstm_layer_fwd_train_f32",
                         "bilstm_bwd_f32_onestage", "bilstm_bwd", "bilstm_gates_f32",
                         "bilstm_wgrad_f32", "bilstm_wgrad", "bilstm_layer_fwd_train",
                         "bilstm_layer_fwd", "bilstm_bwd_lite_mma",
                         "bilstm_bwd_lite_f32_resident", "bilstm_fwd_wide_train_f32_resident",
                         "bilstm_fwd_wide_f32_resident", "bilstm_wgrad_ih")}
    e80 = {str(dtype).replace("torch.", ""): f32_steps(
        dev, batches, e80_expect[dtype], e80_never[dtype], eval_step=True, dtype=dtype,
        embedding_size=80) for dtype in (torch.float32, torch.bfloat16)}
    grad_check = train_grad_check(dev)
    grad_check_80 = {str(dtype).replace("torch.", ""): train_grad_check(
        dev, dtype=dtype, eval_step=True, expect=e80_expect[dtype], never=e80_never[dtype],
        embedding_size=80) for dtype in (torch.float32, torch.bfloat16)}
    grad_check_bf16 = train_grad_check(dev, dtype=torch.bfloat16)
    median = float(np.median(step_ms))
    out = {"phase": "train", "pairs": PAIRS_TRAIN, "T": T_TRAIN, "dtype": "bfloat16",
           "optimizer": "ranger21_xx", "dropout": 0.3, "step_ms": step_ms,
           "median_step_ms": median, "pairs_per_s": PAIRS_TRAIN / median * 1e3,
           "losses": losses, "eval_loss": eval_loss, "eval_step_ms": eval_ms,
           "launches": launches, "peak_memory_gib": peak_gib,
           "step_profile": breakdown, "float32_steps": f32,
           "steps_embedding_80": e80, "grad_check": grad_check,
           "grad_check_embedding_80": grad_check_80, "grad_check_bf16": grad_check_bf16}
    emit(out)
    return out


def f32_steps(dev, batches, expect, never, steps=2, eval_step=False, dtype=torch.float32,
              **widths) -> dict:
    """The same train step with the model in ``dtype`` (by default f32, the
    factory's default compute dtype), a main path of its own: the counts
    are set to 0 just before and read just after (with ``eval_step``, after
    an eval step that follows the train steps). The dispatch is by dtype
    and shape: the kernels in ``expect`` must launch and those in ``never``
    must not. ``widths`` (embedding_size, rnn_num_layers) as the factory
    takes them. Then one more step, profiled, after the counts are read."""
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.train import Trainer

    net = intrepppid_network(steps_per_epoch=100, compute_dtype=dtype,
                             optimizer_type="ranger21_xx", device=dev, seed=SEED, **widths)
    trainer = Trainer(net, seed=SEED)
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms = [], []
    for i in range(steps):
        t = time.perf_counter()
        losses.append(trainer.train_step(batches[i % len(batches)])["loss"].item())
        step_ms.append((time.perf_counter() - t) * 1e3)
    if eval_step:
        losses.append(trainer.eval_step(batches[0])["loss"].item())
    launches = {name: fn.launches for name, fn in counters.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite f32 train loss: {losses}")
    missing = [n for n in expect if launches[n] <= 0]
    wrong = [n for n in never if launches[n] != 0]
    if missing or wrong:
        raise AssertionError(f"the {dtype} train steps never launched {missing} or ran {wrong}")
    profile = profile_device(
        lambda: trainer.train_step(batches[0])["loss"].item(), top=10,
        groups={"fwd": ("bilstm_fwd_f32_kernel", "lstm_recurrence_fwd_kernel", "lstm_recurrence_fwd_mma_kernel",
                        "lstm_recurrence_fwd_mid_mma_kernel", "lstm_recurrence_fwd_f32_kernel",
                        "lstm_recurrence_fwd_mid_f32_kernel", "bilstm_fwd_mma_kernel",
                        "bilstm_fwd_wide_mma_kernel",
                        "bilstm_fwd_wide_mma_uneven_kernel",
                        "lstm_recurrence_fwd_wide_mma_kernel",
                        "lstm_recurrence_fwd_wide_f32_kernel", "bilstm_fwd_wide_f32_kernel",
                        "bilstm_fwd_wide_mma_resident_kernel",
                        "bilstm_fwd_wide_f32_resident_kernel"),
                "sweep": ("bilstm_bwd_f32_kernel", "bilstm_bwd_kernel",
                          "lstm_recurrence_bwd_f32_kernel", "bilstm_bwd_lite_kernel",
                          "bilstm_bwd_mma_kernel", "bilstm_bwd_lite_mma_kernel",
                          "bilstm_bwd_lite_mma_uneven_kernel",
                          "lstm_recurrence_bwd_mma_kernel", "lstm_recurrence_bwd_wide_mma_kernel",
                          "lstm_recurrence_bwd_wide_f32_kernel", "bilstm_bwd_lite_f32_kernel",
                          "bilstm_bwd_lite_f32_resident_kernel",
                          "bilstm_bwd_lite_mma_resident_kernel",
                          "lstm_recurrence_bwd_mid_f32_kernel",
                          "lstm_recurrence_bwd_mid_mma_kernel"),
                "wgrad": ("bilstm_wgrad_f32_kernel", "bilstm_wgrad_mma_kernel",
                          "lstm_recurrence_wgrad_kernel", "lstm_recurrence_wgrad_mma_kernel",
                          "lstm_recurrence_wgrad_f32_kernel"),
                "gates": "bilstm_gates",
                "gemm": ("gemm", "nvjet", "xmma")})
    return {"dtype": str(dtype).replace("torch.", ""), "steps": steps, "eval_step": eval_step,
            **widths,
            "step_ms": step_ms, "losses": losses, "launches": launches, "step_profile": profile}


def train_grad_check(dev, pairs=8, T=64, dtype=torch.float32, eval_step=False, expect=(),
                     never=(), **widths) -> dict:
    """One step's gradients on the card (the kernels) against the port's CPU
    plain path: same seeded weights and batch, every dropout rate 0;
    ``widths`` (embedding_size, rnn_num_layers) as the factory takes them.
    f32: tolerance 1e-4 x max(1, max|grad|) per parameter (f32 sums in
    another order, on the card and in the kernels, over T x 5 x pairs rows).
    bf16: 2^-7 x max(1, max|grad|): the streams (hs, cs, dgc, dx) are bf16
    on both sides and the kernels sum in another order, so a stream value
    may land one bf16 ulp (2^-8 relative) apart, and the tensor-core sweep
    takes its sigmoid and tanh from ex2 and a fast reciprocal. With
    ``eval_step``, an eval step of the same model on the same batch follows
    the backward (no grad: the eval-variant forwards), and its loss is held
    to the same tolerance. The card's steps are a main path of their own:
    the launch counts are set to 0 just before them and read just after
    (``launches``); each kernel named in ``expect`` must have launched, and
    none named in ``never``."""
    from intrepppid_tpu_torch.models.factory import intrepppid_network

    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    batch = quintuplet_batch(np.random.default_rng(SEED + 1), pairs, T)
    grads, eval_losses = {}, {}
    counters = train_counters()
    for device in (dev, torch.device("cpu")):
        net = intrepppid_network(steps_per_epoch=100, device=device, seed=SEED,
                                 compute_dtype=dtype,
                                 rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0,
                                 **widths)
        tb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if device == dev:
            for fn in counters.values():
                fn.launches = 0
        loss, _ = net.step(tb, torch.Generator(device=device).manual_seed(0), train=True)
        loss.backward()
        if eval_step:
            with torch.no_grad():
                eval_losses[device.type] = float(net.step(
                    tb, torch.Generator(device=device).manual_seed(0), train=False)[0])
        if device == dev:
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
        grads[device.type] = {n: p.grad.detach().float().cpu()
                              for n, p in net.named_parameters() if p.grad is not None}
    errs = {}
    for name, ref in grads["cpu"].items():
        got = grads["cuda"][name]
        errs[name] = float((got - ref).abs().max())
        if not errs[name] <= tol * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"card gradient of {name} differs from the CPU's by {errs[name]}")
    if set(grads["cpu"]) != set(grads["cuda"]) or not any(
            n.startswith("encoder.lstm.") for n in grads["cuda"]):
        raise AssertionError("the card's step did not reach the same parameters")
    missing = [n for n in expect if launches[n] <= 0]
    wrong = [n for n in never if launches[n] != 0]
    if missing or wrong:
        raise AssertionError(f"the card's step ({dtype}, {widths}) never launched {missing} "
                             f"or launched {wrong}")
    extra = {}
    if eval_step:
        extra["eval_loss_err"] = abs(eval_losses["cuda"] - eval_losses["cpu"])
        if not extra["eval_loss_err"] <= tol * max(1.0, abs(eval_losses["cpu"])):
            raise AssertionError(f"the card's eval loss differs from the CPU's: {eval_losses}")
    return {"pairs": pairs, "T": T, "dtype": str(dtype).replace("torch.", ""),
            "params": len(errs), **widths, **extra, "max_abs_err": max(errs.values()),
            "tol": f"{tol} x max(1, max|grad|)",
            "launches": {n: v for n, v in launches.items() if v}}


# ------------------------------------------------------------------ fit
# the bf16 tensor-core kernels of the manuscript width's training path, and
# the f32 and CUDA-core kernels that path must never launch
FIT_BF16 = ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma", "bilstm_bwd_mma",
            "bilstm_wgrad_mma")
FIT_NEVER = ("bilstm_layer_fwd_train", "bilstm_layer_fwd", "bilstm_bwd", "bilstm_bwd_f32",
             "bilstm_bwd_f32_onestage", "bilstm_wgrad", "bilstm_wgrad_f32",
             "bilstm_layer_fwd_f32", "bilstm_layer_fwd_train_f32")


class FitModule:
    """In-memory data module with the three iterators ``Trainer.fit`` and
    ``test`` read, from ``quintuplet_batch`` at the train shape: ``train``
    batches an epoch (the last one of ``tail`` pairs, so a short batch runs
    as it is), then ``val`` and ``test`` batches; the same batches every
    epoch."""

    def __init__(self, rng, train=6, pairs=PAIRS_TRAIN, tail=PAIRS_TRAIN // 2, val=2, test=2,
                 T=T_TRAIN):
        self.train = [quintuplet_batch(rng, pairs, T) for _ in range(train - 1)]
        self.train.append(quintuplet_batch(rng, tail, T))
        self.val = [quintuplet_batch(rng, pairs, T) for _ in range(val)]
        self.test = [quintuplet_batch(rng, pairs, T) for _ in range(test)]

    def train_batches(self, epoch):
        return iter(self.train)

    def val_batches(self):
        return iter(self.val)

    def test_batches(self):
        return iter(self.test)


def fit_network(dev, steps_per_epoch, epochs):
    """The manuscript network in bf16 with ``ranger21_xx``, dropout at its
    defaults."""
    from intrepppid_tpu_torch.models.factory import intrepppid_network

    return intrepppid_network(steps_per_epoch=steps_per_epoch, num_epochs=epochs,
                              compute_dtype=torch.bfloat16, optimizer_type="ranger21_xx",
                              device=dev, seed=SEED)


def fit_trainer(dev, chkpt_dir, steps_per_epoch, epochs):
    """``fit_network``'s ``Trainer`` with SWA on and every checkpoint kept."""
    from intrepppid_tpu_torch.train import Trainer

    return Trainer(fit_network(dev, steps_per_epoch, epochs), chkpt_dir, "intrepppid",
                   seed=SEED, keep_all_checkpoints=True)


def nondeterministic_grads(dev, batch) -> list:
    """The parameters whose gradients differ between two identical bf16
    steps (same weights, batch and dropout stream) on the card."""
    grads = []
    for _ in range(2):
        net = fit_network(dev, 100, 3).train()
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, _ = net.step(tb, torch.Generator(device=dev).manual_seed(0), train=True)
        loss.backward()
        grads.append({n: p.grad for n, p in net.named_parameters() if p.grad is not None})
    return [n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n])]


def phase_fit(dev, train_pairs_per_s, keep: Path, epochs=3) -> dict:
    """``Trainer.fit`` at the manuscript width (bf16, ``ranger21_xx``,
    dropout on, SWA on, every checkpoint kept in a temporary directory) for
    ``epochs`` epochs of 6 batches (5 of 80 pairs and one of 40, T = 1500),
    2 val batches an epoch, then ``test("best")`` on 2 test batches: the
    main path, its counts set to 0 just before ``fit`` and read just after
    ``test``. Each epoch's clock, pairs/s and losses from the trainer's
    logger, and each ``_save_epoch``'s ms and bytes. Checks: every loss
    finite; the bf16 tensor-core kernels launched and no f32 or CUDA-core
    one (phase train's lists); ``test("best")`` equal to eval steps of a
    fresh network loaded from the best checkpoint's ``state.pt``; and a
    fresh trainer's ``fit`` from the epoch-0 checkpoint (in a copy of the
    directory) ending at the straight run's weights and SWA average within
    2^-7 x max(1, max|w|). The best checkpoint is copied to
    ``keep/run/chkpt`` for phase export."""
    import shutil

    dm = FitModule(np.random.default_rng(SEED + 29))
    steps = len(dm.train)
    counters = train_counters()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        trainer = fit_trainer(dev, tmp / "straight", steps, epochs)
        saves = []
        save_epoch = trainer._save_epoch

        def timed_save(epoch, val_loss):
            t = time.perf_counter()
            path = save_epoch(epoch, val_loss)
            saves.append({"epoch": epoch, "ms": (time.perf_counter() - t) * 1e3,
                          "bytes": sum(f.stat().st_size for f in path.iterdir())})
            return path

        trainer._save_epoch = timed_save
        for fn in counters.values():
            fn.launches = 0
        trainer.fit(dm)
        test = trainer.test(dm, "best")
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        logs = trainer.loggers[0].metrics

        def col(key):
            return [e["value"] for e in logs[key]]

        losses = {k: col(k) for k in ("train_loss_step", "train_loss", "val_loss")}
        losses["test_loss"] = [test["test_loss"]]
        if not all(np.isfinite(v).all() for v in losses.values()):
            raise AssertionError(f"a fit loss is not finite: {losses}")
        missing = [n for n in FIT_BF16 if launches[n] <= 0]
        ran_old = [n for n in FIT_NEVER if launches[n] != 0]
        if missing or ran_old:
            raise AssertionError(f"fit never launched {missing}, or ran {ran_old}")

        # test("best") against eval steps of a fresh network loaded by hand
        best = trainer.checkpoints.best_checkpoint()
        fresh = fit_network(dev, steps, epochs)
        fresh.load_state_dict(torch.load(best / "state.pt", map_location=dev,
                                         weights_only=True)["params"])
        sums, rows = {}, 0
        for i, batch in enumerate(dm.test_batches()):
            aux = trainer.eval_step(batch, i, fresh)
            n = len(batch["label"])
            rows += n
            for k, v in aux.items():
                sums[k] = sums.get(k, 0.0) + float(v) * n
        hand = {f"test_{k}": v / rows for k, v in sums.items()}
        test_err = max(abs(test[k] - hand[k]) for k in hand)
        if sorted(hand) != sorted(test) or not all(
                abs(test[k] - hand[k]) <= 1e-6 * max(1.0, abs(hand[k])) for k in hand):
            raise AssertionError(f"test('best') {test} differs from the hand-loaded eval {hand}")

        # resume from epoch 0 in a copy of the run's directory
        epoch0 = next(p.name for p in (tmp / "straight").iterdir()
                      if p.name.startswith("intrepppid-epoch=00-"))
        shutil.copytree(tmp / "straight", tmp / "resumed")
        resumed = fit_trainer(dev, tmp / "resumed", steps, epochs)
        t = time.perf_counter()
        resumed.fit(dm, checkpoint_path=tmp / "resumed" / epoch0)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        pairs = [tuple({n: p.detach() for n, p in net.named_parameters()}
                       for net in (resumed.net, trainer.net)),
                 (resumed.swa.avg_params, trainer.swa.avg_params)]
        resume_err = max(scaled_err(a[n], b[n]) for a, b in pairs for n in b)
        bitwise = all(torch.equal(a[n], b[n]) for a, b in pairs for n in b)
        if resumed.swa.n_averaged != trainer.swa.n_averaged or not resume_err <= 2.0 ** -7:
            raise AssertionError(f"the resumed fit ends {resume_err} from the straight one")
        differing = [] if bitwise else nondeterministic_grads(dev, dm.train[0])
        checkpoints = sorted(p.name for p in (tmp / "straight").iterdir())
        shutil.copytree(best, keep / "run" / "chkpt" / best.name)
        state_keys = sorted(torch.load(best / "state.pt", map_location="cpu",
                                       weights_only=True))
    pairs_epoch = sum(len(b["label"]) for b in dm.train)
    out = {"phase": "fit", "epochs": epochs, "steps_per_epoch": steps,
           "pairs_per_epoch": pairs_epoch, "T": dm.train[0]["p1"].shape[1], "dtype": "bfloat16",
           "optimizer": "ranger21_xx", "dropout": 0.3, "swa_n_averaged": trainer.swa.n_averaged,
           "epoch_time_s": col("epoch_time_s"), "seq_pairs_per_s": col("seq_pairs_per_s"),
           "train_step_pairs_per_s": train_pairs_per_s,
           "train_loss": losses["train_loss"], "val_loss": losses["val_loss"],
           "train_loss_step": losses["train_loss_step"], "saves": saves,
           "checkpoints": checkpoints, "best": best.name, "state_keys": state_keys,
           "launches": launches, "test_best": test, "test_vs_hand_max_abs_err": test_err,
           "resume_max_scaled_err": resume_err, "resume_bitwise": bitwise,
           "resume_s": resume_s, "resume_tol": "2^-7 x max(1, max|w|)",
           "nondeterministic_grads": differing}
    emit(out)
    return out


# -------------------------------------------------------------- train_cli
def synthetic_tables(seed=SEED + 30, n_seqs=1200, n_groups=300, splits=(("train", 440),
                                                                         ("val", 160),
                                                                         ("test", 160))):
    """Seeded tables in the INTREPPPID schema, as ``ppi_oma.read_split``
    returns them: ``n_seqs`` sequences over the 20 amino acids with lengths
    uniform in [50, 1500] (as phase serve's), ``n_groups`` orthologue groups
    of 2-6 members (one member absent from the sequences), and per split
    interactions of two random proteins, half positive, each with an anchor
    drawn from a group and that group's id (one anchor absent from the
    sequences)."""
    rng = np.random.default_rng(seed)
    names = [f"P{i:05d}" for i in range(n_seqs)]
    sequences = {n: "".join(rng.choice(list(AAS), int(rng.integers(50, 1501))))
                 for n in names}
    members = {1000 + g: [names[i] for i in rng.choice(n_seqs, int(rng.integers(2, 7)),
                                                       replace=False)]
               for g in range(n_groups)}
    members[1000].append("MISSING_MEMBER")
    groups = sorted(members)
    tables = {}
    for split, n in splits:
        rows = []
        for i in range(n):
            p1, p2 = (names[j] for j in rng.choice(n_seqs, 2, replace=False))
            g = groups[int(rng.integers(len(groups)))]
            anchor = members[g][int(rng.integers(len(members[g])))]
            rows.append((p1, p2, anchor, g, bool(i % 2 == 0)))
        tables[split] = rows
    p1, p2, _, g, label = tables["train"][0]
    tables["train"][0] = (p1, p2, "MISSING_ANCHOR", g, label)
    return tables, sequences, members


# the data flags of a CLI run over ``synthetic_split_reader``'s tables
SYNTHETIC_DATA_FLAGS = ["--ppi_dataset_path", "synthetic.h5", "--sentencepiece_path",
                        str(ROOT / "tests" / "fixtures" / "golden_spm.model"), "--c_type", "3"]


@contextmanager
def synthetic_split_reader():
    """``ppi_oma.read_split`` replaced, inside the block, by
    ``synthetic_tables`` (the card's machine has no ``h5py``); yields the
    tables, sequences and groups."""
    from intrepppid_tpu_torch.data import ppi_oma

    tables, sequences, members = synthetic_tables()
    read_split = ppi_oma.read_split
    ppi_oma.read_split = lambda path, c_type, split: (list(tables[split]), sequences, members)
    try:
        yield tables, sequences, members
    finally:
        ppi_oma.read_split = read_split


def phase_train_cli(dev, train_pairs_per_s, fit, epochs=3) -> dict:
    """``python -m intrepppid_tpu_torch train e2e_rnn_triplet`` (through the
    CLI dispatcher) at the manuscript width, then ``eval e2e_rnn_triplet``
    on the best checkpoint's test split. The card's machine has no ``h5py``,
    so the one table-reading function (``ppi_oma.read_split``) is replaced,
    for this phase only, by ``synthetic_tables``; everything after the read
    is the port's own code: the data module tokenising every batch (5 x 80
    sequences, subword sampling on in training, 4 tokenizer threads) and
    bucketing it, the input pipeline, ``fit`` with SWA, ``test("best")``,
    the run's artifacts. The counts are set to 0 just before each command
    and read just after. Checks: every logged loss finite; the bf16
    tensor-core kernels launched in training and the eval forward in
    ``eval``, no f32 or CUDA-core kernel in either; the run directory's
    artifacts; ``eval``'s metrics equal to the run's ``test_results``
    within 1e-6 x max(1, |v|) (the same checkpoint, batches and kernels).
    Each epoch's clock and pairs/s beside phase fit's (pre-tokenised) and
    phase train's step rate, the host seconds each epoch spent in
    ``_make_batch``, the T buckets, the eval command's seconds."""
    from intrepppid_tpu_torch.__main__ import main as cli
    from intrepppid_tpu_torch.data import ppi_oma

    make_batch = ppi_oma.IntrepppidDataModule._make_batch
    made = []  # (split, host seconds, T) of every batch the data module made

    def timed_make_batch(self, ds, indices, sampling):
        t = time.perf_counter()
        batch = make_batch(self, ds, indices, sampling)
        made.append((ds.split, time.perf_counter() - t, int(batch["p1"].shape[1])))
        return batch

    ppi_oma.IntrepppidDataModule._make_batch = timed_make_batch
    counters = train_counters()
    data = SYNTHETIC_DATA_FLAGS
    try:
        with synthetic_split_reader() as (tables, sequences, members), \
                tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            for fn in counters.values():
                fn.launches = 0
            t = time.perf_counter()
            trainer, test = cli(["train", "e2e_rnn_triplet", *data, "--num_epochs", str(epochs),
                                 "--batch_size", str(PAIRS_TRAIN), "--vocab_size", "258",
                                 "--trunc_len", str(T_TRAIN), "--workers", "4", "--seed",
                                 str(SEED), "--precision", "bf16", "--log_path",
                                 str(tmp / "logs")])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t
            launches = {name: fn.launches for name, fn in counters.items()}
            run = tmp / "logs" / trainer.checkpoints.model_name
            best = trainer.checkpoints.best_checkpoint()
            artifacts = sorted(str(p.relative_to(run)) for p in run.rglob("*")
                               if p.parent in (run, run / "chkpt"))
            metrics = json.loads((run / "metrics.json").read_text())
            for fn in counters.values():
                fn.launches = 0
            t = time.perf_counter()
            evaluated = cli(["eval", "e2e_rnn_triplet", "--checkpoint_path", str(best), *data,
                             "--split", "test", "--batch_size", str(PAIRS_TRAIN), "--workers",
                             "4", "--seed", str(SEED), "--out_path", str(tmp / "eval.json")])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t
            eval_launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        ppi_oma.IntrepppidDataModule._make_batch = make_batch

    def col(key):
        return [e["value"] for e in metrics[key]]

    losses = {k: col(k) for k in ("train_loss_step", "train_loss", "val_loss", "test_loss")}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"a train_cli loss is not finite: {losses}")
    missing = [n for n in FIT_BF16 if launches[n] <= 0]
    ran_old = [n for n, c in (*launches.items(), *eval_launches.items())
               if n in FIT_NEVER and c != 0]
    if missing or ran_old or eval_launches["bilstm_layer_fwd_mma"] <= 0:
        raise AssertionError(f"train_cli never launched {missing} (eval forward "
                             f"{eval_launches['bilstm_layer_fwd_mma']}), or ran {ran_old}")
    want = {"hyperparams.json", "metrics.json", "chkpt", "chkpt/best.json"}
    epoch_dirs = [a for a in artifacts if a.startswith("chkpt/") and "-epoch=" in a]
    if not want <= set(artifacts) or not epoch_dirs:
        raise AssertionError(f"the run directory lacks an artifact: {artifacts}")
    (test_results,) = metrics["test_results"]
    if sorted(evaluated) != sorted(test_results) or sorted(test) != sorted(test_results):
        raise AssertionError(f"eval's metrics {sorted(evaluated)} are not the run's")
    eval_err = max(abs(evaluated[k] - v) for k, v in test_results.items())
    if not all(abs(evaluated[k] - v) <= 1e-6 * max(1.0, abs(v))
               for k, v in test_results.items()):
        raise AssertionError(f"eval {evaluated} differs from the run's test {test_results}")
    steps = trainer.net.steps_per_epoch
    train_made = [(s, T) for split, s, T in made if split == "train"]
    out = {"phase": "train_cli", "epochs": epochs, "steps_per_epoch": steps,
           "pairs_per_epoch": len(tables["train"]), "dtype": "bfloat16",
           "optimizer": trainer.net.optimizer_type, "dropout": 0.3, "workers": 4,
           "sequences": len(sequences), "groups": len(members),
           "interactions": {k: len(v) for k, v in tables.items()},
           "epoch_time_s": col("epoch_time_s"), "seq_pairs_per_s": col("seq_pairs_per_s"),
           "fit_epoch_time_s": fit["epoch_time_s"], "fit_seq_pairs_per_s": fit["seq_pairs_per_s"],
           "train_step_pairs_per_s": train_pairs_per_s,
           "make_batch_s_by_epoch": [sum(s for s, _ in train_made[e * steps:(e + 1) * steps])
                                     for e in range(epochs)],
           "make_batch_s_eval": sum(s for split, s, _ in made if split != "train"),
           "train_buckets": [T for _, T in train_made],
           "eval_buckets": [T for split, _, T in made if split != "train"],
           "train_command_s": train_s, "eval_command_s": eval_s,
           "train_loss": losses["train_loss"], "val_loss": losses["val_loss"],
           "test_results": test_results, "eval": evaluated, "eval_vs_test_max_abs_err": eval_err,
           "eval_tol": "1e-6 x max(1, |v|)", "best": best.name, "artifacts": artifacts,
           "launches": launches, "eval_launches": eval_launches}
    emit(out)
    return out


# ---------------------------------------------------------- data_parallel
# phase data_parallel: DP_STEPS train steps on fixed global batches of
# DP_PAIRS pairs (an uneven split over two ranks: 40 and 39 rows plus a
# weight-0 filler), and the kernel names its profile must hold
DP_STEPS, DP_PAIRS = 3, 79
DP_PROFILED = ("bilstm_fwd_mma", "bilstm_bwd_mma", "bilstm_wgrad_mma")
DP_TOKENS = ("p1", "p2", "anchor", "positive", "negative")


def dp_global_batches():
    rng = np.random.default_rng(SEED + 32)
    return [quintuplet_batch(rng, DP_PAIRS, T_TRAIN) for _ in range(DP_STEPS)]


def dp_local_batch(batch, rank: int, world: int) -> dict:
    """This rank's rows of a global batch as the data module makes them
    (``shard_batch_rows``, ``weight``, ``_global_rows``), its token arrays
    cut to its own longest row, as its own length bucket would cut them."""
    from intrepppid_tpu_torch.data.ppi_oma import shard_batch_rows

    n = len(batch["label"])
    idx, weight = shard_batch_rows(np.arange(n), world, rank)
    out = {k: v[idx] for k, v in batch.items()}
    if weight is not None:
        out["weight"] = weight
    out["_global_rows"] = np.int64(n)
    T = int(max((out[k] != 0).sum(1).max() for k in DP_TOKENS))
    out.update({k: out[k][:, :T] for k in DP_TOKENS})
    return out


def dp_steps(dev, rank: int = 0, world: int = 1, steps: int = DP_STEPS) -> dict:
    """``steps`` train steps of ``fit_network`` (bf16, ``ranger21_xx``,
    dropout on) on this rank's rows of each global batch (one process:
    the whole batches); the final weights on the host."""
    from intrepppid_tpu_torch.train import Trainer

    trainer = Trainer(fit_network(dev, 100, 3), seed=SEED)
    for batch in dp_global_batches()[:steps]:
        trainer.train_step(batch if world == 1 else dp_local_batch(batch, rank, world))
    torch.cuda.synchronize()
    return {n: p.detach().cpu() for n, p in trainer.net.named_parameters()}


def record_writes(root: Path) -> list:
    """Every file under ``root`` this process opens for writing or
    ``torch.save``s, and every tree it removes there, from now on."""
    import builtins
    import io
    import os
    import shutil

    writes = []
    real_open, real_rmtree, real_save = builtins.open, shutil.rmtree, torch.save

    def under(path):
        return isinstance(path, (str, os.PathLike)) and Path(os.path.abspath(path)).is_relative_to(root)

    def note(path, prefix=""):
        writes.append(prefix + str(Path(os.path.abspath(path)).relative_to(root)))

    def open_(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and under(file):
            note(file)
        return real_open(file, mode, *args, **kwargs)

    def rmtree(path, *args, **kwargs):
        if under(path):
            note(path, "rmtree ")
        return real_rmtree(path, *args, **kwargs)

    def save(obj, f, *args, **kwargs):
        if under(f):
            note(f)
        return real_save(obj, f, *args, **kwargs)

    builtins.open = io.open = open_
    shutil.rmtree = rmtree
    torch.save = save
    return writes


def gloo_cuda_collectives(dev) -> dict:
    """Which collectives a gloo group (here of one process) takes on CUDA
    tensors: ``ok`` or the first line of the backend's refusal."""
    import torch.distributed as dist

    group = dist.new_group(backend="gloo")
    probes = {
        "all_reduce": lambda t: dist.all_reduce(t, group=group),
        "broadcast": lambda t: dist.broadcast(t, 0, group=group),
        "reduce": lambda t: dist.reduce(t, 0, group=group),
        "all_gather": lambda t: dist.all_gather([torch.empty_like(t)], t, group=group),
        "all_gather_into_tensor": lambda t: dist.all_gather_into_tensor(
            torch.empty_like(t), t, group=group),
        "gather": lambda t: dist.gather(t, [torch.empty_like(t)], 0, group=group),
        "reduce_scatter_tensor": lambda t: dist.reduce_scatter_tensor(
            torch.empty_like(t), t, group=group),
    }
    out = {}
    for name, probe in probes.items():
        try:
            probe(torch.ones(4, device=dev))
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError, TypeError) as e:
            out[name] = (str(e).strip().splitlines() or [type(e).__name__])[0][:160]
    return out


def dp_cli_args(epochs: int, logs: Path, *extra) -> list:
    """``train e2e_rnn_triplet`` as phase train_cli runs it."""
    return ["train", "e2e_rnn_triplet", *SYNTHETIC_DATA_FLAGS, "--num_epochs", str(epochs),
            "--batch_size", str(PAIRS_TRAIN), "--vocab_size", "258", "--trunc_len", str(T_TRAIN),
            "--workers", "4", "--seed", str(SEED), "--precision", "bf16", "--log_path",
            str(logs), *extra]


def data_parallel_child(mode: str, rank: int, world: int, port: int, workdir: Path) -> int:
    """One process of phase data_parallel (``python3 chip_smoke.py
    data_parallel_child MODE RANK WORLD PORT WORKDIR``), on ``cuda:0``, its
    results in ``WORKDIR/{mode}_rank{rank}.json``.

    ``nccl1``: 2 of ``dp_steps`` without a group, then in an NCCL group of
    one, and the collectives a gloo group takes on CUDA tensors. ``ranks``: rank
    ``rank`` of a gloo group (two ranks share the card, which NCCL
    refuses): ``dp_steps`` on its rows, then ``train e2e_rnn_triplet
    --n_data_parallel WORLD`` over the synthetic tables, its counts set to
    0 just before and read just after, every file it writes recorded."""
    import os
    from datetime import timedelta

    import torch.distributed as dist

    from intrepppid_tpu_torch.__main__ import main as cli
    from intrepppid_tpu_torch.parallel import initialize_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # one intra-op thread a process, as torchrun sets for several processes
    # (OMP_NUM_THREADS=1): the ranks share the machine's cores
    torch.set_num_threads(1)
    dev = torch.device("cuda:0")
    result: dict = {"rank": rank}
    if mode == "nccl1":
        alone = dp_steps(dev, steps=2)
        initialize_distributed(dev, backend="nccl", timeout=timedelta(seconds=300))
        group = dp_steps(dev, steps=2)
        result.update(backend=dist.get_backend(), world=dist.get_world_size(),
                      bitwise=all(torch.equal(alone[n], group[n]) for n in alone),
                      max_scaled_err=max(scaled_err(group[n], alone[n]) for n in alone),
                      gloo_cuda=gloo_cuda_collectives(dev))
    else:
        initialize_distributed(dev, backend="gloo", timeout=timedelta(seconds=300))
        torch.save(dp_steps(dev, rank, world), workdir / f"steps_rank{rank}.pt")
        counters = train_counters()
        logs = (workdir / "logs").resolve()
        with synthetic_split_reader():
            writes = record_writes(logs)
            for fn in counters.values():
                fn.launches = 0
            t = time.perf_counter()
            trainer, test = cli(dp_cli_args(2, logs, "--n_data_parallel", str(world),
                                            "--device", "cuda:0"))
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t
            launches = {name: fn.launches for name, fn in counters.items()}
        torch.save({n: p.detach().cpu() for n, p in trainer.net.named_parameters()},
                   workdir / f"cli_rank{rank}.pt")
        result.update(backend=dist.get_backend(), model_name=trainer.checkpoints.model_name,
                      seed=trainer.seed, steps=trainer.global_step, test=test,
                      train_command_s=train_s, writes=writes,
                      launches={n: v for n, v in launches.items() if v})
    (workdir / f"{mode}_rank{rank}.json").write_text(json.dumps(result))
    return 0


def run_dp_children(mode: str, world: int, workdir: Path, timeout: float) -> list:
    """Start ``world`` processes of ``data_parallel_child`` together and
    wait for each at most ``timeout`` seconds; one that fails or hangs
    fails the phase (every child is stopped first). Their results, by
    rank."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    logs = [open(workdir / f"{mode}_rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "data_parallel_child", mode, str(r), str(world), str(port),
                               str(workdir)], cwd=str(ROOT), env=dict(os.environ),
                              stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    failed = []
    try:
        for r, proc in enumerate(procs):
            if proc.wait(timeout=timeout) != 0:
                failed.append(f"rank {r} exited {proc.returncode}")
    except subprocess.TimeoutExpired:
        failed.append(f"a {mode} process ran past {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    if failed:
        tails = [(workdir / f"{mode}_rank{r}.log").read_text()[-3000:] for r in range(world)]
        raise AssertionError(f"phase data_parallel: {failed}\n" + "\n".join(tails))
    return [json.loads((workdir / f"{mode}_rank{r}.json").read_text()) for r in range(world)]


def phase_data_parallel(dev, tcli) -> dict:
    """Data parallelism (``parallel/``) and ``--profile_dir`` on the card.

    (c) an NCCL group of one process: 2 bf16 steps bit for bit
    the same steps without a group (the backend multi-card runs use, on
    the path); (b) two gloo ranks on the one card take the same steps on
    their rows of 79-pair global batches (an uneven split, dropout on),
    bit-equal to each other and within 2^-7 x max(1, max|w|) of one
    process's steps on the whole batches; (a) the two ranks run ``train
    e2e_rnn_triplet --n_data_parallel 2`` at the manuscript width over
    phase train_cli's tables (2 epochs): the same run name, seed and final
    weights bit for bit, rank zero alone writing the run's files, and each
    rank's bf16 tensor-core kernels launched (the f32 and CUDA-core ones
    never). The two ranks share one card, so their epoch seconds are no
    multi-card rate. (d) a one-process ``train ... --profile_dir`` run of 3
    epochs: one ``*.pt.trace.json``, of epoch 0 alone (its optimizer
    steps), holding device events of the hand kernels ``DP_PROFILED``;
    its epoch 0 seconds beside epochs 1-2 and phase train_cli's."""
    from intrepppid_tpu_torch.__main__ import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t = time.perf_counter()
        (nccl,) = run_dp_children("nccl1", 1, tmp, timeout=300)
        nccl_s = time.perf_counter() - t
        if nccl["backend"] != "nccl" or not nccl["bitwise"]:
            raise AssertionError(f"the NCCL group of one steps differently: {nccl}")
        t = time.perf_counter()
        ranks = run_dp_children("ranks", 2, tmp, timeout=600)
        ranks_s = time.perf_counter() - t

        alone = dp_steps(dev)
        r0, r1 = (torch.load(tmp / f"steps_rank{r}.pt") for r in range(2))
        steps_bitwise = all(torch.equal(r0[n], r1[n]) for n in r0)
        steps_err = max(scaled_err(r0[n], alone[n]) for n in alone)
        if not steps_bitwise or not steps_err <= 2.0 ** -7:
            raise AssertionError(f"the 2-rank steps are {steps_err} from one process's "
                                 f"(ranks bit-equal: {steps_bitwise})")

        w0, w1 = (torch.load(tmp / f"cli_rank{r}.pt") for r in range(2))
        cli_bitwise = all(torch.equal(w0[n], w1[n]) for n in w0)
        name, seed = ranks[0]["model_name"], ranks[0]["seed"]
        run = tmp / "logs" / name
        metrics = json.loads((run / "metrics.json").read_text())
        epochs = [e["value"] for e in metrics["epoch_time_s"]]
        losses = [e["value"] for k in ("train_loss", "val_loss") for e in metrics[k]]
        wrote = set(ranks[0]["writes"])
        want = {f"{name}/hyperparams.json", f"{name}/metrics.json", f"{name}/chkpt/best.json"}
        missing = [n for r in ranks for n in FIT_BF16 if r["launches"].get(n, 0) <= 0]
        ran_old = [n for r in ranks for n in FIT_NEVER if r["launches"].get(n, 0)]
        if (not cli_bitwise or ranks[1]["model_name"] != name or ranks[1]["seed"] != seed
                or ranks[1]["writes"] or not want <= wrote
                or not any(w.endswith("/state.pt") for w in wrote)
                or not np.isfinite(losses).all() or missing or ran_old
                or ranks[0]["test"] != ranks[1]["test"]):
            raise AssertionError(
                f"the 2-rank train command: weights bit-equal {cli_bitwise}, names "
                f"{[r['model_name'] for r in ranks]}, seeds {[r['seed'] for r in ranks]}, "
                f"writes {[r['writes'] for r in ranks]}, losses {losses}, never launched "
                f"{missing}, ran {ran_old}")

        t = time.perf_counter()
        with synthetic_split_reader():
            trainer, _ = cli(dp_cli_args(3, tmp / "prof_logs", "--profile_dir",
                                         str(tmp / "prof")))
        torch.cuda.synchronize()
        profile_command_s = time.perf_counter() - t
        traces = sorted((tmp / "prof").glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"--profile_dir wrote {traces}")
        trace_bytes = traces[0].stat().st_size
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        profiled = {k: sum(k in n for n in kernel_names) for k in DP_PROFILED}
        # the host's annotation (the card's timeline mirrors it)
        opt_steps = sum(e.get("name", "").startswith("Optimizer.step#")
                        and e.get("cat") == "user_annotation" for e in events)
        prof_epochs = [e["value"] for e in trainer.loggers[0].metrics["epoch_time_s"]]
        if min(profiled.values()) <= 0 or opt_steps != trainer.net.steps_per_epoch:
            raise AssertionError(f"the trace holds kernels {profiled} and {opt_steps} "
                                 f"optimizer steps, not epoch 0's")
    out = {"phase": "data_parallel",
           "nccl_world_1": {"bitwise": nccl["bitwise"], "max_scaled_err": nccl["max_scaled_err"],
                            "steps": 2, "process_s": nccl_s},
           "gloo_cuda_collectives": nccl["gloo_cuda"],
           "steps_2_ranks": {"pairs": DP_PAIRS, "steps": DP_STEPS, "dtype": "bfloat16",
                             "dropout": 0.3, "ranks_bitwise": steps_bitwise,
                             "max_scaled_err_vs_one_process": steps_err, "tol": "2^-7 x max(1, max|w|)"},
           "train_2_ranks": {"backend": ranks[0]["backend"], "device": "cuda:0 (both ranks)",
                             "epochs": len(epochs), "epoch_time_s": epochs,
                             "train_cli_epoch_time_s": tcli["epoch_time_s"],
                             "train_command_s": [r["train_command_s"] for r in ranks],
                             "processes_s": ranks_s, "weights_bitwise": cli_bitwise,
                             "rank0_writes": sorted(wrote), "rank1_writes": ranks[1]["writes"],
                             "launches": [r["launches"] for r in ranks],
                             "note": "two ranks share one card: no multi-card rate"},
           "profile": {"epoch_time_s": prof_epochs, "command_s": profile_command_s,
                       "trace_bytes": trace_bytes, "optimizer_steps": opt_steps,
                       "kernel_events": profiled}}
    emit(out)
    return out


# ------------------------------------------------------------ variational
# the ablation configuration (BASELINE.json configs[2]) at the manuscript
# width: variational dropout on layer 0's forward W_hh, the triplet
# projection, bi_reduce mean
ABLATION = dict(variational_dropout=True, use_projection=True, bi_reduce="mean",
                rnn_dropout_rate=0.3)
ABLATION_FLAGS = ["--variational_dropout", "true", "--use_projection", "true", "--bi_reduce",
                  "mean"]
# the eval forwards' wrappers by dtype
EVAL_FWD = {torch.float32: "bilstm_layer_fwd_f32", torch.bfloat16: "bilstm_layer_fwd_mma"}


def grouped_counts():
    """The grouped launches of the tensor-core forwards (``.grouped_launches``:
    a launch on G > 1 weight groups), by wrapper name."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L

    return {n: getattr(L, n) for n in ("bilstm_layer_fwd_f32", "bilstm_layer_fwd_mma",
                                       "bilstm_layer_fwd_train_f32",
                                       "bilstm_layer_fwd_train_mma")}


@torch.no_grad()
def grouped_eval_checks(dev) -> list:
    """Layer 0's grouped eval forward of the ablation network on the card
    against its plain version on the same weights: ``w_hh (2, G, 4H, H)``
    drawn once from one generator (G row masks at p = 0.3), x and lengths
    mixing 0, 1, T and random values, G = 2 x 400 rows (the serve bucket)
    and G = 5 x 80 rows (a step), f32 and bf16; the kernel timed beside
    the plain version and its bound, in turns with the same rows on one
    weight group."""
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.ops.lstm import stack_layer_weights
    from intrepppid_tpu_torch.ops.lstm_cuda import (
        bilstm_layer_fwd,
        bilstm_layer_fwd_plain,
        fwd_kernel,
    )

    counts = grouped_counts()
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        net = intrepppid_network(0, device=dev, seed=SEED, compute_dtype=dtype, **ABLATION)
        for G, Bg in ((2, 400), (5, 80)):
            B = G * Bg
            layers = net.encoder.lstm_weights(
                False, G, torch.Generator(device=dev).manual_seed(SEED + G))
            w_ih, w_hh, bias = stack_layer_weights(layers[0], dtype)
            parts, lengths, _, _, _ = layer_inputs(B, T_TRAIN, [E_SERVE], H_SERVE, dtype, dev,
                                                   SEED + G)
            wrapper = counts[EVAL_FWD[dtype]]
            before = wrapper.grouped_launches
            args = (parts, lengths, w_ih, w_hh, bias, dtype)
            got = bilstm_layer_fwd(*args)
            torch.cuda.synchronize()
            if wrapper.grouped_launches != before + 1:
                raise AssertionError(f"the grouped eval forward did not launch {EVAL_FWD[dtype]}")
            t = time.perf_counter()
            want = bilstm_layer_fwd_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
            names = ("hs_f", "hs_b", "hn", "cn")
            check = {"G": G, "rows": B, "T": T_TRAIN, "dtype": str(dtype).replace("torch.", ""),
                     "kernel": fwd_kernel([E_SERVE], H_SERVE, dtype),
                     "max_abs_err": {n: float((a.float() - b.float()).abs().max())
                                     for n, a, b in zip(names, got, want)},
                     "scaled_err": max(scaled_err(a, b) for a, b in zip(got, want)),
                     "tol": f"{tol} x max(1, max|ref|)", "plain_ms": plain_ms}
            if not check["scaled_err"] <= tol:
                emit({"phase": "variational", "failed": check})
                raise AssertionError(f"the grouped eval forward disagrees with its plain "
                                     f"version: {check}")
            full = layer_inputs(B, T_TRAIN, [E_SERVE], H_SERVE, dtype, dev, SEED,
                                full_lengths=True)
            timed = (full[0], full[1], w_ih, w_hh, bias, dtype)
            # in turns with the same rows on one weight group (group 0's)
            one = (full[0], full[1], w_ih, w_hh[:, 0].contiguous(), bias, dtype)
            ms, ms_again, one_ms = in_turns(lambda: bilstm_layer_fwd(*timed),
                                            lambda: bilstm_layer_fwd(*one), 5)
            check.update({"ms": ms, "ms_again": ms_again, "ungrouped_ms": one_ms})
            size = torch.empty((), dtype=dtype).element_size()
            flops, nbytes = layer_work(B, T_TRAIN, E_SERVE, H_SERVE, size)
            nbytes += (G - 1) * 2 * 4 * H_SERVE * H_SERVE * size  # the G copies of W_hh
            check["bound_ms"], check["bound_by"] = bound(
                [(flops, nbytes, kernel_peak(dtype, check["kernel"]))])
            checks.append(check)
            del got, want, args, full, timed, one, parts
        del net
    return checks


def variational_grad_check(dev, dtype, pairs=8, T=64) -> dict:
    """One step's gradients and an eval step's loss of the ablation network
    (variational dropout at p = 0.3, the other dropouts 0) on the card
    against the port's CPU plain path, from the same row masks: both sides
    draw them from a CPU generator seeded alike. Tolerance as
    ``train_grad_check``'s. The card's step is a main path: its launches
    are counted, and layer 0's forwards (train and eval) must run grouped."""
    from intrepppid_tpu_torch.models import awd_lstm
    from intrepppid_tpu_torch.models.factory import intrepppid_network

    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    batch = quintuplet_batch(np.random.default_rng(SEED + 31), pairs, T)
    counters, grouped = train_counters(), grouped_counts()
    original = awd_lstm.variational_weight
    grads, eval_losses = {}, {}
    for device, side in ((dev, "card"), (torch.device("cpu"), "cpu")):
        masks = torch.Generator().manual_seed(SEED)

        def weight(w, p, gen, masks=masks):
            keep = (torch.rand((w.shape[0], 1), generator=masks) < 1.0 - p).to(w.device)
            return torch.where(keep, w / (1.0 - p), 0.0).to(w.dtype)

        awd_lstm.variational_weight = weight
        try:
            net = intrepppid_network(steps_per_epoch=100, device=device, seed=SEED,
                                     compute_dtype=dtype, embedding_droprate=0.0, do_rate=0.0,
                                     **ABLATION)
            tb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
            if side == "card":
                for fn in (*counters.values(), *grouped.values()):
                    fn.launches = 0
                for fn in grouped.values():
                    fn.grouped_launches = 0
            loss, _ = net.step(tb, torch.Generator(device=device).manual_seed(0), train=True)
            loss.backward()
            with torch.no_grad():
                eval_losses[side] = float(net.step(
                    tb, torch.Generator(device=device).manual_seed(0), train=False)[0])
        finally:
            awd_lstm.variational_weight = original
        if side == "card":
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            grouped_launches = {name: fn.grouped_launches for name, fn in grouped.items()}
        grads[side] = {n: p.grad.detach().float().cpu()
                              for n, p in net.named_parameters() if p.grad is not None}
    errs = {}
    for name, ref in grads["cpu"].items():
        errs[name] = float((grads["card"][name] - ref).abs().max())
        if not errs[name] <= tol * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"card gradient of {name} (variational dropout) differs "
                                 f"from the CPU's by {errs[name]}")
    if set(grads["cpu"]) != set(grads["card"]):
        raise AssertionError("the card's variational step did not reach the same parameters")
    eval_err = abs(eval_losses["card"] - eval_losses["cpu"])
    if not eval_err <= tol * max(1.0, abs(eval_losses["cpu"])):
        raise AssertionError(f"the card's variational eval loss differs: {eval_losses}")
    suffix = "f32" if dtype == torch.float32 else "mma"
    if min(grouped_launches[f"bilstm_layer_fwd_train_{suffix}"],
           grouped_launches[f"bilstm_layer_fwd_{suffix}"]) <= 0:
        raise AssertionError(f"the variational step never ran grouped forwards: "
                             f"{grouped_launches}")
    return {"pairs": pairs, "T": T, "dtype": str(dtype).replace("torch.", ""),
            "params": len(errs), "max_abs_err": max(errs.values()), "eval_loss_err": eval_err,
            "tol": f"{tol} x max(1, max|grad|)",
            "launches": {n: v for n, v in launches.items() if v},
            "grouped_launches": grouped_launches}


def serve_pairs(rng, n, trunc_len=T_SERVE):
    """``n`` pairs of random sequences, lengths in [50, trunc_len], the first
    at ``trunc_len`` (phase serve's bulk request)."""
    lens = rng.integers(50, trunc_len + 1, size=(n, 2))
    lens[0] = trunc_len
    return [tuple("".join(rng.choice(list(AAS), int(k))) for k in ab) for ab in lens]


def phase_variational(dev, serve, epochs=3) -> dict:
    """The ablation configuration (``BASELINE.json`` ``configs[2]``:
    variational dropout at ``rnn_dropout_rate`` 0.3, ``use_projection``,
    ``bi_reduce`` mean) at the manuscript width (vocab 250, E = H = 64, two
    layers, T = 1500). (a) Layer 0's grouped eval forward against its plain
    version (``grouped_eval_checks``) and a gradient step against the CPU
    (``variational_grad_check``), f32 and bf16. (b) The scoring engine
    (f32) on a 400-pair bulk request, twice: bit-equal scores, the f32
    tensor-core eval forward launched on grouped weights (phase serve
    checks that the network without it launches none), the bf16 one not at
    all, and scores unlike the same weights without the masks; pairs/s
    beside phase serve's (its HTTP requests and its engine calls). (c) ``train e2e_rnn_triplet`` with
    ``--variational_dropout true --use_projection true --bi_reduce mean``
    over ``synthetic_tables`` (bf16, 3 epochs of 440 pairs), then ``eval``
    on its best checkpoint twice, bit-equal: the bf16 tensor-core kernels
    launched in training (the forwards on grouped weights) and the grouped
    eval forward in ``eval``, no f32 or CUDA-core kernel. Each path's
    counts are set to 0 just before it and read just after."""
    from intrepppid_tpu_torch.__main__ import main as cli
    from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.serve import ScoringEngine

    kernel_checks = grouped_eval_checks(dev)
    grad_checks = [variational_grad_check(dev, dtype)
                   for dtype in (torch.float32, torch.bfloat16)]

    # (b) the engine
    counts = grouped_counts()
    net = intrepppid_network(0, device=dev, seed=SEED, **ABLATION)
    engine = ScoringEngine(net, None, SentencePieceTokenizer(ROOT / "tests" / "fixtures"
                                                             / "tiny_spm.model"),
                           trunc_len=T_SERVE, batch_size=16, bulk_batch_size=B_SERVE // 2)
    big = serve_pairs(np.random.default_rng(SEED + 32), B_SERVE // 2)
    for fn in counts.values():
        fn.launches = fn.grouped_launches = 0
    scores, bulk_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        scores.append(engine.score_pairs(big))
        bulk_s.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    engine_launches = {n: (fn.launches, fn.grouped_launches) for n, fn in counts.items()}
    if not all(np.array_equal(scores[0], s) for s in scores[1:]):
        raise AssertionError("the variational engine scored one request differently twice")
    if not (np.all(np.isfinite(scores[0])) and np.all((scores[0] > 0) & (scores[0] < 1))):
        raise AssertionError("variational scores are not finite values in (0, 1)")
    # the row masks act: the same weights without variational dropout score otherwise
    plain = intrepppid_network(0, device=dev, seed=SEED, **{**ABLATION,
                                                            "variational_dropout": False})
    plain.load_state_dict(net.state_dict())
    unmasked = ScoringEngine(plain, None, engine.spp, trunc_len=T_SERVE, batch_size=16,
                             bulk_batch_size=B_SERVE // 2).score_pairs(big)
    masks_shift = float(np.abs(scores[0] - unmasked).max())
    if not masks_shift > 0:
        raise AssertionError("the variational engine scores as the network without masks")
    f32_launches, f32_grouped = engine_launches["bilstm_layer_fwd_f32"]
    if f32_grouped <= 0 or 2 * f32_grouped != f32_launches \
            or engine_launches["bilstm_layer_fwd_mma"][0] != 0:
        raise AssertionError(f"the engine's launches {engine_launches}: want the f32 eval "
                             f"forward, layer 0 of each call grouped, and no bf16 one")
    del engine, net, plain

    # (c) the CLI
    counters = train_counters()
    with synthetic_split_reader(), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for fn in (*counters.values(), *counts.values()):
            fn.launches = 0
        for fn in counts.values():
            fn.grouped_launches = 0
        t = time.perf_counter()
        trainer, test = cli(["train", "e2e_rnn_triplet", *SYNTHETIC_DATA_FLAGS, "--num_epochs",
                             str(epochs), "--batch_size", str(PAIRS_TRAIN), "--vocab_size",
                             "258", "--trunc_len", str(T_TRAIN), "--workers", "4", "--seed",
                             str(SEED), "--precision", "bf16", "--log_path", str(tmp / "logs"),
                             *ABLATION_FLAGS])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counters.items()}
        train_grouped = {n: fn.grouped_launches for n, fn in counts.items()}
        run = tmp / "logs" / trainer.checkpoints.model_name
        hyperparams = json.loads((run / "hyperparams.json").read_text())
        metrics = json.loads((run / "metrics.json").read_text())
        best = trainer.checkpoints.best_checkpoint()
        evals, eval_s = [], []
        for fn in (*counters.values(), *counts.values()):
            fn.launches = 0
        for fn in counts.values():
            fn.grouped_launches = 0
        for _ in range(2):
            t = time.perf_counter()
            evals.append(cli(["eval", "e2e_rnn_triplet", "--checkpoint_path", str(best),
                              *SYNTHETIC_DATA_FLAGS, "--split", "test", "--batch_size",
                              str(PAIRS_TRAIN), "--workers", "4", "--seed", str(SEED)]))
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t)
        eval_launches = {name: fn.launches for name, fn in counters.items()}
        eval_grouped = {n: fn.grouped_launches for n, fn in counts.items()}
    losses = [e["value"] for k in ("train_loss", "val_loss", "test_loss") for e in metrics[k]]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"a variational train_cli loss is not finite: {losses}")
    if (hyperparams["variational_dropout"], hyperparams["use_projection"],
            hyperparams["bi_reduce"]) != (True, True, "mean"):
        raise AssertionError(f"hyperparams.json lacks the ablation switches: {hyperparams}")
    if evals[0] != evals[1]:
        raise AssertionError(f"eval of one checkpoint gave {evals[0]} and then {evals[1]}")
    missing = [n for n in FIT_BF16 if launches[n] <= 0]
    ran_old = [n for n, c in (*launches.items(), *eval_launches.items())
               if n in FIT_NEVER and c != 0]
    if missing or ran_old or min(train_grouped["bilstm_layer_fwd_train_mma"],
                                 train_grouped["bilstm_layer_fwd_mma"],
                                 eval_grouped["bilstm_layer_fwd_mma"]) <= 0:
        raise AssertionError(f"the variational CLI never launched {missing} (grouped: "
                             f"{train_grouped}, eval {eval_grouped}), or ran {ran_old}")
    out = {"phase": "variational", "config": {"vocab": 250, "E": E_SERVE, "H": H_SERVE,
                                              "layers": 2, "T": T_TRAIN, **ABLATION},
           "kernel_checks": kernel_checks, "grad_checks": grad_checks,
           "engine": {"pairs": len(big), "bulk_request_s": bulk_s,
                      "pairs_per_s": len(big) / float(np.median(bulk_s)),
                      "serve_engine_pairs_per_s": B_SERVE // 2 / float(
                          np.median(serve["engine_bulk_s"])),
                      "serve_pairs_per_s": serve["pairs_per_s"], "bitwise_repeat": True,
                      "max_shift_vs_no_masks": masks_shift, "launches": engine_launches},
           "train_cli": {"epochs": epochs, "epoch_time_s": [e["value"] for e in
                                                            metrics["epoch_time_s"]],
                         "seq_pairs_per_s": [e["value"] for e in metrics["seq_pairs_per_s"]],
                         "train_command_s": train_s, "eval_command_s": eval_s,
                         "test_results": test, "eval": evals[0], "eval_bitwise_repeat": True,
                         "launches": launches, "grouped_launches": train_grouped,
                         "eval_launches": eval_launches, "eval_grouped_launches": eval_grouped}}
    emit(out)
    return out


# ------------------------------------------------------------------ export
def phase_export(dev, best: Path, pairs=B_SERVE // 2) -> dict:
    """``python -m intrepppid_tpu_torch export torch_ckpt`` (through the CLI
    dispatcher) on phase fit's best checkpoint, in a run directory with the
    fit network's ``hyperparams.json``: the ``.ckpt`` holds ``state_dict``,
    ``hyper_parameters``, ``epoch`` and ``global_step``; loaded through
    ``load_reference_checkpoint`` into a fresh network on the card it
    scores 400 pairs (T = 1500, bf16) bit-equal to the network loaded from
    the checkpoint's own ``state.pt``. The export's ms and bytes."""
    from intrepppid_tpu_torch.__main__ import main as cli
    from intrepppid_tpu_torch.utils.convert import load_reference_checkpoint, load_weights

    hp = {"vocab_size": 250, "embedding_size": E_SERVE, "rnn_num_layers": 2,
          "bi_reduce": "last", "use_projection": False, "variational_dropout": False}
    (best.parent.parent / "hyperparams.json").write_text(json.dumps(hp))
    out_path = best.parent.parent / "exported.ckpt"
    t = time.perf_counter()
    cli(["export", "torch_ckpt", "--checkpoint_path", str(best), "--out_path", str(out_path)])
    export_ms = (time.perf_counter() - t) * 1e3
    chkpt = torch.load(out_path, map_location="cpu", weights_only=True)
    state = torch.load(best / "state.pt", map_location="cpu", weights_only=True)
    if chkpt.get("hyper_parameters") != hp or (chkpt.get("epoch"), chkpt.get("global_step")) \
            != (state["epoch"], state["global_step"]):
        raise AssertionError(f"the export lacks its metadata: {sorted(chkpt)}")
    nets = {}
    for name, weights in (("state", state["params"]),
                          ("export", load_reference_checkpoint(out_path))):
        nets[name] = fit_network(dev, 6, 3)
        load_weights(nets[name], weights)
    rng = np.random.default_rng(SEED + 33)
    b = quintuplet_batch(rng, pairs, T_TRAIN)
    x1, x2 = (torch.as_tensor(b[k]).to(dev) for k in ("p1", "p2"))
    with torch.no_grad():
        logits = {name: net(x1, x2) for name, net in nets.items()}
    torch.cuda.synchronize()
    if not torch.equal(logits["state"], logits["export"]) \
            or not bool(torch.isfinite(logits["state"]).all()):
        raise AssertionError("the exported weights score differently from the checkpoint's")
    out = {"phase": "export", "checkpoint": best.name, "export_ms": export_ms,
           "bytes": out_path.stat().st_size, "state_dict_entries": len(chkpt["state_dict"]),
           "keys": sorted(chkpt), "epoch": chkpt["epoch"], "global_step": chkpt["global_step"],
           "pairs": pairs, "T": T_TRAIN, "bitwise": True}
    emit(out)
    return out


# ------------------------------------------------------------------ orbax
ORBAX_FIXTURE = ROOT / "tests" / "fixtures" / "jax_orbax_manuscript"
ORBAX_SPM = ROOT / "tests" / "fixtures" / "jax_orbax_manuscript_spm.model"
# the f32 scores against the JAX engine's (XLA f32 on the CPU): the card's
# 3xTF32 forward gave 5.96e-8, about one f32 ulp at 0.5; a planted layout
# fault (directions or layers swapped) moves them by over 100 x the limit
# (tests/test_torch_port_orbax.py)
ORBAX_SCORE_TOL = 1e-6


def timed_orbax_read(path) -> tuple:
    """``restore_orbax(path)``, its seconds and the seconds of them in the
    zstd decoder."""
    from intrepppid_tpu_torch.train.orbax_read import restore_orbax
    from intrepppid_tpu_torch.utils import zstd

    decompress, spent = zstd.decompress, [0.0]

    def timed(data):
        t = time.perf_counter()
        try:
            return decompress(data)
        finally:
            spent[0] += time.perf_counter() - t

    zstd.decompress = timed
    try:
        t = time.perf_counter()
        tree = restore_orbax(path)
        seconds = time.perf_counter() - t
    finally:
        zstd.decompress = decompress
    return tree, seconds, spent[0]


def phase_orbax(dev) -> dict:
    """The JAX package's orbax directory read, scored, exported and resumed
    on the card (module notes, 5f). The counts are set to 0 just before the
    engine's call and each ``train`` command, and read just after."""
    from intrepppid_tpu_torch.__main__ import main as cli
    from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.ops.lstm_cuda import bilstm_layer_fwd_f32, bilstm_layer_fwd_mma
    from intrepppid_tpu_torch.serve import ScoringEngine
    from intrepppid_tpu_torch.train import Trainer
    from intrepppid_tpu_torch.utils.convert import load_reference_checkpoint

    expected = json.loads(ORBAX_FIXTURE.with_suffix(".json").read_text())
    hp = expected["hyperparameters"]
    size = sum(p.stat().st_size for p in ORBAX_FIXTURE.rglob("*") if p.is_file())
    reads = [timed_orbax_read(ORBAX_FIXTURE) for _ in range(2)]
    tree = reads[-1][0]
    if (int(tree["epoch"]), int(tree["global_step"]), int(tree["swa_n"])) != (
            expected["epoch"], expected["global_step"], expected["swa_n"]):
        raise AssertionError("the fixture's counts are not its record's")

    # (b) infer's loader and the engine, f32
    scored = expected["scored"]
    t = time.perf_counter()
    weights = load_reference_checkpoint(ORBAX_FIXTURE)
    load_s = time.perf_counter() - t
    net = intrepppid_network(0, vocab_size=hp["vocab_size"], embedding_size=hp["embedding_size"],
                             rnn_num_layers=hp["rnn_num_layers"], use_projection=True, device=dev)
    engine = ScoringEngine(net, weights, SentencePieceTokenizer(ORBAX_SPM),
                           trunc_len=scored["trunc_len"], batch_size=len(scored["pairs"]),
                           bulk_batch_size=0)
    bilstm_layer_fwd_f32.launches = bilstm_layer_fwd_mma.launches = 0
    t = time.perf_counter()
    probs = engine.score_pairs([tuple(p) for p in scored["pairs"]])
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t
    launches, bf16_launches = bilstm_layer_fwd_f32.launches, bilstm_layer_fwd_mma.launches
    want = np.asarray(scored["probabilities"])
    score_err = float(np.abs(probs - want).max())
    # a planted fault, the two directions of every LSTM layer swapped, must
    # fail the same check, or the check could not catch a wrong layout
    swapped = {k: v.flip(0) if k.startswith("encoder.lstm.") else v for k, v in weights.items()}
    fault_err = float(np.abs(ScoringEngine(
        net, swapped, SentencePieceTokenizer(ORBAX_SPM), trunc_len=scored["trunc_len"],
        batch_size=len(scored["pairs"]), bulk_batch_size=0).score_pairs(
        [tuple(p) for p in scored["pairs"]]) - want).max())
    if not score_err <= ORBAX_SCORE_TOL < fault_err or launches <= 0 or bf16_launches != 0:
        raise AssertionError(f"the fixture scores {score_err} from the JAX engine, the planted "
                             f"fault {fault_err} ({ORBAX_SCORE_TOL}), f32 forward {launches} "
                             f"launches, bf16 {bf16_launches}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (c) export torch_ckpt of the JAX directory
        out_path = tmp / "fixture.ckpt"
        t = time.perf_counter()
        cli(["export", "torch_ckpt", "--checkpoint_path", str(ORBAX_FIXTURE), "--out_path",
             str(out_path)])
        export_ms = (time.perf_counter() - t) * 1e3
        export_bytes = out_path.stat().st_size
        chkpt = torch.load(out_path, map_location="cpu", weights_only=True)
        exported = load_reference_checkpoint(out_path)
        if (chkpt["epoch"], chkpt["global_step"]) != (expected["epoch"],
                                                      expected["global_step"]) \
                or list(exported) != list(weights) \
                or not all(torch.equal(exported[k], v) for k, v in weights.items()):
            raise AssertionError("the export of the JAX directory is not its weights")

        # (d) the converted state, resumed and written by the port
        steps = hp["steps_per_epoch"]
        resumed = Trainer(intrepppid_network(
            steps, vocab_size=hp["vocab_size"], embedding_size=hp["embedding_size"],
            rnn_num_layers=hp["rnn_num_layers"], num_epochs=hp["num_epochs"] + 1,
            optimizer_type=hp["optimizer_type"], lr=hp["lr"], compute_dtype=torch.bfloat16,
            device=dev, seed=SEED), tmp / "converted", "intrepppid", seed=SEED)
        t = time.perf_counter()
        resumed.resume(ORBAX_FIXTURE)
        resume_s = time.perf_counter() - t
        counts = {"start_epoch": resumed.start_epoch, "global_step": resumed.global_step,
                  "count": resumed.optimizer.count, "swa_n": resumed.swa.n_averaged}
        if counts != {"start_epoch": expected["epoch"] + 1, "global_step": expected["global_step"],
                      "count": expected["count"], "swa_n": expected["swa_n"]}:
            raise AssertionError(f"the resume's counts {counts} are not the fixture's")
        state_pt = resumed._save_epoch(expected["epoch"], 0.0)

        data = ["--ppi_dataset_path", "synthetic.h5", "--sentencepiece_path", str(ORBAX_SPM),
                "--c_type", "3"]
        counters = train_counters()
        runs = {}
        with synthetic_split_reader():
            for name, path in (("orbax", ORBAX_FIXTURE), ("state_pt", state_pt)):
                for fn in counters.values():
                    fn.launches = 0
                t = time.perf_counter()
                trainer, _ = cli(["train", "e2e_rnn_triplet", *data, "--num_epochs",
                                  str(hp["num_epochs"] + 1), "--batch_size", str(PAIRS_TRAIN),
                                  "--vocab_size", str(hp["vocab_size"]), "--lr", str(hp["lr"]),
                                  "--trunc_len", str(T_TRAIN), "--workers", "4", "--seed",
                                  str(SEED), "--precision", "bf16", "--checkpoint_path",
                                  str(path), "--log_path", str(tmp / name)])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t
                epoch = torch.load(trainer.checkpoints.last_path / "state.pt",
                                   map_location="cpu", weights_only=True)
                runs[name] = {
                    "trainer": trainer, "epoch_params": epoch["params"],
                    "launches": {n: fn.launches for n, fn in counters.items()},
                    "command_s": seconds,
                    "epoch_time_s": [e["value"] for e in
                                     trainer.loggers[0].metrics["epoch_time_s"]]}
        a, b = (runs[k]["trainer"] for k in ("orbax", "state_pt"))
        want_step = expected["global_step"] + a.net.steps_per_epoch
        for tr in (a, b):
            if (tr.start_epoch, tr.global_step) != (expected["epoch"] + 1, want_step):
                raise AssertionError(f"a resumed run started at epoch {tr.start_epoch} and "
                                     f"ended at step {tr.global_step}")
        pairs = [tuple({n: p.detach() for n, p in tr.net.named_parameters()} for tr in (a, b)),
                 (a.swa.avg_params, b.swa.avg_params),
                 (runs["orbax"]["epoch_params"], runs["state_pt"]["epoch_params"])]
        if not all(torch.equal(x[n], y[n]) for x, y in pairs for n in y):
            raise AssertionError("the run resumed from the JAX directory and the one from "
                                 "its state.pt ended apart")
        for name, r in runs.items():
            missing = [n for n in FIT_BF16 if r["launches"][n] <= 0]
            ran_old = [n for n in FIT_NEVER if r["launches"][n] != 0]
            if missing or ran_old:
                raise AssertionError(f"the {name} resume never launched {missing}, "
                                     f"or ran {ran_old}")
        state_pt_bytes = (state_pt / "state.pt").stat().st_size
    out = {"phase": "orbax", "fixture": str(ORBAX_FIXTURE.relative_to(ROOT)), "bytes": size,
           "read_s": [r[1] for r in reads], "zstd_s": [r[2] for r in reads],
           "optimizer_leaves": len(tree["opt_state"]),
           "score": {"pairs": len(scored["pairs"]), "max_abs_err": score_err,
                     "tol": ORBAX_SCORE_TOL, "planted_fault_err": fault_err,
                     "load_s": load_s, "score_s": score_s, "launches": launches,
                     "bf16_launches": bf16_launches},
           "export": {"ms": export_ms, "bytes": export_bytes,
                      "state_dict_entries": len(chkpt["state_dict"]), "bitwise": True},
           "resume": {**counts, "resume_s": resume_s, "state_pt_bytes": state_pt_bytes,
                      "steps": a.net.steps_per_epoch, "bitwise": True,
                      "runs": {k: {"command_s": r["command_s"], "epoch_time_s": r["epoch_time_s"],
                                   "launches": {n: c for n, c in r["launches"].items() if c}}
                               for k, r in runs.items()}}}
    emit(out)
    return out


# ------------------------------------------------------------------ widths
# the train-variant wrapper of each resident forward kernel
RESIDENT_TRAIN_FWD = {"bilstm_fwd_mma": "bilstm_layer_fwd_train_mma",
                      "bilstm_fwd_f32": "bilstm_layer_fwd_train_f32"}
# the layers the width repairs open (E parts, H, weight groups), each run at
# its padded shape: the stacked layer at embedding 80 (96, wide), layer 0
# and the stacked layer at embedding 112 (128, wide), layer 0 at embedding
# 50 (H 64, E 56 in f32 and 64 in bf16, resident), both layers at embedding
# 100 (H 128, parts of 112, wide) and at 272 (288, wide: the tensor-core
# kernels in both dtypes, in bf16 the forward's and sweep's instances for
# uneven unit groups)
PADDED_LAYERS = ((("stacked", 80), [80, 80], 80, 1), (("layer 0", 112), [112], 112, G_TRAIN),
                 (("stacked", 112), [112, 112], 112, 1), (("layer 0", 50), [50], 50, G_TRAIN),
                 (("layer 0", 100), [100], 100, G_TRAIN), (("stacked", 100), [100, 100], 100, 1),
                 (("layer 0", 272), [272], 272, G_TRAIN), (("stacked", 272), [272, 272], 272, 1))
# the wide route's kernels at 128-288, by dtype (the tensor-core ones; in
# f32 three tf32 passes a product; in bf16 dW_ih on cuBLAS beside
# bilstm_wgrad_mma's dW_hh)
WIDE_BF16 = ("bilstm_gates_mma", "bilstm_fwd_wide_train_mma", "bilstm_fwd_wide_mma",
             "bilstm_bwd_lite_mma", "bilstm_wgrad_mma", "bilstm_wgrad_ih")
WIDE_F32 = ("bilstm_gates_f32", "bilstm_fwd_wide_train_f32", "bilstm_fwd_wide_f32",
            "bilstm_bwd_lite_f32", "bilstm_wgrad_f32")
# two-layer models at these embeddings, and the recurrence backend at 80:
# the kernels each one's gradient step and eval step must launch (at 72 in
# bf16 layer 0, E = H = 72, is the main path of the tensor-core forward's
# and sweep's <72, 72> instances, the stacked layer (run at 96) that of the
# one-block bf16 lite sweep and wide forward, and bilstm_bwd.cu must not
# launch, nor the dW_ih products (the stacked layer's weight gradients are
# whole at 96);
# at 16 in bf16 both layers are the tensor-core sweep's (its <16, 16> and
# <16, 32> instances; the stacked layer, E = 16 + 16, K = 48 run as 64, was
# bilstm_bwd.cu's main path), never bilstm_bwd.cu; at 16 and 48 in f32
# and at 80 in f32 (layer 0) the weight gradients are the 3xTF32 wgrad's
# 64-row tile's; at 56 in bf16 both layers, E =
# 56 and 56 + 56, are the tensor-core forward's <56, 56> and <56, 112>
# instances (the latter with a k8 tail); at 48 in bf16 the stacked layer at parts of 56 is its
# <48, 112> one; at 160 both layers run on the wide route at
# 160: in f32 the f32 tensor-core forward's and lite sweep's
# (the dW_ih products must not launch), in bf16 the bf16 tensor-core
# forward's and lite sweep's and the split wgrad's; on the recurrence
# backend at 80 both layers run the op at 96: in f32 its forward, sweep and
# wgrad are the tensor-core lstm_recurrence_{fwd,bwd}_mid_f32.cu and
# lstm_recurrence_wgrad_f32.cu, in bf16 lstm_recurrence_{fwd,bwd}_mid_mma.cu)
# and, where given, must not
WIDTH_STEPS = (
    ("layer", 48, torch.float32, ("bilstm_layer_fwd_train_f32", "bilstm_layer_fwd_f32",
                                  "bilstm_bwd_f32", "bilstm_wgrad_f32")),
    ("layer", 48, torch.bfloat16, ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma",
                                   "bilstm_bwd_mma", "bilstm_wgrad_mma")),
    ("layer", 50, torch.float32, ("bilstm_layer_fwd_train_f32", "bilstm_layer_fwd_f32",
                                  "bilstm_bwd_f32", "bilstm_wgrad_f32")),
    ("layer", 50, torch.bfloat16, ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma",
                                   "bilstm_bwd_mma", "bilstm_wgrad_mma")),
    ("layer", 100, torch.float32, WIDE_F32),
    ("layer", 100, torch.bfloat16, WIDE_BF16),
    ("layer", 272, torch.bfloat16, WIDE_BF16),
    ("layer", 72, torch.bfloat16, ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma",
                                   "bilstm_bwd_mma", "bilstm_wgrad_mma",
                                   "bilstm_fwd_wide_train_mma_resident",
                                   "bilstm_fwd_wide_mma_resident", "bilstm_bwd_lite_mma_resident"),
     ("bilstm_bwd", "bilstm_wgrad_ih")),
    ("layer", 16, torch.bfloat16, ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma",
                                   "bilstm_bwd_mma", "bilstm_wgrad_mma"), ("bilstm_bwd",)),
    ("layer", 16, torch.float32, ("bilstm_layer_fwd_train_f32", "bilstm_layer_fwd_f32",
                                  "bilstm_bwd_f32", "bilstm_wgrad_f32")),
    ("layer", 56, torch.bfloat16, ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma",
                                   "bilstm_bwd_mma", "bilstm_wgrad_mma"), ("bilstm_bwd",)),
    ("layer", 80, torch.float32, ("bilstm_layer_fwd_train_f32", "bilstm_layer_fwd_f32",
                                  "bilstm_bwd_f32_onestage", "bilstm_wgrad_f32")),
    ("layer", 160, torch.float32, WIDE_F32, ("bilstm_wgrad_ih",)),
    ("layer", 160, torch.bfloat16, WIDE_BF16,
     ("bilstm_bwd_lite_f32", "bilstm_wgrad_f32", "bilstm_fwd_wide_mma_resident")),
    ("layer", 112, torch.float32, WIDE_F32),
    ("layer", 112, torch.bfloat16, WIDE_BF16),
    ("recurrence", 80, torch.float32, ("lstm_recurrence_fwd_mid_f32",
                                       "lstm_recurrence_bwd_mid_f32", "lstm_recurrence_wgrad_f32"),
     ("lstm_recurrence_fwd", "lstm_recurrence_bwd", "lstm_recurrence_fwd_f32",
      "lstm_recurrence_fwd_mid_mma", "lstm_recurrence_bwd_mid_mma", "lstm_recurrence_wgrad")),
    ("recurrence", 80, torch.bfloat16, ("lstm_recurrence_fwd_mid_mma",
                                        "lstm_recurrence_bwd_mid_mma",
                                        "lstm_recurrence_wgrad_mma"),
     ("lstm_recurrence_fwd", "lstm_recurrence_bwd", "lstm_recurrence_fwd_mma",
      "lstm_recurrence_bwd_mid_f32", "lstm_recurrence_fwd_mid_f32")),
)


def padded_layer_timings(dev) -> list:
    """Each layer of ``PADDED_LAYERS`` on its route at its padded shape
    (``lstm_cuda.layer_fwd`` train variant, and ``layer_bwd``: the sweep and
    the weight gradients), 400 rows, f32 and bf16: held against the plain
    layer at its true widths (``bidir_layer``, ``bidir_layer_bwd``) at
    T = 300 with the main path's lengths, the kernels it launched, then
    timed at T = 1500, full lengths, beside its bound at the true widths
    and at the padded ones (the dtype's rate; what the padding costs) and
    cuDNN's one-layer training forward and backward (input and weights) at
    the true widths in the same dtype, TF32 off."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_bwd

    counters = train_counters()
    out = []
    for (what, width), E_parts, H, G in PADDED_LAYERS:
        ny = 2 if len(E_parts) == 1 else 1
        for cd in (torch.float32, torch.bfloat16):
            Hp, Ep = L.padded_width(E_parts, H, cd), L.padded_parts(E_parts, H, cd)
            row = {"layer": f"{what}, embedding {width}", "E_parts": E_parts, "H": H,
                   "padded_H": Hp, "padded_parts": list(Ep),
                   "route": L.layer_route(E_parts, H, cd), "G": G, "ny": ny,
                   "B": B_TRAIN, "T": T_TRAIN, "check_T": 300,
                   "dtype": str(cd).replace("torch.", ""), "tol": f"{TOL[cd]} x max(1, max|ref|)"}
            size = torch.empty((), dtype=cd).element_size()
            for full in (False, True):
                parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                    E_parts, H, G, cd, dev, SEED + 40 + H, full_lengths=full, ny=ny,
                    T=T_TRAIN if full else 300)
                fwd_args = (parts, lengths, w_ih, w_hh, bias, cd)
                fwd = lambda: L.layer_fwd(*fwd_args, with_states=True)  # noqa: E731
                hs_f, hs_b, _, _, cs_f, cs_b = fwd()
                args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb,
                        dhn, dcn, cd)
                bwd = lambda: L.layer_bwd(*args)  # noqa: E731
                if full:
                    row["fwd_ms"], row["bwd_ms"] = time_ms(fwd, 3), time_ms(bwd, 3)
                    continue
                for fn in counters.values():
                    fn.launches = 0
                got_f, got_b = fwd(), bwd()
                torch.cuda.synchronize()
                row["kernels"] = sorted(n for n, fn in counters.items() if fn.launches)
                if row["route"] == "wide":
                    want = {L.gates_kernel(Ep, Hp, cd), L.lite_kernel(Hp, cd),
                            L.wide_fwd_kernel(Hp, cd).replace("wide", "wide_train")}
                else:
                    want = {RESIDENT_TRAIN_FWD[L.fwd_kernel(Ep, Hp, cd)],
                            L.sweep_kernel(Ep, Hp, cd)}
                want.add(L.wgrad_kernel(Ep, Hp, cd))
                if not want <= set(row["kernels"]):
                    raise AssertionError(f"a padded layer ran {row['kernels']}, not {want}")
                want_f = bidir_layer(*fwd_args, with_states=True)
                want_b = bidir_layer_bwd(*args)
                flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
                res = {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(
                    ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b"), got_f, want_f)}
                res.update({n: rel_err(a, b, TOL[cd]) for n, a, b in zip(
                    sweep_names(*want_b[:2])[:-2] + ["dW_ih", "dW_hh", "dbias"], flat(got_b),
                    flat(want_b))})
                row["max_abs_err"] = {n: e for n, (e, _) in res.items()}
                if not all(ok for _, ok in res.values()):
                    emit({"phase": "widths", "failed": row})
                    raise AssertionError(f"a padded layer disagrees with its plain layer: {row}")
                del got_f, got_b, want_f, want_b
            for key, Ew, Hw in (("", sum(E_parts), H), ("padded_", sum(Ep), Hp)):
                work = train_layer_work(Ew, Hw, size, ny, G=G)
                peak = kernel_peak(cd)
                row[f"fwd_{key}bound_ms"], row[f"fwd_{key}bound_by"] = bound(
                    [(*work["fwd"], peak)])
                row[f"bwd_{key}bound_ms"], row[f"bwd_{key}bound_by"] = bound(
                    [(*work["bwd"], peak), (*work["wgrad"], peak)])
            lib = cudnn_stack_times(dev, cd, E=sum(E_parts), H=H, layers=1)
            row["fwd_library_ms"], row["bwd_library_ms"] = lib["cudnn_fwd_ms"], lib["cudnn_bwd_ms"]
            out.append(row)
            del parts, hs_f, hs_b, cs_f, cs_b, args, fwd_args
    return out


def wide_cuda_core_kernels(dev, E_parts=(272,), H=272, G=G_TRAIN, ny=2, Hp_want=288,
                           seed=SEED + 50, fwd_want="bilstm_fwd_wide_mma",
                           lite_want="bilstm_bwd_lite_mma", cd=torch.bfloat16) -> dict:
    """The wide forward (both variants) and lite sweep the dispatch names on
    a main path, in ``cd``: by default layer 0 of the bf16 two-layer model
    at embedding 272 (E = 272, run at H = 288, 5 weight groups, two dy
    streams a direction: the tensor-core ``bilstm_fwd_wide_mma`` and
    ``bilstm_bwd_lite_mma``, their instances for uneven unit groups); with
    ``E_parts`` (80, 80), H = 80, G = 1, ny = 1, run at 96, the stacked
    layer of the two-layer model at embedding 80 (in bf16 the one-block
    ``bilstm_fwd_wide_mma_resident.cu`` and ``bilstm_bwd_lite_mma_resident.cu``,
    in f32 the one-block ``bilstm_fwd_wide_f32_resident.cu``, both variants
    also held against the twin at 5 weight groups, T = 300 (``g5_*``), and
    ``bilstm_bwd_lite_f32_resident.cu``);
    with E = H = 160-224 layer 0 at those embeddings (in f32
    ``bilstm_fwd_wide_f32.cu``, also at each of its row tiles in turns with
    the dispatch, and ``bilstm_bwd_lite_f32.cu``, in bf16
    ``bilstm_fwd_wide_mma.cu``'s kernel for uneven unit groups and
    ``bilstm_bwd_lite_mma.cu``); 400 rows, T = 1500,
    the input gates from the tensor-core gates kernel. The forward and the
    sweep the dispatch names must be ``fwd_want`` and ``lite_want``. Each
    held against its plain twin with the main path's lengths (the tolerance
    ``TOL``; a tensor-core forward's two variants must give the same hs
    bits, and the same bits twice; the sweep the same bits twice), then
    timed at
    full lengths beside the twin (timed once, in the check), its bound at
    its rate (``kernel_peak``) at the padded H (the kernel's own work) and at
    the true H, and cuDNN's one-layer training forward (``cudnn_fwd_again_ms``
    its second reading), inference forward and backward for the input at the
    true widths in ``cd``, TF32 off; the 8-block tensor-core forward also at
    each of its row tiles. One dict per kernel: "fwd", "fwd_eval", "lite",
    or "fwd_mma", "fwd_eval_mma", "lite_mma" for the 8-block tensor-core
    ones (with their row tile, tiles and the clusters the card holds at
    once)."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep_lite, bidir_recurrence

    E_parts = list(E_parts)
    E = sum(E_parts)
    Hp = L.padded_width(E_parts, H, cd)
    picked = (Hp, L.wide_fwd_kernel(Hp, cd), L.lite_kernel(Hp, cd))
    if picked != (Hp_want, fwd_want, lite_want):
        raise AssertionError(f"the layer at E={E_parts}, H={H} in {cd} runs {picked}")
    mma = fwd_want == "bilstm_fwd_wide_mma"
    fwd_f32 = fwd_want == "bilstm_fwd_wide_f32"
    one_block_f32 = fwd_want == "bilstm_fwd_wide_f32_resident"
    sfx = "_mma" if mma else ""
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    shape = {"B": B_TRAIN, "T": T_TRAIN, "E": E, "H": H, "padded_H": Hp, "G": G, "ny": ny,
             "dtype": str(cd).replace("torch.", ""), "tol": f"{TOL[cd]} x max(1, max|ref|)"}
    out = {k + sfx: {"kernel": name, **shape} for k, name in (
        ("fwd", f"{fwd_want} (train)"), ("fwd_eval", f"{fwd_want} (eval)"), ("lite", lite_want))}
    for full in (False, True):
        parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
            E_parts, Hp, G, cd, dev, seed, full_lengths=full, ny=ny)
        xg = L.bilstm_gates(parts, w_ih, bias, cd)
        calls = {"fwd": lambda: L.bilstm_fwd_wide_train(xg, lengths, w_hh, cd),
                 "fwd_eval": lambda: L.bilstm_fwd_wide(xg, lengths, w_hh, cd)}
        hs_f, hs_b, _, _, cs_f, cs_b = calls["fwd"]()
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd)
        calls["lite"] = lambda: L.bilstm_bwd_lite(*args)
        if full:
            for k, call in calls.items():
                out[k + sfx]["ms"] = time_ms(call, 3)
            if mma:
                for k, kind, lib in (("fwd", "fwd_mma", "bilstm_fwd_wide_mma"),
                                     ("lite", "lite_mma", "bilstm_bwd_lite_mma")):
                    out[k + sfx]["rows"], out[k + sfx]["tiles"], _ = L.wide_plan(
                        kind, B_TRAIN, G, Hp, L._max_clusters(lib, cd, Hp, dev))
                    out[k + sfx]["max_active_clusters"] = {
                        f"rows={c[3]}": v for c, v in L._cluster_counts.items()
                        if c[0] == lib and c[2] == Hp}
                # the train variant at each row tile its instance for
                # uneven groups is built for
                keep = L.FWD_WIDE_MMA_UNEVEN_ROWS
                try:
                    for R in keep:
                        L.FWD_WIDE_MMA_UNEVEN_ROWS = (R,)
                        out["fwd_mma"][f"rows_{R}_ms"] = time_ms(calls["fwd"], 3)
                finally:
                    L.FWD_WIDE_MMA_UNEVEN_ROWS = keep
            if fwd_f32:
                # the train variant at each row tile, in turns with the dispatch
                for R in L.fwd_wide_f32_rows(Hp):
                    a, b, c = in_turns(lambda: at_f32_rows(
                        L, R, L.bilstm_fwd_wide_train_f32, xg, lengths, w_hh, cd), calls["fwd"], 2)
                    out["fwd"][f"rows_{R}_ms"] = 0.5 * (a + b)
                    out["fwd"][f"rows_{R}_dispatch_ms"] = c
            if not mma and lite_want == "bilstm_bwd_lite_mma" or fwd_f32:
                kind, lib, k = (("fwd_f32", fwd_want, "fwd") if fwd_f32 else
                                ("lite_mma", lite_want, "lite"))
                out[k]["rows"], out[k]["tiles"], _ = L.wide_plan(
                    kind, B_TRAIN, G, Hp, L._max_clusters(lib, cd, Hp, dev))
                out[k]["max_active_clusters"] = {
                    f"rows={c[3]}": v for c, v in L._cluster_counts.items()
                    if c[0] == lib and c[2] == Hp}
        else:
            want, out["fwd" + sfx]["plain_ms"] = timed_once(
                lambda: bidir_recurrence(xg, lengths, w_hh, cd, with_states=True))
            _, out["fwd_eval" + sfx]["plain_ms"] = timed_once(
                lambda: bidir_recurrence(xg, lengths, w_hh, cd))
            ref, out["lite" + sfx]["plain_ms"] = timed_once(lambda: bidir_layer_sweep_lite(*args))
            got = calls["lite"]()
            res = {"lite": {"dgates": rel_err(got, ref, TOL[cd]),
                            "twice": (0.0, bool(torch.equal(calls["lite"](), got)))}}
            out["lite" + sfx]["scaled_err"] = scaled_err(got, ref)
            del got
            train, ev = calls["fwd"](), calls["fwd_eval"]()
            res["fwd"] = {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(names, train, want)}
            res["fwd_eval"] = {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(names, ev, want)}
            if not (torch.equal(train[0], ev[0]) and torch.equal(train[1], ev[1])):
                raise AssertionError(f"{fwd_want}'s two variants differ")
            for k, first in (("fwd", train), ("fwd_eval", ev)):
                res[k]["twice"] = (0.0, all(torch.equal(a, b)
                                            for a, b in zip(calls[k](), first)))
                out[k + sfx]["scaled_err"] = max(scaled_err(a, b) for a, b in zip(first, want))
            if fwd_f32:
                for R in L.fwd_wide_f32_rows(Hp):
                    res["fwd"].update({f"rows{R}_{n}": rel_err(a, b, TOL[cd]) for n, a, b in zip(
                        names, at_f32_rows(L, R, L.bilstm_fwd_wide_train_f32, xg, lengths, w_hh,
                                           cd), want)})
            del train, ev
            torch.cuda.synchronize()
            for k, r in res.items():
                out[k + sfx]["max_abs_err"] = {n: e for n, (e, _) in r.items()}
                if not all(ok for _, ok in r.values()):
                    emit({"phase": "widths", "failed": out[k + sfx]})
                    raise AssertionError(f"{out[k + sfx]['kernel']} disagrees with its twin: "
                                         f"{out[k + sfx]}")
            del want, ref, res
        del parts, xg, hs_f, hs_b, cs_f, cs_b, args, calls
    if one_block_f32:
        # 5 weight groups (each cut into its own 8-row tiles), T = 300
        parts, lengths, w_ih, w_hh, bias, *_ = train_layer_inputs(
            E_parts, Hp, G_TRAIN, cd, dev, seed + 1, T=300, ny=ny)
        xg = L.bilstm_gates(parts, w_ih, bias, cd)
        want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
        for k, got in (("fwd", L.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)),
                       ("fwd_eval", L.bilstm_fwd_wide(xg, lengths, w_hh, cd))):
            res = {f"g5_{n}": rel_err(a, b, TOL[cd]) for n, a, b in zip(names, got, want)}
            torch.cuda.synchronize()
            out[k]["max_abs_err"].update({n: e for n, (e, _) in res.items()})
            if not all(ok for _, ok in res.values()):
                emit({"phase": "widths", "failed": out[k]})
                raise AssertionError(f"{fwd_want} disagrees with its twin at 5 groups: {out[k]}")
        del parts, xg, want, got
    size = torch.empty((), dtype=cd).element_size()
    for key, Hw in (("", Hp), ("true_", H)):
        work = wide_layer_work(E, Hw, G, size, ny)
        for k in out:
            kernel = lite_want if k.startswith("lite") else fwd_want
            out[k][f"{key}bound_ms"], out[k][f"{key}bound_by"] = bound(
                [(*work[k.replace("_mma", "")], kernel_peak(cd, kernel))])
    lib = cudnn_stack_times(dev, cd, E=E, H=H, layers=1)
    for k in out:
        out[k]["library_ms"] = lib[{"fwd": "cudnn_fwd_ms", "fwd_eval": "cudnn_inference_ms",
                                    "lite": "cudnn_bwd_data_ms"}[k.replace("_mma", "")]]
        out[k]["library_fwd_again_ms"] = lib["cudnn_fwd_again_ms"]
    return out


# the f32 tensor-core lite sweep's main paths (E parts, H, the model): layer
# 0 of the f32 two-layer models at embedding 272 (run at H = 288) and 100
# (at H = 128, parts of 112), and layer 0 of the scaled configuration
LITE_F32_LAYERS = ((288, [272], 272, "layer 0 at embedding 272"),
                   (256, [256], 256, "layer 0 of the scaled configuration"),
                   (128, [100], 100, "layer 0 at embedding 100"))


def lite_f32_kernels(dev, G=G_TRAIN, ny=2) -> dict:
    """The f32 tensor-core lite sweep ``bilstm_bwd_lite_f32.cu`` (three
    tf32 passes) at each of ``LITE_F32_LAYERS``, 400 rows in 5 weight
    groups, two dy streams a direction, the input gates from
    ``bilstm_gates`` and the streams from ``bilstm_fwd_wide_train`` (both
    on their f32 tensor-core kernels): held against its plain twin with the
    main path's lengths at T = 300 (1e-4 x max(1, max|ref|)), then timed at
    T = 1500, full lengths, at each row tile it is built for, beside its
    bound at 495/3 TFLOP/s at the padded H and the true H (the CUDA-core
    rate's at 67), the twin (timed once, in the check) and cuDNN's
    one-layer f32 backward for the input at the true widths, TF32 off; its
    plan's row tile and the clusters the card holds at once."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep_lite

    cd, name = torch.float32, "bilstm_bwd_lite_f32"
    out = {}
    for Hp_want, E_parts, H, what in LITE_F32_LAYERS:
        Hp, Ep = L.padded_width(E_parts, H, cd), list(L.padded_parts(E_parts, H, cd))
        if (Hp, L.lite_kernel(Hp, cd)) != (Hp_want, name):
            raise AssertionError(f"{what} in f32 runs at H={Hp} on {L.lite_kernel(Hp, cd)}")
        row = {"layer": what, "B": B_TRAIN, "T": T_TRAIN, "check_T": 300, "E_parts": E_parts,
               "H": H, "padded_H": Hp, "padded_parts": Ep, "G": G, "ny": ny,
               "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        for full in (False, True):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                Ep, Hp, G, cd, dev, SEED + 60 + Hp, full_lengths=full, ny=ny,
                T=T_TRAIN if full else 300)
            xg = L.bilstm_gates(parts, w_ih, bias, cd)
            hs_f, hs_b, _, _, cs_f, cs_b = L.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
            args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd)
            new = lambda: L.bilstm_bwd_lite(*args)  # noqa: E731
            if full:
                row["ms"] = time_ms(new, 3)
                keep = L.LITE_F32_ROWS
                try:
                    for R in keep:
                        L.LITE_F32_ROWS = (R,)
                        row[f"rows_{R}_ms"] = time_ms(new, 3)
                finally:
                    L.LITE_F32_ROWS = keep
                row["rows"], row["tiles"], row["smem"] = L.wide_plan(
                    "lite_f32", B_TRAIN, G, Hp, L._max_clusters(name, cd, Hp, dev))
                row["max_active_clusters"] = {
                    f"rows={c[3]}": v for c, v in L._cluster_counts.items()
                    if c[0] == name and c[2] == Hp}
            else:
                ref, row["plain_ms"] = timed_once(lambda: bidir_layer_sweep_lite(*args))
                got = new()
                res = {"dgates": rel_err(got, ref, TOL[cd])}
                row["scaled_err"] = scaled_err(got, ref)
                torch.cuda.synchronize()
                row["max_abs_err"] = {n: e for n, (e, _) in res.items()}
                if not all(ok for _, ok in res.values()):
                    emit({"phase": "widths", "failed": row})
                    raise AssertionError(f"the f32 lite sweep disagrees with its twin: {row}")
                del ref, got
            del parts, xg, hs_f, hs_b, cs_f, cs_b, args
        for key, Hw, Ew in (("", Hp, sum(Ep)), ("true_", H, sum(E_parts))):
            work = wide_layer_work(Ew, Hw, G, 4, ny)["lite"]
            row[f"{key}bound_ms"], row[f"{key}bound_by"] = bound(
                [(*work, kernel_peak(cd, name))])
            row[f"{key}cuda_core_bound_ms"], _ = bound([(*work, PEAK_F32_FLOPS)])
        row["library_ms"] = cudnn_stack_times(dev, cd, E=sum(E_parts), H=H,
                                              layers=1)["cudnn_bwd_data_ms"]
        out[f"h{Hp}"] = row
    return out


# the f32 tensor-core input gates' and wide forward's main paths (E parts,
# H, weight groups, the model): layer 0 and the stacked layer of the f32
# two-layer model at embedding 272 (run at H = 288), layer 0 of the scaled
# configuration, and layer 0 at embedding 100 (at H = 128, parts of 112)
WIDE_F32_LAYERS = ((288, [272], 272, G_TRAIN, "layer 0 at embedding 272"),
                   (288, [272, 272], 272, 1, "stacked layer at embedding 272"),
                   (256, [256], 256, G_TRAIN, "layer 0 of the scaled configuration"),
                   (128, [100], 100, G_TRAIN, "layer 0 at embedding 100"))


def at_f32_rows(L, R, fn, *args):
    """``fn(*args)`` with the f32 tensor-core forward's plan held to row
    tiles of ``R``."""
    keep = L.FWD_WIDE_F32_ROWS, L.FWD_WIDE_F32_ROWS_288
    L.FWD_WIDE_F32_ROWS = L.FWD_WIDE_F32_ROWS_288 = (R,)
    try:
        return fn(*args)
    finally:
        L.FWD_WIDE_F32_ROWS, L.FWD_WIDE_F32_ROWS_288 = keep


def wide_f32_kernels(dev, ny=2) -> dict:
    """The f32 tensor-core input gates ``bilstm_gates_f32.cu`` and wide
    forward ``bilstm_fwd_wide_f32.cu`` (both variants; three tf32 passes a
    product) at each of ``WIDE_F32_LAYERS``, 400 rows: held against their
    plain twins with the main path's lengths at T = 300 (1e-4 x max(1,
    max|ref|); the gates computed twice must agree bit for bit, the eval and
    train hs too; the forward at every row tile it is built for), then
    timed at T = 1500, full lengths, beside its bound at 495/3 TFLOP/s at
    the padded widths and at the true ones, the twin (timed once, in the
    check) and one PyTorch call at the true widths, TF32 off: cuBLAS
    ``addmm`` for the gates (both directions in one call), cuDNN's one-layer
    f32 training and inference forward for the forward (which does the
    input projection too). The forward at each row tile, each timed in
    turns with the dispatch (new, other, other, new); its plan's row tile
    and the clusters the card holds at once."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_recurrence, input_gates

    cd = torch.float32
    out = {}
    for Hp_want, E_parts, H, G, what in WIDE_F32_LAYERS:
        Hp, Ep = L.padded_width(E_parts, H, cd), list(L.padded_parts(E_parts, H, cd))
        picked = (Hp, L.gates_kernel(Ep, Hp, cd), L.wide_fwd_kernel(Hp, cd))
        if picked != (Hp_want, "bilstm_gates_f32", "bilstm_fwd_wide_f32"):
            raise AssertionError(f"{what} in f32 runs {picked}")
        row = {"layer": what, "B": B_TRAIN, "T": T_TRAIN, "check_T": 300, "E_parts": E_parts,
               "H": H, "padded_H": Hp, "padded_parts": Ep, "G": G,
               "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        row_tiles = L.fwd_wide_f32_rows(Hp)

        for full in (False, True):
            parts, lengths, w_ih, w_hh, bias, _, _, _, _ = train_layer_inputs(
                Ep, Hp, G, cd, dev, SEED + 70 + Hp + len(Ep), full_lengths=full, ny=ny,
                T=T_TRAIN if full else 300)
            gates = lambda: L.bilstm_gates(parts, w_ih, bias, cd)  # noqa: E731
            xg = gates()
            fwd = lambda: L.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)  # noqa: E731
            ev = lambda: L.bilstm_fwd_wide(xg, lengths, w_hh, cd)  # noqa: E731
            if full:
                for key, call in (("gates", gates), ("fwd", fwd), ("fwd_eval", ev)):
                    row[f"{key}_ms"] = time_ms(call, 3)
                for R in row_tiles:
                    d0, d1, o = in_turns(fwd, lambda: at_f32_rows(
                        L, R, L.bilstm_fwd_wide_train_f32, xg, lengths, w_hh, cd), 2)
                    row[f"fwd_rows{R}_ms"] = o
                    row[f"fwd_rows{R}_dispatch_ms"] = 0.5 * (d0 + d1)
                x = torch.cat(parts, dim=-1).reshape(T_TRAIN * B_TRAIN, -1)
                w_t, b = w_ih.reshape(8 * Hp, -1).t(), bias.reshape(-1)
                row["gates_library_ms"] = time_ms(lambda: torch.addmm(b, x, w_t), 3)
                del x, w_t
                # the f32 fragment copy of W_hh^T that the forward and the lite
                # sweep each build a call
                row["f32_copy_ms"] = time_ms(
                    lambda: L.recurrence_f32_weights(w_hh.transpose(-1, -2)), 10)
                row["fwd_rows"], row["fwd_tiles"], row["fwd_smem"] = L.wide_plan(
                    "fwd_f32", B_TRAIN, G, Hp, L._max_clusters(
                        "bilstm_fwd_wide_f32", cd, Hp, dev))
                row["max_active_clusters"] = {
                    f"rows={c[3]}": v for c, v in L._cluster_counts.items()
                    if c[0] == "bilstm_fwd_wide_f32" and c[2] == Hp}
            else:
                ref, row["gates_plain_ms"] = timed_once(
                    lambda: input_gates(parts, w_ih, bias, cd))
                want, row["fwd_plain_ms"] = timed_once(
                    lambda: bidir_recurrence(xg, lengths, w_hh, cd, with_states=True))
                _, row["fwd_eval_plain_ms"] = timed_once(
                    lambda: bidir_recurrence(xg, lengths, w_hh, cd))
                names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
                res = {"xg": rel_err(xg, ref, TOL[cd])}
                again = gates()
                res["xg_recompute_vs_first"] = (float((again - xg).abs().max()),
                                                bool(torch.equal(again, xg)))
                got, got_ev = fwd(), ev()
                res.update({f"train_{n}": rel_err(a, b, TOL[cd])
                            for n, a, b in zip(names, got, want)})
                res.update({f"eval_{n}": rel_err(a, b, TOL[cd])
                            for n, a, b in zip(names, got_ev, want)})
                res["eval_vs_train_hs"] = (
                    max(float((a - b).abs().max()) for a, b in zip(got_ev[:2], got[:2])),
                    all(torch.equal(a, b) for a, b in zip(got_ev[:2], got[:2])))
                row["scaled_err"] = max(scaled_err(a, b) for a, b in zip(got, want))
                row["gates_scaled_err"] = scaled_err(xg, ref)
                for R in row_tiles:
                    res.update({f"fwd_rows{R}_{n}": rel_err(a, b, TOL[cd])
                                for n, a, b in zip(names, at_f32_rows(
                                    L, R, L.bilstm_fwd_wide_train_f32, xg, lengths, w_hh,
                                    cd), want)})
                torch.cuda.synchronize()
                row["max_abs_err"] = {n: e for n, (e, _) in res.items()}
                if not all(ok for _, ok in res.values()):
                    emit({"phase": "widths", "failed": row})
                    raise AssertionError(f"an f32 wide kernel disagrees with its twin: {row}")
                del ref, want, got, got_ev, again
            del parts, xg, w_ih, w_hh
        work, true_work = (wide_layer_work(sum(e), h, G, 4, ny) for e, h in ((Ep, Hp),
                                                                             (E_parts, H)))
        for k, name in (("gates", "bilstm_gates_f32"), ("fwd", "bilstm_fwd_wide_f32"),
                        ("fwd_eval", "bilstm_fwd_wide_f32")):
            row[f"{k}_bound_ms"], row[f"{k}_bound_by"] = bound([(*work[k], kernel_peak(cd, name))])
            row[f"{k}_true_bound_ms"], _ = bound([(*true_work[k], kernel_peak(cd, name))])
        lib = cudnn_stack_times(dev, cd, E=sum(E_parts), H=H, layers=1)
        row["fwd_library_ms"], row["fwd_eval_library_ms"] = (lib["cudnn_fwd_ms"],
                                                            lib["cudnn_inference_ms"])
        out[f"h{Hp}" + ("_stacked" if len(Ep) == 2 else "")] = row
    return out


def lite_f32_96(dev) -> dict:
    """The f32 lite sweep on its main path, the stacked layer of the f32
    two-layer model at embedding 80 (E = 2 x 80, run at H = 96, one weight
    group, one dy stream a direction), 400 rows: the one-block 3xTF32 sweep
    ``bilstm_bwd_lite_f32_resident.cu`` the dispatch names there, held
    against the plain twin with the main path's lengths at T = 300 (1e-4 x
    max(1, max|ref|); the same bits twice), then timed at T = 1500, full
    lengths, beside the bounds at 495/3 TFLOP/s (three tf32 passes) at the
    padded and the true widths, the twin (timed once) and cuDNN's one-layer
    f32 backward for the input at the true widths, TF32 off."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep_lite

    cd, E_parts, H, G, ny = torch.float32, [80, 80], 80, 1, 1
    name = "bilstm_bwd_lite_f32_resident"
    Hp, Ep = L.padded_width(E_parts, H, cd), list(L.padded_parts(E_parts, H, cd))
    if (Hp, L.lite_kernel(Hp, cd)) != (96, name):
        raise AssertionError(f"the stacked layer at embedding 80 in f32 runs at H={Hp} on "
                             f"{L.lite_kernel(Hp, cd)}")
    row = {"layer": "stacked layer at embedding 80", "kernel": name, "B": B_TRAIN, "T": T_TRAIN,
           "check_T": 300, "E_parts": E_parts, "H": H, "padded_H": Hp, "padded_parts": Ep,
           "G": G, "ny": ny, "tol": f"{TOL[cd]} x max(1, max|ref|)"}
    for full in (False, True):
        parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
            Ep, Hp, G, cd, dev, SEED + 96, full_lengths=full, ny=ny, T=T_TRAIN if full else 300)
        xg = L.bilstm_gates(parts, w_ih, bias, cd)
        hs_f, hs_b, _, _, cs_f, cs_b = L.bilstm_fwd_wide_train(xg, lengths, w_hh, cd)
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd)
        new = lambda: L.bilstm_bwd_lite(*args)  # noqa: E731
        if full:
            row["ms"] = time_ms(new, 3)
        else:
            ref, row["plain_ms"] = timed_once(lambda: bidir_layer_sweep_lite(*args))
            got = new()
            res = {"dgates": rel_err(got, ref, TOL[cd]),
                   "twice": (0.0, bool(torch.equal(new(), got)))}
            row["scaled_err"] = scaled_err(got, ref)
            torch.cuda.synchronize()
            row["max_abs_err"] = {n: e for n, (e, _) in res.items()}
            if not all(ok for _, ok in res.values()):
                emit({"phase": "widths", "failed": row})
                raise AssertionError(f"the f32 lite sweep at H = 96 disagrees: {row}")
            del ref, got
        del parts, xg, hs_f, hs_b, cs_f, cs_b, args
    for key, Hw, Ew in (("", Hp, sum(Ep)), ("true_", H, sum(E_parts))):
        work = wide_layer_work(Ew, Hw, G, 4, ny)["lite"]
        row[f"{key}bound_ms"], row[f"{key}bound_by"] = bound([(*work, kernel_peak(cd, name))])
    row["library_ms"] = cudnn_stack_times(dev, cd, E=sum(E_parts), H=H,
                                          layers=1)["cudnn_bwd_data_ms"]
    return row


def resident_bf16_kernels(dev, E_parts, H, G, ny, seed, sweep_want, forwards=False,
                          turns=False) -> dict:
    """The bf16 resident layer at ``E_parts``, ``H`` (``G`` weight groups,
    ``ny`` dy streams a direction, 400 rows) on a main path of its own: its
    sweep, which the dispatch must name ``sweep_want``, and with
    ``forwards`` its forward (both variants, the kernel ``fwd_kernel``
    names), each held against its plain twin with the main path's lengths
    at T = 300 (3e-2 x max(1, max|ref|); the same bits twice), then timed at
    T = 1500, full lengths, beside its bound at the bf16 rate
    (``cuda_core_bound_ms``: a CUDA-core kernel's at 67 TFLOP/s, its f32
    FMAs), the twin (timed once) and cuDNN's one-layer bf16 training
    forward, inference forward and backward for the input at the layer's
    widths, TF32 off; with ``turns`` the sweep in turns with the run-time
    ``<0, 0>`` build of ``bilstm_bwd_mma.cu`` (``generic=True``:
    ``generic_ms``) and with ``bilstm_bwd.cu`` by name (``cuda_core_ms``,
    its bound ``cuda_core_bound_ms``), new, old, old, new, both held
    against the twin too. One dict each: "bwd", and "fwd", "fwd_eval"."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep

    cd, E_parts, E = torch.bfloat16, list(E_parts), sum(E_parts)
    picked = (L.layer_route(E_parts, H, cd), L.padded_width(E_parts, H, cd),
              L.sweep_kernel(E_parts, H, cd))
    if picked != ("resident", H, sweep_want):
        raise AssertionError(f"the bf16 layer at E={E_parts}, H={H} runs {picked}")
    fwd_name = L.fwd_kernel(E_parts, H, cd)
    shape = {"B": B_TRAIN, "T": T_TRAIN, "check_T": 300, "E_parts": E_parts, "H": H, "G": G,
             "ny": ny, "dtype": "bfloat16", "tol": f"{TOL[cd]} x max(1, max|ref|)"}
    out = {"bwd": {"kernel": sweep_want, **shape}}
    if forwards:
        out["fwd"] = {"kernel": f"{fwd_name} (train)", **shape}
        out["fwd_eval"] = {"kernel": f"{fwd_name} (eval)", **shape}
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    flat = lambda r: list(r[0]) + list(r[1]) + list(r[2:])  # noqa: E731
    for full in (False, True):
        parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
            E_parts, H, G, cd, dev, seed, full_lengths=full, ny=ny, T=T_TRAIN if full else 300)
        fwd_args = (parts, lengths, w_ih, w_hh, bias, cd)
        calls = {"fwd": lambda: L.bilstm_layer_fwd_train(*fwd_args),
                 "fwd_eval": lambda: L.bilstm_layer_fwd(*fwd_args)}
        hs_f, hs_b, _, _, cs_f, cs_b = calls["fwd"]()
        args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, cd)
        calls["bwd"] = lambda: L.bilstm_bwd(*args)
        others = {"generic": lambda: L.bilstm_bwd_mma(*args, generic=True),
                  "cuda_core": lambda: L.bilstm_bwd(*args, kernel="bilstm_bwd")}
        if full:
            for k in out:
                out[k]["ms"] = time_ms(calls[k], 3)
            if turns:
                o = out["bwd"]
                o["ms"], o["ms_again"], o["generic_ms"] = in_turns(calls["bwd"],
                                                                   others["generic"], 3)
                a, b, o["cuda_core_ms"] = in_turns(calls["bwd"], others["cuda_core"], 2)
                o["ms_in_cuda_core_turns"] = [a, b]
        else:
            ref, out["bwd"]["plain_ms"] = timed_once(lambda: bidir_layer_sweep(*args))
            gnames = sweep_names(*ref[:2])
            got = flat(calls["bwd"]())
            res = {"bwd": {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(gnames, got, flat(ref))}}
            res["bwd"]["twice"] = (0.0, all(torch.equal(a, b)
                                            for a, b in zip(flat(calls["bwd"]()), got)))
            out["bwd"]["scaled_err"] = max(scaled_err(a, b) for a, b in zip(got, flat(ref)))
            if turns:
                for key, call in others.items():
                    res["bwd"].update({f"{key}_{n}": rel_err(a, b, TOL[cd])
                                       for n, a, b in zip(gnames, flat(call()), flat(ref))})
            if forwards:
                want, out["fwd"]["plain_ms"] = timed_once(
                    lambda: L.bilstm_layer_fwd_plain(*fwd_args, with_states=True))
                _, out["fwd_eval"]["plain_ms"] = timed_once(
                    lambda: L.bilstm_layer_fwd_plain(*fwd_args))
                for k in ("fwd", "fwd_eval"):
                    got_f = calls[k]()
                    res[k] = {n: rel_err(a, b, TOL[cd]) for n, a, b in zip(names, got_f, want)}
                    res[k]["twice"] = (0.0, all(torch.equal(a, b)
                                                for a, b in zip(calls[k](), got_f)))
                    out[k]["scaled_err"] = max(scaled_err(a, b) for a, b in zip(got_f, want))
                    del got_f
                del want
            torch.cuda.synchronize()
            for k, r in res.items():
                out[k]["max_abs_err"] = {n: e for n, (e, _) in r.items()}
                if not all(ok for _, ok in r.values()):
                    emit({"phase": "widths", "failed": out[k]})
                    raise AssertionError(f"{out[k]['kernel']} at E={E_parts}, H={H} disagrees "
                                         f"with its twin: {out[k]}")
            del ref, got, res
        del parts, hs_f, hs_b, cs_f, cs_b, args, fwd_args, calls, others
    work = train_layer_work(E, H, 2, ny, G=G)
    for k in out:
        name = sweep_want if k == "bwd" else fwd_name
        out[k]["bound_ms"], out[k]["bound_by"] = bound([(*work[k], kernel_peak(cd, name))])
        if name == "bilstm_bwd" or (turns and k == "bwd"):
            out[k]["cuda_core_bound_ms"], _ = bound([(*work[k], PEAK_F32_FLOPS)])
    lib = cudnn_stack_times(dev, cd, E=E, H=H, layers=1)
    for k, key in (("fwd", "cudnn_fwd_ms"), ("fwd_eval", "cudnn_inference_ms"),
                   ("bwd", "cudnn_bwd_data_ms")):
        if k in out:
            out[k]["library_ms"] = lib[key]
    return out


def k8_fwd_instances(dev) -> dict:
    """The bf16 tensor-core forward ``bilstm_fwd_mma.cu`` at each of
    ``K8_FWD_SHAPES`` (one input part where E <= H, two of E / 2 where
    E > H, as the models' stacked layers have), both variants: held against
    the plain twin at 27 rows in 3 weight groups of 9 (a short tile in each
    group), T = 1 and 5, lengths 0, 1, T and random, the second group's rows
    ending at T // 3 at most (3e-2 x max(1, max|ref|); the same bits
    twice); then the train variant at the train shape (400 rows, T = 1500,
    full lengths; 5 groups where E <= H, 1 where E > H), timed twice,
    beside its bound at the bf16 rate and cuDNN's one-layer bf16 training
    forward at the same E and H (``cudnn_stack_times``); each instance's
    registers and spill-store bytes from the build's ``-Xptxas -v``."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L

    cd, out = torch.bfloat16, {}
    built = ptxas_instances("bilstm_fwd_mma", r"bilstm_fwd_mma_kernelILi(\d+)ELi(\d+)E")
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    for H, E in K8_FWD_SHAPES:
        E_parts = [E // 2] * 2 if E > H else [E]
        if L.fwd_kernel(E_parts, H, cd) != "bilstm_fwd_mma":
            raise AssertionError(f"the bf16 forward at H={H}, E={E_parts} is not bilstm_fwd_mma")
        o = {"H": H, "E_parts": E_parts, "K": E + H, "k8_tail": (E + H) % 16 == 8,
             "registers": built.get((H, E), (None, None))[0],
             "spill_store_bytes": built.get((H, E), (None, None))[1],
             "smem": L.fwd_mma_plan(E_parts, H, cd)[1], "threads": 4 * H,
             "tol": f"{TOL[cd]} x max(1, max|ref|)", "max_abs_err": {}}
        B, G = 27, 3
        for T in (1, 5):
            g = torch.Generator(device=dev).manual_seed(SEED + 300 + H + E + T)

            def u(*shape, scale=1.0):
                return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * scale

            lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
            lengths[:3] = torch.tensor([0, 1, T], dtype=torch.int32, device=dev)
            lengths[9:18] = torch.clamp(lengths[9:18], max=T // 3)
            parts = tuple(u(T, B, e).to(cd) for e in E_parts)
            args = (parts, lengths, u(2, 4 * H, E, scale=H ** -0.5).to(cd),
                    u(2, G, 4 * H, H, scale=H ** -0.5).to(cd), u(2, 4 * H), cd)
            want = L.bilstm_layer_fwd_plain(*args, with_states=True)
            got = L.bilstm_layer_fwd_train(*args)
            ev = L.bilstm_layer_fwd(*args)
            res = {f"T{T}_{n}": rel_err(a, b, TOL[cd]) for n, a, b in zip(names, got, want)}
            res.update({f"T{T}_eval_{n}": rel_err(a, b, TOL[cd])
                        for n, a, b in zip(names, ev, want)})
            res[f"T{T}_twice"] = (0.0, all(torch.equal(a, b) for a, b in zip(
                L.bilstm_layer_fwd_train(*args), got)) and torch.equal(ev[0], got[0])
                and torch.equal(ev[1], got[1]))
            torch.cuda.synchronize()
            o["max_abs_err"].update({n: e for n, (e, _) in res.items()})
            if not all(ok for _, ok in res.values()):
                emit({"phase": "widths", "failed": o})
                raise AssertionError(f"bilstm_fwd_mma at H={H}, E={E_parts} disagrees: {o}")
            del want, got, ev, args, parts
        G = G_TRAIN if E <= H else 1
        parts, lengths, w_ih, w_hh, bias, _, _, _, _ = train_layer_inputs(
            E_parts, H, G, cd, dev, SEED + 400 + H + E, full_lengths=True, ny=1)
        args = (parts, lengths, w_ih, w_hh, bias, cd)
        o["ms"] = time_ms(lambda: L.bilstm_layer_fwd_train(*args), 3)
        o["ms_again"] = time_ms(lambda: L.bilstm_layer_fwd_train(*args), 3)
        o["library_ms"] = cudnn_stack_times(dev, cd, E=E, H=H, layers=1)["cudnn_fwd_ms"]
        work = train_layer_work(E, H, 2, 1, G=G)["fwd"]
        o["bound_ms"], o["bound_by"] = bound([(*work, kernel_peak(cd, "bilstm_fwd_mma"))])
        o.update({"B": B_TRAIN, "T": T_TRAIN, "G": G})
        out[f"h{H}_e{E}"] = o
        del parts, args
    return out


def narrow_wgrad_kernels(dev) -> dict:
    """The f32 wgrad ``bilstm_wgrad_f32.cu`` at each of
    ``NARROW_WGRAD_SHAPES`` (the f32 layers at H % 32 == 16, its 64-row
    tile): held against the plain twin at T = 300, 400 rows (5 groups with
    one input part, 1 with two) and at 27 rows in 3 groups, T = 5 (1e-4 x
    max(1, max|ref|)), then timed twice at T = 1500, beside its bound at
    495/3 TFLOP/s and at 67 (``bound_67_ms``; the deleted CUDA-core
    kernel's rate), cuBLAS f32's products, its tile, splits and the
    blocks an SM the card holds; each tile instance's registers and
    spill-store bytes from the build's ``-Xptxas -v``."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_wgrad

    cd, out = torch.float32, {}
    built = ptxas_instances("bilstm_wgrad_f32", r"bilstm_wgrad_f32_kernelILi(\d+)ELi(\d+)E")
    lib = L._kernels("bilstm_wgrad_f32")
    out["instances"] = {f"{tm}x{tn}": {"registers": r, "spill_store_bytes": sp,
                                       "blocks_an_sm": lib.bilstm_wgrad_f32_occupancy(tm, tn)}
                        for (tm, tn), (r, sp) in sorted(built.items())}
    for H, E_parts in NARROW_WGRAD_SHAPES:
        E_parts = list(E_parts)
        E = sum(E_parts)
        if L.wgrad_kernel(E_parts, H, cd) != "bilstm_wgrad_f32":
            raise AssertionError(f"the f32 wgrad at H={H}, E={E_parts} is not bilstm_wgrad_f32")
        G0 = G_TRAIN if len(E_parts) == 1 else 1
        tile = L.wgrad_f32_tile(E_parts, H)
        o = {"H": H, "E_parts": E_parts, "tile": f"{tile[0]}x{tile[1]}",
             "tol": f"{TOL[cd]} x max(1, max|ref|)", "max_abs_err": {}}
        for T, B, G in ((300, B_TRAIN, G0), (5, 27, 3 if G0 > 1 else 1), (T_TRAIN, B_TRAIN, G0)):
            g = torch.Generator(device=dev).manual_seed(SEED + 500 + H + E + T)

            def u(*shape):
                return torch.rand(*shape, generator=g, device=dev) * 2 - 1

            parts = tuple(u(T, B, e) for e in E_parts)
            hs_f, hs_b, dgc = u(T, B, H), u(T, B, H), u(2, T, B, 4 * H)
            ops = (dgc, parts, hs_f, hs_b, G)
            new = lambda: L.bilstm_wgrad(*ops)  # noqa: E731
            if T == T_TRAIN:
                o["ms"], o["ms_again"] = time_ms(new, 3), time_ms(new, 3)
                o["library_ms"] = time_ms(wgrad_library(dgc, parts, hs_f, hs_b, G), 3)
                work = train_layer_work(E, H, 4, 2, G=G)["wgrad"]
                o["bound_ms"], o["bound_by"] = bound([(*work, kernel_peak(cd, "bilstm_wgrad_f32"))])
                o["bound_67_ms"], _ = bound([(*work, PEAK_F32_FLOPS)])
                m_t, n_t, splits = L.wgrad_f32_plan(T, B, G, E_parts, H, L._sm_count(dev))
                o.update({"B": B, "T": T, "G": G, "splits": splits,
                          "blocks": m_t * n_t * splits * 2 * G})
            else:
                ref, plain_ms = timed_once(lambda: bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G))
                if T == 300:
                    o["plain_ms_T300"] = plain_ms
                res = {f"T{T}_{n}": rel_err(a, b, TOL[cd])
                       for n, a, b in zip(("dW_ih", "dW_hh"), new(), ref)}
                torch.cuda.synchronize()
                o["max_abs_err"].update({n: e for n, (e, _) in res.items()})
                if not all(ok for _, ok in res.values()):
                    emit({"phase": "widths", "failed": o})
                    raise AssertionError(f"bilstm_wgrad_f32 at H={H}, E={E_parts} disagrees: {o}")
                del ref
            del parts, hs_f, hs_b, dgc
        out[f"h{H}_e{'_'.join(map(str, E_parts))}"] = o
    return out


def phase_widths(dev) -> dict:
    """The widths the JAX package's kernels take and the port's kernels did
    not, on the card: ``padded_layer_timings``; the two-layer model at
    embedding 100 and 272 at the train shape (80 pairs, T = 1500, dropout
    on, 2 steps and an eval step) in f32 and bf16 (their steps timed), each
    with the kernels it launched (in f32 the tensor-core gates, wide
    forward and lite sweep, never the CUDA-core ones); ``lite_f32_kernels``
    (the f32 tensor-core lite sweep at 288, 256 and 128);
    ``wide_f32_kernels`` (the f32 tensor-core gates and wide forward
    there); ``lite_f32_96`` (the one-block f32 lite sweep on its main
    path); ``resident_bf16_kernels`` on layer 0 of the bf16 model at
    embedding 72 (the tensor-core sweep's and forward's <72, 72>
    instances) and on both layers of the bf16 model at embedding 16 (the
    tensor-core sweep's <16, 32> and <16, 16> instances, the stacked layer
    ``bilstm_bwd.cu``'s main path before them: each in turns with the
    run-time build and with ``bilstm_bwd.cu`` by name; the sweep's
    instances' registers and spills from the build); the bf16 two-layer model at embedding
    72 at the train shape (2 steps and an eval step, timed); the two-layer
    models at embedding 160 at the train shape (2 steps and an eval step
    each, timed: in f32 the f32 tensor-core forward and lite sweep at 160
    in both layers, in bf16 the bf16 tensor-core forward and lite sweep and
    the split wgrad);
    ``wide_cuda_core_kernels`` at embedding 272's layer 0 (H = 288, the bf16
    tensor-core forward and lite sweep), at embedding 80's stacked layer
    (H = 96: the one-block forward and lite sweep in bf16 and in f32) and at
    layer 0 at E = H = 160,
    192, 224 (in f32 the f32 tensor-core forward and lite sweep; in bf16
    the bf16 tensor-core forward's kernel for uneven unit groups and lite
    sweep; the forward's
    registers and spills from the build and its blocks an SM,
    ``fwd_mma_uneven``);
    then for each of ``WIDTH_STEPS`` one gradient
    step and an eval step of the two-layer model (8 pairs, T = 64, dropout
    0) on the card against the CPU plain path, in f32 and bf16, the listed
    kernels launched (on the recurrence backend with
    ``ops.lstm.DEFAULT_BACKEND = "recurrence"``)."""
    from intrepppid_tpu_torch.ops import lstm

    layers = padded_layer_timings(dev)
    rng = np.random.default_rng(SEED + 7)
    batches = [quintuplet_batch(rng, PAIRS_TRAIN, T_TRAIN) for _ in range(2)]
    resident = tuple(n for n in train_counters()
                     if n.startswith(("bilstm_layer_fwd", "bilstm_bwd")) and "lite" not in n)
    models = {}
    for key, dtype, width, expect in (("embedding_100_float32", torch.float32, 100, WIDE_F32),
                                      ("embedding_100_bfloat16", torch.bfloat16, 100, WIDE_BF16),
                                      ("embedding_272_bfloat16", torch.bfloat16, 272,
                                       WIDE_BF16),
                                      ("embedding_272_float32", torch.float32, 272, WIDE_F32),
                                      ("embedding_160_float32", torch.float32, 160, WIDE_F32),
                                      ("embedding_160_bfloat16", torch.bfloat16, 160,
                                       WIDE_BF16)):
        others = set(WIDE_BF16 + WIDE_F32) - set(expect)
        models[key] = f32_steps(dev, batches, expect, resident + tuple(sorted(others)),
                                eval_step=True, dtype=dtype, embedding_size=width)
    lite_f32 = lite_f32_kernels(dev)
    wide_f32 = wide_f32_kernels(dev)
    lite_96 = lite_f32_96(dev)
    bf16_72 = resident_bf16_kernels(dev, [72], 72, G_TRAIN, 2, SEED + 72, "bilstm_bwd_mma",
                                    forwards=True)
    # both layers of the bf16 model at embedding 16: the stacked layer
    # (E = 16 + 16, K = 48 run as 64) was bilstm_bwd.cu's main path
    bwd_16 = resident_bf16_kernels(dev, [16, 16], 16, 1, 1, SEED + 16, "bilstm_bwd_mma",
                                   turns=True)
    bwd_16_layer0 = resident_bf16_kernels(dev, [16], 16, G_TRAIN, 2, SEED + 17,
                                          "bilstm_bwd_mma", turns=True)
    bwd_mma_instances = {f"{H}_{E}": {"registers": r, "spill_store_bytes": sp}
                         for (H, E), (r, sp) in sorted(ptxas_instances(
                             "bilstm_bwd_mma", r"bilstm_bwd_mma_kernelILi(\d+)ELi(\d+)E").items())}
    # both layers of the bf16 model at embedding 56: the tensor-core
    # forward's <56, 56> and <56, 112> instances
    fwd_56 = resident_bf16_kernels(dev, [56], 56, G_TRAIN, 2, SEED + 56, "bilstm_bwd_mma",
                                   forwards=True)
    fwd_56_stacked = resident_bf16_kernels(dev, [56, 56], 56, 1, 1, SEED + 57, "bilstm_bwd_mma",
                                           forwards=True)
    k8_fwd = k8_fwd_instances(dev)
    narrow_wgrad = narrow_wgrad_kernels(dev)
    # the bf16 model at embedding 72 at the train shape: layer 0 on the
    # tensor-core forward and sweep (bilstm_bwd.cu never), the stacked layer
    # wide at 96 on the one-block bf16 wide forward and lite sweep
    models["embedding_72_bfloat16"] = f32_steps(
        dev, batches, ("bilstm_layer_fwd_train_mma", "bilstm_layer_fwd_mma", "bilstm_bwd_mma",
                       "bilstm_wgrad_mma", "bilstm_gates_mma",
                       "bilstm_fwd_wide_train_mma_resident", "bilstm_fwd_wide_mma_resident",
                       "bilstm_bwd_lite_mma_resident"),
        ("bilstm_bwd", "bilstm_wgrad_ih"),
        eval_step=True, dtype=torch.bfloat16, embedding_size=72)
    kernels_288 = wide_cuda_core_kernels(dev)
    kernels_96 = wide_cuda_core_kernels(dev, (80, 80), 80, 1, 1, 96, SEED + 51,
                                        "bilstm_fwd_wide_mma_resident",
                                        "bilstm_bwd_lite_mma_resident")
    kernels_96_f32 = wide_cuda_core_kernels(dev, (80, 80), 80, 1, 1, 96, SEED + 52,
                                            "bilstm_fwd_wide_f32_resident",
                                            "bilstm_bwd_lite_f32_resident", torch.float32)
    # layer 0 at E = H = 160, 192, 224, 5 groups: in f32 the f32 tensor-core
    # wide forward and lite sweep; in bf16 the bf16 tensor-core forward's
    # kernel for uneven groups and the lite sweep: timed beside their bounds
    # and cuDNN (the CUDA-core forward, retired there, no longer by name)
    kernels_f32_wide = {f"h{H}": wide_cuda_core_kernels(
        dev, (H,), H, G_TRAIN, 2, H, SEED + 53 + H, "bilstm_fwd_wide_f32", "bilstm_bwd_lite_f32",
        torch.float32) for H in (160, 192, 224)}
    kernels_bf16_wide = {f"h{H}": wide_cuda_core_kernels(
        dev, (H,), H, G_TRAIN, 2, H, SEED + 54 + H, "bilstm_fwd_wide_mma", "bilstm_bwd_lite_mma",
        torch.bfloat16) for H in (160, 192, 224)}
    steps = []
    for backend, width, dtype, expect, *never in WIDTH_STEPS:
        lstm.DEFAULT_BACKEND = "recurrence" if backend == "recurrence" else "auto"
        try:
            check = train_grad_check(dev, dtype=dtype, eval_step=True, expect=expect,
                                     never=never[0] if never else (), embedding_size=width)
        finally:
            lstm.DEFAULT_BACKEND = "auto"
        steps.append({"backend": backend, **check})
    out = {"phase": "widths", "padded_layers": layers, "models": models,
           "lite_f32": lite_f32, "wide_f32": wide_f32, "lite_f32_96": lite_96,
           "bf16_72": bf16_72, "bwd_16": bwd_16, "bwd_16_layer0": bwd_16_layer0,
           "bwd_mma_instances": bwd_mma_instances, "fwd_56": fwd_56,
           "fwd_56_stacked": fwd_56_stacked, "k8_fwd": k8_fwd, "narrow_wgrad": narrow_wgrad,
           "kernels_288": kernels_288, "kernels_96": kernels_96,
           "kernels_96_float32": kernels_96_f32, "kernels_float32_wide": kernels_f32_wide,
           "kernels_bfloat16_wide": kernels_bf16_wide,
           "fwd_mma_uneven": fwd_mma_uneven_build(dev), "grad_checks": steps}
    emit(out)
    return out


def fwd_mma_uneven_build(dev) -> dict:
    """The bf16 wide forward's kernel for uneven unit groups at 160-288, per
    instance: registers and spill bytes (the build's ``-Xptxas -v``), its
    shared memory, the blocks an SM it is compiled for (two where two fit
    the SM's shared memory, ``csrc/bilstm_fwd_wide_mma.cu:blocks_per_sm_u``)
    and the clusters the card holds at once."""
    import re

    from intrepppid_tpu_torch.ops import _build
    from intrepppid_tpu_torch.ops import lstm_cuda as L

    log = _build.build_logs.get("bilstm_fwd_wide_mma", "").splitlines()
    out = {}
    for i, line in enumerate(log):
        m = re.search(r"uneven_kernelILi(\d+)ELi(\d+)E", line)
        if not m:
            continue
        H, R = int(m.group(1)), int(m.group(2))
        nxt = next((j for j in range(i + 1, len(log)) if "Compiling entry" in log[j]), len(log))
        tail = " ".join(log[i + 1:nxt])
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores", tail)
        smem = L.wide_smem("fwd_mma", H, R)
        out[f"h{H}_rows{R}"] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(spill.group(1)) if spill else None, "smem": smem,
            "blocks_per_sm": 2 if 2 * (smem + 1024) <= 233472 else 1,
            "max_active_clusters": L._max_clusters(
                "bilstm_fwd_wide_mma", torch.bfloat16, H, dev)(R, smem)}
    if not all(f"h{H}_rows32" in out for H in (160, 192, 224, 288)):
        raise AssertionError(f"no ptxas report of the uneven forward's instances: {sorted(out)}")
    return out


# ------------------------------------------------------------ wide kernels
def wide_layer_work(E, H, G, size, ny, T=T_TRAIN, B=B_TRAIN):
    """(flops, bytes) of each wide-route kernel for one layer at full
    lengths: multiply-adds x 2 over both directions; each input read once
    and each output written once (xg and dgates are f32)."""
    rows = 2 * B * T
    stream = B * T * size
    xg = rows * 4 * H * 4
    state = B * 4 + 2 * 2 * B * H * 4
    w_hh = 2 * G * 4 * H * H * size
    return {
        "gates": (2 * rows * 4 * H * E, stream * E + 2 * 4 * H * E * size + 2 * 4 * H * 4 + xg),
        "fwd": (2 * rows * 4 * H * H, xg + w_hh + state + 4 * stream * H),
        "fwd_eval": (2 * rows * 4 * H * H, xg + w_hh + state + 2 * stream * H),
        # gate recompute and dh: 2 x 4H x H per (direction, row, step)
        "lite": (2 * rows * 4 * H * 2 * H,
                 xg + w_hh + state + 4 * stream * H + 2 * ny * stream * H + xg),
        "wgrad": (2 * rows * 4 * H * (E + H),
                  2 * stream * 4 * H + stream * E + 2 * stream * H + 2 * 4 * H * (E + G * H) * 4),
    }


def wide_layer_check(E_parts, H, G, dtype, dev, seed, T):
    """The wide kernels and wgrad against their plain versions on one
    layer's operands; each kernel takes the same inputs as its twin."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import (
        bidir_layer_sweep_lite,
        bidir_layer_wgrad,
        bidir_recurrence,
        input_gates,
    )

    parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
        E_parts, H, G, dtype, dev, seed, T=T)
    tol = TOL[dtype]
    res = {}
    xg = L.bilstm_gates(parts, w_ih, bias, dtype)
    ref = input_gates(parts, w_ih, bias, dtype)
    res["xg"] = rel_err(xg, ref, tol)
    # the backward recomputes the gates with the same dispatch: the same bits
    again = L.bilstm_gates(parts, w_ih, bias, dtype)
    res["xg_recompute_vs_first"] = (float((again - xg).abs().max()), bool(torch.equal(again, xg)))
    del again, ref
    want = bidir_recurrence(xg, lengths, w_hh, dtype, with_states=True)
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    got = L.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype)
    res.update({f"train_{n}": rel_err(a, b, tol) for n, a, b in zip(names, got, want)})
    ev = L.bilstm_fwd_wide(xg, lengths, w_hh, dtype)
    res.update({f"eval_{n}": rel_err(a, b, tol) for n, a, b in zip(names, ev, want)})
    if L.wide_fwd_kernel(H, dtype) in ("bilstm_fwd_wide_mma", "bilstm_fwd_wide_f32"):
        # the dispatch took a tensor-core forward (bf16, or 3xTF32 in f32):
        # both variants give the same hs bits
        res["eval_vs_train_hs"] = (
            max(float((a.float() - b.float()).abs().max()) for a, b in zip(ev[:2], got[:2])),
            all(torch.equal(a, b) for a, b in zip(ev[:2], got[:2])))
    del got, ev
    hs_f, hs_b, _, _, cs_f, cs_b = want
    args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, dtype)
    dgates = bidir_layer_sweep_lite(*args)
    res["dgates"] = rel_err(L.bilstm_bwd_lite(*args), dgates, tol)
    del xg, args
    dgc = dgates.to(dtype)
    del dgates
    got = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)
    ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
    res["dW_ih"], res["dW_hh"] = rel_err(got[0], ref[0], tol), rel_err(got[1], ref[1], tol)
    torch.cuda.synchronize()
    return res


def resident_layer_check(E_parts, H, G, dtype, dev, seed, T):
    """Row 4's shape on the resident route: the forward (both variants, the
    train variant against the plain forward), the sweep and wgrad against
    the plain layer backward."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_bwd

    parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
        E_parts, H, G, dtype, dev, seed, T=T)
    tol = TOL[dtype]
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    fwd_args = (parts, lengths, w_ih, w_hh, bias, dtype)
    want = L.bilstm_layer_fwd_plain(*fwd_args, with_states=True)
    got = L.bilstm_layer_fwd_train(*fwd_args)
    res = {n: rel_err(a, b, tol) for n, a, b in zip(names, got, want)}
    res.update({f"eval_{n}": rel_err(a, b, tol)
                for n, a, b in zip(names, L.bilstm_layer_fwd(*fwd_args), want)})
    hs_f, hs_b, _, _, cs_f, cs_b = want
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, dtype)
    dxf, dxb, dgc, dbias = L.bilstm_bwd(*args)
    dw_ih, dw_hh = L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)
    ref = bidir_layer_bwd(*args)
    grads = list(dxf) + list(dxb) + [dw_ih, dw_hh, dbias]
    refs = list(ref[0]) + list(ref[1]) + list(ref[2:])
    gnames = ([f"dxf{k}" for k in range(len(dxf))] + [f"dxb{k}" for k in range(len(dxb))]
              + ["dW_ih", "dW_hh", "dbias"])
    res.update({n: rel_err(a, b, tol) for n, a, b in zip(gnames, grads, refs)})
    if dtype == torch.float32:
        # the dispatch took the 3xTF32 sweep; the CUDA-core one by name
        old = L.bilstm_bwd(*args, kernel="bilstm_bwd")
        nx = 2 * len(dxf)
        res.update({f"cuda_core_{n}": rel_err(a, b, tol) for n, a, b in zip(
            gnames[:nx] + gnames[-1:], list(old[0]) + list(old[1]) + [old[3]],
            refs[:nx] + refs[-1:])})
    torch.cuda.synchronize()
    return res


def row4_timings(dev, T=300) -> dict:
    """Kernel row 4's function (a layer's backward with dx, dW_ih, dW_hh
    and dbias) at its TPU shapes, full lengths, 400 rows, f32 and bf16 at
    H = 128 and 32: the port's layer backward on its route (``layer_bwd``:
    its sweep, then ``bilstm_wgrad``), the plain layer backward, and
    cuDNN's backward for input and weights (training forward and backward,
    less the forward) in the same dtype."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_bwd

    out = {}
    for H, dtype in ((128, torch.float32), (128, torch.bfloat16), (32, torch.float32),
                     (32, torch.bfloat16)):
        t = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        work = []  # (flops, bytes, peak) of each kernel the route runs
        size = torch.empty((), dtype=dtype).element_size()
        for i, (E_parts, G) in enumerate((([H], G_TRAIN), ([H, H], 1))):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, dtype, dev, SEED + 50 + i, full_lengths=True, T=T)
            hs_f, hs_b, _, _, cs_f, cs_b = L.layer_fwd(parts, lengths, w_ih, w_hh, bias,
                                                       dtype, with_states=True)
            args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn,
                    dtype)

            def kernels(**kernel):
                if not kernel:
                    return L.layer_bwd(*args)
                dgc = L.bilstm_bwd(*args, **kernel)[2]
                return L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G)

            if dtype == torch.float32 and L.layer_route(E_parts, H, dtype) == "resident":
                # new, old, old, new: the 3xTF32 sweep and the CUDA-core one
                a, b, c = in_turns(kernels, lambda: kernels(kernel="bilstm_bwd"), 3)
                t["kernel_ms"] += a
                t["kernel_ms_again"] = t.get("kernel_ms_again", 0.0) + b
                t["kernel_cuda_core_ms"] = t.get("kernel_cuda_core_ms", 0.0) + c
            else:
                t["kernel_ms"] += time_ms(kernels, 3)
            t["plain_ms"] += timed_once(lambda: bidir_layer_bwd(*args))[1]
            lstm = torch.nn.LSTM(sum(E_parts), H, bidirectional=True).to(dev).to(dtype)
            x = (torch.rand(T, B_TRAIN, sum(E_parts), device=dev) * 2 - 1).to(dtype)
            x.requires_grad_()
            dy = (torch.rand(T, B_TRAIN, 2 * H, device=dev) * 2 - 1).to(dtype)
            fwd_ms = time_ms(lambda: lstm(x), 3)
            full_ms = time_ms(
                lambda: torch.autograd.grad(lstm(x)[0], [x, *lstm.parameters()], dy), 3)
            t["library_ms"] += full_ms - fwd_ms
            route = L.layer_route(E_parts, H, dtype)
            wgrad_peak = kernel_peak(dtype, L.wgrad_kernel(E_parts, H, dtype))
            if route == "wide":
                w = wide_layer_work(sum(E_parts), H, G, size, len(dyf), T=T)
                peaks = {"gates": kernel_peak(dtype), "lite": kernel_peak(dtype),
                         "wgrad": wgrad_peak}
            else:
                w = train_layer_work(sum(E_parts), H, size, len(dyf), T=T, G=G)
                peaks = {"bwd": kernel_peak(dtype, L.sweep_kernel(E_parts, H, dtype)),
                         "wgrad": wgrad_peak}
            work += [(*w[k], peak) for k, peak in peaks.items()]
            t[f"route_{i}"] = route
            del parts, hs_f, hs_b, cs_f, cs_b, args, lstm, x, dy
        t["bwd_flops"], t["bwd_bytes"] = (sum(w[0] for w in work), sum(w[1] for w in work))
        t["bwd_bound_ms"], t["bwd_bound_by"] = bound(work)
        out[f"H{H}_{str(dtype).replace('torch.', '')}"] = {
            "T": T, "layers": f"E={H} (5 groups) + E=2x{H}", **t}
    return out


def ragged_wide_wgrad_check(dev, H=E_SCALED) -> list:
    """The tensor-core wgrads against their twin at the scaled width where no
    size is round: 27 rows in 3 weight groups of 9 with one input part and
    in 1 group with two, T = 1 (every h_prev past an end), in bf16
    (``bilstm_wgrad_mma``) and f32 (``bilstm_wgrad_f32``)."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_wgrad

    B, T, out = 27, 1, []
    for i, (E_parts, G, cd) in enumerate((([H], 3, torch.bfloat16), ([H, H], 1, torch.bfloat16),
                                          ([H], 3, torch.float32), ([H, H], 1, torch.float32))):
        kernel = L.bilstm_wgrad_mma if cd == torch.bfloat16 else L.bilstm_wgrad_f32
        g = torch.Generator(device=dev).manual_seed(SEED + 85 + i % 2)
        parts = tuple((torch.rand(T, B, e, generator=g, device=dev) * 2 - 1).to(cd)
                      for e in E_parts)
        hs_f, hs_b = ((torch.rand(T, B, H, generator=g, device=dev) * 2 - 1).to(cd)
                      for _ in range(2))
        dgc = (torch.rand(2, T, B, 4 * H, generator=g, device=dev) * 2 - 1).to(cd)
        ref = bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G)
        got = kernel(dgc, parts, hs_f, hs_b, G)
        res = {"dW_ih": rel_err(got[0], ref[0], TOL[cd]), "dW_hh": rel_err(got[1], ref[1], TOL[cd])}
        torch.cuda.synchronize()
        check = {"kernel": kernel.__name__, "B": B, "G": G, "T": T, "H": H,
                 "E_parts": E_parts, "dtype": str(cd).replace("torch.", ""),
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "wide_kernel", "failed": check})
            raise AssertionError(f"the ragged wide wgrad disagrees with its twin: {check}")
    return out


def at_rows(candidates, rows, fn, *args):
    """``fn(*args)`` with a tensor-core wide kernel's plan held to row tiles
    of ``rows``: ``candidates`` names the plan's row tiles in
    ``ops/lstm_cuda.py`` ("LITE_MMA_ROWS", "FWD_WIDE_MMA_ROWS"), set to
    ``(rows,)`` for the call."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L

    keep = getattr(L, candidates)
    setattr(L, candidates, (rows,))
    try:
        return fn(*args)
    finally:
        setattr(L, candidates, keep)


def ragged_wide_sweep_check(dev, H=E_SCALED) -> list:
    """The tensor-core input gates, wide forward (both variants) and lite
    sweep against their twins at the scaled width where no size is round:
    27 rows in 3 weight groups of 9 (one input part) and in 1 group (two
    parts), T = 1 and 5, lengths mixing 0, 1 and T, every row tile the
    forward and the sweep take, bf16; the forward's two variants give the
    same hs bits."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_sweep_lite, bidir_recurrence, input_gates

    cd, B, out = torch.bfloat16, 27, []
    for i, (E_parts, G, T) in enumerate((([H], 3, 1), ([H, H], 1, 1), ([H], 3, 5),
                                         ([H, H], 1, 5))):
        g = torch.Generator(device=dev).manual_seed(SEED + 90 + i)

        def u(*shape):
            return torch.rand(*shape, generator=g, device=dev) * 2 - 1

        parts = tuple(u(T, B, e).to(cd) for e in E_parts)
        w_ih = (u(2, 4 * H, sum(E_parts)) * H ** -0.5).to(cd)
        w_hh = (u(2, G, 4 * H, H) * H ** -0.5).to(cd)
        bias = u(2, 4 * H)
        lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
        lengths[:3] = torch.tensor([0, 1, T], dtype=torch.int32, device=dev)
        xg = L.bilstm_gates_mma(parts, w_ih, bias, cd)
        res = {"xg": rel_err(xg, input_gates(parts, w_ih, bias, cd), TOL[cd])}
        fwd = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
        names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
        for rows in L.FWD_WIDE_MMA_ROWS:
            got = at_rows("FWD_WIDE_MMA_ROWS", rows, L.bilstm_fwd_wide_train_mma, xg, lengths,
                          w_hh, cd)
            ev = at_rows("FWD_WIDE_MMA_ROWS", rows, L.bilstm_fwd_wide_mma, xg, lengths, w_hh, cd)
            res.update({f"fwd_rows{rows}_{n}": rel_err(a, b, TOL[cd])
                        for n, a, b in zip(names, got, fwd)})
            res.update({f"fwd_eval_rows{rows}_{n}": rel_err(a, b, TOL[cd])
                        for n, a, b in zip(names, ev, fwd)})
            res[f"fwd_rows{rows}_eval_vs_train_hs"] = (
                max(float((a.float() - b.float()).abs().max()) for a, b in zip(ev[:2], got[:2])),
                all(torch.equal(a, b) for a, b in zip(ev[:2], got[:2])))
        hs_f, hs_b, _, _, cs_f, cs_b = fwd
        ny = 2 if G > 1 else 1
        dy = [u(T, B, H).to(cd) for _ in range(2 * ny)]
        args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dy[:ny], dy[ny:], u(2, B, H),
                u(2, B, H), cd)
        want = bidir_layer_sweep_lite(*args)
        for rows in L.LITE_MMA_ROWS:
            if L.wide_smem("lite_mma", H, rows) <= L.SMEM_LIMIT:
                res[f"dgates_rows{rows}"] = rel_err(
                    at_rows("LITE_MMA_ROWS", rows, L.bilstm_bwd_lite_mma, *args), want, TOL[cd])
        torch.cuda.synchronize()
        check = {"kernels": ["bilstm_gates_mma", "bilstm_fwd_wide_mma", "bilstm_bwd_lite_mma"],
                 "B": B, "G": G, "T": T,
                 "H": H, "E_parts": E_parts, "dtype": "bfloat16",
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "wide_kernel", "failed": check})
            raise AssertionError(f"a ragged tensor-core wide kernel disagrees with its twin: {check}")
    return out


def ragged_wide_f32_check(dev) -> list:
    """The f32 tensor-core input gates and wide forward (both variants, at
    every row tile it is built for) against their twins
    where no size is round: H = 128, 256 and 288, 27 rows in 3 weight groups
    of 9 (one input part) and in 1 group (two parts), T = 1 and 5, lengths
    mixing 0, 1 and T, 1e-4 x max(1, max|ref|); the gates computed twice and
    the forward's two variants give the same bits."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_recurrence, input_gates

    cd, B, out = torch.float32, 27, []
    names = ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")
    for H in L.FWD_WIDE_F32_WIDTHS:
        for i, (E_parts, G, T) in enumerate((([H], 3, 1), ([H, H], 1, 1), ([H], 3, 5),
                                             ([H, H], 1, 5))):
            g = torch.Generator(device=dev).manual_seed(SEED + 110 + 7 * H + i)

            def u(*shape):
                return torch.rand(*shape, generator=g, device=dev) * 2 - 1

            parts = tuple(u(T, B, e) for e in E_parts)
            w_ih = u(2, 4 * H, sum(E_parts)) * H ** -0.5
            w_hh = u(2, G, 4 * H, H) * H ** -0.5
            bias = u(2, 4 * H)
            lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
            lengths[:3] = torch.tensor([0, 1, T], dtype=torch.int32, device=dev)
            xg = L.bilstm_gates_f32(parts, w_ih, bias, cd)
            res = {"xg": rel_err(xg, input_gates(parts, w_ih, bias, cd), TOL[cd]),
                   "xg_twice": (0.0, bool(torch.equal(xg, L.bilstm_gates_f32(parts, w_ih, bias,
                                                                             cd))))}
            want = bidir_recurrence(xg, lengths, w_hh, cd, with_states=True)
            for R in L.fwd_wide_f32_rows(H):
                got = at_f32_rows(L, R, L.bilstm_fwd_wide_train_f32, xg, lengths, w_hh, cd)
                ev = at_f32_rows(L, R, L.bilstm_fwd_wide_f32, xg, lengths, w_hh, cd)
                res.update({f"fwd_rows{R}_{n}": rel_err(a, b, TOL[cd])
                            for n, a, b in zip(names, got, want)})
                res.update({f"fwd_eval_rows{R}_{n}": rel_err(a, b, TOL[cd])
                            for n, a, b in zip(names, ev, want)})
                res[f"fwd_rows{R}_eval_vs_train_hs"] = (
                    max(float((a - b).abs().max()) for a, b in zip(ev[:2], got[:2])),
                    all(torch.equal(a, b) for a, b in zip(ev[:2], got[:2])))
            torch.cuda.synchronize()
            check = {"kernels": ["bilstm_gates_f32", "bilstm_fwd_wide_f32"], "B": B, "G": G,
                     "T": T, "H": H, "E_parts": E_parts, "dtype": "float32",
                     "max_abs_err": {n: e for n, (e, _) in res.items()},
                     "tol": f"{TOL[cd]} x max(1, max|ref|)"}
            out.append(check)
            if not all(ok for _, ok in res.values()):
                emit({"phase": "wide_kernel", "failed": check})
                raise AssertionError(f"a ragged f32 wide kernel disagrees with its twin: {check}")
    return out


# the bf16 wide route's weight gradient split as the JAX lite mode splits it
# (dW_ih on cuBLAS, dW_hh on bilstm_wgrad_mma with no input part), timed on
# the wide layers (E parts, H at their true widths; weight groups) of the
# scaled step (H = 256), of the bf16 models at embedding 160 and 272 (run at
# 288) and of the stacked layer of the bf16 model at embedding 80 (at 96)
WGRAD_SPLIT_LAYERS = {
    "h256": ((([E_SCALED], E_SCALED), G_TRAIN), (([E_SCALED, E_SCALED], E_SCALED), 1)),
    "h160": ((([160], 160), G_TRAIN), (([160, 160], 160), 1)),
    "h288": ((([272], 272), G_TRAIN), (([272, 272], 272), 1)),
    "h96": ((([80, 80], 80), 1),),
    # the stacked layer of the bf16 model at embedding 72, run at the same
    # padded shape as embedding 80's (96, parts of 80)
    "h96_e72": ((([72, 72], 72), 1),),
}


def wgrad_split_timings(dev) -> dict:
    """``bilstm_wgrad_split`` on each width's layers of ``WGRAD_SPLIT_LAYERS``
    at their padded shapes, at the train shape (400 rows, T = 1500, random
    bf16 operands): held against the plain sums (``TOL``), timed in turns
    with the whole ``bilstm_wgrad_mma`` kernel on the same operands (split,
    whole, whole, split), its two parts alone (``dw_ih_ms``: the cuBLAS
    products, ``dw_hh_ms``: the kernel's launch with no input part) and
    cuBLAS bf16 products of all of it (``wgrad_library``, a yardstick the
    port never calls), each summed over the width's layers; the bounds of
    the whole work and of each part at the bf16 rate (each operand read
    once, the f32 results written once)."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import bidir_layer_wgrad

    cd, size, rows = torch.bfloat16, 2, T_TRAIN * B_TRAIN
    out = {}
    for tag, layers in WGRAD_SPLIT_LAYERS.items():
        t = {k: 0.0 for k in ("ms", "ms_again", "whole_ms", "dw_ih_ms", "dw_hh_ms",
                              "library_ms", "plain_ms")}
        work = {k: [0.0, 0.0] for k in ("whole", "dw_ih", "dw_hh")}
        errs, shapes = [], []
        for i, ((E_true, H_true), G) in enumerate(layers):
            if L.layer_route(E_true, H_true, cd) != "wide":
                raise AssertionError(f"E={E_true}, H={H_true} does not run wide in bf16")
            H = L.padded_width(E_true, H_true, cd)
            E_parts = list(L.padded_parts(E_true, H_true, cd))
            shapes.append({"E_parts": E_parts, "H": H, "G": G})
            g = torch.Generator(device=dev).manual_seed(SEED + 60 + H + i)

            def u(*shape):
                return (torch.rand(*shape, generator=g, device=dev) * 2 - 1).to(cd)

            dgc, hs_f, hs_b = u(2, T_TRAIN, B_TRAIN, 4 * H), u(T_TRAIN, B_TRAIN, H), u(
                T_TRAIN, B_TRAIN, H)
            parts = tuple(u(T_TRAIN, B_TRAIN, e) for e in E_parts)
            want, plain_ms = timed_once(lambda: bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G))
            got = L.bilstm_wgrad_split(dgc, parts, hs_f, hs_b, G)
            for a, b in zip(got, want):
                e, ok = rel_err(a, b, TOL[cd])
                errs.append(e)
                if not ok:
                    emit({"phase": "wide_kernel", "failed": {
                        "kernel": "bilstm_wgrad_split", "H": H, "E_parts": E_parts,
                        "max_abs_err": e, "tol": f"{TOL[cd]} x max(1, max|ref|)"}})
                    raise AssertionError(f"the split wgrad at H={H} disagrees: {e}")
            del want, got
            a, b, c = in_turns(lambda: L.bilstm_wgrad_split(dgc, parts, hs_f, hs_b, G),
                               lambda: L.bilstm_wgrad_mma(dgc, parts, hs_f, hs_b, G), 3)
            t["ms"] += a
            t["ms_again"] += b
            t["whole_ms"] += c
            t["dw_ih_ms"] += time_ms(lambda: L.bilstm_wgrad_ih(dgc, parts), 3)
            t["dw_hh_ms"] += time_ms(lambda: L.bilstm_wgrad_mma(dgc, (), hs_f, hs_b, G), 3)
            t["library_ms"] += time_ms(wgrad_library(dgc, parts, hs_f, hs_b, G), 3)
            t["plain_ms"] += plain_ms
            E = sum(E_parts)
            dgc_bytes = 2 * rows * 4 * H * size
            for k, f, nbytes in (
                    ("dw_ih", 2 * 2 * rows * 4 * H * E, dgc_bytes + rows * E * size
                     + 2 * 4 * H * E * 4),
                    ("dw_hh", 2 * 2 * rows * 4 * H * H, dgc_bytes + 2 * rows * H * size
                     + 2 * G * 4 * H * H * 4),
                    ("whole", 2 * 2 * rows * 4 * H * (E + H), dgc_bytes + rows * E * size
                     + 2 * rows * H * size + 2 * 4 * H * (E + G * H) * 4)):
                work[k][0] += f
                work[k][1] += nbytes
            del dgc, hs_f, hs_b, parts
        for k, (f, nbytes) in work.items():
            t[f"{k}_bound_ms"], t[f"{k}_bound_by"] = bound([(f, nbytes, PEAK_BF16_FLOPS)])
        t["max_abs_err"] = max(errs)
        t["layers"] = shapes
        out[tag] = t
    return out


def phase_wide_kernel(dev) -> dict:
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm import (
        bidir_layer_sweep_lite,
        bidir_layer_wgrad,
        bidir_recurrence,
        input_gates,
    )

    H = E_SCALED
    scaled = [([E_SCALED], G_TRAIN), ([H, H], 1)]
    cases = [("wide", H, E_parts, G, T_TRAIN) for E_parts, G in scaled]
    # row 4's shapes (lstm_pallas_layer.py:603): H = 128 routes wide, H = 32
    # stays resident; layer 0 with grouped W_hh and a stacked layer of two parts
    cases += [("wide", 128, E_parts, G, 300) for E_parts, G in (([128], G_TRAIN), ([128, 128], 1))]
    cases += [("resident", 32, E_parts, G, 300) for E_parts, G in (([32], G_TRAIN), ([32, 32], 1))]
    checks = []
    for i, (route, h, E_parts, G, T) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            if L.layer_route(E_parts, h, dtype) != route:
                raise AssertionError(f"H={h}, E_parts={E_parts} does not take the {route} route")
            run = wide_layer_check if route == "wide" else resident_layer_check
            res = run(E_parts, h, G, dtype, dev, SEED + 30 + i, T)
            check = {"route": route, "B": B_TRAIN, "T": T, "H": h, "G": G, "E_parts": E_parts,
                     "dtype": str(dtype).replace("torch.", ""),
                     "kernels": ([L.gates_kernel(E_parts, h, dtype), L.wide_fwd_kernel(h, dtype),
                                  L.lite_kernel(h, dtype), L.wgrad_kernel(E_parts, h, dtype)]
                                 if route == "wide" else []),
                     "max_abs_err": {n: e for n, (e, _) in res.items()},
                     "tol": f"{TOL[dtype]} x max(1, max|ref|)"}
            checks.append(check)
            if not all(ok for _, ok in res.values()):
                emit({"phase": "wide_kernel", "failed": check})
                raise AssertionError(f"a {route}-route kernel disagrees with its twin: {check}")

    ragged = (ragged_wide_wgrad_check(dev) + ragged_wide_sweep_check(dev)
              + ragged_wide_f32_check(dev))

    # times at full lengths, summed over layer 0 and one stacked layer
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        bf16 = dtype == torch.bfloat16
        t: dict = {}
        work = {k: [0.0, 0.0] for k in ("gates", "fwd", "fwd_eval", "lite", "wgrad")}

        def add(key, ms):
            t[key] = t.get(key, 0.0) + ms

        for i, (E_parts, G) in enumerate(scaled):
            parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = train_layer_inputs(
                E_parts, H, G, dtype, dev, SEED + 40 + i, full_lengths=True)
            xg = L.bilstm_gates(parts, w_ih, bias, dtype)
            hs_f, hs_b, _, _, cs_f, cs_b = L.bilstm_fwd_wide_train(xg, lengths, w_hh, dtype)
            lite_args = (xg, lengths, w_hh, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, dtype)
            dgc = L.bilstm_bwd_lite(*lite_args).to(dtype)
            fwd_args = (xg, lengths, w_hh, dtype)
            # each alone (their CUDA-core kernels are gone); the wgrad twice
            alone = [("gates", lambda: L.bilstm_gates(parts, w_ih, bias, dtype)),
                     ("lite", lambda: L.bilstm_bwd_lite(*lite_args)),
                     ("fwd", lambda: L.bilstm_fwd_wide_train(*fwd_args)),
                     ("fwd_eval", lambda: L.bilstm_fwd_wide(*fwd_args)),
                     ("wgrad", lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G))]
            for key, new in alone:
                add(f"{key}_ms", time_ms(new, 3))
            add("wgrad_ms_again", time_ms(alone[-1][1], 3))
            if bf16:
                # the forward's and the sweep's row tiles on the same operands
                for rows in L.FWD_WIDE_MMA_ROWS:
                    add(f"fwd_rows{rows}_ms", time_ms(lambda: at_rows(
                        "FWD_WIDE_MMA_ROWS", rows, L.bilstm_fwd_wide_train_mma, *fwd_args), 3))
                    add(f"fwd_eval_rows{rows}_ms", time_ms(lambda: at_rows(
                        "FWD_WIDE_MMA_ROWS", rows, L.bilstm_fwd_wide_mma, *fwd_args), 3))
                for rows in L.LITE_MMA_ROWS:
                    if L.wide_smem("lite_mma", H, rows) <= L.SMEM_LIMIT:
                        add(f"lite_rows{rows}_ms",
                            time_ms(lambda: at_rows("LITE_MMA_ROWS", rows, L.bilstm_bwd_lite_mma,
                                                    *lite_args), 3))
            # the plain versions, timed once each (Python loops over T)
            add("gates_plain_ms", timed_once(lambda: input_gates(parts, w_ih, bias, dtype))[1])
            add("fwd_plain_ms", timed_once(
                lambda: bidir_recurrence(xg, lengths, w_hh, dtype, with_states=True))[1])
            add("fwd_eval_plain_ms", timed_once(
                lambda: bidir_recurrence(xg, lengths, w_hh, dtype))[1])
            lite_ref, lite_plain_ms = timed_once(lambda: bidir_layer_sweep_lite(*lite_args))
            add("lite_plain_ms", lite_plain_ms)
            if bf16:
                # H = 288's instance for uneven unit groups at this width (4
                # groups a block), held against the twin and timed in turns
                # with this width's kernel: whether one kernel could serve both
                uneven = lambda: L.bilstm_bwd_lite_mma(*lite_args, uneven=True)  # noqa: E731
                e, ok = rel_err(uneven(), lite_ref, TOL[dtype])
                torch.cuda.synchronize()
                t["lite_uneven_max_abs_err"] = max(e, t.get("lite_uneven_max_abs_err", 0.0))
                if not ok:
                    emit({"phase": "wide_kernel", "failed": {
                        "kernel": "bilstm_bwd_lite_mma (uneven)", "H": H, "E_parts": E_parts,
                        "max_abs_err": e, "tol": f"{TOL[dtype]} x max(1, max|ref|)"}})
                    raise AssertionError(f"the uneven lite sweep at H={H} disagrees: {e}")
                a, b, c = in_turns(uneven, lambda: L.bilstm_bwd_lite_mma(*lite_args), 3)
                add("lite_uneven_ms", a)
                add("lite_uneven_ms_again", b)
                add("lite_even_ms", c)
                t["lite_uneven_rows"] = L.wide_plan(
                    "lite_mma_uneven", B_TRAIN, G, H,
                    L._max_clusters("bilstm_bwd_lite_mma", dtype, H, dev))[0]
            del lite_ref
            add("wgrad_plain_ms", timed_once(
                lambda: bidir_layer_wgrad(dgc, parts, hs_f, hs_b, G))[1])
            # yardsticks the port never calls, in the same dtype: one cuBLAS
            # call for the input gates of both directions (f32 out), cuBLAS for
            # the weight gradients, cuDNN for the recurrence and the sweep
            x = torch.cat(parts, dim=-1).reshape(T_TRAIN * B_TRAIN, -1)
            w_t, b = w_ih.reshape(8 * H, -1).t(), bias.reshape(-1)
            if bf16:
                add("gates_library_ms",
                    time_ms(lambda: torch.addmm(b, x, w_t, out_dtype=torch.float32), 3))
                add("gates_library_bf16_out_ms",
                    time_ms(lambda: torch.addmm(b.to(dtype), x, w_t).float(), 3))
            else:
                add("gates_library_ms", time_ms(lambda: torch.addmm(b, x, w_t), 3))
            add("wgrad_library_ms", time_ms(wgrad_library(dgc, parts, hs_f, hs_b, G), 3))
            if bf16:
                # the tensor-core wgrad in turns with its cuBLAS yardstick on
                # the same operands (kernel, cuBLAS, cuBLAS, kernel)
                a, b, c = in_turns(lambda: L.bilstm_wgrad(dgc, parts, hs_f, hs_b, G),
                                   wgrad_library(dgc, parts, hs_f, hs_b, G), 3)
                add("wgrad_turns_ms", a)
                add("wgrad_turns_ms_again", b)
                add("wgrad_library_turns_ms", c)
            del x, w_t
            lstm = torch.nn.LSTM(sum(E_parts), H, bidirectional=True).to(dev).to(dtype)
            xl = (torch.rand(T_TRAIN, B_TRAIN, sum(E_parts), device=dev) * 2 - 1).to(dtype)
            xl.requires_grad_()
            dy = (torch.rand(T_TRAIN, B_TRAIN, 2 * H, device=dev) * 2 - 1).to(dtype)
            fwd_ms = time_ms(lambda: lstm(xl), 3)
            with torch.inference_mode():
                add("fwd_eval_library_ms", time_ms(lambda: lstm(xl), 3))
            for prm in lstm.parameters():
                prm.requires_grad_(False)
            data_ms = time_ms(lambda: torch.autograd.grad(lstm(xl)[0], [xl], dy), 3)
            add("fwd_library_ms", fwd_ms)
            add("lite_library_ms", data_ms - fwd_ms)
            del lstm, xl, dy
            for k, (f, b) in wide_layer_work(sum(E_parts), H, G, size, len(dyf)).items():
                work[k][0] += f
                work[k][1] += b
            del parts, xg, hs_f, hs_b, cs_f, cs_b, dgc, lite_args, fwd_args, alone
        # the f32 tensor-core kernels run three tf32 products for each f32
        # one; the bounds at the CUDA cores' f32 rate beside them
        add_bounds(t, work, dtype, None if bf16 else {
            "wgrad": kernel_peak(dtype, "bilstm_wgrad_f32"),
            "lite": kernel_peak(dtype, "bilstm_bwd_lite_f32"),
            "gates": kernel_peak(dtype, "bilstm_gates_f32"),
            "fwd": kernel_peak(dtype, "bilstm_fwd_wide_f32"),
            "fwd_eval": kernel_peak(dtype, "bilstm_fwd_wide_f32")})
        if not bf16:
            for key in ("wgrad", "lite"):
                t[f"{key}_cuda_core_bound_ms"], t[f"{key}_cuda_core_bound_by"] = bound(
                    [(*work[key], PEAK_F32_FLOPS)])
        timings[name] = t
    timings["row4"] = row4_timings(dev)
    cluster_counts = {f"{k[0]} {str(k[1]).replace('torch.', '')} H={k[2]}"
                      f"{''.join(f' {c}' for c in k[3:-3])} R={k[-3]}": v
                      for k, v in L._cluster_counts.items()}
    out = {"phase": "wide_kernel", "checks": checks, "ragged_checks": ragged,
           "timings": timings, "wgrad_split": wgrad_split_timings(dev),
           "max_active_clusters": cluster_counts,
           "shape": {"B": B_TRAIN, "groups": G_TRAIN, "T": T_TRAIN, "H": H,
                     "layers": "E=256 (grouped W_hh) + E=2x256"}}
    emit(out)
    return out


def phase_train_scaled(dev, warmup=2, steps=6) -> dict:
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.train import Trainer

    rng = np.random.default_rng(SEED + 2)
    net = intrepppid_network(steps_per_epoch=100, embedding_size=E_SCALED,
                             rnn_num_layers=LAYERS_SCALED, compute_dtype=torch.bfloat16,
                             optimizer_type="ranger21_xx", device=dev, seed=SEED)
    trainer = Trainer(net, seed=SEED)
    batches = [quintuplet_batch(rng, PAIRS_TRAIN, T_TRAIN) for _ in range(3)]
    counters = train_counters()
    # the main path: the train steps and the eval step below
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t = time.perf_counter()
        aux = trainer.train_step(batches[i % len(batches)])
        losses.append(aux["loss"].item())
        if i >= warmup:
            step_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    eval_loss = trainer.eval_step(batches[0])["loss"].item()
    eval_ms = (time.perf_counter() - t) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    breakdown = profile_device(
        lambda: trainer.train_step(batches[0])["loss"].item(), top=12,
        groups={"gates_mma": "bilstm_gates_mma_kernel",
                "gates_f32": "bilstm_gates_f32_kernel",
                "fwd_wide_mma": "bilstm_fwd_wide_mma_kernel",
                "fwd_wide": "bilstm_fwd_wide_kernel",
                "fwd_wide_f32": "bilstm_fwd_wide_f32_kernel",
                "lite_mma": "bilstm_bwd_lite_mma_kernel",
                "lite_f32": "bilstm_bwd_lite_f32_kernel",
                "wgrad_mma": "bilstm_wgrad_mma_kernel",
                "wgrad_f32": "bilstm_wgrad_f32_kernel",
                "gemm": ("gemm", "nvjet", "xmma")})
    if not all(np.isfinite(losses + [eval_loss])):
        raise AssertionError(f"non-finite scaled loss: {losses}, eval {eval_loss}")
    missing = [n for n in WIDE_BF16 if launches[n] <= 0]
    old = [n for n in ("bilstm_layer_fwd_train", "bilstm_layer_fwd_train_mma", "bilstm_bwd",
                       "bilstm_bwd_mma", "bilstm_layer_fwd", "bilstm_layer_fwd_mma",
                       "bilstm_wgrad", "bilstm_wgrad_f32", "bilstm_layer_fwd_f32",
                       "bilstm_layer_fwd_train_f32", "bilstm_bwd_f32", "bilstm_gates_f32", "bilstm_fwd_wide_train_f32", "bilstm_fwd_wide_f32",
                       "bilstm_bwd_lite_f32")
           if launches[n] != 0]
    if missing or old:
        raise AssertionError(
            f"the scaled steps missed {missing} or ran the resident kernels or the CUDA-core "
            f"gates, forward, sweep or wgrad: {old}")
    del trainer, net
    # card gradients at the scaled widths: in f32 (the 3xTF32 gates, wide
    # forward, lite sweep and wgrad, whose main path this step and the eval
    # step after it are) and in bf16 (the tensor-core ones)
    grad_check = train_grad_check(dev, eval_step=True, embedding_size=E_SCALED,
                                  rnn_num_layers=LAYERS_SCALED)
    grad_check_bf16 = train_grad_check(dev, dtype=torch.bfloat16, embedding_size=E_SCALED,
                                       rnn_num_layers=LAYERS_SCALED)
    for check, want, never in (
            (grad_check, WIDE_F32, WIDE_BF16),
            (grad_check_bf16, ("bilstm_gates_mma", "bilstm_bwd_lite_mma", "bilstm_wgrad_mma",
                               "bilstm_fwd_wide_train_mma", "bilstm_wgrad_ih"),
             WIDE_F32)):
        ran = check["launches"]
        if any(ran.get(n, 0) <= 0 for n in want) or any(ran.get(n, 0) for n in never):
            raise AssertionError(f"the {check['dtype']} gradient step at the scaled widths ran "
                                 f"{ran}; it must run {want} and never {never}")
    median = float(np.median(step_ms))
    out = {"phase": "train_scaled", "embedding": E_SCALED, "layers": LAYERS_SCALED,
           "pairs": PAIRS_TRAIN, "T": T_TRAIN, "dtype": "bfloat16", "optimizer": "ranger21_xx",
           "dropout": 0.3, "step_ms": step_ms, "median_step_ms": median,
           "pairs_per_s": PAIRS_TRAIN / median * 1e3, "losses": losses,
           "eval_loss": eval_loss, "eval_step_ms": eval_ms, "launches": launches,
           "peak_memory_gib": peak_gib, "step_profile": breakdown, "grad_check": grad_check,
           "grad_check_bf16": grad_check_bf16}
    emit(out)
    return out


# ------------------------------------------------- the time-major recurrence
D_REC = 2
# (H, G, T): the manuscript width with the train step's 5 weight groups and
# with shared weights, the scaled width, and H = 32
REC_SHAPES = ((H_SERVE, G_TRAIN, T_TRAIN), (H_SERVE, 1, T_TRAIN), (E_SCALED, G_TRAIN, T_TRAIN),
              (32, G_TRAIN, 300))


def recurrence_inputs(T, H, G, dtype, dev, mask, seed, B=B_TRAIN, D=D_REC):
    """Operands of the recurrence op. ``mask`` "lengths": ``valid`` as the
    layer builds it, a prefix for direction 0 and a suffix for direction 1,
    lengths mixing 0, 1, T and random values; "holes": drawn at random
    (70 % on) with an all-zero and an all-one row."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 2 - 1

    xg = u(T, D, B, 4 * H)
    w = (u(D, G, H, 4 * H) * H ** -0.5).to(dtype).contiguous()
    if mask == "lengths":
        lengths = torch.randint(0, T + 1, (B,), generator=g, device=dev)
        lengths[0], lengths[1], lengths[2] = 0, 1, T
        lengths[3::4] = T
        steps = torch.arange(T, device=dev)
        valid = torch.stack([steps[:, None] < lengths[None, :],
                             (T - 1 - steps)[:, None] < lengths[None, :]], dim=1)
    else:
        valid = torch.rand(T, D, B, generator=g, device=dev) < 0.7
        valid[:, :, 0] = False
        valid[:, :, 1] = True
    return xg, valid, w, u(T, D, B, H), u(D, B, H), u(D, B, H)


def recurrence_work(T, H, G, size, B=B_TRAIN, D=D_REC):
    """(flops, bytes) of each recurrence kernel: every step is computed
    whatever the mask, 4H x H multiply-adds per row, step and direction
    (twice in the sweep: gate recompute and dh); each input read once and
    each output written once (every stream f32, the mask one byte)."""
    rows = D * B * T
    state = D * B * H * 4
    w = D * G * H * 4 * H
    xg, st = rows * 4 * H * 4, rows * H * 4
    return {
        "fwd": (2 * rows * 4 * H * H, xg + rows + w * size + 2 * st + 2 * state),
        "bwd": (2 * rows * 4 * H * 2 * H, xg + rows + w * size + 3 * st + 2 * state + xg),
        "wgrad": (2 * D * B * (T - 1) * 4 * H * H, st + xg + w * 4),
    }


def timed_once(fn):
    """(result, ms) of one call, CUDA events around it: for the plain
    versions, whose Python loops over T are too slow to repeat."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def recurrence_library(T, H, dev, B=B_TRAIN, dtype=torch.float32):
    """cuDNN yardstick in ``dtype``, TF32 off: one bidirectional ``nn.LSTM``
    layer (input width H) at full lengths. It also does the input
    projection, which the op takes precomputed. Training-mode forward, and
    the backward for the input alone (training forward and backward, less
    the forward)."""
    lstm = torch.nn.LSTM(H, H, bidirectional=True).to(dev).to(dtype)
    lstm.flatten_parameters()
    x = (torch.rand(T, B, H, device=dev) * 2 - 1).to(dtype).requires_grad_()
    dy = (torch.rand(T, B, 2 * H, device=dev) * 2 - 1).to(dtype)
    fwd_ms = time_ms(lambda: lstm(x), 3)
    for prm in lstm.parameters():
        prm.requires_grad_(False)
    data_ms = time_ms(lambda: torch.autograd.grad(lstm(x)[0], [x], dy), 3)
    return fwd_ms, data_ms - fwd_ms


def ragged_recurrence_check(dev) -> list:
    """The tensor-core recurrence sweeps against their twin where no size is
    round: 27 rows in 3 weight groups of 9, T = 1, D = 2, both masks, bf16
    and f32 (3xTF32); the tensor-core forwards there, bf16 and f32 (3xTF32),
    at H = 64 and 32, T = 1 and 5, D = 1, 2 and 3, both masks; then the tensor-core wgrads
    there, bf16 and f32 (3xTF32), at T = 1 (no row), 2 and 5, at H = 64 and
    at H = 96 (a partial column tile)."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import (
        recurrence_fwd,
        recurrence_sweep,
        recurrence_wgrad,
    )

    cd, out = torch.bfloat16, []
    for sweep, mask in ((sweep, mask) for sweep in (L.lstm_recurrence_bwd_mma,
                                                    L.lstm_recurrence_bwd_f32)
                        for mask in ("lengths", "holes")):
        dt = torch.bfloat16 if sweep is L.lstm_recurrence_bwd_mma else torch.float32
        xg, valid, w, dhs, dhn, dcn = recurrence_inputs(1, H_SERVE, 3, dt, dev, mask,
                                                        SEED + 80, B=27)
        hs, cs, _, _ = recurrence_fwd(xg, valid, w, 3, dt)
        args = (xg, valid, w, hs, cs, dhs, dhn, dcn, 3, dt)
        e, ok = rel_err(sweep(*args), recurrence_sweep(*args), TOL[dt])
        torch.cuda.synchronize()
        check = {"kernel": sweep.__name__, "B": 27, "G": 3, "T": 1, "D": D_REC,
                 "H": H_SERVE, "dtype": str(dt).replace("torch.", ""), "mask": mask,
                 "max_abs_err": {"dxg": e}, "tol": f"{TOL[dt]} x max(1, max|ref|)"}
        out.append(check)
        if not ok:
            emit({"phase": "recurrence_kernel", "failed": check})
            raise AssertionError(f"the ragged recurrence sweep disagrees with its twin: {check}")
    for (fwd, dt), (H, T, D, mask) in ((f, c) for f in (
            (L.lstm_recurrence_fwd_mma, torch.bfloat16), (L.lstm_recurrence_fwd_f32, torch.float32))
            for c in ((H_SERVE, 1, 2, "lengths"), (H_SERVE, 5, 3, "holes"),
                      (32, 5, 2, "lengths"), (32, 1, 1, "holes"))):
        xg, valid, w, _, _, _ = recurrence_inputs(T, H, 3, dt, dev, mask, SEED + 81 + T, B=27,
                                                  D=D)
        res = {n: rel_err(a, b, TOL[dt]) for n, a, b in zip(
            ("hs", "cs", "hn", "cn"), fwd(xg, valid, w, 3, dt),
            recurrence_fwd(xg, valid, w, 3, dt))}
        torch.cuda.synchronize()
        check = {"kernel": fwd.__name__, "B": 27, "G": 3, "T": T, "D": D, "H": H,
                 "dtype": str(dt).replace("torch.", ""), "mask": mask,
                 "max_abs_err": {n: e for n, (e, _) in res.items()},
                 "tol": f"{TOL[dt]} x max(1, max|ref|)"}
        out.append(check)
        if not all(ok for _, ok in res.values()):
            emit({"phase": "recurrence_kernel", "failed": check})
            raise AssertionError(f"the ragged recurrence forward disagrees with its twin: {check}")
    for (wgrad, cd), H, T in ((k, H, T) for k in (
        (L.lstm_recurrence_wgrad_mma, torch.bfloat16),
        (L.lstm_recurrence_wgrad_f32, torch.float32)) for H in (H_SERVE, 96) for T in (1, 2, 5)):
        g = torch.Generator(device=dev).manual_seed(SEED + 85 + T)
        hs = torch.rand(T, D_REC, 27, H, generator=g, device=dev) * 2 - 1
        dxg = torch.rand(T, D_REC, 27, 4 * H, generator=g, device=dev) * 2 - 1
        e, ok = rel_err(wgrad(hs, dxg, 3, cd), recurrence_wgrad(hs, dxg, 3, cd), TOL[cd])
        torch.cuda.synchronize()
        check = {"kernel": wgrad.__name__, "B": 27, "G": 3, "T": T, "D": D_REC,
                 "H": H, "dtype": str(cd).replace("torch.", ""), "max_abs_err": {"dw": e},
                 "tol": f"{TOL[cd]} x max(1, max|ref|)"}
        out.append(check)
        if not ok:
            emit({"phase": "recurrence_kernel", "failed": check})
            raise AssertionError(
                f"the ragged recurrence wgrad disagrees with its twin: {check}")
    return out


def op_sweep_h128(dev, H=128) -> dict:
    """The op at H = 128 on its main paths' shapes, the one-layer model at
    embedding 128 on the recurrence backend: D = 2, 400 rows in 5 weight
    groups, T = 1500. The sweep and the forward are the tensor-core ones of
    96-288: ``lstm_recurrence_{bwd,fwd}_mid_f32.cu`` in f32 (three tf32
    passes), ``lstm_recurrence_{bwd,fwd}_mid_mma.cu`` in bf16. Masks from
    lengths and with holes, each held against its plain twin (timed once;
    1e-4 x max(1, max|ref|) in f32, 3e-2 in bf16) and computed twice (the
    same bits); the sweep and the forward timed twice, each beside its
    bound (f32 at 495/3 TFLOP/s, bf16 at 989)
    and cuDNN's one-layer training forward and backward for the input, TF32
    off."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import recurrence_fwd, recurrence_sweep

    G, out = G_TRAIN, {}
    for cd in (torch.float32, torch.bfloat16):
        dt = str(cd).replace("torch.", "")
        size = torch.empty((), dtype=cd).element_size()
        sweep, fwd = L.recurrence_sweep_kernel(H, cd), L.recurrence_fwd_kernel(H, cd)
        kind = "f32" if cd == torch.float32 else "mma"
        if (sweep, fwd) != (f"lstm_recurrence_bwd_mid_{kind}", f"lstm_recurrence_fwd_mid_{kind}"):
            raise AssertionError(f"H={H} in {dt} runs {sweep} and {fwd}")
        o = {"kernel": sweep, "fwd_kernel": fwd, "B": B_TRAIN, "T": T_TRAIN, "D": D_REC, "H": H,
             "G": G, "dtype": dt, "tol": f"{TOL[cd]} x max(1, max|ref|)", "max_abs_err": {}}
        for mask in ("lengths", "holes"):
            xg, valid, w, dhs, dhn, dcn = recurrence_inputs(T_TRAIN, H, G, cd, dev, mask,
                                                            SEED + 90)
            (hs, cs, hn, cn), fwd_plain_ms = timed_once(lambda: recurrence_fwd(xg, valid, w, G,
                                                                               cd))
            args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
            want, plain_ms = timed_once(lambda: recurrence_sweep(*args))
            got = L.lstm_recurrence_bwd(*args)
            new_fwd = lambda: L.lstm_recurrence_fwd(xg, valid, w, G, cd)  # noqa: E731
            fgot = new_fwd()
            res = {f"{mask}_dxg": rel_err(got, want, TOL[cd]),
                   f"{mask}_twice": (0.0, bool(torch.equal(got, L.lstm_recurrence_bwd(*args)))),
                   f"fwd_{mask}_twice": (0.0, all(torch.equal(a, b)
                                                  for a, b in zip(fgot, new_fwd())))}
            res.update({f"fwd_{mask}_{n}": rel_err(a, b, TOL[cd]) for n, a, b in zip(
                ("hs", "cs", "hn", "cn"), fgot, (hs, cs, hn, cn))})
            torch.cuda.synchronize()
            o["max_abs_err"].update({n: e for n, (e, _) in res.items()})
            if not all(ok for _, ok in res.values()):
                emit({"phase": "recurrence_kernel", "failed": o})
                raise AssertionError(f"the op at H={H} disagrees with its plain version: {o}")
            new = lambda: L.lstm_recurrence_bwd(*args)  # noqa: E731
            if mask == "lengths":
                o["plain_ms"], o["fwd_plain_ms"] = plain_ms, fwd_plain_ms
                o["ms"], o["ms_again"] = time_ms(new, 3), time_ms(new, 3)
                o["fwd_ms"], o["fwd_ms_again"] = time_ms(new_fwd, 3), time_ms(new_fwd, 3)
            else:
                o["holes_ms"], o["fwd_holes_ms"] = time_ms(new, 3), time_ms(new_fwd, 3)
            del xg, valid, w, dhs, hs, cs, want, got, fgot, args
        work = {k: recurrence_work(T_TRAIN, H, G, size)[k] for k in ("fwd", "bwd")}
        add_bounds(o, work, cd, {"bwd": kernel_peak(cd, sweep), "fwd": kernel_peak(cd, fwd)})
        o["fwd_library_ms"], o["library_ms"] = recurrence_library(T_TRAIN, H, dev, dtype=cd)
        out[dt] = o
    return out


def ptxas_instances(name: str, pattern: str) -> dict:
    """Registers and spill-store bytes of each template instance of
    ``csrc/<name>.cu`` from the build's ``-Xptxas -v`` report, keyed by the
    integers ``pattern`` (a regex on the mangled kernel name) captures."""
    import re

    from intrepppid_tpu_torch.ops import _build

    log = _build.build_logs.get(name, "").splitlines()
    built = {}
    for i, line in enumerate(log):
        m = re.search(pattern, line)
        if not m:
            continue
        nxt = next((j for j in range(i + 1, len(log)) if "Compiling entry" in log[j]), len(log))
        tail = " ".join(log[i + 1:nxt])
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores", tail)
        built[tuple(int(v) for v in m.groups())] = (int(regs.group(1)) if regs else None,
                                                   int(spill.group(1)) if spill else None)
    if not built:
        raise AssertionError(f"no ptxas report of {name}'s instances")
    return built


def mid_f32_instances(dev) -> dict:
    """The op's f32 sweep and forward ``lstm_recurrence_{bwd,fwd}_mid_f32.cu``
    at each width they take (96-288), D = 2, 400 rows in 5 weight groups,
    three tf32 passes a product. The sweep's dispatch held against its twin
    at T = 300 with masks from lengths; every instance of the forward
    (blocks a cluster, fragments resident or read from L2, row tile) held
    against its twin at T = 300 (masks from lengths and with holes) and at
    27 rows in 3 groups (T = 5 and 1), to 1e-4 x max(1, max|ref|), each
    computed twice (the same bits). Then at T = 1500, masks from lengths,
    each instance of either kernel timed in turns with the dispatch
    (instance, dispatch, dispatch, instance); each beside its bound (at
    495/3 TFLOP/s, or the bytes at 3.35 TB/s where larger), the plain twins'
    time there (once each) and cuDNN f32's one bidirectional
    layer at that width, TF32 off (training forward and backward for the
    input); each instance's registers and
    spill bytes (the build's ``-Xptxas -v``), shared memory and the clusters
    the card holds at once."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import recurrence_fwd, recurrence_sweep

    cd, G = torch.float32, G_TRAIN
    names = {k: f"lstm_recurrence_{k}_mid_f32" for k in ("bwd", "fwd")}
    built = {k: ptxas_instances(n, r"mid_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E")
             for k, n in names.items()}
    tables = {"bwd": ("REC_MID_F32_CLUSTER", "REC_MID_F32_FROM_L2", "REC_MID_F32_ROWS"),
              "fwd": ("REC_FWD_MID_F32_CLUSTER", "REC_FWD_MID_F32_FROM_L2",
                      "REC_FWD_MID_F32_ROWS")}

    def at(kind, cluster, resident, rows, fn):
        keep = [getattr(L, n) for n in tables[kind]]
        for n, v in zip(tables[kind], ({H: cluster for H in L.REC_MID_F32_WIDTHS},
                                       () if resident else L.REC_MID_F32_WIDTHS, (rows,))):
            setattr(L, n, v)
        try:
            return fn()
        finally:
            for n, v in zip(tables[kind], keep):
                setattr(L, n, v)

    def instances(kind, H):
        table = L.REC_MID_F32_INSTANCES if kind == "bwd" else L.REC_FWD_MID_F32_INSTANCES
        rows_of = L.REC_MID_F32_ROWS if kind == "bwd" else L.REC_FWD_MID_F32_ROWS
        out = []
        for (cluster, resident), widths in table.items():
            for rows in rows_of if H in widths else ():
                if kind == "fwd" and not L.recurrence_mid_f32_fwd_stages(
                        rows, cluster, -(-H // (8 * cluster)), resident):
                    continue
                smem = L.recurrence_mid_f32_smem(H, rows, cluster, resident, kind)
                if smem <= L.SMEM_LIMIT:
                    out.append((cluster, resident, rows, smem))
        return out

    out = {}
    for H in L.REC_MID_F32_WIDTHS:
        picked = (L.recurrence_sweep_kernel(H, cd), L.recurrence_fwd_kernel(H, cd))
        if picked != (names["bwd"], names["fwd"]):
            raise AssertionError(f"H={H} in f32 runs {picked}")
        o = {"B": B_TRAIN, "T": T_TRAIN, "D": D_REC, "G": G, "check_T": 300, "max_abs_err": {},
             "instances": {}}
        for mask, T, B, g in (("lengths", 300, B_TRAIN, G), ("holes", 300, B_TRAIN, G),
                              ("lengths", 5, 27, 3), ("holes", 1, 27, 3)):
            xg, valid, w, dhs, dhn, dcn = recurrence_inputs(T, H, g, cd, dev, mask,
                                                            SEED + 95 + H + T, B=B)
            fw = recurrence_fwd(xg, valid, w, g, cd)
            wf = L.recurrence_f32_weights(w)
            key = f"{mask}_T{T}_B{B}"
            if (mask, B) == ("lengths", B_TRAIN):
                args = (xg, valid, w, fw[0], fw[1], dhs, dhn, dcn, g, cd)
                e, ok = rel_err(L.lstm_recurrence_bwd(*args), recurrence_sweep(*args), TOL[cd])
                o["max_abs_err"][f"bwd_{key}"] = e
                if not ok:
                    emit({"phase": "recurrence_kernel", "failed": {"H": H, **o}})
                    raise AssertionError(f"{names['bwd']} at H={H} disagrees with its twin: {o}")
                del args
            for cluster, resident, rows, _ in instances("fwd", H):
                run = lambda: L.lstm_recurrence_fwd_mid_f32(xg, valid, w, g, cd, wf=wf)  # noqa
                got = at("fwd", cluster, resident, rows, run)
                again = at("fwd", cluster, resident, rows, run)
                res = {n: rel_err(a, b, TOL[cd])
                       for n, a, b in zip(("hs", "cs", "hn", "cn"), got, fw)}
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                torch.cuda.synchronize()
                inst = f"fwd_cl{cluster}_{'res' if resident else 'l2'}_r{rows}_{key}"
                o["max_abs_err"][inst] = max(e for e, _ in res.values())
                if not (all(ok for _, ok in res.values()) and same):
                    emit({"phase": "recurrence_kernel", "failed": {
                        "H": H, "instance": inst, "same_bits_twice": same,
                        "max_abs_err": {n: e for n, (e, _) in res.items()}}})
                    raise AssertionError(f"{names['fwd']} at H={H} ({inst}) disagrees with its "
                                         f"twin or across two runs")
                del got, again
            del xg, valid, w, dhs, fw, wf
        xg, valid, w, dhs, dhn, dcn = recurrence_inputs(T_TRAIN, H, G, cd, dev, "lengths",
                                                        SEED + 96 + H)
        wf = L.recurrence_f32_weights(w)
        hs, cs, _, _ = L.lstm_recurrence_fwd(xg, valid, w, G, cd, wf=wf)
        args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
        # the plain twins at the timed shape, once each
        o["fwd_plain_ms"] = timed_once(lambda: recurrence_fwd(xg, valid, w, G, cd))[1]
        o["bwd_plain_ms"] = timed_once(lambda: recurrence_sweep(*args))[1]
        calls = {"bwd": lambda: L.lstm_recurrence_bwd(*args, wf=wf),
                 "fwd": lambda: L.lstm_recurrence_fwd(xg, valid, w, G, cd, wf=wf)}
        work = recurrence_work(T_TRAIN, H, G, 4)
        for kind, name in names.items():
            count = L._max_clusters(name, cd, H, dev)
            o[f"{kind}_plan"] = dict(zip(("cluster", "resident", "rows", "tiles", "smem"),
                                         L.recurrence_mid_f32_plan(
                                             B_TRAIN, G, H, lambda c, r, R, m: count(
                                                 R, m, c, int(r)), dirs=D_REC, kind=kind)))
            o[f"{kind}_ms"] = time_ms(calls[kind], 3)
            o[f"{kind}_bound_ms"], o[f"{kind}_bound_by"] = bound(
                [(*work[kind], kernel_peak(cd, name))])
            for cluster, resident, rows, smem in instances(kind, H):
                a, b, c = in_turns(lambda: at(kind, cluster, resident, rows, calls[kind]),
                                   calls[kind], 2)
                regs, spill = built[kind].get(
                    (cluster, rows, -(-H // (8 * cluster)), int(resident)), (None, None))
                o["instances"][f"{kind}_cl{cluster}_{'res' if resident else 'l2'}_r{rows}"] = {
                    "ms": 0.5 * (a + b), "dispatch_ms": c, "smem": smem, "registers": regs,
                    "spill_store_bytes": spill, "tiles": L.mma_tiles(B_TRAIN, G, rows),
                    "max_active_clusters": count(rows, smem, cluster, int(resident))}
        del xg, valid, w, dhs, hs, cs, args, wf, calls
        o["fwd_library_ms"], o["bwd_library_ms"] = recurrence_library(T_TRAIN, H, dev, dtype=cd)
        out[f"h{H}"] = o
    return out


def mid_mma_instances(dev) -> dict:
    """The op's bf16 sweep and forward ``lstm_recurrence_{bwd,fwd}_mid_mma.cu``
    at each width they take (96-288), D = 2: every instance (blocks a
    cluster, row tile) held against its twin at T = 300, 400 rows in 5
    weight groups, with masks from lengths and with holes, and at 27 rows
    in 3 groups, T = 1 and 5 (short row tiles), to 3e-2 x max(1, max|ref|),
    each computed twice (the same bits); then at T = 1500, 400 rows, masks
    from lengths, each instance timed in turns with the dispatch (instance,
    dispatch, dispatch, instance), and the dispatch beside its bytes bound,
    the plain twins' time there (once each), cuDNN bf16's one
    bidirectional layer at that width (training forward and
    backward for the input); each instance's
    registers and spill bytes (the build's ``-Xptxas -v``), shared memory
    and the clusters the card holds at once."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import recurrence_fwd, recurrence_sweep

    cd, G = torch.bfloat16, G_TRAIN
    names = {k: f"lstm_recurrence_{k}_mid_mma" for k in ("bwd", "fwd")}
    built = {(kind, *k): v for kind, name in names.items()
             for k, v in ptxas_instances(name, r"mid_mma_kernelILi(\d+)ELi(\d+)ELi(\d+)E").items()}

    def at(cluster, rows, fn):
        keep = L.REC_MID_MMA_CLUSTER, L.REC_MID_MMA_ROWS
        L.REC_MID_MMA_CLUSTER = {k: {H: cluster for H in L.REC_MID_MMA_WIDTHS} for k in keep[0]}
        L.REC_MID_MMA_ROWS = (rows,)
        try:
            return fn()
        finally:
            L.REC_MID_MMA_CLUSTER, L.REC_MID_MMA_ROWS = keep

    def instances(kind, H):
        return [(c, r) for c, widths in L.REC_MID_MMA_INSTANCES.items() if H in widths
                for r in L.REC_MID_MMA_ROWS if L.recurrence_mid_mma_smem(kind, H, r, c)
                <= L.SMEM_LIMIT]

    out = {}
    for H in L.REC_MID_MMA_WIDTHS:
        picked = (L.recurrence_sweep_kernel(H, cd), L.recurrence_fwd_kernel(H, cd))
        if picked != (names["bwd"], names["fwd"]):
            raise AssertionError(f"H={H} in bf16 runs {picked}")
        o = {"B": B_TRAIN, "T": T_TRAIN, "D": D_REC, "G": G, "check_T": 300,
             "max_abs_err": {}, "instances": {}}
        for mask, T, B, g in (("lengths", 300, B_TRAIN, G), ("holes", 300, B_TRAIN, G),
                              ("lengths", 5, 27, 3), ("holes", 1, 27, 3)):
            xg, valid, w, dhs, dhn, dcn = recurrence_inputs(T, H, g, cd, dev, mask,
                                                            SEED + 97 + H + T, B=B)
            fw = recurrence_fwd(xg, valid, w, g, cd)
            args = (xg, valid, w, fw[0], fw[1], dhs, dhn, dcn, g, cd)
            want = recurrence_sweep(*args)
            wf = L.recurrence_mma_weights(w)
            for kind in ("bwd", "fwd"):
                for cluster, rows in instances(kind, H):
                    if kind == "bwd":
                        run = lambda: L.lstm_recurrence_bwd_mid_mma(*args, wf=wf)  # noqa: E731
                        got, again = at(cluster, rows, run), at(cluster, rows, run)
                        res = {"dxg": rel_err(got, want, TOL[cd])}
                        same = torch.equal(got, again)
                    else:
                        run = lambda: L.lstm_recurrence_fwd_mid_mma(  # noqa: E731
                            xg, valid, w, g, cd, wf=wf)
                        got, again = at(cluster, rows, run), at(cluster, rows, run)
                        res = {n: rel_err(a, b, TOL[cd])
                               for n, a, b in zip(("hs", "cs", "hn", "cn"), got, fw)}
                        same = all(torch.equal(a, b) for a, b in zip(got, again))
                    torch.cuda.synchronize()
                    key = f"{kind}_cl{cluster}_r{rows}_{mask}_T{T}_B{B}"
                    o["max_abs_err"][key] = max(e for e, _ in res.values())
                    if not (all(ok for _, ok in res.values()) and same):
                        emit({"phase": "recurrence_kernel", "failed": {
                            "H": H, "instance": key, "same_bits_twice": same,
                            "max_abs_err": {n: e for n, (e, _) in res.items()}}})
                        raise AssertionError(f"{names[kind]} at H={H} ({key}) disagrees with "
                                             f"its twin or across two runs")
                    del got, again
            del xg, valid, w, dhs, fw, args, want, wf
        xg, valid, w, dhs, dhn, dcn = recurrence_inputs(T_TRAIN, H, G, cd, dev, "lengths",
                                                        SEED + 96 + H)
        wf = L.recurrence_mma_weights(w)
        hs, cs, _, _ = L.lstm_recurrence_fwd(xg, valid, w, G, cd, wf=wf)
        args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, cd)
        # the plain twins at the timed shape, once each
        o["fwd_plain_ms"] = timed_once(lambda: recurrence_fwd(xg, valid, w, G, cd))[1]
        o["bwd_plain_ms"] = timed_once(lambda: recurrence_sweep(*args))[1]
        calls = {"bwd": lambda: L.lstm_recurrence_bwd(*args, wf=wf),
                 "fwd": lambda: L.lstm_recurrence_fwd(xg, valid, w, G, cd, wf=wf)}
        work = recurrence_work(T_TRAIN, H, G, 2)
        for kind, name in names.items():
            count = L._max_clusters(name, cd, H, dev)
            o[f"{kind}_plan"] = dict(zip(("cluster", "rows", "tiles", "smem"),
                                         L.recurrence_mid_mma_plan(
                                             kind, B_TRAIN, G, H,
                                             lambda c, R, m: count(R, m, c), dirs=D_REC)))
            o[f"{kind}_ms"] = time_ms(calls[kind], 3)
            o[f"{kind}_bound_ms"], o[f"{kind}_bound_by"] = bound(
                [(*work[kind], kernel_peak(cd, name))])
            for cluster, rows in instances(kind, H):
                a, b, c = in_turns(lambda: at(cluster, rows, calls[kind]), calls[kind], 2)
                smem = L.recurrence_mid_mma_smem(kind, H, rows, cluster)
                regs, spill = built.get((kind, cluster, rows, -(-H // (8 * cluster))),
                                        (None, None))
                o["instances"][f"{kind}_cl{cluster}_r{rows}"] = {
                    "ms": 0.5 * (a + b), "dispatch_ms": c, "smem": smem, "registers": regs,
                    "spill_store_bytes": spill, "tiles": L.mma_tiles(B_TRAIN, G, rows),
                    "max_active_clusters": count(rows, smem, cluster)}
        del xg, valid, w, dhs, hs, cs, args, wf, calls
        o["fwd_library_ms"], o["bwd_library_ms"] = recurrence_library(T_TRAIN, H, dev, dtype=cd)
        out[f"h{H}"] = o
    return out


def recurrence_past_288(dev) -> dict:
    """The recurrence op's kernels past the 256 units they once stopped at:
    H = 288 (the tensor-core kernels of 96-288 in both dtypes), 512 and 1024 (the
    tensor-core kernels ``lstm_recurrence_{fwd,bwd}_wide_mma`` in bf16 and
    ``lstm_recurrence_{fwd,bwd}_wide_f32`` in f32), D = 2, 16 rows in 2
    weight groups, T = 64, masks from lengths, f32 and bf16: the forward,
    the sweep and the weight gradient against their plain twins
    (``checks``). Then the bf16 tensor-core kernels alone at H = 320, 512
    and 1024, masks from lengths and masks with holes, against their twins
    at 2^-7 x max(1, max|ref|) (``wide_mma_checks``); the f32 tensor-core
    forward and sweep alone at the same widths and masks against their
    twins at 1e-4 x max(1, max|ref|) (``wide_f32_checks``). Then one call of
    each at H = 512, 400 rows in 5 groups, T = 300, full-length masks, timed
    beside its plain twin (timed once, in the check), its bound (the f32
    forward, sweep and wgrad at 495/3 TFLOP/s for their three tf32 passes,
    and at 67; the bf16 rate in bf16) and cuDNN's one-layer
    bidirectional LSTM at that width in the same dtype, TF32 off, the f32
    forward at each of its row tiles, and the clusters the card holds at
    once (``h512``)."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import (
        recurrence_fwd,
        recurrence_sweep,
        recurrence_wgrad,
    )

    checks, wide_mma_checks, wide_f32_checks, h512 = [], [], [], {}
    for H in (288, 512, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[dtype]
            xg, valid, w, dhs, dhn, dcn = recurrence_inputs(64, H, 2, dtype, dev, "lengths",
                                                            SEED + H, B=16)
            ref = recurrence_fwd(xg, valid, w, 2, dtype)
            res = {n: rel_err(a, b, tol) for n, a, b in zip(
                ("hs", "cs", "hn", "cn"), L.lstm_recurrence_fwd(xg, valid, w, 2, dtype), ref)}
            args = (xg, valid, w, ref[0], ref[1], dhs, dhn, dcn, 2, dtype)
            dxg = recurrence_sweep(*args)
            res["dxg"] = rel_err(L.lstm_recurrence_bwd(*args), dxg, tol)
            res["dw"] = rel_err(L.lstm_recurrence_wgrad(ref[0], dxg, 2, dtype),
                                recurrence_wgrad(ref[0], dxg, 2, dtype), tol)
            torch.cuda.synchronize()
            check = {"B": 16, "T": 64, "D": D_REC, "H": H, "G": 2, "mask": "lengths",
                     "dtype": str(dtype).replace("torch.", ""),
                     "fwd": L.recurrence_fwd_kernel(H, dtype),
                     "sweep": L.recurrence_sweep_kernel(H, dtype),
                     "wgrad": L.recurrence_wgrad_kernel(H, dtype),
                     "max_abs_err": {n: e for n, (e, _) in res.items()},
                     "tol": f"{tol} x max(1, max|ref|)"}
            checks.append(check)
            if not all(ok for _, ok in res.values()):
                emit({"phase": "recurrence_kernel", "failed": check})
                raise AssertionError(f"the recurrence op past 288 disagrees: {check}")
            del xg, valid, w, dhs, ref, args, dxg
    cd, tol = torch.bfloat16, 2.0 ** -7
    for H in (320, 512, 1024):
        for mask in ("lengths", "holes"):
            xg, valid, w, dhs, dhn, dcn = recurrence_inputs(64, H, 2, cd, dev, mask,
                                                            SEED + 7 * H, B=16)
            ref = recurrence_fwd(xg, valid, w, 2, cd)
            res = {n: rel_err(a, b, tol) for n, a, b in zip(
                ("hs", "cs", "hn", "cn"), L.lstm_recurrence_fwd_wide_mma(xg, valid, w, 2, cd),
                ref)}
            args = (xg, valid, w, ref[0], ref[1], dhs, dhn, dcn, 2, cd)
            dxg = recurrence_sweep(*args)
            res["dxg"] = rel_err(L.lstm_recurrence_bwd_wide_mma(*args), dxg, tol)
            torch.cuda.synchronize()
            check = {"B": 16, "T": 64, "D": D_REC, "H": H, "G": 2, "mask": mask, "dtype": "bfloat16",
                     "max_abs_err": {n: e for n, (e, _) in res.items()},
                     "tol": f"{tol} x max(1, max|ref|)"}
            wide_mma_checks.append(check)
            if not all(ok for _, ok in res.values()):
                emit({"phase": "recurrence_kernel", "failed": check})
                raise AssertionError(f"a bf16 recurrence kernel past 288 disagrees: {check}")
            del xg, valid, w, dhs, ref, args, dxg
    cd, tol = torch.float32, TOL[torch.float32]
    for H in (320, 512, 1024):
        for mask in ("lengths", "holes"):
            xg, valid, w, dhs, dhn, dcn = recurrence_inputs(64, H, 2, cd, dev, mask,
                                                            SEED + 11 * H, B=16)
            ref = recurrence_fwd(xg, valid, w, 2, cd)
            hs, cs = ref[:2]
            args = (xg, valid, w, hs, cs, dhs, dhn, dcn, 2, cd)
            dxg = recurrence_sweep(*args)
            res = {"dxg": rel_err(L.lstm_recurrence_bwd_wide_f32(*args), dxg, tol)}
            got = L.lstm_recurrence_fwd_wide_f32(xg, valid, w, 2, cd)
            fres = {n: rel_err(a, b, tol) for n, a, b in zip(("hs", "cs", "hn", "cn"), got, ref)}
            torch.cuda.synchronize()
            check = {"B": 16, "T": 64, "D": D_REC, "H": H, "G": 2, "mask": mask,
                     "dtype": "float32", "max_abs_err": {n: e for n, (e, _) in res.items()},
                     "scaled_err": scaled_err(L.lstm_recurrence_bwd_wide_f32(*args), dxg),
                     "fwd_max_abs_err": {n: e for n, (e, _) in fres.items()},
                     "fwd_scaled_err": max(scaled_err(a, b) for a, b in zip(got, ref)),
                     "tol": f"{tol} x max(1, max|ref|)"}
            wide_f32_checks.append(check)
            if not all(ok for _, ok in list(res.values()) + list(fres.values())):
                emit({"phase": "recurrence_kernel", "failed": check})
                raise AssertionError(f"an f32 recurrence kernel past 288 disagrees: {check}")
            del xg, valid, w, dhs, hs, cs, args, dxg, ref, got
    # the same at the main path's rows (400 in 5 groups: the row tile the
    # embedding-320 f32 model and the timed call below run), short T
    for H in (320, 512):
        xg, valid, w, dhs, dhn, dcn = recurrence_inputs(16, H, G_TRAIN, cd, dev, "holes",
                                                        SEED + 13 * H)
        ref = recurrence_fwd(xg, valid, w, G_TRAIN, cd)
        hs, cs = ref[:2]
        args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G_TRAIN, cd)
        dxg = recurrence_sweep(*args)
        got = L.lstm_recurrence_bwd_wide_f32(*args)
        e, ok = rel_err(got, dxg, tol)
        fgot = L.lstm_recurrence_fwd_wide_f32(xg, valid, w, G_TRAIN, cd)
        fres = {n: rel_err(a, b, tol) for n, a, b in zip(("hs", "cs", "hn", "cn"), fgot, ref)}
        torch.cuda.synchronize()
        check = {"B": B_TRAIN, "T": 16, "D": D_REC, "H": H, "G": G_TRAIN, "mask": "holes",
                 "dtype": "float32", "rows": L.wide_plan(
                     "rec_bwd_f32", B_TRAIN, G_TRAIN, H, L._max_clusters(
                         "lstm_recurrence_bwd_wide_f32", cd, H, dev), D_REC)[0],
                 "fwd_rows": L.wide_plan(
                     "rec_fwd_f32", B_TRAIN, G_TRAIN, H, L._max_clusters(
                         "lstm_recurrence_fwd_wide_f32", cd, H, dev), D_REC)[0],
                 "max_abs_err": {"dxg": e}, "scaled_err": scaled_err(got, dxg),
                 "fwd_max_abs_err": {n: v for n, (v, _) in fres.items()},
                 "fwd_scaled_err": max(scaled_err(a, b) for a, b in zip(fgot, ref)),
                 "tol": f"{tol} x max(1, max|ref|)"}
        wide_f32_checks.append(check)
        if not ok or not all(k for _, k in fres.values()):
            emit({"phase": "recurrence_kernel", "failed": check})
            raise AssertionError(f"an f32 recurrence kernel past 288 disagrees: {check}")
        del xg, valid, w, dhs, hs, cs, args, dxg, got, ref, fgot
    H, G, T = 512, G_TRAIN, 300
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        xg, valid, w, dhs, dhn, dcn = recurrence_inputs(T, H, G, dtype, dev, "lengths",
                                                        SEED + 95)
        valid.fill_(True)
        ref, fwd_plain_ms = timed_once(lambda: recurrence_fwd(xg, valid, w, G, dtype))
        hs, cs = ref[:2]
        args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, dtype)
        dxg, bwd_plain_ms = timed_once(lambda: recurrence_sweep(*args))
        _, wgrad_plain_ms = timed_once(lambda: recurrence_wgrad(hs, dxg, G, dtype))
        t = {"B": B_TRAIN, "T": T, "D": D_REC, "H": H, "G": G,
             "dtype": str(dtype).replace("torch.", ""),
             "fwd": L.recurrence_fwd_kernel(H, dtype), "sweep": L.recurrence_sweep_kernel(H, dtype),
             "wgrad": L.recurrence_wgrad_kernel(H, dtype),
             "tol": f"{TOL[dtype]} x max(1, max|ref|)",
             "wgrad_ms": time_ms(lambda: L.lstm_recurrence_wgrad(hs, dxg, G, dtype), 3),
             "fwd_plain_ms": fwd_plain_ms, "bwd_plain_ms": bwd_plain_ms,
             "wgrad_plain_ms": wgrad_plain_ms}
        res = {"hs": rel_err(L.lstm_recurrence_fwd(xg, valid, w, G, dtype)[0], hs, TOL[dtype]),
               "dxg": rel_err(L.lstm_recurrence_bwd(*args), dxg, TOL[dtype])}
        torch.cuda.synchronize()
        t["max_abs_err"] = {n: e for n, (e, _) in res.items()}
        if not all(ok for _, ok in res.values()):
            emit({"phase": "recurrence_kernel", "failed": t})
            raise AssertionError(f"the recurrence op at H={H}, {B_TRAIN} rows disagrees: {t}")
        fwd = lambda: L.lstm_recurrence_fwd(xg, valid, w, G, dtype)  # noqa: E731
        bwd = lambda: L.lstm_recurrence_bwd(*args)  # noqa: E731
        t["fwd_ms"], t["bwd_ms"] = time_ms(fwd, 3), time_ms(bwd, 3)
        if dtype == torch.bfloat16:
            t["plans"] = {kind: dict(zip(("rows", "tiles", "smem"), L.wide_plan(
                f"rec_{kind}_mma", B_TRAIN, G, H, L._max_clusters(
                    f"lstm_recurrence_{kind}_wide_mma", dtype, H, dev), D_REC)))
                for kind in ("fwd", "bwd")}
            t["max_active_clusters"] = {
                f"{k[0]} H={k[2]} rows={k[3]}": v for k, v in L._cluster_counts.items()
                if k[0].endswith("_wide_mma") and k[2] == H}
            add_bounds(t, recurrence_work(T, H, G, size), dtype)
        else:
            # the forward at each row tile its instance is built for
            keep = L.REC_WIDE_F32_FWD_ROWS
            try:
                for R in keep[1]:
                    L.REC_WIDE_F32_FWD_ROWS = {1: (R,), 2: keep[2]}
                    t[f"fwd_rows_{R}_ms"] = time_ms(fwd, 3)
            finally:
                L.REC_WIDE_F32_FWD_ROWS = keep
            names = {kind: f"lstm_recurrence_{kind}_wide_f32" for kind in ("fwd", "bwd")}
            t["plans"] = {kind: dict(zip(("rows", "tiles", "smem"), L.wide_plan(
                f"rec_{kind}_f32", B_TRAIN, G, H, L._max_clusters(name, dtype, H, dev), D_REC)))
                for kind, name in names.items()}
            t["max_active_clusters"] = {
                f"{k[0]} H={k[2]} rows={k[3]}": v for k, v in L._cluster_counts.items()
                if k[0] in names.values() and k[2] == H}
            work = recurrence_work(T, H, G, size)
            # the forward, the sweep and the wgrad at 495/3 TFLOP/s (three tf32
            # passes), and at 67 (the CUDA cores' rate)
            add_bounds(t, work, torch.float32, {k: kernel_peak(dtype, n) for k, n in (
                *names.items(), ("wgrad", "lstm_recurrence_wgrad_f32"))})
            for kind in (*names, "wgrad"):
                t[f"{kind}_cuda_core_bound_ms"], t[f"{kind}_cuda_core_bound_by"] = bound(
                    [(*work[kind], PEAK_F32_FLOPS)])
        del xg, valid, w, dhs, ref, hs, cs, args, dxg
        t["fwd_library_ms"], t["bwd_library_ms"] = recurrence_library(T, H, dev, dtype=dtype)
        h512[t["dtype"]] = t
    return {"checks": checks, "wide_mma_checks": wide_mma_checks,
            "wide_f32_checks": wide_f32_checks, "h512": h512}


def phase_recurrence_kernel(dev) -> dict:
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import (
        recurrence_fwd,
        recurrence_sweep,
        recurrence_wgrad,
    )

    checks, timings = [], []
    for i, (H, G, T) in enumerate(REC_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            size = torch.empty((), dtype=dtype).element_size()
            for mask in ("lengths", "holes"):
                xg, valid, w, dhs, dhn, dcn = recurrence_inputs(
                    T, H, G, dtype, dev, mask, SEED + 60 + i)
                tol = TOL[dtype]
                ref, fwd_plain_ms = timed_once(lambda: recurrence_fwd(xg, valid, w, G, dtype))
                # the forward the dispatch picks, a tensor-core one (f32 in
                # three tf32 passes)
                fwd = L.recurrence_fwd_kernel(H, dtype)
                got = L.lstm_recurrence_fwd(xg, valid, w, G, dtype)
                res = {n: rel_err(a, b, tol)
                       for n, a, b in zip(("hs", "cs", "hn", "cn"), got, ref)}
                again = L.lstm_recurrence_fwd(xg, valid, w, G, dtype)
                res["twice"] = (0.0, all(torch.equal(a, b) for a, b in zip(got, again)))
                del got, again
                hs, cs = ref[:2]
                args = (xg, valid, w, hs, cs, dhs, dhn, dcn, G, dtype)
                dxg, bwd_plain_ms = timed_once(lambda: recurrence_sweep(*args))
                # the sweep the dispatch picks, a tensor-core one (bf16, or
                # 3xTF32 in f32)
                sweep = L.recurrence_sweep_kernel(H, dtype)
                res["dxg"] = rel_err(L.lstm_recurrence_bwd(*args), dxg, tol)
                dw, wgrad_plain_ms = timed_once(lambda: recurrence_wgrad(hs, dxg, G, dtype))
                # the wgrad the dispatch picks (a tensor-core one: f32 in three
                # tf32 passes), and the CUDA-core kernel by name
                wgrad = L.recurrence_wgrad_kernel(H, dtype)
                res["dw"] = rel_err(L.lstm_recurrence_wgrad(hs, dxg, G, dtype), dw, tol)
                res["cuda_core_dw"] = rel_err(L.lstm_recurrence_wgrad(
                    hs, dxg, G, dtype, kernel="lstm_recurrence_wgrad"), dw, tol)
                torch.cuda.synchronize()
                shape = {"B": B_TRAIN, "T": T, "D": D_REC, "H": H, "G": G,
                         "dtype": str(dtype).replace("torch.", ""), "mask": mask,
                         "fwd": fwd, "sweep": sweep, "wgrad": wgrad}
                check = {**shape, "valid_share": float(valid.float().mean()),
                         "max_abs_err": {n: e for n, (e, _) in res.items()},
                         "tol": f"{tol} x max(1, max|ref|)"}
                checks.append(check)
                if not all(ok for _, ok in res.values()):
                    emit({"phase": "recurrence_kernel", "failed": check})
                    raise AssertionError(
                        f"a recurrence kernel disagrees with its plain version: {check}")
                new_fwd = lambda: L.lstm_recurrence_fwd(xg, valid, w, G, dtype)  # noqa: E731
                t = {**shape, "bwd_ms": time_ms(lambda: L.lstm_recurrence_bwd(*args), 3),
                     "fwd_plain_ms": fwd_plain_ms, "bwd_plain_ms": bwd_plain_ms,
                     "wgrad_plain_ms": wgrad_plain_ms}
                t["fwd_ms"], t["fwd_ms_again"] = time_ms(new_fwd, 3), time_ms(new_fwd, 3)
                new_wgrad = lambda: L.lstm_recurrence_wgrad(hs, dxg, G, dtype)  # noqa: E731
                # new, old, old, new: both wgrads in one run, on one card
                t["wgrad_ms"], t["wgrad_ms_again"], t["wgrad_cuda_core_ms"] = in_turns(
                    new_wgrad, lambda: L.lstm_recurrence_wgrad(
                        hs, dxg, G, dtype, kernel="lstm_recurrence_wgrad"), 3)
                t["bwd_ms_again"] = time_ms(lambda: L.lstm_recurrence_bwd(*args), 3)
                add_bounds(t, recurrence_work(T, H, G, size), dtype,
                           {"bwd": kernel_peak(dtype, sweep), "fwd": kernel_peak(dtype, fwd),
                            "wgrad": kernel_peak(dtype, wgrad)})
                library = mask == "lengths"
                if library:
                    # yardsticks the port never calls: cuDNN for the recurrence
                    # and the sweep (it also does the input projection), one
                    # batched cuBLAS product for the weight gradient, on the
                    # operands rounded to the compute dtype as the kernel reads
                    # them ("bmm alone") and, in bf16, the whole function in
                    # PyTorch from the f32 streams: round, lay out, multiply
                    Bg = B_TRAIN // G

                    def operands(cast):
                        hp = hs[:-1].to(cast).view(T - 1, D_REC, G, Bg, H).permute(
                            1, 2, 4, 0, 3).reshape(D_REC, G, H, (T - 1) * Bg)
                        dg = dxg[1:].to(cast).view(T - 1, D_REC, G, Bg, 4 * H).permute(
                            1, 2, 0, 3, 4).reshape(D_REC, G, (T - 1) * Bg, 4 * H)
                        return hp, dg

                    hp, dg = operands(dtype)
                    t["wgrad_library_ms"] = time_ms(lambda: torch.matmul(hp, dg), 3)
                    del hp, dg
                    if dtype == torch.bfloat16:
                        t["wgrad_round_bmm_ms"] = time_ms(
                            lambda: torch.matmul(*operands(dtype)), 3)
                del xg, valid, w, dhs, ref, hs, cs, dxg, dw, args
                if library:
                    t["fwd_library_ms"], t["bwd_library_ms"] = recurrence_library(
                        T, H, dev, dtype=dtype)
                timings.append(t)
    # keys (name, dtype, H, *config, R, smem, device): config is the blocks a
    # cluster and the resident flag of lstm_recurrence_bwd_mid_f32
    cluster_counts = {f"{k[0]} {str(k[1]).replace('torch.', '')} H={k[2]}"
                      f"{''.join(f' {c}' for c in k[3:-3])} R={k[-3]}": v
                      for k, v in L._cluster_counts.items() if k[0].startswith("lstm_rec")}
    ragged = ragged_recurrence_check(dev)
    out = {"phase": "recurrence_kernel", "checks": checks, "ragged_checks": ragged,
           "timings": timings, "wgrad_f32": rec_wgrad_f32_tiles(dev),
           "op_h128": op_sweep_h128(dev),
           "mid_f32": mid_f32_instances(dev), "mid_mma": mid_mma_instances(dev),
           "past_288": recurrence_past_288(dev),
           "max_active_clusters": cluster_counts,
           "library": "one bidirectional nn.LSTM layer (cuDNN, full lengths; f32, and bf16 at "
                      "H = 64 and 32), which also does the input projection; cuBLAS for wgrad "
                      "in the compute dtype"}
    emit(out)
    return out


def rec_wgrad_f32_tiles(dev, T=T_TRAIN, D=D_REC, B=B_TRAIN, G=G_TRAIN) -> dict:
    """The op's f32 tensor-core wgrad ``lstm_recurrence_wgrad_f32.cu`` at
    each of its tiles (64 x 128, one block an SM; 64 x 64, two) at H = 64,
    128 and 288, the train shape (400 rows in 5 groups, D = 2, T = 1500):
    held against its twin at T = 300 and at 27 rows in 3 groups, T = 2
    (1e-4 x max(1, max|ref|)), then each tile in turns with
    ``lstm_recurrence_wgrad.cu`` by name (new, old, old, new), beside its
    bound (hs and dxg read once, dw written once, at 3.35 TB/s; the
    products at 495/3 TFLOP/s, and at 67: the CUDA-core kernel's rate) and
    cuBLAS f32 (one batched product on the same operands, TF32 off), with
    the split, the blocks, the blocks an SM the card holds and each tile's
    registers and spill-store bytes from the build's ``-Xptxas -v``."""
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.ops.lstm_recurrence import recurrence_wgrad

    cd = torch.float32
    built = ptxas_instances("lstm_recurrence_wgrad_f32",
                            r"lstm_recurrence_wgrad_f32_kernelILi(\d+)EE")
    lib = L._kernels("lstm_recurrence_wgrad_f32")
    out = {"dispatch_tile": L.REC_WGRAD_F32_TILE_N,
           "tiles": {n: {"registers": built.get((n,), (None, None))[0],
                         "spill_store_bytes": built.get((n,), (None, None))[1],
                         "blocks_an_sm": lib.lstm_recurrence_wgrad_f32_occupancy(n),
                         "smem": L.recurrence_wgrad_f32_smem(n)}
                     for n in L.REC_WGRAD_F32_BLOCKS}}
    for H in (64, 128, 288):
        o = {"B": B, "T": T, "D": D, "G": G, "H": H, "tol": "0.0001 x max(1, max|ref|)",
             "max_abs_err": {}}
        g = torch.Generator(device=dev).manual_seed(SEED + 700 + H)
        for Tc, Bc, Gc in ((300, B, G), (2, 27, 3)):
            hs = torch.rand(Tc, D, Bc, H, generator=g, device=dev) * 2 - 1
            dxg = torch.rand(Tc, D, Bc, 4 * H, generator=g, device=dev) * 2 - 1
            ref, plain_ms = timed_once(lambda: recurrence_wgrad(hs, dxg, Gc, cd))
            if Tc == 300:
                o["plain_ms_T300"] = plain_ms
            res = {f"T{Tc}_tile{n}": rel_err(L.lstm_recurrence_wgrad_f32(
                hs, dxg, Gc, cd, tile_n=n), ref, 1e-4) for n in L.REC_WGRAD_F32_BLOCKS}
            torch.cuda.synchronize()
            o["max_abs_err"].update({k: e for k, (e, _) in res.items()})
            o.update({f"T{Tc}_tile{n}_scaled_err": scaled_err(L.lstm_recurrence_wgrad_f32(
                hs, dxg, Gc, cd, tile_n=n), ref) for n in L.REC_WGRAD_F32_BLOCKS})
            if not all(ok for _, ok in res.values()):
                emit({"phase": "recurrence_kernel", "failed": o})
                raise AssertionError(f"lstm_recurrence_wgrad_f32 at H={H} disagrees: {o}")
            del hs, dxg, ref
        hs = torch.rand(T, D, B, H, generator=g, device=dev) * 2 - 1
        dxg = torch.rand(T, D, B, 4 * H, generator=g, device=dev) * 2 - 1
        old = lambda: L.lstm_recurrence_wgrad(hs, dxg, G, cd,  # noqa: E731
                                              kernel="lstm_recurrence_wgrad")
        for n in L.REC_WGRAD_F32_BLOCKS:
            a, b, c = in_turns(lambda: L.lstm_recurrence_wgrad_f32(hs, dxg, G, cd, tile_n=n),
                               old, 3)
            m_t, n_t, splits = L.recurrence_wgrad_f32_plan(T, B, D, G, H, L._sm_count(dev), n)
            o[f"tile{n}"] = {"ms": a, "ms_again": b, "cuda_core_ms": c, "splits": splits,
                             "blocks": m_t * n_t * splits * D * G}
        o["ms"] = o[f"tile{L.REC_WGRAD_F32_TILE_N}"]["ms"]
        Bg = B // G
        hp = hs[:-1].view(T - 1, D, G, Bg, H).permute(1, 2, 4, 0, 3).reshape(
            D, G, H, (T - 1) * Bg)
        dg = dxg[1:].view(T - 1, D, G, Bg, 4 * H).permute(1, 2, 0, 3, 4).reshape(
            D, G, (T - 1) * Bg, 4 * H)
        o["library_ms"] = time_ms(lambda: torch.matmul(hp, dg), 3)
        del hp, dg
        flops = 2 * (T - 1) * B * D * H * 4 * H
        nbytes = (T * D * B * 5 * H + D * G * H * 4 * H) * 4
        o["bound_ms"], o["bound_by"] = bound([(flops, nbytes, kernel_peak(
            cd, "lstm_recurrence_wgrad_f32"))])
        o["bytes_bound_ms"] = nbytes / PEAK_BYTES * 1e3
        o["ops_bound_ms"] = flops / kernel_peak(cd, "lstm_recurrence_wgrad_f32") * 1e3
        o["bound_67_ms"] = flops / PEAK_F32_FLOPS * 1e3
        out[f"h{H}"] = o
        del hs, dxg
    return out


def pinned_step_turns(dev, batches, name, pin, groups, dtype=torch.float32, **widths) -> dict:
    """The train step in ``dtype`` (``widths`` as the factory takes them),
    profiled on the dispatch and with the dispatch function
    ``ops.lstm_cuda.<name>`` pinned (replaced by ``pin(real)``), in turns:
    dispatch, pinned, pinned, dispatch, one step each, after a warm-up step
    of each. The device time of each step (``profile_device``) and of the
    kernel ``groups`` in it."""
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.ops import lstm_cuda as L
    from intrepppid_tpu_torch.train import Trainer

    net = intrepppid_network(steps_per_epoch=100, compute_dtype=dtype,
                             optimizer_type="ranger21_xx", device=dev, seed=SEED, **widths)
    trainer = Trainer(net, seed=SEED)
    keep = getattr(L, name)

    def step(pinned):
        if pinned:
            setattr(L, name, pin(keep))
        try:
            return profile_device(lambda: trainer.train_step(batches[0])["loss"].item(),
                                  top=4, groups=groups)
        finally:
            setattr(L, name, keep)

    step(False)
    step(True)
    runs = [step(p) for p in (False, True, True, False)]
    new, old = (runs[0], runs[3]), (runs[1], runs[2])
    out = {"dtype": str(dtype).replace("torch.", ""), **widths, "pinned": name,
           "device_ms": [r["device_ms"] for r in new],
           "pinned_device_ms": [r["device_ms"] for r in old],
           "wall_ms": [r["wall_ms"] for r in new], "pinned_wall_ms": [r["wall_ms"] for r in old]}
    for k in groups:
        out[f"{k}_ms"] = [r["device_ms_by_group"][k] for r in new]
        out[f"pinned_{k}_ms"] = [r["device_ms_by_group"][k] for r in old]
    return out


def phase_recurrence_path(dev, warmup=2, steps=4) -> dict:
    from intrepppid_tpu_torch.models.factory import intrepppid_network
    from intrepppid_tpu_torch.ops import lstm
    from intrepppid_tpu_torch.train import Trainer

    # the bf16 step's kernels; everything else must stay at 0
    new = ("lstm_recurrence_fwd_mma", "lstm_recurrence_bwd_mma", "lstm_recurrence_wgrad_mma")
    lstm.DEFAULT_BACKEND = "recurrence"
    try:
        rng = np.random.default_rng(SEED)
        net = intrepppid_network(steps_per_epoch=100, compute_dtype=torch.bfloat16,
                                 optimizer_type="ranger21_xx", device=dev, seed=SEED)
        trainer = Trainer(net, seed=SEED)
        batches = [quintuplet_batch(rng, PAIRS_TRAIN, T_TRAIN) for _ in range(4)]
        counters = train_counters()
        # the main path: the train steps and the eval step below
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms = [], []
        for i in range(warmup + steps):
            t = time.perf_counter()
            aux = trainer.train_step(batches[i % len(batches)])
            losses.append(aux["loss"].item())
            if i >= warmup:
                step_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        eval_loss = trainer.eval_step(batches[0])["loss"].item()
        eval_ms = (time.perf_counter() - t) * 1e3
        launches = {name: fn.launches for name, fn in counters.items()}
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        breakdown = profile_device(
            lambda: trainer.train_step(batches[0])["loss"].item(), top=12,
            groups={"fwd_mma": "lstm_recurrence_fwd_mma_kernel",
                    "fwd": "lstm_recurrence_fwd_kernel",
                    "sweep_mma": "lstm_recurrence_bwd_mma_kernel",
                    "sweep_f32": "lstm_recurrence_bwd_f32_kernel",
                    "wgrad_mma": "lstm_recurrence_wgrad_mma_kernel",
                    "wgrad_f32": "lstm_recurrence_wgrad_f32_kernel",
                    "wgrad": "lstm_recurrence_wgrad_kernel", "gemm": ("gemm", "nvjet", "xmma")})
        if not all(np.isfinite(losses + [eval_loss])):
            raise AssertionError(
                f"non-finite loss on the recurrence backend: {losses}, eval {eval_loss}")
        missing = [n for n in new if launches[n] <= 0]
        layer = [n for n, c in launches.items() if n not in new and c != 0]
        if missing or layer:
            raise AssertionError(
                f"the recurrence-backend steps missed {missing} or ran another forward or "
                f"sweep, the CUDA-core wgrad or a layer kernel: {layer}")
        del trainer, net
        layer_kernels = tuple(n for n in train_counters() if n.startswith("bilstm_"))
        # the f32 steps at the manuscript width: the f32 tensor-core
        # forward, sweep and wgrad at 64 (three tf32 passes)
        f32 = f32_steps(dev, batches,
                        ("lstm_recurrence_fwd_f32", "lstm_recurrence_bwd_f32",
                         "lstm_recurrence_wgrad_f32"),
                        ("lstm_recurrence_fwd", "lstm_recurrence_fwd_mma", "lstm_recurrence_wgrad",
                         "lstm_recurrence_bwd_mma", "lstm_recurrence_wgrad_mma",
                         "lstm_recurrence_bwd", "lstm_recurrence_bwd_mid_f32",
                         "lstm_recurrence_fwd_mid_f32", "lstm_recurrence_fwd_mid_mma",
                         "lstm_recurrence_bwd_mid_mma") + layer_kernels)
        # past 64 units a one-layer model at embedding 128: in f32 its
        # forward and sweep are the tensor-core
        # lstm_recurrence_{fwd,bwd}_mid_f32.cu, in bf16
        # lstm_recurrence_{fwd,bwd}_mid_mma.cu
        mid = f32_steps(dev, batches,
                        ("lstm_recurrence_fwd_mid_f32", "lstm_recurrence_bwd_mid_f32",
                         "lstm_recurrence_wgrad_f32"),
                        ("lstm_recurrence_fwd", "lstm_recurrence_fwd_mma", "lstm_recurrence_wgrad",
                         "lstm_recurrence_bwd_mma", "lstm_recurrence_bwd_f32",
                         "lstm_recurrence_fwd_f32", "lstm_recurrence_wgrad_mma",
                         "lstm_recurrence_bwd", "lstm_recurrence_fwd_mid_mma",
                         "lstm_recurrence_bwd_mid_mma") + layer_kernels,
                        embedding_size=128, rnn_num_layers=1)
        mid_bf16 = f32_steps(dev, batches,
                             ("lstm_recurrence_fwd_mid_mma", "lstm_recurrence_bwd_mid_mma",
                              "lstm_recurrence_wgrad_mma"),
                             ("lstm_recurrence_fwd", "lstm_recurrence_bwd",
                              "lstm_recurrence_fwd_mma", "lstm_recurrence_bwd_mma",
                              "lstm_recurrence_bwd_f32", "lstm_recurrence_wgrad",
                              "lstm_recurrence_wgrad_f32", "lstm_recurrence_bwd_mid_f32",
                              "lstm_recurrence_fwd_f32",
                              "lstm_recurrence_fwd_mid_f32") + layer_kernels,
                             dtype=torch.bfloat16, embedding_size=128, rnn_num_layers=1)
        # the f32 steps (the manuscript's, and one layer at embedding 128)
        # in turns with the wgrad pinned to lstm_recurrence_wgrad.cu (the
        # dispatch before the f32 tensor-core wgrad)
        pin = lambda keep: lambda H, cd: (  # noqa: E731
            "lstm_recurrence_wgrad" if cd == torch.float32 else keep(H, cd))
        groups = {"wgrad": ("lstm_recurrence_wgrad_kernel", "lstm_recurrence_wgrad_f32_kernel")}
        turns = {"manuscript": pinned_step_turns(dev, batches, "recurrence_wgrad_kernel", pin,
                                                 groups),
                 "embedding_128": pinned_step_turns(dev, batches, "recurrence_wgrad_kernel", pin,
                                                    groups, embedding_size=128,
                                                    rnn_num_layers=1)}
        # the card's gradients against the CPU's, both on this backend
        grad_check = train_grad_check(dev)
        grad_check_bf16 = train_grad_check(dev, dtype=torch.bfloat16)
    finally:
        lstm.DEFAULT_BACKEND = "auto"
    # past 288 units the default backend takes the op by itself: a one-layer
    # f32 model at embedding 320 at the train shape (2 steps and an eval
    # step, timed) on the f32 tensor-core forward and sweep; its gradients
    # and those of the bf16 model against the CPU's: in f32 the forward and
    # sweep in three tf32 passes, in bf16 the tensor-core kernels past 288;
    # no layer kernel in either
    old = ("lstm_recurrence_fwd", "lstm_recurrence_bwd", "lstm_recurrence_fwd_mma",
           "lstm_recurrence_bwd_mid_f32", "lstm_recurrence_fwd_mid_mma",
           "lstm_recurrence_bwd_mid_mma", "lstm_recurrence_fwd_f32",
           "lstm_recurrence_fwd_mid_f32")
    wide = ("lstm_recurrence_fwd_wide_mma", "lstm_recurrence_bwd_wide_mma")
    wide_f32 = ("lstm_recurrence_fwd_wide_f32", "lstm_recurrence_bwd_wide_f32")
    f32_320 = f32_steps(dev, batches, wide_f32 + ("lstm_recurrence_wgrad_f32",),
                        old + wide + ("lstm_recurrence_bwd_mma", "lstm_recurrence_bwd_f32",
                                      "lstm_recurrence_wgrad_mma",
                                      "lstm_recurrence_wgrad") + layer_kernels,
                        eval_step=True, embedding_size=320, rnn_num_layers=1)
    grad_check_320 = {str(dtype).replace("torch.", ""): train_grad_check(
        dev, dtype=dtype, eval_step=True, expect=expect, never=never, embedding_size=320,
        rnn_num_layers=1)
        for dtype, expect, never in (
            (torch.float32, wide_f32 + ("lstm_recurrence_wgrad_f32",),
             wide + old + ("lstm_recurrence_wgrad",) + layer_kernels),
            (torch.bfloat16, wide + ("lstm_recurrence_wgrad_mma",),
             old + wide_f32 + ("lstm_recurrence_wgrad_f32",) + layer_kernels))}
    median = float(np.median(step_ms))
    out = {"phase": "recurrence_path", "backend": "recurrence", "pairs": PAIRS_TRAIN,
           "T": T_TRAIN, "dtype": "bfloat16", "optimizer": "ranger21_xx", "dropout": 0.3,
           "step_ms": step_ms, "median_step_ms": median,
           "pairs_per_s": PAIRS_TRAIN / median * 1e3, "losses": losses,
           "eval_loss": eval_loss, "eval_step_ms": eval_ms, "launches": launches,
           "peak_memory_gib": peak_gib, "step_profile": breakdown, "float32_steps": f32,
           "float32_steps_embedding_128": mid, "bfloat16_steps_embedding_128": mid_bf16,
           "float32_steps_embedding_320": f32_320, "wgrad_pinned_turns": turns,
           "grad_check": grad_check,
           "grad_check_bf16": grad_check_bf16, "grad_check_embedding_320": grad_check_320}
    emit(out)
    return out


# ------------------------------------------------------------------ infer
def phase_infer(dev, n_seqs=1200, n_pairs=4000, trunc_len=1500, batch=64, vocab=258) -> dict:
    """``infer from_csv`` file to file on a synthetic proteome, built as
    ``tools/bench_infer.py`` builds it."""
    from intrepppid_tpu_torch.__main__ import main as cli
    from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
    from intrepppid_tpu_torch.ops.lstm_cuda import bilstm_layer_fwd_f32, bilstm_layer_fwd_mma
    from intrepppid_tpu_torch.utils.convert import save_reference_checkpoint

    spm = ROOT / "tests" / "fixtures" / "golden_spm.model"
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fasta, pairs, head = tmp / "proteome.fasta", tmp / "pairs.csv", tmp / "head.csv"
        seqs = ["".join(rng.choice(list(AAS), int(rng.integers(200, 2 * trunc_len))))
                for _ in range(n_seqs)]
        fasta.write_text("".join(f">P{i:05d}\n{s}\n" for i, s in enumerate(seqs)))
        rows = [f"itx{i},P{rng.integers(n_seqs):05d},P{rng.integers(n_seqs):05d}"
                for i in range(n_pairs)]
        pairs.write_text("\n".join(rows) + "\n")
        head.write_text("\n".join(rows[:batch]) + "\n")
        ckpt = tmp / "model.ckpt"
        save_reference_checkpoint(random_jax_params(SEED, V=vocab), ckpt)

        def run(csv_in, out, device):
            return cli(["infer", "from_csv", "--interactions_path", str(csv_in),
                        "--sequences_path", str(fasta), "--weights_path", str(ckpt),
                        "--spm_path", str(spm), "--out_path", str(out),
                        "--trunc_len", str(trunc_len), "--batch_size", str(batch),
                        "--vocab_size", str(vocab), "--device", device])

        # the main path: the command, file to file, through the f32
        # tensor-core forward and never the bf16 one
        bilstm_layer_fwd_mma.launches = bilstm_layer_fwd_f32.launches = 0
        t = time.perf_counter()
        n = run(pairs, tmp / "scores.csv", str(dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches, bf16_launches = bilstm_layer_fwd_f32.launches, bilstm_layer_fwd_mma.launches
        got = [ln.split(",") for ln in (tmp / "scores.csv").read_text().splitlines()]
        # where the time goes: the same command under the profiler (device
        # busy time and idle share), and the sequence library's tokenising
        # on its own
        breakdown = profile_device(lambda: run(pairs, tmp / "again.csv", str(dev)))
        spp = SentencePieceTokenizer(spm)
        t = time.perf_counter()
        spp.encode_batch_padded(seqs, trunc_len, workers=8)
        tokenise_s = time.perf_counter() - t
        # the first batch on the CPU: the same command, the plain forward
        t = time.perf_counter()
        run(head, tmp / "head_scores.csv", "cpu")
        cpu_s = time.perf_counter() - t
        ref = [ln.split(",") for ln in (tmp / "head_scores.csv").read_text().splitlines()]
    ids = [r[0] for r in got]
    probs = np.array([float(r[1]) for r in got])
    if n != n_pairs or ids != [f"itx{i}" for i in range(n_pairs)]:
        raise AssertionError(f"infer wrote {len(ids)} rows (returned {n}), or out of input order")
    if not np.all(np.isfinite(probs)) or not np.all((probs > 0) & (probs < 1)):
        raise AssertionError("infer wrote probabilities that are not finite values in (0, 1)")
    if launches <= 0 or bf16_launches != 0:
        raise AssertionError(
            f"infer launched the f32 tensor-core forward {launches} times and the bf16 one "
            f"{bf16_launches} times (want > 0 and 0)")
    if [r[0] for r in ref] != ids[:batch]:
        raise AssertionError("the CPU run of the first batch wrote other ids")
    err = float(np.abs(probs[:batch] - np.array([float(r[1]) for r in ref])).max())
    if not err <= 1e-4:
        raise AssertionError(f"infer probabilities differ from the CPU forward by {err}")
    out = {"phase": "infer", "sequences": n_seqs, "pairs": n_pairs, "trunc_len": trunc_len,
           "batch_size": batch, "vocab": vocab, "file_to_file_s": seconds,
           "pairs_per_s": n_pairs / seconds, "launches": launches,
           "bf16_launches": bf16_launches, "max_abs_err_vs_cpu": err, "cpu_sample": batch,
           "cpu_reference_s": cpu_s,
           "tokenise_library_s": tokenise_s, "second_run_profile": breakdown}
    emit(out)
    return out


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import intrepppid_tpu_torch  # noqa: F401  (fails outside a checkout)

    # the plain versions and the cuDNN yardstick in true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["data_parallel_child"]:
        mode, rank, world, port, workdir = sys.argv[2:7]
        return data_parallel_child(mode, int(rank), int(world), int(port), Path(workdir))
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    seconds = {}

    def run(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t, 1)
        return out

    run(phase_build)
    kern = run(phase_kernel, dev)
    serve = run(phase_serve, dev)
    tk = run(phase_train_kernel, dev)
    train = run(phase_train, dev)
    # phase fit's best checkpoint, kept for phase export
    work = tempfile.TemporaryDirectory()
    fit = run(phase_fit, dev, train["pairs_per_s"], Path(work.name))
    tcli = run(phase_train_cli, dev, train["pairs_per_s"], fit)
    dp = run(phase_data_parallel, dev, tcli)
    var = run(phase_variational, dev, serve)
    run(phase_export, dev, Path(work.name) / "run" / "chkpt" / fit["best"])
    work.cleanup()
    run(phase_orbax, dev)
    widths = run(phase_widths, dev)
    wk = run(phase_wide_kernel, dev)
    scaled = run(phase_train_scaled, dev)
    rk = run(phase_recurrence_kernel, dev)
    rpath = run(phase_recurrence_path, dev)
    infer = run(phase_infer, dev)

    # the f32 eval forward on the tensor cores (3xTF32): the serve path
    f32 = kern["timings"]["float32"]
    h32 = kern["timings"]["h32_float32"]
    kernels = [{
        "name": "bilstm_layer_fwd_f32",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/bilstm_fwd_f32.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_packed.py:256",
        "launches": serve["launches"],
        "max_abs_err": max(max(c["max_abs_err"][n] for n in ("hs_f", "hs_b", "hn", "cn"))
                           for c in kern["checks"] if c["dtype"] == "float32"),
        "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "ms_again": f32["kernel_ms_again"],
        "h32_ms": h32["kernel_ms"], "h32_ms_again": h32["kernel_ms_again"],
        "h32_plain_ms": h32["plain_ms"], "h32_bound_ms": h32["bound_ms"],
        "h32_library_ms": h32["library_ms"],
        "infer_launches": infer["launches"],
        "work": "eval variant, both layers of one bulk serve dispatch, f32, B=800, T=1500, H=64 "
                "(16-row tiles); bound at 495/3 TFLOP/s (three tf32 passes); library: "
                "cuDNN nn.LSTM inference, TF32 off; h32_*: row 3 at H=32, 96 rows, T=300",
    }]
    # the f32 forward's 320-thread instance at E = H = 80: layer 0 of the
    # f32 two-layer model at embedding 80 (its train steps and eval step)
    e80 = tk["embedding_80"]
    e80_launches = {d: train["steps_embedding_80"][d]["launches"] for d in e80}

    def h80_fields(key, name):
        e = e80["float32"][key]
        ragged = [v for c in tk["ragged_checks"] if c["kernel"] == "bilstm_fwd_f32"
                  for n, v in c["max_abs_err"].items() if n.startswith("eval_") == (key != "fwd")]
        own = [v for n, v in e["max_abs_err"].items() if not n.endswith("_vs_train_hs")]
        fields = {f"h80_{k}": e[k] for k in ("ms", "plain_ms", "library_ms", "scaled_err")}
        fields.update({"h80_bound_ms": e[f"{key}_bound_ms"], "h80_bound_by": e[f"{key}_bound_by"],
                       "h80_launches": e80_launches["float32"][name],
                       "h80_max_abs_err": max(own + ragged)})
        if fields["h80_launches"] <= 0:
            raise AssertionError(f"the f32 model at embedding 80 never ran {name}")
        return fields

    h80_work = ("; h80_*: its 320-thread instance on layer 0 of the f32 two-layer model at "
                "embedding 80 (E=H=80, 5 groups), 400 rows, T=1500, 8-row tiles, launches in "
                "that model's steps, library: cuDNN one-layer f32 at E=H=80; max_abs_err also "
                "over 27 rows in 3 groups at T = 1 and 5")
    kernels[0].update(h80_fields("fwd_eval", "bilstm_layer_fwd_f32"))
    kernels[0]["work"] += h80_work
    t32, t16 = tk["timings"]["float32"], tk["timings"]["bfloat16"]
    sweep_errs = ("dxf0", "dxf1", "dxb0", "dxb1", "dgc", "dbias")
    train_errs = {
        "fwd": ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b"),
        "bwd": sweep_errs,
        "wgrad": ("dW_ih", "dW_hh"),
    }
    library = {"fwd": t32["cudnn_fwd_ms"], "bwd": t32["cudnn_bwd_data_ms"],
               "wgrad": t32["wgrad_library_ms"]}
    # the 3xTF32 forward and wgrad: the f32 step
    path_launches = train["float32_steps"]["launches"]
    w32 = wk["timings"]["float32"]
    for key, name, source, replaces in (
        ("fwd", "bilstm_layer_fwd_train_f32", "bilstm_fwd_f32.cu", "lstm_pallas_packed.py:256"),
        ("wgrad", "bilstm_wgrad_f32", "bilstm_wgrad_f32.cu", "lstm_pallas_packed.py:494"),
    ):
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": path_launches[name],
            "max_abs_err": max(v for c in tk["checks"] + tk["ragged_checks"]
                               if c["dtype"] == "float32"
                               for n, v in c["max_abs_err"].items() if n in train_errs[key]),
            "ms": t32[f"{key}_ms"],
            "plain_ms": t32[f"{key}_plain_ms"],
            "bound_ms": t32[f"{key}_bound_ms"],
            "bound_by": t32[f"{key}_bound_by"],
            "library_ms": library[key],
            "work": "both layers of one train step, f32, 400 rows (5 groups), T=1500, H=64",
        }
        if key == "fwd":
            entry.update({
                "ms_again": t32["fwd_ms_again"],
                "eval_ms": t32["fwd_eval_ms"], "eval_ms_again": t32["fwd_eval_ms_again"],
                "eval_bound_ms": t32["fwd_eval_bound_ms"],
                "eval_library_ms": t32["cudnn_inference_ms"],
                "scaled_err": max(c["fwd_scaled_err"] for c in tk["checks"]
                                  if c["dtype"] == "float32"),
                "tf32_one_pass_scaled_err": max(c["fwd_tf32_one_pass_scaled_err"]
                                                for c in tk["checks"] if c["dtype"] == "float32"),
            })
            entry.update(h80_fields("fwd", name))
            entry["work"] += ("; 8-row tiles; bound at 495/3 TFLOP/s (three tf32 passes); "
                              "eval_*: the eval variant on them; library: cuDNN "
                              "nn.LSTM training forward, TF32 off; tf32_one_pass_scaled_err: the "
                              "twin in one tf32 pass, against the f32 tolerance 1e-4" + h80_work)
        else:
            # the scaled widths: layer 0 and one E = 2 x 256 layer at H = 256,
            # whose f32 main path is the f32 gradient step there
            entry.update({
                "ms_again": t32["wgrad_ms_again"],
                "scaled_err": max(c["wgrad_scaled_err"] for c in tk["checks"]
                                  if c["dtype"] == "float32"),
                **{f"h256_{k}": w32[f"wgrad_{k}"]
                   for k in ("ms", "ms_again", "library_ms", "plain_ms", "bound_ms",
                             "bound_by")},
                "h256_bound_67_ms": w32["wgrad_cuda_core_bound_ms"],
                "h256_launches": scaled["grad_check"]["launches"].get(name, 0),
                "h256_max_abs_err": max(v for c in wk["checks"] + wk["ragged_checks"]
                                        if c["dtype"] == "float32" and c["H"] == E_SCALED
                                        for n, v in c["max_abs_err"].items()
                                        if n in train_errs[key]),
            })
            entry["work"] += ("; bound at 495/3 TFLOP/s (three tf32 passes; h256_bound_67_ms "
                              "at 67); library: cuBLAS f32 products, TF32 off; h256_*: layer 0 "
                              "(E=256, 5 groups) + one E=2x256 layer at H=256, T=1500, its "
                              "launches in the f32 gradient step at the scaled widths")
            # its 64-row tile: layer 0 of the f32 model at embedding 80 (E = H =
            # 80), and the other f32 layers at H % 32 == 16
            h80, nw = e80["float32"]["wgrad"], widths["narrow_wgrad"]
            entry.update({f"h80_{k}": h80[k] for k in (
                "ms", "plain_ms", "library_ms", "scaled_err", "tiles")})
            entry.update({
                "h80_bound_ms": h80["wgrad_bound_ms"], "h80_bound_by": h80["wgrad_bound_by"],
                "h80_bound_67_ms": h80["wgrad_bound_67_ms"],
                "h80_launches": e80_launches["float32"][name],
                "h80_grad_check_launches": next(
                    c for c in widths["grad_checks"] if c["backend"] == "layer"
                    and c.get("embedding_size") == 80)["launches"].get(name, 0),
                "h80_max_abs_err": max(v for n, v in h80["max_abs_err"].items()
                                       if not n.startswith("tile_")),
                "h80_tiles_max_abs_err": max(v for n, v in h80["max_abs_err"].items()
                                             if n.startswith("tile_")),
                "narrow_instances": nw["instances"],
                **{f"narrow_{k}": {s_: o[k] for s_, o in nw.items() if s_ != "instances"}
                   for k in ("ms", "ms_again", "bound_ms", "bound_67_ms",
                             "library_ms", "tile", "splits", "blocks")},
                "narrow_max_abs_err": max(v for s_, o in nw.items() if s_ != "instances"
                                          for v in o["max_abs_err"].values())})
            if min(entry["h80_launches"], entry["h80_grad_check_launches"]) <= 0:
                raise AssertionError("the f32 model at embedding 80 never ran bilstm_wgrad_f32")
            entry["work"] += ("; h80_*: its 64 x 160 tile on layer 0 of the f32 two-layer model "
                              "at embedding 80 (E=H=80, 5 groups), 400 rows, T=1500, launches "
                              "in that model's steps (both layers), h80_bound_67_ms: this work "
                              "at 67 TFLOP/s, h80_tiles: each tile pinned in turns with the "
                              "dispatch's (dispatch_ms); narrow_*: each f32 layer shape at "
                              "H % 32 == 16 at the train shape, timed twice (library: cuBLAS "
                              "f32), narrow_instances: each tile's registers, spills and blocks "
                              "an SM")
        kernels.append(entry)
    # the f32 step's sweep, 3xTF32; bilstm_bwd.cu asked for by name on the
    # same operands, in turns (new, old, old, new), is a yardstick there
    f32_sweep = [c for c in tk["checks"] + tk["ragged_checks"] if c["dtype"] == "float32"
                 and c.get("kernel") != "bilstm_bwd_f32_onestage"]
    kernels.append({
        "name": "bilstm_bwd_f32",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/bilstm_bwd_f32.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_packed.py:494",
        "launches": path_launches["bilstm_bwd_f32"],
        "max_abs_err": max(v for c in f32_sweep for n, v in c["max_abs_err"].items()
                           if n in sweep_errs),
        "ms": t32["bwd_ms"],
        "plain_ms": t32["bwd_plain_ms"],
        "bound_ms": t32["bwd_bound_ms"],
        "bound_by": t32["bwd_bound_by"],
        "library_ms": t32["cudnn_bwd_data_ms"],
        "ms_again": t32["bwd_ms_again"],
        "cuda_core_ms": t32["bwd_cuda_core_ms"],
        "scaled_err": max(c["scaled_err"] for c in tk["checks"] if c["dtype"] == "float32"),
        "tf32_one_pass_scaled_err": max(c["tf32_one_pass_scaled_err"] for c in tk["checks"]
                                        if c["dtype"] == "float32"),
        "work": "both layers of one train step, f32, 400 rows (5 groups), T=1500, H=64; bound "
                "at 495/3 TFLOP/s (three tf32 passes); cuda_core_ms: bilstm_bwd.cu by name on "
                "the same operands; tf32_one_pass_scaled_err: the twin with one tf32 pass, "
                "against the f32 tolerance 1e-4; library: cuDNN nn.LSTM backward (input) in "
                "f32, TF32 off",
    })
    # the one-stage sweep at its main path's shapes: layer 0 of the f32
    # two-layer model at embedding 80 (its train steps and an eval step)
    library = {"bwd": "cuDNN one-layer nn.LSTM backward (input)"}
    for key, name, source, dtype in (
        ("bwd", "bilstm_bwd_f32_onestage", "bilstm_bwd_f32_onestage.cu", "float32"),
    ):
        e = e80[dtype][key]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}",
            "replaces": "intrepppid_tpu/ops/lstm_pallas_layer.py:436",
            "launches": e80_launches[dtype][name],
            "max_abs_err": max(v for n, v in e["max_abs_err"].items()
                               if not n.startswith("cuda_core_")),
            "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e[f"{key}_bound_ms"],
            "bound_by": e[f"{key}_bound_by"],
            "library_ms": e["library_ms"],
            "work": f"layer 0 of the {dtype} two-layer model at embedding 80 (E=H=80, 5 groups, "
                    f"two dy streams a direction), 400 rows, T=1500; library: {library[key]} in "
                    f"{dtype}, TF32 off",
        }
        ragged = [c for c in tk["ragged_checks"] if c["kernel"] == name]
        entry.update({
            "max_abs_err": max([entry["max_abs_err"]] + [max(c["max_abs_err"].values())
                                                         for c in ragged]),
            "ms_again": e["ms_again"], "cuda_core_ms": e["cuda_core_ms"],
            "cuda_core_bound_ms": e["cuda_core_bound_ms"], "scaled_err": e["scaled_err"],
            "cuda_core_max_abs_err": max(v for n, v in e["max_abs_err"].items()
                                         if n.startswith("cuda_core_"))})
        entry["work"] += ("; bound at 495/3 TFLOP/s (three tf32 passes); cuda_core_ms: "
                          "bilstm_bwd.cu by name on the same operands (new, old, old, new), "
                          "its bound cuda_core_bound_ms at 67 TFLOP/s; max_abs_err also over "
                          "the ragged cases (27 rows, 3 groups, T = 1 and 5)")
        if entry["launches"] <= 0:
            raise AssertionError(f"the {dtype} model at embedding 80 never ran {name}")
        kernels.append(entry)
    # the tensor-core sweep at H = 16 (the bf16 model at embedding 16): its
    # <16, 32> instance on the stacked layer (K = 48 run as 64), bilstm_bwd.cu's
    # main path until it, and its <16, 16> one on layer 0; each in turns with
    # the run-time build and with bilstm_bwd.cu by name, which runs on no path
    b16, b16l0, b72 = widths["bwd_16"]["bwd"], widths["bwd_16_layer0"]["bwd"], \
        widths["bf16_72"]["bwd"]
    g16 = next(c for c in widths["grad_checks"]
               if c["backend"] == "layer" and c.get("embedding_size") == 16)
    h16_fields = {}
    for tag, o in (("h16s", b16), ("h16", b16l0)):
        h16_fields.update({f"{tag}_{k}": o[k] for k in (
            "ms", "ms_again", "generic_ms", "cuda_core_ms", "ms_in_cuda_core_turns", "plain_ms",
            "bound_ms", "bound_by", "cuda_core_bound_ms", "library_ms", "scaled_err")})
        h16_fields[f"{tag}_max_abs_err"] = max(v for n, v in o["max_abs_err"].items()
                                               if not n.startswith(("cuda_core_", "generic_")))
        h16_fields[f"{tag}_generic_max_abs_err"] = max(
            v for n, v in o["max_abs_err"].items() if n.startswith("generic_"))
        h16_fields[f"{tag}_cuda_core_max_abs_err"] = max(
            v for n, v in o["max_abs_err"].items() if n.startswith("cuda_core_"))
    h16_fields["h16_grad_check_launches"] = g16["launches"].get("bilstm_bwd_mma", 0)
    h16_fields["h16_grad_check_cuda_core_launches"] = g16["launches"].get("bilstm_bwd", 0)
    h16_fields["instances"] = widths["bwd_mma_instances"]
    if h16_fields["h16_grad_check_launches"] <= 0 \
            or h16_fields["h16_grad_check_cuda_core_launches"] != 0:
        raise AssertionError("the bf16 model at embedding 16 did not run its sweeps on "
                             "bilstm_bwd_mma alone")
    kernels.append({
        "name": "bilstm_bwd_mma",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/bilstm_bwd_mma.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_packed.py:494",
        "launches": train["launches"]["bilstm_bwd_mma"],
        "max_abs_err": max(v for c in tk["checks"] + tk["ragged_checks"]
                           if c["dtype"] == "bfloat16"
                           for n, v in c["max_abs_err"].items() if n in sweep_errs),
        "ms": t16["bwd_ms"],
        "plain_ms": t16["bwd_plain_ms"],
        "bound_ms": t16["bwd_bound_ms"],
        "bound_by": t16["bwd_bound_by"],
        "library_ms": t16["cudnn_bwd_data_ms"],
        "cuda_core_ms": t16["bwd_cuda_core_ms"],
        # its <80, 80> instance: layer 0 of the bf16 model at embedding 80
        **{f"h80_{k}": e80["bfloat16"]["bwd"][k] for k in (
            "ms", "plain_ms", "library_ms", "scaled_err")},
        "h80_bound_ms": e80["bfloat16"]["bwd"]["bwd_bound_ms"],
        "h80_bound_by": e80["bfloat16"]["bwd"]["bwd_bound_by"],
        "h80_launches": e80_launches["bfloat16"]["bilstm_bwd_mma"],
        "h80_max_abs_err": max(v for n, v in e80["bfloat16"]["bwd"]["max_abs_err"].items()
                               if not n.startswith("cuda_core_")),
        # its <72, 72> instance: layer 0 of the bf16 model at embedding 72
        **{f"h72_{k}": b72[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "scaled_err")},
        "h72_launches": widths["models"]["embedding_72_bfloat16"]["launches"]["bilstm_bwd_mma"],
        "h72_grad_check_launches": next(
            c for c in widths["grad_checks"]
            if c["backend"] == "layer" and c.get("embedding_size") == 72)["launches"].get(
                "bilstm_bwd_mma", 0),
        "h72_max_abs_err": max(v for n, v in b72["max_abs_err"].items()
                               if not n.startswith("cuda_core_")),
        **h16_fields,
        "work": "both layers of one train step, bf16, 400 rows (5 groups), T=1500, H=64; "
                "cuda_core_ms: bilstm_bwd.cu on the same operands in the same run; library: "
                "cuDNN nn.LSTM backward (input) in bf16; h80_*: its <80, 80> instance on layer "
                "0 of the bf16 two-layer model at embedding 80 (E=H=80, 5 groups, two dy "
                "streams a direction), 400 rows, T=1500, its launches in that model's steps, "
                "library: cuDNN one-layer bf16 backward (input); h72_*: its <72, 72> instance "
                "(K=144 run as 160 over zero columns) on layer 0 of the bf16 two-layer model at "
                "embedding 72 (E=H=72, 5 groups, two dy streams), 400 rows, T=1500, launches in "
                "that model's timed steps, library: cuDNN one-layer bf16 backward (input) at "
                "E=H=72; h16s_* / h16_*: its <16, 32> (K=48 run as 64) and <16, 16> instances "
                "on the stacked layer (E=16+16, one group, one dy stream) and layer 0 (E=H=16, "
                "5 groups, two dy streams) of the bf16 model at embedding 16, 400 rows, "
                "T=1500, in turns with the run-time <0, 0> build (generic_ms) and with "
                "bilstm_bwd.cu by name (cuda_core_ms; its bound cuda_core_bound_ms at 67; "
                "ms_in_cuda_core_turns: this kernel's two times in those turns), library: "
                "cuDNN one-layer bf16 backward (input) at those widths; h16_grad_check_*: "
                "that model's gradient and eval step; instances: each instance's registers "
                "and spills",
    })
    if min(kernels[-1]["h80_launches"], kernels[-1]["h72_launches"],
           kernels[-1]["h72_grad_check_launches"]) <= 0:
        raise AssertionError("the bf16 models at embedding 80 and 72 never ran the tensor-core "
                             "sweep")
    # the tensor-core forward (both variants) and wgrad: the bf16 step and its eval step
    w16 = wk["timings"]["bfloat16"]
    mma_errs = {"fwd": train_errs["fwd"], "wgrad": train_errs["wgrad"],
                "fwd_eval": tuple(f"eval_{n}" for n in train_errs["fwd"])}
    for key, name, source, replaces, library16, library32 in (
        ("fwd", "bilstm_layer_fwd_train_mma", "bilstm_fwd_mma.cu", "lstm_pallas_packed.py:256",
         "cudnn_fwd_ms", "cudnn_fwd_ms"),
        ("fwd_eval", "bilstm_layer_fwd_mma", "bilstm_fwd_mma.cu", "lstm_pallas_packed.py:256",
         "cudnn_inference_ms", "cudnn_inference_ms"),
        ("wgrad", "bilstm_wgrad_mma", "bilstm_wgrad_mma.cu", "lstm_pallas_packed.py:494",
         "wgrad_library_ms", None),
    ):
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": train["launches"][name],
            "max_abs_err": max(v for c in tk["checks"] + tk["ragged_checks"]
                               + wk["ragged_checks"] if c["dtype"] == "bfloat16"
                               for n, v in c["max_abs_err"].items() if n in mma_errs[key]),
            "ms": t16[f"{key}_ms"],
            "plain_ms": t16[f"{key}_plain_ms"],
            "bound_ms": t16[f"{key}_bound_ms"],
            "bound_by": t16[f"{key}_bound_by"],
            "library_ms": t16[library16],
            "ms_again": t16[f"{key}_ms_again"],
            "work": f"both layers of one train step, bf16, 400 rows (5 groups), T=1500, H=64; "
                    f"library: {library16} in bf16",
        }
        if library32:
            entry["library_f32_ms"] = t32[library32]
            # its <80, 80> and <72, 72> instances: layer 0 of the bf16 models
            # at embedding 80 and 72
            for tag, o, launches in (
                    ("h80", e80["bfloat16"][key], e80_launches["bfloat16"][name]),
                    ("h72", widths["bf16_72"][key],
                     widths["models"]["embedding_72_bfloat16"]["launches"][name])):
                entry.update({f"{tag}_{k}": o[k] for k in (
                    "ms", "plain_ms", "library_ms", "scaled_err")})
                entry.update({
                    f"{tag}_bound_ms": o.get(f"{key}_bound_ms", o.get("bound_ms")),
                    f"{tag}_bound_by": o.get(f"{key}_bound_by", o.get("bound_by")),
                    f"{tag}_launches": launches,
                    f"{tag}_max_abs_err": max(v for n, v in o["max_abs_err"].items()
                                              if not n.startswith("cuda_core_"))})
                if launches <= 0:
                    raise AssertionError(f"the bf16 model at embedding {tag[1:]} never ran "
                                         f"{name}")
            entry["work"] += ("; h80_* / h72_*: its <80, 80> and <72, 72> instances on layer 0 "
                              "of the bf16 two-layer models at embedding 80 and 72 (E=H, 5 "
                              "groups), 400 rows, T=1500, launches in those models' steps, "
                              "library: cuDNN one-layer bf16")
            # its <56, 56> and <56, 112> instances (the latter with a k8
            # tail): both layers of the bf16 model at embedding 56
            g56 = next(c for c in widths["grad_checks"]
                       if c["backend"] == "layer" and c.get("embedding_size") == 56)
            for tag, o in (("h56", widths["fwd_56"][key]),
                           ("h56s", widths["fwd_56_stacked"][key])):
                entry.update({f"{tag}_{k}": o[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scaled_err")})
                entry[f"{tag}_max_abs_err"] = max(o["max_abs_err"].values())
            entry["h56_launches"] = g56["launches"].get(name, 0)
            if entry["h56_launches"] <= 0:
                raise AssertionError(f"the bf16 model at embedding 56 never ran {name}")
            entry["work"] += ("; h56_* / h56s_*: its <56, 56> and <56, 112> instances on both "
                              "layers of the bf16 two-layer model at embedding 56 (E=56, 5 "
                              "groups; E=56+56, 1 group), 400 rows, T=1500, h56_launches: that "
                              "model's gradient and eval step, library: cuDNN one-layer bf16")
            if key == "fwd":
                k8 = widths["k8_fwd"]
                entry.update({f"k8_{k}": {s_: o[k] for s_, o in k8.items()} for k in (
                    "ms", "ms_again", "bound_ms", "library_ms", "registers",
                    "spill_store_bytes", "k8_tail")})
                entry["k8_max_abs_err"] = max(v for o in k8.values()
                                              for v in o["max_abs_err"].values())
                entry["work"] += ("; k8_*: each instance that took a shape from the deleted "
                                  "bilstm_fwd.cu (keys hH_eE), the train variant at 400 rows, "
                                  "T=1500, timed twice, its registers and spills, library: "
                                  "cuDNN one-layer bf16 training forward at E, H; "
                                  "k8_max_abs_err over both variants at 27 rows in 3 groups, "
                                  "T = 1 and 5")
        else:
            # the scaled step's shapes: layer 0 and one E = 2 x 256 layer at H = 256
            entry.update({f"h256_{k}": w16[f"wgrad_{k}"]
                          for k in ("ms", "ms_again", "library_ms", "plain_ms", "bound_ms",
                                    "bound_by", "turns_ms", "turns_ms_again",
                                    "library_turns_ms")})
            entry["h256_launches"] = scaled["launches"][name]
            entry["work"] += ("; h256_*: the scaled step's layers (layer 0 + one E=2x256 "
                              "layer), h256_turns_ms / h256_library_turns_ms: in turns with its "
                              "cuBLAS bf16 products on the same operands (kernel, cuBLAS, "
                              "cuBLAS, kernel)")
            # layer 0 of the bf16 model at embedding 80 (H = 80: the masked gate tile)
            h80 = e80["bfloat16"]["wgrad"]
            entry.update({f"h80_{k}": h80[k] for k in (
                "ms", "plain_ms", "library_ms", "scaled_err")})
            entry.update({"h80_bound_ms": h80["wgrad_bound_ms"],
                          "h80_bound_by": h80["wgrad_bound_by"],
                          "h80_launches": e80_launches["bfloat16"][name],
                          "h80_max_abs_err": max(h80["max_abs_err"].values())})
            entry["work"] += ("; h80_*: layer 0 of the bf16 two-layer model at embedding 80 "
                              "(E=H=80, 5 groups), its launches in that model's steps, "
                              "library: cuBLAS bf16 products")
            # the bf16 wide route's split: dW_hh alone on this kernel, dW_ih on
            # cuBLAS (bilstm_wgrad_ih, counted per layer call)
            for tag, o in wk["wgrad_split"].items():
                entry.update({f"split_{tag}_{k}": v for k, v in o.items() if k != "layers"})
            entry["split_dw_ih_launches"] = scaled["launches"]["bilstm_wgrad_ih"]
            entry["split_h160_dw_ih_launches"] = widths["models"]["embedding_160_bfloat16"][
                "launches"]["bilstm_wgrad_ih"]
            entry["work"] += ("; split_hN_*: the bf16 wide route's split on the wide layers at "
                              "H=N (256: the scaled step's two; 160 and 288: layer 0 and the "
                              "stacked layer of the bf16 models at embedding 160 and 272; 96: "
                              "the stacked layer at embedding 80), 400 rows, T=1500: ms the "
                              "split in turns with the whole kernel (whole_ms), dw_hh_ms this "
                              "kernel with no input part, dw_ih_ms the cuBLAS bf16 products with "
                              "f32 output, library_ms cuBLAS for all of it, bounds of each at "
                              "989 TFLOP/s; split_dw_ih_launches: the scaled step's dW_ih calls")
            if min(entry["split_dw_ih_launches"], entry["split_h160_dw_ih_launches"]) <= 0:
                raise AssertionError("a bf16 wide step never split its weight gradient")
        kernels.append(entry)
    wide_errs = {
        "gates": ("xg",),
        "fwd": tuple(f"train_{n}" for n in ("hs_f", "hs_b", "hn", "cn", "cs_f", "cs_b")),
        "fwd_eval": tuple(f"eval_{n}" for n in ("hs_f", "hs_b", "hn", "cn")),
        "lite": ("dgates",),
    }
    # the one-block f32 wide forward (both variants, three tf32 passes): its
    # main path is the stacked layer of the f32 two-layer model at embedding
    # 80 (run at H = 96). The CUDA-core lite sweep (bilstm_bwd_lite.cu)
    # runs on no path since the bf16 tensor-core sweep took 160-224: its
    # times by name stand in bilstm_bwd_lite_mma's entry
    f32_scaled = scaled["grad_check"]["launches"]
    lite32, wf32, l96 = widths["lite_f32"], widths["wide_f32"], widths["lite_f32_96"]
    k96, k96_f32 = widths["kernels_96"], widths["kernels_96_float32"]
    kf32, kbf16 = widths["kernels_float32_wide"], widths["kernels_bfloat16_wide"]
    g160 = {c["dtype"]: c for c in widths["grad_checks"]
            if c["backend"] == "layer" and c.get("embedding_size") == 160}
    for key, name in (("fwd", "bilstm_fwd_wide_train_f32_resident"),
                      ("fwd_eval", "bilstm_fwd_wide_f32_resident")):
        main = k96_f32[key]
        entry = {
            "name": name,
            "route": "cuda",
            "source": "intrepppid_tpu_torch/csrc/bilstm_fwd_wide_f32_resident.cu",
            "replaces": "intrepppid_tpu/ops/lstm_pallas_layer.py:285",
            "launches": e80_launches["float32"][name],
            "max_abs_err": max(list(main["max_abs_err"].values())
                               + [v for c in tk["ragged_checks"]
                                  if c["kernel"] == "bilstm_fwd_wide_f32_resident"
                                  for n, v in c["max_abs_err"].items()
                                  if n.startswith("fwd_eval_" if key == "fwd_eval" else "fwd_")]),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms",
                                    "library_ms", "scaled_err")},
            "work": "the stacked layer of the f32 two-layer model at embedding 80 (E=80+80, run "
                    "at H=96, one weight group, one dy stream), 400 rows, T=1500, its main path: "
                    "launches in that model's f32 steps; bound at 495/3 TFLOP/s or the bytes at "
                    "H=96 (true_bound_ms at 80); library: cuDNN one-layer f32 "
                    + ("training forward" if key == "fwd" else "inference") + " at E=160, "
                    "H=80, TF32 off; max_abs_err also over 5 weight groups at T=300 and 27 rows "
                    "in 3 groups at T=1 and 5",
        }
        if entry["launches"] <= 0:
            raise AssertionError(f"the f32 model at embedding 80 never ran {name}")
        kernels.append(entry)
    # the one-block bf16 wide forward (both variants): its main path is the
    # stacked layer of the bf16 models at embedding 80 and 72 (run at H = 96)
    for key, name in (("fwd", "bilstm_fwd_wide_train_mma_resident"),
                      ("fwd_eval", "bilstm_fwd_wide_mma_resident")):
        o = k96[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "intrepppid_tpu_torch/csrc/bilstm_fwd_wide_mma_resident.cu",
            "replaces": "intrepppid_tpu/ops/lstm_pallas_layer.py:285",
            "launches": e80_launches["bfloat16"][name],
            "max_abs_err": max([v for n, v in o["max_abs_err"].items()
                                if not n.startswith("cuda_core_")]
                               + [v for c in tk["ragged_checks"]
                                  if c["kernel"] == "bilstm_fwd_wide_mma_resident"
                                  for n, v in c["max_abs_err"].items()
                                  if n.startswith("fwd_eval_" if key == "fwd_eval" else "fwd_")]),
            **{k: o[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms",
                                 "library_ms", "scaled_err")},
            "h72_launches": widths["models"]["embedding_72_bfloat16"]["launches"][name],
            "work": "the stacked layer of the bf16 two-layer model at embedding 80 (E=80+80, run "
                    "at H=96, one weight group), 400 rows, T=1500; launches in that model's bf16 "
                    "steps (h72_launches: the bf16 model at embedding 72's, whose stacked layer "
                    "runs at the same shape); bound at the bf16 rate at H=96 (true_bound_ms at "
                    "80); library: cuDNN one-layer bf16 " + ("training forward" if key == "fwd" else "inference")
                    + " at E=160, H=80, TF32 off; max_abs_err also over 27 rows in 3 groups at "
                      "T = 1 and 5",
        })
        if min(kernels[-1]["launches"], kernels[-1]["h72_launches"]) <= 0:
            raise AssertionError(f"the bf16 models at embedding 80 and 72 never ran {name}")
    # the one-block bf16 lite sweep: its main path is the stacked layer of
    # the bf16 models at embedding 80 and 72 (run at H = 96)
    name, o = "bilstm_bwd_lite_mma_resident", k96["lite"]
    kernels.append({
        "name": name,
        "route": "cuda",
        "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_layer.py:436",
        "launches": e80_launches["bfloat16"][name],
        "max_abs_err": max([v for n, v in o["max_abs_err"].items()]
                           + [v for c in tk["ragged_checks"] if c["kernel"] == name
                              for v in c["max_abs_err"].values()]),
        **{k: o[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms",
                             "library_ms", "scaled_err")},
        "h72_launches": widths["models"]["embedding_72_bfloat16"]["launches"][name],
        "work": "the stacked layer of the bf16 two-layer model at embedding 80 (E=80+80, run at "
                "H=96, one weight group, one dy stream), 400 rows, T=1500; launches in that "
                "model's bf16 steps (h72_launches: the bf16 model at embedding 72's, whose "
                "stacked layer runs at the same shape); bound at the bf16 rate at H=96 "
                "(true_bound_ms at 80); library: cuDNN one-layer bf16 backward (input) at "
                "E=160, H=80, TF32 off; max_abs_err also over 27 rows in 3 groups at T = 1 and "
                "5 (bilstm_bwd_lite.cu is no longer asked for by name at 96 in bf16)",
    })
    if min(kernels[-1]["launches"], kernels[-1]["h72_launches"]) <= 0:
        raise AssertionError("the bf16 models at embedding 80 and 72 never ran the one-block "
                             "bf16 lite sweep")
    # the one-block f32 lite sweep: its main path is the stacked layer of
    # the f32 model at embedding 80 (run at H = 96)
    name = "bilstm_bwd_lite_f32_resident"
    kernels.append({
        "name": name,
        "route": "cuda",
        "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_layer.py:436",
        "launches": e80_launches["float32"][name],
        "max_abs_err": max([l96["max_abs_err"]["dgates"],
                            max(k96_f32["lite"]["max_abs_err"].values())]
                           + [v for c in tk["ragged_checks"] if c["kernel"] == name
                              for v in c["max_abs_err"].values()]),
        "scaled_err": l96["scaled_err"],
        **{k: l96[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms",
                               "library_ms")},
        "work": "the stacked layer of the f32 two-layer model at embedding 80 (E=80+80, run at "
                "H=96, one weight group, one dy stream), 400 rows, T=1500; launches in that "
                "model's f32 steps; bound at 495/3 TFLOP/s (three tf32 passes) at H=96 "
                "(true_bound_ms at 80); library: cuDNN one-layer f32 backward (input) at E=160, "
                "H=80, TF32 off; max_abs_err also over the check at T=1500 and 27 rows in 3 "
                "groups at T = 1 and 5",
    })
    if kernels[-1]["launches"] <= 0:
        raise AssertionError("the f32 model at embedding 80 never ran the one-block lite sweep")
    # the f32 tensor-core gates and wide forward (both variants): the f32
    # gradient step at the scaled widths and its eval step, and the f32
    # models at embedding 100 (H = 128) and 272 (288)
    f32_models = widths["models"]
    for key, name, source, picks in (
        ("gates", "bilstm_gates_f32", "bilstm_gates_f32", lambda n: n == "xg"),
        ("fwd", "bilstm_fwd_wide_train_f32", "bilstm_fwd_wide_f32",
         lambda n: n.startswith(("train_", "fwd_rows")) and "_vs_" not in n),
        ("fwd_eval", "bilstm_fwd_wide_f32", "bilstm_fwd_wide_f32",
         lambda n: n.startswith(("eval_", "fwd_eval_rows"))),
    ):
        picked = [v for c in wk["checks"] + wk["ragged_checks"]
                  if c["dtype"] == "float32" and source in c.get("kernels", ())
                  for n, v in c["max_abs_err"].items() if picks(n)]
        picked += [v for r in wf32.values() for n, v in r["max_abs_err"].items() if picks(n)]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}.cu",
            "replaces": "intrepppid_tpu/ops/lstm_pallas_layer.py:"
                        + ("255" if key == "gates" else "285"),
            "launches": f32_scaled.get(name, 0),
            "max_abs_err": max(picked),
            "ms": w32[f"{key}_ms"],
            "plain_ms": w32[f"{key}_plain_ms"],
            "bound_ms": w32[f"{key}_bound_ms"],
            "bound_by": w32[f"{key}_bound_by"],
            "library_ms": w32[f"{key}_library_ms"],
            "work": "layer 0 (E=256, 5 groups) + one E=2x256 layer of the scaled step, f32, 400 "
                    "rows, T=1500, H=256; launches: the f32 gradient step at the scaled widths "
                    "and the eval step after it; bound at 495/3 TFLOP/s (three tf32 passes); "
                    "library: "
                    + ("one torch.addmm in f32 (cuBLAS)" if key == "gates" else
                       "cuDNN " + ("training" if key == "fwd" else "inference")
                       + " forward of one bidirectional nn.LSTM layer in f32")
                    + ", TF32 off; hN_*: the f32 layers of phase widths' wide_f32 (layer 0 and "
                      "the stacked layer at embedding 272, run at H=288; layer 0 of the scaled "
                      "configuration; layer 0 at embedding 100, at H=128), 400 rows, T=1500, "
                      "bound at the padded widths (true_bound_ms at the true ones); "
                      "hN_launches in those models' steps",
        }
        for h, r in wf32.items():
            entry.update({f"{h}_{k}": r[f"{key}_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms", "library_ms")})
            if key == "fwd":
                entry[f"{h}_rows_ms"] = {k[4:]: v for k, v in r.items()
                                         if k.startswith("fwd_rows") and k.endswith("_ms")
                                         and not k.endswith("_dispatch_ms")}
                entry.update({f"{h}_{k}": r[k] for k in ("fwd_rows", "fwd_tiles",
                                                         "max_active_clusters", "f32_copy_ms")})
        entry["h288_launches"] = f32_models["embedding_272_float32"]["launches"][name]
        entry["h128_launches"] = f32_models["embedding_100_float32"]["launches"][name]
        if key != "gates":
            # the forward's instances for 2 / 3, 3 and 3 / 4 unit groups a
            # block: layer 0 at E = H = 160, 192, 224; launches in the f32
            # model at embedding 160's timed steps and its gradient and eval step
            for h, r in kf32.items():
                o = r[key]
                entry.update({f"{h}_{k}": o[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_fwd_again_ms",
                    "scaled_err")})
                entry[f"{h}_max_abs_err"] = max(
                    [v for n, v in o["max_abs_err"].items() if not n.startswith("cuda_core_")]
                    + [v for c in tk["ragged_checks"] if c["kernel"] == source
                       and c["H"] == int(h[1:]) for n, v in c["max_abs_err"].items()
                       if n.startswith("fwd_eval_" if key == "fwd_eval" else "fwd_")])
                if key == "fwd":
                    entry.update({f"{h}_{k}": o[k] for k in (
                        "rows", "tiles", "max_active_clusters")})
                    entry[f"{h}_rows_ms"] = {k: v for k, v in o.items()
                                             if k.startswith("rows_") and k.endswith("_ms")}
            entry["h160_launches"] = f32_models["embedding_160_float32"]["launches"][name]
            entry["h160_grad_check_launches"] = g160["float32"]["launches"].get(name, 0)
            entry["work"] += ("; h160_* / h192_* / h224_*: layer 0 at E=H=N in f32 (5 groups), "
                              "400 rows, T=1500, the row tile of the plan (h160_rows_ms: each "
                              "row tile, rows_R_dispatch_ms the dispatch in turns with it), "
                              "bound at 495/3, library: cuDNN one-layer f32 "
                              "forward there (library_fwd_again_ms read again after its "
                              "backward); max_abs_err also over 27 rows in 3 groups at T = 1 "
                              "and 5; h160_launches: the f32 model at embedding 160's timed "
                              "steps")
            if min(entry["h160_launches"], entry["h160_grad_check_launches"]) <= 0:
                raise AssertionError(f"the f32 model at embedding 160 never ran {name}")
        if min(entry["launches"], entry["h288_launches"], entry["h128_launches"]) <= 0:
            raise AssertionError(f"an f32 main path never ran {name}")
        kernels.append(entry)
    # the tensor-core gates, wide forward (both variants) and lite sweep: the
    # bf16 scaled step and its eval step; each error name the checks give
    # the kernel, ragged row tiles included
    for key, name, source, replaces, library, picks in (
        ("gates", "bilstm_gates_mma", "bilstm_gates_mma", "lstm_pallas_layer.py:255",
         "one torch.addmm on the bf16 operands with out_dtype=float32 (cuBLAS); "
         "library_bf16_out_ms: bf16 addmm then .float()", lambda n: n == "xg"),
        ("fwd", "bilstm_fwd_wide_train_mma", "bilstm_fwd_wide_mma", "lstm_pallas_layer.py:285",
         "cuDNN training forward of one bidirectional nn.LSTM layer in bf16; library_f32_ms: "
         "the same in f32, TF32 off",
         lambda n: n.startswith("train_") or (n.startswith("fwd_rows") and "_vs_" not in n)),
        ("fwd_eval", "bilstm_fwd_wide_mma", "bilstm_fwd_wide_mma", "lstm_pallas_layer.py:285",
         "cuDNN inference forward of one bidirectional nn.LSTM layer in bf16; library_f32_ms: "
         "the same in f32, TF32 off",
         lambda n: n.startswith("eval_") or n.startswith("fwd_eval_rows")),
        ("lite", "bilstm_bwd_lite_mma", "bilstm_bwd_lite_mma", "lstm_pallas_layer.py:436",
         "cuDNN backward (input) of one bidirectional nn.LSTM layer in bf16; library_f32_ms: "
         "the same in f32, TF32 off", lambda n: n.startswith("dgates")),
    ):
        picked = [v for c in wk["checks"] + wk["ragged_checks"]
                  if c["dtype"] == "bfloat16" and source in c.get("kernels", ())
                  for n, v in c["max_abs_err"].items() if picks(n)]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{source}.cu",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": scaled["launches"][name],
            "max_abs_err": max(picked),
            "ms": w16[f"{key}_ms"],
            "plain_ms": w16[f"{key}_plain_ms"],
            "bound_ms": w16[f"{key}_bound_ms"],
            "bound_by": w16[f"{key}_bound_by"],
            "library_ms": w16[f"{key}_library_ms"],
            "library_f32_ms": w32[f"{key}_library_ms"],
            "work": "layer 0 (E=256, 5 groups) + one E=2x256 layer of the scaled step, bf16, "
                    f"400 rows, T=1500, H=256; library: {library}",
        }
        if key == "gates":
            entry["library_bf16_out_ms"] = w16["gates_library_bf16_out_ms"]
        elif key != "lite":
            entry["rows_ms"] = {k: v for k, v in w16.items() if k.startswith(f"{key}_rows")}
        else:
            entry["rows_ms"] = {k: v for k, v in w16.items() if k.startswith("lite_rows")}
        if key in ("fwd", "fwd_eval"):
            # its instance for uneven unit groups: layer 0 of the bf16 model at embedding 272
            k288 = widths["kernels_288"][f"{key}_mma"]
            entry.update({f"h288_{k}": k288[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms", "library_ms")})
            entry.update({f"h288_{k}": widths["kernels_288"]["fwd_mma"][k] for k in (
                "rows", "tiles", "max_active_clusters")})
            entry["h288_max_abs_err"] = max(k288["max_abs_err"].values())
            entry["h288_launches"] = widths["models"]["embedding_272_bfloat16"]["launches"][name]
            if entry["h288_launches"] <= 0:
                raise AssertionError("the bf16 model at embedding 272 never ran its forward")
            entry["work"] += ("; h288_*: its instance for 4 or 5 unit groups a block on layer 0 "
                              "of the bf16 two-layer model at embedding 272 (E=272, run at "
                              "H=288, 5 groups), 400 rows, T=1500, bound at H=288 "
                              "(true_bound_ms at 272), launches in that model's steps, "
                              "library: cuDNN one-layer bf16 at E=H=272")
            # its instances for 2 / 3, 3 and 3 / 4 unit groups a block: layer 0
            # at E = H = 160, 192, 224 in bf16; launches in the bf16 model at
            # embedding 160's timed steps and its gradient and eval step
            for h, r in kbf16.items():
                o = r[f"{key}_mma"]
                entry.update({f"{h}_{k}": o[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scaled_err")})
                entry.update({f"{h}_{k}": r["fwd_mma"][k] for k in (
                    "rows", "tiles", "max_active_clusters")})
                if key == "fwd":
                    entry[f"{h}_rows_ms"] = {k: v for k, v in o.items()
                                             if k.startswith("rows_") and k.endswith("_ms")}
                entry[f"{h}_max_abs_err"] = max(
                    [v for n, v in o["max_abs_err"].items() if not n.startswith("cuda_core_")]
                    + [v for c in tk["ragged_checks"] if c["kernel"] == "bilstm_fwd_wide_mma"
                       and c["H"] == int(h[1:]) for n, v in c["max_abs_err"].items()
                       if n.startswith("fwd_eval_" if key == "fwd_eval" else "fwd_")])
            entry["h160_launches"] = widths["models"]["embedding_160_bfloat16"]["launches"][name]
            entry["h160_grad_check_launches"] = g160["bfloat16"]["launches"].get(name, 0)
            entry["work"] += ("; h160_* / h192_* / h224_*: its kernel for uneven unit groups on "
                              "layer 0 at E=H=N in bf16 (5 groups), 400 rows, T=1500, the row "
                              "tile of the plan (h160_rows_ms: each row tile), "
                              "library: cuDNN one-layer bf16 there; max_abs_err also over 27 "
                              "rows in 3 groups at T = 1 and 5; h160_launches: the bf16 model "
                              "at embedding 160's timed steps")
            if min(entry["h160_launches"], entry["h160_grad_check_launches"]) <= 0:
                raise AssertionError(f"the bf16 model at embedding 160 never ran {name}")
        if key == "lite":
            # its instance for uneven unit groups: layer 0 of the bf16 model at embedding 272
            k288 = widths["kernels_288"]["lite_mma"]
            entry.update({f"h288_{k}": k288[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms", "library_ms", "rows",
                "tiles", "max_active_clusters")})
            entry["h288_max_abs_err"] = max(k288["max_abs_err"].values())
            entry["h288_launches"] = widths["models"]["embedding_272_bfloat16"]["launches"][name]
            if entry["h288_launches"] <= 0:
                raise AssertionError("the bf16 model at embedding 272 never ran its lite sweep")
            entry.update({f"uneven_h256_{k}": w16[f"lite_{v}"] for k, v in (
                ("ms", "uneven_ms"), ("ms_again", "uneven_ms_again"), ("even_ms", "even_ms"),
                ("max_abs_err", "uneven_max_abs_err"), ("rows", "uneven_rows"))})
            entry["work"] += ("; uneven_h256_*: its instance for uneven groups (H=288's, its "
                              "items dealt over 8 warps) by name on this row's operands, held "
                              "against the twin, in turns with the H=256 kernel (uneven, even, "
                              "even, uneven)")
            # its instances for 2 / 3, 3 and 3 / 4 unit groups a block: layer 0
            # at E = H = 160, 192, 224 in bf16; launches in the bf16 model at
            # embedding 160's timed steps and its gradient and eval step
            for h, r in kbf16.items():
                o = r["lite_mma"]
                entry.update({f"{h}_{k}": o[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scaled_err", "rows",
                    "tiles", "max_active_clusters")})
                entry[f"{h}_max_abs_err"] = max(
                    list(o["max_abs_err"].values())
                    + [v for c in tk["ragged_checks"] if c["kernel"] == name
                       and c["H"] == int(h[1:]) for v in c["max_abs_err"].values()])
            entry["h160_launches"] = widths["models"]["embedding_160_bfloat16"]["launches"][name]
            entry["h160_grad_check_launches"] = g160["bfloat16"]["launches"].get(name, 0)
            entry["work"] += ("; h160_* / h192_* / h224_*: layer 0 at E=H=N in bf16 (5 groups, "
                              "two dy streams), 400 rows, T=1500, the row tile of the plan, "
                              "library: cuDNN one-layer bf16 backward (input) there; max_abs_err "
                              "also over 27 rows in 3 groups at T = 1 and 5; h160_launches: the "
                              "bf16 model at embedding 160's timed steps")
            if min(entry["h160_launches"], entry["h160_grad_check_launches"]) <= 0:
                raise AssertionError("the bf16 model at embedding 160 never ran its lite sweep")
            entry["work"] += ("; h288_*: its instance for 4 or 5 unit groups a block on layer 0 "
                              "of the bf16 two-layer model at embedding 272 (E=272, run at "
                              "H=288, 5 groups, two dy streams), 400 rows, T=1500, bound at "
                              "H=288 (true_bound_ms at 272), launches in that model's steps, "
                              "library: cuDNN one-layer bf16 at E=H=272")
        kernels.append(entry)
    # the f32 tensor-core lite sweep: its main path is the f32 gradient step at
    # the scaled widths (H = 256) and the f32 steps at embedding 100 (128)
    # and 272 (288)
    name = "bilstm_bwd_lite_f32"
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas_layer.py:436",
        "launches": f32_scaled.get(name, 0),
        "max_abs_err": max([r["max_abs_err"]["dgates"] for r in lite32.values()]
                           + [v for c in wk["checks"] if c["dtype"] == "float32"
                              and c["route"] == "wide"
                              for n, v in c["max_abs_err"].items() if n == "dgates"]),
        "scaled_err": max(r["scaled_err"] for r in lite32.values()),
        "ms": w32["lite_ms"],
        "plain_ms": w32["lite_plain_ms"],
        "bound_ms": w32["lite_bound_ms"],
        "bound_by": w32["lite_bound_by"],
        "library_ms": w32["lite_library_ms"],
        "cuda_core_bound_ms": w32["lite_cuda_core_bound_ms"],
        "work": "layer 0 (E=256, 5 groups) + one E=2x256 layer of the scaled step, f32, 400 "
                "rows, T=1500, H=256; launches: the f32 gradient step at the scaled widths and "
                "the eval step after it; bound at 495/3 TFLOP/s (three tf32 passes; "
                "cuda_core_bound_ms at 67); library: cuDNN backward (input) of one "
                "bidirectional nn.LSTM layer in f32, TF32 off; hN_*: layer 0 of the f32 "
                "two-layer models at embedding 272 (run at H=288) and 100 (at H=128, parts of "
                "112) and of the scaled configuration (256), 400 rows in 5 groups, two dy "
                "streams, bound at the padded H "
                "(true_bound_ms at the true H), rows_R_ms at each row tile, library: cuDNN "
                "one-layer f32 at the true widths; hN_launches in those models' steps",
    }
    models = widths["models"]
    for key, r in lite32.items():
        entry.update({f"{key}_{k}": r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "true_bound_ms",
            "cuda_core_bound_ms", "library_ms", "rows", "tiles", "max_active_clusters",
            "scaled_err")})
        entry[f"{key}_rows_ms"] = {k: v for k, v in r.items() if k.startswith("rows_")}
        entry[f"{key}_max_abs_err"] = r["max_abs_err"]["dgates"]
    entry["h288_launches"] = models["embedding_272_float32"]["launches"][name]
    entry["h128_launches"] = models["embedding_100_float32"]["launches"][name]
    # its instances for 2 / 3, 3 and 3 / 4 unit groups a block: layer 0 at
    # E = H = 160, 192, 224 in f32; launches in the f32 model at embedding
    # 160's timed steps and its gradient and eval step
    for h, r in kf32.items():
        o = r["lite"]
        entry.update({f"{h}_{k}": o[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scaled_err")})
        entry[f"{h}_max_abs_err"] = max(
            [v for n, v in o["max_abs_err"].items() if not n.startswith("cuda_core_")]
            + [v for c in tk["ragged_checks"] if c["kernel"] == name and c["H"] == int(h[1:])
               for v in c["max_abs_err"].values()])
    entry["h160_launches"] = models["embedding_160_float32"]["launches"][name]
    entry["h160_grad_check_launches"] = g160["float32"]["launches"].get(name, 0)
    entry["work"] += ("; h160_* / h192_* / h224_*: layer 0 at E=H=N in f32 (5 groups, two dy "
                      "streams), 400 rows, T=1500, the row tile of the plan, library: cuDNN "
                      "one-layer f32 backward (input) there; max_abs_err also over 27 rows in 3 "
                      "groups at T = 1 and 5; h160_launches: the f32 model at embedding 160's "
                      "timed steps")
    if min(entry["launches"], entry["h288_launches"], entry["h128_launches"],
           entry["h160_launches"], entry["h160_grad_check_launches"]) <= 0:
        raise AssertionError("an f32 main path never ran the tensor-core lite sweep")
    kernels.append(entry)
    # the recurrence op: both layers of one recurrence-backend step (layer 0
    # with 5 weight groups, layer 1 with shared weights), f32, masks from lengths
    step = [t for t in rk["timings"] if t["dtype"] == "float32" and t["mask"] == "lengths"
            and t["H"] == H_SERVE and t["T"] == T_TRAIN]
    h32f = [t for t in rk["timings"] if t["dtype"] == "float32" and t["mask"] == "lengths"
            and t["H"] == 32][0]
    rec_errs = {"fwd": ("hs", "cs", "hn", "cn"), "bwd": ("dxg",), "wgrad": ("dw",)}
    # the f32 forward's, the f32 sweep's and the f32 tensor-core wgrad's
    # main path is the f32 step
    rec_launches = {n: rpath["float32_steps"]["launches"][n]
                    for n in ("lstm_recurrence_fwd_f32", "lstm_recurrence_bwd_f32",
                              "lstm_recurrence_wgrad_f32")}
    f32_step = rpath["float32_steps"]["step_profile"]
    for key, name, replaces in (("fwd", "lstm_recurrence_fwd_f32", "lstm_pallas.py:116"),
                                ("bwd", "lstm_recurrence_bwd_f32", "lstm_pallas.py:185"),
                                ("wgrad", "lstm_recurrence_wgrad_f32", "lstm_pallas.py:185")):
        ms_bound, bound_by = bound([(sum(t[f"{key}_flops"] for t in step),
                                     sum(t[f"{key}_bytes"] for t in step),
                                     kernel_peak(torch.float32, name))])
        picked = {"fwd": "fwd", "bwd": "sweep", "wgrad": "wgrad"}[key]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": rec_launches[name],
            "max_abs_err": max(v for c in rk["checks"] + rk["ragged_checks"]
                               if c["dtype"] == "float32" and name in (
                                   c.get(picked), c.get("kernel"))
                               for n, v in c["max_abs_err"].items() if n in rec_errs[key]),
            "ms": sum(t[f"{key}_ms"] for t in step),
            "plain_ms": sum(t[f"{key}_plain_ms"] for t in step),
            "bound_ms": ms_bound,
            "bound_by": bound_by,
            "library_ms": sum(t[f"{key}_library_ms"] for t in step),
            "work": "both layers of one recurrence-backend step (5 weight groups + 1), f32, "
                    "D=2, 400 rows, T=1500, H=64; library: cuDNN nn.LSTM layers, which also "
                    "do the input projection (cuBLAS for wgrad)",
        }
        past = rk["past_288"]
        if key == "wgrad":
            # past 288: one call at H = 512, f32
            h512 = past["h512"]["float32"]
            entry.update({f"h512_{k}": h512[f"{key}_{k}"]
                          for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
            entry["h512_library_ms"] = h512.get(f"{key}_library_ms")
            entry["h512_bound_67_ms"] = h512["wgrad_cuda_core_bound_ms"]
            entry["h512_max_abs_err"] = max(
                v for c in past["checks"] if c["dtype"] == "float32"
                for n, v in c["max_abs_err"].items() if n in rec_errs[key])
            entry["work"] += ("; h512_*: one call at H=512 (400 rows, 5 groups, T=300), f32, "
                              "bound at 495/3 (h512_bound_67_ms at 67); "
                              "h512_max_abs_err over H=288, 512 and 1024")
            # lstm_recurrence_wgrad.cu (CUDA cores), on no path since, by
            # name in turns; each tile at H = 64, 128, 288; the f32 steps in
            # turns with the wgrad pinned to it; every path's launches
            wf = rk["wgrad_f32"]
            flops = sum(t["wgrad_flops"] for t in step)
            entry.update({
                "ms_again": sum(t["wgrad_ms_again"] for t in step),
                "cuda_core_ms": sum(t["wgrad_cuda_core_ms"] for t in step),
                "bound_67_ms": flops / PEAK_F32_FLOPS * 1e3,
                "bytes_bound_ms": sum(t["wgrad_bytes"] for t in step) / PEAK_BYTES * 1e3,
                "tiles": wf["tiles"], "dispatch_tile": wf["dispatch_tile"],
                **{f"{h}_{k}": wf[h][k] for h in ("h64", "h128", "h288") for k in (
                    "ms", "tile64", "tile128", "bound_ms", "bound_by", "bytes_bound_ms",
                    "ops_bound_ms", "bound_67_ms", "library_ms", "plain_ms_T300")},
                "tiles_max_abs_err": max(v for h in ("h64", "h128", "h288")
                                         for v in wf[h]["max_abs_err"].values()),
                "step_turns": rpath["wgrad_pinned_turns"],
                "h128_launches": rpath["float32_steps_embedding_128"]["launches"][name],
                "h320_launches": rpath["float32_steps_embedding_320"]["launches"][name],
                "h80_grad_check_launches": next(
                    c for c in widths["grad_checks"] if c["backend"] == "recurrence"
                    and c["dtype"] == "float32")["launches"].get(name, 0)})
            entry["work"] += ("; bound at 495/3 TFLOP/s or the bytes (three tf32 passes; "
                              "bound_67_ms at 67, the CUDA cores' rate); cuda_core_ms: "
                              "lstm_recurrence_wgrad.cu by name on the same operands (new, old, "
                              "old, new); hN_*: one layer, 400 rows in 5 groups, D=2, T=1500, "
                              "at H=N, the dispatch's tile (dispatch_tile) and each tile "
                              "(tileN: ms, ms_again, cuda_core_ms in turns, splits, blocks), "
                              "library: one cuBLAS f32 batched product; tiles: registers, "
                              "spills, blocks an SM, shared memory; step_turns: the f32 "
                              "recurrence-backend steps (manuscript; one layer at embedding "
                              "128) profiled on the dispatch and with the wgrad pinned to "
                              "lstm_recurrence_wgrad.cu (dispatch, pinned, pinned, dispatch); "
                              "h128_ / h320_launches: the one-layer f32 models at embedding 128 "
                              "(recurrence backend) and 320 (default backend)")
            if min(entry["h128_launches"], entry["h320_launches"],
                   entry["h80_grad_check_launches"]) <= 0:
                raise AssertionError(f"an f32 path on the recurrence op never ran {name}")
        if key == "bwd":
            entry.update({"ms_again": sum(t["bwd_ms_again"] for t in step),
                          "g5_ms": step[0]["bwd_ms"],
                          "g5_library_ms": step[0]["bwd_library_ms"]})
            entry["work"] += ("; bound at 495/3 TFLOP/s (three tf32 passes); g5_*: layer 0 "
                              "(5 groups) alone")
        if key == "fwd":
            entry.update({
                "ms_again": sum(t["fwd_ms_again"] for t in step),
                "g5_ms": step[0]["fwd_ms"],
                "g5_bound_ms": step[0]["fwd_bound_ms"],
                "g5_library_ms": step[0]["fwd_library_ms"],
                **{f"h32_{k}": h32f[f"fwd_{k}"] for k in (
                    "ms", "ms_again", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "step_device_ms": f32_step["device_ms"],
                "step_kernel_ms": f32_step["device_ms_by_group"]["fwd"]})
            entry["work"] += ("; bound at 495/3 TFLOP/s or the bytes (three tf32 passes); g5_*: "
                              "layer 0 (5 groups) alone; h32_*: H=32, 5 groups, T=300; step_*: "
                              "the f32 step profiled; max_abs_err also over 27 rows in 3 "
                              "groups, T = 1 and 5, D = 1-3")
        kernels.append(entry)
    # the op's f32 sweep and forward at 96-288 units, the tensor-core
    # lstm_recurrence_{bwd,fwd}_mid_f32.cu, at their main path's shapes, the
    # recurrence-backend steps of a one-layer model at embedding 128 (h256_*:
    # H = 256, the same rows; widths_*: each width 96-288)
    o128, mid = rk["op_h128"], rk["mid_f32"]
    h512f = rk["past_288"]["h512"]["float32"]
    h256 = {t["dtype"]: t for t in rk["timings"]
            if t["H"] == E_SCALED and t["mask"] == "lengths"}
    mid_step = rpath["float32_steps_embedding_128"]["step_profile"]
    for key, name, replaces, errs in (
            ("bwd", "lstm_recurrence_bwd_mid_f32", "lstm_pallas.py:185", ("dxg",)),
            ("fwd", "lstm_recurrence_fwd_mid_f32", "lstm_pallas.py:116",
             ("hs", "cs", "hn", "cn"))):
        p = "" if key == "bwd" else "fwd_"
        o, h = o128["float32"], h256["float32"]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": rpath["float32_steps_embedding_128"]["launches"][name],
            "max_abs_err": max(
                [v for n, v in o["max_abs_err"].items()
                 if n.rsplit("_", 1)[-1] in errs and (key == "fwd") == n.startswith("fwd_")]
                + [v for m in mid.values() for n, v in m["max_abs_err"].items()
                   if n.startswith(key)]
                + [v for c in rk["checks"] + rk["past_288"]["checks"]
                   if c.get("fwd" if key == "fwd" else "sweep") == name
                   for n, v in c["max_abs_err"].items() if n in errs]),
            "ms": o[f"{p}ms"], "ms_again": o[f"{p}ms_again"], "holes_ms": o[f"{p}holes_ms"],
            "plain_ms": o[f"{p}plain_ms"],
            "bound_ms": o[f"{key}_bound_ms"],
            "bound_by": o[f"{key}_bound_by"],
            "library_ms": o[f"{p}library_ms"],
            "grad_check_launches": sum(c["launches"].get(name, 0)
                                       for c in widths["grad_checks"]),
            "h256_ms": h[f"{key}_ms"], "h256_ms_again": h[f"{key}_ms_again"],
            "h256_plain_ms": h[f"{key}_plain_ms"],
            "h256_bound_ms": h[f"{key}_bound_ms"],
            "h256_library_ms": h[f"{key}_library_ms"],
            "widths_ms": {k: m[f"{key}_ms"] for k, m in mid.items()},
            "widths_bound_ms": {k: m[f"{key}_bound_ms"] for k, m in mid.items()},
            "widths_plain_ms": {k: m[f"{key}_plain_ms"] for k, m in mid.items()},
            "widths_library_ms": {k: m[f"{key}_library_ms"] for k, m in mid.items()},
            "widths_plan": {k: m[f"{key}_plan"] for k, m in mid.items()},
            "step_device_ms": mid_step["device_ms"],
            "step_kernel_ms": mid_step["device_ms_by_group"]["sweep" if key == "bwd" else "fwd"],
            "work": "the layer of the f32 recurrence-backend model at embedding 128 (5 weight "
                    "groups), D=2, 400 rows, T=1500, H=128, masks from lengths (holes_ms: with "
                    "holes); bound at 495/3 TFLOP/s or the bytes at 3.35 TB/s; library: cuDNN "
                    "f32 one-layer nn.LSTM " + ("backward (input), with the projection's dx"
                                                if key == "bwd" else "training forward")
                    + ", TF32 off; grad_check_launches: the recurrence backend's gradient and "
                    "eval steps at embedding 80 (run at 96); h256_*: H=256, the same rows; "
                    "widths_*: each width 96-288 at the same rows on the dispatch's plan; "
                    "step_*: that model's train step profiled on the dispatch; max_abs_err "
                    "over both masks at 128, 96-288 at T=300 (the forward: every instance, "
                    "and 27 rows at T=1 and 5), 256 and 288",
        }
        kernels.append(entry)
    # the op's bf16 sweep and forward at 96-288: the tensor-core
    # lstm_recurrence_{bwd,fwd}_mid_mma.cu
    o, mm = o128["bfloat16"], rk["mid_mma"]
    turns = rpath["bfloat16_steps_embedding_128"]["step_profile"]
    for key, name, replaces, errs in (
            ("bwd", "lstm_recurrence_bwd_mid_mma", "lstm_pallas.py:185", ("dxg",)),
            ("fwd", "lstm_recurrence_fwd_mid_mma", "lstm_pallas.py:116",
             ("hs", "cs", "hn", "cn"))):
        p = "" if key == "bwd" else "fwd_"
        h = h256["bfloat16"]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": rpath["bfloat16_steps_embedding_128"]["launches"][name],
            "max_abs_err": max(
                [v for n, v in o["max_abs_err"].items()
                 if n.rsplit("_", 1)[-1] in errs and (key == "fwd") == n.startswith("fwd_")]
                + [v for m in mm.values() for n, v in m["max_abs_err"].items()
                   if n.startswith(key)]
                + [v for c in rk["checks"] if c.get(key if key == "fwd" else "sweep") == name
                   for n, v in c["max_abs_err"].items() if n in errs]),
            "ms": o[f"{p}ms"], "ms_again": o[f"{p}ms_again"], "holes_ms": o[f"{p}holes_ms"],
            "plain_ms": o[f"{p}plain_ms"],
            "bound_ms": o[f"{key}_bound_ms"],
            "bound_by": o[f"{key}_bound_by"],
            "library_ms": o[f"{p}library_ms"],
            "grad_check_launches": sum(c["launches"].get(name, 0)
                                       for c in widths["grad_checks"]),
            "h256_ms": h[f"{key}_ms"], "h256_ms_again": h[f"{key}_ms_again"],
            "h256_plain_ms": h[f"{key}_plain_ms"],
            "h256_bound_ms": h[f"{key}_bound_ms"],
            "h256_library_ms": h[f"{key}_library_ms"],
            "widths_ms": {k: m[f"{key}_ms"] for k, m in mm.items()},
            "widths_bound_ms": {k: m[f"{key}_bound_ms"] for k, m in mm.items()},
            "widths_plain_ms": {k: m[f"{key}_plain_ms"] for k, m in mm.items()},
            "widths_library_ms": {k: m[f"{key}_library_ms"] for k, m in mm.items()},
            "step_device_ms": turns["device_ms"],
            "step_kernel_ms": turns["device_ms_by_group"]["sweep" if key == "bwd" else "fwd"],
            "work": "the layer of the bf16 recurrence-backend model at embedding 128 (5 weight "
                    "groups), D=2, 400 rows, T=1500, H=128, masks from lengths (holes_ms: with "
                    "holes); bound: bytes at 3.35 TB/s; library: cuDNN bf16 one-layer nn.LSTM "
                    + ("backward (input), with the projection's dx" if key == "bwd"
                       else "training forward")
                    + "; grad_check_launches: the recurrence backend's bf16 gradient and eval "
                    "steps at embedding 80 (run at 96); h256_*: H=256, the same rows; "
                    "widths_*: each width 96-288 at the same rows on the dispatch's plan; "
                    "step_*: that model's train step profiled on the dispatch; max_abs_err over "
                    "both masks at 128 and 256, every instance at 96-288 (T=300 and 27 rows at "
                    "T=1 and 5)",
        }
        kernels.append(entry)
    step16 = [t for t in rk["timings"] if t["dtype"] == "bfloat16" and t["mask"] == "lengths"
              and t["H"] == H_SERVE and t["T"] == T_TRAIN]
    # the tensor-core forward: the bf16 recurrence-backend step's
    holes16 = [t for t in rk["timings"] if t["dtype"] == "bfloat16" and t["mask"] == "holes"
               and t["H"] == H_SERVE and t["T"] == T_TRAIN]
    ops_ms = sum(t["fwd_flops"] for t in step16) / PEAK_BF16_FLOPS * 1e3
    bytes_ms = sum(t["fwd_bytes"] for t in step16) / PEAK_BYTES * 1e3
    kernels.append({
        "name": "lstm_recurrence_fwd_mma",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/lstm_recurrence_fwd_mma.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas.py:116",
        "launches": rpath["launches"]["lstm_recurrence_fwd_mma"],
        "max_abs_err": max(v for c in rk["checks"] + rk["ragged_checks"]
                           if c.get("fwd", c.get("kernel")) == "lstm_recurrence_fwd_mma"
                           for n, v in c["max_abs_err"].items() if n in rec_errs["fwd"]),
        "ms": sum(t["fwd_ms"] for t in step16),
        "ms_again": sum(t["fwd_ms_again"] for t in step16),
        "plain_ms": sum(t["fwd_plain_ms"] for t in step16),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": sum(t["fwd_library_ms"] for t in step16),
        "g5_ms": step16[0]["fwd_ms"], "g5_ms_again": step16[0]["fwd_ms_again"],
        "g5_bound_ms": step16[0]["fwd_bound_ms"], "g5_library_ms": step16[0]["fwd_library_ms"],
        "g5_holes_ms": holes16[0]["fwd_ms"],
        "work": "both layers of one recurrence-backend step (5 weight groups + 1), bf16 "
                "compute dtype, D=2, 400 rows, T=1500, H=64, masks from lengths; "
                "library: cuDNN nn.LSTM training forward in bf16, which also does the input "
                "projection; g5_*: layer 0 (5 groups) alone, g5_holes_*: the same with a mask "
                "with holes; max_abs_err also over 27 rows in 3 groups, T = 1 and 5, D = 1-3",
    })
    ops_ms = sum(t["bwd_flops"] for t in step16) / PEAK_BF16_FLOPS * 1e3
    bytes_ms = sum(t["bwd_bytes"] for t in step16) / PEAK_BYTES * 1e3
    kernels.append({
        "name": "lstm_recurrence_bwd_mma",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/lstm_recurrence_bwd_mma.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas.py:185",
        "launches": rpath["launches"]["lstm_recurrence_bwd_mma"],
        "max_abs_err": max(c["max_abs_err"]["dxg"] for c in rk["checks"] + rk["ragged_checks"]
                           if c.get("sweep", c.get("kernel")) == "lstm_recurrence_bwd_mma"),
        "ms": sum(t["bwd_ms"] for t in step16),
        "plain_ms": sum(t["bwd_plain_ms"] for t in step16),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": sum(t["bwd_library_ms"] for t in step16),
        "ms_again": sum(t["bwd_ms_again"] for t in step16),
        "work": "both layers of one recurrence-backend step (5 weight groups + 1), bf16 "
                "compute dtype, D=2, 400 rows, T=1500, H=64; library: cuDNN nn.LSTM backward "
                "(input) in bf16, with the projection's dx",
    })
    ops_ms = sum(t["wgrad_flops"] for t in step16) / PEAK_BF16_FLOPS * 1e3
    bytes_ms = sum(t["wgrad_bytes"] for t in step16) / PEAK_BYTES * 1e3
    kernels.append({
        "name": "lstm_recurrence_wgrad_mma",
        "route": "cuda",
        "source": "intrepppid_tpu_torch/csrc/lstm_recurrence_wgrad_mma.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas.py:185",
        "launches": rpath["launches"]["lstm_recurrence_wgrad_mma"],
        "max_abs_err": max(c["max_abs_err"]["dw"] for c in rk["checks"] + rk["ragged_checks"]
                           if c.get("wgrad", c.get("kernel")) == "lstm_recurrence_wgrad_mma"),
        "ms": sum(t["wgrad_ms"] for t in step16),
        "ms_again": sum(t["wgrad_ms_again"] for t in step16),
        "plain_ms": sum(t["wgrad_plain_ms"] for t in step16),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": sum(t["wgrad_round_bmm_ms"] for t in step16),
        "bmm_ms": sum(t["wgrad_library_ms"] for t in step16),
        "cuda_core_ms": sum(t["wgrad_cuda_core_ms"] for t in step16),
        "work": "both layers of one recurrence-backend step (5 weight groups + 1), bf16 "
                "compute dtype, D=2, 400 rows, T=1500, H=64; cuda_core_ms: "
                "lstm_recurrence_wgrad.cu on the same operands in the same run (new, old, old, "
                "new); library: the f32 streams rounded to bf16, laid out and multiplied in "
                "one batched cuBLAS product; bmm_ms: that product alone",
    })
    # the bf16 tensor-core recurrence kernels past 288: their main path is the
    # bf16 one-layer model at embedding 320; timed at H = 512 (400 rows in 5
    # groups, T = 300)
    past, h512 = rk["past_288"], rk["past_288"]["h512"]["bfloat16"]
    for key, name, replaces, errs in (
            ("fwd", "lstm_recurrence_fwd_wide_mma", "lstm_pallas.py:116", rec_errs["fwd"]),
            ("bwd", "lstm_recurrence_bwd_wide_mma", "lstm_pallas.py:185", rec_errs["bwd"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
            "replaces": f"intrepppid_tpu/ops/{replaces}",
            "launches": rpath["grad_check_embedding_320"]["bfloat16"]["launches"][name],
            "max_abs_err": max(v for c in past["wide_mma_checks"]
                               for n, v in c["max_abs_err"].items() if n in errs),
            "ms": h512[f"{key}_ms"],
            "plain_ms": h512[f"{key}_plain_ms"],
            "bound_ms": h512[f"{key}_bound_ms"],
            "bound_by": h512[f"{key}_bound_by"],
            "library_ms": h512[f"{key}_library_ms"],
            "rows": h512["plans"][key]["rows"],
            "max_active_clusters": h512["max_active_clusters"],
            "work": "one call at H=512, 400 rows in 5 weight groups, D=2, T=300, full "
                    "lengths, bf16 compute dtype; bound at the bf16 rate; library: "
                    "cuDNN one bidirectional nn.LSTM layer in bf16 at that width, which also "
                    "does the input projection; max_abs_err over H=320, 512 and 1024, masks "
                    "from lengths and with holes (tolerance 2^-7 x max(1, max|ref|)); "
                    "launches: the bf16 model at embedding 320, one layer",
        })
    # the f32 tensor-core sweep past 288: its main path is the f32 one-layer
    # model at embedding 320; timed at H = 512 (400 rows in 5 groups,
    # T = 300)
    name = "lstm_recurrence_bwd_wide_f32"
    kernels.append({
        "name": name,
        "route": "cuda",
        "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas.py:185",
        "launches": rpath["grad_check_embedding_320"]["float32"]["launches"][name],
        "max_abs_err": max(c["max_abs_err"]["dxg"] for c in past["wide_f32_checks"]),
        "scaled_err": max(c["scaled_err"] for c in past["wide_f32_checks"]),
        "ms": h512f["bwd_ms"],
        "plain_ms": h512f["bwd_plain_ms"],
        "bound_ms": h512f["bwd_bound_ms"],
        "bound_by": h512f["bwd_bound_by"],
        "cuda_core_bound_ms": h512f["bwd_cuda_core_bound_ms"],
        "library_ms": h512f["bwd_library_ms"],
        "rows": h512f["plans"]["bwd"]["rows"],
        "max_active_clusters": h512f["max_active_clusters"],
        "work": "one call at H=512, 400 rows in 5 weight groups, D=2, T=300, full lengths, f32 "
                "compute dtype; bound at 495/3 TFLOP/s (three tf32 passes; cuda_core_bound_ms "
                "at 67); library: cuDNN one bidirectional nn.LSTM layer in f32 at that width, "
                "TF32 off, "
                "which also does the input projection; max_abs_err over H=320, 512 and 1024, "
                "masks from lengths and with holes (tolerance 1e-4 x max(1, max|ref|)); "
                "launches: the f32 model at embedding 320, one layer",
    })
    # the f32 tensor-core forward past 288: its main path is the f32 one-layer
    # model at embedding 320 on the default backend; timed at H = 512 (400
    # rows in 5 groups, T = 300)
    name = "lstm_recurrence_fwd_wide_f32"
    kernels.append({
        "name": name,
        "route": "cuda",
        "source": f"intrepppid_tpu_torch/csrc/{name}.cu",
        "replaces": "intrepppid_tpu/ops/lstm_pallas.py:116",
        "launches": rpath["grad_check_embedding_320"]["float32"]["launches"][name],
        "max_abs_err": max(v for c in past["wide_f32_checks"]
                           for v in c["fwd_max_abs_err"].values()),
        "scaled_err": max(c["fwd_scaled_err"] for c in past["wide_f32_checks"]),
        "ms": h512f["fwd_ms"],
        "plain_ms": h512f["fwd_plain_ms"],
        "bound_ms": h512f["fwd_bound_ms"],
        "bound_by": h512f["fwd_bound_by"],
        "cuda_core_bound_ms": h512f["fwd_cuda_core_bound_ms"],
        "library_ms": h512f["fwd_library_ms"],
        "rows": h512f["plans"]["fwd"]["rows"],
        "rows_ms": {k: v for k, v in h512f.items() if k.startswith("fwd_rows_")},
        "max_active_clusters": h512f["max_active_clusters"],
        "steps_launches": rpath["float32_steps_embedding_320"]["launches"][name],
        "work": "one call at H=512, 400 rows in 5 weight groups, D=2, T=300, full lengths, f32 "
                "compute dtype; bound at 495/3 TFLOP/s (three tf32 passes; cuda_core_bound_ms "
                "at 67); rows_ms: at each row tile; library: cuDNN training forward of one "
                "bidirectional nn.LSTM layer in f32 at that width, TF32 off, which also does "
                "the input projection; max_abs_err over H=320, 512 and 1024, masks from lengths "
                "and with holes, and 400 rows at 320 and 512 (tolerance 1e-4 x max(1, "
                "max|ref|)); launches: the f32 model at embedding 320, one layer, on the "
                "default backend (steps_launches: its timed steps)",
    })
    # the bf16 tensor-core kernels of phase fit's epochs, val and test passes,
    # and of phase train_cli's run (training, val, test) and eval command
    for k in kernels:
        if k["name"] in FIT_BF16:
            k["fit_launches"] = fit["launches"][k["name"]]
            k["train_cli_launches"] = tcli["launches"][k["name"]]
            k["train_cli_eval_launches"] = tcli["eval_launches"][k["name"]]
            k["data_parallel_launches"] = sum(r[k["name"]] for r in
                                              dp["train_2_ranks"]["launches"])
            k["work"] += ("; fit_launches: phase fit (3 epochs of 6 steps at the manuscript "
                          "width, bf16, each with a val pass, then test('best')); "
                          "train_cli_launches: phase train_cli (train e2e_rnn_triplet, 3 "
                          "epochs of 6 steps on tokenised synthetic HDF5 tables, each with a "
                          "val pass, then test('best')), train_cli_eval_launches: its eval "
                          "command; data_parallel_launches: both ranks of phase "
                          "data_parallel's train e2e_rnn_triplet --n_data_parallel 2 (2 "
                          "epochs of 6 steps of 40 rows a rank, the val and test passes)")
    for key in ("fit_launches", "train_cli_launches", "data_parallel_launches"):
        entries = [k for k in kernels if key in k]
        if sorted(k["name"] for k in entries) != sorted(FIT_BF16) or any(
                k[key] <= 0 for k in entries):
            raise AssertionError(f"the kernels line lacks an entry of the path's kernels, or "
                                 f"one never launched there: {key}")
    # the eval forwards on grouped weights (variational dropout): phase
    # variational's engine (f32) and its CLI run, training and eval (bf16)
    vcli = var["train_cli"]
    grouped_paths = {
        "bilstm_layer_fwd_f32": ("float32", var["engine"]["launches"]["bilstm_layer_fwd_f32"][1]),
        "bilstm_layer_fwd_mma": ("bfloat16", vcli["grouped_launches"]["bilstm_layer_fwd_mma"]
                                 + vcli["eval_grouped_launches"]["bilstm_layer_fwd_mma"])}
    for k in kernels:
        if k["name"] not in grouped_paths:
            continue
        dtype, k["variational_launches"] = grouped_paths[k["name"]]
        checks = [c for c in var["kernel_checks"] if c["dtype"] == dtype]
        k["grouped_eval_max_abs_err"] = max(max(c["max_abs_err"].values()) for c in checks)
        k["grouped_eval_scaled_err"] = max(c["scaled_err"] for c in checks)
        for c in checks:
            tag = f"grouped_g{c['G']}"
            k.update({f"{tag}_{n}": c[n] for n in ("ms", "ms_again", "ungrouped_ms",
                                                   "plain_ms", "bound_ms", "bound_by")})
        k["work"] += ("; variational_launches: its launches on grouped weights (layer 0 of the "
                      "ablation network, variational dropout) in phase variational's "
                      + ("engine" if dtype == "float32" else "train and eval commands")
                      + "; grouped_eval_*: that layer against the plain version at G = 2 x 400 "
                      "and 5 x 80 rows, T = 1500, lengths mixing 0, 1, T and random values; "
                      "grouped_gN_*: timed at full lengths in turns with the same rows on "
                      "one weight group (ungrouped_ms)")
        if k["variational_launches"] <= 0:
            raise AssertionError(f"phase variational never ran {k['name']} on grouped weights")
    if len(kernels) != 37 or any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel of a main path was never launched: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    lacking = [(k["name"], n) for k in kernels for n in keys if n not in k]
    if lacking:
        raise AssertionError(f"kernels line entries lack keys: {lacking}")
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s ({seconds})", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
