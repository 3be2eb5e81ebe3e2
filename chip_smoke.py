#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), then the build of every
   ``speechsplit_tpu_torch/csrc/*.cu`` file with nvcc for sm_90a;
2. each inference kernel against its plain PyTorch version on the card,
   at the shapes the conversion paths give it (``bilstm_infer`` also at
   the 731-pair call's B731 H256, ``multi_bilstm_infer`` at its B5117
   (8, 32, 1) and B731 (32, 1)), with its time, the plain version's
   time, the least time the card could take (bound) and a cuDNN LSTM as
   a yardstick (the multi-stream kernels: also their kernel's device
   time, the calls queued behind a spin kernel); the merged forwards'
   edges (T=1, B=1, ragged rounds, widths not a multiple of 4, a partial
   128-wide pass, one block a direction, batch tiles, the batch limit of
   each at H 512, 256 and 8, and one row past it, which raises);
   ``bilstm_infer`` at H=256 in each plan (one or two warps a unit) at
   B4, B16 and B731;
   both multi-stream forwards at their edges (widths 1-64 alone and
   mixed, B 1, 3 and 33, T=1, 8 directions; the gradient kernel on the
   residual-saving forward's own g and c) and ``multi_bilstm_infer``'s
   block plan timed at B13 (64, 3, 1);
3. full-width ``convert_batched``: 4 synthetic pairs x 7 conditions
   through seeded default-config models, checked finite, against the
   same call on the plain versions and against the per-utterance
   ``convert`` (batch 1), and through both kernels (launch counts set
   to 0 just before and read just after), timed per call;
4. one ``convert_batched`` call under ``torch.profiler``: device time by
   op and the card's idle share of the call;
5. the normal entry point ``cli.convert`` on reference-format ``.ckpt``
   files and a demo-style metadata pickle, writing 7 mels and, with
   ``--synthesize``, 7 PCM16 wavs;
   then the serving path, wav in and wav out:
   a. ``kernel viterbi_decode``: the pitch tracker's decoder against its
      plain loop on the card, states equal bit for bit, on seeded
      candidate fields at B 1, 2, 28 and T 1, 2, 257, 1876 and at its
      edges (every candidate unusable, every cost equal with every state
      unvoiced or every voiced state tied, K + 1 = 32 states, and 33,
      which raises), and both plans (the backpointers
      in shared memory, or past ``pitch.SHARED_BACK_BYTES`` in device
      memory) at the shared plan's largest T and the next, at K = 12 and
      K + 1 = 32; at B1 T257 (a 3 s request's) and B28 T1876 its states
      on the timed inputs against the plain loop's, its ms, device time,
      the plain loop's ms and its bound, and in the log line only the
      probe build's split (cycles a step of the forward pass and of the
      backtrace) and the measured latency floor (T - 1 irreducible
      steps); each plan's registers, spills, stack frame and shared
      memory;
   b. ``front end``: ``preprocess.extract_features`` on a 3 s and an 8 s
      wav made here (a harmonic tone gliding 110-180 Hz with a silent
      gap): one decoder launch an extraction, against the same call with
      the plain decoder on the card (mel within 1e-6, F0 equal) and on
      the CPU with the same dither draws (mel within 1e-4; F0 voicing and
      bins, and the tracker's log-F0, on 99.5% of the frames); ms an
      extraction with the kernel and with the plain loop; the tracker's
      window prefix sums in XLA's summation order against two float64
      ``torch.cumsum`` calls, ms each;
   c. ``vocoder``: ``GriffinLimVocoder.synthesize_batch`` (100
      iterations) on 14 mels of 192 frames: finite, the PCM16 path
      within 1 LSB of the float path, ms a call;
   d. ``serve``: the port's ``cli.serve`` handler in a thread on an
      ephemeral port, full-width seeded models loaded from ``.ckpt``
      files; three ``POST /convert`` requests (a 3 s pair, an 8 s pair
      through ``convert_long``, the first again, whose mels must equal
      the first's), every reply 200 with 7 int16 wavs and 7 finite mels,
      the launches of each request; each pair's mels within 5e-4 of the
      same call under ``plain_kernels()`` with the same F0; ms a request
      (median of 5 after a warm-up) split into features, conversion and
      vocoder; the card's busy share of one request (a direct
      ``convert_wav_files`` call under ``torch.profiler``); TF32 off;
   e. ``kernel sosfilt`` / ``kernel lfilter``: ``csrc/iir.cu``, the
      filter oracles' sample recurrences, in four instances (the
      high-pass's sections at float32 and float64 under
      ``highpass_filtfilt``, its (b, a) form at float64 and a stable
      low-pass at float32 under ``filtfilt``): each zero-phase call
      against the same call with the plain loop on the card at B16 x
      2000 samples, bit for bit; the main path (counts set to 0 just
      before, read just after: two launches a call) at B16 x the 3 s and
      8 s wavs and B1 x 3 s against scipy's float64 filters on the host
      (``IIR_*_TOL``); one pass's ms and device time at B1 and B16 x 3 s
      and B16 x 8 s beside the bound and the measured floor (samples x
      stages dependent multiply-adds, ``iir_floor_launch``), the plain
      loop's ms at the check's shape, and each instance's registers,
      spills and stack frame;
   f. ``front end time``: ``extract_features(highpass_mode="time")`` on
      the 3 s and 8 s wavs: one decoder launch an extraction; the
      high-passed, dithered signal within 2e-6 of the CPU's, and on the
      card's signal the mel within 1e-4 of the CPU's and the F0 on 99.5%
      of its frames (the whole call on the CPU reported beside); ms in
      turns with the ``"stft"`` mode;
   g. ``pitch decoders``: ``track_pitch`` on a B16 batch of 3 s
      synthetic utterances (``data.synthetic.random_utterance``) with
      each of the parallel decoder, the block decoder at radix 4 and 16,
      the top K by argmax passes and the conv NCCF, against the default
      (JAX's bars between its own decoders), the gross pitch error of
      each against the synthesis ground truth, the decoder kernel's
      launches (none for the parallel and block decoders), ms in turns
      with the default;
   h. ``pitch native``: ``ops.pitch_native`` built by g++ from the port's
      ``csrc/rapt.cc``, against the card's tracker on three tones
      (tests/test_pitch_native.py's bars) and on that batch, ms a 3 s
      utterance on the host;
6. each training kernel (residual-saving forward, gradient) against its
   plain version at the train step's shapes (T=192, B=16), timed beside
   its bound and a cuDNN LSTM's training forward and backward; then the
   ``autograd.Function`` of each op on CUDA tensors against autograd
   through the plain loop; the gradient kernel's edges (ragged widths,
   batch tiles, its batch limit at H=512 and one row past it, which the
   kernel refuses); the four kernels again with bfloat16 residuals (the
   default config's) at the same shapes against their plain versions at
   bfloat16 (float32 outputs within ``PATH_TOL``, bfloat16 ones within
   one bfloat16 ulp element by element), timed beside their bounds at
   those bytes, and at their other code paths (widths not a multiple of
   4 or 8, H=1, batch tiles, the batch limit, the multi-stream edges on
   the lane plan); then the probe build of
   the gradient kernel
   (``-DBILSTM_BWD_PROBE``): a clock64() split of its step into barrier
   wait, d_pre staging, FMAs and reduction, cell gradient and stores,
   and prefetch and arrival, at B16 and H 512, 256 and 8 (``[bwd
   probe]``); and the probe build of the merged forwards
   (``-DBILSTM_INFER_PROBE``): a step split into barrier wait, h
   staging, FMAs and reduction, cell and stores, and gate-input prefetch
   and arrival, at B28 H512 (lean), B16 H512 (residual-saving) and B731
   H256 (lean) (``[infer probe]``); the probe build of the multi-stream
   forwards (``-DMULTI_BILSTM_PROBE``): a lane-plan step split into
   gate-input wait, product, cell and stores, and prefetch, per stream
   width, at B28 (lean) and B16 (residual-saving) (``[multi probe]``);
   the probe builds of the two gradient recurrences on the lane step
   (``-DMULTI_BILSTM_BWD_PROBE``, ``-DLSTM_BWD_PROBE``): a step split
   into residual wait (with the next step's gate factors), product, cell
   gradient and stores, and prefetch, for ``multi_bilstm_bwd`` per
   stream width at B16 (8, 32, 1) and (32, 1) (``[multi bwd probe]``),
   and for ``lstm_bwd`` at B16 H 512, 256 (the wide plan, with the
   barrier wait) and 8 (``[lstm bwd probe]``); and the probe build of
   ``lstm_fwd`` (``-DLSTM_FWD_PROBE``): a step split into barrier wait,
   h and gate-input wait, product, cell and stores, and prefetch and
   arrival, at B16 H 512, 256 (the wide plan) and 8 (the narrow one)
   (``[lstm fwd probe]``);
7. the full-width generator and F0-converter train steps on a seeded
   ``Collator`` batch of 16: the launches of every kernel in one step
   (counts set to 0 just before and read just after), the step against
   the same step on the plain versions, 5 steps with a finite loss, and
   the median time per step over 12 timed steps (float32 with TF32 off,
   as compared); then both steps at the default config
   (``SpeechSplitConfig()``: bfloat16 residuals and Adam mu, TF32): the
   same launches with no call of a plain version, the loss and every
   gradient within 2% of the plain step at the same precision (the
   Functions on their plain versions; also with TF32 off), each one's
   error against the exact float32 step recorded (bfloat16's error), 5
   finite steps, and the median time per step in turns with the float32
   step;
   then ``[ddp]``, data-parallel training (``parallel``) at full width
   on that batch of 16: (a) a world of one under NCCL, the DDP step and
   the explicit all-reduce step (``make_train_step_shard_map``) 5 steps
   each of the float32 config against the plain step, bit for bit or,
   where not, the largest differences printed and held to ``STEP_TOL``
   (loss) and 1e-4 (parameters), and the three steps' ms timed in
   turns; (b) two gloo ranks spawned onto the one card, 8 rows each, 3
   DDP steps each of the one-hot generator, the F0 converter and
   learned mode with ``spk_contrast_weight=0.5`` at the float32 config
   (the loss within 1e-5 and every parameter within 1e-4 of one process
   at B16, JAX's mesh bars) and of the one-hot generator at the default
   config (PARITY.md #10's 2%: the loss, and each gradient of the first
   step, after its reduction, as ``BF16_STEP_TOL`` reads a gradient: 3
   Adam steps at lr 1e-4 move a parameter less than any parameter bar
   could tell a wrong reduction from a right one), both ranks'
   parameters equal; (c) each
   rank's launches of the training kernels in one step, nonzero and
   equal to a B8 one-process step's; (d) the two ranks' ms a step,
   printed as two ranks sharing one card (not a scaling figure), and
   the phase's seconds;
8. one generator train step under ``torch.profiler``;
   then ``train.cli``, the trainer through its entry point at full
   width: ``cli.train`` on a seeded feature tree (8 speakers, 1-3
   utterances of 150-400 frames) for the generator and the F0
   converter, 6 iterations with a checkpoint every 3, a resume from
   step 3 into a copy of the checkpoints (lazy reads, bfloat16 feed,
   the newest checkpoint kept), three runs of 30 iterations timed (wall
   time, one synchronize at the end), each followed by 30 bare steps on
   its state, and 15 iterations under ``--profile_dir`` (the card's busy
   share of the traced steps): every checkpoint loads strictly, the
   resumed state before its first step equals the checkpoint's (params,
   Adam moments, step, generator state), every logged loss is finite,
   each run launches its steps times phase 7's count a step; the loop's
   ms a step beside the bare step's, timed in turns;
   ``Solver.validate()`` over two utterances against the same call on
   the plain versions, each utterance's mels and the sum-MSE, with its
   launches; and the prefetch to the card, plain and compressed: each
   delivered batch, read after a train step and a spin on the
   consumer's stream, equals its host batch bit for bit; then
   ``cli.train`` at the default config (no precision in ``--hparams``)
   for both models, 6 iterations and a resume from step 3 whose state
   equals the checkpoint's, Adam's mu bfloat16 in every checkpoint;
   then bfloat16 compute (``compute_dtype="bfloat16"``: W_hh bfloat16,
   h_{t-1} and the gradient's d_pre rounded to bfloat16 for the step
   products, bfloat16 xp streams beside bfloat16 residuals): each
   bfloat16-compute instance of the four kernel bodies against its plain
   version (``bilstm_infer`` at B28 H512, H256 and H8 beside either
   stream, ``bilstm_fwd`` and ``bilstm_bwd`` at B16 H512, H256 and H8 at
   both residual dtypes, the multi-stream lane plan at B28 and B4 lean
   and at B16 and B28 for training, W_hh bfloat16 for H >= 2 and float32
   for H=1 in one call) at the flip bar (``COMPUTE_FLIP``), timed with
   its device time, plain time and bound at those bytes, and their edges
   (T=1, one row, ragged widths and rounds, H=1, batch tiles, the batch
   limits); both train steps at
   bfloat16 compute, B16 and B32, at bfloat16 residuals (and float32 ones
   at B16): exact launches, no plain call, loss and gradients within 2%
   of the plain step, their distance from the float32 step recorded, 5
   finite steps, ms a step in turns with the default config's and the
   float32 step; ``cli.train --hparams compute_dtype=bfloat16,
   batch_size=32`` for both models (6 iterations, checkpoints loading
   into a float32-compute model, a resume whose state equals the
   checkpoint's) and ``Solver.validate()`` against the plain call;
   ``convert_batched`` at 4 pairs at bfloat16 compute at both residual
   dtypes against the plain call, timed in turns with the float32 call;
   one 3 s ``POST /convert`` to a server at bfloat16 compute beside one
   at float32;
9. with ``ops.bilstm.PROJ_FUSION = "auto"`` (the input projection inside
   the kernel; every phase above runs with "off" and launches no fused
   kernel): each fused kernel against its plain version at every shape
   of the fused conversion and train steps, timed beside its bound, the
   port's composed path at the same shape (two ``F.linear`` and the
   unfused kernel) and a cuDNN ``torch.nn.LSTM(I, H)`` carrying the same
   weights; the kernels' edges, the batch limit included;
   ``BiLSTMFusedFunction`` on CUDA against autograd through the plain
   loops;
10. ``convert_batched`` at 8 pairs x 7 conditions with fusion on: exact
    launch counts, within the path bar of the plain call and of the call
    with fusion off, both timed in the same run;
11. both train steps with fusion on: exact launch counts, against the
    plain step, 5 steps, and the median time per step beside the
    unfused step's, timed in turns;
12. the single-direction kernels of ``ops.lstm`` (the route a BiLSTM
    layer takes where ``ops.bilstm.merged_bidir_fits`` is false, and any
    ``LSTM(bidirectional=False)``): ``lstm_infer``, ``lstm_fwd`` and
    ``lstm_bwd`` against their plain versions in both directions at the
    shapes phases 13 and 14 give them, timed beside their bounds, the
    plain versions, a cuDNN unidirectional LSTM and the merged kernels
    (the training kernels and cuDNN's forward also by device time);
    content layer 1 (B16 H8) on either route, two ``lstm_fwd`` and two
    ``lstm_bwd`` against ``bilstm_fwd`` and ``bilstm_bwd``, by device
    time; ``lstm_infer`` also against a float64 run, and over widths 8-512 at
    phase 13's batch in each of its plans (the sweep that sets its plan
    border); the merged ``bilstm_infer`` beside two
    ``lstm_infer`` launches at batches up to the largest it holds, at
    H=512 (from 28), H=256 (from 4) and H=8 (from 28);
    edges (T=1, B=1, ragged row tiles, odd widths, the plan borders at
    widths 31, 32 and 33, the training kernels' batch limits, which their
    sources state, and one row more, which raises (at H=8 and H=512),
    and ``lstm_infer`` at 16384 rows); every edge
    also against a float64 run of the plain loop; ``LSTMFunction`` on
    CUDA against autograd through the plain loop;
13. ``convert_batched`` at the fewest pairs (731) whose 7 rows a pair the
    merged kernels refuse for the mel decoder and content layer 1:
    exact launch counts (no merged launch on those layers), against the
    plain call, timed, and one call under ``torch.profiler``;
14. both train steps with ``merged_bidir_fits`` forced false, so every
    merged layer takes the single-direction route (a real step at a
    batch the merged kernels refuse needs more memory than the card
    has): exact launch counts (no ``bilstm_*`` launch), against the
    plain step, 5 steps, and the median time per step beside the default
    step's, timed in turns;
15. learned speaker mode (``spk_emb_mode="learned"``, run after the
    bfloat16-compute phases) and the shipped neural vocoder:
    ``train learned``: the learned generator step at B16xT192 on a batch
    of 4 speakers at float32 (TF32 off), at the default config, at
    the default config with ``spk_contrast_weight=0.1`` and at bfloat16
    compute: launches equal
    to the one-hot step's, no plain call, the loss and every gradient
    (the SpeakerEncoder's too) within 5e-4 (float32) or 2% of the plain
    step, the contrastive term's value, ms a step in turns with the
    one-hot step; ``train.cli learned``: ``cli.train --hparams
    spk_emb_mode=learned``, 6 iterations, checkpoints loading strictly
    into a learned model only, a resume (its loader started where the
    uninterrupted run's was) whose state equals the checkpoint's and
    whose last checkpoint equals the uninterrupted run's, bit for bit,
    and ``Solver.validate()`` against the plain call; ``convert learned``: ``with_learned_embedding`` on both
    utterances of 4 pairs and ``convert_batched``, embeddings and mels
    against the plain calls (also at bfloat16 compute), ms a call in
    turns with the one-hot call;
    ``serve learned``: ``cli.serve`` handlers over a learned
    ``VoiceConverter`` with ``load_vocoder("default",
    refine_iters=48)`` and over the same models with Griffin-Lim, the
    3 s and 8 s pairs with no embeddings passed, mels against the plain
    call, a repeat equal, ms a request split into features, conversion
    and vocoder, the two in turns, the card's busy share of one request;
    the neural vocoder on the card against the port's vocoder on the
    CPU for the same mels (the head's spectrum, and the PCM16 after 48
    iterations: ``VOCODER_*``);
16. from a wav tree to trained models (run after phase 15):
    ``prepare``: a wav tree made here (4 speakers, 2 M and 2 F, 80
    utterances each of 1-8 s, PCM16), ``cli.preprocess`` at the JAX
    defaults (B16, 8 batches a dispatch; one ``viterbi_decode`` launch
    a batch and nothing else, counts set to 0 just before and read just
    after) and ``cli.metadata``: every file of its utterance's frames,
    finite; ``extract_dir`` again with the same seed writes the same
    files bit for bit (ms an utterance, mel frames a second, the seconds
    of reading, queueing the extraction, waiting for the fetch and
    writing); a run with the dither hook whose files, for 3 batches,
    equal ``extract_features`` on the batch with the same draws, with F0
    equal to the plain decoder's; the card's busy share of a profiled
    run; ``viterbi_decode`` at B16 and an 8 s utterance's 501 frames;
    the dither's draws made on the host and uploaded beside made on the
    card; ``cli.train`` at the default config for 4 steps on the
    prepared corpus (launches a step as phase 7's, finite losses);
    ``train resident``: ``build_resident_from_wavs`` on that tree at a
    bfloat16 store (one ``viterbi_decode`` a batch) equal bit for bit to
    ``extract_dir(compress_fetch=True)`` -> ``build_resident`` (seconds,
    MB, bytes an utterance); ``collate_on_device`` equal to the host
    loader's batches for 6 batches; at the default config 2 resident
    steps, a ``[2, B]`` resident call and a stacked-host k=4
    ``make_train_multi_step`` call equal to 8 host-batch steps bit for
    bit (at float32 within 4 times the host loop's own repeat distance),
    launches a step as phase 7's; the JAX README's recommended run,
    ``cli.train --wav_dir --data_on_device --steps_per_dispatch 10
    --hparams batch_size=32,compute_dtype=bfloat16`` for 50 steps
    (finite losses, ``50-G.ckpt`` into ``VoiceConverter``, 50 steps'
    launches); steps a second of the Solver's loop, host and resident at
    K = 1 and 10, at B16 default and B32 bfloat16 compute, in turns, and
    the card's idle share of a profiled host K=1 window and one resident
    K=10 call;
    ``train vocoder``: ``cli.train_vocoder`` at the shipped asset's
    width (256 channels, depth 6), B16, crop 64, 200 iterations at 25
    steps a dispatch on that corpus: finite losses, the last dispatch's
    mean below the first's, ``200-V.npz`` read by ``load_vocoder`` into
    finite PCM16; one step's loss and gradient on the card against the
    port's on the CPU from the same state and crops (``VOC_*``); steps a
    second of the resident path and of host ``make_crops``, in turns;
17. the single-direction kernels at bfloat16 (run after phase 14): the
    eight bfloat16 instances of ``lstm_infer`` (W_hh bfloat16 beside a
    float32 or a bfloat16 xp), ``lstm_fwd`` and ``lstm_bwd`` (bfloat16
    residuals at float32 W_hh, bfloat16 W_hh at float32 residuals, and
    both with a bfloat16 xp) against their plain versions in both
    directions, ``lstm_infer`` at the 731-pair call's B5117 H512 and H8,
    the training pair at B16 H512, H256 and H8: the flip bar
    (``COMPUTE_*``; at float32 W_hh the bfloat16-residual bars), rounding
    where the plain version rounds, ms, device time, plain ms and the
    bound at those bytes; their edges (T=1, B=1 and odd batches, widths
    1, 31-33, 64, 100, 130, 257, batch tiles, ``MAX_FWD_BATCH`` and
    ``MAX_BWD_BATCH``);
18. ``convert_batched`` at 731 pairs at bfloat16 compute: at the default
    bfloat16 residuals 8 ``lstm_infer`` launches (bfloat16 xp), the mels
    within ``COMPUTE_PATH_TOL`` of the largest magnitude of the plain
    call's but for ``COMPUTE_FLIP_SHARE`` of their elements, ms a call in
    turns with the float32 call; at float32 residuals the launches and
    finite mels;
19. both train steps with ``merged_bidir_fits`` forced false at the
    default config and at bfloat16 compute (bfloat16 and float32
    residuals): 8 ``lstm_fwd`` and ``lstm_bwd`` for the generator, 4 for
    the F0 converter, no plain call, loss and gradients within 2% of the
    plain step, ms a step in turns;
20. the bfloat16 instances of the multi-stream block plans (a call with
    a width past ``LANE_MAX_H``) and of the fused kernels (run after
    phase 11): ``[kernel multi_bilstm_*/block_*]`` at float32 W_hh and
    bfloat16 residuals (the default config's: h and dx within
    ``PATH_TOL``, g and c within ``BF16_ULPS``) and at bfloat16 compute
    at both residual dtypes (the flip bar and the rounding check) at the
    [wide bottleneck] steps' B16 (8, 64, 1) and (64, 1), lean at B28 and
    B4 and at B13 (64, 3, 1); their edges (widths 33 and 64, alone and
    mixed, B 1, 3, 9 and 13, T=1; ``[kernel multi block bf16 edges]``);
    ``[kernel bilstm_fused_*/bf16_*]``: the lean fused kernel at bfloat16
    compute at B56 and B16 I1024 H512, the residual-saving one at
    bfloat16 residuals (float32 compute: every element within its
    dtype's bar) and at bfloat16 compute at both residual dtypes (the
    flip bar and the rounding check), and their edges (``[kernel fused
    bf16 edges]``); each with ms, device time, the plain version's ms,
    the float32 twin's device time, the bound at those bytes, and its
    and its twin's registers, spills and stack frame (``[codegen ...]``:
    ``-Xptxas -v`` of the three sources, compiled while the checks run);
21. ``convert_batched`` at 8 pairs with fusion on at bfloat16 compute: 6
    ``bilstm_fused_infer`` and 2 ``multi_bilstm_infer`` launches, within
    ``COMPUTE_PATH_TOL`` of the plain call, ms in turns with the
    composed call; both train steps with fusion on at the default
    config and at bfloat16 compute at both residual dtypes: 4 (2)
    ``bilstm_fused_fwd`` launches a step, within 2% of the plain step;
22. ``[wide bottleneck]``: ``dim_neck_3=64`` (the block plans) at full
    width: both train steps at the default config and at bfloat16
    compute at both residual dtypes (one ``multi_bilstm_fwd`` and
    ``_bwd`` a step, within 2% of the plain step, ms in turns with the
    default widths' step), the 4-pair conversion at float32 (mels within
    ``PATH_TOL`` of the plain call) and at bfloat16 compute, ms in turns
    with the default widths' call, and ``cli.train --hparams
    dim_neck_3=64`` for both models; ``dim_neck_3=128`` (past the
    kernels' ``MAX_HIDDEN``: each encoder's own layer): the conversion
    (11 ``bilstm_infer``, no ``multi_bilstm_*``) against the plain call
    and both default-config train steps (7 and 4 ``bilstm_fwd`` and
    ``bilstm_bwd``, no ``multi_bilstm_*``);
23. ``[convert stream]``: ``convert.convert_stream`` at full width,
    float32 with TF32 off, over 24 batches of 8 pairs and 3 batches of
    phase 13's 731 pairs (depth 2): each yield equal, bit for bit, to
    ``convert_batched`` on its batch (else the largest difference,
    within ``PATH_TOL``); the kernels' launches of a stream equal to its
    batches' ``convert_batched`` launches (counts set to 0 just before
    and read just after); at 8 pairs ``compress_fetch=True`` (each value
    the float32 yield rounded to bfloat16, bit for bit) and ``"auto"``
    (the ``linkprobe.probe_link`` profile, the choice, yields equal to
    the chosen mode's); the host time of a submit beside its grid's
    device time; ``torch.cuda.set_sync_debug_mode`` around the submits
    (not the fetches), and what it flags; the card's idle share of a
    profiled stream beside that of a loop of ``convert_batched``; the
    731-pair grid's fetch into pageable and into pinned memory; and
    utterances/s of the stream against the loop, in turns, at both
    sizes.
24. ``[dtype pairs]``: the float32/bfloat16 sets JAX's recurrence ops
    take beyond those its models form, and JAX's four stream switches,
    which the ops bring to the kernels' instances by casts
    (``ops.bilstm.kernel_set``, ``kernel_streams``; no instance is new):
    each cast that rounds (g and c of a forward on float32 residuals, dx
    of a gradient on them) through the merged op at B16 T192 H512 and
    the single-direction op at H512 and H8, forward and gradient, equal
    bit for bit to the instance that takes the set itself on the same
    values, both timed; the fused op with W_ih and W_hh of two dtypes
    (on the merged kernel) and a bfloat16 multi-stream xp on both plans
    against their plain versions; a generator step at B16 x T192 under
    ``LAYER_VJP="on"``, ``GRAD_STREAM_FOLLOWS_RESIDUAL=False`` and
    ``DH_STREAM_FOLLOWS_RESIDUAL=False`` at the default config and under
    ``XP_STREAM_FOLLOWS_COMPUTE=False`` and
    ``H_STREAM_FOLLOWS_COMPUTE=True`` at bfloat16 compute, each within
    2% of the plain step (PARITY.md #10) with its launches (counts set to
    0 just before); the 4-pair ``convert_batched`` at bfloat16 compute
    under the h switch, equal bit for bit to the call with it off and
    within ``COMPUTE_PATH_TOL`` of the plain call; and, as a reading, the
    same conversion through weights the bfloat16-compute models draw
    from the seed, against its plain call with the switch off and on.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without CUDA, or outside the repo, it
exits non-zero and prints no result.

    python3 chip_smoke.py --against DIR [--rounds N]

compares the default (unfused) path of this checkout with that of the
checkout in DIR (for example the parent commit, unpacked with ``git
archive``): the registers, spills, stack frame and a hash of the
machine code nvcc gives each kernel of the merged BiLSTM sources
(``bilstm_infer.cu``, ``bilstm_bwd.cu``), the single-direction ones
(``lstm_infer.cu``, ``lstm_bwd.cu``) and the multi-stream ones
(``multi_bilstm_infer.cu``, ``multi_bilstm_bwd.cu``) in either tree,
and for each kernel whether the two trees' machine code is the same
(a float32 instance keeps the key it had before its type arguments
were added, a bfloat16-residual one ends in ``bf16``, a
bfloat16-compute one names its W_hh and stream types, ``f`` or
``bf16``), and a summary of the keys in both trees; with ``--rounds
0`` that is all; then ``convert_batched`` at phase 13's pair count in
a process of either tree, reporting whether it completed or raised;
then N rounds of DIR, this, this, DIR, each a process of its own that builds its tree's
kernels and times, through that tree's own phase functions,
``bilstm_infer`` at the conversions' shapes (B28 H512, B4 H256, B28 H8,
B731 H256), ``bilstm_fwd`` and ``bilstm_bwd`` at the train shapes,
``bilstm_fused_infer`` at the fused conversion's B56 I1024 H512 and
``bilstm_fused_fwd`` at B16 I1024 H512, ``lstm_infer`` at phase 13's two
shapes and both directions of it at H=512 over batches 28-224,
``lstm_bwd`` and ``lstm_fwd`` at B16 H512, H256 and H8 (device time;
``lstm_fwd`` beside cuDNN's training forward on the same inputs) and
``lstm_fwd`` at B5117 and B13948 H512 (device time),
``viterbi_decode`` at B1 T257, B16 T501 and B28 T1876 (device time),
content layer 1 (B16 H8) on either route (device time),
``multi_bilstm_infer`` at B28 (8, 32, 1), B4 (32, 1), B5117 (8, 32, 1)
and B731 (32, 1) and its block plan at B13 (64, 3, 1), and
``multi_bilstm_fwd`` and ``multi_bilstm_bwd`` at B16 (8, 32, 1) and
(32, 1) (a wrapper call, and the kernel's device time with the calls
queued behind a spin kernel), the 4-pair ``convert_batched`` call (wall
time, and the card's busy time in one profiled call), and both train
steps on the default route and with the single-direction route forced,
in turns. It prints one line per process and the medians of each tree
side by side.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import pickle
import subprocess
import sys
import tempfile
import time

T = 192
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): float32 outside the
# tensor cores, bfloat16 on the tensor cores (dense, float32 sums), and
# HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# sums of 192 dependent float32 steps taken in another order than the
# plain version's matmul: a few ulps a step, compounded
KERNEL_TOL = 1e-4
# the whole model in another order end to end (PARITY.md demo bar 5e-4)
PATH_TOL = 5e-4
# the lean kernel at B28 H512 before it shared its body with the
# residual-saving forward (PERF.md, the slice-1 table): printed beside
# this run's time
LEAN_B28_H512_MS_BEFORE = 3.6035
# the train step's batch
TRAIN_B = 16
# clock cycles of the spin kernel that kernel_device_ms queues calls
# behind: many times what the host takes to queue them
SPIN_CYCLES = 100_000_000
# the fused conversion's pairs (generator batch 8 x 7 = 56)
FUSED_PAIRS = 8
# a train step against the same step on the plain versions: the loss
# relative, and each gradient's max abs error over its max abs
STEP_TOL = 5e-4
# a kernel's bfloat16 outputs (g, c, dxp) against its plain version's:
# one bfloat16 ulp of the element, element by element, beyond float32
# noise of this share of the tensor's largest magnitude (both round
# float32 values that sums taken in another order make, so a rounding
# may flip; tests/test_torch_residual_bf16.py holds the plain versions
# to JAX at the same bar)
BF16_ULPS = 1.0
BF16_NOISE = 1e-6
# a default-config train step (bfloat16 residuals) against the plain step
# at the same precision, the loss and each gradient as STEP_TOL reads
# them: PARITY.md #10's 2% max-relative
BF16_STEP_TOL = 0.02
# the train.cli phase: iterations a run, the save and log cadence, and
# the iterations of the run that times the loop
CLI_STEPS = 6
CLI_SAVE = 3
CLI_TIMED_STEPS = 30
# timed Solver runs, each followed by as many bare steps on its state
CLI_ROUNDS = 3
# a run under --profile_dir traces the Solver's default window, steps
# 10-14 (profile_start 10, profile_steps 5), and ends after it
CLI_PROFILED_STEPS = 15
# the prefetch's check: host batches a pass, and the spin (clock
# cycles, about 10 ms) that holds the consumer's stream back before it
# reads each delivered batch, so that the side stream's later copies
# run while the batch is still to be read
PREFETCH_BATCHES = 8
PREFETCH_SPIN_CYCLES = 20_000_000
# and its large batches (rows of 192 x 80 mels, 126 MB a batch), each
# copied for some ms, read on the consumer's stream as soon as delivered
PREFETCH_LARGE_ROWS = 2048
PREFETCH_LARGE_BATCHES = 3


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fmt(row: dict) -> dict:
    return {k: (f"{v:.6g}" if isinstance(v, float) else v)
            for k, v in row.items()}


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


@contextlib.contextmanager
def strict_float32(scope: str = "comparison"):
    """Full float32: no TF32 in cuDNN convs or matmuls."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("tf32", cudnn_allow_tf32=False, matmul_allow_tf32=False,
        scope=scope)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls and the pitch tracker's Viterbi
    decoder to the plain PyTorch versions (under autograd: autograd
    through the plain time loops)."""
    from speechsplit_tpu_torch.ops import bilstm, lstm, multi_bilstm, pitch

    def saves_nothing(fn, n_args):
        """``fn`` on the ops' first ``n_args`` arguments: the plain
        versions save no residuals, so the residual dtype the layers pass
        goes unused (autograd through the plain loop is float32)."""
        def run(*args, residual_dtype=None):
            return fn(*args[:n_args])
        return run

    saved = (bilstm.bilstm_sequence, bilstm.bilstm_sequence_fused,
             multi_bilstm.multi_bilstm_sequence, lstm.lstm_sequence,
             pitch.viterbi_decode)
    pitch.viterbi_decode = pitch.viterbi_decode_reference
    bilstm.bilstm_sequence = saves_nothing(bilstm.bilstm_sequence_reference, 4)
    bilstm.bilstm_sequence_fused = saves_nothing(
        bilstm.bilstm_sequence_fused_reference, 7)
    multi_bilstm.multi_bilstm_sequence = saves_nothing(
        multi_bilstm.multi_bilstm_sequence_reference, None)
    lstm.lstm_sequence = saves_nothing(lstm.lstm_sequence_reference, 3)
    try:
        yield
    finally:
        (bilstm.bilstm_sequence, bilstm.bilstm_sequence_fused,
         multi_bilstm.multi_bilstm_sequence, lstm.lstm_sequence,
         pitch.viterbi_decode) = saved


@contextlib.contextmanager
def plain_training_kernels():
    """The training kernels' wrappers replaced by their plain versions,
    so that the ``autograd.Function``s run the plain versions on CUDA
    tensors: the same residual dtype, rounding and dW contraction as on
    the kernels (``plain_kernels`` instead takes autograd through the
    plain loops, which saves nothing and is float32)."""
    from speechsplit_tpu_torch.ops import bilstm, lstm, multi_bilstm

    swaps = ((bilstm, "bilstm_forward_cuda", "bilstm_forward_reference"),
             (bilstm, "bilstm_backward_cuda", "bilstm_backward_reference"),
             (bilstm, "bilstm_fused_forward_cuda",
              "bilstm_fused_forward_reference"),
             (multi_bilstm, "multi_bilstm_forward_cuda",
              "multi_bilstm_forward_reference"),
             (multi_bilstm, "multi_bilstm_backward_cuda",
              "multi_bilstm_backward_reference"),
             (lstm, "lstm_forward_cuda", "lstm_direction_forward_reference"),
             (lstm, "lstm_backward_cuda",
              "lstm_direction_backward_reference"))
    saved = [(module, name, getattr(module, name))
             for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, getattr(module, plain))
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


@contextlib.contextmanager
def fusion(mode: str):
    """``ops.bilstm.PROJ_FUSION`` set to ``mode`` for the block."""
    from speechsplit_tpu_torch.ops import bilstm

    saved = bilstm.PROJ_FUSION
    bilstm.PROJ_FUSION = mode
    try:
        yield
    finally:
        bilstm.PROJ_FUSION = saved


@contextlib.contextmanager
def route(name: str):
    """The BiLSTM layers' route for the block: "default" (merged,
    composed), "fused" (merged, ``PROJ_FUSION="auto"``) or "single"
    (``ops.bilstm.merged_bidir_fits`` false, as for a batch the merged
    kernels cannot hold: one ``ops.lstm.lstm_sequence`` a direction)."""
    from speechsplit_tpu_torch.ops import bilstm

    saved = bilstm.merged_bidir_fits
    if name == "single":
        bilstm.merged_bidir_fits = lambda *args, **kwargs: False
    try:
        with fusion("auto" if name == "fused" else "off"):
            yield
    finally:
        bilstm.merged_bidir_fits = saved


def lstm_bound(t: int, b: int, hs, kind: str = "infer",
               i: int = 0, resid_bytes: int = 4,
               stream_bytes: int = 4, xp_bytes: int = 4,
               w_bytes=4, proj_bytes: int = 4) -> tuple[float, str]:
    """Least time for BiLSTM recurrences of widths ``hs`` (one entry per
    direction): max(flops/peak, bytes/peak). Each input read once, each
    output written once, in float32 words of a (t, b) row:
    ``infer`` reads xp (4H) and writes h (H); ``fwd`` also writes g (4H)
    and c (H); ``bwd`` reads dh (H), g (4H), c (H) and writes dx (4H).
    ``resid_bytes`` (2: bfloat16) is the size of a g and c element,
    ``stream_bytes`` of a dh and dx one, ``xp_bytes`` of an xp one and
    ``w_bytes`` of a W_hh one (a list: one a direction; bfloat16
    compute). All read W_hh (4H x H) once. Flops: the step product
    2*4H*H and the cell's elementwise work (about 10H forward, 16H
    backward). The product of a bfloat16 W_hh (2 bytes) is bfloat16
    operands with float32 sums, which the card runs on its tensor cores:
    those flops go at ``PEAK_BF16_FLOPS``, the rest at ``PEAK_F32_FLOPS``,
    and the two units run side by side, so the operations take the
    larger of the two times. With an input width ``i`` the projection is
    inside (the fused kernels): in place of xp, x [t, b, i] is read once
    for both directions and each direction reads W_ih (4H x i) and its
    float32 bias, and does 2*i*4H flops a row; ``proj_bytes`` is the size
    of an x and a W_ih element (2: bfloat16 compute, whose projection
    products go at ``PEAK_BF16_FLOPS`` like a bfloat16 W_hh's)."""
    cell = 16 if kind == "bwd" else 10
    flops = tc_flops = 0.0
    nbytes = float(proj_bytes) * t * b * i
    w_sizes = w_bytes if isinstance(w_bytes, (list, tuple)) else [
        w_bytes] * len(hs)
    for h, w_size in zip(hs, w_sizes):
        product = t * b * 2 * h * 4 * h
        if w_size == 2:
            tc_flops += product
        else:
            flops += product
        if proj_bytes == 2:
            tc_flops += t * b * 2 * i * 4 * h
        else:
            flops += t * b * 2 * i * 4 * h
        flops += t * b * cell * h
        # bytes of a (t, b) row: x replaces xp when fused
        row = {"infer": xp_bytes * 4 * h + 4 * h,
               "fwd": xp_bytes * 4 * h + 4 * h + resid_bytes * 5 * h,
               "bwd": resid_bytes * 5 * h + stream_bytes * 5 * h}[kind]
        row -= xp_bytes * 4 * h if i else 0
        w_ih = proj_bytes * 4 * h * i + 4 * 4 * h if i else 0
        nbytes += t * b * row + w_size * 4 * h * h + w_ih
    by_ops = max(flops / PEAK_F32_FLOPS, tc_flops / PEAK_BF16_FLOPS) * 1e3
    by_bytes = nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (
        by_bytes, "bytes")


def cudnn_yardstick(xp_f, xp_b, w_f, w_b):
    """A bidirectional cuDNN LSTM computing the same (h_f, h_b) from the
    same xp: input [xp_f | xp_b] through identity/zero input weights."""
    import torch

    t_len, batch, four_h = xp_f.shape
    h = four_h // 4
    lstm = torch.nn.LSTM(2 * four_h, h, bidirectional=True).to(xp_f.device)
    eye = torch.eye(four_h, device=xp_f.device)
    zero = torch.zeros_like(eye)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([eye, zero], 1))
        lstm.weight_ih_l0_reverse.copy_(torch.cat([zero, eye], 1))
        lstm.weight_hh_l0.copy_(w_f)
        lstm.weight_hh_l0_reverse.copy_(w_b)
        for name in ("bias_ih_l0", "bias_hh_l0", "bias_ih_l0_reverse",
                     "bias_hh_l0_reverse"):
            getattr(lstm, name).zero_()
    x = torch.cat([xp_f, xp_b], -1).contiguous()
    return lstm, x


def reset_launches() -> None:
    from speechsplit_tpu_torch.ops import (
        bilstm,
        filters,
        lstm,
        multi_bilstm,
        pitch,
    )

    for counts in (bilstm.LAUNCHES, multi_bilstm.LAUNCHES, lstm.LAUNCHES,
                   pitch.LAUNCHES, filters.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    from speechsplit_tpu_torch.ops import (
        bilstm,
        filters,
        lstm,
        multi_bilstm,
        pitch,
    )

    return {**bilstm.LAUNCHES, **multi_bilstm.LAUNCHES, **lstm.LAUNCHES,
            **pitch.LAUNCHES, **filters.LAUNCHES}


def phase_build() -> float:
    from speechsplit_tpu_torch.ops import _build

    seconds = _build.build_all()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for stem in sources:
        _build.load(stem)
    log("build", sources=",".join(f"{s}.cu" for s in sources),
        kernels=",".join([*KERNELS, *IIR_KERNELS]), seconds=f"{seconds:.2f}",
        arch="sm_90a")
    return seconds


def merged_inputs(t: int, b: int, h: int, seed: int):
    """Seeded inputs of a merged BiLSTM layer on the card: xp_f, xp_b
    [t, b, 4h] and w_f, w_b [4h, h]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    return (rand(t, b, 4 * h), rand(t, b, 4 * h),
            rand(4 * h, h, scale=h ** -0.5), rand(4 * h, h, scale=h ** -0.5))


def check_bilstm(b: int, h: int, reps: int) -> dict:
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    xp_f, xp_b, w_f, w_b = merged_inputs(T, b, h, SEED + h + b)
    got = bilstm.bilstm_sequence(xp_f, xp_b, w_f, w_b)
    want = bilstm.bilstm_sequence_reference(xp_f, xp_b, w_f, w_b)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    lstm, x = cudnn_yardstick(xp_f, xp_b, w_f, w_b)
    with torch.no_grad():
        lib_out = lstm(x)[0]
        lib_err = float((lib_out - torch.cat(got, -1)).abs().max())
        library_ms = time_ms(lambda: lstm(x), reps)
    ms = time_ms(lambda: bilstm.bilstm_sequence(xp_f, xp_b, w_f, w_b), reps)
    plain_ms = time_ms(
        lambda: bilstm.bilstm_sequence_reference(xp_f, xp_b, w_f, w_b), 2,
        warmup=1)
    bound_ms, bound_by = lstm_bound(T, b, [h, h])
    row = dict(shape=f"T{T}xB{b}xH{h}", max_abs_err=err, tol=KERNEL_TOL, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, library_err=lib_err)
    # the earlier time goes in the log line only: the returned row holds
    # this run's measurements and bound
    before = ({"ms_before_residual_flag": LEAN_B28_H512_MS_BEFORE}
              if (b, h) == (28, 512) else {})
    log("kernel bilstm_infer", **fmt(row), **before)
    if not err <= KERNEL_TOL:
        fail(f"bilstm_infer {row['shape']}: max abs err {err} > {KERNEL_TOL}")
    return row


def multi_inputs(t: int, b: int, hs, seed: int):
    """Seeded inputs of the multi-stream op on the card, one stream a
    width: the 2n xp [t, b, 4h] and the 2n w [4h, h]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    xps, ws = [], []
    for h in hs:
        for _ in range(2):
            xps.append(torch.randn(t, b, 4 * h, device="cuda", generator=gen))
            ws.append(torch.randn(4 * h, h, device="cuda", generator=gen)
                      * h ** -0.5)
    return xps, ws


def check_multi(b: int, hs, reps: int) -> dict:
    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    xps, ws = multi_inputs(T, b, hs, SEED + 7 * b)
    n = len(hs)
    got = multi_bilstm.multi_bilstm_sequence(n, *xps, *ws)
    want = multi_bilstm.multi_bilstm_sequence_reference(n, *xps, *ws)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ms = time_ms(lambda: multi_bilstm.multi_bilstm_sequence(n, *xps, *ws),
                 reps)
    device_ms = kernel_device_ms(
        lambda: multi_bilstm.multi_bilstm_sequence(n, *xps, *ws), reps)
    plain_ms = time_ms(lambda: multi_bilstm.multi_bilstm_sequence_reference(
        n, *xps, *ws), 2, warmup=1)
    # yardstick only (no single library call runs n LSTMs of mixed
    # widths): one cuDNN call per stream, summed
    cudnn_ms = 0.0
    for s in range(n):
        lstm, x = cudnn_yardstick(xps[2 * s], xps[2 * s + 1], ws[2 * s],
                                  ws[2 * s + 1])
        with torch.no_grad():
            cudnn_ms += time_ms(lambda: lstm(x), reps)
    bound_ms, bound_by = lstm_bound(T, b, [h for h in hs for _ in (0, 1)])
    row = dict(shape=f"T{T}xB{b}xH{'/'.join(map(str, hs))}",
               max_abs_err=err, tol=KERNEL_TOL, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None, cudnn_per_stream_sum_ms=cudnn_ms)
    log("kernel multi_bilstm_infer", **fmt(row))
    if not err <= KERNEL_TOL:
        fail(f"multi_bilstm_infer {row['shape']}: max abs err {err}")
    return row


def check_edges() -> None:
    """The kernels' other code paths against their plain versions, on
    short sequences: batch 1 and ragged batch chunks, the batch-tiled
    h staging (B*H floats beyond the shared-memory budget), widths that
    are not a multiple of 4 (scalar staging) or of 32, H=1, and mixed
    multi-stream widths up to the kernel's limit with ragged tiles."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm, multi_bilstm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 99)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    worst = 0.0
    for t, b, h in ((37, 1, 512), (9, 100, 512), (23, 5, 3), (16, 3, 1),
                    (12, 6, 100)):
        xp_f, xp_b = rand(t, b, 4 * h), rand(t, b, 4 * h)
        w_f, w_b = rand(4 * h, h) * h ** -0.5, rand(4 * h, h) * h ** -0.5
        got = bilstm.bilstm_sequence(xp_f, xp_b, w_f, w_b)
        want = bilstm.bilstm_sequence_reference(xp_f, xp_b, w_f, w_b)
        err = max(float((g - r).abs().max()) for g, r in zip(got, want))
        if not err <= KERNEL_TOL:
            fail(f"bilstm_infer T{t}xB{b}xH{h}: max abs err {err}")
        worst = max(worst, err)
    log("kernel edges", shapes=5, max_abs_err=f"{worst:.3g}", tol=KERNEL_TOL)


# (T, B, widths) of the multi-stream forwards' edges: each width alone
# (the lane plan's L = 1, 2, 8, 16, 32, with units past H at 5, 9 and 31;
# the block plan's 33 and 64), mixed widths up to 8 directions (a call
# with a width past 32 runs the block plan for all of them), B = 1, 3 and
# 33 (lane groups holding rows past the batch, a second block of the
# lane plan at L = 8) and T = 1
MULTI_EDGES = tuple((7, 3, (h,)) for h in (1, 2, 5, 8, 9, 16, 31, 32, 33,
                                           64)) + (
    (9, 33, (1, 2, 5, 8)), (5, 1, (9, 16, 31, 32)), (6, 3, (33, 64, 8, 1)),
    (1, 33, (32, 8, 1)), (1, 1, (64, 1)), (11, 13, (64, 3, 1)),
    (7, 1, (32, 8, 5, 1)))


def check_multi_edges() -> None:
    """Both multi-stream forwards (lean and residual-saving) at
    ``MULTI_EDGES`` against their plain versions, and the gradient kernel
    run on the residual-saving kernel's own g and c against the plain
    gradient on the plain version's: the check that the forward writes
    the layout ``csrc/multi_bilstm_bwd.cu`` reads."""
    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    worst = {"lean": 0.0, "fwd": 0.0, "bwd_rel": 0.0}
    for t, b, hs in MULTI_EDGES:
        xps, ws = multi_inputs(t, b, hs, SEED + 13 * t + b)
        n, d2 = len(hs), 2 * len(hs)
        want = multi_bilstm.multi_bilstm_forward_reference(n, *xps, *ws)
        lean = multi_bilstm.multi_bilstm_infer_cuda(n, *xps, *ws)
        fwd = multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws)
        dhs = [torch.randn_like(h) for h in want[:d2]]
        dx = multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *fwd[d2:], *ws)
        dx_ref = multi_bilstm.multi_bilstm_backward_reference(
            n, *dhs, *want[d2:], *ws)
        torch.cuda.synchronize()
        errs = {"lean": abs_err(lean, want[:d2]), "fwd": abs_err(fwd, want),
                "bwd_rel": rel_err(dx, dx_ref)}
        for name, err in errs.items():
            if not err <= KERNEL_TOL:
                fail(f"multi_bilstm {name} T{t}xB{b}xH{hs}: error {err} > "
                     f"{KERNEL_TOL}")
            worst[name] = max(worst[name], err)
    log("kernel multi edges", shapes=len(MULTI_EDGES),
        widths="1,2,5,8,9,16,31,32,33,64", batches="1,3,13,33", t_min=1,
        max_dirs=8, max_abs_err_lean=f"{worst['lean']:.3g}",
        max_abs_err_fwd=f"{worst['fwd']:.3g}",
        bwd_on_kernel_residuals_rel_err=f"{worst['bwd_rel']:.3g}",
        tol=KERNEL_TOL)


# (T, B, H, splits) of the merged forwards' edges: T=1, B=1, rounds of 8
# rows left ragged (9, 28), widths not a multiple of 4 (4-byte copies),
# a partial 128-wide pass (129, 200), one block a direction (H <= 8),
# batch tiles (B100 at H512, B300 at H256), and each plan at H=256
MERGED_EDGES = ((1, 28, 512, 0), (5, 1, 512, 0), (7, 9, 512, 0),
                (6, 28, 8, 0), (5, 9, 3, 0), (4, 13, 6, 0), (5, 28, 100, 0),
                (4, 9, 129, 0), (4, 28, 200, 0), (4, 100, 512, 0),
                (3, 300, 256, 0), (3, 731, 256, 1), (3, 731, 256, 2))


def check_merged_forward_edges() -> None:
    """``bilstm_infer`` and ``bilstm_fwd`` against their plain versions
    on the code paths the kernel treats specially (``MERGED_EDGES``; the
    residual-saving forward in the source's plan), then at the batch
    limit of each at H 512, 256 and 8 (``ops.bilstm.forward_max_batch``,
    from the source's plan); one row more is refused by the kernel."""
    from speechsplit_tpu_torch.ops import bilstm

    worst = 0.0
    for t, b, h, splits in MERGED_EDGES:
        args = merged_inputs(t, b, h, SEED + 41 * h + b)
        want = bilstm.bilstm_forward_reference(*args)
        err = max(abs_err(bilstm._bilstm_infer_plan(*args, splits),
                          want[:2]),
                  abs_err(bilstm.bilstm_forward_cuda(*args), want))
        if not err <= KERNEL_TOL:
            fail(f"merged forward T{t}xB{b}xH{h} splits {splits}: max abs "
                 f"err {err}")
        worst = max(worst, err)
    limits = {}
    for h in (512, 256, 8):
        for resid, run in ((False, bilstm.bilstm_infer_cuda),
                           (True, bilstm.bilstm_forward_cuda)):
            limit = bilstm.forward_max_batch(h, resid)
            args = merged_inputs(2, limit, h, SEED + h)
            want = bilstm.bilstm_forward_reference(*args)
            err = abs_err(run(*args), want if resid else want[:2])
            if not err <= KERNEL_TOL:
                fail(f"merged forward at its limit B{limit} H{h}: max abs "
                     f"err {err}")
            worst = max(worst, err)
            past = merged_inputs(1, limit + 1, h, SEED)
            try:
                run(*past)
            except RuntimeError:
                pass
            else:
                fail(f"merged forward took B={limit + 1} at H={h}, past its "
                     "limit")
            limits[f"{'fwd' if resid else 'infer'}_h{h}"] = limit
            del args, want, past
    log("kernel merged forward edges", shapes=len(MERGED_EDGES),
        max_abs_err=f"{worst:.3g}", tol=KERNEL_TOL, **limits)


def check_infer_plans(h: int, batches, reps: int) -> list:
    """``bilstm_infer`` at width h in each plan, one warp a unit (2 x 32
    blocks at H=256) or two (2 x 64), against the plain version and
    timed, at each batch: the measurement behind ``kSplitMaxH``."""
    from speechsplit_tpu_torch.ops import bilstm

    rows = []
    for b in batches:
        args = merged_inputs(T, b, h, SEED + 43 * b)
        want = bilstm.bilstm_sequence_reference(*args)
        row = dict(shape=f"T{T}xB{b}xH{h}")
        err = 0.0
        for splits in (1, 2):
            def run():
                return bilstm._bilstm_infer_plan(*args, splits)

            err = max(err, abs_err(run(), want))
            row[f"splits{splits}_ms"] = time_ms(run, reps, warmup=1)
        row.update(max_abs_err=err, tol=KERNEL_TOL)
        log("kernel bilstm_infer plans", **fmt(row))
        if not err <= KERNEL_TOL:
            fail(f"bilstm_infer plans {row['shape']}: max abs err {err}")
        rows.append(row)
        del args, want
    return rows


def multi_infer_shapes():
    """(batch, widths) of multi_bilstm_infer on the main path: the 4-pair
    call's generator (B28) and F0 converter (B4), then the large call's
    (phase 13: 7 x 731 = 5117 and 731 rows)."""
    pairs = refused_pairs()
    return ((28, (8, 32, 1)), (4, (32, 1)), (7 * pairs, (8, 32, 1)),
            (pairs, (32, 1)))


def phase_kernels(reps: int = 20) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns the row of each kernel's most expensive main-path shape."""
    with strict_float32():
        check_edges()
        check_merged_forward_edges()
        rows = {
            "bilstm_infer": [check_bilstm(28, 512, reps),
                             check_bilstm(4, 256, reps),
                             check_bilstm(28, 8, reps),
                             check_bilstm(refused_pairs(), 256, reps)],
            "multi_bilstm_infer": [
                check_multi(b, hs, reps) for b, hs in multi_infer_shapes()],
        }
        rows["bilstm_infer"][0]["plans_h256"] = check_infer_plans(
            256, (4, TRAIN_B, refused_pairs()), reps)
        check_multi_edges()
        multi = rows["multi_bilstm_infer"]
        multi[0]["beside"] = [
            {k: r[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                               "bound_ms")}
            for r in multi[1:]]
        # the block plan at the widest widths the kernel takes
        wide = check_multi(13, (64, 3, 1), reps)
        multi[0]["block_plan_edge"] = {
            k: wide[k] for k in ("shape", "ms", "device_ms", "bound_ms")}
    return {name: r[0] for name, r in rows.items()}


def synthetic_pairs(config, n_pairs: int, device, seed: int):
    import numpy as np

    from speechsplit_tpu_torch.convert import prepare_utterance

    rng = np.random.RandomState(seed)
    pairs = []
    for p in range(n_pairs):
        utts = []
        for side in ("s", "t"):
            length = int(rng.randint(120, config.max_len_pad + 1))
            mel = rng.rand(length, config.dim_freq).astype(np.float32)
            f0 = np.where(rng.rand(length) < 0.2, 0.0,
                          rng.rand(length)).astype(np.float32)
            emb = np.zeros(config.dim_spk_emb, np.float32)
            emb[rng.randint(config.dim_spk_emb)] = 1.0
            utts.append(prepare_utterance(config, mel, f0, emb,
                                          name=f"spk{side}{p}", uid=f"u{p}",
                                          device=device))
        pairs.append(tuple(utts))
    return pairs


def phase_convert(n_pairs: int = 4, reps: int = 20):
    import numpy as np
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import (
        CONDITIONS,
        convert,
        convert_batched,
    )
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    config = SpeechSplitConfig()
    gen = torch.Generator().manual_seed(SEED)
    g_model = SpeechSplit(config, generator=gen).to("cuda").eval()
    p_model = F0Converter(config, generator=gen).to("cuda").eval()
    pairs = synthetic_pairs(config, n_pairs, "cuda", SEED)

    def run():
        return convert_batched(g_model, p_model, pairs, CONDITIONS)

    run()  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    reset_launches()
    result = run()
    counts = read_launches()
    launches = {name: counts[name]
                for name in ("bilstm_infer", "multi_bilstm_infer")}
    for name, count in launches.items():
        if count < 1:
            fail(f"convert_batched did not launch {name}")
    for name in TRAINING_KERNELS + FUSED_KERNELS + LSTM_KERNELS:
        if counts[name]:
            fail(f"convert_batched at {n_pairs} pairs launched {name}")
    check_conversions(config, pairs, result)

    with strict_float32():
        exact = run()
        with plain_kernels():
            plain = run()
        # the per-utterance driver runs the kernels at batch 1
        single = convert(g_model, p_model, *pairs[0], CONDITIONS)
    err = max(float(np.abs(a[1] - b[1]).max())
              for ra, rb in zip(exact, plain) for a, b in zip(ra, rb))
    if not err <= PATH_TOL:
        fail(f"convert_batched kernels vs plain: max abs err {err}")
    err_single = max(float(np.abs(a[1] - b[1]).max())
                     for a, b in zip(single, exact[0]))
    if not err_single <= PATH_TOL:
        fail(f"convert (batch 1) vs convert_batched: max abs err {err_single}")

    # timed at the precision that was compared: float32, TF32 off
    samples = []
    with strict_float32("timing"):
        for _ in range(reps):
            torch.cuda.synchronize()
            start = time.perf_counter()
            run()  # ends in the device->host fetch of the results
            samples.append((time.perf_counter() - start) * 1e3)
    q1, ms, q3 = np.percentile(samples, [25, 50, 75])
    utts = n_pairs * len(CONDITIONS)
    log("convert_batched", pairs=n_pairs, conditions=len(CONDITIONS),
        generator_batch=utts, calls=reps, median_ms_per_call=f"{ms:.4f}",
        q1_ms=f"{q1:.4f}", q3_ms=f"{q3:.4f}",
        utterances_per_s_at_median=f"{utts / ms * 1e3:.2f}",
        max_abs_err_vs_plain=f"{err:.3g}", tol=PATH_TOL,
        max_abs_err_batch1_vs_batched=f"{err_single:.3g}",
        tf32="off for the comparisons and the timing",
        launches=json.dumps(launches).replace(" ", ""))
    return launches, g_model, p_model, pairs


def check_conversions(config, pairs, result) -> None:
    """7 finite mels per pair, each cut to its condition's length."""
    import numpy as np

    if len(result) != len(pairs) or any(len(r) != 7 for r in result):
        fail("convert_batched: expected 7 results per pair")
    for (src, trg), res in zip(pairs, result):
        for name, mel in res:
            cut = trg.length if "R" in name.rsplit("_", 1)[1] else src.length
            if mel.shape != (cut, config.dim_freq):
                fail(f"{name}: shape {mel.shape}, expected "
                     f"{(cut, config.dim_freq)}")
            if not np.isfinite(mel).all():
                fail(f"{name}: non-finite values")


def phase_profile(g_model, p_model, pairs, top: int = 8) -> None:
    """Where one convert_batched call spends device time (torch.profiler):
    the busiest device ops, and the device's busy share of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        convert_batched(g_model, p_model, pairs, CONDITIONS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

    profile_events("profile", prof, wall_ms, top)


def device_us(event) -> float:
    """A profiler event's own device time, µs."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def kernel_device_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` with the card kept fed: the
    ``reps`` calls are queued behind a spin kernel (``torch.cuda._sleep``)
    and run back to back, so the time does not count the gaps in which
    the card waits for a wrapper's host work (``time_ms`` counts them).
    Fails if the card reached the calls before the last was queued."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    host = time.perf_counter()
    for _ in range(reps):
        fn()
    stop.record()
    host = time.perf_counter() - host
    queued = not start.query()  # the card is still in the spin kernel
    torch.cuda.synchronize()
    if not queued:
        fail(f"kernel_device_ms: the spin kernel ended before the calls "
             f"were queued ({host * 1e3:.3f} ms on the host for {reps} "
             f"calls)")
    return start.elapsed_time(stop) / reps


def profiled_busy_us(fn, reps: int) -> float:
    """The device time, µs, of every kernel and copy of ``reps`` calls of
    ``fn`` under ``torch.profiler`` (0 where it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(device_us(e) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False))


# the windows profiled_device_ms takes the largest of: torch.profiler at
# times loses a window's kernel records, wholly or in part, so a window
# only ever reads low (ROADMAP.md C; tools/profiler_windows.py)
PROFILED_WINDOWS = 5


def profiled_device_ms(fn, reps: int) -> tuple:
    """Mean device time of one call of ``fn`` and how it was taken: the
    largest over ``PROFILED_WINDOWS`` windows of ``profiled_busy_us``, over
    ``reps``, for a call that synchronises (cuDNN's training forward does),
    which ``kernel_device_ms`` cannot queue behind its spin kernel. Where
    every window saw no device time, CUDA events over the calls
    (``time_ms``: the card's gaps inside a synchronising call count)."""
    busy = [profiled_busy_us(fn, reps) for _ in range(PROFILED_WINDOWS)]
    seen = [b for b in busy if b > 0]
    empty = len(busy) - len(seen)
    if seen:
        return (max(seen) / 1e3 / reps,
                f"profiler ({empty} of {len(busy)} windows empty)")
    return (time_ms(fn, reps),
            f"events (the profiler saw no device time in {empty} windows)")


def profile_events(phase: str, prof, wall_ms: float, top: int) -> None:
    """The card's busy and idle share of a profiled window, and its
    busiest device ops."""

    # device-side kernel and memcpy records only (CPU ops also carry the
    # device time of the kernels they launch, and a user annotation on
    # the device, such as the optimizer's step, spans kernels listed on
    # their own: either would count twice)
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)
              and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    if not events:
        log(phase, device_time="not measured (no device events)")
        return
    log(phase, wall_ms=f"{wall_ms:.4f}", device_busy_ms=f"{busy_ms:.4f}",
        device_idle_share=f"{max(0.0, 1 - busy_ms / wall_ms):.4f}",
        note="profiler on; wall includes its overhead")
    for e in sorted(events, key=device_us, reverse=True)[:top]:
        log(f"{phase} op", name=e.key.replace(" ", "_")[:60],
            calls=e.count, device_ms=f"{device_us(e) / 1e3:.4f}")


def phase_cli(g_model, p_model) -> None:
    import numpy as np
    import torch
    from scipy.io import wavfile

    from speechsplit_tpu_torch.cli import convert as cli_convert
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.interop import save_reference_checkpoint

    config = SpeechSplitConfig()
    rng = np.random.RandomState(SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        g_path = os.path.join(tmp, "G.ckpt")
        p_path = os.path.join(tmp, "P.ckpt")
        save_reference_checkpoint(g_model, g_path)
        save_reference_checkpoint(p_model, p_path)
        entries = []
        for i, length in enumerate((150, 170)):
            emb = np.zeros((1, config.dim_spk_emb), np.float32)
            emb[0, 3 + i] = 1.0
            mel = rng.rand(length, config.dim_freq).astype(np.float32)
            f0 = rng.rand(length).astype(np.float32)
            entries.append([f"p{225 + i}", emb, (mel, f0, length, f"{i:03d}")])
        meta = os.path.join(tmp, "demo.pkl")
        with open(meta, "wb") as handle:
            pickle.dump(entries, handle)
        out_dir = os.path.join(tmp, "out")
        start = time.perf_counter()
        cli_convert.main([
            "--generator_ckpt", g_path, "--f0_ckpt", p_path,
            "--metadata", meta, "--out_dir", out_dir, "--device", "cuda",
            "--synthesize",
        ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        written = sorted(os.listdir(out_dir))
        mels = [w for w in written if w.endswith(".npy")]
        wavs = [w for w in written if w.endswith(".wav")]
        if len(mels) != 7 or len(wavs) != 7 or len(written) != 14:
            fail(f"cli.convert wrote {written}")
        for w in mels:
            mel = np.load(os.path.join(out_dir, w))
            if mel.ndim != 2 or not np.isfinite(mel).all():
                fail(f"cli.convert: bad mel in {w}")
            _, wav = wavfile.read(os.path.join(out_dir, w[:-4] + ".wav"))
            if wav.dtype != np.int16 or len(wav) != (len(mel) - 1) * 256:
                fail(f"cli.convert: bad wav beside {w}")
    log("cli.convert", files=len(written), seconds=f"{seconds:.2f}",
        synthesize=True)


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over matching tensors."""
    num = max(float((g - w).abs().max()) for g, w in zip(got, want))
    den = max(float(w.abs().max()) for w in want)
    return num / max(den, 1e-30)


def abs_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def cudnn_train_ms(xp_f, xp_b, w_f, w_b, dh_f, dh_b, reps: int):
    """cuDNN's training forward and its backward (one
    ``torch.autograd.grad`` call) of the bidirectional LSTM that
    computes (h_f, h_b) from [xp_f | xp_b] (see ``cudnn_yardstick``).
    Its backward also forms dW_hh and dW_ih and the input's cotangent."""
    import torch

    lstm, x = cudnn_yardstick(xp_f, xp_b, w_f, w_b)
    x.requires_grad_(True)
    dout = torch.cat([dh_f, dh_b], -1)
    fwd_ms = time_ms(lambda: lstm(x), reps)
    out = lstm(x)[0]
    wrt = (x, lstm.weight_hh_l0, lstm.weight_hh_l0_reverse)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, wrt, dout,
                                                 retain_graph=True), reps)
    return fwd_ms, bwd_ms


def check_bilstm_train(b: int, h: int, reps: int) -> dict:
    """The residual-saving forward and the gradient kernel of
    ``ops.bilstm`` against their plain versions on the same inputs (the
    gradient kernel gets the plain forward's residuals)."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3 * h + b)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    xp_f, xp_b = rand(T, b, 4 * h), rand(T, b, 4 * h)
    w_f, w_b = rand(4 * h, h, scale=h ** -0.5), rand(4 * h, h, scale=h ** -0.5)
    dh_f, dh_b = rand(T, b, h), rand(T, b, h)
    got = bilstm.bilstm_forward_cuda(xp_f, xp_b, w_f, w_b)
    want = bilstm.bilstm_forward_reference(xp_f, xp_b, w_f, w_b)
    res = want[2:6]
    dx = bilstm.bilstm_backward_cuda(dh_f, dh_b, *res, w_f, w_b)
    dx_ref = bilstm.bilstm_backward_reference(dh_f, dh_b, *res, w_f, w_b)
    torch.cuda.synchronize()
    errs = dict(err_h=abs_err(got[:2], want[:2]),
                err_g=abs_err(got[2:4], want[2:4]),
                err_c=abs_err(got[4:], want[4:]),
                err_dx_rel=rel_err(dx, dx_ref), err_dx=abs_err(dx, dx_ref))
    fwd_ms = time_ms(lambda: bilstm.bilstm_forward_cuda(xp_f, xp_b, w_f, w_b),
                     reps)
    bwd_ms = time_ms(lambda: bilstm.bilstm_backward_cuda(
        dh_f, dh_b, *res, w_f, w_b), reps)
    infer_ms = time_ms(lambda: bilstm.bilstm_infer_cuda(xp_f, xp_b, w_f, w_b),
                       reps)
    plain_fwd_ms = time_ms(lambda: bilstm.bilstm_forward_reference(
        xp_f, xp_b, w_f, w_b), 2, warmup=1)
    plain_bwd_ms = time_ms(lambda: bilstm.bilstm_backward_reference(
        dh_f, dh_b, *res, w_f, w_b), 2, warmup=1)
    lib_fwd_ms, lib_bwd_ms = cudnn_train_ms(xp_f, xp_b, w_f, w_b, dh_f, dh_b,
                                            reps)
    fwd_bound, fwd_by = lstm_bound(T, b, [h, h], "fwd")
    bwd_bound, bwd_by = lstm_bound(T, b, [h, h], "bwd")
    shape = f"T{T}xB{b}xH{h}"
    fwd = dict(shape=shape, max_abs_err=max(errs["err_h"], errs["err_g"],
                                            errs["err_c"]),
               tol=KERNEL_TOL, ms=fwd_ms, plain_ms=plain_fwd_ms,
               bound_ms=fwd_bound, bound_by=fwd_by, library_ms=lib_fwd_ms,
               lean_ms=infer_ms)
    bwd = dict(shape=shape, max_abs_err=errs["err_dx"],
               rel_err=errs["err_dx_rel"], tol=KERNEL_TOL, ms=bwd_ms,
               plain_ms=plain_bwd_ms, bound_ms=bwd_bound, bound_by=bwd_by,
               library_ms=lib_bwd_ms, library_fwd_plus_bwd_ms=(
                   lib_fwd_ms + lib_bwd_ms))
    log("kernel bilstm_fwd", **fmt({**fwd, **{k: errs[k] for k in (
        "err_h", "err_g", "err_c")}}))
    log("kernel bilstm_bwd", **fmt(bwd))
    for name in ("err_h", "err_g", "err_c", "err_dx_rel"):
        if not errs[name] <= KERNEL_TOL:
            fail(f"bilstm training kernels {shape}: {name} {errs[name]} > "
                 f"{KERNEL_TOL}")
    return {"bilstm_fwd": fwd, "bilstm_bwd": bwd}


def check_multi_train(b: int, hs, reps: int) -> dict:
    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11 * b + len(hs))
    xps, ws, dhs = [], [], []
    for h in hs:
        for _ in range(2):
            xps.append(torch.randn(T, b, 4 * h, device="cuda", generator=gen))
            ws.append(torch.randn(4 * h, h, device="cuda", generator=gen)
                      * h ** -0.5)
            dhs.append(torch.randn(T, b, h, device="cuda", generator=gen))
    n, d2 = len(hs), 2 * len(hs)
    got = multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws)
    want = multi_bilstm.multi_bilstm_forward_reference(n, *xps, *ws)
    res = want[d2:]
    dx = multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *res, *ws)
    dx_ref = multi_bilstm.multi_bilstm_backward_reference(n, *dhs, *res, *ws)
    # the gradient kernel on the residual-saving kernel's own g and c
    dx_own = multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *got[d2:], *ws)
    torch.cuda.synchronize()
    errs = dict(err_h=abs_err(got[:d2], want[:d2]),
                err_g=abs_err(got[d2:2 * d2], want[d2:2 * d2]),
                err_c=abs_err(got[2 * d2:], want[2 * d2:]),
                err_dx_rel=rel_err(dx, dx_ref), err_dx=abs_err(dx, dx_ref),
                err_dx_own_res_rel=rel_err(dx_own, dx_ref))
    fwd_ms = time_ms(lambda: multi_bilstm.multi_bilstm_forward_cuda(
        n, *xps, *ws), reps)
    bwd_ms = time_ms(lambda: multi_bilstm.multi_bilstm_backward_cuda(
        n, *dhs, *res, *ws), reps)
    fwd_device_ms = kernel_device_ms(
        lambda: multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws), reps)
    bwd_device_ms = kernel_device_ms(
        lambda: multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *res, *ws),
        reps)
    plain_fwd_ms = time_ms(lambda: multi_bilstm.multi_bilstm_forward_reference(
        n, *xps, *ws), 2, warmup=1)
    plain_bwd_ms = time_ms(lambda: multi_bilstm.multi_bilstm_backward_reference(
        n, *dhs, *res, *ws), 2, warmup=1)
    # yardstick only (no single library call runs n LSTMs of mixed
    # widths): cuDNN per stream, summed
    lib_fwd = lib_bwd = 0.0
    for s in range(n):
        f_ms, b_ms = cudnn_train_ms(xps[2 * s], xps[2 * s + 1], ws[2 * s],
                                    ws[2 * s + 1], dhs[2 * s], dhs[2 * s + 1],
                                    reps)
        lib_fwd += f_ms
        lib_bwd += b_ms
    dirs = [h for h in hs for _ in (0, 1)]
    fwd_bound, fwd_by = lstm_bound(T, b, dirs, "fwd")
    bwd_bound, bwd_by = lstm_bound(T, b, dirs, "bwd")
    shape = f"T{T}xB{b}xH{'/'.join(map(str, hs))}"
    fwd = dict(shape=shape, max_abs_err=max(errs["err_h"], errs["err_g"],
                                            errs["err_c"]),
               tol=KERNEL_TOL, ms=fwd_ms, device_ms=fwd_device_ms,
               plain_ms=plain_fwd_ms,
               bound_ms=fwd_bound, bound_by=fwd_by, library_ms=None,
               cudnn_per_stream_sum_ms=lib_fwd)
    bwd = dict(shape=shape, max_abs_err=errs["err_dx"],
               rel_err=errs["err_dx_rel"],
               rel_err_on_kernel_residuals=errs["err_dx_own_res_rel"],
               tol=KERNEL_TOL, ms=bwd_ms, device_ms=bwd_device_ms,
               plain_ms=plain_bwd_ms, bound_ms=bwd_bound, bound_by=bwd_by,
               library_ms=None, cudnn_per_stream_sum_ms=lib_bwd)
    log("kernel multi_bilstm_fwd", **fmt(fwd))
    log("kernel multi_bilstm_bwd", **fmt(bwd))
    for name in ("err_h", "err_g", "err_c", "err_dx_rel",
                 "err_dx_own_res_rel"):
        if not errs[name] <= KERNEL_TOL:
            fail(f"multi_bilstm training kernels {shape}: {name} "
                 f"{errs[name]} > {KERNEL_TOL}")
    return {"multi_bilstm_fwd": fwd, "multi_bilstm_bwd": bwd}


def check_functions() -> None:
    """Each op's autograd.Function on CUDA tensors against autograd
    through the plain time loop, same inputs and cotangents: the check
    that a forward under autograd reaches the training kernels and
    returns every gradient. Also the dispatch: no_grad takes the lean
    kernel, autograd a Function node. Shapes cover the batch-tiled
    gradient staging (B=40 at H=512), widths not a multiple of 32 and
    H=1."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm, multi_bilstm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def leaf(*shape, scale=1.0):
        x = torch.randn(*shape, device="cuda", generator=gen) * scale
        return x.requires_grad_(True)

    worst = 0.0
    cases = [("bilstm", (TRAIN_B, 512)), ("bilstm", (40, 512)),
             ("bilstm", (3, 100)), ("bilstm", (5, 1)),
             ("multi", (TRAIN_B, (8, 32, 1))), ("multi", (13, (64, 3)))]
    for op, (b, hs) in cases:
        t = T if b == TRAIN_B else 29
        widths = [hs] if op == "bilstm" else list(hs)
        xps = [leaf(t, b, 4 * h) for h in widths for _ in (0, 1)]
        ws = [leaf(4 * h, h, scale=h ** -0.5) for h in widths for _ in (0, 1)]
        dhs = [torch.randn(t, b, h, device="cuda", generator=gen)
               for h in widths for _ in (0, 1)]
        # float32 residuals: the Function's gradients are autograd's
        # through the float32 loop
        if op == "bilstm":
            run = lambda *a: bilstm.bilstm_sequence(  # noqa: E731
                *a, torch.float32)
            plain = bilstm.bilstm_sequence_reference
            node, lean = "BiLSTMFunction", "bilstm_infer"
        else:
            n = len(widths)
            run = lambda *a: multi_bilstm.multi_bilstm_sequence(  # noqa: E731
                n, *a, residual_dtype=torch.float32)
            plain = lambda *a: multi_bilstm.multi_bilstm_sequence_reference(  # noqa: E731
                n, *a)
            node, lean = "MultiBiLSTMFunction", "multi_bilstm_infer"
        inputs = xps + ws
        reset_launches()
        with torch.no_grad():
            outs = run(*inputs)
        if read_launches()[lean] != 1 or any(o.grad_fn for o in outs):
            fail(f"{op}: no_grad did not take the lean kernel")
        outs = run(*inputs)
        if not type(outs[0].grad_fn).__name__.startswith(node):
            fail(f"{op}: autograd did not take {node}: {outs[0].grad_fn}")
        got = torch.autograd.grad(outs, inputs, dhs)
        want = torch.autograd.grad(plain(*inputs), inputs, dhs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            worst = max(worst, err)
            if not err <= KERNEL_TOL:
                fail(f"{op} B{b} H{hs}: Function grad vs autograd of the "
                     f"plain loop, rel err {err} > {KERNEL_TOL}")
    log("autograd.Function", cases=len(cases), grads_rel_err=f"{worst:.3g}",
        tol=KERNEL_TOL, against="autograd through the plain loop")


def check_bwd_edges() -> None:
    """``bilstm_bwd``'s other code paths against its plain version on
    short sequences: batch 1, widths that are not a multiple of 4 (the
    4-byte residual copies) or of 8 (a block with fewer units), H=1, the
    batch-tiled d_pre staging (B=40 at H=512), and the largest batch the
    kernel takes at H=512 (``merged_max_batch(512, grad=True)``, from the
    kernel source's plan, one row a tile); one row more is refused by the
    kernel itself."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    limit = bilstm.merged_max_batch(512, grad=True)
    shapes = ((5, 1, 512), (7, 3, 100), (5, 2, 1), (6, 5, 3), (4, 40, 512),
              (3, limit, 512))
    worst = 0.0
    for t, b, h in shapes:
        xp_f, xp_b = rand(t, b, 4 * h), rand(t, b, 4 * h)
        w_f, w_b = rand(4 * h, h, scale=h ** -0.5), rand(4 * h, h,
                                                        scale=h ** -0.5)
        dh_f, dh_b = rand(t, b, h), rand(t, b, h)
        res = bilstm.bilstm_forward_reference(xp_f, xp_b, w_f, w_b)[2:]
        got = bilstm.bilstm_backward_cuda(dh_f, dh_b, *res, w_f, w_b)
        want = bilstm.bilstm_backward_reference(dh_f, dh_b, *res, w_f, w_b)
        err = rel_err(got, want)
        if not err <= KERNEL_TOL:
            fail(f"bilstm_bwd T{t}xB{b}xH{h}: rel err {err}")
        worst = max(worst, err)
    res = [torch.zeros(1, limit + 1, n, device="cuda")
           for n in (2048, 2048, 512, 512)]
    dh = torch.zeros(1, limit + 1, 512, device="cuda")
    w = torch.zeros(2048, 512, device="cuda")
    try:
        bilstm.bilstm_backward_cuda(dh, dh, *res, w, w)
    except RuntimeError:
        pass
    else:
        fail(f"bilstm_bwd took B={limit + 1} at H=512, past its limit")
    log("kernel bwd edges", shapes=len(shapes), rel_err=f"{worst:.3g}",
        tol=KERNEL_TOL, max_batch_h512=limit, refused_batch=limit + 1)


def bf16_ulps(got, want) -> float:
    """The largest |got - want| over the elements of matching tensors, in
    bfloat16 ulps of the larger magnitude, beyond float32 noise of
    ``BF16_NOISE`` x max |want| (0 where they agree that far)."""
    import torch

    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        over = ((g - w).abs() - BF16_NOISE * float(w.abs().max())).clamp_min(0)
        worst = max(worst, float((over / ulp).max()))
    return worst


def check_dtypes(what: str, tensors, dtype) -> None:
    if any(x.dtype != dtype for x in tensors):
        fail(f"{what}: {[str(x.dtype) for x in tensors]}, not {dtype}")


def check_bilstm_train_bf16(b: int, h: int, reps: int) -> dict:
    """``bilstm_fwd`` and ``bilstm_bwd`` at bfloat16 residuals (the JAX
    default) against their plain versions at bfloat16 on the same inputs
    as ``check_bilstm_train``'s: h within ``PATH_TOL``; g, c and dx, which
    the kernels store in bfloat16, within ``BF16_ULPS`` (``bf16_ulps``).
    The gradient kernel reads the plain forward's bfloat16 residuals and
    dh rounded to bfloat16 (as ``BiLSTMFunction`` hands it over), and
    also the kernel forward's own. Times each beside its bound at these
    bytes; returns the bfloat16 keys of the two kernels' rows."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3 * h + b)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    xp_f, xp_b = rand(T, b, 4 * h), rand(T, b, 4 * h)
    w_f, w_b = rand(4 * h, h, scale=h ** -0.5), rand(4 * h, h, scale=h ** -0.5)
    dh = [x.to(bf16) for x in (rand(T, b, h), rand(T, b, h))]
    got = bilstm.bilstm_forward_cuda(xp_f, xp_b, w_f, w_b, bf16)
    want = bilstm.bilstm_forward_reference(xp_f, xp_b, w_f, w_b, bf16)
    res = want[2:6]
    dx = bilstm.bilstm_backward_cuda(*dh, *res, w_f, w_b)
    dx_ref = bilstm.bilstm_backward_reference(*dh, *res, w_f, w_b)
    dx_own = bilstm.bilstm_backward_cuda(*dh, *got[2:6], w_f, w_b)
    dx_own_ref = bilstm.bilstm_backward_reference(*dh, *got[2:6], w_f, w_b)
    torch.cuda.synchronize()
    check_dtypes("bilstm_fwd bf16 h", got[:2], torch.float32)
    check_dtypes("bilstm_fwd bf16 g, c", got[2:], bf16)
    check_dtypes("bilstm_bwd bf16 dx", dx, bf16)
    errs = dict(err_h=abs_err(got[:2], want[:2]),
                ulps_g=bf16_ulps(got[2:4], want[2:4]),
                ulps_c=bf16_ulps(got[4:], want[4:]),
                ulps_dx=bf16_ulps(dx, dx_ref),
                ulps_dx_own_res=bf16_ulps(dx_own, dx_own_ref))
    fwd_ms = time_ms(lambda: bilstm.bilstm_forward_cuda(
        xp_f, xp_b, w_f, w_b, bf16), reps)
    bwd_ms = time_ms(lambda: bilstm.bilstm_backward_cuda(
        *dh, *res, w_f, w_b), reps)
    fwd_bound, fwd_by = lstm_bound(T, b, [h, h], "fwd", resid_bytes=2)
    bwd_bound, bwd_by = lstm_bound(T, b, [h, h], "bwd", resid_bytes=2,
                                   stream_bytes=2)
    shape = f"T{T}xB{b}xH{h}"
    log("kernel bilstm_fwd bf16", shape=shape, ms=f"{fwd_ms:.6g}",
        bound_ms=f"{fwd_bound:.6g}", bound_by=fwd_by,
        err_h=f"{errs['err_h']:.3g}", h_tol=PATH_TOL,
        max_ulps_g=f"{errs['ulps_g']:.3g}", max_ulps_c=f"{errs['ulps_c']:.3g}",
        ulps_tol=BF16_ULPS, noise=BF16_NOISE, residuals="bfloat16 g, c")
    log("kernel bilstm_bwd bf16", shape=shape, ms=f"{bwd_ms:.6g}",
        bound_ms=f"{bwd_bound:.6g}", bound_by=bwd_by,
        max_ulps_dx=f"{errs['ulps_dx']:.3g}",
        max_ulps_dx_on_kernel_residuals=f"{errs['ulps_dx_own_res']:.3g}",
        ulps_tol=BF16_ULPS, noise=BF16_NOISE,
        streams="bfloat16 dh, g, c in; bfloat16 dx out")
    if not errs["err_h"] <= PATH_TOL:
        fail(f"bilstm_fwd bf16 {shape}: h err {errs['err_h']} > {PATH_TOL}")
    for name in ("ulps_g", "ulps_c", "ulps_dx", "ulps_dx_own_res"):
        if not errs[name] <= BF16_ULPS:
            fail(f"bilstm training kernels bf16 {shape}: {name} "
                 f"{errs[name]} > {BF16_ULPS}")
    return {"bilstm_fwd": dict(bf16_ms=fwd_ms, bf16_bound_ms=fwd_bound,
                               bf16_bound_by=fwd_by,
                               bf16_max_ulps=max(errs["ulps_g"],
                                                 errs["ulps_c"]),
                               bf16_err_h=errs["err_h"]),
            "bilstm_bwd": dict(bf16_ms=bwd_ms, bf16_bound_ms=bwd_bound,
                               bf16_bound_by=bwd_by,
                               bf16_max_ulps=errs["ulps_dx"])}


def check_multi_train_bf16(b: int, hs, reps: int) -> dict:
    """``multi_bilstm_fwd`` and ``multi_bilstm_bwd`` at bfloat16 residuals
    against their plain versions at bfloat16, on ``check_multi_train``'s
    inputs: h and dx (float32 on this op, as the JAX multi-stream VJP
    keeps dh and dx) within ``PATH_TOL`` (dx relative to its max), g and
    c within ``BF16_ULPS``; the gradient kernel on the plain forward's
    residuals and on the kernel forward's own. Times each (call and
    device time) beside its bound at these bytes."""
    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11 * b + len(hs))
    xps, ws, dhs = [], [], []
    for h in hs:
        for _ in range(2):
            xps.append(torch.randn(T, b, 4 * h, device="cuda", generator=gen))
            ws.append(torch.randn(4 * h, h, device="cuda", generator=gen)
                      * h ** -0.5)
            dhs.append(torch.randn(T, b, h, device="cuda", generator=gen))
    n, d2 = len(hs), 2 * len(hs)
    got = multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws,
                                                 residual_dtype=bf16)
    want = multi_bilstm.multi_bilstm_forward_reference(n, *xps, *ws,
                                                       residual_dtype=bf16)
    res = want[d2:]
    dx = multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *res, *ws)
    dx_ref = multi_bilstm.multi_bilstm_backward_reference(n, *dhs, *res, *ws)
    dx_own = multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *got[d2:], *ws)
    dx_own_ref = multi_bilstm.multi_bilstm_backward_reference(
        n, *dhs, *got[d2:], *ws)
    torch.cuda.synchronize()
    check_dtypes("multi_bilstm_fwd bf16 h", got[:d2], torch.float32)
    check_dtypes("multi_bilstm_fwd bf16 g, c", got[d2:], bf16)
    check_dtypes("multi_bilstm_bwd bf16 dx", dx, torch.float32)
    errs = dict(err_h=abs_err(got[:d2], want[:d2]),
                ulps_g=bf16_ulps(got[d2:2 * d2], want[d2:2 * d2]),
                ulps_c=bf16_ulps(got[2 * d2:], want[2 * d2:]),
                err_dx_rel=rel_err(dx, dx_ref),
                err_dx_own_res_rel=rel_err(dx_own, dx_own_ref))

    def fwd():
        return multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws,
                                                      residual_dtype=bf16)

    def bwd():
        return multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *res, *ws)

    fwd_ms, bwd_ms = time_ms(fwd, reps), time_ms(bwd, reps)
    fwd_device_ms = kernel_device_ms(fwd, reps)
    bwd_device_ms = kernel_device_ms(bwd, reps)
    dirs = [h for h in hs for _ in (0, 1)]
    fwd_bound, fwd_by = lstm_bound(T, b, dirs, "fwd", resid_bytes=2)
    bwd_bound, bwd_by = lstm_bound(T, b, dirs, "bwd", resid_bytes=2)
    shape = f"T{T}xB{b}xH{'/'.join(map(str, hs))}"
    log("kernel multi_bilstm_fwd bf16", shape=shape, ms=f"{fwd_ms:.6g}",
        device_ms=f"{fwd_device_ms:.6g}", bound_ms=f"{fwd_bound:.6g}",
        bound_by=fwd_by, err_h=f"{errs['err_h']:.3g}", h_tol=PATH_TOL,
        max_ulps_g=f"{errs['ulps_g']:.3g}", max_ulps_c=f"{errs['ulps_c']:.3g}",
        ulps_tol=BF16_ULPS, noise=BF16_NOISE, residuals="bfloat16 g, c")
    log("kernel multi_bilstm_bwd bf16", shape=shape, ms=f"{bwd_ms:.6g}",
        device_ms=f"{bwd_device_ms:.6g}", bound_ms=f"{bwd_bound:.6g}",
        bound_by=bwd_by, rel_err_dx=f"{errs['err_dx_rel']:.3g}",
        rel_err_dx_on_kernel_residuals=f"{errs['err_dx_own_res_rel']:.3g}",
        tol=PATH_TOL, streams="bfloat16 g, c in; float32 dh in, dx out")
    for name, tol in (("err_h", PATH_TOL), ("ulps_g", BF16_ULPS),
                      ("ulps_c", BF16_ULPS), ("err_dx_rel", PATH_TOL),
                      ("err_dx_own_res_rel", PATH_TOL)):
        if not errs[name] <= tol:
            fail(f"multi_bilstm training kernels bf16 {shape}: {name} "
                 f"{errs[name]} > {tol}")
    return {"multi_bilstm_fwd": dict(
                bf16_ms=fwd_ms, bf16_device_ms=fwd_device_ms,
                bf16_bound_ms=fwd_bound, bf16_bound_by=fwd_by,
                bf16_max_ulps=max(errs["ulps_g"], errs["ulps_c"]),
                bf16_err_h=errs["err_h"]),
            "multi_bilstm_bwd": dict(
                bf16_ms=bwd_ms, bf16_device_ms=bwd_device_ms,
                bf16_bound_ms=bwd_bound, bf16_bound_by=bwd_by,
                bf16_rel_err=errs["err_dx_rel"])}


def check_bf16_edges() -> None:
    """The bfloat16 instantiations' other code paths against the plain
    versions at bfloat16: ``bilstm_fwd`` and ``bilstm_bwd`` at
    ``check_bwd_edges``' shapes (batch 1, widths not a multiple of 4 or 8,
    where g and c are stored one by one and read back without cp.async,
    H=1, batch tiles, the batch limit at H=512), and the multi-stream
    kernels at every ``MULTI_EDGES`` case whose widths are all on the lane
    plan (the block plan's: ``check_block_bf16_edges``); the gradient
    kernels each on the plain forward's residuals and on the kernel
    forward's own (the layout check)."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm, multi_bilstm

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    limit = bilstm.merged_max_batch(512, grad=True)
    worst = {"err_h": 0.0, "ulps": 0.0, "multi_dx_rel": 0.0}
    for t, b, h in ((5, 1, 512), (7, 3, 100), (5, 2, 1), (6, 5, 3),
                    (4, 40, 512), (5, 9, 6), (3, limit, 512)):
        xp_f, xp_b = rand(t, b, 4 * h), rand(t, b, 4 * h)
        w_f, w_b = (rand(4 * h, h, scale=h ** -0.5) for _ in range(2))
        dh = [rand(t, b, h).to(bf16) for _ in range(2)]
        got = bilstm.bilstm_forward_cuda(xp_f, xp_b, w_f, w_b, bf16)
        want = bilstm.bilstm_forward_reference(xp_f, xp_b, w_f, w_b, bf16)
        ulps = [bf16_ulps(got[2:], want[2:])]
        for res in (want[2:], got[2:]):
            dx = bilstm.bilstm_backward_cuda(*dh, *res, w_f, w_b)
            ulps.append(bf16_ulps(dx, bilstm.bilstm_backward_reference(
                *dh, *res, w_f, w_b)))
        err_h = abs_err(got[:2], want[:2])
        if not (err_h <= PATH_TOL and max(ulps) <= BF16_ULPS):
            fail(f"bilstm bf16 T{t}xB{b}xH{h}: h err {err_h}, ulps {ulps}")
        worst["err_h"] = max(worst["err_h"], err_h)
        worst["ulps"] = max(worst["ulps"], *ulps)
    lane = [c for c in MULTI_EDGES
            if max(c[2]) <= multi_bilstm.LANE_MAX_H]
    for t, b, hs in lane:
        xps, ws = multi_inputs(t, b, hs, SEED + 17 * t + b)
        n, d2 = len(hs), 2 * len(hs)
        got = multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws,
                                                     residual_dtype=bf16)
        want = multi_bilstm.multi_bilstm_forward_reference(
            n, *xps, *ws, residual_dtype=bf16)
        dhs = [torch.randn_like(x) for x in want[:d2]]
        errs = [rel_err(multi_bilstm.multi_bilstm_backward_cuda(
                    n, *dhs, *res, *ws),
                multi_bilstm.multi_bilstm_backward_reference(
                    n, *dhs, *res, *ws)) for res in (want[d2:], got[d2:])]
        err_h, ulps = abs_err(got[:d2], want[:d2]), bf16_ulps(got[d2:],
                                                               want[d2:])
        if not (err_h <= PATH_TOL and ulps <= BF16_ULPS
                and max(errs) <= PATH_TOL):
            fail(f"multi_bilstm bf16 T{t}xB{b}xH{hs}: h err {err_h}, ulps "
                 f"{ulps}, dx rel err {errs}")
        worst["err_h"] = max(worst["err_h"], err_h)
        worst["ulps"] = max(worst["ulps"], ulps)
        worst["multi_dx_rel"] = max(worst["multi_dx_rel"], *errs)
    log("kernel bf16 edges", merged_shapes=7, multi_shapes=len(lane),
        max_abs_err_h=f"{worst['err_h']:.3g}", h_tol=PATH_TOL,
        max_ulps=f"{worst['ulps']:.3g}", ulps_tol=BF16_ULPS,
        multi_dx_rel_err=f"{worst['multi_dx_rel']:.3g}",
        max_batch_h512=limit, block_plan="[kernel multi block bf16 edges]")


def phase_train_kernels(reps: int = 10) -> dict:
    """The training kernels at the train steps' shapes. Returns the row
    of each kernel's most expensive main-path shape."""
    with strict_float32():
        rows = {}
        for b, h in ((TRAIN_B, 512), (TRAIN_B, 256), (TRAIN_B, 8)):
            for name, row in check_bilstm_train(b, h, reps).items():
                rows.setdefault(name, row)
        # the generator's streams (the row of the JSON record), then the
        # F0 converter's beside them
        for hs in ((8, 32, 1), (32, 1)):
            for name, row in check_multi_train(TRAIN_B, hs, reps).items():
                if name in rows:
                    rows[name].setdefault("beside", []).append(
                        {k: row[k] for k in ("shape", "ms", "device_ms",
                                             "plain_ms", "bound_ms")})
                else:
                    rows[name] = row
        check_bwd_edges()
        check_functions()
        # bfloat16 residuals (the default config's) at the same shapes:
        # the keys go into the row of the kernel's first shape
        for b, h in ((TRAIN_B, 512), (TRAIN_B, 256), (TRAIN_B, 8)):
            for name, extra in check_bilstm_train_bf16(b, h, reps).items():
                if "bf16_ms" not in rows[name]:
                    rows[name].update(extra)
        for hs in ((8, 32, 1), (32, 1)):
            for name, extra in check_multi_train_bf16(TRAIN_B, hs,
                                                      reps).items():
                if "bf16_ms" not in rows[name]:
                    rows[name].update(extra)
        check_bf16_edges()
    return rows


def probe_library(tmp: str, stem: str, flag: str):
    """``csrc/<stem>.cu`` built with ``-D<flag>`` into ``tmp`` and loaded
    (the port never loads a probe build)."""
    import ctypes

    from speechsplit_tpu_torch.ops import _build

    lib_path = os.path.join(tmp, f"lib{stem}_probe.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-D{flag}", "-o",
                    lib_path, str(_build.CSRC / f"{stem}.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib_path)


def probe_split(phases, cycles, laps) -> tuple[dict, float]:
    """Cycles a warp a step of each phase (``cycles`` summed over warps,
    ``laps`` the warp-steps) and their shares; and the step's total."""
    per_step = {name: c / laps for name, c in zip(phases, cycles)}
    total = sum(per_step.values())
    split = {f"{k}_cycles": round(v) for k, v in per_step.items()}
    split.update({f"{k}_share": f"{v / total:.4f}"
                  for k, v in per_step.items()})
    return split, total


# the phases of a bilstm_bwd step that its probe build times, in the
# order of csrc/bilstm_bwd.cu's PROBE_LAP calls
BWD_PROBE_PHASES = ("barrier_wait", "d_pre_staging", "fma_and_reduction",
                    "cell_and_stores", "prefetch_and_arrive")


def phase_bwd_probe(shapes=((TRAIN_B, 512), (TRAIN_B, 256),
                            (TRAIN_B, 8))) -> dict:
    """The probe build of ``csrc/bilstm_bwd.cu`` (``-DBILSTM_BWD_PROBE``,
    compiled here into a temporary directory; the port never loads it):
    clock64() laps of each phase of a step, summed over warps, split into
    cycles a step and shares at the train step's shapes. The kernel's
    result is checked against the plain version as in phase 6. Returns
    the split at the first shape."""
    import ctypes

    import torch

    from speechsplit_tpu_torch.ops import bilstm

    splits = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = probe_library(tmp, "bilstm_bwd", "BILSTM_BWD_PROBE")
        lib.bilstm_bwd_launch.argtypes = [ctypes.c_void_p] * 12 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        n = len(BWD_PROBE_PHASES)
        cycles, laps = (ctypes.c_ulonglong * n)(), (ctypes.c_ulonglong * n)()
        for b, h in shapes:
            gen = torch.Generator(device="cuda").manual_seed(SEED + 3 * h + b)

            def rand(*shape, scale=1.0):
                return torch.randn(*shape, device="cuda",
                                   generator=gen) * scale

            xp_f, xp_b = rand(T, b, 4 * h), rand(T, b, 4 * h)
            w_f, w_b = (rand(4 * h, h, scale=h ** -0.5),
                        rand(4 * h, h, scale=h ** -0.5))
            dh_f, dh_b = rand(T, b, h), rand(T, b, h)
            res = bilstm.bilstm_forward_reference(xp_f, xp_b, w_f, w_b)[2:]
            dx = [torch.empty_like(res[0]) for _ in (0, 1)]

            def run():
                # float32 residuals (no carry scratch) and W_hh
                err = lib.bilstm_bwd_launch(
                    *[x.data_ptr() for x in (dh_f, dh_b, *res, w_f, w_b,
                                             *dx)], None,
                    bilstm._barrier_word(xp_f).data_ptr(), T, b, h, 0, 0, 0,
                    bilstm._stream(xp_f))
                if err:
                    fail(f"bilstm_bwd probe build: CUDA error {err}")

            run()
            lib.bilstm_bwd_probe_read(cycles, laps, 1)  # warm-up, reset
            run()
            torch.cuda.synchronize()
            if lib.bilstm_bwd_probe_read(cycles, laps, 1):
                fail("bilstm_bwd probe: reading the counters failed")
            want = bilstm.bilstm_backward_reference(dh_f, dh_b, *res, w_f,
                                                    w_b)
            err = rel_err(dx, want)
            if not err <= KERNEL_TOL:
                fail(f"bilstm_bwd probe build B{b} H{h}: rel err {err}")
            ms = time_ms(run, 5)
            # every warp laps each phase once a step (once a batch tile)
            split, total = probe_split(BWD_PROBE_PHASES, cycles, laps[0])
            log("bwd probe", shape=f"T{T}xB{b}xH{h}", ms_probe_build=f"{ms:.4f}",
                cycles_per_step=round(total), rel_err=f"{err:.3g}",
                **split, clock="clock64 of each warp, summed over warps")
            splits[(b, h)] = split
    return splits[shapes[0]]


# the phases of a merged forward step that its probe build times, in the
# order of csrc/bilstm_infer.cu's PROBE_LAP calls
INFER_PROBE_PHASES = ("barrier_wait", "h_staging", "fma_and_reduction",
                      "cell_and_stores", "prefetch_and_arrive")


def phase_infer_probe(shapes=(("infer", 28, 512), ("fwd", TRAIN_B, 512),
                              ("infer", 731, 256))) -> dict:
    """The probe build of ``csrc/bilstm_infer.cu``
    (``-DBILSTM_INFER_PROBE``, compiled here into a temporary directory;
    the port never loads it): clock64() laps of each phase of a step of
    the unfused forwards, summed over warps, split into cycles a step and
    shares, at the main path's B28 H512 (lean), B16 H512 (residual-
    saving) and B731 H256 (lean). The kernel's result is checked against
    the plain version. Returns the split at the first shape."""
    import ctypes

    import torch

    from speechsplit_tpu_torch.ops import bilstm

    splits = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = probe_library(tmp, "bilstm_infer", "BILSTM_INFER_PROBE")
        lib.bilstm_infer_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.bilstm_fwd_launch.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        n = len(INFER_PROBE_PHASES)
        cycles, laps = (ctypes.c_ulonglong * n)(), (ctypes.c_ulonglong * n)()
        for kind, b, h in shapes:
            args = merged_inputs(T, b, h, SEED + 3 * h + b)
            resid = kind == "fwd"
            outs = [torch.empty(T, b, h, device="cuda") for _ in (0, 1)]
            if resid:
                outs += [torch.empty(T, b, 4 * h, device="cuda")
                         for _ in (0, 1)]
                outs += [torch.empty(T, b, h, device="cuda") for _ in (0, 1)]
            launch = lib.bilstm_fwd_launch if resid else lib.bilstm_infer_launch
            # splits 0 (the source's plan), float32 residuals, W_hh and
            # xp, device 0
            plan = (0, 0, 0, 0, 0) if resid else (0, 0, 0, 0)

            def run():
                err = launch(*[x.data_ptr() for x in (
                    *args, *outs, bilstm._barrier_word(args[0], 2))],
                    T, b, h, *plan, bilstm._stream(args[0]))
                if err:
                    fail(f"bilstm_{kind} probe build: CUDA error {err}")

            run()
            lib.bilstm_infer_probe_read(cycles, laps, 1)  # warm-up, reset
            run()
            torch.cuda.synchronize()
            if lib.bilstm_infer_probe_read(cycles, laps, 1):
                fail("bilstm_infer probe: reading the counters failed")
            want = bilstm.bilstm_forward_reference(*args)
            err = abs_err(outs, want if resid else want[:2])
            if not err <= KERNEL_TOL:
                fail(f"bilstm_{kind} probe build B{b} H{h}: max abs err "
                     f"{err}")
            ms = time_ms(run, 5)
            # every warp laps the barrier phase once a step
            split, total = probe_split(INFER_PROBE_PHASES, cycles, laps[0])
            log("infer probe", kernel=f"bilstm_{kind}",
                shape=f"T{T}xB{b}xH{h}", ms_probe_build=f"{ms:.4f}",
                cycles_per_step=round(total), max_abs_err=f"{err:.3g}",
                **split, clock="clock64 of each warp, summed over warps")
            splits[(kind, b, h)] = split
            del args, outs
    return splits[shapes[0]]


# the phases of a multi-stream forward step that its probe build times, in
# the order of csrc/multi_bilstm_infer.cu's PROBE_LAP indices
MULTI_PROBE_PHASES = ("gate_input_wait", "product", "cell_and_stores",
                      "prefetch")


def phase_multi_probe(shapes=(("infer", 28, (8, 32, 1)),
                              ("fwd", TRAIN_B, (8, 32, 1))),
                      bf16_w: bool = False) -> dict:
    """The probe build of ``csrc/multi_bilstm_infer.cu``
    (``-DMULTI_BILSTM_PROBE``, compiled here into a temporary directory;
    the port never loads it): clock64() laps of each phase of a lane-plan
    step, per direction and summed over warps, as cycles a warp a step
    and shares per stream width, at the generator's B28 (lean) and B16
    (residual-saving); with ``bf16_w`` at bfloat16 compute (W_hh as
    ``compute_multi_inputs`` gives it). Each result is checked against
    the plain version. Returns the splits."""
    import ctypes

    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    n_phases = len(MULTI_PROBE_PHASES)
    slots = multi_bilstm.MAX_DIRECTIONS * n_phases
    cycles = (ctypes.c_ulonglong * slots)()
    laps = (ctypes.c_ulonglong * slots)()
    splits = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = probe_library(tmp, "multi_bilstm_infer", "MULTI_BILSTM_PROBE")
        # widths, W_hh flags (null: float32), T, B, device, stream
        tail = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.multi_bilstm_infer_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + tail)
        lib.multi_bilstm_fwd_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] + tail)
        lib.multi_bilstm_probe_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        for kind, b, hs in shapes:
            xps, ws = (compute_multi_inputs if bf16_w else multi_inputs)(
                T, b, hs, SEED + 7 * b)
            flags = multi_bilstm._w_bf16(ws) if bf16_w else None
            n, resid = len(hs), kind == "fwd"
            want = multi_bilstm.multi_bilstm_forward_reference(n, *xps, *ws)
            outs = [torch.empty_like(x) for x in want]
            outs = outs if resid else outs[:2 * n]
            want = want if resid else want[:2 * n]
            ptrs = [multi_bilstm._ptrs(x) for x in (xps, ws)] + [
                multi_bilstm._ptrs(outs[k * 2 * n:(k + 1) * 2 * n])
                for k in range(len(outs) // (2 * n))]
            launch = (lib.multi_bilstm_fwd_launch if resid
                      else lib.multi_bilstm_infer_launch)
            dtype = (0,) if resid else ()  # float32 residuals

            def run():
                err = launch(2 * n, *ptrs, *dtype, multi_bilstm._widths(xps),
                             flags, T, b, 0,
                             torch.cuda.current_stream().cuda_stream)
                if err:
                    fail(f"multi_bilstm_{kind} probe build: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            lib.multi_bilstm_probe_read(cycles, laps, 1)  # reset
            run()
            torch.cuda.synchronize()
            if lib.multi_bilstm_probe_read(cycles, laps, 1):
                fail("multi_bilstm probe: reading the counters failed")
            if bf16_w:
                err = check_flips(f"multi_bilstm_{kind} probe build B{b}",
                                  outs, want)["max_abs_err"]
            else:
                err = abs_err(outs, want)
            if not err <= KERNEL_TOL and not bf16_w:
                fail(f"multi_bilstm_{kind} probe build B{b}: max abs err "
                     f"{err}")
            ms = kernel_device_ms(run, 5)
            for st, h in enumerate(hs):
                at = [(2 * st + d) * n_phases for d in (0, 1)]
                # every live warp laps phase 0 once a step
                warp_steps = sum(laps[a] for a in at)
                split, total = probe_split(
                    MULTI_PROBE_PHASES,
                    [sum(cycles[a + i] for a in at) for i in range(n_phases)],
                    warp_steps)
                log("multi probe", kernel=f"multi_bilstm_{kind}"
                    + ("/bf16_w" if bf16_w else ""),
                    shape=f"T{T}xB{b}", width=h,
                    warps=warp_steps // (2 * T), ms_probe_build=f"{ms:.4f}",
                    cycles_per_step=round(total), max_abs_err=f"{err:.3g}",
                    **split, clock="clock64 of each warp, summed over warps")
                splits[(kind, b, h)] = split
            del xps, ws, want, outs
    return splits


# the phases of a lane step of the narrow gradients that their probe
# builds time, in the order of csrc/lane_bwd.cuh's slots
LANE_BWD_PROBE_PHASES = ("residual_wait", "product", "cell_and_stores",
                         "prefetch")


def phase_multi_bwd_probe(shapes=((TRAIN_B, (8, 32, 1)),
                                  (TRAIN_B, (32, 1))),
                          bf16: bool = False) -> dict:
    """The probe build of ``csrc/multi_bilstm_bwd.cu``
    (``-DMULTI_BILSTM_BWD_PROBE``): clock64() laps of each phase of a
    lane step (``csrc/lane_bwd.cuh``), per direction and summed over
    warps, as cycles a warp a step and shares per stream width, at the
    generator's and the F0 converter's train-step shapes (residual wait
    includes forming the next step's gate factors); with ``bf16`` at
    bfloat16 compute and residuals. Each result is checked against the
    plain version. Returns the splits."""
    import ctypes

    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    n_phases = len(LANE_BWD_PROBE_PHASES)
    slots = multi_bilstm.MAX_DIRECTIONS * n_phases
    cycles = (ctypes.c_ulonglong * slots)()
    laps = (ctypes.c_ulonglong * slots)()
    splits = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = probe_library(tmp, "multi_bilstm_bwd", "MULTI_BILSTM_BWD_PROBE")
        lib.multi_bilstm_bwd_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.multi_bilstm_bwd_probe_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        rd = torch.bfloat16 if bf16 else torch.float32
        for b, hs in shapes:
            xps, ws = (compute_multi_inputs if bf16 else multi_inputs)(
                T, b, hs, SEED + 7 * b + len(hs))
            flags = multi_bilstm._w_bf16(ws) if bf16 else None
            n = len(hs)
            res = multi_bilstm.multi_bilstm_forward_reference(
                n, *xps, *ws, residual_dtype=rd)
            gs, cs = res[2 * n:4 * n], res[4 * n:]
            dhs = [torch.randn_like(c, dtype=torch.float32) for c in cs]
            dxs = [torch.empty_like(g, dtype=torch.float32) for g in gs]
            ptrs = [multi_bilstm._ptrs(x) for x in (dhs, gs, cs, ws, dxs)]

            def run():
                err = lib.multi_bilstm_bwd_launch(
                    2 * n, *ptrs, int(bf16), multi_bilstm._widths(gs), flags,
                    T, b, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    fail(f"multi_bilstm_bwd probe build: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            lib.multi_bilstm_bwd_probe_read(cycles, laps, 1)  # reset
            run()
            torch.cuda.synchronize()
            if lib.multi_bilstm_bwd_probe_read(cycles, laps, 1):
                fail("multi_bilstm_bwd probe: reading the counters failed")
            want = multi_bilstm.multi_bilstm_backward_reference(
                n, *dhs, *gs, *cs, *ws)
            if bf16:
                check_flips(f"multi_bilstm_bwd probe build B{b}", dxs, want)
            err = rel_err(dxs, want)
            if not (err <= KERNEL_TOL or bf16):
                fail(f"multi_bilstm_bwd probe build B{b}: rel err {err}")
            ms = kernel_device_ms(run, 5)
            for st, h in enumerate(hs):
                at = [(2 * st + d) * n_phases for d in (0, 1)]
                # every live warp laps each phase once a step
                warp_steps = sum(laps[a] for a in at)
                split, total = probe_split(
                    LANE_BWD_PROBE_PHASES,
                    [sum(cycles[a + i] for a in at) for i in range(n_phases)],
                    warp_steps)
                log("multi bwd probe", shape=f"T{T}xB{b}xH"
                    f"{'/'.join(map(str, hs))}", width=h,
                    dtypes="bf16 W and residuals" if bf16 else "float32",
                    warps=warp_steps // (2 * T), ms_probe_build=f"{ms:.4f}",
                    cycles_per_step=round(total), rel_err=f"{err:.3g}",
                    **split, clock="clock64 of each warp, summed over warps")
                splits[(b, hs, h)] = split
            del xps, ws, res, dhs, dxs
    return splits


# the phases of an lstm_bwd step that its probe build times, in the order
# of csrc/lstm_bwd.cu's slots (the narrow plan laps slots 1-4)
LSTM_BWD_PROBE_PHASES = ("barrier_wait", "residual_and_d_pre_wait",
                         "product", "cell_and_stores", "prefetch_and_arrive")


def phase_lstm_bwd_probe(shapes=((TRAIN_B, 512), (TRAIN_B, 256),
                                 (TRAIN_B, 8))) -> dict:
    """The probe build of ``csrc/lstm_bwd.cu`` (``-DLSTM_BWD_PROBE``):
    clock64() laps of each phase of a step, summed over warps, as cycles
    a warp a step and shares, at the single-route train steps' shapes
    (the wide plan at H 512 and 256, the narrow one at H8). Each result is
    checked against the plain version, both directions. Returns the
    splits."""
    import ctypes

    import torch

    from speechsplit_tpu_torch.ops import bilstm, lstm

    n_phases = len(LSTM_BWD_PROBE_PHASES)
    cycles = (ctypes.c_ulonglong * n_phases)()
    laps = (ctypes.c_ulonglong * n_phases)()
    splits = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = probe_library(tmp, "lstm_bwd", "LSTM_BWD_PROBE")
        lib.lstm_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.lstm_bwd_probe_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        for b, h in shapes:
            xp, w, dh = lstm_inputs(T, b, h, SEED + 19 * h + b)
            err = 0.0
            # both directions checked; the split and the time are the
            # forward direction's, run last
            for reverse in (True, False):
                _, g, c = lstm.lstm_direction_forward_reference(xp, w,
                                                                reverse)
                dx = torch.empty_like(g)

                def run():
                    code = lib.lstm_bwd_launch(
                        dh.data_ptr(), g.data_ptr(), c.data_ptr(),
                        w.data_ptr(), dx.data_ptr(),
                        bilstm._barrier_word(g).data_ptr(), None, T, b, h,
                        int(reverse), 0, 0, 0, bilstm._stream(g))
                    if code:
                        fail(f"lstm_bwd probe build: CUDA error {code}")

                run()
                torch.cuda.synchronize()
                lib.lstm_bwd_probe_read(cycles, laps, 1)  # reset
                run()
                torch.cuda.synchronize()
                if lib.lstm_bwd_probe_read(cycles, laps, 1):
                    fail("lstm_bwd probe: reading the counters failed")
                err = max(err, rel_err([dx], [
                    lstm.lstm_direction_backward_reference(dh, g, c, w,
                                                           reverse)]))
            if not err <= KERNEL_TOL:
                fail(f"lstm_bwd probe build B{b} H{h}: rel err {err}")
            ms = kernel_device_ms(run, 5)
            # every warp laps the last phase once a step
            split, total = probe_split(LSTM_BWD_PROBE_PHASES, cycles,
                                       laps[n_phases - 1])
            log("lstm bwd probe", shape=f"T{T}xB{b}xH{h}",
                plan="narrow" if h <= lstm.NARROW_MAX_H else "wide",
                warps=laps[n_phases - 1] // T, ms_probe_build=f"{ms:.4f}",
                cycles_per_step=round(total), rel_err=f"{err:.3g}", **split,
                clock="clock64 of each warp, summed over warps")
            splits[(b, h)] = split
            del xp, w, dh, g, c, dx
    return splits


# the phases of an lstm_fwd step that its probe build times, in the order
# of csrc/lstm_infer.cu's slots (the narrow plan laps slots 1-4)
LSTM_FWD_PROBE_PHASES = ("barrier_wait", "h_and_gate_input_wait", "product",
                         "cell_and_stores", "prefetch_and_arrive")


def phase_lstm_fwd_probe(shapes=((TRAIN_B, 512), (TRAIN_B, 256),
                                 (TRAIN_B, 8))) -> dict:
    """The probe build of ``csrc/lstm_infer.cu`` (``-DLSTM_FWD_PROBE``):
    clock64() laps of each phase of an ``lstm_fwd`` step, summed
    over warps, as cycles a warp a step and shares, at the single-route
    train steps' shapes (the wide plan at H 512 and 256, the narrow one at
    H8). Each result is checked against the plain version, both
    directions. Returns the splits."""
    import ctypes

    import torch

    from speechsplit_tpu_torch.ops import bilstm, lstm

    n_phases = len(LSTM_FWD_PROBE_PHASES)
    cycles = (ctypes.c_ulonglong * n_phases)()
    laps = (ctypes.c_ulonglong * n_phases)()
    splits = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = probe_library(tmp, "lstm_infer", "LSTM_FWD_PROBE")
        lib.lstm_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.lstm_fwd_probe_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        for b, h in shapes:
            xp, w, _ = lstm_inputs(T, b, h, SEED + 19 * h + b)
            err = 0.0
            # both directions checked; the split and the time are the
            # forward direction's, run last
            for reverse in (True, False):
                outs = (torch.empty(T, b, h, device="cuda"),
                        torch.empty(T, b, 4 * h, device="cuda"),
                        torch.empty(T, b, h, device="cuda"))

                def run():
                    code = lib.lstm_fwd_launch(
                        xp.data_ptr(), w.data_ptr(),
                        *[x.data_ptr() for x in outs],
                        bilstm._barrier_word(xp).data_ptr(), T, b, h,
                        int(reverse), 0, 0, 0, 0, bilstm._stream(xp))
                    if code:
                        fail(f"lstm_fwd probe build: CUDA error {code}")

                run()
                torch.cuda.synchronize()
                lib.lstm_fwd_probe_read(cycles, laps, 1)  # reset
                run()
                torch.cuda.synchronize()
                if lib.lstm_fwd_probe_read(cycles, laps, 1):
                    fail("lstm_fwd probe: reading the counters failed")
                want = lstm.lstm_direction_forward_reference(xp, w, reverse)
                err = max(err, abs_err(outs, want))
            if not err <= KERNEL_TOL:
                fail(f"lstm_fwd probe build B{b} H{h}: max abs err {err}")
            ms = kernel_device_ms(run, 5)
            # every warp laps the last phase once a step
            split, total = probe_split(LSTM_FWD_PROBE_PHASES, cycles,
                                       laps[n_phases - 1])
            log("lstm fwd probe", shape=f"T{T}xB{b}xH{h}",
                plan="narrow" if h <= lstm.NARROW_MAX_H else "wide",
                warps=laps[n_phases - 1] // T, ms_probe_build=f"{ms:.4f}",
                cycles_per_step=round(total), max_abs_err=f"{err:.3g}",
                **split, clock="clock64 of each warp, summed over warps")
            splits[(b, h)] = split
            del xp, w, outs
    return splits


def synthetic_batch(config, seed: int, batch: int = TRAIN_B,
                    speakers: int | None = None):
    """A ``Collator`` batch (B=16 by default) cut from as many seeded
    synthetic utterances (mel in [0, 1], a normalized log-F0 contour with
    unvoiced frames, one-hot speakers: row i is speaker i modulo
    ``speakers``, every one of ``dim_spk_emb`` by default)."""
    import numpy as np

    from speechsplit_tpu_torch.data import Collator

    rng = np.random.default_rng(seed)
    samples = []
    for i in range(batch):
        length = int(rng.integers(150, 400))
        mel = rng.random((length, config.dim_freq), dtype=np.float32)
        f0 = np.where(rng.random(length) < 0.2, 0.0,
                      rng.random(length)).astype(np.float32)
        emb = np.zeros(config.dim_spk_emb, np.float32)
        emb[i % (speakers or config.dim_spk_emb)] = 1.0
        samples.append((mel, emb, f0))
    return Collator(config)(samples, rng)


def grads_of(model) -> dict:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def grad_err(grads: dict, want: dict) -> tuple[float, str]:
    """The largest max |g - w| / max |w| over the parameters, and its
    parameter."""
    worst, key = 0.0, ""
    for k, g in grads.items():
        w = want[k]
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if err > worst:
            worst, key = err, k
    return worst, key


def float32_config():
    """The config of the float32 phases: float32 residuals and Adam
    moments, TF32 off (``matmul_precision="highest"``), as every phase
    before the default config trained compared and timed."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    return SpeechSplitConfig(residual_dtype="float32",
                             adam_mu_dtype="float32",
                             matmul_precision="highest")


# the ops' plain versions: a step on the kernels calls none of them
PLAIN_VERSIONS = {
    "bilstm": ("lstm_direction_forward_reference",
               "lstm_direction_backward_reference",
               "bilstm_forward_reference", "bilstm_backward_reference",
               "bilstm_sequence_reference", "bilstm_fused_forward_reference",
               "bilstm_sequence_fused_reference"),
    "multi_bilstm": ("lstm_direction_forward_reference",
                     "lstm_direction_backward_reference",
                     "multi_bilstm_forward_reference",
                     "multi_bilstm_backward_reference",
                     "multi_bilstm_sequence_reference"),
    "lstm": ("lstm_direction_forward_reference",
             "lstm_direction_backward_reference", "lstm_sequence_reference"),
}


@contextlib.contextmanager
def plain_calls():
    """Record every call of the ops' plain versions while the block runs:
    yields the list of the names called."""
    from speechsplit_tpu_torch.ops import bilstm, lstm, multi_bilstm

    modules = {"bilstm": bilstm, "multi_bilstm": multi_bilstm, "lstm": lstm}
    called, saved = [], []

    def counted(name, fn):
        def run(*args, **kwargs):
            called.append(name)
            return fn(*args, **kwargs)
        return run

    for mod_name, names in PLAIN_VERSIONS.items():
        module = modules[mod_name]
        for name in names:
            fn = getattr(module, name)
            saved.append((module, name, fn))
            setattr(module, name, counted(f"{mod_name}.{name}", fn))
    try:
        yield called
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def train_phase(name: str, model: str, expected: dict, batch, reps: int = 12,
                layers: str = "default"):
    """One train step's launches, the step against the plain step, 5
    steps, and the time per step. ``layers`` is the BiLSTM layers'
    :func:`route`; off the default, the same step on the default route is
    timed in turns beside it."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.training import (
        create_train_state,
        make_f0_train_step,
        make_train_step,
    )

    config = float32_config()
    make = make_train_step if model == "speechsplit" else make_f0_train_step
    step = make(config)

    with strict_float32(), route(layers):
        state = create_train_state(config, SEED, model)
        before = [p.detach().clone() for p in state.model.parameters()]
        torch.cuda.synchronize()
        reset_launches()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        launches = read_launches()
        grads = grads_of(state.model)
        for kernel, count in launches.items():
            if count != expected.get(kernel, 0):
                fail(f"{name} step launched {kernel} {count} times, "
                     f"expected {expected.get(kernel, 0)}")
        plain_state = create_train_state(config, SEED, model)
        with plain_kernels():
            plain_state, plain_loss = step(plain_state, batch)
        plain_grads = grads_of(plain_state.model)
    loss_err = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
    max_grad_err, worst = grad_err(grads, plain_grads)
    if not (loss_err <= STEP_TOL and max_grad_err <= STEP_TOL):
        fail(f"{name} step vs plain step: loss rel err {loss_err}, grad "
             f"rel err {max_grad_err} ({worst}) > {STEP_TOL}")

    losses = [float(loss)]
    with route(layers):
        for _ in range(4):
            state, loss = step(state, batch)
            losses.append(float(loss))
    changed = max(float((p.detach() - q).abs().max())
                  for p, q in zip(state.model.parameters(), before))
    if not (np.isfinite(losses).all() and changed > 0):
        fail(f"{name}: losses {losses}, largest parameter change {changed}")

    # timed at the precision that was compared: float32, TF32 off
    modes = (layers, "default") if layers != "default" else (layers,)
    samples = {m: [] for m in modes}
    with strict_float32("timing"):
        for r in range(reps):
            for m in modes if r % 2 == 0 else modes[::-1]:
                with route(m):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    state, loss = step(state, batch)
                    torch.cuda.synchronize()
                samples[m].append((time.perf_counter() - start) * 1e3)
    q1, ms, q3 = np.percentile(samples[layers], [25, 50, 75])
    default = {}
    if layers != "default":
        d_q1, d_ms, d_q3 = np.percentile(samples["default"], [25, 50, 75])
        default = dict(default_median_ms_per_step=f"{d_ms:.4f}",
                       default_q1_ms=f"{d_q1:.4f}",
                       default_q3_ms=f"{d_q3:.4f}",
                       timing=f"{layers} and default steps in turns")
    log(f"train {name}", batch=f"B{TRAIN_B}xT{config.max_len_pad}",
        loss_rel_err_vs_plain=f"{loss_err:.3g}",
        max_grad_rel_err_vs_plain=f"{max_grad_err:.3g}", worst_param=worst,
        tol=STEP_TOL, losses=",".join(f"{v:.6f}" for v in losses),
        largest_param_change=f"{changed:.3g}", steps=reps,
        median_ms_per_step=f"{ms:.4f}", q1_ms=f"{q1:.4f}", q3_ms=f"{q3:.4f}",
        steps_per_s_at_median=f"{1e3 / ms:.3f}", **default,
        layers=layers, tf32="off for the comparison and the timing",
        launches=json.dumps(launches).replace(" ", ""))
    return launches, state, step


def phase_train():
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    batch = synthetic_batch(SpeechSplitConfig(), SEED)
    gen_launches, state, step = train_phase(
        "generator", "speechsplit",
        {"bilstm_fwd": 4, "bilstm_bwd": 4, "multi_bilstm_fwd": 1,
         "multi_bilstm_bwd": 1}, batch)
    f0_launches, _, _ = train_phase(
        "f0_converter", "f0_converter",
        {"bilstm_fwd": 2, "bilstm_bwd": 2, "multi_bilstm_fwd": 1,
         "multi_bilstm_bwd": 1}, batch)
    return gen_launches, f0_launches, state, step, batch


def train_precision_phase(name: str, model: str, expected: dict, batch,
                          checked: dict, timed: dict, title: str,
                          reps: int = 12, layers: str = "default",
                          exact=None) -> dict:
    """Train steps at the precisions ``checked`` ({label: config}) on
    ``batch``: each one's launches in one step, exactly ``expected``,
    with no call of a plain version, Adam's mu bfloat16, its loss and
    every gradient within ``BF16_STEP_TOL`` of the plain step at the same
    config (``plain_training_kernels``: the Functions on their plain
    versions), beside them the error of each against the exact float32
    plain step (float32 residuals, TF32 off), recorded; 5 steps with a
    finite loss. Then the median ms a step of the steps ``timed`` ({label:
    config}; a checked label's state goes on from its 5 steps), timed in
    turns. ``layers``: the BiLSTM layers' :func:`route` for every step.
    ``exact``: the float32 step's config (default ``float32_config()``;
    another width's for models of other widths). Returns the launches by
    checked label."""
    with route(layers):
        return _train_precision_phase(name, model, expected, batch, checked,
                                      timed, title, reps, layers,
                                      exact or float32_config())


def _train_precision_phase(name, model, expected, batch, checked, timed,
                           title, reps, layers, f32) -> dict:
    import numpy as np
    import torch

    from speechsplit_tpu_torch.training import (
        create_train_state,
        make_f0_train_step,
        make_train_step,
    )

    make = make_train_step if model == "speechsplit" else make_f0_train_step
    with strict_float32(f"{name} float32 reference"):
        exact = create_train_state(f32, SEED, model)
        with plain_kernels():
            exact, exact_loss = make(f32)(exact, batch)
        exact_grads = grads_of(exact.model)
    del exact
    fields, launches, runs = {}, {}, {}
    for label, config in checked.items():
        plain = create_train_state(config, SEED, model)
        reset_launches()
        with plain_training_kernels():
            plain, plain_loss = make(config)(plain, batch)
        if any(read_launches().values()):
            fail(f"{name} {label}: the plain step launched a kernel")
        plain_grads = grads_of(plain.model)
        del plain
        run = create_train_state(config, SEED, model)
        torch.cuda.synchronize()
        reset_launches()
        with plain_calls() as called:
            run, loss = make(config)(run, batch)
        torch.cuda.synchronize()
        launches[label] = read_launches()
        for kernel, count in launches[label].items():
            if count != expected.get(kernel, 0):
                fail(f"{name} {label} step launched {kernel} {count} times, "
                     f"expected {expected.get(kernel, 0)}")
        if called:
            fail(f"{name} {label} step called plain versions: "
                 f"{sorted(set(called))}")
        mu = {str(s["exp_avg"].dtype) for s in run.optimizer.state.values()}
        if mu != {"torch.bfloat16"}:
            fail(f"{name} {label} step: Adam mu dtypes {mu}")
        grads = grads_of(run.model)
        worst, key = grad_err(grads, plain_grads)
        vs_f32, f32_key = grad_err(grads, exact_grads)
        loss_err = abs(float(loss) - float(plain_loss)) / abs(
            float(plain_loss))
        if not (loss_err <= BF16_STEP_TOL and worst <= BF16_STEP_TOL):
            fail(f"{name} {label} step vs the plain step: loss rel err "
                 f"{loss_err}, grad rel err {worst} ({key}) > "
                 f"{BF16_STEP_TOL}")
        step, losses = make(config), [float(loss)]
        for _ in range(4):
            run, loss = step(run, batch)
            losses.append(float(loss))
        if not np.isfinite(losses).all():
            fail(f"{name} {label}: losses {losses}")
        runs[label] = (run, step)
        fields.update({
            f"{label}_loss_rel_err_vs_plain": f"{loss_err:.3g}",
            f"{label}_max_grad_rel_err_vs_plain": f"{worst:.3g}",
            f"{label}_worst_param": key,
            f"{label}_loss_rel_err_vs_float32": "%.3g" % (abs(
                losses[0] - float(exact_loss)) / abs(float(exact_loss))),
            f"{label}_max_grad_rel_err_vs_float32": f"{vs_f32:.3g}",
            f"{label}_worst_param_vs_float32": f32_key,
            f"{label}_losses": ",".join(f"{v:.6f}" for v in losses)})
    for label, config in timed.items():
        if label not in runs:
            runs[label] = (create_train_state(config, SEED, model),
                           make(config))
    samples = {label: [] for label in timed}
    order = list(timed)
    for r in range(reps):
        for label in order if r % 2 == 0 else order[::-1]:
            run, fn = runs[label]
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn(run, batch)
            torch.cuda.synchronize()
            samples[label].append((time.perf_counter() - start) * 1e3)
    log(f"train {name} {title}", batch=f"B{batch.mel.shape[0]}xT{T}",
        layers=layers, checked=",".join(checked),
        plain="the Functions on their plain versions, same config",
        float32="the plain float32 step, TF32 off (recorded)", **fields,
        tol=BF16_STEP_TOL, steps=reps,
        **{f"{label}_median_ms_per_step": f"{np.median(v):.4f}"
           for label, v in samples.items()},
        **{f"{label}_rounds_ms": ",".join(f"{t:.4f}" for t in v)
           for label, v in samples.items()},
        timing=" and ".join(timed) + " steps in turns", plain_calls=0,
        launches=json.dumps(launches[next(iter(checked))]).replace(" ", ""))
    return launches


def phase_train_default(gen_per_step: dict, f0_per_step: dict, batch):
    """Both train steps at the default config (``SpeechSplitConfig()``:
    bfloat16 residuals and Adam mu, TF32 matmuls and convolutions; also
    with TF32 off), each expected to launch what its float32 step
    launches, timed in turns with the float32 step (``float32_config``).
    Returns the two steps' launches."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    checked = {"default": SpeechSplitConfig(),
               "tf32_off": SpeechSplitConfig(matmul_precision="highest")}
    timed = {"default": checked["default"], "float32": float32_config()}
    return tuple(
        train_precision_phase(name, model, per_step, batch, checked, timed,
                              "default config")["default"]
        for name, model, per_step in (
            ("generator", "speechsplit", gen_per_step),
            ("f0_converter", "f0_converter", f0_per_step)))


# [ddp]: the bars of two ranks against one process at the global batch
# (JAX's for its mesh, tests/test_shard_map_step.py:59-70), the
# contrastive weight of the learned mode's run, its steps, and the timed
# rounds of (a)
DDP_LOSS_ATOL = 1e-5
DDP_PARAM_ATOL = 1e-4
DDP_CONTRAST = 0.5
DDP_STEPS = 3
DDP_ONE_STEPS = 5
DDP_ROUNDS = 8
DDP_TIMEOUT_S = 300.0


def ddp_modes() -> dict:
    """The [ddp] (b) runs: {label: (config, model)}."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    f32 = float32_config()
    return {
        "generator": (f32, "speechsplit"),
        "f0_converter": (f32, "f0_converter"),
        "learned_contrast": (learned(f32).replace(
            spk_contrast_weight=DDP_CONTRAST), "speechsplit"),
        "generator_default": (SpeechSplitConfig(), "speechsplit"),
    }


def ddp_batch(label: str):
    """The B16 batch of a [ddp] run: 4 speakers (pairs across the two
    ranks' halves) in learned mode, else the train phases' batch."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    return synthetic_batch(SpeechSplitConfig(), SEED, speakers=(
        LEARNED_SPEAKERS if label == "learned_contrast" else None))


def ddp_steps(config, model: str, batch, mesh, steps: int, make=None,
              first_grads: bool = False):
    """``steps`` steps from the seeded state on ``batch`` (this rank's
    rows on ``mesh``) by ``make(config[, mesh])``; returns (state, step,
    losses, launches of the first step, ms of each step, and with
    ``first_grads`` the first step's gradients on the host, else None;
    on a mesh the reduced ones)."""
    import torch

    from speechsplit_tpu_torch.parallel import shard_batch
    from speechsplit_tpu_torch.training import (
        create_train_state,
        make_f0_train_step,
        make_train_step,
    )

    if make is None:
        make = make_train_step if model == "speechsplit" else (
            make_f0_train_step)
    step = make(config, mesh) if mesh is not None else make(config)
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    state = create_train_state(config, SEED, model)
    losses, times, launches, grads = [], [], None, None
    for i in range(steps):
        torch.cuda.synchronize()
        if i == 0:
            reset_launches()
        start = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        if i == 0:
            launches = {k: v for k, v in read_launches().items() if v}
            if first_grads:
                grads = {k: v.cpu() for k, v in
                         grads_of(state.model).items()}
        losses.append(float(loss))
    return state, step, losses, launches, times, grads


def ddp_rank(out: str) -> None:
    """A spawned [ddp] (b) rank: each mode's steps on its 8 rows, saved
    as ``rank{r}.pt`` (losses, parameters, launches, ms a step)."""
    import torch

    from speechsplit_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    results = {}
    with strict_float32(f"[ddp] rank {mesh.rank}"), cudnn_deterministic():
        for label, (config, model) in ddp_modes().items():
            state, _, losses, launches, times, grads = ddp_steps(
                config, model, ddp_batch(label), mesh, DDP_STEPS,
                first_grads=label == "generator_default")
            results[label] = dict(
                losses=losses, launches=launches, ms=times, grads=grads,
                params={k: v.detach().cpu() for k, v in
                        state.model.state_dict().items()})
    torch.save(results, os.path.join(out, f"rank{mesh.rank}.pt"))


def max_param_diff(a: dict, b: dict) -> tuple[float, str]:
    """The largest |a - b| over two state dicts, and its key."""
    worst, key = 0.0, ""
    for k, v in a.items():
        d = float((v.float().cpu() - b[k].float().cpu()).abs().max())
        if d > worst:
            worst, key = d, k
    return worst, key


def phase_ddp(gen_per_step: dict, batch) -> dict:
    """[ddp]: data-parallel training at full width (module docstring,
    after phase 7). Returns each rank's launches in one generator step of
    (b)'s float32 run."""
    import threading

    import numpy as np
    import torch

    from speechsplit_tpu_torch import parallel
    from speechsplit_tpu_torch.training import make_train_step
    from speechsplit_tpu_torch.training.train_step import (
        make_train_step_shard_map,
    )

    wall = time.perf_counter()
    card = card_line()
    f32 = float32_config()
    # (a) a world of one under NCCL: DDP and explicit steps against the
    # plain step, 5 steps each, then timed in turns
    fields = {}
    with tempfile.TemporaryDirectory() as tmp:
        parallel.initialize("nccl", f"file://{tmp}/store", 1, 0,
                            device="cuda:0")
        try:
            mesh = parallel.make_mesh()
            makers = {"plain": None, "ddp": make_train_step,
                      "explicit": make_train_step_shard_map}
            runs = {}
            with strict_float32("[ddp] world of one"), cudnn_deterministic():
                for label, make in makers.items():
                    state, step, losses, launches, *_ = ddp_steps(
                        f32, "speechsplit", batch,
                        None if make is None else mesh, DDP_ONE_STEPS,
                        make or make_train_step)
                    if launches != gen_per_step:
                        fail(f"[ddp] world of one {label}: launches "
                             f"{launches}, expected {gen_per_step}")
                    runs[label] = (state, step, losses)
                plain_state, _, plain_losses = runs["plain"]
                for label in ("ddp", "explicit"):
                    state, _, losses = runs[label]
                    equal = losses == plain_losses and all(
                        torch.equal(p, q) for p, q in zip(
                            state.model.state_dict().values(),
                            plain_state.model.state_dict().values()))
                    loss_err = max(abs(a - b) / abs(b) for a, b in
                                   zip(losses, plain_losses))
                    param_err, key = max_param_diff(
                        state.model.state_dict(),
                        plain_state.model.state_dict())
                    if not equal and not (loss_err <= STEP_TOL
                                          and param_err <= DDP_PARAM_ATOL):
                        fail(f"[ddp] world of one {label} vs plain: loss "
                             f"rel err {loss_err}, parameter err "
                             f"{param_err} ({key})")
                    fields[f"{label}_bit_equal_plain"] = equal
                    fields[f"{label}_max_loss_rel_err"] = f"{loss_err:.3g}"
                    fields[f"{label}_max_param_abs_err"] = f"{param_err:.3g}"
                    fields[f"{label}_worst_param"] = key or "none"
                fields["losses"] = ",".join(f"{v:.6f}" for v in plain_losses)
                # (d) the three steps' ms, in turns, each on its own state
                samples = {label: [] for label in runs}
                order = list(runs)
                for r in range(DDP_ROUNDS):
                    for label in order if r % 2 == 0 else order[::-1]:
                        state, step, _ = runs[label]
                        torch.cuda.synchronize()
                        start = time.perf_counter()
                        step(state, batch)
                        torch.cuda.synchronize()
                        samples[label].append(
                            (time.perf_counter() - start) * 1e3)
            # the DDP wrapper goes before its process group
            del runs, state, step, plain_state
        finally:
            parallel.shutdown()
    log("ddp world of one", backend="nccl", card=card.replace(" ", "_"),
        batch=f"B{TRAIN_B}xT{T}", config="float32 (TF32 off, cuDNN "
        "deterministic)", steps=DDP_ONE_STEPS, **fields,
        **{f"{label}_median_ms_per_step": f"{np.median(v):.4f}"
           for label, v in samples.items()},
        **{f"{label}_rounds_ms": ",".join(f"{t:.4f}" for t in v)
           for label, v in samples.items()},
        timing="plain, ddp and explicit steps in turns",
        tol=f"bit-equal or loss {STEP_TOL} rel, params {DDP_PARAM_ATOL}")

    # (b) two gloo ranks on this card, spawned; one process at B16 and
    # at B8 meanwhile
    with tempfile.TemporaryDirectory() as tmp:
        errors = []

        def ranks():
            try:
                parallel.launch(ddp_rank, 2, (tmp,), backend="gloo",
                                device="cuda:0", timeout=DDP_TIMEOUT_S,
                                threads=1)
            except BaseException as error:  # re-raised below
                errors.append(error)

        thread = threading.Thread(target=ranks)
        thread.start()
        refs, b8 = {}, {}
        with strict_float32("[ddp] one process"), cudnn_deterministic():
            for label, (config, model) in ddp_modes().items():
                full = ddp_batch(label)
                state, _, losses, _, _, grads = ddp_steps(
                    config, model, full, None, DDP_STEPS,
                    first_grads=label == "generator_default")
                refs[label] = (losses, {k: v.detach().cpu() for k, v in
                                        state.model.state_dict().items()},
                               grads)
                half = type(full)(*(x[: TRAIN_B // 2] for x in full))
                b8[label] = ddp_steps(config, model, half, None, 1)[3]
                del state
        thread.join()
        if errors:
            fail(f"[ddp] two gloo ranks: {errors[0]!r}")
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(2)]
    rank_launches = {}
    for label, (config, model) in ddp_modes().items():
        want_losses, want_params, want_grads = refs[label]
        r0, r1 = got[0][label], got[1][label]
        diff01, key01 = max_param_diff(r0["params"], r1["params"])
        if diff01 or r0["losses"] != r1["losses"]:
            fail(f"[ddp] {label}: the two ranks differ ({key01}: {diff01})")
        for r, res in enumerate((r0, r1)):
            if not res["launches"] or res["launches"] != b8[label]:
                fail(f"[ddp] {label} rank {r}: launches {res['launches']}, "
                     f"a B8 one-process step's {b8[label]}")
        param_err, key = max_param_diff(r0["params"], want_params)
        extra = {}
        if label == "generator_default":
            # the parameters are printed, not held: 3 Adam steps move
            # them by about 3e-4 at most, within any bar of their own
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(r0["losses"], want_losses))
            grad_worst, grad_key = grad_err(r0["grads"], want_grads)
            ok = loss_err <= BF16_STEP_TOL and grad_worst <= BF16_STEP_TOL
            bars = (f"loss {BF16_STEP_TOL} rel, first-step reduced grads "
                    f"{BF16_STEP_TOL} of max")
            extra = dict(first_step_grad_err_over_max=f"{grad_worst:.3g}",
                         worst_grad=grad_key)
        else:
            loss_err = max(abs(a - b) for a, b in
                           zip(r0["losses"], want_losses))
            ok = loss_err <= DDP_LOSS_ATOL and param_err <= DDP_PARAM_ATOL
            bars = f"loss {DDP_LOSS_ATOL} abs, params {DDP_PARAM_ATOL} abs"
        if not ok:
            fail(f"[ddp] {label}: two ranks vs one process at B{TRAIN_B}: "
                 f"loss err {loss_err}, parameter err {param_err} ({key}), "
                 f"{extra}; bars {bars}")
        rank_launches[label] = [r0["launches"], r1["launches"]]
        log(f"ddp two ranks {label}", backend="gloo", card=card.replace(
            " ", "_"), ranks="2 processes sharing one card", rows_a_rank=
            TRAIN_B // 2, model=model, steps=DDP_STEPS,
            loss_err_vs_one_process=f"{loss_err:.3g}",
            max_param_abs_err=f"{param_err:.3g}", worst_param=key, **extra,
            bars=bars.replace(" ", "_"),
            losses=",".join(f"{v:.6f}" for v in r0["losses"]),
            one_process_losses=",".join(f"{v:.6f}" for v in want_losses),
            launches_a_step_rank0=json.dumps(r0["launches"]).replace(" ", ""),
            launches_a_step_rank1=json.dumps(r1["launches"]).replace(" ", ""),
            launches_b8_one_process=json.dumps(b8[label]).replace(" ", ""),
            two_ranks_sharing_one_card_ms_a_step_not_a_scaling_figure=(
                ",".join(f"{t:.4f}" for t in r0["ms"])))
    log("ddp", card=card.replace(" ", "_"),
        seconds=f"{time.perf_counter() - wall:.1f}")
    return rank_launches


def phase_train_cli_default(gen_per_step: dict, f0_per_step: dict,
                            hparams: str = "", what: str = "default config",
                            validate_tol: float | None = None) -> None:
    """``cli.train`` at the default config (no precision in --hparams; or
    with ``hparams``, such as ``compute_dtype=bfloat16,batch_size=32``)
    for both models: ``CLI_STEPS`` iterations with a checkpoint every
    ``CLI_SAVE``, their launches, finite losses, Adam's mu bfloat16 in
    every checkpoint, each checkpoint loading strictly into a
    default-config (float32-compute) model, and a resume from step
    ``CLI_SAVE`` whose state before its first step equals the
    checkpoint's; with ``validate_tol``, ``check_validate`` at the run's
    config."""
    import shutil

    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig, resolve_dtype
    from speechsplit_tpu_torch.interop import load_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
    from speechsplit_tpu_torch.training import checkpoint as ckpt_lib

    config = SpeechSplitConfig()
    run_config = config.parse(hparams) if hparams else config
    with tempfile.TemporaryDirectory() as tmp:
        root_dir, feat_dir = write_feature_tree(tmp, config, SEED + 5)
        for model, tag, per_step, cls in (
                ("speechsplit", "G", gen_per_step, SpeechSplit),
                ("f0_converter", "P", f0_per_step, F0Converter)):
            run = os.path.join(tmp, f"run_{tag}")
            models = os.path.join(run, "models")

            def args(save_dir, iters, *extra):
                return [
                    "--num_iters", str(iters), "--model_save_dir", save_dir,
                    "--log_step", str(CLI_SAVE), "--model_save_step",
                    str(CLI_SAVE), "--sample_step", "1000", "--model", model,
                    "--log_dir", os.path.join(run, "logs"),
                    "--sample_dir", os.path.join(run, "samples"),
                    "--validation_path", os.path.join(tmp, "no_such.pkl"),
                    "--hparams", f"root_dir={root_dir},feat_dir={feat_dir}"
                    + (f",{hparams}" if hparams else ""),
                    "--device", "cuda", *extra]

            losses, _, state = run_cli_train(args(models, CLI_STEPS),
                                             CLI_STEPS, per_step,
                                             f"{model} {what}")
            if state.model.decoder.lstm.dtype != resolve_dtype(
                    run_config.compute_dtype):
                fail(f"train.cli {what}: the model's dtype is "
                     f"{state.model.decoder.lstm.dtype}")
            for step in (CLI_SAVE, CLI_STEPS):
                path = ckpt_lib.checkpoint_path(models, step, tag)
                cls(config).load_state_dict(load_reference_checkpoint(path),
                                            strict=True)
                mu = {str(s["exp_avg"].dtype) for s in torch.load(
                    path, map_location="cpu",
                    weights_only=True)["optimizer"]["state"].values()}
                if mu != {"torch.bfloat16"}:
                    fail(f"train.cli {what}: {step}-{tag}.ckpt "
                         f"holds mu in {mu}")
            resumed = os.path.join(run, "resumed")
            shutil.copytree(models, resumed)
            r_losses, r_record, _ = run_cli_train(
                args(resumed, CLI_STEPS - CLI_SAVE, "--resume_iters",
                     str(CLI_SAVE)),
                CLI_STEPS - CLI_SAVE, per_step, f"{model} {what} resumed")
            saved = torch.load(ckpt_lib.checkpoint_path(models, CLI_SAVE, tag),
                               map_location="cpu", weights_only=True)
            if not same_state(r_record["first"], saved):
                fail(f"train.cli {what} {model}: the resumed state "
                     f"before its first step differs from "
                     f"{CLI_SAVE}-{tag}.ckpt")
            log(f"train.cli {what}", model=model, steps=CLI_STEPS,
                hparams=hparams or "root_dir,feat_dir only",
                checkpoints=f"{CLI_SAVE}-{tag},{CLI_STEPS}-{tag} strict, "
                "mu bfloat16",
                resumed_from=f"{CLI_SAVE}-{tag} state equal",
                losses=",".join(f"{v:.6f}" for v in losses + r_losses),
                launches_a_step=json.dumps(per_step).replace(" ", ""))
            shutil.rmtree(run)
        if validate_tol is not None:
            check_validate(run_config, tmp, validate_tol, f" {what}")


def phase_profile_train(state, step, batch, top: int = 14) -> None:
    """Where one generator train step spends device time (float32,
    TF32 off, as the timed steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with strict_float32("profile"), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    profile_events("profile train", prof, wall_ms, top)


def write_feature_tree(root: str, config, seed: int) -> tuple:
    """A seeded feature tree as the preprocessing CLIs write one: 8
    speakers with 1-3 utterances each of 150-400 frames, mel in [0, 1],
    normalized F0 with unvoiced zeros, one-hot embeddings and
    ``spmel/train.pkl``. Returns (root_dir, feat_dir)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    root_dir = os.path.join(root, "spmel")
    feat_dir = os.path.join(root, "raptf0")
    meta = []
    for s in range(8):
        spk = f"p{225 + s}"
        for d in (root_dir, feat_dir):
            os.makedirs(os.path.join(d, spk), exist_ok=True)
        emb = np.zeros(config.dim_spk_emb, np.float32)
        emb[s] = 1.0
        entry = [spk, emb]
        for u in range(int(rng.integers(1, 4))):
            t = int(rng.integers(150, 401))
            rel = f"{spk}/{spk}_{u:03d}.npy"
            np.save(os.path.join(root_dir, rel),
                    rng.random((t, config.dim_freq), dtype=np.float32))
            np.save(os.path.join(feat_dir, rel), np.where(
                rng.random(t) < 0.2, 0.0, rng.random(t)).astype(np.float32))
            entry.append(rel)
        meta.append(entry)
    with open(os.path.join(root_dir, "train.pkl"), "wb") as handle:
        pickle.dump(meta, handle)
    return root_dir, feat_dir


def train_state_snapshot(state) -> dict:
    """Params, Adam state, step and generator state, copied to the CPU."""
    opt = state.optimizer.state_dict()["state"]
    return dict(
        model={k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()},
        optimizer={i: {k: v.detach().cpu().clone() for k, v in s.items()}
                   for i, s in opt.items()},
        step=state.step, generator=state.generator.get_state())


def same_state(snap: dict, ckpt: dict) -> bool:
    import torch

    opt = ckpt["optimizer"]["state"]
    return (snap["step"] == ckpt["step"]
            and torch.equal(snap["generator"], ckpt["generator"])
            and snap["model"].keys() == ckpt["model"].keys()
            and all(torch.equal(v, ckpt["model"][k])
                    for k, v in snap["model"].items())
            and snap["optimizer"].keys() == opt.keys()
            and all(torch.equal(v, opt[i][k])
                    for i, s in snap["optimizer"].items()
                    for k, v in s.items()))


@contextlib.contextmanager
def solver_probe(steps: int):
    """Wrap the train steps a ``Solver`` builds: keep the state before
    its first step and the host clock at each step's start, fence the
    first step with ``torch.cuda.synchronize()``, and end the last
    (step ``steps``) with one, keeping the clock there. So
    ``(end - starts[1]) / (steps - 1)`` is the loop's wall time a step
    over all steps but the first, with no synchronization inside that
    window that the loop does not make itself (it reads the loss at
    ``log_step``)."""
    import torch

    from speechsplit_tpu_torch.training import solver as solver_lib

    saved = (solver_lib.make_train_step, solver_lib.make_f0_train_step)
    record = {"first": None, "starts": [], "end": None}

    def wrap(make):
        def factory(config, *mesh):
            step = make(config, *mesh)

            def run(state, batch):
                if record["first"] is None:
                    record["first"] = train_state_snapshot(state)
                record["starts"].append(time.perf_counter())
                out = step(state, batch)
                if len(record["starts"]) in (1, steps):
                    torch.cuda.synchronize()
                    record["end"] = time.perf_counter()
                return out
            return run
        return factory

    solver_lib.make_train_step = wrap(saved[0])
    solver_lib.make_f0_train_step = wrap(saved[1])
    try:
        yield record
    finally:
        solver_lib.make_train_step, solver_lib.make_f0_train_step = saved


def run_cli_train(args: list, steps: int, per_step: dict, what: str,
                  log_step: int = CLI_SAVE, probe: bool = True):
    """``cli.train.main(args)`` with its stdout kept: the launches of the
    run against ``steps`` x ``per_step``, every logged loss finite.
    ``probe=False`` runs it without ``solver_probe``. Returns (logged
    losses, probe record or None, final train state)."""
    import io

    import numpy as np

    from speechsplit_tpu_torch.cli import train as cli_train

    out = io.StringIO()
    reset_launches()
    with (solver_probe(steps) if probe else contextlib.nullcontext()) as \
            record, contextlib.redirect_stdout(out):
        state = cli_train.main(args)
    launches = read_launches()
    for kernel, count in launches.items():
        want = steps * per_step.get(kernel, 0)
        if count != want:
            fail(f"train.cli {what}: {kernel} launched {count} times in "
                 f"{steps} steps, expected {want}")
    losses = [float(v)
              for v in re.findall(r"loss_id: (\S+),", out.getvalue())]
    if len(losses) != steps // log_step or not np.isfinite(losses).all():
        fail(f"train.cli {what}: logged losses {losses}")
    if record is not None and len(record["starts"]) != steps:
        fail(f"train.cli {what}: {len(record['starts'])} steps, not {steps}")
    return losses, record, state


def bare_step_ms(state, step, batch, reps: int) -> float:
    """Wall ms a step of ``reps`` bare steps on a host batch, after one
    untimed step: a ``torch.cuda.synchronize()`` before the first and
    one after the last, as ``loop_ms`` times the Solver's loop."""
    import torch

    step(state, batch)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / reps


def val_demo(path: str, config) -> None:
    """A two-utterance demo pickle (150 and 190 frames) for validate()."""
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    entries = []
    for i, length in enumerate((150, 190)):
        emb = np.zeros((1, config.dim_spk_emb), np.float32)
        emb[0, 2 + i] = 1.0
        mel = rng.random((length, config.dim_freq), dtype=np.float32)
        f0 = np.where(rng.random(length) < 0.2, 0.0, rng.random(length))
        entries.append([f"p{230 + i}", emb, (mel, f0, length, f"{i:03d}")])
    with open(path, "wb") as handle:
        pickle.dump(entries, handle)


def loop_ms(record: dict) -> float:
    """The loop's wall ms a step of a probed run, the first step left
    out: from the second step's start to the synchronized end of the
    last, over the steps between."""
    return (record["end"] - record["starts"][1]) * 1e3 / (
        len(record["starts"]) - 1)


def trace_busy(path: str) -> tuple[float, float]:
    """(span, device busy) in ms of a ``torch.profiler`` chrome trace:
    the span from its first event's start to its last event's end, and
    the union of its kernels', copies' and fills' device intervals."""
    with open(path) as handle:
        events = [e for e in json.load(handle)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") in (
                        "kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events))
    return span / 1e3, busy / 1e3


def check_prefetch(config) -> None:
    """``prefetch_to_device(device="cuda")``, plain and with
    ``compress=True``, on ``PREFETCH_BATCHES`` seeded host batches: a
    generator train step on each delivered batch, then a spin that
    holds the consumer's stream back while the side stream copies the
    next batches, then a copy of the batch on the consumer's stream,
    before the consumer drops it. Then ``PREFETCH_LARGE_BATCHES``
    batches of ``PREFETCH_LARGE_ROWS`` rows, each copied on the
    consumer's stream as soon as it is delivered. After one synchronize
    every copy equals its host batch bit for bit (in bfloat16 where
    compressed, and ``_upcast_batch`` of it within bfloat16's rounding
    of the host values), in the source's order, and every loss is
    finite. Memory handed to a later copy while the consumer's stream
    still reads it (no ``record_stream``) shows in the first pass, a
    batch read before its copies end (no wait on the event) in the
    large one, each as a copy that differs."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.data.collator import Batch
    from speechsplit_tpu_torch.data.prefetch import prefetch_to_device
    from speechsplit_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )
    from speechsplit_tpu_torch.training.train_step import _upcast_batch

    def large(seed):
        rng = np.random.default_rng(seed)
        rows, t = PREFETCH_LARGE_ROWS, config.max_len_pad
        return Batch(
            mel=rng.random((rows, t, config.dim_freq), dtype=np.float32),
            spk_emb=rng.random((rows, config.dim_spk_emb), dtype=np.float32),
            f0=rng.random((rows, t, 1), dtype=np.float32),
            len_org=rng.integers(1, t + 1, rows).astype(np.int32))

    small = [synthetic_batch(config, SEED + 100 + i)
             for i in range(PREFETCH_BATCHES)]
    big = [large(SEED + 200 + i) for i in range(PREFETCH_LARGE_BATCHES)]
    state = create_train_state(config, SEED, "speechsplit")
    step = make_train_step(config)
    # (compress, host batches, a step and a spin before the read)
    for compress, hosts, stepped in ((False, small, True),
                                     (True, small, True),
                                     (False, big, False)):
        kept = []
        for batch in prefetch_to_device(iter(hosts), device="cuda",
                                        compress=compress):
            loss = torch.zeros((), device="cuda")
            if stepped:
                state, loss = step(state, batch)
                torch.cuda._sleep(PREFETCH_SPIN_CYCLES)
            kept.append((Batch(*(t.clone() for t in batch)), loss))
            del batch
        torch.cuda.synchronize()
        if len(kept) != len(hosts):
            fail(f"train.cli prefetch (compress={compress}): "
                 f"{len(kept)} batches of {len(hosts)}")
        for i, (host, (got, loss)) in enumerate(zip(hosts, kept)):
            for field, g, x in zip(Batch._fields, got, host):
                want = torch.as_tensor(np.asarray(x))
                if compress and want.dtype == torch.float32:
                    want = want.to(torch.bfloat16)
                if not (g.device.type == "cuda" and g.dtype == want.dtype
                        and torch.equal(g.cpu(), want)):
                    fail(f"train.cli prefetch (compress={compress}): batch "
                         f"{i} {field} differs from its host batch")
            if compress:
                for field, u, x in zip(Batch._fields,
                                       _upcast_batch(got, "cuda"), host):
                    x = torch.as_tensor(np.asarray(x)).to(u.dtype)
                    if not (u.cpu() - x).abs().le(2.0 ** -8 * x.abs()).all():
                        fail(f"train.cli prefetch: batch {i} {field} upcast "
                             "is not within bfloat16 rounding of the host")
            if not torch.isfinite(loss):
                fail(f"train.cli prefetch (compress={compress}): batch {i} "
                     f"loss {float(loss)}")
    log("train.cli prefetch", batches=PREFETCH_BATCHES,
        shape=f"B{TRAIN_B}xT{config.max_len_pad}", compress="off,on",
        spin_cycles=PREFETCH_SPIN_CYCLES,
        large_batches=PREFETCH_LARGE_BATCHES,
        large_shape=f"B{PREFETCH_LARGE_ROWS}xT{config.max_len_pad}",
        delivered="equal to the host batches bit for bit, in order")


def check_validate(config, tmp: str, tol: float, what: str = "") -> None:
    """``Solver.validate()`` at ``config`` over a two-utterance demo
    pickle (``val_demo``, written into ``tmp``) against the same call on
    the plain versions: each utterance's mels within ``tol`` (max abs
    error over max abs), the sum-MSE too, and its launches (4
    ``bilstm_infer`` and 1 ``multi_bilstm_infer`` an utterance)."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.training import Solver, SolverConfig

    demo = os.path.join(tmp, "demo.pkl")
    val_demo(demo, config)
    solver = Solver(None, SolverConfig(
        model_save_dir=os.path.join(tmp, "val"), validation_path=demo,
        seed=SEED), config, device="cuda")
    mels = {"kernels": [], "plain": []}

    def keep(kept):
        """``Solver._eval`` that also keeps each utterance's mels."""
        def run(*inputs):
            out = Solver._eval(solver, *inputs)
            kept.append(out.clone())
            return out
        return run

    torch.cuda.synchronize()
    reset_launches()
    solver._eval = keep(mels["kernels"])
    value = solver.validate()
    launches = read_launches()
    expected = {"bilstm_infer": 8, "multi_bilstm_infer": 2}
    for kernel, count in launches.items():
        if count != expected.get(kernel, 0):
            fail(f"train.cli validate{what}: {kernel} launched {count} times, "
                 f"expected {expected.get(kernel, 0)}")
    reset_launches()
    solver._eval = keep(mels["plain"])
    with plain_kernels():
        plain = solver.validate()
    del solver._eval
    if any(read_launches().values()):
        fail(f"train.cli validate{what}: the plain call launched a kernel")
    shape = (1, config.max_len_pad, config.dim_freq)
    if not (len(mels["kernels"]) == len(mels["plain"]) == 2 and all(
            m.shape == shape and bool(torch.isfinite(m).all())
            for m in mels["kernels"])):
        fail(f"train.cli validate{what}: mels "
             f"{[tuple(m.shape) for m in mels['kernels']]}, not 2 "
             f"finite of {shape}")
    mel_errs = [rel_err([g], [w])
                for g, w in zip(mels["kernels"], mels["plain"])]
    err = abs(value - plain) / abs(plain)
    if not (max(mel_errs) <= tol and np.isfinite(value)
            and err <= tol):
        fail(f"train.cli validate{what}: mels' rel err {mel_errs}, sum-MSE "
             f"{value} against plain {plain} (rel err {err}); tol "
             f"{tol}")
    log(f"train.cli validate{what}", utterances=2,
        mel_max_abs_err_over_max_abs=",".join(
            f"{e:.3g}" for e in mel_errs),
        value=repr(value), plain=repr(plain), rel_err=f"{err:.3g}",
        tol=tol,
        launches=json.dumps({k: v for k, v in launches.items() if v})
        .replace(" ", ""))


def phase_train_cli(gen_per_step: dict, f0_per_step: dict) -> None:
    """The trainer through its entry point, at full width: ``cli.train``
    on a seeded feature tree for each model (6 iterations, a checkpoint
    and a log line every 3), then a resume from step 3 into a copy of the
    checkpoints; every checkpoint loads strictly into a fresh model, the
    resumed state before its first step equals the checkpoint's, every
    logged loss is finite, and each run launches its steps x
    ``phase_train``'s count a step of each training kernel. Three runs
    of 30 iterations (no checkpoint) time the loop: its wall ms a step
    over the steps after the first, one synchronize at the end
    (``solver_probe``), each run followed by 30 bare steps on its final
    state timed the same way (in turns). A fourth, of 15 iterations
    under ``--profile_dir`` and without the probe, writes the Solver's
    chrome trace of steps 10-14: the card's busy and idle share of that
    window. Then ``Solver.validate()`` over a two-utterance demo pickle
    against the same call on the plain versions: each utterance's mels
    within ``PATH_TOL`` (max abs error over max abs), the sum-MSE too,
    with its launches; and ``check_prefetch``. Float32, TF32 off, as
    ``phase_train`` compares and times."""
    import shutil

    import numpy as np
    import torch

    from speechsplit_tpu_torch.interop import load_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
    from speechsplit_tpu_torch.training import (
        make_f0_train_step,
        make_train_step,
    )
    from speechsplit_tpu_torch.training import checkpoint as ckpt_lib

    config = float32_config()
    hparams = ("residual_dtype=float32,adam_mu_dtype=float32,"
               "matmul_precision=highest")
    host_batch = synthetic_batch(config, SEED)
    with tempfile.TemporaryDirectory() as tmp, strict_float32("train.cli"):
        root_dir, feat_dir = write_feature_tree(tmp, config, SEED + 3)
        for model, tag, per_step, cls in (
                ("speechsplit", "G", gen_per_step, SpeechSplit),
                ("f0_converter", "P", f0_per_step, F0Converter)):
            run = os.path.join(tmp, f"run_{tag}")
            models = os.path.join(run, "models")
            resumed = os.path.join(run, "resumed")

            def args(save_dir, iters, *extra, save_step=CLI_SAVE,
                     log_step=CLI_SAVE):
                return [
                    "--num_iters", str(iters), "--model_save_dir", save_dir,
                    "--log_step", str(log_step), "--model_save_step",
                    str(save_step), "--sample_step", "1000",
                    "--model", model, "--log_dir", os.path.join(run, "logs"),
                    "--sample_dir", os.path.join(run, "samples"),
                    "--validation_path", os.path.join(tmp, "no_such.pkl"),
                    "--hparams", f"root_dir={root_dir},feat_dir={feat_dir},"
                    + hparams, "--device", "cuda", *extra]

            losses, _, _ = run_cli_train(args(models, CLI_STEPS),
                                         CLI_STEPS, per_step, model)
            for step in (CLI_SAVE, CLI_STEPS):
                path = ckpt_lib.checkpoint_path(models, step, tag)
                cls(config).load_state_dict(load_reference_checkpoint(path),
                                            strict=True)
            shutil.copytree(models, resumed)
            # the resumed run also reads lazily, sends bfloat16 features
            # and keeps only its newest checkpoint
            r_losses, r_record, _ = run_cli_train(
                args(resumed, CLI_STEPS - CLI_SAVE, "--resume_iters",
                     str(CLI_SAVE), "--lazy_data", "--compress_transfers",
                     "--keep_checkpoints", "1"),
                CLI_STEPS - CLI_SAVE, per_step, f"{model} resumed")
            if os.listdir(resumed) != [f"{CLI_STEPS}-{tag}.ckpt"]:
                fail(f"train.cli {model}: the resumed run kept "
                     f"{sorted(os.listdir(resumed))}")
            saved = torch.load(ckpt_lib.checkpoint_path(models, CLI_SAVE, tag),
                               map_location="cpu", weights_only=True)
            if not same_state(r_record["first"], saved):
                fail(f"train.cli {model}: the resumed state before its first "
                     f"step differs from {CLI_SAVE}-{tag}.ckpt")
            bare_step = (make_train_step if tag == "G"
                         else make_f0_train_step)(config)
            rounds, t_losses = [], []
            for r in range(CLI_ROUNDS):
                t_losses, t_record, state = run_cli_train(
                    args(os.path.join(run, f"timed{r}"), CLI_TIMED_STEPS,
                         save_step=10 * CLI_TIMED_STEPS, log_step=10),
                    CLI_TIMED_STEPS, per_step, f"{model} timed", log_step=10)
                rounds.append(dict(
                    loop=loop_ms(t_record),
                    bare=bare_step_ms(state, bare_step, host_batch,
                                      CLI_TIMED_STEPS)))
                del state
            med = {k: float(np.median([t[k] for t in rounds]))
                   for k in rounds[0]}
            traces = os.path.join(run, "trace")
            run_cli_train(
                args(os.path.join(run, "profiled"), CLI_PROFILED_STEPS,
                     "--profile_dir", traces,
                     save_step=10 * CLI_PROFILED_STEPS, log_step=5),
                CLI_PROFILED_STEPS, per_step, f"{model} profiled",
                log_step=5, probe=False)
            if os.listdir(traces) != [f"trace_{CLI_PROFILED_STEPS}.json"]:
                fail(f"train.cli {model}: --profile_dir wrote "
                     f"{os.listdir(traces)}")
            span, busy = trace_busy(os.path.join(
                traces, f"trace_{CLI_PROFILED_STEPS}.json"))
            if not busy > 0:
                fail(f"train.cli {model}: the trace holds no device time")
            log("train.cli", model=model, steps=CLI_STEPS,
                checkpoints=f"{CLI_SAVE}-{tag},{CLI_STEPS}-{tag} strict",
                resumed_from=f"{CLI_SAVE}-{tag} state equal",
                losses=",".join(f"{v:.6f}" for v in losses + r_losses),
                launches_a_step=json.dumps(per_step).replace(" ", ""),
                timed_steps=CLI_TIMED_STEPS,
                timed_losses=",".join(f"{v:.6f}" for v in t_losses),
                rounds=CLI_ROUNDS,
                solver_median_ms_per_step=f"{med['loop']:.4f}",
                bare_in_turns_median_ms=f"{med['bare']:.4f}",
                host_overhead_ms=f"{med['loop'] - med['bare']:.4f}",
                solver_rounds_ms=",".join(f"{t['loop']:.4f}" for t in rounds),
                bare_rounds_ms=",".join(f"{t['bare']:.4f}" for t in rounds),
                solver_above_bare_every_round=(
                    min(t["loop"] for t in rounds)
                    > max(t["bare"] for t in rounds)),
                timing="wall time of the steps after the first, one "
                "synchronize at the end; a Solver run and bare steps in "
                "turns",
                profiled_steps="10-14", trace_span_ms=f"{span:.4f}",
                trace_device_busy_ms=f"{busy:.4f}",
                trace_device_idle_share=f"{1 - busy / span:.4f}",
                trace_note="profiler on, probe off; the profiler's "
                "overhead in the span")
            shutil.rmtree(run)

        check_validate(config, tmp, PATH_TOL)
        check_prefetch(config)


def cudnn_fused_yardstick(x, wi_f, wi_b, b_f, b_b, w_f, w_b):
    """A bidirectional cuDNN ``torch.nn.LSTM(I, H)`` carrying a fused
    layer's real weights (the summed bias as b_ih, b_hh zero): the same
    (h_f, h_b) from the same x. Timed as a yardstick only."""
    import torch

    lstm = torch.nn.LSTM(x.shape[-1], w_f.shape[1],
                         bidirectional=True).to(x.device)
    with torch.no_grad():
        for sfx, wi, b, w in (("l0", wi_f, b_f, w_f),
                              ("l0_reverse", wi_b, b_b, w_b)):
            getattr(lstm, f"weight_ih_{sfx}").copy_(wi)
            getattr(lstm, f"weight_hh_{sfx}").copy_(w)
            getattr(lstm, f"bias_ih_{sfx}").copy_(b)
            getattr(lstm, f"bias_hh_{sfx}").zero_()
    return lstm


def fused_inputs(t: int, b: int, h: int, i: int, seed: int,
                 requires_grad: bool = False):
    """Seeded (x, wi_f, wi_b, b_f, b_b, w_f, w_b) of a fused layer."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        x = torch.randn(*shape, device="cuda", generator=gen) * scale
        return x.requires_grad_(requires_grad)

    return (rand(t, b, i), rand(4 * h, i, scale=i ** -0.5),
            rand(4 * h, i, scale=i ** -0.5), rand(4 * h, scale=0.1),
            rand(4 * h, scale=0.1), rand(4 * h, h, scale=h ** -0.5),
            rand(4 * h, h, scale=h ** -0.5))


def check_fused(b: int, h: int, i: int, kind: str, reps: int) -> dict:
    """A fused kernel (``kind`` "infer": the lean ``bilstm_fused_infer``;
    "fwd": the residual-saving ``bilstm_fused_fwd``) against its plain
    version at one main-path shape, timed beside its bound, the port's
    composed path at the same shape (two ``F.linear`` and the unfused
    kernel) and cuDNN (its forward; for "fwd" also its forward plus one
    ``torch.autograd.grad``)."""
    import torch
    import torch.nn.functional as F

    from speechsplit_tpu_torch.ops import bilstm

    args = fused_inputs(T, b, h, i, SEED + 13 * h + b + i)
    x, wi_f, wi_b, b_f, b_b, w_f, w_b = args
    if kind == "infer":
        kernel = bilstm.bilstm_fused_infer_cuda
        plain = bilstm.bilstm_sequence_fused_reference
        unfused = bilstm.bilstm_infer_cuda
    else:
        kernel = bilstm.bilstm_fused_forward_cuda
        plain = bilstm.bilstm_fused_forward_reference
        unfused = bilstm.bilstm_forward_cuda
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = abs_err(got, want)

    def composed():
        return unfused(F.linear(x, wi_f, b_f), F.linear(x, wi_b, b_b), w_f,
                       w_b)

    ms = time_ms(lambda: kernel(*args), reps)
    composed_ms = time_ms(composed, reps)
    plain_ms = time_ms(lambda: plain(*args), 2, warmup=1)
    lstm = cudnn_fused_yardstick(*args)
    extra = {}
    if kind == "infer":
        with torch.no_grad():
            lib_err = float((lstm(x)[0] - torch.cat(got[:2], -1)).abs().max())
            library_ms = time_ms(lambda: lstm(x), reps)
    else:
        xg = x.detach().clone().requires_grad_(True)
        library_ms = time_ms(lambda: lstm(xg), reps)
        out = lstm(xg)[0]
        lib_err = float((out.detach() - torch.cat(got[:2], -1)).abs().max())
        wrt = (xg, *lstm.parameters())
        grad_ms = time_ms(lambda: torch.autograd.grad(
            out, wrt, torch.ones_like(out), retain_graph=True), reps)
        extra["library_fwd_plus_grad_ms"] = library_ms + grad_ms
    bound_ms, bound_by = lstm_bound(T, b, [h, h], kind, i)
    row = dict(shape=f"T{T}xB{b}xI{i}xH{h}", max_abs_err=err, tol=KERNEL_TOL,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, composed_ms=composed_ms, **extra,
               library_err=lib_err)
    log(f"kernel bilstm_fused_{kind}", **fmt(row))
    if not err <= KERNEL_TOL:
        fail(f"bilstm_fused_{kind} {row['shape']}: max abs err {err} > "
             f"{KERNEL_TOL}")
    return row


def check_fused_edges() -> None:
    """Both fused kernels' other code paths against their plain
    versions on short sequences: batch 1, ragged folds and K-tiles,
    widths not a multiple of 4 or 32, H=1, fold 1 at B=100 H=512, the
    batch-tiled h staging at B=300 H=512, and the largest batch the
    kernels take (``MAX_FUSED_BATCH``, which the kernel source states);
    one more batch row is refused by the kernel itself."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    worst = 0.0
    shapes = ((37, 1, 512, 70), (9, 100, 512, 33), (5, 300, 512, 20),
              (23, 5, 3, 7), (16, 3, 1, 5), (12, 6, 100, 40),
              (3, bilstm.MAX_FUSED_BATCH, 512, 9))
    for n, (t, b, h, i) in enumerate(shapes):
        args = fused_inputs(t, b, h, i, SEED + 77 + n)
        for kernel, plain in (
                (bilstm.bilstm_fused_infer_cuda,
                 bilstm.bilstm_sequence_fused_reference),
                (bilstm.bilstm_fused_forward_cuda,
                 bilstm.bilstm_fused_forward_reference)):
            err = abs_err(kernel(*args), plain(*args))
            if not err <= KERNEL_TOL:
                fail(f"{kernel.__name__} T{t}xB{b}xI{i}xH{h}: max abs err "
                     f"{err}")
            worst = max(worst, err)
    # past the limit: the C entry refuses the launch (the wrapper's
    # check would refuse it first)
    args = fused_inputs(1, bilstm.MAX_FUSED_BATCH + 1, 8, 3, SEED + 99)
    h = torch.empty(1, bilstm.MAX_FUSED_BATCH + 1, 8, device="cuda")
    err = bilstm._library().bilstm_fused_infer_launch(
        *bilstm._fused_pointers(*args), h.data_ptr(), h.data_ptr(),
        bilstm._barrier_word(h).data_ptr(), 1, bilstm.MAX_FUSED_BATCH + 1, 8,
        3, 0, h.device.index or 0, bilstm._stream(h))
    if err == 0:
        fail(f"bilstm_fused_infer took B={bilstm.MAX_FUSED_BATCH + 1}, "
             f"past MAX_FUSED_BATCH")
    log("kernel fused edges", shapes=len(shapes), kernels=2,
        max_abs_err=f"{worst:.3g}", tol=KERNEL_TOL,
        max_batch=bilstm.MAX_FUSED_BATCH,
        refused_batch=bilstm.MAX_FUSED_BATCH + 1)


def check_fused_functions() -> None:
    """``BiLSTMFusedFunction`` on CUDA tensors against autograd through
    the plain loops, same inputs and cotangents; and the dispatch:
    no_grad takes the lean kernel, autograd the Function. Shapes: the mel
    decoder's first and upper layers, the batch-tiled gradient staging
    (B=40 at H=512) and widths that are not a multiple of 32."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    cases = [(T, TRAIN_B, 512, 164), (29, 40, 512, 1024), (29, 3, 100, 70),
             (29, TRAIN_B, 512, 1024), (29, 5, 100, 33)]
    worst = 0.0
    for n, (t, b, h, i) in enumerate(cases):
        inputs = fused_inputs(t, b, h, i, SEED + 31 + n, requires_grad=True)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 41 + n)
        dhs = [torch.randn(t, b, h, device="cuda", generator=gen)
               for _ in (0, 1)]
        reset_launches()
        with torch.no_grad():
            outs = bilstm.bilstm_sequence_fused(*inputs)
        if read_launches()["bilstm_fused_infer"] != 1 or any(
                o.grad_fn for o in outs):
            fail("no_grad did not take bilstm_fused_infer")
        outs = bilstm.bilstm_sequence_fused(*inputs, torch.float32)
        if type(outs[0].grad_fn).__name__ != "BiLSTMFusedFunctionBackward":
            fail(f"autograd did not take BiLSTMFusedFunction: "
                 f"{outs[0].grad_fn}")
        got = torch.autograd.grad(outs, inputs, dhs)
        want = torch.autograd.grad(
            bilstm.bilstm_sequence_fused_reference(*inputs), inputs, dhs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            worst = max(worst, err)
            if not err <= KERNEL_TOL:
                fail(f"T{t}xB{b}xI{i}xH{h}: Function grad vs autograd of "
                     f"the plain loop, rel err {err} > {KERNEL_TOL}")
    log("autograd.Function fused", cases=len(cases),
        grads_rel_err=f"{worst:.3g}", tol=KERNEL_TOL,
        against="autograd through the plain loops")


# the fused kernels' main-path shapes (B, H, I), T=192: the mel decoder's
# three layers, content layer 1, the F0 decoder's two layers; conversion
# runs the generator at 7 rows a pair and the F0 converter (H=256) at one
FUSED_INFER_SHAPES = tuple(
    (7 * FUSED_PAIRS if h != 256 else FUSED_PAIRS, h, i)
    for h, i in ((512, 1024), (512, 164), (8, 16), (256, 512), (256, 66)))
FUSED_FWD_SHAPES = tuple((TRAIN_B, h, i) for _, h, i in FUSED_INFER_SHAPES)


def phase_fused_kernels(reps: int = 10) -> dict:
    """The fused kernels at every main-path shape, their edges and the
    two Functions. Returns the row of each kernel's most expensive
    shape."""
    rows = {}
    with strict_float32(), fusion("auto"):
        for kind, shapes in (("infer", FUSED_INFER_SHAPES),
                             ("fwd", FUSED_FWD_SHAPES)):
            for b, h, i in shapes:
                rows.setdefault(f"bilstm_fused_{kind}",
                                check_fused(b, h, i, kind, reps))
        check_fused_edges()
        check_fused_functions()
    return rows


def phase_convert_fused(reps: int = 10) -> dict:
    """``convert_batched`` at FUSED_PAIRS x 7 conditions with fusion on:
    the launches of one call, the call against the plain call and the
    same call with fusion off, and both timed in turns."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    config = SpeechSplitConfig()
    gen = torch.Generator().manual_seed(SEED)
    g_model = SpeechSplit(config, generator=gen).to("cuda").eval()
    p_model = F0Converter(config, generator=gen).to("cuda").eval()
    pairs = synthetic_pairs(config, FUSED_PAIRS, "cuda", SEED + 2)

    def run():
        return convert_batched(g_model, p_model, pairs, CONDITIONS)

    expected = {"bilstm_fused_infer": 6, "multi_bilstm_infer": 2}
    with fusion("auto"):
        run()  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        result = run()
        launches = read_launches()
    for name, count in launches.items():
        if count != expected.get(name, 0):
            fail(f"fused convert_batched launched {name} {count} times, "
                 f"expected {expected.get(name, 0)}")
    check_conversions(config, pairs, result)

    with strict_float32():
        with fusion("auto"):
            fused = run()
            with plain_kernels():
                plain = run()
        with fusion("off"):
            unfused = run()

    def worst(a, b):
        return max(float(np.abs(x[1] - y[1]).max())
                   for ra, rb in zip(a, b) for x, y in zip(ra, rb))

    err_plain, err_off = worst(fused, plain), worst(fused, unfused)
    if not (err_plain <= PATH_TOL and err_off <= PATH_TOL):
        fail(f"fused convert_batched: max abs err {err_plain} vs plain, "
             f"{err_off} vs fusion off")
    samples = {"auto": [], "off": []}
    with strict_float32("timing"):
        for r in range(reps):
            for mode in ("auto", "off") if r % 2 == 0 else ("off", "auto"):
                with fusion(mode):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    run()  # ends in the device->host fetch of the results
                samples[mode].append((time.perf_counter() - start) * 1e3)
    q = {m: np.percentile(v, [25, 50, 75]) for m, v in samples.items()}
    utts = FUSED_PAIRS * len(CONDITIONS)
    log("convert_batched fused", pairs=FUSED_PAIRS, conditions=len(CONDITIONS),
        generator_batch=utts, calls=reps,
        median_ms_per_call=f"{q['auto'][1]:.4f}", q1_ms=f"{q['auto'][0]:.4f}",
        q3_ms=f"{q['auto'][2]:.4f}",
        utterances_per_s_at_median=f"{utts / q['auto'][1] * 1e3:.2f}",
        unfused_median_ms_per_call=f"{q['off'][1]:.4f}",
        unfused_q1_ms=f"{q['off'][0]:.4f}", unfused_q3_ms=f"{q['off'][2]:.4f}",
        timing="fused and unfused calls in turns",
        max_abs_err_vs_plain=f"{err_plain:.3g}",
        max_abs_err_vs_fusion_off=f"{err_off:.3g}", tol=PATH_TOL,
        tf32="off for the comparisons and the timing",
        launches=json.dumps(launches).replace(" ", ""))
    return launches


def phase_train_fused(batch):
    gen_launches, _, _ = train_phase(
        "generator fused", "speechsplit",
        {"bilstm_fused_fwd": 4, "bilstm_bwd": 4, "multi_bilstm_fwd": 1,
         "multi_bilstm_bwd": 1}, batch, layers="fused")
    f0_launches, _, _ = train_phase(
        "f0_converter fused", "f0_converter",
        {"bilstm_fused_fwd": 2, "bilstm_bwd": 2, "multi_bilstm_fwd": 1,
         "multi_bilstm_bwd": 1}, batch, layers="fused")
    return gen_launches, f0_launches


# the bfloat16 instances of the multi-stream block plans (a call with a
# direction wider than LANE_MAX_H) and of the fused kernels: their entry
# in the JSON record, the kernel whose wrapper launches them, their
# dtypes, and the keys of the instance and of its float32 twin in
# ``ptxas_rows`` (the fused ones at H=512: KQ = 4)
BLOCK_FUSED_BF16_KERNELS = {
    "multi_bilstm_infer/block_bf16_w": (
        "multi_bilstm_infer", "block plan, W bf16 (H >= 2) and f32 (H = 1)",
        "multi_bilstm_infer_kernel<0,f,bf16>", "multi_bilstm_infer_kernel<0>"),
    "multi_bilstm_fwd/block_bf16_resid": (
        "multi_bilstm_fwd", "block plan, W f32, residuals bf16",
        "multi_bilstm_infer_kernel<1,bf16>", "multi_bilstm_infer_kernel<1>"),
    "multi_bilstm_bwd/block_bf16_resid": (
        "multi_bilstm_bwd", "block plan, W f32, residuals bf16",
        "multi_bilstm_bwd_kernel<bf16>", "multi_bilstm_bwd_kernel"),
    "multi_bilstm_fwd/block_bf16_w": (
        "multi_bilstm_fwd", "block plan, W bf16 (H >= 2) and f32, "
        "residuals f32", "multi_bilstm_infer_kernel<1,f,bf16>",
        "multi_bilstm_infer_kernel<1>"),
    "multi_bilstm_bwd/block_bf16_w": (
        "multi_bilstm_bwd", "block plan, W bf16 (H >= 2) and f32, "
        "residuals f32", "multi_bilstm_bwd_kernel<f,bf16>",
        "multi_bilstm_bwd_kernel"),
    "multi_bilstm_fwd/block_bf16_w_bf16_resid": (
        "multi_bilstm_fwd", "block plan, W bf16 (H >= 2) and f32, "
        "residuals bf16", "multi_bilstm_infer_kernel<1,bf16,bf16>",
        "multi_bilstm_infer_kernel<1>"),
    "multi_bilstm_bwd/block_bf16_w_bf16_resid": (
        "multi_bilstm_bwd", "block plan, W bf16 (H >= 2) and f32, "
        "residuals bf16", "multi_bilstm_bwd_kernel<bf16,bf16>",
        "multi_bilstm_bwd_kernel"),
    "bilstm_fused_infer/bf16_w": (
        "bilstm_fused_infer", "x, W_ih, W bf16, h f32",
        "bilstm_fused_kernel<4,0,f,bf16,bf16>", "bilstm_fused_kernel<4,0>"),
    "bilstm_fused_fwd/bf16_resid": (
        "bilstm_fused_fwd", "x, W_ih, W f32, residuals bf16",
        "bilstm_fused_kernel<4,1,bf16>", "bilstm_fused_kernel<4,1>"),
    "bilstm_fused_fwd/bf16_w": (
        "bilstm_fused_fwd", "x, W_ih, W bf16, residuals f32",
        "bilstm_fused_kernel<4,1,f,bf16,bf16>", "bilstm_fused_kernel<4,1>"),
    "bilstm_fused_fwd/bf16_w_bf16_resid": (
        "bilstm_fused_fwd", "x, W_ih, W bf16, residuals bf16",
        "bilstm_fused_kernel<4,1,bf16,bf16,bf16>", "bilstm_fused_kernel<4,1>"),
}
# the bottleneck widths of the [wide bottleneck] phase: the widest the
# multi-stream kernels take (MAX_HIDDEN; its block plans), and one past
# it (each encoder's own layer)
WIDE_NECK = 64
WIDER_NECK = 128
# the sources whose ptxas report gives the new instances' registers
BLOCK_FUSED_SOURCES = ("bilstm_infer", "multi_bilstm_infer",
                       "multi_bilstm_bwd")


def start_codegen(stems) -> list:
    """``nvcc -cubin -Xptxas -v`` of each source in ``stems``, started
    now, one process each (the phases before the report run meanwhile);
    ``finish_codegen`` waits for them."""
    from speechsplit_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    jobs = []
    for stem in stems:
        tmp = tempfile.mkdtemp()
        source = str(_build.CSRC / f"{stem}.cu")
        proc = subprocess.Popen(
            [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
             os.path.join(tmp, "k.cubin"), source],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        jobs.append((stem, tmp, proc))
    return jobs


def finish_codegen(jobs) -> dict:
    """The registers, spill stores and stack frame of every kernel entry
    of the sources ``start_codegen`` compiles, by ``_entry`` key."""
    import shutil

    out = {}
    for stem, tmp, proc in jobs:
        _, err = proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
        if proc.returncode:
            fail(f"ptxas report of {stem}.cu: rc {proc.returncode}\n"
                 f"{err[-2000:]}")
        out.update(ptxas_rows(err))
    return out


def check_block_bf16_resid(b: int, hs, reps: int) -> dict:
    """The block plans at float32 W_hh and bfloat16 residuals (the default
    config's) against their plain versions: ``check_multi_train_bf16``'s
    bars (h and dx within ``PATH_TOL``, g and c within ``BF16_ULPS``);
    their rows, with the plain versions' time and the largest error."""
    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    if max(hs) <= multi_bilstm.LANE_MAX_H:
        fail(f"{hs} runs the lane plan")
    found = check_multi_train_bf16(b, hs, reps)
    xps, ws = multi_inputs(T, b, hs, SEED + 11 * b + len(hs))
    n, d2 = len(hs), 2 * len(hs)
    bf16 = torch.bfloat16
    got = multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws,
                                                 residual_dtype=bf16)
    want = multi_bilstm.multi_bilstm_forward_reference(n, *xps, *ws,
                                                       residual_dtype=bf16)
    dhs = [torch.randn_like(h) for h in want[:d2]]
    dx = multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *want[d2:], *ws)
    dx_ref = multi_bilstm.multi_bilstm_backward_reference(n, *dhs,
                                                          *want[d2:], *ws)
    shape = f"T{T}xB{b}xH{'/'.join(map(str, hs))}"
    rows = {}
    for kernel, plain, err in (
            ("multi_bilstm_fwd", lambda: multi_bilstm.
             multi_bilstm_forward_reference(n, *xps, *ws,
                                            residual_dtype=bf16),
             abs_err(got, want)),
            ("multi_bilstm_bwd", lambda: multi_bilstm.
             multi_bilstm_backward_reference(n, *dhs, *want[d2:], *ws),
             abs_err(dx, dx_ref))):
        f = found[kernel]
        rows[f"{kernel}/block_bf16_resid"] = dict(
            shape=shape, ms=f["bf16_ms"], device_ms=f["bf16_device_ms"],
            plain_ms=time_ms(plain, 1, warmup=0),
            bound_ms=f["bf16_bound_ms"], bound_by=f["bf16_bound_by"],
            max_abs_err=err, **{k: v for k, v in f.items()
                                if k in ("bf16_max_ulps", "bf16_err_h",
                                         "bf16_rel_err")})
    return rows


# (T, B, widths) of the block plans' bfloat16 edges: the MULTI_EDGES cases
# with a width past LANE_MAX_H (widths 33 and 64, alone and mixed with
# lane widths, B 1, 3 and 13: batch tiles of 8 left ragged, T = 1)
BLOCK_EDGES = tuple(c for c in MULTI_EDGES if max(c[2]) > 32) + (
    (4, 9, (33, 64)),)


def check_block_bf16_edges() -> None:
    """The block plans' bfloat16 instances at ``BLOCK_EDGES``: at
    bfloat16 compute (W_hh bfloat16 for H >= 2, float32 for H = 1) the
    lean forward, the residual-saving forward at both residual dtypes and
    the gradient on the plain forward's residuals and on the kernel's
    own, at the flip bar, the float32-W directions at their own; at
    float32 W and bfloat16 residuals the forward and the gradient at
    ``check_bf16_edges``' bars."""
    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    bf16, f32 = torch.bfloat16, torch.float32
    worst = {"share": 0.0, "err": 0.0, "f32": 0.0, "err_h": 0.0,
             "ulps": 0.0, "dx_rel": 0.0}

    def keep(what, got, want, ws):
        errs = check_flips(what, got, want)
        worst["share"] = max(worst["share"], errs["flip_share"])
        worst["err"] = max(worst["err"], errs["max_err_over_max"])
        worst["f32"] = max(worst["f32"],
                           check_f32_directions(what, got, want, ws))

    for t, b, hs in BLOCK_EDGES:
        n, d2 = len(hs), 2 * len(hs)
        xps, ws = compute_multi_inputs(t, b, hs, SEED + 23 * t + b)
        what = f"multi block bf16 compute T{t}xB{b}xH{hs}"
        keep(f"{what} lean", multi_bilstm.multi_bilstm_infer_cuda(n, *xps,
                                                                  *ws),
             multi_bilstm.multi_bilstm_sequence_reference(n, *xps, *ws), ws)
        for rd in (f32, bf16):
            got = multi_bilstm.multi_bilstm_forward_cuda(
                n, *xps, *ws, residual_dtype=rd)
            want = multi_bilstm.multi_bilstm_forward_reference(
                n, *xps, *ws, residual_dtype=rd)
            keep(f"{what} fwd {rd}", got, want, ws)
            dhs = [torch.randn(x.shape, device="cuda") for x in want[:d2]]
            for res in (want[d2:], got[d2:]):
                keep(f"{what} bwd {rd}",
                     multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *res,
                                                             *ws),
                     multi_bilstm.multi_bilstm_backward_reference(
                         n, *dhs, *res, *ws), ws)
        xps, ws = multi_inputs(t, b, hs, SEED + 29 * t + b)
        got = multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws,
                                                     residual_dtype=bf16)
        want = multi_bilstm.multi_bilstm_forward_reference(
            n, *xps, *ws, residual_dtype=bf16)
        dhs = [torch.randn_like(x) for x in want[:d2]]
        rel = [rel_err(multi_bilstm.multi_bilstm_backward_cuda(
                   n, *dhs, *res, *ws),
               multi_bilstm.multi_bilstm_backward_reference(
                   n, *dhs, *res, *ws)) for res in (want[d2:], got[d2:])]
        err_h, ulps = abs_err(got[:d2], want[:d2]), bf16_ulps(got[d2:],
                                                               want[d2:])
        if not (err_h <= PATH_TOL and ulps <= BF16_ULPS
                and max(rel) <= PATH_TOL):
            fail(f"multi block bf16 residuals T{t}xB{b}xH{hs}: h err "
                 f"{err_h}, ulps {ulps}, dx rel err {rel}")
        worst["err_h"] = max(worst["err_h"], err_h)
        worst["ulps"] = max(worst["ulps"], ulps)
        worst["dx_rel"] = max(worst["dx_rel"], *rel)
    log("kernel multi block bf16 edges", shapes=len(BLOCK_EDGES),
        widths="33,64 alone and beside 1-8", batches="1,3,9,13", t_min=1,
        bf16_compute_max_flip_share=f"{worst['share']:.4g}",
        flip_share_tol=COMPUTE_FLIP_SHARE,
        bf16_compute_max_err_over_max=f"{worst['err']:.4g}",
        flip_tol=COMPUTE_FLIP,
        f32_w_max_err_over_max=f"{worst['f32']:.4g}",
        bf16_resid_max_abs_err_h=f"{worst['err_h']:.3g}", h_tol=PATH_TOL,
        bf16_resid_max_ulps=f"{worst['ulps']:.3g}", ulps_tol=BF16_ULPS,
        bf16_resid_dx_rel_err=f"{worst['dx_rel']:.3g}", dx_tol=PATH_TOL)


def fused_compute_inputs(t: int, b: int, h: int, i: int, seed: int,
                         compute):
    """``fused_inputs`` with x, W_ih and W_hh rounded to ``compute`` (the
    biases float32), as the layers hand them to the fused op."""
    args = fused_inputs(t, b, h, i, seed)
    return tuple(a if k in (3, 4) else a.to(compute)
                 for k, a in enumerate(args))


def check_fused_bf16(b: int, h: int, i: int, kind: str, compute, rd,
                     reps: int) -> dict:
    """A bfloat16 instance of a fused kernel (``kind`` "infer": the lean
    one at bfloat16 ``compute``; "fwd": the residual-saving one at
    ``compute`` and residuals ``rd``) against its plain version on the
    same inputs: at bfloat16 compute the flip bar and, on
    ``COMPUTE_SHORT_T`` steps, the rounding check (the plain version at
    float32 x, W_ih and W_hh: the kernel rounds where it rounds); at
    float32 compute every element within its dtype's bar (h 1e-4, g and
    c one bfloat16 ulp). Timed with its device time, the plain version's
    time, the float32 kernel's on the same shape and the bound at these
    bytes. Returns {its name: its row}."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    bf16 = torch.bfloat16
    args = fused_compute_inputs(T, b, h, i, SEED + 13 * h + b + i, compute)
    f32_args = fused_inputs(T, b, h, i, SEED + 13 * h + b + i)
    if kind == "infer":
        name = "bilstm_fused_infer/bf16_w"

        def kernel(a=args):
            return bilstm.bilstm_fused_infer_cuda(*a)

        def plain(a=args):
            return bilstm.bilstm_sequence_fused_reference(*a)
    else:
        name = _fused_name(compute, rd)

        def kernel(a=args):
            return bilstm.bilstm_fused_forward_cuda(*a, residual_dtype=rd)

        def plain(a=args):
            return bilstm.bilstm_fused_forward_reference(*a,
                                                         residual_dtype=rd)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check_dtypes(f"{name} h", got[:2], torch.float32)
    if kind == "fwd":
        check_dtypes(f"{name} g, c", got[2:], rd)
    shape = f"T{T}xB{b}xI{i}xH{h}"
    if compute == bf16:
        errs = check_flips(f"{name} {shape}", got, want)
        short = fused_compute_inputs(COMPUTE_SHORT_T, b, h, i, SEED + b,
                                     compute)
        unrounded = tuple(a.float() for a in short)
        errs.update(check_rounds(f"{name} {shape}", kernel(short),
                                 plain(short), plain(unrounded)))
    else:
        share, worst = flip_stats(got, want)
        if share > 0:
            fail(f"{name} {shape}: {share:.4g} of the elements beyond their "
                 f"bar (tol 0)")
        errs = dict(max_err_over_max=worst, max_abs_err=abs_err(got, want),
                    max_ulps=bf16_ulps(got[2:], want[2:]))
    size = 2 if compute == bf16 else 4
    bound, by = lstm_bound(T, b, [h, h], kind, i,
                           resid_bytes=2 if rd == bf16 else 4,
                           w_bytes=size, proj_bytes=size)

    def twin():
        if kind == "infer":
            return bilstm.bilstm_fused_infer_cuda(*f32_args)
        return bilstm.bilstm_fused_forward_cuda(*f32_args)

    return {name: _compute_row(name, shape, dict(
        ms=time_ms(kernel, reps), device_ms=kernel_device_ms(kernel, reps),
        plain_ms=time_ms(plain, 1, warmup=0),
        float32_twin_device_ms=kernel_device_ms(twin, reps),
        bound_ms=bound, bound_by=by, **errs))}


def check_fused_bf16_edges() -> None:
    """The fused kernels' bfloat16 instances at ``check_fused_edges``'
    shapes (batch 1, ragged folds and K-tiles, widths not a multiple of 4
    or 32, where x and W_ih are staged one value at a time, H=1, fold 1,
    the batch-tiled h, ``MAX_FUSED_BATCH``): the lean one and the
    residual-saving ones at bfloat16 compute at the flip bar, the
    bfloat16-residual one at float32 compute at its dtypes' bars."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = ((37, 1, 512, 70), (9, 100, 512, 33), (5, 300, 512, 20),
              (23, 5, 3, 7), (16, 3, 1, 5), (12, 6, 100, 40),
              (3, bilstm.MAX_FUSED_BATCH, 512, 9))
    worst = {"share": 0.0, "err": 0.0, "f32_resid": 0.0}
    for n, (t, b, h, i) in enumerate(shapes):
        args = fused_compute_inputs(t, b, h, i, SEED + 177 + n, bf16)
        what = f"T{t}xB{b}xI{i}xH{h}"
        cases = [("bilstm_fused_infer bf16", bilstm.bilstm_fused_infer_cuda(
                     *args), bilstm.bilstm_sequence_fused_reference(*args))]
        for rd in (f32, bf16):
            cases.append((f"bilstm_fused_fwd bf16 {rd}",
                          bilstm.bilstm_fused_forward_cuda(*args, rd),
                          bilstm.bilstm_fused_forward_reference(*args, rd)))
        for label, got, want in cases:
            errs = check_flips(f"{label} {what}", got, want)
            worst["share"] = max(worst["share"], errs["flip_share"])
            worst["err"] = max(worst["err"], errs["max_err_over_max"])
        args = fused_inputs(t, b, h, i, SEED + 277 + n)
        got = bilstm.bilstm_fused_forward_cuda(*args, bf16)
        want = bilstm.bilstm_fused_forward_reference(*args, bf16)
        share, err = flip_stats(got, want)
        if share > 0:
            fail(f"bilstm_fused_fwd bf16 residuals {what}: {share:.4g} of "
                 f"the elements beyond their bar (tol 0)")
        worst["f32_resid"] = max(worst["f32_resid"], err)
    log("kernel fused bf16 edges", shapes=len(shapes), instances=4,
        max_flip_share=f"{worst['share']:.4g}",
        flip_share_tol=COMPUTE_FLIP_SHARE,
        max_err_over_max=f"{worst['err']:.4g}", flip_tol=COMPUTE_FLIP,
        f32_compute_bf16_resid_max_err_over_max=(
            f"{worst['f32_resid']:.4g}"),
        f32_compute_tol="h 1e-4, g and c one bfloat16 ulp, every element",
        max_batch=bilstm.MAX_FUSED_BATCH)


def phase_block_fused_kernels(reps: int = 3) -> dict:
    """The bfloat16 instances of the multi-stream block plans and of the
    fused kernels against their plain versions at the main path's shapes
    (the [wide bottleneck] phase's at ``WIDE_NECK``: the generator's
    (8, 64, 1) and the F0 converter's (64, 1) at B16 for training, B28
    and B4 lean; the widest call the kernels take, B13 (64, 3, 1); the
    fused kernels at B16 and B56 I1024 H512) and their edges, each row
    with the registers and spills of the instance and of its float32 twin
    (``ptxas_rows`` of the sources, compiled while the checks run).
    Returns the row of each instance's first shape."""
    rows = {}

    def add(found: dict) -> None:
        for name, row in found.items():
            if name in rows:
                rows[name].setdefault("beside", []).append(
                    {k: row[k] for k in ("shape", "ms", "device_ms",
                                         "bound_ms") if k in row})
            else:
                rows[name] = row

    jobs = start_codegen(BLOCK_FUSED_SOURCES)
    try:
        _block_fused_checks(add, reps)
        codegen = finish_codegen(jobs)
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, row in rows.items():
        key, twin = BLOCK_FUSED_BF16_KERNELS[name][2:]
        for label, k in (("", key), ("float32_twin_", twin)):
            if k not in codegen:
                fail(f"{name}: no ptxas report of {k}")
            for field in ("registers", "spill_stores", "stack_frame"):
                row[label + field] = codegen[k].get(field)
        log(f"codegen {name}", instance=key, twin=twin,
            **{k: row[k] for k in ("registers", "spill_stores",
                                   "stack_frame", "float32_twin_registers",
                                   "float32_twin_spill_stores")},
            device_ms=f"{row.get('device_ms', 0.0):.6g}",
            bound_ms=f"{row['bound_ms']:.6g}")
    return rows


def _block_fused_checks(add, reps: int) -> None:
    """``phase_block_fused_kernels``' checks, each row handed to
    ``add``."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    with strict_float32("block plan and fused bfloat16 instances"):
        for hs in ((8, WIDE_NECK, 1), (WIDE_NECK, 1)):
            add(check_block_bf16_resid(TRAIN_B, hs, reps))
        for b, hs in ((28, (8, WIDE_NECK, 1)), (4, (WIDE_NECK, 1)),
                      (13, (64, 3, 1))):
            add(check_multi_compute(b, hs, reps, plan="block_"))
        for rd in (bf16, f32):
            for hs in ((8, WIDE_NECK, 1), (WIDE_NECK, 1)):
                add(check_multi_compute(TRAIN_B, hs, reps, rd,
                                        plan="block_"))
        check_block_bf16_edges()
        for b in (7 * FUSED_PAIRS, TRAIN_B):
            add(check_fused_bf16(b, 512, 1024, "infer", bf16, None, reps))
        for compute, rd in ((f32, bf16), (bf16, f32), (bf16, bf16)):
            for b in (TRAIN_B, 7 * FUSED_PAIRS):
                add(check_fused_bf16(b, 512, 1024, "fwd", compute, rd, reps))
        check_fused_bf16_edges()


def _fused_name(compute, rd) -> str:
    import torch

    bf16 = torch.bfloat16
    return "bilstm_fused_fwd/" + {(False, True): "bf16_resid",
                                  (True, False): "bf16_w",
                                  (True, True): "bf16_w_bf16_resid"}[
        (compute == bf16, rd == bf16)]


def convert_models(config, base, device: str = "cuda"):
    """Eval models at ``config`` carrying the weights of ``base`` (a
    generator and an F0 converter of the same widths)."""
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    g = SpeechSplit(config).to(device).eval()
    p = F0Converter(config).to(device).eval()
    g.load_state_dict(base[0].state_dict())
    p.load_state_dict(base[1].state_dict())
    return g, p


def check_convert_call(what: str, g, p, pairs, expected: dict,
                       flips: bool) -> dict:
    """One ``convert_batched`` call through ``g`` and ``p``: its launches,
    exactly ``expected``, finite mels cut to their lengths, against the
    same call on the plain versions: every element within ``PATH_TOL``
    (float32), or with ``flips`` (bfloat16 compute) within
    ``COMPUTE_PATH_TOL`` of the plain call's largest magnitude but for at
    most ``COMPUTE_FLIP_SHARE`` of them (``phase_convert_large_compute``'s
    bar: a rounding flipped by a sum taken in another order, or an F0 bin
    picked at a near tie, carried through the later layers). Returns the
    launches, the largest error (over the largest magnitude with
    ``flips``) and the share of elements past the bar."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched

    def run():
        return convert_batched(g, p, pairs, CONDITIONS)

    run()
    torch.cuda.synchronize()
    reset_launches()
    result = run()
    counts = {k: v for k, v in read_launches().items() if v}
    if counts != expected:
        fail(f"convert_batched {what}: launches {counts}, expected "
             f"{expected}")
    check_conversions(g.config, pairs, result)
    with plain_kernels():
        plain = run()
    top = max(float(np.abs(b[1]).max()) for r in plain for b in r)
    scale, bar = (top, COMPUTE_PATH_TOL * top) if flips else (1.0, PATH_TOL)
    past = sum(int((np.abs(a[1] - b[1]) > bar).sum())
               for ra, rb in zip(result, plain) for a, b in zip(ra, rb))
    share = past / sum(b[1].size for r in plain for b in r)
    err = max(float(np.abs(a[1] - b[1]).max())
              for ra, rb in zip(result, plain) for a, b in zip(ra, rb)) / scale
    if not share <= (COMPUTE_FLIP_SHARE if flips else 0.0):
        fail(f"convert_batched {what} vs plain: {share} of the mel elements "
             f"past {bar}; largest error {err}")
    return dict(launches=counts, err=err, share=share)


def turns_ms(calls: dict, reps: int) -> dict:
    """The median wall ms of each of ``calls`` ({label: fn}), run in
    turns, a synchronize before each and after each."""
    import numpy as np
    import torch

    samples = {label: [] for label in calls}
    order = list(calls)
    for r in range(reps):
        for label in order if r % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            start = time.perf_counter()
            calls[label]()
            torch.cuda.synchronize()
            samples[label].append((time.perf_counter() - start) * 1e3)
    return {label: float(np.median(v)) for label, v in samples.items()}


def phase_convert_fused_bf16(reps: int = 6) -> dict:
    """``convert_batched`` at ``FUSED_PAIRS`` x 7 conditions with fusion
    on at bfloat16 compute (``compute_config()``): 6 ``bilstm_fused_infer``
    and 2 ``multi_bilstm_infer`` launches, finite mels, within
    ``check_convert_call``'s flip bar of the plain call, ms a call in
    turns with the same call with fusion off (the composed route at
    bfloat16 compute). Returns the launches."""
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    gen = torch.Generator().manual_seed(SEED)
    base = (SpeechSplit(SpeechSplitConfig(), generator=gen),
            F0Converter(SpeechSplitConfig(), generator=gen))
    g, p = convert_models(compute_config(), base)
    pairs = synthetic_pairs(SpeechSplitConfig(), FUSED_PAIRS, "cuda",
                            SEED + 2)
    with strict_float32("fused bf16 compute conversion"):
        with fusion("auto"):
            found = check_convert_call(
                "fused bf16 compute", g, p, pairs,
                {"bilstm_fused_infer": 6, "multi_bilstm_infer": 2},
                flips=True)

        def call(mode):
            def run():
                with fusion(mode):
                    convert_batched(g, p, pairs, CONDITIONS)
            return run

        ms = turns_ms({"fused": call("auto"), "composed": call("off")}, reps)
    log("convert_batched fused bf16 compute", pairs=FUSED_PAIRS,
        conditions=len(CONDITIONS), generator_batch=7 * FUSED_PAIRS,
        median_ms_per_call=f"{ms['fused']:.4f}",
        composed_median_ms_per_call=f"{ms['composed']:.4f}",
        timing="fused and composed bf16 compute calls in turns, TF32 off",
        max_abs_err_over_max_vs_plain=f"{found['err']:.3g}",
        share_past_tol=f"{found['share']:.4g}", tol=COMPUTE_PATH_TOL,
        share_tol=COMPUTE_FLIP_SHARE,
        launches=json.dumps(found["launches"]).replace(" ", ""))
    return found["launches"]


def phase_train_fused_bf16(batch) -> tuple:
    """Both train steps with fusion on (``route("fused")``) at the default
    config (float32 compute, bfloat16 residuals) and at bfloat16 compute
    at both residual dtypes (``train_precision_phase``): 4 and 2
    ``bilstm_fused_fwd`` launches a step beside the unfused ones' other
    kernels, no plain call, loss and gradients within 2% of the plain
    step (the Functions on their plain versions, the fused forward's
    among them), ms a step in turns. Returns the generator's and the F0
    converter's launches by label."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    checked = {"default": SpeechSplitConfig(),
               "bf16_compute": compute_config(),
               "bf16_compute_f32_resid": compute_config("float32")}
    timed = {"default": checked["default"],
             "bf16_compute": checked["bf16_compute"]}
    out = []
    for name, model, layers in (("generator", "speechsplit", 4),
                                ("f0_converter", "f0_converter", 2)):
        out.append(train_precision_phase(
            f"{name} fused", model,
            {"bilstm_fused_fwd": layers, "bilstm_bwd": layers,
             "multi_bilstm_fwd": 1, "multi_bilstm_bwd": 1}, batch, checked,
            timed, "bf16", reps=6, layers="fused"))
    return tuple(out)


def wide_config(neck: int, **fields):
    """The default config at ``dim_neck_3=neck`` (and ``fields``)."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    return SpeechSplitConfig(dim_neck_3=neck, **fields)


def phase_wide_bottleneck(batch, reps: int = 6) -> dict:
    """Both models at full width with a wide pitch bottleneck. At
    ``dim_neck_3=WIDE_NECK`` (the widest the multi-stream kernels take:
    the block plans): both train steps at the default config and at
    bfloat16 compute at both residual dtypes (``train_precision_phase``:
    one ``multi_bilstm_fwd`` and ``multi_bilstm_bwd`` a step, the merged
    layers' launches as at the default widths, within 2% of the plain
    step; ms a step in turns with the default widths' step); the 4-pair
    conversion at float32 (mels within ``PATH_TOL`` of the plain call)
    and at bfloat16 compute (``check_convert_call``'s flip bar), ms a
    call in turns with the default widths' call; ``cli.train --hparams
    dim_neck_3=WIDE_NECK`` for both models (``CLI_STEPS`` iterations,
    every checkpoint loading strictly into a model of that width). At
    ``WIDER_NECK`` (past the kernels' ``MAX_HIDDEN``: each encoder's own
    layer, no ``multi_bilstm_*`` launch): the 4-pair conversion (11
    ``bilstm_infer``) against the plain call and both default-config
    train steps (7 and 4 ``bilstm_fwd`` and ``bilstm_bwd``). Returns the
    launches of the block plans' instances, by label."""
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
    from speechsplit_tpu_torch.interop import load_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
    from speechsplit_tpu_torch.ops import multi_bilstm
    from speechsplit_tpu_torch.training import checkpoint as ckpt_lib

    if not (multi_bilstm.fits((8, WIDE_NECK, 1))
            and not multi_bilstm.fits((8, WIDER_NECK, 1))):
        fail(f"multi_bilstm.fits: {WIDE_NECK} should fit, {WIDER_NECK} not")
    out = {}
    wide = wide_config(WIDE_NECK)
    checked = {"default": wide,
               "bf16_compute": wide_config(WIDE_NECK,
                                           compute_dtype="bfloat16"),
               "bf16_compute_f32_resid": wide_config(
                   WIDE_NECK, compute_dtype="bfloat16",
                   residual_dtype="float32")}
    timed = {"default": wide, "default_neck_8": SpeechSplitConfig()}
    exact = float32_config().replace(dim_neck_3=WIDE_NECK)
    for name, model, layers in (("generator", "speechsplit", 4),
                                ("f0_converter", "f0_converter", 2)):
        out[model] = train_precision_phase(
            f"{name} wide bottleneck {WIDE_NECK}", model,
            {"bilstm_fwd": layers, "bilstm_bwd": layers,
             "multi_bilstm_fwd": 1, "multi_bilstm_bwd": 1}, batch, checked,
            timed, "wide bottleneck", reps=reps, exact=exact)
    pairs = synthetic_pairs(SpeechSplitConfig(), 4, "cuda", SEED)
    gen = torch.Generator().manual_seed(SEED)
    base = (SpeechSplit(wide, generator=gen), F0Converter(wide, generator=gen))
    lean = {"bilstm_infer": 6, "multi_bilstm_infer": 2}
    fields = {}
    with strict_float32("wide bottleneck conversions"):
        for label, config in (("float32", wide),
                              ("bf16_compute", checked["bf16_compute"])):
            g, p = convert_models(config, base)
            found = check_convert_call(f"wide bottleneck {label}", g, p,
                                       pairs, lean, label != "float32")
            out[f"convert_{label}"] = found["launches"]
            fields[f"{label}_err_vs_plain"] = f"{found['err']:.3g}"
            fields[f"{label}_share_past_tol"] = f"{found['share']:.4g}"
        fields.update(float32_tol=PATH_TOL, bf16_compute_tol=COMPUTE_PATH_TOL,
                      bf16_compute_share_tol=COMPUTE_FLIP_SHARE)
        g, p = convert_models(wide, base)
        gen = torch.Generator().manual_seed(SEED)
        narrow = tuple(m.to("cuda").eval() for m in (
            SpeechSplit(SpeechSplitConfig(), generator=gen),
            F0Converter(SpeechSplitConfig(), generator=gen)))
        ms = turns_ms({
            "neck_64": lambda: convert_batched(g, p, pairs, CONDITIONS),
            "neck_8": lambda: convert_batched(*narrow, pairs, CONDITIONS)},
            reps)
        del narrow
        # past MAX_HIDDEN: every encoder layer on the merged kernels
        wider = wide_config(WIDER_NECK)
        gen = torch.Generator().manual_seed(SEED)
        g, p = convert_models(wider, (SpeechSplit(wider, generator=gen),
                                      F0Converter(wider, generator=gen)))
        found = check_convert_call(f"wide bottleneck {WIDER_NECK}", g, p,
                                   pairs, {"bilstm_infer": 11}, False)
        del g, p
    log(f"convert_batched wide bottleneck {WIDE_NECK}", pairs=4,
        generator_batch=28, **fields,
        median_ms_per_call=f"{ms['neck_64']:.4f}",
        neck_8_median_ms_per_call=f"{ms['neck_8']:.4f}",
        timing="float32 calls at dim_neck_3 64 and 8 in turns, TF32 off",
        launches=json.dumps(lean).replace(" ", ""))
    log(f"convert_batched wide bottleneck {WIDER_NECK}", pairs=4,
        err_vs_plain=f"{found['err']:.3g}", tol=PATH_TOL,
        route="each encoder's own layer (multi_bilstm.fits false)",
        launches=json.dumps(found["launches"]).replace(" ", ""))
    wider_exact = float32_config().replace(dim_neck_3=WIDER_NECK)
    for name, model, layers in (("generator", "speechsplit", 7),
                                ("f0_converter", "f0_converter", 4)):
        train_precision_phase(
            f"{name} wide bottleneck {WIDER_NECK}", model,
            {"bilstm_fwd": layers, "bilstm_bwd": layers}, batch,
            {"default": wider}, {"default": wider}, "wide bottleneck",
            reps=2, exact=wider_exact)
    with tempfile.TemporaryDirectory() as tmp:
        root_dir, feat_dir = write_feature_tree(tmp, SpeechSplitConfig(),
                                                SEED + 5)
        for model, tag, cls in (("speechsplit", "G", SpeechSplit),
                                ("f0_converter", "P", F0Converter)):
            models = os.path.join(tmp, f"models_{tag}")
            args = [
                "--num_iters", str(CLI_STEPS), "--model_save_dir", models,
                "--log_step", str(CLI_SAVE), "--model_save_step",
                str(CLI_SAVE), "--sample_step", "1000", "--model", model,
                "--log_dir", os.path.join(tmp, "logs"),
                "--sample_dir", os.path.join(tmp, "samples"),
                "--validation_path", os.path.join(tmp, "no_such.pkl"),
                "--hparams", f"root_dir={root_dir},feat_dir={feat_dir},"
                f"dim_neck_3={WIDE_NECK}", "--device", "cuda"]
            per_step = {k: v for k, v in out[model]["default"].items() if v}
            losses, _, _ = run_cli_train(args, CLI_STEPS, per_step,
                                         f"{model} dim_neck_3={WIDE_NECK}",
                                         probe=False)
            for step in (CLI_SAVE, CLI_STEPS):
                cls(wide).load_state_dict(load_reference_checkpoint(
                    ckpt_lib.checkpoint_path(models, step, tag)), strict=True)
            log(f"train.cli wide bottleneck {WIDE_NECK}", model=model,
                steps=CLI_STEPS, hparams=f"dim_neck_3={WIDE_NECK}",
                checkpoints=f"{CLI_SAVE}-{tag},{CLI_STEPS}-{tag} strict at "
                f"dim_neck_3={WIDE_NECK}",
                losses=",".join(f"{v:.6f}" for v in losses),
                launches_a_step=json.dumps(per_step).replace(" ", ""))
    return out


def refused_pairs() -> int:
    """The fewest conversion pairs whose rows (7 a pair) the port's plan
    refuses to the merged inference kernel for both the mel decoder
    (H=512) and content layer 1 (H=8): from there on every generator
    BiLSTM layer takes the single-direction route."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS
    from speechsplit_tpu_torch.ops import bilstm

    config = SpeechSplitConfig()
    pairs = 1
    while any(bilstm.merged_bidir_fits(T, len(CONDITIONS) * pairs, h)
              for h in (config.dim_dec_mel, config.dim_neck)):
        pairs += 1
    return pairs


def lstm_inputs(t: int, b: int, h: int, seed: int,
                requires_grad: bool = False):
    """Seeded (xp [t, b, 4h], w [4h, h], dh [t, b, h]) of one direction."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    xp = torch.randn(t, b, 4 * h, device="cuda", generator=gen)
    w = torch.randn(4 * h, h, device="cuda", generator=gen) * h ** -0.5
    dh = torch.randn(t, b, h, device="cuda", generator=gen)
    return (xp.requires_grad_(requires_grad), w.requires_grad_(requires_grad),
            dh)


def cudnn_lstm_yardstick(xp, w):
    """A unidirectional cuDNN ``torch.nn.LSTM(4H, H)`` computing the
    forward direction's h from xp through identity input weights. Timed
    as a yardstick only."""
    import torch

    four_h = xp.shape[-1]
    yard = torch.nn.LSTM(four_h, four_h // 4).to(xp.device)
    with torch.no_grad():
        yard.weight_ih_l0.copy_(torch.eye(four_h, device=xp.device))
        yard.weight_hh_l0.copy_(w)
        yard.bias_ih_l0.zero_()
        yard.bias_hh_l0.zero_()
    return yard


def lean_reference64(xp, w, reverse: bool):
    """The lean forward's plain loop in float64, converting one step of
    xp at a time (no float64 copy of [T, B, 4H], no stacked gates)."""
    import torch

    t_len, batch, four_h = xp.shape
    w64 = w.detach().double()
    h = torch.zeros(batch, four_h // 4, dtype=torch.float64, device=xp.device)
    c = torch.zeros_like(h)
    out = h.new_empty(t_len, batch, four_h // 4)
    for t in range(t_len - 1, -1, -1) if reverse else range(t_len):
        i, f, g, o = (xp[t].detach().double() + h @ w64.t()).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return out


def check_lstm_infer(b: int, h: int, reps: int) -> dict:
    """``lstm_infer`` against its plain version and a float64 run of the
    plain loop in both directions at one main-path shape, timed beside its
    bound, the plain version and a cuDNN unidirectional LSTM (the forward
    direction)."""
    import torch

    from speechsplit_tpu_torch.ops import lstm

    xp, w, _ = lstm_inputs(T, b, h, SEED + 17 * h + b)
    err, err64, plain64, ms = 0.0, 0.0, 0.0, {}
    for reverse in (False, True):
        got = lstm.lstm_infer_cuda(xp, w, reverse)
        want = lstm.lstm_sequence_reference(xp, w, reverse)
        want64 = lean_reference64(xp, w, reverse)
        torch.cuda.synchronize()
        err = max(err, abs_err([got], [want]))
        err64 = max(err64, abs_err([got.double()], [want64]))
        plain64 = max(plain64, abs_err([want.double()], [want64]))
        del got, want, want64
        ms[reverse] = time_ms(lambda: lstm.lstm_infer_cuda(xp, w, reverse),
                              reps, warmup=1)
    plain_ms = time_ms(lambda: lstm.lstm_sequence_reference(xp, w, False), 1,
                       warmup=1)
    yard = cudnn_lstm_yardstick(xp, w)
    with torch.no_grad():
        lib_err = float((yard(xp)[0] - lstm.lstm_infer_cuda(xp, w, False))
                        .abs().max())
        library_ms = time_ms(lambda: yard(xp), reps, warmup=1)
    del yard
    bound_ms, bound_by = lstm_bound(T, b, [h])
    row = dict(shape=f"T{T}xB{b}xH{h}", max_abs_err=err, tol=KERNEL_TOL,
               max_abs_err_vs_float64=err64, plain_vs_float64=plain64,
               ms=ms[False], reverse_ms=ms[True], plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               library_err=lib_err,
               plan="narrow" if h <= lstm.NARROW_MAX_H else "wide")
    log("kernel lstm_infer", **fmt(row),
        faster_than_plain_and_library=max(ms.values()) < min(plain_ms,
                                                              library_ms))
    if not max(err, err64) <= KERNEL_TOL:
        fail(f"lstm_infer {row['shape']}: max abs err {err} (float64: "
             f"{err64}) > {KERNEL_TOL}")
    return row


# the lean kernel's width sweep (phase 12), at phase 13's batch
LSTM_SWEEP_WIDTHS = (8, 32, 64, 128, 256, 512)


def check_lstm_plans(big: int, reps: int) -> list:
    """``lstm_infer`` in each plan where it runs, against the plain version
    (forward direction) and timed beside the bound, at batch ``big`` over
    ``LSTM_SWEEP_WIDTHS``: the narrow plan up to the source's border
    (``kNarrowMaxH``, the widest it holds), the wide plan at every width.
    The border is read off this sweep."""
    from speechsplit_tpu_torch.ops import lstm

    rows = []
    for h in LSTM_SWEEP_WIDTHS:
        xp, w, _ = lstm_inputs(T, big, h, SEED + 29 * h + big)
        want = lstm.lstm_sequence_reference(xp, w, False)
        plans = ("narrow", "wide") if h <= lstm.NARROW_MAX_H else ("wide",)
        row = dict(shape=f"T{T}xB{big}xH{h}", auto=plans[0])
        err = 0.0
        for plan in plans:
            def run():
                return lstm._lstm_infer_plan(xp, w, False, plan)

            err = max(err, abs_err([run()], [want]))
            row[f"{plan}_ms"] = time_ms(run, reps, warmup=1)
        row.update(max_abs_err=err, tol=KERNEL_TOL)
        row["bound_ms"], row["bound_by"] = lstm_bound(T, big, [h])
        log("kernel lstm_infer plans", **fmt(row))
        if not err <= KERNEL_TOL:
            fail(f"lstm_infer plans {row['shape']}: max abs err {err}")
        rows.append(row)
        del xp, w, want
    return rows


def check_merged_vs_single(h: int, batches, reps: int) -> list:
    """The merged ``bilstm_infer`` beside two ``lstm_infer`` launches
    (forward and reverse) on the same inputs at width h, at each batch of
    ``batches`` and at the largest batch the merged kernel holds: what
    each route costs where both hold the batch."""
    from speechsplit_tpu_torch.ops import bilstm, lstm

    rows = []
    for b in (*batches, bilstm.merged_max_batch(h)):
        xp_f, w_f, _ = lstm_inputs(T, b, h, SEED + 61)
        xp_b, w_b, _ = lstm_inputs(T, b, h, SEED + 62)

        def merged():
            return bilstm.bilstm_infer_cuda(xp_f, xp_b, w_f, w_b)

        def single():
            return (lstm.lstm_infer_cuda(xp_f, w_f, False),
                    lstm.lstm_infer_cuda(xp_b, w_b, True))

        err = abs_err(single(), merged())
        row = dict(shape=f"T{T}xB{b}xH{h}",
                   merged_ms=time_ms(merged, reps, warmup=1),
                   single_pair_ms=time_ms(single, reps, warmup=1),
                   max_abs_err_between=err, tol=KERNEL_TOL)
        log("kernel bilstm_infer against two lstm_infer", **fmt(row))
        if not err <= KERNEL_TOL:
            fail(f"lstm_infer pair vs bilstm_infer at B{b}: max abs err "
                 f"{err}")
        rows.append(row)
        del xp_f, xp_b
    return rows


def check_lstm_train(b: int, h: int, reps: int) -> dict:
    """``lstm_fwd`` and ``lstm_bwd`` against their plain versions in both
    directions (the gradient kernel on the plain forward's residuals),
    timed beside their bounds, the plain versions, cuDNN's unidirectional
    training forward and backward, and the merged kernels' time for both
    directions at the same shape; both kernels also by their device time
    (``kernel_device_ms``), cuDNN's forward by the profiler's
    (``profiled_device_ms``: it synchronises)."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm, lstm

    xp, w, dh = lstm_inputs(T, b, h, SEED + 19 * h + b)
    errs = dict(err_h=0.0, err_g=0.0, err_c=0.0, err_dx=0.0, err_dx_rel=0.0)
    for reverse in (False, True):
        got = lstm.lstm_forward_cuda(xp, w, reverse)
        want = lstm.lstm_direction_forward_reference(xp, w, reverse)
        dx = lstm.lstm_backward_cuda(dh, want[1], want[2], w, reverse)
        dx_ref = lstm.lstm_direction_backward_reference(dh, want[1], want[2],
                                                        w, reverse)
        torch.cuda.synchronize()
        for key, value in (("err_h", abs_err(got[:1], want[:1])),
                           ("err_g", abs_err(got[1:2], want[1:2])),
                           ("err_c", abs_err(got[2:], want[2:])),
                           ("err_dx", abs_err([dx], [dx_ref])),
                           ("err_dx_rel", rel_err([dx], [dx_ref]))):
            errs[key] = max(errs[key], value)
    _, g, c = lstm.lstm_direction_forward_reference(xp, w, False)
    fwd_ms = time_ms(lambda: lstm.lstm_forward_cuda(xp, w, False), reps)
    bwd_ms = time_ms(lambda: lstm.lstm_backward_cuda(dh, g, c, w, False),
                     reps)
    fwd_device_ms = kernel_device_ms(
        lambda: lstm.lstm_forward_cuda(xp, w, False), reps)
    bwd_device_ms = kernel_device_ms(
        lambda: lstm.lstm_backward_cuda(dh, g, c, w, False), reps)
    plain_fwd_ms = time_ms(lambda: lstm.lstm_direction_forward_reference(
        xp, w, False), 2, warmup=1)
    plain_bwd_ms = time_ms(lambda: lstm.lstm_direction_backward_reference(
        dh, g, c, w, False), 2, warmup=1)
    yard = cudnn_lstm_yardstick(xp, w)
    x = xp.detach().clone().requires_grad_(True)
    lib_fwd_ms = time_ms(lambda: yard(x), reps)
    lib_fwd_device_ms, lib_fwd_device_by = profiled_device_ms(
        lambda: yard(x), reps)
    out = yard(x)[0]
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (x, yard.weight_hh_l0), dh, retain_graph=True), reps)
    merged_fwd_ms = time_ms(lambda: bilstm.bilstm_forward_cuda(xp, xp, w, w),
                            reps)
    merged_bwd_ms = time_ms(lambda: bilstm.bilstm_backward_cuda(
        dh, dh, g, g, c, c, w, w), reps)
    fwd_bound, fwd_by = lstm_bound(T, b, [h], "fwd")
    bwd_bound, bwd_by = lstm_bound(T, b, [h], "bwd")
    shape = f"T{T}xB{b}xH{h}"
    fwd = dict(shape=shape, max_abs_err=max(errs["err_h"], errs["err_g"],
                                            errs["err_c"]),
               tol=KERNEL_TOL, ms=fwd_ms, device_ms=fwd_device_ms,
               plain_ms=plain_fwd_ms, bound_ms=fwd_bound, bound_by=fwd_by,
               library_ms=lib_fwd_ms, library_device_ms=lib_fwd_device_ms,
               library_device_by=lib_fwd_device_by, plan="narrow" if h <= lstm.NARROW_MAX_H else "wide",
               merged_both_directions_ms=merged_fwd_ms)
    bwd = dict(shape=shape, max_abs_err=errs["err_dx"],
               rel_err=errs["err_dx_rel"], tol=KERNEL_TOL, ms=bwd_ms,
               device_ms=bwd_device_ms, plain_ms=plain_bwd_ms,
               bound_ms=bwd_bound, bound_by=bwd_by, library_ms=lib_bwd_ms,
               library_fwd_plus_bwd_ms=lib_fwd_ms + lib_bwd_ms,
               merged_both_directions_ms=merged_bwd_ms)
    log("kernel lstm_fwd", **fmt({**fwd, **{k: errs[k] for k in (
        "err_h", "err_g", "err_c")}}))
    log("kernel lstm_bwd", **fmt(bwd))
    for name in ("err_h", "err_g", "err_c", "err_dx_rel"):
        if not errs[name] <= KERNEL_TOL:
            fail(f"lstm training kernels {shape}: {name} {errs[name]} > "
                 f"{KERNEL_TOL}")
    return {"lstm_fwd": fwd, "lstm_bwd": bwd}


def check_content_routes(reps: int) -> dict:
    """Content layer 1 (H8) of a generator train step (B16) on either
    route, by the device time of its kernels: two ``lstm_fwd`` and two
    ``lstm_bwd`` (the single-direction route) against ``bilstm_fwd`` and
    ``bilstm_bwd`` (merged), on the same inputs; each route's outputs
    against the other's."""
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.ops import bilstm, lstm

    h = SpeechSplitConfig().dim_neck
    xp_f, w_f, dh_f = lstm_inputs(T, TRAIN_B, h, SEED + 71)
    xp_b, w_b, dh_b = lstm_inputs(T, TRAIN_B, h, SEED + 72)
    fwd = bilstm.bilstm_forward_reference(xp_f, xp_b, w_f, w_b)
    res = fwd[2:]  # g_f, g_b, c_f, c_b

    def single():
        return (*lstm.lstm_forward_cuda(xp_f, w_f, False),
                *lstm.lstm_forward_cuda(xp_b, w_b, True),
                lstm.lstm_backward_cuda(dh_f, res[0], res[2], w_f, False),
                lstm.lstm_backward_cuda(dh_b, res[1], res[3], w_b, True))

    def merged():
        h_f, h_b, g_f, g_b, c_f, c_b = bilstm.bilstm_forward_cuda(
            xp_f, xp_b, w_f, w_b)
        dx = bilstm.bilstm_backward_cuda(dh_f, dh_b, *res, w_f, w_b)
        return (h_f, g_f, c_f, h_b, g_b, c_b, *dx)

    err = abs_err(single(), merged())
    torch.cuda.synchronize()
    row = dict(shape=f"T{T}xB{TRAIN_B}xH{h}",
               single_device_ms=kernel_device_ms(single, reps),
               merged_device_ms=kernel_device_ms(merged, reps),
               max_abs_err_between=err, tol=KERNEL_TOL)
    log("content layer 1 routes", **fmt(row),
        single="2 lstm_fwd + 2 lstm_bwd", merged="bilstm_fwd + bilstm_bwd")
    if not err <= KERNEL_TOL:
        fail(f"content layer 1 routes: max abs err {err}")
    return row


def check_lstm_edges() -> None:
    """The three kernels' other code paths against their plain versions,
    both directions, on short sequences: T=1, B=1, batches that are not a
    multiple of the lean kernel's row tiles (B=300 at H=512, 77 at H=8)
    and fill the training kernels' batch-tiled staging, widths not a
    multiple of 4 or 32 or of a plan's units (H=1, 3, 100, 130, 257: the
    training kernels' wide plans at 1, 2 and 4 units a block), the plan
    borders (the lean kernel's ``kNarrowMaxH``, ``lstm_fwd``'s and the
    gradient's ``kLaneMaxH``, all 32) and one on either side, the
    training kernels' own batch limits, which their sources state (one
    more row raises in the wrapper and is refused by the kernel itself,
    at H=8 and at H=512), and the
    lean kernel past them (B=16384, which only it takes). Both the kernel
    and the plain version are also held against a float64 run of the
    plain loop on the same inputs (the gradient on the same float32
    residuals), which shows how much of their difference each one's
    float32 rounding makes."""
    import ctypes

    import torch

    from speechsplit_tpu_torch.ops import lstm

    border = lstm.NARROW_MAX_H
    # every shape runs lstm_infer; lstm_fwd and lstm_bwd where they take
    # the batch
    shapes = ((1, TRAIN_B, 512), (1, 5, 8), (37, 1, 512), (13, 1, 8),
              (5, 300, 512), (7, 77, 8), (23, 5, 3), (16, 3, 1),
              (12, 6, 100), (7, 9, 130), (9, 7, 257), (11, 33, border - 1),
              (11, 33, border), (11, 33, border + 1),
              (3, lstm.MAX_BWD_BATCH, 512),
              (3, lstm.MAX_FWD_BATCH, 512), (3, lstm.MAX_FWD_BATCH, 8),
              (2, 16384, 512), (2, 16384, 8))

    def f64(tensors):
        return [x.double() for x in tensors]

    worst = {name: (0.0, "") for name in LSTM_KERNELS}
    # against float64: (the kernel's max abs err, the plain version's)
    exact = {name: (0.0, 0.0) for name in LSTM_KERNELS}
    for n, (t, b, h) in enumerate(shapes):
        xp, w, dh = lstm_inputs(t, b, h, SEED + 83 + n)
        for reverse in (False, True):
            want = lstm.lstm_direction_forward_reference(xp, w, reverse)
            want64 = lstm.lstm_direction_forward_reference(
                xp.double(), w.double(), reverse)
            got = {"lstm_infer": (
                       [lstm.lstm_infer_cuda(xp, w, reverse)], want[:1],
                       want64[:1])}
            if b <= lstm.MAX_FWD_BATCH:
                got["lstm_fwd"] = (lstm.lstm_forward_cuda(xp, w, reverse),
                                   want, want64)
            if b <= lstm.MAX_BWD_BATCH:
                res = (dh, want[1], want[2], w)
                got["lstm_bwd"] = (
                    [lstm.lstm_backward_cuda(*res, reverse)],
                    [lstm.lstm_direction_backward_reference(*res, reverse)],
                    [lstm.lstm_direction_backward_reference(*f64(res),
                                                            reverse)])
            torch.cuda.synchronize()
            errs = {}
            for name, (kernel, plain, ref64) in got.items():
                errs[name] = abs_err(kernel, plain)
                exact[name] = (
                    max(exact[name][0], abs_err(f64(kernel), ref64)),
                    max(exact[name][1], abs_err(f64(plain), ref64)))
            del got, want, want64
            if not max(errs.values()) <= KERNEL_TOL or not (
                    exact["lstm_infer"][0] <= KERNEL_TOL):
                fail(f"lstm kernels T{t}xB{b}xH{h} reverse={reverse}: max "
                     f"abs errs {errs}, lstm_infer against float64 "
                     f"{exact['lstm_infer'][0]}")
            for name, err in errs.items():
                if err > worst[name][0]:
                    worst[name] = (err, f"T{t}xB{b}xH{h}"
                                        f"{'r' if reverse else 'f'}")
    # one row past each training kernel's limit (at each plan's width):
    # the wrapper raises, naming the limit, and the C entry refuses the
    # launch
    lib, bwd_lib = lstm._library(), lstm._bwd_library()

    def fwd_wrapper(xp, w, dh):
        return lstm.lstm_forward_cuda(xp, w, False)

    def bwd_wrapper(xp, w, dh):
        return lstm.lstm_backward_cuda(dh, xp, dh, w, False)

    # each C entry takes its pointers (six, the gradient's seven), then T,
    # B, H, reverse, its dtype codes (three, the gradient's two), the
    # device
    for name, limit, h, wrapper, launch, ptrs, codes in (
            ("lstm_fwd", lstm.MAX_FWD_BATCH, 8, fwd_wrapper,
             lib.lstm_fwd_launch, 6, 3),
            ("lstm_fwd", lstm.MAX_FWD_BATCH, 512, fwd_wrapper,
             lib.lstm_fwd_launch, 6, 3),
            ("lstm_bwd", lstm.MAX_BWD_BATCH, 8, bwd_wrapper,
             bwd_lib.lstm_bwd_launch, 7, 2),
            ("lstm_bwd", lstm.MAX_BWD_BATCH, 512, bwd_wrapper,
             bwd_lib.lstm_bwd_launch, 7, 2)):
        xp, w, dh = lstm_inputs(1, limit + 1, h, SEED + 97)
        try:
            wrapper(xp, w, dh)
        except ValueError as err:
            if f"B <= {limit}" not in str(err):
                fail(f"{name} at B={limit + 1} H={h}: {err}")
        else:
            fail(f"{name} took B={limit + 1} at H={h}, past its limit "
                 f"{limit}")
        # the kernel refuses before it reads a pointer
        code = launch(*[xp.data_ptr()] * ptrs, 1, limit + 1, h, 0,
                      *[0] * codes, 0, ctypes.c_void_p(lstm._stream(xp)))
        if code == 0:
            fail(f"the {name} kernel took B={limit + 1} at H={h}")
        del xp, w, dh
    log("kernel lstm edges", shapes=len(shapes), kernels=3, directions=2,
        **{f"{name}_max_abs_err": f"{err:.3g}@{shape}"
           for name, (err, shape) in worst.items()},
        **{f"{name}_vs_float64": f"{k:.3g}/plain:{p:.3g}"
           for name, (k, p) in exact.items()}, tol=KERNEL_TOL,
        plan_border=border, max_fwd_batch=lstm.MAX_FWD_BATCH,
        max_bwd_batch=lstm.MAX_BWD_BATCH,
        refused_batches=f"{lstm.MAX_FWD_BATCH + 1}(fwd,H8,H512),"
                        f"{lstm.MAX_BWD_BATCH + 1}(bwd,H8,H512)")


def check_lstm_functions() -> None:
    """``LSTMFunction`` on CUDA tensors against autograd through the plain
    loop, same inputs and cotangents, both directions; and the dispatch:
    no_grad takes the lean kernel, autograd the Function. Shapes: the
    train step's mel-decoder direction, batch-tiled gradient staging
    (B=40 at H=512) and widths not a multiple of 32 or of the units a
    block."""
    import torch

    from speechsplit_tpu_torch.ops import lstm

    cases = ((T, TRAIN_B, 512), (29, 40, 512), (29, 3, 100), (29, 5, 1),
             (29, 13, 257))
    worst = 0.0
    for n, (t, b, h) in enumerate(cases):
        xp, w, dh = lstm_inputs(t, b, h, SEED + 53 + n, requires_grad=True)
        for reverse in (False, True):
            reset_launches()
            with torch.no_grad():
                out = lstm.lstm_sequence(xp, w, reverse)
            if read_launches()["lstm_infer"] != 1 or out.grad_fn:
                fail("no_grad did not take lstm_infer")
            out = lstm.lstm_sequence(xp, w, reverse, torch.float32)
            if type(out.grad_fn).__name__ != "LSTMFunctionBackward":
                fail(f"autograd did not take LSTMFunction: {out.grad_fn}")
            got = torch.autograd.grad(out, (xp, w), dh)
            want = torch.autograd.grad(
                lstm.lstm_sequence_reference(xp, w, reverse), (xp, w), dh)
            torch.cuda.synchronize()
            for g, r in zip(got, want):
                err = rel_err([g], [r])
                worst = max(worst, err)
                if not err <= KERNEL_TOL:
                    fail(f"T{t}xB{b}xH{h} reverse={reverse}: LSTMFunction "
                         f"grad vs autograd of the plain loop, rel err {err}")
    log("autograd.Function lstm", cases=2 * len(cases),
        grads_rel_err=f"{worst:.3g}", tol=KERNEL_TOL,
        against="autograd through the plain loop")


def phase_lstm_kernels(reps: int = 2) -> dict:
    """The single-direction kernels at the shapes phases 13 and 14 give
    them, their edges and the Function, content layer 1 on either route, and the merged kernel beside them up to its
    batch limit. Returns the row of each kernel's most expensive
    main-path shape."""
    import gc

    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS

    config = SpeechSplitConfig()
    rows = {}
    with strict_float32():
        check_lstm_edges()
        check_lstm_functions()
        for b, h in ((TRAIN_B, config.dim_dec_mel),
                     (TRAIN_B, config.dim_dec_f0),
                     (TRAIN_B, config.dim_neck)):
            for name, row in check_lstm_train(b, h, 10).items():
                rows.setdefault(name, dict(row, widths={}))["widths"][h] = {
                    k: row[k] for k in ("ms", "device_ms", "bound_ms",
                                        "library_ms")}
        rows["lstm_fwd"]["content_layer_routes"] = check_content_routes(10)
        big = len(CONDITIONS) * refused_pairs()
        rows["lstm_infer"] = check_lstm_infer(big, config.dim_dec_mel, reps)
        rows["lstm_infer"]["at_content_width"] = check_lstm_infer(
            big, config.dim_neck, reps)
        rows["lstm_infer"]["plans"] = check_lstm_plans(big, reps)
        rows["lstm_infer"]["merged_vs_single"] = check_merged_vs_single(
            config.dim_dec_mel, (28, 56, 112, 224, 512, 1024, 2048), reps)
        rows["lstm_infer"]["merged_vs_single_h256"] = check_merged_vs_single(
            config.dim_dec_f0, (4, 16, 112, 224, 731), reps)
        rows["lstm_infer"]["merged_vs_single_h8"] = check_merged_vs_single(
            config.dim_neck, (28, 224), reps)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_convert_large(reps: int = 3) -> dict:
    """``convert_batched`` at the fewest pairs whose generator batch the
    merged kernels refuse (:func:`refused_pairs`): the launches of one
    call, the call against the plain call, the time of a few calls, and
    one call under ``torch.profiler``."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    n_pairs = refused_pairs()
    config = SpeechSplitConfig()
    gen = torch.Generator().manual_seed(SEED)
    g_model = SpeechSplit(config, generator=gen).to("cuda").eval()
    p_model = F0Converter(config, generator=gen).to("cuda").eval()
    pairs = synthetic_pairs(config, n_pairs, "cuda", SEED + 3)

    def run():
        return convert_batched(g_model, p_model, pairs, CONDITIONS)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # the mel decoder's 3 layers and content layer 1 one direction a
    # launch; the F0 decoder (batch n_pairs) stays merged
    expected = {"lstm_infer": 8, "bilstm_infer": 2, "multi_bilstm_infer": 2}
    run()  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    result = run()
    launches = read_launches()
    for name, count in launches.items():
        if count != expected.get(name, 0):
            fail(f"convert_batched at {n_pairs} pairs launched {name} "
                 f"{count} times, expected {expected.get(name, 0)}")
    check_conversions(config, pairs, result)
    del result
    free()
    with strict_float32():
        torch.cuda.reset_peak_memory_stats()
        exact = run()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        free()
        torch.cuda.reset_peak_memory_stats()
        with plain_kernels():
            plain = run()
        plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    err = max(float(np.abs(a[1] - b[1]).max())
              for ra, rb in zip(exact, plain) for a, b in zip(ra, rb))
    del exact, plain
    free()
    if not err <= PATH_TOL:
        fail(f"convert_batched at {n_pairs} pairs, kernels vs plain: max abs "
             f"err {err}")
    samples = []
    with strict_float32("timing"):
        for _ in range(reps):
            torch.cuda.synchronize()
            start = time.perf_counter()
            run()  # ends in the device->host fetch of the results
            samples.append((time.perf_counter() - start) * 1e3)
    q1, ms, q3 = np.percentile(samples, [25, 50, 75])
    utts = n_pairs * len(CONDITIONS)
    log("convert_batched large", pairs=n_pairs, conditions=len(CONDITIONS),
        generator_batch=utts, f0_batch=n_pairs, calls=reps,
        median_ms_per_call=f"{ms:.4f}", q1_ms=f"{q1:.4f}", q3_ms=f"{q3:.4f}",
        utterances_per_s_at_median=f"{utts / ms * 1e3:.2f}",
        max_abs_err_vs_plain=f"{err:.3g}", tol=PATH_TOL,
        peak_gb=f"{peak_gb:.2f}", plain_peak_gb=f"{plain_peak_gb:.2f}",
        tf32="off for the comparison and the timing",
        launches=json.dumps(launches).replace(" ", ""))
    with strict_float32("profile"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
    profile_events("profile large", prof, wall_ms, top=14)
    del g_model, p_model, pairs, prof
    free()
    return launches


STREAM_BATCHES = 24  # of STREAM_PAIRS pairs (BENCHMARKS.md:83's stream)
STREAM_PAIRS = 8
STREAM_LARGE_BATCHES = 3  # of refused_pairs() pairs
STREAM_DEPTH = 2


def _flat_results(results) -> list:
    return [(name, mel) for pair in results for name, mel in pair]


def _same_yields(what: str, got, want) -> float:
    """0 where every yield equals its ``convert_batched`` result bit for
    bit; else the largest difference (failing past ``PATH_TOL``)."""
    import numpy as np

    worst = 0.0
    for g, w in zip(got, want, strict=True):
        for (gn, gm), (wn, wm) in zip(_flat_results(g), _flat_results(w),
                                      strict=True):
            if gn != wn or gm.shape != wm.shape:
                fail(f"{what}: yield {gn} {gm.shape} against {wn} "
                     f"{wm.shape}")
            if not np.array_equal(gm, wm):
                worst = max(worst, float(np.abs(gm - wm).max()))
    if worst:
        log(what, not_bit_equal=True, max_abs_diff=f"{worst:.3g}",
            reason="yields differ from convert_batched's")
        if not worst <= PATH_TOL:
            fail(f"{what}: max abs diff {worst} past {PATH_TOL}")
    return worst


def _kernel_idle_share(prof, wall_ms: float) -> tuple:
    """The card's idle share of a profiled window counted by its kernels
    (a copy on the copy stream runs beside them), and the copies' ms."""
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)
              and device_us(e) > 0]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernel_ms = sum(device_us(e) for e in events
                    if e not in copies) / 1e3
    copy_ms = sum(device_us(e) for e in copies) / 1e3
    if not events:
        return None, None
    return max(0.0, 1 - kernel_ms / wall_ms), copy_ms


def phase_convert_stream(reps: int = 3) -> dict:
    """``convert_stream`` at full width, float32 with TF32 off: its yields
    against ``convert_batched``, its launches, its compressed and auto
    modes, whether a submit waits for the card, the card's idle share,
    the large grid's fetch, and utterances/s against a loop of
    ``convert_batched`` in turns (see the module docstring, phase 23)."""
    import gc
    import warnings

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speechsplit_tpu_torch import convert as conv
    from speechsplit_tpu_torch import linkprobe
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    wall = time.perf_counter()
    config = SpeechSplitConfig()
    gen = torch.Generator().manual_seed(SEED)
    g_model = SpeechSplit(config, generator=gen).to("cuda").eval()
    p_model = F0Converter(config, generator=gen).to("cuda").eval()
    large_pairs = refused_pairs()
    # the large batches: one set of pairs, rotated a batch, so that every
    # grid differs (a reused host buffer would show) at a third of the
    # host's preparation
    large = synthetic_pairs(config, large_pairs, "cuda", SEED + 200)
    sizes = {
        STREAM_PAIRS: [synthetic_pairs(config, STREAM_PAIRS, "cuda",
                                       SEED + 100 + k)
                       for k in range(STREAM_BATCHES)],
        large_pairs: [large[k:] + large[:k]
                      for k in range(STREAM_LARGE_BATCHES)],
    }
    log("convert stream inputs", pairs=f"{STREAM_PAIRS},{large_pairs}",
        seconds=f"{time.perf_counter() - wall:.1f}")
    expected_large = {"lstm_infer": 8, "bilstm_infer": 2,
                      "multi_bilstm_infer": 2}

    def loop(batches, **kw):
        return [conv.convert_batched(g_model, p_model, b, **kw)
                for b in batches]

    def stream(batches, **kw):
        return list(conv.convert_stream(g_model, p_model, batches,
                                        depth=STREAM_DEPTH, **kw))

    # the first stream run of each size: a submit's host time beside its
    # grid's device time, and what the sync debug mode flags around the
    # submits (not the fetches)
    host_ms, device_ms, flagged, pending = [], [], [], []
    submit = conv._convert_submit

    def timed_submit(*args, **kwargs):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        start = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                handle = submit(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        host_ms.append((time.perf_counter() - start) * 1e3)
        end.record()
        # still queued when the submit returned: it did not wait for its
        # grid
        pending.append(not end.query())
        device_ms.append((begin, end))
        # the mode's own note that it is a prototype is no flag
        flagged.extend(str(w.message).splitlines()[0] for w in caught
                       if "prototype" not in str(w.message))
        return handle

    out = {}
    with strict_float32("convert stream"):
        for n_pairs, batches in sizes.items():
            small = n_pairs == STREAM_PAIRS
            loop(batches[:1])  # warm-up at this size
            torch.cuda.synchronize()
            reset_launches()
            conv.convert_batched(g_model, p_model, batches[0])
            per_call = {k: v for k, v in read_launches().items() if v}
            if small and not (per_call.get("bilstm_infer")
                              and per_call.get("multi_bilstm_infer")):
                fail(f"convert_batched at {n_pairs} pairs launched "
                     f"{per_call}")
            if not small and per_call != expected_large:
                fail(f"convert_batched at {n_pairs} pairs launched "
                     f"{per_call}, expected {expected_large}")
            # in turns: the loop, the stream, the stream, the loop; the
            # stream's launches and submits from its first run
            seconds = {"loop": [], "stream": []}
            results = {}
            for record in (host_ms, device_ms, flagged, pending):
                record.clear()
            for which in ("loop", "stream", "stream", "loop"):
                first = which == "stream" and "stream" not in results
                torch.cuda.synchronize()
                if first:
                    reset_launches()
                    conv._convert_submit = timed_submit
                start = time.perf_counter()
                try:
                    got = (loop if which == "loop" else stream)(batches)
                finally:
                    conv._convert_submit = submit
                seconds[which].append(time.perf_counter() - start)
                if first:
                    launches = {k: v for k, v in read_launches().items()
                                if v}
                results.setdefault(which, got)
            torch.cuda.synchronize()
            want = {k: v * len(batches) for k, v in per_call.items()}
            if launches != want:
                fail(f"convert_stream at {n_pairs} pairs launched "
                     f"{launches}, {len(batches)} convert_batched calls "
                     f"{want}")
            diff = _same_yields("convert stream", results["stream"],
                                results["loop"])
            utts = len(batches) * n_pairs * len(conv.CONDITIONS)
            loop_s, stream_s = min(seconds["loop"]), min(seconds["stream"])
            log("convert stream", pairs=n_pairs, batches=len(batches),
                depth=STREAM_DEPTH, bit_equal_to_convert_batched=not diff,
                launches=json.dumps(launches).replace(" ", ""),
                launches_convert_batched_per_call=json.dumps(
                    per_call).replace(" ", ""),
                loop_s=",".join(f"{x:.4f}" for x in seconds["loop"]),
                stream_s=",".join(f"{x:.4f}" for x in seconds["stream"]),
                loop_utterances_per_s=f"{utts / loop_s:.2f}",
                stream_utterances_per_s=f"{utts / stream_s:.2f}",
                stream_over_loop=f"{loop_s / stream_s:.4f}",
                note="best of two runs each, in turns (loop, stream, "
                     "stream, loop; the first stream run's submits "
                     "timed); tf32 off")
            out[n_pairs] = dict(launches=launches, stream_s=stream_s,
                                loop_s=loop_s)
            grid_ms = [b.elapsed_time(e) for b, e in device_ms]
            raised = "not tried"
            if small:
                # one submit under "error": the first synchronising call
                # raises there
                raised = "none"
                torch.cuda.set_sync_debug_mode("error")
                try:
                    handle = submit(g_model, p_model, batches[0],
                                    conv.CONDITIONS, False)
                except RuntimeError as err:
                    raised = str(err).splitlines()[0].replace(" ", "_")
                    handle = None
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if handle is not None:
                    conv._convert_fetch(handle)
            log("convert stream submit", pairs=n_pairs,
                submits=len(host_ms),
                host_ms_median=f"{np.median(host_ms):.4f}",
                host_ms_max=f"{max(host_ms):.4f}",
                grid_device_ms_median=f"{np.median(grid_ms):.4f}",
                host_over_device=(
                    f"{np.median(host_ms) / np.median(grid_ms):.4f}"),
                grids_pending_at_return=f"{sum(pending)}/{len(pending)}",
                sync_debug_warn_flags=len(flagged),
                sync_debug_first_flag=(flagged[0].replace(" ", "_")[:120]
                                       if flagged else "none"),
                sync_debug_error=raised[:120],
                note="device time from events around each submit on the "
                     "compute stream")
            if small:
                small_f32 = results["stream"]
            del results
            gc.collect()
            torch.cuda.empty_cache()

            if small:
                # the card's idle share (phase 13 profiles the large
                # call): one profiled stream, one profiled loop
                shares = {}
                for which in ("stream", "loop"):
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        start = time.perf_counter()
                        (loop if which == "loop" else stream)(batches)
                        torch.cuda.synchronize()
                        wall_ms = (time.perf_counter() - start) * 1e3
                    shares[which] = (_kernel_idle_share(prof, wall_ms),
                                     wall_ms)
                    del prof
                log("convert stream idle", pairs=n_pairs,
                    **{f"{w}_{k}": v for w, ((idle, copy), wall_ms) in
                       shares.items() for k, v in (
                           ("wall_ms", f"{wall_ms:.4f}"),
                           ("device_idle_share", "not measured"
                            if idle is None else f"{idle:.4f}"),
                           ("copy_ms", "not measured" if copy is None
                            else f"{copy:.4f}"))},
                    note="idle counted by kernels; profiler on, its "
                         "overhead in the wall")
                # compress_fetch=True: the float32 yields rounded
                packed = stream(batches, compress_fetch=True)
                worst = 0
                for g, w in zip(packed, small_f32, strict=True):
                    for (_, gm), (_, wm) in zip(_flat_results(g),
                                                _flat_results(w)):
                        want_bf16 = torch.from_numpy(wm).to(
                            torch.bfloat16).float().numpy()
                        if gm.dtype != np.float32 or not np.array_equal(
                                gm, want_bf16):
                            worst += 1
                if worst:
                    fail(f"convert_stream(compress_fetch=True): {worst} "
                         f"mels differ from the float32 yields rounded to "
                         f"bfloat16")
                # "auto": the link probe decides
                conv.reset_auto_decisions()
                link = linkprobe.probe_link(force=True)
                auto = stream(batches, compress_fetch="auto")
                key = conv._auto_key(batches[0], conv.CONDITIONS)
                chosen = conv._AUTO_DECISIONS.get(key)
                _same_yields("convert stream auto", auto,
                             packed if chosen else small_f32)
                log("convert stream modes", pairs=n_pairs,
                    compress_fetch_true="bfloat16 rounding of the float32 "
                                        "yields, bit for bit",
                    link_f32_mbps=link.f32_mbps,
                    link_bf16_mbps=link.bf16_mbps, link_rtt_ms=link.rtt_ms,
                    auto_key=json.dumps(list(key)).replace(" ", ""),
                    auto_chose="bfloat16" if chosen else "float32",
                    auto_yields_equal_chosen_mode=True)
                del packed, auto, small_f32
            else:
                # the large grid's fetch: pageable against pinned, and the
                # pinned buffer's copy-out by torch (the threads) and by
                # numpy (one thread)
                cut = max(conv._cut(c, s, t) for c in conv.CONDITIONS
                          for s, t in batches[0])
                rows = n_pairs * len(conv.CONDITIONS)
                grid = torch.rand(rows, cut, config.dim_freq,
                                  device="cuda")
                ring = linkprobe.PinnedRing(1)
                ring.reserve(grid.numel() * 4)
                pageable, pinned, copy_out, numpy_out = [], [], [], []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    grid.cpu()
                    pageable.append((time.perf_counter() - start) * 1e3)
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    fetch = linkprobe.start_fetch(grid, ring)
                    fetch.done.synchronize()
                    mid = time.perf_counter()
                    linkprobe.finish_fetch(fetch)
                    pinned.append((mid - start) * 1e3)
                    copy_out.append((time.perf_counter() - mid) * 1e3)
                    start = time.perf_counter()
                    fetch.host.numpy().copy()
                    numpy_out.append((time.perf_counter() - start) * 1e3)
                gb = grid.numel() * 4 / 1e9
                log("convert stream fetch", pairs=n_pairs,
                    grid=f"{rows}x{cut}x{config.dim_freq}",
                    mb=f"{gb * 1e3:.2f}",
                    pageable_ms=f"{min(pageable):.4f}",
                    pinned_copy_ms=f"{min(pinned):.4f}",
                    pinned_copy_gb_per_s=f"{gb / min(pinned) * 1e3:.2f}",
                    copy_out_ms=f"{min(copy_out):.4f}",
                    numpy_copy_out_ms=f"{min(numpy_out):.4f}",
                    pinned_fetch_ms=f"{min(pinned) + min(copy_out):.4f}",
                    note=f"best of {reps}; the copy-out is the host copy "
                         f"that frees the pinned buffer")
                del grid, ring
            gc.collect()
            torch.cuda.empty_cache()
    del g_model, p_model, sizes, large
    gc.collect()
    torch.cuda.empty_cache()
    log("convert stream done", seconds=f"{time.perf_counter() - wall:.1f}")
    return out


def phase_train_single(batch):
    """Both train steps with every merged BiLSTM layer on the
    single-direction route (``merged_bidir_fits`` false): a real step at
    a batch the merged kernels refuse needs more memory than the card
    has (the mel decoder's residuals alone), so the route is forced at
    B16."""
    gen_launches, _, _ = train_phase(
        "generator single", "speechsplit",
        {"lstm_fwd": 8, "lstm_bwd": 8, "multi_bilstm_fwd": 1,
         "multi_bilstm_bwd": 1}, batch, layers="single")
    f0_launches, _, _ = train_phase(
        "f0_converter single", "f0_converter",
        {"lstm_fwd": 4, "lstm_bwd": 4, "multi_bilstm_fwd": 1,
         "multi_bilstm_bwd": 1}, batch, layers="single")
    return gen_launches, f0_launches


# --------------------------------------------------------------------------
# The single-direction route at bfloat16: W_hh (bfloat16 compute), the xp
# stream and the residuals, in lstm_infer, lstm_fwd and lstm_bwd

# the tag of each (W_hh, residual) dtype pair of the training kernels'
# bfloat16 instances, as COMPUTE_KERNELS names them
def lstm_tag(w_dtype, rd) -> str:
    import torch

    bf16 = torch.bfloat16
    return {(bf16, torch.float32): "bf16_w", (bf16, bf16): "bf16_w_bf16_resid",
            (torch.float32, bf16): "bf16_resid"}[(w_dtype, rd)]


def lstm_compute_inputs(t: int, b: int, h: int, seed: int, w_dtype,
                        stream):
    """``lstm_inputs`` with W_hh in ``w_dtype`` and xp in ``stream``."""
    xp, w, dh = lstm_inputs(t, b, h, seed)
    return xp.to(stream), w.to(w_dtype), dh


def check_lstm_infer_compute(b: int, h: int, stream, reps: int) -> dict:
    """``lstm_infer`` at bfloat16 W beside an xp stream of ``stream``, both
    directions, against its plain version on the same inputs at the flip
    bar, rounding where the plain version rounds (``check_rounds``), timed
    (call and device time) beside the plain version and the bound at
    these bytes."""
    import torch

    from speechsplit_tpu_torch.ops import lstm

    bf16 = torch.bfloat16
    xp, w, _ = lstm_compute_inputs(T, b, h, SEED + 23 * h + b, bf16, stream)
    got = [lstm.lstm_infer_cuda(xp, w, r) for r in (False, True)]
    want = [lstm.lstm_sequence_reference(xp, w, r) for r in (False, True)]
    torch.cuda.synchronize()
    check_dtypes("lstm_infer bf16 compute h", got, torch.float32)
    name = "lstm_infer/bf16_w" + ("_bf16_xp" if stream == bf16 else "")
    shape = f"T{T}xB{b}xH{h}"
    errs = check_flips(f"{name} {shape}", got, want)
    del got, want
    s_xp, s_w, _ = lstm_compute_inputs(COMPUTE_SHORT_T, b, h, SEED + h, bf16,
                                       stream)
    errs.update(check_rounds(
        f"{name} {shape}", [lstm.lstm_infer_cuda(s_xp, s_w, True)],
        [lstm.lstm_sequence_reference(s_xp, s_w, True)],
        [lstm.lstm_sequence_reference(s_xp, s_w.float(), True)]))
    bound, by = lstm_bound(T, b, [h], "infer",
                           xp_bytes=2 if stream == bf16 else 4, w_bytes=2)

    def lean():
        return lstm.lstm_infer_cuda(xp, w, False)

    return _compute_row(name, shape, dict(
        ms=time_ms(lean, reps, warmup=1),
        device_ms=kernel_device_ms(lean, reps),
        plain_ms=time_ms(lambda: lstm.lstm_sequence_reference(xp, w, False),
                         1, warmup=0),
        bound_ms=bound, bound_by=by,
        plan="narrow" if h <= lstm.NARROW_MAX_H else "wide", **errs))


def check_lstm_train_compute(b: int, h: int, w_dtype, rd, reps: int) -> dict:
    """``lstm_fwd`` and ``lstm_bwd`` at W_hh ``w_dtype`` and residuals
    ``rd`` (xp in ``stream_dtype``, dh rounded to ``rd`` as
    ``LSTMFunction`` hands it over), both directions, against their plain
    versions: the forward's h, g and c, the gradient's dx on the plain
    forward's residuals and on the kernel's own. At bfloat16 W the flip
    bar and ``check_rounds``; at float32 W (bfloat16 residuals alone) h
    within ``PATH_TOL`` and g, c and dx within ``BF16_ULPS``, as the
    merged kernels' bfloat16 residuals are held. Timed beside the plain
    versions and the bounds at these bytes; returns the two rows."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm, lstm

    bf16 = torch.bfloat16
    stream = bilstm.stream_dtype(w_dtype, rd)
    xp, w, dh = lstm_compute_inputs(T, b, h, SEED + 37 * h + b, w_dtype,
                                    stream)
    dh = dh.to(rd)
    tag = lstm_tag(w_dtype, rd)
    shape = f"T{T}xB{b}xH{h}"
    got, want, dx, dx_ref, dx_own, dx_own_ref = ([] for _ in range(6))
    for reverse in (False, True):
        fwd = lstm.lstm_forward_cuda(xp, w, reverse, rd)
        ref = lstm.lstm_direction_forward_reference(xp, w, reverse, rd)
        got += fwd
        want += ref
        dx.append(lstm.lstm_backward_cuda(dh, *ref[1:], w, reverse))
        dx_ref.append(lstm.lstm_direction_backward_reference(dh, *ref[1:], w,
                                                             reverse))
        dx_own.append(lstm.lstm_backward_cuda(dh, *fwd[1:], w, reverse))
        dx_own_ref.append(lstm.lstm_direction_backward_reference(
            dh, *fwd[1:], w, reverse))
    torch.cuda.synchronize()
    check_dtypes(f"lstm_fwd/{tag} h", got[0::3], torch.float32)
    check_dtypes(f"lstm_fwd/{tag} g, c", got[1::3] + got[2::3], rd)
    check_dtypes(f"lstm_bwd/{tag} dx", dx + dx_own, rd)
    if w_dtype == bf16:
        fwd_errs = check_flips(f"lstm_fwd/{tag} {shape}", got, want)
        bwd_errs = check_flips(f"lstm_bwd/{tag} {shape}", dx, dx_ref)
        own = check_flips(f"lstm_bwd/{tag} {shape} on the kernel's "
                          "residuals", dx_own, dx_own_ref)
        bwd_errs.update(own_residuals_flip_share=own["flip_share"],
                        own_residuals_max_err_over_max=own[
                            "max_err_over_max"])
        # at COMPUTE_SHORT_T steps beside the plain versions at float32 W
        s_xp, s_w, s_dh = lstm_compute_inputs(COMPUTE_SHORT_T, b, h,
                                              SEED + h, w_dtype, stream)
        s_dh = s_dh.to(rd)
        s_want = lstm.lstm_direction_forward_reference(s_xp, s_w, True, rd)
        fwd_errs.update(check_rounds(
            f"lstm_fwd/{tag} {shape}",
            lstm.lstm_forward_cuda(s_xp, s_w, True, rd), s_want,
            lstm.lstm_direction_forward_reference(s_xp, s_w.float(), True,
                                                  rd)))
        bwd_errs.update(check_rounds(
            f"lstm_bwd/{tag} {shape}",
            [lstm.lstm_backward_cuda(s_dh, *s_want[1:], s_w, True)],
            [lstm.lstm_direction_backward_reference(s_dh, *s_want[1:], s_w,
                                                    True)],
            [lstm.lstm_direction_backward_reference(s_dh, *s_want[1:],
                                                    s_w.float(), True)]))
    else:
        fwd_errs = dict(max_abs_err=abs_err(got, want),
                        err_h=abs_err(got[0::3], want[0::3]),
                        max_ulps=bf16_ulps(got[1::3] + got[2::3],
                                           want[1::3] + want[2::3]))
        bwd_errs = dict(max_abs_err=abs_err(dx, dx_ref),
                        max_ulps=bf16_ulps(dx, dx_ref),
                        own_residuals_max_ulps=bf16_ulps(dx_own, dx_own_ref))
        if not (fwd_errs["err_h"] <= PATH_TOL and max(
                fwd_errs["max_ulps"], bwd_errs["max_ulps"],
                bwd_errs["own_residuals_max_ulps"]) <= BF16_ULPS):
            fail(f"lstm training kernels {tag} {shape}: {fwd_errs} "
                 f"{bwd_errs} (tol {PATH_TOL} on h, {BF16_ULPS} ulps)")
    del got, want, dx, dx_ref, dx_own, dx_own_ref
    _, g, c = lstm.lstm_direction_forward_reference(xp, w, False, rd)
    size = 2 if rd == bf16 else 4
    w_size = 2 if w_dtype == bf16 else 4
    fwd_bound, fwd_by = lstm_bound(T, b, [h], "fwd", resid_bytes=size,
                                   xp_bytes=2 if stream == bf16 else 4,
                                   w_bytes=w_size)
    bwd_bound, bwd_by = lstm_bound(T, b, [h], "bwd", resid_bytes=size,
                                   stream_bytes=size, w_bytes=w_size)

    def fwd():
        return lstm.lstm_forward_cuda(xp, w, False, rd)

    def bwd():
        return lstm.lstm_backward_cuda(dh, g, c, w, False)

    plan = "narrow" if h <= lstm.NARROW_MAX_H else "wide"
    return {
        f"lstm_fwd/{tag}": _compute_row(f"lstm_fwd/{tag}", shape, dict(
            ms=time_ms(fwd, reps), device_ms=kernel_device_ms(fwd, reps),
            plain_ms=time_ms(lambda: lstm.lstm_direction_forward_reference(
                xp, w, False, rd), 1, warmup=0),
            bound_ms=fwd_bound, bound_by=fwd_by, plan=plan, **fwd_errs)),
        f"lstm_bwd/{tag}": _compute_row(f"lstm_bwd/{tag}", shape, dict(
            ms=time_ms(bwd, reps), device_ms=kernel_device_ms(bwd, reps),
            plain_ms=time_ms(lambda: lstm.lstm_direction_backward_reference(
                dh, g, c, w, False), 1, warmup=0),
            bound_ms=bwd_bound, bound_by=bwd_by, plan=plan, **bwd_errs)),
    }


# the single-direction kernels' other code paths at bfloat16 (T, B, H):
# T=1, one row and odd batches, widths not a multiple of 4 (the lean wide
# plan's unvectorised staging, the training kernels' unit-by-unit runs),
# H=1 and the plan borders 31, 32 and 33, the wide plans at 1, 2 and 4
# units a block (64, 130, 257), batch tiles (B=300 at H=512)
LSTM_COMPUTE_EDGES = ((1, 16, 512), (5, 1, 512), (6, 3, 1), (7, 9, 31),
                      (7, 9, 32), (7, 9, 33), (5, 77, 8), (6, 13, 100),
                      (5, 7, 64), (5, 9, 130), (4, 5, 257), (3, 300, 512))


def check_lstm_compute_edges() -> None:
    """The eight bfloat16 instances of the single-direction kernels at
    ``LSTM_COMPUTE_EDGES``, both directions, and the training kernels at
    their batch limits (``MAX_FWD_BATCH``, ``MAX_BWD_BATCH`` at H=512; the
    lean forward beside them), each against its plain version at the flip
    bar (the float32-W instances too: their outputs round only where they
    are stored); the gradient on the plain forward's residuals and on the
    kernel's own."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm, lstm

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = LSTM_COMPUTE_EDGES + ((2, lstm.MAX_FWD_BATCH, 512),
                                   (2, lstm.MAX_BWD_BATCH, 512))
    worst = {"share": 0.0, "err": 0.0}

    def keep(what, got, want):
        errs = check_flips(what, got, want)
        worst["share"] = max(worst["share"], errs["flip_share"])
        worst["err"] = max(worst["err"], errs["max_err_over_max"])

    for i, (t, b, h) in enumerate(shapes):
        for reverse in (False, True):
            where = f"T{t}xB{b}xH{h} reverse={reverse}"
            for stream in (f32, bf16):
                xp, w, _ = lstm_compute_inputs(t, b, h, SEED + 41 * i, bf16,
                                               stream)
                keep(f"lstm_infer bf16 W, xp {stream} {where}",
                     [lstm.lstm_infer_cuda(xp, w, reverse)],
                     [lstm.lstm_sequence_reference(xp, w, reverse)])
            for w_dtype, rd in ((bf16, f32), (bf16, bf16), (f32, bf16)):
                stream = bilstm.stream_dtype(w_dtype, rd)
                xp, w, dh = lstm_compute_inputs(t, b, h, SEED + 43 * i,
                                                w_dtype, stream)
                dh = dh.to(rd)
                what = f"{lstm_tag(w_dtype, rd)} {where}"
                want = lstm.lstm_direction_forward_reference(xp, w, reverse,
                                                             rd)
                got = want
                if b <= lstm.MAX_FWD_BATCH:
                    got = lstm.lstm_forward_cuda(xp, w, reverse, rd)
                    keep(f"lstm_fwd {what}", got, want)
                if b <= lstm.MAX_BWD_BATCH:
                    for res in [want] if got is want else [want, got]:
                        keep(f"lstm_bwd {what}",
                             [lstm.lstm_backward_cuda(dh, *res[1:], w,
                                                      reverse)],
                             [lstm.lstm_direction_backward_reference(
                                 dh, *res[1:], w, reverse)])
                del xp, w, dh, want, got
    torch.cuda.synchronize()
    log("kernel lstm bf16 edges", shapes=len(shapes), directions=2,
        instances=8, max_flip_share=f"{worst['share']:.4g}",
        flip_share_tol=COMPUTE_FLIP_SHARE,
        max_err_over_max=f"{worst['err']:.4g}", flip_tol=COMPUTE_FLIP,
        limits=f"B{lstm.MAX_FWD_BATCH} lstm_fwd, B{lstm.MAX_BWD_BATCH} "
               f"lstm_bwd at H512")


def phase_lstm_compute_kernels(reps: int = 3) -> dict:
    """The single-direction kernels' bfloat16 instances against their
    plain versions at the shapes their main paths give them: ``lstm_infer``
    at the 731-pair call's B5117 H512 and H8 beside either xp stream, the
    training pair at B16 H512, H256 and H8 at each (W_hh, residual) dtype
    pair; then their edges. Returns the row of each instance's first (most
    expensive) shape, the others beside it."""
    import gc

    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS

    bf16, f32 = torch.bfloat16, torch.float32
    config = SpeechSplitConfig()
    big = len(CONDITIONS) * refused_pairs()
    rows = {}

    def add(found: dict) -> None:
        for name, row in found.items():
            if name in rows:
                rows[name].setdefault("beside", []).append(
                    {k: row[k] for k in ("shape", "ms", "device_ms",
                                         "bound_ms") if k in row})
            else:
                rows[name] = row

    with strict_float32("single-direction bfloat16 kernels"):
        for stream in (bf16, f32):
            for h in (config.dim_dec_mel, config.dim_neck):
                row = check_lstm_infer_compute(big, h, stream, reps)
                add({"lstm_infer/bf16_w" + (
                    "_bf16_xp" if stream == bf16 else ""): row})
                gc.collect()
                torch.cuda.empty_cache()
        for w_dtype, rd in ((bf16, bf16), (bf16, f32), (f32, bf16)):
            for h in (config.dim_dec_mel, config.dim_dec_f0,
                      config.dim_neck):
                add(check_lstm_train_compute(TRAIN_B, h, w_dtype, rd, 10))
        check_lstm_compute_edges()
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_convert_large_compute(reps: int = 3) -> dict:
    """``convert_batched`` at :func:`refused_pairs` (731) pairs through
    seeded default-config weights at bfloat16 compute: at the default
    bfloat16 residuals (bfloat16 xp streams) the launches of one call (8
    ``lstm_infer``: the mel decoder's 3 layers and content layer 1 one
    direction a launch), the mels within ``COMPUTE_PATH_TOL`` of the
    largest magnitude of the plain call's but for at most
    ``COMPUTE_FLIP_SHARE`` of their elements (a rounding flipped by a sum
    taken in another order, carried through every later layer; an F0
    bin the converter picks at a near tie changes whole frames), the
    largest error recorded, and ms a call in turns with the same
    weights at float32 compute (TF32 off); at float32 residuals (float32
    xp streams beside bfloat16 W_hh) the launches and finite mels.
    Returns the launches by residual dtype."""
    import gc

    import numpy as np
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    n_pairs = refused_pairs()
    gen = torch.Generator().manual_seed(SEED)
    base = (SpeechSplit(SpeechSplitConfig(), generator=gen),
            F0Converter(SpeechSplitConfig(), generator=gen))
    pairs = synthetic_pairs(SpeechSplitConfig(), n_pairs, "cuda", SEED + 3)

    def models(config):
        g = SpeechSplit(config).to("cuda").eval()
        p = F0Converter(config).to("cuda").eval()
        g.load_state_dict(base[0].state_dict())
        p.load_state_dict(base[1].state_dict())
        return g, p

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    expected = {"lstm_infer": 8, "bilstm_infer": 2, "multi_bilstm_infer": 2}
    launches = {}
    with strict_float32("bf16 compute 731-pair conversions and timing"):
        for residual in ("bfloat16", "float32"):
            config = compute_config(residual)
            g, p = models(config)

            def run(g=g, p=p):
                return convert_batched(g, p, pairs, CONDITIONS)

            run()
            torch.cuda.synchronize()
            reset_launches()
            result = run()
            counts = {k: v for k, v in read_launches().items() if v}
            if counts != expected:
                fail(f"convert_batched at {n_pairs} pairs bf16 compute "
                     f"({residual} residuals): launches {counts}")
            launches[residual] = counts
            check_conversions(config, pairs, result)
            if residual != "bfloat16":
                del g, p, result
                free()
                continue
            free()
            with plain_kernels():
                plain = run()
            # each element within COMPUTE_PATH_TOL of the call's largest
            # magnitude, but for at most COMPUTE_FLIP_SHARE of them
            top = max(float(np.abs(b[1]).max()) for r in plain for b in r)
            past = [int((np.abs(a[1] - b[1]) > COMPUTE_PATH_TOL * top).sum())
                    for ra, rb in zip(result, plain)
                    for a, b in zip(ra, rb)]
            total = sum(b[1].size for r in plain for b in r)
            share = sum(past) / total
            worst = max(float(np.abs(a[1] - b[1]).max())
                        for ra, rb in zip(result, plain)
                        for a, b in zip(ra, rb)) / top
            mels_past = sum(1 for n in past if n)
            del plain
            free()
            if not share <= COMPUTE_FLIP_SHARE:
                fail(f"convert_batched at {n_pairs} pairs bf16 compute vs "
                     f"plain: {share} of the mel elements past "
                     f"{COMPUTE_PATH_TOL} of the largest magnitude (tol "
                     f"{COMPUTE_FLIP_SHARE}); largest error {worst}")
            del result
            f32_models = models(SpeechSplitConfig())
            samples = {"bf16_compute": [], "float32": []}
            for r in range(reps):
                for label in (("bf16_compute", "float32") if r % 2 == 0
                              else ("float32", "bf16_compute")):
                    mg, mp = (g, p) if label == "bf16_compute" else f32_models
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    convert_batched(mg, mp, pairs, CONDITIONS)
                    samples[label].append((time.perf_counter() - start) * 1e3)
            log("convert_batched large bf16 compute", pairs=n_pairs,
                residuals=residual, generator_batch=n_pairs * len(CONDITIONS),
                median_ms_per_call=f"{np.median(samples['bf16_compute']):.4f}",
                float32_median_ms_per_call=(
                    f"{np.median(samples['float32']):.4f}"),
                rounds_ms=";".join(f"{k}:" + ",".join(f"{v:.4f}" for v in w)
                                   for k, w in samples.items()),
                timing="bf16 compute and float32 calls in turns, TF32 off",
                tol=COMPUTE_PATH_TOL, flip_share=f"{share:.4g}",
                flip_share_tol=COMPUTE_FLIP_SHARE,
                mels_with_a_flip=f"{mels_past}/{len(past)}",
                max_abs_err_over_max_vs_plain=f"{worst:.3g}",
                launches=json.dumps(counts).replace(" ", ""))
            del g, p, f32_models
            free()
    log("convert_batched large bf16 compute", pairs=n_pairs,
        residuals="float32", check="launches and finite mels",
        launches=json.dumps(launches["float32"]).replace(" ", ""))
    del pairs, base
    free()
    return launches


def phase_train_single_compute(batch) -> tuple:
    """Both train steps with every merged BiLSTM layer on the
    single-direction route (``merged_bidir_fits`` false) at the default
    config (bfloat16 residuals) and at bfloat16 compute (bfloat16 and
    float32 residuals): exact launches (8 ``lstm_fwd`` and ``lstm_bwd``
    for the generator, 4 for the F0 converter), no plain call, the loss
    and every gradient within ``BF16_STEP_TOL`` of the plain step at the
    same config (``train_precision_phase``), ms a step in turns. Returns
    the generator's and the F0 converter's launches by label."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    checked = {"default": SpeechSplitConfig(),
               "bf16_compute": compute_config(),
               "bf16_compute_f32_resid": compute_config("float32")}
    timed = {"default": checked["default"],
             "bf16_compute": checked["bf16_compute"]}
    out = []
    for name, model, n in (("generator", "speechsplit", 8),
                           ("f0_converter", "f0_converter", 4)):
        out.append(train_precision_phase(
            name, model, {"lstm_fwd": n, "lstm_bwd": n,
                          "multi_bilstm_fwd": 1, "multi_bilstm_bwd": 1},
            batch, checked, timed, "single bf16", reps=4, layers="single"))
    return tuple(out)


# --------------------------------------------------------------------------
# The serving path: wav in, wav out (the front end, its Viterbi kernel,
# Griffin-Lim, VoiceConverter and cli.serve)

# candidate fields of the decoder's check: batches and frame counts (257:
# a 3 s request's padded 65,536 samples; 1876: 30 s)
VITERBI_BATCHES = (1, 2, 28)
VITERBI_FRAMES = (1, 2, 257, 1876)
SAMPLE_RATE = 16000
# the front end's wavs and the server's pairs (seconds)
SHORT_S = 3.0
LONG_S = 8.0
# the vocoder phase: two requests' 7 conditions of max_len_pad frames
VOCODER_MELS = 14
# the front end against the same call on the CPU (cuFFT against
# pocketfft, cuBLAS against the CPU's products): mel, absolute
FRONT_END_CPU_TOL = 1e-4
# the share of frames whose F0 must agree with the CPU run's (voicing,
# and the quantized bin; the tracker's log-F0 within 1e-5): the bar
# tests/test_pitch.py holds JAX's own decoders to
F0_AGREE = 0.995
# the same extraction with the plain decoder on the card: the mel path is
# the same code, so equal up to this
FRONT_END_PLAIN_TOL = 1e-6
# a repeated request's mels against the first's
REPEAT_TOL = 1e-6


def viterbi_fields(b: int, t: int, k: int, seed: int, kind: str):
    """Seeded decoder inputs on the card from a (lag, score) field:
    ``random`` (lags on whole samples and scores on eighths, so that costs
    tie), ``unusable`` (every score at or under the candidate threshold),
    ``equal`` (every candidate the same, every cost a tie; scores of 0.5
    decode unvoiced throughout), ``voiced_equal`` (the same at scores of
    0.875: every voiced path ties and is cheaper than the unvoiced)."""
    import torch

    from speechsplit_tpu_torch.ops import pitch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, t, k)
    if kind in ("equal", "voiced_equal"):
        lag = torch.full(shape, 100.0, device="cuda")
        score = torch.full(shape, 0.5 if kind == "equal" else 0.875,
                           device="cuda")
    else:
        lag = torch.floor(26.0 + 295.0 * torch.rand(
            shape, device="cuda", generator=gen))
        score = torch.floor(-1.6 + 9.6 * torch.rand(
            shape, device="cuda", generator=gen)) / 8.0
        if kind == "unusable":
            score = torch.clamp(score, max=pitch.PitchParams().cand_thresh)
    _, local_v, local_u, log_lag = pitch._local_costs(
        lag, score, SAMPLE_RATE // 50, pitch.PitchParams())
    return local_v.contiguous(), local_u.contiguous(), log_lag.contiguous()


def viterbi_bound(b: int, t: int, k: int) -> tuple[float, str]:
    """(bound ms, what bounds it) of one decode: each input read once
    (local_v, log_lag [B, T, K], local_u [B, T]) and the states [B, T]
    written once, over the card's memory rate; the min-plus step's
    operations (5 a transition: sub, abs, mul, add, compare) over the
    float32 peak. The serial chain's floor is measured instead
    (``phase_viterbi_probe``)."""
    nbytes = 4 * (2 * b * t * k + b * t) + 4 * b * t
    flops = 5 * b * max(t - 1, 0) * k * k
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    if by_ops >= by_bytes:
        return by_ops, "operations"
    return by_bytes, "bytes"


def check_viterbi(b: int, t: int, kind: str = "random", k: int = 12) -> int:
    """The kernel's states against the plain loop's on the card, bit for
    bit; 1, a case."""
    import torch

    from speechsplit_tpu_torch.ops import pitch

    fields = viterbi_fields(b, t, k, SEED + 31 * b + t, kind)
    params = pitch.PitchParams()
    got = pitch.viterbi_decode(*fields, params.freq_weight, params.trans_cost)
    want = pitch.viterbi_decode_reference(*fields, params.freq_weight,
                                          params.trans_cost)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"viterbi_decode B{b} T{t} K{k} {kind}: {bad} states differ "
             f"from the plain loop's")
    return 1


# a kernel instance of csrc/viterbi.cu, by its mangled name: the lanes a
# copy of the states takes (KP), the predecessors a lane takes (NP) and
# the shared-memory backpointers' plan
VITERBI_ENTRY = re.compile(r"viterbi_kernelILi(\d+)ELi(\d+)ELb([01])E")


def viterbi_codegen() -> dict:
    """Registers, spill stores, stack frame and static shared memory of
    each ``viterbi_kernel`` instance the port launches (``-Xptxas -v``),
    by plan: ``NP6 shared``, ``NP6 device`` (two lanes a state, K <= 12),
    ``NP32 shared``, ``NP32 device``."""
    from speechsplit_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        text = subprocess.run(
            [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
             os.path.join(tmp, "v.cubin"),
             str(_build.CSRC / "viterbi.cu")],
            capture_output=True, text=True, check=True).stderr
    out, key = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = VITERBI_ENTRY.search(line)
            key = m and f"NP{m[2]} {'shared' if m[3] == '1' else 'device'}"
        elif key and "spill stores" in line:
            row = out.setdefault(key, {})
            row["spill_stores"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
            row["stack_frame"] = int(
                re.search(r"(\d+) bytes stack frame", line)[1])
        elif key and "Used" in line and "registers" in line:
            row = out.setdefault(key, {})
            row["registers"] = int(re.search(r"Used (\d+) registers",
                                             line)[1])
            smem = re.search(r"(\d+) bytes smem", line)
            row["static_smem"] = int(smem[1]) if smem else 0
            key = None
    if sorted(out) != ["NP32 device", "NP32 shared", "NP6 device",
                       "NP6 shared"]:
        fail(f"viterbi codegen: instances {sorted(out)}")
    return out


def phase_viterbi(reps: int = 20) -> dict:
    """``viterbi_decode`` against its plain loop at every batch and frame
    count of ``VITERBI_BATCHES`` x ``VITERBI_FRAMES`` and at its edges
    (every candidate unusable, every cost equal with every state unvoiced
    or every voiced state tied, K + 1 = 32 states, which is the most the
    kernel takes, and K + 1 = 33, which raises), and both
    plans, the backpointers in shared and in device memory, at the
    largest T of the shared plan and the next, at K = 12 and K + 1 = 32;
    timed at a 3 s request's shape (B1 T257) and at B28 T1876, with the
    probe build's split and the measured latency floor beside each; the
    registers, spills, stack frame and shared memory of each plan."""
    import torch

    from speechsplit_tpu_torch.ops import pitch

    cases = 0
    for b in VITERBI_BATCHES:
        for t in VITERBI_FRAMES:
            cases += check_viterbi(b, t)
    for b, t in ((1, 257), (28, 1876), (2, 2)):
        for kind in ("unusable", "equal", "voiced_equal"):
            cases += check_viterbi(b, t, kind)
    cases += check_viterbi(2, 257, k=pitch.MAX_STATES - 1)
    cases += check_viterbi(3, 5, "equal", k=pitch.MAX_STATES - 1)
    cases += check_viterbi(3, 70, "voiced_equal", k=pitch.MAX_STATES - 1)
    try:
        fields = viterbi_fields(1, 4, pitch.MAX_STATES, SEED, "random")
        pitch.viterbi_decode(*fields, 0.25, 0.3)
        fail("viterbi_decode took K + 1 = 33 states")
    except ValueError:
        pass
    lib = pitch._library()
    plans = []
    for k in (12, pitch.MAX_STATES - 1):
        last = pitch.SHARED_BACK_BYTES // (k + 1) + 1  # the plan's largest T
        for t, shared in ((last, True), (last + 1, False)):
            if pitch.shared_plan(t, k) != shared:
                fail(f"viterbi_decode T{t} K{k}: not the "
                     f"{'shared' if shared else 'device'} plan")
            cases += check_viterbi(2, t, k=k)
            plans.append(dict(shape=f"B2xT{t}xK{k}",
                              plan="shared" if shared else "device",
                              shared_bytes=lib.viterbi_shared_bytes(t, k)))
    params = pitch.PitchParams()
    probe = phase_viterbi_probe(((1, 257), (28, 1876)), reps)
    rows, beside = [], []
    for b, t in ((1, 257), (28, 1876)):
        k = params.num_cands
        fields = viterbi_fields(b, t, k, SEED + b, "random")

        def kernel():
            return pitch.viterbi_decode(*fields, params.freq_weight,
                                        params.trans_cost)

        # the timed inputs held to the plain loop too: the row's error is
        # the largest state difference on them
        got = kernel()
        want = pitch.viterbi_decode_reference(*fields, params.freq_weight,
                                              params.trans_cost)
        differing = int((got != want).sum())
        if differing:
            fail(f"viterbi_decode B{b} T{t} K{k} (timed inputs): "
                 f"{differing} states differ from the plain loop's")
        max_abs_err = int((got.long() - want.long()).abs().max())
        ms = time_ms(kernel, reps)
        device_ms = kernel_device_ms(kernel, reps)
        plain_ms = time_ms(lambda: pitch.viterbi_decode_reference(
            *fields, params.freq_weight, params.trans_cost), 2, warmup=1)
        bound_ms, bound_by = viterbi_bound(b, t, k)
        rows.append(dict(
            shape=f"B{b}xT{t}xK{k}", max_abs_err=max_abs_err, ms=ms,
            kernel_device_ms=device_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            states_differing=differing))
        # the probe build's split and the measured floor: logged, kept
        # out of the row
        split = probe[(b, t)]
        beside.append(dict(
            plan="shared" if pitch.shared_plan(t, k) else "device",
            shared_bytes=lib.viterbi_shared_bytes(t, k),
            **{key: split[key] for key in (
                "forward_cycles_per_step", "refill_cycles_per_step",
                "backtrace_cycles_per_step", "staging_issue_cycles",
                "staging_wait_cycles",
                "floor_ms", "floor_cycles_per_step")},
            device_ms_over_floor=device_ms / split["floor_ms"]))
    codegen = viterbi_codegen()
    cases += len(rows)
    for row, more in zip(rows, beside):
        log("kernel viterbi_decode", **fmt(row), **fmt(more),
            states_equal_cases=cases)
    for plan in plans:
        log("kernel viterbi_decode plans", **plan, states_equal=True)
    for key, gen in sorted(codegen.items()):
        log("kernel viterbi_decode codegen", instance=key, **gen)
    row = rows[0]
    row["beside"] = {k: rows[1][k] for k in ("shape", "ms",
                                             "kernel_device_ms", "plain_ms",
                                             "bound_ms")}
    row["kernel_codegen"] = codegen
    return row


# the decoder's phases that its probe build times, in the order of
# csrc/viterbi.cu's PROBE_LAP calls; and the shapes the probe runs at
VITERBI_PROBE_PHASES = ("staging_issue", "staging_wait", "forward",
                        "refills", "backtrace")
VITERBI_PROBE_SHAPES = ((1, 257), (16, 501), (28, 1876))


def phase_viterbi_probe(shapes=VITERBI_PROBE_SHAPES, reps: int = 20) -> dict:
    """The probe build of ``csrc/viterbi.cu`` (``-DVITERBI_PROBE``, built
    here into a temporary directory; the port never loads it). At each
    (B, T), K = 12: the decoder's clock64() laps of its phases, lane 0's
    a block: the staging prologue's issue and wait (cycles), and cycles
    a step (over T - 1) of the forward steps, of the chunk refills and of
    the backtrace; its states held to the plain loop, and its device
    time; and the latency floor, a warp a row running T - 1
    iterations of the recurrence's irreducible step (one shuffle, 16
    independent adds, a 4-level min tree, one add): its device time and
    cycles a step. Returns {(b, t): row}."""
    import ctypes

    import torch

    from speechsplit_tpu_torch.ops import pitch

    cycles = (ctypes.c_ulonglong * len(VITERBI_PROBE_PHASES))()
    params = pitch.PitchParams()
    k = params.num_cands
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = pitch._bind(probe_library(tmp, "viterbi", "VITERBI_PROBE"))
        lib.viterbi_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.viterbi_floor_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]
        stream = torch.cuda.current_stream().cuda_stream
        for b, t in shapes:
            fields = viterbi_fields(b, t, k, SEED + b, "random")

            def run():
                return pitch._launch(lib, *fields, params.freq_weight,
                                     params.trans_cost)

            run()
            torch.cuda.synchronize()
            lib.viterbi_probe_read(cycles, 1)  # reset
            got = run()
            torch.cuda.synchronize()
            if lib.viterbi_probe_read(cycles, 1):
                fail("viterbi probe: reading the counters failed")
            want = pitch.viterbi_decode_reference(*fields, params.freq_weight,
                                                  params.trans_cost)
            if not torch.equal(got, want):
                fail(f"viterbi probe build B{b} T{t}: states differ")
            steps = max(t - 1, 1)
            # cycles a block of each phase
            per = {name: cycles[i] / b
                   for i, name in enumerate(VITERBI_PROBE_PHASES)}
            ms = kernel_device_ms(run, reps)
            # the floor: distinct weights a lane, a local cost and a start
            gen = torch.Generator(device="cuda").manual_seed(SEED + t)
            w = torch.rand(18, 32, device="cuda", generator=gen)
            sink = torch.empty(b, 32, device="cuda")
            floor_cycles = torch.empty(b, dtype=torch.int64, device="cuda")

            def floor():
                code = lib.viterbi_floor_launch(
                    w.data_ptr(), sink.data_ptr(), floor_cycles.data_ptr(),
                    b, t, stream)
                if code:
                    fail(f"viterbi floor kernel: CUDA error {code}")

            floor_ms = kernel_device_ms(floor, reps)
            row = dict(
                shape=f"B{b}xT{t}xK{k}", ms_probe_build=ms,
                staging_issue_cycles=round(per["staging_issue"]),
                staging_wait_cycles=round(per["staging_wait"]),
                forward_cycles_per_step=per["forward"] / steps,
                refill_cycles_per_step=per["refills"] / steps,
                backtrace_cycles_per_step=per["backtrace"] / steps,
                floor_ms=floor_ms,
                floor_cycles_per_step=float(floor_cycles.double().mean())
                / steps)
            log("viterbi probe", **fmt(row),
                clock="clock64 of lane 0, a mean over blocks")
            out[(b, t)] = row
    return out


def synth_wav(seconds: float, f_start: float, f_end: float, seed: int):
    """A harmonic tone (4 harmonics) gliding from f_start to f_end Hz,
    with a silent gap over 40-50% of its length and faint noise, peak
    0.5, as int16 PCM at 16 kHz."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = int(seconds * SAMPLE_RATE)
    f0 = f_start * (f_end / f_start) ** (np.arange(n) / n)
    phase = 2.0 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    wav = sum(np.sin(h * phase) / h for h in range(1, 5))
    wav = wav + 0.003 * rng.randn(n)
    wav[int(0.4 * n) : int(0.5 * n)] = 0.0
    wav = wav / np.abs(wav).max() * 0.5
    return (wav * 32767).astype(np.int16)


def f0_agreement(got, want, log_tol=None) -> float:
    """The share of frames whose F0 agrees: the voicing, and where voiced
    the log-F0 within ``log_tol`` (a ``track_pitch`` output), or the
    quantized bin the model reads (a normalized F0, whose values the
    speaker normalization's mean and std tie to every frame)."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.ops.quantize import quantize_f0

    v_got, v_want = got > -1e9, want > -1e9
    if log_tol is None:
        close = (quantize_f0(torch.from_numpy(got)).numpy()
                 == quantize_f0(torch.from_numpy(want)).numpy())
    else:
        close = np.abs(got - want) <= log_tol
    return float(((v_got == v_want) & (~v_got | close)).mean())


def phase_front_end(reps: int = 5):
    """``preprocess.extract_features`` on the card for a 3 s and an 8 s
    wav: one decoder launch an extraction; against the same call with the
    plain decoder on the card (``plain_kernels()``) (mel within ``FRONT_END_PLAIN_TOL``, F0
    equal) and against the call on the CPU with the same dither draws
    (mel within ``FRONT_END_CPU_TOL``, F0 on ``F0_AGREE`` of the frames);
    ms an extraction with the kernel and with the plain loop. Returns the
    launches an extraction and the 8 s wav's mel."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.ops import pitch
    from speechsplit_tpu_torch.preprocess import (
        GENDER_F0_RANGE,
        extract_features,
        frame_count,
        pad_batch,
    )

    lo, hi = GENDER_F0_RANGE["M"]
    long_mel = None
    for seconds, seed in ((SHORT_S, SEED), (LONG_S, SEED + 1)):
        wav = synth_wav(seconds, 110.0, 180.0, seed)
        batch, lengths = pad_batch([wav])
        frames = frame_count(len(wav))
        uniform = torch.rand(batch.shape,
                             generator=torch.Generator().manual_seed(seed))

        def run(device="cuda", plain=False):
            with plain_kernels() if plain else contextlib.nullcontext():
                mel, f0 = extract_features(batch, lengths, [lo], [hi],
                                           uniform=uniform, device=device)
            return mel[0, :frames].cpu().numpy(), f0[0, :frames].cpu().numpy()

        run()  # warm-up: cuFFT plans, the allocator
        torch.cuda.synchronize()
        reset_launches()
        mel, f0 = run()
        launches = read_launches()
        if launches["viterbi_decode"] != 1 or any(
                v for k, v in launches.items() if k != "viterbi_decode"):
            fail(f"extract_features launched {launches}, expected one "
                 f"viterbi_decode")
        if not (np.isfinite(mel).all() and mel.shape == (frames, 80)):
            fail(f"extract_features: mel {mel.shape}, finite "
                 f"{np.isfinite(mel).all()}")
        mel_p, f0_p = run(plain=True)
        mel_c, f0_c = run(device="cpu")
        err_plain = float(np.abs(mel - mel_p).max())
        err_cpu = float(np.abs(mel - mel_c).max())
        agree = f0_agreement(f0, f0_c)
        # the tracker alone on one dithered signal, on either device
        y = (torch.from_numpy(batch.astype(np.float32) / 32768.0) * 0.96
             + (uniform - 0.5) * 2.0 * 1e-6)
        tracks = [pitch.track_pitch(
            y.to(device), torch.from_numpy(lengths), torch.tensor([lo]),
            torch.tensor([hi]))[0, :frames].cpu().numpy()
            for device in ("cuda", "cpu")]
        track_agree = f0_agreement(*tracks, log_tol=1e-5)
        off = np.nonzero(np.abs(np.where(tracks[0] > -1e9, tracks[0], 0)
                                - np.where(tracks[1] > -1e9, tracks[1], 0))
                         > 1e-5)[0]
        if not err_plain <= FRONT_END_PLAIN_TOL or not np.array_equal(
                f0, f0_p):
            fail(f"extract_features {seconds} s, kernel vs plain decoder: "
                 f"mel {err_plain}, F0 equal {np.array_equal(f0, f0_p)}")
        if not (err_cpu <= FRONT_END_CPU_TOL and agree >= F0_AGREE
                and track_agree >= F0_AGREE):
            fail(f"extract_features {seconds} s, card vs CPU: mel "
                 f"{err_cpu}, F0 agreement {agree} (bins), track_pitch "
                 f"{track_agree} (frames off {off.tolist()[:20]} of "
                 f"{frames})")

        def timed(plain, n):
            samples = []
            for _ in range(n):
                torch.cuda.synchronize()
                start = time.perf_counter()
                run(plain=plain)  # ends in the fetch to the host
                samples.append((time.perf_counter() - start) * 1e3)
            return float(np.median(samples))

        ms = timed(False, reps)
        plain_ms = timed(True, 2)
        # the tracker's window-sum prefix sums at this extraction's padded
        # length: in XLA's CPU summation order (what runs) and as two
        # float64 torch.cumsum calls, the alternative that rounds otherwise
        padded = torch.nn.functional.pad(
            y.to("cuda"), (0, batch.shape[1] // 256 * 256 + 440))
        prefix_ms = time_ms(lambda: pitch._window_prefix_sums(padded), reps)
        wide = padded.double()
        cumsum_ms = time_ms(lambda: (torch.cumsum(wide * wide, -1),
                                     torch.cumsum(wide, -1)), reps)
        log("front end", seconds=seconds, samples_padded=batch.shape[1],
            frames=frames, ms_per_extraction=f"{ms:.4f}",
            plain_decoder_ms_per_extraction=f"{plain_ms:.4f}",
            viterbi_launches=launches["viterbi_decode"],
            mel_err_vs_plain_decoder=f"{err_plain:.3g}",
            f0_equal_plain_decoder=True, mel_err_vs_cpu=f"{err_cpu:.3g}",
            f0_bin_agreement_vs_cpu=f"{agree:.4f}",
            track_pitch_agreement_vs_cpu=f"{track_agree:.4f}",
            track_pitch_frames_off=",".join(map(str, off)) or "none",
            voiced_share=f"{float((f0 > -1e9).mean()):.3f}",
            prefix_sums_ms=f"{prefix_ms:.4f}",
            cumsum_f64_ms=f"{cumsum_ms:.4f}")
        long_mel = mel
    return launches["viterbi_decode"], long_mel


def phase_vocoder(mel, reps: int = 3) -> None:
    """``GriffinLimVocoder.synthesize_batch`` (100 iterations) on
    ``VOCODER_MELS`` windows of ``max_len_pad`` frames cut from ``mel``:
    finite float wavs, the PCM16 path within 1 LSB of the float path's
    samples times 32767, ms a call of each."""
    import numpy as np

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.vocoder import GriffinLimVocoder

    t = SpeechSplitConfig().max_len_pad
    starts = np.linspace(0, len(mel) - t, VOCODER_MELS).astype(int)
    mels = [mel[s : s + t] for s in starts]
    vocoder = GriffinLimVocoder(device="cuda")
    wavs = vocoder.synthesize_batch(mels)
    if not all(np.isfinite(w).all() and len(w) == (t - 1) * vocoder.hop
               for w in wavs):
        fail("GriffinLimVocoder: non-finite or mis-sized wavs")
    pcm = vocoder.synthesize_batch(mels, pcm16=True)
    lsb = max(float(np.abs(q.astype(np.float64) - w * 32767.0).max())
              for q, w in zip(pcm, wavs))
    if not (all(q.dtype == np.int16 for q in pcm) and lsb <= 1.0):
        fail(f"GriffinLimVocoder pcm16: {lsb} LSB from the float path")

    def timed(pcm16):
        samples = []
        for _ in range(reps):
            start = time.perf_counter()
            vocoder.synthesize_batch(mels, pcm16=pcm16)  # ends in a fetch
            samples.append((time.perf_counter() - start) * 1e3)
        return float(np.median(samples))

    log("vocoder", mels=len(mels), frames=t, n_iter=vocoder.n_iter,
        ms_per_call=f"{timed(False):.4f}",
        ms_per_call_pcm16=f"{timed(True):.4f}",
        pcm16_max_lsb_vs_float=f"{lsb:.3f}")


def post_convert(url: str, payload: dict) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/convert",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def check_reply(status: int, body: dict, what: str) -> dict:
    """200 with 7 conditions, each a finite mel .npy and an int16 wav of
    (frames - 1) * hop samples; returns {condition: mel}."""
    import numpy as np
    from scipy.io import wavfile

    if status != 200 or len(body.get("results", {})) != 7:
        fail(f"serve {what}: status {status}, {str(body)[:300]}")
    mels = {}
    for condition, info in body["results"].items():
        mel = np.load(info["mel_path"])
        rate, wav = wavfile.read(info["wav_path"])
        if not (np.isfinite(mel).all() and list(mel.shape) ==
                info["mel_shape"] and mel.shape[1] == 80):
            fail(f"serve {what} {condition}: bad mel {mel.shape}")
        if not (rate == SAMPLE_RATE and wav.dtype == np.int16
                and len(wav) == (len(mel) - 1) * 256 and wav.any()):
            fail(f"serve {what} {condition}: bad wav {wav.dtype} {wav.shape}")
        mels[condition] = mel
    return mels


def phase_serve(reps: int = 5):
    """The port's ``cli.serve`` handler in a thread on an ephemeral port,
    full-width models with seeded weights loaded from ``.ckpt`` files:
    three ``POST /convert`` requests (a 3 s pair, an 8 s pair, which takes
    ``convert_long``, and the first again, whose mels must equal the
    first's) with the launches of each; each pair's mels against the same
    call under ``plain_kernels()`` (plain LSTMs and plain decoder), its F0
    equal; ms a request (median after a warm-up) with its split, and the
    card's busy share of one request under ``torch.profiler``. Returns
    the three requests' launches."""
    import threading
    from http.server import HTTPServer

    import numpy as np
    import torch
    from scipy.io import wavfile
    from torch.profiler import ProfilerActivity, profile

    from speechsplit_tpu_torch.cli.serve import build_handler
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.data.prepare import read_wav
    from speechsplit_tpu_torch.interop import save_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
    from speechsplit_tpu_torch.pipeline import VoiceConverter

    config = SpeechSplitConfig()
    gen = torch.Generator().manual_seed(SEED + 13)
    with tempfile.TemporaryDirectory() as tmp:
        g_path = os.path.join(tmp, "G.ckpt")
        p_path = os.path.join(tmp, "P.ckpt")
        save_reference_checkpoint(SpeechSplit(config, generator=gen), g_path)
        save_reference_checkpoint(F0Converter(config, generator=gen), p_path)
        converter = VoiceConverter.from_checkpoints(g_path, p_path,
                                                    config=config,
                                                    device="cuda")
        pairs = {}
        for name, seconds in (("short", SHORT_S), ("long", LONG_S)):
            paths = []
            for side, (f_a, f_b) in (("src", (105.0, 150.0)),
                                     ("trg", (190.0, 260.0))):
                path = os.path.join(tmp, f"{name}_{side}.wav")
                wavfile.write(path, SAMPLE_RATE, synth_wav(
                    seconds, f_a, f_b, SEED + len(paths) + int(seconds)))
                paths.append(path)
            pairs[name] = {"source_wav": paths[0], "target_wav": paths[1],
                           "out_dir": os.path.join(tmp, f"out_{name}")}
        httpd = HTTPServer(("127.0.0.1", 0),
                           build_handler(converter, os.path.join(tmp, "out")))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_port}"
        try:
            with strict_float32("serve: the requests, the plain calls and "
                                "the timing"):
                check_reply(*post_convert(url, pairs["short"]), "warm-up")
                torch.cuda.synchronize()
                reset_launches()
                per_request = []
                replies = []
                for name in ("short", "long", "short"):
                    before = read_launches()
                    replies.append(check_reply(
                        *post_convert(url, pairs[name]), name))
                    after = read_launches()
                    per_request.append({k: after[k] - before[k]
                                        for k in ("viterbi_decode",
                                                  "bilstm_infer",
                                                  "multi_bilstm_infer",
                                                  "lstm_infer")})
                launches = read_launches()
                for kernel in ("viterbi_decode", "bilstm_infer",
                               "multi_bilstm_infer"):
                    if not launches[kernel]:
                        fail(f"serve: three requests launched no {kernel}")
                repeat = max(float(np.abs(replies[0][c] - replies[2][c]).max())
                             for c in replies[0])
                if not repeat <= REPEAT_TOL:
                    fail(f"serve: the repeated request's mels differ by "
                         f"{repeat}")
                errs = {}
                for name, reply in (("short", replies[0]),
                                    ("long", replies[1])):
                    src, trg = (pairs[name]["source_wav"],
                                pairs[name]["target_wav"])
                    wav = read_wav(src)
                    f0 = converter.extract_features_full(wav, "M")[1]
                    with plain_kernels():
                        f0_plain = converter.extract_features_full(wav,
                                                                   "M")[1]
                        plain = converter.convert_wav_files(
                            src, trg, synthesize=False)
                    if not np.array_equal(f0, f0_plain):
                        fail(f"serve {name}: F0 differs from the plain call's")
                    errs[name] = max(float(np.abs(reply[c] - plain[c]["mel"])
                                           .max()) for c in reply)
                    if not errs[name] <= PATH_TOL:
                        fail(f"serve {name}: mels {errs[name]} from the plain "
                             f"call's")
                timings = {}
                for name in ("short", "long"):
                    walls, splits = [], []
                    for _ in range(reps):
                        start = time.perf_counter()
                        check_reply(*post_convert(url, pairs[name]), name)
                        walls.append((time.perf_counter() - start) * 1e3)
                        splits.append(dict(converter.last_timings))
                    timings[name] = {"ms_per_request": float(np.median(walls))}
                    for key in splits[0]:
                        timings[name][key] = float(np.median(
                            [s[key] for s in splits]))
                short = pairs["short"]
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    start = time.perf_counter()
                    converter.convert_wav_files(
                        short["source_wav"], short["target_wav"], pcm16=True,
                        compress_results="auto")
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - start) * 1e3
        finally:
            httpd.shutdown()
            thread.join()
        for name, row in timings.items():
            log("serve", pair=name,
                seconds=SHORT_S if name == "short" else LONG_S,
                **{k: f"{v:.4f}" for k, v in row.items()},
                launches=json.dumps(per_request[0 if name == "short" else 1]
                                    ).replace(" ", ""),
                max_abs_err_vs_plain=f"{errs[name]:.3g}", tol=PATH_TOL)
        log("serve", requests=3, all_status=200, repeat_max_abs=f"{repeat:.3g}",
            launches_three_requests=json.dumps(
                {k: v for k, v in launches.items() if v}).replace(" ", ""),
            tf32="off")
        profile_events("serve profile", prof, wall_ms, top=10)
        del converter, prof
    return launches


# the IIR kernel (csrc/iir.cu) under the filter oracles: its instances by
# the name the kernels' line gives them, with the function a user calls,
# its dtype and filter. The high-pass is the reference's (30 Hz, order 5:
# three sections); its (b, a) form NaNs in float32, so the float32 direct
# form runs a stable low-pass.
IIR_KERNELS = {
    "sosfilt/float32": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/iir.cu",
        replaces="speechsplit_tpu/ops/filters.py:48"),
    "sosfilt/float64": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/iir.cu",
        replaces="speechsplit_tpu/ops/filters.py:48"),
    "lfilter/float64": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/iir.cu",
        replaces="speechsplit_tpu/ops/filters.py:104"),
    "lfilter/float32": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/iir.cu",
        replaces="speechsplit_tpu/ops/filters.py:104"),
}
# H100 SXM float64 peak outside the tensor cores (NVIDIA data sheet)
PEAK_F64_FLOPS = 34e12
# the batch of the main path's calls, and the samples of the check
# against the plain loop on the card (its ~27 launches a sample take
# seconds at a 3 s clip's 48,000)
IIR_BATCH = 16
IIR_CHECK_SAMPLES = 2000
# the kernel at full length against scipy's float64 filters on the host:
# the sections at float64 round in another order than scipy's (about
# 2e-13 measured on the CPU for the port's plain loop), the direct form
# at float64 in scipy's order (equal); at float32, 4 times the distance
# of JAX's float32 high-pass from the float64 result on the smoke's 8 s
# wav (6.1e-5, measured on the CPU), and of the float32 low-pass (8.8e-7)
IIR_F64_TOL = 1e-10
IIR_BA_F64_TOL = 1e-12
IIR_F32_TOL = 2.5e-4
IIR_LOWPASS_F32_TOL = 3.5e-6


def iir_filter(name: str):
    """(the zero-phase call, its dtype, its scipy float64 oracle, its
    sections or order) of an ``IIR_KERNELS`` instance."""
    import torch
    from scipy import signal as sp_signal

    from speechsplit_tpu_torch.ops import filters

    kind, dtype = name.split("/")
    dtype = getattr(torch, dtype)
    if kind == "sosfilt":
        sos = filters.butter_highpass_sos(30.0, float(SAMPLE_RATE), 5)
        return (filters.highpass_filtfilt, dtype,
                lambda x: sp_signal.sosfiltfilt(sos, x), len(sos))
    b, a = iir_ba(name)
    return (lambda x: filters.filtfilt(b, a, x), dtype,
            lambda x: sp_signal.filtfilt(b, a, x), len(a) - 1)


def iir_bound(kind: str, m: int, n: int, order: int,
              itemsize: int) -> tuple:
    """(bound ms, what bounds it) of one pass over m signals of n samples:
    each sample read once and written once over the memory rate; the
    operations a sample (sosfilt: 9 a section, 5 products and 4 sums;
    lfilter: 2 + 4 an order) over the dtype's peak. The dependent chain
    is measured instead (``iir_floor_ms``)."""
    by_bytes = 2 * m * n * itemsize / PEAK_BYTES * 1e3
    peak = PEAK_F64_FLOPS if itemsize == 8 else PEAK_F32_FLOPS
    ops = 9 * order if kind == "sosfilt" else 2 + 4 * order
    by_ops = ops * m * n / peak * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes,
                                                            "bytes")


def iir_floor_ms(m: int, steps: int, itemsize: int, reps: int) -> float:
    """The measured floor: the device time of ``iir_floor_launch``, m
    threads each running ``steps`` dependent multiply-adds rounded as the
    filters round. A pass's floor takes samples x stages steps, the
    stages its sections (sosfilt: the chain through the cascade) or 1
    (lfilter: the direct form's one y a sample)."""
    import torch

    from speechsplit_tpu_torch.ops import filters

    lib = filters._library()
    dtype = torch.float64 if itemsize == 8 else torch.float32
    sink = torch.zeros(m, dtype=dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def floor():
        code = lib.iir_floor_launch(sink.data_ptr(), m, steps,
                                    int(itemsize == 8), stream)
        if code:
            fail(f"iir floor kernel: CUDA error {code}")

    return kernel_device_ms(floor, reps)


IIR_ENTRY = re.compile(r"(sosfilt|lfilter|iir_floor)_kernelI([fd])(?:Li(\d+)E)?")


def iir_codegen(jobs) -> dict:
    """Registers, spill stores and stack frame of each ``csrc/iir.cu``
    kernel instance, by name (``sosfilt<f,3>`` ...), from the ``-Xptxas
    -v`` report that ``start_codegen(["iir"])`` started."""
    import shutil

    (_, tmp, proc), = jobs
    _, text = proc.communicate()
    shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode:
        fail(f"ptxas report of iir.cu: rc {proc.returncode}\n{text[-2000:]}")
    out, key = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = IIR_ENTRY.search(line)
            key = m and f"{m[1]}<{m[2]}{',' + m[3] if m[3] else ''}>"
        elif key and "spill stores" in line:
            row = out.setdefault(key, {})
            row["spill_stores"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
            row["stack_frame"] = int(
                re.search(r"(\d+) bytes stack frame", line)[1])
        elif key and "Used" in line and "registers" in line:
            out.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            key = None
    return out


def iir_signals(b: int, seconds: float, seed: int, dtype):
    """b of the smoke's wavs (``synth_wav``, 110-180 Hz glides, seeds
    seed..seed+b-1) as a [b, N] tensor of dtype on the card, and the
    same as float64 on the host."""
    import numpy as np
    import torch

    host = np.stack([synth_wav(seconds, 110.0, 180.0, seed + i)
                     for i in range(b)]).astype(np.float32) / 32768.0
    return (torch.from_numpy(host).to("cuda", dtype),
            host.astype(np.float64))


@contextlib.contextmanager
def plain_iir():
    """The IIR kernel's wrappers replaced by the plain loops, which then
    run on CUDA tensors (the comparison's side of ``phase_iir``)."""
    from speechsplit_tpu_torch.ops import filters

    saved = filters.sosfilt_cuda, filters.lfilter_cuda

    def sos_plain(sos, x, zi):
        return filters.sosfilt_reference(
            filters._coefficients(sos, x.dtype, x.device), x, zi)

    def ba_plain(b, a, x, zi):
        return filters.lfilter_reference(
            filters._coefficients(b, x.dtype, x.device),
            filters._coefficients(a, x.dtype, x.device), x, zi)

    filters.sosfilt_cuda, filters.lfilter_cuda = sos_plain, ba_plain
    try:
        yield
    finally:
        filters.sosfilt_cuda, filters.lfilter_cuda = saved


def iir_pass_args(name: str, b: int, seconds: float, samples=None):
    """One pass's arguments for an ``IIR_KERNELS`` instance: b of the
    smoke's wavs (the first ``samples`` of each if given) and the
    steady-state states scaled by each first sample, as the zero-phase
    calls start; (the wrapper's, the plain loop's) arguments."""
    import numpy as np
    from scipy import signal as sp_signal

    from speechsplit_tpu_torch.ops import filters

    _, dtype, _, _ = iir_filter(name)
    xs, _ = iir_signals(b, seconds, SEED + 200, dtype)
    if samples:
        xs = xs[:, :samples].contiguous()
    if name.startswith("sosfilt"):
        sos = filters.butter_highpass_sos(30.0, float(SAMPLE_RATE), 5)
        zi = filters._coefficients(sp_signal.sosfilt_zi(sos), dtype, "cuda")
        zi = (zi[None] * xs[:, :1, None]).contiguous()
        return (sos, xs, zi), (filters._coefficients(sos, dtype, "cuda"),
                               xs, zi)
    b_, a_ = iir_ba(name)
    zi = filters._coefficients(sp_signal.lfilter_zi(b_, a_), dtype, "cuda")
    zi = (zi[None] * xs[:, :1]).contiguous()
    return (b_, a_, xs, zi), (filters._coefficients(b_, dtype, "cuda"),
                              filters._coefficients(a_, dtype, "cuda"), xs,
                              zi)


def iir_ba(name: str):
    """The (b, a) filter of an ``lfilter`` instance: the high-pass at
    float64, a stable second-order low-pass at float32."""
    from scipy import signal as sp_signal

    from speechsplit_tpu_torch.ops import filters

    if name.endswith("float64"):
        return filters.butter_highpass(30.0, float(SAMPLE_RATE), 5)
    return sp_signal.butter(2, 0.1)


def phase_iir(reps: int = 10) -> dict:
    """``[kernel sosfilt]`` and ``[kernel lfilter]``: each instance of
    ``IIR_KERNELS`` through its zero-phase call (``highpass_filtfilt``,
    ``filtfilt``) on the card. Against the same call with the plain loop
    on the card (``filters.sosfilt_reference``, ``lfilter_reference``) at
    B16 x ``IIR_CHECK_SAMPLES``, bit for bit; then the main path, B16 x
    the 3 s and 8 s wavs and B1 x 3 s, with the counts set to 0 just
    before and read just after (2 launches a call), each output against
    scipy's float64 filter on the host (``IIR_*_TOL``); ms a wrapper call
    (one pass, CUDA events) and its device time (calls queued behind a
    spin kernel) at B1 and B16 x 3 s and at B16 x 8 s, the plain loop's
    ms at the check's shape beside the kernel's there, the bound, the
    measured floor (samples x stages dependent steps) and each instance's
    registers, spills and stack frame. Returns {name: row}."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.ops import filters

    codegen_jobs = start_codegen(["iir"])  # compiles while the checks run
    rows = {}
    for name in IIR_KERNELS:
        call, dtype, oracle, stages = iir_filter(name)
        kind = name.split("/")[0]
        itemsize = torch.finfo(dtype).bits // 8
        tol = {("sosfilt", 8): IIR_F64_TOL, ("sosfilt", 4): IIR_F32_TOL,
               ("lfilter", 8): IIR_BA_F64_TOL,
               ("lfilter", 4): IIR_LOWPASS_F32_TOL}[kind, itemsize]
        wrapper = getattr(filters, f"{kind}_cuda")
        plain = getattr(filters, f"{kind}_reference")

        # the kernel against the plain loop on the card, both passes
        x, _ = iir_signals(IIR_BATCH, 3.0, SEED, dtype)
        x = x[:, :IIR_CHECK_SAMPLES].contiguous()
        got = call(x)
        with plain_iir():
            want = call(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{name}: the kernel differs from the plain loop by "
                 f"{float((got - want).abs().max()):.3g} at "
                 f"B{IIR_BATCH}xN{IIR_CHECK_SAMPLES}")
        max_abs_err = float((got - want).abs().max())

        # the main path: the counts set to 0 just before, read just after
        outs = []
        reset_launches()
        for b, seconds in ((IIR_BATCH, SHORT_S), (IIR_BATCH, LONG_S),
                           (1, SHORT_S)):
            xs, host = iir_signals(b, seconds, SEED + 100, dtype)
            outs.append((call(xs), oracle(host), b, seconds))
        torch.cuda.synchronize()
        launches = read_launches()
        if launches[kind] != 2 * len(outs) or any(
                v for k, v in launches.items() if k != kind):
            fail(f"{name}: launched {launches}, expected {2 * len(outs)} "
                 f"{kind} (two a zero-phase call)")
        oracle_err = 0.0
        for y, truth, b, seconds in outs:
            err = float(np.abs(y.double().cpu().numpy() - truth).max())
            if not (err <= tol and bool(torch.isfinite(y).all())):
                fail(f"{name} B{b} {seconds} s: {err:.3g} from scipy's "
                     f"float64 filter, bar {tol}")
            oracle_err = max(oracle_err, err)

        timed = {}
        for b, seconds in ((1, SHORT_S), (IIR_BATCH, SHORT_S),
                           (IIR_BATCH, LONG_S)):
            args, _ = iir_pass_args(name, b, seconds)
            n = args[-2].shape[1]  # (..., x, zi)
            timed[(b, seconds)] = dict(
                shape=f"B{b}xN{n}", ms=time_ms(lambda: wrapper(*args), reps),
                kernel_device_ms=kernel_device_ms(lambda: wrapper(*args),
                                                  reps),
                floor_ms=iir_floor_ms(
                    b, n * (stages if kind == "sosfilt" else 1), itemsize,
                    reps),
                bound=iir_bound(kind, b, n, stages, itemsize))
        args, plain_args = iir_pass_args(name, IIR_BATCH, SHORT_S,
                                         IIR_CHECK_SAMPLES)
        plain_ms = time_ms(lambda: plain(*plain_args), 1, warmup=0)
        check_ms = time_ms(lambda: wrapper(*args), reps)
        main = timed[(IIR_BATCH, SHORT_S)]
        bound_ms, bound_by = main["bound"]
        row = dict(
            shape=main["shape"], max_abs_err=max_abs_err, ms=main["ms"],
            kernel_device_ms=main["kernel_device_ms"],
            plain_ms=plain_ms,
            plain_shape=f"B{IIR_BATCH}xN{IIR_CHECK_SAMPLES}",
            ms_at_plain_shape=check_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, floor_ms=main["floor_ms"],
            launches_per_zero_phase_call=2,
            max_err_vs_scipy_float64=oracle_err)
        beside = {f"B{b}x{s:g}s": dict(
            shape=t["shape"], ms=t["ms"],
            kernel_device_ms=t["kernel_device_ms"], floor_ms=t["floor_ms"],
            bound_ms=t["bound"][0],
            device_ms_over_floor=t["kernel_device_ms"] / t["floor_ms"])
            for (b, s), t in timed.items()}
        log(f"kernel {kind}", instance=name, **fmt(row), functions=(
            "sosfilt,sosfiltfilt,highpass_filtfilt" if kind == "sosfilt"
            else "lfilter,filtfilt"), launches=launches[kind])
        for label, more in beside.items():
            log(f"kernel {kind} timed", instance=name, at=label, **fmt(more))
        row["beside"] = beside
        row["main_path_launches"] = launches[kind]
        rows[name] = row
    codegen = iir_codegen(codegen_jobs)
    for name, row in rows.items():
        kind, dtype = name.split("/")
        instance = (f"{kind}<{'d' if dtype == 'float64' else 'f'},"
                    f"{iir_filter(name)[3]}>")
        gen = codegen.get(instance)
        if gen is None:
            fail(f"{name}: no {instance} in iir.cu's codegen "
                 f"({sorted(codegen)})")
        log(f"kernel {kind} codegen", instance=instance, **gen)
        row["kernel_codegen"] = gen
    return rows


# the time mode's high-passed, dithered signal on the card against the
# CPU's: float32 rffts of 131,072 and 262,144 points in two libraries.
# JAX's and PyTorch's CPU FFTs differ by 4.8e-7 at 65,536 points of noise
# of amplitude 0.3 (tests/test_torch_filters.py); four times that
ZERO_PHASE_CPU_TOL = 2e-6


def phase_front_end_time(reps: int = 3) -> int:
    """``[front end time]``: ``extract_features(highpass_mode="time")``
    (the FFT high-pass on the waveform, ``ops.filters.zero_phase_highpass``,
    before the gain and dither) on the 3 s and 8 s wavs of
    ``phase_front_end``: one ``viterbi_decode`` launch an extraction and
    no other. Against the CPU in two parts: the high-passed, dithered
    signal within ``ZERO_PHASE_CPU_TOL`` of the CPU's, and the rest of the
    path on the card's signal (the mel within ``FRONT_END_CPU_TOL`` and
    the F0 on ``F0_AGREE`` of the frames of ``mel_spectrogram`` and
    ``track_pitch`` on the CPU). The whole call on the CPU, with its own
    high-pass, is reported beside it: the wav's digital-silence gap
    holds only the dither (1e-6) and the high-pass's rounding, so a
    frame's voicing there, and through the speaker normalization every
    frame's F0 bin, follows the FFT library's rounding. ms an extraction
    beside the ``"stft"`` mode's, in turns (time, stft, stft, time).
    Returns the launches an extraction."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.ops.filters import zero_phase_highpass
    from speechsplit_tpu_torch.ops.pitch import track_pitch
    from speechsplit_tpu_torch.ops.stft import mel_spectrogram
    from speechsplit_tpu_torch.preprocess import (
        GENDER_F0_RANGE,
        extract_features,
        frame_count,
        normalize_log_f0,
        pad_batch,
    )

    lo, hi = GENDER_F0_RANGE["M"]
    per_extraction = 0
    for seconds, seed in ((SHORT_S, SEED), (LONG_S, SEED + 1)):
        wav = synth_wav(seconds, 110.0, 180.0, seed)
        batch, lengths = pad_batch([wav])
        frames = frame_count(len(wav))
        uniform = torch.rand(batch.shape,
                             generator=torch.Generator().manual_seed(seed))

        def run(mode="time", device="cuda"):
            mel, f0 = extract_features(batch, lengths, [lo], [hi],
                                       uniform=uniform, device=device,
                                       highpass_mode=mode)
            return mel[0, :frames].cpu().numpy(), f0[0, :frames].cpu().numpy()

        def dithered(device):
            """The signal the time mode's mel and tracker see
            (preprocess.extract_features: high-pass, gain, dither)."""
            w = torch.from_numpy(batch.astype(np.float32) / 32768.0)
            y = zero_phase_highpass(w.to(device),
                                    torch.from_numpy(lengths).to(device))
            return y * 0.96 + (uniform.to(device) - 0.5) * 2.0 * 1e-6

        run()  # warm-up: cuFFT plans at the extension's length
        torch.cuda.synchronize()
        reset_launches()
        mel, f0 = run()
        launches = read_launches()
        if launches["viterbi_decode"] != 1 or any(
                v for k, v in launches.items() if k != "viterbi_decode"):
            fail(f"extract_features(time) launched {launches}, expected one "
                 f"viterbi_decode")
        per_extraction = launches["viterbi_decode"]
        y_card = dithered("cuda").cpu()
        y_err = float((y_card - dithered("cpu")).abs().max())
        bounds = (torch.from_numpy(lengths), torch.tensor([lo]),
                  torch.tensor([hi]))
        mel_c = mel_spectrogram(y_card)[0, :frames].numpy()
        f0_c = normalize_log_f0(track_pitch(y_card, *bounds))[
            0, :frames].numpy()
        err_cpu = float(np.abs(mel - mel_c).max())
        agree = f0_agreement(f0, f0_c)
        if not (np.isfinite(mel).all() and y_err <= ZERO_PHASE_CPU_TOL
                and err_cpu <= FRONT_END_CPU_TOL and agree >= F0_AGREE):
            fail(f"extract_features(time) {seconds} s, card vs CPU: the "
                 f"high-passed signal {y_err}, on the card's signal mel "
                 f"{err_cpu} and F0 agreement {agree}")
        mel_w, f0_w = run(device="cpu")
        mel_stft, _ = run("stft")
        samples = {"time": [], "stft": []}
        for _ in range(reps):
            for mode in ("time", "stft", "stft", "time"):
                torch.cuda.synchronize()
                start = time.perf_counter()
                run(mode)  # ends in the fetch to the host
                samples[mode].append((time.perf_counter() - start) * 1e3)
        log("front end time", seconds=seconds, samples_padded=batch.shape[1],
            frames=frames, viterbi_launches=per_extraction,
            highpass_err_vs_cpu=f"{y_err:.3g}",
            mel_err_vs_cpu_on_card_signal=f"{err_cpu:.3g}",
            f0_bin_agreement_vs_cpu_on_card_signal=f"{agree:.4f}",
            whole_call_mel_err_vs_cpu=f"{float(np.abs(mel - mel_w).max()):.3g}",
            whole_call_f0_bin_agreement_vs_cpu=f"{f0_agreement(f0, f0_w):.4f}",
            whole_call_voicing_agreement_vs_cpu=(
                f"{float(((f0 > -1e9) == (f0_w > -1e9)).mean()):.4f}"),
            mel_mean_abs_vs_stft_mode=(
                f"{float(np.abs(mel - mel_stft).mean()):.3g}"),
            voiced_share=f"{float((f0 > -1e9).mean()):.3f}",
            ms_time_mode=f"{float(np.median(samples['time'])):.4f}",
            ms_stft_mode=f"{float(np.median(samples['stft'])):.4f}",
            timing="median of turns (time, stft, stft, time), host clock "
                   "to the fetch")
    return per_extraction


# the [pitch decoders] phase's batch: 3 s synthetic utterances
# (data.synthetic.random_utterance, alternating 95-135 and 175-235 Hz
# bases), and the options it runs beside the default
DECODER_BATCH = 16
DECODER_OPTIONS = (("parallel_viterbi", dict(parallel_viterbi=True)),
                   ("block_viterbi_4", dict(block_viterbi=4)),
                   ("block_viterbi_16", dict(block_viterbi=16)),
                   ("topk_by_max", dict(topk_by_sort=False)),
                   ("nccf_by_conv", dict(nccf_by_conv=True)))
# JAX's bars between its own decoders (tests/test_pitch.py:133-193: 1% of
# frames may flip voicing on reassociated ties, F0 equal where both
# voice) and for the conv NCCF (:283-290: 98% voicing, log-F0 within
# 5e-3)
DECODER_VOICING = 0.99
CONV_VOICING = 0.98
CONV_LOG_TOL = 5e-3
# gross pitch error: a voiced frame more than 20% off the ground truth
GPE_REL = 0.2


def decoder_batch(seed: int):
    """``DECODER_BATCH`` 3 s utterances [B, N] on the card, their
    lengths, the gender bounds of each and the synthesis ground truth
    (f0, voiced, scoreable) [B, T] of each."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.data.synthetic import random_utterance
    from speechsplit_tpu_torch.preprocess import GENDER_F0_RANGE

    n = int(SHORT_S * SAMPLE_RATE)
    wavs, truth, bounds = [], [], []
    rng = np.random.RandomState(seed)
    for i in range(DECODER_BATCH):
        base = (rng.uniform(95.0, 135.0) if i % 2 == 0
                else rng.uniform(175.0, 235.0))
        stim = random_utterance(seed * 101 + i, base, duration_s=SHORT_S)
        wav = np.zeros(n, np.float32)
        wav[: min(n, len(stim.wav))] = stim.wav[:n]
        wavs.append(wav)
        stim.wav = wav  # the ground truth at the cut length
        for name in ("f0_per_sample", "voiced_per_sample", "transition"):
            arr = getattr(stim, name)
            cut = np.zeros(n, arr.dtype)
            cut[: min(n, len(arr))] = arr[:n]
            setattr(stim, name, cut)
        truth.append(stim.frame_ground_truth())
        bounds.append(GENDER_F0_RANGE["M" if i % 2 == 0 else "F"])
    x = torch.from_numpy(np.stack(wavs)).to("cuda")
    lengths = torch.full((DECODER_BATCH,), n, dtype=torch.int64)
    lo = torch.tensor([b[0] for b in bounds])
    hi = torch.tensor([b[1] for b in bounds])
    gt = [np.stack([t[j] for t in truth]) for j in range(3)]
    return x, lengths, lo, hi, gt


def gross_pitch_error(logf0, gt) -> float:
    """The share of scoreable frames voiced in the ground truth and in
    ``logf0`` whose F0 is more than ``GPE_REL`` off the truth."""
    import numpy as np

    f0, voiced, scoreable = gt
    est = logf0 > -1e9
    both = scoreable & voiced & est
    if not both.any():
        return float("nan")
    off = np.abs(np.exp(np.where(both, logf0, 0.0)) - f0) > GPE_REL * f0
    return float((off & both).sum() / both.sum())


def phase_pitch_decoders(reps: int = 3) -> dict:
    """``[pitch decoders]``: ``track_pitch`` on the card over a B16 batch
    of 3 s synthetic utterances with the default options and with each of
    ``DECODER_OPTIONS``. Against the default: the parallel and block
    decoders voice the same on ``DECODER_VOICING`` of the frames with F0
    equal where both voice, ``topk_by_sort=False`` bit for bit,
    ``nccf_by_conv=True`` on ``CONV_VOICING`` with log-F0 within
    ``CONV_LOG_TOL``; the gross pitch error against the synthesis ground
    truth of each; the ``viterbi_decode`` launches of a call (1 for the
    serial decoder's options, 0 for the parallel and block decoders); ms
    a call beside the default's, in turns. Returns {option: launches}."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.ops import pitch

    x, lengths, lo, hi, gt = decoder_batch(SEED + 7)

    def track(opts):
        return pitch.track_pitch(x, lengths, lo, hi,
                                 params=pitch.PitchParams(**opts))

    track({})  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    base = track({}).cpu().numpy()
    default_launches = read_launches()["viterbi_decode"]
    if default_launches != 1:
        fail(f"track_pitch launched viterbi_decode {default_launches} times")
    gpe = {"default": gross_pitch_error(base, gt)}
    out = {"default": default_launches}
    for label, opts in DECODER_OPTIONS:
        track(opts)
        torch.cuda.synchronize()
        reset_launches()
        got = track(opts).cpu().numpy()
        launches = read_launches()
        serial = not (opts.get("parallel_viterbi") or opts.get(
            "block_viterbi", 0) > 1)
        if launches["viterbi_decode"] != int(serial) or any(
                v for k, v in launches.items() if k != "viterbi_decode"):
            fail(f"track_pitch {label} launched {launches}")
        voiced, voiced_d = got > -1e9, base > -1e9
        same_voicing = float((voiced == voiced_d).mean())
        both = voiced & voiced_d
        log_err = float(np.abs(got - base)[both].max()) if both.any() else 0.0
        if label == "topk_by_max":
            ok = np.array_equal(got, base)
        elif label == "nccf_by_conv":
            ok = same_voicing >= CONV_VOICING and log_err <= CONV_LOG_TOL
        else:
            ok = same_voicing >= DECODER_VOICING and log_err == 0.0
        if not ok:
            fail(f"track_pitch {label} against the default: voicing "
                 f"{same_voicing}, log-F0 {log_err} where both voice")
        samples = {"default": [], label: []}
        for _ in range(reps):
            for which in ("default", label, label, "default"):
                torch.cuda.synchronize()
                start = time.perf_counter()
                track({} if which == "default" else opts).cpu()
                samples[which].append((time.perf_counter() - start) * 1e3)
        gpe[label] = gross_pitch_error(got, gt)
        out[label] = launches["viterbi_decode"]
        log("pitch decoders", option=label,
            shape=f"B{DECODER_BATCH}xN{x.shape[1]}",
            voicing_same_as_default=f"{same_voicing:.4f}",
            max_log_f0_diff_both_voiced=f"{log_err:.3g}",
            bit_equal_default=bool(np.array_equal(got, base)),
            viterbi_launches=launches["viterbi_decode"],
            gross_pitch_error=f"{gpe[label]:.4f}",
            gross_pitch_error_default=f"{gpe['default']:.4f}",
            ms=f"{float(np.median(samples[label])):.4f}",
            ms_default=f"{float(np.median(samples['default'])):.4f}",
            timing="median of turns (default, option, option, default), "
                   "host clock to the fetch")
    return out


def phase_pitch_native() -> None:
    """``[pitch native]``: ``ops.pitch_native`` built here by g++ from the
    port's ``csrc/rapt.cc`` (a host path: numpy in and out). Its voicing
    and F0 against the card's ``track_pitch`` on the tones of
    tests/test_pitch_native.py at that file's bars (voicing on more than
    95% of the interior frames, a median within 10 cents where both
    voice); the same measures, reported, on the ``[pitch decoders]``
    batch; ms a 3 s utterance on the host."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.ops import pitch, pitch_native

    start = time.perf_counter()
    if not pitch_native.available():
        fail("pitch_native: the g++ build of csrc/rapt.cc failed")
    build_s = time.perf_counter() - start

    def compare(native, device):
        interior = slice(2, -4)
        nv, dv = native[interior] > -1e9, device[interior] > -1e9
        both = nv & dv
        cents = 1200 * np.abs((native[interior][both]
                               - device[interior][both]) / np.log(2))
        return float((nv == dv).mean()), float(np.median(cents)) if (
            both.any()) else float("nan")

    n = SAMPLE_RATE
    for f0, seed in ((110.0, 1), (200.0, 2), (320.0, 3)):
        t = np.arange(n) / SAMPLE_RATE
        r = np.random.RandomState(seed)
        sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 5))
        sig = sig + 0.005 * r.randn(n)
        x = (sig / np.abs(sig).max() * 0.5).astype(np.float32)
        native = pitch_native.track_pitch_native(x)
        device = pitch.track_pitch(
            torch.from_numpy(x[None]).to("cuda"), torch.tensor([n]),
            torch.tensor([50.0]), torch.tensor([600.0]))[0].cpu().numpy()
        agree, cents = compare(native, device)
        if not (agree > 0.95 and cents < 10.0):
            fail(f"pitch_native {f0} Hz tone against the card's tracker: "
                 f"voicing {agree}, median {cents} cents")
    x, lengths, lo, hi, _ = decoder_batch(SEED + 7)
    device = pitch.track_pitch(x, lengths, lo, hi).cpu().numpy()
    host = x.cpu().numpy()
    samples, agrees, cents_all = [], [], []
    for i in range(len(host)):
        start = time.perf_counter()
        native = pitch_native.track_pitch_native(
            host[i], lo=float(lo[i]), hi=float(hi[i]))
        samples.append((time.perf_counter() - start) * 1e3)
        agree, cents = compare(native, device[i])
        agrees.append(agree)
        cents_all.append(cents)
    log("pitch native", build_s=f"{build_s:.2f}", tones_checked=3,
        ms_per_3s_utterance=f"{float(np.median(samples)):.4f}",
        clock="host, one utterance a call",
        voicing_agreement_speech=f"{float(np.mean(agrees)):.4f}",
        median_cents_speech=f"{float(np.nanmedian(cents_all)):.3f}")


# bfloat16 compute (``compute_dtype="bfloat16"``): W_hh in bfloat16, h_{t-1}
# (and in the gradient d_pre) rounded to bfloat16 where a step's product
# reads it. Kernel and plain version sum in other orders, so an operand
# whose two float32 values straddle a bfloat16 rounding boundary enters
# the product one bfloat16 ulp apart, and the steps after it carry that
# difference (tests/test_torch_compute_bf16.py holds the plain versions to
# JAX at the same kind of bar). So a recurrence's outputs at bfloat16 W:
# each element within the bar of its dtype (float32: KERNEL_TOL, absolute
# or relative to the largest magnitude where that is above 1; bfloat16:
# BF16_ULPS ulps and BF16_NOISE), but for at most COMPUTE_FLIP_SHARE of
# them, and every one within COMPUTE_FLIP of the tensor's largest
# magnitude. Measured (the first chip run of these kernels, an NVIDIA
# H100 80GB HBM3 at 700 W): at most 2.6% of an output's elements
# (``bilstm_fwd`` at B16 H512) and 5.8e-3 of the largest magnitude
# (``bilstm_bwd`` at B16 H512, bfloat16 residuals). Over 192 steps the two
# sides' roundings part ways after the first flip, so their mean distance
# at T=192 reads 0.1-0.4 of what the rounding itself moves (the same
# plain version at float32 W). So that the bar shows the kernel rounds
# where its plain version rounds, and not merely stays near it, each
# instance also runs COMPUTE_SHORT_T steps at the same B and H, where its
# mean distance from the plain version must stay within COMPUTE_QUARTER
# of the rounding's (a kernel that rounds nothing reads about 1).
COMPUTE_FLIP = 2.0 ** -6
COMPUTE_FLIP_SHARE = 0.05
COMPUTE_QUARTER = 0.25
COMPUTE_SHORT_T = 8
# a whole call at bfloat16 compute (mels, a step's loss and gradients)
# against the same call on the plain versions, where the flips above pass
# through every later layer: max |got - want| over max |want|
COMPUTE_PATH_TOL = 2.0 ** -7
# the bfloat16-compute instances of the kernels: their entry in the JSON
# record, the kernel whose wrapper launches them, and their dtypes (W_hh,
# xp stream, residuals)
COMPUTE_KERNELS = {
    "bilstm_infer/bf16_w": ("bilstm_infer", "W bf16, xp f32, h f32"),
    "bilstm_infer/bf16_w_bf16_xp": ("bilstm_infer", "W bf16, xp bf16, h f32"),
    "bilstm_fwd/bf16_w": ("bilstm_fwd", "W bf16, xp f32, residuals f32"),
    "bilstm_fwd/bf16_w_bf16_resid": ("bilstm_fwd",
                                     "W bf16, xp bf16, residuals bf16"),
    "bilstm_bwd/bf16_w": ("bilstm_bwd", "W bf16, residuals and dx f32"),
    "bilstm_bwd/bf16_w_bf16_resid": ("bilstm_bwd",
                                     "W bf16, residuals and dx bf16"),
    "multi_bilstm_infer/bf16_w": ("multi_bilstm_infer",
                                  "W bf16 (H >= 2) and f32 (H = 1)"),
    "multi_bilstm_fwd/bf16_w": ("multi_bilstm_fwd",
                                "W bf16 (H >= 2) and f32, residuals f32"),
    "multi_bilstm_fwd/bf16_w_bf16_resid": (
        "multi_bilstm_fwd", "W bf16 (H >= 2) and f32, residuals bf16"),
    "multi_bilstm_bwd/bf16_w": ("multi_bilstm_bwd",
                                "W bf16 (H >= 2) and f32, residuals f32"),
    "multi_bilstm_bwd/bf16_w_bf16_resid": (
        "multi_bilstm_bwd", "W bf16 (H >= 2) and f32, residuals bf16"),
    "lstm_infer/bf16_w": ("lstm_infer", "W bf16, xp f32, h f32"),
    "lstm_infer/bf16_w_bf16_xp": ("lstm_infer", "W bf16, xp bf16, h f32"),
    "lstm_fwd/bf16_resid": ("lstm_fwd", "W f32, xp f32, residuals bf16"),
    "lstm_fwd/bf16_w": ("lstm_fwd", "W bf16, xp f32, residuals f32"),
    "lstm_fwd/bf16_w_bf16_resid": ("lstm_fwd",
                                   "W bf16, xp bf16, residuals bf16"),
    "lstm_bwd/bf16_resid": ("lstm_bwd", "W f32, dh, residuals and dx bf16"),
    "lstm_bwd/bf16_w": ("lstm_bwd", "W bf16, dh, residuals and dx f32"),
    "lstm_bwd/bf16_w_bf16_resid": ("lstm_bwd",
                                   "W bf16, dh, residuals and dx bf16"),
}


def flip_stats(got, want) -> tuple[float, float]:
    """(the share of elements beyond their dtype's bar, the largest
    |got - want| over max |want|) over matching tensors; see
    ``COMPUTE_FLIP``."""
    import torch

    beyond = total = 0
    worst = 0.0
    for g, w in zip(got, want):
        gf, wf = g.float(), w.float()
        top = float(wf.abs().max())
        err = (gf - wf).abs()
        if g.dtype == torch.bfloat16:
            mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
            near = BF16_ULPS * torch.exp2(torch.floor(torch.log2(mag)) - 7) + (
                BF16_NOISE * top)
        else:
            near = KERNEL_TOL * max(top, 1.0)
        beyond += int((err > near).sum())
        total += err.numel()
        worst = max(worst, float(err.max()) / max(top, 1e-30))
    return beyond / max(total, 1), worst


def mean_abs_err(got, want) -> float:
    """The mean |got - want| over all elements of matching tensors."""
    total = sum(float((g.float() - w.float()).abs().sum())
                for g, w in zip(got, want))
    return total / max(sum(w.numel() for w in want), 1)


def check_flips(what: str, got, want) -> dict:
    """``flip_stats`` within ``COMPUTE_FLIP_SHARE`` and ``COMPUTE_FLIP``,
    or fail; returns them with the largest absolute error."""
    share, worst = flip_stats(got, want)
    if not (share <= COMPUTE_FLIP_SHARE and worst <= COMPUTE_FLIP):
        fail(f"{what}: {share:.4g} of the elements beyond their bar (tol "
             f"{COMPUTE_FLIP_SHARE}), largest error {worst:.4g} of the "
             f"largest magnitude (tol {COMPUTE_FLIP})")
    return dict(flip_share=share, max_err_over_max=worst,
                max_abs_err=abs_err(got, want))


def check_f32_directions(what: str, got, want, ws) -> float:
    """The directions of a multi-stream call at bfloat16 compute whose
    W_hh is float32, against the plain version: each of their outputs
    (``got``: one a direction in turn, as the ops return h, g and c or
    dx) within its dtype's bar, every element, as a float32 call's (such
    a direction rounds no operand), or fail. Returns the largest error
    over the largest magnitude."""
    import torch

    pick = [i for i in range(len(got))
            if ws[i % len(ws)].dtype == torch.float32]
    share, worst = flip_stats([got[i] for i in pick], [want[i] for i in pick])
    if share > 0:
        fail(f"{what}, the float32-W directions: {share:.4g} of their "
             f"elements beyond their bar (tol 0)")
    return worst


def check_rounds(what: str, got, want, unrounded) -> dict:
    """The kernel rounds where its plain version rounds: on
    ``COMPUTE_SHORT_T`` steps, the mean |got - want| within
    ``COMPUTE_QUARTER`` of the mean |want - unrounded| (``unrounded``:
    the plain version at float32 W), or fail."""
    ratio = mean_abs_err(got, want) / max(mean_abs_err(want, unrounded),
                                          1e-30)
    if not ratio <= COMPUTE_QUARTER:
        fail(f"{what} at T={COMPUTE_SHORT_T}: mean error {ratio:.4g} of the "
             f"rounding's (tol {COMPUTE_QUARTER})")
    return dict(rounding_ratio=ratio)


def compute_merged_inputs(t: int, b: int, h: int, seed: int, stream):
    """``merged_inputs`` at bfloat16 compute: xp in the ``stream`` dtype,
    W_hh rounded to bfloat16."""
    import torch

    xp_f, xp_b, w_f, w_b = merged_inputs(t, b, h, seed)
    return (xp_f.to(stream), xp_b.to(stream), w_f.to(torch.bfloat16),
            w_b.to(torch.bfloat16))


def _compute_row(name: str, shape: str, fields: dict) -> dict:
    label = {**COMPUTE_KERNELS, **BLOCK_FUSED_BF16_KERNELS}[name][1]
    log(f"kernel {name}", shape=shape, dtypes=label.replace(" ", ""),
        **fmt(fields), flip_share_tol=COMPUTE_FLIP_SHARE,
        flip_tol=COMPUTE_FLIP, library="null (no library call rounds "
        "there)")
    return dict(shape=shape, **fields)


def check_bilstm_compute(b: int, h: int, stream, reps: int) -> dict:
    """``bilstm_infer`` at bfloat16 W beside an xp stream of ``stream``
    against its plain version on the same inputs: the flip bar, time,
    device time, the plain version's time and the bound at these
    bytes."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    args = compute_merged_inputs(T, b, h, SEED + 5 * h + b, stream)
    got = bilstm.bilstm_infer_cuda(*args)
    want = bilstm.bilstm_sequence_reference(*args)
    torch.cuda.synchronize()
    check_dtypes("bilstm_infer bf16 compute h", got, torch.float32)
    bf16_xp = stream == torch.bfloat16
    name = "bilstm_infer/bf16_w" + ("_bf16_xp" if bf16_xp else "")
    errs = check_flips(f"{name} B{b} H{h}", got, want)
    short = compute_merged_inputs(COMPUTE_SHORT_T, b, h, SEED + h, stream)
    errs.update(check_rounds(
        f"{name} B{b} H{h}", bilstm.bilstm_infer_cuda(*short),
        bilstm.bilstm_sequence_reference(*short),
        bilstm.bilstm_sequence_reference(*short[:2], *(
            w.float() for w in short[2:]))))
    bound, by = lstm_bound(T, b, [h, h], "infer", xp_bytes=2 if bf16_xp
                           else 4, w_bytes=2)
    return _compute_row(name, f"T{T}xB{b}xH{h}", dict(
        ms=time_ms(lambda: bilstm.bilstm_infer_cuda(*args), reps),
        device_ms=kernel_device_ms(lambda: bilstm.bilstm_infer_cuda(*args),
                                   reps),
        plain_ms=time_ms(lambda: bilstm.bilstm_sequence_reference(*args), 1,
                         warmup=0),
        bound_ms=bound, bound_by=by, **errs))


def check_bilstm_train_compute(b: int, h: int, rd, reps: int) -> dict:
    """``bilstm_fwd`` and ``bilstm_bwd`` at bfloat16 W, residuals in
    ``rd`` and the xp stream in it too (``stream_dtype``), against their
    plain versions: the forward's h, g and c, the gradient's dx on the
    plain forward's residuals and on the kernel's own, each at the flip
    bar. Returns the two rows."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm

    xp_f, xp_b, w_f, w_b = compute_merged_inputs(T, b, h, SEED + 7 * h + b,
                                                 rd)
    gen = torch.Generator(device="cuda").manual_seed(SEED + h)
    dh = [torch.randn(T, b, h, device="cuda", generator=gen).to(rd)
          for _ in range(2)]
    got = bilstm.bilstm_forward_cuda(xp_f, xp_b, w_f, w_b, rd)
    want = bilstm.bilstm_forward_reference(xp_f, xp_b, w_f, w_b, rd)
    res = want[2:]
    dx = bilstm.bilstm_backward_cuda(*dh, *res, w_f, w_b)
    dx_ref = bilstm.bilstm_backward_reference(*dh, *res, w_f, w_b)
    dx_own = bilstm.bilstm_backward_cuda(*dh, *got[2:], w_f, w_b)
    dx_own_ref = bilstm.bilstm_backward_reference(*dh, *got[2:], w_f, w_b)
    torch.cuda.synchronize()
    check_dtypes("bilstm_fwd bf16 compute h", got[:2], torch.float32)
    check_dtypes("bilstm_fwd bf16 compute g, c", got[2:], rd)
    check_dtypes("bilstm_bwd bf16 compute dx", dx, rd)
    tag = "bf16_w" + ("_bf16_resid" if rd == torch.bfloat16 else "")
    shape = f"T{T}xB{b}xH{h}"
    fwd_errs = check_flips(f"bilstm_fwd/{tag} {shape}", got, want)
    bwd_errs = check_flips(f"bilstm_bwd/{tag} {shape}", dx, dx_ref)
    # the same at COMPUTE_SHORT_T steps beside the plain versions at
    # float32 W
    short = compute_merged_inputs(COMPUTE_SHORT_T, b, h, SEED + h, rd)
    w32 = [w.float() for w in short[2:]]
    s_want = bilstm.bilstm_forward_reference(*short, rd)
    fwd_errs.update(check_rounds(
        f"bilstm_fwd/{tag} {shape}", bilstm.bilstm_forward_cuda(*short, rd),
        s_want, bilstm.bilstm_forward_reference(*short[:2], *w32, rd)))
    s_dh = [x[:COMPUTE_SHORT_T].contiguous() for x in dh]
    bwd_errs.update(check_rounds(
        f"bilstm_bwd/{tag} {shape}",
        bilstm.bilstm_backward_cuda(*s_dh, *s_want[2:], *short[2:]),
        bilstm.bilstm_backward_reference(*s_dh, *s_want[2:], *short[2:]),
        bilstm.bilstm_backward_reference(*s_dh, *s_want[2:], *w32)))
    own = check_flips(f"bilstm_bwd/{tag} {shape} on the kernel's residuals",
                      dx_own, dx_own_ref)
    size = 2 if rd == torch.bfloat16 else 4
    fwd_bound, fwd_by = lstm_bound(T, b, [h, h], "fwd", resid_bytes=size,
                                   xp_bytes=size, w_bytes=2)
    bwd_bound, bwd_by = lstm_bound(T, b, [h, h], "bwd", resid_bytes=size,
                                   stream_bytes=size, w_bytes=2)

    def fwd():
        return bilstm.bilstm_forward_cuda(xp_f, xp_b, w_f, w_b, rd)

    def bwd():
        return bilstm.bilstm_backward_cuda(*dh, *res, w_f, w_b)

    return {
        f"bilstm_fwd/{tag}": _compute_row(f"bilstm_fwd/{tag}", shape, dict(
            ms=time_ms(fwd, reps), device_ms=kernel_device_ms(fwd, reps),
            plain_ms=time_ms(lambda: bilstm.bilstm_forward_reference(
                xp_f, xp_b, w_f, w_b, rd), 1, warmup=0),
            bound_ms=fwd_bound, bound_by=fwd_by, **fwd_errs)),
        f"bilstm_bwd/{tag}": _compute_row(f"bilstm_bwd/{tag}", shape, dict(
            ms=time_ms(bwd, reps), device_ms=kernel_device_ms(bwd, reps),
            plain_ms=time_ms(lambda: bilstm.bilstm_backward_reference(
                *dh, *res, w_f, w_b), 1, warmup=0),
            bound_ms=bwd_bound, bound_by=bwd_by, **bwd_errs,
            own_residuals_flip_share=own["flip_share"],
            own_residuals_max_err_over_max=own["max_err_over_max"])),
    }


def compute_multi_inputs(t: int, b: int, hs, seed: int, f32_widths=(1,)):
    """``multi_inputs`` at bfloat16 compute: W_hh float32 at the widths
    ``f32_widths`` and bfloat16 at the others (the default: float32 for
    H = 1, as the models' ``_recurrent_dtype`` gives them)."""
    import torch

    xps, ws = multi_inputs(t, b, hs, seed)
    return xps, [w if w.shape[1] in f32_widths else w.to(torch.bfloat16)
                 for w in ws]


def check_multi_compute(b: int, hs, reps: int, rd=None,
                        plan: str = "") -> dict:
    """The multi-stream kernels at bfloat16 compute, W_hh of mixed
    dtypes in one call, against the plain versions: the lean forward
    (``rd`` None), or the residual-saving forward and the gradient at
    residuals ``rd`` (on the plain forward's residuals and the kernel's
    own). ``plan``: "" where ``hs`` runs the lane plan, "block_" where
    it runs the block plan (a width past ``LANE_MAX_H``), the prefix of
    the rows' instance names. Returns the rows."""
    import torch

    from speechsplit_tpu_torch.ops import multi_bilstm

    xps, ws = compute_multi_inputs(T, b, hs, SEED + 13 * b + len(hs))
    n, d2 = len(hs), 2 * len(hs)
    shape = f"T{T}xB{b}xH{'/'.join(map(str, hs))}"
    dirs = [h for h in hs for _ in (0, 1)]
    w_bytes = [2 if h >= 2 else 4 for h in dirs]
    if rd is None:
        got = multi_bilstm.multi_bilstm_infer_cuda(n, *xps, *ws)
        want = multi_bilstm.multi_bilstm_sequence_reference(n, *xps, *ws)
        torch.cuda.synchronize()
        name = f"multi_bilstm_infer/{plan}bf16_w"
        errs = check_flips(f"{name} {shape}", got, want)
        errs["f32_w_max_err_over_max"] = check_f32_directions(
            f"{name} {shape}", got, want, ws)
        s_xps, s_ws = compute_multi_inputs(COMPUTE_SHORT_T, b, hs, SEED + b)
        errs.update(check_rounds(
            f"{name} {shape}",
            multi_bilstm.multi_bilstm_infer_cuda(n, *s_xps, *s_ws),
            multi_bilstm.multi_bilstm_sequence_reference(n, *s_xps, *s_ws),
            multi_bilstm.multi_bilstm_sequence_reference(
                n, *s_xps, *(w.float() for w in s_ws))))
        bound, by = lstm_bound(T, b, dirs, "infer", w_bytes=w_bytes)

        def lean():
            return multi_bilstm.multi_bilstm_infer_cuda(n, *xps, *ws)

        return {name: _compute_row(name, shape, dict(
            ms=time_ms(lean, reps), device_ms=kernel_device_ms(lean, reps),
            plain_ms=time_ms(lambda: multi_bilstm.
                             multi_bilstm_sequence_reference(n, *xps, *ws), 1,
                             warmup=0),
            bound_ms=bound, bound_by=by, **errs))}
    got = multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws,
                                                 residual_dtype=rd)
    want = multi_bilstm.multi_bilstm_forward_reference(n, *xps, *ws,
                                                       residual_dtype=rd)
    res = want[d2:]
    gen = torch.Generator(device="cuda").manual_seed(SEED + b)
    dhs = [torch.randn(x.shape, device="cuda", generator=gen)
           for x in want[:d2]]
    dx = multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *res, *ws)
    dx_ref = multi_bilstm.multi_bilstm_backward_reference(n, *dhs, *res, *ws)
    dx_own = multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *got[d2:], *ws)
    dx_own_ref = multi_bilstm.multi_bilstm_backward_reference(
        n, *dhs, *got[d2:], *ws)
    torch.cuda.synchronize()
    check_dtypes("multi_bilstm_fwd bf16 compute h", got[:d2], torch.float32)
    check_dtypes("multi_bilstm_fwd bf16 compute g, c", got[d2:], rd)
    check_dtypes("multi_bilstm_bwd bf16 compute dx", dx, torch.float32)
    tag = plan + "bf16_w" + ("_bf16_resid" if rd == torch.bfloat16 else "")
    fwd_errs = check_flips(f"multi_bilstm_fwd/{tag} {shape}", got, want)
    bwd_errs = check_flips(f"multi_bilstm_bwd/{tag} {shape}", dx, dx_ref)
    fwd_errs["f32_w_max_err_over_max"] = check_f32_directions(
        f"multi_bilstm_fwd/{tag} {shape}", got, want, ws)
    bwd_errs["f32_w_max_err_over_max"] = max(
        check_f32_directions(f"multi_bilstm_bwd/{tag} {shape}", dx, dx_ref,
                             ws),
        check_f32_directions(f"multi_bilstm_bwd/{tag} {shape} on the "
                             "kernel's residuals", dx_own, dx_own_ref, ws))
    s_xps, s_ws = compute_multi_inputs(COMPUTE_SHORT_T, b, hs, SEED + b)
    w32 = [w.float() for w in s_ws]
    s_want = multi_bilstm.multi_bilstm_forward_reference(
        n, *s_xps, *s_ws, residual_dtype=rd)
    fwd_errs.update(check_rounds(
        f"multi_bilstm_fwd/{tag} {shape}",
        multi_bilstm.multi_bilstm_forward_cuda(n, *s_xps, *s_ws,
                                               residual_dtype=rd),
        s_want, multi_bilstm.multi_bilstm_forward_reference(
            n, *s_xps, *w32, residual_dtype=rd)))
    s_dhs = [x[:COMPUTE_SHORT_T].contiguous() for x in dhs]
    bwd_errs.update(check_rounds(
        f"multi_bilstm_bwd/{tag} {shape}",
        multi_bilstm.multi_bilstm_backward_cuda(n, *s_dhs, *s_want[d2:],
                                                *s_ws),
        multi_bilstm.multi_bilstm_backward_reference(n, *s_dhs, *s_want[d2:],
                                                     *s_ws),
        multi_bilstm.multi_bilstm_backward_reference(n, *s_dhs,
                                                     *s_want[d2:], *w32)))
    own = check_flips(f"multi_bilstm_bwd/{tag} {shape} on the kernel's "
                      "residuals", dx_own, dx_own_ref)
    size = 2 if rd == torch.bfloat16 else 4
    fwd_bound, fwd_by = lstm_bound(T, b, dirs, "fwd", resid_bytes=size,
                                   w_bytes=w_bytes)
    bwd_bound, bwd_by = lstm_bound(T, b, dirs, "bwd", resid_bytes=size,
                                   w_bytes=w_bytes)

    def fwd():
        return multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws,
                                                      residual_dtype=rd)

    def bwd():
        return multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *res, *ws)

    return {
        f"multi_bilstm_fwd/{tag}": _compute_row(
            f"multi_bilstm_fwd/{tag}", shape, dict(
                ms=time_ms(fwd, reps), device_ms=kernel_device_ms(fwd, reps),
                plain_ms=time_ms(lambda: multi_bilstm.
                                 multi_bilstm_forward_reference(
                                     n, *xps, *ws, residual_dtype=rd), 1,
                                 warmup=0),
                bound_ms=fwd_bound, bound_by=fwd_by, **fwd_errs)),
        f"multi_bilstm_bwd/{tag}": _compute_row(
            f"multi_bilstm_bwd/{tag}", shape, dict(
                ms=time_ms(bwd, reps), device_ms=kernel_device_ms(bwd, reps),
                plain_ms=time_ms(lambda: multi_bilstm.
                                 multi_bilstm_backward_reference(
                                     n, *dhs, *res, *ws), 1, warmup=0),
                bound_ms=bwd_bound, bound_by=bwd_by, **bwd_errs,
                own_residuals_flip_share=own["flip_share"],
                own_residuals_max_err_over_max=own["max_err_over_max"])),
    }


# the merged kernels' other code paths at bfloat16 compute (T, B, H):
# T=1, one row, widths not a multiple of 4 or 8 (gate inputs and h staged
# one by one), H=1, batches not a multiple of a round or a tile, one
# block a direction, and the batch limit at H=512
COMPUTE_EDGES = ((1, 28, 512), (5, 1, 512), (7, 9, 100), (5, 2, 1),
                 (6, 5, 3), (4, 40, 512), (5, 9, 6), (3, 13, 8))


def check_compute_edges() -> None:
    """The bfloat16-compute instances at ``COMPUTE_EDGES`` (the lean
    forward beside both streams, the training pair at both residual
    dtypes, the batch limits of each at H=512) and the multi-stream lane
    plan at every ``MULTI_EDGES`` case on it, W_hh mixed as the models
    give it, and once mixed otherwise (float32 at H=8 beside bfloat16 at
    32 and 1), each against its plain version at the flip bar, the
    float32-W directions at their own (the block plan's edges:
    ``check_block_bf16_edges``)."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm, multi_bilstm

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = COMPUTE_EDGES + (
        (3, bilstm.forward_max_batch(512, resid=False), 512),
        (3, bilstm.merged_max_batch(512, grad=True), 512))
    worst = {"share": 0.0, "err": 0.0, "f32": 0.0}

    def keep(errs):
        worst["share"] = max(worst["share"], errs["flip_share"])
        worst["err"] = max(worst["err"], errs["max_err_over_max"])

    def keep_multi(what, got, want, ws):
        keep(check_flips(what, got, want))
        worst["f32"] = max(worst["f32"],
                           check_f32_directions(what, got, want, ws))

    for i, (t, b, h) in enumerate(shapes):
        lean = i != len(shapes) - 1  # the last one: the autograd limit
        train = i != len(shapes) - 2  # the one before: the lean limit
        for rd in (f32, bf16):
            args = compute_merged_inputs(t, b, h, SEED + 31 * i, rd)
            what = f"bf16 compute T{t}xB{b}xH{h} {rd}"
            if lean:
                keep(check_flips(f"bilstm_infer {what}",
                                 bilstm.bilstm_infer_cuda(*args),
                                 bilstm.bilstm_sequence_reference(*args)))
            if not train:
                continue
            got = bilstm.bilstm_forward_cuda(*args, rd)
            want = bilstm.bilstm_forward_reference(*args, rd)
            keep(check_flips(f"bilstm_fwd {what}", got, want))
            dh = [torch.randn(t, b, h, device="cuda").to(rd)
                  for _ in range(2)]
            for res in (want[2:], got[2:]):
                keep(check_flips(
                    f"bilstm_bwd {what}",
                    bilstm.bilstm_backward_cuda(*dh, *res, *args[2:]),
                    bilstm.bilstm_backward_reference(*dh, *res, *args[2:])))
    lane = [c + ((1,),) for c in MULTI_EDGES
            if max(c[2]) <= multi_bilstm.LANE_MAX_H]
    lane.append((COMPUTE_SHORT_T, 13, (8, 32, 1), (8,)))
    for t, b, hs, f32_widths in lane:
        xps, ws = compute_multi_inputs(t, b, hs, SEED + 17 * t + b,
                                       f32_widths)
        n, d2 = len(hs), 2 * len(hs)
        what = f"multi bf16 compute T{t}xB{b}xH{hs} f32 W at {f32_widths}"
        keep_multi(what, multi_bilstm.multi_bilstm_infer_cuda(n, *xps, *ws),
                   multi_bilstm.multi_bilstm_sequence_reference(n, *xps,
                                                                *ws), ws)
        for rd in (f32, bf16):
            got = multi_bilstm.multi_bilstm_forward_cuda(
                n, *xps, *ws, residual_dtype=rd)
            want = multi_bilstm.multi_bilstm_forward_reference(
                n, *xps, *ws, residual_dtype=rd)
            keep_multi(f"{what} fwd {rd}", got, want, ws)
            dhs = [torch.randn(x.shape, device="cuda") for x in want[:d2]]
            for res in (want[d2:], got[d2:]):
                keep_multi(
                    f"{what} bwd {rd}",
                    multi_bilstm.multi_bilstm_backward_cuda(n, *dhs, *res,
                                                            *ws),
                    multi_bilstm.multi_bilstm_backward_reference(
                        n, *dhs, *res, *ws), ws)
    log("kernel bf16 compute edges", merged_shapes=len(shapes),
        multi_shapes=len(lane), max_flip_share=f"{worst['share']:.4g}",
        flip_share_tol=COMPUTE_FLIP_SHARE,
        max_err_over_max=f"{worst['err']:.4g}", flip_tol=COMPUTE_FLIP,
        f32_w_max_err_over_max=f"{worst['f32']:.4g}",
        mixed="f32 W at H8 beside bf16 H32 and H1",
        limits=f"B{shapes[-2][1]} lean, B{shapes[-1][1]} training at H512",
        block_plan="[kernel multi block bf16 edges]")


def phase_compute_kernels(reps: int = 10) -> dict:
    """The bfloat16-compute instances of the four kernel bodies against
    their plain versions at the main path's shapes and edges. Returns the
    row of each instance's first (most expensive) shape."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}

    def add(found: dict) -> None:
        for name, row in found.items():
            if name in rows:
                rows[name].setdefault("beside", []).append(
                    {k: row[k] for k in ("shape", "ms", "device_ms",
                                         "bound_ms", "flip_share")})
            else:
                rows[name] = row

    with strict_float32("bfloat16 compute kernels"):
        for stream in (bf16, f32):
            for b, h in ((28, 512), (28, 256), (28, 8)):
                row = check_bilstm_compute(b, h, stream, reps)
                add({"bilstm_infer/bf16_w" + (
                    "_bf16_xp" if stream == bf16 else ""): row})
        for rd in (bf16, f32):
            for h in (512, 256, 8):
                add(check_bilstm_train_compute(TRAIN_B, h, rd, reps))
        for b in (28, 4):
            add(check_multi_compute(b, (8, 32, 1) if b == 28 else (32, 1),
                                    reps))
        for rd in (bf16, f32):
            for b in (TRAIN_B, 28):
                add(check_multi_compute(b, (8, 32, 1), reps, rd))
        check_compute_edges()
    return rows


def compute_config(residual: str = "bfloat16"):
    """The default config at bfloat16 compute (``residual``: its
    residual dtype, the default bfloat16)."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    return SpeechSplitConfig(compute_dtype="bfloat16",
                             residual_dtype=residual)


def phase_train_compute(gen_per_step: dict, f0_per_step: dict) -> tuple:
    """Both train steps at bfloat16 compute (``train_precision_phase``) on
    a B16 and a B32 batch: bfloat16 residuals (the default), and at B16
    also float32 ones, timed in turns with the default config's step
    (float32 compute) and the float32 step. Returns the generator's and
    the F0 converter's launches at B16 by residual dtype."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig

    timed = {"bf16_compute": compute_config(),
             "default": SpeechSplitConfig(), "float32": float32_config()}
    out = []
    for name, model, per_step in (
            ("generator", "speechsplit", gen_per_step),
            ("f0_converter", "f0_converter", f0_per_step)):
        for b in (TRAIN_B, 32):
            checked = {"bf16_compute": compute_config()}
            if b == TRAIN_B:
                checked["bf16_compute_f32_resid"] = compute_config("float32")
            launches = train_precision_phase(
                name, model, per_step,
                synthetic_batch(SpeechSplitConfig(), SEED + b, b), checked,
                timed, "bf16 compute", reps=8)
            if b == TRAIN_B:
                out.append({"bfloat16": launches["bf16_compute"],
                            "float32": launches["bf16_compute_f32_resid"]})
    return tuple(out)


def phase_convert_compute(reps: int = 10) -> dict:
    """``convert_batched`` at 4 pairs x 7 conditions through seeded
    default-config models at bfloat16 compute, at bfloat16 residuals (its
    merged layers' xp streams bfloat16) and at float32 ones: launches,
    finite mels cut to their lengths, within ``COMPUTE_PATH_TOL`` of the
    same call on the plain versions, ms a call in turns with the same
    weights at float32 compute (TF32 off). The fused route at bfloat16
    compute is ``phase_convert_fused_bf16``'s, the 731-pair call
    ``phase_convert_large_compute``'s. Returns the launches by residual
    dtype."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    gen = torch.Generator().manual_seed(SEED)
    base = (SpeechSplit(SpeechSplitConfig(), generator=gen),
            F0Converter(SpeechSplitConfig(), generator=gen))
    pairs = synthetic_pairs(SpeechSplitConfig(), 4, "cuda", SEED)

    def models(config):
        g = SpeechSplit(config).to("cuda").eval()
        p = F0Converter(config).to("cuda").eval()
        g.load_state_dict(base[0].state_dict())
        p.load_state_dict(base[1].state_dict())
        return g, p

    f32_models = models(SpeechSplitConfig())
    launches = {}
    with strict_float32("bf16 compute conversions and their timing"):
        for residual in ("bfloat16", "float32"):
            config = compute_config(residual)
            g, p = models(config)

            def run(g=g, p=p):
                return convert_batched(g, p, pairs, CONDITIONS)

            run()
            torch.cuda.synchronize()
            reset_launches()
            result = run()
            counts = {k: v for k, v in read_launches().items() if v}
            if counts != {"bilstm_infer": 6, "multi_bilstm_infer": 2}:
                fail(f"convert_batched bf16 compute: launches {counts}")
            launches[residual] = counts
            check_conversions(config, pairs, result)
            with plain_kernels():
                plain = run()
            err = max(float(np.abs(a[1] - b[1]).max()) / max(
                float(np.abs(b[1]).max()), 1e-30)
                for ra, rb in zip(result, plain) for a, b in zip(ra, rb))
            if not err <= COMPUTE_PATH_TOL:
                fail(f"convert_batched bf16 compute ({residual} residuals) "
                     f"vs plain: {err} of the largest magnitude")
            samples = {"bf16_compute": [], "float32": []}
            for r in range(reps):
                for label in (("bf16_compute", "float32") if r % 2 == 0
                              else ("float32", "bf16_compute")):
                    mg, mp = (g, p) if label == "bf16_compute" else f32_models
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    convert_batched(mg, mp, pairs, CONDITIONS)
                    samples[label].append((time.perf_counter() - start) * 1e3)
            log("convert_batched bf16 compute", pairs=4,
                residuals=residual, generator_batch=28,
                median_ms_per_call=f"{np.median(samples['bf16_compute']):.4f}",
                float32_median_ms_per_call=(
                    f"{np.median(samples['float32']):.4f}"),
                timing="bf16 compute and float32 calls in turns, TF32 off",
                max_abs_err_over_max_vs_plain=f"{err:.3g}",
                tol=COMPUTE_PATH_TOL,
                launches=json.dumps(counts).replace(" ", ""))
            del g, p
    return launches


def phase_serve_compute(reps: int = 3) -> None:
    """One 3 s ``POST /convert`` to a ``cli.serve`` handler whose config
    sets ``compute_dtype=bfloat16`` (full-width seeded models from
    ``.ckpt`` files), beside the same request to a float32 one: every
    reply 200 with 7 wavs and 7 finite mels, the bfloat16 reply's mels
    within ``COMPUTE_PATH_TOL`` of the same call on the plain versions,
    ms a request (median of ``reps`` after a warm-up, the two servers in
    turns); TF32 off."""
    import threading
    from http.server import HTTPServer

    import numpy as np
    import torch
    from scipy.io import wavfile

    from speechsplit_tpu_torch.cli.serve import build_handler
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.interop import save_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
    from speechsplit_tpu_torch.pipeline import VoiceConverter

    gen = torch.Generator().manual_seed(SEED + 13)
    with tempfile.TemporaryDirectory() as tmp:
        g_path = os.path.join(tmp, "G.ckpt")
        p_path = os.path.join(tmp, "P.ckpt")
        save_reference_checkpoint(SpeechSplit(SpeechSplitConfig(),
                                              generator=gen), g_path)
        save_reference_checkpoint(F0Converter(SpeechSplitConfig(),
                                              generator=gen), p_path)
        paths = []
        for side, (f_a, f_b) in (("src", (105.0, 150.0)),
                                 ("trg", (190.0, 260.0))):
            path = os.path.join(tmp, f"{side}.wav")
            wavfile.write(path, SAMPLE_RATE, synth_wav(
                SHORT_S, f_a, f_b, SEED + len(paths) + int(SHORT_S)))
            paths.append(path)
        servers, converters = {}, {}
        for label, config in (("bf16_compute", compute_config()),
                              ("float32", SpeechSplitConfig())):
            converters[label] = VoiceConverter.from_checkpoints(
                g_path, p_path, config=config, device="cuda")
            httpd = HTTPServer(("127.0.0.1", 0), build_handler(
                converters[label], os.path.join(tmp, f"out_{label}")))
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            servers[label] = (httpd, thread,
                              f"http://127.0.0.1:{httpd.server_port}")
        payload = {"source_wav": paths[0], "target_wav": paths[1]}
        try:
            with strict_float32("serve bf16 compute"):
                walls = {k: [] for k in servers}
                replies = {}
                for r in range(reps + 1):
                    for label in (list(servers) if r % 2 == 0
                                  else list(servers)[::-1]):
                        url = servers[label][2]
                        out = dict(payload,
                                   out_dir=os.path.join(tmp, f"o{label}{r}"))
                        start = time.perf_counter()
                        replies[label] = check_reply(*post_convert(url, out),
                                                     f"bf16 compute {label}")
                        if r:
                            walls[label].append(
                                (time.perf_counter() - start) * 1e3)
                conv = converters["bf16_compute"]
                if conv.g_model.decoder.lstm.dtype != torch.bfloat16:
                    fail("serve bf16 compute: the model is not at bfloat16")
                with plain_kernels():
                    plain = conv.convert_wav_files(*paths, synthesize=False)
                reply = replies["bf16_compute"]
                err = max(float(np.abs(reply[c] - plain[c]["mel"]).max())
                          / max(float(np.abs(plain[c]["mel"]).max()), 1e-30)
                          for c in reply)
                if not err <= COMPUTE_PATH_TOL:
                    fail(f"serve bf16 compute: mels {err} of the largest "
                         f"magnitude from the plain call's")
        finally:
            for httpd, thread, _ in servers.values():
                httpd.shutdown()
                thread.join()
        log("serve bf16 compute", pair="short", seconds=SHORT_S,
            ms_per_request=f"{np.median(walls['bf16_compute']):.4f}",
            float32_ms_per_request=f"{np.median(walls['float32']):.4f}",
            rounds_ms=";".join(f"{k}:" + ",".join(f"{v:.4f}" for v in w)
                               for k, w in walls.items()),
            timing="the two servers in turns after a warm-up, TF32 off",
            max_abs_err_over_max_vs_plain=f"{err:.3g}",
            tol=COMPUTE_PATH_TOL, status=200)
        del converters


# learned speaker mode (``spk_emb_mode="learned"``) and the neural vocoder:
# the learned train batch's speakers (row i is speaker i mod 4, so every
# anchor of the contrastive term has positives), the contrastive weight
# of the third learned config, and the shipped vocoder's refinement
LEARNED_SPEAKERS = 4
CONTRAST_WEIGHT = 0.1
VOCODER_REFINE = 48
# the neural vocoder on the card against the port's vocoder on the CPU
# for the same mels (the front end's of the serving wavs). The head's
# spectrum: max abs error over the largest magnitude. After 48
# refinement iterations the two devices' float32 roundings are carried
# forward and amplified: measured (NVIDIA H100 80GB HBM3, 700 W, PR 15)
# up to 635 PCM16 codes apart on one mel (a few samples near a silent
# gap) and within 10 on the three others, while what the iterations
# pin, the output's mel, stays put. So the refined PCM16 is held by
# its energy and its mel: the RMS of the samples' difference over the
# RMS of the CPU's samples (measured at most 4.34e-3), the mean
# absolute difference of the two outputs' mels in dB (at most 0.0266)
# and the two outputs' distance from the target mel in dB, which must
# agree (at most 0.0021 apart), over 8 mels in two runs; each bar about
# four times the measured value. PERF.md section 2 states them.
VOCODER_SPEC_TOL = 1e-4
VOCODER_PCM16_RMS = 0.02
VOCODER_MEL_DB = 0.1
VOCODER_RESYNTH_DB = 0.01


def learned(config):
    """``config`` in learned speaker mode."""
    return config.replace(spk_emb_mode="learned")


def phase_train_learned(gen_per_step: dict, reps: int = 8) -> None:
    """The learned-mode generator step at B16xT192 on a batch of 4
    speakers, at four configs: float32 (TF32 off; the plain step is
    autograd through the plain loops, ``STEP_TOL``), the default config,
    the default config with ``spk_contrast_weight=0.1`` and the default
    config at bfloat16 compute (the plain step: the Functions on their
    plain versions, ``BF16_STEP_TOL``).
    Each: its launches equal to the one-hot step's, no call of a plain
    version, the loss and every gradient (the SpeakerEncoder's too) within
    the bar of the plain step, the contrastive term's value (0 where the
    weight is), whether a second step from the same start gives the same
    gradients bit for bit (recorded: which differ, and whether two more
    steps under ``torch.backends.cudnn.deterministic`` do), and the
    median ms a step in turns
    with the one-hot step at the same config."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )
    from speechsplit_tpu_torch.training.train_step import (
        _speaker_conditioning,
        _upcast_batch,
    )

    batch = synthetic_batch(SpeechSplitConfig(), SEED + 21,
                            speakers=LEARNED_SPEAKERS)
    cases = (
        ("float32", float32_config(), STEP_TOL, plain_kernels,
         lambda: strict_float32("train learned float32")),
        ("default", SpeechSplitConfig(), BF16_STEP_TOL,
         plain_training_kernels, contextlib.nullcontext),
        ("default_contrast",
         SpeechSplitConfig(spk_contrast_weight=CONTRAST_WEIGHT),
         BF16_STEP_TOL, plain_training_kernels, contextlib.nullcontext),
        ("bf16_compute", compute_config(), BF16_STEP_TOL,
         plain_training_kernels, contextlib.nullcontext))
    for label, onehot, tol, plain_ctx, scope in cases:
        config = learned(onehot)
        step = make_train_step(config)
        with scope():
            plain = create_train_state(config, SEED, "speechsplit")
            reset_launches()
            with plain_ctx():
                plain, plain_loss = step(plain, batch)
            if any(read_launches().values()):
                fail(f"train learned {label}: the plain step launched a "
                     "kernel")
            plain_grads = grads_of(plain.model)
            del plain
            run = create_train_state(config, SEED, "speechsplit")
            with torch.no_grad():
                _, aux = _speaker_conditioning(
                    config, run.model, _upcast_batch(batch, "cuda"))
            term = 0.0 if aux is None else (
                float(aux) / config.spk_contrast_weight)
            torch.cuda.synchronize()
            reset_launches()
            with plain_calls() as called:
                run, loss = step(run, batch)
            torch.cuda.synchronize()
            launches = read_launches()
            for kernel, count in launches.items():
                if count != gen_per_step.get(kernel, 0):
                    fail(f"train learned {label}: {kernel} launched "
                         f"{count} times, the one-hot step "
                         f"{gen_per_step.get(kernel, 0)}")
            if called:
                fail(f"train learned {label}: plain versions called: "
                     f"{sorted(set(called))}")
            grads = grads_of(run.model)
            encoder = {k: g for k, g in grads.items()
                       if k.startswith("speaker_encoder.")}
            if len(encoder) != 14 or not all(
                    float(g.abs().max()) > 0 for g in encoder.values()):
                fail(f"train learned {label}: speaker encoder gradients "
                     f"{sorted(encoder)}")
            worst, key = grad_err(grads, plain_grads)
            enc_worst, enc_key = grad_err(encoder, plain_grads)
            loss_err = abs(float(loss) - float(plain_loss)) / abs(
                float(plain_loss))
            if not (loss_err <= tol and worst <= tol):
                fail(f"train learned {label} vs the plain step: loss rel "
                     f"err {loss_err}, grad rel err {worst} ({key}) > {tol}")
            again = create_train_state(config, SEED, "speechsplit")
            again, _ = step(again, batch)
            differing = [k for k, p in again.model.named_parameters()
                         if not torch.equal(p.grad, grads[k])]
            del again
            twins = []
            with cudnn_deterministic():
                for _ in range(2):
                    twin = create_train_state(config, SEED, "speechsplit")
                    twin, _ = step(twin, batch)
                    twins.append(grads_of(twin.model))
                    del twin
            deterministic_equal = all(torch.equal(twins[0][k], twins[1][k])
                                      for k in grads)
            del twins
            if label == "default_contrast" and not term > 0:
                fail(f"train learned {label}: contrastive term {term}")
            runs = {"learned": (run, step),
                    "onehot": (create_train_state(onehot, SEED,
                                                  "speechsplit"),
                               make_train_step(onehot))}
            samples = {k: [] for k in runs}
            for r in range(reps):
                for name in (("learned", "onehot") if r % 2 == 0
                             else ("onehot", "learned")):
                    state, fn = runs[name]
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    fn(state, batch)
                    torch.cuda.synchronize()
                    samples[name].append((time.perf_counter() - start) * 1e3)
            del runs, run
        ms = {k: float(np.median(v)) for k, v in samples.items()}
        log("train learned", config=label,
            batch=f"B{TRAIN_B}xT{T}", speakers=LEARNED_SPEAKERS,
            spk_contrast_weight=config.spk_contrast_weight,
            contrastive_term=f"{term:.6f}",
            loss=f"{float(loss):.6f}", loss_rel_err_vs_plain=f"{loss_err:.3g}",
            max_grad_rel_err_vs_plain=f"{worst:.3g}", worst_param=key,
            speaker_encoder_max_grad_rel_err=f"{enc_worst:.3g}",
            speaker_encoder_worst_param=enc_key, tol=tol,
            repeat_step_grads_bit_equal=not differing,
            repeat_differing=f"{len(differing)} of {len(grads)}",
            repeat_differing_outside_conv_stacks=",".join(
                k for k in differing if "conv" not in k) or "none",
            repeat_step_grads_bit_equal_cudnn_deterministic=(
                deterministic_equal),
            median_ms_per_step=f"{ms['learned']:.4f}",
            onehot_median_ms_per_step=f"{ms['onehot']:.4f}",
            rounds_ms=";".join(f"{k}:" + ",".join(f"{v:.4f}" for v in w)
                               for k, w in samples.items()),
            timing="learned and one-hot steps in turns", plain_calls=0,
            launches=json.dumps({k: v for k, v in launches.items() if v})
            .replace(" ", ""),
            launches_equal_onehot_step=True)
    torch.cuda.empty_cache()


@contextlib.contextmanager
def loader_from(batch: int):
    """``data.loader.data_loader`` starting at its ``batch``-th batch
    while the block runs (``cli.train`` builds its loader through it), so
    that a resumed run reads what the uninterrupted one read next."""
    from speechsplit_tpu_torch.data import loader as loader_lib

    saved = loader_lib.data_loader

    def skipping(*args, **kwargs):
        batches = saved(*args, **kwargs)
        for _ in range(batch):
            next(batches)
        return batches

    loader_lib.data_loader = skipping
    try:
        yield
    finally:
        loader_lib.data_loader = saved


def phase_train_cli_learned(gen_per_step: dict) -> None:
    """``cli.train --hparams spk_emb_mode=learned`` at the default config
    otherwise: ``CLI_STEPS`` iterations with a checkpoint every
    ``CLI_SAVE``, each step launching the one-hot step's kernels, finite
    losses, each checkpoint loading strictly into a learned model and
    refused by a one-hot one; a resume from step ``CLI_SAVE`` (its loader
    started at the batch the uninterrupted run read next) whose state
    before its first step (params, Adam moments, step, generator state)
    equals the checkpoint's and whose last checkpoint and logged loss
    equal the uninterrupted run's, bit for bit; then ``check_validate``
    in learned mode (TF32 off, ``PATH_TOL``)."""
    import shutil

    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.interop import load_reference_checkpoint
    from speechsplit_tpu_torch.models import SpeechSplit
    from speechsplit_tpu_torch.training import checkpoint as ckpt_lib

    config = SpeechSplitConfig()
    hparams = "spk_emb_mode=learned"
    with tempfile.TemporaryDirectory() as tmp:
        root_dir, feat_dir = write_feature_tree(tmp, config, SEED + 9)
        run = os.path.join(tmp, "run_G")
        models = os.path.join(run, "models")

        def args(save_dir, iters, *extra):
            return [
                "--num_iters", str(iters), "--model_save_dir", save_dir,
                "--log_step", str(CLI_SAVE), "--model_save_step",
                str(CLI_SAVE), "--sample_step", "1000",
                "--log_dir", os.path.join(run, "logs"),
                "--sample_dir", os.path.join(run, "samples"),
                "--validation_path", os.path.join(tmp, "no_such.pkl"),
                "--hparams",
                f"root_dir={root_dir},feat_dir={feat_dir},{hparams}",
                "--device", "cuda", *extra]

        def ckpt(root, step):
            return torch.load(ckpt_lib.checkpoint_path(root, step, "G"),
                              map_location="cpu", weights_only=True)

        losses, _, state = run_cli_train(args(models, CLI_STEPS), CLI_STEPS,
                                         gen_per_step, "learned")
        if not hasattr(state.model, "speaker_encoder"):
            fail("train.cli learned: the model has no speaker encoder")
        del state
        for step in (CLI_SAVE, CLI_STEPS):
            sd = load_reference_checkpoint(
                ckpt_lib.checkpoint_path(models, step, "G"))
            SpeechSplit(learned(config)).load_state_dict(sd, strict=True)
            try:
                SpeechSplit(config).load_state_dict(sd, strict=True)
            except RuntimeError:
                pass
            else:
                fail(f"train.cli learned: {step}-G.ckpt loaded into a "
                     "one-hot model")
        resumed = os.path.join(run, "resumed")
        shutil.copytree(models, resumed)
        os.remove(ckpt_lib.checkpoint_path(resumed, CLI_STEPS, "G"))
        with loader_from(CLI_SAVE):
            r_losses, r_record, _ = run_cli_train(
                args(resumed, CLI_STEPS - CLI_SAVE, "--resume_iters",
                     str(CLI_SAVE)),
                CLI_STEPS - CLI_SAVE, gen_per_step, "learned resumed")
        if not same_state(r_record["first"], ckpt(models, CLI_SAVE)):
            fail(f"train.cli learned: the resumed state before its first "
                 f"step differs from the run's {CLI_SAVE}-G.ckpt")
        last = ckpt(resumed, CLI_STEPS)
        last = dict(last, optimizer=last["optimizer"]["state"])
        if not (same_state(last, ckpt(models, CLI_STEPS))
                and r_losses == losses[1:]):
            fail(f"train.cli learned: the resumed run ({r_losses}) differs "
                 f"from the uninterrupted one ({losses[1:]}) at step "
                 f"{CLI_STEPS}")
        log("train.cli learned", steps=CLI_STEPS, hparams=hparams,
            checkpoints=f"{CLI_SAVE}-G,{CLI_STEPS}-G strict into a learned "
            "model, refused by a one-hot one",
            resumed_from=f"{CLI_SAVE}-G state equal bit for bit",
            resumed_run=f"{CLI_STEPS}-G and its loss equal to the "
            "uninterrupted run's bit for bit",
            losses=",".join(f"{v:.6f}" for v in losses),
            resumed_losses=",".join(f"{v:.6f}" for v in r_losses),
            launches_a_step=json.dumps(gen_per_step).replace(" ", ""))
        shutil.rmtree(run)
        with strict_float32("train.cli learned validate"):
            check_validate(learned(config), tmp, PATH_TOL, " learned")


def phase_convert_learned(reps: int = 10) -> None:
    """Zero-shot conversion at full width: seeded learned-mode models,
    ``with_learned_embedding`` on both utterances of 4 synthetic pairs,
    then ``convert_batched`` (4 pairs x 7 conditions): the one-hot call's
    launches, finite mels cut to their lengths, the embeddings (unit
    norm) and the mels within ``PATH_TOL`` of the same calls on the plain
    versions, ms a call (the 8 embeddings and the conversion) in turns
    with the one-hot call of the same weights; TF32 off. Then the same
    learned call at bfloat16 compute (the same weights): its launches,
    its embeddings and the mels of the conditions on the source's F0
    (R, U, RU) within ``COMPUTE_PATH_TOL`` of the largest magnitude of
    its plain call's, and the converted F0 (the F0 converter's argmax)
    in another bin on at most ``COMPUTE_FLIP_SHARE`` of its frames: a
    rounding flip in a near-tie moves the argmax, and the conditions
    with F then convert another contour (measured: 1 frame of 768, the F
    conditions 0.065 of the largest magnitude apart, the others 0.002;
    the error of each condition is logged)."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import (
        CONDITIONS,
        _f0_onehot,
        convert_batched,
        with_learned_embedding,
    )
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    onehot = SpeechSplitConfig()
    config = learned(onehot)
    models = {}
    for label, cfg in (("learned", config), ("onehot", onehot)):
        # the speaker encoder is built last: the shared weights are equal
        gen = torch.Generator().manual_seed(SEED + 17)
        models[label] = (SpeechSplit(cfg, generator=gen).to("cuda").eval(),
                         F0Converter(cfg, generator=gen).to("cuda").eval())
    pairs = synthetic_pairs(onehot, 4, "cuda", SEED)

    def run():
        g, p = models["learned"]
        zero_shot = [(with_learned_embedding(config, g, s),
                      with_learned_embedding(config, g, t))
                     for s, t in pairs]
        embs = torch.cat([u.spk_emb for pair in zero_shot for u in pair])
        return embs, convert_batched(g, p, zero_shot, CONDITIONS)

    with strict_float32("convert learned: the calls and their timing"):
        run()
        torch.cuda.synchronize()
        reset_launches()
        embs, result = run()
        counts = {k: v for k, v in read_launches().items() if v}
        if counts != {"bilstm_infer": 6, "multi_bilstm_infer": 2}:
            fail(f"convert learned: launches {counts}")
        check_conversions(config, pairs, result)
        norms = torch.linalg.norm(embs, dim=-1)
        if not (embs.shape == (8, config.dim_spk_emb)
                and float((norms - 1).abs().max()) <= 1e-5):
            fail(f"convert learned: embeddings {tuple(embs.shape)}, norms "
                 f"{norms.tolist()}")
        with plain_kernels():
            plain_embs, plain = run()
        emb_err = float((embs - plain_embs).abs().max())
        err = max(float(np.abs(a[1] - b[1]).max())
                  for ra, rb in zip(result, plain) for a, b in zip(ra, rb))
        if not (emb_err <= PATH_TOL and err <= PATH_TOL):
            fail(f"convert learned vs plain: embeddings {emb_err}, mels "
                 f"{err} > {PATH_TOL}")
        samples = {"learned": [], "onehot": []}
        for r in range(reps):
            for label in (("learned", "onehot") if r % 2 == 0
                          else ("onehot", "learned")):
                torch.cuda.synchronize()
                start = time.perf_counter()
                if label == "learned":
                    run()
                else:
                    convert_batched(*models["onehot"], pairs, CONDITIONS)
                samples[label].append((time.perf_counter() - start) * 1e3)
        g16 = SpeechSplit(learned(compute_config())).to("cuda").eval()
        p16 = F0Converter(compute_config()).to("cuda").eval()
        g16.load_state_dict(models["learned"][0].state_dict())
        p16.load_state_dict(models["learned"][1].state_dict())

        def run16():
            zero_shot = [(with_learned_embedding(config, g16, s),
                          with_learned_embedding(config, g16, t))
                         for s, t in pairs]
            return (torch.cat([u.spk_emb for pair in zero_shot
                               for u in pair]),
                    convert_batched(g16, p16, zero_shot, CONDITIONS))

        def f0_ids():  # the converted contour's bins, as the call has them
            return _f0_onehot(p16, torch.cat([s.mel for s, _ in pairs]),
                              torch.cat([t.f0_onehot for _, t in pairs])
                              ).argmax(dim=-1)

        reset_launches()
        embs16, result16 = run16()
        counts16 = {k: v for k, v in read_launches().items() if v}
        f0_16 = f0_ids()
        with plain_kernels():
            plain_embs16, plain16 = run16()
            plain_f0_16 = f0_ids()
        f0_flips = float((f0_16 != plain_f0_16).float().mean())
        errs16 = {c: max(float(np.abs(ra[ci][1] - rb[ci][1]).max()) / max(
            float(np.abs(rb[ci][1]).max()), 1e-30)
            for ra, rb in zip(result16, plain16))
            for ci, c in enumerate(CONDITIONS)}
        # the source's F0 conditions at the mel bar; the converted F0 is
        # an argmax, which a rounding flip in a near-tie moves a bin
        err16 = max([float((embs16 - plain_embs16).abs().max())]
                    + [e for c, e in errs16.items() if "F" not in c])
        if not (counts16 == counts and err16 <= COMPUTE_PATH_TOL
                and f0_flips <= COMPUTE_FLIP_SHARE):
            fail(f"convert learned bf16 compute: launches {counts16}, "
                 f"{errs16} of the largest magnitude from the plain call, "
                 f"{f0_flips} of the converted F0 frames another bin")
        del g16, p16
    log("convert learned", pairs=4, conditions=len(CONDITIONS),
        embeddings=8, generator_batch=28,
        median_ms_per_call=f"{np.median(samples['learned']):.4f}",
        onehot_median_ms_per_call=f"{np.median(samples['onehot']):.4f}",
        timing="learned (8 embeddings and the conversion) and one-hot "
        "calls in turns, TF32 off",
        emb_max_abs_err_vs_plain=f"{emb_err:.3g}",
        mel_max_abs_err_vs_plain=f"{err:.3g}", tol=PATH_TOL,
        bf16_compute_max_err_over_max_vs_plain=f"{err16:.3g}",
        bf16_compute_tol=COMPUTE_PATH_TOL,
        bf16_compute_f0_bins_flipped=f"{f0_flips:.4g}",
        bf16_compute_f0_flip_tol=COMPUTE_FLIP_SHARE,
        bf16_compute_err_by_condition=",".join(
            f"{c}:{e:.3g}" for c, e in errs16.items()),
        launches=json.dumps(counts).replace(" ", ""))
    del models


def check_neural_vocoder(mels) -> dict:
    """The shipped neural vocoder on the card against the port's vocoder
    on the CPU for the same ``mels``: the head's spectrum within
    ``VOCODER_SPEC_TOL`` of its largest magnitude; after
    ``VOCODER_REFINE`` iterations each mel's PCM16 within
    ``VOCODER_PCM16_RMS`` (the RMS of the difference over the CPU's),
    the two outputs' mels within ``VOCODER_MEL_DB`` dB of each other on
    average, and their distances from the target mel (dB) within
    ``VOCODER_RESYNTH_DB``. Returns the measured values."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.ops.stft import mel_spectrogram
    from speechsplit_tpu_torch.vocoder_neural import load_vocoder

    t_max = -(-max(len(m) for m in mels) // 32) * 32
    batch = np.zeros((len(mels), t_max, 80), np.float32)
    for i, m in enumerate(mels):
        batch[i, : len(m)] = m
    spec = {dev: load_vocoder("default", device=dev).spectrum(
        torch.from_numpy(batch)).cpu() for dev in ("cuda", "cpu")}
    spec_err = float((spec["cuda"] - spec["cpu"]).abs().max()) / float(
        spec["cpu"].abs().max())
    pcm = {dev: load_vocoder("default", refine_iters=VOCODER_REFINE,
                             device=dev).synthesize_batch(mels, pcm16=True)
           for dev in ("cuda", "cpu")}

    def mel_db(q):  # the normalized mel of a PCM16 wav, in dB (x 100)
        return mel_spectrogram(torch.from_numpy(
            q.astype(np.float32) / 32768.0)[None])[0] * 100.0

    rows = []
    for card, cpu, target in zip(pcm["cuda"], pcm["cpu"], mels):
        diff = (card.astype(np.float64) - cpu).ravel()
        m_card, m_cpu = mel_db(card), mel_db(cpu)
        tgt = torch.from_numpy(target[: len(m_cpu)]) * 100.0
        rows.append(dict(
            codes=int(np.abs(diff).max()),
            rms=float(np.sqrt(np.mean(diff ** 2) / np.mean(
                cpu.astype(np.float64) ** 2))),
            mel_db=float((m_card - m_cpu).abs().mean()),
            resynth=abs(float((m_card[: len(tgt)] - tgt).abs().mean())
                        - float((m_cpu[: len(tgt)] - tgt).abs().mean()))))
    worst = {k: max(r[k] for r in rows) for k in rows[0]}
    if not (spec_err <= VOCODER_SPEC_TOL
            and worst["rms"] <= VOCODER_PCM16_RMS
            and worst["mel_db"] <= VOCODER_MEL_DB
            and worst["resynth"] <= VOCODER_RESYNTH_DB):
        fail(f"neural vocoder card vs CPU: spectrum {spec_err} (tol "
             f"{VOCODER_SPEC_TOL}), after {VOCODER_REFINE} iterations "
             f"{worst}")
    return dict(spec_max_abs_err_over_max=f"{spec_err:.3g}",
                spec_tol=VOCODER_SPEC_TOL, refine_iters=VOCODER_REFINE,
                pcm16_rms_rel=",".join(f"{r['rms']:.3g}" for r in rows),
                pcm16_rms_tol=VOCODER_PCM16_RMS,
                mel_mean_abs_db=",".join(f"{r['mel_db']:.4f}" for r in rows),
                mel_db_tol=VOCODER_MEL_DB,
                resynth_db_apart=",".join(f"{r['resynth']:.4f}"
                                          for r in rows),
                resynth_db_tol=VOCODER_RESYNTH_DB,
                pcm16_max_codes=",".join(str(r["codes"]) for r in rows))


def phase_serve_learned(reps: int = 3) -> None:
    """Zero-shot serving with the shipped neural vocoder: a ``cli.serve``
    handler over a learned-mode ``VoiceConverter`` (full-width seeded
    models from ``.ckpt`` files, ``load_vocoder("default",
    refine_iters=48)``) and, beside it, one over the same models with
    Griffin-Lim. Three requests with no embeddings passed (the 3 s pair,
    the 8 s pair through ``convert_long``, the 3 s pair again, whose mels
    must equal the first's), each reply 200 with 7 wavs and 7 finite
    mels, their launches; each pair's mels within ``PATH_TOL`` of the
    same call under ``plain_kernels()``, its F0 equal; ms a request
    split into features, conversion and vocoder, the two servers in
    turns (median of ``reps`` after the warm-up); the card's busy share
    of one request; ``check_neural_vocoder`` on the four wavs' mels;
    TF32 off."""
    import threading
    from http.server import HTTPServer

    import numpy as np
    import torch
    from scipy.io import wavfile
    from torch.profiler import ProfilerActivity, profile

    from speechsplit_tpu_torch.cli.serve import build_handler
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.data.prepare import read_wav
    from speechsplit_tpu_torch.interop import save_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
    from speechsplit_tpu_torch.pipeline import VoiceConverter
    from speechsplit_tpu_torch.vocoder_neural import load_vocoder

    config = learned(SpeechSplitConfig())
    gen = torch.Generator().manual_seed(SEED + 13)
    with tempfile.TemporaryDirectory() as tmp:
        g_path = os.path.join(tmp, "G.ckpt")
        p_path = os.path.join(tmp, "P.ckpt")
        save_reference_checkpoint(SpeechSplit(config, generator=gen), g_path)
        save_reference_checkpoint(F0Converter(config, generator=gen), p_path)
        converters = {
            "neural": VoiceConverter.from_checkpoints(
                g_path, p_path, config=config, device="cuda",
                vocoder=load_vocoder(
                    "default", hop=config.hop_length,
                    sample_rate=config.sample_rate,
                    refine_iters=VOCODER_REFINE, device="cuda")),
            "griffin_lim": VoiceConverter.from_checkpoints(
                g_path, p_path, config=config, device="cuda")}
        pairs = {}
        for name, seconds in (("short", SHORT_S), ("long", LONG_S)):
            paths = []
            for side, (f_a, f_b) in (("src", (105.0, 150.0)),
                                     ("trg", (190.0, 260.0))):
                path = os.path.join(tmp, f"{name}_{side}.wav")
                wavfile.write(path, SAMPLE_RATE, synth_wav(
                    seconds, f_a, f_b, SEED + len(paths) + int(seconds)))
                paths.append(path)
            pairs[name] = (paths[0], paths[1])
        servers = {}
        for label, conv in converters.items():
            httpd = HTTPServer(("127.0.0.1", 0), build_handler(
                conv, os.path.join(tmp, f"out_{label}")))
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            servers[label] = (httpd, thread,
                              f"http://127.0.0.1:{httpd.server_port}")

        def request(label, name, tag):
            src, trg = pairs[name]
            return check_reply(*post_convert(servers[label][2], {
                "source_wav": src, "target_wav": trg,
                "out_dir": os.path.join(tmp, f"o_{label}_{name}_{tag}")}),
                f"learned {label} {name}")

        conv = converters["neural"]
        try:
            with strict_float32("serve learned: the requests, the plain "
                                "calls and the timing"):
                for label in servers:
                    request(label, "short", "warm")
                torch.cuda.synchronize()
                per_request, replies = [], []
                for i, name in enumerate(("short", "long", "short")):
                    before = read_launches()
                    replies.append(request("neural", name, i))
                    after = read_launches()
                    per_request.append({k: after[k] - before[k] for k in (
                        "viterbi_decode", "bilstm_infer",
                        "multi_bilstm_infer", "lstm_infer")})
                if per_request[0]["viterbi_decode"] != 2 or not all(
                        r["bilstm_infer"] and r["multi_bilstm_infer"]
                        for r in per_request):
                    fail(f"serve learned: launches {per_request}")
                repeat = max(float(np.abs(replies[0][c] - replies[2][c])
                                   .max()) for c in replies[0])
                if not repeat <= REPEAT_TOL:
                    fail(f"serve learned: the repeated request's mels "
                         f"differ by {repeat}")
                errs = {}
                for name, reply in (("short", replies[0]),
                                    ("long", replies[1])):
                    src, trg = pairs[name]
                    f0 = conv.extract_features_full(read_wav(src), "M")[1]
                    with plain_kernels():
                        f0_plain = conv.extract_features_full(read_wav(src),
                                                              "M")[1]
                        plain = conv.convert_wav_files(src, trg,
                                                       synthesize=False)
                    if not np.array_equal(f0, f0_plain):
                        fail(f"serve learned {name}: F0 differs from the "
                             "plain call's")
                    errs[name] = max(float(np.abs(reply[c] - plain[c]["mel"])
                                           .max()) for c in reply)
                    if not errs[name] <= PATH_TOL:
                        fail(f"serve learned {name}: mels {errs[name]} from "
                             "the plain call's")
                timings = {}
                for name in ("short", "long"):
                    walls = {k: [] for k in servers}
                    splits = {k: [] for k in servers}
                    for r in range(reps):
                        for label in (list(servers) if r % 2 == 0
                                      else list(servers)[::-1]):
                            start = time.perf_counter()
                            request(label, name, f"t{r}")
                            walls[label].append(
                                (time.perf_counter() - start) * 1e3)
                            splits[label].append(
                                dict(converters[label].last_timings))
                    for label in servers:
                        row = {"ms_per_request": float(np.median(
                            walls[label]))}
                        for key in splits[label][0]:
                            row[key] = float(np.median(
                                [s[key] for s in splits[label]]))
                        timings[(name, label)] = row
                src, trg = pairs["short"]
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    start = time.perf_counter()
                    conv.convert_wav_files(src, trg, pcm16=True)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - start) * 1e3
                mels = [conv.extract_features_full(read_wav(path), "M")[0]
                        for n in ("short", "long") for path in pairs[n]]
        finally:
            for httpd, thread, _ in servers.values():
                httpd.shutdown()
                thread.join()
        vocoder_check = check_neural_vocoder(mels)
        for (name, label), row in timings.items():
            log("serve learned", pair=name, vocoder=label,
                seconds=SHORT_S if name == "short" else LONG_S,
                **{k: f"{v:.4f}" for k, v in row.items()},
                timing="the neural and Griffin-Lim servers in turns",
                **({"launches": json.dumps(
                    per_request[0 if name == "short" else 1]).replace(
                        " ", ""),
                    "max_abs_err_vs_plain": f"{errs[name]:.3g}",
                    "tol": PATH_TOL} if label == "neural" else {}))
        log("serve learned", requests=3, all_status=200,
            embeddings="each wav's own mel", vocoder_refine=VOCODER_REFINE,
            repeat_max_abs=f"{repeat:.3g}", tf32="off")
        log("serve learned vocoder", mels=",".join(str(len(m))
                                                   for m in mels),
            card="cuda", against="the port's vocoder on the CPU",
            **vocoder_check)
        profile_events("serve learned profile", prof, wall_ms, top=10)
        del converters, prof
    torch.cuda.empty_cache()


# corpus preparation and the vocoder's trainer: the smoke's own
# wav tree, 4 speakers (2 M, 2 F) x PREP_UTTS utterances of 1-8 s
PREP_SPEAKERS = (("p225", "M"), ("p226", "M"), ("p227", "F"), ("p228", "F"))
PREP_UTTS = 80
PREP_SECONDS = (1.0, 8.0)
# the JAX defaults of cli.preprocess
PREP_BATCH = 16
PREP_DISPATCH = 8
# files of the hooked run held against extract_features on their batch
PREP_SAMPLE_BATCHES = 3
# default-config cli.train steps on the prepared corpus
PREP_TRAIN_STEPS = 4
# cli.train_vocoder at the shipped asset's width
VOC_ITERS = 200
VOC_DISPATCH = 25
VOC_BATCH = 16
VOC_CROP = 64
# the card's vocoder step against the port's step on the CPU from the
# same state and crops: the loss, relative; the gradient as one vector
# (relative L2) within this many times the CPU's float32 distance from
# the float64 gradient on the CPU (a reference the card does not touch;
# the two float32 gradients scatter about the exact one independently:
# the loss's L1 terms make that scatter large,
# tests/test_torch_vocoder_train.py)
VOC_LOSS_TOL = 1e-5
VOC_GRAD_NOISE_TIMES = 3.0
# the network's backward up to its head (``MelToSpec.head_out``) on one
# seeded cotangent, card against CPU, within this many times the CPU's
# float32 distance from float64 (a smooth map: a TF32 backward on the
# card must land outside)
VOC_BACKWARD_NOISE_TIMES = 30.0
# timed rounds of the resident path and the host make_crops path, in turns
VOC_ROUNDS = 2


def write_corpus(root: str, seed: int) -> tuple:
    """The smoke's wav tree: ``root/wavs/<spk>/<spk>_<i>.wav`` (PCM16,
    16 kHz) of ``synth_wav`` tones, 1-8 s, M speakers gliding within
    85-170 Hz, F within 165-330 Hz, and ``root/spk2gen.pkl``. Returns
    (wav_dir, spk2gen path, utterances, samples)."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(root, "wavs")
    samples = 0
    for s, (spk, gender) in enumerate(PREP_SPEAKERS):
        os.makedirs(os.path.join(wav_dir, spk))
        base = 85.0 if gender == "M" else 165.0
        for i in range(PREP_UTTS):
            seconds = float(rng.uniform(*PREP_SECONDS))
            f_start, f_end = base * (1.0 + rng.random(2))
            wav = synth_wav(seconds, f_start, f_end, seed + 1000 * s + i)
            wavfile.write(os.path.join(wav_dir, spk, f"{spk}_{i:03d}.wav"),
                          SAMPLE_RATE, wav)
            samples += len(wav)
    spk2gen = os.path.join(root, "spk2gen.pkl")
    with open(spk2gen, "wb") as handle:
        pickle.dump(dict(PREP_SPEAKERS), handle)
    return wav_dir, spk2gen, len(PREP_SPEAKERS) * PREP_UTTS, samples


def read_tree(path: str) -> dict:
    import numpy as np

    return {(spk, f): np.load(os.path.join(path, spk, f))
            for spk in sorted(os.listdir(path))
            if os.path.isdir(os.path.join(path, spk))
            for f in sorted(os.listdir(os.path.join(path, spk)))}


def same_tree(a: dict, b: dict) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def hooked_draws(group: int, k: int, shape):
    """The dither of batch k of group ``group`` in the hooked run: drawn on
    the card from a generator seeded by the batch's place."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1000 * group + k)
    return torch.rand(tuple(shape), generator=gen, device="cuda")


def phase_prepare(gen_per_step: dict, root: str) -> dict:
    """Corpus preparation on the smoke's own wav tree (``write_corpus``):
    ``cli.preprocess`` at the JAX defaults (B16, 8 batches a dispatch;
    launch counts set to 0 just before and read just after: one
    ``viterbi_decode`` a batch, nothing else) and ``cli.metadata``; every
    file of the right shape and finite, the F0 normalized or unvoiced;
    ``extract_dir`` again with the same seed (its stages' seconds kept),
    whose files must equal the first run's bit for bit; a run with the
    dither hook (draws made on the card by ``hooked_draws``) whose files,
    for ``PREP_SAMPLE_BATCHES`` batches, equal ``extract_features`` on
    the batch with the same draws, and the same extraction with the
    plain decoder (``plain_kernels``: F0 equal, so the kernel's states are
    the plain loop's; mel within ``FRONT_END_PLAIN_TOL``); a run under
    ``torch.profiler`` (the card's busy share of it); ``viterbi_decode``
    at B16 and an 8 s utterance's frames (ms, device ms, plain ms,
    bound); the dither's [B, N] draws of the largest batch made on the
    host and uploaded beside drawn on the card; then ``cli.train`` at the
    default config for ``PREP_TRAIN_STEPS`` steps on the prepared corpus
    (launches a step as ``phase_train``'s, finite losses). Returns the
    decoder's row fields for the kernels' JSON."""
    import io

    import numpy as np
    import torch

    from speechsplit_tpu_torch.cli import metadata as cli_metadata
    from speechsplit_tpu_torch.cli import preprocess as cli_preprocess
    from speechsplit_tpu_torch.data import prepare
    from speechsplit_tpu_torch.ops import pitch
    from speechsplit_tpu_torch.preprocess import extract_features

    wav_dir, spk2gen, utts, samples = write_corpus(root, SEED + 16)
    genders = dict(PREP_SPEAKERS)
    _, entries = prepare._enumerate_entries(wav_dir, genders)
    batches = -(-len(entries) // PREP_BATCH)
    mel_dir, f0_dir = os.path.join(root, "spmel"), os.path.join(root, "raptf0")

    def tree(tag):
        return os.path.join(root, f"spmel{tag}"), os.path.join(
            root, f"raptf0{tag}")

    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_preprocess.main([
            "--wav_dir", wav_dir, "--mel_dir", mel_dir, "--f0_dir", f0_dir,
            "--spk2gen", spk2gen, "--batch_size", str(PREP_BATCH),
            "--batches_per_dispatch", str(PREP_DISPATCH), "--seed",
            str(SEED), "--device", "cuda"])
    cli_s = time.perf_counter() - start
    launches = read_launches()
    if launches["viterbi_decode"] != batches or any(
            v for k, v in launches.items() if k != "viterbi_decode"):
        fail(f"cli.preprocess launched {launches}, expected "
             f"{batches} viterbi_decode (one a batch)")
    mels, f0s = read_tree(mel_dir), read_tree(f0_dir)
    frames = 0
    for spk, fname, _lo, _hi, _size in entries:
        key = (spk, fname[:-4] + ".npy")
        want = prepare.wav_frame_count(os.path.join(wav_dir, spk, fname))
        mel, f0 = mels.get(key), f0s.get(key)
        if mel is None or f0 is None or mel.shape != (want, 80) or (
                f0.shape != (want,)) or not np.isfinite(mel).all() or not (
                ((f0 >= 0) & (f0 <= 1)) | (f0 == np.float32(-1e10))).all():
            fail(f"cli.preprocess: {key} mel "
                 f"{None if mel is None else mel.shape}, F0 "
                 f"{None if f0 is None else f0.shape}, {want} frames due")
        frames += want
    if len(mels) != utts:
        fail(f"cli.preprocess wrote {len(mels)} mels for {utts} wavs")
    with contextlib.redirect_stdout(io.StringIO()):
        meta = cli_metadata.main(["--mel_dir", mel_dir])
    if [m[0] for m in meta] != [s for s, _ in PREP_SPEAKERS] or sum(
            len(m) - 2 for m in meta) != utts:
        fail(f"cli.metadata: {[(m[0], len(m) - 2) for m in meta]}")

    # the same seed again: the same files; the stages' seconds
    stats = {}
    repeat_mel, repeat_f0 = tree("_repeat")
    torch.cuda.synchronize()
    start = time.perf_counter()
    prepare.extract_dir(wav_dir, repeat_mel, repeat_f0, genders, seed=SEED,
                        batch_size=PREP_BATCH,
                        batches_per_dispatch=PREP_DISPATCH, device="cuda",
                        stats=stats)
    run_s = time.perf_counter() - start
    if not (same_tree(read_tree(repeat_mel), mels)
            and same_tree(read_tree(repeat_f0), f0s)):
        fail("extract_dir with the same seed wrote other files")

    # the dither hook: a sample of files against extract_features
    hook_mel, hook_f0 = tree("_hook")
    prepare.extract_dir(wav_dir, hook_mel, hook_f0, genders, seed=SEED,
                        batch_size=PREP_BATCH,
                        batches_per_dispatch=PREP_DISPATCH, device="cuda",
                        dither=hooked_draws)
    hook = (read_tree(hook_mel), read_tree(hook_f0))
    staged = [(g, k, item) for g, (group, _) in enumerate(
        prepare._staged_groups(wav_dir, entries, batch_size=PREP_BATCH,
                               batches_per_dispatch=PREP_DISPATCH))
              for k, item in enumerate(group)]
    picks = sorted({0, len(staged) // 2, len(staged) - 1})[
        :PREP_SAMPLE_BATCHES]
    sample_files, plain_err = 0, 0.0
    for g, k, (job, batch, lengths) in (staged[i] for i in picks):
        draws = hooked_draws(g, k, batch.shape)
        lo = [e[2] for e in job]
        hi = [e[3] for e in job]
        mel, f0 = extract_features(batch, lengths, lo, hi, uniform=draws,
                                   device="cuda")
        with plain_kernels():
            mel_p, f0_p = extract_features(batch, lengths, lo, hi,
                                           uniform=draws, device="cuda")
        if not torch.equal(f0, f0_p):
            fail(f"extract_dir batch {g}.{k}: the decoder kernel's F0 "
                 f"differs from the plain loop's")
        plain_err = max(plain_err, float((mel - mel_p).abs().max()))
        mel, f0 = mel.cpu().numpy(), f0.cpu().numpy()
        for i, (spk, fname, _lo, _hi) in enumerate(job):
            n = int(lengths[i]) // 256 + 1
            key = (spk, fname[:-4] + ".npy")
            if not (np.array_equal(hook[0][key], mel[i, :n])
                    and np.array_equal(hook[1][key], f0[i, :n])):
                fail(f"extract_dir {key} differs from extract_features on "
                     f"its batch with the same draws")
            sample_files += 1
    if not plain_err <= FRONT_END_PLAIN_TOL:
        fail(f"extract_dir batches: mel {plain_err} from the plain "
             f"decoder's")

    # the card's busy share of a profiled run
    prof_mel, prof_f0 = tree("_profiled")
    trace = os.path.join(root, "prepare_trace.json")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prepare.extract_dir(wav_dir, prof_mel, prof_f0, genders, seed=SEED,
                            batch_size=PREP_BATCH,
                            batches_per_dispatch=PREP_DISPATCH,
                            device="cuda")
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    span, busy = trace_busy(trace)
    if not busy > 0:
        fail("extract_dir: the profiled run holds no device time")

    # the decoder at B16 and an 8 s utterance's frames
    params = pitch.PitchParams()
    t8 = int(PREP_SECONDS[1] * SAMPLE_RATE) // 256 + 1
    fields = viterbi_fields(PREP_BATCH, t8, params.num_cands, SEED + 16,
                            "random")

    def kernel():
        return pitch.viterbi_decode(*fields, params.freq_weight,
                                    params.trans_cost)

    if not torch.equal(kernel(), pitch.viterbi_decode_reference(
            *fields, params.freq_weight, params.trans_cost)):
        fail(f"viterbi_decode B{PREP_BATCH} T{t8}: states differ from the "
             f"plain loop's")
    vit = dict(ms=time_ms(kernel, 20), device_ms=kernel_device_ms(kernel, 20),
               plain_ms=time_ms(lambda: pitch.viterbi_decode_reference(
                   *fields, params.freq_weight, params.trans_cost), 1,
                   warmup=0))
    vit["bound_ms"], vit["bound_by"] = viterbi_bound(PREP_BATCH, t8,
                                                        params.num_cands)

    # the dither's draws of the largest batch: host and upload, or card
    n_max = max(b.shape[1] for _g, _k, (_j, b, _l) in staged)
    host_gen = torch.Generator().manual_seed(SEED)
    card_gen = torch.Generator(device="cuda").manual_seed(SEED)
    host_draw = time_ms(lambda: torch.rand(
        (PREP_BATCH, n_max), generator=host_gen).to("cuda"), 10)
    card_draw = time_ms(lambda: torch.rand(
        (PREP_BATCH, n_max), generator=card_gen, device="cuda"), 10)

    # cli.train at the default config reads the corpus
    losses, _, _ = run_cli_train([
        "--num_iters", str(PREP_TRAIN_STEPS), "--log_step", "2",
        "--model_save_step", str(PREP_TRAIN_STEPS), "--sample_step", "1000",
        "--model_save_dir", os.path.join(root, "models"),
        "--log_dir", os.path.join(root, "logs"),
        "--sample_dir", os.path.join(root, "samples"),
        "--validation_path", os.path.join(root, "no_such.pkl"),
        "--hparams", f"root_dir={mel_dir},feat_dir={f0_dir}",
        "--device", "cuda"], PREP_TRAIN_STEPS, gen_per_step,
        "prepared corpus", log_step=2, probe=False)

    seconds = samples / SAMPLE_RATE
    log("prepare", speakers=len(PREP_SPEAKERS), utterances=utts,
        audio_seconds=f"{seconds:.1f}", batches=batches,
        batch_size=PREP_BATCH, batches_per_dispatch=PREP_DISPATCH,
        viterbi_launches=launches["viterbi_decode"],
        cli_preprocess_s=f"{cli_s:.4f}", extract_dir_s=f"{run_s:.4f}",
        ms_per_utterance=f"{run_s * 1e3 / utts:.4f}",
        mel_frames_per_s=f"{frames / run_s:.1f}",
        audio_s_per_s=f"{seconds / run_s:.1f}",
        read_s=f"{stats['read']:.4f}",
        dispatch_s=f"{stats['dispatch']:.4f}",
        fetch_wait_s=f"{stats['fetch']:.4f}",
        write_s=f"{stats['write']:.4f}",
        stages_note="read and write on their own threads, overlapping",
        repeat_equal=True, sample_files=sample_files,
        sample_equal_extract_features=True,
        mel_err_vs_plain_decoder=f"{plain_err:.3g}",
        f0_equal_plain_decoder=True,
        profiled_span_ms=f"{span:.4f}", profiled_busy_ms=f"{busy:.4f}",
        profiled_idle_share=f"{1 - busy / span:.4f}",
        dither_host_draw_and_upload_ms=f"{host_draw:.4f}",
        dither_card_draw_ms=f"{card_draw:.4f}", dither_shape=
        f"{PREP_BATCH}x{n_max}",
        train_cli_steps=PREP_TRAIN_STEPS,
        train_cli_losses=",".join(f"{v:.6f}" for v in losses),
        train_cli_launches_a_step=json.dumps(gen_per_step).replace(" ", ""))
    log("kernel viterbi_decode extract_dir", shape=f"B{PREP_BATCH}xT{t8}xK"
        f"{params.num_cands}", **fmt(vit))
    return dict(launches_extract_dir=launches["viterbi_decode"],
                extract_dir_batches=batches,
                extract_dir_b16={"shape": f"B{PREP_BATCH}xT{t8}xK"
                                 f"{params.num_cands}", **vit})


# [train resident]: device-resident features and K steps a call on the
# corpus [prepare] wrote
RESIDENT_GATHER_BATCHES = 6
# the JAX README's recommended run: cli.train --data_on_device
# --steps_per_dispatch 10 --hparams "batch_size=32,compute_dtype=bfloat16",
# here from the wav tree (--wav_dir), 50 steps, a loss logged every 10
RECOMMENDED_HPARAMS = "batch_size=32,compute_dtype=bfloat16"
RESIDENT_K = 10
RESIDENT_CLI_STEPS = 50
RESIDENT_CLI_LOG = 10
# Solver steps a timed run (after a warm-up run of one call), rounds of the
# four loops (host K=1, host K=10, resident K=1, resident K=10) in turns
RESIDENT_TIMED_STEPS = 40
RESIDENT_ROUNDS = 2
# float32 (TF32 off) steps repeat bit for bit on the card only under
# ``torch.backends.cudnn.deterministic``: without it the convolutions'
# weight gradients vary from run to run (``[train learned]``'s
# ``repeat_differing``), and the trajectories' distance with them, over
# two orders of magnitude. The float32 trajectories are compared under it.


def resident_trajectory(cfg, dataset, features, utts, per_step: dict,
                        mixed: bool):
    """8 generator steps at ``cfg`` from one seeded state on the host
    loader's first 8 batches: 8 single host-batch steps, or (``mixed``)
    2 resident steps on ``[B]`` plans, one resident call on a ``[2, B]``
    plan and one ``make_train_multi_step`` call on the host batches 5-8
    stacked. Each call's launches (counts set to 0 just before and read
    just after) must be its steps x ``per_step``. Returns (state, losses
    [8])."""
    import torch

    from speechsplit_tpu_torch.data import data_loader
    from speechsplit_tpu_torch.data import resident as res
    from speechsplit_tpu_torch.data.prefetch import stack_batches
    from speechsplit_tpu_torch.training import (
        create_train_state,
        make_train_multi_step,
        make_train_step,
    )

    state = create_train_state(cfg, SEED, "speechsplit")
    host = data_loader(dataset, cfg, seed=SEED + 3)
    plans = res.plan_batches(utts, features.length.cpu().numpy(), cfg,
                             seed=SEED + 3)
    single = make_train_step(cfg)
    resident = res.make_resident_train_step(cfg, features)
    multi = make_train_multi_step(cfg)

    def host_steps(n):
        nonlocal state
        out = []
        for _ in range(n):
            state, loss = single(state, next(host))
            out.append(loss.reshape(1))
        return out

    def resident_steps(n):
        nonlocal state
        out = []
        for _ in range(n):
            state, loss = resident(state, next(plans))
            out.append(loss.reshape(1))
        return out

    def resident_call(k):
        nonlocal state
        state, losses = resident(state, next(res.stack_plans(plans, k)))
        return [losses]

    def multi_call(k):
        nonlocal state
        for _ in range(4):  # the batches the resident calls drew
            next(host)
        state, losses = multi(state, next(stack_batches(host, k)))
        return [losses]

    calls = ((("host", host_steps, 8),) if not mixed else (
        ("resident [B]", resident_steps, 2),
        ("resident [2, B]", resident_call, 2),
        ("host stacked k=4", multi_call, 4)))
    losses = []
    for what, call, steps in calls:
        torch.cuda.synchronize()
        reset_launches()
        losses += call(steps)
        torch.cuda.synchronize()
        launches = read_launches()
        for kernel, count in launches.items():
            if count != steps * per_step.get(kernel, 0):
                fail(f"train resident {what}: {kernel} launched {count} "
                     f"times in {steps} steps, expected "
                     f"{steps * per_step.get(kernel, 0)}")
    return state, torch.cat(losses)


def trajectory_distance(a, b) -> tuple[float, float]:
    """(max abs parameter difference, max rel loss difference) of two
    ``resident_trajectory`` results."""
    (sa, la), (sb, lb) = a, b
    params = max(float((p.detach() - q.detach()).abs().max())
                 for p, q in zip(sa.model.parameters(),
                                 sb.model.parameters()))
    losses = float(((la - lb).abs() / lb.abs()).max())
    return params, losses


def same_trajectory(a, b) -> bool:
    import torch

    (sa, la), (sb, lb) = a, b
    return torch.equal(la, lb) and all(
        torch.equal(p, q) for p, q in zip(sa.model.state_dict().values(),
                                          sb.model.state_dict().values()))


@contextlib.contextmanager
def cudnn_deterministic():
    """``torch.backends.cudnn.deterministic`` on, restored on exit."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def timed_solver_run(solver, rc, steps: int) -> float:
    """Steps a second of ``solver.train()`` for ``steps`` steps: wall time
    from the call to its return, then a ``torch.cuda.synchronize()``
    (the loop reads its loss at the end, its only fence)."""
    import dataclasses
    import io

    import torch

    solver.rc = dataclasses.replace(rc, num_iters=steps)
    torch.cuda.synchronize()
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        solver.train()
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - start)


def phase_train_resident(gen_per_step: dict, root: str) -> dict:
    """Device-resident training data and K steps a call on the corpus
    ``phase_prepare`` wrote under ``root`` (run after it):

    (a) ``build_resident_from_wavs`` at a bfloat16 store (one
        ``viterbi_decode`` a batch and nothing else launched) against
        ``extract_dir(compress_fetch=True)`` -> ``build_metadata`` ->
        ``build_resident`` (bfloat16) with the same seed, bit for bit;
        its seconds, MB and utterances a second beside that flow's;
    (b) ``collate_on_device`` on a float32 store of ``[prepare]``'s
        feature tree against the host ``data_loader``, bit for bit, for
        ``RESIDENT_GATHER_BATCHES`` batches;
    (c) at the default config, 8 host-batch steps against 2 resident
        steps, a ``[2, B]`` resident call and a stacked-host k=4
        ``make_train_multi_step`` call from the same state: losses and
        parameters bit for bit, every call's launches its steps x
        ``gen_per_step``; at float32 the same under
        :func:`cudnn_deterministic`, a host-loop repeat too, and the
        host loop's repeat distance without it logged;
    (d) the JAX README's recommended run, ``cli.train --wav_dir
        --data_on_device --steps_per_dispatch 10 --hparams
        RECOMMENDED_HPARAMS`` for ``RESIDENT_CLI_STEPS`` steps: one
        ``viterbi_decode`` a batch of the store, ``RESIDENT_CLI_STEPS`` x
        ``gen_per_step`` training launches, every logged loss finite, its
        checkpoint loading into ``VoiceConverter`` and converting a pair
        to finite mels; then steps a second of the Solver's loop, host and
        resident at K = 1 and 10, at the default config (B16) and the
        recommended one (B32), in turns, and the card's idle share of one
        profiled host K=1 window and one resident K=10 call at each.

    Returns row fields for the kernels' JSON: the launches of one
    recommended K=10 call and of the store's build."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from speechsplit_tpu_torch.cli import train as cli_train
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.data import (
        SpeakerDataset,
        data_loader,
        prepare,
    )
    from speechsplit_tpu_torch.data import resident as res
    from speechsplit_tpu_torch.interop import save_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter
    from speechsplit_tpu_torch.pipeline import VoiceConverter
    from speechsplit_tpu_torch.training import Solver, SolverConfig
    from speechsplit_tpu_torch.training import checkpoint as ckpt_lib

    phase_start = time.perf_counter()
    config = SpeechSplitConfig()
    wav_dir = os.path.join(root, "wavs")
    genders = dict(PREP_SPEAKERS)
    _, entries = prepare._enumerate_entries(wav_dir, genders)
    batches = -(-len(entries) // PREP_BATCH)

    # (a) the store from the wavs against the archival flow
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    store, utts = res.build_resident_from_wavs(
        wav_dir, genders, config, torch.bfloat16, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    launches = read_launches()
    if launches["viterbi_decode"] != batches or any(
            v for k, v in launches.items() if k != "viterbi_decode"):
        fail(f"train resident: build_resident_from_wavs launched "
             f"{launches}, expected {batches} viterbi_decode (one a batch)")
    store_launches = launches["viterbi_decode"]
    mel_c, f0_c = os.path.join(root, "spmel_c"), os.path.join(root,
                                                             "raptf0_c")
    torch.cuda.synchronize()
    start = time.perf_counter()
    prepare.extract_dir(wav_dir, mel_c, f0_c, genders, seed=SEED,
                        batch_size=PREP_BATCH,
                        batches_per_dispatch=PREP_DISPATCH,
                        compress_fetch=True, device="cuda")
    archival_s = time.perf_counter() - start
    meta = prepare.build_metadata(mel_c)
    start = time.perf_counter()
    disk, disk_utts = res.build_resident(
        SpeakerDataset(mel_c, f0_c, metadata=meta), config, torch.bfloat16,
        device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - start
    if utts != disk_utts:
        fail("train resident: the stores' speaker_utts differ")
    for field, a, b in zip(store._fields, store, disk):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"train resident: the store's {field} from the wavs "
                 f"differs from extract_dir -> build_resident's")
    n_utts, t_pad = store.mel.shape[0], store.mel.shape[1]
    store_mb = sum(t.numel() * t.element_size() for t in store) / 1e6
    del disk

    # (b) the gather against the host loader, a float32 store
    dataset = SpeakerDataset(os.path.join(root, "spmel"),
                             os.path.join(root, "raptf0"))
    features, f_utts = res.build_resident(dataset, config, device="cuda")
    f32_mb = sum(t.numel() * t.element_size() for t in features) / 1e6
    host = data_loader(dataset, config, seed=SEED)
    plans = res.plan_batches(f_utts, features.length.cpu().numpy(), config,
                             seed=SEED)
    for i in range(RESIDENT_GATHER_BATCHES):
        got = res.collate_on_device(config, features, next(plans))
        for field, g, w in zip(got._fields, got, next(host)):
            w = torch.from_numpy(w)
            if g.device.type != "cuda" or g.dtype != w.dtype or not (
                    torch.equal(g.cpu(), w)):
                fail(f"train resident: gathered batch {i} {field} differs "
                     f"from the host loader's")

    # (c) the steps: host against resident and k-step calls
    default_host = resident_trajectory(config, dataset, features, f_utts,
                                       gen_per_step, mixed=False)
    default_mixed = resident_trajectory(config, dataset, features, f_utts,
                                        gen_per_step, mixed=True)
    if not same_trajectory(default_host, default_mixed):
        fail(f"train resident: at the default config the resident and "
             f"k-step calls differ from the host steps: "
             f"{trajectory_distance(default_host, default_mixed)}")
    f32 = float32_config()
    with cudnn_deterministic():
        f32_host = [resident_trajectory(f32, dataset, features, f_utts,
                                        gen_per_step, mixed=False)
                    for _ in range(2)]
        f32_mixed = resident_trajectory(f32, dataset, features, f_utts,
                                        gen_per_step, mixed=True)
    for what, other in (("a repeat of the host steps", f32_host[1]),
                        ("the resident and k-step calls", f32_mixed)):
        if not same_trajectory(f32_host[0], other):
            fail(f"train resident float32 (cuDNN deterministic): {what} "
                 f"differ from the host steps: "
                 f"{trajectory_distance(f32_host[0], other)}")
    loose = resident_trajectory(f32, dataset, features, f_utts,
                                gen_per_step, mixed=False)
    loose_d = trajectory_distance(f32_host[0], loose)
    del default_host, default_mixed, f32_host, f32_mixed, loose

    # (d) the recommended run from the wav tree
    run = os.path.join(root, "recommended")
    models = os.path.join(run, "models")
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_state = cli_train.main([
            "--wav_dir", wav_dir, "--data_on_device",
            "--steps_per_dispatch", str(RESIDENT_K),
            "--hparams", RECOMMENDED_HPARAMS,
            "--num_iters", str(RESIDENT_CLI_STEPS),
            "--log_step", str(RESIDENT_CLI_LOG),
            "--model_save_step", str(RESIDENT_CLI_STEPS),
            "--sample_step", "1000", "--model_save_dir", models,
            "--log_dir", os.path.join(run, "logs"),
            "--sample_dir", os.path.join(run, "samples"),
            "--validation_path", os.path.join(root, "no_such.pkl"),
            "--spk2gen", os.path.join(root, "spk2gen.pkl"),
            "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - start
    launches = read_launches()
    for kernel, count in launches.items():
        want = (batches if kernel == "viterbi_decode"
                else RESIDENT_CLI_STEPS * gen_per_step.get(kernel, 0))
        if count != want:
            fail(f"train resident cli.train: {kernel} launched {count} "
                 f"times, expected {want} ({RESIDENT_CLI_STEPS} steps, "
                 f"{batches} store batches)")
    losses = [float(v) for v in re.findall(r"loss_id: (\S+),",
                                           out.getvalue())]
    if len(losses) != RESIDENT_CLI_STEPS // RESIDENT_CLI_LOG or not (
            np.isfinite(losses).all()) or cli_state.step != (
            RESIDENT_CLI_STEPS):
        fail(f"train resident cli.train: logged losses {losses}, step "
             f"{cli_state.step}")
    g_path = ckpt_lib.checkpoint_path(models, RESIDENT_CLI_STEPS, "G")
    p_path = os.path.join(run, "P.ckpt")
    save_reference_checkpoint(F0Converter(
        config, generator=torch.Generator().manual_seed(SEED)), p_path)
    converter = VoiceConverter.from_checkpoints(g_path, p_path,
                                                config=config, device="cuda")
    src, trg = (os.path.join(wav_dir, spk, f"{spk}_000.wav")
                for spk in ("p225", "p227"))
    mels = converter.convert_wav_files(src, trg, synthesize=False)
    if len(mels) != 7 or not all(np.isfinite(m["mel"]).all()
                                 for m in mels.values()):
        fail(f"train resident: {g_path} converts to non-finite mels")
    del converter, cli_state
    per_call = {k: launches[k] // (RESIDENT_CLI_STEPS // RESIDENT_K)
                for k in TRAINING_KERNELS}

    # readings: the four loops in turns at two configs, then profiles
    def run_config(k: int, on_device: bool, tag: str):
        return SolverConfig(
            num_iters=RESIDENT_TIMED_STEPS, log_step=RESIDENT_TIMED_STEPS,
            model_save_step=1000, sample_step=1000,
            model_save_dir=os.path.join(run, tag, "models"),
            log_dir=os.path.join(run, tag, "logs"),
            sample_dir=os.path.join(run, tag, "samples"),
            validation_path=os.path.join(root, "no_such.pkl"), seed=SEED,
            steps_per_dispatch=k, data_on_device=on_device)

    loops = (("host_k1", 1, False), (f"host_k{RESIDENT_K}", RESIDENT_K, False),
             ("resident_k1", 1, True),
             (f"resident_k{RESIDENT_K}", RESIDENT_K, True))
    readings = {}
    for label, hparams in (("default_b16", ""),
                           ("recommended_b32", RECOMMENDED_HPARAMS)):
        cfg = config.parse(hparams) if hparams else config
        solvers = {}
        with contextlib.redirect_stdout(io.StringIO()):
            for name, k, on_device in loops:
                rc = run_config(k, on_device, f"{label}_{name}")
                solvers[name] = (Solver(
                    None if on_device else data_loader(dataset, cfg,
                                                       seed=SEED),
                    rc, cfg, resident=(features, f_utts) if on_device
                    else None, device="cuda"), rc)
        rates = {name: [] for name in solvers}
        for name, (solver, rc) in solvers.items():  # warm-up, one call
            timed_solver_run(solver, rc, RESIDENT_K)
        for r in range(RESIDENT_ROUNDS):
            order = list(solvers) if r % 2 == 0 else list(solvers)[::-1]
            for name in order:
                solver, rc = solvers[name]
                rates[name].append(timed_solver_run(solver, rc,
                                                    RESIDENT_TIMED_STEPS))
        for name in ("host_k1", f"resident_k{RESIDENT_K}"):
            solver, rc = solvers[name]
            trace_dir = os.path.join(run, f"{label}_{name}_trace")
            solver.rc = dataclasses.replace(
                rc, num_iters=2 * RESIDENT_K, profile_dir=trace_dir,
                profile_start=RESIDENT_K, profile_steps=RESIDENT_K)
            torch.cuda.synchronize()
            with contextlib.redirect_stdout(io.StringIO()):
                solver.train()
            span, busy = trace_busy(os.path.join(
                trace_dir, f"trace_{2 * RESIDENT_K}.json"))
            if not busy > 0:
                fail(f"train resident {label} {name}: the profiled window "
                     f"holds no device time")
            readings[f"{label}_{name}_profiled_span_ms"] = f"{span:.4f}"
            readings[f"{label}_{name}_profiled_busy_ms"] = f"{busy:.4f}"
            readings[f"{label}_{name}_idle_share"] = (
                f"{1 - busy / span:.4f}")
        for name, values in rates.items():
            readings[f"{label}_{name}_steps_per_s"] = ",".join(
                f"{v:.3f}" for v in values)
        del solvers
    torch.cuda.empty_cache()

    log("train resident", corpus_utterances=n_utts,
        store_batches=batches, store_viterbi_launches=store_launches,
        store_equal_extract_dir_build_resident="bfloat16 bit for bit",
        build_resident_from_wavs_s=f"{build_s:.4f}",
        build_utterances_per_s=f"{n_utts / build_s:.1f}",
        build_ms_per_utterance=f"{build_s * 1e3 / n_utts:.4f}",
        extract_dir_compress_fetch_s=f"{archival_s:.4f}",
        extract_dir_ms_per_utterance=f"{archival_s * 1e3 / n_utts:.4f}",
        build_resident_upload_s=f"{upload_s:.4f}",
        store_t_pad=t_pad, store_mb_bfloat16=f"{store_mb:.3f}",
        store_mb_float32=f"{f32_mb:.3f}",
        bytes_an_utterance_bfloat16=t_pad * (config.dim_freq + 1) * 2
        + 4 * config.dim_spk_emb + 4,
        bytes_an_utterance_float32=t_pad * (config.dim_freq + 1) * 4
        + 4 * config.dim_spk_emb + 4,
        bytes_note="every row holds T_pad = longest + max_len_pad frames",
        gather_batches=RESIDENT_GATHER_BATCHES,
        gather_equal_host_loader="bit for bit",
        default_steps_equal="bit for bit (losses, parameters)",
        float32_steps_equal="bit for bit under cudnn.deterministic "
        "(losses, parameters; a host repeat too)",
        float32_repeat_without_deterministic_params_abs_diff=(
            f"{loose_d[0]:.3g}"),
        float32_repeat_without_deterministic_loss_rel_diff=(
            f"{loose_d[1]:.3g}"),
        launches_a_step=json.dumps(gen_per_step).replace(" ", ""),
        cli_steps=RESIDENT_CLI_STEPS, cli_k=RESIDENT_K,
        cli_hparams=RECOMMENDED_HPARAMS, cli_s=f"{cli_s:.4f}",
        cli_losses=",".join(f"{v:.6f}" for v in losses),
        cli_checkpoint=f"{RESIDENT_CLI_STEPS}-G.ckpt into VoiceConverter, "
        "7 finite mels",
        cli_launches_a_call=json.dumps(per_call).replace(" ", ""),
        timed_steps=RESIDENT_TIMED_STEPS, rounds=RESIDENT_ROUNDS,
        timing="Solver.train() wall to a synchronize, after one warm-up "
        "call, the four loops in turns",
        **readings, phase_s=f"{time.perf_counter() - phase_start:.1f}")
    return dict(store_launches=store_launches, per_call=per_call)


def flat_grads(model) -> dict:
    return {k: p.grad.detach().double().cpu()
            for k, p in model.named_parameters()}


def rel_l2(got: dict, want: dict) -> float:
    diff = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return (diff / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def worst_tensor(got: dict, want: dict) -> tuple:
    return max((float((got[k] - want[k]).norm() / want[k].norm()), k)
               for k in want)


def phase_train_vocoder(root: str) -> None:
    """The neural vocoder's trainer at the shipped asset's width (256
    channels, depth 6), B16, crop 64: ``cli.train_vocoder`` on the
    prepared corpus's wavs for ``VOC_ITERS`` iterations at
    ``VOC_DISPATCH`` steps a dispatch (a loss read a dispatch): every
    logged loss finite, the last dispatch's mean below the first's,
    ``{iters}-V.npz`` written, loaded by ``load_vocoder`` and turning a
    corpus mel into finite PCM16; one step on the card against the
    port's step on the CPU from the same state and crops, both through
    ``VocoderTrainer.loss_and_grad`` (the loss within ``VOC_LOSS_TOL``,
    the gradient within ``VOC_GRAD_NOISE_TIMES`` the CPU's float32
    distance from the float64 gradient on the CPU); the network's
    backward up to its head on a seeded cotangent within
    ``VOC_BACKWARD_NOISE_TIMES`` the CPU's float32 distance from
    float64, and the same backward in TF32 on the card outside that bar;
    steps a second
    of the resident path and of the host ``make_crops`` path, in turns."""
    import io

    import numpy as np
    import torch

    from speechsplit_tpu_torch.cli import train_vocoder as cli_tv
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.vocoder_neural import (
        ResidentCorpus,
        VocoderTrainer,
        init_model,
        load_vocoder,
        make_crops,
    )

    from speechsplit_tpu_torch.ops.stft import exact_float32

    wav_dir = os.path.join(root, "wavs")
    save_dir = os.path.join(root, "vocoder")
    reset_launches()
    out = io.StringIO()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state, logged = cli_tv.main([
            "--wav_dir", wav_dir, "--save_dir", save_dir,
            "--num_iters", str(VOC_ITERS), "--batch_size", str(VOC_BATCH),
            "--crop_frames", str(VOC_CROP), "--channels", "256",
            "--depth", "6", "--log_step", str(VOC_DISPATCH),
            "--save_step", str(VOC_ITERS),
            "--steps_per_dispatch", str(VOC_DISPATCH), "--device", "cuda"])
    cli_s = time.perf_counter() - start
    launches = read_launches()
    losses = [v for _, v in logged]
    if (len(logged) != VOC_ITERS // VOC_DISPATCH
            or not np.isfinite(losses).all() or not losses[-1] < losses[0]):
        fail(f"cli.train_vocoder: logged {logged}")
    if os.listdir(save_dir) != [f"{VOC_ITERS}-V.npz"]:
        fail(f"cli.train_vocoder wrote {os.listdir(save_dir)}")
    rate = re.findall(r"\(([\d.]+) steps/s\)", out.getvalue())
    config = SpeechSplitConfig()
    wavs = cli_tv._load_corpus(wav_dir, 8)
    mels = cli_tv.front_end_mels(wavs, config, torch.device("cuda"))
    vocoder = load_vocoder(os.path.join(save_dir, f"{VOC_ITERS}-V.npz"),
                           device="cuda")
    pcm = vocoder.synthesize_batch([mels[0]], pcm16=True)[0]
    if not (pcm.dtype == np.int16 and len(pcm) == (len(mels[0]) - 1) * 256
            and np.abs(pcm).max() > 0):
        fail(f"the trained vocoder's PCM16: {pcm.dtype}, {len(pcm)} samples")
    del state, vocoder

    # one step on the card against the port's step on the CPU, both as
    # VocoderTrainer.step takes it (TF32 off, the backward too): the
    # loss, and the gradient within a multiple of the CPU's float32
    # distance from the float64 gradient on the CPU. The loss's L1
    # terms, the log-magnitude clamp and the phase normalization flip
    # or amplify with rounding, so that distance is large (0.009-0.018)
    # and a TF32 backward hides under it; the network's backward up to
    # its head (layers, norms, GELUs), on one seeded cotangent, is
    # smooth: the card's within a multiple of the CPU's float32
    # distance from float64, and the same backward in TF32 outside it
    trainer = VocoderTrainer(total_steps=VOC_ITERS, device="cuda")
    cpu_trainer = VocoderTrainer(total_steps=VOC_ITERS, device="cpu")
    mel_b, wav_b = (torch.from_numpy(x) for x in make_crops(
        wavs, mels, VOC_BATCH, VOC_CROP, 256, np.random.RandomState(SEED)))

    def model_at(t, dtype=torch.float32):
        return init_model(torch.Generator().manual_seed(SEED)).to(
            t.device, dtype)

    def step_grads(t, dtype=torch.float32):
        m = model_at(t, dtype)
        return float(t.loss_and_grad(m, mel_b, wav_b)), flat_grads(m)

    cotangent = None

    def backward_grads(t, dtype=torch.float32, tf32=False):
        nonlocal cotangent
        m = model_at(t, dtype)
        with exact_float32():
            pred = m.backbone.head_out(mel_b.to(t.device, dtype))
        if cotangent is None:
            cotangent = torch.randn(pred.shape, generator=torch.Generator(
                ).manual_seed(SEED), dtype=torch.float64)
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            pred.backward(cotangent.to(t.device, dtype))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        return flat_grads(m)

    card_loss, card = step_grads(trainer)
    cpu_loss, cpu = step_grads(cpu_trainer)
    _, cpu64 = step_grads(cpu_trainer, torch.float64)
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    err = rel_l2(card, cpu)
    noise = rel_l2(cpu, cpu64)
    bar = VOC_GRAD_NOISE_TIMES * noise
    worst, worst_key = worst_tensor(card, cpu)
    del card, cpu, cpu64
    vjp = {"cpu64": backward_grads(cpu_trainer, torch.float64),
           "cpu": backward_grads(cpu_trainer),
           "card": backward_grads(trainer),
           "card_tf32": backward_grads(trainer, tf32=True)}
    vjp_noise = rel_l2(vjp["cpu"], vjp["cpu64"])
    vjp_bar = VOC_BACKWARD_NOISE_TIMES * vjp_noise
    vjp_err = rel_l2(vjp["card"], vjp["cpu"])
    vjp_tf32 = rel_l2(vjp["card_tf32"], vjp["cpu"])
    del vjp
    log("train vocoder gradient", loss_err=f"{loss_err:.3g}",
        loss_tol=VOC_LOSS_TOL, step_grad_rel_l2_vs_cpu=f"{err:.4g}",
        cpu_step_grad_rel_l2_vs_float64=f"{noise:.4g}",
        step_grad_bar=f"{bar:.4g}", worst_tensor_rel=f"{worst:.4g}",
        worst_tensor=worst_key,
        backward_rel_l2_vs_cpu=f"{vjp_err:.4g}",
        cpu_backward_rel_l2_vs_float64=f"{vjp_noise:.4g}",
        backward_bar=f"{vjp_bar:.4g}",
        tf32_backward_rel_l2_vs_cpu=f"{vjp_tf32:.4g}")
    if not (loss_err <= VOC_LOSS_TOL and err <= bar):
        fail(f"vocoder step card vs CPU: loss {loss_err}, gradient {err} "
             f"against {bar} ({VOC_GRAD_NOISE_TIMES} x the CPU's float32 "
             f"distance {noise} from its float64 gradient)")
    if not vjp_err <= vjp_bar < vjp_tf32:
        fail(f"the vocoder's backward on the card: {vjp_err} from the "
             f"CPU's, {vjp_tf32} in TF32, against {vjp_bar} "
             f"({VOC_BACKWARD_NOISE_TIMES} x the CPU's float32 distance "
             f"{vjp_noise} from float64)")

    # steps a second: resident crops against host crops, in turns (on 8
    # of the corpus's utterances: a step's cost does not depend on how
    # many there are)
    dispatch = trainer.make_resident_step(
        ResidentCorpus(wavs, mels, VOC_CROP, 256, "cuda"), VOC_BATCH,
        VOC_DISPATCH)
    state = trainer.init(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.RandomState(SEED)

    def resident():
        nonlocal state
        state, loss = dispatch(state, gen)
        return loss

    def host():
        nonlocal state
        loss = None
        for _ in range(VOC_DISPATCH):
            m, w = make_crops(wavs, mels, VOC_BATCH, VOC_CROP, 256, rng)
            state, loss = trainer.step(state, torch.from_numpy(m).to(
                "cuda"), torch.from_numpy(w).to("cuda"))
        return loss

    rounds = {"resident": [], "host": []}
    resident(), host()  # warm-up
    for _ in range(VOC_ROUNDS):
        for name, fn in (("resident", resident), ("host", host)):
            torch.cuda.synchronize()
            start = time.perf_counter()
            loss = fn()
            float(loss)
            rounds[name].append(VOC_DISPATCH / (time.perf_counter() - start))
    log("train vocoder", channels=256, depth=6, batch=VOC_BATCH,
        crop_frames=VOC_CROP, iterations=VOC_ITERS,
        steps_per_dispatch=VOC_DISPATCH,
        parameters=sum(p.numel() for p in state.model.parameters()),
        cli_s=f"{cli_s:.4f}", cli_steps_per_s=rate[-1] if rate else "none",
        dispatch_losses=",".join(f"{v:.5f}" for v in losses),
        first_mean=f"{losses[0]:.5f}", last_mean=f"{losses[-1]:.5f}",
        checkpoint=f"{VOC_ITERS}-V.npz loaded, PCM16 finite",
        viterbi_launches_front_end=launches["viterbi_decode"],
        resident_steps_per_s=",".join(f"{v:.2f}" for v in rounds[
            "resident"]),
        host_crops_steps_per_s=",".join(f"{v:.2f}" for v in rounds["host"]),
        timing=f"wall clock of one dispatch of {VOC_DISPATCH} steps, a "
        "synchronize before and a loss read after; resident and host in "
        "turns",
        tf32="off (exact_float32)")


KERNELS = {
    "bilstm_infer": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/bilstm_infer.cu",
        replaces="speechsplit_tpu/ops/pallas_lstm.py:751"),
    "multi_bilstm_infer": dict(
        route="cuda",
        source="speechsplit_tpu_torch/csrc/multi_bilstm_infer.cu",
        replaces="speechsplit_tpu/ops/pallas_multilstm.py:149"),
    "bilstm_fwd": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/bilstm_infer.cu",
        replaces="speechsplit_tpu/ops/pallas_lstm.py:625"),
    "bilstm_bwd": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/bilstm_bwd.cu",
        replaces="speechsplit_tpu/ops/pallas_lstm.py:832"),
    "multi_bilstm_fwd": dict(
        route="cuda",
        source="speechsplit_tpu_torch/csrc/multi_bilstm_infer.cu",
        replaces="speechsplit_tpu/ops/pallas_multilstm.py:113"),
    "multi_bilstm_bwd": dict(
        route="cuda",
        source="speechsplit_tpu_torch/csrc/multi_bilstm_bwd.cu",
        replaces="speechsplit_tpu/ops/pallas_multilstm.py:174"),
    "bilstm_fused_infer": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/bilstm_infer.cu",
        replaces="speechsplit_tpu/ops/pallas_lstm.py:1258"),
    "bilstm_fused_fwd": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/bilstm_infer.cu",
        replaces="speechsplit_tpu/ops/pallas_lstm.py:1222"),
    "lstm_infer": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/lstm_infer.cu",
        replaces="speechsplit_tpu/ops/pallas_lstm.py:283"),
    "lstm_fwd": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/lstm_infer.cu",
        replaces="speechsplit_tpu/ops/pallas_lstm.py:254"),
    "lstm_bwd": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/lstm_bwd.cu",
        replaces="speechsplit_tpu/ops/pallas_lstm.py:396"),
    "viterbi_decode": dict(
        route="cuda", source="speechsplit_tpu_torch/csrc/viterbi.cu",
        replaces="speechsplit_tpu/ops/pitch.py:497"),
}
TRAINING_KERNELS = ("bilstm_fwd", "bilstm_bwd", "multi_bilstm_fwd",
                    "multi_bilstm_bwd")
FUSED_KERNELS = ("bilstm_fused_infer", "bilstm_fused_fwd")
LSTM_KERNELS = ("lstm_infer", "lstm_fwd", "lstm_bwd")


# the sources whose kernels --against compares: the merged BiLSTM ones,
# the single-direction ones and the multi-stream ones (with the headers
# they include: merged_step.cuh, lane_fwd.cuh, lane_bwd.cuh)
CODEGEN_SOURCES = ("bilstm_infer", "bilstm_bwd", "lstm_infer", "lstm_bwd",
                   "multi_bilstm_infer", "multi_bilstm_bwd")
# a kernel entry of those sources, by its mangled name: the template and
# its arguments, if any (bilstm_infer_kernel<KQ, kResid>,
# bilstm_fused_kernel<KQ, kResid>, bilstm_bwd_kernel<KQ>;
# lstm_wide_step_kernel<kVec>, lstm_narrow_kernel<L>,
# lstm_fwd_narrow_kernel<L>, lstm_fwd_wide_kernel<KQ, UN> (before them
# lstm_infer_kernel<KPL, kResid>, lstm_fwd's first design),
# lstm_bwd_narrow_kernel<L>, lstm_bwd_wide_kernel<KQ, UN> (before them
# lstm_bwd_kernel<KPL>); multi_bilstm_lane_kernel<kResid>,
# multi_bilstm_infer_kernel<kResid>, which is the block plan's,
# multi_bilstm_bwd_lane_kernel, multi_bilstm_bwd_kernel, the gradient's
# block plan). Their type arguments (the residuals', W_hh's and the xp
# stream's) are float or __nv_bfloat16, a repeated one a substitution
# (S_, S0_, ...)
KERNEL_ENTRY = re.compile(
    r"((?:multi_)?(?:bi)?lstm_(?:bwd_lane|bwd_narrow|bwd_wide|fwd_narrow"
    r"|fwd_wide|infer|fused|bwd|wide_step|narrow|lane)_kernel)"
    r"(?:I((?:L[ib]\d+E|f|13__nv_bfloat16|S\d*_)+)E)?")


def _entry(match) -> str:
    """A kernel's key: its name and its template arguments, integers, f
    for float and bf16 for __nv_bfloat16, the float arguments at the end
    left out: a float32 instance keeps the key of the kernel before its
    type arguments were added (the residuals', then W_hh's and the
    stream's, all float by default), and a bfloat16-residual one keeps
    its key too (``--against`` lines up the trees' rows by key)."""
    if match[2] is None:
        return match[1]
    args = [num or ("f" if kind == "f" else "bf16")
            for num, kind in re.findall(
                r"L[ib](\d+)E|(f|13__nv_bfloat16|S\d*_)", match[2])]
    while args and args[-1] == "f":
        args.pop()
    return f"{match[1]}<{','.join(args)}>" if args else match[1]


def ptxas_rows(log_text: str) -> dict:
    """Registers, spill stores and stack frame bytes of each kernel entry
    that ``KERNEL_ENTRY`` names, from ``-Xptxas -v`` output."""
    out = {}
    key = None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            m = KERNEL_ENTRY.search(line)
            key = _entry(m) if m else None
        elif key and "spill stores" in line:
            row = out.setdefault(key, {})
            row["spill_stores"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
            row["stack_frame"] = int(
                re.search(r"(\d+) bytes stack frame", line)[1])
        elif key and "Used" in line and "registers" in line:
            out.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            key = None
    return out


def kernel_codegen(tree: str) -> dict:
    """What nvcc makes of every kernel of ``CODEGEN_SOURCES`` in ``tree``:
    registers, spill stores, stack frame bytes (local memory: an array
    the compiler could not keep in registers) and a hash of each one's
    SASS."""
    from speechsplit_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    out = {}
    for stem in CODEGEN_SOURCES:
        source = os.path.join(tree, "speechsplit_tpu_torch", "csrc",
                              f"{stem}.cu")
        with tempfile.TemporaryDirectory() as tmp:
            cubin = os.path.join(tmp, "k.cubin")
            log_text = subprocess.run(
                [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
                 cubin, source], capture_output=True, text=True,
                check=True).stderr
            for key, row in ptxas_rows(log_text).items():
                out.setdefault(key, {}).update(row)
            cuobjdump = os.path.join(os.path.dirname(_build._nvcc()),
                                     "cuobjdump")
            sass = subprocess.run([cuobjdump, "-sass", cubin],
                                  capture_output=True, text=True,
                                  check=True).stdout
        for part in sass.split("Function : ")[1:]:
            head, _, body = part.partition("\n")
            m = KERNEL_ENTRY.search(head)
            if m:
                # the instruction lines only (cuobjdump pads the listing's
                # last function with a blank line the others lack), runs
                # of spaces as one: the column padding follows the
                # longest instruction of the whole file
                code = "\n".join(" ".join(line.split())
                                 for line in body.splitlines()
                                 if line.strip().startswith("/*"))
                out.setdefault(_entry(m), {})["sass_sha256"] = (
                    hashlib.sha256(code.encode()).hexdigest()[:16])
    return out


# one process of the comparison: only phase functions and entry points
# that every tree since the single-direction kernels were ported has
AB_CHILD = """
import json, time
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.training import (
    create_train_state, make_f0_train_step, make_train_step)

c.phase_build()
out = {}
with c.strict_float32():
    for b, h in ((28, 512), (4, 256), (28, 8), (731, 256)):
        out[f"bilstm_infer B{b} H{h} ms"] = c.check_bilstm(b, h, 20)["ms"]
    for h in (512, 256, 8):
        for name, row in c.check_bilstm_train(c.TRAIN_B, h, 10).items():
            out[f"{name} B{c.TRAIN_B} H{h} ms"] = row["ms"]
    # the fused kernels at their most expensive main-path shapes
    for b, kind in ((7 * c.FUSED_PAIRS, "infer"), (c.TRAIN_B, "fwd")):
        row = c.check_fused(b, 512, 1024, kind, 10)
        out[f"bilstm_fused_{kind} B{b} I1024 H512 ms"] = row["ms"]
    big = 7 * c.refused_pairs()  # the 731-pair conversion's rows
    for h in (512, 8):
        row = c.check_lstm_infer(big, h, 2)
        out[f"lstm_infer B{big} H{h} ms"] = row["ms"]
        out[f"lstm_infer B{big} H{h} reverse ms"] = row["reverse_ms"]
    # both directions at small batches: where the trees' kernels cross
    from speechsplit_tpu_torch.ops import lstm
    for b in (28, 56, 84, 112, 224):
        xp, w, _ = c.lstm_inputs(c.T, b, 512, c.SEED + b)
        out[f"lstm_infer pair B{b} H512 ms"] = c.time_ms(
            lambda: (lstm.lstm_infer_cuda(xp, w, False),
                     lstm.lstm_infer_cuda(xp, w, True)), 5)
    # the multi-stream kernels at the conversions' and train steps' shapes:
    # a wrapper call as check_multi and check_multi_train time it, and the
    # calls queued behind a spin kernel, so that they run back to back
    # (the kernels' device time, without the host's gaps)
    from speechsplit_tpu_torch.ops import multi_bilstm

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        assert not start.query(), "the spin kernel ended too early"
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def multi_args(b, hs):
        g = torch.Generator(device="cuda").manual_seed(c.SEED + b)
        dirs = [h for h in hs for _ in (0, 1)]
        return ([torch.randn(c.T, b, 4 * h, device="cuda", generator=g)
                 for h in dirs],
                [torch.randn(4 * h, h, device="cuda", generator=g)
                 * h ** -0.5 for h in dirs],
                [torch.randn(c.T, b, h, device="cuda", generator=g)
                 for h in dirs])

    # the pitch decoder at a 3 s request's, an extract_dir batch's and
    # B28 T1876's shapes
    from speechsplit_tpu_torch.ops import pitch
    vp = pitch.PitchParams()
    for b, t in ((1, 257), (16, 501), (28, 1876)):
        vf = c.viterbi_fields(b, t, vp.num_cands, c.SEED + b, "random")
        out[f"viterbi_decode B{b} T{t} device ms"] = device_ms(
            lambda: pitch.viterbi_decode(*vf, vp.freq_weight, vp.trans_cost))
    pairs = c.refused_pairs()
    for b, hs in ((28, (8, 32, 1)), (4, (32, 1)), (7 * pairs, (8, 32, 1)),
                  (pairs, (32, 1)), (13, (64, 3, 1))):
        key = f"multi_bilstm_infer B{b} H{'/'.join(map(str, hs))}"
        out[f"{key} ms"] = c.check_multi(b, hs, 20)["ms"]
        xps, ws, _ = multi_args(b, hs)
        out[f"{key} device ms"] = device_ms(
            lambda: multi_bilstm.multi_bilstm_infer_cuda(len(hs), *xps, *ws))
    # the single-direction gradient at the single-route steps' widths
    for h in (512, 256, 8):
        xp, w, dh = c.lstm_inputs(c.T, c.TRAIN_B, h, c.SEED + h)
        _, g, cc = lstm.lstm_direction_forward_reference(xp, w, False)
        out[f"lstm_bwd B{c.TRAIN_B} H{h} device ms"] = device_ms(
            lambda: lstm.lstm_backward_cuda(dh, g, cc, w, False))
    # the single-direction residual-saving forward at the same widths,
    # beside cuDNN's training forward on the same inputs
    for h in (512, 256, 8):
        xp, w, _ = c.lstm_inputs(c.T, c.TRAIN_B, h, c.SEED + h)
        out[f"lstm_fwd B{c.TRAIN_B} H{h} device ms"] = device_ms(
            lambda: lstm.lstm_forward_cuda(xp, w, False))
        # cuDNN's training forward synchronises, so its device time is
        # the profiler's: every kernel and copy of 20 calls
        yard = c.cudnn_lstm_yardstick(xp, w)
        x = xp.detach().clone().requires_grad_(True)
        yard(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                yard(x)
            torch.cuda.synchronize()
        out[f"cudnn lstm fwd B{c.TRAIN_B} H{h} device ms"] = sum(
            float(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0)))
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)) / 1e3 / 20
        del yard, x
    # lstm_fwd at H512 at the batches the single route carries past the
    # merged kernels' autograd limit: the 731-pair conversion's rows, and
    # the most both trees take (the first design's limit)
    for b in (big, 13948):
        torch.cuda.empty_cache()
        xp, w = c.lstm_inputs(c.T, b, 512, c.SEED + b)[:2]
        out[f"lstm_fwd B{b} H512 device ms"] = device_ms(
            lambda: lstm.lstm_forward_cuda(xp, w, False), 2)
        del xp, w
    torch.cuda.empty_cache()
    # content layer 1 (H8) of a train step on either route: two lstm_fwd
    # and two lstm_bwd, or bilstm_fwd and bilstm_bwd
    from speechsplit_tpu_torch.ops import bilstm
    xf, wf, dhf = c.lstm_inputs(c.T, c.TRAIN_B, 8, c.SEED + 71)
    xb, wb, dhb = c.lstm_inputs(c.T, c.TRAIN_B, 8, c.SEED + 72)
    _, _, gf, gb, cf, cb = bilstm.bilstm_forward_reference(xf, xb, wf, wb)
    out[f"content layer 1 single route B{c.TRAIN_B} device ms"] = device_ms(
        lambda: (lstm.lstm_forward_cuda(xf, wf, False),
                 lstm.lstm_forward_cuda(xb, wb, True),
                 lstm.lstm_backward_cuda(dhf, gf, cf, wf, False),
                 lstm.lstm_backward_cuda(dhb, gb, cb, wb, True)))
    out[f"content layer 1 merged route B{c.TRAIN_B} device ms"] = device_ms(
        lambda: (bilstm.bilstm_forward_cuda(xf, xb, wf, wb),
                 bilstm.bilstm_backward_cuda(dhf, dhb, gf, gb, cf, cb, wf,
                                             wb)))
    for hs in ((8, 32, 1), (32, 1)):
        widths = "/".join(map(str, hs))
        for name, row in c.check_multi_train(c.TRAIN_B, hs, 10).items():
            out[f"{name} B{c.TRAIN_B} H{widths} ms"] = row["ms"]
        n = len(hs)
        xps, ws, dhs = multi_args(c.TRAIN_B, hs)
        res = multi_bilstm.multi_bilstm_forward_reference(n, *xps, *ws)[2 * n:]
        out[f"multi_bilstm_fwd B{c.TRAIN_B} H{widths} device ms"] = device_ms(
            lambda: multi_bilstm.multi_bilstm_forward_cuda(n, *xps, *ws))
        out[f"multi_bilstm_bwd B{c.TRAIN_B} H{widths} device ms"] = device_ms(
            lambda: multi_bilstm.multi_bilstm_backward_cuda(
                n, *dhs, *res, *ws))
# the 4-pair conversion: wall time a call, and the device's busy time in
# one profiled call (kernel and copy records)
from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
gen = torch.Generator().manual_seed(c.SEED)
g_model = SpeechSplit(SpeechSplitConfig(), generator=gen).to("cuda").eval()
p_model = F0Converter(SpeechSplitConfig(), generator=gen).to("cuda").eval()
pairs = c.synthetic_pairs(SpeechSplitConfig(), 4, "cuda", c.SEED)
with c.strict_float32("timing"):
    for _ in range(3):
        convert_batched(g_model, p_model, pairs, CONDITIONS)
    samples = []
    for _ in range(20):
        torch.cuda.synchronize()
        start = time.perf_counter()
        convert_batched(g_model, p_model, pairs, CONDITIONS)
        samples.append((time.perf_counter() - start) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        convert_batched(g_model, p_model, pairs, CONDITIONS)
        torch.cuda.synchronize()
out["convert_batched 4 pairs median ms"] = float(np.median(samples))
out["convert_batched 4 pairs device busy ms"] = sum(
    float(getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0.0)))
    for e in prof.key_averages()
    if str(getattr(e, "device_type", "")).endswith("CUDA")
    and not getattr(e, "is_user_annotation", False)) / 1e3
del g_model, p_model, pairs
config = SpeechSplitConfig(residual_dtype="float32", adam_mu_dtype="float32",
                           matmul_precision="highest")
batch = c.synthetic_batch(SpeechSplitConfig(), c.SEED)
# each step on the default route and with the single-direction route
# forced (phase 14), in turns
for model, make in (("speechsplit", make_train_step),
                    ("f0_converter", make_f0_train_step)):
    step = make(config)
    with c.strict_float32("timing"):
        state = create_train_state(config, c.SEED, model)
        samples = {"default": [], "single": []}
        for r in range(17):
            for layers in ("default", "single")[::1 if r % 2 else -1]:
                with c.route(layers):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    state, _ = step(state, batch)
                    torch.cuda.synchronize()
                if r >= 5:  # after 5 warm-up steps of each
                    samples[layers].append((time.perf_counter() - start) * 1e3)
    out[f"train {model} median ms"] = float(np.median(samples["default"]))
    out[f"train {model} single route median ms"] = float(
        np.median(samples["single"]))
print("AB " + json.dumps(out), flush=True)
"""

# the large conversion in one process of a tree: P pairs (sys.argv[1])
# through that tree's convert_batched; it reports whether the call raised
PROBE_CHILD = """
import sys
import torch
import chip_smoke as c
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

c.phase_build()
config = SpeechSplitConfig()
gen = torch.Generator().manual_seed(c.SEED)
g_model = SpeechSplit(config, generator=gen).to("cuda").eval()
p_model = F0Converter(config, generator=gen).to("cuda").eval()
pairs = c.synthetic_pairs(config, int(sys.argv[1]), "cuda", c.SEED + 3)
try:
    out = convert_batched(g_model, p_model, pairs, CONDITIONS)
    torch.cuda.synchronize()
    print("PROBE completed", len(out), flush=True)
except Exception as err:  # the outcome is what the probe reports
    print("PROBE raised", type(err).__name__,
          str(err).replace(chr(10), " ")[:300], flush=True)
"""


def ab_main(other: str, rounds: int) -> int:
    """``--against DIR``: see the module docstring."""
    import numpy as np

    print(card_line(), flush=True)
    trees = {"other": os.path.abspath(other), "this": os.getcwd()}
    codegen = {}
    for label, tree in trees.items():
        if not os.path.exists(os.path.join(tree, "chip_smoke.py")):
            fail(f"{tree} is not a checkout")
        codegen[label] = kernel_codegen(tree)
        for kernel, row in sorted(codegen[label].items()):
            log(f"codegen {label}", kernel=kernel, **row)
    # the kernels of both trees, by key: the same machine code or not
    for kernel in sorted(set(codegen["this"]) | set(codegen["other"])):
        hashes = [codegen[label].get(kernel, {}).get("sass_sha256")
                  for label in ("other", "this")]
        log("codegen same", kernel=kernel,
            same_sass=None in hashes and "only_in_" + (
                "this" if hashes[0] is None else "other")
            or hashes[0] == hashes[1])
    common = sorted(set(codegen["this"]) & set(codegen["other"]))
    differ = [k for k in common if codegen["this"][k].get("sass_sha256")
              != codegen["other"][k].get("sass_sha256")]
    log("codegen summary", keys_in_both=len(common),
        same_sass=len(common) - len(differ),
        differ=",".join(differ) or "none",
        only_in_other=",".join(sorted(set(codegen["other"])
                                      - set(codegen["this"]))) or "none",
        only_in_this=len(set(codegen["this"]) - set(codegen["other"])))
    if rounds < 1:  # --rounds 0: the machine code only
        return 0
    pairs = refused_pairs()
    for label, tree in trees.items():
        proc = subprocess.run([sys.executable, "-c", PROBE_CHILD, str(pairs)],
                              cwd=tree, capture_output=True, text=True,
                              timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("PROBE ")]
        if proc.returncode or not lines:
            fail(f"{label} probe: rc {proc.returncode}\n"
                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        log(f"ab probe {label}", tree=tree, pairs=pairs,
            outcome=lines[-1][len("PROBE "):].replace(" ", "_"))
    samples = {label: [] for label in trees}
    for r in range(rounds):
        for label in ("other", "this", "this", "other"):
            proc = subprocess.run([sys.executable, "-c", AB_CHILD],
                                  cwd=trees[label], capture_output=True,
                                  text=True, timeout=900)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("AB ")]
            if proc.returncode or not lines:
                fail(f"{label} tree: rc {proc.returncode}\n"
                     f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
            samples[label].append(json.loads(lines[-1][3:]))
            log(f"ab {label}", round=r, **fmt(samples[label][-1]))
    for key in samples["this"][0]:
        got = {label: [run[key] for run in runs]
               for label, runs in samples.items()}
        log("ab median", metric=key, tree=trees["other"],
            other=f"{np.median(got['other']):.4f}",
            this=f"{np.median(got['this']):.4f}",
            other_runs=",".join(f"{v:.4f}" for v in got["other"]),
            this_runs=",".join(f"{v:.4f}" for v in got["this"]))
    return 0


# [dtype pairs]: the float32/bfloat16 sets JAX's recurrence ops take and
# JAX's stream switches. The kernels take the sets the models form; the
# ops bring every other one to them by casts (ops.bilstm.kernel_set,
# kernel_streams). The casts that round (g and c of a forward run on
# float32 residuals, dx of a gradient run on them) are held bit for bit
# against the instance that takes the set itself, on inputs whose values
# both read alike (bfloat16 values in either type); the rest only widen.
PAIR_SEED = SEED + 900
# seeds of other weights the conversion under the h switch is read at
# beside its plain call, with no bar (the bar holds at SEED's weights)
WITNESS_SEEDS = (SEED + 1, SEED + 2)
# the stream switches a generator step runs under, each at the config
# where it acts: (switch, value, label of the config)
SWITCH_STEPS = (("LAYER_VJP", "on", "default"),
                ("GRAD_STREAM_FOLLOWS_RESIDUAL", False, "default"),
                ("DH_STREAM_FOLLOWS_RESIDUAL", False, "default"),
                ("XP_STREAM_FOLLOWS_COMPUTE", False, "bf16_compute"),
                ("H_STREAM_FOLLOWS_COMPUTE", True, "bf16_compute"))


def _exact(x, dtype):
    """x's values rounded to bfloat16, held in ``dtype``: the same values
    a bfloat16 stream and a float32 one of them read."""
    import torch

    return x.to(torch.bfloat16).to(dtype).contiguous()


@contextlib.contextmanager
def switched(**settings):
    """``ops.bilstm``'s switches (the stream switches, ``LAYER_VJP``) set
    as given for the block."""
    from speechsplit_tpu_torch.ops import bilstm

    saved = {name: getattr(bilstm, name) for name in settings}
    for name, value in settings.items():
        setattr(bilstm, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(bilstm, name, value)


def _op_grads(op, inputs, dhs, settings):
    """``op``'s outputs and its inputs' gradients for cotangents ``dhs``,
    under the switches ``settings``, and the kernels it launched."""
    import torch

    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    with switched(**settings):
        reset_launches()
        outs = op(*leaves)
        grads = torch.autograd.grad(
            outs, leaves, [d.to(o.dtype) for d, o in zip(dhs, outs)])
        torch.cuda.synchronize()
    return list(outs) + list(grads), {k: v for k, v in
                                      read_launches().items() if v}


def route_row(label: str, op, inputs, twin_inputs, dhs, settings,
              rounded=()) -> dict:
    """``op`` on a set the ops bring to a kernel by a rounding cast,
    under the switches ``settings``, against the same op on the set whose
    instance takes it as it is (``twin_inputs``, the default switches),
    each output and gradient equal bit for bit at the narrower type (the
    outputs ``rounded`` at bfloat16: a float32 stream beside the twin's
    bfloat16 one widened); both timed (forward and gradient)."""
    import torch

    got, launches = _op_grads(op, inputs, dhs, settings)
    twin, twin_launches = _op_grads(op, twin_inputs, dhs, {})
    if launches != twin_launches:
        fail(f"route {label}: launches {launches}, its twin's "
             f"{twin_launches}")
    for k, (g, r) in enumerate(zip(got, twin)):
        narrow = torch.bfloat16 if k in rounded or torch.bfloat16 in (
            g.dtype, r.dtype) else torch.float32
        if g.shape != r.shape or not torch.equal(g.to(narrow), r.to(narrow)):
            bad = float((g.float() - r.float()).abs().max())
            fail(f"route {label}: output {k} differs from its twin's ({bad})")
    row = dict(twin="bit for bit",
               ms=time_ms(lambda: _op_grads(op, inputs, dhs, settings), 3),
               twin_ms=time_ms(lambda: _op_grads(op, twin_inputs, dhs, {}),
                               3),
               launches=json.dumps(launches).replace(" ", ""))
    log(f"dtype pairs route {label}", **fmt(row))
    return row


def route_rows() -> dict:
    """The rounding routes at the train shapes: the merged op at B16 T192
    H512 and the single-direction one at H512 (its wide plan) and H8
    (its narrow plan): a float32 xp beside a bfloat16 W_hh and bfloat16
    residuals (``XP_STREAM_FOLLOWS_COMPUTE=False``'s set: float32
    residuals rounded after the forward) against a bfloat16 xp of the same
    values; a float32 dh (``DH_STREAM_FOLLOWS_RESIDUAL=False``) and a
    float32 dx (``GRAD_STREAM_FOLLOWS_RESIDUAL=False``) beside bfloat16
    residuals (the float32-residual gradient on the residuals widened)
    against the default switches on a cotangent of bfloat16 values. Then
    the sets that only widen or reroute, each against its plain version:
    the fused op with W_ih and W_hh of two dtypes (the merged kernels)
    at B16 I1024 H512, and a bfloat16 multi-stream xp on both plans."""
    import torch

    from speechsplit_tpu_torch.ops import bilstm, lstm, multi_bilstm

    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(PAIR_SEED)
    for kind, h in (("merged", 512), ("single", 512), ("single", 8)):
        if kind == "merged":
            xf, xb, wf, wb = merged_inputs(T, TRAIN_B, h, PAIR_SEED + h)
            xps, ws = [xf, xb], [wf, wb]
            op = lambda *a: bilstm.bilstm_sequence(  # noqa: E731
                *a, torch.bfloat16)
        else:
            xp, w, _ = lstm_inputs(T, TRAIN_B, h, PAIR_SEED + 2 * h)
            xps, ws = [xp], [w]
            op = lambda a, b: (lstm.lstm_sequence(  # noqa: E731
                a, b, True, torch.bfloat16),)
        dhs = [_exact(torch.randn(T, TRAIN_B, h, device="cuda",
                                  generator=gen), f32) for _ in xps]
        tag = f"{kind} H{h}"
        rows[f"{tag} xp f32 W bf16"] = route_row(
            f"{tag} xp=f32,W=bf16,R=bf16", op,
            [_exact(x, f32) for x in xps] + [w.to(bf16) for w in ws],
            [_exact(x, bf16) for x in xps] + [w.to(bf16) for w in ws],
            dhs, {})
        # the outputs, then the gradients: xp's follow the h's
        xp_grads = range(len(xps), 2 * len(xps))
        for switch, rounded in (("DH_STREAM_FOLLOWS_RESIDUAL", ()),
                                ("GRAD_STREAM_FOLLOWS_RESIDUAL", xp_grads)):
            rows[f"{tag} {switch}=False"] = route_row(
                f"{tag} {switch}=False (W f32, R bf16)", op,
                xps + ws, xps + ws, dhs, {switch: False}, rounded)
    with torch.no_grad():
        args = fused_inputs(T, TRAIN_B, 512, 1024, PAIR_SEED + 3)
        for wi_dtype, w_dtype in ((f32, bf16), (bf16, f32)):
            x, wi_f, wi_b, b_f, b_b, w_f, w_b = args
            mixed = (x, wi_f.to(wi_dtype), wi_b.to(wi_dtype), b_f, b_b,
                     w_f.to(w_dtype), w_b.to(w_dtype))
            reset_launches()
            got = bilstm.bilstm_sequence_fused(*mixed)
            torch.cuda.synchronize()
            launches = {k: v for k, v in read_launches().items() if v}
            if launches != {"bilstm_infer": 1}:
                fail(f"fused op, W_ih {wi_dtype}, W_hh {w_dtype}: launches "
                     f"{launches}")
            want = bilstm.bilstm_sequence_fused_reference(
                bilstm.fused_input(x, wi_dtype), *mixed[1:])
            label = f"fused W_ih={wi_dtype},W_hh={w_dtype}".replace(
                "torch.", "")
            rows[label] = dict(**check_flips(label, got, want),
                               launches=json.dumps(launches))
            log(f"dtype pairs route {label}", **fmt(rows[label]))
        for hs in ((8, 32, 1), (8, 64, 1)):
            xps, ws = multi_inputs(T, TRAIN_B, hs, PAIR_SEED + 4)
            n = len(hs)
            got = multi_bilstm.multi_bilstm_sequence(
                n, *[_exact(x, bf16) for x in xps], *ws)
            want = multi_bilstm.multi_bilstm_sequence_reference(
                n, *[_exact(x, f32) for x in xps], *ws)
            err = abs_err(got, want)
            if not err <= KERNEL_TOL:
                fail(f"multi-stream op, bfloat16 xp {hs}: {err} from the "
                     f"plain version (tol {KERNEL_TOL})")
            label = f"multi bf16 xp {hs}"
            rows[label] = dict(max_abs_err=err, tol=KERNEL_TOL)
            log(f"dtype pairs route {label}", **fmt(rows[label]))
    return rows


def switch_steps(batch) -> dict:
    """A generator train step at B16 x T192 under each of
    ``SWITCH_STEPS`` (the default config, or bfloat16 compute), against
    the plain step at the same config and switch (the Functions on their
    plain versions) at BF16_STEP_TOL (PARITY.md #10), with no plain
    version called; returns the launches of each by kernel."""
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.ops import bilstm
    from speechsplit_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    configs = {"default": SpeechSplitConfig(),
               "bf16_compute": compute_config()}
    out = {}
    for name, value, label in SWITCH_STEPS:
        config = configs[label]
        with switched(**{name: value}):
            plain = create_train_state(config, SEED, "speechsplit")
            with plain_training_kernels():
                plain, plain_loss = make_train_step(config)(plain, batch)
            plain_grads = grads_of(plain.model)
            del plain
            run = create_train_state(config, SEED, "speechsplit")
            layer_calls = []
            real = bilstm.BiLSTMLayerFunction.apply
            bilstm.BiLSTMLayerFunction.apply = (
                lambda *a: layer_calls.append(1) or real(*a))
            torch.cuda.synchronize()
            reset_launches()
            try:
                with plain_calls() as called:
                    run, loss = make_train_step(config)(run, batch)
                torch.cuda.synchronize()
            finally:
                del bilstm.BiLSTMLayerFunction.apply  # Function.apply again
            launches = {k: v for k, v in read_launches().items() if v}
        if called:
            fail(f"step under {name}={value}: plain versions called "
                 f"{sorted(set(called))}")
        if (name == "LAYER_VJP") != bool(layer_calls):
            fail(f"step under {name}={value}: {len(layer_calls)} "
                 f"bilstm_layer calls")
        if not (launches.get("bilstm_fwd") and launches.get("bilstm_bwd")):
            fail(f"step under {name}={value}: launches {launches}")
        worst, key = grad_err(grads_of(run.model), plain_grads)
        loss_err = abs(float(loss) - float(plain_loss)) / abs(
            float(plain_loss))
        if not (loss_err <= BF16_STEP_TOL and worst <= BF16_STEP_TOL):
            fail(f"step under {name}={value} vs the plain step: loss rel "
                 f"err {loss_err}, grad rel err {worst} ({key}) > "
                 f"{BF16_STEP_TOL}")
        out[f"{name}={value}"] = launches
        log("dtype pairs step", switch=f"{name}={value}", config=label,
            batch=f"B{batch.mel.shape[0]}xT{T}",
            loss_rel_err_vs_plain=f"{loss_err:.3g}",
            max_grad_rel_err_vs_plain=f"{worst:.3g}", worst_param=key,
            tol=BF16_STEP_TOL, bilstm_layer_calls=len(layer_calls),
            launches=json.dumps(launches).replace(" ", ""))
        del run
    return out


def _converted_err(result, plain) -> float:
    """The largest mel difference over the largest magnitude."""
    import numpy as np

    return max(float(np.abs(a[1] - b[1]).max()) / max(
        float(np.abs(b[1]).max()), 1e-30)
        for ra, rb in zip(result, plain) for a, b in zip(ra, rb))


def switch_convert() -> dict:
    """``convert_batched`` at 4 pairs at bfloat16 compute, under
    ``H_STREAM_FOLLOWS_COMPUTE``, through ``phase_convert_compute``'s
    seeded models: its mels equal, bit for bit, to the same call with the
    switch off (every reader of h rounds it to bfloat16 first, as JAX's
    note on the switch says), finite, of the right lengths, and within
    ``COMPUTE_PATH_TOL`` of the plain call. Then the same calls through
    models drawn from each of ``WITNESS_SEEDS``: the switched mels equal
    to the unswitched ones bit for bit, and, as a reading only (no bar),
    each against the plain call. Returns the launches of the switched
    call."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import CONDITIONS, convert_batched
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    config = compute_config()
    pairs = synthetic_pairs(SpeechSplitConfig(), 4, "cuda", SEED)
    gen = torch.Generator().manual_seed(SEED)
    base = (SpeechSplit(SpeechSplitConfig(), generator=gen),
            F0Converter(SpeechSplitConfig(), generator=gen))
    g = SpeechSplit(config).to("cuda").eval()
    p = F0Converter(config).to("cuda").eval()
    g.load_state_dict(base[0].state_dict())
    p.load_state_dict(base[1].state_dict())
    off = convert_batched(g, p, pairs, CONDITIONS)
    with switched(H_STREAM_FOLLOWS_COMPUTE=True):
        torch.cuda.synchronize()
        reset_launches()
        result = convert_batched(g, p, pairs, CONDITIONS)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_launches().items() if v}
        with plain_kernels():
            plain = convert_batched(g, p, pairs, CONDITIONS)
    if counts != {"bilstm_infer": 6, "multi_bilstm_infer": 2}:
        fail(f"convert_batched under H_STREAM_FOLLOWS_COMPUTE: {counts}")
    if not all(np.array_equal(a[1], b[1])
               for ra, rb in zip(result, off) for a, b in zip(ra, rb)):
        fail("convert_batched under H_STREAM_FOLLOWS_COMPUTE: mels differ "
             "from the call with the switch off")
    check_conversions(config, pairs, result)
    err = _converted_err(result, plain)
    if not err <= COMPUTE_PATH_TOL:
        fail(f"convert_batched under H_STREAM_FOLLOWS_COMPUTE vs plain: "
             f"{err} of the largest magnitude")
    readings = {}
    for seed in WITNESS_SEEDS:
        gen = torch.Generator().manual_seed(seed)
        g = SpeechSplit(config, generator=gen).to("cuda").eval()
        p = F0Converter(config, generator=gen).to("cuda").eval()
        drawn_off = convert_batched(g, p, pairs, CONDITIONS)
        with switched(H_STREAM_FOLLOWS_COMPUTE=True):
            drawn_on = convert_batched(g, p, pairs, CONDITIONS)
        if not all(np.array_equal(a[1], b[1]) for ra, rb in zip(
                drawn_on, drawn_off) for a, b in zip(ra, rb)):
            fail(f"convert_batched under H_STREAM_FOLLOWS_COMPUTE, weights "
                 f"of seed {seed}: mels differ from the switch off")
        with plain_kernels():
            drawn_plain = convert_batched(g, p, pairs, CONDITIONS)
        # the switched call's equals it (checked above)
        readings[f"seed_{seed}_vs_plain"] = (
            f"{_converted_err(drawn_off, drawn_plain):.4g}")
    log("dtype pairs convert", pairs=4, config="bf16_compute",
        switch="H_STREAM_FOLLOWS_COMPUTE=True",
        mels_vs_switch_off="bit for bit",
        max_abs_err_over_max_vs_plain=f"{err:.3g}", tol=COMPUTE_PATH_TOL,
        launches=json.dumps(counts).replace(" ", ""),
        other_weights_on_vs_off="bit for bit", **readings)
    return counts


def phase_dtype_pairs(batch) -> None:
    """[dtype pairs]: the rounding routes against their twins, bit for
    bit, and the rerouted and widened sets against their plain versions
    (:func:`route_rows`); five generator steps under the switches and a
    conversion under the h switch, each against its plain call. No
    kernel instance is new: every set and switch setting runs on the
    instances the earlier phases hold against their plain versions."""
    start = time.perf_counter()
    with strict_float32("dtype pairs"):
        rows = route_rows()
    checked = time.perf_counter() - start
    steps = switch_steps(batch)
    with strict_float32("the conversion under the h switch"):
        switch_convert()
    log("dtype pairs", routes=len(rows), steps=len(steps),
        new_kernel_instances=0, routes_seconds=f"{checked:.1f}",
        seconds=f"{time.perf_counter() - start:.1f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", metavar="DIR",
                        help="compare the default path with the checkout "
                             "in DIR instead of the smoke run")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    try:
        import speechsplit_tpu_torch  # noqa: F401
    except ImportError:
        fail("run from the root of a checkout that holds "
             "speechsplit_tpu_torch/")
    if args.against:
        return ab_main(args.against, args.rounds)
    wall = time.perf_counter()
    print(card_line(), flush=True)
    phase_build()
    rows = phase_kernels()
    launches, g_model, p_model, pairs = phase_convert()
    phase_profile(g_model, p_model, pairs)
    phase_cli(g_model, p_model)
    del g_model, p_model, pairs
    rows["viterbi_decode"] = phase_viterbi()
    per_extraction, long_mel = phase_front_end()
    rows["viterbi_decode"]["launches_an_extraction"] = per_extraction
    phase_vocoder(long_mel)
    serve_launches = phase_serve()
    iir_rows = phase_iir()
    rows["viterbi_decode"]["launches_an_extraction_time_mode"] = (
        phase_front_end_time())
    decoder_launches = phase_pitch_decoders()
    rows["viterbi_decode"]["launches_a_track_pitch_call_by_option"] = (
        decoder_launches)
    phase_pitch_native()
    rows.update(phase_train_kernels())
    phase_bwd_probe()
    phase_infer_probe()
    phase_multi_probe()
    phase_multi_bwd_probe()
    phase_lstm_bwd_probe()
    phase_lstm_fwd_probe()
    gen_launches, f0_launches, state, step, batch = phase_train()
    phase_profile_train(state, step, batch)
    del state, step
    gen_per_step = {k: v for k, v in gen_launches.items() if v}
    f0_per_step = {k: v for k, v in f0_launches.items() if v}
    gen_launches, f0_launches = phase_train_default(gen_per_step,
                                                    f0_per_step, batch)
    ddp_launches = phase_ddp(gen_per_step, batch)
    phase_train_cli(gen_per_step, f0_per_step)
    phase_train_cli_default(gen_per_step, f0_per_step)
    rows.update(phase_compute_kernels())
    compute_gen, compute_f0 = phase_train_compute(gen_per_step, f0_per_step)
    phase_train_cli_default(gen_per_step, f0_per_step,
                            "compute_dtype=bfloat16,batch_size=32",
                            "bf16 compute", COMPUTE_PATH_TOL)
    compute_convert = phase_convert_compute()
    phase_serve_compute()
    phase_train_learned(gen_per_step)
    phase_train_cli_learned(gen_per_step)
    phase_convert_learned()
    phase_serve_learned()
    with tempfile.TemporaryDirectory() as corpus_root:
        rows["viterbi_decode"].update(phase_prepare(gen_per_step,
                                                    corpus_root))
        resident = phase_train_resident(gen_per_step, corpus_root)
        phase_train_vocoder(corpus_root)
    rows.update(phase_fused_kernels())
    fused_convert = phase_convert_fused()
    fused_gen, fused_f0 = phase_train_fused(batch)
    rows.update(phase_block_fused_kernels())
    fused_bf16_convert = phase_convert_fused_bf16()
    fused_bf16_gen, fused_bf16_f0 = phase_train_fused_bf16(batch)
    wide = phase_wide_bottleneck(batch)
    rows.update(phase_lstm_kernels())
    large_convert = phase_convert_large()
    phase_convert_stream()
    single_gen, single_f0 = phase_train_single(batch)
    rows.update(phase_lstm_compute_kernels())
    large_compute = phase_convert_large_compute()
    single_compute_gen, single_compute_f0 = phase_train_single_compute(batch)
    phase_dtype_pairs(batch)
    log("done", seconds=f"{time.perf_counter() - wall:.1f}")
    # launches: the conversion call's for the inference kernels, one
    # default-config generator train step's for the training kernels (the
    # F0 step's beside them); the fused kernels' from the runs with fusion
    # on, the single-direction kernels' from the large conversion and the
    # steps on the single-direction route
    launches.update({k: gen_launches[k] for k in TRAINING_KERNELS})
    launches["bilstm_fused_infer"] = fused_convert["bilstm_fused_infer"]
    launches["bilstm_fused_fwd"] = fused_gen["bilstm_fused_fwd"]
    launches["lstm_infer"] = large_convert["lstm_infer"]
    # the serving path's: three requests (a 3 s pair, an 8 s pair, the
    # first again)
    launches["viterbi_decode"] = serve_launches["viterbi_decode"]
    f0_launches = {**f0_launches, "bilstm_fused_fwd": fused_f0[
        "bilstm_fused_fwd"]}
    for name in ("lstm_fwd", "lstm_bwd"):
        launches[name] = single_gen[name]
        f0_launches[name] = single_f0[name]
    # the device-resident paths: one call of the recommended run (10
    # steps, B32, bfloat16 compute) and the store's build from the wavs
    for name in TRAINING_KERNELS:
        rows[name]["launches_resident_k10_call"] = resident["per_call"][name]
        # a rank's step in [ddp] (b): two gloo ranks, 8 rows each
        rows[name]["launches_ddp_rank_step"] = ddp_launches["generator"][
            0].get(name, 0)
    rows["viterbi_decode"]["launches_resident_store_build"] = resident[
        "store_launches"]
    kernels = []
    for name, meta in KERNELS.items():
        row = dict(name=name, **meta, launches=launches[name], **rows[name])
        if name in TRAINING_KERNELS or name in (
                "bilstm_fused_fwd", "lstm_fwd", "lstm_bwd"):
            row["launches_f0_step"] = f0_launches[name]
        kernels.append(row)
    # the bfloat16-compute instances: launches from the bfloat16-compute
    # conversions (the lean kernels; bfloat16 residuals give bfloat16 xp
    # streams) and generator steps (the training kernels; F0 step beside)
    # the single-direction instances: launches from the 731-pair
    # conversions at bfloat16 compute (lstm_infer) and the generator steps
    # on the single route (the training pair; F0 step beside)
    single_labels = {"bf16_resid": "default", "bf16_w": (
        "bf16_compute_f32_resid"), "bf16_w_bf16_resid": "bf16_compute"}
    for name, (kernel, dtypes) in COMPUTE_KERNELS.items():
        rd = "bfloat16" if name.endswith(("_bf16_xp", "_bf16_resid")) else (
            "float32")
        if kernel == "lstm_infer":
            extra = dict(launches=large_compute[rd][kernel])
        elif kernel in ("lstm_fwd", "lstm_bwd"):
            label = single_labels[name.split("/")[1]]
            extra = dict(launches=single_compute_gen[label][kernel],
                         launches_f0_step=single_compute_f0[label][kernel])
        elif kernel in TRAINING_KERNELS:
            extra = dict(launches=compute_gen[rd][kernel],
                         launches_f0_step=compute_f0[rd][kernel])
        else:
            rd = "float32" if name == "bilstm_infer/bf16_w" else "bfloat16"
            extra = dict(launches=compute_convert[rd][kernel])
        if not extra["launches"]:
            fail(f"{name}: no launch on its main path")
        kernels.append(dict(name=name, **KERNELS[kernel], **extra,
                            dtypes=dtypes, library_ms=None, **rows[name]))
    # the block plans' and the fused kernels' bfloat16 instances: launches
    # from the [wide bottleneck] phase at dim_neck_3 = WIDE_NECK (the lean
    # one from its bfloat16-compute conversion, the training pair from its
    # generator steps by precision; F0 step beside) and from the fused
    # phases at bfloat16 (the lean one from the conversion, the
    # residual-saving ones from the generator steps by precision)
    labels = {"bf16_resid": "default", "bf16_w": "bf16_compute_f32_resid",
              "bf16_w_bf16_resid": "bf16_compute"}
    for name, (kernel, dtypes, _, _) in BLOCK_FUSED_BF16_KERNELS.items():
        label = labels[name.split("/")[1].removeprefix("block_")]
        if kernel == "multi_bilstm_infer":
            extra = dict(launches=wide["convert_bf16_compute"][kernel])
        elif kernel == "bilstm_fused_infer":
            extra = dict(launches=fused_bf16_convert[kernel])
        elif kernel == "bilstm_fused_fwd":
            extra = dict(launches=fused_bf16_gen[label][kernel],
                         launches_f0_step=fused_bf16_f0[label][kernel])
        else:
            extra = dict(launches=wide["speechsplit"][label][kernel],
                         launches_f0_step=wide["f0_converter"][label][kernel])
        if not extra["launches"]:
            fail(f"{name}: no launch on its main path")
        kernels.append(dict(name=name, **KERNELS[kernel], **extra,
                            dtypes=dtypes, library_ms=None, **rows[name]))
    # the IIR kernel's instances: launches from [kernel sosfilt] and
    # [kernel lfilter]'s main-path run (three zero-phase calls, two
    # launches each)
    for name, meta in IIR_KERNELS.items():
        row = dict(iir_rows[name])
        launches_iir = row.pop("main_path_launches")
        if not launches_iir:
            fail(f"{name}: no launch on its main path")
        kernels.append(dict(name=name, **meta, launches=launches_iir,
                            **row))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
