#!/usr/bin/env python3
"""Serve and train ResNet-50, train the LSTM and GRU text classifiers, the
CTC acoustic model and the word2vec N-gram model, serve a decoder LM
through the generation engine, serve ResNet-50 and the LM over RPC through
ModelServer, and train three of those models with gradient clipping,
weight decay and learning-rate schedules and the LSTM classifier with the
six other optimizers, train ResNet-50 and the LSTM classifier under AMP,
run the program verifier and the Executor's run_steps and per-op hooks
on them, train and beam-decode the Seq2Seq NMT model through While and
tensor arrays, train the models of the book chapters (digits, CIFAR,
sentiment, SRL with its CRF, the recommender), train the decoder LM and
serve what it learned, with the PyTorch/CUDA port on one GPU, run the
data-parallel steps over NCCL and the multi-device lanes on gloo ranks,
train Wide&Deep CTR locally, through parameter-server shard processes
and with its table sharded over NCCL ranks, feed bench.py's ragged LSTM
lane and an MNIST reader graph through recordio, the readers and the
double buffer, train the reference's RNN benchmark config through
paddle_trainer and the paddle.v2 spelling, serve ResNet-50 and the LSTM
classifier from torch.export artifacts in Python and from C, train
MobileNet-SSD and serve its detections, serve ResNet-50 from a fleet of
spawned replicas, serve the LM from exported phase programs, plan the
LM's placement, learn Wide&Deep online while its fleet serves, and hold
every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each of which exits non-zero on a failed check:

1. build    — compile every csrc/*.cu with nvcc, all at once; print the
              card's name and power limit, the torch and nvcc versions, the
              TF32 switches (both off: every float32 reference is full
              float32) and cuBLAS's bf16 reduced-precision reduction
              (AMP turns it off), and per kernel its registers and
              spills (all of the
              conv kernels', the others' that spill).
2. kernels  — every distinct fused conv shape of ResNet-50 at batch 8, in
              float32 and bfloat16, with and without relu: conv_affine,
              conv_bn_train and conv_bn_bwd against their plain versions;
              momentum_arena against its plain version over ResNet-50's
              trainable parameters, nesterov off and on, bitwise, then
              its call split: time, host enqueue, the host pass alone
              (kept tables and packing anew), the kernel's device time,
              and 5 samples in turns with SGD(momentum=0.9, fused=True).
              Then, in float32, conv_affine at batches 32, 8 and
              1 and the training kernels at batch 32: the outputs against
              their plain versions again, and each kernel's time per
              forward or step, its plain version's, one PyTorch library
              call computing the same function (a yardstick the port never
              calls) and the least time the card could take: the conv
              kernels' GEMMs at the rate of the tensor-core instruction
              they run (3xTF32 in float32), beside the CUDA-core bound
              (every operation at float32's rate), with conv_affine's K
              ranges per shape, the GEMM TFLOP/s achieved and the error
              margins against REL_LIMIT.
3. serving  — ResNet-50 (224x224x3, 1000 classes, softmax fetch) built with
              the port's front end, random weights from the seed, BN
              statistics overwritten so the folded affine is not trivial;
              fuse_conv_bn, save_inference_model, InferenceEngine, warmup;
              requests of batch 1, 3, 8, 32 and 40 (the last one chunks),
              each compared with the same bundle served under
              kernel_tier=torch. Each forward must launch conv_affine 49
              times and route 4 convs to the plain op chain. Latency per
              request size (median of LAT_REPS requests) and bucket-32
              images/s on both routes, and a profile of one bucket-32
              request with conv_affine's share.
4. training — ResNet-50 with mean(softmax_with_cross_entropy), fuse_conv_bn
              and Momentum(0.0125, 0.9, fused=True) at batch 32 (bench.py:217
              with its batch-256 rate of 0.1 scaled to batch 32), seeded
              weights; 5 steps on one fixed feed under kernel_tier=auto and
              under kernel_tier=torch, each from a copy of the startup
              state. Each step must launch conv_bn_train and conv_bn_bwd 49
              times each and momentum_arena once, and route 4 + 4 convs to
              the plain chain. The step-1 loss must match the plain route,
              and each parameter's step-1 gradient (each running
              statistic's change) must lie within a limit set by its own
              float32 floor, measured in the run by plain-route steps on
              the batch in permuted orders; a step with a planted fault in
              conv_bn_bwd must break those limits; the loss must fall over
              the 5 steps. Prints ms per step, images/s and peak memory for
              both routes, the relu outputs that change side between the
              routes, the losses at bench.py's lr 0.1, and a profile of one
              step.
5. lstm     — lstm_seq and lstm_seq_bwd (b 64, L 100, H 512, ragged) and
              adam_arena (bitwise) against their plain versions; times,
              lstm_seq_bwd also at the CTC model's 200 frames, and its
              three stages' shares (prologue, chain, epilogue) from the
              kernel's own clocks.
6. textcls  — bench.py:239's LSTM text classifier at its published widths,
              5 steps on both routes: 2 + 2 + 1 launches and 0 plain-routed
              LSTMs per step; step 1 on a fixed and a ragged feed held to
              the same program with the LSTM wrappers' plain versions; a
              planted dW fault must be caught; the loss must fall.
7. gru, ctc — gru_seq and gru_seq_bwd at the lane's shape (ragged), also
              measured against the same recipe in float64; ctc_alpha (from
              logp and the labels) and ctc_loss_bwd at the CTC model's
              shape, a planted fault in the forward (its skip mask
              ignored) that must be caught; times, bounds, the serial
              floors, both CTC kernels' stage shares, the first forward's
              torch glue (ctc_inputs) alone, and F.ctc_loss as a
              yardstick; gru_seq_bwd also at 200 frames, with its stages'
              shares.
8. gru cls  — bench.py:320's GRU text classifier as phase 6 runs the LSTM
              one: 2 + 2 + 1 launches and 0 plain-routed GRUs per step.
9. ctc      — tests/book/test_ocr_ctc.py's CTC acoustic model at
              DeepSpeech2's widths (161 features, hidden 512, 28 + 1
              classes, 64 utterances of 100-200 frames), 5 steps on both
              routes: 1 launch each of gru_seq, gru_seq_bwd, ctc_alpha,
              ctc_loss_bwd and adam_arena per step; step 1 held to the
              plain versions; a planted dlogits fault must be caught; then
              greedy decoding through main.clone(for_test=True) and
              edit_distance.
10. sparse   — embedding_sgd against its plain version, bitwise, at
              word2vec's table (2073 x 32, 128 Zipf-skewed ids with
              duplicates and sentinel entries: the one-launch path), at a
              CTR-scale table (a Criteo batch of 4096: one Zipf-drawn
              value of each of the 26 categorical fields from the field's
              own vocabulary, hashed into one 1 000 000 x 64 table,
              106 496 ids: the library-sort path) and in a hot-run case
              (5 000 entries of one id among 20 000 others, sentinels and
              negative ids, into the same table); an all-sentinel call is
              the identity and untouched rows stay bitwise; sgd_arena
              against its plain version, bitwise, over word2vec's dense
              parameters and ResNet-50's. Per call: the time, the host's
              enqueue, and the profiler's device time of the kernel and of
              the rest (the sort); unique rows, bounds, and w.index_add_
              and SGD(fused=True).step as yardsticks; then 5 samples of
              the call and of its yardstick, timed in turns, for the
              spread of single samples.
11. word2vec — tests/book/test_word2vec.py's N-gram model at the reference
              book test's widths (dict 2073, 4 context words, embedding 32,
              hidden 256, batch 32) with is_sparse=True and
              SGD(0.001, fused=True), Zipf-skewed ids and seeded weights;
              5 steps on one batch on both routes: 1 embedding_sgd and 1
              sgd_arena launch and 0 plain-routed updates per step; step 1
              bitwise the same program with the plain-version wrappers,
              within float32 roundings of the unmerged scatter route; rows
              absent from the batch unchanged; a planted lr fault in
              embedding_sgd must be caught; the loss must fall.
12. paged    — paged_attention against its plain version (atol 1e-5, rtol
              1e-4) at the generation lane's decode shape (8 slots, 4 heads
              of 32, blocks of 8, tables of 16: ragged lengths, idle rows,
              a multiple of the block size and a full table), at
              tests/test_paged_attention_pallas.py's three shapes, at
              lengths on, before and after the split path's partition
              boundaries (D 128, 36 and 33), and at two Llama-2-7B decodes
              (32 slots, 32 heads of 128, blocks of 16, over a fragmented
              arena: contexts drawn 1..4096, and every slot at 4096, ~4.3
              GB of arena); idle rows exact zeros; a planted scale x0.875
              must break the limit. At the lane and both Llama shapes:
              times, GB/s, bounds, nsplit and PART, launches and device
              kernels a call, and the gather +
              scaled_dot_product_attention as a yardstick.
13. generate — the decoder LM of bench.py:1931's generation lane (vocab
              64, emb 128, 4 heads, 4 layers, seeded weights) built with
              the port's front end, saved, loaded into GenerationEngine
              (8 slots, blocks of 8, 256 blocks, max_len 128) and warmed;
              the lane's 8 clients x 3 requests (252 greedy tokens)
              through ContinuousBatcher, continuous and gang, on the kernel
              route and under kernel_tier=torch: 4 paged_attention
              launches and 0 fallbacks per decode dispatch, the same
              tokens on both routes, in both modes and one request at a
              time, decode logits within 1e-4 of the largest; a
              prefix-cached and a chunked pass equal to cold. Tokens/s,
              decode ms per step, TTFT p50/p99, continuous vs gang, peak
              memory and a profile of one decode step for both routes.
14. front door — phase 3's bundle behind ModelServer (batching on) on the
              card: 8 InferClient threads x 6 requests of 1-8 images drawn
              from the seed; conv_affine bitwise at each bucket against
              the same rows inside the largest (a planted row shift must
              be caught), and the ops where a request's rows start to
              move between buckets (the bundle's forward with every op's
              output fetched); every reply bitwise its coalesced
              dispatch's rows and the in-process engine.infer of the same
              rows (bitwise unless an op starts a drift between the two
              buckets, then within SRV_REL_LIMIT), a reply with its rows
              reversed must be caught; fewer dispatches than requests, 49
              conv_affine launches a dispatch; health() and stats() plain
              JSON; latency by request size under 8 clients (100
              requests of each size: count, p50, p99, max); one client's
              lone requests bitwise on their solo bucket, the wire's bytes
              and seconds per call beside the in-process engine and phase
              3; a server without warmup whose first dispatch runs on its
              batcher's worker thread; images/s of 8 clients' batch-1
              requests with batching on and off (3-s windows, in turns);
              shutdown(drain=True) with 8 requests in flight answers all
              8. Then phase 13's LM behind a generative
              ModelServer: 8 GenClient threads x 3 greedy requests, the
              tokens equal to phase 13's, 4 paged_attention launches a
              decode dispatch, tokens/s and TTFT beside phase 13's.
15. recipes — the training front end's knobs on phases 4, 6 and 11's
              models at their widths, each on the kernel route and under
              kernel_tier=torch. ResNet-50 (batch 32) with the ImageNet
              recipe of PaddlePaddle's models repository: Momentum(0.9,
              fused=True) with L2Decay(1e-4) and piecewise_decay (phase
              4's rate, /10 at step 2, /100 at step 4): 49 + 49 + 1
              launches a step, the fetched rate the closed form's, step 1
              within float32 roundings of the recipe recomputed in
              float64 from the fetched raw gradients, the same program
              with the decay doubled caught, the loss falling. The LSTM
              classifier with GradientClipByGlobalNorm(5) and Adam(
              exponential_decay(2e-3, 2, 0.5), fused=True): 2 + 2 + 1
              launches a step, the global norm the float64 norm of the
              raw gradients, adam_arena's gradients g·min(1, 5/‖g‖).
              word2vec with the same clip through SGD(fused=True): 1 + 1
              launches, the clipped table gradient still SparseRows, rows
              absent from the batch bitwise; then Adagrad on the sparse
              table (the lazy row update, no kernel) against the same
              steps on the CPU. Each recipe's clip, decay and schedule
              ops run once more on device tensors under
              set_sync_debug_mode("error"). The six per-parameter
              optimizers 3 steps each on the LSTM classifier, step 1 of
              each update op against the same op on the CPU. Prints ms a
              step and peak memory with and without each recipe and the
              ops each adds.

16. amp     — Executor(amp=True), bench.py:3420-3439's flagship mode:
              phase 4's ResNet-50 at batch 32 with its images staged on
              the card in bfloat16, 5 steps on both routes: 49 + 49
              conv_bn_train / conv_bn_bwd launches on bfloat16 x and 1
              momentum_arena a step, every parameter, velocity and
              running statistic float32 after each step; step 1 against
              the plain route under AMP (limits from a bf16 floor of
              permuted batches), and printed beside float32 at
              tests/test_amp.py's rtol 0.05 / atol 1e-2 (a reading); every
              conv kernel call of a step and of a test-clone forward
              replayed through its plain version on the program's own
              inputs (REL_LIMIT's bfloat16 limit; conv_bn_bwd's dy zeroed
              within MASK_MARGIN of its relu); a float32 feed gives
              the same launches and loss; a step with cast_compute off
              must fail the launch check; the loss falls; the forward's
              test clone launches conv_affine 49 times on bfloat16 and
              agrees with the plain route. Then 5 kernel-route steps at
              the flagship's batch 256 (loss finite and falling, the same
              launches, ms a step, peak memory, a profiled step), phase
              6's LSTM classifier under AMP through phase 6's checks (fc
              GEMMs in bfloat16, float32 into the LSTM kernels), and
              conv_bn_train, conv_bn_bwd and conv_affine in bfloat16 at
              batches 32 and 256 against their plain versions, timed
              beside cuDNN in bfloat16 and their bounds at the bfloat16
              tensor-core rate.
17. runtime — the program verifier and the rest of the Executor, with
              verify_passes and executor_verify on: phase 4's ResNet-50
              training program (fused), phase 6's LSTM classifier and
              phase 11's word2vec rebuilt, each verified clean (with
              verify_program's and lint_program's host ms on ResNet-50);
              phase 3's bundle loaded, saved, loaded again and served
              (49 conv_affine launches, bitwise the original) and linted
              by python -m paddle_tpu_torch.tools.lint_program (exit 0);
              phase 13's LM lane served again (its tokens, 4
              paged_attention launches a decode dispatch). Under
              cudnn.deterministic, run_steps(K=5) against 5 run() calls
              from a copy of the same state, bitwise, on ResNet-50 (batch
              32), the LSTM classifier (two LoD feeds of batch 64,
              length 100) and word2vec, with phases 4, 6 and 11's
              launches a step and one verify_program call over the 5
              runs (where two run() sequences differ on the card, the
              first differing op is printed and run_steps is held to 2x
              that spread); prepare_steps + 2 run_prepared against 10
              run() calls. check_nan_inf names the fused_conv2d_bn whose
              filter holds a planted NaN (and costs this much a step);
              benchmark prints one line per op; obs_op_metrics counts 3
              steps of dispatches without a rebuild; one run()'s host time
              with a warm and a cold analysis cache.
18. seq2seq — tests/book/test_machine_translation.py's encoder-decoder at
              the book's chapter-8 widths (word vectors, encoder and
              decoder 512, dictionaries of 30000), batch 64, sources of
              10-50 words: 10 Adam steps on one batch on both routes, 1
              launch each of lstm_seq, lstm_seq_bwd, gru_seq and
              gru_seq_bwd a step and no LSTM or GRU fallback; each step's
              loss against kernel_tier=torch within phase 8's limit, the
              loss falling, the decoder's H0@GRAD (nonzero) against the
              plain route; ms a step, peak memory and a profiled step.
              Then a beam-3 decode of the 64 sources with the trained
              weights through While, gru_unit, topk, beam_search,
              batch_gather and beam_search_decode (max_length 50, cut
              from the book's 250) on both routes: a 2-level LoD of 64
              groups of 3 rows, every row starting with <s>, scores
              falling within a group, the encoder output within the
              recurrent forward's limits between the routes, the same ids
              bitwise in two runs; the best beams' agreement between the
              routes, ms a decode step and host syncs a loop iteration.
              Then tests/test_recurrent_grad.py's While training loop and
              DynamicRNN model, 3 steps on the card and on the CPU from one
              state: losses and final state within 1e-5 relative.
19. book    — the models of tests/book/'s chapters at the book's widths
              (paddle_tpu_torch.testing.models): MNIST's MLP and conv net,
              CIFAR's resnet_cifar10 (depth 32) and vgg16_bn_drop (dropout
              on), the sentiment chapter's convolution_net and
              stacked_lstm_net, SRL's db_lstm with its CRF (assumed
              conll05 dictionaries) and the recommender; 5 Adam steps on
              one synthetic batch each, on the kernel route and on
              kernel_tier=torch, under cudnn.deterministic: ms a step,
              peak memory, launches and plain-routed ops a step; then,
              with cuDNN's default algorithms, one profiled step (its busy
              share) and ms a step over 3 more. Before stacked_lstm_net trains, lstm_seq and
              lstm_seq_bwd against their plain versions (and the forward
              against float64) at its shapes: H 128, batch 64, its feed's
              lengths, each layer's startup W, at phase 5's limits.
              Checks: the loss falls; the routes within 1e-3 at every
              step; stacked_lstm_net 3 + 3 lstm_seq launches a step and
              no fallback; SRL's 8 LSTMs plain-routed (16 fallbacks a
              step: each lstm_grad replays its forward) and no launch;
              step 1 against the port on the CPU from one state (digits,
              ResNet, SRL with its CRF cost, crfw@GRAD and Viterbi paths,
              the recommender); accuracy's and chunk_eval's counts against
              numpy recounts written apart from the port, chunk_eval's run
              at one host sync; dropout on the card bitwise X * Mask with its
              keep share within 4 sigma.
20. LM train — phase 13's decoder LM (vocab 64, emb 128, 4 heads, 4
              layers) trained with next-token labels, softmax_with_cross_
              entropy and Adam(1e-3, fused=True) on 32 sequences of 128
              tokens of a noisy periodic corpus, 5 steps on both routes:
              1 adam_arena launch a step and no fallback; step-1
              gradients equal between the routes (no kernel before the
              update), the losses within 1e-4 at every step, the loss
              falling; ms a step, tokens/s, peak memory and the busy
              share of a profiled step. Then the trained test clone,
              saved with save_inference_model, served through
              GenerationEngine + ContinuousBatcher as phase 13's lane on
              both routes: 4 paged_attention launches a decode dispatch,
              the same greedy tokens on both routes.
21. multichip — through paddle_tpu_torch.parallel.launch.RankPool: the
              LM's dp step (phase 20's feed) and the reference dryrun's
              ResNet slice under dp+ZeRO-1, 2 steps each, on NCCL ranks
              over every visible card, against the same steps on one
              device (losses within 1e-5 relative, parameters within the
              limits beside DP_STEPS); 1 adam_arena launch a step on
              the LM. Then the reference's eight dryrun_multichip lanes
              (dp+ZeRO-1, dp×tp, LoD dp, ring attention, MoE, pipeline,
              dp×pp×tp, dp×sp) on 8 gloo ranks of the CPU, each line
              printed as the reference prints it, every error within
              1e-5. Every rank is joined with a timeout.
22. ctr      — Wide&Deep CTR (Cheng et al. 2016's hidden 1024/512/256)
              over phase 10's Criteo batch: is_sparse tables of
              1 000 000 x 64 (deep) and 1 000 000 x 1 (wide),
              SGD(0.05, fused=True), batch 4096, 5 steps on one batch on
              both routes: 2 embedding_sgd and 1 sgd_arena launches a step
              and no fallback, step-1 gradients equal between the routes
              within 1e-6 of the largest, the loss falling; ms a step,
              busy share, peak memory. Then the same program through
              DistributeTranspiler onto 2 pserver shard processes under
              PserverSupervisor (sync, one trainer on the card): step 1
              the local loss bitwise, 5 steps within 1e-5 relative; ms a
              step split into pull, install, step, fetch and push, and
              the bytes pushed and pulled. Then 4 async steps through
              OverlappedRemoteUpdater (the loss falls); the sharded step
              (deep_emb's columns over tp, the sparse gradients gathered
              over dp) on NCCL ranks over every visible card against one
              device; split_ids and split_selected_rows on the card
              bitwise the CPU's, at 1 host sync and 0.
23. input   — the input pipeline (paddle_tpu_torch/reader, recordio,
              dataset; the recordio backend printed). (a) bench.py:352's
              ragged LSTM lane: bench.py:238's IMDB-width classifier
              (vocab 30000, emb 128, two LSTMs of 512, batch 64, unfused
              Adam 2e-3) over RAGGED_SEQS (1152) of its 4608 sequences
              from RandomState(0), half 10-12 and half 96-100 long; flat (padded to 100) against
              bucketed (written with convert_reader_to_recordio_file, read
              with creator.recordio, bucket_by_length to [12, 100], padded
              with bucket_bound_for); each bound's batches staged with
              prepare_steps and run with run_prepared; after a warm-up
              epoch, the best of 3 epochs on the kernel route and one
              under kernel_tier=torch, ms a sample on each, the
              flat/bucketed ratio, the busy
              share of a profiled bucketed epoch; 2 + 2 lstm_seq /
              lstm_seq_bwd launches a step, no other kernel and no lstm
              fallback; the routes' epoch mean losses within 1e-2; before
              that, lstm_seq and lstm_seq_bwd against their plain versions
              at L 12 (phase 5's limits) and timed there. (b) the bucketed
              epoch one exe.run a batch, fed from host numpy and through
              reader.double_buffer onto the card: the losses bitwise, ms a
              step and busy share of each. (c) dataset.mnist.train()
              written through fluid.recordio_writer into 4 shards;
              open_files(thread_num=4) -> create_shuffle_reader ->
              create_double_buffer_reader(CUDAPlace(0)) ->
              create_multi_pass_reader(2) -> read_file trains digits_mlp
              until StopIteration: the popped tensors on the card, every
              record once a pass, the loss falling.
24. legacy  — the legacy surfaces (paddle_tpu_torch/v2, trainer,
              trainer_config_helpers). (a) benchmark/paddle/rnn/rnn.py
              (testing/legacy_lane.py) through paddle_trainer's main(argv)
              at bench.py:238's widths (vocab 30000, emb 128, two LSTMs of
              512, batch 64) over 8 batches of 100-long sequences from
              RandomState(seed), labelled by the last token's parity: the
              train job (2 passes) on both routes, the pass cost falling
              and the routes' pass costs within LEGACY_PASS_LIMIT; the
              time job (ms a batch, the busy share of a profiled step),
              the test job, checkgrad over the fc config (the 1% check),
              and the train job once as a python -m subprocess: 2 + 2
              lstm_seq / lstm_seq_bwd launches a step, no other kernel,
              no fallback. Step 1's gradients against kernel_tier=torch
              and against the plain LSTM versions within phase 5's
              limits. Readings: rnn.py's defaults (batch 128, hidden 128)
              through the time job with their fallbacks, checkgrad over
              the RNN config. (b) the same topology in the paddle.v2
              spelling through v2.SGD and an event handler, one pass:
              v2.infer on 64 samples, Parameters.to_tar -> from_tar_file
              -> Inference, and serialize_for_inference -> Inference(
              fileobj=), each bitwise the trained scope's forward. (c) the
              slice's 15 op types (lrn at AlexNet's first layer) on the
              card against the CPU, forward and grad.
25. deploy  — the deployment slice. (a) phase 3's ResNet-50 (fused,
              seeded, BN statistics overwritten) exported on the card with
              fluid.aot.export_inference_artifact (torch.export, the
              kernels as torch.library operators), loaded in a fresh
              python that imports only torch and paddle_tpu_torch, and
              served at batches 1, 8 and 32 against InferenceEngine over
              the same bundle (phase 3's limit): 49 conv_affine launches
              a forward, the graph holding 49 conv_affine calls and the 4
              plain convolutions; export s, load s, the artifact's bytes,
              latency (median of 7) beside the engine's. (b) bench.py:239's
              LSTM classifier exported with dynamic batch and length: batch
              64 at length 100 and batch 8 at length 37 through the loader
              against the Executor on the pruned program (phase 5's limit),
              2 lstm_seq launches a forward, no plain scan, a batch of 65
              refused. (c) the C examples built with gcc into build/capi:
              seq_infer's 3 rows within 1e-6 of the in-process run,
              dense_infer and multi_thread_infer (4 threads ok=1) over the
              book's digits MLP. (d) paddle_trainer --job=merge over phase
              24's rnn.py config on the card: the artifact loads, 2
              lstm_seq launches a forward. (e) memory_optimize +
              release_memory on phase 4's ResNet-50 training program at
              batch 32 under cudnn.deterministic: 3 steps bitwise the
              unoptimized program's losses, the same conv kernel launches,
              each run's peak max_memory_allocated. (f)
              fluid.profiler.cuda_profiler around one more artifact
              forward in the fresh interpreter: the chrome trace names
              conv_affine_kernel 49 times.
26. detection — MobileNet-SSD (PaddlePaddle/models fluid/object_detection/
              mobilenet_ssd.py: MobileNet v1 at scale 1.0, 300x300x3, 21
              classes, multi_box_head on six maps, 2278 priors) built with
              the port's fluid.layers. (a) 5 steps of reduce_sum(ssd_loss)
              at batch 32 with Momentum(1e-3, 0.9, fused=True) on images
              and 1-4 ground-truth boxes an image from the seed: finite
              losses, one momentum_arena launch a step; step 1's loss
              within SSD_LOSS_REL of the same program on the CPU (TF32
              off), each gradient within SSD_HEAD_REL (the head's) or
              SSD_BACK_REL (the backbone's, median SSD_BACK_MEDIAN: relu
              inputs near 0 flip with the float32 rounding) of the CPU's,
              and the float64 build's gradients on the card within
              SSD_F64_REL of the CPU's; ms a step, the busy share of a
              profiled step, peak max_memory_allocated.
              (b) the test program (softmax, detection_output with
              nms_threshold 0.45), its batch norm statistics set from one
              training-mode pass, saved with save_inference_model and
              served by InferenceEngine at batches 1 and 8: replies
              bitwise the Executor's, finite; ms a served batch (median
              of SSD_SERVE_REPS), multiclass_nms's share of it and its
              fixed-point iterations; then multiclass_nms alone at the
              batch-8 shape with the top SSD_NMS_K boxes of every class a
              staircase (each overlapping the next: the longest
              suppression chain), its ms and iterations, every other box
              of each chain kept. (c) DetectionMAP over the batch-8
              replies against the ground truth.
27. fleet   — phase 3's ResNet-50 through a ModelRegistry and spawned
              replicas, the warm cache, the tuner's conv_bn variants, the
              LM lane's KV spill tier (see phase_fleet).
28. planner, online — (a) phase 13's lane from exported phase programs:
              a first engine exports each (phase, bucket) into a cache; a
              fresh interpreter loads them (0 op-loop warmup dispatches)
              and serves the lane on the continuous and the gang route,
              tokens bitwise phase 13's, GEN_LAYERS paged_attention
              launches a decode dispatch from inside the exported decode
              program; a bit-flipped artifact is a typed reject, an
              executable swapped for one that refuses the decode feeds a
              run_failed reject and one hot recompile, both with the same
              tokens; the time to the first token of a fresh interpreter
              with and without the cache. (b) the placement planner over
              phase 20's LM step for 1 and 8 devices (FLOPs measured on
              the card), the 1-device choice applied over a one-rank NCCL
              group (3 steps bitwise the hand-built step, one adam_arena
              a step), a bundle published with plan=True whose plan a
              fresh interpreter resolves without a search. (c)
              OnlineLearningLoop over phase 22's Wide&Deep at full width
              (2 pserver shards, 2 replicas on the card, a client thread
              throughout; a shard and then a replica SIGKILLed): 0 failed
              requests, the served version never going back over 3
              versions, every freeze bitwise both shards' checkpoints at
              its round, the final version's replies against the
              trainer-side forward on its frozen parameters; steps/s, s a
              freeze, s from publish to served.

Each phase's header carries the seconds since the script started. The
last four lines of output are phase 14's summary, a JSON line listing
each kernel's numbers, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

# Published H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA
# cores, bfloat16 and TF32 on the tensor cores, and device memory
# bandwidth. "tf32x3" is float32 products run as 3xTF32 (three TF32
# products each, csrc/conv_mma.cuh): a third of TF32's 495.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# the instruction the training conv kernels' GEMMs run, per operand type
MMA_ROUTE = {"float32": "tf32x3", "bfloat16": "bfloat16"}

# max ‖kernel − plain‖∞ / ‖plain‖∞. float32: both sum the same float32
# products, in another order; with K ≤ 4608 terms that moves a sum by far
# less than 1e-4 of the largest output. bfloat16: the conv sum is rounded to
# bfloat16 before the affine and the output is stored in bfloat16, and one
# bfloat16 step is 2^-8 ≈ 3.9e-3 of a value; a different summation order can
# move a rounding by a step at each of the two roundings, so 2e-2 leaves
# room for a few steps and no more.
REL_LIMIT = {"float32": 1e-4, "bfloat16": 2e-2}

# relu masks in the kernel-vs-plain checks: where the plain pre-activation
# lies within this share of its largest magnitude of 0, dy is set to 0, so
# that neither version's mask there is decided by a rounding (the two sum
# the conv in different orders; a pre-activation within one rounding of 0
# may take the other side of the relu, which moves dbias by a whole dy term)
MASK_MARGIN = 1e-3

# phase 4, kernel route vs plain route on step 1. Loss: both compute the
# same float32 function with sums in other orders through 53 conv+BN
# layers, which moves the loss by float32 roundings (~1e-7 relative), so
# 1e-4 is loose for that and tight for a wrong kernel.
# Parameters: each trainable parameter's step-1 gradient and each running
# statistic's step-1 change, ‖Δ‖₂/‖ref‖₂, within FLOOR_FACTOR times that
# parameter's own float32 floor, and never below REL_MIN (for a floor of
# 0). The floor is the largest such spread between the plain route and the
# plain route on the same batch in FLOOR_ORDERS permuted orders, the same
# function summed in other orders. It lies far above float32's rounding:
# ResNet-50 with batch statistics amplifies a rounding through its layers,
# and a relu output within a rounding of 0 takes either side whichever
# route runs. The check's reach is shown in every run: a kernel-route step
# whose conv_bn_bwd scales one layer's dw and another's dscale by PLANTED,
# at the layers whose limits are loosest, must exceed the limits, and a
# plain-route step in a further order is printed against them.
LOSS_LIMIT, FLOOR_FACTOR, FLOOR_ORDERS, REL_MIN = 1e-4, 2.0, 3, 1e-5
PLANTED = 0.875

IMAGE, CLASSES = 224, 1000
REQUESTS = (1, 3, 8, 32, 40)
# phase 3 times this many more requests of each size on each route
LAT_REPS = 7
KERNEL_CONVS, PLAIN_CONVS = 49, 4
# phase 2 times conv_affine per forward at these batches: the largest
# serving bucket (core/flags.py), and two small ones, whose grids fill few
# of the card's SMs
AFFINE_BATCHES = (32, 8, 1)
TRAIN_BATCH, TRAIN_STEPS = 32, 5
# bench.py:217 trains with lr 0.1 at its default batch of 256; at batch 32
# that rate makes the loss on one fixed feed climb after step 2 on both
# routes alike (phase 4 prints it), so phase 4 takes the linear-scaling
# rate 0.1 * 32 / 256
BENCH_LR = 0.1
TRAIN_LR = BENCH_LR * TRAIN_BATCH / 256
KERNELS = ("conv_affine", "conv_bn_train", "conv_bn_bwd", "optimizer_arena",
           "lstm_seq", "gru_seq", "ctc", "embedding_sgd", "paged_attention")

# phases 5-6: bench.py:239's lane (benchmark/README.md:115-127)
SEQ_BATCH, SEQ_LEN, SEQ_HIDDEN, SEQ_VOCAB, SEQ_EMB = 64, 100, 512, 30000, 128
SEQ_LR, SEQ_STEPS = 2e-3, 5
# lstm_seq vs lstm_seq_torch, hs and cs each. Both sum the same exact
# bf16 x bf16 products in float32, the kernel a tensor-core sum per
# 16-deep k-step added in increasing k, the plain version in whatever order
# the library's matmul takes (the reference's MXU takes a third); neither
# order is nearer the truth. But a float32 step of difference in h_{t-1}
# moves bf16(h_{t-1}) by 2^-8 of itself now and then, every gate of its
# row moves with it, and later steps carry it on: so the carries agree to
# a few such moves, ‖Δ‖∞/‖ref‖∞ ≤ 1e-2, while such moves stay rare,
# ‖Δ‖₂/‖ref‖₂ ≤ 2e-3 (the GRU forward's limits), and the kernel's ‖Δ‖∞ to
# the same recipe in float64 must be within LSTM_F64_RATIO of the plain
# version's. On an NVIDIA H100 80GB HBM3 at 700.00 W (--seed 0, L 100):
# hs 6.75e-4 and cs 2.88e-4 of the largest, ‖Δ‖₂ 1.25e-4 and 1.15e-4; to
# float64 hs 7.00e-4 against the plain version's 5.59e-4, cs 1.12e-3
# against 1.07e-3. A forward whose W is scaled by PLANTED in the forget
# gate's columns must break them (there: hs 1.09e-1, cs 6.20e-2 of the
# largest)
LSTM_FWD_LIMIT, LSTM_FWD_L2_LIMIT, LSTM_F64_RATIO = 1e-2, 2e-3, 2.0
# lstm_seq_bwd vs lstm_seq_bwd_torch: each step's dW_t and the product part
# of dh_{t-1} are rounded to bfloat16 (the reference's vjp does so). A
# float32 rounding of difference before them carries an element across a
# bf16 rounding boundary now and then, which moves it by one bf16 step,
# 2^-8 = 3.9e-3 of itself, and a moved dh travels back through the steps
# before it. So ‖Δ‖∞/‖ref‖∞ may reach a few bf16 steps of the largest
# element (1e-2 allows ~2.5), while such elements stay rare, which
# ‖Δ‖₂/‖ref‖₂ ≤ 2e-3 holds
LSTM_BWD_LIMIT, LSTM_BWD_L2_LIMIT = 1e-2, 2e-3
# phase 6, the kernel route's step 1 against the same program with the two
# LSTM wrappers swapped for their plain versions. Loss, relative: the
# forward's carries differ from the plain version's by rare bf16(h) moves
# (phase 5), which the pooled, projected loss averages down. Gradients,
# ‖Δ‖₂/‖ref‖₂ per parameter: every gradient at or below an LSTM carries
# those moves and the LSTM backward's rare bf16 rounding moves, which
# phase 5 holds to LSTM_BWD_L2_LIMIT on each output; a permuted batch on
# the plain route moves far fewer of them (it reorders only the batch
# sums of dW), so it is no floor for this check. On an NVIDIA H100 80GB
# HBM3 at 700.00 W (--seed 0) with the tensor-core forward: loss 8.6e-8
# (fixed feed) and 0 (ragged); the largest gradient 1.04e-3 (lstm_1.w_0,
# fixed) and 4.9e-4 (ragged), within these limits, which the GRU's
# phase-8 limits would loosen for no reading. A step whose lstm_seq_bwd
# scales one dW by PLANTED must exceed the limit (there: 1.25e-1)
TEXTCLS_LOSS_LIMIT, TEXTCLS_GRAD_LIMIT = 1e-5, LSTM_BWD_L2_LIMIT

# phases 7-9: bench.py:320's GRU lane at phases 5-6's widths, and the CTC
# acoustic model of tests/book/test_ocr_ctc.py:38-50 at DeepSpeech2's
# widths: 161 features (a linear spectrogram of 20 ms windows at a 10 ms
# stride, 16 kHz), the lane's hidden 512, 28 characters (26 letters, space,
# apostrophe) plus the blank; 64 utterances of 100-200 frames (1-2 s) with
# labels of ⌈frames/8⌉..⌊frames/4⌋ characters. Adam at the lanes' 2e-3: at
# the book test's 0.01, which it takes at hidden 24, the loss swings on a
# fixed batch at these widths (402 -> 137 -> 636 -> 283 -> 242 on both
# routes, an H100 run)
CTC_BATCH, CTC_FEAT, CTC_HIDDEN, CTC_CLASSES = 64, 161, 512, 28
CTC_FRAMES, CTC_LR = (100, 200), 2e-3
# gru_seq vs gru_seq_torch. Unlike the LSTM's, a GRU step rounds a product
# of its own sums to bf16 inside the step (bf16(r ⊙ h) · W_c): where the
# two sum r's product in another float32 order, r moves by a float32 step
# now and then, that moves bf16(r ⊙ h) across a rounding boundary by 2^-8
# of itself, and the candidate of every unit moves with it; later steps
# carry it on. So the carries agree to a few such moves, ‖Δ‖∞/‖ref‖∞ ≤ 1e-2
# and ‖Δ‖₂/‖ref‖₂ ≤ 2e-3 (PERF.md §6 gives the H100 readings at L 100),
# and neither is nearer the truth: each version's ‖Δ‖∞ to the same recipe
# in float64 must be within GRU_F64_RATIO of the other's
GRU_FWD_LIMIT, GRU_FWD_L2_LIMIT, GRU_F64_RATIO = 1e-2, 2e-3, 2.0
# gru_seq_bwd vs gru_seq_bwd_torch: the LSTM backward's reasoning, with
# four bf16 roundings a step where the LSTM has two (both dh products and
# both parts of dW_t), so twice its ‖Δ‖₂ allowance
GRU_BWD_LIMIT, GRU_BWD_L2_LIMIT = 1e-2, 4e-3
# ctc_alpha vs ctc_loss_fwd_torch: the same operations in the same order
# (logaddexp as max + log1p(exp(-|d|)), each rounded), so equal to float32
# roundings of exp and log1p at most. ctc_loss_bwd vs ctc_loss_bwd_torch:
# the kernel adds each state's three cotangents and scatters the emission
# cotangents onto the classes in its own order, autograd in another, and
# the difference travels back through up to 200 steps of logaddexp
# weights: float32 roundings only, 1e-4 of the largest element
CTC_FWD_LIMIT, CTC_BWD_LIMIT = 1e-5, 1e-4
# phase 7's planted fault: csrc/ctc.cu's forward with its skip mask
# ignored, an (anchor, replacement) pair on a copy of the source; phase 1
# builds it beside the real kernels and keeps (source, library) here
CTC_PLANT = (
    "  chain_registers<K>(av, valid, skip, a0, sv, cs, CHAIN, sp);\n"
    "  __syncthreads();\n  stamp(stamps, 1);\n",
    "  chain_registers<K>(av, valid, skip, a0, sv, cs, CHAIN, sp);\n"
    "  for (int k = 0; k < K; ++k) skip[k] = false;\n"
    "  __syncthreads();\n  stamp(stamps, 1);\n")
PLANTED_CTC = []
# phases 8-9, the kernel route's step 1 against the same program with the
# GRU (and CTC) wrappers swapped for their plain versions. Both GRU
# kernels differ from their plain versions by bf16 rounding moves (above),
# the forward's now moving the activations too, so the loss may move by
# ~1e-5 and each gradient ‖Δ‖₂/‖ref‖₂ by a few 1e-3; 1e-4 and 1e-2 allow
# that, and a gradient scaled by PLANTED moves by 0.125, 12x the limit
GRU_TRAIN_LOSS_LIMIT, GRU_TRAIN_GRAD_LIMIT = 1e-4, 1e-2

# phases 10-11: tests/book/test_word2vec.py's N-gram model at the reference
# book test's published widths: a dictionary of 2073 words (PTB at
# imikolov.build_dict()'s min_word_freq 50), N 5 (4 context words),
# embedding 32, hidden 256, batch 32, SGD(0.001), is_sparse=True
W2V_DICT, W2V_N, W2V_EMB, W2V_HIDDEN, W2V_BATCH = 2073, 5, 32, 256, 32
W2V_LR, W2V_STEPS = 1e-3, 5
# phase 11 holds step 1 of the kernel route bitwise to the same program
# with the plain-version wrappers (both kernels are bitwise their plain
# versions, phase 10), and to the unmerged-scatter route within (longest
# run + 1) float32 steps of the table's largest value. On an NVIDIA H100
# 80GB HBM3 at 700.00 W (--seed 0): bitwise; 0.0 steps from the scatter
# route (limit 21, a run of 20); lr x0.875 planted in the step's
# embedding_sgd launch moved shared_w by 111.0 steps
# word ids, and each categorical field's values, are drawn with
# rank-frequency 1/rank^ZIPF_S. An assumption: Zipf's law puts word
# frequencies near exponent 1, and no source at hand gives the Criteo
# fields' value frequencies
ZIPF_S = 1.1
# phase 10's word2vec-shaped call: one step's 4 x 32 entries, W2V_SENTINELS
# of them sentinels (as padded LoD positions give)
W2V_SENTINELS = 8
# phase 10's CTR-scale call: a Criteo display-ads batch of 4096 examples,
# one value of each of its 26 categorical fields, drawn from that field's
# own vocabulary and hashed with the field's index into one table of
# 1 000 000 rows of 64 float32. The vocabularies' sizes are the Kaggle
# data's distinct values per field (C1..C26), as TorchRec's DLRM example
# passes them in --num_embeddings_per_feature
CRITEO_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                 93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652,
                 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
CTR_BATCH, CTR_ROWS, CTR_DIM = 4096, 1_000_000, 64
# phase 10's hot-run call into the CTR table: one id repeated HOT_RUN times
# (a run of dozens of the kernel's staging chunks) among HOT_OTHERS uniform
# ids, with sentinel and negative entries
HOT_RUN, HOT_OTHERS = 5000, 20000

# phases 12-13: the geometry and traffic of the reference's generation lane
# (bench.py:1931 run_generation_serving_lane): a decoder LM of vocab 64,
# emb 128, 4 heads (head dim 32), 4 layers, positions up to 256, weights
# seeded from 11; the engine at 8 decode slots, KV blocks of 8 tokens, 256
# blocks, max_len 128, one prefill bucket of 8; 8 clients of 3 requests
# each, prompt [1 + i, 2 + j, 3] and GEN_LENS[(3i + 5j) % 8] new tokens,
# greedy, no EOS: 252 tokens
GEN_VOCAB, GEN_EMB, GEN_HEADS, GEN_LAYERS, GEN_MAX_POS = 64, 128, 4, 4, 256
GEN_MAX_SEQS, GEN_BLOCK, GEN_BLOCKS, GEN_MAX_LEN = 8, 8, 256, 128
GEN_SEED, GEN_CLIENTS, GEN_PER_CLIENT = 11, 8, 3
GEN_LENS = (4, 4, 4, 4, 6, 6, 28, 28)
# the kernel against its plain version: the reference test's own tolerance
# for the Pallas kernel against its twin (the online softmax re-associates
# the float32 sums)
PA_ATOL, PA_RTOL = 1e-5, 1e-4
# phase 12's decode shape users run beside the lane's tiny one: Llama-2-7B's
# attention (32 heads of 128, Touvron et al. 2023, Table 1's family) over
# its 4096-token context, vLLM's default KV block of 16 tokens; 32 slots,
# each context drawn 1..4096, 2 of them idle
PA_SLOTS, PA_HEADS, PA_DIM, PA_BLOCK, PA_CTX = 32, 32, 128, 16, 4096
# phase 13, the kernel route's decode logits against kernel_tier=torch's on
# the same request: both run the same PyTorch ops but for the attend, which
# the kernel sums in another order (float32 roundings, phase 12); 4 layers
# with layer norms carry that to the logits, far below 1e-4 of the largest
GEN_LOGIT_LIMIT = 1e-4
# phase 13's prefix-cached and chunked passes: 8 requests of a shared
# 16-token system prompt (2 blocks) and a 4-token user suffix, 6 new
# tokens each, prefill buckets of 8 and 32; chunks of 4 tokens
GEN_SYSTEM, GEN_SUFFIX, GEN_PREFIX_NEW, GEN_CHUNK = 16, 4, 6, 4
# phase 14, the serving front door: phase 3's bundle behind ModelServer
# (batching on, the default buckets and max delay) on the card. The
# correctness run: SRV_CLIENTS client threads of SRV_PER_CLIENT requests,
# each of 1 to SRV_MAX_ROWS images drawn from --seed. The latency window:
# SRV_LAT_PER_SIZE requests of each size 1..SRV_MAX_ROWS, shuffled over
# the same clients. The batch-1 throughput: SRV_THR_ROUNDS windows of
# SRV_THR_WINDOW_S seconds for each mode, in turns. One client alone
# times (and holds bitwise) requests of SRV_WIRE_SIZES images
SRV_CLIENTS, SRV_PER_CLIENT, SRV_MAX_ROWS = 8, 6, 8
# (50 requests a size and 2-s windows: the script's time limit)
SRV_LAT_PER_SIZE = 50
SRV_THR_WINDOW_S, SRV_THR_ROUNDS = 2.0, 2
SRV_WIRE_SIZES = (1, 3, 8)
# a served reply against the in-process engine.infer of the same rows.
# Where the dispatch's bucket is the solo request's, every op sees the
# same shapes and the reply must be bitwise equal. conv_affine sums each
# output in an order set by K alone (csrc/conv_mma.cuh), so its rows do
# not depend on the bucket either: phase 14 holds that bitwise on every
# kernel-routed conv (conv_bucket_check), and finds which ops do move a
# request's rows between buckets (op_drift: on an H100 only the fc's
# GEMM, at bucket 1, where cuBLAS takes another kernel for one row).
# Across two buckets where no op starts a drift the reply must still be
# bitwise; across a drift source the plain-routed op sums in another
# float32 order, which moves a softmax reply by float32 roundings:
# phase 3's kernel-vs-plain limit, REL_LIMIT["float32"] of the largest
SRV_REL_LIMIT = REL_LIMIT["float32"]


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg):
    if msg.lstrip("\n").startswith("== phase"):
        # each phase's header carries the script's elapsed seconds
        msg = msg.replace("== phase",
                          f"[{time.perf_counter() - _T0:.1f} s] == phase", 1)
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def ptxas_summary(out):
    """One line per kernel from nvcc's -Xptxas=-v log: its name (demangled
    by c++filt where the toolkit's machine has it), registers, and spill
    stores and loads (ptxas prints them on separate lines)."""
    rows, name, spill = [], None, ""
    for line in out.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line:
            spill = line
        elif "ptxas info" in line and "Used" in line and name:
            rows.append((name, line.split(":", 1)[1].strip(), spill))
            name, spill = None, ""
    names = [r[0] for r in rows]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    if len(names) != len(rows):
        names = [r[0] for r in rows]
    return [f"{n.replace('(anonymous namespace)::', '')[:110]}: {used}; "
            f"{spill}" for n, (_, used, spill) in zip(names, rows)]


def time_ms(fn, torch, target_ms=30.0):
    """Mean device time of ``fn`` in ms: CUDA events around enough calls to
    fill ~target_ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    reps = int(min(200, max(3, target_ms / max(s.elapsed_time(e), 1e-3))))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def build_resnet50(fluid, seed):
    from paddle_tpu_torch.testing.models import resnet
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[IMAGE, IMAGE, 3])
        prob = fluid.layers.softmax(resnet(img, CLASSES))
    return main, startup, prob


def conv_key(block, op, batch):
    """(x_shape, w_shape, strides, paddings, dilations, groups, act) of a
    fused conv+bn op at ``batch``."""
    from paddle_tpu_torch.ops.conv_ops import conv_attrs
    x = (batch,) + tuple(block.var(op.input("Input")[0]).shape[1:])
    w = tuple(block.var(op.input("Filter")[0]).shape)
    strides, paddings, dilations, groups = conv_attrs(op.attr)
    return (x, w, strides, paddings, dilations, groups,
            op.attr("act", "") or "")


def fused_conv_shapes(fluid, main, batch):
    """{conv_key: count per forward} over the fused conv+bn ops of a fused
    program, at ``batch``."""
    block = main.global_block()
    shapes = {}
    for op in block.ops:
        if op.type == "fused_conv2d_bn":
            key = conv_key(block, op, batch)
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def kernel_routed(cbk, key):
    """Whether a fused conv of this conv_key launches conv_affine in a
    float32 NHWC forward (else it takes the plain chain)."""
    return cbk.supported(key[0], key[1], key[2], key[3], key[4], key[5],
                         "NHWC", "float32")


def conv_work(x, w, strides, paddings, itemsize):
    """(GEMM operations, elementwise operations, bytes) of one conv_affine
    call: the conv's multiply-adds, the affine's two operations per output
    element, and each input read once and the output written once."""
    n, h, wd, cin = x
    cout, _, kh, kw = w
    ho = (h + 2 * paddings[0] - kh) // strides[0] + 1
    wo = (wd + 2 * paddings[1] - kw) // strides[1] + 1
    m = n * ho * wo
    nbytes = (n * h * wd * cin * itemsize + cout * cin * kh * kw * 4
              + 2 * cout * 4 + m * cout * itemsize)
    return 2 * m * cout * kh * kw * cin, 2 * m * cout, nbytes


def phase_kernels(torch, fluid, seed):
    """conv_affine against its plain version on every distinct ResNet-50
    fused shape at batch 8, both dtypes and acts; then its times per
    forward at each of AFFINE_BATCHES. Returns the batch-32 sums for the
    kernels line."""
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk

    main, _, _ = build_resnet50(fluid, seed)
    fluid.fuse_conv_bn(main)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def operands(x_shape, w_shape, dtype):
        cout, cin, kh, kw = w_shape
        x = torch.randn(x_shape, generator=gen, device=dev).to(dtype)
        w = torch.randn(w_shape, generator=gen, device=dev) \
            * (2.0 / (cin * kh * kw)) ** 0.5
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        return x, w, a, b

    def rel_err(y, ref):
        y, ref = y.float(), ref.float()
        d = (y - ref).abs().max().item()
        return d / max(ref.abs().max().item(), 1e-30), d

    shapes8 = fused_conv_shapes(fluid, main, 8)
    kernel_keys = [k for k in shapes8 if kernel_routed(cbk, k)]
    n_kernel = sum(shapes8[k] for k in kernel_keys)
    n_plain = sum(shapes8.values()) - n_kernel
    if (n_kernel, n_plain) != (KERNEL_CONVS, PLAIN_CONVS):
        fail(f"ResNet-50 routes {n_kernel} convs to conv_affine and "
             f"{n_plain} to the plain chain, want {KERNEL_CONVS}/"
             f"{PLAIN_CONVS}")
    geoms = sorted({k[:4] for k in kernel_keys},
                   key=lambda g: (-g[0][1], g[1][1], g[1][0], g[2]))
    log(f"\n== phase 2: conv_affine vs conv_affine_torch, {len(geoms)} "
        f"distinct shapes, batch 8 ==")
    max_abs = 0.0
    errs = {}
    for x_shape, w_shape, strides, paddings in geoms:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for act in ("", "relu"):
                x, w, a, b = operands(x_shape, w_shape, dtype)
                y = cbk.conv_affine(x, w, a, b, strides, paddings, act)
                torch.cuda.synchronize()
                ref = cbk.conv_affine_torch(x, w, a, b, strides, paddings,
                                            act)
                if y.shape != ref.shape or y.dtype != ref.dtype:
                    fail(f"conv_affine {x_shape} {w_shape}: got "
                         f"{tuple(y.shape)}/{y.dtype}, want "
                         f"{tuple(ref.shape)}/{ref.dtype}")
                rel, d = rel_err(y, ref)
                if dtype == torch.float32:
                    max_abs = max(max_abs, d)
                key = (x_shape[1:], w_shape, strides, dname)
                errs[key] = max(errs.get(key, 0.0), rel)
                if not rel <= REL_LIMIT[dname]:
                    fail(f"conv_affine x{x_shape} w{w_shape} s{strides} "
                         f"{dname} act={act!r}: rel err {rel:.3e} > "
                         f"{REL_LIMIT[dname]:.0e}")

    totals = {}
    for batch in AFFINE_BATCHES:
        totals[batch] = t = affine_times(torch, fluid, main, batch, operands,
                                         errs)
        log(f"  per forward at batch {batch} (49 convs): kernel "
            f"{t['ms']:.3f} ms (device {t['device_ms']:.3f}, host enqueue "
            f"{t['host_ms']:.3f}), plain {t['plain_ms']:.3f} ms, cuDNN "
            f"{t['library_ms']:.3f} ms ({t['ms'] / t['library_ms']:.2f}x), "
            f"bound {t['bound_ms']:.3f} ms at the 3xTF32 GEMM rate "
            f"({100 * t['bound_ms'] / t['ms']:.1f}% of it reached; the "
            f"CUDA-core bound: {t['old_bound_ms']:.3f} ms), "
            f"{t['gemm'] / t['ms'] / 1e9:.1f} TFLOP/s of GEMM achieved")
    e32 = max(v for k, v in errs.items() if k[3] == "float32")
    e16 = max(v for k, v in errs.items() if k[3] == "bfloat16")
    log(f"  conv_affine: max float32 rel err {e32:.3e}, bfloat16 {e16:.3e} "
        f"at batch 8 (limits {REL_LIMIT['float32']:.0e}, "
        f"{REL_LIMIT['bfloat16']:.0e}: margins "
        f"{REL_LIMIT['float32'] / max(e32, 1e-30):.0f}x, "
        f"{REL_LIMIT['bfloat16'] / max(e16, 1e-30):.0f}x)")
    total = totals[32]
    total["max_abs_err"] = max(max_abs, total["max_abs_err"])
    return total


def affine_times(torch, fluid, main, batch, operands, errs):
    """conv_affine at ``batch`` in float32 over ResNet-50's kernel-routed
    shapes: each shape's output against the plain version (a failure past
    REL_LIMIT), then the kernel's, the plain version's and cuDNN's times,
    summed per forward with the bounds."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk

    log(f"\n== conv_affine times, batch {batch}, float32, per shape ==")
    log("  x[N,H,W,C] w[O,I,kh,kw] s act n/fwd | rel_err f32@8 "
        f"bf16@8 f32@{batch} | kernel_ms (device_ms host_ms) plain_ms "
        "library_ms bound_ms cuda_core_bound_ms")
    total = {"ms": 0.0, "device_ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0, "bound_ms": 0.0, "old_bound_ms": 0.0,
             "gemm": 0, "elem": 0, "bytes": 0, "max_abs_err": 0.0}
    for key, count in sorted(fused_conv_shapes(fluid, main, batch).items(),
                             key=lambda kv: (-kv[0][0][1], kv[0][1][1],
                                             kv[0][1][0], kv[0][2])):
        x_shape, w_shape, strides, paddings, _, _, act = key
        if not cbk.supported(x_shape, w_shape, strides, paddings, (1, 1), 1,
                             "NHWC", "float32"):
            continue
        x, w, a, b = operands(x_shape, w_shape, torch.float32)
        y = cbk.conv_affine(x, w, a, b, strides, paddings, act)
        torch.cuda.synchronize()
        ref = cbk.conv_affine_torch(x, w, a, b, strides, paddings, act)
        d = (y - ref).abs().max().item()
        rel = d / max(ref.abs().max().item(), 1e-30)
        total["max_abs_err"] = max(total["max_abs_err"], d)
        if not rel <= REL_LIMIT["float32"]:
            fail(f"conv_affine x{x_shape} w{w_shape} s{strides} float32 "
                 f"act={act!r}: rel err {rel:.3e} > "
                 f"{REL_LIMIT['float32']:.0e}")
        def kernel():
            return cbk.conv_affine(x, w, a, b, strides, paddings, act)

        k_ms = time_ms(kernel, torch)
        # the call's device time (every launch of its C entry) and its
        # host enqueue: where the host is slower, time_ms reads the host
        d_ms = sum(device_ms(torch, kernel, reps=10).values())
        h_ms = host_ms(torch, kernel, reps=20)
        p_ms = time_ms(lambda: cbk.conv_affine_torch(x, w, a, b, strides,
                                                     paddings, act), torch)
        xn = x.permute(0, 3, 1, 2)          # NCHW view, channels-last
        wf = w * a.view(-1, 1, 1, 1)

        def library():
            y = F.conv2d(xn, wf, b, stride=strides, padding=paddings)
            return torch.relu(y) if act == "relu" else y

        l_ms = time_ms(library, torch)
        gemm, elem, nbytes = conv_work(x_shape, w_shape, strides, paddings,
                                       4)
        bound, _by, old_bound = bn_bound_ms(gemm, elem, nbytes)
        e32 = errs[(x_shape[1:], w_shape, strides, "float32")]
        e16 = errs[(x_shape[1:], w_shape, strides, "bfloat16")]
        log(f"  {list(x_shape)} {list(w_shape)} {strides[0]} "
            f"{act or '-':4} {count} | "
            f"{e32:.2e} {e16:.2e} {rel:.2e} | {k_ms:.4f} ({d_ms:.4f} "
            f"{h_ms:.4f}) {p_ms:.4f} {l_ms:.4f} {bound:.4f} "
            f"{old_bound:.4f}")
        for field, v in (("ms", k_ms), ("device_ms", d_ms),
                         ("host_ms", h_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("bound_ms", bound),
                         ("old_bound_ms", old_bound), ("gemm", gemm),
                         ("elem", elem), ("bytes", nbytes)):
            total[field] += count * v
    total["bound_by"] = bn_bound_ms(total["gemm"], total["elem"],
                                    total["bytes"])[1]
    return total


def overwrite_bn_stats(main, scope, torch, seed):
    """Seeded non-trivial BN scale/bias/mean/variance, so the folded affine
    a = scale·rsqrt(var+eps), b = bias − mean·a is not the identity."""
    import numpy as np
    rng = np.random.RandomState(seed)
    for op in main.global_block().ops:
        if op.type not in ("batch_norm", "fused_conv2d_bn"):
            continue
        c = scope.find_var(op.input("Scale")[0]).shape[0]
        vals = {"Scale": rng.uniform(0.5, 1.0, c),
                "Bias": rng.normal(0.0, 0.1, c),
                "Mean": rng.normal(0.0, 0.1, c),
                "Variance": rng.uniform(0.5, 1.5, c)}
        for slot, v in vals.items():
            name = op.input(slot)[0]
            scope.set(name, torch.from_numpy(v.astype("float32")).to(
                scope.find_var(name).device))


def phase_serving(torch, fluid, seed, card):
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.serving import InferenceEngine

    log("\n== phase 3: ResNet-50 served through InferenceEngine ==")
    main, startup, prob = build_resnet50(fluid, seed)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    overwrite_bn_stats(main, scope, torch, seed)
    n_fused = fluid.fuse_conv_bn(main)
    if n_fused != KERNEL_CONVS + PLAIN_CONVS:
        fail(f"fuse_conv_bn fused {n_fused} chains, want 53")
    # kept for phase 14, which serves the same bundle over RPC
    d = tempfile.mkdtemp(prefix="chip-smoke-resnet-")
    fluid.io.save_inference_model(d, ["img"], [prob], exe,
                                  main_program=main, scope=scope)
    engine = InferenceEngine(d)
    ref_engine = InferenceEngine(d)
    t0 = time.perf_counter()
    engine.warmup()
    log(f"warmup of buckets {engine.buckets}: "
        f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(seed)
    feeds = {n: rng.normal(0, 1, (n, IMAGE, IMAGE, 3)).astype("float32")
             for n in REQUESTS}
    cbk.reset_launches()
    tier.reset_fallback_counts()
    replies, lat = {}, {}
    forwards = 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        replies[n], = engine.infer({"img": feeds[n]})
        lat[n] = (time.perf_counter() - t0) * 1e3
        forwards += -(-n // engine.max_batch)
    launches = cbk.launches["conv_affine"]
    fallbacks = tier.fallback_counts().get("conv_bn", 0)
    log(f"main path: {forwards} forwards, conv_affine launches {launches}, "
        f"plain-routed fused convs {fallbacks}")
    if launches != KERNEL_CONVS * forwards:
        fail(f"conv_affine launched {launches} times in {forwards} "
             f"forwards, want {KERNEL_CONVS} per forward")
    if fallbacks != PLAIN_CONVS * forwards:
        fail(f"{fallbacks} fused convs took the plain chain in {forwards} "
             f"forwards, want {PLAIN_CONVS} per forward")

    fluid.set_flags({"kernel_tier": "torch"})
    try:
        refs = {n: ref_engine.infer({"img": feeds[n]})[0] for n in REQUESTS}
    finally:
        fluid.set_flags({"kernel_tier": "auto"})
    for n in REQUESTS:
        y, ref = replies[n], refs[n]
        if y.shape != (n, CLASSES) or not np.isfinite(y).all():
            fail(f"batch {n}: reply of shape {y.shape}, finite="
                 f"{np.isfinite(y).all()}")
        if np.abs(y.sum(axis=1) - 1).max() > 1e-4:
            fail(f"batch {n}: softmax rows do not sum to 1")
        rel = np.abs(y - ref).max() / np.abs(ref).max()
        same = (y.argmax(1) == ref.argmax(1)).all()
        log(f"batch {n:3d}: {lat[n]:8.2f} ms | rel err vs kernel_tier=torch "
            f"{rel:.2e} | argmax equal {same} | top prob mean "
            f"{y.max(1).mean():.3f} | {card}")
        if not rel <= REL_LIMIT["float32"] or not same:
            fail(f"batch {n}: reply differs from the plain route "
                 f"(rel {rel:.3e}, argmax equal {same})")

    # latency per request size: LAT_REPS more requests of each size on
    # both routes, in turns, for the spread of the host-set numbers
    lat = {(n, t): [] for n in REQUESTS for t in ("auto", "torch")}
    for _ in range(LAT_REPS):
        for n in REQUESTS:
            for tier_name, eng in (("auto", engine), ("torch", ref_engine)):
                fluid.set_flags({"kernel_tier": tier_name})
                try:
                    t0 = time.perf_counter()
                    eng.infer({"img": feeds[n]})
                    lat[n, tier_name].append(
                        (time.perf_counter() - t0) * 1e3)
                finally:
                    fluid.set_flags({"kernel_tier": "auto"})
    for n in REQUESTS:
        log(f"batch {n:3d} latency over {LAT_REPS} requests, median (min-"
            "max) ms: " + ", ".join(
                f"kernel_tier={t} {sorted(v)[len(v) // 2]:.2f} "
                f"({min(v):.2f}-{max(v):.2f})"
                for t in ("auto", "torch") for v in [lat[n, t]])
            + f" | {card}")

    x32 = {"img": feeds[32]}
    for tier_name, eng in (("auto", engine), ("torch", ref_engine)):
        fluid.set_flags({"kernel_tier": tier_name})
        try:
            eng.infer(x32)
            t0 = time.perf_counter()
            reps = 10
            for _ in range(reps):
                eng.infer(x32)
            ms = (time.perf_counter() - t0) * 1e3 / reps
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
        log(f"bucket 32, kernel_tier={tier_name}: {ms:.2f} ms per request, "
            f"{32e3 / ms:.1f} images/s | {card}")
    log(f"engine stats: {json.dumps(engine.stats())}")
    profile(torch, lambda: engine.infer(x32), "bucket-32 request", card,
            groups=CONV_AFFINE_LAUNCHES)
    medians = {n: sorted(lat[n, "auto"])[LAT_REPS // 2] for n in REQUESTS}
    return launches, dict(dir=d, lat_ms=medians)


# the launches of conv_affine's C entry (float32: phase 3's route): the
# filter layout and the conv
CONV_AFFINE_LAUNCHES = {
    "conv_affine": ("taps_kernel<float, false>", "conv_affine_kernel")}
# the launches of each training conv kernel's C entry, by kernel name
# (float32: phase 4's route)
CONV_BN_LAUNCHES = {
    "conv_bn_train": ("taps_kernel<float, false>", "conv_stats_kernel",
                      "stats_finalize_kernel", "bn_apply_kernel"),
    "conv_bn_bwd": ("taps_kernel<float, true>", "fold_kernel",
                    "recompute_kernel", "grad_finalize_kernel", "dz_kernel",
                    "dw_gemm_kernel", "dw_reduce_kernel", "dx_kernel")}


def profile(torch, fn, title, card, reps=3, groups=None):
    """Where the time of ``fn`` goes: device time by kernel from
    torch.profiler over ``reps`` calls, the device's busy share of the
    host wall time, and the device kernels (launches and copies) a call.
    Returns (wall ms, device-busy ms) a call, or None without device
    time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((dev_us / 1e3 / reps, ev.count // reps, ev.key))
    if not rows:
        log("profile: torch.profiler recorded no device time "
            "(device breakdown not measured)")
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"\n== profile: {title}, {reps} calls | {card} ==")
    log(f"wall {wall_ms:.2f} ms per call, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%), idle "
        f"{100 * (1 - busy / wall_ms):.1f}%, "
        f"{sum(r[1] for r in rows)} device kernels and copies per call")
    for ms, count, name in rows[:14]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    for label, names in (groups or {}).items():
        ms = sum(r[0] for r in rows if any(n in r[2] for n in names))
        log(f"  {label}: {ms:.3f} ms of device time per call, "
            f"{100 * ms / busy:.1f}% of busy")
    return wall_ms, busy


EPS = 1e-5


def build_resnet50_train(fluid, seed, lr=TRAIN_LR, with_test=False):
    """bench.py:217 build(fuse=True) at its published widths: ResNet-50,
    mean(softmax_with_cross_entropy), fuse_conv_bn, then
    Momentum(lr, 0.9, fused=True).minimize. ``with_test`` also returns
    the forward's ``clone(for_test=True)``, taken before minimize, and the
    logits var."""
    from paddle_tpu_torch.testing.models import resnet
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[IMAGE, IMAGE, 3])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet(img, CLASSES)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, label))
        n_fused = fluid.fuse_conv_bn(main)
        if n_fused != KERNEL_CONVS + PLAIN_CONVS:
            fail(f"fuse_conv_bn fused {n_fused} chains, want 53")
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                 fused=True).minimize(loss, startup)
    if with_test:
        return main, startup, loss, test, logits
    return main, startup, loss


def bn_work(x, w, strides, paddings, itemsize, backward):
    """(GEMM operations, elementwise operations, bytes) of one
    conv_bn_train or conv_bn_bwd call. The forward: one conv (2·M·Cout·K)
    and ~6 operations per output element (statistics, normalize, relu); x
    and w read, y written. The backward: three GEMMs of the conv's size (z,
    dw, dx) and ~12 operations per output element; x, w and dy read, dx and
    dw (float32) written."""
    n, h, wd, cin = x
    cout, _, kh, kw = w
    ho = (h + 2 * paddings[0] - kh) // strides[0] + 1
    wo = (wd + 2 * paddings[1] - kw) // strides[1] + 1
    m = n * ho * wo
    gemm = 2 * m * cout * kh * kw * cin
    xb, wb, yb = n * h * wd * cin * itemsize, cout * cin * kh * kw * 4, \
        m * cout * itemsize
    if backward:
        return 3 * gemm, 12 * m * cout, 2 * xb + wb + yb + wb + 4 * cout * 4
    return gemm, 6 * m * cout, xb + wb + yb + 4 * cout * 4


def bound_ms(ops, nbytes, dtype="float32"):
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def bn_bound_ms(gemm, elem, nbytes, dtype="float32"):
    """The training conv kernels' bound: the GEMMs at the rate of the
    instruction they run (MMA_ROUTE: 3xTF32 for float32) plus the
    elementwise operations at float32's CUDA-core rate, against the bytes.
    Returns (ms, bound_by, the CUDA-core bound: every operation at
    float32's 67 TFLOP/s, the bound of the kernels' earlier fmaf loop)."""
    t_ops = (gemm / PEAK_FLOPS[MMA_ROUTE[dtype]]
             + elem / PEAK_FLOPS["float32"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            bound_ms(gemm + elem, nbytes, dtype)[0])


def phase_train_kernels(torch, fluid, seed):
    """conv_bn_train, conv_bn_bwd and momentum_arena against their plain
    versions, then their times per training step at batch 32 in float32.
    Returns {kernel: numbers for the kernels line}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    main, _, _ = build_resnet50_train(fluid, seed)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def operands(x_shape, w_shape, dtype):
        cout, cin, kh, kw = w_shape
        return (randn(x_shape).to(dtype),
                randn(w_shape, (2.0 / (cin * kh * kw)) ** 0.5),
                torch.rand(cout, generator=gen, device=dev) + 0.5,
                randn((cout,), 0.1))

    shapes8 = fused_conv_shapes(fluid, main, 8)
    geoms = sorted({k[:4] for k in shapes8 if cbk.supported(
        k[0], k[1], k[2], k[3], k[4], k[5], "NHWC", "float32")},
        key=lambda g: (-g[0][1], g[1][1], g[1][0], g[2]))
    log(f"\n== phase 2: conv_bn_train / conv_bn_bwd vs their plain "
        f"versions, {len(geoms)} distinct shapes, batch 8 ==")
    out = {k: {"max_abs_err": 0.0} for k in
           ("conv_bn_train", "conv_bn_bwd", "momentum_arena")}
    errs = {}

    def check(kernel, names, got, ref, what, dname):
        for name, g, r in zip(names, got, ref):
            if g.shape != r.shape or g.dtype != r.dtype:
                fail(f"{kernel} {what} {name}: got {tuple(g.shape)}/"
                     f"{g.dtype}, want {tuple(r.shape)}/{r.dtype}")
            d = (g.float() - r.float()).abs().max().item()
            rel = d / max(r.float().abs().max().item(), 1e-30)
            if dname == "float32":
                out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"],
                                                 d)
            key = (kernel, what[0], what[1], dname)
            errs[key] = max(errs.get(key, 0.0), rel)
            if not rel <= REL_LIMIT[dname]:
                fail(f"{kernel} {what} {dname} {name}: rel err {rel:.3e} > "
                     f"{REL_LIMIT[dname]:.0e}")

    def errs_max(kernel, dname):
        return max(v for key, v in errs.items()
                   if key[0] == kernel and key[3] == dname)

    def masked_dy(x, w, scale, bias, strides, paddings, act):
        """A random dy, zero where a relu's plain pre-activation lies within
        MASK_MARGIN of 0 (see MASK_MARGIN)."""
        y = cbk.conv_bn_train_torch(x, w, scale, bias, EPS, strides,
                                    paddings, "")[0]
        dy = randn(y.shape)
        if act == "relu":
            pre = y.float().abs()
            dy = dy * (pre > MASK_MARGIN * pre.max())
        return dy.to(x.dtype)

    def check_pair(x, w, scale, bias, dy, strides, paddings, act, dname):
        """Both training kernels against their plain versions on one set
        of operands; returns the plain forward's (mean, var)."""
        what = (tuple(x.shape), tuple(w.shape), strides)
        args = (EPS, strides, paddings, act)
        got = cbk.conv_bn_train(x, w, scale, bias, *args)
        torch.cuda.synchronize()
        ref = cbk.conv_bn_train_torch(x, w, scale, bias, *args)
        check("conv_bn_train", ("y", "mean", "var"), got, ref, what, dname)
        mean, var = ref[1], ref[2]
        got = cbk.conv_bn_bwd(x, w, dy, scale, bias, mean, var, *args)
        torch.cuda.synchronize()
        ref = cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, mean, var, *args)
        check("conv_bn_bwd", ("dx", "dw", "dscale", "dbias"), got, ref,
              what, dname)
        return mean, var

    for x_shape, w_shape, strides, paddings in geoms:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for act in ("", "relu"):
                x, w, scale, bias = operands(x_shape, w_shape, dtype)
                dy = masked_dy(x, w, scale, bias, strides, paddings, act)
                check_pair(x, w, scale, bias, dy, strides, paddings, act,
                           dname)

    params = [p for p in main.global_block().all_parameters() if p.trainable]
    log(f"\n== phase 2: momentum_arena vs momentum_arena_torch over "
        f"ResNet-50's {len(params)} trainable parameters "
        f"({sum(_numel(p.shape) for p in params)} elements), bitwise ==")
    ps = [randn(p.shape) for p in params]
    gs = [randn(p.shape) for p in params]
    vs = [randn(p.shape) for p in params]
    lr = torch.full((), 0.1, device=dev)
    for nesterov in (False, True):
        want_p, want_v = opk.momentum_arena_torch(ps, gs, vs, lr, 0.9,
                                                  nesterov)
        got_p, got_v = opk.momentum_arena([p.clone() for p in ps], gs,
                                          [v.clone() for v in vs], lr, 0.9,
                                          nesterov)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip(got_p + got_v, want_p + want_v)):
            diff = max((a - b).abs().max().item() for a, b in
                       zip(got_p + got_v, want_p + want_v))
            fail(f"momentum_arena (nesterov={nesterov}) differs from "
                 f"momentum_arena_torch: max abs {diff:.3e}, want bitwise")
        log(f"nesterov={nesterov}: bitwise equal")

    log(f"\n== conv_bn_train / conv_bn_bwd at batch {TRAIN_BATCH}, "
        "float32, per shape: outputs against the plain versions, then "
        "times ==")
    log("  x[N,H,W,C] w[O,I,kh,kw] s act n/step | rel_err f32@8 bf16@8 "
        f"f32@{TRAIN_BATCH} (train; bwd) | kernel_ms plain_ms library_ms "
        "bound_ms cuda_core_bound_ms, forward; backward")
    for k in ("conv_bn_train", "conv_bn_bwd"):
        out[k].update(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      old_bound_ms=0.0, gemm=0, elem=0, bytes=0)
    shapes32 = fused_conv_shapes(fluid, main, TRAIN_BATCH)
    for key, count in sorted(shapes32.items(),
                             key=lambda kv: (-kv[0][0][1], kv[0][1][1],
                                             kv[0][1][0], kv[0][2])):
        x_shape, w_shape, strides, paddings, _, _, act = key
        if not cbk.supported(x_shape, w_shape, strides, paddings, (1, 1), 1,
                             "NHWC", "float32"):
            continue
        x, w, scale, bias = operands(x_shape, w_shape, torch.float32)
        args = (EPS, strides, paddings, act)
        dy = masked_dy(x, w, scale, bias, strides, paddings, act)
        mean, var = check_pair(x, w, scale, bias, dy, strides, paddings, act,
                               "float32")
        rm = torch.zeros_like(scale)
        rv = torch.ones_like(scale)
        leaves = [t.detach().requires_grad_(True) for t in
                  (x.permute(0, 3, 1, 2), w, scale, bias)]

        def composite(xn, wn, sc, bi):
            y = F.batch_norm(F.conv2d(xn, wn, stride=strides,
                                      padding=paddings),
                             rm, rv, sc, bi, training=True, eps=EPS)
            return F.relu(y) if act == "relu" else y

        with torch.enable_grad():
            y_lib = composite(*leaves)
        dy_n = dy.permute(0, 3, 1, 2)
        rows = {}
        for kname, kfn, pfn, lfn in (
                ("conv_bn_train",
                 lambda: cbk.conv_bn_train(x, w, scale, bias, *args),
                 lambda: cbk.conv_bn_train_torch(x, w, scale, bias, *args),
                 lambda: composite(*[t.detach() for t in leaves])),
                ("conv_bn_bwd",
                 lambda: cbk.conv_bn_bwd(x, w, dy, scale, bias, mean, var,
                                         *args),
                 lambda: cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, mean,
                                               var, *args),
                 lambda: torch.autograd.grad(y_lib, leaves, dy_n,
                                             retain_graph=True))):
            gemm, elem, nbytes = bn_work(x_shape, w_shape, strides,
                                         paddings, 4, kname == "conv_bn_bwd")
            b_ms, _by, old_ms = bn_bound_ms(gemm, elem, nbytes)
            rows[kname] = (time_ms(kfn, torch), time_ms(pfn, torch),
                           time_ms(lfn, torch), b_ms, old_ms)
            t = out[kname]
            for field, v in zip(("ms", "plain_ms", "library_ms", "bound_ms",
                                 "old_bound_ms"), rows[kname]):
                t[field] += count * v
            t["gemm"] += count * gemm
            t["elem"] += count * elem
            t["bytes"] += count * nbytes
        x8 = (8,) + x_shape[1:]
        e = [errs.get((k, xs, w_shape, d), 0.0)
             for k in ("conv_bn_train", "conv_bn_bwd")
             for xs, d in ((x8, "float32"), (x8, "bfloat16"),
                           (x_shape, "float32"))]
        log(f"  {list(x_shape)} {list(w_shape)} {strides[0]} "
            f"{act or '-':4} {count} | {e[0]:.1e} {e[1]:.1e} {e[2]:.1e}; "
            f"{e[3]:.1e} {e[4]:.1e} {e[5]:.1e} | " + "; ".join(
                " ".join(f"{v:.4f}" for v in rows[k])
                for k in ("conv_bn_train", "conv_bn_bwd")))
    for k in ("conv_bn_train", "conv_bn_bwd"):
        t = out[k]
        t["bound_by"] = bn_bound_ms(t["gemm"], t["elem"], t["bytes"])[1]
        log(f"  per step at batch {TRAIN_BATCH} (49 convs), {k}: kernel "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, cuDNN "
            f"{t['library_ms']:.3f} ms ({t['ms'] / t['library_ms']:.2f}x), "
            f"bound {t['bound_ms']:.3f} ms at the 3xTF32 GEMM rate "
            f"({100 * t['bound_ms'] / t['ms']:.1f}% of it reached; the "
            f"CUDA-core bound: {t['old_bound_ms']:.3f} ms), "
            f"{t['gemm'] / t['ms'] / 1e9:.1f} TFLOP/s of GEMM achieved")
        e32, e16 = errs_max(k, "float32"), errs_max(k, "bfloat16")
        log(f"  {k}: max float32 rel err {e32:.3e}, bfloat16 {e16:.3e} "
            f"(limits {REL_LIMIT['float32']:.0e}, "
            f"{REL_LIMIT['bfloat16']:.0e}: margins "
            f"{REL_LIMIT['float32'] / max(e32, 1e-30):.0f}x, "
            f"{REL_LIMIT['bfloat16'] / max(e16, 1e-30):.0f}x)")

    nelem = sum(p.numel() for p in ps)
    sgd_params = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(sgd_params, gs):
        p.grad = g
    sgd = torch.optim.SGD(sgd_params, lr=0.1, momentum=0.9, fused=True)
    t = out["momentum_arena"]

    def call():
        opk.momentum_arena(ps, gs, vs, lr, 0.9, False)

    t["ms"] = time_ms(call, torch)
    t["plain_ms"] = time_ms(lambda: opk.momentum_arena_torch(
        ps, gs, vs, lr, 0.9, False), torch)
    t["library_ms"] = time_ms(sgd.step, torch)
    t["bound_ms"], t["bound_by"] = bound_ms(0, 20 * nelem)
    # the call's split: the kernel's device time (profiler) against the
    # call's, and the wrapper's host pass alone (kept tables, the grads'
    # column refilled)
    t["kernel_device_ms"], _, _ = split_device(device_ms(torch, call),
                                               "momentum_arena")
    lib_dev = sum(device_ms(torch, sgd.step).values())
    host = host_pass_ms(opk, "momentum_arena", ps, gs, [vs])
    log(f"momentum_arena per step ({len(ps)} tensors, {nelem} elements): "
        f"call {t['ms']:.4f} ms (host enqueue {host_ms(torch, call):.4f} "
        f"ms; host pass alone {host['kept']:.4f} ms kept, "
        f"{host['packed']:.4f} ms packing anew; kernel device "
        f"{t['kernel_device_ms']:.4f} ms = "
        f"{t['bound_ms'] / max(t['kernel_device_ms'], 1e-9):.1%} of the "
        f"bound), plain "
        f"{t['plain_ms']:.4f} ms, SGD(momentum=0.9, fused=True) "
        f"{t['library_ms']:.4f} ms (host enqueue "
        f"{host_ms(torch, sgd.step):.4f} ms, device {lib_dev:.4f} ms), "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    ka, la = turns_ms(torch, call, sgd.step)
    log(f"momentum_arena in turns with SGD(momentum=0.9, fused=True): per "
        f"step {samples(ka)} ms; SGD {samples(la)} ms")
    return out


def host_pass_ms(opk, name, ps, gs, state, reps=50):
    """The arena wrapper's host pass alone (``opk._tables``: the checks and
    the launch tables, no launch), ms a call on the host clock: with the
    list's tables kept, and packing anew every call."""
    dev = ps[0].device

    def tables(fresh):
        if fresh:
            opk._PACKED.pop(name, None)
        opk._tables(name, ps, gs, state, dev, opk._max_rows)

    out = {}
    for key, fresh in (("kept", False), ("packed", True)):
        tables(fresh)
        t0 = time.perf_counter()
        for _ in range(reps):
            tables(fresh)
        out[key] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def copy_scope(fluid, torch, src):
    """A scope holding a copy of every tensor of ``src``."""
    scope = fluid.Scope()
    for name in src.local_names():
        v = src.find_var(name)
        if torch.is_tensor(v):
            scope.set(name, v.clone())
    return scope


def op_counts(block):
    types = {}
    for op in block.ops:
        types[op.type] = types.get(op.type, 0) + 1
    return ", ".join(f"{k}x{v}" for k, v in sorted(types.items()))


def spread(got, ref):
    """{name: ‖got − ref‖₂ / ‖ref‖₂}."""
    return {n: ((got[n].double() - ref[n].double()).norm()
                / ref[n].double().norm().clamp_min(1e-30)).item()
            for n in ref}


def phase_training(torch, fluid, seed, card):
    """Train ResNet-50 5 steps on one feed under both routes and hold step 1
    of the kernel route to the plain route parameter by parameter; returns
    the launches of each training kernel on the kernel route."""
    import re
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.conv_ops import conv_attrs
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    log(f"\n== phase 4: ResNet-50 training, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps on one feed ==")
    main, startup, loss = build_resnet50_train(fluid, seed)
    block = main.global_block()
    log("program: " + op_counts(block))
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)

    def fresh():
        return copy_scope(fluid, torch, init)

    rng = np.random.RandomState(seed)
    feed = {"img": rng.normal(0, 1, (TRAIN_BATCH, IMAGE, IMAGE, 3))
            .astype("float32"),
            "label": rng.randint(0, CLASSES, (TRAIN_BATCH, 1))
            .astype("int64")}
    update, = [op for op in block.ops if op.type == "fused_momentum"]
    grads = dict(zip(update.input("Params"), update.input("Grads")))
    stats = [p.name for p in block.all_parameters() if p.name not in grads]

    def run(route, scope, fd, fetch=()):
        fluid.set_flags({"kernel_tier": route})
        try:
            return exe.run(main, feed=fd, fetch_list=[loss] + list(fetch),
                           scope=scope, return_numpy=False)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})

    def readings(vals, scope):
        """Step 1 per parameter: each trainable parameter's gradient (from
        ``vals``, fetched after the loss) and each running statistic's
        change."""
        out = dict(zip(grads, vals[1:]))
        for n in stats:
            out[n] = scope.find_var(n).double() - init.find_var(n).double()
        return out

    want = {"auto": (KERNEL_CONVS, KERNEL_CONVS, 1, 2 * PLAIN_CONVS),
            "torch": (0, 0, 0, 0)}
    res = {}
    for route in ("auto", "torch"):
        scope = fresh()
        losses, ms, total = [], [], [0, 0, 0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            cbk.reset_launches()
            opk.reset_launches()
            tier.reset_fallback_counts()
            t0 = time.perf_counter()
            vals = run(route, scope, feed, grads.values() if step == 0
                       else ())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = (cbk.launches["conv_bn_train"],
                      cbk.launches["conv_bn_bwd"],
                      opk.launches["momentum_arena"],
                      tier.fallback_counts().get("conv_bn", 0))
            # the executor hands the same params and velocities back every
            # step, so only the first step packs momentum_arena's table
            if route == "auto" and step > 0 \
                    and opk.packs["momentum_arena"] != 0:
                fail(f"step {step + 1}: momentum_arena packed its table "
                     f"again ({opk.packs['momentum_arena']}): the params or "
                     "velocities came back as other tensors")
            if counts != want[route]:
                fail(f"kernel_tier={route} step {step + 1}: launches "
                     f"conv_bn_train/conv_bn_bwd/momentum_arena and "
                     f"plain-routed convs {counts}, want {want[route]}")
            for i in range(3):
                total[i] += counts[i]
            lv = vals[0]
            if lv.shape != () or not torch.isfinite(lv).item():
                fail(f"kernel_tier={route} step {step + 1}: loss {lv}")
            losses.append(lv.item())
            if step == 0:
                step1 = readings(vals, scope)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = sum(ms[1:]) / len(ms[1:])
        res[route] = dict(losses=losses, step1=step1, total=total,
                          stats=(steady, peak))
        log(f"kernel_tier={route}: losses "
            + " ".join(f"{v:.6f}" for v in losses)
            + " | ms/step " + " ".join(f"{v:.1f}" for v in ms)
            + f" | steady {steady:.2f} ms/step, "
            f"{TRAIN_BATCH * 1e3 / steady:.1f} images/s | peak memory "
            f"{peak:.2f} GiB | {card}")

    # the float32 floor: plain-route steps on the batch in other orders;
    # the last order is held out and only printed against the limits
    ref = res["torch"]["step1"]
    floors = []
    for j in range(FLOOR_ORDERS + 1):
        perm = np.random.RandomState(seed + 1 + j).permutation(TRAIN_BATCH)
        scope = fresh()
        vals = run("torch", scope, {k: v[perm] for k, v in feed.items()},
                   grads.values())
        floors.append(spread(readings(vals, scope), ref))
    held_out = floors.pop()
    floor = {n: max(f[n] for f in floors) for n in ref}
    limit = {n: max(REL_MIN, FLOOR_FACTOR * floor[n]) for n in ref}
    got = spread(res["auto"]["step1"], ref)

    def median(vals):
        vals = sorted(vals)
        return vals[len(vals) // 2]

    dl = abs(res["auto"]["losses"][0] - res["torch"]["losses"][0]) \
        / abs(res["torch"]["losses"][0])
    log(f"step 1, kernel vs plain route: loss rel diff {dl:.3e} (limit "
        f"{LOSS_LIMIT:.0e}); per parameter, the gradient of {len(grads)} "
        f"and the running-statistic change of {len(stats)}, ‖Δ‖₂/‖ref‖₂ "
        f"against {FLOOR_FACTOR}x its float32 floor (plain route, batch in "
        f"{FLOOR_ORDERS} other orders):")
    log("  kind           n | kernel vs plain: median, worst/limit | "
        "floor median | held-out order: worst/limit")
    kinds = {}
    for n in ref:
        kinds.setdefault(re.sub(r"_\d+\.", ".", n), []).append(n)
    for kind, names in sorted(kinds.items()):
        log(f"  {kind:12} {len(names):3d} | "
            f"{median(got[n] for n in names):.3e}, "
            f"{max(got[n] / limit[n] for n in names):.3f} | "
            f"{median(floor[n] for n in names):.3e} | "
            f"{max(held_out[n] / limit[n] for n in names):.3f}")
    worst = max(ref, key=lambda n: got[n] / limit[n])
    held = max(ref, key=lambda n: held_out[n] / limit[n])
    log(f"  worst: {worst} {got[worst]:.3e} (limit {limit[worst]:.3e}); "
        f"held-out order's worst: {held} {held_out[held]:.3e} (limit "
        f"{limit[held]:.3e})")
    problems = []
    if not dl <= LOSS_LIMIT:
        problems.append(f"step-1 loss differs from the plain route by "
                        f"{dl:.3e}")
    over = [n for n in ref if not got[n] <= limit[n]]
    if over:
        problems.append(f"{len(over)} parameters differ from the plain "
                        f"route at step 1 beyond their limits, worst "
                        f"{worst} {got[worst]:.3e} > {limit[worst]:.3e}")

    # the check's own test: a kernel-route step whose conv_bn_bwd scales
    # one layer's dw and another layer's dscale by PLANTED, at the layers
    # whose limits are loosest, must exceed those limits
    launched = []      # (filter, scale) of each conv_bn_bwd launch, in order
    for op in block.ops:
        if op.type != "fused_conv2d_bn_grad":
            continue
        x = (TRAIN_BATCH,) + tuple(block.var(op.input("Input")[0]).shape[1:])
        w = tuple(block.var(op.input("Filter")[0]).shape)
        if cbk.supported(x, w, *conv_attrs(op.attr), "NHWC", "float32"):
            launched.append((op.input("Filter")[0], op.input("Scale")[0]))
    at_dw = max(range(len(launched)), key=lambda i: limit[launched[i][0]])
    at_ds = max(range(len(launched)), key=lambda i: limit[launched[i][1]])
    real, calls = cbk.conv_bn_bwd, [0]

    def planted(*args):
        dx, dw, dscale, dbias = real(*args)
        dw = dw * PLANTED if calls[0] == at_dw else dw
        dscale = dscale * PLANTED if calls[0] == at_ds else dscale
        calls[0] += 1
        return dx, dw, dscale, dbias

    cbk.conv_bn_bwd = planted
    try:
        scope = fresh()
        bad = spread(readings(run("auto", scope, feed, grads.values()),
                              scope), ref)
    finally:
        cbk.conv_bn_bwd = real
    if calls[0] != len(launched):
        problems.append(f"the planted step made {calls[0]} conv_bn_bwd "
                        f"calls, want {len(launched)}")
    for what, i, name in (("dw", at_dw, launched[at_dw][0]),
                          ("dscale", at_ds, launched[at_ds][1])):
        log(f"planted fault: {what} x{PLANTED} at conv_bn_bwd launch "
            f"{i + 1} ({name}): ‖Δ‖₂/‖ref‖₂ {bad[name]:.3e}, limit "
            f"{limit[name]:.3e}")
        if not bad[name] > limit[name]:
            problems.append(f"the parameter check does not see {what} "
                            f"x{PLANTED} at {name}")

    # bench.py's own rate, and how many relu outputs change side at step 1
    lr_name = update.input("LearningRate")[0]
    relus = [op.output("Output")[0] for op in block.ops
             if op.type == "fused_conv2d_bn" and op.attr("act") == "relu"]
    relus += [op.output("Out")[0] for op in block.ops if op.type == "relu"]
    fast = {}
    for route in ("auto", "torch"):
        scope = fresh()
        scope.set(lr_name, torch.full_like(init.find_var(lr_name), BENCH_LR))
        vals = run(route, scope, feed, relus)
        masks = [v > 0 for v in vals[1:]]
        losses = [vals[0].item()] + [run(route, scope, feed)[0].item()
                                     for _ in range(TRAIN_STEPS - 1)]
        fast[route] = (losses, masks)
    flips = sum(int((a != b).sum().item()) for a, b in
                zip(fast["auto"][1], fast["torch"][1]))
    log(f"step 1: {flips} of {sum(m.numel() for m in masks)} relu outputs "
        f"are positive on one route and not on the other")
    log(f"at bench.py's lr {BENCH_LR} (its batch 256): losses, kernel route "
        + " ".join(f"{v:.4f}" for v in fast["auto"][0]) + "; plain route "
        + " ".join(f"{v:.4f}" for v in fast["torch"][0]))
    del fast, masks

    for route in ("auto", "torch"):
        losses = res[route]["losses"]
        if not losses[-1] < losses[0]:
            problems.append(f"kernel_tier={route}: loss did not fall over "
                            f"{TRAIN_STEPS} steps on one feed: {losses}")
    if problems:
        fail("; ".join(problems))
    scope = fresh()
    profile(torch, lambda: run("auto", scope, feed),
            f"one training step, batch {TRAIN_BATCH}, kernel route", card,
            reps=2, groups=CONV_BN_LAUNCHES)
    return (dict(zip(("conv_bn_train", "conv_bn_bwd", "momentum_arena"),
                     res["auto"]["total"])),
            {r: res[r]["stats"] for r in res})


def build_textcls(fluid, seed, cell="lstm"):
    """bench.py:239 build_lstm_textcls (``cell="lstm"``) or bench.py:320
    build_gru_textcls (``"gru"``) at the published widths, with
    Adam(SEQ_LR, fused=True)."""
    from paddle_tpu_torch.testing import models
    net = {"lstm": models.lstm_textcls, "gru": models.gru_textcls}[cell]
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        prob = net(words, vocab=SEQ_VOCAB, emb=SEQ_EMB, hidden=SEQ_HIDDEN)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam(learning_rate=SEQ_LR, fused=True).minimize(
            loss, startup)
    return main, startup, loss


def bwd_ops_ms(gemm):
    """(the least time of a recurrent backward's products on the tensor
    cores, at the CUDA cores' rate): one bf16 GEMM of ``gemm`` operations
    (the recomputed gates) and two of float32 dgates against bf16 W (dW and
    the dh products), three bf16 products each on the tensor cores."""
    bf16 = PEAK_FLOPS["bfloat16"]
    return ((gemm + 2 * 3 * gemm) / bf16 * 1e3,
            (gemm / bf16 + 2 * gemm / PEAK_FLOPS["float32"]) * 1e3)


def kernel_stages(torch, module, name, fn, ms,
                  stages=("prologue", "chain", "epilogue")):
    """Launch ``fn`` once and print its kernel's three stages' shares of
    block 0's clock (the kernel's stage clocks, in ``module``) and their
    ms at ``ms`` a launch."""
    fn()
    torch.cuda.synchronize()
    c = module.stage_clocks[name].cpu().double()
    share = ((c[1:] - c[:-1]) / (c[3] - c[0])).tolist()
    log(f"  {name} stages of one launch (block 0's clock): "
        + ", ".join(f"{n} {100 * v:.1f}% ({v * ms:.4f} ms)" for n, v in zip(
            stages, share)))


def lstm_operands(torch, gen, dev, lens, L=SEQ_LEN, H=SEQ_HIDDEN):
    """x, alive, w, h0, c0, dhs, dcs for len(lens) rows of L steps at
    hidden H (phase 5's shape by default); w at the scale of the model's
    Xavier init, the cotangents zero where alive is 0."""
    b = len(lens)
    alive = (torch.arange(L, device=dev)[:, None] < lens[None, :]) \
        .float()[..., None].contiguous()

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (randn(L, b, 4 * H), alive, randn(H, 4 * H, scale=0.05),
            randn(b, H), randn(b, H), (randn(L, b, H) * alive).contiguous(),
            (randn(L, b, H) * alive).contiguous())


def rel_errs(got, ref):
    """(‖Δ‖∞/‖ref‖∞, ‖Δ‖₂/‖ref‖₂, ‖Δ‖∞)."""
    d = (got.double() - ref.double())
    return (d.abs().max().item() / max(ref.abs().max().item(), 1e-30),
            (d.norm() / ref.double().norm().clamp_min(1e-30)).item(),
            d.abs().max().item())


def lstm_float64(torch, x, alive, w, h0, c0):
    """The LSTM forward's recipe (bf16(h)·bf16(w), then the cell) in
    float64: the yardstick both float32 versions are measured against."""
    def bf16(t):
        return t.float().bfloat16().double()

    H = h0.shape[-1]
    wb = bf16(w)
    x, alive = x.double(), alive.double()
    h, c = h0.double(), c0.double()
    hs, cs = [], []
    for t in range(x.shape[0]):
        g = x[t] + bf16(h) @ wb
        i, f = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H])
        cand, o = torch.tanh(g[:, 2 * H:3 * H]), torch.sigmoid(g[:, 3 * H:])
        cn = f * c + i * cand
        hn = o * torch.tanh(cn)
        h = alive[t] * hn + (1 - alive[t]) * h
        c = alive[t] * cn + (1 - alive[t]) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_fwd_check(torch, got, ref, exact, what, hold=True):
    """Print the LSTM forward's three criteria (LSTM_FWD_LIMIT) for hs and
    cs of ``got`` against the plain version's ``ref`` and the float64
    recipe's ``exact``. With ``hold``, fail where one is broken and return
    the largest ‖Δ‖∞; else return whether all of them held."""
    worst, ok = 0.0, True
    for name, g, r, e in zip(("hs", "cs"), got, ref, exact):
        inf, l2, d = rel_errs(g, r)
        k64 = (g.double() - e).abs().max().item()
        p64 = (r.double() - e).abs().max().item()
        worst = max(worst, d)
        held = (inf <= LSTM_FWD_LIMIT and l2 <= LSTM_FWD_L2_LIMIT
                and k64 <= LSTM_F64_RATIO * p64)
        ok = ok and held
        log(f"  {what} {name}: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
            f"{LSTM_FWD_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {l2:.3e} (limit "
            f"{LSTM_FWD_L2_LIMIT:.0e}); ‖Δ‖∞ to the float64 recipe: kernel "
            f"{k64:.3e}, plain {p64:.3e} (limit {LSTM_F64_RATIO}x the "
            f"plain's){'' if held else ': outside'}")
        if hold and not held:
            fail(f"lstm_seq {name} differs from lstm_seq_torch: {inf:.3e} / "
                 f"{l2:.3e}; to float64 {k64:.3e} vs {p64:.3e}")
    return worst if hold else ok


def lstm_bwd_check(torch, rnn, args):
    """lstm_seq_bwd against lstm_seq_bwd_torch on ``args`` (the forward's
    operands and plain carries, then the cotangents): fail where dx, dw,
    dh0 or dc0 is outside LSTM_BWD_LIMIT; return the largest ‖Δ‖∞."""
    got = rnn.lstm_seq_bwd(*args)
    torch.cuda.synchronize()
    want = rnn.lstm_seq_bwd_torch(*args)
    worst = 0.0
    for name, g, r in zip(("dx", "dw", "dh0", "dc0"), got, want):
        inf, l2, d = rel_errs(g, r)
        worst = max(worst, d)
        log(f"  lstm_seq_bwd {name}: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
            f"{LSTM_BWD_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {l2:.3e} (limit "
            f"{LSTM_BWD_L2_LIMIT:.0e})")
        if not (inf <= LSTM_BWD_LIMIT and l2 <= LSTM_BWD_L2_LIMIT):
            fail(f"lstm_seq_bwd {name} differs from lstm_seq_bwd_torch: "
                 f"{inf:.3e} / {l2:.3e}")
    return worst


def phase_rnn_kernels(torch, fluid, seed, card):
    """lstm_seq, lstm_seq_bwd and adam_arena against their plain versions
    at the lane's shapes, then their times. Returns {kernel: numbers for
    the kernels line}."""
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    L, b, H = SEQ_LEN, SEQ_BATCH, SEQ_HIDDEN
    lens = torch.randint(1, L + 1, (b,), generator=gen, device=dev)
    lens[: b // 4] = L
    x, alive, w, h0, c0, dhs, dcs = lstm_operands(torch, gen, dev, lens)
    log(f"\n== phase 5: lstm_seq / lstm_seq_bwd vs their plain versions, "
        f"b {b}, L {L}, H {H}, lengths {int(lens.min())}..{int(lens.max())} "
        f"({int((lens == L).sum())} full) ==")
    out = {}
    hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
    torch.cuda.synchronize()
    ref = rnn.lstm_seq_torch(x, alive, w, h0, c0)
    exact = lstm_float64(torch, x, alive, w, h0, c0)
    worst = lstm_fwd_check(torch, (hs, cs), ref, exact, "lstm_seq")
    out["lstm_seq"] = {"max_abs_err": worst}
    # the check's own test: W x PLANTED in the forget gate's columns
    wp = w.clone()
    wp[:, H:2 * H] *= PLANTED
    bad = rnn.lstm_seq(x, alive, wp, h0, c0)
    torch.cuda.synchronize()
    if lstm_fwd_check(torch, bad, ref, exact,
                      f"planted fault, W's forget columns x{PLANTED}",
                      hold=False):
        fail(f"lstm_seq's check does not see W's forget columns "
             f"x{PLANTED}")
    # the backward from the plain carries, so that it is held alone
    worst = lstm_bwd_check(torch, rnn, (x, alive, w, h0, c0, *ref, dhs,
                                        dcs))
    out["lstm_seq_bwd"] = {"max_abs_err": worst}

    main, _, _ = build_textcls(fluid, seed)
    params = [p for p in main.global_block().all_parameters() if p.trainable]
    nelem = sum(_numel(p.shape) for p in params)
    log(f"\n== phase 5: adam_arena vs adam_arena_torch over the text "
        f"classifier's {len(params)} trainable tensors ({nelem} elements), "
        f"bitwise ==")
    ps = [torch.randn(p.shape, generator=gen, device=dev) * 0.05
          for p in params]
    gs = [torch.randn(p.shape, generator=gen, device=dev) * 1e-2
          for p in params]
    state = {route: ([p.clone() for p in ps],
                     [torch.zeros_like(p) for p in ps],
                     [torch.zeros_like(p) for p in ps])
             for route in ("kernel", "plain")}
    lr = torch.full((1,), SEQ_LR, device=dev)
    pows = [torch.full((1,), 0.9, device=dev),
            torch.full((1,), 0.999, device=dev)]
    for step in (1, 2, 3):
        args = (lr, *pows, 0.9, 0.999, 1e-8)
        k = state["kernel"]
        opk.adam_arena(k[0], gs, k[1], k[2], *args)
        state["plain"] = opk.adam_arena_torch(*state["plain"][:1], gs,
                                              *state["plain"][1:], *args)
        torch.cuda.synchronize()
        pairs = [(a, r) for ks, rs in zip(state["kernel"], state["plain"])
                 for a, r in zip(ks, rs)]
        if step in (1, 3):
            if not all(torch.equal(a, r) for a, r in pairs):
                diff = max((a - r).abs().max().item() for a, r in pairs)
                fail(f"adam_arena differs from adam_arena_torch at step "
                     f"{step}: max abs {diff:.3e}, want bitwise")
            log(f"step {step}: bitwise equal (params and both moments)")
        pows = [pows[0] * 0.9 + 0.0, pows[1] * 0.999 + 0.0]
    out["adam_arena"] = {"max_abs_err": 0.0}

    log(f"\n== phase 5: times at the lane's shapes | {card} ==")
    lstm = torch.nn.LSTM(H, H).to(dev)
    xin = torch.randn(L, b, H, generator=gen, device=dev, requires_grad=True)
    with torch.enable_grad():
        y_lib, _ = lstm(xin)
    dy = torch.randn(y_lib.shape, generator=gen, device=dev)
    lib_leaves = [xin] + list(lstm.parameters())

    def lib_fwd():
        with torch.no_grad():
            lstm(xin)

    # operations of one lstm_seq: the gate product (bf16 operands) and
    # ~30 per cell; bytes: x, alive, w, h0, c0 read, hs and cs written
    gemm = 2 * L * b * H * 4 * H
    fwd_bytes = 4 * (L * b * 4 * H + L * b + 4 * H * H + 2 * b * H
                     + 2 * L * b * H)
    t_ops = gemm / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = fwd_bytes / PEAK_BYTES * 1e3
    out["lstm_seq"].update(
        ms=time_ms(lambda: rnn.lstm_seq(x, alive, w, h0, c0), torch),
        plain_ms=time_ms(lambda: rnn.lstm_seq_torch(x, alive, w, h0, c0),
                         torch),
        library_ms=time_ms(lib_fwd, torch),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    # the backward: the gate product again (bf16 operands), then dW and dh
    # (float32 dgates against bf16 values, exact on the tensor cores as
    # three bf16 products each, csrc/seq_mma.cuh; the CUDA-core bound, at
    # float32's rate, beside it); bytes: the forward's inputs and carries
    # and the cotangents read, dx, dw, dh0 and dc0 written
    t_ops, t_core = bwd_ops_ms(gemm)
    bwd_bytes = 4 * (2 * L * b * 4 * H + L * b + 2 * 4 * H * H + 4 * b * H
                     + 4 * L * b * H)
    t_bytes = bwd_bytes / PEAK_BYTES * 1e3

    def bwd():
        return rnn.lstm_seq_bwd(x, alive, w, h0, c0, *ref, dhs, dcs)

    out["lstm_seq_bwd"].update(
        ms=time_ms(bwd, torch),
        plain_ms=time_ms(lambda: rnn.lstm_seq_bwd_torch(
            x, alive, w, h0, c0, *ref, dhs, dcs), torch),
        library_ms=time_ms(lambda: torch.autograd.grad(
            y_lib, lib_leaves, dy, retain_graph=True), torch),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    serial = time_ms(lambda: rnn.barrier_chain(H // 4, L, dev), torch)
    for k in ("lstm_seq", "lstm_seq_bwd"):
        t = out[k]
        log(f"{k} per launch: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, torch.nn.LSTM {t['library_ms']:.4f} "
            f"ms (with the input GEMM), bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}"
            + (f"; CUDA-core bound {t_core:.4f} ms" if k.endswith("bwd")
               else "")
            + f"), serial floor {serial:.4f} ms ({L} grid barriers over "
            f"{H // 4} blocks)")
    kernel_stages(torch, rnn, "lstm_seq_bwd", bwd, out["lstm_seq_bwd"]["ms"])
    x2, a2, _, _, _, dh2, dc2 = lstm_operands(
        torch, gen, dev, torch.full((b,), CTC_FRAMES[1], device=dev),
        CTC_FRAMES[1])
    h2, c2 = rnn.lstm_seq(x2, a2, w, h0, c0)

    def long():
        return rnn.lstm_seq_bwd(x2, a2, w, h0, c0, h2, c2, dh2, dc2)

    ms_f = time_ms(lambda: rnn.lstm_seq(x2, a2, w, h0, c0), torch)
    ms = time_ms(long, torch)
    log(f"at the CTC model's {CTC_FRAMES[1]} frames (b {b}, H {H}): "
        f"lstm_seq {ms_f:.4f} ms, lstm_seq_bwd {ms:.4f} ms a launch")
    kernel_stages(torch, rnn, "lstm_seq_bwd", long, ms)

    adam_ps = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(adam_ps, gs):
        p.grad = g
    adam = torch.optim.Adam(adam_ps, lr=SEQ_LR, fused=True)
    k = state["kernel"]
    t = out["adam_arena"]

    def call():
        opk.adam_arena(k[0], gs, k[1], k[2], lr, *pows, 0.9, 0.999, 1e-8)

    t["ms"] = time_ms(call, torch)
    t["plain_ms"] = time_ms(lambda: opk.adam_arena_torch(
        k[0], gs, k[1], k[2], lr, *pows, 0.9, 0.999, 1e-8), torch)
    t["library_ms"] = time_ms(adam.step, torch)
    t["bound_ms"], t["bound_by"] = bound_ms(0, 28 * nelem)
    kern, _, _ = split_device(device_ms(torch, call), "adam_arena")
    log(f"adam_arena per step ({len(ps)} tensors, {nelem} elements): call "
        f"{t['ms']:.4f} ms (host enqueue {host_ms(torch, call):.4f} ms, "
        f"kernel device {kern:.4f} ms), plain {t['plain_ms']:.4f} ms, "
        f"Adam(fused=True) {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def textcls_feeds(fluid, seed, ragged):
    """One batch of SEQ_BATCH sequences fed as the lane feeds it
    (pack_sequences): length SEQ_LEN, or lengths 1..SEQ_LEN (some full)."""
    import numpy as np
    rng = np.random.RandomState(seed + (7 if ragged else 5))
    lens = np.full(SEQ_BATCH, SEQ_LEN)
    if ragged:
        lens = rng.randint(1, SEQ_LEN + 1, SEQ_BATCH)
        lens[:4] = SEQ_LEN
        lens[4] = 1
    seqs = [rng.randint(0, SEQ_VOCAB, (int(n), 1)).astype("int64")
            for n in lens]
    return {"words": fluid.pack_sequences(seqs),
            "label": rng.randint(0, 2, (SEQ_BATCH, 1)).astype("int64")}


def train_phase(torch, fluid, card, spec):
    """Train ``spec["main"]`` SEQ_STEPS steps on the first of
    ``spec["feeds"]`` under both routes, each step's kernel launches and
    plain-routed ops counted against ``spec["want"]``; hold step 1 of the
    kernel route, on every feed, to the same program with the kernel
    wrappers swapped for their plain versions (``spec["swaps"]``) within
    ``spec["loss_limit"]`` and ``spec["grad_limit"]``; a planted fault
    (``spec["plant"]``) must break the gradient limit; the loss must fall on
    both routes. ``spec["amp"]`` runs every step under
    ``Executor(amp=True)``. Prints ms per step, sequences/s and peak memory
    of both routes and a profile of a kernel-route step. Returns (the launch
    totals of the kernel route by counter, its trained scope, the
    executor, {route: (steady ms a step, peak GiB)})."""
    import numpy as np
    title, main, loss = spec["title"], spec["main"], spec["loss"]
    block = main.global_block()
    log("program: " + op_counts(block))
    exe = fluid.Executor(amp=spec.get("amp", False))
    init = fluid.Scope()
    exe.run(spec["startup"], scope=init)
    update, = [op for op in block.ops if op.type == "fused_adam"]
    grads = dict(zip(update.input("Params"), update.input("Grads")))
    feeds = spec["feeds"]
    train_name, train_feed = feeds[0]
    labels = [c[0] for c in spec["counters"]]

    def run(route, scope, fd, fetch=()):
        fluid.set_flags({"kernel_tier": route})
        try:
            return exe.run(main, feed=fd, fetch_list=[loss] + list(fetch),
                           scope=scope, return_numpy=False)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})

    def step1(route, fd):
        """(loss, {param: gradient}) of one step from the startup state."""
        vals = run(route, copy_scope(fluid, torch, init), fd, grads.values())
        return vals[0].item(), dict(zip(grads, vals[1:]))

    want = {"auto": spec["want"], "torch": (0,) * len(labels)}
    res = {}
    for route in ("auto", "torch"):
        scope = copy_scope(fluid, torch, init)
        losses, ms, total = [], [], [0] * len(labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(SEQ_STEPS):
            for reset in spec["resets"]:
                reset()
            t0 = time.perf_counter()
            vals = run(route, scope, train_feed, grads.values() if step == 0
                       else ())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = tuple(get() for _, get in spec["counters"])
            if counts != want[route]:
                fail(f"{title}, kernel_tier={route} step {step + 1}: "
                     f"{'/'.join(labels)} {counts}, want {want[route]}")
            total = [a + c for a, c in zip(total, counts)]
            lv = vals[0]
            if lv.shape != () or not torch.isfinite(lv).item():
                fail(f"{title}, kernel_tier={route} step {step + 1}: loss "
                     f"{lv}")
            losses.append(lv.item())
            if step == 0:
                first = dict(zip(grads, vals[1:]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = sum(ms[1:]) / len(ms[1:])
        res[route] = dict(losses=losses, step1=first, total=total,
                          scope=scope, stats=(steady, peak))
        log(f"kernel_tier={route}: losses "
            + " ".join(f"{v:.6f}" for v in losses)
            + " | ms/step " + " ".join(f"{v:.1f}" for v in ms)
            + f" | steady {steady:.2f} ms/step, "
            f"{spec['batch'] * 1e3 / steady:.1f} sequences/s | peak memory "
            f"{peak:.2f} GiB | {card}")

    # the reference: the same program with the kernel wrappers swapped for
    # their plain versions, as the planted fault below swaps one
    real = [(m, a, getattr(m, a)) for m, a, _ in spec["swaps"]]
    for m, a, plain in spec["swaps"]:
        setattr(m, a, plain)
    try:
        refs = {name: step1("auto", fd) for name, fd in feeds}
    finally:
        for m, a, fn in real:
            setattr(m, a, fn)

    problems = []
    loss_limit, grad_limit = spec["loss_limit"], spec["grad_limit"]

    def check(name, loss_got, got):
        ref_loss, ref = refs[name]
        dl = abs(loss_got - ref_loss) / abs(ref_loss)
        sp = spread(got, ref)
        log(f"step 1, {name} feed, kernel vs plain versions: loss rel diff "
            f"{dl:.3e} (limit {loss_limit:.0e}); gradients ‖Δ‖₂/‖ref‖₂ "
            f"(limit {grad_limit:.0e}): "
            + ", ".join(f"{n} {v:.3e}" for n, v in sp.items()))
        if not dl <= loss_limit:
            problems.append(f"{title}, {name} feed: loss differs by "
                            f"{dl:.3e}")
        over = [n for n in grads if not sp[n] <= grad_limit]
        if over:
            problems.append(f"{title}, {name} feed: {over} beyond the "
                            f"limit")

    check(train_name, res["auto"]["losses"][0], res["auto"]["step1"])
    for name, fd in feeds[1:]:
        lv, got = step1("auto", fd)
        if not np.isfinite(lv) or not all(torch.isfinite(g).all().item()
                                          for g in got.values()):
            problems.append(f"{title}: the {name} step is not finite "
                            f"(loss {lv})")
        check(name, lv, got)

    # the check's own test: one output of one kernel launch x PLANTED
    plant = spec["plant"]
    module, attr, at = plant["module"], plant["attr"], plant["at"]
    good, calls = getattr(module, attr), [0]

    def planted(*args):
        out = good(*args)
        if calls[0] == at:
            if plant["index"] is None:
                out = out * PLANTED
            else:
                out = tuple(o * PLANTED if i == plant["index"] else o
                            for i, o in enumerate(out))
        calls[0] += 1
        return out

    setattr(module, attr, planted)
    try:
        bad = spread(step1("auto", train_feed)[1], refs[train_name][1])
    finally:
        setattr(module, attr, good)
    name = plant["param"]
    log(f"planted fault: {plant['what']} x{PLANTED} at {attr} launch "
        f"{at + 1}: {name} ‖Δ‖₂/‖ref‖₂ {bad[name]:.3e}, limit "
        f"{grad_limit:.0e}")
    if calls[0] != plant["calls"]:
        problems.append(f"{title}: the planted step made {calls[0]} {attr} "
                        f"calls, want {plant['calls']}")
    if not bad[name] > grad_limit:
        problems.append(f"{title}: the gradient check does not see "
                        f"{plant['what']} x{PLANTED} at {name}")

    # the torch route runs the float32 scans, without the kernels' bf16
    # roundings: another function, so its distance is printed only
    dist = spread(res["torch"]["step1"], refs[train_name][1])
    dl = abs(res["torch"]["losses"][0] - refs[train_name][0]) \
        / abs(refs[train_name][0])
    log("distance of the torch route (float32 scans) from the kernel "
        f"route's reference at step 1: loss {dl:.3e}; ‖Δ‖₂/‖ref‖₂ "
        + ", ".join(f"{n} {v:.2e}" for n, v in dist.items()))
    for route in ("auto", "torch"):
        losses = res[route]["losses"]
        if not losses[-1] < losses[0]:
            problems.append(f"{title}, kernel_tier={route}: loss did not "
                            f"fall over {SEQ_STEPS} steps on one feed: "
                            f"{losses}")
    if problems:
        fail("; ".join(problems))
    scope = copy_scope(fluid, torch, init)
    profile(torch, lambda: run("auto", scope, train_feed),
            f"{title}: one training step, batch {spec['batch']}, kernel "
            "route", card, reps=3)
    return (dict(zip(labels, res["auto"]["total"])), res["auto"]["scope"],
            exe, {r: res[r]["stats"] for r in res})


def phase_textcls(torch, fluid, seed, card, cell="lstm"):
    """Train the LSTM (phase 6) or GRU (phase 8) text classifier 5 steps on
    one feed under both routes and hold step 1 of the kernel route to the
    plain-version route parameter by parameter; returns (the launches of
    each kernel on the kernel route, {route: (ms a step, peak GiB)})."""
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    name = {"lstm": "LSTM", "gru": "GRU"}[cell]
    fwd, bwd = f"{cell}_seq", f"{cell}_seq_bwd"
    log(f"\n== phase {6 if cell == 'lstm' else 8}: {name} text classifier, "
        f"batch {SEQ_BATCH}, length {SEQ_LEN}, {SEQ_STEPS} steps on one "
        f"feed ==")
    main, startup, loss = build_textcls(fluid, seed, cell)
    weights = [op.input("Weight")[0] for op in main.global_block().ops
               if op.type == f"{cell}_grad"]
    loss_limit, grad_limit = {
        "lstm": (TEXTCLS_LOSS_LIMIT, TEXTCLS_GRAD_LIMIT),
        "gru": (GRU_TRAIN_LOSS_LIMIT, GRU_TRAIN_GRAD_LIMIT)}[cell]
    totals, _, _, stats = train_phase(torch, fluid, card, dict(
        title=f"{name} text classifier", main=main, startup=startup,
        loss=loss, batch=SEQ_BATCH,
        feeds=[("fixed", textcls_feeds(fluid, seed, ragged=False)),
               ("ragged", textcls_feeds(fluid, seed, ragged=True))],
        counters=[(fwd, lambda: rnn.launches[fwd]),
                  (bwd, lambda: rnn.launches[bwd]),
                  ("adam_arena", lambda: opk.launches["adam_arena"]),
                  (f"plain-routed {name}s",
                   lambda: tier.fallback_counts().get(cell, 0))],
        resets=[rnn.reset_launches, opk.reset_launches,
                tier.reset_fallback_counts],
        want=(2, 2, 1, 0),
        swaps=[(rnn, fwd, getattr(rnn, f"{fwd}_torch")),
               (rnn, bwd, getattr(rnn, f"{bwd}_torch"))],
        # dW x PLANTED in the last backward launch of the step (the first
        # layer's)
        plant=dict(module=rnn, attr=bwd, index=1, at=len(weights) - 1,
                   calls=len(weights), param=weights[-1], what="dW"),
        loss_limit=loss_limit, grad_limit=grad_limit))
    return totals, stats


def gru_operands(torch, gen, dev, lens, L=SEQ_LEN):
    """x, alive, w, h0, dhs at phase 7's shape (L steps); w at the scale of
    the model's Xavier init, the cotangents zero where alive is 0."""
    b, H = SEQ_BATCH, SEQ_HIDDEN
    alive = (torch.arange(L, device=dev)[:, None] < lens[None, :]) \
        .float()[..., None].contiguous()

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (randn(L, b, 3 * H), alive, randn(H, 3 * H, scale=0.05),
            randn(b, H), (randn(L, b, H) * alive).contiguous())


def gru_float64(torch, x, alive, w, h0):
    """The GRU forward's recipe (bf16(h)·bf16(w), bf16(r⊙h)·bf16(w_c)) in
    float64: the yardstick both float32 versions are measured against."""
    def bf16(t):
        return t.float().bfloat16().double()

    H = h0.shape[-1]
    wb = bf16(w)
    x, alive, h = x.double(), alive.double(), h0.double()
    out = []
    for t in range(x.shape[0]):
        ur = bf16(h) @ wb[:, :2 * H]
        u = torch.sigmoid(x[t][:, :H] + ur[:, :H])
        r = torch.sigmoid(x[t][:, H:2 * H] + ur[:, H:])
        c = torch.tanh(x[t][:, 2 * H:] + bf16(r * h) @ wb[:, 2 * H:])
        h = alive[t] * (u * c + (1 - u) * h) + (1 - alive[t]) * h
        out.append(h)
    return torch.stack(out)


def ctc_feed(fluid, seed):
    """One batch of CTC_BATCH utterances of CTC_FRAMES frames of
    CTC_FEAT features (one at the longest), each with a label of
    ⌈frames/8⌉..⌊frames/4⌋ characters of CTC_CLASSES."""
    import numpy as np
    rng = np.random.RandomState(seed + 11)
    frames = rng.randint(CTC_FRAMES[0], CTC_FRAMES[1] + 1, CTC_BATCH)
    frames[0] = CTC_FRAMES[1]
    ulens = [rng.randint(-(-int(f) // 8), int(f) // 4 + 1) for f in frames]
    feats = [rng.normal(0, 1, (int(f), CTC_FEAT)).astype("float32")
             for f in frames]
    labels = [rng.randint(1, CTC_CLASSES + 1, (u, 1)).astype("int64")
              for u in ulens]
    return {"feat": fluid.pack_sequences(feats),
            "label": fluid.pack_sequences(labels)}


def phase_seq_kernels(torch, fluid, seed, card):
    """gru_seq, gru_seq_bwd, ctc_alpha and ctc_loss_bwd against their plain
    versions at the lane's and the CTC model's shapes, then their times.
    Returns {kernel: numbers for the kernels line}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import ctc
    from paddle_tpu_torch.ops.cuda import rnn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    L, b, H = SEQ_LEN, SEQ_BATCH, SEQ_HIDDEN
    lens = torch.randint(1, L + 1, (b,), generator=gen, device=dev)
    lens[: b // 4] = L
    x, alive, w, h0, dhs = gru_operands(torch, gen, dev, lens)
    log(f"\n== phase 7: gru_seq / gru_seq_bwd vs their plain versions, "
        f"b {b}, L {L}, H {H}, lengths {int(lens.min())}..{int(lens.max())} "
        f"({int((lens == L).sum())} full) ==")
    out = {}
    hs = rnn.gru_seq(x, alive, w, h0)
    torch.cuda.synchronize()
    ref = rnn.gru_seq_torch(x, alive, w, h0)
    inf, l2, d = rel_errs(hs, ref)
    exact = gru_float64(torch, x, alive, w, h0)
    k64 = (hs.double() - exact).abs().max().item()
    p64 = (ref.double() - exact).abs().max().item()
    log(f"  gru_seq hs: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit {GRU_FWD_LIMIT:.0e}), "
        f"‖Δ‖₂/‖ref‖₂ {l2:.3e} (limit {GRU_FWD_L2_LIMIT:.0e}); ‖Δ‖∞ to the "
        f"float64 recipe: kernel {k64:.3e}, plain {p64:.3e} (limit "
        f"{GRU_F64_RATIO}x the plain's)")
    if not (inf <= GRU_FWD_LIMIT and l2 <= GRU_FWD_L2_LIMIT
            and k64 <= GRU_F64_RATIO * p64):
        fail(f"gru_seq differs from gru_seq_torch: {inf:.3e} / {l2:.3e}; "
             f"to float64 {k64:.3e} vs {p64:.3e}")
    out["gru_seq"] = {"max_abs_err": d}
    # the backward from the plain carries, so that it is held alone
    got = rnn.gru_seq_bwd(x, alive, w, h0, ref, dhs)
    torch.cuda.synchronize()
    want = rnn.gru_seq_bwd_torch(x, alive, w, h0, ref, dhs)
    worst = 0.0
    for name, g, r in zip(("dx", "dw", "dh0"), got, want):
        inf, l2, d = rel_errs(g, r)
        worst = max(worst, d)
        log(f"  gru_seq_bwd {name}: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
            f"{GRU_BWD_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {l2:.3e} (limit "
            f"{GRU_BWD_L2_LIMIT:.0e})")
        if not (inf <= GRU_BWD_LIMIT and l2 <= GRU_BWD_L2_LIMIT):
            fail(f"gru_seq_bwd {name} differs from gru_seq_bwd_torch: "
                 f"{inf:.3e} / {l2:.3e}")
    out["gru_seq_bwd"] = {"max_abs_err": worst}

    fd = ctc_feed(fluid, seed)
    xl = fd["feat"].lens.to(dev)
    yl = fd["label"].lens.to(dev)
    labels = fd["label"].data[..., 0].to(dev)
    T, C = int(xl.max()), CTC_CLASSES + 1
    logits = torch.randn((CTC_BATCH, T, C), generator=gen, device=dev)
    dloss = torch.randn((CTC_BATCH,), generator=gen, device=dev)
    logp = torch.log_softmax(logits, -1)
    sp = ctc.label_positions(labels.shape[1])
    log(f"\n== phase 7: ctc_alpha / ctc_loss_bwd vs their plain versions, "
        f"b {CTC_BATCH}, T {T}, C {C}, Sp {sp}, frames "
        f"{int(xl.min())}..{T}, labels {int(yl.min())}..{int(yl.max())} ==")
    loss = ctc.ctc_alpha(logp, xl, labels, yl, 0)
    torch.cuda.synchronize()
    want = ctc.ctc_loss_fwd_torch(logp, xl, labels, yl, 0)
    inf, l2, d = rel_errs(loss, want)
    lib = F.ctc_loss(logp.transpose(0, 1), labels, xl, yl, blank=0,
                     reduction="none")
    lib_rel = ((lib - want[:, 0]).abs() / want[:, 0].abs()).max().item()
    log(f"  ctc_alpha loss: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
        f"{CTC_FWD_LIMIT:.0e}; bitwise {torch.equal(loss, want)}); "
        f"F.ctc_loss against the plain version: max rel diff {lib_rel:.3e} "
        f"(printed only: another summation)")
    if not inf <= CTC_FWD_LIMIT:
        fail(f"ctc_alpha differs from ctc_loss_fwd_torch: {inf:.3e}")
    out["ctc_alpha"] = {"max_abs_err": d}
    # the check's own test: the forward built with its skip mask ignored
    # (phase 1 built it from a copy of csrc/ctc.cu) must break the limit
    good = ctc._lib
    bad_lib = ctc._bind(ctypes.CDLL(str(PLANTED_CTC[1])))
    ctc._lib = lambda: bad_lib
    try:
        bad = rel_errs(ctc.ctc_alpha(logp, xl, labels, yl, 0), want)[0]
    finally:
        ctc._lib = good
    log(f"  planted fault: the forward's skip mask ignored: ‖Δ‖∞/‖ref‖∞ "
        f"{bad:.3e}, limit {CTC_FWD_LIMIT:.0e}")
    if not bad > CTC_FWD_LIMIT:
        fail(f"the ctc_alpha check does not see the skip mask ignored "
             f"({bad:.3e})")
    got = ctc.ctc_loss_bwd(logp, xl, labels, yl, 0, dloss)
    torch.cuda.synchronize()
    want = ctc.ctc_loss_bwd_torch(logp, xl, labels, yl, 0, dloss)
    inf, l2, d = rel_errs(got, want)
    log(f"  ctc_loss_bwd dlogits: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
        f"{CTC_BWD_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {l2:.3e}")
    if not inf <= CTC_BWD_LIMIT:
        fail(f"ctc_loss_bwd differs from ctc_loss_bwd_torch: {inf:.3e}")
    out["ctc_loss_bwd"] = {"max_abs_err": d}

    log(f"\n== phase 7: times at the lane's and the CTC model's shapes | "
        f"{card} ==")
    # operations of one gru_seq: the gate products (bf16 operands) and ~30
    # per cell; bytes: x, alive, w, h0 read, hs written
    gemm = 2 * L * b * H * 3 * H
    fwd_bytes = 4 * (L * b * 3 * H + L * b + 3 * H * H + b * H + L * b * H)
    t_ops = gemm / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = fwd_bytes / PEAK_BYTES * 1e3
    out["gru_seq"].update(
        ms=time_ms(lambda: rnn.gru_seq(x, alive, w, h0), torch),
        plain_ms=time_ms(lambda: rnn.gru_seq_torch(x, alive, w, h0), torch),
        library_ms=None, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    # the backward: the gate products again (bf16 operands), then the two
    # dh products and dW (float32 dgates against bf16 values, three bf16
    # products each on the tensor cores; the CUDA-core bound beside);
    # bytes: the forward's inputs, its carries and their cotangents read,
    # dx, dw and dh0 written
    t_ops, t_core = bwd_ops_ms(gemm)
    bwd_bytes = 4 * (2 * L * b * 3 * H + L * b + 2 * 3 * H * H + 2 * b * H
                     + 2 * L * b * H)
    t_bytes = bwd_bytes / PEAK_BYTES * 1e3

    def bwd():
        return rnn.gru_seq_bwd(x, alive, w, h0, ref, dhs)

    out["gru_seq_bwd"].update(
        ms=time_ms(bwd, torch),
        plain_ms=time_ms(lambda: rnn.gru_seq_bwd_torch(
            x, alive, w, h0, ref, dhs), torch),
        library_ms=None, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    serial = time_ms(lambda: rnn.barrier_chain(H // 4, 2 * L, dev), torch)
    for k in ("gru_seq", "gru_seq_bwd"):
        t = out[k]
        log(f"{k} per launch: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library none (torch.nn.GRU applies r "
            f"after the recurrent product, cuDNN's formula: another "
            f"function), bound {t['bound_ms']:.4f} ms ({t['bound_by']}"
            + (f"; CUDA-core bound {t_core:.4f} ms" if k.endswith("bwd")
               else "")
            + f"), serial floor {serial:.4f} ms ({2 * L} grid barriers "
            f"over {H // 4} blocks)")
    kernel_stages(torch, rnn, "gru_seq_bwd", bwd, out["gru_seq_bwd"]["ms"])
    x2, a2, _, _, dh2 = gru_operands(
        torch, gen, dev, torch.full((b,), CTC_FRAMES[1], device=dev),
        CTC_FRAMES[1])
    h2 = rnn.gru_seq(x2, a2, w, h0)

    def long():
        return rnn.gru_seq_bwd(x2, a2, w, h0, h2, dh2)

    ms_f = time_ms(lambda: rnn.gru_seq(x2, a2, w, h0), torch)
    ms = time_ms(long, torch)
    log(f"at the CTC model's {CTC_FRAMES[1]} frames (b {b}, H {H}): "
        f"gru_seq {ms_f:.4f} ms, gru_seq_bwd {ms:.4f} ms a launch")
    kernel_stages(torch, rnn, "gru_seq_bwd", long, ms)

    # CTC work that this batch's lengths need, not the padded T: ~16
    # operations per valid label position (2 U' + 1 in a row) and step of
    # the recurrence (two logaddexp and the emission's add). The forward
    # reads logp at the classes of a row's labels and the blank over its
    # frames, the labels (int64) and the lengths, and writes the loss
    steps = int((xl - 1).clamp_min(0).sum())
    frames = int(xl.sum())
    classes = sum(len({0, *row[:n].tolist()}) * int(f) for row, n, f in
                  zip(labels.cpu(), yl.cpu().tolist(), xl.cpu()))
    t_ops = 16 * int(((xl - 1).clamp_min(0) * (2 * yl + 1)).sum()) \
        / PEAK_FLOPS["float32"] * 1e3
    t_bytes = (4 * classes + 8 * int(yl.sum()) + 12 * CTC_BATCH) \
        / PEAK_BYTES * 1e3
    lg_leaf = logits.detach().requires_grad_(True)
    with torch.enable_grad():
        lib_loss = F.ctc_loss(torch.log_softmax(lg_leaf, -1).transpose(0, 1),
                              labels, xl, yl, blank=0, reduction="none")
    lib_ct = dloss.clone()

    def fwd():
        return ctc.ctc_alpha(logp, xl, labels, yl, 0)

    out["ctc_alpha"].update(
        ms=time_ms(fwd, torch),
        plain_ms=time_ms(lambda: ctc.ctc_loss_fwd_torch(logp, xl, labels, yl,
                                                        0), torch),
        library_ms=time_ms(lambda: F.ctc_loss(
            logp.transpose(0, 1), labels, xl, yl, blank=0,
            reduction="none"), torch),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    # the first forward's torch glue (the Pallas kernel's inputs), which
    # ran before its kernel on every call up to PR 13
    glue_ms = time_ms(lambda: ctc.ctc_inputs(logp, labels, yl, xl, 0), torch)
    # the backward: the recurrence again, ~30 operations per position and
    # step of the scan's adjoint, and per frame one add per label position
    # (the emissions' cotangents onto their classes) and ~3 per class (the
    # log-softmax's backward). It reads logp at the rows' frames, the labels
    # (int64), the lengths and dloss, and writes all of dlogits [b, T, C]
    # (zeros past each row's frames)
    t_ops = ((16 + 30) * steps * sp + frames * (sp + 3 * C)) \
        / PEAK_FLOPS["float32"] * 1e3
    t_bytes = (4 * (frames * C + CTC_BATCH * T * C + 3 * CTC_BATCH)
               + 8 * labels.numel()) / PEAK_BYTES * 1e3
    out["ctc_loss_bwd"].update(
        ms=time_ms(lambda: ctc.ctc_loss_bwd(logp, xl, labels, yl, 0, dloss),
                   torch),
        plain_ms=time_ms(lambda: ctc.ctc_loss_bwd_torch(
            logp, xl, labels, yl, 0, dloss), torch),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_loss, lg_leaf, lib_ct, retain_graph=True), torch),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    # the serial floors: one warp running the forward's T dependent steps
    # alone, and the backward's 2 T (the launch's own cost included)
    floors = {"ctc_alpha": (time_ms(lambda: ctc.chain_floor(
        T, dev, backward=False), torch), T),
        "ctc_loss_bwd": (time_ms(lambda: ctc.chain_floor(T, dev), torch),
                         2 * T)}
    for k, lib_name in (("ctc_alpha", "F.ctc_loss"),
                        ("ctc_loss_bwd", "F.ctc_loss backward, with the "
                         "log-softmax's")):
        t = out[k]
        log(f"{k} per call: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, {lib_name} {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), serial floor "
            f"{floors[k][0]:.4f} ms ({floors[k][1]} dependent steps on one "
            f"warp)")
    log(f"the first forward's torch glue (ctc_inputs: the extended labels, "
        f"masks, alpha0, final0 and e [b, T, Sp]) alone: {glue_ms:.4f} ms "
        f"a call")
    kernel_stages(torch, ctc, "ctc_alpha", fwd, out["ctc_alpha"]["ms"],
                  ("prologue", "chain", "loss"))
    kernel_stages(torch, ctc, "ctc_loss_bwd",
                  lambda: ctc.ctc_loss_bwd(logp, xl, labels, yl, 0, dloss),
                  out["ctc_loss_bwd"]["ms"], ("recompute", "adjoint",
                                              "epilogue"))
    return out


def build_ctc_acoustic(fluid, seed):
    """tests/book/test_ocr_ctc.py:38-50 at phase 9's widths, with
    Adam(CTC_LR, fused=True). Returns (main, startup, loss, logits)."""
    from paddle_tpu_torch.testing.models import ctc_acoustic
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        feat = fluid.layers.data("feat", shape=[CTC_FEAT], lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64",
                                  lod_level=1)
        logits, loss = ctc_acoustic(feat, label, CTC_CLASSES, CTC_HIDDEN)
        fluid.optimizer.Adam(learning_rate=CTC_LR, fused=True).minimize(
            loss, startup)
    return main, startup, loss, logits


def phase_ctc(torch, fluid, seed, card):
    """Train the CTC acoustic model 5 steps on one batch under both routes
    and hold step 1 of the kernel route to the plain-version route; then
    greedy-decode the batch through ``main.clone(for_test=True)`` and print
    the normalized edit distance. Returns the launches of each kernel on
    the kernel route."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import ctc
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    log(f"\n== phase 9: CTC acoustic model, batch {CTC_BATCH}, "
        f"{CTC_FRAMES[0]}..{CTC_FRAMES[1]} frames of {CTC_FEAT} features, "
        f"hidden {CTC_HIDDEN}, {CTC_CLASSES} + 1 classes, {SEQ_STEPS} steps "
        f"on one batch ==")
    main, startup, loss, logits = build_ctc_acoustic(fluid, seed)
    fd = ctc_feed(fluid, seed)
    gru_w, = [op.input("Weight")[0] for op in main.global_block().ops
              if op.type == "gru_grad"]
    totals, trained, exe, _ = train_phase(torch, fluid, card, dict(
        title="CTC acoustic model", main=main, startup=startup, loss=loss,
        batch=CTC_BATCH, feeds=[("utterances", fd)],
        counters=[("gru_seq", lambda: rnn.launches["gru_seq"]),
                  ("gru_seq_bwd", lambda: rnn.launches["gru_seq_bwd"]),
                  ("ctc_alpha", lambda: ctc.launches["ctc_alpha"]),
                  ("ctc_loss_bwd", lambda: ctc.launches["ctc_loss_bwd"]),
                  ("adam_arena", lambda: opk.launches["adam_arena"]),
                  ("plain-routed GRUs",
                   lambda: tier.fallback_counts().get("gru", 0)),
                  ("plain-routed CTCs",
                   lambda: tier.fallback_counts().get("ctc", 0))],
        resets=[rnn.reset_launches, ctc.reset_launches, opk.reset_launches,
                tier.reset_fallback_counts],
        want=(1, 1, 1, 1, 1, 0, 0),
        swaps=[(rnn, "gru_seq", rnn.gru_seq_torch),
               (rnn, "gru_seq_bwd", rnn.gru_seq_bwd_torch),
               (ctc, "ctc_alpha", ctc.ctc_loss_fwd_torch),
               (ctc, "ctc_loss_bwd", ctc.ctc_loss_bwd_torch)],
        # dlogits x PLANTED in the step's one ctc_loss_bwd launch: every
        # gradient below the loss moves by it
        plant=dict(module=ctc, attr="ctc_loss_bwd", index=None, at=0,
                   calls=1, param=gru_w, what="dlogits"),
        loss_limit=GRU_TRAIN_LOSS_LIMIT, grad_limit=GRU_TRAIN_GRAD_LIMIT))

    # decode the batch as tests/book/test_ocr_ctc.py decodes its test batch
    infer = main.clone(for_test=True)
    eval_prog, eval_start = fluid.Program(), fluid.Program()
    with fluid.program_guard(eval_prog, eval_start):
        lg = fluid.layers.data("lg", shape=[CTC_CLASSES + 1], lod_level=1)
        lb = fluid.layers.data("lb", shape=[1], dtype="int64", lod_level=1)
        decoded = fluid.layers.ctc_greedy_decoder(input=lg, blank=0)
        dist, _ = fluid.layers.edit_distance(input=decoded, label=lb,
                                             normalized=True)
    scope = copy_scope(fluid, torch, trained)
    lg_out, = exe.run(infer, feed=fd, fetch_list=[logits], scope=scope,
                      return_numpy=False)
    dec, d = exe.run(eval_prog, feed={"lg": lg_out, "lb": fd["label"]},
                     fetch_list=[decoded, dist], scope=scope)
    if d.shape != (CTC_BATCH, 1) or not np.isfinite(d).all():
        fail(f"edit_distance gave {d.shape}, finite={np.isfinite(d).all()}")
    log(f"greedy decoding after {SEQ_STEPS} steps: decoded lengths "
        f"{int(dec.lens.min())}..{int(dec.lens.max())} (labels "
        f"{int(fd['label'].lens.min())}..{int(fd['label'].lens.max())}); "
        f"mean normalized edit distance {float(d.mean()):.4f}")
    return totals


def zipf_ranks(rng, n, size):
    """``size`` ranks in [0, n) with rank-frequency 1/rank^ZIPF_S."""
    import numpy as np
    p = 1.0 / np.arange(1, n + 1) ** ZIPF_S
    return rng.choice(n, size=size, p=p / p.sum())


def zipf_ids(rng, n, size):
    """``size`` ids of ``n`` with rank-frequency 1/rank^ZIPF_S, the ranks
    mapped to ids by a seeded permutation."""
    ranks = zipf_ranks(rng, n, size)
    return rng.permutation(n)[ranks]


def ctr_ids(rng):
    """Phase 10's CTR batch: CTR_BATCH examples, each with one value per
    Criteo field drawn by rank from that field's vocabulary, hashed
    (splitmix64 of field and value) into CTR_ROWS rows; field-major, as
    the sum of the fields' gradients orders them."""
    import numpy as np
    salt = np.uint64(rng.randint(1 << 31))
    out = []
    for f, vocab in enumerate(CRITEO_VOCABS):
        z = (np.uint64(f) << np.uint64(32)) \
            | zipf_ranks(rng, vocab, CTR_BATCH).astype(np.uint64)
        z = z ^ salt
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        out.append((z % np.uint64(CTR_ROWS)).astype(np.int64))
    return np.concatenate(out)


def build_word2vec(fluid, seed):
    """tests/book/test_word2vec.py at phase 11's widths, with
    SGD(W2V_LR, fused=True). Returns (main, startup, loss)."""
    from paddle_tpu_torch.testing.models import ngram_lm
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(f"w{i}", shape=[1], dtype="int64")
                 for i in range(W2V_N - 1)]
        nextw = fluid.layers.data("nextw", shape=[1], dtype="int64")
        predict = ngram_lm(words, W2V_DICT, W2V_EMB, W2V_HIDDEN)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(predict, nextw))
        fluid.optimizer.SGD(learning_rate=W2V_LR, fused=True).minimize(
            loss, startup)
    return main, startup, loss


def word2vec_feed(seed):
    """One batch of W2V_BATCH N-grams of Zipf-skewed word ids."""
    import numpy as np
    grams = zipf_ids(np.random.RandomState(seed + 11), W2V_DICT,
                     (W2V_BATCH, W2V_N)).astype("int64")
    feed = {f"w{i}": grams[:, i:i + 1] for i in range(W2V_N - 1)}
    feed["nextw"] = grams[:, W2V_N - 1:]
    return feed


def device_ms(torch, fn, reps=20):
    """Device time per call of ``fn`` by kernel name, {name: ms}, from
    torch.profiler over ``reps`` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            out[ev.key] = out.get(ev.key, 0.0) + dev_us / 1e3 / reps
    return out


def turns_ms(torch, fa, fb, rounds=5):
    """time_ms of ``fa`` and ``fb`` in turns (a b b a a b ...): the samples
    of each, in order, so the spread of single samples shows beside the
    one the kernels line keeps."""
    a, b = [], []
    for i in range(rounds):
        for f, out in ((fa, a), (fb, b)) if i % 2 == 0 else ((fb, b), (fa, a)):
            out.append(time_ms(f, torch))
    return a, b


def samples(xs):
    """``xs`` (ms) for a log line: the samples, then min / median / max."""
    m = sorted(xs)
    return (f"[{', '.join(f'{x:.4f}' for x in xs)}] (min {m[0]:.4f}, "
            f"median {m[len(m) // 2]:.4f}, max {m[-1]:.4f})")


def host_ms(torch, fn, reps=50):
    """Host time per call of ``fn``: the wall time of ``reps`` calls that
    only enqueue their work (no sync between them), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def split_device(times, kernel):
    """(ms of the kernels whose name holds ``kernel``, ms of the rest, the
    rest's names by time)."""
    mine = sum(v for k, v in times.items() if kernel in k)
    rest = sorted(((v, k) for k, v in times.items() if kernel not in k),
                  reverse=True)
    return mine, sum(v for v, _ in rest), [k[:60] for _, k in rest[:4]]


def hot_ids(rng):
    """Phase 10's hot-run call: HOT_RUN entries of one row among
    HOT_OTHERS uniform rows of the CTR table, with sentinel and negative
    entries, shuffled."""
    import numpy as np
    rows = np.concatenate([np.full(HOT_RUN, 7), rng.randint(
        0, CTR_ROWS, HOT_OTHERS), [CTR_ROWS, CTR_ROWS + 5, -1, -3] * 16])
    return rng.permutation(rows)


def phase_sparse_kernels(torch, fluid, seed, card):
    """embedding_sgd and sgd_arena against their plain versions, bitwise,
    then their times: per call (time_ms, one sample each, as the kernels
    line of every phase takes it), the host's enqueue, and the device time
    of the kernel and of the rest (the library sort) from the profiler;
    then the kernel and its library yardstick timed again in turns, 5
    samples each, for the spread. Returns {kernel: numbers for the kernels
    line}, at word2vec's shapes (the main path's)."""
    import numpy as np
    from paddle_tpu_torch.ops.cuda import embedding as embk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    rng = np.random.RandomState(seed + 10)
    lr = torch.full((1,), W2V_LR, device=dev)
    out = {}
    log(f"\n== phase 10: embedding_sgd vs embedding_sgd_torch, bitwise, "
        f"then times | {card} ==")
    n_w2v = (W2V_N - 1) * W2V_BATCH
    w2v_rows = zipf_ids(rng, W2V_DICT, n_w2v)
    w2v_rows[rng.choice(n_w2v, W2V_SENTINELS, replace=False)] = W2V_DICT
    # "CTR wide" is phase 22's wide table, width 1: the kernel's scalar
    # instantiation (one float a lane) on the sort path
    cases = [("word2vec", W2V_DICT, W2V_EMB, w2v_rows),
             ("CTR", CTR_ROWS, CTR_DIM, ctr_ids(rng)),
             ("hot run", CTR_ROWS, CTR_DIM, hot_ids(rng)),
             ("CTR wide", CTR_ROWS, 1, ctr_ids(rng))]
    for name, v, d, rows_np in cases:
        rows = torch.from_numpy(rows_np.astype("int64")).to(dev)
        real = rows_np[(rows_np >= 0) & (rows_np < v)]
        uniq, counts = np.unique(real, return_counts=True)
        n, u = len(rows_np), len(uniq)
        w = torch.randn((v, d), generator=gen, device=dev) * 0.05
        vals = torch.randn((n, d), generator=gen, device=dev) * 1e-3
        want = embk.embedding_sgd_torch(w, rows, vals, lr)
        got = embk.embedding_sgd(w.clone(), rows, vals, lr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            diff = (got - want).abs().max().item()
            fail(f"embedding_sgd at {name}'s shape differs from "
                 f"embedding_sgd_torch: max abs {diff:.3e}, want bitwise")
        untouched = torch.ones(v, dtype=torch.bool, device=dev)
        untouched[torch.from_numpy(uniq).to(dev)] = False
        if not torch.equal(got[untouched], w[untouched]):
            fail(f"embedding_sgd at {name}'s shape changed rows no entry "
                 "names")
        same = embk.embedding_sgd(w.clone(), torch.full_like(rows, v),
                                  vals, lr)
        torch.cuda.synchronize()
        if not torch.equal(same, w):
            fail(f"embedding_sgd at {name}'s shape: an all-sentinel call "
                 "changed the table")
        path = embk.sort_path(n, v)
        log(f"{name}: table [{v}, {d}], {n} entries ({n - len(real)} "
            f"sentinels or negative), {u} unique rows, longest run "
            f"{counts.max()}, path {path}: bitwise equal; all-sentinel call "
            "the identity; untouched rows unchanged")
        keep = torch.from_numpy(np.flatnonzero((rows_np >= 0)
                                               & (rows_np < v))).to(dev)
        lib_w = w.clone()
        lib_rows, lib_vals = rows[keep], vals[keep].contiguous()

        def call():
            embk.embedding_sgd(got, rows, vals, lr)

        def lib():
            lib_w.index_add_(0, lib_rows, lib_vals, alpha=-W2V_LR)

        t = dict(max_abs_err=0.0, ms=time_ms(call, torch),
                 plain_ms=time_ms(lambda: embk.embedding_sgd_torch(
                     w, rows, vals, lr), torch),
                 library_ms=time_ms(lib, torch))
        # bytes: each unique row read and written, each entry's values and
        # row index read
        t["bound_ms"], t["bound_by"] = bound_ms(0, 8 * u * d + 4 * n * d
                                                + 8 * n)
        kern, rest, names = split_device(device_ms(torch, call),
                                         "embedding_sgd")
        lib_dev = sum(device_ms(torch, lib).values())
        log(f"embedding_sgd at {name}'s shape per call: {t['ms']:.4f} ms "
            f"(host enqueue {host_ms(torch, call):.4f} ms; device: kernel "
            f"{kern:.4f} ms, sort and keys {rest:.4f} ms {names}), plain "
            f"{t['plain_ms']:.4f} ms, w.index_add_ on the kept entries "
            f"{t['library_ms']:.4f} ms (device {lib_dev:.4f} ms), bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}) | {card}")
        ka, la = turns_ms(torch, call, lib)
        log(f"embedding_sgd at {name}'s shape, in turns with index_add_: "
            f"per call {samples(ka)} ms; index_add_ {samples(la)} ms")
        if name == "word2vec":
            out["embedding_sgd"] = t
        del w, got, want, same, lib_w

    main, _, _ = build_word2vec(fluid, seed)
    rmain, _, _ = build_resnet50_train(fluid, seed)
    for name, prog in (("word2vec", main), ("ResNet-50", rmain)):
        params = [p for p in prog.global_block().all_parameters()
                  if p.trainable and p.name != "shared_w"]
        nelem = sum(_numel(p.shape) for p in params)
        ps = [torch.randn(p.shape, generator=gen, device=dev) * 0.05
              for p in params]
        gs = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3
              for p in params]
        want = opk.sgd_arena_torch(ps, gs, lr)
        before = opk.launches["sgd_arena"]
        got = opk.sgd_arena([p.clone() for p in ps], gs, lr)
        torch.cuda.synchronize()
        n_launch = opk.launches["sgd_arena"] - before
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            diff = max((a - b).abs().max().item() for a, b in zip(got, want))
            fail(f"sgd_arena over {name}'s parameters differs from "
                 f"sgd_arena_torch: max abs {diff:.3e}, want bitwise")
        lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
        for p, g in zip(lib_ps, gs):
            p.grad = g
        sgd = torch.optim.SGD(lib_ps, lr=W2V_LR, fused=True)

        def call():
            opk.sgd_arena(got, gs, lr)

        t = dict(max_abs_err=0.0, ms=time_ms(call, torch),
                 plain_ms=time_ms(lambda: opk.sgd_arena_torch(ps, gs, lr),
                                  torch),
                 library_ms=time_ms(sgd.step, torch))
        t["bound_ms"], t["bound_by"] = bound_ms(0, 12 * nelem)
        kern, _, _ = split_device(device_ms(torch, call), "sgd_arena")
        lib_dev = sum(device_ms(torch, sgd.step).values())
        log(f"sgd_arena over {name}'s {len(ps)} dense tensors ({nelem} "
            f"elements): bitwise equal, {n_launch} launch(es); per step "
            f"{t['ms']:.4f} ms (host enqueue {host_ms(torch, call):.4f} ms, "
            f"kernel device {kern:.4f} ms = "
            f"{t['bound_ms'] / kern if kern else 0:.1%} of the bound), "
            f"plain {t['plain_ms']:.4f} ms, SGD(fused=True) "
            f"{t['library_ms']:.4f} ms (host enqueue "
            f"{host_ms(torch, sgd.step):.4f} ms, device {lib_dev:.4f} ms), "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}) | {card}")
        ka, la = turns_ms(torch, call, sgd.step)
        log(f"sgd_arena over {name}'s set, in turns with SGD(fused=True): "
            f"per step {samples(ka)} ms; SGD(fused=True) {samples(la)} ms")
        if name == "word2vec":
            out["sgd_arena"] = t
    return out


def phase_word2vec(torch, fluid, seed, card):
    """Train the word2vec N-gram model 5 steps on one batch under both
    routes; hold step 1 of the kernel route to the same program with the
    plain-version wrappers (bitwise) and to the plain route (float32
    roundings of the unmerged scatter); returns the launches of each
    kernel on the kernel route."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import embedding as embk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    log(f"\n== phase 11: word2vec N-gram model, dict {W2V_DICT}, "
        f"{W2V_N - 1} context words, embedding {W2V_EMB}, hidden "
        f"{W2V_HIDDEN}, batch {W2V_BATCH}, SGD({W2V_LR}, fused=True), "
        f"{W2V_STEPS} steps on one batch ==")
    main, startup, loss = build_word2vec(fluid, seed)
    block = main.global_block()
    log("program: " + op_counts(block))
    update, = [op for op in block.ops if op.type == "fused_sgd"]
    params = update.input("Params")
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    feed = word2vec_feed(seed)
    ids = np.concatenate([feed[f"w{i}"].ravel() for i in range(W2V_N - 1)])
    uniq, counts = np.unique(ids, return_counts=True)
    log(f"batch: {len(ids)} context ids, {len(uniq)} distinct, the most "
        f"frequent {counts.max()} times")

    def run(route, scope):
        fluid.set_flags({"kernel_tier": route})
        try:
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
        return out[0]

    def state(scope):
        return {n: scope.find_var(n).clone() for n in params}

    counters = (("embedding_sgd", lambda: embk.launches["embedding_sgd"]),
                ("sgd_arena", lambda: opk.launches["sgd_arena"]),
                ("plain-routed tables",
                 lambda: tier.fallback_counts().get("embedding_sgd", 0)),
                ("plain-routed arenas",
                 lambda: tier.fallback_counts().get("optimizer", 0)))
    labels = [c[0] for c in counters]
    want = {"auto": (1, 1, 0, 0), "torch": (0, 0, 0, 0)}
    res = {}
    for route in ("auto", "torch"):
        scope = copy_scope(fluid, torch, init)
        losses, ms, total = [], [], [0] * len(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(W2V_STEPS):
            embk.reset_launches()
            opk.reset_launches()
            tier.reset_fallback_counts()
            t0 = time.perf_counter()
            lv = run(route, scope)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got = tuple(get() for _, get in counters)
            if got != want[route]:
                fail(f"word2vec, kernel_tier={route} step {step + 1}: "
                     f"{'/'.join(labels)} {got}, want {want[route]}")
            total = [a + c for a, c in zip(total, got)]
            if lv.shape != () or not torch.isfinite(lv).item():
                fail(f"word2vec, kernel_tier={route} step {step + 1}: loss "
                     f"{lv}")
            losses.append(lv.item())
            if step == 0:
                first = state(scope)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = sum(ms[1:]) / len(ms[1:])
        res[route] = dict(losses=losses, step1=first, total=total,
                          scope=scope)
        log(f"kernel_tier={route}: losses "
            + " ".join(f"{v:.7f}" for v in losses)
            + " | ms/step " + " ".join(f"{v:.2f}" for v in ms)
            + f" | steady {steady:.3f} ms/step, "
            f"{W2V_BATCH * 1e3 / steady:.1f} sequences/s | peak memory "
            f"{peak:.3f} GiB | {card}")

    # the reference: the same program with both wrappers swapped for their
    # plain versions
    swaps = ((embk, "embedding_sgd", embk.embedding_sgd_torch),
             (opk, "sgd_arena", opk.sgd_arena_torch))
    real = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    for m, a, plain in swaps:
        setattr(m, a, plain)
    try:
        ref_scope = copy_scope(fluid, torch, init)
        ref_loss = run("auto", ref_scope).item()
        ref = state(ref_scope)
    finally:
        for m, a, fn in real:
            setattr(m, a, fn)

    problems = []
    kernel = res["auto"]
    w0 = init.find_var("shared_w")
    # one float32 step at the table's largest magnitude: every rounding of
    # the two routes' updates happens at or below it
    ulp = (torch.nextafter(w0.abs().max(), torch.tensor(float("inf"),
                                                        device=w0.device))
           - w0.abs().max()).item()
    diffs = {n: (kernel["step1"][n] - ref[n]).abs().max().item()
             for n in params}
    log(f"step 1, kernel route vs plain-version wrappers: loss "
        f"{kernel['losses'][0]!r} vs {ref_loss!r}; max |Δ| per parameter "
        "(limit 0, bitwise): "
        + ", ".join(f"{n} {v:.3e}" for n, v in diffs.items()))
    if kernel["losses"][0] != ref_loss or any(diffs.values()):
        problems.append("word2vec step 1 is not bitwise the plain-version "
                        "wrappers' step")
    # the plain route adds each entry's −lr·v to its row one at a time (a
    # rounding at the row's magnitude per entry) where the kernel subtracts
    # lr times their sum once: up to (longest run + 1) float32 steps apart;
    # the dense parameters take the same expression on both routes
    limit = (counts.max() + 1) * ulp
    plain = res["torch"]["step1"]
    dw = (kernel["step1"]["shared_w"] - plain["shared_w"]).abs().max().item()
    dense = max((kernel["step1"][n] - plain[n]).abs().max().item()
                for n in params if n != "shared_w")
    log(f"step 1, kernel route vs kernel_tier=torch (unmerged scatter): "
        f"shared_w max |Δ| {dw:.3e} = {dw / ulp:.1f} float32 steps of "
        f"max|w| (limit {counts.max() + 1}); dense parameters max |Δ| "
        f"{dense:.3e} (limit 0)")
    if not dw <= limit or dense != 0:
        problems.append("word2vec step 1 on the kernel route is beyond the "
                        "limits against the plain route")
    fed = torch.zeros(W2V_DICT, dtype=torch.bool, device=w0.device)
    fed[torch.from_numpy(uniq).to(w0.device)] = True
    trained = kernel["scope"].find_var("shared_w")
    if not torch.equal(trained[~fed], w0[~fed]):
        problems.append("word2vec: table rows absent from the batch moved")
    moved = (trained[fed] - w0[fed]).abs().max().item()
    log(f"after {W2V_STEPS} steps: the {int((~fed).sum())} table rows "
        f"absent from the batch unchanged: "
        f"{torch.equal(trained[~fed], w0[~fed])}; max |Δ| of the "
        f"{len(uniq)} fed rows {moved:.3e}")

    # the check's own test: lr x PLANTED in the step's embedding_sgd launch
    good, calls = embk.embedding_sgd, [0]

    def planted(w, rows, vals, lr):
        calls[0] += 1
        return good(w, rows, vals, lr * PLANTED if calls[0] == 1 else lr)

    embk.embedding_sgd = planted
    try:
        bad_scope = copy_scope(fluid, torch, init)
        run("auto", bad_scope)
        bad = (bad_scope.find_var("shared_w") - ref["shared_w"]).abs().max() \
            .item()
    finally:
        embk.embedding_sgd = good
    log(f"planted fault: lr x{PLANTED} in the step's embedding_sgd launch: "
        f"shared_w max |Δ| {bad:.3e} = {bad / ulp:.1f} float32 steps "
        "(limit 0)")
    if calls[0] != 1 or not bad > 0:
        problems.append("word2vec: the bitwise check does not see a planted "
                        f"lr x{PLANTED} in embedding_sgd ({calls[0]} calls)")
    for route in ("auto", "torch"):
        losses = res[route]["losses"]
        if not losses[-1] < losses[0]:
            problems.append(f"word2vec, kernel_tier={route}: loss did not "
                            f"fall over {W2V_STEPS} steps: {losses}")
    if problems:
        fail("; ".join(problems))
    for route, title in (("auto", "kernel route"), ("torch", "plain route")):
        scope = copy_scope(fluid, torch, init)
        profile(torch, lambda: run(route, scope),
                f"word2vec: one training step, batch {W2V_BATCH}, {title}",
                card, reps=5)
    return dict(zip(labels, kernel["total"]))


def paged_operands(torch, gen, rng, s, h, d, bs, p, lens, spare):
    """One decode attend's operands on the card: q [s, h, d], K and V
    arenas of sum(ceil(len / bs)) + ``spare`` blocks, and each slot's blocks
    drawn without repeats from a random permutation of the arena (a
    fragmented arena, as an engine's free list leaves it); table entries
    past a slot's blocks are 0, as the engine pads them."""
    import numpy as np
    lens = np.asarray(lens, np.int64)
    nblk = -(-lens // bs)
    nb = int(nblk.sum()) + spare
    perm = rng.permutation(nb)
    bt = np.zeros((s, p), np.int32)
    o = 0
    for i in range(s):
        bt[i, :nblk[i]] = perm[o:o + nblk[i]]
        o += nblk[i]
    dev = torch.device("cuda", 0)
    qh = torch.randn((s, h, d), generator=gen, device=dev)
    kc = torch.randn((nb, bs, h, d), generator=gen, device=dev)
    vc = torch.randn((nb, bs, h, d), generator=gen, device=dev)
    return (qh, kc, vc, torch.from_numpy(bt).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


def paged_check(torch, pak, args, planted=False):
    """paged_attention_cuda against paged_attention_torch on ``args``:
    (max |Δ|, within atol + rtol·|plain| everywhere, inactive rows exact
    zeros). ``planted`` feeds the kernel q x PLANTED, which scales every
    score by PLANTED as a wrong scale would."""
    want = pak.paged_attention_torch(*args)
    got = pak.paged_attention_cuda(
        *((args[0] * PLANTED,) + tuple(args[1:]) if planted else args))
    torch.cuda.synchronize()
    err = (got - want).abs()
    within = bool((err <= PA_ATOL + PA_RTOL * want.abs()).all())
    zeros = bool((got[args[4] == 0] == 0).all())
    return err.max().item(), within, zeros


def paged_library(torch, qh, kc, vc, bt, cl):
    """The yardstick, never on the path: the gather of every table row's
    context (index_select) and F.scaled_dot_product_attention under the
    length mask (idle rows see position 0, so nothing is NaN)."""
    import torch.nn.functional as F
    nb, bs, h, d = kc.shape
    s, p = bt.shape
    idx = (bt.long()[:, :, None] * bs
           + torch.arange(bs, device=bt.device)).reshape(-1)
    k = kc.view(nb * bs, h, d).index_select(0, idx).view(s, p * bs, h, d)
    v = vc.view(nb * bs, h, d).index_select(0, idx).view(s, p * bs, h, d)
    live = torch.arange(p * bs, device=bt.device)[None, :] \
        < cl.clamp(min=1)[:, None]
    return F.scaled_dot_product_attention(
        qh[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=live[:, None, None, :])


def paged_bytes(args):
    """Bytes the function must move: each live K and V row read once, q
    read and out written (block tables and lengths aside)."""
    qh, _, _, _, cl = args
    s, h, d = qh.shape
    return 2 * int(cl.sum().item()) * h * d * 4 + 2 * s * h * d * 4


def phase_paged_kernels(torch, fluid, seed, card):
    """paged_attention against its plain version at the lane's geometry,
    the reference test's three shapes, shapes whose lengths fall on and
    around partition boundaries, and two Llama-2-7B decode shapes (random
    contexts, and every slot at 4096); a planted scale fault; times,
    bounds and the library yardstick. Returns the numbers for the kernels
    line: the lane's geometry (the main path's), with the Llama shapes'
    times and bounds under their own keys."""
    import numpy as np
    from paddle_tpu_torch.ops.cuda import paged_attention as pak

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    rng = np.random.RandomState(seed + 12)
    log(f"\n== phase 12: paged_attention vs paged_attention_torch "
        f"(atol {PA_ATOL}, rtol {PA_RTOL}), then times | {card} ==")
    p_lane = GEN_MAX_LEN // GEN_BLOCK
    # ragged, 2 idle rows, a multiple of the block size, and a full table
    lane_lens = [0, 1, 5, GEN_BLOCK, 23, 31, p_lane * GEN_BLOCK, 0]
    used = sum(-(-n // GEN_BLOCK) for n in lane_lens)
    lane = paged_operands(torch, gen, rng, GEN_MAX_SEQS, GEN_HEADS,
                          GEN_EMB // GEN_HEADS, GEN_BLOCK, p_lane,
                          lane_lens, GEN_BLOCKS - used)
    cases = [("lane", lane)]
    # tests/test_paged_attention_pallas.py:97's shapes, drawn as it draws
    # them (tables with repeats, lengths 0..P·bs)
    for i, (s, h, d, nb, bs, p) in enumerate(
            [(4, 2, 8, 8, 4, 2), (8, 4, 16, 32, 8, 4), (2, 1, 4, 4, 2, 2)]):
        r = np.random.RandomState(seed + i)
        arrs = [r.normal(0, 1, (s, h, d)), r.normal(0, 1, (nb, bs, h, d)),
                r.normal(0, 1, (nb, bs, h, d))]
        arrs = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
        bt = torch.from_numpy(r.randint(0, nb, (s, p)).astype(np.int32))
        cl = torch.from_numpy(r.randint(0, p * bs + 1, s).astype(np.int32))
        cases.append((f"reference shape {i}", (*arrs, bt.to(dev),
                                               cl.to(dev))))
    # lengths on, just before and just after partition boundaries, one
    # position, an idle slot, and slots whose later table entries'
    # partitions lie wholly past their length (Llama's heads and blocks,
    # 8 slots); then an odd head dim (scalar loads) at the same lengths
    p_big = PA_CTX // PA_BLOCK
    part = pak.part_blocks(PA_BLOCK) * PA_BLOCK
    edge_lens = [part, 2 * part, part - 1, part + 1, 1, 0, 3 * part + 5,
                 PA_CTX]
    for d in (PA_DIM, 36, 33):
        cases.append((f"partition edges, D {d}", paged_operands(
            torch, gen, rng, len(edge_lens), 8, d, PA_BLOCK, p_big,
            edge_lens, 16)))
    big_lens = rng.randint(1, PA_CTX + 1, PA_SLOTS)
    big_lens[rng.choice(PA_SLOTS, 2, replace=False)] = 0
    big = paged_operands(torch, gen, rng, PA_SLOTS, PA_HEADS, PA_DIM,
                         PA_BLOCK, p_big, big_lens, 64)
    cases.append(("Llama-2-7B decode", big))
    problems = []
    for name, args in cases:
        err, within, zeros = paged_check(torch, pak, args)
        qh, kc, _, bt, cl = args
        log(f"{name}: q {tuple(qh.shape)}, arena {tuple(kc.shape)}, "
            f"tables {tuple(bt.shape)} (nsplit "
            f"{pak.paged_attention_nsplit(bt.shape[1], kc.shape[1])}), "
            f"lengths sum {int(cl.sum())} (max {int(cl.max())}, "
            f"{int((cl == 0).sum())} idle): max |Δ| {err:.3e}, within the "
            f"limit {within}, idle rows zero {zeros}")
        if not (within and zeros):
            problems.append(f"paged_attention at {name}")
    # the check's own test: the scale x PLANTED
    for name, args in (("lane", lane), ("Llama-2-7B decode", big)):
        err, within, _ = paged_check(torch, pak, args, planted=True)
        log(f"planted fault at {name}: scale x{PLANTED}: max |Δ| "
            f"{err:.3e}, within the limit {within}")
        if within:
            problems.append(f"the check does not see scale x{PLANTED} at "
                            f"{name}")
    if problems:
        fail("; ".join(problems))
    del cases
    out = {}
    lane_t = paged_times(torch, pak, "lane", lane)
    big_t = paged_times(torch, pak, "Llama-2-7B decode", big)
    del big
    torch.cuda.empty_cache()
    # every slot at the full context: ~4.3 GB of arena, no ragged tail, so
    # its time against the random lengths' separates the tail from each
    # CTA's bandwidth
    full = paged_operands(torch, gen, rng, PA_SLOTS, PA_HEADS, PA_DIM,
                          PA_BLOCK, p_big, [PA_CTX] * PA_SLOTS, 64)
    err, within, _ = paged_check(torch, pak, full)
    log(f"Llama-2-7B decode, all {PA_SLOTS} slots at {PA_CTX}: arena "
        f"{tuple(full[1].shape)} x 2: max |Δ| {err:.3e}, within the limit "
        f"{within}")
    if not within:
        fail(f"paged_attention at {PA_SLOTS} slots of {PA_CTX}")
    err, within, _ = paged_check(torch, pak, full, planted=True)
    log(f"planted fault at {PA_SLOTS} slots of {PA_CTX}: scale "
        f"x{PLANTED}: max |Δ| {err:.3e}, within the limit {within}")
    if within:
        fail(f"the check does not see scale x{PLANTED} at {PA_SLOTS} slots "
             f"of {PA_CTX}")
    full_t = paged_times(torch, pak, f"all {PA_CTX}", full)
    del full
    torch.cuda.empty_cache()
    out["paged_attention"] = dict(
        lane_t, llama_ms=big_t["ms"], llama_bound_ms=big_t["bound_ms"],
        llama_4096_ms=full_t["ms"], llama_4096_bound_ms=full_t["bound_ms"])
    return out


def kernel_name(key):
    """A profiler key's kernel name without its namespace, template
    arguments and parameters: "paged_attention_kernel"."""
    import re
    m = re.search(r"(\w+)(<[^()]*>)?\(", key)
    return m.group(1) if m else key[:40]


def paged_times(torch, pak, name, args):
    """One shape's numbers: the kernel's time (time_ms), its plain
    version's and the library yardstick's, the bound, the achieved GB/s,
    nsplit and PART, wrapper launches and device kernels a call (profiler),
    logged; returns the kernels line's keys."""
    nbytes = paged_bytes(args)

    def call():
        pak.paged_attention_cuda(*args)

    t = dict(max_abs_err=paged_check(torch, pak, args)[0],
             ms=time_ms(call, torch),
             plain_ms=time_ms(lambda: pak.paged_attention_torch(*args),
                              torch),
             library_ms=time_ms(lambda: paged_library(torch, *args), torch))
    # operations: q·k and the weighted v sum, 4 flops per element of the
    # live context, against float32's peak
    ops = 4 * int(args[4].sum().item()) * args[0].shape[1] \
        * args[0].shape[2]
    t["bound_ms"], t["bound_by"] = bound_ms(ops, nbytes)
    bs, p = args[1].shape[1], args[3].shape[1]
    before = pak.launches["paged_attention"]
    call()
    torch.cuda.synchronize()
    wrapper = pak.launches["paged_attention"] - before
    kernels = {kernel_name(k): v for k, v in
               device_ms(torch, call, reps=10).items()
               if "paged_attention" in k}
    log(f"paged_attention at {name} per call: kernel {t['ms']:.4f} ms "
        f"({nbytes / t['ms'] / 1e6:.1f} GB/s, "
        f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound), plain "
        f"{t['plain_ms']:.4f} ms, gather + scaled_dot_product_attention "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
        f"({t['bound_by']}, {nbytes} bytes); nsplit "
        f"{pak.paged_attention_nsplit(p, bs)}, PART {pak.PART} (partitions "
        f"of {pak.part_blocks(bs) * bs} positions); {wrapper} wrapper "
        f"launch(es) and {len(kernels)} device kernel(s) a call: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in kernels.items()))
    return t


def gen_lane(eng, continuous):
    """The lane's traffic through a ContinuousBatcher over ``eng``: one
    thread per client, each sending its requests one after another and
    draining each stream. Returns the tokens per (client, request), the
    TTFTs (submit to first token, seconds), the wall time and the
    batcher's step count."""
    import threading
    from paddle_tpu_torch.serving import ContinuousBatcher

    want = [[GEN_LENS[(3 * i + 5 * j) % len(GEN_LENS)]
             for j in range(GEN_PER_CLIENT)] for i in range(GEN_CLIENTS)]
    toks = [[None] * GEN_PER_CLIENT for _ in range(GEN_CLIENTS)]
    ttft, errs = [], []
    batcher = ContinuousBatcher(eng, continuous=continuous)
    barrier = threading.Barrier(GEN_CLIENTS + 1)

    def client(i):
        barrier.wait()
        try:
            for j, n in enumerate(want[i]):
                t0 = time.perf_counter()
                got = []
                for t in batcher.submit([1 + i, 2 + j, 3], n):
                    if not got:
                        ttft.append(time.perf_counter() - t0)
                    got.append(t)
                toks[i][j] = got
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(GEN_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    steps = batcher.stats()["steps"]
    if not batcher.close():
        fail("generation: the ContinuousBatcher's worker did not stop")
    if errs:
        fail(f"generation lane clients failed: {errs[:2]}")
    counts = [[len(t) for t in per] for per in toks]
    if counts != want:
        fail(f"generation lane token counts {counts}, want {want}")
    return dict(tokens=toks, ttft=ttft, elapsed=elapsed, steps=steps)


def gen_drain(eng, prompt, n, sampling=None):
    handle, toks, fin = eng.start(prompt, n, sampling)
    toks = list(toks)
    while not fin:
        for h, ts, f in eng.step():
            if h is handle:
                toks += ts
                fin = f
    return toks


def phase_generation(torch, fluid, seed, card):
    """Serve the decoder LM at the lane's geometry through GenerationEngine
    and ContinuousBatcher on the kernel route and under
    kernel_tier=torch. Returns the kernel's launches on the main path (the
    kernel route's continuous lane)."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.testing.models import export_tiny_lm

    n_tokens = sum(GEN_LENS[(3 * i + 5 * j) % len(GEN_LENS)]
                   for i in range(GEN_CLIENTS)
                   for j in range(GEN_PER_CLIENT))
    log(f"\n== phase 13: decoder LM (vocab {GEN_VOCAB}, emb {GEN_EMB}, "
        f"{GEN_HEADS} heads, {GEN_LAYERS} layers) served through "
        f"GenerationEngine + ContinuousBatcher: {GEN_CLIENTS} clients x "
        f"{GEN_PER_CLIENT} requests, {n_tokens} tokens, greedy | {card} ==")
    d = tempfile.mkdtemp(prefix="chip-smoke-lm-")
    fluid.reset_unique_name()
    main, _, _ = export_tiny_lm(d, vocab=GEN_VOCAB, emb=GEN_EMB,
                                heads=GEN_HEADS, n_layers=GEN_LAYERS,
                                max_pos=GEN_MAX_POS, seed=GEN_SEED + seed)
    log("program: " + op_counts(main.global_block()))
    geom = dict(max_seqs=GEN_MAX_SEQS, block_size=GEN_BLOCK,
                num_blocks=GEN_BLOCKS, max_len=GEN_MAX_LEN)

    def engine(**kw):
        eng = GenerationEngine(d, **{**geom, "prefill_buckets": (8,), **kw})
        warmed = eng.warmup()
        if eng.device.type != "cuda":
            fail(f"GenerationEngine runs on {eng.device}, want the card")
        return eng, warmed

    res, problems = {}, []
    for route in ("auto", "torch"):
        fluid.set_flags({"kernel_tier": route})
        try:
            eng, warmed = engine()
            want_launch = GEN_LAYERS if route == "auto" else 0
            for continuous in (True, False):
                decodes0 = eng.stats()["phases"]["decode"][GEN_MAX_SEQS][
                    "dispatches"]
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                arena = list(eng.cache.k) + list(eng.cache.v)
                pak.reset_launches()
                tier.reset_fallback_counts()
                lane = gen_lane(eng, continuous)
                torch.cuda.synchronize()
                if any(a is not b for a, b in
                       zip(arena, list(eng.cache.k) + list(eng.cache.v))):
                    problems.append(f"kernel_tier={route}: the arena was "
                                    "copied, not updated in place")
                launches = pak.launches["paged_attention"]
                fallbacks = tier.fallback_counts()
                decodes = eng.stats()["phases"]["decode"][GEN_MAX_SEQS][
                    "dispatches"] - decodes0
                lane.update(launches=launches, decodes=decodes,
                            peak=(torch.cuda.max_memory_allocated() - base)
                            / 2 ** 20)
                mem = eng.stats()["memory"]
                resident = (mem["arena_bytes"] + mem["param_bytes"]) \
                    / 2 ** 20
                mode = "continuous" if continuous else "gang"
                res[(route, mode)] = lane
                ttft = np.asarray(lane["ttft"]) * 1e3
                log(f"kernel_tier={route}, {mode}: {n_tokens} tokens in "
                    f"{lane['elapsed'] * 1e3:.1f} ms, "
                    f"{n_tokens / lane['elapsed']:.1f} tokens/s; "
                    f"{decodes} decode dispatches "
                    f"({lane['elapsed'] * 1e3 / decodes:.3f} ms of wall time "
                    f"each, prefills included), TTFT p50 {np.percentile(ttft, 50):.2f} "
                    f"p99 {np.percentile(ttft, 99):.2f} ms; paged_attention "
                    f"launches {launches}, fallbacks {fallbacks}; peak "
                    f"memory above the engine's {resident:.1f} MiB (arena "
                    f"and parameters) {lane['peak']:.1f} MiB")
                if launches != want_launch * decodes or fallbacks:
                    problems.append(
                        f"kernel_tier={route} {mode}: {launches} "
                        f"paged_attention launches over {decodes} decode "
                        f"dispatches (want {want_launch} each), fallbacks "
                        f"{fallbacks}")
            # decode logits of one request, for the cross-route check
            seen = []
            real = eng._sample

            def sample(seq, logits, seen=seen, real=real):
                seen.append(np.array(logits))
                return real(seq, logits)

            eng._sample = sample
            gen_drain(eng, [1, 2, 3], 28)
            eng._sample = real
            res[(route, "logits")] = np.stack(seen)
            # one decode step with every slot busy: its time and profile
            for i in range(GEN_MAX_SEQS):
                eng.start([1 + i, 2, 3], GEN_MAX_LEN - 3)
            profile(torch, eng.step, f"one decode step, {GEN_MAX_SEQS} "
                    f"slots busy, kernel_tier={route}", card, reps=5)
            ms = []
            for _ in range(20):
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            res[(route, "step_ms")] = float(np.mean(ms))
            log(f"kernel_tier={route}: decode step with {GEN_MAX_SEQS} slots "
                f"busy {np.mean(ms):.3f} ms (min {np.min(ms):.3f}, 20 "
                f"steps, host clock with a sync)")
            for h in list(eng._slots):
                if h is not None:
                    eng.abort(h)
            if route == "auto":
                # continuous = sequential on the kernel route
                cont = res[(route, "continuous")]["tokens"]
                seq_toks = [[gen_drain(eng, [1 + i, 2 + j, 3], len(t))
                             for j, t in enumerate(per)]
                            for i, per in enumerate(cont)]
                res["sequential"] = seq_toks
        finally:
            fluid.set_flags({"kernel_tier": "auto"})

    kc, kg = res[("auto", "continuous")], res[("auto", "gang")]
    tc = res[("torch", "continuous")]
    same_routes = kc["tokens"] == tc["tokens"]
    gang_same = kg["tokens"] == kc["tokens"]
    seq_same = res["sequential"] == kc["tokens"]
    lg_k, lg_t = res[("auto", "logits")], res[("torch", "logits")]
    dlog = float(np.abs(lg_k - lg_t).max() / np.abs(lg_t).max())
    log(f"greedy tokens: kernel route = kernel_tier=torch {same_routes}; "
        f"gang = continuous {gang_same}; continuous = sequential "
        f"{seq_same}; decode logits of a 28-token request, max |Δ| / "
        f"max |logit| {dlog:.3e} (limit {GEN_LOGIT_LIMIT})")
    if not (same_routes and gang_same and seq_same):
        problems.append("generation token streams differ between routes "
                        "or scheduling modes")
    if not dlog <= GEN_LOGIT_LIMIT:
        problems.append(f"decode logits differ between routes by {dlog:.3e}"
                        " of the largest")
    for route in ("auto", "torch"):
        c, g = res[(route, "continuous")], res[(route, "gang")]
        log(f"kernel_tier={route}: continuous {c['elapsed'] * 1e3:.1f} ms "
            f"({c['decodes']} decode dispatches) vs gang "
            f"{g['elapsed'] * 1e3:.1f} ms ({g['decodes']}): "
            f"{g['elapsed'] / c['elapsed']:.2f}x")

    # cached prefix and chunked prefill against cold, on the kernel route
    system = [(5 + 3 * t) % GEN_VOCAB for t in range(GEN_SYSTEM)]
    prompts = [system + [(1 + i + t) % GEN_VOCAB for t in range(GEN_SUFFIX)]
               for i in range(GEN_MAX_SEQS)]

    def batch(eng):
        from paddle_tpu_torch.serving import ContinuousBatcher
        b = ContinuousBatcher(eng)
        streams = [b.submit(p, GEN_PREFIX_NEW) for p in prompts]
        out = [list(s) for s in streams]
        if not b.close():
            fail("generation: the ContinuousBatcher's worker did not stop")
        return out

    pak.reset_launches()
    tier.reset_fallback_counts()
    cold = batch(engine(prefill_buckets=(8, 32))[0])
    cached_eng, warmed = engine(prefill_buckets=(8, 32),
                                prefix_cache_blocks=64)
    primed = batch(cached_eng)
    hits0 = cached_eng.cache.prefix_hits
    cached = batch(cached_eng)
    hits = cached_eng.cache.prefix_hits - hits0
    chunk_eng, _ = engine(prefill_buckets=(8, 32), prefill_chunk=GEN_CHUNK)
    chunked = batch(chunk_eng)
    log(f"{len(prompts)} prompts of a {GEN_SYSTEM}-token system prompt + "
        f"{GEN_SUFFIX} tokens, {GEN_PREFIX_NEW} new each: cached-prefix "
        f"engine warmed {warmed} (phase, bucket) pairs; cold pass on it = "
        f"cold {primed == cold}; cached pass ({hits} prefix blocks "
        f"attached) = cold {cached == cold}; chunked (chunks of "
        f"{GEN_CHUNK}, {chunk_eng.stats()['phases']['chunk']}) = cold "
        f"{chunked == cold}; fallbacks {tier.fallback_counts()}")
    if not (primed == cold and cached == cold and chunked == cold) \
            or hits == 0 or tier.fallback_counts():
        problems.append("prefix-cached or chunked token streams differ from "
                        "cold ones (or nothing was attached)")
    if problems:
        fail("; ".join(problems))
    ttft = np.asarray(kc["ttft"]) * 1e3
    return kc["launches"], dict(
        dir=d, tokens=kc["tokens"], tokens_per_s=n_tokens / kc["elapsed"],
        ttft_p50=float(np.percentile(ttft, 50)),
        ttft_p99=float(np.percentile(ttft, 99)))


def is_plain_json(obj):
    """Builtins only, all the way down (dict keys str or int), and
    json.dumps takes it: what a client of either package unpickles without
    torch."""
    if isinstance(obj, dict):
        return all(type(k) in (str, int) and is_plain_json(v)
                   for k, v in obj.items())
    if isinstance(obj, list):
        return all(is_plain_json(v) for v in obj)
    return obj is None or type(obj) in (str, int, float, bool)


def run_clients(address, client_cls, fn, n=SRV_CLIENTS):
    """``fn(i, client)`` in ``n`` threads, each with its own client, all
    released at once; returns the wall time from the release to the last
    join."""
    import threading
    errs = []
    barrier = threading.Barrier(n + 1)

    def worker(i):
        try:
            with client_cls(address) as c:
                barrier.wait(60)
                fn(i, c)
        except Exception as e:
            errs.append(f"client {i}: {type(e).__name__}: {e}")
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    try:
        barrier.wait(60)
    except threading.BrokenBarrierError:
        pass
    t0 = time.perf_counter()
    for t in threads:
        t.join(300)
    elapsed = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        fail(f"serving clients failed: {errs[:3]}")
    return elapsed


def conv_bucket_check(torch, cbk, program, buckets, seed):
    """conv_affine at each smaller bucket against the same rows inside the
    largest bucket, on every distinct kernel-routed conv of the served
    program (float32, the served dtype). Returns the (geometry, bucket)
    pairs that were not bitwise equal, the number of pairs checked, and
    whether a planted fault (the rows shifted by one) was caught."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 142)
    top = buckets[-1]
    keys = [k for k in fused_conv_shapes(None, program, top)
            if kernel_routed(cbk, k)]
    moved, checked, planted = [], 0, None
    for x_shape, w_shape, strides, paddings, _, _, act in keys:
        cout, cin, kh, kw = w_shape
        x = torch.randn(x_shape, generator=gen, device=dev)
        w = torch.randn(w_shape, generator=gen, device=dev) \
            * (2.0 / (cin * kh * kw)) ** 0.5
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        y = cbk.conv_affine(x, w, a, b, strides, paddings, act)
        for n in buckets[:-1]:
            yn = cbk.conv_affine(x[:n], w, a, b, strides, paddings, act)
            checked += 1
            if not torch.equal(yn, y[:n]):
                moved.append((x_shape[1:], w_shape, strides, n))
            if planted is None:
                planted = not torch.equal(yn, y[1:n + 1])
    return moved, checked, planted


def op_drift(torch, fluid, cbk, model_dir, buckets, seed):
    """Which ops of the served forward move a request's rows when its
    bucket grows. The bundle, loaded anew on the card, runs the largest
    bucket's rows and, for each smaller bucket, its first rows alone,
    fetching every op's outputs; an op whose output rows differ while all
    its inputs' rows agree is where a drift starts. Returns {bucket:
    (ops whose outputs moved, [sources as "label@op index"])} and the
    number of ops."""
    import numpy as np
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    program, feeds, _ = fluid.io.load_inference_model(model_dir, exe,
                                                      scope=scope)
    block = program.global_block()
    names = list(dict.fromkeys(n for op in block.ops
                               for n in op.output_arg_names()))
    top = buckets[-1]
    x = np.random.RandomState(seed + 141).normal(
        0, 1, (top, IMAGE, IMAGE, 3)).astype("float32")

    def run(rows):
        outs = exe.run(program, feed={feeds[0]: rows}, fetch_list=names,
                       scope=scope, return_numpy=False)
        return dict(zip(names, outs))

    def label(op):
        if op.type != "fused_conv2d_bn":
            return op.type
        key = conv_key(block, op, top)
        return "conv_affine" if kernel_routed(cbk, key) else \
            f"plain conv {key[1][2]}x{key[1][3]}/{key[2][0]}"

    big = run(x)
    drift = {}
    for b in buckets[:-1]:
        small = run(x[:b])
        agree = {}

        def rows_agree(n):
            if n not in agree:
                s, t = small.get(n), big.get(n)
                if not isinstance(s, torch.Tensor) \
                        or not isinstance(t, torch.Tensor):
                    agree[n] = True      # a feed or a parameter
                elif s.dim() and s.shape[0] == b and t.shape[0] == top:
                    agree[n] = torch.equal(s, t[:b])
                else:
                    agree[n] = s.shape != t.shape or torch.equal(s, t)
            return agree[n]

        moved, sources = 0, []
        for k, op in enumerate(block.ops):
            if all(rows_agree(n) for n in op.output_arg_names()):
                continue
            moved += 1
            if all(rows_agree(n) for n in op.input_arg_names()):
                sources.append(f"{label(op)}@{k}")
        drift[b] = (moved, sources)
        del small
    return drift, len(block.ops)


def phase_front_door(torch, fluid, seed, card, serving, gen):
    """Serve phase 3's ResNet-50 bundle and phase 13's decoder LM through
    ModelServer over the framed RPC codec on the card. Returns the
    conv_affine and paged_attention launches of its main paths (the
    8-client ResNet-50 run and the LM lane)."""
    import hashlib
    import threading
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    from paddle_tpu_torch.serving import GenClient, InferClient, ModelServer

    log(f"\n== phase 14: serving over RPC: ResNet-50 (phase 3's bundle) "
        f"behind ModelServer, {SRV_CLIENTS} InferClients x "
        f"{SRV_PER_CLIENT} requests of 1-{SRV_MAX_ROWS} images; the LM "
        f"lane (phase 13's bundle) behind a generative ModelServer, "
        f"{GEN_CLIENTS} GenClients x {GEN_PER_CLIENT} | {card} ==")
    problems = []
    summary = {}
    t_phase = t0 = time.perf_counter()
    server = ModelServer(serving["dir"], batching=True)
    server.start()
    eng = server.engine
    health = server.health()
    log(f"ModelServer on {eng.device}, buckets {eng.buckets}: load and "
        f"warmup {time.perf_counter() - t0:.2f} s; health "
        f"{json.dumps(health)}")
    if eng.device.type != "cuda" or not health["warmed"]:
        fail(f"the ModelServer's engine runs on {eng.device}, warmed "
             f"{health['warmed']}: want the card, warmed")

    rng = np.random.RandomState(seed + 14)
    sizes = rng.randint(1, SRV_MAX_ROWS + 1, (SRV_CLIENTS, SRV_PER_CLIENT))
    feeds = [[rng.normal(0, 1, (n, IMAGE, IMAGE, 3)).astype("float32")
              for n in row] for row in sizes]
    n_req = SRV_CLIENTS * SRV_PER_CLIENT

    # every coalesced dispatch the batcher makes, with the engine's reply
    dispatches = []
    real_infer = eng.infer

    def spy(feed, fetch_list=None):
        out = real_infer(feed, fetch_list)
        dispatches.append((feed["img"], out[0]))
        return out

    eng.infer = spy
    replies = [[None] * SRV_PER_CLIENT for _ in range(SRV_CLIENTS)]

    def mixed(i, c):
        for j in range(SRV_PER_CLIENT):
            replies[i][j], = c.infer({"img": feeds[i][j]})

    st0 = server.stats()
    torch.cuda.synchronize()
    cbk.reset_launches()
    tier.reset_fallback_counts()
    elapsed = run_clients(server.address, InferClient, mixed)
    launches = cbk.launches["conv_affine"]
    fallbacks = tier.fallback_counts().get("conv_bn", 0)
    eng.infer = real_infer
    st1 = server.stats()
    n_disp = len(dispatches)
    batches = st1["batcher"]["batches"] - st0["batcher"]["batches"]
    engine_disp = st1["engine"]["dispatches"] - st0["engine"]["dispatches"]
    hist = {k: v - st0["batcher"]["batch_size_hist"].get(k, 0)
            for k, v in st1["batcher"]["batch_size_hist"].items()}
    hist = {k: v for k, v in sorted(hist.items()) if v}
    n_rows = int(sizes.sum())
    log(f"main path: {n_req} requests ({n_rows} images) in "
        f"{elapsed * 1e3:.1f} ms; {n_disp} engine dispatches (batcher "
        f"batches {batches}, engine dispatches {engine_disp}), rows per "
        f"dispatch {hist}; conv_affine launches {launches}, plain-routed "
        f"fused convs {fallbacks}; hot recompiles "
        f"{st1['engine']['hot_recompiles']}")
    if not (n_disp == batches == engine_disp) or not n_disp < n_req:
        problems.append(f"{n_disp} dispatches ({batches} batches, "
                        f"{engine_disp} engine dispatches) for {n_req} "
                        "requests: no coalescing")
    if launches != KERNEL_CONVS * n_disp or fallbacks != PLAIN_CONVS * n_disp:
        problems.append(f"conv_affine launched {launches} times and "
                        f"{fallbacks} convs took the plain chain in {n_disp} "
                        f"dispatches, want {KERNEL_CONVS} and {PLAIN_CONVS} "
                        "each")
    if st1["engine"]["hot_recompiles"]:
        problems.append("the warmed engine counted hot recompiles")

    # do a request's rows depend on the bucket? conv_affine alone, then
    # every op of the served forward: the replies below must be bitwise
    # wherever no op starts a drift between their two buckets
    moved, checked, planted = conv_bucket_check(
        torch, cbk, eng.program, eng.buckets, seed)
    log(f"conv_affine across buckets: {checked - len(moved)} of {checked} "
        f"(geometry, bucket) pairs bitwise the same rows inside bucket "
        f"{eng.buckets[-1]}; planted fault (rows shifted by one) caught: "
        f"{planted}")
    if moved or not planted:
        problems.append(f"conv_affine's rows depend on the bucket: "
                        f"{moved[:3]} (planted caught {planted})")
    drift, n_ops = op_drift(torch, fluid, cbk, serving["dir"], eng.buckets,
                            seed)
    log(f"ops whose outputs move a request's rows against bucket "
        f"{eng.buckets[-1]} (of {n_ops}), and where each drift starts: "
        + "; ".join(f"bucket {b}: {m}, {src or 'none'}"
                    for b, (m, src) in drift.items()))
    if any(src.startswith("conv_affine@")
           for _, srcs in drift.values() for src in srcs):
        problems.append("a kernel-routed conv starts a drift between "
                        "buckets")
    summary["conv_bucket_pairs"] = [checked - len(moved), checked]
    summary["drift_sources"] = {b: src for b, (_, src) in drift.items()}

    # each request's rows in the dispatch that carried them, and how many
    # requests each dispatch carried
    def key(row):
        return hashlib.sha1(row).digest()

    where = {}
    for k, (x, _) in enumerate(dispatches):
        for r in range(len(x)):
            where[key(x[r])] = (k, r)
    firsts = {key(f[0]) for row in feeds for f in row}
    per_dispatch = [sum(key(r) in firsts for r in x) for x, _ in dispatches]
    counts = {"same bucket": 0, "other bucket": 0, "drifting": 0,
              "bitwise": 0}
    loose = []    # (request size, dispatch rows) of the replies not bitwise
    worst, planted_caught, planted_done = 0.0, None, False

    def check(y, served, solo, exact):
        """None, or what is wrong with reply ``y``: it must be bitwise the
        engine's reply in the dispatch that served it, and the in-process
        engine's solo reply for the same rows: bitwise where ``exact`` (the
        same bucket, or two buckets between which no op starts a drift),
        else within SRV_REL_LIMIT."""
        if y.shape != solo.shape or not np.isfinite(y).all():
            return f"shape {y.shape}, finite {np.isfinite(y).all()}"
        if not np.array_equal(y, served):
            return "differs from its dispatch's rows"
        if exact:
            return None if np.array_equal(y, solo) else \
                "not bitwise the solo reply where no op drifts"
        rel = float(np.abs(y - solo).max() / np.abs(solo).max())
        return None if rel <= SRV_REL_LIMIT else f"rel err {rel:.3e}"

    for i in range(SRV_CLIENTS):
        for j in range(SRV_PER_CLIENT):
            x, y = feeds[i][j], replies[i][j]
            n = len(x)
            k, o = where.get(key(x[0]), (None, None))
            if k is None or not np.array_equal(dispatches[k][0][o:o + n], x):
                problems.append(f"request ({i}, {j}): its rows are not in "
                                "one dispatch")
                continue
            served = dispatches[k][1][o:o + n]
            solo, = real_infer({"img": x})
            pair = (eng.bucket_for(n), eng.bucket_for(len(dispatches[k][0])))
            same = pair[0] == pair[1]
            exact = same or not any(drift.get(b, (0, []))[1] for b in pair)
            counts["same bucket" if same else "other bucket"] += 1
            counts["drifting"] += int(not exact)
            counts["bitwise"] += int(np.array_equal(y, solo))
            if not np.array_equal(y, solo):
                loose.append((n, len(dispatches[k][0])))
            worst = max(worst, float(np.abs(y - solo).max()
                                     / np.abs(solo).max()))
            if np.abs(y.sum(axis=1) - 1).max() > 1e-4:
                problems.append(f"request ({i}, {j}): softmax rows do not "
                                "sum to 1")
            bad = check(y, served, solo, exact)
            if bad:
                problems.append(f"request ({i}, {j}) of {n} images: {bad}")
            if n >= 2 and not planted_done:
                # planted fault: this reply's rows in reverse order
                planted_done = True
                planted_caught = check(y[::-1], served, solo, exact)
    log(f"requests per dispatch: {per_dispatch}")
    if max(per_dispatch, default=0) < 2:
        problems.append("no dispatch carried two requests")
    log(f"replies against the engine: {counts['same bucket']} on the solo "
        f"request's bucket, {counts['other bucket']} on another, "
        f"{counts['drifting']} of those across a drift source; "
        f"{counts['bitwise']} of {n_req} bitwise the in-process "
        f"engine.infer of the same rows (the others, as (request rows, "
        f"dispatch rows): {loose}); largest |Δ| / max |reply| {worst:.3e} "
        f"(limit {SRV_REL_LIMIT} across a drift source, 0 elsewhere); "
        f"every reply bitwise its dispatch's rows; planted fault (a reply's "
        f"rows reversed) caught: {planted_caught}")
    if not planted_caught:
        problems.append("a reply with its rows reversed passed the check")

    summary.update(requests=n_req, images=n_rows, dispatches=n_disp,
                   rows_per_dispatch=hist, bitwise=counts["bitwise"],
                   drifting=counts["drifting"], rel_err=worst)

    # latency by request size under 8 clients: SRV_LAT_PER_SIZE requests
    # of each size, shuffled over the clients
    lat_sizes = np.repeat(np.arange(1, SRV_MAX_ROWS + 1), SRV_LAT_PER_SIZE)
    rng.shuffle(lat_sizes)
    lat_sizes = np.array_split(lat_sizes, SRV_CLIENTS)
    pool = rng.normal(0, 1, (SRV_MAX_ROWS, IMAGE, IMAGE, 3)).astype(
        "float32")
    lat = [[] for _ in range(SRV_CLIENTS)]

    def timed(i, c):
        for n in lat_sizes[i]:
            t1 = time.perf_counter()
            y, = c.infer({"img": pool[:n]})
            lat[i].append((int(n), (time.perf_counter() - t1) * 1e3))
            if y.shape != (n, CLASSES) or not np.isfinite(y).all():
                raise ValueError(f"a reply of shape {y.shape} to {n} images")

    b0 = server.stats()["batcher"]["batches"]
    lat_s = run_clients(server.address, InferClient, timed)
    lat_disp = server.stats()["batcher"]["batches"] - b0
    by_n = {}
    for n, ms in (p for per in lat for p in per):
        by_n.setdefault(n, []).append(ms)
    summary["load_latency_ms"] = {
        n: dict(count=len(v), p50=float(np.percentile(v, 50)),
                p99=float(np.percentile(v, 99)), max=float(max(v)))
        for n, v in sorted(by_n.items())}
    log(f"latency window: {sum(len(v) for v in by_n.values())} requests "
        f"from {SRV_CLIENTS} clients in {lat_s:.2f} s, {lat_disp} "
        f"dispatches; over the wire by request size (count, p50, p99, max "
        f"ms): " + "; ".join(
            f"{n}: {v['count']}, {v['p50']:.2f}, {v['p99']:.2f}, "
            f"{v['max']:.2f}" for n, v in summary["load_latency_ms"].items())
        + f" | {card}")
    if any(len(v) < SRV_LAT_PER_SIZE for v in by_n.values()) \
            or len(by_n) != SRV_MAX_ROWS:
        problems.append("the latency window lost requests")

    with InferClient(server.address) as c:
        for name, obj in (("health", c.health()), ("stats", c.stats())):
            if not is_plain_json(obj):
                problems.append(f"{name}() is not plain JSON")
            json.dumps(obj)

    # one client, one request at a time: the wire's cost per call beside
    # the in-process engine (this call) and phase 3's medians. Each
    # request rides a dispatch of its own, so on its solo bucket: its
    # reply must be bitwise the in-process engine's
    wire, solo = {}, []
    with InferClient(server.address) as c:
        for n in SRV_WIRE_SIZES:
            x = {"img": feeds[0][0][:1].repeat(n, axis=0)}
            s0, c0 = server.stats()["wire"], c.wire_stats()
            b0 = server.stats()["batcher"]["batches"]
            over, local = [], []
            for _ in range(LAT_REPS):
                t1 = time.perf_counter()
                y, = c.infer(x)
                over.append((time.perf_counter() - t1) * 1e3)
                t1 = time.perf_counter()
                want, = real_infer(x)
                local.append((time.perf_counter() - t1) * 1e3)
                solo.append(check(y, y, want, True))
            s1, c1 = server.stats()["wire"], c.wire_stats()
            if server.stats()["batcher"]["batches"] - b0 != LAT_REPS:
                problems.append(f"one client's requests of {n} images did "
                                "not each ride a dispatch of their own")
            calls = s1["calls"]["infer"]["count"] - \
                s0["calls"]["infer"]["count"]
            srv_s = s1["calls"]["infer"]["total_s"] - \
                s0["calls"]["infer"]["total_s"]
            cli_s = c1["calls"]["infer"]["total_s"] - \
                c0["calls"].get("infer", {}).get("total_s", 0.0)
            wire[n] = dict(
                over_ms=sorted(over)[LAT_REPS // 2],
                local_ms=sorted(local)[LAT_REPS // 2],
                phase3_ms=serving["lat_ms"].get(n),
                request_bytes=(s1["bytes_recv"] - s0["bytes_recv"]) / calls,
                reply_bytes=(s1["bytes_sent"] - s0["bytes_sent"]) / calls,
                client_ms=cli_s / calls * 1e3, server_ms=srv_s / calls * 1e3)
            w = wire[n]
            p3 = "n/a" if w["phase3_ms"] is None else \
                f"{w['phase3_ms']:.2f}"
            log(f"batch {n}: median of {LAT_REPS} over the wire "
                f"{w['over_ms']:.2f} ms, in-process {w['local_ms']:.2f} ms "
                f"(phase 3: {p3}); per call {w['request_bytes']:.0f} bytes "
                f"in, {w['reply_bytes']:.0f} out, the client's "
                f"{w['client_ms']:.2f} ms of which the server's handler "
                f"{w['server_ms']:.2f} (WireStats) | {card}")
    summary["wire"] = wire
    bad = [b for b in solo if b]
    log(f"one client alone: {len(solo) - len(bad)} of {len(solo)} replies, "
        f"each on its solo bucket, bitwise the in-process engine.infer of "
        f"the same rows")
    if bad:
        problems.append(f"on its solo bucket: {bad[0]}")
    summary["solo_bitwise"] = [len(solo) - len(bad), len(solo)]

    # a dispatch first made from a non-main thread: a server that skipped
    # warmup makes each bucket's first dispatch on its batcher's worker
    cold = ModelServer(serving["dir"], batching=True)
    cold.start(warmup=False)
    try:
        cbk.reset_launches()
        x3 = {"img": feeds[0][0][:1].repeat(3, axis=0)}
        with InferClient(cold.address) as c:
            y3, = c.infer(x3)
        cold_launches = cbk.launches["conv_affine"]
        cst = cold.stats()["engine"]
        same = np.array_equal(y3, real_infer(x3)[0])
        log(f"cold server (no warmup; first dispatch on the batcher's worker "
            f"thread): bitwise the warm engine's reply {same}, conv_affine "
            f"launches {cold_launches}, first dispatches {cst['compiles']}")
        if not same or cold_launches != KERNEL_CONVS:
            problems.append("a first dispatch on a worker thread differs "
                            "from the main thread's")
    finally:
        cold.shutdown()
        cold.engine.release()

    # images/s, 8 clients of batch-1 requests, batching on and off in
    # turns: windows of SRV_THR_WINDOW_S seconds, each client sending
    # until its window closes
    ones = rng.normal(0, 1, (64, IMAGE, IMAGE, 3)).astype("float32")
    sent = [0] * SRV_CLIENTS

    def batch1(i, c):
        end, k = time.perf_counter() + SRV_THR_WINDOW_S, 0
        while time.perf_counter() < end:
            c.infer({"img": ones[(i * 8 + k) % len(ones)][None]})
            k += 1
        sent[i] = k

    off = ModelServer(engine=eng, batching=False)
    off.start(warmup=False)
    thr = {"on": [], "off": []}
    try:
        for _ in range(SRV_THR_ROUNDS):
            for mode, srv in (("on", server), ("off", off)):
                b0 = srv.stats()["engine"]["dispatches"]
                secs = run_clients(srv.address, InferClient, batch1)
                disp = srv.stats()["engine"]["dispatches"] - b0
                thr[mode].append((sum(sent) / secs, sum(sent), secs, disp))
    finally:
        off.shutdown()
    log(f"batch-1 requests from {SRV_CLIENTS} clients in windows of "
        f"{SRV_THR_WINDOW_S} s, images/s (requests, seconds, engine "
        f"dispatches): batching on " + ", ".join(
            f"{r:.1f} ({n}, {t:.2f}, {d})" for r, n, t, d in thr["on"])
        + "; off " + ", ".join(
            f"{r:.1f} ({n}, {t:.2f}, {d})" for r, n, t, d in thr["off"])
        + f" | {card}")
    summary["batch1_images_per_s"] = {m: [r for r, *_ in v]
                                      for m, v in thr.items()}
    summary["batch1_requests"] = {m: [n for _, n, *_ in v]
                                  for m, v in thr.items()}

    # drain: shutdown(drain=True) while every client has a request in flight
    gate, held = threading.Event(), []

    def gated(feed, fetch_list=None):
        held.append(len(feed["img"]))
        gate.wait(120)
        return real_infer(feed, fetch_list)

    eng.infer = gated
    answers = {}
    req0 = server.stats()["batcher"]["requests"]

    def one(i):
        with InferClient(server.address) as c:
            answers[i], = c.infer({"img": feeds[i][0]})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(SRV_CLIENTS)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while (server.stats()["batcher"]["requests"] - req0 < SRV_CLIENTS
           or not held) and time.monotonic() < deadline:
        time.sleep(0.005)
    drained = []
    sd = threading.Thread(target=lambda: drained.append(
        server.shutdown(drain=True, timeout=120)))
    sd.start()
    while not server._rpc._draining.is_set() and time.monotonic() < deadline:
        time.sleep(0.005)
    answered_before = len(answers)
    gate.set()
    sd.join(180)
    for t in threads:
        t.join(60)
    eng.infer = real_infer
    ok = [i for i, y in answers.items()
          if y.shape == replies[i][0].shape and np.isfinite(y).all()
          and np.abs(y - replies[i][0]).max()
          <= SRV_REL_LIMIT * np.abs(replies[i][0]).max()]
    log(f"drain: shutdown(drain=True) with {SRV_CLIENTS} requests in "
        f"flight ({answered_before} answered when it began): returned "
        f"{drained}, {len(answers)} answered, {len(ok)} equal to their "
        f"main-path replies")
    if drained != [True] or len(ok) != SRV_CLIENTS or answered_before:
        problems.append(f"drain: returned {drained}, answered "
                        f"{len(answers)} of {SRV_CLIENTS} ({len(ok)} right, "
                        f"{answered_before} before the drain)")

    # the LM lane behind a generative ModelServer
    gserver = ModelServer(gen["dir"], model_kind="generative", gen_opts=dict(
        max_seqs=GEN_MAX_SEQS, block_size=GEN_BLOCK, num_blocks=GEN_BLOCKS,
        max_len=GEN_MAX_LEN, prefill_buckets=(8,)))
    try:
        t0 = time.perf_counter()
        gserver.start()
        geng = gserver.engine
        log(f"generative ModelServer on {geng.device}: load and warmup "
            f"{time.perf_counter() - t0:.2f} s")
        if geng.device.type != "cuda":
            fail(f"the generative engine runs on {geng.device}")
        want = [[GEN_LENS[(3 * i + 5 * j) % len(GEN_LENS)]
                 for j in range(GEN_PER_CLIENT)] for i in range(GEN_CLIENTS)]
        toks = [[None] * GEN_PER_CLIENT for _ in range(GEN_CLIENTS)]
        ttft = []

        def lane(i, c):
            for j, n in enumerate(want[i]):
                t1 = time.perf_counter()
                got = []
                for t in c.generate([1 + i, 2 + j, 3], n):
                    if not got:
                        ttft.append((time.perf_counter() - t1) * 1e3)
                    got.append(t)
                toks[i][j] = got

        decodes0 = geng.stats()["phases"]["decode"][GEN_MAX_SEQS][
            "dispatches"]
        lat0 = gserver.stats()["latency"]["count"]
        torch.cuda.synchronize()
        pak.reset_launches()
        tier.reset_fallback_counts()
        gelapsed = run_clients(gserver.address, GenClient, lane,
                               n=GEN_CLIENTS)
        glaunches = pak.launches["paged_attention"]
        gfall = tier.fallback_counts()
        gst = gserver.stats()
        decodes = gst["engine"]["phases"]["decode"][GEN_MAX_SEQS][
            "dispatches"] - decodes0
        n_tokens = sum(len(t) for per in toks for t in per)
        same = toks == gen["tokens"]
        log(f"LM lane over the wire: {n_tokens} tokens in "
            f"{gelapsed * 1e3:.1f} ms, {n_tokens / gelapsed:.1f} tokens/s "
            f"(phase 13 in-process: {gen['tokens_per_s']:.1f}); TTFT at the "
            f"client p50 {np.percentile(ttft, 50):.2f} p99 "
            f"{np.percentile(ttft, 99):.2f} ms (phase 13 in-process: "
            f"{gen['ttft_p50']:.2f}, {gen['ttft_p99']:.2f}); the server's "
            f"time to first frame p50 {gst['latency']['p50_ms']:.2f} p99 "
            f"{gst['latency']['p99_ms']:.2f} ms over "
            f"{gst['latency']['count'] - lat0} requests; {decodes} decode "
            f"dispatches, paged_attention launches {glaunches}, fallbacks "
            f"{gfall}; tokens = phase 13's {same} | {card}")
        if not same:
            problems.append("the LM lane's tokens over GenClient differ from "
                            "phase 13's in-process tokens")
        if glaunches != GEN_LAYERS * decodes or not decodes or gfall:
            problems.append(f"{glaunches} paged_attention launches over "
                            f"{decodes} decode dispatches (want {GEN_LAYERS} "
                            f"each), fallbacks {gfall}")
        summary["lm"] = dict(tokens=n_tokens,
                             tokens_per_s=n_tokens / gelapsed,
                             ttft_p50=float(np.percentile(ttft, 50)),
                             ttft_p99=float(np.percentile(ttft, 99)),
                             decodes=decodes, launches=glaunches)
    finally:
        gserver.shutdown()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14 took {summary['phase_s']:.1f} s")
    if problems:
        fail("; ".join(problems))
    return launches, glaunches, summary


# phase 15: the training recipes. ResNet-50 with the ImageNet recipe of
# PaddlePaddle's models repository (Momentum 0.9, L2Decay(1e-4), a
# piecewise schedule falling tenfold at each boundary), its rate the
# phase-4 rate and its boundaries cut to steps 2 and 4 so that 5 steps
# cross both; the LSTM classifier with a global-norm clip of 5 and an
# exponential schedule halving every 2 steps from phase 6's rate; word2vec
# with the same clip through SGD(fused=True), then Adagrad on its sparse
# table; each of the six per-parameter optimizers 3 steps on the LSTM
# classifier
RECIPE_STEPS, OPT_STEPS = 5, 3
RESNET_DECAY = 1e-4
RESNET_BOUNDARIES = (2, 4)
RESNET_VALUES = (TRAIN_LR, TRAIN_LR / 10, TRAIN_LR / 100)
TEXT_CLIP = 5.0
TEXT_DECAY_STEPS, TEXT_DECAY_RATE = 2, 0.5
W2V_CLIP = 5.0
ADAGRAD_LR = 0.01
# the fetched rate against the schedule's closed form, relative: the
# schedules compute it in float32 through 2-4 roundings (scale, add, exp),
# each within 2^-24 of its value
LR_REL = 1e-6
# ResNet-50's step 1 against the recipe recomputed in float64 from the
# step's fetched raw gradients g, the fetched rate and p0: per element
# |p1 − (p0 − lr·(g + c·p0))| ≤ UPDATE_ROUNDINGS · 2^-24 · (|p0| + |lr·v1|
# + lr·c·|p0|). The float32 step rounds c·p0, g + c·p0, lr·v1 and p0 −
# lr·v1 once each (and the coefficient c itself), each within 2^-24 of its
# value: at most 2^-24·(|p1| + 2|lr·v1| + 2·lr·c·|p0|), which 4 covers
# twice over. A decay of 2c moves p1 by lr·c·|p0|, ~5x that limit where
# |p0| dominates: the planted fault
UPDATE_ROUNDINGS = 4
F32_U = 2.0 ** -24
# the LSTM recipe's global norm against the float64 norm of the fetched raw
# gradients, relative: a float32 sum of squares over 4.9 M elements in
# blocks; the clipped gradients against g·min(1, clip/‖g‖₆₄) per element
# within that plus 3 roundings (the factor's max and division, the product)
NORM_REL = 1e-5
# a per-parameter optimizer's step-1 update ops on the card against the
# same ops run on the CPU from the same inputs (the startup state and the
# card's step-1 gradients: the port's ops on the same float32 values; the
# card's sqrt, pow and exp may differ by a rounding), and the Adagrad
# word2vec run's losses on the card against the same steps on the CPU,
# relative: 1e-5 (of the largest element), the CPU tests' tolerance
# between the packages. The whole steps' states are printed, not held:
# Adagrad divides each element by its own gradient, lr·g/(|g| + 1e-6),
# so where |g| is near 1e-6 (a zero-initialized bias whose gradient
# cancels) the card's and the CPU's GEMM rounding differences move the
# step by up to lr/4 (H100 runs: 2.12e-4 of fc_0.w_1's largest after
# step 1 at lr 0.01; 4.47e-4 of fc_0.w_0's after 3 steps at lr 0.1)
CPU_REL = 1e-5
# each per-parameter optimizer's rate, set so that its first step moves an
# element by about SEQ_LR (Adagrad, Adamax and Ftrl step by lr·sign(g) at
# first, DecayedAdagrad and RMSProp by lr/√0.05, Adadelta by √1e-6/√0.05
# whatever the rate). Ftrl takes a small l2: with l2 = 0 (its default) an
# element whose gradient is exactly 0, as the rows of the embedding table
# no word of the batch looks up, becomes 0/0 (the reference's expression)
OPT_RECIPES = {
    "adagrad": lambda o: o.Adagrad(SEQ_LR),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(SEQ_LR * 0.05 ** 0.5),
    "adadelta": lambda o: o.Adadelta(SEQ_LR),
    "rmsprop": lambda o: o.RMSProp(SEQ_LR * 0.05 ** 0.5),
    "adamax": lambda o: o.Adamax(SEQ_LR),
    "ftrl": lambda o: o.Ftrl(SEQ_LR, l2=1e-4),
}


def build_resnet50_recipe(fluid, seed, decay=RESNET_DECAY):
    """build_resnet50_train with the ImageNet recipe: the piecewise
    schedule and Momentum(lr, 0.9, fused=True, L2Decay(decay)). Returns
    (main, startup, loss, lr)."""
    from paddle_tpu_torch.testing.models import resnet
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[IMAGE, IMAGE, 3])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            resnet(img, CLASSES), label))
        if fluid.fuse_conv_bn(main) != KERNEL_CONVS + PLAIN_CONVS:
            fail("fuse_conv_bn did not fuse ResNet-50's 53 chains")
        lr = fluid.layers.piecewise_decay(list(RESNET_BOUNDARIES),
                                          list(RESNET_VALUES))
        fluid.optimizer.Momentum(
            learning_rate=lr, momentum=0.9, fused=True,
            regularization=fluid.regularizer.L2Decay(decay)).minimize(
                loss, startup)
    return main, startup, loss, lr


def build_textcls_recipe(fluid, seed, opt=None):
    """build_textcls's LSTM classifier with set_gradient_clip(
    GradientClipByGlobalNorm(TEXT_CLIP)), exponential_decay and
    Adam(fused=True); or, given ``opt`` (a key of OPT_RECIPES), that
    optimizer at a constant rate and no clip. Returns (main, startup,
    loss, lr var or None)."""
    from paddle_tpu_torch.testing import models
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        prob = models.lstm_textcls(words, vocab=SEQ_VOCAB, emb=SEQ_EMB,
                                   hidden=SEQ_HIDDEN)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        lr = None
        if opt is None:
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(TEXT_CLIP))
            lr = fluid.layers.exponential_decay(SEQ_LR, TEXT_DECAY_STEPS,
                                                TEXT_DECAY_RATE)
            fluid.optimizer.Adam(learning_rate=lr, fused=True).minimize(
                loss, startup)
        else:
            OPT_RECIPES[opt](fluid.optimizer).minimize(loss, startup)
    return main, startup, loss, lr


def build_word2vec_recipe(fluid, seed, adagrad=False):
    """build_word2vec with set_gradient_clip(GradientClipByGlobalNorm(
    W2V_CLIP)) through SGD(W2V_LR, fused=True), or Adagrad(ADAGRAD_LR).
    Returns (main, startup, loss)."""
    from paddle_tpu_torch.testing.models import ngram_lm
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(f"w{i}", shape=[1], dtype="int64")
                 for i in range(W2V_N - 1)]
        nextw = fluid.layers.data("nextw", shape=[1], dtype="int64")
        predict = ngram_lm(words, W2V_DICT, W2V_EMB, W2V_HIDDEN)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(predict, nextw))
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(W2V_CLIP))
        opt = fluid.optimizer.Adagrad(ADAGRAD_LR) if adagrad else \
            fluid.optimizer.SGD(learning_rate=W2V_LR, fused=True)
        opt.minimize(loss, startup)
    return main, startup, loss


def recipe_op_indices(block, update, targets):
    """Indices of the ops a recipe added in front of ``update``: those the
    ``targets`` (the update's gradients and its learning rate) are computed
    by, back to the raw gradients (names ending in @GRAD, which the
    backward writes) and the parameters and step counter."""
    end = block.ops.index(update)
    needed, picked = set(targets), []
    for i in reversed(range(end)):
        op = block.ops[i]
        outs = op.output_arg_names()
        if not needed & set(outs) or any(
                o.endswith("@GRAD") or "@RENAME" in o for o in outs):
            continue
        picked.append(i)
        needed.update(op.input_arg_names())
    return sorted(picked)


def gnorm_var(block):
    """The name of a global-norm clip's norm (the ``sqrt`` clip.py
    appends)."""
    return next(op.output("Out")[0] for op in block.ops
                if op.type == "sqrt"
                and op.output("Out")[0].startswith("gclip_gnorm"))


def step_env(exe, main, feed, scope, raw):
    """The scope's values and the raw gradients ``raw`` of one more step
    of ``main``: the inputs of the recipe ops for no_host_sync."""
    env = {n: scope.find_var(n) for n in scope.local_names()}
    env.update(zip(raw, exe.run(main, feed=feed, fetch_list=raw, scope=scope,
                                return_numpy=False)))
    return env


def no_host_sync(torch, block, indices, env, device, title):
    """Run the ops at ``indices`` once more on device tensors (``env``:
    their inputs, from a step of the program) under
    torch.cuda.set_sync_debug_mode("error"), which raises at any call that
    waits for the device (.item(), .cpu(), float() of a device tensor,
    a nonzero). Prints the op types run."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.executor import ExecContext
    env = dict(env)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            for i in indices:
                op = block.ops[i]
                registry.get_op_info(op.type).forward(
                    ExecContext(op, block, env, device))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    types = {}
    for i in indices:
        types[block.ops[i].type] = types.get(block.ops[i].type, 0) + 1
    log(f"{title}: {len(indices)} clip, decay and schedule ops ("
        + ", ".join(f"{k}x{v}" for k, v in sorted(types.items()))
        + ") ran on device tensors under set_sync_debug_mode('error'): "
        "no host sync")


def recipe_run(torch, fluid, exe, spec, route):
    """``spec["steps"]`` steps of ``spec["main"]`` on ``spec["feed"]`` from
    a copy of ``spec["init"]`` under ``route``: each step's counters (reset
    before it) against ``spec["want"]`` (zeros on the torch route), its
    loss finite; ``spec["each"]`` fetched every step and ``spec["first"]``
    at step 1 (device values); ``spec["keep"]`` copied from the scope
    after step 1. Returns a dict of the readings."""
    scope = copy_scope(fluid, torch, spec["init"])
    labels = [c[0] for c in spec["counters"]]
    want = spec["want"] if route == "auto" else (0,) * len(labels)
    each, first = list(spec.get("each", ())), list(spec.get("first", ()))
    out = dict(losses=[], ms=[], each=[], total=[0] * len(labels))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    for step in range(spec["steps"]):
        for reset in spec["resets"]:
            reset()
        fetch = [spec["loss"]] + each + (first if step == 0 else [])
        fluid.set_flags({"kernel_tier": route})
        t0 = time.perf_counter()
        try:
            vals = exe.run(spec["main"], feed=spec["feed"], fetch_list=fetch,
                           scope=scope, return_numpy=False)
            torch.cuda.synchronize()
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        counts = tuple(get() for _, get in spec["counters"])
        if counts != want:
            fail(f"{spec['title']}, kernel_tier={route} step {step + 1}: "
                 f"{'/'.join(labels)} {counts}, want {want}")
        out["total"] = [a + c for a, c in zip(out["total"], counts)]
        lv = vals[0]
        if lv.shape != () or not torch.isfinite(lv).item():
            fail(f"{spec['title']}, kernel_tier={route} step {step + 1}: "
                 f"loss {lv}")
        out["losses"].append(lv.item())
        out["each"].append(vals[1:1 + len(each)])
        if step == 0:
            out["first"] = dict(zip(first, vals[1 + len(each):]))
            out["kept"] = {n: scope.find_var(n).clone()
                           for n in spec.get("keep", ())}
    out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["work"] = out["peak"] - start / 2 ** 30
    out["steady"] = sum(out["ms"][1:]) / max(len(out["ms"]) - 1, 1)
    out["scope"] = scope
    return out


def recipe_line(title, route, res, card):
    return (f"{title}, kernel_tier={route}: losses "
            + " ".join(f"{v:.6f}" for v in res["losses"])
            + " | ms/step " + " ".join(f"{v:.1f}" for v in res["ms"])
            + f" | steady {res['steady']:.2f} ms/step | peak memory "
            f"{res['peak']:.3f} GiB, {res['work']:.3f} above the start | "
            f"{card}")


def base_vs_recipe(torch, fluid, exe, title, base, recipe, card):
    """Steady ms a step and a step's peak memory above its start of the
    program without the recipe (``base``: main, startup, loss, feed) and
    with it (``recipe``: its main and readings), both on the kernel
    route; prints them with the ops the recipe adds."""
    main, startup, loss, feed = base
    init = fluid.Scope()
    exe.run(startup, scope=init)
    res = recipe_run(torch, fluid, exe, dict(
        title=title + " without the recipe", main=main, loss=loss,
        feed=feed, init=init, steps=RECIPE_STEPS, counters=[], resets=[],
        want=()), "auto")
    n_base, n_recipe = len(main.global_block().ops), \
        len(recipe["main"].global_block().ops)
    added = {}
    for op in recipe["main"].global_block().ops:
        added[op.type] = added.get(op.type, 0) + 1
    for op in main.global_block().ops:
        added[op.type] = added.get(op.type, 0) - 1
    log(f"{title}: without the recipe {res['steady']:.2f} ms/step, a step "
        f"peaks {res['work']:.3f} GiB above its start; with it "
        f"{recipe['steady']:.2f} ms/step, {recipe['work']:.3f} GiB (kernel "
        f"route; the start holds the state and what earlier runs keep) | "
        f"the recipe adds "
        f"{n_recipe - n_base} ops a step ("
        + ", ".join(f"{k}{v:+d}" for k, v in sorted(added.items()) if v)
        + f") | {card}")
    del res


def resnet_step1(torch, init, first, kept, lr, params, coeff):
    """Each parameter's step-1 value against the recipe in float64 from the
    fetched raw gradients (v0 = 0): the largest |Δ| / limit over each
    parameter's elements, {name: ratio}."""
    ratios = {}
    lr = float(lr)
    for n in params:
        p0 = init.find_var(n).double()
        v1 = first[n + "@GRAD"].double() + RESNET_DECAY * p0
        want = p0 - lr * v1
        limit = UPDATE_ROUNDINGS * F32_U * (p0.abs() + (lr * v1).abs()
                                            + lr * RESNET_DECAY * p0.abs())
        d = (kept[n].double() - want).abs()
        ratios[n] = (d / limit.clamp_min(1e-45)).max().item() \
            if (d > 0).any().item() else 0.0
    return ratios


def replay_on_cpu(torch, block, updates, init, grads, kept):
    """Run each update op of ``updates`` once more on the CPU from the
    startup state ``init`` and the card's step-1 gradients ``grads`` (by
    name; a SparseRows moved as one); returns the worst ‖Δ‖∞/‖ref‖∞ of the
    card's step-1 outputs ``kept`` against them, and where."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.sparse import SparseRows, is_sparse
    cpu = torch.device("cpu")
    names = set(init.local_names())
    worst, at = 0.0, None
    for op in updates:
        env = {n: init.find_var(n).cpu() for n in op.input_arg_names()
               if n in names}
        g = op.input("Grad")[0]
        v = grads[g]
        env[g] = SparseRows(v.rows.cpu(), v.values.cpu(), v.nrows,
                            v.merged) if is_sparse(v) else v.cpu()
        with torch.no_grad():
            registry.get_op_info(op.type).forward(
                ExecContext(op, block, env, cpu))
        for slot, out in op.outputs.items():
            want = env[out[0]].double()
            got = kept[out[0]].cpu().double()
            rel = ((got - want).abs().max()
                   / want.abs().max().clamp_min(1e-30)).item()
            if rel >= worst:
                worst, at = rel, f"{slot} of {op.input('Param')[0]}"
    return worst, at


def phase_resnet_recipe(torch, fluid, seed, card):
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    title = "ResNet-50 recipe"
    log(f"\n-- {title}: batch {TRAIN_BATCH}, Momentum(piecewise_decay("
        f"{list(RESNET_BOUNDARIES)}, {list(RESNET_VALUES)}), 0.9, "
        f"fused=True, L2Decay({RESNET_DECAY})), {RECIPE_STEPS} steps --")
    main, startup, loss, lr = build_resnet50_recipe(fluid, seed)
    block = main.global_block()
    update, = [op for op in block.ops if op.type == "fused_momentum"]
    params = update.input("Params")
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    rng = np.random.RandomState(seed)
    feed = {"img": rng.normal(0, 1, (TRAIN_BATCH, IMAGE, IMAGE, 3))
            .astype("float32"),
            "label": rng.randint(0, CLASSES, (TRAIN_BATCH, 1))
            .astype("int64")}
    raw = [n + "@GRAD" for n in params]
    spec = dict(title=title, main=main, loss=loss, feed=feed, init=init,
                steps=RECIPE_STEPS, each=[lr], first=raw, keep=params,
                counters=[("conv_bn_train",
                           lambda: cbk.launches["conv_bn_train"]),
                          ("conv_bn_bwd",
                           lambda: cbk.launches["conv_bn_bwd"]),
                          ("momentum_arena",
                           lambda: opk.launches["momentum_arena"]),
                          ("plain-routed convs",
                           lambda: tier.fallback_counts().get("conv_bn", 0))],
                resets=[cbk.reset_launches, opk.reset_launches,
                        tier.reset_fallback_counts],
                want=(KERNEL_CONVS, KERNEL_CONVS, 1, 2 * PLAIN_CONVS))
    problems, res = [], {}
    for route in ("auto", "torch"):
        r = recipe_run(torch, fluid, exe, spec, route)
        log(recipe_line(title, route, r, card))
        rates = [v[0].item() for v in r["each"]]
        closed = [RESNET_VALUES[sum(s >= b for b in RESNET_BOUNDARIES)]
                  for s in range(1, RECIPE_STEPS + 1)]
        worst = max(abs(a - b) / b for a, b in zip(rates, closed))
        log(f"  rates " + " ".join(f"{v:.9g}" for v in rates)
            + f" against the closed form: worst {worst:.2e} (limit "
            f"{LR_REL:.0e})")
        if not worst <= LR_REL:
            problems.append(f"{route}: the fetched rates {rates} are not "
                            f"the schedule's {closed}")
        ratios = resnet_step1(torch, init, r["first"], r["kept"], rates[0],
                              params, RESNET_DECAY)
        top = max(ratios, key=ratios.get)
        log(f"  step 1 against p0 − lr·(g + {RESNET_DECAY}·p0) in float64 "
            f"from the fetched raw gradients: worst |Δ|/limit "
            f"{ratios[top]:.3f} at {top} (limit {UPDATE_ROUNDINGS} float32 "
            "roundings of |p0| + |lr·v1| + lr·c·|p0|)")
        if not ratios[top] <= 1.0:
            problems.append(f"{route}: step 1 of {top} is "
                            f"{ratios[top]:.3f}x its limit from the recipe")
        if not r["losses"][-1] < r["losses"][0]:
            problems.append(f"{route}: the loss did not fall over "
                            f"{RECIPE_STEPS} steps: {r['losses']}")
        r.pop("first")
        r.pop("kept")
        res[route] = r

    # the planted fault: the same program with the decay doubled, one step
    bad_main, bad_start, bad_loss, bad_lr = build_resnet50_recipe(
        fluid, seed, 2 * RESNET_DECAY)
    bad = recipe_run(torch, fluid, exe, dict(
        spec, title=title + " (decay x2)", main=bad_main, loss=bad_loss,
        each=[bad_lr], steps=1), "auto")
    ratios = resnet_step1(torch, init, bad["first"], bad["kept"],
                          bad["each"][0][0].item(), params, RESNET_DECAY)
    caught = sum(v > 1.0 for v in ratios.values())
    log(f"planted fault: L2Decay({2 * RESNET_DECAY}) in the same program: "
        f"{caught} of {len(params)} parameters beyond their limit, worst "
        f"{max(ratios.values()):.2f}x")
    if caught == 0:
        problems.append("the step-1 check does not see the decay doubled")
    del bad, ratios

    base = build_resnet50_train(fluid, seed) + (feed,)
    base_vs_recipe(torch, fluid, exe, title, base, dict(
        main=main, steady=res["auto"]["steady"], work=res["auto"]["work"]),
        card)
    if problems:
        fail(f"{title}: " + "; ".join(problems))
    no_host_sync(torch, block, recipe_op_indices(
        block, update, update.input("Grads") + [lr.name]),
        step_env(exe, main, feed, res["auto"]["scope"], raw), exe.device,
        title)
    return dict(zip(("conv_bn_train", "conv_bn_bwd", "momentum_arena"),
                    res["auto"]["total"]))


def phase_textcls_recipe(torch, fluid, seed, card):
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    title = "LSTM classifier recipe"
    log(f"\n-- {title}: batch {SEQ_BATCH}, length {SEQ_LEN}, hidden "
        f"{SEQ_HIDDEN}, GradientClipByGlobalNorm({TEXT_CLIP}), Adam("
        f"exponential_decay({SEQ_LR}, {TEXT_DECAY_STEPS}, "
        f"{TEXT_DECAY_RATE}), fused=True), {RECIPE_STEPS} steps --")
    main, startup, loss, lr = build_textcls_recipe(fluid, seed)
    block = main.global_block()
    update, = [op for op in block.ops if op.type == "fused_adam"]
    params, clipped = update.input("Params"), update.input("Grads")
    gnorm = gnorm_var(block)
    raw = [n + "@GRAD" for n in params]
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    feed = textcls_feeds(fluid, seed, ragged=False)
    spec = dict(title=title, main=main, loss=loss, feed=feed, init=init,
                steps=RECIPE_STEPS, each=[lr], first=raw + clipped + [gnorm],
                counters=[("lstm_seq", lambda: rnn.launches["lstm_seq"]),
                          ("lstm_seq_bwd",
                           lambda: rnn.launches["lstm_seq_bwd"]),
                          ("adam_arena", lambda: opk.launches["adam_arena"]),
                          ("plain-routed LSTMs",
                           lambda: tier.fallback_counts().get("lstm", 0))],
                resets=[rnn.reset_launches, opk.reset_launches,
                        tier.reset_fallback_counts],
                want=(2, 2, 1, 0))
    problems, res = [], {}
    for route in ("auto", "torch"):
        r = recipe_run(torch, fluid, exe, spec, route)
        log(recipe_line(title, route, r, card))
        rates = [v[0].item() for v in r["each"]]
        closed = [SEQ_LR * TEXT_DECAY_RATE ** (s / TEXT_DECAY_STEPS)
                  for s in range(1, RECIPE_STEPS + 1)]
        worst = max(abs(a - b) / b for a, b in zip(rates, closed))
        first = r.pop("first")
        norm64 = sum(first[g].double().pow(2).sum() for g in raw).sqrt()
        got = first[gnorm].double().reshape(())
        dn = ((got - norm64).abs() / norm64).item()
        factor = min(1.0, TEXT_CLIP / norm64.item())
        worst_clip = 0.0
        for g, c in zip(raw, clipped):
            ref = first[g].double() * factor
            d = (first[c].double() - ref).abs()
            lim = (NORM_REL + 3 * F32_U) * ref.abs()
            if (d > lim).any().item():
                worst_clip = max(worst_clip,
                                 (d / lim.clamp_min(1e-45)).max().item())
        log(f"  rates: worst {worst:.2e} from the closed form (limit "
            f"{LR_REL:.0e}) | global norm {got.item():.6g} against the "
            f"float64 {norm64.item():.6g}: {dn:.2e} (limit {NORM_REL:.0e}); "
            f"factor min(1, {TEXT_CLIP}/‖g‖) = {factor:.6g} (the clip "
            f"{'bites' if factor < 1 else 'does not bite'}); the gradients "
            f"adam_arena reads against g·factor: "
            + ("within the limit" if worst_clip == 0 else
               f"{worst_clip:.2f}x the limit"))
        if not worst <= LR_REL:
            problems.append(f"{route}: rates {rates}, want {closed}")
        if not dn <= NORM_REL:
            problems.append(f"{route}: global norm off by {dn:.2e}")
        if worst_clip:
            problems.append(f"{route}: clipped gradients {worst_clip:.2f}x "
                            "their limit")
        if not r["losses"][-1] < r["losses"][0]:
            problems.append(f"{route}: the loss did not fall: "
                            f"{r['losses']}")
        res[route] = r
    base = build_textcls(fluid, seed) + (feed,)
    base_vs_recipe(torch, fluid, exe, title, base, dict(
        main=main, steady=res["auto"]["steady"], work=res["auto"]["work"]),
        card)
    if problems:
        fail(f"{title}: " + "; ".join(problems))
    no_host_sync(torch, block, recipe_op_indices(block, update,
                                                 clipped + [lr.name]),
                 step_env(exe, main, feed, res["auto"]["scope"], raw),
                 exe.device, title)
    return dict(zip(("lstm_seq", "lstm_seq_bwd", "adam_arena"),
                    res["auto"]["total"]))


def phase_word2vec_recipe(torch, fluid, seed, card):
    import numpy as np
    from paddle_tpu_torch.core.sparse import is_sparse
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import embedding as embk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    title = "word2vec recipe"
    log(f"\n-- {title}: dict {W2V_DICT}, batch {W2V_BATCH}, is_sparse, "
        f"GradientClipByGlobalNorm({W2V_CLIP}) through SGD({W2V_LR}, "
        f"fused=True), {RECIPE_STEPS} steps; then Adagrad({ADAGRAD_LR}) "
        f"{OPT_STEPS} steps on the card and on the CPU --")
    main, startup, loss = build_word2vec_recipe(fluid, seed)
    block = main.global_block()
    update, = [op for op in block.ops if op.type == "fused_sgd"]
    params, clipped = update.input("Params"), update.input("Grads")
    table = clipped[params.index("shared_w")]
    raw = [n + "@GRAD" for n in params]
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    feed = word2vec_feed(seed)
    ids = np.unique(np.concatenate([feed[f"w{i}"].ravel()
                                    for i in range(W2V_N - 1)]))
    absent = np.setdiff1d(np.arange(W2V_DICT), ids)
    counters = [("embedding_sgd", lambda: embk.launches["embedding_sgd"]),
                ("sgd_arena", lambda: opk.launches["sgd_arena"]),
                ("plain-routed updates",
                 lambda: tier.fallback_counts().get("embedding_sgd", 0)
                 + tier.fallback_counts().get("optimizer", 0))]
    resets = [embk.reset_launches, opk.reset_launches,
              tier.reset_fallback_counts]
    gnorm = gnorm_var(block)
    spec = dict(title=title, main=main, loss=loss, feed=feed, init=init,
                steps=RECIPE_STEPS, first=[table, gnorm],
                counters=counters, resets=resets, want=(1, 1, 0))
    problems, res = [], {}
    w0 = init.find_var("shared_w")
    keep = torch.as_tensor(absent, device=w0.device)
    for route in ("auto", "torch"):
        r = recipe_run(torch, fluid, exe, spec, route)
        log(recipe_line(title, route, r, card))
        first = r.pop("first")
        g = first[table]
        w = r["scope"].find_var("shared_w")
        same = torch.equal(w[keep], w0[keep])
        norm = first[gnorm].reshape(()).item()
        log(f"  global norm {norm:.6g} (the clip of {W2V_CLIP} "
            f"{'bites' if norm > W2V_CLIP else 'does not bite'}); the "
            "clipped shared_w gradient is "
            f"{'a SparseRows' if is_sparse(g) else type(g).__name__}; "
            f"{len(absent)} rows absent from the batch "
            f"{'bitwise unchanged' if same else 'CHANGED'} after "
            f"{RECIPE_STEPS} steps")
        if not is_sparse(g):
            problems.append(f"{route}: the clipped table gradient is dense")
        if not same:
            problems.append(f"{route}: rows absent from the batch moved")
        if not r["losses"][-1] < r["losses"][0]:
            problems.append(f"{route}: the loss did not fall: "
                            f"{r['losses']}")
        res[route] = r
    base = build_word2vec(fluid, seed) + (feed,)
    base_vs_recipe(torch, fluid, exe, title, base, dict(
        main=main, steady=res["auto"]["steady"], work=res["auto"]["work"]),
        card)
    no_host_sync(torch, block, recipe_op_indices(block, update, clipped),
                 step_env(exe, main, feed, res["auto"]["scope"], raw),
                 exe.device, title)

    # Adagrad on the same sparse table: the lazy row update, no kernel;
    # its step-1 ops against the same ops on the CPU, the card's losses
    # against the same steps on the CPU
    amain, astart, aloss = build_word2vec_recipe(fluid, seed, adagrad=True)
    ablock = amain.global_block()
    updates = [op for op in ablock.ops if op.type == "adagrad"]
    ainit = fluid.Scope()
    exe.run(astart, scope=ainit)
    states = [n for n in ainit.local_names()
              if torch.is_tensor(ainit.find_var(n))
              and ainit.find_var(n).is_floating_point()]
    ar = recipe_run(torch, fluid, exe, dict(
        title="word2vec Adagrad", main=amain, loss=aloss, feed=feed,
        init=ainit, steps=OPT_STEPS, counters=counters, resets=resets,
        first=[op.input("Grad")[0] for op in updates], keep=states,
        want=(0, 0, 0)), "auto")
    log(recipe_line("word2vec Adagrad", "auto", ar, card))
    table_grad = ar["first"][updates[[op.input("Param")[0] for op in updates]
                                     .index("shared_w")].input("Grad")[0]]
    worst, at = replay_on_cpu(torch, ablock, updates, ainit, ar["first"],
                              ar["kept"])
    cpu = fluid.Executor(fluid.CPUPlace())
    cscope = fluid.Scope()
    for n in ainit.local_names():
        v = ainit.find_var(n)
        if torch.is_tensor(v):
            cscope.set(n, v.cpu().clone())
    closses, dist = [], []
    for step in range(OPT_STEPS):
        closses.append(float(cpu.run(amain, feed=feed, fetch_list=[aloss],
                                     scope=cscope)[0]))
        card_states = ar["kept"] if step == 0 else \
            {n: ar["scope"].find_var(n) for n in states}
        if step in (0, OPT_STEPS - 1):
            dist.append(max(
                ((card_states[n].cpu().double()
                  - cscope.find_var(n).double()).abs().max()
                 / cscope.find_var(n).double().abs().max()
                 .clamp_min(1e-30)).item() for n in states))
    dl = max(abs(a - b) / abs(b) for a, b in zip(ar["losses"], closses))
    wa = ar["scope"].find_var("shared_w")
    same = torch.equal(wa[keep], ainit.find_var("shared_w")[keep])
    log(f"  Adagrad: the table's gradient is "
        f"{'a SparseRows' if is_sparse(table_grad) else 'dense'}; step 1's "
        f"{len(updates)} adagrad ops against the same ops on the CPU: "
        f"worst ‖Δ‖∞/‖ref‖∞ {worst:.2e} ({at}; limit {CPU_REL:.0e}); losses "
        f"on the CPU " + " ".join(f"{v:.6f}" for v in closses)
        + f" ({dl:.2e} from the card's, limit {CPU_REL:.0e}); whole-step "
        f"state against the CPU's (printed): {dist[0]:.2e} after step 1, "
        f"{dist[-1]:.2e} after {OPT_STEPS}; absent rows "
        f"{'bitwise unchanged' if same else 'CHANGED'}")
    if not is_sparse(table_grad):
        problems.append("Adagrad: the table's gradient is dense")
    if not worst <= CPU_REL:
        problems.append(f"Adagrad: {at} differs from the CPU's op by "
                        f"{worst:.2e}")
    if not dl <= CPU_REL:
        problems.append(f"Adagrad: the losses differ from the CPU's by "
                        f"{dl:.2e}")
    if not same:
        problems.append("Adagrad: rows absent from the batch moved")
    if not ar["losses"][-1] < ar["losses"][0]:
        problems.append(f"Adagrad: the loss did not fall: {ar['losses']}")
    if problems:
        fail(f"{title}: " + "; ".join(problems))
    return dict(zip(("embedding_sgd", "sgd_arena"), res["auto"]["total"]))


def phase_optimizers(torch, fluid, seed, card):
    """The six per-parameter optimizers, each OPT_STEPS steps on the LSTM
    classifier on the kernel route; step 1 of every update op against the
    same op on the CPU from the same inputs."""
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    log(f"\n-- the six per-parameter optimizers, each {OPT_STEPS} steps on "
        f"the LSTM classifier (batch {SEQ_BATCH}, length {SEQ_LEN}, hidden "
        f"{SEQ_HIDDEN}) --")
    feed = textcls_feeds(fluid, seed, ragged=False)
    exe = fluid.Executor()
    totals, problems = {"lstm_seq": 0, "lstm_seq_bwd": 0}, []
    for name in OPT_RECIPES:
        main, startup, loss, _ = build_textcls_recipe(fluid, seed, name)
        block = main.global_block()
        updates = [op for op in block.ops if op.type == name]
        init = fluid.Scope()
        exe.run(startup, scope=init)
        outs = [n for op in updates for slot, names in op.outputs.items()
                for n in names]
        r = recipe_run(torch, fluid, exe, dict(
            title=name, main=main, loss=loss, feed=feed, init=init,
            steps=OPT_STEPS, first=[op.input("Grad")[0] for op in updates],
            keep=outs,
            counters=[("lstm_seq", lambda: rnn.launches["lstm_seq"]),
                      ("lstm_seq_bwd", lambda: rnn.launches["lstm_seq_bwd"]),
                      ("adam_arena", lambda: opk.launches["adam_arena"])],
            resets=[rnn.reset_launches, opk.reset_launches],
            want=(2, 2, 0)), "auto")
        for k, v in zip(("lstm_seq", "lstm_seq_bwd"), r["total"]):
            totals[k] += v
        worst, at = replay_on_cpu(torch, block, updates, init, r["first"],
                                  r["kept"])
        log(f"{name}: losses " + " ".join(f"{v:.6f}" for v in r["losses"])
            + f" | steady {r['steady']:.2f} ms/step | step 1 of its "
            f"{len(updates)} update ops against the same ops on the CPU: "
            f"worst ‖Δ‖∞/‖ref‖∞ {worst:.2e} ({at}; limit {CPU_REL:.0e}) | "
            f"{card}")
        if not worst <= CPU_REL:
            problems.append(f"{name}: {at} differs from the CPU's by "
                            f"{worst:.2e}")
        if not r["losses"][-1] < r["losses"][0]:
            problems.append(f"{name}: the loss did not fall: {r['losses']}")
        del r
    if problems:
        fail("per-parameter optimizers: " + "; ".join(problems))
    return totals


def phase_recipes(torch, fluid, seed, card):
    """Phase 15: ResNet-50, the LSTM classifier and word2vec trained with
    their recipes' clip, decay and schedule on both routes, and the six
    per-parameter optimizers; returns the kernel route's launches."""
    log("\n== phase 15: training recipes (clip, decay, schedules, the six "
        "other optimizers) ==")
    launches = phase_resnet_recipe(torch, fluid, seed, card)
    launches.update(phase_textcls_recipe(torch, fluid, seed, card))
    launches.update(phase_word2vec_recipe(torch, fluid, seed, card))
    for k, v in phase_optimizers(torch, fluid, seed, card).items():
        launches[k] += v
    return launches


# phase 16: AMP, the flagship's training mode (bench.py:3420-3439:
# Executor(amp=True), images staged on the card in bfloat16), on phase 4's
# ResNet-50 at batch 32 and at the flagship's batch 256 (bench.py:2949),
# and on phase 6's LSTM classifier
AMP_BIG_BATCH = 256
# each step on the kernel route: the 49 supported conv+BN chains launch
# both training kernels on bfloat16 x, the update one momentum_arena, and
# the 4 + 4 others take the plain chain
AMP_WANT = ({"bfloat16": KERNEL_CONVS}, {"bfloat16": KERNEL_CONVS}, 1,
            2 * PLAIN_CONVS)
# step 1, kernel route vs plain route, both under AMP. Every conv output
# is rounded to bfloat16 on both routes, the kernels' sums and cuDNN's in
# other orders: wherever the float32 sums straddle a bfloat16 rounding
# boundary the two roundings land a step (2^-8 of the value) apart, and
# batch statistics carry such moves through the 53 layers. Loss: the
# logits come out of a bfloat16 GEMM, so the loss of either route is as
# good as one step of the logits; within max(AMP_LOSS_MIN, FLOOR_FACTOR x
# the loss's own floor), the floor measured as the parameters' is below.
# Parameters: ‖Δ‖₂/‖ref‖₂ within FLOOR_FACTOR times the parameter's own
# floor (plain-route AMP steps on the batch in FLOOR_ORDERS permuted
# orders, as phase 4), and never below AMP_REL_MIN: the plain route's
# filter gradients come back rounded to bfloat16 (the reference's jnp
# vjp), the kernel's in float32, which alone puts each element up to half
# a step apart (2^-9, ‖Δ‖₂/‖ref‖₂ ≈ 2^-9/√3 ≈ 1.1e-3), so a floor below
# 2^-8 is no floor for this check. (On an NVIDIA H100 80GB HBM3 at 700.00
# W, --seed 0: the conv filters' and BN scales' and biases' floors are
# ~1.0, the step-1 gradient below the head being set by bfloat16 rounding
# on either route; the running statistics' 4.5e-4-2.3e-3.)
AMP_LOSS_MIN, AMP_REL_MIN = 2.0 ** -8, 2.0 ** -8
# step 1's update under AMP against the same step in float32 (phase 4's
# model and feed, each route against itself in float32), read at the
# reference's own AMP tolerance, tests/test_amp.py:76-77, |Δ| ≤ AMP_ATOL +
# AMP_RTOL·|x|, on every parameter and running statistic, and printed, not
# held: the plain route's own AMP step is outside it at the stem and a few
# other convs (the step-1 gradients below the head are bf16 rounding, above,
# and no route can do better), so it decides nothing (ROADMAP §C)
AMP_RTOL, AMP_ATOL = 0.05, 1e-2
# the test clone's logits, kernel route (conv_affine in bfloat16) vs plain
# route under AMP, max|Δ|/max|ref|: REL_LIMIT's bfloat16 reasoning per
# layer; without batch statistics nothing amplifies a move, so the bound
# of one conv holds the whole forward
AMP_INFER_LIMIT = REL_LIMIT["bfloat16"]
# the LSTM classifier's step 1 under AMP, the kernel route against the same
# program with the LSTM wrappers swapped for their plain versions (phase
# 6's check): float32 reaches the LSTM on both, so the two differ by the
# LSTM kernels' rare bf16(h) moves, as in phase 6, and the loss keeps
# phase 6's limit. But under AMP each fc's weight gradient comes back
# rounded to bfloat16 (mul_grad's Y@GRAD, the reference's dtype), so a
# float32 rounding of difference in its sum moves an element by a whole
# step (2^-8 of itself) wherever the sum lies near a rounding boundary:
# ‖Δ‖₂/‖ref‖₂ ≤ 2^-8 if every element moved. (On an NVIDIA H100 80GB HBM3
# at 700.00 W, --seed 0: fc_2.w_0 1.81e-3 fixed and 2.26e-3 ragged, the
# rest ≤ 1.57e-3.)
AMP_TEXTCLS_LOSS_LIMIT = TEXTCLS_LOSS_LIMIT
AMP_TEXTCLS_GRAD_LIMIT = max(TEXTCLS_GRAD_LIMIT, 2.0 ** -8)


def amp_launches(cbk, opk, tier):
    """(conv_bn_train and conv_bn_bwd launches by x's dtype, momentum_arena
    launches, plain-routed conv+BN chains) since the last reset."""
    return (dict(cbk.launches_by_dtype["conv_bn_train"]),
            dict(cbk.launches_by_dtype["conv_bn_bwd"]),
            opk.launches["momentum_arena"],
            tier.fallback_counts().get("conv_bn", 0))


@contextlib.contextmanager
def replayed_through_plain(cbk, found,
                           names=("conv_affine", "conv_bn_train",
                                  "conv_bn_bwd")):
    """While on, each call the program makes to a conv kernel wrapper also
    runs the wrapper's plain version (``*_torch``) on the same inputs, the
    program's own tensors, and ``found[wrapper]`` gathers the calls, x's
    dtypes and the worst max|kernel − plain|/max|plain| over the outputs
    (inf where a dtype or shape differs), with the shapes it came at. A
    conv_bn_bwd under a relu is held on dy zeroed where the pre-activation
    lies within MASK_MARGIN of 0 (see MASK_MARGIN: the two versions round
    the recomputed conv in other orders, and a flipped mask moves a whole
    dy term), both versions run on that dy; its worst on the program's dy
    itself is gathered as ``unmasked``. The program gets the kernel's
    outputs on its own inputs. ``names``: the wrappers replayed. A keyword
    argument (the tile) goes to the kernel alone: the plain version has
    no tile."""
    real = {n: getattr(cbk, n) for n in names}

    def worst(got, ref):
        out = 0.0
        for g, r in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (got, ref))):
            if g.dtype != r.dtype or g.shape != r.shape:
                return float("inf")
            out = max(out, ((g.float() - r.float()).abs().max()
                            / r.float().abs().max().clamp_min(1e-30)).item())
        return out

    def wrap(name):
        kernel, plain = real[name], getattr(cbk, f"{name}_torch")

        def call(*args, **kw):
            got = kernel(*args, **kw)
            rec = found.setdefault(name, dict(calls=0, dtypes=set(),
                                              rel=0.0, at=None,
                                              unmasked=0.0))
            rec["calls"] += 1
            rec["dtypes"].add(str(args[0].dtype).removeprefix("torch."))
            held, kept = args, got
            if name == "conv_bn_bwd" and args[-1] == "relu":
                x, w, dy, scale, bias, mean, var, eps, strides, paddings, _ \
                    = args
                a, b, _ = cbk._fold(scale, bias, mean, var, eps)
                pre = cbk.conv_affine_torch(x, w, a, b, strides, paddings,
                                            "").float().abs()
                held = (x, w, dy * (pre > MASK_MARGIN * pre.max())) \
                    + args[3:]
                rec["unmasked"] = max(rec["unmasked"],
                                      worst(got, plain(*args)))
                kept = kernel(*held, **kw)
            rel = worst(kept, plain(*held))
            if not rel <= rec["rel"]:
                rec["rel"] = rel
                rec["at"] = (tuple(args[0].shape), tuple(args[1].shape))
            return got
        return call

    for n in names:
        setattr(cbk, n, wrap(n))
    try:
        yield found
    finally:
        for n, fn in real.items():
            setattr(cbk, n, fn)


def non_float32_state(torch, main, scope):
    """The persistable floating-point tensors of ``scope`` that are not
    float32: AMP keeps parameters, optimizer state and running statistics
    in float32."""
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable and scope.has_var(v.name)
                  and hasattr(scope.find_var(v.name), "dtype")
                  and scope.find_var(v.name).is_floating_point()
                  and scope.find_var(v.name).dtype != torch.float32)


def amp_kernel_times(torch, fluid, main, batch, seed):
    """conv_bn_train, conv_bn_bwd (per training step) and conv_affine (per
    forward) in bfloat16 at ``batch`` over ResNet-50's kernel-routed
    shapes: each against its plain version (REL_LIMIT's bfloat16 limit),
    then the kernel's, the plain version's and the library's times and
    the bound (the GEMMs at the bfloat16 tensor-core rate, the rest at
    float32's CUDA-core rate, against the bytes at 3.35 TB/s), summed over
    the step. Returns {kernel: sums}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 16)
    bf16 = torch.bfloat16

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    names = ("conv_bn_train", "conv_bn_bwd", "conv_affine")
    out = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   gemm=0, elem=0, bytes=0, rel=0.0) for k in names}
    log(f"\n== bf16 kernels at batch {batch}, per shape: kernel_ms "
        "plain_ms library_ms bound_ms for conv_bn_train; conv_bn_bwd; "
        "conv_affine ==")
    for key, count in sorted(fused_conv_shapes(fluid, main, batch).items(),
                             key=lambda kv: (-kv[0][0][1], kv[0][1][1],
                                             kv[0][1][0], kv[0][2])):
        x_shape, w_shape, strides, paddings, _, _, act = key
        if not cbk.supported(x_shape, w_shape, strides, paddings, (1, 1), 1,
                             "NHWC", "bfloat16"):
            continue
        cout, cin, kh, kw = w_shape
        x = randn(x_shape).to(bf16)
        w = randn(w_shape, (2.0 / (cin * kh * kw)) ** 0.5)
        scale = torch.rand(cout, generator=gen, device=dev) + 0.5
        bias = randn((cout,), 0.1)
        args = (EPS, strides, paddings, act)
        y, mean, var = cbk.conv_bn_train_torch(x, w, scale, bias, *args)
        dy = randn(y.shape)
        if act == "relu":
            # see MASK_MARGIN
            pre = cbk.conv_bn_train_torch(x, w, scale, bias, EPS, strides,
                                          paddings, "")[0].float().abs()
            dy = dy * (pre > MASK_MARGIN * pre.max())
        dy = dy.to(bf16)
        a, b, _ = cbk._fold(scale, bias, mean, var, EPS)
        xn = x.permute(0, 3, 1, 2)
        rm, rv = torch.zeros_like(scale), torch.ones_like(scale)
        leaves = [t.detach().requires_grad_(True)
                  for t in (xn, w.to(bf16), scale, bias)]

        def composite(xc, wc, sc, bi):
            yc = F.batch_norm(F.conv2d(xc, wc, stride=strides,
                                       padding=paddings),
                              rm, rv, sc, bi, training=True, eps=EPS)
            return F.relu(yc) if act == "relu" else yc

        with torch.enable_grad():
            y_lib = composite(*leaves)
        dy_n = dy.permute(0, 3, 1, 2)
        wa, ba = (w * a.view(-1, 1, 1, 1)).to(bf16), b.to(bf16)

        def affine_lib():
            yc = F.conv2d(xn, wa, ba, stride=strides, padding=paddings)
            return torch.relu(yc) if act == "relu" else yc

        calls = {
            "conv_bn_train": (
                lambda: cbk.conv_bn_train(x, w, scale, bias, *args),
                lambda: cbk.conv_bn_train_torch(x, w, scale, bias, *args),
                lambda: composite(*[t.detach() for t in leaves])),
            "conv_bn_bwd": (
                lambda: cbk.conv_bn_bwd(x, w, dy, scale, bias, mean, var,
                                        *args),
                lambda: cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, mean,
                                              var, *args),
                lambda: torch.autograd.grad(y_lib, leaves, dy_n,
                                            retain_graph=True)),
            "conv_affine": (
                lambda: cbk.conv_affine(x, w, a, b, strides, paddings, act),
                lambda: cbk.conv_affine_torch(x, w, a, b, strides, paddings,
                                              act),
                affine_lib)}
        row = []
        for name in names:
            kfn, pfn, lfn = calls[name]
            got, ref = kfn(), pfn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for g, r in zip(got, ref):
                if g.dtype != r.dtype or g.shape != r.shape:
                    fail(f"{name} bf16 x{x_shape} w{w_shape}: got "
                         f"{g.dtype}{tuple(g.shape)}, want "
                         f"{r.dtype}{tuple(r.shape)}")
                rel = (g.float() - r.float()).abs().max().item() \
                    / max(r.float().abs().max().item(), 1e-30)
                out[name]["rel"] = max(out[name]["rel"], rel)
                if not rel <= REL_LIMIT["bfloat16"]:
                    fail(f"{name} bf16 x{x_shape} w{w_shape} s{strides} "
                         f"act={act!r} at batch {batch}: rel err "
                         f"{rel:.3e} > {REL_LIMIT['bfloat16']:.0e}")
            del got, ref
            if name == "conv_affine":
                gemm, elem, nbytes = conv_work(x_shape, w_shape, strides,
                                               paddings, 2)
            else:
                gemm, elem, nbytes = bn_work(x_shape, w_shape, strides,
                                             paddings, 2,
                                             name == "conv_bn_bwd")
            bound, _by, _ = bn_bound_ms(gemm, elem, nbytes, "bfloat16")
            times = (time_ms(kfn, torch), time_ms(pfn, torch),
                     time_ms(lfn, torch), bound)
            t = out[name]
            for field, v in zip(("ms", "plain_ms", "library_ms",
                                 "bound_ms"), times):
                t[field] += count * v
            for field, v in (("gemm", gemm), ("elem", elem),
                             ("bytes", nbytes)):
                t[field] += count * v
            row.append(" ".join(f"{v:.4f}" for v in times))
        del y_lib, leaves
        log(f"  {list(x_shape)} {list(w_shape)} {strides[0]} "
            f"{act or '-':4} {count} | " + "; ".join(row))
    for name in names:
        t = out[name]
        t["bound_by"] = bn_bound_ms(t["gemm"], t["elem"], t["bytes"],
                                    "bfloat16")[1]
        per = "forward" if name == "conv_affine" else "step"
        log(f"  per {per} at batch {batch}, {name} in bfloat16: kernel "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, library "
            f"{t['library_ms']:.3f} ms ({t['ms'] / t['library_ms']:.2f}x), "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}; "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of it reached), "
            f"{t['gemm'] / t['ms'] / 1e9:.1f} TFLOP/s of GEMM; max rel "
            f"err {t['rel']:.3e} (limit {REL_LIMIT['bfloat16']:.0e})")
    return out


def phase_amp_resnet(torch, fluid, seed, card, problems, f32_stats):
    """ResNet-50 under Executor(amp=True) at batch 32 on both routes, then
    its test clone, then 5 steps at batch 256; adds what its checks find to
    ``problems`` and returns the kernel launches of those main-path runs.
    ``f32_stats``: phase 4's {route: (ms a step, peak GiB)}."""
    import re
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops import conv_ops, fused_ops, matmul
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    log(f"\n== phase 16: ResNet-50 under AMP, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps on one feed staged on the card in bfloat16 "
        "==")
    main, startup, loss, test, logits = build_resnet50_train(
        fluid, seed, with_test=True)
    block = main.global_block()
    exe, exe32 = fluid.Executor(amp=True), fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    dev = torch.device("cuda", 0)

    def fresh():
        return copy_scope(fluid, torch, init)

    rng = np.random.RandomState(seed)          # phase 4's feed
    img = rng.normal(0, 1, (TRAIN_BATCH, IMAGE, IMAGE, 3)).astype("float32")
    label = rng.randint(0, CLASSES, (TRAIN_BATCH, 1)).astype("int64")
    feed32 = {"img": img, "label": label}
    feed = {"img": torch.from_numpy(img).to(dev).to(torch.bfloat16),
            "label": label}
    update, = [op for op in block.ops if op.type == "fused_momentum"]
    grads = dict(zip(update.input("Params"), update.input("Grads")))
    stats = [p.name for p in block.all_parameters() if p.name not in grads]
    params = list(grads) + stats

    def run(route, scope, fd, fetch=(), executor=exe, program=main,
            first=loss):
        fluid.set_flags({"kernel_tier": route})
        try:
            return executor.run(program, feed=fd,
                                fetch_list=[first] + list(fetch),
                                scope=scope, return_numpy=False)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})

    def reset():
        cbk.reset_launches()
        opk.reset_launches()
        tier.reset_fallback_counts()

    def readings(vals, scope):
        out = dict(zip(grads, vals[1:]))
        for n in stats:
            out[n] = scope.find_var(n).double() - init.find_var(n).double()
        return out

    def launch_problem(counts, want=AMP_WANT):
        if counts != want:
            return (f"conv_bn_train/conv_bn_bwd launches by dtype, "
                    f"momentum_arena launches and plain-routed convs "
                    f"{counts}, want {want}")
        return None

    res = {}
    for route in ("auto", "torch"):
        scope = fresh()
        losses, ms, total = [], [], [0, 0, 0]
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            reset()
            t0 = time.perf_counter()
            vals = run(route, scope, feed, grads.values() if step == 0
                       else ())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = amp_launches(cbk, opk, tier)
            bad = launch_problem(counts, AMP_WANT if route == "auto"
                                 else ({}, {}, 0, 0))
            if bad:
                fail(f"AMP kernel_tier={route} step {step + 1}: {bad}")
            total[0] += sum(counts[0].values())
            total[1] += sum(counts[1].values())
            total[2] += counts[2]
            wrong = non_float32_state(torch, main, scope)
            if wrong:
                fail(f"AMP kernel_tier={route} step {step + 1}: state not "
                     f"float32: {wrong[:5]} ({len(wrong)})")
            lv = vals[0]
            if lv.shape != () or lv.dtype != torch.float32 \
                    or not torch.isfinite(lv).item():
                fail(f"AMP kernel_tier={route} step {step + 1}: loss {lv}")
            losses.append(lv.item())
            if step == 0:
                step1 = readings(vals, scope)
                after1 = {n: scope.find_var(n).clone() for n in params}
        peak = torch.cuda.max_memory_allocated()
        steady = sum(ms[1:]) / len(ms[1:])
        res[route] = dict(losses=losses, step1=step1, total=total,
                          after1=after1)
        f32 = f32_stats[route]
        log(f"AMP kernel_tier={route}: losses "
            + " ".join(f"{v:.6f}" for v in losses)
            + " | ms/step " + " ".join(f"{v:.1f}" for v in ms)
            + f" | steady {steady:.2f} ms/step, "
            f"{TRAIN_BATCH * 1e3 / steady:.1f} images/s | peak memory "
            f"{peak / 2 ** 30:.2f} GiB ({(peak - start) / 2 ** 30:.3f} GiB "
            "above the start)"
            + f" | phase 4 (float32): {f32[0]:.2f} ms/step, peak "
            f"{f32[1]:.2f} GiB | {card}")
        log(f"  every parameter, velocity and running statistic float32 "
            f"after each of the {TRAIN_STEPS} steps; state not float32: "
            "none")

    # the bf16 floor: plain-route AMP steps on the batch in other orders;
    # the last order is held out and only printed against the limits
    ref = res["torch"]["step1"]
    ref_loss = res["torch"]["losses"][0]
    floors, loss_floors = [], []
    for j in range(FLOOR_ORDERS + 1):
        perm = np.random.RandomState(seed + 1 + j).permutation(TRAIN_BATCH)
        scope = fresh()
        fd = {"img": feed["img"][torch.from_numpy(perm).to(dev)],
              "label": label[perm]}
        vals = run("torch", scope, fd, grads.values())
        floors.append(spread(readings(vals, scope), ref))
        loss_floors.append(abs(vals[0].item() - ref_loss) / abs(ref_loss))
    held_out = floors.pop()
    floor = {n: max(f[n] for f in floors) for n in ref}
    limit = {n: max(AMP_REL_MIN, FLOOR_FACTOR * floor[n]) for n in ref}
    loss_limit = max(AMP_LOSS_MIN, FLOOR_FACTOR * max(loss_floors[:-1]))
    got = spread(res["auto"]["step1"], ref)
    dl = abs(res["auto"]["losses"][0] - ref_loss) / abs(ref_loss)
    log(f"step 1 under AMP, kernel vs plain route: loss rel diff {dl:.3e} "
        f"(limit {loss_limit:.3e}; the plain route's in {FLOOR_ORDERS} "
        f"other orders " + " ".join(f"{v:.3e}" for v in loss_floors[:-1])
        + f", held out {loss_floors[-1]:.3e}); per parameter ‖Δ‖₂/‖ref‖₂ "
        f"against max({AMP_REL_MIN:.2e}, {FLOOR_FACTOR}x its bf16 floor):")
    log("  kind           n | kernel vs plain: median, worst/limit | "
        "floor median | held-out order: worst/limit")
    kinds = {}
    for n in ref:
        kinds.setdefault(re.sub(r"_\d+\.", ".", n), []).append(n)

    def median(vals):
        vals = sorted(vals)
        return vals[len(vals) // 2]

    for kind, names in sorted(kinds.items()):
        log(f"  {kind:12} {len(names):3d} | "
            f"{median(got[n] for n in names):.3e}, "
            f"{max(got[n] / limit[n] for n in names):.3f} | "
            f"{median(floor[n] for n in names):.3e} | "
            f"{max(held_out[n] / limit[n] for n in names):.3f}")
    worst = max(ref, key=lambda n: got[n] / limit[n])
    log(f"  worst: {worst} {got[worst]:.3e} (limit {limit[worst]:.3e})")
    if not dl <= loss_limit:
        problems.append(f"AMP step-1 loss differs from the plain route by "
                        f"{dl:.3e} > {loss_limit:.3e}")
    over = [n for n in ref if not got[n] <= limit[n]]
    if over:
        problems.append(f"AMP: {len(over)} parameters differ from the "
                        f"plain route at step 1 beyond their limits, worst "
                        f"{worst} {got[worst]:.3e} > {limit[worst]:.3e}")

    # against float32, a reading (see AMP_RTOL): each route's step 1
    # against the same step in float32 on that route
    ratio = {}
    for route in ("auto", "torch"):
        scope = fresh()
        run(route, scope, feed32, executor=exe32)
        ratio[route] = {}
        for n in params:
            a = res[route]["after1"][n].double()
            b = scope.find_var(n).double()
            ratio[route][n] = ((a - b).abs()
                               / (AMP_ATOL + AMP_RTOL * b.abs())).max().item()
        del scope
    log(f"step 1's update under AMP against float32, |Δ|/(atol + "
        f"rtol·|f32|) at rtol {AMP_RTOL}, atol {AMP_ATOL} "
        "(tests/test_amp.py:76-77; a reading, not a limit), per kind: "
        "within the tolerance, kernel route / plain route; worst, kernel / "
        "plain")
    for kind, names in sorted(kinds.items()):
        log(f"  {kind:12} {len(names):3d} | "
            f"{sum(ratio['auto'][n] <= 1 for n in names)} / "
            f"{sum(ratio['torch'][n] <= 1 for n in names)} | "
            f"{max(ratio['auto'][n] for n in names):.3f} / "
            f"{max(ratio['torch'][n] for n in names):.3f}")
    worst_n = max(params, key=lambda n: ratio["auto"][n])
    log(f"  worst: {worst_n} {ratio['auto'][worst_n]:.3f} (plain route "
        f"{ratio['torch'][worst_n]:.3f}); within the tolerance on both "
        f"routes: {sum(max(ratio[r][n] for r in ratio) <= 1 for n in params)}"
        f" of {len(params)}")

    # each conv kernel launch of an AMP training step and of a test-clone
    # forward, replayed through the kernel's plain version on the program's
    # own inputs: a wrong bf16 kernel anywhere below the head shows here,
    # where the step-1 checks above cannot see it for bf16 rounding
    found = {}
    with replayed_through_plain(cbk, found):
        run("auto", fresh(), feed)
        scope = fresh()
        overwrite_bn_stats(test, scope, torch, seed)
        run("auto", scope, feed, (), program=test, first=logits)
    torch.cuda.synchronize()
    del scope
    for name in ("conv_bn_train", "conv_bn_bwd", "conv_affine"):
        rec = found.get(name, dict(calls=0, dtypes=set(), rel=0.0, at=None,
                                   unmasked=0.0))
        log(f"{name} replayed through its plain version on the program's "
            f"own inputs under AMP: {rec['calls']} calls on "
            f"{sorted(rec['dtypes'])}, worst max|Δ|/max|ref| "
            f"{rec['rel']:.3e} at x, w {rec['at']} (limit "
            f"{REL_LIMIT['bfloat16']:.0e})"
            + (f"; on the unmasked dy {rec['unmasked']:.3e}, relu masks "
               "decided by a rounding" if name == "conv_bn_bwd" else ""))
        if rec["calls"] != KERNEL_CONVS or rec["dtypes"] != {"bfloat16"} \
                or not rec["rel"] <= REL_LIMIT["bfloat16"]:
            problems.append(f"AMP {name} on the program's own inputs: "
                            f"{rec['calls']} calls on {rec['dtypes']}, worst "
                            f"{rec['rel']:.3e} at {rec['at']}, want "
                            f"{KERNEL_CONVS} on bfloat16 within "
                            f"{REL_LIMIT['bfloat16']:.0e}")

    # a float32 feed: cast_compute rounds the images at the stem, so the
    # same bf16 launches and bitwise the same loss as the staged bf16 feed
    reset()
    lv = run("auto", fresh(), feed32)[0].item()
    counts = amp_launches(cbk, opk, tier)
    bad = launch_problem(counts)
    log(f"float32 numpy feed under AMP: {counts}, loss {lv:.6f} (staged "
        f"bf16 feed {res['auto']['losses'][0]:.6f})")
    if bad:
        problems.append(f"AMP with a float32 feed: {bad}")
    if lv != res["auto"]["losses"][0]:
        problems.append(f"AMP with a float32 feed: loss {lv!r}, the bf16 "
                        f"feed's {res['auto']['losses'][0]!r}")

    # the check's own test: the same step with cast_compute disabled in
    # the GEMM ops (a scratch swap of their module-level name) must fail
    # the launch check
    swapped = [conv_ops, fused_ops, matmul]
    real = [m.cast_compute for m in swapped]
    for m in swapped:
        m.cast_compute = lambda *ts: ts if len(ts) > 1 else ts[0]
    try:
        reset()
        run("auto", fresh(), feed32)
        counts = amp_launches(cbk, opk, tier)
    finally:
        for m, fn in zip(swapped, real):
            m.cast_compute = fn
    bad = launch_problem(counts)
    log(f"planted fault: cast_compute off in conv2d, fused_conv2d_bn and "
        f"mul: {counts} -> "
        + ("caught" if bad else "NOT caught"))
    if not bad:
        problems.append("the launch check does not see cast_compute off")

    for route in ("auto", "torch"):
        losses = res[route]["losses"]
        if not losses[-1] < losses[0]:
            problems.append(f"AMP kernel_tier={route}: loss did not fall "
                            f"over {TRAIN_STEPS} steps: {losses}")

    # the test clone: one forward, conv_affine on bf16, against the plain
    # route; non-trivial BN statistics as phase 3's
    scope = fresh()
    overwrite_bn_stats(test, scope, torch, seed)
    reset()
    out_k = run("auto", scope, feed, (), program=test, first=logits)[0]
    torch.cuda.synchronize()
    affine = dict(cbk.launches_by_dtype["conv_affine"])
    fallbacks = tier.fallback_counts().get("conv_bn", 0)
    out_p = run("torch", scope, feed, (), program=test, first=logits)[0]
    rel = ((out_k.float() - out_p.float()).abs().max()
           / out_p.float().abs().max()).item()
    log(f"test clone under AMP: conv_affine launches {affine}, "
        f"{fallbacks} plain-routed convs; logits {out_k.dtype} "
        f"{tuple(out_k.shape)}, max|Δ|/max|ref| against the plain route "
        f"{rel:.3e} (limit {AMP_INFER_LIMIT:.0e})")
    if affine != {"bfloat16": KERNEL_CONVS} or fallbacks != PLAIN_CONVS:
        fail(f"AMP test clone: conv_affine launches {affine} and "
             f"{fallbacks} plain-routed convs, want "
             f"{{'bfloat16': {KERNEL_CONVS}}} and {PLAIN_CONVS}")
    if not torch.isfinite(out_k).all().item() or not rel <= AMP_INFER_LIMIT:
        problems.append(f"AMP test clone: logits {rel:.3e} from the plain "
                        "route")
    del scope, out_k, out_p

    step_scope = fresh()
    profile(torch, lambda: run("auto", step_scope, feed),
            f"one AMP training step, batch {TRAIN_BATCH}, kernel route",
            card, reps=2, groups=CONV_BN_LAUNCHES)
    launches = dict(zip(("conv_bn_train", "conv_bn_bwd", "momentum_arena"),
                        res["auto"]["total"]),
                    conv_affine=affine.get("bfloat16", 0))
    del step_scope, init, res

    for k, v in phase_amp_flagship(torch, fluid, seed, card,
                                   problems).items():
        launches[k] += v
    return launches


def phase_amp_flagship(torch, fluid, seed, card, problems):
    """5 AMP steps of ResNet-50 at the flagship's batch (bench.py:2949) on
    the kernel route, the images staged on the card in bfloat16, at phase
    4's rate. Adds what its checks find to ``problems`` and returns the
    launches of the run."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    log(f"\n== phase 16: ResNet-50 under AMP at the flagship's batch "
        f"{AMP_BIG_BATCH}, lr {TRAIN_LR}, {TRAIN_STEPS} steps, kernel route "
        "==")
    main, startup, loss = build_resnet50_train(fluid, seed)
    exe = fluid.Executor(amp=True)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 256)
    feed = {"img": torch.randn((AMP_BIG_BATCH, IMAGE, IMAGE, 3),
                               generator=gen, device=dev)
            .to(torch.bfloat16),
            "label": np.random.RandomState(seed + 256).randint(
                0, CLASSES, (AMP_BIG_BATCH, 1)).astype("int64")}
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, total = [], [], [0, 0, 0]
    for step in range(TRAIN_STEPS):
        cbk.reset_launches()
        opk.reset_launches()
        tier.reset_fallback_counts()
        t0 = time.perf_counter()
        lv = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                     return_numpy=False)[0]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = amp_launches(cbk, opk, tier)
        if counts != AMP_WANT:
            fail(f"AMP batch {AMP_BIG_BATCH} step {step + 1}: launches "
                 f"{counts}, want {AMP_WANT}")
        total[0] += sum(counts[0].values())
        total[1] += sum(counts[1].values())
        total[2] += counts[2]
        if not torch.isfinite(lv).item():
            fail(f"AMP batch {AMP_BIG_BATCH} step {step + 1}: loss {lv}")
        losses.append(lv.item())
    peak = torch.cuda.max_memory_allocated()
    wrong = non_float32_state(torch, main, scope)
    steady = sum(ms[1:]) / len(ms[1:])
    log(f"batch {AMP_BIG_BATCH} under AMP: losses "
        + " ".join(f"{v:.6f}" for v in losses)
        + " | ms/step " + " ".join(f"{v:.1f}" for v in ms)
        + f" | steady {steady:.2f} ms/step, "
        f"{AMP_BIG_BATCH * 1e3 / steady:.1f} images/s | a step's peak "
        f"memory {(peak - start) / 2 ** 30:.3f} GiB above its start "
        f"({start / 2 ** 30:.3f} GiB), {peak / 2 ** 30:.2f} GiB in all | "
        f"{card}")
    if wrong:
        problems.append(f"AMP batch {AMP_BIG_BATCH}: state not float32: "
                        f"{wrong[:5]}")
    if not losses[-1] < losses[0]:
        problems.append(f"AMP batch {AMP_BIG_BATCH}: loss did not fall over "
                        f"{TRAIN_STEPS} steps: {losses}")
    profile(torch, lambda: exe.run(main, feed=feed, scope=scope),
            f"one AMP training step, batch {AMP_BIG_BATCH}, kernel route",
            card, reps=1, groups=CONV_BN_LAUNCHES)
    return dict(zip(("conv_bn_train", "conv_bn_bwd", "momentum_arena"),
                    total))


def phase_amp_textcls(torch, fluid, seed, card, f32_stats):
    """Phase 6's LSTM classifier under Executor(amp=True): train_phase on
    both routes; the fc GEMMs' outputs must be bfloat16 and float32 must
    reach the LSTM kernels. ``f32_stats``: phase 6's {route: (ms a step,
    peak GiB)}. Returns the launches."""
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    log(f"\n== phase 16: LSTM text classifier under AMP, batch "
        f"{SEQ_BATCH}, length {SEQ_LEN}, {SEQ_STEPS} steps on one feed ==")
    main, startup, loss = build_textcls(fluid, seed)
    block = main.global_block()
    weights = [op.input("Weight")[0] for op in block.ops
               if op.type == "lstm_grad"]
    mul_outs = [op.output("Out")[0] for op in block.ops if op.type == "mul"]
    dtypes = []
    real = rnn.supported

    def spy(batch, hidden, dtype, device=None):
        dtypes.append(dtype)
        return real(batch, hidden, dtype, device)

    rnn.supported = spy
    try:
        totals, trained, exe, stats = train_phase(torch, fluid, card, dict(
            title="LSTM text classifier under AMP", main=main,
            startup=startup, loss=loss, batch=SEQ_BATCH, amp=True,
            feeds=[("fixed", textcls_feeds(fluid, seed, ragged=False)),
                   ("ragged", textcls_feeds(fluid, seed, ragged=True))],
            counters=[("lstm_seq", lambda: rnn.launches["lstm_seq"]),
                      ("lstm_seq_bwd", lambda: rnn.launches["lstm_seq_bwd"]),
                      ("adam_arena", lambda: opk.launches["adam_arena"]),
                      ("plain-routed LSTMs",
                       lambda: tier.fallback_counts().get("lstm", 0))],
            resets=[rnn.reset_launches, opk.reset_launches,
                    tier.reset_fallback_counts],
            want=(2, 2, 1, 0),
            swaps=[(rnn, "lstm_seq", rnn.lstm_seq_torch),
                   (rnn, "lstm_seq_bwd", rnn.lstm_seq_bwd_torch)],
            plant=dict(module=rnn, attr="lstm_seq_bwd", index=1,
                       at=len(weights) - 1, calls=len(weights),
                       param=weights[-1], what="dW"),
            loss_limit=AMP_TEXTCLS_LOSS_LIMIT,
            grad_limit=AMP_TEXTCLS_GRAD_LIMIT))
    finally:
        rnn.supported = real
    reached = sorted({str(d) for d in dtypes})
    outs = exe.run(main, feed=textcls_feeds(fluid, seed, ragged=False),
                   fetch_list=mul_outs, scope=trained, return_numpy=False)
    got = sorted({str(getattr(v, "data", v).dtype) for v in outs})
    log(f"under AMP: the {len(mul_outs)} fc GEMMs' outputs {got}; dtypes "
        f"reaching the LSTM kernels' supported(): {reached}")
    if got != ["torch.bfloat16"] or reached != ["torch.float32"]:
        fail(f"LSTM classifier under AMP: fc outputs {got}, LSTM inputs "
             f"{reached}, want bfloat16 and float32")
    for route in ("auto", "torch"):
        amp, f32 = stats[route], f32_stats[route]
        log(f"kernel_tier={route}: {amp[0]:.2f} ms/step and peak "
            f"{amp[1]:.2f} GiB under AMP against phase 6's {f32[0]:.2f} "
            f"ms/step and {f32[1]:.2f} GiB | {card}")
    return totals


def phase_amp(torch, fluid, seed, card, f32_stats):
    """Phase 16: AMP on ResNet-50 (batch 32 on both routes, the test clone,
    batch 256) and on the LSTM classifier, then the bf16 conv kernels'
    times at batches 32 and 256. ``f32_stats``: phases 4's and 6's
    {route: (ms a step, peak GiB)} under "resnet" and "textcls". Returns
    (the main path's launches, the bf16 kernel sums at batch 32)."""
    log("\n== phase 16: automatic mixed precision (bf16 compute, float32 "
        "master weights) ==")
    problems = []
    launches = phase_amp_resnet(torch, fluid, seed, card, problems,
                                f32_stats["resnet"])
    launches.update(phase_amp_textcls(torch, fluid, seed, card,
                                      f32_stats["textcls"]))
    main, _, _ = build_resnet50_train(fluid, seed)
    sums = amp_kernel_times(torch, fluid, main, TRAIN_BATCH, seed)
    amp_kernel_times(torch, fluid, main, AMP_BIG_BATCH, seed)
    if problems:
        fail("phase 16: " + "; ".join(problems))
    return launches, sums


# ---------------------------------------------------------------------------
# phase 17: the runtime — the program verifier and lint, the Executor's
# run_steps / prepare_steps / run_prepared, its per-op hooks and the
# per-version analysis cache, on phases 3, 4, 6, 11 and 13's models
# ---------------------------------------------------------------------------

RT_STEPS = 5           # run_steps K, and the run() calls it is held to
RT_REPS = 5            # timing repetitions of the host readings
RT_SPREAD_FACTOR = 2.0  # run_steps within 2x the run-to-run spread, if any
RT_FLAGS = ("verify_passes", "executor_verify", "check_nan_inf",
            "benchmark", "obs_op_metrics")


def median_ms(fn, reps=RT_REPS):
    """Median host milliseconds of ``fn()`` over ``reps`` calls."""
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2]


def scope_tensors(torch, scope):
    return {n: scope.find_var(n) for n in scope.local_names()
            if torch.is_tensor(scope.find_var(n))}


def scope_spread(torch, a, b):
    """(tensors that differ, worst ‖a − b‖₂ / ‖b‖₂) over two scopes."""
    ta, tb = scope_tensors(torch, a), scope_tensors(torch, b)
    if sorted(ta) != sorted(tb):
        fail(f"scopes hold different names: {sorted(set(ta) ^ set(tb))}")
    diff = [n for n in tb if not torch.equal(ta[n], tb[n])]
    worst = max((((ta[n].double() - tb[n].double()).norm()
                  / tb[n].double().norm().clamp_min(1e-30)).item()
                 for n in diff), default=0.0)
    return diff, worst


def first_differing_op(torch, exe, main, feed, sa, sb):
    """The first op of one step whose output differs between two runs from
    the scopes ``sa`` and ``sb`` (every op output fetched)."""
    block = main.global_block()
    names = list(dict.fromkeys(n for op in block.ops
                               for n in op.output_arg_names()))
    va = exe.run(main, feed=feed, fetch_list=names, scope=sa,
                 return_numpy=False)
    vb = exe.run(main, feed=feed, fetch_list=names, scope=sb,
                 return_numpy=False)
    got = dict(zip(names, zip(va, vb)))
    for i, op in enumerate(block.ops):
        for n in op.output_arg_names():
            a, b = got[n]
            if torch.is_tensor(a) and not torch.equal(a, b):
                return f"op#{i} {op.type} output {n}"
    return "none (the outputs of one step agree bitwise)"


def kernel_counters():
    """Every kernel wrapper's launch counter, and their reset."""
    from paddle_tpu_torch.ops.cuda import (conv_bn, ctc, embedding,
                                           optimizer, paged_attention, rnn)
    mods = (conv_bn, ctc, embedding, optimizer, paged_attention, rnn)

    def read():
        return {k: int(v) for m in mods for k, v in dict(m.launches).items()}

    def reset():
        for m in mods:
            m.reset_launches()
    return read, reset


def phase_runtime(torch, fluid, seed, card, serving, gen):
    """Phase 17. Returns each kernel's launches on this phase's path."""
    import io
    import numpy as np
    from paddle_tpu_torch.core import executor as texec
    from paddle_tpu_torch.core.block_walk import free_reads, written_names
    from paddle_tpu_torch.fluid.analysis import (ERROR, lint_program,
                                                 verify_calls,
                                                 verify_program)
    from paddle_tpu_torch.obs.metrics import REGISTRY
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.conv_ops import conv_attrs
    from paddle_tpu_torch.serving import GenerationEngine, InferenceEngine

    log(f"\n== phase 17: runtime — verifier and lint, run_steps, the "
        f"executor's hooks and analysis cache | {card} ==")
    read, reset_launches = kernel_counters()
    total = dict.fromkeys(read(), 0)
    problems = []

    def reset():
        """Zero the launch counters, dropping what they hold."""
        reset_launches()
        tier.reset_fallback_counts()

    def count():
        """Add the launches since the last count() to the phase's total,
        zero the counters and return those launches: every launch of the
        phase is added once."""
        c = read()
        for k, v in c.items():
            total[k] += v
        reset()
        return c

    def errors(diags):
        return [str(d) for d in diags if d.severity == ERROR]

    reset()  # the earlier phases' launches are theirs
    # ---- the verifier on every model, both flags on ----
    fluid.set_flags({"verify_passes": True, "executor_verify": True})
    prev_det = (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        exe = fluid.Executor()
        built = {}
        for name, build in (
                ("resnet50", lambda: build_resnet50_train(fluid, seed)),
                ("lstm_textcls", lambda: build_textcls(fluid, seed)),
                ("word2vec", lambda: build_word2vec(fluid, seed))):
            v0 = verify_calls()
            main, startup, loss = build()
            passes = verify_calls() - v0
            diags = verify_program(main, startup_program=startup,
                                   fetch_names=[loss.name],
                                   raise_on_error=False)
            lints = lint_program(main, fetch_names=[loss.name])
            log(f"{name}: {len(main.global_block().ops)} ops, "
                f"{passes} pass outputs verified while building, "
                f"verify_program {len(errors(diags))} errors, "
                f"{len(diags)} findings; lint {len(lints)} warnings "
                f"({sorted({d.code for d in lints})})")
            if errors(diags) or passes < 1:
                problems.append(f"{name} does not verify clean: "
                                f"{errors(diags)[:3]} ({passes} passes)")
            built[name] = (main, startup, loss)

        main, startup, loss = built["resnet50"]
        block = main.global_block()
        v_ms = median_ms(lambda: verify_program(
            main, startup_program=startup, fetch_names=[loss.name],
            raise_on_error=False))
        l_ms = median_ms(lambda: lint_program(main, fetch_names=[loss.name]))
        walk_ms = median_ms(lambda: (free_reads(main, 0),
                                     written_names(main, 0)), reps=20)
        log(f"ResNet-50 training program ({len(block.ops)} ops): "
            f"verify_program {v_ms:.3f} ms, lint_program {l_ms:.3f} ms, "
            f"free_reads + written_names {walk_ms:.3f} ms (host, median "
            f"of {RT_REPS}/20 calls; the analysis cache takes the walks "
            f"off every run()) | {card}")

        # phase 3's served bundle: load (verified), save under
        # verify_passes, load the copy, serve one image from it
        v0 = verify_calls()
        scope3 = fluid.Scope()
        prog3, feeds3, fetch3 = fluid.io.load_inference_model(
            serving["dir"], exe, scope=scope3)
        d2 = tempfile.mkdtemp(prefix="chip-smoke-resaved-")
        fluid.io.save_inference_model(d2, feeds3, fetch3, exe,
                                      main_program=prog3, scope=scope3)
        eng2, eng3 = InferenceEngine(d2), InferenceEngine(serving["dir"])
        shutil.rmtree(d2)
        x = np.random.RandomState(seed + 17).normal(
            0, 1, (1, IMAGE, IMAGE, 3)).astype("float32")
        count()
        got = eng2.infer({"img": x})
        c = read()
        want = eng3.infer({"img": x})
        count()
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(got, want))
        log(f"phase 3's bundle: loaded, saved under verify_passes, loaded "
            f"again and served: {verify_calls() - v0} verify_program "
            f"calls, conv_affine launches for one image "
            f"{c['conv_affine']} (want {KERNEL_CONVS}), reply bitwise the "
            f"original bundle's {same}")
        if c["conv_affine"] != KERNEL_CONVS or not same:
            problems.append("the re-saved bundle does not serve as phase "
                            "3's does")
        lint = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.lint_program",
             serving["dir"]], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        log(f"lint CLI on phase 3's bundle: exit {lint.returncode}, "
            f"{(lint.stdout.strip().splitlines() or ['?'])[-1]}")
        if lint.returncode != 0:
            problems.append(f"the lint CLI exits {lint.returncode} on "
                            f"phase 3's bundle: {lint.stderr[-400:]}")

        # the LM lane through GenerationEngine under both flags
        v0 = verify_calls()
        geom = dict(max_seqs=GEN_MAX_SEQS, block_size=GEN_BLOCK,
                    num_blocks=GEN_BLOCKS, max_len=GEN_MAX_LEN,
                    prefill_buckets=(8,))
        count()
        eng = GenerationEngine(gen["dir"], **geom)
        eng.warmup()
        calls = verify_calls() - v0
        lane = gen_lane(eng, True)
        c = count()
        decodes = eng.stats()["phases"]["decode"][GEN_MAX_SEQS]["dispatches"]
        log(f"LM lane under verify_passes + executor_verify: "
            f"{calls} verify_program calls (load, 2 phase rewrites, the "
            f"first dispatch of each phase), tokens equal phase 13's "
            f"{lane['tokens'] == gen['tokens']}, paged_attention launches "
            f"{c['paged_attention']} over {decodes} decode dispatches "
            "(warmup's included)")
        if lane["tokens"] != gen["tokens"] \
                or c["paged_attention"] != GEN_LAYERS * decodes \
                or calls != 5:
            problems.append("the LM lane under the verifier flags differs "
                            "from phase 13")

        # ---- run_steps against run() ----
        def hold(name, main, startup, loss, feeds, want):
            """K run() calls (twice) against run_steps(K), launches per
            step; returns the startup state and the run-to-run spread."""
            init = fluid.Scope()
            exe.run(startup, scope=init)
            sa, sa2 = copy_scope(fluid, torch, init), \
                copy_scope(fluid, torch, init)
            sb = copy_scope(fluid, torch, init)
            v0 = verify_calls()
            count()
            seq = [exe.run(main, feed=feeds[i % len(feeds)],
                           fetch_list=[loss], scope=sa,
                           return_numpy=False)[0]
                   for i in range(RT_STEPS)]
            c_run = count()
            verified = verify_calls() - v0
            seq2 = [exe.run(main, feed=feeds[i % len(feeds)],
                            fetch_list=[loss], scope=sa2,
                            return_numpy=False)[0]
                    for i in range(RT_STEPS)]
            count()
            multi = exe.run_steps(main, feeds, fetch_list=[loss], scope=sb,
                                  steps=RT_STEPS, return_numpy=False)[0]
            c_steps = count()
            torch.cuda.synchronize()
            rr_diff, rr = scope_spread(torch, sa2, sa)
            rs_diff, rs = scope_spread(torch, sb, sa)
            loss_rr = torch.equal(torch.stack(seq2), torch.stack(seq))
            loss_rs = torch.equal(multi, torch.stack(seq))
            per_step = {k: v // RT_STEPS for k, v in c_steps.items() if v}
            log(f"{name}: {RT_STEPS} run() calls vs run_steps(K="
                f"{RT_STEPS}, {len(feeds)} feeds): losses bitwise "
                f"{loss_rs}, {len(rs_diff)} state tensors differ (worst "
                f"{rs:.3e}); two run() sequences: losses bitwise "
                f"{loss_rr}, {len(rr_diff)} differ (worst {rr:.3e}); "
                f"launches a step {per_step} (want {want}); "
                f"verify_program calls over the {RT_STEPS} runs "
                f"{verified}; losses "
                + " ".join(f"{v.item():.5f}" for v in seq))
            if rr_diff or not loss_rr:
                where = first_differing_op(
                    torch, exe, main, feeds[0], copy_scope(fluid, torch, init),
                    copy_scope(fluid, torch, init))
                log(f"  run-to-run spread on the card: first differing op "
                    f"of a step: {where}; run_steps held to "
                    f"{RT_SPREAD_FACTOR}x the spread")
                if not rs <= RT_SPREAD_FACTOR * rr:
                    problems.append(f"{name}: run_steps differs from run() "
                                    f"by {rs:.3e}, beyond {RT_SPREAD_FACTOR}"
                                    f"x the run-to-run spread {rr:.3e}")
            elif rs_diff or not loss_rs:
                problems.append(f"{name}: run_steps is not bitwise "
                                f"{RT_STEPS} run() calls ({rs_diff[:3]})")
            for counts in (c_run, c_steps):
                got = {k: v // RT_STEPS for k, v in counts.items()
                       if k in want}
                if got != want or any(counts[k] % RT_STEPS for k in want):
                    problems.append(f"{name}: launches {counts} over "
                                    f"{RT_STEPS} steps, want {want} a step")
            if verified != 1:
                problems.append(f"{name}: executor_verify ran "
                                f"{verified} times over {RT_STEPS} steady "
                                "steps, want 1")
            return init, rr

        rng = np.random.RandomState(seed)
        rfeed = {"img": rng.normal(0, 1, (TRAIN_BATCH, IMAGE, IMAGE, 3))
                 .astype("float32"),
                 "label": rng.randint(0, CLASSES, (TRAIN_BATCH, 1))
                 .astype("int64")}
        want_r = {"conv_bn_train": KERNEL_CONVS, "conv_bn_bwd": KERNEL_CONVS,
                  "momentum_arena": 1}
        rinit, rr = hold("ResNet-50, batch 32", main, startup, loss,
                            [rfeed], want_r)
        # prepare_steps + two run_prepared = 2K run() calls
        sa, sb = copy_scope(fluid, torch, rinit), \
            copy_scope(fluid, torch, rinit)
        for i in range(2 * RT_STEPS):
            exe.run(main, feed=rfeed, fetch_list=[loss], scope=sa,
                    return_numpy=False)
        v0 = verify_calls()
        h = exe.prepare_steps(main, [rfeed], fetch_list=[loss], scope=sb,
                              steps=RT_STEPS)
        count()
        l1 = exe.run_prepared(h, return_numpy=False)[0]
        l2 = exe.run_prepared(h, return_numpy=False)[0]
        c = count()
        diff, worst = scope_spread(torch, sb, sa)
        log(f"ResNet-50: prepare_steps + 2 x run_prepared(K={RT_STEPS}) vs "
            f"{2 * RT_STEPS} run() calls: {len(diff)} state tensors differ "
            f"(worst {worst:.3e}), losses {l1[0].item():.5f} -> "
            f"{l2[-1].item():.5f}, conv_bn_train launches "
            f"{c['conv_bn_train']}, verify_program calls "
            f"{verify_calls() - v0} (the surface was verified)")
        if (diff and not worst <= RT_SPREAD_FACTOR * rr) \
                or c["conv_bn_train"] != 2 * RT_STEPS * KERNEL_CONVS \
                or verify_calls() != v0:
            problems.append("prepare_steps + run_prepared does not continue "
                            "the training as run() does")

        lmain, lstart, lloss = built["lstm_textcls"]
        hold(f"LSTM classifier (b {SEQ_BATCH}, L {SEQ_LEN}, H "
             f"{SEQ_HIDDEN}, LoD)", lmain, lstart, lloss,
             [textcls_feeds(fluid, seed, False),
              textcls_feeds(fluid, seed, True)],
             {"lstm_seq": 2, "lstm_seq_bwd": 2, "adam_arena": 1})
        wmain, wstart, wloss = built["word2vec"]
        hold("word2vec (is_sparse)", wmain, wstart, wloss,
             [word2vec_feed(seed)], {"embedding_sgd": 1, "sgd_arena": 1})

        # ---- check_nan_inf on ResNet-50 ----
        def step_ms(scope, n=3):
            ms = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exe.run(main, feed=rfeed, fetch_list=[loss], scope=scope,
                        return_numpy=False)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return sorted(ms)[len(ms) // 2]

        clean = copy_scope(fluid, torch, rinit)
        step_ms(clean, 1)
        off_ms = step_ms(clean)
        fluid.set_flags({"check_nan_inf": True})
        on_ms = step_ms(clean)
        fluid.set_flags({"check_nan_inf": False})
        log(f"check_nan_inf: a ResNet-50 step {on_ms:.2f} ms with the flag, "
            f"{off_ms:.2f} ms without (+{on_ms - off_ms:.2f} ms: one "
            f"isfinite reduction per output and one sync per op) | {card}")
        # the first conv that launches conv_bn_train
        target = next(op for op in block.ops
                      if op.type == "fused_conv2d_bn"
                      and cbk.supported((TRAIN_BATCH,) + tuple(
                          block.var(op.input("Input")[0]).shape[1:]),
                          tuple(block.var(op.input("Filter")[0]).shape),
                          *conv_attrs(op.attr), "NHWC", "float32"))
        filt = target.input("Filter")[0]
        readers = [op for op in block.ops if filt in op.input_arg_names()]
        planted = copy_scope(fluid, torch, rinit)
        planted.find_var(filt).view(-1)[7] = float("nan")
        want_msg = (f"NaN in output {target.output('Output')[0]!r} of op "
                    f"'fused_conv2d_bn' (check_nan_inf flag)")
        fluid.set_flags({"check_nan_inf": True})
        try:
            exe.run(main, feed=rfeed, fetch_list=[loss], scope=planted)
            msg = "no error"
        except FloatingPointError as e:
            msg = str(e)
        finally:
            fluid.set_flags({"check_nan_inf": False})
        log(f"check_nan_inf with one NaN in {filt} (read first by "
            f"{readers[0].type}): {msg!r}")
        if msg != want_msg or readers[0] is not target:
            problems.append(f"check_nan_inf said {msg!r}, want {want_msg!r}")
        planted = copy_scope(fluid, torch, rinit)
        planted.find_var(filt).view(-1)[7] = float("nan")
        count()
        lv = exe.run(main, feed=rfeed, fetch_list=[loss], scope=planted,
                     return_numpy=False)[0]
        c = count()
        got = {k: c[k] for k in want_r}
        log(f"the flag off, the same step: loss {lv.item()}, launches {got}")
        if got != want_r:
            problems.append(f"with check_nan_inf off the planted step "
                            f"launched {got}, want {want_r}")

        # ---- benchmark and obs_op_metrics ----
        buf = io.StringIO()
        fluid.set_flags({"benchmark": True})
        count()
        try:
            with contextlib.redirect_stdout(buf):
                exe.run(main, feed=rfeed, fetch_list=[loss], scope=clean,
                        return_numpy=False)
        finally:
            fluid.set_flags({"benchmark": False})
        count()
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("[benchmark] ")]
        per_op = {}
        for ln in lines:
            op, ms = ln[len("[benchmark] "):].rsplit(": ", 1)
            per_op[op] = per_op.get(op, 0.0) + float(ms.split()[0])
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:4]
        log(f"benchmark: one ResNet-50 step printed {len(lines)} lines for "
            f"{len(block.ops)} ops; most time by op type (synchronised per "
            "op): " + ", ".join(f"{k} {v:.1f} ms" for k, v in top))
        if len(lines) != len(block.ops):
            problems.append(f"benchmark printed {len(lines)} lines for "
                            f"{len(block.ops)} ops")
        t0 = REGISTRY.totals()
        fluid.set_flags({"obs_op_metrics": True})
        count()
        try:
            for _ in range(3):
                exe.run(main, feed=rfeed, fetch_list=[loss], scope=clean,
                        return_numpy=False)
        finally:
            fluid.set_flags({"obs_op_metrics": False})
        count()
        t1 = REGISTRY.totals()

        def delta(k):
            return t1.get(k, 0) - t0.get(k, 0)

        log(f"obs_op_metrics over 3 steps: op_dispatches "
            f"{delta('paddle_tpu_executor_op_dispatches')} (3 x "
            f"{len(block.ops)} ops), steps "
            f"{delta('paddle_tpu_executor_steps')}, retraces "
            f"{delta('paddle_tpu_executor_retraces')}, op_seconds "
            f"{delta('paddle_tpu_executor_op_seconds') * 1e3 / 3:.2f} ms a "
            "step (dispatch time)")
        if delta("paddle_tpu_executor_op_dispatches") != 3 * len(block.ops) \
                or delta("paddle_tpu_executor_retraces") != 0 \
                or delta("paddle_tpu_executor_steps") != 3:
            problems.append("obs_op_metrics counts are off")

        # ---- the analysis cache: a run() with a warm and a cold cache ----
        fluid.set_flags({"executor_verify": False})
        warm, cold = [], []
        for _ in range(RT_REPS):
            for ms, drop in ((warm, False), (cold, True)):
                if drop:
                    texec._ANALYSIS_CACHE.pop(main, None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exe.run(main, feed=rfeed, fetch_list=[loss], scope=clean,
                        return_numpy=False)
                ms.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
        log(f"one ResNet-50 run() call's host time (enqueue, median of "
            f"{RT_REPS}): warm analysis cache {sorted(warm)[RT_REPS // 2]:.2f}"
            f" ms, cold {sorted(cold)[RT_REPS // 2]:.2f} ms (a reading) | "
            f"{card}")
        count()
    finally:
        fluid.set_flags({f: False for f in RT_FLAGS})
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev_det
    if problems:
        fail("; ".join(problems))
    log("phase 17 launches: " + json.dumps(total))
    return total


# ---------------------------------------------------------------------------
# phase 18: control flow and the Seq2Seq NMT model
# ---------------------------------------------------------------------------

# tests/book/test_machine_translation.py's attention-free encoder-decoder
# at the widths of the PaddlePaddle book's chapter 8 (08.machine_translation,
# v2 train.py): word vectors, encoder and decoder 512, source and target
# dictionaries of 30000 (paddle_tpu/dataset/wmt14.py:132), beam 3; batch
# 64, the recurrent kernels' supported() limit and the LSTM lane's batch.
# Sources of 10-50 words drawn from the seed (12-52 tokens with <s>/<e>),
# targets the same length plus <s>/<e>. One cut: the decoder's max_length
# goes from the book's 250 to 50, to bound the phase's time. Adam at the
# lanes' 2e-3 (phase 9's reasoning: at the book test's 0.01, which it takes
# at hidden 48, a fixed batch's loss swings at these widths)
NMT_DICT, NMT_EMB, NMT_HID, NMT_BEAM = 30000, 512, 512, 3
NMT_BATCH, NMT_SRC, NMT_MAX_LEN, NMT_BOOK_MAX_LEN = 64, (10, 50), 50, 250
NMT_STEPS, NMT_LR = 10, SEQ_LR
# each step's loss, kernel route against kernel_tier=torch: the tolerance
# phase 8 holds the GRU classifier's loss to (the decoder is a GRU); the
# decoder's H0@GRAD against the plain route by phase 8's gradient limit in
# ‖Δ‖₂ and gru_seq_bwd's ‖Δ‖∞ limit (phase 7), both relative to the plain
# route's
NMT_LOSS_LIMIT = GRU_TRAIN_LOSS_LIMIT
NMT_DH0_LIMIT, NMT_DH0_L2_LIMIT = GRU_BWD_LIMIT, GRU_TRAIN_GRAD_LIMIT
# the encoder's output between the routes: the recurrent forward's limits
# (ROADMAP §C, phase 5)
NMT_ENC_LIMIT, NMT_ENC_L2_LIMIT = LSTM_FWD_LIMIT, LSTM_FWD_L2_LIMIT
# the While training loop and DynamicRNN model of tests/test_recurrent_grad
# run on the card against the CPU from one state: float32 with TF32 off,
# sums in other orders
CF_STEPS, CF_REL = 3, 1e-5


def nmt_triples(seed):
    """NMT_BATCH synthetic triples at phase 18's widths: cores of
    NMT_SRC[0]..NMT_SRC[1] words over the NMT_DICT-word dictionary."""
    from paddle_tpu_torch.testing.models import nmt_pairs
    return nmt_pairs(NMT_BATCH, seed + 18, NMT_DICT, min_len=NMT_SRC[0],
                     max_len=NMT_SRC[1] + 1)


def nmt_decode_feed(fluid, triples):
    import numpy as np
    init_scores = np.zeros((NMT_BATCH, NMT_BEAM), "float32")
    init_scores[:, 1:] = -1e9
    return {"src": fluid.pack_sequences([np.asarray(t[0], "int64")
                                         .reshape(-1, 1) for t in triples]),
            "init_ids": np.zeros((NMT_BATCH, NMT_BEAM), "int64"),
            "init_scores": init_scores,
            "state_seed": np.zeros((NMT_BATCH, NMT_BEAM, NMT_HID),
                                   "float32")}


def sync_counter(torch):
    """A context counting the host syncs torch reports (sync debug mode
    "warn") per tag: ``count[tag]`` for the tag set in ``where[0]``. Only
    the "called a synchronizing CUDA operation" warnings count, not the
    notice torch gives once a process when the mode is first set."""
    import warnings
    count, where = {}, [None]

    @contextlib.contextmanager
    def ctx():
        shown = warnings.showwarning

        def show(message, category, *a, **k):
            if "synchronizing CUDA operation" in str(message):
                count[where[0]] = count.get(where[0], 0) + 1
            else:
                shown(message, category, *a, **k)

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
                warnings.showwarning = shown

    return ctx, count, where


def phase_nmt_decode(torch, fluid, exe, trained, triples, card, problems):
    """Beam-decode NMT_BATCH sources with the trained weights on both
    routes through While, gru_unit, topk, beam_search, batch_gather and
    beam_search_decode. Returns the decode's kernel launches."""
    import numpy as np
    from paddle_tpu_torch.ops import control_flow_ops as cfo
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import rnn
    from paddle_tpu_torch.testing.models import (NMT_BOS,
                                                 nmt_decode_program)

    fluid.reset_unique_name()
    main, _, sent_ids, sent_scores, enc = nmt_decode_program(
        fluid, NMT_BATCH, NMT_DICT, NMT_DICT, NMT_EMB, NMT_HID, NMT_BEAM,
        NMT_MAX_LEN)
    feed = nmt_decode_feed(fluid, triples)
    fetch = [enc, sent_ids, sent_scores]

    def run(route, scope):
        fluid.set_flags({"kernel_tier": route})
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3
        finally:
            fluid.set_flags({"kernel_tier": "auto"})

    rnn.reset_launches()
    tier.reset_fallback_counts()
    (enc_k, ids_k, sc_k), ms_k = run("auto", copy_scope(fluid, torch,
                                                       trained))
    launches = dict(rnn.launches)
    if (launches["lstm_seq"], launches["gru_seq"],
            tier.fallback_counts().get("lstm", 0)) != (1, 0, 0):
        problems.append(f"NMT decode, kernel route: launches {launches}, "
                        f"fallbacks {tier.fallback_counts()}; want 1 "
                        "lstm_seq (the encoder) and no GRU kernel (the "
                        "decoder loop runs gru_unit)")
    (enc_k2, ids_k2, sc_k2), ms_k2 = run("auto", copy_scope(fluid, torch,
                                                           trained))
    (enc_t, ids_t, sc_t), ms_t = run("torch", copy_scope(fluid, torch,
                                                        trained))

    flat, lod = fluid.lodarray_to_flat(ids_k)
    scores = sc_k.cpu().numpy().reshape(NMT_BATCH, NMT_BEAM)
    want_outer = list(range(0, NMT_BATCH * NMT_BEAM + 1, NMT_BEAM))
    starts = [flat[a, 0] for a in lod[-1][:-1]] if len(lod) == 2 else []
    if len(lod) != 2 or lod[0] != want_outer \
            or len(lod[1]) != NMT_BATCH * NMT_BEAM + 1:
        problems.append(f"NMT decode: the output is not a 2-level LoD of "
                        f"{NMT_BATCH} groups of {NMT_BEAM} rows: "
                        f"{[len(v) for v in lod]} levels' offsets")
    if any(s != NMT_BOS for s in starts):
        problems.append("NMT decode: a row does not start with <s>")
    if not (np.isfinite(scores).all()
            and (np.diff(scores, axis=1) <= 0).all()):
        problems.append(f"NMT decode: scores do not fall within a group "
                        f"(or are not finite): {scores[:2]}")
    ek = enc_k.double()
    et = enc_t.double()
    d = ek - et
    e_inf = (d.abs().max() / et.abs().max()).item()
    e_l2 = (d.norm() / et.norm()).item()
    log(f"encoder output (b {NMT_BATCH}, H {NMT_HID}), kernel route vs "
        f"kernel_tier=torch: ‖Δ‖∞/‖ref‖∞ {e_inf:.3e} (limit "
        f"{NMT_ENC_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {e_l2:.3e} (limit "
        f"{NMT_ENC_L2_LIMIT:.0e})")
    if not (e_inf <= NMT_ENC_LIMIT and e_l2 <= NMT_ENC_L2_LIMIT):
        problems.append(f"NMT decode: the encoder outputs differ between "
                        f"the routes by {e_inf:.3e} / {e_l2:.3e}")
    same_enc = torch.equal(enc_k, enc_k2)
    same_ids = torch.equal(ids_k.data, ids_k2.data) \
        and torch.equal(ids_k.lens, ids_k2.lens) \
        and torch.equal(sc_k, sc_k2)
    log(f"two kernel-route decodes: encoder output bitwise {same_enc}, "
        f"ids, lengths and scores bitwise {same_ids}")
    if not same_enc:
        problems.append("NMT decode: the encoder's output differs between "
                        "two runs on the kernel route")
    elif not same_ids:
        problems.append("NMT decode: the same encoder output gave other "
                        "ids or scores on a second run")
    flat_t, lod_t = fluid.lodarray_to_flat(ids_t)

    def best(fl, lo, i):
        return fl[lo[-1][i * NMT_BEAM]:lo[-1][i * NMT_BEAM + 1], 0].tolist()

    agree = sum(best(flat, lod, i) == best(flat_t, lod_t, i)
                for i in range(NMT_BATCH)) if len(lod_t) == 2 else 0
    lens = np.diff(lod[-1])
    log(f"best beams equal between the routes: {agree}/{NMT_BATCH} "
        f"({100 * agree / NMT_BATCH:.1f}%); kernel-route sentence lengths "
        f"{int(lens.min())}..{int(lens.max())} tokens (max_length "
        f"{NMT_MAX_LEN}, cut from the book's {NMT_BOOK_MAX_LEN})")

    # host syncs a loop iteration makes: sync debug mode while the loop
    # runs, counted inside and outside the while op
    ctx, syncs, where = sync_counter(torch)
    iters = [0]
    real_loop = cfo._while_loop

    def tagged_loop(sub, env_base, pre, carried, cond_name, max_iters,
                    device):
        where[0] = "loop"
        try:
            out = real_loop(sub, env_base, pre, carried, cond_name,
                            max_iters, device)
        finally:
            where[0] = "outside"
        return out

    real_cond = cfo._cond_true

    def counted_cond(v):
        if where[0] == "loop":
            iters[0] += 1
        return real_cond(v)

    cfo._while_loop, cfo._cond_true = tagged_loop, counted_cond
    where[0] = "outside"
    try:
        with ctx():
            run("auto", copy_scope(fluid, torch, trained))
    finally:
        cfo._while_loop, cfo._cond_true = real_loop, real_cond
    n_iter = iters[0] - 1          # the last read ends the loop
    per_iter = syncs.get("loop", 0) / max(n_iter, 1)
    log(f"host syncs: {syncs.get('loop', 0)} inside the While over "
        f"{n_iter} iterations ({per_iter:.2f} an iteration; the condition "
        f"read is one by design: the loop decides on the host whether to "
        f"run its block again), {syncs.get('outside', 0)} outside it")
    log(f"decode of {NMT_BATCH} sources, {n_iter} steps: kernel route "
        f"{ms_k:.1f} ms (again {ms_k2:.1f} ms), {ms_k2 / n_iter:.3f} ms a "
        f"decode step; kernel_tier=torch {ms_t:.1f} ms, "
        f"{ms_t / n_iter:.3f} ms a step | {card}")
    return launches


def cf_models(fluid, which):
    """tests/test_recurrent_grad.py's While training loop (``while``) and
    DynamicRNN model (``dynamic_rnn``) at that file's sizes, with their
    feeds: (main, startup, loss, feed)."""
    import numpy as np
    layers = fluid.layers
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    if which == "while":
        batch, T, feat, hid = 6, 4, 5, 3
        main.random_seed = startup.random_seed = 11
        with fluid.program_guard(main, startup):
            x = layers.data("x", shape=[T, feat])
            y = layers.data("y", shape=[hid])
            pieces = layers.split(x, T, dim=1)
            arr = None
            for t in range(T):
                it = layers.fill_constant(shape=[1], dtype="int64", value=t)
                arr = layers.array_write(
                    layers.reshape(pieces[t], [batch, feat]), it, array=arr,
                    cap=T)
            i = layers.fill_constant(shape=[1], dtype="int64", value=0)
            limit = layers.fill_constant(shape=[1], dtype="int64", value=T)
            acc = layers.fill_constant(shape=[batch, hid], dtype="float32",
                                       value=0.0)
            cond = layers.less_than(i, limit)
            w = layers.While(cond, max_iters=T)
            with w.block():
                h = layers.fc(layers.array_read(arr, i), size=hid,
                              act="tanh",
                              param_attr=fluid.ParamAttr(name="ww"),
                              bias_attr=fluid.ParamAttr(name="wb"))
                layers.assign(layers.elementwise_add(acc, h), output=acc)
                layers.increment(i, value=1)
                layers.less_than(i, limit, cond=cond)
            loss = layers.mean(layers.square(layers.elementwise_sub(acc,
                                                                    y)))
            fluid.optimizer.SGD(learning_rate=0.05).minimize(loss, startup)
        rng = np.random.RandomState(7)
        feed = {"x": rng.normal(0, 1, (batch, T, feat)).astype("float32"),
                "y": rng.normal(0, 1, (batch, hid)).astype("float32")}
        return main, startup, loss, feed
    vocab, emb, hid = 12, 6, 5
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup):
        words = layers.data("words", shape=[1], dtype="int64", lod_level=1)
        label = layers.data("label", shape=[1])
        e = layers.embedding(words, size=[vocab, emb],
                             param_attr=fluid.ParamAttr(name="empar"))
        drnn = layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(e)
            h = drnn.memory(shape=[6, hid], value=0.0)
            nh = layers.fc(xt, size=hid, act="tanh",
                           param_attr=fluid.ParamAttr(name="dw"),
                           bias_attr=fluid.ParamAttr(name="db"))
            h2 = layers.fc(h, size=hid, act=None, bias_attr=False,
                           param_attr=fluid.ParamAttr(name="dh"))
            nh = layers.tanh(layers.elementwise_add(nh, h2))
            drnn.update_memory(h, nh)
            drnn.output(nh)
        pred = layers.fc(layers.sequence_pool(drnn(), pool_type="last"),
                         size=1, act=None)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred,
                                                                label)))
        fluid.optimizer.Adam(learning_rate=0.02).minimize(loss, startup)
    rng = np.random.RandomState(2)
    seqs = [rng.randint(0, vocab, (int(rng.randint(2, 6)), 1)).astype(
        "int64") for _ in range(6)]
    return main, startup, loss, {
        "words": seqs, "label": rng.normal(0, 1, (6, 1)).astype("float32")}


def phase_control_flow(torch, fluid, card, problems):
    """The While loop and DynamicRNN model, CF_STEPS steps on the card and
    on the CPU from one startup state: the losses and the final state
    within CF_REL relative."""
    for which in ("while", "dynamic_rnn"):
        main, startup, loss, feed = cf_models(fluid, which)
        cpu = fluid.Executor(fluid.CPUPlace())
        init = fluid.Scope()
        cpu.run(startup, scope=init)
        names = [n for n in init.local_names()
                 if torch.is_tensor(init.find_var(n))]
        gpu = fluid.Executor()
        scopes = {}
        for dev, device in (("cuda", gpu.device), ("cpu", cpu.device)):
            s = fluid.Scope()
            for n in names:
                s.set(n, init.find_var(n).to(device))
            scopes[dev] = s
        losses = {}
        for dev, exe in (("cuda", gpu), ("cpu", cpu)):
            losses[dev] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                         scope=scopes[dev])[0])
                           for _ in range(CF_STEPS)]
        dl = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                     losses["cpu"]))
        worst, wname = 0.0, None
        for n in names:
            a = scopes["cuda"].find_var(n)
            b = scopes["cpu"].find_var(n)
            if not (torch.is_tensor(a) and a.is_floating_point()):
                continue
            if a.device != gpu.device:
                problems.append(f"{which}: {n} left the card "
                                f"({a.device})")
            r = ((a.cpu().double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30)).item()
            if r > worst:
                worst, wname = r, n
        log(f"{which} ({op_counts(main.global_block())}): "
            f"{CF_STEPS} steps, card vs CPU from one state: losses "
            + " ".join(f"{v:.6f}" for v in losses["cuda"])
            + f", worst relative difference {dl:.3e}; final state worst "
            f"{worst:.3e} ({wname}); limit {CF_REL:.0e} | {card}")
        if not (dl <= CF_REL and worst <= CF_REL):
            problems.append(f"{which}: the card and the CPU differ by "
                            f"{dl:.3e} (losses) / {worst:.3e} ({wname})")


def phase_seq2seq(torch, fluid, seed, card):
    """Phase 18. Returns the launches of the four recurrent kernels on
    this phase's path (training on the kernel route and the decode)."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import rnn
    from paddle_tpu_torch.testing.models import nmt_feed, nmt_train_program

    log(f"\n== phase 18: Seq2Seq NMT (tests/book/test_machine_translation.py"
        f" at the book's chapter-8 widths: word vectors {NMT_EMB}, encoder "
        f"and decoder {NMT_HID}, dictionaries {NMT_DICT}, beam {NMT_BEAM}), "
        f"batch {NMT_BATCH}, sources of {NMT_SRC[0]}-{NMT_SRC[1]} words, "
        f"{NMT_STEPS} Adam({NMT_LR}) steps on one batch; control flow on "
        f"the card | {card} ==")
    fluid.reset_unique_name()
    main, startup, loss, v = nmt_train_program(
        fluid, NMT_DICT, NMT_DICT, NMT_EMB, NMT_HID, NMT_LR)
    block = main.global_block()
    log("program: " + op_counts(block))
    dh0_name = v["boot"].name + "@GRAD"
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    triples = nmt_triples(seed)
    feed = nmt_feed(triples)
    src_lens = [len(t[0]) for t in triples]
    trg_lens = [len(t[1]) for t in triples]
    log(f"feed: source lengths {min(src_lens)}..{max(src_lens)} tokens, "
        f"target lengths {min(trg_lens)}..{max(trg_lens)} ({sum(trg_lens)} "
        "target tokens)")
    counters = (("lstm_seq", lambda: rnn.launches["lstm_seq"]),
                ("lstm_seq_bwd", lambda: rnn.launches["lstm_seq_bwd"]),
                ("gru_seq", lambda: rnn.launches["gru_seq"]),
                ("gru_seq_bwd", lambda: rnn.launches["gru_seq_bwd"]),
                ("plain-routed LSTMs",
                 lambda: tier.fallback_counts().get("lstm", 0)),
                ("plain-routed GRUs",
                 lambda: tier.fallback_counts().get("gru", 0)))
    labels = [c[0] for c in counters]
    want = {"auto": (1, 1, 1, 1, 0, 0), "torch": (0,) * 6}
    problems, res = [], {}
    for route in ("auto", "torch"):
        scope = copy_scope(fluid, torch, init)
        losses, ms, total = [], [], [0] * len(labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fluid.set_flags({"kernel_tier": route})
        try:
            for step in range(NMT_STEPS):
                rnn.reset_launches()
                tier.reset_fallback_counts()
                t0 = time.perf_counter()
                vals = exe.run(main, feed=feed, fetch_list=[loss] + (
                    [dh0_name] if step == 0 else []), scope=scope,
                    return_numpy=False)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                counts = tuple(get() for _, get in counters)
                if counts != want[route]:
                    fail(f"NMT, kernel_tier={route} step {step + 1}: "
                         f"{'/'.join(labels)} {counts}, want {want[route]}")
                total = [a + c for a, c in zip(total, counts)]
                if not torch.isfinite(vals[0]).item():
                    fail(f"NMT, kernel_tier={route} step {step + 1}: loss "
                         f"{vals[0]}")
                losses.append(vals[0].item())
                if step == 0:
                    dh0 = vals[1]
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = sum(ms[1:]) / len(ms[1:])
        res[route] = dict(losses=losses, dh0=dh0, total=total, scope=scope)
        log(f"kernel_tier={route}: losses "
            + " ".join(f"{x:.6f}" for x in losses)
            + " | ms/step " + " ".join(f"{x:.1f}" for x in ms)
            + f" | steady {steady:.2f} ms/step, "
            f"{sum(trg_lens) * 1e3 / steady:.0f} target tokens/s | peak "
            f"memory {peak:.2f} GiB | {card}")

    rel = [abs(a - b) / abs(b) for a, b in zip(res["auto"]["losses"],
                                               res["torch"]["losses"])]
    log("loss per step, kernel route vs kernel_tier=torch, relative: "
        + " ".join(f"{x:.2e}" for x in rel)
        + f" (limit {NMT_LOSS_LIMIT:.0e})")
    if not max(rel) <= NMT_LOSS_LIMIT:
        problems.append(f"NMT: the routes' losses differ by {max(rel):.3e} "
                        f"at step {rel.index(max(rel)) + 1}")
    for route in ("auto", "torch"):
        losses = res[route]["losses"]
        if not losses[-1] < losses[0]:
            problems.append(f"NMT, kernel_tier={route}: the loss did not "
                            f"fall over {NMT_STEPS} steps: {losses}")
    gk = res["auto"]["dh0"].double()
    gt = res["torch"]["dh0"].double()
    d = gk - gt
    g_inf = (d.abs().max() / gt.abs().max().clamp_min(1e-30)).item()
    g_l2 = (d.norm() / gt.norm().clamp_min(1e-30)).item()
    log(f"step 1 {dh0_name} (the gru op's H0@GRAD, [{NMT_BATCH}, "
        f"{NMT_HID}]), kernel route vs kernel_tier=torch: ‖Δ‖∞/‖ref‖∞ "
        f"{g_inf:.3e} (limit {NMT_DH0_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {g_l2:.3e} "
        f"(limit {NMT_DH0_L2_LIMIT:.0e}); ‖ref‖∞ {gt.abs().max().item():.3e}")
    if gk.abs().max().item() == 0:
        problems.append(f"NMT: {dh0_name} is all zeros")
    if not (g_inf <= NMT_DH0_LIMIT and g_l2 <= NMT_DH0_L2_LIMIT):
        problems.append(f"NMT: {dh0_name} differs between the routes by "
                        f"{g_inf:.3e} / {g_l2:.3e}")
    scope = copy_scope(fluid, torch, init)
    profile(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope),
            f"NMT: one training step, batch {NMT_BATCH}, kernel route", card,
            reps=3, groups={"lstm_seq + lstm_seq_bwd": [
                "lstm_fwd_kernel", "lstm_bwd_kernel"],
                "gru_seq + gru_seq_bwd": ["gru_fwd_kernel",
                                          "gru_bwd_kernel"]})

    dec = phase_nmt_decode(torch, fluid, exe, res["auto"]["scope"], triples,
                           card, problems)
    phase_control_flow(torch, fluid, card, problems)
    if problems:
        fail("; ".join(problems))
    out = dict(zip(labels, res["auto"]["total"]))
    for k in ("lstm_seq", "lstm_seq_bwd", "gru_seq", "gru_seq_bwd"):
        out[k] += dec[k]
    log("phase 18 launches: " + json.dumps(
        {k: out[k] for k in ("lstm_seq", "lstm_seq_bwd", "gru_seq",
                             "gru_seq_bwd")}))
    return out


# ---------------------------------------------------------------------------

# The book chapters of tests/book/ at the book's widths (the builders of
# paddle_tpu_torch/testing/models.py, their defaults): recognize_digits'
# MLP (784-128-64-10) and conv net (20 and 50 filters, 5x5, pool 2/2);
# image_classification's resnet_cifar10 at depth 32 (16/32/64) and
# vgg16_bn_drop with its dropouts on, 32x32x3, 10 classes; the sentiment
# chapter's stacked_lstm_net (emb 128, hid 512: LSTMs of 128, 3 layers)
# and convolution_net (the book function's emb 32, hid 32, sqrt pooling)
# over a dictionary of 5000 (the repo test's cap) and reviews of 10-100
# tokens, batch 64 (the recurrent kernels' supported() limit); SRL's
# db_lstm (word_dim 32, mark_dim 5, hidden 512: LSTMs of 128, depth 8,
# eight features, CRF "crfw") over ASSUMED dictionaries of 30000 words,
# 3000 predicates and 59 tags (conll05's are not in the repo), the book's
# batch of 10 sentences of 10-50 words; the recommender at the repo test's
# widths over MovieLens-1M's id ranges (6041 users, 21 jobs, 3953 movies,
# 18 categories, a title dictionary of 5175, assumed), batch 64. Digits
# and CIFAR at batch 128. Synthetic data from the seed. Adam at the
# builders' rates (the book's 0.002, SRL 1e-4, the recommender 0.01). The
# phase's counted steps run under cudnn.deterministic, so the routes'
# plain ops give the same bits and their losses differ only where a kernel
# runs; each route's profiled step and the BOOK_DEFAULT_STEPS after it
# run with cuDNN's defaults.
# counted steps a route (3 of the book tests' 5: the script's time limit)
BOOK_STEPS = 3
# steps timed after the profiled one, with cuDNN's default algorithms
# (one: the script's time limit)
BOOK_DEFAULT_STEPS = 1
BOOK_BATCH = 128
BOOK_SENT = dict(dict_dim=5000, lens=(10, 100))
BOOK_SENT_BATCH = 64
BOOK_SRL = dict(word_dict=30000, pred_dict=3000, label_dict=59,
                lens=(10, 50))
BOOK_SRL_BATCH = 10
BOOK_REC = dict(users=6041, jobs=21, movies=3953, categories=18,
                title_dict=5175)
BOOK_REC_BATCH = 64
# each step's loss, kernel route against kernel_tier=torch: lstm_seq keeps
# W in bf16 (phase 5), so the stacked LSTM's loss moves by a few 1e-4;
# the other chapters run the same plain ops on both routes
BOOK_ROUTE_REL = 1e-3
# step 1 on the card against the port on the CPU from one state, TF32 off:
# float32 sums in other orders
BOOK_CPU_REL = 1e-4
# dropout's keep share within this many binomial sigmas of 1 - p
DROPOUT_SIGMAS = 4.0


def book_chapters():
    """(name, builder, book_feed chapter, batch, feed sizes) of phase 19."""
    from paddle_tpu_torch.testing import models as M
    return [
        ("digits_mlp", M.digits_mlp, "digits_mlp", BOOK_BATCH, {}),
        ("digits_conv", M.digits_conv, "digits_conv", BOOK_BATCH, {}),
        ("cifar_resnet32", lambda f: M.cifar_resnet(f, depth=32), "cifar",
         BOOK_BATCH, {}),
        ("cifar_vgg16", M.cifar_vgg, "cifar", BOOK_BATCH, {}),
        ("sentiment_conv",
         lambda f: M.sentiment_conv(f, BOOK_SENT["dict_dim"]), "sentiment",
         BOOK_SENT_BATCH, BOOK_SENT),
        ("sentiment_lstm",
         lambda f: M.sentiment_lstm(f, BOOK_SENT["dict_dim"]), "sentiment",
         BOOK_SENT_BATCH, BOOK_SENT),
        ("srl", lambda f: M.srl_db_lstm(
            f, BOOK_SRL["word_dict"], BOOK_SRL["pred_dict"],
            BOOK_SRL["label_dict"]), "srl", BOOK_SRL_BATCH, BOOK_SRL),
        ("recommender", lambda f: M.recommender(f, **BOOK_REC),
         "recommender", BOOK_REC_BATCH, BOOK_REC),
    ]


def accuracy_vars(block):
    """The (Correct, Total) names of the block's accuracy op."""
    op = next(op for op in block.ops if op.type == "accuracy")
    return op.output("Correct")[0], op.output("Total")[0]


def book_lstm_kernels(torch, seed, ch, card):
    """lstm_seq and lstm_seq_bwd against their plain versions, and the
    forward against the float64 recipe, at phase 5's limits and at the
    shapes stacked_lstm_net gives them: each lstm op's hidden width and
    startup weight, the chapter's batch and its feed's ragged lengths. A
    reversed layer hands the kernels its rows' valid prefixes reversed
    (ops/rnn_ops.py), so their operands have the same shape and mask in
    both directions. Runs before the chapter trains; its launches are
    not counted."""
    from paddle_tpu_torch.ops.cuda import rnn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 19)
    block = ch["main"].global_block()
    lens = torch.tensor([len(s) for s in ch["raw"]["words"]], device=dev)
    L = int(lens.max())
    for i, op in enumerate(op for op in block.ops if op.type == "lstm"):
        w = ch["init"].find_var(op.input("Weight")[0])
        x, alive, _, h0, c0, dhs, dcs = lstm_operands(
            torch, gen, dev, lens, L, w.shape[0])
        log(f"{ch['name']} lstm #{i + 1} (is_reverse "
            f"{op.attr('is_reverse')}): lstm_seq / lstm_seq_bwd vs their "
            f"plain versions at b {len(lens)}, L {L}, H {w.shape[0]}, "
            f"lengths {int(lens.min())}..{L}, the startup W | {card}")
        hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
        torch.cuda.synchronize()
        ref = rnn.lstm_seq_torch(x, alive, w, h0, c0)
        lstm_fwd_check(torch, (hs, cs), ref,
                       lstm_float64(torch, x, alive, w, h0, c0), "lstm_seq")
        lstm_bwd_check(torch, rnn, (x, alive, w, h0, c0, *ref, dhs, dcs))


def book_route(torch, fluid, exe, ch, route, counters):
    """BOOK_STEPS steps of chapter ``ch`` on ``route`` from a copy of its
    startup state (each copy seeds its own generator from the program's
    random_seed, so both routes draw the same dropout masks): losses,
    step-1 extra fetches, ms a step, peak memory, kernel launches and
    plain-routed ops a step."""
    from paddle_tpu_torch.ops import cuda as tier
    read, reset = counters
    scope = copy_scope(fluid, torch, ch["init"])
    losses, ms, per_step, first = [], [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fluid.set_flags({"kernel_tier": route})
    try:
        for step in range(BOOK_STEPS):
            reset()
            tier.reset_fallback_counts()
            t0 = time.perf_counter()
            vals = exe.run(ch["main"], feed=ch["feed"],
                           fetch_list=[ch["loss"]] + (
                               ch["extra"] if step == 0 else []),
                           scope=scope, return_numpy=False)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append((read(), dict(tier.fallback_counts())))
            loss = float(vals[0])
            if loss != loss or abs(loss) == float("inf"):
                fail(f"{ch['name']}, kernel_tier={route} step {step + 1}: "
                     f"loss {loss}")
            losses.append(loss)
            if step == 0:
                first = vals[1:]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        fluid.set_flags({"kernel_tier": "auto"})
    return dict(losses=losses, ms=ms, first=first, peak=peak,
                per_step=per_step, scope=scope)


def dropout_on_card(torch, fluid, card, problems):
    """The dropout op on the card at vgg16's first dropout (batch x 64 x
    32 x 32, p 0.3): Out == X * Mask bitwise, Mask 0/1, and the keep
    share within DROPOUT_SIGMAS sigmas of 1 - p."""
    import numpy as np
    p = 0.3
    fluid.reset_unique_name()
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data("x", shape=[64, 32, 32])
        out = fluid.layers.dropout(x, dropout_prob=p)
    mask = next(op for op in main.global_block().ops
                if op.type == "dropout").output("Mask")[0]
    xs = torch.randn((BOOK_BATCH, 64, 32, 32), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(5))
    o, m = fluid.Executor().run(main, feed={"x": xs},
                                fetch_list=[out, mask], scope=fluid.Scope(),
                                return_numpy=False)
    exact = bool(torch.equal(o, xs * m))
    binary = bool(((m == 0) | (m == 1)).all())
    keep = float(m.double().mean())
    sigma = float(np.sqrt(p * (1 - p) / m.numel()))
    log(f"dropout on the card ({m.numel()} elements, p {p}): Out == X*Mask "
        f"bitwise {exact}, Mask 0/1 {binary}, keep share {keep:.6f} "
        f"against {1 - p} (|Δ| {abs(keep - (1 - p)) / sigma:.2f} sigma, "
        f"limit {DROPOUT_SIGMAS}) | {card}")
    if not (exact and binary
            and abs(keep - (1 - p)) <= DROPOUT_SIGMAS * sigma):
        problems.append(f"dropout on the card: bitwise {exact}, 0/1 "
                        f"{binary}, keep share {keep}")


def recount_metrics(ch, first, problems):
    """accuracy's Correct/Total of step 1 against a numpy recount of the
    predictions fetched in the same run."""
    import numpy as np
    pred = np.asarray(first[0].cpu())
    correct, total = (int(t.item()) for t in first[1:3])
    label = np.asarray(ch["feed"]["label"]).reshape(-1)
    want = int((pred.argmax(1) == label).sum())
    log(f"{ch['name']}: accuracy's Correct/Total {correct}/{total}, numpy "
        f"recount {want}/{len(label)}")
    if (correct, total) != (want, len(label)):
        problems.append(f"{ch['name']}: accuracy counts {correct}/{total}, "
                        f"recount {want}/{len(label)}")


def iob_chunks(tags, types):
    """The (begin, end, type) chunks of one IOB tag sequence, in numpy and
    apart from the port's chunk extraction: tag 2k begins a chunk of type
    k; 2k+1 continues the open chunk of type k, or begins one after an
    Outside tag or a chunk of another type; tags >= 2 * types are
    Outside. A chunk ends before the next begin or Outside tag."""
    import numpy as np
    tags = np.asarray(tags, np.int64).reshape(-1)
    inside = (tags >= 0) & (tags < 2 * types)
    kind = tags // 2
    after = np.r_[False, inside[:-1]] & (np.r_[-1, kind[:-1]] == kind)
    begins = inside & ((tags % 2 == 0) | ~after)
    starts = np.flatnonzero(begins)
    breaks = np.r_[np.flatnonzero(begins | ~inside), len(tags)]
    ends = breaks[np.searchsorted(breaks, starts, side="right")] - 1
    return {(int(a), int(e), int(kind[a])) for a, e in zip(starts, ends)}


def srl_chunk_eval(torch, fluid, ch, first, card, problems):
    """chunk_eval (IOB, 29 types) of SRL's fetched Viterbi paths against
    the targets, in a program of its own on the card fed both on the
    card: its three counts against iob_chunks' recount in numpy, and the
    host syncs of the run (the op's one read)."""
    types = (BOOK_SRL["label_dict"] - 1) // 2
    fluid.reset_unique_name()
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        inf = fluid.layers.data("inf", shape=[1], dtype="int64",
                                lod_level=1)
        lab = fluid.layers.data("lab", shape=[1], dtype="int64",
                                lod_level=1)
        outs = fluid.layers.chunk_eval(inf, lab, "IOB", types)
    path = first[2]
    lens = path.lens.cpu().numpy()
    paths = [path.data[i, :n].cpu().numpy() for i, n in enumerate(lens)]
    targets = ch["raw"]["target"]
    exe = fluid.Executor()
    staged = {}
    for key, seqs in (("inf", paths), ("lab", targets)):
        packed = fluid.pack_sequences(seqs)
        staged[key] = fluid.LoDArray(packed.data.to(exe.device),
                                     packed.lens.to(exe.device))
    counting, count, where = sync_counter(torch)
    where[0] = "chunk_eval"
    with counting():
        got = exe.run(prog, feed=staged, fetch_list=list(outs[3:]),
                      return_numpy=False)
    syncs = count.get("chunk_eval", 0)
    got = [int(g.reshape(-1)[0].item()) for g in got]
    n_inf = n_lab = n_cor = 0
    for a, b in zip(paths, targets):
        ia, ib = (iob_chunks(s, types) for s in (a, b))
        n_inf, n_lab, n_cor = n_inf + len(ia), n_lab + len(ib), \
            n_cor + len(ia & ib)
    log(f"srl chunk_eval (IOB, {types} types): inferred/label/correct "
        f"chunks {got}, numpy recount {[n_inf, n_lab, n_cor]}; host syncs "
        f"in the run {syncs} | {card}")
    if got != [n_inf, n_lab, n_cor]:
        problems.append(f"srl: chunk_eval counts {got}, recount "
                        f"{[n_inf, n_lab, n_cor]}")
    if syncs != 1:
        problems.append(f"srl: chunk_eval's run made {syncs} host syncs, "
                        f"want its one read")


def card_vs_cpu(torch, fluid, ch, first, card, problems):
    """Step 1 of the chapter on the port's CPU from the card's startup
    state and feed: the loss within BOOK_CPU_REL relative; for SRL also
    the per-sentence CRF cost and crfw@GRAD (relative to its largest
    element), and the Viterbi paths equal."""
    cpu = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    for n in ch["init"].local_names():
        v = ch["init"].find_var(n)
        if torch.is_tensor(v):
            scope.set(n, v.cpu().clone())
    vals = cpu.run(ch["main"], feed=ch["feed"],
                   fetch_list=[ch["loss"]] + ch["extra"], scope=scope,
                   return_numpy=False)
    card_loss = ch["routes"]["auto"]["losses"][0]
    rel = abs(card_loss - float(vals[0])) / abs(float(vals[0]))
    line = (f"{ch['name']}: step 1 on the card {card_loss:.7f}, on the CPU "
            f"{float(vals[0]):.7f} (relative {rel:.2e}, limit "
            f"{BOOK_CPU_REL:.0e})")
    ok = rel <= BOOK_CPU_REL
    if ch["name"] == "srl":
        cost_g, cost_c = first[0].double().cpu(), vals[1].double()
        crel = ((cost_g - cost_c).abs() / cost_c.abs()).max().item()
        dw_g, dw_c = first[1].double().cpu(), vals[2].double()
        wrel = ((dw_g - dw_c).abs().max()
                / dw_c.abs().max().clamp_min(1e-30)).item()
        pg, pc = first[2], vals[3]
        same = bool(torch.equal(pg.lens.cpu(), pc.lens)) and all(
            torch.equal(pg.data[i, :n].cpu(), pc.data[i, :n])
            for i, n in enumerate(pc.lens.tolist()))
        line += (f"; CRF cost per sentence worst {crel:.2e}, crfw@GRAD "
                 f"{wrel:.2e} of its largest, Viterbi paths equal {same}")
        ok = ok and crel <= BOOK_CPU_REL and wrel <= BOOK_CPU_REL and same
    log(line + f" | {card}")
    if not ok:
        problems.append(f"{ch['name']}: the card and the CPU differ at "
                        f"step 1: {line}")


def phase_book(torch, fluid, seed, card):
    """Phase 19. Returns lstm_seq's and lstm_seq_bwd's launches in the
    kernel route's counted steps."""
    counters = kernel_counters()

    log(f"\n== phase 19: the book chapters (tests/book/) at the book's "
        f"widths, {BOOK_STEPS} Adam steps on one synthetic batch each, on "
        f"the kernel route and on kernel_tier=torch | {card} ==")
    exe = fluid.Executor()
    problems, launched = [], {"lstm_seq": 0, "lstm_seq_bwd": 0}
    dropout_on_card(torch, fluid, card, problems)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for chapter in book_chapters():
            book_chapter(torch, fluid, exe, seed, card, chapter, counters,
                         problems, launched)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if problems:
        fail("; ".join(problems))
    log("phase 19 launches: " + json.dumps(launched))
    return launched


def book_chapter(torch, fluid, exe, seed, card, chapter, counters, problems,
                 launched):
    """One chapter of phase 19: both routes, their readings and checks;
    problems appended, lstm_seq launches added to ``launched``."""
    from paddle_tpu_torch.testing import models as M
    name, build, kind, batch, sizes = chapter
    fluid.reset_unique_name()
    main, startup, v = build(fluid)
    main.random_seed = startup.random_seed = seed
    block = main.global_block()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    feed = M.book_feed(kind, batch, seed, **sizes)
    ch = dict(name=name, main=main, loss=v["loss"], init=init, raw=feed,
              feed={n: fluid.pack_sequences(x) if isinstance(x, list)
                    else x for n, x in feed.items()}, extra=[])
    if "acc" in v:
        ch["extra"] = [v["predict"], *accuracy_vars(block)]
    if name == "srl":
        ch["extra"] = [v["crf_cost"], "crfw@GRAD", v["decode"]]
    log(f"\n{name}: batch {batch}, program: {op_counts(block)}")
    if name == "sentiment_lstm":
        book_lstm_kernels(torch, seed, ch, card)
    ch["routes"] = {r: book_route(torch, fluid, exe, ch, r, counters)
                    for r in ("auto", "torch")}
    for route, res in ch["routes"].items():
        launches, falls = res["per_step"][-1]
        ran = {k: n for k, n in launches.items() if n}
        steady = sum(res["ms"][1:]) / len(res["ms"][1:])
        # the profiled step and BOOK_DEFAULT_STEPS timed ones run with
        # cuDNN's default algorithms, as a user's run does; the counted
        # steps above are deterministic

        def step():
            return float(exe.run(main, feed=ch["feed"],
                                 fetch_list=[ch["loss"]], scope=res["scope"],
                                 return_numpy=False)[0])

        fluid.set_flags({"kernel_tier": route})
        torch.backends.cudnn.deterministic = False
        try:
            prof = profile(torch, step, f"{name}, one step, "
                           f"kernel_tier={route}, cuDNN default", card,
                           reps=1)
            t0 = time.perf_counter()
            for _ in range(BOOK_DEFAULT_STEPS):
                step()
            default_ms = (time.perf_counter() - t0) * 1e3 \
                / BOOK_DEFAULT_STEPS
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
            torch.backends.cudnn.deterministic = True
        busy = (f"cuDNN default: {default_ms:.2f} ms/step; profiled step "
                f"{prof[0]:.2f} ms, device busy {prof[1]:.2f} ms "
                f"({100 * prof[1] / prof[0]:.1f}%)" if prof
                else f"cuDNN default: {default_ms:.2f} ms/step; device "
                "busy not measured")
        log(f"{name}, kernel_tier={route}: losses "
            + " ".join(f"{x:.6f}" for x in res["losses"])
            + " | ms/step " + " ".join(f"{x:.1f}" for x in res["ms"])
            + f" | steady {steady:.2f} ms/step (cudnn.deterministic) | "
            f"{busy} | peak memory "
            f"{res['peak']:.2f} GiB | kernel launches a step {ran} | "
            f"plain-routed a step {falls} | {card}")
    auto, plain = ch["routes"]["auto"], ch["routes"]["torch"]
    rel = [abs(a - b) / abs(b) for a, b in zip(auto["losses"],
                                               plain["losses"])]
    log(f"{name}: loss per step, kernel route vs kernel_tier=torch, "
        "relative: " + " ".join(f"{x:.2e}" for x in rel)
        + f" (limit {BOOK_ROUTE_REL:.0e})")
    if not max(rel) <= BOOK_ROUTE_REL:
        problems.append(f"{name}: the routes' losses differ by "
                        f"{max(rel):.3e}")
    if not auto["losses"][-1] < auto["losses"][0]:
        problems.append(f"{name}: the loss did not fall on the kernel "
                        f"route: {auto['losses']}")
    for step, (launches, falls) in enumerate(auto["per_step"]):
        ran = {k: n for k, n in launches.items() if n}
        if name == "sentiment_lstm":
            want = ({"lstm_seq": 3, "lstm_seq_bwd": 3}, {})
        elif name == "srl":
            # 8 lstm forwards, and each lstm_grad replays its forward
            # under autograd through the same route choice: 8 more
            want = ({}, {"lstm": 16})
        else:
            want = ({}, {})
        if (ran, falls) != want:
            problems.append(f"{name} step {step + 1}: launches {ran}, "
                            f"plain-routed {falls}; want {want}")
        for k in launched:
            launched[k] += launches.get(k, 0)
    if "acc" in v:
        recount_metrics(ch, auto["first"], problems)
    if name == "srl":
        srl_chunk_eval(torch, fluid, ch, auto["first"], card, problems)
    if name in ("digits_mlp", "digits_conv", "cifar_resnet32", "srl",
                "recommender"):
        card_vs_cpu(torch, fluid, ch, auto["first"], card, problems)


# phase 20: the decoder LM of phase 13's lane (GEN_* widths) trained with
# next-token labels, reshape to [b·T, vocab], softmax_with_cross_entropy,
# mean and Adam(LM_LR, fused=True) on LM_BATCH sequences of LM_SEQ tokens
# of a noisy periodic corpus (a stride of 1-3 through the vocabulary from
# a random start, LM_NOISE of the tokens replaced at random)
LM_BATCH, LM_SEQ, LM_STEPS, LM_LR, LM_NOISE = 32, 128, 5, 1e-3, 0.1
# the routes run the same ops up to the update (no kernel in the LM's
# forward or backward): step 1's gradients must agree to float32 noise,
# max |Δ| within 1e-6 of the largest gradient element; after it the
# routes differ by adam_arena's float32 roundings, which 5 steps carry into
# the losses far below 1e-4 relative
LM_GRAD_LIMIT, LM_ROUTE_REL = 1e-6, 1e-4
# phase 21: the NCCL dp steps against one device (float32 sums of the
# mean and the gradients in another order): losses within the dryrun's
# LANE_LIMIT (paddle_tpu_torch/testing/multichip.py); the ResNet slice's
# parameters (momentum) within its PARAM_LIMIT of each one's largest
# element. Adam moves an element whose gradient is float32 noise near 0 by
# up to lr a step whatever the noise's size (m̂/√v̂ is its sign at step
# 1), so the LM's parameters are held to a tenth of what DP_STEPS steps
# at LM_LR could move them (measured on 2 gloo ranks: 1.5e-5). The
# ResNet slice at the dryrun's widths and batch, the LM at phase 20's
DP_STEPS, DP_SLICE_BATCH = 2, 8
DP_LM_PARAM_ABS = 0.1 * LM_LR * DP_STEPS


def lm_corpus(np, batch, seq, vocab, seed, noise=LM_NOISE):
    """(tokens, positions, labels) [batch, seq, 1] int64: noisy periodic
    rows, the labels the next tokens."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, vocab, (batch, 1))
    stride = rng.randint(1, 4, (batch, 1))
    seqs = (start + stride * np.arange(seq + 1)[None]) % vocab
    flip = rng.rand(batch, seq + 1) < noise
    seqs = np.where(flip, rng.randint(0, vocab, seqs.shape), seqs)
    seqs = seqs.astype(np.int64)[..., None]
    pos = np.broadcast_to(np.arange(seq, dtype=np.int64)[None, :, None],
                          (batch, seq, 1)).copy()
    return seqs[:, :-1].copy(), pos, seqs[:, 1:].copy()


def lm_train_program(fluid, seed):
    """The lane's LM with the loss layers and Adam(LM_LR, fused=True):
    (main, startup, test clone, logits, loss)."""
    from paddle_tpu_torch.testing.models import build_tiny_lm
    main, startup, logits = build_tiny_lm(
        vocab=GEN_VOCAB, emb=GEN_EMB, heads=GEN_HEADS, n_layers=GEN_LAYERS,
        max_pos=GEN_MAX_POS, seed=GEN_SEED + seed)
    with fluid.program_guard(main, startup):
        labels = fluid.layers.data("labels", shape=[-1, 1], dtype="int64")
        flat = fluid.layers.reshape(logits, [-1, GEN_VOCAB])
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            flat, fluid.layers.reshape(labels, [-1, 1])))
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(LM_LR, fused=True).minimize(loss, startup)
    return main, startup, test, logits, loss


def lm_feed(seed):
    import numpy as np
    tokens, pos, labels = lm_corpus(np, LM_BATCH, LM_SEQ, GEN_VOCAB, seed)
    return {"tokens": tokens, "positions": pos, "labels": labels}


def phase_lm_train(torch, fluid, seed, card):
    """Phase 20: train the LM LM_STEPS steps on both routes, then serve the
    trained test clone through GenerationEngine + ContinuousBatcher on
    both routes. Returns adam_arena's and paged_attention's launches."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    from paddle_tpu_torch.serving import GenerationEngine

    log(f"\n== phase 20: train the decoder LM (vocab {GEN_VOCAB}, emb "
        f"{GEN_EMB}, {GEN_HEADS} heads, {GEN_LAYERS} layers), "
        f"{LM_BATCH} x {LM_SEQ} tokens, Adam({LM_LR}, fused=True), "
        f"{LM_STEPS} steps on both routes, then serve it | {card} ==")
    fluid.reset_unique_name()
    main, startup, test, logits, loss = lm_train_program(fluid, seed)
    log("program: " + op_counts(main.global_block()))
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    update, = [op for op in main.global_block().ops
               if op.type == "fused_adam"]
    grads = update.input("Grads")
    feed = lm_feed(seed)
    problems, res = [], {}
    for route in ("auto", "torch"):
        scope = copy_scope(fluid, torch, init)
        fluid.set_flags({"kernel_tier": route})
        losses, ms, launched = [], [], 0
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for step in range(LM_STEPS):
                opk.reset_launches()
                tier.reset_fallback_counts()
                t0 = time.perf_counter()
                vals = exe.run(main, feed=feed, scope=scope,
                               fetch_list=[loss] + (grads if step == 0
                                                    else []),
                               return_numpy=False)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                n = opk.launches["adam_arena"]
                want = 1 if route == "auto" else 0
                if n != want or tier.fallback_counts():
                    problems.append(
                        f"LM kernel_tier={route} step {step + 1}: "
                        f"adam_arena {n} (want {want}), fallbacks "
                        f"{tier.fallback_counts()}")
                launched += n
                if not torch.isfinite(vals[0]).item():
                    fail(f"LM kernel_tier={route} step {step + 1}: loss "
                         f"{vals[0]}")
                losses.append(vals[0].item())
                if step == 0:
                    first = dict(zip(grads, vals[1:]))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            pscope = copy_scope(fluid, torch, init)
            prof = profile(torch, lambda: exe.run(
                main, feed=feed, scope=pscope, fetch_list=[loss],
                return_numpy=False),
                f"LM training step, kernel_tier={route}", card, reps=3)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
        steady = sum(ms[1:]) / len(ms[1:])
        busy = (f"device busy {prof[1]:.2f} of {prof[0]:.2f} ms "
                f"({100 * prof[1] / prof[0]:.1f}%)" if prof
                else "device busy not measured")
        res[route] = dict(losses=losses, first=first, scope=scope,
                          launched=launched)
        log(f"LM kernel_tier={route}: losses "
            + " ".join(f"{v:.6f}" for v in losses)
            + " | ms/step " + " ".join(f"{v:.1f}" for v in ms)
            + f" | steady {steady:.2f} ms/step, "
            f"{LM_BATCH * LM_SEQ * 1e3 / steady:.0f} tokens/s | {busy} | "
            f"peak memory {peak:.2f} GiB | adam_arena launches {launched} "
            f"| {card}")
    auto, plain = res["auto"], res["torch"]
    top = max(g.abs().max().item() for g in plain["first"].values())
    dg = max((auto["first"][n] - plain["first"][n]).abs().max().item()
             for n in grads) / top
    rel = [abs(a - b) / abs(b) for a, b in zip(auto["losses"],
                                               plain["losses"])]
    log(f"LM step 1, kernel route vs kernel_tier=torch: max |Δ gradient| "
        f"{dg:.3e} of the largest (limit {LM_GRAD_LIMIT:.0e}); losses per "
        "step relative " + " ".join(f"{x:.2e}" for x in rel)
        + f" (limit {LM_ROUTE_REL:.0e})")
    if not dg <= LM_GRAD_LIMIT:
        problems.append(f"LM step-1 gradients differ by {dg:.3e}")
    if not max(rel) <= LM_ROUTE_REL:
        problems.append(f"LM losses differ between routes by {max(rel):.3e}")
    for route in ("auto", "torch"):
        if not res[route]["losses"][-1] < res[route]["losses"][0]:
            problems.append(f"LM kernel_tier={route}: the loss did not "
                            f"fall: {res[route]['losses']}")
    if problems:
        fail("; ".join(problems))

    d = tempfile.mkdtemp(prefix="chip-smoke-lm-trained-")
    fluid.io.save_inference_model(d, ["tokens", "positions"], [logits], exe,
                                  test, scope=auto["scope"])
    geom = dict(max_seqs=GEN_MAX_SEQS, block_size=GEN_BLOCK,
                num_blocks=GEN_BLOCKS, max_len=GEN_MAX_LEN,
                prefill_buckets=(8,))
    served = {}
    for route in ("auto", "torch"):
        fluid.set_flags({"kernel_tier": route})
        try:
            eng = GenerationEngine(d, **geom)
            eng.warmup()
            if eng.device.type != "cuda":
                fail(f"GenerationEngine runs on {eng.device}, want the card")
            decodes0 = eng.stats()["phases"]["decode"][GEN_MAX_SEQS][
                "dispatches"]
            pak.reset_launches()
            tier.reset_fallback_counts()
            lane = gen_lane(eng, True)
            decodes = eng.stats()["phases"]["decode"][GEN_MAX_SEQS][
                "dispatches"] - decodes0
            launches = pak.launches["paged_attention"]
            want = (GEN_LAYERS if route == "auto" else 0) * decodes
            n_tok = sum(len(t) for per in lane["tokens"] for t in per)
            log(f"trained LM served, kernel_tier={route}: {n_tok} tokens in "
                f"{lane['elapsed'] * 1e3:.1f} ms "
                f"({n_tok / lane['elapsed']:.1f} tokens/s), {decodes} "
                f"decode dispatches, paged_attention launches {launches} "
                f"(want {want}), fallbacks {tier.fallback_counts()}")
            if launches != want or tier.fallback_counts():
                problems.append(f"trained LM kernel_tier={route}: "
                                f"{launches} paged_attention launches over "
                                f"{decodes} decode dispatches")
            served[route] = (lane["tokens"], launches)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
    shutil.rmtree(d, ignore_errors=True)
    same = served["auto"][0] == served["torch"][0]
    log(f"trained LM greedy tokens: kernel route = kernel_tier=torch {same}")
    if not same:
        problems.append("the trained LM's greedy tokens differ between "
                        "the routes")
    if problems:
        fail("; ".join(problems))
    return {"adam_arena": auto["launched"],
            "paged_attention": served["auto"][1]}


def lm_dp_program(seed):
    """The LM's training program for the sharded step: (main, startup,
    loss)."""
    import paddle_tpu_torch.fluid as fluid
    main, startup, _, _, loss = lm_train_program(fluid, seed)
    return main, startup, loss


def key_biases(main):
    """The biases added into a causal_self_attention's K input: a shift of
    every key adds one constant to a query's scores, which the softmax
    ignores, so their gradient is 0 in exact arithmetic and what Adam makes
    of its rounding noise is no measure of the step."""
    ops = main.global_block().ops
    keys = {op.input("K")[0] for op in ops
            if op.type == "causal_self_attention"}
    return {op.input("Y")[0] for op in ops
            if op.type == "elementwise_add" and op.output("Out")[0] in keys}


def nccl_dp_rank(kind, seed):
    """One NCCL rank of phase 21 (every rank of the pool runs it): the
    sharded step of ``kind`` ("lm": phase 20's LM under dp; "slice": the
    dryrun's ResNet slice under dp+ZeRO-1) on this rank's card, with the
    launches of adam_arena and momentum_arena it made."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.testing import models, multichip

    # as main() sets them: every float32 conv and GEMM in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "lm":
        build, kw, feed, plan_kw = (lm_dp_program, dict(seed=seed),
                                    lm_feed(seed), None)
    else:
        build, kw, plan_kw = (models.build_convnet_slice,
                              dict(size=16, classes=8, nf=8, seed=3,
                                   bottleneck=True),
                              {"shard_opt_state": True})
        feed = models.convnet_feed(DP_SLICE_BATCH, size=16, classes=8,
                                   seed=1)
    # the pool's backend sets the device: NCCL ranks run on their cards
    dev = f"cuda:{dist.get_rank()}" if dist.get_backend() == "nccl" \
        else "cpu"
    opk.reset_launches()
    out = multichip.sharded_run(build, kw, [feed] * DP_STEPS, ("dp",),
                                plan_kw, device=dev)
    out["launches"] = dict(opk.launches)
    out["backend"] = dist.get_backend()
    return out


def phase_multichip(torch, fluid, seed, card):
    """Phase 21: the LM's dp step and the ResNet slice's dp+ZeRO-1 step
    over NCCL on every visible card against one device, then the eight
    lanes of the reference's dryrun_multichip on 8 gloo ranks of the CPU.
    Returns adam_arena's launches in the NCCL LM step."""
    import numpy as np
    import chip_smoke
    from paddle_tpu_torch.parallel.launch import RankPool
    from paddle_tpu_torch.testing import models, multichip

    world = torch.cuda.device_count()
    log(f"\n== phase 21: multi-device: dp over NCCL on {world} card(s), "
        f"then the reference's eight multichip lanes on 8 gloo ranks of the "
        f"CPU | {card} ==")
    problems = []
    t0 = time.perf_counter()
    with RankPool(world, "nccl", timeout=300) as pool:
        start_s = time.perf_counter() - t0
        ranks = {kind: pool.run(chip_smoke.nccl_dp_rank, kind, seed)
                 for kind in ("lm", "slice")}
    log(f"NCCL pool of {world} rank(s) started in {start_s:.1f} s")
    singles = {
        "lm": multichip.single_run(chip_smoke.lm_dp_program,
                                   dict(seed=seed),
                                   [lm_feed(seed)] * DP_STEPS,
                                   device="cuda:0"),
        "slice": multichip.single_run(
            models.build_convnet_slice,
            dict(size=16, classes=8, nf=8, seed=3, bottleneck=True),
            [models.convnet_feed(DP_SLICE_BATCH, size=16, classes=8,
                                 seed=1)] * DP_STEPS, device="cuda:0")}
    fluid.reset_unique_name()
    noise = key_biases(lm_dp_program(seed)[0])
    for kind, title in (("lm", "LM dp"), ("slice", "resnet_slice dp+zero1")):
        got, single = ranks[kind][0], singles[kind]
        kept = {n: w for n, w in single["params"].items() if n not in noise}
        shift = max([float(np.max(np.abs(got["params"][n]
                                         - single["params"][n])))
                     for n in single["params"] if n in noise] or [0.0])
        if any(r["losses"] != got["losses"] for r in ranks[kind][1:]):
            problems.append(f"{title}: the ranks' losses differ")
        lerr = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                       single["losses"]))
        scale = {n: 1.0 if kind == "lm" else max(float(np.max(np.abs(w))),
                                                  1e-30)
                 for n, w in kept.items()}
        limit = DP_LM_PARAM_ABS if kind == "lm" else multichip.PARAM_LIMIT
        perr = max(float(np.max(np.abs(got["params"][n] - w))) / scale[n]
                   for n, w in kept.items())
        log(f"{title} over {got['backend']} on mesh {got['mesh']}: losses "
            + " ".join(f"{v:.6f}" for v in got["losses"])
            + f", one device " + " ".join(f"{v:.6f}"
                                           for v in single["losses"])
            + f"; loss rel err {lerr:.2e} (limit {multichip.LANE_LIMIT:.0e})"
            f", params max |Δ| {perr:.2e}"
            + (" (limit " if kind == "lm" else " of each one's largest "
               "(limit ") + f"{limit:.0e}; the K biases, whose gradient is "
            f"noise, apart: max |Δ| {shift:.2e}); launches "
            f"{got['launches']}")
        if got["backend"] != "nccl":
            problems.append(f"{title}: backend {got['backend']}")
        if not (lerr <= multichip.LANE_LIMIT and perr <= limit):
            problems.append(f"{title}: sharded step differs from one "
                            "device")
    lm_adam = ranks["lm"][0]["launches"]["adam_arena"]
    if lm_adam != DP_STEPS:
        problems.append(f"LM dp: adam_arena launched {lm_adam} times in "
                        f"{DP_STEPS} steps")
    t0 = time.perf_counter()
    lines, ok = multichip.dryrun_multichip(8, timeout=300)
    log(f"8 gloo ranks: {time.perf_counter() - t0:.1f} s")
    if not ok:
        problems.append("a gloo multichip lane failed: " + "; ".join(lines))
    if problems:
        fail("; ".join(problems))
    return {"adam_arena": sum(r["launches"]["adam_arena"]
                              for r in ranks["lm"])}


# phase 22: Wide&Deep CTR (Cheng et al., "Wide & Deep Learning for
# Recommender Systems", 2016, §5.1: hidden 1024, 512, 256) over phase 10's
# Criteo batch. Deep: the 26 categorical fields hashed into one is_sparse
# table of CTR_ROWS x CTR_DIM, reshaped to [batch, 26 * 64], concatenated
# with the 13 integer fields (log1p'd float32), relu fcs 1024, 512, 256
# and an fc to 1. Wide: an is_sparse table of CTR_ROWS x 1 on the same
# ids, summed over the fields, plus fc(dense, 1). mean sigmoid
# cross-entropy against the click; SGD(lr, fused=True); batch CTR_BATCH.
# Assumptions: the paper's embedding width was 32 (64 keeps phase 10's
# table), its optimizers FTRL and AdaGrad (SGD is the server rule the
# transpiler lifts), and the clicks come from a seeded logistic model of
# the ids hashed into WD["click_buckets"] buckets and of the dense
# features, so that the loss can fall. The sizes sit in a dict so the
# NCCL ranks get them as an argument
WD = dict(rows=CTR_ROWS, dim=CTR_DIM, fields=len(CRITEO_VOCABS), dense=13,
          hidden=(1024, 512, 256), batch=CTR_BATCH, lr=0.05,
          click_buckets=1024)
WD_STEPS, WD_ASYNC_STEPS, WD_SHARDS = 5, 4, 2
# the routes run the same ops up to the update (the kernels are the
# update): step-1 gradients within 1e-6 of the largest element. The
# kernel route's step-1 update is held bitwise against the kernels' plain
# versions (embedding_sgd_torch, sgd_arena_torch) on the same inputs. The
# plain route's is another function: the dense set's update is the same
# expression (bitwise), but a table's is the reference's unmerged
# scatter-add, whose sum of a row's k entries rounds differently from the
# merged one: each side rounds k + 1 times (k adds and the product, or
# k - 1 adds, the product and the difference), so they part by at most
# 2k + 2 float32 roundings of |w| + lr·Σ|v| an element (WD_ROUND_UNIT
# each, to first order), held elementwise after step 1 (the phase
# prints how far they part). So the losses may part too: 1e-6 relative
# in 5 steps
WD_GRAD_LIMIT, WD_ROUTE_REL, WD_ROUND_UNIT = 1e-6, 1e-6, 2.0 ** -24
# through the pservers: step 1 the local step's loss bitwise (the same
# forward from the same parameters); the server's numpy SGD against the
# kernels' update, a float32 rounding a step, within 1e-5 relative
WD_PS_REL = 1e-5


def wd_program(fluid, wd, seed, with_prob=False):
    """Phase 22's Wide&Deep training program: (main, startup, loss), and
    with ``with_prob`` the click probability sigmoid(logit) the served
    bundle fetches (phase 28)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7 + seed
    with fluid.program_guard(main, startup):
        ids = L.data("ids", shape=[wd["fields"], 1], dtype="int64")
        dense = L.data("dense", shape=[wd["dense"]])
        click = L.data("click", shape=[1])
        deep = L.reshape(L.embedding(
            ids, size=[wd["rows"], wd["dim"]], is_sparse=True,
            param_attr=fluid.ParamAttr(name="deep_emb")),
            [-1, wd["fields"] * wd["dim"]])
        h = L.concat([deep, dense], axis=1)
        for width in wd["hidden"]:
            h = L.fc(h, size=width, act="relu")
        wide = L.reshape(L.embedding(
            ids, size=[wd["rows"], 1], is_sparse=True,
            param_attr=fluid.ParamAttr(name="wide_emb")), [-1, wd["fields"]])
        logit = L.elementwise_add(
            L.elementwise_add(L.fc(h, size=1),
                              L.reduce_sum(wide, dim=1, keep_dim=True)),
            L.fc(dense, size=1))
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, click))
        prob = L.sigmoid(logit) if with_prob else None
        fluid.optimizer.SGD(wd["lr"], fused=True).minimize(loss, startup)
    return (main, startup, loss, prob) if with_prob else (main, startup,
                                                          loss)


def wd_dp_program(wd, seed):
    """The Wide&Deep program for the sharded step (ranks import this)."""
    import paddle_tpu_torch.fluid as fluid
    fluid.reset_unique_name()
    return wd_program(fluid, wd, seed)


def wd_feed(np, wd, seed):
    """One batch: ids [batch, fields, 1] (phase 10's Criteo hashing at
    full size, else uniform), the dense fields as log1p of Poisson counts
    of field-wise exponential means, clicks from the logistic model."""
    rng = np.random.RandomState(seed)
    full = (wd["rows"], wd["batch"], wd["fields"]) == \
        (CTR_ROWS, CTR_BATCH, len(CRITEO_VOCABS))
    ids = ctr_ids(rng).reshape(wd["fields"], wd["batch"]).T if full \
        else rng.randint(0, wd["rows"], (wd["batch"], wd["fields"]))
    lam = rng.exponential(5.0, wd["dense"])
    dense = np.log1p(rng.poisson(lam, (wd["batch"], wd["dense"])))
    w = np.random.RandomState(seed + 1).normal(0, 1, wd["click_buckets"])
    v = np.random.RandomState(seed + 2).normal(0, 0.5, wd["dense"])
    score = 1.5 * w[ids % wd["click_buckets"]].sum(1) \
        / np.sqrt(wd["fields"]) + (dense - dense.mean(0)) @ v - 1.0
    click = rng.rand(wd["batch"]) < 1.0 / (1.0 + np.exp(-score))
    return {"ids": np.ascontiguousarray(ids, dtype=np.int64)[..., None],
            "dense": dense.astype(np.float32),
            "click": click.astype(np.float32)[:, None]}


def wd_plan_kw():
    """The sharded step's plan: deep_emb's columns over tp whatever the
    mesh's tp size (a one-card mesh runs the column path on a one-rank
    group); the fcs follow the default policy."""
    from paddle_tpu_torch.parallel.sharding import P
    return {"rules": [("^deep_emb$", P(None, "tp"))]}


def nccl_ctr_rank(wd, seed):
    """One NCCL rank of phase 22's sharded step: the Wide&Deep step over a
    dp x tp mesh of every rank, deep_emb's columns sharded over tp and
    both tables' sparse gradients gathered over dp; with the launches of
    embedding_sgd and sgd_arena it made."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.ops.cuda import embedding as embk
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.testing import multichip

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = f"cuda:{dist.get_rank()}" if dist.get_backend() == "nccl" \
        else "cpu"
    embk.reset_launches()
    opk.reset_launches()
    out = multichip.sharded_run(wd_dp_program, dict(wd=wd, seed=seed),
                                [wd_feed(np, wd, seed)] * DP_STEPS,
                                ("dp", "tp"), wd_plan_kw(), device=dev)
    out["launches"] = {"embedding_sgd": embk.launches["embedding_sgd"],
                       "sgd_arena": opk.launches["sgd_arena"]}
    out["backend"] = dist.get_backend()
    return out


def wd_grads_host(grads):
    """A step's gradients as the trainer pushes them: the sparse ones as
    rpc.SparseGrad (ids + touched rows), the dense ones as numpy."""
    from paddle_tpu_torch.core.sparse import SparseRows
    from paddle_tpu_torch.distributed import SparseGrad
    return {n: SparseGrad.from_sparse_rows(g) if isinstance(g, SparseRows)
            else g.cpu().numpy() for n, g in grads.items()}


def wd_grad_diff(torch, a, b):
    """(max |a - b|, max |b|) over one gradient, dense or SparseRows (the
    rows must be equal)."""
    from paddle_tpu_torch.core.sparse import SparseRows
    if isinstance(b, SparseRows):
        if not torch.equal(a.rows, b.rows):
            return float("inf"), 1.0
        a, b = a.values, b.values
    return (a - b).abs().max().item(), b.abs().max().item()


def wd_plain_update(torch, init, params, grads, first, lr_name):
    """Every parameter after step 1 by the kernels' plain versions, from
    the startup values and the step-1 gradients: embedding_sgd_torch for a
    table (a SparseRows gradient), sgd_arena_torch for the rest."""
    from paddle_tpu_torch.core.sparse import SparseRows
    from paddle_tpu_torch.ops.cuda import embedding as embk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    lr = init.find_var(lr_name).reshape(())
    out = {}
    for p, g in zip(params, grads):
        w, gv = init.find_var(p), first[g]
        if isinstance(gv, SparseRows):
            out[p] = embk.embedding_sgd_torch(
                w, gv.rows, gv.values.to(w.dtype).contiguous(), lr)
        else:
            out[p], = opk.sgd_arena_torch([w], [gv.float().contiguous()],
                                          lr)
    return out


def wd_route_bound(torch, w, g, lr):
    """The elementwise bound on |merged − unmerged| of a table's step-1
    update (see WD_ROUTE_REL): 2k + 2 roundings of |w| + lr·Σ|v| for a row
    of k entries (with the second-order term), 0 for an untouched row."""
    keep = (g.rows >= 0) & (g.rows < w.shape[0])
    rows, vals = g.rows[keep], g.values[keep].to(w.dtype).abs()
    k = torch.zeros(w.shape[0], device=w.device).index_add_(
        0, rows, torch.ones(rows.shape[0], device=w.device))
    mag = torch.zeros_like(w).index_add_(0, rows, vals)
    n = ((2 * k + 2) * (k > 0))[:, None] * WD_ROUND_UNIT
    return n * (1 + n) * (w.abs() + lr.reshape(()) * mag)


def wd_local(torch, fluid, exe, main, loss, params, grads, lr_name, init,
             feed, card, route, problems):
    """WD_STEPS local steps on ``route``: losses, step-1 gradients and
    parameters, ms, peak GiB, the profile, and the launches. On the kernel
    route the step-1 update is held bitwise against the kernels' plain
    versions."""
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import embedding as embk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    scope = copy_scope(fluid, torch, init)
    fluid.set_flags({"kernel_tier": route})
    losses, ms = [], []
    launched = {"embedding_sgd": 0, "sgd_arena": 0}
    want = (2, 1) if route == "auto" else (0, 0)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(WD_STEPS):
            embk.reset_launches()
            opk.reset_launches()
            tier.reset_fallback_counts()
            t0 = time.perf_counter()
            vals = exe.run(main, feed=feed, scope=scope,
                           fetch_list=[loss] + (grads if step == 0
                                                else []),
                           return_numpy=False)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            n = (embk.launches["embedding_sgd"], opk.launches["sgd_arena"])
            if n != want or tier.fallback_counts():
                problems.append(
                    f"Wide&Deep kernel_tier={route} step {step + 1}: "
                    f"embedding_sgd {n[0]}, sgd_arena {n[1]} (want "
                    f"{want}), fallbacks {tier.fallback_counts()}")
            launched["embedding_sgd"] += n[0]
            launched["sgd_arena"] += n[1]
            if not torch.isfinite(vals[0]).item():
                fail(f"Wide&Deep kernel_tier={route} step {step + 1}: "
                     f"loss {vals[0]}")
            losses.append(vals[0].item())
            if step == 0:
                first = dict(zip(grads, vals[1:]))
                after = {p: scope.find_var(p).clone() for p in params}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        pscope = copy_scope(fluid, torch, init)
        prof = profile(torch, lambda: exe.run(
            main, feed=feed, scope=pscope, fetch_list=[loss],
            return_numpy=False),
            f"Wide&Deep training step, kernel_tier={route}", card, reps=3)
    finally:
        fluid.set_flags({"kernel_tier": "auto"})
    steady = sum(ms[1:]) / len(ms[1:])
    busy = (f"device busy {prof[1]:.2f} of {prof[0]:.2f} ms "
            f"({100 * prof[1] / prof[0]:.1f}%)" if prof
            else "device busy not measured")
    log(f"Wide&Deep local, kernel_tier={route}: losses "
        + " ".join(f"{v:.6f}" for v in losses)
        + " | ms/step " + " ".join(f"{v:.1f}" for v in ms)
        + f" | steady {steady:.2f} ms/step, "
        f"{WD['batch'] * 1e3 / steady:.0f} examples/s | {busy} | peak "
        f"memory {peak:.2f} GiB | launches {launched} | {card}")
    if route == "auto":
        want = wd_plain_update(torch, init, params, grads, first, lr_name)
        bad = [p for p in params if not torch.equal(after[p], want[p])]
        log(f"Wide&Deep step-1 update on the kernel route against "
            f"embedding_sgd_torch (deep_emb, wide_emb) and sgd_arena_torch "
            f"({len(params) - 2} dense): bitwise for "
            f"{len(params) - len(bad)} of {len(params)}")
        if bad:
            diff = max((after[p] - want[p]).abs().max().item() for p in bad)
            problems.append(f"Wide&Deep step-1 update differs from the "
                            f"plain versions in {bad}: max abs {diff:.3e}, "
                            f"want bitwise")
        del want
    return dict(losses=losses, first=first, after=after, launched=launched,
                ms=steady)


def wd_pserver(torch, fluid, exe, t, loss, feed, init, card, mode, steps,
               problems):
    """``steps`` steps of the transpiled trainer through WD_SHARDS shard
    processes (``mode`` "sync": pull, install, step, fetch, push in turn;
    "async": through OverlappedRemoteUpdater). Returns the losses and, in
    sync mode, the per-step times and wire bytes."""
    from paddle_tpu_torch.distributed import (OverlappedRemoteUpdater,
                                              PserverSupervisor,
                                              install_params)
    trainer = t.get_trainer_program()
    names = [p for p, _ in t.params_grads]
    grads = [g for _, g in t.params_grads]
    scope = copy_scope(fluid, torch, init)
    held = {n: scope.find_var(n) for n in names}
    t0 = time.perf_counter()
    # checkpoint_every=0: no per-update checkpoint of the 256 MB table
    with PserverSupervisor(n_servers=WD_SHARDS, optimizer=t.optimizer,
                           opt_kwargs=t.opt_kwargs, mode=mode, fan_in=1,
                           checkpoint_every=0) as sup:
        if not sup.wait_ready(120.0):
            fail(f"pserver shards ({mode}) did not answer in 120 s: "
                 f"{sup.child_stats()}")
        start_s = time.perf_counter() - t0
        client = t.trainer_client(
            endpoints=[f"{h}:{p}" for h, p in sup.addresses])
        t0 = time.perf_counter()
        client.init_params({n: init.find_var(n).cpu().numpy()
                            for n in names})
        init_s = time.perf_counter() - t0
        losses, split, wire = [], [], []
        upd = OverlappedRemoteUpdater(client, scope, names,
                                      device=exe.device) \
            if mode == "async" else None
        for _ in range(steps):
            w0 = client.wire_stats()
            c0 = time.perf_counter()
            if upd is not None:
                upd.sync_in()
                torch.cuda.synchronize()
                c1 = c2 = time.perf_counter()
            else:
                pulled = client.pull()
                c1 = time.perf_counter()
                install_params(scope, pulled, device=exe.device)
                torch.cuda.synchronize()
                c2 = time.perf_counter()
            vals = exe.run(trainer, feed=feed, scope=scope,
                           fetch_list=[loss] + grads,
                           return_numpy=False)
            losses.append(vals[0].item())
            c3 = time.perf_counter()
            step_grads = dict(zip(names, vals[1:]))
            if upd is not None:
                upd.submit(step_grads)
                c4 = c5 = time.perf_counter()
            else:
                host = wd_grads_host(step_grads)
                c4 = time.perf_counter()
                client.push(host)
                c5 = time.perf_counter()
            w1 = client.wire_stats()
            split.append(((c1 - c0) * 1e3, (c2 - c1) * 1e3,
                          (c3 - c2) * 1e3, (c4 - c3) * 1e3,
                          (c5 - c4) * 1e3))
            wire.append((w1["bytes_sent"] - w0["bytes_sent"],
                         w1["bytes_recv"] - w0["bytes_recv"]))
        if upd is not None:
            upd.finish()
        client.close()
        alive = sup.child_stats()
    if not all(c["alive"] and c["restart_count"] == 0 for c in alive):
        problems.append(f"pserver shards ({mode}) died or restarted: "
                        f"{alive}")
    moved = [n for n in names if scope.find_var(n) is not held[n]
             or scope.find_var(n).device.type != "cuda"]
    if moved:
        problems.append(f"pulled params not installed into the scope's "
                        f"tensors on the card: {moved}")
    return dict(losses=losses, split=split, wire=wire, start_s=start_s,
                init_s=init_s)


def wd_split_ops(torch, fluid, feed, sr, card, problems):
    """split_ids over the batch's ids and split_selected_rows over the
    step-1 deep_emb gradient, on the card and on the CPU: bitwise equal,
    split_ids at one host sync a call, split_selected_rows at none."""
    from paddle_tpu_torch.core.sparse import SparseRows
    from paddle_tpu_torch.ops import nn_ops

    n_ids = 4
    halves = [WD["rows"] // 2, WD["rows"] - WD["rows"] // 2]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        block = main.global_block()
        outs = [block.create_var(name=f"ids_shard{i}", dtype="int64")
                for i in range(n_ids)]
        block.append_op("split_ids", inputs={"Ids": [ids.name]},
                        outputs={"Out": [o.name for o in outs]})
        x = block.create_var(name="deep_grad")
        parts = [block.create_var(name=f"grad_part{i}") for i in range(2)]
        block.append_op("split_selected_rows", inputs={"X": [x.name]},
                        outputs={"Out": [p.name for p in parts]},
                        attrs={"height_sections": halves})
    fetch = [o.name for o in outs] + [p.name for p in parts]
    flat = torch.from_numpy(feed["ids"].reshape(-1, 1))
    got = {}
    ctx, syncs, where = sync_counter(torch)
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        scope = fluid.Scope()
        scope.set("deep_grad", SparseRows(sr.rows.to(exe.device),
                                          sr.values.to(exe.device),
                                          sr.nrows))
        ids_in = flat.to(exe.device)
        before = nn_ops.host_syncs()["split_ids"]
        torch.cuda.synchronize()
        where[0] = dev
        with ctx():
            vals = exe.run(main, feed={"ids": ids_in}, fetch_list=fetch,
                           scope=scope, return_numpy=False)
        counted = nn_ops.host_syncs()["split_ids"] - before
        got[dev] = (vals, counted)
    (cv, ccount), (hv, hcount) = got["cuda"], got["cpu"]
    same = all(torch.equal(a.cpu(), b) for a, b in zip(cv[:n_ids],
                                                       hv[:n_ids]))
    same_rows = all(torch.equal(a.rows.cpu(), b.rows)
                    and torch.equal(a.values.cpu(), b.values)
                    and a.nrows == b.nrows for a, b in zip(cv[n_ids:],
                                                           hv[n_ids:]))
    log(f"split_ids ({flat.shape[0]} ids into {n_ids} shards: "
        + ", ".join(str(v.shape[0]) for v in cv[:n_ids])
        + f") and split_selected_rows (the step-1 deep_emb gradient, "
        f"{sr.rows.shape[0]} entries, sections {halves}) on the card: "
        f"bitwise the CPU's {same} / {same_rows}; host syncs torch reports "
        f"in the run {syncs.get('cuda', 0)}, split_ids' own count "
        f"{ccount} (CPU {hcount}) | {card}")
    if not (same and same_rows):
        problems.append("split_ids / split_selected_rows differ between "
                        "the card and the CPU")
    if ccount != 1 or hcount != 0 or syncs.get("cuda", 0) != 1:
        problems.append(f"split ops: {syncs.get('cuda', 0)} host syncs on "
                        f"the card (want 1, split_ids' count read), "
                        f"counted {ccount}/{hcount}")


def phase_ctr(torch, fluid, seed, card):
    """Phase 22: Wide&Deep CTR trained locally on both routes, then the
    same program through transpiled pserver shard processes (sync, then
    async through OverlappedRemoteUpdater), then the sharded step over
    NCCL on every visible card, then the sharded table's routing ops.
    Returns embedding_sgd's and sgd_arena's launches."""
    import numpy as np
    import chip_smoke
    from paddle_tpu_torch.core.sparse import SparseRows
    from paddle_tpu_torch.parallel.launch import RankPool
    from paddle_tpu_torch.testing import multichip

    wd = WD
    log(f"\n== phase 22: Wide&Deep CTR ({wd['fields']} hashed fields into "
        f"is_sparse tables of {wd['rows']} x {wd['dim']} and "
        f"{wd['rows']} x 1, {wd['dense']} dense, hidden {wd['hidden']}), "
        f"batch {wd['batch']}, SGD({wd['lr']}, fused=True): {WD_STEPS} "
        f"local steps on both routes, through {WD_SHARDS} pserver shards "
        f"(sync, async), the sharded step over NCCL, the routing ops "
        f"| {card} ==")
    t_phase = time.perf_counter()
    fluid.reset_unique_name()
    main, startup, loss = wd_program(fluid, wd, seed)
    block = main.global_block()
    log("program: " + op_counts(block))
    update, = [op for op in block.ops if op.type == "fused_sgd"]
    params, grads = update.input("Params"), update.input("Grads")
    lr_name, = update.input("LearningRate")
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    feed = wd_feed(np, wd, seed)
    uniq = np.unique(feed["ids"])
    log(f"batch: {feed['ids'].size} ids, {uniq.size} distinct rows, click "
        f"rate {feed['click'].mean():.3f}")
    problems = []
    res = {route: wd_local(torch, fluid, exe, main, loss, params, grads,
                           lr_name, init, feed, card, route, problems)
           for route in ("auto", "torch")}
    auto, plain = res["auto"], res["torch"]
    diffs = [wd_grad_diff(torch, auto["first"][n], plain["first"][n])
             for n in grads]
    dg = max(d for d, _ in diffs) / max(m for _, m in diffs)
    rel = [abs(a - b) / abs(b) for a, b in zip(auto["losses"],
                                               plain["losses"])]
    log(f"Wide&Deep step 1, kernel route vs kernel_tier=torch: max |Δ "
        f"gradient| {dg:.3e} of the largest (limit {WD_GRAD_LIMIT:.0e}); "
        "losses per step relative " + " ".join(f"{x:.2e}" for x in rel)
        + f" (limit {WD_ROUTE_REL:.0e})")
    if not dg <= WD_GRAD_LIMIT:
        problems.append(f"Wide&Deep step-1 gradients differ by {dg:.3e}")
    lr = init.find_var(lr_name)
    for p, g in zip(params, grads):
        a, b = auto["after"][p], plain["after"][p]
        if not isinstance(plain["first"][g], SparseRows):
            if not torch.equal(a, b):
                problems.append(f"Wide&Deep step-1 {p}: the routes' dense "
                                f"updates differ, want bitwise")
            continue
        d = (a - b).abs()
        bound = wd_route_bound(torch, init.find_var(p), plain["first"][g],
                               lr)
        log(f"Wide&Deep step-1 {p}, kernel route vs kernel_tier=torch: "
            f"{int((d > 0).sum().item())} of {d.numel()} elements differ, "
            f"max |Δ| {d.max().item():.3e}, at most "
            f"{(d / bound.clamp_min(1e-45)).max().item():.3f} of the "
            f"elementwise rounding bound")
        if not bool((d <= bound).all().item()):
            problems.append(f"Wide&Deep step-1 {p}: the routes' tables "
                            f"differ beyond the rounding bound")
        del d, bound
    if not max(rel) <= WD_ROUTE_REL:
        problems.append(f"Wide&Deep losses differ between routes by "
                        f"{max(rel):.3e}")
    for route in ("auto", "torch"):
        if not res[route]["losses"][-1] < res[route]["losses"][0]:
            problems.append(f"Wide&Deep kernel_tier={route}: the loss did "
                            f"not fall: {res[route]['losses']}")
    if problems:
        fail("; ".join(problems))

    t = fluid.DistributeTranspiler().transpile(
        0, program=main, pservers="127.0.0.1:6170,127.0.0.1:6171",
        trainers=1, startup_program=startup)
    log(f"transpiled: rule {t.optimizer} {t.opt_kwargs}, sparse "
        f"{t.sparse_param_names}, trainer program "
        + op_counts(t.get_trainer_program().global_block()))
    ps = wd_pserver(torch, fluid, exe, t, loss, feed, init, card, "sync",
                    WD_STEPS, problems)
    prel = [abs(a - b) / abs(b) for a, b in zip(ps["losses"],
                                               auto["losses"])]
    names = ("pull", "install", "step", "fetch", "push")
    mean = [sum(s[i] for s in ps["split"][1:]) / (WD_STEPS - 1)
            for i in range(5)]
    log(f"Wide&Deep through {WD_SHARDS} pserver shards (sync, 1 trainer): "
        f"shards up in {ps['start_s']:.2f} s, init_params "
        f"{ps['init_s']:.2f} s; losses "
        + " ".join(f"{v:.6f}" for v in ps["losses"])
        + "; against the local kernel route: step 1 bitwise "
        f"{ps['losses'][0] == auto['losses'][0]}, relative "
        + " ".join(f"{x:.2e}" for x in prel)
        + f" (limit {WD_PS_REL:.0e}) | per step (mean of steps 2-"
        f"{WD_STEPS}): " + ", ".join(f"{k} {v:.1f} ms"
                                     for k, v in zip(names, mean))
        + f", {sum(mean):.1f} ms in all against {auto['ms']:.1f} ms local"
        f" | bytes a step: pushed "
        + " ".join(str(w[0]) for w in ps["wire"]) + ", pulled "
        + " ".join(str(w[1]) for w in ps["wire"]) + f" | {card}")
    if ps["losses"][0] != auto["losses"][0]:
        problems.append(f"pserver step 1 loss {ps['losses'][0]!r} is not "
                        f"the local one {auto['losses'][0]!r}")
    if not max(prel) <= WD_PS_REL:
        problems.append(f"pserver losses differ from local by "
                        f"{max(prel):.3e}")
    asy = wd_pserver(torch, fluid, exe, t, loss, feed, init, card, "async",
                     WD_ASYNC_STEPS, problems)
    log(f"Wide&Deep async through OverlappedRemoteUpdater: losses "
        + " ".join(f"{v:.6f}" for v in asy["losses"])
        + f" | ms a step (sync_in, -, step, -, submit) "
        + "; ".join(" ".join(f"{x:.1f}" for x in s) for s in asy["split"]))
    if not asy["losses"][-1] < asy["losses"][0]:
        problems.append(f"async pserver: the loss did not fall: "
                        f"{asy['losses']}")
    if problems:
        fail("; ".join(problems))

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    with RankPool(world, "nccl", timeout=300) as pool:
        start_s = time.perf_counter() - t0
        ranks = pool.run(chip_smoke.nccl_ctr_rank, wd, seed)
    single = multichip.single_run(wd_dp_program, dict(wd=wd, seed=seed),
                                  [feed] * DP_STEPS, device="cuda:0")
    got = ranks[0]
    lerr = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   single["losses"]))
    perr = max(float(np.max(np.abs(got["params"][n] - w)))
               / max(float(np.max(np.abs(w))), 1e-30)
               for n, w in single["params"].items())
    log(f"Wide&Deep sharded step over {got['backend']} on mesh "
        f"{got['mesh']} (pool up in {start_s:.1f} s): deep_emb "
        f"{got['specs'].get('deep_emb')}; losses "
        + " ".join(f"{v:.6f}" for v in got["losses"]) + ", one device "
        + " ".join(f"{v:.6f}" for v in single["losses"])
        + f"; loss rel err {lerr:.2e} (limit {multichip.LANE_LIMIT:.0e}), "
        f"params max |Δ| {perr:.2e} of each one's largest (limit "
        f"{multichip.PARAM_LIMIT:.0e}); launches per rank "
        + str([r["launches"] for r in ranks]))
    if any(r["losses"] != got["losses"] for r in ranks[1:]):
        problems.append("Wide&Deep sharded: the ranks' losses differ")
    if got["backend"] != "nccl" or got["specs"].get("deep_emb") != \
            [None, "tp"]:
        problems.append(f"Wide&Deep sharded: backend {got['backend']}, "
                        f"deep_emb spec {got['specs'].get('deep_emb')}")
    if not (lerr <= multichip.LANE_LIMIT and perr <= multichip.PARAM_LIMIT):
        problems.append("Wide&Deep sharded step differs from one device")
    wd_split_ops(torch, fluid, feed, plain["first"]["deep_emb@GRAD"], card,
                 problems)
    if problems:
        fail("; ".join(problems))
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return {k: auto["launched"][k] + sum(r["launches"][k] for r in ranks)
            for k in ("embedding_sgd", "sgd_arena")}


# phase 23: bench.py:352's ragged LSTM lane (run_lstm_ragged_lane) through
# the port's input pipeline (paddle_tpu_torch/testing/ragged_lane.py holds
# its widths: batch 64, bounds [12, 100], 4608 sequences half of length
# 10-12 and half 96-100, vocab 30000, emb 128, hidden 512, unfused Adam
# 2e-3), best of RAGGED_EPOCHS timed epochs after a warm-up epoch per path
# on the kernel route, as bench.py times it. The torch route, a yardstick
# whose plain LSTM backward sets its step (~0.3 s at L 100), times one
# epoch after its warm-up, which keeps the whole script within half its
# time limit
RAGGED_EPOCHS, RAGGED_TORCH_EPOCHS = 3, 1
# the epoch's depth: a quarter of the lane's 4608 sequences (its widths,
# bounds and half-short, half-long mix kept), which keeps the whole
# script within its time limit since phase 28 joined it
RAGGED_SEQS = 1152
# the two routes' epoch losses: the kernel route's LSTMs round their
# products to bf16 (phase 5), the torch route's scans do not, so each
# step's loss moves by the carries' rare bf16 moves, and 72 Adam steps
# carry them on; the epoch's mean loss within phase 5's recurrent
# tolerance, LSTM_FWD_LIMIT relative
RAGGED_LOSS_LIMIT = LSTM_FWD_LIMIT
# phase 23(c): dataset.mnist.train() in batches of MNIST_BATCH written to
# MNIST_SHARDS recordio shards, read back through open_files(thread_num=4)
# -> create_shuffle_reader(MNIST_SHUFFLE records) -> the double buffer ->
# create_multi_pass_reader(MNIST_PASSES) -> read_file into digits_mlp
MNIST_BATCH, MNIST_SHARDS, MNIST_SHUFFLE, MNIST_PASSES = 64, 4, 8, 2


def ragged_lstm_kernels(torch, rnn, init, main, lengths, card):
    """lstm_seq and lstm_seq_bwd against their plain versions (and the
    forward against the float64 recipe) at phase 5's limits, at the
    short bucket's shape (b 64, L 12, H 512, the batch's lengths, each
    layer's startup W); then their times there. Returns
    {kernel: {"l12_ms", "l12_plain_ms", "l12_bound_ms"}}."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    lens = torch.tensor(lengths, device=dev)
    L, b = int(lens.max()), len(lens)
    out = {}
    for i, op in enumerate(op for op in main.global_block().ops
                           if op.type == "lstm"):
        w = init.find_var(op.input("Weight")[0])
        H = w.shape[0]
        x, alive, _, h0, c0, dhs, dcs = lstm_operands(torch, gen, dev, lens,
                                                      L, H)
        log(f"lstm #{i + 1}: lstm_seq / lstm_seq_bwd vs their plain "
            f"versions at b {b}, L {L}, H {H}, lengths "
            f"{int(lens.min())}..{L}, the startup W | {card}")
        hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
        torch.cuda.synchronize()
        ref = rnn.lstm_seq_torch(x, alive, w, h0, c0)
        lstm_fwd_check(torch, (hs, cs), ref,
                       lstm_float64(torch, x, alive, w, h0, c0), "lstm_seq")
        lstm_bwd_check(torch, rnn, (x, alive, w, h0, c0, *ref, dhs, dcs))
    gemm = 2 * L * b * H * 4 * H
    fwd_bytes = 4 * (L * b * 4 * H + L * b + 4 * H * H + 2 * b * H
                     + 2 * L * b * H)
    bwd_bytes = 4 * (2 * L * b * 4 * H + L * b + 2 * 4 * H * H + 4 * b * H
                     + 4 * L * b * H)
    t_bwd, _ = bwd_ops_ms(gemm)
    out["lstm_seq"] = dict(
        l12_ms=time_ms(lambda: rnn.lstm_seq(x, alive, w, h0, c0), torch),
        l12_plain_ms=time_ms(lambda: rnn.lstm_seq_torch(x, alive, w, h0, c0),
                             torch),
        l12_bound_ms=max(gemm / PEAK_FLOPS["bfloat16"] * 1e3,
                         fwd_bytes / PEAK_BYTES * 1e3))
    args = (x, alive, w, h0, c0, *ref, dhs, dcs)
    out["lstm_seq_bwd"] = dict(
        l12_ms=time_ms(lambda: rnn.lstm_seq_bwd(*args), torch),
        l12_plain_ms=time_ms(lambda: rnn.lstm_seq_bwd_torch(*args), torch),
        l12_bound_ms=max(t_bwd, bwd_bytes / PEAK_BYTES * 1e3))
    for k, t in out.items():
        log(f"{k} per launch at L {L}: kernel {t['l12_ms']:.4f} ms, plain "
            f"{t['l12_plain_ms']:.4f} ms, bound {t['l12_bound_ms']:.4f} ms "
            f"| {card}")
    return out


def ragged_route(torch, fluid, exe, lane, main, loss, init, batches, route,
                 counters, problems):
    """One path's epochs on ``route`` from a copy of the startup state:
    each bound's batches staged with prepare_steps (untimed), a warm-up
    epoch (its per-step losses, its launches checked: 2 lstm_seq and 2
    lstm_seq_bwd a step, no other kernel and no lstm fallback on the
    kernel route, none on the torch route), then the best of
    RAGGED_EPOCHS timed epochs (RAGGED_TORCH_EPOCHS on the torch route).
    Returns (losses, ms a sample, the handles, the kernel launches of
    those epochs, steps)."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    read, reset = counters
    fluid.set_flags({"kernel_tier": route})
    try:
        scope = copy_scope(fluid, torch, init)
        grouped, n_samples = lane.groups(batches)
        steps = sum(len(v) for v in grouped.values())
        handles = lane.prepare(exe, main, loss, scope, grouped)
        reset()
        tier.reset_fallback_counts()
        losses = lane.epoch(exe, handles)
        torch.cuda.synchronize()
        got = {k: v for k, v in read().items() if v}
        want = {"lstm_seq": 2 * steps, "lstm_seq_bwd": 2 * steps} \
            if route == "auto" else {}
        falls = tier.fallback_counts().get("lstm", 0)
        if got != want or falls:
            problems.append(f"ragged lane, kernel_tier={route}: launches "
                            f"{got} and {falls} lstm fallbacks in {steps} "
                            f"steps, want {want} and none")
        if losses.shape != (steps,) or not np.isfinite(losses).all():
            fail(f"ragged lane, kernel_tier={route}: losses {losses}")
        best = float("inf")
        epochs = RAGGED_EPOCHS if route == "auto" else RAGGED_TORCH_EPOCHS
        for _ in range(epochs):
            t0 = time.perf_counter()
            for h in handles:
                last = exe.run_prepared(h, return_numpy=False)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        if not bool(torch.isfinite(last[0]).all()):
            fail(f"ragged lane, kernel_tier={route}: non-finite loss")
        total = {k: v for k, v in read().items() if v}
        if total != {k: v * (1 + epochs) for k, v in want.items()}:
            problems.append(f"ragged lane, kernel_tier={route}: {total} "
                            f"launches in {1 + epochs} epochs")
        return losses, best / n_samples * 1e3, handles, total, steps
    finally:
        fluid.set_flags({"kernel_tier": "auto"})


def ragged_double_buffer(torch, fluid, exe, lane, reader, main, loss, init,
                         batches, counters, card, problems):
    """Phase 23(b): the bucketed epoch fed one exe.run a batch, from host
    numpy and through reader.double_buffer onto the card (the feeder as
    ``convert``), each from a copy of the startup state: the per-batch
    losses bitwise equal; ms a step of each and the busy share of a
    profiled epoch of each. Returns the kernel launches made."""
    from paddle_tpu_torch.reader import prefetch
    read, reset = counters
    res, launched = {}, {"lstm_seq": 0, "lstm_seq_bwd": 0}

    def host_feeds():
        return (lane.feed_of(c, b) for c, b in batches)

    staged = reader.double_buffer(lambda: iter(batches),
                                  place=fluid.CUDAPlace(0),
                                  convert=lambda cb: lane.feed_of(*cb))
    for how, feeds in (("host numpy", host_feeds), ("double buffer",
                                                    staged)):
        scope = copy_scope(fluid, torch, init)
        reset()
        prefetch.reset_staged()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in feeds()]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(losses)
        counts = read()
        for k in launched:
            launched[k] += counts[k]
        if counts["lstm_seq"] != 2 * len(batches):
            problems.append(f"double buffer, {how}: {counts['lstm_seq']} "
                            f"lstm_seq launches in {len(batches)} steps")
        res[how] = (losses, ms, dict(prefetch.staged))

        def epoch(feeds=feeds, scope=scope):
            for f in feeds():
                exe.run(main, feed=f, fetch_list=[loss], scope=scope)

        reset()
        prof = profile(torch, epoch, f"the bucketed epoch, one exe.run a "
                       f"batch, fed from {how}", card, reps=1)
        counts = read()
        for k in launched:
            launched[k] += counts[k]
        busy = f"{100 * prof[1] / prof[0]:.1f}%" if prof else "not measured"
        log(f"phase 23(b) {how}: {ms:.3f} ms a step over {len(losses)} "
            f"steps, busy {busy} of a profiled epoch; staged onto the card "
            f"{res[how][2]['batches']} batches, {res[how][2]['bytes']} bytes "
            f"| {card}")
    a, b = res["host numpy"][0], res["double buffer"][0]
    same = len(a) == len(b) == len(batches) and all(
        x.tobytes() == y.tobytes() for x, y in zip(a, b))
    log(f"phase 23(b): {len(b)} per-batch losses through the double buffer "
        f"{'bitwise' if same else 'NOT bitwise'} those of the host feed "
        f"(first {float(a[0]):.6f}, last {float(a[-1]):.6f})")
    if not same:
        problems.append("double buffer: the staged epoch's losses differ "
                        "from the host feed's")
    if res["double buffer"][2]["batches"] != len(batches):
        problems.append(f"double buffer staged "
                        f"{res['double buffer'][2]['batches']} batches, "
                        f"want {len(batches)}")
    return launched


def reader_graph_mnist(torch, fluid, work, card, problems):
    """Phase 23(c): dataset.mnist.train() batched and written through
    fluid.recordio_writer into MNIST_SHARDS shards; the Fluid reader graph
    open_files(thread_num=4) -> create_shuffle_reader ->
    create_double_buffer_reader(CUDAPlace(0)) -> create_multi_pass_reader
    -> read_file feeds digits_mlp until StopIteration. The popped tensors
    lie on the card, each pass pops every record once, the loss falls."""
    import collections
    import hashlib
    import numpy as np
    from paddle_tpu_torch import dataset, reader
    from paddle_tpu_torch.reader import prefetch
    from paddle_tpu_torch.testing import models

    scratch, scratch_start = fluid.Program(), fluid.Program()
    with fluid.program_guard(scratch, scratch_start):
        img_v = fluid.layers.data("img", shape=[784])
        lbl_v = fluid.layers.data("label", shape=[1], dtype="int64")
    feeder = fluid.DataFeeder([img_v, lbl_v], fluid.CUDAPlace(0))
    batches = list(reader.batch(dataset.mnist.train(), MNIST_BATCH,
                                drop_last=True)())
    paths = [os.path.join(work, f"mnist-{i:05d}.recordio")
             for i in range(MNIST_SHARDS)]
    t0 = time.perf_counter()
    for i, p in enumerate(paths):
        fluid.recordio_writer.convert_reader_to_recordio_file(
            p, lambda i=i: iter(batches[i::MNIST_SHARDS]), feeder)
    write_ms = (time.perf_counter() - t0) * 1e3

    def key(img, lbl):
        return hashlib.sha1(np.ascontiguousarray(img).tobytes()
                            + np.ascontiguousarray(lbl).tobytes()).hexdigest()

    written = collections.Counter()
    for b in batches:
        f = feeder.feed(b)
        written[key(f["img"], f["label"])] += 1
    log(f"\n== phase 23(c): mnist ({len(batches)} batches of {MNIST_BATCH}) "
        f"written to {MNIST_SHARDS} recordio shards in {write_ms:.1f} ms; "
        f"open_files(thread_num=4) -> shuffle({MNIST_SHUFFLE}) -> double "
        f"buffer on CUDAPlace(0) -> multi_pass({MNIST_PASSES}) -> read_file "
        f"-> digits_mlp | {card} ==")
    popped = []

    def inputs(layers):
        r = layers.open_files(paths, thread_num=4,
                              shapes=[[-1, 784], [-1, 1]],
                              lod_levels=[0, 0], dtypes=["float32", "int64"])
        r = layers.create_shuffle_reader(r, buffer_size=MNIST_SHUFFLE)
        r = layers.create_double_buffer_reader(r, place=fluid.CUDAPlace(0))
        r = layers.create_multi_pass_reader(r, pass_num=MNIST_PASSES)
        popped[:] = layers.read_file(r)
        return popped

    fluid.reset_unique_name()
    main, startup, v = models.digits_mlp(fluid, inputs=inputs)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    prefetch.reset_staged()
    losses, keys, devices = [], [], set()
    t0 = time.perf_counter()
    while True:
        try:
            img, lbl, lv = exe.run(main, fetch_list=popped + [v["loss"]],
                                   scope=scope, return_numpy=False)
        except StopIteration:
            break
        devices.update((img.device.type, lbl.device.type))
        keys.append(key(img.cpu().numpy(), lbl.cpu().numpy()))
        losses.append(float(lv))
    ms = (time.perf_counter() - t0) * 1e3 / max(len(losses), 1)
    n = len(batches)
    passes = [collections.Counter(keys[i * n:(i + 1) * n])
              for i in range(MNIST_PASSES)]
    once = len(keys) == MNIST_PASSES * n and all(p == written
                                                 for p in passes)
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"reader graph: {len(losses)} steps until StopIteration "
        f"({MNIST_PASSES} passes of {n} records), popped tensors on "
        f"{sorted(devices)}, every record once a pass: {once}; "
        f"{prefetch.staged['batches']} batches ({prefetch.staged['bytes']} "
        f"bytes) staged onto the card by the double buffer; loss "
        f"{head:.4f} (first 5 steps) -> {tail:.4f} (last 5); {ms:.3f} ms "
        f"a step | {card}")
    if devices != {"cuda"}:
        problems.append(f"reader graph: popped tensors on {devices}")
    if not once:
        problems.append("reader graph: a pass did not pop every record "
                        "exactly once")
    if prefetch.staged["batches"] != MNIST_PASSES * n:
        problems.append(f"reader graph: the double buffer staged "
                        f"{prefetch.staged['batches']} batches, want "
                        f"{MNIST_PASSES * n}")
    if not (np.isfinite(losses).all() and tail < head):
        problems.append(f"reader graph: the loss did not fall "
                        f"({head:.4f} -> {tail:.4f})")
    iv, = exe.run(main, fetch_list=popped[:1], scope=scope,
                  return_numpy=False)
    if tuple(iv.shape) != (MNIST_BATCH, 784):
        problems.append(f"reader graph: the pass after StopIteration "
                        f"popped {tuple(iv.shape)}")


def phase_input_pipeline(torch, fluid, seed, card):
    """Phase 23: bench.py:352's ragged LSTM lane through recordio and
    bucket_by_length on both routes, the same epoch through the double
    buffer, and a Fluid reader graph over MNIST shards. Returns the
    lstm_seq / lstm_seq_bwd launches, and their times at L 12."""
    from paddle_tpu_torch import reader, recordio
    from paddle_tpu_torch.ops.cuda import rnn
    from paddle_tpu_torch.testing import ragged_lane as lane

    t_phase = time.perf_counter()
    native = recordio.backend()
    log(f"\n== phase 23: input pipeline — bench.py:352's ragged LSTM lane "
        f"(batch {lane.BATCH}, {RAGGED_SEQS} of its {lane.N_SEQS} "
        f"sequences, half "
        f"{lane.SHORT[0]}-{lane.SHORT[1]} and half "
        f"{lane.LONG[0]}-{lane.LONG[1]} long, bounds {list(lane.BOUNDS)}, "
        f"hidden {lane.HIDDEN}), the double buffer, a Fluid reader graph; "
        f"recordio backend {native}"
        + ("" if native == "native" else
           f" (the native library is unavailable here: "
           f"{recordio.native_error()})") + f" | {card} ==")
    work = tempfile.mkdtemp(prefix="chip-smoke-input-")
    try:
        samples = lane.corpus(RAGGED_SEQS, lane.VOCAB, lane.SHORT,
                              lane.LONG)
        path = os.path.join(work, "corpus.recordio")
        t0 = time.perf_counter()
        n = reader.creator.convert_reader_to_recordio_file(
            path, lambda: iter(samples))
        write_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        bucketed = lane.bucketed_batches(path, lane.BOUNDS, lane.BATCH)
        read_ms = (time.perf_counter() - t0) * 1e3
        flat = lane.flat_batches(samples, lane.BATCH, lane.BOUNDS[-1])
        bounds = sorted({b for _, b in bucketed})
        log(f"corpus: {n} records, {os.path.getsize(path)} bytes written in "
            f"{write_ms:.1f} ms, read and bucketed in {read_ms:.1f} ms: "
            f"{len(flat)} flat batches at {lane.BOUNDS[-1]}, "
            f"{len(bucketed)} bucketed ("
            + ", ".join(f"{sum(1 for _, b in bucketed if b == x)} at {x}"
                        for x in bounds) + ")")
        if n != RAGGED_SEQS or bounds != list(lane.BOUNDS):
            fail(f"ragged lane: {n} records, bounds {bounds}")

        fluid.reset_unique_name()
        main, startup, loss = lane.build(fluid, lane.VOCAB, lane.EMB,
                                         lane.HIDDEN, lane.LR, seed)
        log("program: " + op_counts(main.global_block()))
        exe = fluid.Executor()
        init = fluid.Scope()
        exe.run(startup, scope=init)
        short = next(c for c, b in bucketed if b == lane.BOUNDS[0])
        l12 = ragged_lstm_kernels(
            torch, rnn, init, main, [len(s) for s, _ in short], card)

        counters = kernel_counters()
        problems = []
        launches = {"lstm_seq": 0, "lstm_seq_bwd": 0}
        res = {}
        for route in ("auto", "torch"):
            for name, batches in (("flat", flat), ("bucketed", bucketed)):
                losses, ms, handles, total, steps = ragged_route(
                    torch, fluid, exe, lane, main, loss, init, batches,
                    route, counters, problems)
                for k in launches:
                    launches[k] += total.get(k, 0)
                res[route, name] = (losses, ms)
                log(f"kernel_tier={route}, {name}: {steps} steps, epoch "
                    f"mean loss {losses.mean():.6f} ({losses[0]:.6f} -> "
                    f"{losses[-1]:.6f}); best of "
                    f"{RAGGED_EPOCHS if route == 'auto' else RAGGED_TORCH_EPOCHS}"
                    " epochs "
                    f"{ms:.5f} ms a sample | {card}")
                if (route, name) == ("auto", "bucketed"):
                    read_counts, reset = counters
                    reset()

                    def epoch():
                        for h in handles:
                            exe.run_prepared(h, return_numpy=False)

                    prof = profile(torch, epoch, "one bucketed epoch of the "
                                   "ragged lane, kernel route", card, reps=1)
                    for k in launches:
                        launches[k] += read_counts()[k]
                    log("busy share of a profiled bucketed epoch: "
                        + (f"{100 * prof[1] / prof[0]:.1f}%" if prof
                           else "not measured"))
        for route in ("auto", "torch"):
            ratio = res[route, "flat"][1] / res[route, "bucketed"][1]
            log(f"kernel_tier={route}: flat {res[route, 'flat'][1]:.5f} / "
                f"bucketed {res[route, 'bucketed'][1]:.5f} ms a sample = "
                f"{ratio:.3f}x for bucketing | {card}")
        for name in ("flat", "bucketed"):
            a, b = res["auto", name][0], res["torch", name][0]
            rel = abs(a.mean() - b.mean()) / abs(b.mean())
            step = float((abs(a - b) / abs(b)).max())
            log(f"{name} epoch, kernel route vs torch route: mean loss "
                f"rel diff {rel:.3e} (limit {RAGGED_LOSS_LIMIT:.0e}), "
                f"largest step rel diff {step:.3e}")
            if not rel <= RAGGED_LOSS_LIMIT:
                problems.append(f"ragged lane, {name}: the routes' epoch "
                                f"losses differ by {rel:.3e}")

        log(f"\n== phase 23(b): the bucketed epoch fed one exe.run a batch, "
            f"from host numpy and through reader.double_buffer | {card} ==")
        db = ragged_double_buffer(torch, fluid, exe, lane, reader, main,
                                  loss, init, bucketed, counters, card,
                                  problems)
        for k in launches:
            launches[k] += db[k]
        reader_graph_mnist(torch, fluid, work, card, problems)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if problems:
        fail("; ".join(problems))
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s; lstm_seq "
        f"{launches['lstm_seq']} and lstm_seq_bwd {launches['lstm_seq_bwd']} "
        f"launches")
    return launches, l12


# phase 24: the reference's RNN benchmark config (benchmark/paddle/rnn/
# rnn.py, testing/legacy_lane.py) through paddle_trainer at bench.py:238's
# widths (lane.RNN_ARGS): 2 passes of 8 batches of 64 100-long sequences
LEGACY_PASSES = 2
# the routes' pass costs, relative: the kernel route's bf16 recurrent
# products against the torch route's float32 scans over 16 Adam steps
# (the ragged lane's epoch limit, RAGGED_LOSS_LIMIT)
LEGACY_PASS_LIMIT = LSTM_FWD_LIMIT
# step 1's gradients, per parameter. Against the same program with the
# LSTM wrappers swapped for their plain versions (the same bf16 recipe):
# phase 5's backward limits, ‖Δ‖∞/‖ref‖∞ ≤ LSTM_BWD_LIMIT and ‖Δ‖₂/‖ref‖₂
# ≤ LSTM_BWD_L2_LIMIT. Against kernel_tier=torch (the float32 scans, no
# bf16 rounding of W or h) every element carries its own bf16 rounding, so
# the moves are not rare and only the ‖Δ‖∞ limit (a few bf16 steps of the
# largest element) applies; ‖Δ‖₂ is printed (a CPU rehearsal at H 16, b 8:
# lstm W 2.3e-3 of ‖ref‖₂, ‖Δ‖∞ 3.5e-3). A bias's gradient is a sum over
# the batch and the steps (of its gates' gradients, or of an fc's output
# gradient); at initialization the net predicts nearly alike for every
# sequence, so with labels of both kinds those terms nearly cancel and the
# sum is a small remainder of large terms: its ‖Δ‖∞ is held relative to
# the largest element of Σ|terms|, the scale a sum's rounding has (an
# H100 run of this phase held the LSTM biases to their own largest
# element: 1.26e-2 against the plain versions, 1.43e-1 against the torch
# route, while every weight's stayed under 2.5e-3)
LEGACY_GRAD_LIMITS = {"kernel_tier=torch": (LSTM_BWD_LIMIT, None),
                      "the plain versions": (LSTM_BWD_LIMIT,
                                             LSTM_BWD_L2_LIMIT)}
# the 15 op types on the card against the same op on the CPU from the same
# inputs: floats within 1e-5 of the largest element (CPU_REL), integers
# exact; lrn at AlexNet's first layer (batch 64, 96 channels, 55x55)
LEGACY_LRN_SHAPE = (64, 96, 55, 55)


def legacy_cli(trainer_cli, argv):
    """paddle_trainer's main(argv) in-process: (exit code, stdout), the
    output echoed to the log."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trainer_cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log("  | " + line)
    return rc, out


def legacy_op_cases(np, rng):
    """{name: (op, inputs, outputs, attrs, feeds, grad inputs, grad
    outputs, the cotangent's output)} for the slice's 15 op types."""
    f32 = lambda *s: rng.normal(0, 1, s).astype("float32")  # noqa: E731
    return {
        "lrn": ("lrn", {"X": ["x"]}, {"Out": ["out"], "MidOut": ["mid"]},
                {"n": 5, "k": 1.0, "alpha": 1e-4 / 5, "beta": 0.75},
                {"x": f32(*LEGACY_LRN_SHAPE)}, {"X": ["x"]},
                {"X@GRAD": ["dx"]}, "Out"),
        "maxout": ("maxout", {"X": ["x"]}, {"Out": ["out"]}, {"groups": 2},
                   {"x": f32(8, 16, 12, 12)}, {"X": ["x"]},
                   {"X@GRAD": ["dx"]}, "Out"),
        "im2sequence": ("im2sequence", {"X": ["x"]}, {"Out": ["out"]},
                        {"kernels": [3, 3], "strides": [2, 2],
                         "paddings": [1, 1, 1, 1]},
                        {"x": f32(4, 8, 16, 16)}, {"X": ["x"]},
                        {"X@GRAD": ["dx"]}, "Out"),
        "rank_loss": ("rank_loss", {"Label": ["y"], "Left": ["l"],
                                    "Right": ["r"]}, {"Out": ["out"]}, {},
                      {"y": rng.randint(0, 2, (256, 1)).astype("float32"),
                       "l": f32(256, 1), "r": f32(256, 1)},
                      {"Label": ["y"], "Left": ["l"], "Right": ["r"]},
                      {"Left@GRAD": ["dl"], "Right@GRAD": ["dr"]}, "Out"),
        "nce": ("nce", {"Input": ["x"], "Label": ["y"], "Weight": ["w"],
                        "Bias": ["b"]},
                {"Cost": ["cost"], "SampleLabels": ["s"]},
                {"num_total_classes": 1000, "num_neg_samples": 5,
                 "custom_neg_classes": [3, 141, 592, 653, 999]},
                {"x": f32(64, 128), "y": rng.randint(0, 1000, (64, 1))
                 .astype("int64"), "w": f32(1000, 128), "b": f32(1000)},
                {"Input": ["x"], "Weight": ["w"], "Bias": ["b"],
                 "SampleLabels": ["s"]},
                {"Input@GRAD": ["dx"], "Weight@GRAD": ["dw"],
                 "Bias@GRAD": ["db"]}, "Cost"),
        "pad": ("pad", {"X": ["x"]}, {"Out": ["out"]},
                {"paddings": [0, 0, 1, 2, 3, 0, 0, 1], "pad_value": 0.25},
                {"x": f32(4, 8, 9, 9)}, {"X": ["x"]}, {"X@GRAD": ["dx"]},
                "Out"),
        "crop": ("crop", {"X": ["x"]}, {"Out": ["out"]},
                 {"shape": [-1, 6, 5, 5], "offsets": [0, 1, 2, 3]},
                 {"x": f32(4, 8, 9, 9)}, {"X": ["x"]}, {"X@GRAD": ["dx"]},
                 "Out"),
        "positive_negative_pair": (
            "positive_negative_pair",
            {"Score": ["s"], "Label": ["y"], "QueryID": ["q"],
             "Weight": ["w"]},
            {"PositivePair": ["pos"], "NegativePair": ["neg"],
             "NeutralPair": ["neu"]}, {"column": 0},
            {"s": np.round(rng.uniform(0, 1, (512, 1)), 2)
             .astype("float32"), "y": rng.randint(0, 3, (512, 1))
             .astype("int64"), "q": rng.randint(0, 16, (512, 1))
             .astype("int64"), "w": rng.uniform(0.5, 2, (512, 1))
             .astype("float32")}, None, None, None),
    }


def legacy_ops_on_card(torch, fluid, seed, card):
    """Each of the slice's op types once on the card against its CPU
    result, forward and grad (15 op types). Returns the problems."""
    import numpy as np

    def run(place, op, ins, outs, attrs, feeds):
        prog = fluid.Program()
        block = prog.global_block()
        for name, arr in feeds.items():
            block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
        fetch = [n for names in outs.values() for n in names]
        for n in fetch:
            block.create_var(name=n)
        block.append_op(op, inputs=ins, outputs=outs, attrs=attrs)
        vals = fluid.Executor(place).run(prog, feed=feeds, fetch_list=fetch,
                                         scope=fluid.Scope())
        return [np.asarray(v.data if hasattr(v, "lens") else v)
                for v in vals]

    def held(what, got, want):
        if got.shape != want.shape or got.dtype != want.dtype:
            return f"{what}: {got.shape}/{got.dtype} against " \
                   f"{want.shape}/{want.dtype}", None
        if not np.issubdtype(want.dtype, np.floating):
            return (None if np.array_equal(got, want)
                    else f"{what}: integers differ"), 0.0
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.astype(np.float64) - want).max()) / scale
        return (None if err <= CPU_REL else f"{what}: {err:.2e} of the "
                f"largest (limit {CPU_REL:.0e})"), err

    rng = np.random.RandomState(seed + 24)
    problems, rows, types = [], [], set()
    for name, (op, ins, outs, attrs, feeds, gins, gouts, cot) in \
            legacy_op_cases(np, rng).items():
        t0 = time.perf_counter()
        card_out = run(fluid.CUDAPlace(0), op, ins, outs, attrs, feeds)
        cpu_out = run(fluid.CPUPlace(), op, ins, outs, attrs, feeds)
        types.add(op)
        worst = 0.0
        names = [n for ns in outs.values() for n in ns]
        for n, g, w in zip(names, card_out, cpu_out):
            bad, err = held(f"{op} {n}", g, w)
            if bad:
                problems.append(bad)
            worst = max(worst, err or 0.0)
        if gins is not None:
            vals = dict(zip(names, cpu_out))
            gfeeds = {k: v for k, v in {**feeds, **vals}.items()
                      if any(k in ns for ns in gins.values())}
            d = vals[outs[cot][0]]
            if op == "im2sequence":      # the padded [b, steps, d] layout
                d = d.reshape(feeds["x"].shape[0], -1, d.shape[-1])
            gfeeds["d"] = rng.normal(0, 1, d.shape).astype("float32")
            gargs = (op + "_grad", {**gins, cot + "@GRAD": ["d"]}, gouts,
                     attrs, gfeeds)
            gnames = [n for ns in gouts.values() for n in ns]
            for n, g, w in zip(gnames, run(fluid.CUDAPlace(0), *gargs),
                               run(fluid.CPUPlace(), *gargs)):
                bad, err = held(f"{op}_grad {n}", g, w)
                if bad:
                    problems.append(bad)
                worst = max(worst, err or 0.0)
            types.add(op + "_grad")
        rows.append(f"{name} {worst:.2e} ({(time.perf_counter() - t0):.2f} "
                    "s)")
    # nce's own draw on the card: the labels, then ids in range
    x = rng.normal(0, 1, (64, 16)).astype("float32")
    y = rng.randint(0, 50, (64, 1)).astype("int64")
    cost, s = run(fluid.CUDAPlace(0), "nce",
                  {"Input": ["x"], "Label": ["y"], "Weight": ["w"]},
                  {"Cost": ["cost"], "SampleLabels": ["s"]},
                  {"num_total_classes": 50, "num_neg_samples": 7},
                  {"x": x, "y": y, "w": rng.normal(0, 1, (50, 16))
                   .astype("float32")})
    if not (s.shape == (64, 8) and (s[:, :1] == y).all()
            and 0 <= s[:, 1:].min() and s[:, 1:].max() < 50
            and np.isfinite(cost).all()):
        problems.append("nce's drawn SampleLabels on the card break their "
                        "rule")
    log(f"the slice's {len(types)} op types on the card against the CPU, "
        f"worst ‖Δ‖∞/‖ref‖∞ (limit {CPU_REL:.0e}, integers exact): "
        + "; ".join(rows) + f" | {card}")
    if len(types) != 15:
        problems.append(f"{len(types)} op types checked, not 15")
    return problems


def bias_terms(block):
    """{bias: the gradient it sums}: an elementwise_add's bias (Y) sums its
    Out@GRAD over the rows, an lstm's Bias sums its Input@GRAD (the gates'
    gradients) over the batch and the steps."""
    from paddle_tpu_torch.fluid.framework import grad_var_name
    params = {p.name for p in block.all_parameters()}
    terms = {}
    for op in block.ops:
        if op.type == "elementwise_add" and op.input("Y")[0] in params:
            terms[op.input("Y")[0]] = grad_var_name(op.output("Out")[0])
        elif op.type == "lstm":
            terms[op.input("Bias")[0]] = grad_var_name(op.input("Input")[0])
    return terms


def grads_of(torch, fluid, exe, main, cost, feed, scope):
    """(loss, {param: gradient}, {bias: Σ|terms| per element}) of one step
    of ``main`` from ``scope``: each bias's terms (``bias_terms``) summed
    in absolute value over the rows they add (the valid steps of a LoD
    gradient), the scale a sum's rounding is relative to."""
    from paddle_tpu_torch.fluid.framework import grad_var_name
    params = [p.name for p in main.all_parameters()]
    terms = bias_terms(main.global_block())
    vals = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                   fetch_list=[cost] + [grad_var_name(p) for p in params]
                   + list(terms.values()))
    sums = {}
    for b, v in zip(terms, vals[1 + len(params):]):
        data = v.data if hasattr(v, "lens") else v
        if hasattr(v, "lens"):
            steps = torch.arange(data.shape[1], device=data.device)
            data = data * (steps[None, :] < v.lens[:, None]).to(
                data.dtype)[..., None]
        sums[b] = data.abs().reshape(-1, data.shape[-1]).sum(0)
    return vals[0].item(), dict(zip(params, vals[1:len(params) + 1])), sums


def phase_legacy(torch, fluid, seed, card):
    """Phase 24: paddle_trainer's jobs over rnn.py at bench.py:238's widths
    on the card (launches, step-1 gradients against the plain routes, the
    routes' pass costs), the same topology through the paddle.v2 spelling
    (infer, the tar and the serialized topology bitwise), and the slice's
    op types against the CPU. Returns the lstm_seq / lstm_seq_bwd
    launches."""
    import numpy as np
    import paddle_tpu_torch.v2 as v2
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import rnn
    from paddle_tpu_torch.testing import legacy_lane as lane
    from paddle_tpu_torch.v2 import trainer_cli
    from paddle_tpu_torch.v2.config_helpers import parse_config
    from paddle_tpu_torch.v2.inference import build_feed

    t_phase = time.perf_counter()
    a = lane.RNN_ARGS
    log(f"\n== phase 24: paddle_trainer over benchmark/paddle/rnn/rnn.py "
        f"(vocab {a['vocab_size']}, emb {a['emb_size']}, {a['lstm_num']} "
        f"LSTMs of {a['hidden_size']}, batch {a['batch_size']}, "
        f"{lane.LENGTH}-long sequences, {LEGACY_PASSES} passes of "
        f"{lane.BATCHES} batches), the v2 spelling, the slice's op types | "
        f"{card} ==")
    lane.SEED, lane.BATCH = seed, a["batch_size"]
    work = tempfile.mkdtemp(prefix="chip-smoke-legacy-")
    problems = []
    launches = {"lstm_seq": 0, "lstm_seq_bwd": 0}
    read, reset = kernel_counters()
    try:
        cfg = os.path.join(work, "rnn.py")
        fc_cfg = os.path.join(work, "fc.py")
        with open(cfg, "w") as f:
            f.write(lane.RNN_CONFIG)
        with open(fc_cfg, "w") as f:
            f.write(lane.CLI_CONFIG)
        base = [f"--config={cfg}", "--config_args=" + ",".join(
            f"{k}={v}" for k, v in a.items()),
            "--reader=paddle_tpu_torch.testing.legacy_lane:reader"]

        def job(what, argv, fwd, bwd, route="auto"):
            """One job in-process with its launches held: ``fwd`` and
            ``bwd`` LSTM launches, no other kernel, no fallback."""
            reset()
            tier.reset_fallback_counts()
            fluid.set_flags({"kernel_tier": route})
            t0 = time.perf_counter()
            try:
                rc, out = legacy_cli(trainer_cli, base + argv)
            finally:
                fluid.set_flags({"kernel_tier": "auto"})
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got, fb = read(), tier.fallback_counts()
            want = ({"lstm_seq": fwd, "lstm_seq_bwd": bwd} if route == "auto"
                    else {})
            other = {k: v for k, v in got.items() if v and k not in want}
            log(f"{what} (kernel_tier={route}): exit {rc} in {secs:.2f} s; "
                f"lstm_seq {got['lstm_seq']}, lstm_seq_bwd "
                f"{got['lstm_seq_bwd']} launches, other kernels {other}, "
                f"fallbacks {fb}")
            if rc != 0:
                problems.append(f"{what}: exit {rc}")
            if route != "auto" and any(got.values()):
                problems.append(f"{what} (kernel_tier={route}): kernel "
                                f"launches {got}")
            if route == "auto":
                if (got["lstm_seq"], got["lstm_seq_bwd"]) != (fwd, bwd) \
                        or other or fb:
                    problems.append(
                        f"{what}: lstm_seq {got['lstm_seq']} / lstm_seq_bwd "
                        f"{got['lstm_seq_bwd']} launches (want {fwd} / "
                        f"{bwd}), other kernels {other}, fallbacks {fb}")
                for k in launches:
                    launches[k] += got[k]
            return out

        steps = LEGACY_PASSES * lane.BATCHES
        costs = {}
        for route in ("auto", "torch"):
            out = job("--job=train", ["--job=train",
                                      f"--num_passes={LEGACY_PASSES}"],
                      2 * steps, 2 * steps, route)
            costs[route] = [float(ln.split("cost=")[1])
                            for ln in out.splitlines()
                            if ln.startswith("Pass")]
        for route, c in costs.items():
            if len(c) != LEGACY_PASSES or not c[-1] < c[0]:
                problems.append(f"train, kernel_tier={route}: pass costs "
                                f"{c} do not fall")
        rel = [abs(x - y) / abs(y) for x, y in zip(costs["auto"],
                                                   costs["torch"])]
        log(f"pass costs, kernel route {costs['auto']} against torch route "
            f"{costs['torch']}: rel diff "
            + ", ".join(f"{r:.3e}" for r in rel)
            + f" (limit {LEGACY_PASS_LIMIT:.0e})")
        if not rel or max(rel) > LEGACY_PASS_LIMIT:
            problems.append(f"the routes' pass costs differ by {rel}")
        out = job("--job=time", ["--job=time"], 2 * lane.BATCHES + 2,
                  2 * lane.BATCHES + 2)
        timing = [ln for ln in out.splitlines() if ln.startswith("time:")]
        job("--job=test", ["--job=test"], 2 * lane.BATCHES, 0)
        reset()
        rc, out = legacy_cli(trainer_cli, [f"--config={fc_cfg}",
                                           "--job=checkgrad"])
        if rc != 0 or "***" in out:
            problems.append(f"checkgrad over the fc config: exit {rc}")

        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__)),
             os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.v2.trainer_cli",
             *base, "--job=train", "--num_passes=1"], env=env,
            capture_output=True, text=True, timeout=300)
        log(f"python -m paddle_tpu_torch.v2.trainer_cli --job=train: exit "
            f"{r.returncode} in {time.perf_counter() - t0:.1f} s: "
            + " | ".join(r.stdout.strip().splitlines()[-2:]))
        if r.returncode != 0:
            problems.append(f"the trainer_cli subprocess exited "
                            f"{r.returncode}: {r.stderr[-1500:]}")

        # step 1's gradients on the kernel route against kernel_tier=torch
        # and against the LSTM wrappers' plain versions
        fluid.reset_unique_name()
        topo, main, startup = parse_config(lane.RNN_CONFIG, config_args=a)
        with fluid.program_guard(main, startup):
            topo.create_optimizer().minimize(topo.cost, startup)
        exe = fluid.Executor()
        init = fluid.Scope()
        exe.run(startup, scope=init)
        feed = build_feed(main.global_block(), topo.feed_order,
                          lane.parity_batches()[0])
        reset()
        got = grads_of(torch, fluid, exe, main, topo.cost, feed,
                       copy_scope(fluid, torch, init))
        n = read()
        if (n["lstm_seq"], n["lstm_seq_bwd"]) != (2, 2):
            problems.append(f"step 1: {n['lstm_seq']} / {n['lstm_seq_bwd']} "
                            "LSTM launches, want 2 / 2")
        for k in launches:
            launches[k] += n[k]
        refs = {}
        fluid.set_flags({"kernel_tier": "torch"})
        try:
            refs["kernel_tier=torch"] = grads_of(
                torch, fluid, exe, main, topo.cost, feed,
                copy_scope(fluid, torch, init))
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
        real = rnn.lstm_seq, rnn.lstm_seq_bwd
        rnn.lstm_seq, rnn.lstm_seq_bwd = (rnn.lstm_seq_torch,
                                          rnn.lstm_seq_bwd_torch)
        try:
            refs["the plain versions"] = grads_of(
                torch, fluid, exe, main, topo.cost, feed,
                copy_scope(fluid, torch, init))
        finally:
            rnn.lstm_seq, rnn.lstm_seq_bwd = real
        for what, (ref_loss, ref, ref_sums) in refs.items():
            inf_limit, l2_limit = LEGACY_GRAD_LIMITS[what]
            dl = abs(got[0] - ref_loss) / abs(ref_loss)
            rows, over = [], []
            for p, g in got[1].items():
                d = (g.double() - ref[p].double())
                if p in ref_sums:       # a bias: against its terms' size
                    inf = (d.abs().max() / ref_sums[p].double().max()
                           .clamp_min(1e-30)).item()
                    l2 = None
                else:
                    inf = (d.abs().max() / ref[p].double().abs().max()
                           .clamp_min(1e-30)).item()
                    l2 = (d.norm() / ref[p].double().norm()
                          .clamp_min(1e-30)).item()
                own = (d.abs().max() / ref[p].double().abs().max()
                       .clamp_min(1e-30)).item()
                rows.append(f"{p} {inf:.2e}/"
                            + (f"{l2:.2e}" if l2 is not None else
                               f"(sum; of its own ‖ref‖∞ {own:.2e})"))
                if not (inf <= inf_limit and (l2_limit is None or l2 is None
                                              or l2 <= l2_limit)):
                    over.append(p)
            log(f"step 1, kernel route against {what}: loss rel diff "
                f"{dl:.3e}; gradients ‖Δ‖∞/‖ref‖∞ / ‖Δ‖₂/‖ref‖₂ (limits "
                f"{inf_limit:.0e} / "
                + ("printed" if l2_limit is None else f"{l2_limit:.0e}")
                + "; a bias's ‖Δ‖∞ over its terms' Σ|·|): "
                + ", ".join(rows))
            if over:
                problems.append(f"step 1 against {what}: {over} beyond "
                                "phase 5's limits")

        # readings: rnn.py's own defaults through the time job, checkgrad
        # over the RNN config
        lane.BATCH = 128
        reset()
        tier.reset_fallback_counts()
        legacy_cli(trainer_cli, [f"--config={cfg}",
                                 "--reader=paddle_tpu_torch.testing."
                                 "legacy_lane:reader", "--job=time"])
        log(f"reading: rnn.py's defaults (batch 128, hidden 128, 1 LSTM) "
            f"through --job=time: launches {read()}, fallbacks "
            f"{tier.fallback_counts()} (batch 128 lies outside "
            f"lstm_seq's supported())")
        lane.BATCH = a["batch_size"]
        reset()
        rc, out = legacy_cli(trainer_cli, base + ["--job=checkgrad"])
        for k in launches:
            launches[k] += read()[k]
        log(f"reading: checkgrad over rnn.py at the lane's widths exits "
            f"{rc} (the recurrent kernels' bf16 W products may move a "
            f"directional difference past 1%)")

        problems += legacy_v2(torch, fluid, v2, lane, build_feed, read,
                              reset, launches, card)
        problems += legacy_ops_on_card(torch, fluid, seed, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if problems:
        fail("; ".join(problems))
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s; "
        + "; ".join(timing) + f"; lstm_seq {launches['lstm_seq']} and "
        f"lstm_seq_bwd {launches['lstm_seq_bwd']} launches")
    return launches


def legacy_v2(torch, fluid, v2, lane, build_feed, read, reset, launches,
              card):
    """Phase 24(b): rnn.py's topology in the paddle.v2 spelling, one pass
    through v2.SGD with an event handler, then v2.infer, the
    Parameters tar and the serialized topology, each bitwise the trained
    scope's forward. Returns the problems."""
    import io
    import numpy as np

    a = lane.RNN_ARGS
    log(f"\n== phase 24(b): the same topology through paddle.v2 (layer.data"
        f" with integer_value_sequence({a['vocab_size']}), SGD with "
        f"optimizer.Adam) | {card} ==")
    problems = []
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = v2.layer.data("data", v2.data_type.integer_value_sequence(
            a["vocab_size"]))
        net = v2.layer.embedding(data, size=a["emb_size"])
        for _ in range(a["lstm_num"]):
            net = v2.networks.simple_lstm(net, size=a["hidden_size"])
        pred = v2.layer.fc(v2.layer.last_seq(net), size=2,
                           act=v2.activation.Softmax())
        label = v2.layer.data("label", v2.data_type.integer_value(2))
        cost = v2.layer.classification_cost(input=pred, label=label)
        params = v2.parameters.create(cost)
        trainer = v2.SGD(cost=cost, parameters=params,
                         update_equation=v2.optimizer.Adam(
                             learning_rate=2e-3,
                             regularization=v2.optimizer.L2Regularization(
                                 8e-4)),
                         main_program=main, startup_program=startup)
    batches = lane.parity_batches()
    seen = []

    def handler(evt):
        if isinstance(evt, v2.event.EndIteration):
            n = read()
            seen.append((evt.cost, n["lstm_seq"], n["lstm_seq_bwd"]))
            for k in launches:
                launches[k] += n[k]
            reset()

    reset()
    t0 = time.perf_counter()
    trainer.train(lambda: iter(batches), num_passes=1, event_handler=handler)
    torch.cuda.synchronize()
    log(f"v2.SGD: {len(seen)} steps in {time.perf_counter() - t0:.2f} s, "
        f"costs {seen[0][0]:.6f} -> {seen[-1][0]:.6f}, launches a step "
        f"{sorted({(f, b) for _, f, b in seen})}")
    if len(seen) != len(batches) or any((f, b) != (2, 2)
                                        for _, f, b in seen):
        problems.append(f"v2.SGD: launches a step {[s[1:] for s in seen]}")
    if not all(np.isfinite(c) for c, _, _ in seen):
        problems.append("v2.SGD: a cost is not finite")

    samples = [(ids,) for ids, _ in batches[0]]
    feed = build_feed(trainer._test_program.global_block(), ["data", "label"],
                      batches[0])
    direct = trainer._exe.run(trainer._test_program, feed=feed,
                              fetch_list=[pred.var], scope=trainer.scope)[0]
    reset()
    outs = {"v2.infer": v2.infer(output_layer=pred, parameters=params,
                                 input=samples)}
    tar, topo_buf = io.BytesIO(), io.BytesIO()
    params.to_tar(tar)
    v2.Topology(pred).serialize_for_inference(topo_buf)
    loaded = v2.parameters.Parameters.from_tar_file(
        io.BytesIO(tar.getvalue()))
    outs["Parameters.to_tar -> from_tar_file -> Inference"] = v2.Inference(
        loaded, output_layer=pred).infer(input=samples)
    outs["serialize_for_inference -> Inference(fileobj=)"] = v2.Inference(
        loaded, fileobj=io.BytesIO(topo_buf.getvalue())).infer(
        input=samples)
    n = read()
    for k in launches:
        launches[k] += n[k]
    for what, got in outs.items():
        same = got.shape == direct.shape and np.array_equal(got, direct)
        log(f"{what}: {got.shape}, bitwise the trained scope's forward: "
            f"{same}")
        if not same:
            problems.append(f"{what} differs from the trained scope's "
                            "forward")
    if n["lstm_seq"] != 2 * len(outs):
        problems.append(f"inference: {n['lstm_seq']} lstm_seq launches, "
                        f"want {2 * len(outs)}")
    return problems


# phase 25: deployment through fluid/aot.py, capi/ and --job=merge; the
# ResNet-50 artifact serves these batches
DEPLOY_BATCHES = (1, 8, 32)
# the LSTM classifier through the loader: bench.py:239's batch at its
# length, and a smaller batch at another padded length (one artifact)
DEPLOY_SEQ = ((SEQ_BATCH, SEQ_LEN), (8, 37))
MEMOPT_STEPS = 3
# seq_infer's rows against the in-process run of the same artifact: the
# same operators on the same inputs, so float32 printing (6 decimals) is
# the only difference
CAPI_ROW_LIMIT = 1e-6

# the fresh interpreter that serves phase 25's ResNet-50 artifact: it
# imports torch and paddle_tpu_torch only, serves every batch it finds in
# the work dir (saving the replies), traces one more forward of the
# largest with fluid.profiler.cuda_profiler (a process whose CUPTI has
# traced nothing before: in a long process torch.profiler was seen to
# drop a few records a call), and prints one JSON line
DEPLOY_LOADER = r"""
import json, os, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from paddle_tpu_torch.fluid import aot, profiler
from paddle_tpu_torch.ops.cuda import conv_bn as cbk
# phase 1's switches: every float32 conv and GEMM in full float32
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t1 = time.perf_counter()
art = aot.load_inference_artifact(sys.argv[1])
if art.device.startswith("cuda"):
    torch.cuda.synchronize()
t2 = time.perf_counter()
work = sys.argv[2]
res = {"import_s": t1 - t0, "load_s": t2 - t1, "launches": {},
       "modules": sorted(m for m in ("jax", "paddle_tpu")
                         if m in sys.modules)}
for name in sorted(os.listdir(work)):
    if not name.startswith("x"):
        continue
    n = int(name[1:-4])
    x = np.load(os.path.join(work, name))
    cbk.reset_launches()
    y, = art.run({"img": x})
    res["launches"][n] = cbk.launches["conv_affine"]
    np.save(os.path.join(work, f"y{n}.npy"), y)
cbk.reset_launches()
with profiler.cuda_profiler(sys.argv[3]):
    art.run({"img": x})
res["trace_launches"] = cbk.launches["conv_affine"]
print(json.dumps(res))
"""


def graph_calls(art):
    """{operator: calls} of a loaded artifact's graph: the kernels'
    operators, the plain scans and the convolutions it holds."""
    code = art._exported.graph_module.code
    names = ("paddle_tpu_torch.conv_affine", "paddle_tpu_torch.lstm_seq",
             "paddle_tpu_torch.lstm_scan", "paddle_tpu_torch.gru_seq",
             "aten.convolution", "aten.conv2d")
    return {n: code.count(n + ".default") for n in names}


def artifact_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def finish(procs, problems, timeout=300):
    """Wait for each (name, Popen) in turn: {name: stdout}; a non-zero
    exit is a problem. Kills whatever still runs on the way out."""
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                problems.append(f"{name}: exit {proc.returncode}: "
                                f"{stderr.strip()[-1500:]}")
            out[name] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def deploy_resnet_export(torch, fluid, seed, work):
    """Phase 25(a), first half: ResNet-50 built as phase 3 builds it,
    saved as a bundle and exported on the card; the loader started on it
    in a fresh interpreter. Returns (bundle, artifact dir, feeds, inputs
    dir, the loader's Popen)."""
    import numpy as np
    from paddle_tpu_torch.fluid import aot
    from paddle_tpu_torch.ops import cuda as tier

    main, startup, prob = build_resnet50(fluid, seed)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    overwrite_bn_stats(main, scope, torch, seed)
    fluid.fuse_conv_bn(main)
    bundle, art_dir = os.path.join(work, "bundle"), os.path.join(work, "rn50")
    fluid.io.save_inference_model(bundle, ["img"], [prob], exe,
                                  main_program=main, scope=scope)
    tier.reset_fallback_counts()
    t0 = time.perf_counter()
    manifest = aot.export_inference_artifact(art_dir, ["img"], [prob], exe,
                                             main_program=main, scope=scope)
    export_s = time.perf_counter() - t0
    traced = tier.fallback_counts()
    nbytes = artifact_bytes(art_dir)
    log(f"ResNet-50: export {export_s:.2f} s, {nbytes} bytes "
        f"({nbytes / 2**20:.1f} MiB), device {manifest['device']}, dims "
        f"{manifest['dims']}, plain-routed fused convs at the trace "
        f"{traced}")
    rng = np.random.RandomState(seed + 25)
    feeds = {n: rng.normal(0, 1, (n, IMAGE, IMAGE, 3)).astype("float32")
             for n in DEPLOY_BATCHES}
    inputs = os.path.join(work, "inputs")
    os.makedirs(inputs)
    for n, x in feeds.items():
        np.save(os.path.join(inputs, f"x{n}.npy"), x)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", DEPLOY_LOADER, art_dir,
                             inputs, os.path.join(work, "trace.json")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return bundle, art_dir, feeds, inputs, traced, proc


def deploy_resnet_check(torch, card, exported, fresh_out, problems,
                        launches):
    """Phase 25(a), second half: the fresh interpreter's replies against
    InferenceEngine over the same bundle, then the artifact in this
    process in turns with the engine (latency), a profile of each at batch
    32, and the graph's operators. Returns the fresh interpreter's
    record."""
    import numpy as np
    from paddle_tpu_torch.fluid import aot
    from paddle_tpu_torch.serving import InferenceEngine

    bundle, art_dir, feeds, inputs, traced, _ = exported
    if fresh_out is None:
        return None
    fresh = json.loads(fresh_out.strip().splitlines()[-1])
    log(f"fresh interpreter (torch + paddle_tpu_torch only; jax/paddle_tpu "
        f"imported: {fresh['modules'] or 'neither'}): imports "
        f"{fresh['import_s']:.2f} s, load_inference_artifact "
        f"{fresh['load_s']:.2f} s | {card}")
    if fresh["modules"]:
        problems.append(f"the loader imported {fresh['modules']}")
    launches["conv_affine"] += fresh["trace_launches"]
    engine = InferenceEngine(bundle)
    engine.warmup()
    t0 = time.perf_counter()
    art = aot.load_inference_artifact(art_dir)
    log(f"load_inference_artifact in this process: "
        f"{time.perf_counter() - t0:.2f} s")
    for n in DEPLOY_BATCHES:
        want, = engine.infer({"img": feeds[n]})
        got = np.load(os.path.join(inputs, f"y{n}.npy"))
        k = fresh["launches"][str(n)]
        launches["conv_affine"] += k
        rel = np.abs(got - want).max() / np.abs(want).max()
        same = bool((got.argmax(1) == want.argmax(1)).all())
        art.run({"img": feeds[n]})
        lat = {"artifact": [], "engine": []}
        for _ in range(LAT_REPS):
            for what, fn in (("artifact", art.run),
                             ("engine", engine.infer)):
                t0 = time.perf_counter()
                fn({"img": feeds[n]})
                lat[what].append((time.perf_counter() - t0) * 1e3)
        med = {w: sorted(v)[LAT_REPS // 2] for w, v in lat.items()}
        log(f"batch {n:2d}: artifact {med['artifact']:.2f} ms, "
            f"InferenceEngine {med['engine']:.2f} ms (medians of "
            f"{LAT_REPS}, in turns); the fresh interpreter's reply: "
            f"conv_affine launches {k}, rel err vs the engine {rel:.2e}, "
            f"argmax equal {same} | {card}")
        if got.shape != (n, CLASSES) or not np.isfinite(got).all():
            problems.append(f"artifact batch {n}: reply {got.shape}")
        if not rel <= REL_LIMIT["float32"] or not same:
            problems.append(f"artifact batch {n}: rel {rel:.3e} against "
                            f"the engine, argmax equal {same}")
        if k != KERNEL_CONVS:
            problems.append(f"artifact batch {n}: {k} conv_affine "
                            f"launches a forward, want {KERNEL_CONVS}")
    for what, fn in (("artifact", art.run), ("InferenceEngine",
                                             engine.infer)):
        profile(torch, lambda: fn({"img": feeds[32]}),
                f"{what} forward, batch 32", card,
                groups=CONV_AFFINE_LAUNCHES)
    calls = graph_calls(art)
    plain = calls["aten.convolution"] + calls["aten.conv2d"]
    log(f"the artifact's graph: {calls['paddle_tpu_torch.conv_affine']} "
        f"conv_affine calls, {plain} plain convolutions")
    if calls["paddle_tpu_torch.conv_affine"] != KERNEL_CONVS \
            or plain != PLAIN_CONVS or traced.get("conv_bn") != PLAIN_CONVS:
        problems.append(f"the artifact's graph holds {calls}, want "
                        f"{KERNEL_CONVS} conv_affine and {PLAIN_CONVS} "
                        "plain convolutions")
    return fresh


def deploy_textcls(fluid, seed, card, work, problems, launches):
    """Phase 25(b): bench.py:239's LSTM classifier exported with dynamic
    batch and length, served through the loader against the Executor on
    the pruned program. Returns (artifact dir, the in-process run of
    seq_infer's three sequences)."""
    import numpy as np
    from paddle_tpu_torch.fluid import aot
    from paddle_tpu_torch.fluid.io import _prune_program
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import rnn
    from paddle_tpu_torch.testing import models

    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        prob = models.lstm_textcls(words, vocab=SEQ_VOCAB, emb=SEQ_EMB,
                                   hidden=SEQ_HIDDEN)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    d = os.path.join(work, "textcls")
    tier.reset_fallback_counts()
    t0 = time.perf_counter()
    manifest = aot.export_inference_artifact(d, ["words"], [prob], exe,
                                             main_program=main, scope=scope)
    export_s = time.perf_counter() - t0
    traced = tier.fallback_counts()
    t0 = time.perf_counter()
    art = aot.load_inference_artifact(d)
    load_s = time.perf_counter() - t0
    calls = graph_calls(art)
    log(f"LSTM classifier: export {export_s:.2f} s, load {load_s:.2f} s, "
        f"{artifact_bytes(d)} bytes, dims {manifest['dims']}; graph "
        f"{calls['paddle_tpu_torch.lstm_seq']} lstm_seq, "
        f"{calls['paddle_tpu_torch.lstm_scan']} plain scans; fallbacks at "
        f"the trace {traced}")
    if calls["paddle_tpu_torch.lstm_seq"] != 2 or \
            calls["paddle_tpu_torch.lstm_scan"] or traced:
        problems.append(f"LSTM artifact: graph {calls}, fallbacks {traced}")
    infer = _prune_program(main, ["words"], [prob.name])
    rng = np.random.RandomState(seed + 26)
    for b, length in DEPLOY_SEQ:
        lens = rng.randint(1, length + 1, b)
        lens[0] = length
        seqs = [rng.randint(0, SEQ_VOCAB, (int(n), 1)).astype("int64")
                for n in lens]
        want = exe.run(infer, feed={"words": seqs}, fetch_list=[prob.name],
                       scope=scope)[0]
        rnn.reset_launches()
        got, = art.run({"words": seqs})
        n = rnn.launches["lstm_seq"]
        launches["lstm_seq"] += n
        rel = np.abs(got - want).max() / np.abs(want).max()
        log(f"batch {b}, padded length {length}: lstm_seq launches {n}, "
            f"rel err vs the Executor {rel:.2e} | {card}")
        if n != 2 or got.shape != (b, 2) or not rel <= LSTM_FWD_LIMIT:
            problems.append(f"LSTM artifact batch {b} length {length}: "
                            f"{n} launches, {got.shape}, rel {rel:.3e}")
    try:
        art.run({"words": [np.ones((3, 1), "int64")] * (rnn.MAX_BATCH + 1)})
        problems.append("LSTM artifact served a batch over the kernel's "
                        "range")
    except ValueError as e:
        log(f"batch {rnn.MAX_BATCH + 1} refused: {str(e)[:80]}...")
    seqs = [np.array(s, "int64").reshape(-1, 1)
            for s in ([1, 2, 3, 4], [5, 6], [7, 8, 9])]
    return d, art.run({"words": seqs})[0]


def deploy_capi_start(fluid, work, seq_dir, problems):
    """Phase 25(c), first half: the three C examples built with gcc into
    build/capi, the book's digits MLP exported, and the three binaries
    started (each starts an embedded interpreter and its own CUDA
    context). Returns their Popens."""
    from paddle_tpu_torch.fluid import aot
    from paddle_tpu_torch.testing import models

    repo = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(repo, "build", "capi")
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-s", "-C",
                        os.path.join(repo, "paddle_tpu_torch", "capi"),
                        f"BUILD={out}"], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        problems.append(f"the C examples did not build: {r.stderr[-2000:]}")
        return {}
    log(f"built dense_infer, seq_infer, multi_thread_infer with gcc in "
        f"{time.perf_counter() - t0:.2f} s")
    fluid.reset_unique_name()
    main, startup, v = models.digits_mlp(fluid)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    digits = os.path.join(work, "digits")
    aot.export_inference_artifact(digits, ["img"], [v["predict"]], exe,
                                  main_program=main, scope=scope)
    env = dict(os.environ, PYTHONPATH=repo)
    return {b: subprocess.Popen([os.path.join(out, b), *argv], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
            for b, argv in (("seq_infer", [seq_dir]),
                            ("dense_infer", [digits, "784"]),
                            ("multi_thread_infer", [digits, "784"]))}


def deploy_capi_check(texts, seq_rows, problems):
    """Phase 25(c), second half: seq_infer's rows against the in-process
    run, dense_infer's row sum, multi_thread_infer's 4 threads."""
    import numpy as np

    for b, text in texts.items():
        log(f"{b}:")
        for line in text.splitlines():
            log("  | " + line)
    rows = [ln for ln in texts.get("seq_infer", "").splitlines()
            if ln.startswith("seq ")]
    got = np.array([[float(x) for x in ln.split(":")[1].split("(")[0]
                     .split()] for ln in rows])
    err = np.abs(got - seq_rows).max() if got.shape == seq_rows.shape \
        else float("inf")
    log(f"seq_infer: {len(rows)} rows, max |C - in-process| {err:.2e} "
        f"(limit {CAPI_ROW_LIMIT})")
    if len(rows) != 3 or not err <= CAPI_ROW_LIMIT:
        problems.append(f"seq_infer: rows {got.tolist()} against "
                        f"{seq_rows.tolist()}")
    text = texts.get("dense_infer", "")
    sums = [float(ln.split()[1]) for ln in text.splitlines()
            if ln.startswith("sum:")]
    if not sums or abs(sums[0] - 1) > 1e-4 or "DENSE_INFER_OK" not in text:
        problems.append(f"dense_infer: sums {sums}")
    text = texts.get("multi_thread_infer", "")
    if text.count("ok=1") != 4 or "MULTI_THREAD_INFER_OK" not in text:
        problems.append("multi_thread_infer: not 4 threads ok=1")


def deploy_merge(seed, work, problems, launches):
    """Phase 25(d): paddle_trainer --job=merge over phase 24's rnn.py
    config on the card; the artifact loads and launches lstm_seq twice a
    forward."""
    import numpy as np
    from paddle_tpu_torch.fluid import aot
    from paddle_tpu_torch.ops.cuda import rnn
    from paddle_tpu_torch.testing import legacy_lane as lane
    from paddle_tpu_torch.v2 import trainer_cli

    a = lane.RNN_ARGS
    cfg, d = os.path.join(work, "rnn.py"), os.path.join(work, "merged")
    with open(cfg, "w") as f:
        f.write(lane.RNN_CONFIG)
    t0 = time.perf_counter()
    rc, _ = legacy_cli(trainer_cli, [
        f"--config={cfg}", "--config_args=" + ",".join(
            f"{k}={v}" for k, v in a.items()), "--job=merge",
        f"--model_dir={d}"])
    log(f"--job=merge: exit {rc} in {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        problems.append(f"--job=merge: exit {rc}")
        return
    art = aot.load_inference_artifact(d)
    batch = lane.parity_batches(seed, 1)[0]
    feed = {"data": [ids for ids, _ in batch],
            "label": np.array([[lab] for _, (lab,) in batch], "int64")}
    rnn.reset_launches()
    cost, = art.run(feed)
    n = rnn.launches["lstm_seq"]
    launches["lstm_seq"] += n
    log(f"merged artifact (device {art.device}, feeds {art.feed_names}): "
        f"cost {float(np.asarray(cost).reshape(-1)[0]):.6f}, lstm_seq "
        f"launches {n}")
    if n != 2 or not np.isfinite(cost).all():
        problems.append(f"merged artifact: {n} lstm_seq launches, cost "
                        f"{cost}")


def deploy_memopt(torch, fluid, seed, card, problems, launches):
    """Phase 25(e): memory_optimize + release_memory on phase 4's ResNet-50
    training program at batch 32: MEMOPT_STEPS steps with and without the
    passes from one state, under cudnn.deterministic."""
    import numpy as np

    read, reset = kernel_counters()
    rng = np.random.RandomState(seed + 27)
    feed = {"img": rng.normal(0, 1, (TRAIN_BATCH, IMAGE, IMAGE, 3))
            .astype("float32"),
            "label": rng.randint(0, CLASSES, (TRAIN_BATCH, 1))
            .astype("int64")}
    exe = fluid.Executor()
    init = None
    runs = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for passes in (False, True):
            main, startup, loss = build_resnet50_train(fluid, seed)
            note = ""
            if passes:
                n_ops = len(main.global_block().ops)
                renames = fluid.memory_optimize(main, fetch_list=[loss])
                deletes = fluid.release_memory(main, fetch_list=[loss])
                note = (f": {renames} renames, {deletes} delete_var ops "
                        f"({n_ops} -> {len(main.global_block().ops)} ops)")
            if init is None:
                init = fluid.Scope()
                exe.run(startup, scope=init)
            scope = copy_scope(fluid, torch, init)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            losses = [exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope)[0] for _ in range(MEMOPT_STEPS)]
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            got = {k: v for k, v in read().items() if v}
            runs[passes] = (losses, got)
            for k in ("conv_bn_train", "conv_bn_bwd", "momentum_arena"):
                launches[k] += got.get(k, 0)
            log(f"{'with' if passes else 'without'} the passes{note}: "
                f"losses {[float(x) for x in losses]}, peak "
                f"max_memory_allocated {peak:.3f} GiB, launches {got} | "
                f"{card}")
            del scope, main
    finally:
        torch.backends.cudnn.deterministic = det
    (l0, k0), (l1, k1) = runs[False], runs[True]
    if not all(np.array_equal(a, b) for a, b in zip(l0, l1)):
        problems.append("memory_optimize: the losses are not bitwise equal")
    if k0 != k1 or k0.get("conv_bn_train") != KERNEL_CONVS * MEMOPT_STEPS:
        problems.append(f"memory_optimize: launches {k1} against {k0}")


def deploy_trace(work, card, fresh, problems):
    """Phase 25(f): the chrome trace fluid.profiler.cuda_profiler wrote
    around one artifact forward in the fresh interpreter names
    conv_affine's kernel KERNEL_CONVS times, one a launch."""
    path = os.path.join(work, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    n = sum("conv_affine_kernel" in e.get("name", "") for e in kernels)
    log(f"cuda_profiler (the fresh interpreter): {len(events)} events, "
        f"{len(kernels)} device kernels, conv_affine_kernel {n} times for "
        f"{fresh['trace_launches']} launches, {os.path.getsize(path)} "
        f"bytes of chrome JSON | {card}")
    if n != KERNEL_CONVS or fresh["trace_launches"] != KERNEL_CONVS:
        problems.append(f"cuda_profiler: conv_affine_kernel {n} times in "
                        f"the trace for {fresh['trace_launches']} launches, "
                        f"want {KERNEL_CONVS}")


def phase_deploy(torch, fluid, seed, card):
    """Phase 25: deployment (fluid/aot.py, capi/, --job=merge, the memory
    passes, fluid.profiler). The fresh interpreter and the C examples run
    while this process exports and serves the LSTM classifier and runs the
    merge job; the latencies are taken after they end. Returns the
    kernels' launches on its paths."""
    t_phase = time.perf_counter()
    log(f"\n== phase 25: deploy — ResNet-50 and the LSTM classifier served "
        f"from torch.export artifacts, the C API, --job=merge, the memory "
        f"passes, cuda_profiler | {card} ==")
    launches = {"conv_affine": 0, "lstm_seq": 0, "conv_bn_train": 0,
                "conv_bn_bwd": 0, "momentum_arena": 0}
    problems = []
    work = tempfile.mkdtemp(prefix="chip-smoke-deploy-")
    procs = {}
    try:
        exported = deploy_resnet_export(torch, fluid, seed, work)
        procs["the fresh interpreter"] = exported[-1]
        t0 = time.perf_counter()
        seq_dir, seq_rows = deploy_textcls(fluid, seed, card, work,
                                           problems, launches)
        procs.update(deploy_capi_start(fluid, work, seq_dir, problems))
        deploy_merge(seed, work, problems, launches)
        texts = finish(procs, problems)
        log(f"the fresh interpreter and the C examples done "
            f"{time.perf_counter() - t0:.2f} s after the first started")
        deploy_capi_check({k: v for k, v in texts.items()
                           if k != "the fresh interpreter"}, seq_rows,
                          problems)
        fresh = deploy_resnet_check(torch, card, exported,
                                    texts.get("the fresh interpreter"),
                                    problems, launches)
        if fresh is not None:
            deploy_trace(work, card, fresh, problems)
        deploy_memopt(torch, fluid, seed, card, problems, launches)
    finally:
        finish(procs, [])
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{launches}")
    if problems:
        fail("phase 25: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# phase 26: detection — MobileNet-SSD trained and served
# ---------------------------------------------------------------------------

# PaddlePaddle/models fluid/object_detection/mobilenet_ssd.py at its
# published width: 300x300x3, 21 classes, 2278 priors
SSD = dict(scale=1.0, image=300)
SSD_PRIORS = 19 * 19 * 4 + (10 * 10 + 5 * 5 + 3 * 3 + 2 * 2 + 1) * 6
SSD_BATCH = 32
SSD_STEPS = 5
SSD_SERVE_BATCHES = (1, 8)
SSD_SERVE_REPS = 5
# step 1 on the card against the CPU, TF32 off: the loss within 1e-4
# relative, each gradient (L2, relative to the CPU's) within SSD_HEAD_REL
# for the 24 head ones (the loc/conf filters and biases) and SSD_BACK_REL
# for the 105 of the backbone, whose median within SSD_BACK_MEDIAN; the
# float64 build of the program on both, each gradient within SSD_F64_REL.
# The backbone's limits are wide because the float32 forwards part by ~1e-4
# at the deep layers, so a few relu inputs near 0 take the other side and
# pass or stop a whole element's gradient (read on the H100: median
# 2.97e-2, worst 1.20e-1; the float64 build, whose forwards agree to 1e-9,
# 4.3e-12 at worst: PERF.md)
SSD_LOSS_REL = 1e-4
SSD_HEAD_REL, SSD_F64_REL = 2e-3, 1e-9
SSD_BACK_REL, SSD_BACK_MEDIAN = 0.3, 0.06
# the longest suppression chain multiclass_nms can meet at the served
# shape: in each (image, class) the top SSD_NMS_K boxes a staircase
SSD_NMS_K = 400


def ssd_step_one(torch, fluid, exe, main, init, feed, fetch, first, seed,
                 card, problems):
    """Phase 26(a)'s step-1 check: the same program on the CPU from the
    same state and feed, and its float64 build on the card and the CPU."""
    import numpy as np
    from paddle_tpu_torch.testing import models as M

    state = {n: v.cpu().numpy()
             for n, v in scope_tensors(torch, init).items()}
    wide = {n: v.astype(np.float64) if v.dtype == np.float32 else v
            for n, v in state.items()}
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch,
        scope=fluid.io.scope_from_numpy(state, "cpu"), return_numpy=False)
    fluid.reset_unique_name()
    main64 = M.mobilenet_ssd(fluid, **SSD, seed=seed, dtype="float64")[0]
    feed64 = dict(feed, img=feed["img"].astype(np.float64),
                  gt_box=[b.astype(np.float64) for b in feed["gt_box"]])
    card64 = exe.run(main64, feed=feed64, fetch_list=fetch,
                     scope=fluid.io.scope_from_numpy(wide, exe.device),
                     return_numpy=False)
    cpu64 = fluid.Executor(fluid.CPUPlace()).run(
        main64, feed=feed64, fetch_list=fetch,
        scope=fluid.io.scope_from_numpy(wide, "cpu"), return_numpy=False)
    loss_card, loss_cpu = float(first[0]), float(cpu[0])
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    rel64 = abs(float(card64[0]) - float(cpu64[0])) / abs(float(cpu64[0]))
    ops = main.global_block().ops
    params = {p.name for p in main.global_block().all_parameters()}
    biased = {op.input("X")[0]: op.input("Y")[0] for op in ops
              if op.type == "elementwise_add" and op.input("Y")[0] in params}
    head = {n + "@GRAD" for op in ops if op.type == "conv2d"
            and op.output("Output")[0] in biased
            for n in (op.input("Filter")[0], biased[op.output("Output")[0]])}

    def dist(got, want):
        return {n: float((g.double().cpu() - w.double().cpu()).norm()
                         / max(float(w.double().norm()), 1e-300))
                for n, g, w in zip(fetch[1:], got[1:], want[1:])}

    d32, d64 = dist(first, cpu), dist(card64, cpu64)
    groups = (("head", [n for n in d32 if n in head], d32, SSD_HEAD_REL,
               None),
              ("backbone", [n for n in d32 if n not in head], d32,
               SSD_BACK_REL, SSD_BACK_MEDIAN),
              ("float64", list(d64), d64, SSD_F64_REL, None))
    parts = []
    for what, names, d, limit, median_limit in groups:
        top = sorted(names, key=d.get, reverse=True)
        median = d[top[len(top) // 2]]
        parts.append(f"{what}: {len(names)}, median {median:.2e}, worst "
                     + ", ".join(f"{n[:-len('@GRAD')]} {d[n]:.2e}"
                                 for n in top[:3])
                     + f" (limit {limit:.0e})")
        bad = [n for n in top if d[n] > limit]
        if bad:
            problems.append(f"step-1 {what} gradients from the CPU's beyond "
                            f"{limit:.0e}: {bad[:5]} ({len(bad)})")
        if median_limit is not None and median > median_limit:
            problems.append(f"step-1 {what} gradients' median distance "
                            f"from the CPU's {median:.2e}")
    log(f"step 1: loss on the card {loss_card:.7f}, on the CPU "
        f"{loss_cpu:.7f} (relative {rel:.2e}, limit {SSD_LOSS_REL:.0e}); "
        f"float64 {float(card64[0]):.12f} / {float(cpu64[0]):.12f}; "
        f"gradients from the CPU's (L2 relative) " + "; ".join(parts)
        + f" | {card}")
    if rel > SSD_LOSS_REL or rel64 > SSD_F64_REL:
        problems.append(f"step-1 loss on the card {loss_card} against the "
                        f"CPU's {loss_cpu} (relative {rel:.2e}; float64 "
                        f"{rel64:.2e})")
    if len(head) != 24:
        problems.append(f"{len(head)} head gradients, want 24")


def calibrate_bn(fluid, exe, test, imgs, scope):
    """Set the running statistics of every batch norm of ``test`` in
    ``scope`` to the batch statistics of one training-mode pass over
    ``imgs`` (the test program with is_test off and momentum 0): after a
    handful of steps the running averages still hold most of their
    startup values, which the trained weights no longer match."""
    calib = test.clone()
    for op in calib.global_block().ops:
        if op.type == "batch_norm":
            op.attrs["is_test"] = False
            op.attrs["momentum"] = 0.0
    exe.run(calib, feed={"img": imgs}, fetch_list=[], scope=scope)


def ssd_serve(torch, fluid, exe, test, nmsed, scope, feed, work, card,
              problems):
    """Phase 26(b)-(c): the test program served by InferenceEngine at
    SSD_SERVE_BATCHES (buckets of those sizes, so nothing is padded),
    each reply bitwise the Executor's; ms a batch and multiclass_nms's
    share; DetectionMAP over the largest batch's replies."""
    import numpy as np
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.serving import InferenceEngine

    fluid.io.save_inference_model(work, ["img"], [nmsed], exe,
                                  main_program=test, scope=scope)
    eng = InferenceEngine(work, buckets=list(SSD_SERVE_BATCHES))
    nms = registry.get_op_info("multiclass_nms")
    forward = nms.forward
    nms_ms, iters = [], []

    def timed_nms(ctx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(ctx)
        torch.cuda.synchronize()
        nms_ms.append((time.perf_counter() - t0) * 1e3)

    reply = None
    for b in SSD_SERVE_BATCHES:
        imgs = feed["img"][:b]
        reply = eng.infer({"img": imgs})[0]
        want = exe.run(test, feed={"img": imgs}, fetch_list=[nmsed],
                       scope=scope)[0]
        same = np.array_equal(reply.data, want.data) and \
            np.array_equal(reply.lens, want.lens)
        ms = median_ms(lambda: eng.infer({"img": imgs}), SSD_SERVE_REPS)
        nms_ms.clear()
        nms.forward = timed_nms
        try:
            with counted_nms(iters):
                for _ in range(SSD_SERVE_REPS):
                    eng.infer({"img": imgs})
        finally:
            nms.forward = forward
        share = sorted(nms_ms)[len(nms_ms) // 2] / ms
        finite = bool(np.isfinite(reply.data).all())
        log(f"served batch {b}: {ms:.3f} ms a batch (median of "
            f"{SSD_SERVE_REPS}), multiclass_nms {100 * share:.1f}% of it "
            f"({sorted(nms_ms)[len(nms_ms) // 2]:.3f} ms, synchronized "
            f"around the op; fixed-point iterations {iters[-SSD_SERVE_REPS:]}"
            f"); detections per image "
            f"{reply.lens.tolist()}, rows {tuple(reply.data.shape)}, equal "
            f"to the Executor's {same}, finite {finite} | {card}")
        if not same:
            problems.append(f"served batch {b} differs from the Executor")
        if not finite or reply.data.shape != (b, 200, 6) \
                or int(reply.lens.min()) <= 0:
            problems.append(f"served batch {b}: rows "
                            f"{tuple(reply.data.shape)}, counts "
                            f"{reply.lens.tolist()}, finite {finite}")
    b = SSD_SERVE_BATCHES[-1]
    ev = fluid.evaluator.DetectionMAP(overlap_threshold=0.5)
    ev.update(reply, [[(int(l[0]),) + tuple(float(x) for x in box)
                       for l, box in zip(labels, boxes)]
                      for labels, boxes in zip(feed["gt_label"][:b],
                                               feed["gt_box"][:b])])
    m_ap = ev.eval()
    log(f"DetectionMAP over the {b} served images' detections: mAP "
        f"{m_ap:.4f} (random weights, 5 steps: no accuracy is claimed)")
    if not 0.0 <= m_ap <= 1.0:
        problems.append(f"DetectionMAP gave {m_ap}")


@contextlib.contextmanager
def counted_nms(iters):
    """Append the fixed-point iterations of each multiclass_nms call to
    ``iters`` while the block runs."""
    from paddle_tpu_torch.ops import detection_ops as D
    keep = D.nms_keep

    def counted(*args):
        out = keep(*args)
        iters.append(out[1])
        return out
    D.nms_keep = counted
    try:
        yield
    finally:
        D.nms_keep = keep


def ssd_nms_chain(torch, fluid, exe, card, problems):
    """Phase 26(b)'s worst case for multiclass_nms at the batch-8 serving
    shape: in every (image, class) the top SSD_NMS_K boxes form a
    staircase along x, each at IoU 0.5 with the next and 0.2 with the one
    after, the rest score below them. The greedy walk keeps every other
    box of each chain; the fixed point takes SSD_NMS_K iterations."""
    import numpy as np
    from paddle_tpu_torch.testing import models as M

    b, c, p, k = SSD_SERVE_BATCHES[-1], M.SSD_CLASSES, SSD_PRIORS, SSD_NMS_K
    step = 0.002
    rng = np.random.RandomState(26)
    boxes = np.tile(np.array([0.0, 0.6, 0.05, 0.7], np.float32), (b, p, 1))
    boxes[:, :, 0] += rng.rand(b, p).astype(np.float32) * 0.9
    boxes[:, :, 2] += boxes[:, :, 0]
    boxes[:, :k] = np.stack([np.arange(k) * step, np.zeros(k),
                             np.arange(k) * step + 3 * step,
                             np.full(k, 0.5)], 1)
    scores = rng.rand(b, c, p).astype(np.float32) * 0.3
    scores[:, :, :k] = np.linspace(0.9, 0.5, k, dtype=np.float32)
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        bb = fluid.layers.data("bb", shape=[p, 4], dtype="float32")
        sc = fluid.layers.data("sc", shape=[c, p], dtype="float32")
        out = fluid.layers.multiclass_nms(bb, sc, score_threshold=0.01,
                                          nms_top_k=k, keep_top_k=-1,
                                          nms_threshold=0.45)
    feed = {"bb": boxes, "sc": scores}
    iters = []
    with counted_nms(iters):
        got = exe.run(prog, feed=feed, fetch_list=[out])[0]
        ms = median_ms(lambda: exe.run(prog, feed=feed, fetch_list=[out]),
                       SSD_SERVE_REPS)
    rows = np.asarray(got.data)
    idx = np.rint(rows[..., 2] / step).astype(np.int64)
    want = (c - 1) * k // 2
    chain = all(int(n) == want and np.all(idx[i, :n] % 2 == 0)
                and np.all(rows[i, :n, 3] == 0)
                for i, n in enumerate(np.asarray(got.lens)))
    log(f"multiclass_nms on the longest suppression chain (batch {b}, "
        f"{c - 1} classes, {p} boxes, top {k} a staircase): {ms:.3f} ms "
        f"(median of {SSD_SERVE_REPS}, fed from the host), fixed-point "
        f"iterations {iters}, every other chain box kept {chain} | {card}")
    if not chain or iters[0] != k:
        problems.append(f"the NMS chain: {np.asarray(got.lens).tolist()} "
                        f"kept, want {want} an image of even chain boxes; "
                        f"iterations {iters}, want {k}")


def phase_detection(torch, fluid, seed, card):
    """Phase 26: MobileNet-SSD trained at batch 32 and served
    (module docstring). Returns the kernels' launches on its path."""
    import numpy as np
    from paddle_tpu_torch.testing import models as M

    t_phase = time.perf_counter()
    log(f"\n== phase 26: detection — MobileNet-SSD at {SSD['image']}x"
        f"{SSD['image']}x3, {M.SSD_CLASSES} classes, trained at batch "
        f"{SSD_BATCH} and served | {card} ==")
    read, reset = kernel_counters()
    problems = []
    work = tempfile.mkdtemp(prefix="chip-smoke-ssd-")
    fluid.reset_unique_name()
    main, startup, test, v = M.mobilenet_ssd(fluid, **SSD, seed=seed)
    priors = int(v["locs"].shape[1])
    block = main.global_block()
    grads = [p.name + "@GRAD" for p in block.all_parameters()
             if p.trainable and block.has_var(p.name + "@GRAD")]
    log(f"program: {len(block.ops)} ops, {len(grads)} trainable "
        f"parameters, {priors} priors")
    if priors != SSD_PRIORS:
        problems.append(f"{priors} priors, want {SSD_PRIORS}")
    feed = M.ssd_feed(SSD_BATCH, SSD["image"], seed + 26)
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    scope = copy_scope(fluid, torch, init)
    fetch = [v["loss"].name] + grads
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        first = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
        losses, step_ms = [float(first[0])], []
        for _ in range(SSD_STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[v["loss"]],
                                        scope=scope)[0]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = {k: n for k, n in read().items() if n}
        launches = {"momentum_arena": got.get("momentum_arena", 0)}
        log(f"{SSD_STEPS} steps: losses {losses}; "
            f"{sorted(step_ms)[len(step_ms) // 2]:.3f} ms a step (median "
            f"of {len(step_ms)}, the feed staged from the "
            f"host in each), peak max_memory_allocated {peak:.3f} GiB, "
            f"launches {got} | {card}")
        if not all(np.isfinite(losses)):
            problems.append(f"losses {losses}")
        if got != {"momentum_arena": SSD_STEPS}:
            problems.append(f"launches {got}, want momentum_arena "
                            f"{SSD_STEPS} (one a step)")
        ssd_step_one(torch, fluid, exe, main, init, feed, fetch, first,
                     seed, card, problems)
        prof = profile(torch, lambda: exe.run(main, feed=feed,
                                              fetch_list=[v["loss"]],
                                              scope=scope),
                       "MobileNet-SSD training step at batch 32", card,
                       reps=2)
        if prof is not None:
            log(f"training step busy share {100 * prof[1] / prof[0]:.1f}% "
                f"| {card}")
        calibrate_bn(fluid, exe, test, feed["img"], scope)
        ssd_serve(torch, fluid, exe, test, v["nmsed"], scope, feed, work,
                  card, problems)
        ssd_nms_chain(torch, fluid, exe, card, problems)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 26: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{launches}")
    if problems:
        fail("phase 26: " + "; ".join(problems))
    return launches


# phase 27: the serving fleet and the perf plane (A15) with conv_bn's tile
# and bf16 variants (B.1). ResNet-50's phase-3 bundle is published to a
# ModelRegistry (v1 with its warm executables and a tuning table measured
# on its own conv_bn keys; v2 a copy whose fc bias is shifted; v3 a corrupt
# copy) and served by FLEET_REPLICAS spawned replicas on the card, routed by
# FleetClient, at the buckets of FLEET_BUCKETS: a batch-1 and a batch-8
# request FLEET_REQUESTS times each
FLEET_BUCKETS = (1, 8)
FLEET_REPLICAS = 2
FLEET_REQUESTS = 3
FLEET_READY_S = 300.0
FLEET_V2_SHIFT = 0.5
# the tuner's windows (ops/autotune.py measure): interleaved best of
# TUNE_REPEATS windows of TUNE_INNER calls, CUDA events after a sync
TUNE_REPEATS, TUNE_INNER = 3, 2
# (batch, is_test) of the conv_bn keys the tuner times: serving at 1 and 8,
# training at 32
TUNE_KEYS = ((1, True), (8, True), (TRAIN_BATCH, False))
# pallas_bf16 against float32's default kernel on the same inputs: the AMP
# phase's bfloat16 limit, REL_LIMIT["bfloat16"] of the largest element.
# tests/test_amp.py's elementwise AMP_RTOL/AMP_ATOL is printed beside it as
# a reading: a bf16 z of magnitude ~8 rounds by up to 2^-5, so where the
# affine cancels it near 0 (a relu's edge) a few elements in 10^5 move by
# ~0.02 > AMP_ATOL (an NVIDIA H100 80GB HBM3 at 700.00 W, --seed 0)
# pallas_bf16 against its plain twin (the same bf16 x and w, products exact
# in float32, summed in another order): z rounds to bf16 the same way but
# where the float32 sums' difference moves it across a rounding boundary,
# so few elements differ, each by a step or two at its magnitude. Held:
# max|Δ| within BF16_TWIN_STEPS bf16 steps (2^-7 of the binade) of the
# largest |twin|, and at most BF16_TWIN_SHARE of the elements differing.
# (The earlier max|Δ|/max|twin| read 4.4e-4 to 6.7e-3, max|Δ| one step of
# the largest element, on the same card at --seed 0.) The check's own
# test, made on every shape: the float32 kernel's y rounded to bf16 (a
# path that skips the cast of x and w) must break it
BF16_TWIN_STEPS, BF16_TWIN_SHARE = 2, 1e-2
# ResNet-50's multiply-adds a 224x224 image: ~4.1 G (He et al. 2016,
# Table 1: 3.8 G for the convs as they count them); FlopCounterMode
# counts two operations a multiply-add
RESNET50_GMACS = 4.1
# the LM lane's KV prompts: phase 13's shared system prompt of GEN_SYSTEM
# tokens (2 blocks) with a GEN_SUFFIX-token user suffix, GEN_PREFIX_NEW
# new tokens greedy, for FLEET_KV_REQUESTS users
FLEET_KV_REQUESTS = 4


def fleet_feed(np, seed, n):
    rng = np.random.RandomState(seed + 27 + n)
    return {"img": rng.normal(0, 1, (n, IMAGE, IMAGE, 3)).astype("float32")}


def first_replies(sup, t0, feed, deadline_s=FLEET_READY_S):
    """Seconds from ``t0`` to each replica's first answered request, sent
    to it directly (the router aside); None where none came in time."""
    from paddle_tpu_torch.serving import InferClient
    out = [None] * len(sup.addresses)
    deadline = t0 + deadline_s
    while None in out and time.monotonic() < deadline:
        for i, addr in enumerate(sup.addresses):
            if out[i] is not None:
                continue
            try:
                with InferClient(addr, timeout=60.0, retry=None) as c:
                    c.infer(feed)
                out[i] = time.monotonic() - t0
            except Exception:
                pass
        time.sleep(0.2)
    return out


def variant_keys(fluid, cbk, at, main):
    """The conv_bn keys ResNet-50 dispatches at each TUNE_KEYS batch, with
    the variants each supports, as ops/fused_ops.py builds them:
    [(kernel, key, supported names)], and {(batch, is_test): {conv_key:
    kernel-routed convs of that shape a forward}}."""
    captured, by_batch = [], {}
    for batch, is_test in TUNE_KEYS:
        shapes = fused_conv_shapes(fluid, main, batch)
        for key in sorted(shapes, key=lambda k: (-k[0][1], k[1][1],
                                                 k[1][0], k[2])):
            x, w, strides, paddings, dilations, groups, act = key
            sup = cbk.supported(x, w, strides, paddings, dilations, groups,
                                "NHWC", "float32")
            names = ["jnp"]
            if sup:
                names.append("pallas")
                by_batch.setdefault((batch, is_test), {})[key] = shapes[key]
                if cbk.db_supported(x, w, strides, paddings, "float32"):
                    names.append("pallas_db")
            if cbk.supported(x, w, strides, paddings, dilations, groups,
                             "NHWC", "bfloat16"):
                names.append("pallas_bf16")
            captured.append(("conv_bn", at.make_key(
                x=x, w=w, dtype="float32", strides=tuple(strides),
                paddings=tuple(paddings), dilations=tuple(dilations),
                groups=groups, df="NHWC", act=act, is_test=is_test),
                tuple(sorted(names))))
    return captured, by_batch


def variant_checks(torch, cbk, by_batch, seed, card):
    """B.1's variants against their plain twins and the default variant on
    ResNet-50's shapes: conv_affine at 1 and 8, conv_bn_train (and
    conv_bn_bwd from its statistics) at TRAIN_BATCH. The 128-row tile
    bitwise the default (output, statistics, gradients) and within
    REL_LIMIT of its twin; bf16 within BF16_TWIN_STEPS/BF16_TWIN_SHARE of
    its twin (and float32's y rounded to bf16 outside them) and within
    REL_LIMIT["bfloat16"] of float32's default kernel (the AMP phase's
    limit; elements outside tests/test_amp.py's AMP_RTOL/AMP_ATOL printed
    as a reading).
    Then the times per forward (step) over the shapes each variant takes,
    with their
    plain, cuDNN and bound. These launches compare; they are not the
    main path's."""
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 27)

    def operands(x_shape, w_shape):
        cout, cin, kh, kw = w_shape
        return (torch.randn(x_shape, generator=gen, device=dev),
                torch.randn(w_shape, generator=gen, device=dev)
                * (2.0 / (cin * kh * kw)) ** 0.5,
                torch.rand(cout, generator=gen, device=dev) + 0.5,
                torch.randn(cout, generator=gen, device=dev) * 0.1)

    def rel(y, ref):
        y, ref = y.float(), ref.float()
        d = (y - ref).abs().max().item()
        return d / max(ref.abs().max().item(), 1e-30), d

    def amp_ok(y, ref):
        return rel(y, ref)[0] <= REL_LIMIT["bfloat16"]

    def bf16_steps(y, ref):
        """(max|y − ref| in bf16 steps at the largest |ref|, the share of
        elements that differ)."""
        y, ref = y.float(), ref.float()
        top = ref.abs().max().item()
        step = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 1.0
        return ((y - ref).abs().max().item() / step,
                (y != ref).float().mean().item())

    def twin_ok(steps, share):
        return steps <= BF16_TWIN_STEPS and share <= BF16_TWIN_SHARE

    def amp_outside(y, ref):
        """Elements outside tests/test_amp.py's rtol/atol (a reading)."""
        y, ref = y.float(), ref.float()
        return int(((y - ref).abs() > AMP_ATOL + AMP_RTOL * ref.abs())
                   .sum().item())

    def same(a, b):
        return bool(torch.equal(a, b))

    keys = ("ms", "default_ms", "plain_ms", "library_ms", "bound_ms",
            "gemm", "elem", "bytes")
    sums = {}
    # (variant, batch): [max steps, max share differing against the twin,
    # and the float32-rounded path's least share and steps]
    bf16_read = {}

    def add(name, batch, count, vals):
        t = sums.setdefault((name, batch), {k: 0.0 for k in keys}
                            | {"max_abs_err": 0.0, "shapes": 0,
                               "convs": 0, "dtype": vals["dtype"]})
        for k in keys:
            t[k] += count * vals[k]
        t["max_abs_err"] = max(t["max_abs_err"], vals["err"])
        t["shapes"] += 1
        t["convs"] += count

    for (batch, is_test), counts in sorted(by_batch.items()):
        kind = "conv_affine" if is_test else "conv_bn_train"
        log(f"\n  {kind} variants at batch {batch}: x w s act xN (convs "
            "of the shape a forward) | db: "
            "bitwise, rel vs twin, ms (default ms) | bf16: rel, bf16 "
            "steps of the largest and share differing vs twin (float32's "
            "y rounded: steps, share), within the AMP limit of float32 "
            "(elements outside "
            "test_amp's rtol/atol), ms | plain, cuDNN ms (float32, bf16)")
        for key, count in counts.items():
            x_shape, w_shape, strides, paddings, _, _, act = key
            x, w, a, b = operands(x_shape, w_shape)
            xb = x.to(torch.bfloat16)
            db = cbk.db_supported(x_shape, w_shape, strides, paddings,
                                  "float32")
            xn, xbn = x.permute(0, 3, 1, 2), xb.permute(0, 3, 1, 2)
            if is_test:
                def run(xx, tile=0):
                    return cbk.conv_affine(xx, w, a, b, strides, paddings,
                                           act, tile)

                def plain(xx):
                    return cbk.conv_affine_torch(xx, w, a, b, strides,
                                                 paddings, act)

                def library(xx):
                    wf = (w * a.view(-1, 1, 1, 1)).to(xx.dtype)
                    y = F.conv2d(xx, wf, b.to(xx.dtype), stride=strides,
                                 padding=paddings)
                    return torch.relu(y) if act == "relu" else y
                work = conv_work
            else:
                def run(xx, tile=0):
                    return cbk.conv_bn_train(xx, w, a, b, EPS, strides,
                                             paddings, act, tile)

                def plain(xx):
                    return cbk.conv_bn_train_torch(xx, w, a, b, EPS,
                                                   strides, paddings, act)
                rm, rv = torch.zeros_like(a), torch.ones_like(a)

                def library(xx):
                    y = F.batch_norm(F.conv2d(xx, w.to(xx.dtype),
                                              stride=strides,
                                              padding=paddings),
                                     rm, rv, a.to(xx.dtype),
                                     b.to(xx.dtype), training=True, eps=EPS)
                    return F.relu(y) if act == "relu" else y

                def work(x_, w_, s_, p_, item):
                    return bn_work(x_, w_, s_, p_, item, backward=False)
            first = lambda y: y[0] if isinstance(y, tuple) else y  # noqa
            y0 = run(x)
            line = f"  {list(x_shape)} {list(w_shape)} {strides[0]} " \
                f"{act or '-':4} x{count} |"
            d_ms = time_ms(lambda: run(x), torch, target_ms=10.0)
            p32 = time_ms(lambda: plain(x), torch, target_ms=10.0)
            l32 = time_ms(lambda: library(xn), torch, target_ms=10.0)
            if db:
                y1 = run(x, cbk.DB_TILE)
                if is_test:
                    bit = same(y1, y0)
                else:
                    bit = all(same(p, q) for p, q in zip(y1, y0))
                    dy = torch.randn(y0[0].shape, generator=gen,
                                     device=dev)
                    g0 = cbk.conv_bn_bwd(x, w, dy, a, b, y0[1], y0[2], EPS,
                                         strides, paddings, act)
                    g1 = cbk.conv_bn_bwd(x, w, dy, a, b, y1[1], y1[2], EPS,
                                         strides, paddings, act)
                    bit = bit and all(same(p, q) for p, q in zip(g1, g0))
                r, d = rel(first(y1), first(plain(x)))
                if not bit:
                    fail(f"{kind} pallas_db x{x_shape} w{w_shape}: output, "
                         "statistics or gradients not bitwise the default "
                         "tile's")
                if not r <= REL_LIMIT["float32"]:
                    fail(f"{kind} pallas_db x{x_shape} w{w_shape}: rel err "
                         f"{r:.3e} vs its plain twin > "
                         f"{REL_LIMIT['float32']:.0e}")
                k_ms = time_ms(lambda: run(x, cbk.DB_TILE), torch,
                               target_ms=10.0)
                gemm, elem, nbytes = work(x_shape, w_shape, strides,
                                          paddings, 4)
                bound = bn_bound_ms(gemm, elem, nbytes)[0]
                add(f"{kind}_db", batch, count, dict(
                    ms=k_ms, default_ms=d_ms, plain_ms=p32, library_ms=l32,
                    bound_ms=bound, gemm=gemm, elem=elem, bytes=nbytes,
                    err=d, dtype="float32"))
                line += f" {bit} {r:.1e} {k_ms:.4f} ({d_ms:.4f}) |"
            else:
                line += f" - (default {d_ms:.4f}) |"
            yb = run(xb)
            twin = first(plain(xb))
            rb, db_abs = rel(first(yb), twin)
            steps, share = bf16_steps(first(yb), twin)
            skip = bf16_steps(first(y0).to(torch.bfloat16), twin)
            amp = amp_ok(first(yb), first(y0))
            if not is_test:
                amp = amp and amp_ok(yb[1], y0[1]) and amp_ok(yb[2], y0[2])
            outside = amp_outside(first(yb), first(y0))
            if not twin_ok(steps, share) or not amp:
                fail(f"{kind} pallas_bf16 x{x_shape} w{w_shape}: vs its "
                     f"twin {steps:.2f} bf16 steps of the largest, "
                     f"{share:.2e} of the elements differ (limits "
                     f"{BF16_TWIN_STEPS}, {BF16_TWIN_SHARE:.0e}); within "
                     f"{REL_LIMIT['bfloat16']:.0e} of float32's largest "
                     f"(output and statistics): {amp}")
            if twin_ok(*skip):
                fail(f"{kind} pallas_bf16 x{x_shape} w{w_shape}: float32's "
                     f"y rounded to bf16 reads {skip[0]:.2f} steps, "
                     f"{skip[1]:.2e} differing against the bf16 twin, "
                     "within the limits: they cannot tell a path that "
                     "skips the cast")
            rd = bf16_read.setdefault((f"{kind}_bf16", batch),
                                      [0.0, 0.0, 1.0, 1e30])
            rd[:] = [max(rd[0], steps), max(rd[1], share),
                     min(rd[2], skip[1]), min(rd[3], skip[0])]
            kb_ms = time_ms(lambda: run(xb), torch, target_ms=10.0)
            pb_ms = time_ms(lambda: plain(xb), torch, target_ms=10.0)
            lb_ms = time_ms(lambda: library(xbn), torch, target_ms=10.0)
            gemm, elem, nbytes = work(x_shape, w_shape, strides, paddings, 2)
            bound = bn_bound_ms(gemm, elem, nbytes, "bfloat16")[0]
            add(f"{kind}_bf16", batch, count, dict(
                ms=kb_ms, default_ms=d_ms, plain_ms=pb_ms, library_ms=lb_ms,
                bound_ms=bound, gemm=gemm, elem=elem, bytes=nbytes,
                err=db_abs, dtype="bfloat16"))
            log(line + f" {rb:.1e} {steps:.2f} {share:.1e} (cast "
                f"skipped: {skip[0]:.2f} {skip[1]:.1e}) {amp} "
                f"({outside} of {first(yb).numel()}"
                f" outside rtol {AMP_RTOL}/atol {AMP_ATOL}) {kb_ms:.4f} | "
                f"{p32:.4f} {l32:.4f} {pb_ms:.4f} {lb_ms:.4f}")
    for (name, batch), (st, sh, skip_sh, skip_st) in sorted(
            bf16_read.items()):
        log(f"  {name} at batch {batch} against its twin: at most "
            f"{st:.2f} bf16 steps of the largest, {sh:.2e} of the elements "
            f"differing (limits {BF16_TWIN_STEPS}, {BF16_TWIN_SHARE:.0e}); "
            f"float32's y rounded to bf16: at least {skip_sh:.2e} "
            f"differing, {skip_st:.2f} steps | {card}")
    for (name, batch), t in sorted(sums.items()):
        t["bound_ms"], t["bound_by"], _ = bn_bound_ms(
            t["gemm"], t["elem"], t["bytes"], t["dtype"])
        log(f"  {name} at batch {batch}: {t['shapes']} shapes "
            f"({t['convs']} convs a forward), "
            f"{t['ms']:.3f} ms per {'forward' if 'affine' in name else 'step'}"
            f" (the default kernel {t['default_ms']:.3f}), plain "
            f"{t['plain_ms']:.3f}, cuDNN {t['library_ms']:.3f}, bound "
            f"{t['bound_ms']:.3f} ({t['bound_by']}), max abs err vs twin "
            f"{t['max_abs_err']:.3e} | {card}")
    return sums


def variant_tables(at, keys):
    """Two routing tables over the conv_bn dispatches ``keys`` (a
    ``capture()``): every key that offers pallas_db routed to it, and every
    key that offers pallas_bf16 routed to it."""
    db, bf = at.TuneTable(), at.TuneTable()
    for kernel, key, names in keys:
        if kernel == "conv_bn" and "pallas_db" in names:
            db.set(kernel, key, "pallas_db")
        if kernel == "conv_bn" and "pallas_bf16" in names:
            bf.set(kernel, key, "pallas_bf16")
    return db, bf


def offering(keys, variant, batch=None):
    """The conv_bn dispatches in ``keys`` that offer ``variant`` (at x's
    ``batch``, where given)."""
    return sum(1 for kernel, key, names in keys
               if kernel == "conv_bn" and variant in names
               and (batch is None or dict(key)["x"][0] == batch))


@contextlib.contextmanager
def routed_by(fluid, at, table, bf16=False):
    """Route by ``table``, attached process-wide (an engine without a
    table of its own follows it), with the bf16 opt-in as given; None
    routes statically."""
    if table is None:
        yield
        return
    at.attach_table(table, merge=False)
    fluid.set_flags({"kernel_autotune_bf16": bf16})
    try:
        yield
    finally:
        at.detach_table()
        fluid.set_flags({"kernel_autotune_bf16": False})


def phase_fleet(torch, fluid, seed, card, serving, gen):
    """Phase 27 (see FLEET_*, TUNE_*): publish, tune and warm ResNet-50 in
    a ModelRegistry; first replies of a spawned replica with the warm cache
    off, on a fill and on a hit; FLEET_REPLICAS replicas through
    FleetClient bitwise the in-process engine, a rolling reload, a failed
    canary's rollback and a FaultPlan kill and rejoin; B.1's variants on
    the main path (ResNet-50 served at FLEET_BUCKETS and trained a step at
    TRAIN_BATCH under a table of pallas_db, bitwise the default, and of
    pallas_bf16, each bf16 launch replayed through its plain version);
    the LM lane published with its KV prompts and decoded after a
    spill-hit attach; obs.perf.attribute of ResNet-50 at batch 1. Before
    the main path's counts start, the tuner times ResNet-50's conv_bn keys
    at TUNE_KEYS; after they are read, B.1's variants are held against
    their twins and timed. Returns {kernel: launches on the main path} and
    the variants' sums."""
    import numpy as np
    from paddle_tpu_torch.distributed import FaultPlan
    from paddle_tpu_torch.obs import perf
    from paddle_tpu_torch.ops import autotune as at
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    from paddle_tpu_torch.serving import (CanaryFailed, FleetClient,
                                          FleetSupervisor, GenClient,
                                          GenerationEngine, InferenceEngine,
                                          ModelRegistry, ModelServer)

    log(f"\n== phase 27: fleet — ResNet-50 through a ModelRegistry and "
        f"{FLEET_REPLICAS} spawned replicas, the tuner's conv_bn variants, "
        f"the LM lane's KV spill tier | {card} ==")
    t_phase = time.perf_counter()
    missing = [n for n in KERNELS if not build.library_path(n).exists()]
    if missing:
        fail(f"phase 27 spawns replicas that must find every kernel built "
             f"in the parent; missing {missing}")
    log(f"every kernel library built once in the parent (phase 1): "
        f"{len(KERNELS)} under {build.BUILD_DIR}")
    work = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    buckets = ",".join(str(b) for b in FLEET_BUCKETS)
    v1_dir = serving["dir"]
    v2_dir = os.path.join(work, "v2")
    shutil.copytree(v1_dir, v2_dir)
    bias = [n for n in os.listdir(v2_dir)
            if n.startswith("fc_") and n.endswith(".w_1.npy")]
    if len(bias) != 1:
        fail(f"the ResNet-50 bundle holds fc biases {bias}, want one")
    arr = np.load(os.path.join(v2_dir, bias[0]))
    np.save(os.path.join(v2_dir, bias[0]), arr + np.float32(FLEET_V2_SHIFT))
    v3_dir = os.path.join(work, "v3")
    shutil.copytree(v1_dir, v3_dir)
    with open(os.path.join(v3_dir, "__model__"), "w") as f:
        f.write("not a model")
    feeds = {n: fleet_feed(np, seed, n) for n in FLEET_BUCKETS}

    # ---- set-up: v1 published with its tuning table (the tuner's
    # launches time variants, off the main path's counts) ----
    perf.COMPILE_LOG.clear()
    reg = ModelRegistry(os.path.join(work, "registry"))
    t0 = time.perf_counter()
    v1 = reg.publish("resnet50", v1_dir, warm_cache=True,
                     tune={"repeats": TUNE_REPEATS, "inner": TUNE_INNER},
                     warm_kwargs={"buckets": buckets})
    publish_s = time.perf_counter() - t0
    m1 = reg.manifest("resnet50", v1)
    table = at.resolve_store(reg.resolve("resnet50", v1)[0]).load()
    if table is None or not m1.get("warm_files") or not m1.get("tune_files"):
        fail(f"v1 published without its sidecars: warm {m1.get('warm_files')}"
             f", tune {m1.get('tune_files')}")
    chosen = {}
    for (kernel, _ks), e in table.entries.items():
        chosen[e["variant"]] = chosen.get(e["variant"], 0) + 1
    log(f"published v{v1} in {publish_s:.2f} s (tune + warm of buckets "
        f"{buckets}): {len(m1['warm_files'])} warm executables, "
        f"{len(table.entries)} tuned conv_bn keys, winners {chosen}; "
        f"manifest kernel_tier {m1['kernel_tier']}; compile log "
        f"{json.dumps(perf.COMPILE_LOG.stats()['by_site'])}")
    reg.verify("resnet50", v1)
    v2 = reg.publish("resnet50", v2_dir)
    v3 = reg.publish("resnet50", v3_dir)
    path1, _ = reg.resolve("resnet50", v1)
    path2, _ = reg.resolve("resnet50", v2)

    # ---- the tuner over ResNet-50's conv_bn keys (B.1) ----
    main_t, startup_t, loss_t = build_resnet50_train(fluid, seed)
    captured, by_batch = variant_keys(fluid, cbk, at, main_t)
    fluid.set_flags({"kernel_autotune_bf16": True})
    try:
        t1 = time.perf_counter()
        tuned = at.Tuner(repeats=TUNE_REPEATS, inner=TUNE_INNER).tune(
            captured)
        tune_s = time.perf_counter() - t1
    finally:
        fluid.set_flags({"kernel_autotune_bf16": False})
    log(f"\n  the tuner over {len(tuned.entries)} conv_bn keys at "
        f"(batch, is_test) {list(TUNE_KEYS)} in {tune_s:.2f} s (bf16 "
        "opted in); key: winner, ms by variant")
    wins = {}
    for (kernel, ks), e in sorted(tuned.entries.items()):
        k = dict(json.loads(ks))
        wins[e["variant"]] = wins.get(e["variant"], 0) + 1
        log(f"  x{k['x']} w{k['w']} s{k['strides'][0]} test={k['is_test']}"
            f": {e['variant']} " + " ".join(
                f"{v}={ms:.4f}" for v, ms in sorted(e["timings_ms"].items())))
    log(f"  winners {wins} | {card}")
    plain = [k for k, key, names in captured
             if "pallas" in names and tuned.lookup(k, key) == "jnp"]
    if plain:
        fail(f"the tuner chose the plain chain for {len(plain)} keys the "
             "kernel runs")

    # ---- the main path: counts from 0 ----
    cbk.reset_launches()
    opk.reset_launches()
    pak.reset_launches()
    tier.reset_fallback_counts()
    eng1 = InferenceEngine(path1, buckets=buckets, exec_cache=False)
    with at.capture() as served_keys:
        eng1.warmup()
    want1 = {n: eng1.infer(feeds[n])[0] for n in FLEET_BUCKETS}
    # v1's table holds every key served, and names the plain chain only
    # where the kernel cannot run
    bad = [(dict(key)["x"], dict(key)["w"], table.lookup(kernel, key))
           for kernel, key, names in served_keys if kernel == "conv_bn"
           and (table.lookup(kernel, key) is None
                or ("pallas" in names
                    and table.lookup(kernel, key) == "jnp"))]
    if bad:
        fail(f"v1's tuning table on the served keys: {bad[:3]} "
             f"({len(bad)} keys missing or routed to the plain chain)")
    eng2 = InferenceEngine(path2, buckets=buckets, exec_cache=False)
    eng2.warmup()
    want2 = {n: eng2.infer(feeds[n])[0] for n in FLEET_BUCKETS}
    if eng1.stats()["tune_digest"] != table.digest():
        fail("the in-process engine did not attach v1's tuning table")
    if any(np.array_equal(want1[n], want2[n]) for n in FLEET_BUCKETS):
        fail("v2 replies as v1 does: the shifted bias did not reach it")

    # ---- first replies: cache off and a fill, started together (as the
    # hit's replicas are; a supervisor takes the flags when it is built
    # and spawns its replica there), then a hit ----
    firsts = {}
    t0 = time.monotonic()
    fluid.set_flags({"serving_exec_cache": False})
    try:
        off = FleetSupervisor(reg, "resnet50", version=v1, n_replicas=1,
                              buckets=buckets)
    finally:
        fluid.set_flags({"serving_exec_cache": True})
    fluid.set_flags({"serving_exec_cache_dir": os.path.join(work, "local")})
    try:
        fill = FleetSupervisor(reg, "resnet50", version=v2, n_replicas=1,
                               buckets=buckets)
    except BaseException:
        off.stop()
        raise
    finally:
        fluid.set_flags({"serving_exec_cache_dir": ""})
    with off, fill:
        both = first_replies(types.SimpleNamespace(
            addresses=off.addresses + fill.addresses), t0, feeds[1])
        firsts["off"], firsts["fill"] = both[:1], both[1:]
        st = off.replica_stats()[0]
        if st is None or st["engine"]["exec_cache"] is not None:
            fail(f"cache-off replica: stats {st and st['engine']}")
        st = fill.replica_stats()[0]
        ec = st and st["engine"]["exec_cache"]
        if not ec or ec["saves"] != len(FLEET_BUCKETS):
            fail(f"fill replica: exec cache {ec}")

    # ---- the fleet: warm replicas, the router, reload, canary, kill ----
    problems = []
    t0 = time.monotonic()
    with FleetSupervisor(reg, "resnet50", version=v1,
                         n_replicas=FLEET_REPLICAS, buckets=buckets,
                         fault_plans={1: FaultPlan().die("stats", 2)}) \
            as sup:
        firsts["hit"] = first_replies(sup, t0, feeds[1])
        log(f"first reply of a spawned replica (spawn, torch import, "
            f"bundle load, warmup, bind, one batch-1 request), s: cache off "
            f"{firsts['off']} and fill {firsts['fill']} (started together), "
            f"hit {firsts['hit']} ({FLEET_REPLICAS} replicas started "
            f"together) | {card}")
        if None in firsts["off"] + firsts["fill"] + firsts["hit"]:
            fail(f"a replica never answered: {firsts}")
        with FleetClient(sup.addresses, probe_interval_ms=100) as fc:
            lat = {}
            for n in FLEET_BUCKETS:
                for _ in range(FLEET_REQUESTS):
                    t1 = time.perf_counter()
                    got = fc.infer(feeds[n])[0]
                    lat.setdefault(n, []).append(
                        (time.perf_counter() - t1) * 1e3)
                    if not np.array_equal(got, want1[n]):
                        fail(f"fleet reply at batch {n} differs from the "
                             f"in-process engine's (max "
                             f"{np.abs(got - want1[n]).max():.3e})")
            stats = sup.replica_stats()                  # stats call 0
            replica_launches = {}
            for i, st in stats.items():
                e = st and st["engine"]
                kl = e and e["kernel_launches"]
                n = kl and kl["conv_affine"] + kl["conv_affine_db"]
                replica_launches[i] = kl
                # every dispatch of a replica is one forward at its bucket
                if not n or n != KERNEL_CONVS * e["dispatches"] \
                        or e["warm_loaded"] != len(FLEET_BUCKETS) \
                        or e["tune_digest"] != table.digest():
                    fail(f"replica {i}: conv_affine launches {kl} in "
                         f"{e and e['dispatches']} forwards (want "
                         f"{KERNEL_CONVS} a forward), warm loaded "
                         f"{e and e['warm_loaded']}, tune digest "
                         f"{e and e['tune_digest']}")
            log(f"fleet replies at batches {list(FLEET_BUCKETS)} bitwise the "
                f"in-process engine's; client latency ms "
                f"{ {n: [round(v, 2) for v in lat[n]] for n in lat} }; "
                f"kernel launches in the replicas {replica_launches}")
            errs, stop = [], threading.Event()

            def hammer():
                while not stop.is_set():
                    try:
                        y = fc.infer(feeds[1])[0]
                        if not (np.array_equal(y, want1[1])
                                or np.array_equal(y, want2[1])):
                            errs.append("a reply of neither version")
                    except Exception as e:
                        errs.append(f"{type(e).__name__}: {e}")
            th = threading.Thread(target=hammer)
            th.start()
            t1 = time.perf_counter()
            try:
                sup.rolling_reload(v2, wait_timeout=FLEET_READY_S)
            finally:
                stop.set()
                th.join()
            reload_s = time.perf_counter() - t1
            if errs:
                fail(f"requests failed during the rolling reload: {errs[:3]}")
            for n in FLEET_BUCKETS:
                if not np.array_equal(fc.infer(feeds[n])[0], want2[n]):
                    fail(f"after the reload the batch-{n} reply is not v2's")
            versions = {i: st and st["version"]
                        for i, st in sup.replica_stats().items()}  # call 1
            if set(versions.values()) != {v2}:
                fail(f"replica versions after the reload: {versions}")
            try:
                sup.rolling_reload(v3, wait_timeout=FLEET_READY_S)
                fail("the corrupt v3's canary passed")
            except CanaryFailed as e:
                if e.rolled_back_to != v2 or sup.version != v2:
                    fail(f"canary rollback to {e.rolled_back_to}, fleet on "
                         f"{sup.version}")
            log(f"rolling reload v{v1} -> v{v2} in {reload_s:.2f} s under "
                f"traffic, no request failed; the corrupt v{v3}'s canary "
                f"failed and rolled back to v{v2}")
            t1 = time.monotonic()
            sup.replica_stats()                          # call 2: dies
            deadline = t1 + FLEET_READY_S
            while time.monotonic() < deadline and not (
                    sup.restarts[1] >= 1 and sup.ready_count() == 2):
                time.sleep(0.2)
            rejoin_s = time.monotonic() - t1
            h = sup.replica_health(1)
            if sup.restarts != [0, 1] or h is None or h["version"] != v2:
                fail(f"FaultPlan kill of replica 1: restarts {sup.restarts},"
                     f" health {h}")
            for n in FLEET_BUCKETS:
                if not np.array_equal(fc.infer(feeds[n])[0], want2[n]):
                    fail(f"after the rejoin the batch-{n} reply is not v2's")
            log(f"replica 1 killed by its FaultPlan (3rd stats call) and "
                f"back on v{v2} in {rejoin_s:.2f} s; fleet stats "
                f"{json.dumps(fc.fleet_stats(include_server_stats=False))}")

    # ---- B.1's variants on the main path: served and trained under a
    # table that routes every key offering the variant to it ----
    eng_v = InferenceEngine(v1_dir, buckets=buckets, exec_cache=False)
    eng_v.warmup()
    s_db, s_bf = variant_tables(at, served_keys)
    c0 = cbk.launches["conv_affine_db"]
    with routed_by(fluid, at, s_db):
        got = {n: eng_v.infer(feeds[n])[0] for n in FLEET_BUCKETS}
    n_db = cbk.launches["conv_affine_db"] - c0
    if not n_db or n_db != offering(served_keys, "pallas_db") or any(
            not np.array_equal(got[n], want1[n]) for n in FLEET_BUCKETS):
        fail(f"served under the pallas_db table: {n_db} conv_affine_db "
             f"launches, want {offering(served_keys, 'pallas_db')}; replies "
             f"bitwise v1's: "
             f"{[np.array_equal(got[n], want1[n]) for n in FLEET_BUCKETS]}")
    found = {}
    c0 = cbk.launches_by_dtype["conv_affine"].get("bfloat16", 0)
    with routed_by(fluid, at, s_bf, True), \
            replayed_through_plain(cbk, found, ("conv_affine",)):
        yb = eng_v.infer(feeds[8])[0]
    n_bf = cbk.launches_by_dtype["conv_affine"].get("bfloat16", 0) - c0
    rec = found.get("conv_affine", dict(calls=0, dtypes=set(), rel=0.0,
                                        at=None))
    rows = np.abs(yb.sum(1) - 1).max() if yb.ndim == 2 else np.inf
    vs32 = np.abs(yb - want1[8]).max() / np.abs(want1[8]).max()
    log(f"B.1 served: ResNet-50 at batches {list(FLEET_BUCKETS)} under a "
        f"table of pallas_db: {n_db} conv_affine_db launches, replies "
        f"bitwise v1's; at batch 8 under a table of pallas_bf16: {n_bf} "
        f"bf16 conv_affine launches, each on the program's own inputs "
        f"within {rec['rel']:.3e} of its plain version (limit "
        f"{REL_LIMIT['bfloat16']:.0e}), rows sum to 1 within {rows:.1e}, "
        f"max|Δ|/max|ref| {vs32:.3e} from the float32 reply (a reading)")
    if n_bf != KERNEL_CONVS \
            or n_bf != offering(served_keys, "pallas_bf16", 8) \
            or rec["calls"] != KERNEL_CONVS \
            or rec["dtypes"] != {"bfloat16"} \
            or not rec["rel"] <= REL_LIMIT["bfloat16"] \
            or yb.shape != want1[8].shape or not np.isfinite(yb).all() \
            or not rows <= 1e-4:
        fail(f"served under the pallas_bf16 table: {n_bf} bf16 launches, "
             f"replayed {rec['calls']} on {rec['dtypes']} worst "
             f"{rec['rel']:.3e} at {rec['at']}, reply {yb.shape} rows "
             f"{rows:.1e}")
    exe_t = fluid.Executor()
    init = fluid.Scope()
    exe_t.run(startup_t, scope=init)
    rng = np.random.RandomState(seed)              # phase 4's feed
    tfeed = {"img": rng.normal(0, 1, (TRAIN_BATCH, IMAGE, IMAGE, 3))
             .astype("float32"),
             "label": rng.randint(0, CLASSES, (TRAIN_BATCH, 1))
             .astype("int64")}
    tblock = main_t.global_block()
    update, = [op for op in tblock.ops if op.type == "fused_momentum"]
    gnames = list(update.input("Grads"))
    pnames = [p.name for p in tblock.all_parameters()]

    def train_step(table=None, bf16=False):
        """One step from the same initial scope: the loss and gradients,
        then every parameter and running statistic after it."""
        scope = copy_scope(fluid, torch, init)
        with routed_by(fluid, at, table, bf16):
            vals = exe_t.run(main_t, feed=tfeed,
                             fetch_list=[loss_t] + gnames, scope=scope,
                             return_numpy=False)
        return list(vals) + [scope.find_var(n) for n in pnames]

    # the default step twice and the pallas_db step, with cuDNN's
    # deterministic algorithms for the plain convs: the db step must equal
    # the default step on every tensor that the default step reproduces
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with at.capture() as train_keys:
            base = train_step()
        again = train_step()
        t_db, t_bf = variant_tables(at, train_keys)
        c0 = cbk.launches["conv_bn_train_db"]
        dbs = train_step(t_db)
        n_tdb = cbk.launches["conv_bn_train_db"] - c0
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    repro = [torch.equal(a, b) for a, b in zip(base, again)]
    same = repro[0] and all(torch.equal(a, b)
                            for a, b, r in zip(base, dbs, repro) if r)
    unrepro = [n for n, r in zip(["loss"] + gnames + pnames, repro)
               if not r]
    log(f"B.1 trained: the default step at batch {TRAIN_BATCH} reproduces "
        f"{sum(repro)} of its {len(repro)} tensors (loss, gradients, "
        f"parameters after the step) bitwise under cudnn.deterministic; "
        f"not: {unrepro[:6]}")
    found = {}
    c0 = cbk.launches_by_dtype["conv_bn_train"].get("bfloat16", 0)
    with replayed_through_plain(cbk, found, ("conv_bn_train",)):
        bfs = train_step(t_bf, True)
    n_tbf = cbk.launches_by_dtype["conv_bn_train"].get("bfloat16", 0) - c0
    rec = found.get("conv_bn_train", dict(calls=0, dtypes=set(), rel=0.0,
                                          at=None))
    loss0, lossb = base[0].item(), bfs[0].item()
    finite = all(torch.isfinite(t).all().item() for t in bfs)
    log(f"B.1 trained: a ResNet-50 step at batch {TRAIN_BATCH} under a "
        f"table of pallas_db: {n_tdb} conv_bn_train_db launches, bitwise "
        f"the default step on every tensor it reproduces: {same}; under a "
        f"table of pallas_bf16: {n_tbf} bf16 conv_bn_train "
        f"launches, each on the program's own inputs within "
        f"{rec['rel']:.3e} of its plain version, loss {lossb:.6f} against "
        f"{loss0:.6f}, all finite: {finite}")
    if not n_tdb or n_tdb != offering(train_keys, "pallas_db") or not same:
        fail(f"trained under the pallas_db table: {n_tdb} conv_bn_train_db "
             f"launches (want {offering(train_keys, 'pallas_db')}), bitwise "
             f"the default step: {same}")
    if n_tbf != KERNEL_CONVS \
            or n_tbf != offering(train_keys, "pallas_bf16") \
            or rec["calls"] != KERNEL_CONVS \
            or rec["dtypes"] != {"bfloat16"} \
            or not rec["rel"] <= REL_LIMIT["bfloat16"] or not finite \
            or not abs(lossb - loss0) <= REL_LIMIT["bfloat16"] * abs(loss0):
        fail(f"trained under the pallas_bf16 table: {n_tbf} bf16 launches, "
             f"replayed {rec['calls']} on {rec['dtypes']} worst "
             f"{rec['rel']:.3e} at {rec['at']}, loss {lossb} against "
             f"{loss0}, finite {finite}")
    del base, again, dbs, bfs, init

    # ---- the LM lane: KV prompts published, a spill-hit attach ----
    system = list(range(1, GEN_SYSTEM + 1))
    prompts = [system + [20 + j, 21 + j, 22 + j, 23 + j][:GEN_SUFFIX]
               for j in range(FLEET_KV_REQUESTS)]
    gopts = dict(max_seqs=GEN_MAX_SEQS, block_size=GEN_BLOCK,
                 num_blocks=GEN_BLOCKS, max_len=GEN_MAX_LEN,
                 prefill_buckets=(8, 32), prefix_cache_blocks=16)
    lv = reg.publish("lm", gen["dir"], model_kind="generative",
                     kv_prompts=[prompts[0]],
                     warm_kwargs={"gen_opts": gopts})
    lpath, _ = reg.resolve("lm", lv)
    kv_files = reg.manifest("lm", lv).get("kv_files", {})
    if len(kv_files) != GEN_SYSTEM // GEN_BLOCK:
        fail(f"the LM's published kv/ holds {len(kv_files)} chain blocks, "
             f"want {GEN_SYSTEM // GEN_BLOCK}")
    hot = GenerationEngine(gen["dir"], kv_store=False, **gopts)
    hot.warmup()
    gen_drain(hot, prompts[0], GEN_PREFIX_NEW)
    hot_toks = [gen_drain(hot, p, GEN_PREFIX_NEW) for p in prompts]
    server = ModelServer(lpath, model_kind="generative", gen_opts=gopts)
    server.start()
    try:
        eng = server.engine

        def prefills():
            return sum(s["dispatches"] for s in
                       eng.stats()["phases"]["prefill"].values())
        before, pa0 = prefills(), pak.launches["paged_attention"]
        with GenClient(server.address) as gc:
            spill_toks = [list(gc.generate(p, GEN_PREFIX_NEW))
                          for p in prompts]
        st = eng.stats()
    finally:
        server.shutdown()
    kv = st["kv_store"]
    pa_spill = pak.launches["paged_attention"] - pa0
    if spill_toks != hot_toks or prefills() != before or \
            kv["restores"] != GEN_SYSTEM // GEN_BLOCK or \
            sum(kv["rejects"].values()) or not pa_spill:
        fail(f"LM spill-hit attach: tokens equal the hot attach's "
             f"{spill_toks == hot_toks}, prefill dispatches "
             f"{prefills() - before}, restores {kv['restores']}, rejects "
             f"{kv['rejects']}, paged_attention launches {pa_spill}")
    log(f"LM lane v{lv} published with {len(kv_files)} KV chain blocks; a "
        f"generative replica decoded {FLEET_KV_REQUESTS} prompts after a "
        f"spill-hit attach: 0 prefill dispatches, {kv['restores']} blocks "
        f"restored, {pa_spill} paged_attention launches, tokens bitwise the "
        f"hot attach's")

    def in_replicas(name):
        return sum((kl or {}).get(name, 0)
                   for kl in replica_launches.values())
    launches = {
        "conv_affine": cbk.launches["conv_affine"]
        + in_replicas("conv_affine"),
        "conv_affine_db": cbk.launches["conv_affine_db"]
        + in_replicas("conv_affine_db"),
        "conv_affine_bf16": cbk.launches_by_dtype["conv_affine"].get(
            "bfloat16", 0),
        "conv_bn_train": cbk.launches["conv_bn_train"],
        "conv_bn_train_db": cbk.launches["conv_bn_train_db"],
        "conv_bn_train_bf16": cbk.launches_by_dtype["conv_bn_train"].get(
            "bfloat16", 0),
        "conv_bn_bwd": cbk.launches["conv_bn_bwd"],
        "momentum_arena": opk.launches["momentum_arena"],
        "paged_attention": pak.launches["paged_attention"],
        "replicas": replica_launches,
    }
    log(f"phase 27 main path launches: {json.dumps(launches)}")
    for name in ("conv_affine", "conv_affine_db", "conv_affine_bf16",
                 "conv_bn_train", "conv_bn_train_db", "conv_bn_train_bf16",
                 "conv_bn_bwd", "momentum_arena", "paged_attention"):
        if not launches[name]:
            fail(f"phase 27's main path launched {name} no time")

    # ---- attribute: ResNet-50's FLOPs at batch 1 ----
    res = perf.attribute(eng1, batch=1, per_op=True)
    gflop = res["cost"]["flops"] / 1e9
    block = eng1.program.global_block()
    analytic = 0
    for op in block.ops:
        if op.type in ("fused_conv2d_bn", "conv2d"):
            w = block.var(op.input("Filter")[0]).shape
            o = block.var(op.output("Output")[0]).shape
            analytic += 2 * o[1] * o[2] * w[0] * w[1] * w[2] * w[3]
        elif op.type == "mul":
            k, n = block.var(op.input("Y")[0]).shape
            analytic += 2 * k * n
    top = sorted(res["kind_totals"].items(), key=lambda kv: -kv[1])[:3]
    mb = res["cost"]["bytes_accessed"] / 1e6
    log(f"obs.perf.attribute(ResNet-50, batch 1): {gflop:.3f} GFLOP over "
        f"{res['instructions']} ops (analytic {analytic / 1e9:.3f}: convs "
        f"and the fc at 2 a multiply-add; ~{2 * RESNET50_GMACS:.1f} from "
        f"~{RESNET50_GMACS} G multiply-adds), {mb:.1f} MB of operands and "
        f"results, the most by kind {top}, "
        f"{res['compile_seconds'] * 1e3:.2f} ms")
    if res["cost"]["flops"] != analytic:
        fail(f"attribute counted {res['cost']['flops']} FLOPs, the analytic "
             f"count is {analytic}")
    prof = perf.profile(lambda: eng1.infer(feeds[8]), steps=3, warmup=1)
    top3 = [(t["name"][:40], round(t["us_per_step"], 1))
            for t in prof["top"][:3]]
    log(f"obs.perf.profile(a batch-8 request, 3 steps): "
        f"{prof['busy_us_per_step'] / 1e3:.3f} ms of device time a step in "
        f"{prof['wall_s_per_step'] * 1e3:.3f}; launches {prof['launches']}"
        f", their kernels' trace events {prof['kernel_events']}, complete "
        f"{prof['complete']}; top (name, us a step) {top3}")

    log("\n  B.1's variants against their twins (comparison launches, off "
        "the main path's counts):")
    sums = variant_checks(torch, cbk, by_batch, seed, card)
    shutil.rmtree(work, ignore_errors=True)
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s | {card}")
    return launches, sums


def start_planted_ctc(build):
    """Start nvcc on a copy of csrc/ctc.cu with CTC_PLANT applied, under
    the build directory; records (source, library) in PLANTED_CTC and
    returns the process."""
    src = (build.CSRC / "ctc.cu").read_text()
    anchor, repl = CTC_PLANT
    if src.count(anchor) != 1:
        fail(f"csrc/ctc.cu holds the planted fault's anchor "
             f"{src.count(anchor)} times, not once")
    d = build.BUILD_DIR / "planted"
    d.mkdir(parents=True, exist_ok=True)
    (d / "ctc.cu").write_text(src.replace(anchor, repl))
    PLANTED_CTC[:] = [d / "ctc.cu", d / "libctc.so"]
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(PLANTED_CTC[1]),
         str(PLANTED_CTC[0])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


# phase 28: the placement planner (A13), online learning (A14) and the
# generation engine's warm executables (A15's rest).
# (a) phase 13's lane (the GEN_* geometry, prefill bucket 8, 252 tokens)
# served from exported phase programs: a first engine exports each
# (phase, bucket) into a cache directory; a fresh interpreter loads them
# (its warmup runs no op loop) and serves the lane on both routes, its
# tokens bitwise phase 13's eager engine's, GEN_LAYERS paged_attention
# launches a decode dispatch from inside the exported decode program; a
# bit-flipped artifact rejects typed, and an executable swapped for one
# that refuses the decode feeds is a run_failed reject and one hot
# recompile; the time to the first token of a fresh interpreter with and
# without the cache
GW_PROMPT, GW_NEW = [1, 2, 3], 4
# (b) the planner over phase 20's LM training program (LM_BATCH x LM_SEQ,
# Adam): reports for 1 and 8 devices with the FLOPs measured on the card;
# the 1-device choice applied over a one-rank NCCL group, PLAN_STEPS steps
# bitwise the hand-built step, one adam_arena a step; a bundle published
# with plan=True, whose plan a fresh interpreter resolves with no search.
# The published bundle is the book's digits MLP (tests/book/
# test_recognize_digits.py's widths): publishing runs the warm pass too,
# which exports the bundle per bucket
PLAN_DEVICES, PLAN_STEPS, PLAN_BUCKETS = (1, 8), 3, "1,8"
# (c) OnlineLearningLoop over phase 22's Wide&Deep at full width (WD:
# 1 000 000 x 64 and 1 000 000 x 1 tables, batch 4096): 2 pserver shards in
# sync mode (checkpointing every update, the loop's default), a freeze
# every ONLINE_PUBLISH_STEPS steps, 2 replicas on the card (buckets
# ONLINE_BUCKETS) answering a client thread throughout; one pserver shard
# and then one replica SIGKILLed once a rollout has landed; the stream
# cycles ONLINE_FEEDS seeded Criteo batches. The loop runs until
# ONLINE_VERSIONS versions have been served and a rollout has landed after
# both kills, within ONLINE_DEADLINE_S. The final version's replies
# against the trainer-side forward on its frozen parameters: bitwise at
# requests that fill a bucket (8, 64 rows), within ONLINE_PAD_LIMIT of the
# largest element at 5 rows (padded to 8: the fc GEMMs run at another M)
ONLINE_PUBLISH_STEPS, ONLINE_MIN_SERVE_S, ONLINE_VERSIONS = 4, 1.0, 3
ONLINE_BUCKETS, ONLINE_ROWS, ONLINE_PAD_LIMIT = (8, 64), (8, 5, 64), 1e-5
ONLINE_FEEDS, ONLINE_DEADLINE_S, ONLINE_READY_S = 4, 300.0, 300.0
# the registry keeps the newest ONLINE_KEEP versions (and the served one
# and its rollback target): a version is about 260 MB of tables
ONLINE_KEEP = 3


def gen_warm_child(lm_dir, cache, mode, kernel_tier, plan_dir=""):
    """Phase 28(a)'s fresh interpreter (``mode`` cold: no cache; warm: the
    cache read-only), under the parent's ``kernel_tier`` (a spawned process
    starts with default flags; the flag keys the artifacts). Prints one
    JSON line: the imports' and the time to the first token (engine built,
    warmed, one request's first token), the warmup's op-loop first
    dispatches and, warm, both routes' lanes with their launches, decode
    dispatches and dispatches through the loaded decode program, then the
    two planted faults. Given ``plan_dir`` (phase 28(b)'s published
    bundle), it then resolves that bundle's plan as a replica would
    (resolve_published_plan)."""
    t0 = time.perf_counter()
    import numpy as np
    import torch
    import paddle_tpu_torch.fluid  # noqa: F401  (registers the ops)
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    from paddle_tpu_torch.serving import ExecCache, GenerationEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    paddle_tpu_torch.fluid.set_flags({"kernel_tier": kernel_tier})
    geom = dict(max_seqs=GEN_MAX_SEQS, block_size=GEN_BLOCK,
                num_blocks=GEN_BLOCKS, max_len=GEN_MAX_LEN,
                prefill_buckets=(8,))

    def engine(path):
        return GenerationEngine(
            lm_dir, exec_cache=ExecCache(path, readonly=True)
            if path else False, **geom)

    out = {"import_s": time.perf_counter() - t0}
    t1 = time.perf_counter()
    eng = engine(cache if mode == "warm" else None)
    compiles = eng.warmup()
    _h, first, _fin = eng.start(GW_PROMPT, GW_NEW)
    out["ttft_s"] = time.perf_counter() - t1
    out["warmup_compiles"] = compiles
    for h in list(eng._slots):
        if h is not None:
            eng.abort(h)
    if mode == "warm":
        runs = {}

        class Counted:
            """A loaded executable that counts its dispatches."""

            def __init__(self, entry, key):
                self.entry, self.key, self.source = entry, key, entry.source

            def run(self, *a, **k):
                runs[self.key] = runs.get(self.key, 0) + 1
                return self.entry.run(*a, **k)

        for key in list(eng._warm_execs):
            eng._warm_execs[key] = Counted(eng._warm_execs[key], key)
        for continuous in (True, False):
            d0 = eng.stats()["phases"]["decode"][GEN_MAX_SEQS]["dispatches"]
            r0 = runs.get(("decode", GEN_MAX_SEQS), 0)
            pak.reset_launches()
            lane = gen_lane(eng, continuous)
            torch.cuda.synchronize()
            out["continuous" if continuous else "gang"] = {
                "tokens": lane["tokens"], "elapsed": lane["elapsed"],
                "launches": pak.launches["paged_attention"],
                "decodes": eng.stats()["phases"]["decode"][GEN_MAX_SEQS][
                    "dispatches"] - d0,
                "exported_decodes": runs.get(("decode", GEN_MAX_SEQS), 0)
                - r0}
        st = eng.stats()
        out["stats"] = {"exec_cache": st["exec_cache"],
                        "warm_loaded": st["warm_loaded"],
                        "hot_recompiles": st["hot_recompiles"]}
        # planted 1: one artifact's payload bit-flipped in a copy of the
        # cache: a typed reject at load, that (phase, bucket) through the
        # op loop at warmup
        bad = cache + "-flipped"
        shutil.copytree(cache, bad)
        name = [n for n in ExecCache(bad).artifacts()
                if n.startswith("gen_decode")][0]
        with open(os.path.join(bad, name), "r+b") as f:
            f.seek(os.path.getsize(os.path.join(bad, name)) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0x40]))
        flipped = engine(bad)
        c = flipped.warmup()
        lane = gen_lane(flipped, True)
        out["flipped"] = {"warmup_compiles": c, "tokens": lane["tokens"],
                          "rejects": flipped.stats()["exec_cache"]["rejects"],
                          "hot_recompiles": flipped.hot_recompiles}
        # planted 2: the decode executable swapped after warmup for the
        # prefill program (a real artifact that loads and refuses the
        # decode feeds): run_failed, one hot recompile, the op loop answers
        swapped = engine(cache)
        swapped.warmup()
        swapped._warm_execs[("decode", GEN_MAX_SEQS)] = \
            swapped._warm_execs[("prefill", 8)]
        lane = gen_lane(swapped, True)
        out["swapped"] = {"tokens": lane["tokens"],
                          "rejects": swapped.stats()["exec_cache"]["rejects"],
                          "hot_recompiles": swapped.hot_recompiles}
    if plan_dir:
        t2 = time.perf_counter()
        out["plan"] = resolve_published_plan(plan_dir)
        out["plan"]["seconds"] = time.perf_counter() - t2
    print(json.dumps(out), flush=True)


def resolve_published_plan(path):
    """What a replica does with a published bundle's plan: load the bundle
    on the card and plan it with ``model_dir``. Returns the planner's
    counters in this process (searches, cache hits, rejects) and the
    choice."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.obs import REGISTRY, perf
    from paddle_tpu_torch.parallel import planner as pl

    exe = fluid.Executor()
    prog, feeds, fetches = fluid.io.load_inference_model(
        path, exe, scope=fluid.Scope())
    n = pl._device_count(exe.device)
    rep = pl.plan(prog, feed_example=perf.template_feed(prog, feeds,
                                                        batch=n),
                  fetch_list=fetches, model_dir=path, measure=False,
                  executor=exe)
    t = REGISTRY.totals()
    return {"searches": t.get("paddle_tpu_plan_searches", 0),
            "hits": t.get("paddle_tpu_plan_cache_hits", 0),
            "rejects": t.get("paddle_tpu_plan_rejects", 0),
            "from_cache": rep.from_cache,
            "chosen": rep.chosen.describe(), "n_devices": n,
            "device": rep.fingerprint["device"]}


def run_children(code, arg_lists, timeout):
    """Fresh interpreters at the repository root, started together, each
    running ``code`` (which prints one JSON line last) with its
    arguments: their last lines, parsed. Every one is killed if they are
    not done within ``timeout`` seconds."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", code]
                              + [str(a) for a in args], env=env, cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in arg_lists]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                fail(f"child {code.splitlines()[0][:60]!r} exited "
                     f"{p.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


GEN_WARM_CHILD = ("import sys, chip_smoke; "
                  "chip_smoke.gen_warm_child(*sys.argv[1:])")

def planned_lm_rank(seed, sizes, plan_kw):
    """One NCCL rank of phase 28(b): phase 20's LM step through the
    planner's candidate with these ``sizes`` and ``plan_kw`` and through
    the same mesh and plan built by hand, PLAN_STEPS steps each
    (multichip.planned_run), on this rank's card."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.testing import multichip

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = f"cuda:{dist.get_rank()}" if dist.get_backend() == "nccl" \
        else "cpu"
    out = multichip.planned_run(lm_dp_program, dict(seed=seed),
                                [lm_feed(seed)] * PLAN_STEPS,
                                dist.get_world_size(), sizes, plan_kw,
                                device=dev)
    out["backend"] = dist.get_backend()
    return out


def phase_gen_warm(torch, fluid, seed, card, gen, problems, plan_path):
    """Phase 28(a) (GW_*): returns paged_attention's launches in the fresh
    interpreter's lanes, the times to the first token, and what the cold
    interpreter made of the plan published at ``plan_path``."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pak
    from paddle_tpu_torch.serving import GenerationEngine

    work = tempfile.mkdtemp(prefix="chip-smoke-genwarm-")
    cache = os.path.join(work, "cache")
    geom = dict(max_seqs=GEN_MAX_SEQS, block_size=GEN_BLOCK,
                num_blocks=GEN_BLOCKS, max_len=GEN_MAX_LEN,
                prefill_buckets=(8,))
    t0 = time.perf_counter()
    fill = GenerationEngine(gen["dir"], exec_cache=cache, **geom)
    compiles = fill.warmup()
    _h, _first, _fin = fill.start(GW_PROMPT, GW_NEW)
    fill_ttft = time.perf_counter() - t0
    st = fill.stats()["exec_cache"]
    log(f"fill: {compiles} (phase, bucket) programs exported and "
        f"dispatched ({st['saves']} saved, "
        f"{sorted(os.listdir(cache))}), first token {fill_ttft:.2f} s from "
        f"the engine's construction")
    if st["saves"] != 2:
        problems.append(f"(a) the fill saved {st['saves']} programs, want 2 "
                        "(decode, prefill 8)")
    for h in list(fill._slots):
        if h is not None:
            fill.abort(h)
    pak.reset_launches()
    lane = gen_lane(fill, True)
    if lane["tokens"] != gen["tokens"]:
        problems.append("(a) the filling engine's tokens differ from phase "
                        "13's eager engine's")
    route = fluid.get_flag("kernel_tier")
    cold, warm = run_children(
        GEN_WARM_CHILD, [[gen["dir"], cache, "cold", route, plan_path],
                         [gen["dir"], cache, "warm", route]], 300)
    log(f"time to the first token of a fresh interpreter (engine built, "
        f"warmed, one request's first token; imports apart; the cold and "
        f"the warm one started together): cold "
        f"{cold['ttft_s']:.3f} s ({cold['warmup_compiles']} op-loop first "
        f"dispatches), warm {warm['ttft_s']:.3f} s "
        f"({warm['warmup_compiles']}); imports {cold['import_s']:.2f} / "
        f"{warm['import_s']:.2f} s | {card}")
    if warm["warmup_compiles"] != 0 or warm["stats"]["warm_loaded"] != 2:
        problems.append(f"(a) the warm engine's warmup ran "
                        f"{warm['warmup_compiles']} op-loop dispatches and "
                        f"loaded {warm['stats']['warm_loaded']} programs, "
                        "want 0 and 2")
    launches = 0
    for mode in ("continuous", "gang"):
        lane = warm[mode]
        launches += lane["launches"]
        same = lane["tokens"] == gen["tokens"]
        log(f"warm {mode}: 252 tokens in {lane['elapsed'] * 1e3:.1f} ms, "
            f"{lane['decodes']} decode dispatches, "
            f"{lane['exported_decodes']} through the loaded decode program, "
            f"paged_attention launches {lane['launches']}; tokens "
            f"{'bitwise' if same else 'DIFFERENT from'} phase 13's eager "
            "engine's")
        if not same:
            problems.append(f"(a) warm {mode} tokens differ from the eager "
                            "engine's")
        if lane["launches"] != GEN_LAYERS * lane["decodes"] \
                or lane["exported_decodes"] != lane["decodes"]:
            problems.append(
                f"(a) warm {mode}: {lane['launches']} launches over "
                f"{lane['decodes']} decode dispatches "
                f"({lane['exported_decodes']} exported), want "
                f"{GEN_LAYERS} each, every one exported")
    rej = warm["stats"]["exec_cache"]["rejects"]
    if any(rej.values()) or warm["stats"]["hot_recompiles"]:
        problems.append(f"(a) rejects {rej} or hot recompiles "
                        f"{warm['stats']['hot_recompiles']} on the "
                        "unplanted runs")
    fl, sw = warm["flipped"], warm["swapped"]
    log(f"planted: a bit-flipped decode artifact: rejects {fl['rejects']}, "
        f"{fl['warmup_compiles']} op-loop warmup dispatch, tokens "
        f"{'bitwise' if fl['tokens'] == gen['tokens'] else 'DIFFERENT'}; "
        f"the decode program swapped for the prefill one: rejects "
        f"{sw['rejects']}, hot recompiles {sw['hot_recompiles']}, tokens "
        f"{'bitwise' if sw['tokens'] == gen['tokens'] else 'DIFFERENT'}")
    if fl["rejects"]["format"] != 1 or fl["warmup_compiles"] != 1 \
            or fl["tokens"] != gen["tokens"]:
        problems.append("(a) the bit-flipped artifact was not one typed "
                        "format reject with the same tokens")
    if sw["rejects"]["run_failed"] != 1 or sw["hot_recompiles"] != 1 \
            or sw["tokens"] != gen["tokens"]:
        problems.append("(a) the swapped executable was not one run_failed "
                        "reject and one hot recompile with the same tokens")
    shutil.rmtree(work, ignore_errors=True)
    return launches, {"cold_ttft_s": cold["ttft_s"],
                      "warm_ttft_s": warm["ttft_s"]}, cold["plan"]


def phase_planner(torch, fluid, seed, card, problems, work):
    """Phase 28(b) (PLAN_*): returns adam_arena's launches in the planned
    steps and the version directory of the bundle published under ``work``
    with plan=True (phase 28(a)'s cold interpreter resolves its plan)."""
    import numpy as np
    import chip_smoke
    from paddle_tpu_torch.obs import REGISTRY
    from paddle_tpu_torch.parallel import planner as pl
    from paddle_tpu_torch.parallel.launch import RankPool
    from paddle_tpu_torch.serving import ModelRegistry
    from paddle_tpu_torch.testing import models

    fluid.reset_unique_name()
    main, startup, loss = lm_dp_program(seed)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = lm_feed(seed)
    reports = {}
    for n in PLAN_DEVICES:
        t0 = time.perf_counter()
        rep = pl.plan(main, feed_example=feed, n_devices=n,
                      fetch_list=[loss], executor=exe, scope=scope,
                      max_candidates=0)
        reports[n] = rep
        log(f"plan of phase 20's LM step (batch {LM_BATCH} x {LM_SEQ} "
            f"tokens) over {n} device(s) in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms: chosen "
            f"{rep.chosen.describe()} | {card}\n{rep.render()}")
    feats = pl.extract_features(main, feed_example=feed, fetch_list=[loss],
                                executor=exe, scope=scope)
    log(f"FLOPs of one step measured on the card (FlopCounterMode over the "
        f"op loop): {feats.flops:.6e}; the static estimate 6 x batch x "
        f"parameters: {6.0 * feats.batch * sum(int(np.prod(s)) for s in feats.param_shapes.values()):.6e}; "
        f"fingerprint device {reports[1].fingerprint['device']}")
    if not feats.flops or reports[1].fingerprint["device"] != \
            torch.cuda.get_device_name(0):
        problems.append("(b) no FLOPs measured on the card")
    chosen = reports[1].chosen
    with RankPool(1, "nccl", timeout=300) as pool:
        [rank] = pool.run(chip_smoke.planned_lm_rank, seed, chosen.sizes,
                          chosen.plan_kw)
    adam = rank["launches"]["planned"].get("adam_arena", 0)
    same = rank["planned"] == rank["hand"]
    log(f"the 1-device choice {chosen.describe()} applied over a one-rank "
        f"{rank['backend']} group, {PLAN_STEPS} steps: losses "
        + " ".join(f"{v:.6f}" for v in rank["losses"])
        + f", {'bitwise' if same else 'NOT bitwise'} the hand-built "
        f"make_mesh(1) + ShardingPlan step; launches planned "
        f"{rank['launches']['planned']}, hand-built "
        f"{rank['launches']['hand']}")
    if not same or rank["backend"] != "nccl" or adam != PLAN_STEPS:
        problems.append(f"(b) the planned step: bitwise {same}, backend "
                        f"{rank['backend']}, adam_arena {adam} in "
                        f"{PLAN_STEPS} steps")
    # a bundle published with plan=True, resolved by a fresh interpreter
    fluid.reset_unique_name()
    dmain, dstartup, v = models.digits_mlp(fluid)
    dscope = fluid.Scope()
    exe.run(dstartup, scope=dscope)
    bundle = os.path.join(work, "digits")
    fluid.io.save_inference_model(bundle, ["img"], [v["predict"]], exe,
                                  main_program=dmain, scope=dscope)
    reg = ModelRegistry(os.path.join(work, "registry"))
    before = REGISTRY.totals().get("paddle_tpu_plan_searches", 0)
    t0 = time.perf_counter()
    ver = reg.publish("digits", bundle, plan=True,
                      warm_kwargs={"buckets": PLAN_BUCKETS})
    pub_s = time.perf_counter() - t0
    m = reg.verify("digits", ver)
    path, _ = reg.resolve("digits", ver)
    log(f"publish(plan=True) of the digits MLP in {pub_s:.2f} s "
        f"({REGISTRY.totals().get('paddle_tpu_plan_searches', 0) - before} "
        f"search, plan_files {sorted(m.get('plan_files', {}))}, warm_files "
        f"{len(m.get('warm_files', {}))})")
    if not m.get("plan_files"):
        problems.append("(b) publish(plan=True) certified no plan")
    return adam, path


def _load_ckpt_params(paths):
    import pickle

    params, rounds = {}, set()
    for p in paths:
        with open(p, "rb") as f:
            st = pickle.load(f)
        params.update(st["params"])
        rounds.add(int(st["round"]))
    return params, rounds


def phase_online(torch, fluid, seed, card, problems):
    """Phase 28(c) (ONLINE_*): returns the loop's readings."""
    import numpy as np
    from paddle_tpu_torch.distributed import RetryPolicy
    from paddle_tpu_torch.online import OnlineLearningLoop
    from paddle_tpu_torch.serving import FleetClient, InferClient

    fluid.reset_unique_name()
    main, startup, loss, prob = wd_program(fluid, WD, seed, with_prob=True)
    feeds = [wd_feed(np, WD, seed + 280 + i) for i in range(ONLINE_FEEDS)]

    def reader():
        i = 0
        while True:
            yield feeds[i % len(feeds)]
            i += 1

    work = tempfile.mkdtemp(prefix="chip-smoke-online-")
    loop = OnlineLearningLoop(
        main, startup, reader, ["ids", "dense"], [prob],
        registry_root=os.path.join(work, "registry"), model="wd",
        n_pservers=WD_SHARDS, n_replicas=2,
        publish_every_steps=ONLINE_PUBLISH_STEPS,
        min_serve_s=ONLINE_MIN_SERVE_S, rollout_poll_s=0.2,
        buckets=",".join(str(b) for b in ONLINE_BUCKETS), max_delay_ms=1.0,
        checkpoint_dir=os.path.join(work, "ckpt"), extra_fetch=[loss],
        registry_keep=ONLINE_KEEP)
    rows = {n: {"ids": feeds[0]["ids"][:n], "dense": feeds[0]["dense"][:n]}
            for n in ONLINE_ROWS}
    errs, infers, served_seen, checked = [], [0], [], {}
    stop = threading.Event()
    copies = {}

    def hammer(addresses):
        fc = FleetClient(addresses, retry=RetryPolicy(
            max_retries=20, backoff_base_s=0.05, backoff_max_s=1.0))
        try:
            while not stop.is_set():
                try:
                    out = fc.infer(rows[8])
                    infers[0] += 1
                    if np.asarray(out[0]).shape != (8, 1):
                        errs.append(f"reply shape {np.asarray(out[0]).shape}")
                except Exception as e:
                    errs.append(repr(e))
        finally:
            fc.close()

    def check_version(v):
        """A freeze's bundle against both shards' checkpoints copied at
        its cut: bitwise, the same round."""
        man = loop.registry.manifest("wd", v)
        lin = man.get("lineage", {})
        step = lin.get("global_step")
        if step == 0:
            checked[v] = "initial parameters (no update: no checkpoint)"
            return
        paths = copies.pop(step, None)
        if paths is None:
            problems.append(f"(c) v{v} (step {step}): no checkpoint copy "
                            "taken at its cut")
            return
        params, rounds = _load_ckpt_params(paths)
        path, _ = loop.registry.resolve("wd", v)
        bad = [n for n, w in params.items()
               if not os.path.exists(os.path.join(path, n + ".npy"))
               or not (lambda g: g.dtype == w.dtype and np.array_equal(
                   g, w))(np.load(os.path.join(path, n + ".npy")))]
        if rounds != {lin.get("freeze_round")} or bad:
            problems.append(f"(c) v{v}: checkpoint rounds {rounds} against "
                            f"the freeze's {lin.get('freeze_round')}, "
                            f"params not bitwise {bad}")
        checked[v] = f"round {lin.get('freeze_round')}: " + (
            "bitwise" if not bad else f"differs in {bad}")
        for p in paths:
            os.unlink(p)

    ht = None
    t_start = time.perf_counter()
    try:
        v0 = loop.start(wait_ready_s=ONLINE_READY_S)
        ready_s = time.perf_counter() - t_start
        orig = loop.freezer.request_freeze

        def request_freeze(step, wait=False, timeout=None):
            # at the trainer's step boundary both shards' checkpoints hold
            # this round (a push is acked after its checkpoint is written)
            d = os.path.join(work, f"cut-{step}")
            os.makedirs(d, exist_ok=True)
            paths = []
            for i in range(WD_SHARDS):
                paths.append(os.path.join(d, f"{i}.ckpt"))
                shutil.copyfile(loop.pservers.checkpoint_path(i), paths[-1])
            job = orig(step, wait=wait, timeout=timeout)
            if job is None:
                shutil.rmtree(d, ignore_errors=True)
            else:
                copies[step] = paths
            return job

        loop.freezer.request_freeze = request_freeze
        ht = threading.Thread(target=hammer,
                              args=(list(loop.fleet.addresses),), daemon=True)
        ht.start()
        log(f"loop up in {ready_s:.1f} s (2 pserver shards, v{v0} frozen from "
            f"the initial parameters and published, {2} replicas serving "
            f"it) | {card}")
        kills, t_train0, step0 = {}, time.perf_counter(), 0
        served_versions = {v0}
        deadline = time.monotonic() + ONLINE_DEADLINE_S
        while True:
            if time.monotonic() > deadline:
                fail(f"phase 28(c): the loop did not reach its end within "
                     f"{ONLINE_DEADLINE_S:.0f} s: "
                     + json.dumps(loop.stats(fleet_metrics=False))[:2000])
            st = loop.stats(fleet_metrics=False)
            served_seen.append(st["served_version"])
            served_versions.add(st["served_version"])
            for v in st["published_versions"]:
                if v not in checked and v not in st["rollout"]["bad_versions"]:
                    check_version(v)
            step = st["trainer"]["global_step"]
            ro = st["rollout"]["rollouts"]
            if "pserver" not in kills and ro >= 1:
                loop.pservers.kill(1)
                kills["pserver"] = (step, ro, time.perf_counter())
                log(f"SIGKILL pserver shard 1 at step {step}, after {ro} "
                    "rollout(s)")
            if "replica" not in kills and "pserver" in kills:
                loop.fleet.kill(1)
                kills["replica"] = (step, ro, time.perf_counter())
                log(f"SIGKILL replica 1 at step {step}, after {ro} "
                    "rollout(s)")
            restarted = (
                sum(c["restart_count"] for c in st["pserver_children"]) >= 1
                and sum(c["restart_count"] for c in st["fleet_children"]) >= 1)
            if "replica" in kills and ro > kills["replica"][1] and restarted \
                    and len(served_versions) >= ONLINE_VERSIONS \
                    and all(loop.fleet.replica_health(i) for i in range(2)):
                break
            time.sleep(0.5)
        train_s = time.perf_counter() - t_train0
        loop.trainer.stop()
        final_steps = loop.trainer.global_step
        # let the last accepted freeze publish and roll out
        conv_deadline = time.monotonic() + 120.0
        while True:
            st = loop.stats(fleet_metrics=False)
            latest = [v for v in st["published_versions"]
                      if v not in st["rollout"]["bad_versions"]][-1]
            health = [loop.fleet.replica_health(i) for i in range(2)]
            if st["served_version"] == latest and all(
                    h and h.get("version") == latest for h in health) \
                    and loop.freezer._jobs.empty():
                break
            if time.monotonic() > conv_deadline:
                fail(f"phase 28(c): the fleet did not converge on v{latest}: "
                     f"{health}")
            time.sleep(0.5)
        for v in st["published_versions"]:
            if v not in checked:
                check_version(v)
        stop.set()
        ht.join(30.0)
        st = loop.stats()
        fr = loop.freezer.stats()["freeze_latency"]
        p2s = st["rollout"]["publish_to_served"]
        log(f"{final_steps} steps in {train_s:.1f} s "
            f"({final_steps / train_s:.3f} steps/s, the trainer's last loss "
            f"{st['trainer']['last_extra']}); freezes "
            f"{loop.freezer.stats()['published']} published, "
            f"{loop.freezer.stats()['skipped_busy']} skipped busy, "
            f"{json.dumps(loop.freezer.stats()['failures'])} failed, "
            f"{fr.get('p50_ms', 0) / 1e3:.3f} s a freeze (p50, max "
            f"{fr.get('max_ms', 0) / 1e3:.3f}); publish to served p50 "
            f"{p2s.get('p50_ms', 0) / 1e3:.3f} s (max "
            f"{p2s.get('max_ms', 0) / 1e3:.3f}, {p2s.get('count')} "
            f"rollouts); {infers[0]} infer requests, {len(errs)} failed; "
            f"served versions {sorted(served_versions)}; restarts pserver "
            f"{[c['restart_count'] for c in st['pserver_children']]}, "
            f"replicas {[c['restart_count'] for c in st['fleet_children']]}"
            f" | {card}")
        log("freezes against the pserver checkpoints at their rounds: "
            + json.dumps(checked))
        if errs:
            problems.append(f"(c) {len(errs)} infer requests failed: "
                            f"{errs[:3]}")
        if any(b < a for a, b in zip(served_seen, served_seen[1:])):
            problems.append(f"(c) the served version went back: "
                            f"{served_seen}")
        if len(served_versions) < ONLINE_VERSIONS or infers[0] == 0:
            problems.append(f"(c) served {sorted(served_versions)}, "
                            f"{infers[0]} requests")
        # the final version's replies against the trainer-side forward on
        # its frozen parameters
        final = st["served_version"]
        path, _ = loop.registry.resolve("wd", final)
        exe = fluid.Executor()
        fscope = fluid.Scope()
        prog, feed_names, fetches = fluid.io.load_inference_model(
            path, exe, scope=fscope)
        readings = []
        for i, addr in enumerate(loop.fleet.addresses):
            with InferClient(tuple(addr)) as c:
                for n in ONLINE_ROWS:
                    got = np.asarray(c.infer(rows[n])[0])
                    want = np.asarray(exe.run(prog, feed=rows[n],
                                              fetch_list=fetches,
                                              scope=fscope)[0])
                    fills = n in ONLINE_BUCKETS
                    err = float(np.max(np.abs(got - want)))
                    scale = float(np.max(np.abs(want)))
                    ok = np.array_equal(got, want) if fills \
                        else err <= ONLINE_PAD_LIMIT * scale
                    readings.append(f"replica {i} {n} rows: "
                                    + ("bitwise" if np.array_equal(got, want)
                                       else f"max |Δ| {err:.3e} of "
                                            f"{scale:.3e}"))
                    if not ok:
                        problems.append(f"(c) replica {i}, {n} rows: "
                                        f"max |Δ| {err:.3e} of {scale:.3e}")
        log(f"v{final}'s replies against the trainer-side forward on its "
            "frozen parameters (bitwise where the request fills a bucket, "
            f"else within {ONLINE_PAD_LIMIT} of the largest): "
            + "; ".join(readings))
        return {"steps_per_s": final_steps / train_s,
                "freeze_s": fr.get("p50_ms", 0) / 1e3,
                "publish_to_served_s": p2s.get("p50_ms", 0) / 1e3}
    finally:
        stop.set()
        if ht is not None:
            ht.join(30.0)
        loop.stop()
        shutil.rmtree(work, ignore_errors=True)


def phase_online_planner(torch, fluid, seed, card, gen):
    """Phase 28: the generation engine's warm executables (a), the
    placement planner (b) and online learning at full width (c). Returns
    the main path's launches of paged_attention (inside the exported
    decode programs) and adam_arena (the planned step), and the readings."""
    from paddle_tpu_torch.ops import cuda as tier

    log(f"\n== phase 28: the LM lane from exported phase programs, the "
        f"placement planner over phase 20's LM, online learning over "
        f"Wide&Deep at full width | {card} ==")
    t_phase = time.perf_counter()
    problems = []
    work = tempfile.mkdtemp(prefix="chip-smoke-plan-")
    log("-- (b) the placement planner --")
    adam, plan_path = phase_planner(torch, fluid, seed, card, problems, work)
    log("-- (a) warm executables --")
    pa, ttft, child = phase_gen_warm(torch, fluid, seed, card, gen,
                                     problems, plan_path)
    log(f"(b) the published plan resolved by (a)'s cold interpreter, as a "
        f"replica resolves it, in {child['seconds']:.2f} s: "
        f"{json.dumps(child)}")
    if child["searches"] != 0 or child["hits"] != 1 \
            or not child["from_cache"]:
        problems.append(f"(b) the replica's plan: {child['searches']} "
                        f"searches, {child['hits']} cache hits")
    shutil.rmtree(work, ignore_errors=True)
    log("-- (c) online learning --")
    c0 = tier.launch_counts()
    online = phase_online(torch, fluid, seed, card, problems)
    online_launches = {k: v - c0.get(k, 0)
                       for k, v in tier.launch_counts().items()
                       if v - c0.get(k, 0)}
    log(f"(c)'s launches in this process (the trainer and the freezes): "
        f"{online_launches} (the update runs in the numpy shards)")
    log(f"phase 28: {time.perf_counter() - t_phase:.1f} s | {card}")
    if problems:
        fail("phase 28: " + "; ".join(problems))
    return {"paged_attention": pa, "adam_arena": adam}, {**ttft, **online}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "paddle_tpu_torch")):
        fail("run chip_smoke.py from a checkout of the repository: "
             "paddle_tpu_torch/ is missing beside it")
    sys.path.insert(0, repo)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops.cuda import build

    log("== phase 1: build ==")
    card = card_line()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log(f"card: {card} | torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}) | {nvcc[-1] if nvcc else 'nvcc ?'}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mm = torch.backends.cuda.matmul
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={mm.allow_tf32} "
        "cuda.matmul.allow_bf16_reduced_precision_reduction="
        f"{mm.allow_bf16_reduced_precision_reduction} (paddle_tpu_torch "
        "turns it off when imported: bf16 GEMMs accumulate in float32)")
    planted = start_planted_ctc(build)
    try:
        built = build.build(KERNELS)
    finally:
        planted_log = planted.communicate()[0]
    for name, (secs, out) in built.items():
        lines = ptxas_summary(out)
        spilled = [ln for ln in lines if " 0 bytes spill stores" not in ln]
        log(f"built {name} in {secs:.2f} s: {len(lines)} kernels, "
            f"{len(spilled)} with spills")
        for line in (lines if name in ("conv_affine", "conv_bn_train",
                                       "conv_bn_bwd") else spilled):
            log(f"  {line}")
    if planted.returncode != 0:
        fail(f"nvcc failed on the planted copy of ctc.cu:\n{planted_log}")
    log(f"built the planted ctc.cu (the forward's skip mask ignored) at "
        f"{PLANTED_CTC[1]}")

    totals = phase_kernels(torch, fluid, args.seed)
    train_totals = phase_train_kernels(torch, fluid, args.seed)
    launches, serving = phase_serving(torch, fluid, args.seed, card)
    train_launches, resnet_f32 = phase_training(torch, fluid, args.seed,
                                                card)
    rnn_totals = phase_rnn_kernels(torch, fluid, args.seed, card)
    rnn_launches, textcls_f32 = phase_textcls(torch, fluid, args.seed, card)
    seq_totals = phase_seq_kernels(torch, fluid, args.seed, card)
    gru_launches, _ = phase_textcls(torch, fluid, args.seed, card, "gru")
    ctc_launches = phase_ctc(torch, fluid, args.seed, card)
    sparse_totals = phase_sparse_kernels(torch, fluid, args.seed, card)
    w2v_launches = phase_word2vec(torch, fluid, args.seed, card)
    paged_totals = phase_paged_kernels(torch, fluid, args.seed, card)
    gen_launches, gen = phase_generation(torch, fluid, args.seed, card)
    srv_launches, srv_gen_launches, srv_summary = phase_front_door(
        torch, fluid, args.seed, card, serving, gen)
    rec = phase_recipes(torch, fluid, args.seed, card)
    amp, amp_sums = phase_amp(torch, fluid, args.seed, card,
                              dict(resnet=resnet_f32, textcls=textcls_f32))
    rt = phase_runtime(torch, fluid, args.seed, card, serving, gen)
    s2s = phase_seq2seq(torch, fluid, args.seed, card)
    book = phase_book(torch, fluid, args.seed, card)
    lm = phase_lm_train(torch, fluid, args.seed, card)
    multi = phase_multichip(torch, fluid, args.seed, card)
    ctr = phase_ctr(torch, fluid, args.seed, card)
    inp, l12 = phase_input_pipeline(torch, fluid, args.seed, card)
    leg = phase_legacy(torch, fluid, args.seed, card)
    dep = phase_deploy(torch, fluid, args.seed, card)
    det = phase_detection(torch, fluid, args.seed, card)
    fleet, variants = phase_fleet(torch, fluid, args.seed, card, serving,
                                  gen)
    p28, p28_readings = phase_online_planner(torch, fluid, args.seed, card,
                                             gen)
    log("phase 28 readings: " + json.dumps(p28_readings))
    for d in (serving["dir"], gen["dir"]):
        shutil.rmtree(d, ignore_errors=True)

    def entry(name, source, replaces, n, t, extra=()):
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{source}",
                "replaces": f"paddle_tpu/ops/{replaces}",
                "launches": n, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], **{k: t[k] for k in extra}}

    def with_bf16(t, name):
        """The float32 numbers with phase 16's bfloat16 ones at batch 32."""
        b = amp_sums[name]
        return {**t, "bf16_ms": b["ms"], "bf16_plain_ms": b["plain_ms"],
                "bf16_library_ms": b["library_ms"],
                "bf16_bound_ms": b["bound_ms"],
                "bf16_bound_by": b["bound_by"]}

    bf16_keys = ("bf16_ms", "bf16_plain_ms", "bf16_library_ms",
                 "bf16_bound_ms", "bf16_bound_by")

    def variant(name, batch, other=None):
        """Phase 27's sums of a B.1 variant at ``batch`` (and, with
        ``other``, that batch's under a ``b<other>_`` prefix)."""
        t = dict(variants[name, batch])
        if other is not None:
            o = variants[name, other]
            for k in ("ms", "default_ms", "plain_ms", "library_ms",
                      "bound_ms", "bound_by"):
                t[f"b{other}_{k}"] = o[k]
        return t
    variant_keys_ = ("default_ms", "b1_ms", "b1_default_ms", "b1_plain_ms",
                     "b1_library_ms", "b1_bound_ms", "b1_bound_by")
    l12_keys = ("l12_ms", "l12_plain_ms", "l12_bound_ms")
    kernels = [
        entry("conv_affine", "conv_affine.cu", "pallas/conv_bn.py:261",
              launches + srv_launches + amp["conv_affine"]
              + rt["conv_affine"] + dep["conv_affine"]
              + fleet["conv_affine"],
              with_bf16(totals, "conv_affine"), bf16_keys),
        entry("conv_bn_train", "conv_bn_train.cu", "pallas/conv_bn.py:191",
              train_launches["conv_bn_train"] + rec["conv_bn_train"]
              + amp["conv_bn_train"] + rt["conv_bn_train"]
              + dep["conv_bn_train"] + fleet["conv_bn_train"],
              with_bf16(train_totals["conv_bn_train"], "conv_bn_train"),
              bf16_keys),
        entry("conv_bn_bwd", "conv_bn_bwd.cu", "pallas/conv_bn.py:379",
              train_launches["conv_bn_bwd"] + rec["conv_bn_bwd"]
              + amp["conv_bn_bwd"] + rt["conv_bn_bwd"]
              + dep["conv_bn_bwd"] + fleet["conv_bn_bwd"],
              with_bf16(train_totals["conv_bn_bwd"], "conv_bn_bwd"),
              bf16_keys),
        entry("momentum_arena", "optimizer_arena.cu",
              "pallas/optimizer.py:111",
              train_launches["momentum_arena"] + rec["momentum_arena"]
              + amp["momentum_arena"] + rt["momentum_arena"]
              + dep["momentum_arena"] + det["momentum_arena"]
              + fleet["momentum_arena"],
              train_totals["momentum_arena"], ("kernel_device_ms",)),
        entry("lstm_seq", "lstm_seq.cu", "pallas/rnn.py:124",
              rnn_launches["lstm_seq"] + rec["lstm_seq"] + amp["lstm_seq"]
              + rt["lstm_seq"] + s2s["lstm_seq"] + book["lstm_seq"]
              + inp["lstm_seq"] + leg["lstm_seq"] + dep["lstm_seq"],
              {**rnn_totals["lstm_seq"], **l12["lstm_seq"]}, l12_keys),
        entry("lstm_seq_bwd", "lstm_seq.cu", "pallas/rnn.py:133",
              rnn_launches["lstm_seq_bwd"] + rec["lstm_seq_bwd"]
              + amp["lstm_seq_bwd"] + rt["lstm_seq_bwd"]
              + s2s["lstm_seq_bwd"] + book["lstm_seq_bwd"]
              + inp["lstm_seq_bwd"] + leg["lstm_seq_bwd"],
              {**rnn_totals["lstm_seq_bwd"], **l12["lstm_seq_bwd"]},
              l12_keys),
        entry("adam_arena", "optimizer_arena.cu", "pallas/optimizer.py:129",
              rnn_launches["adam_arena"] + gru_launches["adam_arena"]
              + ctc_launches["adam_arena"] + rec["adam_arena"]
              + amp["adam_arena"] + rt["adam_arena"] + lm["adam_arena"]
              + multi["adam_arena"] + p28["adam_arena"],
              rnn_totals["adam_arena"]),
        entry("gru_seq", "gru_seq.cu", "pallas/rnn.py:233",
              gru_launches["gru_seq"] + ctc_launches["gru_seq"]
              + s2s["gru_seq"],
              seq_totals["gru_seq"]),
        entry("gru_seq_bwd", "gru_seq.cu", "pallas/rnn.py:242",
              gru_launches["gru_seq_bwd"] + ctc_launches["gru_seq_bwd"]
              + s2s["gru_seq_bwd"],
              seq_totals["gru_seq_bwd"]),
        entry("ctc_alpha", "ctc.cu", "pallas/ctc.py:66",
              ctc_launches["ctc_alpha"], seq_totals["ctc_alpha"]),
        entry("ctc_loss_bwd", "ctc.cu", "ctc_ops.py:155",
              ctc_launches["ctc_loss_bwd"], seq_totals["ctc_loss_bwd"]),
        entry("sgd_arena", "optimizer_arena.cu", "pallas/optimizer.py:92",
              w2v_launches["sgd_arena"] + rec["sgd_arena"]
              + rt["sgd_arena"] + ctr["sgd_arena"],
              sparse_totals["sgd_arena"]),
        entry("embedding_sgd", "embedding_sgd.cu", "pallas/embedding.py:40",
              w2v_launches["embedding_sgd"] + rec["embedding_sgd"]
              + rt["embedding_sgd"] + ctr["embedding_sgd"],
              sparse_totals["embedding_sgd"]),
        entry("paged_attention", "paged_attention.cu",
              "pallas/paged_attention.py:100",
              gen_launches + srv_gen_launches + rt["paged_attention"]
              + lm["paged_attention"] + fleet["paged_attention"]
              + p28["paged_attention"],
              paged_totals["paged_attention"],
              ("llama_ms", "llama_bound_ms", "llama_4096_ms",
               "llama_4096_bound_ms")),
        entry("conv_affine_db", "conv_affine.cu", "pallas/conv_bn.py:261",
              fleet["conv_affine_db"], variant("conv_affine_db", 8, 1),
              variant_keys_),
        entry("conv_affine_bf16", "conv_affine.cu", "pallas/conv_bn.py:261",
              fleet["conv_affine_bf16"], variant("conv_affine_bf16", 8, 1),
              variant_keys_),
        entry("conv_bn_train_db", "conv_bn_train.cu",
              "pallas/conv_bn.py:191", fleet["conv_bn_train_db"],
              variant("conv_bn_train_db", TRAIN_BATCH), ("default_ms",)),
        entry("conv_bn_train_bf16", "conv_bn_train.cu",
              "pallas/conv_bn.py:191", fleet["conv_bn_train_bf16"],
              variant("conv_bn_train_bf16", TRAIN_BATCH), ("default_ms",)),
    ]
    log("phase 14 summary: " + json.dumps(srv_summary))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
