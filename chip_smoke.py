#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (each fails the run with a nonzero exit if it fails):

1. device   -- nvidia-smi's name and power limit, torch's device name, the
               TF32 flags as set by the port's Environment.
2. build    -- compile every hand-written kernel from csrc/ with nvcc
               (sm_90a), all sources at once; print the build time and
               ``-Xptxas -v`` (registers, spills) of each.
3. kernels  -- each kernel's wrapper against its plain PyTorch version on
               the card: bn_act at every shape the serving path gives it
               (ResNet-50, batch 32) plus ragged shapes (HW 1, HW below a
               vector, 5x5 and 7x7 planes, odd C, odd numel), float32 and
               bfloat16, and once past 2^31 elements (bf16 [1, 2, 32768,
               32770], the 64-bit index route); fused_update for sgd,
               nesterovs, adam and adamw, float32 state and bfloat16 state
               with identical random bits (bfloat16 moments must match
               bitwise), at the main path's
               bucket (25,557,032 elements), ragged sizes
               (1, 5, 4097) and views that start 1 element into a buffer
               (the head path and the scalar variant); embedding_bag bitwise
               at the CBOW path's shape ([8192, 10] bags of a [10000, 100]
               table) and ragged ones (D 1, 3, 101, 300; W 1; fully masked
               bags; a table 1 element into its buffer; W 32, 33, 40 and
               3, 5, 13 for the index chunks and rows in flight; B 8191,
               1001, 5; indices past both ends), and its bf16 route bitwise
               at [8192, 10] and PV-DM's [8192, 11] bags of a [10000, 100]
               bf16 table and at D 1, 3, 102, 128, 256, 300 (each vector
               width), W 0, 13, 33, 40, offset tables, and the edges of its
               paired layout (two bags a warp: W 11, 12, 16, 17; B 1, 15,
               17, 8191; D 100, 102, 128, 300). Then each kernel,
               its plain version, the unfused PyTorch path and, where one
               PyTorch call computes the same function, that call, timed
               with CUDA events and a cold L2 after a 2 ms spin of the card
               (so the host's launch overhead is not timed), beside the
               bandwidth bound;
               embedding_bag also warm (the L2 its previous launch left),
               with its host time per launch, at a wide shape (V
               3,000,000, D 300), and on its bf16 route at the CBOW path's
               and PV-DM's shapes beside F.embedding_bag on the bf16 table
               and the float32 route on the same values;
               flash_attention's float32 kernel (3xTF32 on wgmma) within
               2e-5 at the encoder path's [384, 128, 64] (non-causal,
               causal, the MHA mask bias,
               a full [B, H, T, T] bias, a row masked everywhere, which must
               give 0), T 200 (a tail tile) and T 512 with D 32, 64 and 128,
               timed at the path's shape and at [96, 512, 64] beside
               F.scaled_dot_product_attention and the unfused matmul +
               softmax + matmul, its bound restated for three TF32
               products (the FFMA bound beside it). Its bf16 kernel
               (wgmma, TMA) against the
               plain version in float32 on the upcast inputs (``want``) at
               the path's [32, 12, 128, 64] as the MHA op hands it over
               (permuted views of [B, T, H, D]; non-causal, causal, mask
               bias, full bias, masked row) and contiguous, T 200, T 1, D
               40, T 512 with D 32/64/128: each element within 2^-8 |want|
               + 2e-5, at least 99% bitwise equal to want rounded to bf16,
               the log-sum-exp within 1e-5; timed at the path's shape and
               at [96, 512, 64], strided and contiguous, beside its plain
               version, SDPA and the unfused path on the same bf16 tensors,
               and its host time per call, and with the float32 output
               that autograd's forward asks for. Then the gradients (dq,
               dk, dv, dbias) through the float32 kernel's forward against
               autograd through dense attention at [8, 256, 64], within
               1e-4; and bf16 gradients through the bf16 kernel (its
               float32 output saved for the backward) against the plain
               version at the path's [32, 12, 128, 64], within 1 bf16 ulp
               + 2^-16 of the largest. Last, bn_act at every launch shape of
               one ResNet-50 serving forward (batch 32: 112x112 down to
               7x7, 64 to 2048 channels) and of phase 24's served forwards
               with BN (SimpleCNN, Xception, InceptionResNetV1,
               FaceNetNN4Small2, NASNet at batch 16: 728 channels at
               19x19, 1792 at 3x3, ...), each against its plain version in
               float32 and bf16 and timed in bf16 beside its byte bound;
               per forward the launch-weighted share of the bound (the
               launches' bounds summed over their times summed), beside
               the launch floor (the kernel at [1, 8], one vector); and
               the identity launches against F.batch_norm (library_ms).
4. serving  -- full-size ResNet-50 (224x224x3, 1000 classes, bf16 compute,
               fused epilogue) behind ParallelInference (batched, batch limit
               32, 2 workers): 64 single-image requests from 8 client
               threads, measured after one unmeasured round that warms the
               pool's worker threads. Checks every answer and that the path
               launched bn_act 53 times per batch served, with no fallback.
5. parity   -- the same model in float32 with TF32 off, batch 8, fused
               epilogue on against off: rtol 1e-4, atol 1e-6.
5b. kernel-routes -- every route the JAX package computes off its kernels
               (a dtype the kernel does not take, a gradient) on the card
               against the CPU, TF32 off, each with 0 kernel launches and its
               plain_on_card count (ops/routing.py): LeNet
               MultiLayerNetwork.fit with fused_update, 3 steps, in float64
               (1e-10 of a leaf's largest) and bfloat16 (2^-5 of it plus a
               quarter of the leaf's step), plain 3, then float32 (1e-5)
               with 3 launches and plain 0; the fleet's member
               route on a float64 [8, 431,080] bucket (1e-10); bn_act float64
               and float16 at [8, 256, 56, 56] with relu and residual (1e-12;
               one float16 rounding); compute_gradient_and_score with the
               fused epilogue for ResNet-50 at its published widths (64x64,
               batch 2, float64, 53 plain BNs, 1e-9 of each tensor's largest)
               and the two-block conv/BN net (float32, 1e-4), no gradient
               zero where the CPU's is not; embedding_bag's table gradient at
               the CBOW path's shape, directly and through SameDiff (1e-5),
               and a float64 table's forward (1e-12). Then phase 4's model
               again: one served forward, 53 bn_act launches, plain 0; one
               float32 training step, 1 fused_update launch, plain 0.
5c. environment -- the Environment's switches on the card. NAN_PANIC
               (set_check_nan) on: log(-1) raises FloatingPointError naming
               aten.log; each kernel, fed a NaN at its main path's shape
               (bn_act bf16 [32, 256, 56, 56] + residual, fused_update
               Nesterovs over 25,557,032 elements, embedding_bag [8192, 10]
               of [10000, 100], flash float32 [384, 128, 64] and bf16 [32,
               12, 128, 64]), raises naming the kernel; a LeNet fit step
               with one NaN in its batch, a backward pass that makes a NaN
               and a ParallelInference request with a NaN image fail the
               same way. Off again: no dispatch mode left, and phase 4's
               served forward (53 bn_act launches) and float32 step (1
               fused_update launch) make as many host syncs in a
               tracecheck.steady_state region as before the phase. Two
               processes with DL4J_TPU_COMPILE_CACHE on a fresh directory:
               the first builds bn_act into it under its hashed name, the
               second runs no nvcc and its bn_act output is bitwise the
               first's, and creates float64 arrays on the card under
               DL4J_TPU_DTYPE=float64; an edited copy of the source hashes
               to another name. allow_pallas off: the encoder's float32
               forward (BERT-base width, batch 2) takes the dense route, 0
               flash launches, within 1e-4 of the flash forward.
6. train    -- full-size ResNet-50 training as bench.py configures it
               (bf16 compute, float32 master params, Nesterovs(0.1, 0.9),
               l2 1e-4, fused_update, bf16 updater state with stochastic
               rounding) through ComputationGraph.fit at batch 128 on a
               seeded synthetic batch: 2 unmeasured steps, then 10 timed
               ones. Gates: finite losses, one fused_update launch per step,
               no fallback, gradients born flat, bf16 state of 51,114,064
               bytes, parameters changed.
7. train-parity -- batch 8, float32 compute, TF32 off, deterministic cuDNN,
               float32 state: one fit step through the kernel against one
               through the per-leaf apply_updater path from the same
               parameters; parameters and momentum within 2 float32 ulp.
7b. resnet50-pipeline -- phase 6's model through ComputationGraph.fit over
               an unshuffled NDArrayDataSetIterator of 300 seeded synthetic
               images at batch 128 (per epoch two full batches and one of
               44 padded to 128), 3 epochs, with bench.py's
               ScoreIterationListener(10) and a CheckpointListener (every 3
               iterations, keep 2; deterministic cuDNN). Gates: 9 fused
               launches, 3 padded batches, finite losses, 2 checkpoints
               committed; a fresh model resumed from the iteration-6 file
               ends with parameters, BN states and bf16 moments bitwise the
               uninterrupted run's; ComputationGraph.load of the last file
               serves 32 images through 53 bn_act launches, bitwise as the
               trained model; evaluate gives one accuracy on both. Prints
               images/s beside phase 6's, step times with and without a
               checkpoint, snapshot ms, serialize-and-commit s, bytes,
               restore s.
7c. core     -- the card against the CPU, float32, TF32 off: the 15 losses
               (value and gradient through an OutputLayer, masked and
               example-weighted; 1e-5 of the largest), the 11 updaters (3
               steps) and the 8 rates (constant and 7 schedules) under
               Nesterovs (2 float32 ulp), the 10 vertices (1e-5), and a
               two-input, two-output MultiDataSet fit (rtol 1e-4).
8. word2vec-cbow -- the word2vec-cbow configuration as bench.py runs it:
               Word2Vec CBOW with negative sampling, vocabulary 10,000 of a
               zipf corpus of 200,000 x 20 words (seed 123), layer 100,
               window 5, 5 negatives, sampling 1e-3, batch 8192, one epoch,
               fitted twice (cold, then warm). Gates: vocabulary 10,000,
               8192 examples per round, 384 embedding_bag launches per fit
               (one per round), tables on the card, finite losses, the last
               loss below ln 2. Then a CBOW fit of the cluster corpus of
               tests/test_nlp.py on the card, gated as there.
9. encoder  -- a BERT-base-width self-attention encoder (vocabulary 30522,
               512 positions, hidden 768, 12 layers, 12 heads, feed-forward
               3072, erf GELU, LayerNorm eps 1e-12; 108,854,786 parameters,
               random from the seed) built with the graph builder, bf16
               compute and float32 parameters, served through
               ComputationGraph.output with int32 tokens and positions
               [B, 128]: 3 warm-ups, then 20 timed batches of 32 and 20 of 1.
               Gates: 12 flash_attention launches per forward, all on the
               bf16 kernel (none on the float32 kernel), no dense attention,
               finite outputs of shape (B, 2) whose rows sum to 1 within
               1e-2.
9b. encoder-train -- the same encoder trained through
               ComputationGraph.fit(MultiDataSet) at batch 32 on one seeded
               batch: bf16 compute over float32 master parameters,
               Adam(2e-5) (BERT's fine-tuning rate) in one fused_update
               launch per step, float32 state; 2 warm-ups, 10 timed steps
               each ended by a synchronize (samples/s, step median, p10,
               p90, peak memory). Gates: 12 bf16 flash launches per step,
               each writing the float32 output the backward takes D from,
               none on the float32 kernel, no dense attention; 1
               fused_update launch per step; finite losses, the last below
               the first. Then hidden 256, 2 layers, 4 heads in float32
               (TF32 off): one fit step from the same weights on the card
               and the CPU, the loss within 1e-4 relative and every
               parameter within 1e-4 of its leaf's scale. (Run after phase
               10, whose model it replaces on the card.)
10. encoder-parity -- the same encoder in float32 (TF32 off) at batch 2 on
               the card (the float32 kernel, 12 launches) against the same
               weights on the CPU (the plain version): probabilities within
               1e-4. Then the encoder at a reduced width (hidden 256, 2
               layers, 4 heads) in bf16 compute: the last hidden states on
               the card (the bf16 kernel) against the CPU within 2% of their
               norm, and no further from the float32 states than twice the
               CPU's bf16 run.

11. lenet   -- LeNet as bench.py trains it (zoo LeNet: Nesterovs 0.01/0.9,
               relu, xavier, conv 20/50 5x5, max pools, dense 500, softmax;
               float32) through MultiLayerNetwork.fit(MnistDataSetIterator(
               128, flatten=False), batch_size=128) on the synthetic MNIST
               fallback: 94 steps per epoch, the last padded by wrapping
               rows; once with a listener that waits for the card after
               every step (step times), once without (images/s); then
               evaluate on the 2,000 test images and bench.py's loop
               (fit(ds) on one batch, 3 warm-ups, 50 timed). Per-leaf, and
               with fused_update (exactly 1 launch per step, no fallback).
               Then 10 steps fused against per-leaf (float32, TF32 off,
               deterministic cuDNN; parameters and momentum within 2 float32
               ulp, phase 7's contract) and 5 steps on the card against the
               CPU (losses within 1e-5 relative).
12. vgg16   -- zoo VGG16 at its published widths (224x224x3, 1000 classes,
               138,357,544 parameters) training at batch 64: bf16 compute,
               fused_update, bf16 updater state, dropout 0.5 on both 4096
               layers, on 8-bit pixels scaled to [0, 1]; 2 warm-ups, 10
               timed fit(ds) steps. Gates: finite
               losses, 1 fused_update launch per step, the keep share of
               dropout's mask on the first dense input within 0.5 +- 0.01.
13. masked  -- a MultiLayerNetwork at BERT-base widths (embedding 30522 x
               768, self-attention 768/12 heads, LayerNorm, self-attention,
               masked average pool, softmax 2; the depth is no published
               model's) served through output(x, fmask=) in bf16 at batch
               32, T 128, real lengths uniform in [16, 128]: 2 bf16 flash
               launches per forward carrying the mask bias as a zero-stride
               view, no dense attention, rows summing to 1, outputs
               unchanged when the padded token ids change, and float32 on
               the card against the CPU at batch 4 within 1e-4. Then
               fused_update's kernel at LeNet's and VGG16's buckets against
               its plain version and its bound.
14. skipgram -- bench.py --config word2vec: Word2Vec skip-gram with negative
               sampling (min frequency 5, layer 100, window 5, 5 negatives,
               sampling 1e-3, batch 8192, seed 42, 1 epoch) over phase 8's
               4,000,000-word corpus, cold and warm. Gates: B 8190 pairs per
               round, S 87,360 positions and C 876,330 pairs per block;
               rounds = sum of ceil(count / B) over the blocks, with each
               block's count as the card computed it; one count readback
               per block; no embedding_bag launch; finite tables on the
               card; the last loss below the first block's. Then the
               cluster corpus on the card, gated as tests/test_nlp.py:255.
15. word2vec-hs -- skip-gram and CBOW with hierarchical softmax at
               bench.py's word2vec-hs hyperparameters on the corpus's first
               400,000 words (HS rounds hold 128 pairs: the corpus is cut,
               not the widths). Gates: 128 pairs or centers per round,
               rounds as in phase 14 (skip-gram) or one f32 embedding_bag
               launch per round (CBOW), finite tables; the cluster corpus
               gates of tests/test_nlp.py:282 and :301 on the card.
16. cbow-bf16 -- the word2vec-cbow configuration on bf16 tables: 384 launches
               of the bag's bf16 route per fit (one per round), finite
               tables, the last loss below ln 2; the cluster corpus on bf16
               tables (CBOW, and skip-gram as tests/test_nlp.py:268), gated
               at 0.3.
17. paragraph-vectors -- PV-DBOW (with the skip-gram word pass) and PV-DM at
               layer 100, window 5, 5 negatives, sampling 1e-3, batch 8192
               on the first 400,000 words as 20,000 documents labelled
               DOC_i: documents/s and words/s; PV-DM launches the bag (2W +
               1 = 11 columns) once per round. Then the document-cluster
               and infer_vector gates of tests/test_nlp.py:426-460 on the
               card.

18. samediff-bert -- bench.py --config bert (BASELINE.json configs[2]) at
               full width and depth, nothing cut: the BERT-base frozen
               GraphDef (hidden 768, 12 layers, 12 heads, FF 3072, vocab
               30522, 512 positions, batch 32, T 128) written by the port
               (imports/tf_fixtures.py, no TensorFlow), imported on the
               card (import_frozen_tf), 199 frozen tensors of 109,187,328
               elements promoted and a [768, 3] head grafted on; served
               (sd.output of the pooled output, 2 warm-ups, 20 timed
               batches: sequences/s, p50/p99) and fine-tuned through
               SameDiff.fit on dict batches (Adam(2e-5), float32, TF32 off;
               2 warm-ups, 10 timed steps each ended by a synchronize:
               samples/s, step median/p10/p90, peak memory, first and last
               loss; the loss finite and falling); every kernel count 0 on
               this path (profile_port.py --bert breaks the step down). Then
               the card against the CPU at full width, 2 layers, batch 2,
               from the same bytes (SD_PARITY): the pooled output, the loss
               and every gradient; that 2-layer graph saved and loaded
               on the card, the pooled output bitwise ([samediff-save]).

19. w2v-host -- the host pair path (device_corpus = False) at phase 14's
               hyperparameters on the corpus's first 400,000 words: the
               native helper built with g++ first (a failed build fails the
               run), then skip-gram (pairs from native.sg_pairs), CBOW and
               PV-DM on 20,000 documents. Gates: the helper made the
               skip-gram pairs; 64 rounds per block; no bag launch for
               skip-gram and one per CBOW and PV-DM round; finite tables on
               the card; skip-gram's last loss below its first block's
               (CBOW's and PV-DM's examples fit one flush, made after the
               producer consumed every word, so it trains at
               min_learning_rate: the gate is a loss below ln 2 and a
               trained syn1neg); then the host-path gates of
               tests/test_nlp.py (skip-gram clusters, :312, :592) on the
               card. Prints words/s and the consumer's wait on the producer.
20. fasttext -- bench.py --config fasttext (400,000 words, min frequency 5,
               layer 100, window 5, 5 negatives, 1 epoch, batch 8192, seed
               42, bucket 100,000, minn 3, maxn 6): one cold fit as it
               stands, logged and not gated (without subsampling it reaches
               NaN, as the JAX package does); then with fastText's default
               subsampling t = 1e-4, cold and warm. Gates: tables [V +
               100,000, 100]; one embedding_bag launch per round, each on
               the round's [8190, G] bags of that table; finite tables; the
               loss falling; bucket rows trained; the cluster, OOV and
               subword-cluster gates of tests/test_nlp_breadth.py on the
               card. Then the bag bitwise against its plain version (mean
               and sum) and timed, beside its bound, at the path's [8190,
               15] x [108163, 100] (corpus centers' subword rows) and at
               G = 39 (words of 3 to 11 letters).
21. glove   -- bench.py --config glove (1,000,000 words, min frequency 5,
               layer 100, window 5, 5 epochs, batch 8192, seed 42, x_max
               100, alpha 0.75, lr 0.05): words/s with and without the host
               co-occurrence count, rounds, losses. Gates: finite tables on
               the card, the last loss below the first block's, the cluster
               gate of tests/test_nlp_breadth.py:47 on the card.
22. deepwalk -- DeepWalk at BlogCatalog's published setting (Perozzi et al.
               2014, section 6: 10,312 vertices, 333,983 edges, 39 groups;
               walk length 40, window 10, dimension 128) on a seeded
               stochastic block model of that size, walks per vertex CUT
               from 80 to 2 (the walk sampler is a Python loop). Walk time
               and the fit's words/s apart. Gates: within-group cosine above
               across-group, half of each vertex's 10 nearest from its
               group; then Node2Vec (p 0.5, q 2) on the two-community graph
               of tests/test_nlp_breadth.py:145, gated as there.
23. serializer -- phase 19's skip-gram and phase 20's FastText written as
               text, binary and the model zip and read back onto the card:
               binary and zip bitwise with the same nearest words, text
               within its six digits; a fit resumed from the skip-gram zip
               starts below the first fit's first block's loss.

24. zoo-cnn -- the twelve CNNs of the zoo at their published defaults, in
               full width and depth (SimpleCNN 48x48, AlexNet 227x227,
               VGG19, SqueezeNet and Darknet19 224x224, UNet 128x128,
               Xception 299x299, InceptionResNetV1 160x160,
               FaceNetNN4Small2 and NASNet 96x96, TinyYOLO and YOLO2
               416x416), each with its own updater, bf16 compute over
               float32 master parameters and fused_update, on seeded pixels
               in [0, 1] with one-hot labels, binary masks (UNet) or boxes
               in the YOLO label format: 2 warm-ups and 5 timed fit(ds)
               steps at batch 16 (images/s, step median; VGG19 at learning
               rate 1e-3: at its published 0.01 it reaches NaN within 5
               steps at this batch, in float32 as in bf16, which is logged
               first and not gated), then one served
               output of 16 images with fused_epilogue on. Gates: finite
               losses, 1 fused_update launch per step, outputs finite and of
               the JAX model's shape, bn_act launches per served forward
               equal to the count read off the configuration (BN layers
               with relu or identity, alone or heading a BN -> add -> relu
               chain; Darknet19's and the YOLOs' BNs are leakyrelu and stay
               dense). Then each model at the JAX tests' reduced sizes,
               TF32 off, deterministic cuDNN, batch 2: the card against the
               CPU from the same seeded weights, the served output in
               float32 within 1e-4 of its scale, and from BN statistics set
               to the batch's own one fit step in float64 (in float32 it is
               ill-conditioned at these sizes; zoo_cpu_parity says why):
               loss and BN statistics within 1e-4, every parameter whose
               step is decided (gradient above 1% of its leaf's largest and
               1e-5 of the model's, the same sign on the card) within 1e-4
               of its leaf's scale, at most 1e-5 of the parameters with a
               significant gradient of the other sign on the card, every
               parameter finite; and SimpleCNN
               fused against per-leaf for 3 steps, parameters and Adam's
               moments within 2 float32 ulp.

25. sequences -- the zoo's TextGenerationLSTM at full width (two LSTM(256)
               layers, a softmax RnnOutputLayer with mcxent over the
               character set, Adam(2e-3)) trained through
               MultiLayerNetwork.fit with truncated BPTT of 50 steps over
               sequences of 1,000 characters at batch 32 (the sequence and
               truncation lengths of dl4j-examples'
               LSTMCharModellingExample), float32, fused_update, on the
               characters of the repository's README.md and SURVEY.md
               one-hot: 1 warm-up and 3 timed batches (characters/s, batch
               median, peak memory). Gates: 20 segments and 20
               fused_update launches per batch, no fallback, one iteration
               per batch, finite losses, and a fixed 50-character segment's
               loss lower after the 4 batches than before them. Then
               streaming: 100 characters primed and 200 generated one
               rnn_time_step each (ms per character); rnn_time_step in
               chunks of 10 against output over 100 steps within rtol
               1e-5, atol 1e-6. Then the card against the CPU, TF32
               off: one TBPTT batch of 150 steps of the full-width model
               (in float64 through the per-leaf Adam: text_parity says
               why), and in float32 a MaskingLayer + Bidirectional(LSTM) + GRU +
               LastTimeStep(GRU) classifier fit through an iterator of two
               zero-padded batches of variable lengths (TBPTT 10 over T
               40: one fused_update launch per segment), every parameter
               within 1e-4 of its leaf's scale; and a forward and a
               backward of each 1D and 2D shape layer within 1e-5.

26. transfer -- zoo VGG16 at its published widths (138,357,544 parameters)
               written as a model zip into a temporary pretrained cache
               (DL4J_TPU_PRETRAINED_DIR) and read back through
               VGG16().init_pretrained(), bitwise; re-headed as
               dl4j-examples' EditLastLayerOthersFrozen does it
               (TransferLearning: FineTuneConfiguration with Nesterovs(5e-5)
               and seed 12345, set_feature_extractor through fc2, the
               1000-way head replaced by a 5-class xavier softmax):
               134,281,029 parameters, 20,485 trainable; fit at batch 15
               (the example's) in bf16 compute with fused_update on seeded
               pixels in [0, 1]: 2 warm-ups, 5 timed steps each ended by a
               synchronize (images/s, step median, p10, p90, peak memory).
               Gates: 1 fused_update launch per step over the whole bucket
               (frozen ranges included), the frozen parameters bitwise
               unchanged (a checksum before and after), the head's loss on
               the batch lower after the steps. TransferLearningHelper:
               featurize 4 batches through the frozen bottom (images/s),
               fit_featurized the head, the full model's output equal to
               the top network's over the features within 1e-5. The card
               against the CPU from the same zip, float32, TF32 off, batch
               2: one step with the same injected dropout masks (the frozen
               dense layers drop out in fit), parameters within 1e-4 of
               their scale. Last the zoo SimpleCNN re-headed the same way
               (convolution stack frozen) served with fused_epilogue on: 3
               bn_act launches per forward through the FrozenLayer-wrapped
               BNs, the card against the CPU within 1e-4.
27. pretrain, capsnet, layers -- a VariationalAutoencoder at dl4j-examples'
               VaeMNISTAnomaly widths (784, encoder 256-256, 32 latents,
               decoder 256-256, Bernoulli, leakyrelu, Adam 1e-3, l2 1e-4)
               pretrained one epoch of the synthetic MNIST fallback at
               batch 128 (samples/s, the negative ELBO first and last; it
               must fall), then the card against the CPU over 2 batches
               with injected eps (1e-4). CapsNet at Sabour et al. (2017)'s
               widths (conv 256 9x9, 1,152 primary 8-D capsules, 10 routed
               16-D capsules, 3 routings, lengths, softmax, negative
               log-likelihood), Adam(1e-3) through fused_update at batch 32:
               2 warm-ups, 5 timed steps (1 launch per step), then its
               output, loss and gradients on the card against the CPU
               (1e-4). Every other new layer class at its CPU test's size,
               and C3D's first two blocks (Tran et al. 2015) on [4, 3, 16,
               112, 112] with a 101-way head (UCF101), on the card against
               the CPU: the forward and one SGD step with the same injected
               draws, within 1e-4 of their scale.
28. remat   -- phase 6's ResNet-50 training (bf16, fused_update, bf16
               state) at batch 128, 3 steps under each rematerialization
               policy ("none", "full", "dots_only",
               "checkpoint_dots_with_no_batch_dims", and the selective list
               [stem_bn, s0b0_bn1]), deterministic cuDNN: peak device memory
               and step median per policy; gates: "full" peaks below "none",
               losses and parameters within 1e-6 of the "none" run's
               (whether bitwise is printed); then the TextGenerationLSTM's
               TBPTT batch under "full" against "none", the same way.

29. disk    -- ResNet-50 (phase 6's: bf16, fused_update, bf16 state) at
               batch 64 trained from 768 synthetic JPEGs of 224x224 in ten
               class folders (bench.py's resnet50-disk): ImageRecordReader
               (PIL, os.cpu_count() decode threads) ->
               RecordReaderDataSetIterator -> AsyncDataSetIterator(queue 8,
               device_prefetch: pinned memory, a copy stream, an event);
               one warm-up and 10 timed fit(ds) steps. Prints images/s,
               step median/p10/p90, the wait on the queue per step, the
               decode workers, the decoder, peak memory. Gates: 1
               fused_update launch per step, finite losses, the first
               batch bitwise the decoder's pixels / 255.
30. container -- the same images as uint8 [3, 224, 224] + int32 labels in
               the pre-decoded container (chunks of 64, written under a
               temporary name, then renamed), read by
               BinaryRecordDataSetIterator(raw_numpy) -> AsyncDataSetIterator
               with uint8 -> float32 / 255 on the card (bench.py's
               resnet50-predecoded); the same figures. Gates: the card's
               features bitwise numpy's; one step from the pipeline's
               batch bitwise the same batch given as a DataSet
               (deterministic cuDNN); fit(iterator, host_prefetch=4)
               bitwise host_prefetch=0 on ResNet-50 (3 steps) and LeNet
               (one epoch).
31. telemetry -- ResNet-50 at batch 64: the step time without telemetry,
               with TelemetrySink and with NanSentinelListener("skip") too,
               in turns; then 8 steps through fit(iterator) whose third
               batch holds a NaN, under NanSentinelListener("skip", 4) and
               TelemetrySink(InMemoryStatsStorage, 4), every step off a
               drain boundary under torch.cuda.set_sync_debug_mode("error").
               Gates: the poisoned step's parameters, moments and BN
               statistics bitwise the pre-step ones, the next step trains,
               skipped_updates 1 at that iteration only. The guard on phase
               26's re-headed VGG16 (frozen ranges) runs in phase 26
               (``[transfer] NaN guard``); here one TextGenerationLSTM
               TBPTT batch with a NaN in its 11th segment (one segment
               skipped, finite parameters) and the device kernels
               telemetry adds per segment.
32. early-stopping -- EarlyStoppingTrainer on LeNet over the synthetic
               MNIST fallback (MaxEpochs(5), ScoreImprovement(2),
               DataSetLossCalculator, LocalFileModelSaver): epochs, best
               epoch, reason; the best model reloads bitwise. Then phase
               29's model served (fused epilogue) over two batches of the
               container's images into ROCMultiClass, EvaluationCalibration
               and Evaluation: 53 bn_act launches per forward, the metrics
               equal numpy's on the host.

33. onnx-resnet50 -- ResNet-50 at torchvision's widths (25,557,032
               parameters; seeded weights, BN statistics not the identity)
               written as an ONNX model (opset 17, the exporter's
               Conv/BatchNormalization/Relu/MaxPool/Add/GlobalAveragePool/
               Flatten/Gemm; ``import_fixtures.py``, the port's own writer)
               and imported from its 102 MB of bytes with import_onnx on the
               card (batch 32): 20 timed batches after 3 (images/s,
               p50/p99); the card against the port on the CPU on the same
               bytes at batch 2 (max |err| within 1e-4 of the largest
               |logit|, TF32 off); convert_to_variables, softmax
               cross-entropy, Adam(1e-3), 5 steps (step median, peak
               memory; finite losses, the last below the first).
34. onnx-encoder -- the pre-LN encoder of tests/test_onnx_deep_models.py at
               BERT-base's widths (12 blocks, D 768, 12 heads, FF 3072, T
               128; 85,057,540 parameters, 340 MB): import, serve at batch
               32 (sequences/s, p50/p99), the card against the CPU at batch
               2 (1e-4), 3 fine-tune steps at Adam(2e-5) (finite losses).
35. tf-resnet50 -- phase 33's weights as a frozen NHWC GraphDef (Conv2D,
               FusedBatchNormV3, Relu, MaxPool, Pad, AddV2, Mean, MatMul,
               BiasAdd) through import_frozen_tf on the card: its logits
               within 1e-4 of the largest |logit| of phase 33's.
36. samediff-kernels -- SameDiff's kernel ops on the card: sd.nn.
               multi_head_dot_product_attention at [32, 128, 768], 12 heads,
               a padding mask, in bf16 and float32 (exactly one
               flash_attention launch per call, on attention/flash_bf16 and
               attention/flash_f32; within 2^-8 |want| + 2e-5 and 2e-5 of
               the dense path in float32); the flash_attention op, causal,
               [4, 12, 512, 64] (1 launch, 2e-5 of its plain version); the
               embedding_bag op at [8192, 10] x [10000, 100] (1 launch,
               bitwise its plain version).
37. keras-resnet50 -- keras.applications.ResNet50(weights=None) as Keras 3
               writes it to a legacy .h5 (177 layers, 25,636,712 values,
               about 103 MB; ``import_fixtures.py``'s HDF5 writer, seeded
               weights), imported with KerasModelImport through the port's
               HDF5 reader onto the card (the first and a second import
               timed), served at batch 32 with the fused epilogue (20 timed
               batches after 3: images/s, p50/p99; bn_act launches per
               forward gated at one per BatchNormalization, 53, and those
               that add the residual at 16, the block tails), the card
               against the port on the CPU at batch 2 (1e-4 of the largest
               output),
               fused against unfused on the card (1e-4), then Nesterovs
               (1e-3, 0.9) with fused_update on the imported graph: 5 steps
               at batch 32, one fused_update launch each (step median, peak
               memory, finite losses).
38. keras-lstm -- keras-io's character LSTM (Input((40, V)), LSTM(128),
               softmax Dense(V); V the characters of phase 25's corpus) as
               a Keras 3 .keras zip into a MultiLayerNetwork on the card:
               the forward against the CPU at batch 128 (1e-4), 5 steps of
               Adam(2e-3) with fused_update, one launch each.
39. samediff-control-random -- a SameDiff graph with a cond and a
               while_loop(max_iters=8), trained 5 steps on the card and on
               the CPU in float64 (losses and variables within 1e-9
               relative); an unbounded while_loop forward; each of the 13
               random ops through SameDiff on the card from a seeded device
               generator, 2^20 draws each: shape, dtype, device, mean and
               variance within 6 standard errors of the distribution's
               (the truncated normal's variance at two standard deviations
               about 0.7737), multinomial rows against their logits,
               dropout_bp's zeros at its rate; an NDArray view write on the
               card reaches its base.
40. parallel-resnet50 -- full-size ResNet-50 trained by ParallelWrapper
               with four replicas on the one card (``Builder.devices``),
               global batch 64 (16 a replica), fused_update on: (a) float32
               Nesterovs state, 5 steps dense and 5 ZeRO-1
               (ReduceScatterAccumulator) from the same parameters and
               batches, deterministic cuDNN: losses and parameters bitwise
               equal, 4 fused_update launches a step in each layout, ZeRO-1's
               updater state a quarter (plus its padding) per replica by
               the tensors, the zero1/* counters and memory_allocated around
               the replicas' build; the variant (vector or scalar) each
               replica's launch takes. A ZeRO-1 slice's launch timed beside
               the whole bucket's (Nesterovs, bf16 state) and its bound.
               (b) bf16 compute and state, 2 + 10 steps solo (model.fit at
               batch 64), dense and ZeRO-1: images/s, step median, peak
               memory, launches; after the steps every replica's parameters
               (and, dense, updater state) bitwise the same. Four replicas
               share one card: images/s is the wrapper's cost against the
               solo fit, not a scaling figure. (c) two replicas, batch 8
               at 64x64, two steps on the card and on the CPU from the
               same parameters, float64 at Nesterovs 1e-3 (the per-leaf
               updater), BN statistics set to the batch's own, TF32 off:
               after the first step the parameters within 2e-3 of their
               largest magnitude; the second step's difference reported
               and held below its own size (PW_CPU_REL_TOL says why).
41. parallel-encoded-elastic -- LeNet (bench.py's elastic smoke data: 8
               batches of 64) with EncodedGradientsAccumulator(
               AdaptiveThresholdAlgorithm()) at four replicas: the encode
               density and the collective ledger after an epoch; stopped 3
               steps into epoch 2, resize(3, lost_replicas=[1]): the
               residual rows folded bitwise (survivors 0, 2, 3; row 1 added
               onto row 0), their sum within 2 ulp; continued with
               fit(resume_cursor=) to the end, grown back to 4 for an
               epoch; finite losses; launches per replica per step. Then a
               ZeRO-1 checkpoint written at 4 replicas (every 3 steps,
               stopped after 5) resumed at 2 in ZeRO-1 and dense: bitwise
               the same losses and parameters.
42. parallel-integrity -- LeNet, four dense replicas, IntegrityListener
               every 2 steps: bit 12 of replica 2's copy flipped after step
               5 (apply_bitflip); caught at iteration 7 and attributed to
               replica 2, the step discarded on every replica (their
               digests as before it); resize(3, lost_replicas=[2]) and the
               continuation bitwise equal to a fresh 3-replica run handed
               the survivors' state; a digest on the card equals the same
               bytes' on the host.
43. serving-tier -- full-size ResNet-50 (224x224x3, 1000 classes, bf16,
               fused epilogue) served by ServingEngine over the ladder 1-32
               with 2 workers pinned to two slots on the card, max_wait 2
               ms, resurrection after 100 ms, SLO classes gold / silver /
               batch. (a) trace/serving_infer = 6 x 2 after warmup and flat
               to the end (serving/traces_after_warmup 0), warmup seconds
               per bucket; requests of 1, 3, 5, 8, 13, 32 images bitwise the
               served forward of their padded bucket, sliced, and within
               SV_UNPADDED_BOUND of the unpadded forward; 40 images split 32
               + 8 in order, refused under a reject ladder. (b) the closed-
               loop images/s of 8 clients (1-8 images a request), then an
               open-loop Poisson load at 70% of it (p50/p99, images/s, fill
               ratio, pad waste; nothing fails), one dispatch's parts, and a
               replica killed mid-load (nothing fails, a requeue, the pool
               back to 2). (c) a class-mixed overload made deterministic by
               a slow dispatch fault: no gold shed, batch first, one level
               a step, Retry-After within [0.1, 30] s. (d) the autoscaler
               (1-4 workers) up on a backlog, down when idle, no new
               warmup. (e) two fused_update steps committed by
               CheckpointListener; a forced serving/promote violation rolls
               back bitwise, a publication promotes with every slot's
               fingerprint the checkpoint's as cast, both pub<N> chains in
               the flight recorder; a flipped byte quarantined by the
               scrubber and skipped by last_checkpoint(require_scrubbed).
               (f) UIServer: POST /api/infer bitwise engine.output, 413 /
               400 / 429 with Retry-After, /api/health and /api/metrics.
               bn_act 53 launches a bucket forward over the phase, no
               fallback.
44. fused-update-members -- the member-batched route of fused_update
               (one launch over a contiguous [M, N] bucket, a rate per row
               and a live mask) for sgd, nesterovs and adam, float32 and
               bf16 state, at [4, 431,080], [4, 25,557,032], [3, 4097] and
               [2, 1], row 1 masked: within 2 f32 ulp of its plain version
               (bf16 moments bitwise), every row bitwise the single-bucket
               kernel on it with its rate, the masked row unchanged; then
               timed at the sweep's [8, 431,080] and at [4, 25,557,032]
               beside its plain version, the single-bucket kernel launched M
               times, torch.optim.SGD(nesterov, fused) over M parameter
               groups, and the bandwidth bound.
45. fleet-sweep -- FleetTrainer.from_sweep over LeNet at full width, 8
               learning rates around 0.01, batch 64 a member, synthetic
               MNIST, 20 timed steps: one member-batched launch a step and
               no single-bucket launch, member 3 bitwise its solo twin, no
               stacked buffer reallocated after step 1, the card within
               1e-4 of the CPU after 3 steps; images/s, step median, p10,
               p90, the member passes' host time against the step's device
               time, peak memory; the same 8 members as 8 solo fits, in
               turns with the fleet.
46. fleet-lifecycle -- on fleet-smoke's 64-32-10 MLP and on LeNet: a NaN in
               member 5's batch under "skip" (the others bitwise a clean
               run) and "cull" (its alive bit dropped, its row frozen); cull
               then spawn without reallocation; FleetEarlyStop culling from
               the drained window; save_member restored into a solo network
               continuing bitwise; save/restore of the whole fleet
               continuing bitwise; the best member's checkpoint canaried and
               promoted on a live ServingEngine, its params bitwise the
               checkpoint's.
47. fault-sites -- a FaultPlan with device/loss at dispatch 2 of a LeNet
               fit raises DeviceLostError naming replica 1 and counts
               faults/device/loss/device_loss; phase 42's bit flip driven
               through the integrity/fingerprint site, caught at iteration 7
               and named replica 2.
48. rl      -- FleetDQNPopulation, 8 members on the in-process CartPole
               (a learning-rate sweep), 300 environment steps: one
               member-batched launch per TD step; QLearningDiscreteDense
               with one fused_update per TD step; A3C and async n-step Q on
               SameDiff networks, two workers, 400 steps each; finite
               losses, counted steps and episodes.
49. pipeline -- the 12-block SelfAttentionLayer(768, 12 heads) stack
               (BERT-base's attention widths) at T 128, batch 32, through
               PipelineTrainer(4 stages, 8 microbatches) on ["cuda:0"] * 4
               with bf16 compute and Adam(2e-5): 5 steps under 1F1B, under
               GPipe and as a single-slot microbatched fit, losses and final
               parameters bitwise across the three; flash_attention.cu
               (bf16 route) launched 12 x 8 x 2 = 192 times a step (forward
               and recompute), the kernel against its plain version at the
               stage shape [4, 12, 128, 64]; step median/p10/p90, samples/s,
               the ledger's bubble against (S-1)/(M+S-1), peak memory; the
               card (float32, TF32 off) against the CPU (float64) at the
               same configuration, 2 Sgd steps.
50. kill-a-stage -- bench.py's pipeline-parallel-smoke stack (12 x Dense
               32, 4 stages x 2 data, M 8, batch 64): a pipeline/stage
               device_loss mid epoch 2, remap(3), the fit continued from the
               cursor: no microbatch lost, the losses after it bitwise a
               fresh 3-stage run's, one build per (stage count, schedule).
51. vgg16-pipeline -- zoo VGG16 cut into 4 stages by pipeline_from_mln(
               cuts=...), forward at batch 16 against model.output (1e-4
               of the largest output, float32), 3 train_steps.
52. sharded-word2vec -- Word2Vec(mesh=make_mesh(data=1, model=4)) at bench.py
               --config word2vec: one block's tables within 1e-6 of the
               unsharded block's, cold and warm fits beside phase 14's
               (last loss within 2%), the cluster gates.
53. tensor-parallel -- apply_tp over 2 slots on zoo VGG16's forward at batch
               16 (1e-5 of the largest output, float32); ParallelWrapper
               workers(8).model_axis(4) on the embedding model of
               tests/test_parallel_extras.py:203 against its replicated
               run, 3 steps, 1e-3.
54. ring-attention -- ring_self_attention at F 768, 12 heads, T 4096 over 4
               slots, batch 2, causal and not, against dense attention
               (2e-5 + 1e-4 |dense|) and its gradients (1e-4 of their
               largest |value| + 1e-3 |dense|), ms per call beside the
               dense op's.

55. supervised-resnet50 -- ResNet-50 as bench.py trains it (bf16 compute,
               Nesterovs with fused_update, bf16 state), batch 32, a
               shuffled seeded iterator of 6 batches, 2 epochs, under
               TrainingSupervisor(save_every_n_iterations=2): a train/step
               crash at dispatch 5 and a train/wedge hang (watchdog 3 s)
               each heal by checkpoint-restart with losses, parameters, BN
               statistics and momentum bitwise an unsupervised fit's and
               one fused_update launch per dispatched step (replays
               included); a preempt fault's real SIGTERM gives a
               "preempted" result and a second fit(resume="auto") finishes
               bitwise; the step medians of the plain fit, the plain fit
               with a CheckpointListener at the same cadence and the
               supervised fit, in turns; the checkpoint's bytes, snapshot
               ms and commit seconds.
56. supervised-elastic -- ResNet-50 on 4 replicas of one card (ZeRO-1,
               batch 64): a device/loss of replica 2 at dispatch 3 shrinks
               to 3 replicas in memory, bitwise a fresh 3-replica wrapper
               resumed from the same state and cursor; a loss at dispatch 1
               shrinks and the grow-back probe rejoins the slot; LeNet's
               flipped bit on replica 2 quarantined (the check names it).
57. supervised-pipeline -- phase 49's stack under the supervisor: a
               pipeline/stage loss of stage 1 at dispatch 2 remaps 4 -> 3
               stages with no microbatch lost, the losses after it bitwise
               a fresh 3-stage run's from the cursor, 192 bf16 flash
               launches a step; a 2-stage pipeline's loss is refused by the
               remap gate and healed by checkpoint-restart, bitwise.
58. process-group -- supervise_processes launches 2 ranks of this script
               (--group-worker) on the card over gloo; each rank runs
               distributed.initialize and SharedTrainingMaster with
               ResNet-50, batch 32 a rank, 8 steps, a group commit every 3;
               rank 1 exits at step 5 in attempt 0, the group is reaped and
               relaunched from the step-3 commit, and both ranks' final
               parameters are bitwise an uninterrupted 2-rank run's, with
               one fused_update launch a rank a step; a barrier names the
               missing rank with its heartbeat staleness; a dead
               coordinator fails inside its 3 s deadline with the whole
               diagnosis; no process of the run survives (a sweep of the
               process table for the run's token). Prints rank 0's steady
               step time (no commit in it) and the exchange's share of it
               (staging, the wait for the peer, the all_gather; the drain
               of the rank's queued work apart), the steps with a group
               commit and the first step.
59. observed-resnet50-fit -- ResNet-50 as bench.py trains it (bf16 compute,
               Nesterovs with fused_update, bf16 state), batch 32, 10
               steps through ComputationGraph.fit with the executable census
               on (common/xprof.py) and a StatsListener collecting every 4
               iterations: graph/fit_step one generation after the first
               step and one call a step; pallas/update_bucket's analytic
               bytes for 25,557,032 elements (16 B each) and one
               fused_update launch a step; steps 3-10 in a steady_state
               region (common/tracecheck.py) with no compile, no trace/*
               delta and no more synchronizing CUDA calls than the
               listener's counted readbacks; a batch of 16 inside a second
               region raises SteadyStateViolation; the fit watermark above 0
               and under max_memory_allocated; the census's flops for one
               step exactly 16 x FlopCounterMode's count of the same step on
               the CPU at batch 2. Prints, with no limit, the census's cost
               in turns (on, off, five each) and the roofline row with its
               MFU against 989 TFLOP/s from the fenced step median.
60. observed-serving -- phase 43's ResNet-50 behind ServingEngine (bf16,
               two slots, the ladder 1-32) under the census, the default SLOs
               and a gold p99 SLO (1 s over a 2 s window) on a watchtower
               evaluating every 0.1 s: serving/bucket one variant a (shape,
               slot) after warmup and a serving_warmup watermark; a
               closed-loop burst (4 clients x 10 gold requests) inside a
               steady_state region with no new generation, trace/serving_infer
               flat and 53 bn_act launches a bucket forward; an overload
               burst (+1.2 s a dispatch) pages the p99 SLO, whose incident
               GET /api/incidents and ?id= serve, with a dl4j_alert_state
               row of 2 in /api/metrics and last_incident in /api/health;
               after the load, manual evaluations clear the page on the
               clear_ticks-th; the incident's chain starts at the injected
               fault and the page (printed whole).
61. observed-supervisor -- phase 55's supervised ResNet-50 at one epoch of 6
               batches of 32, a train/step crash at dispatch 3, a watchtower
               installed: one incident whose chain runs cause -> detection
               -> mitigation -> recovery; memcensus.json beside
               blackbox.jsonl with the card's allocator figures; the healed
               run bitwise the unsupervised one; a StatsListener into a
               TensorBoardStatsStorage writes event files whose scores
               read back as float32. Prints CrashReportingUtil's report
               (its totals) at batch 32 beside the card's measured peak.

Then it prints the kernels line (one JSON object) and, last, the device line
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, it exits nonzero and prints no result. Weights are random, made
from a seed; for serving, BN statistics are calibrated on a seeded batch and
perturbed (see deeplearning4j_tpu_torch/util/calibrate.py for why).
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 1234
BATCH = 32
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM TF32 tensor cores, dense
TIMED_RUNS = 30
WARMUP_RUNS = 5
SPIN_CYCLES = 4_000_000             # about 2 ms at the H100's 1.98 GHz
TRAIN_BATCH = 128
IMAGE = 224
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
RESNET50_PARAMS = 25_557_032        # elements of the one float32 bucket
W2V_VOCAB = 10_000                  # bench.py --config word2vec-cbow
W2V_WORDS = 4_000_000
W2V_ROUNDS_PER_FIT = 384            # 6 blocks of 64 rounds
# BERT-base (google-research/bert uncased_L-12_H-768_A-12/bert_config.json)
BERT = {"vocab": 30522, "positions": 512, "hidden": 768, "layers": 12,
        "heads": 12, "ff": 3072}
BERT_PARAMS = 108_854_786           # read off the configuration below
SEQ_LEN = 128
ENC_BATCH = 32
ENC_WARMUP = 3
ENC_TIMED = 20
FA_PATH = (ENC_BATCH * 12, SEQ_LEN, 64)   # B*H, T, D of one encoder layer
FA_LONG = (8 * 12, 512, 64)               # BERT's 512 positions


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --- phase 1 -------------------------------------------------------------------

def phase_device():
    from deeplearning4j_tpu_torch.common.environment import Environment

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    smi = r.stdout.strip().splitlines()[0].strip()
    log(smi)
    env = Environment.get()
    env.set_tf32(False)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}; "
        f"tf32 {env.tf32_flags()}")
    return smi, name


# --- phase 2 -------------------------------------------------------------------

def phase_build(names=None):
    """Build every csrc/*.cu (or the named sources), all at once."""
    from deeplearning4j_tpu_torch.ops import cuda_lib

    if names is None:
        names = sorted(p.stem for p in cuda_lib.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    times = cuda_lib.build(names, force=True)
    wall = time.perf_counter() - t0
    for n in names:
        lib = cuda_lib.load(n)
        check(lib is not None, f"{n} did not load")
        text = cuda_lib.BUILD_LOGS.get(n, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(v) for v in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", text))
        log(f"[build] {n}: {times[n]:.2f} s; -Xptxas -v: {len(regs)} "
            f"kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)} per thread, {spills} bytes spilled")
    log(f"[build] {len(names)} source(s) in {wall:.2f} s (parallel nvcc)")
    return names


# --- phase 3 -------------------------------------------------------------------

def main_path_bn_cases(batch: int):
    """(shape, act, residual) of every bn_act launch one ResNet-50 forward
    makes at ``batch``, read off the model's own configuration."""
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    conf = ResNet50(num_classes=1000, image_size=224).conf()
    cases = set()
    for name in conf.order:
        node = conf.nodes[name]
        if node.kind != "layer" or not isinstance(node.layer,
                                                  L.BatchNormalization):
            continue
        t = conf.node_output_types[name]
        shape = (batch, t.channels, t.height, t.width)
        if name.endswith("_bn3"):           # the fused block tail
            cases.add((shape, "relu", True))
        else:
            cases.add((shape, node.layer.activation, False))
    return sorted(cases)


def bn_launch_cases(conf, batch: int):
    """{(shape, act, residual): launches} of one served forward of a
    configuration with fused_epilogue on: every BN layer with relu or
    identity, the heads of ``BN(identity) -> add -> relu`` chains as one
    residual relu launch (for ResNet-50, the ``_bn3`` block tails)."""
    from collections import Counter

    from deeplearning4j_tpu_torch.nn.conf import layers as L

    out = Counter()
    if hasattr(conf, "nodes"):
        items = [(n, conf.nodes[n].layer, conf.node_output_types[n])
                 for n in conf.order if conf.nodes[n].kind == "layer"]
    else:
        items = list(zip(range(len(conf.layers)), conf.layers,
                         conf.layer_output_types))
    for name, layer, t in items:
        act = (getattr(layer, "activation", None) or "identity").lower()
        if not isinstance(layer, L.BatchNormalization) \
                or act not in ("relu", "identity"):
            continue
        shape = (batch, t.channels, t.height, t.width)
        tail = isinstance(name, str) and name.endswith("_bn3")
        out[(shape, "relu" if tail else act, tail)] += 1
    return out


def _inputs(shape, dtype, residual, dev, gen):
    C = shape[1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    res = (torch.randn(shape, generator=gen, device=dev).to(dtype)
           if residual else None)
    mean = torch.randn(C, generator=gen, device=dev) * 0.1
    var = torch.rand(C, generator=gen, device=dev) * 1.5 + 0.5
    gamma = torch.randn(C, generator=gen, device=dev) * 0.1 + 1.0
    beta = torch.randn(C, generator=gen, device=dev) * 0.1
    return x, res, (mean, var, gamma, beta)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(v.abs())          # v = m * 2**e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(v), e - 8)


def compare_bn_act(shape, act, residual, dtype, dev, gen):
    from deeplearning4j_tpu_torch.ops import epilogue

    x, res, stats = _inputs(shape, dtype, residual, dev, gen)
    scale, shift = epilogue.fold(*stats)
    got = epilogue.bn_act_cuda(x, scale, shift, res, act).float()
    want = epilogue.bn_act_reference(x, scale, shift, res, act).float()
    torch.cuda.synchronize()
    max_err, ok, tol_s = _bn_act_within_tolerance(got, want, x, scale, shift,
                                                  res, dtype)
    check(ok, f"bn_act {tuple(shape)} {act} res={residual} {dtype}: "
              f"max_abs_err {max_err} not {tol_s}")
    return max_err


def _bn_act_within_tolerance(got, want, x, scale, shift, res, dtype):
    """(max_abs_err, within the tolerance, the tolerance in words) of the
    kernel's output ``got`` against the plain version's ``want`` (both
    upcast to float32) on the inputs x, scale, shift and res."""
    err = (got - want).abs()
    max_err = err.max().item()
    if dtype == torch.float32:
        # fmaf against two roundings: 2 ulp of the output scale
        tol = 2.0 ** -22 * (want.abs().max().item() + 1.0)
        ok = max_err <= tol
        tol_s = f"<= {tol:.3g} (2 f32 ulp of the output scale)"
    else:
        # both round once to bf16 from f32 values that differ by the
        # kernel's fmaf (at most 2 f32 ulp of the terms' magnitude), so
        # they differ by at most that plus 1 bf16 ulp, elementwise
        terms = (x.float() * scale.reshape([1, -1] + [1] * (x.ndim - 2))).abs() \
            + shift.abs().reshape([1, -1] + [1] * (x.ndim - 2))
        if res is not None:
            terms = terms + res.float().abs()
        tol = _bf16_ulp(torch.maximum(got.abs(), want.abs())) \
            + 2.0 ** -22 * terms
        ok = bool(err.le(tol).all())
        tol_s = "<= 1 bf16 ulp + 2 f32 ulp of the terms, elementwise"
    return max_err, ok, tol_s


def _time_ms(fn, flush, cold: bool = True) -> float:
    """Median card time of ``fn`` over TIMED_RUNS runs, each from a cold
    L2 (``cold=False``: from the L2 the previous run of ``fn`` left). Before
    each run the card spins for about 2 ms, so the host has enqueued the
    whole run before the start event fires: the time is the card's, not the
    host's launch overhead (which a short kernel would otherwise show as its
    own time). A function whose host work takes longer than that (the
    per-leaf updater) still shows part of it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(WARMUP_RUNS):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        if cold:
            flush.zero_()                 # start each run with a cold L2
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_bn_act(shape, dtype, dev, gen, flush):
    """Kernel, plain version and the unfused PyTorch path at one residual
    shape, plus the least time the card could take for the same work."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import epilogue

    x, res, (mean, var, gamma, beta) = _inputs(shape, dtype, True, dev, gen)
    scale, shift = epilogue.fold(mean, var, gamma, beta)
    mean_c, var_c, gamma_c, beta_c = (t.to(dtype)
                                      for t in (mean, var, gamma, beta))
    kernel = lambda: epilogue.bn_act_cuda(x, scale, shift, res, "relu")  # noqa: E731
    plain = lambda: epilogue.bn_act_reference(x, scale, shift, res, "relu")  # noqa: E731
    unfused = lambda: torch.relu(F.batch_norm(  # noqa: E731
        x, mean_c, var_c, gamma_c, beta_c, training=False, eps=1e-5) + res)
    return {"ms": _time_ms(kernel, flush), "plain_ms": _time_ms(plain, flush),
            "unfused_ms": _time_ms(unfused, flush),
            **bn_act_bound(shape, True, x.element_size())}


def bn_act_bound(shape, residual: bool, elem_size: int) -> dict:
    """The least time of one bn_act launch: the bytes of x, the residual
    and the output once plus scale and shift over 3.35 TB/s, or its float32
    operations (fma 2, add, max) over 67 TFLOP/s, the larger."""
    n = math.prod(shape)
    nbytes = (3 if residual else 2) * n * elem_size + 2 * shape[1] * 4
    flops = (4 if residual else 3) * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def time_bn_act_kernel(shape, act, residual, dtype, dev, gen, flush):
    """The kernel's median cold-L2 time at one launch's shape and its
    bound (bn_act_bound)."""
    from deeplearning4j_tpu_torch.ops import epilogue

    x, res, stats = _inputs(shape, dtype, residual, dev, gen)
    scale, shift = epilogue.fold(*stats)
    ms = _time_ms(lambda: epilogue.bn_act_cuda(x, scale, shift, res, act),
                  flush)
    return {"ms": ms, **bn_act_bound(shape, residual, x.element_size())}


#: the zoo models of phase 24 whose served forward launches bn_act, at
#: their defaults, batch 16
BN_ZOO_MODELS = ("SimpleCNN", "Xception", "InceptionResNetV1",
                 "FaceNetNN4Small2", "NASNet")
#: one bf16 vector: the kernel's launch floor
BN_FLOOR_SHAPE = (1, 8)
#: the identity launches without a residual of one ResNet-50 forward, the
#: ones a single PyTorch call (F.batch_norm) computes
BN_IDENTITY_SHAPES = ((BATCH, 256, 56, 56), (BATCH, 512, 28, 28),
                      (BATCH, 1024, 14, 14), (BATCH, 2048, 7, 7))
#: past 2**31 elements (the 64-bit index route): bf16, 4.3 GB a tensor
BN_WIDE_SHAPE = (1, 2, 32768, 32770)


def bn_act_forwards():
    """{forward: {(shape, act, residual): launches}} of one ResNet-50
    serving forward (batch 32) and of the served forwards of phase 24
    (batch 16)."""
    from deeplearning4j_tpu_torch.models import ResNet50, zoo

    forwards = {"ResNet50": bn_launch_cases(
        ResNet50(num_classes=1000, image_size=224).conf(), BATCH)}
    for name in BN_ZOO_MODELS:
        forwards[name] = bn_launch_cases(getattr(zoo, name)().conf(),
                                         ZOO_BATCH)
    return forwards


def bn_act_shape_bounds(smi: str, dev, gen, flush, floor_ms: float):
    """bn_act at every launch shape of bn_act_forwards, bf16: each compared
    with its plain version (f32 and bf16) and timed beside its bound; per
    forward the launch-weighted share of the bound, the sum of the
    launches' bounds over the sum of their times, beside the launch floor
    times the launches."""
    timed = {}
    out = {}
    for fwd, cases in bn_act_forwards().items():
        bound = ms = 0.0
        rows = []
        for case, count in sorted(cases.items()):
            shape, act, residual = case
            if case not in timed:
                for dtype in (torch.float32, torch.bfloat16):
                    compare_bn_act(shape, act, residual, dtype, dev, gen)
                timed[case] = time_bn_act_kernel(shape, act, residual,
                                                 torch.bfloat16, dev, gen,
                                                 flush)
            t = timed[case]
            bound += count * t["bound_ms"]
            ms += count * t["ms"]
            rows.append({"shape": list(shape), "act": act,
                         "residual": residual, "launches": count,
                         "ms": t["ms"], "bound_ms": t["bound_ms"],
                         "share": t["bound_ms"] / t["ms"]})
        launches = sum(cases.values())
        out[fwd] = {"launches": launches, "ms": ms, "bound_ms": bound,
                    "share": bound / ms, "floor_ms": launches * floor_ms,
                    "cases": rows}
        log(f"[kernels] bn_act bf16 over one {fwd} served forward "
            f"({launches} launches, {len(cases)} shapes): "
            f"sum of times {ms:.4f} ms, of bounds {bound:.4f} ms, "
            f"launch-weighted share of the bound {bound / ms:.3f}; the "
            f"launch floor ({floor_ms:.4f} ms) x {launches} = "
            f"{launches * floor_ms:.4f} ms; {smi}")
        for r in rows:
            log(f"[kernels]   {fwd} bn_act {r['shape']} {r['act']} "
                f"residual={r['residual']} x{r['launches']}: "
                f"{r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                f"({r['share']:.3f})")
    return out


def time_bn_act_library(shape, dev, gen, flush):
    """The kernel against the one PyTorch call that computes an identity
    launch without a residual, ``F.batch_norm`` with mean 0, variance
    1 - 2^-20 and eps 2^-20 (it refuses eps 0; the two sum to 1 exactly)
    and the folded scale and shift as its affine, bf16 x (float32
    parameters, as the kernel takes them)."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import epilogue

    x, _, stats = _inputs(shape, torch.bfloat16, False, dev, gen)
    scale, shift = epilogue.fold(*stats)
    eps = 2.0 ** -20
    zeros = torch.zeros_like(scale)
    var = torch.full_like(scale, 1.0 - eps)
    library = lambda: F.batch_norm(  # noqa: E731
        x, zeros, var, scale, shift, training=False, eps=eps)
    got = epilogue.bn_act_cuda(x, scale, shift, None, "identity").float()
    err = (library().float() - got).abs().max().item()
    torch.cuda.synchronize()
    return {"shape": list(shape),
            "ms": _time_ms(lambda: epilogue.bn_act_cuda(x, scale, shift,
                                                        None, "identity"),
                           flush),
            "library_ms": _time_ms(library, flush),
            "library_max_abs_diff": err}


def compare_bn_act_misaligned(shape, dtype, dev, gen):
    """bn_act (relu, with the residual) on x and a residual that start one
    element into their buffers, so no base pointer is 16-byte aligned and
    the kernel takes its scalar route, against the plain version."""
    from deeplearning4j_tpu_torch.ops import epilogue

    n = math.prod(shape)
    x, res = (torch.randn(n + 1, generator=gen, device=dev).to(dtype)[1:]
              .view(shape) for _ in range(2))
    _, _, stats = _inputs((1, shape[1]), dtype, False, dev, gen)
    scale, shift = epilogue.fold(*stats)
    got = epilogue.bn_act_cuda(x, scale, shift, res, "relu").float()
    want = epilogue.bn_act_reference(x, scale, shift, res, "relu").float()
    max_err, ok, tol_s = _bn_act_within_tolerance(got, want, x, scale, shift,
                                                  res, dtype)
    check(ok, f"bn_act {shape} {dtype} one element into its buffers: "
              f"max_abs_err {max_err} not {tol_s}")
    return max_err


def compare_bn_act_wide(dev, gen):
    """bf16 bn_act (relu, no residual) on BN_WIDE_SHAPE, past 2**31
    elements, against the plain version in float32, a slab of rows at a
    time (the plain version of the whole would need tens of GB)."""
    from deeplearning4j_tpu_torch.ops import epilogue

    t0 = time.perf_counter()
    shape = BN_WIDE_SHAPE
    C = shape[1]
    x = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    scale = torch.rand(C, generator=gen, device=dev) + 0.5
    shift = torch.randn(C, generator=gen, device=dev)
    out = epilogue.bn_act_cuda(x, scale, shift, None, "relu")
    torch.cuda.synchronize()
    max_err = 0.0
    rows = 2048
    for h in range(0, shape[2], rows):
        xs = x[:, :, h:h + rows]
        want = epilogue.bn_act_reference(xs, scale, shift, None,
                                         "relu").float()
        e, ok, tol_s = _bn_act_within_tolerance(
            out[:, :, h:h + rows].float(), want, xs, scale, shift, None,
            torch.bfloat16)
        check(ok, f"bn_act {shape} (64-bit route) rows {h}-{h + rows}: "
                  f"max_abs_err {e} not {tol_s}")
        max_err = max(max_err, e)
    del x, out
    torch.cuda.empty_cache()
    return {"shape": list(shape), "elements": math.prod(shape),
            "max_abs_err": max_err, "seconds": time.perf_counter() - t0}


def phase_kernels(smi: str, dev):
    cases = main_path_bn_cases(BATCH)
    ragged = [(shape, a, r)
              for shape in ((3, 65, 7, 5), (17, 130), (3, 5, 1, 1),
                            (2, 3, 1, 3), (4, 512, 7, 7), (2, 192, 5, 5),
                            (5, 33), (3, 7, 5, 3))
              for a in ("relu", "identity") for r in (False, True)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for shape, act, residual in cases + ragged:
        for dtype in (torch.float32, torch.bfloat16):
            e = compare_bn_act(shape, act, residual, dtype, dev, gen)
            errs[dtype] = max(errs[dtype], e)
            n += 1
    log(f"[kernels] bn_act vs plain: {n} comparisons "
        f"({len(cases)} main-path cases at batch {BATCH} + {len(ragged)} "
        f"ragged, f32 and bf16) ok; max_abs_err f32 {errs[torch.float32]} "
        f"bf16 {errs[torch.bfloat16]}")
    for dtype in (torch.float32, torch.bfloat16):
        e = compare_bn_act_misaligned((4, 512, 7, 7), dtype, dev, gen)
        errs[dtype] = max(errs[dtype], e)
    log(f"[kernels] bn_act vs plain on x and residual one element into "
        f"their buffers (the scalar route), [4, 512, 7, 7], f32 and bf16: "
        f"ok")
    wide = compare_bn_act_wide(dev, gen)
    errs[torch.bfloat16] = max(errs[torch.bfloat16], wide["max_abs_err"])
    log(f"[kernels] bn_act bf16 {wide['shape']} ({wide['elements']} "
        f"elements, the 64-bit index route) vs plain in float32: ok, "
        f"max_abs_err {wide['max_abs_err']}; {wide['seconds']:.2f} s")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = {"wide": wide}
    for dtype in (torch.float32, torch.bfloat16):
        t = time_bn_act((BATCH, 256, 56, 56), dtype, dev, gen, flush)
        timing[dtype] = t
        log(f"[kernels] bn_act [32,256,56,56] residual relu {dtype}: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"unfused F.batch_norm+add+relu {t['unfused_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{t['bytes']} B at 3.35 TB/s); median of {TIMED_RUNS} "
            f"(CUDA events, cold L2); {smi}")
    floor = time_bn_act_kernel(BN_FLOOR_SHAPE, "relu", False, torch.bfloat16,
                               dev, gen, flush)
    floor["empty_launch_ms"] = _time_ms(lambda: torch.cuda._sleep(0), flush)
    timing["floor"] = floor
    log(f"[kernels] bn_act launch floor: {floor['ms']:.4f} ms at "
        f"{list(BN_FLOOR_SHAPE)} bf16 (one vector; bound "
        f"{floor['bound_ms']:.7f} ms), timed as every shape; an empty "
        f"launch (torch.cuda._sleep(0)) {floor['empty_launch_ms']:.4f} ms; "
        f"{smi}")
    timing["library"] = []
    for shape in BN_IDENTITY_SHAPES:
        t = time_bn_act_library(shape, dev, gen, flush)
        timing["library"].append(t)
        log(f"[kernels] bn_act identity {t['shape']} bf16: kernel "
            f"{t['ms']:.4f} ms, F.batch_norm (mean 0, variance 1 - 2^-20, "
            f"eps 2^-20, the folded affine) {t['library_ms']:.4f} ms (the "
            f"kernel "
            f"{'no slower' if t['ms'] <= t['library_ms'] else 'SLOWER'}; "
            f"outputs within {t['library_max_abs_diff']:.3g}); {smi}")
    timing["shapes"] = bn_act_shape_bounds(smi, dev, gen, flush,
                                           floor["ms"])
    return errs, timing


# --- phase 3, embedding_bag -------------------------------------------------------

BAG_PATH = (8192, 10, W2V_VOCAB, 100)   # B, W, V, D of one CBOW round


def _bag_case(B, W, V, D, dev, gen, offset=0, dist="uniform", masked=0):
    """A table (a view ``offset`` elements into its buffer), indices, a 0/1
    mask with ``masked`` fully masked bags, and the counts. Indices are
    ``uniform`` over the table, ``zipf`` (the bench corpus's word
    frequencies, 1/rank) or ``subsampled`` (zipf after word2vec's
    frequent-word subsampling at 1e-3, keep = sqrt(t/f) + t/f: the
    distribution of the CBOW path's context words)."""
    buf = torch.randn(V * D + offset, generator=gen, device=dev)
    table = buf[offset:].view(V, D)
    if dist != "uniform":
        p = 1.0 / torch.arange(1, V + 1, device=dev, dtype=torch.float64)
        p = p / p.sum()
        if dist == "subsampled":
            p = p * ((1e-3 / p).sqrt() + 1e-3 / p).clamp(max=1.0)
        idx = torch.multinomial(p, B * W, replacement=True, generator=gen)
    else:
        idx = torch.randint(0, V, (B * W,), generator=gen, device=dev)
    idx = idx.view(B, W).to(torch.int32)
    mask = (torch.rand((B, W), generator=gen, device=dev) < 0.7).float()
    mask[:masked] = 0.0
    counts = mask.sum(1).clamp_min(1.0)
    return table, idx, mask, counts


def compare_embedding_bag(B, W, V, D, dev, gen, offset=0, masked=3):
    from deeplearning4j_tpu_torch.ops import embeddings

    table, idx, mask, counts = _bag_case(B, W, V, D, dev, gen, offset,
                                         masked=masked)
    if W:
        idx[0, 0], idx[-1, -1] = V - 1, V + 5      # the edge, and clamped
        idx[1, W // 2] = -3                        # clamped to row 0
    err = 0.0
    for mean in (True, False):
        got = embeddings.embedding_bag_cuda(table, idx, mask, counts, mean)
        want = embeddings.embedding_bag_reference(table, idx, mask, counts,
                                                  mean)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item() if got.numel() else 0.0
        check(torch.equal(got, want),
              f"embedding_bag B={B} W={W} V={V} D={D} offset={offset} "
              f"mean={mean}: not bitwise (max_abs_err {e})")
        err = max(err, e)
    return err


def _to_bf16_route(table, mask, offset=0):
    """A bag case's table and mask rounded to bf16 (the table ``offset``
    elements into its buffer), and the counts in bf16: the bf16 route's
    inputs."""
    V, D = table.shape
    buf = torch.empty(V * D + offset, dtype=torch.bfloat16,
                      device=table.device)
    t16 = buf[offset:].view(V, D)
    t16.copy_(table)
    m16 = mask.to(torch.bfloat16)
    return t16, m16, m16.float().sum(1).clamp_min(1.0).to(torch.bfloat16)


def compare_embedding_bag_bf16(B, W, V, D, dev, gen, offset=0, masked=3):
    """The bf16 route against its plain version, bitwise, mean and sum."""
    from deeplearning4j_tpu_torch.ops import embeddings

    table, idx, mask, _ = _bag_case(B, W, V, D, dev, gen, masked=masked)
    if W:
        idx[0, 0], idx[-1, -1] = V - 1, V + 5
    t16, m16, c16 = _to_bf16_route(table, mask, offset)
    err = 0.0
    for mean in (True, False):
        got = embeddings.embedding_bag_cuda(t16, idx, m16, c16, mean)
        want = embeddings.embedding_bag_reference(t16, idx, m16, c16, mean)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        check(got.dtype == torch.bfloat16 and torch.equal(got, want),
              f"embedding_bag bf16 B={B} W={W} V={V} D={D} offset={offset} "
              f"mean={mean}: not bitwise (max_abs_err {e})")
        err = max(err, e)
    return err


def time_embedding_bag(B, W, V, D, dev, gen, flush, dist, bf16=False,
                       case=None):
    """Kernel, plain version, F.embedding_bag (the one PyTorch call for the
    same function) and the unfused expression at one shape, beside the
    least bytes: indices, mask, counts, output, each distinct row once.
    ``bf16``: the bf16 route (table, mask, counts and output in bf16; its
    operations counted at the float32 peak, which the bytes bound exceeds),
    and the float32 route on the same values beside it (``f32_ms``).
    ``case``: a (table, indices, mask, counts) to time instead of a random
    one drawn as ``dist``."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import embeddings

    table, idx, mask, counts = (case if case is not None else
                                _bag_case(B, W, V, D, dev, gen, dist=dist))
    esize = 4
    f32_route = {}
    if bf16:
        table, mask, counts = _to_bf16_route(table, mask)
        esize = 2
        # the float32 route on the same values (each exact in float32)
        f32_case = (table.float(), idx, mask.float(), counts.float())
        f32_kernel = lambda: embeddings.embedding_bag_cuda(  # noqa: E731
            *f32_case, True)
        f32_route = {"f32_ms": _time_ms(f32_kernel, flush),
                     "f32_ms_warm": _time_ms(f32_kernel, flush, cold=False)}
        del f32_case
    c2 = counts[:, None]
    idx64 = idx.long()
    kernel = lambda: embeddings.embedding_bag_cuda(  # noqa: E731
        table, idx, mask, counts, True)
    plain = lambda: embeddings.embedding_bag_reference(  # noqa: E731
        table, idx, mask, counts, True)
    library = lambda: F.embedding_bag(  # noqa: E731
        idx64, table, per_sample_weights=mask, mode="sum") / c2
    unfused = lambda: (table[idx64] * mask[..., None]).sum(1) / c2  # noqa: E731
    check(torch.equal(kernel(), plain()),
          f"embedding_bag {dist} [{B},{W}] x [{V},{D}] bf16={bf16}: not "
          f"bitwise")
    # the library call sums in float32 and rounds once: W bf16 ulp apart
    tol = (2 ** -8 * W * table.float().abs().max().item() if bf16 else 1e-5)
    check(torch.allclose(library().float(), kernel().float(),
                         rtol=0 if bf16 else 1e-5, atol=tol),
          "F.embedding_bag yardstick computes another function")
    distinct = int(torch.unique(idx).numel())
    nbytes = (B * W * (4 + esize) + B * esize + B * D * esize
              + distinct * D * esize)
    no_reuse = (B * W * (4 + esize) + B * esize + B * D * esize
                + B * W * D * esize)
    flops = 2 * B * W * D + B * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    out = {"ms": _time_ms(kernel, flush),
           "ms_warm": _time_ms(kernel, flush, cold=False),
           "host_us": host_us(kernel),
           "plain_ms": _time_ms(plain, flush),
           "library_ms": _time_ms(library, flush),
           "unfused_ms": _time_ms(unfused, flush),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "bytes_no_reuse": no_reuse,
           "no_reuse_ms": no_reuse / HBM_BYTES_PER_S * 1e3,
           "distinct_rows": distinct, "shape": [B, W, V, D],
           "indices": dist, "dtype": "bfloat16" if bf16 else "float32",
           "hottest_row_share": torch.bincount(idx.view(-1).long()).max()
           .item() / (B * W), **f32_route}
    del table, idx, mask, counts, idx64
    return out


def phase_embedding_bag(smi: str, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    B, W, V, D = BAG_PATH
    cases = [(B, W, V, D, 0)]
    cases += [(257, 10, 1000, d, 0) for d in (1, 3, 101, 300)]
    cases += [(257, 1, 1000, 100, 0), (257, 10, 1000, 100, 1),
              (257, 10, 1000, 3, 1), (9, 0, 1000, 100, 0)]
    # the paths of the kernel's loops: index chunks past 32 lanes (W 32,
    # 33, 40) at D 100 and 300, each count of rows in flight (W 3, 5, 13,
    # and 10 and 40 above), B not a multiple of the 8 bags per block (8191,
    # 1001, 5, and 257 above), the scalar route past 32 indices
    cases += [(257, w, 1000, d, 0) for w in (32, 33, 40) for d in (100, 300)]
    cases += [(8191, w, V, D, 0) for w in (3, 5, 13)]
    cases += [(1001, 33, 1000, 101, 1), (5, 40, 1000, 300, 1)]
    err = 0.0
    for b, w, v, d, off in cases:
        err = max(err, compare_embedding_bag(b, w, v, d, dev, gen, off))
    log(f"[kernels] embedding_bag vs plain: {2 * len(cases)} comparisons "
        f"(mean and sum; the CBOW path's [{B},{W}] x [{V},{D}], D 1/3/100/"
        f"101/300, W 0/1/3/5/10/13/32/33/40, B 5/9/257/1001/8191/8192, 3 "
        f"fully masked bags each, indices past both ends, a table 1 element "
        f"into its buffer) all bitwise; max_abs_err {err}")
    # the bf16 route: the CBOW path's shape, PV-DM's 2W + 1 = 11 columns,
    # and each vector width (D % 8, % 4, % 2, odd; an offset table)
    cases16 = [(B, W, V, D, 0), (B, 2 * 5 + 1, V, D, 0)]
    cases16 += [(257, 10, 1000, d, 0) for d in (1, 3, 102, 128, 300)]
    cases16 += [(257, 10, 1000, 128, 1), (257, 10, 1000, 100, 2),
                (257, 33, 1000, 128, 0), (257, 40, 1000, 256, 0),
                (8191, 13, V, D, 0), (9, 0, 1000, 100, 0)]
    # the paired layout's edges: W at its 11 rows in flight (11, 12) and at
    # the layout's limit (16, and 17 on the float route's loop), B not a
    # multiple of its 2 bags a warp or 16 a block (1, 15, 17, 8191), rows of
    # 25 and 32 vectors (D 100, 128; a table 4 elements into its buffer
    # keeps the 8-byte vectors) and those it leaves to the loop (102, 300)
    cases16 += [(b, w, 1000, d, off)
                for b, w in ((1, 12), (15, 16), (17, 11), (8191, 17))
                for d in (100, 102, 128, 300) for off in (0, 4)]
    err16 = 0.0
    for b, w, v, d, off in cases16:
        err16 = max(err16, compare_embedding_bag_bf16(b, w, v, d, dev, gen,
                                                      off))
    log(f"[kernels] embedding_bag bf16 route vs plain: {2 * len(cases16)} "
        f"comparisons (mean and sum; [{B},{W}] and PV-DM's [{B},11] x "
        f"[{V},{D}], D 1/3/100/102/128/256/300 (16-, 8-, 4- and 2-byte "
        f"vectors), W 0/10/11/12/13/16/17/33/40, B 1/9/15/17/257/8191/8192, "
        f"offset tables) all bitwise; max_abs_err {err16}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = {"path": time_embedding_bag(B, W, V, D, dev, gen, flush,
                                         "subsampled"),
              "path_raw_zipf": time_embedding_bag(B, W, V, D, dev, gen, flush,
                                                  "zipf"),
              "wide": time_embedding_bag(B, W, 3_000_000, 300, dev, gen,
                                         flush, "uniform"),
              "bf16": time_embedding_bag(B, W, V, D, dev, gen, flush,
                                         "subsampled", bf16=True),
              "bf16_pv_dm": time_embedding_bag(B, 11, V, D, dev, gen, flush,
                                               "subsampled", bf16=True)}
    timing["bf16"]["max_abs_err"] = err16
    torch.cuda.empty_cache()
    for name in ("bf16", "bf16_pv_dm"):
        t = timing[name]
        log(f"[kernels] embedding_bag {name} {t['shape']}: bf16 route "
            f"{t['ms']:.4f} ms cold, {t['ms_warm']:.4f} ms warm; the float32 "
            f"route on the same values {t['f32_ms']:.4f} ms cold, "
            f"{t['f32_ms_warm']:.4f} ms warm; bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}); {smi}")
    for name, t in timing.items():
        log(f"[kernels] embedding_bag {name} {t['dtype']} {t['shape']} (B, W, "
            f"V, D; "
            f"{t['indices']} indices, {t['distinct_rows']} distinct rows, "
            f"hottest row {100 * t['hottest_row_share']:.2f}% of the "
            f"lookups): kernel {t['ms']:.4f} ms cold, {t['ms_warm']:.4f} ms "
            f"warm (L2 as the previous launch left it), host "
            f"{t['host_us']:.1f} us per launch; plain {t['plain_ms']:.4f} "
            f"ms, F.embedding_bag/counts {t['library_ms']:.4f} ms, unfused "
            f"{t['unfused_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B "
            f"at 3.35 TB/s; {t['bytes_no_reuse']} B without reuse = "
            f"{t['no_reuse_ms']:.4f} ms); median of {TIMED_RUNS} (CUDA "
            f"events, cold L2); {smi}")
    return err, timing


# --- phase 3, flash_attention ----------------------------------------------------

FA_TOL = 2e-5   # flash against dense in tests/test_pallas_attention.py


def _fa_bias(kind, b, heads, T, dev, gen):
    """None; "mask", a padding mask [b, 1, 1, T] of 0 / -1e9 broadcast to
    [b, heads, T, T] (a view with zero strides, as the MHA op builds it);
    "full", [b, heads, T, T] of scale 0.5; "masked_row", "full" with row 3
    at -inf everywhere."""
    if kind == "mask":
        keep = torch.rand((b, 1, 1, T), generator=gen, device=dev) < 0.7
        keep[..., 0] = True
        zero = torch.zeros((), device=dev)
        return torch.where(keep, zero, torch.full((), -1e9, device=dev)) \
            .expand(b, heads, T, T)
    if kind in ("full", "masked_row"):
        bias = torch.randn((b, heads, T, T), generator=gen, device=dev) * 0.5
        if kind == "masked_row":
            bias[:, :, min(3, T - 1)] = float("-inf")
        return bias
    return None


def _fa_case(bh, T, D, dev, gen, bias=None, heads=12):
    """q, k, v [bh, T, D] float32 of scale 0.3, and a bias over bh = B *
    heads (:func:`_fa_bias`)."""
    q, k, v = (torch.randn((bh, T, D), generator=gen, device=dev) * 0.3
               for _ in range(3))
    return q, k, v, _fa_bias(bias, bh // heads, heads, T, dev, gen)


def _fa_bf16_case(B, H, T, D, layout, dev, gen, bias=None):
    """bf16 q, k, v [B, H, T, D] of scale 0.3: "strided" as the MHA op hands
    them to the kernel (permuted views of [B, T, H, D] projections),
    "contiguous" as [B, H, T, D] tensors; and a bias (:func:`_fa_bias`)."""
    qkv = []
    for _ in range(3):
        t = (torch.randn((B, T, H, D), generator=gen, device=dev) * 0.3) \
            .to(torch.bfloat16).permute(0, 2, 1, 3)
        qkv.append(t.contiguous() if layout == "contiguous" else t)
    return (*qkv, _fa_bias(bias, B, H, T, dev, gen))


def compare_flash(bh, T, D, causal, bias, dev, gen):
    from deeplearning4j_tpu_torch.ops import attention

    heads = 12
    q, k, v, b = _fa_case(bh, T, D, dev, gen, bias, heads)
    scale = D ** -0.5
    got = attention.flash_attention_cuda(q, k, v, scale, causal, b)
    want = attention.flash_attention_reference(q, k, v, scale, causal, b)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and err <= FA_TOL,
          f"flash_attention [{bh},{T},{D}] causal={causal} bias={bias}: "
          f"max_abs_err {err} not <= {FA_TOL}")
    if bias == "masked_row":
        check(not got.view(bh // heads, heads, T, D)[:, :, 3].any(),
              "flash_attention: the row masked everywhere is not 0")
    return err, (got == want).float().mean().item()


def time_flash(bh, T, D, dev, gen, flush):
    """Kernel, plain version, F.scaled_dot_product_attention (the one
    PyTorch call for the same function, on the same float32 tensors) and
    the unfused matmul + softmax + matmul, beside the least time for the
    kernel's instruction mix: the larger of q, k, v read once and out
    written once over 3.35 TB/s and three TF32 products of 4*BH*T*T*D
    operations (3xTF32) over 495 TFLOP/s; and beside it the FFMA bound
    of the kernel's first design, 4*BH*T*T*D float32 operations over 67
    TFLOP/s."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention

    q, k, v, _ = _fa_case(bh, T, D, dev, gen)
    scale = D ** -0.5
    q4, k4, v4 = (t.view(bh // 12, 12, T, D) for t in (q, k, v))
    kernel = lambda: attention.flash_attention_cuda(q, k, v, scale)  # noqa: E731
    plain = lambda: attention.flash_attention_reference(q, k, v, scale)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
    unfused = lambda: torch.softmax(  # noqa: E731
        (q @ k.transpose(1, 2)) * scale, dim=-1) @ v
    want = kernel()
    for name, fn in (("scaled_dot_product_attention", library),
                     ("unfused", unfused)):
        check(torch.allclose(fn().reshape(bh, T, D), want, rtol=0,
                             atol=1e-4), f"{name} yardstick computes another "
              f"function")
    nbytes = 4 * bh * T * D * 4
    flops = 4 * bh * T * T * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    return {"shape": [bh, T, D], "ms": _time_ms(kernel, flush),
            "ffma_bound_ms": max(bytes_ms, flops / F32_FLOPS_PER_S * 1e3),
            "plain_ms": _time_ms(plain, flush),
            "library_ms": _time_ms(library, flush),
            "unfused_ms": _time_ms(unfused, flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


def phase_flash_attention(smi: str, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    bh, T, D = FA_PATH
    cases = [(bh, T, D, False, None), (bh, T, D, True, None),
             (bh, T, D, False, "mask"), (bh, T, D, False, "full"),
             (bh, T, D, False, "masked_row"), (24, 200, 64, False, "mask"),
             (24, 200, 64, True, None)]
    cases += [(24, 512, d, c, None) for d in (32, 64, 128)
              for c in (False, True)]
    err, share = 0.0, 1.0
    for case in cases:
        e, sh = compare_flash(*case, dev, gen)
        err, share = max(err, e), min(share, sh)
    log(f"[kernels] flash_attention float32 vs plain: {len(cases)} comparisons (the "
        f"encoder path's [{bh},{T},{D}] non-causal, causal, with the MHA "
        f"mask bias, a full [B,H,T,T] bias and a row masked everywhere; T 200 "
        f"(a tail tile); T 512 with D 32/64/128) ok; max_abs_err {err} "
        f"(<= {FA_TOL}), least bitwise share {share:.4f}; {smi}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = {"path": time_flash(*FA_PATH, dev, gen, flush),
              "long": time_flash(*FA_LONG, dev, gen, flush)}
    for name, t in timing.items():
        log(f"[kernels] flash_attention {name} {t['shape']} (B*H, T, D) "
            f"float32: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, F.scaled_dot_product_attention {t['library_ms']:.4f} ms, "
            f"unfused matmul+softmax+matmul {t['unfused_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: 3 x {t['flops']} TF32 "
            f"flops at 495 TFLOP/s, {t['bytes']} B at 3.35 TB/s; the FFMA "
            f"bound {t['ffma_bound_ms']:.4f} ms at 67 TFLOP/s); median of "
            f"{TIMED_RUNS} (CUDA events, cold L2); {smi}")
    timing["bitwise_share"] = share
    return err, timing


# the bf16 kernel against its plain version (float32 on the upcast inputs,
# unrounded: ``want``): every element within 2^-8 |want| + 2e-5 (half a
# bf16 ulp for the one rounding, plus the sums' order), at least 99% of the
# elements bitwise equal to ``want`` rounded to bf16, the log-sum-exp
# within 1e-5
FA_BF16_REL = 2.0 ** -8
FA_BF16_SHARE = 0.99
FA_LSE_TOL = 1e-5
BF16_FLOPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense


def compare_flash_bf16(B, H, T, D, causal, bias, layout, dev, gen):
    from deeplearning4j_tpu_torch.ops import attention

    q, k, v, b = _fa_bf16_case(B, H, T, D, layout, dev, gen, bias)
    scale = D ** -0.5
    got, lse = attention.flash_attention_bf16_cuda(q, k, v, scale, causal, b,
                                                   with_lse=True)
    want, want_lse = attention.flash_attention_reference(
        q.float(), k.float(), v.float(), scale, causal, b, with_lse=True)
    torch.cuda.synchronize()
    g = got.float()
    name = (f"flash_attention bf16 [{B},{H},{T},{D}] {layout} "
            f"causal={causal} bias={bias}")
    check(bool(torch.isfinite(g).all()), f"{name}: not finite")
    excess = ((g - want).abs() - FA_BF16_REL * want.abs()).max().item()
    check(excess <= 2e-5, f"{name}: |got - want| exceeds 2^-8 |want| by "
          f"{excess} (> 2e-5)")
    share = (got == want.bfloat16()).float().mean().item()
    check(share >= FA_BF16_SHARE, f"{name}: bitwise share {share} < "
          f"{FA_BF16_SHARE}")
    lse_err = (lse - want_lse.reshape(B * H, T)).abs().max().item()
    check(lse_err <= FA_LSE_TOL, f"{name}: lse error {lse_err}")
    if bias == "masked_row":
        check(not got[:, :, min(3, T - 1)].any(),
              f"{name}: the row masked everywhere is not 0")
    return (g - want).abs().max().item(), share, lse_err


def time_flash_bf16(bh, T, D, layout, dev, gen, flush):
    """The bf16 kernel (as SDPA computes it: q, k, v to out; and as the path
    calls it, with the log-sum-exp), its plain version, SDPA and the
    unfused matmul + softmax + matmul, all on the same bf16 tensors, beside
    the least time: the larger of q, k, v read once and out written once in
    bf16 over 3.35 TB/s and 4*BH*T*T*D operations over 989 TFLOP/s."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention

    B, H = bh // 12, 12
    q, k, v, _ = _fa_bf16_case(B, H, T, D, layout, dev, gen)
    scale = D ** -0.5
    kernel = lambda: attention.flash_attention_bf16_cuda(q, k, v, scale)  # noqa: E731
    with_lse = lambda: attention.flash_attention_bf16_cuda(  # noqa: E731
        q, k, v, scale, with_lse=True)
    # as autograd's forward calls it: the float32 output for the backward
    with_f32 = lambda: attention.flash_attention_bf16_cuda(  # noqa: E731
        q, k, v, scale, with_lse=True, with_f32=True)
    plain = lambda: attention.flash_attention_reference(q, k, v, scale)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    unfused = lambda: torch.softmax(  # noqa: E731
        (q @ k.transpose(-1, -2)) * scale, dim=-1) @ v
    want = kernel().float()
    for name, fn in (("scaled_dot_product_attention", library),
                     ("unfused", unfused)):
        check(torch.allclose(fn().float(), want, rtol=2 ** -6, atol=1e-2),
              f"{name} yardstick computes another function")
    nbytes = 4 * bh * T * D * 2
    flops = 4 * bh * T * T * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return {"shape": [bh, T, D], "layout": layout,
            "ms": _time_ms(kernel, flush),
            "ms_with_lse": _time_ms(with_lse, flush),
            "ms_with_f32": _time_ms(with_f32, flush),
            "plain_ms": _time_ms(plain, flush),
            "library_ms": _time_ms(library, flush),
            "unfused_ms": _time_ms(unfused, flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


def host_us(fn, runs: int = 200) -> float:
    """Host time of one call of ``fn`` with the card idle (its checks, the
    launch enqueued), median of ``runs``, in microseconds."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_encode_us(dev) -> float:
    """Host time of one bf16 launch at the path's shape (three tensor maps
    encoded, the launch enqueued), median of 200, in microseconds."""
    from deeplearning4j_tpu_torch.ops import attention

    B, H = FA_PATH[0] // 12, 12
    q, k, v, _ = _fa_bf16_case(B, H, FA_PATH[1], FA_PATH[2], "strided", dev,
                               torch.Generator(device=dev).manual_seed(1))
    return host_us(lambda: attention.flash_attention_bf16_cuda(
        q, k, v, 0.125, with_lse=True))


def phase_flash_attention_bf16(smi: str, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    B, H, T, D = FA_PATH[0] // 12, 12, FA_PATH[1], FA_PATH[2]
    cases = [(B, H, T, D, c, b, "strided") for c, b in (
        (False, None), (True, None), (False, "mask"), (False, "full"),
        (False, "masked_row"))]
    cases += [(B, H, T, D, False, None, "contiguous"),
              (2, 12, 200, 64, False, "mask", "strided"),
              (2, 12, 200, 64, True, None, "strided"),
              (2, 12, 1, 64, False, None, "strided"),
              (2, 12, 128, 40, False, "full", "strided")]
    cases += [(2, 12, 512, d, c, None, "strided") for d in (32, 64, 128)
              for c in (False, True)]
    err, share, lse_err = 0.0, 1.0, 0.0
    for case in cases:
        e, sh, le = compare_flash_bf16(*case, dev, gen)
        err, share, lse_err = max(err, e), min(share, sh), max(lse_err, le)
    log(f"[kernels] flash_attention bf16 vs plain (float32 on the upcast): "
        f"{len(cases)} comparisons (the encoder path's [{B},{H},{T},{D}] "
        f"strided non-causal, causal, the MHA mask bias, a full bias, a row "
        f"masked everywhere, and contiguous; T 200, T 1, D 40; T 512 with D "
        f"32/64/128) ok: max_abs_err {err} (each within 2^-8 |want| + 2e-5), "
        f"least bitwise share {share:.4f} (>= {FA_BF16_SHARE}), lse error "
        f"{lse_err} (<= {FA_LSE_TOL}); {smi}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = {f"{name}_{layout}": time_flash_bf16(*shape, layout, dev, gen,
                                                  flush)
              for name, shape in (("path", FA_PATH), ("long", FA_LONG))
              for layout in ("strided", "contiguous")}
    for name, t in timing.items():
        log(f"[kernels] flash_attention bf16 {name} {t['shape']} (B*H, T, D): "
            f"kernel {t['ms']:.4f} ms ({t['ms_with_lse']:.4f} ms with the "
            f"log-sum-exp, as the path calls it; {t['ms_with_f32']:.4f} ms "
            f"with the float32 output too, as autograd's forward calls it), "
            f"plain {t['plain_ms']:.4f} "
            f"ms, F.scaled_dot_product_attention (same bf16 tensors) "
            f"{t['library_ms']:.4f} ms, unfused bf16 matmul+softmax+matmul "
            f"{t['unfused_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}: {t['bytes']} B at 3.35 TB/s, {t['flops']} "
            f"flops at 989 TFLOP/s); median of {TIMED_RUNS} (CUDA events, "
            f"cold L2); {smi}")
    host_us = time_encode_us(dev)
    log(f"[kernels] flash_attention bf16 host time per call at the path's "
        f"shape (three tensor maps encoded, launch enqueued): {host_us:.1f} "
        f"us, median of 200")
    timing.update({"max_abs_err": err, "bitwise_share": share,
                   "lse_err": lse_err, "host_us": host_us})
    return timing


def phase_flash_grad(smi: str, dev):
    """Gradients through the kernel's forward and the blockwise backward
    against autograd through dense attention, at [8, 256, 64]: dq, dk, dv,
    and dbias for a full bias and for the MHA mask shape."""
    from deeplearning4j_tpu_torch.ops import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    B, H, T, D = 2, 4, 256, 64
    worst = 0.0
    for causal in (False, True):
        for kind in (None, "full", "mask"):
            q, k, v = (t.view(B, H, T, D).clone().requires_grad_()
                       for t in _fa_case(B * H, T, D, dev, gen)[:3])
            bias = None
            if kind == "full":
                bias = torch.randn((B, H, T, T), generator=gen, device=dev)
            elif kind == "mask":
                bias = torch.randn((B, 1, 1, T), generator=gen, device=dev)
            if bias is not None:
                bias = (bias * 0.5).requires_grad_()
            tgt = torch.randn((B, H, T, D), generator=gen, device=dev)
            before = attention.flash_attention_launches
            out = attention.flash_attention(q, k, v, causal=causal,
                                            bias=bias)
            check(attention.flash_attention_launches == before + 1,
                  "the gradient phase did not launch the kernel")
            leaves = [q, k, v] + ([bias] if bias is not None else [])
            got = torch.autograd.grad((out * tgt).sum(), leaves)
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
            if bias is not None:
                s = s + bias
            if causal:
                s = s.masked_fill(torch.ones(T, T, dtype=torch.bool,
                                             device=dev).triu(1),
                                  float("-inf"))
            dense = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
            want = torch.autograd.grad((dense * tgt).sum(), leaves)
            for g, w, n in zip(got, want, ("dq", "dk", "dv", "dbias")):
                e = (g - w).abs().max().item()
                check(g.shape == w.shape and e <= 1e-4,
                      f"flash_attention {n} causal={causal} bias={kind}: "
                      f"max_abs_err {e} not <= 1e-4")
                worst = max(worst, e)
    log(f"[attention-grad] [{B * H},{T},{D}]: dq, dk, dv (and dbias, full "
        f"and mask-shaped) through the kernel's forward vs autograd through "
        f"dense attention, causal and not: max_abs_err {worst} (<= 1e-4); "
        f"{smi}")
    return worst, flash_grad_bf16(smi, dev, gen)


def flash_grad_bf16(smi: str, dev, gen):
    """bf16 q, k, v at the encoder path's shape, as the MHA op hands them
    over: the gradients through the bf16 kernel, whose forward also writes
    the float32 output that the backward reads (D = sum(dO * O), as the JAX
    package's backward takes it), against the plain version's forward and
    the same backward on the same inputs. Each element within 1 bf16 ulp of
    itself plus 2^-16 of the largest gradient: the kernel's exp2 and its
    reciprocal leave O and the log-sum-exp float32 ulps from the plain
    version's, which the backward's sums carry before the one rounding to
    bf16."""
    from deeplearning4j_tpu_torch.ops import attention

    B, H, T, D = FA_PATH[0] // 12, 12, FA_PATH[1], FA_PATH[2]
    scale = D ** -0.5
    worst = 0.0
    for causal in (False, True):
        base = [(torch.randn((B, T, H, D), generator=gen, device=dev) * 0.3)
                .to(torch.bfloat16).requires_grad_() for _ in range(3)]
        q, k, v = (t.permute(0, 2, 1, 3) for t in base)
        tgt = torch.randn((B, H, T, D), generator=gen, device=dev)
        before = attention.flash_attention_launches
        out = attention.flash_attention(q, k, v, causal=causal)
        check(attention.flash_attention_launches == before + 1
              and out.dtype == torch.bfloat16,
              "the bf16 gradient case did not launch the bf16 kernel")
        got = torch.autograd.grad((out.float() * tgt).sum(), base)
        got = [g.permute(0, 2, 1, 3) for g in got]
        qd, kd, vd = (t.detach() for t in (q, k, v))
        _, lse, o32 = attention.flash_attention_reference(
            qd, kd, vd, scale, causal, None, attention.DEFAULT_BLOCK_K,
            with_lse=True, with_f32=True)
        want = attention.flash_attention_backward(
            qd, kd, vd, o32, tgt.to(torch.bfloat16), lse, scale, causal,
            attention.DEFAULT_BLOCK_K)
        for g, w, n in zip(got, want, ("dq", "dk", "dv")):
            g, w = g.float(), w.float()
            ulp = torch.where(w == 0, torch.zeros_like(w), _bf16_ulp(w))
            bound = ulp + 2.0 ** -16 * w.abs().max()
            excess = ((g - w).abs() - bound).max().item()
            check(excess <= 0, f"flash_attention bf16 {n} causal={causal}: "
                  f"exceeds 1 bf16 ulp + 2^-16 of the largest by {excess}")
            worst = max(worst, (g - w).abs().max().item())
    log(f"[attention-grad] bf16 [{B},{H},{T},{D}] strided, causal and not: "
        f"dq, dk, dv through the bf16 kernel (float32 O saved for the "
        f"backward) vs the plain version: max_abs_err {worst} (each element "
        f"within 1 bf16 ulp + 2^-16 of the largest gradient); {smi}")
    return worst


# --- phase 3, fused_update -------------------------------------------------------

UPDATE_KINDS = ("sgd", "nesterovs", "adam", "adamw")


def _updater(kind: str, state_dtype=None):
    from deeplearning4j_tpu_torch.learning import updaters as U

    u = {"sgd": lambda: U.Sgd(0.1),
         "nesterovs": lambda: U.Nesterovs(0.1, momentum=0.9),
         "adam": lambda: U.Adam(1e-3), "adamw": lambda: U.AdamW(1e-3)}[kind]()
    u.state_dtype = state_dtype
    return u


def _update_case(kind, n, bf16, dev, gen, offset=(0, 0)):
    """p, g, slots, bits on the card; ``offset`` = (elements into the
    buffer for p, for every other tensor)."""
    from deeplearning4j_tpu_torch.ops import update

    def buf(dtype, fill):
        t = torch.empty(n + 4, dtype=torch.float32, device=dev)
        fill(t)
        return t.to(dtype)

    def view(t, which):
        o = offset[0] if which == "p" else offset[1]
        return t[o:o + n]

    p = view(buf(torch.float32, lambda t: t.normal_(generator=gen)), "p")
    g = view(buf(torch.float32,
                 lambda t: t.normal_(generator=gen).mul_(0.01)), "g")
    sdt = torch.bfloat16 if bf16 else torch.float32
    slots = {}
    for s in update.SLOTS[kind]:
        if s == "v" and kind != "nesterovs":
            fill = lambda t: t.normal_(generator=gen).abs_().mul_(1e-3)  # noqa: E731
        else:
            fill = lambda t: t.normal_(generator=gen).mul_(0.1)  # noqa: E731
        slots[s] = view(buf(sdt, fill), s)
    bits = None
    if bf16 and update.SLOTS[kind]:
        b = torch.randint(-2 ** 31, 2 ** 31, (n + 4,), dtype=torch.int32,
                          generator=gen, device=dev)
        bits = view(b, "bits")
    return p, g, slots, bits


def compare_fused_update(kind, n, bf16, dev, gen, offset=(0, 0)):
    """The kernel (in place) against the plain version on copies of the
    same inputs: parameters and float32 moments within 2 float32 ulp,
    bfloat16 moments bitwise. Returns (max param err, max moment err,
    bitwise)."""
    from deeplearning4j_tpu_torch.ops import update

    p, g, slots, bits = _update_case(kind, n, bf16, dev, gen, offset)
    sr = torch.bfloat16 if bf16 else None
    sc = update._scalars(_updater(kind, "bfloat16" if bf16 else None), kind,
                         3)
    want_p, want_s = update.fused_update_reference(kind, sc, p, g, slots,
                                                   bits, sr)
    update.fused_update_cuda(kind, sc, p, g, slots, bits, sr)
    torch.cuda.synchronize()
    bitwise = torch.equal(p, want_p) and all(
        torch.equal(slots[k], want_s[k]) for k in slots)
    perr = (p - want_p).abs().max().item() if n else 0.0
    # the JAX package's contract between its modes: 2 float32 ulp of the
    # magnitude for parameters
    ptol = 2.0 ** -22 * (want_p.abs().max().item() + 1.0) if n else 0.0
    check(perr <= ptol, f"fused_update {kind} n={n} bf16={bf16} "
                        f"offset={offset}: param err {perr} > {ptol}")
    serr = 0.0
    for k in slots:
        got, want = slots[k].float(), want_s[k].float()
        d = (got - want).abs()
        serr = max(serr, d.max().item() if n else 0.0)
        if bf16:
            # stochastic rounding picks one of two bf16 neighbours 1 ulp
            # apart, so only equal bits check that the kernel read the
            # right halfword of the right bits
            ok = torch.equal(slots[k], want_s[k])
            what = "bitwise equality"
        else:
            ok = d.max().item() <= 2.0 ** -22 * (want.abs().max().item()
                                                 + 1.0)
            what = "2 f32 ulp"
        check(ok, f"fused_update {kind} n={n} bf16={bf16} offset={offset}:"
                  f" moment {k} err {d.max().item()} beyond {what}")
    return perr, serr, bitwise


def resnet50_leaf_shapes():
    """(node, name, shape) of the 161 parameter leaves of full-size
    ResNet-50, read off the configuration."""
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    conf = ResNet50(num_classes=1000, image_size=224).conf()
    out = []
    for name in sorted(conf.nodes):
        node = conf.nodes[name]
        if node.kind != "layer":
            continue
        layer = node.layer
        if isinstance(layer, L.ConvolutionLayer):
            kh, kw = layer.kernel_size
            shapes = {"W": (layer.n_out, layer.n_in, kh, kw)}
            if layer.has_bias:
                shapes["b"] = (layer.n_out,)
        elif isinstance(layer, L.BatchNormalization):
            shapes = {"beta": (layer.n_in,), "gamma": (layer.n_in,)}
        elif isinstance(layer, L.DenseLayer):
            shapes = {"W": (layer.n_in, layer.n_out)}
            if layer.has_bias:
                shapes["b"] = (layer.n_out,)
        else:
            continue
        out += [(name, k, s) for k, s in sorted(shapes.items())]
    return out


def time_fused_update(dev, gen, flush):
    """At the main path's bucket: Nesterovs with bf16 state (the train
    path) and Adam with float32 state, each kernel against its plain
    version; the per-leaf apply_updater over the 161 leaves; drawing the
    bits; and the PyTorch optimizer that computes each step on the same
    bucket (a yardstick only: the port never calls it):
    torch.optim.Adam(fused=True) for Adam, and for Nesterovs
    torch.optim.SGD(momentum=0.9, nesterov=True, fused=True), which keeps
    its momentum in float32 (not bf16: it moves 24 B/elem where the kernel
    moves 20) and scales the buffer by lr (the same step up to that
    rescaling)."""
    from deeplearning4j_tpu_torch.learning import precision
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.parallel.sharding import Zero1Plan

    n = RESNET50_PARAMS
    rows = {}
    for kind, bf16, per_elem in (("nesterovs", True, 20),
                                 ("adam", False, 28)):
        p, g, slots, bits = _update_case(kind, n, bf16, dev, gen)
        sr = torch.bfloat16 if bf16 else None
        upd = _updater(kind, "bfloat16" if bf16 else None)
        sc = update._scalars(upd, kind, 3)
        nbytes = per_elem * n
        flops = {"nesterovs": 6, "adam": 14}[kind] * n
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        row = {
            "ms": _time_ms(lambda: update.fused_update_cuda(
                kind, sc, p, g, slots, bits, sr), flush),
            "plain_ms": _time_ms(lambda: update.fused_update_reference(
                kind, sc, p, g, slots, bits, sr), flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "library_ms": None}
        # the per-leaf path over ResNet-50's 161 leaves (views of the same
        # buckets, as the graph holds them)
        shapes = resnet50_leaf_shapes()
        tree = {}
        for node, name, shape in shapes:
            tree.setdefault(node, {})[name] = torch.empty(shape,
                                                          device="meta")
        plan = Zero1Plan(tree, 1)
        check(plan.buckets[0].total == n, f"ResNet-50 has "
              f"{plan.buckets[0].total} parameters, not {n}")
        pt, gt = plan.unflatten({"flat::float32": p}), \
            plan.unflatten({"flat::float32": g})
        st = {k: plan.unflatten({"flat::float32": v})
              for k, v in slots.items()}
        lgen = torch.Generator(device=dev)
        lgen.manual_seed(SEED)
        row["unfused_ms"] = _time_ms(lambda: precision.apply_updater(
            upd, gt, st, pt, 3, lgen), flush)
        if bf16:
            row["bits_ms"] = _time_ms(lambda: precision.random_bits(
                n, lgen, dev), flush)
            row["bits_bound_ms"] = 4 * n / HBM_BYTES_PER_S * 1e3
            lib_p = p.clone()
            lib_p.grad = g.clone()
            opt = torch.optim.SGD([lib_p], lr=0.1, momentum=0.9,
                                  nesterov=True, fused=True)
            opt.step()               # makes its float32 momentum buffer
            row["library_ms"] = _time_ms(opt.step, flush)
            row["library"] = ("torch.optim.SGD(momentum=0.9, nesterov=True, "
                              "fused=True), float32 momentum")
            del opt, lib_p
        else:
            lib_p = p.clone()
            lib_p.grad = g.clone()
            opt = torch.optim.Adam([lib_p], lr=1e-3, betas=(0.9, 0.999),
                                   eps=1e-8, fused=True)
            row["library_ms"] = _time_ms(opt.step, flush)
        rows[f"{kind}_{'bf16' if bf16 else 'f32'}"] = row
        del p, g, slots, bits, pt, gt, st
    return rows


def phase_fused_update(smi: str, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    perr = serr = 0.0
    n_cases = n_bitwise = 0
    sizes = [RESNET50_PARAMS, 1, 5, 4097]
    for kind in UPDATE_KINDS:
        for bf16 in (False, True):
            cases = [(n, (0, 0)) for n in sizes]
            # a view 1 element into its buffer: all tensors (head path)
            # and p alone (the scalar variant)
            cases += [(4097, (1, 1)), (4097, (1, 0))]
            for n, off in cases:
                pe, se, bw = compare_fused_update(kind, n, bf16, dev, gen,
                                                  off)
                perr, serr = max(perr, pe), max(serr, se)
                n_cases += 1
                n_bitwise += int(bw)
    log(f"[kernels] fused_update vs plain: {n_cases} comparisons (4 kinds x "
        f"f32/bf16 state x sizes {sizes} + 2 offset views) ok; "
        f"{n_bitwise} of {n_cases} bitwise; max param err {perr}, max "
        f"moment err {serr}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = time_fused_update(dev, gen, flush)
    for name, t in timing.items():
        extra = (f"bits {t['bits_ms']:.4f} ms (bound {t['bits_bound_ms']:.4f}"
                 f"), {t['library']} {t['library_ms']:.4f} ms"
                 if "bits_ms" in t else
                 f"torch.optim.Adam(fused=True) {t['library_ms']:.4f} ms")
        log(f"[kernels] fused_update {name} n={RESNET50_PARAMS}: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, per-leaf "
            f"apply_updater (161 leaves) {t['unfused_ms']:.4f} ms, {extra}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B "
            f"at 3.35 TB/s); median of {TIMED_RUNS} (CUDA events, cold L2); "
            f"{smi}")
    return {"max_err_param": perr, "max_err_moment": serr,
            "bitwise": n_bitwise, "cases": n_cases}, timing


# --- phases 4 and 5 -----------------------------------------------------------

def set_fused(graph, on: bool) -> None:
    """The global knob plus the cascade onto every BN layer."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    graph.conf.global_conf.fused_epilogue = on
    for name in graph.conf.order:
        node = graph.conf.nodes[name]
        if node.kind == "layer" and isinstance(node.layer,
                                               L.BatchNormalization):
            node.layer.fused_epilogue = on


def build_model(dev, image_size: int = 224, num_classes: int = 1000):
    """ResNet-50 with seeded random weights: gamma ~ N(1, 0.1) and
    beta ~ N(0, 0.1), BN statistics calibrated on a seeded batch, then
    perturbed (mean += N(0, 0.05)·std, var *= U(0.8, 1.25))."""
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.util.calibrate import calibrate_batchnorm

    model = ResNet50(num_classes=num_classes, image_size=image_size,
                     seed=SEED).init(device=dev)
    rng = np.random.default_rng(SEED)
    for name in sorted(model._states):
        p = model._params[name]
        if "gamma" in p:
            c = p["gamma"].shape[0]
            p["gamma"] = torch.from_numpy(
                rng.normal(1.0, 0.1, c).astype(np.float32)).to(dev)
            p["beta"] = torch.from_numpy(
                rng.normal(0.0, 0.1, c).astype(np.float32)).to(dev)
    calib = rng.normal(size=(BATCH, 3, image_size, image_size)).astype(
        np.float32)
    states = calibrate_batchnorm(model, calib)
    for name in sorted(states):
        st = states[name]
        if "mean" not in st:
            continue
        c = st["mean"].shape[0]
        dm = torch.from_numpy(rng.normal(0.0, 0.05, c).astype(np.float32))
        sv = torch.from_numpy(rng.uniform(0.8, 1.25, c).astype(np.float32))
        st["mean"] = st["mean"] + dm.to(dev) * st["var"].sqrt()
        st["var"] = st["var"] * sv.to(dev)
    return model


def serve_round(pi, images, clients: int = 8):
    """``len(images)`` single-image requests from ``clients`` threads, each
    submitting its share asynchronously and then waiting for it. Returns
    (results, latency in s per request, client errors, wall time in s)."""
    n = len(images)
    results = [None] * n
    latency = [0.0] * n
    errors = []
    per = n // clients

    def client(k: int) -> None:
        try:
            futs = []
            for i in range(per * k, per * (k + 1)):
                t0 = time.perf_counter()
                fut = pi.output_async(images[i])
                fut.add_done_callback(
                    lambda f, i=i, t0=t0: latency.__setitem__(
                        i, time.perf_counter() - t0))
                futs.append((i, fut))
            for i, fut in futs:
                results[i] = fut.result(timeout=120)
        except Exception as e:   # reported by the caller
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    return results, latency, errors, time.perf_counter() - t0


def phase_serving(model, smi: str, dev):
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import epilogue
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    set_fused(model, True)
    model.conf.global_conf.compute_dtype = "bfloat16"
    size = model.conf.node_output_types["input"].height
    classes = model.conf.nodes["output"].layer.n_out
    rng = np.random.default_rng(SEED + 1)
    images = rng.normal(size=(64, 1, 3, size, size)).astype(np.float32)
    # warm-up outside the counted run: cuDNN handles, algorithms, the
    # bf16 parameter copies
    for b in (BATCH, 1):
        model.output(images[:b, 0])
    torch.cuda.synchronize()

    pi = (ParallelInference.Builder(model).inference_mode("batched")
          .batch_limit(BATCH).workers(2).max_wait_ms(10)
          .request_timeout_ms(120_000).build())
    prof = OpProfiler.get()
    try:
        # one round to warm the pool's own worker threads (each thread
        # makes its own cuDNN/cuBLAS handles on its first forward), then
        # the measured round with every count set to 0 just before it
        serve_round(pi, images)
        prof.reset()
        epilogue.reset_launches()
        results, latency, errors, wall = serve_round(pi, images)
        launches = epilogue.bn_act_launches
        counters = prof.get_counters()
    finally:
        pi.shutdown()

    check(not errors, f"client errors: {errors[:3]}")
    batches = counters.get("inference/batches", 0)
    check(counters.get("inference/requests", 0) == 64,
          f"served {counters.get('inference/requests')} of 64 requests")
    for i, r in enumerate(results):
        check(r is not None and tuple(r.shape) == (1, classes),
              f"answer {i} has shape {None if r is None else tuple(r.shape)}")
        v = r[0].float()
        check(bool(torch.isfinite(v).all()), f"answer {i} is not finite")
        check(abs(v.sum().item() - 1.0) <= 1e-2,
              f"answer {i} sums to {v.sum().item()}")
    check(launches == 53 * batches and launches > 0,
          f"bn_act kernel launched {launches} times for {batches} batches "
          f"(want 53 per batch)")
    check(counters.get("precision/epilogue_hits", 0) == 53 * batches,
          f"epilogue hits {counters.get('precision/epilogue_hits')}")
    check(counters.get("precision/epilogue_fallbacks", 0) == 0,
          f"epilogue fallbacks {counters.get('precision/epilogue_fallbacks')}")
    plain = counters.get(PLAIN_ON_CARD["bn_act"], 0)
    check(plain == 0, f"bn_act took its plain route on the card {plain} "
          f"times")
    lat = sorted(latency)
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3
    top = max(r[0].float().max().item() for r in results)
    log(f"[serving] ResNet-50 {size}x{size} {classes} classes bf16, fused "
        f"epilogue: "
        f"64 requests from 8 clients in {batches} batches, "
        f"{64 / wall:.2f} images/s, latency p50 {p50:.2f} ms p99 "
        f"{p99:.2f} ms; bn_act launches {launches} (53 x {batches}), plain "
        f"on the card {plain}; largest probability {top:.4f}; {smi}")
    return launches, batches, plain


def phase_parity(model, dev):
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler

    Environment.get().set_tf32(False)
    check(not any(Environment.get().tf32_flags().values()), "TF32 is on")
    model.conf.global_conf.compute_dtype = None
    size = model.conf.node_output_types["input"].height
    x = np.random.default_rng(SEED + 2).normal(
        size=(8, 3, size, size)).astype(np.float32)
    prof = OpProfiler.get()
    prof.reset()
    set_fused(model, True)
    fused = model.output(x)[0].float().cpu()
    check(prof.counter_value("precision/epilogue_hits") == 53,
          "fused forward did not take 53 epilogue launches")
    set_fused(model, False)
    dense = model.output(x)[0].float().cpu()
    check(prof.counter_value("precision/epilogue_hits") == 53,
          "dense forward took the epilogue")
    diff = (fused - dense).abs().max().item()
    check(torch.allclose(fused, dense, rtol=1e-4, atol=1e-6),
          f"fused vs dense float32 disagree: max abs diff {diff}")
    log(f"[parity] float32 batch 8, TF32 off: fused vs dense max abs diff "
        f"{diff} (rtol 1e-4, atol 1e-6); largest probability "
        f"{fused.max().item():.4f}")


# --- phase 5b: the routes the JAX package computes off its kernels ----------

#: the OpProfiler counter of each kernel's plain route on the card: a CUDA
#: tensor of a dtype its kernel does not take, or one that needs a gradient
#: (deeplearning4j_tpu_torch/ops/routing.py). flash_attention has no such
#: route: it casts other dtypes to float32 and differentiates through its
#: own autograd function, as the JAX package does.
PLAIN_ON_CARD = {"bn_act": "precision/epilogue_plain_on_card",
                 "fused_update": "precision/fused_buckets_plain_on_card",
                 "fused_update_members":
                     "precision/fused_member_buckets_plain_on_card",
                 "embedding_bag": "nlp/embedding_bag_plain_on_card"}
ROUTE_STEPS = 3                      # LeNet fit steps of each dtype
#: LeNet's parameters, the card against the CPU, over each leaf's own
#: largest magnitude: float64 rounding; float32 with TF32 off (phase 10's
#: LeNet bound). bfloat16: 4 bf16 ulp of the leaf's largest, plus a quarter
#: of the leaf's largest step (ROUTE_STEP_REL). The card's and the CPU's
#: bf16 convolutions and sums round apart, so the gradients differ in
#: their last bits: a parameter near a rounding boundary lands ulps away,
#: and a bias, which starts at 0 and is all step, by a share of its step
#: (on an H100 the dense layer's bias lands 4.5e-2 of its largest away,
#: a tenth of its step; a wrong update misses by the whole step)
ROUTE_REL = {"float64": 1e-10, "float32": 1e-5, "bfloat16": 2.0 ** -5}
ROUTE_STEP_REL = {"bfloat16": 0.25}
#: gradients, card against CPU, each tensor over its own largest: float64
#: through ResNet-50's 53 BNs; float32 through two (TF32 off)
ROUTE_GRAD_REL = {"float64": 1e-9, "float32": 1e-4}
#: the bag's table gradient: the card's index_add sums a row's duplicates
#: with atomics in any order
ROUTE_BAG_GRAD_REL = 1e-5
ROUTE_IMAGE, ROUTE_BATCH = 64, 2     # ResNet-50 at its published widths
ROUTE_BN_SHAPE = (8, 256, 56, 56)    # a stage-1 tail of ResNet-50, batch 8
ROUTE_M = 8                          # members of the float64 fleet bucket


def plain_on_card() -> dict:
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler

    prof = OpProfiler.get()
    return {k: prof.counter_value(v) for k, v in PLAIN_ON_CARD.items()}


def _routed(fn):
    """``fn()`` with every launch count and plain_on_card counter set to 0
    just before it and read just after: ``(result, launches, plain)``."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler

    OpProfiler.get().reset()
    _reset_kernel_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _kernel_counts(), plain_on_card()


def _route_gate(what: str, launches: dict, plain: dict, want_launches: dict,
                want_plain: dict) -> None:
    """Exactly these launches and plain routes on the card, no other."""
    got_l = {k: v for k, v in launches.items() if v}
    got_p = {k: v for k, v in plain.items() if v}
    check(got_l == {k: v for k, v in want_launches.items() if v}
          and got_p == {k: v for k, v in want_plain.items() if v},
          f"{what}: launches {got_l}, plain on the card {got_p} (want "
          f"{want_launches} and {want_plain})")


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """:func:`_scaled_err` of a card tensor against a CPU one, in float64."""
    return _scaled_err(got.detach().cpu().double(), want.detach().double())


def _grads_gate(what: str, card, host, rel: float) -> dict:
    """Every gradient tensor within ``rel`` of its own largest, and none
    zero on the card where the CPU's is not (a route that dropped the
    graph gives exact zeros)."""
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths

    if isinstance(host, list):
        card, host = ({str(i): d for i, d in enumerate(t)}
                      for t in (card, host))
    worst, zero, paths = 0.0, [], leaf_paths(host)
    for p in paths:
        want, got = get_path(host, p), get_path(card, p)
        if want.abs().max().item() > 0 and got.abs().max().item() == 0:
            zero.append(p)
        worst = max(worst, _rel(got, want))
    check(not zero, f"{what}: {len(zero)} gradient tensors are zero on the "
          f"card where the CPU's are not: {zero[:5]}")
    check(worst <= rel, f"{what}: gradients card vs CPU {worst} of a "
          f"tensor's largest > {rel}")
    return {"tensors": len(paths), "max_rel_err": worst,
            "zero_on_card": len(zero)}


def _carry(src, dst) -> None:
    """``src``'s parameters into ``dst`` (the same configuration)."""
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths

    with torch.no_grad():
        for p in leaf_paths(dst._params):
            get_path(dst._params, p).copy_(get_path(src._params, p))


def route_lenet(dev) -> dict:
    """LeNet at its full width through MultiLayerNetwork.fit with
    fused_update, float64, bfloat16 and float32, on the card and on the CPU
    from the same parameters: the float64 and bfloat16 buckets take the
    plain update on the card (the JAX package's xla math), the float32 one
    the kernel."""
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import LeNet, zoo

    batches = lenet_batches(ROUTE_STEPS, dev, SEED + 26)
    out = {}
    for dt in ("float64", "bfloat16", "float32"):
        tdt = getattr(torch, dt)
        nets = []
        for where in (dev, "cpu"):
            conf = LeNet().conf()
            conf.global_conf.dtype, conf.global_conf.fused_update = dt, True
            nets.append(zoo.network(conf).init(device=where))
        card, cpu = nets
        _carry(card, cpu)
        init = {p: get_path(cpu._params, p).clone()
                for p in leaf_paths(cpu._params)}
        data = [DataSet(ds.features.to(tdt), ds.labels.to(tdt))
                for ds in batches]

        def fit(net=card, data=data):
            for ds in data:
                net.fit(ds)

        _, launches, plain = _routed(fit)
        for ds in data:
            cpu.fit(DataSet(ds.features.cpu(), ds.labels.cpu()))
        kernel = dt == "float32"
        _route_gate(f"LeNet {dt} fused fit", launches, plain,
                    {"fused_update": ROUTE_STEPS if kernel else 0},
                    {"fused_update": 0 if kernel else ROUTE_STEPS})
        leaves = {}
        for p, v in init.items():
            want = get_path(cpu._params, p).double()
            got = get_path(card._params, p).detach().cpu().double()
            leaves[".".join(p)] = ((got - want).abs().max().item(),
                                   want.abs().max().item(),
                                   (want - v.double()).abs().max().item())
        bound = {n: ROUTE_REL[dt] * top + ROUTE_STEP_REL.get(dt, 0) * step
                 for n, (_, top, step) in leaves.items()}
        worst = max(leaves, key=lambda n: leaves[n][0]
                    / max(bound[n], 1e-300))
        err = max(e / top for e, top, _ in leaves.values())
        moved = max(step for _, _, step in leaves.values())
        buckets = sorted(card._flat.params)
        check(buckets == [f"flat::{dt}"], f"LeNet {dt}: buckets {buckets}")
        check(np.isfinite(card.score_value) and moved > 0,
              f"LeNet {dt}: loss {card.score_value}, moved {moved}")
        check(leaves[worst][0] <= bound[worst], f"LeNet {dt} fused fit: "
              f"card vs CPU on {worst} (difference, largest, step) "
              f"{leaves[worst]} above its bound {bound[worst]}")
        out[dt] = {"launches": launches["fused_update"],
                   "plain_on_card": plain["fused_update"],
                   "max_rel_err": err, "moved_abs": moved,
                   "worst_leaf": {"name": worst,
                                  "diff_largest_step": leaves[worst],
                                  "bound": bound[worst]},
                   "loss_card": card.score_value,
                   "loss_cpu": cpu.score_value}
        del nets, card, cpu
    return out


def route_members(dev) -> dict:
    """The fleet's member route (fused_apply_members) on a float64
    [8, 431,080] bucket, Nesterovs, a learning rate a row and one masked
    row, on the card and on the CPU."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.ops import update

    gen = torch.Generator().manual_seed(SEED + 27)
    shape = (ROUTE_M, LENET_PARAMS)
    host = {"p": torch.randn(shape, generator=gen, dtype=torch.float64),
            "g": torch.randn(shape, generator=gen, dtype=torch.float64)
            * 0.01,
            "v": torch.randn(shape, generator=gen, dtype=torch.float64)
            * 0.1}
    lr = torch.linspace(1e-3, 1e-1, ROUTE_M)
    live = torch.ones(ROUTE_M, dtype=torch.int32)
    live[3] = 0
    key = "flat::float64"

    def apply(where):
        t = {k: v.to(where, copy=True) for k, v in host.items()}
        update.fused_apply_members(
            Nesterovs(0.01, momentum=0.9), {key: t["p"]}, {key: t["g"]},
            {"v": {key: t["v"]}}, 3, [None] * ROUTE_M, lr.to(where),
            live.to(where))
        return t

    card, launches, plain = _routed(lambda: apply(dev))
    cpu = apply("cpu")
    _route_gate("fleet member route float64", launches, plain, {},
                {"fused_update_members": 1})
    err = max(_rel(card[k], cpu[k]) for k in ("p", "v"))
    held = all(torch.equal(card[k][3].cpu(), host[k][3]) for k in ("p", "v"))
    check(err <= ROUTE_REL["float64"] and held,
          f"fleet member route float64: card vs CPU {err}, masked row "
          f"held {held}")
    return {"shape": list(shape), "plain_on_card": 1, "max_rel_err": err,
            "bitwise": all(torch.equal(card[k].cpu(), cpu[k])
                           for k in ("p", "v"))}


def route_bn_act(dev) -> dict:
    """bn_act in float64 and float16 (relu, residual) at a stage-1 tail's
    shape: the plain version on the card against it on the CPU."""
    from deeplearning4j_tpu_torch.ops import epilogue

    rng = np.random.default_rng(SEED + 28)
    C = ROUTE_BN_SHAPE[1]
    x = rng.normal(size=ROUTE_BN_SHAPE)
    res = rng.normal(size=ROUTE_BN_SHAPE)
    stats = [torch.from_numpy(s.astype(np.float32)) for s in (
        rng.normal(size=C), rng.uniform(0.5, 2.0, C),
        rng.normal(1.0, 0.1, C), rng.normal(size=C))]
    out = {}
    for dt in (torch.float64, torch.float16):
        xt, rt = torch.from_numpy(x).to(dt), torch.from_numpy(res).to(dt)
        xd, rd = xt.to(dev), rt.to(dev)
        sd = [s.to(dev) for s in stats]
        y, launches, plain = _routed(lambda: epilogue.bn_act(
            xd, *sd, act="relu", residual=rd))
        want = epilogue.bn_act(xt, *stats, act="relu", residual=rt)
        _route_gate(f"bn_act {dt}", launches, plain, {}, {"bn_act": 1})
        got = y.cpu()
        if dt == torch.float64:
            ok = _rel(got, want) <= 1e-12
        else:   # one float16 rounding of the same float32 value
            ok = bool(((got.float() - want.float()).abs()
                       <= want.float().abs() * 2.0 ** -10 + 2.0 ** -24)
                      .all())
        name = str(dt).replace("torch.", "")
        check(got.dtype == dt and ok, f"bn_act {name} on the card vs the "
              f"CPU: {_rel(got, want)} of the largest")
        out[name] = {"plain_on_card": plain["bn_act"],
                     "max_rel_err": _rel(got, want),
                     "bitwise": torch.equal(got, want)}
    return out


def two_block_net(device):
    """Two conv -> BN(relu) blocks and a softmax head with the fused
    epilogue on (tests/test_torch_serving.py's two_block_conf)."""
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    b = (NeuralNetConfiguration.builder().seed(3).updater(Sgd(0.01))
         .fused_epilogue().list())
    for _ in range(2):
        b = b.layer(L.ConvolutionLayer(
            n_out=8, kernel_size=(3, 3), padding=(1, 1),
            activation="identity")).layer(
            L.BatchNormalization(activation="relu"))
    conf = (b.layer(L.OutputLayer(n_out=5, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.convolutional(6, 6, 3)).build())
    return MultiLayerNetwork(conf).init(device=device)


def route_gradients(dev) -> dict:
    """compute_gradient_and_score with the fused epilogue on, card against
    CPU from the same parameters and BN statistics: ResNet-50 at its
    published widths (64x64, batch 2, float64, statistics calibrated on the
    batch) and the two-block net (float32, BN affine and statistics
    seeded). In inference mode every BN takes the epilogue; the gradients
    need its plain version."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import ResNet50, zoo
    from deeplearning4j_tpu_torch.util.calibrate import calibrate_batchnorm

    out = {}
    rng = np.random.RandomState(SEED + 29)
    x = rng.randn(ROUTE_BATCH, 3, ROUTE_IMAGE, ROUTE_IMAGE)
    y = np.eye(1000)[rng.randint(0, 1000, ROUTE_BATCH)]
    nets = []
    for where in (dev, "cpu"):
        conf = ResNet50(num_classes=1000, image_size=ROUTE_IMAGE,
                        seed=SEED).conf()
        conf.global_conf.dtype = "float64"
        nets.append(zoo.network(conf).init(device=where))
    card, cpu = nets
    _carry(card, cpu)
    calibrate_batchnorm(cpu, x)
    card._states = {n: {k: v.to(dev) for k, v in d.items()}
                    for n, d in cpu._states.items()}
    for net in (card, cpu):
        set_fused(net, True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    (g_card, s_card), launches, plain = _routed(
        lambda: card.compute_gradient_and_score(
            DataSet(xt.to(dev), yt.to(dev))))
    g_cpu, s_cpu = cpu.compute_gradient_and_score(DataSet(xt, yt))
    _route_gate("ResNet-50 float64 gradients", launches, plain, {},
                {"bn_act": BN_ACT_PER_FORWARD})
    r = _grads_gate("ResNet-50 float64 gradients", g_card, g_cpu,
                    ROUTE_GRAD_REL["float64"])
    check(abs(s_card - s_cpu) <= 1e-10 * abs(s_cpu),
          f"ResNet-50 float64 score {s_card} vs {s_cpu}")
    out["resnet50_float64"] = dict(r, plain_on_card=plain["bn_act"],
                                   score_card=s_card, score_cpu=s_cpu)
    del nets, card, cpu, g_card, g_cpu

    card, cpu = two_block_net(dev), two_block_net("cpu")
    gen = torch.Generator().manual_seed(SEED + 30)
    for key in sorted(cpu._states):
        st, p = cpu._states[key], cpu._params[key]
        if "mean" in st:
            c = st["mean"].shape[0]
            p["gamma"].copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
            p["beta"].copy_(0.1 * torch.randn(c, generator=gen))
            st["mean"] = 0.1 * torch.randn(c, generator=gen)
            st["var"] = 0.5 + 1.5 * torch.rand(c, generator=gen)
    _carry(cpu, card)
    card._states = {n: {k: v.to(dev) for k, v in d.items()}
                    for n, d in cpu._states.items()}
    x = torch.randn(4, 3, 6, 6, generator=gen)
    y = torch.eye(5)[torch.randint(0, 5, (4,), generator=gen)]
    (g_card, s_card), launches, plain = _routed(
        lambda: card.compute_gradient_and_score(DataSet(x.to(dev),
                                                        y.to(dev))))
    g_cpu, s_cpu = cpu.compute_gradient_and_score(DataSet(x, y))
    _route_gate("two-block float32 gradients", launches, plain, {},
                {"bn_act": 2})
    r = _grads_gate("two-block float32 gradients", g_card, g_cpu,
                    ROUTE_GRAD_REL["float32"])
    out["two_block_float32"] = dict(r, plain_on_card=plain["bn_act"],
                                    score_card=s_card, score_cpu=s_cpu)
    return out


def route_embedding_bag(dev) -> dict:
    """embedding_bag at the CBOW path's shape: the gradient of a float32
    table, directly and through SameDiff.calculate_gradients over
    sd.nn.embedding_bag, and a float64 table's forward, each on the card
    against the CPU."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.ops import embeddings

    B, W, V, D = BAG_PATH
    rng = np.random.default_rng(SEED + 31)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, size=(B, W)).astype(np.int32)
    mask = (rng.random((B, W)) < 0.8).astype(np.float32)
    up = rng.normal(size=(B, D)).astype(np.float32)
    out = {}

    def grad(where):
        t = torch.from_numpy(table).to(where).requires_grad_(True)
        h = embeddings.embedding_bag(t, torch.from_numpy(idx).to(where),
                                     torch.from_numpy(mask).to(where))
        (h * torch.from_numpy(up).to(where)).sum().backward()
        return t.grad

    g, launches, plain = _routed(lambda: grad(dev))
    want = grad("cpu")
    _route_gate("embedding_bag gradient", launches, plain, {},
                {"embedding_bag": 1})
    err = _rel(g, want)
    check(err <= ROUTE_BAG_GRAD_REL and g.abs().max().item() > 0,
          f"embedding_bag gradient card vs CPU {err} of the largest")
    out["grad_float32"] = {"shape": [B, W, V, D], "max_rel_err": err,
                           "plain_on_card": plain["embedding_bag"]}

    def sd_grad(where):
        sd = SameDiff(where)
        t = sd.var("t", init=table)
        bag = sd.nn.embedding_bag(t, sd.constant("i", idx),
                                  sd.constant("m", mask), mode="mean")
        bag.mul(sd.constant("u", up)).sum().rename("loss")
        return sd.calculate_gradients({}, "loss", ["t"])["t"]

    g, launches, plain = _routed(lambda: sd_grad(dev))
    want = sd_grad("cpu")
    _route_gate("SameDiff embedding_bag gradient", launches, plain, {},
                {"embedding_bag": 1})
    err = _rel(g, want)
    check(err <= ROUTE_BAG_GRAD_REL and g.abs().max().item() > 0,
          f"SameDiff embedding_bag gradient card vs CPU {err}")
    out["samediff_grad"] = {"max_rel_err": err,
                            "plain_on_card": plain["embedding_bag"]}

    t64 = torch.from_numpy(table.astype(np.float64))
    it, mt = torch.from_numpy(idx), torch.from_numpy(mask)
    h, launches, plain = _routed(lambda: embeddings.embedding_bag(
        t64.to(dev), it.to(dev), mt.to(dev)))
    want = embeddings.embedding_bag(t64, it, mt)
    _route_gate("embedding_bag float64", launches, plain, {},
                {"embedding_bag": 1})
    err = _rel(h, want)
    check(h.dtype == torch.float64 and err <= 1e-12,
          f"embedding_bag float64 card vs CPU {err}")
    out["forward_float64"] = {"max_rel_err": err,
                              "bitwise": torch.equal(h.cpu(), want),
                              "plain_on_card": plain["embedding_bag"]}
    return out


def route_main_paths(model, dev) -> dict:
    """After the routes above, the main paths untouched: one served
    ResNet-50 forward (bf16, fused epilogue, batch 32) and one float32
    training step of the same model with fused_update."""
    from deeplearning4j_tpu_torch.data import DataSet

    size = model.conf.node_output_types["input"].height
    x = np.random.default_rng(SEED + 32).normal(
        size=(BATCH, 3, size, size)).astype(np.float32)
    set_fused(model, True)
    gc = model.conf.global_conf
    gc.compute_dtype = "bfloat16"
    model.output(x)                       # the bf16 parameter copies
    _, launches, plain = _routed(lambda: model.output(x))
    _route_gate("served ResNet-50 forward", launches, plain,
                {"bn_act": BN_ACT_PER_FORWARD}, {})
    gc.compute_dtype, gc.fused_update = None, True
    classes = model.conf.nodes["output"].layer.n_out
    ds = DataSet(torch.from_numpy(x[:8]).to(dev), torch.eye(classes)[
        torch.randint(0, classes, (8,), generator=torch.Generator()
                      .manual_seed(SEED + 33))].to(dev))
    _, launches2, plain2 = _routed(lambda: model.fit(ds))
    _route_gate("float32 ResNet-50 training step", launches2, plain2,
                {"fused_update": 1}, {})
    check(np.isfinite(model.score_value), f"training loss "
          f"{model.score_value}")
    return {"served_forward": {"bn_act_launches": launches["bn_act"],
                               "plain_on_card": plain["bn_act"]},
            "train_step": {"fused_update_launches":
                           launches2["fused_update"],
                           "plain_on_card": plain2["fused_update"],
                           "loss": model.score_value}}


def phase_kernel_routes(smi: str, dev, model) -> dict:
    """Phase 5b: every route that the JAX package computes off its kernels
    (another dtype, a gradient), on the card against the CPU, then the main
    paths' launches untouched."""
    t0 = time.perf_counter()
    with _Deterministic():
        r = {"lenet_fused_fit": route_lenet(dev),
             "fleet_member_route": route_members(dev),
             "bn_act": route_bn_act(dev),
             "gradients_fused_epilogue": route_gradients(dev),
             "embedding_bag": route_embedding_bag(dev)}
        torch.cuda.empty_cache()
        r["main_paths"] = route_main_paths(model, dev)
    r["seconds"] = time.perf_counter() - t0
    for dt, f in r["lenet_fused_fit"].items():
        log(f"[kernel-routes] LeNet {dt} fused fit, {ROUTE_STEPS} steps: "
            f"fused_update launches {f['launches']}, plain on the card "
            f"{f['plain_on_card']}; card vs CPU {f['max_rel_err']:.3e} of a "
            f"leaf's largest, the worst leaf against its bound "
            f"{f['worst_leaf']}, the largest step {f['moved_abs']:.3e}; "
            f"losses {f['loss_card']} / {f['loss_cpu']}; {smi}")
    m = r["fleet_member_route"]
    log(f"[kernel-routes] fleet member route float64 {m['shape']}: plain on "
        f"the card 1, card vs CPU {m['max_rel_err']:.3e} (bitwise "
        f"{m['bitwise']}); {smi}")
    for dt, b in r["bn_act"].items():
        log(f"[kernel-routes] bn_act {dt} {list(ROUTE_BN_SHAPE)} relu + "
            f"residual: plain on the card, vs the CPU {b['max_rel_err']:.3e} "
            f"(bitwise {b['bitwise']}); {smi}")
    for name, g in r["gradients_fused_epilogue"].items():
        log(f"[kernel-routes] compute_gradient_and_score {name}, fused "
            f"epilogue: bn_act plain on the card {g['plain_on_card']}, 0 "
            f"launches; {g['tensors']} gradient tensors within "
            f"{g['max_rel_err']:.3e} of their largest, {g['zero_on_card']} "
            f"zero; scores {g['score_card']} / {g['score_cpu']}; {smi}")
    e = r["embedding_bag"]
    log(f"[kernel-routes] embedding_bag {e['grad_float32']['shape']}: table "
        f"gradient card vs CPU {e['grad_float32']['max_rel_err']:.3e}, "
        f"through SameDiff {e['samediff_grad']['max_rel_err']:.3e}, float64 "
        f"forward {e['forward_float64']['max_rel_err']:.3e} (bitwise "
        f"{e['forward_float64']['bitwise']}); each plain on the card; {smi}")
    mp = r["main_paths"]
    log(f"[kernel-routes] after them: served ResNet-50 forward "
        f"{mp['served_forward']['bn_act_launches']} bn_act launches, plain "
        f"{mp['served_forward']['plain_on_card']}; float32 training step "
        f"{mp['train_step']['fused_update_launches']} fused_update launch, "
        f"plain {mp['train_step']['plain_on_card']}; phase "
        f"{r['seconds']:.1f} s; {smi}")
    print(json.dumps({"kernel_routes": r}, default=str), flush=True)
    return r


# --- phase 5c -------------------------------------------------------------------

#: one process of the build-cache check: bn_act on a fixed input through
#: the cache that DL4J_TPU_COMPILE_CACHE names, and the factories' dtype
CACHE_WORKER = """
import hashlib, json, torch
from deeplearning4j_tpu_torch.ndarray import factory
from deeplearning4j_tpu_torch.ops import cuda_lib, epilogue
g = torch.Generator().manual_seed(11)
x = torch.randn(32, 256, 56, 56, generator=g).cuda()
s, b = (torch.randn(256, generator=g).cuda() for _ in range(2))
out = epilogue.bn_act_cuda(x, s, b, x, "relu")
a = factory.create([[1.0, 2.0]])
print(json.dumps({"nvcc_runs": cuda_lib.nvcc_runs,
                  "library": str(cuda_lib.library_path("bn_act")),
                  "sha256": hashlib.sha256(out.cpu().numpy().tobytes())
                  .hexdigest(), "create_dtype": str(a.value.dtype),
                  "create_device": str(a.value.device)}))
"""
#: the encoder's float32 forward with flash against the dense route
#: (allow_pallas off): phase 9's card-against-CPU bound on probabilities
ALLOW_PALLAS_TOL = 1e-4


def _cache_worker(cache: str, **env):
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", CACHE_WORKER], cwd=root, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, DL4J_TPU_COMPILE_CACHE=cache,
                 PYTHONPATH=root, **env))


def _cache_result(proc, what: str) -> dict:
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise PhaseError(f"{what}: the build-cache process hung")
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}: "
          f"{err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def nan_kernel_case(kernel: str, dev):
    """Inputs for one launch of ``kernel`` at its main path's shape, with a
    NaN that reaches what it writes (fused_update: the parameters and the
    moment it updates in place); returns the launch. Built before NAN_PANIC
    is on, since writing the NaN is itself an operation that makes one."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.ops import (attention, embeddings,
                                              epilogue, update)

    nan = float("nan")
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    if kernel == "bn_act":
        x = torch.randn(BATCH, 256, 56, 56, device=dev, generator=g,
                        dtype=torch.bfloat16)
        x[7, 100, 20, 30] = nan
        s = torch.ones(256, device=dev)
        return lambda: epilogue.bn_act_cuda(x, s, s, x, "relu")
    if kernel == "fused_update":
        n = RESNET50_PARAMS
        p = torch.randn(n, device=dev, generator=g)
        grad = torch.randn(n, device=dev, generator=g) * 1e-3
        grad[n - 5] = nan
        slots = {"v": torch.zeros(n, device=dev)}
        sc = update._scalars(Nesterovs(0.1, momentum=0.9), "nesterovs", 0)
        return lambda: update.fused_update_cuda("nesterovs", sc, p, grad,
                                                slots)
    if kernel == "embedding_bag":
        B, W, V, D = BAG_PATH
        table = torch.randn(V, D, device=dev, generator=g)
        idx = torch.randint(0, V, (B, W), device=dev, generator=g,
                            dtype=torch.int32)
        mask = torch.ones(B, W, device=dev)
        table[int(idx[B // 2, 3])] = nan
        counts = mask.sum(1)
        return lambda: embeddings.embedding_bag_cuda(table, idx, mask,
                                                     counts, True)
    b, h, T, d = ENC_BATCH, BERT["heads"], SEQ_LEN, \
        BERT["hidden"] // BERT["heads"]
    dt = torch.float32 if kernel == "flash_attention" else torch.bfloat16
    q, k, v = (torch.randn(b, h, T, d, device=dev, generator=g) * 0.3
               for _ in range(3))
    v[3, 5, 100, 7] = nan
    if kernel == "flash_attention":
        q, k, v = (t.reshape(b * h, T, d) for t in (q, k, v))
        return lambda: attention.flash_attention_cuda(q, k, v, d ** -0.5)
    q, k, v = (t.to(dt) for t in (q, k, v))
    return lambda: attention.flash_attention_bf16_cuda(q, k, v, d ** -0.5)


#: the kernel each NaN case must name
NAN_KERNELS = {"bn_act": "bn_act", "fused_update": "fused_update",
               "embedding_bag": "embedding_bag",
               "flash_attention": "flash_attention",
               "flash_attention_bf16": "flash_attention"}


def _raises_nan(fn, name: str, what: str) -> str:
    """``fn()`` must raise FloatingPointError naming ``name``; returns the
    message."""
    try:
        fn()
        torch.cuda.synchronize()
    except FloatingPointError as e:
        check(name in str(e), f"{what}: the error names {e}, not {name}")
        return str(e)
    raise PhaseError(f"{what}: no FloatingPointError under NAN_PANIC")


def _main_path_syncs(model, dev) -> dict:
    """One served ResNet-50 forward (bf16, fused epilogue) and one float32
    training step of phase 4's model, each in a tracecheck steady_state
    region that counts and does not police: the launches and host syncs
    of each."""
    from deeplearning4j_tpu_torch.common import tracecheck
    from deeplearning4j_tpu_torch.data import DataSet

    size = model.conf.node_output_types["input"].height
    x = np.random.default_rng(SEED + 52).normal(
        size=(BATCH, 3, size, size)).astype(np.float32)
    classes = model.conf.nodes["output"].layer.n_out
    ds = DataSet(torch.from_numpy(x[:8]).to(dev), torch.eye(classes)[
        torch.randint(0, classes, (8,), generator=torch.Generator()
                      .manual_seed(SEED + 53))].to(dev))
    gc = model.conf.global_conf
    set_fused(model, True)
    out = {}
    for name, dtype, fused, fn in (
            ("served_forward", "bfloat16", False, lambda: model.output(x)),
            ("train_step", None, True, lambda: model.fit(ds))):
        gc.compute_dtype, gc.fused_update = dtype, fused
        fn()                                  # the dtype's copies, warm
        torch.cuda.synchronize()
        with tracecheck.steady_state(f"environment {name}",
                                     allow_compiles=1 << 20,
                                     max_host_syncs=None) as region:
            _, launches, plain = _routed(fn)
        out[name] = {"launches": launches, "plain": plain,
                     "host_syncs": region.host_syncs,
                     "sync_sites": dict(region.sync_sites)}
    check(np.isfinite(model.score_value), f"training loss "
          f"{model.score_value}")
    return out


def _allow_pallas_forwards(dev) -> dict:
    """The encoder at BERT-base width, float32, batch 2: its forward with
    flash, then with allow_pallas off (the dense route, no launch)."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    model = ComputationGraph(encoder_conf()).init(seed=SEED + 54, device=dev)
    feed = [torch.from_numpy(a).to(dev) for a in encoder_inputs(2, SEED + 55)]
    prof, env = OpProfiler.get(), Environment.get()
    outs, routes = {}, {}
    for allow in (True, False):
        env.set_allow_pallas(allow)
        try:
            out, launches, _ = _routed(lambda: model.output(*feed)[0])
        finally:
            env.set_allow_pallas(True)
        counters = prof.get_counters()
        outs[allow] = out.float()
        routes[allow] = {"flash_launches": launches["flash_attention"],
                         "mha_flash": counters.get("attention/mha_flash", 0),
                         "mha_dense": counters.get("attention/mha_dense", 0)}
    L = BERT["layers"]
    check(routes[True] == {"flash_launches": L, "mha_flash": L,
                           "mha_dense": 0}, f"allow_pallas on: {routes[True]}")
    check(routes[False] == {"flash_launches": 0, "mha_flash": 0,
                            "mha_dense": L}, f"allow_pallas off: "
          f"{routes[False]}")
    err = (outs[True] - outs[False]).abs().max().item()
    check(bool(torch.isfinite(outs[False]).all()) and err <= ALLOW_PALLAS_TOL,
          f"dense against flash: max abs err {err} not <= "
          f"{ALLOW_PALLAS_TOL}")
    return {"routes": {"on": routes[True], "off": routes[False]},
            "max_abs_err": err}


def phase_environment(smi: str, dev, model) -> dict:
    """Phase 5c: the Environment's switches on the card. NAN_PANIC raises
    FloatingPointError naming the aten op, each kernel, a LeNet step's op,
    a backward op and a ParallelInference future's; turned off, phase 4's
    model keeps its launches and host syncs. Two processes share a build
    cache (the second builds nothing, bitwise output, the factories in
    float64 under DL4J_TPU_DTYPE); allow_pallas off takes the dense route."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.common import build_cache, nan_panic
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.ops import cuda_lib
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    t0 = time.perf_counter()
    env = Environment.get()
    cache = tempfile.mkdtemp(prefix="dl4j-build-cache-")
    procs = [_cache_worker(cache)]
    try:
        with _Deterministic():
            before = _main_path_syncs(model, dev)
            r = {"nan_panic": {}}
            # every input is made before the flag is on: writing a NaN is
            # itself an operation that makes one
            minus = torch.tensor([-1.0, 4.0], device=dev)
            cases = {k: nan_kernel_case(k, dev) for k in sorted(NAN_KERNELS)}
            net = LeNet().init(device=dev)
            ds = lenet_batches(1, dev)[0]
            ds.features[5, 0, 14, 14] = float("nan")
            env.set_check_nan(True)
            try:
                r["nan_panic"]["aten"] = _raises_nan(
                    lambda: torch.log(minus), "aten.log", "log(-1)")
                for k, launch in cases.items():
                    r["nan_panic"][k] = _raises_nan(
                        launch, f"the {NAN_KERNELS[k]} kernel", k)
                r["nan_panic"]["lenet_fit"] = _raises_nan(
                    lambda: net.fit(ds), "NAN_PANIC", "LeNet fit")
                w = torch.zeros(8, device=dev, requires_grad=True)
                r["nan_panic"]["backward"] = _raises_nan(
                    lambda: (torch.sqrt(w) * 0.0).sum().backward(),
                    "NAN_PANIC", "backward")
                size = model.conf.node_output_types["input"].height
                bad = np.full((1, 3, size, size), np.nan, np.float32)
                pi = (ParallelInference.Builder(model)
                      .inference_mode("batched").batch_limit(BATCH)
                      .workers(1).max_wait_ms(1).build())
                try:
                    fut = pi.output_async(bad)
                    r["nan_panic"]["inference_future"] = _raises_nan(
                        lambda: fut.result(timeout=120), "NAN_PANIC",
                        "ParallelInference future")
                finally:
                    pi.shutdown()
            finally:
                env.set_check_nan(False)
            check(not env.is_check_nan() and not any(
                isinstance(m, nan_panic.NanPanicMode)
                for m in _get_current_dispatch_mode_stack()),
                  "NAN_PANIC left a mode pushed after it was turned off")
            first = _cache_result(procs[0], "first build-cache process")
            procs.append(_cache_worker(cache, DL4J_TPU_DTYPE="float64"))
            pallas = _allow_pallas_forwards(dev)
            after = _main_path_syncs(model, dev)
        second = _cache_result(procs[1], "second build-cache process")
        edited = os.path.join(cache, "edited", "bn_act.cu")
        os.makedirs(os.path.dirname(edited))
        shutil.copy(cuda_lib.source_path("bn_act"), edited)
        with open(edited, "a") as f:
            f.write("\n// edited\n")
        edited_name = build_cache.cached_name(
            "libbn_act", edited, cuda_lib.FLAGS, cuda_lib.nvcc_path())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(cache, ignore_errors=True)
    for name, want in (("served_forward", {"bn_act": BN_ACT_PER_FORWARD}),
                       ("train_step", {"fused_update": 1})):
        for when, m in (("before", before), ("after", after)):
            got = {k: m[name]["launches"][k] for k in want}
            check(got == want and not any(m[name]["plain"].values()),
                  f"{name} {when} the phase: launches {got}, plain "
                  f"{m[name]['plain']}, want {want}")
        check(after[name]["host_syncs"] == before[name]["host_syncs"],
              f"{name}: {after[name]['host_syncs']} host syncs after the "
              f"phase, {before[name]['host_syncs']} before "
              f"({after[name]['sync_sites']} / {before[name]['sync_sites']})")
    lib = os.path.basename(first["library"])
    check(first["nvcc_runs"] == 1 and os.path.dirname(first["library"])
          == cache and lib.startswith("libbn_act-"),
          f"first process: {first}")
    check(second["nvcc_runs"] == 0 and second["library"] == first["library"],
          f"second process built {second['nvcc_runs']} times or found "
          f"{second['library']}")
    check(second["sha256"] == first["sha256"], "the cached bn_act's output "
          "is not bitwise the first process's")
    check(edited_name != lib, "an edited source kept the library's name")
    check(first["create_dtype"] == "torch.float32"
          and second["create_dtype"] == "torch.float64"
          and second["create_device"].startswith("cuda"),
          f"Nd4j.create: {first['create_dtype']} by default, "
          f"{second['create_dtype']} on {second['create_device']} under "
          f"DL4J_TPU_DTYPE=float64")
    r["main_paths"] = {"before": before, "after": after}
    r["build_cache"] = {"library": lib, "first_nvcc_runs": first["nvcc_runs"],
                        "second_nvcc_runs": second["nvcc_runs"],
                        "bitwise": True, "edited_library": edited_name}
    r["default_dtype"] = {"unset": first["create_dtype"],
                          "float64": second["create_dtype"]}
    r["allow_pallas"] = pallas
    r["seconds"] = time.perf_counter() - t0
    for k, msg in r["nan_panic"].items():
        log(f"[environment] NAN_PANIC {k}: FloatingPointError: {msg}; {smi}")
    for name in ("served_forward", "train_step"):
        b, a = before[name], after[name]
        log(f"[environment] NAN_PANIC off: {name} launches "
            f"{ {k: v for k, v in a['launches'].items() if v} }, host syncs "
            f"{a['host_syncs']} (before the phase {b['host_syncs']}); {smi}")
    log(f"[environment] build cache: the first process built {lib} "
        f"({first['nvcc_runs']} nvcc run), the second ran "
        f"{second['nvcc_runs']} and its bn_act output is bitwise the "
        f"first's; an edited source is {edited_name}; Nd4j.create "
        f"{first['create_dtype']} unset, {second['create_dtype']} under "
        f"DL4J_TPU_DTYPE=float64; {smi}")
    log(f"[environment] allow_pallas off: encoder float32 batch 2 routes "
        f"{pallas['routes']['off']} (on: {pallas['routes']['on']}), dense "
        f"against flash max abs err {pallas['max_abs_err']:.3e} "
        f"(<= {ALLOW_PALLAS_TOL}); phase {r['seconds']:.1f} s; {smi}")
    print(json.dumps({"environment": r}, default=str), flush=True)
    return r


# --- phases 6 and 7 -----------------------------------------------------------

def train_model(dev, fused: bool, compute_dtype, state_dtype):
    """Full-size ResNet-50 as bench.py trains it (models/zoo.py: Nesterovs
    0.1/0.9, l2 1e-4), random weights from the seed."""
    from deeplearning4j_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=1000, image_size=IMAGE, seed=SEED).init(
        device=dev)
    gc = model.conf.global_conf
    gc.compute_dtype = compute_dtype
    gc.fused_update = fused
    gc.updater.state_dtype = state_dtype
    return model


def synthetic_batch(batch: int, dev, seed: int):
    """bench.py's synthetic batch: inputs N(0, 1), one-hot labels, from the
    seed, placed on the card once."""
    from deeplearning4j_tpu_torch.data import DataSet

    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 3, IMAGE, IMAGE).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.randint(0, 1000, batch)]
    return DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))


def phase_train(smi: str, dev):
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import epilogue, update

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = train_model(dev, True, "bfloat16", "bfloat16")
    ds = synthetic_batch(TRAIN_BATCH, dev, SEED)
    losses = []
    for _ in range(TRAIN_WARMUP):
        model.fit(ds)
        torch.cuda.synchronize()
        losses.append(model.score_value)
    bucket = model._flat.params["flat::float32"]
    before = bucket.clone()
    prof = OpProfiler.get()
    prof.reset()
    update.reset_launches()
    epilogue.reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        model.fit(ds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(model.score_value)
    launches = update.fused_update_launches
    counters = prof.get_counters()
    peak = torch.cuda.max_memory_allocated()
    changed = not torch.equal(before, bucket)
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(launches == TRAIN_STEPS, f"fused_update launched {launches} times "
          f"in {TRAIN_STEPS} steps (want 1 per step: one float32 bucket)")
    check(counters.get("precision/fused_buckets_kernel", 0) == TRAIN_STEPS,
          f"kernel buckets {counters.get('precision/fused_buckets_kernel')}")
    check(counters.get("precision/fused_fallbacks", 0) == 0,
          f"fused fallbacks {counters.get('precision/fused_fallbacks')}")
    check(counters.get(PLAIN_ON_CARD["fused_update"], 0) == 0,
          f"plain updates on the card "
          f"{counters.get(PLAIN_ON_CARD['fused_update'])}")
    check(counters.get("precision/grads_flat_in_step") == 1,
          "gradients were not born flat")
    state_bytes = counters.get("precision/updater_state_bytes_bfloat16", 0)
    check(state_bytes == 2 * RESNET50_PARAMS
          and counters.get("precision/updater_state_bytes_total") ==
          state_bytes, f"updater state {state_bytes} B, want "
          f"{2 * RESNET50_PARAMS} B of bfloat16")
    check(changed, "parameters did not change")
    ms = sorted(t * 1e3 for t in times)
    pct = lambda q: ms[min(len(ms) - 1, int(round(q * (len(ms) - 1))))]  # noqa: E731
    result = {"images_per_s": TRAIN_BATCH * TRAIN_STEPS / sum(times),
              "step_ms_median": statistics.median(ms),
              "step_ms_p10": pct(0.1), "step_ms_p90": pct(0.9),
              "losses": losses, "peak_bytes": peak,
              "state_bytes": state_bytes, "launches": launches,
              "bn_act_launches": epilogue.bn_act_launches,
              "counters": {k: v for k, v in sorted(counters.items())
                           if k.startswith("precision/")}}
    log(f"[train] ResNet-50 {IMAGE}x{IMAGE} 1000 classes, batch "
        f"{TRAIN_BATCH}, bf16 "
        f"compute, Nesterovs + l2, fused_update, bf16 state: "
        f"{result['images_per_s']:.2f} images/s, step ms median "
        f"{result['step_ms_median']:.2f} p10 {result['step_ms_p10']:.2f} "
        f"p90 {result['step_ms_p90']:.2f} ({TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-up); peak memory {peak} B; updater state "
        f"{state_bytes} B; fused_update launches {launches}; {smi}")
    log(f"[train] losses {losses}")
    log(f"[train] counters {result['counters']}")
    del model, ds, before
    torch.cuda.empty_cache()
    return result


def _f32_ulp_of(v: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), e - 24)


def phase_train_parity(dev):
    """One fit step through the kernel against one through the per-leaf
    apply_updater path from the same parameters."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.parallel.sharding import leaf_paths

    Environment.get().set_tf32(False)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ds = synthetic_batch(8, dev, SEED + 4)
        runs = []
        for fused in (True, False):
            m = train_model(dev, fused, None, None)
            m.fit(ds)
            torch.cuda.synchronize()
            runs.append(m)
        a, b = runs
        worst = {"params": 0.0, "momentum": 0.0}
        bitwise = True
        for what, ta, tb in (("params", a._params, b._params),
                             ("momentum", a._updater_state["v"],
                              b._updater_state["v"])):
            for n, k in leaf_paths(tb):
                x, y = ta[n][k].detach(), tb[n][k].detach()
                d = (x - y).abs()
                bitwise = bitwise and torch.equal(x, y)
                ulps = (d / _f32_ulp_of(torch.maximum(x.abs(), y.abs())
                                        .clamp_min(2.0 ** -126))).max().item()
                worst[what] = max(worst[what], ulps)
        check(worst["params"] <= 2 and worst["momentum"] <= 2,
              f"fused vs per-leaf step: {worst} f32 ulp (want <= 2)")
        log(f"[train-parity] batch 8, float32, TF32 off, deterministic "
            f"cuDNN, float32 state: fused kernel step vs per-leaf step: "
            f"params within {worst['params']:.2f} ulp, momentum within "
            f"{worst['momentum']:.2f} ulp (bound 2); bitwise {bitwise}; "
            f"loss {a.score_value} vs {b.score_value}")
        del runs, a, b
        torch.cuda.empty_cache()
        return {"worst_ulp": worst, "bitwise": bitwise}
    finally:
        torch.backends.cudnn.deterministic = det


# --- phases 7b-7c: the pipeline, checkpoints and the core ---------------------

#: phase 7b: an unshuffled iterator over PIPE_IMAGES seeded synthetic images
#: at TRAIN_BATCH: per epoch two full batches and one of 44 padded to 128
PIPE_IMAGES = 300
PIPE_EPOCHS = 3
PIPE_CKPT_EVERY = 3
PIPE_PROBE = 32                       # images served from the checkpoint
BN_ACT_PER_FORWARD = 53


class _StepClock:
    """A listener that records when each step's work has finished on the
    device (it waits for it). Placed last, so a step's time includes what
    the listeners before it did on the training thread."""

    def __init__(self, dev):
        self.dev = dev
        self.t = []

    def iteration_done(self, model, iteration, score):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.t.append(time.perf_counter())


def _same_bits(a, b) -> bool:
    """Two ``{node: {name: tensor}}`` trees hold the same bits."""
    from deeplearning4j_tpu_torch.parallel.sharding import leaf_paths

    return leaf_paths(a) == leaf_paths(b) and all(
        torch.equal(a[n][k], b[n][k]) for n, k in leaf_paths(a))


def stage_breakdown(model, data, dev) -> dict:
    """Host time of the pipeline's staging of one epoch's batches (bind,
    pad, pin, enqueue the copy; then wait for the copies), batch by batch,
    and of its parts on the first batch: pinning, the copy from pinned
    memory, the copy from pageable memory."""
    from deeplearning4j_tpu_torch.data import pipeline as pipe

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    per_batch = []
    for ds, w, _n in pipe.stable_batches(data):
        sync()
        t0 = time.perf_counter()
        model._place_batch(model._bind_batch(ds, w))
        sync()
        per_batch.append((time.perf_counter() - t0) * 1e3)
    first = torch.from_numpy(np.asarray(next(iter(data)).features))
    sync()
    t0 = time.perf_counter()
    pinned = first.pin_memory() if dev.type == "cuda" else first
    t1 = time.perf_counter()
    pinned.to(dev, non_blocking=True)
    sync()
    t2 = time.perf_counter()
    first.to(dev)
    sync()
    t3 = time.perf_counter()
    return {"batch_ms": per_batch, "pin_ms": (t1 - t0) * 1e3,
            "copy_pinned_ms": (t2 - t1) * 1e3,
            "copy_pageable_ms": (t3 - t2) * 1e3,
            "batch_bytes": first.numel() * first.element_size()}


def checkpoint_bytes_reckoned(model) -> int:
    """The arrays one checkpoint of ``model`` holds: float32 parameters,
    the updater state as stored, the BN statistics."""
    from deeplearning4j_tpu_torch.util.model_serializer import tree_leaves

    return sum(t.numel() * t.element_size() for t in
               tree_leaves(model._params) + tree_leaves(model._states)
               + tree_leaves(model._updater_state))


def phase_resnet_pipeline(smi: str, dev, train_ips: float,
                          image: int = IMAGE, n_images: int = PIPE_IMAGES,
                          batch: int = TRAIN_BATCH):
    """Full-size ResNet-50 as bench.py trains it, through
    ComputationGraph.fit over the input pipeline with bench.py's
    ScoreIterationListener and a CheckpointListener (every 3 iterations,
    keep 2); a fresh model resumed from the iteration-6 checkpoint must end
    bitwise where the uninterrupted run ends; the last checkpoint, loaded,
    serves through bn_act bitwise as the trained model does."""
    import tempfile

    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import epilogue, update
    from deeplearning4j_tpu_torch.optimize import (
        CheckpointListener, CollectScoresIterationListener,
        ScoreIterationListener)
    from deeplearning4j_tpu_torch.util import checkpoint as ckpt

    on_card = dev.type == "cuda"
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True       # the resume is bitwise
    rng = np.random.RandomState(SEED + 11)
    x = rng.randn(n_images, 3, image, image).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.randint(0, 1000, n_images)]
    data = NDArrayDataSetIterator(x, y, batch_size=batch)
    steps = PIPE_EPOCHS * -(-n_images // batch)
    tmp = tempfile.TemporaryDirectory(prefix="dl4j_ckpt_")
    try:
        if on_card:
            torch.cuda.empty_cache()
        a = train_model(dev, True, "bfloat16", "bfloat16")
        ck = CheckpointListener(tmp.name,
                                save_every_n_iterations=PIPE_CKPT_EVERY,
                                keep_last=2)
        scores, clock = CollectScoresIterationListener(), _StepClock(dev)
        a.set_listeners(ScoreIterationListener(print_iterations=10), ck,
                        scores, clock)
        prof = OpProfiler.get()
        prof.reset()
        update.reset_launches()
        t0 = time.perf_counter()
        a.fit(data, epochs=PIPE_EPOCHS)
        wall = clock.t[-1] - t0
        launches = update.fused_update_launches
        padded = prof.counter_value("pipeline/padded_batches")
        saved = [p.rsplit("/", 1)[-1] for p in ck.saved]     # flushes
        ck.close()
        losses = [s for _, s in scores.scores]
        check(not ck.errors(), f"checkpoint writes failed: {ck.errors()}")
        hits = prof.counter_value("precision/fused_hits")
        check(launches == (steps if on_card else 0) and hits == steps
              and a._iteration == steps,
              f"fused_update launched {launches} times ({hits} fused "
              f"updates) in {a._iteration} steps (want {steps}, one per "
              f"step)")
        check(padded == PIPE_EPOCHS, f"{padded} padded batches (want "
              f"{PIPE_EPOCHS}, one per epoch)")
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"losses {losses}")
        check(saved == [f"checkpoint_iter_{steps - PIPE_CKPT_EVERY}.zip",
                        f"checkpoint_iter_{steps}.zip"],
              f"committed checkpoints {saved}")
        ends = [t0] + clock.t
        step_ms = [(t1 - t2) * 1e3 for t1, t2 in zip(ends[1:], ends)]
        ck_steps = [step_ms[i - 1] for i in range(PIPE_CKPT_EVERY, steps + 1,
                                                  PIPE_CKPT_EVERY)]
        plain_steps = [ms for i, ms in enumerate(step_ms, 1)
                       if i > 1 and i % PIPE_CKPT_EVERY]
        mid = os.path.join(tmp.name, saved[0])
        last = os.path.join(tmp.name, saved[1])
        nbytes = os.path.getsize(last)
        staging = stage_breakdown(a, data, dev)

        # (b) a fresh model resumed from the middle checkpoint
        b = train_model(dev, True, "bfloat16", "bfloat16")
        t1 = time.perf_counter()
        cursor = ckpt.restore_training_state(b, mid)    # timed alone; the
        restore_s = time.perf_counter() - t1             # fit restores again
        bclock = _StepClock(dev)
        b.set_listeners(ScoreIterationListener(print_iterations=10), bclock)
        t1 = time.perf_counter()
        b.fit(data, epochs=PIPE_EPOCHS, resume_from=mid)
        bends = [t1] + bclock.t
        resumed_ms = [(u - v) * 1e3 for u, v in zip(bends[1:], bends)]
        check(b._iteration == steps, f"resumed run ended at {b._iteration}")
        bitwise = {"params": _same_bits(a._params, b._params),
                   "states": _same_bits(a._states, b._states),
                   "moments": _same_bits(a._updater_state["v"],
                                         b._updater_state["v"])}
        check(all(bitwise.values()), f"resumed run vs uninterrupted run: "
              f"bitwise {bitwise}")
        v_dtypes = {t.dtype for d in b._updater_state["v"].values()
                    for t in d.values()}
        check(v_dtypes == {torch.bfloat16}, f"moments {v_dtypes}")
        del b

        # (c) the last checkpoint, loaded, serves through bn_act
        d = ComputationGraph.load(last, device=dev)
        set_fused(d, True)
        set_fused(a, True)
        probe = x[:PIPE_PROBE]
        epilogue.reset_launches()
        got = d.output(probe)[0]
        served = epilogue.bn_act_launches
        want = a.output(probe)[0]
        if on_card:
            check(served == BN_ACT_PER_FORWARD, f"the loaded model launched "
                  f"bn_act {served} times per forward (want "
                  f"{BN_ACT_PER_FORWARD})")
        check(bool(torch.isfinite(got).all()) and torch.equal(got, want),
              "the loaded checkpoint does not serve what the trained model "
              "serves, bit for bit")
        # (d) the same accuracy over the iterator
        acc = (a.evaluate(data).accuracy(), d.evaluate(data).accuracy())
        check(acc[0] == acc[1], f"evaluate: {acc[0]} vs {acc[1]}")
        reckoned = checkpoint_bytes_reckoned(a)
    finally:
        torch.backends.cudnn.deterministic = det
        tmp.cleanup()
    commit_s = ck.commit_seconds
    result = {
        "steps": steps, "launches": launches, "padded_batches": padded,
        "losses": losses,
        "images_per_s": n_images * PIPE_EPOCHS / wall,
        "padded_images_per_s": batch * steps / wall,
        "given_dataset_images_per_s": train_ips,
        "step_ms": step_ms,
        "step_ms_checkpoint_steps": statistics.mean(ck_steps),
        "step_ms_other_steps": statistics.mean(plain_steps),
        "resumed_step_ms": resumed_ms,
        "snapshot_ms": ck.snapshot_ms, "commit_s": commit_s,
        "checkpoint_bytes": nbytes, "checkpoint_array_bytes": reckoned,
        "restore_s": restore_s, "cursor": cursor, "bitwise": bitwise,
        "staging": staging,
        "bn_act_launches_per_forward": served, "accuracy": acc[0]}
    log(f"[resnet50-pipeline] ResNet-50 {image}x{image}, bf16 compute, "
        f"fused_update, bf16 Nesterovs state, through fit(iterator) with "
        f"ScoreIterationListener(10) and CheckpointListener(every "
        f"{PIPE_CKPT_EVERY}, keep 2): {n_images} images at batch {batch}, "
        f"{PIPE_EPOCHS} epochs, {steps} steps ({padded} padded), "
        f"{launches} fused_update launches; {result['images_per_s']:.2f} "
        f"images/s through the pipeline ({result['padded_images_per_s']:.2f}"
        f" counting pad rows) against {train_ips:.2f} for fit(ds) in phase "
        f"6; step ms {['%.2f' % t for t in step_ms]}: with a checkpoint "
        f"{result['step_ms_checkpoint_steps']:.2f}, without "
        f"{result['step_ms_other_steps']:.2f} (steps 2 on); {smi}")
    log(f"[resnet50-pipeline] staging one epoch's batches on the host "
        f"(bind, pad, pin, copy; card waited for): ms "
        f"{['%.2f' % t for t in staging['batch_ms']]}; the first batch's "
        f"{staging['batch_bytes']} B: pin_memory {staging['pin_ms']:.2f} "
        f"ms, copy from pinned {staging['copy_pinned_ms']:.2f} ms, copy from "
        f"pageable {staging['copy_pageable_ms']:.2f} ms; {smi}")
    log(f"[resnet50-pipeline] checkpoints: snapshot (one readback) ms "
        f"{['%.2f' % t for t in ck.snapshot_ms]}; serialize + commit off "
        f"the training thread s {['%.3f' % t for t in commit_s]}; "
        f"{nbytes} B per file ({reckoned} B of arrays); restore "
        f"{restore_s:.3f} s; cursor {cursor}; {smi}")
    log(f"[resnet50-pipeline] resumed from iteration "
        f"{steps - PIPE_CKPT_EVERY}: bitwise {bitwise}, steps ms "
        f"{['%.2f' % t for t in resumed_ms]} (no checkpoint listener; the "
        f"first includes the restore and the replay); the loaded last "
        f"checkpoint serves {PIPE_PROBE} images through {served} bn_act "
        f"launches, bitwise as the trained model; accuracy {acc[0]} on "
        f"both; losses {losses}")
    del a, d
    if on_card:
        torch.cuda.empty_cache()
    return result


#: phase 7c: the port's core on the card against the port on the CPU
CORE_LOSSES = {
    # name: (constructor kwargs, activation, n_out, labels)
    "LossMCXENT": ({}, "softmax", 4, "onehot"),
    "LossSparseMCXENT": ({}, "softmax", 4, "index"),
    "LossBinaryXENT": ({}, "sigmoid", 4, "binary"),
    "LossMSE": ({}, "identity", 4, "real"),
    "LossL2": ({}, "tanh", 4, "real"),
    "LossMAE": ({}, "identity", 4, "real"),
    "LossL1": ({}, "identity", 4, "real"),
    "LossHinge": ({}, "identity", 4, "binary"),
    "LossSquaredHinge": ({}, "identity", 4, "binary"),
    "LossKLD": ({}, "softmax", 4, "onehot"),
    "LossPoisson": ({}, "softplus", 4, "count"),
    "LossCosineProximity": ({}, "identity", 4, "real"),
    "LossWasserstein": ({}, "identity", 4, "real"),
    "LossFMeasure": ({"beta": 2.0}, "sigmoid", 2, "onehot"),
    "LossMixtureDensity": ({"mixtures": 2, "labels_width": 3}, "identity",
                           10, "real3"),
}
CORE_UPDATERS = {
    "Sgd": {"learning_rate": 0.05}, "NoOp": {},
    "Nesterovs": {"learning_rate": 0.05, "momentum": 0.9},
    "AdaGrad": {"learning_rate": 0.05}, "AdaDelta": {},
    "RmsProp": {"learning_rate": 0.01}, "Adam": {"learning_rate": 0.01},
    "AdamW": {"learning_rate": 0.01, "weight_decay": 0.05},
    "AdaMax": {"learning_rate": 0.01}, "Nadam": {"learning_rate": 0.01},
    "AMSGrad": {"learning_rate": 0.01}}
CORE_SCHEDULES = {
    "constant": None,
    "FixedSchedule": {"value": 0.05},
    "StepSchedule": {"initial_value": 0.1, "decay_rate": 0.5, "step": 2},
    "ExponentialSchedule": {"initial_value": 0.1, "gamma": 0.9},
    "PolySchedule": {"initial_value": 0.1, "power": 2.0, "max_iter": 5},
    "InverseSchedule": {"initial_value": 0.1, "gamma": 0.3, "power": 0.75},
    "SigmoidSchedule": {"initial_value": 0.1, "gamma": 0.7, "step_size": 2},
    "CycleSchedule": {"initial_value": 0.01, "max_value": 0.1,
                      "cycle_length": 4, "annealing_cycles": 0.5}}
CORE_VERTICES = {
    "MergeVertex": ({}, [(4, 3, 4, 4), (4, 2, 4, 4)]),
    "ElementWiseVertex": ({"op": "max"}, [(4, 6)] * 3),
    "DotProductVertex": ({"normalize": True}, [(4, 6)] * 2),
    "SubsetVertex": ({"from_idx": 1, "to_idx": 3}, [(4, 5, 2, 2)]),
    "ScaleVertex": ({"scale": 0.3}, [(4, 6)]),
    "ShiftVertex": ({"shift": -1.5}, [(4, 6)]),
    "L2NormalizeVertex": ({}, [(4, 3, 2, 2)]),
    "StackVertex": ({}, [(4, 6)] * 2),
    "UnstackVertex": ({"from_idx": 1, "stack_size": 2}, [(4, 6)]),
    "ReshapeVertex": ({"shape": (2, 3)}, [(4, 6)])}
#: the tolerances of phase 7c, card against CPU, float32 with TF32 off:
#: losses, gradients and vertices within 1e-5 of each quantity's largest
#: magnitude (sums and reductions run in another order on the card);
#: updater steps within 2 float32 ulp of each leaf's largest magnitude
#: (elementwise IEEE operations; a library exp or log may differ by an
#: ulp); the MultiDataSet fit within rtol 1e-4 / atol 1e-6 (the graph
#: training bound of tests/test_torch_train.py)
CORE_REL = 1e-5


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _core_loss(name, dev):
    from deeplearning4j_tpu_torch.nn import losses as Ls
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    kw, act, n_out, kind = CORE_LOSSES[name]
    rng = np.random.default_rng(sorted(CORE_LOSSES).index(name))
    B = 6
    labels = {"onehot": lambda: np.eye(n_out)[rng.integers(0, n_out, B)],
              "index": lambda: rng.integers(0, n_out, (B, 1)),
              "binary": lambda: rng.integers(0, 2, (B, n_out)),
              "count": lambda: rng.integers(0, 4, (B, n_out)),
              "real3": lambda: rng.normal(size=(B, 3)),
              "real": lambda: rng.normal(size=(B, n_out))}[kind]()
    arrays = [rng.normal(size=(B, 5)), rng.normal(size=(5, n_out)) * 0.5,
              rng.normal(size=(n_out,)) * 0.1, labels,
              (rng.random(B) < 0.8) * 1.0, np.r_[np.ones(B - 1), 0.0]]
    res = []
    for where in (dev, torch.device("cpu")):
        xx, W, bb, lab, mask, w = (torch.tensor(a, dtype=torch.float32,
                                                device=where)
                                   for a in arrays)
        W.requires_grad_()
        bb.requires_grad_()
        layer = L.OutputLayer(n_in=5, n_out=n_out, activation=act,
                              loss=getattr(Ls, name)(**kw))
        pre = layer.pre_output({"W": W, "b": bb}, xx)
        v = layer.loss.compute_score(lab, pre, act, mask * w,
                                     average=False) / w.sum().clamp_min(1.0)
        res.append((v,) + torch.autograd.grad(v, [W, bb]))
    return max(_rel_err(g, c) for g, c in zip(*res))


def _core_updater(name, schedule, dev):
    from deeplearning4j_tpu_torch.learning import schedules as S
    from deeplearning4j_tpu_torch.learning import updaters as U

    kw = dict(CORE_UPDATERS[name])
    if schedule is not None:
        skw = CORE_SCHEDULES[schedule]
        kw["learning_rate"] = 0.05 if skw is None else getattr(
            S, schedule)(**skw)
    rng = np.random.default_rng(len(name))
    p0 = {"a": {"W": rng.normal(size=(3, 5)), "b": rng.normal(size=(5,))}}
    grads = [{"a": {k: rng.normal(size=v.shape) * 0.5 for k, v in
                    p0["a"].items()}} for _ in range(3)]
    out = []
    for where in (dev, torch.device("cpu")):
        t = lambda tree: {n: {k: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                              device=where)
                              for k, v in d.items()} for n, d in tree.items()}
        upd = getattr(U, name)(**kw)
        p = t(p0)
        st = upd.init(p)
        for i in range(3):
            p, st = upd.apply(t(grads[i]), st, p, i)
        out.append([p] + [st[s] for s in sorted(st)])
    worst = 0.0
    for card, cpu in zip(*out):
        for n, d in cpu.items():
            for k, w in d.items():
                g = card[n][k].cpu()
                ulps = ((g - w).abs().max() / np.spacing(np.float32(
                    w.abs().max().item()))).item()
                worst = max(worst, ulps)
    return worst


def multi_io_conf():
    """Two inputs and two outputs (softmax/mcxent, identity/mse) around a
    MergeVertex: the MultiDataSet path of phase 7c."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn import graph as G
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    b = (NeuralNetConfiguration.builder().seed(9)
         .updater(Nesterovs(0.05, momentum=0.9)).activation("tanh"))
    gb = G.ComputationGraphConfiguration.graph_builder(b).add_inputs("a",
                                                                     "b")
    gb.add_layer("da", L.DenseLayer(n_out=8), "a")
    gb.add_layer("db", L.DenseLayer(n_out=8), "b")
    gb.add_vertex("m", G.MergeVertex(), "da", "db")
    gb.add_layer("cls", L.OutputLayer(n_out=3, loss="mcxent",
                                      activation="softmax"), "m")
    gb.add_layer("reg", L.OutputLayer(n_out=2, loss="mse",
                                      activation="identity"), "m")
    gb.set_outputs("cls", "reg")
    gb.set_input_types(InputType.feed_forward(5), InputType.feed_forward(4))
    return gb.build()


def _core_multidataset(dev):
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    rng = np.random.default_rng(5)
    arrays = (rng.normal(size=(10, 5)), rng.normal(size=(10, 4)),
              np.eye(3)[rng.integers(0, 3, 10)], rng.normal(size=(10, 2)))
    arrays = [a.astype(np.float32) for a in arrays]
    batches = [MultiDataSet([a[i:i + 4] for a in arrays[:2]],
                            [a[i:i + 4] for a in arrays[2:]])
               for i in range(0, 10, 4)]
    nets = []
    for where in (dev, torch.device("cpu")):
        net = ComputationGraph(multi_io_conf()).init(device=where)
        net.fit(batches, epochs=2)
        nets.append(net)
    card, cpu = nets
    check(card._iteration == 6, f"MultiDataSet fit: {card._iteration} steps")
    return max(_rel_err(card._params[n][k], t) for n, d in cpu._params.items()
               for k, t in d.items())


def phase_core(smi: str, dev):
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.nn import graph as G

    Environment.get().set_tf32(False)
    loss_err = {n: _core_loss(n, dev) for n in CORE_LOSSES}
    upd_ulps = {n: _core_updater(n, None, dev) for n in CORE_UPDATERS}
    sched_ulps = {s: _core_updater("Nesterovs", s, dev)
                  for s in CORE_SCHEDULES}
    vert_err = {}
    for name, (kw, shapes) in CORE_VERTICES.items():
        rng = np.random.default_rng(len(name))
        xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
        v = getattr(G, name)(**kw)
        vert_err[name] = _rel_err(
            v.apply(*[torch.from_numpy(a).to(dev) for a in xs]),
            v.apply(*[torch.from_numpy(a) for a in xs]))
    mds_err = _core_multidataset(dev)
    for what, errs, bound in (("loss", loss_err, CORE_REL),
                              ("vertex", vert_err, CORE_REL),
                              ("updater", upd_ulps, 2),
                              ("schedule", sched_ulps, 2)):
        bad = {k: e for k, e in errs.items() if not e <= bound}
        check(not bad, f"core on the card vs the CPU: {what} {bad} > {bound}")
    check(mds_err <= 1e-4, f"MultiDataSet fit card vs CPU {mds_err}")
    log(f"[core] the card vs the CPU, float32, TF32 off: {len(loss_err)} "
        f"losses (value and gradient through an OutputLayer, masked and "
        f"example-weighted) worst {max(loss_err.values())} of the largest "
        f"magnitude (<= {CORE_REL}); {len(upd_ulps)} updaters x 3 steps worst "
        f"{max(upd_ulps.values())} ulp, {len(sched_ulps)} schedules under "
        f"Nesterovs worst {max(sched_ulps.values())} ulp (<= 2); "
        f"{len(vert_err)} vertices worst {max(vert_err.values())} "
        f"(<= {CORE_REL}); a two-input, two-output MultiDataSet fit (6 "
        f"steps) params within {mds_err} of their scale (<= 1e-4); {smi}")
    return {"loss_worst_rel": max(loss_err.values()),
            "updater_worst_ulp": max(upd_ulps.values()),
            "schedule_worst_ulp": max(sched_ulps.values()),
            "vertex_worst_rel": max(vert_err.values()),
            "multidataset_rel": mds_err}


# --- phase 8 -------------------------------------------------------------------

def zipf_sentences(n_words: int, vocab_size: int = W2V_VOCAB,
                   sent_len: int = 20, seed: int = 123):
    """bench.py's word2vec corpus: zipf(1) word ids, 20-word sentences."""
    rng = np.random.default_rng(seed)
    n_sent = max(1, n_words // sent_len)
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    words = np.array([f"w{i}" for i in range(vocab_size)])
    ids = rng.choice(vocab_size, size=(n_sent, sent_len), p=p)
    return [" ".join(row) for row in words[ids]]


def cluster_corpus(n_sent: int, sent_len: int = 12, seed: int = 0):
    """tests/test_nlp.py's corpus: two disjoint 50-word clusters."""
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(50)]
    B = [f"b{i}" for i in range(50)]
    return [" ".join(rng.choice(A if rng.random() < .5 else B, size=sent_len))
            for _ in range(n_sent)]


def bench_word2vec(dev, sents):
    """The word2vec-cbow model of bench.py (bench_word2vec_variant)."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w2v = Word2Vec(min_word_frequency=5, layer_size=100, window=5,
                   negative=5, sampling=1e-3, epochs=1, batch_size=8192,
                   seed=42, algorithm="cbow", device=dev)
    w2v.set_sentence_iterator(sents)
    return w2v


def phase_word2vec(smi: str, dev):
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import embeddings

    t0 = time.perf_counter()
    sents = zipf_sentences(W2V_WORDS)
    corpus_s = time.perf_counter() - t0
    w2v = bench_word2vec(dev, sents)
    prof = OpProfiler.get()
    prof.reset()
    embeddings.reset_launches()
    fits = []
    for label in ("cold", "warm"):
        launches0 = embeddings.embedding_bag_launches
        rounds0 = prof.counter_value("nlp/w2v_rounds")
        t0 = time.perf_counter()
        w2v.fit()
        wall = time.perf_counter() - t0
        timing = w2v.last_fit_timing
        fits.append({
            "fit": label, "words_per_s": w2v.words_per_sec,
            "pairs_per_s": w2v.pairs_per_sec, "last_loss": w2v.last_loss,
            "launches": embeddings.embedding_bag_launches - launches0,
            "rounds": prof.counter_value("nlp/w2v_rounds") - rounds0,
            "blocks": timing["blocks"], "wall_s": wall,
            "prepare_s": timing["prepare"], "train_s": timing["train"],
            "ms_per_block": timing["train"] / max(timing["blocks"], 1) * 1e3})
    launches = embeddings.embedding_bag_launches
    plain = prof.counter_value(PLAIN_ON_CARD["embedding_bag"])
    check(plain == 0, f"embedding_bag took its plain route on the card "
          f"{plain} times")
    vocab = len(w2v.vocab)
    syn0, syn1 = w2v.lookup_table.syn0, w2v.lookup_table.syn1neg
    check(len(w2v.vocab) == W2V_VOCAB, f"vocabulary {len(w2v.vocab)}, want "
          f"{W2V_VOCAB}")
    check(w2v._cbow_centers == 8192, f"{w2v._cbow_centers} examples per "
          f"round, want 8192")
    check(w2v.table_device is not None and w2v.table_device.type == "cuda",
          f"tables trained on {w2v.table_device}")
    for f in fits:
        check(f["launches"] == f["rounds"] == W2V_ROUNDS_PER_FIT
              and f["blocks"] * 64 == f["rounds"],
              f"{f['fit']} fit: {f['launches']} embedding_bag launches, "
              f"{f['rounds']} rounds, {f['blocks']} blocks (want "
              f"{W2V_ROUNDS_PER_FIT} launches, one per round)")
        check(np.isfinite(f["last_loss"]) and f["last_loss"] < np.log(2.0),
              f"{f['fit']} fit: last loss {f['last_loss']} not finite or "
              f"not below ln 2")
    check(bool(np.isfinite(syn0).all() and np.isfinite(syn1).all()),
          "tables not finite")
    for f in fits:
        log(f"[word2vec-cbow] {f['fit']} fit: {f['words_per_s']:.1f} words/s, "
            f"{f['pairs_per_s']:.1f} examples/s over the train window "
            f"{f['train_s']:.3f} s ({f['blocks']} blocks, "
            f"{f['ms_per_block']:.2f} ms per block); host prepare "
            f"(tokenize, count, encode) {f['prepare_s']:.3f} s of "
            f"{f['wall_s']:.3f} s fit wall; embedding_bag launches "
            f"{f['launches']} = rounds {f['rounds']}; last loss "
            f"{f['last_loss']:.6f}; {smi}")
    log(f"[word2vec-cbow] vocabulary {len(w2v.vocab)}, corpus "
        f"{len(sents) * 20} words (made in {corpus_s:.2f} s), 8192 examples "
        f"per round; similarity(w1, w2) {w2v.similarity('w1', 'w2'):.4f}")
    del w2v, sents
    torch.cuda.empty_cache()

    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w = Word2Vec(min_word_frequency=5, layer_size=24, negative=5,
                 algorithm="cbow", epochs=10, batch_size=256, seed=2,
                 device=dev)
    w.set_sentence_iterator(cluster_corpus(1000))
    w.fit()
    same = float(np.mean([w.similarity("a0", f"a{i}") for i in range(1, 6)]))
    diff = float(np.mean([w.similarity("a0", f"b{i}") for i in range(5)]))
    check(same > diff + 0.4, f"cluster corpus on the card: same {same} not "
          f"above diff {diff} + 0.4")
    log(f"[word2vec-cbow] cluster corpus on the card: same {same:.4f}, diff "
        f"{diff:.4f} (gate same > diff + 0.4), last loss {w.last_loss:.4f}")
    return {"fits": fits, "launches": launches, "plain_on_card": plain,
            "vocab": vocab,
            "cluster_same": same, "cluster_diff": diff}


# --- phases 14-17: skip-gram, hierarchical softmax, bf16 tables, PV --------------

#: HS and ParagraphVectors run on this cut of the corpus (HS rounds hold
#: 128 pairs, so they are many and round-bound); widths stay bench.py's
W2V_CUT_WORDS = 400_000
SG_ROUND_PAIRS = 8190                 # bench.py word2vec's B
SG_SPAN, SG_CAPACITY = 87_360, 876_330
HS_ROUND = 128                        # HS_MAX_ROUND


def w2v_model(dev, **kw):
    """bench.py's _w2v_model (skip-gram with negative sampling: min
    frequency 5, layer 100, window 5, 5 negatives, sampling 1e-3, 1 epoch,
    batch 8192, seed 42), with ``kw`` on top."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    cfg = dict(min_word_frequency=5, layer_size=100, window=5, negative=5,
               sampling=1e-3, epochs=1, batch_size=8192, seed=42)
    cfg.update(kw)
    return Word2Vec(device=dev, **cfg)


def fit_counted(model, label: str) -> dict:
    """One fit with every count set to 0 just before it and read just
    after: the bag's launches (both routes, and the bf16 route's), the
    rounds and blocks counters, and each skip-gram block's pair count as
    the card computed it (so that rounds can be held to sum(ceil(count /
    B)))."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import embeddings

    counts = []
    sg_block = type(model)._sg_block

    def recording(*a):
        counts.append(a[4])
        return sg_block(model, *a)

    model._sg_block = recording
    prof = OpProfiler.get()
    prof.reset()
    embeddings.reset_launches()
    t0 = time.perf_counter()
    try:
        model.fit()
    finally:
        del model._sg_block
    wall = time.perf_counter() - t0
    timing = model.last_fit_timing
    B = model._round_pairs
    return {
        "fit": label, "words_per_s": model.words_per_sec,
        "pairs_per_s": model.pairs_per_sec, "first_loss": model.first_loss,
        "last_loss": model.last_loss, "wall_s": wall,
        "prepare_s": timing["prepare"], "train_s": timing["train"],
        "blocks": timing["blocks"], "readbacks": timing["readbacks"],
        "readback_wait_s": timing["readback_wait"],
        "ms_per_block": timing["train"] / max(timing["blocks"], 1) * 1e3,
        "rounds": prof.counter_value("nlp/w2v_rounds"),
        "sg_blocks": len(counts),
        "sum_ceil_count_over_b": sum(-(-c // B) for c in counts),
        "sg_pairs": sum(counts),
        "launches": embeddings.embedding_bag_launches,
        "bf16_launches": embeddings.embedding_bag_bf16_launches}


def check_tables(model, what: str) -> None:
    lt = model.lookup_table
    out = lt.syn1 if model.use_hs else lt.syn1neg
    check(model.table_device is not None
          and model.table_device.type == "cuda",
          f"{what}: tables trained on {model.table_device}")
    check(lt.syn0.dtype == np.float32 and bool(np.isfinite(lt.syn0).all())
          and bool(np.isfinite(out).all()), f"{what}: tables not finite "
          f"float32")


def cluster_gate(dev, what: str, margin: float, n_sent: int,
                 near: bool = False, device_corpus: bool = True,
                 sent_len: int = 12, **kw) -> dict:
    """A fit of tests/test_nlp.py's cluster corpus on the card, gated as
    there: mean similarity of a0 to a1..a5 above that to b0..b4 plus
    ``margin``; with ``near``, 8 of a0's 10 nearest words from cluster a.
    ``device_corpus`` False fits through the host pair path."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w = Word2Vec(min_word_frequency=5, device=dev, **kw)
    w.device_corpus = device_corpus
    w.set_sentence_iterator(cluster_corpus(n_sent, sent_len))
    w.fit()
    same = float(np.mean([w.similarity("a0", f"a{i}") for i in range(1, 6)]))
    diff = float(np.mean([w.similarity("a0", f"b{i}") for i in range(5)]))
    check(w.table_device.type == "cuda", f"{what}: not on the card")
    check(same > diff + margin, f"{what} cluster corpus on the card: same "
          f"{same} not above diff {diff} + {margin}")
    out = {"same": same, "diff": diff, "margin": margin}
    if near:
        out["near_a"] = sum(n.startswith("a")
                            for n in w.words_nearest("a0", 10))
        check(out["near_a"] >= 8, f"{what}: {out['near_a']} of a0's 10 "
              f"nearest words from its cluster, want >= 8")
    log(f"[{what}] cluster corpus on the card: same {same:.4f}, diff "
        f"{diff:.4f} (gate same > diff + {margin})"
        + (f", {out['near_a']} of 10 nearest from cluster a" if near else ""))
    return out


def _log_fit(tag: str, f: dict, smi: str) -> None:
    log(f"[{tag}] {f['fit']} fit: {f['words_per_s']:.1f} words/s, "
        f"{f['pairs_per_s']:.1f} pairs/s over the train window "
        f"{f['train_s']:.3f} s ({f['blocks']} blocks, {f['ms_per_block']:.2f} "
        f"ms per block, {f['rounds']} rounds; {f['readbacks']} count "
        f"readbacks waiting {1e3 * f['readback_wait_s']:.3f} ms in all); "
        f"host prepare {f['prepare_s']:.3f} s of {f['wall_s']:.3f} s fit "
        f"wall; embedding_bag launches {f['launches']} (bf16 route "
        f"{f['bf16_launches']}); first block's loss {f['first_loss']:.6f}, "
        f"last loss {f['last_loss']:.6f}; {smi}")


def phase_skipgram(smi: str, dev, sents):
    """Phase 14: skip-gram with negative sampling at bench.py --config
    word2vec, cold and warm, and the cluster corpus on the card."""
    w = w2v_model(dev)
    w.set_sentence_iterator(sents)
    fits = [fit_counted(w, label) for label in ("cold", "warm")]
    check((w._round_pairs, w._window_span, w._pack_capacity)
          == (SG_ROUND_PAIRS, SG_SPAN, SG_CAPACITY),
          f"B, S, C = {w._round_pairs}, {w._window_span}, "
          f"{w._pack_capacity}, want {SG_ROUND_PAIRS}, {SG_SPAN}, "
          f"{SG_CAPACITY}")
    check_tables(w, "skipgram")
    for f in fits:
        check(f["rounds"] == f["sum_ceil_count_over_b"] > 0
              and f["sg_blocks"] == f["blocks"] == f["readbacks"],
              f"{f['fit']} fit: {f['rounds']} rounds against sum(ceil("
              f"count/B)) = {f['sum_ceil_count_over_b']} over "
              f"{f['sg_blocks']} blocks ({f['blocks']} blocks, "
              f"{f['readbacks']} readbacks)")
        check(f["launches"] == 0, f"{f['fit']} fit: {f['launches']} "
              f"embedding_bag launches, skip-gram has no bag")
        check(np.isfinite(f["last_loss"])
              and f["last_loss"] < fits[0]["first_loss"],
              f"{f['fit']} fit: last loss {f['last_loss']} not below the "
              f"first block's {fits[0]['first_loss']}")
        _log_fit("skipgram", f, smi)
    log(f"[skipgram] vocabulary {len(w.vocab)}, B {w._round_pairs} pairs per "
        f"round, S {w._window_span} positions and C {w._pack_capacity} pairs "
        f"per block; pairs per fit {fits[0]['sg_pairs']}; similarity(w1, "
        f"w2) {w.similarity('w1', 'w2'):.4f}")
    del w
    cluster = cluster_gate(dev, "skipgram", 0.4, 1500, near=True,
                           layer_size=32, seed=42, window=3, negative=5,
                           epochs=3, batch_size=256)
    return {"fits": fits, "cluster": cluster}


def phase_hs(smi: str, dev, sents):
    """Phase 15: skip-gram and CBOW with hierarchical softmax at the
    word2vec-hs hyperparameters, on the corpus's first 400,000 words, and
    the cluster corpus on the card for each."""
    cut = sents[:W2V_CUT_WORDS // 20]
    out = {}
    for alg in ("skipgram", "cbow"):
        w = w2v_model(dev, negative=0, use_hierarchic_softmax=True,
                      algorithm=alg)
        w.set_sentence_iterator(cut)
        f = fit_counted(w, "cold")
        size = w._round_pairs if alg == "skipgram" else w._cbow_centers
        check(size == HS_ROUND, f"hs {alg}: {size} per round, want "
              f"{HS_ROUND}")
        check(w.negative == 0 and w.lookup_table.syn1neg is None,
              f"hs {alg}: negative sampling tables present")
        check_tables(w, f"hs {alg}")
        if alg == "skipgram":
            check(f["rounds"] == f["sum_ceil_count_over_b"] > 0
                  and f["launches"] == 0, f"hs skipgram: {f['rounds']} "
                  f"rounds, sum(ceil(count/B)) "
                  f"{f['sum_ceil_count_over_b']}, {f['launches']} launches")
        else:
            check(f["launches"] == f["rounds"] == 64 * f["blocks"] > 0
                  and f["bf16_launches"] == 0, f"hs cbow: {f['launches']} "
                  f"launches for {f['rounds']} rounds")
        check(np.isfinite(f["last_loss"]), f"hs {alg}: loss not finite")
        _log_fit(f"hs-{alg}", f, smi)
        out[alg] = f
        del w
    out["cluster_skipgram"] = cluster_gate(
        dev, "hs-skipgram", 0.4, 1000, layer_size=24, negative=0,
        use_hierarchic_softmax=True, epochs=3, batch_size=256, seed=1)
    out["cluster_cbow"] = cluster_gate(
        dev, "hs-cbow", 0.3, 1000, layer_size=24, negative=0,
        use_hierarchic_softmax=True, algorithm="cbow", epochs=8,
        batch_size=256, seed=6)
    return out


def phase_cbow_bf16(smi: str, dev, sents):
    """Phase 16: the word2vec-cbow configuration on bf16 tables (the bag's
    bf16 route, one launch per round), and the cluster corpus on bf16
    tables, CBOW and skip-gram."""
    w = w2v_model(dev, algorithm="cbow", table_dtype="bfloat16")
    w.set_sentence_iterator(sents)
    f = fit_counted(w, "cold")
    check(f["bf16_launches"] == f["launches"] == f["rounds"]
          == W2V_ROUNDS_PER_FIT, f"cbow bf16: {f['bf16_launches']} bf16 "
          f"launches of {f['launches']}, {f['rounds']} rounds, want "
          f"{W2V_ROUNDS_PER_FIT}")
    check_tables(w, "cbow-bf16")
    check(np.isfinite(f["last_loss"]) and f["last_loss"] < np.log(2.0),
          f"cbow bf16: last loss {f['last_loss']} not below ln 2")
    _log_fit("cbow-bf16", f, smi)
    del w
    return {"fit": f,
            "cluster_cbow": cluster_gate(
                dev, "cbow-bf16", 0.3, 1000, layer_size=24, negative=5,
                algorithm="cbow", epochs=10, batch_size=256, seed=2,
                table_dtype="bfloat16"),
            "cluster_skipgram": cluster_gate(
                dev, "skipgram-bf16", 0.3, 1500, layer_size=32, seed=42,
                window=3, negative=5, epochs=3, batch_size=256,
                table_dtype="bfloat16")}


def cluster_docs(n_docs=80, doc_len=30, seed=0, zipf=False):
    """tests/test_nlp.py's documents: even ones from cluster a, odd ones
    from cluster b."""
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(50)]
    B = [f"b{i}" for i in range(50)]
    p = None
    if zipf:
        p = 1.0 / np.arange(1, 51)
        p /= p.sum()
    return [" ".join(rng.choice(A if i % 2 == 0 else B, size=doc_len, p=p))
            for i in range(n_docs)]


def phase_paragraph_vectors(smi: str, dev, sents):
    """Phase 17: PV-DBOW (with the word pass) and PV-DM at layer 100,
    window 5, 5 negatives, sampling 1e-3, batch 8192 on the corpus's first
    400,000 words as 20,000 documents; then tests/test_nlp.py's document
    clusters on the card."""
    from deeplearning4j_tpu_torch.nlp import (LabelAwareIterator,
                                              ParagraphVectors)

    docs = sents[:W2V_CUT_WORDS // 20]
    labels = [f"DOC_{i}" for i in range(len(docs))]
    out = {}
    for dm in (False, True):
        tag = "pv-dm" if dm else "pv-dbow"
        pv = (ParagraphVectors.builder().min_word_frequency(5)
              .layer_size(100).window_size(5).negative_sample(5)
              .sampling(1e-3).epochs(1).batch_size(8192).seed(42).dm(dm)
              .device(dev).iterate(LabelAwareIterator(docs, labels)).build())
        f = fit_counted(pv, "cold")
        f["docs_per_s"] = len(docs) / f["train_s"]
        check_tables(pv, tag)
        check(np.isfinite(f["last_loss"]), f"{tag}: loss not finite")
        if dm:
            check(f["launches"] == f["rounds"] == 64 * f["blocks"] > 0,
                  f"pv-dm: {f['launches']} bag launches for {f['rounds']} "
                  f"rounds")
        else:
            dbow = f["blocks"] - f["sg_blocks"]
            check(f["launches"] == 0 and f["sg_blocks"] == f["readbacks"] > 0
                  and f["rounds"] == 64 * dbow + f["sum_ceil_count_over_b"],
                  f"pv-dbow: {f['rounds']} rounds over {dbow} DBOW and "
                  f"{f['sg_blocks']} skip-gram blocks, {f['launches']} bag "
                  f"launches")
        _log_fit(tag, f, smi)
        log(f"[{tag}] {f['docs_per_s']:.1f} documents/s ({len(docs)} "
            f"documents of 20 words); {smi}")
        out["dm" if dm else "dbow"] = f
        del pv

    def doc_gate(pv, margin):
        same = float(np.mean([pv.similarity("DOC_0", f"DOC_{i}")
                              for i in (2, 4, 6, 8)]))
        diff = float(np.mean([pv.similarity("DOC_0", f"DOC_{i}")
                              for i in (1, 3, 5, 7)]))
        check(same > diff + margin, f"document clusters on the card: same "
              f"{same} not above diff {diff} + {margin}")
        return {"same": same, "diff": diff, "margin": margin}

    small = [f"DOC_{i}" for i in range(80)]
    pv = (ParagraphVectors.builder().min_word_frequency(1).layer_size(24)
          .epochs(10).negative_sample(5).batch_size(256).seed(3).device(dev)
          .iterate(LabelAwareIterator(cluster_docs(), small)).build())
    pv.fit()
    out["cluster_dbow"] = doc_gate(pv, 0.3)
    rng = np.random.default_rng(7)
    near = pv.nearest_labels(pv.infer_vector(" ".join(
        f"a{i}" for i in rng.integers(0, 50, size=25))), 5)
    out["infer_even"] = sum(int(lb.split("_")[1]) % 2 == 0 for lb in near)
    check(out["infer_even"] >= 4, f"infer_vector on the card: nearest "
          f"labels {near}, want >= 4 from cluster a")
    pv = (ParagraphVectors.builder().min_word_frequency(1).layer_size(24)
          .epochs(20).negative_sample(5).batch_size(128).seed(3).dm(True)
          .learning_rate(0.05).device(dev)
          .iterate(LabelAwareIterator(cluster_docs(zipf=True), small))
          .build())
    pv.fit()
    out["cluster_dm"] = doc_gate(pv, 0.2)
    log(f"[paragraph-vectors] document clusters on the card: DBOW same "
        f"{out['cluster_dbow']['same']:.4f} diff "
        f"{out['cluster_dbow']['diff']:.4f} (gate +0.3), infer_vector "
        f"{out['infer_even']} of 5 nearest labels from cluster a, DM same "
        f"{out['cluster_dm']['same']:.4f} diff "
        f"{out['cluster_dm']['diff']:.4f} (gate +0.2)")
    return out


# --- phases 9 and 10 ------------------------------------------------------------

def encoder_conf(vocab=BERT["vocab"], positions=BERT["positions"],
                 seq_len=SEQ_LEN, hidden=BERT["hidden"], layers=BERT["layers"],
                 heads=BERT["heads"], ff=BERT["ff"], classes=2,
                 eps=1e-12, seed=SEED):
    """BERT-base as a DL4J user builds it from the graph builder's layers:
    token and position embeddings (EmbeddingSequenceLayer) added and
    layer-normed, then per layer self-attention (SelfAttentionLayer, no
    projection bias) + residual + LayerNorm and a GELU (erf) feed-forward of
    two TimeDistributed dense layers + residual + LayerNorm; an average
    pool over time and a softmax head over ``classes``. No token-type
    embeddings, no attention mask, a pooled head in place of [CLS]. Inputs
    ``tokens`` and ``positions``, int32 [B, seq_len]."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraphConfiguration, ElementWiseVertex)

    b = NeuralNetConfiguration.builder().seed(seed).data_type("float32")
    gb = ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("tokens", "positions")
    gb.add_layer("tok_emb", L.EmbeddingSequenceLayer(n_out=hidden), "tokens")
    gb.add_layer("pos_emb", L.EmbeddingSequenceLayer(n_out=hidden),
                 "positions")
    gb.add_vertex("emb", ElementWiseVertex(op="add"), "tok_emb", "pos_emb")
    gb.add_layer("emb_ln", L.LayerNormalization(eps=eps), "emb")
    prev = "emb_ln"
    for i in range(layers):
        p = f"l{i}_"
        gb.add_layer(p + "attn", L.SelfAttentionLayer(
            n_out=hidden, n_heads=heads, project_input=True), prev)
        gb.add_vertex(p + "res1", ElementWiseVertex(op="add"), prev,
                      p + "attn")
        gb.add_layer(p + "ln1", L.LayerNormalization(eps=eps), p + "res1")
        gb.add_layer(p + "ff1", L.TimeDistributed(layer=L.DenseLayer(
            n_out=ff, activation="gelu_exact")), p + "ln1")
        gb.add_layer(p + "ff2", L.TimeDistributed(layer=L.DenseLayer(
            n_out=hidden, activation="identity")), p + "ff1")
        gb.add_vertex(p + "res2", ElementWiseVertex(op="add"), p + "ln1",
                      p + "ff2")
        gb.add_layer(p + "ln2", L.LayerNormalization(eps=eps), p + "res2")
        prev = p + "ln2"
    gb.add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"), prev)
    gb.add_layer("out", L.OutputLayer(n_out=classes, activation="softmax",
                                      loss="mcxent"), "pool")
    gb.set_outputs("out")
    gb.set_input_types(InputType.recurrent(vocab, seq_len),
                       InputType.recurrent(positions, seq_len))
    return gb.build()


def encoder_inputs(batch: int, seed: int):
    """Seeded token ids over the vocabulary and positions 0..T-1, int32."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, BERT["vocab"], (batch, SEQ_LEN)).astype(np.int32)
    positions = np.tile(np.arange(SEQ_LEN, dtype=np.int32), (batch, 1))
    return tokens, positions


def _percentile(ms, q):
    ms = sorted(ms)
    return ms[min(len(ms) - 1, int(round(q * (len(ms) - 1))))]


def phase_encoder(smi: str, dev):
    """BERT-base width served through ComputationGraph.output, bf16 compute
    and float32 parameters: 3 warm-ups, then 20 timed batches of 32 and 20
    of 1 with every count set to 0 just before them."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention

    torch.cuda.empty_cache()
    model = ComputationGraph(encoder_conf()).init(seed=SEED, device=dev)
    check(model.num_params() == BERT_PARAMS, f"encoder has "
          f"{model.num_params()} parameters, want {BERT_PARAMS}")
    model.conf.global_conf.compute_dtype = "bfloat16"
    feeds = {b: [tuple(torch.from_numpy(a).to(dev)
                       for a in encoder_inputs(b, SEED + 10 + i))
                 for i in range(ENC_TIMED)] for b in (ENC_BATCH, 1)}
    for _ in range(ENC_WARMUP):
        model.output(*feeds[ENC_BATCH][0])
        model.output(*feeds[1][0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = OpProfiler.get()
    prof.reset()
    attention.reset_launches()
    times = {}
    outs = []
    per_forward = []
    for b in (ENC_BATCH, 1):
        times[b] = []
        for feed in feeds[b]:
            before = attention.flash_attention_launches
            t0 = time.perf_counter()
            out = model.output(*feed)[0]
            torch.cuda.synchronize()
            times[b].append((time.perf_counter() - t0) * 1e3)
            per_forward.append(attention.flash_attention_launches - before)
            outs.append(out)
    launches = attention.flash_attention_launches
    counters = prof.get_counters()
    peak = torch.cuda.max_memory_allocated()
    n_fwd = 2 * ENC_TIMED
    check(per_forward == [BERT["layers"]] * n_fwd, f"flash launches per "
          f"forward {sorted(set(per_forward))}, want {BERT['layers']}")
    check(counters.get("attention/mha_flash", 0) == BERT["layers"] * n_fwd
          and counters.get("attention/mha_dense", 0) == 0,
          f"attention routes {counters}")
    check(counters.get("attention/flash_bf16", 0) == launches
          and counters.get("attention/flash_f32", 0) == 0,
          f"flash routes {counters}: every launch must take the bf16 kernel")
    for out, b in zip(outs, [ENC_BATCH] * ENC_TIMED + [1] * ENC_TIMED):
        o = out.float()
        check(tuple(o.shape) == (b, 2), f"output shape {tuple(o.shape)}")
        check(bool(torch.isfinite(o).all()), "encoder output not finite")
        err = (o.sum(1) - 1).abs().max().item()
        check(err <= 1e-2, f"encoder rows sum to 1 +- {err}")
    result = {"params": model.num_params(), "peak_bytes": peak,
              "launches": launches, "launches_per_forward": BERT["layers"],
              "bf16_route_launches": counters.get("attention/flash_bf16", 0)}
    for b in (ENC_BATCH, 1):
        ms = times[b]
        result[f"b{b}"] = {
            "sequences_per_s": b * len(ms) / sum(ms) * 1e3,
            "p50_ms": _percentile(ms, 0.5), "p99_ms": _percentile(ms, 0.99)}
        r = result[f"b{b}"]
        log(f"[encoder] BERT-base width ({BERT_PARAMS} parameters, "
            f"{BERT['layers']} layers, hidden {BERT['hidden']}, "
            f"{BERT['heads']} heads, T {SEQ_LEN}), bf16 compute, float32 "
            f"parameters, ComputationGraph.output batch {b}: "
            f"{r['sequences_per_s']:.2f} sequences/s, latency p50 "
            f"{r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms ({ENC_TIMED} "
            f"batches after {ENC_WARMUP} warm-ups); {smi}")
    log(f"[encoder] flash_attention launches {launches} = {BERT['layers']} "
        f"per forward x {n_fwd}, all on the bf16 kernel; peak device memory {peak} B; largest "
        f"probability {max(o.float().max().item() for o in outs):.4f}; "
        f"{smi}")
    return model, result


def phase_encoder_parity(model, smi: str, dev):
    """The same encoder in float32 at batch 2: its output on the card (the
    float32 kernel) against the same weights on the CPU (the plain
    version), within 1e-4; then :func:`bf16_parity`. Returns the float32
    error, the float32 route's launches in that run, and bf16_parity's
    numbers."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention
    from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy

    Environment.get().set_tf32(False)
    model.conf.global_conf.compute_dtype = None
    tokens, positions = encoder_inputs(2, SEED + 9)
    prof = OpProfiler.get()
    prof.reset()
    before = attention.flash_attention_launches
    card = model.output(tokens, positions)[0].float().cpu()
    f32_launches = prof.counter_value("attention/flash_f32")
    check(attention.flash_attention_launches == before + BERT["layers"]
          and f32_launches == BERT["layers"],
          "the float32 encoder did not launch the float32 kernel once per "
          "layer")
    cpu = ComputationGraph(encoder_conf()).init(seed=SEED + 1, device="cpu")
    graph_state_from_numpy(cpu, {n: {k: t.cpu().numpy() for k, t in d.items()}
                                 for n, d in model._params.items()}, {})
    t0 = time.perf_counter()
    host = cpu.output(tokens, positions)[0]
    cpu_s = time.perf_counter() - t0
    check(attention.flash_attention_launches == before + BERT["layers"],
          "the CPU run launched the kernel")
    err = (card - host).abs().max().item()
    check(err <= 1e-4, f"encoder card vs CPU float32: max abs err {err} "
          f"not <= 1e-4")
    log(f"[encoder-parity] float32, TF32 off, batch 2: card (float32 flash "
        f"kernel, {f32_launches} launches) vs CPU (plain version) "
        f"probabilities max abs err {err} (<= 1e-4); CPU forward "
        f"{cpu_s:.2f} s; {smi}")
    return err, f32_launches, bf16_parity(smi, dev)


#: bf16 card-against-CPU parity: the last hidden states (unit scale after
#: LayerNorm) may differ by 2% of their norm: bf16 keeps 8 bits (2^-9
#: relative per rounding), the card's matmuls (cuBLAS) and the CPU's round
#: at other places, and the differences compound over the layers; a wrong
#: kernel errs by the states' own size. The card must also stay as close to
#: the float32 states as the CPU's bf16 run is (at most twice as far, plus
#: 1e-3).
BF16_PARITY_TOL = 2e-2
BF16_PARITY_WIDTH = {"hidden": 256, "layers": 2, "heads": 4, "ff": 1024,
                     "vocab": 1000}


def bf16_parity(smi: str, dev):
    """The encoder at a reduced width (BF16_PARITY_WIDTH, head size 64, T
    128, batch 2) in bf16 compute: the last layer's hidden states on the
    card (the bf16 kernel) against the same weights on the CPU (the plain
    version) and against the float32 states on the CPU."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy

    w = BF16_PARITY_WIDTH
    conf = lambda: encoder_conf(vocab=w["vocab"], hidden=w["hidden"],  # noqa: E731
                                layers=w["layers"], heads=w["heads"],
                                ff=w["ff"])
    card = ComputationGraph(conf()).init(seed=SEED + 2, device=dev)
    cpu = ComputationGraph(conf()).init(seed=SEED + 3, device="cpu")
    graph_state_from_numpy(cpu, {n: {k: t.cpu().numpy() for k, t in d.items()}
                                 for n, d in card._params.items()}, {})
    rng = np.random.default_rng(SEED + 11)
    tokens = rng.integers(0, w["vocab"], (2, SEQ_LEN)).astype(np.int32)
    positions = np.tile(np.arange(SEQ_LEN, dtype=np.int32), (2, 1))
    last = f"l{w['layers'] - 1}_ln2"

    def hidden(model, compute_dtype):
        model.conf.global_conf.compute_dtype = compute_dtype
        with torch.inference_mode():
            acts, _ = model._forward(model._params, model._states,
                                     model._bind_inputs((tokens, positions)))
        return acts[last].float().cpu()

    prof = OpProfiler.get()
    prof.reset()
    h_card = hidden(card, "bfloat16")
    launches = prof.counter_value("attention/flash_bf16")
    check(launches == w["layers"]
          and prof.counter_value("attention/flash_f32") == 0,
          f"bf16 parity: flash routes {prof.get_counters()}")
    h_cpu = hidden(cpu, "bfloat16")
    h_f32 = hidden(cpu, None)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    r_cpu, r_card_f32, r_cpu_f32 = (rel(h_card, h_cpu), rel(h_card, h_f32),
                                    rel(h_cpu, h_f32))
    check(r_cpu <= BF16_PARITY_TOL, f"bf16 encoder card vs CPU: relative "
          f"error {r_cpu} > {BF16_PARITY_TOL}")
    check(r_card_f32 <= 2 * r_cpu_f32 + 1e-3, f"bf16 encoder on the card is "
          f"{r_card_f32} from float32, the CPU's bf16 run {r_cpu_f32}")
    log(f"[encoder-parity] bf16 compute at hidden {w['hidden']}, "
        f"{w['layers']} layers, {w['heads']} heads, batch 2, T {SEQ_LEN}: "
        f"last hidden states card (bf16 kernel, {launches} launches) vs CPU "
        f"(plain version) relative error {r_cpu:.5f} (<= "
        f"{BF16_PARITY_TOL}); from the float32 states: card {r_card_f32:.5f}, "
        f"CPU {r_cpu_f32:.5f}; {smi}")
    return {"rel_err_card_vs_cpu": r_cpu, "rel_err_card_vs_f32": r_card_f32,
            "rel_err_cpu_vs_f32": r_cpu_f32, "launches": launches}


# --- phases 11-13: MultiLayerNetwork ---------------------------------------------

LENET_BATCH = 128
LENET_TRAIN = 12_000                # the synthetic MNIST fallback
LENET_STEPS = 94                    # 12,000 at batch 128, the last padded
LENET_PARAMS = 431_080
LENET_BENCH_WARMUP = 3              # bench.py's bench_lenet
LENET_BENCH_STEPS = 50
LENET_PARITY_STEPS = 10
LENET_CPU_STEPS = 5
VGG_BATCH = 64
VGG_PARAMS = 138_357_544            # zoo VGG16 at 1000 classes
VGG_WARMUP = 2
VGG_STEPS = 10
VGG_FLAT = 512 * 7 * 7              # the first dense layer's input width
VGG_PROBE = 8                       # images served before and after the fit
# the masked path: BERT-base widths (google-research/bert
# uncased_L-12_H-768_A-12), at a depth of two attention layers that is no
# published model's: it runs the padding mask at the widths the card sees
MASKED = {"vocab": 30522, "width": 768, "heads": 12, "seq": 128,
          "batch": 32, "min_len": 16}
MASKED_WARMUP = 3
MASKED_TIMED = 20


class StepClock:
    """A listener that waits for the card after every step and keeps the
    host clock and the loss: per-step times of a fit over an iterator."""

    def __init__(self):
        self.stamps = []
        self.losses = []

    def start(self):
        torch.cuda.synchronize()
        self.stamps = [time.perf_counter()]

    def iteration_done(self, model, iteration, score):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        self.losses.append(float(score))

    def step_ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]


def _ms_stats(ms):
    return {"step_ms_median": statistics.median(ms),
            "step_ms_p10": _percentile(ms, 0.1),
            "step_ms_p90": _percentile(ms, 0.9)}


def _ulp_worst(a_tree, b_tree) -> tuple:
    """Largest difference in float32 ulp between two trees of tensors, and
    whether they are bitwise equal."""
    from deeplearning4j_tpu_torch.parallel.sharding import leaf_paths

    worst, bitwise = 0.0, True
    for n, k in leaf_paths(b_tree):
        x, y = a_tree[n][k].detach(), b_tree[n][k].detach()
        bitwise = bitwise and torch.equal(x, y)
        d = (x - y).abs()
        ulps = (d / _f32_ulp_of(torch.maximum(x.abs(), y.abs())
                                .clamp_min(2.0 ** -126))).max().item()
        worst = max(worst, ulps)
    return worst, bitwise


def lenet_batches(n: int, dev, seed: int = SEED):
    """``n`` batches of 128 synthetic MNIST images (the iterator's first
    ones), as DataSets on ``dev``."""
    from deeplearning4j_tpu_torch.data import DataSet, MnistDataSetIterator

    it = MnistDataSetIterator(LENET_BATCH, train=True,
                              num_examples=n * LENET_BATCH, seed=seed,
                              flatten=False)
    return [DataSet(torch.from_numpy(ds.features).to(dev),
                    torch.from_numpy(ds.labels).to(dev)) for ds in it]


def lenet_bench_loop(net, ds):
    """bench.py's bench_lenet loop: fit(ds) on one batch, 3 warm-ups, then
    timed steps, each ending in a wait for the card."""
    for _ in range(LENET_BENCH_WARMUP):
        net.fit(ds)
    torch.cuda.synchronize()
    ms = []
    for _ in range(LENET_BENCH_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"images_per_s": LENET_BATCH * len(ms) / sum(ms) * 1e3,
            **_ms_stats(ms), "last_loss": net.score_value}


def phase_lenet(smi: str, dev):
    """LeNet as bench.py trains it, through MultiLayerNetwork.fit, per-leaf
    and with fused_update; then fused against per-leaf and the card
    against the CPU."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.ops import update

    Environment.get().set_tf32(False)
    train_it = MnistDataSetIterator(LENET_BATCH, train=True, flatten=False)
    test_it = MnistDataSetIterator(LENET_BATCH, train=False, flatten=False)
    check(train_it.synthetic and train_it.total_examples() == LENET_TRAIN
          and test_it.total_examples() == 2000,
          f"MNIST: synthetic {train_it.synthetic}, "
          f"{train_it.total_examples()} + {test_it.total_examples()} images")
    bench_ds = lenet_batches(1, dev)[0]
    prof = OpProfiler.get()
    result = {}
    for fused in (False, True):
        label = "fused" if fused else "per_leaf"
        net = LeNet().init(device=dev)
        net.conf.global_conf.fused_update = fused
        check(net.num_params() == LENET_PARAMS, f"LeNet has "
              f"{net.num_params()} parameters, want {LENET_PARAMS}")
        clock = StepClock()
        net.set_listeners(clock)
        prof.reset()
        update.reset_launches()
        clock.start()
        net.fit(train_it, batch_size=LENET_BATCH)
        torch.cuda.synchronize()
        step_ms = clock.step_ms()
        # the same epoch again without the listener's waits: throughput
        net.set_listeners()
        t0 = time.perf_counter()
        net.fit(train_it, batch_size=LENET_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counters = prof.get_counters()
        launches = update.fused_update_launches
        steps = net._iteration
        check(steps == 2 * LENET_STEPS, f"{steps} steps in two epochs, want "
              f"{2 * LENET_STEPS}")
        check(counters.get("pipeline/padded_batches", 0) == 2,
              f"padded batches {counters.get('pipeline/padded_batches')}, "
              f"want 1 per epoch")
        check(all(np.isfinite(clock.losses)), "non-finite LeNet loss")
        want = steps if fused else 0
        check(launches == want, f"LeNet {label}: fused_update launched "
              f"{launches} times in {steps} steps, want {want}")
        check(counters.get("precision/fused_fallbacks", 0) == 0,
              f"fused fallbacks {counters.get('precision/fused_fallbacks')}")
        if fused:
            check(counters.get("precision/fused_buckets_kernel", 0) == steps,
                  f"kernel buckets "
                  f"{counters.get('precision/fused_buckets_kernel')}")
        ev = net.evaluate(test_it)
        bench = lenet_bench_loop(net, bench_ds)
        r = {"images_per_s": LENET_TRAIN / wall, **_ms_stats(step_ms),
             "steps_per_epoch": LENET_STEPS, "launches": launches,
             "last_loss": clock.losses[-1], "first_loss": clock.losses[0],
             "test_accuracy": ev.accuracy(), "test_examples": ev.count,
             "bench_loop": bench}
        result[label] = r
        log(f"[lenet] {label}: fit(MnistDataSetIterator(128), synthetic "
            f"{LENET_TRAIN} images, {LENET_STEPS} steps, the last padded): "
            f"{r['images_per_s']:.2f} images/s; step ms median "
            f"{r['step_ms_median']:.3f} p10 {r['step_ms_p10']:.3f} p90 "
            f"{r['step_ms_p90']:.3f} (waiting for the card every step); "
            f"loss {r['first_loss']:.4f} -> {r['last_loss']:.4f}; test "
            f"accuracy {r['test_accuracy']:.4f} on {ev.count}; "
            f"fused_update launches {launches} in {steps} steps; {smi}")
        log(f"[lenet] {label}: bench.py loop fit(ds) at batch 128: "
            f"{bench['images_per_s']:.2f} images/s, step ms median "
            f"{bench['step_ms_median']:.3f} p10 {bench['step_ms_p10']:.3f} "
            f"p90 {bench['step_ms_p90']:.3f} ({LENET_BENCH_STEPS} steps "
            f"after {LENET_BENCH_WARMUP} warm-ups); last loss "
            f"{bench['last_loss']:.4f}; {smi}")
        del net
    result["fused_parity"] = lenet_fused_parity(dev)
    result["cpu_parity"] = lenet_cpu_parity(dev)
    return result


def lenet_fused_parity(dev):
    """10 steps through the kernel against 10 through the per-leaf path,
    from the same parameters, float32, TF32 off, deterministic cuDNN.
    Contract: phase 7's, every parameter and momentum element within 2
    float32 ulp."""
    from deeplearning4j_tpu_torch.models import LeNet

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batches = lenet_batches(LENET_PARITY_STEPS, dev, SEED + 5)
        nets = []
        for fused in (True, False):
            net = LeNet().init(device=dev)
            net.conf.global_conf.fused_update = fused
            for ds in batches:
                net.fit(ds)
            torch.cuda.synchronize()
            nets.append(net)
        a, b = nets
        wp, bp = _ulp_worst(a._params, b._params)
        wv, bv = _ulp_worst(a._updater_state["v"], b._updater_state["v"])
        check(wp <= 2 and wv <= 2, f"LeNet fused vs per-leaf after "
              f"{LENET_PARITY_STEPS} steps: params {wp}, momentum {wv} f32 "
              f"ulp (want <= 2)")
        log(f"[lenet-parity] {LENET_PARITY_STEPS} steps, float32, TF32 off, "
            f"deterministic cuDNN: fused kernel vs per-leaf: params within "
            f"{wp:.2f} ulp (bitwise {bp}), momentum within {wv:.2f} ulp "
            f"(bitwise {bv}); bound 2 ulp; losses {a.score_value} vs "
            f"{b.score_value}")
        return {"params_ulp": wp, "momentum_ulp": wv,
                "bitwise": bool(bp and bv)}
    finally:
        torch.backends.cudnn.deterministic = det


def lenet_cpu_parity(dev):
    """Float32 (TF32 off) on the card against the port on the CPU from the
    same seed: the losses of 5 steps within 1e-5 relative."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import LeNet

    batches = lenet_batches(LENET_CPU_STEPS, dev, SEED + 6)
    card, host = LeNet().init(device=dev), LeNet().init(device="cpu")
    worst = 0.0
    pairs = []
    for ds in batches:
        card.fit(ds)
        host.fit(DataSet(ds.features.cpu(), ds.labels.cpu()))
        a, b = card.score_value, host.score_value
        pairs.append((a, b))
        worst = max(worst, abs(a - b) / abs(b))
    check(worst <= 1e-5, f"LeNet card vs CPU losses {pairs}: relative "
          f"{worst} > 1e-5")
    log(f"[lenet-parity] float32, TF32 off: card vs CPU losses of "
        f"{LENET_CPU_STEPS} steps within {worst:.3e} relative (<= 1e-5): "
        f"{pairs}")
    return {"max_rel_err": worst, "losses": pairs}


def vgg_batch(dev, seed: int):
    """A seeded batch of 64 synthetic 8-bit images scaled to [0, 1] by the
    port's ImagePreProcessingScaler (as a DL4J user feeds a zoo model
    trained from scratch), with one-hot labels over 1000 classes, placed on
    the card once. N(0, 1) inputs (phase 6's) drive this configuration's
    loss to NaN within 4 steps, in float32 as in bf16: zoo VGG16 has no
    BatchNormalization, and its learning rate of 0.01 overshoots on inputs
    of that scale (profile_port.py --mln prints the trajectories)."""
    from deeplearning4j_tpu_torch.data import DataSet, ImagePreProcessingScaler

    rng = np.random.RandomState(seed)
    ds = DataSet(rng.randint(0, 256, (VGG_BATCH, 3, IMAGE, IMAGE))
                 .astype(np.uint8),
                 np.eye(1000, dtype=np.float32)[rng.randint(0, 1000,
                                                            VGG_BATCH)])
    ImagePreProcessingScaler().transform(ds)
    return DataSet(torch.from_numpy(ds.features).to(dev),
                   torch.from_numpy(ds.labels).to(dev))


def phase_vgg16(smi: str, dev):
    """Zoo VGG16 at its published widths (224x224x3, 1000 classes),
    training at batch 64: bf16 compute, fused_update, bf16 updater state,
    dropout 0.5 on both 4096-wide layers; 2 warm-ups (which also measure
    dropout's keep share), then 10 timed steps. ``output`` on 8 images
    before and after the steps: the second reads the updated parameters,
    bitwise as a forward with no cached bf16 copies."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.models import VGG16
    from deeplearning4j_tpu_torch.ops import nn as ops
    from deeplearning4j_tpu_torch.ops import update

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = VGG16(seed=SEED).init(device=dev)
    check(net.num_params() == VGG_PARAMS, f"VGG16 has {net.num_params()} "
          f"parameters, want {VGG_PARAMS}")
    gc = net.conf.global_conf
    gc.compute_dtype = "bfloat16"
    gc.fused_update = True
    gc.updater.state_dtype = "bfloat16"
    ds = vgg_batch(dev, SEED + 20)
    probe = ds.features[:VGG_PROBE]
    # output() caches the bf16 copies of the parameters; the fused kernel
    # writes the bucket behind their versions, so the step must drop them
    before = net.output(probe).float()
    shares = []
    draw = ops.dropout_mask

    def recording_mask(shape, rate, generator, device):
        keep = draw(shape, rate, generator, device)
        if tuple(shape) == (VGG_BATCH, VGG_FLAT):
            shares.append(keep.float().mean().item())
        return keep

    losses = []
    ops.dropout_mask = recording_mask
    try:
        for _ in range(VGG_WARMUP):
            net.fit(ds)
            losses.append(net.score_value)
    finally:
        ops.dropout_mask = draw
    torch.cuda.synchronize()
    prof = OpProfiler.get()
    prof.reset()
    update.reset_launches()
    ms = []
    for _ in range(VGG_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_value)
    launches = update.fused_update_launches
    counters = prof.get_counters()
    peak = torch.cuda.max_memory_allocated()
    after = net.output(probe).float()
    net._cast_cache = None
    fresh = net.output(probe).float()
    check(not torch.equal(after, before), "VGG16 output after 12 fused "
          "steps equals the output before them (stale cast cache)")
    check(torch.equal(after, fresh), "VGG16 output after the fused steps "
          "differs from an uncached forward: largest difference "
          f"{(after - fresh).abs().max().item()}")
    check(all(np.isfinite(losses)), f"non-finite VGG16 loss: {losses}")
    check(launches == VGG_STEPS, f"fused_update launched {launches} times "
          f"in {VGG_STEPS} steps (want 1 per step)")
    check(counters.get("precision/fused_fallbacks", 0) == 0,
          f"fused fallbacks {counters.get('precision/fused_fallbacks')}")
    check(len(shares) == VGG_WARMUP and all(abs(s - 0.5) <= 0.01
                                           for s in shares),
          f"dropout keep share on the first dense input {shares}, want "
          f"0.5 +- 0.01 in each of {VGG_WARMUP} steps")
    state_bytes = counters.get("precision/updater_state_bytes_bfloat16", 0)
    result = {"params": VGG_PARAMS, "images_per_s":
              VGG_BATCH * len(ms) / sum(ms) * 1e3, **_ms_stats(ms),
              "peak_bytes": peak, "losses": losses, "launches": launches,
              "keep_shares": shares, "state_bytes": state_bytes,
              "output_after_fit": "fresh"}
    log(f"[vgg16] zoo VGG16 ({VGG_PARAMS} parameters, 224x224x3, 1000 "
        f"classes), batch {VGG_BATCH}, bf16 compute, fused_update, bf16 "
        f"state, dropout 0.5 x2: {result['images_per_s']:.2f} images/s, "
        f"step ms median {result['step_ms_median']:.2f} p10 "
        f"{result['step_ms_p10']:.2f} p90 {result['step_ms_p90']:.2f} "
        f"({VGG_STEPS} steps after {VGG_WARMUP} warm-ups); peak device "
        f"memory {peak} B; fused_update launches {launches}; dropout keep "
        f"share on the [{VGG_BATCH}, {VGG_FLAT}] input {shares}; output "
        f"after the steps changed and equals an uncached forward; {smi}")
    log(f"[vgg16] losses {losses}")
    del net, ds
    torch.cuda.empty_cache()
    return result


def masked_conf(compute_dtype=None):
    """The masked path at BERT-base widths: token embedding (30522 x 768)
    -> self-attention (768, 12 heads) -> LayerNorm -> self-attention ->
    average pool over the real steps -> softmax over 2 classes. Two
    attention layers are no published model's depth: the configuration
    exists to run the padding mask at the widths the card sees."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    w, h = MASKED["width"], MASKED["heads"]
    b = NeuralNetConfiguration.builder().seed(SEED)
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    return (b.list()
            .layer(L.EmbeddingSequenceLayer(n_out=w))
            .layer(L.SelfAttentionLayer(n_out=w, n_heads=h))
            .layer(L.LayerNormalization())
            .layer(L.SelfAttentionLayer(n_out=w, n_heads=h))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax"))
            .set_input_type(InputType.recurrent(MASKED["vocab"],
                                                MASKED["seq"]))
            .build())


def masked_inputs(batch: int, seed: int):
    """Token ids ``[B, T]`` and a feature mask whose real lengths are
    uniform in [16, T], from the seed."""
    rng = np.random.default_rng(seed)
    T = MASKED["seq"]
    tokens = rng.integers(0, MASKED["vocab"], (batch, T)).astype(np.int32)
    lengths = rng.integers(MASKED["min_len"], T + 1, batch)
    fmask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return tokens, fmask


def phase_masked(smi: str, dev):
    """The masked path served through MultiLayerNetwork.output(x, fmask=)
    in bf16 compute; padding invariance; float32 card against the CPU."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import attention

    torch.cuda.empty_cache()
    net = MultiLayerNetwork(masked_conf("bfloat16")).init(seed=SEED,
                                                          device=dev)
    B = MASKED["batch"]
    feeds = [tuple(torch.from_numpy(a).to(dev)
                   for a in masked_inputs(B, SEED + 30 + i))
             for i in range(MASKED_TIMED)]
    for _ in range(MASKED_WARMUP):
        net.output(feeds[0][0], fmask=feeds[0][1])
    torch.cuda.synchronize()
    launch = attention._launch_bf16
    biases = []

    def recording_launch(q, k, v, scale, causal, bias, with_lse):
        biases.append(None if bias is None else tuple(bias.stride()))
        return launch(q, k, v, scale, causal, bias, with_lse)

    prof = OpProfiler.get()
    prof.reset()
    attention.reset_launches()
    outs, ms, per_forward = [], [], []
    attention._launch_bf16 = recording_launch
    try:
        for tokens, fmask in feeds:
            before = attention.flash_attention_launches
            t0 = time.perf_counter()
            out = net.output(tokens, fmask=fmask)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_forward.append(attention.flash_attention_launches - before)
            outs.append(out)
    finally:
        attention._launch_bf16 = launch
    counters = prof.get_counters()
    launches = attention.flash_attention_launches
    check(per_forward == [2] * MASKED_TIMED, f"flash launches per forward "
          f"{sorted(set(per_forward))}, want 2")
    check(counters.get("attention/flash_bf16", 0) == launches
          and counters.get("attention/flash_f32", 0) == 0
          and counters.get("attention/mha_flash", 0) == 2 * MASKED_TIMED
          and counters.get("attention/mha_dense", 0) == 0,
          f"attention routes {counters}")
    # the bias reaches the kernel as the broadcast [B, 1, 1, T] view:
    # zero strides over heads and query rows, no copy
    check(len(biases) == launches and all(
        s is not None and s[1] == 0 and s[2] == 0 for s in biases),
        f"bias strides at the bf16 kernel {sorted(set(biases))}")
    for out in outs:
        o = out.float()
        check(tuple(o.shape) == (B, 2) and bool(torch.isfinite(o).all()),
              f"masked output {tuple(o.shape)} not finite")
        err = (o.sum(1) - 1).abs().max().item()
        check(err <= 1e-2, f"masked rows sum to 1 +- {err}")
    # padding invariance: other token ids at the padded steps
    tokens, fmask = feeds[0]
    rng = np.random.default_rng(SEED + 40)
    other = torch.from_numpy(rng.integers(
        0, MASKED["vocab"], tuple(tokens.shape)).astype(np.int32)).to(dev)
    swapped = torch.where(fmask > 0, tokens, other)
    check(bool((swapped != tokens).any()), "no padded token changed")
    a = net.output(tokens, fmask=fmask).float()
    b = net.output(swapped, fmask=fmask).float()
    pad_bitwise = bool(torch.equal(a, b))
    pad_err = (a - b).abs().max().item()
    check(pad_err <= 1e-6, f"padded tokens changed the output by {pad_err}")
    # float32 on the card (TF32 off) against the CPU at batch 4
    Environment.get().set_tf32(False)
    net.conf.global_conf.compute_dtype = None
    tokens4, fmask4 = masked_inputs(4, SEED + 41)
    prof.reset()
    card = net.output(tokens4, fmask=fmask4).float().cpu()
    check(prof.counter_value("attention/flash_f32") == 2,
          "the float32 masked path did not launch the float32 kernel twice")
    host = MultiLayerNetwork(masked_conf()).init(seed=SEED + 1, device="cpu")
    host.set_params(net.params().cpu())
    want = host.output(tokens4, fmask=fmask4)
    f32_err = (card - want).abs().max().item()
    check(f32_err <= 1e-4, f"masked path card vs CPU float32: {f32_err} "
          f"> 1e-4")
    result = {"params": net.num_params(), "launches": launches,
              "launches_per_forward": 2,
              "sequences_per_s": B * len(ms) / sum(ms) * 1e3,
              "p50_ms": _percentile(ms, 0.5), "p99_ms": _percentile(ms, 0.99),
              "pad_bitwise": pad_bitwise, "pad_max_abs_err": pad_err,
              "f32_card_vs_cpu": f32_err}
    log(f"[masked] MultiLayerNetwork at BERT-base widths (embedding 30522 "
        f"x 768, 2 self-attention layers of 12 heads, LayerNorm, masked "
        f"average pool; {result['params']} parameters), bf16 compute, "
        f"output(x, fmask) at batch {B}, T {MASKED['seq']}, real lengths "
        f"uniform in [{MASKED['min_len']}, {MASKED['seq']}]: "
        f"{result['sequences_per_s']:.2f} sequences/s, latency p50 "
        f"{result['p50_ms']:.3f} ms p99 {result['p99_ms']:.3f} ms "
        f"({MASKED_TIMED} batches after {MASKED_WARMUP} warm-ups); "
        f"flash_attention launches {launches} = 2 per forward, all on the "
        f"bf16 kernel with the mask bias; {smi}")
    log(f"[masked] padded token ids changed: outputs bitwise equal "
        f"{pad_bitwise}, max abs diff {pad_err}; float32 card (float32 "
        f"kernel) vs CPU at batch 4: max abs err {f32_err} (<= 1e-4)")
    del net
    torch.cuda.empty_cache()
    return result


def time_mln_updates(smi: str, dev, flush):
    """fused_update at the MultiLayerNetwork buckets: LeNet's 431,080
    elements (Nesterovs, float32 state, as phase 11 trains it) and VGG16's
    138,357,544 (Nesterovs, bf16 state), kernel against plain version and
    the bound (20 bytes per element). Before it is timed, the kernel is
    held against its plain version at each of these sizes (parameters
    within 2 float32 ulp, float32 moments too, bf16 moments bitwise)."""
    from deeplearning4j_tpu_torch.ops import update

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 50)
    rows = {}
    for name, n, bf16 in (("lenet", LENET_PARAMS, False),
                          ("vgg16", VGG_PARAMS, True)):
        perr, serr, bitwise = compare_fused_update("nesterovs", n, bf16, dev,
                                                   gen)
        torch.cuda.empty_cache()
        p, g, slots, bits = _update_case("nesterovs", n, bf16, dev, gen)
        sr = torch.bfloat16 if bf16 else None
        sc = update._scalars(_updater("nesterovs",
                                      "bfloat16" if bf16 else None),
                             "nesterovs", 3)
        nbytes = 20 * n
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 6 * n / F32_FLOPS_PER_S * 1e3
        rows[name] = {
            "elements": n, "state_dtype": "bfloat16" if bf16 else "float32",
            "ms": _time_ms(lambda: update.fused_update_cuda(
                "nesterovs", sc, p, g, slots, bits, sr), flush),
            "plain_ms": _time_ms(lambda: update.fused_update_reference(
                "nesterovs", sc, p, g, slots, bits, sr), flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "max_err_param": perr, "max_err_moment": serr,
            "bitwise": bitwise}
        r = rows[name]
        log(f"[kernels] fused_update nesterovs {r['state_dtype']} state at "
            f"{name}'s bucket (n={n}): against the plain version param err "
            f"{perr}, moment err {serr}, bitwise {bitwise}; kernel "
            f"{r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {nbytes} B at 3.35 TB/s); median of "
            f"{TIMED_RUNS} (CUDA events, cold L2); {smi}")
        del p, g, slots, bits
    torch.cuda.empty_cache()
    return rows


# --- main -----------------------------------------------------------------------

# --- phase 18: SameDiff BERT-base (TF frozen-graph import) --------------------

#: bench.py --config bert (BASELINE.json configs[2]): BERT-base imported from
#: a frozen GraphDef, a [768, 3] head, Adam(2e-5), float32, batch 32, T 128
SD_BATCH = 32
SD_CLASSES = 3
SD_SERVE_WARMUP, SD_SERVE_TIMED = 2, 20
SD_FIT_WARMUP, SD_FIT_TIMED = 2, 10
#: frozen tensors promoted to variables: the word, type and position tables,
#: 16 per layer, the embedding LayerNorm's 2 and the pooler's 2 (199)
SD_PROMOTED = 3 + 16 * BERT["layers"] + 4
SD_HEAD = BERT["hidden"] * SD_CLASSES + SD_CLASSES
#: the card against the CPU, float32 with TF32 off, at full width, 2 layers,
#: batch 2 (stated before the first card run): the pooled output (tanh, in
#: [-1, 1]) within 1e-4 absolute, the loss within 1e-4 relative, every
#: gradient within 1e-4 of its own largest magnitude on the CPU (a float32
#: product over K = 3072 errs by about sqrt(K) * 2^-24 = 3e-6 of its
#: scale; two layers forward and back stay well inside 1e-4); the key
#: projections' biases, whose gradient is zero in exact arithmetic (the
#: softmax ignores a shift shared by a row), within 1e-6 of the largest
#: gradient of the graph
SD_PARITY = {"layers": 2, "batch": 2, "pooled_abs": 1e-4, "loss_rel": 1e-4,
             "grad_rel": 1e-4, "zero_grad_rel": 1e-6}


def _kernel_counts():
    from deeplearning4j_tpu_torch.ops import (attention, embeddings,
                                              epilogue, update)

    return {"bn_act": epilogue.bn_act_launches,
            "fused_update": update.fused_update_launches,
            "fused_update_members": update.fused_update_member_launches,
            "embedding_bag": embeddings.embedding_bag_launches,
            "flash_attention": attention.flash_attention_launches}


def _reset_kernel_counts():
    from deeplearning4j_tpu_torch.ops import (attention, embeddings,
                                              epilogue, update)

    for m in (attention, embeddings, epilogue, update):
        m.reset_launches()


def bert_dims(batch: int, **over):
    """build_bert_frozen_graph's arguments at BERT-base's widths."""
    return dict(dict(batch=batch, seq=SEQ_LEN, hidden=BERT["hidden"],
                     layers=BERT["layers"], heads=BERT["heads"],
                     intermediate=BERT["ff"], vocab=BERT["vocab"],
                     max_pos=BERT["positions"]), **over)


def bert_fine_tune_graph(sd, hidden: int, batch: int, seed: int):
    """bench.py's _bert_training graph on an imported SameDiff: the frozen
    weights promoted, a [hidden, 3] head (values from ``seed``, the same on
    every device), softmax cross-entropy, Adam(2e-5). Returns the promoted
    names."""
    from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig
    from deeplearning4j_tpu_torch.learning.updaters import Adam

    promoted = sd.convert_to_variables()
    pooled = sd.get_variable(sd.tf_outputs[0])
    rng = np.random.RandomState(seed)
    w = sd.var("cls_w", init=(rng.normal(size=(hidden, SD_CLASSES))
                              * np.sqrt(2.0 / (hidden + SD_CLASSES)))
               .astype(np.float32))
    b = sd.var("cls_b", shape=(SD_CLASSES,), init="zeros")
    pooled.mmul(w).add(b).rename("logits")
    sd.placeholder("labels", shape=(batch, SD_CLASSES))
    sd.ops.softmax_cross_entropy(sd.get_variable("logits"),
                                 sd.get_variable("labels"), name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(TrainingConfig(updater=Adam(2e-5),
                                          loss_name="loss"))
    return promoted


def bert_feed(names, batch: int, dev, seed: int = 0):
    from deeplearning4j_tpu_torch.imports.tf_fixtures import make_bert_batch

    ids, types, mask, y = make_bert_batch(batch, SEQ_LEN, BERT["vocab"],
                                          SD_CLASSES, seed)
    feed = {k: torch.from_numpy(v).to(dev)
            for k, v in zip(names, (ids, types, mask))}
    return feed, torch.from_numpy(y).to(dev)


def phase_samediff_bert(smi: str, dev):
    """bench.py --config bert through the port's entry points at full
    width and depth: write the frozen GraphDef, import it on the card,
    serve the pooled output, fine-tune through SameDiff.fit; then the card
    against the CPU at 2 layers. Every kernel count is 0 on this path (its
    attention arrives as BatchMatMul ops)."""
    from deeplearning4j_tpu_torch.imports import import_frozen_tf
    from deeplearning4j_tpu_torch.imports.tf_fixtures import \
        build_bert_frozen_graph

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data, names, n_params = build_bert_frozen_graph(**bert_dims(SD_BATCH))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = import_frozen_tf(data, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    n_bytes = len(data)
    del data
    promoted = bert_fine_tune_graph(sd, BERT["hidden"], SD_BATCH, SEED)
    elems = sum(sd._vars[n].value.numel() for n in promoted)
    want_elems = n_params - (BERT["positions"] - SEQ_LEN) * BERT["hidden"]
    check(len(promoted) == SD_PROMOTED and elems == want_elems,
          f"promoted {len(promoted)} tensors of {elems} elements, want "
          f"{SD_PROMOTED} of {want_elems}")
    check(sd.variables()[-2:] == ["cls_w", "cls_b"] and
          sum(sd._vars[n].value.numel() for n in sd.variables()) ==
          elems + SD_HEAD, "the head's variables")
    check(all(sd._vars[n].value.device == dev for n in sd.variables()),
          "variables not on the card")
    pooled = sd.tf_outputs[0]
    ops_fwd = len(sd._plan((pooled,)))
    ops_loss = len(sd._plan(("loss",)))
    log(f"[samediff-bert] BERT-base GraphDef ({BERT['layers']} layers, "
        f"hidden {BERT['hidden']}, {BERT['heads']} heads, FF {BERT['ff']}, "
        f"vocab {BERT['vocab']}, {BERT['positions']} positions; {n_params} "
        f"parameters): written in {build_s:.2f} s, {n_bytes} bytes; "
        f"imported on the card in {import_s:.2f} s; {len(promoted)} tensors "
        f"of {elems} elements promoted, head {SD_HEAD}; {ops_fwd} graph ops "
        f"per pooled forward, {ops_loss} to the loss")

    feed, labels = bert_feed(names, SD_BATCH, dev)
    _reset_kernel_counts()
    # serving: the pooled output at batch 32
    for _ in range(SD_SERVE_WARMUP):
        sd.output(feed, [pooled])
    torch.cuda.synchronize()
    serve_ms, outs = [], None
    for _ in range(SD_SERVE_TIMED):
        t0 = time.perf_counter()
        outs = sd.output(feed, [pooled])[pooled]
        torch.cuda.synchronize()
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    check(tuple(outs.shape) == (SD_BATCH, BERT["hidden"]) and
          bool(torch.isfinite(outs).all()), "pooled output shape or values")
    serve = {"sequences_per_s": SD_BATCH * len(serve_ms) / sum(serve_ms)
             * 1e3, "p50_ms": _percentile(serve_ms, 0.5),
             "p99_ms": _percentile(serve_ms, 0.99)}
    log(f"[samediff-bert] serve sd.output(pooled), float32, batch "
        f"{SD_BATCH}, T {SEQ_LEN}: {serve['sequences_per_s']:.2f} "
        f"sequences/s, latency p50 {serve['p50_ms']:.3f} ms p99 "
        f"{serve['p99_ms']:.3f} ms ({SD_SERVE_TIMED} batches after "
        f"{SD_SERVE_WARMUP} warm-ups); {smi}")

    # fine-tune: SameDiff.fit on dict batches
    batch = dict(feed, labels=labels)
    losses = []
    for _ in range(SD_FIT_WARMUP):
        losses.append(sd.fit(batch).final_loss())
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(SD_FIT_TIMED):
        t0 = time.perf_counter()
        hist = sd.fit(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(hist.final_loss())
    peak = torch.cuda.max_memory_allocated()
    counts = _kernel_counts()
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(sd._iteration == SD_FIT_WARMUP + SD_FIT_TIMED, "iterations")
    ms = [t * 1e3 for t in times]
    fit = {"samples_per_s": SD_BATCH * len(times) / sum(times),
           **_ms_stats(ms), "peak_bytes": peak, "first_loss": losses[0],
           "last_loss": losses[-1], "losses": losses}
    log(f"[samediff-bert] fine-tune SameDiff.fit, Adam(2e-5), float32 "
        f"(TF32 off), batch {SD_BATCH}, T {SEQ_LEN}, "
        f"{len(sd.variables())} variables: {fit['samples_per_s']:.2f} "
        f"samples/s, step ms median {fit['step_ms_median']:.2f} p10 "
        f"{fit['step_ms_p10']:.2f} p90 {fit['step_ms_p90']:.2f} "
        f"({SD_FIT_TIMED} steps after {SD_FIT_WARMUP} warm-ups); peak "
        f"device memory {peak} B; loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"{smi}")
    log(f"[samediff-bert] losses {losses}")
    log(f"[samediff-bert] kernel launches on this path (serving and fit): "
        f"{counts}")
    del sd, feed, labels, batch, outs
    torch.cuda.empty_cache()
    parity = samediff_bert_parity(dev, smi)
    seconds = time.perf_counter() - t_phase
    log(f"[samediff-bert] phase {seconds:.1f} s")
    return {"graph_bytes": n_bytes, "build_s": build_s, "import_s": import_s,
            "promoted": len(promoted), "promoted_elements": elems,
            "ops_per_forward": ops_fwd, "ops_to_loss": ops_loss,
            "serve": serve, "fit": fit, "launches": counts,
            "parity": parity, "seconds": seconds}


def samediff_save_check(sd, batch, pooled: str, smi: str):
    """SameDiff save/load on the card at the parity size (full width, 2
    layers, batch 2): the loaded graph's pooled output bitwise the saved
    graph's."""
    import tempfile

    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

    with tempfile.TemporaryDirectory(prefix="dl4j_sd_") as d:
        path = os.path.join(d, "bert.zip")
        t0 = time.perf_counter()
        sd.save(path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = SameDiff.load(path, device=sd.device)
        load_s = time.perf_counter() - t0
    same = torch.equal(sd.output(batch, [pooled])[pooled],
                       back.output(batch, [pooled])[pooled])
    check(same, "SameDiff save/load: the loaded graph's pooled output is "
          "not the saved graph's, bit for bit")
    log(f"[samediff-save] BERT fine-tune graph, full width, 2 layers, batch "
        f"2, on the card: save {save_s:.3f} s ({nbytes} B), load "
        f"{load_s:.3f} s; the loaded graph's pooled output bitwise the "
        f"saved graph's; {smi}")
    return {"bytes": nbytes, "save_s": save_s, "load_s": load_s}


def samediff_bert_parity(dev, smi: str):
    """The fine-tune graph at full width, 2 layers, batch 2, float32 with
    TF32 off, from the same bytes on the card and on the CPU: the pooled
    output, the loss, and every gradient (SD_PARITY); and the card's graph
    saved and loaded (:func:`samediff_save_check`)."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.imports import import_frozen_tf
    from deeplearning4j_tpu_torch.imports.tf_fixtures import \
        build_bert_frozen_graph

    Environment.get().set_tf32(False)
    L, B = SD_PARITY["layers"], SD_PARITY["batch"]
    data, names, _ = build_bert_frozen_graph(**bert_dims(B, layers=L))
    res = []
    for where in (dev, torch.device("cpu")):
        sd = import_frozen_tf(data, device=where)
        bert_fine_tune_graph(sd, BERT["hidden"], B, SEED)
        feed, labels = bert_feed(names, B, where, seed=7)
        batch = dict(feed, labels=labels)
        out = sd.output(batch, [sd.tf_outputs[0], "loss"])
        grads = sd.calculate_gradients(batch, "loss")
        res.append(({k: v.float().cpu() for k, v in out.items()},
                    {k: v.cpu() for k, v in grads.items()}))
        if where == dev:
            saved = samediff_save_check(sd, batch, sd.tf_outputs[0], smi)
        del sd
    (co, cg), (ho, hg) = res
    pooled = next(k for k in co if k != "loss")
    p_err = (co[pooled] - ho[pooled]).abs().max().item()
    l_rel = abs(co["loss"].item() - ho["loss"].item()) / abs(ho["loss"].item())
    top = max(g.abs().max().item() for g in hg.values())
    key_biases = {f"add_{5 + 14 * i}/y_0" for i in range(L)}
    worst, worst_name, worst_zero = 0.0, None, 0.0
    for n, g in hg.items():
        err = (cg[n] - g).abs().max().item()
        if n in key_biases:
            worst_zero = max(worst_zero, err / top)
            continue
        rel = err / g.abs().max().item()
        if rel > worst:
            worst, worst_name = rel, n
    check(p_err <= SD_PARITY["pooled_abs"], f"pooled card vs CPU {p_err}")
    check(l_rel <= SD_PARITY["loss_rel"], f"loss card vs CPU {l_rel}")
    check(worst <= SD_PARITY["grad_rel"], f"gradient {worst_name} card vs "
          f"CPU {worst} of its largest magnitude")
    check(worst_zero <= SD_PARITY["zero_grad_rel"], f"key-bias gradients "
          f"card vs CPU {worst_zero} of the largest gradient")
    log(f"[samediff-bert] card vs CPU, float32, TF32 off, full width, {L} "
        f"layers, batch {B}: pooled max abs err {p_err} (<= 1e-4), loss rel "
        f"err {l_rel} (<= 1e-4), {len(hg)} gradients: worst {worst} of its "
        f"largest magnitude ({worst_name}; <= 1e-4), key biases {worst_zero} "
        f"of the largest gradient (<= 1e-6)")
    return {"save": saved, "pooled_max_abs_err": p_err,
            "loss_rel_err": l_rel,
            "grad_worst_rel": worst, "grad_worst": worst_name,
            "key_bias_rel": worst_zero, "gradients": len(hg)}


# --- phases 19-23: the host pair path, FastText, GloVe, DeepWalk, serializer ----

FT_WORDS = 400_000                    # bench.py --config fasttext
FT_BUCKET = 100_000
#: fastText's default subsampling threshold (its -t), which bench.py's
#: configuration leaves out: without it both packages diverge to NaN
FT_SAMPLING = 1e-4
FT_LONG_G = 39                        # a word of 11 characters: 4 * 11 - 5
GLOVE_WORDS = 1_000_000               # bench.py --config glove
#: BlogCatalog as DeepWalk's paper uses it (Perozzi et al. 2014, section 6):
#: 10,312 vertices, 333,983 edges, 39 groups; walk length 40, window 10,
#: dimension 128. Walks per vertex cut from the paper's 80 to 2: the walk
#: sampler is a Python loop on the host (nlp/graph_vectors.random_walks).
BLOG = {"vertices": 10_312, "edges": 333_983, "groups": 39,
        "walk_length": 40, "window": 10, "dim": 128, "walks": 2,
        "published_walks": 80}
#: the stochastic block model that stands in for BlogCatalog's graph: this
#: share of each vertex's edges stays inside its group
SBM_WITHIN = 0.8
DW_PAIRS = 2000                       # vertex pairs per similarity mean
DW_QUERIES = 500                      # vertices whose neighbours are read


def breadth_corpus(n=1200, vocab_half=20, seed=0):
    """tests/test_nlp_breadth.py's corpus: even sentences from a0..a19, odd
    ones from b0..b19."""
    rng = np.random.default_rng(seed)
    return [" ".join(f"{'a' if i % 2 == 0 else 'b'}{j}"
                     for j in rng.integers(0, vocab_half, 12))
            for i in range(n)]


def _mean_sim(m, pairs):
    return float(np.mean([m.similarity(x, y) for x, y in pairs]))


def phase_w2v_host(smi: str, dev, sents):
    """Phase 19: the host pair path (device_corpus = False) at phase 14's
    hyperparameters on the corpus's first 400,000 words: skip-gram (pairs
    from the native helper), CBOW, and PV-DM on 20,000 documents; then the
    host-path gates of tests/test_nlp.py on the card."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.nlp import (LabelAwareIterator,
                                              ParagraphVectors)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native.load()          # raises with g++'s output when the build fails
    build_s = time.perf_counter() - t0
    log(f"[w2v-host] native helper {native.LIBRARY.name} built and loaded "
        f"in {build_s:.2f} s (g++ -O3)")
    cut = sents[:W2V_CUT_WORDS // 20]
    out = {"native_build_s": build_s}
    models = {}
    docs_labels = [f"DOC_{i}" for i in range(len(cut))]
    for tag in ("skipgram", "cbow", "pv-dm"):
        if tag == "pv-dm":
            m = (ParagraphVectors.builder().min_word_frequency(5)
                 .layer_size(100).window_size(5).negative_sample(5)
                 .sampling(1e-3).epochs(1).batch_size(8192).seed(42).dm(True)
                 .device(dev).iterate(LabelAwareIterator(cut, docs_labels))
                 .build())
        else:
            m = w2v_model(dev, algorithm=tag)
            m.set_sentence_iterator(cut)
        m.device_corpus = False
        calls0 = native.sg_pairs_calls
        f = fit_counted(m, "cold")
        f["native_calls"] = native.sg_pairs_calls - calls0
        f["producer_wait_s"] = m.last_fit_timing["producer_wait"]
        check_tables(m, f"w2v-host {tag}")
        check(np.isfinite(f["last_loss"]), f"w2v-host {tag}: loss not "
              f"finite")
        check(f["rounds"] == 64 * f["blocks"] > 0 and f["readbacks"] == 0,
              f"w2v-host {tag}: {f['rounds']} rounds in {f['blocks']} "
              f"blocks of 64")
        if tag == "skipgram":
            check(f["native_calls"] > 0, "w2v-host skipgram: the native "
                  "helper made no pairs")
            check(f["launches"] == 0, f"w2v-host skipgram: {f['launches']} "
                  f"bag launches, skip-gram has no bag")
            check(f["blocks"] >= 2 and f["last_loss"] < f["first_loss"],
                  f"w2v-host skipgram: last loss {f['last_loss']} not below "
                  f"the first block's {f['first_loss']} ({f['blocks']} "
                  f"blocks)")
        else:
            # the examples fit one flush, made after the producer consumed
            # every word, so it trains at min_learning_rate (the JAX host
            # path's schedule): one block, the loss close to its start of
            # ln 2 (syn1neg starts at 0); the gate is that the rounds ran
            # and moved the output table
            check(f["launches"] == f["rounds"] and f["bf16_launches"] == 0,
                  f"w2v-host {tag}: {f['launches']} embedding_bag launches "
                  f"for {f['rounds']} rounds, want one per round")
            check(f["last_loss"] < np.log(2.0)
                  and np.abs(m.lookup_table.syn1neg).max() > 0,
                  f"w2v-host {tag}: loss {f['last_loss']} not below ln 2 or "
                  f"syn1neg untrained")
        _log_fit(f"w2v-host {tag}", f, smi)
        log(f"[w2v-host {tag}] {f['words_per_s']:.1f} words/s; consumer "
            f"waited {f['producer_wait_s']:.3f} s of {f['train_s']:.3f} s "
            f"for the producer thread; {f['native_calls']} native "
            f"sg_pairs calls; {smi}")
        out[tag] = f
        models[tag] = m
    del models["pv-dm"], models["cbow"]
    out["cluster_skipgram"] = cluster_gate(
        dev, "w2v-host skipgram", 0.4, 1000, device_corpus=False,
        layer_size=24, epochs=3, batch_size=256, seed=2)
    w = w2v_model(dev, algorithm="cbow", min_word_frequency=5, layer_size=16,
                  negative=3, epochs=2, batch_size=128, seed=2, sampling=0.0)
    w.device_corpus = False
    w.set_sentence_iterator(cluster_corpus(300, 8))
    w.fit()
    check(np.isfinite(w.last_loss) and w.table_device.type == "cuda",
          "tests/test_nlp.py:312 (CBOW host path) on the card: loss not "
          "finite")
    small = [f"DOC_{i}" for i in range(80)]
    pv = (ParagraphVectors.builder().min_word_frequency(1).layer_size(24)
          .epochs(10).negative_sample(5).batch_size(256).seed(3).device(dev)
          .iterate(LabelAwareIterator(cluster_docs(), small)).build())
    pv.device_corpus = False
    pv.fit()
    same = _mean_sim(pv, [("DOC_0", f"DOC_{i}") for i in (2, 4, 6, 8)])
    diff = _mean_sim(pv, [("DOC_0", f"DOC_{i}") for i in (1, 3, 5, 7)])
    check(same > diff + 0.3, f"PV host path document clusters on the card "
          f"(tests/test_nlp.py:592): same {same} not above diff {diff} + 0.3")
    out["pv_host_cluster"] = {"same": same, "diff": diff, "margin": 0.3}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[w2v-host] CBOW host gate (tests/test_nlp.py:312) loss "
        f"{w.last_loss:.4f}; PV-DBOW host document clusters same "
        f"{same:.4f} diff {diff:.4f} (gate +0.3); phase {out['seconds']:.1f} "
        f"s; {smi}")
    return out, models["skipgram"]


def fasttext_bag_cases(ft, sents, dev, gen):
    """The bag at FastText's path: (1) 8190 centers drawn from the corpus
    stream, their subword rows and mask, on the trained table; (2) the same
    table with 8190 words of 3 to 11 letters (G = 39 columns, shorter
    words padded), their own rows and hashed n-grams."""
    from deeplearning4j_tpu_torch.nlp.fasttext import char_ngrams

    table = torch.from_numpy(ft.lookup_table.syn0).to(dev)
    B = ft._round_pairs
    flat = np.concatenate(ft._encode_corpus(
        [s.split() for s in sents[:5000]]))
    rng = np.random.default_rng(SEED)
    c = flat[rng.integers(0, flat.size, B)]
    idx = torch.from_numpy(ft._subword_ids[c]).to(dev)
    mask = torch.from_numpy(ft._subword_mask[c]).to(dev)
    path = (table, idx, mask, mask.sum(1).clamp_min(1.0))
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    V = len(ft.vocab)
    rows = np.zeros((B, FT_LONG_G), np.int32)
    lmask = np.zeros((B, FT_LONG_G), np.float32)
    for b in range(B):
        L = 11 if b % 4 == 0 else int(rng.integers(3, 12))
        word = "".join(rng.choice(letters, L))
        ids = ft.subword_row_ids(word, int(rng.integers(0, V)))
        check(len(ids) == 4 * L - 5 <= FT_LONG_G, f"{len(ids)} rows for a "
              f"word of {L} letters")
        rows[b, :len(ids)] = ids
        lmask[b, :len(ids)] = 1.0
    check(len(char_ngrams("a" * 11, 3, 6)) + 1 == FT_LONG_G, "G 39")
    lm = torch.from_numpy(lmask).to(dev)
    long = (table, torch.from_numpy(rows).to(dev), lm,
            lm.sum(1).clamp_min(1.0))
    return path, long


def phase_fasttext(smi: str, dev, sents):
    """Phase 20: bench.py --config fasttext (400,000 words, min frequency
    5, layer 100, window 5, 5 negatives, 1 epoch, batch 8192, seed 42,
    bucket 100,000, minn 3, maxn 6): once as it stands (logged), then with
    subsampling at FT_SAMPLING, cold and warm, gated; the gates of
    tests/test_nlp_breadth.py on the card; then the bag bitwise against its
    plain version and timed at the path's shape and at G = 39."""
    from deeplearning4j_tpu_torch.nlp import FastText
    from deeplearning4j_tpu_torch.ops import embeddings

    t_phase = time.perf_counter()
    cut = sents[:FT_WORDS // 20]

    def bench_fasttext(sampling):
        ft = (FastText.builder().min_word_frequency(5).layer_size(100)
              .negative_sample(5).epochs(1).batch_size(8192).seed(42)
              .bucket(FT_BUCKET).minn(3).maxn(6).device(dev).iterate(cut)
              .build())
        ft.sampling = sampling
        return ft

    # bench.py's configuration as it stands leaves subsampling off; the JAX
    # package reaches NaN there on the CPU, and the port is expected to do
    # the same: one cold fit, logged and not gated
    raw = bench_fasttext(0.0)
    raw_fit = fit_counted(raw, "bench.py as is")
    raw_fit["finite"] = bool(np.isfinite(raw.lookup_table.syn0).all())
    _log_fit("fasttext", raw_fit, smi)
    log(f"[fasttext] bench.py's configuration as is (no subsampling): "
        f"tables finite {raw_fit['finite']}, last loss "
        f"{raw_fit['last_loss']} (not gated); the gated fits below add "
        f"fastText's own default subsampling t = {FT_SAMPLING}")
    del raw
    ft = bench_fasttext(FT_SAMPLING)
    shapes = []
    real_launch = embeddings.embedding_bag_cuda

    def recording(table, indices, mask, counts, mean):
        shapes.append((tuple(indices.shape), tuple(table.shape)))
        return real_launch(table, indices, mask, counts, mean)

    init = {}
    real_build = ft.build_vocab

    def keep_init(tokens):
        real_build(tokens)
        init["syn0"] = ft.lookup_table.syn0.copy()

    ft.build_vocab = keep_init
    embeddings.embedding_bag_cuda = recording
    try:
        fits = []
        for label in ("cold", "warm"):
            n0 = len(shapes)
            f = fit_counted(ft, label)
            f["bag_shapes"] = sorted(set(shapes[n0:]))
            fits.append(f)
    finally:
        embeddings.embedding_bag_cuda = real_launch
        del ft.build_vocab
    V = len(ft.vocab)
    B, G = ft._round_pairs, ft._subword_ids.shape[1]
    lt = ft.lookup_table
    check(lt.syn0.shape == lt.syn1neg.shape == (V + FT_BUCKET, 100),
          f"tables {lt.syn0.shape} and {lt.syn1neg.shape}, want "
          f"[{V} + {FT_BUCKET}, 100]")
    check_tables(ft, "fasttext")
    for f in fits:
        check(f["launches"] == f["rounds"] == f["sum_ceil_count_over_b"] > 0
              and f["bf16_launches"] == 0, f"fasttext {f['fit']}: "
              f"{f['launches']} bag launches for {f['rounds']} rounds "
              f"(sum ceil(count/B) {f['sum_ceil_count_over_b']})")
        check(f["bag_shapes"] == [((B, G), (V + FT_BUCKET, 100))],
              f"fasttext {f['fit']}: bag shapes {f['bag_shapes']}, want "
              f"[{B}, {G}] of [{V + FT_BUCKET}, 100]")
        check(np.isfinite(f["last_loss"])
              and f["last_loss"] < fits[0]["first_loss"],
              f"fasttext {f['fit']}: last loss {f['last_loss']} not below "
              f"the cold fit's first block's {fits[0]['first_loss']}")
        _log_fit("fasttext", f, smi)
    moved = int((np.abs(lt.syn0[V:] - init["syn0"][V:]).sum(1) > 0).sum())
    check(moved > 1000, f"fasttext: {moved} bucket rows trained")
    log(f"[fasttext] vocabulary {V}, G {G} subword columns, table "
        f"[{V + FT_BUCKET}, 100], B {B} pairs per round; {moved} of "
        f"{FT_BUCKET} bucket rows trained; similarity(w1, w2) "
        f"{ft.similarity('w1', 'w2'):.4f}; OOV w99999 vector norm "
        f"{np.linalg.norm(ft.get_word_vector('w99999')):.4f}; {smi}")
    gates = {}
    c = FastText.builder().min_word_frequency(3).layer_size(24).epochs(4) \
        .negative_sample(5).batch_size(512).seed(2).bucket(4096).device(dev) \
        .iterate(breadth_corpus()).build()
    c.fit()
    gates["same"] = _mean_sim(c, [("a0", f"a{i}") for i in range(1, 6)])
    gates["diff"] = _mean_sim(c, [("a0", f"b{i}") for i in range(5)])
    gates["oov_a"] = _mean_sim(c, [("a00", f"a{i}") for i in range(5)])
    gates["oov_b"] = _mean_sim(c, [("a00", f"b{i}") for i in range(5)])
    v = c.get_word_vector("a0a1")
    check(gates["same"] > gates["diff"] + 0.2, f"fasttext cluster gate on "
          f"the card: {gates}")
    check(gates["oov_a"] > gates["oov_b"], f"fasttext OOV gate: {gates}")
    check(v.shape == (24,) and np.isfinite(v).all() and np.abs(v).sum() > 0,
          "fasttext OOV vector")
    rng = np.random.default_rng(4)
    pools = {0: [f"app{i}le" for i in range(8)],
             1: [f"zur{i}ich" for i in range(8)]}
    dsents = [" ".join(rng.choice(pools[int(rng.integers(0, 2))], size=10))
              for _ in range(240)]
    d = FastText.builder().min_word_frequency(1).layer_size(24) \
        .negative_sample(5).epochs(8).batch_size(256).seed(3).bucket(2000) \
        .device(dev).iterate(dsents).build()
    d.fit()
    mat = d.get_word_vector_matrix()
    mat = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-12)
    words = list(d.vocab.words())
    a = [i for i, w in enumerate(words) if w.startswith("app")]
    z = [i for i, w in enumerate(words) if w.startswith("zur")]
    gates["within"] = float(np.mean([mat[i] @ mat[k] for i in a for k in a
                                     if i != k]))
    gates["across"] = float(np.mean([mat[i] @ mat[k] for i in a for k in z]))
    check(gates["within"] > gates["across"] + 0.2, f"fasttext device-path "
          f"subword clusters on the card: {gates}")
    check(np.linalg.norm(d.get_word_vector("app9le")) > 0, "OOV app9le")
    log(f"[fasttext] gates on the card (tests/test_nlp_breadth.py): cluster "
        f"same {gates['same']:.4f} diff {gates['diff']:.4f} (+0.2), OOV a00 "
        f"to a {gates['oov_a']:.4f} to b {gates['oov_b']:.4f}, subword "
        f"clusters within {gates['within']:.4f} across "
        f"{gates['across']:.4f} (+0.2)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    bag = {}
    for name, case in zip(("path", "long"),
                          fasttext_bag_cases(ft, cut, dev, gen)):
        table, idx, mask, counts = case
        for mean in (True, False):
            got = embeddings.embedding_bag_cuda(table, idx, mask, counts,
                                                mean)
            want = embeddings.embedding_bag_reference(table, idx, mask,
                                                      counts, mean)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"fasttext bag {name} mean={mean}"
                  f": not bitwise its plain version (max "
                  f"{(got - want).abs().max().item()})")
        Bc, Wc = idx.shape
        t = time_embedding_bag(Bc, Wc, table.shape[0], table.shape[1], dev,
                               gen, flush, "fasttext " + name, case=case)
        t["max_abs_err"] = 0.0
        bag[name] = t
        log(f"[fasttext] embedding_bag {name} [{Bc}, {Wc}] x "
            f"{list(table.shape)} ({t['distinct_rows']} distinct rows, "
            f"bitwise mean and sum): kernel {t['ms']:.4f} ms cold, "
            f"{t['ms_warm']:.4f} ms warm, host {t['host_us']:.1f} us; plain "
            f"{t['plain_ms']:.4f} ms, F.embedding_bag/counts "
            f"{t['library_ms']:.4f} ms, unfused {t['unfused_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B); "
            f"median of {TIMED_RUNS} (CUDA events, cold L2); {smi}")
    del flush
    out = {"fits": fits, "bench_as_is": raw_fit, "sampling": FT_SAMPLING,
           "vocab": V, "G": G, "bucket_rows_trained": moved,
           "gates": gates, "bag": bag,
           "seconds": time.perf_counter() - t_phase}
    log(f"[fasttext] phase {out['seconds']:.1f} s")
    return out, ft


def phase_glove(smi: str, dev, sents):
    """Phase 21: bench.py --config glove (1,000,000 words, min frequency 5,
    layer 100, window 5, 5 epochs, batch 8192, seed 42, x_max 100, alpha
    0.75, lr 0.05); then tests/test_nlp_breadth.py's cluster gate on the
    card."""
    from deeplearning4j_tpu_torch.nlp import Glove

    t_phase = time.perf_counter()
    cut = sents[:GLOVE_WORDS // 20]
    g = (Glove.builder().min_word_frequency(5).layer_size(100)
         .window_size(5).epochs(5).batch_size(8192).seed(42).x_max(100.0)
         .alpha(0.75).learning_rate(0.05).device(dev).iterate(cut).build())
    t0 = time.perf_counter()
    g.fit()
    wall = time.perf_counter() - t0
    tm = g.last_fit_timing
    check(g.table_device.type == "cuda", "glove: not on the card")
    check(bool(np.isfinite(g.lookup_table.syn0).all()), "glove: tables not "
          "finite")
    check(tm["rounds"] == 64 * tm["blocks"] > 0, f"glove: {tm}")
    check(np.isfinite(g.last_loss) and g.last_loss < g.first_loss,
          f"glove: last loss {g.last_loss} not below the first block's "
          f"{g.first_loss}")
    train_wps = tm["words"] / tm["train"]
    log(f"[glove] vocabulary {len(g.vocab)}, {tm['nnz']} co-occurrence "
        f"triplets, {tm['rounds']} rounds in {tm['blocks']} blocks; "
        f"{g.words_per_sec:.1f} words/s with the host co-occurrence count "
        f"({tm['cooccur']:.3f} s) and {tm['train']:.3f} s on the card, "
        f"{train_wps:.1f} words/s over the training alone; "
        f"{1e3 * tm['train'] / tm['rounds']:.3f} ms per round; first "
        f"block's loss {g.first_loss:.4f}, last loss {g.last_loss:.4f}; fit "
        f"wall {wall:.3f} s; {smi}")
    c = (Glove.builder().min_word_frequency(3).layer_size(24).window_size(8)
         .epochs(30).learning_rate(0.05).batch_size(1024).seed(1).device(dev)
         .iterate(breadth_corpus()).build())
    c.fit()
    same = _mean_sim(c, [("a0", f"a{i}") for i in range(1, 6)])
    diff = _mean_sim(c, [("a0", f"b{i}") for i in range(5)])
    check(same > diff + 0.3, f"glove cluster gate on the card: same {same} "
          f"diff {diff}")
    out = {"words_per_s": g.words_per_sec, "train_words_per_s": train_wps,
           "timing": tm, "first_loss": g.first_loss,
           "last_loss": g.last_loss, "vocab": len(g.vocab),
           "cluster": {"same": same, "diff": diff, "margin": 0.3},
           "seconds": time.perf_counter() - t_phase}
    log(f"[glove] cluster corpus on the card (tests/test_nlp_breadth.py:47): "
        f"same {same:.4f} diff {diff:.4f} (gate +0.3); phase "
        f"{out['seconds']:.1f} s")
    return out


def blogcatalog_sbm(seed: int):
    """A stochastic block model at BlogCatalog's size: 10,312 vertices in
    39 groups of near-equal size, 333,983 distinct undirected edges without
    loops, SBM_WITHIN of them inside a group (their endpoints uniform over
    the group), the rest uniform over the graph. Returns (Graph, group of
    each vertex)."""
    from deeplearning4j_tpu_torch.nlp import Graph

    n, m, k = BLOG["vertices"], BLOG["edges"], BLOG["groups"]
    rng = np.random.default_rng(seed)
    group = rng.permutation(np.arange(n) % k)
    order = np.argsort(group, kind="stable")
    sizes = np.bincount(group, minlength=k)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    keys = np.empty(0, np.int64)
    while keys.size < m:
        need = int((m - keys.size) * 1.3) + 16
        a = rng.integers(0, n, need)
        g = group[a]
        inside = order[starts[g] + (rng.random(need) * sizes[g])
                       .astype(np.int64)]
        b = np.where(rng.random(need) < SBM_WITHIN, inside,
                     rng.integers(0, n, need))
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        new = (lo * n + hi)[lo != hi]
        keys = np.unique(np.concatenate([keys, new]))
    keys = rng.permutation(keys)[:m]
    graph = Graph(n)
    for key in keys.tolist():
        graph.add_edge(key // n, key % n)
    return graph, group


def two_communities(k=8, bridge=1):
    """tests/test_nlp_breadth.py's graph: two k-cliques and a bridge."""
    from deeplearning4j_tpu_torch.nlp import Graph

    g = Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    for b in range(bridge):
        g.add_edge(b, k + b)
    return g


def phase_deepwalk(smi: str, dev):
    """Phase 22: DeepWalk at BlogCatalog's published setting (BLOG), with
    2 walks per vertex; then Node2Vec (p 0.5, q 2) on
    tests/test_nlp_breadth.py's two-community graph, gated as there."""
    from deeplearning4j_tpu_torch.nlp import DeepWalk, Node2Vec

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    graph, group = blogcatalog_sbm(SEED)
    graph_s = time.perf_counter() - t0
    edges = sum(len(graph.neighbors(v)) for v in range(graph.n)) // 2
    check(edges == BLOG["edges"], f"{edges} edges")
    dw = (DeepWalk.builder().window_size(BLOG["window"])
          .vector_size(BLOG["dim"]).walk_length(BLOG["walk_length"])
          .num_walks(BLOG["walks"]).seed(42).device(dev).build())
    t0 = time.perf_counter()
    dw.fit(graph)
    wall = time.perf_counter() - t0
    w2v = dw._w2v
    check(w2v.table_device.type == "cuda", "deepwalk: not on the card")
    check(len(w2v.vocab) == BLOG["vertices"], f"{len(w2v.vocab)} vertices "
          f"in the vocabulary")
    check(bool(np.isfinite(w2v.lookup_table.syn0).all()), "deepwalk: tables "
          "not finite")
    norm = w2v.lookup_table.normalized()
    row = np.array([w2v.vocab.index_of(str(v)) for v in range(graph.n)])
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, graph.n, 4 * DW_PAIRS)
    b = rng.integers(0, graph.n, 4 * DW_PAIRS)
    keep = a != b
    a, b = a[keep], b[keep]
    sims = (norm[row[a]] * norm[row[b]]).sum(1)
    same_g = group[a] == group[b]
    # the same-group pairs: partners drawn from the first vertex's group
    members = [np.flatnonzero(group == k) for k in range(BLOG["groups"])]
    sa = rng.integers(0, graph.n, DW_PAIRS)
    sb = np.array([rng.choice(members[group[v]]) for v in sa])
    keep = sa != sb
    within = float((norm[row[sa[keep]]] * norm[row[sb[keep]]]).sum(1).mean())
    across = float(sims[~same_g][:DW_PAIRS].mean())
    check(within > across, f"deepwalk: within-group similarity {within} not "
          f"above across-group {across}")
    # the raw cosines share a common direction (all near 1): the nearest
    # neighbours say more, 10 of each of DW_QUERIES vertices, against
    # 1/39 from the same group by chance
    q = rng.integers(0, graph.n, DW_QUERIES)
    sims = norm[row[q]] @ norm[row].T
    sims[np.arange(DW_QUERIES), q] = -2.0
    top = np.argsort(-sims, axis=1)[:, :10]
    share = float((group[top] == group[q][:, None]).mean())
    check(share >= 0.5, f"deepwalk: {share:.3f} of the 10 nearest vertices "
          f"in the query's group, want >= 0.5 (chance "
          f"{1 / BLOG['groups']:.3f})")
    fit_s = w2v.last_fit_timing["train"]
    out = {"graph_s": graph_s, "walk_s": dw.walk_seconds,
           "fit_wall_s": wall, "train_s": fit_s,
           "words_per_s": w2v.words_per_sec, "pairs_per_s":
           w2v.pairs_per_sec, "within": within, "across": across,
           "nearest10_same_group": share,
           "walks": BLOG["walks"], "published_walks": BLOG["published_walks"],
           "first_loss": w2v.first_loss, "last_loss": w2v.last_loss,
           "blocks": w2v.last_fit_timing["blocks"]}
    log(f"[deepwalk] BlogCatalog-size SBM ({graph.n} vertices, {edges} "
        f"edges, {BLOG['groups']} groups, {SBM_WITHIN:.0%} of edges within "
        f"a group; built in {graph_s:.2f} s); walk length "
        f"{BLOG['walk_length']}, window {BLOG['window']}, dimension "
        f"{BLOG['dim']}; walks per vertex CUT from {BLOG['published_walks']} "
        f"to {BLOG['walks']} (the Python sampler): walks "
        f"{dw.walk_seconds:.2f} s on the host, fit {w2v.words_per_sec:.1f} "
        f"words/s ({w2v.pairs_per_sec:.1f} pairs/s) over {fit_s:.3f} s on "
        f"the card, {out['blocks']} blocks, first block's loss "
        f"{w2v.first_loss:.4f}, last {w2v.last_loss:.4f}; cosine within a "
        f"group {within:.4f}, across {across:.4f}; {share:.3f} of 10 nearest "
        f"vertices from the query's group (chance "
        f"{1 / BLOG['groups']:.3f}, gate 0.5); {smi}")
    g = two_communities()
    n2v = Node2Vec(window_size=4, vector_size=16, walk_length=30,
                   num_walks=12, epochs=3, seed=1, p=0.5, q=2.0, device=dev)
    n2v.fit(g)
    same = float(np.mean([n2v.similarity(1, j) for j in range(2, 6)]))
    diff = float(np.mean([n2v.similarity(1, 8 + j) for j in range(2, 6)]))
    check(same > diff + 0.3, f"node2vec on the card: same {same} diff "
          f"{diff}")
    out["node2vec"] = {"same": same, "diff": diff, "margin": 0.3}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[deepwalk] Node2Vec p 0.5 q 2 on the two-community graph "
        f"(tests/test_nlp_breadth.py:145): same {same:.4f} diff {diff:.4f} "
        f"(gate +0.3); phase {out['seconds']:.1f} s")
    return out


def phase_serializer(smi: str, dev, sg, ft, sents):
    """Phase 23: phase 19's skip-gram and phase 20's FastText written as
    text, binary and the model zip, read back onto the card: tables bitwise
    after the zip, text within its six digits, binary bitwise, the same
    nearest words; a fit resumed from the skip-gram zip starts below the
    first fit's first block."""
    import tempfile

    from deeplearning4j_tpu_torch.nlp import (read_word2vec_model,
                                              read_word_vectors,
                                              write_word2vec_model,
                                              write_word_vectors)

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, m in (("skipgram", sg), ("fasttext", ft)):
            want = m.get_word_vector_matrix()
            sizes = {}
            for fmt in ("text", "binary"):
                p = f"{d}/{name}.{fmt}"
                write_word_vectors(m, p, binary=fmt == "binary")
                sizes[fmt] = len(open(p, "rb").read())
                r = read_word_vectors(p, binary=fmt == "binary")
                got = r.lookup_table.syn0
                check(r.vocab.words() == m.vocab.words(), f"{name} {fmt}: "
                      f"words")
                near = r.words_nearest("w1", 10) == m.words_nearest("w1", 10)
                if fmt == "binary":
                    check(np.array_equal(got, want), f"{name} binary: not "
                          f"bitwise")
                    check(near, f"{name} binary: words_nearest differs")
                else:
                    # six significant digits; the nearest words are logged,
                    # not gated: a near tie may flip at the sixth digit
                    check(bool(np.all(np.abs(got - want)
                                      <= 5.1e-6 * np.abs(want))),
                          f"{name} text: beyond six significant digits")
                    sizes["text_nearest_equal"] = near
            p = f"{d}/{name}.zip"
            write_word2vec_model(m, p)
            sizes["zip"] = len(open(p, "rb").read())
            z = read_word2vec_model(p, device=dev)
            check(z.device == dev or z.device.type == "cuda", "zip model "
                  "not on the card")
            for t in ("syn0", "syn1", "syn1neg"):
                a, b = (getattr(z.lookup_table, t),
                        getattr(m.lookup_table, t))
                check((a is None) == (b is None)
                      and (a is None or np.array_equal(a, b)),
                      f"{name} zip: {t} not bitwise")
            if name == "skipgram":
                # (FastText's zip reads back as a Word2Vec over all V +
                # bucket rows; its composed vectors are the files' above)
                check(z.words_nearest("w1", 10) == m.words_nearest("w1", 10),
                      f"{name} zip: words_nearest differs")
            out[name] = {"bytes": sizes}
            log(f"[serializer] {name}: text {sizes['text']} B, binary "
                f"{sizes['binary']} B, zip {sizes['zip']} B; binary and zip "
                f"bitwise with equal words_nearest, text within 6 digits "
                f"(words_nearest equal: {sizes['text_nearest_equal']})")
        z = read_word2vec_model(f"{d}/skipgram.zip", device=dev)
    restored = z.lookup_table.syn0.copy()
    z.set_sentence_iterator(sents[:W2V_CUT_WORDS // 20])
    z.fit()
    check(z.vocab.words() == sg.vocab.words()
          and not np.array_equal(z.lookup_table.syn0, restored)
          and z.table_device.type == "cuda", "resumed fit")
    check(z.first_loss < sg.first_loss, f"resumed fit: first block's loss "
          f"{z.first_loss} not below the first fit's {sg.first_loss}")
    out["resume"] = {"first_loss": z.first_loss, "last_loss": z.last_loss,
                     "fresh_first_loss": sg.first_loss}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[serializer] fit resumed from the skip-gram zip on the card: first "
        f"block's loss {z.first_loss:.4f} (the first fit's "
        f"{sg.first_loss:.4f}), last {z.last_loss:.4f}; phase "
        f"{out['seconds']:.1f} s; {smi}")
    return out


# --- phase 9b -------------------------------------------------------------------

ENC_TRAIN_WARMUP = 2
ENC_TRAIN_STEPS = 10
ENC_TRAIN_LR = 2e-5                 # BERT's fine-tuning rate (bench.py bert)
#: the card-against-CPU fit step's width (phase 10's reduced encoder)
ENC_TRAIN_PARITY = {"hidden": 256, "layers": 2, "heads": 4, "ff": 1024,
                    "vocab": 1000}


def encoder_train_batch(batch: int, dev, seed: int, vocab=BERT["vocab"]):
    """A seeded batch of int32 tokens and positions with one-hot labels
    over 2 classes, as a MultiDataSet on ``dev``."""
    from deeplearning4j_tpu_torch.data import MultiDataSet

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch, SEQ_LEN)).astype(np.int32)
    positions = np.tile(np.arange(SEQ_LEN, dtype=np.int32), (batch, 1))
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, batch)]
    return MultiDataSet([torch.from_numpy(a).to(dev)
                         for a in (tokens, positions)],
                        [torch.from_numpy(labels).to(dev)])


def phase_encoder_train(smi: str, dev):
    """The BERT-base-width encoder of phase 9 trained through
    ComputationGraph.fit at batch 32: bf16 compute over float32 master
    parameters, Adam(2e-5) in one fused_update launch per step with float32
    state; 2 warm-ups, then 10 timed steps on one repeated batch, each
    ended by a synchronize. Gates: 12 bf16 flash launches per step, each
    with the float32 output the backward takes D from; no float32-kernel
    launch and no dense attention; 1 fused_update launch per step; finite
    losses, the last below the first. Then :func:`encoder_train_parity`."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention, update

    torch.cuda.empty_cache()
    model = ComputationGraph(encoder_conf()).init(seed=SEED, device=dev)
    check(model.num_params() == BERT_PARAMS, f"encoder has "
          f"{model.num_params()} parameters, want {BERT_PARAMS}")
    gc = model.conf.global_conf
    gc.compute_dtype = "bfloat16"
    gc.updater = Adam(ENC_TRAIN_LR)
    gc.fused_update = True
    ds = encoder_train_batch(ENC_BATCH, dev, SEED + 30)
    losses = []
    for _ in range(ENC_TRAIN_WARMUP):
        model.fit(ds)
        losses.append(model.score_value)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_bf16 = attention._launch_bf16
    with_f32 = []

    def spy(*args, **kw):
        with_f32.append(bool(args[7] if len(args) > 7
                             else kw.get("with_f32", False)))
        return launch_bf16(*args, **kw)

    prof = OpProfiler.get()
    prof.reset()
    _reset_kernel_counts()
    ms = []
    attention._launch_bf16 = spy
    try:
        for _ in range(ENC_TRAIN_STEPS):
            t0 = time.perf_counter()
            model.fit(ds)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(model.score_value)
    finally:
        attention._launch_bf16 = launch_bf16
    counts = _kernel_counts()
    counters = prof.get_counters()
    peak = torch.cuda.max_memory_allocated()
    want = BERT["layers"] * ENC_TRAIN_STEPS
    check(counts["flash_attention"] == want
          and counters.get("attention/flash_bf16", 0) == want
          and counters.get("attention/flash_f32", 0) == 0,
          f"flash launches {counts['flash_attention']}, routes {counters}: "
          f"want {want} on the bf16 kernel, none on the float32 one")
    check(len(with_f32) == want and all(with_f32), f"bf16 flash launches "
          f"with the float32 output {sum(with_f32)} of {len(with_f32)}")
    check(counters.get("attention/mha_dense", 0) == 0
          and counters.get("attention/mha_flash", 0) == want,
          f"attention routes {counters}")
    check(counts["fused_update"] == ENC_TRAIN_STEPS
          and counters.get("precision/fused_fallbacks", 0) == 0,
          f"fused_update launched {counts['fused_update']} times in "
          f"{ENC_TRAIN_STEPS} steps (want 1 per step, no fallback)")
    check(counts["bn_act"] == 0 and counts["embedding_bag"] == 0,
          f"kernel counts {counts}")
    check(all(np.isfinite(losses)), f"non-finite encoder loss {losses}")
    check(losses[-1] < losses[0], f"encoder loss did not fall on the "
          f"repeated batch: {losses}")
    result = {"params": BERT_PARAMS, "batch": ENC_BATCH,
              "samples_per_s": ENC_BATCH * len(ms) / sum(ms) * 1e3,
              **_ms_stats(ms), "peak_bytes": peak, "losses": losses,
              "flash_launches": counts["flash_attention"],
              "fused_update_launches": counts["fused_update"]}
    log(f"[encoder-train] BERT-base width ({BERT_PARAMS} parameters), "
        f"ComputationGraph.fit batch {ENC_BATCH}, T {SEQ_LEN}, bf16 compute, "
        f"float32 master parameters, Adam({ENC_TRAIN_LR}) fused_update, "
        f"float32 state: {result['samples_per_s']:.2f} samples/s, step ms "
        f"median {result['step_ms_median']:.2f} p10 "
        f"{result['step_ms_p10']:.2f} p90 {result['step_ms_p90']:.2f} "
        f"({ENC_TRAIN_STEPS} steps after {ENC_TRAIN_WARMUP} warm-ups); peak "
        f"device memory {peak} B; flash launches {counts['flash_attention']}"
        f" (bf16, float32 output in each), fused_update "
        f"{counts['fused_update']}; losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; {smi}")
    del model, ds
    torch.cuda.empty_cache()
    result["parity"] = encoder_train_parity(smi, dev)
    return result


def encoder_train_parity(smi: str, dev):
    """One fit step of the encoder at ENC_TRAIN_PARITY's width, float32,
    TF32 off, Adam(2e-5), from the same weights on the card (the float32
    flash kernel, the fused update) and on the CPU (plain versions): the
    loss within 1e-4 relative and every parameter within 1e-4 of its own
    leaf's largest magnitude."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    w = ENC_TRAIN_PARITY
    tf32 = torch.backends.cuda.matmul.allow_tf32
    Environment.get().set_tf32(False)
    try:
        nets = []
        for where in (dev, "cpu"):
            net = ComputationGraph(encoder_conf(
                vocab=w["vocab"], hidden=w["hidden"], layers=w["layers"],
                heads=w["heads"], ff=w["ff"])).init(seed=SEED + 31,
                                                    device=where)
            net.conf.global_conf.updater = Adam(ENC_TRAIN_LR)
            net.conf.global_conf.fused_update = True
            net.fit(encoder_train_batch(2, where, SEED + 32, w["vocab"]))
            nets.append(net)
        card, host = nets
        loss_err = abs(card.score_value - host.score_value) \
            / abs(host.score_value)
        worst = 0.0
        for n, d in host._params.items():
            for k, v in d.items():
                err = (card._params[n][k].detach().cpu() - v.detach()).abs()
                worst = max(worst, err.max().item()
                            / max(v.abs().max().item(), 1e-30))
        check(loss_err <= 1e-4 and worst <= 1e-4, f"encoder fit card vs "
              f"CPU: loss {loss_err}, parameters {worst} of their scale "
              f"(want <= 1e-4)")
        log(f"[encoder-train] parity: hidden {w['hidden']}, {w['layers']} "
            f"layers, float32, TF32 off, one fit step card vs CPU: loss "
            f"{card.score_value:.7f} vs {host.score_value:.7f} ({loss_err:.3e}"
            f" relative), parameters within {worst:.3e} of their scale "
            f"(<= 1e-4); {smi}")
        return {"loss_rel_err": loss_err, "param_err": worst}
    finally:
        Environment.get().set_tf32(tf32)


# --- phase 24 --------------------------------------------------------------------

ZOO_BATCH = 16
ZOO_WARMUP = 2
ZOO_STEPS = 5
ZOO_PARITY_BATCH = 2
#: the twelve CNNs of phase 24 in the zoo's order, each with the output
#: shape the JAX model gives at its defaults (its configuration's last
#: output type; batch first)
ZOO_MODELS = (
    ("SimpleCNN", (10,)), ("AlexNet", (1000,)), ("VGG19", (1000,)),
    ("SqueezeNet", (1000,)), ("Darknet19", (1000,)), ("UNet", (1, 128, 128)),
    ("Xception", (1000,)), ("InceptionResNetV1", (128,)),
    ("FaceNetNN4Small2", (100,)), ("NASNet", (1000,)),
    ("TinyYOLO", (125, 14, 14)), ("YOLO2", (425, 13, 13)))
#: the reduced sizes the JAX package's tests build (tests/test_graph.py);
#: AlexNet and VGG19 take no size and run at their defaults
ZOO_REDUCED = {
    "SimpleCNN": {}, "AlexNet": {}, "VGG19": {},
    "SqueezeNet": {"num_classes": 10},
    "Darknet19": {"num_classes": 10, "image_size": 64},
    "UNet": {"n_channels": 1, "n_classes": 1, "image_size": 32, "base": 8},
    "Xception": {"num_classes": 10, "image_size": 96},
    "InceptionResNetV1": {"num_classes": 16, "image_size": 96},
    "FaceNetNN4Small2": {"num_classes": 5, "image_size": 64},
    "NASNet": {"num_classes": 7, "image_size": 32, "cells_per_stack": 1},
    "TinyYOLO": {"num_classes": 4, "image_size": 64},
    "YOLO2": {"num_classes": 4, "image_size": 64}}
ZOO_SIMPLECNN_STEPS = 3
#: zoo models whose published learning rate diverges on this phase's batch,
#: with the rate of their gated run: zoo VGG19's Nesterovs(0.01, 0.9) (no
#: BN, 19 layers) reaches NaN within 5 steps at batch 16 on pixels in
#: [0, 1], in float32 as in bf16, and not at 1e-3 (the as-is runs are
#: logged first, ungated)
ZOO_DIVERGES = {"VGG19": 1e-3}
ZOO_AS_IS_STEPS = 5


def _zoo_layers(conf):
    """The layers of either network's configuration, a ``FrozenLayer``'s
    inner layer in its place (it runs that layer's own ``apply``)."""
    if hasattr(conf, "nodes"):
        return [conf.nodes[n].layer for n in conf.order
                if conf.nodes[n].kind == "layer"]
    return [getattr(layer, "layer", None)
            if type(layer).__name__ == "FrozenLayer" else layer
            for layer in conf.layers]


def zoo_io(conf):
    """(input type, output type) of a zoo configuration."""
    if hasattr(conf, "nodes"):
        return (conf.input_types[conf.network_inputs[0]],
                conf.node_output_types[conf.network_outputs[0]])
    return conf.input_type, conf.layer_output_types[-1]


def yolo_labels(rng, batch: int, classes: int, grid: int,
                objects: int = 2) -> np.ndarray:
    """YOLOv2 labels in the reference format ``[batch, 4 + classes, grid,
    grid]``: per image ``objects`` distinct cells, each holding the corners
    (x1, y1, x2, y2, grid units) of a box centred in it with sides in
    [0.5, 3] and a one-hot class."""
    lab = np.zeros((batch, 4 + classes, grid, grid), np.float32)
    for b in range(batch):
        for cell in rng.choice(grid * grid, size=objects, replace=False):
            gy, gx = divmod(int(cell), grid)
            cx, cy = gx + rng.uniform(0.1, 0.9), gy + rng.uniform(0.1, 0.9)
            w, h = rng.uniform(0.5, 3.0, 2)
            lab[b, :4, gy, gx] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                  cy + h / 2)
            lab[b, 4 + rng.integers(0, classes), gy, gx] = 1.0
    return lab


def zoo_batch(conf, batch: int, seed: int):
    """Seeded pixels in [0, 1] and labels in the model's format: one-hot
    classes, binary masks (UNet's sigmoid head) or YOLO boxes (numpy)."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    rng = np.random.default_rng(seed)
    it, ot = zoo_io(conf)
    x = rng.random((batch, it.channels, it.height, it.width),
                   dtype=np.float32)
    head = _zoo_layers(conf)[-1]
    if isinstance(head, L.Yolo2OutputLayer):
        classes = ot.channels // len(head.anchors) - 5
        y = yolo_labels(rng, batch, classes, ot.height)
    elif hasattr(ot, "channels"):
        y = (rng.random((batch, ot.channels, ot.height, ot.width))
             < 0.5).astype(np.float32)
    else:
        y = np.eye(ot.size, dtype=np.float32)[rng.integers(0, ot.size,
                                                           batch)]
    return x, y


def expected_bn_launches(conf):
    """bn_act launches one served forward makes, read off the
    configuration: every BatchNormalization with relu or identity (the
    gate takes any channel count) launches once, alone or as the head of
    a ``BN(identity) -> add -> relu`` chain, whose one launch also does
    the add and the relu; the gate refuses (and counts) every other BN
    (leakyrelu), which runs dense. Returns (alone, chains, refused)."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    fusable = lambda layer: (isinstance(layer, L.BatchNormalization)  # noqa: E731
                             and (layer.activation or "identity").lower()
                             in ("relu", "identity"))
    refused = sum(1 for layer in _zoo_layers(conf)
                  if isinstance(layer, L.BatchNormalization)
                  and not fusable(layer))
    if not hasattr(conf, "nodes"):
        return (sum(1 for layer in _zoo_layers(conf) if fusable(layer)), 0,
                refused)
    consumers = {}
    for name in conf.order:
        for i in conf.nodes[name].inputs:
            consumers.setdefault(i, []).append(name)
    outputs = set(conf.network_outputs)
    chains = 0
    for name in conf.order:
        node = conf.nodes[name]
        layer = node.layer
        if not (fusable(layer) and layer.activation.lower() == "identity"
                and name not in outputs
                and len(consumers.get(name, ())) == 1):
            continue
        add = conf.nodes[consumers[name][0]]
        if (add.kind != "vertex" or type(add.vertex).__name__
                != "ElementWiseVertex" or add.vertex.op.lower() != "add"
                or len(add.inputs) != 2 or add.inputs[0] == add.inputs[1]
                or add.name in outputs
                or len(consumers.get(add.name, ())) != 1):
            continue
        act = conf.nodes[consumers[add.name][0]].layer
        if isinstance(act, L.ActivationLayer) \
                and (act.activation or "").lower() == "relu":
            chains += 1
    total = sum(1 for layer in _zoo_layers(conf) if fusable(layer))
    return total - chains, chains, refused


def set_fused_epilogue(net, on: bool) -> None:
    """The global knob plus the cascade onto every BN layer, for either
    network."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    net.conf.global_conf.fused_epilogue = on
    for layer in _zoo_layers(net.conf):
        if isinstance(layer, L.BatchNormalization):
            layer.fused_epilogue = on


def _no_dropout(net) -> None:
    for layer in _zoo_layers(net.conf):
        if hasattr(layer, "rate"):
            layer.rate = 0.0
        layer.dropout = 0.0


def zoo_as_is(name, smi, dev):
    """ZOO_AS_IS_STEPS fit steps of a ZOO_DIVERGES model at its published
    learning rate, float32 and bf16, at phase 24's batch: the losses,
    logged and not gated."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import zoo

    out = {}
    for cd in (None, "bfloat16"):
        net = getattr(zoo, name)().init(device=dev)
        net.conf.global_conf.compute_dtype = cd
        net.conf.global_conf.fused_update = True
        x, y = zoo_batch(net.conf, ZOO_BATCH, SEED + 40)
        ds = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        losses = []
        for _ in range(ZOO_AS_IS_STEPS):
            net.fit(ds)
            losses.append(net.score_value)
        out[cd or "float32"] = losses
        log(f"[zoo-cnn] {name} as published (learning rate "
            f"{net.conf.global_conf.updater.learning_rate}), batch "
            f"{ZOO_BATCH}, {cd or 'float32'}: losses {losses} (not gated); "
            f"{smi}")
        del net, ds
        torch.cuda.empty_cache()
    return out


def zoo_fit_and_serve(name, want_out, smi, dev, batch=ZOO_BATCH, lr=None,
                      **kw):
    """One zoo model at its published defaults (``kw`` overrides them for
    a rehearsal on the CPU): bf16 compute over float32 master parameters,
    its own updater through fused_update; 2 warm-up and 5 timed fit(ds)
    steps at batch 16, then one served output of 16 images with
    fused_epilogue on. ``lr`` replaces the updater's learning rate."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import zoo

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = getattr(zoo, name)(**kw).init(device=dev)
    conf = net.conf
    gc = conf.global_conf
    gc.compute_dtype = "bfloat16"
    gc.fused_update = True
    if lr is not None:
        gc.updater.learning_rate = lr
    x, y = zoo_batch(conf, batch, SEED + 40)
    ds = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    losses = []
    for _ in range(ZOO_WARMUP):
        net.fit(ds)
        losses.append(net.score_value)
    torch.cuda.synchronize()
    prof = OpProfiler.get()
    prof.reset()
    _reset_kernel_counts()
    ms = []
    for _ in range(ZOO_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_value)
    counts = _kernel_counts()
    fallbacks = prof.counter_value("precision/fused_fallbacks")
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    check(counts["fused_update"] == ZOO_STEPS and not fallbacks,
          f"{name}: fused_update launched {counts['fused_update']} times in "
          f"{ZOO_STEPS} steps, fallbacks {fallbacks} (want 1 per step)")
    alone, chains, want_refused = expected_bn_launches(conf)
    set_fused_epilogue(net, True)
    prof.reset()
    _reset_kernel_counts()
    out = net.output(ds.features)
    out = (out[0] if isinstance(out, list) else out).float()
    torch.cuda.synchronize()
    counts = _kernel_counts()
    refused = prof.counter_value("precision/epilogue_fallbacks")
    check(tuple(out.shape) == (batch,) + want_out,
          f"{name}: output shape {tuple(out.shape)}, want "
          f"{(batch,) + want_out}")
    check(bool(torch.isfinite(out).all()), f"{name}: output not finite")
    check(counts["bn_act"] == alone + chains and refused == want_refused,
          f"{name}: bn_act launches {counts['bn_act']} per served forward, "
          f"gate refusals {refused}; want {alone + chains} launches ("
          f"{alone} alone + {chains} chains) and {want_refused} refusals, "
          f"read off the configuration")
    it, _ = zoo_io(conf)
    upd = f"{type(gc.updater).__name__}({gc.updater.learning_rate})"
    result = {"params": net.num_params(), "input": [it.channels, it.height,
                                                     it.width],
              "updater": upd, "images_per_s":
              batch * len(ms) / sum(ms) * 1e3, **_ms_stats(ms),
              "peak_bytes": peak, "losses": losses,
              "fused_update_launches": ZOO_STEPS,
              "bn_act_launches": counts["bn_act"],
              "bn_act_expected": [alone, chains],
              "bn_act_refused": refused}
    log(f"[zoo-cnn] {name} ({result['params']} parameters, input "
        f"{it.channels}x{it.height}x{it.width}, {upd}), batch {batch}, "
        f"bf16 compute, fused_update: {result['images_per_s']:.2f} "
        f"images/s, step ms median {result['step_ms_median']:.2f} p10 "
        f"{result['step_ms_p10']:.2f} p90 {result['step_ms_p90']:.2f} "
        f"({ZOO_STEPS} steps after {ZOO_WARMUP} warm-ups); peak {peak} B; "
        f"losses {losses[0]:.5f} -> {losses[-1]:.5f}; served output "
        f"{tuple(out.shape)}, bn_act launches {counts['bn_act']} = "
        f"{alone} alone + {chains} chains from the configuration, "
        f"{refused} leakyrelu BNs refused by the gate (want "
        f"{want_refused}); {smi}")
    del net, ds, out
    torch.cuda.empty_cache()
    return result


#: an element's step is decided (its gradient's sign far above the
#: disagreement) where its gradient is above these shares of its leaf's
#: largest and of the model's largest gradient
ZOO_DECIDED = (1e-2, 1e-5)


def _step_grads(net, ds):
    """One fit step of ``net`` on ``ds``, returning the gradients its
    per-leaf updater was handed (on the CPU)."""
    from deeplearning4j_tpu_torch.nn import _train

    got = []
    real = _train.apply_updater

    def spy(updater, grads, *args, **kw):
        got.append({n: {k: v.detach().cpu() for k, v in d.items()}
                    for n, d in grads.items()})
        return real(updater, grads, *args, **kw)

    _train.apply_updater = spy
    try:
        net.fit(ds)
    finally:
        _train.apply_updater = real
    check(len(got) == 1, f"a fit step made {len(got)} per-leaf updates")
    return got[0]


def zoo_cpu_parity(name, dev):
    """The model at the JAX tests' reduced size, TF32 off, deterministic
    cuDNN, dropout off, the same seeded weights on the card and on the
    CPU, batch 2. The served output in float32 within 1e-4 of its scale.
    Then one fit step in float64 (the float32 draws widened; BN's
    statistics stay float32, as in the JAX package), from BN running
    statistics set to the batch's own: the loss and the BN running
    statistics within 1e-4 (relative, of their scale), and each parameter
    within 1e-4 of its leaf's largest magnitude wherever the CPU's
    gradient is significant (above 1% of the leaf's largest and 1e-5 of
    the model's largest, ZOO_DECIDED) and the card's has its sign, every
    parameter finite, and significant gradients of the other sign on the
    card for at most 1e-5 of the parameters. Where a gradient is zero in exact
    arithmetic (a bias or a beta whose shift the next training-mode
    BatchNormalization subtracts: whole leaves of NASNet's and
    InceptionResNetV1's) only the rounding of BN's float32 reductions is
    left, and Adam's first step lr * g / (|g| + eps) makes of it a step of
    up to lr either way. A pre-activation within rounding of a relu kink
    moves a weight's gradient by a whole term, and can turn its sign: in
    float32 the step
    is ill-conditioned at these sizes: the deep BN stacks end in sums over
    a few positions (batch 2 at 2x2 or 3x3), where a pre-activation within
    rounding of a relu or leakyrelu kink moves a weight's gradient by a
    whole term (nudging the input by one float32 ulp moves the CPU's own
    gradients by up to 2.7% of their norm, FaceNetNN4Small2)."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.util.calibrate import calibrate_batchnorm

    def twins(dtype):
        nets = []
        for where in (dev, "cpu"):
            conf = getattr(zoo, name)(**ZOO_REDUCED[name]).conf()
            conf.global_conf.dtype = dtype
            nets.append(zoo.network(conf).init(device=where))
        for net in nets:
            _no_dropout(net)
        return nets

    card, host = twins("float32")
    x, y = zoo_batch(card.conf, ZOO_PARITY_BATCH, SEED + 41)
    outs = []
    for net in (card, host):
        o = net.output(x)
        outs.append((o[0] if isinstance(o, list) else o).detach().cpu())
    scale = max(1.0, outs[1].abs().max().item())
    out_err = (outs[0] - outs[1]).abs().max().item() / scale
    check(out_err <= 1e-4, f"{name} card vs CPU output: {out_err} of its "
          f"scale (want <= 1e-4)")
    card, host = twins("float64")
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    calibrate_batchnorm(host, x64)
    card._states = {n: {k: v.to(dev) for k, v in d.items()}
                    for n, d in host._states.items()}
    card_grads = _step_grads(card, DataSet(card._to_device(x64),
                                           card._to_device(y64)))
    grads = _step_grads(host, DataSet(x64, y64))
    loss_err = abs(card.score_value - host.score_value) \
        / abs(host.score_value)
    st_err = 0.0
    for n, d in host._states.items():
        for k, v in d.items():
            e = (card._states[n][k].cpu() - v).abs().max().item()
            st_err = max(st_err, e / max(v.abs().max().item(), 1e-2))
    p_err = 0.0
    flips = undecided = total = 0
    top = max(g.abs().max().item() for d in grads.values()
              for g in d.values())
    for n, d in host._params.items():
        for k, v in d.items():
            v = v.detach()
            d_ = (card._params[n][k].detach().cpu() - v).abs()
            g = grads[n][k].abs()
            significant = (g > ZOO_DECIDED[0] * g.max()) \
                & (g > ZOO_DECIDED[1] * top)
            agree = torch.sign(grads[n][k]) == torch.sign(card_grads[n][k])
            decided = significant & agree
            flips += int((significant & ~agree).sum())
            total += v.numel()
            if bool(decided.any()):
                p_err = max(p_err, d_[decided].max().item()
                            / max(v.abs().max().item(), 1e-30))
            undecided += int((~decided).sum())
    finite = all(bool(torch.isfinite(t).all())
                 for d in card._params.values() for t in d.values())
    check(loss_err <= 1e-4 and st_err <= 1e-4 and p_err <= 1e-4 and finite
          and flips <= max(1, 1e-5 * total),
          f"{name} float64 fit step card vs CPU: loss {loss_err}, BN "
          f"statistics {st_err}, decided parameters {p_err} of their scale "
          f"(want <= 1e-4), finite {finite}; {flips} significant gradients "
          f"of {total} parameters change sign (want <= 1e-5 of them)")
    return {"output": out_err, "loss": loss_err, "bn_stats": st_err,
            "params": p_err, "undecided": undecided, "sign_flips": flips}


def simplecnn_fused_parity(dev):
    """SimpleCNN, 3 steps through the fused kernel against 3 through the
    per-leaf path, float32, TF32 off, deterministic cuDNN, from the same
    seed (the same dropout masks from the same generators): parameters
    and Adam's moments within 2 float32 ulp, phase 7's contract."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import SimpleCNN

    x, y = zoo_batch(SimpleCNN().conf(), ZOO_BATCH, SEED + 42)
    nets = []
    for fused in (True, False):
        net = SimpleCNN().init(device=dev)
        net.conf.global_conf.fused_update = fused
        ds = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        for _ in range(ZOO_SIMPLECNN_STEPS):
            net.fit(ds)
        torch.cuda.synchronize()
        nets.append(net)
    a, b = nets
    wp, bp = _ulp_worst(a._params, b._params)
    wm, bm = _ulp_worst(a._updater_state["m"], b._updater_state["m"])
    wv, bv = _ulp_worst(a._updater_state["v"], b._updater_state["v"])
    check(wp <= 2 and wm <= 2 and wv <= 2, f"SimpleCNN fused vs per-leaf "
          f"after {ZOO_SIMPLECNN_STEPS} steps: params {wp}, m {wm}, v {wv} "
          f"f32 ulp (want <= 2)")
    return {"params_ulp": wp, "m_ulp": wm, "v_ulp": wv,
            "bitwise": bool(bp and bm and bv)}


def phase_zoo_cnn(smi: str, dev):
    """Phase 24: the twelve zoo CNNs (see the module docstring)."""
    from deeplearning4j_tpu_torch.common.environment import Environment

    result = {}
    for name, want_out in ZOO_MODELS:
        as_is = zoo_as_is(name, smi, dev) if name in ZOO_DIVERGES else None
        result[name] = zoo_fit_and_serve(name, want_out, smi, dev,
                                         lr=ZOO_DIVERGES.get(name))
        if as_is is not None:
            result[name]["as_published"] = as_is
    det = torch.backends.cudnn.deterministic
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.deterministic = True
    Environment.get().set_tf32(False)
    try:
        for name, _ in ZOO_MODELS:
            p = zoo_cpu_parity(name, dev)
            result[name]["cpu_parity"] = p
            log(f"[zoo-cnn] {name} {ZOO_REDUCED[name] or 'defaults'}, "
                f"TF32 off, deterministic cuDNN, batch {ZOO_PARITY_BATCH}, "
                f"card vs CPU: float32 output {p['output']:.3e} of its "
                f"scale (<= 1e-4); one float64 fit step: loss "
                f"{p['loss']:.3e} (<= 1e-4), BN statistics "
                f"{p['bn_stats']:.3e} (<= 1e-4), parameters {p['params']:.3e}"
                f" of their scale where the step is decided (<= 1e-4; "
                f"{p['undecided']} parameters undecided), "
                f"{p['sign_flips']} significant gradients changed sign")
        sp = simplecnn_fused_parity(dev)
        log(f"[zoo-cnn] SimpleCNN {ZOO_SIMPLECNN_STEPS} steps, float32, TF32 "
            f"off, deterministic cuDNN: fused kernel vs per-leaf: params "
            f"within {sp['params_ulp']:.2f} ulp, Adam m {sp['m_ulp']:.2f}, v "
            f"{sp['v_ulp']:.2f} (bitwise {sp['bitwise']}); bound 2 ulp")
        result["simplecnn_fused_parity"] = sp
    finally:
        torch.backends.cudnn.deterministic = det
        Environment.get().set_tf32(tf32)
    return result


# --- phase 25 --------------------------------------------------------------------

TEXT_HIDDEN = 256       # the zoo TextGenerationLSTM's default width
TEXT_BATCH = 32
TEXT_SEQ = 1000         # dl4j-examples LSTMCharModellingExample: 1000-char
TEXT_TBPTT = 50         # sequences, truncated BPTT of 50 steps
TEXT_WARMUP = 1
TEXT_TIMED = 3
TEXT_PRIME = 100
TEXT_GENERATE = 200
TEXT_STREAM_T = 100     # the streaming gate's sequence, in chunks of 10
TEXT_PARITY_T = 150     # card against CPU: three segments
#: the masked classifier of phase 25 (its widths are no published model's)
SEQ_CLS = {"width": 64, "batch": 16, "T": 40, "tbptt": 10, "classes": 4,
           "features": 8}


def text_corpus():
    """The characters of the repository's README.md and SURVEY.md as indices
    into their sorted character set, and that set."""
    root = os.path.dirname(os.path.abspath(__file__))
    text = "".join(open(os.path.join(root, n), encoding="utf-8").read()
                   for n in ("README.md", "SURVEY.md"))
    chars = sorted(set(text))
    lut = {c: i for i, c in enumerate(chars)}
    return np.array([lut[c] for c in text], dtype=np.int64), chars


def text_batch(idx, vocab: int, batch: int, T: int, dev, seed: int):
    """``batch`` windows of ``T + 1`` characters at seeded offsets, one-hot
    on ``dev``: the first T as features, the next T as labels."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(idx) - T - 1, batch)
    win = torch.from_numpy(np.stack([idx[s:s + T + 1] for s in starts]))
    hot = torch.nn.functional.one_hot(win.to(dev), vocab).to(torch.float32)
    return hot[:, :-1].contiguous(), hot[:, 1:].contiguous()


def text_generation_net(vocab: int, dev, fused: bool = True,
                        dtype: str = "float32"):
    """The zoo's TextGenerationLSTM (two LSTM(256), softmax RnnOutputLayer
    with mcxent, Adam(2e-3)) trained with truncated BPTT of TEXT_TBPTT
    steps, parameters in ``dtype`` (float32), fused_update on."""
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = TextGenerationLSTM(vocab, TEXT_HIDDEN, seed=SEED).conf()
    conf.backprop_type = "TruncatedBPTT"
    conf.tbptt_fwd_length = conf.tbptt_back_length = TEXT_TBPTT
    conf.global_conf.fused_update = fused
    conf.global_conf.dtype = dtype
    return MultiLayerNetwork(conf).init(device=dev)


def _tree_err(card: dict, host: dict) -> float:
    """The largest difference of any parameter, card against CPU, over its
    own leaf's largest magnitude."""
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths

    worst = 0.0
    for p in leaf_paths(host):
        want = get_path(host, p).detach()
        got = get_path(card, p).detach().cpu()
        worst = max(worst, (got - want).abs().max().item()
                    / max(want.abs().max().item(), 1e-30))
    return worst


def phase_sequences(smi: str, dev):
    """The zoo's TextGenerationLSTM at full width trained with truncated
    BPTT on the repository's own text, then served a character at a time;
    the card against the CPU; the masked classifier; the shape layers."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import DataSet

    idx, chars = text_corpus()
    vocab = len(chars)
    torch.cuda.empty_cache()
    net = text_generation_net(vocab, dev)
    n_params = net.num_params()
    h = TEXT_HIDDEN
    check(n_params == 4 * h * (vocab + h + 1) + 4 * h * (2 * h + 1)
          + h * vocab + vocab, f"TextGenerationLSTM has {n_params} "
          f"parameters")
    segments = -(-TEXT_SEQ // TEXT_TBPTT)
    # a fixed segment's score before and after training: the batches'
    # own losses are each a different batch's last segment
    probe = DataSet(*text_batch(idx, vocab, TEXT_BATCH, TEXT_TBPTT, dev,
                                SEED + 49))
    score_before = net.score(probe)
    losses = []
    for i in range(TEXT_WARMUP):
        net.fit(DataSet(*text_batch(idx, vocab, TEXT_BATCH, TEXT_SEQ, dev,
                                    SEED + 50 + i)))
        losses.append(net.score_value)
    batches = [text_batch(idx, vocab, TEXT_BATCH, TEXT_SEQ, dev,
                          SEED + 60 + i) for i in range(TEXT_TIMED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = OpProfiler.get()
    prof.reset()
    _reset_kernel_counts()
    ms = []
    for x, y in batches:
        t0 = time.perf_counter()
        net.fit(DataSet(x, y))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_value)
    counts = _kernel_counts()
    counters = prof.get_counters()
    peak = torch.cuda.max_memory_allocated()
    check(counts["fused_update"] == segments * TEXT_TIMED
          and counters.get("precision/fused_fallbacks", 0) == 0,
          f"fused_update launched {counts['fused_update']} times in "
          f"{TEXT_TIMED} batches of {segments} segments (want one per "
          f"segment, no fallback)")
    check(counts["bn_act"] == counts["embedding_bag"]
          == counts["flash_attention"] == 0, f"kernel counts {counts}")
    check(net._iteration == TEXT_WARMUP + TEXT_TIMED, f"iteration "
          f"{net._iteration} after {TEXT_WARMUP + TEXT_TIMED} batches")
    score_after = net.score(probe)
    check(all(np.isfinite(losses)) and score_after < score_before,
          f"TextGenerationLSTM loss did not fall: a fixed segment scores "
          f"{score_before} -> {score_after}; batch losses {losses}")
    chars_per_s = TEXT_BATCH * TEXT_SEQ * len(ms) / sum(ms) * 1e3
    result = {"vocab": vocab, "params": n_params, "batch": TEXT_BATCH,
              "seq": TEXT_SEQ, "tbptt": TEXT_TBPTT,
              "segments_per_batch": segments,
              "fused_update_launches": counts["fused_update"],
              "fused_update_launches_per_batch":
                  counts["fused_update"] / TEXT_TIMED,
              "chars_per_s": chars_per_s, **_ms_stats(ms),
              "segment_ms_median": statistics.median(ms) / segments,
              "peak_bytes": peak, "losses": losses,
              "probe_score": [score_before, score_after]}
    log(f"[sequences] TextGenerationLSTM (hidden {h}, 2 LSTM layers, "
        f"vocabulary {vocab}, {n_params} parameters), float32, "
        f"Adam(2e-3) fused_update, truncated BPTT {TEXT_TBPTT} over "
        f"{TEXT_SEQ} characters at batch {TEXT_BATCH}: "
        f"{chars_per_s:.1f} characters/s, batch ms median "
        f"{result['step_ms_median']:.2f} p10 {result['step_ms_p10']:.2f} "
        f"p90 {result['step_ms_p90']:.2f} ({TEXT_TIMED} batches after "
        f"{TEXT_WARMUP} warm-up); {segments} segments and "
        f"{counts['fused_update'] / TEXT_TIMED:.0f} fused_update launches "
        f"per batch; peak device memory {peak} B; a fixed segment's loss "
        f"{score_before:.5f} -> {score_after:.5f} (batch losses "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}); {smi}")
    result["streaming"] = text_streaming(net, idx, vocab, smi, dev)
    del net, batches
    torch.cuda.empty_cache()
    result["parity"] = text_parity(idx, vocab, smi, dev)
    result["classifier"] = seq_classifier_parity(smi, dev)
    result["shape_layers"] = shape_layers_parity(smi, dev)
    return result


def text_streaming(net, idx, vocab: int, smi: str, dev) -> dict:
    """Prime with TEXT_PRIME characters, then generate TEXT_GENERATE more,
    one rnn_time_step each, sampled on the host from the softmax (seeded).
    Gate: rnn_time_step over a sequence in chunks of 10 equals output on
    the whole sequence within rtol 1e-5, atol 1e-6."""
    hot = torch.nn.functional.one_hot(
        torch.from_numpy(idx[:TEXT_STREAM_T]).to(dev), vocab).to(
            torch.float32)[None].repeat(2, 1, 1)
    full = net.output(hot)
    net.rnn_clear_previous_state()
    parts = torch.cat([net.rnn_time_step(hot[:, s:s + 10])
                       for s in range(0, TEXT_STREAM_T, 10)], dim=1)
    excess = ((parts - full).abs() - (1e-6 + 1e-5 * full.abs())).max().item()
    check(excess <= 0, f"rnn_time_step in chunks of 10 against output: "
          f"exceeds rtol 1e-5, atol 1e-6 by {excess}")
    net.rnn_clear_previous_state()
    rng = np.random.default_rng(SEED + 70)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = net.rnn_time_step(hot[:1, :TEXT_PRIME])
    torch.cuda.synchronize()
    prime_ms = (time.perf_counter() - t0) * 1e3
    eye = torch.eye(vocab, device=dev)
    picked = []
    t0 = time.perf_counter()
    for _ in range(TEXT_GENERATE):
        p = out[0, -1].double().cpu().numpy()
        c = int(rng.choice(vocab, p=p / p.sum()))
        picked.append(c)
        out = net.rnn_time_step(eye[c][None])
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3 / TEXT_GENERATE
    check(bool(torch.isfinite(out).all()) and out.shape == (1, 1, vocab),
          f"generation output {tuple(out.shape)}")
    log(f"[sequences] streaming: prime {TEXT_PRIME} characters in "
        f"{prime_ms:.2f} ms, then {TEXT_GENERATE} generated one "
        f"rnn_time_step each at {gen_ms:.3f} ms per character (host "
        f"sampling included); chunks of 10 against output over "
        f"{TEXT_STREAM_T} steps within rtol 1e-5, atol 1e-6 (margin "
        f"{-excess:.3e}); {smi}")
    return {"prime_ms": prime_ms, "ms_per_char": gen_ms,
            "chunk_margin": -excess, "distinct_generated": len(set(picked))}


def text_parity(idx, vocab: int, smi: str, dev) -> dict:
    """One TBPTT batch (T TEXT_PARITY_T: three segments) of the full-width
    TextGenerationLSTM on the card and on the CPU from the same seeded
    parameters, in float64 through the per-leaf Adam: every parameter
    within 1e-4 of its leaf's scale, and the loss within 1e-4 relative.
    Float64, as phase 24's parity: Adam makes an element whose gradient is
    near its eps (a character seen once in the batch) a step that float32
    rounding moves, so in float32 the gap follows the corpus (3.0e-5 of
    the scale on one text, 2.8e-4 once a character was added to it). The
    fused kernel is held to the per-leaf update elsewhere (phases 7, 11,
    24)."""
    from deeplearning4j_tpu_torch.data import DataSet

    x, y = text_batch(idx, vocab, TEXT_BATCH, TEXT_PARITY_T, dev, SEED + 80)
    x, y = x.to(torch.float64), y.to(torch.float64)
    nets = []
    for where, xx, yy in ((dev, x, y), ("cpu", x.cpu(), y.cpu())):
        net = text_generation_net(vocab, where, fused=False,
                                  dtype="float64")
        net.fit(DataSet(xx, yy))
        nets.append(net)
    card, host = nets
    err = _tree_err(card._params, host._params)
    loss_err = abs(card.score_value - host.score_value) \
        / abs(host.score_value)
    check(err <= 1e-4 and loss_err <= 1e-4, f"TextGenerationLSTM TBPTT "
          f"batch card vs CPU: parameters {err}, loss {loss_err} (want "
          f"<= 1e-4)")
    log(f"[sequences] parity: TextGenerationLSTM full width, one TBPTT "
        f"batch of {TEXT_PARITY_T} steps (3 segments), float64, card vs CPU: "
        f"parameters within {err:.3e} of their scale, loss "
        f"{card.score_value:.7f} vs {host.score_value:.7f} (<= 1e-4); "
        f"{smi}")
    return {"param_err": err, "loss_rel_err": loss_err}


def seq_classifier_conf():
    """MaskingLayer, Bidirectional(LSTM), GRU, LastTimeStep(GRU) and a
    softmax head, trained with truncated BPTT (Adam(1e-3), fused_update)."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    c = SEQ_CLS
    return (NeuralNetConfiguration.builder().seed(SEED).updater(Adam(1e-3))
            .fused_update().list()
            .layer(L.MaskingLayer())
            .layer(L.Bidirectional(layer=L.LSTM(n_out=c["width"])))
            .layer(L.GRU(n_out=c["width"]))
            .layer(L.LastTimeStep(layer=L.GRU(n_out=c["width"] // 2,
                                              reset_after=True)))
            .layer(L.OutputLayer(n_out=c["classes"], loss="mcxent",
                                 activation="softmax"))
            .backprop_type("TruncatedBPTT").tbptt_length(c["tbptt"])
            .set_input_type(InputType.recurrent(c["features"]))
            .build())


def seq_classifier_parity(smi: str, dev) -> dict:
    """The masked classifier fit through an iterator of two batches with
    variable lengths (zero-padded; the MaskingLayer derives the mask) on
    the card and on the CPU from the same parameters: one fused_update
    launch per segment on the card, every parameter within 1e-4 of its
    leaf's scale."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.data.iterators import (
        ExistingDataSetIterator)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    c = SEQ_CLS
    rng = np.random.default_rng(SEED + 90)
    data = []
    for _ in range(2):
        x = rng.normal(size=(c["batch"], c["T"], c["features"])).astype(
            np.float32)
        lengths = rng.integers(1, c["T"] + 1, c["batch"])
        x[np.arange(c["T"])[None, :] >= lengths[:, None]] = 0.0
        y = np.eye(c["classes"], dtype=np.float32)[
            rng.integers(0, c["classes"], c["batch"])]
        data.append((x, y))
    nets = []
    for where in (dev, "cpu"):
        net = MultiLayerNetwork(seq_classifier_conf()).init(device=where)
        _reset_kernel_counts()
        net.fit(ExistingDataSetIterator([DataSet(x, y) for x, y in data]))
        nets.append((net, _kernel_counts()["fused_update"]))
    (card, launches), (host, _) = nets
    segments = 2 * -(-c["T"] // c["tbptt"])
    check(launches == segments, f"classifier fused_update launches "
          f"{launches}, want {segments}")
    err = _tree_err(card._params, host._params)
    check(err <= 1e-4, f"masked classifier card vs CPU: parameters {err} "
          f"of their scale (want <= 1e-4)")
    log(f"[sequences] masked classifier (MaskingLayer, Bidirectional(LSTM "
        f"{c['width']}), GRU, LastTimeStep(GRU), {card.num_params()} "
        f"parameters) fit through an iterator of 2 batches, lengths 1 to "
        f"{c['T']}, truncated BPTT {c['tbptt']}: {launches} fused_update "
        f"launches; card vs CPU parameters within {err:.3e} of their scale "
        f"(<= 1e-4); {smi}")
    return {"param_err": err, "fused_update_launches": launches}


#: the module's shape layers at phase 25's check, with their input shapes
SHAPE_LAYERS = (
    ("Convolution1DLayer", (4, 64, 16), dict(n_out=32, kernel_size=5,
                                             stride=2, padding=2)),
    ("Convolution1DLayer", (4, 64, 16), dict(n_out=32, kernel_size=4,
                                             convolution_mode="same")),
    ("Subsampling1DLayer", (4, 64, 16), dict(kernel_size=3, stride=2,
                                             padding=1)),
    ("Subsampling1DLayer", (4, 64, 16), dict(pooling_type="avg")),
    ("Upsampling1D", (4, 64, 16), dict(size=3)),
    ("ZeroPadding1DLayer", (4, 64, 16), dict(padding=(2, 3))),
    ("Cropping1D", (4, 64, 16), dict(cropping=(3, 1))),
    ("SeparableConvolution1D", (4, 64, 16), dict(n_out=24, kernel_size=3,
                                                 depth_multiplier=2)),
    ("Upsampling2D", (4, 8, 14, 10), dict(size=(2, 3))),
    ("ZeroPaddingLayer", (4, 8, 14, 10), dict(padding=(1, 2, 3, 0))),
    ("Cropping2D", (4, 8, 14, 10), dict(cropping=(2, 1, 0, 3))),
    ("SpaceToBatchLayer", (4, 8, 14, 10), dict(block_size=2)))


def shape_layers_parity(smi: str, dev) -> dict:
    """A forward and a backward of each 1D and 2D shape layer, card
    against CPU from the same seeded parameters and input, float32: the
    output and the gradients of a seeded weighted sum within 1e-5 of each
    array's scale."""
    from deeplearning4j_tpu_torch.common.tree import (get_path, leaf_paths,
                                                      tree_map)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    worst = {}
    for i, (kind, shape, kw) in enumerate(SHAPE_LAYERS):
        layer = getattr(L, kind)(**kw)
        layer.weight_init, layer.activation = "xavier", "identity"
        layer.set_input_type(InputType.recurrent(shape[2], shape[1])
                             if len(shape) == 3 else
                             InputType.convolutional(shape[2], shape[3],
                                                     shape[1]))
        gen = torch.Generator().manual_seed(SEED + i)
        params = layer.init_params(gen) if layer.has_params else {}
        x = torch.randn(shape, generator=gen)
        results = []
        for where in (dev, "cpu"):
            p = tree_map(lambda t: t.to(where).requires_grad_(True), params)
            xx = x.to(where).requires_grad_(True)
            y, _ = layer.apply(p, xx, {}, False)
            ct = torch.randn(y.shape, generator=torch.Generator()
                             .manual_seed(SEED + 100 + i)).to(where)
            paths = leaf_paths(p)
            grads = torch.autograd.grad((y * ct).sum(), [xx] + [
                get_path(p, q) for q in paths])
            results.append([y.detach().cpu()] + [g.cpu() for g in grads])
        err = max((a - b).abs().max().item()
                  / max(b.abs().max().item(), 1e-30)
                  for a, b in zip(*results))
        name = f"{kind}{kw}"
        worst[name] = err
        check(err <= 1e-5, f"{name} card vs CPU: {err} of the scale (want "
              f"<= 1e-5)")
    log(f"[sequences] shape layers: {len(SHAPE_LAYERS)} 1D and 2D layers, "
        f"forward and backward, card vs CPU within "
        f"{max(worst.values()):.3e} of the scale (<= 1e-5); {smi}")
    return worst


# --- phase 26 --------------------------------------------------------------------

TL_BATCH = 15            # dl4j-examples EditLastLayerOthersFrozen's batch
TL_CLASSES = 5           # the flower-photos set's classes
TL_FC2 = 19              # VGG16: 13 convolutions and 5 pools, fc1, fc2, out
TL_PARAMS = 134_281_029  # VGG16 at 1000 classes, re-headed to 5
TL_TRAINABLE = 4096 * TL_CLASSES + TL_CLASSES
TL_WARMUP = 2
TL_STEPS = 5
TL_FEATURIZE = 4         # batches the helper featurizes
TL_PARITY_BATCH = 2
SCNN_FROZEN = 7          # SimpleCNN: its convolution stack, pools included
SCNN_BATCH = 16


def _tl_head(classes: int = TL_CLASSES):
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    return L.OutputLayer(n_out=classes, weight_init="xavier",
                         activation="softmax", loss="mcxent")


def reheaded(src, frozen_until: int):
    """dl4j-examples' EditLastLayerOthersFrozen on ``src``: Nesterovs(5e-5)
    and seed 12345 through FineTuneConfiguration, layers ``0..
    frozen_until`` frozen, the output layer replaced by a 5-class softmax
    (xavier)."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                      TransferLearning)

    ft = (FineTuneConfiguration.builder()
          .updater(Nesterovs(learning_rate=5e-5, momentum=0.9))
          .seed(12345).build())
    return (TransferLearning.builder(src).fine_tune_configuration(ft)
            .set_feature_extractor(frozen_until).remove_output_layer()
            .add_layer(_tl_head()).build())


def _frozen_leaves(net):
    """The parameter tensors of the network's FrozenLayer layers."""
    from deeplearning4j_tpu_torch.common.tree import get_path

    return [get_path(net._params, p) for p in net._frozen_paths()]


def _checksum(tensors) -> int:
    """The sum of the tensors' 32-bit words, as one integer: a bitwise
    fingerprint that moves with any changed bit pattern."""
    return int(sum(int(t.detach().contiguous().view(torch.int32)
                       .to(torch.int64).sum()) for t in tensors))


def transfer_batch(dev, seed: int, n: int = TL_BATCH):
    """Seeded pixels in [0, 1] at 224x224x3 and one-hot labels over the
    flower-photos set's 5 classes (which the repository does not hold),
    placed on the card."""
    from deeplearning4j_tpu_torch.data import DataSet

    rng = np.random.default_rng(seed)
    x = rng.random((n, 3, IMAGE, IMAGE), dtype=np.float32)
    y = np.eye(TL_CLASSES, dtype=np.float32)[rng.integers(0, TL_CLASSES, n)]
    return DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))


class _InjectedMasks:
    """``ops.nn.dropout_mask`` replaced by fixed seeded masks, one per
    shape, on the device asked for: the card and the CPU draw the same
    bits."""

    def __init__(self, seed: int):
        from deeplearning4j_tpu_torch.ops import nn as ops

        self.ops, self.draw, self.seed, self.masks = ops, ops.dropout_mask, \
            seed, {}

    def __call__(self, shape, rate, generator, device):
        key = (tuple(shape), rate)
        if key not in self.masks:
            rng = np.random.default_rng(self.seed + len(self.masks))
            self.masks[key] = torch.from_numpy(rng.random(tuple(shape))
                                               < 1.0 - rate)
        return self.masks[key].to(device)

    def __enter__(self):
        self.ops.dropout_mask = self
        return self

    def __exit__(self, *exc):
        self.ops.dropout_mask = self.draw


def transfer_cpu_parity(pre_path: str, dev) -> dict:
    """The re-headed VGG16 from the same pretrained zip on the card and on
    the CPU, float32, TF32 off, deterministic cuDNN: one fit step at batch
    2 with the same injected dropout masks (the frozen dense layers drop
    out in fit); every parameter within 1e-4 of its leaf's scale, the
    frozen ones bitwise unchanged on both."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    det = torch.backends.cudnn.deterministic
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.deterministic = True
    Environment.get().set_tf32(False)
    try:
        nets = []
        ds = transfer_batch(torch.device("cpu"), SEED + 71, TL_PARITY_BATCH)
        for d in (dev, torch.device("cpu")):
            net = reheaded(restore_model(pre_path, device=d), TL_FC2)
            frozen = [t.clone() for t in _frozen_leaves(net)]
            from deeplearning4j_tpu_torch.data import DataSet

            with _InjectedMasks(SEED + 72):
                net.fit(DataSet(ds.features.to(d), ds.labels.to(d)))
            if d.type == "cuda":
                torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in
                      zip(frozen, _frozen_leaves(net))),
                  f"VGG16 transfer on {d}: frozen parameters changed in the "
                  f"parity step")
            nets.append(net)
        card, host = nets
        err = _tree_err(card._params, host._params)
        loss_err = abs(card.score_value - host.score_value) \
            / abs(host.score_value)
    finally:
        torch.backends.cudnn.deterministic = det
        Environment.get().set_tf32(tf32)
    check(err <= 1e-4 and loss_err <= 1e-4, f"VGG16 transfer, card vs CPU "
          f"after one step: parameters {err:.3e} of their scale, loss "
          f"{loss_err:.3e} (want <= 1e-4)")
    return {"params": err, "loss": loss_err}


def transfer_helper(net, smi: str, dev) -> dict:
    """TransferLearningHelper over the fitted re-headed VGG16: featurize
    TL_FEATURIZE batches through the frozen bottom (images/s), fit the head
    on the features, and hold the full model's output against the top
    network's over the features (1e-5)."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearningHelper

    helper = TransferLearningHelper(net)
    check(helper.frozen_until == TL_FC2, f"helper frozen_until "
          f"{helper.frozen_until}")
    batches = [transfer_batch(dev, SEED + 80 + i)
               for i in range(TL_FEATURIZE)]
    helper.featurize(batches[0])                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = [helper.featurize(b) for b in batches]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    fx = torch.cat([f.features for f in feats])
    fy = torch.cat([f.labels for f in feats])
    top = helper.unfrozen_mln()
    before = top.score(DataSet(fx, fy))
    helper.fit_featurized(DataSet(fx, fy), epochs=3)
    after = top.score(DataSet(fx, fy))
    x = batches[0].features
    full = net.output(x).float()
    via_top = top.output(feats[0].features).float()
    torch.cuda.synchronize()
    err = (full - via_top).abs().max().item()
    check(err <= 1e-5, f"VGG16 transfer: the full model's output differs "
          f"from the helper's top over the features by {err:.3e} (want "
          f"<= 1e-5)")
    check(np.isfinite(after) and after < before, f"fit_featurized: the "
          f"head's loss {before} -> {after}")
    ips = len(batches) * TL_BATCH / sec
    log(f"[transfer] TransferLearningHelper: featurize "
        f"{len(batches) * TL_BATCH} images through the frozen bottom at "
        f"{ips:.2f} images/s; fit_featurized 3 epochs of the head: loss "
        f"{before:.5f} -> {after:.5f}; full model vs top over the features "
        f"{err:.3e} (<= 1e-5); {smi}")
    return {"featurize_images_per_s": ips, "head_loss": [before, after],
            "output_err": err}


def simplecnn_reheaded(smi: str, dev) -> dict:
    """The zoo SimpleCNN re-headed as VGG16 is (its convolution stack
    frozen, a 5-class head) and served with fused_epilogue on: 3 bn_act
    launches per forward (the frozen BNs take their own route), and the
    card against the CPU within 1e-4 of the output's scale (float32, TF32
    off)."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.models import SimpleCNN

    rng = np.random.default_rng(SEED + 90)
    x = rng.random((SCNN_BATCH, 3, 48, 48), dtype=np.float32)
    outs, launches = [], None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    Environment.get().set_tf32(False)
    try:
        for d in (dev, torch.device("cpu")):
            net = reheaded(SimpleCNN(seed=SEED).init(device=d), SCNN_FROZEN)
            set_fused_epilogue(net, True)
            alone, _, _ = expected_bn_launches(net.conf)
            _reset_kernel_counts()
            out = net.output(x).float()
            if d.type == "cuda":
                torch.cuda.synchronize()
                launches = _kernel_counts()["bn_act"]
            outs.append(out.cpu())
    finally:
        Environment.get().set_tf32(tf32)
    scale = outs[1].abs().max().item()
    err = (outs[0] - outs[1]).abs().max().item() / scale
    check(alone == 3 and launches == 3, f"re-headed SimpleCNN: bn_act "
          f"launches {launches} per served forward, {alone} read off the "
          f"configuration (want 3)")
    check(err <= 1e-4, f"re-headed SimpleCNN, card vs CPU: {err:.3e} of "
          f"the output's scale (want <= 1e-4)")
    log(f"[transfer] zoo SimpleCNN re-headed (layers 0-{SCNN_FROZEN} "
        f"frozen, 5-class head), fused_epilogue on, batch {SCNN_BATCH}: "
        f"{launches} bn_act launches per served forward through the "
        f"FrozenLayer-wrapped BNs; card vs CPU {err:.3e} of the output's "
        f"scale (<= 1e-4); {smi}")
    return {"bn_act_launches": launches, "cpu_parity": err}


def phase_transfer(smi: str, dev):
    """Phase 26: zoo VGG16 at its published widths through the pretrained
    cache, re-headed for 5 classes and fine-tuned (see the module
    docstring)."""
    import tempfile

    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.models import VGG16, PretrainedType

    torch.cuda.empty_cache()
    cache = tempfile.mkdtemp(prefix="pretrained-")
    old = os.environ.get("DL4J_TPU_PRETRAINED_DIR")
    os.environ["DL4J_TPU_PRETRAINED_DIR"] = cache
    try:
        zoo = VGG16(seed=SEED)
        src = zoo.init(device=dev)
        check(src.num_params() == VGG_PARAMS, f"VGG16 has "
              f"{src.num_params()} parameters, want {VGG_PARAMS}")
        t0 = time.perf_counter()
        src.save(zoo.pretrained_path(PretrainedType.IMAGENET))
        save_s = time.perf_counter() - t0
        zip_bytes = os.path.getsize(zoo.pretrained_path())
        t0 = time.perf_counter()
        pre = VGG16().init_pretrained(PretrainedType.IMAGENET, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(torch.equal(pre.params(), src.params()), "VGG16 read back "
              "through init_pretrained differs from the model written")
        del src
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = reheaded(pre, TL_FC2)
        del pre
        trainable = sum(int(t.numel()) for k, layer in zip(net._keys,
                                                           net.layers)
                        if type(layer).__name__ != "FrozenLayer"
                        for t in net._params[k].values())
        check(net.num_params() == TL_PARAMS and trainable == TL_TRAINABLE,
              f"re-headed VGG16 has {net.num_params()} parameters, "
              f"{trainable} trainable; want {TL_PARAMS}, {TL_TRAINABLE}")
        gc = net.conf.global_conf
        gc.compute_dtype = "bfloat16"
        gc.fused_update = True
        ds = transfer_batch(dev, SEED + 70)
        frozen = _frozen_leaves(net)
        kept = [t.clone() for t in frozen]
        sum_before = _checksum(frozen)
        score_before = net.score(ds)
        losses = []
        for _ in range(TL_WARMUP):
            net.fit(ds)
            losses.append(net.score_value)
        torch.cuda.synchronize()
        prof = OpProfiler.get()
        prof.reset()
        _reset_kernel_counts()
        ms = []
        for _ in range(TL_STEPS):
            t0 = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(net.score_value)
        counts = _kernel_counts()
        fallbacks = prof.counter_value("precision/fused_fallbacks")
        peak = torch.cuda.max_memory_allocated()
        frozen = _frozen_leaves(net)
        sum_after = _checksum(frozen)
        same = all(torch.equal(a, b) for a, b in zip(kept, frozen))
        del kept
        score_after = net.score(ds)
        bucket = sum(int(v.numel()) for v in net._flat.params.values())
        check(counts["fused_update"] == TL_STEPS and not fallbacks,
              f"VGG16 transfer: fused_update launched "
              f"{counts['fused_update']} times in {TL_STEPS} steps, "
              f"fallbacks {fallbacks} (want 1 per step)")
        check(bucket == TL_PARAMS, f"the fused bucket holds {bucket} "
              f"elements, want {TL_PARAMS} (frozen ranges included)")
        check(same and sum_before == sum_after, f"VGG16 transfer: frozen "
              f"parameters changed (checksum {sum_before} -> {sum_after})")
        check(all(np.isfinite(losses)) and score_after < score_before,
              f"VGG16 transfer: the head's loss did not fall: "
              f"{score_before} -> {score_after}; step losses {losses}")
        result = {"params": TL_PARAMS, "trainable": TL_TRAINABLE,
                  "batch": TL_BATCH, "images_per_s":
                  TL_BATCH * len(ms) / sum(ms) * 1e3, **_ms_stats(ms),
                  "peak_bytes": peak, "losses": losses,
                  "score": [score_before, score_after],
                  "fused_update_launches": counts["fused_update"],
                  "fused_update_elements": bucket,
                  "frozen_checksum": sum_before, "zip_bytes": zip_bytes,
                  "save_s": save_s, "load_s": load_s}
        log(f"[transfer] zoo VGG16 ({VGG_PARAMS} parameters) saved as a "
            f"model zip of {zip_bytes} B in {save_s:.2f} s, read back "
            f"through VGG16().init_pretrained() in {load_s:.2f} s, bitwise; "
            f"re-headed (layers 0-{TL_FC2} frozen, 5-class xavier softmax, "
            f"Nesterovs(5e-5), seed 12345): {TL_PARAMS} parameters, "
            f"{TL_TRAINABLE} trainable; batch {TL_BATCH}, bf16 compute, "
            f"fused_update: {result['images_per_s']:.2f} images/s, step ms "
            f"median {result['step_ms_median']:.2f} p10 "
            f"{result['step_ms_p10']:.2f} p90 {result['step_ms_p90']:.2f} "
            f"({TL_STEPS} steps after {TL_WARMUP} warm-ups); peak device "
            f"memory {peak} B; fused_update {counts['fused_update'] / TL_STEPS:.0f} "
            f"launch per step over {bucket} elements; frozen checksum "
            f"{sum_before} before and {sum_after} after (bitwise); the "
            f"head's loss on the batch {score_before:.5f} -> "
            f"{score_after:.5f}; {smi}")
        log(f"[transfer] losses {losses}")
        result["guard"] = transfer_guard(net, ds, smi)
        result["helper"] = transfer_helper(net, smi, dev)
        del net, ds
        torch.cuda.empty_cache()
        p = transfer_cpu_parity(zoo.pretrained_path(), dev)
        result["cpu_parity"] = p
        log(f"[transfer] re-headed VGG16, float32, TF32 off, batch "
            f"{TL_PARITY_BATCH}, one fit step with the same injected dropout "
            f"masks, card vs CPU: parameters {p['params']:.3e} of their "
            f"scale, loss {p['loss']:.3e} (<= 1e-4); frozen parameters "
            f"bitwise unchanged on both")
    finally:
        if old is None:
            os.environ.pop("DL4J_TPU_PRETRAINED_DIR", None)
        else:
            os.environ["DL4J_TPU_PRETRAINED_DIR"] = old
        import shutil

        shutil.rmtree(cache, ignore_errors=True)
    torch.cuda.empty_cache()
    result["simplecnn"] = simplecnn_reheaded(smi, dev)
    return result


# --- phase 27 --------------------------------------------------------------------

VAE = {"n_in": 784, "encoder": (256, 256), "latent": 32,
       "decoder": (256, 256), "batch": 128, "lr": 1e-3, "l2": 1e-4}
VAE_PARITY_BATCHES = 2
CAPS_BATCH = 32
CAPS_WARMUP = 2
CAPS_STEPS = 5
CAPS_PARITY_BATCH = 4
C3D_INPUT = (4, 3, 16, 112, 112)    # C3D's clips: 16 frames of 112x112
C3D_CLASSES = 101                   # UCF101


def vae_net(dev, dtype: str = "float32"):
    """dl4j-examples' VaeMNISTAnomaly: one VariationalAutoencoder (784 in,
    encoder 256-256, 32 latents, decoder 256-256, Bernoulli, leakyrelu),
    Adam(1e-3), l2 1e-4; parameters in ``dtype``."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(SEED)
            .updater(Adam(VAE["lr"])).l2(VAE["l2"]).data_type(dtype)
            .list()
            .layer(L.VariationalAutoencoder(
                n_out=VAE["latent"], encoder_layer_sizes=VAE["encoder"],
                decoder_layer_sizes=VAE["decoder"],
                reconstruction_distribution="bernoulli",
                activation="leakyrelu"))
            .set_input_type(InputType.feed_forward(VAE["n_in"])).build())
    return MultiLayerNetwork(conf).init(device=dev)


class _InjectedNormals:
    """``ops.nn.normal`` replaced by fixed seeded draws, one per shape."""

    def __init__(self, seed: int):
        from deeplearning4j_tpu_torch.ops import nn as ops

        self.ops, self.draw, self.seed, self.cache = ops, ops.normal, seed, {}

    def __call__(self, shape, generator, dtype, device):
        key = tuple(shape)
        if key not in self.cache:
            rng = np.random.default_rng(self.seed + len(self.cache))
            self.cache[key] = torch.from_numpy(
                rng.normal(size=key).astype(np.float32))
        return self.cache[key].to(device=device, dtype=dtype)

    def __enter__(self):
        self.ops.normal = self
        return self

    def __exit__(self, *exc):
        self.ops.normal = self.draw


def phase_vae(smi: str, dev) -> dict:
    """The VAE pretrained for one epoch of the synthetic MNIST fallback at
    batch 128 (samples/s, the negative ELBO at the first and last step),
    then the card against the CPU over VAE_PARITY_BATCHES batches with the
    same injected eps, in float64: Adam turns a gradient within float32
    rounding of 0 into a step of lr either way, so in float32 the two
    devices' parameters may part by lr where a gradient is that small
    (phase 24's zoo parity steps in float64 for the same reason)."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.data import (DataSet,
                                               MnistDataSetIterator)

    it = MnistDataSetIterator(VAE["batch"], train=True)
    net = vae_net(dev)
    first = []

    class _First:
        """The iterator, noting the negative ELBO of the first step."""

        def __init__(self, data):
            self.data = data

        def reset(self):
            self.data.reset()

        def __iter__(self):
            for i, ds in enumerate(self.data):
                yield ds
                if i == 0:
                    first.append(net.score_value)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(_First(it), epochs=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = len(it.features)
    last = net.score_value
    check(np.isfinite(last) and last < first[0], f"VAE pretraining: the "
          f"negative ELBO did not fall: {first[0]} -> {last}")
    x = it.features
    tf32 = torch.backends.cuda.matmul.allow_tf32
    Environment.get().set_tf32(False)
    try:
        nets = []
        for d in (dev, torch.device("cpu")):
            twin = vae_net(d, "float64")
            with _InjectedNormals(SEED + 100):
                twin.pretrain([DataSet(x[i * VAE["batch"]:(i + 1)
                                         * VAE["batch"]].astype(np.float64),
                                       None)
                               for i in range(VAE_PARITY_BATCHES)])
            nets.append(twin)
        err = _tree_err(nets[0]._params, nets[1]._params)
        lerr = abs(nets[0].score_value - nets[1].score_value) \
            / abs(nets[1].score_value)
    finally:
        Environment.get().set_tf32(tf32)
    check(err <= 1e-4 and lerr <= 1e-4, f"VAE pretraining, card vs CPU: "
          f"parameters {err:.3e} of their scale, negative ELBO {lerr:.3e} "
          f"(want <= 1e-4)")
    result = {"params": net.num_params(), "samples_per_s": n / sec,
              "steps": -(-n // VAE["batch"]), "neg_elbo": [first[0], last],
              "cpu_parity": {"params": err, "neg_elbo": lerr}}
    log(f"[pretrain] VariationalAutoencoder at VaeMNISTAnomaly's widths "
        f"({net.num_params()} parameters: 784 -> 256-256 -> 32 -> 256-256 "
        f"-> 784, Bernoulli, leakyrelu, Adam(1e-3), l2 1e-4) pretrained "
        f"one epoch of {n} synthetic MNIST images at batch {VAE['batch']}: "
        f"{n / sec:.1f} samples/s; negative ELBO {first[0]:.4f} -> "
        f"{last:.4f}; card vs CPU ({VAE_PARITY_BATCHES} batches, injected "
        f"eps, float64): parameters {err:.3e} of their scale, negative "
        f"ELBO {lerr:.3e} (<= 1e-4); {smi}")
    return result


def capsnet_conf():
    """CapsNet at Sabour et al. (2017)'s widths on 28x28x1: convolution 256
    9x9 ReLU, PrimaryCapsules 32 channels of 8-D capsules 9x9 stride 2
    (1,152 capsules), CapsuleLayer 10 capsules of 16-D with 3 routings,
    CapsuleStrengthLayer, softmax and negative log-likelihood;
    Adam(1e-3)."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    return (NeuralNetConfiguration.builder().seed(SEED).updater(Adam(1e-3))
            .list()
            .layer(L.ConvolutionLayer(n_out=256, kernel_size=(9, 9),
                                      activation="relu"))
            .layer(L.PrimaryCapsules(capsule_dimensions=8, channels=32,
                                     kernel_size=(9, 9), stride=(2, 2)))
            .layer(L.CapsuleLayer(capsules=10, capsule_dimensions=16,
                                  routings=3))
            .layer(L.CapsuleStrengthLayer())
            .layer(L.ActivationLayer(activation="softmax"))
            .layer(L.LossLayer(loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(28, 28, 1)).build())


def phase_capsnet(smi: str, dev) -> dict:
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import DataSet, MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    it = MnistDataSetIterator(CAPS_BATCH, train=True, num_examples=256,
                              flatten=False)
    conf = capsnet_conf()
    check(conf.layers[1].capsules == 1152, f"primary capsules "
          f"{conf.layers[1].capsules}, want 1152")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = MultiLayerNetwork(conf).init(device=dev)
    net.conf.global_conf.fused_update = True
    ds = DataSet(torch.from_numpy(it.features[:CAPS_BATCH]).to(dev),
                 torch.from_numpy(it.labels[:CAPS_BATCH]).to(dev))
    losses = []
    for _ in range(CAPS_WARMUP):
        net.fit(ds)
        losses.append(net.score_value)
    torch.cuda.synchronize()
    prof = OpProfiler.get()
    prof.reset()
    _reset_kernel_counts()
    ms = []
    for _ in range(CAPS_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score_value)
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["fused_update"] == CAPS_STEPS
          and not prof.counter_value("precision/fused_fallbacks"),
          f"CapsNet: fused_update launched {counts['fused_update']} times in "
          f"{CAPS_STEPS} steps (want 1 per step)")
    check(all(np.isfinite(losses)), f"CapsNet: non-finite loss {losses}")
    n_params = net.num_params()
    del net
    tf32 = torch.backends.cuda.matmul.allow_tf32
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    Environment.get().set_tf32(False)
    try:
        x = it.features[:CAPS_PARITY_BATCH]
        y = it.labels[:CAPS_PARITY_BATCH]
        res = []
        for d in (dev, torch.device("cpu")):
            twin = MultiLayerNetwork(capsnet_conf()).init(device=d)
            grads, score = twin.compute_gradient_and_score(DataSet(x, y))
            res.append(({str(i): g for i, g in enumerate(grads)}, score,
                        twin.output(x).float().cpu()))
        gerr = _tree_err(res[0][0], res[1][0])
        lerr = abs(res[0][1] - res[1][1]) / abs(res[1][1])
        oerr = (res[0][2] - res[1][2]).abs().max().item() \
            / res[1][2].abs().max().item()
    finally:
        torch.backends.cudnn.deterministic = det
        Environment.get().set_tf32(tf32)
    check(max(gerr, lerr, oerr) <= 1e-4, f"CapsNet card vs CPU: gradients "
          f"{gerr:.3e} of their scale, loss {lerr:.3e}, output {oerr:.3e} "
          f"(want <= 1e-4)")
    result = {"params": n_params, "batch": CAPS_BATCH,
              "images_per_s": CAPS_BATCH * len(ms) / sum(ms) * 1e3,
              **_ms_stats(ms), "peak_bytes": peak, "losses": losses,
              "fused_update_launches": counts["fused_update"],
              "cpu_parity": {"grads": gerr, "loss": lerr, "output": oerr}}
    log(f"[capsnet] CapsNet at Sabour et al.'s widths ({n_params} "
        f"parameters: conv 256 9x9, 1152 primary 8-D capsules, 10 routed "
        f"16-D capsules, 3 routings), Adam(1e-3) fused_update, float32, "
        f"batch {CAPS_BATCH}: step ms median {result['step_ms_median']:.2f}"
        f" p10 {result['step_ms_p10']:.2f} p90 {result['step_ms_p90']:.2f}"
        f" ({result['images_per_s']:.1f} images/s); peak {peak} B; "
        f"fused_update {counts['fused_update'] / CAPS_STEPS:.0f} launch per "
        f"step; losses {losses[0]:.5f} -> {losses[-1]:.5f}; card vs CPU "
        f"(batch {CAPS_PARITY_BATCH}, TF32 off): gradients {gerr:.3e}, loss "
        f"{lerr:.3e}, output {oerr:.3e} (<= 1e-4); {smi}")
    return result


def _layer_cases():
    """(name, layers, input type) of each new class at its CPU test's size
    (tests/test_torch_layers_rest.py), a loss head appended per output
    type; the 3D family also at C3D's first two blocks."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as T

    ff, rnn, cnn = T.feed_forward, T.recurrent, T.convolutional
    c3d = T.convolutional_3d
    return [
        ("PReLULayer", [L.PReLULayer()], cnn(4, 4, 3)),
        ("ElementWiseMultiplicationLayer",
         [L.ElementWiseMultiplicationLayer(activation="tanh")], ff(6)),
        ("ThresholdedReLULayer", [L.DenseLayer(n_out=6, activation="tanh"),
                                  L.ThresholdedReLULayer(theta=0.3)], ff(6)),
        ("GroupNormalizationLayer", [L.GroupNormalizationLayer(groups=2)],
         cnn(4, 4, 4)),
        ("FlattenLayer", [L.FlattenLayer()], c3d(2, 3, 3, 2)),
        ("Permute", [L.Permute(dims=(2, 1))], rnn(4, 5)),
        ("ReshapeLayer", [L.ReshapeLayer(shape=(5, 4))], ff(20)),
        ("RepeatVector", [L.RepeatVector(n=3)], ff(4)),
        ("TimeDistributedLayer", [L.TimeDistributedLayer(
            inner=L.DenseLayer(n_out=3, activation="tanh"))], rnn(4, 5)),
        ("LambdaLayer", [L.LambdaLayer(fn=lambda v: v * 2.0 + 1.0,
                                       name="chip_smoke_affine")], ff(6)),
        ("Convolution3DLayer", [L.Convolution3DLayer(
            n_out=2, kernel_size=(3, 3, 3), stride=(2, 2, 2),
            convolution_mode="same")], c3d(5, 5, 4, 2)),
        ("Subsampling3DLayer", [L.Subsampling3DLayer(
            pooling_type="avg", kernel_size=(3, 3, 3), stride=(2, 2, 2),
            padding=(1, 1, 1))], c3d(5, 5, 5, 2)),
        ("Upsampling3D", [L.Upsampling3D(size=(1, 2, 3))], c3d(2, 3, 3, 2)),
        ("ZeroPadding3DLayer", [L.ZeroPadding3DLayer(
            padding=((1, 0), (0, 2), (1, 1)))], c3d(2, 3, 3, 2)),
        ("Cropping3D", [L.Cropping3D(cropping=(1, 0, 1))], c3d(4, 4, 4, 2)),
        ("LocallyConnected2D", [L.LocallyConnected2D(
            n_out=3, kernel_size=(2, 3), stride=(1, 2), activation="tanh")],
         cnn(5, 6, 2)),
        ("LocallyConnected1D", [L.LocallyConnected1D(
            n_out=3, kernel_size=3, stride=2)], rnn(4, 9)),
        ("LearnedSelfAttentionLayer", [L.LearnedSelfAttentionLayer(
            n_out=8, n_heads=2, n_queries=3)], rnn(8, 5)),
        ("RecurrentAttentionLayer", [L.RecurrentAttentionLayer(
            n_out=6, n_heads=2)], rnn(4, 5)),
        ("ConvLSTM2DLayer", [L.ConvLSTM2DLayer(n_out=3, kernel_size=(3, 3))],
         c3d(3, 5, 5, 2)),
        ("AlphaDropoutLayer", [L.AlphaDropoutLayer(rate=0.3)], ff(6)),
        ("GaussianDropoutLayer", [L.GaussianDropoutLayer(rate=0.3)], ff(6)),
        ("GaussianNoiseLayer", [L.GaussianNoiseLayer(stddev=0.2)],
         rnn(4, 5)),
        ("SpatialDropoutLayer", [L.SpatialDropoutLayer(rate=0.4)],
         cnn(3, 3, 4)),
        ("DropConnect", [L.DenseLayer(n_out=7, activation="tanh",
                                      weight_noise=L.DropConnect(0.7))],
         ff(5)),
        ("WeightNoise", [L.DenseLayer(n_out=7, activation="tanh",
                                      weight_noise=L.WeightNoise(
                                          stddev=0.1))], ff(5)),
        ("FrozenLayer", [L.FrozenLayer(layer=L.DenseLayer(
            n_out=6, activation="tanh", dropout=0.3)),
            L.DenseLayer(n_out=5, activation="tanh")], ff(6)),
        ("C3D", [L.Convolution3DLayer(n_out=64, kernel_size=(3, 3, 3),
                                      padding=(1, 1, 1), activation="relu"),
                 L.Subsampling3DLayer(kernel_size=(1, 2, 2),
                                      stride=(1, 2, 2)),
                 L.Convolution3DLayer(n_out=128, kernel_size=(3, 3, 3),
                                      padding=(1, 1, 1), activation="relu"),
                 L.Subsampling3DLayer(kernel_size=(2, 2, 2),
                                      stride=(2, 2, 2))],
         c3d(*C3D_INPUT[2:], C3D_INPUT[1])),
    ]


def _case_net(layers, in_type, dev, classes, dtype="float32"):
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import RNNInput
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def build(head=None):
        lb = (NeuralNetConfiguration.builder().seed(SEED).updater(Sgd(0.1))
              .data_type(dtype).list())
        for layer in layers + ([head] if head is not None else []):
            lb = lb.layer(copy.deepcopy(layer))
        return lb.set_input_type(in_type).build()

    out = build().layer_output_types[-1]
    conf = build((L.RnnOutputLayer if isinstance(out, RNNInput)
                  else L.OutputLayer)(n_out=classes, activation="softmax",
                                      loss="mcxent"))
    return MultiLayerNetwork(conf).init(device=dev), out


def _case_batch(in_type, out, batch, classes, seed):
    from deeplearning4j_tpu_torch.nn.conf.inputs import (CNN3DInput,
                                                         CNNInput, FFInput,
                                                         RNNInput)

    rng = np.random.default_rng(seed)
    shape = {FFInput: lambda t: (t.size,),
             RNNInput: lambda t: (t.timesteps, t.size),
             CNNInput: lambda t: (t.channels, t.height, t.width),
             CNN3DInput: lambda t: (t.channels, t.depth, t.height,
                                    t.width)}[type(in_type)](in_type)
    x = rng.normal(size=(batch,) + shape).astype(np.float32)
    lead = (batch, out.timesteps) if isinstance(out, RNNInput) else (batch,)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, lead)]
    return x, y


def c3d_step_ms(layers, in_type, dev) -> float:
    """One float32 fit step of C3D's first two blocks on the card, after a
    warm-up step (cuDNN's plans)."""
    from deeplearning4j_tpu_torch.data import DataSet

    net, o_t = _case_net(layers, in_type, dev, C3D_CLASSES)
    x, y = _case_batch(in_type, o_t, C3D_INPUT[0], C3D_CLASSES, SEED + 113)
    ds = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    net.fit(ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(ds)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_layers(smi: str, dev) -> dict:
    """Every other new class on the card against the CPU, float32, TF32
    off: from the same seeded weights, the forward and one SGD fit step
    (random draws injected: the same masks and normals on both), every
    output and parameter within 1e-4 of its scale. C3D's first two blocks
    at [4, 3, 16, 112, 112] (UCF101's 101 classes) are timed in float32
    and compared in float64: their convolution biases' gradients sum
    802,816 terms that cancel, which float32 leaves at about 2e-3 of the
    step on one device against the other."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import DataSet

    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    Environment.get().set_tf32(False)
    try:
        for name, layers, in_type in _layer_cases():
            c3d = name == "C3D"
            batch, classes = (C3D_INPUT[0], C3D_CLASSES) if c3d else (3, 3)
            dtype = "float64" if c3d else "float32"
            res = []
            OpProfiler.get().reset()
            for d in (dev, torch.device("cpu")):
                net, o_t = _case_net(layers, in_type, d, classes, dtype)
                x, y = _case_batch(in_type, o_t, batch, classes, SEED + 110)
                ds = DataSet(torch.from_numpy(x).to(d, getattr(torch, dtype)),
                             torch.from_numpy(y).to(d, getattr(torch, dtype)))
                fwd = net.output(ds.features).cpu()
                with _InjectedMasks(SEED + 111), _InjectedNormals(SEED + 112):
                    net.fit(ds)
                res.append((fwd, net._params, net.score_value))
            ferr = (res[0][0] - res[1][0]).abs().max().item() \
                / max(res[1][0].abs().max().item(), 1e-30)
            perr = _tree_err(res[0][1], res[1][1])
            lerr = abs(res[0][2] - res[1][2]) / abs(res[1][2])
            check(max(ferr, perr, lerr) <= 1e-4, f"{name}, card vs CPU: "
                  f"forward {ferr:.3e}, parameters after a step {perr:.3e}, "
                  f"loss {lerr:.3e} (want <= 1e-4)")
            out[name] = {"forward": ferr, "params": perr, "loss": lerr,
                         "dtype": dtype}
            routes = {k: v for k, v in OpProfiler.get().get_counters().items()
                      if k.startswith("attention/mha_")}
            if routes:
                # the attention op's route for this layer's shapes, both
                # devices' calls counted
                out[name]["attention_routes"] = routes
            del res
    finally:
        torch.backends.cudnn.deterministic = det
        Environment.get().set_tf32(tf32)
    c3d = [c for c in _layer_cases() if c[0] == "C3D"][0]
    out["C3D"]["fit_step_ms"] = (c3d_step_ms(c3d[1], c3d[2], dev)
                                 if dev.type == "cuda" else None)
    worst = max(max(v["forward"], v["params"], v["loss"])
                for v in out.values())
    log(f"[layers] {len(out)} new layer classes and configurations, card vs "
        f"CPU (float32, C3D float64; TF32 off, injected draws): forward and "
        f"one SGD step "
        f"within {worst:.3e} of their scale (<= 1e-4); C3D's first two "
        f"blocks at {list(C3D_INPUT)} ({C3D_CLASSES} classes): fit step "
        f"{out['C3D']['fit_step_ms']} ms on the card; attention routes "
        f"{ {n: v['attention_routes'] for n, v in out.items() if 'attention_routes' in v} }; {smi}")
    return out


# --- phase 28 --------------------------------------------------------------------

REMAT_STEPS = 3
REMAT_SELECTIVE = ["stem_bn", "s0b0_bn1"]


def remat_run(policy, ds, dev) -> dict:
    """ResNet-50 as phase 6 trains it (bf16 compute, fused_update, bf16
    state), REMAT_STEPS fit steps under ``policy``: losses, the peak
    device memory of the steps, their times, the parameters."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler

    torch.cuda.empty_cache()
    model = train_model(dev, True, "bfloat16", "bfloat16")
    model.set_remat_policy(policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    OpProfiler.get().reset()
    _reset_kernel_counts()
    losses, ms = [], []
    for _ in range(REMAT_STEPS):
        t0 = time.perf_counter()
        model.fit(ds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(model.score_value)
    peak = torch.cuda.max_memory_allocated()
    launches = _kernel_counts()["fused_update"]
    params = model.params().detach().clone()
    del model
    torch.cuda.empty_cache()
    return {"losses": losses, "peak_bytes": peak, "peak_above_start":
            peak - base, "step_ms_median": statistics.median(ms),
            "step_ms": ms, "params": params, "fused_update_launches":
            launches}


def _scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def phase_remat(smi: str, dev) -> dict:
    """Phase 28: ResNet-50 training under each rematerialization policy,
    and the TextGenerationLSTM's TBPTT batch under "full" (see the module
    docstring)."""
    from deeplearning4j_tpu_torch.data import DataSet

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ds = synthetic_batch(TRAIN_BATCH, dev, SEED + 120)
    runs = {}
    try:
        for name, pol in (("none", "none"), ("full", "full"),
                          ("dots_only", "dots_only"),
                          ("checkpoint_dots_with_no_batch_dims",
                           "checkpoint_dots_with_no_batch_dims"),
                          ("selective", REMAT_SELECTIVE)):
            runs[name] = remat_run(pol, ds, dev)
        ref = runs["none"]
        result = {}
        for name, r in runs.items():
            perr = _scaled_err(r["params"], ref["params"])
            lerr = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                          ref["losses"]))
            bitwise = bool(torch.equal(r["params"], ref["params"])
                           and r["losses"] == ref["losses"])
            check(all(np.isfinite(r["losses"])) and perr <= 1e-6
                  and lerr <= 1e-6, f"remat {name}: parameters {perr:.3e} "
                  f"of their scale, losses {lerr:.3e} from the 'none' run "
                  f"(want <= 1e-6)")
            check(r["fused_update_launches"] == REMAT_STEPS,
                  f"remat {name}: fused_update launched "
                  f"{r['fused_update_launches']} times in {REMAT_STEPS} "
                  f"steps")
            result[name] = {k: v for k, v in r.items() if k != "params"}
            result[name].update(params_err=perr, losses_err=lerr,
                                bitwise=bitwise)
            log(f"[remat] ResNet-50 batch {TRAIN_BATCH}, bf16 compute, "
                f"fused_update, bf16 state, policy {name}"
                f"{' ' + str(REMAT_SELECTIVE) if name == 'selective' else ''}"
                f": peak device memory {r['peak_bytes']} B "
                f"({r['peak_above_start']} above the parameters and state), "
                f"step ms median {r['step_ms_median']:.2f} over "
                f"{REMAT_STEPS} steps; against 'none': parameters "
                f"{perr:.3e} of their scale, losses {lerr:.3e} (<= 1e-6), "
                f"bitwise {bitwise}; {smi}")
        check(runs["full"]["peak_bytes"] < ref["peak_bytes"], f"remat: "
              f"'full' peaks at {runs['full']['peak_bytes']} B, not below "
              f"'none' at {ref['peak_bytes']} B")
        del runs, ds
        torch.cuda.empty_cache()
        idx, chars = text_corpus()
        vocab = len(chars)
        x, y = text_batch(idx, vocab, TEXT_BATCH, TEXT_SEQ, dev, SEED + 130)
        tb = {}
        for pol in ("none", "full"):
            net = text_generation_net(vocab, dev)
            net.set_remat_policy(pol)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            net.fit(DataSet(x, y))
            torch.cuda.synchronize()
            tb[pol] = {"ms": (time.perf_counter() - t0) * 1e3,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "loss": net.score_value,
                       "params": net.params().detach().clone()}
            del net
        perr = _scaled_err(tb["full"]["params"], tb["none"]["params"])
        lerr = abs(tb["full"]["loss"] - tb["none"]["loss"]) \
            / abs(tb["none"]["loss"])
        bitwise = bool(torch.equal(tb["full"]["params"],
                                   tb["none"]["params"])
                       and tb["full"]["loss"] == tb["none"]["loss"])
        check(perr <= 1e-6 and lerr <= 1e-6, f"TBPTT under 'full': "
              f"parameters {perr:.3e}, loss {lerr:.3e} from 'none' (want "
              f"<= 1e-6)")
        result["textgen_tbptt"] = {
            p: {k: v for k, v in r.items() if k != "params"}
            for p, r in tb.items()}
        result["textgen_tbptt"].update(params_err=perr, loss_err=lerr,
                                       bitwise=bitwise)
        log(f"[remat] TextGenerationLSTM TBPTT batch ({TEXT_BATCH} x "
            f"{TEXT_SEQ}, {TEXT_TBPTT}-step segments): 'none' "
            f"{tb['none']['ms']:.2f} ms, peak {tb['none']['peak_bytes']} B; "
            f"'full' {tb['full']['ms']:.2f} ms, peak "
            f"{tb['full']['peak_bytes']} B; parameters {perr:.3e} of their "
            f"scale, loss {lerr:.3e} (<= 1e-6), bitwise {bitwise}; {smi}")
    finally:
        torch.backends.cudnn.deterministic = det
    return result


# --- phases 29-32: DataVec, telemetry, early stopping, evaluation -------------

DV_BATCH = 64           # bench.py's resnet50-disk and resnet50-predecoded
DV_STEPS = 10
DV_IMAGES = (DV_STEPS + 2) * DV_BATCH   # bench.py:445: 768 images
DV_QUEUE = 8
DV_PREFETCH_STEPS = 3   # host_prefetch=4 against 0 on ResNet-50
TELE_STEPS = 8          # the guard's gate run
TELE_NAN_STEP = 3       # the step whose features hold a NaN
TELE_EVERY = 4          # check_every_n and drain_every_n
TELE_ROUNDS = 2
TELE_TIMED = 5          # steps per setting and round
TELE_NAN_T = 510        # the TBPTT batch's NaN: its 11th segment of 20
TELE_COUNT_T = 100      # the TBPTT batch whose launches are counted
ES_MAX_EPOCHS = 5
ES_PATIENCE = 2
EVAL_BATCHES = 2


def write_jpegs(root: str, n: int, size: int, seed: int):
    """bench.py's synthetic JPEGs (bench.py:448-460): uniform-noise pixels
    from ``default_rng(seed)``, quality 85, image i in ``class_{i % 10}``;
    saved on a thread per core. Returns the pixels written ([n, H, W, 3]
    uint8), the container phase's images."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    pixels = np.stack([rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                       for _ in range(n)])
    for c in range(10):
        os.makedirs(os.path.join(root, f"class_{c:02d}"), exist_ok=True)

    def save(i):
        Image.fromarray(pixels[i]).save(
            os.path.join(root, f"class_{i % 10:02d}", f"{i:06d}.jpg"),
            quality=85)

    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        list(pool.map(save, range(n)))
    return pixels


def feed_steps(model, it, steps: int) -> tuple:
    """bench.py's loop over ``it`` (one generator): one warm-up fit(ds),
    then ``steps`` timed ones, each ending in a synchronize, with the wait
    on the iterator per step. Returns the first batch and the figures."""
    gen = iter(it)
    t0 = time.perf_counter()
    first = next(gen)
    first_wait = (time.perf_counter() - t0) * 1e3
    model.fit(first)
    torch.cuda.synchronize()
    ms, waits, losses = [], [], [model.score_value]
    t_all = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        ds = next(gen)
        t1 = time.perf_counter()
        model.fit(ds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        waits.append((t1 - t0) * 1e3)
        losses.append(model.score_value)
    total = time.perf_counter() - t_all
    gen.close()
    return first, {"images_per_s": DV_BATCH * steps / total, **_ms_stats(ms),
                   "wait_ms_median": statistics.median(waits),
                   "wait_ms_mean": sum(waits) / len(waits),
                   "wait_share": sum(waits) / sum(ms),
                   "first_wait_ms": first_wait, "losses": losses}


def _dv_line(tag: str, r: dict, smi: str) -> str:
    return (f"[{tag}] ResNet-50 {IMAGE}x{IMAGE}, 1000 classes, bf16, "
            f"fused_update, bf16 state, batch {DV_BATCH}: "
            f"{r['images_per_s']:.2f} images/s, step ms median "
            f"{r['step_ms_median']:.2f} p10 {r['step_ms_p10']:.2f} p90 "
            f"{r['step_ms_p90']:.2f} ({DV_STEPS} steps after 1 warm-up); "
            f"wait on the queue {r['wait_ms_median']:.2f} ms median a step "
            f"({100 * r['wait_share']:.1f}% of the steps' time; the first "
            f"batch {r['first_wait_ms']:.1f} ms); peak device memory "
            f"{r['peak_bytes']} B; fused_update launches "
            f"{r['fused_update_launches']} ({DV_STEPS + 1} steps); {smi}")


def phase_disk(smi: str, dev):
    """Phase 29: ResNet-50 trained from JPEG files through DataVec
    (bench.py:427-502). Returns the figures and the trained model, which
    phase 32 serves."""
    import tempfile

    import PIL
    from PIL import Image

    from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                               FileSplit, ImageRecordReader,
                                               RecordReaderDataSetIterator)

    root = tempfile.mkdtemp(prefix="jpegs-")
    try:
        t0 = time.perf_counter()
        pixels = write_jpegs(root, DV_IMAGES, IMAGE, 0)
        write_s = time.perf_counter() - t0
        workers = os.cpu_count() or 8
        rr = ImageRecordReader(height=IMAGE, width=IMAGE, channels=3,
                               workers=workers)
        rr.initialize(FileSplit(root, allowed_extensions=[".jpg"]))
        base = RecordReaderDataSetIterator(rr, batch_size=DV_BATCH,
                                           label_index=1, num_classes=1000)
        it = AsyncDataSetIterator(base, queue_size=DV_QUEUE,
                                  device_prefetch=True, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = train_model(dev, True, "bfloat16", "bfloat16")
        _reset_kernel_counts()
        first, r = feed_steps(model, it, DV_STEPS)
        r["fused_update_launches"] = _kernel_counts()["fused_update"]
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        # the decoder's pixels of the first batch, as the reader makes them
        paths = FileSplit(root, allowed_extensions=[".jpg"]).locations()
        want, labels = [], []
        for p in paths[:DV_BATCH]:
            with Image.open(p) as im:
                want.append((np.asarray(im.convert("RGB")).astype(np.float32)
                             / 255.0).transpose(2, 0, 1))
            labels.append(rr.labels.index(p.parent.name))
        got = first.features.cpu()
        same = torch.equal(got, torch.from_numpy(np.stack(want)))
        lab_ok = first.labels.argmax(1).cpu().tolist() == labels
        del first
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    check(all(np.isfinite(r["losses"])), f"disk: losses {r['losses']}")
    check(r["fused_update_launches"] == DV_STEPS + 1, f"disk: fused_update "
          f"launched {r['fused_update_launches']} times in {DV_STEPS + 1} "
          f"steps (want 1 per step)")
    check(same and lab_ok, f"disk: the first batch is not the decoder's "
          f"pixels / 255 (features bitwise {same}, labels {lab_ok})")
    r.update(decoder=f"PIL {PIL.__version__}", decode_workers=workers,
             cpu_count=os.cpu_count(), images=DV_IMAGES,
             jpeg_write_s=write_s, first_batch_bitwise=same)
    log(f"[disk] {DV_IMAGES} JPEGs of {IMAGE}x{IMAGE} (quality 85, ten "
        f"class folders) written in {write_s:.2f} s; ImageRecordReader "
        f"(decoder {r['decoder']}, {workers} decode workers, os.cpu_count() "
        f"{os.cpu_count()}) -> RecordReaderDataSetIterator -> "
        f"AsyncDataSetIterator(queue {DV_QUEUE}, device_prefetch); the first "
        f"batch bitwise the decoder's pixels / 255: {same}")
    log(_dv_line("disk", r, smi))
    log(f"[disk] losses {r['losses']}")
    return r, model, pixels


def _same_state(a, b) -> bool:
    """Parameters, layer states and updater state of two networks
    bitwise."""
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths

    def leaves(t):
        return [get_path(t, p) for p in leaf_paths(t or {})]

    return all(len(leaves(x)) == len(leaves(y)) and all(
        torch.equal(u, v) for u, v in zip(leaves(x), leaves(y)))
        for x, y in ((a._params, b._params), (a._states, b._states),
                     (a._updater_state, b._updater_state)))


def phase_container(smi: str, dev, pixels):
    """Phase 30: ResNet-50 trained from the pre-decoded container
    (bench.py:503-580), the pipeline's hand-over gates, and fit's
    host_prefetch against none on both networks."""
    import tempfile

    from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                               BinaryRecordDataSetIterator,
                                               DataSet, MnistDataSetIterator,
                                               NDArrayDataSetIterator)
    from deeplearning4j_tpu_torch.data.binary_records import \
        BinaryRecordWriter
    from deeplearning4j_tpu_torch.models import LeNet

    root = tempfile.mkdtemp(prefix="container-")
    det = torch.backends.cudnn.deterministic
    try:
        path = os.path.join(root, "images.d4tbin")
        t0 = time.perf_counter()
        with BinaryRecordWriter(
                path + ".tmp", [("features", (3, IMAGE, IMAGE), "uint8"),
                                ("label", (), "int32")],
                chunk_records=DV_BATCH) as w:
            for i in range(DV_IMAGES):
                w.append(pixels[i].transpose(2, 0, 1), i % 10)
        os.replace(path + ".tmp", path)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        # the divisor a 0-d tensor on the card: PyTorch divides by a
        # Python scalar as a multiplication by its reciprocal, by a tensor
        # as IEEE division, as numpy does
        d255 = torch.full((), 255.0, device=dev)
        it = AsyncDataSetIterator(
            BinaryRecordDataSetIterator(path, batch_size=DV_BATCH,
                                        num_classes=1000, raw_numpy=True),
            queue_size=DV_QUEUE, device_prefetch=True,
            feature_transform=lambda x: x.float().div_(d255), device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = train_model(dev, True, "bfloat16", "bfloat16")
        _reset_kernel_counts()
        first, r = feed_steps(model, it, DV_STEPS)
        r["fused_update_launches"] = _kernel_counts()["fused_update"]
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        del model
        torch.cuda.empty_cache()
        x0, y0 = next(iter(BinaryRecordDataSetIterator(
            path, batch_size=DV_BATCH, num_classes=1000, raw_numpy=True)))
        want = torch.from_numpy(x0.astype(np.float32) / 255)
        scaled_same = torch.equal(first.features.cpu(), want) and \
            torch.equal(first.labels.cpu(), torch.from_numpy(y0))
        # one step from the pipeline's batch against the same batch given
        # as a DataSet: the pipeline hands over exactly the data
        torch.backends.cudnn.deterministic = True
        a = train_model(dev, True, "bfloat16", "bfloat16")
        a.fit(first)
        b = train_model(dev, True, "bfloat16", "bfloat16")
        b.fit(DataSet(want.numpy(), y0))
        step_same = _same_state(a, b)
        del a, b, first
        torch.cuda.empty_cache()
        # fit(iterator, host_prefetch=4) against host_prefetch=0
        n = DV_PREFETCH_STEPS * DV_BATCH
        raw = iter(BinaryRecordDataSetIterator(path, DV_BATCH,
                                               raw_numpy=True))
        xs = np.concatenate([next(raw)[0] for _ in range(
            DV_PREFETCH_STEPS)]).astype(np.float32) / 255
        ys = np.eye(1000, dtype=np.float32)[np.arange(n) % 10]
        _reset_kernel_counts()
        nets = []
        for hp in (0, 4):
            m = train_model(dev, True, "bfloat16", "bfloat16")
            m.fit(NDArrayDataSetIterator(xs, ys, DV_BATCH), host_prefetch=hp)
            nets.append(m)
        resnet_same = _same_state(*nets)
        del nets
        torch.cuda.empty_cache()
        lenets = []
        for hp in (0, 4):
            net = LeNet().init(device=dev)
            net.conf.global_conf.fused_update = True
            net.fit(MnistDataSetIterator(128, train=True, flatten=False),
                    host_prefetch=hp)
            lenets.append(net)
        lenet_same = _same_state(*lenets)
        prefetch_launches = _kernel_counts()["fused_update"]
        lenet_steps = lenets[0]._iteration
        del lenets
    finally:
        torch.backends.cudnn.deterministic = det
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    check(all(np.isfinite(r["losses"])), f"container: losses {r['losses']}")
    check(r["fused_update_launches"] == DV_STEPS + 1, f"container: "
          f"fused_update launched {r['fused_update_launches']} times in "
          f"{DV_STEPS + 1} steps (want 1 per step)")
    check(scaled_same, "container: the card's features are not numpy's "
          "x.astype(float32) / 255 bitwise")
    check(step_same, "container: a step from the pipeline's batch differs "
          "from the same batch given as a DataSet")
    want_launches = 2 * DV_PREFETCH_STEPS + 2 * lenet_steps
    check(resnet_same and lenet_same and prefetch_launches == want_launches,
          f"host_prefetch=4 against 0: ResNet-50 bitwise {resnet_same}, "
          f"LeNet bitwise {lenet_same}; fused_update launches "
          f"{prefetch_launches} (want {want_launches})")
    r.update(container_bytes=size, write_s=write_s,
             features_bitwise=scaled_same, step_bitwise=step_same,
             host_prefetch={"resnet50_bitwise": resnet_same,
                            "lenet_bitwise": lenet_same,
                            "lenet_steps": lenet_steps,
                            "fused_update_launches": prefetch_launches})
    log(f"[container] {DV_IMAGES} images as uint8 [3, {IMAGE}, {IMAGE}] + "
        f"int32 labels, chunks of {DV_BATCH}: {size} B written in "
        f"{write_s:.2f} s (temporary name, then a rename); "
        f"BinaryRecordDataSetIterator(raw_numpy) -> AsyncDataSetIterator("
        f"queue {DV_QUEUE}, device_prefetch, uint8 -> float32 / 255 on the "
        f"card); the card's features bitwise numpy's: {scaled_same}; one "
        f"step from the pipeline's batch bitwise the same batch as a "
        f"DataSet (deterministic cuDNN): {step_same}")
    log(_dv_line("container", r, smi))
    log(f"[container] losses {r['losses']}")
    log(f"[container] fit(iterator, host_prefetch=4) bitwise "
        f"host_prefetch=0: ResNet-50 ({DV_PREFETCH_STEPS} steps of "
        f"{DV_BATCH}) {resnet_same}, LeNet (one epoch, {lenet_steps} steps) "
        f"{lenet_same}; fused_update launches {prefetch_launches}; {smi}")
    return r


class _SyncGate:
    """Puts the card in ``set_sync_debug_mode("error")`` for the steps off
    a drain boundary: ``opener`` (the first listener) lifts it before the
    telemetry listeners drain, ``closer`` (the last) sets it again."""

    def __init__(self, every: int):
        self.every = every
        self.steps = 0
        gate = self

        class Opener:
            def iteration_done(self, model, iteration, score):
                gate.steps += 1
                if gate.steps % gate.every == 0:
                    torch.cuda.set_sync_debug_mode(0)

        class Closer:
            def iteration_done(self, model, iteration, score):
                torch.cuda.set_sync_debug_mode("error")

        self.opener, self.closer = Opener(), Closer()


class _Snap:
    """Device copies (no readback) of the fused buckets and the layer
    states after given steps of a fit."""

    def __init__(self, at):
        self.at = set(at)
        self.steps = 0
        self.snaps = {}

    def iteration_done(self, model, iteration, score):
        from deeplearning4j_tpu_torch.optimize.telemetry import clone_tree

        self.steps += 1
        if self.steps in self.at:
            store = model._flat
            self.snaps[self.steps] = (
                {k: v.clone() for k, v in store.params.items()},
                {s: {k: v.clone() for k, v in d.items()}
                 for s, d in store.state.items()},
                clone_tree(model._states))


def _snaps_equal(a, b) -> bool:
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths

    pa, sa, ta = a
    pb, sb, tb = b
    return (all(torch.equal(pa[k], pb[k]) for k in pa)
            and all(torch.equal(sa[s][k], sb[s][k]) for s in sa
                    for k in sa[s])
            and all(torch.equal(get_path(ta, p), get_path(tb, p))
                    for p in leaf_paths(ta)))


def transfer_guard(net, ds, smi: str) -> dict:
    """The NaN guard on phase 26's re-headed VGG16 (frozen ranges kept
    aside in the bucket): a poisoned step leaves the bucket and the
    moments bitwise, the next step trains and the frozen ranges stay."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.optimize import NanSentinelListener

    sent = NanSentinelListener("skip", check_every_n=1)
    net.set_listeners(sent)
    bad = DataSet(ds.features.clone(), ds.labels)
    bad.features[0, 0, 0, 0] = float("nan")
    store = net._flat
    frozen = _frozen_leaves(net)
    sum_before = _checksum(frozen)
    before = ({k: v.clone() for k, v in store.params.items()},
              {s: {k: v.clone() for k, v in d.items()}
               for s, d in store.state.items()})
    net.fit(bad)
    after = (store.params, store.state)
    kept = all(torch.equal(before[0][k], after[0][k]) for k in before[0]) \
        and all(torch.equal(before[1][s][k], after[1][s][k])
                for s in before[1] for k in before[1][s])
    net.fit(ds)
    trained = not all(torch.equal(before[0][k], store.params[k])
                      for k in before[0])
    frozen_same = _checksum(_frozen_leaves(net)) == sum_before
    net.set_listeners()
    check(kept and trained and frozen_same and len(sent.events) == 1,
          f"transfer guard: poisoned step kept bitwise {kept}, next step "
          f"trained {trained}, frozen checksum kept {frozen_same}, events "
          f"{sent.events}")
    log(f"[transfer] NaN guard on the re-headed VGG16 (frozen ranges in the "
        f"bucket): the poisoned step's bucket and moments bitwise the "
        f"pre-step ones {kept}; the next step trains {trained}; frozen "
        f"checksum unchanged {frozen_same}; {smi}")
    return {"kept_bitwise": kept, "next_trains": trained,
            "frozen_unchanged": frozen_same}


def _cuda_kernels(fn) -> int:
    """Device kernels that ``fn()`` launches, counted by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("Memcpy")
               and not e.name.startswith("Memset"))


def tbptt_guard(smi: str, dev) -> dict:
    """The guard on one TextGenerationLSTM TBPTT batch with a NaN in a
    middle segment, and the launches telemetry adds per segment."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.optimize import (NanSentinelListener,
                                                   TelemetrySink)
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage

    idx, chars = text_corpus()
    vocab = len(chars)
    x, y = text_batch(idx, vocab, TEXT_BATCH, TEXT_SEQ, dev, SEED + 95)
    bad = x.clone()
    bad[0, TELE_NAN_T] = float("nan")
    net = text_generation_net(vocab, dev)
    sent = NanSentinelListener("skip", check_every_n=1)
    net.set_listeners(sent)
    _reset_kernel_counts()
    net.fit(DataSet(bad, y))
    launches = _kernel_counts()["fused_update"]
    aux = {k: v.cpu().tolist() for k, v in net._aux.items()}
    finite = bool(torch.isfinite(net.params()).all())
    segments = TEXT_SEQ // TEXT_TBPTT
    check(launches == segments and aux["skipped"] == 1 and finite
          and len(sent.events) == 1 and sent.events[0]["total"] > 0,
          f"TBPTT guard: launches {launches} (want {segments}), skipped "
          f"segments {aux['skipped']} (want 1), parameters finite {finite}, "
          f"events {sent.events}")
    xs, ys = x[:, :TELE_COUNT_T], y[:, :TELE_COUNT_T]
    net.set_listeners()
    net.fit(DataSet(xs, ys))
    plain = _cuda_kernels(lambda: net.fit(DataSet(xs, ys)))
    net.set_listeners(NanSentinelListener("skip", check_every_n=10),
                      TelemetrySink(InMemoryStatsStorage(), 10))
    net.fit(DataSet(xs, ys))
    guarded = _cuda_kernels(lambda: net.fit(DataSet(xs, ys)))
    n_seg = TELE_COUNT_T // TEXT_TBPTT
    per_seg = (guarded - plain) / n_seg
    log(f"[telemetry] TextGenerationLSTM TBPTT batch ({TEXT_BATCH} x "
        f"{TEXT_SEQ}, {segments} segments) with a NaN at t {TELE_NAN_T} "
        f"under 'skip': {aux['skipped']} segment skipped, non-finite total "
        f"{aux['nonfinite_total']}, fused_update launches {launches}, "
        f"parameters finite {finite}; device kernels per {TELE_COUNT_T}-"
        f"step batch {plain} without telemetry, {guarded} with stats and "
        f"the guard: {per_seg:.1f} more a segment; {smi}")
    return {"skipped": aux["skipped"], "launches": launches,
            "kernels_plain": plain, "kernels_guarded": guarded,
            "added_per_segment": per_seg}


def phase_telemetry(smi: str, dev) -> dict:
    """Phase 31: ResNet-50 at batch 64 with TelemetrySink and
    NanSentinelListener("skip"): the step time in turns without telemetry,
    with stats and with the guard; a NaN at step 3 skipped bitwise with no
    host synchronisation off the drain boundaries; the guard on the
    re-headed VGG16 is phase 26's, the TBPTT batch's here."""
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.optimize import (NanSentinelListener,
                                                   TelemetrySink)
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage

    torch.cuda.empty_cache()
    model = train_model(dev, True, "bfloat16", "bfloat16")
    ds = synthetic_batch(DV_BATCH, dev, SEED + 90)
    settings = {
        "off": lambda: (),
        "stats": lambda: (TelemetrySink(InMemoryStatsStorage(), 10),),
        "guard": lambda: (NanSentinelListener("skip", 10),
                          TelemetrySink(InMemoryStatsStorage(), 10))}
    ms = {k: [] for k in settings}
    for rnd in range(TELE_ROUNDS):
        for name, make in settings.items():
            model.set_listeners(*make())
            model.fit(ds)           # the first step of a setting untimed
            torch.cuda.synchronize()
            for _ in range(TELE_TIMED):
                t0 = time.perf_counter()
                model.fit(ds)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in ms.items()}
    # the gate run: one fit over TELE_STEPS batches, the third poisoned
    bad = DataSet(ds.features.clone(), ds.labels)
    bad.features[0, 0, 0, 0] = float("nan")
    storage = InMemoryStatsStorage()
    sent = NanSentinelListener("skip", check_every_n=TELE_EVERY)
    sink = TelemetrySink(storage, drain_every_n=TELE_EVERY)
    gate = _SyncGate(TELE_EVERY)
    snap = _Snap((TELE_NAN_STEP - 1, TELE_NAN_STEP, TELE_NAN_STEP + 1))
    model.set_listeners(gate.opener, snap, sent, sink, gate.closer)
    batches = [bad if s == TELE_NAN_STEP else ds
               for s in range(1, TELE_STEPS + 1)]
    it0 = model._iteration
    _reset_kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.fit(ExistingDataSetIterator(batches))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = _kernel_counts()["fused_update"]
    model.set_listeners()
    pre, post, nxt = (snap.snaps[s] for s in (
        TELE_NAN_STEP - 1, TELE_NAN_STEP, TELE_NAN_STEP + 1))
    kept = _snaps_equal(pre, post)
    trained = not all(torch.equal(post[0][k], nxt[0][k]) for k in post[0])
    skipped = dict(storage.series("skipped_updates"))
    want_skip = {it0 + s: (1.0 if s == TELE_NAN_STEP else 0.0)
                 for s in range(1, TELE_STEPS + 1)}
    check(kept, "telemetry: the poisoned step's parameters, moments or BN "
          "statistics differ from the pre-step ones")
    check(trained, "telemetry: the step after the poisoned one did not "
          "train")
    check(skipped == want_skip, f"telemetry: skipped_updates {skipped}, "
          f"want {want_skip}")
    check(launches == TELE_STEPS and len(sent.events) == 1
          and sent.events[0]["iteration"] == it0 + TELE_NAN_STEP,
          f"telemetry: launches {launches}, events {sent.events}")
    tags = storage.tags()
    result = {"step_ms": med, "step_ms_all": ms,
              "stats_overhead": med["stats"] / med["off"] - 1,
              "guard_overhead": med["guard"] / med["off"] - 1,
              "kept_bitwise": kept, "next_trains": trained,
              "skipped_updates": skipped, "fused_update_launches": launches,
              "sync_free_steps": TELE_STEPS - TELE_STEPS // TELE_EVERY,
              "series": len(tags)}
    log(f"[telemetry] ResNet-50 batch {DV_BATCH}, bf16, fused_update: step "
        f"ms median without telemetry {med['off']:.2f}, with stats "
        f"{med['stats']:.2f} ({100 * result['stats_overhead']:+.1f}%), with "
        f"stats and the NaN guard {med['guard']:.2f} "
        f"({100 * result['guard_overhead']:+.1f}%); {TELE_ROUNDS} rounds of "
        f"{TELE_TIMED} steps in turns; {smi}")
    log(f"[telemetry] NaN in step {TELE_NAN_STEP}'s features under "
        f"NanSentinelListener('skip', check_every_n={TELE_EVERY}) and "
        f"TelemetrySink(InMemoryStatsStorage, {TELE_EVERY}): parameters, "
        f"bf16 moments and BN statistics bitwise the pre-step ones {kept}; "
        f"the next step trains {trained}; skipped_updates {skipped}; "
        f"{result['sync_free_steps']} of {TELE_STEPS} steps under "
        f"set_sync_debug_mode('error') (all but the drain steps); "
        f"{len(tags)} series; fused_update launches {launches}")
    del model, ds, bad
    torch.cuda.empty_cache()
    result["tbptt"] = tbptt_guard(smi, dev)
    return result


def _sorted_auc(y: np.ndarray, s: np.ndarray) -> float:
    """The exact ROC's AUC on the host: scores sorted descending (stable),
    the curve's cumulative rates, the trapezoid rule."""
    y = y.astype(np.float64)[np.argsort(-s, kind="mergesort")]
    tpr = np.concatenate([[0.0], np.cumsum(y) / y.sum()])
    fpr = np.concatenate([[0.0], np.cumsum(1 - y) / (1 - y).sum()])
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


def phase_early_stopping(smi: str, dev, served, pixels) -> dict:
    """Phase 32: EarlyStoppingTrainer on LeNet, then the disk-trained
    ResNet-50 served over two container batches into ROCMultiClass,
    EvaluationCalibration and Evaluation."""
    import tempfile

    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.eval import (Evaluation,
                                               EvaluationCalibration,
                                               ROCMultiClass)
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.optimize.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, LocalFileModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)

    class Saver(LocalFileModelSaver):
        def save_best_model(self, model, score):
            super().save_best_model(model, score)
            self.best_params = model.params().detach().clone()

    root = tempfile.mkdtemp(prefix="earlystop-")
    try:
        net = LeNet().init(device=dev)
        net.conf.global_conf.fused_update = True
        train = MnistDataSetIterator(128, train=True, flatten=False)
        saver = Saver(root)
        cfg = (EarlyStoppingConfiguration.builder()
               .epoch_termination_conditions(
                   MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                   ScoreImprovementEpochTerminationCondition(ES_PATIENCE))
               .score_calculator(DataSetLossCalculator(MnistDataSetIterator(
                   128, train=False, flatten=False)))
               .model_saver(saver).build())
        _reset_kernel_counts()
        t0 = time.perf_counter()
        res = EarlyStoppingTrainer(cfg, net, train).fit()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _kernel_counts()["fused_update"]
        best = res.get_best_model()
        reload_same = torch.equal(best.params(), saver.best_params)
        steps = net._iteration
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    check(reload_same and res.total_epochs <= ES_MAX_EPOCHS
          and launches == steps and np.isfinite(res.best_model_score),
          f"early stopping: best model reloads bitwise {reload_same}, "
          f"epochs {res.total_epochs}, launches {launches} for {steps} "
          f"steps, best score {res.best_model_score}")
    es = {"epochs": res.total_epochs, "best_epoch": res.best_model_epoch,
          "best_score": res.best_model_score,
          "reason": res.termination_reason,
          "details": res.termination_details, "seconds": secs,
          "steps": steps, "fused_update_launches": launches,
          "best_reloads_bitwise": reload_same}
    log(f"[early-stopping] LeNet on the synthetic MNIST fallback, "
        f"MaxEpochs({ES_MAX_EPOCHS}) + ScoreImprovement(patience "
        f"{ES_PATIENCE}), DataSetLossCalculator over the test set, "
        f"LocalFileModelSaver: {res.total_epochs} epochs ({steps} steps, "
        f"{secs:.2f} s), best epoch {res.best_model_epoch} (loss "
        f"{res.best_model_score:.6f}), ended by {res.termination_reason}: "
        f"{res.termination_details}; the best model reloads bitwise "
        f"{reload_same}; fused_update launches {launches}; {smi}")
    # the disk-trained ResNet-50 served over two container batches
    set_fused(served, True)
    roc, cal, ev = ROCMultiClass(), EvaluationCalibration(), Evaluation()
    host = []
    _reset_kernel_counts()
    with torch.inference_mode():
        for b in range(EVAL_BATCHES):
            sel = np.arange(b * DV_BATCH, (b + 1) * DV_BATCH)
            x = torch.from_numpy(pixels[sel].transpose(0, 3, 1, 2)).to(dev)
            x = x.float().div_(torch.full((), 255.0, device=dev))
            y = np.eye(1000, dtype=np.float32)[sel % 10]
            out = served.output(x)[0].float()
            for m in (roc, cal, ev):
                m.eval(y, out)
            host.append((y, out.cpu().numpy()))
    bn = _kernel_counts()["bn_act"]
    y_all = np.concatenate([h[0] for h in host])
    p_all = np.concatenate([h[1] for h in host]).astype(np.float64)
    acc = float((p_all.argmax(1) == y_all.argmax(1)).mean())
    aucs = [_sorted_auc(y_all[:, c], p_all[:, c]) for c in range(10)]
    got_aucs = [roc.calculate_auc(c) for c in range(10)]
    conf = p_all.max(1)
    rb = 10
    bins = np.clip((p_all * rb).astype(np.int64), 0, rb - 1)
    ece_num = ece_den = 0.0
    for c in range(p_all.shape[1]):
        cnt = np.bincount(bins[:, c], minlength=rb)
        ps = np.bincount(bins[:, c], weights=p_all[:, c], minlength=rb)
        pos = np.bincount(bins[:, c], weights=y_all[:, c], minlength=rb)
        safe = np.maximum(cnt, 1)
        ece_num += float(np.sum(cnt * np.abs(ps / safe - pos / safe)))
        ece_den += float(cnt.sum())
    ece = ece_num / max(ece_den, 1.0)
    auc_err = max(abs(a - b) for a, b in zip(got_aucs, aucs))
    ece_err = abs(cal.expected_calibration_error() - ece)
    acc_err = abs(ev.accuracy() - acc)
    want_bn = 53 * EVAL_BATCHES
    check(bn == want_bn, f"evaluation forward: bn_act launched {bn} times, "
          f"want {want_bn} (53 per forward)")
    check(auc_err <= 1e-9 and ece_err <= 1e-9 and acc_err == 0.0,
          f"evaluation: ROC AUC off by {auc_err}, ECE by {ece_err}, "
          f"accuracy by {acc_err} from numpy on the host")
    ev_r = {"bn_act_launches": bn, "accuracy": ev.accuracy(),
            "average_auc_present_classes": float(np.mean(got_aucs)),
            "ece": cal.expected_calibration_error(), "auc_err": auc_err,
            "ece_err": ece_err, "mean_confidence": float(conf.mean())}
    log(f"[evaluation] the disk-trained ResNet-50 served (fused epilogue, "
        f"bf16) over {EVAL_BATCHES} container batches of {DV_BATCH}: "
        f"bn_act {bn} launches ({bn / EVAL_BATCHES:.0f} per forward); "
        f"accuracy {ev.accuracy():.4f}, mean AUC of the 10 present classes "
        f"{ev_r['average_auc_present_classes']:.4f} (ROCMultiClass, exact; "
        f"within {auc_err:.1e} of numpy's curve on the host), ECE "
        f"{ev_r['ece']:.6f} (within {ece_err:.1e}); {smi}")
    return {"early_stopping": es, "evaluation": ev_r}


# --- phases 33-36: ONNX and TF import, SameDiff's kernel ops ------------------

ONNX_BATCH = 32
ONNX_WARMUP, ONNX_TIMED = 3, 20
ONNX_FIT_STEPS = 5
ONNX_GATE_BATCH = 2
ONNX_GATE = 1e-4                 # of the CPU's largest |logit|
ONNX_ENC_TIMED = 20
ONNX_ENC_FIT_STEPS = 3
MHA_SHAPE = (ENC_BATCH, SEQ_LEN, BERT["hidden"], BERT["heads"])
FLASH_OP_SHAPE = (4, 12, 512, 64)
MHA_CALLS = 7                    # the checked call, a warm-up, 5 timed
MHA_TOL = {torch.float32: (0.0, FA_TOL), torch.bfloat16: (2.0 ** -8, FA_TOL)}


def _serve(sd, out: str, feed: dict, warmup: int, timed: int):
    """``sd.output`` for ``out`` ``warmup`` times, then ``timed`` times with
    a synchronise after each: the last output and the batch times in ms."""
    for _ in range(warmup):
        sd.output(feed, [out])
    torch.cuda.synchronize()
    ms, res = [], None
    for _ in range(timed):
        t0 = time.perf_counter()
        res = sd.output(feed, [out])[out]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return res, ms


def _logit_gate(card: torch.Tensor, cpu: torch.Tensor, what: str) -> dict:
    """The card's logits against the CPU's: max |card - cpu| within
    ONNX_GATE of the largest |cpu| logit."""
    scale = cpu.abs().max().item()
    err = (card.cpu() - cpu).abs().max().item()
    check(bool(torch.isfinite(card).all()) and err <= ONNX_GATE * scale,
          f"{what}: the card's logits are {err} from the CPU's (largest "
          f"|logit| {scale}, gate {ONNX_GATE} of it)")
    return {"max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale}


def _import_fine_tune(sd, n_classes: int, batch: int, lr: float):
    """The imported weights promoted, softmax cross-entropy against a
    ``labels`` placeholder, Adam(lr)."""
    from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig
    from deeplearning4j_tpu_torch.learning.updaters import Adam

    promoted = sd.convert_to_variables()
    logits = sd.get_variable(sd.onnx_outputs[0])
    sd.placeholder("labels", shape=(batch, n_classes))
    sd.loss_ops.softmax_cross_entropy(logits, sd.get_variable("labels"),
                                      name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(TrainingConfig(updater=Adam(lr),
                                          loss_name="loss"))
    return promoted


def _fit_steps(sd, batch: dict, steps: int):
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        hist = sd.fit(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(hist.final_loss())
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    return {"losses": losses, "step_ms_median": statistics.median(ms),
            "step_ms": ms, "peak_bytes": torch.cuda.max_memory_allocated()}


def phase_onnx_resnet50(smi: str, dev):
    """Phase 33: ResNet-50 (torchvision's widths, seeded weights) written as
    an ONNX model by the port's writer, imported on the card from its
    bytes, served at batch 32, held against the port on the CPU at batch
    2, and fine-tuned for 5 steps."""
    import import_fixtures as fx
    from deeplearning4j_tpu_torch.imports import import_onnx

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    params = fx.resnet50_params(SEED)
    data = fx.resnet50_onnx(params)
    write_s = time.perf_counter() - t0
    check(fx.n_params(params) == RESNET50_PARAMS,
          f"{fx.n_params(params)} parameters, want {RESNET50_PARAMS}")
    _reset_kernel_counts()
    t0 = time.perf_counter()
    sd = import_onnx(data, input_shapes={"x": (ONNX_BATCH, 3, IMAGE,
                                               IMAGE)}, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    out = sd.onnx_outputs[0]
    n_nodes = len(sd._nodes)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(ONNX_BATCH, 3, IMAGE, IMAGE, device=dev, generator=g)
    logits, ms = _serve(sd, out, {"x": x}, ONNX_WARMUP, ONNX_TIMED)
    check(tuple(logits.shape) == (ONNX_BATCH, 1000) and
          bool(torch.isfinite(logits).all()), "ResNet-50 logits")
    serve = {"images_per_s": ONNX_BATCH * len(ms) / sum(ms) * 1e3,
             "p50_ms": _percentile(ms, 0.5), "p99_ms": _percentile(ms, 0.99)}
    log(f"[onnx-resnet50] ResNet-50 ONNX model ({RESNET50_PARAMS} "
        f"parameters, {len(data)} bytes, written in {write_s:.2f} s): "
        f"imported on the card in {import_s:.2f} s, {n_nodes} graph ops; "
        f"serve float32 batch {ONNX_BATCH}: {serve['images_per_s']:.1f} "
        f"images/s, p50 {serve['p50_ms']:.2f} ms p99 {serve['p99_ms']:.2f} "
        f"ms ({ONNX_TIMED} batches after {ONNX_WARMUP}); {smi}")

    n = ONNX_GATE_BATCH
    shapes = {"x": (n, 3, IMAGE, IMAGE)}
    t0 = time.perf_counter()
    card2 = import_onnx(data, input_shapes=shapes, device=dev)
    torch.cuda.synchronize()
    import_again_s = time.perf_counter() - t0
    cpu2 = import_onnx(data, input_shapes=shapes, device="cpu")
    want = cpu2.output({"x": x[:n].cpu()}, [out])[out]
    got = card2.output({"x": x[:n]}, [out])[out]
    gate = _logit_gate(got, want, "onnx-resnet50")
    del card2, cpu2
    log(f"[onnx-resnet50] the card against the port on the CPU, batch {n}, "
        f"TF32 off: max |err| {gate['max_abs_err']:.3e} of largest |logit| "
        f"{gate['max_abs_logit']:.3f} ({gate['rel_err']:.2e}, gate "
        f"{ONNX_GATE}); the same bytes imported again on the card in "
        f"{import_again_s:.2f} s (the first import in the process pays "
        f"PyTorch's lazy set-up of the meta device's operators)")

    promoted = _import_fine_tune(sd, 1000, ONNX_BATCH, 1e-3)
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (ONNX_BATCH,), device=dev, generator=g),
        1000).float()
    fit = _fit_steps(sd, {"x": x, "labels": y}, ONNX_FIT_STEPS)
    check(fit["losses"][-1] < fit["losses"][0],
          f"ResNet-50 fine-tune loss did not fall: {fit['losses']}")
    counts = _kernel_counts()
    log(f"[onnx-resnet50] fine-tune SameDiff.fit, Adam(1e-3), batch "
        f"{ONNX_BATCH}, {len(promoted)} tensors promoted: step median "
        f"{fit['step_ms_median']:.2f} ms over {ONNX_FIT_STEPS} steps, peak "
        f"device memory {fit['peak_bytes']} B; loss {fit['losses'][0]:.5f} "
        f"-> {fit['losses'][-1]:.5f}; {smi}")
    log(f"[onnx-resnet50] kernel launches on this path: {counts}")
    seconds = time.perf_counter() - t_phase
    del sd
    torch.cuda.empty_cache()
    return {"bytes": len(data), "write_s": write_s, "import_s": import_s,
            "import_again_s": import_again_s,
            "graph_ops": n_nodes, "serve": serve, "gate": gate,
            "fit": {k: v for k, v in fit.items() if k != "step_ms"},
            "launches": counts, "seconds": seconds}, params, x, logits


def phase_onnx_encoder(smi: str, dev):
    """Phase 34: the pre-LN encoder at BERT-base's widths (12 blocks, D 768,
    12 heads, FF 3072, T 128) as an ONNX model: imported on the card,
    served at batch 32, held against the CPU at batch 2, fine-tuned 3
    steps."""
    import import_fixtures as fx
    from deeplearning4j_tpu_torch.imports import import_onnx

    t_phase = time.perf_counter()
    e = fx.ENCODER
    t0 = time.perf_counter()
    params = fx.encoder_params(SEED)
    data = fx.encoder_onnx(params)
    write_s = time.perf_counter() - t0
    n_params = fx.n_params(params)
    del params
    _reset_kernel_counts()
    shape = (ONNX_BATCH, e["t"], e["d"])
    t0 = time.perf_counter()
    sd = import_onnx(data, input_shapes={"x": shape}, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    out = sd.onnx_outputs[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(*shape, device=dev, generator=g)
    logits, ms = _serve(sd, out, {"x": x}, ONNX_WARMUP, ONNX_ENC_TIMED)
    check(tuple(logits.shape) == (ONNX_BATCH, e["classes"]) and
          bool(torch.isfinite(logits).all()), "encoder logits")
    serve = {"sequences_per_s": ONNX_BATCH * len(ms) / sum(ms) * 1e3,
             "p50_ms": _percentile(ms, 0.5), "p99_ms": _percentile(ms, 0.99)}
    log(f"[onnx-encoder] pre-LN encoder ONNX model ({e['blocks']} blocks, D "
        f"{e['d']}, {e['heads']} heads, FF {e['ff']}, T {e['t']}; "
        f"{n_params} parameters, {len(data)} bytes, written in "
        f"{write_s:.2f} s): imported on the card in {import_s:.2f} s, "
        f"{len(sd._nodes)} graph ops; serve float32 batch {ONNX_BATCH}: "
        f"{serve['sequences_per_s']:.1f} sequences/s, p50 "
        f"{serve['p50_ms']:.2f} ms p99 {serve['p99_ms']:.2f} ms "
        f"({ONNX_ENC_TIMED} batches after {ONNX_WARMUP}); {smi}")

    n = ONNX_GATE_BATCH
    shapes = {"x": (n, e["t"], e["d"])}
    card2 = import_onnx(data, input_shapes=shapes, device=dev)
    cpu2 = import_onnx(data, input_shapes=shapes, device="cpu")
    del data
    want = cpu2.output({"x": x[:n].cpu()}, [out])[out]
    got = card2.output({"x": x[:n]}, [out])[out]
    gate = _logit_gate(got, want, "onnx-encoder")
    del card2, cpu2
    log(f"[onnx-encoder] the card against the port on the CPU, batch {n}, "
        f"TF32 off: max |err| {gate['max_abs_err']:.3e} of largest |logit| "
        f"{gate['max_abs_logit']:.4f} ({gate['rel_err']:.2e}, gate "
        f"{ONNX_GATE})")

    _import_fine_tune(sd, e["classes"], ONNX_BATCH, ENC_TRAIN_LR)
    y = torch.nn.functional.one_hot(torch.randint(
        0, e["classes"], (ONNX_BATCH,), device=dev, generator=g),
        e["classes"]).float()
    fit = _fit_steps(sd, {"x": x, "labels": y}, ONNX_ENC_FIT_STEPS)
    counts = _kernel_counts()
    log(f"[onnx-encoder] fine-tune SameDiff.fit, Adam({ENC_TRAIN_LR}), batch "
        f"{ONNX_BATCH}: step median {fit['step_ms_median']:.2f} ms over "
        f"{ONNX_ENC_FIT_STEPS} steps, peak device memory "
        f"{fit['peak_bytes']} B; losses {fit['losses']}; {smi}")
    log(f"[onnx-encoder] kernel launches on this path: {counts}")
    seconds = time.perf_counter() - t_phase
    del sd
    torch.cuda.empty_cache()
    return {"parameters": n_params, "import_s": import_s, "serve": serve,
            "gate": gate, "write_s": write_s,
            "fit": {k: v for k, v in fit.items() if k != "step_ms"},
            "launches": counts, "seconds": seconds}


def phase_tf_resnet50(smi: str, dev, params, x, onnx_logits):
    """Phase 35: phase 33's weights as a frozen NHWC GraphDef (Conv2D,
    FusedBatchNormV3, Relu, MaxPool, Pad, AddV2, Mean, MatMul, BiasAdd),
    imported by import_frozen_tf on the card; its logits against the ONNX
    import's on the same images."""
    import import_fixtures as fx
    from deeplearning4j_tpu_torch.imports import import_frozen_tf

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = fx.resnet50_graphdef(params, batch=ONNX_BATCH)
    write_s = time.perf_counter() - t0
    _reset_kernel_counts()
    t0 = time.perf_counter()
    sd = import_frozen_tf(data, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    ops = sorted({n.op_name for n in sd._nodes})
    out = sd.tf_outputs[0]
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    logits, ms = _serve(sd, out, {"x": nhwc}, 1, 5)
    gate = _logit_gate(logits, onnx_logits.cpu(), "tf-resnet50")
    counts = _kernel_counts()
    log(f"[tf-resnet50] ResNet-50 frozen NHWC GraphDef ({len(data)} bytes, "
        f"written in {write_s:.2f} s): imported on the card in "
        f"{import_s:.2f} s as {len(sd._nodes)} graph ops ({', '.join(ops)}); "
        f"forward batch {ONNX_BATCH} p50 {_percentile(ms, 0.5):.2f} ms; "
        f"against the ONNX import's logits: max |err| "
        f"{gate['max_abs_err']:.3e} of {gate['max_abs_logit']:.3f} "
        f"({gate['rel_err']:.2e}, gate {ONNX_GATE}); kernel launches "
        f"{counts}; {smi}")
    del sd
    torch.cuda.empty_cache()
    return {"bytes": len(data), "write_s": write_s, "import_s": import_s,
            "graph_ops": ops, "p50_ms": _percentile(ms, 0.5), "gate": gate,
            "launches": counts, "seconds": time.perf_counter() - t_phase}


def _mha_case(dev, dtype, g):
    """SameDiff's multi_head_dot_product_attention at MHA_SHAPE with a
    padding mask, self-attention of one input; wo is the identity, so the
    output is the attention itself. The graph, its output, the input and
    the dense float32 answer on the same bf16 or float32 projections."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.ops.nn import dot_product_attention

    B, T, d, heads = MHA_SHAPE
    sd = SameDiff(dev)
    xv = sd.placeholder("x", shape=(B, T, d), dtype=str(dtype)[6:])
    ws = [(torch.randn(d, d, device=dev, generator=g) / d ** 0.5).to(dtype)
          for _ in range(3)]
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=g)
    mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    out = sd.nn.multi_head_dot_product_attention(
        xv, xv, xv, *(sd.constant(f"w{i}", w) for i, w in enumerate(ws)),
        sd.constant("wo", torch.eye(d, dtype=dtype, device=dev)),
        sd.constant("mask", mask), num_heads=heads, name="mha")
    x = torch.randn(B, T, d, device=dev, generator=g).to(dtype)
    qkv = [(x @ w).reshape(B, T, heads, -1).permute(0, 2, 1, 3).float()
           for w in ws]
    want = dot_product_attention(*qkv, mask.reshape(B, 1, 1, T))
    return sd, out.name, x, want.permute(0, 2, 1, 3).reshape(B, T, d)


def phase_samediff_kernels(smi: str, dev):
    """Phase 36: the registry ops that reach a kernel, driven through
    SameDiff on the card: multi_head_dot_product_attention (bf16 and
    float32: exactly one flash_attention launch per call, on the named
    route, against the dense path in float32), the flash_attention op
    (causal) against its plain version, and the embedding_bag op (one
    launch, bitwise its plain version)."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import attention, embeddings

    prof = OpProfiler.get()
    g = torch.Generator(device=dev).manual_seed(SEED + 36)
    res = {"launches": {}}
    _reset_kernel_counts()
    for dtype, route in ((torch.bfloat16, "flash_bf16"),
                         (torch.float32, "flash_f32")):
        sd, out, x, want = _mha_case(dev, dtype, g)
        before = (attention.flash_attention_launches,
                  prof.counter_value(f"attention/{route}"))
        got = sd.output({"x": x}, [out])[out].float()
        torch.cuda.synchronize()
        n = attention.flash_attention_launches - before[0]
        n_route = prof.counter_value(f"attention/{route}") - before[1]
        rel, ab = MHA_TOL[dtype]
        err = (got - want).abs()
        worst = (err - rel * want.abs()).max().item()
        check(n == 1 and n_route == 1,
              f"SameDiff MHA {dtype}: {n} flash launches, {n_route} on "
              f"{route}; want exactly 1")
        check(worst <= ab, f"SameDiff MHA {dtype}: |err| exceeds "
              f"{rel} |want| + {ab} by {worst - ab}")
        _, ms = _serve(sd, out, {"x": x}, 1, MHA_CALLS - 2)
        key = "mha_" + ("bf16" if dtype == torch.bfloat16 else "f32")
        res[key] = {"shape": list(MHA_SHAPE), "max_abs_err":
                    err.max().item(), "launches_per_call": n,
                    "route": route, "output_ms_p50": _percentile(ms, 0.5)}
        log(f"[samediff-kernels] sd.nn.multi_head_dot_product_attention "
            f"{str(dtype)[6:]} [B {MHA_SHAPE[0]}, T {MHA_SHAPE[1]}, D "
            f"{MHA_SHAPE[2]}], {MHA_SHAPE[3]} heads, padding mask: {n} "
            f"flash_attention launch on attention/{route}; max |err| "
            f"{err.max().item():.3e} against the dense path in float32 "
            f"(gate {rel} |want| + {ab}); sd.output p50 "
            f"{_percentile(ms, 0.5):.3f} ms; {smi}")
        del sd

    q, k, v = (torch.randn(*FLASH_OP_SHAPE, device=dev, generator=g)
               for _ in range(3))
    sd = SameDiff(dev)
    fo = sd.nn.flash_attention(*(sd.constant(nm, t) for nm, t in
                                 zip("qkv", (q, k, v))), causal=True)
    before = attention.flash_attention_launches
    got = sd.output({}, [fo.name])[fo.name]
    n = attention.flash_attention_launches - before
    want = attention.flash_attention_reference(
        q, k, v, FLASH_OP_SHAPE[3] ** -0.5, True, None, attention.TILE)
    err = (got - want).abs().max().item()
    check(n == 1 and err <= FA_TOL, f"flash_attention op: {n} launches, "
          f"max |err| {err} (gate {FA_TOL})")
    res["flash_op"] = {"shape": list(FLASH_OP_SHAPE), "causal": True,
                       "launches_per_call": n, "max_abs_err": err}
    log(f"[samediff-kernels] sd.nn.flash_attention causal float32 "
        f"{list(FLASH_OP_SHAPE)}: {n} launch; max |err| {err:.3e} against "
        f"the plain version (gate {FA_TOL}); {smi}")

    B, W, V, D = BAG_PATH
    table = torch.randn(V, D, device=dev, generator=g)
    idx = torch.randint(0, V, (B, W), device=dev, generator=g,
                        dtype=torch.int32)
    mask = (torch.rand(B, W, device=dev, generator=g) < 0.9).float()
    sd = SameDiff(dev)
    bo = sd.nn.embedding_bag(sd.constant("table", table),
                             sd.constant("idx", idx),
                             sd.constant("mask", mask), mode="mean")
    before = embeddings.embedding_bag_launches
    got = sd.output({}, [bo.name])[bo.name]
    n = embeddings.embedding_bag_launches - before
    counts = mask.sum(1, keepdim=True).clamp_min(1.0)
    want = embeddings.embedding_bag_reference(table, idx, mask, counts, True)
    same = bool(torch.equal(got, want))
    check(n == 1 and same, f"embedding_bag op: {n} launches, bitwise "
          f"{same}")
    res["embedding_bag_op"] = {"shape": [B, W, V, D], "launches_per_call": n,
                               "bitwise": same}
    log(f"[samediff-kernels] sd.nn.embedding_bag mean [{B}, {W}] bags of a "
        f"[{V}, {D}] table: {n} launch, bitwise the plain version {same}; "
        f"{smi}")
    res["launches"] = _kernel_counts()
    check(res["launches"]["flash_attention"] == 2 * MHA_CALLS + 1 and
          res["launches"]["embedding_bag"] == 1,
          f"phase 36's kernel launches {res['launches']}")
    log(f"[samediff-kernels] kernel launches on this path: "
        f"{res['launches']}")
    torch.cuda.empty_cache()
    return res


# --- phases 37-39: Keras import, SameDiff control flow and random ops --------------------

KERAS_BATCH = 32
KERAS_WARMUP, KERAS_TIMED = 3, 20
KERAS_FIT_STEPS = 5
KERAS_RESNET50_VALUES = 25_636_712
KERAS_LSTM_BATCH = 128
RANDOM_DRAWS = 1 << 20
CONTROL_STEPS = 5


def _fit_net(net, ds, steps: int) -> dict:
    """``steps`` fits of one batch, each ended by a synchronise."""
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(net.score_value))
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    return {"losses": losses, "step_ms_median": statistics.median(ms),
            "step_ms": ms, "peak_bytes": torch.cuda.max_memory_allocated()}


def phase_keras_resnet50(smi: str, dev):
    """Phase 37: Keras ResNet-50 from a legacy .h5 through the port's HDF5
    reader and KerasModelImport, served with bn_act and fine-tuned with
    fused_update."""
    import tempfile

    import import_fixtures as fx
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.imports import KerasModelImport
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.ops import epilogue

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = fx.keras_resnet50_h5(SEED)
    write_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50.h5")
        with open(path, "wb") as fh:
            fh.write(data)
        t0 = time.perf_counter()
        net = KerasModelImport.import_keras_model_and_weights(path,
                                                              device=dev)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = KerasModelImport.import_keras_model_and_weights(path,
                                                                device=dev)
        torch.cuda.synchronize()
        import_again_s = time.perf_counter() - t0
        del again
        cpu = KerasModelImport.import_keras_model_and_weights(path,
                                                              device="cpu")
    values = net.num_params() + sum(int(t.numel()) for st in
                                    net._states.values()
                                    for t in st.values())
    check(values == KERAS_RESNET50_VALUES,
          f"{values} imported values, want {KERAS_RESNET50_VALUES}")
    bns = [n for n in net.conf.order if net.conf.nodes[n].kind == "layer"
           and isinstance(net.conf.nodes[n].layer, L.BatchNormalization)]
    check(len(bns) == 53 and all(net.conf.nodes[n].layer.eps ==
                                 fx.KERAS_BN_EPS for n in bns),
          f"{len(bns)} BatchNormalization layers or an epsilon that is not "
          f"Keras's {fx.KERAS_BN_EPS}")
    set_fused_epilogue(net, True)
    tails = len(net._epilogue_fusion_plan()["act"])
    check(tails == 16, f"the fusion plan collapses {tails} block tails, "
          f"want 16")
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    x = torch.randn(KERAS_BATCH, IMAGE, IMAGE, 3, device=dev, generator=g)
    for _ in range(KERAS_WARMUP):
        net.output(x)
    torch.cuda.synchronize()
    _reset_kernel_counts()
    ms = []
    for _ in range(KERAS_TIMED):
        t0 = time.perf_counter()
        probs = net.output(x)[0]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = _kernel_counts()
    per_forward = counts["bn_act"] / KERAS_TIMED
    residual = epilogue.bn_act_residual_launches / KERAS_TIMED
    check(per_forward == len(bns) and counts["fused_update"] == 0,
          f"bn_act launched {counts['bn_act']} times in {KERAS_TIMED} "
          f"forwards, want {len(bns)} each")
    check(residual == tails, f"bn_act added a residual "
          f"{epilogue.bn_act_residual_launches} times in {KERAS_TIMED} "
          f"forwards, want {tails} each")
    check(tuple(probs.shape) == (KERAS_BATCH, 1000)
          and bool(torch.isfinite(probs).all()), "Keras ResNet-50 outputs")
    serve = {"images_per_s": KERAS_BATCH * len(ms) / sum(ms) * 1e3,
             "p50_ms": _percentile(ms, 0.5), "p99_ms": _percentile(ms, 0.99),
             "bn_act_launches_per_forward": per_forward,
             "residual_launches_per_forward": residual}
    log(f"[keras-resnet50] Keras ResNet-50 legacy .h5 ({len(data)} bytes, "
        f"{values} values, written in {write_s:.2f} s): imported through "
        f"the port's HDF5 reader onto the card in {import_s:.2f} s (again "
        f"in {import_again_s:.2f} s); serve float32 batch {KERAS_BATCH}, "
        f"fused epilogue: {serve['images_per_s']:.1f} images/s, p50 "
        f"{serve['p50_ms']:.2f} ms p99 {serve['p99_ms']:.2f} ms "
        f"({KERAS_TIMED} batches after {KERAS_WARMUP}); bn_act "
        f"{per_forward:.0f} launches per forward ({residual:.0f} of them "
        f"block tails with the residual); {smi}")

    n = ONNX_GATE_BATCH
    gate = _logit_gate(net.output(x[:n])[0], cpu.output(x[:n].cpu())[0],
                       "keras-resnet50")
    del cpu
    set_fused_epilogue(net, False)
    dense = net.output(x)[0]
    set_fused_epilogue(net, True)
    fused_err = (probs - dense).abs().max().item()
    check(fused_err <= ONNX_GATE * dense.abs().max().item(),
          f"fused against unfused on the card: {fused_err}")
    log(f"[keras-resnet50] the card against the port on the CPU, batch {n}, "
        f"TF32 off: max |err| {gate['max_abs_err']:.3e} of largest output "
        f"{gate['max_abs_logit']:.4f} ({gate['rel_err']:.2e}, gate "
        f"{ONNX_GATE}); fused against unfused epilogue on the card, batch "
        f"{KERAS_BATCH}: max |err| {fused_err:.3e}")

    net.conf.global_conf.updater = Nesterovs(learning_rate=1e-3,
                                             momentum=0.9)
    net.conf.global_conf.fused_update = True
    y = torch.nn.functional.one_hot(torch.randint(
        0, 1000, (KERAS_BATCH,), device=dev, generator=g), 1000).float()
    _reset_kernel_counts()
    fit = _fit_net(net, DataSet(x, y), KERAS_FIT_STEPS)
    fcounts = _kernel_counts()
    check(fcounts["fused_update"] == KERAS_FIT_STEPS,
          f"fused_update launched {fcounts['fused_update']} times in "
          f"{KERAS_FIT_STEPS} steps")
    log(f"[keras-resnet50] fine-tune ComputationGraph.fit, Nesterovs(1e-3, "
        f"0.9), fused_update, batch {KERAS_BATCH}, {net.num_params()} "
        f"trainable: step median {fit['step_ms_median']:.2f} ms over "
        f"{KERAS_FIT_STEPS} steps, peak device memory {fit['peak_bytes']} "
        f"B; losses {fit['losses']}; kernel launches {fcounts}; {smi}")
    seconds = time.perf_counter() - t_phase
    del net
    torch.cuda.empty_cache()
    return {"bytes": len(data), "values": values, "write_s": write_s,
            "import_s": import_s, "import_again_s": import_again_s,
            "serve": serve, "gate": gate, "fused_max_abs_err": fused_err,
            "fit": {k: v for k, v in fit.items() if k != "step_ms"},
            "bn_act_launches": counts["bn_act"],
            "fused_update_launches": fcounts["fused_update"],
            "seconds": seconds}


def phase_keras_lstm(smi: str, dev) -> dict:
    """Phase 38: keras-io's character LSTM as a .keras zip, imported into a
    MultiLayerNetwork on the card and trained with fused_update."""
    import tempfile

    import import_fixtures as fx
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.imports import KerasModelImport
    from deeplearning4j_tpu_torch.learning.updaters import Adam

    t_phase = time.perf_counter()
    idx, chars = text_corpus()
    vocab, maxlen = len(chars), fx.CHAR_LSTM["maxlen"]
    data = fx.keras_char_lstm(vocab, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "char_lstm.keras")
        with open(path, "wb") as fh:
            fh.write(data)
        t0 = time.perf_counter()
        net = KerasModelImport.import_keras_sequential_model_and_weights(
            path, device=dev)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        cpu = KerasModelImport.import_keras_sequential_model_and_weights(
            path, device="cpu")
    check(type(net.layers[0]).__name__ == "LastTimeStep",
          f"LSTM(128) imported as {type(net.layers[0]).__name__}")
    rng = np.random.default_rng(SEED + 38)
    starts = rng.integers(0, len(idx) - maxlen - 1, KERAS_LSTM_BATCH)
    win = np.stack([idx[s:s + maxlen + 1] for s in starts])
    eye = np.eye(vocab, dtype=np.float32)
    x = torch.from_numpy(eye[win[:, :maxlen]]).to(dev)
    y = torch.from_numpy(eye[win[:, maxlen]]).to(dev)
    gate = _logit_gate(net.output(x), cpu.output(x.cpu()), "keras-lstm")
    del cpu
    net.conf.global_conf.updater = Adam(learning_rate=2e-3)
    net.conf.global_conf.fused_update = True
    ds = DataSet(x, y)
    before = net.score(ds)
    _reset_kernel_counts()
    fit = _fit_net(net, ds, KERAS_FIT_STEPS)
    counts = _kernel_counts()
    check(counts["fused_update"] == KERAS_FIT_STEPS,
          f"fused_update launched {counts['fused_update']} times in "
          f"{KERAS_FIT_STEPS} steps")
    after = net.score(ds)
    check(after < before, f"the LSTM's loss did not fall: {before} -> "
          f"{after}")
    log(f"[keras-lstm] keras-io's character LSTM (.keras zip, {len(data)} "
        f"bytes; V {vocab}, {net.num_params()} parameters) imported onto "
        f"the card in {import_s:.2f} s; the card against the CPU, batch "
        f"{KERAS_LSTM_BATCH}: max |err| {gate['max_abs_err']:.3e} of "
        f"largest output {gate['max_abs_logit']:.4f}; Adam(2e-3) "
        f"fused_update: step median {fit['step_ms_median']:.2f} ms over "
        f"{KERAS_FIT_STEPS} steps, loss {before:.5f} -> {after:.5f}, "
        f"peak device memory {fit['peak_bytes']} B; kernel launches "
        f"{counts}; {smi}")
    seconds = time.perf_counter() - t_phase
    del net
    torch.cuda.empty_cache()
    return {"vocab": vocab, "bytes": len(data), "import_s": import_s,
            "gate": gate, "loss": [before, after],
            "fit": {k: v for k, v in fit.items() if k != "step_ms"},
            "fused_update_launches": counts["fused_update"],
            "seconds": seconds}


def control_graph(device, dtype: str = "float64"):
    """A SameDiff graph with a cond and a bounded while_loop: h = x @ w;
    cond(sum(h) > 0, tanh(h), 0.5 * relu(h)); then v <- tanh(v @ u) + 0.5 v
    while c < 5, bounded at 8 iterations; the head's squared error.
    Variables seeded from numpy, Adam(1e-2)."""
    from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff,
                                                            TrainingConfig)
    from deeplearning4j_tpu_torch.learning.updaters import Adam

    rng = np.random.RandomState(SEED)
    sd = SameDiff(device=device)
    x = sd.placeholder("x", dtype=dtype)
    y = sd.placeholder("y", dtype=dtype)
    w = sd.var("w", init=rng.normal(0, 0.3, (16, 32)).astype(dtype))
    u = sd.var("u", init=rng.normal(0, 0.2, (32, 32)).astype(dtype))
    head = sd.var("head", init=rng.normal(0, 0.2, (32, 4)).astype(dtype))
    h = x.mmul(w)
    a = sd.cond(sd.math.greater(h.sum(), 0.0),
                lambda s, v: s.math.tanh(v),
                lambda s, v: s.math.multiply(s.math.relu(v), 0.5), h)
    zero = sd.constant("zero", np.zeros((), dtype))
    v_fin, _, _ = sd.while_loop(
        lambda s, v, c, uu: s.math.less(c, 5.0),
        lambda s, v, c, uu: (s.math.add(s.math.tanh(v.mmul(uu)),
                                        s.math.multiply(v, 0.5)),
                             s.math.add(c, 1.0), s.math.identity(uu)),
        a, zero, u, max_iters=8)
    sd.math.square(v_fin.mmul(head) - y).mean().rename("loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(TrainingConfig(updater=Adam(1e-2),
                                          loss_name="loss"))
    return sd


def _moments(name: str):
    """(mean, variance, fourth central moment) of each random case."""
    from math import erf, exp, pi, sqrt

    def raw4(m1, m2, m3, m4):
        return m4 - 4 * m3 * m1 + 6 * m2 * m1 ** 2 - 3 * m1 ** 4

    if name == "random_uniform":            # U(-1, 2)
        return 0.5, 9 / 12, 81 / 80
    if name == "random_normal":             # N(1, 2^2)
        return 1.0, 4.0, 48.0
    if name == "random_truncated_normal":   # N(0, 1) cut at +-2, then x3
        phi, z = exp(-2.0) / sqrt(2 * pi), erf(2 / sqrt(2))
        v = 1 - 4 * phi / z
        m4 = 3 - 2 * phi * (8 + 6) / z
        return 0.0, 9 * v, 81 * m4
    if name == "random_lognormal":          # exp(N(0, 0.5^2))
        m = [exp(k * k * 0.25 / 2) for k in range(1, 5)]
        return m[0], m[1] - m[0] ** 2, raw4(*m)
    if name == "random_bernoulli":          # p 0.3
        p = 0.3
        return p, p * (1 - p), p * (1 - p) * (1 - 3 * p + 3 * p * p)
    if name == "random_binomial":           # 5 trials, p 0.3
        n, p = 5, 0.3
        v = n * p * (1 - p)
        return n * p, v, v * (1 + 3 * (n - 2) * p * (1 - p))
    if name == "random_exponential":        # lam 2
        return 0.5, 0.25, 9 / 16
    if name == "random_gamma":              # alpha 2.5, rate 2
        a, b = 2.5, 2.0
        v = a / b ** 2
        return a / b, v, (3 + 6 / a) * v * v
    if name == "random_poisson":            # lam 3
        return 3.0, 3.0, 3.0 * (1 + 3 * 3.0)
    raise KeyError(name)


def _six_se(x: torch.Tensor, name: str) -> dict:
    m, v, mu4 = _moments(name)
    n = x.numel()
    xd = x.to(torch.float64)
    mean, var = xd.mean().item(), xd.var(correction=0).item()
    ok = (abs(mean - m) < 6 * (v / n) ** 0.5
          and abs(var - v) < 6 * ((mu4 - v * v) / n) ** 0.5)
    check(ok, f"{name}: mean {mean} variance {var}, want {m} and {v} within "
          f"6 standard errors")
    return {"mean": mean, "var": var, "want_mean": m, "want_var": v}


def random_cases(sd, n: int):
    """{name: (node, check)} of the 13 random ops on ``sd``."""
    side = int(n ** 0.5)
    shape = (side, n // side)
    logits = np.log(np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1],
                              [0.25, 0.25, 0.25, 0.25], [0.5, 0.5, 1e-9,
                                                          1e-9]]))
    ops = sd.random_ops
    cases = {
        "random_uniform": ops.random_uniform(shape, low=-1.0, high=2.0),
        "random_normal": ops.random_normal(shape, mean=1.0, stddev=2.0),
        "random_truncated_normal": ops.random_truncated_normal(
            shape, stddev=3.0),
        "random_lognormal": ops.random_lognormal(shape, stddev=0.5),
        "random_bernoulli": ops.random_bernoulli(shape, p=0.3),
        "random_binomial": ops.random_binomial(shape, 5, 0.3),
        "random_exponential": ops.random_exponential(shape, lam=2.0),
        "random_gamma": ops.random_gamma(shape, 2.5, beta=2.0),
        "random_poisson": ops.random_poisson(shape, 3.0),
        "random_multinomial": ops.random_multinomial(
            sd.constant("logits", logits.astype(np.float32)), n // 4),
        "random_shuffle": ops.random_shuffle(
            sd.constant("seq", np.arange(n, dtype=np.float32)
                        .reshape(shape)), axis=1),
        "random_crop": ops.random_crop(
            sd.constant("img", np.arange(64 * 64, dtype=np.float32)
                        .reshape(64, 64)), (16, 24)),
        "dropout_bp": ops.dropout_bp(
            sd.constant("ones", np.ones(shape, np.float32)), 0.25),
    }
    return cases, shape, logits


def phase_samediff_control_random(smi: str, dev) -> dict:
    """Phase 39: SameDiff cond and while_loop trained on the card against
    the CPU; an unbounded while_loop; the 13 random ops on the card; an
    NDArray view write on the card."""
    from deeplearning4j_tpu_torch import factory
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 39)
    batches = [{"x": rng.normal(0, 1, (64, 16)),
                "y": rng.normal(0, 1, (64, 4))} for _ in range(CONTROL_STEPS)]
    card, host = control_graph(dev), control_graph("cpu")
    t0 = time.perf_counter()
    lc = [card.fit(b).final_loss() for b in batches]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    lh = [host.fit(b).final_loss() for b in batches]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    var_err = max((card._vars[n].value.cpu() - host._vars[n].value)
                  .abs().max().item() / host._vars[n].value.abs().max()
                  .item() for n in card.variables())
    check(loss_err <= 1e-9 and var_err <= 1e-9 and all(np.isfinite(lc)),
          f"control-flow graph: the card's losses {lc} against the CPU's "
          f"{lh} ({loss_err}), variables {var_err}")
    ub = SameDiff(device=dev)
    s = ub.placeholder("s", dtype="float32")
    looped = ub.while_loop(lambda sb, v: sb.math.less(v, 10.0),
                           lambda sb, v: sb.math.add(v, 3.0), s)
    got = float(looped.eval({"s": np.array(0.0, np.float32)}))
    check(got == 12.0, f"unbounded while_loop gave {got}, want 12")
    log(f"[samediff-control-random] cond + while_loop(max_iters=8) graph, "
        f"float64, Adam(1e-2): {CONTROL_STEPS} steps on the card in "
        f"{fit_s:.3f} s, losses {lc[0]:.6f} -> {lc[-1]:.6f}, within "
        f"{loss_err:.1e} of the CPU's, variables within {var_err:.1e}; "
        f"unbounded while_loop forward 0 -> {got}; {smi}")

    sd = SameDiff(device=dev)
    sd._device_generator = torch.Generator(device=dev).manual_seed(SEED)
    cases, shape, logits = random_cases(sd, RANDOM_DRAWS)
    t0 = time.perf_counter()
    out = sd.output({}, [v.name for v in cases.values()])
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    stats = {}
    want_dtype = {"random_poisson": torch.int32,
                  "random_multinomial": torch.int64}
    for name, var in cases.items():
        t = out[var.name]
        check(t.device.type == dev.type and t.dtype == want_dtype.get(
            name, torch.float32), f"{name}: {t.dtype} on {t.device}")
        if name in ("random_multinomial", "random_crop"):
            continue
        check(tuple(t.shape) == shape, f"{name}: shape {tuple(t.shape)}")
        if name == "random_shuffle":
            base = torch.arange(RANDOM_DRAWS, dtype=torch.float32,
                                device=dev).reshape(shape)
            check(torch.equal(torch.sort(t, dim=1).values, base),
                  "random_shuffle is not a permutation of each row")
            continue
        if name == "dropout_bp":
            zeros = (t == 0).to(torch.float64)
            check(bool(((t == 0) | (t == 1.0 / 0.75)).all()),
                  "dropout_bp values")
            stats[name] = {"zero_share": zeros.mean().item()}
            p, n = 0.25, zeros.numel()
            check(abs(zeros.mean().item() - p) < 6 * (p * (1 - p) / n)
                  ** 0.5, f"dropout_bp zero share {zeros.mean().item()}")
            continue
        if name == "random_truncated_normal":
            check(bool((t.abs() < 6.0).all()), "truncated normal bounds")
        stats[name] = _six_se(t, name)
    m = out[cases["random_multinomial"].name]
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    counts = torch.stack([(m == c).sum(dim=1) for c in range(4)], 1).cpu()
    k = m.shape[1]
    for i in range(4):
        for c in range(4):
            p = probs[i, c]
            se = (p * (1 - p) / k) ** 0.5
            check(abs(counts[i, c].item() / k - p) < 6 * se + 1e-12,
                  f"multinomial row {i} class {c}: {counts[i, c].item() / k}"
                  f" against {p}")
    crop = out[cases["random_crop"].name]
    r0, c0 = divmod(int(crop[0, 0].item()), 64)
    want = torch.arange(64 * 64, dtype=torch.float32,
                        device=dev).reshape(64, 64)[r0:r0 + 16, c0:c0 + 24]
    check(torch.equal(crop, want), "random_crop is not a window")
    stats["random_multinomial"] = {"rows": 4, "samples_per_row": k}
    log(f"[samediff-control-random] the 13 random ops through SameDiff on "
        f"the card, {RANDOM_DRAWS} draws each, in {draw_s:.3f} s: "
        + "; ".join(f"{n} mean {v['mean']:.5f} var {v['var']:.5f}"
                    for n, v in stats.items() if "mean" in v)
        + f"; dropout_bp zero share {stats['dropout_bp']['zero_share']:.5f}"
        f"; multinomial rows within 6 standard errors of their logits; "
        f"{smi}")

    a = factory.create(np.zeros((4, 4), np.float32), device=dev)
    a[1].addi(5.0)
    a[2][1:3].assign(7.0)
    row = a.to_numpy()
    check(a.device.type == dev.type and (row[1] == 5).all()
          and row[2, 1] == row[2, 2] == 7 and row.sum() == 34,
          f"NDArray view writes on the card: {row}")
    log("[samediff-control-random] NDArray view writes on the card reach "
        "their base")
    return {"control": {"losses_card": lc, "losses_cpu": lh,
                        "loss_rel_err": loss_err, "var_rel_err": var_err,
                        "fit_s": fit_s, "unbounded": got},
            "random": stats, "draw_s": draw_s,
            "seconds": time.perf_counter() - t_phase}


# --- phases 40-42: ParallelWrapper ---------------------------------------------

PW_WORKERS = 4
PW_BATCH = 64                 # bench.py's bench_zero1_smoke: 16 per replica
PW_PARITY_STEPS = 5
PW_WARMUP = 2
PW_TIMED_STEPS = 10
PW_CPU_BATCH = 8
PW_CPU_STEPS = 2
LENET_PW_BATCH = 64           # bench.py's bench_elastic_smoke
LENET_PW_STEPS = 8            # batches per epoch


class _Losses:
    """The loss of every step as a float (a wait for the card each)."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, score):
        self.losses.append(float(score))


class _Interrupt(RuntimeError):
    pass


class _At:
    """Calls ``fn(model)`` after iteration ``at``."""

    def __init__(self, at: int, fn):
        self.at = at
        self.fn = fn

    def iteration_done(self, model, iteration, score):
        if iteration == self.at:
            self.fn(model)


def _interrupt(model):
    raise _Interrupt(f"stopped after iteration {model._iteration}")


def pw_wrapper(model, dev, acc=None, workers: int = PW_WORKERS):
    """ParallelWrapper with ``workers`` replicas all on ``dev``."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    b = ParallelWrapper.Builder(model).workers(workers).devices(
        [dev] * workers)
    if acc is not None:
        b.gradients_accumulator(acc)
    return b.build()


def _bytes(tree) -> int:
    from deeplearning4j_tpu_torch.util.model_serializer import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def replica_fps(pw, with_updater: bool) -> list:
    """Each replica's digest of its parameters (and updater state)."""
    from deeplearning4j_tpu_torch.common.integrity import (combine_fp,
                                                           fingerprint_tree)

    out = []
    for r in range(pw.workers_count):
        f = fingerprint_tree(pw.replica_params(r))
        if with_updater:
            f = combine_fp(f, fingerprint_tree(pw.replica_updater_state(r)))
        out.append(int(f))
    return out


def shard_variants(pw) -> list:
    """Which variant of fused_update each replica's launch takes: the
    kernel's own alignment rule on the parameter slice it is given (the
    gradient, moment and bit buffers are fresh allocations)."""
    from deeplearning4j_tpu_torch.ops import update

    plan = pw._plan
    out = []
    for r, rep in enumerate(pw._reps):
        p = rep.store.params["flat::float32"]
        if pw.accumulator.zero1:
            p = plan.shard_slice(rep.store.params, r)["flat::float32"]
        fresh = torch.empty(p.numel(), dtype=torch.float32, device=p.device)
        head, vec = update._alignment(p, [fresh])
        out.append({"elements": p.numel(), "offset_bytes":
                    p.data_ptr() - rep.store.params["flat::float32"]
                    .data_ptr(), "head": head,
                    "variant": "vector" if vec else "scalar"})
    return out


def time_shard_update(dev, flush, shard: int, n_shards: int) -> dict:
    """Nesterovs with bf16 state through the kernel on the last replica's
    slice (``shard`` elements at ``(n_shards - 1) * shard`` into a bucket),
    beside the same launch on the whole bucket, the plain version and the
    bound (20 B/elem)."""
    from deeplearning4j_tpu_torch.ops import update

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 40)
    upd = _updater("nesterovs", "bfloat16")
    sc = update._scalars(upd, "nesterovs", 3)
    bucket = torch.randn(shard * n_shards, device=dev, generator=gen)
    rows = {}
    for name, p in (("shard", bucket[(n_shards - 1) * shard:]),
                    ("whole", bucket[:RESNET50_PARAMS])):
        n = p.numel()
        g = torch.randn(n, device=dev, generator=gen).mul_(0.01)
        v = torch.randn(n, device=dev, generator=gen).mul_(0.1).to(
            torch.bfloat16)
        bits = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                             device=dev, generator=gen)
        head, vec = update._alignment(p, [g, v, bits])
        rows[name] = {
            "elements": n, "head": head,
            "variant": "vector" if vec else "scalar",
            "ms": _time_ms(lambda: update.fused_update_cuda(
                "nesterovs", sc, p, g, {"v": v}, bits, torch.bfloat16),
                flush),
            "plain_ms": _time_ms(lambda: update.fused_update_reference(
                "nesterovs", sc, p, g, {"v": v}, bits, torch.bfloat16),
                flush),
            "bound_ms": 20 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    return rows


def _timed_fit(pw_or_model, ds, steps: int) -> list:
    clock = StepClock()
    pw_or_model.set_listeners(clock)
    clock.start()
    pw_or_model.fit(ds, epochs=steps)
    return clock.step_ms(), clock.losses


def phase_parallel_resnet50(smi: str, dev) -> dict:
    """Phase 40: full-size ResNet-50 trained by four replicas on the card
    (see the module docstring)."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.parallel import ReduceScatterAccumulator

    Environment.get().set_tf32(False)
    prof = OpProfiler.get()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    result = {"workers": PW_WORKERS, "batch": PW_BATCH}
    try:
        ds = synthetic_batch(PW_BATCH, dev, SEED + 40)
        # (a) float32 state: dense against ZeRO-1, 5 steps from one init
        runs = {}
        for layout in ("dense", "zero1"):
            torch.cuda.empty_cache()
            model = train_model(dev, True, "bfloat16", None)
            pw = pw_wrapper(model, dev, ReduceScatterAccumulator()
                            if layout == "zero1" else None)
            prof.reset()
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            pw._ensure_parallel_state()
            torch.cuda.synchronize()
            alloc = torch.cuda.memory_allocated() - m0
            per = [_bytes(pw.replica_updater_state(r))
                   for r in range(PW_WORKERS)]
            variants = shard_variants(pw)
            losses = _Losses()
            pw.set_listeners(losses)
            update.reset_launches()
            pw.fit(ds, epochs=PW_PARITY_STEPS)
            torch.cuda.synchronize()
            runs[layout] = {
                "losses": losses.losses,
                "launches": update.fused_update_launches,
                "alloc_bytes": alloc, "state_bytes_per_replica": per,
                "zero1_counters": {k: v for k, v in
                                   prof.get_counters().items()
                                   if k.startswith("zero1/")},
                "collectives": prof.collective_stats(),
                "variants": variants,
                "params": {n: {k: t.clone() for k, t in d.items()}
                           for n, d in model._params.items()},
                "init_fp": None}
            pw.shutdown()
            del pw, model
        d, z = runs["dense"], runs["zero1"]
        want = PW_WORKERS * PW_PARITY_STEPS
        for layout, r in runs.items():
            check(r["launches"] == want, f"[parallel-resnet50] {layout}: "
                  f"fused_update launched {r['launches']} times in "
                  f"{PW_PARITY_STEPS} steps (want {want}: one per replica)")
            check(all(np.isfinite(r["losses"])), f"{layout} losses "
                  f"{r['losses']}")
        check(d["losses"] == z["losses"], f"ZeRO-1 losses {z['losses']} "
              f"differ from dense {d['losses']}")
        check(_same_bits(d["params"], z["params"]),
              "ZeRO-1 parameters differ from dense after 5 steps")
        dense_state, z_state = d["state_bytes_per_replica"], \
            z["state_bytes_per_replica"]
        check(len(set(z_state)) == 1 and len(set(dense_state)) == 1,
              f"uneven state: {dense_state} {z_state}")
        check(z["zero1_counters"].get("zero1/updater_state_bytes_per_replica")
              == z_state[0], f"zero1 counters {z['zero1_counters']}")
        pad = PW_WORKERS * z_state[0] - dense_state[0]
        check(0 <= pad <= 16 * PW_WORKERS * 4, f"ZeRO-1 state {z_state[0]} B "
              f"per replica is not a quarter of {dense_state[0]} B")
        saved = sum(dense_state) - sum(z_state)
        alloc_saved = d["alloc_bytes"] - z["alloc_bytes"]
        # the caching allocator counts a large tensor's whole 2 MiB-rounded
        # segment when the rest would be under 1 MiB: up to 2 MiB a replica
        check(abs(alloc_saved - saved) <= 2 * 2 ** 20 * PW_WORKERS,
              f"memory_allocated says ZeRO-1 saves {alloc_saved} B, the "
              f"state sizes say {saved} B")
        result["f32"] = {
            "losses": d["losses"], "bitwise": True,
            "launches_dense": d["launches"], "launches_zero1": z["launches"],
            "state_bytes_per_replica_dense": dense_state[0],
            "state_bytes_per_replica_zero1": z_state[0],
            "alloc_bytes_dense": d["alloc_bytes"],
            "alloc_bytes_zero1": z["alloc_bytes"],
            "collectives_dense": d["collectives"],
            "collectives_zero1": z["collectives"],
            "variants_dense": d["variants"], "variants_zero1": z["variants"]}
        log(f"[parallel-resnet50] (a) float32 Nesterovs state, {PW_WORKERS} "
            f"replicas on one card, batch {PW_BATCH}: {PW_PARITY_STEPS} "
            f"steps dense vs ZeRO-1 bitwise (losses {d['losses']}); "
            f"fused_update launches {d['launches']} / {z['launches']}; "
            f"updater state per replica {dense_state[0]} B dense, "
            f"{z_state[0]} B ZeRO-1 (+{pad} B of padding over a quarter); "
            f"memory_allocated for the replicas {d['alloc_bytes']} B vs "
            f"{z['alloc_bytes']} B (saved {alloc_saved} B, state sizes say "
            f"{saved} B); variants dense {[v['variant'] for v in d['variants']]}"
            f" ZeRO-1 {[(v['offset_bytes'], v['variant']) for v in z['variants']]}; {smi}")
        del runs, d, z
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
        shard = result["f32"]["variants_zero1"][0]["elements"]
        result["shard_update"] = time_shard_update(dev, flush, shard,
                                                   PW_WORKERS)
        su = result["shard_update"]
        log(f"[parallel-resnet50] fused_update Nesterovs bf16 state: a "
            f"ZeRO-1 slice of {su['shard']['elements']} elements "
            f"({su['shard']['variant']} variant, head {su['shard']['head']})"
            f" {su['shard']['ms']:.4f} ms (plain {su['shard']['plain_ms']:.4f}"
            f", bound {su['shard']['bound_ms']:.4f}); the whole bucket of "
            f"{su['whole']['elements']} ({su['whole']['variant']}) "
            f"{su['whole']['ms']:.4f} ms (bound {su['whole']['bound_ms']:.4f});"
            f" {smi}")
        del flush
        # (b) bf16 state: timed steps in each layout, beside the solo fit
        timed = {}
        for layout in ("solo", "dense", "zero1"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = train_model(dev, True, "bfloat16", "bfloat16")
            target = model if layout == "solo" else pw_wrapper(
                model, dev, ReduceScatterAccumulator()
                if layout == "zero1" else None)
            update.reset_launches()
            ms, losses = _timed_fit(target, ds, PW_WARMUP + PW_TIMED_STEPS)
            torch.cuda.synchronize()
            ms = ms[PW_WARMUP:]
            row = {"images_per_s": PW_BATCH * len(ms) / sum(ms) * 1e3,
                   **_ms_stats(ms), "losses": losses,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "launches": update.fused_update_launches}
            replicas = 1 if layout == "solo" else PW_WORKERS
            check(row["launches"] == replicas * (PW_WARMUP + PW_TIMED_STEPS),
                  f"[parallel-resnet50] bf16 {layout}: {row['launches']} "
                  f"fused_update launches")
            check(all(np.isfinite(losses)), f"bf16 {layout} losses {losses}")
            if layout != "solo":
                fps = replica_fps(target, layout == "dense")
                row["replica_fps"] = fps
                check(len(set(fps)) == 1, f"bf16 {layout}: replicas "
                      f"disagree after {len(losses)} steps: {fps}")
                target.shutdown()
            timed[layout] = row
            del target, model
        result["bf16"] = timed
        log(f"[parallel-resnet50] (b) bf16 compute and state, batch "
            f"{PW_BATCH}: " + "; ".join(
                f"{k} {v['images_per_s']:.2f} images/s, step median "
                f"{v['step_ms_median']:.2f} ms (p10 {v['step_ms_p10']:.2f}, "
                f"p90 {v['step_ms_p90']:.2f}), peak {v['peak_bytes']} B, "
                f"fused_update {v['launches']}"
                for k, v in timed.items())
            + f"; replicas bitwise identical after the steps (dense: "
            f"parameters and updater state; ZeRO-1: parameters); four "
            f"replicas share the one card; {smi}")
        # (c) the card against the port on the CPU, two replicas
        result["cpu_parity"] = parallel_cpu_parity(dev)
        cp = result["cpu_parity"]
        log(f"[parallel-resnet50] (c) workers 2, batch {PW_CPU_BATCH} at "
            f"{PW_CPU_IMAGE}x{PW_CPU_IMAGE}, Nesterovs {PW_CPU_LR}, float64, "
            f"TF32 off, deterministic cuDNN, card vs CPU: after step 1 "
            f"{cp['steps'][0]['rel']:.3e} of the largest |param| "
            f"{cp['max_abs']:.4f} (bound {PW_CPU_REL_TOL}; the step moved "
            f"them by {cp['steps'][0]['moved_rel']:.3e}), after step 2 "
            f"{cp['steps'][1]['rel']:.3e} (moved {cp['steps'][1]['moved_rel']:.3e}"
            f"); losses card {cp['losses_card']} CPU {cp['losses_cpu']}; "
            f"{smi}")
    finally:
        torch.backends.cudnn.deterministic = det
    torch.cuda.empty_cache()
    return result


#: phase 40 (c): the card's parameters against the CPU's after the first
#: step, as a share of the largest parameter magnitude. ResNet-50 at
#: random weights with 4 images a replica is chaotic, and BatchNorm sums
#: its statistics in float32 in any dtype (as the JAX package does), so
#: the card and the CPU differ at float32 rounding there (the first loss
#: by 1.4e-7 relative). At 64x64 and Nesterovs 1e-3 in float64 the first
#: step moves the parameters by 4.7e-2 of their largest and the card
#: lands 4.0e-4 from the CPU (nudging the CPU's own input by 1e-7 moves
#: them by 2.4e-5); the second step moves them by 7.6e-2 in all, and the
#: card lands 2.8e-2 away (the nudge: 8.1e-3). At 224x224 or the model's
#: 0.1 a nudge moves them more (max pooling's near-ties). So the first step
#: is held to 2e-3 (4% of it: rounding meets it, a wrong exchange moves
#: them by the step's order), and the second is reported and held below
#: its own size (PERF.md, section 6).
PW_CPU_REL_TOL = 2e-3
PW_CPU_IMAGE = 64
PW_CPU_LR = 1e-3


def parallel_cpu_parity(dev) -> dict:
    """Two replicas, batch 8 at 64x64, two steps on the card and on the
    CPU from the same parameters, float64 with the per-leaf updater, BN's
    running statistics set to the batch's own (the pivot of
    batchnorm_train's variance). With fused_update on, a float64 bucket
    would take the plain update on the card as on the CPU (phase 5b holds
    that route); this parity holds the per-leaf one."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import ResNet50, zoo
    from deeplearning4j_tpu_torch.parallel.sharding import leaf_paths
    from deeplearning4j_tpu_torch.util.calibrate import calibrate_batchnorm

    rng = np.random.RandomState(SEED + 41)
    x = rng.randn(PW_CPU_BATCH, 3, PW_CPU_IMAGE, PW_CPU_IMAGE)
    y = np.eye(1000)[rng.randint(0, 1000, PW_CPU_BATCH)]
    nets = {}
    for where in ("card", "cpu"):
        conf = ResNet50(num_classes=1000, image_size=PW_CPU_IMAGE,
                        seed=SEED).conf()
        gc = conf.global_conf
        # the per-leaf updater (a float64 bucket's fused route is phase
        # 5b's)
        gc.dtype, gc.fused_update = "float64", False
        gc.updater.learning_rate = PW_CPU_LR
        nets[where] = zoo.network(conf).init(
            device=dev if where == "card" else "cpu")
    card, cpu = nets["card"], nets["cpu"]
    with torch.no_grad():
        for n, k in leaf_paths(cpu._params):
            cpu._params[n][k].copy_(card._params[n][k])
    calibrate_batchnorm(cpu, x)
    card._states = {n: {k: v.to(dev) for k, v in d.items()}
                    for n, d in cpu._states.items()}
    init = {p: cpu._params[p[0]][p[1]].detach().clone()
            for p in leaf_paths(cpu._params)}
    top = max(t.abs().max().item() for t in init.values())
    wrappers, losses = {}, {w: _Losses() for w in nets}
    for where, net in nets.items():
        wrappers[where] = pw_wrapper(
            net, dev if where == "card" else torch.device("cpu"), workers=2)
        wrappers[where].set_listeners(losses[where])
    steps = []
    for _ in range(PW_CPU_STEPS):
        for pw in wrappers.values():
            pw.fit(DataSet(x, y))        # one step; the next continues
        a, b = nets["card"]._params, nets["cpu"]._params
        diff = max((a[n][k].detach().cpu() - b[n][k]).abs().max().item()
                   for n, k in leaf_paths(b))
        moved = max((b[n][k] - init[(n, k)]).abs().max().item()
                    for n, k in leaf_paths(b))
        steps.append({"rel": diff / top, "moved_rel": moved / top})
    for pw in wrappers.values():
        pw.shutdown()
    first, second = steps
    msg = (f"[parallel-resnet50] card vs CPU by step: {steps}; losses card "
           f"{losses['card'].losses} CPU {losses['cpu'].losses}")
    check(first["rel"] <= PW_CPU_REL_TOL, msg + f" (first step > "
          f"{PW_CPU_REL_TOL})")
    check(second["rel"] < second["moved_rel"]
          and all(np.isfinite(losses["card"].losses)), msg)
    del nets, wrappers
    return {"max_abs": top, "rel": first["rel"], "steps": steps,
            "losses_card": losses["card"].losses,
            "losses_cpu": losses["cpu"].losses}


def lenet_pw_data(steps: int, seed: int = 0):
    """bench.py's elastic smoke data: ``steps`` batches of random 28x28
    images with one-hot labels of 10 classes."""
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator

    rng = np.random.RandomState(seed)
    n = steps * LENET_PW_BATCH
    x = rng.randn(n, 1, 28, 28).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    return NDArrayDataSetIterator(x, y, batch_size=LENET_PW_BATCH)


def lenet_pw_model(dev):
    from deeplearning4j_tpu_torch.models import LeNet

    net = LeNet().init(device=dev)
    net.conf.global_conf.fused_update = True
    return net


def phase_parallel_encoded_elastic(smi: str, dev) -> dict:
    """Phase 41: LeNet through the threshold-encoded exchange, shrunk and
    grown online; a ZeRO-1 checkpoint from 4 replicas resumed at 2."""
    import tempfile

    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener)
    from deeplearning4j_tpu_torch.parallel import (
        AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator,
        ReduceScatterAccumulator)

    Environment.get().set_tf32(False)
    prof = OpProfiler.get()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    result = {}
    try:
        it = lenet_pw_data(LENET_PW_STEPS)
        model = lenet_pw_model(dev)
        acc = EncodedGradientsAccumulator(
            threshold_algorithm=AdaptiveThresholdAlgorithm())
        pw = pw_wrapper(model, dev, acc)
        prof.reset()
        update.reset_launches()
        losses = _Losses()
        pw.set_listeners(losses, _At(LENET_PW_STEPS + 3, _interrupt))
        t0 = time.perf_counter()
        try:
            pw.fit(it, epochs=3)
            check(False, "the interrupting listener did not fire")
        except _Interrupt:
            pass
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches_4 = update.fused_update_launches
        check(launches_4 == PW_WORKERS * (LENET_PW_STEPS + 3),
              f"[parallel-encoded-elastic] {launches_4} fused_update "
              f"launches in {LENET_PW_STEPS + 3} steps at 4 replicas")
        stats = prof.collective_stats()
        check(stats.get("encoded_steps") == LENET_PW_STEPS
              and 0.0 < stats.get("encoded_density", 0) <= 1.0,
              f"encoded ledger after one epoch: {stats}")
        cursor = (model._epoch - model._fit_epoch0, model._steps_in_epoch)
        check(cursor == (1, 3), f"cursor {cursor}")
        before = pw._host_acc()
        threshold = float(before["threshold"])
        removed = pw.resize(3, lost_replicas=[1])
        after = model._acc_state
        worst_sum = 0.0
        for p in leaf_paths(before["residual"]):
            old = get_path(before["residual"], p)
            new = get_path(after["residual"], p)
            check(new.shape[0] == 3, f"residual rows {new.shape}")
            check(torch.equal(new[0], old[0] + old[1])
                  and torch.equal(new[1], old[2])
                  and torch.equal(new[2], old[3]),
                  f"residual rows of {p} not folded as survivors 0, 2, 3 "
                  f"with lost row 1 added onto row 0")
            d = (new.sum(0) - old.sum(0)).abs().max().item()
            scale = old.abs().sum(0).max().item()
            check(d <= 2 * 2.0 ** -24 * scale, f"residual sum of {p} moved "
                  f"by {d} (> 2 ulp of {scale})")
            worst_sum = max(worst_sum, d)
        update.reset_launches()
        pw.set_listeners(losses)
        pw.fit(it, epochs=3, resume_cursor=cursor)
        launches_3 = update.fused_update_launches
        want3 = 3 * (LENET_PW_STEPS - 3 + LENET_PW_STEPS)
        check(launches_3 == want3, f"{launches_3} fused_update launches at "
              f"3 replicas (want {want3})")
        pw.resize(4)
        update.reset_launches()
        pw.fit(it, epochs=1)
        launches_grown = update.fused_update_launches
        check(launches_grown == PW_WORKERS * LENET_PW_STEPS,
              f"{launches_grown} fused_update launches after growing back")
        check(all(np.isfinite(losses.losses)), f"losses {losses.losses}")
        stats = prof.collective_stats()
        result["encoded"] = {
            "steps": len(losses.losses), "losses": losses.losses,
            "density": stats.get("encoded_density"),
            "collectives": stats, "threshold_at_shrink": threshold,
            "final_threshold": float(model._acc_state["threshold"]),
            "launches": {"4": launches_4, "3": launches_3,
                         "4_again": launches_grown},
            "removed": [repr(s) for s in removed],
            "residual_sum_moved": worst_sum,
            "elastic": prof.elastic_stats(), "first_fit_s": first_s}
        log(f"[parallel-encoded-elastic] LeNet, encoded exchange "
            f"(AdaptiveThresholdAlgorithm), batch {LENET_PW_BATCH}: density "
            f"{stats.get('encoded_density'):.4f} over "
            f"{stats.get('encoded_steps')} steps, threshold "
            f"{threshold:.3e} at the shrink; 4 -> 3 (lost replica 1, cursor "
            f"{cursor}): residual rows folded bitwise, row sums moved by "
            f"{worst_sum:.3e}; 3 -> 4; {len(losses.losses)} finite losses "
            f"(last {losses.losses[-1]:.4f}); fused_update launches "
            f"{launches_4}/{launches_3}/{launches_grown}; ledger {stats}; "
            f"elastic {prof.elastic_stats()}; {smi}")
        pw.shutdown()
        del pw, model
        # a ZeRO-1 checkpoint at 4 replicas, resumed at 2: ZeRO-1 == dense
        with tempfile.TemporaryDirectory(prefix="dl4j_pw_") as d:
            model = lenet_pw_model(dev)
            pw = pw_wrapper(model, dev, ReduceScatterAccumulator())
            cl = CheckpointListener(d, save_every_n_iterations=3, keep_last=2)
            pw.set_listeners(cl, _At(5, _interrupt))
            try:
                pw.fit(lenet_pw_data(LENET_PW_STEPS), epochs=2)
            except _Interrupt:
                pass
            cl.close()
            last = CheckpointListener.last_checkpoint(d)
            check(last is not None, "no checkpoint committed")
            pw.shutdown()
            runs = {}
            for layout in ("zero1", "dense"):
                model = lenet_pw_model(dev)
                pw = pw_wrapper(model, dev, ReduceScatterAccumulator()
                                if layout == "zero1" else None, workers=2)
                scores = _Losses()
                pw.set_listeners(scores)
                update.reset_launches()
                pw.fit(lenet_pw_data(LENET_PW_STEPS), epochs=2,
                       resume_from=last)
                torch.cuda.synchronize()
                runs[layout] = (scores.losses, model._params,
                                update.fused_update_launches,
                                model._ckpt_workers)
                pw.shutdown()
        (zl, zp, zn, zw), (dl, dp, dn, dw) = runs["zero1"], runs["dense"]
        check(zl == dl and _same_bits(zp, dp), "ZeRO-1 resumed at 2 "
              "replicas from a 4-replica checkpoint differs from the dense "
              "resume")
        check(zw == 4 and zn == dn == 2 * len(zl),
              f"checkpoint workers {zw}; launches {zn} / {dn}")
        result["resume_4_to_2"] = {"losses": zl, "bitwise": True,
                                   "launches": zn, "checkpoint_workers": zw,
                                   "checkpoint": os.path.basename(last)}
        log(f"[parallel-encoded-elastic] ZeRO-1 checkpoint at 4 replicas "
            f"({os.path.basename(last)}) resumed at 2: ZeRO-1 and dense "
            f"continuations bitwise ({len(zl)} steps, losses {zl}); "
            f"fused_update {zn} launches each; {smi}")
    finally:
        torch.backends.cudnn.deterministic = det
    return result


def phase_parallel_integrity(smi: str, dev) -> dict:
    """Phase 42: the replica-consistency check on four LeNet replicas: a
    flipped bit found and named, the step discarded, the replica evicted
    and training continued bitwise like a fresh run from the survivors."""
    from deeplearning4j_tpu_torch.common import integrity
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.ops import update

    Environment.get().set_tf32(False)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    flip_at, check_every, epochs = 5, 2, 2
    try:
        model = lenet_pw_model(dev)
        pw = pw_wrapper(model, dev)
        lst = integrity.IntegrityListener(check_every=check_every)
        seen = {}

        def flip(m):
            integrity.apply_bitflip(m, pw.mesh, {"replica": 2, "bit": 12,
                                                 "offset": 7})

        def capture(m):
            seen["fps"] = replica_fps(pw, True)

        pw.set_listeners(_At(flip_at, flip), _At(flip_at + 1, capture), lst)
        update.reset_launches()
        err = None
        try:
            pw.fit(lenet_pw_data(LENET_PW_STEPS), epochs=epochs)
        except integrity.ReplicaCorruptionError as e:
            err = e
        check(err is not None, "the flipped bit was not caught")
        check(err.replica == 2 and err.iteration == flip_at + 2,
              f"caught replica {err.replica} at iteration {err.iteration} "
              f"(want 2 at {flip_at + 2})")
        launches = update.fused_update_launches
        check(launches == PW_WORKERS * (flip_at + 2),
              f"{launches} fused_update launches")
        frozen = replica_fps(pw, True)
        check(frozen == seen["fps"], "the diverged step was not discarded "
              "on every replica")
        check(len(set(frozen[:2] + frozen[3:])) == 1 and frozen[2] !=
              frozen[0], f"survivors {frozen}")
        cursor = (model._epoch - model._fit_epoch0, model._steps_in_epoch)
        snap = integrity.materialize_from_survivors(
            [(pw.replica_params(r), pw.replica_states(r),
              pw.replica_updater_state(r)) for r in range(PW_WORKERS)], [2])
        gen_state = model.generator().get_state()
        it_, ep = model._iteration, model._epoch
        pw.resize(3, lost_replicas=[2])
        pw.set_listeners()
        pw.fit(lenet_pw_data(LENET_PW_STEPS), epochs=epochs,
               resume_cursor=cursor)
        fresh = lenet_pw_model(dev)
        fresh._params = {n: {k: t.to(dev) for k, t in d.items()}
                         for n, d in snap[0].items()}
        fresh._states = {n: {k: t.to(dev) for k, t in d.items()}
                         for n, d in snap[1].items()}
        fresh._updater_state = snap[2]
        fresh._iteration, fresh._epoch = it_, ep
        fresh.generator().set_state(gen_state)
        pw2 = pw_wrapper(fresh, dev, workers=3)
        pw2.fit(lenet_pw_data(LENET_PW_STEPS), epochs=epochs,
                resume_cursor=cursor)
        check(_same_bits(model._params, fresh._params),
              "the evicted run differs from a fresh 3-replica run from the "
              "survivors' state")
        card_fp = int(integrity.fingerprint_tree(pw.replica_params(0)))
        host_fp = integrity.host_fingerprint(pw.replica_params(0))
        check(card_fp == host_fp, f"fingerprint on the card {card_fp} vs "
              f"host {host_fp}")
        result = {"caught_replica": err.replica,
                  "caught_iteration": err.iteration,
                  "launches_to_detection": launches,
                  "fingerprints": lst.fingerprints,
                  "frozen_fps": frozen, "continued_bitwise": True,
                  "card_fp": card_fp, "host_fp": host_fp}
        log(f"[parallel-integrity] LeNet, 4 replicas, check every "
            f"{check_every}: bit 12 of replica 2 flipped after iteration "
            f"{flip_at}; caught at iteration {err.iteration}, replica "
            f"{err.replica}; the step discarded on every replica; evicted "
            f"(4 -> 3) and continued bitwise like a fresh 3-replica run from "
            f"the survivors; fingerprint on the card {card_fp} = host "
            f"{host_fp}; {smi}")
        pw.shutdown()
        pw2.shutdown()
    finally:
        torch.backends.cudnn.deterministic = det
    return result


# --- phase 43: the serving tier ------------------------------------------------

SV_LADDER = (1, 2, 4, 8, 16, 32)
SV_SLOTS = 2                       # two device slots on the one card
SV_SIZES = (1, 3, 5, 8, 13, 32)    # requests held bitwise to the bucket
SV_CLIENTS = 8
SV_CLOSED_S = 3.0                  # the closed-loop measurement
SV_LOAD_S = 4.0                    # the open-loop Poisson load
SV_LOAD_FRAC = 0.7                 # of the closed-loop rate
SV_DRILL_S = 3.0
SV_REQ_MAX = 8                     # images per request, 1..8
SV_SLOW_S = 0.05                   # the injected dispatch delay of (c), (d)
SV_OVERLOAD_RPS = 500.0
SV_OVERLOAD_S = 2.0
SV_CLASS_MIX = ("batch",) * 5 + ("silver",) * 3 + ("gold",) * 2
# the largest gap between a served answer (its padded bucket, sliced) and
# the forward on the unpadded rows, in probability. cuDNN picks its
# convolution algorithms by batch size, and in bf16 another summation
# order moves a probability by a few bf16 ulp: 3.418e-3 measured on an
# H100 (PERF.md §6); the bound is 2^-6, 4.6x that
SV_UNPADDED_BOUND = 2.0 ** -6


def _sv_classes():
    from deeplearning4j_tpu_torch.parallel import SLOClass

    return [SLOClass("gold", 2, 2000.0, queue_budget=1024),
            SLOClass("silver", 1, 3000.0, queue_budget=512),
            SLOClass("batch", 0, 5000.0, queue_budget=512)]


def _sv_poisson(eng, images, rps: float, seconds: float, seed: int,
                classes=None, threads: int = 4) -> dict:
    """Open-loop Poisson arrivals of 1-8-image requests at ``rps`` from
    ``threads`` client threads for ``seconds``. Sheds (Overloaded) are
    counted per class with their Retry-After; admitted requests resolve
    through done callbacks. Returns latencies, failures, sheds, images and
    the wall time."""
    from deeplearning4j_tpu_torch.parallel import Overloaded

    lock = threading.Lock()
    out = {"lat": [], "lat_by": {}, "fail": [], "shed": {}, "retry": [],
           "images": 0, "admitted": 0}
    pending = []

    def client(k: int) -> None:
        r = np.random.RandomState(seed * 100 + k)
        t0 = time.monotonic()
        t_next = t0
        while True:
            t_next += r.exponential(threads / rps)
            if t_next - t0 > seconds:
                return
            d = t_next - time.monotonic()
            if d > 0:
                time.sleep(d)
            n = int(r.randint(1, SV_REQ_MAX + 1))
            cls = (classes[r.randint(0, len(classes))] if classes
                   else None)
            try:
                fut = eng.output_async(images[:n], slo_class=cls)
            except Overloaded as e:
                with lock:
                    out["shed"][cls] = out["shed"].get(cls, 0) + 1
                    out["retry"].append(e.retry_after_s)
                continue

            def done(f, t_sub=t_next, c=cls, n=n):
                with lock:
                    if f.exception() is not None:
                        out["fail"].append(repr(f.exception()))
                    else:
                        lat = time.monotonic() - t_sub
                        out["lat"].append(lat)
                        out["lat_by"].setdefault(c, []).append(lat)
                        out["images"] += n

            fut.add_done_callback(done)
            with lock:
                out["admitted"] += 1
                pending.append(fut)

    t0 = time.monotonic()
    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for f in list(pending):
        f.exception(timeout=120)       # resolve without raising
    out["wall"] = time.monotonic() - t0
    return out


def _sv_sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _sv_pct(lat, q) -> float:
    return float(np.percentile(np.asarray(lat) * 1e3, q)) if lat else 0.0


def _sv_breakdown(eng, x: np.ndarray, dev, ref_launches, runs: int = 5
                  ) -> dict:
    """The parts of one bucket dispatch, timed one after another on an idle
    engine (medians over ``runs``): the host's wrap padding, the copy to
    the card, the forward's enqueue (host) and its time on the card (CUDA
    events), and the answer's copy back. Its bn_act launches are counted
    into ``ref_launches`` (a measurement, not the path)."""
    from deeplearning4j_tpu_torch.data import pad_rows
    from deeplearning4j_tpu_torch.ops import epilogue

    before = epilogue.bn_act_launches
    b = eng.ladder.bucket_batch(len(x))
    rec = {k: [] for k in ("pad_ms", "h2d_ms", "launch_ms", "device_ms",
                           "d2h_ms")}
    for _ in range(runs):
        _sv_sync(dev)
        t0 = time.perf_counter()
        padded, _w = pad_rows(x, b)
        t1 = time.perf_counter()
        xd = torch.from_numpy(np.ascontiguousarray(padded)).to(dev)
        _sv_sync(dev)
        t2 = time.perf_counter()
        if dev.type == "cuda":
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
        y = eng.forward_bucket(*eng._dev_params[0], xd)
        t3 = time.perf_counter()
        if dev.type == "cuda":
            e1.record()
            e1.synchronize()
            rec["device_ms"].append(e0.elapsed_time(e1))
        t4 = time.perf_counter()
        y.cpu()
        t5 = time.perf_counter()
        rec["pad_ms"].append((t1 - t0) * 1e3)
        rec["h2d_ms"].append((t2 - t1) * 1e3)
        rec["launch_ms"].append((t3 - t2) * 1e3)
        rec["d2h_ms"].append((t5 - t4) * 1e3)
    ref_launches[0] += epilogue.bn_act_launches - before
    return {k: (statistics.median(v) if v else None) for k, v in rec.items()}


def phase_serving_tier(smi: str, dev) -> dict:
    """Phase 43: full-size ResNet-50 (bf16, fused epilogue) served by
    ServingEngine over the ladder 1-32 with two device slots on the card:
    warmup and bucket parity, a closed-loop and an open-loop load with a
    replica killed mid-load, SLO admission under an injected overload, the
    autoscaler, canaried publication with a forced rollback and the
    checkpoint scrubber, and the HTTP front door."""
    import json as _json
    import tempfile
    import urllib.error
    import urllib.request

    from deeplearning4j_tpu_torch.common import faultinject, flightrec
    from deeplearning4j_tpu_torch.common.integrity import (
        CheckpointScrubber, _flip_file_byte, host_fingerprint)
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator, pad_rows
    from deeplearning4j_tpu_torch.learning.precision import cast_floating
    from deeplearning4j_tpu_torch.ops import epilogue
    from deeplearning4j_tpu_torch.optimize import CheckpointListener
    from deeplearning4j_tpu_torch.parallel import (
        AutoscalePolicy, Autoscaler, BucketLadder, OversizeRequest,
        ServingEngine)
    from deeplearning4j_tpu_torch.parallel.serving import (
        next_publication_ordinal)
    from deeplearning4j_tpu_torch.ui import UIServer
    from deeplearning4j_tpu_torch.util import checkpoint as ckpt

    t_phase = time.perf_counter()
    prof = OpProfiler.get()
    faultinject.clear_plan()
    # the drills fire hundreds of faults; their warnings stay off stderr
    port_log = logging.getLogger("deeplearning4j_tpu_torch")
    log_level = port_log.level
    port_log.setLevel(logging.ERROR)
    flightrec.configure(capacity=1 << 17)
    flightrec.reset()
    model = build_model(dev)
    set_fused(model, True)
    model.conf.global_conf.compute_dtype = "bfloat16"
    classes = model.conf.nodes["output"].layer.n_out
    rng = np.random.default_rng(SEED + 43)
    images = rng.normal(size=(40, 3, IMAGE, IMAGE)).astype(np.float32)
    ref_launches = [0]

    def ref_forward(x: np.ndarray) -> torch.Tensor:
        """The model's functional forward of ``x`` with slot 0's serving
        params, called directly (comparison only: its bn_act launches are
        not the path's)."""
        before = epilogue.bn_act_launches
        y = eng.forward_bucket(*eng._dev_params[0],
                               torch.from_numpy(np.ascontiguousarray(x))
                               .to(dev)).cpu()
        _sv_sync(dev)
        ref_launches[0] += epilogue.bn_act_launches - before
        return y

    tmp = tempfile.TemporaryDirectory(prefix="dl4j_serving_")
    eng = scaler = ui = None
    result = {}
    try:
        # every count set to 0 just before the path is driven
        prof.reset()
        _reset_kernel_counts()
        t0 = time.perf_counter()
        eng = (ServingEngine.Builder(model).buckets(SV_LADDER)
               .input_shape((3, IMAGE, IMAGE)).workers(SV_SLOTS)
               .max_wait_ms(2).bf16(True).pin_devices(True)
               .devices([dev] * SV_SLOTS).queue_limit(1024)
               .request_timeout_ms(120_000)
               .resurrect_dead_replicas(True, backoff_ms=100)
               .slo_classes(_sv_classes())
               .brownout(interval_s=0.1, depth_trigger=32, clear_ticks=5)
               .queue_hwm_window(0.5).build())
        _sv_sync(dev)
        build_s = time.perf_counter() - t0
        n_exec = len(SV_LADDER) * SV_SLOTS
        traces = prof.counter_value("trace/serving_infer")

        def flat(where: str) -> None:
            n = prof.counter_value("trace/serving_infer")
            check(n == n_exec, f"trace/serving_infer {n} {where} (want "
                  f"{n_exec}: buckets x slots)")
            check(prof.counter_value("serving/traces_after_warmup") == 0,
                  f"serving/traces_after_warmup "
                  f"{prof.counter_value('serving/traces_after_warmup')} "
                  f"{where}")

        flat("after warmup")
        warm = {k: round(v, 4) for k, v in eng.warmup_timings.items()}
        log(f"[serving-tier] warmup: {n_exec} (bucket, slot) forwards in "
            f"{sum(eng.warmup_timings.values()):.3f} s (build "
            f"{build_s:.3f} s); per bucket {warm}; {smi}")

        # (a) buckets: bitwise to the padded bucket's forward, sliced
        gap = 0.0
        for n in SV_SIZES:
            x = images[:n]
            got = eng.output(x)
            b = eng.ladder.bucket_batch(n)
            want = ref_forward(pad_rows(x, b)[0])[:n]
            check(tuple(got.shape) == (n, classes)
                  and got.dtype == torch.float32,
                  f"{n} images: shape {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()), f"{n} images: not finite")
            check(torch.equal(got, want),
                  f"{n} images through bucket {b} differ from the padded "
                  f"bucket's forward by "
                  f"{(got - want).abs().max().item():.3e}")
            if n != b:
                gap = max(gap, (got - ref_forward(x)).abs().max().item())
        log(f"[serving-tier] (a) requests of {list(SV_SIZES)} images: "
            f"bitwise the model's forward on the same padded bucket, "
            f"sliced; largest gap to the unpadded forward {gap:.3e} "
            f"(bound {SV_UNPADDED_BOUND:.0e}, in probability)")
        check(gap <= SV_UNPADDED_BOUND, f"unpadded gap {gap:.3e} over "
              f"{SV_UNPADDED_BOUND:.0e}")
        split0 = prof.counter_value("serving/oversize_split")
        got = eng.output(images[:40])
        want = torch.cat([ref_forward(images[:32]),
                          ref_forward(pad_rows(images[32:40], 8)[0])])
        check(torch.equal(got, want), "a 40-image request is not 32 + 8 "
              "in order")
        check(prof.counter_value("serving/oversize_split") == split0 + 1,
              "the 40-image request was not split")
        eng.ladder.oversize = "reject"
        try:
            try:
                eng.output_async(images[:40])
                check(False, "a 40-image request under a reject ladder was "
                      "admitted")
            except OversizeRequest:
                pass
        finally:
            eng.ladder.oversize = "split"
        result["warmup_s"] = sum(eng.warmup_timings.values())
        result["warmup_per_bucket_s"] = eng.warmup_timings
        result["unpadded_gap"] = gap

        # (b) closed loop, then an open-loop Poisson load at 70%, then a
        # replica killed mid-load
        served = {"images": 0}
        stop = threading.Event()
        cl_lat, cl_err = [], []
        lock = threading.Lock()

        def closed(k: int) -> None:
            r = np.random.RandomState(SEED + k)
            while not stop.is_set():
                n = int(r.randint(1, SV_REQ_MAX + 1))
                t1 = time.monotonic()
                try:
                    eng.output(images[:n])
                except Exception as e:      # counted, then gated
                    cl_err.append(repr(e))
                    return
                with lock:
                    served["images"] += n
                    cl_lat.append(time.monotonic() - t1)

        ts = [threading.Thread(target=closed, args=(k,))
              for k in range(SV_CLIENTS)]
        b0 = prof.get_counters()
        t1 = time.monotonic()
        for t in ts:
            t.start()
        time.sleep(SV_CLOSED_S)
        stop.set()
        for t in ts:
            t.join()
        closed_wall = time.monotonic() - t1
        check(not cl_err, f"closed-loop errors: {cl_err[:3]}")
        closed_ips = served["images"] / closed_wall
        b1 = prof.get_counters()
        log(f"[serving-tier] (b) closed loop, {SV_CLIENTS} clients, 1-8 "
            f"images a request: {closed_ips:.2f} images/s, p50 "
            f"{_sv_pct(cl_lat, 50):.2f} ms p99 {_sv_pct(cl_lat, 99):.2f} "
            f"ms, {b1.get('serving/batches', 0) - b0.get('serving/batches', 0)}"
            f" batches; {smi}")
        rps = SV_LOAD_FRAC * closed_ips / ((1 + SV_REQ_MAX) / 2)
        c0 = prof.get_counters()
        load = _sv_poisson(eng, images, rps, SV_LOAD_S, seed=1)
        c1 = prof.get_counters()
        check(not load["fail"], f"load failures: {load['fail'][:3]}")

        def fill(a, b):
            cap = b.get("serving/capacity_rows", 0) - a.get(
                "serving/capacity_rows", 0)
            rows = b.get("serving/rows", 0) - a.get("serving/rows", 0)
            return (rows / cap if cap else 0.0), cap - rows

        fr, pad = fill(c0, c1)
        load_ips = load["images"] / load["wall"]
        log(f"[serving-tier] (b) Poisson load at {SV_LOAD_FRAC:.0%} of the "
            f"closed loop ({rps:.1f} requests/s): {load['admitted']} "
            f"requests, 0 failed, p50 {_sv_pct(load['lat'], 50):.2f} ms p99 "
            f"{_sv_pct(load['lat'], 99):.2f} ms, {load_ips:.2f} images/s, "
            f"fill ratio {fr:.4f}, pad waste {1 - fr:.4f} ({pad} rows); {smi}")
        retired0 = prof.counter_value("inference/replica_retired")
        req0 = prof.counter_value("serving/requeued")
        kill_at = prof.counter_value("serving/batches") + 20
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "serving/dispatch", "kind": "dead_replica",
              "index": kill_at}]))
        drill = _sv_poisson(eng, images, rps, SV_DRILL_S, seed=2)
        faultinject.clear_plan()
        check(not drill["fail"], f"kill-drill failures: {drill['fail'][:3]}")
        check(prof.counter_value("inference/replica_retired")
              == retired0 + 1, "the kill drill retired no replica")
        requeued = prof.counter_value("serving/requeued") - req0
        check(requeued >= 1, "the kill drill requeued nothing")
        deadline = time.monotonic() + 10
        while eng.alive_replicas() < SV_SLOTS \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        check(eng.alive_replicas() == SV_SLOTS
              and prof.counter_value("inference/replica_resurrected") >= 1,
              f"the pool is at {eng.alive_replicas()} after the drill")
        log(f"[serving-tier] (b) kill drill (dead_replica at dispatch "
            f"{kill_at}): {drill['admitted']} requests, 0 failed, "
            f"{requeued} requeued, pool back to {eng.alive_replicas()} by "
            f"resurrection; p50 {_sv_pct(drill['lat'], 50):.2f} ms p99 "
            f"{_sv_pct(drill['lat'], 99):.2f} ms")
        flat("after the load")
        parts = _sv_breakdown(eng, images[:20], dev, ref_launches)
        ms = {k: ("not measured" if v is None else f"{v:.3f}")
              for k, v in parts.items()}
        log(f"[serving-tier] (b) one dispatch of 20 images in bucket 32, "
            f"the engine idle (medians of 5, ms): pad on the host "
            f"{ms['pad_ms']}, copy to the card {ms['h2d_ms']}, forward "
            f"enqueued {ms['launch_ms']} (on the card {ms['device_ms']}), "
            f"answer back {ms['d2h_ms']}")
        result["dispatch_breakdown_ms"] = parts
        result.update(
            closed_images_per_s=closed_ips,
            closed_p50_ms=_sv_pct(cl_lat, 50),
            closed_p99_ms=_sv_pct(cl_lat, 99), load_rps=rps,
            load_images_per_s=load_ips,
            load_p50_ms=_sv_pct(load["lat"], 50),
            load_p99_ms=_sv_pct(load["lat"], 99), fill_ratio=fr,
            pad_waste=1 - fr, drill_p99_ms=_sv_pct(drill["lat"], 99),
            drill_requeued=requeued)

        # (c) admission under an injected overload
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "serving/dispatch", "kind": "slow",
              "seconds": SV_SLOW_S, "times": 10 ** 6}]))
        over = _sv_poisson(eng, images, SV_OVERLOAD_RPS, SV_OVERLOAD_S,
                           seed=4, classes=SV_CLASS_MIX)
        faultinject.clear_plan()
        check(not over["fail"], f"overload failures: {over['fail'][:3]}")
        check(over["shed"].get("gold", 0) == 0
              and prof.counter_value("serving/shed/gold") == 0,
              f"gold shed: {over['shed']}")
        check(over["shed"].get("batch", 0) > 0,
              f"the overload shed no batch request: {over['shed']}")
        shed_ev = [e["attrs"] for e in flightrec.events("serving/shed")]
        check(shed_ev and all(abs(a["level"] - a["prev"]) == 1
                              for a in shed_ev),
              f"level changes {[(a['prev'], a['level']) for a in shed_ev]}")
        check(all("batch" in a["shed"] for a in shed_ev if a["shed"]),
              "silver shed while batch was admitted")
        first_up = next((a for a in shed_ev if a["level"] > a["prev"]),
                        None)
        check(first_up is not None and first_up["shed"] == ["batch"],
              f"first shed {first_up}")
        check(all(0.1 <= r <= 30.0 for r in over["retry"]),
              f"Retry-After outside [0.1, 30]: "
              f"{min(over['retry'])}-{max(over['retry'])}")
        log(f"[serving-tier] (c) overload ({SV_OVERLOAD_RPS:.0f} "
            f"requests/s, +{SV_SLOW_S * 1e3:.0f} ms a dispatch): sheds "
            f"{over['shed']}, gold 0; levels "
            f"{[(a['prev'], a['level']) for a in shed_ev]}; Retry-After "
            f"{min(over['retry']):.2f}-{max(over['retry']):.2f} s; gold p99 "
            f"{_sv_pct(over['lat_by'].get('gold', []), 99):.2f} ms")
        result["overload_shed"] = over["shed"]
        result["shed_levels"] = [(a["prev"], a["level"]) for a in shed_ev]

        # (d) the autoscaler: up on a backlog, down when idle
        flat("before the autoscaler")
        scaler = Autoscaler(eng, AutoscalePolicy(
            min_workers=1, max_workers=4, interval_s=0.1, up_queue_depth=8,
            up_p99_frac=50.0, down_idle_s=0.5, cooldown_up_s=0.3,
            cooldown_down_s=0.5)).start()
        t_up = time.monotonic()
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "serving/dispatch", "kind": "slow",
              "seconds": SV_SLOW_S, "times": 10 ** 6}]))
        backlog = _sv_poisson(eng, images, 300.0, 1.5, seed=3)
        faultinject.clear_plan()
        check(not backlog["fail"], f"backlog failures: {backlog['fail'][:3]}")
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and eng.alive_replicas() > 1:
            time.sleep(0.05)
        scaler.stop()
        scales = [e["attrs"] for e in flightrec.events("autoscale/scale")
                  if e["m"] >= t_up]
        ups = [a for a in scales if a["to"] > a["frm"]]
        downs = [a for a in scales if a["to"] < a["frm"]]
        check(any(a["reason"].startswith("queue_hwm") for a in ups),
              f"no scale-up on the backlog: {scales}")
        check(downs and eng.alive_replicas() == 1,
              f"no scale-down to 1 when idle: {scales}, alive "
              f"{eng.alive_replicas()}")
        flat("across the resizes")
        log(f"[serving-tier] (d) autoscaler 1-4: "
            f"{[(a['frm'], a['to'], a['reason']) for a in scales]}; "
            f"trace/serving_infer flat at {n_exec}")
        eng.scale_to(SV_SLOTS, reason="phase 43")
        deadline = time.monotonic() + 5
        while eng.alive_replicas() != SV_SLOTS \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        result["autoscale"] = [(a["frm"], a["to"], a["reason"])
                               for a in scales]

        # (e) publication: two fused_update steps committed, a forced
        # rollback, a promote, the scrubber
        tm = train_model(dev, True, "bfloat16", "bfloat16")
        tm._params = {n: {k: t.detach().clone() for k, t in d.items()}
                      for n, d in model._params.items()}
        tm._states = {n: {k: t.detach().clone() for k, t in d.items()}
                      for n, d in model._states.items()}
        ck_dir = os.path.join(tmp.name, "ckpt")
        cl = CheckpointListener(ck_dir, save_every_n_iterations=1,
                                keep_last=3)
        tm.set_listeners(cl)
        xs = rng.normal(size=(32, 3, IMAGE, IMAGE)).astype(np.float32)
        ys = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, 32)]
        fu0 = _kernel_counts()["fused_update"]
        hits0 = prof.counter_value("precision/fused_hits")
        tm.fit(NDArrayDataSetIterator(xs, ys, batch_size=16), epochs=1)
        cl.close()
        check(not cl.errors(), f"checkpoint errors {cl.errors()}")
        fused = _kernel_counts()["fused_update"] - fu0
        check(fused == (2 if dev.type == "cuda" else 0)
              and prof.counter_value("precision/fused_hits") - hits0 == 2,
              f"{fused} fused_update launches in 2 steps")
        paths = ckpt.committed_checkpoints(ck_dir)
        check(len(paths) == 2, f"{len(paths)} checkpoints committed")
        del tm
        stop_gold = threading.Event()
        gold_err = []

        def gold_traffic() -> None:
            while not stop_gold.is_set():
                try:
                    eng.output(images[:2], slo_class="gold")
                except Exception as e:      # gated below
                    gold_err.append(repr(e))
                    return

        def publish(path, **kw):
            stop_gold.clear()
            ts = [threading.Thread(target=gold_traffic) for _ in range(2)]
            for t in ts:
                t.start()
            try:
                h = eng.publish_checkpoint(path, canary_window_s=1.0,
                                           confirm_window_s=1.0,
                                           check_interval_s=0.05, **kw)
                outcome = h.result(timeout=60)
            finally:
                stop_gold.set()
                for t in ts:
                    t.join()
            return h, outcome

        def slot_bits():
            return [[t.cpu().clone() for t in ckpt.tree_leaves(p)
                     + ckpt.tree_leaves(st)]
                    for p, st in (eng._dev_params[i]
                                  for i in sorted(eng._dev_params))]

        before = slot_bits()
        ordinal = next_publication_ordinal()
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "serving/promote", "kind": "transient",
              "index": ordinal}]))
        h_rb, out_rb = publish(paths[0])
        faultinject.clear_plan()
        check(out_rb == "rolled_back", f"the forced violation ended "
              f"{out_rb!r}")
        after = slot_bits()
        check(all(len(a) == len(b) and all(torch.equal(x, y)
                                           for x, y in zip(a, b))
                  for a, b in zip(before, after)),
              "a slot's params after the rollback differ from before")
        chain_rb = [e["name"] for e in flightrec.events(corr=h_rb.corr)]
        check(chain_rb == ["serving/canary", "serving/promote",
                           "serving/rollback"],
              f"{h_rb.corr} chain {chain_rb}: "
              f"{[e['attrs'] for e in flightrec.events(corr=h_rb.corr)]}")
        h_pr, out_pr = publish(paths[1])
        check(out_pr == "promoted", f"the publication ended {out_pr!r}: "
              f"{[e['attrs'] for e in flightrec.events(corr=h_pr.corr)]}")
        want_p, _ = ckpt.read_checkpoint_params(paths[1], model._params,
                                                model._states)
        want_fp = host_fingerprint(cast_floating(want_p, torch.bfloat16))
        got_fp = [host_fingerprint(eng._dev_params[s][0])
                  for s in range(SV_SLOTS)]
        check(all(fp == want_fp for fp in got_fp),
              f"served slots {got_fp} against the checkpoint {want_fp}")
        chain_pr = [e["name"] for e in flightrec.events(corr=h_pr.corr)]
        check(chain_pr == ["serving/canary", "serving/promote"],
              f"{h_pr.corr} chain {chain_pr}")
        scrub = CheckpointScrubber(ck_dir)
        first = scrub.scrub_now()
        check(first["verified"] == 2, f"scrub {first}")
        _flip_file_byte(paths[1], 4096, 3)
        second = scrub.scrub_now()
        check(second["quarantined"] == 1, f"scrub {second}")
        chosen = ckpt.last_checkpoint(ck_dir, require_scrubbed=True)
        check(chosen == paths[0], f"last_checkpoint(require_scrubbed) gave "
              f"{chosen}")
        log(f"[serving-tier] (e) 2 fused_update steps committed; "
            f"{h_rb.corr} {chain_rb} -> {out_rb}, every slot bitwise as "
            f"before; {h_pr.corr} {chain_pr} -> {out_pr}, both slots' "
            f"fingerprint {got_fp[0]} = the checkpoint's as cast; a byte "
            f"flipped: scrub {second}, last_checkpoint(require_scrubbed) "
            f"-> {os.path.basename(chosen)}")
        check(not gold_err, f"gold requests failed during the "
              f"publications: {gold_err[:3]}")
        flat("after the publications")

        # (f) the HTTP front door
        ui = UIServer().attach_serving(eng)
        port = ui.enable(0)
        base = f"http://127.0.0.1:{port}"

        def post(raw: bytes):
            req = urllib.request.Request(
                base + "/api/infer", data=raw,
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=120)

        def code_of(raw: bytes):
            try:
                with post(raw):
                    return 200, None
            except urllib.error.HTTPError as e:
                return e.code, e.headers.get("Retry-After")

        x2 = images[:2]
        with post(_json.dumps({"inputs": x2.tolist()}).encode()) as r:
            body = _json.loads(r.read())
        http_out = torch.tensor(body["outputs"], dtype=torch.float32)
        check(torch.equal(http_out, eng.output(x2)),
              "POST /api/infer differs from engine.output")
        ladder = eng.ladder
        eng.ladder = BucketLadder((1, 2), oversize="reject")
        try:
            c413, _ = code_of(_json.dumps(
                {"inputs": np.zeros((3, 3, IMAGE, IMAGE), np.float32)
                 .tolist()}).encode())
        finally:
            eng.ladder = ladder
        c400, _ = code_of(b"{not json")
        ticks = eng._brownout.clear_ticks
        eng._brownout.clear_ticks = 10 ** 9    # hold the level for the probe
        eng._adm.set_level(1, reason="phase 43 http drill")
        try:
            c429, retry = code_of(_json.dumps(
                {"inputs": images[:1].tolist(),
                 "slo_class": "batch"}).encode())
        finally:
            eng._adm.set_level(0, reason="phase 43 http drill over")
            eng._brownout.clear_ticks = ticks
        check((c413, c400, c429) == (413, 400, 429)
              and retry is not None and 1 <= int(retry) <= 30,
              f"codes 413/400/429: {c413}/{c400}/{c429}, Retry-After "
              f"{retry}")
        with urllib.request.urlopen(base + "/api/health", timeout=60) as r:
            health = _json.loads(r.read())
        with urllib.request.urlopen(base + "/api/metrics", timeout=60) as r:
            metrics = r.read().decode()
        check(health["serving"]["engines"] >= 1
              and health["serving"]["requests"] > 0,
              f"/api/health serving {list(health.get('serving', {}))}")
        check("dl4j_serving_latency_ms" in metrics,
              "/api/metrics has no dl4j_serving_latency_ms")
        log(f"[serving-tier] (f) POST /api/infer 2 images bitwise "
            f"engine.output; 413 / 400 / 429 (Retry-After {retry} s); "
            f"/api/health serving section, /api/metrics latency rows")

        # the path's kernel: 53 bn_act launches a bucket forward, no
        # fallback, over the whole phase
        flat("at the end")
        launches = epilogue.bn_act_launches - ref_launches[0]
        forwards = prof.counter_value("serving/forwards")
        hits = prof.counter_value("precision/epilogue_hits")
        check(forwards > 0 and launches == 53 * forwards,
              f"bn_act launched {launches} times for {forwards} bucket "
              f"forwards (want 53 each)")
        check(hits == 53 * forwards + ref_launches[0],
              f"epilogue hits {hits}")
        check(prof.counter_value("precision/epilogue_fallbacks") == 0,
              "epilogue fallbacks")
        resid = epilogue.bn_act_residual_launches
        seconds = time.perf_counter() - t_phase
        log(f"[serving-tier] bn_act {launches} launches over {forwards} "
            f"bucket forwards (53 each, {resid} with the residual incl. "
            f"{ref_launches[0]} comparison launches' share), no fallback; "
            f"phase {seconds:.1f} s; {smi}")
        result.update(launches=launches, forwards=forwards,
                      seconds=seconds,
                      serving_ledger=prof.serving_stats())
    finally:
        faultinject.clear_plan()
        if scaler is not None:
            scaler.stop()
        if ui is not None:
            ui.stop()
        if eng is not None:
            eng.shutdown()
        tmp.cleanup()
        flightrec.configure(capacity=flightrec.DEFAULT_CAPACITY)
        port_log.setLevel(log_level)
    return result


# --- phases 44-48: fleet training ------------------------------------------------

FLEET_M = 8
FLEET_BATCH = 64                    # images per member and step
#: the sweep's learning rates, around LeNet's published 0.01
FLEET_RATES = (0.005, 0.0065, 0.008, 0.009, 0.01, 0.011, 0.0125, 0.015)
FLEET_WARMUP = 3
FLEET_TIMED = 20
FLEET_ROUNDS = 2                    # fleet and eight solo fits, in turns
FLEET_CPU_STEPS = 3
FLEET_CPU_TOL = 1e-4                # of each leaf's largest |value|
FLEET_TWIN = 3                      # the member held to its solo twin
FLEET_POISON = 5                    # the member fed a NaN in the drills
MEMBERS_KERNEL_M = 4
MEMBERS_MASKED = 1                  # the masked row of the kernel gates
#: bench.py --config fleet-smoke's MLP and batch (bench.py:4630-4650)
FLEET_MLP = {"n_in": 64, "hidden": 32, "n_out": 10, "batch": 64, "lr": 1e-3}
RL_MEMBERS = 8
RL_STEPS = 300
RL_UPDATE_START = 64
RL_RATES = (2e-4, 3e-4, 5e-4, 7e-4, 1e-3, 1.5e-3, 2e-3, 3e-3)
RL_ASYNC_STEPS = 400


def _members_case(kind, m, n, bf16, dev, gen, masked=True):
    """``[m, n]`` buckets, the rates and the live mask of one
    member-batched case on the card (row MEMBERS_MASKED masked)."""
    from deeplearning4j_tpu_torch.ops import update

    p = torch.randn((m, n), generator=gen, device=dev)
    g = torch.randn((m, n), generator=gen, device=dev).mul_(0.01)
    sdt = torch.bfloat16 if bf16 else torch.float32
    slots = {}
    for s in update.SLOTS[kind]:
        t = torch.randn((m, n), generator=gen, device=dev)
        t = t.abs_().mul_(1e-3) if (s == "v" and kind != "nesterovs") \
            else t.mul_(0.1)
        slots[s] = t.to(sdt)
    bits = (torch.randint(-2 ** 31, 2 ** 31, (m, n), dtype=torch.int32,
                          generator=gen, device=dev)
            if bf16 and update.SLOTS[kind] else None)
    lr = torch.tensor([FLEET_RATES[i % len(FLEET_RATES)] for i in range(m)],
                      dtype=torch.float32, device=dev)
    live = torch.ones((m,), dtype=torch.int32, device=dev)
    if masked and m > MEMBERS_MASKED:
        live[MEMBERS_MASKED] = 0
    return p, g, slots, bits, lr, live


def compare_members(kind, m, n, bf16, dev, gen):
    """The member-batched kernel against (a) its plain version: parameters
    and float32 moments within 2 float32 ulp, bfloat16 moments bitwise;
    (b) the single-bucket kernel launched on each live row with that row's
    rate: bitwise; (c) the masked row: bitwise unchanged. Returns (max
    param err, max moment err, bitwise against the plain version)."""
    from deeplearning4j_tpu_torch.ops import update

    p, g, slots, bits, lr, live = _members_case(kind, m, n, bf16, dev, gen)
    sr = torch.bfloat16 if bf16 else None
    sc = update._scalars(_updater(kind, "bfloat16" if bf16 else None), kind,
                         3)
    want_p, want_s = update.fused_update_members_reference(
        kind, sc, p, g, slots, bits, sr, lr, live)
    solo_p = p.clone()
    solo_s = {k: v.clone() for k, v in slots.items()}
    rates = lr.tolist()
    alive = live.tolist()
    for r in range(m):
        if alive[r]:
            update.fused_update_cuda(
                kind, (rates[r],) + tuple(sc[1:]), solo_p[r], g[r],
                {k: v[r] for k, v in solo_s.items()},
                None if bits is None else bits[r], sr)
    old_p = p.clone()
    old_s = {k: v.clone() for k, v in slots.items()}
    update.fused_update_members_cuda(kind, sc, p, g, slots, bits, sr, lr,
                                     live)
    torch.cuda.synchronize()
    what = f"members {kind} [{m}, {n}] bf16={bf16}"
    perr = (p - want_p).abs().max().item()
    ptol = 2.0 ** -22 * (want_p.abs().max().item() + 1.0)
    check(perr <= ptol, f"{what}: param err {perr} > {ptol}")
    serr = 0.0
    for k in slots:
        d = (slots[k].float() - want_s[k].float()).abs().max().item()
        serr = max(serr, d)
        ok = (torch.equal(slots[k], want_s[k]) if bf16 else
              d <= 2.0 ** -22 * (want_s[k].float().abs().max().item() + 1.0))
        check(ok, f"{what}: moment {k} err {d} against the plain version")
    check(torch.equal(p, solo_p) and all(torch.equal(slots[k], solo_s[k])
                                         for k in slots),
          f"{what}: a row differs from the single-bucket kernel on it")
    for r in range(m):
        if not alive[r]:
            check(torch.equal(p[r], old_p[r]) and all(
                torch.equal(slots[k][r], old_s[k][r]) for k in slots),
                f"{what}: masked row {r} changed")
    bitwise = torch.equal(p, want_p) and all(torch.equal(slots[k], want_s[k])
                                             for k in slots)
    return perr, serr, bitwise


def time_members(dev, gen, flush):
    """Nesterovs with float32 state (LeNet's updater) at the sweep's
    ``[8, 431,080]`` and at ``[4, 25,557,032]``: the member-batched kernel,
    its plain version, the single-bucket kernel launched once per member,
    and torch.optim.SGD(momentum=0.9, nesterov=True, fused=True) over one
    parameter group per member (a yardstick only). Bound: every input read
    once and every output written once (p, g, v in; p, v out: 20 B an
    element) over 3.35 TB/s, against 6 float32 operations an element."""
    from deeplearning4j_tpu_torch.ops import update

    kind = "nesterovs"
    rows = {}
    for tag, m, n in (("lenet_sweep", FLEET_M, LENET_PARAMS),
                      ("resnet50", MEMBERS_KERNEL_M, RESNET50_PARAMS)):
        p, g, slots, _, lr, live = _members_case(kind, m, n, False, dev, gen,
                                                 masked=False)
        sc = update._scalars(_updater(kind), kind, 3)
        rates = lr.tolist()
        nbytes = sum(t.numel() * t.element_size()
                     for t in [p, g] + list(slots.values())) \
            + sum(t.numel() * t.element_size()
                  for t in [p] + list(slots.values())) \
            + lr.numel() * 4 + live.numel() * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 6 * m * n / F32_FLOPS_PER_S * 1e3

        def solo():
            for r in range(m):
                update.fused_update_cuda(kind, (rates[r],) + tuple(sc[1:]),
                                         p[r], g[r], {"v": slots["v"][r]})

        row = {
            "shape": [m, n], "kind": kind, "state_dtype": "float32",
            "ms": _time_ms(lambda: update.fused_update_members_cuda(
                kind, sc, p, g, slots, None, None, lr, live), flush),
            "plain_ms": _time_ms(
                lambda: update.fused_update_members_reference(
                    kind, sc, p, g, slots, None, None, lr, live), flush),
            "solo_x_m_ms": _time_ms(solo, flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}
        lib = [p[r].clone() for r in range(m)]
        for r, t in enumerate(lib):
            t.grad = g[r].clone()
        opt = torch.optim.SGD([{"params": [t], "lr": rates[r]}
                               for r, t in enumerate(lib)], lr=0.01,
                              momentum=0.9, nesterov=True, fused=True)
        opt.step()                   # makes its momentum buffers
        row["library_ms"] = _time_ms(opt.step, flush)
        row["library"] = (f"torch.optim.SGD(momentum=0.9, nesterov=True, "
                          f"fused=True), {m} parameter groups")
        rows[tag] = row
        del p, g, slots, lib, opt
    return rows


def phase_fused_update_members(smi: str, dev):
    """Phase 44: the member-batched route of fused_update held to its plain
    version, to the single-bucket kernel row by row, and to a masked row,
    then timed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 44)
    perr = serr = 0.0
    n_cases = n_bitwise = 0
    cases = [(MEMBERS_KERNEL_M, LENET_PARAMS), (MEMBERS_KERNEL_M,
                                                RESNET50_PARAMS),
             (3, 4097), (2, 1)]
    for kind in ("sgd", "nesterovs", "adam"):
        for bf16 in ((False,) if kind == "sgd" else (False, True)):
            for m, n in cases:
                pe, se, bw = compare_members(kind, m, n, bf16, dev, gen)
                perr, serr = max(perr, pe), max(serr, se)
                n_cases += 1
                n_bitwise += int(bw)
    torch.cuda.empty_cache()
    log(f"[kernels] fused_update members vs plain: {n_cases} comparisons "
        f"(sgd, nesterovs, adam; float32 and bf16 state; [M, N] "
        f"{cases}; row {MEMBERS_MASKED} masked) within 2 f32 ulp, bf16 "
        f"moments bitwise; every row bitwise the single-bucket kernel on "
        f"it, the masked row unchanged; {n_bitwise} of {n_cases} bitwise to "
        f"the plain version; max param err {perr}, max moment err {serr}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = time_members(dev, gen, flush)
    for tag, t in timing.items():
        log(f"[kernels] fused_update members {tag} {t['shape']} nesterovs "
            f"f32 state: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, single-bucket kernel x {t['shape'][0]} "
            f"{t['solo_x_m_ms']:.4f} ms, {t['library']} "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}, {t['bytes']} B at 3.35 TB/s); median of "
            f"{TIMED_RUNS} (CUDA events, cold L2); {smi}")
    torch.cuda.empty_cache()
    return {"max_err_param": perr, "max_err_moment": serr,
            "bitwise": n_bitwise, "cases": n_cases}, timing


def lenet_fleet(dev, drain_every_n: int = 10):
    """The sweep: LeNet as bench.py builds it (fused_update on), one member
    per rate of FLEET_RATES, one shared init."""
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.parallel import FleetTrainer

    net = LeNet().init(device=dev)
    net.conf.global_conf.fused_update = True
    check(net.num_params() == LENET_PARAMS, f"LeNet has {net.num_params()} "
          f"parameters")
    return FleetTrainer.from_sweep(net, {"lr": list(FLEET_RATES)},
                                   same_init=True,
                                   drain_every_n=drain_every_n)


def fleet_batches(n: int, dev, seed: int):
    """``n`` batches of FLEET_BATCH synthetic MNIST images on ``dev``."""
    from deeplearning4j_tpu_torch.data import MnistDataSetIterator

    it = MnistDataSetIterator(FLEET_BATCH, train=True,
                              num_examples=n * FLEET_BATCH, seed=seed,
                              flatten=False)
    return [(torch.from_numpy(ds.features).to(dev),
             torch.from_numpy(ds.labels).to(dev)) for ds in it]


def _member_bits(fleet, m: int) -> list:
    """Member ``m``'s parameters and moments, as host copies."""
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths

    p, _, u = fleet.stacked_views()
    trees = [p] + [u[s] for s in sorted(u)]
    return [get_path(t, q)[m].detach().cpu().clone() for t in trees
            for q in leaf_paths(t)]


def _solo_bits(net) -> list:
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
    from deeplearning4j_tpu_torch.util.model_serializer import \
        dense_updater_state

    u = dense_updater_state(net) or {}
    trees = [net._params] + [u[s] for s in sorted(u)]
    return [get_path(t, q).detach().cpu().clone() for t in trees
            for q in leaf_paths(t)]


def _bits_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


class _Deterministic:
    """cuDNN's deterministic algorithms for the block (bitwise gates
    between runs), TF32 off."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.common.environment import Environment

        Environment.get().set_tf32(False)
        self.prev = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.prev
        return False


def _fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.3f} ms"


def fleet_busy_ms(fleet, batches):
    """The card's busy time a fleet step: torch.profiler's device time of
    every kernel over ``batches`` steps, per step (None when the profiler
    sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x, y in batches:
            fleet.step(x, y)
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
                   for e in prof.key_averages())
    return total_us / 1e3 / len(batches) if total_us > 0 else None


def phase_fleet_sweep(smi: str, dev) -> dict:
    """Phase 45: the LeNet learning-rate sweep at full width, M = 8 members
    at batch 64 each through FleetTrainer.from_sweep: one member-batched
    fused_update launch per step, member 3 bitwise its solo twin, no
    stacked buffer reallocated after step 1, the card against the CPU, and
    the same eight members trained as eight solo fits, in turns."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
    from deeplearning4j_tpu_torch.data import DataSet

    prof = OpProfiler.get()
    with _Deterministic():
        batches = fleet_batches(FLEET_WARMUP + FLEET_TIMED, dev, SEED + 45)
        prof.reset()
        fleet = lenet_fleet(dev)
        twin = fleet.solo_twin(FLEET_TWIN)
        for x, y in batches[:FLEET_WARMUP]:
            fleet.step(x, y)
        torch.cuda.synchronize()
        ptrs = fleet.buffer_ptrs()
        builds = prof.counter_value("trace/fleet_step")
        # the main path: every count set to 0 just before, read just after
        _reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)    # earlier phases' too
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        step_ms, dev_ms, pass_ms = [], [], []
        for x, y in batches[FLEET_WARMUP:]:
            t0 = time.perf_counter()
            start.record()
            fleet.step(x, y)
            end.record()
            end.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
            pass_ms.append(fleet.last_step_timing["passes_host_s"] * 1e3)
        counts = _kernel_counts()
        member_plain = prof.counter_value(
            PLAIN_ON_CARD["fused_update_members"])
        peak = torch.cuda.max_memory_allocated(dev)
        stacked = sum(v.numel() * v.element_size() for v in
                      list(fleet._P.values()) + list(fleet._G.values())
                      + [t for d in fleet._S.values() for t in d.values()])
        check(counts["fused_update_members"] == FLEET_TIMED,
              f"{counts['fused_update_members']} member-batched launches in "
              f"{FLEET_TIMED} fleet steps")
        check(counts["fused_update"] == 0, f"{counts['fused_update']} "
              f"single-bucket fused_update launches in the fleet's steps")
        check(member_plain == 0, f"{member_plain} member buckets took the "
              f"plain route on the card")
        check(fleet.buffer_ptrs() == ptrs, "a stacked buffer was "
              "reallocated after the first step")
        check(builds == 1, f"trace/fleet_step {builds}")
        losses = fleet._score_dev.cpu().numpy()
        check(np.isfinite(losses).all(), f"losses {losses}")
        for x, y in batches:
            twin.fit(DataSet(x, y))
        check(_bits_equal(_member_bits(fleet, FLEET_TWIN), _solo_bits(twin)),
              f"member {FLEET_TWIN} differs from its solo twin after "
              f"{len(batches)} steps")
        busy_ms = fleet_busy_ms(fleet, batches[FLEET_WARMUP:][:3])
        # throughput in turns: the fleet, then the eight members as eight
        # solo networks stepping one after another, twice
        solos = [fleet.solo_twin(m) for m in range(FLEET_M)]
        timed = batches[FLEET_WARMUP:]
        for s in solos:
            s.fit(DataSet(*batches[0]))
        rounds = {"fleet": [], "solo": []}
        for _ in range(FLEET_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, y in timed:
                fleet.step(x, y)
            torch.cuda.synchronize()
            rounds["fleet"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for x, y in timed:
                ds = DataSet(x, y)
                for s in solos:
                    s.fit(ds)
            torch.cuda.synchronize()
            rounds["solo"].append(time.perf_counter() - t0)
        images = FLEET_M * FLEET_BATCH * len(timed)
        ips = {k: images / statistics.median(v) for k, v in rounds.items()}
        del solos
        # the card against the CPU after FLEET_CPU_STEPS steps
        card, host = lenet_fleet(dev), lenet_fleet(torch.device("cpu"))
        for x, y in batches[:FLEET_CPU_STEPS]:
            card.step(x, y)
            host.step(x.cpu(), y.cpu())
        pc, ph = card.stacked_views()[0], host.stacked_views()[0]
        worst = 0.0
        for q in leaf_paths(ph):
            a, b = get_path(pc, q).cpu(), get_path(ph, q)
            worst = max(worst, ((a - b).abs().max()
                                / b.abs().max().clamp_min(1e-30)).item())
        check(worst <= FLEET_CPU_TOL, f"fleet card vs CPU after "
              f"{FLEET_CPU_STEPS} steps: {worst} of a leaf's largest value "
              f"> {FLEET_CPU_TOL}")
    r = {"members": FLEET_M, "batch_per_member": FLEET_BATCH,
         "rates": list(FLEET_RATES), "steps": FLEET_TIMED,
         "images_per_s": FLEET_M * FLEET_BATCH * FLEET_TIMED
         / sum(step_ms) * 1e3,
         **_ms_stats(step_ms),
         "device_ms_median": statistics.median(dev_ms),
         "passes_host_ms_median": statistics.median(pass_ms),
         "host_share": statistics.median(pass_ms)
         / statistics.median(step_ms),
         "device_busy_ms": busy_ms,
         "idle_share": (None if busy_ms is None else
                        1.0 - busy_ms / statistics.median(dev_ms)),
         "peak_bytes": peak, "peak_above_start": peak - held,
         "stacked_bytes": stacked,
         "launches": counts["fused_update_members"],
         "plain_on_card": member_plain,
         "solo_launches": counts["fused_update"],
         "turns_images_per_s": ips, "rounds_s": rounds,
         "last_losses": losses.tolist(), "twin_bitwise": True,
         "cpu_max_rel_err": worst}
    log(f"[fleet-sweep] LeNet (431,080 parameters) x {FLEET_M} members, "
        f"lr {list(FLEET_RATES)}, batch {FLEET_BATCH} each, synthetic "
        f"MNIST: {r['images_per_s']:.1f} images/s over {FLEET_TIMED} steps; "
        f"step ms median {r['step_ms_median']:.3f} p10 "
        f"{r['step_ms_p10']:.3f} p90 {r['step_ms_p90']:.3f} (host clock, "
        f"waiting each step); device time (CUDA events around the step) "
        f"median {r['device_ms_median']:.3f} ms, of which the card is "
        f"busy {_fmt_ms(busy_ms)} (torch.profiler's kernel time a step); "
        f"the {FLEET_M} member passes' host time median "
        f"{r['passes_host_ms_median']:.3f} ms; "
        f"peak {peak} B, {peak - held} B above the phase's start (the "
        f"stacked parameters, gradients and moments {stacked} B); "
        f"{r['launches']} member-batched launches, "
        f"{r['solo_launches']} single-bucket; member {FLEET_TWIN} bitwise "
        f"its solo twin; no buffer reallocated; card vs CPU after "
        f"{FLEET_CPU_STEPS} steps within {worst:.3e} (<= {FLEET_CPU_TOL}); "
        f"{smi}")
    log(f"[fleet-sweep] in turns ({FLEET_ROUNDS} rounds of {FLEET_TIMED} "
        f"steps): fleet {ips['fleet']:.1f} images/s, the same {FLEET_M} "
        f"members as {FLEET_M} solo fits one after another "
        f"{ips['solo']:.1f} images/s; {smi}")
    return r


def fleet_mlp(dev, updater=None, seed: int = 7):
    """bench.py fleet-smoke's 64-32-10 MLP (Adam 1e-3, tanh, MSE), with
    fused_update."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    c = FLEET_MLP
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater if updater is not None else Adam(c["lr"]))
            .activation("tanh").weight_init("xavier").fused_update().list()
            .layer(L.DenseLayer(n_out=c["hidden"]))
            .layer(L.OutputLayer(n_out=c["n_out"], loss="mse",
                                 activation="identity"))
            .set_input_type(InputType.feed_forward(c["n_in"])).build())
    return MultiLayerNetwork(conf).init(device=dev)


def _nan_drills(label, make, x, y, dev) -> dict:
    """A NaN poured into member FLEET_POISON's batch: under "skip" every
    other member ends bitwise as in a clean run and the member keeps its
    pre-step bits at that step; under "cull" its alive bit drops on the
    device and its row stays frozen from then on."""
    from deeplearning4j_tpu_torch.optimize import NanSentinelListener

    M = FLEET_M
    xs = x.expand((M,) + tuple(x.shape)).clone()
    ys = y.expand((M,) + tuple(y.shape)).clone()
    bad = xs.clone()
    bad[FLEET_POISON] = float("nan")
    out = {}
    for policy in ("skip", "cull"):
        def run(poison):
            fleet = make()
            fleet.set_listeners(NanSentinelListener(policy,
                                                    check_every_n=50))
            fleet.step(x, y)
            pre = _member_bits(fleet, FLEET_POISON)
            fleet.step(bad if poison else xs, ys, per_member=True)
            kept = _bits_equal(_member_bits(fleet, FLEET_POISON), pre)
            for _ in range(2):
                fleet.step(x, y)
            fleet.drain()
            return fleet, pre, kept

        clean, _, _ = run(False)
        drill, pre, kept = run(True)
        others = all(_bits_equal(_member_bits(clean, m),
                                 _member_bits(drill, m))
                     for m in range(M) if m != FLEET_POISON)
        check(kept, f"{label} {policy}: the poisoned step moved member "
              f"{FLEET_POISON}")
        check(others, f"{label} {policy}: another member differs from the "
              f"clean run")
        alive = drill.alive_mask().tolist()
        if policy == "skip":
            check(alive == [1] * M, f"{label} skip: alive {alive}")
            check(not _bits_equal(_member_bits(drill, FLEET_POISON), pre),
                  f"{label} skip: member {FLEET_POISON} stopped training")
        else:
            want = [int(m != FLEET_POISON) for m in range(M)]
            check(alive == want, f"{label} cull: alive {alive}")
            check(_bits_equal(_member_bits(drill, FLEET_POISON), pre),
                  f"{label} cull: the culled row moved")
        out[policy] = {"alive": alive, "others_bitwise": True}
    return out


def _cull_spawn(label, make, x, y) -> dict:
    fleet = make()
    fleet.step(x, y)
    ptrs = fleet.buffer_ptrs()
    fleet.cull(2, reason="drill")
    frozen = _member_bits(fleet, 2)
    fleet.step(x, y)
    check(_bits_equal(_member_bits(fleet, 2), frozen), f"{label}: the culled "
          f"member moved")
    fleet.spawn(2)
    fleet.step(x, y)
    check(fleet.buffer_ptrs() == ptrs, f"{label}: cull/spawn reallocated a "
          f"stacked buffer")
    check(fleet.alive_mask().tolist() == [1] * FLEET_M, f"{label}: alive "
          f"{fleet.alive_mask().tolist()}")
    return {"no_realloc": True}


def phase_fleet_lifecycle(smi: str, dev) -> dict:
    """Phase 46: the lifecycle drills on fleet-smoke's MLP and on LeNet:
    NaN isolation under "skip" and "cull", cull then spawn in place,
    FleetEarlyStop from the drained window, save_member into a solo network
    continuing bitwise, save/restore of the whole fleet continuing bitwise,
    and the best member's checkpoint canaried and promoted onto a live
    ServingEngine."""
    import tempfile

    from deeplearning4j_tpu_torch.common import flightrec
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.learning import Sgd
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.optimize import NanSentinelListener
    from deeplearning4j_tpu_torch.parallel import (FleetEarlyStop,
                                                   FleetTrainer,
                                                   ServingEngine)
    from deeplearning4j_tpu_torch.util import checkpoint as ckpt
    from deeplearning4j_tpu_torch.util.model_serializer import tree_leaves

    rng = np.random.RandomState(SEED + 46)
    c = FLEET_MLP
    mx = torch.from_numpy(rng.randn(c["batch"], c["n_in"]).astype(
        np.float32)).to(dev)
    my = torch.from_numpy(rng.randn(c["batch"], c["n_out"]).astype(
        np.float32)).to(dev)
    lx, ly = fleet_batches(1, dev, SEED + 46)[0]
    makers = {"mlp": (lambda: FleetTrainer(fleet_mlp(dev), FLEET_M,
                                           seed=7), mx, my),
              "lenet": (lambda: lenet_fleet(dev), lx, ly)}
    out = {}
    t0 = time.perf_counter()
    with _Deterministic(), tempfile.TemporaryDirectory(
            prefix="dl4j_fleet_") as tmp:
        for label, (make, x, y) in makers.items():
            out[label] = {"nan": _nan_drills(label, make, x, y, dev),
                          "cull_spawn": _cull_spawn(label, make, x, y)}
        # early stop: lr 0 never improves, so every member goes stale
        flightrec.reset()
        es = FleetTrainer(fleet_mlp(dev, Sgd(0.0)), FLEET_M, seed=7,
                          drain_every_n=3)
        es.set_listeners(NanSentinelListener("warn"),
                         FleetEarlyStop(patience=2))
        for _ in range(9):
            es.step(mx, my)
        es.drain()
        check(es.alive_mask().tolist() == [0] * FLEET_M,
              f"early stop: alive {es.alive_mask().tolist()}")
        reasons = {e["attrs"]["reason"] for e in flightrec.events(
            "fleet/cull")}
        check(reasons == {"early_stop"}, f"early stop culls {reasons}")
        # save_member -> a solo network continuing bitwise (LeNet sweep)
        fleet = lenet_fleet(dev, drain_every_n=2)
        for _ in range(2):
            fleet.step(lx, ly)
        path = fleet.save_member(FLEET_TWIN, os.path.join(tmp, "member"))
        solo = type(fleet.model)(fleet.member_conf(FLEET_TWIN)).init(
            device=dev)
        ckpt.restore_training_state(solo, path)
        check(_bits_equal(_member_bits(fleet, FLEET_TWIN), _solo_bits(solo)),
              "save_member: the restored solo network differs")
        for _ in range(2):
            fleet.step(lx, ly)
            solo.fit(DataSet(lx, ly))
        check(_bits_equal(_member_bits(fleet, FLEET_TWIN), _solo_bits(solo)),
              "save_member: the solo continuation differs from the member")
        # save/restore of the whole fleet, continuing bitwise
        fleet.cull(6)
        fpath = fleet.save(os.path.join(tmp, "fleet"))
        resumed = lenet_fleet(dev, drain_every_n=2)
        resumed.restore(fpath)
        for _ in range(2):
            fleet.step(lx, ly)
            resumed.step(lx, ly)
        check(all(_bits_equal(_member_bits(fleet, m),
                              _member_bits(resumed, m))
                  for m in range(FLEET_M)),
              "fleet save/restore: a member differs after the resume")
        check(resumed.alive_mask().tolist()[6] == 0, "restored alive mask")
        manifest = [e.get("fleet") for e in ckpt.read_manifest(
            os.path.join(tmp, "fleet"))]
        # the serving handoff: the best member onto a live engine
        fleet.set_listeners(NanSentinelListener("warn", check_every_n=2))
        for _ in range(2):
            fleet.step(lx, ly)
        best = fleet.best_member()
        exported = fleet.export_member(best)
        bpath = fleet.save_member(best, os.path.join(tmp, "best"))
        engine = (ServingEngine.Builder(LeNet().init(device=dev))
                  .buckets((1, 8, 32)).input_shape((1, 28, 28)).workers(1)
                  .max_wait_ms(2).build())
        try:
            xs = lx[:8].cpu().numpy()
            engine.output(xs)
            handle = engine.publish_checkpoint(bpath, canary_window_s=0.3,
                                               confirm_window_s=0.3,
                                               check_interval_s=0.05)
            deadline = time.monotonic() + 30
            while not handle.done and time.monotonic() < deadline:
                engine.output(xs)
            outcome = handle.result(timeout=30)
            check(outcome == "promoted", f"the member's publication ended "
                  f"{outcome!r}")
            want_p, want_s = ckpt.read_checkpoint_params(
                bpath, engine.model._params, engine.model._states)
            got_p, got_s = engine._dev_params[0]
            got = [t.cpu() for t in tree_leaves(got_p) + tree_leaves(got_s)]
            want = [t.cpu() for t in tree_leaves(want_p)
                    + tree_leaves(want_s)]
            check(_bits_equal(got, want), "the promoted params differ from "
                  "the checkpoint's")
            check(_bits_equal([t.cpu() for t in tree_leaves(want_p)],
                              [t.detach().cpu()
                               for t in tree_leaves(exported._params)]),
                  "the checkpoint differs from export_member")
            served = torch.as_tensor(engine.output(xs)).cpu()
            direct = exported.output(lx[:8]).cpu()
            serve_err = ((served - direct).abs().max()
                         / direct.abs().max()).item()
            check(serve_err <= 1e-5, f"the engine serves {serve_err} of the "
                  f"largest output away from the exported member")
        finally:
            engine.shutdown()
    out["early_stop"] = {"culled": FLEET_M, "reasons": sorted(reasons)}
    out["checkpoints"] = {"member_continuation_bitwise": True,
                          "fleet_resume_bitwise": True,
                          "manifest": manifest}
    out["handoff"] = {"best_member": best, "outcome": outcome,
                      "served_rel_err": serve_err}
    out["seconds"] = time.perf_counter() - t0
    log(f"[fleet-lifecycle] fleet-smoke MLP (64-32-10, Adam) and LeNet, "
        f"{FLEET_M} members each: a NaN in member {FLEET_POISON}'s batch "
        f"under skip left the other {FLEET_M - 1} bitwise as a clean run, "
        f"under cull dropped its alive bit and froze its row; cull then "
        f"spawn without reallocation; FleetEarlyStop culled all "
        f"{FLEET_M} (lr 0) from the drained window; save_member({FLEET_TWIN})"
        f" restored into a solo LeNet continuing bitwise; save/restore of "
        f"the whole fleet continuing bitwise (manifest {manifest}); member "
        f"{best}'s checkpoint {outcome} on a live ServingEngine, its params "
        f"bitwise the checkpoint's; {out['seconds']:.1f} s; {smi}")
    return out


def phase_fault_sites(smi: str, dev) -> dict:
    """Phase 47: the training path's fault sites: device/loss at step 2 of
    a LeNet fit raises DeviceLostError naming the replica; phase 42's bit
    flip driven through the integrity/fingerprint site is caught and
    named."""
    from deeplearning4j_tpu_torch.common import (faultinject, flightrec,
                                                 integrity)
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler

    prof = OpProfiler.get()
    prof.reset()
    flightrec.reset()
    net = lenet_pw_model(dev)
    faultinject.set_plan(faultinject.FaultPlan(
        [{"site": "device/loss", "kind": "device_loss", "index": 2,
          "replica": 1}]))
    err = None
    try:
        net.fit(lenet_pw_data(LENET_PW_STEPS))
    except faultinject.DeviceLostError as e:
        err = e
    finally:
        faultinject.clear_plan()
    check(err is not None and err.replica == 1 and "replica 1" in str(err),
          f"device/loss: {err!r}")
    check(net._iteration == 2, f"device/loss fired after {net._iteration} "
          f"steps")
    lost = prof.fault_stats().get("faults/device/loss/device_loss", 0)
    check(lost == 1, f"faults/device/loss/device_loss {lost}")
    flip_at = 5
    with _Deterministic():
        model = lenet_pw_model(dev)
        pw = pw_wrapper(model, dev)
        lst = integrity.IntegrityListener(check_every=2)
        pw.set_listeners(lst)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "integrity/fingerprint", "kind": "bitflip",
              "index": flip_at, "replica": 2, "bit": 12, "offset": 7}]))
        caught = None
        try:
            pw.fit(lenet_pw_data(LENET_PW_STEPS), epochs=2)
        except integrity.ReplicaCorruptionError as e:
            caught = e
        finally:
            faultinject.clear_plan()
            pw.shutdown()
    check(caught is not None and caught.replica == 2
          and caught.iteration == flip_at + 2,
          f"the site's bit flip: {caught!r}")
    div = flightrec.events("integrity/divergence")
    check(bool(div) and div[0]["attrs"]["replica"] == 2,
          f"integrity/divergence events {div}")
    r = {"device_loss": {"replica": err.replica, "steps": net._iteration,
                         "counted": lost},
         "bitflip_site": {"replica": caught.replica,
                          "iteration": caught.iteration,
                          "divergence_events": len(div)}}
    log(f"[fault-sites] LeNet fit: device/loss at dispatch 2 raised "
        f"DeviceLostError ({err}) after 2 steps, counted {lost}; phase 42's "
        f"flip through integrity/fingerprint (replica 2, bit 12, at "
        f"iteration {flip_at}) caught at iteration {caught.iteration} and "
        f"named replica {caught.replica}, {len(div)} integrity/divergence "
        f"event(s); {smi}")
    return r


def rl_qnet(dev, hidden: int = 64, lr: float = 1e-3):
    """The CartPole Q-network: 4 - 64 - 64 - 2, ReLU, an MSE head, Adam,
    fused_update."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(lr))
            .activation("relu").weight_init("xavier").fused_update().list()
            .layer(L.DenseLayer(n_out=hidden))
            .layer(L.DenseLayer(n_out=hidden))
            .layer(L.OutputLayer(n_out=2, loss="mse", activation="identity"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init(device=dev)


def phase_rl(smi: str, dev) -> dict:
    """Phase 48: the RL package on the card: FleetDQNPopulation (M = 8 on
    the in-process CartPole, a learning-rate sweep) with one member-batched
    update per TD step; QLearningDiscreteDense with one fused_update per TD
    step; A3C and async n-step Q on SameDiff networks, two workers each."""
    from deeplearning4j_tpu_torch import rl
    from deeplearning4j_tpu_torch.optimize import NanSentinelListener

    out = {}
    conf = rl.QLConfiguration(seed=3, max_step=RL_STEPS, max_epoch_step=200,
                              batch_size=32, update_start=RL_UPDATE_START,
                              target_dqn_update_freq=50,
                              epsilon_nb_step=RL_STEPS)
    pop = rl.FleetDQNPopulation(
        lambda i: rl.CartPole(seed=i, max_steps=200), rl_qnet(dev), conf,
        n_members=RL_MEMBERS, grid={"lr": list(RL_RATES)},
        listeners=(NanSentinelListener("warn", check_every_n=25),))
    _reset_kernel_counts()
    t0 = time.perf_counter()
    rewards = pop.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    want = RL_STEPS - RL_UPDATE_START + 1
    check(pop.learn_steps == want, f"population TD steps {pop.learn_steps}, "
          f"want {want}")
    check(counts["fused_update_members"] == pop.learn_steps
          and counts["fused_update"] == 0,
          f"population launches {counts} for {pop.learn_steps} TD steps")
    check(all(len(r) >= 1 for r in rewards), f"episodes per member "
          f"{[len(r) for r in rewards]}")
    losses = pop.fleet._last_losses
    check(losses is not None and np.isfinite(losses).all(),
          f"population TD losses {losses}")
    out["population"] = {"members": RL_MEMBERS, "env_steps": RL_STEPS,
                         "td_steps": pop.learn_steps,
                         "member_launches": counts["fused_update_members"],
                         "episodes": [len(r) for r in rewards],
                         "mean_reward": [float(np.mean(r)) for r in rewards],
                         "last_losses": losses.tolist(), "seconds": wall}
    ql_conf = rl.QLConfiguration(seed=5, max_step=RL_STEPS,
                                 max_epoch_step=200, batch_size=32,
                                 update_start=RL_UPDATE_START,
                                 target_dqn_update_freq=50)
    net = rl_qnet(dev)
    ql = rl.QLearningDiscreteDense(rl.CartPole(seed=11, max_steps=200), net,
                                   ql_conf)
    _reset_kernel_counts()
    ql_rewards = ql.train()
    counts = _kernel_counts()
    check(counts["fused_update"] == ql.learn_steps == want,
          f"QLearningDiscreteDense: {counts['fused_update']} launches, "
          f"{ql.learn_steps} TD steps")
    check(len(ql_rewards) >= 1 and np.isfinite(net.score_value),
          f"QLearningDiscreteDense: {len(ql_rewards)} episodes, loss "
          f"{net.score_value}")
    out["dqn"] = {"td_steps": ql.learn_steps, "episodes": len(ql_rewards),
                  "last_loss": net.score_value}
    a3c = rl.A3CDiscreteDense(
        lambda: rl.CartPole(seed=21, max_steps=200),
        rl.ActorCriticNetwork(4, 2, hidden=(64, 64), seed=2, device=dev),
        rl.A3CConfiguration(seed=2, max_step=RL_ASYNC_STEPS,
                            max_epoch_step=200, num_threads=2, nstep=8))
    a3c_rewards = a3c.train()
    nq = rl.AsyncNStepQLearningDiscreteDense(
        lambda: rl.CartPole(seed=31, max_steps=200),
        rl.SameDiffQNetwork(4, 2, hidden=(64, 64), lr=1e-3, seed=4,
                            device=dev),
        rl.AsyncQLConfiguration(seed=4, max_step=RL_ASYNC_STEPS,
                                max_epoch_step=200, num_threads=2, nstep=5,
                                target_dqn_update_freq=20))
    nq_rewards = nq.train()
    for label, learner, rw in (("a3c", a3c, a3c_rewards),
                               ("async_nstep_q", nq, nq_rewards)):
        check(learner.step_count >= RL_ASYNC_STEPS and len(rw) >= 1
              and learner.losses and np.isfinite(learner.losses).all(),
              f"{label}: {learner.step_count} steps, {len(rw)} episodes, "
              f"{len(learner.losses)} updates")
        out[label] = {"env_steps": learner.step_count, "episodes": len(rw),
                      "updates": len(learner.losses),
                      "last_loss": float(learner.losses[-1])}
    p = out["population"]
    log(f"[rl] FleetDQNPopulation, {RL_MEMBERS} members on CartPole (lr "
        f"{list(RL_RATES)}): {RL_STEPS} env steps, {p['td_steps']} TD steps "
        f"with {p['member_launches']} member-batched fused_update launches "
        f"(one each) in {wall:.2f} s; episodes {p['episodes']}; finite TD "
        f"losses; QLearningDiscreteDense {ql.learn_steps} TD steps, one "
        f"fused_update each, {len(ql_rewards)} episodes; A3C "
        f"{a3c.step_count} steps / {len(a3c_rewards)} episodes / "
        f"{len(a3c.losses)} updates; async n-step Q {nq.step_count} steps / "
        f"{len(nq_rewards)} episodes / {len(nq.losses)} updates; {smi}")
    return out


# --- phases 49-54: model parallelism ---------------------------------------------------
PP_BLOCKS = 12                    # BERT-base's layers (BASELINE.json configs[2])
PP_STAGES = 4
PP_MICRO = 8
PP_BATCH = 32
PP_STEPS = 5
PP_LR = 2e-5                      # BERT's fine-tuning rate
# the card against the CPU: phase 49's stack, batch and schedule, in
# float32 on the card and float64 on the CPU (seconds there), 2 Sgd steps
PP_PARITY = {"blocks": PP_BLOCKS, "width": BERT["hidden"],
             "heads": BERT["heads"], "batch": PP_BATCH, "micro": PP_MICRO,
             "stages": PP_STAGES, "steps": 2, "lr": 0.1}
#: the parity's bounds: loss relative, parameters of their largest |value|
#: (an H100 at 700 W read 1.3e-7 and 7.8e-8; the bounds sit about 13x above)
PP_PARITY_LOSS_TOL = 2e-6
PP_PARITY_PARAM_TOL = 1e-6
PP_SMOKE = {"layers": 12, "feat": 32, "stages": 4, "data": 2, "micro": 8,
            "batch": 64, "steps": 4, "lr": 0.02, "seed": 77}
VGG_PIPE_BATCH = 16
VGG_PIPE_MICRO = 4
VGG_PIPE_STEPS = 3
W2V_SHARDS = 4
W2V_ONE_BLOCK_SENTS = 4000        # 80,000 words: less than one span
TP_SLOTS = 2
TABLE_WORKERS, TABLE_AXIS, TABLE_STEPS = 8, 4, 3
RING = {"batch": 2, "T": 4096, "F": 768, "heads": 12, "slots": 4}
#: the device every slot of these phases' pools names: one card
CARD = "cuda:0"


def attention_stack_conf(blocks: int, width: int, heads: int, T: int,
                         updater, compute_dtype=None):
    """``blocks`` identical SelfAttentionLayer(width, heads) blocks over
    [B, T, width] (tests/test_parallel_extras.py:361's stack)."""
    from deeplearning4j_tpu_torch.nn import (InputType,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    b = NeuralNetConfiguration.builder().seed(SEED).updater(updater).list()
    for _ in range(blocks):
        b.layer(L.SelfAttentionLayer(n_out=width, n_heads=heads))
    conf = b.set_input_type(InputType.recurrent(width, T)).build()
    conf.global_conf.compute_dtype = compute_dtype
    return conf


def _tree_bits(model) -> list:
    return [model._params[k][n] for k in sorted(model._params)
            for n in sorted(model._params[k])]


def microbatched_reference(model, x, y, n_micro: int, steps: int,
                           batch: int):
    """A single-slot microbatched fit of an identical-blocks model with the
    pipeline's arithmetic: per microbatch, autograd through every block
    (layer 0's program, the compute dtype cast as each stage casts), the
    weighted MSE over the global real rows, the gradients added in
    ascending microbatch order, then the per-leaf updater. Returns (losses,
    parameter trees)."""
    from deeplearning4j_tpu_torch.common.dtypes import torch_dtype
    from deeplearning4j_tpu_torch.learning.precision import (apply_updater,
                                                             cast_floating)
    from deeplearning4j_tpu_torch.parallel.pipeline import _weighted_mse

    layer0 = model.conf.layers[0]
    keys = list(model._keys)
    cd = model.conf.global_conf.compute_dtype
    ct = torch_dtype(cd) if cd else None
    params = {k: {n: a.detach().clone() for n, a in model._params[k].items()}
              for k in keys}
    upd = model.conf.global_conf.updater
    state = upd.init(params)
    dev = x.device
    losses = []
    for i in range(steps):
        xb, yb = x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch]
        w = torch.ones(batch, device=dev)
        denom = torch.clamp_min(w.sum(), 1.0)
        mb = batch // n_micro
        dp, loss = None, None
        for m in range(n_micro):
            sl = slice(m * mb, (m + 1) * mb)
            leaves = {k: {n: a.detach().requires_grad_(True)
                          for n, a in params[k].items()} for k in keys}
            with torch.enable_grad():
                h = xb[sl]
                trees = [leaves[k] for k in keys]
                if ct is not None:
                    trees = [cast_floating(t, ct) for t in trees]
                    h = h.to(ct)
                for t in trees:
                    h = layer0.apply(t, h, {}, False)[0]
                l_m = _weighted_mse(h.to(torch.float32), yb[sl],
                                    w[sl]) / denom
                flat = [leaves[k][n] for k in keys for n in sorted(leaves[k])]
                gs = iter(torch.autograd.grad(l_m, flat))
            g = {k: {n: next(gs) for n in sorted(leaves[k])} for k in keys}
            dp = g if dp is None else {k: {n: torch.add(dp[k][n], g[k][n])
                                           for n in g[k]} for k in keys}
            loss = l_m.detach() if loss is None else loss + l_m.detach()
        with torch.no_grad():
            params, state = apply_updater(upd, dp, state, params, i,
                                          model.generator())
        losses.append(float(loss))
    return losses, params


class _PipeClock:
    """A listener: each step's loss, and its wall time ended by the loss's
    readback (which waits for the card)."""

    def __init__(self):
        self.losses, self.ms = [], []
        self.t0 = time.perf_counter()

    def iteration_done(self, model, iteration, score):
        self.losses.append(float(score))
        t = time.perf_counter()
        self.ms.append((t - self.t0) * 1e3)
        self.t0 = t


def pipeline_fit(model, schedule: str, x, y, steps: int, devices,
                 stages: int = PP_STAGES, n_micro: int = PP_MICRO,
                 batch: int = PP_BATCH):
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.parallel import PipelineTrainer

    tr = PipelineTrainer(model, stages=stages, n_micro=n_micro,
                         schedule=schedule, devices=devices)
    clock = _PipeClock()
    tr.set_listeners(clock)
    n = steps * batch
    data = NDArrayDataSetIterator(x[:n].cpu().numpy(), y[:n].cpu().numpy(),
                                  batch_size=batch)
    clock.t0 = time.perf_counter()
    tr.fit(data, epochs=1, batch_size=batch)
    return tr, clock


def phase_pipeline_attention(smi: str, dev):
    """Phase 49: the 12-block SelfAttentionLayer(768, 12 heads) stack
    (BERT-base's attention widths) at T 128, global batch 32, through
    PipelineTrainer(4 stages, 8 microbatches) on [CARD] * 4, bf16
    compute (the encoder fit's flash route), Adam(2e-5): 5 steps under 1F1B
    and under GPipe and a single-slot microbatched fit, bitwise in losses
    and parameters; flash_attention.cu launched blocks x microbatches x
    (forward + recompute) times a step; the kernel against its plain
    version at the stage shape; the card (float32) against the CPU
    (float64) at the same configuration after 2 steps."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import attention

    hidden, heads = BERT["hidden"], BERT["heads"]
    mb = PP_BATCH // PP_MICRO
    gen = torch.Generator(device=dev).manual_seed(SEED + 49)
    err, share, lse_err = compare_flash_bf16(mb, heads, SEQ_LEN,
                                             hidden // heads, False, None,
                                             "strided", dev, gen)
    log(f"[model-parallel] flash_attention bf16 kernel at the stage shape "
        f"[{mb}, {heads}, {SEQ_LEN}, {hidden // heads}] (strided, as the "
        f"MHA op hands it over) against its plain version on the upcast: "
        f"max_abs_err {err:.3e}, bitwise share {share:.4f}, lse error "
        f"{lse_err:.3e} (tolerance 2^-8 |want| + 2e-5, share >= "
        f"{FA_BF16_SHARE}); {smi}")
    conf = attention_stack_conf(PP_BLOCKS, hidden, heads, SEQ_LEN,
                                Adam(PP_LR), "bfloat16")
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    n = PP_STEPS * PP_BATCH
    x = torch.randn((n, SEQ_LEN, hidden), generator=g, device=dev)
    y = torch.randn((n, SEQ_LEN, hidden), generator=g, device=dev) * 0.5
    pool = [CARD] * PP_STAGES
    predicted = PP_BLOCKS * PP_MICRO * 2      # forward + recompute, a step
    runs = {}
    with _Deterministic():
        for schedule in ("1f1b", "gpipe"):
            model = MultiLayerNetwork(conf).init(seed=SEED, device=dev)
            prof = OpProfiler.get()
            prof.reset()
            _reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            tr, clock = pipeline_fit(model, schedule, x, y, PP_STEPS, pool)
            torch.cuda.synchronize()
            counters = prof.get_counters()
            runs[schedule] = {
                "losses": clock.losses, "ms": clock.ms, "model": model,
                "launches": attention.flash_attention_launches,
                "bf16": counters.get("attention/flash_bf16", 0),
                "f32": counters.get("attention/flash_f32", 0),
                "dense": counters.get("attention/mha_dense", 0),
                "builds": counters.get("trace/pipeline_fit_step", 0),
                "ledger": prof.pipeline_stats(),
                "peak": torch.cuda.max_memory_allocated()}
        ref_model = MultiLayerNetwork(conf).init(seed=SEED, device=dev)
        ref_losses, ref_params = microbatched_reference(
            ref_model, x, y, PP_MICRO, PP_STEPS, PP_BATCH)
    a, b = runs["1f1b"], runs["gpipe"]
    check(a["losses"] == b["losses"] == ref_losses,
          f"pipeline losses not bitwise: 1f1b {a['losses']}, gpipe "
          f"{b['losses']}, single slot {ref_losses}")
    ref_bits = [ref_params[k][n] for k in sorted(ref_params)
                for n in sorted(ref_params[k])]
    for name in ("1f1b", "gpipe"):
        bits = _tree_bits(runs[name]["model"])
        check(len(bits) == len(ref_bits)
              and all(torch.equal(p, q) for p, q in zip(bits, ref_bits)),
              f"{name}: final parameters not bitwise the single-slot fit's")
        r = runs[name]
        check(r["launches"] == r["bf16"] == predicted * PP_STEPS
              and r["f32"] == 0 and r["dense"] == 0,
              f"{name}: flash launches {r['launches']} (bf16 route "
              f"{r['bf16']}, f32 {r['f32']}, dense MHA {r['dense']}), want "
              f"{predicted} a step x {PP_STEPS}")
        check(r["builds"] == 1, f"{name}: {r['builds']} step builds")
        check(all(np.isfinite(r["losses"])), f"{name}: losses {r['losses']}")
    bound = (PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1)
    led = a["ledger"]
    check(abs(led["bubble_fraction"] - bound) < 1e-12,
          f"bubble {led['bubble_fraction']} against (S-1)/(M+S-1) {bound}")
    out = {"blocks": PP_BLOCKS, "width": hidden, "heads": heads,
           "T": SEQ_LEN, "batch": PP_BATCH, "stages": PP_STAGES,
           "micro": PP_MICRO, "compute_dtype": "bfloat16",
           "flash_launches_per_step": a["launches"] / PP_STEPS,
           "flash_launches_per_step_gpipe": b["launches"] / PP_STEPS,
           "flash_launches": a["launches"], "losses": a["losses"],
           "flash_max_abs_err": err, "flash_bitwise_share": share,
           "bubble": led["bubble_fraction"], "bubble_bound": bound}
    for name, r in runs.items():
        ms = r["ms"][1:]          # the first step pays the first launches
        out[name] = {**_ms_stats(ms), "samples_per_s":
                     PP_BATCH * len(ms) / sum(ms) * 1e3,
                     "first_step_ms": r["ms"][0], "peak_bytes": r["peak"]}
        log(f"[model-parallel] pipeline {name}: {PP_BLOCKS} x "
            f"SelfAttentionLayer({hidden}, {heads} heads), T {SEQ_LEN}, "
            f"batch {PP_BATCH}, {PP_STAGES} stages x {PP_MICRO} "
            f"microbatches on one card, bf16 compute: step ms median "
            f"{out[name]['step_ms_median']:.2f} p10 "
            f"{out[name]['step_ms_p10']:.2f} p90 "
            f"{out[name]['step_ms_p90']:.2f} (steps 2-{PP_STEPS}; step 1 "
            f"{r['ms'][0]:.2f} ms), {out[name]['samples_per_s']:.1f} "
            f"samples/s; flash_attention launches {r['launches']}, "
            f"{r['launches'] / PP_STEPS:g} a step (predicted {predicted}: "
            f"{PP_BLOCKS} blocks x {PP_MICRO} microbatches x forward + "
            f"recompute), all on the bf16 route; "
            f"peak device memory {r['peak']} B; {smi}")
    log(f"[model-parallel] pipeline losses bitwise across 1F1B, GPipe and a "
        f"single-slot microbatched fit, final parameters too: "
        f"{a['losses']}; bubble {led['bubble_fraction']:.6f} from the "
        f"pipeline ledger against (S-1)/(M+S-1) = {bound:.6f}; {smi}")
    for r in runs.values():
        del r["model"]
    del runs, ref_model, ref_params, x, y
    torch.cuda.empty_cache()
    out["cpu_parity"] = pipeline_cpu_parity(smi, dev)
    return out


def pipeline_cpu_parity(smi: str, dev) -> dict:
    """The card against the CPU at phase 49's configuration (12 x
    SelfAttentionLayer(768, 12 heads), T 128, batch 32, 4 stages x 8
    microbatches): 2 Sgd steps through a 1F1B pipeline on each from the
    same float32 draws, on the card in float32 (TF32 off: the float32
    flash kernel), on the CPU in float64 (the parameters and data
    widened; the plain attention; the trainer's loss in float32 as ever),
    so the reference's own rounding is far below the card's."""
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import attention

    p = PP_PARITY
    rng = np.random.default_rng(SEED + 51)
    n = p["steps"] * p["batch"]
    xh = rng.standard_normal((n, SEQ_LEN, p["width"])).astype(np.float32)
    yh = (rng.standard_normal((n, SEQ_LEN, p["width"])) * 0.5).astype(
        np.float32)
    res = {}
    draws = None
    with _Deterministic():
        for where, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
            d = dev if where == "cuda" else torch.device("cpu")
            conf = attention_stack_conf(p["blocks"], p["width"], p["heads"],
                                        SEQ_LEN, Sgd(p["lr"]))
            conf.global_conf.dtype = "float64" if where == "cpu" \
                else "float32"
            model = MultiLayerNetwork(conf).init(seed=SEED, device=d)
            if draws is None:
                draws = {k: {n_: t.detach().cpu() for n_, t in v.items()}
                         for k, v in model._params.items()}
            model._params = {k: {n_: t.to(d, dt) for n_, t in v.items()}
                             for k, v in draws.items()}
            _reset_kernel_counts()
            t0 = time.perf_counter()
            _, clock = pipeline_fit(
                model, "1f1b", torch.from_numpy(xh).to(d, dt),
                torch.from_numpy(yh).to(d, dt), p["steps"],
                [CARD if where == "cuda" else "cpu"] * p["stages"],
                stages=p["stages"], n_micro=p["micro"], batch=p["batch"])
            res[where] = (clock.losses, [t.detach().cpu().double() for t in
                                         _tree_bits(model)],
                          attention.flash_attention_launches,
                          time.perf_counter() - t0)
    (lc, pc, launches, s_card), (lh, ph, _, s_cpu) = res["cuda"], res["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    scale = max(t.abs().max().item() for t in ph)
    err = max((a - b).abs().max().item() for a, b in zip(pc, ph))
    want = p["blocks"] * p["micro"] * 2 * p["steps"]
    check(launches == want, f"parity run: {launches} flash launches, want "
          f"{want}")
    check(loss_rel <= PP_PARITY_LOSS_TOL
          and err <= PP_PARITY_PARAM_TOL * scale,
          f"pipeline card against CPU: loss rel {loss_rel} (bound "
          f"{PP_PARITY_LOSS_TOL}), parameter error {err} against "
          f"{PP_PARITY_PARAM_TOL} of {scale}")
    log(f"[model-parallel] pipeline card against CPU ({p['blocks']} x "
        f"SelfAttentionLayer({p['width']}, {p['heads']}), T {SEQ_LEN}, batch "
        f"{p['batch']}, {p['stages']} stages x {p['micro']}, Sgd({p['lr']}), "
        f"{p['steps']} steps; card float32 with TF32 off, CPU float64): "
        f"losses within {loss_rel:.3e} relative (bound "
        f"{PP_PARITY_LOSS_TOL:g}), parameters within {err:.3e} = "
        f"{err / scale:.3e} of the largest |param| {scale:.4f} (bound "
        f"{PP_PARITY_PARAM_TOL:g}); {launches} float32 flash launches; "
        f"card {s_card:.2f} s, CPU {s_cpu:.2f} s; {smi}")
    return {"loss_rel": loss_rel, "param_err": err, "param_scale": scale,
            "param_err_rel": err / scale, "flash_launches": launches,
            "cpu_s": s_cpu}


def _dense_stack(dev, layers: int, feat: int, lr: float, seed: int):
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Sgd(learning_rate=lr)).list())
    for _ in range(layers):
        b.layer(L.DenseLayer(n_out=feat, activation="tanh"))
    return MultiLayerNetwork(b.set_input_type(
        InputType.feed_forward(feat)).build()).init(seed=seed, device=dev)


def phase_pipeline_remap(smi: str, dev) -> dict:
    """Phase 50: bench.py's pipeline-parallel-smoke stack (12 Dense layers
    32 wide, 4 stages x 2 data, 8 microbatches, batch 64, 1F1B) on
    [CARD] * 8: a warm-up epoch (one build, the bubble at its bound),
    a pipeline/stage device_loss mid epoch 2, remap(3) over the survivors
    and the fit continued from the cursor: no microbatch lost, the losses
    after the remap bitwise a fresh 3-stage run's from the same state and
    cursor, one build per (stage count, schedule); then epochs at 4 and 3
    stages in turns."""
    from deeplearning4j_tpu_torch.common import faultinject
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.parallel import PipelineTrainer

    c = PP_SMOKE
    S, D, M, batch, steps = (c["stages"], c["data"], c["micro"], c["batch"],
                             c["steps"])
    rng = np.random.RandomState(0)
    x = rng.randn(steps * batch, c["feat"]).astype(np.float32)
    y = (np.tanh(x) * 0.5).astype(np.float32)
    pool = [CARD] * (S * D)

    def make_it():
        return NDArrayDataSetIterator(x, y, batch_size=batch)

    def build(stages, model=None):
        model = model or _dense_stack(dev, c["layers"], c["feat"], c["lr"],
                                      c["seed"])
        tr = PipelineTrainer(model, stages=stages, n_micro=M,
                             schedule="1f1b", data=D, devices=pool)
        clock = _PipeClock()
        tr.set_listeners(clock)
        return model, tr, clock

    prof = OpProfiler.get()
    prof.reset()
    model, tr, clock = build(S)
    tr.fit(make_it(), epochs=1, batch_size=batch)
    led = prof.pipeline_stats()
    bound = (S - 1) / (M + S - 1)
    check(prof.counter_value("trace/pipeline_fit_step") == 1
          and abs(led["bubble_fraction"] - bound) < 1e-12,
          f"warm-up: builds {prof.counter_value('trace/pipeline_fit_step')}"
          f", bubble {led['bubble_fraction']} against {bound}")
    micro0 = prof.counter_value("pipeline/microbatches")
    kill_at = steps + steps // 2
    faultinject.set_plan(faultinject.FaultPlan(
        [{"site": "pipeline/stage", "kind": "device_loss",
          "index": kill_at, "stage": 1}]))
    err = None
    try:
        tr.fit(make_it(), epochs=2, batch_size=batch)
    except faultinject.DeviceLostError as e:
        err = e
    finally:
        faultinject.clear_plan()
    check(err is not None and err.stage == 1, f"device_loss: {err!r}")
    cursor = (int(model._epoch - model._fit_epoch0),
              int(model._steps_in_epoch))
    snap = {k: {n: a.detach().clone() for n, a in v.items()}
            for k, v in model._params.items()}
    it_ep = (model._iteration, model._epoch)
    n_before = len(clock.losses)
    t0 = time.perf_counter()
    removed = tr.remap(S - 1, lost_stages=[1])
    remap_s = time.perf_counter() - t0
    check(len(removed) == D and not (set(removed)
                                     & set(tr.mesh.devices.flat)),
          f"remap removed {removed}")
    tr.fit(make_it(), epochs=2, batch_size=batch, resume_cursor=cursor)
    post = clock.losses[n_before:]
    micro_seen = prof.counter_value("pipeline/microbatches") - micro0
    check(micro_seen == 2 * steps * M,
          f"kill-a-stage drill: {micro_seen} microbatches, want "
          f"{2 * steps * M}")
    builds = prof.counter_value("trace/pipeline_fit_step")
    check(builds == 2, f"{builds} builds after the remap, want 2")
    fresh = _dense_stack(dev, c["layers"], c["feat"], c["lr"], c["seed"])
    fresh._params = snap
    fresh._iteration, fresh._epoch = it_ep
    _, tr2, clock2 = build(S - 1, fresh)
    tr2.fit(make_it(), epochs=2, batch_size=batch, resume_cursor=cursor)
    check(post == clock2.losses and all(np.isfinite(post)),
          f"post-remap losses {post} not bitwise the fresh 3-stage run's "
          f"{clock2.losses}")
    check(all(torch.equal(p, q) for p, q in zip(_tree_bits(model),
                                                 _tree_bits(fresh))),
          "post-remap parameters not bitwise the fresh 3-stage run's")
    builds_all = prof.counter_value("trace/pipeline_fit_step")
    times = {S: [], S - 1: []}
    for _ in range(3):
        for s in (S, S - 1):
            tr.remap(s)
            t0 = time.perf_counter()
            tr.fit(make_it(), epochs=1, batch_size=batch)
            float(model._score)
            times[s].append((time.perf_counter() - t0) / steps * 1e3)
    check(prof.counter_value("trace/pipeline_fit_step") == builds_all,
          "the rounds at 4 and 3 stages built a step again")
    out = {"kill_at": kill_at, "cursor": list(cursor),
           "microbatches_after_kill": micro_seen, "builds": builds,
           "remap_s": remap_s, "post_remap_losses": post,
           "bubble": led["bubble_fraction"], "bubble_bound": bound,
           "step_ms_4": statistics.median(times[S]),
           "step_ms_3": statistics.median(times[S - 1])}
    log(f"[model-parallel] kill a stage: {c['layers']} x Dense({c['feat']}) "
        f"at {S} stages x {D} data, {M} microbatches, batch {batch}; "
        f"pipeline/stage device_loss at dispatch {kill_at} (stage 1), "
        f"remap({S - 1}) in {remap_s * 1e3:.2f} ms, fit continued from "
        f"cursor {cursor}: {micro_seen} microbatches = {2 * steps * M} "
        f"(none lost), post-remap losses bitwise a fresh {S - 1}-stage "
        f"run's ({post}), {builds} builds; step ms median "
        f"{out['step_ms_4']:.2f} at {S} stages, {out['step_ms_3']:.2f} at "
        f"{S - 1}; bubble {led['bubble_fraction']:.6f} against "
        f"{bound:.6f}; {smi}")
    return out


def phase_pipeline_vgg16(smi: str, dev):
    """Phase 51: zoo VGG16 at its published widths cut into 4 stages by
    pipeline_from_mln(cuts=...) on [CARD] * 4, float32 with TF32 off:
    its forward at batch 16 (4 microbatches) against model.output, then 3
    train_steps with finite losses. Returns the model for phase 53."""
    from deeplearning4j_tpu_torch.models import VGG16
    from deeplearning4j_tpu_torch.parallel import (make_pipeline_mesh,
                                                   pipeline_from_mln)

    torch.cuda.empty_cache()
    net = VGG16(seed=SEED).init(device=dev)
    n = len(net.conf.layers)
    cuts = [n // 4, n // 2, 3 * n // 4]
    ds = vgg_batch(dev, SEED + 51)
    x, y = ds.features[:VGG_PIPE_BATCH], ds.labels[:VGG_PIPE_BATCH]
    with _Deterministic():
        want = net.output(x)
        pp = pipeline_from_mln(net, make_pipeline_mesh(
            1, 4, [CARD] * 4), n_micro=VGG_PIPE_MICRO, cuts=cuts,
            example_input=tuple(x.shape))
        got = pp.forward(x)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        check(err <= 1e-4 * scale, f"VGG16 pipeline forward: max abs error "
              f"{err} against 1e-4 of {scale}")
        t0 = time.perf_counter()
        losses = [float(pp.train_step(x, y, lr=0.01))
                  for _ in range(VGG_PIPE_STEPS)]
        step_ms = (time.perf_counter() - t0) / VGG_PIPE_STEPS * 1e3
    check(all(np.isfinite(losses)), f"VGG16 pipeline losses {losses}")
    out = {"layers": n, "cuts": cuts, "in_shapes": pp.in_shapes,
           "forward_max_abs_err": err, "output_scale": scale,
           "losses": losses, "train_step_ms": step_ms}
    log(f"[model-parallel] heterogeneous pipeline: zoo VGG16 ({n} layers) cut "
        f"at {cuts} into 4 stages (inputs {pp.in_shapes}), batch "
        f"{VGG_PIPE_BATCH} in {VGG_PIPE_MICRO} microbatches, float32: "
        f"forward within {err:.3e} of model.output (largest {scale:.4e}); "
        f"{VGG_PIPE_STEPS} train_steps, losses {losses}, "
        f"{step_ms:.1f} ms a step; {smi}")
    del pp
    torch.cuda.empty_cache()
    return out, net, x


def _one_block_tables(dev, sents, mesh=None):
    w = w2v_model(dev, **({} if mesh is None else {"mesh": mesh}))
    w.set_sentence_iterator(sents)
    f = fit_counted(w, "one block")
    check(f["blocks"] == 1, f"one-block fit ran {f['blocks']} blocks")
    return w.lookup_table.syn0, w.lookup_table.syn1neg


def _tables_err(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def phase_sharded_word2vec(smi: str, dev, unsharded) -> dict:
    """Phase 52: Word2Vec with syn0/syn1neg row-sharded over 4 slots of one
    card (make_mesh(data=1, model=4, devices=["cuda:0"] * 4)) at bench.py
    --config word2vec: one block's tables against the unsharded block's
    (index_add_ sums a row's duplicates with atomics, in no fixed order:
    the spread of two unsharded blocks is printed beside the difference,
    and the 1e-6 gate runs under torch.use_deterministic_algorithms, where
    index_add_ adds a row's duplicates in index order), the whole fit cold
    and warm beside phase 14's unsharded fits of this call (last loss
    within 2%), and the cluster gates of phase 14."""
    from deeplearning4j_tpu_torch.parallel import make_mesh

    sents = zipf_sentences(W2V_WORDS)
    mesh = make_mesh(data=1, model=W2V_SHARDS,
                     devices=[CARD] * W2V_SHARDS)
    one = sents[:W2V_ONE_BLOCK_SENTS]
    base1 = _one_block_tables(dev, one)
    spread = _tables_err(base1, _one_block_tables(dev, one))
    atomic_err = _tables_err(base1, _one_block_tables(dev, one, mesh))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = _one_block_tables(dev, one)
        det_spread = _tables_err(det, _one_block_tables(dev, one))
        block_err = _tables_err(det, _one_block_tables(dev, one, mesh))
    finally:
        torch.use_deterministic_algorithms(False)
    check(block_err <= 1e-6, f"one sharded block's tables differ from the "
          f"unsharded block's by {block_err} (> 1e-6) under deterministic "
          f"algorithms")
    log(f"[model-parallel] sharded word2vec, one block ({len(one)} "
        f"sentences): tables within {block_err:.3e} of the unsharded "
        f"block's with deterministic index_add_ (two unsharded blocks: "
        f"{det_spread:.3e}); with the default atomics {atomic_err:.3e}, "
        f"where two unsharded blocks differ by {spread:.3e}; {smi}")
    w = w2v_model(dev, mesh=mesh)
    w.set_sentence_iterator(sents)
    fits = [fit_counted(w, label) for label in ("cold", "warm")]
    check_tables(w, "sharded skipgram")
    base = unsharded["fits"]
    for f, u in zip(fits, base):
        check(f["rounds"] == f["sum_ceil_count_over_b"] > 0,
              f"sharded {f['fit']} fit: rounds {f['rounds']}")
        check(np.isfinite(f["last_loss"]), f"sharded {f['fit']} loss")
        _log_fit("model-parallel] [sharded-w2v", f, smi)
    rel = abs(fits[0]["last_loss"] - base[0]["last_loss"]) / abs(
        base[0]["last_loss"])
    check(rel <= 0.02, f"sharded last loss {fits[0]['last_loss']} against "
          f"the unsharded {base[0]['last_loss']}: {rel:.4f} > 2%")
    del w, sents
    cluster = cluster_gate(dev, "model-parallel] [sharded-w2v", 0.4, 1500,
                           near=True, layer_size=32, seed=42, window=3,
                           negative=5, epochs=3, batch_size=256, mesh=mesh)
    out = {"shards": W2V_SHARDS, "one_block_max_abs_err": block_err,
           "one_block_spread_deterministic": det_spread,
           "one_block_err_atomics": atomic_err,
           "one_block_spread_atomics": spread,
           "fits": fits, "last_loss_rel_to_unsharded": rel,
           "cluster": cluster,
           "words_per_s": {"sharded_cold": fits[0]["words_per_s"],
                           "sharded_warm": fits[1]["words_per_s"],
                           "unsharded_cold": base[0]["words_per_s"],
                           "unsharded_warm": base[1]["words_per_s"]}}
    log(f"[model-parallel] sharded word2vec over {W2V_SHARDS} slots of one "
        f"card: words/s cold {fits[0]['words_per_s']:.1f} warm "
        f"{fits[1]['words_per_s']:.1f} against unsharded cold "
        f"{base[0]['words_per_s']:.1f} warm {base[1]['words_per_s']:.1f} "
        f"(phase 14, this call); last loss {fits[0]['last_loss']:.6f} "
        f"against {base[0]['last_loss']:.6f} ({100 * rel:.3f}%); {smi}")
    return out


def phase_tp_and_tables(smi: str, dev, net, x) -> dict:
    """Phase 53: apply_tp over 2 model slots of one card on zoo VGG16's
    forward at batch 16 (float32, TF32 off) against the replicated forward
    (1e-5 relative); ParallelWrapper.Builder(m).workers(8).model_axis(4)
    on tests/test_parallel_extras.py's embedding model against its
    replicated run (1e-3, the JAX test's bound), 3 steps."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   ShardedTensor, apply_tp,
                                                   make_mesh)

    with _Deterministic():
        want = net.output(x)
        replicated = net._params
        net._params = apply_tp(replicated, make_mesh(
            data=1, model=TP_SLOTS, devices=[CARD] * TP_SLOTS))
        n_sharded = sum(isinstance(t, ShardedTensor)
                        for v in net._params.values() for t in v.values())
        t0 = time.perf_counter()
        got = net.output(x)
        torch.cuda.synchronize()
        tp_ms = (time.perf_counter() - t0) * 1e3
        net._params = replicated
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    check(n_sharded > 0 and err <= 1e-5 * scale,
          f"VGG16 tensor-parallel forward: max abs error {err} against 1e-5 "
          f"of {scale} ({n_sharded} sharded leaves)")

    def emb_model(table_sharding):
        conf = (NeuralNetConfiguration.builder().seed(7)
                .updater(Adam(learning_rate=0.01)).list()
                .layer(L.EmbeddingSequenceLayer(
                    n_out=16, table_sharding=table_sharding))
                .layer(L.GlobalPoolingLayer(pooling_type="avg"))
                .layer(L.OutputLayer(n_out=4, activation="softmax",
                                     loss="mcxent"))
                .set_input_type(InputType.recurrent(64, 6)).build())
        return MultiLayerNetwork(conf).init(device=dev)

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(TABLE_STEPS):
        c = rng.integers(0, 4, size=32)
        batches.append(DataSet(
            (c[:, None] * 16 + rng.integers(0, 16, size=(32, 6))).astype(
                np.float32), np.eye(4, dtype=np.float32)[c]))
    pool = [CARD] * TABLE_WORKERS
    m_ref, m_sh = emb_model(None), emb_model("model")
    pw_ref = ParallelWrapper.Builder(m_ref).workers(TABLE_WORKERS) \
        .devices(pool).build()
    pw_sh = ParallelWrapper.Builder(m_sh).workers(TABLE_WORKERS) \
        .model_axis(TABLE_AXIS).devices(pool).build()
    for ds in batches:
        pw_ref.fit(ds)
        pw_sh.fit(ds)
    shards = [tuple(t.shape) for t in pw_sh._reps[0].tables["0000"]]
    tab_err = max((m_sh._params[k]["W"] - m_ref._params[k]["W"]).abs().max()
                  .item() for k in ("0000", "0002"))
    check(tab_err <= 1e-3 and len(shards) == TABLE_AXIS,
          f"model-axis wrapper against replicated: {tab_err} (shards "
          f"{shards})")
    out = {"vgg16_tp": {"slots": TP_SLOTS, "sharded_leaves": n_sharded,
                        "max_abs_err": err, "output_scale": scale,
                        "forward_ms": tp_ms},
           "wrapper_tables": {"workers": TABLE_WORKERS,
                              "model_axis": TABLE_AXIS, "shards": shards,
                              "max_abs_err": tab_err,
                              "losses": [float(m_sh._score)]}}
    log(f"[model-parallel] tensor parallel: zoo VGG16 forward at batch "
        f"{x.shape[0]} with apply_tp over {TP_SLOTS} slots ({n_sharded} "
        f"sharded leaves, column-parallel conv and dense, the softmax head "
        f"gathered) within {err:.3e} of the replicated forward (largest "
        f"{scale:.4e}), {tp_ms:.1f} ms; ParallelWrapper workers "
        f"{TABLE_WORKERS} model_axis {TABLE_AXIS}: the table in shards "
        f"{shards} per data row, {TABLE_STEPS} steps within {tab_err:.3e} "
        f"of the replicated run; {smi}")
    return out


def phase_ring_attention(smi: str, dev) -> dict:
    """Phase 54: ring_self_attention at F 768, 12 heads, T 4096 over 4
    slots of one card, batch 2, causal and not, float32 with TF32 off,
    against dense attention (the projections, then
    ops.nn.dot_product_attention) at atol 2e-5 / rtol 1e-4, and the
    gradients of sum(out^2) (the JAX test's loss) for wq, wk, wv, wo at
    rtol 1e-3 and an atol of 1e-4 of the dense gradients' largest |value|
    (the JAX test's 1e-4 against its gradients' 0.82); ms per call against
    the dense op's."""
    from deeplearning4j_tpu_torch.ops import nn as tnn
    from deeplearning4j_tpu_torch.parallel import (make_mesh,
                                                   ring_self_attention)

    r = RING
    B, T, F, H = r["batch"], r["T"], r["F"], r["heads"]
    g = torch.Generator(device=dev).manual_seed(SEED + 54)
    x = torch.randn((B, T, F), generator=g, device=dev)
    ws = [torch.randn(shape, generator=g, device=dev) / math.sqrt(F)
          for shape in ((F, F),) * 4]
    mesh = make_mesh(data=r["slots"], devices=[CARD] * r["slots"])

    def dense(wq, wk, wv, wo, causal):
        def heads(w):
            return (x @ w).reshape(B, T, H, -1).permute(0, 2, 1, 3)

        q, k, v = heads(wq), heads(wk), heads(wv)
        mask = (torch.tril(torch.ones((T, T), dtype=torch.bool,
                                      device=dev))[None, None]
                if causal else None)
        ctx = tnn.dot_product_attention(q, k, v, mask)
        return ctx.permute(0, 2, 1, 3).reshape(B, T, -1) @ wo

    def ring(wq, wk, wv, wo, causal):
        return ring_self_attention(x, wq, wk, wv, wo, H, mesh, "data",
                                   causal=causal)

    out = {}
    with _Deterministic():
        for causal in (False, True):
            res = {}
            for name, fn in (("ring", ring), ("dense", dense)):
                leaves = [w.clone().requires_grad_(True) for w in ws]
                y = fn(*leaves, causal)
                (y ** 2).sum().backward()
                res[name] = (y.detach(), [w.grad for w in leaves])
                with torch.no_grad():
                    fn(*ws, causal)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(3):
                        fn(*ws, causal)
                    torch.cuda.synchronize()
                res[name] += ((time.perf_counter() - t0) / 3 * 1e3,)
            (yr, gr, ms_r), (yd, gd, ms_d) = res["ring"], res["dense"]
            tag = "causal" if causal else "full"
            excess = ((yr - yd).abs() - 1e-4 * yd.abs()).max().item()
            check(excess <= 2e-5, f"ring ({tag}) against dense: "
                  f"|ring - dense| exceeds 1e-4 |dense| by {excess}")
            g_excess = max(((a - b).abs() - 1e-3 * b.abs()).max().item()
                           for a, b in zip(gr, gd))
            g_scale = max(b.abs().max().item() for b in gd)
            check(g_excess <= 1e-4 * g_scale, f"ring ({tag}) gradients: "
                  f"exceed 1e-3 |dense| by {g_excess}, against 1e-4 of "
                  f"{g_scale}")
            out[tag] = {"max_abs_err": (yr - yd).abs().max().item(),
                        "excess_over_rtol": excess,
                        "grad_excess_over_rtol": g_excess,
                        "grad_scale": g_scale,
                        "ms": ms_r, "dense_ms": ms_d}
            log(f"[model-parallel] ring attention ({tag}): batch {B}, T {T} "
                f"over {r['slots']} slots of one card, F {F}, {H} heads, "
                f"float32, TF32 off: max abs error "
                f"{out[tag]['max_abs_err']:.3e} against dense attention, "
                f"max(|ring - dense| - 1e-4 |dense|) {excess:.3e} (gate "
                f"<= 2e-5); gradients: max(|ring - dense| - 1e-3 |dense|) "
                f"{g_excess:.3e} (gate <= 1e-4 x {g_scale:.4e}, the dense "
                f"gradients' largest |value|); {ms_r:.2f} ms a forward "
                f"against the dense op's {ms_d:.2f} ms; {smi}")
    return out


# --- phases 55-58: the supervisor and the process group -------------------------

SV_BATCH = 32                 # bench.py's resnet50 batch per card
SV_BATCHES = 6                # an epoch
SV_EPOCHS = 2
SV_EVERY = 2                  # checkpoint cadence, iterations
SV_CRASH_AT = 5               # dispatch ordinals of the drills
SV_WEDGE_AT = 7
SV_PREEMPT_AT = 7
SV_HANG_S = 3.0               # the watchdog's deadline (a step is ~0.1 s)
SV_GRACE_S = 60.0             # before an attempt's first step
EL_BATCHES = 6                # phase 56: one epoch of batch 64
EL_LOSS_AT = 3
EL_GROW_LOSS_AT = 1
PR_STEPS = 5                  # phase 57
PR_LOSS_AT = 2
PR_REFUSED_STEPS = 3
PR_REFUSED_AT = 1
PG_WORLD = 2                  # phase 58
PG_BATCH = 32                 # per rank
PG_STEPS = 8
PG_EVERY = 3
PG_CRASH_ORDINAL = 4          # rank 1 leaves at step 5's dispatch


def _sv_arrays(n: int, seed: int, classes: int = 1000):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3, IMAGE, IMAGE).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.randint(0, classes, n)]
    return x, y


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def _step_ms(clock, t0) -> list:
    ends = [t0] + clock.t
    return [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]


class _Count:
    """Counts every step it hears of, replays included (no state_dict, so
    no checkpoint rewinds it)."""

    def __init__(self):
        self.n = 0

    def iteration_done(self, model, iteration, score):
        self.n += 1


def _sv_drill(dev, make, tmp: str, plan, **opts) -> dict:
    """One supervised ResNet-50 fit of ``make``'s batches under ``plan``."""
    from deeplearning4j_tpu_torch.common import faultinject
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresIterationListener)
    from deeplearning4j_tpu_torch.parallel import TrainingSupervisor

    torch.cuda.empty_cache()
    model = train_model(dev, True, "bfloat16", "bfloat16")
    scores, count = CollectScoresIterationListener(), _Count()
    model.set_listeners(scores, count)
    prof = OpProfiler.get()
    prof.reset()
    update.reset_launches()
    faultinject.set_plan(faultinject.FaultPlan(plan) if plan else None)
    try:
        sup = TrainingSupervisor(model, tmp, save_every_n_iterations=SV_EVERY,
                                 backoff_base_s=0.05, **opts)
        res = sup.fit(make, epochs=SV_EPOCHS, resume="never")
    finally:
        faultinject.clear_plan()
    torch.cuda.synchronize()
    return {"model": model, "sup": sup, "res": res,
            "losses": [s for _, s in scores.scores], "steps": count.n,
            "launches": update.fused_update_launches,
            "stats": prof.supervisor_stats()}


def _same_model(a, b) -> bool:
    return (_same_bits(a._params, b._params)
            and _same_bits(a._states, b._states)
            and _same_bits(a._updater_state["v"], b._updater_state["v"]))


def phase_supervised_resnet50(smi: str, dev) -> dict:
    """Phase 55: ResNet-50 under TrainingSupervisor (see the module
    docstring)."""
    import tempfile

    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.optimize import (
        CheckpointListener, CollectScoresIterationListener)
    from deeplearning4j_tpu_torch.parallel import TrainingSupervisor

    t_phase = time.perf_counter()
    x, y = _sv_arrays(SV_BATCH * SV_BATCHES, SEED + 55)

    def make():
        return NDArrayDataSetIterator(x, y, batch_size=SV_BATCH,
                                      shuffle=True, seed=SEED + 55)

    steps = SV_EPOCHS * SV_BATCHES
    out = {"batch": SV_BATCH, "steps": steps, "every": SV_EVERY}
    with _Deterministic():
        base = train_model(dev, True, "bfloat16", "bfloat16")
        scores = CollectScoresIterationListener()
        base.set_listeners(scores)
        base.fit(make(), epochs=SV_EPOCHS)
        want = [s for _, s in scores.scores]
        check(len(want) == steps and all(np.isfinite(want)),
              f"unsupervised losses {want}")
        drills = {
            "crash": ([{"site": "train/step", "index": SV_CRASH_AT,
                        "kind": "crash"}], {}),
            "wedge": ([{"site": "train/wedge", "index": SV_WEDGE_AT,
                        "kind": "wedge"}],
                      {"hang_deadline_s": SV_HANG_S,
                       "hang_startup_grace_s": SV_GRACE_S}),
        }
        for name, (plan, opts) in drills.items():
            with tempfile.TemporaryDirectory(prefix="dl4j_sv_") as tmp:
                r = _sv_drill(dev, make, tmp, plan, **opts)
            res, st = r["res"], r["stats"]
            want_class = "device_failure" if name == "crash" else "hang"
            check(res.status == "completed" and res.restarts == 1
                  and [h["class"] for h in res.history] == [want_class],
                  f"{name} drill: {res} history {res.history}")
            check(r["losses"] == want, f"{name} drill: healed losses "
                  f"{r['losses']} differ from the unsupervised {want}")
            check(_same_model(r["model"], base), f"{name} drill: final "
                  "parameters, BN statistics or momentum not bitwise the "
                  "unsupervised fit's")
            check(r["launches"] == r["steps"] > steps,
                  f"{name} drill: fused_update launched {r['launches']} "
                  f"times for {r['steps']} dispatched steps (want one a "
                  f"step, replays included)")
            check(st.get("restarts") == 1 and st.get("attempts") == 2
                  and (name != "wedge" or st.get("watchdog_fires") == 1),
                  f"{name} drill: supervisor ledger {st}")
            out[name] = {"steps_dispatched": r["steps"],
                         "launches": r["launches"], "ledger": st,
                         "history": res.history}
            log(f"[supervised-resnet50] {name} drill at dispatch "
                f"{plan[0]['index']}: {want_class} -> restart from the "
                f"last checkpoint; {r['steps']} steps dispatched ({steps} "
                f"+ {r['steps'] - steps} replayed), fused_update launches "
                f"{r['launches']}; losses, parameters, BN statistics and "
                f"momentum bitwise the unsupervised fit's; ledger {st}; "
                f"{smi}")
            del r
        # preemption: a real SIGTERM, a resumable result, a second fit
        with tempfile.TemporaryDirectory(prefix="dl4j_sv_") as tmp:
            r = _sv_drill(dev, make, tmp, [{"site": "train/step",
                                             "index": SV_PREEMPT_AT,
                                             "kind": "preempt"}])
            res = r["res"]
            check(res.status == "preempted" and res.resumable
                  and res.restarts == 0
                  and os.path.basename(res.resume_from or "").startswith(
                      "checkpoint_preempt_"),
                  f"preempt drill: {res} history {res.history}")
            first = r["losses"]
            del r
            torch.cuda.empty_cache()
            model = train_model(dev, True, "bfloat16", "bfloat16")
            scores2 = CollectScoresIterationListener()
            model.set_listeners(scores2)
            res2 = TrainingSupervisor(model, tmp,
                                      save_every_n_iterations=SV_EVERY,
                                      backoff_base_s=0.05).fit(
                make, epochs=SV_EPOCHS, resume="auto")
            torch.cuda.synchronize()
            got = [s for _, s in scores2.scores]
            check(res2.status == "completed" and got == want
                  and _same_model(model, base),
                  f"preempt drill: the resumed fit ({res2}) is not bitwise "
                  f"the unsupervised fit: {got} vs {want}")
            out["preempt"] = {"preempted_after": len(first),
                              "resume_from": os.path.basename(
                                  res.resume_from)}
            log(f"[supervised-resnet50] preempt drill: SIGTERM at dispatch "
                f"{SV_PREEMPT_AT}, preempted after {len(first)} steps with "
                f"{os.path.basename(res.resume_from)}; a second fit "
                f"(resume='auto') finished bitwise the unsupervised fit; "
                f"{smi}")
            del model
        # the supervised and the plain fit's steps, in turns, and the plain
        # fit with the same checkpoint cadence (what the supervisor adds
        # beyond its checkpoints)
        ms = {"plain": [], "checkpointed": [], "supervised": []}
        ck = {}
        for turn in ("plain", "checkpointed", "supervised", "supervised",
                     "checkpointed", "plain"):
            torch.cuda.empty_cache()
            model = train_model(dev, True, "bfloat16", "bfloat16")
            clock = _StepClock(dev)
            model.set_listeners(clock)
            with tempfile.TemporaryDirectory(prefix="dl4j_sv_") as tmp:
                t0 = time.perf_counter()
                if turn == "plain":
                    model.fit(make(), epochs=SV_EPOCHS)
                elif turn == "checkpointed":
                    cl = CheckpointListener(
                        tmp, save_every_n_iterations=SV_EVERY)
                    model.set_listeners(cl, clock)
                    model.fit(make(), epochs=SV_EPOCHS)
                    cl.close()
                else:
                    sup = TrainingSupervisor(
                        model, tmp, save_every_n_iterations=SV_EVERY)
                    sup.fit(make, epochs=SV_EPOCHS, resume="never")
                    cl = sup.checkpoint_listener
                    last = cl.saved[-1]
                    ck = {"bytes": os.path.getsize(last),
                          "commit_s": list(cl.commit_seconds),
                          "snapshot_ms": list(cl.snapshot_ms)}
            ms[turn] += _step_ms(clock, t0)[1:]
            del model
        out["step_ms_median"] = {k: statistics.median(v)
                                 for k, v in ms.items()}
        out["checkpoint"] = ck
        log(f"[supervised-resnet50] steps 2-{steps} of two fits each, in "
            f"turns (plain, checkpointed, supervised, supervised, "
            f"checkpointed, plain): median "
            f"{out['step_ms_median']['plain']:.2f} ms plain, "
            f"{out['step_ms_median']['checkpointed']:.2f} ms with a "
            f"CheckpointListener alone, "
            f"{out['step_ms_median']['supervised']:.2f} ms supervised "
            f"(a checkpoint every {SV_EVERY} steps: "
            f"{ck['bytes']} B, commit s median "
            f"{statistics.median(ck['commit_s']):.3f}, snapshot ms median "
            f"{statistics.median(ck['snapshot_ms']):.2f}); {smi}")
    del base
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_supervised_elastic(smi: str, dev) -> dict:
    """Phase 56: ResNet-50 through four replicas on the card under the
    supervisor: shrink on a lost replica, bitwise a fresh 3-replica resume;
    the grow-back; LeNet's flipped bit quarantined."""
    import tempfile

    from deeplearning4j_tpu_torch.common import faultinject, flightrec
    from deeplearning4j_tpu_torch.common import integrity
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.parallel import (ReduceScatterAccumulator,
                                                   TrainingSupervisor)

    t_phase = time.perf_counter()
    x, y = _sv_arrays(PW_BATCH * EL_BATCHES, SEED + 56)

    def make():
        return NDArrayDataSetIterator(x, y, batch_size=PW_BATCH)

    def loss_plan(at):
        return faultinject.FaultPlan([{"site": "device/loss", "index": at,
                                       "kind": "device_loss",
                                       "replica": 2}])

    out = {"workers": PW_WORKERS, "batch": PW_BATCH, "steps": EL_BATCHES}
    with _Deterministic(), tempfile.TemporaryDirectory(
            prefix="dl4j_el_") as tmp:
        # (a) the supervised shrink
        torch.cuda.empty_cache()
        m1 = train_model(dev, True, "bfloat16", None)
        pw1 = pw_wrapper(m1, dev, ReduceScatterAccumulator())
        count = _Losses()
        pw1.set_listeners(count)
        update.reset_launches()
        faultinject.set_plan(loss_plan(EL_LOSS_AT))
        try:
            res = TrainingSupervisor(pw1, os.path.join(tmp, "a"),
                                     elastic_grow=False).fit(make, epochs=1)
        finally:
            faultinject.clear_plan()
        torch.cuda.synchronize()
        launches = update.fused_update_launches
        want_l = (PW_WORKERS * EL_LOSS_AT
                  + (PW_WORKERS - 1) * (EL_BATCHES - EL_LOSS_AT))
        check(res.status == "completed" and res.restarts == 0
              and [h["policy"] for h in res.history]
              == ["shrink_and_continue"] and pw1.workers_count == 3,
              f"supervised shrink: {res} {res.history}, workers "
              f"{pw1.workers_count}")
        check(len(count.losses) == EL_BATCHES
              and all(np.isfinite(count.losses)) and launches == want_l,
              f"supervised shrink: losses {count.losses}, fused_update "
              f"launches {launches} (want {want_l}: one per replica per "
              f"step)")
        pw1.shutdown()
        del pw1
        # (b) by hand to the same boundary, then a fresh 3-replica wrapper
        m2 = train_model(dev, True, "bfloat16", None)
        pw2 = pw_wrapper(m2, dev, ReduceScatterAccumulator())
        faultinject.set_plan(loss_plan(EL_LOSS_AT))
        try:
            pw2.fit(make(), epochs=1)
            check(False, "the device loss did not fire")
        except faultinject.DeviceLostError:
            pass
        finally:
            faultinject.clear_plan()
        cursor = (m2._epoch - m2._fit_epoch0, m2._steps_in_epoch)
        pw2.shutdown()
        snap = (_tree_clone(m2._params), _tree_clone(m2._states),
                _tree_clone(m2._updater_state), m2._iteration, m2._epoch,
                m2.generator().get_state())
        del pw2, m2
        torch.cuda.empty_cache()
        m3 = train_model(dev, True, "bfloat16", None)
        (m3._params, m3._states, m3._updater_state, m3._iteration,
         m3._epoch, gen) = snap
        m3.generator().set_state(gen)
        pw3 = pw_wrapper(m3, dev, ReduceScatterAccumulator(), workers=3)
        pw3.fit(make(), epochs=1, resume_cursor=cursor)
        torch.cuda.synchronize()
        check(_same_bits(m1._params, m3._params)
              and _same_bits(m1._states, m3._states),
              "the shrunk run differs from a fresh 3-replica run resumed "
              "from the same state and cursor")
        out["shrink"] = {"cursor": list(cursor), "launches": launches,
                         "history": res.history, "bitwise": True}
        log(f"[supervised-elastic] ResNet-50, {PW_WORKERS} replicas on one "
            f"card, batch {PW_BATCH}, ZeRO-1: device/loss of replica 2 at "
            f"dispatch {EL_LOSS_AT} -> shrink_and_continue to 3 replicas in "
            f"memory from cursor {cursor}, no restart; the {EL_BATCHES - EL_LOSS_AT} "
            f"steps after it bitwise a fresh 3-replica wrapper resumed from "
            f"the same state; fused_update launches {launches}; {smi}")
        pw3.shutdown()
        del pw3, m3, m1, snap
        torch.cuda.empty_cache()
        # (c) the grow-back
        m4 = train_model(dev, True, "bfloat16", None)
        pw4 = pw_wrapper(m4, dev, ReduceScatterAccumulator())
        count = _Count()
        pw4.set_listeners(count)
        faultinject.set_plan(loss_plan(EL_GROW_LOSS_AT))
        try:
            res = TrainingSupervisor(pw4, os.path.join(tmp, "c"),
                                     elastic_grow=True,
                                     grow_probe_base_s=0.0,
                                     poll_s=0.01).fit(make, epochs=1)
        finally:
            faultinject.clear_plan()
        pols = [h["policy"] for h in res.history]
        check(res.status == "completed" and res.restarts == 0
              and pols[0] == "shrink_and_continue"
              and "grow_and_continue" in pols
              and pw4.workers_count == PW_WORKERS and count.n == EL_BATCHES,
              f"grow-back: {res} policies {pols}, workers "
              f"{pw4.workers_count}, steps {count.n}")
        out["grow_back"] = {"policies": pols, "steps": count.n}
        log(f"[supervised-elastic] grow-back: device/loss at dispatch "
            f"{EL_GROW_LOSS_AT}, shrunk to 3, the probe found the slot "
            f"healthy and the wrapper grew back to {PW_WORKERS} at the next "
            f"boundary; {count.n} steps, none lost or doubled; {smi}")
        pw4.shutdown()
        del pw4, m4
        torch.cuda.empty_cache()
        # (d) LeNet: a flipped bit quarantined
        model = lenet_pw_model(dev)
        pw = pw_wrapper(model, dev)
        lst = integrity.IntegrityListener(check_every=1)
        pw.set_listeners(lst)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "integrity/fingerprint", "index": 5,
              "kind": "bitflip", "replica": 2, "bit": 12, "offset": 7}]))
        try:
            res = TrainingSupervisor(pw, os.path.join(tmp, "d"),
                                     elastic_grow=False).fit(
                lambda: lenet_pw_data(LENET_PW_STEPS), epochs=2)
        finally:
            faultinject.clear_plan()
        q = flightrec.events("integrity/quarantine")
        check(res.status == "completed" and res.restarts == 0
              and [(h["class"], h["policy"]) for h in res.history]
              == [("silent_corruption", "quarantine_and_continue")]
              and pw.workers_count == 3 and q
              and q[-1]["attrs"]["replica"] == 2
              and lst.divergences and lst.divergences[0]["replica"] == 2,
              f"quarantine drill: {res} {res.history}, workers "
              f"{pw.workers_count}, divergences {lst.divergences}")
        out["quarantine"] = {"replica": 2, "history": res.history}
        log(f"[supervised-elastic] LeNet, 4 replicas: bit 12 of replica 2 "
            f"flipped before iteration 6; the check named replica "
            f"{lst.divergences[0]['replica']}; quarantine_and_continue on 3 "
            f"replicas, no restart; {smi}")
        pw.shutdown()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_supervised_pipeline(smi: str, dev) -> dict:
    """Phase 57: phase 49's stack under the supervisor: a lost stage
    remapped (4 -> 3) bitwise a fresh 3-stage run; a 2-stage pipeline's
    loss refused by the gate and healed by checkpoint-restart."""
    import tempfile

    from deeplearning4j_tpu_torch.common import faultinject
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import attention
    from deeplearning4j_tpu_torch.parallel import (PipelineTrainer,
                                                   TrainingSupervisor)

    t_phase = time.perf_counter()
    hidden, heads = BERT["hidden"], BERT["heads"]
    conf = attention_stack_conf(PP_BLOCKS, hidden, heads, SEQ_LEN,
                                Adam(PP_LR), "bfloat16")
    rng = np.random.RandomState(SEED + 57)
    n = PR_STEPS * PP_BATCH
    x = rng.randn(n, SEQ_LEN, hidden).astype(np.float32)
    y = (rng.randn(n, SEQ_LEN, hidden) * 0.5).astype(np.float32)

    def make(steps=PR_STEPS):
        k = steps * PP_BATCH
        return NDArrayDataSetIterator(x[:k], y[:k], batch_size=PP_BATCH)

    def stage_loss(at):
        return faultinject.FaultPlan([{"site": "pipeline/stage",
                                       "index": at, "kind": "device_loss",
                                       "stage": 1}])

    per_step = PP_BLOCKS * PP_MICRO * 2
    prof = OpProfiler.get()
    out = {"stages": PP_STAGES, "micro": PP_MICRO, "steps": PR_STEPS}
    with _Deterministic(), tempfile.TemporaryDirectory(
            prefix="dl4j_pr_") as tmp:
        # (a) the supervised remap
        model = MultiLayerNetwork(conf).init(seed=SEED, device=dev)
        tr = PipelineTrainer(model, PP_STAGES, PP_MICRO,
                             devices=[CARD] * PP_STAGES)
        clock = _PipeClock()
        tr.set_listeners(clock)
        prof.reset()
        _reset_kernel_counts()
        faultinject.set_plan(stage_loss(PR_LOSS_AT))
        try:
            res = TrainingSupervisor(tr, os.path.join(tmp, "a"),
                                     elastic_grow=False).fit(make, epochs=1)
        finally:
            faultinject.clear_plan()
        torch.cuda.synchronize()
        launches = attention.flash_attention_launches
        bf16 = prof.counter_value("attention/flash_bf16")
        micro = prof.counter_value("pipeline/microbatches")
        check(res.status == "completed" and res.restarts == 0
              and [h["policy"] for h in res.history]
              == ["remap_and_continue"] and tr.stages_count == 3,
              f"supervised remap: {res} {res.history}, stages "
              f"{tr.stages_count}")
        check(len(clock.losses) == PR_STEPS and micro == PR_STEPS * PP_MICRO,
              f"microbatches lost: {len(clock.losses)} steps, {micro} "
              f"microbatches (want {PR_STEPS} and {PR_STEPS * PP_MICRO})")
        check(launches == bf16 == per_step * PR_STEPS,
              f"flash launches {launches} (bf16 route {bf16}), want "
              f"{per_step} a step")
        # (b) by hand to the same boundary, then a fresh 3-stage run
        ref = MultiLayerNetwork(conf).init(seed=SEED, device=dev)
        rtr = PipelineTrainer(ref, PP_STAGES, PP_MICRO,
                              devices=[CARD] * PP_STAGES)
        faultinject.set_plan(stage_loss(PR_LOSS_AT))
        try:
            rtr.fit(make(), epochs=1)
            check(False, "the stage loss did not fire")
        except faultinject.DeviceLostError:
            pass
        finally:
            faultinject.clear_plan()
        cursor = (ref._epoch - ref._fit_epoch0, ref._steps_in_epoch)
        fresh = MultiLayerNetwork(conf).init(seed=SEED, device=dev)
        fresh._params = _tree_clone(ref._params)
        fresh._updater_state = _tree_clone(ref._updater_state)
        fresh._iteration, fresh._epoch = ref._iteration, ref._epoch
        rtr.shutdown()
        del rtr, ref
        tr3 = PipelineTrainer(fresh, PP_STAGES - 1, PP_MICRO,
                              devices=[CARD] * (PP_STAGES - 1))
        c3 = _PipeClock()
        tr3.set_listeners(c3)
        tr3.fit(make(), epochs=1, resume_cursor=cursor)
        torch.cuda.synchronize()
        check(clock.losses[PR_LOSS_AT:] == c3.losses
              and _same_bits(model._params, fresh._params),
              f"the remapped run's losses {clock.losses[PR_LOSS_AT:]} are "
              f"not bitwise a fresh 3-stage run's {c3.losses}")
        out["remap"] = {"cursor": list(cursor), "losses": clock.losses,
                        "flash_launches": launches,
                        "flash_launches_per_step": launches / PR_STEPS,
                        "step_ms": clock.ms, "history": res.history}
        log(f"[supervised-pipeline] {PP_BLOCKS} x SelfAttentionLayer("
            f"{hidden}, {heads} heads), T {SEQ_LEN}, batch {PP_BATCH}, bf16, "
            f"{PP_STAGES} stages x {PP_MICRO} microbatches on one card: "
            f"pipeline/stage loss of stage 1 at dispatch {PR_LOSS_AT} -> "
            f"remap_and_continue to 3 stages, no restart, {micro} "
            f"microbatches in {PR_STEPS} steps (none lost); the losses after "
            f"the remap bitwise a fresh 3-stage run's from cursor {cursor}; "
            f"bf16 flash launches {launches} ({launches / PR_STEPS:g} a "
            f"step); {smi}")
        tr.shutdown()
        tr3.shutdown()
        del tr, tr3, model, fresh
        torch.cuda.empty_cache()
        # (c) the refused remap: 2 stages, one lost
        model = MultiLayerNetwork(conf).init(seed=SEED, device=dev)
        tr = PipelineTrainer(model, 2, PP_MICRO, devices=[CARD] * 2)
        clock = _PipeClock()
        tr.set_listeners(clock)
        faultinject.set_plan(stage_loss(PR_REFUSED_AT))
        try:
            res = TrainingSupervisor(tr, os.path.join(tmp, "c"),
                                     backoff_base_s=0.05,
                                     elastic_grow=False).fit(
                lambda: make(PR_REFUSED_STEPS), epochs=1)
        finally:
            faultinject.clear_plan()
        ref = MultiLayerNetwork(conf).init(seed=SEED, device=dev)
        rtr = PipelineTrainer(ref, 2, PP_MICRO, devices=[CARD] * 2)
        rc = _PipeClock()
        rtr.set_listeners(rc)
        rtr.fit(make(PR_REFUSED_STEPS), epochs=1)
        torch.cuda.synchronize()
        check(res.status == "completed" and res.restarts == 1
              and [h["policy"] for h in res.history] == ["restart"]
              and tr.stages_count == 2
              and clock.losses[-PR_REFUSED_STEPS:] == rc.losses
              and _same_bits(model._params, ref._params),
              f"refused remap: {res} {res.history}, stages "
              f"{tr.stages_count}, losses {clock.losses} vs {rc.losses}")
        out["refused"] = {"history": res.history}
        log(f"[supervised-pipeline] 2 stages, stage 1 lost at dispatch "
            f"{PR_REFUSED_AT}: one survivor is below the remap gate -> "
            f"checkpoint-restart from the anchor; healed bitwise the "
            f"uninterrupted 2-stage run; {smi}")
        tr.shutdown()
        rtr.shutdown()
        del tr, rtr, model, ref
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _params_sha(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(model._params):
        for n in sorted(model._params[k]):
            t = model._params[k][n].detach().contiguous()
            h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


class _GatherClock:
    """Each step's milliseconds in the process group's exchange, by part
    (the route's running totals at each step's end; the wrapper is the
    model's ``_parallel``): ``drain`` (the card finishing this rank's
    queued forward and backward), ``stage`` (gloo's copies through host
    memory), ``wait`` (a one-element all_gather: the wait for the peer),
    ``transport`` (the payload's all_gather)."""

    PARTS = ("drain", "stage", "wait", "transport")

    def __init__(self):
        self.totals = [dict.fromkeys(self.PARTS, 0.0)]

    def iteration_done(self, model, iteration, score):
        route = model._parallel._route
        self.totals.append({p: getattr(route, p + "_seconds")
                            for p in self.PARTS})

    def step_ms(self) -> dict:
        return {p: [(b[p] - a[p]) * 1e3
                    for a, b in zip(self.totals, self.totals[1:])]
                for p in self.PARTS}


def group_worker(argv) -> int:
    """One rank of phase 58 (``chip_smoke.py --group-worker <run dir>
    <rank> <token>``): ResNet-50 through SharedTrainingMaster over the
    process group the environment names, a group checkpoint every
    ``PG_EVERY`` steps; the result goes to ``<run dir>/result-a<attempt>-
    r<rank>.json``."""
    run_dir, rank = argv[0], int(argv[1])
    os.environ["DL4J_TPU_PROC_ID"] = str(rank)
    if not torch.cuda.is_available():
        print(f"group worker {rank}: no CUDA card", file=sys.stderr)
        return 3
    from deeplearning4j_tpu_torch.common import faultinject
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.parallel import (SharedTrainingMaster,
                                                   distributed)

    attempt = int(os.environ.get("DL4J_ATTEMPT", "0"))
    rt = distributed.initialize(init_deadline_s=60.0)
    dev = rt.device
    if dev.type != "cuda":
        print(f"group worker {rank}: formed on {dev}", file=sys.stderr)
        return 3
    plan = os.environ.get("DL4J_SMOKE_FAULT_PLAN")
    if plan and os.environ.get("DL4J_SMOKE_FAULT_RANK") == str(rank):
        faultinject.set_plan(faultinject.FaultPlan.from_json(plan))
    x, y = _sv_arrays(PG_STEPS * PG_BATCH, SEED + 58 + rank)
    with _Deterministic():
        model = train_model(dev, True, "bfloat16", "bfloat16")
        clock = _StepClock(dev)
        gathers = _GatherClock()
        model.set_listeners(clock, gathers)
        update.reset_launches()
        master = (SharedTrainingMaster.Builder(PG_BATCH)
                  .checkpoint(os.environ["DL4J_SMOKE_CKPT"], PG_EVERY)
                  .build())
        t0 = time.perf_counter()
        master.fit(model, NDArrayDataSetIterator(x, y, batch_size=PG_BATCH),
                   epochs=1)
        torch.cuda.synchronize()
    route = master.wrapper._route
    res = {"rank": rank, "attempt": attempt, "device": str(dev),
           "kind": torch.cuda.get_device_name(dev), "backend": rt.backend,
           "world": rt.world, "status": master.last_result.status,
           "iteration": int(model._iteration), "steps": len(clock.t),
           "launches": update.fused_update_launches,
           "step_ms": _step_ms(clock, t0), "gather_s": route.seconds,
           "gather_ms": gathers.step_ms(), "gather_calls": route.calls,
           "params_sha": _params_sha(model)}
    with open(os.path.join(run_dir, f"result-a{attempt}-r{rank}.json"),
              "w") as f:
        json.dump(res, f)
    distributed.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _orphans(token: str) -> list:
    """Processes whose command line holds ``token`` (this one aside)."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if token.encode() in f.read():
                    found.append(int(pid))
        except OSError:
            continue
    return found


def phase_process_group(smi: str, dev) -> dict:
    """Phase 58: two ranks on the card over gloo under supervise_processes
    (see the module docstring)."""
    import tempfile

    from deeplearning4j_tpu_torch.parallel import cluster
    from deeplearning4j_tpu_torch.parallel.distributed import (
        supervise_processes)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    token = f"dl4j-pg-{os.getpid()}-{time.time_ns()}"
    script = os.path.abspath(__file__)
    out = {"world": PG_WORLD, "batch_per_rank": PG_BATCH,
           "steps": PG_STEPS, "every": PG_EVERY}
    with tempfile.TemporaryDirectory(prefix="dl4j_pg_") as tmp:
        def run(name, fault):
            run_dir = os.path.join(tmp, name)
            os.makedirs(run_dir)

            def make_env(attempt):
                e = {"DL4J_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
                     "DL4J_TPU_NUM_PROCS": str(PG_WORLD),
                     "DL4J_TPU_CLUSTER_DIR": os.path.join(run_dir, "cd"),
                     "DL4J_TPU_COLLECTIVE_TIMEOUT_S": "120",
                     "DL4J_ATTEMPT": str(attempt),
                     "DL4J_SMOKE_CKPT": os.path.join(run_dir, "ck")}
                if fault and attempt == 0:
                    e["DL4J_SMOKE_FAULT_RANK"] = "1"
                    e["DL4J_SMOKE_FAULT_PLAN"] = json.dumps(
                        [{"site": "train/step", "index": PG_CRASH_ORDINAL,
                          "kind": "crash", "mode": "exit", "code": 1}])
                return e

            t0 = time.perf_counter()
            summary = supervise_processes(
                [[sys.executable, script, "--group-worker", run_dir, str(r),
                  token] for r in range(PG_WORLD)],
                make_env=make_env, max_restarts=2 if fault else 0,
                backoff_base_s=1.0, kill_grace_s=10.0,
                storm_min_uptime_s=0.0,
                cluster_dir=os.path.join(run_dir, "cd"),
                heartbeat_stale_s=120.0, timeout_s=400.0)
            wall = time.perf_counter() - t0
            last = summary["attempts"] - 1
            results = []
            for r in range(PG_WORLD):
                path = os.path.join(run_dir, f"result-a{last}-r{r}.json")
                check(os.path.exists(path), f"{name}: rank {r} left no "
                      f"result (summary {summary})")
                with open(path) as f:
                    results.append(json.load(f))
            return summary, results, wall, run_dir

        base, bres, bwall, _ = run("uninterrupted", False)
        check(base["status"] == "completed" and base["restarts"] == 0,
              f"uninterrupted group: {base}")
        sup, sres, swall, sdir = run("restarted", True)
        check(sup["status"] == "completed" and sup["restarts"] == 1
              and sup["history"][0]["failed_rank"] == 1
              and sup["history"][0]["classes"][1] == "crash",
              f"restarted group: {sup}")
        for r, (b, s) in enumerate(zip(bres, sres)):
            check(b["kind"] == s["kind"] and "cuda" in b["device"]
                  and b["backend"] == s["backend"] == "gloo",
                  f"rank {r}: {b['device']} {b['backend']}, {s['device']} "
                  f"{s['backend']}")
            check(b["status"] == s["status"] == "completed"
                  and b["iteration"] == s["iteration"] == PG_STEPS,
                  f"rank {r}: {b['status']} at {b['iteration']}, "
                  f"{s['status']} at {s['iteration']}")
            check(b["launches"] == b["steps"] == PG_STEPS
                  and s["launches"] == s["steps"] == PG_STEPS - PG_EVERY,
                  f"rank {r}: fused_update launches {b['launches']} in "
                  f"{b['steps']} steps, after the restart {s['launches']} "
                  f"in {s['steps']} (want one a step)")
        shas = {r["params_sha"] for r in bres + sres}
        check(len(shas) == 1, f"final parameters differ: {shas}")
        # the barrier diagnosis over the finished group's heartbeats
        rt0 = cluster.ClusterRuntime(os.path.join(sdir, "cd"), 0, PG_WORLD)
        try:
            rt0.barrier("drill", deadline_s=1.0)
            check(False, "the barrier did not time out")
        except cluster.BarrierTimeout as e:
            check(e.missing == [1] and e.staleness.get(1) is not None
                  and "rank 1: heartbeat" in str(e),
                  f"barrier diagnosis: {e}")
            barrier_msg = str(e)
        # a dead coordinator: the whole diagnosis inside the deadline
        cd2 = os.path.join(tmp, "dead")
        port = _free_port()
        rt1 = cluster.ClusterRuntime(cd2, 1, PG_WORLD,
                                     coordinator=f"127.0.0.1:{port}",
                                     init_deadline_s=3.0)
        t0 = time.perf_counter()
        try:
            rt1.form()
            check(False, "a dead coordinator formed a group")
        except cluster.ClusterInitError as e:
            dead_s = time.perf_counter() - t0
            check(dead_s < 3.0 + 5.0 and f"127.0.0.1:{port}" in str(e)
                  and "ranks that reported a heartbeat: [1]" in str(e),
                  f"dead coordinator after {dead_s:.1f} s: {e}")
            dead_msg = str(e)
        finally:
            rt1.shutdown()
        orphans = _orphans(token)
        check(not orphans, f"orphan processes of the run: {orphans}")
    # steady steps: after the first (launch setup, the peers' start) and
    # without a group commit (a synchronous snapshot and write, timed into
    # the step after the commit's iteration: the clock hears of a step
    # before the checkpoint listener)
    steady = [i for i in range(1, PG_STEPS) if i % PG_EVERY]
    ms = [bres[0]["step_ms"][i] for i in steady]
    parts = {p: statistics.median(bres[0]["gather_ms"][p][i]
                                  for i in steady)
             for p in _GatherClock.PARTS}
    # the exchange proper: the staging copies, the wait for the peer and
    # the all_gather (the drain is this rank's own work finishing)
    g_ms = [sum(bres[0]["gather_ms"][p][i]
                for p in ("stage", "wait", "transport")) for i in steady]
    gather_share = statistics.median(g_ms) / statistics.median(ms)
    commit_ms = [bres[0]["step_ms"][i] for i in range(1, PG_STEPS)
                 if not i % PG_EVERY]
    out.update({
        "uninterrupted": {"wall_s": bwall, "ranks": bres},
        "restarted": {"wall_s": swall, "ranks": sres,
                      "history": sup["history"]},
        "params_bitwise": True, "step_ms_median": statistics.median(ms),
        "gather_ms_median": statistics.median(g_ms),
        "gather_parts_ms_median": parts,
        "commit_step_ms": commit_ms, "first_step_ms": bres[0]["step_ms"][0],
        "gather_share": gather_share, "barrier": barrier_msg,
        "dead_coordinator": dead_msg, "dead_coordinator_s": dead_s,
        "orphans": 0, "seconds": time.perf_counter() - t_phase})
    log(f"[process-group] ResNet-50, {PG_WORLD} ranks on one card over "
        f"gloo, batch {PG_BATCH} a rank, {PG_STEPS} steps, a group commit "
        f"every {PG_EVERY}: uninterrupted {bwall:.1f} s; rank 1 exited at "
        f"step {PG_CRASH_ORDINAL + 1}, the group was reaped and relaunched "
        f"from the step-{PG_EVERY} commit ({swall:.1f} s); final parameters "
        f"bitwise the uninterrupted group's on both ranks; fused_update one "
        f"launch a rank a step; rank 0's steady steps (2-{PG_STEPS} "
        f"without a commit) median {statistics.median(ms):.2f} ms, the "
        f"exchange {statistics.median(g_ms):.2f} ms of it "
        f"({gather_share:.3f}: staging {parts['stage']:.2f} ms, the wait "
        f"for the peer {parts['wait']:.2f} ms, all_gather "
        f"{parts['transport']:.2f} ms), and before it the drain of this "
        f"rank's queued work {parts['drain']:.2f} ms; the steps with a "
        f"group commit "
        f"{', '.join(f'{v:.1f}' for v in commit_ms)} ms; the first "
        f"{bres[0]['step_ms'][0]:.1f} ms; {smi}")
    log(f"[process-group] barrier: {barrier_msg}")
    log(f"[process-group] dead coordinator ({dead_s:.2f} s): {dead_msg}")
    log(f"[process-group] no process of the run survived (token {token})")
    return out


# --- phases 59-61: observability ---------------------------------------------
OB_BATCH = 32                 # bench.py's resnet50 batch per card
OB_STEPS = 10
OB_COLLECT = 4                # StatsListener's cadence in the steady region
OB_CPU_BATCH = 2              # the CPU flop count's batch
OB_TURNS = 5                  # census on and off, alternating, five each
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
OB_CLIENTS = 4                # the steady closed-loop burst
OB_REQS = 10                  # requests a client
# the burst SLO's rolling p99 window: long enough to hold a gold answer
# while slowed dispatches land one a slot every OB_SLOW_S, so the reading
# (from one answer up) stays bad through the burst and its drain
OB_P99_WINDOW_S = 2.0
# ... and its ceiling: far above a closed loop's tail (phase 43 prints its
# p99; one slow answer in a window is that window's p99, and it pages), so
# steady load on a slower host stays clear of it
OB_P99_MS = 1000.0
# the overload's injected dispatch delay, longer than the ceiling: every
# answer of the burst waits out one such dispatch, so the page fires
# whatever the host's speed
OB_SLOW_S = 1.2
OB_BURST_S = 1.5
OB_CLEAR = 3                  # clear_ticks of every SLO of phase 60
OB_CRASH_AT = 3               # phase 61's crash, a dispatch ordinal


def phase_observed_fit(smi: str, dev) -> dict:
    """Phase 59: ResNet-50 trained as bench.py trains it, under the
    executable census and a steady-state region (see the module
    docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.common import flightrec, tracecheck, xprof
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, StatsListener

    t_phase = time.perf_counter()
    out = {"batch": OB_BATCH, "steps": OB_STEPS}
    # the flops of the same step on the CPU at batch 2, counted apart from
    # the census (it is off for this fit)
    xprof.configure(enabled=False)
    try:
        cpu = torch.device("cpu")
        cm = train_model(cpu, True, "bfloat16", "bfloat16")
        ds2 = synthetic_batch(OB_CPU_BATCH, cpu, SEED + 59)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            cm.fit(ds2, batch_size=OB_CPU_BATCH)
        cpu_flops = int(fc.get_total_flops())
        cpu_s = time.perf_counter() - t0
        del cm, ds2
    finally:
        xprof.configure(enabled=True)
    check(cpu_flops > 0, "FlopCounterMode counted no flops on the CPU")

    xprof.reset()
    flightrec.reset()
    prof = OpProfiler.get()
    prof.reset()
    torch.cuda.empty_cache()
    model = train_model(dev, True, "bfloat16", "bfloat16")
    storage = InMemoryStatsStorage()
    model.set_listeners(StatsListener(storage, collect_every_n=OB_COLLECT,
                                      collect_timing=False))
    ds = synthetic_batch(OB_BATCH, dev, SEED + 59)
    # every count set to 0 just before the path is driven
    _reset_kernel_counts()
    model.fit(ds, batch_size=OB_BATCH)
    first = xprof.census()["graph/fit_step"]
    check(first["generations"] == 1 and first["calls"] == 1,
          f"graph/fit_step after the first step: {first}")
    model.fit(ds, batch_size=OB_BATCH)
    with tracecheck.steady_state(
            "observed fit, steps 3-10",
            max_host_syncs=(OB_STEPS - 2) // OB_COLLECT) as region:
        for _ in range(OB_STEPS - 2):
            model.fit(ds, batch_size=OB_BATCH)
    torch.cuda.synchronize()
    launches = update.fused_update_launches
    rep = region.report()
    census = xprof.census()
    fit_row, upd_row = census["graph/fit_step"], census["pallas/update_bucket"]
    check(fit_row["generations"] == 1 and fit_row["calls"] == OB_STEPS,
          f"graph/fit_step after {OB_STEPS} steps: {fit_row}")
    check(launches == OB_STEPS,
          f"fused_update launched {launches} times in {OB_STEPS} steps")
    want_bytes = 16 * RESNET50_PARAMS   # p, g read, p written (f32), v r/w
    check(upd_row["cost"] == {"flops": 5.0 * RESNET50_PARAMS,
                              "bytes_accessed": float(want_bytes)}
          and upd_row["calls"] == OB_STEPS,
          f"pallas/update_bucket {upd_row} (want {want_bytes} bytes)")
    check(rep["compiles"] == 0 and not rep["counter_deltas"]
          and rep["readbacks"] == (OB_STEPS - 2) // OB_COLLECT
          and rep["sync_warnings"] <= rep["readbacks"],
          f"steady region: {rep}")
    gpu_flops = int(fit_row["cost"]["flops"])
    ratio = OB_BATCH // OB_CPU_BATCH
    check(gpu_flops == ratio * cpu_flops,
          f"the census counted {gpu_flops} flops a step at batch "
          f"{OB_BATCH}; FlopCounterMode on the CPU at batch {OB_CPU_BATCH} "
          f"{cpu_flops} (x{ratio} = {ratio * cpu_flops})")
    out.update(census_fit=fit_row, census_update=upd_row,
               launches=launches, region=rep, cpu_flops=cpu_flops,
               cpu_flop_count_s=cpu_s)
    log(f"[observed-fit] {OB_STEPS} steps at batch {OB_BATCH}: "
        f"graph/fit_step {fit_row['calls']} calls, 1 generation (first "
        f"call {fit_row['compile_s']:.3f} s, counted); "
        f"pallas/update_bucket {upd_row['cost']['bytes_accessed']:.0f} B "
        f"and {upd_row['cost']['flops']:.0f} flops a launch, "
        f"{launches} fused_update launches; steps 3-10 steady: 0 compiles, "
        f"no trace/* delta, {rep['sync_warnings']} synchronizing CUDA calls "
        f"against {rep['readbacks']} counted readbacks; {gpu_flops} flops a "
        f"step = {ratio} x {cpu_flops} on the CPU at batch {OB_CPU_BATCH} "
        f"({cpu_s:.1f} s)")

    # the census's cost, in turns: on against off, one fenced step each
    model.set_listeners()
    turns = {True: [], False: []}
    host = {True: [], False: []}
    for k in range(2 * OB_TURNS):
        on = k % 2 == 0
        xprof.configure(enabled=on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(ds, batch_size=OB_BATCH)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        turns[on].append((t2 - t0) * 1e3)
        host[on].append((t1 - t0) * 1e3)
    xprof.configure(enabled=True)
    med = {on: statistics.median(v) for on, v in turns.items()}
    hmed = {on: statistics.median(v) for on, v in host.items()}
    # the census's own cost a dispatch (host time): a no-op through a
    # census wrapper against the bare call on one card tensor, and one
    # memory watermark (a fit's per-epoch sample), each in turns, on a
    # census of their own so the phase's rows stay as they are
    probe = torch.zeros(OB_BATCH, device=dev)
    side = xprof.ExecutableCensus()
    bare = lambda t: t  # noqa: E731
    wrapped = side.register_jit("graph/fit_step", bare)
    per = {True: [], False: []}
    wm_us = []
    for k in range(2 * OB_TURNS):
        f = wrapped if k % 2 == 0 else bare
        t0 = time.perf_counter()
        for _ in range(1000):
            f(probe)
        per[k % 2 == 0].append((time.perf_counter() - t0) * 1e3)
        if k % 2 == 0:
            t0 = time.perf_counter()
            side.memory_watermark("probe")
            wm_us.append((time.perf_counter() - t0) * 1e6)
    dispatch_us = statistics.median(per[True]) - statistics.median(
        per[False])
    out.update(census_dispatch_us=dispatch_us,
               watermark_us=statistics.median(wm_us))
    xprof.note_measured("graph/fit_step", med[True] / 1e3)
    row = xprof.roofline()["graph/fit_step"]
    mfu = row.get("mfu", 0.0)
    out.update(step_ms_census_on=turns[True], step_ms_census_off=turns[False],
               host_ms_census_on=host[True], host_ms_census_off=host[False],
               roofline=row)
    log(f"[observed-fit] the census in turns (on, off x {OB_TURNS}): fenced "
        f"step median {med[True]:.3f} ms on "
        f"[{min(turns[True]):.3f}-{max(turns[True]):.3f}], "
        f"{med[False]:.3f} ms off "
        f"[{min(turns[False]):.3f}-{max(turns[False]):.3f}]; the "
        f"fit call's host time {hmed[True]:.3f} ms on, {hmed[False]:.3f} ms "
        f"off; the wrapper alone {dispatch_us:.2f} us a dispatch, one "
        f"memory watermark {statistics.median(wm_us):.1f} us (medians of "
        f"{OB_TURNS} turns each); {smi}")
    log(f"[observed-fit] roofline graph/fit_step: {row['step_s'] * 1e3:.3f} "
        f"ms fenced, {fit_row['cost']['flops']:.4g} flops (aten operators, "
        f"counted on the first call), "
        f"{row.get('effective_flops_per_s', 0):.4g} flop/s, MFU {mfu:.4f} "
        f"against {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s "
        f"(bf16 peak), arithmetic intensity "
        f"{row.get('arithmetic_intensity', 0):.1f} ({row.get('bound')}); "
        f"{smi}")

    # a new batch size inside a region: a new generation, a violation
    ds16 = synthetic_batch(OB_BATCH // 2, dev, SEED + 60)
    raised = None
    try:
        with tracecheck.steady_state("observed fit, a new batch size"):
            model.fit(ds16, batch_size=OB_BATCH // 2)
    except tracecheck.SteadyStateViolation as e:
        raised = e
    check(raised is not None and raised.report["compiles"] >= 1,
          "a batch of 16 inside a steady-state region raised nothing")
    check(any(e["attrs"]["label"] == "observed fit, a new batch size"
              for e in flightrec.events("tracecheck/violation")),
          "no tracecheck/violation event")
    torch.cuda.synchronize()
    wm = xprof.watermarks().get("fit", {})
    peak = torch.cuda.max_memory_allocated(dev)
    check(0 < wm.get("peak_live_bytes", 0) <= peak,
          f"fit watermark {wm} against max_memory_allocated {peak}")
    out.update(violation=str(raised).splitlines()[0], watermark=wm,
               max_memory_allocated=peak)
    log(f"[observed-fit] a batch of {OB_BATCH // 2} in a region: "
        f"{str(raised).splitlines()[0]}; fit watermark peak "
        f"{wm['peak_live_bytes']} B over {wm['samples']} samples (the "
        f"allocator's peak {peak} B)")
    del model, ds, ds16
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _ob_get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read()


def phase_observed_serving(smi: str, dev) -> dict:
    """Phase 60: ResNet-50 behind ServingEngine as in phase 43, under the
    census, a steady-state region and the SLO watchtower (see the module
    docstring)."""
    import json as _json
    import tempfile

    from deeplearning4j_tpu_torch.common import (faultinject, flightrec,
                                                 tracecheck, watchtower, xprof)
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.common.watchtower import (
        OK, PAGE, SLO, Watchtower, threshold_sampler)
    from deeplearning4j_tpu_torch.ops import epilogue
    from deeplearning4j_tpu_torch.parallel import ServingEngine
    from deeplearning4j_tpu_torch.ui import UIServer

    t_phase = time.perf_counter()
    prof = OpProfiler.get()
    faultinject.clear_plan()
    port_log = logging.getLogger("deeplearning4j_tpu_torch")
    log_level = port_log.level
    port_log.setLevel(logging.ERROR)
    flightrec.configure(capacity=1 << 17)
    flightrec.reset()
    xprof.reset()
    model = build_model(dev)
    set_fused(model, True)
    model.conf.global_conf.compute_dtype = "bfloat16"
    rng = np.random.default_rng(SEED + 60)
    images = rng.normal(size=(SV_REQ_MAX, 3, IMAGE, IMAGE)).astype(
        np.float32)
    tmp = tempfile.TemporaryDirectory(prefix="dl4j_observed_")
    eng = tower = ui = None
    out = {}
    try:
        # every count set to 0 just before the path is driven
        prof.reset()
        _reset_kernel_counts()
        eng = (ServingEngine.Builder(model).buckets(SV_LADDER)
               .input_shape((3, IMAGE, IMAGE)).workers(SV_SLOTS)
               .max_wait_ms(2).bf16(True).pin_devices(True)
               .devices([dev] * SV_SLOTS).queue_limit(1024)
               .request_timeout_ms(120_000).slo_classes(_sv_classes())
               .brownout(interval_s=0.1, depth_trigger=32, clear_ticks=5)
               .build())
        n_exec = len(SV_LADDER) * SV_SLOTS
        row = xprof.census()["serving/bucket"]
        wm = xprof.watermarks().get("serving_warmup", {})
        check(row["variants"] == row["generations"] == n_exec
              and row["fingerprint"]["last_variant"].endswith(
                  f"/dev{SV_SLOTS - 1}"),
              f"serving/bucket after warmup: {row} (want {n_exec} "
              f"variants, one a (shape, slot))")
        check(wm.get("samples", 0) >= 1 and wm.get("peak_live_bytes", 0) > 0,
              f"serving_warmup watermark {wm}")
        log(f"[observed-serving] warmup: serving/bucket {row['variants']} "
            f"variants (buckets x slots), first forwards "
            f"{row['compile_s']:.3f} s, {row['cost'].get('flops', 0):.4g} "
            f"aten flops over the ladder (bn_act not counted); "
            f"serving_warmup watermark {wm['peak_live_bytes']} B")

        burst = SLO("latency-burst", threshold_sampler(
            lambda: eng.class_recent_p99("gold", window_s=OB_P99_WINDOW_S,
                                         min_samples=1),
            OB_P99_MS), budget=0.1, fast_s=1.0, mid_s=2.0, slow_s=4.0,
            page_burn=2.0, warn_burn=1e9, clear_ticks=OB_CLEAR,
            period_s=10.0,
            description=f"gold rolling p99 under {OB_P99_MS:g} ms")
        slos = watchtower.default_slos(engine=eng, fast_s=1.0, mid_s=2.0,
                                       slow_s=4.0, period_s=10.0,
                                       clear_ticks=OB_CLEAR) + [burst]
        tower = watchtower.install(Watchtower(
            slos, interval_s=0.1,
            incident_dir=os.path.join(tmp.name, "incidents"))).start()
        ui = UIServer()
        port = ui.enable(0)

        # a closed-loop burst in steady state: no new generation, no
        # trace/serving_infer; the syncs allowed are a dispatch's two
        # copies (the request to the card from pageable memory, the answer
        # back), at most one dispatch a request
        gens0 = xprof.census()["serving/bucket"]["generations"]
        f0, bn0 = prof.counter_value("serving/forwards"), \
            epilogue.bn_act_launches
        errs, lats = [], []

        def client(k: int) -> None:
            r = np.random.RandomState(SEED + 600 + k)
            for _ in range(OB_REQS):
                t_req = time.monotonic()
                try:
                    eng.output(images[:int(r.randint(1, SV_REQ_MAX + 1))],
                               slo_class="gold")
                except Exception as e:          # counted, then gated
                    errs.append(repr(e))
                    return
                lats.append((time.monotonic() - t_req) * 1e3)

        n_req = OB_CLIENTS * OB_REQS
        t0 = time.monotonic()
        with tracecheck.steady_state("observed serving, closed loop",
                                     max_host_syncs=2 * n_req) as region:
            ts = [threading.Thread(target=client, args=(k,))
                  for k in range(OB_CLIENTS)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        wall = time.monotonic() - t0
        rep = region.report()
        lat_ms = (np.percentile(lats, [50, 99]).tolist() + [max(lats)]
                  if lats else [float("nan")] * 3)
        forwards = prof.counter_value("serving/forwards") - f0
        bn = epilogue.bn_act_launches - bn0
        check(not errs, f"closed-loop errors: {errs[:3]}")
        check(xprof.census()["serving/bucket"]["generations"] == gens0
              and rep["compiles"] == 0 and not rep["counter_deltas"],
              f"steady serving region: {rep}")
        check(forwards > 0 and bn == 53 * forwards,
              f"{bn} bn_act launches over {forwards} bucket forwards "
              f"(want 53 each)")
        check(tower.alert_states()["latency-burst"] == OK,
              f"the steady load tripped the burst SLO: "
              f"{tower.alert_states()}; its answers' p50/p99/max "
              f"{lat_ms} ms against the {OB_P99_MS:g} ms ceiling")
        out.update(steady_region=rep, steady_forwards=forwards,
                   bn_act_launches=bn, steady_wall_s=wall,
                   steady_p50_p99_max_ms=lat_ms)
        log(f"[observed-serving] steady closed loop ({OB_CLIENTS} clients x "
            f"{OB_REQS} gold requests of 1-8 images, {wall:.2f} s, answers "
            f"in {lat_ms[0]:.1f} / {lat_ms[1]:.1f} / {lat_ms[2]:.1f} ms "
            f"p50/p99/max against the {OB_P99_MS:g} ms ceiling): "
            f"{forwards} bucket forwards, {bn} bn_act launches (53 each), "
            f"no new generation, trace/serving_infer flat, "
            f"{rep['sync_warnings']} synchronizing CUDA calls (allowed "
            f"{2 * n_req}); {smi}")

        # the overload burst: a slow dispatch breaks the gold p99 SLO
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "serving/dispatch", "kind": "slow",
              "seconds": OB_SLOW_S, "times": 10 ** 6}]))
        result = {}
        bt = threading.Thread(target=lambda: result.update(over=_sv_poisson(
            eng, images, SV_OVERLOAD_RPS, OB_BURST_S, seed=60,
            classes=SV_CLASS_MIX)))
        t_burst = time.monotonic()
        bt.start()
        paged = None
        try:
            deadline = time.monotonic() + OB_BURST_S + 10.0
            while time.monotonic() < deadline:
                if tower.alert_states().get("latency-burst") == PAGE:
                    paged = time.monotonic() - t_burst
                    break
                time.sleep(0.02)
            check(paged is not None, f"the burst paged no alert: "
                  f"{tower.alert_states()}")
            # while it pages: the incident and the alert row over HTTP
            incs = [i for i in watchtower.incidents()
                    if i["slo"] == "latency-burst"]
            check(len(incs) == 1, f"incidents {watchtower.incidents()}")
            iid = incs[0]["id"]
            index = _json.loads(_ob_get(port, "/api/incidents"))
            check(any(i["id"] == iid for i in index),
                  f"/api/incidents lacks {iid}: {index}")
            rep_http = _json.loads(_ob_get(port, f"/api/incidents?id={iid}"))
            check(rep_http["slo"] == "latency-burst"
                  and rep_http["chain"]["detection"]["name"]
                  == "watchtower/alert",
                  f"incident {iid} over HTTP: {rep_http.get('chain')}")
            metrics = _ob_get(port, "/api/metrics").decode()
            check('dl4j_alert_state{slo="latency-burst"} 2' in metrics,
                  "/api/metrics has no paging dl4j_alert_state row")
            health = _json.loads(_ob_get(port, "/api/health"))
            li = health.get("last_incident") or {}
            check(li.get("id") in {i["id"] for i in watchtower.incidents()},
                  f"/api/health last_incident {li}")
        finally:
            bt.join()
            faultinject.clear_plan()
        over = result["over"]
        check(not over["fail"], f"burst failures: {over['fail'][:3]}")

        # the load stopped: with the evaluator stopped, manual ticks after
        # the p99 window has emptied clear the page on the clear_ticks-th
        tower.stop()
        time.sleep(OB_P99_WINDOW_S + 0.5)
        states = [tower.evaluate_now()["states"]["latency-burst"]["state"]
                  for _ in range(OB_CLEAR)]
        check(states == [PAGE] * (OB_CLEAR - 1) + [OK],
              f"the page cleared as {states} (want {OB_CLEAR - 1} held "
              f"ticks, then ok)")
        report = _json.loads(_ob_get(port, f"/api/incidents?id={iid}"))
        names = {k: (report["chain"][k] or {}).get("name") for k in
                 ("cause", "detection", "mitigation", "recovery")}
        check(names["cause"] == "fault/fired"
              and names["detection"] == "watchtower/alert",
              f"incident {iid}'s chain {names}")
        out.update(paged_after_s=paged, burst=over["shed"],
                   clear_states=states, incident=iid, chain=names,
                   complete=report["complete"],
                   incidents=len(tower.incidents()))
        log(f"[observed-serving] overload burst ({SV_OVERLOAD_RPS:.0f} "
            f"requests/s, +{OB_SLOW_S * 1e3:.0f} ms a dispatch, "
            f"{OB_BURST_S:g} s): latency-burst paged after {paged:.2f} s; "
            f"incident {iid} over /api/incidents and ?id=, "
            f"dl4j_alert_state row 2, /api/health last_incident; sheds "
            f"{over['shed']}; cleared on manual tick {OB_CLEAR} (states "
            f"{states}); chain {names} (complete: {report['complete']}); "
            f"{out['incidents']} incidents in all; {smi}")
    finally:
        faultinject.clear_plan()
        watchtower.uninstall()
        if ui is not None:
            ui.stop()
        if eng is not None:
            eng.shutdown()
        port_log.setLevel(log_level)
        tmp.cleanup()
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_observed_supervisor(smi: str, dev) -> dict:
    """Phase 61: phase 55's supervised ResNet-50 at a smaller depth, with
    a watchtower installed and a StatsListener into TensorBoard event
    files (see the module docstring)."""
    import glob
    import tempfile

    from deeplearning4j_tpu_torch.common import faultinject, watchtower, xprof
    from deeplearning4j_tpu_torch.common.watchtower import Watchtower
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresIterationListener)
    from deeplearning4j_tpu_torch.parallel import TrainingSupervisor
    from deeplearning4j_tpu_torch.ui import (StatsListener,
                                             TensorBoardStatsStorage,
                                             read_scalar_events)
    from deeplearning4j_tpu_torch.util import CrashReportingUtil

    t_phase = time.perf_counter()
    x, y = _sv_arrays(SV_BATCH * SV_BATCHES, SEED + 61)

    def make():
        return NDArrayDataSetIterator(x, y, batch_size=SV_BATCH,
                                      shuffle=True, seed=SEED + 61)

    out = {"batch": SV_BATCH, "steps": SV_BATCHES, "crash_at": OB_CRASH_AT}
    with _Deterministic(), tempfile.TemporaryDirectory(
            prefix="dl4j_observed_") as tmp:
        base = train_model(dev, True, "bfloat16", "bfloat16")
        scores = CollectScoresIterationListener()
        base.set_listeners(scores)
        base.fit(make(), epochs=1)
        want = [s for _, s in scores.scores]
        check(len(want) == SV_BATCHES and all(np.isfinite(want)),
              f"unsupervised losses {want}")
        xprof.reset()
        tower = watchtower.install(Watchtower(
            [], interval_s=0.1, incident_dir=os.path.join(tmp, "incidents")))
        ck = os.path.join(tmp, "ckpt")
        tb = os.path.join(tmp, "tb")
        try:
            torch.cuda.empty_cache()
            model = train_model(dev, True, "bfloat16", "bfloat16")
            storage = TensorBoardStatsStorage(tb)
            healed, count = CollectScoresIterationListener(), _Count()
            model.set_listeners(healed, count, StatsListener(
                storage, collect_every_n=1, collect_timing=False))
            torch.cuda.reset_peak_memory_stats(dev)
            # every count set to 0 just before the path is driven
            _reset_kernel_counts()
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "train/step", "index": OB_CRASH_AT,
                  "kind": "crash"}]))
            try:
                sup = TrainingSupervisor(model, ck,
                                         save_every_n_iterations=SV_EVERY,
                                         backoff_base_s=0.05)
                res = sup.fit(make, epochs=1, resume="never")
            finally:
                faultinject.clear_plan()
            torch.cuda.synchronize()
            launches = update.fused_update_launches
            peak = torch.cuda.max_memory_allocated(dev)
            storage.close()
            check(res.status == "completed" and res.restarts == 1,
                  f"supervised fit: {res} history {res.history}")
            check(launches == count.n > SV_BATCHES,
                  f"fused_update launched {launches} times for {count.n} "
                  f"dispatched steps (want one a step, replays included)")
            got = [s for _, s in healed.scores]
            check(got == want and _same_model(model, base),
                  f"the healed run is not bitwise the unsupervised one: "
                  f"{got} vs {want}")
            tower.evaluate_now()
            incs = tower.incidents()
            check(len(incs) == 1, f"incidents: {incs}")
            with open(incs[0]["path"]) as f:
                rep = json.load(f)
            chain = rep["chain"]
            names = {k: (chain[k] or {}).get("name") for k in
                     ("cause", "detection", "mitigation", "recovery")}
            check(rep["complete"] and incs[0]["finalized"]
                  and names["cause"] == "fault/fired"
                  and names["detection"] == "supervisor/attempt_failed"
                  and names["mitigation"] == "supervisor/restart"
                  and names["recovery"] in ("supervisor/attempt_start",
                                            "checkpoint/restore"),
                  f"incident chain {names}")
            seqs = [chain[k]["seq"] for k in
                    ("cause", "detection", "mitigation", "recovery")]
            check(seqs == sorted(seqs), f"chain out of order: {seqs}")
            mc = sup.memcensus_path()
            check(os.path.dirname(mc) == os.path.dirname(sup.blackbox_path())
                  and os.path.exists(mc) and os.path.exists(
                      sup.blackbox_path()),
                  f"memcensus.json {mc} beside {sup.blackbox_path()}")
            with open(mc) as f:
                blob = json.load(f)
            devs = blob["census"].get("devices", [])
            check(devs and devs[0].get("bytes_in_use", 0) > 0
                  and devs[0].get("bytes_limit", 0) > 0
                  and "peak_bytes_in_use" in devs[0],
                  f"memcensus has no allocator figures: {blob['census']}")
            files = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
            events = [e for p in files for e in read_scalar_events(p)]
            by_step = {}
            for step, tag, v in events:
                if tag == "score":
                    by_step.setdefault(step, set()).add(v)
            check(files and sorted(by_step) == [i for i, _ in healed.scores]
                  and all(vals == {float(np.float32(s))}
                          for (i, s), vals in zip(
                              healed.scores,
                              (by_step[i] for i, _ in healed.scores))),
                  f"TensorBoard scores {by_step} against {healed.scores}")
            report = CrashReportingUtil.generate_memory_status_report(
                model, minibatch=SV_BATCH)
        finally:
            watchtower.uninstall()
    keep = [ln for ln in report.splitlines()
            if ln.startswith(("=== deeplearning4j", "device 0",
                              "total parameters", "activation estimate"))]
    act = re.search(r"activation estimate \(fwd, minibatch \d+\): "
                    r"([0-9.]+) MiB", report)
    check(act is not None, "the crash report has no activation estimate")
    out.update(launches=launches, incident_chain=names, peak_bytes=peak,
               activation_estimate_mib=float(act.group(1)),
               report_lines=len(report.splitlines()),
               tensorboard_scalars=len(events))
    log(f"[observed-supervisor] a train/step crash at dispatch "
        f"{OB_CRASH_AT}: one incident, "
        f"{' -> '.join(names[k] for k in ('cause', 'detection', 'mitigation', 'recovery'))}; "
        f"memcensus.json beside blackbox.jsonl (device 0: "
        f"{devs[0]['bytes_in_use']} B in use of {devs[0]['bytes_limit']}); "
        f"losses, parameters, BN statistics and momentum bitwise the "
        f"unsupervised fit's; {launches} fused_update launches; "
        f"{len(events)} scalars read back from {len(files)} event file(s), "
        f"the scores as float32; {smi}")
    for ln in keep:
        log(f"[observed-supervisor] report: {ln}")
    log(f"[observed-supervisor] report ({len(report.splitlines())} lines): "
        f"activation estimate {float(act.group(1)):.2f} MiB at batch "
        f"{SV_BATCH} (forward, bf16) beside the card's measured peak over "
        f"the supervised fit {peak / 2 ** 20:.2f} MiB "
        f"(max_memory_allocated); {smi}")
    del model, base
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available; the port's main path "
              "runs on the card", file=sys.stderr)
        return 2
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
        from deeplearning4j_tpu_torch.ops import (attention, embeddings,
                                                  epilogue, update)
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    kernels = []
    try:
        smi, name = phase_device()
        phase_build()
        errs, timing = phase_kernels(smi, dev)
        upd_errs, upd_timing = phase_fused_update(smi, dev)
        bag_err, bag_timing = phase_embedding_bag(smi, dev)
        fa_err, fa_timing = phase_flash_attention(smi, dev)
        fa16 = phase_flash_attention_bf16(smi, dev)
        fa_grad_err, fa_grad_bf16_err = phase_flash_grad(smi, dev)
        model = build_model(dev)
        launches, batches, bn_plain = phase_serving(model, smi, dev)
        phase_parity(model, dev)
        routes = phase_kernel_routes(smi, dev, model)
        environment = phase_environment(smi, dev, model)
        del model
        torch.cuda.empty_cache()
        train = phase_train(smi, dev)
        tparity = phase_train_parity(dev)
        pipe = phase_resnet_pipeline(smi, dev, train["images_per_s"])
        core = phase_core(smi, dev)
        w2v = phase_word2vec(smi, dev)
        enc_model, enc = phase_encoder(smi, dev)
        enc["parity_max_abs_err"], f32_launches, enc["bf16_parity"] = \
            phase_encoder_parity(enc_model, smi, dev)
        del enc_model
        enc_train = phase_encoder_train(smi, dev)
        lenet = phase_lenet(smi, dev)
        vgg = phase_vgg16(smi, dev)
        masked = phase_masked(smi, dev)
        mln_upd = time_mln_updates(
            smi, dev, torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                  device=dev))
        sents = zipf_sentences(W2V_WORDS)
        sg = phase_skipgram(smi, dev, sents)
        hs = phase_hs(smi, dev, sents)
        cbow16 = phase_cbow_bf16(smi, dev, sents)
        pv = phase_paragraph_vectors(smi, dev, sents)
        bert = phase_samediff_bert(smi, dev)
        torch.cuda.empty_cache()
        host, host_sg = phase_w2v_host(smi, dev, sents)
        ft, ft_model = phase_fasttext(smi, dev, sents)
        glove = phase_glove(smi, dev, sents)
        deepwalk = phase_deepwalk(smi, dev)
        ser = phase_serializer(smi, dev, host_sg, ft_model, sents)
        del sents, host_sg, ft_model
        torch.cuda.empty_cache()
        zoo_cnn = phase_zoo_cnn(smi, dev)
        torch.cuda.empty_cache()
        seq = phase_sequences(smi, dev)
        torch.cuda.empty_cache()
        transfer = phase_transfer(smi, dev)
        torch.cuda.empty_cache()
        rest = {"vae": phase_vae(smi, dev),
                "capsnet": phase_capsnet(smi, dev),
                "layers": phase_layers(smi, dev)}
        torch.cuda.empty_cache()
        remat = phase_remat(smi, dev)
        torch.cuda.empty_cache()
        disk, disk_model, pixels = phase_disk(smi, dev)
        container = phase_container(smi, dev, pixels)
        tele = phase_telemetry(smi, dev)
        es_eval = phase_early_stopping(smi, dev, disk_model, pixels)
        del disk_model, pixels
        torch.cuda.empty_cache()
        onnx_r50, r50_params, r50_x, r50_logits = phase_onnx_resnet50(smi,
                                                                      dev)
        tf_r50 = phase_tf_resnet50(smi, dev, r50_params, r50_x, r50_logits)
        del r50_params, r50_x, r50_logits
        onnx_enc = phase_onnx_encoder(smi, dev)
        sdk = phase_samediff_kernels(smi, dev)
        torch.cuda.empty_cache()
        keras_r50 = phase_keras_resnet50(smi, dev)
        keras_lstm = phase_keras_lstm(smi, dev)
        sd_ctl = phase_samediff_control_random(smi, dev)
        torch.cuda.empty_cache()
        pw_r50 = phase_parallel_resnet50(smi, dev)
        pw_enc = phase_parallel_encoded_elastic(smi, dev)
        pw_int = phase_parallel_integrity(smi, dev)
        torch.cuda.empty_cache()
        sv = phase_serving_tier(smi, dev)
        torch.cuda.empty_cache()
        mem_errs, mem_timing = phase_fused_update_members(smi, dev)
        fleet = phase_fleet_sweep(smi, dev)
        fleet_life = phase_fleet_lifecycle(smi, dev)
        faults = phase_fault_sites(smi, dev)
        rl_r = phase_rl(smi, dev)
        torch.cuda.empty_cache()
        t_mp = time.perf_counter()
        mp = {"pipeline": phase_pipeline_attention(smi, dev),
              "kill_a_stage": phase_pipeline_remap(smi, dev)}
        mp["vgg16_pipeline"], vgg_net, vgg_x = phase_pipeline_vgg16(smi, dev)
        mp["tensor_parallel"] = phase_tp_and_tables(smi, dev, vgg_net, vgg_x)
        del vgg_net, vgg_x
        torch.cuda.empty_cache()
        mp["sharded_word2vec"] = phase_sharded_word2vec(smi, dev, sg)
        mp["ring_attention"] = phase_ring_attention(smi, dev)
        mp["seconds"] = time.perf_counter() - t_mp
        log(f"[model-parallel] phases 49-54 took {mp['seconds']:.1f} s")
        torch.cuda.empty_cache()
        t_sv = time.perf_counter()
        heal = {"resnet50": phase_supervised_resnet50(smi, dev),
                "elastic": phase_supervised_elastic(smi, dev),
                "pipeline": phase_supervised_pipeline(smi, dev),
                "process_group": phase_process_group(smi, dev)}
        heal["seconds"] = time.perf_counter() - t_sv
        log(f"[supervisor] phases 55-58 took {heal['seconds']:.1f} s")
        torch.cuda.empty_cache()
        t_ob = time.perf_counter()
        observed = {"fit": phase_observed_fit(smi, dev)}
        observed["serving"] = phase_observed_serving(smi, dev)
        observed["supervisor"] = phase_observed_supervisor(smi, dev)
        observed["seconds"] = time.perf_counter() - t_ob
        log(f"[observability] phases 59-61 took {observed['seconds']:.1f} s")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    bf, f32 = timing[torch.bfloat16], timing[torch.float32]
    kernels.append({
        "name": "bn_act", "route": "cuda", "source": epilogue.SOURCE,
        "replaces": epilogue.REPLACES, "launches": launches,
        "plain_on_card": bn_plain,
        "max_abs_err": max(errs.values()),
        "max_err_f32": errs[torch.float32],
        "max_err_bf16": errs[torch.bfloat16],
        "shape": [BATCH, 256, 56, 56], "dtype": "bfloat16",
        "ms": bf["ms"], "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": None, "unfused_ms": bf["unfused_ms"],
        "f32": {k: f32[k] for k in ("ms", "plain_ms", "unfused_ms",
                                    "bound_ms")},
        "floor_ms": timing["floor"]["ms"],
        "identity_library": timing["library"], "wide": timing["wide"],
        "batches": batches,
        "launches_samediff_bert": bert["launches"]["bn_act"],
        "launches_zoo_cnn": {n: r["bn_act_launches"]
                             for n, r in zoo_cnn.items()
                             if "bn_act_launches" in r},
        "launches_simplecnn_reheaded":
            transfer["simplecnn"]["bn_act_launches"],
        "launches_evaluation_forward":
            es_eval["evaluation"]["bn_act_launches"],
        "launches_keras_resnet50": keras_r50["bn_act_launches"],
        "launches_serving_tier": sv["launches"],
        "launches_observed_serving": observed["serving"]["bn_act_launches"],
        "forwards": {n: {k: f[k] for k in ("launches", "ms", "bound_ms",
                                           "share")}
                     for n, f in timing["shapes"].items()}})
    nb, ad = upd_timing["nesterovs_bf16"], upd_timing["adam_f32"]
    kernels.append({
        "name": "fused_update", "route": "cuda", "source": update.SOURCE,
        "replaces": update.REPLACES, "launches": train["launches"],
        "plain_on_card": train["counters"].get(
            PLAIN_ON_CARD["fused_update"], 0),
        "max_abs_err": max(upd_errs["max_err_param"],
                           upd_errs["max_err_moment"],
                           *(mln_upd[m][k] for m in ("lenet", "vgg16")
                             for k in ("max_err_param", "max_err_moment"))),
        "max_err_param": upd_errs["max_err_param"],
        "max_err_moment": upd_errs["max_err_moment"],
        "bitwise_cases": f"{upd_errs['bitwise']}/{upd_errs['cases']}",
        "shape": [RESNET50_PARAMS], "kind": "nesterovs",
        "state_dtype": "bfloat16",
        "ms": nb["ms"], "plain_ms": nb["plain_ms"],
        "bound_ms": nb["bound_ms"], "bound_by": nb["bound_by"],
        "library_ms": nb["library_ms"], "library": nb["library"],
        "unfused_ms": nb["unfused_ms"], "bits_ms": nb["bits_ms"],
        "launches_resnet50_pipeline": pipe["launches"],
        "adam_f32": {k: ad[k] for k in ("ms", "plain_ms", "unfused_ms",
                                        "bound_ms", "library_ms")},
        "mln": {"lenet": dict(mln_upd["lenet"],
                              launches=lenet["fused"]["launches"]),
                "vgg16": dict(mln_upd["vgg16"], launches=vgg["launches"])},
        "launches_samediff_bert": bert["launches"]["fused_update"],
        "launches_encoder_train": enc_train["fused_update_launches"],
        "launches_zoo_cnn": {n: r["fused_update_launches"]
                             for n, r in zoo_cnn.items()
                             if "fused_update_launches" in r},
        "launches_textgen": seq["fused_update_launches"],
        "launches_vgg16_transfer": transfer["fused_update_launches"],
        "vgg16_transfer_elements": transfer["fused_update_elements"],
        "launches_capsnet": rest["capsnet"]["fused_update_launches"],
        "launches_remat": {n: r["fused_update_launches"]
                           for n, r in remat.items()
                           if "fused_update_launches" in r},
        "launches_disk": disk["fused_update_launches"],
        "launches_container": container["fused_update_launches"],
        "launches_host_prefetch":
            container["host_prefetch"]["fused_update_launches"],
        "launches_guarded": tele["fused_update_launches"],
        "launches_guarded_tbptt": tele["tbptt"]["launches"],
        "launches_early_stopping":
            es_eval["early_stopping"]["fused_update_launches"],
        "launches_keras_resnet50": keras_r50["fused_update_launches"],
        "launches_keras_lstm": keras_lstm["fused_update_launches"],
        "launches_parallel": {
            "resnet50_dense_f32": pw_r50["f32"]["launches_dense"],
            "resnet50_zero1_f32": pw_r50["f32"]["launches_zero1"],
            **{f"resnet50_{k}_bf16": v["launches"]
               for k, v in pw_r50["bf16"].items()},
            "lenet_encoded": pw_enc["encoded"]["launches"],
            "lenet_zero1_resume": pw_enc["resume_4_to_2"]["launches"],
            "lenet_integrity": pw_int["launches_to_detection"]},
        "parallel_variants": {
            "dense": [v["variant"] for v in pw_r50["f32"]["variants_dense"]],
            "zero1": [v["variant"]
                      for v in pw_r50["f32"]["variants_zero1"]]},
        "parallel_shard": pw_r50["shard_update"],
        "launches_supervised": {
            "resnet50_crash": heal["resnet50"]["crash"]["launches"],
            "resnet50_wedge": heal["resnet50"]["wedge"]["launches"],
            "resnet50_shrink_4_to_3":
                heal["elastic"]["shrink"]["launches"],
            "process_group_per_rank": [
                r["launches"]
                for r in heal["process_group"]["uninterrupted"]["ranks"]],
            "process_group_after_restart_per_rank": [
                r["launches"]
                for r in heal["process_group"]["restarted"]["ranks"]]},
        "launches_observed": {
            "resnet50_fit_census": observed["fit"]["launches"],
            "resnet50_supervised_watchtower":
                observed["supervisor"]["launches"]}})
    bp = bag_timing["path"]
    kernels.append({
        "name": "embedding_bag", "route": "cuda",
        "source": embeddings.SOURCE, "replaces": embeddings.REPLACES,
        "launches": w2v["launches"], "plain_on_card": w2v["plain_on_card"],
        "max_abs_err": bag_err,
        "shape": bp["shape"], "dtype": "float32",
        "ms": bp["ms"], "ms_warm": bp["ms_warm"], "host_us": bp["host_us"],
        "plain_ms": bp["plain_ms"],
        "bound_ms": bp["bound_ms"], "bound_by": bp["bound_by"],
        "library_ms": bp["library_ms"], "unfused_ms": bp["unfused_ms"],
        "bytes": bp["bytes"], "bytes_no_reuse": bp["bytes_no_reuse"],
        "indices": bp["indices"],
        "launches_by_path": {
            "word2vec_cbow": w2v["launches"],
            "cbow_hs": hs["cbow"]["launches"],
            "cbow_bf16": cbow16["fit"]["launches"],
            "pv_dm": pv["dm"]["launches"],
            "samediff_bert": bert["launches"]["embedding_bag"],
            "samediff_op": sdk["embedding_bag_op"]["launches_per_call"],
            "host_cbow": host["cbow"]["launches"],
            "host_pv_dm": host["pv-dm"]["launches"],
            "fasttext_cold": ft["fits"][0]["launches"],
            "fasttext_warm": ft["fits"][1]["launches"]},
        **{f"fasttext_{name}": {k: ft["bag"][name][k] for k in (
            "shape", "ms", "ms_warm", "host_us", "plain_ms", "library_ms",
            "unfused_ms", "bound_ms", "bound_by", "bytes", "max_abs_err")}
           for name in ("path", "long")},
        **{name: {k: bag_timing[name][k] for k in (
            "shape", "indices", "ms", "ms_warm", "plain_ms", "library_ms",
            "unfused_ms", "bound_ms", "bytes", "bytes_no_reuse")}
           for name in ("path_raw_zipf", "wide")},
        "bf16": dict(
            {k: bag_timing["bf16"][k] for k in (
                "shape", "indices", "ms", "ms_warm", "host_us", "plain_ms",
                "library_ms", "unfused_ms", "bound_ms", "bound_by", "bytes",
                "max_abs_err")},
            launches=cbow16["fit"]["bf16_launches"],
            f32_ms=bag_timing["bf16"]["f32_ms"],
            f32_ms_warm=bag_timing["bf16"]["f32_ms_warm"],
            pv_dm_width=bag_timing["bf16_pv_dm"]["shape"],
            pv_dm_ms=bag_timing["bf16_pv_dm"]["ms"],
            pv_dm_ms_warm=bag_timing["bf16_pv_dm"]["ms_warm"],
            pv_dm_f32_ms=bag_timing["bf16_pv_dm"]["f32_ms"],
            pv_dm_f32_ms_warm=bag_timing["bf16_pv_dm"]["f32_ms_warm"],
            pv_dm_bound_ms=bag_timing["bf16_pv_dm"]["bound_ms"])})
    keys = ("shape", "layout", "ms", "ms_with_lse", "ms_with_f32", "plain_ms",
            "library_ms",
            "unfused_ms", "bound_ms", "bound_by")
    bp = fa16["path_strided"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": attention.SOURCE, "replaces": attention.REPLACES,
        "launches": enc["bf16_route_launches"], "plain_on_card": 0,
        "max_abs_err": fa16["max_abs_err"],
        "bitwise_share": fa16["bitwise_share"], "lse_err": fa16["lse_err"],
        "bf16_grad_max_abs_err": fa_grad_bf16_err,
        "ms_with_f32": bp["ms_with_f32"],
        "shape": bp["shape"], "layout": bp["layout"], "dtype": "bfloat16",
        "ms": bp["ms"], "ms_with_lse": bp["ms_with_lse"],
        "plain_ms": bp["plain_ms"], "bound_ms": bp["bound_ms"],
        "bound_by": bp["bound_by"], "library_ms": bp["library_ms"],
        "unfused_ms": bp["unfused_ms"], "host_us": fa16["host_us"],
        "masked_launches": masked["launches"],
        "launches_encoder_train": enc_train["flash_launches"],
        "launches_samediff_bert": bert["launches"]["flash_attention"],
        "launches_samediff_mha": sdk["mha_bf16"]["launches_per_call"],
        "launches_pipeline": mp["pipeline"]["flash_launches"],
        "launches_pipeline_per_step":
            mp["pipeline"]["flash_launches_per_step"],
        "launches_pipeline_per_step_gpipe":
            mp["pipeline"]["flash_launches_per_step_gpipe"],
        "launches_supervised_pipeline":
            heal["pipeline"]["remap"]["flash_launches"],
        "launches_supervised_pipeline_per_step":
            heal["pipeline"]["remap"]["flash_launches_per_step"],
        **{name: {k: fa16[name][k] for k in keys}
           for name in ("path_contiguous", "long_strided",
                        "long_contiguous")}})
    fp, fl = fa_timing["path"], fa_timing["long"]
    kernels.append({
        "name": "flash_attention_f32", "route": "cuda",
        "source": attention.SOURCE, "replaces": attention.REPLACES,
        "launches": f32_launches, "plain_on_card": 0, "max_abs_err": fa_err,
        "bitwise_share": fa_timing["bitwise_share"],
        "grad_max_abs_err": fa_grad_err, "shape": fp["shape"],
        "launches_samediff_bert": bert["launches"]["flash_attention"],
        "launches_samediff_mha": sdk["mha_f32"]["launches_per_call"],
        "launches_samediff_flash_op": sdk["flash_op"]["launches_per_call"],
        "dtype": "float32", "ms": fp["ms"], "plain_ms": fp["plain_ms"],
        "bound_ms": fp["bound_ms"], "bound_by": fp["bound_by"],
        "ffma_bound_ms": fp["ffma_bound_ms"],
        "library_ms": fp["library_ms"], "unfused_ms": fp["unfused_ms"],
        "long": {k: fl[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                    "unfused_ms", "bound_ms", "bound_by",
                                    "ffma_bound_ms")}})
    ms = mem_timing["lenet_sweep"]
    kernels.append({
        "name": update.MEMBERS_KERNEL_NAME, "route": "cuda",
        "source": update.SOURCE, "replaces": update.REPLACES,
        "under": "jax.vmap over the fleet's members",
        "launches": fleet["launches"],
        "plain_on_card": fleet["plain_on_card"],
        "max_abs_err": max(mem_errs["max_err_param"],
                           mem_errs["max_err_moment"]),
        "max_err_param": mem_errs["max_err_param"],
        "max_err_moment": mem_errs["max_err_moment"],
        "bitwise_cases": f"{mem_errs['bitwise']}/{mem_errs['cases']}",
        "shape": ms["shape"], "kind": ms["kind"],
        "state_dtype": ms["state_dtype"],
        "ms": ms["ms"], "plain_ms": ms["plain_ms"],
        "bound_ms": ms["bound_ms"], "bound_by": ms["bound_by"],
        "library_ms": ms["library_ms"], "library": ms["library"],
        "solo_x_m_ms": ms["solo_x_m_ms"], "bytes": ms["bytes"],
        "resnet50": mem_timing["resnet50"],
        "launches_rl_population": rl_r["population"]["member_launches"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"train": {k: v for k, v in train.items()
                                if k != "counters"},
                      "train_parity": tparity, "kernel_routes": routes,
                      "environment": {k: environment[k] for k in (
                          "build_cache", "default_dtype", "allow_pallas",
                          "seconds")},
                      "resnet50_pipeline": pipe, "core": core,

                      "word2vec_cbow": w2v, "encoder": enc,
                      "encoder_train": enc_train, "zoo_cnn": zoo_cnn,
                      "bn_act_forwards": timing["shapes"], "lenet": lenet,
                      "vgg16": vgg, "masked": masked, "skipgram": sg,
                      "word2vec_hs": hs, "cbow_bf16": cbow16,
                      "paragraph_vectors": pv,
                      "samediff_bert": {k: v for k, v in bert.items()
                                        if k != "launches"},
                      "w2v_host": host,
                      "fasttext": {k: v for k, v in ft.items()
                                   if k != "bag"},
                      "glove": glove, "deepwalk": deepwalk,
                      "serializer": ser, "sequences": seq,
                      "transfer": transfer, "pretrain_and_layers": rest,
                      "remat": remat, "disk": disk, "container": container,
                      "telemetry": tele, **es_eval,
                      "onnx_resnet50": onnx_r50, "tf_resnet50": tf_r50,
                      "onnx_encoder": onnx_enc, "samediff_kernels": sdk,
                      "keras_resnet50": keras_r50, "keras_lstm": keras_lstm,
                      "samediff_control_random": sd_ctl,
                      "parallel_resnet50": pw_r50,
                      "parallel_encoded_elastic": pw_enc,
                      "parallel_integrity": pw_int,
                      "serving_tier": sv, "fleet_sweep": fleet,
                      "fleet_lifecycle": fleet_life, "fault_sites": faults,
                      "rl": rl_r, "model_parallel": mp,
                      "supervisor": heal, "observability": observed},
                     default=str),
          flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--group-worker"]:
        sys.exit(group_worker(sys.argv[2:]))
    sys.exit(main())
