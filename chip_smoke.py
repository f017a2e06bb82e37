#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each printing one JSON line with the card's name and power limit:

1. build    — compile the CUDA kernels from ``paddle_tpu_torch/csrc``;
              print each kernel's ``ptxas`` registers and spills and its
              count of ``HGMMA`` (wgmma) instructions in the SASS.
2. kernels  — hold K4 (paged decode), K5 (paged prefill), K1 (flash
              forward) and K2/K3 (flash backward: dK/dV and dQ) against
              their plain PyTorch versions at the serving and training
              paths' shapes, in f32 and bf16, and time each kernel, its
              plain version and one library call computing the same thing;
              hold the bf16 tensor-core K1, K5, K2 and K3 at their edge
              shapes (ragged S, S 16, full and causal, D 64 and 128, starts
              that are not multiples of 64), and require wgmma in all four;
              hold the split-K K4 at its edges (windows about one split
              long, a length past the table, query groups 1-8, block size
              32, shared table rows), time it at one long slot, at 32 slots
              and on a table whose blocks walk several splits (these three
              also in f32), and require two calls on the same inputs to
              agree bitwise; hold and time K4 and K5 at ``serve_gpt``'s
              shapes too (16 heads of 64, a 1024-position table).  A
              kernel, its plain version and the library call are timed
              cold, each call alone after ``L2_FLUSH_BYTES`` are written
              outside its events; the kernel also alone and warm
              (``warm_ms``) and back to back (``batched_ms``, how earlier
              runs timed it).  K1-K3's dropout instances are held at the
              train shape at p 0.1 on one draw (seed, offset) against
              their plain versions on the same draw (to the p = 0 rows'
              tolerances), on a ragged full-mask shape, and K1's mask
              exactly at S 64 (q = k = 0 and V one-hot by key, so that O
              exposes the mask), and at a rank's coordinates: each of the
              2 batch x 2 head quarters of the train shape, drawing at its
              ``[batch_start, head_start, heads_total]``, against the
              slice of the whole problem's output on one draw and against
              the plain version at the same coordinates.  The f16 instances of K1-K3 (p 0 and
              dropout) are held and timed at the train shape (SDPA at
              f16 the library call), on a ragged full shape, and K2/K3
              under an f16 overflow (outputs non-finite where the plain
              versions' are: never clamped); their HGMMA is required too.
              The f16 instances of K4 and K5 are held and timed at the
              main path's and ``serve_gpt``'s shapes (SDPA at f16 the
              library call), K4 also at its edges (windows about one
              split long, a length past the table, query groups 1-8,
              block size 32; a bitwise repeat at each), and both under
              an overflow (+inf V rows: outputs non-finite exactly where
              the plain versions' are); the f16 K5 must hold HGMMA.
              The f32 K1 and K2 (p 0 and dropout) run on tensor cores
              too, 3xTF32 on wgmma: held at the bf16 edges, on the fused
              projection's views and at p 0.1, each flash check also
              requiring two calls to agree bitwise; their four f32
              instances must hold HGMMA.  Every f32 row's bound takes
              f32-accurate products at the 3xTF32 rate (``PEAK_FLOPS``).
3. serve_paged — Llama-2 7B at full width (random weights from a seed),
              bf16, paged KV: 12 requests sharing a 512-token system
              prompt; the K4/K5 launch counts of this run are read.
              Every engine step is a CUDA graph (``serving.programs``):
              warmup captures one per prefill bucket and one decode, and
              each serve phase prints ``compile_cache`` and fails if a
              program is built after warmup.
3b. serve_mesh — the same model (serve_paged's engine released) and
              traffic through ``Engine(mesh=serving_mesh(1))``: an NCCL
              world of one on a ``HashStore``, the tensor-parallel layers
              sharing the model's tensors, their all-reduces and the
              head's all-gather captured in the CUDA graphs; in turns with
              the plain engine (plain, mesh, mesh, plain: ITL p50, TTFT
              p50, decode tokens/s, medians and quartiles).  Every turn's
              streams must equal serve_paged's bitwise (all four sampling
              laws), no program may be built after warmup, K4/K5 must
              launch and the decode program must hold its collectives
              (their count a decode step is printed).  Then GPT-2 345M
              contiguous at mesh one against its plain engine (K1 in the
              prefill), the same checks.
4. serve_contiguous — a few requests through the same model with the
              contiguous layout, whose prefill runs K1.
5. serve_gpt — GPT-2 345M at full width (random weights from a seed),
              bf16, paged KV: 12 requests sharing a 256-token system
              prompt; K4 and K5 run at head dim 64.
6. parity   — Llama-2 7B and GPT-2 345M widths in f32 at 2 layers: paged
              prefill + 4 decode steps on the kernel path against
              ``kernel="reference"``.
7. graph_parity — the same two widths in f32 at 2 layers, paged and
              contiguous: seeded requests (greedy and sampling) served
              through the engine's programs and through its step bodies
              called eagerly give identical token streams.
8. serve_overload — serve_paged's Llama-2 7B (kept alive until here)
              under overload: a paged engine of 8 slots whose pool of 384
              blocks (3.0 GiB) cannot hold its 24 requests, in three
              priority classes arriving at steps 0, 8 and 16 (the normals
              with a deadline shed, one queued and one running low
              cancelled), with a live request tracer.  It fails unless
              some stream was preempted for a slot and some for blocks, a
              resume hit all its prompt's whole blocks, the trace chain is
              valid, no program was built after warmup and the pool is
              clean after; it prints TTFT and ITL per class and writes the
              Chrome trace into the temporary directory.
9. overload_parity — both widths at 2 layers in f32, paged and
              contiguous, 2 slots: a greedy and a seeded top-p low request
              preempted by high arrivals while the step programs fail
              (before and after they ran) must give the streams each gives
              served alone; a decode failing past its retry fails its
              batch and the next request is served as alone.
10. serve_durable — serve_paged's Llama-2 7B with a request journal:
              serve_paged's engine and traffic served with no journal,
              with ``fsync="rotate"`` and with ``fsync="always"`` in turn
              (three times each; ITL, TTFT, tokens/s, records and bytes); 8
              requests (greedy and seeded) admitted to a journaled engine
              that is dropped once each streamed two tokens, then
              recovered by a new engine whose streams must equal the same
              requests served uninterrupted; a hot swap to weights of
              another seed and back under the CUDA graphs (the new
              weights change the stream, the old ones give it back, the
              prompt misses the prefix cache after each swap, no
              parameter moves, no program is built); ``drain()`` of a
              contiguous engine (K1) with 4 requests in flight and
              ``shutdown(timeout_s=0)`` of a paged one with 2 running.
11. sigkill_drill — GPT-2 345M at full width, paged, bf16, in two child
              processes: one journals 3 requests and SIGKILLs itself
              mid-decode, the other rebuilds the model, recovers and
              holds the streams to uninterrupted runs.
12. train   — GPT-2 345M at full width (24 layers, random weights from a
              seed), batch 8 x 1024, bf16 AMP O2 with f32 masters, AdamW,
              the step compiled by ``jit.to_static`` (a CUDA graph from
              its second call): 3 warm-up and 10 timed steps on one
              batch, one program and one capture; the K1/K2/K3 launch
              counts of these 13 steps are read; the first 3 losses must
              equal the same step's run eagerly.
12a. hybrid_train — the same step through fleet in a launched world of
              one (``python -m paddle_tpu_torch.distributed.launch
              --nproc_per_node 1`` on
              ``paddle_tpu_torch/distributed/launch/hybrid_train.py``,
              NCCL): ``fleet.init`` at every degree 1 and sharding stage
              1, ``distributed_model``, ``distributed_optimizer(AdamW)``,
              3 + 10 graph steps whose losses must be bitwise train's and
              whose K1-K3 launches are one per layer per step; gradient
              merge (k 4, f32, SGD 1e-2) over 4 micro-batches of 2
              within 1e-5 of one update on the batch of 8, and its
              refusal of a compiled step; every collective on the card,
              and an all-reduce captured in a CUDA graph on a side stream
              and replayed; K1-K3 against their plain versions at the
              path's shape.
12e. elastic_train — the same step (train's recipe, 13 steps) in a
              worker of ``python -m paddle_tpu_torch.distributed.launch
              --elastic_coordinator <tmp> --np 1 --job_id smoke
              --max_restarts 2`` (``.../launch/elastic_train.py``) under
              ``ResilientLoop(mesh_watchdog=MeshWatchdog(FileCoordinator))``
              with a format-2 generation every 4 steps: a
              ``train.straggler`` stall of 8 s at step 6 outlasts the
              watchdog's 5 s deadline, the worker exits 101, the launcher
              relaunches it and it resumes from step 4.  Held: exit 0, two
              lives, the 13 losses and the redone steps' bitwise train's,
              no sample lost, one capture and K1-K3 once per layer per
              step in the second life.  Reported: the seconds to detect
              the stall, from it to the first resumed step, of the load;
              the steps redone; the step ms of each life.
12f. ring_attention — ring attention at GPT-2 345M's heads (16 x 64,
              bf16, causal) over 8192 positions cut into 4 sep chunks of
              2048, B 1, in one process: forward and backward against one
              K1-K3 call over the whole 8192 and against the plain ring,
              each of K1-K3 launched once per visible tick (10); the ms of
              the ring and of the whole call, and per tick.
12g. auto_parallel_train — the same model, optimizer and batch through
              ``auto_parallel.Engine(body, inputs_spec=["dp"])
              .prepare(AdamW, loss).fit`` on ``ProcessMesh([0], ["dp"])``
              (``body``: the decoder under ``auto_cast``; ``loss``: the
              fused cross-entropy over the tied head): one program, one
              capture, K1-K3 once per layer per step, and the 13 losses
              against train's (bitwise, or the largest relative
              difference within 1e-5).
12b. train_recipe — the same model at the GPT-2 recipe: dropout 0.1
              (hidden, and attention in K1-K3's dropout instances), 4
              warm-up steps then a cosine decay, a global-norm clip of
              1.0, through ``to_static``, 20 steps with recompute off and
              then on (step ms after the eager call and the capture,
              peak): finite losses, each step read the scheduler's
              rate, the clipped norm is at most 1.0 (one eager backward
              after the run), the first loss bitwise equal in both runs,
              a lower peak with recompute; the dropout instances' launch
              counts of the two runs are read.
12c. train_o1 — the bench step at AMP O1 (f32 parameters, no masters,
              ``compute_loss`` under ``amp.auto_cast(bfloat16, O1)``)
              through ``to_static``: 3 warm-up and 10 timed steps, one
              program and one capture, the first 3 losses bitwise the
              eager step's, the bf16 K1-K3 launched layers x steps
              times; then the O1 and O2 graph steps in turns (O1 O2 O2
              O1, twice): medians and quartiles.
12d. train_fp16_scaler — the same model at O1 float16 with
              ``amp.GradScaler`` from a scale of 2^32, the step of
              ``tests/test_amp.py:150-158`` through ``to_static``, 20
              steps: skipped steps leave parameters, moments and
              ``beta*_pow`` bitwise as they were (device checksums read
              after the loop), the scale follows the JAX rule replayed on
              the host, some step skips and some applies, finite losses
              once steps apply, one program and one capture, the f16
              K1-K3 launched layers x steps times; then 4 steps at
              dropout 0.1 (the f16 dropout instances).
13. train_parity — GPT-2 345M width at 2 layers in f32: loss, every
              gradient and the parameters after one AdamW step on the
              kernel path against ``kernel="reference"``.
14. train_parity_bf16 — the same model in bf16: loss and every gradient
              on the kernel path (the bf16 K1, K2 and K3 on tensor cores)
              against ``kernel="reference"``.
15. serve_spec — serve_paged's Llama-2 7B (after serve_durable) and
              traffic through a speculating paged engine (max_seq 2048,
              k 4: draft prefill, draft decode and verify programs, each
              a CUDA graph), once with an independent draft of
              JackFram/llama-68m's shape (random weights, seed 1) and once
              with the target as its own draft: the speculation counters,
              TTFT, ITL, tokens/s, device ms per round (draft steps and
              verify, CUDA events around each program), K4/K5/K1
              launches, the share of greedy streams equal to
              serve_paged's (reported, not held: bf16 near-ties may part
              a ``[slots, 5]`` verify from a ``[slots, 1]`` decode),
              beside the shares that the plain engine at max_seq 2048
              reproduces on the kernels and on its gather path (no
              kernel); it fails on a program built after
              warmup and unless the pool audits clean with no block in
              use.
16. spec_parity — (a) the paged verify route (``slots·W`` K4 rows)
              against the plain ``verify_attention`` at serve_spec's shape
              in f32 and bf16, timed in bf16 beside the gather + plain
              attention; (b) K4's merge tickets across a decode graph and
              a verify graph captured on one stream, decode → verify →
              decode replayed against eager calls; (c) f32, 2 layers, both
              widths, both layouts, an independent 1-layer draft and the
              target as its own draft: greedy speculative streams equal
              the plain engine's, one request's rounds running past
              ``max_seq`` until it retires on capacity; and Llama-2 7B at
              full depth in f32 with the llama-68m-shaped draft, four
              greedy streams of 32 tokens.
17. serve_tenancy — serve_paged's Llama-2 7B (after serve_spec) and
              engine with 4 LoRA adapter lanes of rank 16 (``t1``-``t3``
              loaded from seeds 1-3, factors N(0, 0.05)) and the bounded
              JSON grammar (eos 2): (a) serve_paged's 12 requests with no
              tenant, streams bitwise the plain engine's, the two served
              in turns (ITL, TTFT, tokens/s); (b) the same prompts round
              robin over base, ``t1``-``t3`` and json, greedy and at
              temperature 0.8: per-tenant TTFT and ITL, tokens/s, K4/K5
              launches, every json stream accepted by the grammar's
              oracle, the base greedy stream the plain engine's; (c) the
              prefix probe sees each tenant's domain and no other; (d) a
              hot swap and an unload mid-flight fail their requests with
              the JAX engine's ``error_ctx``, move no lane and build no
              program, and the reloaded v1 factors give the v1 streams
              back (swap ms).  It fails on a program built after warmup
              and unless the pool audits clean.
18. tenancy_parity — f32, 2 layers, both widths, paged and contiguous:
              lanes-off streams equal the plain engine's; a speculating
              tenancy engine (1-layer independent draft, k 3) gives the
              non-speculative greedy streams for base, ``t1`` and json; a
              preempted low ``t1`` request resumes to its stream alone;
              programs failing before and after they ran, with json and
              ``t1`` in flight, give the streams alone; a journaled engine
              dropped after 2 tokens recovers the tenant streams.
19. serve_resilience — serve_paged's Llama-2 7B (after serve_tenancy) on
              paged engines of 8 slots: (a) an engine armed from
              ``PADDLE_TPU_FT_SERVING_FAULTS`` (decode call #2 fails once,
              callback call #3 raises): that request alone fails, every
              other stream equals an unfaulted engine's, the pool is
              clean, no program is built after warmup; (b) a decode
              failing both attempts fails its batch only, and the next
              request gets its unfaulted stream; (c) a raising and a
              stalled (past 10 ms) prefix lookup serve as misses; (d) the
              step watchdog (0.5 s) fires on a 3 s host stall and (e) on a
              3 s ``torch.cuda._sleep`` enqueued after a decode replay
              (the replay returns at once; the host waits at the token
              read), each engine turning sticky unhealthy, its shutdown
              cancelling the request and joining the thread; (f) strict
              sanitized engines, plain and speculating (the
              llama-68m-shaped draft, k 4): 0.0 host transfers a decode
              step, and a control that reads the replay's output inside
              the window, counted at its line and failing its batch under
              the strict guard; (g) ITL, tokens/s and TTFT of
              serve_paged's traffic with nothing armed, a 5 s watchdog,
              ``PADDLE_TPU_SANITIZE=1`` and ``=strict``, in turns.
20. serve_fleet — serve_paged's Llama-2 7B (after serve_resilience) as
              the template of a weight-isolated ``Fleet`` of two paged
              replicas (8 slots, max_seq 2048) with a request tracer: (a)
              serve_paged's 12 requests in two waves of 6 (the second,
              after the first's prefills, routed by prefix affinity), in
              turns with a bare engine of the same kwargs (FEEF × 2):
              dispatches per replica, affinity hits, TTFT of the hits
              against the first wave, ITL, client ITL, TTFT and tokens/s,
              the host ms of a supervision pass; (b) three failover
              cycles: replica 1's decode fails both attempts mid-stream
              (the first request pinned to it), every request ends once,
              finished, with the stream it had in (a) (each engine primed
              with the system prompt, so a stream does not depend on its
              replica), ejection, replay and rebuild once a cycle, no
              program built past warmup, ``memory_allocated()`` back
              within 256 MiB, the recovery split into ejection, copy,
              build and warmup; (c) a rolling update to the weights of
              seed 2 under live streams: roll ms, the stall, no capture,
              versions, prefix epochs, post-roll streams equal a bare
              engine's on the new weights; (d) a journaled fleet dropped
              mid-decode and recovered by a new one, each replay once and
              equal to the uninterrupted stream.

21. serve_f16 — after serve_fleet releases the bf16 7B: Llama-2 7B at
              full width in float16, paged, on serve_paged's traffic, then
              GPT-2 345M in float16 on serve_gpt's (TTFT, ITL, tokens/s,
              peak); a device counter of the non-finite logits the steps
              hand the sampler (inside the graphs) must read 0 (else the
              first module that overflowed is named: nothing is clamped
              or rescaled), no program is built after warmup, and the f16
              K4 and K5 must launch.
22. parity_f16 — both widths at 2 layers in float16 (after
              tenancy_parity): the paged kernel path (f16 K4/K5) and the
              contiguous one (f16 K1 prefill) against the paged
              ``kernel="reference"`` path within
              ``PARITY_F16_TOLERANCE``; the graphs give the step bodies'
              token streams, paged and contiguous.
23. predictor — GPT-2 345M at full width made f16 by
              ``amp.decorate(level="O2", dtype="float16")``, ``jit.save``d
              into the temporary directory and served through
              ``inference.Config`` (``enable_use_gpu(precision=Half)``),
              ``create_predictor`` and the handles on seeded ``[4, 1024]``
              ids: logits against the eager forward and against
              ``kernel="reference"``, ``flash_fwd_f16`` launched 24 times
              a run (one a layer) and nothing else, a
              ``PredictorPool(config, 2)`` loading once; then a small f16
              GPT saved on the CPU, served on the card with K1.
23b. dy2static_generate — GPT-2 345M f16 (as ``predictor``) generating
              greedily with ``greedy_search`` (PaddleNLP's
              ``GenerationMixin.greedy_search`` loop: a tensor test, a
              tensor-predicated ``break``) on a ``[4, 256]`` id buffer with
              a 64-token prompt: eagerly (a host read a trip), through
              ``jit.to_static`` (the eager first call, then one CUDA graph
              whose WHILE node runs the forward, K1 24 times a trip, and
              the break's IF pair) and ``jit.save`` → ``create_predictor``
              (``torch.while_loop`` run by torch's own path): the ids and
              the final ``cur_len`` bitwise equal; K1 launched 24 × trips
              in a replay; a batch-1 run whose eos is the token the eager
              run emits at step 40 stops, replayed, at the eager loop's
              ``cur_len``.  Then ``graph_control``: the WHILE node's cost
              a trip over a one-kernel body against the same body
              unrolled (a bare replay), the plain loop and
              ``torch.while_loop``, and its build's seconds.

24. nn_encoder — BERT-base's masked-LM model (``bert-base-uncased``:
              hidden 768, 12 layers of 12 heads, FFN 3072, vocabulary
              30522, 512 positions; random weights from seed 0) built
              from the port's ``nn`` only (``Embedding``s, ``LayerNorm``,
              ``Dropout(0.1)``, ``TransformerEncoder`` of
              ``TransformerEncoderLayer``, an untied ``Linear`` head,
              ``CrossEntropyLoss`` over 15 % of the positions), 8 x 512,
              bf16 O2, AdamW, through ``jit.to_static``: 13 steps (one
              program, one capture, the first 3 losses bitwise the eager
              step's, falling losses), K1-K3's bf16 dropout instances
              launched 12 times a step and the plain attention route
              never; ``eval()`` and a no-grad forward (``flash_fwd`` 12);
              a 2-layer ``nn.Transformer`` forward with a causal target
              mask (Sq 128, Sk 512: the decoder's attention on the plain
              route, 4 calls; the encoder's on K1); the f32 2-layer loss
              and gradients on the card against the CPU.
25. seq2seq — PaddleNLP's LSTM attention translator
              (``examples/machine_translation/seq2seq``) at its IWSLT'15
              widths (vocabularies 17,191 and 7,709, embeddings and hidden
              512, 2 layers, dropout 0.2; random weights from seed 0; f32)
              from the port's ``nn`` (``nn.LSTM``, ``LSTMCell``s):
              ``paddle.Model.fit`` over a 2-worker ``io.DataLoader`` of
              seeded pairs (lengths 10-50, batch 128), 13 batches, every
              one through the shared-memory ring, with a
              ``StepTimeline``; the first 3 losses within 1e-4 of a CPU
              twin's; beam search (``BeamSearchDecoder``, beam 10,
              ``dynamic_decode`` up to 50 steps) over one batch on the
              card and on a CPU copy: ids and parents equal wherever the
              CPU's K-th/(K+1)-th margins exceed 1e-4, scores within
              1e-4, ``gather_tree`` consistent with the parents.  No
              kernel of the port runs here.
26. hapi_fit — BERT-base's masked LM (``nn_encoder``'s layers, logits at
              80 positions a sample) through ``paddle.Model``: bf16 O2,
              AdamW on a ``LinearWarmup`` rate, ``Accuracy``; ``fit``
              over 6 batches of 8 x 512 (eager) with ``ModelCheckpoint``,
              ``LRScheduler`` and ``EarlyStopping``; ``evaluate``,
              ``predict``, the checkpoint loaded bitwise, ``summary``;
              K1-K3's bf16 dropout instances 12 a train batch each, K1 12
              an eval or predict batch, the plain route never.
27. ops     — the 362 schema rows of the op suites
              (``tests/torch_op_rows.py``) on the card against the CPU.
28. resnet_fit — ResNet-50 (f32, TF32 off) through ``paddle.Model`` at
              PaddleClas's per-card recipe over ``FakeData`` and 4 loader
              workers: step ms, images/s, the loader's wait, idle share,
              launches a step, peak.
29. mobilenet_fit — MobileNetV3-large (5,483,032 parameters) at
              resnet_fit's recipe over 64 seeded images in 10 class
              folders, read and augmented in 4 workers (RandomResizedCrop
              224, flip, Normalize); the same figures, and every batch
              ``[64, 3, 224, 224]`` float32 through the ring.
30. vision_ops — the detection ops of ``vision.ops`` and Viterbi
              decoding at YOLOv3, Faster R-CNN, R-FCN and DCNv2 shapes on
              the card against the CPU (forward and gradient within
              1e-4 of scale, ``nms`` and the paths equal), each op's warm
              ms.  No kernel of the port runs in 27-30.
31. sparse_train — SECOND's sparse middle encoder (mmdet3d
              ``SparseEncoder`` of ``hv_second_secfpn_6x8_80e_kitti-3d-car``:
              ``sparse_shape`` [41, 1600, 1408], 4 input features, 8
              SubmConv3D and 4 strided Conv3D, each with BatchNorm and
              ReLU) from the port's ``sparse.nn``, f32, trained with AdamW
              on batches of 6 KITTI-like scans (ray-cast ground, facades,
              hedges, cars and pedestrians; up to 16,000 voxels each) for
              12 steps on the mean square of the BEV map ``[6, 256, 200,
              176]`` against a seeded target, every step building its
              rulebooks on the card.  Prints the first layer's mean active
              neighbours (at least 4), step ms (median and quartiles after
              2 warm-up steps), ms building rulebooks against ms in
              gather-GEMM-scatter, host reads and rulebooks a step (8 each),
              active sites per layer, peak memory and the idle share; then
              a batch-1 step against the CPU: every layer's sites and
              rulebook pairs equal, the BEV map and every gradient within
              1e-3 of their largest magnitude, the CPU on the card's ReLU
              masks and every site where they differ from its own within
              1e-3 of its layer's largest input.
32. signal_fft — Whisper's spectrogram front end (openai/whisper
              ``audio.py``: 16 kHz, N_FFT 400, HOP_LENGTH 160, Hann window):
              ``signal.stft`` of 16 seeded 30-s chunks, ``[16, 201, 3001]``
              complex64, on the card against the CPU within 1e-4 of the
              largest magnitude; ``istft(stft(x))``'s largest error
              against x; ``fft.rfft2``, ``irfft2``, ``fftn`` and ``hfftn``
              at ``[16, 512, 512]`` held the same way; each one's warm ms.
33. distributions — 2**22 draws on the card from each of Normal,
              Uniform, Categorical (1,000 classes), Multinomial, Beta and
              Dirichlet, means and variances within 5 standard errors of
              the closed forms (each draw's ms); ``log_prob``, ``entropy``
              and every registered KL on the card against the CPU within
              1e-5 of the largest magnitude; ``Normal.rsample`` inside a
              ``jit.to_static`` CUDA graph: two replays drawing different
              values that hold the law, the generator's offset one a call
              as in eager mode.  No kernel of the port runs in 31-33; each
              prints its seconds, and the ``done`` line their sum.
34. static_train — GPT-2 345M at full width (24 layers, f32, TF32 off)
              built from ``models.gpt`` under ``enable_static()`` and
              ``program_guard``: ``static.data`` feeds ``[8, 1024]``,
              ``AdamW(None, lr=1e-4).minimize(loss)``, 12
              ``Executor.run`` steps on seeded batches; the first 3 losses
              within 1e-5 relative of the same model's eager steps, one
              train program and one CUDA graph capture, K1-K3's f32
              instances 24 launches a step; step ms (median and quartiles
              past the two build calls), tokens/s, peak; four more steps
              under the ported ``Profiler`` (CLOSED, READY, RECORD,
              RECORD_AND_RETURN), each in a ``RecordEvent``:
              ``static_step`` exactly 2 calls in the host table, each
              K1-K3 f32 kernel exactly 48 in the device table, the
              window's idle share, ``summary()``'s rows; the same window
              without the READY step (its counts printed, not held); a
              batch-1
              forward program through ``save_inference_model`` and
              ``load_inference_model`` onto the card, its logits within
              1e-4 of the live program's and K1 launching 24 times.
35. extensions — ``register_op`` with a ``vjp`` eagerly and in a
              ``to_static`` program (eager call, capture, replay: values
              and gradients equal); ``register_kernel("relu",
              backend="gpu")`` taken by card tensors, not CPU ones;
              ``cpp_extension.load`` of ``tests/test_custom_kernel.py``'s
              C++ source: eager on card tensors within 1e-6 of
              ``F.softsign``, refused in a capture (``CaptureError``
              naming the op); ``hub.load`` of a local hubconf building a
              port layer on the card.  The ``done`` line gives 34-35's
              seconds.  The kernels phase also times K1-K3's f32
              instances at the train shape (static_train's), listed in
              the kernels line as ``*_f32`` (K1's f32 dropout instance,
              on no main path, in the kernels phase's line only).

Before the last line it prints the card line of ``nvidia-smi`` and one
``{"kernels": [...]}`` line (K1-K5, K1-K3's dropout instances, every
f16 instance and the conditional nodes' kernel ``graph_conditional``
(``dy2static_generate``'s replay): each kernel's ``launches`` on its main
path,
``train_recipe`` for the dropout instances, ``train_fp16_scaler`` for
K1-K3's f16 ones, ``serve_f16``'s 7B run for K4/K5's, and
``launches_by_phase``, ``hybrid_train``'s fleet steps, ``nn_encoder``'s
train steps and ``hapi_fit``'s fit among them); the
last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without that line.  No phase falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published peaks of one H100 SXM (dense): HBM bytes/s and flops/s by the
# inputs' type.  f32 work at f32 accuracy runs fastest on the tensor cores
# as three tf32 products a product (3xTF32) at 495 TFLOP/s, past the
# 67 TFLOP/s of f32 outside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12,
              torch.float16: 989e12}
#: max abs error of a kernel's output against its plain version: f16 keeps
#: three more mantissa bits than bf16, so its bound is a third of bf16's
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 1e-2}
LSE_TOLERANCE = 1e-3

CARD = ""
#: nvcc's seconds per library in this run's build phase
BUILD_SECONDS: dict = {}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


#: cycles of the spin kernel that holds the card while the host enqueues a
#: timed run (~25 ms at the H100's 1.98 GHz boost clock)
SPIN_CYCLES = 50_000_000

#: bytes written between cold timed calls: twice the H100's 50 MB L2
L2_FLUSH_BYTES = 2 * 50 * 10 ** 6


def cuda_ms(fn, iters: int = 10, warmup: int = 2, alone: bool = False,
            flush: bool = False) -> float:
    """Mean device milliseconds of ``fn()`` on the current stream (CUDA
    events).  A spin kernel (``torch.cuda._sleep``) keeps the card busy
    while the host enqueues the timed calls, so the host's own time per
    call (a wrapper's checks, the launch) does not show as device time
    unless it exceeds the spin.  By default the ``iters`` calls run back
    to back between two events (each call's head overlapping the last
    one's tail, and finding its data in L2).  ``alone`` times each call
    between its own pair of events, all of them queued behind one longer
    spin; ``flush`` (which implies ``alone``) also writes
    ``L2_FLUSH_BYTES`` before each call, outside its events, as a caller
    between two steps finds the cache: the two ``alone`` times differ by
    the L2's effect only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not (alone or flush):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    buf = torch.empty(L2_FLUSH_BYTES // 4 if flush else 1,
                      dtype=torch.int32, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(4 * SPIN_CYCLES)
    for start, end in events:
        if flush:
            buf.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def host_ms(fn, iters: int = 5) -> float:
    """Mean host milliseconds ``fn()`` takes to return (its device work
    enqueued, not waited for), after a call and a sync."""
    fn()
    torch.cuda.synchronize()
    spent = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        spent += time.perf_counter() - t0
        torch.cuda.synchronize()
    return spent / iters * 1e3


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 1: build --------------------------------------------------------

def _cuobjdump() -> str:
    """The toolkit's ``cuobjdump`` (beside ``nvcc``), else Triton's copy."""
    from paddle_tpu_torch.ops import kernels

    cands = [os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        cands.append(os.path.join(spec.submodule_search_locations[0],
                                  "backends", "nvidia", "bin", "cuobjdump"))
    for cand in cands:
        if os.path.exists(cand):
            return cand
    raise RuntimeError(f"cuobjdump not found (looked at {cands})")


def kernel_label(mangled: str) -> str:
    """``_ZN2pt16flash_fwd_kernelI13__nv_bfloat16Li64EE...`` ->
    ``flash_fwd_kernel<bf16,64>`` (``I6__half`` -> ``f16``, ``If`` ->
    ``f32``; and ``...Li128ELi4EE...`` -> ``<bf16,128,4>``); other names
    are returned as they are."""
    m = re.search(r"_ZN2pt(\d+)", mangled)
    if m is None:
        return mangled
    name = mangled[m.end():m.end() + int(m.group(1))]
    t = re.match(r"I(13__nv_bfloat16|6__half|f)((?:Li\d+E)+)",
                 mangled[m.end() + len(name):])
    if t is None:
        return name
    ints = ",".join(re.findall(r"Li(\d+)E", t.group(2)))
    dtype = {"f": "f32", "6__half": "f16"}.get(t.group(1), "bf16")
    return f"{name}<{dtype},{ints}>"


def hgmma_counts(lib_path: str) -> dict:
    """Per kernel of a built library, the number of ``HGMMA`` (wgmma)
    instructions in its SASS (``cuobjdump -sass``)."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = kernel_label(line.split("Function :")[1].strip())
            counts[current] = 0
        elif current is not None and "HGMMA" in line:
            counts[current] += 1
    return counts


def ptxas_by_kernel(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> per kernel instance its spill line
    and its registers line, e.g. ``{"flash_fwd_kernel<bf16,64>": "0 bytes
    stack frame, 0 bytes spill stores, 0 bytes spill loads; Used 95
    registers, used 1 barriers"}``."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = kernel_label(m.group(1))
            out[current] = []
        elif current is not None and ("registers" in line
                                      or "spill" in line):
            out[current].append(line.split("ptxas info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def phase_build() -> dict:
    """Builds every library and returns per library its ``HGMMA`` count
    by kernel.  The line shows nvcc's seconds, the ``ptxas`` registers
    and spills of each kernel, and the ``HGMMA`` counts."""
    from paddle_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    info = kernels.build()
    secs = time.perf_counter() - t0
    ptxas = {name: ptxas_by_kernel(rec["ptxas"])
             for name, rec in info.items()}
    hgmma = {name: hgmma_counts(rec["path"]) for name, rec in info.items()}
    emit("build", seconds=round(secs, 3),
         per_library={n: r["seconds"] for n, r in info.items()},
         ptxas=ptxas, hgmma=hgmma)
    BUILD_SECONDS.update({n: r["seconds"] for n, r in info.items()})
    return hgmma


#: (library, kernel) whose bf16 and f16 instances must run on tensor cores
TENSOR_CORE_KERNELS = (("flash_attention_fwd", "flash_fwd_kernel"),
                       ("paged_attention", "paged_prefill_kernel"),
                       ("flash_attention_bwd", "flash_bwd_dkv_kernel"),
                       ("flash_attention_bwd", "flash_bwd_dq_kernel"),
                       ("flash_attention_fwd", "flash_fwd_dropout_kernel"),
                       ("flash_attention_bwd",
                        "flash_bwd_dkv_dropout_kernel"),
                       ("flash_attention_bwd", "flash_bwd_dq_dropout_kernel"))
#: ... and whose f32 instances must too (3xTF32): K1 and K2, p 0 and dropout
F32_TENSOR_CORE_KERNELS = (
    ("flash_attention_fwd", "flash_fwd_kernel"),
    ("flash_attention_fwd", "flash_fwd_dropout_kernel"),
    ("flash_attention_bwd", "flash_bwd_dkv_kernel"),
    ("flash_attention_bwd", "flash_bwd_dkv_dropout_kernel"))


def check_tensor_cores(hgmma: dict) -> None:
    """Every bf16 and every f16 instance of ``TENSOR_CORE_KERNELS`` (K1,
    K5, K2, K3 and K1-K3's dropout instances), and every f32 one of
    ``F32_TENSOR_CORE_KERNELS``, has HGMMA instructions."""
    from paddle_tpu_torch.ops.kernels import HEAD_DIMS

    for lib, kernel, dtypes in (
            [(lib, k, ("bf16", "f16")) for lib, k in TENSOR_CORE_KERNELS]
            + [(lib, k, ("f32",)) for lib, k in F32_TENSOR_CORE_KERNELS]):
        for dtype in dtypes:
            for d in HEAD_DIMS:
                label = f"{kernel}<{dtype},{d}>"
                if not hgmma.get(lib, {}).get(label, 0) > 0:
                    raise AssertionError(f"{label} in {lib} has no HGMMA "
                                         f"instruction: {hgmma.get(lib)}")


# -- phase 2: kernels against their plain versions ------------------------

def _pool(rs_gen, n_blocks, bs, hkv, d, dtype, layers=2):
    """A two-layer pool; the kernels get the strided view of layer 1."""
    shape = (n_blocks, layers, bs, hkv, d)
    k = torch.randn(shape, generator=rs_gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=rs_gen, device="cuda").to(dtype)
    return k[:, 1], v[:, 1]


def check_decode(gen, H, Hkv, dtype, lengths, D=128, bs=16, max_seq=4096,
                 shared_blocks=0, inf_at=0):
    """K4 against ``gather_block_kv`` + ``cached_attention`` on a strided
    one-layer view of a two-layer pool, the slots' blocks shuffled.
    ``shared_blocks``: every table row starts with row 0's first blocks
    (a prefix-cache hit).  Two calls on the same inputs must agree bitwise
    (``res["bitwise"]``).  ``inf_at``: that many live V rows of slot 0
    hold +inf in lane 0 of kv head 0 (as a projection that overflowed f16
    writes them), and ``err`` is the share of outputs whose finiteness
    differs from the plain version's (:func:`_finite_mismatch`)."""
    from paddle_tpu_torch.ops import cached_attention as ca
    from paddle_tpu_torch.ops import kernels

    B = len(lengths)
    MB = max_seq // bs
    kp, vp = _pool(gen, B * MB + 1, bs, Hkv, D, dtype)
    perm = torch.randperm(B * MB, generator=gen, device="cuda") + 1
    tables = perm.reshape(B, MB).to(torch.int32)
    if shared_blocks:
        tables[:, :shared_blocks] = tables[0, :shared_blocks].clone()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
    for p in range(inf_at):
        pos = (p + 1) * min(lengths[0], MB * bs - 1) // (inf_at + 1)
        vp[int(tables[0, pos // bs]), pos % bs, 0, 0] = float("inf")

    def kern():
        return kernels.paged_decode(q, kp, vp, tables, lens)

    def plain():
        return ca.cached_attention(q, ca.gather_block_kv(kp, tables),
                                   ca.gather_block_kv(vp, tables), lens)

    valid = (torch.arange(MB * bs, device="cuda")[None, :]
             <= lens.long()[:, None])[:, None, None, :]

    def library():   # 2 calls: index_select gather + SDPA with a mask
        kg = kp.index_select(0, tables.reshape(-1).long()).reshape(
            B, MB * bs, Hkv, D)
        vg = vp.index_select(0, tables.reshape(-1).long()).reshape(
            B, MB * bs, Hkv, D)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            attn_mask=valid, enable_gqa=H != Hkv).transpose(1, 2)

    got = kern()
    over = _finite_mismatch(got, plain()) if inf_at else {}
    err = over["err"] if inf_at else \
        (got.float() - plain().float()).abs().max().item()
    bitwise = torch.equal(got, kern())
    # the bound reads each live K/V row once: a row shared by several
    # slots' tables counts once
    rows = set()
    for row, n in zip(tables.tolist(), lengths):
        rows.update((row[p // bs], p % bs) for p in range(min(n + 1,
                                                              MB * bs)))
    keys = sum(min(n + 1, MB * bs) for n in lengths)
    isz = torch.finfo(dtype).bits // 8
    nbytes = len(rows) * Hkv * D * 2 * isz + 2 * B * H * D * isz \
        + tables.numel() * 4 + B * 4
    return {"err": err, "bitwise": bitwise, "kern": kern, "plain": plain,
            "library": library,
            "bound": bound(nbytes, 4 * H * D * keys, dtype), **over}


def _finite_mismatch(got, want) -> dict:
    """Outputs that must be non-finite exactly where the plain version's
    are (never clamped): ``err`` is the share of elements whose finiteness
    differs (held to 0), beside the non-finite counts; some must exist."""
    bad_kern = int((~torch.isfinite(got)).sum())
    bad_plain = int((~torch.isfinite(want)).sum())
    if not (bad_kern > 0 and bad_plain > 0):
        raise AssertionError(f"overflow: non-finite outputs kernel "
                             f"{bad_kern}, plain {bad_plain}: the inf did "
                             f"not reach the outputs")
    differ = int((torch.isfinite(got) != torch.isfinite(want)).sum())
    return {"err": differ / got.numel(), "tol": 0.0,
            "nonfinite_kernel": bad_kern, "nonfinite_plain": bad_plain}


def check_prefill(gen, H, Hkv, dtype, start, S, D=128, bs=16, max_seq=4096,
                  inf_at=0):
    """K5 against ``gather_block_kv`` + ``block_prefill_attention``;
    ``inf_at`` as :func:`check_decode` (V rows of the cached prefix)."""
    from paddle_tpu_torch.ops import cached_attention as ca
    from paddle_tpu_torch.ops import kernels

    MB = max_seq // bs
    kp, vp = _pool(gen, 4 * MB + 1, bs, Hkv, D, dtype)
    row = (torch.randperm(4 * MB, generator=gen, device="cuda")[:MB]
           + 1).to(torch.int32)
    q = torch.randn((1, S, H, D), generator=gen, device="cuda").to(dtype)
    for p in range(inf_at):
        pos = (p + 1) * start // (inf_at + 1)
        vp[int(row[pos // bs]), pos % bs, 0, 0] = float("inf")

    start_t = torch.tensor([start], dtype=torch.int32, device="cuda")

    def kern():
        return kernels.paged_prefill(q, kp, vp, row, start_t)

    def plain():
        return ca.block_prefill_attention(
            q, ca.gather_block_kv(kp, row[None]),
            ca.gather_block_kv(vp, row[None]), start_t)

    T = MB * bs
    valid = (torch.arange(T, device="cuda")[None, :]
             <= start + torch.arange(S, device="cuda")[:, None])

    def library():   # 2 calls: index_select gather + SDPA with a mask
        kg = kp.index_select(0, row.long()).reshape(1, T, Hkv, D)
        vg = vp.index_select(0, row.long()).reshape(1, T, Hkv, D)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            attn_mask=valid, enable_gqa=H != Hkv).transpose(1, 2)

    over = _finite_mismatch(kern(), plain()) if inf_at else {}
    err = over["err"] if inf_at else \
        (kern().float() - plain().float()).abs().max().item()
    isz = torch.finfo(dtype).bits // 8
    keys = sum(start + i + 1 for i in range(S))
    nbytes = (start + S) * Hkv * D * 2 * isz + 2 * S * H * D * isz + MB * 4
    return {"err": err, "kern": kern, "plain": plain, "library": library,
            "bound": bound(nbytes, 4 * H * D * keys, dtype), **over}


#: the dropout draw the kernels phase holds K1-K3's dropout instances with
DROPOUT_SNAPSHOT = (1234, 5)


def _snapshot():
    return torch.tensor(DROPOUT_SNAPSHOT, dtype=torch.int64, device="cuda")


def check_flash(gen, B, S, H, dtype, D=128, causal=True, fused=False,
                dropout_p=0.0):
    """K1 on separate q/k/v, or (``fused``) on strided views of one
    ``[B, S, H, 3*D]`` projection as the GPT model hands them over;
    ``dropout_p > 0``: K1's dropout instance and the plain version on the
    draw ``DROPOUT_SNAPSHOT`` (the library call: SDPA with the same rate,
    its own mask)."""
    from paddle_tpu_torch.obs.cost import attention_cost
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import _flash_fwd_reference

    if fused:
        q, k, v = torch.randn((B, S, H, 3 * D), generator=gen,
                              device="cuda").to(dtype).split(D, dim=-1)
    else:
        q, k, v = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))

    snap = _snapshot() if dropout_p else None

    def kern():
        return kernels.flash_fwd(q, k, v, causal, dropout_p, snap)

    def plain():
        return _flash_fwd_reference(q, k, v, causal, dropout_p, snap)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, dropout_p=dropout_p).transpose(1, 2)

    (o, lse), (o_ref, lse_ref) = kern(), plain()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    o2, lse2 = kern()
    bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
    del o2, lse2
    flops, nbytes = attention_cost("fwd", q, causal)
    # dropout multiplies every kept probability, and so O, by 1 / (1 - p):
    # the p = 0 tolerance on that scale (one bf16 ulp of an output in
    # [4, 8) is 2**-5, past the unscaled 3e-2)
    return {"err": err, "lse_err": lse_err, "kern": kern, "plain": plain,
            "library": library, "tol": TOLERANCE[dtype] / (1 - dropout_p),
            "bitwise": bitwise, "bound": bound(nbytes, flops, dtype)}


#: K2/K3 gradients are sums over up to S rows: held relative to the plain
#: version's largest value
BWD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
                 torch.float16: 1e-2}


def check_flash_bwd(gen, which: str, B, S, H, dtype, D=64, causal=True,
                    dropout_p=0.0):
    """K2 (``which="flash_bwd_dkv"``) or K3 (``"flash_bwd_dq"``) on q/k/v
    taken as strided views of one fused ``[B, S, H, 3*D]`` projection, as
    the GPT model hands them over, with lse and delta from the plain
    forward.  The library call is one ``torch.autograd.grad`` through
    SDPA giving dq, dk and dv together; its forward runs at the first
    call (a warm-up call of the timing).  ``dropout_p > 0``: the dropout
    instances and plain versions on the draw ``DROPOUT_SNAPSHOT`` (SDPA
    with the same rate for the library)."""
    from paddle_tpu_torch.obs.cost import attention_cost
    from paddle_tpu_torch.ops import attention as att
    from paddle_tpu_torch.ops import kernels

    q, k, v = torch.randn((B, S, H, 3 * D), generator=gen,
                          device="cuda").to(dtype).split(D, dim=-1)
    do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    snap = _snapshot() if dropout_p else None
    o, lse = att._flash_fwd_reference(q, k, v, causal, dropout_p, snap)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
        .contiguous().view(B * H, S)
    del o
    args = (q, k, v, do, lse, delta, causal, dropout_p, snap)
    if which == "flash_bwd_dkv":
        def kern():
            return kernels.flash_bwd_dkv(*args)

        def plain():
            return att._flash_bwd_dkv_reference(*args)
    else:
        def kern():
            return (kernels.flash_bwd_dq(*args),)

        def plain():
            return (att._flash_bwd_dq_reference(*args),)
    ref, got, again = plain(), kern(), kern()
    scale = max(r.float().abs().max().item() for r in ref)
    err = max((a.float() - r.float()).abs().max().item()
              for a, r in zip(got, ref))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del ref, got, again
    graph = []

    def library():
        if not graph:
            qkv = [t.transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v)]
            graph.append((torch.nn.functional.scaled_dot_product_attention(
                *qkv, is_causal=causal, dropout_p=dropout_p), qkv))
        out, qkv = graph[0]
        return torch.autograd.grad(out, qkv, do.transpose(1, 2),
                                   retain_graph=True)
    flops, nbytes = attention_cost(
        "bwd_dkv" if which == "flash_bwd_dkv" else "bwd_dq", q, causal)
    return {"err": err, "tol": BWD_TOLERANCE[dtype] * scale,
            "kern": kern, "plain": plain, "library": library,
            "bitwise": bitwise, "bound": bound(nbytes, flops, dtype)}


def check_dropout_mask(dtype, S=64, H=2, p=0.25):
    """K1's dropout instance with every probability of a row equal (q = k
    = 0) and V one-hot by key (``[S, D]`` the identity, D = S = 64), so
    that ``O[q, key] = P[q, key] * M[q, key] / (1 - p)`` exposes the mask:
    the count of causal (q, key) where O is nonzero and the plain mask
    drops it, or the reverse (0 holds it exactly)."""
    from paddle_tpu_torch import rng
    from paddle_tpu_torch.ops import kernels

    q = torch.zeros((1, S, H, 64), dtype=dtype, device="cuda")
    v = torch.eye(64, dtype=dtype, device="cuda")[None, :, None, :] \
        .expand(1, S, H, 64).contiguous()
    snap = _snapshot()
    o, _ = kernels.flash_fwd(q, q, v, True, p, snap)
    keep = (rng.attention_dropout_factor(snap, H, S, S, p) > 0) & \
        torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    got = o.float()[0].permute(1, 0, 2) != 0        # [H, q, key]
    mismatch = int((got != keep).sum().item())
    return {"err": float(mismatch), "tol": 0.0,
            "kept_share": keep.sum().item() / (H * S * (S + 1) / 2)}


#: K1-K3's dropout at a rank's coordinates: the whole ``[B, S, H, D]``
#: split as 2 batch halves x 2 head halves
COORDS_SPLIT = (2, 2)


def check_dropout_coords(gen, which: str, dtype, B=8, S=1024, H=16, D=64,
                         p=0.1):
    """A dropout instance of K1 (``which="flash_fwd"``), K2 or K3 on each
    quarter of a whole ``[B, S, H, D]`` problem (``COORDS_SPLIT``), each
    drawing at its coordinates (``rng.with_coordinates``: the draw's
    ``[seed, offset]`` then ``[batch_start, head_start, heads_total]``),
    held against the matching slice of the kernel's output on the whole
    problem (one draw) and against the plain version on the quarter with
    the same coordinates.  ``err`` is the larger of the two differences;
    ``slice_bitwise`` whether every quarter equals its slice exactly."""
    from paddle_tpu_torch import rng
    from paddle_tpu_torch.ops import attention as att
    from paddle_tpu_torch.ops import kernels

    q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    snap = _snapshot()
    o, lse = att._flash_fwd_reference(q, k, v, True, p, snap)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
        .contiguous().view(B * H, S)

    def run(q_, k_, v_, do_, lse_, delta_, draw, kernel: bool):
        if which == "flash_fwd":
            f = kernels.flash_fwd if kernel else att._flash_fwd_reference
            return (f(q_, k_, v_, True, p, draw)[0],)
        args = (q_, k_, v_, do_, lse_, delta_, True, p, draw)
        if which == "flash_bwd_dkv":
            f = kernels.flash_bwd_dkv if kernel \
                else att._flash_bwd_dkv_reference
            return f(*args)
        f = kernels.flash_bwd_dq if kernel else att._flash_bwd_dq_reference
        return (f(*args),)

    whole = run(q, k, v, do, lse, delta, snap, True)
    nb, nh = COORDS_SPLIT
    b_, h_ = B // nb, H // nh
    lse4 = lse.view(B, H, S)
    delta4 = delta.view(B, H, S)
    err = slice_err = 0.0
    scale = max(w.float().abs().max().item() for w in whole)
    bitwise = True
    for bi in range(nb):
        for hi in range(nh):
            bs, hs = slice(bi * b_, (bi + 1) * b_), slice(hi * h_,
                                                          (hi + 1) * h_)
            part = [t[bs, :, hs] for t in (q, k, v, do)]
            rows = [t[bs, hs].reshape(b_ * h_, S).contiguous()
                    for t in (lse4, delta4)]
            with rng.shard_coordinates(batch_start=bi * b_,
                                       head_start=hi * h_, heads_total=H):
                draw = rng.with_coordinates(snap, h_)
            got = run(*part, *rows, draw, True)
            ref = run(*part, *rows, draw, False)
            for g, r, w in zip(got, ref, whole):
                ws = w[bs, :, hs]
                err = max(err, (g.float() - r.float()).abs().max().item())
                d = (g.float() - ws.float()).abs().max().item()
                slice_err = max(slice_err, d)
                bitwise = bitwise and d == 0.0
    tol = (TOLERANCE[dtype] / (1 - p) if which == "flash_fwd"
           else BWD_TOLERANCE[dtype] * scale)
    return {"err": max(err, slice_err), "plain_err": err,
            "slice_err": slice_err, "slice_bitwise": bitwise, "tol": tol}


#: the share of K2/K3's outputs whose finiteness may differ from the plain
#: version's under an f16 overflow: a ds at f16's edge may round to either
#: side in another summation order
OVERFLOW_MISMATCH_SHARE = 1e-3


def check_f16_overflow(gen, which: str, B=2, S=256, H=4, D=64):
    """K2 or K3 at f16 with a finite dO of 2e4 a unit (clamped inside
    f16's range), as a large loss scale makes it, q of 4 a unit (peaked
    probabilities) and v of 30: dP ~ 5e6 in f32, so ds (rounded to f16
    before dS^T Q and dS K) and the sums pass 65504, and the outputs must
    hold inf or NaN where the plain version's do (never clamped, so that a
    loss scaler sees the overflow).  ``err`` is the share of elements
    whose finiteness differs, beside the counts of non-finite elements."""
    from paddle_tpu_torch.ops import attention as att
    from paddle_tpu_torch.ops import kernels

    scale = torch.tensor([4.0] * D + [1.0] * D + [30.0] * D, device="cuda")
    q, k, v = (torch.randn((B, S, H, 3 * D), generator=gen, device="cuda")
               * scale).half().split(D, dim=-1)
    o, lse = att._flash_fwd_reference(q, k, v, True)
    do = (torch.randn((B, S, H, D), generator=gen, device="cuda")
          * 2e4).clamp(-6e4, 6e4).half()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
        .contiguous().view(B * H, S)
    args = (q, k, v, do, lse, delta, True, 0.0, None)
    if which == "flash_bwd_dkv":
        got, want = kernels.flash_bwd_dkv(*args), \
            att._flash_bwd_dkv_reference(*args)
    else:
        got, want = (kernels.flash_bwd_dq(*args),), \
            (att._flash_bwd_dq_reference(*args),)
    bad_kern = sum(int((~torch.isfinite(a)).sum()) for a in got)
    bad_plain = sum(int((~torch.isfinite(a)).sum()) for a in want)
    differ = sum(int((torch.isfinite(a) != torch.isfinite(b)).sum())
                 for a, b in zip(got, want))
    n = sum(a.numel() for a in got)
    if not (bad_kern > 0 and bad_plain > 0):
        raise AssertionError(f"{which} f16 overflow: non-finite outputs "
                             f"kernel {bad_kern}, plain {bad_plain}: no "
                             f"overflow reached the gradients")
    return {"err": differ / n, "tol": OVERFLOW_MISMATCH_SHARE,
            "nonfinite_kernel": bad_kern, "nonfinite_plain": bad_plain}


DECODE_LENGTHS = [2047, 1800, 1536, 1200, 1024, 700, 333, 0]
#: serve_gpt's 8 slots 32 tokens into their decode: the 256-token system
#: prompt plus tails of 32, 600, 150, 77, 400, 256, 500 and 64
GPT_DECODE_LENGTHS = [320, 888, 438, 365, 688, 544, 788, 352]
#: the GPT-2 345M train step's attention shape: batch, seq, heads, head dim
TRAIN_ATTN = (8, 1024, 16, 64)
#: the GPT-2 recipe's attention dropout (train_recipe)
RECIPE_DROPOUT = 0.1


#: a case checked in f32 and bf16, or in bf16 only, or in f16 only
BOTH, BF16 = (torch.float32, torch.bfloat16), (torch.bfloat16,)
F16 = (torch.float16,)
#: K4's edge cases of :func:`decode_edges` the f16 instance is held at too:
#: windows about one split long, a length past the table, query groups
#: 1-8 at both head dims, block size 32
F16_DECODE_EDGES = ("lenP-1,P,P+1", "past_table", "G1/D64", "G1/D128",
                    "G2/D128", "G3/D128", "G4/D128", "G8/D64", "G8/D128",
                    "bs32")
SHORT = {torch.bfloat16: "bf16", torch.float16: "f16"}


def flash_edges(gen):
    """K1's edge cases, in f32 and bf16 (both on tensor cores): ragged S
    (1000, 70), causal and full, D 64 and 128; S 16 (one part-filled
    tile)."""
    out = []
    for S, causal, D in [(S, c, D) for S in (1000, 70) for c in (True, False)
                         for D in (64, 128)] + [(16, True, 64),
                                                (16, True, 128)]:
        mask = "causal" if causal else "full"
        out.append((f"S{S}/{mask}/D{D}",
                    lambda dt, S=S, c=causal, D=D: check_flash(
                        gen, 2, S, 4, dt, D, causal=c),
                    f"B=2 S={S} H=4 D={D} {mask}",
                    f"scaled_dot_product_attention is_causal={causal}",
                    BOTH, False))
    return out


def decode_edges(gen):
    """K4's edge cases, in bf16 and (the first seven) f32: an empty window,
    windows about one split long, a length past the table, one long slot,
    32 slots of 1024, a 32768-position table whose grid is capped so that
    a block walks several splits (these three timed, and held in f32 too
    so that the split walk and the merge are checked to 1e-4), query
    groups of 1, 4 and 8 at D 64 and 128 (timed at 128: the same bytes,
    more rows), of 2 and of 3 (a bucket of 4 with a row unused), block
    size 32, and tables whose rows share their first 32
    blocks (a prefix-cache hit)."""
    from paddle_tpu_torch.ops.kernels import DECODE_SPLIT_KEYS as P

    lib = "index_select + scaled_dot_product_attention with a mask (2 calls)"

    def case(label, lengths, shape, dtypes=BF16, timed=False, H=32, Hkv=32,
             **kw):
        return (label, lambda dt: check_decode(gen, H, Hkv, dt, lengths,
                                               **kw),
                shape, lib, dtypes, timed)

    out = [case("len0", [0], "B=1 length 0 H=Hkv=32 D=128 bs=16", BOTH),
           case("lenP-1,P,P+1", [P - 1, P, P + 1],
                f"B=3 lengths {P - 1},{P},{P + 1} H=Hkv=32 D=128 bs=16",
                BOTH),
           case("past_table", [1024 + 37, 500],
                "B=2 lengths 1061 (past the 1024-position table),500 "
                "H=Hkv=32 D=128 bs=16 max_seq=1024", BOTH, max_seq=1024),
           case("B1/len4095", [4095], "B=1 length 4095 H=Hkv=32 D=128 "
                "bs=16 max_seq=4096", BOTH, timed=True),
           case("B32/len1023", [1023] * 32, "B=32 lengths 1023 H=Hkv=32 "
                "D=128 bs=16 max_seq=2048", BOTH, timed=True, max_seq=2048),
           case("long_table", [30000, 700], "B=2 lengths 30000,700 H=Hkv=32 "
                "D=128 bs=16 max_seq=32768 (blocks walk several splits)",
                BOTH, timed=True, max_seq=32768),
           case("G2/D128", [0, 300, 777, 1500], "B=4 lengths 0,300,777,1500 "
                "H=8 Hkv=4 D=128 bs=16 max_seq=2048", BOTH, H=8, Hkv=4,
                max_seq=2048),
           case("G3/D128", [0, 300, 777, 1500], "B=4 lengths 0,300,777,1500 "
                "H=12 Hkv=4 D=128 bs=16 max_seq=2048", H=12, Hkv=4,
                max_seq=2048)]
    for G in (1, 4, 8):
        for D in (64, 128):
            out.append(case(f"G{G}/D{D}", [0, 300, 777, 1500],
                            f"B=4 lengths 0,300,777,1500 H={4 * G} Hkv=4 "
                            f"D={D} bs=16 max_seq=2048", timed=D == 128,
                            H=4 * G, Hkv=4, D=D, max_seq=2048))
    out += [case("bs32", [100, 1000, 2047], "B=3 lengths 100,1000,2047 "
                 "H=Hkv=32 D=128 bs=32", bs=32),
            case("shared_prefix", [600, 900, 511, 1500],
                 "B=4 lengths 600,900,511,1500 H=Hkv=32 D=128 bs=16, rows "
                 "sharing their first 32 blocks", shared_blocks=32)]
    return out


def bwd_edges(gen, which: str):
    """K2's or K3's edge cases, as :func:`flash_edges` (K2's in f32 too,
    on tensor cores like the bf16 ones; K3's f32 keeps its CUDA-core loop);
    the bf16 S 1000 causal D 128 and S 1000 full D 64 cases are timed."""
    out = []
    for S, causal, D in [(S, c, D) for S in (1000, 70) for c in (True, False)
                         for D in (64, 128)] + [(16, True, 64),
                                                (16, True, 128)]:
        mask = "causal" if causal else "full"
        out.append((f"S{S}/{mask}/D{D}",
                    lambda dt, S=S, c=causal, D=D: check_flash_bwd(
                        gen, which, 2, S, 4, dt, D, causal=c),
                    f"B=2 S={S} H=4 D={D} {mask}, q/k/v views of a fused "
                    f"[B, S, H, 3D] projection",
                    f"autograd.grad through scaled_dot_product_attention "
                    f"is_causal={causal}",
                    BOTH if which == "flash_bwd_dkv" else BF16,
                    S == 1000 and (causal, D) in ((True, 128), (False, 64))))
    return out


def phase_kernels(hgmma: dict) -> dict:
    """Every main-path case is checked in f32 and bf16 and timed in bf16;
    the edge cases of the bf16 tensor-core kernels (K1, K5, K2, K3) are
    checked in bf16, and some timed.  The f16 instances of K1-K3 (p 0 and
    dropout) are checked and timed in f16 at the train shape, on a ragged
    full shape, and (K2/K3) under an overflow.  ``hgmma`` (from the build
    phase) must show wgmma in all the 16-bit instances.  Returns per kernel the record for the
    final ``{"kernels": [...]}`` line (minus ``launches``): that of its
    main-path case, the first listed."""
    from paddle_tpu_torch.ops.kernels import KERNELS

    check_tensor_cores(hgmma)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, D = TRAIN_ATTN
    train = f"B={B} S={S} H={H} D={D} causal"
    sdpa_causal = "scaled_dot_product_attention is_causal"
    sdpa_grad = "autograd.grad through scaled_dot_product_attention " \
        "is_causal: dq, dk and dv in one call, shared by K2 and K3"
    gather_sdpa = "index_select + scaled_dot_product_attention with a " \
        "mask (2 calls)"

    def bwd(which, p=0.0):
        return lambda dt: check_flash_bwd(gen, which, B, S, H, dt, D,
                                          dropout_p=p)

    P = RECIPE_DROPOUT
    train_p = f"{train}, dropout {P} (draw {DROPOUT_SNAPSHOT})"
    # nn_encoder's attention: BERT-base's heads at its train batch, full
    nB, nS = NN_TRAIN
    nH = BERT_BASE["num_attention_heads"]
    nD = BERT_BASE["hidden_size"] // nH
    nn_p = f"B={nB} S={nS} H={nH} D={nD} full, dropout {P} (nn_encoder)"
    sdpa_p = f"{sdpa_causal} dropout_p={P} (its own mask)"
    sdpa_grad_p = f"{sdpa_grad}, dropout_p={P} (its own mask)"
    coords_p = (f"{train_p}, each of {COORDS_SPLIT[0]} batch x "
                f"{COORDS_SPLIT[1]} head quarters at its coordinates, "
                "against the whole draw's slice")

    def prefill(H, Hkv, start, S_, dtypes=BF16, timed=False, D_=128,
                max_seq=4096, label=""):
        return (label or f"S{S_}/start{start}/H{H}/Hkv{Hkv}",
                lambda dt: check_prefill(gen, H, Hkv, dt, start, S_, D=D_,
                                         max_seq=max_seq),
                f"S={S_} start={start} H={H} Hkv={Hkv} D={D_} bs=16"
                + (f" max_seq={max_seq}" if max_seq != 4096 else ""),
                gather_sdpa, dtypes, timed)

    # kernel -> [(label, make(dtype), shape, library call, dtypes, timed)],
    # main path first
    cases = {
        "paged_decode": [
            ("H32/Hkv32", lambda dt: check_decode(gen, 32, 32, dt,
                                                  DECODE_LENGTHS),
             "B=8 lengths<=2047 H=Hkv=32 D=128 bs=16",
             gather_sdpa, BOTH, True),
            ("H64/Hkv8", lambda dt: check_decode(gen, 64, 8, dt,
                                                 DECODE_LENGTHS),
             "B=8 lengths<=2047 H=64 Hkv=8 D=128 bs=16",
             gather_sdpa, BOTH, True),
            # serve_gpt's decode: GPT-2 345M's heads, its 8 slots halfway
            # through their 64 new tokens
            ("gpt345m", lambda dt: check_decode(gen, 16, 16, dt,
                                                GPT_DECODE_LENGTHS, D=64,
                                                max_seq=1024),
             "B=8 lengths<=888 H=Hkv=16 D=64 bs=16 max_seq=1024",
             gather_sdpa, BOTH, True),
            *decode_edges(gen)],
        "paged_prefill": [
            ("H32/Hkv32", lambda dt: check_prefill(gen, 32, 32, dt, 512,
                                                   512),
             "S=512 start=512 H=Hkv=32 D=128 bs=16",
             gather_sdpa, BOTH, True),
            ("H64/Hkv8", lambda dt: check_prefill(gen, 64, 8, dt, 512,
                                                  512),
             "S=512 start=512 H=64 Hkv=8 D=128 bs=16",
             gather_sdpa, BOTH, True),
            # the 1000-token admission's bucket after a 512-token prefix
            prefill(32, 32, 512, 1024, timed=True),
            # serve_gpt's admissions (GPT-2 345M's heads, a 1024-position
            # table): a bucket-512 tail after its 256-token system prompt,
            # and the bucket-1024 tail, which the table holds only from 0
            prefill(16, 16, 256, 512, BOTH, True, D_=64, max_seq=1024,
                    label="gpt345m/S512/start256"),
            prefill(16, 16, 0, 1024, BOTH, True, D_=64, max_seq=1024,
                    label="gpt345m/S1024/start0"),
            prefill(32, 32, 0, 16),
            prefill(64, 8, 0, 16),
            prefill(32, 32, 1008, 32),
            prefill(64, 8, 1008, 32)],
        "flash_fwd": [
            ("train", lambda dt: check_flash(gen, B, S, H, dt, D), train,
             sdpa_causal, BOTH, True),
            ("serve", lambda dt: check_flash(gen, 1, 1024, 32, dt),
             "B=1 S=1024 H=32 D=128 causal", sdpa_causal, BOTH, True),
            ("train/fused", lambda dt: check_flash(gen, B, S, H, dt, D,
                                                   fused=True),
             train + ", q/k/v views of a fused [B, S, H, 3D] projection",
             sdpa_causal, BOTH, True),
            *flash_edges(gen)],
        "flash_bwd_dkv": [("train", bwd("flash_bwd_dkv"), train, sdpa_grad,
                           BOTH, True), *bwd_edges(gen, "flash_bwd_dkv")],
        "flash_bwd_dq": [("train", bwd("flash_bwd_dq"), train, sdpa_grad,
                          BOTH, True), *bwd_edges(gen, "flash_bwd_dq")],
        # the dropout instances: the train shape at the recipe's rate,
        # nn_encoder's full-mask shape (bf16, as it runs there), a ragged
        # full-mask shape, and (K1) the exact mask
        "flash_fwd_dropout": [
            ("train", lambda dt: check_flash(gen, B, S, H, dt, D,
                                             dropout_p=P),
             train_p, sdpa_p, BOTH, True),
            ("nn_encoder", lambda dt: check_flash(
                gen, nB, nS, nH, dt, nD, causal=False, dropout_p=P),
             nn_p, sdpa_p, BF16, False),
            ("S1000/full/D128", lambda dt: check_flash(
                gen, 2, 1000, 4, dt, 128, causal=False, dropout_p=P),
             f"B=2 S=1000 H=4 D=128 full, dropout {P}", sdpa_p, BOTH,
             False),
            ("exact_mask", check_dropout_mask,
             "B=1 S=64 H=2 D=64 causal, dropout 0.25, q=k=0, V one-hot",
             sdpa_p, BOTH, False),
            ("coords", lambda dt: check_dropout_coords(gen, "flash_fwd",
                                                       dt, B, S, H, D, P),
             coords_p, sdpa_p, BF16, False)],
        "flash_bwd_dkv_dropout": [
            ("train", bwd("flash_bwd_dkv", P), train_p, sdpa_grad_p, BOTH,
             True),
            ("nn_encoder", lambda dt: check_flash_bwd(
                gen, "flash_bwd_dkv", nB, nS, nH, dt, nD, causal=False,
                dropout_p=P), nn_p, sdpa_grad_p, BF16, False),
            ("S1000/full/D128", lambda dt: check_flash_bwd(
                gen, "flash_bwd_dkv", 2, 1000, 4, dt, 128, causal=False,
                dropout_p=P),
             f"B=2 S=1000 H=4 D=128 full, dropout {P}", sdpa_grad_p, BOTH,
             False),
            ("coords", lambda dt: check_dropout_coords(
                gen, "flash_bwd_dkv", dt, B, S, H, D, P), coords_p,
             sdpa_grad_p, BF16, False)],
        "flash_bwd_dq_dropout": [
            ("train", bwd("flash_bwd_dq", P), train_p, sdpa_grad_p, BOTH,
             True),
            ("nn_encoder", lambda dt: check_flash_bwd(
                gen, "flash_bwd_dq", nB, nS, nH, dt, nD, causal=False,
                dropout_p=P), nn_p, sdpa_grad_p, BF16, False),
            ("S1000/full/D128", lambda dt: check_flash_bwd(
                gen, "flash_bwd_dq", 2, 1000, 4, dt, 128, causal=False,
                dropout_p=P),
             f"B=2 S=1000 H=4 D=128 full, dropout {P}", sdpa_grad_p, BF16,
             False),
            ("coords", lambda dt: check_dropout_coords(
                gen, "flash_bwd_dq", dt, B, S, H, D, P), coords_p,
             sdpa_grad_p, BF16, False)],
    }
    # the f16 instances of K1-K3 (AMP O1 at float16 with a loss scaler):
    # the train shape on the fused projection's views at p 0 and at the
    # recipe's p, a ragged full shape, and (K2/K3) an overflow
    fused = train + ", q/k/v views of a fused [B, S, H, 3D] projection"
    ragged = "B=2 S=1000 H=4 D=128 full"
    for p_, sfx, sdpa, grad in ((0.0, "", sdpa_causal, sdpa_grad),
                                (P, "_dropout", sdpa_p, sdpa_grad_p)):
        drop = f", dropout {P} (draw {DROPOUT_SNAPSHOT})" if p_ else ""
        cases[f"flash_fwd{sfx}_f16"] = [
            ("train", lambda dt, p_=p_: check_flash(
                gen, B, S, H, dt, D, fused=True, dropout_p=p_),
             fused + drop, sdpa, F16, True),
            ("S1000/full/D128", lambda dt, p_=p_: check_flash(
                gen, 2, 1000, 4, dt, 128, causal=False, dropout_p=p_),
             ragged + drop, sdpa.replace("is_causal", "full"), F16, False)]
        for which in ("flash_bwd_dkv", "flash_bwd_dq"):
            cases[f"{which}{sfx}_f16"] = [
                ("train", bwd(which, p_), train + drop, grad, F16, True),
                ("S1000/full/D128", lambda dt, w=which, p_=p_:
                 check_flash_bwd(gen, w, 2, 1000, 4, dt, 128, causal=False,
                                 dropout_p=p_),
                 ragged + drop, grad, F16, False)]
            if not p_:
                cases[f"{which}_f16"].append(
                    ("overflow", lambda dt, w=which: check_f16_overflow(
                        gen, w),
                     "B=2 S=256 H=4 D=64 causal, q ~ 4, v ~ 30, dO ~ 2e4 "
                     "(ds past 65504)",
                     grad, F16, False))
    # the f16 instances of K4/K5 (f16 serving): the main path's and
    # serve_gpt's shapes, K4's edges, and an overflow
    cases["paged_decode_f16"] = [
        (label, make, shape, lib, F16, timed)
        for label, make, shape, lib, _, timed in cases["paged_decode"]
        if label in ("H32/Hkv32", "gpt345m")] + [
        (label, make, shape, lib, F16, False)
        for label, make, shape, lib, _, _ in decode_edges(gen)
        if label in F16_DECODE_EDGES] + [
        ("overflow", lambda dt: check_decode(gen, 32, 32, dt,
                                             DECODE_LENGTHS, inf_at=3),
         "B=8 lengths<=2047 H=Hkv=32 D=128 bs=16, 3 V rows of slot 0 "
         "+inf (outputs non-finite where the plain version's are)",
         gather_sdpa, F16, False)]
    cases["paged_prefill_f16"] = [
        (label, make, shape, lib, F16, timed)
        for label, make, shape, lib, _, timed in cases["paged_prefill"]
        if label in ("H32/Hkv32", "gpt345m/S512/start256",
                     "S16/start0/H64/Hkv8", "S32/start1008/H64/Hkv8")] + [
        ("overflow", lambda dt: check_prefill(gen, 32, 32, dt, 512, 512,
                                              inf_at=3),
         "S=512 start=512 H=Hkv=32 D=128 bs=16, 3 V rows of the prefix "
         "+inf (outputs non-finite where the plain version's are)",
         gather_sdpa, F16, False)]
    out, library_ms = {}, {}      # one figure per (shape, call, dtype)
    for name, shapes in cases.items():
        errors, tolerances, lse_errors, timed = {}, {}, {}, []
        # K1-K3 at the train shape in f32 (static_train's), and K1's
        # dropout instance there
        timed_f32 = []
        for label, make, shape, library_call, dtypes, is_timed in shapes:
            for dt in dtypes:
                res = make(dt)
                tol = res.get("tol", TOLERANCE[dt])
                key = f"{label}/{str(dt).split('.')[-1]}"
                errors[key], tolerances[key] = res["err"], tol
                if res["err"] > tol or not np.isfinite(res["err"]):
                    raise AssertionError(
                        f"{name} {key}: max abs err {res['err']} > {tol}")
                if not res.get("bitwise", True):
                    raise AssertionError(f"{name} {key}: two calls on the "
                                         f"same inputs differ")
                if "lse_err" in res:
                    lse_errors[key] = res["lse_err"]
                    if not res["lse_err"] <= LSE_TOLERANCE:
                        raise AssertionError(
                            f"{name} {key}: lse err {res['lse_err']} > "
                            f"{LSE_TOLERANCE}")
                f32_row = dt == torch.float32 and label == "train" and \
                    name in F32_TIMED
                if (dt != torch.float32 and is_timed) or f32_row:
                    bound_ms, bound_by = res["bound"]
                    lib = (shape, library_call, dt)
                    if lib not in library_ms:
                        library_ms[lib] = cuda_ms(res["library"], iters=5,
                                                  flush=True)
                    (timed_f32 if f32_row else timed).append({
                        "case": label,
                        "shape": f"{shape} {SHORT.get(dt, 'f32')}",
                        "max_abs_err": res["err"], "tolerance": tol,
                        "ms": cuda_ms(res["kern"], flush=True),
                        "warm_ms": cuda_ms(res["kern"], alone=True),
                        "batched_ms": cuda_ms(res["kern"]),
                        "plain_ms": cuda_ms(res["plain"], iters=3,
                                            flush=True),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms[lib],
                        "library_call": library_call})
                del res
                torch.cuda.synchronize()
                gc.collect()
                torch.cuda.empty_cache()
        info = KERNELS[name]
        out[name] = {"name": name, "route": "cuda", "source": info.source,
                     "replaces": info.replaces, **timed[0]}
        if timed_f32 and name in TRAIN_KERNELS:
            # the f32 instance shares the launch counter of ``name``
            out[f"{name}_f32"] = {"name": f"{name}_f32", "route": "cuda",
                                  "source": info.source,
                                  "replaces": info.replaces, **timed_f32[0]}
        emit("kernels", kernel=name, errors=errors, tolerances=tolerances,
             **({"lse_errors": lse_errors, "lse_tolerance": LSE_TOLERANCE}
                if lse_errors else {}),
             timed=timed + timed_f32)
    return out


# -- phases 3, 4 and 5: serving ---------------------------------------------

def sampling_laws(seed: int):
    """Greedy, temperature, top-k and top-p, the three drawn laws seeded
    from ``seed``."""
    from paddle_tpu_torch.serving import SamplingParams

    return [SamplingParams(),
            SamplingParams(temperature=0.8, seed=seed + 1),
            SamplingParams(temperature=1.0, top_k=40, seed=seed + 2),
            SamplingParams(temperature=0.7, top_p=0.9, seed=seed + 3)]


def make_requests(vocab: int, n: int, prefix_len: int, tail_lens, seed: int):
    """``n`` prompts sharing one ``prefix_len``-token system prompt, tails
    cycling through ``tail_lens``, with greedy, temperature, top-k and
    top-p requests in turn (seeded)."""
    rs = np.random.RandomState(seed)
    system = rs.randint(0, vocab, (prefix_len,)).tolist()
    laws = sampling_laws(seed)
    out = []
    for i in range(n):
        tail = rs.randint(0, vocab, (tail_lens[i % len(tail_lens)],))
        out.append((system + tail.tolist(), laws[i % len(laws)]))
    return out


def expected_programs(engine) -> int:
    """The programs warmup builds: a prefill per bucket and the decode;
    speculating, also a draft prefill per bucket, and the draft decode
    and the verify in place of the decode."""
    n = len(engine.buckets)
    return n + 1 if engine.spec is None else 2 * n + 2


def serve(engine, requests, max_new_tokens: int) -> dict:
    """Warm the engine, zero the launch counts, serve ``requests`` to the
    end, and check what came out.  Returns the run's figures and the
    launch counts of this run alone."""
    from paddle_tpu_torch.ops import kernels

    warm = engine.warmup()
    if warm["compile_misses"] != expected_programs(engine):
        raise AssertionError(f"warmup built {warm['compile_misses']} "
                             f"programs, want {expected_programs(engine)}")
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    reqs = [engine.add_request(p, sampling=s, max_new_tokens=max_new_tokens)
            for p, s in requests]
    engine.run()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    vocab = engine.config.vocab_size
    for r in reqs:
        if r.state != "finished" or len(r.output_ids) != max_new_tokens:
            raise AssertionError(f"request {r.request_id} ended {r.state} "
                                 f"with {len(r.output_ids)} tokens "
                                 f"({r.error})")
        if not all(0 <= t < vocab for t in r.output_ids):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 f"range")
    st = engine.stats()
    if st["compile_cache"]["after_warmup"] != 0:
        raise AssertionError(f"step programs built after warmup: "
                             f"{st['compile_cache']}")
    res = {"requests": len(reqs), "wall_s": round(wall, 3),
           "ttft_ms": {k: st["ttft_ms"][k] for k in ("p50", "p99")},
           "inter_token_ms": {k: st["inter_token_ms"][k]
                              for k in ("p50", "p99")},
           "decode_tokens_per_sec": st["decode_tokens_per_sec"],
           "decode_steps": st["decode_steps"],
           "slot_occupancy": st["slot_occupancy"],
           "prefills_by_bucket": st["prefills_by_bucket"],
           "compile_cache": st["compile_cache"],
           "launches": launches,
           "outputs": [r.output_ids for r in reqs]}
    if engine.kv_layout == "paged":
        res["prefix_hit_rate"] = st["paging"]["prefix"]["hit_rate"]
        res["kv_block_invariants"] = st["health"]["kv_block_invariants"]
        if res["prefix_hit_rate"] <= 0:
            raise AssertionError("paged serve: no prefix-cache hit")
        if res["kv_block_invariants"] != "ok":
            raise AssertionError(f"paged serve: allocator invariants "
                                 f"{res['kv_block_invariants']}")
    if cuda:
        # the graphs' pool is reserved at warmup, not allocated: the peak
        # of allocated memory does not show it, the reserved peak does
        res["peak_memory_gb"] = round(torch.cuda.max_memory_allocated()
                                      / 2 ** 30, 3)
        res["peak_reserved_gb"] = round(torch.cuda.max_memory_reserved()
                                        / 2 ** 30, 3)
    return res


#: serve_paged's prompt tails (after its 512-token system prompt); its
#: traffic is also serve_durable's
PAGED_TAILS = [64, 1000, 300, 128, 777, 200, 512, 96]


def phase_serve_paged():
    from paddle_tpu_torch import create_engine

    t0 = time.perf_counter()
    eng = create_engine("llama:llama2-7b", device="cuda",
                        dtype=torch.bfloat16, kv_layout="paged",
                        block_size=16, min_bucket=16, num_slots=8, seed=0)
    build_s = time.perf_counter() - t0
    reqs = make_requests(eng.config.vocab_size, 12, 512, PAGED_TAILS,
                         seed=0)
    res = serve(eng, reqs, max_new_tokens=64)
    if res["launches"]["paged_decode"] < 1 or \
            res["launches"]["paged_prefill"] < 1:
        raise AssertionError(f"paged serve did not run K4/K5: "
                             f"{res['launches']}")
    emit("serve_paged", model="llama2-7b", dtype="bfloat16",
         model_build_s=round(build_s, 3), max_seq=eng.max_seq,
         kv_pool_gb=round(eng.cache.nbytes() / 2 ** 30, 3),
         **{k: v for k, v in res.items() if k != "outputs"})
    return eng.model, res


def phase_serve_contiguous(model):
    from paddle_tpu_torch.serving import Engine

    eng = Engine(model, kv_layout="contiguous", num_slots=4, max_seq=2048,
                 min_bucket=16)
    reqs = make_requests(model.config.vocab_size, 4, 512, [100, 400, 250],
                         seed=1)
    res = serve(eng, reqs, max_new_tokens=16)
    if res["launches"]["flash_fwd"] < 1:
        raise AssertionError(f"contiguous serve did not run K1: "
                             f"{res['launches']}")
    emit("serve_contiguous", model="llama2-7b", dtype="bfloat16",
         **{k: v for k, v in res.items() if k != "outputs"})
    return res


def phase_serve_gpt():
    """GPT-2 345M at full width through the paged engine: K4 and K5 at
    head dim 64, with the prefix cache."""
    from paddle_tpu_torch import create_engine

    t0 = time.perf_counter()
    eng = create_engine("gpt:gpt2-345m", device="cuda", dtype=torch.bfloat16,
                        kv_layout="paged", block_size=16, min_bucket=16,
                        num_slots=8, max_seq=1024, seed=0)
    build_s = time.perf_counter() - t0
    if eng.config.head_dim != 64:
        raise AssertionError(f"serve_gpt: head dim {eng.config.head_dim}")
    reqs = make_requests(eng.config.vocab_size, 12, 256,
                         [32, 600, 150, 77, 400, 256, 500, 64], seed=2)
    res = serve(eng, reqs, max_new_tokens=64)
    if res["launches"]["paged_decode"] < 1 or \
            res["launches"]["paged_prefill"] < 1:
        raise AssertionError(f"serve_gpt did not run K4/K5: "
                             f"{res['launches']}")
    emit("serve_gpt", model="gpt2-345m", dtype="bfloat16", head_dim=64,
         model_build_s=round(build_s, 3), max_seq=eng.max_seq,
         kv_pool_gb=round(eng.cache.nbytes() / 2 ** 30, 3),
         **{k: v for k, v in res.items() if k != "outputs"})
    return res


# -- phase 3b: sharded serving on a mesh of one --------------------------------

#: the turns of serve_mesh's timing: plain, mesh, mesh, plain
MESH_TURNS = ("plain", "mesh", "mesh", "plain")


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def run_serve_mesh(plain, meshed, requests, max_new_tokens: int,
                   reference) -> dict:
    """Warm a plain engine and a mesh engine of the same kwargs over one
    model, then serve ``requests`` on each in :data:`MESH_TURNS`, from a
    cold prefix cache each time (:func:`timed_run`).  Every turn's
    streams must equal ``reference`` (the plain engine's, all four
    sampling laws) bitwise, no program may be built after warmup, and
    the mesh engine's step programs must hold its collectives (each
    captured program records the collectives it issues; a decode step
    replays its program's).  The kernel launch and collective counts are
    set to 0 before each turn and read after it.  Returns the turns,
    each engine's medians and quartiles, the mesh turns' launches and
    collectives, and the collectives of one decode step."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.ops import kernels

    engines = {"plain": plain, "mesh": meshed}
    for name, eng in engines.items():
        warm = eng.warmup()
        if warm["compile_misses"] != expected_programs(eng):
            raise AssertionError(f"serve_mesh: the {name} engine's warmup "
                                 f"built {warm['compile_misses']} programs")
    decode = meshed.programs._programs[("decode",)]
    per_step = dict(decode.collectives)
    if not per_step.get("all_reduce"):
        raise AssertionError(f"serve_mesh: the decode program holds no "
                             f"all_reduce ({per_step})")
    turns, launches, collectives = [], {}, {}
    for name in MESH_TURNS:
        eng = engines[name]
        kernels.reset_launches()
        mp_layers.reset_collectives()
        res = timed_run(eng, requests, max_new_tokens)
        counts = _nonzero(kernels.launch_counts())
        colls = _nonzero(mp_layers.collective_counts())
        if res.pop("outputs") != reference:
            raise AssertionError(f"serve_mesh: the {name} engine's streams "
                                 f"differ from the plain engine's")
        if name == "mesh":
            launches = _sum_launches(launches, counts)
            collectives = _sum_launches(collectives, colls)
            if colls.get("all_reduce", 0) < per_step["all_reduce"] \
                    * res["decode_steps"]:
                raise AssertionError(f"serve_mesh: {colls} collectives for "
                                     f"{res['decode_steps']} decode steps")
        elif colls:
            raise AssertionError(f"serve_mesh: the plain engine issued "
                                 f"collectives {colls}")
        res["engine"] = name
        turns.append(res)
    for name, eng in engines.items():
        after = eng.stats()["compile_cache"]["after_warmup"]
        if after != 0:
            raise AssertionError(f"serve_mesh: the {name} engine built "
                                 f"{after} programs after warmup")
    summary = {}
    for name in engines:
        mine = [t for t in turns if t["engine"] == name]
        summary[name] = {
            "itl_p50_ms": _quartiles([t["itl"]["p50_ms"] for t in mine]),
            "ttft_p50_ms": _quartiles([t["ttft_p50_ms"] for t in mine]),
            "decode_tokens_per_sec": _quartiles(
                [t["decode_tokens_per_sec"] for t in mine])}
    return {"turns": turns, "summary": summary, "launches": launches,
            "collectives": collectives,
            "collectives_per_decode_step": per_step,
            "programs_after_warmup": 0}


def phase_serve_mesh(model, reference) -> dict:
    """serve_paged's Llama-2 7B (its engine released) on serve_paged's
    traffic through ``Engine(mesh=serving_mesh(1))``: an NCCL world of one
    made on a ``HashStore``, the tensor-parallel layers (sharing the
    model's tensors) issuing their all-reduces and the head's all-gather
    inside the engine's CUDA graphs, K4/K5 on the mesh's pool; in turns
    with the plain engine.  Then GPT-2 345M contiguous (K1 prefill) at
    mesh one against its plain engine.  Returns the 7B mesh turns' launch
    counts, both runs' summed."""
    import torch.distributed as dist

    from paddle_tpu_torch.serving import Engine, serving_mesh

    t0 = time.perf_counter()
    mesh = serving_mesh(1)
    init_s = time.perf_counter() - t0
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"serve_mesh: world {dist.get_backend()} of "
                             f"{dist.get_world_size()}")
    reqs = make_requests(model.config.vocab_size, 12, 512, PAGED_TAILS,
                         seed=0)
    plain, meshed = paged_engine(model), paged_engine(model, mesh=mesh)
    shared = [p.data_ptr() for p in meshed.model.parameters()] == \
        [p.data_ptr() for p in model.parameters()]
    if not shared:
        raise AssertionError("serve_mesh: the mesh-one model copied the "
                             "weights")
    res = run_serve_mesh(plain, meshed, reqs, 64, reference)
    if not (res["launches"].get("paged_decode")
            and res["launches"].get("paged_prefill")):
        raise AssertionError(f"serve_mesh did not run K4/K5: "
                             f"{res['launches']}")
    emit("serve_mesh", model="llama2-7b", dtype="bfloat16",
         mesh_shape=meshed.mesh_shape, backend=dist.get_backend(),
         world_init_s=round(init_s, 3), shares_weights=shared,
         streams_equal_plain=True, **res)
    launches = res["launches"]
    del plain, meshed
    gc.collect()
    torch.cuda.empty_cache()

    # GPT-2 345M, contiguous: K1 in the prefill at mesh one
    gpt = Engine.resolve_model("gpt:gpt2-345m", device="cuda",
                               dtype=torch.bfloat16, seed=0)
    greqs = make_requests(gpt.config.vocab_size, 4, 256, [100, 400, 250],
                          seed=1)
    kw = dict(kv_layout="contiguous", num_slots=4, max_seq=1024,
              min_bucket=16)
    ref = serve(Engine(gpt, **kw), greqs, max_new_tokens=32)
    gres = run_serve_mesh(Engine(gpt, **kw), Engine(gpt, mesh=mesh, **kw),
                          greqs, 32, ref["outputs"])
    if not gres["launches"].get("flash_fwd"):
        raise AssertionError(f"serve_mesh (345M contiguous) did not run "
                             f"K1: {gres['launches']}")
    emit("serve_mesh", model="gpt2-345m", dtype="bfloat16",
         kv_layout="contiguous", mesh_shape="model=1",
         streams_equal_plain=True, **gres)
    del gpt
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return _sum_launches(launches, gres["launches"])


# -- phase 6: model parity, kernel path against the reference path --------

PARITY_TOLERANCE = 1e-3


@torch.no_grad()
def drive_paged(model, kernel: str, prompt, shared_len: int, tail,
                steps: int, feed=None):
    """Slot 0 prefills ``prompt`` from position 0; slot 1 shares slot 0's
    first ``shared_len`` tokens of blocks and prefills ``tail`` after them
    (start > 0); then ``steps`` decode steps for both slots.  Decode
    inputs are ``feed`` (per step, ``[2]``) or the greedy tokens.
    Returns the last-position logits of every forward ``[2, V]`` and the
    tokens fed."""
    from paddle_tpu_torch.serving import (
        CacheContext, PagedCacheContext, PagedKVCache,
    )

    cfg, bs = model.config, 16
    param = next(model.parameters())
    dev = param.device
    kv_heads = getattr(cfg, "n_kv_heads", None) or cfg.num_attention_heads
    cache = PagedKVCache(2, cfg.num_hidden_layers, 1024, kv_heads,
                         cfg.head_dim, param.dtype, block_size=bs,
                         kernel=kernel, device=dev)

    def prefill(slot, ids, start, length):
        bucket = -(-len(ids) // bs) * bs
        x = np.zeros((1, bucket), dtype=np.int64)
        x[0, :len(ids)] = ids
        # the prefill surface takes int32 device scalars, as the engine's
        # programs pass them
        slot, start, length = (torch.tensor([n], dtype=torch.int32,
                                            device=dev)
                               for n in (slot, start, length))
        logits = model(torch.from_numpy(x).to(dev),
                       cache_ctx=PagedCacheContext(cache, "prefill",
                                                   slot=slot, start=start))
        cache.set_length(slot, length)
        return logits[0, len(ids) - 1]

    La = len(prompt)
    cache.begin_sequence(0, [], 0, -(-La // bs) * bs)
    row0 = prefill(0, prompt, 0, La)
    Lb = shared_len + len(tail)
    cache.begin_sequence(1, cache.owned_blocks(0)[:shared_len // bs],
                         shared_len, -(-len(tail) // bs) * bs)
    row1 = prefill(1, tail, shared_len, Lb)
    out = [torch.stack([row0, row1])]
    fed, seq = [], [La, Lb]
    for i in range(steps):
        tok = feed[i] if feed is not None else out[-1].argmax(-1)
        fed.append(tok)
        for s in (0, 1):
            if not cache.ensure_capacity(s, seq[s]):
                raise AssertionError("parity: pool exhausted")
        logits = model(tok[:, None].long(),
                       cache_ctx=CacheContext(cache, "decode"))
        cache.advance(torch.ones(2, dtype=torch.int32, device=dev))
        seq = [n + 1 for n in seq]
        out.append(logits[:, -1])
    return out, fed


def parity_models(dtype=torch.float32):
    """The full-width configurations held at 2 layers in f32 by ``parity``
    and ``graph_parity`` (in f16 by ``parity_f16``): Llama-2 7B's (D 128)
    and GPT-2 345M's (D 64), each built on the card with random weights
    from a seed."""
    from paddle_tpu_torch.models import (
        GPTForCausalLM, LlamaForCausalLM, gpt2_345m, llama2_7b,
    )

    def llama():
        gen = torch.Generator(device="cuda").manual_seed(1)
        return LlamaForCausalLM(llama2_7b(num_hidden_layers=2),
                                device="cuda", dtype=dtype,
                                generator=gen).eval()

    def gpt():
        gen = torch.Generator(device="cuda").manual_seed(1)
        return GPTForCausalLM(
            gpt2_345m(num_hidden_layers=2, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0),
            device="cuda", dtype=dtype, generator=gen).eval()

    return [("llama2-7b width, 2 layers", llama),
            ("gpt2-345m width, 2 layers", gpt)]


def phase_parity():
    from paddle_tpu_torch.ops import kernels

    for label, build in parity_models():
        model = build()
        rs = np.random.RandomState(2)
        prompt = rs.randint(0, model.config.vocab_size, (300,)).tolist()
        tail = rs.randint(0, model.config.vocab_size, (100,)).tolist()
        ref, fed = drive_paged(model, "reference", prompt, 256, tail, 4)
        kernels.reset_launches()
        got, _ = drive_paged(model, "cuda", prompt, 256, tail, 4, feed=fed)
        launches = kernels.launch_counts()
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        agree = float(np.mean([bool((a.argmax(-1) == b.argmax(-1)).all())
                               for a, b in zip(got, ref)]))
        emit("parity", model=label, dtype="float32",
             head_dim=model.config.head_dim, forwards=len(ref),
             max_abs_logit_err=err, tolerance=PARITY_TOLERANCE,
             greedy_token_agreement=agree, launches=launches)
        if not err <= PARITY_TOLERANCE:
            raise AssertionError(f"parity ({label}): logits differ by {err} "
                                 f"> {PARITY_TOLERANCE}")
        if launches["paged_decode"] < 1 or launches["paged_prefill"] < 1:
            raise AssertionError(f"parity ({label}): kernel path did not "
                                 f"launch K4/K5: {launches}")
        del model, ref, got
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 7: graph_parity, the engine's programs against its bodies -----

@torch.no_grad()
def serve_bodies(engine, requests, max_new_tokens: int):
    """Serve ``requests`` through ``engine``'s step bodies called eagerly,
    as :func:`drive_paged` calls the model: every request is staged into
    slot ``i`` and prefilled from position 0 (no prefix reuse), then all
    decode together until each has ``max_new_tokens``.  The engine's
    programs are never run (a tenancy engine's adapter lane is staged
    too).  Returns the token streams in request
    order."""
    from paddle_tpu_torch.serving import Request

    if len(requests) > engine.num_slots:
        raise ValueError(f"{len(requests)} requests for {engine.num_slots} "
                         f"slots")
    dev, paged = engine.device, engine.kv_layout == "paged"
    out, seq = {}, {}
    for slot, (prompt, law) in enumerate(requests):
        # the engine numbers requests 0.. in the order they are added, and
        # seeds an unseeded law from that number
        req = Request(np.asarray(prompt), max_new_tokens, law,
                      request_id=slot)
        engine.sampler.stage_slot(slot, law, engine._seed_for(req))
        if engine.adapter_pool is not None:
            engine.adapter_pool.stage_slot(slot, law.adapter)
        L = len(prompt)
        bucket = engine.bucket_for(L)
        if paged and not engine.cache.begin_sequence(slot, [], 0, bucket):
            raise AssertionError("serve_bodies: pool exhausted")
        ids = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
        ids[0, :L] = torch.tensor(prompt, device=dev)
        meta = torch.tensor([slot, L, 0], dtype=torch.int32, device=dev)
        out[slot] = [int(engine._prefill_step(ids, meta))]
        seq[slot] = L
    running = set(out)
    while running:
        active = np.zeros(engine.num_slots, dtype=np.int32)
        for slot in running:
            if paged and not engine.cache.ensure_capacity(slot, seq[slot]):
                raise AssertionError("serve_bodies: pool exhausted")
            active[slot] = 1
        toks = engine._decode_step(
            torch.from_numpy(active).to(dev)).cpu().tolist()
        for slot in sorted(running):
            seq[slot] += 1
            out[slot].append(toks[slot])
            if len(out[slot]) == max_new_tokens:
                running.discard(slot)
                if paged:
                    engine.cache.release_slot(slot)
    return [out[i] for i in range(len(requests))]


def drive_graph_parity(model, layout: str, requests, max_new_tokens: int,
                       **engine_kw) -> dict:
    """The same seeded requests served by an engine (its step programs:
    CUDA graphs on the card) and by :func:`serve_bodies` on a second
    engine over the same model; prefix reuse is off in both, so the two
    run the same arithmetic.  Returns both token streams, whether they
    are identical, the first engine's ``compile_cache`` and its launch
    counts."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import Engine

    kw = dict(kv_layout=layout, enable_prefix_cache=False, **engine_kw)
    eng = Engine(model, **kw)
    eng.warmup()
    kernels.reset_launches()
    reqs = [eng.add_request(p, sampling=s, max_new_tokens=max_new_tokens)
            for p, s in requests]
    eng.run()
    launches = kernels.launch_counts()
    programs = [r.output_ids for r in reqs]
    cc = eng.stats()["compile_cache"]
    del eng
    eager = serve_bodies(Engine(model, **kw), requests, max_new_tokens)
    return {"identical": programs == eager, "programs": programs,
            "eager": eager, "compile_cache": cc, "launches": launches}


def phase_graph_parity():
    for label, build in parity_models():
        model = build()
        reqs = make_requests(model.config.vocab_size, 4, 48,
                             [5, 40, 17, 90], seed=3)
        for layout in ("paged", "contiguous"):
            res = drive_graph_parity(model, layout, reqs, 12, num_slots=4,
                                     max_seq=256, min_bucket=16,
                                     block_size=16)
            emit("graph_parity", model=label, dtype="float32", layout=layout,
                 requests=len(reqs), laws="greedy, temperature, top-k, top-p",
                 identical=res["identical"],
                 compile_cache=res["compile_cache"],
                 launches=res["launches"])
            if not res["identical"]:
                raise AssertionError(
                    f"graph_parity ({label}, {layout}): the programs gave "
                    f"{res['programs']}, the eager bodies {res['eager']}")
            if res["compile_cache"]["after_warmup"] != 0 or \
                    res["compile_cache"]["hits"] < 1:
                raise AssertionError(f"graph_parity ({label}, {layout}): "
                                     f"{res['compile_cache']}")
        del model
        gc.collect()
        torch.cuda.empty_cache()


# -- phases 8 and 9: the overload regime -----------------------------------

#: ``serve_overload``'s traffic: (class, arrival step, tails, new tokens);
#: every prompt is the shared system prompt plus its tail, and no prompt
#: is a whole number of blocks, so a resume can hit all its whole blocks
OVERLOAD_TRAFFIC = (
    ("low", 0, [300, 1400, 700, 1100, 333, 950, 1203, 401, 777, 1349, 555,
                900], 64),
    ("normal", 8, [65, 300, 129, 511, 200, 77, 400, 150], 64),
    ("high", 16, [33, 127, 90, 45], 32),
)
#: how many of the normal arrivals (the last ones) carry a deadline that
#: their estimated queue wait must exceed
OVERLOAD_SHED = 2
OVERLOAD_DEADLINE_S = 0.05


def _percentiles(xs) -> dict:
    if not xs:
        return {"count": 0, "p50_ms": None, "p99_ms": None}
    s = sorted(xs)
    q = lambda p: s[min(len(s) - 1, int(p * (len(s) - 1) + 0.5))]  # noqa
    return {"count": len(s), "p50_ms": round(q(0.5) * 1e3, 3),
            "p99_ms": round(q(0.99) * 1e3, 3)}


def _quartiles(xs) -> dict:
    """The median and quartiles of ``xs``."""
    q = np.percentile(xs, [25, 50, 75])
    return {"median": round(float(q[1]), 3), "q1": round(float(q[0]), 3),
            "q3": round(float(q[2]), 3)}


def preempt_causes(tracer) -> dict:
    """Each ``preempt`` event's cause: ``blocks`` when the scheduler
    evicted for KV blocks (the event right after a deferred admission's
    ``block_pressure``), else ``slot``."""
    out = {"slot": 0, "blocks": 0}
    prev = None
    for ev in tracer.events:
        if ev["kind"] == "preempt":
            blocks = (prev is not None and prev["kind"] == "block_pressure"
                      and "defers" in prev)
            out["blocks" if blocks else "slot"] += 1
        if ev["kind"] != "decode_step":
            prev = ev
    return out


def serve_overload(engine, vocab: int, system_len: int, traffic,
                   n_shed: int, deadline_s: float, seed: int) -> dict:
    """Warm ``engine`` (paged, with a live ``RequestTracer``), then drive
    ``traffic``: each class's requests arrive at their step, the four
    sampling laws in turn; the last ``n_shed`` normal arrivals carry
    ``deadline_s`` and must be shed; one queued and one running low
    request are cancelled.  Checks the overload regime and returns the
    run's figures."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (
        PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL, ShedReject,
        validate_trace,
    )

    classes = {"low": PRIORITY_LOW, "normal": PRIORITY_NORMAL,
               "high": PRIORITY_HIGH}
    tracer = engine.tracer
    rs = np.random.RandomState(seed)
    system = rs.randint(0, vocab, (system_len,)).tolist()
    laws = sampling_laws(seed)
    warm = engine.warmup()
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = {}                       # request -> [(attempt, t)] per token

    def cb(tok, req):
        times.setdefault(req.request_id, []).append(
            (req.preemptions, time.perf_counter()))

    reqs, shed, cancels, n = [], [], {}, 0
    last_arrival = max(at for _, at, _, _ in traffic)
    step, t0 = 0, time.perf_counter()
    while True:
        for cls, at, tails, new in traffic:
            if at != step:
                continue
            for i, tail_len in enumerate(tails):
                prompt = system + rs.randint(0, vocab, (tail_len,)).tolist()
                dl = deadline_s if (cls == "normal"
                                    and i >= len(tails) - n_shed) else None
                try:
                    reqs.append(engine.add_request(
                        prompt, sampling=laws[n % 4],
                        max_new_tokens=new, priority=cls, deadline_s=dl,
                        stream_cb=cb))
                except ShedReject as e:
                    shed.append(e.request)
                n += 1
        # one low cancelled while queued (step 2), one while running (4)
        for at, state in ((2, "queued"), (4, "running")):
            victim = next((r for r in reqs if step == at and r.state == state
                           and r.priority == PRIORITY_LOW), None)
            if victim is not None and victim.cancel():
                cancels[state] = victim.request_id
        busy = engine.step()
        step += 1
        if not busy and step > last_arrival:
            break
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = engine.stats()
    # -- checks
    problems = []
    cancelled = {r.request_id for r in reqs if r.state == "cancelled"}
    if set(cancels.values()) != cancelled or len(cancelled) != 2:
        problems.append(f"cancelled {sorted(cancelled)}, asked {cancels}")
    for r in reqs:
        if r.request_id in cancelled:
            continue
        if r.state != "finished" or len(r.output_ids) != r.max_new_tokens:
            problems.append(f"request {r.request_id} (class "
                            f"{r.priority}) ended "
                            f"{r.state} with {len(r.output_ids)} tokens "
                            f"({r.error})")
        if not all(0 <= t < vocab for t in r.output_ids):
            problems.append(f"request {r.request_id}: token out of range")
    if len(shed) != n_shed or st["overload"]["shed"] != n_shed:
        problems.append(f"shed {len(shed)} requests "
                        f"({st['overload']['shed']} counted), want {n_shed}")
    if st["failures"]["cancelled"] != 2:
        problems.append(f"cancelled counter {st['failures']['cancelled']}")
    causes = preempt_causes(tracer)
    if causes["slot"] < 1 or causes["blocks"] < 1:
        problems.append(f"preemptions by cause {causes}: want >= 1 each")
    bs = engine.block_size
    by_id = {r.request_id: r for r in reqs}
    resumes = []
    for ev in tracer.events:
        if ev["kind"] != "admitted" or \
                tracer.spans[ev["span"]]["name"] != "resume":
            continue
        L = int(by_id[ev["request_id"]].prompt_ids.size)
        resumes.append({"request": ev["request_id"], "prompt": L,
                        "prefix_hit": ev["prefix_hit"],
                        "bucket": ev["bucket"],
                        "whole_blocks_hit":
                            ev["prefix_hit"] >= (L // bs) * bs})
    if not any(r["whole_blocks_hit"] for r in resumes):
        problems.append(f"no resume hit all its prompt's whole blocks: "
                        f"{resumes}")
    trace_problems = validate_trace(tracer)
    if trace_problems:
        problems.append(f"trace chain: {trace_problems[:5]}")
    if st["compile_cache"]["after_warmup"] != 0:
        problems.append(f"programs built after warmup: "
                        f"{st['compile_cache']}")
    if st["health"]["kv_block_invariants"] != "ok":
        problems.append(f"allocator: {st['health']['kv_block_invariants']}")
    if st["paging"]["blocks"]["used"] != 0:
        problems.append(f"blocks still in use: {st['paging']['blocks']}")
    if problems:
        raise AssertionError("serve_overload: " + "; ".join(problems))
    # -- figures: TTFT and ITL per class over each request's last attempt
    by_class = {}
    for cls, prio in classes.items():
        done = [r for r in reqs if r.finished and r.priority == prio]
        itl = []
        for r in done:
            ts = [t for a, t in times[r.request_id] if a == r.preemptions]
            itl += [b - a for a, b in zip(ts, ts[1:])]
        by_class[cls] = {"requests": len(done),
                         "ttft": _percentiles([r.ttft_s for r in done]),
                         "itl": _percentiles(itl)}
    res = {"requests": len(reqs) + len(shed), "finished": sum(
               r.finished for r in reqs), "shed": len(shed),
           "cancelled": sorted(cancels.items()), "steps": step,
           "wall_s": round(wall, 3), "by_class": by_class,
           "decode_tokens_per_sec": st["decode_tokens_per_sec"],
           "preemptions": st["overload"]["preemptions"],
           "preemptions_by_cause": causes,
           "resumes": resumes,
           "resume_prefix_hit_tokens": sum(r["prefix_hit"]
                                           for r in resumes),
           "queue_depth_max": st["queue_depth_max"],
           "failures": st["failures"],
           "prefix_hit_rate": st["paging"]["prefix"]["hit_rate"],
           "kv_block_invariants": st["health"]["kv_block_invariants"],
           "compile_cache": st["compile_cache"],
           "warmup_programs": warm["compile_misses"],
           "launches": launches,
           "trace_events": len(tracer.events)}
    if cuda:
        res["peak_memory_gb"] = round(torch.cuda.max_memory_allocated()
                                      / 2 ** 30, 3)
        res["peak_reserved_gb"] = round(torch.cuda.max_memory_reserved()
                                        / 2 ** 30, 3)
    return res


def overload_engine(model):
    """``serve_overload``'s engine: paged, 8 slots, max_seq 4096, a pool
    of 384 blocks of 16 plus the scratch block (3.0 GiB at Llama-2 7B in
    bf16), two preemptions a request, aging slower than the run, a queue
    of 16 and a live request tracer."""
    from paddle_tpu_torch.serving import Engine, RequestTracer

    return Engine(model, kv_layout="paged", num_slots=8, max_seq=4096,
                  min_bucket=16, block_size=16, num_kv_blocks=385,
                  max_preemptions=2, priority_aging_s=30, max_queue=16,
                  tracer=RequestTracer())


def run_serve_overload(model) -> tuple:
    """``overload_engine`` over ``model`` serving ``OVERLOAD_TRAFFIC``
    after a 512-token system prompt.  Returns the engine and the run's
    figures."""
    eng = overload_engine(model)
    return eng, serve_overload(eng, model.config.vocab_size, 512,
                               OVERLOAD_TRAFFIC, OVERLOAD_SHED,
                               OVERLOAD_DEADLINE_S, seed=4)


def phase_serve_overload(model) -> dict:
    """Llama-2 7B (serve_paged's model) under overload: 24 requests in
    three priority classes through a paged engine whose pool cannot hold
    them all."""
    from paddle_tpu_torch import obs

    eng, res = run_serve_overload(model)
    if res["launches"]["paged_decode"] < 1 or \
            res["launches"]["paged_prefill"] < 1:
        raise AssertionError(f"serve_overload did not run K4/K5: "
                             f"{res['launches']}")
    path = obs.write_chrome_trace(eng.tracer, os.path.join(
        tempfile.gettempdir(), "serve_overload_trace.json"))
    emit("serve_overload", model="llama2-7b", dtype="bfloat16",
         kv_pool_gb=round(eng.cache.nbytes() / 2 ** 30, 3),
         num_kv_blocks=eng.cache.num_blocks, chrome_trace=path, **res)
    return res


def drive_overload_parity(model, layout: str, seed: int, **engine_kw) -> dict:
    """On one engine (2 slots): a greedy and a seeded top-p ``low``
    request, each served alone for reference; then both running when two
    ``high`` requests arrive and preempt them, with the step programs
    failing (a prefill before and after it ran, a decode before and
    after); then a decode failing past its retries, and one more request.
    Returns the streams, the references and the counters."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import Engine, SamplingParams

    eng = Engine(model, kv_layout=layout, num_slots=2, max_preemptions=2,
                 priority_aging_s=30, **engine_kw)
    eng.warmup()
    vocab = model.config.vocab_size
    rs = np.random.RandomState(seed)
    lows = [(rs.randint(0, vocab, (40,)).tolist(), SamplingParams()),
            (rs.randint(0, vocab, (70,)).tolist(),
             SamplingParams(temperature=0.8, top_p=0.9, seed=seed))]
    highs = [rs.randint(0, vocab, (n,)).tolist() for n in (20, 33)]

    def alone(prompt, law, priority="low"):
        r = eng.add_request(prompt, sampling=law, max_new_tokens=12,
                            priority=priority)
        eng.run()
        return r.output_ids

    # served twice alone: the second admission takes the same prefix hit
    # (paged) as the overload run's admissions and resumes
    ref = [alone(p, s) for p, s in lows]
    ref = [alone(p, s) for p, s in lows]
    ref_high = [alone(p, SamplingParams()) for p in highs]
    ref_high = [alone(p, SamplingParams()) for p in highs]
    before = eng.stats()["failures"]
    run, calls = eng.programs.run, {"prefill": 0, "decode": 0}
    # (kind, call number) -> when the call fails: never two in a row, so
    # one retry absorbs each
    faults = {("prefill", 1): "before", ("prefill", 4): "after",
              ("decode", 2): "before", ("decode", 6): "after"}

    def flaky(key, body, *inputs):
        calls[key[0]] += 1
        when = faults.get((key[0], calls[key[0]]))
        if when == "before":
            raise RuntimeError(f"injected fault before {key}")
        out = run(key, body, *inputs)
        if when == "after":
            raise RuntimeError(f"injected fault after {key}")
        return out

    kernels.reset_launches()
    eng.programs.run = flaky
    try:
        lo = [eng.add_request(p, sampling=s, max_new_tokens=12,
                              priority="low") for p, s in lows]
        for _ in range(3):
            eng.step()
        running = all(r.state == "running" and r.output_ids for r in lo)
        hi = [eng.add_request(p, max_new_tokens=12, priority="high")
              for p in highs]
        eng.run()
    finally:
        del eng.programs.run
    after = eng.stats()["failures"]
    retried = {k: v - before["retries_by_point"].get(k, 0)
               for k, v in after["retries_by_point"].items()}
    # a decode failing past its one retry fails its batch, not the engine
    exhausted = {("decode", calls["decode"] + 1): "before",
                 ("decode", calls["decode"] + 2): "after"}
    faults = exhausted
    eng.programs.run = flaky
    try:
        doomed = [eng.add_request(p, max_new_tokens=12, priority="high")
                  for p in highs]
        eng.run()
    finally:
        del eng.programs.run
    nxt = alone(*lows[0])
    launches = kernels.launch_counts()
    health = eng.health()
    return {"running_before_preemption": running,
            "preempted": [r.preemptions for r in lo],
            "states": [r.state for r in lo + hi],
            "streams": [r.output_ids for r in lo],
            "references": ref,
            "high_streams": [r.output_ids for r in hi],
            "high_references": ref_high,
            "retries_by_point": retried,
            "step_failures": after["step_failures"]
            - before["step_failures"],
            "doomed": [(r.state, (r.error or "").split(":")[0])
                       for r in doomed],
            "next_stream": nxt, "next_reference": ref[0],
            "kv_block_invariants": health.get("kv_block_invariants", "ok"),
            "slots_free": health["slots_free"],
            "after_warmup": eng.stats()["compile_cache"]["after_warmup"],
            "launches": launches}


def check_overload_parity(res: dict, label: str) -> None:
    want_doomed = [("failed", "decode step failed after 1 retry")] * 2
    problems = []
    if not res["running_before_preemption"]:
        problems.append("the low requests were not both running")
    if not all(n >= 1 for n in res["preempted"]):
        problems.append(f"preemptions {res['preempted']}")
    if res["states"] != ["finished"] * 4:
        problems.append(f"states {res['states']}")
    if res["streams"] != res["references"]:
        problems.append(f"preempted streams {res['streams']} != alone "
                        f"{res['references']}")
    if res["high_streams"] != res["high_references"]:
        problems.append("high streams differ from alone")
    if res["retries_by_point"] != {"serving.prefill": 2,
                                   "serving.decode": 2}:
        problems.append(f"retries {res['retries_by_point']}")
    if res["doomed"] != want_doomed:
        problems.append(f"exhausted decode: {res['doomed']}")
    if res["next_stream"] != res["next_reference"]:
        problems.append("the request after the failed batch differs")
    if res["kv_block_invariants"] != "ok" or res["slots_free"] != 2:
        problems.append(f"pool {res['kv_block_invariants']}, "
                        f"{res['slots_free']} slots free")
    if res["after_warmup"] != 0:
        problems.append(f"{res['after_warmup']} programs after warmup")
    if problems:
        raise AssertionError(f"overload_parity ({label}): "
                             + "; ".join(problems))


def phase_overload_parity():
    for label, build in parity_models():
        model = build()
        for layout in ("paged", "contiguous"):
            res = drive_overload_parity(model, layout, seed=6, max_seq=256,
                                        min_bucket=16, block_size=16)
            emit("overload_parity", model=label, dtype="float32",
                 layout=layout,
                 **{k: v for k, v in res.items() if k not in (
                     "streams", "references", "high_streams",
                     "high_references", "next_stream", "next_reference")})
            check_overload_parity(res, f"{label}, {layout}")
            want = ("paged_decode", "paged_prefill") if layout == "paged" \
                else ("flash_fwd",)
            if any(res["launches"][k] < 1 for k in want):
                raise AssertionError(f"overload_parity ({label}, {layout}) "
                                     f"did not launch {want}: "
                                     f"{res['launches']}")
        del model
        gc.collect()
        torch.cuda.empty_cache()


# -- phases 10 and 11: durability -------------------------------------------

#: the three journal settings served in turn, each ``rounds`` times
JOURNAL_MODES = ("none", "rotate", "always")


def paged_engine(model, **kw):
    """serve_paged's engine over ``model``: paged, block 16, buckets from
    16, 8 slots, ``max_seq`` the model's positions."""
    from paddle_tpu_torch.serving import Engine

    return Engine(model, kv_layout="paged", block_size=16, min_bucket=16,
                  num_slots=8, **kw)


class _TimedFile:
    """A journal segment file whose ``write`` and ``flush`` add their host
    seconds to ``spent[0]``; everything else goes to the file."""

    def __init__(self, f, spent):
        self._f, self._spent = f, spent

    def _timed(self, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        self._spent[0] += time.perf_counter() - t
        return out

    def write(self, data):
        return self._timed(self._f.write, data)

    def flush(self):
        return self._timed(self._f.flush)

    def __getattr__(self, name):
        return getattr(self._f, name)


def timed_journal(path: str, fsync: str):
    """A ``RequestJournal`` whose appends are timed on the host clock:
    returns it and ``[append s, write + flush s]``.  The second is the
    time inside the segment file's ``write`` and ``flush`` calls alone
    (every segment, rotations included); the rest of an append is
    serialising (``json.dumps`` + ``crc32``), the ``fsync`` under
    ``fsync="always"`` and the journal's bookkeeping."""
    from paddle_tpu_torch.serving import RequestJournal

    spent = [0.0]
    io = [0.0]
    j = RequestJournal(path, fsync=fsync)
    j._seg = _TimedFile(j._seg, io)
    append, open_segment = j._append, j._open_segment

    def timed_append(rec):
        t = time.perf_counter()
        append(rec)
        spent[0] += time.perf_counter() - t

    def timed_open_segment():
        open_segment()
        j._seg = _TimedFile(j._seg, io)

    j._append, j._open_segment = timed_append, timed_open_segment
    return j, (spent, io)


def _journal_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path) if f.endswith(".jrnl"))


def timed_run(engine, requests, max_new_tokens: int) -> dict:
    """Serve ``requests`` on a warmed ``engine`` from a cold prefix cache;
    the figures of this run alone (its ITL window starts empty, the rest
    are deltas of the engine's metrics).  ``itl`` is the engine's: each
    decode step's time, from its call until its tokens are on the host.
    ``client_itl`` is what a stream sees: the time between a request's
    consecutive tokens at its stream callback, which also holds the host
    work between steps (the journal's appends among it)."""
    m = engine.metrics
    if engine.prefix_cache is not None:
        engine.prefix_cache.clear()
    m.itl_s.clear()
    tokens0, time0, steps0 = m.decode_tokens, m.decode_time_s, m.decode_steps
    stamps = {}

    def cb(tok, req):
        stamps.setdefault(req.request_id, []).append(time.perf_counter())

    reqs = [engine.add_request(p, sampling=s, max_new_tokens=max_new_tokens,
                               stream_cb=cb)
            for p, s in requests]
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    if any(r.state != "finished" or len(r.output_ids) != max_new_tokens
           for r in reqs):
        raise AssertionError(f"journal-cost run: {[r.state for r in reqs]}")
    itl = list(m.itl_s)
    gaps = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    return {"wall_s": round(wall, 3),
            "ttft_p50_ms": _percentiles([r.ttft_s for r in reqs])["p50_ms"],
            "itl": _percentiles(itl), "client_itl": _percentiles(gaps),
            "decode_tokens_per_sec": round(
                (m.decode_tokens - tokens0) / (m.decode_time_s - time0), 2),
            "decode_steps": m.decode_steps - steps0,
            "outputs": [r.output_ids for r in reqs]}


def journal_cost(engine, requests, max_new_tokens: int, root: str,
                 rounds: int) -> dict:
    """The same traffic ``rounds`` times in each of ``JOURNAL_MODES``
    (none, ``fsync="rotate"``, ``fsync="always"``; in turn), each
    journaled run into a journal of its own, whose appends, and the
    ``write`` + ``flush`` calls inside them, are timed on the host clock
    (:func:`timed_journal`).  The outputs must not depend on the journal.
    Returns every run and each mode's median ITL p50, TTFT p50, tokens/s
    and journal time."""
    runs = []
    for i in range(rounds):
        for mode in JOURNAL_MODES:
            j = None
            if mode != "none":
                j, (spent, io) = timed_journal(
                    os.path.join(root, f"cost-{mode}-{i}"), mode)
            engine.journal = j
            res = timed_run(engine, requests, max_new_tokens)
            engine.journal = None
            if j is not None:
                res["journal_ms"] = round(spent[0] * 1e3, 3)
                res["write_flush_ms"] = round(io[0] * 1e3, 3)
                j.close()
                res["records"] = j.records_written
                res["bytes"] = _journal_bytes(j.path)
            res["mode"] = mode
            runs.append(res)
    ref = runs[0].pop("outputs")
    for r in runs[1:]:
        if r.pop("outputs") != ref:
            raise AssertionError(f"journal-cost: the {r['mode']} run's "
                                 f"outputs differ from the first run's")
    summary = {}
    for mode in JOURNAL_MODES:
        mine = [r for r in runs if r["mode"] == mode]
        summary[mode] = {
            "itl_p50_ms": float(np.median([r["itl"]["p50_ms"]
                                           for r in mine])),
            "itl_p99_ms": float(np.median([r["itl"]["p99_ms"]
                                           for r in mine])),
            "client_itl_p50_ms": float(np.median(
                [r["client_itl"]["p50_ms"] for r in mine])),
            "client_itl_p99_ms": float(np.median(
                [r["client_itl"]["p99_ms"] for r in mine])),
            "wall_s": float(np.median([r["wall_s"] for r in mine])),
            "ttft_p50_ms": float(np.median([r["ttft_p50_ms"]
                                            for r in mine])),
            "decode_tokens_per_sec": float(np.median(
                [r["decode_tokens_per_sec"] for r in mine]))}
        if mode != "none":
            # an admission, a first token and an end per request; the
            # rest is one token record per decode step
            summary[mode].update(
                records=mine[0]["records"], bytes=mine[0]["bytes"],
                token_records_per_decode_step=round(
                    (mine[0]["records"] - 3 * len(requests))
                    / mine[0]["decode_steps"], 4),
                journal_ms=float(np.median([r["journal_ms"]
                                            for r in mine])),
                write_flush_ms=float(np.median([r["write_flush_ms"]
                                                for r in mine])),
                journal_us_per_record=round(float(np.median(
                    [r["journal_ms"] for r in mine])) * 1e3
                    / mine[0]["records"], 3),
                write_flush_us_per_record=round(float(np.median(
                    [r["write_flush_ms"] for r in mine])) * 1e3
                    / mine[0]["records"], 3))
    return {"runs": runs, "summary": summary}


def crash_and_recover(engine, make_engine, requests, root: str) -> tuple:
    """``requests`` (prompt, law, max_new_tokens) are admitted to
    ``engine``, journaled, which steps until each has streamed two tokens
    and is then dropped without ``close()``, as a crash would leave it.
    A new engine from ``make_engine(journal)`` reopens the journal, warms
    up, recovers and serves.  The reopened journal must hold, for each
    pending request, exactly the tokens its client received before the
    crash, and each recovered stream must begin with them; it must also
    equal the same request (its journaled recipe, effective seed
    included) served uninterrupted on that engine from the same cold
    prefix cache.  Returns the new engine and the figures."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import RequestJournal, SamplingParams

    path = os.path.join(root, "crash")
    if engine.prefix_cache is not None:
        engine.prefix_cache.clear()
    engine.journal = RequestJournal(path)
    reqs = [engine.add_request(p, sampling=s, max_new_tokens=n)
            for p, s, n in requests]
    steps = 0
    while any(len(r.output_ids) < 2 for r in reqs):
        engine.step()
        steps += 1
    streamed = [len(r.output_ids) for r in reqs]
    sent = {r.journal_id: list(r.output_ids) for r in reqs}
    del reqs
    journal = RequestJournal(path)
    pending = journal.pending()
    journaled = {jid: journal.outputs(jid) for jid in pending}
    eng = make_engine(journal)
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    kernels.reset_launches()
    info = eng.recover()
    eng.run()
    rec = info["requests"]
    # the uninterrupted runs, from the same cold prefix cache
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    refs = []
    for r in pending.values():
        s = journal.replay_sampling(r)
        refs.append(eng.add_request(
            r["prompt_ids"], max_new_tokens=r["max_new_tokens"],
            sampling=SamplingParams(temperature=s["temperature"],
                                    top_k=s["top_k"], top_p=s["top_p"],
                                    seed=s["seed"])))
    eng.run()
    launches = kernels.launch_counts()
    audit = journal.audit()
    st = eng.stats()
    res = {"admitted": len(requests), "steps_before_crash": steps,
           "streamed_before_crash": streamed,
           "replayed": info["replayed"],
           "recovered_flags": all(r.recovered for r in rec),
           "states": sorted({r.state for r in rec + refs}),
           "bitwise": [r.output_ids for r in rec]
           == [r.output_ids for r in refs],
           "journal_holds_sent": all(journaled[j] == sent[j]
                                     for j in journaled),
           "continues_sent": all(
               r.output_ids[:len(sent[r.journal_id])] == sent[r.journal_id]
               for r in rec),
           "sent_tokens": sum(len(sent[j]) for j in journaled),
           "banked": st["durability"]["banked"],
           "recovered": st["durability"]["recovered"],
           "replay_ttft": _percentiles([r.ttft_s for r in rec]),
           "pending_after": audit["pending"],
           "duplicate_terminals": audit["duplicate_terminals"],
           "journal_records": audit["records_written"],
           "after_warmup": st["compile_cache"]["after_warmup"],
           "warmup_s": round(warmup_s, 3), "launches": launches}
    problems = []
    if not (res["replayed"] == len(pending) > 0 and res["recovered_flags"]):
        problems.append(f"replayed {res['replayed']} of {len(pending)}")
    if res["states"] != ["finished"]:
        problems.append(f"states {res['states']}")
    if not res["bitwise"]:
        problems.append(f"recovered {[r.output_ids for r in rec]} != "
                        f"uninterrupted {[r.output_ids for r in refs]}")
    if not (res["journal_holds_sent"] and res["continues_sent"]):
        problems.append(f"sent before the crash {sent}, journaled "
                        f"{journaled}, recovered "
                        f"{[(r.journal_id, r.output_ids) for r in rec]}")
    if res["pending_after"] != 0 or res["duplicate_terminals"] != 0:
        problems.append(f"audit {audit}")
    if res["after_warmup"] != 0:
        problems.append(f"{res['after_warmup']} programs after warmup")
    if problems:
        raise AssertionError("serve_durable (recovery): "
                             + "; ".join(problems))
    return eng, res


def hot_swap(engine, build, prompt, max_new_tokens: int) -> dict:
    """On the idle ``engine`` (its model built by ``build(0)``): serve
    ``prompt`` greedily at version 0 (T0) and again (a prefix hit), swap
    to ``build(1)``'s weights (T1 must differ, the prompt must miss the
    prefix cache), then back to ``build(0)``'s (T0 again, still a miss).
    No program may be built and no parameter may move."""
    cuda = engine.device.type == "cuda"
    pc = engine.prefix_cache
    ptrs = {k: p.data_ptr() for k, p in engine.model.named_parameters()}
    misses = engine.metrics.compile_misses

    def serve_once():
        r = engine.add_request(prompt, max_new_tokens=max_new_tokens)
        engine.run()
        return r

    def swap(seed):
        other = build(seed)
        sd = other.state_dict()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = engine.update_weights(sd)
        ms = (time.perf_counter() - t0) * 1e3
        del other, sd
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return v, ms

    r0 = serve_once()
    hit0 = pc.hit_tokens_total
    serve_once()                         # a prefix hit at version 0
    hit_v0 = pc.hit_tokens_total
    v1, ms1 = swap(1)
    r1 = serve_once()
    hit_v1 = pc.hit_tokens_total
    v2, ms2 = swap(0)
    r2 = serve_once()
    hit_v2 = pc.hit_tokens_total
    moved = [k for k, p in engine.model.named_parameters()
             if p.data_ptr() != ptrs[k]]
    res = {"versions": [r0.model_version, r1.model_version,
                        r2.model_version],
           "swap_versions": [v1, v2], "epoch": pc.epoch,
           "second_v0_serve_hit_tokens": hit_v0 - hit0,
           "hit_tokens_after_swaps": [hit_v1 - hit_v0, hit_v2 - hit_v1],
           "t1_differs": r1.output_ids != r0.output_ids,
           "t0_again": r2.output_ids == r0.output_ids,
           "swap_ms": [round(ms1, 3), round(ms2, 3)],
           "parameters": len(ptrs), "moved": moved,
           "new_programs": engine.metrics.compile_misses - misses,
           "after_warmup": engine.stats()["compile_cache"]["after_warmup"],
           "durability": {k: v for k, v in engine.stats()[
               "durability"].items() if k != "journal"}}
    problems = []
    if res["versions"] != [0, 1, 2] or res["swap_versions"] != [1, 2] \
            or res["epoch"] != 2:
        problems.append(f"versions {res['versions']}, epoch {res['epoch']}")
    if res["second_v0_serve_hit_tokens"] <= 0:
        problems.append("the second v0 serve did not hit the prefix cache")
    if res["hit_tokens_after_swaps"] != [0, 0]:
        problems.append(f"hit after a swap: {res['hit_tokens_after_swaps']}")
    if not res["t1_differs"]:
        problems.append("the new weights gave the old stream")
    if not res["t0_again"]:
        problems.append(f"swapping back gave {r2.output_ids}, not "
                        f"{r0.output_ids}")
    if moved or res["new_programs"] or res["after_warmup"]:
        problems.append(f"moved {moved[:3]}, {res['new_programs']} new "
                        f"programs, after_warmup {res['after_warmup']}")
    if problems:
        raise AssertionError("serve_durable (hot swap): "
                             + "; ".join(problems))
    return res


def drain_and_shutdown(drain_engine, shutdown_engine, drain_requests,
                       shutdown_requests, max_new_tokens: int) -> dict:
    """``drain()`` on ``drain_engine`` with its requests in flight (all
    must finish, the engine stop and refuse new work), then
    ``shutdown(timeout_s=0)`` on ``shutdown_engine`` with its requests
    running (cancelled with ``"engine shutdown"``, the pool clean)."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import EngineStopped

    drain_engine.warmup()
    kernels.reset_launches()
    reqs = [drain_engine.add_request(p, sampling=s,
                                     max_new_tokens=max_new_tokens)
            for p, s in drain_requests]
    drain_engine.step()
    in_flight = sum(not r.done for r in reqs)
    st = drain_engine.drain()
    try:
        drain_engine.add_request([1, 2, 3])
        refused = False
    except EngineStopped:
        refused = True
    launches = kernels.launch_counts()
    sreqs = [shutdown_engine.add_request(p, sampling=s,
                                         max_new_tokens=max_new_tokens)
             for p, s in shutdown_requests]
    shutdown_engine.step()
    running = sum(r.state == "running" for r in sreqs)
    sst = shutdown_engine.shutdown(timeout_s=0)
    res = {"drain": {"in_flight": in_flight,
                     "states": sorted({r.state for r in reqs}),
                     "tokens": [len(r.output_ids) for r in reqs],
                     "state": drain_engine.state, "refuses_new": refused,
                     "after_warmup": st["compile_cache"]["after_warmup"],
                     "launches": launches},
           "shutdown": {"running": running,
                        "outcomes": sorted({(r.state, r.error, r.error_kind)
                                            for r in sreqs}),
                        "state": shutdown_engine.state,
                        "kv_block_invariants":
                            sst["health"]["kv_block_invariants"],
                        "blocks_used": sst["paging"]["blocks"]["used"],
                        "after_warmup":
                            sst["compile_cache"]["after_warmup"]}}
    d, s = res["drain"], res["shutdown"]
    problems = []
    if d["in_flight"] != len(reqs) or d["states"] != ["finished"] or \
            d["state"] != "stopped" or not d["refuses_new"]:
        problems.append(f"drain {d}")
    if s["running"] != len(sreqs) or s["outcomes"] != [
            ("cancelled", "engine shutdown", "replica")] or \
            s["state"] != "stopped" or s["kv_block_invariants"] != "ok" or \
            s["blocks_used"] != 0:
        problems.append(f"shutdown {s}")
    if d["after_warmup"] or s["after_warmup"]:
        problems.append("programs built after warmup")
    if problems:
        raise AssertionError("serve_durable (drain/shutdown): "
                             + "; ".join(problems))
    return res


def run_serve_durable(model, build, root: str, rounds: int = 3) -> dict:
    """serve_durable over ``model`` (``build(0)``'s weights): the journal
    cost on serve_paged's engine and traffic, a crash and recovery of 8
    requests, the hot swap, drain (contiguous) and shutdown.  Returns the
    figures and the K4/K5/K1 launches of each part."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import Engine, SamplingParams

    vocab = model.config.vocab_size
    eng = paged_engine(model)
    t0 = time.perf_counter()
    warm = eng.warmup()
    warmup_s = time.perf_counter() - t0
    kernels.reset_launches()
    cost = journal_cost(eng, make_requests(vocab, 12, 512, PAGED_TAILS,
                                           seed=0),
                        64, root, rounds)
    cost["launches"] = kernels.launch_counts()
    # 8 requests, greedy and seeded in turn, after a shared 256-token
    # prompt; the last two end at their second token, before the crash
    rs = np.random.RandomState(5)
    system = rs.randint(0, vocab, (256,)).tolist()
    crash_reqs = []
    for i, tail in enumerate([40, 300, 17, 700, 120, 64, 33, 500]):
        law = SamplingParams() if i % 2 == 0 else SamplingParams(
            temperature=0.8, top_k=40, seed=100 + i)
        crash_reqs.append((system + rs.randint(0, vocab, (tail,)).tolist(),
                           law, 2 if i >= 6 else 32))
    eng2, recovery = crash_and_recover(
        eng, lambda j: paged_engine(model, journal=j), crash_reqs, root)
    del eng                              # the crashed engine's pool and graphs
    gc.collect()
    if next(model.parameters()).is_cuda:
        torch.cuda.empty_cache()
    kernels.reset_launches()
    swap = hot_swap(eng2, build, rs.randint(0, vocab, (300,)).tolist(), 16)
    swap["launches"] = kernels.launch_counts()
    # serve_contiguous's engine
    contiguous = Engine(model, kv_layout="contiguous", num_slots=4,
                        max_seq=2048, min_bucket=16)
    lifecycle = drain_and_shutdown(
        contiguous, eng2,
        make_requests(vocab, 4, 512, [100, 400, 250, 31], seed=6),
        make_requests(vocab, 2, 128, [50, 90], seed=7), 16)
    eng2.journal.close()
    return {"warmup_s": round(warmup_s, 3),
            "warmup_programs": warm["compile_misses"],
            "journal_cost": cost, "recovery": recovery, "hot_swap": swap,
            **lifecycle}


def _sum_launches(*counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_serve_durable(model) -> dict:
    """Llama-2 7B (serve_paged's model) with a request journal: the
    journal's cost, a crash and recovery, a hot swap of the weights under
    the CUDA graphs, drain and shutdown."""
    from paddle_tpu_torch.serving import Engine

    def build(seed):
        return Engine.resolve_model("llama:llama2-7b", device="cuda",
                                    dtype=torch.bfloat16, seed=seed)

    with tempfile.TemporaryDirectory() as root:
        res = run_serve_durable(model, build, root)
    parts = {"journal_cost": res["journal_cost"]["launches"],
             "recovery": res["recovery"]["launches"],
             "hot_swap": res["hot_swap"]["launches"],
             "drain": res["drain"]["launches"]}
    for part in ("journal_cost", "recovery", "hot_swap"):
        if parts[part]["paged_decode"] < 1 or \
                parts[part]["paged_prefill"] < 1:
            raise AssertionError(f"serve_durable ({part}) did not run "
                                 f"K4/K5: {parts[part]}")
    if parts["drain"]["flash_fwd"] < 1:
        raise AssertionError(f"serve_durable (drain) did not run K1: "
                             f"{parts['drain']}")
    res["launches"] = _sum_launches(*parts.values())
    emit("serve_durable", model="llama2-7b", dtype="bfloat16", **res)
    return res


# -- phase 11: the SIGKILL drill -------------------------------------------

#: one child of the drill: ``serve`` journals 3 requests (greedy, seeded,
#: greedy) through a paged engine of 2 slots and SIGKILLs itself at its
#: third step; ``recover`` rebuilds the same model, recovers, serves, holds
#: each recovered stream to the same request served uninterrupted (from
#: its journaled recipe) and prints one JSON line.  On the card a child
#: builds no kernel: the parent built them into ``_build/``.
_DRILL_CHILD = r"""
import json, os, signal, sys
import numpy as np
import torch
from paddle_tpu_torch import create_engine
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.serving import RequestJournal, SamplingParams

mode, jdir, spec, device, dtype, max_seq, lens, new = sys.argv[1:9]
if device == "cuda":
    assert torch.cuda.is_available(), "the drill's children need the card"
    assert all(b["cached"] for b in kernels.build().values()), \
        "a child of the drill built a kernel"
journal = RequestJournal(jdir)
eng = create_engine(spec, device=device, dtype=getattr(torch, dtype),
                    seed=0, kv_layout="paged", block_size=16,
                    min_bucket=16, num_slots=2, max_seq=int(max_seq),
                    journal=journal)
eng.warmup()
if mode == "serve":
    rs = np.random.RandomState(5)
    laws = [SamplingParams(),
            SamplingParams(temperature=0.7, top_k=8, seed=99),
            SamplingParams()]
    reqs = [eng.add_request(
        rs.randint(0, eng.config.vocab_size, (n,)).tolist(), sampling=law,
        max_new_tokens=int(new)) for n, law in zip(json.loads(lens), laws)]
    steps = 0
    while eng.step():
        steps += 1
        if steps == 3:               # mid-decode, tokens already streamed
            print("KILLING", json.dumps({r.journal_id: r.output_ids
                                         for r in reqs}), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
    raise SystemExit("unreachable: the SIGKILL must land mid-decode")
pend = journal.pending()
journaled = {jid: journal.outputs(jid) for jid in pend}
misses0 = eng.metrics.compile_misses
kernels.reset_launches()
info = eng.recover()
eng.run()
rec = info["requests"]
eng.prefix_cache.clear()             # the references start as cold
refs = []
for r in pend.values():
    s = journal.replay_sampling(r)
    refs.append(eng.add_request(
        r["prompt_ids"], max_new_tokens=r["max_new_tokens"],
        sampling=SamplingParams(temperature=s["temperature"],
                                top_k=s["top_k"], top_p=s["top_p"],
                                seed=s["seed"])))
eng.run()
a = journal.audit()
print(json.dumps({
    "replayed": info["replayed"],
    "recovered_flags": [bool(r.recovered) for r in rec],
    "all_finished": all(r.state == "finished" for r in rec),
    "bitwise": [r.output_ids for r in rec] == [r.output_ids for r in refs],
    "journaled": journaled,
    "recovered_streams": {r.journal_id: r.output_ids for r in rec},
    "steady_misses": eng.metrics.compile_misses - misses0,
    "pending_after": a["pending"],
    "duplicate_terminals": a["duplicate_terminals"],
    "launches": kernels.launch_counts()}))
"""


def sigkill_drill(spec: str, device: str, dtype: str, max_seq: int,
                  prompt_lens, new_tokens: int, root: str) -> dict:
    """Run the drill's two children from the repository root with this
    Python.  The first must die by SIGKILL after printing ``KILLING`` and
    the tokens its clients received; the second's JSON line must show 3
    replays, all recovered and finished, bitwise equal to uninterrupted
    runs, a journal that held exactly the received tokens, each replay
    beginning with them, no program built after warmup, nothing pending
    and no duplicate terminal."""
    here = os.path.dirname(os.path.abspath(__file__))
    args = [os.path.join(root, "drill"), spec, device, dtype, str(max_seq),
            json.dumps(list(prompt_lens)), str(new_tokens)]
    t0 = time.perf_counter()
    r1 = subprocess.run([sys.executable, "-c", _DRILL_CHILD, "serve", *args],
                        cwd=here, capture_output=True, text=True,
                        timeout=300)
    t1 = time.perf_counter()
    if r1.returncode != -signal.SIGKILL or "KILLING" not in r1.stdout:
        raise AssertionError(f"sigkill_drill: the serving child ended with "
                             f"{r1.returncode}: {r1.stdout[-1000:]} "
                             f"{r1.stderr[-2000:]}")
    r2 = subprocess.run([sys.executable, "-c", _DRILL_CHILD, "recover",
                         *args], cwd=here, capture_output=True, text=True,
                        timeout=300)
    t2 = time.perf_counter()
    if r2.returncode != 0:
        raise AssertionError(f"sigkill_drill: the recovering child failed "
                             f"({r2.returncode}): {r2.stderr[-2000:]}")
    out = json.loads(r2.stdout.strip().splitlines()[-1])
    sent = json.loads(r1.stdout.split("KILLING", 1)[1].splitlines()[0])
    journaled, streams = out.pop("journaled"), out.pop("recovered_streams")
    out.update(
        sent_tokens=sum(len(t) for t in sent.values()),
        journal_holds_sent=journaled == sent,
        continues_sent=sorted(streams) == sorted(sent) and all(
            streams[j][:len(t)] == t for j, t in sent.items()))
    want = {"replayed": 3, "recovered_flags": [True] * 3,
            "all_finished": True, "bitwise": True,
            "journal_holds_sent": True, "continues_sent": True,
            "steady_misses": 0, "pending_after": 0,
            "duplicate_terminals": 0}
    got = {k: out[k] for k in want}
    if got != want:
        raise AssertionError(f"sigkill_drill: {got}, want {want}")
    out.update(serve_child_s=round(t1 - t0, 3),
               recover_child_s=round(t2 - t1, 3),
               killed_by=-r1.returncode)
    return out


def phase_sigkill_drill() -> dict:
    """GPT-2 345M at full width (random weights from seed 0, made on the
    card in each child), paged, bf16."""
    with tempfile.TemporaryDirectory() as root:
        res = sigkill_drill("gpt:gpt2-345m", "cuda", "bfloat16", 1024,
                            [60, 333, 130], 16, root)
    if res["launches"]["paged_decode"] < 1 or \
            res["launches"]["paged_prefill"] < 1:
        raise AssertionError(f"sigkill_drill did not run K4/K5: "
                             f"{res['launches']}")
    emit("sigkill_drill", model="gpt2-345m", dtype="bfloat16", **res)
    return res


# -- phases 15 and 16: speculative decoding --------------------------------

SPEC_K = 4
#: the shape of JackFram/llama-68m, SpecInfer's public draft for Llama
#: targets (random weights here; made in this script, not registered)
SPEC_DRAFT_68M = dict(vocab_size=32000, hidden_size=768, num_hidden_layers=2,
                      num_attention_heads=12, intermediate_size=3072,
                      max_position_embeddings=2048)
#: serve_spec's engine: serve_paged's, at max_seq 2048
SPEC_ENGINE = dict(kv_layout="paged", block_size=16, min_bucket=16,
                   num_slots=8, max_seq=2048)


def spec_draft_68m(device, dtype, seed: int = 1):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    gen = torch.Generator(device=device).manual_seed(seed)
    return LlamaForCausalLM(LlamaConfig(**SPEC_DRAFT_68M), device=device,
                            dtype=dtype, generator=gen).eval()


def record_programs(engine) -> list:
    """Wrap ``engine.programs.run`` (an instance attribute; ``del
    engine.programs.run`` restores it): each call appends ``(key[0],
    start, end)``, two CUDA events recorded on the host's stream around
    it (no sync), or nothing on the CPU.  Returns the list."""
    calls, run = [], engine.programs.run
    cuda = engine.device.type == "cuda"

    def timed(key, body, *inputs):
        if not cuda:
            return run(key, body, *inputs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(key, body, *inputs)
        end.record()
        calls.append((key[0], start, end))
        return out

    engine.programs.run = timed
    return calls


def program_ms(calls) -> dict:
    """Summed milliseconds and calls per program kind of
    :func:`record_programs`' list (synchronises first)."""
    if calls:
        torch.cuda.synchronize()
    out = {}
    for kind, start, end in calls:
        ms, n = out.get(kind, (0.0, 0))
        out[kind] = (ms + start.elapsed_time(end), n + 1)
    return {k: {"ms": ms, "calls": n} for k, (ms, n) in out.items()}


def greedy_agreement(requests, streams, reference) -> dict:
    """Of the greedy requests, the share whose stream equals the
    reference's, and the first divergence (request, token index)."""
    greedy = [i for i, (_, law) in enumerate(requests)
              if law.temperature == 0.0]
    same, first = 0, None
    for i in greedy:
        a, b = streams[i], reference[i]
        if a == b:
            same += 1
        elif first is None:
            j = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            first = {"request": i, "token": j}
    return {"greedy_requests": len(greedy),
            "equal_share": same / max(len(greedy), 1),
            "first_divergence": first}


def pool_audit(engine, phase: str) -> dict:
    """The paged pool after a phase's run: its invariants hold and no
    block is in use, or the phase fails."""
    audit = engine.cache.check_invariants()
    used = engine.cache.allocator.stats()["used"]
    if audit or used:
        raise AssertionError(f"{phase}: pool after the run: {audit}, "
                             f"{used} blocks in use")
    return {"invariants": "ok", "blocks_in_use": used}


def run_serve_spec(model, draft, requests, max_new_tokens: int, reference,
                   **engine_kw) -> tuple:
    """A paged speculating engine (``SPEC_ENGINE`` updated by
    ``engine_kw``, k = ``SPEC_K``) over ``model`` with ``draft`` serves
    ``requests`` through :func:`serve`; the run's programs are timed with
    CUDA events (device ms per round, draft steps and verify apart).
    Fails unless the pool audits clean with no block in use after.
    Returns the engine and the run's figures, with the greedy streams'
    agreement with ``reference`` (the same requests' streams without
    speculation)."""
    from paddle_tpu_torch.serving import Engine, SpecConfig

    eng = Engine(model, **{**SPEC_ENGINE, **engine_kw},
                 speculation=SpecConfig(draft_model=draft, k=SPEC_K))
    calls = record_programs(eng)
    res = serve(eng, requests, max_new_tokens)
    n_warm = expected_programs(eng)
    del eng.programs.run
    by_kind = program_ms(calls[n_warm:])
    st = eng.stats()
    spec = st["speculation"]
    rounds = max(spec["rounds"], 1)
    res.update({
        "speculation": spec,
        "allocator": pool_audit(eng, "serve_spec"),
        "programs_ms": by_kind,
        "device_ms_per_round": (None if not by_kind else {
            "draft_steps": by_kind.get("draft_decode", {}).get("ms", 0.0)
            / rounds,
            "verify": by_kind.get("verify", {}).get("ms", 0.0) / rounds}),
        "greedy": greedy_agreement(requests, res["outputs"], reference)})
    return eng, res


def phase_serve_spec(model, reference) -> dict:
    """serve_paged's Llama-2 7B and traffic through a speculating paged
    engine (max_seq 2048, k 4), with an independent draft of
    JackFram/llama-68m's shape and with the target as its own draft.
    Returns the K4/K5/K1 launches of both runs."""
    reqs = make_requests(model.config.vocab_size, 12, 512, PAGED_TAILS,
                         seed=0)
    draft = spec_draft_68m("cuda", torch.bfloat16)
    launches = []
    for label, d in (("llama-68m shape, seed 1", draft),
                     ("self (the target)", model)):
        eng, res = run_serve_spec(model, d, reqs, 64, reference)
        for name in ("paged_decode", "paged_prefill", "flash_fwd"):
            if res["launches"][name] < 1:
                raise AssertionError(f"serve_spec ({label}) did not run "
                                     f"{name}: {res['launches']}")
        launches.append(res["launches"])
        emit("serve_spec", model="llama2-7b", dtype="bfloat16", draft=label,
             k=SPEC_K, max_seq=eng.max_seq,
             kv_pool_gb=round(eng.cache.nbytes() / 2 ** 30, 3),
             draft_cache_gb=round(eng.spec.nbytes() / 2 ** 30, 3),
             **{k: v for k, v in res.items() if k != "outputs"})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del draft
    # how far bf16 rounding alone parts serve_paged's greedy streams: the
    # same traffic through the plain engine at serve_spec's max_seq, on
    # the kernels and on the gather path (no kernel)
    from paddle_tpu_torch.serving import Engine

    agree = {}
    for kernel in ("cuda", "reference"):
        res = serve(Engine(model, **{**SPEC_ENGINE, "kernel": kernel}),
                    reqs, 64)
        agree[kernel] = greedy_agreement(reqs, res["outputs"], reference)
        gc.collect()
        torch.cuda.empty_cache()
    emit("serve_spec", model="llama2-7b", dtype="bfloat16",
         part="plain_engine", max_seq=SPEC_ENGINE["max_seq"],
         greedy_by_kernel=agree)
    return _sum_launches(*launches)


#: serve_spec's windows for the verify route's check: 8 slots, the first
#: window running past max_seq 2048 (positions 2045..2049)
SPEC_VERIFY_LENGTHS = [2045, 1800, 1536, 1200, 1024, 700, 333, 0]


def check_verify_route(gen, dtype, lengths=SPEC_VERIFY_LENGTHS, H=32, Hkv=32,
                       D=128, bs=16, max_seq=2048, W=SPEC_K + 1):
    """The paged verify route (a ``[slots, W]`` window as ``slots·W`` K4
    rows) against the plain ``verify_attention`` over the gathered pool,
    at serve_spec's shape.  The plain path is also the route's
    alternative on the card (the gather copies every slot's whole
    table)."""
    from paddle_tpu_torch.ops import cached_attention as ca

    B, MB = len(lengths), max_seq // bs
    kp, vp = _pool(gen, B * MB + 1, bs, Hkv, D, dtype)
    tables = (torch.randperm(B * MB, generator=gen, device="cuda") + 1
              ).reshape(B, MB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, W, H, D), generator=gen, device="cuda").to(dtype)

    def kern():
        return ca.paged_verify_attention(q, kp, vp, tables, lens)

    def plain():
        return ca.verify_attention(q, ca.gather_block_kv(kp, tables),
                                   ca.gather_block_kv(vp, tables), lens)

    err = (kern().float() - plain().float()).abs().max().item()
    isz = torch.finfo(dtype).bits // 8
    # each slot's live K/V rows once (its window's last row's), q and out
    live = sum(min(n + W, MB * bs) for n in lengths)
    keys = sum(min(n + i + 1, MB * bs) for n in lengths for i in range(W))
    nbytes = live * Hkv * D * 2 * isz + 2 * B * W * H * D * isz \
        + tables.numel() * 4 + B * 4
    return {"err": err, "kern": kern, "plain": plain,
            "bound": bound(nbytes, 4 * H * D * keys, dtype)}


def ticket_replay(device, dtype, lengths=SPEC_VERIFY_LENGTHS, H=32, Hkv=32,
                  D=128, bs=16, max_seq=2048, W=SPEC_K + 1) -> dict:
    """K4's merge tickets across a decode graph and a verify graph of one
    registry (one capture stream): the decode is captured first (tickets
    for ``slots`` rows), then the verify, whose first call outgrows that
    buffer (``slots·W`` rows) and retires it to the decode graph.  Then
    decode → verify → decode are replayed at new lengths, each held
    bitwise to an eager call of the same function on the same inputs.
    Returns whether each replay matched and the tickets left nonzero."""
    from paddle_tpu_torch.ops import cached_attention as ca
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving.programs import StepPrograms

    gen = torch.Generator(device=device).manual_seed(5)
    B, MB = len(lengths), max_seq // bs
    kp, vp = (t[:, 1] for t in (
        torch.randn((B * MB + 1, 2, bs, Hkv, D), generator=gen,
                    device=device).to(dtype) for _ in range(2)))
    tables = (torch.randperm(B * MB, generator=gen, device=device) + 1
              ).reshape(B, MB).to(torch.int32)
    q1 = torch.randn((B, 1, H, D), generator=gen, device=device).to(dtype)
    qw = torch.randn((B, W, H, D), generator=gen, device=device).to(dtype)

    def decode(lens):
        return ca.paged_decode_attention(q1, kp, vp, tables, lens)

    def verify(lens):
        return ca.paged_verify_attention(qw, kp, vp, tables, lens)

    progs = StepPrograms(device, lambda miss: None)
    rs = np.random.RandomState(7)
    steps = [("decode", decode), ("verify", verify)] * 2 + [("decode",
                                                               decode)]
    matched = []
    for i, (key, fn) in enumerate(steps):
        lens = np.array(lengths if i < 2 else rs.randint(
            0, max_seq - W, (B,)), dtype=np.int32)
        got = progs.run((key,), fn, lens).clone()
        want = fn(torch.from_numpy(lens).to(device))
        matched.append((key, "capture" if i < 2 else "replay",
                        bool(torch.equal(got, want))))
    if device.type == "cuda":
        torch.cuda.synchronize()
    dirty = sum(int(t.count_nonzero()) for t in
                list(kernels._decode_tickets.values())
                + kernels._retired_tickets)
    return {"calls": matched, "all_equal": all(m for *_, m in matched),
            "tickets_nonzero": dirty}


def drive_spec_parity(model, draft, layout: str, requests,
                      max_new_tokens: int, **engine_kw) -> dict:
    """The same greedy requests through a plain engine and a speculating
    one (k = ``SPEC_K``) over ``model``: the streams must be equal, token
    for token.  Returns both streams, the speculating engine's
    ``compile_cache``, ``speculation`` and launch counts, and its pool's
    audit (paged)."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import Engine, SpecConfig

    def run(eng):
        eng.warmup()
        kernels.reset_launches()
        reqs = [eng.add_request(p, sampling=s, max_new_tokens=max_new_tokens)
                for p, s in requests]
        eng.run()
        return [r.output_ids for r in reqs], [r.state for r in reqs]

    plain, _ = run(Engine(model, kv_layout=layout, **engine_kw))
    eng = Engine(model, kv_layout=layout, **engine_kw,
                 speculation=SpecConfig(draft_model=draft, k=SPEC_K))
    spec, states = run(eng)
    st = eng.stats()
    out = {"identical": spec == plain, "plain": plain, "spec": spec,
           "states": states, "compile_cache": st["compile_cache"],
           "speculation": st["speculation"],
           "launches": kernels.launch_counts()}
    if layout == "paged":
        out["allocator"] = {
            "invariants": eng.cache.check_invariants() or "ok",
            "blocks_in_use": eng.cache.allocator.stats()["used"]}
    return out


def check_spec_parity(res: dict, label: str) -> None:
    if not res["identical"]:
        raise AssertionError(f"spec_parity ({label}): speculative streams "
                             f"{res['spec']} != plain {res['plain']}")
    if any(s != "finished" for s in res["states"]):
        raise AssertionError(f"spec_parity ({label}): {res['states']}")
    cc = res["compile_cache"]
    if cc["after_warmup"] != 0 or cc["hits"] < 1:
        raise AssertionError(f"spec_parity ({label}): {cc}")
    if res["speculation"]["rounds"] < 1:
        raise AssertionError(f"spec_parity ({label}): no round ran")
    al = res.get("allocator")
    if al is not None and (al["invariants"] != "ok"
                           or al["blocks_in_use"]):
        raise AssertionError(f"spec_parity ({label}): pool {al}")


def spec_parity_requests(vocab: int, max_seq: int, seed: int):
    """Four greedy requests after a 48-token system prompt, and a fifth
    whose prompt ends 3 positions short of ``max_seq``: it waits for a
    slot, and its rounds' windows run past the end until it retires on
    capacity."""
    from paddle_tpu_torch.serving import SamplingParams

    reqs = make_requests(vocab, 4, 48, [5, 40, 17, 90], seed=seed)
    system = reqs[0][0][:48]
    tail = np.random.RandomState(seed).randint(0, vocab,
                                               (max_seq - 3 - 48,))
    greedy = SamplingParams()
    return ([(p, greedy) for p, _ in reqs]
            + [(system + tail.tolist(), greedy)])


def full_depth_spec_parity() -> None:
    """Llama-2 7B at full depth (32 layers) in f32, random weights from
    seed 0, with the llama-68m-shaped draft in f32: four greedy requests
    through a plain and a speculating paged engine (serve_spec's
    geometry) must give equal streams of 32 tokens."""
    from paddle_tpu_torch.serving import Engine, SamplingParams

    model = Engine.resolve_model("llama:llama2-7b", device="cuda",
                                 dtype=torch.float32, seed=0)
    draft = spec_draft_68m("cuda", torch.float32)
    reqs = [(p, SamplingParams()) for p, _ in make_requests(
        model.config.vocab_size, 4, 128, [64, 300, 128, 200], seed=0)]
    kw = {k: v for k, v in SPEC_ENGINE.items() if k != "kv_layout"}
    res = drive_spec_parity(model, draft, "paged", reqs, 32, **kw)
    check_spec_parity(res, "llama2-7b, 32 layers, f32")
    emit("spec_parity", model="llama2-7b, 32 layers", dtype="float32",
         layout="paged", draft="llama-68m shape", requests=len(reqs),
         identical=res["identical"], compile_cache=res["compile_cache"],
         speculation=res["speculation"], allocator=res["allocator"],
         launches=res["launches"])
    del model, draft, res
    gc.collect()
    torch.cuda.empty_cache()


def phase_spec_parity() -> None:
    """f32, 2 layers, Llama-2 7B's and GPT-2 345M's widths: greedy
    speculative streams equal the plain engine's in both layouts, with an
    independent 1-layer draft of the same width and with the target as
    its own draft; the verify route against the plain verify at
    serve_spec's shape (f32 and bf16, timed in bf16 against the gather +
    plain attention); K4's tickets across decode and verify graphs."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    route = {}
    for dt in BOTH:
        res = check_verify_route(gen, dt)
        tol = TOLERANCE[dt]
        key = str(dt).split(".")[-1]
        route[key] = {"max_abs_err": res["err"], "tolerance": tol}
        if not res["err"] <= tol:
            raise AssertionError(f"spec_parity: verify route ({key}) err "
                                 f"{res['err']} > {tol}")
        if dt == torch.bfloat16:
            route[key].update(
                ms=cuda_ms(res["kern"]), gather_plain_ms=cuda_ms(
                    res["plain"], iters=3),
                bound_ms=res["bound"][0], bound_by=res["bound"][1])
        del res
    tickets = ticket_replay(torch.device("cuda"), torch.bfloat16)
    emit("spec_parity", part="verify_route",
         shape="8 slots, W 5, lengths <= 2045 (the first past max_seq "
               "2048), H = Hkv = 32, D 128, bs 16",
         route=route, tickets=tickets)
    if not tickets["all_equal"] or tickets["tickets_nonzero"]:
        raise AssertionError(f"spec_parity: ticket replay {tickets}")
    full_depth_spec_parity()
    for label, build in parity_models():
        model = build()
        cfg = model.config
        dgen = torch.Generator(device="cuda").manual_seed(2)
        draft = type(model)(dataclasses.replace(cfg, num_hidden_layers=1),
                            device="cuda", dtype=torch.float32,
                            generator=dgen).eval()
        reqs = spec_parity_requests(cfg.vocab_size, 256, seed=3)
        for layout in ("paged", "contiguous"):
            for dname, d in (("1-layer draft", draft), ("self", model)):
                res = drive_spec_parity(model, d, layout, reqs, 12,
                                        num_slots=4, max_seq=256,
                                        min_bucket=16, block_size=16)
                check_spec_parity(res, f"{label}, {layout}, {dname}")
                emit("spec_parity", model=label, dtype="float32",
                     layout=layout, draft=dname, requests=len(reqs),
                     identical=res["identical"],
                     capacity_retire_tokens=len(res["spec"][-1]),
                     compile_cache=res["compile_cache"],
                     speculation=res["speculation"],
                     allocator=res.get("allocator"),
                     launches=res["launches"])
        del model, draft
        gc.collect()
        torch.cuda.empty_cache()


# -- phases 17 and 18: multi-tenant serving ----------------------------------

#: serve_tenancy's adapter pool: 4 lanes of rank 16 beside the base lane
TENANCY_ADAPTERS = dict(max_adapters=4, rank=16)
#: the adapters' factors are drawn N(0, 0.05) (``make_lora_weights``), so
#: that a delta ``(x @ A) @ B`` is of the order of a projection's output
#: at these widths and every greedy stream under an adapter parts from
#: the base model's (the default 0.02 moves the logits far less)
TENANCY_SCALE = 0.05
#: the tenants of the mixed traffic, round robin: base, three adapters,
#: the JSON grammar
TENANTS = (None, "t1", "t2", "t3", "json")


def tenancy_engine(model, eos: int, scale: float = TENANCY_SCALE,
                   **engine_kw):
    """An engine over ``model`` with ``TENANCY_ADAPTERS`` and the bounded
    JSON grammar (``eos`` its stop token), warmed, then ``t1``-``t3``
    loaded from seeds 1-3 at ``init_scale=scale`` (written in place after
    the capture)."""
    from paddle_tpu_torch.serving import (
        Engine, JsonArrayGrammar, make_lora_weights,
    )

    eng = Engine(model, **engine_kw, adapters=TENANCY_ADAPTERS,
                 grammars={"json": JsonArrayGrammar(eos_token_id=eos)})
    eng.warmup()
    for i, name in enumerate(("t1", "t2", "t3"), start=1):
        eng.load_adapter(name, make_lora_weights(
            eng.adapter_pool, seed=i, init_scale=scale))
    return eng


def tenant_law(tenant, law):
    """``law`` (a ``SamplingParams``) under ``tenant``: an adapter's name,
    ``"json"`` (the grammar) or None (the base model)."""
    if tenant == "json":
        return dataclasses.replace(law, grammar="json")
    return dataclasses.replace(law, adapter=tenant)


def mixed_requests(requests, seed: int):
    """``requests``' prompts round robin over ``TENANTS``, greedy and at
    temperature 0.8 (seeded) in turn: ``(prompt, tenant, law)``."""
    from paddle_tpu_torch.serving import SamplingParams

    out = []
    for i, (prompt, _) in enumerate(requests):
        law = (SamplingParams() if i % 2 == 0
               else SamplingParams(temperature=0.8, seed=seed + i))
        tenant = TENANTS[i % len(TENANTS)]
        out.append((prompt, tenant, tenant_law(tenant, law)))
    return out


def serve_mixed(engine, mixed, max_new_tokens: int) -> dict:
    """Serve ``mixed`` (``mixed_requests``) on the warmed tenancy
    ``engine`` from a cold prefix cache.  Every stream must finish, the
    JSON ones accepted by the grammar's oracle (they stop at its eos), the
    others at ``max_new_tokens``.  Returns per-tenant TTFT and client ITL
    (the gaps between a stream's tokens at its callback), the run's
    tokens/s, launches and streams."""
    from paddle_tpu_torch.ops import kernels

    spec = engine.grammar_table.spec_of("json")
    vocab = engine.config.vocab_size
    if engine.prefix_cache is not None:
        engine.prefix_cache.clear()
    m = engine.metrics
    tokens0, time0 = m.decode_tokens, m.decode_time_s
    stamps = {}

    def cb(tok, req):
        stamps.setdefault(req.request_id, []).append(time.perf_counter())

    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    reqs = [engine.add_request(p, sampling=law, stream_cb=cb,
                               max_new_tokens=max_new_tokens)
            for p, _, law in mixed]
    engine.run()
    if cuda:
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    problems = []
    by = {}
    for (_, tenant, law), r in zip(mixed, reqs):
        label = r.tenant
        if r.state != "finished":
            problems.append(f"request {r.request_id} ({label}) {r.state}: "
                            f"{r.error}")
        elif tenant == "json":
            if not spec.accepts(r.output_ids, vocab):
                problems.append(f"json stream {r.output_ids} rejected")
        elif len(r.output_ids) != max_new_tokens:
            problems.append(f"request {r.request_id} ({label}): "
                            f"{len(r.output_ids)} tokens")
        ts = stamps.get(r.request_id, [])
        d = by.setdefault(label, {"ttft": [], "gaps": [], "tokens": 0})
        d["ttft"].append(r.ttft_s)
        d["gaps"] += [b - a for a, b in zip(ts, ts[1:])]
        d["tokens"] += len(r.output_ids)
    if problems:
        raise AssertionError("serve_tenancy (mixed): " + "; ".join(problems))
    st = engine.stats()
    return {"per_tenant": {
                t: {"requests": len(d["ttft"]), "tokens": d["tokens"],
                    "ttft": _percentiles(d["ttft"]),
                    "client_itl": _percentiles(d["gaps"])}
                for t, d in sorted(by.items())},
            "decode_tokens_per_sec": round(
                (m.decode_tokens - tokens0) / (m.decode_time_s - time0), 2),
            "tenants": st["tenants"]["by_tenant"],
            "launches": launches,
            "outputs": [r.output_ids for r in reqs]}


def salted_domains(engine, system, prompt) -> dict:
    """``system`` was served under every tenant; ``prompt`` is served now
    under ``t1`` alone.  The prefix probe must see ``system`` in each
    adapter's domain and the base one, and ``prompt`` in ``t1``'s only."""
    from paddle_tpu_torch.serving import SamplingParams

    r = engine.add_request(prompt, max_new_tokens=2,
                           sampling=SamplingParams(adapter="t1"))
    engine.run()
    res = {"system": {str(t): engine.prefix_probe(system + [0], adapter=t)
                      for t in (None, "t1", "t2", "t3")},
           "t1_only": {str(t): engine.prefix_probe(prompt, adapter=t)
                       for t in (None, "t1", "t2", "t3")}}
    if r.state != "finished" or min(res["system"].values()) <= 0 or \
            res["t1_only"]["t1"] <= 0 or any(
                v for t, v in res["t1_only"].items() if t != "t1"):
        raise AssertionError(f"serve_tenancy (salted domains): {res}")
    return res


def tenant_swaps(engine, prompt, max_new_tokens: int,
                 scale: float = TENANCY_SCALE) -> dict:
    """On the idle tenancy ``engine``: ``prompt``'s greedy stream under
    the base model and under ``t1``-``t3`` (each adapter's must part from
    the base's and from the others'); a ``t1`` request hot-swapped
    mid-flight (to seed 4's factors) and a ``t2`` request unloaded
    mid-flight must fail with the JAX engine's ``error_ctx``; reloading
    the v1 factors must give the v1 streams back.  No lane may move and
    no program may be built."""
    from paddle_tpu_torch.serving import SamplingParams, make_lora_weights

    pool = engine.adapter_pool
    ptrs, misses = pool._lane_ptrs(), engine.metrics.compile_misses
    cuda = engine.device.type == "cuda"

    def stream(tenant):
        # from a cold prefix cache: every stream prefills the same way
        if engine.prefix_cache is not None:
            engine.prefix_cache.clear()
        r = engine.add_request(prompt, max_new_tokens=max_new_tokens,
                               sampling=tenant_law(tenant, SamplingParams()))
        engine.run()
        return r.output_ids

    def timed(fn, *args):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        return out, round((time.perf_counter() - t0) * 1e3, 3)

    base = stream(None)
    v1 = {t: stream(t) for t in ("t1", "t2", "t3")}
    differ = all(s != base for s in v1.values()) and \
        len({tuple(s) for s in v1.values()}) == 3
    r1 = engine.add_request(prompt, max_new_tokens=4 * max_new_tokens,
                            sampling=SamplingParams(adapter="t1"))
    engine.step()
    engine.step()
    t4 = make_lora_weights(pool, seed=4, init_scale=scale)
    swap_v, swap_ms = timed(engine.load_adapter, "t1", t4)
    r2 = engine.add_request(prompt, max_new_tokens=4 * max_new_tokens,
                            sampling=SamplingParams(adapter="t2"))
    engine.step()
    unload_v, unload_ms = timed(engine.unload_adapter, "t2")
    swapped = stream("t1")
    for i, name in ((1, "t1"), (2, "t2")):
        engine.load_adapter(name, make_lora_weights(
            pool, seed=i, init_scale=scale))
    back = {t: stream(t) for t in ("t1", "t2")}
    engine.run()
    res = {"adapters_differ_from_base": differ,
           "hot_swap": {"state": r1.state, "error_ctx": r1.error_ctx,
                        "new_version": swap_v, "ms": swap_ms,
                        "new_stream_differs": swapped != v1["t1"]},
           "unload": {"state": r2.state, "error_ctx": r2.error_ctx,
                      "version": unload_v, "ms": unload_ms},
           "v1_back": {t: back[t] == v1[t] for t in back},
           "versions": pool.loaded,
           "lanes_moved": pool._lane_ptrs() != ptrs,
           "new_programs": engine.metrics.compile_misses - misses,
           "after_warmup": engine.stats()["compile_cache"]["after_warmup"]}
    problems = []
    if not differ:
        problems.append(f"adapter streams {v1} vs base {base}")
    if r1.state != "failed" or r1.error_ctx != {"adapter": "t1",
                                                "version": 1}:
        problems.append(f"hot swap left {r1.state} {r1.error_ctx}")
    if r2.state != "failed" or r2.error_ctx != {"adapter": "t2",
                                                "version": 1}:
        problems.append(f"unload left {r2.state} {r2.error_ctx}")
    if not res["hot_swap"]["new_stream_differs"]:
        problems.append("the swapped-in factors gave the v1 stream")
    if not all(res["v1_back"].values()):
        problems.append(f"reloaded v1 factors gave {back}, not {v1}")
    if res["versions"] != {"t1": 3, "t2": 2, "t3": 1}:
        problems.append(f"versions {res['versions']}")
    if res["lanes_moved"] or res["new_programs"] or res["after_warmup"]:
        problems.append(f"lanes moved {res['lanes_moved']}, "
                        f"{res['new_programs']} new programs")
    if problems:
        raise AssertionError("serve_tenancy (swaps): " + "; ".join(problems))
    return res


def run_serve_tenancy(model, requests, max_new_tokens: int, eos: int,
                      scale: float = TENANCY_SCALE, **engine_kw) -> dict:
    """serve_tenancy's four checks over ``model`` with ``engine_kw``:
    (a) ``requests`` with no tenant through a plain engine and a tenancy
    engine (lanes loaded, none selected) in turns (plain, tenancy,
    tenancy, plain), each from a cold prefix cache (``timed_run``):
    every stream bitwise the
    plain's; (b) the same prompts over ``TENANTS`` (``serve_mixed``), the
    base greedy stream bitwise the plain's; (c) ``salted_domains``; (d)
    ``tenant_swaps``.  Returns the figures."""
    from paddle_tpu_torch.serving import Engine

    plain = Engine(model, **engine_kw)
    plain.warmup()
    ten = tenancy_engine(model, eos, scale, **engine_kw)
    runs = {"plain": [], "lanes_off": []}
    for eng in (plain, ten, ten, plain):
        res = timed_run(eng, requests, max_new_tokens)
        runs["plain" if eng is plain else "lanes_off"].append(res)
    base = runs["plain"][0]["outputs"]
    bitwise = all(r["outputs"] == base for rs in runs.values() for r in rs)
    if not bitwise:
        raise AssertionError("serve_tenancy (lanes off): streams differ from "
                             "the plain engine's")
    del plain
    gc.collect()
    if ten.device.type == "cuda":
        torch.cuda.empty_cache()
    mixed = mixed_requests(requests, seed=7)
    mix = serve_mixed(ten, mixed, max_new_tokens)
    if mix["outputs"][0] != base[0]:
        raise AssertionError("serve_tenancy (mixed): the base greedy stream "
                             "differs from the plain engine's")
    system = os.path.commonprefix([p for p, _ in requests])
    rs = np.random.RandomState(5)
    fresh = rs.randint(0, model.config.vocab_size, (64,)).tolist()
    salts = salted_domains(ten, system, fresh)
    swaps = tenant_swaps(ten, requests[0][0], 16, scale)
    audit = (pool_audit(ten, "serve_tenancy") if ten.kv_layout == "paged"
             else None)
    st = ten.stats()
    if st["compile_cache"]["after_warmup"] != 0:
        raise AssertionError(f"serve_tenancy: programs built after warmup: "
                             f"{st['compile_cache']}")
    summary = {k: [{f: r[f] for f in ("ttft_p50_ms", "itl", "client_itl",
                                      "decode_tokens_per_sec")}
                   for r in rs_] for k, rs_ in runs.items()}
    return {"lanes_off": {"bitwise_plain": bitwise, "turns": summary},
            "mixed": {k: v for k, v in mix.items() if k != "outputs"},
            "salted_domains": salts, "swaps": swaps, "allocator": audit,
            "lanes_gb": round(ten.adapter_pool.nbytes() / 2 ** 30, 3),
            "compile_cache": st["compile_cache"],
            "tenancy": st["tenancy"], "launches": mix["launches"]}


def phase_serve_tenancy(model) -> dict:
    """serve_paged's Llama-2 7B and engine, with 4 adapter lanes of rank
    16 and the JSON grammar (eos 2): serve_paged's 12 requests with lanes
    off against the plain engine, then mixed over the tenants; salted
    prefix domains; a hot swap and an unload mid-flight.  Returns the
    mixed run's launches."""
    reqs = make_requests(model.config.vocab_size, 12, 512, PAGED_TAILS,
                         seed=0)
    res = run_serve_tenancy(model, reqs, 64, eos=2, kv_layout="paged",
                            block_size=16, min_bucket=16, num_slots=8)
    for name in ("paged_decode", "paged_prefill"):
        if res["launches"][name] < 1:
            raise AssertionError(f"serve_tenancy did not run {name}: "
                                 f"{res['launches']}")
    emit("serve_tenancy", model="llama2-7b", dtype="bfloat16",
         adapters=TENANCY_ADAPTERS, init_scale=TENANCY_SCALE,
         grammar="JsonArrayGrammar(eos_token_id=2)", **res)
    return res["launches"]


def drive_tenancy_parity(model, layout: str, draft, eos: int,
                         **engine_kw) -> dict:
    """f32 tenancy on one engine geometry (2 slots): the lanes-off streams
    against a plain engine's; a speculating tenancy engine (``draft``,
    k 3) against the plain tenancy engine's greedy streams for base,
    ``t1`` and json; a low ``t1`` request preempted by a high one, against
    its stream alone; ``json`` and ``t1`` requests while programs fail
    before and after they ran, against their streams alone; a journaled
    engine dropped after 2 tokens and recovered, against the same
    requests served uninterrupted on the recovering engine from a cold
    prefix cache.  Each reference is served twice and the second kept: it
    takes the prefix hits the checked run takes (paged), so both prefill
    alike.  Returns what each gave and what it should have."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (
        Engine, RequestJournal, SamplingParams, SpecConfig,
    )

    kw = dict(kv_layout=layout, num_slots=2, **engine_kw)
    vocab = model.config.vocab_size
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, vocab, (n,)).tolist() for n in (40, 70, 23)]
    greedy = SamplingParams()
    json_len = 2 + 3 * 3                     # JsonArrayGrammar's max_tokens

    def one(eng, prompt, tenant, **req):
        r = eng.add_request(prompt, sampling=tenant_law(tenant, greedy),
                            max_new_tokens=json_len if tenant == "json"
                            else 12, **req)
        eng.run()
        return r

    def streams(eng):
        for _ in range(2):
            out = {t: [one(eng, p, t).output_ids for p in prompts]
                   for t in (None, "t1", "json")}
        return out

    out = {}
    kernels.reset_launches()
    plain = Engine(model, **kw)
    plain.warmup()
    ten = tenancy_engine(model, eos, max_preemptions=2,
                         priority_aging_s=30, **kw)
    alone = streams(ten)
    for _ in range(2):
        base = [one(plain, p, None).output_ids for p in prompts]
    out["lanes_off"] = (base, alone[None])
    spec = tenancy_engine(model, eos, speculation=SpecConfig(
        draft_model=draft, k=3), **kw)
    out["spec"] = (streams(spec), alone)
    out["spec_rounds"] = spec.stats()["speculation"]["rounds"]
    del spec, plain
    # preemption: two low t1 requests running, a high base one arrives
    lo = [ten.add_request(p, max_new_tokens=12, priority="low",
                          sampling=tenant_law("t1", greedy))
          for p in prompts[:2]]
    ten.step()
    ten.step()
    hi = ten.add_request(prompts[2], max_new_tokens=4, priority="high")
    ten.run()
    out["preempt"] = ([r.output_ids for r in lo], alone["t1"][:2])
    out["preempted"] = [r.preemptions for r in lo] + [hi.state]
    # programs failing before and after they ran, json and t1 in flight
    run, calls = ten.programs.run, {}
    faults = {("prefill", 2): "after", ("decode", 2): "before",
              ("decode", 5): "after"}

    def flaky(key, body, *inputs):
        calls[key[0]] = calls.get(key[0], 0) + 1
        when = faults.get((key[0], calls[key[0]]))
        if when == "before":
            raise RuntimeError(f"injected fault before {key}")
        res = run(key, body, *inputs)
        if when == "after":
            raise RuntimeError(f"injected fault after {key}")
        return res

    before = ten.stats()["failures"]["step_retries"]
    ten.programs.run = flaky
    try:
        rj = ten.add_request(prompts[0], max_new_tokens=json_len,
                             sampling=tenant_law("json", greedy))
        rt = ten.add_request(prompts[1], max_new_tokens=12,
                             sampling=tenant_law("t1", greedy))
        ten.run()
    finally:
        del ten.programs.run
    out["retry"] = ([rj.output_ids, rt.output_ids],
                    [alone["json"][0], alone["t1"][1]])
    out["retries"] = ten.stats()["failures"]["step_retries"] - before
    out["after_warmup"] = ten.stats()["compile_cache"]["after_warmup"]
    out["audit"] = (ten.cache.check_invariants() or "ok"
                    if layout == "paged" else "ok")
    del ten
    # a journaled engine dropped after 2 tokens, recovered by a new one
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "journal")
        crashed = tenancy_engine(model, eos, journal=RequestJournal(path),
                                 **kw)
        reqs = [crashed.add_request(prompts[1], max_new_tokens=12,
                                    sampling=tenant_law("t1", greedy)),
                crashed.add_request(prompts[0], max_new_tokens=json_len,
                                    sampling=tenant_law("json", greedy))]
        while any(len(r.output_ids) < 2 for r in reqs):
            crashed.step()
        del reqs, crashed
        rec = tenancy_engine(model, eos, journal=RequestJournal(path), **kw)
        info = rec.recover()
        rec.run()
        if rec.prefix_cache is not None:
            rec.prefix_cache.clear()
        out["recovery"] = ([r.output_ids for r in info["requests"]],
                           [one(rec, prompts[1], "t1").output_ids,
                            one(rec, prompts[0], "json").output_ids])
        out["recovered"] = (info["replayed"], len(info["invalid"]),
                            rec.journal.audit()["pending"])
        out["after_warmup"] += rec.stats()["compile_cache"]["after_warmup"]
        rec.journal.close()
        del rec
    out["launches"] = kernels.launch_counts()
    return out


def check_tenancy_parity(res: dict, label: str) -> None:
    problems = [f"{k}: {res[k][0]} != {res[k][1]}"
                for k in ("lanes_off", "spec", "preempt", "retry",
                          "recovery") if res[k][0] != res[k][1]]
    if res["spec_rounds"] < 1:
        problems.append("no speculative round ran")
    if res["preempted"][-1] != "finished" or not any(res["preempted"][:2]):
        problems.append(f"preemptions {res['preempted']}")
    if res["retries"] != 3:
        problems.append(f"{res['retries']} retries, want 3")
    if res["recovered"] != (2, 0, 0):
        problems.append(f"recovery (replayed, invalid, pending) "
                        f"{res['recovered']}")
    if res["after_warmup"] != 0 or res["audit"] != "ok":
        problems.append(f"after warmup {res['after_warmup']}, pool "
                        f"{res['audit']}")
    if problems:
        raise AssertionError(f"tenancy_parity ({label}): "
                             + "; ".join(problems))


def phase_tenancy_parity() -> None:
    """f32, 2 layers, Llama-2 7B's and GPT-2 345M's widths, paged and
    contiguous: ``drive_tenancy_parity`` with an independent 1-layer
    draft of the same width."""
    for label, build in parity_models():
        model = build()
        cfg = model.config
        dgen = torch.Generator(device="cuda").manual_seed(2)
        draft = type(model)(dataclasses.replace(cfg, num_hidden_layers=1),
                            device="cuda", dtype=torch.float32,
                            generator=dgen).eval()
        for layout in ("paged", "contiguous"):
            res = drive_tenancy_parity(model, layout, draft, eos=2,
                                       max_seq=256, min_bucket=16,
                                       block_size=16)
            check_tenancy_parity(res, f"{label}, {layout}")
            want = ("paged_decode", "paged_prefill") if layout == "paged" \
                else ("flash_fwd",)
            if any(res["launches"][k] < 1 for k in want):
                raise AssertionError(f"tenancy_parity ({label}, {layout}) "
                                     f"did not launch {want}: "
                                     f"{res['launches']}")
            emit("tenancy_parity", model=label, dtype="float32",
                 layout=layout, identical=True,
                 spec_rounds=res["spec_rounds"],
                 preempted=res["preempted"], retries=res["retries"],
                 recovered=res["recovered"], launches=res["launches"])
        del model, draft
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 19: resilience ------------------------------------------------------

#: serve_resilience's engines: serve_paged's (paged, block 16, buckets
#: from 16, 8 slots); at max_seq 2048 for the chaos traffic and the
#: arming cost, at max_seq 256 for the watchdog and sanitizer engines
RESILIENCE_ENGINE = dict(kv_layout="paged", block_size=16, min_bucket=16,
                         num_slots=8)
#: (a)'s environment: decode call #2 fails once, callback call #3 raises
RESILIENCE_CHAOS = "serving.decode@2,serving.stream_cb@3"
#: the watchdog's deadline in (d) and (e), and the stalls it must catch
WATCHDOG_TIMEOUT_S = 0.5
STALL_S = 3.0
#: (g)'s four arming configurations: (name, step_timeout_s,
#: PADDLE_TPU_SANITIZE at construction)
ARMINGS = (("none", None, None), ("watchdog_5s", 5.0, None),
           ("sanitize", None, "1"), ("sanitize_strict", None, "strict"))


def _with_env(name: str, value, build):
    """``build()`` with ``os.environ[name]`` set to ``value`` (None: unset)
    for the construction only."""
    saved = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        return build()
    finally:
        os.environ.pop(name, None)
        if saved is not None:
            os.environ[name] = saved


def stream_all(engine, requests, max_new_tokens: int) -> tuple:
    """Serve ``requests`` on ``engine`` with a stream callback; returns
    the handles and each request's streamed tokens."""
    streamed = {}

    def cb(tok, req):
        streamed.setdefault(req.request_id, []).append(tok)

    reqs = [engine.add_request(p, sampling=s, max_new_tokens=max_new_tokens,
                               stream_cb=cb) for p, s in requests]
    engine.run()
    return reqs, [streamed.get(r.request_id, []) for r in reqs]


def served_alone(engine, request, max_new_tokens: int) -> list:
    """``request`` served alone from a cold prefix cache: a full prefill,
    so its stream compares with any other engine's built the same way."""
    engine.prefix_cache.clear()
    r = engine.add_request(request[0], sampling=request[1],
                           max_new_tokens=max_new_tokens)
    engine.run()
    if r.state != "finished":
        raise AssertionError(f"served alone: {r.state} ({r.error})")
    return r.output_ids


def finish(engine, phase: str) -> dict:
    """Shut ``engine`` down and check that its watchdog thread is joined
    and that no sync debug mode leaked out of its guard."""
    wd = engine._watchdog
    engine.shutdown(timeout_s=0.0)
    if engine._watchdog is not None or (wd is not None
                                        and wd._thread.is_alive()):
        raise AssertionError(f"{phase}: the watchdog thread outlived "
                             f"shutdown")
    if engine.device.type == "cuda" and torch.cuda.get_sync_debug_mode():
        raise AssertionError(f"{phase}: the sync debug mode leaked: "
                             f"{torch.cuda.get_sync_debug_mode()}")
    return {"state": engine.state, "watchdog_joined": True}


def chaos_checks(engine, requests, max_new_tokens: int, reference,
                 alone) -> dict:
    """(a)-(c) on ``engine`` (armed from ``RESILIENCE_CHAOS`` at its
    construction, not warmed).  ``reference`` are the streams of
    ``requests`` on an unfaulted engine built the same way, ``alone``
    that engine's stream of ``requests[-1]`` from a cold cache."""
    from paddle_tpu_torch.distributed.fault_tolerance import (
        ServingFaultPlan,
    )

    if not engine.fault_plan.armed:
        raise AssertionError("chaos: the plan was not read from "
                             "PADDLE_TPU_FT_SERVING_FAULTS")
    engine.warmup()
    misses = engine.metrics.compile_misses
    reqs, streamed = stream_all(engine, requests, max_new_tokens)
    st = engine.stats()
    failed = [i for i, r in enumerate(reqs) if r.state != "finished"]
    # the first tokens are emitted in admission order: callback call #3
    # is the third request's first token
    if failed != [2] or not reqs[2].error.startswith(
            "stream_cb raised: InjectedFault: injected fault: "
            "serving.stream_cb call #3"):
        raise AssertionError(f"chaos: failed {failed}: "
                             f"{[r.error for r in reqs]}")
    for i, r in enumerate(reqs):
        if i != 2 and (r.output_ids != reference[i]
                       or streamed[i] != r.output_ids):
            raise AssertionError(f"chaos: request {i}'s stream differs "
                                 f"from the unfaulted engine's")
    if st["failures"]["retries_by_point"] != {"serving.decode": 1}:
        raise AssertionError(f"chaos: retries {st['failures']}")
    if engine.metrics.compile_misses != misses or \
            st["compile_cache"]["after_warmup"] != 0:
        raise AssertionError(f"chaos: programs built after warmup: "
                             f"{st['compile_cache']}")
    chaos = {"failed": failed, "error": reqs[2].error,
             "retries_by_point": st["failures"]["retries_by_point"],
             "step_failures": st["failures"]["step_failures"],
             "callback_errors": st["failures"]["callback_errors"],
             "streams_equal_unfaulted": len(reqs) - 1,
             "allocator": pool_audit(engine, "serve_resilience (a)"),
             "compile_cache": st["compile_cache"]}
    # (b) both attempts of the next decode fail: that batch fails, the
    # next request is served with its unfaulted stream
    engine.fault_plan = ServingFaultPlan().add("serving.decode", 1, times=2)
    batch = [engine.add_request(p, sampling=s, max_new_tokens=max_new_tokens)
             for p, s in requests[:2]]
    engine.run()
    if any(r.state != "failed" or not r.error.startswith(
            "decode step failed after 1 retry") for r in batch):
        raise AssertionError(f"exhausted retries: "
                             f"{[(r.state, r.error) for r in batch]}")
    after = served_alone(engine, requests[-1], max_new_tokens)
    if after != alone:
        raise AssertionError("exhausted retries: the next request's stream "
                             "differs from the unfaulted engine's")
    exhausted = {"batch": [r.state for r in batch], "next_equal": True}
    # (c) a raising lookup, then one stalled past a 10 ms budget: misses
    errors0 = engine.metrics.prefix_lookup_errors
    engine.fault_plan = ServingFaultPlan().add("serving.prefix_lookup", 1)
    raised = served_alone(engine, requests[-1], max_new_tokens)
    engine.fault_plan = ServingFaultPlan().add("serving.prefix_lookup", 1,
                                               stall_s=0.05)
    engine.prefix_lookup_timeout_s = 0.01
    r = engine.add_request(requests[-1][0], sampling=requests[-1][1],
                           max_new_tokens=max_new_tokens)
    engine.run()                         # its blocks are cached: a miss all
    engine.prefix_lookup_timeout_s = 0.25
    engine.fault_plan = ServingFaultPlan()
    st = engine.stats()
    lookup = {"errors": engine.metrics.prefix_lookup_errors - errors0,
              "streams_equal": raised == r.output_ids == alone,
              "kv_block_invariants": st["health"]["kv_block_invariants"]}
    if lookup != {"errors": 2, "streams_equal": True,
                  "kv_block_invariants": "ok"}:
        raise AssertionError(f"prefix lookup: {lookup}")
    lookup["allocator"] = pool_audit(engine, "serve_resilience (c)")
    return {"chaos": chaos, "exhausted": exhausted, "prefix_lookup": lookup}


def sleep_cycles(seconds: float) -> int:
    """``torch.cuda._sleep`` cycles that hold the card ``seconds``,
    calibrated with CUDA events on a 50 M-cycle sleep."""
    n = SPIN_CYCLES
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return int(n * seconds * 1e3 / start.elapsed_time(end))


def watchdog_stall(engine, prompt, where: str) -> dict:
    """(d) or (e): ``engine`` (``step_timeout_s`` set; for ``"host"`` its
    plan stalls decode call #3) serves ``prompt``.  For ``"device"`` a
    wrapper of ``programs.run`` enqueues ``STALL_S`` of
    ``torch.cuda._sleep`` after decode replay #3: the replay returns at
    once, and the watchdog must fire while the host waits for the
    tokens.  The engine must turn and stay ``unhealthy``, and shutdown
    must cancel the request, free its slot and join the thread."""
    from paddle_tpu_torch.serving import EngineStopped

    engine.warmup()
    stalled_at = []
    if where == "device":
        cycles, run, calls = sleep_cycles(STALL_S), engine.programs.run, [0]

        def stalls(key, body, *inputs):
            out = run(key, body, *inputs)
            if key[0] == "decode":
                calls[0] += 1
                if calls[0] == 3:
                    stalled_at.append(time.time())
                    torch.cuda._sleep(cycles)
            return out

        engine.programs.run = stalls
    r = engine.add_request(prompt, max_new_tokens=16)
    t0 = time.perf_counter()
    try:
        engine.run()
        raise AssertionError(f"watchdog ({where} stall): did not fire: "
                             f"{engine.health()}")
    except EngineStopped:
        pass                             # the expected outcome
    wall = time.perf_counter() - t0
    if where == "device":
        del engine.programs.run
    health = engine.health()
    if engine.state != "unhealthy" or "watchdog" not in health["reason"] \
            or health["watchdog_armed"] is not False \
            or not engine._watchdog.fired:
        raise AssertionError(f"watchdog ({where} stall): {health}")
    slots = engine.num_slots
    out = {"state": engine.state, "reason": health["reason"],
           "watchdog_armed": health["watchdog_armed"],
           "wall_s": round(wall, 3), "tokens_before": len(r.output_ids),
           **finish(engine, f"watchdog ({where} stall)")}
    if stalled_at:
        # the flight dump's wall time is the watchdog's firing
        out["fired_after_s"] = round(
            engine.flight.dumps[-1]["wall_time"] - stalled_at[0], 3)
    if r.state != "cancelled" or len(engine.free_slots) != slots or \
            engine.state != "unhealthy":
        raise AssertionError(f"watchdog ({where} stall): after shutdown "
                             f"{r.state}, {len(engine.free_slots)} free, "
                             f"{engine.state}")
    out["request"] = r.state
    return out


def sanitized_run(engine, requests, max_new_tokens: int) -> dict:
    """(f): a strict sanitized engine serves ``requests``: 0.0 host
    transfers per decode step, no guard violation, every decode step (or
    round) of this run counted."""
    engine.warmup()
    steps0 = engine.metrics.decode_steps
    counted0 = engine.sanitizer.decode_steps
    reqs = [engine.add_request(p, sampling=s, max_new_tokens=max_new_tokens)
            for p, s in requests]
    engine.run()
    rep = engine.stats()["sanitizer"]
    steps = engine.metrics.decode_steps - steps0
    counted = rep["decode_steps"] - counted0
    if not rep["strict"] or rep["per_decode_step"] != 0.0 or \
            rep["guard_violations"] != 0 or counted != steps or \
            any(r.state != "finished" for r in reqs):
        raise AssertionError(f"sanitizer: {rep}, {counted} of {steps} "
                             f"steps counted, {[r.state for r in reqs]}")
    return {**rep, "steps_run": steps}


def sanitizer_control(engine, request, max_new_tokens: int) -> dict:
    """(f)'s negative control on a strict sanitized engine: a wrapper of
    ``programs.run`` reads the decode replay's output on the host
    (``.item()``) inside the dispatch.  It must be counted and attributed
    to this file's line; on the card the strict guard turns it into an
    error that fails the batch after its retry (``guard_violations``
    1)."""
    run, line = engine.programs.run, []

    def reads(key, body, *inputs):
        out = run(key, body, *inputs)
        if key[0] == "decode":
            line.append(sys._getframe().f_lineno + 1)
            out[0].item()                # a sync inside the window
        return out

    before = dict(engine.sanitizer.report())
    engine.programs.run = reads
    r = engine.add_request(request[0], sampling=request[1],
                           max_new_tokens=max_new_tokens)
    engine.run()
    del engine.programs.run
    rep = engine.sanitizer.report()
    site = f"chip_smoke.py:{line[0]}"
    sites = [s for s in rep["by_site"] if s.endswith(site)]
    counted = rep["host_transfers"] - before["host_transfers"]
    out = {"request": r.state, "error": r.error, "counted": counted,
           "by_site": rep["by_site"],
           "guard_violations": rep["guard_violations"]}
    if engine.device.type == "cuda":
        # the read fails both attempts of the first decode: the batch fails
        ok = (r.state == "failed" and counted == 2
              and "called a synchronizing CUDA operation" in r.error
              and rep["guard_violations"] == 1)
    else:                                # no guard off the card: counted
        ok = r.state == "finished" and counted == len(r.output_ids) - 1
    if not ok or len(sites) != 1:
        raise AssertionError(f"sanitizer control: {out}")
    return out


def arming_cost(engines: dict, requests, max_new_tokens: int,
                rounds: int) -> dict:
    """(g): ``engines`` (name → a warmed engine built under that arming)
    serve ``requests`` in turns (ABCD DCBA, ``rounds`` times), each run
    from a cold prefix cache (``timed_run``); per arming the medians and
    quartiles of ITL p50, tokens/s and TTFT p50."""
    names = list(engines)
    runs = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            res = timed_run(engines[n], requests, max_new_tokens)
            runs[n].append({"itl_p50_ms": res["itl"]["p50_ms"],
                            "tokens_per_s": res["decode_tokens_per_sec"],
                            "ttft_p50_ms": res["ttft_p50_ms"]})

    return {n: {m: _quartiles([r[m] for r in rs]) for m in rs[0]}
            for n, rs in runs.items()}


def run_serve_resilience(model, draft, requests, max_new_tokens: int,
                         timing_requests, timing_tokens: int, rounds: int,
                         big: dict, small: dict) -> dict:
    """serve_resilience over ``model`` (engines: ``big`` for (a)-(c) and
    (g), ``small`` for (d)-(f)); on the card also (e) and the strict
    guard of (f)'s control.  Returns the figures."""
    from paddle_tpu_torch.distributed.fault_tolerance import (
        ENV_SERVING_FAULTS, ServingFaultPlan,
    )
    from paddle_tpu_torch.serving import Engine, SpecConfig

    cuda = next(model.parameters()).is_cuda

    def collect():
        # a dropped engine's pool and graphs go before the next is built
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    plain = Engine(model, **big)
    plain.warmup()
    reference = [r.output_ids for r in stream_all(plain, requests,
                                                  max_new_tokens)[0]]
    alone = served_alone(plain, requests[-1], max_new_tokens)
    chaotic = _with_env(ENV_SERVING_FAULTS, RESILIENCE_CHAOS,
                        lambda: Engine(model, **big))
    out = chaos_checks(chaotic, requests, max_new_tokens, reference, alone)
    finish(chaotic, "serve_resilience (a)-(c)")
    del chaotic
    collect()
    prompt = requests[0][0][:100]
    out["watchdog_host"] = watchdog_stall(Engine(
        model, **small, step_timeout_s=WATCHDOG_TIMEOUT_S,
        fault_plan=ServingFaultPlan().add("serving.decode", 3,
                                          stall_s=STALL_S)), prompt, "host")
    if cuda:
        out["watchdog_device"] = watchdog_stall(Engine(
            model, **small, step_timeout_s=WATCHDOG_TIMEOUT_S), prompt,
            "device")
    collect()
    short = [(p[:200], s) for p, s in requests]
    sanitized = {}
    for label, kw in (("plain", {}), (f"spec k={SPEC_K}", {
            "speculation": SpecConfig(draft_model=draft, k=SPEC_K)})):
        eng = _with_env("PADDLE_TPU_SANITIZE", "strict",
                        lambda: Engine(model, **small, **kw))
        sanitized[label] = sanitized_run(eng, short, max_new_tokens)
        if label == "plain":
            sanitized["control"] = sanitizer_control(eng, short[0],
                                                     max_new_tokens)
        finish(eng, f"sanitizer ({label})")
        del eng
        collect()
    out["sanitizer"] = sanitized
    engines = {"none": plain}
    for name, timeout, sanitize in ARMINGS[1:]:
        engines[name] = _with_env(
            "PADDLE_TPU_SANITIZE", sanitize,
            lambda: Engine(model, **big, step_timeout_s=timeout))
        engines[name].warmup()
    out["arming_cost"] = arming_cost(engines, timing_requests,
                                     timing_tokens, rounds)
    reports = {n: e.stats()["sanitizer"] for n, e in engines.items()
               if e.sanitizer is not None}
    if any(r["per_decode_step"] != 0.0 or r["guard_violations"]
           for r in reports.values()):
        raise AssertionError(f"arming cost: sanitizer {reports}")
    out["arming_cost"]["sanitizer_reports"] = reports
    for n, e in engines.items():
        finish(e, f"arming cost ({n})")
    del plain
    engines.clear()
    collect()
    return out


def phase_serve_resilience(model) -> dict:
    """serve_paged's Llama-2 7B on paged engines of 8 slots, armed: (a) a
    chaos plan from the environment, (b) exhausted retries, (c) a raising
    and a stalled prefix lookup, (d) the watchdog on a host stall, (e) on
    a device stall, (f) strict sanitized engines, plain and speculating
    (the llama-68m-shaped draft), with a negative control, (g) what
    arming costs.  Returns the K4/K5 launches of the phase."""
    from paddle_tpu_torch.ops import kernels

    vocab = model.config.vocab_size
    draft = spec_draft_68m("cuda", torch.bfloat16)
    kernels.reset_launches()
    res = run_serve_resilience(
        model, draft, make_requests(vocab, 4, 128, [64, 300, 17, 200],
                                    seed=11), 32,
        make_requests(vocab, 12, 512, PAGED_TAILS, seed=0), 64, rounds=3,
        big=dict(RESILIENCE_ENGINE, max_seq=2048),
        small=dict(RESILIENCE_ENGINE, max_seq=256))
    launches = kernels.launch_counts()
    for name in ("paged_decode", "paged_prefill"):
        if launches[name] < 1:
            raise AssertionError(f"serve_resilience did not run {name}: "
                                 f"{launches}")
    del draft
    emit("serve_resilience", model="llama2-7b", dtype="bfloat16",
         chaos_env=RESILIENCE_CHAOS, watchdog_timeout_s=WATCHDOG_TIMEOUT_S,
         stall_s=STALL_S, launches=launches, **res)
    return launches


# -- phase 20: serve_fleet ---------------------------------------------------

#: serve_fleet's fleet: two replicas of serve_paged's engine
FLEET_REPLICAS = dict(num_replicas=2, eject_after_failures=2,
                      max_redispatch=2)
#: (b): replica 1's decode call, counted from a cycle's start, whose two
#: attempts fail
FLEET_FAULT_AT = 20
FAILOVER_CYCLES = 3
#: (b): how far memory_allocated() may be from its level before the first
#: fault once a rebuild is done
MEMORY_SLACK = 256 * 2 ** 20


def _engines(target) -> list:
    return ([rep.engine for rep in target.replicas]
            if hasattr(target, "replicas") else [target])


def prime(target, system, clear: bool = True) -> None:
    """Every engine of ``target`` (a fleet or an engine) holding the
    system prompt's blocks from one prefill of the system prompt alone
    (from a cold prefix cache unless ``clear`` is False): each later
    request of the traffic then prefills its tail over the same prefix
    K/V on any replica, so its stream does not depend on where it runs or
    what ran before."""
    if clear:
        for eng in _engines(target):
            eng.prefix_cache.clear()
    if hasattr(target, "replicas"):
        for k in range(len(target.replicas)):
            target.submit(system, max_new_tokens=1, replica=k)
    else:
        target.add_request(system, max_new_tokens=1)
    target.run()


def serve_waves(target, requests, max_new_tokens: int, *, system=None,
                clear: bool = True, pin_first: bool = False) -> dict:
    """Serve ``requests`` on ``target`` (a warmed fleet or engine) in two
    waves: the second goes in once every request of the first has its
    first token.  From a cold prefix cache (unless ``clear`` is False),
    primed with ``system`` when given (:func:`prime`); ``pin_first`` pins
    the first request to replica 1.  Returns the handles, each attempt's
    streamed tokens, each request's ``done_cb`` calls, and the run's
    figures: TTFT from submit to the first streamed token, the engines'
    decode-step ITL, the client ITL (gaps between a stream's tokens),
    decode tokens/s (decode tokens over the summed decode-step time of
    every engine) and the generated tokens over the wall time."""
    fleet = hasattr(target, "replicas")
    engines = _engines(target)
    if system is not None:
        prime(target, system, clear)
    elif clear:
        for eng in engines:
            eng.prefix_cache.clear()
    for eng in engines:
        eng.metrics.itl_s.clear()
    tok0 = sum(e.metrics.decode_tokens for e in engines)
    time0 = sum(e.metrics.decode_time_s for e in engines)
    stamps, streamed, submitted, done = {}, {}, {}, []

    def cb(tok, req):
        stamps.setdefault(req.request_id, []).append(time.perf_counter())
        key = (req.request_id, getattr(req, "redispatches", 0))
        streamed.setdefault(key, []).append(tok)

    def submit(i, prompt, law):
        kw = dict(sampling=law, max_new_tokens=max_new_tokens, stream_cb=cb)
        if fleet:
            r = target.submit(prompt, **kw,
                              replica=1 if pin_first and i == 0 else None,
                              done_cb=lambda q: done.append(q.request_id))
        else:
            r = target.add_request(prompt, **kw)
        submitted[r.request_id] = time.perf_counter()
        return r

    half = len(requests) // 2
    t0 = time.perf_counter()
    first = [submit(i, p, s) for i, (p, s) in enumerate(requests[:half])]
    while not all(r.output_ids or r.done for r in first):
        target.step()
    second = [submit(half + i, p, s)
              for i, (p, s) in enumerate(requests[half:])]
    target.run()
    wall = time.perf_counter() - t0
    reqs = first + second
    ttft = [stamps[r.request_id][0] - submitted[r.request_id]
            for r in reqs if r.request_id in stamps]
    gaps = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    tokens = sum(e.metrics.decode_tokens for e in engines) - tok0
    step_s = sum(e.metrics.decode_time_s for e in engines) - time0
    return {"reqs": reqs, "streamed": streamed, "done": done,
            "ttft_s": ttft, "ttft_p50_ms": _percentiles(ttft)["p50_ms"],
            "itl": _percentiles([x for e in engines
                                 for x in e.metrics.itl_s]),
            "client_itl": _percentiles(gaps),
            "decode_tokens_per_sec": round(tokens / max(step_s, 1e-9), 2),
            "tokens_per_sec_wall": round(
                sum(len(r.output_ids) for r in reqs) / wall, 2)}


def _wrap_timed(obj, name: str, spent: list, cuda: bool = False) -> None:
    """Append each call's host seconds of ``obj.<name>`` to ``spent``
    (device work synchronised when ``cuda``); undo with ``delattr``."""
    fn = getattr(obj, name)

    def timed(*args):
        t = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    setattr(obj, name, timed)


def fleet_dispatch(fleet, engine, requests, max_new_tokens: int,
                   rounds: int) -> dict:
    """(a): the fleet and a bare engine of the same kwargs serve the same
    traffic in turns (FEEF, ``rounds`` times), each run from a cold prefix
    cache; the first fleet run also gives the dispatch figures (dispatches
    per replica, affinity hits and tokens, the TTFT of the second wave,
    routed by affinity, against the first's) and the host time of each
    supervision pass.  Per target, the medians and quartiles of each
    run's ITL p50, client ITL p50, TTFT p50 and tokens/s."""
    runs = {"fleet": [], "engine": []}
    first, spent = None, []
    half = len(requests) // 2
    for _ in range(rounds):
        for name in ("fleet", "engine", "engine", "fleet"):
            target = fleet if name == "fleet" else engine
            probe = first is None and name == "fleet"
            if probe:
                d0 = fleet.metrics.snapshot()["dispatch"]
                _wrap_timed(fleet, "_supervise", spent)
            res = serve_waves(target, requests, max_new_tokens)
            if any(q.state != "finished" or len(q.output_ids) !=
                   max_new_tokens for q in res["reqs"]):
                raise AssertionError(f"serve_fleet (a) {name}: "
                                     f"{[q.state for q in res['reqs']]}")
            if probe:
                del fleet._supervise
                d1 = fleet.metrics.snapshot()["dispatch"]
                per = {}
                for q in res["reqs"]:
                    per[q.replica_history[0]] = \
                        per.get(q.replica_history[0], 0) + 1
                first = {
                    "dispatches": per,
                    "affinity_hits": d1["affinity_hits"]
                    - d0["affinity_hits"],
                    "affinity_hit_tokens": d1["affinity_hit_tokens"]
                    - d0["affinity_hit_tokens"],
                    "ttft_p50_ms_wave1": _percentiles(
                        res["ttft_s"][:half])["p50_ms"],
                    "ttft_p50_ms_wave2_hits": _percentiles(
                        res["ttft_s"][half:])["p50_ms"],
                    "supervise_pass_ms": _percentiles(spent),
                    "fleet_steps": len(spent)}
            runs[name].append({
                "itl_p50_ms": res["itl"]["p50_ms"],
                "client_itl_p50_ms": res["client_itl"]["p50_ms"],
                "ttft_p50_ms": res["ttft_p50_ms"],
                "decode_tokens_per_sec": res["decode_tokens_per_sec"],
                "tokens_per_sec_wall": res["tokens_per_sec_wall"]})
    if first["affinity_hits"] != len(requests) - half or \
            len(first["dispatches"]) != len(fleet.replicas):
        raise AssertionError(f"serve_fleet (a): the first wave did not "
                             f"spread or the second did not route by "
                             f"affinity: {first}")
    return {**first, "in_turns": {
        n: {m: _quartiles([x[m] for x in rs]) for m in rs[0]}
        for n, rs in runs.items()}}


def failover(fleet, requests, max_new_tokens: int, system, reference,
             cycles: int, fault_at: int) -> dict:
    """(b): ``cycles`` times, replica 1's decode fails both its attempts
    ``fault_at`` decode calls into the cycle, while the fleet serves
    primed traffic with the first request pinned to replica 1 (all of
    ``requests`` in the first cycle, the first 4 after).  Each request
    must end once, finished, with its stream of ``reference``;
    redispatched streams restart at token 0, marked; replica 1 is ejected
    and rebuilt once a cycle; the survivor and the rebuilt replica build
    no program past warmup; on the card ``memory_allocated()`` is back
    within ``MEMORY_SLACK`` of its level before the first fault.  Each
    cycle's recovery is split into the ejection (export, shutdown, the
    device memory freed), the model copy, the engine build and the
    warmup."""
    cuda = next(fleet.model.parameters()).is_cuda
    base = torch.cuda.memory_allocated() if cuda else 0
    plan = fleet.fault_plan
    out = []
    for c in range(cycles):
        reqs_c = requests if c == 0 else requests[:4]
        plan.add("serving.r1.decode",
                 plan.calls("serving.r1.decode") + fault_at, times=2)
        m = fleet.metrics
        before = (m.ejections, m.rebuilds, m.redispatches,
                  m.duplicate_terminals)
        times = {"clone": [], "make": [], "rebuild": []}
        for key, name in (("clone", "_replica_model"),
                          ("make", "_make_engine"),
                          ("rebuild", "_rebuild")):
            _wrap_timed(fleet, name, times[key], cuda)
        res = serve_waves(fleet, reqs_c, max_new_tokens, system=system,
                          pin_first=True)
        for name in ("_replica_model", "_make_engine", "_rebuild"):
            delattr(fleet, name)
        reqs = res["reqs"]
        moved = [q for q in reqs if q.redispatches]
        recovery = m.last_recovery_s or 0.0
        clone, make, rebuild = (times[k][-1] if times[k] else 0.0
                                for k in ("clone", "make", "rebuild"))
        row = {"states": sorted({q.state for q in reqs}),
               "ejections": m.ejections - before[0],
               "rebuilds": m.rebuilds - before[1],
               "redispatches": m.redispatches - before[2],
               "duplicate_terminals": m.duplicate_terminals - before[3],
               "done_cb_once": sorted(res["done"]) == sorted(
                   q.request_id for q in reqs),
               "redispatched_requests": len(moved),
               "restarts_marked": all(
                   q.redispatched and res["streamed"].get(
                       (q.request_id, q.redispatches)) == q.output_ids
                   for q in moved),
               "streams_equal_reference": sum(
                   q.output_ids == ref for q, ref in zip(reqs, reference)),
               "requests": len(reqs),
               "after_warmup": [
                   rep.engine.stats()["compile_cache"]["after_warmup"]
                   for rep in fleet.replicas],
               "recovery_ms": round(recovery * 1e3, 3),
               "eject_ms": round((recovery - rebuild) * 1e3, 3),
               "clone_ms": round(clone * 1e3, 3),
               "build_ms": round((make - clone) * 1e3, 3),
               "warmup_ms": round((rebuild - make) * 1e3, 3)}
        if cuda:
            row["memory_allocated_delta_mib"] = round(
                (torch.cuda.memory_allocated() - base) / 2 ** 20, 3)
        if not (row["states"] == ["finished"] and row["ejections"] == 1
                and row["rebuilds"] == 1 and row["redispatches"] >= 1
                and moved and row["restarts_marked"]
                and row["done_cb_once"]
                and row["duplicate_terminals"] == 0
                and row["streams_equal_reference"] == len(reqs)
                and row["after_warmup"] == [0, 0]
                and fleet.replicas[1].state == "active"
                and (not cuda or abs(torch.cuda.memory_allocated() - base)
                     <= MEMORY_SLACK)):
            raise AssertionError(f"serve_fleet (b) cycle {c}: {row}")
        out.append(row)
    return {"cycles": out,
            "memory_allocated_before_gib": round(base / 2 ** 30, 3)}


def rolling_update(fleet, new_model, requests, max_new_tokens: int,
                   system, max_drain_steps: int) -> dict:
    """(c): streams live on both replicas while ``fleet.update_weights``
    rolls ``new_model``'s weights through them (replica 1's requests ask
    for twice the tokens, so its streams are still live when replica 0,
    drained first, takes the weights).  No program is built on
    any replica and no parameter moves (the write raises if one does);
    the in-flight requests finish at version 0; every replica's prefix
    epoch is 1, and its first admission after the roll (the system
    prompt, :func:`prime` without clearing) hits no block from before it.
    Returns the roll ms, the stall (the worst gap between two tokens of a
    stream in flight across the roll) and the handles of ``requests``
    served after the roll."""
    misses = [rep.engine.metrics.compile_misses for rep in fleet.replicas]
    for eng in _engines(fleet):
        eng.prefix_cache.clear()
    stamps = {}

    def cb(tok, req):
        stamps.setdefault(req.request_id, []).append(time.perf_counter())

    half = len(requests) // 2
    live = [fleet.submit(p, sampling=s, stream_cb=cb,
                         max_new_tokens=max_new_tokens * (1 + (i >= half)),
                         replica=int(i >= half))
            for i, (p, s) in enumerate(requests)]
    for _ in range(2):
        fleet.step()
    t_roll = time.perf_counter()
    roll = fleet.update_weights(new_model.state_dict(),
                                max_drain_steps=max_drain_steps)
    t_end = time.perf_counter()
    fleet.run()
    stall = max((b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])
                 if b >= t_roll and a <= t_end), default=0.0)
    hits0 = [rep.engine.prefix_cache.hit_tokens_total
             for rep in fleet.replicas]
    prime(fleet, system, clear=False)
    hits = [rep.engine.prefix_cache.hit_tokens_total - h
            for rep, h in zip(fleet.replicas, hits0)]
    post = serve_waves(fleet, requests, max_new_tokens, clear=False)
    out = {"roll_ms": roll["roll_ms"],
           "model_version": roll["model_version"],
           "replicas_updated": roll["replicas_updated"],
           "stall_ms": round(stall * 1e3, 3),
           "live_streams": len(stamps),
           "live": sorted({(r.state, r.model_version) for r in live}),
           "post": sorted({(r.state, r.model_version)
                           for r in post["reqs"]}),
           "epochs": [rep.engine.prefix_cache.epoch
                      for rep in fleet.replicas],
           "first_admission_hit_tokens": hits,
           "captures_added": [rep.engine.metrics.compile_misses - n
                              for rep, n in zip(fleet.replicas, misses)]}
    n = len(fleet.replicas)
    if (roll["replicas_updated"] != n or out["live"] != [("finished", 0)]
            or out["post"] != [("finished", 1)] or out["epochs"] != [1] * n
            or hits != [0] * n or out["captures_added"] != [0] * n
            or len(stamps) != len(requests)):
        raise AssertionError(f"serve_fleet (c): {out}")
    return out, post["reqs"]


def fleet_crash_recovery(make_fleet, requests, max_new_tokens: int,
                         root: str) -> dict:
    """(d): a fleet journaling into ``root`` (``fsync="rotate"``) serves
    ``requests`` and is dropped mid-decode, as a crash leaves it (no
    shutdown, no final record; what its engines hold on the device is
    freed).  A new fleet over the reopened journal recovers: every
    request replays once (the journal's audit shows no pending request
    and no duplicate terminal), each replay's stream begins with the
    tokens its client had before the crash, and equals the same request
    served uninterrupted (the same traffic on the new fleet from a cold
    prefix cache, dispatched the same way)."""
    from paddle_tpu_torch.serving import RequestJournal

    j = RequestJournal(root, fsync="rotate")
    f1 = make_fleet(j)
    f1.warmup()
    reqs = [f1.submit(p, sampling=s, max_new_tokens=max_new_tokens)
            for p, s in requests]
    while not all(len(r.output_ids) >= 2 for r in reqs):
        f1.step()
    before = [list(r.output_ids) for r in reqs]
    for rep in f1.replicas:
        rep.engine._release_device()
    cuda = next(f1.model.parameters()).is_cuda
    del f1, reqs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    j2 = RequestJournal(root, fsync="rotate")
    f2 = make_fleet(j2)
    f2.warmup()
    info = f2.recover()
    f2.run()
    audit = j2.audit()
    for rep in f2.replicas:
        rep.engine.prefix_cache.clear()
    again = [f2.submit(p, sampling=s, max_new_tokens=max_new_tokens)
             for p, s in requests]
    f2.run()
    replays = info["requests"]
    out = {"replayed": info["replayed"], "recovery_ms": info["recovery_ms"],
           "tokens_before_crash": [len(b) for b in before],
           "states": sorted({r.state for r in replays}),
           "recovered": all(r.recovered for r in replays),
           "pending": audit["pending"],
           "duplicate_terminals": audit["duplicate_terminals"],
           "prefix_kept": sum(r.output_ids[:len(b)] == b
                              for r, b in zip(replays, before)),
           "streams_equal_uninterrupted": sum(
               r.output_ids == a.output_ids
               for r, a in zip(replays, again))}
    f2.shutdown(timeout_s=0.0)
    for rep in f2.replicas:
        rep.engine._release_device()
    j.close()
    j2.close()
    n = len(requests)
    if not (out["replayed"] == n and out["states"] == ["finished"]
            and out["recovered"] and out["pending"] == 0
            and out["duplicate_terminals"] == 0 and out["prefix_kept"] == n
            and out["streams_equal_uninterrupted"] == n):
        raise AssertionError(f"serve_fleet (d): {out}")
    return out


def run_serve_fleet(model, build_new, requests, max_new_tokens: int, *,
                    system_len: int, rounds: int, cycles: int,
                    fault_at: int, engine: dict, root: str,
                    max_drain_steps: int = 2000) -> dict:
    """serve_fleet over the template ``model``: a weight-isolated
    2-replica fleet (``engine`` its replicas' kwargs) with a request
    tracer, through (a) dispatch and the router's cost beside a bare
    engine, (b) failover, (c) a rolling update to ``build_new()``'s
    weights (the template takes them) and (d) fleet crash recovery.
    Returns the figures."""
    from paddle_tpu_torch.distributed.fault_tolerance import (
        ServingFaultPlan,
    )
    from paddle_tpu_torch.serving import (
        Engine, Fleet, RequestTracer, validate_trace,
    )

    cuda = next(model.parameters()).is_cuda

    def collect():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def make_fleet(journal=None, tracer=None):
        return Fleet(model, **FLEET_REPLICAS, **engine,
                     fault_plan=ServingFaultPlan(), tracer=tracer,
                     journal=journal)

    system = requests[0][0][:system_len]
    tracer = RequestTracer()
    t0 = time.perf_counter()
    fleet = make_fleet(tracer=tracer)
    if not fleet.weights_isolated:
        raise AssertionError("serve_fleet: the fleet shares its weights")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet.warmup()
    out = {"fleet_build_s": round(build_s, 3),
           "fleet_warmup_s": round(time.perf_counter() - t0, 3)}
    bare = Engine(model, **engine)
    bare.warmup()
    out["dispatch"] = fleet_dispatch(fleet, bare, requests, max_new_tokens,
                                     rounds)
    del bare
    collect()
    ref = serve_waves(fleet, requests, max_new_tokens, system=system)
    reference = [r.output_ids for r in ref["reqs"]]
    out["failover"] = failover(fleet, requests, max_new_tokens, system,
                               reference, cycles, fault_at)
    if cuda:
        out["failover"]["max_memory_allocated_gib"] = round(
            torch.cuda.max_memory_allocated() / 2 ** 30, 3)
    new = build_new()
    out["roll"], post = rolling_update(fleet, new, requests[:4],
                                       max_new_tokens, system,
                                       max_drain_steps)
    del new
    collect()
    bare = Engine(model, **engine)       # the template took the new weights
    bare.warmup()
    alone = serve_waves(bare, requests[:4], max_new_tokens, system=system)
    equal = sum(a.output_ids == b.output_ids
                for a, b in zip(post, alone["reqs"]))
    out["roll"]["streams_equal_bare_engine"] = equal
    if equal != 4:
        raise AssertionError(f"serve_fleet (c): {equal} of 4 post-roll "
                             f"streams equal the bare engine's")
    del bare, alone
    problems = validate_trace(tracer)
    out["trace"] = {"events": len(tracer.events), "dropped": tracer.dropped,
                    "problems": problems[:5]}
    if problems:
        raise AssertionError(f"serve_fleet: trace chain {problems[:5]}")
    fleet.shutdown(timeout_s=0.0)
    for rep in fleet.replicas:
        rep.engine._release_device()
    del fleet
    collect()
    out["crash"] = fleet_crash_recovery(make_fleet, requests[:4],
                                        max_new_tokens, root)
    collect()
    return out


def phase_serve_fleet(model) -> dict:
    """serve_paged's Llama-2 7B as the template of a 2-replica fleet of
    serve_paged's engines at max_seq 2048: (a) dispatch and the router's
    cost beside a bare engine, (b) three failover cycles, (c) a rolling
    update to weights of seed 2, (d) fleet crash recovery.  Returns the
    K4/K5 launches of the phase."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import Engine

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as root:
        res = run_serve_fleet(
            model, lambda: Engine.resolve_model(
                "llama:llama2-7b", device="cuda", dtype=torch.bfloat16,
                seed=2),
            make_requests(model.config.vocab_size, 12, 512, PAGED_TAILS,
                          seed=0), 64, system_len=512, rounds=2,
            cycles=FAILOVER_CYCLES, fault_at=FLEET_FAULT_AT,
            engine=dict(kv_layout="paged", block_size=16, min_bucket=16,
                        num_slots=8, max_seq=2048), root=root)
    launches = kernels.launch_counts()
    for name in ("paged_decode", "paged_prefill"):
        if launches[name] < 1:
            raise AssertionError(f"serve_fleet did not run {name}: "
                                 f"{launches}")
    emit("serve_fleet", model="llama2-7b", dtype="bfloat16",
         replicas=FLEET_REPLICAS, fault_at=FLEET_FAULT_AT,
         max_memory_allocated_gib=round(
             torch.cuda.max_memory_allocated() / 2 ** 30, 3),
         launches=launches, **res)
    return launches

# -- phases 21, 22 and 23: float16 serving and the deployment path ----------

#: the f16 instances of K4/K5 the f16 engines must launch
F16_SERVE_KERNELS = ("paged_decode_f16", "paged_prefill_f16")


def count_nonfinite_logits(engine) -> torch.Tensor:
    """A device counter of the non-finite logits every step of ``engine``
    hands its sampler (prefill and decode).  Call it before ``warmup()``:
    the count is an op of each step's body, so each CUDA graph captures it
    and every replay adds to it."""
    bad = torch.zeros((), dtype=torch.int64, device=engine.device)
    sampler = engine.sampler

    def counted(fn, pos: int):
        def inner(*args, **kwargs):
            bad.add_((~torch.isfinite(args[pos])).sum())
            return fn(*args, **kwargs)
        return inner

    sampler.sample_slot = counted(sampler.sample_slot, 1)
    sampler.sample_all = counted(sampler.sample_all, 0)
    return bad


@torch.no_grad()
def first_nonfinite(model, prompt) -> str:
    """The first module of ``model``'s forward on ``prompt`` whose output
    holds a non-finite value, or ``""``: where an overflow starts."""
    found = []

    def hook(name):
        def fn(mod, args, out):
            if not found and isinstance(out, torch.Tensor) and \
                    out.is_floating_point() and \
                    not bool(torch.isfinite(out).all()):
                found.append(f"{name} ({type(mod).__name__})")
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.named_modules() if n]
    try:
        dev = next(model.parameters()).device
        model(torch.tensor([prompt], device=dev))
    finally:
        for h in handles:
            h.remove()
    return found[0] if found else ""


def run_serve_f16(engine, requests, max_new_tokens: int) -> dict:
    """``serve`` with the non-finite logits counted on the device; fails
    on any (naming the first module whose output overflowed, never
    clamping or rescaling), and on the card unless the f16 K4 and K5
    launched."""
    bad = count_nonfinite_logits(engine)
    res = serve(engine, requests, max_new_tokens)
    res["nonfinite_logits"] = int(bad.item())
    if res["nonfinite_logits"]:
        raise AssertionError(
            f"f16 serving: {res['nonfinite_logits']} non-finite logits; the "
            f"first module with a non-finite output: "
            f"{first_nonfinite(engine.model, requests[0][0]) or 'none'}")
    if engine.device.type == "cuda" and \
            min(res["launches"][n] for n in F16_SERVE_KERNELS) < 1:
        raise AssertionError(f"f16 serving did not run the f16 K4/K5: "
                             f"{res['launches']}")
    return res


def phase_serve_f16() -> dict:
    """Llama-2 7B at full width in float16 (built after the bf16 7B is
    released), paged, on serve_paged's traffic; then GPT-2 345M in f16 on
    serve_gpt's.  Returns both runs' launch counts by model."""
    from paddle_tpu_torch import create_engine

    out = {}
    for model, spec, kw, prefix, tails, seed in (
            ("llama2-7b", "llama:llama2-7b", {}, 512, PAGED_TAILS, 0),
            ("gpt2-345m", "gpt:gpt2-345m", dict(max_seq=1024), 256,
             [32, 600, 150, 77, 400, 256, 500, 64], 2)):
        t0 = time.perf_counter()
        eng = create_engine(spec, device="cuda", dtype=torch.float16,
                            kv_layout="paged", block_size=16, min_bucket=16,
                            num_slots=8, seed=0, **kw)
        build_s = time.perf_counter() - t0
        reqs = make_requests(eng.config.vocab_size, 12, prefix, tails,
                             seed=seed)
        res = run_serve_f16(eng, reqs, max_new_tokens=64)
        emit("serve_f16", model=model, dtype="float16",
             head_dim=eng.config.head_dim, model_build_s=round(build_s, 3),
             max_seq=eng.max_seq,
             kv_pool_gb=round(eng.cache.nbytes() / 2 ** 30, 3),
             **{k: v for k, v in res.items() if k != "outputs"})
        out[model] = res["launches"]
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: f16 logits, kernel path against ``kernel="reference"`` (2 layers at
#: full width; |logits| < ~4, where an f16 ulp is 2^-9): the two paths
#: round attention's output to f16 in another order, and K4 keeps p in
#: f32 where both K5s round it
PARITY_F16_TOLERANCE = 2e-2


@torch.no_grad()
def drive_contiguous(model, prompt, steps: int, feed):
    """Slot 0 of a contiguous cache prefills ``prompt`` (K1 through the
    registered op on the card) and decodes the tokens of ``feed`` (slot
    0's of :func:`drive_paged`); the last-position logits of each
    forward."""
    from paddle_tpu_torch.serving import CacheContext, KVCache

    cfg, bs = model.config, 16
    param = next(model.parameters())
    dev = param.device
    kv_heads = getattr(cfg, "n_kv_heads", None) or cfg.num_attention_heads
    cache = KVCache(1, cfg.num_hidden_layers, 1024, kv_heads, cfg.head_dim,
                    param.dtype, device=dev)
    L = len(prompt)
    x = torch.zeros((1, -(-L // bs) * bs), dtype=torch.int64, device=dev)
    x[0, :L] = torch.tensor(prompt, device=dev)
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    out = [model(x, cache_ctx=CacheContext(cache, "prefill",
                                           slot=slot))[0, L - 1]]
    cache.set_length(slot, torch.tensor([L], dtype=torch.int32, device=dev))
    for i in range(steps):
        tok = feed[i][:1].reshape(1, 1).long()
        out.append(model(tok, cache_ctx=CacheContext(cache, "decode"))[0,
                                                                       -1])
        cache.advance(torch.ones(1, dtype=torch.int32, device=dev))
    return out


def drive_parity_f16(model, prompt, shared_len: int, tail,
                     steps: int = 4) -> dict:
    """The paged kernel path (K4/K5 f16) and the contiguous one (K1 f16
    prefill) against the paged ``kernel="reference"`` path on the same
    tokens; max abs logit errors, finiteness and the launches of each."""
    from paddle_tpu_torch.ops import kernels

    ref, fed = drive_paged(model, "reference", prompt, shared_len, tail,
                           steps)
    kernels.reset_launches()
    got, _ = drive_paged(model, "cuda", prompt, shared_len, tail, steps,
                         feed=fed)
    paged = kernels.launch_counts()
    kernels.reset_launches()
    cont = drive_contiguous(model, prompt, steps, fed)
    contiguous = kernels.launch_counts()
    return {"paged_err": max((a.float() - b.float()).abs().max().item()
                             for a, b in zip(got, ref)),
            "contiguous_err": max((a.float() - b[0].float()).abs().max()
                                  .item() for a, b in zip(cont, ref)),
            "finite": all(bool(torch.isfinite(t).all())
                          for t in [*ref, *got, *cont]),
            "forwards": len(ref), "launches_paged": paged,
            "launches_contiguous": contiguous}


def check_parity_f16(res: dict, label: str, cuda: bool) -> None:
    if not res["finite"]:
        raise AssertionError(f"parity_f16 ({label}): non-finite logits")
    for key in ("paged_err", "contiguous_err"):
        if not res[key] <= PARITY_F16_TOLERANCE:
            raise AssertionError(f"parity_f16 ({label}): {key} {res[key]} "
                                 f"> {PARITY_F16_TOLERANCE}")
    if cuda and (min(res["launches_paged"][n] for n in F16_SERVE_KERNELS)
                 < 1 or res["launches_contiguous"]["flash_fwd_f16"] < 1):
        raise AssertionError(f"parity_f16 ({label}): the f16 kernels did "
                             f"not run: {res['launches_paged']} "
                             f"{res['launches_contiguous']}")


def phase_parity_f16() -> None:
    """Both widths at 2 layers in float16: the kernel paths against the
    reference path (paged and contiguous), then the engine's CUDA graphs
    against its step bodies run eagerly (both layouts, as
    ``graph_parity``)."""
    for label, build in parity_models(torch.float16):
        model = build()
        rs = np.random.RandomState(2)
        prompt = rs.randint(0, model.config.vocab_size, (300,)).tolist()
        tail = rs.randint(0, model.config.vocab_size, (100,)).tolist()
        res = drive_parity_f16(model, prompt, 256, tail)
        emit("parity_f16", model=label, dtype="float16",
             head_dim=model.config.head_dim,
             tolerance=PARITY_F16_TOLERANCE, **res)
        check_parity_f16(res, label, cuda=True)
        reqs = make_requests(model.config.vocab_size, 4, 48,
                             [5, 40, 17, 90], seed=3)
        for layout in ("paged", "contiguous"):
            g = drive_graph_parity(model, layout, reqs, 12, num_slots=4,
                                   max_seq=256, min_bucket=16,
                                   block_size=16)
            emit("parity_f16", model=label, dtype="float16", layout=layout,
                 graph_identical=g["identical"],
                 compile_cache=g["compile_cache"], launches=g["launches"])
            if not g["identical"] or g["compile_cache"]["after_warmup"]:
                raise AssertionError(
                    f"parity_f16 ({label}, {layout}): the programs gave "
                    f"{g['programs']}, the eager bodies {g['eager']}, "
                    f"{g['compile_cache']}")
        del model
        gc.collect()
        torch.cuda.empty_cache()


#: the predictor's inputs: seeded ids ``[batch, seq]``
PREDICTOR_IDS = (4, 1024)
#: the predictor's f16 logits against the eager forward on the same
#: kernels (the same ops on the same device: one f16 ulp at |x| < 4)
PREDICTOR_EAGER_TOLERANCE = 2e-3
#: ... and against ``kernel="reference"`` (24 layers: K1 rounds p to f16
#: before P V at every layer, the plain attention keeps f32 p)
PREDICTOR_REFERENCE_TOLERANCE = 5e-2


def _set_kernel(model, kernel: str) -> None:
    for m in model.modules():
        if hasattr(m, "kernel"):
            m.kernel = kernel


def _predictor_config(path: str, device: torch.device):
    from paddle_tpu_torch import inference

    cfg = inference.Config(path)
    if device.type == "cuda":
        cfg.enable_use_gpu(256, device.index or 0,
                           inference.PrecisionType.Half)
    else:
        cfg.disable_gpu()
    return cfg


def _timed_run(pred, device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run_predictor(model, ids: np.ndarray, root: str) -> dict:
    """``jit.save`` ``model`` (symbolic batch) into ``root``, serve it
    through ``Config``, ``create_predictor`` and the handles on ``ids``
    (a first run, then one counted and timed on the host's clock, the
    logits' copy to the host included; on the card also the program's and
    the eager forward's ms between CUDA events and the host ms each takes
    to enqueue a call: where the host's exceed the events', the call is
    bound by the host), and hold the logits to the eager
    forward and to ``kernel="reference"``; then a
    ``PredictorPool(config, 2)``, whose loads are counted.  The model
    and the predictors run on the model's device."""
    from paddle_tpu_torch import inference, jit, static
    from paddle_tpu_torch.ops import kernels

    dev = next(model.parameters()).device
    path = os.path.join(root, "model")
    t0 = time.perf_counter()
    jit.save(model, path, input_spec=[
        static.InputSpec([None, ids.shape[1]], "int64", name="input_ids")])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = _predictor_config(path, dev)
    pred = inference.create_predictor(cfg)
    load_s = time.perf_counter() - t0
    names = pred.get_input_names()
    pred.get_input_handle(names[0]).copy_from_cpu(ids)
    first_ms = _timed_run(pred, dev)
    kernels.reset_launches()
    run_ms = _timed_run(pred, dev)
    launches = kernels.launch_counts()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    x = torch.from_numpy(ids).to(dev)
    with torch.no_grad():
        eager = model(x).float().cpu().numpy()
        _set_kernel(model, "reference")
        try:
            ref = model(x).float().cpu().numpy()
        finally:
            _set_kernel(model, "cuda")
    got = out.astype(np.float32)
    program_ms = eager_ms = program_host_ms = eager_host_ms = None
    if dev.type == "cuda":      # the logits left on the card
        with torch.no_grad():
            program_ms = cuda_ms(lambda: pred._layer(x), iters=3, warmup=1)
            eager_ms = cuda_ms(lambda: model(x), iters=3, warmup=1)
            program_host_ms = host_ms(lambda: pred._layer(x))
            eager_host_ms = host_ms(lambda: model(x))
    loads = []
    orig = jit.load

    def counting(*a, **k):
        loads.append(a[0])
        return orig(*a, **k)

    jit.load = counting
    try:
        pool = inference.PredictorPool(cfg, 2)
    finally:
        jit.load = orig
    pool_out = pool.retrieve(1).run([ids])[0]
    return {"input_names": names, "out_shape": list(out.shape),
            "out_dtype": str(out.dtype),
            "finite": bool(np.isfinite(got).all()),
            "eager_err": float(np.abs(got - eager).max()),
            "reference_err": float(np.abs(got - ref).max()),
            "max_abs_logit": float(np.abs(ref).max()),
            "pool_loads": len(loads),
            "pool_shares_layer": pool.retrieve(0)._layer
            is pool.retrieve(1)._layer,
            "pool_equal": bool(np.array_equal(pool_out, out)),
            "launches": launches, "save_s": round(save_s, 3),
            "load_s": round(load_s, 3), "first_run_ms": round(first_ms, 3),
            "run_ms": round(run_ms, 3), "program_ms": program_ms,
            "eager_ms": eager_ms, "program_host_ms": program_host_ms,
            "eager_host_ms": eager_host_ms,
            "program_mb": round(os.path.getsize(path + ".pdmodel") / 2 ** 20,
                                3),
            "params_mb": round(os.path.getsize(path + ".pdiparams")
                               / 2 ** 20, 3),
            "device": str(pred._layer.device)}


def check_predictor(res: dict, layers: int, cuda: bool, tag: str) -> None:
    if not res["finite"]:
        raise AssertionError(f"{tag}: non-finite logits")
    for key, tol in (("eager_err", PREDICTOR_EAGER_TOLERANCE),
                     ("reference_err", PREDICTOR_REFERENCE_TOLERANCE)):
        if not res[key] <= tol:
            raise AssertionError(f"{tag}: {key} {res[key]} > {tol}")
    if res["pool_loads"] != 1 or not res["pool_shares_layer"] or \
            not res["pool_equal"]:
        raise AssertionError(f"{tag}: PredictorPool(config, 2) loaded "
                             f"{res['pool_loads']} times (want 1), "
                             f"shared {res['pool_shares_layer']}, equal "
                             f"{res['pool_equal']}")
    want = {n: 0 for n in res["launches"]}
    if cuda:
        want["flash_fwd_f16"] = layers
    if res["launches"] != want:
        raise AssertionError(f"{tag}: one run launched "
                             f"{ {n: c for n, c in res['launches'].items() if c} }"
                             f", want flash_fwd_f16 x {layers if cuda else 0}"
                             f" and nothing else")


def cpu_artifact_on_card(root: str, device) -> dict:
    """A small f16 GPT (head dim 64) saved on the CPU, served by a CPU
    predictor and by one on ``device``: the latter runs K1 (one launch a
    layer), its logits within ``TOLERANCE[float16]`` of the CPU run's (the
    plain version there)."""
    from paddle_tpu_torch import inference, jit, static
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import kernels

    cfg = GPTConfig(vocab_size=128, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=128,
                    hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cpu", dtype=torch.float16,
                           generator=torch.Generator().manual_seed(4)).eval()
    path = os.path.join(root, "tiny")
    jit.save(model, path, input_spec=[static.InputSpec([None, 64], "int64")])
    ids = np.random.RandomState(5).randint(0, 128, (2, 64))
    want = inference.create_predictor(
        _predictor_config(path, torch.device("cpu"))).run([ids])[0]
    pred = inference.create_predictor(_predictor_config(path,
                                                        torch.device(device)))
    kernels.reset_launches()
    got = pred.run([ids])[0]
    launches = kernels.launch_counts()
    err = float(np.abs(got.astype(np.float32) - want.astype(np.float32))
                .max())
    return {"device": str(pred._layer.device), "err": err,
            "tolerance": TOLERANCE[torch.float16], "launches": launches,
            "layers": cfg.num_hidden_layers}


def phase_predictor() -> dict:
    """GPT-2 345M at full width made f16 by ``amp.decorate(level="O2",
    dtype="float16")``, saved by ``jit.save`` into the temporary
    directory and served through ``Config`` /
    ``enable_use_gpu(precision=Half)`` / ``create_predictor`` and the
    handles on seeded ``PREDICTOR_IDS``: logits against the eager forward
    and ``kernel="reference"``, ``flash_fwd_f16`` launched once a layer a
    run and nothing else, a pool of 2 loading once; then a CPU-saved
    artifact on the card.  Returns the run's launch counts."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_345m

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(gpt2_345m(hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0),
                           device="cuda", dtype=torch.float32,
                           generator=gen).eval()
    model = amp.decorate(model, level="O2", dtype="float16")
    ids = np.random.RandomState(6).randint(
        0, model.config.vocab_size, PREDICTOR_IDS)
    layers = model.config.num_hidden_layers
    with tempfile.TemporaryDirectory() as root:
        res = run_predictor(model, ids, root)
        emit("predictor", model="gpt2-345m", dtype="float16 (amp.decorate "
             "O2)", ids=list(PREDICTOR_IDS),
             eager_tolerance=PREDICTOR_EAGER_TOLERANCE,
             reference_tolerance=PREDICTOR_REFERENCE_TOLERANCE, **res)
        check_predictor(res, layers, cuda=True, tag="predictor")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        tiny = cpu_artifact_on_card(root, "cuda")
    emit("predictor", artifact="saved on the CPU, served on the card",
         **tiny)
    if not (tiny["err"] <= tiny["tolerance"] and tiny["device"]
            .startswith("cuda") and tiny["launches"]["flash_fwd_f16"]
            == tiny["layers"]):
        raise AssertionError(f"predictor: the CPU-saved artifact on the "
                             f"card: {tiny}")
    return res["launches"]


# -- phase 23b: dy2static_generate ------------------------------------------

#: the id buffer of the generation loop, and its prompt's length
GEN_IDS = (4, 256)
GEN_PROMPT = 64
#: the early-stop run: its eos is the token the eager run emits here
GEN_EARLY_STEP = 40
#: trips of the graph_control loop (a one-kernel body)
NODE_TRIPS = 1000


def greedy_step(model, input_ids, unfinished_flag, cur_len, eos_token_id):
    """One token of greedy decoding over a fixed id buffer, in Paddle's
    ops as a PaddleNLP user writes it: a full causal forward, the argmax
    at ``cur_len - 1``, written at ``cur_len`` by a device select (a
    finished row writes ``eos``).  The causal mask keeps the buffer's
    unfilled tail out of every written position.  ``paddle.arange`` makes
    its positions on the port's current device (``drive_generate`` sets
    it)."""
    import paddle_tpu_torch as paddle

    logits = model(input_ids)
    next_token_logits = paddle.index_select(
        logits, (cur_len - 1).reshape([1]), axis=1)[:, 0]
    next_tokens = paddle.argmax(next_token_logits, axis=-1)
    next_tokens = paddle.where(unfinished_flag, next_tokens, eos_token_id)
    positions = paddle.arange(input_ids.shape[1])
    input_ids = paddle.where(positions == cur_len, next_tokens[:, None],
                             input_ids)
    unfinished_flag = paddle.logical_and(unfinished_flag,
                                         next_tokens != eos_token_id)
    return input_ids, unfinished_flag, cur_len + 1


def greedy_search(model, input_ids, cur_len, max_length: int,
                  eos_token_id):
    """PaddleNLP ``GenerationMixin.greedy_search``'s loop: generate until
    ``max_length`` or until every row has emitted ``eos_token_id`` (a
    tensor-predicated early stop).  ``cur_len`` is a 0-d int64 tensor, so
    the loop's test is a tensor's value: Python's loop on the CPU and at a
    program's eager call, a WHILE node (its break an IF pair inside it)
    captured on the card, ``torch.while_loop`` in a saved program."""
    unfinished_flag = input_ids[:, 0] == input_ids[:, 0]
    while cur_len < max_length:
        input_ids, unfinished_flag, cur_len = greedy_step(
            model, input_ids, unfinished_flag, cur_len, eos_token_id)
        if not unfinished_flag.any():
            break
    return input_ids, cur_len


class GreedyGenerator(torch.nn.Module):
    """``greedy_search`` over a model as a layer (``jit.save`` exports a
    layer's forward): ``(input_ids, cur_len, eos_token_id) -> (ids,
    cur_len)``."""

    def __init__(self, model, max_length: int):
        super().__init__()
        self.model = model
        self.max_length = max_length

    def forward(self, input_ids, cur_len, eos_token_id):
        return greedy_search(self.model, input_ids, cur_len,
                             self.max_length, eos_token_id)


def gen_inputs(ids: np.ndarray, prompt: int, eos: int, device):
    buf = torch.zeros(ids.shape, dtype=torch.int64, device=device)
    buf[:, :prompt] = torch.from_numpy(ids[:, :prompt]).to(device)
    return (buf, torch.tensor(prompt, dtype=torch.int64, device=device),
            torch.tensor(eos, dtype=torch.int64, device=device))


def timed_call(fn, *args):
    """``(fn(*args), host ms)`` with the card synchronized around."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def drive_generate(gen, ids: np.ndarray, prompt: int, eos: int, device,
                   root: str, predictor: bool = True) -> dict:
    """``gen`` (a :class:`GreedyGenerator`) on ``ids``' prompt: eagerly,
    through ``jit.to_static`` (the eager first call, the capture, then
    replays) and, with ``predictor``, ``jit.save`` → ``create_predictor``.
    Returns the ids and final ``cur_len`` of each, the replay's K1
    launches and the times."""
    from paddle_tpu_torch import device_guard, inference, jit, static
    from paddle_tpu_torch.ops import kernels

    dev = torch.device(device)
    args = gen_inputs(ids, prompt, eos, dev)
    res = {}
    with torch.no_grad(), device_guard(dev):
        (e_ids, e_len), res["eager_ms"] = timed_call(gen, *args)
        res["eager_ids"], res["eager_len"] = e_ids.cpu().numpy(), int(e_len)
        static_fn = jit.to_static(gen.forward)
        (_, _), res["first_call_ms"] = timed_call(static_fn, *args)
        (s_ids, s_len), res["capture_ms"] = timed_call(static_fn, *args)
        kernels.reset_launches()
        (s_ids, s_len), res["replay_ms"] = timed_call(static_fn, *args)
        res["replay_launches"] = {n: c for n, c in
                                  kernels.launch_counts().items() if c}
        res["static_ids"], res["static_len"] = (s_ids.cpu().numpy(),
                                                int(s_len))
        res["captures"] = static_fn.captures
        res["programs"] = len(static_fn.program_cache)
    if not predictor:
        return res
    path = os.path.join(root, "generate")
    t0 = time.perf_counter()
    with device_guard(dev):
        jit.save(gen, path, input_spec=[
            static.InputSpec(list(ids.shape), "int64", name="input_ids"),
            static.InputSpec([], "int64", name="cur_len"),
            static.InputSpec([], "int64", name="eos_token_id")])
    res["save_s"] = time.perf_counter() - t0
    cfg = inference.Config(path)
    if dev.type == "cuda":
        cfg.enable_use_gpu(256, dev.index or 0)
    else:
        cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    host = [a.cpu().numpy() for a in args]
    for name, a in zip(pred.get_input_names(), host):
        pred.get_input_handle(name).copy_from_cpu(a)
    res["predictor_first_ms"] = _timed_run(pred, dev)
    kernels.reset_launches()
    res["predictor_ms"] = _timed_run(pred, dev)
    res["predictor_launches"] = {n: c for n, c in
                                 kernels.launch_counts().items() if c}
    outs = [pred.get_output_handle(n).copy_to_cpu()
            for n in pred.get_output_names()]
    res["predictor_ids"], res["predictor_len"] = outs[0], int(outs[1])
    return res


def check_generate(res: dict, layers: int, tag: str, cuda: bool) -> None:
    for other in ("static", "predictor"):
        if other + "_ids" not in res:
            continue
        if not (np.array_equal(res[other + "_ids"], res["eager_ids"])
                and res[other + "_len"] == res["eager_len"]):
            raise AssertionError(f"{tag}: {other} ids or cur_len differ "
                                 f"from the eager loop's")
    if cuda:
        trips = res["static_len"] - GEN_PROMPT
        k1 = res["replay_launches"].get("flash_fwd_f16", 0)
        if k1 != layers * trips or res["captures"] != 1:
            raise AssertionError(f"{tag}: K1 launched {k1} times in a "
                                 f"replay of {trips} trips ({layers} "
                                 f"layers), captures {res['captures']}")


def node_cost(device) -> dict:
    """The WHILE node's cost a trip: a loop of ``NODE_TRIPS`` trips over a
    one-kernel body (``x + 1`` on 256 floats, the counter, the test)
    captured with a WHILE node, against the same body unrolled into a
    graph (a bare replay), the plain version (Python's loop, one host read
    a trip) and ``torch.while_loop`` (its eager path), each per trip."""
    from paddle_tpu_torch.static import nn as snn

    x0 = torch.zeros(256, device=device)
    n = torch.tensor(NODE_TRIPS, device=device)

    def c(i, x):
        return i < n

    def b(i, x):
        return i + 1, x + 1.0

    def fresh():
        return [torch.zeros((), dtype=torch.int64, device=device), x0]

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    g_while, g_flat = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    start = fresh()
    nodes = snn.Nodes(device)
    with nodes, torch.cuda.graph(g_while, stream=side):
        w_out = snn.while_loop(c, b, start)
    flat = fresh()
    with torch.cuda.graph(g_flat, stream=side):
        i, x = flat
        for _ in range(NODE_TRIPS):
            i, x = b(i, x)
            c(i, x)
    while_ms = cuda_ms(g_while.replay, iters=5) / NODE_TRIPS
    flat_ms = cuda_ms(g_flat.replay, iters=5) / NODE_TRIPS
    torch.cuda.synchronize()
    plain = fresh()
    t0 = time.perf_counter()
    out = snn.while_loop(c, b, plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / NODE_TRIPS
    t0 = time.perf_counter()
    lib = torch.while_loop(c, b, tuple(fresh()))
    torch.cuda.synchronize()
    library_ms = (time.perf_counter() - t0) * 1e3 / NODE_TRIPS
    err = max(float((w_out[1] - out[1]).abs().max()),
              float((lib[1] - out[1]).abs().max()),
              abs(int(w_out[0]) - NODE_TRIPS))
    del g_while, w_out
    nodes.release()
    return {"trips": NODE_TRIPS, "while_ms_per_trip": while_ms,
            "unrolled_ms_per_trip": flat_ms,
            "node_ms_per_trip": while_ms - flat_ms,
            "plain_ms_per_trip": plain_ms, "library_ms_per_trip": library_ms,
            "max_abs_err": err}


def phase_dy2static_generate(build: dict) -> dict:
    """GPT-2 345M f16 (``amp.decorate`` O2, as ``predictor``) generating
    greedily with :func:`greedy_search` on a ``[4, 256]`` buffer with a
    64-token prompt: eager, through ``to_static`` (one CUDA graph whose
    WHILE node runs K1 in its body, 24 launches a trip) and saved /
    served by ``create_predictor``, the ids bitwise equal; then a batch-1
    run whose eos is the token the eager run emits at step 40, stopped by
    the replayed graph's own predicate at the eager loop's ``cur_len``;
    then the WHILE node's cost a trip (``graph_control``).  Returns the
    kernels-line record of the conditional kernel and the launches of the
    main run's replay."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_345m
    from paddle_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(gpt2_345m(hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0),
                           device="cuda", dtype=torch.float32,
                           generator=gen).eval()
    model = amp.decorate(model, level="O2", dtype="float16")
    layers = model.config.num_hidden_layers
    ids = np.random.RandomState(7).randint(0, model.config.vocab_size,
                                           GEN_IDS)
    generator = GreedyGenerator(model, GEN_IDS[1])
    with tempfile.TemporaryDirectory() as root:
        res = drive_generate(generator, ids, GEN_PROMPT, -1, "cuda", root)
    check_generate(res, layers, "dy2static_generate", cuda=True)
    emit("dy2static_generate", model="gpt2-345m", dtype="float16 (amp."
         "decorate O2)", ids=list(GEN_IDS), prompt=GEN_PROMPT,
         cur_len=res["eager_len"], trips=res["static_len"] - GEN_PROMPT,
         ids_equal=True, replay_launches=res["replay_launches"],
         predictor_launches=res["predictor_launches"],
         **{k: round(res[k], 3) for k in (
             "eager_ms", "first_call_ms", "capture_ms", "replay_ms",
             "save_s", "predictor_first_ms", "predictor_ms")})
    main_launches = res["replay_launches"]
    # the early stop: batch 1, eos = the token emitted at step 40
    eos = int(res["eager_ids"][0, GEN_PROMPT + GEN_EARLY_STEP])
    early = drive_generate(generator, ids[:1], GEN_PROMPT, eos, "cuda",
                           "", predictor=False)
    check_generate(early, layers, "dy2static_generate/early", cuda=True)
    if not early["static_len"] < GEN_IDS[1]:
        raise AssertionError("dy2static_generate: the early-stop run did "
                             "not stop early")
    emit("dy2static_generate", run="early stop", batch=1, eos=eos,
         cur_len=early["static_len"], eager_cur_len=early["eager_len"],
         stop_step=early["static_len"] - GEN_PROMPT,
         replay_launches=early["replay_launches"],
         **{k: round(early[k], 3) for k in (
             "eager_ms", "capture_ms", "replay_ms")})
    del model, generator
    gc.collect()
    torch.cuda.empty_cache()
    cost = node_cost(torch.device("cuda"))
    emit("graph_control", build_s=build.get("graph_control"), **cost)
    if not cost["max_abs_err"] == 0:
        raise AssertionError(f"graph_control: the WHILE node's loop differs "
                             f"from the plain loop's: {cost}")
    info = kernels.KERNELS["graph_conditional"]
    record = {"name": info.name, "route": "cuda", "source": info.source,
              "replaces": info.replaces,
              "case": f"WHILE node, {NODE_TRIPS} trips of a one-kernel "
                      f"body, per trip",
              "max_abs_err": cost["max_abs_err"], "tolerance": 0,
              "ms": cost["while_ms_per_trip"],
              "plain_ms": cost["plain_ms_per_trip"],
              # one bool read a trip
              "bound_ms": 1 / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
              "library_ms": cost["library_ms_per_trip"],
              "library_call": "torch.while_loop (eager)"}
    return {"record": record, "launches": main_launches}


# -- phases 12, 13 and 14: training ----------------------------------------

TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
#: the kernels whose f32 instances the kernels phase times at the train
#: shape: K1-K3 (static_train's) and K1's dropout instance
F32_TIMED = TRAIN_KERNELS + ("flash_fwd_dropout",)


def run_train(config: str, batch: int, seq: int, device: str, warmup: int,
              steps: int, to_static: bool = True, check_fall: bool = True,
              keep_step: bool = False, **build_kw) -> dict:
    """``build_train_step`` for ``config`` (``build_kw``: its recipe
    options and AMP level); zero the launch counts, run ``warmup`` then
    ``steps`` timed steps on the one seeded batch, and check the losses:
    finite, and (``check_fall``) the last below the first.  Returns the
    run's figures, the launch counts of these steps alone and, for a
    compiled step, its program-cache counts (``keep_step``: also the
    ``TrainStep`` under ``"ts"``).  The peak is taken from the model's
    build on, so a graph's pool is in it."""
    from paddle_tpu_torch import build_train_step
    from paddle_tpu_torch.ops import kernels

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts = build_train_step(config, batch=batch, seq=seq, device=device,
                          to_static=to_static, **build_kw)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in ts.model.parameters())
    kernels.reset_launches()
    losses = [ts.train_step(ts.x, ts.y) for _ in range(warmup)]
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [ts.train_step(ts.x, ts.y) for _ in range(steps)]
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss {losses}")
    if check_fall and not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall {losses}")
    tokens_per_s = steps * batch * seq / wall
    res = {"params": n_params, "steps": warmup + steps, "timed_steps": steps,
           "to_static": to_static, "model_build_s": round(build_s, 3),
           "step_ms": wall * 1e3 / steps, "tokens_per_s": tokens_per_s,
           "mfu": tokens_per_s * 6 * n_params / PEAK_FLOPS[torch.bfloat16],
           "losses": losses, "launches": launches,
           "layers": ts.model.config.num_hidden_layers}
    if to_static:
        f = ts.train_step
        res["program_cache"] = {"programs": len(f.program_cache),
                                "misses": f.misses, "hits": f.hits,
                                "captures": f.captures}
    if cuda:
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if keep_step:
        res["ts"] = ts
    return res


#: the eager steps ``train`` holds the compiled step's first losses to
TRAIN_EAGER_STEPS = 3


def phase_train() -> dict:
    """GPT-2 345M's bench step through ``jit.to_static`` (a CUDA graph a
    step after the first two calls): 3 warm-up and 10 timed steps, one
    program and one capture; its first 3 losses against the same step run
    eagerly (bitwise expected: the same kernels in the same order)."""
    eager = run_train("gpt2-345m", batch=8, seq=1024, device="cuda",
                      warmup=0, steps=TRAIN_EAGER_STEPS, to_static=False,
                      check_fall=False)
    gc.collect()
    torch.cuda.empty_cache()
    res = run_train("gpt2-345m", batch=8, seq=1024, device="cuda", warmup=3,
                    steps=10)
    diff = max(abs(a - b) for a, b in zip(res["losses"], eager["losses"]))
    want = res["layers"] * res["steps"]
    emit("train", model="gpt2-345m", dtype="bfloat16 (AMP O2, f32 masters)",
         batch=8, seq=1024, mfu_peak="989e12 bf16 dense, 6N flops/token",
         eager_losses=eager["losses"], eager_max_abs_diff=diff, **res)
    if res["program_cache"] != {"programs": 1, "misses": 1,
                                "hits": res["steps"] - 1, "captures": 1}:
        raise AssertionError(f"train: program cache {res['program_cache']} "
                             f"(want one program, one capture)")
    if diff != 0.0:
        raise AssertionError(f"train: the compiled step's first losses "
                             f"{res['losses'][:3]} differ from the eager "
                             f"step's {eager['losses']}")
    for name in TRAIN_KERNELS:
        if res["launches"][name] != want:
            raise AssertionError(f"train: {name} launched "
                                 f"{res['launches'][name]} times, want "
                                 f"{want} (one per layer per step)")
    return res


#: the port's worker that hybrid_train starts through the launcher
HYBRID_WORKER = os.path.join("paddle_tpu_torch", "distributed", "launch",
                             "hybrid_train.py")
#: seconds the launched worker may take
HYBRID_TIMEOUT_S = 300
#: gradient merge against one full-batch update: max abs over parameters
MERGE_TOLERANCE = 1e-5


def phase_hybrid_train(train: dict) -> dict:
    """GPT-2 345M through fleet in a launched NCCL world of one
    (``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 1``
    on ``hybrid_train.py``): (a) the bench step built through
    ``fleet.init`` (every degree 1, sharding stage 1),
    ``distributed_model`` and ``distributed_optimizer(AdamW)``, 3 + 10
    steps as one CUDA graph a step, whose losses must be bitwise the
    ``train`` phase's (at degree 1 the wrappers add no work) and whose
    K1-K3 launches are one per layer per step; (b) gradient merge (k 4,
    avg) over 4 micro-batches of 2 against one SGD update on the batch of
    8, f32, within ``MERGE_TOLERANCE``, and its refusal of a compiled
    step; (c) every collective on the card, and one all-reduce captured
    in a CUDA graph on a side stream and replayed.  K1-K3 are held
    against their plain versions at the path's shape (bf16, B 8, S 1024,
    16 heads of 64) here, outside the counted run."""
    import shutil

    root = tempfile.mkdtemp(prefix="hybrid_train_")
    out = os.path.join(root, "result.json")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "1", "--log_dir", root, HYBRID_WORKER,
         "--out", out], env=env, capture_output=True, text=True,
        timeout=HYBRID_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = ""
    if os.path.exists(os.path.join(root, "workerlog.0")):
        with open(os.path.join(root, "workerlog.0")) as f:
            log = f.read()
    if proc.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"hybrid_train: the launched worker failed "
                             f"(rc {proc.returncode}):\n{log[-3000:]}\n"
                             f"{proc.stderr[-2000:]}")
    with open(out) as f:
        res = json.load(f)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(res), flush=True)          # the worker's line
    fl, merge = res["fleet"], res["merge"]
    gen = torch.Generator(device="cuda").manual_seed(23)
    held = {"flash_fwd": check_flash(gen, 8, 1024, 16, torch.bfloat16, D=64,
                                     fused=True),
            "flash_bwd_dkv": check_flash_bwd(gen, "flash_bwd_dkv", 8, 1024,
                                             16, torch.bfloat16),
            "flash_bwd_dq": check_flash_bwd(gen, "flash_bwd_dq", 8, 1024,
                                            16, torch.bfloat16)}
    kernel_errs = {n: {"max_abs_err": c["err"], "tol": c["tol"]}
                   for n, c in held.items()}
    del held
    emit("hybrid_train", model="gpt2-345m",
         dtype="bfloat16 (AMP O2, f32 masters)", batch=8, seq=1024,
         world=res["world"], wrappers=[fl["model"], fl["optimizer"]],
         step_ms=fl["step_ms"], losses=fl["losses"],
         train_losses=train["losses"], launches=fl["launches"],
         program_cache=fl["program_cache"], merge=merge,
         collectives=res["collectives"], capture=res["capture"],
         kernels_vs_plain=kernel_errs, worker_seconds=res["seconds"],
         phase_seconds=seconds)
    if res["world"] != {"backend": "nccl", "size": 1}:
        raise AssertionError(f"hybrid_train: world {res['world']}")
    if fl["losses"] != train["losses"]:
        raise AssertionError(f"hybrid_train: the fleet step's losses "
                             f"{fl['losses']} are not bitwise the train "
                             f"phase's {train['losses']}")
    want = fl["layers"] * len(fl["losses"])
    for name in TRAIN_KERNELS:
        if fl["launches"][name] != want:
            raise AssertionError(f"hybrid_train: {name} launched "
                                 f"{fl['launches'][name]} times, want "
                                 f"{want}")
    if fl["program_cache"]["captures"] != 1:
        raise AssertionError(f"hybrid_train: program cache "
                             f"{fl['program_cache']}")
    if not merge["max_abs_diff"] <= MERGE_TOLERANCE or \
            not merge["refuses_to_static"]:
        raise AssertionError(f"hybrid_train: gradient merge {merge}")
    bad = [n for n, ok in res["collectives"].items() if not ok]
    if bad or not res["capture"]["equal"]:
        raise AssertionError(f"hybrid_train: collectives failed {bad}, "
                             f"capture {res['capture']}")
    for n, e in kernel_errs.items():
        if not e["max_abs_err"] <= e["tol"]:
            raise AssertionError(f"hybrid_train: {n} {e}")
    return {"launches": fl["launches"], "step_ms": fl["step_ms"]}


#: elastic_train: the port's worker that the elastic launcher starts, the
#: steps (train's 3 + 10), the checkpoint cadence, the straggler's step and
#: stall, and the mesh watchdog's deadline (a stall past it exits 101)
ELASTIC_WORKER = os.path.join("paddle_tpu_torch", "distributed", "launch",
                              "elastic_train.py")
ELASTIC_STEPS, ELASTIC_SAVE_EVERY = 13, 4
ELASTIC_STALL_AT, ELASTIC_STALL_S, ELASTIC_DEADLINE_S = 6, 8.0, 5.0
#: seconds the elastic launcher may take
ELASTIC_TIMEOUT_S = 420


def drive_elastic_train(config: str, device: str, root: str, batch: int = 8,
                        seq: int = 1024, layers=None,
                        stall: float = ELASTIC_STALL_S,
                        deadline: float = ELASTIC_DEADLINE_S,
                        timeout: float = ELASTIC_TIMEOUT_S) -> dict:
    """``python -m paddle_tpu_torch.distributed.launch --elastic_coordinator
    <root>/coord --np 1 --job_id smoke --max_restarts 2`` on
    ``elastic_train.py``: life 1 stalls at step ``ELASTIC_STALL_AT`` past
    the watchdog's deadline and exits 101; the launcher relaunches it and
    life 2 resumes from the newest generation.  Returns the run read from
    the worker's events: each step's loss from the last life that ran it,
    the redone steps' losses in both lives, the times (detection,
    relaunch to the first resumed step, the resume's load), the step ms
    of each life, each life's launches, and ``lost_samples`` of the
    committed segments on an ``ElasticDataSchedule`` of the batch."""
    from paddle_tpu_torch.distributed.reshard import ElasticDataSchedule

    coord, run = os.path.join(root, "coord"), os.path.join(root, "run")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--elastic_coordinator", coord, "--np", "1", "--job_id", "smoke",
           "--max_restarts", "2", "--log_dir", os.path.join(root, "logs"),
           ELASTIC_WORKER, "--root", run, "--coord", coord, "--job_id",
           "smoke", "--config", config, "--device", device, "--batch",
           str(batch), "--seq", str(seq), "--steps", str(ELASTIC_STEPS),
           "--save_every", str(ELASTIC_SAVE_EVERY), "--stall_at",
           str(ELASTIC_STALL_AT), "--stall", str(stall), "--deadline",
           str(deadline)] + (["--layers", str(layers)] if layers else [])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    events = []
    path = os.path.join(run, "events.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
    log = ""
    if os.path.exists(os.path.join(root, "logs", "workerlog.0")):
        with open(os.path.join(root, "logs", "workerlog.0")) as f:
            log = f.read()
    lives = sorted({e["life"] for e in events if e["event"] == "start"})
    steps = {life: [e for e in events if e["event"] == "step"
                    and e["life"] == life] for life in lives}
    done = [e for e in events if e["event"] == "done"]
    fired = [e for e in events if e["event"] == "fired"]
    res = {"rc": proc.returncode, "seconds": seconds, "lives": len(lives),
           "launcher_log": proc.stderr[-1500:], "worker_log": log[-3000:]}
    if proc.returncode != 0 or len(lives) != 2 or not done or not fired:
        return res
    first, second = steps[1], steps[2]
    resume = second[0]["step"]
    losses = [e["loss"] for e in first if e["step"] < resume] + \
        [e["loss"] for e in second]

    def step_ms(ss):
        """The median host interval between a life's steps after its eager
        call and its capture."""
        return float(np.median([(b["t"] - a["t"]) * 1e3
                                for a, b in zip(ss[2:], ss[3:])]))

    sched = ElasticDataSchedule(batch)
    res.update({
        "losses": losses, "resume_step": resume,
        "steps_redone": len([e for e in first if e["step"] >= resume]),
        "redone_life1": [e["loss"] for e in first if e["step"] >= resume],
        "redone_life2": [e["loss"] for e in second
                         if e["step"] < first[-1]["step"] + 1],
        "detect_s": fired[0]["t"] - first[-1]["t"],
        "relaunch_to_first_step_s": second[0]["t"] - fired[0]["t"],
        "load_s": done[0]["resume_s"],
        "step_ms_before": step_ms(first), "step_ms_after": step_ms(second),
        "launches": {"life1": first[-1]["launches"],
                     "life2": done[0]["launches"]},
        "program_cache": done[0]["program_cache"],
        "wrapper": done[0]["model"], "layers": done[0]["layers"],
        "lost_samples": sched.lost_samples(
            [(0, resume, 1), (resume, ELASTIC_STEPS, 1)])})
    return res


def phase_elastic_train(train: dict) -> dict:
    """GPT-2 345M under the elastic launcher (see
    :func:`drive_elastic_train`) at ``train``'s recipe: a ``train.straggler``
    stall at step 6 outlasts the mesh watchdog's deadline, the worker
    exits 101, the launcher relaunches it and it resumes from the format-2
    generation of step 4.  Held: exit 0, two lives, the 13 losses bitwise
    ``train``'s (and the redone steps' bitwise in both lives), no sample
    lost, one capture in the second life and its K1-K3 launches one per
    layer per step."""
    import shutil

    root = tempfile.mkdtemp(prefix="elastic_train_")
    res = drive_elastic_train("gpt2-345m", "cuda", root)
    shutil.rmtree(root, ignore_errors=True)
    report = {k: v for k, v in res.items()
              if k not in ("launcher_log", "worker_log")}
    emit("elastic_train", model="gpt2-345m",
         dtype="bfloat16 (AMP O2, f32 masters)", batch=8, seq=1024,
         stall_at=ELASTIC_STALL_AT, stall_s=ELASTIC_STALL_S,
         deadline_s=ELASTIC_DEADLINE_S, save_every=ELASTIC_SAVE_EVERY,
         train_losses=train["losses"], **report)
    if res["rc"] != 0 or res["lives"] != 2 or "losses" not in res:
        raise AssertionError(f"elastic_train: rc {res['rc']}, lives "
                             f"{res['lives']}\n{res['worker_log']}\n"
                             f"{res['launcher_log']}")
    if res["losses"] != train["losses"]:
        raise AssertionError(f"elastic_train: losses {res['losses']} are not "
                             f"bitwise train's {train['losses']}")
    if res["redone_life1"] != res["redone_life2"] or res["lost_samples"]:
        raise AssertionError(f"elastic_train: redone steps "
                             f"{res['redone_life1']} / {res['redone_life2']},"
                             f" lost samples {res['lost_samples']}")
    if res["program_cache"]["captures"] != 1:
        raise AssertionError(f"elastic_train: program cache "
                             f"{res['program_cache']}")
    want = res["layers"] * (ELASTIC_STEPS - res["resume_step"])
    for name in TRAIN_KERNELS:
        if res["launches"]["life2"].get(name) != want:
            raise AssertionError(f"elastic_train: {name} launched "
                                 f"{res['launches']['life2'].get(name)} "
                                 f"times in the second life, want {want}")
    return res


#: ring_attention: GPT-2 345M's attention heads over 8192 positions cut
#: into 4 sep chunks of 2048, B 1, bf16, causal
RING_SHAPE, RING_CHUNKS = (1, 8192, 16, 64), 4


def drive_ring_attention(device: str, shape=RING_SHAPE,
                         chunks: int = RING_CHUNKS,
                         dtype=torch.bfloat16, timed: bool = False) -> dict:
    """The in-process ring (``ring_flash_attention(..., chunks=p)``: K1 a
    tick forward, K2 and K3 a tick backward) on seeded ``[B, S, H, D]``
    inputs, held forward and backward against one K1-K3 call over the
    whole sequence (``flash_attention``) and against the plain ring
    (``ring_attention_reference``).  Returns the errors (outputs absolute,
    gradients relative to the largest whole-sequence gradient), the
    ring's launches (counted from 0), and with ``timed`` the ring's and
    the whole call's ms."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import flash_attention
    from paddle_tpu_torch.ops.ring_attention import (
        ring_attention_reference, ring_flash_attention,
    )

    gen = torch.Generator(device=device).manual_seed(24)
    base = [torch.randn(shape, generator=gen, device=device).to(dtype)
            for _ in range(4)]
    do = base[3]

    def run(fn, **kw):
        q, k, v = (t.clone().requires_grad_() for t in base[:3])
        o = fn(q, k, v, True, **kw)
        o.backward(do)
        return o.detach(), [t.grad for t in (q, k, v)]

    kernels.reset_launches()
    ring, ring_g = run(ring_flash_attention, chunks=chunks)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    whole, whole_g = run(lambda q, k, v, c: flash_attention(
        q, k, v, is_causal=c))
    plain, plain_g = run(ring_attention_reference, chunks=chunks)
    scale = max(g.float().abs().max().item() for g in whole_g)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    res = {"shape": list(shape), "chunks": chunks,
           "dtype": str(dtype).split(".")[-1],
           "ticks": chunks * (chunks + 1) // 2,
           "out_err_whole": err(ring, whole), "out_err_plain": err(ring,
                                                                    plain),
           "grad_rel_err_whole": max(err(a, b) for a, b in
                                     zip(ring_g, whole_g)) / scale,
           "grad_rel_err_plain": max(err(a, b) for a, b in
                                     zip(ring_g, plain_g)) / scale,
           "launches": launches}
    del ring_g, whole_g, plain_g, plain
    if timed:
        q, k, v = base[:3]

        def ring_fwd():
            with torch.no_grad():
                return ring_flash_attention(q, k, v, True, chunks=chunks)

        def whole_fwd():
            with torch.no_grad():
                return flash_attention(q, k, v, is_causal=True)

        def ring_step():
            run(ring_flash_attention, chunks=chunks)

        def whole_step():
            run(lambda a, b, c, d: flash_attention(a, b, c, is_causal=d))

        res.update({"ring_fwd_ms": cuda_ms(ring_fwd, iters=5),
                    "whole_fwd_ms": cuda_ms(whole_fwd, iters=5),
                    "ring_fwd_bwd_ms": cuda_ms(ring_step, iters=3),
                    "whole_fwd_bwd_ms": cuda_ms(whole_step, iters=3)})
        res["ring_ms_per_tick"] = res["ring_fwd_ms"] / res["ticks"]
        res["ring_fwd_bwd_ms_per_tick"] = res["ring_fwd_bwd_ms"] / \
            res["ticks"]
    return res


def phase_ring_attention() -> dict:
    """Ring attention at GPT-2 345M's attention shape over 8192 positions
    (sep 4 chunks of 2048, in one process: :func:`drive_ring_attention`):
    the ring's output within the bf16 K1 tolerance of the whole-sequence
    K1 call and of the plain ring, its gradients within K2/K3's relative
    tolerance, each of K1-K3 launched once a visible tick (10)."""
    t0 = time.perf_counter()
    res = drive_ring_attention("cuda", timed=True)
    res["seconds"] = time.perf_counter() - t0
    tol = {"out": TOLERANCE[torch.bfloat16],
           "grad_rel": BWD_TOLERANCE[torch.bfloat16]}
    emit("ring_attention", tolerance=tol, **res)
    for key, limit in (("out_err_whole", tol["out"]),
                       ("out_err_plain", tol["out"]),
                       ("grad_rel_err_whole", tol["grad_rel"]),
                       ("grad_rel_err_plain", tol["grad_rel"])):
        if not res[key] <= limit:
            raise AssertionError(f"ring_attention: {key} {res[key]} > "
                                 f"{limit}")
    for name in TRAIN_KERNELS:
        if res["launches"].get(name) != res["ticks"]:
            raise AssertionError(f"ring_attention: {name} launched "
                                 f"{res['launches'].get(name)} times, want "
                                 f"{res['ticks']}")
    return res


def drive_auto_parallel_train(config: str, batch: int, seq: int,
                              device: str, steps: int = 13) -> dict:
    """``build_train_step``'s model and optimizer (AMP O2, the seeded
    batch) through ``auto_parallel.Engine(body, inputs_spec=["dp"])
    .prepare(optimizer, loss).fit`` on ``ProcessMesh([0], ["dp"])``:
    ``body`` is the model's decoder under ``auto_cast`` and ``loss`` the
    fused cross-entropy over its tied head, so that a step does what
    ``compute_loss`` does.  Returns the losses, the step's program cache
    and the launches of the fit (counted from 0)."""
    from paddle_tpu_torch import amp, build_train_step
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.fused import fused_linear_cross_entropy

    ts = build_train_step(config, batch=batch, seq=seq, device=device,
                          to_static=False)
    model = ts.model

    class Body(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, x):
            with amp.auto_cast(dtype="bfloat16", level="O2"):
                return self.m.gpt(x)

    def loss(h, y):
        with amp.auto_cast(dtype="bfloat16", level="O2"):
            return fused_linear_cross_entropy(h, model._head_weight(), y)

    saved = ap._default_process_mesh
    ap._default_process_mesh = None
    try:
        ap.ProcessMesh([0], ["dp"])
        eng = ap.Engine(Body(), inputs_spec=["dp"])
        eng.prepare(optimizer=ts.optimizer, loss=loss)
        xs = np.tile(ts.x.cpu().numpy(), (steps, 1))
        ys = np.tile(ts.y.cpu().numpy(), (steps, 1))
        if device == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        losses = eng.fit((xs, ys), batch_size=batch, epochs=1)
        wall = time.perf_counter() - t0
    finally:
        ap._default_process_mesh = saved
    f = eng._train_step
    return {"losses": losses, "seconds": wall,
            "launches": {k: v for k, v in kernels.launch_counts().items()
                         if v},
            "program_cache": {"programs": len(f.program_cache),
                              "misses": f.misses, "hits": f.hits,
                              "captures": f.captures},
            "layers": model.config.num_hidden_layers}


def phase_auto_parallel_train(train: dict) -> dict:
    """GPT-2 345M through ``auto_parallel.Engine`` on a process mesh of one
    (:func:`drive_auto_parallel_train`), 13 steps on ``train``'s batch:
    one program, one capture, K1-K3 launched once per layer per step, and
    the losses against ``train``'s (bitwise expected: the same ops in the
    same order; otherwise the largest relative difference is reported and
    held within the bf16 step's tolerance)."""
    t0 = time.perf_counter()
    res = drive_auto_parallel_train("gpt2-345m", 8, 1024, "cuda")
    res["phase_seconds"] = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                  train["losses"]))
    res["bitwise"] = res["losses"] == train["losses"]
    res["max_rel_err"] = rel
    emit("auto_parallel_train", model="gpt2-345m",
         dtype="bfloat16 (AMP O2, f32 masters)", batch=8, seq=1024,
         mesh="ProcessMesh([0], ['dp'])", train_losses=train["losses"],
         **res)
    if res["program_cache"] != {"programs": 1, "misses": 1,
                                "hits": len(res["losses"]) - 1,
                                "captures": 1}:
        raise AssertionError(f"auto_parallel_train: program cache "
                             f"{res['program_cache']}")
    if not res["bitwise"] and not rel <= TRAIN_PARITY_TOLERANCE["loss"]:
        raise AssertionError(f"auto_parallel_train: losses {res['losses']}"
                             f" differ from train's by {rel}")
    want = res["layers"] * len(res["losses"])
    for name in TRAIN_KERNELS:
        if res["launches"].get(name) != want:
            raise AssertionError(f"auto_parallel_train: {name} launched "
                                 f"{res['launches'].get(name)} times, want "
                                 f"{want}")
    return res


#: the MoE transformer of ``moe_train``: GPT-2 345M's widths at full depth,
#: the FFN of every other layer an ``MoELayer`` of 8 experts (GShard's
#: layout)
MOE_GPT = {"vocab": 50304, "positions": 1024, "hidden": 1024, "heads": 16,
           "ffn": 4096, "layers": 24, "experts": 8}
#: its step: batch x seq, compiled steps, LookAhead(AdamW) and the l_aux
#: weight; the eager steps its first losses are held to; NaN-check turns
MOE_TRAIN = {"batch": 8, "seq": 1024, "steps": 12, "lr": 1e-4, "k": 5,
             "alpha": 0.5, "aux": 0.01, "eager_steps": 3, "turns": 3,
             "turn_steps": 2}
#: the graph's first losses against the eager step's, relative (bf16
#: parameters: one step's rounding differs if any sum runs in another order)
MOE_LOSS_TOLERANCE = 1e-3


def moe_gpt_params(cfg: dict) -> int:
    """Parameters of :func:`moe_gpt` reckoned from its widths."""
    h, f, e = cfg["hidden"], cfg["ffn"], cfg["experts"]
    ffn = h * f + f + f * h + h
    block = 2 * 2 * h + h * 3 * h + 3 * h + h * h + h
    n_moe = cfg["layers"] // 2
    return ((cfg["vocab"] + cfg["positions"]) * h + 2 * h
            + cfg["layers"] * block + (cfg["layers"] - n_moe) * ffn
            + n_moe * (e * ffn + h * e + e))


def moe_gpt(cfg: dict):
    """A causal LM of ``cfg``'s widths built from the port's public API, as
    a Paddle user builds one: pre-LN blocks, attention through
    ``nn.functional.scaled_dot_product_attention(is_causal=True)`` (K1
    forward, K2/K3 backward), the FFN of every odd layer an
    ``incubate.distributed.models.moe.MoELayer`` of ``cfg["experts"]``
    experts behind a GShard top-2 gate; each FFN is ``Linear``, a user
    ``PyLayer`` GeLU with a hand-written backward, ``Linear``.  The head
    is tied to the token embedding (both embeddings drawn N(0, 0.02), as
    GPT-2's), its loss the fused LM cross-entropy, which
    ``forward(ids, labels)`` returns; ``aux_loss()`` sums the layers'
    ``l_aux`` in f32, for the step to add outside ``auto_cast`` (where
    O2 would add in bf16).  Built on the current device."""
    from paddle_tpu_torch import autograd, nn
    from paddle_tpu_torch.incubate import fused_linear_cross_entropy
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    F = nn.functional
    H, heads = cfg["hidden"], cfg["heads"]

    class GeLU(autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return F.gelu(x)

        @staticmethod
        def backward(ctx, g):
            x, = ctx.saved_tensor()
            xf = x.float()
            cdf = 0.5 * (1.0 + torch.erf(xf * 0.7071067811865476))
            pdf = torch.exp(-0.5 * xf * xf) * 0.3989422804014327
            return (g.float() * (cdf + xf * pdf)).to(g.dtype)

    class Expert(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(H, cfg["ffn"])
            self.fc2 = nn.Linear(cfg["ffn"], H)

        def forward(self, x):
            return self.fc2(GeLU.apply(self.fc1(x)))

    class Block(nn.Layer):
        def __init__(self, moe: bool):
            super().__init__()
            self.ln1 = nn.LayerNorm(H)
            self.qkv = nn.Linear(H, 3 * H)
            self.proj = nn.Linear(H, H)
            self.ln2 = nn.LayerNorm(H)
            self.ffn = MoELayer(H, [Expert() for _ in range(cfg["experts"])],
                                gate={"type": "gshard", "top_k": 2}) \
                if moe else Expert()

        def forward(self, x):
            b, s = x.shape[0], x.shape[1]
            q, k, v = self.qkv(self.ln1(x)).view(
                b, s, heads, 3 * (H // heads)).split(H // heads, dim=-1)
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + self.proj(a.reshape(b, s, H))
            return x + self.ffn(self.ln2(x).reshape(b * s, H)).reshape(
                b, s, H)

    class MoEGPT(nn.Layer):
        def __init__(self):
            super().__init__()
            init = nn.initializer.Normal(std=0.02)       # GPT-2's
            self.emb = nn.Embedding(cfg["vocab"], H, weight_attr=init)
            self.pos = nn.Embedding(cfg["positions"], H, weight_attr=init)
            self.blocks = nn.LayerList([Block(i % 2 == 1)
                                        for i in range(cfg["layers"])])
            self.ln_f = nn.LayerNorm(H)

        def moe_layers(self) -> list:
            return [b.ffn for b in self.blocks if isinstance(b.ffn, MoELayer)]

        def aux_loss(self):
            """The layers' ``l_aux``, summed in f32."""
            return torch.stack([m.l_aux.float()
                                for m in self.moe_layers()]).sum()

        def forward(self, ids, labels):
            x = self.emb(ids) + self.pos.weight[:ids.shape[1]]
            for blk in self.blocks:
                x = blk(x)
            return fused_linear_cross_entropy(self.ln_f(x), self.emb.weight,
                                              labels)

    return MoEGPT()


def moe_state(model, opt) -> list:
    """Every tensor a step of ``model`` under ``opt`` (a LookAhead) writes:
    parameters, buffers, the inner optimizer's and LookAhead's state, the
    dropout generators' states."""
    from paddle_tpu_torch import rng

    ts = [p.data for p in model.parameters()] + list(model.buffers())
    ts += _state_tensors([dict(s) for s in
                          opt.inner_optimizer.state.values()])
    ts += _state_tensors([dict(s) for s in opt.state.values()])
    ts += [opt._k_step] + [g._state for g in rng._generators.values()]
    return ts


def drive_moe_train(cfg: dict, shape: dict, device: str) -> dict:
    """``moe_train``'s drive (:func:`phase_moe_train`; tiny ``cfg`` and
    ``shape`` rehearse it on the CPU, where ``to_static`` runs the step
    eagerly and the NaN check raises in the step itself)."""
    from paddle_tpu_torch import amp, device as pdev, flags, incubate, jit, \
        optimizer, rng
    from paddle_tpu_torch.ops import kernels

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rng.seed(0)
    t0 = time.perf_counter()
    with pdev.device_guard(device):
        model = moe_gpt(cfg)
    amp.decorate(model, level="O2")
    build_s = time.perf_counter() - t0
    moes = model.moe_layers()
    rs = np.random.RandomState(0)
    B, S = shape["batch"], shape["seq"]
    x = torch.from_numpy(rs.randint(0, cfg["vocab"], (B, S))).to(device)
    y = torch.from_numpy(rs.randint(0, cfg["vocab"], (B, S))).to(device)
    init = [t.detach().clone() for t in model.state_dict().values()]

    def make_opt():
        return incubate.LookAhead(optimizer.AdamW(model.parameters(),
                                                  lr=shape["lr"]),
                                  alpha=shape["alpha"], k=shape["k"])

    def body(opt):
        def moe_step(ids, labels):
            with amp.auto_cast(dtype="bfloat16", level="O2"):
                loss = model(ids, labels)
            loss = loss + shape["aux"] * model.aux_loss()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return moe_step

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # the eager reference: the first steps without a graph, then back to
    # the initial weights and generator state
    step = body(make_opt())
    eager = [float(step(x, y)) for _ in range(shape["eager_steps"])]
    with torch.no_grad():
        for t, v in zip(model.state_dict().values(), init):
            t.copy_(v)
    # a gate's l_aux keeps its last graph alive, and with it the
    # parameters' gradient-accumulation nodes of the eager steps' stream:
    # the compiled steps run on another, so they start without it
    for m in moes:
        m.gate.set_loss(None)
    del step, init
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rng.seed(0)

    opt = make_opt()
    step = jit.to_static(body(opt))
    kernels.reset_launches()
    losses, step_ms, synced, dropped = [], [], [], []
    for i in range(shape["steps"]):
        sync()
        t0 = time.perf_counter()
        loss = step(x, y)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        gap = torch.stack([
            (opt.state[p]["slow"] - opt.inner_optimizer._param32(
                p, opt.inner_optimizer.state[p])).abs().max()
            for p in model.parameters()]).max()
        synced.append(float(gap) == 0.0)
        dropped.append(torch.stack([m.dropped_tokens for m in moes])
                       .tolist())
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    cache = {"programs": len(step.program_cache), "misses": step.misses,
             "hits": step.hits, "captures": step.captures}
    timed = step_ms[2:]
    res = {"params": sum(p.numel() for p in model.parameters()),
           "model_build_s": round(build_s, 3), "steps": shape["steps"],
           "losses": losses, "eager_losses": eager,
           "step_ms_each": [round(v, 3) for v in step_ms],
           "step_ms": _quartiles(timed),
           "tokens_per_s": B * S * 1e3 / float(np.median(timed)),
           "synced_after_steps": [i + 1 for i, s in enumerate(synced) if s],
           "dropped_per_layer_and_step": dropped,
           "capacity": moes[0]._capacity(B * S), "launches": launches,
           "program_cache": cache, "layers": cfg["layers"]}
    if cuda:
        res["peak_gb"] = pdev.cuda.max_memory_allocated() / 2 ** 30
        res["torch_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # FLAGS_check_nan_inf on the same model: a freshly captured program,
    # timed in turns against the unscanned one
    turns = {"off": [], "on": []}
    for _ in range(shape["turns"]):
        for flag in ("off", "on"):
            flags.set_flags({"FLAGS_check_nan_inf": flag == "on"})
            for _ in range(shape["turn_steps"]):
                sync()
                t0 = time.perf_counter()
                float(step(x, y))
                sync()
                turns[flag].append((time.perf_counter() - t0) * 1e3)
    flags.set_flags({"FLAGS_check_nan_inf": True})
    # the first two calls of the scanned program build and capture it
    res["nan_check_ms"] = {k: _quartiles(v[2:] if k == "on" else v)
                           for k, v in turns.items()}
    res["nan_check_programs"] = len(step.program_cache)
    saved = [t.detach().to("cpu", copy=True)
             for t in moe_state(model, opt)]
    row = model.emb.weight[int(x[0, 0])].detach().clone()
    with torch.no_grad():
        model.emb.weight[int(x[0, 0])] = float("inf")
    try:
        step(x, y)
        res["nan_raised"] = None
    except FloatingPointError as e:
        res["nan_raised"] = str(e)
    with torch.no_grad():
        model.emb.weight[int(x[0, 0])] = row
        for t, v in zip(moe_state(model, opt), saved):
            t.copy_(v)
    del saved
    res["nan_clean_loss"] = float(step(x, y))
    flags.set_flags({"FLAGS_check_nan_inf": False})
    return res


def phase_moe_train() -> dict:
    """A user's MoE training step on the card (:func:`moe_gpt` at full
    width and depth, ~1.06 B parameters, bf16 O2): ``LookAhead(AdamW)``,
    one CUDA graph a step through ``jit.to_static``, 12 steps on one
    seeded batch.  Holds: the parameter count; the graph's first losses
    against the eager step's; the loss falling; K1-K3 launched once a
    layer a step; one capture; the slow weights equal to the fast ones
    after steps 5 and 10 and no other; ``paddle.device.cuda``'s peak equal
    to torch's; then ``FLAGS_check_nan_inf``: the scanned program's step
    time in turns with the plain one's, a replay after an embedding row is
    set to inf raising ``FloatingPointError`` naming an op, and a replay
    after the state is restored passing."""
    t0 = time.perf_counter()
    res = drive_moe_train(MOE_GPT, MOE_TRAIN, "cuda")
    res["phase_seconds"] = time.perf_counter() - t0
    want_params = moe_gpt_params(MOE_GPT)
    rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                              res["eager_losses"])]
    res["eager_bitwise"] = res["losses"][:len(rel)] == res["eager_losses"]
    res["eager_max_rel_err"] = max(rel)
    emit("moe_train", model="moe-gpt (GPT-2 345M widths, 24 layers, 12 MoE "
         "layers of 8 experts, GShard top-2)",
         dtype="bfloat16 (AMP O2, f32 masters)",
         optimizer="LookAhead(AdamW(lr 1e-4), k=5, alpha=0.5)",
         batch=MOE_TRAIN["batch"], seq=MOE_TRAIN["seq"],
         want_params=want_params, **res)
    if res["params"] != want_params:
        raise AssertionError(f"moe_train: {res['params']} parameters, want "
                             f"{want_params}")
    if not res["eager_bitwise"] and not max(rel) <= MOE_LOSS_TOLERANCE:
        raise AssertionError(f"moe_train: the graph's first losses "
                             f"{res['losses'][:len(rel)]} differ from the "
                             f"eager step's {res['eager_losses']}")
    if not (all(np.isfinite(res["losses"]))
            and res["losses"][-1] < res["losses"][0]):
        raise AssertionError(f"moe_train: losses {res['losses']}")
    if res["program_cache"] != {"programs": 1, "misses": 1,
                                "hits": res["steps"] - 1, "captures": 1}:
        raise AssertionError(f"moe_train: program cache "
                             f"{res['program_cache']}")
    want = res["layers"] * res["steps"]
    for name in TRAIN_KERNELS:
        if res["launches"].get(name) != want:
            raise AssertionError(f"moe_train: {name} launched "
                                 f"{res['launches'].get(name)} times, want "
                                 f"{want}")
    k = MOE_TRAIN["k"]
    if res["synced_after_steps"] != list(range(k, res["steps"] + 1, k)):
        raise AssertionError(f"moe_train: slow == fast after steps "
                             f"{res['synced_after_steps']}")
    if res["peak_gb"] != res["torch_peak_gb"]:
        raise AssertionError(f"moe_train: peaks {res['peak_gb']} / "
                             f"{res['torch_peak_gb']}")
    if res["nan_check_programs"] != 2:
        raise AssertionError("moe_train: the NaN check did not capture a "
                             "program of its own")
    if not (res["nan_raised"] or "").startswith("Operator "):
        raise AssertionError(f"moe_train: an inf embedding row raised "
                             f"{res['nan_raised']!r}")
    if not np.isfinite(res["nan_clean_loss"]):
        raise AssertionError("moe_train: the restored step is not finite")
    return res


def timed_steps(ts, n_steps: int) -> float:
    """Host ms a step over ``n_steps`` steps of a warmed ``TrainStep``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ts.train_step(ts.x, ts.y)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps


#: turns of ``train_o1``: O1 O2 O2 O1, twice, 5 timed steps a turn
O1_TURN_STEPS, O1_ROUNDS = 5, 2


def level_turns(steps: dict, n_params: int) -> dict:
    """``steps`` (level -> warmed compiled step) timed in turns, first,
    second, second, first, ``O1_ROUNDS`` times: per level the ms of every
    turn, the median and quartiles, tokens/s and MFU at the median."""
    a, b = list(steps)
    ms = {a: [], b: []}
    for _ in range(O1_ROUNDS):
        for name in (a, b, b, a):
            ms[name].append(timed_steps(steps[name], O1_TURN_STEPS))
    tokens = 8 * 1024
    out = {}
    for name, xs in ms.items():
        q = _quartiles(xs)
        out[name] = {"step_ms": xs, **q,
                     "tokens_per_s": tokens / q["median"] * 1e3,
                     "mfu": tokens / q["median"] * 1e3 * 6 * n_params
                     / PEAK_FLOPS[torch.bfloat16]}
    return out


def phase_train_o1() -> dict:
    """GPT-2 345M's bench step at AMP O1 (``PADDLE_TPU_BENCH_AMP=O1``: f32
    parameters, no masters, ``compute_loss`` under ``auto_cast(bfloat16,
    O1)``) through ``to_static``: 3 warm-up and 10 timed steps, one
    program and one capture, the first 3 losses bitwise equal to the same
    step run eagerly, and K1-K3's bf16 instances launched layers x steps
    times; then the O1 and the O2 graph steps in turns.  Returns the
    launch counts of the 13 steps."""
    eager = run_train("gpt2-345m", batch=8, seq=1024, device="cuda",
                      warmup=0, steps=TRAIN_EAGER_STEPS, to_static=False,
                      check_fall=False, amp_level="O1")
    gc.collect()
    torch.cuda.empty_cache()
    res = run_train("gpt2-345m", batch=8, seq=1024, device="cuda", warmup=3,
                    steps=10, keep_step=True, amp_level="O1")
    o1 = res.pop("ts")
    o2 = run_train("gpt2-345m", batch=8, seq=1024, device="cuda", warmup=3,
                   steps=1, check_fall=False, keep_step=True)["ts"]
    turns = level_turns({"O1": o1, "O2": o2}, res["params"])
    del o1, o2
    gc.collect()
    torch.cuda.empty_cache()
    diff = max(abs(a - b) for a, b in zip(res["losses"], eager["losses"]))
    want = res["layers"] * res["steps"]
    emit("train_o1", model="gpt2-345m",
         dtype="f32 parameters, bfloat16 per-op policy (AMP O1, no masters)",
         batch=8, seq=1024, mfu_peak="989e12 bf16 dense, 6N flops/token",
         eager_losses=eager["losses"], eager_max_abs_diff=diff,
         turns={"order": "O1 O2 O2 O1", "rounds": O1_ROUNDS,
                "steps_per_turn": O1_TURN_STEPS, **turns}, **res)
    if res["program_cache"] != {"programs": 1, "misses": 1,
                                "hits": res["steps"] - 1, "captures": 1}:
        raise AssertionError(f"train_o1: program cache "
                             f"{res['program_cache']} (want one program, "
                             f"one capture)")
    if diff != 0.0:
        raise AssertionError(f"train_o1: the compiled step's first losses "
                             f"{res['losses'][:3]} differ from the eager "
                             f"step's {eager['losses']}")
    for name in TRAIN_KERNELS:
        if res["launches"][name] != want:
            raise AssertionError(f"train_o1: {name} launched "
                                 f"{res['launches'][name]} times, want "
                                 f"{want} (one per layer per step)")
    return res["launches"]


#: train_fp16_scaler: GradScaler settings (an initial scale past the
#: step's f16 range, so that the first steps overflow; each overflow
#: halves it; 4 good steps double it) and the run's steps
SCALER_KW = dict(init_loss_scaling=2.0 ** 32, decr_every_n_nan_or_inf=1,
                 incr_every_n_steps=4)
SCALER_STEPS = 20
SCALER_DROPOUT_STEPS = 4
F16_KERNELS = tuple(f"{n}_f16" for n in TRAIN_KERNELS)
F16_DROPOUT_KERNELS = tuple(f"{n}_dropout_f16" for n in TRAIN_KERNELS)


def scaler_rule(found, init: float, incr_ratio: float = 2.0,
                decr_ratio: float = 0.5, incr_every_n_steps: int = 1000,
                decr_every_n_nan_or_inf: int = 2, **_) -> list:
    """The JAX ``GradScaler.update`` rule (``paddle_tpu/amp/grad_scaler.
    py:151-171``) replayed on the host in f32 from the ``found_inf``
    sequence: the scale after each step."""
    scale, good, bad, out = np.float32(init), 0, 0, []
    for f in found:
        good, bad = (0, bad + 1) if f else (good + 1, 0)
        if bad >= decr_every_n_nan_or_inf:
            scale, bad = max(np.float32(scale * np.float32(decr_ratio)),
                             np.float32(1.0)), 0
        if good >= incr_every_n_steps:
            scale, good = np.float32(scale * np.float32(incr_ratio)), 0
        out.append(float(scale))
    return out


def state_checksums(model, opt) -> torch.Tensor:
    """Three int64 sums on the device: of the bits of every parameter, of
    every moment (AdamW's, zeros before they are born) and of every
    ``beta*_pow`` (ones before they are born): equal iff (with certainty
    in practice) the state is bitwise equal."""
    def bits(t):
        return t.detach().view(torch.int32).sum(dtype=torch.int64)

    params = list(model.parameters())
    zero = torch.zeros((), dtype=torch.int64, device=params[0].device)
    one = bits(torch.ones((), device=zero.device))
    moments, pows = zero.clone(), zero.clone()
    for p in params:
        st = opt.state.get(p, {})
        if "moment1" in st:
            moments += bits(st["moment1"]) + bits(st["moment2"])
            pows += bits(st["beta1_pow"]) + bits(st["beta2_pow"])
        else:
            pows += 2 * one
    return torch.stack([sum(bits(p) for p in params), moments, pows])


def run_fp16_scaler(steps: int, init: float, dropout: float = 0.0,
                    config: str = "gpt2-345m", batch: int = 8,
                    seq: int = 1024, device: str = "cuda") -> dict:
    """GPT-2 345M at AMP O1 in float16 with a ``GradScaler``: the step of
    ``tests/test_amp.py:150-158`` (``auto_cast`` around the loss, the
    scaled backward, ``scaler.step``, ``scaler.update``, ``clear_grad``),
    which also returns ``found_inf``, through ``to_static``.  Between
    steps (outside the graph, on the device) the state's checksums and
    the scale are copied aside; every device value is read after the
    loop.  ``init``: the scaler's initial scale (the rest of
    ``SCALER_KW`` as it is).  The peak (on the card) is taken from the
    build on."""
    from paddle_tpu_torch import amp, build_train_step, jit
    from paddle_tpu_torch.ops import kernels

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ts = build_train_step(config, batch=batch, seq=seq, device=device,
                          amp_level="O1", to_static=False, dropout=dropout)
    model, opt = ts.model, ts.optimizer
    scaler = amp.GradScaler(**{**SCALER_KW, "init_loss_scaling": init})

    @jit.to_static
    def step(x, y):
        with amp.auto_cast(dtype="float16", level="O1"):
            loss = model.compute_loss(x, y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        found = scaler.found_inf
        scaler.update()
        opt.clear_grad()
        return loss, found

    kernels.reset_launches()
    sums = [state_checksums(model, opt)]
    losses, found, scales = [], [], []
    for i in range(steps):
        if i == 2:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss, f = step(ts.x, ts.y)
        losses.append(loss)
        found.append(f)
        scales.append(scaler.scale_tensor.clone())
        sums.append(state_checksums(model, opt))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    return {"dropout": dropout, "steps": steps, "init_loss_scaling": init,
            "losses": [float(v.detach()) for v in losses],
            "found_inf": [bool(v) for v in found],
            "scales": [float(v) for v in scales],
            "checksums": [[int(x) for x in c] for c in sums],
            "step_ms": wall * 1e3 / (steps - 2),
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                               if cuda else None),
            "program_cache": {"programs": len(step.program_cache),
                              "misses": step.misses, "hits": step.hits,
                              "captures": step.captures},
            "launches": launches, "cuda": cuda,
            "layers": model.config.num_hidden_layers}


def check_fp16_scaler(run: dict, tag: str, both: bool = True) -> None:
    """A skipped step left the parameters, moments and ``beta*_pow``
    bitwise as they were (checksums), an applied one moved the
    parameters; the scale followed the JAX rule; some step applied (and,
    with ``both``, some skipped); the losses are finite from the first
    applied step on; one program, one capture (on the card; none on the
    CPU, where a program runs its body)."""
    found, sums = run["found_inf"], run["checksums"]
    for i, f in enumerate(found):
        if f and sums[i + 1] != sums[i]:
            raise AssertionError(f"{tag}: step {i} overflowed but changed "
                                 f"the state: {sums[i]} -> {sums[i + 1]}")
        if not f and sums[i + 1][0] == sums[i][0]:
            raise AssertionError(f"{tag}: step {i} applied but left the "
                                 f"parameters as they were")
    rule = scaler_rule(found, **SCALER_KW, init=run["init_loss_scaling"])
    if run["scales"] != rule:
        raise AssertionError(f"{tag}: scale trajectory {run['scales']} is "
                             f"not the JAX rule's {rule} for {found}")
    if all(found) or (both and not any(found)):
        raise AssertionError(f"{tag}: want an applied step"
                             f"{' and a skipped one' if both else ''}, got "
                             f"found_inf {found}")
    first = found.index(False)
    if not all(np.isfinite(run["losses"][first:])):
        raise AssertionError(f"{tag}: non-finite loss after the first "
                             f"applied step: {run['losses']}")
    if run["program_cache"] != {"programs": 1, "misses": 1,
                                "hits": run["steps"] - 1,
                                "captures": int(run["cuda"])}:
        raise AssertionError(f"{tag}: {run['program_cache']}")


def phase_train_fp16_scaler() -> dict:
    """(d): ``run_fp16_scaler`` for ``SCALER_STEPS`` steps at dropout 0
    from ``SCALER_KW``'s initial scale (K1-K3's f16 instances launched
    layers x steps times), then ``SCALER_DROPOUT_STEPS`` at the recipe's
    0.1 from the scale the first run ended at (their f16 dropout
    instances); both held by ``check_fp16_scaler``, the second needing
    only an applied step.  Returns the launch counts of the two runs."""
    plain = run_fp16_scaler(SCALER_STEPS, SCALER_KW["init_loss_scaling"])
    gc.collect()
    torch.cuda.empty_cache()
    drop = run_fp16_scaler(SCALER_DROPOUT_STEPS, plain["scales"][-1],
                           RECIPE_DROPOUT)
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_fp16_scaler", model="gpt2-345m", batch=8, seq=1024,
         dtype="f32 parameters, float16 per-op policy (AMP O1) with "
               "GradScaler", scaler=SCALER_KW,
         **{k: v for k, v in plain.items() if k != "checksums"},
         dropout_run={k: v for k, v in drop.items() if k != "checksums"})
    check_fp16_scaler(plain, "train_fp16_scaler")
    check_fp16_scaler(drop, "train_fp16_scaler (dropout)", both=False)
    for run, names in ((plain, F16_KERNELS), (drop, F16_DROPOUT_KERNELS)):
        want = run["layers"] * run["steps"]
        for name in names:
            if run["launches"][name] != want:
                raise AssertionError(
                    f"train_fp16_scaler: {name} launched "
                    f"{run['launches'][name]} times, want {want}")
    return _sum_launches(plain["launches"], drop["launches"])


RECIPE_STEPS = 20
#: a compiled step's first two calls (the eager step and the capture) are
#: not in ``step_ms``
RECIPE_UNTIMED = 2
RECIPE_KERNELS = tuple(f"{n}_dropout" for n in TRAIN_KERNELS)


def recipe_schedule():
    """The GPT-2 recipe's rate: 4 linear warm-up steps to 1.5e-4, then a
    cosine decay over the rest of the run."""
    from paddle_tpu_torch.optimizer import lr

    return lr.LinearWarmup(lr.CosineAnnealingDecay(1.5e-4, T_max=16), 4,
                           0.0, 1.5e-4)


def run_recipe(recompute: bool, config: str = "gpt2-345m", batch: int = 8,
               seq: int = 1024, device: str = "cuda",
               steps: int = RECIPE_STEPS) -> dict:
    """``config`` at the GPT-2 recipe (dropout 0.1, ``recipe_schedule``,
    a global-norm clip of 1.0), through ``to_static``: ``steps`` steps,
    the scheduler stepped after each; the device rate each step read is
    copied aside (no host read inside the loop).  ``step_ms`` is that of
    the steps after the first two (the eager call and the capture).  Then,
    outside the timing, one eager backward whose clipped gradients'
    global norm is read once.  The peak (on the card) is taken from the
    build on."""
    from paddle_tpu_torch import build_train_step
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sched = recipe_schedule()
    clip = ClipGradByGlobalNorm(1.0)
    ts = build_train_step(config, batch=batch, seq=seq, device=device,
                          dropout=RECIPE_DROPOUT, recompute=recompute,
                          lr=sched, grad_clip=clip)
    lr_t = sched._lr_tensor(ts.x.device)
    want_lrs, seen_lrs, losses = [], [], []
    for i in range(steps):
        if i == RECIPE_UNTIMED:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        want_lrs.append(sched())
        seen_lrs.append(lr_t.clone())
        losses.append(ts.train_step(ts.x, ts.y))
        sched.step()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    losses = [float(v) for v in losses]
    seen = [float(v) for v in seen_lrs]
    loss = ts.model.compute_loss(ts.x, ts.y)
    loss.backward()
    pairs = ts.optimizer._params_grads()
    norm_before = clip.global_norm([g for _, g in pairs]).item()
    norm_after = clip.global_norm([g for _, g in clip(pairs)]).item()
    ts.optimizer.clear_grad()
    f = ts.train_step
    return {"recompute": recompute, "losses": losses,
            "step_ms": wall * 1e3 / (steps - RECIPE_UNTIMED),
            "peak_memory_gb": peak, "lr_seen": seen,
            "lr_max_abs_err": max(abs(a - float(np.float32(b)))
                                  for a, b in zip(seen, want_lrs)),
            "grad_norm_before_clip": norm_before,
            "grad_norm_after_clip": norm_after,
            "program_cache": {"programs": len(f.program_cache),
                              "misses": f.misses, "captures": f.captures}}


def phase_train_recipe() -> dict:
    """(c): ``run_recipe`` with recompute off, then on.  Fails unless
    every loss is finite, each step read the scheduler's rate, the clipped
    norm is at most 1.0, the first loss is bitwise equal in the two runs
    (the same masks: a region draws its dropout offsets outside the
    checkpoint), recompute lowers the peak, and the dropout instances of
    K1-K3 ran.  Returns the launch counts of the two runs' steps."""
    from paddle_tpu_torch.ops import kernels

    kernels.reset_launches()
    runs = []
    for recompute in (False, True):
        runs.append(run_recipe(recompute))
        gc.collect()
        torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    off, on = runs
    emit("train_recipe", model="gpt2-345m", batch=8, seq=1024,
         dtype="bfloat16 (AMP O2, f32 masters)", dropout=RECIPE_DROPOUT,
         schedule="LinearWarmup(4, 0 -> 1.5e-4) then "
                  "CosineAnnealingDecay(T_max=16)",
         grad_clip="ClipGradByGlobalNorm(1.0)", steps=RECIPE_STEPS,
         recompute_off=off, recompute_on=on,
         first_loss_bitwise=off["losses"][0] == on["losses"][0],
         launches={n: launches[n] for n in RECIPE_KERNELS + TRAIN_KERNELS})
    for run in runs:
        tag = f"train_recipe (recompute {run['recompute']})"
        if not all(np.isfinite(run["losses"])):
            raise AssertionError(f"{tag}: non-finite loss {run['losses']}")
        if run["lr_max_abs_err"] != 0.0:
            raise AssertionError(f"{tag}: a step read a rate other than "
                                 f"the scheduler's: {run['lr_seen']}")
        if not run["grad_norm_after_clip"] <= 1.0 + 1e-6:   # f32 rounding
            raise AssertionError(f"{tag}: clipped global norm "
                                 f"{run['grad_norm_after_clip']} > 1.0")
        if run["program_cache"] != {"programs": 1, "misses": 1,
                                    "captures": 1}:
            raise AssertionError(f"{tag}: {run['program_cache']}")
    if off["losses"][0] != on["losses"][0]:
        raise AssertionError(f"train_recipe: first loss {off['losses'][0]} "
                             f"without recompute, {on['losses'][0]} with")
    if not on["peak_memory_gb"] < off["peak_memory_gb"]:
        raise AssertionError(f"train_recipe: recompute did not lower the "
                             f"peak ({on['peak_memory_gb']} GiB against "
                             f"{off['peak_memory_gb']})")
    for name in RECIPE_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"train_recipe: {name} never launched")
    return launches


#: train_parity tolerances (f32): loss relative; each gradient relative to
#: its tensor's largest value; the parameters after one AdamW step, whose
#: first step is lr * g / (|g| + eps): 1e-6 absolute (1e-2 lr) where the
#: reference gradient is at least SIGNAL of its tensor's largest, and 2 lr
#: elsewhere, where the two paths' gradients differ by more than their
#: size and the steps may go opposite ways (the key slice of the qkv bias,
#: whose gradient is zero in exact arithmetic, is all such noise)
TRAIN_PARITY_TOLERANCE = {"loss": 1e-5, "grad": 1e-4, "param": 1e-6,
                          "param_noise": 2e-4}
SIGNAL = 1e-3


def drive_train_parity(cfg, batch: int, seq: int, device: str,
                       lr: float = 1e-4, seed: int = 0) -> dict:
    """Two models with the same seeded f32 weights, on ``kernel="cuda"``
    and ``kernel="reference"``: one forward + backward on the same batch,
    then one AdamW step each.  Returns the largest loss, gradient and
    parameter differences (gradients relative to each tensor's largest
    value; parameters split by the reference gradient's size, see
    ``TRAIN_PARITY_TOLERANCE``) and the kernel path's launch counts."""
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    rs = np.random.RandomState(seed)
    x, y = (torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq)))
            .to(device) for _ in range(2))
    runs = {}
    for kernel in ("reference", "cuda"):
        gen = torch.Generator(device=device).manual_seed(seed)
        model = GPTForCausalLM(cfg, device=device, generator=gen,
                               kernel=kernel)
        kernels.reset_launches()
        loss = model.compute_loss(x, y)
        loss.backward()
        launches = kernels.launch_counts()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        AdamW(model.parameters(), lr=lr).step()
        runs[kernel] = (loss.item(), grads, dict(model.named_parameters()),
                        launches)
    (ref_loss, ref_g, ref_p, _), (loss, got_g, got_p, launches) = \
        runs["reference"], runs["cuda"]
    grad_err = param_err = noise_err = 0.0
    n_noise = n_all = 0
    for n, g in ref_g.items():
        top = g.abs().max().clamp(min=1e-30)
        grad_err = max(grad_err, ((got_g[n] - g).abs().max() / top).item())
        diff = (got_p[n] - ref_p[n]).detach().abs()
        noise = g.abs() < SIGNAL * top
        if (~noise).any():
            param_err = max(param_err, diff[~noise].max().item())
        if noise.any():
            noise_err = max(noise_err, diff[noise].max().item())
        n_noise += int(noise.sum())
        n_all += noise.numel()
    return {"loss": loss, "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
            "grad_rel_err": grad_err, "param_abs_err": param_err,
            "noise_param_abs_err": noise_err,
            "noise_share": n_noise / n_all, "launches": launches}


def check_train_parity(res: dict) -> None:
    tol = TRAIN_PARITY_TOLERANCE
    for key, limit in (("loss_rel_err", tol["loss"]),
                       ("grad_rel_err", tol["grad"]),
                       ("param_abs_err", tol["param"]),
                       ("noise_param_abs_err", tol["param_noise"])):
        if not res[key] <= limit:
            raise AssertionError(f"train_parity: {key} {res[key]} > {limit}")


def phase_train_parity() -> None:
    from paddle_tpu_torch.models import gpt2_345m

    cfg = gpt2_345m(num_hidden_layers=2, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    res = drive_train_parity(cfg, batch=2, seq=256, device="cuda")
    emit("train_parity", model="gpt2-345m width, 2 layers", dtype="float32",
         batch=2, seq=256, tolerance=TRAIN_PARITY_TOLERANCE, **res)
    check_train_parity(res)
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        if res["launches"][name] < 1:
            raise AssertionError(f"train_parity: kernel path did not launch "
                                 f"{name}: {res['launches']}")


#: train_parity_bf16 tolerances: the loss relative, each gradient relative
#: to its tensor's largest value.  The two paths round at other points (the
#: bf16 K1 rounds p before P V, the reference only its output), and every
#: later bf16 op rounds what it is given, so the gradients differ by a few
#: bf16 ulps (2^-8 = 3.9e-3 of a value) at their largest elements.
BF16_GRAD_TOLERANCE = {"loss": 1e-2, "grad": 5e-2}


def drive_grad_parity_bf16(cfg, batch: int, seq: int, device: str,
                           seed: int = 0) -> dict:
    """Two bf16 models with the same seeded weights, on ``kernel="cuda"``
    and ``kernel="reference"``: one forward + backward on the same batch.
    Returns the loss's relative difference, the largest gradient
    difference relative to its tensor's largest value (and which tensor),
    and the kernel path's launch counts."""
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.ops import kernels

    rs = np.random.RandomState(seed)
    x, y = (torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq)))
            .to(device) for _ in range(2))
    runs = {}
    for kernel in ("reference", "cuda"):
        gen = torch.Generator(device=device).manual_seed(seed)
        model = GPTForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                               generator=gen, kernel=kernel)
        kernels.reset_launches()
        loss = model.compute_loss(x, y)
        loss.backward()
        runs[kernel] = (loss.float().item(),
                        {n: p.grad.float() for n, p in
                         model.named_parameters()},
                        kernels.launch_counts())
        del model
    (ref_loss, ref_g, _), (loss, got_g, launches) = \
        runs["reference"], runs["cuda"]
    worst, grad_err = "", 0.0
    for n, g in ref_g.items():
        err = ((got_g[n] - g).abs().max()
               / g.abs().max().clamp(min=1e-30)).item()
        if not err <= grad_err:
            worst, grad_err = n, err
    return {"loss": loss, "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
            "grad_rel_err": grad_err, "worst_grad": worst,
            "launches": launches}


def phase_train_parity_bf16() -> None:
    from paddle_tpu_torch.models import gpt2_345m

    cfg = gpt2_345m(num_hidden_layers=2, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    res = drive_grad_parity_bf16(cfg, batch=2, seq=256, device="cuda")
    emit("train_parity_bf16", model="gpt2-345m width, 2 layers",
         dtype="bfloat16", batch=2, seq=256,
         tolerance=BF16_GRAD_TOLERANCE, **res)
    for key, limit in (("loss_rel_err", BF16_GRAD_TOLERANCE["loss"]),
                       ("grad_rel_err", BF16_GRAD_TOLERANCE["grad"])):
        if not res[key] <= limit:
            raise AssertionError(f"train_parity_bf16: {key} {res[key]} > "
                                 f"{limit} ({res['worst_grad']})")
    for name in TRAIN_KERNELS:
        if res["launches"][name] < 1:
            raise AssertionError(f"train_parity_bf16: kernel path did not "
                                 f"launch {name}: {res['launches']}")


#: train_resilience: the rollback drill's NaN step and length, the resume
#: drill's preempted step, length and cadence, and the timed steps of a
#: turn of the sentry's cost (each turn runs one untimed step first)
RESILIENCE_NAN_STEP, RESILIENCE_STEPS = 5, 10
PREEMPT_AT, PREEMPT_STEPS, PREEMPT_SAVE_EVERY = 4, 8, 3
SENTRY_TURN_STEPS = 20


def resilience_rig(config: str, batch: int, seq: int, device: str,
                   dropout: float = 0.0, amp_level: str = "O2"):
    """``build_train_step(config, to_static=False)``'s model, optimizer
    and batch, and ``make(sentry)``: the drill's body compiled with
    ``jit.to_static``, ``compute_loss(x, y) * w`` (``w`` an f32 ``[1]``
    loss weight, 1.0 unless a ``train.nan`` fault poisons it), backward,
    ``sentry.observe(loss, grad_norm=global_grad_norm(params))`` when a
    sentry is given, ``step`` and ``clear_grad``."""
    from paddle_tpu_torch import amp, build_train_step, jit
    from paddle_tpu_torch.distributed.fault_tolerance import (
        global_grad_norm,
    )

    ts = build_train_step(config, batch=batch, seq=seq, device=device,
                          dropout=dropout, amp_level=amp_level,
                          to_static=False)
    model, opt = ts.model, ts.optimizer

    def make(sentry=None):
        def body(x, y, w):
            with amp.auto_cast(dtype="bfloat16", level=amp_level):
                loss = model.compute_loss(x, y)
            loss = loss * w
            loss.backward()
            if sentry is not None:
                sentry.observe(loss, grad_norm=global_grad_norm(
                    model.parameters()))
            opt.step()
            opt.clear_grad()
            return loss.detach()
        return jit.to_static(body)

    def state_fn():
        return {"model": model.state_dict(), "opt": opt.state_dict()}

    def restore_fn(state):
        model.load_state_dict(state["model"])
        opt.set_state_dict(state["opt"])

    return ts, make, state_fn, restore_fn


def resilience_checksums(ts, sentry=None) -> torch.Tensor:
    """One int64 sum of the bits of each tensor of the training state, on
    the device: the parameters, every optimizer state tensor (f32 masters,
    moments, ``beta*_pow``), the sentry's window, counts and EMA, and the
    generators' ``[seed, offset]``."""
    from paddle_tpu_torch import rng

    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    def bits(t):
        t = t.detach()
        return t.view(view[t.element_size()]).sum(dtype=torch.int64)

    tensors = list(ts.model.state_dict().values())
    for st in ts.optimizer.state.values():
        tensors += [st[k] for k in sorted(st)
                    if isinstance(st[k], torch.Tensor)]
    if sentry is not None:
        sd = sentry.state_dict()
        tensors += [sd[k] for k in ("hist", "n", "gn", "gema")]
    dev = tensors[0].device
    tensors += [t.to(dev) for _, t in sorted(rng.get_rng_state().items())]
    return torch.stack([bits(t) for t in tensors])


def _state_tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _state_tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _state_tensors(v)]
    return []


def drive_train_resilience(config: str = "gpt2-345m", batch: int = 8,
                           seq: int = 1024, device: str = "cuda",
                           amp_level: str = "O2",
                           reference_loss=None) -> dict:
    """The three parts of ``train_resilience`` (``phase_train_resilience``
    holds them); every figure the phase prints.

    (a) The bench's rollback drill at ``config``: ``RESILIENCE_STEPS``
    steps under ``ResilientLoop`` with a ``DivergenceSentry``
    (``snapshot_every=2``, ``ring_capacity=2``, ``max_rollbacks=2``), a
    ``train.nan`` fault at ``RESILIENCE_NAN_STEP``, a ``StepTimeline`` and
    a ``CompileLedger``; then the oracle, a second model of the same seed
    run through the same schedule with that step skipped, and the
    sentry's cost: the oracle's step with and without the sentry in turns
    (no sentry, sentry, sentry, no sentry; an untimed step, then
    ``SENTRY_TURN_STEPS`` timed steps a turn, each step's host ms to its
    end: the sentry's poll, or a synchronize).  The cost is ``resolved``
    only where the sentry's median lies outside the no-sentry steps'
    quartiles; else the turns cannot tell it from the host's spread.  ``reference_loss``: the bench step's first loss
    (``build_train_step``'s), which the drill's first must equal (one is
    built when None).
    (c) A ``CostLedger`` of the oracle's warm sentry step.
    (b) Preemption at dropout 0.1: ``PADDLE_TPU_FT_DIE_AT_STEP`` sends
    SIGTERM at ``PREEMPT_AT`` to a loop saving every
    ``PREEMPT_SAVE_EVERY`` steps (``keep_last=1``); it commits and raises
    ``SystemExit(101)``; every tensor of the live state is then zeroed and
    a new loop on the same objects resumes and runs to ``PREEMPT_STEPS``;
    the oracle is a third model run ``PREEMPT_STEPS`` steps.  Launches are
    counted over all of it; those of the cost ledger's eager run (it
    launches K1-K3 as an eager step does) are also reported on their
    own."""
    from paddle_tpu_torch import build_train_step, obs, rng
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.fault_tolerance import (
        DivergenceSentry, FaultPlan, ResilientLoop,
    )
    from paddle_tpu_torch.ops import kernels

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    if reference_loss is None:
        ref = build_train_step(config, batch=batch, seq=seq, device=device,
                               amp_level=amp_level)
        reference_loss = float(ref.train_step(ref.x, ref.y))
        del ref
        free()
    kernels.reset_launches()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="train_resilience_") as tmp:
        # (a) the rollback drill
        kw = dict(snapshot_every=2, ring_capacity=2, max_rollbacks=2,
                  device=device)
        sentry = DivergenceSentry(**kw)
        ts, make, state_fn, restore_fn = resilience_rig(
            config, batch, seq, device, amp_level=amp_level)
        step = make(sentry)
        w = torch.ones(1, dtype=torch.float32, device=device)
        plan = FaultPlan().add_train_fault("train.nan",
                                           RESILIENCE_NAN_STEP)
        losses = {}

        def drill_step(i):
            losses[i] = step(ts.x, ts.y, plan.corrupt_batch(i, w))

        timeline, ledger = obs.StepTimeline(), obs.CompileLedger()
        loop = ResilientLoop(os.path.join(tmp, "drill"), state_fn,
                             restore_fn, save_every=None, save_final=False,
                             sentry=sentry, timeline=timeline,
                             compile_ledger=ledger, verbose=False)
        t0 = time.perf_counter()
        loop.run(drill_step, RESILIENCE_STEPS)
        sync()
        chrome = obs.chrome_trace(timeline)
        snaps = sentry.ring.taken
        snap_ms = [round((sp["t_end"] - sp["t_start"]) * 1e3, 3)
                   for _, sp in sorted(timeline.spans.items())
                   if sp["name"] == "snapshot_capture"]
        out["drill"] = {
            "counters": sentry.counters(),
            "seconds": round(time.perf_counter() - t0, 3),
            "first_loss": float(losses[0].reshape(-1)[0]),
            "reference_loss": reference_loss,
            "losses": [float(losses[i].reshape(-1)[0])
                       for i in sorted(losses)],
            "restore_ms": round(loop.last_rollback_recovery_s * 1e3, 3),
            "snapshot_ms_each": snap_ms,
            "snapshot_ms": _quartiles(snap_ms)["median"],
            "snapshots": snaps,
            "snapshot_gb": round(sentry.ring.nbytes() / 2 ** 30
                                 / max(len(sentry.ring), 1), 3),
            "programs": len(step.program_cache), "captures": step.captures,
            "compiles": ledger.stats(),
            "timeline_problems": obs.validate_timeline(timeline),
            "rolled_back_spans": sum(
                1 for e in chrome["traceEvents"] if e.get("ph") == "X"
                and e["args"]["state"] == "rolled_back"),
            "timeline": timeline.counters()}
        drill_sums = resilience_checksums(ts, sentry).cpu()
        sentry.ring.clear()
        del ts, make, step, loop, sentry, state_fn, restore_fn, timeline
        free()

        # the oracle: the same seed, step RESILIENCE_NAN_STEP skipped
        sentry_b = DivergenceSentry(**kw)
        tsb, make_b, _, _ = resilience_rig(config, batch, seq, device,
                                           amp_level=amp_level)
        step_b = make_b(sentry_b)
        for i in range(RESILIENCE_STEPS):
            if i != RESILIENCE_NAN_STEP:
                step_b(tsb.x, tsb.y, w)
                sentry_b.poll()
        sync()
        out["drill"]["bitwise"] = bool(torch.equal(
            drill_sums, resilience_checksums(tsb, sentry_b).cpu()))

        # the sentry's cost, in turns
        plain_b = make_b(None)
        for _ in range(2):                # its eager call and its capture
            plain_b(tsb.x, tsb.y, w)
        ms = {"no_sentry": [], "sentry": []}
        for name in ("no_sentry", "sentry", "sentry", "no_sentry"):
            f = step_b if name == "sentry" else plain_b
            for j in range(SENTRY_TURN_STEPS + 1):
                t0 = time.perf_counter()
                f(tsb.x, tsb.y, w)
                if name == "sentry":
                    sentry_b.poll()
                else:
                    sync()
                if j:
                    ms[name].append(
                        round((time.perf_counter() - t0) * 1e3, 3))
        out["sentry_cost"] = {k: {"step_ms": v, **_quartiles(v)}
                              for k, v in ms.items()}
        base, with_s = (out["sentry_cost"][k]
                        for k in ("no_sentry", "sentry"))
        out["sentry_cost"]["cost_pct"] = round(
            (with_s["median"] / base["median"] - 1) * 100, 3)
        out["sentry_cost"]["resolved"] = not (
            base["q1"] <= with_s["median"] <= base["q3"])

        # (c) the cost ledger of the warm sentry step
        n_params = sum(p.numel() for p in tsb.model.parameters())
        before = (len(step_b.program_cache), step_b.captures,
                  kernels.launch_counts())
        t0 = time.perf_counter()
        cost = obs.CostLedger(chip="h100").add(
            "train_step", step_b, tsb.x, tsb.y, w,
            tokens_per_step=batch * seq, n_params=n_params)
        out["cost"] = {**{k: cost[k] for k in (
            "flops", "bytes_accessed", "attention_flops", "attention_calls",
            "analytic_mfu", "bound", "roofline_step_ms",
            "arithmetic_intensity", "flops_vs_6nd", "model_flops_6nd",
            "op_counts", "fingerprint", "restored_tensors")},
            "n_params": n_params, "tokens_per_step": batch * seq,
            "seconds": round(time.perf_counter() - t0, 3),
            "new_programs": len(step_b.program_cache) - before[0],
            "new_captures": step_b.captures - before[1],
            "eager_run_launches": {n: c - before[2][n] for n, c
                         in kernels.launch_counts().items()
                         if c != before[2][n]}}
        del tsb, make_b, step_b, plain_b, sentry_b
        free()

        # (b) preemption and resume at dropout 0.1
        launches_b0 = kernels.launch_counts()
        ts2, make2, state_fn2, restore_fn2 = resilience_rig(
            config, batch, seq, device, dropout=RECIPE_DROPOUT,
            amp_level=amp_level)
        step2 = make2(None)
        root = os.path.join(tmp, "preempt")
        handler = signal.getsignal(signal.SIGTERM)
        tl2 = obs.StepTimeline()
        os.environ["PADDLE_TPU_FT_DIE_AT_STEP"] = str(PREEMPT_AT)
        try:
            loop1 = ResilientLoop(root, state_fn2, restore_fn2,
                                  save_every=PREEMPT_SAVE_EVERY, keep_last=1,
                                  timeline=tl2, verbose=False)
        finally:
            del os.environ["PADDLE_TPU_FT_DIE_AT_STEP"]
        exit_code = None
        try:
            loop1.run(lambda i: step2(ts2.x, ts2.y, w), PREEMPT_STEPS)
        except SystemExit as e:
            exit_code = e.code
        gens = ckpt.list_generations(root)
        path = ckpt.generation_dir(root, gens[-1])
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t0 = time.perf_counter()
        problems = ckpt.verify_checkpoint(path)
        verify_s = time.perf_counter() - t0
        # the resume must write every byte: zero the live state first
        with torch.no_grad():
            for t in _state_tensors(state_fn2()):
                t.zero_()
            for gen in rng._generators.values():
                gen._state.zero_()
        loop2 = ResilientLoop(root, state_fn2, restore_fn2, save_every=None,
                              save_final=False, verbose=False)
        completed = loop2.run(lambda i: step2(ts2.x, ts2.y, w),
                              PREEMPT_STEPS)
        sync()
        resumed = resilience_checksums(ts2).cpu()
        out["preempt"] = {
            "exit_code": exit_code, "generations": gens,
            "handler_restored": signal.getsignal(signal.SIGTERM) is handler,
            "commit_s": round(loop1.last_commit_s, 3),
            "commits_s_each": [
                round(sp["t_end"] - sp["t_start"], 3)
                for _, sp in sorted(tl2.spans.items())
                if sp["name"] == "checkpoint_commit"],
            "gb_written": round(nbytes / 1e9, 3),
            "verify_s": round(verify_s, 3), "verify_problems": problems,
            "resume_s": round(loop2.last_resume_s, 3),
            "completed": completed,
            "programs": len(step2.program_cache), "captures": step2.captures}
        del ts2, make2, step2, loop1, loop2, state_fn2, restore_fn2
        free()
        ts3, make3, _, _ = resilience_rig(config, batch, seq, device,
                                          dropout=RECIPE_DROPOUT,
                                          amp_level=amp_level)
        step3 = make3(None)
        for _ in range(PREEMPT_STEPS):
            step3(ts3.x, ts3.y, w)
        sync()
        out["preempt"]["bitwise"] = bool(torch.equal(
            resumed, resilience_checksums(ts3).cpu()))
        after = kernels.launch_counts()
        out["preempt"]["dropout_launches"] = {
            n: after[n] - launches_b0[n] for n in RECIPE_KERNELS}
        del ts3, make3, step3
        free()
    out["launches"] = kernels.launch_counts()
    return out


def phase_train_resilience(reference_loss=None) -> dict:
    """Training resilience on GPT-2 345M (bf16 O2, 8 x 1024) through one
    CUDA graph a step (``drive_train_resilience``).  Holds: one anomaly,
    rollback and skip; the rolled-back state bitwise equal to the oracle's
    and the drill's first loss to the bench step's; one program, one
    capture and no steady-state compile anomaly; a valid timeline with a
    ``rolled_back`` span in its Perfetto export; the preempted run exits
    101, its handler restored, its generation valid, and the resumed
    state bitwise equal to the uninterrupted run's; the cost ledger adds
    no program; K1-K3 (and their dropout instances) launched.  Returns
    the launch counts."""
    t0 = time.perf_counter()
    res = drive_train_resilience(reference_loss=reference_loss)
    seconds = round(time.perf_counter() - t0, 3)
    drill, pre, cost = res["drill"], res["preempt"], res["cost"]
    emit("train_resilience", part="a", model="gpt2-345m", batch=8, seq=1024,
         dtype="bfloat16 (AMP O2, f32 masters)",
         nan_step=RESILIENCE_NAN_STEP, steps=RESILIENCE_STEPS, **drill)
    emit("train_resilience", part="a_sentry_cost",
         turns="no_sentry sentry sentry no_sentry",
         steps_per_turn=SENTRY_TURN_STEPS, **res["sentry_cost"])
    emit("train_resilience", part="b", dropout=RECIPE_DROPOUT,
         preempt_at=PREEMPT_AT, steps=PREEMPT_STEPS,
         save_every=PREEMPT_SAVE_EVERY, keep_last=1, **pre)
    emit("train_resilience", part="c", chip="h100 (989e12 bf16 dense, "
         "3.35e12 B/s)", attention="K1-K3 by obs.cost.attention_cost",
         **cost)
    counters = drill["counters"]
    holds = {
        "anomalies_rollbacks_skips": (counters["anomalies"],
                                      counters["rollbacks"],
                                      counters["skipped_steps"]) == (1, 1, 1),
        "rollback_bitwise": drill["bitwise"],
        "first_loss_bitwise": drill["first_loss"] == drill["reference_loss"],
        "one_program_one_capture": (drill["programs"],
                                    drill["captures"]) == (1, 1),
        "no_steady_compile": drill["compiles"]["compiles"] == 1
        and drill["compiles"]["steady_state_misses"] == 0,
        "timeline_valid": drill["timeline_problems"] == [],
        "rolled_back_span": drill["rolled_back_spans"] >= 1,
        "preempt_exit_101": pre["exit_code"] == 101,
        "handler_restored": pre["handler_restored"],
        "generation_valid": pre["verify_problems"] == [],
        "resume_bitwise": pre["bitwise"],
        "dropout_kernels": all(v > 0 for v in
                               pre["dropout_launches"].values()),
        "cost_adds_no_program": cost["new_programs"] == 0
        and cost["new_captures"] == 0,
        "k1_k3_launched": all(res["launches"][n] > 0
                              for n in TRAIN_KERNELS),
    }
    emit("train_resilience", part="holds", seconds=seconds, **holds)
    broken = [k for k, ok in holds.items() if not ok]
    if broken:
        raise AssertionError(f"train_resilience: {broken} broken")
    return res["launches"]


#: PaddleNLP's ``bert-base-uncased`` (Devlin et al. 2019), the masked-LM
#: model ``nn_encoder`` trains: hidden 768, 12 layers of 12 heads (head
#: dim 64, a kernel head dim), FFN 3072, GELU, dropout 0.1, vocabulary
#: 30522, 512 positions, 2 token types
BERT_BASE = {"vocab_size": 30522, "hidden_size": 768,
             "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072, "max_position_embeddings": 512,
             "type_vocab_size": 2, "hidden_dropout_prob": 0.1,
             "attention_probs_dropout_prob": 0.1}
#: the share of positions a masked-LM batch predicts (the rest carry
#: ``ignore_index``)
MLM_SHARE = 0.15
#: the nn_encoder phase's shapes: the train batch, the cross-attention
#: call (batch, target and source lengths) and the f32 parity batch
NN_TRAIN = (8, 512)
NN_CROSS = (4, 128, 512)
NN_PARITY = (2, 256)
#: the flash kernels' bf16 dropout instances a training step launches
NN_TRAIN_KERNELS = tuple(f"{n}_dropout" for n in TRAIN_KERNELS)


def masked_lm(cfg: dict):
    """A BERT-shaped masked-LM model built from the port's ``nn`` only, as
    PaddleNLP's ``BertModel`` stacks it: word, position and token-type
    ``Embedding``s summed, ``LayerNorm`` (eps 1e-12) and ``Dropout``, a
    ``TransformerEncoder`` of ``TransformerEncoderLayer(hidden, heads,
    ffn, dropout, activation="gelu", attn_dropout, act_dropout=0)``, and
    an untied ``Linear`` head; ``forward(ids, types, labels)`` returns
    ``CrossEntropyLoss`` (ignore_index -100) over the labelled
    positions, without labels the logits.  Parameters are drawn from the
    port's init generator (seed it with ``paddle_tpu_torch.seed``) on
    torch's default device."""
    from paddle_tpu_torch import nn

    h = cfg["hidden_size"]

    class MaskedLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_embeddings = nn.Embedding(cfg["vocab_size"], h)
            self.position_embeddings = nn.Embedding(
                cfg["max_position_embeddings"], h)
            self.token_type_embeddings = nn.Embedding(
                cfg["type_vocab_size"], h)
            self.layer_norm = nn.LayerNorm(h, epsilon=1e-12)
            self.dropout = nn.Dropout(cfg["hidden_dropout_prob"])
            layer = nn.TransformerEncoderLayer(
                h, cfg["num_attention_heads"], cfg["intermediate_size"],
                dropout=cfg["hidden_dropout_prob"], activation="gelu",
                attn_dropout=cfg["attention_probs_dropout_prob"],
                act_dropout=0)
            self.encoder = nn.TransformerEncoder(layer,
                                                 cfg["num_hidden_layers"])
            self.head = nn.Linear(h, cfg["vocab_size"])
            self.loss = nn.CrossEntropyLoss()

        def forward(self, ids, types, labels=None):
            pos = torch.arange(ids.shape[1], device=ids.device)
            x = (self.word_embeddings(ids) + self.position_embeddings(pos)
                 + self.token_type_embeddings(types))
            logits = self.head(self.encoder(self.dropout(
                self.layer_norm(x))))
            return logits if labels is None else self.loss(logits, labels)

    return MaskedLM()


def mlm_batch(cfg: dict, batch: int, seq: int, device, seed: int = 0):
    """Seeded token ids, token types and labels (``MLM_SHARE`` of the
    positions keep their id, the rest -100)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg["vocab_size"], (batch, seq))
    types = rs.randint(0, cfg["type_vocab_size"], (batch, seq))
    labels = np.where(rs.rand(batch, seq) < MLM_SHARE, ids, -100)
    return tuple(torch.from_numpy(a).to(device) for a in (ids, types,
                                                          labels))


def build_masked_lm(cfg: dict, device, seed: int = 0):
    """``masked_lm(cfg)`` from ``seed`` on ``device`` at AMP O2 (bf16
    parameters, ``amp.decorate``) with AdamW (lr 1e-4), and its train
    step: the loss under ``amp.auto_cast(bfloat16, O2)``, backward, step,
    clear.  Returns ``(model, optimizer, step)``."""
    from paddle_tpu_torch import amp, device_guard, rng
    from paddle_tpu_torch.optimizer import AdamW

    rng.seed(seed)
    with device_guard(device):
        model = masked_lm(cfg)
    opt = AdamW(model.parameters(), lr=1e-4)
    model, opt = amp.decorate(model, opt, level="O2")

    def train_step(ids, types, labels):
        with amp.auto_cast(dtype="bfloat16", level="O2"):
            loss = model(ids, types, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return model, opt, train_step


def _counts():
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels

    return kernels.launch_counts(), dict(F.ATTENTION_ROUTES)


def _moved(before, after) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _step_ms(fn, cuda: bool):
    """``fn()``'s result and its milliseconds (CUDA events on the card,
    the host clock on the CPU)."""
    if not cuda:
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def drive_nn_encoder(cfg: dict, batch: int, seq: int, device: str,
                     warmup: int = 3, steps: int = 10) -> dict:
    """Train ``masked_lm(cfg)`` at O2 through ``jit.to_static`` (one CUDA
    graph a step on the card): ``warmup`` then ``steps`` timed steps on
    one seeded batch, after the same model's first ``TRAIN_EAGER_STEPS``
    steps run eagerly; then ``eval()`` and one forward under
    ``torch.no_grad()``, and its timing.  Returns the losses, the launch
    and route counts of each part, step and eval ms."""
    from paddle_tpu_torch import jit

    cuda = torch.device(device).type == "cuda"
    data = mlm_batch(cfg, batch, seq, device)
    model, _, eager_step = build_masked_lm(cfg, device)
    eager = [float(eager_step(*data)) for _ in range(TRAIN_EAGER_STEPS)]
    del model, eager_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    model, _, body = build_masked_lm(cfg, device)
    step = jit.to_static(body)
    before = _counts()
    losses, ms = [], []
    for i in range(warmup + steps):
        loss, t = _step_ms(lambda: step(*data), cuda)
        losses.append(loss)
        if i >= warmup:
            ms.append(t)
    after = _counts()
    losses = [float(v) for v in losses]
    res = {"params": sum(p.numel() for p in model.parameters()),
           "losses": losses, "eager_losses": eager,
           "eager_max_abs_diff": max(abs(a - b) for a, b in
                                     zip(losses, eager)),
           "program_cache": {"programs": len(step.program_cache),
                             "misses": step.misses, "hits": step.hits,
                             "captures": step.captures},
           "train_launches": _moved(before[0], after[0]),
           "train_routes": _moved(before[1], after[1]),
           "step_ms": _quartiles(ms),
           "tokens_per_s": batch * seq / (float(np.median(ms)) / 1e3)}
    if cuda:
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    model.eval()
    before = _counts()
    with torch.no_grad():
        logits = model(data[0], data[1])
    after = _counts()
    res["eval_launches"] = _moved(before[0], after[0])
    res["eval_routes"] = _moved(before[1], after[1])
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (
            batch, seq, cfg["vocab_size"]):
        raise AssertionError(f"nn_encoder: eval logits {logits.shape} "
                             f"finite={bool(torch.isfinite(logits).all())}")
    if cuda:
        with torch.no_grad():
            res["eval_ms"] = cuda_ms(lambda: model(data[0], data[1]),
                                     iters=5, warmup=1)
    return res


def check_nn_encoder(res: dict, layers: int, cuda: bool) -> None:
    """The train and eval holds of ``nn_encoder`` (see the phase)."""
    steps = len(res["losses"])
    if not all(np.isfinite(res["losses"])) or \
            not res["losses"][-1] < res["losses"][0]:
        raise AssertionError(f"nn_encoder: losses {res['losses']}")
    if res["eager_max_abs_diff"] != 0.0:
        raise AssertionError(
            f"nn_encoder: the compiled step's first losses "
            f"{res['losses'][:TRAIN_EAGER_STEPS]} differ from the eager "
            f"step's {res['eager_losses']}")
    if cuda and res["program_cache"] != {"programs": 1, "misses": 1,
                                         "hits": steps - 1, "captures": 1}:
        raise AssertionError(f"nn_encoder: program cache "
                             f"{res['program_cache']} (want one program, "
                             f"one capture)")
    if res["train_routes"].get("plain") or res["eval_routes"].get("plain"):
        raise AssertionError(f"nn_encoder: the plain attention route ran "
                             f"({res['train_routes']}, "
                             f"{res['eval_routes']})")
    if res["eval_routes"].get("kernel") != layers:
        raise AssertionError(f"nn_encoder: eval routes "
                             f"{res['eval_routes']}, want {layers} kernel")
    if not cuda:
        return
    want = {n: layers * steps for n in NN_TRAIN_KERNELS}
    if res["train_launches"] != want:
        raise AssertionError(f"nn_encoder: train launches "
                             f"{res['train_launches']}, want {want} "
                             f"(one per layer per step)")
    if res["eval_launches"] != {"flash_fwd": layers}:
        raise AssertionError(f"nn_encoder: eval launches "
                             f"{res['eval_launches']}, want flash_fwd "
                             f"{layers}")


def drive_nn_cross(cfg: dict, batch: int, tgt_len: int, src_len: int,
                   device: str, layers: int = 2) -> dict:
    """A ``layers``-layer ``nn.Transformer`` at ``cfg``'s widths (bf16,
    eval, dropout 0), one forward under ``torch.no_grad()`` with a causal
    target mask: the encoder's self-attention takes the kernel route,
    the decoder's masked self-attention and its cross-attention (``Sq !=
    Sk``) the plain one."""
    from paddle_tpu_torch import device_guard, nn

    with device_guard(device):
        model = nn.Transformer(
            cfg["hidden_size"], cfg["num_attention_heads"], layers, layers,
            cfg["intermediate_size"], dropout=0.0)
    model = model.to(dtype=torch.bfloat16).eval()
    gen = torch.Generator(device=device).manual_seed(0)
    src = torch.randn(batch, src_len, cfg["hidden_size"], generator=gen,
                      device=device, dtype=torch.bfloat16)
    tgt = torch.randn(batch, tgt_len, cfg["hidden_size"], generator=gen,
                      device=device, dtype=torch.bfloat16)
    mask = nn.Transformer.generate_square_subsequent_mask(tgt_len, device)
    before = _counts()
    with torch.no_grad():
        out = model(src, tgt, tgt_mask=mask)
    after = _counts()
    if not torch.isfinite(out).all() or tuple(out.shape) != tuple(tgt.shape):
        raise AssertionError(f"nn_encoder cross: output {out.shape}")
    res = {"launches": _moved(before[0], after[0]),
           "routes": _moved(before[1], after[1])}
    if res["routes"] != {"kernel": layers, "plain": 2 * layers}:
        raise AssertionError(f"nn_encoder cross: routes {res['routes']}, "
                             f"want {layers} kernel and {2 * layers} plain")
    if torch.device(device).type == "cuda" and \
            res["launches"] != {"flash_fwd": layers}:
        raise AssertionError(f"nn_encoder cross: launches "
                             f"{res['launches']}")
    return res


def drive_nn_parity(cfg: dict, batch: int, seq: int, device: str) -> dict:
    """``masked_lm`` at ``cfg``'s widths, 2 layers, dropout 0, f32: one
    forward and backward on ``device`` and on the CPU from the same
    weights and batch.  Returns the loss's relative difference and the
    largest gradient difference relative to its tensor's largest value,
    or to ``SIGNAL`` times the model's largest where that is larger (and
    which tensor), with the device run's launches."""
    import copy

    from paddle_tpu_torch import device_guard, rng
    from paddle_tpu_torch.ops import kernels

    small = {**cfg, "num_hidden_layers": 2, "hidden_dropout_prob": 0.0,
             "attention_probs_dropout_prob": 0.0}
    rng.seed(0)
    with device_guard("cpu"):
        ref = masked_lm(small)
    dev = copy.deepcopy(ref).to(device)
    runs = {}
    for name, model in (("cpu", ref), ("device", dev)):
        data = mlm_batch(small, batch, seq, "cpu" if model is ref
                         else device)
        kernels.reset_launches()
        loss = model(*data)
        loss.backward()
        runs[name] = (float(loss.detach()), {n: p.grad.cpu() for n, p in
                                    model.named_parameters()},
                      kernels.launch_counts())
    (ref_loss, ref_g, _), (loss, got_g, launches) = runs["cpu"], \
        runs["device"]
    # a tensor whose gradient is zero in exact arithmetic (k_proj.bias:
    # softmax ignores a constant added to a row's scores) holds rounding
    # noise only; each difference is taken relative to the larger of the
    # tensor's largest gradient and SIGNAL times the model's
    floor = SIGNAL * max(float(g.abs().max()) for g in ref_g.values())
    worst, where = 0.0, ""
    for n, g in ref_g.items():
        err = float((got_g[n] - g).abs().max()) / max(float(g.abs().max()),
                                                      floor)
        if err > worst:
            worst, where = err, n
    return {"loss": loss, "loss_rel_err": abs(loss - ref_loss)
            / abs(ref_loss), "grad_rel_err": worst, "worst_grad": where,
            "launches": {k: v for k, v in launches.items() if v}}


def phase_nn_encoder(cfg: dict = BERT_BASE, device: str = "cuda",
                     train=NN_TRAIN, cross=NN_CROSS,
                     parity=NN_PARITY) -> dict:
    """BERT-base's masked-LM model from the port's ``nn`` (``masked_lm``):
    (1) 13 train steps at O2 through one CUDA graph (3 warm-up: the eager
    call and the capture; one program, one capture; the first 3 losses
    bitwise the eager step's; finite, falling losses; K1-K3's bf16
    dropout instances launched once a layer a step; the plain route
    never); (2) ``eval()`` and one no-grad forward (the registered
    ``flash_fwd``, once a layer); (3) a 2-layer ``nn.Transformer``
    forward with a causal target mask (``drive_nn_cross``); (4) the f32
    card-vs-CPU parity of a 2-layer model (``drive_nn_parity``) within
    ``TRAIN_PARITY_TOLERANCE``.  Returns the train steps' launch
    counts."""
    t0 = time.perf_counter()
    layers = cfg["num_hidden_layers"]
    cuda = torch.device(device).type == "cuda"
    res = drive_nn_encoder(cfg, *train, device)
    check_nn_encoder(res, layers, cuda)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    res["cross"] = drive_nn_cross(cfg, *cross, device)
    par = drive_nn_parity(cfg, *parity, device)
    res["parity"] = par
    tol = TRAIN_PARITY_TOLERANCE
    if not (par["loss_rel_err"] <= tol["loss"]
            and par["grad_rel_err"] <= tol["grad"]):
        raise AssertionError(f"nn_encoder parity: {par} (tolerance "
                             f"{tol})")
    if cuda and not all(par["launches"].get(n) for n in TRAIN_KERNELS):
        raise AssertionError(f"nn_encoder parity: launches "
                             f"{par['launches']}")
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit("nn_encoder", model="bert-base-uncased masked LM (port nn)",
         dtype="bfloat16 (AMP O2, f32 masters)", batch=train[0],
         seq=train[1], layers=layers, cross_shape=list(cross),
         parity_shape=list(parity), parity_tolerance=tol, **res)
    return res


# ---- seq2seq: PaddleNLP's LSTM attention translator through paddle.Model --

#: PaddleNLP ``examples/machine_translation/seq2seq`` at its README's
#: train and predict settings on IWSLT'15 English-Vietnamese: vocabularies
#: of 17,191 and 7,709 tokens, embeddings and hidden 512, 2 LSTM layers,
#: dropout 0.2, uniform init ±0.1, batch 128, Adam at 1e-3 with
#: ``ClipGradByGlobalNorm(5.0)``, beam 10, at most 50 decoded steps;
#: sentences of 10–50 tokens (the corpus is absent: seeded ids), BOS 1,
#: EOS 2 (also the padding)
SEQ2SEQ = {"src_vocab": 17191, "trg_vocab": 7709, "embed": 512,
           "hidden": 512, "layers": 2, "dropout": 0.2, "init_scale": 0.1,
           "batch": 128, "beam": 10, "max_out": 50, "lr": 1e-3,
           "max_grad_norm": 5.0, "min_len": 10, "max_len": 50, "bos": 1,
           "eos": 2}
#: ``Model.fit`` iterations: the warm-up, then the timed ones
SEQ2SEQ_ITERS = (3, 10)
#: the CPU twin's train steps, and the holds against it: the first losses
#: (relative), the beam scores (relative to max(1, |score|)) and the
#: K-th/(K+1)-th score margin past which ids must agree
SEQ2SEQ_TWIN_STEPS = 3
SEQ2SEQ_TOLERANCE = {"loss": 1e-4, "score": 1e-4, "margin": 1e-4}
#: the DataLoader's worker processes
SEQ2SEQ_WORKERS = 2


class Seq2SeqPairs:
    """Seeded translation pairs (numpy only: the loader's workers import
    this module).  Source lengths are uniform in ``[min_len, max_len]``,
    target contents in ``[min_len, max_len - 1]`` (so that BOS + content
    and content + EOS fit ``max_len`` steps); ids are uniform past EOS;
    every row is padded with EOS to ``max_len``.  Sample ``i`` is
    ``((src, src_len, trg_in), (trg_out, trg_mask))``."""

    def __init__(self, cfg: dict, n: int, seed: int = 0):
        rs = np.random.RandomState(seed)
        L, eos = cfg["max_len"], cfg["eos"]
        self.src_len = rs.randint(cfg["min_len"], L + 1, n).astype(np.int64)
        trg_len = rs.randint(cfg["min_len"], L, n)
        src = rs.randint(eos + 1, cfg["src_vocab"], (n, L))
        trg = rs.randint(eos + 1, cfg["trg_vocab"], (n, L))
        cols = np.arange(L)[None, :]
        self.src = np.where(cols < self.src_len[:, None], src, eos)
        content = np.where(cols < trg_len[:, None], trg, eos)
        self.trg_in = np.concatenate(
            [np.full((n, 1), cfg["bos"]), content[:, :-1]], 1)
        self.trg_out = content                  # content, then EOS
        self.trg_mask = (cols <= trg_len[:, None]).astype(np.float32)

    def __getitem__(self, i):
        return ((self.src[i], self.src_len[i], self.trg_in[i]),
                (self.trg_out[i], self.trg_mask[i]))

    def __len__(self):
        return len(self.src)


def seq2seq_model(cfg: dict):
    """PaddleNLP's ``Seq2SeqAttnModel`` from the port's ``nn``: source and
    target ``Embedding``s, the encoder ``nn.LSTM(embed, hidden, layers,
    dropout)``, a decoder cell of ``layers`` ``LSTMCell``s (the first fed
    ``[embedding; previous attention output]``, each output through
    ``Dropout``) and a dot-product attention of the top state over the
    projected encoder outputs (masked past each source length), giving
    ``tanh(Linear([context; h]))``; then the bias-free vocabulary
    projection.  Embeddings and linears are drawn from ``Uniform(±0.1)``,
    the LSTMs from their default.  The example projects the encoder
    outputs inside the cell, at every step; here once a batch
    (``encode``), the same values.  The decoder's time loop is a Python
    loop over the cell, as ``BeamSearchDecoder`` drives it."""
    from paddle_tpu_torch import nn

    s, E, H, layers = (cfg["init_scale"], cfg["embed"], cfg["hidden"],
                       cfg["layers"])

    def uniform():
        return nn.ParamAttr(initializer=nn.initializer.Uniform(-s, s))

    class AttentionLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_proj = nn.Linear(H, H, weight_attr=uniform(),
                                        bias_attr=False)
            self.output_proj = nn.Linear(2 * H, H, weight_attr=uniform(),
                                         bias_attr=False)

        def forward(self, hidden, keys, mask):
            scores = torch.matmul(hidden.unsqueeze(1),
                                  keys.transpose(1, 2)) + mask
            ctx = torch.matmul(torch.softmax(scores, dim=-1), keys)
            return torch.tanh(self.output_proj(
                torch.cat([ctx.squeeze(1), hidden], dim=1)))

    class DecoderCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = H
            self.dropout = nn.Dropout(cfg["dropout"])
            self.lstm_cells = nn.LayerList([
                nn.LSTMCell(E + H if i == 0 else H, H)
                for i in range(layers)])
            self.attention_layer = AttentionLayer()

        def forward(self, step_input, states, encoder_output,
                    encoder_padding_mask):
            lstm_states, input_feed = states
            x = torch.cat([step_input, input_feed], dim=1)
            new_states = []
            for i, cell in enumerate(self.lstm_cells):
                out, st = cell(x, lstm_states[i])
                x = self.dropout(out)
                new_states.append(st)
            out = self.attention_layer(x, encoder_output,
                                       encoder_padding_mask)
            return out, [new_states, out]

    class Seq2SeqAttnModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedder = nn.Embedding(cfg["src_vocab"], E,
                                             weight_attr=uniform())
            self.encoder = nn.LSTM(E, H, num_layers=layers,
                                   dropout=cfg["dropout"] if layers > 1
                                   else 0.0)
            self.trg_embedder = nn.Embedding(cfg["trg_vocab"], E,
                                             weight_attr=uniform())
            self.cell = DecoderCell()
            self.output_layer = nn.Linear(H, cfg["trg_vocab"],
                                          weight_attr=uniform(),
                                          bias_attr=False)

        def encode(self, src, src_len):
            """The attention keys (projected encoder outputs), the
            decoder's first states (the encoder's final ones, a zero
            attention output) and the additive source mask ``[B, 1, S]``."""
            out, (h, c) = self.encoder(self.src_embedder(src),
                                       sequence_length=src_len)
            states = [[(h[i], c[i]) for i in range(layers)],
                      self.cell.get_initial_states(out)]
            cols = torch.arange(src.shape[1], device=src.device)
            mask = torch.where(cols[None, :] < src_len[:, None], 0.0,
                               -1e9)[:, None, :]
            return self.cell.attention_layer.input_proj(out), states, mask

        def forward(self, src, src_len, trg):
            keys, states, mask = self.encode(src, src_len)
            emb = self.trg_embedder(trg)
            outs = []
            for t in range(trg.shape[1]):
                out, states = self.cell(emb[:, t], states, keys, mask)
                outs.append(out)
            return self.output_layer(torch.stack(outs, dim=1))

    return Seq2SeqAttnModel()


def seq2seq_loss(logits, label, mask):
    """The example's ``CrossEntropyCriterion``: token cross-entropy times
    the target mask, averaged over the batch and summed over the steps."""
    from paddle_tpu_torch.nn import functional as F

    cost = F.cross_entropy(logits, label, reduction="none")
    return (cost * mask).mean(dim=0).sum()


def perplexity_metric(eos: int):
    """The example's perplexity as a ``metric.Metric``: exp of the summed
    token cross-entropy over the target tokens (each target's tokens run
    through its first EOS); one host read a batch."""
    from paddle_tpu_torch.metric import Metric
    from paddle_tpu_torch.nn import functional as F

    class Perplexity(Metric):
        def __init__(self):
            self.reset()

        def reset(self):
            self.total, self.words = 0.0, 0

        def name(self):
            return "ppl"

        def compute(self, pred, label):
            is_eos = (label == eos).long()
            valid = (torch.cumsum(is_eos, dim=1) - is_eos) == 0
            ce = F.cross_entropy(pred.float(), label, reduction="none")
            return torch.stack([(ce * valid).sum(),
                                valid.sum().float()]).tolist()

        def update(self, stats):
            self.total += stats[0]
            self.words += int(stats[1])

        def accumulate(self):
            return float(np.exp(self.total / max(self.words, 1)))

    return Perplexity()


def step_clock():
    """A ``hapi`` callback keeping each train batch's loss and its host
    milliseconds (``on_train_batch_begin`` to ``_end``: the step and its
    loss read, which waits for the card), and the seconds from the start
    of training to the first batch (a loader's workers start in them)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            super().__init__()
            self.ms, self.losses, self._t0 = [], [], None
            #: seconds from the start of training to its first batch
            self.start_s = None

        def on_train_begin(self, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            if self.start_s is None:
                self.start_s = time.perf_counter() - self._t0
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.ms.append((time.perf_counter() - self._t0) * 1e3)
            self.losses.append(logs["loss"])

    return StepClock()


def seq2seq_trainer(net, cfg: dict):
    """``paddle.Model(net)`` prepared as the example prepares it."""
    from paddle_tpu_torch import Model, nn
    from paddle_tpu_torch.optimizer import Adam

    opt = Adam(net.parameters(), lr=cfg["lr"],
               grad_clip=nn.ClipGradByGlobalNorm(cfg["max_grad_norm"]))
    return Model(net).prepare(opt, seq2seq_loss,
                              metrics=perplexity_metric(cfg["eos"]))


def margin_beam_search():
    """``nn.BeamSearchDecoder`` that keeps, a step, the K+1 best scores of
    each row (to find the near-ties) and the raw step outputs before the
    backtrace."""
    from paddle_tpu_torch import nn

    class MarginBeamSearch(nn.BeamSearchDecoder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.tops, self.raw = [], None

        def _top_k(self, flat, k):
            scores, idx = super()._top_k(flat, k + 1)
            self.tops.append(scores)
            return scores[:, :k], idx[:, :k]

        def finalize(self, outputs, final_states, sequence_lengths):
            self.raw = outputs
            return super().finalize(outputs, final_states, sequence_lengths)

    return MarginBeamSearch


def beam_decode(net, cfg: dict, src, src_len):
    """The example's inference: encode, tile keys and mask by the beam
    (``tile_beam_merge_with_batch``), ``BeamSearchDecoder(cell, BOS, EOS,
    beam, embedding_fn=, output_fn=)`` and ``dynamic_decode(max_step_num=
    max_out)`` with the keys and mask as the cell's kwargs.  Returns the
    decoder (its ``tops`` and ``raw``) and the backtraced ids ``[B, T,
    K]``."""
    from paddle_tpu_torch import nn

    K = cfg["beam"]
    net.eval()
    with torch.no_grad():
        keys, states, mask = net.encode(src, src_len)
        tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
        dec = margin_beam_search()(
            net.cell, cfg["bos"], cfg["eos"], K,
            embedding_fn=net.trg_embedder, output_fn=net.output_layer)
        seqs, _ = nn.dynamic_decode(
            dec, inits=states, max_step_num=cfg["max_out"],
            encoder_output=tile(keys, K), encoder_padding_mask=tile(mask, K))
    return dec, seqs


def backtrace(ids: np.ndarray, parents: np.ndarray) -> np.ndarray:
    """``gather_tree`` in numpy: ``[T, B, K]`` ids and parents to each
    final beam's sequence."""
    T, B, K = ids.shape
    out = np.empty_like(ids)
    beam = np.tile(np.arange(K), (B, 1))
    rows = np.arange(B)[:, None]
    for t in range(T - 1, -1, -1):
        out[t] = ids[t][rows, beam]
        beam = parents[t][rows, beam]
    return out


def compare_beams(dev, ref, tol: dict) -> dict:
    """Hold ``dev``'s beam search to ``ref``'s (the CPU twin's, over the
    first rows and steps of ``dev``'s) where it is decided: row b at step
    t counts while every step up to t had, in ``ref``, all gaps among its
    K+1 best scores above ``tol["margin"]`` (past a near-tie the two may
    take either branch).  There ids and parents must be equal and scores
    within ``tol["score"]`` of max(1, |score|).  Returns the counts."""
    r_ids = ref.raw.predicted_ids.cpu().numpy()
    T, B, _ = r_ids.shape

    def dev_rows(t):
        return t[:T, :B].cpu().numpy()

    d_ids, d_par, d_sc = (dev_rows(getattr(dev.raw, f)) for f in (
        "predicted_ids", "parent_ids", "scores"))
    r_par, r_sc = (getattr(ref.raw, f).cpu().numpy() for f in (
        "parent_ids", "scores"))
    if d_ids.shape != r_ids.shape:
        raise AssertionError(f"seq2seq decode: the device ran "
                             f"{d_ids.shape[0]} steps of rows the CPU "
                             f"decoded in {T}")
    gaps = np.stack([(-np.diff(t.cpu().numpy(), axis=1)).min(axis=1)
                     for t in ref.tops])                        # [T, B]
    decided = np.logical_and.accumulate(gaps > tol["margin"], axis=0)
    where = np.broadcast_to(decided[:, :, None], r_ids.shape)
    bad_ids = int(((r_ids != d_ids) | (r_par != d_par))[where].sum())
    err = np.abs(d_sc - r_sc) / np.maximum(1.0, np.abs(r_sc))
    worst = float(err[where].max()) if where.any() else 0.0
    if bad_ids or worst > tol["score"]:
        raise AssertionError(
            f"seq2seq decode: {bad_ids} decided ids or parents differ from "
            f"the CPU twin's; worst decided score error {worst:.3e} "
            f"(tolerance {tol})")
    return {"decided_share": round(float(decided.mean()), 4),
            "rows_decided_to_the_end": int(decided[-1].sum()),
            "score_rel_err": worst}


def device_profile(fn) -> dict:
    """What ``fn()`` puts on the card (kernels, copies and fills), counted
    by ``torch.profiler``, and the milliseconds the card was busy with
    them (their union); the card idles 50 ms at the window's start (the
    profiler can lose a window's first records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        raise RuntimeError("the profiler recorded no device time")
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    return {"launches": len(spans), "busy_ms": (busy + hi - lo) / 1e3}


#: source rows the CPU copy decodes (rows are independent: the card's
#: first rows are held to them)
SEQ2SEQ_CPU_ROWS = 16


def decode_and_compare(net, cpu_net, cfg: dict, data: Seq2SeqPairs,
                       device) -> dict:
    """Beam-decode the first batch of ``data`` with ``net`` on ``device``
    and its first ``SEQ2SEQ_CPU_ROWS`` rows with ``cpu_net`` (the same
    weights on the CPU); hold ``gather_tree``'s sequences to the parents'
    backtrace and the device's decided beams to the CPU's
    (``compare_beams``).  Returns ms, steps and the comparison."""
    cuda = torch.device(device).type == "cuda"
    B, rows = cfg["batch"], min(SEQ2SEQ_CPU_ROWS, cfg["batch"])
    src, src_len = (torch.from_numpy(a[:B]) for a in (data.src,
                                                      data.src_len))
    (dec, seqs), ms = _step_ms(
        lambda: beam_decode(net, cfg, src.to(device), src_len.to(device)),
        cuda)
    ids = dec.raw.predicted_ids.cpu().numpy()
    if not np.array_equal(seqs.transpose(0, 1).cpu().numpy(),
                          backtrace(ids, dec.raw.parent_ids.cpu().numpy())):
        raise AssertionError("seq2seq decode: gather_tree's sequences "
                             "disagree with the parents' backtrace")
    if not torch.isfinite(dec.raw.scores).all():
        raise AssertionError("seq2seq decode: non-finite beam scores")
    ref, _ = beam_decode(cpu_net, cfg, src[:rows], src_len[:rows])
    return {"ms": round(ms, 3), "steps": int(ids.shape[0]),
            "cpu_rows": rows, **compare_beams(dec, ref, SEQ2SEQ_TOLERANCE)}


def drive_seq2seq(cfg: dict, device: str, iters=SEQ2SEQ_ITERS,
                  workers: int = SEQ2SEQ_WORKERS,
                  twin_steps: int = SEQ2SEQ_TWIN_STEPS) -> dict:
    """Train ``seq2seq_model(cfg)`` on ``device`` through ``Model.fit``
    over a ``DataLoader`` of ``workers`` processes (shared-memory ring),
    ``sum(iters)`` batches, with a ``StepTimeline``; hold its first
    ``twin_steps`` losses to the same model's CPU twin (from the same
    weights and generator seed); then beam-decode the first batch on the
    device and on a CPU copy of the trained model.  Returns the figures."""
    import copy

    from paddle_tpu_torch import device_guard, io, obs, rng

    cuda = torch.device(device).type == "cuda"
    warm, timed = iters
    B = cfg["batch"]
    data = Seq2SeqPairs(cfg, B * (warm + timed))
    rng.seed(0)
    with device_guard(device):
        net = seq2seq_model(cfg)
    twin_net = copy.deepcopy(net).to("cpu")
    # the untrained model's beams do not end: a full-length decode
    res = {"decode_untrained": decode_and_compare(net, twin_net, cfg, data,
                                                  device)}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    model = seq2seq_trainer(net, cfg)
    loader = io.DataLoader(data, batch_size=B, num_workers=workers,
                           timeout=300)
    clock, tl = step_clock(), obs.StepTimeline()
    before = _counts()
    rng.seed(0)
    t0 = time.perf_counter()
    model.fit(loader, epochs=1, verbose=0, num_iters=warm + timed,
              timeline=tl, callbacks=[clock])
    fit_s = time.perf_counter() - t0
    after = _counts()
    res.update({"params": sum(p.numel() for p in net.parameters()),
           "losses": clock.losses, "transport": dict(loader.transport),
           "launches": _moved(before[0], after[0]),
           "routes": _moved(before[1], after[1]),
           "fit_s": round(fit_s, 3), "ppl": model._metrics[0].accumulate(),
           "warmup_step_ms": [round(t, 3) for t in clock.ms[:warm]],
           "start_s": round(clock.start_s, 3)})
    ms = clock.ms[warm:]
    res["step_ms"] = _quartiles(ms)
    tokens = float(data.trg_mask[B * warm:].sum()) / timed
    res["target_tokens_per_s"] = round(tokens / (float(np.median(ms))
                                                 / 1e3), 1)
    phases = {ph: 0.0 for ph in ("data_fetch", "step_dispatch",
                                 "device_wait")}
    for sp in tl.spans.values():
        step = sp["trace"].rpartition(":s")[2]
        if sp["name"] in phases and step.isdigit() and int(step) >= warm:
            phases[sp["name"]] += sp["t_end"] - sp["t_start"]
    res["data_fetch_share"] = round(phases["data_fetch"]
                                    / sum(phases.values()), 5)
    res["warmup_fetch_s"] = round(tl.phase_seconds["data_fetch"]
                                  - phases["data_fetch"], 3)
    if twin_steps:
        twin, tclock = seq2seq_trainer(twin_net, cfg), step_clock()
        rng.seed(0)
        twin.fit(data, batch_size=B, epochs=1, verbose=0, shuffle=False,
                 num_iters=twin_steps, callbacks=[tclock])
        res["twin_losses"] = tclock.losses
        res["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(
            clock.losses[:twin_steps], tclock.losses))
    if cuda:
        x, y = next(iter(io.DataLoader(data, batch_size=B)))
        prof = device_profile(lambda: model.train_batch(x, y))
        res["launches_per_step"] = prof["launches"]
        res["device_busy_ms"] = round(prof["busy_ms"], 3)
        res["idle_share"] = round(1.0 - prof["busy_ms"]
                                  / res["step_ms"]["median"], 4)
    res["decode"] = decode_and_compare(net, copy.deepcopy(net).to("cpu"),
                                       cfg, data, device)
    if cuda:
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def check_seq2seq(res: dict, n_batches: int, workers: int) -> None:
    """The train holds of ``seq2seq`` (the decode's are in
    ``drive_seq2seq``)."""
    if not np.all(np.isfinite(res["losses"])):
        raise AssertionError(f"seq2seq: losses {res['losses']}")
    if res.get("loss_rel_err", 0.0) > SEQ2SEQ_TOLERANCE["loss"]:
        raise AssertionError(
            f"seq2seq: the first losses {res['losses'][:3]} differ from the "
            f"CPU twin's {res['twin_losses']} by {res['loss_rel_err']:.3e} "
            f"(tolerance {SEQ2SEQ_TOLERANCE['loss']})")
    want = {"ring": n_batches, "queue": 0} if workers else \
        {"ring": 0, "queue": 0}
    if res["transport"] != want:
        raise AssertionError(f"seq2seq: batches came {res['transport']}, "
                             f"want {want} (every batch through the "
                             f"shared-memory ring)")


def phase_seq2seq(cfg: dict = SEQ2SEQ, device: str = "cuda",
                  iters=SEQ2SEQ_ITERS, workers: int = SEQ2SEQ_WORKERS
                  ) -> dict:
    """PaddleNLP's LSTM attention translator at its published widths
    (``SEQ2SEQ``), f32 as the example trains: ``Model.fit`` over a
    2-worker ``DataLoader`` for 13 batches (every one through the
    shared-memory ring) with a ``StepTimeline``, its first 3 losses within
    1e-4 of a CPU twin's; then beam search (beam 10, at most 50 steps) over
    one batch of 128, on the card and on a CPU copy: the decided ids and
    parents equal, scores within 1e-4, ``gather_tree``'s sequences those
    of the parents' backtrace.  Prints the step's milliseconds, target
    tokens/s, launches a step, the ``data_fetch`` share, the decode's
    milliseconds and steps, and the peak memory."""
    t0 = time.perf_counter()
    res = drive_seq2seq(cfg, device, iters, workers)
    check_seq2seq(res, sum(iters), workers)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit("seq2seq", model="PaddleNLP seq2seq attention (IWSLT'15 en-vi "
         "widths, port nn)", dtype="float32", cfg=cfg, iters=list(iters),
         workers=workers, tolerance=SEQ2SEQ_TOLERANCE, **res)
    return res


# ---- hapi_fit: BERT-base's masked LM through paddle.Model -----------------

#: hapi_fit's shapes: batches of 8 x 512 with 80 predicted positions a
#: sample (BERT's ``max_predictions_per_seq`` at 512), 6 train batches, 2
#: eval batches, 1 predict batch
HAPI_FIT = {"batch": 8, "seq": 512, "predictions": 80, "train": 6,
            "eval": 2, "predict": 1}


class MlmSamples:
    """Seeded masked-LM samples (numpy only): ids, token types, ``P``
    sorted positions a sample and the ids there as labels.  Sample ``i``
    is ``((ids, types, positions), labels)``."""

    def __init__(self, cfg: dict, n: int, seq: int, predictions: int,
                 seed: int = 0):
        rs = np.random.RandomState(seed)
        self.ids = rs.randint(0, cfg["vocab_size"], (n, seq))
        self.types = rs.randint(0, cfg["type_vocab_size"], (n, seq))
        self.pos = np.sort(np.stack([rs.choice(seq, predictions,
                                               replace=False)
                                     for _ in range(n)]), axis=1)
        self.labels = np.take_along_axis(self.ids, self.pos, axis=1)

    def __getitem__(self, i):
        return (self.ids[i], self.types[i], self.pos[i]), self.labels[i]

    def __len__(self):
        return len(self.ids)


def mlm_predictions(cfg: dict):
    """``masked_lm(cfg)``'s layers with BERT pre-training's head input:
    ``forward(ids, types, positions)`` gives the logits at the
    ``positions`` only, ``[B, P, vocab]``."""
    from paddle_tpu_torch import nn

    class MaskedLMPredictions(nn.Layer):
        def __init__(self):
            super().__init__()
            self.mlm = masked_lm(cfg)

        def forward(self, ids, types, positions):
            m = self.mlm
            pos = torch.arange(ids.shape[1], device=ids.device)
            x = (m.word_embeddings(ids) + m.position_embeddings(pos)
                 + m.token_type_embeddings(types))
            h = m.encoder(m.dropout(m.layer_norm(x)))
            h = h.gather(1, positions[..., None].expand(-1, -1, h.shape[-1]))
            return m.head(h)

    return MaskedLMPredictions()


def mlm_loss(logits, labels):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits.float(), labels)


def build_hapi_mlm(cfg: dict, device, seed: int = 0):
    """``mlm_predictions(cfg)`` from ``seed`` at AMP O2 (bf16 parameters)
    with AdamW on a ``LinearWarmup`` rate, in ``paddle.Model`` prepared
    with the masked-LM loss, ``Accuracy`` and O2 bf16."""
    from paddle_tpu_torch import Model, amp, device_guard, metric, rng
    from paddle_tpu_torch.optimizer import AdamW, lr

    rng.seed(seed)
    with device_guard(device):
        net = mlm_predictions(cfg)
    opt = AdamW(net.parameters(), lr=lr.LinearWarmup(
        learning_rate=1e-4, warmup_steps=10, start_lr=0.0, end_lr=1e-4))
    net, opt = amp.decorate(net, opt, level="O2")
    return Model(net).prepare(opt, mlm_loss, metrics=metric.Accuracy(),
                              amp_configs={"level": "O2"})


def _states_equal(a, b) -> bool:
    """Two (nested) state dicts hold the same keys and bitwise tensors."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _states_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_states_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a.cpu(), b.cpu())
    return a == b


def drive_hapi_fit(cfg: dict, device: str, shape: dict = HAPI_FIT) -> dict:
    """``build_hapi_mlm`` trained through ``Model.fit`` (``shape["train"]``
    batches, an ``eval_data`` of ``shape["eval"]`` batches at the epoch's
    end) with ``ModelCheckpoint`` (its final save only), ``LRScheduler``
    and ``EarlyStopping`` armed; then ``evaluate``, ``predict``, a fresh
    model's ``load`` of the checkpoint (bitwise, the optimizer too) and
    ``summary``.  Returns the launch and route counts of each part, the ms
    a batch and the counts."""
    import contextlib
    import io as stdio
    import os

    from paddle_tpu_torch.hapi import callbacks as cbs
    from paddle_tpu_torch.io import DataLoader

    cuda = torch.device(device).type == "cuda"
    B, S, P = shape["batch"], shape["seq"], shape["predictions"]
    train = MlmSamples(cfg, B * shape["train"], S, P, seed=0)
    evals = MlmSamples(cfg, B * shape["eval"], S, P, seed=1)
    preds = MlmSamples(cfg, B * shape["predict"], S, P, seed=2)
    model = build_hapi_mlm(cfg, device)
    sched = model._optimizer._learning_rate
    clock = step_clock()
    res = {"params": sum(p.numel() for p in model.network.parameters())}
    with tempfile.TemporaryDirectory() as tmp:
        before = _counts()
        model.fit(train, eval_data=evals, batch_size=B, epochs=1,
                  verbose=0, shuffle=False, callbacks=[
                      cbs.ModelCheckpoint(save_freq=2, save_dir=tmp),
                      cbs.LRScheduler(),
                      cbs.EarlyStopping(monitor="loss", patience=2,
                                        verbose=0), clock])
        after = _counts()
        res["fit_launches"] = _moved(before[0], after[0])
        res["fit_routes"] = _moved(before[1], after[1])
        res["losses"] = clock.losses
        res["batch_ms"] = _quartiles(clock.ms[1:])
        res["first_batch_ms"] = round(clock.ms[0], 3)
        res["lr_steps"] = sched.last_epoch
        before = _counts()
        res["eval_logs"] = model.evaluate(evals, batch_size=B, verbose=0)
        after = _counts()
        res["eval_launches"] = _moved(before[0], after[0])
        res["eval_routes"] = _moved(before[1], after[1])
        before = _counts()
        out = model.predict(preds, batch_size=B)
        after = _counts()
        res["predict_launches"] = _moved(before[0], after[0])
        res["predict_routes"] = _moved(before[1], after[1])
        logits = out[0][0]
        if logits.shape != (B, P, cfg["vocab_size"]) or \
                not np.isfinite(logits).all():
            raise AssertionError(f"hapi_fit: predict gave {logits.shape}, "
                                 f"finite={bool(np.isfinite(logits).all())}")
        fresh = build_hapi_mlm(cfg, device, seed=1)
        t0 = time.perf_counter()
        fresh.load(os.path.join(tmp, "final"))
        res["load_s"] = round(time.perf_counter() - t0, 3)
        res["checkpoint_gb"] = round(sum(
            os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
            / 1e9, 3)
        res["load_bitwise"] = (
            _states_equal(model.network.state_dict(),
                          fresh.network.state_dict())
            and _states_equal(model._optimizer.state_dict(),
                              fresh._optimizer.state_dict()))
        del fresh
    with contextlib.redirect_stdout(stdio.StringIO()) as table:
        info = model.summary(input_size=[(1, S), (1, S), (1, P)],
                             dtype=["int64"] * 3)
    res["summary"] = {**info, "rows": table.getvalue().count("\n")}
    res["stop_training"] = model.stop_training
    if cuda:
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        x, y = next(iter(DataLoader(train, batch_size=B)))
        prof = device_profile(lambda: model.train_batch(x, y))
        res["launches_per_batch"] = prof["launches"]
        res["device_busy_ms"] = round(prof["busy_ms"], 3)
        res["idle_share"] = round(1.0 - prof["busy_ms"]
                                  / res["batch_ms"]["median"], 4)
    return res


def check_hapi_fit(res: dict, cfg: dict, shape: dict, cuda: bool) -> None:
    """The holds of ``hapi_fit`` (see the phase)."""
    layers = cfg["num_hidden_layers"]
    if len(res["losses"]) != shape["train"] or \
            not np.all(np.isfinite(res["losses"])):
        raise AssertionError(f"hapi_fit: losses {res['losses']}")
    if res["lr_steps"] != shape["train"]:
        raise AssertionError(f"hapi_fit: LRScheduler stepped "
                             f"{res['lr_steps']} times")
    if not res["load_bitwise"]:
        raise AssertionError("hapi_fit: the loaded model or optimizer "
                             "differs from the saved one")
    want = 132_363_066 if cfg == BERT_BASE else res["params"]
    if res["summary"]["total_params"] != want or res["params"] != want:
        raise AssertionError(f"hapi_fit: summary counts "
                             f"{res['summary']} ({res['params']} "
                             f"parameters), want {want}")
    for part in ("fit", "eval", "predict"):
        if res[f"{part}_routes"].get("plain"):
            raise AssertionError(f"hapi_fit: the plain attention route ran "
                                 f"in {part} ({res[f'{part}_routes']})")
    if not cuda:
        return
    want = {**{n: layers * shape["train"] for n in NN_TRAIN_KERNELS},
            "flash_fwd": layers * shape["eval"]}
    if res["fit_launches"] != want:
        raise AssertionError(f"hapi_fit: fit launches {res['fit_launches']}"
                             f", want {want} (12 a train batch each, K1 12 "
                             f"an eval batch)")
    for part in ("eval", "predict"):
        want = {"flash_fwd": layers * shape[part]}
        if res[f"{part}_launches"] != want:
            raise AssertionError(f"hapi_fit: {part} launches "
                                 f"{res[f'{part}_launches']}, want {want}")


def phase_hapi_fit(cfg: dict = BERT_BASE, device: str = "cuda",
                   shape: dict = HAPI_FIT) -> dict:
    """BERT-base's masked LM (``masked_lm``'s layers, logits at 80
    positions a sample) through ``paddle.Model``: bf16 O2, AdamW on a
    ``LinearWarmup`` rate, ``Accuracy``; ``fit`` over 6 batches of 8 x 512
    (eager, as the reference's ``fit``) with ``ModelCheckpoint``,
    ``LRScheduler`` and ``EarlyStopping``, the epoch's evaluation of 2
    batches; ``evaluate`` (2 batches), ``predict`` (1), a fresh model's
    ``load`` of the final checkpoint (bitwise, optimizer included) and
    ``summary`` (132,363,066 parameters).  Holds: K1-K3's bf16 dropout
    instances 12 a train batch each, K1 12 an eval or predict batch, the
    plain attention route never.  Returns the fit's launches."""
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    res = drive_hapi_fit(cfg, device, shape)
    check_hapi_fit(res, cfg, shape, cuda)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit("hapi_fit", model="bert-base-uncased masked LM through "
         "paddle.Model (port nn, hapi)", dtype="bfloat16 (AMP O2)",
         shape=shape, **res)
    return res


# ---- ops: the op suites' schema rows on the card --------------------------

#: the card's gradients against the CPU's (both the port's autograd, f32);
#: forward outputs are held at each row's own rtol/atol
OPS_GRAD_TOLERANCE = {"rtol": 1e-4, "atol": 1e-5}


def op_rows():
    """``tests/torch_op_rows.py``: the rows of ``tests/test_op_suite.py``
    and ``tests/test_op_suite_extra.py`` read as data, ``paddle`` bound to
    the port (it imports no JAX)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_op_rows

    return torch_op_rows


def drive_ops(device: str = "cuda", other: str = "cpu", names=None) -> dict:
    """Every row (or those ``names``) on ``device`` and on ``other`` from
    the same seeded numpy inputs, each side's generators seeded alike: the
    forward outputs held at the row's tolerance (integers and bools
    exactly), a differentiable row's gradients at ``OPS_GRAD_TOLERANCE``,
    a random row's draws to their law.  Returns the counts, the failures
    and the worst row."""
    from paddle_tpu_torch import rng

    R = op_rows()
    rows = R.load_rows()
    names = sorted(rows) if names is None else list(names)
    failed, worst = {}, {"row": None, "max_abs_err": 0.0}
    for name in names:
        spec = rows[name]
        try:
            rng.seed(0)
            got = R.run_row(spec, device)
            rng.seed(0)
            want = R.run_row(spec, other)
            err = R.compare(spec, got, want, spec.rtol, spec.atol,
                            OPS_GRAD_TOLERANCE["rtol"],
                            OPS_GRAD_TOLERANCE["atol"])
        except Exception as e:              # noqa: BLE001 — counted, raised
            failed[name] = f"{type(e).__name__}: {str(e)[:400]}"
            continue
        if err > worst["max_abs_err"]:
            worst = {"row": name, "max_abs_err": err, "rtol": spec.rtol,
                     "atol": spec.atol}
    return {"ops": len(names), "failed": len(failed), "failures": failed,
            "worst": worst,
            "grad_rows": sum(1 for n in names if rows[n].grad),
            "random_rows": sorted(R.RANDOM & set(names))}


def phase_ops(device: str = "cuda") -> dict:
    """Every schema row of the op suites (362) on the card against the
    CPU: forward and, for the differentiable rows, gradients.  Prints the
    count, the failures (there must be none), the worst max abs error with
    its row's tolerance, and the seconds."""
    t0 = time.perf_counter()
    res = drive_ops(device)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit("ops", against="cpu", grad_tolerance=OPS_GRAD_TOLERANCE, **res)
    if res["failed"]:
        raise AssertionError(f"ops: {res['failed']} rows differ between "
                             f"the card and the CPU: {res['failures']}")
    return res


# ---- resnet_fit: ResNet-50 through paddle.Model ------------------------------

#: PaddleClas's ImageNet ResNet50 recipe at one card's share (8 cards x 64):
#: Momentum 0.9, lr 0.1, L2Decay 1e-4, batch 64 at 224 x 224, 1000
#: classes; 12 train batches over ``distinct`` batches' worth of FakeData
#: images, so the labels can be memorised (over two alternating batches
#: the loss at lr 0.1 swung between 5.2 and 9.8 on an H100), 2 eval
#: batches (the first the trained one), 4 loader workers; the first
#: ``warm`` steps are untimed, ``traced`` steps profiled
RESNET_FIT = {"depth": 50, "classes": 1000, "image": (3, 224, 224),
              "batch": 64, "train": 12, "eval": 2, "distinct": 1,
              "workers": 4, "lr": 0.1, "momentum": 0.9, "l2": 1e-4,
              "warm": 2, "traced": 3}


class Cycled:
    """``base``'s samples over and over: sample ``i`` is ``base[i %
    len(base)]`` (numpy only; the loader's workers unpickle it)."""

    def __init__(self, base, n: int):
        self.base, self.n = base, n

    def __getitem__(self, i):
        return self.base[i % len(self.base)]

    def __len__(self):
        return self.n


def drive_resnet_fit(shape: dict, device: str) -> dict:
    """``vision.resnet<depth>`` trained through ``Model.fit`` over
    ``FakeData`` (:func:`drive_image_fit`)."""
    from paddle_tpu_torch import device_guard, rng, vision

    B = shape["batch"]
    rng.seed(0)
    with device_guard(device):
        net = getattr(vision, f"resnet{shape['depth']}")(
            num_classes=shape["classes"])
    base = vision.datasets.FakeData(B * shape["distinct"], shape["image"],
                                    shape["classes"])
    evals = vision.datasets.FakeData(B * shape["eval"], shape["image"],
                                     shape["classes"])
    return drive_image_fit(shape, device, net, base, evals)


def drive_image_fit(shape: dict, device: str, net, base, evals) -> dict:
    """``net`` trained through ``Model.fit`` for ``shape["train"]`` batches
    over a ``DataLoader`` of ``base``'s samples over and over with
    ``shape["workers"]`` workers, with a ``StepTimeline``; ``evaluate`` on
    ``evals``; ``summary``; one worker's time to draw a batch of ``base``
    (its transforms included); each train batch's shape and dtype as the
    network received it; on the card a profile of ``traced`` warm
    steps."""
    import contextlib
    import io as stdio

    from paddle_tpu_torch import (Model, io, metric, nn, obs, optimizer,
                                  regularizer, summary)

    cuda = torch.device(device).type == "cuda"
    B, warm = shape["batch"], shape["warm"]
    res = {"params": sum(p.numel() for p in net.parameters())}
    with contextlib.redirect_stdout(stdio.StringIO()) as table:
        info = summary(net, (1,) + tuple(shape["image"]))
    res["summary"] = {**info, "rows": table.getvalue().count("\n")}
    opt = optimizer.Momentum(net.parameters(), lr=shape["lr"],
                             momentum=shape["momentum"],
                             weight_decay=regularizer.L2Decay(shape["l2"]))
    model = Model(net).prepare(opt, nn.CrossEntropyLoss(),
                               metrics=metric.Accuracy(topk=(1, 5)))
    t0 = time.perf_counter()
    np.stack([base[i][0] for i in range(B)])
    res["one_worker_batch_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    loader = io.DataLoader(Cycled(base, B * shape["train"]), batch_size=B,
                           num_workers=shape["workers"], timeout=300)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    clock, tl = step_clock(), obs.StepTimeline()
    batches = []
    hook = net.register_forward_pre_hook(
        lambda m, inp: batches.append([list(inp[0].shape),
                                       str(inp[0].dtype)]))
    before = _counts()
    t0 = time.perf_counter()
    try:
        model.fit(loader, epochs=1, verbose=0, num_iters=shape["train"],
                  timeline=tl, callbacks=[clock])
    finally:
        hook.remove()
    res["fit_s"] = round(time.perf_counter() - t0, 3)
    after = _counts()
    res.update({"losses": [float(v) for v in clock.losses],
                "launches": _moved(before[0], after[0]),
                "routes": _moved(before[1], after[1]),
                "transport": dict(loader.transport),
                "batches": batches,
                "start_s": round(clock.start_s, 3),
                "warmup_step_ms": [round(t, 3) for t in clock.ms[:warm]]})
    ms = clock.ms[warm:]
    res["step_ms"] = _quartiles(ms)
    res["images_per_s"] = round(B / (res["step_ms"]["median"] / 1e3), 1)
    phases = {ph: 0.0 for ph in ("data_fetch", "step_dispatch",
                                 "device_wait")}
    for sp in tl.spans.values():
        step = sp["trace"].rpartition(":s")[2]
        if sp["name"] in phases and step.isdigit() and int(step) >= warm:
            phases[sp["name"]] += sp["t_end"] - sp["t_start"]
    timed = len(ms)
    res["loader_wait_ms_per_batch"] = round(phases["data_fetch"] * 1e3
                                            / timed, 3)
    res["wall_ms_per_batch"] = round(sum(phases.values()) * 1e3 / timed, 3)
    res["wall_images_per_s"] = round(B / (res["wall_ms_per_batch"] / 1e3),
                                     1)
    res["data_fetch_share"] = round(phases["data_fetch"]
                                    / sum(phases.values()), 5)
    before = _counts()
    logs = model.evaluate(evals, batch_size=B, verbose=0)
    res["eval_logs"] = {k: float(np.asarray(v).reshape(-1)[0])
                        for k, v in logs.items()}
    res["eval_accuracy_top1_top5"] = [
        float(a) for a in model._metrics[0].accumulate()]
    after = _counts()
    res["eval_routes"] = _moved(before[1], after[1])
    if cuda:
        res["peak_memory_gb"] = round(torch.cuda.max_memory_allocated()
                                      / 2 ** 30, 3)
        x, y = next(iter(io.DataLoader(base, batch_size=B)))
        n = shape["traced"]
        prof = device_profile(lambda: [model.train_batch(x, y)
                                       for _ in range(n)])
        res["launches_per_step"] = prof["launches"] / n
        res["device_busy_ms_per_step"] = round(prof["busy_ms"] / n, 3)
        res["idle_share"] = round(1.0 - prof["busy_ms"] / n
                                  / res["step_ms"]["median"], 4)
    return res


def check_resnet_fit(res: dict, shape: dict) -> None:
    """The holds of ``resnet_fit``: ``summary`` and the model agree on the
    parameter count (25,557,032 for ResNet-50 at 1000 classes), every loss
    is finite and the last three's mean is below the first loss, every
    batch came through the workers' ring, and no plain attention route
    ran (the network has none)."""
    want = 25_557_032 if (shape["depth"], shape["classes"]) == (50, 1000) \
        else res["params"]
    if res["params"] != want or res["summary"]["total_params"] != want:
        raise AssertionError(f"resnet_fit: {res['params']} parameters, "
                             f"summary {res['summary']}, want {want}")
    losses = res["losses"]
    if len(losses) != shape["train"] or not np.all(np.isfinite(losses)):
        raise AssertionError(f"resnet_fit: losses {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"resnet_fit: the loss did not fall: {losses}")
    want = {"ring": shape["train"], "queue": 0} if shape["workers"] else \
        {"ring": 0, "queue": 0}
    if res["transport"] != want:
        raise AssertionError(f"resnet_fit: batches came {res['transport']}"
                             f", want {want}")
    for part in ("routes", "eval_routes"):
        if res[part].get("plain"):
            raise AssertionError(f"resnet_fit: a plain route ran ({part} "
                                 f"{res[part]})")


def phase_resnet_fit(shape: dict = RESNET_FIT, device: str = "cuda") -> dict:
    """ResNet-50 (``vision.resnet50(num_classes=1000)``) trained through
    ``paddle.Model`` on ``FakeData`` at PaddleClas's per-card recipe, f32
    (the TF32 switches printed as they stand): ``fit`` for 12 batches of
    64 at 224 x 224 with ``Accuracy(topk=(1, 5))`` over 4 loader workers,
    then ``evaluate`` on 2 batches.  Prints the warm step's milliseconds,
    images/s (the step's and the wall clock's), the loader's wait and one
    worker's draw of a batch, peak memory, the card's idle share over 3
    traced warm steps and the launches a step."""
    t0 = time.perf_counter()
    res = drive_resnet_fit(shape, device)
    check_resnet_fit(res, shape)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit("resnet_fit", model=f"resnet{shape['depth']} (port vision, "
         f"hapi)", dtype="float32", shape=shape,
         tf32={"cudnn": torch.backends.cudnn.allow_tf32,
               "matmul": torch.backends.cuda.matmul.allow_tf32}, **res)
    return res


# ---- mobilenet_fit: MobileNetV3-large through paddle.Model -----------------

#: resnet_fit's recipe (Momentum 0.9, lr 0.1, L2Decay 1e-4, batch 64 at
#: 224 x 224, 12 train and 2 eval batches, 4 workers) on MobileNetV3-large
#: over an augmenting loader: ``images`` seeded uint8 HWC ``.npy`` images
#: with sides drawn from ``sides``, in ``folders`` class folders, read by
#: ``DatasetFolder`` through PaddleClas's ImageNet train transforms
#: (RandomResizedCrop 224, a random horizontal flip, ToTensor, Normalize)
#: and its eval ones (Resize 256, CenterCrop 224)
MOBILENET_FIT = {"arch": "mobilenet_v3_large", "classes": 1000,
                 "image": (3, 224, 224), "batch": 64, "train": 12,
                 "eval": 2, "workers": 4, "lr": 0.1, "momentum": 0.9,
                 "l2": 1e-4, "warm": 2, "traced": 3, "images": 64,
                 "folders": 10, "sides": (256, 512), "resize": 256}

#: MobileNetV3-large's parameters at 1000 classes (5,507,432 with the
#: batch norms' buffers)
MOBILENET_V3_LARGE_PARAMS = 5_483_032

IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]


def write_image_folder(root: str, n: int, folders: int, sides, seed=0):
    """``n`` seeded uint8 HWC RGB images, each side drawn from ``sides``
    (inclusive), as ``root/class<k>/<i>.npy``, image ``i`` in class ``i %
    folders``."""
    rs = np.random.RandomState(seed)
    for i in range(n):
        h, w = rs.randint(sides[0], sides[1] + 1, 2)
        d = os.path.join(root, f"class{i % folders:02d}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{i:04d}.npy"),
                rs.randint(0, 256, (h, w, 3), dtype=np.uint8))


def image_folder_sets(root: str, shape: dict):
    """The train and eval ``DatasetFolder``s over ``root`` with
    PaddleClas's ImageNet transforms at ``shape``'s sizes."""
    from paddle_tpu_torch.vision import datasets, transforms as T

    side = shape["image"][1]
    norm = [T.ToTensor(), T.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD)]
    train = datasets.DatasetFolder(root, transform=T.Compose(
        [T.RandomResizedCrop(side), T.RandomHorizontalFlip()] + norm))
    evals = datasets.DatasetFolder(root, transform=T.Compose(
        [T.Resize(shape["resize"]), T.CenterCrop(side)] + norm))
    return train, evals


def drive_mobilenet_fit(shape: dict, device: str, root: str) -> dict:
    """``vision.<arch>`` trained through ``Model.fit`` over seeded images
    written to ``root`` (:func:`drive_image_fit`)."""
    from paddle_tpu_torch import device_guard, rng, vision

    write_image_folder(root, shape["images"], shape["folders"],
                       shape["sides"])
    train, evals = image_folder_sets(root, shape)
    rng.seed(0)
    with device_guard(device):
        net = getattr(vision, shape["arch"])(num_classes=shape["classes"])
    return drive_image_fit(shape, device, net, train,
                           Cycled(evals, shape["batch"] * shape["eval"]))


def check_mobilenet_fit(res: dict, shape: dict) -> None:
    """The holds of ``mobilenet_fit``: ``summary`` and the model agree on
    the parameter count (5,483,032 for MobileNetV3-large at 1000
    classes), every loss is finite and the last three's mean is below the
    first loss, every batch came through the workers' ring, and the
    network received every train batch as ``[batch, *image]`` float32."""
    want = MOBILENET_V3_LARGE_PARAMS \
        if (shape["arch"], shape["classes"]) == ("mobilenet_v3_large",
                                                 1000) else res["params"]
    if res["params"] != want or res["summary"]["total_params"] != want:
        raise AssertionError(f"mobilenet_fit: {res['params']} parameters, "
                             f"summary {res['summary']}, want {want}")
    losses = res["losses"]
    if len(losses) != shape["train"] or not np.all(np.isfinite(losses)):
        raise AssertionError(f"mobilenet_fit: losses {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"mobilenet_fit: the loss did not fall: "
                             f"{losses}")
    want = {"ring": shape["train"], "queue": 0} if shape["workers"] else \
        {"ring": 0, "queue": 0}
    if res["transport"] != want:
        raise AssertionError(f"mobilenet_fit: batches came "
                             f"{res['transport']}, want {want}")
    batch = [[shape["batch"], *shape["image"]], "torch.float32"]
    if len(res["batches"]) != shape["train"] or \
            any(b != batch for b in res["batches"]):
        raise AssertionError(f"mobilenet_fit: the network received "
                             f"{res['batches']}, want {shape['train']} x "
                             f"{batch}")


def phase_mobilenet_fit(shape: dict = MOBILENET_FIT,
                        device: str = "cuda") -> dict:
    """MobileNetV3-large (``vision.mobilenet_v3_large(num_classes=1000)``)
    trained through ``paddle.Model`` at resnet_fit's recipe, f32, over a
    4-worker loader whose workers read 64 seeded images of sides 256-512
    from 10 class folders and augment them (random resized crop to 224,
    flip, normalize); ``evaluate`` on 2 batches (resize 256, centre crop
    224).  Prints the warm step's milliseconds, images/s (the step's and
    the wall clock's), the loader's wait, one worker's draw of a
    transformed batch, peak memory, the card's idle share over 3 traced
    warm steps and the launches a step."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        res = drive_mobilenet_fit(shape, device, root)
    check_mobilenet_fit(res, shape)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    res["batches"] = f"{len(res['batches'])} x {res['batches'][0]}"
    emit("mobilenet_fit", model=f"{shape['arch']} (port vision, hapi, "
         f"transforms)", dtype="float32", shape=shape,
         tf32={"cudnn": torch.backends.cudnn.allow_tf32,
               "matmul": torch.backends.cuda.matmul.allow_tf32}, **res)
    return res


# ---- vision_ops: the detection ops on the card against the CPU -------------

#: the nine COCO anchors of YOLOv3 and each head's three
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]

#: the shapes detectors run: YOLOv3-DarkNet53 at 608 (three heads of 80
#: classes, 50 padded ground-truth boxes an image), Faster R-CNN R50-FPN's
#: P2 level (512 RoIs an image of sides 16-112 px), R-FCN's
#: position-sensitive map (10 x 7 x 7 channels), DCNv2 at ResNet-50's res5,
#: multiclass NMS of 1000 boxes in 80 categories, a CRF's 64 x 128 x 60
#: emissions
VISION_OPS = {
    "yolo": {"batch": 8, "grids": (19, 38, 76), "down": (32, 16, 8),
             "classes": 80, "image": 608, "conf_thresh": 0.005,
             "gt_boxes": 50, "ignore_thresh": 0.7},
    "nms": {"boxes": 1000, "categories": 80, "iou": 0.45, "top_k": 100,
            "image": 608},
    "roi": {"feat": (2, 256, 200, 272), "scale": 0.25, "rois": 512,
            "sides": (16, 112), "output": 7, "sampling_ratio": -1},
    "psroi": {"feat": (2, 490, 200, 272), "output": 7},
    "deform": {"x": (2, 512, 25, 34), "cout": 512, "k": 3},
    "viterbi": {"batch": 64, "seq": 128, "tags": 60},
}

#: the card's forward against the CPU's (both the port's f32 torch ops,
#: sums in another order), of each output's scale; the gradients of
#: ``sum(out * c)`` likewise
VISION_OPS_TOLERANCE = {"fwd": 1e-4, "grad": 1e-4}


def vision_op_cases(shape: dict) -> dict:
    """Each op of the phase as ``(fn, floats, others, grad)``:
    ``fn(*floats, *others)`` on tensors made from seeded numpy; with
    ``grad`` the ``floats`` are differentiated, ``others`` never."""
    from paddle_tpu_torch import text
    from paddle_tpu_torch.vision import ops as V

    rs = np.random.RandomState(0)
    cases = {}
    y = shape["yolo"]
    ncls, N = y["classes"], y["batch"]
    img = np.full((N, 2), y["image"], np.int32)
    gt = np.zeros((N, y["gt_boxes"], 4), np.float32)
    label = np.zeros((N, y["gt_boxes"]), np.int64)
    for n in range(N):
        k = rs.randint(5, y["gt_boxes"] + 1)
        gt[n, :k, :2] = rs.uniform(0.05, 0.95, (k, 2))
        gt[n, :k, 2:] = rs.uniform(0.01, 0.5, (k, 2))
        label[n, :k] = rs.randint(0, ncls, k)
    for grid, down, mask in zip(y["grids"], y["down"], YOLO_MASKS):
        head = (0.5 * rs.randn(N, 3 * (5 + ncls), grid, grid)).astype(
            np.float32)
        anchors = [YOLO_ANCHORS[2 * a + i] for a in mask for i in (0, 1)]
        cases[f"yolo_box_{grid}"] = (
            lambda x, im, a=anchors, d=down: V.yolo_box(
                x, im, a, ncls, y["conf_thresh"], d), [head], [img], False)
        cases[f"yolo_loss_{grid}"] = (
            lambda x, b, l, m=mask, d=down: V.yolo_loss(
                x, b, l, YOLO_ANCHORS, m, ncls, y["ignore_thresh"], d),
            [head], [gt, label], True)
    s = shape["nms"]
    xy = rs.uniform(0, s["image"] - 64, (s["boxes"], 2))
    wh = rs.uniform(8, 160, (s["boxes"], 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    cases["nms"] = (lambda b, sc, c: V.nms(
        b, s["iou"], sc, c, list(range(s["categories"])), s["top_k"]),
        [], [boxes, rs.rand(s["boxes"]).astype(np.float32),
             rs.randint(0, s["categories"], s["boxes"])], False)
    r = shape["roi"]
    N, C, H, W = r["feat"]
    lo, hi = r["sides"]
    side = rs.uniform(lo, hi, (N * r["rois"], 2))
    corner = rs.uniform(0, 1, (N * r["rois"], 2)) \
        * (np.array([W, H]) / r["scale"] - side)
    rois = np.concatenate([corner, corner + side], 1).astype(np.float32)
    num = np.full(N, r["rois"], np.int32)
    feat = rs.randn(*r["feat"]).astype(np.float32)
    cases["roi_align"] = (lambda f, b, n: V.roi_align(
        f, b, n, r["output"], r["scale"], r["sampling_ratio"], True),
        [feat, rois], [num], True)
    cases["roi_pool"] = (lambda f, b, n: V.roi_pool(
        f, b, n, r["output"], r["scale"]), [feat], [rois, num], True)
    p = shape["psroi"]
    cases["psroi_pool"] = (lambda f, b, n: V.psroi_pool(
        f, b, n, p["output"], r["scale"]),
        [rs.randn(*p["feat"]).astype(np.float32)], [rois, num], True)
    d = shape["deform"]
    N, C, H, W = d["x"]
    k = d["k"]
    cases["deform_conv2d"] = (
        lambda x, o, m, w: V.deform_conv2d(x, o, w, padding=k // 2,
                                           mask=m),
        [rs.randn(N, C, H, W).astype(np.float32),
         (2 * rs.randn(N, 2 * k * k, H, W)).astype(np.float32),
         rs.rand(N, k * k, H, W).astype(np.float32),
         (rs.randn(d["cout"], C, k, k) / np.sqrt(C * k * k)).astype(
             np.float32)], [], True)
    v = shape["viterbi"]
    cases["viterbi_decode"] = (
        lambda pot, tr, ln: text.viterbi_decode(pot, tr, ln, True), [],
        [rs.randn(v["batch"], v["seq"], v["tags"]).astype(np.float32),
         rs.randn(v["tags"], v["tags"]).astype(np.float32),
         rs.randint(1, v["seq"] + 1, v["batch"]).astype(np.int64)], False)
    return cases


def _run_case(case, device: str, seed: int = 1):
    """A case on ``device``: its outputs and, where it has a gradient, the
    gradients of ``sum(out * c)`` (``c`` seeded), as CPU tensors."""
    fn, floats, others, grad = case
    xs = [torch.tensor(a, device=device, requires_grad=grad)
          for a in floats]
    outs = fn(*xs, *[torch.tensor(a, device=device) for a in others])
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = []
    if grad:
        rs = np.random.RandomState(seed)
        loss = sum((o * torch.tensor(rs.rand(*o.shape).astype(np.float32),
                                     device=device)).sum() for o in outs)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads)]
    return [o.detach().cpu() for o in outs], [g.cpu() for g in grads]


def _max_rel_err(got, want) -> float:
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1e-6)
    return float((got.double() - want.double()).abs().max()) / scale \
        if want.numel() else 0.0


def drive_vision_ops(shape: dict = VISION_OPS, device: str = "cuda",
                     other: str = "cpu", reps: int = 5) -> dict:
    """Each case on ``device`` and on ``other`` from the same seeded
    inputs: float outputs and gradients held at ``VISION_OPS_TOLERANCE``
    of their scale, integer outputs (``nms``'s indices, Viterbi's paths)
    equal; each op's warm forward milliseconds on ``device`` (median of
    ``reps``; with the backward too where it has one).  Returns each op's
    numbers and the failures."""
    cuda = torch.device(device).type == "cuda"
    out, failed = {}, {}
    for name, case in vision_op_cases(shape).items():
        try:
            got, got_g = _run_case(case, device)
            want, want_g = _run_case(case, other)
            res = {"max_abs_err": 0.0, "fwd_rel_err": 0.0,
                   "grad_rel_err": 0.0, "outputs": [list(o.shape)
                                                    for o in want]}
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise AssertionError(f"output {list(g.shape)} "
                                         f"{g.dtype}, want {list(w.shape)} "
                                         f"{w.dtype}")
                if not w.is_floating_point():
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"{int((g != w).sum())} of {w.numel()} "
                            f"integer outputs differ")
                    continue
                res["max_abs_err"] = max(res["max_abs_err"], float(
                    (g - w).abs().max()) if w.numel() else 0.0)
                res["fwd_rel_err"] = max(res["fwd_rel_err"],
                                         _max_rel_err(g, w))
            for g, w in zip(got_g, want_g):
                res["grad_rel_err"] = max(res["grad_rel_err"],
                                          _max_rel_err(g, w))
            if res["fwd_rel_err"] > VISION_OPS_TOLERANCE["fwd"] or \
                    res["grad_rel_err"] > VISION_OPS_TOLERANCE["grad"]:
                raise AssertionError(f"beyond {VISION_OPS_TOLERANCE}: {res}")
            fn, floats, others, grad = case
            xs = [torch.tensor(a, device=device, requires_grad=grad)
                  for a in floats]
            args = xs + [torch.tensor(a, device=device) for a in others]
            res["ms"] = _quartiles([_step_ms(lambda: fn(*args), cuda)[1]
                                    for _ in range(reps)])["median"]
            if grad:
                def step():
                    outs = fn(*args)
                    outs = outs if isinstance(outs, tuple) else (outs,)
                    sum(o.sum() for o in outs).backward()
                res["ms_with_grad"] = _quartiles(
                    [_step_ms(step, cuda)[1] for _ in range(reps)])["median"]
            out[name] = res
        except Exception as e:              # noqa: BLE001 — counted, raised
            failed[name] = f"{type(e).__name__}: {str(e)[:400]}"
    return {"ops": out, "failed": failed}


def phase_vision_ops(shape: dict = VISION_OPS, device: str = "cuda") -> dict:
    """The detection ops at the shapes detectors run (``VISION_OPS``) on
    the card against the CPU: yolo_box and yolo_loss at each YOLOv3 head,
    multiclass nms, roi_align/roi_pool at Faster R-CNN's P2 level,
    psroi_pool at R-FCN's map, deform_conv2d at DCNv2's res5 and Viterbi
    decoding; forwards and gradients within ``VISION_OPS_TOLERANCE``,
    nms's indices and the Viterbi paths equal.  Prints each op's warm
    milliseconds and errors, and the seconds."""
    t0 = time.perf_counter()
    res = drive_vision_ops(shape, device)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit("vision_ops", against="cpu", tolerance=VISION_OPS_TOLERANCE,
         shape=shape, **res)
    if res["failed"]:
        raise AssertionError(f"vision_ops: {len(res['failed'])} ops differ "
                             f"between the card and the CPU or fail: "
                             f"{res['failed']}")
    return res


# ---- sparse_train: SECOND's sparse middle encoder on KITTI-like scans -------

#: mmdet3d's ``SparseEncoder`` as ``configs/second/hv_second_secfpn_6x8_80e_
#: kitti-3d-car.py`` sets it: voxels of 0.05 x 0.05 x 0.1 m over x [0, 70.4],
#: y [-40, 40], z [-3, 1] (``sparse_shape`` z, y, x), ``conv_input`` a
#: SubMConv3d to 16 channels, four stages (a stride-2 SparseConv3d k3
#: opening stages 2-4), ``conv_out`` (3, 1, 1) / (2, 1, 1) to 128; every
#: convolution bias-free and followed by BatchNorm1d(eps 1e-3, momentum
#: 0.01: Paddle's 0.99) and ReLU
SECOND = {"in_channels": 4, "sparse_shape": (41, 1600, 1408),
          "point_range": (0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
          "base_channels": 16, "out_channels": 128,
          "encoder_channels": ((16,), (32, 32, 32), (64, 64, 64),
                               (64, 64, 64)),
          "encoder_paddings": ((1,), (1, 1, 1), (1, 1, 1),
                               ((0, 1, 1), 1, 1)),
          "bn_eps": 1e-3, "bn_momentum": 0.99}

#: the config's ``samples_per_gpu`` 6 and training ``max_voxels`` 16000,
#: its AdamW (lr 0.0018, weight decay 0.01); 2 warm-up and 10 timed steps
#: over ``batches`` distinct seeded batches in turn (each step's tensors
#: new, so each step builds its rulebooks), ``traced`` steps profiled
SECOND_TRAIN = {"batch": 6, "max_voxels": 16000, "steps": 12, "warm": 2,
                "lr": 0.0018, "weight_decay": 0.01, "batches": 2,
                "traced": 2}

#: the card's batch-1 step against the CPU's: the BEV map and every
#: gradient within this share of their largest magnitude
SPARSE_PARITY_TOLERANCE = 1e-3

#: the least mean of active neighbours a first-layer site must have for a
#: scan to count as surfaces rather than scattered points
MIN_NEIGHBOURS = 4.0


def _ray_box(d, centre, size, yaw):
    """Distance along unit rays ``d`` ``[n, 3]`` from the origin to a box
    of ``size`` (l, w, h) at ``centre`` turned by ``yaw``; inf where it
    misses (the slab method in the box's frame)."""
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    o = rot.T @ (-np.asarray(centre))
    dd = d @ rot
    half = np.asarray(size) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        t1, t2 = (-half - o) / dd, (half - o) / dd
    near = np.nanmax(np.minimum(t1, t2), axis=1)
    far = np.nanmin(np.maximum(t1, t2), axis=1)
    return np.where((far >= near) & (near > 0), near, np.inf)


def lidar_scan(rs, cfg: dict, max_voxels: int):
    """One KITTI-like scan voxelised as mmdet3d's hard voxelisation does
    it: a 64-beam sensor 1.73 m above the ground (HDL-64E: 32 beams +2 to
    -8.33 deg, 32 beams -8.83 to -24.33 deg; 0.18 deg azimuth, KITTI's
    ~2,000 returns a ring) over the front 90 deg, ray-cast against a
    ground plane (far grazing returns fading), building facades on both
    sides with hedges before them, cars parked along both curbs and
    driving, pedestrians and cyclists; 2 cm range noise; the points
    shuffled (``PointShuffle``) and voxelised in point order up to
    ``max_voxels``, a voxel's features the mean of its points' (x, y, z,
    intensity).  Returns the voxels' ``(z, y, x)`` indices and features."""
    elev = np.deg2rad(np.concatenate([np.linspace(2.0, -8.33, 32),
                                      np.linspace(-8.83, -24.33, 32)]))
    az = np.deg2rad(np.arange(-45.0, 45.0, 0.18))
    el, a = np.meshgrid(elev, az, indexing="ij")
    d = np.stack([np.cos(el) * np.cos(a), np.cos(el) * np.sin(a),
                  np.sin(el)], -1).reshape(-1, 3)
    n = d.shape[0]
    down = d[:, 2] < 0
    t_ground = np.where(down, -1.73 / np.where(down, d[:, 2], -1.0), np.inf)
    t = t_ground.copy()
    boxes = []
    for side in (-1, 1):
        y_wall = side * rs.uniform(9.0, 18.0)
        toward = d[:, 1] * side > 0
        tw = np.where(toward, y_wall / np.where(toward, d[:, 1], 1.0),
                      np.inf)
        ok = (tw * d[:, 2] < 6.0) & (tw * d[:, 0] > 3.0)
        t = np.minimum(t, np.where(ok, tw, np.inf))
        x = rs.uniform(2.0, 6.0)
        while x < 40.0:                       # hedges before the facade
            length = rs.uniform(3.0, 8.0)
            h = rs.uniform(0.8, 1.5)
            boxes.append(((length, 0.8, h), (x + length / 2, y_wall - side
                          * rs.uniform(1.0, 2.5), -1.73 + h / 2), 0.0))
            x += length + rs.uniform(1.0, 6.0)
        x = rs.uniform(3.0, 8.0)
        while x < 50.0:                       # cars parked along the curb
            boxes.append(((3.9, 1.6, 1.56), (x, side * rs.uniform(4.0, 6.5),
                          -1.73 + 0.78), rs.normal(0, 0.1)
                          + (0.0 if side > 0 else np.pi)))
            x += rs.uniform(5.0, 12.0)
    for _ in range(6):                        # cars on the road
        boxes.append(((3.9, 1.6, 1.56), (rs.uniform(8, 45), rs.uniform(-3, 3),
                      -1.73 + 0.78), rs.normal(0, 0.05) + np.pi
                      * rs.randint(2)))
    for size, count in (((0.8, 0.6, 1.73), 5), ((1.76, 0.6, 1.73), 3)):
        for _ in range(count):                # pedestrians, cyclists
            boxes.append((size, (rs.uniform(5, 35), rs.uniform(-8, 8),
                                 -1.73 + size[2] / 2),
                          rs.uniform(-np.pi, np.pi)))
    for size, centre, yaw in boxes:
        t = np.minimum(t, _ray_box(d, centre, size, yaw))
    flat = np.hypot(d[:, 0], d[:, 1]) * t
    fade = (t == t_ground) & (rs.uniform(0, 1, n) < np.clip(
        (flat - 20.0) / 40.0, 0.0, 0.9))
    keep = np.isfinite(t) & (t < 80.0) & ~fade
    pts = d[keep] * t[keep, None] + rs.normal(0, 0.02, (int(keep.sum()), 3))
    pts = np.concatenate([pts, rs.uniform(0, 1, (len(pts), 1))], 1)
    lo, hi = np.array(cfg["point_range"][:3]), np.array(
        cfg["point_range"][3:])
    dims = np.array(cfg["sparse_shape"][::-1]) - np.array([0, 0, 1])
    ijk = np.floor((pts[:, :3] - lo) / ((hi - lo) / dims)).astype(np.int64)
    inside = np.all((ijk >= 0) & (ijk < dims), 1)
    pts, ijk = pts[inside], ijk[inside]
    perm = rs.permutation(len(pts))
    pts, ijk = pts[perm], ijk[perm]
    key = (ijk[:, 2] * dims[1] + ijk[:, 1]) * dims[0] + ijk[:, 0]
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)                 # voxels in point order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    vid = rank[inv]
    n_vox = min(len(uniq), max_voxels)
    kept = vid < n_vox
    feats = np.zeros((n_vox, 4))
    np.add.at(feats, vid[kept], pts[kept])
    feats /= np.bincount(vid[kept], minlength=n_vox)[:, None]
    u = uniq[order[:n_vox]]
    zyx = np.stack([u // (dims[1] * dims[0]), (u // dims[0]) % dims[1],
                    u % dims[0]], 1)
    return zyx, feats.astype(np.float32)


def scan_batch(cfg: dict, batch: int, max_voxels: int, seed: int):
    """``batch`` scans (seeds ``seed * 1000 + b``) as one COO input:
    indices ``int64 [4, N]`` (batch, z, y, x) and features ``[N, 4]``."""
    idx, feats = [], []
    for b in range(batch):
        zyx, f = lidar_scan(np.random.RandomState(seed * 1000 + b), cfg,
                            max_voxels)
        idx.append(np.concatenate([np.full((len(zyx), 1), b), zyx], 1))
        feats.append(f)
    return (np.ascontiguousarray(np.concatenate(idx).T).astype(np.int64),
            np.concatenate(feats))


def second_convs(cfg: dict) -> list:
    """The encoder's convolutions in order: ``(cin, cout, kernel, stride,
    padding, subm)``."""
    cin = cfg["base_channels"]
    convs = [(cfg["in_channels"], cin, 3, 1, 1, True)]
    for i, (chans, pads) in enumerate(zip(cfg["encoder_channels"],
                                          cfg["encoder_paddings"])):
        for j, (cout, pad) in enumerate(zip(chans, pads)):
            strided = i != 0 and j == 0
            convs.append((cin, cout, 3, 2 if strided else 1, pad,
                          not strided))
            cin = cout
    convs.append((cin, cfg["out_channels"], (3, 1, 1), (2, 1, 1), 0,
                  False))
    return convs


#: rulebooks SECOND's encoder builds a step: ``conv_input``'s (which the
#: first stage's SubMConv3d shares), then a strided convolution's and a
#: SubMConv3d's in each of stages 2-4 (its second SubMConv3d shares it),
#: then ``conv_out``'s
SECOND_RULEBOOKS = 8


def second_encoder(cfg: dict):
    """SECOND's sparse middle encoder from the port's ``sparse.nn`` layers,
    on the port's current device: each convolution of
    :func:`second_convs`, bias-free, followed by ``BatchNorm`` and
    ``ReLU``."""
    from paddle_tpu_torch import nn, sparse

    S = sparse.nn
    layers = []
    for cin, cout, kernel, stride, padding, subm in second_convs(cfg):
        layers.append(S.SubmConv3D(cin, cout, kernel, padding=padding,
                                   bias_attr=False) if subm else
                      S.Conv3D(cin, cout, kernel, stride=stride,
                               padding=padding, bias_attr=False))
        layers += [S.BatchNorm(cout, momentum=cfg["bn_momentum"],
                               epsilon=cfg["bn_eps"]), S.ReLU()]
    return nn.Sequential(*layers)


def bev_shape(cfg: dict, batch: int) -> tuple:
    """The BEV map's shape ``(N, C·D, H, W)``."""
    from paddle_tpu_torch.sparse.nn import _triple

    dims = list(cfg["sparse_shape"])
    for _, cout, kernel, stride, padding, subm in second_convs(cfg):
        if not subm:
            dims = [(s + 2 * p - k) // st + 1 for s, p, k, st in
                    zip(dims, _triple(padding), _triple(kernel),
                        _triple(stride))]
    return (batch, cfg["out_channels"] * dims[0], dims[1], dims[2])


def bev_map(out) -> torch.Tensor:
    """The encoder's output made dense as the BEV map ``[N, C·D, H, W]``
    (mmdet3d's ``spatial_features.view(N, C * D, H, W)``)."""
    dense = out.to_dense().permute(0, 4, 1, 2, 3)
    n, c, d, h, w = dense.shape
    return dense.reshape(n, c * d, h, w)


def _conv_layers(net) -> list:
    from paddle_tpu_torch import sparse

    return [m for m in net if isinstance(m, sparse.nn._Conv3D)]


def _timed_module(module, names, cuda: bool) -> tuple:
    """Wrap ``module.<name>`` for each of ``names`` so that each call's
    time is kept (a pair of CUDA events on the card, the host clock on
    the CPU); returns ``(spans, restore)``."""
    spans = {n: [] for n in names}
    originals = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                spans[name].append((start, end))
            else:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                spans[name].append(time.perf_counter() - t0)
            return out
        return timed

    for n, fn in originals.items():
        setattr(module, n, wrap(n, fn))

    def restore():
        for n, fn in originals.items():
            setattr(module, n, fn)
    return spans, restore


def _span_ms(spans: list, cuda: bool) -> float:
    """The milliseconds of kept spans (after a sync), emptying them."""
    ms = sum(s.elapsed_time(e) for s, e in spans) if cuda else \
        sum(spans) * 1e3
    spans.clear()
    return ms


def drive_sparse_train(cfg: dict, shape: dict, device: str) -> dict:
    """``sparse_train``'s timed run (:func:`phase_sparse_train`; a tiny
    ``cfg`` and ``shape`` rehearse it on the CPU)."""
    from paddle_tpu_torch import device as pdev, optimizer, rng, sparse
    from paddle_tpu_torch.ops import kernels

    cuda = torch.device(device).type == "cuda"
    rng.seed(0)
    t0 = time.perf_counter()
    batches = [scan_batch(cfg, shape["batch"], shape["max_voxels"], s)
               for s in range(shape["batches"])]
    res = {"data_s": round(time.perf_counter() - t0, 3),
           "voxels_per_batch": [int(b[0].shape[1]) for b in batches]}
    with pdev.device_guard(device):
        net = second_encoder(cfg)
    res["params"] = sum(p.numel() for p in net.parameters())
    opt = optimizer.AdamW(net.parameters(), lr=shape["lr"],
                          weight_decay=shape["weight_decay"])
    dev_batches = [(torch.from_numpy(i).to(device),
                    torch.from_numpy(f).to(device)) for i, f in batches]
    full = (shape["batch"],) + tuple(cfg["sparse_shape"]) + \
        (cfg["in_channels"],)
    convs = _conv_layers(net)
    sites = []
    hooks = [m.register_forward_hook(lambda m, i, o: sites.append(o.nnz()))
             for m in convs]
    target = torch.randn(bev_shape(cfg, shape["batch"]), device=device,
                         generator=torch.Generator(device).manual_seed(1))

    def step(i):
        idx, feats = dev_batches[i % len(dev_batches)]
        # a new tensor over the indices: the step builds its rulebooks
        x = sparse.SparseCooTensor(idx, feats, full)
        loss = ((bev_map(net(x)) - target) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    def sync():
        if cuda:
            torch.cuda.synchronize()

    spans, restore = _timed_module(
        sparse.nn, ("build_rulebook", "conv_forward", "conv_backward"), cuda)
    losses, step_ms, rule_ms, gemm_ms, reads, books = [], [], [], [], [], []
    before = dict(kernels.launch_counts())
    try:
        if cuda:
            sync()
            torch.cuda.reset_peak_memory_stats()
        for i in range(shape["steps"]):
            r0 = dict(sparse.nn.HOST_READS)
            sites.clear()
            sync()
            t0 = time.perf_counter()
            loss = step(i)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
            rule_ms.append(_span_ms(spans["build_rulebook"], cuda))
            gemm_ms.append(_span_ms(spans["conv_forward"], cuda)
                           + _span_ms(spans["conv_backward"], cuda))
            reads.append(sparse.nn.HOST_READS["reads"] - r0["reads"])
            books.append(sparse.nn.HOST_READS["rulebooks"]
                         - r0["rulebooks"])
            if i == 0:
                res["active_sites_per_layer"] = list(sites)
    finally:
        restore()
        for h in hooks:
            h.remove()
    first = sparse.nn.build_rulebook(dev_batches[0][0], cfg["sparse_shape"],
                                     3, 1, 1, True)
    res["first_layer_neighbours"] = sum(first.counts) / first.n_out - 1.0
    after = kernels.launch_counts()
    res["launches"] = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
    warm = shape["warm"]
    res.update({"losses": losses,
                "step_ms_each": [round(v, 3) for v in step_ms],
                "step_ms": _quartiles(step_ms[warm:]),
                "rulebook_ms": _quartiles(rule_ms[warm:]),
                "gather_gemm_scatter_ms": _quartiles(gemm_ms[warm:]),
                "host_reads_per_step": reads,
                "rulebooks_per_step": books,
                "voxels_per_s": round(float(np.mean(
                    res["voxels_per_batch"])) * 1e3
                    / float(np.median(step_ms[warm:])), 1)})
    if cuda:
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        n = shape["traced"]
        prof = device_profile(lambda: [step(i) for i in range(n)])
        res["device_busy_ms_per_step"] = round(prof["busy_ms"] / n, 3)
        res["launches_per_step"] = prof["launches"] / n
        res["idle_share"] = round(1.0 - prof["busy_ms"] / n
                                  / res["step_ms"]["median"], 4)
    return res


def _sparse_step(net, idx, feats, full, target, device,
                 masks=None) -> dict:
    """One training step's forward and backward of ``net`` on ``device``
    (no optimizer step): each convolution's output sites and rulebook,
    each ReLU's input and the mask it kept, the BEV map, the loss and
    every parameter's gradient, as CPU tensors.  With ``masks`` (one
    boolean tensor a ReLU, in order) each ReLU keeps the sites its mask
    names instead of those whose input is above 0."""
    from paddle_tpu_torch import sparse

    convs = _conv_layers(net)
    seen, relus = [], []

    def relu_hook(m, i, o):
        v = i[0].values()
        if masks is None:
            relus.append((v.detach().cpu(), (v > 0).cpu()))
            return None
        keep = masks[len(relus)]
        relus.append((v.detach().cpu(), keep))
        return i[0]._replace_values(v * keep.to(v.device, v.dtype))

    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(
        (m, i[0], o))) for m in convs]
    hooks += [m.register_forward_hook(relu_hook) for m in net
              if isinstance(m, sparse.nn.ReLU)]
    try:
        x = sparse.SparseCooTensor(torch.from_numpy(idx).to(device),
                                   torch.from_numpy(feats).to(device), full)
        bev = bev_map(net(x))
        loss = ((bev - torch.from_numpy(target).to(device)) ** 2).mean()
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    layers = []
    for m, inp, out in seen:
        rb = sparse.nn.rulebook_of(inp, m._kernel, m._stride, m._padding,
                                   m._subm)
        layers.append({"sites": out.indices().cpu(),
                       "in_rows": rb.in_rows.cpu(),
                       "out_rows": rb.out_rows.cpu(), "counts": rb.counts})
    return {"layers": layers, "relus": relus, "bev": bev.detach().cpu(),
            "loss": float(loss.detach()),
            "grads": {n: p.grad.detach().cpu()
                      for n, p in net.named_parameters()}}


def drive_sparse_parity(cfg: dict, max_voxels: int, device: str,
                        other: str = "cpu", scan=None,
                        follow_masks: bool = True) -> dict:
    """A batch-1 step of the encoder on ``device`` against the same step
    on ``other`` (same weights, scan and target): each layer's output
    sites and rulebook pairs, the BEV map's and every gradient's error
    relative to its largest magnitude on ``other``.

    A ReLU is not differentiable at 0, so an input within rounding of 0
    (the card's atomics sum in any order) can fall on either side, and
    the gradients then differ by that site's whole term: a 1-ulp change
    of the scan's features moves the batch-norm bias gradient after the
    fifth convolution by 1.29e-3 of its largest magnitude on the card
    alone.  So ``other`` runs with the card's ReLU masks, and the sites
    where its own inputs would choose otherwise are counted
    (``relu_flips``) with their largest input relative to the layer's
    largest (``relu_flip_rel``), which must be within rounding too.
    ``scan``: ``(indices, features)`` instead of the seeded scan;
    ``follow_masks=False``: ``other`` on its own ReLU masks
    (``probe_sparse_parity.py`` compares the two)."""
    from paddle_tpu_torch import device as pdev, rng

    rng.seed(0)
    with pdev.device_guard(other):
        ref = second_encoder(cfg)
    with pdev.device_guard(device):
        net = second_encoder(cfg)
    net.load_state_dict(ref.state_dict())
    idx, feats = scan if scan is not None else \
        scan_batch(cfg, 1, max_voxels, seed=100)
    full = (1,) + tuple(cfg["sparse_shape"]) + (cfg["in_channels"],)
    target = np.random.RandomState(2).standard_normal(
        bev_shape(cfg, 1)).astype(np.float32)
    got = _sparse_step(net, idx, feats, full, target, device)
    t0 = time.perf_counter()
    want = _sparse_step(ref, idx, feats, full, target, other,
                        masks=[keep for _, keep in got["relus"]]
                        if follow_masks else None)
    res = {"voxels": int(idx.shape[1]),
           "other_step_s": round(time.perf_counter() - t0, 3)}
    flips, flip_rel = [], 0.0
    for v, keep in want["relus"]:
        off = (v > 0) != keep
        flips.append(int(off.sum()))
        if flips[-1]:
            flip_rel = max(flip_rel, float(v[off].abs().max())
                           / max(float(v.abs().max()), 1e-30))
    res["relu_flips"], res["relu_flip_rel"] = flips, flip_rel
    res["differing_layers"] = [
        i for i, (g, w) in enumerate(zip(got["layers"], want["layers"]))
        if g["counts"] != w["counts"] or not all(
            torch.equal(g[k], w[k]) for k in ("sites", "in_rows",
                                              "out_rows"))]
    res["sites_per_layer"] = [int(w["sites"].shape[1])
                              for w in want["layers"]]
    res["pairs_per_layer"] = [sum(w["counts"]) for w in want["layers"]]
    res["losses"] = [got["loss"], want["loss"]]
    res["bev_rel_err"] = _max_rel_err(got["bev"], want["bev"])
    res["grad_rel_err"] = {n: _max_rel_err(got["grads"][n], w)
                           for n, w in want["grads"].items()}
    return res


def check_sparse_train(res: dict, parity: dict, shape: dict) -> None:
    """The holds of ``sparse_train`` (:func:`phase_sparse_train`)."""
    if res["first_layer_neighbours"] < MIN_NEIGHBOURS:
        raise AssertionError(f"sparse_train: {res['first_layer_neighbours']}"
                             f" active neighbours a first-layer site, want "
                             f">= {MIN_NEIGHBOURS}")
    losses = res["losses"]
    if not np.all(np.isfinite(losses)) or not losses[-2] < losses[0]:
        raise AssertionError(f"sparse_train: losses {losses} (the last "
                             f"step of batch 0 must be below its first)")
    if set(res["host_reads_per_step"]) != {SECOND_RULEBOOKS} or \
            res["host_reads_per_step"] != res["rulebooks_per_step"]:
        raise AssertionError(
            f"sparse_train: host reads a step {res['host_reads_per_step']}"
            f", rulebooks {res['rulebooks_per_step']}; want one read for "
            f"each of {SECOND_RULEBOOKS} rulebooks")
    if parity["differing_layers"]:
        raise AssertionError(f"sparse_train: layers "
                             f"{parity['differing_layers']} differ in sites "
                             f"or rulebook pairs between the card and the "
                             f"CPU")
    worst = max([parity["bev_rel_err"], parity["relu_flip_rel"]] + list(
        parity["grad_rel_err"].values()))
    if worst > SPARSE_PARITY_TOLERANCE:
        raise AssertionError(f"sparse_train: BEV map, gradient or ReLU "
                             f"flip error {worst} of the largest "
                             f"magnitude, above {SPARSE_PARITY_TOLERANCE}")


def phase_sparse_train(cfg: dict = SECOND, shape: dict = SECOND_TRAIN,
                       device: str = "cuda") -> dict:
    """SECOND's sparse middle encoder (``SECOND``) trained on the card:
    batches of 6 KITTI-like scans (:func:`lidar_scan`, up to 16,000 voxels
    each), 12 AdamW steps on the mean square of the BEV map ``[6, 256,
    200, 176]`` against a seeded target, each step building its
    rulebooks on the card.  Prints the first layer's mean active
    neighbours, step ms (median and quartiles after 2 warm-up steps), the
    ms building rulebooks against the ms in gather-GEMM-scatter (forward
    and backward), host reads and rulebooks a step, active sites per
    layer, peak memory, the idle share over 2 traced steps; then a batch-1
    step against the CPU (TF32 off): every layer's sites and rulebook
    pairs equal, the BEV map and every gradient within
    ``SPARSE_PARITY_TOLERANCE`` of their largest magnitude, the CPU on the
    card's ReLU masks (:func:`drive_sparse_parity`) and every ReLU input
    where they differ from its own within that share of its layer's
    largest."""
    t0 = time.perf_counter()
    res = drive_sparse_train(cfg, shape, device)
    res["train_s"] = round(time.perf_counter() - t0, 3)
    parity = drive_sparse_parity(cfg, shape["max_voxels"], device)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit("sparse_train", model="SECOND SparseEncoder (mmdet3d hv_second_"
         "secfpn_6x8_80e_kitti-3d-car)", dtype="float32",
         tf32={"cudnn": torch.backends.cudnn.allow_tf32,
               "matmul": torch.backends.cuda.matmul.allow_tf32},
         sparse_shape=cfg["sparse_shape"], shape=shape, parity=parity,
         **res)
    check_sparse_train(res, parity, shape)
    return res


# ---- signal_fft: Whisper's spectrogram front end -----------------------------

#: openai/whisper ``whisper/audio.py``: 16 kHz audio in 30-s chunks of
#: 480,000 samples, ``N_FFT`` 400, ``HOP_LENGTH`` 160, a periodic Hann
#: window (``torch.hann_window(N_FFT)``), centred reflect padding: an STFT
#: of ``[chunks, 201, 3001]``; beside it the 2-D and n-D transforms at
#: ``fft_shape``
WHISPER = {"sample_rate": 16000, "n_fft": 400, "hop_length": 160,
           "chunk_s": 30, "chunks": 16, "fft_shape": (16, 512, 512)}

#: card against CPU: the largest error within this share of the largest
#: magnitude
SIGNAL_TOLERANCE = 1e-4


def _timed_ms(fn, cuda: bool, reps: int = 5) -> float:
    """``fn()``'s warm milliseconds: the median of ``reps`` calls after
    one (CUDA events on the card, the host clock on the CPU)."""
    fn()
    return _quartiles([_step_ms(fn, cuda)[1] for _ in range(reps)])[
        "median"]


def drive_signal_fft(cfg: dict, device: str, other: str = "cpu") -> dict:
    """``signal_fft``'s drive (:func:`phase_signal_fft`): each transform on
    ``device`` against ``other`` on the same seeded input, its error
    relative to the largest magnitude on ``other`` and its warm ms on
    ``device``."""
    from paddle_tpu_torch import fft, signal

    cuda = torch.device(device).type == "cuda"
    n = cfg["sample_rate"] * cfg["chunk_s"]
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    rs = np.random.RandomState(0)
    audio = (0.1 * rs.standard_normal((cfg["chunks"], n))).astype(np.float32)
    grid = rs.standard_normal(cfg["fft_shape"]).astype(np.float32)
    res = {}

    def on(dev):
        x = torch.from_numpy(audio).to(dev)
        w = torch.hann_window(n_fft, device=dev)
        spec = signal.stft(x, n_fft, hop_length=hop, window=w)
        a = torch.from_numpy(grid).to(dev)
        half = fft.rfft2(a)
        return {
            "stft": lambda: signal.stft(x, n_fft, hop_length=hop, window=w),
            "istft": lambda: signal.istft(spec, n_fft, hop_length=hop,
                                          window=w, length=n),
            "rfft2": lambda: fft.rfft2(a),
            "irfft2": lambda: fft.irfft2(half, s=a.shape[-2:]),
            "fftn": lambda: fft.fftn(a),
            "hfftn": lambda: fft.hfftn(half, s=a.shape[-2:], axes=(-2, -1)),
        }

    mine, ref = on(device), on(other)
    for name, fn in mine.items():
        got, want = fn(), ref[name]()
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
            raise AssertionError(f"signal_fft: {name} gave {list(got.shape)}"
                                 f" {got.dtype}, the CPU {list(want.shape)}"
                                 f" {want.dtype}")
        res[name] = {"shape": list(got.shape), "dtype": str(got.dtype),
                     "rel_err": _mag_err(got.cpu(), want),
                     "ms": _timed_ms(fn, cuda)}
    back = mine["istft"]().cpu()
    res["istft"]["max_abs_vs_x"] = float((back - torch.from_numpy(audio))
                                         .abs().max())
    return res


def _mag_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error's magnitude over the largest magnitude of
    ``want`` (complex values by their modulus), in double precision."""
    wide = torch.complex128 if want.is_complex() else torch.float64
    got, want = got.to(wide), want.to(wide)
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / max(scale, 1e-30)


def check_signal_fft(res: dict, cfg: dict) -> None:
    n = cfg["sample_rate"] * cfg["chunk_s"]
    want = [cfg["chunks"], cfg["n_fft"] // 2 + 1,
            1 + n // cfg["hop_length"]]
    if res["stft"]["shape"] != want or res["stft"]["dtype"] != \
            "torch.complex64":
        raise AssertionError(f"signal_fft: stft gave {res['stft']}, want "
                             f"{want} complex64")
    bad = {k: v["rel_err"] for k, v in res.items()
           if v["rel_err"] > SIGNAL_TOLERANCE}
    if bad:
        raise AssertionError(f"signal_fft: card against CPU beyond "
                             f"{SIGNAL_TOLERANCE}: {bad}")


def phase_signal_fft(cfg: dict = WHISPER, device: str = "cuda") -> dict:
    """Whisper's spectrogram front end (``WHISPER``): ``signal.stft`` of 16
    seeded 30-s chunks (``[16, 201, 3001]`` complex64) on the card
    against the CPU within ``SIGNAL_TOLERANCE`` of the largest magnitude,
    ``istft(stft(x))``'s largest error against ``x``, and ``fft.rfft2``,
    ``irfft2``, ``fftn`` and ``hfftn`` at ``[16, 512, 512]`` held the same
    way; each one's warm ms."""
    t0 = time.perf_counter()
    res = drive_signal_fft(cfg, device)
    emit("signal_fft", config="openai/whisper audio.py (16 kHz, N_FFT 400, "
         "HOP_LENGTH 160, 30-s chunks)", against="cpu",
         tolerance=SIGNAL_TOLERANCE, cfg=cfg, transforms=res,
         seconds=round(time.perf_counter() - t0, 3))
    check_signal_fft(res, cfg)
    return res


# ---- distributions: draws, densities and KLs on the card ---------------------

#: draws a distribution makes on the card (each moment then has a standard
#: error of about sd / 2048)
DIST_SAMPLES = 2 ** 22
#: moments within this many standard errors of the closed forms
DIST_SIGMAS = 5.0
#: log_prob, entropy and KL on the card against the CPU: the largest error
#: within this share of the largest magnitude
DIST_TOLERANCE = 1e-5


def distribution_cases(device) -> dict:
    """The six distributions of the phase (seeded parameters on
    ``device``), each with the closed-form mean and variance of a draw
    (per element, as numpy arrays) and a value to score."""
    from paddle_tpu_torch import distribution as D

    rs = np.random.RandomState(0)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    logits = rs.standard_normal(1000).astype(np.float32)
    p = np.exp(logits.astype(np.float64) - logits.max())
    p /= p.sum()
    k = np.arange(1000)
    cat_mean = float((p * k).sum())
    probs = rs.uniform(0.2, 1.0, 8)
    probs /= probs.sum()
    a, b = np.array([0.5, 2.0, 5.0]), np.array([0.5, 3.0, 1.5])
    conc = np.array([0.3, 1.0, 2.0, 4.0])
    c0 = conc.sum()
    loc, scale = np.array([0.5, -1.0]), np.array([1.0, 2.5])
    low, high = np.array([-1.0, 2.0]), np.array([1.0, 5.0])
    return {
        "Normal": (D.Normal(t(loc), t(scale)), loc, scale ** 2,
                   t([0.3, 1.0])),
        "Uniform": (D.Uniform(t(low), t(high)), (low + high) / 2,
                    (high - low) ** 2 / 12, t([0.5, 3.0])),
        "Categorical": (D.Categorical(t(logits)), cat_mean,
                        float((p * k * k).sum()) - cat_mean ** 2,
                        torch.tensor([3, 999], device=device)),
        "Multinomial": (D.Multinomial(10, t(probs)), 10 * probs,
                        10 * probs * (1 - probs),
                        t([1, 2, 0, 3, 1, 1, 2, 0])),
        "Beta": (D.Beta(t(a), t(b)), a / (a + b),
                 a * b / ((a + b) ** 2 * (a + b + 1)), t([0.3, 0.5, 0.9])),
        "Dirichlet": (D.Dirichlet(t(conc)), conc / c0,
                      conc * (c0 - conc) / (c0 ** 2 * (c0 + 1)),
                      t([0.1, 0.2, 0.3, 0.4])),
    }


def _moments(x: torch.Tensor) -> tuple:
    """Per element: the sample mean, variance and fourth central moment
    (f64, on the draw's device), as numpy arrays."""
    x = x.to(torch.float64).reshape(x.shape[0], -1)
    m = x.mean(0)
    c = x - m
    v = (c * c).mean(0)
    return (m.cpu().numpy(), v.cpu().numpy(),
            (c ** 4).mean(0).cpu().numpy())


def _law_sigmas(x: torch.Tensor, mean, var) -> tuple:
    """How many standard errors the sample mean and variance lie from the
    closed forms (the largest over elements)."""
    n = x.shape[0]
    m, v, m4 = _moments(x)
    mean = np.broadcast_to(np.asarray(mean, np.float64),
                           x.shape[1:]).reshape(-1)
    var = np.broadcast_to(np.asarray(var, np.float64),
                          x.shape[1:]).reshape(-1)
    z_mean = np.abs(m - mean) / np.sqrt(var / n)
    z_var = np.abs(v - var) / np.sqrt(np.maximum(m4 - v * v, 1e-300) / n)
    return float(z_mean.max()), float(z_var.max())


def _scores(cases: dict) -> dict:
    """Each distribution's ``log_prob`` at its value and ``entropy``, and
    every registered KL between two members, as CPU tensors."""
    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch.distribution import kl

    out = {}
    for name, (dist, _, _, value) in cases.items():
        out[f"{name}.log_prob"] = dist.log_prob(value)
        out[f"{name}.entropy"] = dist.entropy()
    dev = cases["Normal"][0].loc.device

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    other = {"Normal": D.Normal(t([0.0, 1.0]), t([2.0, 0.5])),
             "Uniform": D.Uniform(t([-2.0, 1.0]), t([2.0, 6.0])),
             "Categorical": D.Categorical(cases["Categorical"][0].logits
                                          .flip(0)),
             "Beta": D.Beta(t([1.5, 1.0, 2.0]), t([2.5, 0.7, 3.0])),
             "Dirichlet": D.Dirichlet(t([1.0, 0.5, 3.0, 2.0]))}
    for name, q in other.items():
        out[f"kl({name}, {name})"] = D.kl_divergence(cases[name][0], q)
    for name in ("Beta", "Dirichlet"):
        out[f"bregman({name}, {name})"] = kl._kl_expfamily_expfamily(
            cases[name][0], other[name])
    return {k: v.detach().cpu() for k, v in out.items()}


def drive_distributions(device: str, n: int = DIST_SAMPLES,
                        other: str = "cpu") -> dict:
    """``distributions``' drive (:func:`phase_distributions`)."""
    from paddle_tpu_torch import distribution as D, jit, rng

    cuda = torch.device(device).type == "cuda"
    cases = distribution_cases(device)
    res = {"samples": n, "draws": {}}
    for i, (name, (dist, mean, var, _)) in enumerate(cases.items()):
        rng.seed(i)
        x, ms = _step_ms(lambda: dist.sample((n,)), cuda)
        z_mean, z_var = _law_sigmas(x, mean, var)
        res["draws"][name] = {"shape": list(x.shape), "dtype": str(x.dtype),
                              "ms": round(ms, 3), "mean_sigmas": z_mean,
                              "var_sigmas": z_var}
    mine, ref = _scores(cases), _scores(distribution_cases(other))
    res["scores_rel_err"] = {k: _mag_err(mine[k], ref[k]) for k in ref}
    # Normal.rsample inside a jit.to_static CUDA graph: the first call runs
    # eagerly, the second captures and replays, the third replays
    normal, mean, var, _ = cases["Normal"]
    sample = jit.to_static(lambda loc, scale: D.Normal(loc, scale)
                           .rsample((n,)))
    gen = rng.default_generator(normal.loc.device)
    offsets, draws = [int(gen.get_state()[1])], []
    for _ in range(3):
        draws.append(sample(normal.loc, normal.scale))
        offsets.append(int(gen.get_state()[1]))
    res["graph"] = {"captures": sample.captures, "hits": sample.hits,
                    "offsets": offsets,
                    "replays_differ": not torch.equal(draws[1], draws[2]),
                    "sigmas": [_law_sigmas(d, mean, var) for d in draws]}
    return res


def check_distributions(res: dict, cuda: bool) -> None:
    for name, d in res["draws"].items():
        if max(d["mean_sigmas"], d["var_sigmas"]) > DIST_SIGMAS:
            raise AssertionError(f"distributions: {name}'s draws lie "
                                 f"{d['mean_sigmas']:.2f} / "
                                 f"{d['var_sigmas']:.2f} standard errors "
                                 f"from the closed-form mean / variance")
    bad = {k: v for k, v in res["scores_rel_err"].items()
           if v > DIST_TOLERANCE}
    if bad:
        raise AssertionError(f"distributions: beyond {DIST_TOLERANCE} of "
                             f"the CPU: {bad}")
    g = res["graph"]
    steps = [b - a for a, b in zip(g["offsets"], g["offsets"][1:])]
    if steps != [1, 1, 1] or not g["replays_differ"] or \
            max(max(s) for s in g["sigmas"]) > DIST_SIGMAS:
        raise AssertionError(f"distributions: rsample under to_static "
                             f"{g}")
    if cuda and g["captures"] != 1:
        raise AssertionError(f"distributions: {g['captures']} captures")


def phase_distributions(device: str = "cuda") -> dict:
    """``DIST_SAMPLES`` draws on the card from each of Normal, Uniform,
    Categorical (1,000 classes), Multinomial, Beta and Dirichlet, their
    means and variances within ``DIST_SIGMAS`` standard errors of the
    closed forms; ``log_prob``, ``entropy`` and every registered KL (and
    the Bregman KL of the exponential family) on the card against the CPU
    within ``DIST_TOLERANCE`` of the largest magnitude; ``Normal.rsample``
    inside a ``jit.to_static`` CUDA graph: two replays drawing different
    values that hold the law, the generator's offset moving one a call as
    in eager mode.  Prints each draw's ms."""
    t0 = time.perf_counter()
    res = drive_distributions(device)
    emit("distributions", against="cpu", tolerance=DIST_TOLERANCE,
         sigmas=DIST_SIGMAS, seconds=round(time.perf_counter() - t0, 3),
         **res)
    check_distributions(res, torch.device(device).type == "cuda")
    return res



# -- phases 34 and 35: the static program mode and the extension points --------

#: GPT-2 345M trained through the static program mode, at full width, f32
STATIC_TRAIN = {"config": "gpt2-345m", "batch": 8, "seq": 1024, "steps": 12,
                "eager_steps": 3, "lr": 1e-4}
#: the CPU rehearsal's model (tests/test_torch_static_program.py)
STATIC_TINY = {"config": "tiny"}
#: the program's first losses against the eager model's, relative
STATIC_LOSS_RTOL = 1e-5
#: the loaded inference program's logits against the live program's
STATIC_INFER_TOL = 1e-4
#: the static_train and extensions phases' budgets, seconds
STATIC_BUDGET_S, EXTENSIONS_BUDGET_S = 60, 15


def static_gpt(cfg: dict, device):
    """GPT (dropout 0) with weights drawn from seed 0 on ``device``."""
    from paddle_tpu_torch import models

    config = models.GPT_CONFIGS[cfg["config"]](
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    gen = torch.Generator(device=device).manual_seed(0)
    return models.GPTForCausalLM(config, device=device, generator=gen)


def static_kernel_calls(stats) -> dict:
    """Calls of K1-K3's f32 instances in a profile's device table, by
    kernel (names demangled or not)."""
    out = {n: 0 for n in TRAIN_KERNELS}
    for name, ev in stats.device.items():
        label = kernel_label(name)
        for n in TRAIN_KERNELS:
            if re.search(rf"\b{n}_kernel<(float|f32)\b", label):
                out[n] += ev.call
    return out


def profile_static_steps(exe, main, loss, batches, root: str,
                         ready: int = 1) -> dict:
    """Steps under the ported ``Profiler``: CLOSED, ``ready`` READY (the
    tracer's warm-up), RECORD, RECORD_AND_RETURN, each in a
    ``RecordEvent("static_step")``; its host and device tables' counts and
    the window's device busy share."""
    from paddle_tpu_torch import profiler

    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(closed=1, ready=ready, record=2,
                                          repeat=1),
        on_trace_ready=profiler.export_chrome_tracing(root))
    prof.start()
    for x, y in batches[:3 + ready]:
        with profiler.RecordEvent("static_step"):
            exe.run(main, feed={"input_ids": x, "labels": y},
                    fetch_list=[loss])
        prof.step()
    prof.stop()
    stats = prof.statistic_data()
    prof.summary(row_limit=8)
    step = stats.host.get("static_step")
    return {"trace": prof.chrome_trace_path,
            "static_step_calls": step.call if step else 0,
            "kernel_calls": static_kernel_calls(stats),
            "device_busy_ms": round(stats.device_busy_us / 1e3, 3),
            "wall_ms": round(stats.wall_us / 1e3, 3),
            "idle_share": round(1 - stats.device_busy_us / stats.wall_us, 4)}


def drive_static_train(cfg: dict, batch: int, seq: int, device: str,
                       steps: int, eager_steps: int, lr: float = 1e-4,
                       profile: bool = False) -> dict:
    """GPT through the static program mode: the eager model's first
    ``eager_steps`` AdamW steps on seeded batches; then the same model
    (same seed) built under ``enable_static()`` and ``program_guard``,
    ``static.data`` feeds ``[batch, seq]``, ``AdamW(None).minimize(loss)``
    and ``steps`` ``Executor.run`` calls on the same batches (launch counts
    and step times of these); ``profile``: four more steps under the
    ``Profiler``; then a forward-only program at batch 1 through
    ``save_inference_model`` and ``load_inference_model`` onto the device,
    its logits against the live program's."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_start = time.perf_counter()
    vocab = pt.models.GPT_CONFIGS[cfg["config"]]().vocab_size
    rs = np.random.RandomState(1)
    batches = [(rs.randint(0, vocab, (batch, seq)).astype(np.int64),
                rs.randint(0, vocab, (batch, seq)).astype(np.int64))
               for _ in range(max(steps, 4))]
    ref = static_gpt(cfg, dev)
    opt = AdamW(ref.parameters(), lr=lr)
    eager = []
    for x, y in batches[:eager_steps]:
        loss = ref.compute_loss(torch.from_numpy(x).to(dev),
                                torch.from_numpy(y).to(dev))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(float(loss.detach()))
    del ref, opt, loss
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pt.enable_static()
    try:
        main, startup = static.Program(), static.Program()
        with pt.device_guard(dev), static.program_guard(main, startup):
            model = static_gpt(cfg, dev)
            ids = static.data("input_ids", [batch, seq], "int64")
            labels = static.data("labels", [batch, seq], "int64")
            loss = model.compute_loss(ids, labels)
            AdamW(None, lr=lr).minimize(loss)
    finally:
        pt.disable_static()
    record_s = time.perf_counter() - t0
    exe = static.Executor()
    exe.run(startup)
    kernels.reset_launches()
    losses, ms = [], []
    for x, y in batches[:steps]:
        t0 = time.perf_counter()
        lv, = exe.run(main, feed={"input_ids": x, "labels": y},
                      fetch_list=[loss])
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lv))
    launches = kernels.launch_counts()
    step_fn, = main._train_cache.values()
    res = {"model": cfg["config"], "params": sum(
               p.numel() for p in model.parameters()),
           "layers": model.config.num_hidden_layers, "batch": batch,
           "seq": seq, "steps": steps, "ops": len(main.ops),
           "leaves": len(main._leaves), "record_s": round(record_s, 3),
           "eager_losses": eager, "losses": losses,
           "loss_rel_err": max(abs(a - b) / abs(b)
                               for a, b in zip(losses, eager)),
           "train_programs": len(main._train_cache),
           "captures": step_fn.captures, "hits": step_fn.hits,
           "launches": {n: launches.get(n, 0) for n in TRAIN_KERNELS},
           "step_ms_each": [round(m, 3) for m in ms],
           # the first two calls build the program (eager, then capture)
           "step_ms": _quartiles(ms[2:] if len(ms) > 4 else ms)}
    res["tokens_per_s"] = round(batch * seq / (res["step_ms"]["median"]
                                               / 1e3), 1)
    if cuda:
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if profile:
        with tempfile.TemporaryDirectory() as root:
            res["profile"] = profile_static_steps(exe, main, loss, batches,
                                                  root)
            # the same window without the warm-up step (not held: what a
            # cold start of the tracer loses)
            res["profile_cold"] = profile_static_steps(
                exe, main, loss, batches, root, ready=0)
    pt.enable_static()
    try:
        infer = static.Program()
        with pt.device_guard(dev), static.program_guard(infer):
            ids1 = static.data("input_ids", [1, seq], "int64")
            logits = model(ids1)
    finally:
        pt.disable_static()
    x1 = batches[0][0][:1]
    live, = exe.run(infer, feed={"input_ids": x1}, fetch_list=[logits])
    with tempfile.TemporaryDirectory() as root:
        prefix = os.path.join(root, "gpt")
        t0 = time.perf_counter()
        static.save_inference_model(prefix, [ids1], [logits], exe,
                                    program=infer)
        res["save_s"] = round(time.perf_counter() - t0, 3)
        prog, names, fetches = static.load_inference_model(
            prefix, static.Executor(), device=dev)
    kernels.reset_launches()
    got, = exe.run(prog, feed={"input_ids": x1}, fetch_list=fetches)
    res["infer_launches"] = kernels.launch_counts().get("flash_fwd", 0)
    res["infer_shape"] = list(got.shape)
    res["infer_err"] = float(np.abs(got - live).max())
    res["infer_finite"] = bool(np.isfinite(got).all())
    res["seconds"] = round(time.perf_counter() - t_start, 3)
    return res


def check_static_train(res: dict, layers: int, steps: int) -> None:
    holds = {
        "losses": res["loss_rel_err"] <= STATIC_LOSS_RTOL,
        "one_capture": res["train_programs"] == 1 and res["captures"] == 1,
        "launches": all(res["launches"][n] == layers * steps
                        for n in TRAIN_KERNELS),
        "profile": res["profile"]["static_step_calls"] == 2 and all(
            c == 2 * layers
            for c in res["profile"]["kernel_calls"].values()),
        "inference": res["infer_err"] <= STATIC_INFER_TOL
        and res["infer_finite"] and res["infer_launches"] == layers}
    emit("static_train_holds", **holds)
    broken = [k for k, ok in holds.items() if not ok]
    if broken:
        raise AssertionError(f"static_train: {broken} do not hold")


def phase_static_train() -> dict:
    """GPT-2 345M (f32, TF32 off) trained through ``Executor.run``
    (``STATIC_TRAIN``): the first 3 losses within ``STATIC_LOSS_RTOL`` of
    the eager model's, one train program and one capture, K1-K3's f32
    instances 24 launches a step; step ms (median and quartiles after the
    two build calls), tokens/s, peak; four more steps under the
    ``Profiler`` (``static_step`` exactly 2 calls, each of K1-K3 exactly
    48, the window's idle share); the batch-1 inference program saved and
    loaded onto the card, its logits against the live program's and K1
    launching."""
    c = STATIC_TRAIN
    res = drive_static_train(c, c["batch"], c["seq"], "cuda", c["steps"],
                             c["eager_steps"], c["lr"], profile=True)
    emit("static_train", dtype="float32", tf32=False,
         budget_s=STATIC_BUDGET_S, **res)
    check_static_train(res, res["layers"], c["steps"])
    return res


#: the C++ source of tests/test_custom_kernel.py (read from the file: the
#: test module imports the JAX package)
def custom_kernel_cpp_src() -> str:
    text = open(os.path.join("tests", "test_custom_kernel.py")).read()
    return re.search(r'CPP_SRC = r"""(.*?)"""', text, re.S).group(1)


HUBCONF = """
import torch
import paddle_tpu_torch as pt


def tiny_mlp(hidden=8):
    \"\"\"A 4 -> hidden -> 3 MLP of the port's layers, on the current
    device.\"\"\"
    return pt.nn.Sequential(pt.nn.Linear(4, hidden), pt.nn.ReLU(),
                            pt.nn.Linear(hidden, 3))
"""


def drive_extensions(device: str, root: str) -> dict:
    """The extension points on ``device``: a ``register_op`` with a
    ``vjp`` eagerly and in a ``to_static`` program (on the card its
    capture and replays), gradients equal; a ``register_kernel`` for
    ``"relu"`` on the gpu backend taken by CUDA tensors only; a
    ``cpp_extension`` op against ``F.softsign`` and refused in a capture
    (``CaptureError`` naming it); ``hub.load`` of a local hubconf."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import hub, jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.utils import (cpp_extension, register_kernel,
                                        register_op, unregister_kernel)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    out = {}
    cube = register_op("smoke_cube", lambda x: x ** 3,
                       vjp=lambda xs, g: (3 * xs[0] ** 2 * g,))
    x = torch.linspace(-2, 2, 4096, device=dev)

    def value_and_grad(t):
        t = t.detach().requires_grad_()
        y = cube(t)
        g, = torch.autograd.grad(y.sum(), t)
        return y.detach(), g

    want_y, want_g = value_and_grad(x)
    compiled = jit.to_static(value_and_grad)
    errs = []
    for i in range(3):                       # eager, capture, replay
        y, g = compiled(x + 0.0 * i)
        errs.append(max(float((y - want_y).abs().max()),
                        float((g - want_g).abs().max())))
    out["register_op"] = {"max_abs_err": max(errs),
                          "captures": compiled.captures,
                          "grad_vs_3x2": float((want_g - 3 * x ** 2)
                                               .abs().max())}
    unregister_kernel("smoke_cube")
    register_kernel("relu", lambda x, name=None: x * 0.0 + 42.0,
                    backend="gpu")
    try:
        on_card = F.relu(torch.tensor([-1.0, 5.0], device=dev))
        on_cpu = F.relu(torch.tensor([-1.0, 5.0]))
    finally:
        unregister_kernel("relu", backend="gpu")
    out["register_kernel"] = {"card": on_card.tolist(),
                              "cpu": on_cpu.tolist()}
    src = os.path.join(root, "my_ops.cc")
    with open(src, "w") as f:
        f.write(custom_kernel_cpp_src())
    t0 = time.perf_counter()
    ext = cpp_extension.load("smoke_ops", [src],
                             functions={"twice_plus_one": {},
                                        "softsign_ref": {}},
                             build_directory=root)
    out["cpp_build_s"] = round(time.perf_counter() - t0, 3)
    v = torch.randn(4096, generator=torch.Generator().manual_seed(0)) \
        .to(dev)
    out["cpp_softsign_err"] = float((ext.softsign_ref(v) - F.softsign(v))
                                    .abs().max())
    out["cpp_device"] = str(ext.softsign_ref(v).device)
    twice = jit.to_static(lambda t: ext.twice_plus_one(t) * 2.0)
    first = twice(v)
    out["cpp_eager_err"] = float((first - (2 * v + 1) * 2).abs().max())
    refused = None
    if cuda:
        try:
            twice(v)
        except jit.CaptureError as e:
            refused = str(e)
    out["cpp_capture_refused"] = refused
    hub_dir = os.path.join(root, "hub")
    os.makedirs(hub_dir)
    with open(os.path.join(hub_dir, "hubconf.py"), "w") as f:
        f.write(HUBCONF)
    with pt.device_guard(device):
        net = hub.load(hub_dir, "tiny_mlp", hidden=16)
    out["hub"] = {"entries": hub.list(hub_dir),
                  "device": str(net.parameters()[0].device),
                  "out_shape": list(net(torch.ones(2, 4, device=dev))
                                    .shape)}
    return out


def check_extensions(res: dict, cuda: bool) -> None:
    holds = {
        "register_op": res["register_op"]["max_abs_err"] <= 1e-6
        and res["register_op"]["grad_vs_3x2"] <= 1e-5
        and res["register_op"]["captures"] == (1 if cuda else 0),
        "register_kernel": res["register_kernel"]["card" if cuda else "cpu"]
        == ([42.0, 42.0] if cuda else [0.0, 5.0])
        and res["register_kernel"]["cpu"] == [0.0, 5.0],
        "cpp_extension": res["cpp_softsign_err"] <= 1e-6
        and res["cpp_eager_err"] <= 1e-6,
        "cpp_capture_refused": not cuda or (
            res["cpp_capture_refused"] is not None
            and "smoke_ops.twice_plus_one" in res["cpp_capture_refused"]),
        "hub": res["hub"]["entries"] == ["tiny_mlp"]
        and res["hub"]["out_shape"] == [2, 3]}
    emit("extensions_holds", **holds)
    broken = [k for k, ok in holds.items() if not ok]
    if broken:
        raise AssertionError(f"extensions: {broken} do not hold")


def phase_extensions() -> dict:
    """``drive_extensions`` on the card (module docstring, phase 35)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        res = drive_extensions("cuda", root)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit("extensions", budget_s=EXTENSIONS_BUDGET_S, **res)
    check_extensions(res, True)
    return res


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401 — fails outside the repository

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    CARD = card_line()
    emit("start", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0))
    records = phase_kernels(phase_build())
    model, paged = phase_serve_paged()
    gc.collect()
    torch.cuda.empty_cache()
    meshed = phase_serve_mesh(model, paged["outputs"])
    phase_serve_contiguous(model)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_gpt()
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity()
    phase_graph_parity()
    phase_serve_overload(model)
    gc.collect()
    torch.cuda.empty_cache()
    durable = phase_serve_durable(model)
    gc.collect()
    torch.cuda.empty_cache()
    spec = phase_serve_spec(model, paged["outputs"])
    gc.collect()
    torch.cuda.empty_cache()
    tenancy = phase_serve_tenancy(model)
    gc.collect()
    torch.cuda.empty_cache()
    resilience = phase_serve_resilience(model)
    gc.collect()
    torch.cuda.empty_cache()
    fleet = phase_serve_fleet(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    f16 = phase_serve_f16()
    drill = phase_sigkill_drill()
    phase_overload_parity()
    phase_spec_parity()
    phase_tenancy_parity()
    phase_parity_f16()
    predictor = phase_predictor()
    gc.collect()
    torch.cuda.empty_cache()
    generate = phase_dy2static_generate(BUILD_SECONDS)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = phase_hybrid_train(train)
    gc.collect()
    torch.cuda.empty_cache()
    elastic = phase_elastic_train(train)
    ring = phase_ring_attention()
    gc.collect()
    torch.cuda.empty_cache()
    auto = phase_auto_parallel_train(train)
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe_train()
    gc.collect()
    torch.cuda.empty_cache()
    train_o1 = phase_train_o1()
    gc.collect()
    torch.cuda.empty_cache()
    fp16 = phase_train_fp16_scaler()
    gc.collect()
    torch.cuda.empty_cache()
    recipe = phase_train_recipe()
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity()
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity_bf16()
    gc.collect()
    torch.cuda.empty_cache()
    train_res = phase_train_resilience(train["losses"][0])
    gc.collect()
    torch.cuda.empty_cache()
    nn_enc = phase_nn_encoder()
    gc.collect()
    torch.cuda.empty_cache()
    phase_seq2seq()
    gc.collect()
    torch.cuda.empty_cache()
    hapi = phase_hapi_fit()
    gc.collect()
    torch.cuda.empty_cache()
    phase_ops()
    gc.collect()
    torch.cuda.empty_cache()
    phase_resnet_fit()
    gc.collect()
    torch.cuda.empty_cache()
    phase_mobilenet_fit()
    gc.collect()
    torch.cuda.empty_cache()
    phase_vision_ops()
    gc.collect()
    torch.cuda.empty_cache()
    t_slice = time.perf_counter()
    phase_sparse_train()
    gc.collect()
    torch.cuda.empty_cache()
    phase_signal_fft()
    phase_distributions()
    slice_s = round(time.perf_counter() - t_slice, 3)
    gc.collect()
    torch.cuda.empty_cache()
    t_static = time.perf_counter()
    static = phase_static_train()
    gc.collect()
    torch.cuda.empty_cache()
    phase_extensions()
    static_s = round(time.perf_counter() - t_static, 3)
    launches = {**paged["launches"],
                **{n: train["launches"][n] for n in TRAIN_KERNELS},
                **{n: recipe[n] for n in RECIPE_KERNELS},
                **{n: fp16[n] for n in F16_KERNELS + F16_DROPOUT_KERNELS},
                **{n: f16["llama2-7b"][n] for n in F16_SERVE_KERNELS},
                "graph_conditional":
                    generate["launches"].get("graph_conditional", 0),
                **{f"{n}_f32": static["launches"][n] for n in TRAIN_KERNELS}}
    records["graph_conditional"] = generate["record"]
    by_phase = {"serve_paged": paged["launches"],
                "serve_mesh": meshed,
                "serve_f16": _sum_launches(*f16.values()),
                "predictor": predictor,
                "dy2static_generate": generate["launches"],
                "serve_durable": durable["launches"],
                "serve_spec": spec,
                "serve_tenancy": tenancy,
                "serve_resilience": resilience,
                "serve_fleet": fleet,
                "sigkill_drill": drill["launches"],
                "train": train["launches"],
                "hybrid_train": hybrid["launches"],
                "elastic_train": _sum_launches(
                    *elastic["launches"].values()),
                "ring_attention": ring["launches"],
                "auto_parallel_train": auto["launches"],
                "moe_train": moe["launches"],
                "train_o1": train_o1,
                "train_fp16_scaler": fp16,
                "train_recipe": recipe,
                "train_resilience": train_res,
                "nn_encoder": nn_enc["train_launches"],
                "hapi_fit": hapi["fit_launches"],
                "static_train": {**static["launches"], **{
                    f"{n}_f32": c for n, c in static["launches"].items()}}}
    kernels_line = [{**rec, "launches": launches[name],
                     "launches_by_phase": {ph: c[name]
                                           for ph, c in by_phase.items()
                                           if c.get(name)}}
                    for name, rec in records.items()]
    emit("done", seconds=round(time.perf_counter() - t_start, 3),
         sparse_signal_distribution_seconds=slice_s,
         static_extensions_seconds=static_s)
    print(CARD)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
