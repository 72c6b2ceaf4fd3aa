"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and builds the
kernels from the checkout's sources (``csrc/``, with ``nvcc``). Every
phase raises on failure and the script then exits non-zero without
its result line:

1. the card's name and power limit (``nvidia-smi``);
2. the kernel build, with its time and ``ptxas`` report;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the same bf16 inputs at the serving path's shapes (decode at
   B = 32 with kv lens over 1..1024 and pad rows; chunked prefill at
   B = 8, T = 512, first and second chunk, and at the widest unified
   mixed step, R = 40 rows at W = 512; ragged at that same unified
   step, at a verify block, B = 32, W = 5, draft lens 0..4, at decode
   rows alone (every tile but the first dead) and at chunk rows whose
   live slots end inside a tile; page sizes 128, 64, 32 and 16), plus
   a small f32 case each at the tiny-llama geometry. Every output slot
   is compared, and the ragged kernel's dead slots and pad rows must be
   exact 0. The bf16 ragged cases are held against the plain version
   with the tensor-core walk's rounding (probabilities enter p . v as
   bf16: ``p_dtype``). Tolerance: atol = rtol = 2e-2 on bf16 outputs
   compared in f32 (one bf16 rounding of values of order 1, and sums
   taken in another order), 1e-4 on f32 outputs. A timed ragged case
   also prints the bound of writing its output alone
   (``output_bound_ms``); the dead-tile case (the headline block's 28
   decode rows and 12 pad rows, about 8,900 tiles that only write
   zeros) puts the dead tiles' cost on record. Each kernel is timed
   with CUDA events (device time: the launch is queued behind a short
   device-side wait) against its plain
   version, one ``scaled_dot_product_attention`` call over gathered
   dense K/V (a yardstick only: the port never calls it) and its bound
   on the card. A prefill or ragged case also prints the bound of its
   live slots alone (``live_bound_ms``), the part of the work a step
   uses. The headline case of each kernel runs again on an int8 cache
   (a QuantKV) quantized from the same bf16 K/V, held against the plain
   version at the same 2e-2 and timed the same way; its bound counts
   head_dim + 4 bytes (int8 values and an f32 scale) per cached token
   per kv head and plane, and SDPA runs over the dequantized dense K/V.
   Untimed int8 cases cover page size 16 and the f32 tiny-llama
   geometry (1e-4). The headline case of each kernel runs again in the
   stacked form, bf16 and int8: the case's K/V at layer 15 of a stacked
   [16, kv, pages, d, ps] cache whose other layers are random. Each is
   held against its plain version (same tolerance) and, bitwise,
   against the per-layer launch on the layer's view, and timed beside
   that per-layer launch (``per_layer_ms``); its bound and SDPA time are
   the per-layer case's. One untimed stacked decode case sits at layer
   15 of 2304 pages, an element offset past 2^31. The split decode
   kernel runs at batch 1, 4 and 32 over tables of 1024 and 4096
   tokens, at the split the wrapper picks (printed per case) and at one
   split, with rows ending inside the first split, kv lens 127, 128
   and 129 and pad rows, and its headline case is timed at 1, 2, 3, 4
   and 8 splits. The tensor-core prefill walk runs at T = 16 and 64,
   row starts off the tile and the chunk (37, 600), a kv_len one past a
   chunk edge and page sizes 32 and 64, over bf16 and int8. Two
   launches of every decode, prefill and ragged case must give equal
   bits. Each headline case also prints the time this script recorded
   for the kernel before its redesign (``before_redesign_ms``, a
   record, not a measurement of this run);
4. model: the bench-1b llama at full width, random weights, one
   512-token prefill chunk, one decode step and one 5-token verify
   block (the ragged route) through ``forward`` with the kernels and
   with their plain versions rounded as the kernels round (``impl``
   ``plain_bf16p``: bf16 probabilities into p . v in prefill and
   ragged), over a bf16 and over an int8 KV cache. Logits must agree
   to 5% of the largest, and a top-1 flip passes only where the
   reference's own margin to the kernels' pick is under
   ``NEAR_TIE_LOGITS``; flips and margins are printed. Then the same
   through the kernels over a stacked cache, whose logits must be
   bitwise those over the per-layer caches;
5. engine, no HTTP: bench-1b with the stacked layout, unified step and
   async off, 8 greedy prompts submitted together, decode_steps 1 and
   then 4 (bursts): the token streams must be byte-identical;
6. graphs, no HTTP: bench-1b, 16 greedy prompts of 64..700 tokens
   submitted together (a prefill step, unified mixed steps, then
   decode), each step replayed as a CUDA graph of its kind and bucket
   shape against the same run eager (``cuda_graphs=False``), in four
   cases: per_layer bf16 and stacked int8 KV with the unified step and
   async on, ``speculative_k`` 4 on prompts that repeat a block, and
   ``decode_steps`` 4. The greedy streams must be byte-identical, each
   key captured once, every step replayed, no step eager. In the first
   case both runs go under ``torch.profiler``: the kernels the card ran
   must be, kernel by kernel, what the launch counters say (the
   graphed run's from the replay accounting), and the host calls that
   queue work (launches, graph launches, copies) are counted per steady
   decode step both ways. A seeded request then runs alone in both
   engines: its steps run eagerly, are counted as such, and give the
   same tokens. Captures by kind, capture seconds, graph-pool bytes and
   host launches per decode step are printed;
7. sampling options, no HTTP: bench-1b, 16 prompts of 64..700 tokens
   whose rows carry the per-row options (presence and frequency
   penalties with top-20 logprobs, a repetition penalty, a +100
   ``logit_bias`` on one token, ``min_tokens`` 8 with EOS biased up,
   guided JSON whose structural bytes are biased so that it closes,
   top-20 logprobs alone) beside plain greedy rows, 32 tokens each,
   graphed and eager at decode_steps 1 and 4. The greedy streams must be
   byte-identical graphed and eager and at both decode_steps, logprobs
   within 1e-3 graphed and eager (top ids equal but at ties), every key
   captured once with no eager step, the guided rows must parse as JSON,
   the ``min_tokens`` rows hold EOS back to their minimum and the
   biased token be emitted. Captures are printed by option set;
8. serving: the port's HTTP server in-process with bench-1b at full
   width, 16 concurrent completions plus a repeated greedy one, with
   the kernels' launch counters read around the run (all three kernels
   must launch: prefill steps, unified mixed steps, decode steps). The
   server replays its steps as graphs, so the counts come from the
   replay accounting; each serving run must have captured graphs,
   replayed them and run no step eagerly, and prints its captures by
   kind. After its timed window the first run also answers one
   request with ``n`` 3, ``best_of`` 4 and ``logprobs`` 5: three
   choices in order of mean token logprob, each with its legacy
   logprobs, and the four candidates' tokens in the usage;
9. observatory, on the first serving run's server after its timed
   window (it runs with ``--request-span-log``): ``vllm:engine_mfu``
   strictly between 0 and 1, ``vllm:engine_attention_impl`` naming the
   CUDA kernels for decode, prefill and unified, ``/debug/compiles``'
   capture events by kind equal to the step graphs' own counts,
   ``/debug/memory`` with a ``device`` section whose allocated bytes
   are at least the analytic weights and KV pages; a
   ``/debug/profiler/start`` and ``stop`` around the 16 requests again,
   whose Chrome trace must name all three kernels; a request sent with
   ``x-request-id`` whose ``/debug/trace/{id}`` has its enqueue,
   prefill chunk, first token and finish; the span lines parsed and
   stitched by the repo's ``traceview`` (run as a process of its own:
   it is a standard-library script); then four greedy requests alone
   on fresh prompts, byte-identical on this server (tracer on) and on
   a server with ``--trace-ring-size 0`` (no tracer), and the steady
   decode step's wall a token at one row both ways (printed);
10. speculative serving: the same server with ``--speculative-k 4``
   (async 'auto' then resolves off), 16 concurrent greedy completions
   on prompts that repeat a block, so the n-gram proposer drafts even
   under random weights. It must draft, launch the ragged kernel
   (mixed and verify steps) and reproduce a repeated greedy request;
   it prints the draft and accepted counts, tok/s and the share of
   completion characters (one per token under the bench tokenizer)
   that agree with the spec-off server on the same prompts. That share
   is printed, not asserted: bf16 kernels may flip near-ties;
11. int8 serving: the first run's server with ``--kv-cache-dtype
    int8`` and the same 16 requests. It must launch the int8 form of
    all three kernels, make no plain call on CUDA tensors, repeat a
    greedy request exactly and show ``kv_dtype="int8"`` and the
    expanded page capacity (962 of 963 pages) on ``/metrics``; it
    prints tok/s and the share of greedy characters that agree with the
    bf16 run (printed, not asserted: int8 KV changes tokens);
12. stacked serving: the first run's server with ``--cache-layout
    stacked`` and the same requests. It must launch the stacked form of
    all three kernels and no per-layer form, make no plain call on CUDA
    tensors and repeat a greedy request exactly; it prints the share of
    greedy characters that agree with the first run (printed, not
    asserted: request timing changes the steps' composition);
13. burst serving: ``--cache-layout stacked --kv-cache-dtype int8
    --decode-steps 4 --deferred-kv-writes off`` (async ``auto`` then
    off; each iteration writes its pages, so the non-tail decode form
    runs: the tail form is the tp phase's) and the same requests.
    It must launch the int8 stacked forms only, no completion may pass
    its ``max_tokens``, the repeated greedy request must reproduce, and
    its decode dispatches must commit at least 3 tokens a row on
    average (a burst commits up to 4);
14. fleet: the fleet contract and the KV offload tier at the first
    run's configuration, the port's cache server in a thread, once with
    per_layer bf16 KV and once with stacked int8. Server A
    (``--checkpoint-interval-tokens 16``, ``--kv-remote-url``,
    ``--kv-host-pool-bytes 0``) streams a greedy chat of about 700
    prompt tokens and 64 out; the first mid-stream checkpoint frame
    whose journal does not end on a page boundary goes to server B's
    ``/v1/resume`` (a fresh engine, same weights). A shipped page must
    be 4,194,304 bytes of bfloat16 (2,228,224 of int8 with f32 scales),
    A must have shipped checkpoints, B must hit the tier, its restored
    pages on the card must equal the shipped bytes, the resumed stream
    must keep A's response id, and the kernels of the run's form must
    launch in the resume window (counters set to 0 just before it). The
    client's text (A's before the frame, then B's) is held to A's
    uninterrupted stream by tokens: equal, or parting at a near tie of
    A's logits (A's best logprob minus its logprob of B's token under
    ``NEAR_TIE_LOGITS``, the model phase's rule). The tier itself is
    held exactly: the same frame resumed on a fresh engine with no tier
    recomputes the whole journal and must give B's stream byte for
    byte. Then a migrate drain cuts a
    stream right after a checkpoint frame (``: migrating``, no end),
    new requests answer 503 with Retry-After, ``/health`` shows
    draining and the build id, ``/version`` answers, and a drain with
    exit stops the server in-process; a cold prefill of the resumed
    context is timed on a server without a tier, whose one row and
    queue of 8 at ``--shed-threshold 0.5`` then shed a batch request
    with 429 and Retry-After while an interactive one is admitted; 16
    greedy requests of 128 tokens on a page budget that forces
    preemption (with ``--preempt-to-offload on``) must preempt more
    than once, offload pages and restore a victim's pages from the
    tier, their streams held to a roomy budget's by the same near-tie
    rule. Prints the checkpoint
    tick's host ms a shipped page, a restore's ms a page and the resumed
    stream's time to first token against the cold prefill's, beside the
    card's name and power limit;
15. disagg: disaggregated prefill and decode at the first run's
    configuration, in the fleet phase's two forms (per_layer bf16,
    stacked int8), the port's cache server in a thread: a prefill-role
    server and a decode-role server on the tier (``--kv-remote-url``,
    ``--kv-host-pool-bytes 0``) and a monolithic server. The fleet
    phase's greedy chat (705 prompt tokens), 64 tokens out, goes
    through the two hops as the router sends them
    (``/v1/disagg/prefill``, then ``/v1/disagg/handoff`` with the
    descriptor), after a warm-up of the same shapes on another chat. The descriptor must name 705 // 128 =
    5 pages, ``vllm:disagg_kv_bytes_shipped_total`` grow by 5 pages
    (4,194,304 bytes a bf16 page, 2,228,224 an int8 one), the restored
    pages on the card equal the shipped bytes, the first token equal
    the monolithic server's (both ran the prefill chunks 512 + 193),
    the decode-role window (counters set to 0 just before the handoff
    hop) launch prefill (the tail) and decode and no ragged step,
    capturing no graph (the tail's chunk takes a prefill bucket the
    warm-up captured), and the roles show on ``/health``. The continuation is held to the
    monolithic stream by the near-tie rule (the decode side recomputes
    the tail, positions 640..705, in one chunk where the monolithic
    engine ran it in its second chunk and a decode step). A handoff whose pages the tier never held must recompute,
    held by the same rule. Prints the two-hop TTFT against the
    monolithic one, the ``vllm:disagg_handoff_latency_seconds`` sum and
    the prefill side's host ms a shipped page, beside the card's name
    and power limit.

16. autotune: the self-tuning controllers and the pooled routes at the
    first run's configuration with ``--speculative-k 4``, the unified
    step on and no prefix cache, on three servers, ``--autotune off``,
    ``shadow`` and ``on`` (the last two ticking every 50 ms toward a 1
    ms ITL target, so the prefill budget shrinks). Each streams 16
    greedy completions of 32 tokens, twice (a warm-up pass, then the
    counted window), on prompts that draft (4 repeat a block, 12 end on
    a bigram seen earlier in them), all queued while the engine loop is
    held, so every server admits the same rows before its first step.
    Every key the step graphs captured must be in the configuration's
    lattice (prefill [8, T bucket], decode [32, 1], verify [32, 5],
    unified [row bucket, W bucket]) and captured once; captures by kind
    are printed before and after the window. The window must launch all
    three kernels, no plain version on CUDA tensors and no eager step.
    ``shadow``'s streams (both passes) must be byte-identical to
    ``off``'s with no decision applied and no knob moved; ``on`` must
    apply at least one ``spec_k`` and one ``prefill_budget`` decision,
    and its greedy streams equal ``off``'s or part at a near tie of
    ``off``'s engine (``NEAR_TIE_LOGITS``). Printed: each server's tok/s,
    its ticks' host µs, the knob trajectories, the drift guardrail's
    baseline (the first non-zero step-time median of each kind) and
    whether a median passed it by 25%, and ``/autotune/status``. On the
    ``on`` server, still serving: ``/v1/embeddings`` of 8 inputs of 64
    to 1024 tokens (one [8, 1024] chunk, three times, ms each and the
    peak device bytes above the server's): unit norms, the 64-token
    input alone against padded (cosine at least 0.999), each vector's
    cosine to the same ``encode`` with f32 weights on the card (the
    plain reference) at least 0.999; ``/v1/score`` and ``/v1/rerank``
    equal to the cosines of the same texts' vectors; one
    ``vllm:engine_eager_steps_total{reason="embed"}`` a chunk.
17. weights: weight-only int8 and multi-LoRA. The int8-weight GEMM
    (``ops/int8_matmul_cuda.int8_weight_matmul``) against its plain
    version at bench-1b's four projections (qkv, o, gate_up, down) for
    M = 1, 8, 32, 64, 160 and ``INT8_KERNEL_MAX_ROWS`` rows in bf16
    (2e-2) and one f32 tiny-llama case (1e-4); two launches must give
    equal bits; each case's plan (``int8_weight_plan``) is logged with
    the clusters the card runs at once at its shape (at least its tiles:
    one wave), and the build's ``-Xptxas -v`` lines of the GEMM's
    instances (registers, spills, wgmma serialization warnings) are
    logged; at every M it is timed with CUDA events
    (L2 flushed) beside bf16 ``torch.matmul`` on the dequantized weight
    (the yardstick, ``library_ms``), the dequantize-then-matmul form
    (``dequant_ms``), the plain version and its bound (int8 weight
    bytes read once). bench-1b with random int8 weights through
    ``forward``, the kernels against the plain versions at the model
    phase's three step kinds (``compare_logits``, ``NEAR_TIE_LOGITS``);
    decode and verify launch the kernel 64 times each. Then three
    servers at the first run's configuration with no prefix cache, bf16
    KV per layer: bf16 without LoRA, ``--quantization int8`` and
    ``--enable-lora --max-lora-rank 16 --lora-modules a=DIR_A b=DIR_B``
    (two rank-16 PEFT adapters over all seven targets, BF16 safetensors
    written by the script itself). Each takes 16 greedy requests of
    64..700 tokens,
    32 out, submitted together (the LoRA server's a third each to the
    base model, ``a`` and ``b``), once as a warm-up that captures the
    graphs and then counted, the counters set to 0 just before and
    read just after: the three attention kernels launch, no plain call
    on CUDA tensors, no eager step, no key captured in the window or
    twice, and the int8 and LoRA runs capture no key the bf16 run did
    not. Every int8 graph
    whose products have at most ``INT8_KERNEL_MAX_ROWS`` rows launches
    the int8-weight kernel 4 * 16 times a forward, every other none.
    Every stream is held by ``check_stream`` to the same request sent
    alone to the same server; the LoRA server's base rows to the server
    without LoRA; its adapter rows must differ from the base stream, and
    each response names its adapter. Prints tok/s beside the first
    serving run's bf16 figure and captures by kind;
18. families: the OPT, GPT-2 and Mixtral families and HF checkpoint
    loading. First the device allocation left by the earlier phases.
    Each attention kernel at the new geometries, bf16 and int8 KV, at
    the kernel phase's headline shapes (decode B = 32, kv lens
    1..1024; prefill B = 8, T = 512; ragged R = 40, W = 512, and a
    verify block and a second chunk at page 16 untimed): Mixtral-8x7B's
    32 q over 8 kv heads at head_dim 128 (``g4_d128``) and OPT-1.3b's
    32 heads of 64, one q head a kv head (``g1_d64``), timed like the
    headline cases; Qwen2-7B's group 7 at head_dim 128 and tiny-opt's
    f32 group 1 checked untimed; the int8-weight kernel at OPT-1.3b's
    and GPT-2's four projections at M = 32, timed beside bf16
    ``torch.matmul``. Then checkpoint directories this script writes
    (``config.json`` and safetensors shards of random weights from a
    seed, by its own writer, into a temporary directory removed after):
    Mixtral-8x7B at full width with 2 of its 32 layers (bf16) and
    OPT-1.3b at full size (float16, as published: the loader casts to
    bf16), each served with ``--model DIR --tokenizer bench`` (16
    sequences, prefill batch 4, chunk 256, page 128, async and unified
    on, no prefix cache): the weights phase's window of 16 greedy
    requests of 64..700 tokens, 32 out (the three kernels launch, no
    plain call on CUDA tensors, no eager step, no capture in the
    window; every stream held to the request alone), sampled weights
    read back from the server bitwise equal to those written, and the
    model check through the family's ``forward`` (``compare_logits``);
    then GPT-2 (f32 checkpoint) through ``LLMEngine`` over
    ``load_weights``, its max_model_len clamped to the 1024 positions,
    8 greedy prompts against each alone, the three kernels launched.
    Bytes, write seconds, the server's start seconds (the load
    included), tok/s and the graph pool are printed;
19. geometries: every query group, head_dim and dtype the JAX engine
    serves, on the three attention kernels. The sweep: each
    kernel (decode at the wrapper's split and at one, stacked at layer
    1 of 2 and bitwise the per-layer launch on its view, the burst-tail
    form; prefill; ragged) against its plain version at B = 3, two kv
    heads, kv lens 130 and 300 and a pad row, over dtype {bf16, f16,
    f32} x cache {same, int8}: group {1..8, 16} x head_dim {64, 80, 128}
    at page 16, and group {1, 3, 4, 8} x head_dim {96, 100, 160, 256}
    (padded in the kernel but 256) and head_dim {257, 288, 320, 384,
    448, 512, 576, 640, 1024} (slabs of 128, the last padded but at 384,
    512 and 1024; 16-bit prefill to 512 on the wgmma walk's wide form,
    at its widths 384 and 512) at pages 128 and 16 (BF16_TOL for bf16
    and f16, F32_TOL for f32), each prefill launch at group 3 and page
    16 held, by the library's count of each walk's launches, to the
    walk ``prefill_walk_plan`` names (every
    head_dim from 257 to 512 on the wide form, those above on the slab
    walk), with
    ``pstt_kernel_supports`` and
    ``pstt_decode_group_tile`` held to the Python rule on every point,
    at every head_dim 0..1100 and on points outside it (head_dim 0 and
    -1, int8 queries, a mixed cache, group 0). Then timed like the
    headline cases (each time a mean over its launches, the median
    logged beside it and a mean 10% off its median flagged):
    Llama-3-70B's
    group 8 at head_dim 128 (``g8_d128``, bf16 and int8 KV), OPT-2.7b's
    head_dim 80 in f16 (``g1_d80``), Qwen2-0.5B's group 7 at 64 in f32
    (``g7_d64``, its bound at the f32 FMA rate), Llama-2-7B's group 1
    at 128 (``g1_d128``), Falcon3-7B's group 3 at 256 (``g3_d256``, bf16
    and int8 KV), OpenLLaMA-3B's head_dim 100 in f16 (``g1_d100``), 6 q
    over 2 kv heads at 512 (``g3_d512``, bf16 and int8 KV: g3_d256's K/V
    bytes) and 16 heads of 320 in f16 (``g1_d320``), each prefill row
    holding the walk its launch ran (the slab rows: the wide form) and
    each ragged row its own, by the library's ``pstt_ragged_walk_launches``
    (``g3_d256`` on the wgmma walk, ``g3_d512`` and ``g1_d320`` on its
    wide form; bench-1b's, ``g4_d128``'s and ``g1_d64``'s geometries,
    bf16 and int8, on the mma.sync walk), each held to
    ``ragged_walk_plan``; and the int8-weight kernel's f16 form at OPT-2.7b's projections (M
    = 1, 32, 160; timed at 32). Then checkpoints written from published
    configs and served (``--model DIR --tokenizer bench``, page 128, the
    families phase's flags and 16 greedy requests): Meta-Llama-3-70B at
    2 of 80 layers (bf16, then ``--kv-cache-dtype int8``), OPT-2.7b at
    16 of 32 layers at ``--dtype float16``, Qwen2-0.5B at 12 of 24
    layers at ``--dtype float32``, Falcon3-7B-Base at 1 of 28 layers
    (bf16, then ``--kv-cache-dtype int8``), OpenLLaMA-3B at 2 of 26
    layers at ``--dtype float16`` and, not a published checkpoint, a
    llama written to reach head_dim 512 (Falcon3-7B's widths, 6 q over
    2 kv heads at an explicit head_dim 512, 1 layer; bf16, then
    ``--kv-cache-dtype int8``: ``serve_geometry_d512`` and
    ``serve_geometry_d512_int8``, whose windows count the wide form's
    launches as the prefill kernel's); then bench-1b at ``--quantization int8 --dtype float16``. Each
    server: the weights phase's window (tok/s, the three kernels
    launched, no plain call, no eager step), each attention call of the
    model check held to its plain version, and the 16 requests again,
    submitted together, through an eager engine (``cuda_graphs=False``)
    over the server's params, byte-identical to the window's graphed
    streams. Printed, not held:
    the model check's logits against the plain reference and, but for
    Falcon3, OpenLLaMA and d512 (GEOMETRY_ALONE), where a batched stream parts
    from the same request alone, with margins (at
    Llama-3-70B's width the bf16 logits step by 1/16 near |11|, so a
    flip two steps apart meets ``NEAR_TIE_LOGITS`` itself);
20. pages: every page size the JAX engine serves, on the three
    attention kernels (a chunk is tokens [128 c, 128 c + 128) of a row
    whatever the page). The sweep: each kernel (decode at the wrapper's
    split, over several chunks, and at one split; stacked at layer 1 of
    2 and bitwise the per-layer launch on its view; the burst-tail
    form; prefill; ragged) against its plain version at pages 1, 8, 12,
    16, 24, 48, 96, 128, 200, 256, 384 and 512 over bf16 and int8
    caches at bench-1b's geometry (group 4, head_dim 64), and f16 at
    group 1, head_dim 80 and f32 at group 7, head_dim 64 at pages 8, 48
    and 256, with kv lens just before, at and after a page edge and the
    chunk edge (for page 48: 47, 48, 49, 127, 128, 129, 144), a row of
    several chunks and a pad row (BF16_TOL for bf16 and f16, F32_TOL for
    f32), and ``pstt_page_size_supported`` held to the Python rule at
    every point and at pages 0 and -16 (refused). Then bench-1b's
    headline cases (decode B = 32; prefill B = 8, T = 512, first and
    second chunk; ragged R = 40, W = 512) timed at pages 16 and 256,
    bf16 and int8, and at an int8 page of 8 (decode, prefill), beside
    page 128 in the same call. Then bench-1b served at ``--page-size
    256 --num-pages 256`` (per layer, bf16 KV) and at ``--page-size 8
    --num-pages 8192 --kv-cache-dtype int8 --cache-layout stacked``
    with the families phase's flags: 16 greedy requests submitted
    together (tok/s; decode, prefill and ragged launched in the run's
    form, no plain call, no eager step), each attention call of the
    model check over a cache of the server's page size and layout held
    to its plain version, and the same requests through an eager engine
    byte-identical to the graphed streams;
21. tp: tensor parallelism and deferred KV writes. The decode kernel's
    burst-tail form against its plain version (bf16 tolerance, bitwise
    stacked = per-layer view, two launches the same bits) at B = 32,
    kv lens 1..896, S = 4 tail slots with each row frozen after 1..4 of
    them, bf16 and int8 pages, per layer and stacked: at bench-1b and
    g4_d128 timed beside the non-tail form over the same pages, the
    plain version and SDPA over the dense pages and tail; at one tp-2
    rank of bench-1b (16 q over 4 kv heads) untimed. The tail form
    against the non-tail form over the same pages with the tail flushed
    into them (bf16 per layer and stacked, bf16 tolerance; one position
    fewer must miss it). bench-1b --decode-steps 4 through LLMEngine on
    one fixed batch of 16 greedy requests: off twice byte-identical,
    auto equal to off up to near ties (``check_stream``). Then bench-1b with
    --decode-steps 4 and --deferred-kv-writes off, auto, auto, off, off,
    auto, each server warmed by one round of the serving phase's 16
    requests (greedy and stochastic) and timed on a second: auto
    launches the tail form and off never does, every greedy stream
    equals the first off server's or parts from it at a near tie of
    that server's engine (``check_stream``), the stochastic streams are
    counted, and each run prints its tok/s and its burst dispatches'
    mean host wall; then one auto server a cache form (int8, stacked,
    int8 stacked), each launching the tail form in its own form and no
    other. Then the tp runner over a one-rank NCCL
    group with graphs on against the non-tp engine of the same flags
    (16 greedy requests, byte-identical streams, every captured graph
    holding its all-reduces and its logits gather, no eager step).
    Then bench-1b at tp 2: two ranks on cuda:0 over gloo, started as
    the server starts them (the backend named, graphs off), the 16
    greedy requests held to the tp-1 engine's streams (equal, or equal
    to a first flip at a near tie: ``check_stream``), each rank's three
    kernels counted and the ranks' counts equal;
22. parallel2: pipeline and context parallelism on one card, two ranks
    over gloo (graphs off): ring attention at T = 8192 against its dense
    reference; bench-1b at pp 2 (bf16 and int8 KV) and at cp 2 against
    the one-rank engines (streams equal or parting at near ties, each
    rank launching the stacked forms only); at cp 2 the two 4096-token
    prompts take one sp dispatch each, and each rank ran exactly half
    the rows of every unified dispatch (``ModelRunner.sp_split_rows``);
    GPT-2 at pp 2 and cp 2;
23. distributed: multi-host serving, two ``--distributed`` server
    processes on cuda:0 (``--num-processes 2``, one rank each; process
    0 serves HTTP, process 1 replays): bench-1b at tp 2, then at pp 2.
    The launcher must take gloo with graphs off (the two processes
    share the card); the 16 greedy requests of the tp phase go through
    HTTP, their texts held to a one-process engine of the same size over
    gloo with the same resolved flags (``--async-scheduling off
    --unified-step off``): equal, or parting at a near tie of that
    engine, margins printed. Each process's rank launched the decode
    and prefill kernels (pp: their stacked forms only) and the two
    ranks' counts are equal; /metrics reads slice 0 and, after the
    requests, slices 0 and 1 live; process 1 exits 0 within 60 s of
    process 0's shutdown;
24. training: the dense training forwards with gradients at bench-1b's
    full width cut to 2 layers (f32 weights from a seed, B = 2, T =
    1024, loss mean(logits ** 2), no TF32). One rank's
    ``forward_train`` forward and backward (a warm-up, then timed),
    then four ranks spawned on cuda:0 run, over gloo, cp 2
    (``context_parallel_forward``, ring attention), pp 2 (GPipe
    ``pipeline_forward``, M = 2) and dp 2 x cp 2, each rank after
    ``sync_grads`` over sp and dp holding every leaf's gradient (pp:
    its stage's layers, the final norm and head, the embedding on stage
    0) within relative L2 1e-3 of the one-rank gradient it computed
    itself, its logits within 1e-4, finite and [2, 1024, 32128]; the
    same cp 2 with bf16 weights is printed (relative L2 and cosine by
    leaf), not held. Printed: forward, backward and ``sync_grads`` ms
    and peak GB by rank, beside the card's name and power limit. Then
    a bench-1b server process of its own with ``PSTPU_TIMING=1`` and
    the first serving run's flags takes the 16 greedy requests, then 16
    more of the same lengths: after each round its ``/debug/compiles``
    ``timings`` must name decode, prefill and unified, each counted,
    with one logged ``timing`` line a counted dispatch; each round's
    dispatches and mean wall by kind are printed (the first's include
    the graph captures).

``python3 chip_smoke.py --only fleet`` (any phase names) runs the
kernel build and those phases alone, for development, and prints no
result lines.

The line before the last is the ``kernels`` JSON summary, one entry a
kernel with its bf16 per-layer numbers and ``int8``, ``stacked`` and
``int8_stacked`` objects of the same keys; ``launches`` is the kernel's
count in the first serving run (the main path: per_layer bf16, async
and unified on), ``launches_by_run`` its count in every run (the fleet
phase's resume windows as ``fleet_resume`` and, counting the int8
stacked form, ``fleet_resume_int8_stacked``; the disagg phase's
decode-role handoff windows as ``disagg_handoff`` and
``disagg_handoff_int8_stacked``; the autotune phase's ``on`` window as
``serve_autotune``; the weights phase's int8 and LoRA windows as
``serve_int8_weights`` and ``serve_lora``; the families phase's
windows as ``serve_mixtral`` and ``serve_opt``, and its GPT-2 engine
as ``engine_gpt2``; the geometries phase's windows as
``serve_llama3_70b``, ``serve_llama3_70b_int8``,
``serve_opt_2.7b_f16``, ``serve_qwen2_0.5b_f32``, ``serve_falcon3_7b``,
``serve_falcon3_7b_int8``, ``serve_open_llama_3b_f16`` and
``serve_int8_weights_f16``; the pages phase's servers as
``serve_page256`` and, counting the int8 stacked form,
``serve_page8_int8_stacked``; the tp phase's deferred window as
``serve_deferred``, its one-rank NCCL engine as ``engine_tp1_nccl``
and rank 0 of its tp-2 engine as ``serve_tp2_gloo``; the parallel2
phase's rank 0 windows as ``serve_pp2_gloo``, ``serve_pp2_int8_gloo``,
``serve_cp2_gloo``, ``engine_gpt2_pp2_gloo`` and
``engine_gpt2_cp2_gloo``; the distributed phase's process 0 windows as
``serve_tp2_distributed`` and ``serve_pp2_distributed``). Each attention
kernel's ``geometries`` object
holds, keyed ``g4_d128`` and ``g1_d64``, the same numbers at that
geometry with the launches of its serving run, and ``int8``; and the
geometries phase's rows ``g8_d128`` (with ``int8``), ``g1_d80``,
``g7_d64``, ``g1_d128``, ``g3_d256`` (with ``int8``), ``g1_d100``,
``g3_d512`` (with ``int8``) and ``g1_d320``, each with its ``dtype``
and the launches of the run that served it (0 for ``g1_d128`` and
``g1_d320``, which none serves). Each
attention kernel's ``pages`` object holds the pages phase's rows,
keyed ``ps128``, ``ps16``, ``ps256`` and ``ps8`` (``int8`` beside the
bf16 numbers; the prefill kernel's second chunk as ``second_chunk``),
each with the launches of the run that served it. The
int8-weight GEMM's ``f16`` object holds OPT-2.7b's projections and the
launches of the f16 int8-weight server. The
int8-weight GEMM's entry reports its headline case (gate_up at M = 32)
and its launches in the int8 server's window, and under ``families``
OPT-1.3b's and GPT-2's projections at M = 32. The decode kernel's
burst-tail form has an entry of its own (``paged_decode_tail``: the
same keys, its four forms and ``g4_d128``, each with ``decode_ms``, the
non-tail form over the same pages), its launches the deferred windows'
(``serve_deferred`` and ``serve_deferred_<form>``).
The last line is the ``ok`` JSON line.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Published peaks of one H100 SXM (dense), the denominators of the
# bound: HBM bytes per second and bf16 tensor-core operations per
# second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# f32 outside the tensor cores: the f32 forms of the kernels run FMA.
F32_FLOPS_PER_S = 67e12
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
L2_FLUSH_BYTES = 128 << 20  # > the H100's 50 MB L2

SERVER_ARGS = ["--model", "bench-1b", "--random-weights",
               "--page-size", "128", "--num-pages", "512",
               "--max-num-seqs", "32", "--max-model-len", "1024",
               "--prefill-chunk-size", "512", "--prefill-batch-size", "8",
               "--async-scheduling", "auto", "--unified-step", "auto"]

KERNELS = {
    "paged_decode": dict(
        route="cuda",
        source="production_stack_tpu_torch/csrc/paged_decode.cu",
        replaces="production_stack_tpu/ops/paged_attention_pallas.py:147"),
    "paged_prefill": dict(
        route="cuda",
        source="production_stack_tpu_torch/csrc/paged_prefill.cu",
        replaces="production_stack_tpu/ops/prefill_attention_pallas.py:149"),
    "paged_ragged": dict(
        route="cuda",
        source="production_stack_tpu_torch/csrc/paged_ragged.cu",
        replaces="production_stack_tpu/ops/ragged_attention_pallas.py:174"),
}
# The serving run whose launch count a kernel's line reports: the first
# (the main path: per_layer bf16, async and unified on), for every
# kernel; ``launches_by_run`` lists the others.
MAIN_RUN = "serve"
# Headline times of each kernel as this script recorded them before its
# redesign (f32 FMA over f32 tiles; one block a (row, kv head) pair in
# decode; one 116 KB block an SM in ragged), on an NVIDIA H100 80GB HBM3
# at 700 W: printed beside the new times, never part of the ``kernels``
# line.
BEFORE_REDESIGN_MS = {
    "paged_decode": {"bf16": 0.08956, "int8": 0.06844,
                     "stacked": 0.08287, "int8_stacked": 0.06875},
    "paged_prefill": {"bf16": 0.5286, "int8": 0.5375,
                      "stacked": 0.5248, "int8_stacked": 0.5376},
    "paged_ragged": {"bf16": 0.7057, "int8": 0.7175,
                     "stacked": 0.7080, "int8_stacked": 0.7169},
}
INT8_RUN = "serve_int8"  # the run of the int8 forms
STACKED_RUN = "serve_stacked"  # the run of the stacked forms
BURST_RUN = "serve_burst"  # the run of the int8 stacked forms
# The fleet phase's resume windows (bf16 per_layer, int8 stacked).
FLEET_RUN = "fleet_resume"
FLEET_INT8_RUN = "fleet_resume_int8_stacked"
# A stacked case: the layer count of bench-1b and its last layer.
STACK = (16, 15)
# The int8 serving run's page budget: --num-pages 512 at bf16 widths,
# expanded to the same bytes of int8 pages (512 * 128 // 68), less the
# trash page.
INT8_PAGE_CAPACITY = 512 * 2 * 64 // (64 + 4) - 1


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- timing -----------------------------------------------------------------


class Timer:
    """Per-launch device time from CUDA events, with the L2 flushed
    before each launch, as the serving path finds it (every layer reads
    another layer's cache). Each timed launch is queued behind a short
    device-side wait, so that the host has queued it before the card
    reaches it: the events then bracket the kernels alone, and not the
    time the card waits for the wrapper's Python."""

    # About 2 ms of the card's clock: a host thread that stalls for
    # less than that between queueing the wait and the launch (a shared
    # host's other processes) still has the launch queued in time.
    HEAD_START_CYCLES = 4_000_000
    # A mean more than this share away from the median of its launches
    # is flagged in the log (a stall or a clock change inside the
    # window): the mean keeps every launch, the median is printed beside
    # it.
    SPREAD_FLAG = 0.10

    def __init__(self, dev):
        self.flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                     device=dev)
        self.last_median = None  # the last ms() window's median
        # Half a second of dense work first: the first timed case of a
        # process otherwise reads up to 1.6x high (the card's clocks).
        x = torch.randn((4096, 4096), device=dev).to(torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.5:
            for _ in range(20):
                x @ x
            torch.cuda.synchronize()

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """The mean device ms a launch of ``fn`` over ``iters`` launches
        (every one counted); the median lands in ``last_median``, and a
        mean that parts from it by more than SPREAD_FLAG is logged."""
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(self.HEAD_START_CYCLES)
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
            torch.cuda.synchronize()
        times = sorted(start.elapsed_time(end) for start, end in pairs)
        mean = sum(times) / iters
        self.last_median = (times[(iters - 1) // 2] + times[iters // 2]) / 2
        if abs(mean - self.last_median) > self.SPREAD_FLAG * self.last_median:
            log(f"timer flag: mean {mean:.5f} ms is {mean / self.last_median:.2f}"
                f"x the median {self.last_median:.5f} ms of {iters} launches "
                f"(max {times[-1]:.5f})")
        return mean


# ---- kernel phase -----------------------------------------------------------


def _cache(kv, pages, d, ps, dtype, dev, gen):
    return (torch.randn((kv, pages, d, ps), generator=gen, device=dev)
            .to(dtype))


def _quantize(cache):
    """A [kv, pages, d, ps] cache quantized per (page, slot, kv head)
    row, as the engine's page writes lay it out."""
    from production_stack_tpu_torch.ops.quant_kv import QuantKV, quantize_kv
    q8, scale = quantize_kv(cache.permute(0, 1, 3, 2))
    return QuantKV(q8.permute(0, 1, 3, 2).contiguous(), scale.contiguous())


def _caches(kv, pages, d, ps, dtype, dev, gen, int8):
    """(k, v) for the kernels and (k, v) dense in ``dtype`` for SDPA:
    the int8 caches are quantized from the same random K/V, and SDPA
    reads them dequantized."""
    kc = _cache(kv, pages, d, ps, dtype, dev, gen)
    vc = _cache(kv, pages, d, ps, dtype, dev, gen)
    if not int8:
        return (kc, vc), (kc, vc)
    k8, v8 = _quantize(kc), _quantize(vc)
    return (k8, v8), tuple(
        (c.data.float() * c.scale[:, :, None, :]).to(dtype)
        for c in (k8, v8))


def _stack_at(cache, layers, layer, gen):
    """A stacked [layers, ...] cache (a QuantKV's data and scales
    alike) holding ``cache`` at ``layer`` and random values in the other
    layers, filled in place (no f32 copy of the stack)."""
    from production_stack_tpu_torch.ops.quant_kv import QuantKV

    def stack(t):
        out = torch.empty((layers,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        if t.is_floating_point():
            out.normal_(generator=gen)
        else:
            out.random_(-127, 128, generator=gen)
        out[layer] = t
        return out
    if isinstance(cache, QuantKV):
        return QuantKV(stack(cache.data), stack(cache.scale).abs_())
    return stack(cache)


def _form(name, args, stack, gen):
    """``(call, view, layer offset)`` for a case's arguments ``args`` =
    (q, k, v, ...): ``call(fn)`` runs a wrapper or plain version in the
    case's form, as given or (``stack`` = (layers, layer)) over K/V
    embedded at ``layer`` of stacked caches; for the stacked form,
    ``view(fn)`` runs ``fn`` per layer on the layer's view, and the
    layer's element offset is returned."""
    if stack is None:
        return (lambda fn: fn(*args)), None, None
    layers, layer = stack
    k5 = _stack_at(args[1], layers, layer, gen)
    v5 = _stack_at(args[2], layers, layer, gen)
    stacked = (args[0], k5, v5) + tuple(args[3:])
    view = (args[0], k5[layer], v5[layer]) + tuple(args[3:])
    offset = layer * args[1].shape.numel()
    log(f"{name}: stacked cache {tuple(k5.shape)}, layer {layer} at "
        f"element offset {offset} ({offset / 2**31:.2f} x 2^31)")
    return ((lambda fn: fn(*stacked, layer=layer)),
            (lambda fn: fn(*view)), offset)


def _check_view(name, got, view, fn) -> None:
    """The stacked launch must be bitwise the per-layer launch on the
    layer's view: the same walk over the same bytes."""
    if view is None:
        return
    same = view(fn)
    torch.cuda.synchronize()
    if not torch.equal(got, same):
        raise AssertionError(f"{name}: the stacked launch differs from "
                             "the per-layer launch on the layer's view")


def _kv_slot_bytes(d, esz, int8):
    """Bytes of one cached token of one kv head in one plane."""
    return d + 4 if int8 else d * esz


def _page_table(kv_lens, ps, max_pages, num_pages, gen, dev):
    """Distinct random physical pages per row (page 0 stays the trash
    page), zeros past each row's pages."""
    b = len(kv_lens)
    perm = torch.randperm(num_pages - 1, generator=gen,
                          device=gen.device).cpu() + 1
    table = torch.zeros((b, max_pages), dtype=torch.int32)
    used = 0
    for i, n in enumerate(kv_lens):
        need = -(-int(n) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    if used >= num_pages:
        raise ValueError("page budget too small for the case")
    return table.to(dev)


def _dense_kv(cache, table, kv_len_max, group):
    """[kv, pages, d, ps] gathered per row to dense [B, nh, L, d]."""
    g = cache[:, table.long()]  # [kv, B, P, d, ps]
    kv, b, p, d, ps = g.shape
    dense = g.permute(1, 0, 2, 4, 3).reshape(b, kv, p * ps, d)
    return dense[:, :, :kv_len_max].repeat_interleave(group, dim=1)


def decode_case(name, b, kv_lens, ps, dtype, dev, gen, timer=None,
                nh=32, kv=8, d=64, max_len=1024, num_pages=None,
                int8=False, stack=None, num_splits=None, sweep=()):
    """``num_splits``: the split to force (default: the wrapper's
    choice, from shapes). ``sweep``: splits to time the case at."""
    from production_stack_tpu_torch.ops import paged_attention_cuda
    paged_decode_attention_plain = (
        paged_attention_cuda.paged_decode_attention_plain)

    def paged_decode_attention(*args, **kwargs):
        return paged_attention_cuda.paged_decode_attention(
            *args, num_splits=num_splits, **kwargs)

    max_pages = -(-max_len // ps)
    num_pages = num_pages or (b * max_pages + 1)
    (kc, vc), dense = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    q = torch.randn((b, nh, d), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    table = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    call, view, offset = _form(name, (q, kc, vc, table, lens), stack, gen)
    got = call(paged_decode_attention)
    ref = call(paged_decode_attention_plain)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    pad = lens == 0
    if pad.any() and got[pad].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: pad rows must write exact 0")
    _check_view(name, got, view, paged_decode_attention)
    again = call(paged_decode_attention)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    picked = paged_attention_cuda.decode_splits(b, kv, max_pages, ps)
    out = {"case": name, "max_abs_err": err,
           "splits": num_splits or picked[0], "picked_splits": picked[0],
           "chunks_per_split": picked[1]}
    if offset is not None:
        out["layer_offset_elems"] = offset
    if timer is not None:
        # What the function must move: K/V of each row's cached tokens,
        # q of the live rows, every output row, the live page-table
        # entries and kv_lens.
        tokens = int(lens.sum())
        esz = q.element_size()
        live_rows = sum(1 for n in kv_lens if n)
        entries = sum(-(-n // ps) for n in kv_lens)
        nbytes = (2 * tokens * kv * _kv_slot_bytes(d, esz, int8)
                  + live_rows * nh * d * esz + q.numel() * esz
                  + entries * 4 + b * 4)
        flops = 4 * nh * d * tokens
        kmax = max(kv_lens)
        kd = _dense_kv(dense[0], table, kmax, nh // kv)
        vd = _dense_kv(dense[1], table, kmax, nh // kv)
        mask = (torch.arange(kmax, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
        qd = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out.update(
            ms=timer.ms(lambda: call(paged_decode_attention)),
            median_ms=timer.last_median,
            plain_ms=timer.ms(lambda: call(paged_decode_attention_plain),
                              iters=5),
            library_ms=timer.ms(lambda: sdpa(qd, kd, vd, attn_mask=mask)),
            **_bound(nbytes, flops, dtype))
        if view is not None:
            out["per_layer_ms"] = timer.ms(
                lambda: view(paged_decode_attention))
        if sweep:
            out["ms_by_splits"] = {
                n: timer.ms(lambda: call(
                    lambda *a, **k: paged_attention_cuda
                    .paged_decode_attention(*a, num_splits=n, **k)))
                for n in sweep}
    return out


# The prefill kernel's walks, by their index in the library's
# pstt_prefill_walk_launches (paged_prefill.cu), as prefill_walk_plan
# names them.
PREFILL_WALKS = ("wgmma", "wgmma_wide", "mma_slab", "f32")


# The ragged kernel's walks, by their index in the library's
# pstt_ragged_walk_launches (paged_ragged.cu), as ragged_walk_plan names
# them.
RAGGED_WALKS = ("mma", "wgmma", "wgmma_wide", "mma_slab", "f32")


def _walk_counts(fn, kernel="prefill") -> dict:
    """{walk: launches} of the prefill (or ragged) kernel while ``fn``
    runs, read from the library's count of the launches each walk's
    kernel took (the kernel the runtime accepted, after the launch's
    error check)."""
    from production_stack_tpu_torch.ops import paged_kv_common as pkc
    lib = pkc.kernel_lib()
    walks, count = ((PREFILL_WALKS, lib.pstt_prefill_walk_launches)
                    if kernel == "prefill" else
                    (RAGGED_WALKS, lib.pstt_ragged_walk_launches))

    def counts():
        return [count(i) for i in range(len(walks))]
    before = counts()
    fn()
    torch.cuda.synchronize()
    return {walk: n1 - n0 for walk, n0, n1
            in zip(walks, before, counts()) if n1 != n0}


def _one_walk(fn, kernel="prefill") -> str:
    """The one walk a call of the prefill (or ragged) kernel ran (``fn``
    makes one launch); raises where it ran none or more than one
    kernel."""
    walks = _walk_counts(fn, kernel)
    if len(walks) != 1 or sum(walks.values()) != 1:
        raise AssertionError(f"one {kernel} launch ran {walks}")
    return next(iter(walks))


# A point of the prefill walk check: (dtype name, int8 cache, query
# group, kv heads, head_dim, tokens T, page size).
DTYPES_BY_NAME = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                  "float32": torch.float32}


def _prefill_walks_of(points) -> list:
    """The walk one prefill launch ran at each point (a row of a first
    chunk of T tokens), each held to the one ``prefill_walk_plan``
    names."""
    from production_stack_tpu_torch.ops.prefill_attention_cuda import (
        paged_prefill_attention, prefill_walk_plan)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    walks = []
    for point in points:
        name, int8, group, kv, d, t, ps = point
        dtype = DTYPES_BY_NAME[name]
        max_pages = -(-t // ps)
        (kc, vc), _ = _caches(kv, max_pages + 1, d, ps, dtype, dev, gen,
                              int8)
        table = _page_table([t], ps, max_pages, max_pages + 1, gen, dev)
        lens = torch.tensor([t], dtype=torch.int32, device=dev)
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
        q = torch.randn((1, t, kv * group, d), generator=gen,
                        device=dev).to(dtype)

        def call():
            paged_prefill_attention(q, kc, vc, table, pos.contiguous(),
                                    lens)
        walk = _one_walk(call)
        planned = prefill_walk_plan(
            dtype, torch.int8 if int8 else dtype, group, t, d, ps)["walk"]
        if walk != planned:
            raise AssertionError(f"prefill at {point}: ran the {walk} walk,"
                                 f" the plan names {planned}")
        walks.append(walk)
    return walks


def _ragged_walks_of(points) -> list:
    """The walk one ragged launch ran at each point (dtype name, int8
    cache, query group, kv heads, head_dim, page size, width W: a block
    of a decode row, a pad row and a row whose W slots are live), each
    held to the one ``ragged_walk_plan`` names."""
    from production_stack_tpu_torch.ops.ragged_attention_cuda import (
        paged_ragged_attention, ragged_walk_plan)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    walks = []
    for point in points:
        name, int8, group, kv, d, ps, w = point
        dtype = DTYPES_BY_NAME[name]
        rows = [(130, 0), (0, -1), (300 + w, w - 1)]
        max_pages = -(-(300 + w) // ps)
        num_pages = 3 * max_pages + 1
        (kc, vc), _ = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
        table = _page_table([n for n, _ in rows], ps, max_pages, num_pages,
                            gen, dev)
        lens = torch.tensor([n for n, _ in rows], dtype=torch.int32,
                            device=dev)
        last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                            device=dev)
        q = torch.randn((3, w, kv * group, d), generator=gen,
                        device=dev).to(dtype)
        walk = _one_walk(
            lambda: paged_ragged_attention(q, kc, vc, table, lens, last),
            "ragged")
        planned = ragged_walk_plan(
            dtype, torch.int8 if int8 else dtype, group, w, d, ps)["walk"]
        if walk != planned:
            raise AssertionError(f"ragged at {point}: ran the {walk} walk, "
                                 f"the plan names {planned}")
        walks.append(walk)
    return walks


def prefill_case(name, rows, t, ps, dtype, dev, gen, timer=None, nh=32,
                 kv=8, d=64, max_len=1024, int8=False, stack=None):
    """Row i holds ``rows[i] = (start, n)``: n real tokens of a chunk
    starting at ``start`` (n = 0: a pad row). Every slot t sits at
    start + t, as the kernel rebuilds it, so a row's slots past n are
    pad slots that still attend up to kv_len = start + n."""
    from production_stack_tpu_torch.ops.prefill_attention_cuda import (
        paged_prefill_attention, paged_prefill_attention_plain)
    b = len(rows)
    max_pages = -(-max_len // ps)
    num_pages = b * max_pages + 1
    (kc, vc), dense = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    q = torch.randn((b, t, nh, d), generator=gen, device=dev).to(dtype)
    kv_lens = [start + n if n else 0 for start, n in rows]
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    starts = torch.tensor([start if n else 0 for start, n in rows],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(t, dtype=torch.int32,
                                          device=dev)[None]).contiguous()
    table = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    call, view, offset = _form(name, (q, kc, vc, table, pos, lens), stack,
                               gen)
    got = call(paged_prefill_attention)
    ref = call(paged_prefill_attention_plain)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    pad = lens == 0
    if pad.any() and got[pad].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: pad rows must write exact 0")
    _check_view(name, got, view, paged_prefill_attention)
    again = call(paged_prefill_attention)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    out = {"case": name, "max_abs_err": err}
    if offset is not None:
        out["layer_offset_elems"] = offset
    if timer is not None:
        esz = q.element_size()
        slot_bytes = nh * d * esz
        live_rows = sum(1 for n in kv_lens if n)
        entries = sum(-(-n // ps) for n in kv_lens)
        kv_bytes = 2 * sum(kv_lens) * kv * _kv_slot_bytes(d, esz, int8)
        small = entries * 4 + 2 * b * 4  # page table, row starts, kv_lens
        # Operations this data needs: slot t of row i sees
        # min(start_i + t + 1, kv_len_i) tokens.
        visible = torch.minimum(pos.long() + 1, lens[:, None].long())
        flops = 4 * nh * d * int(visible.sum())
        # The function as called: q of the live rows (all t slots, pad
        # slots included), every output slot.
        nbytes = kv_bytes + (live_rows + b) * t * slot_bytes + small
        # The part of it the step uses: the live slots (t < n) only.
        live = (torch.arange(t, device=dev)[None]
                < torch.tensor([n for _, n in rows], device=dev)[:, None])
        n_slots = int(live.sum())
        live_bound = _bound(kv_bytes + 2 * n_slots * slot_bytes + small,
                            4 * nh * d * int(visible[live].sum()), dtype)
        kmax = max(kv_lens)
        kd = _dense_kv(dense[0], table, kmax, nh // kv)
        vd = _dense_kv(dense[1], table, kmax, nh // kv)
        tok = torch.arange(kmax, device=dev)
        mask = ((tok[None, None, :] <= pos.long()[:, :, None])
                & (tok[None, None, :] < lens.long()[:, None, None]))
        qd = q.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out.update(
            ms=timer.ms(lambda: call(paged_prefill_attention)),
            median_ms=timer.last_median,
            plain_ms=timer.ms(lambda: call(paged_prefill_attention_plain),
                              iters=5),
            library_ms=timer.ms(
                lambda: sdpa(qd, kd, vd, attn_mask=mask[:, None])),
            **_bound(nbytes, flops, dtype),
            live_bound_ms=live_bound["bound_ms"],
            live_bound_by=live_bound["bound_by"])
        if view is not None:
            out["per_layer_ms"] = timer.ms(
                lambda: view(paged_prefill_attention))
    return out


def ragged_case(name, rows, w, ps, dtype, dev, gen, timer=None, nh=32,
                kv=8, d=64, max_len=1024, verify=False, int8=False,
                stack=None, walk=False):
    """Row i holds ``rows[i] = (kv_len, last_index)``: slots 0..last_index
    are live and sit at kv_len - 1 - last_index + t (kv_len 0: a pad
    row). ``verify``: the rows are verify rows, draft_len = last_index.
    ``walk``: the case's first launch is read for the walk it ran
    (``case["walk"]``), held to the one ``ragged_walk_plan`` names."""
    from production_stack_tpu_torch.ops.ragged_attention_cuda import (
        paged_ragged_attention, paged_ragged_attention_plain,
        ragged_walk_plan)
    b = len(rows)
    max_pages = -(-max_len // ps)
    num_pages = b * max_pages + 1
    (kc, vc), dense = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    q = torch.randn((b, w, nh, d), generator=gen, device=dev).to(dtype)
    kv_lens = [n for n, _ in rows]
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                        device=dev)
    drafts = torch.clamp(last, min=0) if verify else None
    table = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    call, view, offset = _form(name, (q, kc, vc, table, lens, last, drafts),
                               stack, gen)

    def plain(*args, **kwargs):
        # The 16-bit kernel feeds its probabilities to p . v in its type.
        if dtype != torch.float32:
            kwargs["p_dtype"] = dtype
        return paged_ragged_attention_plain(*args, **kwargs)

    ran = {}

    def first():
        ran["got"] = call(paged_ragged_attention)
    if walk:
        ran["walk"] = _one_walk(first, "ragged")
        planned = ragged_walk_plan(dtype, torch.int8 if int8 else dtype,
                                   nh // kv, w, d, ps)["walk"]
        if ran["walk"] != planned:
            raise AssertionError(f"{name}: ran the {ran['walk']} walk, the "
                                 f"plan names {planned}")
    else:
        first()
    got = ran["got"]
    ref = call(plain)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    slot = torch.arange(w, device=dev)[None]
    live = (slot <= last[:, None].long()) & (lens[:, None] > 0)  # [B, W]
    if (~live).any() and got[~live].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: dead slots and pad rows must "
                             "write exact 0")
    _check_view(name, got, view, paged_ragged_attention)
    again = call(paged_ragged_attention)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    out = {"case": name, "max_abs_err": err}
    if walk:
        out["walk"] = ran["walk"]
    if offset is not None:
        out["layer_offset_elems"] = offset
    if timer is not None:
        esz = q.element_size()
        slot_bytes = nh * d * esz
        entries = sum(-(-n // ps) for n in kv_lens)
        kv_bytes = 2 * sum(kv_lens) * kv * _kv_slot_bytes(d, esz, int8)
        small = entries * 4 + 3 * b * 4  # page table, kv_lens, last_index
        # Operations this data needs: live slot t of row i sits at
        # q_start_i + t and sees min(q_start_i + t + 1, kv_len_i) tokens.
        pos = (lens - 1 - last)[:, None].long() + slot
        visible = torch.minimum(pos + 1, lens[:, None].long())
        flops = 4 * nh * d * int(visible[live].sum())
        n_live = int(live.sum())
        # The function as called reads q of the live slots and writes
        # every output slot (dead ones as 0); its live slots alone read
        # and write only theirs.
        bound = _bound(kv_bytes + (n_live + b * w) * slot_bytes + small,
                       flops, dtype)
        live_bound = _bound(kv_bytes + 2 * n_live * slot_bytes + small,
                            flops, dtype)
        kmax = max(kv_lens)
        kd = _dense_kv(dense[0], table, kmax, nh // kv)
        vd = _dense_kv(dense[1], table, kmax, nh // kv)
        tok = torch.arange(kmax, device=dev)
        mask = (live[:, :, None] & (tok[None, None, :] <= pos[:, :, None])
                & (tok[None, None, :] < lens.long()[:, None, None]))
        qd = q.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out.update(
            ms=timer.ms(lambda: call(paged_ragged_attention)),
            median_ms=timer.last_median,
            plain_ms=timer.ms(lambda: call(plain), iters=5),
            library_ms=timer.ms(
                lambda: sdpa(qd, kd, vd, attn_mask=mask[:, None])),
            **bound, live_bound_ms=live_bound["bound_ms"],
            live_bound_by=live_bound["bound_by"],
            # Writing the output alone (every slot, dead ones as 0).
            output_bound_ms=_bound(b * w * slot_bytes, 0)["bound_ms"])
        if view is not None:
            out["per_layer_ms"] = timer.ms(
                lambda: view(paged_ragged_attention))
    return out


def _bound(nbytes: int, flops: int, dtype=torch.bfloat16) -> dict:
    """The least time of the work: its bytes over the HBM rate or its
    operations over the peak of their type (bf16 and f16 on the tensor
    cores, f32 on the FMA units), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _headline_rows() -> dict:
    """The rows of the headline cases: decode ``lens`` (32 rows, kv lens
    over 1..1024, rows 7 and 21 pad); prefill ``first`` and ``second``
    chunks (8 rows of a 512-token bucket, live lengths over 64..512,
    row 5 pad); the widest unified mixed step of the serving
    configuration, R = max_num_seqs + prefill_batch_size = 40 rows at W
    = 512, as the prefill kernel takes it (``unified_prefill``: 28
    decode rows of one live slot at kv_len - 1, 8 prefill-chunk rows of
    first and second chunks, 4 pad rows) and as the ragged kernel takes
    it (``unified``: (kv_len, last_index) a row, pad rows at kv_len 0
    and last_index -1 as the runner lays them out)."""
    lens = np.linspace(1, 1024, 32).round().astype(int).tolist()
    lens[7] = lens[21] = 0
    live = [512, 448, 384, 320, 256, 0, 128, 64]
    decode_lens = np.linspace(70, 1024, 28).round().astype(int).tolist()
    unified = ([(n - 1, 1) for n in decode_lens]
               + [(0, 512), (0, 448), (0, 300), (0, 64), (512, 188),
                  (512, 100), (512, 500), (0, 200)] + [(0, 0)] * 4)
    return {"lens": lens, "first": [(0, n) for n in live],
            "second": [(512, n) for n in live], "decode_lens": decode_lens,
            "unified_prefill": unified,
            "unified": [(start + n, n - 1) if n else (0, -1)
                        for start, n in unified]}


def kernel_phase(dev) -> dict:
    """Returns {kernel name: {form: headline case}} for the forms
    "bf16", "int8", "stacked" and "int8_stacked", after checking every
    case."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(dev)
    bf16 = torch.bfloat16
    rows = _headline_rows()
    lens, first, second = rows["lens"], rows["first"], rows["second"]
    decode_lens, unified = rows["decode_lens"], rows["unified_prefill"]
    unified_ragged = rows["unified"]
    # A verify block of the speculative path at K = 4: 32 rows with kv
    # lens over 1..1024 (drafts included), draft lens 0..4, rows 9 and
    # 26 pad.
    verify = [(max(n, i % 5 + 1), i % 5) for i, n in enumerate(
        np.linspace(1, 1024, 32).round().astype(int).tolist())]
    verify[9] = verify[26] = (0, -1)
    # The headline block without its chunk rows: 28 decode rows and 12
    # pad rows, so about 8,900 of its 10,240 tiles only write zeros
    # (every tile of a decode row but its first, every tile of a pad
    # row). Its time beside the bound of its output bytes is the cost
    # of the dead tiles.
    dead_tiles = [(n, 0) for n in decode_lens] + [(0, -1)] * 12
    # Decode rows only (kv lens 1..1024; pad rows 7 and 21 at
    # last_index 0, as the JAX tests lay them out): every tile but the
    # first dead.
    decode_only = [(n, 0) for n in lens]
    # Chunk rows whose live slots end inside a tile (37, 100, 129, 511,
    # 3, 250 slots: 148 .. 2044 live query rows, none a multiple of 64)
    # at first and later chunks.
    mid_tile = [(s + n, n - 1) for s, n in ((0, 37), (200, 100), (700, 129),
                                            (0, 511), (1000, 3), (300, 250))]
    # f32 cases at the tiny-llama geometry (4 q heads, 2 kv heads,
    # head_dim 32), the f32 config the kernels are built for.
    tiny = dict(nh=4, kv=2, d=32)
    f32 = torch.float32
    # The split decode kernel: batch 1, 4 and 32 over tables of 1024
    # and 4096 tokens. Rows end inside the first split (5, 127), on a
    # chunk edge (128, 4096), one past (129, 2049); pad rows.
    wide = np.linspace(1, 4096, 32).round().astype(int).tolist()
    wide[3] = wide[30] = 0
    split_cases = [
        ("B=1 table 1024", [1000], 1024, None),
        ("B=1 table 1024, one split", [1000], 1024, 1),
        ("B=1 table 4096", [3000], 4096, None),
        ("B=4 table 1024", [127, 128, 129, 0], 1024, None),
        ("B=4 table 4096", [4096, 5, 0, 2049], 4096, None),
        ("B=4 table 4096, one split", [4096, 5, 0, 2049], 4096, 1),
        ("B=32 table 4096", wide, 4096, None),
        ("B=32 table 4096, one split", wide, 4096, 1),
    ]

    def split_decode_cases(int8):
        tag = "bf16/int8" if int8 else "bf16"
        return [decode_case(f"decode {tag} {label} ps=128", len(rows), rows,
                            128, bf16, dev, gen, timer, max_len=width,
                            int8=int8, num_splits=n)
                for label, rows, width, n in split_cases]

    # The tensor-core prefill walk off its easy shapes: T = 16 and 64,
    # row starts off the tile and the chunk (37, 600), a kv_len one
    # past a chunk edge (129), a one-token row, a pad row; page sizes
    # 128, 32 and 64.
    def edge_prefill_cases(int8):
        tag = "bf16/int8" if int8 else "bf16"
        out = []
        for t, ps in ((16, 128), (64, 32), (64, 64)):
            rows = [(37, t), (600, t - 7), (129 - t, t), (0, 0), (300, 1),
                    (0, t), (1024 - t, t)]
            out.append(prefill_case(
                f"prefill {tag} T={t} ps={ps} starts 37, 600, kv_len 129",
                rows, t, ps, bf16, dev, gen, int8=int8))
        return out
    # The first case of each list is the kernel's headline case.
    cases = {"bf16": {
        "paged_decode": [
            decode_case("decode bf16 B=32 ps=128", 32, lens, 128, bf16,
                        dev, gen, timer, num_pages=512,
                        sweep=(1, 2, 3, 4, 8)),
            decode_case("decode bf16 B=32 ps=16", 32, lens, 16, bf16,
                        dev, gen, timer),
            *split_decode_cases(False),
            decode_case("decode f32 tiny B=4 ps=16", 4, [1, 0, 37, 300],
                        16, torch.float32, dev, gen, max_len=512, **tiny),
        ],
        "paged_prefill": [
            prefill_case("prefill bf16 B=8 T=512 first chunk ps=128", first,
                         512, 128, bf16, dev, gen, timer),
            prefill_case("prefill bf16 B=8 T=512 second chunk ps=128",
                         second, 512, 128, bf16, dev, gen, timer),
            prefill_case("prefill bf16 B=8 T=512 second chunk ps=16",
                         second, 512, 16, bf16, dev, gen, timer),
            prefill_case("prefill bf16 unified R=40 W=512 ps=128", unified,
                         512, 128, bf16, dev, gen, timer),
            prefill_case("prefill f32 tiny B=2 T=64 ps=16",
                         [(40, 64), (40, 9)], 64, 16, torch.float32, dev,
                         gen, max_len=256, **tiny),
            *edge_prefill_cases(False),
        ],
        "paged_ragged": [
            ragged_case("ragged bf16 unified R=40 W=512 ps=128",
                        unified_ragged, 512, 128, bf16, dev, gen, timer),
            ragged_case("ragged bf16 verify B=32 W=5 ps=128", verify, 5,
                        128, bf16, dev, gen, timer, verify=True),
            ragged_case("ragged bf16 dead tiles R=40 W=512 ps=128 (28 "
                        "decode rows, 12 pad rows)", dead_tiles, 512, 128,
                        bf16, dev, gen, timer),
            ragged_case("ragged bf16 decode rows R=32 W=512 ps=64",
                        decode_only, 512, 64, bf16, dev, gen),
            ragged_case("ragged bf16 chunk rows ending mid-tile R=6 W=512 "
                        "ps=32", mid_tile, 512, 32, bf16, dev, gen),
            ragged_case("ragged bf16 verify B=32 W=5 ps=16", verify, 5, 16,
                        bf16, dev, gen, timer, verify=True),
            ragged_case("ragged f32 tiny R=4 W=16 ps=16",
                        [(1, 0), (77, 15), (0, -1), (200, 3)], 16, 16,
                        torch.float32, dev, gen, max_len=256, **tiny),
        ],
    }, "int8": {
        # The headline cases again over an int8 cache quantized from the
        # same kind of bf16 K/V, then page size 16 and the f32 tiny-llama
        # geometry over int8 caches.
        "paged_decode": [
            decode_case("decode bf16/int8 B=32 ps=128", 32, lens, 128, bf16,
                        dev, gen, timer, num_pages=512, int8=True,
                        sweep=(1, 2, 3, 4, 8)),
            *split_decode_cases(True),
            decode_case("decode bf16/int8 B=32 ps=16", 32, lens, 16, bf16,
                        dev, gen, int8=True),
            decode_case("decode f32/int8 tiny B=4 ps=16", 4,
                        [1, 0, 37, 300], 16, f32, dev, gen, max_len=512,
                        int8=True, **tiny),
        ],
        "paged_prefill": [
            prefill_case("prefill bf16/int8 B=8 T=512 first chunk ps=128",
                         first, 512, 128, bf16, dev, gen, timer, int8=True),
            prefill_case("prefill bf16/int8 B=8 T=512 second chunk ps=16",
                         second, 512, 16, bf16, dev, gen, int8=True),
            prefill_case("prefill f32/int8 tiny B=2 T=64 ps=16",
                         [(40, 64), (40, 9)], 64, 16, f32, dev, gen,
                         max_len=256, int8=True, **tiny),
            *edge_prefill_cases(True),
        ],
        "paged_ragged": [
            ragged_case("ragged bf16/int8 unified R=40 W=512 ps=128",
                        unified_ragged, 512, 128, bf16, dev, gen, timer,
                        int8=True),
            ragged_case("ragged bf16/int8 verify B=32 W=5 ps=16", verify, 5,
                        16, bf16, dev, gen, timer, verify=True, int8=True),
            ragged_case("ragged bf16/int8 decode rows R=32 W=512 ps=64",
                        decode_only, 512, 64, bf16, dev, gen, int8=True),
            ragged_case("ragged bf16/int8 chunk rows ending mid-tile R=6 "
                        "W=512 ps=32", mid_tile, 512, 32, bf16, dev, gen,
                        int8=True),
            ragged_case("ragged f32/int8 tiny R=4 W=16 ps=16",
                        [(1, 0), (77, 15), (0, -1), (200, 3)], 16, 16, f32,
                        dev, gen, max_len=256, int8=True, **tiny),
        ],
    }, "stacked": {
        # The headline cases at the last layer of a bench-1b-deep
        # stacked cache; then decode over 2304 pages a layer, where the
        # layer's element offset passes 2^31 (about 4.8 GB a bf16 k
        # cache).
        "paged_decode": [
            decode_case("decode bf16 stacked L=16 layer 15 B=32 ps=128", 32,
                        lens, 128, bf16, dev, gen, timer, num_pages=512,
                        stack=STACK),
            decode_case("decode bf16 stacked L=16 layer 15 B=32 ps=128, "
                        "2304 pages", 32, lens, 128, bf16, dev, gen,
                        num_pages=2304, stack=STACK),
        ],
        "paged_prefill": [
            prefill_case("prefill bf16 stacked L=16 layer 15 B=8 T=512 first "
                         "chunk ps=128", first, 512, 128, bf16, dev, gen,
                         timer, stack=STACK),
        ],
        "paged_ragged": [
            ragged_case("ragged bf16 stacked L=16 layer 15 unified R=40 "
                        "W=512 ps=128", unified_ragged, 512, 128, bf16, dev,
                        gen, timer, stack=STACK),
        ],
    }, "int8_stacked": {
        "paged_decode": [
            decode_case("decode bf16/int8 stacked L=16 layer 15 B=32 ps=128",
                        32, lens, 128, bf16, dev, gen, timer, num_pages=512,
                        int8=True, stack=STACK),
        ],
        "paged_prefill": [
            prefill_case("prefill bf16/int8 stacked L=16 layer 15 B=8 T=512 "
                         "first chunk ps=128", first, 512, 128, bf16, dev,
                         gen, timer, int8=True, stack=STACK),
        ],
        "paged_ragged": [
            ragged_case("ragged bf16/int8 stacked L=16 layer 15 unified "
                        "R=40 W=512 ps=128", unified_ragged, 512, 128, bf16,
                        dev, gen, timer, int8=True, stack=STACK),
        ],
    }}
    headline = {name: {} for name in KERNELS}
    for form, by_kernel in cases.items():
        for name, results in by_kernel.items():
            for r in results:
                log("kernel case " + json.dumps(r))
            head = dict(results[0])
            head["max_abs_err"] = max(r["max_abs_err"] for r in results)
            headline[name][form] = head
            before = BEFORE_REDESIGN_MS.get(name, {}).get(form)
            if before is not None:
                log(f"kernel {name} {form}: {head['ms']:.5f} ms now, "
                    f"before_redesign_ms {before} (recorded, not measured "
                    f"in this run): {before / head['ms']:.2f}x")
    return headline


# ---- model phase ------------------------------------------------------------


def model_phase(dev) -> None:
    from production_stack_tpu_torch.engine.config import (
        bench_1b_model_config)
    from production_stack_tpu_torch.models import llama

    cfg = bench_1b_model_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, dev)
    tokens = torch.randint(1, cfg.vocab_size, (1, 512 + 6), generator=gen,
                           device=dev, dtype=torch.int32)
    for kv_dtype in ("bf16", "int8"):
        per_layer = _model_forwards(dev, cfg, params, tokens, kv_dtype)
        stacked = _forwards(dev, cfg, params, tokens,
                            _model_caches(dev, cfg, kv_dtype, "stacked"),
                            "cuda")
        for phase, a, b in zip(PHASES, stacked, per_layer):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"model {kv_dtype} KV {phase}: logits over the stacked "
                    "cache differ from those over the per-layer caches")
        log(f"model bench-1b {kv_dtype} KV: stacked-cache logits bitwise "
            f"equal to per-layer ones ({', '.join(PHASES)})")
    del params
    torch.cuda.empty_cache()


PHASES = ("prefill T=512", "decode T=1", "verify T=5 (ragged)")


def _model_caches(dev, cfg, kv_dtype, layout, page_size=128):
    """Fresh k and v caches of the pages ``_forwards`` writes (5 of 128
    tokens at the default page size) and 3 more: a list of per-layer
    buffers, or one stacked buffer each."""
    from production_stack_tpu_torch.ops.quant_kv import quant_cache_zeros

    shape = (cfg.num_key_value_heads, -(-(512 + 6) // page_size) + 3,
             cfg.head_dim, page_size)
    layers = cfg.num_hidden_layers

    def cache(shape):
        if kv_dtype == "int8":
            return quant_cache_zeros(shape, dev)
        return torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)

    if layout == "stacked":
        return cache((layers,) + shape), cache((layers,) + shape)
    return ([cache(shape) for _ in range(layers)],
            [cache(shape) for _ in range(layers)])


def _forwards(dev, cfg, params, tokens, caches, impl):
    """The prefill chunk, decode step and verify block through the
    architecture's ``forward`` over ``caches``; returns their logits."""
    from production_stack_tpu_torch.models.registry import get_model

    forward = get_model(cfg)[1]

    t = 512
    page_size = (caches[0][0] if isinstance(caches[0], list)
                 else caches[0]).shape[-1]
    # Pages 1.. of the 518 tokens (page 0 is the trash page).
    table = torch.arange(1, 1 + -(-(t + 6) // page_size), dtype=torch.int32,
                         device=dev)[None]
    with torch.inference_mode():
        prefill = forward(
            params, cfg, tokens[:, :t],
            torch.arange(t, device=dev, dtype=torch.int32)[None],
            table, torch.tensor([t], dtype=torch.int32, device=dev),
            torch.ones((1, t), dtype=torch.bool, device=dev),
            *caches, kind="prefill", impl=impl)
        decode = forward(
            params, cfg, tokens[:, t:t + 1],
            torch.tensor([[t]], dtype=torch.int32, device=dev), table,
            torch.tensor([t + 1], dtype=torch.int32, device=dev),
            torch.ones((1, 1), dtype=torch.bool, device=dev),
            *caches, kind="decode", impl=impl)
        verify = forward(
            params, cfg, tokens[:, t + 1:],
            torch.arange(t + 1, t + 6, device=dev,
                         dtype=torch.int32)[None], table,
            torch.tensor([t + 6], dtype=torch.int32, device=dev),
            torch.ones((1, 5), dtype=torch.bool, device=dev),
            *caches, kind="ragged", impl=impl)
    torch.cuda.synchronize()
    return prefill[0], decode[0], verify[0]


# A top-1 flip between the kernels' forward and its plain reference is
# allowed only as a near-tie: where the reference's margin between its
# own best token and the kernels' pick is under this many logits. The
# two forwards run the same bf16 model with the same roundings and
# differ only in the order of each attention's f32 sums; on the card
# that order alone moved a logit by up to 0.094 (the f32 FMA kernels
# against the f32 plain walk, before the tensor-core redesigns). This
# bound is that, rounded up to a power of two. Fixed: a larger logit
# difference does not excuse a larger flip, and there is no allowance
# on the number of flips.
NEAR_TIE_LOGITS = 0.125


def compare_logits(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``got`` against ``ref`` ([..., vocab] logits): the largest
    difference, the largest |logit| of ``ref``, the top-1 flips and, at
    each flip, the reference's margin (its best logit minus its logit at
    ``got``'s pick), largest first. ``ok``: every logit finite, within 5%
    of the largest, and every flip a near-tie (margin under
    NEAR_TIE_LOGITS)."""
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    pick = got.argmax(-1, keepdim=True)
    flipped = pick[..., 0] != ref.argmax(-1)
    margin = ref.max(-1).values - ref.gather(-1, pick)[..., 0]
    margins = sorted(margin[flipped].float().tolist(), reverse=True)
    ok = (finite and diff <= 0.05 * scale
          and all(m < NEAR_TIE_LOGITS for m in margins))
    return {"ok": ok, "finite": finite, "diff": diff, "scale": scale,
            "positions": flipped.numel(), "flips": len(margins),
            "margins": margins}


def _model_forwards(dev, cfg, params, tokens, kv_dtype):
    """The prefill chunk, decode step and verify block through the
    kernels and through their plain versions over a fresh ``kv_dtype``
    per-layer cache each, compared; returns the kernels' logits. The
    reference is the plain versions rounded as the kernels round
    (``plain_bf16p``: the prefill and ragged walks feed bf16
    probabilities to p . v, as the tensor-core walk does)."""
    results = {impl: _forwards(dev, cfg, params, tokens,
                               _model_caches(dev, cfg, kv_dtype,
                                             "per_layer"), impl)
               for impl in ("cuda", "plain_bf16p")}
    for i, phase in enumerate(PHASES):
        c = compare_logits(results["cuda"][i], results["plain_bf16p"][i])
        log(f"model bench-1b {kv_dtype} KV {phase}: logits "
            f"{tuple(results['cuda'][i].shape)}, finite {c['finite']}, max "
            f"|cuda - plain| {c['diff']:.3e} (max |logit| "
            f"{c['scale']:.3e}), top-1 agreement "
            f"{1 - c['flips'] / c['positions']:.4f} ({c['flips']} flips), "
            f"margins of the flips {[f'{m:.3e}' for m in c['margins']]}")
        # Over int8 KV each side also quantizes the K/V its own layers
        # produced, so the logits move more; the same bound holds.
        if not c["ok"]:
            raise AssertionError(
                f"model {kv_dtype} KV {phase}: cuda and plain forwards "
                f"disagree (non-finite logits, logits apart by more than "
                f"5%, or a flip past the near-tie bound {NEAR_TIE_LOGITS})")
    return results["cuda"]


# ---- engine phase -----------------------------------------------------------


def engine_phase(vocab: int) -> None:
    """bench-1b, stacked layout, unified step and async off: 8 greedy
    prompts submitted before the first step, decoded single-step and
    in bursts of 4. Every GEMM keeps its padded shape and the rows do
    not interact, so the streams must be byte-identical."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, bench_1b_model_config)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    rng = np.random.RandomState(2)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 500, 8).round().astype(int)]
    streams = {}
    for k in (1, 4):
        cfg = EngineConfig(
            model=bench_1b_model_config(),
            cache=CacheConfig(page_size=128, num_pages=512,
                              cache_layout="stacked"),
            scheduler=SchedulerConfig(
                max_num_seqs=32, max_model_len=1024,
                prefill_chunk_size=512, prefill_batch_size=8,
                decode_steps=k, async_scheduling=False,
                unified_step=False))
        engine = LLMEngine(cfg, device="cuda")
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        seqs = engine.generate_batch(prompts, SamplingParams(
            temperature=0.0, max_tokens=32, ignore_eos=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(COUNTERS.launches)
        streams[k] = [list(s.output_token_ids) for s in seqs]
        steps = engine.metrics.pipeline_steps_total
        del engine, seqs
        torch.cuda.empty_cache()
        log(f"engine bench-1b stacked decode_steps={k}: 8 prompts x 32 "
            f"tokens in {wall:.3f} s over {steps} steps; launches "
            f"{launches}")
        if set(launches) != {"paged_prefill_stacked",
                             "paged_decode_stacked"}:
            raise AssertionError(f"engine decode_steps={k}: launched "
                                 f"{launches}, expected the stacked "
                                 "prefill and decode forms only")
    if streams[1] != streams[4]:
        diff = [i for i, (a, b) in enumerate(zip(streams[1], streams[4]))
                if a != b]
        raise AssertionError(f"engine: decode_steps 4 streams differ from "
                             f"single-step ones in rows {diff}")
    log("engine bench-1b stacked: decode_steps 4 streams byte-identical to "
        "decode_steps 1 (8 rows x 32 tokens)")


# ---- graph phase ------------------------------------------------------------


# The engine comparison's cases: (label, cache options, scheduler
# options). Spec and bursts run synchronously, as the server's async
# ``auto`` resolves them.
GRAPH_CASES = [
    ("per_layer bf16, unified, async", {"cache_layout": "per_layer"},
     {"unified_step": True, "async_scheduling": True}),
    ("stacked int8, unified, async",
     {"cache_layout": "stacked", "kv_cache_dtype": "int8"},
     {"unified_step": True, "async_scheduling": True}),
    ("spec k=4, unified", {"cache_layout": "per_layer"},
     {"unified_step": True, "async_scheduling": False,
      "speculative_k": 4}),
    ("decode_steps 4, unified", {"cache_layout": "per_layer"},
     {"unified_step": True, "async_scheduling": False, "decode_steps": 4}),
]
# Steady decode steps whose host calls are counted (first case).
HOST_WINDOW_STEPS = 4


# The device kernels of each counted launch, by the suffix their names
# carry after the counter's name (prefill: the wgmma walk, its wide form
# at head dims 257 to 512, the mma.sync slab walk, the f32 walk; ragged:
# the mma.sync walk, the f32 walk).
KERNEL_SUFFIXES = ("_kernel", "_mma_kernel", "_wgmma_kernel",
                   "_wgmma_wide_kernel", "_mma_slab_kernel")


def _kernel_family(name: str):
    """The launch counter a device kernel's name belongs to (its forms
    summed), or None: the decode kernel's merge is not a counted
    launch."""
    for kernel in KERNELS:
        if any(kernel + suffix in name for suffix in KERNEL_SUFFIXES):
            return kernel
    return None


def _engine_run(cfg, prompts, cuda_graphs, profiled):
    """Run ``prompts`` (greedy, 32 tokens each, submitted together)
    through a fresh engine; returns its streams and what it counted.
    ``profiled``: the run goes under torch.profiler, which gives the
    kernels the card ran, by counter, and the host calls queued in a
    window of steady decode steps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    from production_stack_tpu_torch.tools.profile_steps import (
        is_host_launch)

    engine = LLMEngine(cfg, device="cuda", cuda_graphs=cuda_graphs)
    torch.cuda.synchronize()
    COUNTERS.reset()
    seqs = [engine.sequences[engine.add_request(p, SamplingParams(
        temperature=0.0, max_tokens=32, ignore_eos=True))] for p in prompts]

    def run():
        window = False
        while engine.has_work():
            # The window: once every row is decoding, mid-run.
            if (profiled and not window
                    and all(len(q.output_token_ids) >= 8 for q in seqs)):
                window = True
                with record_function("host window"):
                    for _ in range(HOST_WINDOW_STEPS):
                        engine.step()
                    torch.cuda.synchronize()
            else:
                engine.step()
        torch.cuda.synchronize()

    out = {}
    t0 = time.perf_counter()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        ran = {}
        for e in prof.key_averages():
            family = (_kernel_family(e.key)
                      if str(e.device_type).endswith("CUDA") else None)
            if family:
                ran[family] = ran.get(family, 0) + e.count
        events = prof.events()
        span = next(e.time_range for e in events if e.name == "host window")
        calls = {}
        for e in events:
            if (is_host_launch(e.name) and span.start <= e.time_range.start
                    and e.time_range.end <= span.end):
                calls[e.name] = calls.get(e.name, 0) + 1
        out.update(device_launches=ran, window_calls=calls)
    else:
        run()
    out["wall"] = time.perf_counter() - t0
    out["streams"] = [list(q.output_token_ids) for q in seqs]
    out["counted"] = {}
    for name, n in COUNTERS.launches.items():
        family = next(k for k in KERNELS if name.startswith(k))
        out["counted"][family] = out["counted"].get(family, 0) + n
    out["plain_calls"] = dict(COUNTERS.plain_cuda_calls)
    graphs = engine.runner.graphs
    if graphs is not None:
        out.update(captures=dict(graphs.captures),
                   capture_seconds=dict(graphs.capture_seconds),
                   replays=dict(graphs.replays), keys=graphs.keys(),
                   eager_steps=dict(graphs.eager_steps),
                   pool_bytes=graphs.pool_bytes())
    out["steps"] = engine.metrics.pipeline_steps_total
    out["ragged_steps"] = engine.metrics.ragged_steps_total
    out["drafted"] = engine.metrics.spec_draft_tokens_total
    out["engine"] = engine
    return out


def _seeded_run(engine, vocab):
    """One seeded stochastic request alone: every step has the seeded
    row, so every step runs eagerly on either path."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams

    rng = np.random.RandomState(9)
    seq = engine.generate(rng.randint(258, vocab, size=200).tolist(),
                          SamplingParams(temperature=0.8, top_p=0.95,
                                         seed=17, max_tokens=8,
                                         ignore_eos=True))
    return list(seq.output_token_ids)


def graph_phase(vocab: int) -> None:
    """Each case graphed against eager: greedy streams byte-identical;
    see the module docstring (phase 6)."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, bench_1b_model_config)

    rng = np.random.RandomState(4)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 700, 16).round().astype(int)]
    spec_prompts = []
    for i in range(16):
        block = rng.randint(258, vocab, size=16 + 3 * i).tolist()
        spec_prompts.append((block * (500 // len(block) + 1))[:500 - 7 * i])
    for c, (label, cache, sched) in enumerate(GRAPH_CASES):
        cfg_of = lambda: EngineConfig(  # noqa: E731
            model=bench_1b_model_config(),
            cache=CacheConfig(page_size=128, num_pages=512, **cache),
            scheduler=SchedulerConfig(
                max_num_seqs=32, max_model_len=1024, prefill_chunk_size=512,
                prefill_batch_size=8, **sched))
        case_prompts = spec_prompts if "speculative_k" in sched else prompts
        runs = {}
        for cuda_graphs in (True, False):
            run = _engine_run(cfg_of(), case_prompts, cuda_graphs,
                              profiled=c == 0)
            if c == 0:
                # A seeded request alone, in the same engine.
                run["seeded"] = _seeded_run(run["engine"], vocab)
                if cuda_graphs:
                    run["eager_after_seeded"] = dict(
                        run["engine"].runner.graphs.eager_steps)
            del run["engine"]
            torch.cuda.empty_cache()
            runs["graphs" if cuda_graphs else "eager"] = run
        g, e = runs["graphs"], runs["eager"]
        log(f"graphs bench-1b {label}: {len(case_prompts)} prompts x 32 "
            f"tokens over {g['steps']} steps ({g['ragged_steps']} unified or "
            f"verify-ragged, {g['drafted']} drafted); graphed "
            f"{g['wall']:.3f} s, eager {e['wall']:.3f} s; captures "
            f"{g['captures']} in "
            f"{ {k: round(v, 3) for k, v in g['capture_seconds'].items()} } s"
            f", replays {g['replays']}, {len(g['keys'])} keys "
            f"{sorted(g['keys'])}, graph pool "
            f"{g['pool_bytes'] / 2**20:.1f} MiB, eager steps "
            f"{g['eager_steps']}; launches graphed {g['counted']}, eager "
            f"{e['counted']}")
        if g["streams"] != e["streams"]:
            rows = [i for i, (a, b) in enumerate(zip(g["streams"],
                                                     e["streams"]))
                    if a != b]
            raise AssertionError(f"graphs {label}: greedy streams differ "
                                 f"from the eager run's in rows {rows}")
        if (sum(g["captures"].values()) != len(g["keys"])
                or any(g["eager_steps"].values())
                or sum(g["replays"].values()) < len(g["keys"])):
            raise AssertionError(
                f"graphs {label}: expected one capture a key, a replay "
                f"every step and no eager step: captures {g['captures']}, "
                f"keys {len(g['keys'])}, replays {g['replays']}, steps "
                f"{g['steps']}, eager {g['eager_steps']}")
        if g["plain_calls"] or e["plain_calls"]:
            raise AssertionError(f"graphs {label}: plain versions ran on "
                                 f"CUDA tensors")
        if set(g["counted"]) != set(KERNELS) and c < 2:
            raise AssertionError(f"graphs {label}: launched {g['counted']}, "
                                 "expected all three kernels")
        if "speculative_k" in sched and g["drafted"] <= 0:
            raise AssertionError(f"graphs {label}: nothing was drafted")
        if c == 0:
            for path, run in runs.items():
                if run["device_launches"] != run["counted"]:
                    raise AssertionError(
                        f"graphs {label} ({path}): the card ran "
                        f"{run['device_launches']} kernels, the counters "
                        f"say {run['counted']}")
                calls = {k: v / HOST_WINDOW_STEPS
                         for k, v in sorted(run["window_calls"].items())}
                log(f"graphs bench-1b {label} ({path}): host calls per "
                    f"steady decode step {sum(calls.values()):.2f} "
                    f"({calls}); "
                    f"the card ran {run['device_launches']} attention "
                    "kernels, as counted")
            if g["seeded"] != e["seeded"]:
                raise AssertionError("graphs: a seeded request's tokens "
                                     "differ between the two engines")
            eager = g["eager_after_seeded"]["seeded"]
            if eager < 8:
                raise AssertionError(f"graphs: the seeded request's steps "
                                     f"ran eagerly {eager} times, expected "
                                     "one a step (8)")
            log(f"graphs: a seeded request alone ran {eager} steps "
                f"eagerly in the graphed engine, tokens equal to the eager "
                "engine's")
        log(f"graphs bench-1b {label}: greedy streams byte-identical, "
            f"graphed against eager ({len(case_prompts)} rows x 32 tokens)")


# ---- sampling options phase -------------------------------------------------


# Greedy bias of a guided row: its structural bytes in the order that
# closes a document ({"":""}) and EOS after it.
GUIDED_CLOSING_BIAS = {ord("{"): 60.0, ord('"'): 100.0, ord(":"): 80.0,
                       ord("}"): 50.0, 257: 100.0}
FORCED_TOKEN = 1234
OPTIONS_MIN_TOKENS = 8
LOGPROB_TOL = 1e-3


def _option_rows():
    """(label, sampling kwargs) of the phase's 16 rows: every option of
    the chain, mixed with plain greedy rows, 32 tokens each."""
    base = dict(temperature=0.0, max_tokens=32)
    lp = dict(logprobs=True, top_logprobs=20)
    kinds = [
        ("plain", dict(base, ignore_eos=True)),
        ("penalties+logprobs", dict(base, ignore_eos=True,
                                    presence_penalty=0.8,
                                    frequency_penalty=0.4, **lp)),
        ("repetition", dict(base, ignore_eos=True, repetition_penalty=1.3)),
        ("forced", dict(base, ignore_eos=True,
                        logit_bias={FORCED_TOKEN: 100.0})),
        ("min_tokens", dict(base, min_tokens=OPTIONS_MIN_TOKENS,
                            logit_bias={257: 100.0})),
        ("guided", dict(base, guided="json",
                        logit_bias=GUIDED_CLOSING_BIAS)),
        ("logprobs", dict(base, ignore_eos=True, **lp)),
        ("plain", dict(base, ignore_eos=True)),
    ]
    return kinds * 2


def _options_run(prompts, decode_steps, cuda_graphs):
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, bench_1b_model_config)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    cfg = EngineConfig(
        model=bench_1b_model_config(),
        cache=CacheConfig(page_size=128, num_pages=512),
        scheduler=SchedulerConfig(
            max_num_seqs=32, max_model_len=1024, prefill_chunk_size=512,
            prefill_batch_size=8, decode_steps=decode_steps,
            async_scheduling=decode_steps == 1, unified_step=True))
    engine = LLMEngine(cfg, device="cuda", cuda_graphs=cuda_graphs)
    torch.cuda.synchronize()
    COUNTERS.reset()
    ids = [engine.add_request(p, SamplingParams(**kw))
           for p, (_, kw) in zip(prompts, _option_rows())]
    rows = {sid: [] for sid in ids}
    seqs = [engine.sequences[sid] for sid in ids]
    t0 = time.perf_counter()
    while engine.has_work():
        for out in engine.step():
            if out.new_token is not None:
                rows[out.seq_id].append((out.new_token, out.logprobs))
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0,
           "rows": [rows[sid] for sid in ids],
           "finish": [s.finish_reason.value for s in seqs],
           "steps": engine.metrics.pipeline_steps_total,
           "launches": dict(COUNTERS.launches),
           "plain_calls": dict(COUNTERS.plain_cuda_calls),
           "guided_fsm": engine.guided_fsm}
    graphs = engine.runner.graphs
    if graphs is not None:
        out.update(captures=dict(graphs.captures), keys=graphs.keys(),
                   replays=dict(graphs.replays),
                   eager_steps=dict(graphs.eager_steps))
    del engine, seqs
    torch.cuda.empty_cache()
    return out


def _tokens(run):
    return [[t for t, _ in r] for r in run["rows"]]


def _logprob_gap(a, b) -> float:
    """The largest difference between two runs' logprob entries of the
    same tokens; raises where a top id differs other than at a tie."""
    worst = 0.0
    for (slp, tops), (e_slp, e_tops) in zip(a, b):
        worst = max(worst, abs(slp - e_slp))
        vals = [v for _, v in e_tops]
        for j, ((tid, v), (e_tid, e_v)) in enumerate(zip(tops, e_tops)):
            worst = max(worst, abs(v - e_v))
            if tid != e_tid and not (j == len(vals) - 1 or any(
                    k != j and abs(vals[k] - e_v) <= LOGPROB_TOL
                    for k in range(len(vals)))):
                raise AssertionError(f"sampling options: top id {tid} "
                                     f"against {e_tid} at rank {j}, no tie")
    return worst


def sampling_options_phase(vocab: int) -> None:
    """The per-row option chain at full width, graphed against eager at
    decode_steps 1 and 4; see the module docstring (phase 7)."""
    rng = np.random.RandomState(6)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 700, 16).round().astype(int)]
    labels = [label for label, _ in _option_rows()]
    runs = {}
    for k in (1, 4):
        for cuda_graphs in (True, False):
            runs[k, cuda_graphs] = _options_run(prompts, k, cuda_graphs)
    for k in (1, 4):
        g, e = runs[k, True], runs[k, False]
        if _tokens(g) != _tokens(e):
            bad = [labels[i] for i, (a, b) in enumerate(zip(_tokens(g),
                                                           _tokens(e)))
                   if a != b]
            raise AssertionError(f"sampling options K={k}: graphed streams "
                                 f"differ from eager in rows {bad}")
        gap = 0.0
        for i, (rg, re_) in enumerate(zip(g["rows"], e["rows"])):
            want = _option_rows()[i][1].get("logprobs", False)
            entries = [lp for _, lp in rg], [lp for _, lp in re_]
            if want != all(x is not None for x in entries[0] + entries[1]):
                raise AssertionError(f"sampling options K={k}: row "
                                     f"{labels[i]} logprobs {want} not kept")
            if want:
                gap = max(gap, _logprob_gap(*entries))
        if gap > LOGPROB_TOL:
            raise AssertionError(f"sampling options K={k}: logprobs differ "
                                 f"by {gap} graphed against eager")
        if (sum(g["captures"].values()) != len(g["keys"])
                or any(g["eager_steps"].values())):
            raise AssertionError(f"sampling options K={k}: captures "
                                 f"{g['captures']} for {len(g['keys'])} keys, "
                                 f"eager steps {g['eager_steps']}")
        if g["plain_calls"] or e["plain_calls"]:
            raise AssertionError("sampling options: plain versions ran on "
                                 "CUDA tensors")
        fsm = g["guided_fsm"]
        for i, label in enumerate(labels):
            toks = _tokens(g)[i]
            if label == "forced" and set(toks) != {FORCED_TOKEN}:
                raise AssertionError(f"sampling options K={k}: the +100 "
                                     f"token was not emitted: {toks}")
            if label == "min_tokens" and (
                    len(toks) != OPTIONS_MIN_TOKENS + 1 or toks[-1] != 257
                    or 257 in toks[:-1]):
                raise AssertionError(f"sampling options K={k}: min_tokens "
                                     f"row {toks}")
            if label == "guided":
                state = 0
                for t in toks:
                    state = fsm.advance(state, t)
                json.loads(bytes(t for t in toks if t < 256))
                if state < 0 or toks[-1] != 257:
                    raise AssertionError(f"sampling options K={k}: guided "
                                         f"row {toks}")
        by_options = {}
        for key in g["keys"]:
            name = "+".join(key[3]) or "none"
            by_options[name] = by_options.get(name, 0) + 1
        log(f"sampling options bench-1b K={k}: 16 rows "
            f"({', '.join(labels[:8])} x 2) in {g['steps']} steps; "
            f"graphed {g['wall']:.3f} s, eager {e['wall']:.3f} s; "
            f"captures {g['captures']} for {len(g['keys'])} keys, by "
            f"option set {by_options}; replays {g['replays']}, eager "
            f"steps {g['eager_steps']}; launches {g['launches']}; "
            f"logprobs graphed vs eager within {gap:.2e}")
    if _tokens(runs[1, True]) != _tokens(runs[4, True]):
        raise AssertionError("sampling options: decode_steps 4 streams "
                             "differ from decode_steps 1")
    log("sampling options bench-1b: greedy streams byte-identical graphed "
        "against eager and at decode_steps 1 and 4; guided rows parse as "
        "JSON, min_tokens rows held EOS back, the +100 token emitted")


# ---- serving phase ----------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def serving_run(label, extra_args, requests, repeat, after=(), form="",
                probe=None, inspect=None):
    """Start the port's server with SERVER_ARGS + ``extra_args``, send
    ``requests`` concurrently with the launch counters set to 0 just
    before and read just after, then ``repeat`` twice; then (outside
    the counted window) the ``after`` requests, ``probe`` (a body
    whose answer is returned unchecked, as ``probe``) and
    ``inspect(server, url)`` (its result returned as ``inspected``),
    the server still serving. Checks every
    completion, that every kernel launched in its ``form`` (the
    counter suffix: "", "_int8", "_stacked" or "_int8_stacked") and in
    no other, and returns what the run measured, with the decode
    dispatches' rows and committed tokens in the counted window."""
    from production_stack_tpu_torch.engine.server import make_server
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    port = _free_port()
    server = make_server(SERVER_ARGS + extra_args
                         + ["--host", "127.0.0.1", "--port", str(port)])
    # The synchronous decode dispatches (bursts, or single steps with
    # async off): rows and tokens each committed.
    runner = server.app.engine.runner
    decode = {"dispatches": 0, "row_steps": 0, "tokens": 0}
    run_decode = runner.run_decode

    def counted_run_decode(plan):
        out = run_decode(plan)
        if plan.drafts is None:
            decode["dispatches"] += 1
            decode["row_steps"] += len(out[0])
            decode["tokens"] += sum(len(t) for t in out[0])
        return out

    runner.run_decode = counted_run_decode
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def post_all(bodies):
        with ThreadPoolExecutor(len(bodies)) as pool:
            return list(pool.map(
                lambda b: _post(base + "/v1/completions", b), bodies))

    try:
        torch.cuda.synchronize()
        COUNTERS.reset()
        decode.update(dispatches=0, row_steps=0, tokens=0)
        t0 = time.perf_counter()
        answers = post_all(requests)
        wall = time.perf_counter() - t0
        again = [_post(base + "/v1/completions", repeat) for _ in range(2)]
        torch.cuda.synchronize()
        launches = dict(COUNTERS.launches)
        plain_calls = dict(COUNTERS.plain_cuda_calls)
        decode_counts = dict(decode)
        graphs = runner.graphs
        ledger = (dict(graphs.captures), dict(graphs.replays),
                  dict(graphs.eager_steps), len(graphs.keys()))
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        after_answers = post_all(list(after)) if after else []
        probe_answer = (_post(base + "/v1/completions", probe)
                        if probe is not None else None)
        inspected = inspect(server, base) if inspect is not None else None
    finally:
        server.shutdown()
        thread.join(timeout=60)

    bodies = list(requests) + [repeat] * 2 + list(after)
    for body, ans in zip(bodies, answers + again + after_answers):
        usage = ans["usage"]
        n = body["max_tokens"]
        if (usage["completion_tokens"] != n
                or usage["prompt_tokens"] != len(body["prompt"])
                or usage["total_tokens"] != len(body["prompt"]) + n
                or ans["choices"][0]["finish_reason"] != "length"):
            raise AssertionError(f"{label}: bad completion: {ans}")
    if again[0]["choices"][0]["text"] != again[1]["choices"][0]["text"]:
        raise AssertionError(f"{label}: a repeated greedy request gave "
                             "other tokens")

    def metric(name):
        return float(next(line.split()[-1] for line in metrics.splitlines()
                          if line.startswith(name + " ")))

    ragged = metric("vllm:engine_ragged_steps_total")
    if ragged <= 0:
        raise AssertionError(f"{label}: no unified mixed step ran")
    for kernel in KERNELS:
        if launches.get(kernel + form, 0) <= 0:
            raise AssertionError(f"{label}: the run never launched "
                                 f"{kernel + form}")
        for other in ("", "_int8", "_stacked", "_int8_stacked"):
            if other != form and launches.get(kernel + other, 0):
                raise AssertionError(f"{label}: the run launched "
                                     f"{kernel + other}")
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: plain versions ran on CUDA "
                             f"tensors: {plain_calls}")
    captures, replays, eager, keys = ledger
    if (sum(captures.values()) != keys or not sum(replays.values())
            or any(eager.values())):
        raise AssertionError(f"{label}: expected every step replayed from "
                             f"a graph captured once a key: captures "
                             f"{captures}, keys {keys}, replays {replays}, "
                             f"eager steps {eager}")
    if metric("vllm:engine_compile_events_total{kind=\"step\"}") != (
            captures["step"]):
        raise AssertionError(f"{label}: /metrics does not carry the "
                             "step graphs' captures")
    log(f"{label}: captures {captures} ({keys} keys), replays {replays}, "
        f"eager steps {eager}")
    tokens = sum(b["max_tokens"] for b in requests)
    log(f"{label} bench-1b: {len(requests)} concurrent requests, "
        f"{tokens} tokens in {wall:.3f} s ({tokens / wall:.1f} tok/s); "
        f"ragged steps {ragged:.0f}; launches {launches}; plain calls "
        f"on CUDA tensors {plain_calls or 0}")
    return {"launches": launches, "answers": answers,
            "after": after_answers, "probe": probe_answer,
            "inspected": inspected, "wall": wall,
            "tokens": tokens,
            "metrics": metrics, "metric": metric, "decode": decode_counts,
            "async": server.app.engine.config.scheduler.async_scheduling,
            "drafted": metric("vllm:spec_decode_num_draft_tokens_total"),
            "accepted": metric(
                "vllm:spec_decode_num_accepted_tokens_total")}


def serving_phase(vocab: int) -> dict:
    """Returns each serving run's kernel launch counts."""
    rng = np.random.RandomState(0)
    lengths = np.linspace(64, 700, 16).round().astype(int)
    requests = []
    for i, n in enumerate(lengths):
        body = {"model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
                "prompt": rng.randint(258, vocab, size=n).tolist()}
        body.update({"temperature": 0.0} if i % 2 == 0 else
                    {"temperature": 0.8, "top_p": 0.95})
        requests.append(body)
    repeat = {"model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
              "temperature": 0.0,
              "prompt": rng.randint(258, vocab, size=300).tolist()}
    # Greedy prompts that repeat a block of 16..64 tokens up to about
    # 500 tokens: the trailing n-gram of each has occurred before, so
    # the proposer drafts even when random weights do not repeat.
    spec_requests = []
    for i in range(16):
        block = rng.randint(258, vocab, size=16 + 3 * i).tolist()
        spec_requests.append({
            "model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
            "temperature": 0.0,
            "prompt": (block * (500 // len(block) + 1))[:500 - 7 * i]})

    # After the timed window: n 3 of best_of 4 candidates, with the
    # sampled logprob and 5 alternatives a position.
    probe = {"model": "bench-1b", "max_tokens": 16, "ignore_eos": True,
             "temperature": 0.9, "seed": 5, "n": 3, "best_of": 4,
             "logprobs": 5, "prompt": requests[3]["prompt"]}
    span_dir = tempfile.mkdtemp(prefix="chip-smoke-spans-")
    span_log = os.path.join(span_dir, "engine.jsonl")
    base = serving_run(
        "serving", ["--request-span-log", span_log], requests, repeat,
        after=spec_requests, probe=probe,
        inspect=lambda server, url: observatory_checks(
            server, url, requests, span_log))
    _check_best_of(base["probe"], probe)
    global SERVE_TOK_S
    SERVE_TOK_S = base["tokens"] / base["wall"]
    spec = serving_run("serving spec k=4", ["--speculative-k", "4"],
                       spec_requests, spec_requests[0])
    if spec["drafted"] <= 0:
        raise AssertionError("the speculative run drafted no token")
    same = total = whole = 0
    for a, b in zip(spec["answers"], base["after"]):
        ta, tb = a["choices"][0]["text"], b["choices"][0]["text"]
        same += sum(x == y for x, y in zip(ta, tb))
        total += max(len(ta), len(tb))
        whole += ta == tb
    log(f"serving spec k=4: drafted {spec['drafted']:.0f}, accepted "
        f"{spec['accepted']:.0f} tokens; {spec['tokens'] / spec['wall']:.1f} "
        f"tok/s; greedy characters agreeing with the spec-off server "
        f"{same}/{total} ({same / total:.4f}), whole completions "
        f"{whole}/{len(spec['answers'])}")

    int8 = serving_run("serving int8 KV", ["--kv-cache-dtype", "int8"],
                       requests, repeat, form="_int8")
    if 'vllm:engine_kv_cache_dtype{kv_dtype="int8"} 1.0' not in (
            int8["metrics"]):
        raise AssertionError("int8 serving: /metrics does not show "
                             'kv_dtype="int8"')
    capacity = int8["metric"]("vllm:engine_kv_cache_page_capacity")
    if capacity != INT8_PAGE_CAPACITY:
        raise AssertionError(f"int8 serving: page capacity {capacity}, "
                             f"expected {INT8_PAGE_CAPACITY}")
    same, total, whole, greedy = _greedy_agreement(requests, int8, base)
    log(f"serving int8 KV: page capacity {capacity:.0f}, "
        f"{int8['tokens'] / int8['wall']:.1f} tok/s against "
        f"{base['tokens'] / base['wall']:.1f} for bf16 KV; greedy "
        f"characters agreeing with the bf16 KV server {same}/{total} "
        f"({same / total:.4f}), whole completions {whole}/{greedy}")

    stacked = serving_run("serving stacked", ["--cache-layout", "stacked"],
                          requests, repeat, form="_stacked")
    same, total, whole, greedy = _greedy_agreement(requests, stacked, base)
    log(f"serving stacked: {stacked['tokens'] / stacked['wall']:.1f} tok/s "
        f"against {base['tokens'] / base['wall']:.1f} per_layer; greedy "
        f"characters agreeing with the per_layer server {same}/{total} "
        f"({same / total:.4f}), whole completions {whole}/{greedy}")

    burst = serving_run("serving stacked int8 K=4",
                        ["--cache-layout", "stacked", "--kv-cache-dtype",
                         "int8", "--decode-steps", "4",
                         "--deferred-kv-writes", "off"], requests, repeat,
                        form="_int8_stacked")
    d = burst["decode"]
    per_row = d["tokens"] / max(d["row_steps"], 1)
    log(f"serving stacked int8 K=4: async {burst['async']}, "
        f"{burst['tokens'] / burst['wall']:.1f} tok/s; {d['dispatches']} "
        f"decode dispatches, {d['row_steps']} row-dispatches committing "
        f"{d['tokens']} tokens ({per_row:.2f} a row a dispatch)")
    if burst["async"]:
        raise AssertionError("burst serving: --async-scheduling auto did "
                             "not resolve off with --decode-steps 4")
    if per_row < 3.0:
        raise AssertionError(f"burst serving: {per_row:.2f} tokens a row "
                             "a decode dispatch, expected about 4")
    return {"serve": base["launches"], "serve_spec": spec["launches"],
            INT8_RUN: int8["launches"], STACKED_RUN: stacked["launches"],
            BURST_RUN: burst["launches"]}


def _check_best_of(ans, body) -> None:
    """An n / best_of / logprobs answer's shape: n choices in order of
    their mean token logprob, each with its tokens' legacy logprobs,
    and every candidate's tokens in the usage."""
    n, m = body["n"], body["max_tokens"]
    choices = ans["choices"]
    means = []
    for i, c in enumerate(choices):
        lp = c["logprobs"]
        if (c["index"] != i or c["finish_reason"] != "length"
                or len(lp["tokens"]) != m or len(lp["token_logprobs"]) != m
                or len(lp["top_logprobs"]) != m
                or not all(1 <= len(t) <= body["logprobs"]
                           for t in lp["top_logprobs"])):
            raise AssertionError(f"serving n/best_of: bad choice {c}")
        means.append(sum(lp["token_logprobs"]) / m)
    if (len(choices) != n or means != sorted(means, reverse=True)
            or ans["usage"]["completion_tokens"] != body["best_of"] * m):
        raise AssertionError(f"serving n/best_of: {len(choices)} choices, "
                             f"means {means}, usage {ans['usage']}")
    log(f"serving n={n} best_of={body['best_of']} logprobs="
        f"{body['logprobs']}: {n} choices of mean token logprob "
        f"{[round(x, 4) for x in means]}, usage {ans['usage']}")


def _greedy_agreement(requests, run, base):
    """(characters equal, characters, whole completions equal, greedy
    completions) of ``run``'s greedy answers against ``base``'s."""
    same = total = whole = greedy = 0
    for body, a, b in zip(requests, run["answers"], base["answers"]):
        if body.get("temperature", 1.0) != 0.0:
            continue
        ta, tb = a["choices"][0]["text"], b["choices"][0]["text"]
        same += sum(x == y for x, y in zip(ta, tb))
        total += max(len(ta), len(tb))
        whole += ta == tb
        greedy += 1
    return same, total, whole, greedy


# ---- observatory phase --------------------------------------------------------

# The request the observatory phase traces by its x-request-id, and the
# tokens out of the lone stream whose decode steps it times.
TRACE_ID = "chip-smoke-trace"
WALL_OUT = 128


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _decode_wall_ms(url, prompt) -> float:
    """A lone greedy stream of WALL_OUT tokens: the wall a token after
    the first, in ms (the steady decode step's wall at one row), on its
    second run (the first captures what is new)."""
    body = {"max_tokens": WALL_OUT, "temperature": 0, "ignore_eos": True,
            "stream": True, "prompt": prompt}
    for _ in range(2):
        _, first, total = _timed_stream(url, "/v1/completions", body)
    return 1e3 * (total - first) / (WALL_OUT - 1)


def observatory_checks(server, url, requests, span_log) -> dict:
    """The observatory and the tracer on the first serving run's server,
    after its timed window; see the module docstring (phase 9)."""
    engine = server.app.engine
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        metrics = r.read().decode()
    mfu = float(re.search(r"^vllm:engine_mfu (\S+)$", metrics,
                          re.M).group(1))
    if not 0.0 < mfu < 1.0:
        raise AssertionError(f"observatory: vllm:engine_mfu {mfu}")
    impls = dict(re.findall(r'^vllm:engine_attention_impl\{phase="(\w+)",'
                            r'impl="(\w+)"\} 1\.0$', metrics, re.M))
    if impls != dict.fromkeys(("decode", "prefill", "unified"), "cuda"):
        raise AssertionError(f"observatory: attention impls {impls}")
    compiles = _get_json(url + "/debug/compiles")
    if compiles["events"] != engine.runner.graphs.captures:
        raise AssertionError(f"observatory: /debug/compiles events "
                             f"{compiles['events']}, the graphs captured "
                             f"{engine.runner.graphs.captures}")
    memory = _get_json(url + "/debug/memory")
    analytic = memory["analytic"]
    allocated = memory.get("device", {}).get("allocated_bytes.all.current",
                                             0)
    if allocated < analytic["weights"] + analytic["kv_pages"]:
        raise AssertionError(f"observatory: {allocated} bytes allocated, "
                             f"under the analytic weights and pages "
                             f"{analytic}")

    # A profiler window around the timed window's requests: the trace
    # names all three kernels.
    trace_dir = tempfile.mkdtemp(prefix="chip-smoke-trace-")
    status, text, _ = _http("POST", url + "/debug/profiler/start?dir="
                            + trace_dir)
    if status != 200:
        raise AssertionError(f"observatory: profiler start {status} {text}")
    with ThreadPoolExecutor(len(requests)) as pool:
        list(pool.map(lambda b: _post(url + "/v1/completions", b), requests))
    status, text, _ = _http("POST", url + "/debug/profiler/stop")
    if status != 200:
        raise AssertionError(f"observatory: profiler stop {status} {text}")
    with open(json.loads(text)["trace"]) as f:
        trace = json.load(f)
    kernels = {}
    for ev in trace.get("traceEvents", []):
        family = (_kernel_family(ev.get("name", ""))
                  if ev.get("cat") == "kernel" else None)
        if family:
            kernels[family] = kernels.get(family, 0) + 1
    if set(kernels) != set(KERNELS):
        raise AssertionError(f"observatory: the profiler's trace names "
                             f"{kernels}, not all of {list(KERNELS)}")

    # One request's timeline by its x-request-id, and the span lines
    # stitched by the repo's traceview (a standard-library script, run
    # as a process of its own).
    greedy = [b for b in requests if b.get("temperature") == 0.0][:4]
    status, _, _ = _http("POST", url + "/v1/completions", greedy[0],
                         {"x-request-id": TRACE_ID})
    found = _get_json(url + "/debug/trace/" + TRACE_ID)
    events = [e["event"] for e in found["spans"][0]["events"]]
    if status != 200 or not {"enqueue", "prefill_chunk", "first_token",
                             "finish"} <= set(events):
        raise AssertionError(f"observatory: /debug/trace events {events}")
    with open(span_log) as f:
        lines = [json.loads(line) for line in f]
    view = subprocess.run(
        [sys.executable, "-m", "production_stack_tpu.traceview", span_log,
         "--request-id", TRACE_ID], capture_output=True, text=True,
        timeout=60, cwd=os.path.dirname(os.path.abspath(__file__)))
    if (view.returncode != 0 or "engine[both" not in view.stdout
            or "first_token" not in view.stdout):
        raise AssertionError(f"observatory: traceview: {view.returncode} "
                             f"{view.stdout} {view.stderr}")

    # Greedy streams with the tracer on (this server) and with
    # --trace-ring-size 0 (no tracer), each request alone, on prompts
    # neither server has cached.
    rng = np.random.RandomState(21)
    vocab = engine.config.model.vocab_size
    fresh = [dict(greedy[0], max_tokens=32,
                  prompt=rng.randint(258, vocab, size=n).tolist())
             for n in (100, 300, 600, 700)]
    on = [_post(url + "/v1/completions", b)["choices"][0]["text"]
          for b in fresh]
    wall_prompt = rng.randint(258, vocab, size=64).tolist()
    on_wall = _decode_wall_ms(url, wall_prompt)
    off = _Server(["--trace-ring-size", "0"])
    try:
        if off.engine.tracer is not None:
            raise AssertionError("observatory: --trace-ring-size 0 left a "
                                 "tracer installed")
        off_texts = [_post(off.url + "/v1/completions", b)["choices"][0][
            "text"] for b in fresh]
        off_wall = _decode_wall_ms(off.url, wall_prompt)
    finally:
        off.close()
    if on != off_texts:
        raise AssertionError("observatory: greedy streams differ with the "
                             "tracer on and off")
    log(f"observatory: vllm:engine_mfu {mfu:.6f} over the serving run; "
        f"attention impls {impls}; captures {compiles['events']} on "
        f"/debug/compiles as the graphs count them; {allocated} bytes "
        f"allocated against analytic {analytic}; the profiler's trace "
        f"ran kernels {kernels}; /debug/trace events {events}; "
        f"{len(lines)} span lines stitched by traceview; {len(fresh)} "
        f"greedy streams byte-identical with the tracer on and off; "
        f"steady decode wall a token at one row: tracer on "
        f"{on_wall:.3f} ms, off {off_wall:.3f} ms; {SMI}")
    return {"mfu": mfu, "decode_wall_ms": {"on": on_wall, "off": off_wall}}


# ---- fleet phase --------------------------------------------------------------

# (label, server args beyond SERVER_ARGS, bytes of one page on the wire,
# its arrays' wire dtypes, the launch-counter suffix of its kernels, the
# --num-pages that forces preemption): bench-1b pages of 128 tokens are
# 16 layers x 2 planes x 8 kv heads x 64 x 128 elements, bf16 2 bytes
# each; int8 1 byte each plus 16 x 2 x 8 x 128 f32 scales.
FLEET_RUNS = (
    ("fleet bf16 per_layer", [], 4_194_304, ["bfloat16"] * 2, "", 32),
    ("fleet int8 stacked", ["--cache-layout", "stacked",
                            "--kv-cache-dtype", "int8"], 2_228_224,
     ["int8"] * 2 + ["float32"] * 2, "_int8_stacked", 17),
)
FLEET_CHECKPOINT = 16
FLEET_OUT = 64
# The resumed chat's content (about 700 prompt tokens with the chat
# template), and the prompt lengths of the 16 preempt-to-offload rows.
FLEET_PROMPT_CHARS = 680
PREEMPT_LENGTHS = np.linspace(64, 700, 16).round().astype(int)
# Enough tokens out that every row crosses a page boundary while others
# hold the budget, so victims wait and their cached pages are reused.
PREEMPT_OUT = 128
SMI = ""  # the card's name and power limit, set by main()


class _Server:
    """A port server in-process on a free port, serving on a thread."""

    def __init__(self, args, base=SERVER_ARGS):
        from production_stack_tpu_torch.engine.server import make_server
        port = _free_port()
        self.http = make_server(base + args + [
            "--host", "127.0.0.1", "--port", str(port)])
        self.app = self.http.app
        self.engine = self.app.engine
        self.url = f"http://127.0.0.1:{port}"
        # Every finished sequence's token ids (prompt, as folded by any
        # preemption or resume, then output).
        self.finished = []
        on_finished = self.engine.metrics.on_finished

        def record(seq):
            self.finished.append(list(seq.all_token_ids))
            on_finished(seq)

        self.engine.metrics.on_finished = record
        self.thread = threading.Thread(target=self.http.serve, daemon=True)
        self.thread.start()

    def stop(self):
        """Stop serving; the engine stays for ``near_tie``."""
        if self.thread.is_alive():
            self.http.shutdown()
            self.thread.join(timeout=60)

    def tokens_after(self, prefix):
        """The token ids after ``prefix`` of the finished sequence that
        starts with it."""
        return next(t[len(prefix):] for t in self.finished
                    if t[:len(prefix)] == list(prefix))

    def close(self):
        self.stop()
        self.http = self.app = self.engine = None
        import gc
        gc.collect()
        torch.cuda.empty_cache()


def _http(method, url, body=None, headers=None):
    """(status, text, headers) of one request, HTTP errors included."""
    req = urllib.request.Request(
        url, method=method, headers={"Content-Type": "application/json",
                                     **(headers or {})},
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _sse_events(raw: str):
    """(kind, payload) of each SSE event: "ckpt" (a checkpoint frame's
    descriptor), "migrating" (the drain cut's marker) or "data"."""
    events = []
    for block in raw.split("\n\n"):
        block = block.strip()
        if block.startswith(": checkpoint "):
            events.append(("ckpt", json.loads(block[len(": checkpoint "):])))
        elif block == ": migrating":
            events.append(("migrating", None))
        elif block.startswith("data: ") and block != "data: [DONE]":
            events.append(("data", json.loads(block[len("data: "):])))
    return events


def _text(events) -> str:
    out = []
    for kind, e in events:
        if kind == "data":
            c = e["choices"][0]
            out.append((c.get("delta") or {}).get("content") or c.get("text")
                       or "")
    return "".join(out)


def _timed_stream(url, path, body):
    """Stream one request: (raw text, seconds to the first content
    frame, seconds in all)."""
    import http.client
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"{path}: {resp.status} {resp.read()}")
    raw, first = b"", None
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        raw += chunk
        if first is None and _text(_sse_events(raw.decode(errors="ignore"))):
            first = time.perf_counter() - t0
    conn.close()
    return raw.decode(), first, time.perf_counter() - t0


def tie_margin(top_logprobs, got_token) -> float:
    """The reference's margin against ``got_token`` from its top
    logprobs ({token: logprob}): its best logprob minus its logprob of
    ``got_token`` (a logit difference, never negative), inf when
    ``got_token`` is not among them: ``compare_logits``' margin."""
    if got_token not in top_logprobs:
        return float("inf")
    return max(top_logprobs.values()) - top_logprobs[got_token]


def near_tie(engine, context, got_token, lora_name=None) -> float:
    """``tie_margin`` of the engine's top 20 logprobs at the token after
    ``context`` (with the adapter ``lora_name``, if any). The engine
    must not be serving (its loop stopped)."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    sid = engine.add_request(list(context), SamplingParams(
        temperature=0.0, max_tokens=1, logprobs=True, top_logprobs=20,
        ignore_eos=True), lora_name=lora_name)
    entry = None
    while entry is None:
        for out in engine.step():
            if out.seq_id == sid and out.logprobs is not None:
                entry = out.logprobs
    while engine.has_work():
        engine.step()
    return tie_margin(dict(entry[1]), got_token)


def check_stream(label, what, ref_engine, context, ref_ids, got_ids,
                 lora_name=None):
    """Greedy ``got_ids`` against ``ref_ids`` after ``context``: equal,
    or equal up to a first flip that is a near tie of the reference
    engine (its margin under ``NEAR_TIE_LOGITS``, the model phase's
    rule: bf16 arithmetic in another order, a step of another kind or
    shape, may flip a near tie, and the streams part there), the
    reference run with the adapter ``lora_name``, if any. Returns the
    flip's (index, margin), or None."""
    if len(got_ids) != len(ref_ids):
        raise AssertionError(f"{label}: {what}: {len(got_ids)} tokens, "
                             f"expected {len(ref_ids)}")
    flip = next((i for i, (x, y) in enumerate(zip(ref_ids, got_ids))
                 if x != y), None)
    if flip is None:
        return None
    margin = near_tie(ref_engine, list(context) + ref_ids[:flip],
                      got_ids[flip], lora_name)
    if not margin < NEAR_TIE_LOGITS:
        raise AssertionError(f"{label}: {what}: token {flip} flipped at a "
                             f"margin of {margin} logits")
    return flip, margin


def _fleet_prompt(rng, vocab, n):
    return rng.randint(258, vocab, size=n).tolist()


def fleet_phase(vocab: int) -> dict:
    """The fleet contract and the offload tier at full width; see the
    module docstring (phase 14). Returns each run's kernel launches in
    its resume window."""
    from production_stack_tpu_torch.engine.cache_server import (
        build_cache_server)
    launches = {}
    for run in FLEET_RUNS:
        cache = build_cache_server(8 * 1024 ** 3)
        threading.Thread(target=cache.serve_forever, daemon=True).start()
        try:
            launches[run[0]] = _fleet_run(run, cache, vocab)
        finally:
            cache.shutdown()
            cache.server_close()
    return launches


def _fleet_run(run, cache, vocab) -> dict:
    from production_stack_tpu_torch.engine.kv_cache import (
        PagedCacheManager)
    from production_stack_tpu_torch.engine.offload import (
        _stable_key, unpackb)
    from production_stack_tpu_torch.engine.tokenizer import (
        render_chat_prompt)
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    label, extra, page_bytes, wire, form, small_pages = run
    rng = np.random.RandomState(9)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz ,."))
    content = "".join(rng.choice(letters, size=FLEET_PROMPT_CHARS))
    chat = {"max_tokens": FLEET_OUT, "temperature": 0,
            "ignore_eos": True, "stream": True,
            "messages": [{"role": "user", "content": content}]}
    tier = ["--kv-remote-url", cache.url, "--kv-host-pool-bytes", "0",
            "--checkpoint-interval-tokens", str(FLEET_CHECKPOINT),
            "--build-id", "chip-smoke"]

    # Resume: server A streams and checkpoints; B resumes from a frame
    # over the tier, R from the same frame by recompute.
    a = b = r = None
    try:
        a = _Server(extra + tier)
        eng = a.engine
        prompt = render_chat_prompt(eng.tokenizer, chat["messages"])
        tick, ship = eng._checkpoint_tick, {"s": 0.0, "bytes": 0}

        def timed_tick():
            before, t0 = eng.checkpoint_kv_bytes, time.perf_counter()
            tick()
            if eng.checkpoint_kv_bytes > before:
                ship["s"] += time.perf_counter() - t0
                ship["bytes"] += eng.checkpoint_kv_bytes - before

        eng._checkpoint_tick = timed_tick
        raw, _, _ = _timed_stream(a.url, "/v1/chat/completions", chat)
        a.stop()
        a_stats = eng.stats()
        if not raw.rstrip().endswith("data: [DONE]"):
            raise AssertionError(f"{label}: server A's stream did not end")
        events = _sse_events(raw)
        full = _text(events)
        rid = next(e for k, e in events if k == "data")["id"]
        desc, delivered, seen = None, 0, 0
        for kind, payload in events:
            if kind == "data":
                seen += len(_text([(kind, payload)]))
            elif (desc is None and kind == "ckpt"
                  and payload["output_tokens"] < FLEET_OUT
                  and len(payload["tokens"]) % 128):
                desc, delivered = payload, seen
        if desc is None or not (a_stats["checkpoint_ships_total"] > 0
                                and a_stats["checkpoint_kv_bytes_total"] > 0):
            raise AssertionError(f"{label}: no usable checkpoint ({a_stats})")
        pages_shipped = ship["bytes"] / page_bytes
        # Wire: the first page of the journal's chain, as the tier holds
        # it.
        first = PagedCacheManager.chain_hashes(desc["tokens"][:-1], 128)[0]
        arrays = unpackb(cache.store._blobs[_stable_key(first, wire[0])]
                         )["arrays"]
        nbytes = sum(len(x["data"]) for x in arrays)
        if nbytes != page_bytes or [x["dtype"] for x in arrays] != wire:
            raise AssertionError(
                f"{label}: a shipped page is {nbytes} bytes of "
                f"{[x['dtype'] for x in arrays]}, expected {page_bytes} "
                f"of {wire}")

        b = _Server(extra + tier)
        eng = b.engine
        restore, rst = eng._restore_offloaded_prefix, {"s": 0.0,
                                                       "pages": []}

        def timed_restore(*args):
            t0 = time.perf_counter()
            pages = restore(*args)
            rst["s"] += time.perf_counter() - t0
            rst["pages"] += pages
            return pages

        eng.scheduler.restore_hook = timed_restore
        # Warm the graph keys the resume takes (a prefill of the tail's
        # length, then decode) on an unrelated prompt.
        tail = len(desc["tokens"]) - (len(desc["tokens"]) - 1) // 128 * 128
        _post(b.url + "/v1/completions", {
            "max_tokens": 4, "temperature": 0, "ignore_eos": True,
            "prompt": _fleet_prompt(rng, vocab, tail)})
        torch.cuda.synchronize()
        COUNTERS.reset()
        raw, resume_ttft, _ = _timed_stream(b.url, "/v1/resume", {
            "descriptor": desc, "delivered_text_chars": delivered,
            "stream": True})
        torch.cuda.synchronize()
        window = dict(COUNTERS.launches)
        stats = eng.stats()
        resumed = _sse_events(raw)
        if {e["id"] for k, e in resumed if k == "data"} != {rid}:
            raise AssertionError(f"{label}: the resumed stream is not "
                                 f"under {rid}")
        if not (stats["kv_offload_cluster_hits"] > 0
                and stats["kv_offload_restored_pages"] > 0
                and stats["stream_resumes_total"] == 1):
            raise AssertionError(f"{label}: resume without tier hits "
                                 f"({stats})")
        # The restored pages on the card are the shipped bytes.
        for page_id in rst["pages"]:
            page_hash = eng.cache_manager._pages[page_id].page_hash
            frame = unpackb(cache.store._blobs[_stable_key(page_hash,
                                                           wire[0])])
            if [bytes(x["data"]) for x in frame["arrays"]] != [
                    t.contiguous().view(torch.uint8).numpy().tobytes()
                    for t in eng.runner.read_page(page_id)]:
                raise AssertionError(f"{label}: restored page {page_id} "
                                     "differs from the shipped bytes")
        if (window.get("paged_decode" + form, 0) <= 0
                or window.get("paged_prefill" + form, 0)
                + window.get("paged_ragged" + form, 0) <= 0):
            raise AssertionError(f"{label}: the restored pages were not "
                                 f"read through the kernels: {window}")
        if any(COUNTERS.plain_cuda_calls.values()):
            raise AssertionError(f"{label}: plain versions ran on CUDA "
                                 f"tensors: {dict(COUNTERS.plain_cuda_calls)}")
        # The client's text: A's up to the frame, then B's.
        same_text = full[:delivered] + _text(resumed) == full
        b.stop()
        restored_ids = b.tokens_after(desc["tokens"][:len(prompt)])
        flip = check_stream(label, "resumed stream", a.engine, prompt,
                            a.tokens_after(prompt), restored_ids)
        if same_text != (flip is None):
            raise AssertionError(f"{label}: text and tokens disagree")
        b.close()
        # The tier alone: the same descriptor resumed on a fresh engine
        # with no tier recomputes the whole journal, and must give B's
        # stream byte for byte (greedy, exact): the restored pages
        # stand in for recomputed ones, and where B parts from A is the
        # tail's arithmetic, not the tier.
        r = _Server(extra)
        raw, _, _ = _timed_stream(r.url, "/v1/resume", {
            "descriptor": desc, "delivered_text_chars": delivered,
            "stream": True})
        r.stop()
        recomputed_ids = r.tokens_after(desc["tokens"][:len(prompt)])
        if (recomputed_ids != restored_ids
                or _text(_sse_events(raw)) != _text(resumed)
                or r.engine.stats()["stream_resumes_total"] != 1):
            at = next((i for i, (x, y) in enumerate(
                zip(recomputed_ids, restored_ids)) if x != y), None)
            raise AssertionError(
                f"{label}: the resume by restore and the resume by "
                f"recompute differ (first at output token {at})")
        r.close()
        b = _Server(extra + tier)
        _drain_checks(label, b, chat)
    finally:
        for srv in (a, b, r):
            if srv is not None and srv.http is not None:
                srv.close()

    c = _Server(extra + ["--max-num-seqs", "1", "--max-queue-len", "8",
                         "--shed-threshold", "0.5"])
    try:
        # Cold prefill of the resumed context, after a warm-up of the
        # same length on another prompt.
        n = len(desc["tokens"])
        body = {"max_tokens": 2, "temperature": 0, "ignore_eos": True,
                "stream": True}
        _timed_stream(c.url, "/v1/completions",
                      dict(body, prompt=_fleet_prompt(rng, vocab, n)))
        _, cold_ttft, _ = _timed_stream(
            c.url, "/v1/completions", dict(body, prompt=desc["tokens"]))
        _shed_checks(label, c, rng, vocab)
    finally:
        c.close()

    _preempt_checks(label, extra, small_pages, rng, vocab)
    log(f"{label}: resume under {rid}: "
        + ("the client's text byte-identical to server A's uninterrupted "
           "stream" if flip is None else
           f"A's and the client's greedy tokens part at output token "
           f"{flip[0]} (checkpoint at {desc['output_tokens']}), a near "
           f"tie of A's logits (margin {flip[1]:.4f})")
        + f"; server A shipped {a_stats['checkpoint_ships_total']:.0f} "
        f"checkpoints, {a_stats['checkpoint_kv_bytes_total']:.0f} B, a "
        f"page {nbytes} B of {wire}; B's tier hits "
        f"{stats['kv_offload_cluster_hits']:.0f}, restored pages equal to "
        f"the shipped bytes; the resume by recompute byte-identical to "
        f"the resume by restore; resume window launches {window}")
    log(f"{label}: checkpoint tick host ms a shipped page "
        f"{1e3 * ship['s'] / max(pages_shipped, 1):.3f} ({pages_shipped:.0f} "
        f"pages, {ship['bytes']} B); restore ms a page "
        f"{1e3 * rst['s'] / max(len(rst['pages']), 1):.3f} "
        f"({len(rst['pages'])} pages); resumed TTFT "
        f"{1e3 * resume_ttft:.1f} ms against a cold prefill of the same "
        f"{n}-token context {1e3 * cold_ttft:.1f} ms; {SMI}")
    return window


def _drain_checks(label, srv, chat):
    """A migrate drain cuts a stream at a checkpoint frame; new requests
    then answer 503 + Retry-After, /health shows draining and the build
    id, /version answers; a drain with exit stops the server."""
    import http.client
    host, port = srv.url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    conn.request("POST", "/v1/chat/completions", json.dumps(dict(
        chat, messages=[{"role": "user", "content": "drain me " * 40}])),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = b""
    while b": checkpoint " not in raw:
        chunk = resp.read1(65536)
        if not chunk:
            raise AssertionError(f"{label}: the stream ended before a "
                                 "checkpoint frame")
        raw += chunk
    with srv.engine._lock:  # no step commits while the drain lands
        status, _, _ = _http("POST", srv.url + "/drain", {"migrate": True})
    cut = False
    try:
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            raw += chunk
    except http.client.IncompleteRead as e:
        raw += e.partial
        cut = True
    conn.close()
    kinds = [k for k, _ in _sse_events(raw.decode())]
    if status != 200 or not cut or kinds[-2:] != ["ckpt", "migrating"]:
        raise AssertionError(f"{label}: the migrate drain did not cut the "
                             f"stream at a frame (cut {cut}, {kinds[-4:]})")
    status, _, headers = _http("POST", srv.url + "/v1/chat/completions",
                               dict(chat, stream=False))
    _, health, _ = _http("GET", srv.url + "/health")
    health = json.loads(health)
    version = _http("GET", srv.url + "/version")
    if (status != 503 or headers.get("Retry-After") != "1"
            or health["draining"] is not True
            or health["build_id"] != "chip-smoke" or version[0] != 200):
        raise AssertionError(f"{label}: after the drain: {status} "
                             f"{headers}, health {health}, version {version}")
    _http("POST", srv.url + "/drain", {"exit": True})
    srv.thread.join(timeout=60)
    if srv.thread.is_alive():
        raise AssertionError(f"{label}: the drained server did not exit")
    srv.http.server_close()
    srv.http = srv.app = srv.engine = None
    log(f"{label}: migrate drain cut the stream after its checkpoint frame; "
        f"503 + Retry-After, /health {health}, /version {version[1]}; the "
        "server exited once idle")


def _shed_checks(label, srv, rng, vocab):
    """With one row and a queue of 8 at threshold 0.5, a batch request is
    shed with 429 + Retry-After once 4 wait; an interactive one is
    admitted."""
    body = {"max_tokens": FLEET_OUT, "temperature": 0,
            "ignore_eos": True}
    inter = {"x-priority": "interactive"}
    pool = ThreadPoolExecutor(6)
    backlog = [pool.submit(_http, "POST", srv.url + "/v1/completions",
                           dict(body, prompt=_fleet_prompt(rng, vocab, 64)),
                           inter) for _ in range(6)]
    deadline = time.time() + 60
    while (srv.engine.scheduler.num_waiting < 4
           and time.time() < deadline):
        time.sleep(0.002)
    shed = _http("POST", srv.url + "/v1/completions",
                 dict(body, prompt=[300] * 8), {"x-priority": "batch"})
    admitted = _http("POST", srv.url + "/v1/completions",
                     dict(body, max_tokens=2, prompt=[301] * 8), inter)
    results = [f.result() for f in backlog]
    pool.shutdown()
    if (shed[0] != 429 or not shed[2].get("Retry-After")
            or admitted[0] != 200 or any(r[0] != 200 for r in results)):
        raise AssertionError(f"{label}: shed gate: batch {shed[:2]}, "
                             f"interactive {admitted[0]}, backlog "
                             f"{[r[0] for r in results]}")
    log(f"{label}: shed gate: batch answered {shed[0]} (Retry-After "
        f"{shed[2]['Retry-After']}), interactive admitted")


def _preempt_checks(label, extra, small_pages, rng, vocab) -> None:
    """16 greedy requests of PREEMPT_OUT tokens on a page budget that
    forces preemption, with preempt-to-offload, against the same on a
    roomy budget: each stream equal to the roomy one's, or parting at a
    near tie of the roomy engine (``check_stream``). The budget must
    preempt more than once, ship victims' pages, and bring a victim's
    pages back from the tier (its cached pages on the card reused in
    the meantime)."""
    prompts = [_fleet_prompt(rng, vocab, n) for n in PREEMPT_LENGTHS]
    bodies = [{"max_tokens": PREEMPT_OUT, "temperature": 0,
               "ignore_eos": True, "prompt": p} for p in prompts]
    originals = {tuple(p) for p in prompts}
    servers, victims = {}, []
    try:
        for budget in ("small", "roomy"):
            args = extra + (["--num-pages", str(small_pages),
                             "--enable-kv-offload", "--preempt-to-offload",
                             "on"] if budget == "small" else [])
            srv = servers[budget] = _Server(args)
            if budget == "small":
                restore = srv.engine.scheduler.restore_hook

                def counted(prompt_ids, matched, salt=0):
                    pages = restore(prompt_ids, matched, salt)
                    if pages and tuple(prompt_ids) not in originals:
                        victims.append(len(pages))  # a folded prompt
                    return pages

                srv.engine.scheduler.restore_hook = counted
            with ThreadPoolExecutor(len(bodies)) as pool:
                list(pool.map(lambda b: _post(srv.url + "/v1/completions",
                                              b), bodies))
            srv.stop()
            if budget == "small":
                metrics = srv.app.metrics()
                offloaded = float(re.search(
                    r'^vllm:preempt_offload_total\{outcome="offloaded"\} '
                    r'(\S+)', metrics, re.M).group(1))
                preemptions = srv.engine.scheduler.num_preemptions
                restored = srv.engine.stats()["kv_offload_restored_pages"]
                srv.close()
        flips = [check_stream(label, f"preempt-to-offload row {i}",
                              servers["roomy"].engine, p,
                              servers["roomy"].tokens_after(p),
                              servers["small"].tokens_after(p))
                 for i, p in enumerate(prompts)]
    finally:
        for srv in servers.values():
            if srv.http is not None:
                srv.close()
    parted = [(i, f) for i, f in enumerate(flips) if f is not None]
    log(f"{label}: preempt-to-offload at {small_pages} pages: "
        f"{preemptions} preemptions, {offloaded:.0f} offloaded, "
        f"{restored:.0f} pages restored, {len(victims)} victims restored "
        f"from the tier ({sum(victims)} pages); "
        f"{len(prompts) - len(parted)}/{len(prompts)} streams "
        f"byte-identical to the roomy budget's, the others parting at near "
        f"ties (row, token, margin): "
        f"{[(i, f[0], round(f[1], 4)) for i, f in parted]}")
    if not (preemptions > 1 and offloaded > 0 and restored > 0 and victims):
        raise AssertionError(
            f"{label}: preempt-to-offload did no real work: {preemptions} "
            f"preemptions, {offloaded} offloaded, {restored} pages "
            f"restored, {len(victims)} victims restored")


# ---- disagg phase -------------------------------------------------------------

# (label, server args beyond SERVER_ARGS, bytes of one page on the wire,
# the launch-counter suffix of its kernels): the fleet phase's two
# forms.
DISAGG_RUNS = tuple((label.replace("fleet", "disagg"), extra, page_bytes,
                     form) for label, extra, page_bytes, _, form, _
                    in FLEET_RUNS)
# The disagg phase's decode-role handoff windows (bf16 per_layer, int8
# stacked).
DISAGG_RUN = "disagg_handoff"
DISAGG_INT8_RUN = "disagg_handoff_int8_stacked"


def _fleet_chat(seed=9):
    """The fleet phase's greedy chat (FLEET_PROMPT_CHARS of content, 705
    prompt tokens with the chat template), not streamed."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz ,."))
    content = "".join(rng.choice(letters, size=FLEET_PROMPT_CHARS))
    return {"max_tokens": FLEET_OUT, "temperature": 0, "ignore_eos": True,
            "messages": [{"role": "user", "content": content}]}


def _metric_value(url, name) -> float:
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    return float(re.search("^" + re.escape(name) + r" (\S+)$", text,
                           re.M).group(1))


def disagg_phase(vocab: int) -> dict:
    """Disaggregated prefill and decode at full width; see the module
    docstring (phase 15). Returns each form's decode-role launches in
    its handoff window."""
    from production_stack_tpu_torch.engine.cache_server import (
        build_cache_server)
    launches = {}
    for run in DISAGG_RUNS:
        cache = build_cache_server(8 * 1024 ** 3)
        threading.Thread(target=cache.serve_forever, daemon=True).start()
        try:
            launches[run[0]] = _disagg_run(run, cache, vocab)
        finally:
            cache.shutdown()
            cache.server_close()
    return launches


def _disagg_run(run, cache, vocab) -> dict:
    from production_stack_tpu_torch.engine.offload import (
        _stable_key, unpackb)
    from production_stack_tpu_torch.engine.tokenizer import (
        render_chat_prompt)
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    label, extra, page_bytes, form = run
    chat, other = _fleet_chat(9), _fleet_chat(10)
    tier = ["--kv-remote-url", cache.url, "--kv-host-pool-bytes", "0"]
    mono = pre = dec = None
    try:
        mono = _Server(extra)
        pre = _Server(extra + tier + ["--engine-role", "prefill"])
        dec = _Server(extra + tier + ["--engine-role", "decode"])
        prompt = render_chat_prompt(mono.engine.tokenizer, chat["messages"])
        health = _get_json(pre.url + "/health")
        if health["role"] != "prefill" or _get_json(
                dec.url + "/health")["role"] != "decode":
            raise AssertionError(f"{label}: /health roles {health}")
        if dec.engine.config.scheduler.unified_step:
            raise AssertionError(f"{label}: unified step on a role engine")

        # The monolithic reference, after a warm-up of the same shapes
        # on another chat.
        _post(mono.url + "/v1/chat/completions", other)
        _, mono_ttft, _ = _timed_stream(mono.url, "/v1/chat/completions",
                                        dict(chat, stream=True))

        # The prefill engine's ship, timed a page.
        ship_fn, ship = pre.engine._ship_handoff, {"s": 0.0, "pages": 0}

        def timed_ship(seq):
            t0 = time.perf_counter()
            ship_fn(seq)
            ship["s"] += time.perf_counter() - t0
            ship["pages"] += pre.engine._handoff_info[seq.seq_id][
                "num_pages"]

        pre.engine._ship_handoff = timed_ship
        restore_fn, restored = dec.engine._restore_offloaded_prefix, []

        def recorded_restore(*args):
            pages = restore_fn(*args)
            restored.extend(pages)
            return pages

        dec.engine.scheduler.restore_hook = recorded_restore
        # Warm-up of both hops' shapes (the prefill chunks, the decode
        # side's tail chunk and decode steps) on the other chat.
        warm = _post(pre.url + "/v1/disagg/prefill", other)["descriptor"]
        _post(dec.url + "/v1/disagg/handoff", {"descriptor": warm})
        shipped0 = _metric_value(pre.url,
                                 "vllm:disagg_kv_bytes_shipped_total")
        latency0 = _metric_value(
            dec.url, "vllm:disagg_handoff_latency_seconds_sum")
        restored.clear()
        captured = dict(dec.engine.runner.graphs.captures)

        # The two hops, as the router makes them.
        t0 = time.perf_counter()
        desc = _post(pre.url + "/v1/disagg/prefill", chat)["descriptor"]
        hop1 = time.perf_counter() - t0
        torch.cuda.synchronize()
        COUNTERS.reset()
        raw, hop2_ttft, _ = _timed_stream(dec.url, "/v1/disagg/handoff",
                                          {"descriptor": desc,
                                           "stream": True})
        torch.cuda.synchronize()
        window = dict(COUNTERS.launches)
        two_hop_ttft = hop1 + hop2_ttft
        shipped = _metric_value(
            pre.url, "vllm:disagg_kv_bytes_shipped_total") - shipped0
        latency = _metric_value(
            dec.url, "vllm:disagg_handoff_latency_seconds_sum") - latency0
        pages = len(prompt) // 128
        if not (desc["token_ids"] == prompt and desc["num_pages"] == pages
                and desc["kv_bytes"] == pages * page_bytes
                and shipped == pages * page_bytes
                and len(desc["page_keys"]) == pages):
            raise AssertionError(
                f"{label}: descriptor of {len(desc['token_ids'])} tokens, "
                f"{desc['num_pages']} pages, {desc['kv_bytes']} B; "
                f"/metrics shipped {shipped} B; expected {pages} pages of "
                f"{page_bytes} B")
        if len(restored) != pages:
            raise AssertionError(f"{label}: {len(restored)} pages "
                                 f"restored, expected {pages}")
        for page_id in restored:
            page_hash = dec.engine.cache_manager._pages[page_id].page_hash
            key = _stable_key(page_hash,
                              "int8" if dec.engine.runner.kv_quantized
                              else "bfloat16")
            frame = unpackb(cache.store._blobs[key])
            if [bytes(x["data"]) for x in frame["arrays"]] != [
                    t.contiguous().view(torch.uint8).numpy().tobytes()
                    for t in dec.engine.runner.read_page(page_id)]:
                raise AssertionError(f"{label}: restored page {page_id} "
                                     "differs from the shipped bytes")
        if (window.get("paged_prefill" + form, 0) <= 0
                or window.get("paged_decode" + form, 0) <= 0
                or any(n for k, n in window.items()
                       if k.startswith("paged_ragged"))):
            raise AssertionError(f"{label}: the decode-role window "
                                 f"launched {window}, expected prefill "
                                 "(the tail) and decode, no ragged step")
        if any(COUNTERS.plain_cuda_calls.values()):
            raise AssertionError(f"{label}: plain versions ran on CUDA "
                                 f"tensors: {dict(COUNTERS.plain_cuda_calls)}")
        if dec.engine.runner.graphs.captures != captured:
            # The tail's chunk takes a prefill bucket the warm-up
            # captured: no graph is captured a handoff.
            raise AssertionError(f"{label}: the handoff captured graphs: "
                                 f"{captured} -> "
                                 f"{dec.engine.runner.graphs.captures}")
        if not raw.rstrip().endswith("data: [DONE]"):
            raise AssertionError(f"{label}: the handoff stream did not end")

        # A handoff whose pages the tier never held: a recompute.
        missing = _fleet_chat(11)
        _post(mono.url + "/v1/chat/completions", missing)
        missing_prompt = render_chat_prompt(mono.engine.tokenizer,
                                            missing["messages"])
        mono_missing = mono.tokens_after(missing_prompt)
        restored.clear()
        miss_desc = dict(desc, token_ids=missing_prompt,
                         first_token=mono_missing[0], page_keys=[],
                         num_pages=0, kv_bytes=0)
        miss_ans = _post(dec.url + "/v1/disagg/handoff",
                         {"descriptor": miss_desc})
        if restored or miss_ans["usage"]["completion_tokens"] != FLEET_OUT:
            raise AssertionError(f"{label}: the missing-page handoff "
                                 f"restored {restored}: {miss_ans['usage']}")
        for srv in (mono, pre, dec):
            srv.stop()
        mono_ids = mono.tokens_after(prompt)
        got_ids = dec.tokens_after(prompt)
        if got_ids[0] != mono_ids[0] or desc["first_token"] != mono_ids[0]:
            raise AssertionError(f"{label}: first token {got_ids[0]}, the "
                                 f"monolithic server's {mono_ids[0]}")
        flip = check_stream(label, "two-hop stream", mono.engine, prompt,
                            mono_ids, got_ids)
        miss_flip = check_stream(label, "recomputed handoff", mono.engine,
                                 missing_prompt, mono_missing,
                                 dec.tokens_after(missing_prompt))
    finally:
        for srv in (mono, pre, dec):
            if srv is not None and srv.http is not None:
                srv.close()

    def told(f):
        return ("byte-identical to the monolithic stream" if f is None else
                f"parting from the monolithic stream at output token "
                f"{f[0]}, a near tie (margin {f[1]:.4f})")

    log(f"{label}: {len(prompt)}-token chat, descriptor of {pages} pages, "
        f"{shipped:.0f} B shipped ({page_bytes} B a page), restored pages "
        f"equal to the shipped bytes; the two-hop stream "
        f"{told(flip)}; the missing-page handoff recomputed, "
        f"{told(miss_flip)}; decode-role window launches {window}, no "
        f"graph captured (captures {captured})")
    log(f"{label}: two-hop TTFT {1e3 * two_hop_ttft:.1f} ms (prefill hop "
        f"{1e3 * hop1:.1f}, handoff hop to its first frame "
        f"{1e3 * hop2_ttft:.1f}) against the monolithic TTFT "
        f"{1e3 * mono_ttft:.1f} ms; vllm:disagg_handoff_latency_seconds "
        f"sum {latency:.6f} s; host ms a shipped page "
        f"{1e3 * ship['s'] / max(ship['pages'], 1):.3f} ({ship['pages']} "
        f"pages shipped in the phase, the warm-up's included); {SMI}")
    return window


# ---- autotune and the pooled routes -----------------------------------------


AUTOTUNE_RUN = "serve_autotune"  # the ``on`` server's window
# The phase's servers: spec decoding on prompts that draft, the unified
# step on, and no prefix cache, so the warm-up pass and the window run
# the same steps.
AUTOTUNE_ARGS = ["--speculative-k", "4", "--unified-step", "on",
                 "--disable-prefix-caching"]
# The ``shadow`` and ``on`` servers tick every 50 ms toward an ITL
# target no decode step meets, so the prefill budget shrinks (in
# ``on``; ``shadow`` only logs the decisions).
AUTOTUNE_TICK_ARGS = ["--autotune-interval-s", "0.05",
                      "--autotune-target-itl-ms", "1"]
AUTOTUNE_OUT = 32
EMBED_LENGTHS = np.linspace(64, 1024, 8).round().astype(int)


def _autotune_prompts(vocab):
    """16 greedy prompts of 150..500 tokens that draft: 4 repeat a block
    of 8..14 tokens (the model tends to continue the loop: drafts
    accepted), 12 are random with their last two tokens also earlier
    in the prompt (the proposer drafts that occurrence's continuation,
    which the model seldom takes: drafts rejected)."""
    rng = np.random.RandomState(21)
    prompts = []
    for i in range(16):
        n = 500 - 23 * i
        if i % 4 == 0:
            block = rng.randint(258, vocab, size=8 + i // 2).tolist()
            prompts.append((block * (n // len(block) + 1))[:n])
        else:
            prompt = rng.randint(258, vocab, size=n).tolist()
            at = int(rng.randint(10, n // 2))
            prompts.append(prompt[:-2] + prompt[at:at + 2])
    return prompts


def _graph_lattice(runner) -> set:
    """(kind, shape) of every key the step graphs may capture at this
    configuration: prefill steps at [prefill rows, T bucket], decode at
    [rows, 1], verify at [rows, K + 1], unified at [row bucket,
    max(T bucket, K + 1)]."""
    span = runner.unified_span
    return ({("step", (runner.prefill_width, t)) for t in runner._buckets}
            | {("step", (runner.decode_width, 1)),
               ("spec_verify", (runner.decode_width, runner.spec_width))}
            | {("unified", (r, max(w, span)))
               for r in runner.unified_row_buckets for w in runner._buckets})


def _gated_streams(srv, prompts, max_tokens=None, models=None):
    """Stream one greedy completion of ``max_tokens`` (AUTOTUNE_OUT) a
    prompt, each under its ``models`` name if given, with the engine
    loop held until all are queued, in this order, so every server
    admits the same rows before its first step; returns (texts, seconds
    from the release to the last frame)."""
    import http.client
    gate, held = threading.Event(), threading.Event()
    while not srv.app.loop._thread.is_alive():
        time.sleep(0.01)  # a call before the loop runs would not hold it

    def hold():
        held.set()
        gate.wait()

    holder = threading.Thread(target=lambda: srv.app.loop.call(hold),
                              daemon=True)
    holder.start()
    held.wait()
    host, port = srv.url.split("//")[1].split(":")
    conns = []
    try:
        for i, prompt in enumerate(prompts):
            body = {"prompt": prompt,
                    "max_tokens": max_tokens or AUTOTUNE_OUT,
                    "temperature": 0.0, "ignore_eos": True, "stream": True}
            if models is not None:
                body["model"] = models[i]
            conn = http.client.HTTPConnection(host, int(port), timeout=300)
            conn.request("POST", "/v1/completions", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()  # the headers: the request is queued
            if resp.status != 200:
                raise AssertionError(f"autotune: {resp.status} "
                                     f"{resp.read()}")
            conns.append((conn, resp))
    finally:
        t0 = time.perf_counter()
        gate.set()
        holder.join()
    with ThreadPoolExecutor(len(conns)) as pool:
        raws = list(pool.map(lambda c: c[1].read().decode(), conns))
    wall = time.perf_counter() - t0
    for conn, _ in conns:
        conn.close()
    return [_text(_sse_events(raw)) for raw in raws], wall


def _autotune_run(mode, prompts) -> dict:
    """One server of the phase: a warm-up pass, then the counted window
    (the same prompts; counters and captures read around it)."""
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    args = AUTOTUNE_ARGS + ["--autotune", mode] + (
        AUTOTUNE_TICK_ARGS if mode != "off" else [])
    srv = _Server(args)
    tuner, runner = srv.app.autotuner, srv.engine.runner
    graphs, obs = runner.graphs, runner.observatory
    # Each tick's host µs, knob values and the observatory's step-time
    # medians (the drift guardrail's input).
    ticks = []
    tick = tuner.tick

    def timed_tick(now=None):
        t0 = time.perf_counter()
        tick(now)
        ticks.append(((time.perf_counter() - t0) * 1e6,
                      tuner.knob_values(), obs.step_time_medians()))

    tuner.tick = timed_tick
    warm_texts, warm_wall = _gated_streams(srv, prompts)
    torch.cuda.synchronize()
    before = dict(graphs.captures)
    srv.finished.clear()
    COUNTERS.reset()
    texts, wall = _gated_streams(srv, prompts)
    torch.cuda.synchronize()
    run = {"mode": mode, "srv": srv, "texts": texts, "wall": wall,
           "warm_texts": warm_texts, "warm_wall": warm_wall,
           "launches": dict(COUNTERS.launches),
           "plain": dict(COUNTERS.plain_cuda_calls),
           "before": before, "after": dict(graphs.captures),
           "keys": graphs.keys(), "ticks": ticks,
           "status": json.loads(_http("GET", srv.url
                                      + "/autotune/status")[1]),
           "ids": [srv.tokens_after(p) for p in prompts]}
    lattice = _graph_lattice(runner)
    outside = [k for k in run["keys"] if (k[0], k[1]) not in lattice]
    if outside or sum(run["after"].values()) != len(run["keys"]):
        raise AssertionError(f"autotune {mode}: keys outside the lattice "
                             f"{outside}, or a key captured twice "
                             f"(captures {run['after']}, "
                             f"{len(run['keys'])} keys)")
    for kernel in KERNELS:
        if run["launches"].get(kernel, 0) <= 0:
            raise AssertionError(f"autotune {mode}: the window never "
                                 f"launched {kernel}")
    if run["plain"] or any(graphs.eager_steps.values()):
        raise AssertionError(f"autotune {mode}: plain calls on CUDA "
                             f"{run['plain']} or eager steps "
                             f"{graphs.eager_steps}")
    tokens = len(prompts) * AUTOTUNE_OUT
    log(f"autotune {mode}: {tokens} tokens in {wall:.3f} s "
        f"({tokens / wall:.1f} tok/s; warm-up pass {tokens / warm_wall:.1f}"
        f" tok/s); captures by kind before the window {before}, after "
        f"{run['after']} ({len(run['keys'])} keys, all in the lattice of "
        f"{len(lattice)}); launches {run['launches']}; "
        f"decisions {tuner.decisions_total}, applied {tuner.applied_total}")
    return run


def _trajectory(ticks, name):
    """The knob's values over the ticks, repeats folded."""
    out = []
    for _, knobs, _ in ticks:
        value = knobs.get(name)
        if value is not None and (not out or out[-1] != value):
            out.append(round(value, 4))
    return out


def _drift_report(ticks, band=0.25):
    """The guardrail's baseline (the first non-zero step-time median of
    each kind at a tick) and the kinds whose median later passed it by
    ``band`` (observatory_drift_flags' rule)."""
    baseline, tripped = {}, set()
    for _, _, medians in ticks:
        for kind, median in medians.items():
            if median <= 0:
                continue
            base = baseline.setdefault(kind, median)
            if median > base * (1.0 + band):
                tripped.add(kind)
    return baseline, sorted(tripped)


def autotune_phase(vocab: int) -> dict:
    """Self-tuning and the pooled routes at full width; see the module
    docstring (phase 16). Returns the ``on`` server's window launches."""
    prompts = _autotune_prompts(vocab)
    runs = {}
    try:
        for mode in ("off", "shadow", "on"):
            runs[mode] = _autotune_run(mode, prompts)
            if mode == "on":
                # The pooled routes on the serving ``on`` server.
                _embedding_checks(runs[mode]["srv"], vocab)
            runs[mode]["srv"].stop()
        off, shadow, on = runs["off"], runs["shadow"], runs["on"]
        if (shadow["texts"], shadow["warm_texts"]) != (off["texts"],
                                                        off["warm_texts"]):
            raise AssertionError("autotune: shadow streams differ from off")
        shadow_tuner = shadow["srv"].app.autotuner
        if (sum(shadow_tuner.applied_total.values())
                or not sum(shadow_tuner.decisions_total.values())):
            raise AssertionError(f"autotune shadow: applied "
                                 f"{shadow_tuner.applied_total}, decisions "
                                 f"{shadow_tuner.decisions_total}")
        if _trajectory(shadow["ticks"], "spec_k") != [4.0] or _trajectory(
                shadow["ticks"], "prefill_budget") != [4096.0]:
            raise AssertionError("autotune shadow: a knob moved")
        applied = on["srv"].app.autotuner.applied_total
        if applied.get("spec_k", 0) < 1 or applied.get("prefill_budget",
                                                       0) < 1:
            raise AssertionError(f"autotune on: applied {applied}")
        flips = []
        for prompt, ref, got in zip(prompts, off["ids"], on["ids"]):
            flip = check_stream("autotune on", "a greedy stream",
                                off["srv"].engine, prompt, ref, got)
            if flip is not None:
                flips.append(flip)
        log(f"autotune on: {len(prompts) - len(flips)}/{len(prompts)} "
            f"greedy streams byte-identical to off, the others part at "
            f"near ties (index, margin) {flips}")
        for run in runs.values():
            us = [t[0] for t in run["ticks"]]
            baseline, tripped = _drift_report(run["ticks"])
            log(f"autotune {run['mode']}: {len(us)} ticks, host us a tick "
                f"median {np.median(us) if us else 0:.1f} max "
                f"{max(us, default=0):.1f}; spec_k "
                f"{_trajectory(run['ticks'], 'spec_k')}, prefill_budget "
                f"{_trajectory(run['ticks'], 'prefill_budget')}; drift "
                f"baseline (s) {baseline}, kinds past it by 25% {tripped}, "
                f"frozen {run['srv'].app.autotuner.frozen_flags()}")
        log(f"autotune on: /autotune/status {json.dumps(on['status'])}; "
            f"{SMI}")
        return on["launches"]
    finally:
        for run in runs.values():
            run["srv"].close()


def _embedding_checks(srv, vocab) -> None:
    """/v1/embeddings, /v1/score and /v1/rerank on the ``on`` server,
    its loop still serving."""
    from production_stack_tpu_torch.engine.config import ModelConfig
    from production_stack_tpu_torch.engine.embeddings import Embedder
    rng = np.random.RandomState(31)
    inputs = [rng.randint(258, vocab, size=n).tolist()
              for n in EMBED_LENGTHS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        status, text, _ = _http("POST", srv.url + "/v1/embeddings",
                                {"input": inputs})
        ms.append((time.perf_counter() - t0) * 1e3)
        if status != 200:
            raise AssertionError(f"embeddings: {status} {text}")
    peak = torch.cuda.max_memory_allocated() - held
    vecs = np.asarray([d["embedding"] for d in json.loads(text)["data"]])
    norms = np.linalg.norm(vecs, axis=-1)
    hidden = srv.engine.config.model.hidden_size
    if vecs.shape != (8, hidden) or np.abs(norms - 1).max() > 1e-4:
        raise AssertionError(f"embeddings: shape {vecs.shape}, norms "
                             f"{norms}")
    alone = np.asarray(json.loads(_http("POST", srv.url + "/v1/embeddings",
                                        {"input": inputs[:1]})[1])
                       ["data"][0]["embedding"])
    pad_cos = float(alone @ vecs[0])
    if pad_cos < 0.999:
        raise AssertionError(f"embeddings: the 64-token input alone and "
                             f"padded to 1024 agree to a cosine of {pad_cos}")
    # The plain reference: the same encode with f32 weights on the card.
    cfg = ModelConfig(**{**srv.engine.config.model.__dict__,
                         "dtype": "float32"})
    params = srv.engine.runner.params
    ref_params = type(params)(cfg, srv.engine.runner.device)
    ref_params.load_state_dict({k: v.float() for k, v in
                                params.state_dict().items()})
    ref = Embedder(cfg, ref_params, max_len=1024).embed_batch(inputs)
    del ref_params
    cos = (vecs * ref).sum(-1) / np.linalg.norm(ref, axis=-1)
    if cos.min() < 0.999:
        raise AssertionError(f"embeddings: cosine to the f32 reference "
                             f"{cos}")
    texts = ["alpha beta gamma", "alpha beta", "zzz unrelated", "gamma"]
    emb = json.loads(_http("POST", srv.url + "/v1/embeddings",
                           {"input": texts})[1])
    tv = np.asarray([d["embedding"] for d in emb["data"]])
    want = tv[1:] @ tv[0]
    score = json.loads(_http("POST", srv.url + "/v1/score",
                             {"text_1": texts[0], "text_2": texts[1:]})[1])
    got = np.asarray([d["score"] for d in score["data"]])
    rerank = json.loads(_http("POST", srv.url + "/v1/rerank",
                              {"query": texts[0],
                               "documents": texts[1:]})[1])
    order = [r["index"] for r in rerank["results"]]
    if (np.abs(got - want).max() > 1e-4
            or order != list(np.argsort(-want, kind="stable"))):
        raise AssertionError(f"score {got} / rerank {order} against the "
                             f"vectors' cosines {want}")
    eager = _metric_value(srv.url, 'vllm:engine_eager_steps_total'
                                   '{reason="embed"}')
    if eager != 3 + 1 + 1 + 1 + 1:  # 3 batches, alone, texts, score, rerank
        raise AssertionError(f"embeddings: {eager} embed eager steps")
    log(f"embeddings: 8 inputs of {EMBED_LENGTHS[0]}..{EMBED_LENGTHS[-1]} "
        f"tokens, one chunk of [8, 1024], ms a batch "
        f"{[round(x, 3) for x in ms]}; peak allocated above the server's "
        f"{peak / 2**30:.3f} GiB (graph pool "
        f"{srv.engine.runner.graphs.pool_bytes() / 2**30:.3f} GiB); unit "
        f"norms to {np.abs(norms - 1).max():.2e}; padding cosine "
        f"{pad_cos:.6f}; cosine to the f32 encode min {cos.min():.6f}; "
        f"score and rerank equal the vectors' cosines; {eager:.0f} embed "
        f"eager steps; {SMI}")


# ---- weights phase ------------------------------------------------------------

# The int8-weight GEMM's entry on the ``kernels`` line: the XLA product
# it stands for (the JAX package's dequantizing matmul is no Pallas
# kernel) and its run, the int8-weight server's counted window.
W8_KERNEL = dict(
    route="cuda",
    source="production_stack_tpu_torch/csrc/int8_weight_gemm.cu",
    replaces="production_stack_tpu/engine/quantization.py:58")
WEIGHTS_RUN = "serve_int8_weights"
LORA_RUN = "serve_lora"
# bench-1b's four projections as (K, N): qkv, o, gate_up, down.
PROJECTIONS = {"qkv": (2048, 3072), "o": (2048, 2048),
               "gate_up": (2048, 11264), "down": (5632, 2048)}
# The kernel's headline case: the gate_up product of a decode step.
W8_HEADLINE = ("gate_up", 32)
WEIGHTS_OUT = 32
WEIGHTS_ARGS = ["--disable-prefix-caching"]
LORA_RANK = 16
# tok/s of the first serving run (bf16 KV), set by serving_phase.
SERVE_TOK_S = None


# The kernel build's compiler output, a source at a time (main fills it).
PTXAS_LOG = []


def _w8_ptxas_report() -> None:
    """Log the int8-weight GEMM's wgmma instances from the build's
    ``-Xptxas -v`` output: registers and spills each, and every warning
    that ptxas serialized their wgmma (C75xx)."""
    text = next((t for t in PTXAS_LOG
                 if t.startswith("nvcc int8_weight_gemm.cu")), "")
    log(text.splitlines()[0] if text else "weights: no build output of "
        "int8_weight_gemm.cu (the library was built earlier)")
    entry, serialized = None, []
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and "w8_wgmma_kernel" in entry and (
                "registers" in line or "spill" in line):
            log(f"weights ptxas {entry}: {line.strip()}")
        if "(C75" in line and "w8_wgmma_kernel" in line:
            serialized.append(line.strip())
    log(f"weights ptxas: {len(serialized)} wgmma serialization warnings "
        f"for the GEMM's instances" + "".join(
            "\n  " + line for line in serialized))


def _w8_bound(m, k, n) -> dict:
    """Weight bytes read once (int8 values, f32 scales), activations
    read once and the output written once, against 2 m n k bf16
    tensor-core operations."""
    return _bound(n * k + 4 * n + 2 * m * k + 2 * m * n, 2 * m * n * k)


def _w8_kernel_cases(dev) -> dict:
    """``int8_weight_matmul`` against its plain version at the four
    projections for M = 1, 8, 32, 64, 160 and the threshold (bf16), and
    one f32 tiny-llama case; two launches must give equal bits. Each
    case's plan is logged, with the clusters of its shape the card runs
    at once (``pstt_int8_weight_active_clusters``, at least the plan's
    tiles: one wave). At M = 1, 8, 32, 64, 160 and the
    threshold it is timed beside bf16 ``torch.matmul`` on the
    dequantized weight (``library_ms``, the yardstick), the plain torch
    form the engine takes above the threshold (``dequant_ms``) and the
    plain version (``plain_ms``). Returns the headline case."""
    from production_stack_tpu_torch.engine.quantization import (
        dequant_matmul)
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        INT8_KERNEL_MAX_ROWS, MAX_ACTIVE_CLUSTERS, int8_weight_matmul,
        int8_weight_matmul_plain, int8_weight_plan)
    from production_stack_tpu_torch.ops.paged_kv_common import (
        dtype_code, kernel_lib)
    _w8_ptxas_report()
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows = sorted({1, 8, 32, 64, 160, INT8_KERNEL_MAX_ROWS})
    timed = set(rows)
    cases = []
    timer = None  # made just before the first timed case (clocks warm)

    def check(name, x, q, scale, tol):
        got = int8_weight_matmul(x, q, scale)
        again = int8_weight_matmul(x, q, scale)
        want = int8_weight_matmul_plain(x, q, scale)
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), want.float(), **tol):
            raise AssertionError(f"{name}: kernel and plain version "
                                 "disagree")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches gave other bits")
        return (got.float() - want.float()).abs().max().item()

    for proj, (k, n) in PROJECTIONS.items():
        q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = (torch.rand((n,), generator=gen, device=dev) + 0.5) * (
            0.02 / 127)
        dense = (q.float() * scale[:, None]).to(torch.bfloat16)
        for m in rows:
            if m > INT8_KERNEL_MAX_ROWS:
                continue
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            case = f"int8_weight_matmul bf16 {proj} M={m} K={k} N={n}"
            plan = int8_weight_plan(m, n, k, torch.bfloat16)
            active = kernel_lib().pstt_int8_weight_active_clusters(
                dtype_code(torch.bfloat16), plan["bucket"],
                plan["warpgroups"], plan["cluster"], plan["smem"])
            if active < plan["tiles"]:
                raise AssertionError(f"{case}: the card runs {active} "
                                     f"clusters at once, the plan {plan} "
                                     "needs a second wave")
            r = {"case": case, "proj": proj, "m": m, "plan": plan,
                 "active_clusters": active,
                 "table_clusters": MAX_ACTIVE_CLUSTERS[plan["cluster"]],
                 "max_abs_err": check(case, x, q, scale, BF16_TOL)}
            if m in timed:
                timer = timer or Timer(dev)
                r["ms"] = timer.ms(lambda: int8_weight_matmul(x, q, scale))
                r["library_ms"] = timer.ms(lambda: torch.matmul(x, dense.t()))
                r["dequant_ms"] = timer.ms(lambda: dequant_matmul(x, q, scale))
                r["plain_ms"] = timer.ms(
                    lambda: int8_weight_matmul_plain(x, q, scale))
                r.update(_w8_bound(m, k, n))
                r["bound_share"] = r["bound_ms"] / r["ms"]
            log("weights kernel case " + json.dumps(r))
            cases.append(r)
        del q, dense
    # The tiny llama's f32 geometry (hidden 128, ffn 256): the FMA form.
    xq = torch.randn((24, 256), generator=gen, device=dev)
    q = torch.randint(-127, 128, (128, 256), generator=gen, device=dev,
                      dtype=torch.int8)
    scale = torch.rand((128,), generator=gen, device=dev) * (0.04 / 127)
    err = check("int8_weight_matmul f32 tiny down M=24", xq, q, scale,
                F32_TOL)
    log(f"weights kernel case f32 tiny down M=24 K=256 N=128: max abs err "
        f"{err:.3e} (tolerance 1e-4)")
    for m in sorted(timed):
        line = [c for c in cases if c["m"] == m]
        log(f"weights kernel M={m}: " + "; ".join(
            f"{c['proj']} {c['ms']:.5f} ms (bf16 matmul {c['library_ms']:.5f}"
            f", dequantize-then-matmul {c['dequant_ms']:.5f}, bound "
            f"{c['bound_ms']:.5f} by {c['bound_by']}, "
            f"{100 * c['bound_share']:.1f}% of it)" for c in line)
            + f"; {SMI}")
    head = next(c for c in cases
                if (c["proj"], c["m"]) == W8_HEADLINE)
    head = dict(head, max_abs_err=max(max(c["max_abs_err"] for c in cases),
                                      err))
    return head


def _w8_model_check(dev) -> None:
    """bench-1b with random int8 weights through ``forward``: the
    kernels (attention and int8-weight) against their plain versions
    (``plain_bf16p`` attention, the int8 product's plain version) at
    the model phase's three step kinds; prefill (512 rows) takes the
    dequantize-then-matmul form on both sides, decode (1 row) and verify
    (5 rows) the kernel."""
    from production_stack_tpu_torch.engine import quantization
    from production_stack_tpu_torch.engine.config import (
        bench_1b_model_config)
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        int8_weight_matmul_plain)
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    cfg = bench_1b_model_config()
    cfg.quantization = "int8"
    params = quantization.init_random_quantized(cfg, 0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size, (1, 512 + 6), generator=gen,
                           device=dev, dtype=torch.int32)
    COUNTERS.reset()
    cuda = _forwards(dev, cfg, params, tokens,
                     _model_caches(dev, cfg, "bf16", "per_layer"), "cuda")
    launched = COUNTERS.launches.get("int8_weight_matmul", 0)
    expected = 2 * 4 * cfg.num_hidden_layers  # decode and verify
    if launched != expected:
        raise AssertionError(f"weights model: {launched} int8-weight "
                             f"launches, expected {expected}")
    kernel = quantization.int8_weight_matmul
    quantization.int8_weight_matmul = int8_weight_matmul_plain
    try:
        plain = _forwards(dev, cfg, params, tokens,
                          _model_caches(dev, cfg, "bf16", "per_layer"),
                          "plain_bf16p")
    finally:
        quantization.int8_weight_matmul = kernel
    for phase, a, b in zip(PHASES, cuda, plain):
        c = compare_logits(a, b)
        log(f"weights model bench-1b int8 {phase}: finite {c['finite']}, "
            f"max |cuda - plain| {c['diff']:.3e} (max |logit| "
            f"{c['scale']:.3e}), {c['flips']} flips of {c['positions']}, "
            f"margins {[f'{m:.3e}' for m in c['margins']]}")
        if not c["ok"]:
            raise AssertionError(f"weights model {phase}: the kernels' and "
                                 "the plain versions' logits disagree")
    del params
    torch.cuda.empty_cache()


def _write_peft_adapter(path, cfg, seed) -> None:
    """A rank-LORA_RANK PEFT adapter over all seven llama targets: A ~
    N(0, 0.02), B ~ N(0, 0.2), lora_alpha = r, in a safetensors file of
    BF16 tensors written here (a u64 header length, the JSON header,
    the raw little-endian data)."""
    rng = np.random.default_rng(seed)
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    q_out = cfg.num_attention_heads * cfg.head_dim
    kv_out = cfg.num_key_value_heads * cfg.head_dim
    projs = (("self_attn.q_proj", h, q_out), ("self_attn.k_proj", h, kv_out),
             ("self_attn.v_proj", h, kv_out), ("self_attn.o_proj", q_out, h),
             ("mlp.gate_proj", h, ffn), ("mlp.up_proj", h, ffn),
             ("mlp.down_proj", ffn, h))
    header, blobs, offset = {}, [], 0
    for i in range(cfg.num_hidden_layers):
        for proj, d_in, d_out in projs:
            for kind, shape, sd in (("A", (LORA_RANK, d_in), 0.02),
                                    ("B", (d_out, LORA_RANK), 0.2)):
                x = (sd * rng.standard_normal(shape, dtype=np.float32))
                bits = (x.view(np.uint32) >> 16).astype("<u2").tobytes()
                name = (f"base_model.model.model.layers.{i}.{proj}"
                        f".lora_{kind}.weight")
                header[name] = {"dtype": "BF16", "shape": list(shape),
                                "data_offsets": [offset,
                                                 offset + len(bits)]}
                blobs.append(bits)
                offset += len(bits)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_model.safetensors"), "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for b in blobs:
            f.write(b)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": LORA_RANK, "lora_alpha": LORA_RANK,
                   "target_modules": [p.split(".")[1] for p, _, _ in projs]},
                  f)


def _weights_window(label, srv, prompts, models=None, form="",
                    alone=True) -> dict:
    """The 16 greedy requests submitted together (the engine loop held
    until all are queued), once as a warm-up (the graphs' captures),
    then counted: the counters set to 0 just before and read just
    after; then (``alone``) each request alone on the same server. Checks the
    window's launches (of each kernel's ``form``: "" per-layer at the
    model's dtype, "_int8" over an int8 cache) and graphs; stops the
    server (its engine stays for ``near_tie``)."""
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    graphs = srv.engine.runner.graphs
    _, warm_wall = _gated_streams(srv, prompts, WEIGHTS_OUT, models)
    warm_captures = dict(graphs.captures)
    torch.cuda.synchronize()
    srv.finished.clear()
    COUNTERS.reset()
    _, wall = _gated_streams(srv, prompts, WEIGHTS_OUT, models)
    torch.cuda.synchronize()
    run = {"label": label, "srv": srv, "wall": wall,
           "warm_tok_s": len(prompts) * WEIGHTS_OUT / warm_wall,
           "warm_captures": warm_captures,
           "launches": dict(COUNTERS.launches),
           "plain": dict(COUNTERS.plain_cuda_calls),
           "captures": dict(graphs.captures), "keys": set(graphs.keys()),
           "eager": dict(graphs.eager_steps),
           "recorded": graphs.recorded_launches(),
           "ids": [srv.tokens_after(p) for p in prompts]}
    srv.finished.clear()
    for i, prompt in enumerate(prompts if alone else ()):
        body = {"prompt": prompt, "max_tokens": WEIGHTS_OUT,
                "temperature": 0.0, "ignore_eos": True}
        if models is not None:
            body["model"] = models[i]
        status, text, _ = _http("POST", srv.url + "/v1/completions", body)
        if status != 200:
            raise AssertionError(f"{label}: {status} {text}")
        if models is not None and json.loads(text)["model"] != models[i]:
            raise AssertionError(f"{label}: the response names "
                                 f"{json.loads(text)['model']}, the "
                                 f"request {models[i]}")
    if alone:
        run["alone"] = [srv.tokens_after(p) for p in prompts]
    srv.stop()
    for kernel in KERNELS:
        if run["launches"].get(kernel + form, 0) <= 0:
            raise AssertionError(f"{label}: the window never launched "
                                 f"{kernel + form}")
    if run["plain"] or any(run["eager"].values()):
        raise AssertionError(f"{label}: plain calls on CUDA {run['plain']}"
                             f" or eager steps {run['eager']}")
    if sum(run["captures"].values()) != len(run["keys"]):
        raise AssertionError(f"{label}: a key captured twice")
    if run["captures"] != warm_captures:
        raise AssertionError(f"{label}: the window captured keys the "
                             f"warm-up did not: {warm_captures} -> "
                             f"{run['captures']}")
    tokens = len(prompts) * WEIGHTS_OUT
    run["tok_s"] = tokens / wall
    log(f"{label}: {tokens} tokens in {wall:.3f} s ({run['tok_s']:.1f} "
        f"tok/s; warm-up pass {run['warm_tok_s']:.1f}); captures by kind "
        f"after the warm-up {run['warm_captures']}, after the window "
        f"{run['captures']} ({len(run['keys'])} keys); launches "
        f"{run['launches']}")
    return run


def _w8_rows(kind, shape):
    """(rows of one projection product, products a replay) of a key."""
    if kind == "decode_burst":
        return shape[0], shape[1]
    return shape[0] * shape[1], 1


def weights_phase(vocab: int) -> dict:
    """Weight-only int8 and multi-LoRA on the card: the int8-weight
    kernel's cases and times, the quantized model against its plain
    versions, then three servers at the first run's configuration (bf16
    without LoRA, ``--quantization int8``, ``--enable-lora`` with two
    rank-16 adapters over all seven targets), 16 greedy requests of
    64..700 tokens each, WEIGHTS_OUT out, submitted together. Returns
    the headline case and the int8 and LoRA windows' launches."""
    from production_stack_tpu_torch.engine.config import (
        bench_1b_model_config)
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        INT8_KERNEL_MAX_ROWS)
    dev = torch.device("cuda", 0)
    head = _w8_kernel_cases(dev)
    torch.cuda.empty_cache()
    _w8_model_check(dev)

    cfg = bench_1b_model_config()
    rng = np.random.RandomState(21)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 700, 16).round().astype(int)]
    models = [("bench-1b", "a", "b")[i % 3] for i in range(16)]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-lora-")
    dirs = {name: os.path.join(tmp, name) for name in ("a", "b")}
    t0 = time.perf_counter()
    for seed, (name, path) in enumerate(dirs.items()):
        _write_peft_adapter(path, cfg, seed)
    size = os.path.getsize(os.path.join(dirs["a"],
                                        "adapter_model.safetensors"))
    log(f"weights: two rank-{LORA_RANK} PEFT adapters (BF16, seven targets,"
        f" {size / 2**20:.1f} MiB each) written in "
        f"{time.perf_counter() - t0:.1f} s")

    # No prefix cache: the counted window repeats the warm-up's steps.
    base = _weights_window("weights bf16", _Server(WEIGHTS_ARGS), prompts)
    int8 = _weights_window("weights int8", _Server(
        WEIGHTS_ARGS + ["--quantization", "int8"]), prompts)
    lora = _weights_window("weights LoRA", _Server(
        WEIGHTS_ARGS + ["--enable-lora", "--max-lora-rank", str(LORA_RANK),
                        "--lora-modules"]
        + [f"{n}={p}" for n, p in dirs.items()]), prompts, models)

    # Every decode-sized product of every int8 graph launched the kernel,
    # every larger one took the dequantize-then-matmul form.
    layers = cfg.num_hidden_layers
    for key, counts in int8["recorded"].items():
        m, products = _w8_rows(key[0], key[1])
        want = 4 * layers * products if m <= INT8_KERNEL_MAX_ROWS else 0
        if counts.get("int8_weight_matmul", 0) != want:
            raise AssertionError(f"weights int8: key {key} launches "
                                 f"{counts}, expected {want} int8-weight")
    if int8["launches"].get("int8_weight_matmul", 0) <= 0:
        raise AssertionError("weights int8: no int8-weight launch")
    for run in (int8, lora):
        extra = run["keys"] - base["keys"]
        if extra:
            raise AssertionError(f"{run['label']}: keys the bf16 run did "
                                 f"not capture: {sorted(extra)}")
    flips = {}
    for run in (base, int8, lora):
        flips[run["label"]] = [
            check_stream(run["label"], f"request {i} batched vs alone",
                         run["srv"].engine, prompts[i], run["alone"][i],
                         run["ids"][i], lora_name=(
                             None if models[i] == "bench-1b"
                             or run is not lora else models[i]))
            for i in range(16)]
    base_rows = [i for i in range(16) if models[i] == "bench-1b"]
    flips["LoRA base rows vs bf16"] = [
        check_stream("weights LoRA", f"base row {i} vs the server without "
                     "LoRA", base["srv"].engine, prompts[i], base["ids"][i],
                     lora["ids"][i]) for i in base_rows]
    same = [lora["ids"][i] == base["ids"][i]
            for i in range(16) if i not in base_rows]
    if any(same):
        raise AssertionError(f"weights LoRA: adapter rows equal to the "
                             f"base stream: {same}")
    for label, f in flips.items():
        parted = [(i, x) for i, x in enumerate(f) if x is not None]
        log(f"{label}: {len(f) - len(parted)}/{len(f)} streams "
            f"byte-identical, the others part at near ties (row, (index, "
            f"margin)) {parted}")
    against = (f"the first serving run's bf16 {SERVE_TOK_S:.1f} tok/s, "
               if SERVE_TOK_S else "")
    log(f"weights: int8 {int8['tok_s']:.1f} tok/s, LoRA "
        f"{lora['tok_s']:.1f} tok/s against {against}this phase's bf16 "
        f"server {base['tok_s']:.1f} tok/s (same traffic); "
        f"INT8_KERNEL_MAX_ROWS {INT8_KERNEL_MAX_ROWS}; {SMI}")
    for run in (base, int8, lora):
        run["srv"].close()
    return {"headline": head, WEIGHTS_RUN: int8["launches"],
            LORA_RUN: lora["launches"]}


# ---- families phase ---------------------------------------------------------

_ST_NAMES = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}


def write_safetensors(path, specs) -> int:
    """Write a safetensors file (a u64 little-endian header length, the
    JSON header, the raw little-endian data) from ``specs``, a list of
    (name, shape, torch dtype, make) where ``make()`` returns the CPU
    tensor: one tensor in host memory at a time. Returns the bytes
    written."""
    header, offset = {}, 0
    for name, shape, dtype, _ in specs:
        n = int(np.prod(tuple(shape))) * torch.empty(
            (), dtype=dtype).element_size()
        header[name] = {"dtype": _ST_NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name, shape, dtype, make in specs:
            t = make().contiguous()
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(f"{name}: made {t.dtype} "
                                 f"{tuple(t.shape)}, declared {dtype} "
                                 f"{tuple(shape)}")
            f.write(t.view(torch.uint8).numpy().tobytes() if t.numel()
                    else b"")
    return 8 + len(raw) + offset


# The families phase's runs (``launches_by_run`` keys) and configs:
# published config.json fields, Mixtral's depth cut to 4 of its 32
# layers (the checkpoint this phase writes, and the 80 GB card).
MIXTRAL_RUN = "serve_mixtral"
OPT_RUN = "serve_opt"
GPT2_RUN = "engine_gpt2"
MIXTRAL_LAYERS = 2
FAMILY_CONFIGS = {
    # mistralai/Mixtral-8x7B-v0.1/config.json, 2 of 32 layers
    "mixtral": {"architectures": ["MixtralForCausalLM"],
                "vocab_size": 32000, "hidden_size": 4096,
                "intermediate_size": 14336,
                "num_hidden_layers": MIXTRAL_LAYERS,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
                "rope_theta": 1e6, "num_local_experts": 8,
                "num_experts_per_tok": 2, "tie_word_embeddings": False,
                "torch_dtype": "bfloat16"},
    # facebook/opt-1.3b/config.json (its weights are float16)
    "opt": {"architectures": ["OPTForCausalLM"], "vocab_size": 50272,
            "hidden_size": 2048, "ffn_dim": 8192, "num_hidden_layers": 24,
            "num_attention_heads": 32, "max_position_embeddings": 2048,
            "do_layer_norm_before": True, "word_embed_proj_dim": 2048,
            "torch_dtype": "float16"},
    # openai-community/gpt2/config.json
    "gpt2": {"architectures": ["GPT2LMHeadModel"], "vocab_size": 50257,
             "n_embd": 768, "n_layer": 12, "n_head": 12,
             "n_positions": 1024, "n_inner": None,
             "torch_dtype": "float32"},
}
FAMILY_DTYPES = {"mixtral": torch.bfloat16, "opt": torch.float16,
                 "gpt2": torch.float32}
# The geometries of the ``kernels`` line: (query heads, kv heads,
# head_dim) of Mixtral-8x7B (also Mistral-7B, Llama-3-8B) and of
# OPT-1.3b (group 1).
FAMILY_GEOMETRIES = {"g4_d128": dict(nh=32, kv=8, d=128),
                     "g1_d64": dict(nh=32, kv=32, d=64)}
# Checked untimed: Qwen2-7B's group 7 (28 q heads over 4 kv heads) and
# tiny-opt's f32 group 1.
FAMILY_UNTIMED = {"g7_d128": dict(nh=28, kv=4, d=128)}
FAMILY_SERVER_ARGS = ["--tokenizer", "bench", "--max-num-seqs", "16",
                      "--prefill-batch-size", "4",
                      "--prefill-chunk-size", "256", "--page-size", "128",
                      "--max-model-len", "1024", "--async-scheduling",
                      "auto", "--unified-step", "auto",
                      "--disable-prefix-caching"]
# OPT-1.3b caches 24 layers x 32 heads x 64 x 2 planes x 2 bytes =
# 196,608 bytes a token: 340 pages of 128 tokens are about 8 GB.
OPT_PAGES = 340
MIXTRAL_PAGES = 256
# OPT-1.3b's and GPT-2's projections as (K, N), for the int8-weight
# kernel at M = 32 (K = 768 and 3072 are whole STEP_K = 64 steps).
FAMILY_PROJECTIONS = {
    "opt-1.3b": {"qkv": (2048, 6144), "o": (2048, 2048),
                 "fc1": (2048, 8192), "fc2": (8192, 2048)},
    "gpt2": {"qkv": (768, 2304), "o": (768, 768), "fc1": (768, 3072),
             "fc2": (3072, 768)},
}


# Mixtral's router, made decisive as a trained one is: token t's
# embedding carries ROUTE_SIGNAL[0] on hidden dim a_t and ROUTE_SIGNAL[1]
# on b_t (its two experts, t % 8 and another that t // 8 picks), and
# expert e's router row reads dim e with weight ROUTE_WEIGHT, so every
# layer's top-2 choice and its combine weights stand far from a tie.
# An untrained N(0, 0.02) router's choice, and its top-2 softmax, move
# with a bf16 rounding of the hidden state (PERF.md §6), which the
# logits and a greedy stream then amplify.
ROUTE_SIGNAL = (64.0, 16.0)
ROUTE_WEIGHT = 2.0


def _hf_tensors(arch, hf):
    """(name, shape, kind) of every tensor of an HF checkpoint of
    ``arch`` at the config ``hf``, in file groups: [(file stem,
    [...])]. kind: "w" N(0, 0.02), "b" N(0, 0.02) (biases), "one",
    "embed_routed" and "router" (Mixtral's, see ROUTE_SIGNAL)."""
    if arch in ("llama", "qwen2"):
        h, f = hf["hidden_size"], hf["intermediate_size"]
        d = h // hf["num_attention_heads"]
        qd, kvd = hf["num_attention_heads"] * d, hf["num_key_value_heads"] * d
        top = [("model.embed_tokens.weight", (hf["vocab_size"], h), "w"),
               ("model.norm.weight", (h,), "one")]
        if not hf["tie_word_embeddings"]:
            top.append(("lm_head.weight", (hf["vocab_size"], h), "w"))
        groups = [("model-embed", top)]
        for i in range(hf["num_hidden_layers"]):
            p = f"model.layers.{i}."
            layer = [(p + "input_layernorm.weight", (h,), "one"),
                     (p + "post_attention_layernorm.weight", (h,), "one"),
                     (p + "self_attn.q_proj.weight", (qd, h), "w"),
                     (p + "self_attn.k_proj.weight", (kvd, h), "w"),
                     (p + "self_attn.v_proj.weight", (kvd, h), "w"),
                     (p + "self_attn.o_proj.weight", (h, qd), "w"),
                     (p + "mlp.gate_proj.weight", (f, h), "w"),
                     (p + "mlp.up_proj.weight", (f, h), "w"),
                     (p + "mlp.down_proj.weight", (h, f), "w")]
            if arch == "qwen2":
                layer += [(p + f"self_attn.{x}_proj.bias", (n,), "b")
                          for x, n in (("q", qd), ("k", kvd), ("v", kvd))]
            groups.append((f"model-layer-{i:03d}", layer))
        return groups
    if arch == "mixtral":
        h, f, e = hf["hidden_size"], hf["intermediate_size"], hf[
            "num_local_experts"]
        d = h // hf["num_attention_heads"]
        kvd = hf["num_key_value_heads"] * d
        groups = [("model-embed", [
            ("model.embed_tokens.weight", (hf["vocab_size"], h),
             "embed_routed"),
            ("model.norm.weight", (h,), "one"),
            ("lm_head.weight", (hf["vocab_size"], h), "w")])]
        for i in range(hf["num_hidden_layers"]):
            p = f"model.layers.{i}."
            layer = [(p + "input_layernorm.weight", (h,), "one"),
                     (p + "post_attention_layernorm.weight", (h,), "one"),
                     (p + "self_attn.q_proj.weight", (h, h), "w"),
                     (p + "self_attn.k_proj.weight", (kvd, h), "w"),
                     (p + "self_attn.v_proj.weight", (kvd, h), "w"),
                     (p + "self_attn.o_proj.weight", (h, h), "w"),
                     (p + "block_sparse_moe.gate.weight", (e, h),
                      "router")]
            for x in range(e):
                q = f"{p}block_sparse_moe.experts.{x}."
                layer += [(q + "w1.weight", (f, h), "w"),
                          (q + "w3.weight", (f, h), "w"),
                          (q + "w2.weight", (h, f), "w")]
            groups.append((f"model-layer-{i:03d}", layer))
        return groups
    if arch == "opt":
        h, f = hf["hidden_size"], hf["ffn_dim"]
        p = "model.decoder."
        top = [(p + "embed_tokens.weight", (hf["vocab_size"], h), "w"),
               (p + "embed_positions.weight",
                (hf["max_position_embeddings"] + 2, h), "w"),
               (p + "final_layer_norm.weight", (h,), "one"),
               (p + "final_layer_norm.bias", (h,), "b")]
        layers = []
        for i in range(hf["num_hidden_layers"]):
            q = f"{p}layers.{i}."
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                layers += [(q + f"self_attn.{proj}.weight", (h, h), "w"),
                           (q + f"self_attn.{proj}.bias", (h,), "b")]
            for norm in ("self_attn_layer_norm", "final_layer_norm"):
                layers += [(q + f"{norm}.weight", (h,), "one"),
                           (q + f"{norm}.bias", (h,), "b")]
            layers += [(q + "fc1.weight", (f, h), "w"),
                       (q + "fc1.bias", (f,), "b"),
                       (q + "fc2.weight", (h, f), "w"),
                       (q + "fc2.bias", (h,), "b")]
        return [("model", top + layers)]
    h = hf["n_embd"]
    f = hf["n_inner"] or 4 * h
    tensors = [("transformer.wte.weight", (hf["vocab_size"], h), "w"),
               ("transformer.wpe.weight", (hf["n_positions"], h), "w"),
               ("transformer.ln_f.weight", (h,), "one"),
               ("transformer.ln_f.bias", (h,), "b")]
    for i in range(hf["n_layer"]):
        q = f"transformer.h.{i}."
        # Conv1D: [in, out].
        tensors += [(q + "ln_1.weight", (h,), "one"),
                    (q + "ln_1.bias", (h,), "b"),
                    (q + "attn.c_attn.weight", (h, 3 * h), "w"),
                    (q + "attn.c_attn.bias", (3 * h,), "b"),
                    (q + "attn.c_proj.weight", (h, h), "w"),
                    (q + "attn.c_proj.bias", (h,), "b"),
                    (q + "ln_2.weight", (h,), "one"),
                    (q + "ln_2.bias", (h,), "b"),
                    (q + "mlp.c_fc.weight", (h, f), "w"),
                    (q + "mlp.c_fc.bias", (f,), "b"),
                    (q + "mlp.c_proj.weight", (f, h), "w"),
                    (q + "mlp.c_proj.bias", (h,), "b")]
    return [("model", tensors)]


def _hf_tensor(index, shape, kind, dtype, seed):
    """Tensor ``index`` of a checkpoint, made on the card from ``seed``
    and brought to the host in ``dtype``: the same bits every call."""
    dev = torch.device("cuda", 0)
    if kind == "one":
        return torch.ones(shape, dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 1_000_003 + index)
    x = torch.randn(shape, generator=gen, device=dev).mul_(0.02)
    if kind == "router":  # [E, H]
        e = shape[0]
        x[:, :e] = ROUTE_WEIGHT * torch.eye(e, device=dev)
    elif kind == "embed_routed":  # [V, H]
        e = FAMILY_CONFIGS["mixtral"]["num_local_experts"]
        t = torch.arange(shape[0], device=dev)
        a = t % e
        b = (a + 1 + (t // e) % (e - 1)) % e
        x[:, :e] = 0.0
        x[t, a] = ROUTE_SIGNAL[0]
        x[t, b] = ROUTE_SIGNAL[1]
    return x.to(dtype).cpu()


def write_checkpoint(path, arch, seed, hf=None, dtype=None) -> dict:
    """``config.json`` and safetensors shards of random weights (from
    ``seed``) for ``arch`` at FAMILY_CONFIGS' shapes (or the config
    ``hf``, written in ``dtype``); returns {name: (index, shape, kind)}
    of every tensor, and logs bytes and seconds."""
    hf = hf or FAMILY_CONFIGS[arch]
    dtype = dtype or FAMILY_DTYPES[arch]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    t0 = time.perf_counter()
    index, nbytes, written = 0, 0, {}
    for stem, tensors in _hf_tensors(arch, hf):
        specs = []
        for name, shape, kind in tensors:
            written[name] = (index, shape, kind)
            specs.append((name, shape, dtype,
                          lambda i=index, s=shape, k=kind:
                          _hf_tensor(i, s, k, dtype, seed)))
            index += 1
        nbytes += write_safetensors(os.path.join(
            path, stem + ".safetensors"), specs)
    log(f"checkpoint {arch}: {index} tensors, "
        f"{nbytes / 1e9:.3f} GB in {dtype}, written in "
        f"{time.perf_counter() - t0:.1f} s")
    return written


def _family_kernel_cases(dev) -> dict:
    """Each attention kernel at the new geometries, bf16 and int8 KV,
    the kernel phase's headline shapes (decode B = 32, kv lens 1..1024;
    prefill B = 8, T = 512, first chunk; ragged R = 40, W = 512, the
    unified step), timed against its plain version, its bound and SDPA;
    then untimed cases at Qwen2-7B's group 7 and tiny-opt's f32 group 1;
    then the int8-weight kernel at OPT-1.3b's and GPT-2's projections,
    M = 32. Returns {kernel: {geometry: {"bf16": case, "int8": case}}}
    and the int8-weight cases."""
    from production_stack_tpu_torch.engine.quantization import (
        dequant_matmul)
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        int8_weight_matmul, int8_weight_matmul_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    timer = Timer(dev)
    bf16 = torch.bfloat16
    lens = np.linspace(1, 1024, 32).round().astype(int).tolist()
    lens[7] = lens[21] = 0
    first = [(0, n) for n in [512, 448, 384, 320, 256, 0, 128, 64]]
    decode_lens = np.linspace(70, 1024, 28).round().astype(int).tolist()
    unified = ([(n, 0) for n in decode_lens]
               + [(512, 511), (448, 447), (300, 299), (64, 63),
                  (700, 187), (612, 99), (1012, 499), (200, 199)]
               + [(0, -1)] * 4)
    verify = [(max(n, i % 5 + 1), i % 5) for i, n in enumerate(
        np.linspace(1, 1024, 32).round().astype(int).tolist())]
    verify[9] = verify[26] = (0, -1)
    out = {name: {} for name in KERNELS}
    for geo, shape in {**FAMILY_GEOMETRIES, **FAMILY_UNTIMED}.items():
        timed = timer if geo in FAMILY_GEOMETRIES else None
        for int8 in (False, True):
            form = "int8" if int8 else "bf16"
            tag = f"{geo} bf16{'/int8' if int8 else ''}"
            cases = {
                "paged_decode": decode_case(
                    f"decode {tag} B=32 ps=128", 32, lens, 128, bf16, dev,
                    gen, timed, num_pages=512, int8=int8, **shape),
                "paged_prefill": prefill_case(
                    f"prefill {tag} B=8 T=512 first chunk ps=128", first,
                    512, 128, bf16, dev, gen, timed, int8=int8, **shape),
                "paged_ragged": ragged_case(
                    f"ragged {tag} unified R=40 W=512 ps=128", unified, 512,
                    128, bf16, dev, gen, timed, int8=int8, **shape),
            }
            extra = [ragged_case(f"ragged {tag} verify B=32 W=5 ps=16",
                                 verify, 5, 16, bf16, dev, gen, int8=int8,
                                 verify=True, **shape),
                     prefill_case(f"prefill {tag} B=8 T=512 ps=16",
                                  [(512, n) for _, n in first], 512, 16,
                                  bf16, dev, gen, int8=int8, **shape)]
            for name, r in cases.items():
                log("families kernel case " + json.dumps(r))
                out[name].setdefault(geo, {})[form] = r
            for r in extra:
                log("families kernel case " + json.dumps(r))
            torch.cuda.empty_cache()
    tiny = dict(nh=4, kv=4, d=32)
    for int8 in (False, True):
        for r in (decode_case("decode f32 tiny-opt B=4 ps=16", 4,
                              [1, 0, 37, 300], 16, torch.float32, dev, gen,
                              max_len=512, int8=int8, **tiny),
                  prefill_case("prefill f32 tiny-opt B=2 T=64 ps=16",
                               [(40, 64), (40, 9)], 64, 16, torch.float32,
                               dev, gen, max_len=256, int8=int8, **tiny),
                  ragged_case("ragged f32 tiny-opt R=4 W=16 ps=16",
                              [(1, 0), (77, 15), (0, -1), (200, 3)], 16,
                              16, torch.float32, dev, gen, max_len=256,
                              int8=int8, **tiny)):
            log("families kernel case " + json.dumps(r))
    w8 = {}
    for model, projs in FAMILY_PROJECTIONS.items():
        for proj, (k, n) in projs.items():
            q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                              dtype=torch.int8)
            scale = (torch.rand((n,), generator=gen, device=dev) + 0.5) * (
                0.02 / 127)
            dense = (q.float() * scale[:, None]).to(bf16)
            x = torch.randn((32, k), generator=gen, device=dev).to(bf16)
            got = int8_weight_matmul(x, q, scale)
            want = int8_weight_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
            r = {"case": f"int8_weight_matmul {model} {proj} M=32 K={k} "
                         f"N={n}",
                 "max_abs_err": (got.float() - want.float()).abs().max()
                 .item(),
                 "ms": timer.ms(lambda: int8_weight_matmul(x, q, scale)),
                 "plain_ms": timer.ms(
                     lambda: int8_weight_matmul_plain(x, q, scale)),
                 "library_ms": timer.ms(lambda: torch.matmul(x, dense.t())),
                 "dequant_ms": timer.ms(
                     lambda: dequant_matmul(x, q, scale)),
                 **_w8_bound(32, k, n)}
            log("families kernel case " + json.dumps(r))
            w8[f"{model} {proj}"] = r
    for name, by_geo in out.items():
        for geo, forms in by_geo.items():
            if geo in FAMILY_GEOMETRIES:
                log(f"families kernel {name} {geo}: " + "; ".join(
                    f"{form} {c['ms']:.5f} ms (bound {c['bound_ms']:.5f} "
                    f"by {c['bound_by']}, SDPA {c['library_ms']:.5f}, "
                    f"plain {c['plain_ms']:.4f}, max abs err "
                    f"{c['max_abs_err']:.3e})" for form, c in forms.items())
                    + f"; {SMI}")
    return ({name: {g: f for g, f in by_geo.items()
                    if g in FAMILY_GEOMETRIES}
             for name, by_geo in out.items()}, w8)


def _family_forwards(dev, cfg, params, label, kv_dtype="bf16",
                     hold_logits=True, page_size=128,
                     layout="per_layer") -> None:
    """The model check: prefill T = 512, a decode step and a verify
    block through the family's ``forward``, the kernels against the
    plain versions rounded as the kernels round (``plain_bf16p``), over
    a fresh cache of the model's dtype (``kv_dtype`` "int8": an int8
    one) in pages of ``page_size`` and the ``layout``. In the kernels' run every attention call is also
    held, on its own inputs, to the plain version (BF16_TOL, F32_TOL
    for f32 queries); the logits are held by ``compare_logits``, or
    with ``hold_logits`` False printed only. For Mixtral the smallest
    router gaps (1st against 2nd, 2nd against 3rd expert logit) are
    printed."""
    from production_stack_tpu_torch.models import llama, mixtral
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size, (1, 512 + 6), generator=gen,
                           device=dev, dtype=torch.int32)
    top_k, dispatch = mixtral.top_k_lower_index, llama.dispatch_attention
    gaps, calls = [], {}

    def recording(logits, k):
        top = torch.topk(logits, k + 1, dim=-1).values
        gaps.append(((top[..., 0] - top[..., 1]).min().item(),
                     (top[..., k - 1] - top[..., k]).min().item()))
        return top_k(logits, k)

    def held(config, q, k, v, table, pos, lens, kind, impl=None,
             layer=None):
        args = (config, q, k, v, table, pos, lens, kind)
        out = dispatch(*args, impl=impl, layer=layer)
        if impl == "cuda":
            ref = dispatch(*args, impl="plain_bf16p", layer=layer)
            torch.testing.assert_close(
                out.float(), ref.float(),
                **(F32_TOL if q.dtype == torch.float32 else BF16_TOL),
                msg=lambda m: f"families {label} {kind} attention: {m}")
            err = (out.float() - ref.float()).abs().max().item()
            calls[kind] = max(calls.get(kind, 0.0), err)
        return out

    mixtral.top_k_lower_index = recording
    llama.dispatch_attention = held
    try:
        results = {impl: _forwards(dev, cfg, params, tokens,
                                   _model_caches(dev, cfg, kv_dtype,
                                                 layout, page_size), impl)
                   for impl in ("cuda", "plain_bf16p")}
    finally:
        mixtral.top_k_lower_index = top_k
        llama.dispatch_attention = dispatch
    log(f"{label}: every attention call of the kernels' forward within "
        f"tolerance of the plain version on its inputs, max abs err by "
        f"kind {calls}")
    if gaps:
        log(f"families {label} router: smallest gaps, 1st to 2nd "
            f"{min(g[0] for g in gaps):.3e}, 2nd to 3rd "
            f"{min(g[1] for g in gaps):.3e} expert logit, over "
            f"{len(gaps)} layer-steps")
    for i, phase in enumerate(PHASES):
        c = compare_logits(results["cuda"][i], results["plain_bf16p"][i])
        log(f"families {label} model {phase}: finite {c['finite']}, max "
            f"|cuda - plain| {c['diff']:.3e} (max |logit| {c['scale']:.3e})"
            f", {c['flips']} flips of {c['positions']}, margins "
            f"{[f'{m:.3e}' for m in c['margins']]}")
        if hold_logits and not c["ok"]:
            raise AssertionError(f"families {label} {phase}: the kernels' "
                                 "and the plain versions' logits disagree")


def _readback(label, params, arch, written, seed, samples) -> None:
    """Sampled leaves of the served params against the tensors written
    (regenerated from the seed), after the loader's layout and cast:
    bitwise equal. ``samples``: [(checkpoint name, params path, index,
    transpose)]."""
    dtype = params.embed.dtype
    for name, path, index, transpose in samples:
        i, shape, kind = written[name]
        want = _hf_tensor(i, shape, kind, FAMILY_DTYPES[arch], seed).to(
            device=params.embed.device, dtype=dtype)
        got = params.get_parameter(path)[index]
        if not torch.equal(got, want.T if transpose else want):
            raise AssertionError(f"families {label}: {path} differs from "
                                 f"the checkpoint's {name}")
    log(f"families {label}: {len(samples)} sampled leaves bitwise equal "
        f"to the checkpoint's (written in {FAMILY_DTYPES[arch]}, served "
        f"in {dtype})")


def _family_server(label, arch, path, pages, prompts, written, seed,
                   samples) -> dict:
    """A server on ``--model path``: the model check and the read-back
    on its params, then the weights phase's window (warm-up pass,
    counted window, each request alone, every stream held to it)."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    srv = _Server(["--model", path, "--num-pages", str(pages)]
                  + FAMILY_SERVER_ARGS, base=[])
    start = time.perf_counter() - t0
    cfg = srv.engine.config
    log(f"families {label}: server up in {start:.1f} s (the load "
        f"included); {cfg.model.architecture}, {cfg.model.dtype}, "
        f"{cfg.model.num_attention_heads} q / "
        f"{cfg.model.num_key_value_heads} kv heads of "
        f"{cfg.model.head_dim}, async {cfg.scheduler.async_scheduling}, "
        f"unified {cfg.scheduler.unified_step}, {cfg.cache.num_pages} "
        f"pages; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    run = _weights_window(label, srv, prompts)
    params = srv.engine.runner.params
    _readback(label, params, arch, written, seed, samples)
    with torch.inference_mode():
        _family_forwards(dev, cfg.model, params, label)
    flips = [check_stream(label, f"request {i} batched vs alone",
                          srv.engine, prompts[i], run["alone"][i],
                          run["ids"][i]) for i in range(len(prompts))]
    parted = [(i, x) for i, x in enumerate(flips) if x is not None]
    log(f"families {label}: {len(flips) - len(parted)}/{len(flips)} streams "
        f"byte-identical to the request alone, the others part at near "
        f"ties (row, (index, margin)) {parted}; graph pool "
        f"{srv.engine.runner.graphs.pool_bytes() / 1e9:.2f} GB; {SMI}")
    srv.close()
    return run


def _gpt2_engine(path, written, seed) -> dict:
    """GPT-2 through ``LLMEngine`` over ``load_weights``: 8 greedy
    prompts together (async and unified on), then each alone; every
    stream held to it; all three kernels launched."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.engine.weights import (
        load_model_config, load_weights)
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    model = load_model_config(path)
    t0 = time.perf_counter()
    params = load_weights(path, model)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = EngineConfig(
        model=model, cache=CacheConfig(page_size=128, num_pages=256),
        scheduler=SchedulerConfig(max_num_seqs=8, max_model_len=2048,
                                  prefill_chunk_size=256,
                                  prefill_batch_size=4,
                                  async_scheduling=True, unified_step=True))
    log(f"families gpt2: loaded in {load_s:.1f} s; max_model_len 2048 "
        f"clamped to {cfg.scheduler.max_model_len} (the position table)")
    if cfg.scheduler.max_model_len != FAMILY_CONFIGS["gpt2"]["n_positions"]:
        raise AssertionError("families gpt2: max_model_len not clamped")
    engine = LLMEngine(cfg, params=params)
    _readback("gpt2", engine.runner.params, "gpt2", written, seed, [
        ("transformer.wte.weight", "embed", (), False),
        ("transformer.h.5.attn.c_attn.weight", "layers.5.qkv.weight", (),
         True),
        ("transformer.h.11.mlp.c_proj.weight", "layers.11.fc2.weight", (),
         True)])
    rng = np.random.RandomState(23)
    prompts = [rng.randint(258, model.vocab_size, size=n).tolist()
               for n in np.linspace(40, 600, 8).round().astype(int)]
    sp = SamplingParams(temperature=0.0, max_tokens=WEIGHTS_OUT,
                        ignore_eos=True)
    engine.generate_batch(prompts, sp)  # warm-up: the graphs' captures
    torch.cuda.synchronize()
    COUNTERS.reset()
    t0 = time.perf_counter()
    batched = [list(s.output_token_ids)
               for s in engine.generate_batch(prompts, sp)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(COUNTERS.launches)
    plain = dict(COUNTERS.plain_cuda_calls)
    alone = [list(engine.generate(p, sp).output_token_ids) for p in prompts]
    for kernel in KERNELS:
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"families gpt2: never launched {kernel}")
    if plain:
        raise AssertionError(f"families gpt2: plain calls on CUDA {plain}")
    flips = [check_stream("families gpt2", f"prompt {i} batched vs alone",
                          engine, prompts[i], alone[i], batched[i])
             for i in range(len(prompts))]
    parted = [(i, x) for i, x in enumerate(flips) if x is not None]
    log(f"families gpt2: 8 x {WEIGHTS_OUT} tokens in {wall:.3f} s "
        f"({8 * WEIGHTS_OUT / wall:.1f} tok/s); launches {launches}; "
        f"{8 - len(parted)}/8 streams byte-identical to the prompt alone, "
        f"the others part at near ties {parted}")
    del engine, params
    return launches


def families_phase(vocab: int) -> dict:
    """The OPT, GPT-2 and Mixtral families and HF checkpoint loading on
    the card: the kernels at the new geometries, then Mixtral-8x7B's
    full width (MIXTRAL_LAYERS layers) and OPT-1.3b served from
    checkpoint directories written here (``--model DIR --tokenizer
    bench``), then GPT-2 through ``LLMEngine``. Returns the kernels'
    geometry cases, the int8-weight cases and each run's launches."""
    import gc
    import shutil
    dev = torch.device("cuda", 0)
    del vocab  # each family's own
    gc.collect()
    torch.cuda.empty_cache()
    log(f"families: allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB"
        f", reserved {torch.cuda.memory_reserved() / 1e9:.2f} GB before "
        "the phase")
    geometries, w8 = _family_kernel_cases(dev)
    torch.cuda.empty_cache()
    out = {"geometries": geometries, "w8": w8}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-families-")
    try:
        for arch, run, pages, seed, samples in (
                ("mixtral", MIXTRAL_RUN, MIXTRAL_PAGES, 31, [
                    ("model.embed_tokens.weight", "embed", (), False),
                    ("model.layers.0.self_attn.q_proj.weight",
                     "layers.0.qkv.weight", (slice(0, 4096),), False),
                    ("model.layers.1.block_sparse_moe.experts.5.w2.weight",
                     "layers.1.w_down", (slice(None), 5), False),
                    ("model.layers.0.block_sparse_moe.experts.7.w1.weight",
                     "layers.0.w_gate", (7,), False),
                    ("lm_head.weight", "lm_head.weight", (), False)]),
                ("opt", OPT_RUN, OPT_PAGES, 32, [
                    ("model.decoder.embed_tokens.weight", "embed", (),
                     False),
                    ("model.decoder.layers.7.fc2.weight",
                     "layers.7.fc2.weight", (), False),
                    ("model.decoder.layers.0.self_attn.k_proj.bias",
                     "layers.0.qkv.bias", (slice(2048, 4096),), False)])):
            path = os.path.join(tmp, arch)
            written = write_checkpoint(path, arch, seed)
            hf = FAMILY_CONFIGS[arch]
            rng = np.random.RandomState(21)
            prompts = [rng.randint(258, hf["vocab_size"], size=n).tolist()
                       for n in np.linspace(64, 700, 16).round().astype(int)]
            out[run] = _family_server(
                f"serve {arch}", arch, path, pages, prompts, written, seed,
                samples)["launches"]
            shutil.rmtree(path)
            gc.collect()
            torch.cuda.empty_cache()
        path = os.path.join(tmp, "gpt2")
        written = write_checkpoint(path, "gpt2", 33)
        out[GPT2_RUN] = _gpt2_engine(path, written, 33)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- geometries phase -------------------------------------------------------

# The serving runs of the geometries phase (``launches_by_run`` keys)
# and their checkpoints, written from published config.json values.
LLAMA70_RUN = "serve_llama3_70b"
LLAMA70_INT8_RUN = "serve_llama3_70b_int8"
OPT27_RUN = "serve_opt_2.7b_f16"
QWEN05_RUN = "serve_qwen2_0.5b_f32"
W8_F16_RUN = "serve_int8_weights_f16"
FALCON3_RUN = "serve_falcon3_7b"
FALCON3_INT8_RUN = "serve_falcon3_7b_int8"
OPEN_LLAMA_RUN = "serve_open_llama_3b_f16"
D512_RUN = "serve_geometry_d512"
D512_INT8_RUN = "serve_geometry_d512_int8"
LLAMA70_LAYERS = 2
GEOMETRY_CONFIGS = {
    # meta-llama/Meta-Llama-3-70B/config.json, 2 of 80 layers: group 8
    # (64 q over 8 kv heads) at head_dim 128, also Llama-2-70B's and
    # Qwen2-72B's.
    "llama3-70b": {"architectures": ["LlamaForCausalLM"],
                   "vocab_size": 128256, "hidden_size": 8192,
                   "intermediate_size": 28672,
                   "num_hidden_layers": LLAMA70_LAYERS,
                   "num_attention_heads": 64, "num_key_value_heads": 8,
                   "max_position_embeddings": 8192, "rms_norm_eps": 1e-5,
                   "rope_theta": 500000.0, "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"},
    # facebook/opt-2.7b/config.json, 16 of 32 layers: group 1 at
    # head_dim 80 (2560 / 32).
    "opt-2.7b": {"architectures": ["OPTForCausalLM"], "vocab_size": 50272,
                 "hidden_size": 2560, "ffn_dim": 10240,
                 "num_hidden_layers": 16, "num_attention_heads": 32,
                 "max_position_embeddings": 2048,
                 "do_layer_norm_before": True, "word_embed_proj_dim": 2560,
                 "torch_dtype": "float16"},
    # Qwen/Qwen2-0.5B/config.json, 12 of 24 layers: group 7 (14 q over
    # 2 kv heads) at head_dim 64, tied embeddings.
    "qwen2-0.5b": {"architectures": ["Qwen2ForCausalLM"],
                   "vocab_size": 151936, "hidden_size": 896,
                   "intermediate_size": 4864, "num_hidden_layers": 12,
                   "num_attention_heads": 14, "num_key_value_heads": 2,
                   "max_position_embeddings": 131072,
                   "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
                   "tie_word_embeddings": True, "torch_dtype": "bfloat16"},
    # tiiuae/Falcon3-7B-Base/config.json, 1 of 28 layers (cut for the
    # phase's time): group 3 (12 q over 4 kv heads) at the explicit
    # head_dim 256, the head-dim tile 256 itself.
    "falcon3-7b": {"architectures": ["LlamaForCausalLM"],
                   "vocab_size": 131072, "hidden_size": 3072,
                   "intermediate_size": 23040, "num_hidden_layers": 1,
                   "num_attention_heads": 12, "num_key_value_heads": 4,
                   "head_dim": 256, "max_position_embeddings": 32768,
                   "rms_norm_eps": 1e-6, "rope_theta": 1000042.0,
                   "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"},
    # openlm-research/open_llama_3b/config.json, 2 of 26 layers (cut for
    # the phase's time): group 1 (32 heads, no GQA) at head_dim 100
    # (3200 / 32), padded in the kernel to the tile 128.
    "open-llama-3b": {"architectures": ["LlamaForCausalLM"],
                      "vocab_size": 32000, "hidden_size": 3200,
                      "intermediate_size": 8640, "num_hidden_layers": 2,
                      "num_attention_heads": 32,
                      "num_key_value_heads": 32,
                      "max_position_embeddings": 2048,
                      "rms_norm_eps": 1e-6,
                      "tie_word_embeddings": False,
                      "torch_dtype": "float16"},
    # Not a published checkpoint: a geometry written to reach head_dim
    # 512 (prefill on the wgmma walk's wide form, decode and ragged as 4
    # slabs of 128), on
    # the published widths of tiiuae/Falcon3-7B-Base/config.json (hidden
    # 3072, FFN 23040, vocab 131072, rope theta 1000042, rms_norm_eps
    # 1e-6) but 6 q heads over 2 kv heads at an explicit head_dim 512:
    # Falcon3's group 3, the q width equal to hidden. 1 layer.
    "d512": {"architectures": ["LlamaForCausalLM"],
             "vocab_size": 131072, "hidden_size": 3072,
             "intermediate_size": 23040, "num_hidden_layers": 1,
             "num_attention_heads": 6, "num_key_value_heads": 2,
             "head_dim": 512, "max_position_embeddings": 32768,
             "rms_norm_eps": 1e-6, "rope_theta": 1000042.0,
             "tie_word_embeddings": False, "torch_dtype": "bfloat16"},
}
# (architecture, dtype the checkpoint is written and served in, the
# server's dtype flags, seed) of each.
GEOMETRY_MODELS = {
    "llama3-70b": ("llama", torch.bfloat16, [], 41),
    "opt-2.7b": ("opt", torch.float16, ["--dtype", "float16"], 42),
    "qwen2-0.5b": ("qwen2", torch.float32, ["--dtype", "float32"], 43),
    "falcon3-7b": ("llama", torch.bfloat16, [], 44),
    "open-llama-3b": ("llama", torch.float16, ["--dtype", "float16"], 45),
    "d512": ("llama", torch.bfloat16, [], 46),
}
# 16 requests of at most 700 + 32 tokens take 6 pages of 128 each.
GEOMETRY_PAGES = 128
# The checkpoints whose servers also serve each request alone after the
# window (where a batched stream parts from it is printed, not held);
# Falcon3's, OpenLLaMA's and d512's skip that pass, for the phase's time.
GEOMETRY_ALONE = ("llama3-70b", "opt-2.7b", "qwen2-0.5b")
# The kernel sweep: every point is served (kernel_geometry_supported).
# The tiles' own head dims over every group at page 16; then head dims
# padded in the kernel (96 and 100 at the tile 128, 160 at 256) and the
# tile 256 over groups 1, 3, 4 and 8 at pages 128 and 16; then head
# dims above 256, run as slabs of 128 (3 to 8 slabs; 257, 288, 320,
# 448, 576 and 640 pad the last; 16-bit prefill to 512 on the wide
# form), over the same groups and pages.
SWEEP_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
SWEEP_GROUPS = (1, 2, 3, 4, 5, 6, 7, 8, 16)
SWEEP_HEAD_DIMS = (64, 80, 128)
SWEEP_PADDED = ((96, 100, 160, 256), (1, 3, 4, 8), (128, 16))
SWEEP_SLABS = ((257, 288, 320, 384, 448, 512, 576, 640, 1024),
               (1, 3, 4, 8), (16, 128))
# The sweep's points at group 3 and page 16, whose prefill launch is
# checked for the walk it ran (``_prefill_walks_of``).
SWEEP_WALK_POINTS = []
# Points outside it (dtype, cache dtype or None for the same, group,
# head_dim), each refused by the rule and by the library: head_dim 0
# and -1, int8 queries (no query type of the kernels), a mixed cache,
# group 0.
SWEEP_REFUSED = ((torch.bfloat16, None, 4, 0),
                 (torch.float16, torch.int8, 3, 0),
                 (torch.float32, None, 1, -1),
                 (torch.int8, None, 4, 64),
                 (torch.bfloat16, torch.float16, 4, 64),
                 (torch.bfloat16, None, 0, 64))
# The timed rows: (q heads, kv heads, head_dim, dtype, KV forms).
GEOMETRY_ROWS = {
    "g8_d128": (64, 8, 128, torch.bfloat16, (False, True)),
    "g1_d80": (32, 32, 80, torch.float16, (False,)),
    "g7_d64": (14, 2, 64, torch.float32, (False,)),
    "g1_d128": (32, 32, 128, torch.bfloat16, (False,)),
    "g3_d256": (12, 4, 256, torch.bfloat16, (False, True)),
    "g1_d100": (32, 32, 100, torch.float16, (False,)),
    # Above 256: g3_d512 moves g3_d256's K/V bytes (2 kv heads at 512
    # against 4 at 256), so the two rows compare directly; g1_d320 (16
    # heads) pads its third slab (decode, ragged) and the wide prefill
    # form's width 384.
    "g3_d512": (6, 2, 512, torch.bfloat16, (False, True)),
    "g1_d320": (16, 16, 320, torch.float16, (False,)),
}
# The rows' head dims that the prefill kernel runs on the wgmma walk's
# wide form (257 to 512), each held to it.
WIDE_ROWS = (512, 320)
# The walk the ragged kernel runs at the rows whose 16-bit forms moved
# to the wgmma walk (head dims 129 to 256 at its tile 256, 257 to 512 on
# its wide form), each held to it; and the geometries (q heads, kv
# heads, head_dim) whose 16-bit forms stay on the mma.sync walk.
RAGGED_ROW_WALKS = {"g3_d256": "wgmma", "g3_d512": "wgmma_wide",
                    "g1_d320": "wgmma_wide"}
RAGGED_MMA_CONTROLS = {"bench-1b": (32, 8, 64), "g4_d128": (32, 8, 128),
                       "g1_d64": (32, 32, 64)}
# The serving run whose launches each row's form reports (g1_d128,
# Llama-2-7B's geometry, is served by no run of this script).
GEOMETRY_ROW_RUNS = {("g8_d128", "bfloat16"): LLAMA70_RUN,
                     ("g8_d128", "int8"): LLAMA70_INT8_RUN,
                     ("g1_d80", "float16"): OPT27_RUN,
                     ("g7_d64", "float32"): QWEN05_RUN,
                     ("g3_d256", "bfloat16"): FALCON3_RUN,
                     ("g3_d256", "int8"): FALCON3_INT8_RUN,
                     ("g1_d100", "float16"): OPEN_LLAMA_RUN,
                     ("g3_d512", "bfloat16"): D512_RUN,
                     ("g3_d512", "int8"): D512_INT8_RUN}
# OPT-2.7b's projections as (K, N), for the int8-weight kernel's f16
# form.
OPT27_PROJECTIONS = {"qkv": (2560, 7680), "o": (2560, 2560),
                     "fc1": (2560, 10240), "fc2": (10240, 2560)}


def _sweep_point(dev, gen, dtype, int8, group, d, ps=16) -> float:
    """Every kernel at one point of the sweep, small shapes: B = 3 rows,
    two kv heads, kv lens 130 and 300 (past the 128- and 256-token chunk
    edges) and a pad row, page ``ps``. Decode per layer (the wrapper's
    split and one split), stacked (layer 1 of 2, bitwise the per-layer
    launch on its view) and its tail form (S = 4); prefill (T = 24,
    rows starting at 120 and 280); ragged (W = 5: a decode row, a pad
    row, a 5-slot verify row). Each against its plain version; returns
    the largest error."""
    from production_stack_tpu_torch.ops import paged_attention_cuda as pa
    from production_stack_tpu_torch.ops.prefill_attention_cuda import (
        paged_prefill_attention, paged_prefill_attention_plain)
    from production_stack_tpu_torch.ops.ragged_attention_cuda import (
        paged_ragged_attention, paged_ragged_attention_plain)
    kv, max_pages = 2, 24
    nh, num_pages = kv * group, 3 * max_pages + 1
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    p16 = {} if dtype == torch.float32 else {"p_dtype": dtype}
    tag = (f"sweep {str(dtype)[6:]}{'/int8' if int8 else ''} g{group} "
           f"d{d} ps{ps}")
    (kc, vc), _ = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    worst = 0.0

    def held(what, got, ref):
        nonlocal worst
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol,
                                   msg=lambda m: f"{tag} {what}: {m}")
        worst = max(worst, (got.float() - ref.float()).abs().max().item())

    lens_l = [130, 0, 300]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    table = _page_table(lens_l, ps, max_pages, num_pages, gen, dev)
    q = torch.randn((3, nh, d), generator=gen, device=dev).to(dtype)
    want = pa.paged_decode_attention_plain(q, kc, vc, table, lens)
    for splits in (None, 1):
        got = pa.paged_decode_attention(q, kc, vc, table, lens,
                                        num_splits=splits)
        held(f"decode splits={splits}", got, want)
        if got[1].abs().max().item() != 0.0:
            raise AssertionError(f"{tag}: the decode pad row is not 0")
    k5, v5 = (_stack_at(c, 2, 1, gen) for c in (kc, vc))
    got5 = pa.paged_decode_attention(q, k5, v5, table, lens, layer=1)
    held("decode stacked", got5, pa.paged_decode_attention_plain(
        q, k5, v5, table, lens, layer=1))
    if not torch.equal(got5, pa.paged_decode_attention(q, k5[1], v5[1],
                                                        table, lens)):
        raise AssertionError(f"{tag}: stacked decode differs from the "
                             "per-layer launch on its view")
    k_tail, v_tail = (torch.randn((3, 4, kv, d), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
    q_pos = (lens + torch.tensor([3, 0, 1], dtype=torch.int32,
                                 device=dev)).contiguous()
    tail = (q, kc, vc, table, lens, k_tail, v_tail, q_pos)
    held("decode tail", pa.paged_decode_tail_attention(*tail),
         pa.paged_decode_tail_attention_plain(*tail))

    rows = [(120, 24), (0, 0), (280, 20)]
    kv_lens = [s + n if n else 0 for s, n in rows]
    plens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    ptable = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    starts = torch.tensor([s if n else 0 for s, n in rows],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(24, dtype=torch.int32,
                                          device=dev)[None]).contiguous()
    qp = torch.randn((3, 24, nh, d), generator=gen, device=dev).to(dtype)
    args = (qp, kc, vc, ptable, pos, plens)
    held("prefill", paged_prefill_attention(*args),
         paged_prefill_attention_plain(*args, **p16))
    if group == 3 and ps == 16:
        # Checked after the sweep: the walk its launch ran.
        SWEEP_WALK_POINTS.append((str(dtype)[6:], int8, group, kv, d, 24,
                                  ps))

    rrows = [(130, 0), (0, -1), (300, 4)]
    rlens = torch.tensor([n for n, _ in rrows], dtype=torch.int32,
                         device=dev)
    last = torch.tensor([li for _, li in rrows], dtype=torch.int32,
                        device=dev)
    rtable = _page_table([n for n, _ in rrows], ps, max_pages, num_pages,
                         gen, dev)
    qr = torch.randn((3, 5, nh, d), generator=gen, device=dev).to(dtype)
    rargs = (qr, kc, vc, rtable, rlens, last)
    got = paged_ragged_attention(*rargs)
    held("ragged", got, paged_ragged_attention_plain(*rargs, **p16))
    if got[1].abs().max().item() != 0.0 or got[0, 1:].abs().max().item():
        raise AssertionError(f"{tag}: ragged dead slots are not 0")
    return worst


def _geometry_sweep(dev) -> dict:
    """The kernel sweep over dtype {bf16, f16, f32} x cache {same, int8}:
    group {1..8, 16} x head_dim {64, 80, 128} at page 16, and group {1,
    3, 4, 8} x head_dim {96, 100, 160, 256} and the slabs' {257, 288,
    320, 384, 448, 512, 576, 640, 1024} at pages 128 and 16
    (``_sweep_point``); the library's ``pstt_kernel_supports`` and
    ``pstt_decode_group_tile`` against the Python rule on every point,
    on every head_dim 0..1100 and on points outside it. Returns the
    largest error by form."""
    from production_stack_tpu_torch.ops import paged_kv_common as pkc
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        decode_group_tile)
    lib = pkc.kernel_lib()
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    t0 = time.perf_counter()
    grid = [(d, g, 16) for d in SWEEP_HEAD_DIMS for g in SWEEP_GROUPS]
    for dims, groups, pages in (SWEEP_PADDED, SWEEP_SLABS):
        grid += [(d, g, ps) for d in dims for g in groups for ps in pages]
    worst, points = {}, 0
    for dtype in SWEEP_DTYPES:
        for int8 in (False, True):
            cache = torch.int8 if int8 else dtype
            key = f"{str(dtype)[6:]}{'/int8' if int8 else ''}"
            for d, group, ps in grid:
                said = lib.pstt_kernel_supports(
                    pkc.dtype_code(dtype), pkc.cache_code(cache), group, d)
                if not (said and pkc.kernel_geometry_supported(
                        dtype, cache, group, d)):
                    raise AssertionError(f"{key} g{group} d{d}: the "
                                         f"library says {said}, the "
                                         "rule refuses or disagrees")
                if (lib.pstt_decode_group_tile(group, d)
                        != decode_group_tile(group, d)):
                    raise AssertionError(f"group tile of g{group} d{d}:"
                                         " library and host differ")
                try:
                    err = _sweep_point(dev, gen, dtype, int8, group, d, ps)
                except RuntimeError as e:
                    raise RuntimeError(f"sweep {key} g{group} d{d} ps{ps}: "
                                       f"{e}") from e
                worst[key] = max(worst.get(key, 0.0), err)
                points += 1
    for d in range(0, 1101):
        for dtype in SWEEP_DTYPES:
            for cache in (dtype, torch.int8):
                said = bool(lib.pstt_kernel_supports(
                    pkc.dtype_code(dtype), pkc.cache_code(cache), 3, d))
                if said != pkc.kernel_geometry_supported(dtype, cache, 3, d):
                    raise AssertionError(f"head_dim {d}, {dtype} over "
                                         f"{cache}: library {said}, the "
                                         "rule the other way")
        if pkc.kernel_head_dim_tile(d) is not None and any(
                lib.pstt_decode_group_tile(g, d) != decode_group_tile(g, d)
                for g in (1, 2, 3, 4, 5, 8, 16)):
            raise AssertionError(f"group tiles at head_dim {d}: library "
                                 "and host differ")
    for dtype, cache, group, d in SWEEP_REFUSED:
        rule = pkc.kernel_geometry_refusal(dtype, cache, group, d)
        said = lib.pstt_kernel_supports(pkc.cache_code(dtype),
                                        pkc.cache_code(cache or dtype),
                                        group, d)
        if rule is None or said:
            raise AssertionError(f"{dtype} {cache} g{group} d{d}: rule "
                                 f"{rule!r}, library {said}")
    torch.cuda.empty_cache()
    walks = {}
    for point, walk in zip(SWEEP_WALK_POINTS,
                           _prefill_walks_of(SWEEP_WALK_POINTS)):
        walks.setdefault(walk, set()).add(point[4])
    wide = {d for d in SWEEP_SLABS[0] if 256 < d <= 512}
    if (not wide <= walks.get("wgmma_wide", set())
            or not {d for d in SWEEP_SLABS[0] if d > 512}
            <= walks.get("mma_slab", set())):
        raise AssertionError(f"the sweep's prefill walks {walks}: 257 to "
                             "512 not all on the wide form, or above 512 "
                             "not all on the slab walk")
    log(f"geometries sweep: each prefill launch at group 3, page 16 "
        f"({len(SWEEP_WALK_POINTS)} points) ran the walk the plan names "
        f"(the library's launches of each walk's kernel); head dims by "
        f"walk " + json.dumps(
            {w: sorted(ds) for w, ds in sorted(walks.items())}))
    log(f"geometries sweep: {points} points x 7 launches (decode at the "
        f"wrapper's split and at one, stacked, tail; prefill; ragged), "
        f"each within tolerance of its plain version, in "
        f"{time.perf_counter() - t0:.1f} s; largest error by form {worst}; "
        f"the rule and pstt_kernel_supports agree on them, on every "
        f"head_dim 0..1100 (and pstt_decode_group_tile with the host), and "
        f"refuse {len(SWEEP_REFUSED)} points outside (head_dim 0 and -1, "
        f"int8 queries, a mixed cache, group 0)")
    return worst


def _geometry_kernel_cases(dev) -> tuple:
    """The new rows at the kernel phase's headline shapes (decode B =
    32, kv lens 1..1024; prefill B = 8, T = 512, first chunk; ragged R
    = 40, W = 512, the unified step), timed against the plain version,
    the bound and SDPA: Llama-3-70B's g8_d128 (bf16 and int8 KV),
    OPT-2.7b's g1_d80 (f16), Qwen2-0.5B's g7_d64 (f32), Llama-2-7B's
    g1_d128 (bf16), Falcon3-7B's g3_d256 (bf16 and int8 KV) and
    OpenLLaMA-3B's g1_d100 (f16, padded to the tile 128). Then the int8-weight kernel's f16 form at OPT-2.7b's
    projections, M = 1, 32 and 160 (timed at 32). Returns {kernel: {row:
    {form: case}}} and the int8-weight cases."""
    from production_stack_tpu_torch.engine.quantization import (
        dequant_matmul)
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        int8_weight_matmul, int8_weight_matmul_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    timer = Timer(dev)
    lens = np.linspace(1, 1024, 32).round().astype(int).tolist()
    lens[7] = lens[21] = 0
    first = [(0, n) for n in [512, 448, 384, 320, 256, 0, 128, 64]]
    decode_lens = np.linspace(70, 1024, 28).round().astype(int).tolist()
    unified = ([(n, 0) for n in decode_lens]
               + [(512, 511), (448, 447), (300, 299), (64, 63),
                  (700, 187), (612, 99), (1012, 499), (200, 199)]
               + [(0, -1)] * 4)
    out = {name: {} for name in KERNELS}
    for row, (nh, kv, d, dtype, forms) in GEOMETRY_ROWS.items():
        shape = dict(nh=nh, kv=kv, d=d)
        for int8 in forms:
            form = "int8" if int8 else str(dtype)[6:]
            tag = f"{row} {form}"
            cases = {
                "paged_decode": decode_case(
                    f"decode {tag} B=32 ps=128", 32, lens, 128, dtype, dev,
                    gen, timer, num_pages=512, int8=int8, **shape),
                "paged_prefill": prefill_case(
                    f"prefill {tag} B=8 T=512 first chunk ps=128", first,
                    512, 128, dtype, dev, gen, timer, int8=int8, **shape),
                "paged_ragged": ragged_case(
                    f"ragged {tag} unified R=40 W=512 ps=128", unified, 512,
                    128, dtype, dev, gen, timer, int8=int8, walk=True,
                    **shape),
            }
            for name, r in cases.items():
                log("geometries kernel case " + json.dumps(r))
                out[name].setdefault(row, {})[form] = r
            torch.cuda.empty_cache()
    # The walk each row's prefill launch runs (the launch of the timed
    # case at one row), and the rows above 256 on the wide form.
    points = [(str(dtype)[6:], form == "int8", nh // kv, kv, d, 512, 128)
              for row, (nh, kv, d, dtype, _) in GEOMETRY_ROWS.items()
              for form in out["paged_prefill"][row]]
    cases = [c for forms in out["paged_prefill"].values()
             for c in forms.values()]
    for point, case, walk in zip(points, cases, _prefill_walks_of(points)):
        case["walk"] = walk
        if point[4] in WIDE_ROWS and walk != "wgmma_wide":
            raise AssertionError(f"{case['case']}: ran the {walk} walk, "
                                 "not the wide form")
    log("geometries kernel prefill walks: " + json.dumps(
        {c["case"]: c["walk"] for c in cases}))
    # The walk each row's timed ragged launch ran (ragged_case held it
    # to the plan), held to the walk that serves its head dims
    # (RAGGED_ROW_WALKS); then a verify-shaped block (W = 5) at each
    # row's geometry, held to the plan; and PR 6's mma.sync walk at
    # bench-1b's, g4_d128's and g1_d64's, bf16 and int8, at both widths.
    cases = [(row, c) for row, forms in out["paged_ragged"].items()
             for c in forms.values()]
    for row, case in cases:
        want = RAGGED_ROW_WALKS.get(row)
        if want is not None and case["walk"] != want:
            raise AssertionError(f"{case['case']}: ran the {case['walk']} "
                                 f"walk, not {want}")
    points = [(str(dtype)[6:], form == "int8", nh // kv, kv, d, 128, 5)
              for row, (nh, kv, d, dtype, _) in GEOMETRY_ROWS.items()
              for form in out["paged_ragged"][row]]
    verify_walks = _ragged_walks_of(points)
    controls = [("bfloat16", int8, nh // kv, kv, d, 128, w)
                for nh, kv, d in RAGGED_MMA_CONTROLS.values()
                for int8 in (False, True) for w in (5, 512)]
    control_walks = _ragged_walks_of(controls)
    if set(control_walks) != {"mma"}:
        raise AssertionError(f"ragged at {list(RAGGED_MMA_CONTROLS)}: ran "
                             f"{control_walks}, not the mma.sync walk")
    log("geometries kernel ragged walks (unified R=40 W=512): " + json.dumps(
        {c["case"]: c["walk"] for _, c in cases}) + "; W=5: " + json.dumps(
        verify_walks) + "; bench-1b, g4_d128 and g1_d64 (bf16 and int8, "
        "W=5 and 512): " + json.dumps(control_walks))
    w8 = {}
    for proj, (k, n) in OPT27_PROJECTIONS.items():
        q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = (torch.rand((n,), generator=gen, device=dev) + 0.5) * (
            0.02 / 127)
        dense = (q.float() * scale[:, None]).half()
        err = 0.0
        for m in (1, 32, 160):
            x = torch.randn((m, k), generator=gen, device=dev).half()
            got = int8_weight_matmul(x, q, scale)
            want = int8_weight_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
            err = max(err, (got.float() - want.float()).abs().max().item())
            if not torch.equal(got, int8_weight_matmul(x, q, scale)):
                raise AssertionError("int8_weight_matmul f16: two launches "
                                     "gave different bits")
        x = torch.randn((32, k), generator=gen, device=dev).half()
        r = {"case": f"int8_weight_matmul f16 opt-2.7b {proj} M=32 K={k} "
                     f"N={n}", "max_abs_err": err,
             "ms": timer.ms(lambda: int8_weight_matmul(x, q, scale)),
             "plain_ms": timer.ms(
                 lambda: int8_weight_matmul_plain(x, q, scale)),
             "library_ms": timer.ms(lambda: torch.matmul(x, dense.t())),
             "dequant_ms": timer.ms(lambda: dequant_matmul(x, q, scale)),
             **_w8_bound(32, k, n)}
        log("geometries kernel case " + json.dumps(r))
        w8[proj] = r
    for name, by_row in out.items():
        for row, forms in by_row.items():
            log(f"geometries kernel {name} {row}: " + "; ".join(
                f"{form} {c['ms']:.5f} ms (median {c['median_ms']:.5f}, "
                f"bound {c['bound_ms']:.5f} by "
                f"{c['bound_by']}, SDPA {c['library_ms']:.5f}, plain "
                f"{c['plain_ms']:.4f}, max abs err {c['max_abs_err']:.3e})"
                for form, c in forms.items()) + f"; {SMI}")
    return out, w8


def _eager_batch(label, srv, prompts, graphed) -> None:
    """The prompts submitted together to an eager engine
    (``cuda_graphs=False``) over the server's params and configuration,
    as the window submitted them to the graphed server: every stream
    byte-identical to the server's."""
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    engine = LLMEngine(srv.engine.config, params=srv.engine.runner.params,
                       cuda_graphs=False)
    t0 = time.perf_counter()
    got = [list(s.output_token_ids) for s in engine.generate_batch(
        prompts, SamplingParams(temperature=0.0, max_tokens=WEIGHTS_OUT,
                                ignore_eos=True))]
    wall = time.perf_counter() - t0
    for i, (e, g) in enumerate(zip(got, graphed)):
        if e != g:
            raise AssertionError(f"{label}: request {i}, eager {e} against "
                                 f"graphed {g}")
    log(f"{label}: {len(prompts)}/{len(prompts)} streams byte-identical "
        f"eager and graphed, submitted together ({wall:.1f} s eager)")


def _geometry_server(label, path, extra, prompts, kv_dtype="bf16",
                     alone=True) -> dict:
    """A server on ``--model path`` (None: the bench-1b preset) with
    ``extra`` flags: the weights phase's window (16 greedy requests
    together, counted; then, with ``alone``, each alone), each attention
    call of the model check held to its plain version, and the requests
    again through an eager engine, submitted together, byte-identical to
    the window's. The model check's logits and where a batched stream
    parts from the request alone are printed."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    model = ["--model", path] if path else ["--model", "bench-1b",
                                            "--random-weights"]
    srv = _Server(model + ["--num-pages", str(GEOMETRY_PAGES)]
                  + FAMILY_SERVER_ARGS + extra, base=[])
    cfg = srv.engine.config
    log(f"{label}: server up in {time.perf_counter() - t0:.1f} s (the "
        f"load included); {cfg.model.architecture}, {cfg.model.dtype}, "
        f"{cfg.model.num_attention_heads} q / "
        f"{cfg.model.num_key_value_heads} kv heads of "
        f"{cfg.model.head_dim}, {cfg.model.num_hidden_layers} layers, KV "
        f"{cfg.cache.resolved_kv_dtype()}, quantization "
        f"{cfg.model.quantization}; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    run = _weights_window(label, srv, prompts,
                          form="_int8" if kv_dtype == "int8" else "",
                          alone=alone)
    with torch.inference_mode():
        _family_forwards(dev, cfg.model, srv.engine.runner.params, label,
                         kv_dtype, hold_logits=False)
    parted = []
    for i, (one, ids) in enumerate(zip(run.get("alone", ()), run["ids"])):
        flip = next((j for j, (x, y) in enumerate(zip(one, ids))
                     if x != y), None)
        if flip is not None:
            parted.append((i, flip, near_tie(srv.engine, prompts[i]
                                             + one[:flip], ids[flip])))
    if alone:
        log(f"{label}: {len(prompts) - len(parted)}/{len(prompts)} streams "
            f"byte-identical batched and alone, the others parting at "
            f"(row, index, the alone engine's margin) {parted}; {SMI}")
    _eager_batch(label, srv, prompts, run["ids"])
    srv.close()
    return run


def geometries_phase(vocab: int) -> dict:
    """Every query group, head_dim and dtype the JAX engine serves, on
    the three attention kernels: the kernel sweep, the timed rows, then
    five checkpoints written from published configs and served:
    Llama-3-70B (2 layers; bf16, then int8 KV), OPT-2.7b at float16,
    Qwen2-0.5B at float32, Falcon3-7B (1 layer, head_dim 256; bf16, then
    int8 KV) and OpenLLaMA-3B (2 layers, head_dim 100) at float16, and a
    written llama at head_dim 512 (bf16, then int8 KV);
    then bench-1b at --quantization int8 --dtype float16 (the
    int8-weight kernel's f16 form). Returns the timed cases, the
    int8-weight cases and each run's launches."""
    import gc
    import shutil
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"sweep": _geometry_sweep(dev)}
    out["rows"], out["w8"] = _geometry_kernel_cases(dev)
    torch.cuda.empty_cache()
    runs = {"llama3-70b": ((LLAMA70_RUN, [], "bf16"),
                           (LLAMA70_INT8_RUN,
                            ["--kv-cache-dtype", "int8"], "int8")),
            "opt-2.7b": ((OPT27_RUN, [], "bf16"),),
            "qwen2-0.5b": ((QWEN05_RUN, [], "bf16"),),
            "falcon3-7b": ((FALCON3_RUN, [], "bf16"),
                           (FALCON3_INT8_RUN,
                            ["--kv-cache-dtype", "int8"], "int8")),
            "open-llama-3b": ((OPEN_LLAMA_RUN, [], "bf16"),),
            "d512": ((D512_RUN, [], "bf16"),
                     (D512_INT8_RUN, ["--kv-cache-dtype", "int8"], "int8"))}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-geometries-")
    try:
        for model, served in runs.items():
            arch, dtype, flags, seed = GEOMETRY_MODELS[model]
            hf = GEOMETRY_CONFIGS[model]
            path = os.path.join(tmp, model)
            write_checkpoint(path, arch, seed, hf=hf, dtype=dtype)
            rng = np.random.RandomState(21)
            prompts = [rng.randint(258, hf["vocab_size"], size=n).tolist()
                       for n in np.linspace(64, 700, 16).round().astype(int)]
            for run, extra, kv_dtype in served:
                out[run] = _geometry_server(
                    f"geometries {run}", path, flags + extra, prompts,
                    kv_dtype, alone=model in GEOMETRY_ALONE)["launches"]
                gc.collect()
                torch.cuda.empty_cache()
            shutil.rmtree(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rng = np.random.RandomState(21)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 700, 16).round().astype(int)]
    out[W8_F16_RUN] = _geometry_server(
        f"geometries {W8_F16_RUN}", None,
        ["--quantization", "int8", "--dtype", "float16"],
        prompts)["launches"]
    if out[W8_F16_RUN].get("int8_weight_matmul", 0) <= 0:
        raise AssertionError("the int8 f16 server never launched the "
                             "int8-weight kernel")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"geometries: phase passed in {time.perf_counter() - t_phase:.1f} s"
        f"; {SMI}")
    return out


# ---- pages phase --------------------------------------------------------------

# The serving runs of the pages phase (``launches_by_run`` keys): bench-1b
# at page 256, per layer, bf16 KV; and at an int8 page of 8, stacked.
PAGES_256_RUN = "serve_page256"
PAGES_INT8_RUN = "serve_page8_int8_stacked"
PAGES_SERVERS = (
    (PAGES_256_RUN, ["--page-size", "256", "--num-pages", "256"], "bf16",
     "per_layer", ""),
    (PAGES_INT8_RUN, ["--page-size", "8", "--num-pages", "8192",
                      "--kv-cache-dtype", "int8", "--cache-layout",
                      "stacked"], "int8", "stacked", "_int8_stacked"))
# The sweep: every page size at bench-1b's geometry (group 4, head_dim
# 64) over bf16 and int8 caches; f16 at OPT-2.7b's (group 1, head_dim
# 80) and f32 at Qwen2-0.5B's (group 7, head_dim 64) at three of them.
PAGE_SWEEP = (1, 8, 12, 16, 24, 48, 96, 128, 200, 256, 384, 512)
PAGE_SWEEP_OTHER = ((torch.float16, 1, 80), (torch.float32, 7, 64))
PAGE_SWEEP_OTHER_PAGES = (8, 48, 256)
# Page sizes under one token: refused by the rule and by the library.
PAGE_REFUSED = (0, -16)
# The timed rows (bench-1b's headline shapes) by page size and caches;
# page 128 is the kernel phase's, re-timed in the same call.
PAGE_ROWS = ((128, (False, True)), (16, (False, True)),
             (256, (False, True)), (8, (True,)))
# The serving run (and its counters' form) whose launches each timed
# row reports: page 128 the main path's and the int8 run's, page 256
# and the int8 page of 8 this phase's servers; no run serves page 16.
PAGE_ROW_RUNS = {("ps128", "bf16"): (MAIN_RUN, ""),
                 ("ps128", "int8"): (INT8_RUN, "_int8"),
                 ("ps256", "bf16"): (PAGES_256_RUN, ""),
                 ("ps8", "int8"): (PAGES_INT8_RUN, "_int8_stacked")}


def _page_sweep_point(dev, gen, dtype, int8, group, d, ps) -> float:
    """Every kernel form at one page size, small shapes, two kv heads:
    decode over kv lens just before, at and after a page edge and the
    chunk edge, at 144, a row of several chunks and a pad row (per
    layer at the wrapper's split and at one, stacked at layer 1 of 2 and
    bitwise the per-layer launch on its view, the burst-tail form);
    prefill (T = 24 from a page edge, across the chunk edge and past a
    second chunk; a pad row); ragged (W = 5: a decode row at a page
    edge, a verify row across the chunk edge, a chunk row, a pad row).
    Each against its plain version; returns the largest error."""
    from production_stack_tpu_torch.ops import paged_attention_cuda as pa
    from production_stack_tpu_torch.ops.prefill_attention_cuda import (
        paged_prefill_attention, paged_prefill_attention_plain)
    from production_stack_tpu_torch.ops.ragged_attention_cuda import (
        paged_ragged_attention, paged_ragged_attention_plain)
    kv, nh = 2, 2 * group
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    p16 = {} if dtype == torch.float32 else {"p_dtype": dtype}
    tag = (f"pages ps={ps} {str(dtype)[6:]}{'/int8' if int8 else ''} "
           f"g{group} d{d}")
    lens_l = [max(ps - 1, 1), ps, ps + 1, 127, 128, 129, 144,
              max(600, 2 * ps + 7), 0]
    max_pages = -(-max(lens_l) // ps) + 1
    num_pages = len(lens_l) * max_pages + 1
    (kc, vc), _ = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    worst = 0.0

    def held(what, got, ref):
        nonlocal worst
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **tol,
                                   msg=lambda m: f"{tag} {what}: {m}")
        worst = max(worst, (got.float() - ref.float()).abs().max().item())

    b = len(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    table = _page_table(lens_l, ps, max_pages, num_pages, gen, dev)
    q = torch.randn((b, nh, d), generator=gen, device=dev).to(dtype)
    splits = pa.decode_splits(b, kv, max_pages, ps)
    if splits[0] < 2:
        raise AssertionError(f"{tag}: the decode split {splits} walks "
                             "one range")
    want = pa.paged_decode_attention_plain(q, kc, vc, table, lens,
                                           num_splits=splits[0])
    for n in (None, 1):
        got = pa.paged_decode_attention(q, kc, vc, table, lens,
                                        num_splits=n)
        held(f"decode splits={n}", got, want)
        if got[-1].abs().max().item() != 0.0:
            raise AssertionError(f"{tag}: the decode pad row is not 0")
    k5, v5 = (_stack_at(c, 2, 1, gen) for c in (kc, vc))
    got5 = pa.paged_decode_attention(q, k5, v5, table, lens, layer=1)
    held("decode stacked", got5, pa.paged_decode_attention_plain(
        q, k5, v5, table, lens, layer=1))
    if not torch.equal(got5, pa.paged_decode_attention(q, k5[1], v5[1],
                                                        table, lens)):
        raise AssertionError(f"{tag}: stacked decode differs from the "
                             "per-layer launch on its view")
    k_tail, v_tail = (torch.randn((b, 4, kv, d), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
    q_pos = (lens + torch.arange(b, dtype=torch.int32, device=dev) % 4
             ).contiguous()
    tail = (q, kc, vc, table, lens, k_tail, v_tail, q_pos)
    held("decode tail", pa.paged_decode_tail_attention(*tail),
         pa.paged_decode_tail_attention_plain(*tail))

    rows = [(max(ps - 5, 0), 24), (120, 24), (250, 20), (0, 0)]
    kv_lens = [s + n if n else 0 for s, n in rows]
    plens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    ptable = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    starts = torch.tensor([s if n else 0 for s, n in rows],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(24, dtype=torch.int32,
                                          device=dev)[None]).contiguous()
    qp = torch.randn((4, 24, nh, d), generator=gen, device=dev).to(dtype)
    args = (qp, kc, vc, ptable, pos, plens)
    got = paged_prefill_attention(*args)
    held("prefill", got, paged_prefill_attention_plain(*args, **p16))
    if got[-1].abs().max().item() != 0.0:
        raise AssertionError(f"{tag}: the prefill pad row is not 0")

    rrows = [(ps, 0), (130, 4), (300, 4), (0, -1)]
    rlens = torch.tensor([n for n, _ in rrows], dtype=torch.int32,
                         device=dev)
    last = torch.tensor([li for _, li in rrows], dtype=torch.int32,
                        device=dev)
    rtable = _page_table([n for n, _ in rrows], ps, max_pages, num_pages,
                         gen, dev)
    qr = torch.randn((4, 5, nh, d), generator=gen, device=dev).to(dtype)
    rargs = (qr, kc, vc, rtable, rlens, last)
    got = paged_ragged_attention(*rargs)
    held("ragged", got, paged_ragged_attention_plain(*rargs, **p16))
    if got[-1].abs().max().item() != 0.0 or got[0, 1:].abs().max().item():
        raise AssertionError(f"{tag}: ragged dead slots are not 0")
    return worst


def _page_sweep(dev) -> dict:
    """The sweep over page sizes (``_page_sweep_point``), and the
    library's ``pstt_page_size_supported`` against the Python rule at
    every point and at pages under one token. Returns the largest error
    by form."""
    from production_stack_tpu_torch.ops import paged_kv_common as pkc
    lib = pkc.kernel_lib()
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    t0 = time.perf_counter()
    points = [(torch.bfloat16, int8, 4, 64, ps) for ps in PAGE_SWEEP
              for int8 in (False, True)]
    points += [(dtype, int8, group, d, ps)
               for dtype, group, d in PAGE_SWEEP_OTHER
               for ps in PAGE_SWEEP_OTHER_PAGES for int8 in (False, True)]
    worst = {}
    for dtype, int8, group, d, ps in points:
        cache = torch.int8 if int8 else dtype
        said = lib.pstt_page_size_supported(ps)
        if not (said and pkc.kernel_page_size_supported(ps)):
            raise AssertionError(f"page {ps}: the library says {said}, the "
                                 "rule refuses or disagrees")
        key = f"{str(dtype)[6:]}{'/int8' if int8 else ''}"
        worst[key] = max(worst.get(key, 0.0), _page_sweep_point(
            dev, gen, dtype, int8, group, d, ps))
    for ps in PAGE_REFUSED:
        said = lib.pstt_page_size_supported(ps)
        if said or pkc.kernel_page_size_refusal(ps) is None:
            raise AssertionError(f"page {ps}: the library says {said}, the "
                                 f"rule {pkc.kernel_page_size_refusal(ps)!r}")
    torch.cuda.empty_cache()
    log(f"pages sweep: {len(points)} points x 7 launches (decode at the "
        f"wrapper's split and at one, stacked, tail; prefill; ragged) at "
        f"pages {PAGE_SWEEP}, each within tolerance of its plain version, "
        f"in {time.perf_counter() - t0:.1f} s; largest error by form "
        f"{worst}; the rule and pstt_page_size_supported agree on them and "
        f"refuse pages {PAGE_REFUSED}")
    return worst


def _page_kernel_cases(dev) -> dict:
    """bench-1b's headline cases at each page size of ``PAGE_ROWS`` (page
    128 again beside the others, in this call): decode B = 32, kv lens
    1..1024; prefill B = 8, T = 512, first and second chunk; ragged R =
    40, W = 512, the unified step; bf16 and int8 caches (the int8 page
    of 8: decode and prefill). Returns {kernel: {"ps<P>": {form:
    case}}}, the second chunk under ``paged_prefill_second``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    timer = Timer(dev)
    rows = _headline_rows()
    out = {name: {} for name in list(KERNELS) + ["paged_prefill_second"]}

    bf16 = torch.bfloat16
    for ps, forms in PAGE_ROWS:
        for int8 in forms:
            form = "int8" if int8 else "bf16"
            tag = f"{'bf16/int8' if int8 else 'bf16'} ps={ps}"
            cases = {
                "paged_decode": decode_case(
                    f"decode {tag} B=32", 32, rows["lens"], ps, bf16, dev,
                    gen, timer, num_pages=512 * 128 // ps, int8=int8),
                "paged_prefill": prefill_case(
                    f"prefill {tag} B=8 T=512 first chunk", rows["first"],
                    512, ps, bf16, dev, gen, timer, int8=int8),
                "paged_prefill_second": prefill_case(
                    f"prefill {tag} B=8 T=512 second chunk", rows["second"],
                    512, ps, bf16, dev, gen, timer, int8=int8),
            }
            if ps != 8:
                cases["paged_ragged"] = ragged_case(
                    f"ragged {tag} unified R=40 W=512", rows["unified"],
                    512, ps, bf16, dev, gen, timer, int8=int8)
            for name, r in cases.items():
                log("pages kernel case " + json.dumps(r))
                out[name].setdefault(f"ps{ps}", {})[form] = r
            torch.cuda.empty_cache()
    for name, by_page in out.items():
        for page, forms in by_page.items():
            log(f"pages kernel {name} {page}: " + "; ".join(
                f"{form} {c['ms']:.5f} ms (bound {c['bound_ms']:.5f} by "
                f"{c['bound_by']}, SDPA {c['library_ms']:.5f}, plain "
                f"{c['plain_ms']:.4f}, max abs err {c['max_abs_err']:.3e})"
                for form, c in forms.items()) + f"; {SMI}")
    return out


def _pages_server(label, extra, prompts, kv_dtype, layout, form) -> dict:
    """bench-1b with ``extra`` page flags and the families phase's
    flags: the 16 greedy requests submitted together, once as a
    warm-up, then counted (tok/s; the three kernels launched in the
    run's form, no plain call, no eager step, no capture in the
    window), each attention call of the model check over a cache of the
    server's page size and layout held to its plain version, and the
    requests again through an eager engine, byte-identical to the
    graphed streams."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    srv = _Server(["--model", "bench-1b", "--random-weights"]
                  + FAMILY_SERVER_ARGS + extra, base=[])
    cfg = srv.engine.config
    log(f"{label}: server up in {time.perf_counter() - t0:.1f} s; page "
        f"{cfg.cache.page_size}, {cfg.cache.num_pages} pages, KV "
        f"{cfg.cache.resolved_kv_dtype()}, layout "
        f"{srv.engine.runner.cache_layout}; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    run = _weights_window(label, srv, prompts, form=form, alone=False)
    with torch.inference_mode():
        _family_forwards(dev, cfg.model, srv.engine.runner.params, label,
                         kv_dtype, hold_logits=False,
                         page_size=cfg.cache.page_size, layout=layout)
    _eager_batch(label, srv, prompts, run["ids"])
    srv.close()
    log(f"{label}: {run['tok_s']:.1f} tok/s; {SMI}")
    return run


def pages_phase(vocab: int) -> dict:
    """Every page size the JAX engine serves, on the three attention
    kernels: the sweep, the timed rows at pages 16, 256 and an int8 page
    of 8 beside page 128, then bench-1b served at page 256 (per layer,
    bf16 KV) and at an int8 page of 8 (stacked). Returns the sweep's
    errors, the timed cases and each run's launches."""
    import gc
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"sweep": _page_sweep(dev), "rows": _page_kernel_cases(dev)}
    torch.cuda.empty_cache()
    rng = np.random.RandomState(21)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 700, 16).round().astype(int)]
    for run, extra, kv_dtype, layout, form in PAGES_SERVERS:
        out[run] = _pages_server(f"pages {run}", extra, prompts, kv_dtype,
                                 layout, form)["launches"]
        gc.collect()
        torch.cuda.empty_cache()
    log(f"pages: phase passed in {time.perf_counter() - t_phase:.1f} s; "
        f"{SMI}")
    return out


# ---- tp phase -----------------------------------------------------------------

# The decode kernel's burst-tail form: its entry in the ``kernels``
# line, and the run whose launches it reports (the deferred server's
# window: its own path).
TAIL_KERNEL = dict(
    route="cuda",
    source="production_stack_tpu_torch/csrc/paged_decode.cu",
    replaces="production_stack_tpu/ops/paged_attention_pallas.py:147")
DEFERRED_RUN = "serve_deferred"
TP_RUN = "serve_tp2_gloo"
NCCL_RUN = "engine_tp1_nccl"
TAIL_SLOTS = 4
# (name, q heads, kv heads, head_dim) of the tail form's cases: bench-1b,
# the head_dim-128 geometry, and one tp-2 rank of bench-1b (untimed).
TAIL_GEOMETRIES = (("bench_1b", 32, 8, 64), ("g4_d128", 32, 8, 128),
                   ("tp2_rank", 16, 4, 64))
TAIL_FORMS = {"bf16": (False, None), "int8": (True, None),
              "stacked": (False, STACK), "int8_stacked": (True, STACK)}
# Alternating, the first run of the process (cold) an ``off`` one.
DEFERRED_MODES = ("off", "auto", "auto", "off", "off", "auto")


def tail_case(name, b, kv_lens, ps, dtype, dev, gen, timer=None, nh=32,
              kv=8, d=64, max_len=1024, int8=False, stack=None,
              s_len=TAIL_SLOTS):
    """The decode kernel's tail form against its plain version: rows
    at kv_lens[i] cached tokens with a burst tail of ``s_len`` slots,
    each row frozen after a random number of them (its query position
    kv_len + 0 .. s_len - 1). Timed beside the non-tail form over the
    same pages, the plain version and SDPA over the dense pages and the
    tail."""
    from production_stack_tpu_torch.ops import paged_attention_cuda as pa
    max_pages = max_len // ps
    num_pages = b * max_pages + 1
    (kc, vc), dense = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    q = torch.randn((b, nh, d), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    table = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    k_tail = torch.randn((b, s_len, kv, d), generator=gen,
                         device=dev).to(dtype)
    v_tail = torch.randn((b, s_len, kv, d), generator=gen,
                         device=dev).to(dtype)
    live = torch.randint(1, s_len + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    q_pos = (lens + live - 1).contiguous()
    args = (q, kc, vc, table, lens, k_tail, v_tail, q_pos)
    call, view, offset = _form(name, args, stack, gen)
    got = call(pa.paged_decode_tail_attention)
    ref = call(pa.paged_decode_tail_attention_plain)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    _check_view(name, got, view, pa.paged_decode_tail_attention)
    again = call(pa.paged_decode_tail_attention)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    out = {"case": name, "max_abs_err": err, "tail_slots": s_len,
           "live_slots": int(live.sum())}
    if timer is None:
        return out
    esz = q.element_size()
    tokens = int(lens.sum())
    entries = sum(-(-n // ps) for n in kv_lens)
    # Pages of each row's cached tokens, the whole tail (read once), q,
    # the output, the live table entries, kv_lens and the positions.
    nbytes = (2 * tokens * kv * _kv_slot_bytes(d, esz, int8)
              + 2 * b * s_len * kv * d * esz + 2 * q.numel() * esz
              + entries * 4 + 2 * b * 4)
    flops = 4 * nh * d * (tokens + int(live.sum()))
    kmax = max(kv_lens)
    group = nh // kv
    kd = torch.cat([_dense_kv(dense[0], table, kmax, group),
                    k_tail.permute(0, 2, 1, 3).repeat_interleave(group, 1)],
                   dim=2)
    vd = torch.cat([_dense_kv(dense[1], table, kmax, group),
                    v_tail.permute(0, 2, 1, 3).repeat_interleave(group, 1)],
                   dim=2)
    pos = torch.arange(kmax + s_len, device=dev)[None, :]
    mask = torch.where(pos < kmax, pos < lens[:, None].long(),
                       pos - kmax < live[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    decode_args = args[:5]
    decode_call = (lambda fn: fn(*decode_args)) if stack is None else (
        lambda fn: call(lambda *a, **k: fn(*a[:5], **k)))
    out.update(
        ms=timer.ms(lambda: call(pa.paged_decode_tail_attention)),
        decode_ms=timer.ms(lambda: decode_call(pa.paged_decode_attention)),
        plain_ms=timer.ms(lambda: call(pa.paged_decode_tail_attention_plain),
                          iters=5),
        library_ms=timer.ms(lambda: sdpa(qd, kd, vd, attn_mask=mask)),
        **_bound(nbytes, flops))
    return out


def _tail_kernel_cases(dev) -> dict:
    """{geometry: {form: case}} of the tail form; the tp-2 rank's
    geometry checked untimed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    timer = Timer(dev)
    kv_lens = np.linspace(1, 1024 - 128, 32).round().astype(int).tolist()
    kv_lens[3] = 0  # a pad row
    cases = {}
    for geo, nh, kv, d in TAIL_GEOMETRIES:
        cases[geo] = {}
        for form, (int8, stack) in TAIL_FORMS.items():
            name = f"decode tail {geo} {form} B=32 S={TAIL_SLOTS}"
            case = tail_case(name, 32, kv_lens, 128, torch.bfloat16, dev,
                             gen, None if geo == "tp2_rank" else timer,
                             nh=nh, kv=kv, d=d, int8=int8, stack=stack)
            cases[geo][form] = case
            log(f"{name}: max abs err {case['max_abs_err']:.3g}"
                + ("" if "ms" not in case else
                   f"; {case['ms']:.4f} ms (non-tail form "
                   f"{case['decode_ms']:.4f}), bound {case['bound_ms']:.4f}"
                   f" ({case['bound_by']}), plain {case['plain_ms']:.3f}, "
                   f"SDPA {case['library_ms']:.4f}"))
    return cases


def _tail_against_flushed_pages(dev) -> dict:
    """The tail form against the non-tail form over the same pages with
    the tail flushed into them (``write_to_pages``, the deferred burst's
    own flush): what an eager burst reads at the same step. bench-1b
    bf16, per layer and stacked, B = 32 with kv lens from 0 to 896
    (half of them under 16 tokens, some crossing a page in the tail),
    each row frozen after 1..S slots; held to the bf16 tolerance. The
    non-tail form over one position fewer must miss that tolerance on
    the short rows, so a tail slot masked one position off would
    show."""
    from production_stack_tpu_torch.ops import paged_attention_cuda as pa
    from production_stack_tpu_torch.ops.attention import write_to_pages
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    b, nh, kv, d, ps, s_len = 32, 32, 8, 64, 128, TAIL_SLOTS
    kv_lens = ([0, 1, 2, 3, 5, 8, 11, 15] + [126, 127, 125, 124]
               + [16 * i for i in range(1, 9)]
               + np.linspace(300, 896, 12).round().astype(int).tolist())
    short = torch.tensor([n < 16 for n in kv_lens], device=dev)
    max_pages = 1024 // ps
    num_pages = b * max_pages + 1
    (kc, vc), _ = _caches(kv, num_pages, d, ps, torch.bfloat16, dev, gen,
                          False)
    q = torch.randn((b, nh, d), generator=gen, device=dev).bfloat16()
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    table = _page_table([n + s_len for n in kv_lens], ps, max_pages,
                        num_pages, gen, dev)
    k_tail, v_tail = (torch.randn((b, s_len, kv, d), generator=gen,
                                  device=dev).bfloat16() for _ in range(2))
    live = torch.randint(1, s_len + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    q_pos = (lens + live - 1).contiguous()
    slots = torch.arange(s_len, device=dev, dtype=torch.int32)[None, :]
    positions = lens[:, None] + slots
    valid = slots < live[:, None]
    kf, vf = kc.clone(), vc.clone()
    write_to_pages(kf, k_tail, table, positions, valid)
    write_to_pages(vf, v_tail, table, positions, valid)
    out = {}
    for form, stack in (("bf16", None), ("stacked", STACK)):
        name = f"decode tail vs flushed pages bench_1b {form}"
        call, _, _ = _form(name, (q, kc, vc, table, lens, k_tail, v_tail,
                                  q_pos), stack, gen)
        got = call(pa.paged_decode_tail_attention)
        flushed, _, _ = _form(name, (q, kf, vf, table, q_pos + 1), stack,
                              gen)
        want = flushed(pa.paged_decode_attention)
        shifted, _, _ = _form(name, (q, kf, vf, table, q_pos), stack, gen)
        off_by_one = shifted(pa.paged_decode_attention)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL,
                                   msg=lambda m: f"{name}: {m}")
        gap = (got.float() - off_by_one.float()).abs()[short].max().item()
        if torch.allclose(got.float()[short], off_by_one.float()[short],
                          **BF16_TOL):
            raise AssertionError(f"{name}: one position fewer is within "
                                 f"the tolerance ({gap}): the check "
                                 "could not see a mask one slot off")
        out[form] = {"max_abs_err": err, "off_by_one_gap": gap}
        log(f"{name}: B={b} S={s_len}, max abs err {err:.3g} against the "
            f"non-tail form over the flushed pages; one position fewer "
            f"differs by up to {gap:.3g} on the short rows")
    return out


def _deferred_engines(vocab) -> dict:
    """bench-1b at --decode-steps 4 through LLMEngine, the 16 greedy
    requests added at once (one fixed batch, no request timing): off
    twice, byte-identical (the card's kernels are deterministic, so
    servers that part with deferred writes off part through batch
    composition); auto once, each stream equal to off's or parting at a
    near tie of off's engine (``check_stream``). Returns the flips."""
    from production_stack_tpu_torch.engine.server import (
        build_engine_from_args)
    requests = _greedy_requests(vocab)
    streams, ref = {}, None
    for label, mode in (("off", "off"), ("off again", "off"),
                        ("auto", "auto")):
        engine, _ = build_engine_from_args(_tp_engine_args(
            ["--decode-steps", "4", "--deferred-kv-writes", mode]))
        if engine.config.scheduler.deferred_kv_writes != (mode == "auto"):
            raise AssertionError(f"deferred engine {mode}: resolved "
                                 f"{engine.config.scheduler}")
        streams[label] = _engine_streams(engine, requests)
        if ref is None:
            ref = engine
        else:
            del engine
        torch.cuda.empty_cache()
    if streams["off again"] != streams["off"]:
        raise AssertionError("deferred off: two engines on one fixed batch "
                             "gave different streams")
    flips = [check_stream("deferred engine auto", f"request {i}", ref,
                          r["prompt"], w, g)
             for i, (r, w, g) in enumerate(zip(requests, streams["off"],
                                               streams["auto"]))]
    flips = [(i,) + f for i, f in enumerate(flips) if f is not None]
    log(f"deferred KV writes through LLMEngine, one fixed batch ({SMI}): "
        f"off twice byte-identical; auto {len(requests) - len(flips)}/"
        f"{len(requests)} streams byte-identical to off, flips at near "
        f"ties (request, token, margin) {flips}")
    del ref
    torch.cuda.empty_cache()
    return {"flips": flips, "streams": len(requests)}


def _greedy_requests(vocab, seed=0):
    """The serving phase's 16 prompts, every one greedy."""
    rng = np.random.RandomState(seed)
    return [{"model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
             "temperature": 0.0,
             "prompt": rng.randint(258, vocab, size=int(n)).tolist()}
            for n in np.linspace(64, 700, 16).round().astype(int)]


# The tail form's other cache forms, each served by one deferred server
# (run name suffix, extra flags).
DEFERRED_FORMS = (("int8", ["--kv-cache-dtype", "int8"]),
                  ("stacked", ["--cache-layout", "stacked"]),
                  ("int8_stacked", ["--kv-cache-dtype", "int8",
                                    "--cache-layout", "stacked"]))


def _deferred_window(mode, extra, requests, form=""):
    """One bench-1b server with --decode-steps 4 --deferred-kv-writes
    ``mode`` (and ``extra`` flags), warmed by an untimed round of
    ``requests`` (its graphs captured), then timed on a second: returns
    (the run's measures, the stopped server, kept for ``near_tie``).
    auto must launch the tail form in ``form`` (a counter suffix) and
    off the non-tail form, and no plain version may run on the card."""
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    srv = _Server(["--decode-steps", "4", "--deferred-kv-writes", mode]
                  + extra)
    runner = srv.engine.runner
    walls = []
    run_decode = runner.run_decode

    def timed(plan):
        t0 = time.perf_counter()
        out = run_decode(plan)
        walls.append(time.perf_counter() - t0)
        return out

    runner.run_decode = timed
    if srv.engine.config.scheduler.deferred_kv_writes != (mode == "auto"):
        raise AssertionError(f"deferred {mode}: resolved "
                             f"{srv.engine.config.scheduler}")

    def post_all():
        with ThreadPoolExecutor(len(requests)) as pool:
            return list(pool.map(
                lambda b: _post(srv.url + "/v1/completions", b), requests))

    post_all()  # warm: every graph key of the window captured
    torch.cuda.synchronize()
    walls.clear()
    COUNTERS.reset()
    captures = sum(runner.graphs.captures.values())
    t0 = time.perf_counter()
    answers = post_all()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(COUNTERS.launches)
    new_captures = sum(runner.graphs.captures.values()) - captures
    ids = [list(t[len(r["prompt"]):]) for r, t in zip(
        requests, [next(t for t in reversed(srv.finished)
                        if t[:len(r["prompt"])] == r["prompt"])
                   for r in requests])]
    srv.stop()
    kernel = ("paged_decode_tail" if mode == "auto"
              else "paged_decode") + form
    tails = {k for k in launches if k.startswith("paged_decode_tail")}
    if not launches.get(kernel) or tails - {kernel}:
        raise AssertionError(f"deferred {mode} {form}: launches {launches}")
    if any(COUNTERS.plain_cuda_calls.values()):
        raise AssertionError(f"deferred {mode}: plain calls on CUDA "
                             f"tensors {COUNTERS.plain_cuda_calls}")
    tokens = sum(r["max_tokens"] for r in requests)
    run = {"mode": mode, "launches": launches, "answers": answers,
           "ids": ids, "tok_s": tokens / wall,
           "burst_ms": 1e3 * float(np.mean(walls)) if walls else 0.0,
           "bursts": len(walls)}
    log(f"deferred {mode}{form} K=4 ({SMI}): {len(requests)} requests, "
        f"{tokens} tokens in {wall:.3f} s ({run['tok_s']:.1f} tok/s); "
        f"{len(walls)} burst dispatches of {run['burst_ms']:.3f} ms mean "
        f"host wall; captures in the window {new_captures}; launches "
        f"{launches}")
    return run, srv


def _deferred_servers(vocab) -> dict:
    """bench-1b with --decode-steps 4 and --deferred-kv-writes auto (on:
    the burst's KV through tails the decode kernel reads) and off, in
    DEFERRED_MODES' order (``_deferred_window``): every greedy stream
    equals the first off server's, or equals it up to a first flip at a
    near tie of that server's engine (``check_stream``: the tail is one
    more split of the softmax, so the sums run in another order); the
    stochastic streams (the same draws) counted; each run's tok/s and
    its burst dispatches' mean host wall (dispatch and read). Then one
    auto server for each other cache form of the tail
    (DEFERRED_FORMS), its launches counted."""
    rng = np.random.RandomState(0)
    requests = []
    for i, n in enumerate(np.linspace(64, 700, 16).round().astype(int)):
        body = {"model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
                "prompt": rng.randint(258, vocab, size=n).tolist()}
        body.update({"temperature": 0.0} if i % 2 == 0 else
                    {"temperature": 0.8, "top_p": 0.95})
        requests.append(body)
    runs, ref = [], None
    for mode in DEFERRED_MODES:
        run, srv = _deferred_window(mode, [], requests)
        runs.append(run)
        if ref is None:
            ref = srv
        else:
            srv.close()
    n = len(requests)
    flips, stochastic_same = [], {"off": 0, "auto": 0}
    for run in runs[1:]:
        for i, body in enumerate(requests):
            if body["temperature"] != 0.0:
                stochastic_same[run["mode"]] += (
                    run["ids"][i] == runs[0]["ids"][i])
                continue
            flip = check_stream(f"deferred {run['mode']}", f"request {i}",
                                ref.engine, body["prompt"], runs[0]["ids"][i],
                                run["ids"][i])
            if flip is not None:
                flips.append((run["mode"], i) + flip)
    ref.close()
    summary = {m: {"tok_s": [r["tok_s"] for r in runs if r["mode"] == m],
                   "burst_ms": [r["burst_ms"] for r in runs
                                if r["mode"] == m]}
               for m in ("off", "auto")}
    greedy = sum(b["temperature"] == 0.0 for b in requests)
    log(f"deferred KV writes, bench-1b K=4, {SMI}: off {summary['off']}, "
        f"auto {summary['auto']}; greedy streams against the first off "
        f"server's: {greedy * (len(runs) - 1) - len(flips)}/"
        f"{greedy * (len(runs) - 1)} byte-identical, flips at near ties "
        f"(mode, request, token, margin) {flips}; stochastic streams "
        f"identical: off {stochastic_same['off']}/"
        f"{(n - greedy) * (DEFERRED_MODES.count('off') - 1)}, auto "
        f"{stochastic_same['auto']}/"
        f"{(n - greedy) * DEFERRED_MODES.count('auto')}")
    forms = {}
    for form, extra in DEFERRED_FORMS:
        run, srv = _deferred_window("auto", extra, requests, "_" + form)
        srv.close()
        forms[form] = run["launches"]
    auto = next(r for r in runs if r["mode"] == "auto")
    return {"launches": auto["launches"], "summary": summary,
            "flips": flips, "forms": forms}


def _engine_streams(engine, requests) -> list:
    """Every request's output ids, the engine driven to the end."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    seqs = [engine.sequences[engine.add_request(
        list(r["prompt"]), SamplingParams(
            temperature=0.0, max_tokens=r["max_tokens"], ignore_eos=True))]
        for r in requests]
    while engine.has_work() or engine._in_flight is not None:
        engine.step()
    return [list(s.output_token_ids) for s in seqs]


def _tp_engine_args(extra=()):
    from production_stack_tpu_torch.engine.server import parse_args
    return parse_args(SERVER_ARGS + list(extra))


def _nccl_world_of_one(requests) -> dict:
    """The tp runner over a one-rank NCCL group, graphs on, against the
    non-tp engine of the same flags: byte-identical streams (a one-rank
    reduce is the identity), and every captured graph holding its
    collectives."""
    import torch.distributed as dist
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.server import (
        build_engine_from_args)
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    from production_stack_tpu_torch.parallel.collectives import (
        TPGroup, init_mesh_groups)
    from production_stack_tpu_torch.parallel.distributed import free_port
    ref, _ = build_engine_from_args(_tp_engine_args())
    want = _engine_streams(ref, requests)
    config, tokenizer = ref.config, ref.tokenizer
    del ref
    torch.cuda.empty_cache()
    init_mesh_groups(0, "nccl", f"tcp://127.0.0.1:{free_port()}",
                     torch.device("cuda", 0))
    group = TPGroup(0, 1, "nccl")
    try:
        engine = LLMEngine(config, tokenizer=tokenizer, device="cuda",
                           tp=group)
        COUNTERS.reset()
        got = _engine_streams(engine, requests)
        torch.cuda.synchronize()
        launches = dict(COUNTERS.launches)
        recorded = engine.runner.graphs.recorded_launches()
        captures = dict(engine.runner.graphs.captures)
        eager = dict(engine.runner.graphs.eager_steps)
    finally:
        dist.destroy_process_group()
    if got != want:
        raise AssertionError("tp over a one-rank NCCL group: streams "
                             "differ from the non-tp engine's")
    bare = [key for key, counts in recorded.items()
            if not counts.get("tp_all_reduce")
            or not counts.get("tp_all_gather")]
    if bare or any(eager.values()) or not launches.get("tp_all_reduce"):
        raise AssertionError(f"tp NCCL: graphs without their collectives "
                             f"{bare}, eager steps {eager}, launches "
                             f"{launches}")
    log(f"tp NCCL world 1, graphs on: {len(requests)} streams byte-identical "
        f"to the non-tp engine; {len(recorded)} graphs captured ({captures}),"
        f" each with its all-reduces and its logits gather; launches "
        f"{launches}")
    del engine
    torch.cuda.empty_cache()
    return launches


def _gloo_tp2(requests) -> dict:
    """bench-1b at tp 2: two ranks on cuda:0 over gloo, started as the
    server starts them (the backend named, graphs off), against the
    tp-1 engine of the same flags: greedy streams equal up to a first
    flip at a near tie of the tp-1 engine (bf16 sums in another order);
    each rank's kernels counted."""
    from production_stack_tpu_torch.engine.server import (
        build_engine_from_args)
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    ref, _ = build_engine_from_args(_tp_engine_args())
    want = _engine_streams(ref, requests)
    engine, _ = build_engine_from_args(
        _tp_engine_args(["--tensor-parallel-size", "2"]),
        devices=["cuda:0", "cuda:0"], tp_backend="gloo")
    runtime = engine.tp_runtime
    try:
        shard = engine.runner.shard_config
        if engine.runner.graphs is not None or (
                shard.num_attention_heads, shard.num_key_value_heads) != (
                    16, 4):
            raise AssertionError(f"tp 2: graphs {engine.runner.graphs}, "
                                 f"rank heads {shard}")
        COUNTERS.reset()
        t0 = time.perf_counter()
        got = _engine_streams(engine, requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(COUNTERS.launches)
    finally:
        engine.close()
    flips = [check_stream("tp 2 gloo", f"request {i}", ref, r["prompt"],
                          w, g)
             for i, (r, w, g) in enumerate(zip(requests, want, got))]
    whole = sum(f is None for f in flips)
    workers = runtime.worker_launches
    for rank, counts in [(0, launches)] + sorted(workers.items()):
        for kernel in KERNELS:
            if counts.get(kernel, 0) <= 0:
                raise AssertionError(f"tp 2 gloo: rank {rank} never "
                                     f"launched {kernel}: {counts}")
    if len(workers) != 1 or launches != workers[1]:
        raise AssertionError(f"tp 2 gloo: rank launches differ: rank 0 "
                             f"{launches}, workers {workers}")
    tokens = sum(r["max_tokens"] for r in requests)
    log(f"tp 2 over gloo on one card ({SMI}): {whole}/{len(requests)} "
        f"greedy streams byte-identical to tp 1, flips at near ties "
        f"{[f for f in flips if f]}; {tokens} tokens in {wall:.3f} s "
        f"(eager, host-staged collectives: not a speed); launches a rank "
        f"{launches}")
    del ref
    torch.cuda.empty_cache()
    return launches


def tp_phase(vocab: int) -> dict:
    """Tensor parallelism and deferred KV writes on the card: the tail
    form of the decode kernel, the deferred servers, the one-rank NCCL
    tp runner inside the graphs, and tp 2 over gloo on one card."""
    dev = torch.device("cuda", 0)
    cases = _tail_kernel_cases(dev)
    flushed = _tail_against_flushed_pages(dev)
    torch.cuda.empty_cache()
    engines = _deferred_engines(vocab)
    deferred = _deferred_servers(vocab)
    torch.cuda.empty_cache()
    requests = _greedy_requests(vocab)
    nccl = _nccl_world_of_one(requests)
    tp2 = _gloo_tp2(requests)
    out = {"cases": cases, DEFERRED_RUN: deferred["launches"],
           "deferred": deferred["summary"], "flushed": flushed,
           "deferred_engines": engines, NCCL_RUN: nccl, TP_RUN: tp2}
    for form, counts in deferred["forms"].items():
        out[f"{DEFERRED_RUN}_{form}"] = counts
    return out


# ---- parallel2 phase: pipeline and context parallelism ----------------------

PP_RUN = "serve_pp2_gloo"  # rank 0 of the pp-2 engine's window
PP_INT8_RUN = "serve_pp2_int8_gloo"  # the same with int8 KV
CP_RUN = "serve_cp2_gloo"  # rank 0 of the cp-2 engine's window
GPT2_PP_RUN = "engine_gpt2_pp2_gloo"
GPT2_CP_RUN = "engine_gpt2_cp2_gloo"
RING_T = 8192  # tokens of the ring check, RING_T / 2 a rank
CP_ARGS = ["--max-model-len", "8192", "--long-prefill-threshold", "1024"]
CP_LONG = 4096  # tokens of each of the cp window's two long prompts
PAR_DEVICES = ["cuda:0", "cuda:0"]  # two ranks sharing the card
# The cp window's tok/s as this script recorded it while the unified
# blocks ran replicated on each sp rank (an H100 80GB HBM3 at 700 W):
# printed beside the split form's, a record, not this run's figure.
CP_REPLICATED_TOK_S = 184.3


def _ring_check(dev) -> dict:
    """``ring_attention`` over a two-rank sp group on cuda:0 (two fake
    ranks, one thread each, exchanging card tensors) against
    ``ring_attention_dense`` at bench-1b's heads (32 q / 8 kv of 64),
    f32, T = 8192 causal: within F32_TOL."""
    from production_stack_tpu_torch.ops.ring_attention import (
        ring_attention, ring_attention_dense)
    from production_stack_tpu_torch.parallel.collectives import (
        FakeTPGroup, run_ranks)
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = (torch.randn((1, RING_T, h, 64), generator=gen, device=dev)
               for h in (32, 8, 8))
    half = RING_T // 2

    def ring():
        outs = run_ranks(FakeTPGroup.world(2, axis="sp"), lambda g: (
            ring_attention(*(x[:, g.rank * half:(g.rank + 1) * half]
                             for x in (q, k, v)), g)))
        return torch.cat(outs, dim=1)

    ring()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ring()
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dense = ring_attention_dense(q, k, v)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    err = (got - dense).abs().max().item()
    torch.testing.assert_close(got, dense, **F32_TOL)
    del got, dense, q, k, v
    torch.cuda.empty_cache()
    log(f"parallel2 ring attention, 2 sp ranks on one card, T = {RING_T} "
        f"({half} a rank), 32 q / 8 kv heads of 64, f32, causal: max abs "
        f"err {err:.3g} against the dense reference (tolerance atol = "
        f"rtol = {F32_TOL['atol']}); wall {ring_ms:.1f} ms for both ranks "
        f"(threads sharing the card), dense {dense_ms:.1f} ms ({SMI})")
    return {"max_abs_err": err, "ring_ms": ring_ms, "dense_ms": dense_ms}


def _rank_forms(label, counts_by_rank, forms, need=tuple(KERNELS)) -> None:
    """Every rank launched each kernel of ``need`` in each of ``forms``
    (suffixes), and no kernel in another form."""
    known = ("", "_int8", "_stacked", "_int8_stacked")
    for rank, counts in counts_by_rank:
        for kernel in KERNELS:
            for form in known:
                n = counts.get(kernel + form, 0)
                if form in forms and kernel in need and n <= 0:
                    raise AssertionError(f"{label}: rank {rank} never "
                                         f"launched {kernel}{form}: {counts}")
                if form not in forms and n:
                    raise AssertionError(f"{label}: rank {rank} launched "
                                         f"{kernel}{form}: {counts}")


def _gloo_world(label, flags, requests, ref, want, forms,
                need=tuple(KERNELS)):
    """bench-1b over two ranks on cuda:0 over gloo, started as the
    server starts them (the backend named, graphs off), against the
    one-rank engine's ``want`` streams: each stream equal or parting at
    a near tie of ``ref``; each rank's kernel forms counted
    (``_rank_forms``); under cp each rank's split ragged rows
    (``ModelRunner.sp_split_rows``: half of every unified block's)."""
    from production_stack_tpu_torch.engine.server import (
        build_engine_from_args)
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    engine, _ = build_engine_from_args(
        _tp_engine_args(flags), devices=PAR_DEVICES, tp_backend="gloo")
    runtime = engine.tp_runtime
    try:
        runner = engine.runner
        if runner.graphs is not None or runner.cache_layout != "stacked":
            raise AssertionError(f"{label}: graphs {runner.graphs}, "
                                 f"layout {runner.cache_layout}")
        COUNTERS.reset()
        t0 = time.perf_counter()
        got = _engine_streams(engine, requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(COUNTERS.launches)
        sp_steps = runner.sp_prefill_steps
        layers = len(runner.params.layers)
        split = {0: {k: list(v) for k, v in runner.sp_split_rows.items()}}
    finally:
        engine.close()
    flips = [check_stream(label, f"request {i}", ref, r["prompt"], w, g)
             for i, (r, w, g) in enumerate(zip(requests, want, got))]
    workers = runtime.worker_launches
    if len(workers) != 1:
        raise AssertionError(f"{label}: worker counts {workers}")
    _rank_forms(label, [(0, launches)] + sorted(workers.items()), forms,
                need)
    split.update(runtime.worker_split_rows)
    if runner.sp is not None:
        # Each rank ran R / 2 rows of every unified block, the same
        # blocks on both ranks.
        if not split[0].get("unified") or split[0] != split[1] or any(
                mine * 2 != rows for counts in split.values()
                for _, mine, rows in counts.values()):
            raise AssertionError(f"{label}: split ragged rows {split}")
        log(f"{label}: the unified dispatches split over the two sp "
            f"ranks, [dispatches, rows a rank ran, rows of the blocks] "
            f"by rank {split}; ragged launches rank 0 "
            f"{launches.get('paged_ragged_stacked', 0)}, rank 1 "
            f"{workers[1].get('paged_ragged_stacked', 0)}")
    tokens = sum(r["max_tokens"] for r in requests)
    whole = sum(f is None for f in flips)
    collectives = {k: v for k, v in launches.items()
                   if k.startswith(("pp_", "sp_", "tp_"))}
    log(f"{label} ({SMI}): {whole}/{len(requests)} greedy streams "
        f"byte-identical to the one-rank engine, flips at near ties "
        f"{[f for f in flips if f]}; {tokens} tokens in {wall:.3f} s, "
        f"{tokens / wall:.1f} tok/s (eager, host-staged gloo collectives "
        f"on one card: not a speed); rank 0 holds {layers} layers; its "
        f"collectives {collectives}; launches rank 0 {launches}, rank 1 "
        f"{workers[1]}")
    return {"launches": launches, "wall_s": wall, "tok_s": tokens / wall,
            "sp_prefill_steps": sp_steps, "flips": flips, "split": split}


def _first_token_ms(engine, prompt) -> float:
    """Wall ms from a greedy request's arrival to its first token."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    t0 = time.perf_counter()
    seq = engine.sequences[engine.add_request(list(prompt), SamplingParams(
        temperature=0.0, max_tokens=1, ignore_eos=True))]
    while seq.num_generated < 1:
        engine.step()
    ms = (time.perf_counter() - t0) * 1e3
    while engine.has_work() or engine._in_flight is not None:
        engine.step()
    return ms


def _pp_windows(requests) -> dict:
    """bench-1b at pp 2 (8 layers a stage), bf16 and int8 KV."""
    from production_stack_tpu_torch.engine.server import (
        build_engine_from_args)
    ref, _ = build_engine_from_args(_tp_engine_args())
    want = _engine_streams(ref, requests)
    out = {PP_RUN: _gloo_world(
        "parallel2 pp 2 over gloo on one card",
        ["--pipeline-parallel-size", "2", "--cache-layout", "auto"],
        requests, ref, want, ("_stacked",))}
    del ref
    torch.cuda.empty_cache()
    int8 = ["--kv-cache-dtype", "int8"]
    ref, _ = build_engine_from_args(_tp_engine_args(int8))
    want = _engine_streams(ref, requests)
    out[PP_INT8_RUN] = _gloo_world(
        "parallel2 pp 2 int8 KV over gloo on one card",
        ["--pipeline-parallel-size", "2"] + int8, requests, ref, want,
        ("_int8_stacked",))
    del ref
    torch.cuda.empty_cache()
    return out


def _cp_window(vocab, requests) -> dict:
    """bench-1b at cp 2: two 4096-token prompts, each one sp prefill
    dispatch, and the 16 short ones on the chunked path, against a cp-1
    engine of the same flags; then each engine's first-token latency of
    two more long prompts, each alone."""
    from production_stack_tpu_torch.engine.server import (
        build_engine_from_args)
    rng = np.random.RandomState(41)
    longs = [{"model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
              "temperature": 0.0,
              "prompt": rng.randint(258, vocab, size=CP_LONG).tolist()}
             for _ in range(4)]
    window = longs[:2] + requests
    ref, _ = build_engine_from_args(_tp_engine_args(CP_ARGS))
    want = _engine_streams(ref, window)
    # Two more long prompts, each cold (no prefix hit) on each engine.
    chunked_ms = [_first_token_ms(ref, r["prompt"]) for r in longs[2:]]
    # Once the long prompts run, the short ones' chunks ride unified
    # steps: the ragged kernel, and no pure prefill step is owed.
    out = _gloo_world(
        "parallel2 cp 2 over gloo on one card",
        ["--context-parallel-size", "2"] + CP_ARGS, window, ref, want,
        ("_stacked",), need=("paged_decode", "paged_ragged"))
    if out["sp_prefill_steps"] != 2:
        raise AssertionError(f"cp 2: {out['sp_prefill_steps']} sp prefill "
                             "dispatches for 2 long prompts")
    engine, _ = build_engine_from_args(
        _tp_engine_args(["--context-parallel-size", "2"] + CP_ARGS),
        devices=PAR_DEVICES, tp_backend="gloo")
    try:
        ring_ms = [_first_token_ms(engine, r["prompt"]) for r in longs[2:]]
        if engine.runner.sp_prefill_steps != 2:
            raise AssertionError("cp 2: two long prompts alone took "
                                 f"{engine.runner.sp_prefill_steps} sp "
                                 "prefills")
    finally:
        engine.close()
    del ref
    torch.cuda.empty_cache()
    log(f"parallel2 cp 2 ({SMI}): {out['tok_s']:.1f} tok/s with the "
        f"unified blocks split over the sp ranks (the replicated form's "
        f"recorded window: {CP_REPLICATED_TOK_S} tok/s; eager over gloo "
        f"on one card, not a speed)")
    log(f"parallel2 cp 2 ({SMI}): a {CP_LONG}-token prompt's first token "
        f"in {ring_ms} ms (one ring dispatch a run, eager over gloo) "
        f"against cp 1's chunked prefill (8 graphed chunks of 512) "
        f"{chunked_ms} ms")
    out.update(first_token_ms=ring_ms, chunked_first_token_ms=chunked_ms)
    return out


def _gpt2_parallel(label, parallel) -> dict:
    """GPT-2 (openai-community/gpt2's config, random weights from the
    seed, bf16 as ``ModelConfig.from_hf_config`` gives it) through ``LLMEngine`` over two gloo ranks on cuda:0,
    against the one-rank engine: 8 greedy prompts of 40..600 tokens,
    async and unified on; with cp the prompts from 512 tokens each in
    one sp dispatch."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, ModelConfig, ParallelConfig,
        SchedulerConfig)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    from production_stack_tpu_torch.parallel.distributed import (
        start_parallel)

    def cfg(par):
        return EngineConfig(
            model=ModelConfig.from_hf_config(FAMILY_CONFIGS["gpt2"],
                                             "gpt2"),
            cache=CacheConfig(page_size=128, num_pages=256),
            scheduler=SchedulerConfig(max_num_seqs=8, max_model_len=1024,
                                      prefill_chunk_size=256,
                                      prefill_batch_size=4,
                                      async_scheduling=True,
                                      unified_step=True),
            parallel=ParallelConfig(**par))
    rng = np.random.RandomState(23)
    vocab = FAMILY_CONFIGS["gpt2"]["vocab_size"]
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(40, 600, 8).round().astype(int)]
    sp = SamplingParams(temperature=0.0, max_tokens=WEIGHTS_OUT,
                        ignore_eos=True)
    ref = LLMEngine(cfg({}), device=PAR_DEVICES[0])
    want = [list(s.output_token_ids)
            for s in ref.generate_batch(prompts, sp)]
    config = cfg(parallel)
    runtime = start_parallel(config, PAR_DEVICES, backend="gloo")
    try:
        engine = LLMEngine(config, device=PAR_DEVICES[0],
                           **runtime.engine_args())
        COUNTERS.reset()
        got = [list(s.output_token_ids)
               for s in engine.generate_batch(prompts, sp)]
        torch.cuda.synchronize()
        launches = dict(COUNTERS.launches)
        sp_steps = engine.runner.sp_prefill_steps
    finally:
        runtime.close()
    flips = [check_stream(label, f"prompt {i}", ref, prompts[i], w, g)
             for i, (w, g) in enumerate(zip(want, got))]
    _rank_forms(label, [(0, launches)] + sorted(
        runtime.worker_launches.items()), ("_stacked",),
        ("paged_decode", "paged_ragged"))
    if parallel.get("context_parallel_size", 1) > 1 and sp_steps != 2:
        raise AssertionError(f"{label}: {sp_steps} sp prefills, expected 2")
    log(f"{label}: {sum(f is None for f in flips)}/8 streams "
        f"byte-identical to the one-rank engine, flips at near ties "
        f"{[f for f in flips if f]}; sp prefills {sp_steps}; launches "
        f"rank 0 {launches}")
    del ref
    torch.cuda.empty_cache()
    return launches


def parallel2_phase(vocab: int) -> dict:
    """Pipeline and context parallelism on one card: ring attention at
    T = 8192 against its dense reference, bench-1b at pp 2 (bf16 and
    int8 KV) and cp 2 over gloo against the one-rank engines, GPT-2 at
    pp 2 and cp 2 through ``LLMEngine``."""
    dev = torch.device("cuda", 0)
    ring = _ring_check(dev)
    requests = _greedy_requests(vocab)
    windows = _pp_windows(requests)
    windows[CP_RUN] = _cp_window(vocab, requests)
    out = {run: w["launches"] for run, w in windows.items()}
    out[GPT2_PP_RUN] = _gpt2_parallel("parallel2 gpt2 pp 2",
                                      {"pipeline_parallel_size": 2})
    out[GPT2_CP_RUN] = _gpt2_parallel(
        "parallel2 gpt2 cp 2", {"context_parallel_size": 2,
                                "long_prefill_threshold": 512})
    out["ring"], out["windows"] = ring, windows
    return out


# ---- distributed phase: multi-host serving ----------------------------------

DIST_TP_RUN = "serve_tp2_distributed"  # process 0 of the tp-2 world
DIST_PP_RUN = "serve_pp2_distributed"  # process 0 of the pp-2 world
DIST_RESOLVED = ["--async-scheduling", "off", "--unified-step", "off"]
DIST_EXIT_S = 60.0  # process 1's bound after process 0's shutdown
DIST_START_S = 240.0


def _metric_lines(url) -> list:
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        return r.read().decode().splitlines()


def _launches_on_metrics(lines) -> dict:
    """The kernel launch counters of a /metrics page."""
    out = {}
    for line in lines:
        m = re.match(r'vllm:engine_kernel_launches_total\{kernel="(\w+)"\} '
                     r"(\S+)", line)
        if m:
            out[m.group(1)] = int(float(m.group(2)))
    return out


def _text_flip(engine, prompt, ref_ids, got_text):
    """Where ``got_text`` (a stream served as text) parts from the
    engine's ``ref_ids``: (token index, margin of the engine's pick over
    the best of its top 20 that decodes to the served text), or None
    when the texts are equal."""
    tok = engine.tokenizer
    if tok.decode(ref_ids) == got_text:
        return None
    k = next((i for i in range(len(ref_ids))
              if not got_text.startswith(tok.decode(ref_ids[:i + 1]))),
             None)
    if k is None:  # the engine's whole stream is a prefix of the text
        return len(ref_ids), float("inf")
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    sid = engine.add_request(list(prompt) + ref_ids[:k], SamplingParams(
        temperature=0.0, max_tokens=1, logprobs=True, top_logprobs=20,
        ignore_eos=True))
    entry = None
    while entry is None:
        for out in engine.step():
            if out.seq_id == sid and out.logprobs is not None:
                entry = out.logprobs
    while engine.has_work():
        engine.step()
    tops = dict(entry[1])
    served = [t for t in tops if got_text.startswith(
        tok.decode(ref_ids[:k] + [t]))]
    margin = (max(tops.values()) - max(tops[t] for t in served)
              if served else float("inf"))
    return k, margin


def _distributed_world(label, flags, requests, forms, need) -> dict:
    """bench-1b over two ``--distributed`` server processes on cuda:0,
    one rank each (process 0 serves HTTP), against a one-process engine
    of the same size over gloo with the resolved flags: the 16 greedy
    requests through HTTP at once, each text equal to the engine's or
    parting at a near tie of it; gloo taken with graphs off; each
    rank's kernel forms counted and the ranks' counts equal; the slice
    gauges; process 1 gone with code 0 within DIST_EXIT_S of process
    0's shutdown."""
    from production_stack_tpu_torch.engine.server import (
        build_engine_from_args)
    here = os.path.dirname(os.path.abspath(__file__))
    ref, _ = build_engine_from_args(
        _tp_engine_args(flags + DIST_RESOLVED), devices=PAR_DEVICES,
        tp_backend="gloo")
    try:
        t0 = time.perf_counter()
        want = _engine_streams(ref, requests)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        port, coord = _free_port(), _free_port()
        logs = [tempfile.NamedTemporaryFile("w+", suffix=f".p{i}.log")
                for i in range(2)]
        cmd = [sys.executable, "-m",
               "production_stack_tpu_torch.engine.server", *SERVER_ARGS,
               *flags, "--distributed", "--coordinator-address",
               f"127.0.0.1:{coord}", "--num-processes", "2", "--host",
               "127.0.0.1", "--port", str(port)]
        procs = [subprocess.Popen(
            cmd + ["--process-id", str(i)], cwd=here, stdout=logs[i],
            stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": here}) for i in range(2)]
        url = f"http://127.0.0.1:{port}"
        try:
            deadline = time.monotonic() + DIST_START_S
            while True:
                try:
                    urllib.request.urlopen(url + "/health", timeout=2)
                    break
                except OSError:
                    if (any(p.poll() is not None for p in procs)
                            or time.monotonic() > deadline):
                        raise AssertionError(f"{label}: process 0 never "
                                             "served")
                    time.sleep(0.5)
            before = _metric_lines(url)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(requests)) as pool:
                texts = list(pool.map(lambda r: _post(
                    url + "/v1/completions", r)["choices"][0]["text"],
                    requests))
            wall = time.perf_counter() - t0
            after = _metric_lines(url)
        finally:
            procs[0].terminate()
            procs[0].wait(timeout=120)
            stopped = time.monotonic()
            try:
                code1 = procs[1].wait(timeout=DIST_EXIT_S)
            except subprocess.TimeoutExpired:
                procs[1].kill()
                procs[1].wait()
                code1 = None
            exit_s = time.monotonic() - stopped
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
        flips = [_text_flip(ref, r["prompt"], w, t)
                 for r, w, t in zip(requests, want, texts)]
    finally:
        ref.close()
    for i, out in enumerate(outs):
        for line in out.splitlines()[-40:]:
            log(f"{label} process {i}: {line}")
    if code1 != 0 or exit_s > DIST_EXIT_S:
        raise AssertionError(f"{label}: process 1 exit code {code1} "
                             f"{exit_s:.1f} s after process 0's shutdown")
    if "backend gloo (step graphs off)" not in outs[0]:
        raise AssertionError(f"{label}: the launcher took another backend")
    bad = [(i, f) for i, f in enumerate(flips)
           if f is not None and not f[1] < NEAR_TIE_LOGITS]
    if bad:
        raise AssertionError(f"{label}: streams part beyond near ties "
                             f"(request, (token, margin)) {bad}")
    m = re.search(r"distributed process 1: kernel launches by rank "
                  r"(\{.*\})", outs[1])
    rank1 = json.loads(m.group(1))["1"]
    rank0 = _launches_on_metrics(after)
    _rank_forms(label, [(0, rank0), (1, rank1)], forms, need)
    if rank0 != rank1:
        raise AssertionError(f"{label}: rank launches differ: rank 0 "
                             f"{rank0}, rank 1 {rank1}")
    if "vllm:engine_slice_id 0.0" not in before or any(
            f'vllm:engine_slice_live{{slice="{i}"}} 1.0' not in after
            for i in (0, 1)):
        raise AssertionError(f"{label}: slice gauges "
                             f"{[x for x in after if 'slice' in x]}")
    tokens = sum(r["max_tokens"] for r in requests)
    whole = sum(f is None for f in flips)
    log(f"{label} ({SMI}): {whole}/{len(requests)} greedy texts "
        f"byte-identical to the one-process engine over gloo, flips at "
        f"near ties (request, (token, margin)) "
        f"{[(i, f) for i, f in enumerate(flips) if f]}; {tokens} tokens in "
        f"{wall:.3f} s, {tokens / wall:.1f} tok/s through HTTP, the "
        f"one-process engine {tokens / ref_wall:.1f} tok/s in the same "
        f"call (eager, host-staged gloo across two processes on one card: "
        f"not a speed); process 1 left "
        f"{exit_s:.2f} s after process 0's shutdown; launches a rank "
        f"{rank0}")
    torch.cuda.empty_cache()
    return {"launches": rank0, "tok_s": tokens / wall,
            "ref_tok_s": tokens / ref_wall, "flips": flips, "exit_s": exit_s}


def distributed_phase(vocab: int) -> dict:
    """Multi-host serving on one card: bench-1b at tp 2 and at pp 2
    over two ``--distributed`` server processes (``_distributed_world``).
    tp crosses the processes, so its placement is named ``any``, as a
    tp axis over two hosts needs."""
    requests = _greedy_requests(vocab)
    tp = _distributed_world(
        "distributed tp 2", ["--tensor-parallel-size", "2",
                             "--mesh-placement", "tp=any"],
        requests, ("",), ("paged_decode", "paged_prefill"))
    pp = _distributed_world(
        "distributed pp 2", ["--pipeline-parallel-size", "2"], requests,
        ("_stacked",), ("paged_decode", "paged_prefill"))
    return {DIST_TP_RUN: tp["launches"], DIST_PP_RUN: pp["launches"],
            "tp": tp, "pp": pp}


# ---- training phase: the dense training forwards with gradients --------------

TRAIN_LAYERS = 4  # bench-1b at full width, cut to 4 of its 16 layers
TRAIN_SHAPE = (2, 1024)  # B, T of the tokens
TRAIN_SEED = 23
TRAIN_REL_L2 = 1e-3
# (label, world sizes, weight dtype) of each world, in the order the same
# spawned ranks run them (a process a rank, every rank on cuda:0, gloo);
# the bf16 world is printed, not held to the bound.
TRAIN_WORLDS = (("cp 2", {"sp": 2}, torch.float32),
                ("pp 2", {"pp": 2}, torch.float32),
                ("dp 2 x cp 2", {"dp": 2, "sp": 2}, torch.float32),
                ("cp 2 bf16", {"sp": 2}, torch.bfloat16))
TRAIN_RANKS = 4
TRAIN_TIMEOUT_S = 420.0
TIMING_KINDS = ("decode", "prefill", "unified")


def _train_model(dev, dtype=torch.float32):
    """(config, params, tokens): bench-1b's geometry with TRAIN_LAYERS
    layers, f32 weights from TRAIN_SEED (cast to ``dtype``) that require
    grad, and [B, T] tokens from the same generator, on ``dev``."""
    import dataclasses
    from production_stack_tpu_torch.engine.config import (
        bench_1b_model_config)
    from production_stack_tpu_torch.models import llama
    cfg = dataclasses.replace(bench_1b_model_config(),
                              num_hidden_layers=TRAIN_LAYERS,
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    params = llama.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, TRAIN_SHAPE, generator=gen,
                           device=dev)
    return cfg, params.to(dtype).requires_grad_(True), tokens


def _train_step(forward, params):
    """One forward and backward of the loss mean(logits ** 2): (logits
    detached, forward ms, backward ms), the gradients left on
    ``params``; the card synchronized around each."""
    params.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = forward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (logits ** 2).mean().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return logits.detach(), (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _grad_stats(g, ref) -> tuple:
    """(relative L2, cosine) of gradient ``g`` against ``ref``, in f32."""
    g, ref = g.float(), ref.float()
    norm = torch.linalg.vector_norm
    return ((norm(g - ref) / norm(ref)).item(),
            ((g * ref).sum() / (norm(g) * norm(ref))).item())


def _stage_leaves(names, stage, stages) -> set:
    """The leaves whose gradient a pp stage holds whole: its layers', the
    final norm's and the head's, and on stage 0 the embedding's."""
    lo = stage * TRAIN_LAYERS // stages
    hi = (stage + 1) * TRAIN_LAYERS // stages
    mine = {f"layers.{i}." for i in range(lo, hi)}
    return {n for n in names
            if n.startswith(tuple(mine)) or n in ("final_norm",
                                                  "lm_head.weight")
            or (n == "embed" and stage == 0)}


def _train_worker(rank, inits, queue) -> None:
    """Rank ``rank`` of the training worlds (spawned; every rank on
    cuda:0): the one-rank ``forward_train`` gradient first, then, in
    each world of TRAIN_WORLDS that has the rank, the world's forward
    and backward over gloo, ``sync_grads`` over sp and dp, and every
    leaf's gradient against the one-rank one; each world's figures go
    on ``queue``."""
    import math
    import traceback
    import torch.distributed as dist
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.parallel.collectives import (
        init_mesh_groups, sync_grads)
    from production_stack_tpu_torch.parallel.context import (
        context_parallel_forward)
    from production_stack_tpu_torch.parallel.pipeline import (
        pipeline_forward)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        cfg, params, tokens = _train_model(dev)
        want, _, _ = _train_step(
            lambda: llama.forward_train(params, cfg, tokens), params)
        ref = {n: p.grad for n, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        for (label, sizes, dtype), init in zip(TRAIN_WORLDS, inits):
            if rank >= math.prod(sizes.values()):
                continue
            groups = init_mesh_groups(rank, "gloo", init, dev, **sizes)
            model = params
            if dtype != torch.float32:
                model = _train_model(dev, dtype)[1]
            if groups.pp is not None:
                def forward():
                    return pipeline_forward(model, cfg, tokens, groups.pp)
            else:
                def forward():
                    return context_parallel_forward(model, cfg, tokens,
                                                    groups.sp, groups.dp)
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)
            logits, fwd_ms, bwd_ms = _train_step(forward, model)
            t0 = time.perf_counter()
            sync_grads(model, groups.sp, groups.dp)
            torch.cuda.synchronize()
            sync_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev)
            leaves = {n: _grad_stats(p.grad, ref[n])
                      for n, p in model.named_parameters()
                      if p.grad is not None}
            want_leaves = (set(ref) if groups.pp is None else _stage_leaves(
                ref, groups.pp.rank, groups.pp.size))
            queue.put(("world", label, rank, {
                "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "sync_ms": sync_ms,
                "resident": resident, "peak": peak, "leaves": leaves,
                "want_leaves": sorted(want_leaves),
                "logits": (list(logits.shape),
                           bool(torch.isfinite(logits).all()),
                           _grad_stats(logits, want)[0])}))
            model.zero_grad(set_to_none=True)
            del logits, model
            dist.destroy_process_group()
            torch.cuda.empty_cache()
        queue.put(("done", None, rank, None))
    except BaseException:
        queue.put(("error", None, rank, traceback.format_exc()))
        raise


def _train_worlds() -> dict:
    """Spawn TRAIN_RANKS ranks, collect every world's figures, and stop
    every rank: {(label, rank): figures}."""
    import queue as queues
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    inits = [f"tcp://127.0.0.1:{_free_port()}" for _ in TRAIN_WORLDS]
    procs = [ctx.Process(target=_train_worker, args=(r, inits, out))
             for r in range(TRAIN_RANKS)]
    for p in procs:
        p.start()
    results, done = {}, 0
    deadline = time.monotonic() + TRAIN_TIMEOUT_S
    try:
        while done < TRAIN_RANKS:
            try:
                kind, label, rank, body = out.get(timeout=5.0)
            except queues.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"training ranks: exit codes "
                                         f"{[p.exitcode for p in procs]}, "
                                         f"{done} done")
                continue
            if kind == "error":
                raise AssertionError(f"training rank {rank}: {body}")
            if kind == "done":
                done += 1
            else:
                results[(label, rank)] = body
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return results


def _timing_server(vocab) -> dict:
    """A bench-1b server process of its own (the first serving run's
    flags) with PSTPU_TIMING=1 and the 16 greedy requests, twice (the
    first round captures the step graphs; the second has prompts of the
    same lengths drawn anew, so its prefills miss the prefix cache):
    after each round its ``/debug/compiles`` ``timings`` must name
    decode, prefill and unified, each counted, with one logged
    ``timing`` line a counted dispatch. Returns {round: {kind: (count,
    mean wall ms)}}, the second round's the ledger's growth over it."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    logf = tempfile.NamedTemporaryFile("w+", suffix=".timing.log")
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         *SERVER_ARGS, "--host", "127.0.0.1", "--port", str(port)],
        cwd=here, stdout=logf, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": here, "PSTPU_TIMING": "1"})
    try:
        deadline = time.monotonic() + DIST_START_S
        while True:
            try:
                urllib.request.urlopen(url + "/health", timeout=2)
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("the timing server never served")
                time.sleep(0.5)
        rounds = []
        for seed in (0, 1):
            requests = _greedy_requests(vocab, seed)
            with ThreadPoolExecutor(len(requests)) as pool:
                answers = list(pool.map(lambda r: _post(
                    url + "/v1/completions", r), requests))
            if any(not a["choices"][0]["text"] for a in answers):
                raise AssertionError("the timing server gave an empty "
                                     "completion")
            rounds.append(_get_json(url + "/debug/compiles")["timings"])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        logf.seek(0)
        text = logf.read()
        logf.close()
    lines = re.findall(r"timing (\w+) t=(\d+) ([0-9.]+)", text)
    first, total = rounds
    second = {k: {f: v[f] - first.get(k, {}).get(f, 0) for f in v}
              for k, v in total.items()}
    for label, timings in (("first", first), ("second", second)):
        missing = [k for k in TIMING_KINDS
                   if timings.get(k, {}).get("count", 0) <= 0]
        if missing:
            raise AssertionError(f"the {label} round's timings {timings} "
                                 f"miss {missing}")
    if len(lines) != sum(v["count"] for v in total.values()):
        raise AssertionError(f"timings {total}, {len(lines)} timing lines")
    return {label: {k: (v["count"], 1e3 * v["wall_seconds"] / v["count"])
                    for k, v in timings.items() if v["count"]}
            for label, timings in (("first", first), ("second", second))}


def training_phase(vocab: int) -> dict:
    """The dense training forwards with gradients at bench-1b's full
    width (TRAIN_LAYERS layers, f32, B x T = TRAIN_SHAPE, loss
    mean(logits ** 2)): one rank's ``forward_train``, then cp 2, pp 2
    and dp 2 x cp 2 over gloo ranks on the one card, every rank's
    gradient after ``sync_grads`` within relative L2 TRAIN_REL_L2 of the
    one-rank gradient on every leaf (pp: the leaves its stage holds
    whole), the same cp 2 in bf16 printed; then the PSTPU_TIMING
    dispatch ledger of a server process of its own."""
    from production_stack_tpu_torch.models import llama
    dev = torch.device("cuda", 0)
    # What the earlier phases still hold: the peak is read above it.
    held = torch.cuda.memory_allocated(dev)
    cfg, params, tokens = _train_model(dev)
    one = []
    for _ in range(2):  # a warm-up, then the timed run
        torch.cuda.reset_peak_memory_stats(dev)
        logits, fwd_ms, bwd_ms = _train_step(
            lambda: llama.forward_train(params, cfg, tokens), params)
        one.append((fwd_ms, bwd_ms,
                    torch.cuda.max_memory_allocated(dev) - held))
    if (list(logits.shape) != list(TRAIN_SHAPE) + [cfg.vocab_size]
            or not torch.isfinite(logits).all()
            or not all(torch.isfinite(p.grad).all()
                       for p in params.parameters())):
        raise AssertionError("training: the one-rank forward_train gave "
                             "non-finite logits or gradients")
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    del logits, params
    torch.cuda.empty_cache()
    log(f"training one rank ({SMI}): bench-1b at full width, "
        f"{TRAIN_LAYERS} layers, f32 ({weights / 1e9:.3f} GB of weights), "
        f"B x T = {TRAIN_SHAPE}, loss mean(logits ** 2): forward "
        f"{one[1][0]:.2f} ms, backward {one[1][1]:.2f} ms, peak "
        f"{one[1][2] / 1e9:.3f} GB above the {held / 1e9:.3f} GB the "
        f"earlier phases hold (no TF32)")
    results = _train_worlds()
    worlds = {}
    for label, sizes, dtype in TRAIN_WORLDS:
        ranks = [results[(label, r)] for r in range(
            int(np.prod(list(sizes.values()))))]
        for rank, fig in enumerate(ranks):
            shape, finite, logits_rel = fig["logits"]
            if (shape != list(TRAIN_SHAPE) + [cfg.vocab_size]
                    or not finite):
                raise AssertionError(f"training {label} rank {rank}: "
                                     f"logits {shape}, finite {finite}")
            if sorted(fig["leaves"]) != fig["want_leaves"]:
                raise AssertionError(
                    f"training {label} rank {rank}: gradients on "
                    f"{sorted(fig['leaves'])}, want {fig['want_leaves']}")
            worst = max(fig["leaves"].items(), key=lambda kv: kv[1][0])
            if dtype == torch.float32 and not (
                    worst[1][0] <= TRAIN_REL_L2 and logits_rel <= 1e-4):
                raise AssertionError(
                    f"training {label} rank {rank}: leaf {worst[0]} at "
                    f"relative L2 {worst[1][0]:.3g} (bound {TRAIN_REL_L2}), "
                    f"logits at {logits_rel:.3g}")
        rels = [v[0] for f in ranks for v in f["leaves"].values()]
        coss = [v[1] for f in ranks for v in f["leaves"].values()]
        worlds[label] = {
            "fwd_ms": [f["fwd_ms"] for f in ranks],
            "bwd_ms": [f["bwd_ms"] for f in ranks],
            "sync_ms": [f["sync_ms"] for f in ranks],
            "peak_gb": [f["peak"] / 1e9 for f in ranks],
            "max_rel_l2": max(rels), "min_cosine": min(coss)}
        bf16 = dtype != torch.float32
        log(f"training {label} ({SMI}): {len(ranks)} gloo ranks on cuda:0, "
            f"{'bf16 weights (printed, not held)' if bf16 else 'f32'}; "
            f"every rank's gradient after sync_grads against the one-rank "
            f"f32 gradient over {len(ranks[0]['leaves'])} leaves a rank: "
            f"max relative L2 {max(rels):.3g}"
            f"{'' if bf16 else f' (bound {TRAIN_REL_L2})'}, min cosine "
            f"{min(coss):.6f}; logits relative L2 "
            f"{max(f['logits'][2] for f in ranks):.3g}; forward ms by rank "
            f"{[round(x, 2) for x in worlds[label]['fwd_ms']]}, backward "
            f"{[round(x, 2) for x in worlds[label]['bwd_ms']]}, sync_grads "
            f"{[round(x, 2) for x in worlds[label]['sync_ms']]}; peak GB by "
            f"rank {[round(x, 3) for x in worlds[label]['peak_gb']]} "
            f"(resident before "
            f"{[round(f['resident'] / 1e9, 3) for f in ranks]}: weights, "
            f"the one-rank gradient kept for the check)")
        if bf16:
            per_leaf = {n: (round(v[0], 4), round(v[1], 6)) for n, v in
                        ranks[0]["leaves"].items()}
            log(f"training {label}: rank 0 (relative L2, cosine) by leaf "
                f"{per_leaf}")
    timings = _timing_server(vocab)
    log(f"training PSTPU_TIMING server ({SMI}): bench-1b, the 16 greedy "
        f"requests, async and unified on; dispatches and mean wall ms by "
        f"kind, the first round (graph captures included) "
        f"{({k: (n, round(ms, 3)) for k, (n, ms) in timings['first'].items()})}"
        f", the second "
        f"{({k: (n, round(ms, 3)) for k, (n, ms) in timings['second'].items()})}")
    return {"one_rank": one[1], "worlds": worlds, "timings": timings}


def _numbers(h) -> dict:
    """A case's numbers for the ``kernels`` line."""
    out = {"max_abs_err": h["max_abs_err"], "ms": h["ms"],
           "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
           "bound_by": h["bound_by"], "library_ms": h["library_ms"],
           "case": h["case"]}
    for key in ("per_layer_ms", "splits", "ms_by_splits"):
        if key in h:
            out[key] = h[key]
    return out


def kernels_line(headline, launches, weights, families, tp=None,
                 geometries=None, pages=None) -> list:
    """The ``kernels`` JSON line's entries: each attention kernel with
    its bf16 per-layer numbers, its ``int8``, ``stacked`` and
    ``int8_stacked`` forms, and its ``geometries`` (``g4_d128`` and
    ``g1_d64``: bf16 with the launches of the serving run of that
    geometry, and ``int8``); then the int8-weight GEMM with its
    OPT-1.3b and GPT-2 projections at M = 32 (``families``); then the
    decode kernel's burst-tail form at bench-1b (its four forms, each
    with the non-tail form's time at the same pages as ``decode_ms``,
    its launches those of the deferred server of that cache form) and
    at ``g4_d128`` (from the tp phase's results ``tp``). With the
    geometries phase's results (``geometries``), each attention kernel's
    ``geometries`` also holds its rows (``g8_d128`` with ``int8``,
    ``g1_d80``, ``g7_d64``, ``g1_d128``: the numbers of the row's dtype
    and the launches of the run that served it, 0 where none did), and
    the int8-weight GEMM its f16 form at OPT-2.7b's projections. With
    the pages phase's results (``pages``), each attention kernel's
    ``pages`` holds its rows keyed ``ps128``, ``ps16``, ``ps256`` and
    ``ps8`` (bf16 numbers with ``int8`` beside them; the int8 page of 8
    alone under ``int8``; the prefill kernel's second chunk under
    ``second_chunk``), each with the launches of the run that served
    that page and cache (``PAGE_ROW_RUNS``; 0 where none did)."""
    geometry_runs = {"g4_d128": MIXTRAL_RUN, "g1_d64": OPT_RUN}
    summary = []
    for name, meta in KERNELS.items():
        h = headline[name]
        summary.append({
            "name": name, **meta,
            "launches": launches[MAIN_RUN].get(name, 0),
            "launches_by_run": {
                run: counts.get(name + RUN_FORMS.get(run, ""), 0)
                for run, counts in launches.items()},
            **_numbers(h["bf16"]),
            "int8": {"launches": launches[INT8_RUN].get(name + "_int8", 0),
                     **_numbers(h["int8"])},
            "stacked": {"launches": launches[STACKED_RUN].get(
                name + "_stacked", 0), **_numbers(h["stacked"])},
            "int8_stacked": {"launches": launches[BURST_RUN].get(
                name + "_int8_stacked", 0), **_numbers(h["int8_stacked"])},
            "geometries": {
                geo: {"launches": launches[run].get(name, 0),
                      **_numbers(families["geometries"][name][geo]["bf16"]),
                      "int8": _numbers(
                          families["geometries"][name][geo]["int8"])}
                for geo, run in geometry_runs.items()}})
    if pages is not None:
        for entry in summary:
            name = entry["name"]
            entry["pages"] = {}
            for page, forms in pages["rows"][name].items():
                row = {}
                for form, case in forms.items():
                    run, suffix = PAGE_ROW_RUNS.get((page, form), (None, ""))
                    numbers = {"launches": launches.get(run, {}).get(
                        name + suffix, 0), **_numbers(case)}
                    if form == "bf16":
                        row.update(numbers)
                    else:
                        row[form] = numbers
                second = pages["rows"].get(name + "_second", {}).get(page)
                if second is not None:
                    row["second_chunk"] = {
                        form: _numbers(case) for form, case in second.items()}
                entry["pages"][page] = row
    if geometries is not None:
        for entry in summary:
            name = entry["name"]
            for row, forms in geometries["rows"][name].items():
                numbers = {}
                for form, case in forms.items():
                    run = GEOMETRY_ROW_RUNS.get((row, form))
                    counter = name + ("_int8" if form == "int8" else "")
                    numbers[form] = {
                        "dtype": "bfloat16" if form == "int8" else form,
                        "launches": launches.get(run, {}).get(counter, 0),
                        **_numbers(case)}
                    if "walk" in case:
                        numbers[form]["walk"] = case["walk"]
                first = numbers.pop(next(iter(forms)))
                entry["geometries"][row] = {**first, **numbers}
    # The int8-weight GEMM's path is the int8-weight server's window.
    w8 = "int8_weight_matmul"
    summary.append({
        "name": w8, **W8_KERNEL,
        "launches": launches[WEIGHTS_RUN].get(w8, 0),
        "launches_by_run": {run: counts.get(w8, 0)
                            for run, counts in launches.items()},
        **_numbers(weights["headline"]),
        "dequant_ms": weights["headline"]["dequant_ms"],
        "families": {case: dict(_numbers(c), dequant_ms=c["dequant_ms"])
                     for case, c in families["w8"].items()}})
    if geometries is not None:
        summary[-1]["f16"] = {
            "launches": launches.get(W8_F16_RUN, {}).get(w8, 0),
            "opt-2.7b": {proj: dict(_numbers(c), dequant_ms=c["dequant_ms"])
                         for proj, c in geometries["w8"].items()}}
    if tp is None:
        return summary
    tail = "paged_decode_tail"
    cases = tp["cases"]

    def tail_numbers(case):
        return dict(_numbers(case), decode_ms=case["decode_ms"])

    forms = {form: {"launches": launches.get(
        f"{DEFERRED_RUN}_{form}", {}).get(tail + "_" + form, 0),
        **tail_numbers(cases["bench_1b"][form])}
        for form in ("int8", "stacked", "int8_stacked")}
    summary.append({
        "name": tail, **TAIL_KERNEL,
        "launches": launches[DEFERRED_RUN].get(tail, 0),
        "launches_by_run": {run: counts.get(tail, 0)
                            for run, counts in launches.items()},
        **tail_numbers(cases["bench_1b"]["bf16"]), **forms,
        "geometries": {"g4_d128": {
            **tail_numbers(cases["g4_d128"]["bf16"]),
            "int8": tail_numbers(cases["g4_d128"]["int8"])}}})
    return summary


# The kernel form each run's ``launches_by_run`` entry counts, where it
# is not the per-layer bf16 one.
RUN_FORMS = {FLEET_INT8_RUN: "_int8_stacked", LLAMA70_INT8_RUN: "_int8",
             FALCON3_INT8_RUN: "_int8", D512_INT8_RUN: "_int8",
             PAGES_INT8_RUN: "_int8_stacked",
             DISAGG_INT8_RUN: "_int8_stacked", PP_RUN: "_stacked",
             PP_INT8_RUN: "_int8_stacked", CP_RUN: "_stacked",
             GPT2_PP_RUN: "_stacked", GPT2_CP_RUN: "_stacked",
             DIST_PP_RUN: "_stacked"}


# ---- main -------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from production_stack_tpu_torch.ops import paged_kv_common

    global SMI
    only = sys.argv[sys.argv.index("--only") + 1:] if (
        "--only" in sys.argv) else None
    smi = SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t_start = t0 = time.perf_counter()
    ptxas = []
    lib = paged_kv_common.build_kernels(log=ptxas.append)
    paged_kv_common.kernel_lib()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib, here)}")
    PTXAS_LOG[:] = ptxas
    for text in ptxas:
        for line in text.splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line or line.startswith("nvcc ")
                    or "(C75" in line):
                log(line.strip())

    from production_stack_tpu_torch.engine.config import (
        bench_1b_model_config)
    vocab = bench_1b_model_config().vocab_size
    if only is not None:
        # A development run of the named phases (no result lines).
        for name in only:
            globals()[name + "_phase"](vocab)
        log(f"chip_smoke: phases {only} passed")
        return 0
    headline = kernel_phase(dev)
    torch.cuda.empty_cache()
    model_phase(dev)
    engine_phase(vocab)
    graph_phase(vocab)
    sampling_options_phase(vocab)
    launches = serving_phase(vocab)
    torch.cuda.empty_cache()
    fleet = fleet_phase(vocab)
    launches[FLEET_RUN] = fleet[FLEET_RUNS[0][0]]
    launches[FLEET_INT8_RUN] = fleet[FLEET_RUNS[1][0]]
    torch.cuda.empty_cache()
    disagg = disagg_phase(vocab)
    launches[DISAGG_RUN] = disagg[DISAGG_RUNS[0][0]]
    launches[DISAGG_INT8_RUN] = disagg[DISAGG_RUNS[1][0]]
    torch.cuda.empty_cache()
    launches[AUTOTUNE_RUN] = autotune_phase(vocab)
    torch.cuda.empty_cache()
    weights = weights_phase(vocab)
    launches[WEIGHTS_RUN] = weights[WEIGHTS_RUN]
    launches[LORA_RUN] = weights[LORA_RUN]
    torch.cuda.empty_cache()
    families = families_phase(vocab)
    launches[MIXTRAL_RUN] = families[MIXTRAL_RUN]
    launches[OPT_RUN] = families[OPT_RUN]
    launches[GPT2_RUN] = families[GPT2_RUN]
    torch.cuda.empty_cache()
    geometries = geometries_phase(vocab)
    for run in (LLAMA70_RUN, LLAMA70_INT8_RUN, OPT27_RUN, QWEN05_RUN,
                FALCON3_RUN, FALCON3_INT8_RUN, OPEN_LLAMA_RUN, D512_RUN,
                D512_INT8_RUN, W8_F16_RUN):
        launches[run] = geometries[run]
    torch.cuda.empty_cache()
    pages = pages_phase(vocab)
    for run, *_ in PAGES_SERVERS:
        launches[run] = pages[run]
    torch.cuda.empty_cache()
    tp = tp_phase(vocab)
    for run in (DEFERRED_RUN, NCCL_RUN, TP_RUN) + tuple(
            f"{DEFERRED_RUN}_{form}" for form, _ in DEFERRED_FORMS):
        launches[run] = tp[run]
    torch.cuda.empty_cache()
    par = parallel2_phase(vocab)
    for run in (PP_RUN, PP_INT8_RUN, CP_RUN, GPT2_PP_RUN, GPT2_CP_RUN):
        launches[run] = par[run]
    torch.cuda.empty_cache()
    multihost = distributed_phase(vocab)
    for run in (DIST_TP_RUN, DIST_PP_RUN):
        launches[run] = multihost[run]
    torch.cuda.empty_cache()
    training_phase(vocab)
    if launches[DEFERRED_RUN].get("paged_decode_tail", 0) <= 0:
        raise AssertionError("the deferred server's window never launched "
                             "the decode kernel's tail form")
    summary = kernels_line(headline, launches, weights, families, tp,
                           geometries, pages)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s, the kernel build included")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
