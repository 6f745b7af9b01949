#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 1 builds the four CUDA kernels from the sources in the checkout
and prints each kernel's registers, shared memory and spills. Phase 2
holds each kernel against its plain PyTorch version at the shapes the
serving path gives it (B1 in f32 and bf16 for all four methods, also at
K = 10, at m = 3 and 100, on a ragged C and a misaligned base; B3 also
at every length around its 32-key chunk edges and at batch 32, bitwise
equal to the same rows at batch 4, and at head dims 96 and 112 with query
groups 9 and 16 in every kv dtype; B2 in bf16 at every head dim with
ragged S and T), checks that B2 and B3 give the same bits on a second
call and that one B3 call with a python-int length, and one B4 call
(greedy or top-50), is one device kernel, and times kernel, plain
version and (for attention) one PyTorch library call as a yardstick, on
device time only, each call after a read-only flush of L2.
Phase 3 serves qwen3-1.7b at full width (QWEN_CUT_LAYERS = 14 of its 28
layers, bf16, seeded random weights) with robust replicated decoding (m
= 8 replicas, VRMOM, alpha = 0.25) through ``ServeEngine.generate``,
which captures one decode step as a CUDA graph and replays it every
token, and through ``generate_python_loop``, the eager loop: greedy
tokens must be identical between the two and across
none/signflip/gaussian x fused/unfused x shared/replicated (and plain),
temperature and top-50 tokens identical between graph and eager from one
seed, and every kernel must have launched on that path. For both it
prints decode ms/token, the capture time, host launches and device
kernels a token and the device-busy share of one profiled generate.
Every call of the main path runs under torch.profiler, and its launches
are the port's device kernels in that trace: a replay calls no kernel
wrapper, so the wrappers count only eager launches. On the eager loop
the trace must hold exactly what the wrappers counted, kernel by kernel;
each graph generate must launch, kernel by kernel, what the eager loop
launches, with no decode kernel counted by a wrapper (every step a
replay); a call whose trace lost an event is run and traced again, and
one whose trace lost its spin is called again (printed; the first
generate then captures anew).
Phase 4 drives the paper's statistical path (RCSL, Algorithm 1, with
plug-in sandwich CIs, replications batched into tensors): B1/B4 at
K = 65 and 100 bitwise against their plain versions; the acceptance cell
of BENCH_inference.json (linear, gaussian attack, alpha = 0.1, VRMOM K =
10, 200 replications, n 200, m 100, p 5, 6 rounds), whose coverage must
lie within 0.03 of 0.95; PAPER_LINREG (p 30, n 1000, m 100, 10 rounds)
at 500 replications under the gaussian attack, where VRMOM-RCSL's RMSE
must be below MOM-RCSL's on the same draws; PAPER_LOGREG_BALANCED with
label flipping; B1 on one chunk's statistics bitwise against its plain
version, a cell on the kernel against the same cell on the plain
Estimator, and the times of the path and of B1 at its shape.
Phase 5 serves, one at a time and each freed before the next, the configs
that reach B2's and B3's wider instances, at full width through
``ServeEngine.generate`` with seeded random weights and the workload of
phase 3, each cut in depth only: starcoder2-7b (B3 at query group 9),
minitron-4b (B4 over a 256000 vocabulary) and phi-3-vision-4.2b with 256
stub patches before the prompt (B2 and B3 at head dim 96), each at 4 of
its 32 layers, and llama3-405b at 2 of its 126 layers (B3 at group 16). Greedy tokens must be equal between
``generate`` (graph) and ``generate_python_loop`` (eager) and across
none, signflip and gaussian and fused and unfused within each layout
(shared and replicated), their launches are traced and held against
each other and the wrappers' counts, and both are timed and profiled, all
as in phase 3; where the two layouts part, the step must be a near-tie
(its top-2 gap within the layouts' logit difference) and their
teacher-forced logits must agree within 5e-2 of the largest logit. The
new instances must have run (traced launches, and the template arguments
of the device kernels in a trace of a prefill and a decode step), and
each is held against its plain version and timed at its shape.
Phase 6 serves qwen3-1.7b at full width (phase 3's 14 of 28 layers)
through continuous batching: ``Scheduler(decode_block=8)`` over
``ServeEngine(max_len=512, n_slots=32)`` with robust m = 8 VRMOM K = 8
shared fused replicas and a ``MetricsRegistry``, 64 requests made with
numpy (prompts 32..320, budgets 16..64) and one too long for a slot,
which must come back rejected. Each admission prefills at batch 1 (B2)
into its slot; each block replays the pool's captured step 8 times.
Every completion must have its budget; the tokens must be identical
under signflip and gaussian at alpha 0.25, the signflip disagreement
histogram must count exactly the live tokens with mean exactly 0.25, and
the tokens of 8 requests must equal a solo generate or part only at a
near-tie (``layout_check`` at batch 1 against 32). Its main path (a
traced drain and a temperature round, which runs B1 inside the replayed
step) must launch what the blocks imply, kernel by kernel. It prints
tokens/s of a drain, TTFT and decode-step percentiles from the registry,
the capture, host launch calls, device kernels and the device-busy share
of one profiled block, and the kv_bytes_per_slot gauge, and adds B3 at
the pool's batch 32 with ragged lengths (beside SDPA with the same
mask), B4 with ``with_agg``, B1 at the pool's stack and B2 at batch 1 to
the ``kernels`` line.
Phase 7 trains qwen3-1.7b at full width (seeded weights, bf16, remat on)
through ``make_train_step`` with W = 8 workers emulated on the card, one
4096-token sequence each (``data.lm_batch``), VRMOM K 10, AdamW lr 1e-4:
(a) a clean warm-up step, then 3 timed stacked-auto steps under signflip
(int(0.25 * 7) = 1 row) as its main path, B1 once a leaf and B2 twice a
layer and worker (the forward and its recompute) by the wrappers'
counts and in a profiler trace of one more step; it prints step seconds,
tokens/s, the share of the bf16 peak, the split of a step, the device
time by kernel group, peak memory against the reckoning, and requires
the loss finite and batch 0's loss to fall. (b) On one step's gradient,
2 of 8 rows attacked (alpha 0.3) by signflip, omniscient and gaussian
(``robust_shift``): VRMOM's aggregate must move less than the mean's,
the mean must turn round under omniscient, and on the leaves whose clean
rows share a direction VRMOM must stay closer to its clean aggregate
than a zero aggregate is; ``with_diag`` must flag exactly the attacked
rows. (c) 2 inloop steps at 8 x 1024 tokens, B1 on every product's dW.
(d) B1 at the w_gate stack [8, 352321536] bf16 (sampled columns against
the plain version, bitwise equal to f32 then cast) and at one inloop dW,
B2's forward at q [1, 4096, 16, 128] and at the inloop q [8, 1024, 16,
128] beside SDPA's, and B2 under autograd (its forward and the ``mha``
recompute backward) beside SDPA's forward and backward join the
``kernels`` line.
Phase 8 drives the adaptive tier (census, vrmom_adaptive, auto_gm): (a)
BENCH_regimes.json's coverage block (linear, alpha 0.2, m 100, n 100, p
5, 4 rounds) under alie and ipm at 480 replications, vrmom and median at
assumed_alpha 0 and the adaptive arms at the census's alpha_hat (which
must be the record's 0.198), printed beside the JAX record; the record's
own criterion must hold (a regime where both fixed arms fall below 0.90
and both adaptive arms reach it) and both adaptive arms must reach 0.90
under each; (b) phase 7's training at full width (14 of 28 layers) with
stacked-adaptive vrmom_adaptive and auto_gm: on one honest stack each
aggregate equals its fixed baseline's bit for bit (B1 vrmom; the
geometric median) with the state at its unit fixed point, then 3 steps
under ipm on int(0.4 * 7) = 2 rows carry the state, whose alpha_hat must
be (1 - 0.5^s) * 0.25 and the two rows' weights the EMA toward 1/2, the
rest 1.0, the loss finite and stable, B1 and B2 launched as the wire's
column blocks imply; (c) phase 3's serving workload (its model at 14
layers) with the adaptive tails under none, signflip and gaussian: graph
tokens equal eager and phase 3's clean tokens, traced B1 launches a
token as the ladder implies, the mean control corrupted, and decode
ms/token. B1 at the phase's three stacks joins the ``kernels`` line.
Phase 9 drives the consensus backend (``dist.consensus``,
``FaultPlan``): (a) BENCH_dist.json's emulated degradation grid (n 8, f
1, midpoint trim, vrmom, alie and omniscient on one pinned row, C 512)
under dropout 0 to 0.5 at 64 seeds in one batched call a cell, the
port's own draws: quorum, messages_dropped and quorum_lost must lie
within 4 standard errors of their closed forms (P(Bin(7, 1 - d) >= 6),
40 * 56 * d, (1 - q)^8), the decision at dropout 0 must equal the
fault-free run's, and the unpinned fault-free mean-trim decision B1's
direct aggregate, bit for bit; err_vs_honest_mean and rounds_to_eps
print beside the record's. (b) One round at the train wire's [8, 2^22]
f32 block, device time: B1 on identical rows (the degenerate-scale
branch of every fault-free round after the first; bitwise its plain
version, and a ``kernels`` record), a whole fault-free round, a
fault-path round (the masked trim of 8 receivers, and the same views
through torch.sort beside it) and the spread. (c)
tests/test_consensus.py's coverage cell (linear, alie alpha 0.1, vrmom K
5, m 20, n 100, p 3, 4 rounds, f 2, 10% dropout) at 480 replications:
coverage >= 0.6 and a finite RMSE. (d) Phase 7's training at 14 of its
28 layers with ``reduce_backend="consensus"`` (f 1): on one honest stack
the consensus aggregate equals the stacked-auto aggregate bit for bit; 3
steps under alie on 1 pinned row (its main path, B1 once a block and
round), the loss finite and quorum kept, the split of a step printed;
then one step under repro's plan (dropout 0.1, a crash at round 2) at
the depth its reckoned time allows, printed with the cut; peak memory.
Phase 10 serves the moe family (``models/moe.py``): (a) granite-moe-3b-
a800m at full width and 8 of its 32 layers (40 experts top-8, dh 64, G 3,
V 49155; seeded bf16 weights) with phase 3's workload: greedy tokens
identical across none/signflip/gaussian x fused/unfused in each layout;
for three of those runs (signflip; fused and unfused shared, fused
replicated) graph = eager, the eager loop's launches (the wrappers'
counts) and each traced generate's what the step implies kernel by
kernel (``graph_traced``), shared vs replicated held by
``layout_check`` (past LAYOUT_TOL only after a router near-tie), the
B2 <64> and B3 <64, 8> instances read from a trace, the (token, slot)
pairs capacity dropped in the prefill counted, decode ms/token, capture,
launches and busy share beside the weight bound; (b) the same model
behind ``Scheduler`` over 8 slots of 512 (16 numpy-seeded requests):
tokens identical under none/signflip/gaussian, 4 requests against a solo
generate, drain tok/s and decode-step percentiles; (c) mixtral-8x7b at 4
of 32 layers, every width as published: graph = eager under none and
signflip, no B2 launch (its window of 4096 sends the prefill to the plain
``mha``) and B3 once a layer a step over the 4096-slot ring, and one
prompt of 4090 tokens whose 24 new ones run the ring past its end, graph
= eager. B2/B3 at granite's shapes, B3 over mixtral's ring, and B4 (and
B1) at V 49155 (odd: B4's scalar loads) and 32000 join the ``kernels``
line.
Phase 11 serves the ssm and hybrid families (``models/mamba2.py``,
``models/hybrid.py``): (a) mamba2-2.7b (16 of its 64 mamba2 layers, no
attention, V 50280) and zamba2-7b (15 of its 81 mamba2 layers and a
shared attention block after every 6: 2 applications at dh 112, G 1; V
32000) at full width (SSM_SERVE_LAYERS), seeded bf16 weights, phase 3's
workload, one engine for each of seven (layout, attack, tail) runs
covering none/signflip/gaussian and fused/unfused in each layout: greedy
tokens identical within each layout; two signflip runs (mamba2: fused
and unfused shared; zamba2: fused shared and replicated) graph = eager,
the eager loop's launches (the wrappers' counts) and each traced
generate's what the step implies kernel by kernel (zamba2: B2 once an
application, B3 once an application a step; mamba2: neither); shared vs
replicated held by ``layout_check``; the instances that ran (zamba2: B2
<112>, B3 <112, 8>); the prefill on the kernel path against the plain
path (mamba2: the same bits; zamba2: within LAYOUT_TOL); decode
ms/token, capture, launches and busy share (of the graph), the
replicated layout's decode ms/token, each layout's decode bound from the
bytes a step moves (the weights, the f32 state read and written, the
K/V), and peak memory; (b) zamba2-7b behind ``Scheduler`` over 8 slots
of 512 (16 numpy-seeded requests): tokens identical under
none/signflip/gaussian, a second drain (every admission into a slot
whose state moved while it sat free) identical to the first, the first
request admitted after an eviction equal to its run alone in a new pool,
5 requests against a solo generate; (c) B2 and B3 at zamba2's dh 112, G
1 (and B3 at its 32 replicated rows), and B4 and B1 at mamba2's V 50280
join the ``kernels`` line with the launches of (a)'s traces.
Phase 12 serves the encdec family (``models/whisper.py``): (a)
whisper-medium at full width and 12 of its 24 encoder and 12 of its 24
decoder layers (ENCDEC_LAYERS; dh 64, G 1, V 51865 tied; seeded bf16
weights) with phase 3's workload and numpy-seeded stub frames [4, 1500,
1024] bf16, one engine for each of phase 11's seven (layout, attack,
tail) runs: greedy tokens identical within each layout; the signflip
runs (shared fused and unfused, replicated fused) graph = eager, every
call of theirs traced: the eager loop's and each generate's launches
what the step implies kernel by kernel (B2 once an encoder layer and
twice a decoder layer a prefill, the encoder's and the cross attention's
non-causal; B3 twice a decoder layer a step, the cross one over the
whole 1500-frame cache with no length mask); shared vs replicated held
by ``layout_check``; the instances that ran (B2 <64>, B3 <64, 8>); the
kernel prefill within LAYOUT_TOL of the plain one; decode ms/token
(graph, eager, replicated), capture, launches and busy share, prefill
ms, each layout's decode bound from the bytes a step moves (the
decoder's weights and the embedding, each row's cross K/V and self K/V),
peak memory; (b) the same model behind ``Scheduler`` over 8 slots of 512
(16 requests, each with its own numpy-seeded frames): the cross K/V
counted in ``serve.kv_bytes_per_slot``, tokens identical under
none/signflip/gaussian and in a second drain, 4 requests against a solo
generate (or a near-tie); (c) B2 non-causal at the encoder's [4, 1500,
16, 64] and the cross attention's q [4, 192, 16, 64] over 1500 keys, B2
causal at the decoder's [4, 192, 16, 64], B3 over the whole encoder
cache at 4 and 32 rows, B3 at the self cache [4, 216, 16, 64], and B4
and B1 at V 51865 join the ``kernels`` line, each B2 and B3 row with its
launches and median device time (``in_path_ms``) in (a)'s traces, split
by role from their launch order (the encoder's, then a self and a cross
launch a decoder layer).
Phase 13 trains whisper-medium at full width and depth (24 + 24 layers,
seeded bf16 weights, remat on) through ``make_train_step`` with phase 7's
W = 8, VRMOM K 10, AdamW lr 1e-4 and alphas, each worker one sample of
1500 numpy-seeded frames and 448 decoder tokens (``data.lm_batch``): (a)
a clean warm-up step, then 3 timed stacked-auto steps under signflip as
its main path, B1 once a leaf and B2 twice an attention (the encoder's
and the cross attention's non-causal under autograd, the decoder's
causal), both by the wrappers' counts; it prints step seconds, tokens/s,
6 (N_enc 1500 + N_dec 448) W over the bf16 peak, the split of a step,
the device time by kernel group of one profiled step and peak memory
against ``encdec_train_reckoning``, and requires the loss finite and
batch 0's loss to fall; (b) phase 7's robustness gates and ``with_diag``
on one step's gradient; (c) 2 inloop steps with the 8 samples in one
forward, B1 on each of the 433 products' dW (``encdec_products``) and B2
as in (a); (d) B2's forward at batch 1 at the encoder's, the cross
attention's and the decoder's shapes beside SDPA, B2 under autograd at
the encoder's and the cross shapes beside SDPA's forward and backward,
B1 at ``enc_layers.mlp.w_gate`` [8, 100663296] bf16 and at one MLP
product's dW [8, 1024*4096] f32 join the ``kernels`` line.
Phase 14 trains granite-moe-3b-a800m at full width (d 1536, 24 heads
over 8 kv heads of 64, 40 experts top-8 of d_ff 512, V 49155 tied, bf16,
seeded weights, remat on) and MOE_TRAIN_LAYERS = 16 of its 32 layers
through ``make_train_step`` with phase 7's W = 8, VRMOM K 10 and alphas,
AdamW at lr 1e-5 (MOE_TRAIN_LR), each worker one 4096-token row (two
routing groups of 2048, 512 rows an expert): (a) a clean warm-up step,
then 3 timed stacked-auto steps under signflip as its main path, B1 once
a leaf and B2 twice a layer and worker (768), both by the wrappers'
counts; it prints step seconds, tokens/s, 6 N_active tokens over the
bf16 peak (N_active: top-8 of 40 experts, ``model.active_param_count``),
the split of a step, the device time by kernel group of one profiled
step (the routing's scatter, gather, index and scan kernels a group of
their own), peak memory against ``moe_train_reckoning``, and the share
of (token, slot) pairs capacity dropped in that step's forward; requires
the loss finite, batch 0's loss and its next-token CE to fall, and, as
the gate's controls on the 4 steps' update d, p0 - d to raise both and
p0 + d with random signs, over every leaf or over the moe leaves alone,
to lower neither as far; one worker's gradients twice
on one batch: the backward's recompute must route as the forward did,
call for call, and whether the two runs' gradients are bit-equal is
printed (the dispatch's backward adds a token's rows by atomics); (b)
phase 7's robustness gates and ``with_diag``, the expert leaves' row
cosines printed apart; (c) 2 inloop steps at 8 x 1024 tokens in one
forward (a group of 1024 a row), B1 on each of the 4 L + 1 products' dW
(q, k, v, o and the tied unembedding: the router and the experts are
plain products, as in ``repro``) and B2 twice a layer, with the share of
the params the wire covers; (d) B1 at ``layers.moe.w_gate`` [8,
503316480] bf16 and at one attention product's dW [8, 1536*1536] f32,
B2's forward at q [1, 4096, 24, 64] over k/v [1, 4096, 8, 64] causal
beside SDPA, and B2 under autograd at that shape beside SDPA's forward
and backward join the ``kernels`` line.

Phase 15 trains the ssm and hybrid families at full width through
``make_train_step`` with phase 7's W = 8, VRMOM K 10, AdamW lr 1e-4 and
alphas, each worker one 4096-token row, seeded bf16 weights, remat on:
mamba2-2.7b at SSM_TRAIN_LAYERS = 16 of its 64 layers (d 2560, 80 heads
of 64, N 128, V 50280 tied), then zamba2-7b at HYBRID_TRAIN_LAYERS = 15
of its 81 (two groups of 6 mamba layers, each followed by the shared
block at 32 heads of dh 112, G 1, then the 3-layer tail; V 32000 tied),
each mamba layer recomputed in the backward and the shared block not.
For each: (a) a clean warm-up step, then 3 timed stacked-auto steps under
signflip as its main path, B1 once a leaf (14 and 36 leaves) and B2
once a shared-block application and worker (0 and 48), by the wrappers'
counts; batch 0's loss must fall, and, as the gate's controls on the 4
steps' update d, p0 - d must raise it and p0 + d with random signs lower
it less far; it prints step seconds, tokens/s, 6 N tokens over the bf16
peak (zamba2's N counts the shared block once an application; the SSD's
intra-chunk products are not in 6N), the device time by kernel group of
one profiled step, and peak memory against ``ssm_train_reckoning``; (b)
phase 7's robustness gates and ``with_diag``, the clean rows' cosines of
every mamba and shared-block leaf printed apart; (c) 2 inloop steps at 8
x 1024 tokens in one forward, B1 on each product's dW the wire reaches
(the tied unembedding; zamba2 also q, k, v, o, gate, up and down of each
application: the mamba projections and the shared block's in_proj are
plain products, as in ``repro``), with the share of the params the wire
covers; (d) B1 at ``layers.ssm.in_proj_z`` [8, 209715200] and
``mamba_g.ssm.in_proj_z`` [8, 308281344] bf16, at the unembedding's dW
[8, 2560*50280] and the shared block's ``wq`` dW [8, 3584*3584] f32, B2's
forward at q/k/v [1, 4096, 32, 112] causal beside SDPA, and B2 under
autograd at that shape beside SDPA's forward and backward join the
``kernels`` line.

Phase 16 is static analysis and the audit (``repro_torch.lint``), and
adds no kernel row: (a) the AST rules over the port's tree (its package,
its tests and this script) must report no error a waiver does not cover;
it prints the file count and the waived count; (b) ``run_audit`` on the
card must pass every RL2xx check but RL201, which skips off a process
group (phase 18 runs it on its ranks); it prints each check's wall and
the launches of
B1-B4 by the wrappers' counters; (c) RL209 at full width: a seeded
qwen3-1.7b robust engine (m 8, VRMOM K 8) serves three greedy
``generate`` calls of 4 x 192 tokens with 8 new, each with a freshly
built ``Sampling`` equal to the first: one capture, the later calls
replay the same ``StepGraph``, and the third call's tokens equal the
first's.

Phase 17 is the one-card accounting (``repro_torch.launch``) held
against a real run, on full-width qwen3-1.7b with seeded weights at the
shapes above: (a) ``op_cost.counting("cuda")`` on the meta device over
the 4 x 192 prefill (B2: 28 calls), one decode step at batch 4 over its
216-slot cache (B3: 28) and one stacked-rrs train step at W = 8 x 4096
(B1 on each of 13 leaves, B2 forward under autograd), the step counted
twice: traced whole and by trip count (``op_cost.trips``), which must
agree exactly in FLOPs, bytes, peak and kernel calls, and phase 7's step
(stacked-auto, signflip) counted for its peak; (b) the same three
calls on the card under the same count: FLOPs and bytes equal the meta
count's exactly, op by op (an op that parts is named and fails it), the
wrappers' launch counters rise by the kernel calls the meta count
recorded, each call's untraced wall is printed against its roofline
bound (989 TFLOP/s bf16, 3.35 TB/s), and the train step's
``max_memory_allocated`` must lie within 10 % of the meta peak; (c)
``launch.dryrun.dryrun_one`` for every arch at ``decode_32k`` and the
``launch.report`` table of those rows; (e) the mesh dry run of
qwen3-1.7b ``train_4k`` at 16 worker ranks (``dryrun_one(mesh=16x16)``:
one rank's step under a fake process group of 16 on meta, its RRS
wire's all-to-all and all-gather bytes equal to the padded raveled
gradient's and its slice's, its three roofline terms printed) and the
meta count of phase 18's counted wire call under a fake group of 4. B1,
B2 and B3 at phase 17's shapes join the ``kernels`` line with the bounds
of ``kernels/*.cost``.

Phase 18 is the Robust-Reduce-Scatter wire and the consensus wire over
ranks (``dist.robust_reduce.aggregate_stacked_rrs``,
``dist.consensus.aggregate_stacked_consensus``): after phase 17 the
allocator's cache is emptied and 4 ranks are started
(``torch.multiprocessing``, from a forkserver that preloads torch and the
port, since there is no fork after CUDA is initialised), each on the one
card, joined in a
``gloo`` group through a ``FileStore`` in a temporary directory, removed
with what the ranks left there when the phase ends (NCCL cannot put
several ranks on one GPU); they load the kernels phase 1
built and never run nvcc. Each rank is one worker of qwen3-1.7b at full
width cut to 2 of 28 layers (seeded weights; ~28 B a param a rank), one
4096-token sample of ``lm_batch`` each; the main path, counts from 0:
(a) the worker's gradient down the wire once (B1 once on the rank's
[4, 102959744] f32 slice), the SHA-256 of each gradient and aggregate
leaf recorded, rank 0's aggregate saved; the wire's synchronised wall,
and the host walls of its ``rrs.*`` spans from a profiler trace
(all_to_all; B1's launch, which returns at once; all_gather, which holds
B1's device time, since its copy to the host waits for B1); (b) two
stacked-rrs steps over the group (AdamW, signflip on the last rank's
worker), params identical on every rank after each, losses finite, B1
once and B2 2 x 2 a rank and step; (c) one ``robust_dot`` product at
``wq``'s width ([2048, 2048] f32 dW, B1 once); (d) RL201 ``ok`` on every
rank; (e) one inloop step over the group at phase 7's inloop length
(1024 tokens a worker; fresh params, AdamW, signflip): B1 once a product
(15: 7 a layer and the tied unembedding once a loss chunk), params
identical on every rank, loss finite, and the ``all_reduce`` after the
backward summing exactly the leaves off the wire (the norms and the tied
embedding; counted from the profiler's ``gloo:all_reduce`` shapes), with
the step's wall and its collectives' spans and elements printed (the
inloop step against one process is held on the CPU, in
``tests/test_torch_rrs.py``); (f) (a)'s worker gradient down the
consensus wire fault-free (``ConsensusConfig(f=0)``: 4 peers allow no
more, n > 5f; trivial plan, no pins): its SHA-256 leaf by leaf must equal
(a)'s RRS aggregate's, the aux be the same on every rank, and each
``WIRE_CHUNK`` block take exactly one ``all_gather`` (counted at
``robust_reduce.all_gather_into``) and one B1 (the wrappers' counter),
its synchronised wall printed; (g) the leaf ``layers/attn/wk`` alone with
one stale straggler (f = 0, p_end 21): ``p_end + 1`` = 22 ``all_gather``s,
output and aux the same on every rank; the counted wire call: one RRS
wire call on (a)'s ``layers/attn/wk`` under ``launch.op_cost.counting``
on the card and a profiler trace, its all-to-all and all-gather bytes
equal to the elements of the profiler's ``gloo:`` shapes x 4 and to phase
17's meta count of the same call under a fake group of 4; (h), (a)'s
gradient freed, PAPER_LINREG's gaussian alpha 0.1 cell at phase 4's
settings over the group (``coverage_run(group=)``: 500 replications, 125
a rank in one chunk, 10 rounds, seed 1), VRMOM-RCSL and MOM-RCSL: every
rank's cell the same, rank 0's re-run of the 4 one-process slices
(seeded ``rank_seed``) equal to it bit for bit and B1's launches a rank
equal to its slice's, coverage within 4 binomial standard errors (over
2,500 CIs) of this process's one-process cell at phase 4's settings, and
RMSE VRMOM < MOM; the cell's synchronised wall printed. The f = 1 fault
paths are held on 8 CPU ranks (``tests/test_torch_rrs.py``). Then this
process recomputes the
four workers' gradients (each must hash as its rank's), runs
``aggregate_stacked_auto`` (rank 0's aggregate must equal it bit for
bit) and the one-process ``aggregate(mode="stacked-consensus")`` on their
``wk`` with the same plan and a generator seeded as the ranks' ((g) must
equal it bit for bit, aux included), the one-process
``make_train_step(mode="stacked-rrs")`` on the same batches (params
equal, gate 0 as the CPU test) and the one-process ``_RobustDot`` (dW
equal). A rank's failure raises through the join. B1 at the RRS wire's
slice, at the consensus wire's block and at (h)'s chunk [101, 125 x 465]
join the ``kernels`` line.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it lists every kernel with its launches, error and times. Any
failed check exits non-zero before that line. Without a CUDA device, or
without the repository beside it, the script exits non-zero.
"""
from __future__ import annotations

import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak
# device spin before each timed call: ~2 ms at the H100's 1.98 GHz for a
# kernel, ~20 ms for a plain version (many launches, more host time)
SPIN_CYCLES = 4_000_000
PLAIN_SPIN_CYCLES = 40_000_000

# the port's kernels by their device names (csrc/*.cu)
PORT_KERNELS = ("agg_kernel", "tail_kernel", "flash_fwd_wgmma",
                "flash_fwd_f32", "decode_split_kernel")
# each wrapper and the device kernels it launches, one a call
WRAPPER_KERNELS = {"aggregate": ("agg_kernel",),
                   "aggregate_sample": ("tail_kernel",),
                   "flash_attention": ("flash_fwd_wgmma", "flash_fwd_f32"),
                   "decode_attention": ("decode_split_kernel",)}

# workload of phase 3
N_PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 192, 24
MAX_LEN = PROMPT_LEN + NEW_TOKENS

# qwen3-1.7b's depth in the serving of phases 3, 6 and 8 (c) and the
# training of phases 8 (b) and 9 (d): 14 of its 28 layers, every width as
# published (phases 7, 16 and 17 keep all 28). With these phases and
# phases 11, 12, 13 and 15 at the depths they had before, the whole smoke
# took 1,055.6 s of phases on one host and passed the 1200 s allowed on
# another: their traced eager loops, profiled steps and consensus rounds
# scale with the depth
QWEN_CUT_LAYERS = 14

# traces of one main-path call before a lost event fails the check
TRACE_TRIES = 8

# phase 5: (config, layers kept or None for all of them), every width as
# published. llama3-405b: the whole model does not fit one card; the
# others keep 4 of their 32 layers so that the smoke, grown by phases 8 and
# 11, keeps its time (their eager steps, traced, set phase 5's time)
WIDE_CONFIGS = (("starcoder2-7b", 4), ("minitron-4b", 4),
                ("phi-3-vision-4.2b", 4), ("llama3-405b", 2))
# phase 6, continuous batching: qwen3-1.7b at full width through the
# scheduler; 64 requests of prompt 32..320 and budget 16..64 tokens (numpy
# seed 6) and one that cannot fit a slot; pool tokens held against a solo
# generate on the first POOL_SOLO requests
POOL_SLOTS, POOL_MAX_LEN, POOL_BLOCK = 32, 512, 8
POOL_REQUESTS, POOL_SOLO = 64, 8
POOL_PROMPT, POOL_NEW = (32, 320), (16, 64)

# shared vs replicated teacher-forced logits, over the largest |logit|:
# cuBLAS may round a batch-32 product unlike a batch-4 one, and bf16
# rounds at other places through the depth (phase 3's prefill tolerance)
LAYOUT_TOL = 5e-2
# a moe config's two runs may part past LAYOUT_TOL only after a router
# near-tie flips an expert, where their router probabilities differ by at
# most this much (rounding; a wrong kernel moves them by ~1/E)
FLIP_PROB_TOL = 1e-2

# phase 7, training: qwen3-1.7b at full width, W workers emulated on the
# card, one TRAIN_SEQ-token sequence each; AdamW at repro's defaults;
# repro's rule int(alpha * (W - 1)) makes 1 of 8 rows Byzantine at 0.25,
# and 2 at 0.3 (the robustness contract of part b)
TRAIN_W, TRAIN_SEQ, TRAIN_K, TRAIN_LR = 8, 4096, 10, 1e-4
TRAIN_ALPHA, TRAIN_ROBUST_ALPHA = 0.25, 0.3
# part b: a leaf carries a direction the clean workers share when their
# rows' mean cosine with the clean VRMOM aggregate reaches this (8 rows of
# pure noise give ~0.35)
SIGNAL_COS = 0.5
INLOOP_SEQ = 1024

# phase 8, the adaptive tier: BENCH_regimes.json's acceptance block (alie
# and ipm at alpha 0.2, the fixed arms at assumed_alpha 0, the adaptive
# arms at the census's alpha_hat; the record's gate) at 5x its 96
# replications; training at phase 7's setup with ipm on int(0.4 * 7) = 2
# rows (the regimes train wire), the state carried over ADAPT_STEPS
ADAPT_REPS, ADAPT_BATCH, ADAPT_ALPHA, ADAPT_GATE = 480, 240, 0.2, 0.90
ADAPT_ATTACKS = ("alie", "ipm")
ADAPT_ARMS = ("vrmom", "median", "vrmom_adaptive", "auto_gm")
ADAPT_TRAIN_ALPHA, ADAPT_STEPS = 0.4, 3

# phase 9, consensus: BENCH_dist.json's degradation grid (benchmarks/
# dist.py: n 8, f 1, one pinned row, C 512) at 8x its 8 seeds;
# tests/test_consensus.py's coverage cell at 480 replications; phase 7's
# training on the consensus wire, the faulted step cut in depth to what
# CONS_FAULT_BUDGET_S seconds of reckoned fault-path rounds allow
CONS_N, CONS_C, CONS_SEEDS = 8, 512, 64
CONS_DROPOUTS = (0.0, 0.05, 0.1, 0.2, 0.3, 0.5)
CONS_ATTACKS = ("alie", "omniscient")
CONS_REPS, CONS_BATCH = 480, 240
CONS_STEPS, CONS_FAULT_BUDGET_S = 3, 30.0

# phase 10, the moe family: granite-moe-3b-a800m at full width and
# MOE_GRANITE_LAYERS of 32 layers with phase 3's workload, the (layout,
# attack, fused) runs of MOE_TRACED held against their eager loops, their
# generates traced (the rest of the matrix runs its graph generate alone,
# untraced, to hold the smoke's time), and behind the scheduler (16
# requests of phase 6's ranges over 8 slots of 512);
# mixtral-8x7b at MOE_MIXTRAL_LAYERS of 32 layers, and one prompt whose
# last tokens run the 4096-slot ring past its end
MOE_TRACED = (("shared", "signflip", True), ("shared", "signflip", False),
              ("replicated", "signflip", True))
MOE_POOL_SLOTS, MOE_POOL_REQUESTS, MOE_POOL_SOLO = 8, 16, 4
MOE_MIXTRAL_LAYERS, MOE_RING_PROMPT = 4, 4090
# granite's depth in phase 10: 8 of its 32 layers since phase 11 came in,
# to hold the smoke's time (its traced steps set phase 10's time)
MOE_GRANITE_LAYERS = 8

# phase 11, the ssm and hybrid families: mamba2-2.7b and zamba2-7b at full
# width and the depth of SSM_SERVE_LAYERS with phase 3's workload, one engine a
# (layout, attack, fused) run of SSM_RUNS, each serving a graph generate; the
# two runs of SSM_TRACED also serve the eager loop, their generates traced
# (mamba2: both tails, whose kernels it times; zamba2: both layouts, whose B3
# shapes it times); zamba2 behind the scheduler as phase 10 (b)
SSM_RUNS = (("shared", "none", True), ("shared", "signflip", True),
            ("shared", "signflip", False), ("shared", "gaussian", True),
            ("replicated", "none", True), ("replicated", "signflip", True),
            ("replicated", "gaussian", False))
SSM_TRACED = {"mamba2-2.7b": (("shared", "signflip", True),
                              ("shared", "signflip", False)),
              "zamba2-7b": (("shared", "signflip", True),
                            ("replicated", "signflip", True))}
SSM_CONFIGS = tuple(SSM_TRACED)
# phase 11's depths (QWEN_CUT_LAYERS says why): mamba2-2.7b at 16 of its
# 64 layers; zamba2-7b at phase 15's 15 of its 81, two groups of 6 each
# followed by the shared block, then the 3-layer tail
SSM_SERVE_LAYERS = {"mamba2-2.7b": 16, "zamba2-7b": 15}

# phase 12, the encdec family: whisper-medium at full width and ENCDEC_LAYERS
# of its 24 encoder and 24 decoder layers with phase 3's workload and
# ENCDEC_FRAMES numpy-seeded stub frames a prompt, one engine a run of SSM_RUNS
# (phase 11's matrix), the runs of ENCDEC_TRACED held against their eager
# loops, every call of theirs traced (both tails, whose kernels it times, and
# both layouts, whose B3 shapes it times); behind the scheduler as phase 10
# (b), each request with its own frames
ENCDEC_TRACED = (("shared", "signflip", True),
                 ("shared", "signflip", False),
                 ("replicated", "signflip", True))
ENCDEC_SEED = 12
# phase 12's depth (QWEN_CUT_LAYERS says why): 12 of whisper-medium's 24
# encoder and 12 of its 24 decoder layers. Phase 13 trains it whole: cut,
# its (d) records draw other q/k/v (their generator first fills the B1
# stack of enc_layers.mlp.w_gate, whose size follows the depth), and the
# encoder's B2 under autograd then parts from the f32 plain path by 2.13 %
# of the largest gradient, past its 2e-2 (ROADMAP section C)
ENCDEC_LAYERS = 12

# phase 13, training the encdec family: whisper-medium at full width and
# depth (24 + 24 layers) with phase 7's W, K, lr and alphas; a worker's
# sample is the model's 1500 stub frames and ENCDEC_TRAIN_SEQ decoder
# tokens, whisper's published text context (n_text_ctx)
ENCDEC_TRAIN_SEQ = 448

# phase 14, training the moe family: granite-moe-3b-a800m at full width
# with phase 7's W, K, lr, alphas, TRAIN_SEQ and INLOOP_SEQ, cut to
# MOE_TRAIN_LAYERS of its 32 layers. train_reckoning's 28 B a parameter
# at W = 8 (bf16 params, grads and stack of 8, f32 AdamW moments): a layer
# holds 100,727,808 params and the tied embedding 75.5 M, so 32 layers
# reckon at 92.4 GB, 20 at 58.5 and 16 at 47.2 before ~4 GB of
# activations; qwen3's step peaked 16-18 % over its reckoning, which puts
# 20 layers near 74 GB of the card's 80. W = 4 would leave int(0.25 * 3)
# = 0 Byzantine rows.
MOE_TRAIN_LAYERS = 16
# AdamW's lr in phase 14, not phase 7's 1e-4 (PERF.md section 7). At 1e-4
# the first steps move every router entry by about one bf16 ulp in the
# sign of its gradient: on the seeded model batch 0's next-token CE falls
# while the load-balance term, 0.01 x its sum over the 16 layers (its
# top-1 fractions have no gradient), rises faster, so the loss rises. At
# 1e-5 both fall.
MOE_TRAIN_LR = 1e-5
# phase 14's kernel groups ahead of kernel_group's own: the routing's
# scatter and gather (the loss's gather among them), index_select and its
# backward's index_add, and the capacity cumsum's scan
MOE_ROUTING_KERNELS = tuple((key, "routing") for key in (
    "scatter_gather", "indexSelect", "indexFunc", "scan", "Scan"))

# phase 15, training the ssm and hybrid families at full width with phase
# 7's W, K, lr, alphas, TRAIN_SEQ and INLOOP_SEQ, cut in depth only.
# train_reckoning's 28 B a parameter: a mamba2-2.7b layer holds 40,211,184
# params and the tied embedding 128,716,800, so 16 of its 64 layers
# reckon at 21.6 GB (32 at 39.6, 64 at 75.7; 16 since phase 15 ran at 32
# for QWEN_CUT_LAYERS' reason); a zamba2-7b mamba layer holds
# 77,970,768, the shared block 231,218,176 and the embedding 114,688,000,
# so 15 of its 81 layers (two groups of 6, each followed by the shared
# block, then the 3-layer tail, as the published 13 x 6 + 3 ends) reckon
# at 42.4 GB (21 at 55.5), each before its activations
SSM_TRAIN_LAYERS = 16
HYBRID_TRAIN_LAYERS = 15
# phase 16 (c): new tokens a generate of the full-width capture check
LINT_NEW_TOKENS = 8


class CheckFailed(Exception):
    pass


def at_depth(cfg, layers: int):
    """``cfg`` with ``layers`` layers (an encdec config: that many encoder
    and decoder layers), every width as published."""
    import dataclasses

    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=layers))
    return dataclasses.replace(cfg, n_layers=layers)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_flush(torch, dev):
    """A callable that leaves L2 cold: it sums a 128 MB buffer written once
    here, so L2 then holds clean lines only (``scripts/kernel_ab.py
    --flush read``; a write flush leaves dirty lines that the timed
    kernel's loads may have to write back, PERF.md)."""
    buf = torch.ones(32 * 2 ** 20, dtype=torch.float32, device=dev)
    return lambda: buf.sum()


def timed_ms(fn, torch, flush, iters: int = 20,
             spin: int = SPIN_CYCLES) -> float:
    """Median device time of one call, from a cold L2: the device spins
    ``spin`` cycles after the flush and before the start event, so the
    host has enqueued the call before the device reaches it and the
    events bracket device work only (``scripts/kernel_ab.py``'s timer)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(nbytes: float, bf16_flops: float = 0.0):
    """(ms, what bounds it): the least time the card could take — the bytes
    read and written once over HBM bandwidth, or the bf16 multiply-adds
    over the tensor-core peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = bf16_flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def ptxas_report(build) -> None:
    """Registers, static shared memory and spills of every kernel, from the
    ``-Xptxas -v`` log the build keeps beside each library (attention: the
    bf16 instances at head dims 96 and 128, which the serving paths run)."""
    import re
    import shutil

    demangle = shutil.which("c++filt")
    for lib in build.SOURCES:
        info, cur = {}, None
        for line in build.library_path(lib).with_suffix(".log").read_text(
                ).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = m.group(1)
                info[cur] = dict(regs="?", smem="0", spill="?", stack="?")
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
            if m:
                info[cur]["stack"], info[cur]["spill"] = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                info[cur]["regs"] = m.group(1)
                sm = re.search(r"(\d+) bytes smem", line)
                info[cur]["smem"] = sm.group(1) if sm else "0"
        for name, r in info.items():
            if demangle:
                name = subprocess.run([demangle, name], capture_output=True,
                                      text=True).stdout.strip()
            if lib != "vrmom" and not re.search(
                    r"wgmma<(96|128)>|kernel<(96|128), \d+, __nv_bfloat16, "
                    r"__nv_bfloat16>|ILi(96|128)E", name):
                continue
            print(f"[ptxas] {lib}: {r['regs']} registers, {r['smem']} bytes "
                  f"static smem, {r['spill']} bytes spilled, {r['stack']} "
                  f"bytes stack  {name[:100]}")


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build_all()
    total = time.perf_counter() - t0
    for name, s in seconds.items():
        print(f"[build] {name}: {s:.1f} s")
    print(f"[build] all kernels: {total:.1f} s wall (one nvcc per source, "
          f"in parallel)")
    ptxas_report(build)


def phase_kernels(torch, dev):
    """Each kernel against its plain version; returns per-kernel records
    (without launches, which the main path fills in)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      lengths)
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.vrmom import (aggregate, aggregate_plain,
                                           aggregate_sample,
                                           aggregate_sample_plain, plan_tail)

    g = torch.Generator(device=dev).manual_seed(1234)
    flush = make_flush(torch, dev)
    rec = {}
    V = 151936

    # -- B1 / B4 at the serving stack [m=8, B=4, V] f32 ----------------------
    x = 4.0 * torch.randn((8, 4, V), generator=g, device=dev)
    x2 = x.reshape(8, -1)
    errs = {}
    for method in ("vrmom", "median", "trimmed_mean", "mean"):
        got = aggregate(x, method, K=8, beta=0.25)
        k_trim = 2 if method == "trimmed_mean" else 0
        want = aggregate_plain(x2, method, K=8, k_trim=k_trim).reshape(4, V)
        errs[method] = max_err(got, want)
        require(torch.equal(got, want),
                f"B1 {method} [8,4,{V}] differs from its plain version "
                f"(max err {errs[method]})")
    agg_b1 = aggregate(x, "vrmom", K=8)
    _, tok = aggregate_sample(x, "vrmom", K=8, with_agg=False)
    agg_b4, tok2 = aggregate_sample(x, "vrmom", K=8, with_agg=True)
    _, tok_plain = aggregate_sample_plain(x, "vrmom", K=8)
    require(torch.equal(tok, torch.argmax(agg_b1, -1).to(torch.int32)),
            "B4 greedy tokens differ from argmax over B1's output")
    require(torch.equal(tok, tok_plain) and torch.equal(tok, tok2),
            "B4 greedy tokens differ from the plain tail")
    require(torch.equal(agg_b4, agg_b1),
            "B4's with_agg aggregate differs from B1's bitwise")
    _, tv, ti = aggregate_sample(x, "vrmom", K=8, top_k=50, with_agg=False)
    _, pv, pi = aggregate_sample_plain(x, "vrmom", K=8, top_k=50)
    require(torch.equal(ti, pi) and torch.equal(tv, pv),
            "B4 top-50 (values, indices) differ from the plain tail's order")
    # honest replicas + 2 sign-flipped rows: the degenerate-scale guard
    honest = x[:1].expand(8, 4, V).clone()
    honest[6:] = -honest[6:]
    _, tok_h = aggregate_sample(honest, "vrmom", K=8, with_agg=False)
    require(torch.equal(tok_h, torch.argmax(x[0], -1).to(torch.int32)),
            "B4 under signflip does not return the honest argmax")
    # other worker counts and bf16
    for m, C in ((3, 4 * 4096), (100, 65536)):
        xm = torch.randn((m, C), generator=g, device=dev)
        for method, Kq in (("vrmom", 8), ("vrmom", 10), ("median", 8)):
            require(torch.equal(aggregate(xm, method, K=Kq),
                                aggregate_plain(xm, method, K=Kq)),
                    f"B1 {method} K={Kq} at m={m} differs from its plain "
                    f"version")
    xb = x.to(torch.bfloat16)
    for method in ("vrmom", "median", "trimmed_mean", "mean"):
        outb = aggregate(xb, method, K=8, beta=0.25)
        k_trim = 2 if method == "trimmed_mean" else 0
        require(outb.dtype == torch.bfloat16 and torch.equal(
            outb, aggregate_plain(xb.reshape(8, -1), method, K=8,
                                  k_trim=k_trim).reshape(4, V)),
            f"B1 {method} on a bf16 stack differs from its plain version")
    # K = 10 (the Estimator's default), C not a multiple of the vector
    # width, and a stack whose base is not 16-byte aligned
    buf = torch.randn(8 * (V + 1) + 1, generator=g, device=dev)
    for what, xs, Kq in (
            ("K=10", x2, 10),
            (f"C={V + 1}", buf[:8 * (V + 1)].view(8, V + 1), 8),
            ("misaligned base", buf[1:1 + 8 * V].view(8, V), 8)):
        for method in ("vrmom", "median", "trimmed_mean", "mean"):
            k_trim = 2 if method == "trimmed_mean" else 0
            require(torch.equal(aggregate(xs, method, K=Kq, beta=0.25),
                                aggregate_plain(xs, method, K=Kq,
                                                k_trim=k_trim)),
                    f"B1 {method} ({what}) differs from its plain version")
    plan = plan_tail(8, V, 50)
    print(f"[B1/B4] exact against the plain versions: {json.dumps(errs)}; "
          f"also at K=10, m=3, m=100, bf16, C={V + 1} and a misaligned "
          f"base; fused greedy == argmax(B1) == plain tail; top-50 order "
          f"equal; "
          f"B4 tiles of {plan.tile} coordinates, {plan.n_blk} blocks a row, "
          f"{8 * plan.tile} bytes of dynamic shared memory a block for "
          f"top-k")

    stack_bytes = x.numel() * 4
    t_b1 = timed_ms(lambda: aggregate(x, "vrmom", K=8), torch, flush)
    t_b1p = timed_ms(lambda: aggregate_plain(x2, "vrmom", K=8), torch,
                     flush, iters=5, spin=PLAIN_SPIN_CYCLES)
    b1_bound = bound(stack_bytes + 4 * V * 4)
    rec["aggregate"] = dict(
        name="B1 aggregate (vrmom, m=8, [8,4,151936] f32)", route="cuda",
        source="src/repro_torch/kernels/csrc/vrmom.cu",
        replaces="src/repro/kernels/vrmom.py:142",
        max_abs_err=errs["vrmom"], ms=t_b1, plain_ms=t_b1p,
        bound_ms=b1_bound[0], bound_by=b1_bound[1], library_ms=None)
    t_b4 = timed_ms(lambda: aggregate_sample(x, "vrmom", K=8,
                                             with_agg=False),
                    torch, flush)
    t_b4p = timed_ms(lambda: aggregate_sample_plain(x, "vrmom", K=8,
                                                    with_agg=False),
                     torch, flush, iters=5, spin=PLAIN_SPIN_CYCLES)
    b4_bound = bound(stack_bytes + 4 * 4)
    rec["aggregate_sample"] = dict(
        name="B4 aggregate_sample (vrmom greedy, m=8, [8,4,151936] f32)",
        route="cuda", source="src/repro_torch/kernels/csrc/vrmom.cu",
        replaces="src/repro/kernels/vrmom.py:242",
        max_abs_err=max_err(tok, tok_plain), ms=t_b4, plain_ms=t_b4p,
        bound_ms=b4_bound[0], bound_by=b4_bound[1], library_ms=None)

    # -- B2 at the prefill shape ---------------------------------------------
    # bf16 kernel output against the plain version in f32 from the same bf16
    # inputs: one bf16 rounding of the output (2^-9 relative), the bf16
    # rounding of each softmax weight before P.V, and f32 sums in another
    # order.
    atol, rtol = 1e-2, 1e-2
    q = torch.randn((4, 192, 16, 128), generator=g, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn((4, 192, 8, 128), generator=g, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn((4, 192, 8, 128), generator=g, device=dev
                    ).to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    e2 = max_err(out, ref)
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
    require(torch.equal(out, flash_attention(q, k, v, causal=True)),
            "B2: two calls on the same inputs differ")
    for dh in HEAD_DIMS:
        for S, T in ((100, 150), (193, 193)):
            qr, kr, vr = (torch.randn((2, n, h, dh), generator=g, device=dev
                                      ).to(torch.bfloat16)
                          for n, h in ((S, 8), (T, 2), (T, 2)))
            for causal in (True, False):
                torch.testing.assert_close(
                    flash_attention(qr, kr, vr, causal=causal).float(),
                    flash_attention_plain(qr.float(), kr.float(), vr.float(),
                                          causal=causal),
                    atol=atol, rtol=rtol)
    # Shape<128>::kSmem in csrc/flash_attention.cu: Q and two stages of K
    # and V, each 64 rows of 256 bytes, plus 1 KB to align the panels
    smem = 5 * 64 * 128 * 2 + 1024
    print(f"[B2] causal [4,192,16,128] x [4,192,8,128] bf16 (wgmma) max err "
          f"{e2:.3g} (tolerance {atol} + {rtol}*|ref|), bitwise repeatable; "
          f"dh {HEAD_DIMS} at S,T = 100,150 and 193,193, causal and not, ok; "
          f"{smem} bytes of dynamic shared memory per block at dh 128")
    t_b2 = timed_ms(lambda: flash_attention(q, k, v, causal=True), torch,
                    flush)
    t_b2p = timed_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                     torch, flush, iters=5, spin=PLAIN_SPIN_CYCLES)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    t_b2l = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), torch, flush)
    pairs = 4 * 16 * sum(min(i + 1, 192) for i in range(192))
    b2_bound = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                     4 * 128 * pairs)
    rec["flash_attention"] = dict(
        name="B2 flash_attention (causal, q [4,192,16,128] bf16)",
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:76",
        max_abs_err=e2, ms=t_b2, plain_ms=t_b2p, bound_ms=b2_bound[0],
        bound_by=b2_bound[1], library_ms=t_b2l)

    # -- B3 at the decode shape ----------------------------------------------
    T = MAX_LEN
    qd = torch.randn((4, 1, 16, 128), generator=g, device=dev
                     ).to(torch.bfloat16)
    kc = torch.randn((4, T, 8, 128), generator=g, device=dev
                     ).to(torch.bfloat16)
    vc = torch.randn((4, T, 8, 128), generator=g, device=dev
                     ).to(torch.bfloat16)
    lens = torch.tensor([T, 100, 1, 37], dtype=torch.int32, device=dev)
    e3 = 0.0
    for kv_len in (None, lens):
        ln = lengths(kv_len, 4, T, dev)
        out = decode_attention(qd, kc, vc, kv_len=kv_len)
        ref = decode_attention_plain(qd.float(), kc.float(), vc.float(), ln)
        e3 = max(e3, max_err(out, ref))
        torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
    # every length at a 32-key chunk edge, as a scalar and per row
    for n in (0, 1, 31, 32, 33, 63, 64, 65, T - 1, T):
        ref = decode_attention_plain(qd.float(), kc.float(), vc.float(),
                                     lengths(n, 4, T, dev))
        for kv_len in (n, torch.full((4,), n, dtype=torch.int32,
                                     device=dev)):
            torch.testing.assert_close(
                decode_attention(qd, kc, vc, kv_len=kv_len).float(), ref,
                atol=atol, rtol=rtol)
    require(torch.equal(decode_attention(qd, kc, vc, kv_len=150),
                        decode_attention(qd, kc, vc, kv_len=150)),
            "B3: two calls on the same inputs differ")
    k8 = torch.randint(-127, 128, kc.shape, generator=g, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, vc.shape, generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((4, T), generator=g, device=dev) * 0.02
    vs = torch.rand((4, T), generator=g, device=dev) * 0.02
    torch.testing.assert_close(
        decode_attention(qd, k8, v8, kv_len=lens, k_scale=ks,
                         v_scale=vs).float(),
        decode_attention_plain(qd.float(), k8, v8, lens, ks, vs),
        atol=atol, rtol=rtol)
    # batch 32 (the replicated path: 2 splits against 7 at batch 4): each
    # row must come out bitwise as it does at batch 4
    q32 = torch.randn((32, 1, 16, 128), generator=g, device=dev
                      ).to(torch.bfloat16)
    k32 = kc.repeat(8, 1, 1, 1)
    v32 = vc.repeat(8, 1, 1, 1)
    for kv_len in (200, lens.repeat(8)):
        out32 = decode_attention(q32, k32, v32, kv_len=kv_len)
        torch.testing.assert_close(
            out32.float(),
            decode_attention_plain(q32.float(), k32.float(), v32.float(),
                                   lengths(kv_len, 32, T, dev)),
            atol=atol, rtol=rtol)
        by4 = torch.cat([decode_attention(
            q32[i:i + 4], kc, vc, kv_len=kv_len if isinstance(kv_len, int)
            else lens) for i in range(0, 32, 4)])
        require(torch.equal(out32, by4),
                "B3 at batch 32 differs bitwise from the same rows at "
                "batch 4")
    # the head dims past 128's instance and the 16-head group bound, in
    # every kv dtype, with per-row lengths around the chunk edges
    lens_w = torch.tensor([T, 33, 1, 64], dtype=torch.int32, device=dev)
    for dh in (96, 112):
        for G in (9, 16):
            qw = torch.randn((4, 1, 2 * G, dh), generator=g, device=dev
                             ).to(torch.bfloat16)
            kw, vw = (torch.randn((4, T, 2, dh), generator=g, device=dev)
                      for _ in range(2))
            kws = vws = None
            for kv in ("float32", "bfloat16", "int8"):
                if kv == "int8":
                    kw, vw = (torch.randint(-127, 128, (4, T, 2, dh),
                                            generator=g, device=dev,
                                            dtype=torch.int8)
                              for _ in range(2))
                    kws, vws = (0.02 * torch.rand((4, T), generator=g,
                                                  device=dev)
                                for _ in range(2))
                else:
                    kw, vw = kw.to(getattr(torch, kv)), vw.to(
                        getattr(torch, kv))
                torch.testing.assert_close(
                    decode_attention(qw, kw, vw, kv_len=lens_w, k_scale=kws,
                                     v_scale=vws).float(),
                    decode_attention_plain(qw.float(), kw, vw, lens_w, kws,
                                           vws),
                    atol=atol, rtol=rtol)
    print(f"[B3] q [4,1,16,128] over [4,{T},8,128] bf16 max err {e3:.3g}; "
          f"lengths 0..{T} at every chunk edge (scalar and per row), int8 + "
          f"scales, batch 32 == batch 4 bitwise, repeat calls bitwise equal; "
          f"dh 96 and 112 at G 9 and 16 in f32, bf16 and int8 caches ok")
    one_kernel = {
        "B4 greedy": lambda: aggregate_sample(x, "vrmom", K=8,
                                              with_agg=False),
        "B4 top-50": lambda: aggregate_sample(x, "vrmom", K=8, top_k=50,
                                              with_agg=False),
        "B3 python-int kv_len": lambda: decode_attention(qd, kc, vc,
                                                         kv_len=200)}
    from repro_torch.device import kernels_in_calls

    per_call = kernels_in_calls(list(one_kernel.values()))
    require(len(per_call) == len(one_kernel)
            and all(len(names) == 1 for names in per_call),
            f"one call should run one device kernel: "
            f"{dict(zip(one_kernel, per_call))}")
    print("[one call = one device kernel] " + "; ".join(
        f"{what}: {names[0][:60]}"
        for what, names in zip(one_kernel, per_call)))
    t_b3 = timed_ms(lambda: decode_attention(qd, kc, vc), torch, flush)
    full = lengths(None, 4, T, dev)
    t_b3p = timed_ms(lambda: decode_attention_plain(qd, kc, vc, full), torch,
                     flush, iters=10, spin=PLAIN_SPIN_CYCLES)
    qdt, kct, vct = (a.transpose(1, 2).contiguous() for a in (qd, kc, vc))
    t_b3l = timed_ms(lambda: F.scaled_dot_product_attention(
        qdt, kct, vct, enable_gqa=True), torch, flush)
    b3_bound = bound(2 * (kc.numel() + vc.numel() + 2 * qd.numel()),
                     4 * 128 * 16 * 4 * T)
    rec["decode_attention"] = dict(
        name=f"B3 decode_attention (q [4,1,16,128], cache [4,{T},8,128] "
             f"bf16)", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:158",
        max_abs_err=e3, ms=t_b3, plain_ms=t_b3p, bound_ms=b3_bound[0],
        bound_by=b3_bound[1], library_ms=t_b3l)
    return rec


def traced_call(torch, K, fn, what: str, again=None):
    """(result, host ms of the call to a synchronised end under the tracer
    (the profiler's start, its fills and its spin left out), the launches
    the wrappers counted, the launches in the call's torch.profiler trace:
    each wrapper's device kernels, eager or replayed, those kernels in
    launch order as (name, device µs), and the calls made beyond the
    first). ``device_kernel_events`` calls ``fn`` again when its trace
    lost the spin: each such call is printed and ``again()`` runs before
    it; the result, the host ms and the wrappers' counts are those of the
    call whose trace it returns, the last."""
    from repro_torch.device import device_kernel_events

    calls, last = [], {}

    def once():
        if calls:
            print(f"[trace] {what}: the trace lost its spin; re-called")
            if again is not None:
                again()
        calls.append(1)
        before = K.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        last["ms"] = (time.perf_counter() - t0) * 1e3
        after = K.launch_counts()
        last["counted"] = {k: after[k] - before[k] for k in after}
        return out

    out, evs = device_kernel_events(once)
    ran = [(name, us) for name, us in evs
           if any(k in name for k in PORT_KERNELS)]
    traced = {w: sum(any(k in name for k in ks) for name, _ in ran)
              for w, ks in WRAPPER_KERNELS.items()}
    return out, last["ms"], last["counted"], traced, ran, len(calls) - 1


def first_generate(eng, key):
    """``eng.generate`` that first drops the step captured for ``key``:
    called again (a trace that lost its spin, or differed), the first
    generate still runs its step eagerly on the capture stream and
    captures anew, and its tokens are never a replay's."""
    def first_generate(*args, **kw):
        eng.graphs.pop(key, None)
        return eng.generate(*args, **kw)
    return first_generate


def add_counts(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def graph_and_eager(torch, K, eng, batch, what: str, sampling=None,
                    seed=None):
    """One engine's ``generate_python_loop`` and its ``generate`` twice, on
    one batch, each call traced. The loop is the eager baseline; the first
    generate runs one step eagerly on the capture stream, captures the
    step and replays it; the second only replays. Tokens must be identical
    (with ``sampling``, from one ``seed`` each). The loop's trace must hold
    what the wrappers counted, each generate's trace the same, kernel by
    kernel, and the second generate's wrappers must count no decode kernel
    (its steps all replays). The tracer loses a run of events from some
    traces of tens of thousands (on an H100, about one phase-5 trace in
    seven): a call whose trace differs is run and traced again,
    ``TRACE_TRIES`` times in all, before the check fails; a call whose
    trace lost its spin is called again inside ``traced_call``. Both count
    in ``retraced``. ``launches``: the three complete traces together."""
    from repro_torch.serve.engine import GREEDY

    args = (batch, NEW_TOKENS) if sampling is None else (
        batch, NEW_TOKENS, sampling)
    retraced = 0

    def seeded(fn):
        # a generator seeded anew at every call: traced_call may call again
        # (a trace that lost its spin), and a generator made once would run
        # that call from where the first left it, its sampled tokens apart
        # from the eager loop's
        def call():
            kw = {} if seed is None else dict(generator=torch.Generator(
                device=eng.device).manual_seed(seed))
            return fn(*args, **kw)
        return call

    def traced(fn, want=None):
        nonlocal retraced
        for _ in range(TRACE_TRIES):
            out, ms, counted, ran, _, again = traced_call(
                torch, K, seeded(fn), f"'{what}' {fn.__name__}")
            retraced += again
            if ran == (counted if want is None else want):
                return out, ms, counted, ran
            retraced += 1
            print(f"[trace] '{what}' {fn.__name__}: the trace holds "
                  f"{ran}, expected {counted if want is None else want}; "
                  f"traced again")
        raise CheckFailed(f"'{what}' {fn.__name__}: {TRACE_TRIES} traces "
                          f"differ from the launches expected")

    eager, eager_ms, eager_c, eager_t = traced(eng.generate_python_loop)
    first, first_ms, _, first_t = traced(
        first_generate(eng, sampling or GREEDY), eager_c)
    graph, graph_ms, graph_c, graph_t = traced(eng.generate, eager_c)
    require(graph_c["decode_attention"] == 0 and eager_t[
        "decode_attention"] > 0, f"'{what}': a replayed generate's wrappers "
                                 f"counted {graph_c}: a decode step ran "
                                 f"eagerly")
    launches = {}
    for t in (first_t, graph_t, eager_t):
        add_counts(launches, t)
    st = eng.graphs[sampling or GREEDY]
    return dict(toks=graph, first_ms=first_ms, graph_ms=graph_ms,
                eager_ms=eager_ms, graph_n=graph_t, eager_n=eager_t,
                graph_counted=graph_c, launches=launches,
                capture_s=st.capture_s, retraced=retraced,
                same=torch.equal(first, graph) and torch.equal(graph, eager))


def phase_serve(torch, dev, card: str):
    """Full-width qwen3-1.7b robust serving: ``ServeEngine.generate`` (the
    decode step captured once and replayed every token) against
    ``generate_python_loop`` (eager). Returns the kernel launch counts of
    the main path."""
    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.core.estimator import Estimator
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, Sampling, ServeEngine

    full = get_arch("qwen3-1.7b")
    cfg = at_depth(full, QWEN_CUT_LAYERS)
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    print(f"[serve] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
          f"(QWEN_CUT_LAYERS), d {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, dh {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B params "
          f"bf16 ({2 * n_params / 1e9:.2f} GB), seeded init "
          f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    batch = {"tokens": tokens}

    def rcfg(**kw):
        return RobustDecodeConfig(**{**dict(m=8, estimator="vrmom", K=8,
                                            alpha=0.25), **kw})

    def engine(robust, **kw):
        return ServeEngine(cfg, params, max_len=MAX_LEN, robust=robust,
                           device=dev, **kw)

    runs = [("plain", engine(None))]
    for share in (True, False):
        for fuse in (True, False):
            for attack in ("none", "signflip", "gaussian"):
                runs.append((f"{attack} {'fused' if fuse else 'unfused'} "
                             f"{'shared' if share else 'replicated'}",
                             engine(rcfg(attack=attack, fuse_tail=fuse,
                                         share_replica_compute=share))))
    # warm-up (cuBLAS handles, allocator): a 2-token generate runs its one
    # step eagerly and captures nothing
    runs[1][1].generate_python_loop(batch, 2)
    runs[1][1].generate(batch, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0; launches from its traces ---------
    K.reset_launch_counts()
    results = {name: graph_and_eager(torch, K, eng, batch, name)
               for name, eng in runs}
    eng_s = dict(runs)["gaussian fused shared"]
    sampled = {sc.method: graph_and_eager(torch, K, eng_s, batch,
                                          f"{sc.method} sampling", sc, 7)
               for sc in (Sampling("temperature", 1.0),
                          Sampling("top_k", 1.0, top_k=50))}
    counted = K.launch_counts()
    # ---------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {}
    for r in list(results.values()) + list(sampled.values()):
        add_counts(counts, r["launches"])

    ref_toks = results["none fused shared"]["toks"]
    require(ref_toks.shape == (N_PROMPTS, NEW_TOKENS),
            f"tokens shape {tuple(ref_toks.shape)}")
    require(bool(((ref_toks >= 0) & (ref_toks < cfg.vocab)).all()),
            "tokens out of the vocabulary")
    for name, r in results.items():
        same = torch.equal(r["toks"], ref_toks)
        print(f"[serve] {name:27s} traced walls: graph {r['first_ms']:7.1f} "
              f"ms (capture {r['capture_s'] * 1e3:6.1f} ms), replayed "
              f"{r['graph_ms']:6.1f} ms, eager {r['eager_ms']:7.1f} ms; graph"
              f" == eager {r['same']}, == 'none fused shared' {same}; traced "
              f"launches a generate {json.dumps(r['graph_n'])}, counted by "
              f"the wrappers when replayed {json.dumps(r['graph_counted'])}"
              f"; calls traced again {r['retraced']}")
        require(r["same"], f"'{name}': generate (graph) and "
                           f"generate_python_loop (eager) tokens differ")
        require(same, f"greedy tokens of '{name}' differ from 'none fused "
                      f"shared'")
    for method, r in sampled.items():
        require(r["same"] and bool(((r["toks"] >= 0)
                                    & (r["toks"] < cfg.vocab)).all()),
                f"{method} sampling, one seed: graph and eager tokens "
                f"differ or leave the vocabulary")
    print("[serve] temperature and top-50 sampling under the gaussian "
          "attack, one seed: graph tokens == eager tokens, traced launches "
          "equal")
    fused = results["signflip fused shared"]["graph_n"]
    require(fused["flash_attention"] == cfg.n_layers
            and fused["decode_attention"] == cfg.n_layers * (NEW_TOKENS - 1)
            and fused["aggregate_sample"] == NEW_TOKENS
            and fused["aggregate"] == 0,
            f"fused greedy launches {fused}, expected B2 {cfg.n_layers}, B3 "
            f"{cfg.n_layers * (NEW_TOKENS - 1)}, B4 {NEW_TOKENS}")
    unfused = results["signflip unfused shared"]["graph_n"]
    require(unfused["aggregate"] == NEW_TOKENS
            and unfused["aggregate_sample"] == 0,
            f"unfused launches {unfused}")
    print(f"[serve] main-path launches {json.dumps(counts)} (the port's "
          f"device kernels in the traces of its calls, replays included; "
          f"the wrappers counted {json.dumps(counted)}, eager launches "
          f"only); peak memory {peak_gb:.2f} GB")
    for name in ("aggregate", "aggregate_sample", "flash_attention",
                 "decode_attention"):
        require(counts[name] > 0, f"kernel {name} never launched on the "
                                  f"main path")

    # ---- prefill on the kernel path against the plain path -------------
    eng_k = dict(runs)["none fused shared"]
    eng_p = engine(rcfg(estimator=Estimator(method="vrmom", K=8,
                                            backend="torch")),
                   attn_backend="torch")
    lk, _ = eng_k.prefill(batch)
    lp, _ = eng_p.prefill(batch)
    rel = max_err(lk, lp) / float(lp.float().abs().max())
    # bf16 rounds at other places on the two paths (f32 scores in the
    # kernel, bf16 scores in the plain mha) through the layers
    require(rel <= 5e-2 and bool(torch.isfinite(lk.float()).all()),
            f"prefill logits kernel vs plain: max err / max |logit| = {rel}")
    print(f"[serve] prefill logits kernel path vs plain path: max err / "
          f"max|logit| = {rel:.3g} (tolerance 5e-2)")

    # ---- end-to-end timings ----------------------------------------------
    prefill_ms = prefill_median(torch, eng_k, batch)
    report_decode(torch, "[serve] qwen3-1.7b robust m=8 vrmom greedy "
                  f"(none fused shared), B={N_PROMPTS}, prompt "
                  f"{PROMPT_LEN}", eng_k, batch, prefill_ms, card)
    return counts


def prefill_median(torch, eng, batch) -> float:
    pre = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.prefill(batch)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(pre)


def report_decode(torch, what, eng, batch, prefill_ms, card,
                  profiled=True) -> None:
    """Decode ms/token, capture time, launches a token and the device-busy
    share, for the graph (a generate of replays only) and the eager loop,
    untraced: the capture of a generate after the engine's graphs are
    dropped, the median of three walls of each (a shared host's spread),
    and, with ``profiled``, one profiled call of each (``"graph"``: of the
    graph generate only)."""
    eng.graphs.clear()
    eng.generate(batch, NEW_TOKENS)  # one eager step, the capture, replays
    capture_ms = next(iter(eng.graphs.values())).capture_s * 1e3
    per = {}
    for mode, fn in (
            ("graph", lambda: eng.generate(batch, NEW_TOKENS)),
            ("eager", lambda: eng.generate_python_loop(batch, NEW_TOKENS))):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(walls)
        print(f"{what}, {mode} generate walls {walls[0]:.1f}, "
              f"{walls[1]:.1f}, {walls[2]:.1f} ms: median {ms:.1f}")
        p = (profile_generate(torch, fn, f"{mode} generate", ms)
             if profiled in (True, mode) else None)
        per[mode] = (ms, p)
    for mode, (ms, p) in per.items():
        decode = (ms - prefill_ms) / (NEW_TOKENS - 1)
        busy = ("not measured" if p is None else
                f"{100 * p['busy_ms'] / ms:.1f}% device-busy")
        launches = ("not measured" if p is None else
                    f"{p['host_launches'] / NEW_TOKENS:.1f} host launches "
                    f"({p['graphs']} graph launches in all) and "
                    f"{p['device_ops'] / NEW_TOKENS:.0f} device kernels a "
                    f"token")
        cap = f", capture {capture_ms:.1f} ms" if mode == "graph" else ""
        print(f"{what}, {NEW_TOKENS} new tokens, {mode}: generate "
              f"{ms:.1f} ms, prefill {prefill_ms:.1f} ms, decode "
              f"{decode:.2f} ms/token, "
              f"{N_PROMPTS * NEW_TOKENS / (ms / 1e3):.1f} tok/s{cap}; "
              f"{launches}; {busy} ({card})")


def profile_generate(torch, fn, label: str, gen_ms: float,
                     tokens: int = NEW_TOKENS):
    """Device time of one generate (or one pool block of ``tokens`` steps)
    by kernel (torch.profiler, CUPTI), against the unprofiled wall: the
    device's busy share, the kernels that take it, the host's launch calls
    (kernels and graphs) and the device kernels run, and each port
    kernel's device µs a call (``kernel_us``, by the names of
    PORT_KERNELS). Returns those numbers, or None if the trace holds no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the raw events, summed by name as key_averages() would: building the
    # profiler's per-event objects for a trace of ~10^5 kernels and as many
    # host ops takes tens of seconds
    by_name, launches, graphs = {}, 0, 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name in ("cudaLaunchKernel", "cuLaunchKernel",
                    "cudaLaunchKernelExC", "cudaGraphLaunch"):
            launches += 1
            graphs += name == "cudaGraphLaunch"
        if ev.device_type() != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        if getattr(ev, "is_user_annotation", lambda: False)() or \
                name.startswith("serve."):
            continue  # a span's range (obs.trace), not device work
        dev_us = ev.duration_ns() / 1e3
        if dev_us > 0:
            us, n = by_name.get(name, (0.0, 0))
            by_name[name] = (us + dev_us, n + 1)
    rows = [(us, n, name) for name, (us, n) in by_name.items()]
    if not rows:
        print(f"[profile] {label}: device time not measured (the profiler "
              f"recorded no device activity)")
        return None
    busy_ms = sum(r[0] for r in rows) / 1e3
    device_ops = sum(r[1] for r in rows)
    print(f"[profile] {label}: device busy {busy_ms:.1f} ms of {gen_ms:.1f} "
          f"ms unprofiled wall ({100 * busy_ms / gen_ms:.1f}% busy); "
          f"{launches} host launch calls ({launches / tokens:.1f} per "
          f"token; {graphs} of them graph launches), {device_ops} device "
          f"kernels ({device_ops / tokens:.0f} per token)")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"[profile] {dev_us / 1e3:8.2f} ms {count:6d}x  {key[:90]}")
    kernel_us = {}
    for dev_us, count, key in rows:
        for k in PORT_KERNELS:
            if k in key:
                kernel_us[k] = dev_us / count
                print(f"[profile] port kernel {dev_us / 1e3:8.3f} ms "
                      f"{count:5d}x ({dev_us / count:7.2f} us each)  "
                      f"{key[:70]}")
    return dict(busy_ms=busy_ms, host_launches=launches, graphs=graphs,
                device_ops=device_ops, kernel_us=kernel_us)


def attn_record(torch, flush, name, q, k, v, *, decode: bool,
                causal: bool = True):
    """B2 (``decode=False``; causal, or not with ``causal=False``) or B3 (a
    python-int length, the whole cache) at one shape: held against its
    plain version, timed beside the plain version and SDPA. Returns the
    record of the ``kernels`` line, without launches."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      lengths)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    B, S, H, dh = q.shape
    T = k.shape[1]
    if decode:
        full = lengths(None, B, T, q.device)

        def run():
            return decode_attention(q, k, v, kv_len=T)

        def plain():
            return decode_attention_plain(q, k, v, full)
        ref = decode_attention_plain(q.float(), k.float(), v.float(), full)
        flops = 4 * dh * H * B * T
    else:
        def run():
            return flash_attention(q, k, v, causal=causal)

        def plain():
            return flash_attention_plain(q, k, v, causal=causal)
        ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal)
        flops = 4 * dh * B * H * (sum(min(i + 1, T) for i in range(S))
                                  if causal else S * T)
    out = run()
    err = max_err(out, ref)
    # bf16 output against the f32 plain version of the same bf16 inputs,
    # as in phase 2
    torch.testing.assert_close(out.float(), ref, atol=1e-2, rtol=1e-2)
    require(torch.equal(out, run()), f"{name}: two calls differ")
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    b = bound(2 * (2 * q.numel() + k.numel() + v.numel()), flops)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/" + (
            "decode_attention.cu" if decode else "flash_attention.cu"),
        replaces="src/repro/kernels/" + (
            "decode_attention.py:158" if decode else
            "flash_attention.py:76"),
        max_abs_err=err, ms=timed_ms(run, torch, flush),
        plain_ms=timed_ms(plain, torch, flush, iters=5,
                          spin=PLAIN_SPIN_CYCLES),
        bound_ms=b[0], bound_by=b[1],
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal and not decode, enable_gqa=True),
            torch, flush))


def layout_check(torch, cfg, params, batch, max_len, shared, replicated,
                 m=8, what="shared vs replicated") -> str:
    """Shared (batch B) against replicated (batch m·B) replica compute,
    teacher-forced on the shared layout's tokens up to the first step where
    the layouts' tokens part (the last step if they never do): their logits
    must agree within LAYOUT_TOL of the largest |logit|, and a parting
    step must be a near-tie, its top-2 gap within twice the largest
    difference of the two layouts' logits in that row. Phase 6 holds a
    solo generate (batch 1) against the pool (batch 32) with m = 32."""
    from repro_torch.models import model as M
    from repro_torch.serve import robust as R

    apart = (shared != replicated).any(0).nonzero()
    t = int(apart[0]) if len(apart) else shared.shape[1] - 1
    require(t >= 1, "the layouts part at token 0, which both sample off the "
                    "same prefill logits")
    B = shared.shape[0]
    moe = getattr(cfg, "moe", None) is not None
    part = None
    with torch.inference_mode():
        _, cs = M.prefill(params, cfg, batch, cache_len=max_len,
                          last_only=True)
        cr = R.flatten_replicas(R.stack_replicas(cs, m), m)
        for i in range(t):
            tok = shared[:, i]
            (ls, cs), ra = routed(lambda: M.decode_step(params, cfg, cs, tok))
            (lr, cr), rb = routed(lambda: M.decode_step(params, cfg, cr,
                                                        tok.repeat(m)))
            if moe and part is None:
                part = routing_parts(torch, ra, rb, rows=B)
                part = part and (i,) + part
    ls, lr = ls.float(), lr[:B].float()
    rel = max_err(ls, lr) / float(ls.abs().max())
    flip = (part is not None and part[3] and part[5] <= FLIP_PROB_TOL)
    require((rel <= LAYOUT_TOL or flip) and bool(torch.isfinite(lr).all()),
            f"{what} logits at step {t}: max err / max |logit| = {rel}; "
            f"routing parts {part}")
    note = (f"logits at step {t}, teacher-forced: max err / max |logit| = "
            f"{rel:.3g} (tolerance {LAYOUT_TOL})")
    if part is not None:
        note += (f"; the routing first parts at step {part[0]}, layer "
                 f"{part[1]}, {part[2]} rows, near-ties {part[3]} (largest "
                 f"gap {part[4]:.3g}, largest probability difference "
                 f"{part[5]:.3g})")
    if rel > LAYOUT_TOL:
        return "tokens part after a router near-tie; " + note
    if not len(apart):
        return "tokens identical; " + note
    rows = (shared[:, t] != replicated[:, t]).nonzero()[:, 0].tolist()
    for r in rows:
        top2 = torch.topk(ls[r], 2).values
        gap = float(top2[0] - top2[1])
        diff = float((ls[r] - lr[r]).abs().max())
        require(gap <= 2 * diff, f"{what}: tokens part at step {t}, row "
                                 f"{r}, with a top-2 gap {gap} above twice "
                                 f"their logit difference {diff}")
        note += (f"; row {r} parts at step {t}: top-2 gap {gap:.4g}, largest "
                 f"layout difference {diff:.4g} (a near-tie)")
    return "tokens part; " + note


def phase_configs(torch, dev, card: str):
    """Phase 5: the configs that reach B2's and B3's wider instances,
    served one at a time at full width. Returns the ``kernels`` records of
    the new instances, with the launches of their config's main path."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.core.estimator import Estimator
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, ServeEngine

    flush = make_flush(torch, dev)
    records = []
    for name, depth in WIDE_CONFIGS:
        t_cfg = time.perf_counter()
        cfg = get_arch(name)
        if depth is not None:
            print(f"[configs] {name}: depth cut to {depth} of "
                  f"{cfg.n_layers} layers (WIDE_CONFIGS); every width as "
                  f"published")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        torch.cuda.synchronize()
        n_params = M.param_count(params)
        g = torch.Generator(device=dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab,
                                         (N_PROMPTS, PROMPT_LEN),
                                         generator=g, device=dev)}
        n_prefix = 0
        if cfg.family == "vlm":
            n_prefix = cfg.vision.n_patches
            batch["patches"] = (0.02 * torch.randn(
                (N_PROMPTS, n_prefix, cfg.d_model), generator=g,
                device=dev)).to(torch.bfloat16)
        max_len = n_prefix + PROMPT_LEN + NEW_TOKENS
        dh, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
        print(f"[configs] {name} [{cfg.family}]: {cfg.n_layers} layers, d "
              f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (G {G}), "
              f"dh {dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
              f"{n_params / 1e9:.3f} B params bf16 "
              f"({2 * n_params / 1e9:.2f} GB); {N_PROMPTS} x "
              f"({n_prefix} patches + {PROMPT_LEN} tokens), {NEW_TOKENS} new")

        def rcfg(**kw):
            return RobustDecodeConfig(**{**dict(m=8, estimator="vrmom", K=8,
                                                alpha=0.25), **kw})

        def engine(robust, **kw):
            return ServeEngine(cfg, params, max_len=max_len, robust=robust,
                               device=dev, **kw)

        runs = {
            "shared": [("none", engine(rcfg())),
                       ("signflip", engine(rcfg(attack="signflip"))),
                       ("gaussian", engine(rcfg(attack="gaussian"))),
                       ("signflip unfused", engine(rcfg(attack="signflip",
                                                        fuse_tail=False)))],
            "replicated": [
                ("signflip", engine(rcfg(attack="signflip",
                                         share_replica_compute=False))),
                ("gaussian unfused", engine(rcfg(
                    attack="gaussian", fuse_tail=False,
                    share_replica_compute=False)))],
        }
        warm = runs["shared"][0][1]
        warm.generate_python_loop(batch, 2)  # warm-up
        warm.generate(batch, 2)
        torch.cuda.synchronize()

        # ---- this config's main path: counts from 0; launches from its
        # traces ------------------------------------------------------------
        K.reset_launch_counts()
        res = {(layout, what): graph_and_eager(torch, K, eng, batch,
                                               f"{name} {layout} {what}")
               for layout, rs in runs.items() for what, eng in rs}
        counted = K.launch_counts()
        # ------------------------------------------------------------------
        counts = {}
        for r in res.values():
            add_counts(counts, r["launches"])
        ref = res["shared", "none"]["toks"]
        require(ref.shape == (N_PROMPTS, NEW_TOKENS)
                and bool(((ref >= 0) & (ref < cfg.vocab)).all()),
                f"{name}: tokens of shape {tuple(ref.shape)} or outside the "
                f"vocabulary")
        for (layout, what), r in res.items():
            base = res[layout, runs[layout][0][0]]["toks"]
            same = torch.equal(r["toks"], base)
            print(f"[configs] {name} {layout:10s} {what:17s} traced walls:"
                  f" graph {r['first_ms']:7.1f} ms (capture "
                  f"{r['capture_s'] * 1e3:6.1f} ms), replayed "
                  f"{r['graph_ms']:6.1f} ms, eager {r['eager_ms']:7.1f} ms; "
                  f"graph == eager {r['same']}, identical in layout={same}; "
                  f"traced launches a generate {json.dumps(r['graph_n'])}, "
                  f"counted by the wrappers when replayed "
                  f"{json.dumps(r['graph_counted'])}; calls traced again "
                  f"{r['retraced']}")
            require(r["same"], f"{name}: {layout} '{what}' generate (graph) "
                               f"and generate_python_loop (eager) differ")
            require(same, f"{name}: greedy tokens of {layout} '{what}' differ "
                          f"from {layout} '{runs[layout][0][0]}'")
        fused = res["shared", "signflip"]["graph_n"]
        require(fused["flash_attention"] == cfg.n_layers
                and fused["decode_attention"] == cfg.n_layers
                * (NEW_TOKENS - 1)
                and fused["aggregate_sample"] == NEW_TOKENS
                and fused["aggregate"] == 0,
                f"{name}: fused greedy launches {fused}")
        for k_name in ("aggregate", "aggregate_sample", "flash_attention",
                       "decode_attention"):
            require(counts[k_name] > 0, f"{name}: kernel {k_name} never "
                                        f"launched on the main path")
        print(f"[configs] {name} shared vs replicated: " + layout_check(
            torch, cfg, params, batch, max_len, ref,
            res["replicated", "signflip"]["toks"]))

        # ---- the instances that ran, by the device kernels' names
        eng = runs["shared"][0][1]
        flash, dec = instances_ran(torch, eng, params, cfg, batch, ref[:, 0])
        want_dec = (dh, 8 if G <= 8 else 16)
        require(flash == {(dh,)} and dec == {want_dec},
                f"{name}: instances {flash} (B2) and {dec} (B3), expected "
                f"{(dh,)} and {want_dec}")
        print(f"[configs] {name} instances: B2 flash_fwd_wgmma<{dh}> "
              f"(prefill), B3 decode_split_kernel<{want_dec[0]}, "
              f"{want_dec[1]}> (decode step)")

        # ---- prefill on the kernel path against the plain path -----------
        eng_p = engine(rcfg(estimator=Estimator(method="vrmom", K=8,
                                                backend="torch")),
                       attn_backend="torch")
        lk, _ = eng.prefill(batch)
        lp, _ = eng_p.prefill(batch)
        rel = max_err(lk, lp) / float(lp.float().abs().max())
        require(rel <= 5e-2 and bool(torch.isfinite(lk.float()).all()),
                f"{name}: prefill logits kernel vs plain: {rel}")
        print(f"[configs] {name}: prefill logits kernel vs plain path max "
              f"err / max|logit| = {rel:.3g} (tolerance 5e-2); main-path "
              f"launches {json.dumps(counts)} (traced; the wrappers counted "
              f"{json.dumps(counted)}) ({card})")
        report_decode(torch, f"[configs] {name} robust m=8 vrmom greedy "
                      f"(shared none)", eng, batch,
                      prefill_median(torch, eng, batch), card)

        # ---- the new instances at this config's shapes --------------------
        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev
                               ).to(torch.bfloat16)

        Hkv, H = cfg.n_kv_heads, cfg.n_heads
        S = n_prefix + PROMPT_LEN
        new = []
        if dh == 96:
            new.append((f"B2 flash_attention (causal, {name}: q "
                        f"[{N_PROMPTS},{S},{H},{dh}] bf16)",
                        dict(q=rand(N_PROMPTS, S, H, dh),
                             k=rand(N_PROMPTS, S, Hkv, dh),
                             v=rand(N_PROMPTS, S, Hkv, dh), decode=False),
                        "flash_attention"))
        if dh == 96 or G > 8:
            new.append((f"B3 decode_attention ({name}: dh {dh}, G {G}, q "
                        f"[{N_PROMPTS},1,{H},{dh}], cache "
                        f"[{N_PROMPTS},{max_len},{Hkv},{dh}] bf16)",
                        dict(q=rand(N_PROMPTS, 1, H, dh),
                             k=rand(N_PROMPTS, max_len, Hkv, dh),
                             v=rand(N_PROMPTS, max_len, Hkv, dh),
                             decode=True),
                        "decode_attention"))
        for rec_name, kw, kernel in new:
            rec = attn_record(torch, flush, rec_name, **kw)
            rec["launches"] = counts[kernel]
            print(f"[configs] {rec_name}: {rec['ms'] * 1e3:.2f} us device, "
                  f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}),"
                  f" SDPA {rec['library_ms'] * 1e3:.2f} us, plain "
                  f"{rec['plain_ms']:.3f} ms, max err {rec['max_abs_err']:.3g}"
                  f" ({card})")
            records.append(rec)
        del runs, eng, eng_p, params, lk, lp
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"[time] phase 5 {name}: {time.perf_counter() - t_cfg:.1f} s")
    return records


def pool_requests(vocab: int):
    """Phase 6's requests, made with numpy from seed 6: POOL_REQUESTS of
    uniform prompt length and budget, and one whose prompt + budget +
    block overshoot cannot fit a slot."""
    import numpy as np

    rs = np.random.RandomState(6)
    reqs = []
    for _ in range(POOL_REQUESTS):
        S = int(rs.randint(POOL_PROMPT[0], POOL_PROMPT[1] + 1))
        n = int(rs.randint(POOL_NEW[0], POOL_NEW[1] + 1))
        reqs.append((rs.randint(0, vocab, size=(S,)).astype(np.int32), n))
    big = rs.randint(0, vocab, size=(POOL_MAX_LEN - 40,)).astype(np.int32)
    return reqs, (big, 48)


def drain(torch, sched, reqs, oversized=None):
    """Submit ``reqs`` ((prompt, budget) each, or (prompt, budget, extras),
    and ``oversized``) to the scheduler and run it dry -> (completions in
    request order, the oversized one's or None, synchronised wall
    seconds)."""
    from repro_torch.serve import Request

    uids = [sched.submit(Request(tokens=r[0], max_new_tokens=r[1],
                                 extras=r[2] if len(r) > 2 else None))
            for r in reqs]
    big = None if oversized is None else sched.submit(
        Request(tokens=oversized[0], max_new_tokens=oversized[1]))
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([done[u] for u in uids], None if big is None else done[big],
            wall)


def pool_b3_record(torch, flush, lens, H, Hkv, dh, T, g, dev, where="pool"):
    """B3 at the pool's shape: q [32, 1, H, dh] over a [32, T, Hkv, dh] bf16
    cache with the pool's ragged per-row lengths (or another batch and its
    lengths, named by ``where``), against its plain version, each row
    bitwise as at batch 1, timed beside SDPA with the same per-row mask.
    The bound counts the cache rows the lengths reach."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)

    B = lens.shape[0]
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((B, 1, H, dh), (B, T, Hkv, dh),
                             (B, T, Hkv, dh)))
    out = decode_attention(q, k, v, kv_len=lens)
    ref = decode_attention_plain(q.float(), k.float(), v.float(), lens)
    torch.testing.assert_close(out.float(), ref, atol=1e-2, rtol=1e-2)
    rows = [decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                             kv_len=lens[i:i + 1]) for i in range(B)]
    require(torch.equal(out, torch.cat(rows)),
            f"B3 at batch {B} ({where}) differs bitwise from the same rows "
            f"at batch 1")
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[
        :, None, None, :]
    keys = int(lens.sum())
    b = bound(2 * (2 * keys * Hkv * dh + 2 * q.numel()), 4 * dh * H * keys)
    return dict(
        name=f"B3 decode_attention ({where}: q [{B},1,{H},{dh}], cache "
             f"[{B},{T},{Hkv},{dh}] bf16, " + (
                 f"lengths {int(lens.min())}" if bool((lens == lens[0]).all())
                 else f"ragged lengths {int(lens.min())}..{int(lens.max())}")
             + ")", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:158",
        max_abs_err=max_err(out, ref),
        ms=timed_ms(lambda: decode_attention(q, k, v, kv_len=lens), torch,
                    flush),
        plain_ms=timed_ms(lambda: decode_attention_plain(q, k, v, lens),
                          torch, flush, iters=5, spin=PLAIN_SPIN_CYCLES),
        bound_ms=b[0], bound_by=b[1],
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), torch, flush))


def pool_tail_records(torch, flush, B, V, g, dev, where=None,
                      b1_what="pool's temperature tail"):
    """B4 greedy with ``with_agg`` (the obs path) and B1 (the temperature
    tail) on the pool's [8, B, V] f32 stack, each against its plain
    version, bitwise. With ``where`` (another path's name) the B4 record
    times B4 greedy without the aggregate, as that path runs it, and
    ``b1_what`` names B1's use there."""
    from repro_torch.kernels.vrmom import (aggregate, aggregate_plain,
                                           aggregate_sample,
                                           aggregate_sample_plain)

    x = 4.0 * torch.randn((8, B, V), generator=g, device=dev)
    x2 = x.reshape(8, -1)
    agg, tok = aggregate_sample(x, "vrmom", K=8, with_agg=True)
    _, tok_off = aggregate_sample(x, "vrmom", K=8, with_agg=False)
    agg_p, tok_p = aggregate_sample_plain(x, "vrmom", K=8)
    b1 = aggregate(x, "vrmom", K=8)
    b1_p = aggregate_plain(x2, "vrmom", K=8).reshape(B, V)
    require(torch.equal(tok, tok_p) and torch.equal(tok, tok_off)
            and torch.equal(agg, agg_p) and torch.equal(agg, b1)
            and torch.equal(b1, b1_p),
            f"B4 with_agg / B1 at [8,{B},{V}] differ from their plain "
            f"versions, from each other, or with_agg changed the tokens")
    with_agg = where is None
    b4 = bound(x.numel() * 4 + B * 4 + (B * V * 4 if with_agg else 0))
    b1b = bound(x.numel() * 4 + B * V * 4)
    src = dict(route="cuda", source="src/repro_torch/kernels/csrc/vrmom.cu",
               library_ms=None)
    return {
        "aggregate_sample": dict(
            src, name=(f"B4 aggregate_sample (vrmom greedy with_agg, pool: "
                       f"m=8, [8,{B},{V}] f32)" if with_agg else
                       f"B4 aggregate_sample (vrmom greedy, {where}: m=8, "
                       f"[8,{B},{V}] f32)"),
            replaces="src/repro/kernels/vrmom.py:242",
            max_abs_err=max_err(agg, agg_p),
            ms=timed_ms(lambda: aggregate_sample(x, "vrmom", K=8,
                                                 with_agg=with_agg), torch,
                        flush),
            plain_ms=timed_ms(lambda: aggregate_sample_plain(
                x, "vrmom", K=8, with_agg=with_agg), torch, flush, iters=5,
                spin=PLAIN_SPIN_CYCLES),
            bound_ms=b4[0], bound_by=b4[1]),
        "aggregate": dict(
            src, name=f"B1 aggregate (vrmom K=8, {b1_what}: [8,{B},{V}] "
                      f"f32)",
            replaces="src/repro/kernels/vrmom.py:142",
            max_abs_err=max_err(b1, b1_p),
            ms=timed_ms(lambda: aggregate(x, "vrmom", K=8), torch, flush),
            plain_ms=timed_ms(lambda: aggregate_plain(x2, "vrmom", K=8),
                              torch, flush, iters=5, spin=PLAIN_SPIN_CYCLES),
            bound_ms=b1b[0], bound_by=b1b[1])}


def phase_pool(torch, dev, card: str):
    """Phase 6: continuous batching. Full-width qwen3-1.7b (seeded weights)
    behind ``Scheduler`` over a 32-slot pool (robust m = 8, VRMOM K = 8,
    shared replicas, fused tail, obs on), the pool's decode step captured
    once and replayed every token. Returns the ``kernels`` records of the
    phase with the launches of its main path."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.device import device_kernel_counts
    from repro_torch.models import model as M
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import (GREEDY, Request, RobustDecodeConfig,
                                   Sampling, Scheduler, ServeEngine)

    t_phase = time.perf_counter()
    cfg = at_depth(get_arch("qwen3-1.7b"), QWEN_CUT_LAYERS)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    L, Hkv, dh, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    reqs, oversized = pool_requests(cfg.vocab)
    budget = sum(n for _, n in reqs)
    # rates the disagreement histogram counts: a request is active for
    # ceil((n - 1) / block) blocks of POOL_BLOCK steps after admission
    live = POOL_BLOCK * sum(-(-(n - 1) // POOL_BLOCK) for _, n in reqs)
    slot_bytes = L * 2 * POOL_MAX_LEN * Hkv * dh * 2
    print(f"[pool] {cfg.name} at full width and {L} layers, "
          f"ServeEngine(max_len="
          f"{POOL_MAX_LEN}, n_slots={POOL_SLOTS}, robust m=8 vrmom K=8 "
          f"shared fused, obs), Scheduler(decode_block={POOL_BLOCK}), greedy;"
          f" {POOL_REQUESTS} requests, prompts {POOL_PROMPT[0]}.."
          f"{POOL_PROMPT[1]} (mean {np.mean([len(p) for p, _ in reqs]):.1f})"
          f", budgets {POOL_NEW[0]}..{POOL_NEW[1]} ({budget} tokens), + one "
          f"of {len(oversized[0])} + {oversized[1]} tokens; KV reckoned "
          f"{slot_bytes / 1e6:.1f} MB a slot ({L} layers x K,V x "
          f"{POOL_MAX_LEN} x {Hkv} x {dh} x 2 B), "
          f"{POOL_SLOTS * slot_bytes / 1e9:.2f} GB a pool, beside "
          f"{2 * M.param_count(params) / 1e9:.2f} GB of weights")

    def rcfg(attack):
        return RobustDecodeConfig(m=8, estimator="vrmom", K=8, alpha=0.25,
                                  attack=attack)

    engines, scheds = {}, {}
    for attack in ("none", "signflip", "gaussian"):
        engines[attack] = ServeEngine(cfg, params, max_len=POOL_MAX_LEN,
                                      n_slots=POOL_SLOTS,
                                      robust=rcfg(attack),
                                      obs=MetricsRegistry(), device=dev)
        scheds[attack] = Scheduler(engines[attack], decode_block=POOL_BLOCK)
    eng, sched = engines["none"], scheds["none"]
    reg = eng.obs
    gauge = reg.gauges["serve.kv_bytes_per_slot"]
    require(gauge == slot_bytes + 4,
            f"serve.kv_bytes_per_slot {gauge}, reckoned {slot_bytes} + 4 "
            f"(the slot's int32 position)")

    # ---- round 1: set-up (first prefills, the eager first step and the
    # capture of the pool's step); round 2 timed -------------------------
    comp1, rej, wall1 = drain(torch, sched, reqs, oversized)
    capture_ms = eng.pool_graphs[GREEDY].capture_s * 1e3
    comp2, _, wall2 = drain(torch, sched, reqs)
    toks = [c.tokens for c in comp2]
    require(rej.finished_by == "rejected" and rej.tokens == [],
            f"the oversized request finished by {rej.finished_by}")
    require(all(c.finished_by == "length" and len(c.tokens) == n
                for c, (_, n) in zip(comp2, reqs)),
            "a completion lacks its budget of tokens")
    require(all(0 <= t < cfg.vocab for c in comp2 for t in c.tokens),
            "pool tokens outside the vocabulary")
    require(toks == [c.tokens for c in comp1],
            "the pool's tokens differ between two drains of the same "
            "requests")
    ttft, step = (reg.histograms[n] for n in ("serve.ttft_s",
                                              "serve.decode_step_s"))
    print(f"[pool] drain {budget} tokens in {wall2:.3f} s = "
          f"{budget / wall2:.1f} tok/s (round 2; round 1 with set-up "
          f"{wall1:.3f} s); TTFT p50 {ttft.percentile(50) * 1e3:.1f} ms p95 "
          f"{ttft.percentile(95) * 1e3:.1f} ms ({ttft.count} samples, queue "
          f"wait included); decode step p50 {step.percentile(50) * 1e3:.2f}"
          f" ms p95 {step.percentile(95) * 1e3:.2f} ms ({step.count} blocks);"
          f" compile_s {reg.gauges['serve.compile_s']:.4f} s (last set-up "
          f"sample); capture {capture_ms:.1f} ms; kv_bytes_per_slot gauge "
          f"{gauge:.0f} B; rejected {reg.counters['serve.rejected']:.0f}, "
          f"admitted {reg.counters['serve.admitted']:.0f} ({card})")

    # ---- the robustness contract through the pool ----------------------
    for attack in ("signflip", "gaussian"):
        got, _, wall = drain(torch, scheds[attack], reqs)
        h = engines[attack].obs.histograms["serve.replica_disagreement"]
        require([c.tokens for c in got] == toks,
                f"pool tokens under {attack} differ from 'none'")
        print(f"[pool] {attack} a=0.25: tokens identical to none; "
              f"disagreement histogram {h.count} rates (live tokens "
              f"{live}), mean {h.mean:.6f}; drain with set-up {wall:.3f} s")
        if attack == "signflip":
            require(h.count == live and h.mean == 0.25,
                    f"signflip disagreement: {h.count} rates of mean "
                    f"{h.mean}, expected {live} of mean 0.25")
    h = reg.histograms.get("serve.replica_disagreement")
    require(h is not None and h.count == 2 * live and h.mean == 0.0,
            f"'none' disagreement: {h and h.snapshot()}")

    # ---- pool vs solo generate ------------------------------------------
    for i, (p, n) in enumerate(reqs[:POOL_SOLO]):
        batch = {"tokens": torch.from_numpy(p)[None].to(dev)}
        solo = eng.generate(batch, n)
        pooled = torch.tensor([toks[i]], dtype=solo.dtype, device=dev)
        if torch.equal(solo, pooled):
            continue
        print(f"[pool] request {i} (prompt {len(p)}): solo vs pool " +
              layout_check(torch, cfg, params, batch, POOL_MAX_LEN, solo,
                           pooled, m=POOL_SLOTS, what="solo vs pool"))
    print(f"[pool] {POOL_SOLO} requests: pool tokens checked against a solo "
          f"generate (parting only at near-ties)")

    # ---- the main path: counts from 0; launches from its traces ---------
    calls = []
    real = eng.decode_pool

    def counted(pool, cur, n, **kw):
        calls.append(n)
        return real(pool, cur, n, **kw)

    eng.decode_pool = counted
    K.reset_launch_counts()
    launches, retraced = {}, 0
    temp = Sampling("temperature", 1.0)
    short = [(p, POOL_BLOCK + 1) for p, _ in reqs[:POOL_SLOTS]]
    for what, sampling, rs, b1_per_step in (
            ("greedy drain", GREEDY, reqs, 0),
            ("temperature round, capture", temp, short, 1),
            ("temperature round, replays", temp, short, 1)):
        sched.sampling = sampling
        for _ in range(TRACE_TRIES):
            calls.clear()
            (got, _, _), ran = device_kernel_counts(
                lambda: drain(torch, sched, rs), PORT_KERNELS)
            traced = {w: sum(ran[k] for k in ks)
                      for w, ks in WRAPPER_KERNELS.items()}
            steps = sum(calls)
            first = len(rs)  # token 0 of each admission
            want = dict(flash_attention=L * first,
                        decode_attention=L * steps,
                        aggregate_sample=0 if b1_per_step else first + steps,
                        aggregate=(first + steps) * b1_per_step)
            if traced == want:
                break
            retraced += 1
            print(f"[trace] pool '{what}': the trace holds {traced}, "
                  f"expected {want}; run and traced again")
        else:
            raise CheckFailed(f"pool '{what}': {TRACE_TRIES} traces differ "
                              f"from the launches expected")
        if sampling == GREEDY:
            require([c.tokens for c in got] == toks,
                    "the traced drain's tokens differ")
        require(all(len(c.tokens) == n and all(0 <= t < cfg.vocab
                                                for t in c.tokens)
                    for c, (_, n) in zip(got, rs)),
                f"'{what}': completions lack their budget or leave the "
                f"vocabulary")
        add_counts(launches, traced)
        print(f"[pool] {what}: traced launches {json.dumps(traced)} over "
              f"{len(calls)} blocks of {POOL_BLOCK}")
    counted_k = K.launch_counts()
    del eng.decode_pool
    require(counted_k["decode_attention"] == L, f"the wrappers counted "
            f"{counted_k}: B3 should run eagerly only in the first step of "
            f"the temperature capture ({L}); every other step a replay")
    for name in ("aggregate", "aggregate_sample", "flash_attention",
                 "decode_attention"):
        require(launches[name] > 0 and counted_k[name] > 0,
                f"kernel {name} never launched on the pool's main path")
    print(f"[pool] main-path launches {json.dumps(launches)} (traced, "
          f"replays included; the wrappers counted {json.dumps(counted_k)}, "
          f"eager launches only); calls traced again {retraced}")

    # ---- one block at steady state, profiled: every slot live ------------
    prof_out = {}
    for label, sampling in (("greedy", GREEDY), ("temperature", temp)):
        sched.sampling = sampling
        for p, _ in reqs[:POOL_SLOTS]:
            sched.submit(Request(tokens=p, max_new_tokens=6 * POOL_BLOCK))
        sched.step()  # admits every slot, one block
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            sched.step()
            walls.append((time.perf_counter() - t0) * 1e3)
        lens = torch.clamp(sched.pool.caches.pos[:POOL_SLOTS] + 1,
                           max=POOL_MAX_LEN).clone()
        ms = statistics.median(walls)
        p = profile_generate(torch, sched.step, f"pool {label} block "
                             f"({POOL_SLOTS} slots live, {POOL_BLOCK} steps)",
                             ms, tokens=POOL_BLOCK)
        sched.run()
        prof_out[label] = (ms, p, lens)
        print(f"[pool] {label} block walls {walls[0]:.2f}, {walls[1]:.2f}, "
              f"{walls[2]:.2f} ms: {ms / POOL_BLOCK:.3f} ms a step of "
              f"{POOL_SLOTS} tokens; " + (
                  "not measured" if p is None else
                  f"{p['host_launches'] / POOL_BLOCK:.2f} host launch calls "
                  f"a step ({p['graphs']} graph launches a block), "
                  f"{p['device_ops'] / POOL_BLOCK:.0f} device kernels a "
                  f"step, {100 * p['busy_ms'] / ms:.1f}% device-busy") +
              f" ({card})")
    require(prof_out["greedy"][1] is None
            or prof_out["greedy"][1]["graphs"] == POOL_BLOCK,
            "the profiled greedy block is not one graph launch a step")

    # ---- the kernels at the pool's shapes -------------------------------
    flush = make_flush(torch, dev)
    g = torch.Generator(device=dev).manual_seed(66)
    records = {"decode_attention": pool_b3_record(
        torch, flush, prof_out["greedy"][2], H, Hkv, dh, POOL_MAX_LEN, g,
        dev)}
    records.update(pool_tail_records(torch, flush, POOL_SLOTS, cfg.vocab, g,
                                     dev))
    S = int(np.median([len(p) for p, _ in reqs]))
    records["flash_attention"] = attn_record(
        torch, flush, f"B2 flash_attention (causal, admission: q "
        f"[1,{S},{H},{dh}] bf16, the median prompt)",
        *(torch.randn((1, S, h, dh), generator=g, device=dev).to(
            torch.bfloat16) for h in (H, Hkv, Hkv)), decode=False)
    in_loop = {"decode_attention": ("greedy", "decode_split_kernel"),
               "aggregate_sample": ("greedy", "tail_kernel"),
               "aggregate": ("temperature", "agg_kernel"),
               "flash_attention": (None, None)}
    out = []
    for name, rec in records.items():
        rec["launches"] = launches[name]
        cfg_name, kern = in_loop[name]
        p = prof_out[cfg_name][1] if cfg_name else None
        us = None if p is None else p["kernel_us"].get(kern)
        print(f"[pool] {rec['name']}: {rec['ms'] * 1e3:.2f} us device cold,"
              f" in the replayed loop " + ("not measured" if us is None
                                           else f"{us:.2f} us") +
              f", bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}), "
              f"library " + ("none" if rec["library_ms"] is None else
                             f"{rec['library_ms'] * 1e3:.2f} us") +
              f", plain {rec['plain_ms']:.3f} ms, max err "
              f"{rec['max_abs_err']:.3g}, launches {rec['launches']} "
              f"({card})")
        out.append(rec)
    del engines, scheds, eng, sched, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[time] phase 6 in all: {time.perf_counter() - t_phase:.1f} s")
    return out


def paper_kw(cfg, **kw):
    """Phase 4's ``coverage_run`` arguments for a paper config: every
    replication in one chunk (X is 6.06 GB of f32 at 500), 10 rounds,
    seed 1."""
    return dict(model=cfg.model, K=cfg.K, reps=cfg.reps,
                N_per_machine=cfg.n_per_machine, m_workers=cfg.m_workers,
                p=cfg.p, rounds=10, mu_x=cfg.mu_x, batch_size=cfg.reps,
                seed=1, **kw)


def phase_paper(torch, dev, card: str):
    """Phase 4: the paper path. Returns (B1 launches on the path, the
    B1 record at the path's shape)."""
    from repro_torch import kernels as K
    from repro_torch.configs.paper_glm import (PAPER_LINREG,
                                               PAPER_LOGREG_BALANCED)
    from repro_torch.core import attacks, rcsl as R
    from repro_torch.core.estimator import Estimator
    from repro_torch.infer import coverage_run, sandwich as S
    from repro_torch.kernels.vrmom import (aggregate, aggregate_plain,
                                           aggregate_sample,
                                           aggregate_sample_plain)

    g = torch.Generator(device=dev).manual_seed(4321)
    flush = make_flush(torch, dev)

    # -- (a) B1/B4 above K = 64 ---------------------------------------------
    V = 151936
    x = 4.0 * torch.randn((8, 4, V), generator=g, device=dev)
    x101 = torch.randn((101, 65536), generator=g, device=dev)
    for Kq in (64, 65, 100):
        require(torch.equal(aggregate(x, "vrmom", K=Kq),
                            aggregate_plain(x.reshape(8, -1), "vrmom",
                                            K=Kq).reshape(4, V)),
                f"B1 vrmom K={Kq} [8,4,{V}] differs from its plain version")
        require(torch.equal(aggregate(x101, "vrmom", K=Kq),
                            aggregate_plain(x101, "vrmom", K=Kq)),
                f"B1 vrmom K={Kq} [101,65536] differs from its plain version")
        agg, tok = aggregate_sample(x, "vrmom", K=Kq)
        _, tok_p = aggregate_sample_plain(x, "vrmom", K=Kq)
        _, tv, ti = aggregate_sample(x, "vrmom", K=Kq, top_k=50,
                                     with_agg=False)
        _, pv, pi = aggregate_sample_plain(x, "vrmom", K=Kq, top_k=50)
        require(torch.equal(tok, tok_p) and torch.equal(ti, pi)
                and torch.equal(tv, pv)
                and torch.equal(agg, aggregate(x, "vrmom", K=Kq)),
                f"B4 at K={Kq} differs from its plain tail or from B1")
    t_k100 = timed_ms(lambda: aggregate(x, "vrmom", K=100), torch, flush)
    t_b4_k100 = timed_ms(lambda: aggregate_sample(x, "vrmom", K=100,
                                                  with_agg=False),
                         torch, flush)
    print(f"[paper] (a) B1 and B4 (greedy, top-50) at K = 64, 65, 100 on "
          f"[8,4,{V}] and B1 on [101,65536]: bitwise equal to the plain "
          f"versions; device ms at K = 100 on [8,4,{V}] f32: B1 "
          f"{t_k100:.5f}, B4 greedy {t_b4_k100:.5f} ({card})")

    def cell(name, **kw):
        t0 = time.perf_counter()
        c = coverage_run(device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = c.summary()
        require(c.covered.shape == (kw["reps"], kw["p"])
                and all(math.isfinite(s[k])
                        for k in ("coverage", "mean_width", "rmse")),
                f"{name}: non-finite or misshapen results {s}")
        print(f"[paper] {name}: coverage {s['coverage']:.4f}, mean width "
              f"{s['mean_width']:.6f}, RMSE {s['rmse']:.6f}, {kw['reps']} "
              f"replications in {wall:.3f} s wall = "
              f"{kw['reps'] / wall:.1f} replications/s ({card})")
        return c, s, wall

    acc = dict(model="linear", attack="gaussian", alpha=0.1, K=10,
               level=0.95, reps=200, N_per_machine=200, m_workers=100, p=5,
               rounds=6, batch_size=200, seed=0)

    paper = paper_kw
    # warm-up at the cells' own size: cuBLAS and cuSOLVER set-up and the
    # allocator's blocks of several GB out of the timed cells
    coverage_run(device=dev, **paper_kw(PAPER_LINREG, attack="gaussian",
                                        alpha=0.1, estimator="vrmom"))
    torch.cuda.synchronize()

    # ---- the main path: counts from 0 ----------------------------------
    K.reset_launch_counts()
    c_acc, s_acc, _ = cell("(b) BENCH_inference acceptance cell, linear/"
                           "gaussian/a0.1/vrmom K=10", estimator="vrmom",
                           **acc)
    c_v, s_v, wall_v = cell("(c) PAPER_LINREG gaussian a0.1 VRMOM-RCSL",
                            **paper_kw(PAPER_LINREG, attack="gaussian",
                                       alpha=0.1, estimator="vrmom"))
    _, s_m, _ = cell("(c) PAPER_LINREG gaussian a0.1 MOM-RCSL",
                     **paper_kw(PAPER_LINREG, attack="gaussian", alpha=0.1,
                                estimator="median"))
    cell("(c) PAPER_LOGREG_BALANCED labelflip a0.1 VRMOM-RCSL",
         **paper_kw(PAPER_LOGREG_BALANCED, attack="none", alpha=0.1,
                    labelflip=True, estimator="vrmom"))
    counts = K.launch_counts()
    # ---------------------------------------------------------------------
    require(abs(s_acc["coverage"] - 0.95) <= 0.03,
            f"acceptance cell coverage {s_acc['coverage']} not within 0.03 "
            f"of 0.95")
    require(s_v["rmse"] < s_m["rmse"],
            f"PAPER_LINREG: VRMOM-RCSL RMSE {s_v['rmse']} not below "
            f"MOM-RCSL's {s_m['rmse']}")
    # three a cell (one chunk each) for the statistics, one a round of the
    # MOM cell
    want = 3 * 4 + 10
    require(counts["aggregate"] == want,
            f"B1 launches on the paper path {counts['aggregate']}, expected "
            f"{want}")
    print(f"[paper] gates: acceptance coverage {s_acc['coverage']:.4f} "
          f"within 0.03 of 0.95; PAPER_LINREG RMSE VRMOM {s_v['rmse']:.6f} < "
          f"MOM {s_m['rmse']:.6f}; main-path launches {json.dumps(counts)}")

    # -- (d) the kernel against its plain version on this path -------------
    cfg = PAPER_LINREG
    R_chunk = cfg.reps
    theta_star = R.paper_theta_star(cfg.p, device=dev)
    shards = R.make_shards(g, N_per_machine=cfg.n_per_machine,
                           m_workers=cfg.m_workers, p=cfg.p,
                           theta_star=theta_star, reps=R_chunk, device=dev)
    prob = R.LinearRegressionProblem()
    stats = S.machine_stats(prob, theta_star.expand(R_chunk, cfg.p), shards)
    mask = attacks.byzantine_mask(cfg.m_workers + 1, 0.1, device=dev)
    stats = S.corrupt_stats(g, stats, mask, "gaussian")
    del shards
    iu = torch.triu_indices(cfg.p, cfg.p, device=dev)
    m1 = cfg.m_workers + 1

    def stack(t):  # [R, m+1, ..] -> the [m+1, R·d] stack the Estimator makes
        return torch.movedim(t, 1, 0).reshape(m1, -1).contiguous()

    tri = stack(stats.grad2[..., iu[0], iu[1]].float())
    g1 = stack(stats.grad1.float())
    errs = {}
    for what, st in (("grad2 triangle", tri), ("grad1", g1),
                     ("hessian triangle",
                      stack(stats.hessian[..., iu[0], iu[1]].float()))):
        got, want_st = (aggregate(st, "vrmom", K=10),
                        aggregate_plain(st, "vrmom", K=10))
        errs[what] = max_err(got, want_st)
        require(torch.equal(got, want_st),
                f"B1 on one chunk's {what} stack {tuple(st.shape)} differs "
                f"from its plain version")
    del stats
    c_t, _, _ = cell("(d) acceptance cell on the plain Estimator",
                     estimator=Estimator("vrmom", K=10, backend="torch"),
                     **acc)

    def bounds(c):
        mid = R.paper_theta_star(5, device=dev) + c.err
        return mid - c.width / 2, mid + c.width / 2

    (lo_k, hi_k), (lo_t, hi_t) = bounds(c_acc), bounds(c_t)
    d_bounds = max(max_err(lo_k, lo_t), max_err(hi_k, hi_t))
    flips = int((c_acc.covered != c_t.covered).sum())
    print(f"[paper] (d) B1 on one PAPER_LINREG chunk's statistics "
          f"({tuple(tri.shape)} and {tuple(g1.shape)} f32, vrmom K=10): bitwise "
          f"equal to the plain version; acceptance cell, Estimator cuda vs "
          f"torch: largest CI-bound difference {d_bounds:.3g}, {flips} of "
          f"{c_acc.covered.numel()} coverage flags differ")

    # -- (e) times -----------------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        coverage_run(device=dev, **paper_kw(
            PAPER_LINREG, attack="gaussian", alpha=0.1, estimator="vrmom"))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.count, ev.key))
    if rows:
        busy = sum(r[0] for r in rows) / 1e6
        print(f"[paper] (e) one PAPER_LINREG VRMOM cell profiled: device busy "
              f"{busy:.4f} s of {prof_wall:.3f} s profiled wall "
              f"({100 * busy / prof_wall:.1f}% busy; unprofiled wall "
              f"{wall_v:.3f} s) ({card})")
        for us, n, key in sorted(rows, reverse=True)[:10]:
            print(f"[paper] {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")
    else:
        print("[paper] (e) device busy share: not measured (the profiler "
              "recorded no device activity)")
    what = f"[{m1},{R_chunk}*{cfg.p * (cfg.p + 1) // 2}]"
    t_k = timed_ms(lambda: aggregate(tri, "vrmom", K=10), torch, flush)
    t_p = timed_ms(lambda: aggregate_plain(tri, "vrmom", K=10), torch,
                   flush, iters=5, spin=PLAIN_SPIN_CYCLES)
    b = bound(tri.numel() * 4 + tri.shape[1] * 4)
    print(f"[paper] (e) B1 vrmom K=10 on {what} f32: {t_k * 1e3:.1f} us "
          f"device, plain {t_p:.3f} ms, bytes bound {b[0] * 1e3:.1f} us "
          f"({tri.numel() * 4 / 1e6:.1f} MB read); {counts['aggregate']} "
          f"launches on the path ({card})")
    rec = dict(
        name=f"B1 aggregate on the paper path (vrmom K=10, {what} f32: "
             f"PAPER_LINREG statistics)", route="cuda",
        source="src/repro_torch/kernels/csrc/vrmom.cu",
        replaces="src/repro/kernels/vrmom.py:142",
        max_abs_err=errs["grad2 triangle"], ms=t_k, plain_ms=t_p, bound_ms=b[0], bound_by=b[1], library_ms=None)
    return counts["aggregate"], rec


def train_reckoning(cfg, n_params: int, seq: int) -> dict:
    """GB a stacked AdamW step at full width should hold at its peak: bf16
    params and autograd grads, the bf16 stack of W workers, f32 moments,
    the remat boundaries of one sequence, one layer recomputed (``mha``
    at chunk 1024 keeps f32 scores and probabilities of [H, 1024, seq]
    a chunk) and one f32 loss chunk of logits."""
    L, D, H, V = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab
    return {"params": 2 * n_params / 1e9, "grads": 2 * n_params / 1e9,
            "stack": 2 * n_params * TRAIN_W / 1e9,
            "adamw m, v": 8 * n_params / 1e9,
            "remat boundaries": L * seq * D * 2 / 1e9,
            "one layer's recompute": 4 * H * 1024 * seq * 4 * 2 / 1e9,
            "loss chunk": cfg.loss_chunk * V * 4 / 1e9}


def step_kernel_times(torch, fn):
    """Run ``fn`` (one train step) under the profiler: (host wall s, device
    busy s, {kernel name: (count, device s)}) from the raw device events
    (no per-event parsing: a full-width step launches ~10^5 kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        n, s = by.get(ev.name(), (0, 0.0))
        by[ev.name()] = (n + 1, s + ev.duration_ns() / 1e9)
    return wall, sum(s for _, s in by.values()), by


def kernel_group(name: str, extra=()) -> str:
    """The group of a device kernel by its name; the (key, group) pairs of
    ``extra`` are tried after B1's and B2's."""
    for key, group in (("agg_kernel", "B1"), ("flash_fwd", "B2"),
                       *extra,
                       ("gemm", "matmul"), ("nvjet", "matmul"),
                       ("xmma", "matmul"), ("cutlass", "matmul"),
                       ("softmax", "softmax"), ("reduce", "reduction"),
                       ("elementwise", "elementwise"),
                       ("copy", "copy/cast"), ("Copy", "copy/cast")):
        if key in name:
            return group
    return "other"


ROBUST_ATTACKS = ("signflip", "omniscient", "gaussian")


def robust_shift(torch, stack, est, gen, mask) -> dict:
    """How far each attack moves the aggregate of one step's gradient
    stack (a dict of ``[W, ...]`` leaves), over 64M-column blocks. For
    VRMOM and the mean, and each attack of ``ROBUST_ATTACKS`` on the rows
    of ``mask``: ``cos`` of the attacked aggregate h with the clean one c,
    and ``ratio`` = |h - c| over the rows' RMS distance from c. ``zero``
    is |c| over that RMS distance, the ratio of an aggregator that
    returns zeros; ``row_cos`` each clean row's cosine with VRMOM's c.
    ``leaf`` holds the same for each leaf by its key path."""
    from repro_torch.core import attacks as TA
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.tree import paths

    W = int(mask.numel())
    # (path, est, attack) -> [c.h, |c|^2, |h|^2, |h - c|^2, spread^2]
    acc = {}
    rows = {}
    for path, leaf in paths(stack):
        path = ".".join(path)
        flat = leaf.reshape(W, -1)
        rows[path] = torch.zeros((3, W), dtype=torch.float32,
                                 device=mask.device)
        for c0 in range(0, flat.shape[1], 1 << 26):
            x = flat[:, c0:c0 + (1 << 26)].contiguous()
            for name in ("vrmom", "mean"):
                def agg(t):
                    if name == "mean":
                        return RR.aggregate(t, mode="mean").float()
                    return RR.aggregate(t, mode="stacked-auto",
                                        est=est).float()
                c = agg(x)
                spread = torch.sum((x.float() - c[None]) ** 2)
                if name == "vrmom":  # each clean row against VRMOM's
                    rows[path] += torch.stack([
                        x.float() @ c, (c * c).sum().expand(W),
                        (x.float() ** 2).sum(dim=1)])
                for attack in ROBUST_ATTACKS:
                    h = agg(TA.get(attack)(gen, x, mask))
                    a = acc.setdefault((path, name, attack), [0.0] * 5)
                    for j, v in enumerate((torch.dot(c, h), torch.dot(c, c),
                                           torch.dot(h, h),
                                           torch.sum((h - c) ** 2),
                                           spread / W)):
                        a[j] = a[j] + v

    def summary(sums, r):
        out = {"cos": {}, "ratio": {}, "zero": {}}
        for key, a in sums.items():
            out["cos"][key] = a[0] / math.sqrt(a[1] * a[2]) \
                if a[1] * a[2] > 0 else float("nan")
            out["ratio"][key] = math.sqrt(a[3] / a[4]) if a[4] > 0 \
                else float("nan")
            out["zero"][key[0]] = math.sqrt(a[1] / a[4]) if a[4] > 0 \
                else float("nan")
        out["row_cos"] = (r[0] / torch.sqrt(r[1] * r[2])).tolist()
        return out

    acc = {k: [float(v) for v in a] for k, a in acc.items()}
    total = {}
    for (path, name, attack), a in acc.items():
        total[(name, attack)] = [u + v for u, v in zip(
            total.get((name, attack), [0.0] * 5), a)]
    out = summary(total, sum(rows.values()))
    out["leaf"] = {path: summary({k[1:]: a for k, a in acc.items()
                                  if k[0] == path}, r)
                   for path, r in rows.items()}
    return out


def train_setups(cfg, params, dev, lr=TRAIN_LR):
    """Phase 7's and 13's optimizer and steps: VRMOM K ``TRAIN_K``, AdamW
    at ``lr``, stacked-auto over ``TRAIN_W`` workers, under signflip at
    ``TRAIN_ALPHA`` (``setup``) and clean (``clean``) -> (est, opt,
    opt_state, setup, clean, n_byz)."""
    from repro_torch import optim as O
    from repro_torch.core.estimator import Estimator
    from repro_torch.train.step import make_train_step

    est = Estimator("vrmom", K=TRAIN_K)
    opt = O.get("adamw", lr=lr)
    setup = make_train_step(cfg, TRAIN_W, estimator=est, mode="stacked-auto",
                            optimizer=opt, byzantine_frac=TRAIN_ALPHA,
                            attack="signflip", device=dev)
    clean = make_train_step(cfg, TRAIN_W, estimator=est, mode="stacked-auto",
                            optimizer=opt, device=dev)
    return (est, opt, opt.init(params), setup, clean,
            int(TRAIN_ALPHA * (TRAIN_W - 1)))


def train_main_path(torch, cfg, params, opt_state, setup, clean, batch,
                    gen) -> dict:
    """(a)'s main path of a training phase: a clean warm-up step on
    ``batch(0)``, then 3 timed steps of ``setup`` on ``batch(1..3)``, each
    synchronised, the launch counts set to 0 just before them. Requires
    every loss finite and batch 0's loss to fall. Returns loss0 (the
    warm-up's), losses, walls, step_s (their median), counts, peak (GB,
    warm-up included) and loss0_after."""
    from repro_torch import kernels as K
    from repro_torch.models import model as M

    b0 = batch(0)
    torch.cuda.reset_peak_memory_stats()
    _, _, loss0 = clean.step_fn(params, opt_state, b0)  # warm-up, no attack
    loss0 = float(loss0)
    K.reset_launch_counts()   # ---- the main path: counts from 0
    walls, losses = [], []
    for i in range(1, 4):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss = setup.step_fn(params, opt_state, b, gen)
        losses.append(float(loss))  # waits for the step
        walls.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        loss0_after = float(M.loss(params, cfg, b0))
    require(all(math.isfinite(x) for x in [loss0, loss0_after] + losses),
            f"non-finite training loss: {loss0}, {losses}, {loss0_after}")
    require(loss0_after < loss0,
            f"the loss of batch 0 did not fall: {loss0} before, "
            f"{loss0_after} after 4 steps")
    return dict(loss0=loss0, losses=losses, walls=walls,
                step_s=statistics.median(walls), counts=counts, peak=peak,
                loss0_after=loss0_after)


def report_main_path(tag, card, r, tokens, flops, flop_what, reck) -> None:
    """Print (a)'s step time, tokens/s, the share of the bf16 peak that
    ``flops`` a step make (``flop_what`` names the count), the losses and
    the peak against the reckoning ``reck`` (dict of GB)."""
    step_s = r["step_s"]
    print(f"[{tag}] (a) stacked-auto, signflip: step {step_s:.4f} s "
          f"(median of {[round(w, 4) for w in r['walls']]}), "
          f"{tokens / step_s:.1f} tokens/s, {flop_what} at "
          f"{100 * flops / step_s / BF16_FLOP_PER_S:.2f} % of the H100 SXM "
          f"dense bf16 peak ({BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s) ({card})")
    print(f"[{tag}] (a) loss: warm-up step (no attack) {r['loss0']:.5f}, "
          f"steps 1-3 {[round(x, 5) for x in r['losses']]}; batch 0 after "
          f"4 steps {r['loss0_after']:.5f} (falls); launches "
          f"{json.dumps(r['counts'])}")
    print(f"[{tag}] (a) peak memory {r['peak']:.2f} GB against a reckoning "
          f"of {sum(reck.values()):.2f} GB ("
          + ", ".join(f"{k} {v:.2f}" for k, v in reck.items()) + ")")


def report_profiled_step(torch, tag, card, fn, extra_groups=()):
    """Run ``fn`` (one train step) under the profiler and print its wall,
    device-busy share, device time by kernel group (``kernel_group`` with
    ``extra_groups``) and its 8 largest kernels -> (B1, B2 launches in the
    trace)."""
    wall, busy, by = step_kernel_times(torch, fn)
    n_b1 = sum(n for k, (n, _) in by.items() if "agg_kernel" in k)
    n_b2 = sum(n for k, (n, _) in by.items() if "flash_fwd" in k)
    groups = {}
    for k, (n, s) in by.items():
        group = kernel_group(k, extra_groups)
        gn, gs = groups.get(group, (0, 0.0))
        groups[group] = (gn + n, gs + s)
    print(f"[{tag}] (a) one profiled stacked step: {wall:.4f} s wall, "
          f"device busy {busy:.4f} s ({100 * busy / wall:.1f} %), "
          f"{sum(n for n, _ in by.values())} device kernels; B1 {n_b1} "
          f"launches, B2 {n_b2} in the trace ({card})")
    print(f"[{tag}] (a) device time by group: " + ", ".join(
        f"{g} {s:.4f} s ({n}x)" for g, (n, s) in sorted(
            groups.items(), key=lambda kv: -kv[1][1])))
    for k, (n, s) in sorted(by.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[{tag}] {s * 1e3:10.3f} ms {n:7d}x  {k[:90]}")
    return n_b1, n_b2


def split_and_robustness(torch, cfg, params, opt, opt_state, est, gen, b,
                         n_byz, tag, card, apart=()) -> None:
    """The split of one step, and (b) the robustness contract, on the
    workers' gradient stack of batch ``b`` (``TRAIN_W`` workers): 2 rows
    attacked (``TRAIN_ROBUST_ALPHA``) by each of ``ROBUST_ATTACKS``
    (``robust_shift``) and the gates on the whole gradient and on the
    leaves whose clean rows share a direction; ``with_diag`` under
    omniscient must flag exactly the attacked rows. The stack, attacked
    by signflip on ``n_byz`` rows, is aggregated and applied (AdamW) to
    ``params`` in place, each part timed. The clean rows' cosines of the
    leaves named in ``apart`` (dotted key paths) are printed apart."""
    from repro_torch.core import attacks as TA
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.train.step import stacked_grads
    from repro_torch.tree import leaves

    W, dev = TRAIN_W, gen.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stack = stacked_grads(cfg, params, b, W)
    torch.cuda.synchronize()
    t_grads = time.perf_counter() - t0

    mask_b = torch.arange(W, device=dev) >= W - int(TRAIN_ROBUST_ALPHA
                                                    * (W - 1))
    rs = robust_shift(torch, stack, est, gen, mask_b)
    cos, ratio = rs["cos"], rs["ratio"]
    # the leaves where the clean workers share a direction (their rows'
    # mean cosine with the clean VRMOM aggregate >= SIGNAL_COS), chosen
    # from the clean stack alone
    signal = {k: v for k, v in rs["leaf"].items()
              if statistics.mean(v["row_cos"]) >= SIGNAL_COS}

    def shifts(r):
        return "; ".join(f"{n} {atk} {r['cos'][(n, atk)]:.4f} / "
                         f"{r['ratio'][(n, atk)]:.4g}" for n in
                         ("vrmom", "mean") for atk in ROBUST_ATTACKS) + (
            f"; zeros {r['zero']['vrmom']:.4g}")

    print(f"[{tag}] (b) one step's gradient (params after (a)), "
          f"{int(mask_b.sum())} of {W} rows attacked (alpha "
          f"{TRAIN_ROBUST_ALPHA}): cosine with the clean aggregate / its "
          f"shift over the rows' RMS distance from it, whole gradient: "
          + shifts(rs))
    print(f"[{tag}] (b) each clean worker row's cosine with the clean VRMOM "
          f"aggregate {[round(c, 4) for c in rs['row_cos']]}; leaves where "
          f"the rows share a direction (mean row cosine >= {SIGNAL_COS}): "
          f"{sorted(signal)} of {len(rs['leaf'])}")
    for k, v in sorted(signal.items()):
        print(f"[{tag}] (b) {k}, row cosines "
              f"{[round(c, 4) for c in v['row_cos']]}: " + shifts(v))
    for k in apart:
        print(f"[{tag}] (b) {k}: each clean worker row's cosine with the "
              f"clean VRMOM aggregate "
              f"{[round(c, 4) for c in rs['leaf'][k]['row_cos']]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = torch.arange(W, device=dev) >= W - n_byz
    for g in leaves(stack):
        g.copy_(TA.get("signflip")(gen, g, mask))
    agg_tree = RR.aggregate(stack, mode="stacked-auto", est=est)
    torch.cuda.synchronize()
    t_agg = time.perf_counter() - t0
    opt.update(agg_tree, opt_state, params)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0 - t_agg
    del agg_tree
    print(f"[{tag}] (a) the split of one step, synchronised: workers' "
          f"forward + backward {t_grads:.4f} s, signflip + aggregation "
          f"{t_agg:.4f} s, AdamW {t_opt:.4f} s ({card})")

    for g in leaves(stack):
        g.copy_(TA.get("omniscient")(gen, g, mask_b))
    _, diag = RR.aggregate(stack, mode="stacked-auto", est=est,
                           with_diag=True)
    flagged = diag.suspected.tolist()
    print(f"[{tag}] (b) with_diag under omniscient: suspected {flagged}, "
          f"alpha_hat {float(diag.alpha_hat):.4f}, scores "
          f"{[float(f'{s:.4g}') for s in diag.scores.tolist()]}")
    del stack, diag
    require(flagged == mask_b.tolist(),
            f"with_diag flagged {flagged}, attacked {mask_b.tolist()}")
    # the contract. Over the whole gradient the clean rows are as good as
    # orthogonal (cosine 0.27-0.31 with their aggregate at 1 to 8 sequences
    # a worker, scripts/train_robustness.py), and every aggregate, zeros
    # too, is about as far from the clean one: VRMOM must move less than
    # the mean under every attack, and the mean turn round under
    # omniscient. Where the rows share a direction VRMOM must also stay
    # closer to its clean aggregate than zeros are (the zero aggregate's
    # ratio), which zeros do not, nor the mean under omniscient
    for atk in ROBUST_ATTACKS:
        require(ratio[("vrmom", atk)] < ratio[("mean", atk)],
                f"VRMOM's aggregate under {atk} moved "
                f"{ratio[('vrmom', atk)]} of the rows' RMS distance, the "
                f"mean's {ratio[('mean', atk)]}")
    require(not cos[("mean", "omniscient")] > 0,
            f"the mean under omniscient kept cosine "
            f"{cos[('mean', 'omniscient')]}")
    require(bool(signal), f"no leaf's clean rows share a direction (mean "
            f"row cosine >= {SIGNAL_COS})")
    for k, v in signal.items():
        for atk in ROBUST_ATTACKS:
            r = v["ratio"][("vrmom", atk)]
            require(r < v["zero"]["vrmom"] and r < v["ratio"][("mean", atk)],
                    f"{k}: VRMOM's aggregate under {atk} moved {r} of the "
                    f"rows' RMS distance; zeros {v['zero']['vrmom']}, the "
                    f"mean {v['ratio'][('mean', atk)]}")


def inloop_steps(torch, setup, params, opt_state, batches):
    """(c): one inloop step on each of ``batches``, synchronised, the
    launch counts and the peak set to 0 just before them -> (losses,
    walls, counts, peak GB). Requires every loss finite."""
    from repro_torch import kernels as K

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()   # ---- the main path: counts from 0
    losses, walls = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss = setup.step_fn(params, opt_state, b)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    require(all(math.isfinite(x) for x in losses),
            f"non-finite inloop loss {losses}")
    return (losses, walls, K.launch_counts(),
            torch.cuda.max_memory_allocated() / 1e9)


def b1_stack_record(torch, flush, g, C, name, launches):
    """B1 (vrmom, K ``TRAIN_K``) at a ``[TRAIN_W, C]`` bf16 gradient stack
    (a layer-stacked leaf): held bitwise against its plain version on 2^20
    sampled columns and against B1 of the f32 stack then cast, timed
    beside the plain version over 2^25-column blocks."""
    from repro_torch.kernels.vrmom import aggregate, aggregate_plain

    W = TRAIN_W
    x = torch.randn((W, C), generator=g, device=g.device,
                    dtype=torch.bfloat16)
    out = aggregate(x, "vrmom", K=TRAIN_K)
    cols = torch.randint(0, C, (1 << 20,), generator=g, device=g.device)
    want = aggregate_plain(x[:, cols], "vrmom", K=TRAIN_K)
    err = max_err(out[cols], want)
    require(torch.equal(out[cols], want),
            f"B1 at [{W},{C}] bf16 differs from its plain version on "
            f"sampled columns (max err {err})")
    require(torch.equal(out, aggregate(x.float(), "vrmom", K=TRAIN_K).to(
        torch.bfloat16)), f"B1 at [{W},{C}]: bf16 differs from f32 then cast")
    del out

    def plain_blocks():
        for c0 in range(0, C, 1 << 25):
            aggregate_plain(x[:, c0:c0 + (1 << 25)], "vrmom", K=TRAIN_K)

    bb = bound(x.numel() * 2 + C * 2)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/vrmom.cu",
        replaces="src/repro/kernels/vrmom.py:142", launches=launches,
        max_abs_err=err,
        ms=timed_ms(lambda: aggregate(x, "vrmom", K=TRAIN_K), torch, flush),
        plain_ms=timed_ms(plain_blocks, torch, flush, iters=3,
                          spin=PLAIN_SPIN_CYCLES),
        bound_ms=bb[0], bound_by=bb[1], library_ms=None)


def b2_autograd_record(torch, flush, g, name, q, k, v, *, causal: bool,
                       chunk: int, launches):
    """B2 under autograd (``FlashAttentionFn``: B2's forward, the backward
    the VJP of the chunked ``mha`` recomputed at ``chunk``) at q/k/v: its
    gradients held against the plain path's within 2e-2 of the largest,
    timed beside the plain path and SDPA's forward + backward."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attn_backend import FlashAttentionFn

    _, S, H, dh = q.shape
    T = k.shape[1]
    dout = torch.randn(q.shape, generator=g, device=g.device,
                       dtype=q.dtype)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dt = dout.transpose(1, 2).contiguous()

    def pair():
        o = FlashAttentionFn.apply(qg, kg, vg, causal, chunk)
        return torch.autograd.grad(o, (qg, kg, vg), dout)

    def pair_plain():
        o = flash_attention_plain(qg, kg, vg, causal=causal)
        return torch.autograd.grad(o, (qg, kg, vg), dout)

    def pair_sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), dt)

    got, want = pair(), pair_plain()
    scale = max(float(w.abs().max()) for w in want)
    err = max(max_err(a, b) for a, b in zip(got, want))
    # the gradients come from the mha recompute (B2's output is not read
    # by the backward); B2's forward is held against its plain version in
    # the forward records at the same shapes
    require(err <= 2e-2 * scale,
            f"{name}: FlashAttentionFn's mha recompute backward: grads "
            f"differ from the plain path's by {err} (largest {scale})")
    pairs = S * (S + 1) // 2 if causal else S * T
    # q, k, v and the output's gradient read, their three gradients
    # written; 2 products forward, 4 in the backward
    b = bound(2 * 2 * (q.numel() + k.numel() + v.numel()) + 2 * dout.numel(),
              12 * dh * H * pairs)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:76",
        launches=launches, max_abs_err=err,
        ms=timed_ms(pair, torch, flush, iters=5, spin=PLAIN_SPIN_CYCLES),
        plain_ms=timed_ms(pair_plain, torch, flush, iters=5,
                          spin=PLAIN_SPIN_CYCLES),
        bound_ms=b[0], bound_by=b[1],
        library_ms=timed_ms(pair_sdpa, torch, flush, iters=5,
                            spin=PLAIN_SPIN_CYCLES))


def print_train_records(tag, card, recs) -> None:
    for r in recs:
        print(f"[{tag}] (d) {r['name']}: {r['ms'] * 1e3:.2f} us device, "
              f"plain {r['plain_ms']:.3f} ms, {r['bound_by']} bound "
              f"{r['bound_ms'] * 1e3:.2f} us, library "
              + ("none" if r["library_ms"] is None
                 else f"{r['library_ms'] * 1e3:.2f} us")
              + f", {r['launches']} launches on the main path ({card})")


def phase_train(torch, dev, card: str):
    """Phase 7: Byzantine-robust training of qwen3-1.7b at full width (28
    layers, bf16, seeded weights; no cut), W = 8 workers emulated on the
    card. Returns the ``kernels`` records of the phase with the launches
    of its main path (the timed stacked steps and the inloop steps)."""
    from repro_torch.configs import get as get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_arch("qwen3-1.7b")
    W, S, L = TRAIN_W, TRAIN_SEQ, cfg.n_layers
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(7),
                    device=dev)
    n_params = M.param_count(params)
    n_leaves = len(list(leaves(params)))
    est, opt, opt_state, setup, clean, n_byz = train_setups(cfg, params, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = W * S
    print(f"[train] {cfg.name} at full width ({L} layers, d {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B params, bf16), W = {W} workers of one "
          f"{S}-token sequence each, VRMOM K {TRAIN_K}, AdamW lr "
          f"{TRAIN_LR}, alpha {TRAIN_ALPHA} = int({TRAIN_ALPHA} * {W - 1}) "
          f"= {n_byz} signflip row(s), remat {cfg.remat}")

    def batch(i, seq=S):
        return lm_batch(cfg, i, W, seq, device=dev)

    # -- (a) stacked-auto ------------------------------------------------------
    r = train_main_path(torch, cfg, params, opt_state, setup, clean, batch,
                        gen)
    counts = r["counts"]
    n_fwd = 2 if cfg.remat else 1
    require(counts["aggregate"] == 3 * n_leaves
            and counts["flash_attention"] == 3 * W * L * n_fwd,
            f"stacked steps launched {counts}; expected B1 {3 * n_leaves}, "
            f"B2 {3 * W * L * n_fwd}")
    report_main_path("train", card, r, tokens, 6 * n_params * tokens,
                     "6*N*tokens", train_reckoning(cfg, n_params, S))
    # one profiled step: the kernels it launched, the busy share
    n_b1, n_b2 = report_profiled_step(
        torch, "train", card,
        lambda: setup.step_fn(params, opt_state, batch(4), gen))
    require(n_b1 == n_leaves and n_b2 == W * L * n_fwd,
            f"the profiled stacked step ran B1 {n_b1} times and B2 {n_b2}; "
            f"expected {n_leaves} and {W * L * n_fwd}")

    # -- the split of a step, and (b) the robustness contract ------------------
    split_and_robustness(torch, cfg, params, opt, opt_state, est, gen,
                         batch(5), n_byz, "train", card)

    # -- (c) inloop ------------------------------------------------------------
    inloop = make_train_step(cfg, W, estimator=est, mode="inloop",
                             optimizer=opt, device=dev)
    in_losses, in_walls, in_counts, in_peak = inloop_steps(
        torch, inloop, params, opt_state,
        [batch(10 + i, INLOOP_SEQ) for i in range(2)])
    # q, k, v, o, gate, up, down a layer; the unembedding once a loss chunk
    n_dots = 7 * L + -(-INLOOP_SEQ // cfg.loss_chunk)
    require(in_counts["aggregate"] == 2 * n_dots
            and in_counts["flash_attention"] == 2 * L * n_fwd,
            f"inloop steps launched {in_counts}; expected B1 {2 * n_dots}, "
            f"B2 {2 * L * n_fwd}")
    print(f"[train] (c) inloop at {W} x {INLOOP_SEQ} tokens (at 4096 the "
          f"tied unembedding's per-worker dW stacks and the global "
          f"activations of one backward would not fit beside the rest): "
          f"losses {[round(x, 5) for x in in_losses]}, steps "
          f"{[round(w, 4) for w in in_walls]} s, peak memory "
          f"{in_peak:.2f} GB; launches {json.dumps(in_counts)} ({card})")
    del params, opt_state
    torch.cuda.empty_cache()

    # -- (d) the kernels at the training shapes --------------------------------
    flush = make_flush(torch, dev)
    g = torch.Generator(device=dev).manual_seed(70)
    C = L * cfg.d_model * cfg.d_ff   # layers.mlp.w_gate
    rec_b1 = b1_stack_record(
        torch, flush, g, C,
        f"B1 aggregate on the gradient stacks (vrmom K={TRAIN_K}, bf16; "
        f"timed at layers.mlp.w_gate [{W},{C}])", counts["aggregate"])
    rec_b1i = b1_record(
        torch, flush, f"B1 aggregate in the backward (inloop: one matmul's "
        f"dW, vrmom K={TRAIN_K}, [{W},{cfg.d_model}*{cfg.d_ff}] f32)",
        torch.randn((W, cfg.d_model * cfg.d_ff), generator=g, device=dev),
        TRAIN_K, in_counts["aggregate"])

    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((1, S, H, dh), generator=g, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((1, S, Hkv, dh), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((1, S, Hkv, dh), generator=g, device=dev,
                    dtype=torch.bfloat16)
    rec_b2 = attn_record(
        torch, flush, f"B2 flash_attention forward at the training shape "
        f"(q [1,{S},{H},{dh}], k/v [1,{S},{Hkv},{dh}] bf16 causal)",
        q, k, v, decode=False)
    rec_b2["launches"] = counts["flash_attention"]
    # B2 at the inloop steps' shape: the whole global batch in one forward
    rec_b2i = attn_record(
        torch, flush, f"B2 flash_attention forward at the inloop shape "
        f"(q [{W},{INLOOP_SEQ},{H},{dh}], k/v [{W},{INLOOP_SEQ},{Hkv},{dh}] "
        f"bf16 causal)", *(torch.randn(
            (W, INLOOP_SEQ, h, dh), generator=g, device=dev,
            dtype=torch.bfloat16) for h in (H, Hkv, Hkv)), decode=False)
    rec_b2i["launches"] = in_counts["flash_attention"]
    rec_pair = b2_autograd_record(
        torch, flush, g,
        f"B2 under autograd (FlashAttentionFn: B2 forward + the mha "
        f"recompute backward; max_abs_err is the recompute's gradient "
        f"against the plain path's, launches are the stacked steps' B2 "
        f"forwards as above), q [1,{S},{H},{dh}], k/v [1,{S},{Hkv},{dh}] "
        f"bf16 causal; library: SDPA forward + backward",
        q, k, v, causal=True, chunk=cfg.attn_chunk,
        launches=counts["flash_attention"])
    recs = [rec_b1, rec_b1i, rec_b2, rec_b2i, rec_pair]
    print_train_records("train", card, recs)
    print(f"[train] phase 7 in {time.perf_counter() - t_phase:.1f} s")
    return recs


def b1_record(torch, flush, name, x, K, launches):
    """B1 (vrmom) at one stack of phase 8: held against its plain version,
    timed beside it; its byte bound (the stack read once, the aggregate
    written once). No single PyTorch call computes it."""
    from repro_torch.kernels.vrmom import aggregate, aggregate_plain

    got = aggregate(x, "vrmom", K=K)
    want = aggregate_plain(x, "vrmom", K=K)
    require(torch.equal(got, want), f"{name}: B1 differs from its plain "
                                    f"version (max err {max_err(got, want)})")
    bb = bound(x.numel() * x.element_size() + x.shape[1] * x.element_size())
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/vrmom.cu",
        replaces="src/repro/kernels/vrmom.py:142", launches=launches,
        max_abs_err=max_err(got, want),
        ms=timed_ms(lambda: aggregate(x, "vrmom", K=K), torch, flush),
        plain_ms=timed_ms(lambda: aggregate_plain(x, "vrmom", K=K), torch,
                          flush, iters=5, spin=PLAIN_SPIN_CYCLES),
        bound_ms=bb[0], bound_by=bb[1], library_ms=None)


def adaptive_coverage(torch, dev, card: str):
    """Phase 8 (a): BENCH_regimes.json's acceptance block on the card.
    Returns (B1 launches of its main path, the widest triangle stack)."""
    from repro_torch import kernels as K
    from repro_torch.core import adaptive as AD, attacks as TA
    from repro_torch.core.estimator import Estimator
    from repro_torch.infer import coverage_run

    record = json.loads((ROOT / "BENCH_regimes.json").read_text())
    m = 100
    alpha_hat = {}
    for attack in ADAPT_ATTACKS:
        # the adaptive arms' assumed alpha: the census of an attacked
        # [101, 64] stack (benchmarks/regimes.py; torch draws)
        g = torch.Generator(device=dev).manual_seed(0)
        v = torch.randn((m + 1, 64), generator=g, device=dev) + 1.0
        mask = TA.byzantine_mask(m + 1, ADAPT_ALPHA, device=dev)
        alpha_hat[attack] = float(AD.estimate_alpha(
            TA.get(attack)(g, v, mask), backend="auto"))
        want = record["rows"][f"coverage/{attack}/a{ADAPT_ALPHA}/auto_gm"][
            "assumed_alpha"]
        print(f"[adapt] (a) census alpha_hat under {attack} at alpha "
              f"{ADAPT_ALPHA}: {alpha_hat[attack]:.6f} (the JAX record's "
              f"assumed_alpha {want})")
        require(abs(alpha_hat[attack] - want) <= 5e-4,
                f"census alpha_hat {alpha_hat[attack]} under {attack}, the "
                f"record's {want}")
    cov = {}
    K.reset_launch_counts()   # ---- the main path: counts from 0
    for attack in ADAPT_ATTACKS:
        for arm in ADAPT_ARMS:
            adaptive = arm in ("vrmom_adaptive", "auto_gm")
            assumed = alpha_hat[attack] if adaptive else 0.0
            t0 = time.perf_counter()
            c = coverage_run(model="linear", attack=attack,
                             alpha=ADAPT_ALPHA, estimator=Estimator(arm, K=10),
                             reps=ADAPT_REPS, N_per_machine=100,
                             m_workers=m, p=5, rounds=4, level=0.95,
                             batch_size=ADAPT_BATCH, seed=0, device=dev,
                             assumed_alpha=assumed)
            s = c.summary()
            wall = time.perf_counter() - t0
            jr = record["rows"][f"coverage/{attack}/a{ADAPT_ALPHA}/{arm}"]
            require(c.covered.shape == (ADAPT_REPS, 5)
                    and all(math.isfinite(s[k]) for k in
                            ("coverage", "mean_width", "rmse")),
                    f"(a) {attack}/{arm}: non-finite or misshapen {s}")
            cov[(attack, arm)] = s["coverage"]
            print(f"[adapt] (a) {attack} alpha {ADAPT_ALPHA} {arm:15s} "
                  f"assumed {assumed:.4f}: coverage {s['coverage']:.4f}, "
                  f"width {s['mean_width']:.6f}, RMSE {s['rmse']:.6f}, "
                  f"{ADAPT_REPS} replications in {wall:.3f} s (the JAX "
                  f"record, 96 replications on host CPUs: coverage "
                  f"{jr['coverage']:.4f}, width {jr['mean_width']:.6f}, "
                  f"{jr['seconds']} s) ({card})")
    launches = K.launch_counts()["aggregate"]
    require(launches > 0, "(a) the coverage cells launched no B1")
    # the record's own criterion (benchmarks/regimes.py:251-268): at least
    # one stealth regime where both fixed arms fall below the gate while
    # both adaptive arms reach it. Under ipm vrmom sits at the gate itself
    # (0.898-0.903 in repro at 480 replications, seeds 0-2; the record's
    # 0.8708 is one draw of 96), so that regime is reported, and every
    # regime must keep both adaptive arms at or above the gate
    passing = []
    for attack in ADAPT_ATTACKS:
        fixed = [cov[(attack, a)] for a in ("vrmom", "median")]
        adapt = [cov[(attack, a)] for a in ("vrmom_adaptive", "auto_gm")]
        fixed_fail = max(fixed) < ADAPT_GATE
        adaptive_pass = min(adapt) >= ADAPT_GATE
        print(f"[adapt] (a) {attack}: fixed arms {fixed} all < {ADAPT_GATE} "
              f"{fixed_fail}; adaptive arms {adapt} all >= {ADAPT_GATE} "
              f"{adaptive_pass} (the record: "
              f"{record['acceptance']['regimes'][attack]['fixed_fail']}, "
              f"{record['acceptance']['regimes'][attack]['adaptive_pass']})")
        require(adaptive_pass, f"(a) under {attack} an adaptive arm lost "
                               f"coverage: {adapt}")
        if fixed_fail:
            passing.append(attack)
    require(bool(passing), "(a) the regimes gate: no stealth regime where "
                           "both fixed arms fall below it")
    g = torch.Generator(device=dev).manual_seed(80)
    return launches, torch.randn((m + 1, ADAPT_BATCH * 15), generator=g,
                                 device=dev)


def stacked_equal(torch, a, b) -> bool:
    from repro_torch.tree import leaves

    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def adaptive_train(torch, dev, card: str):
    """Phase 8 (b): the stacked-adaptive train step at full width. Returns
    the B1 launches of its main path (the ipm steps of both arms)."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch import optim as O
    from repro_torch.configs import get as get_arch
    from repro_torch.core.adaptive import k_ladder
    from repro_torch.core.estimator import Estimator
    from repro_torch.data import lm_batch
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step, stacked_grads
    from repro_torch.tree import leaves, unflatten

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = at_depth(get_arch("qwen3-1.7b"), QWEN_CUT_LAYERS)
    W, S = TRAIN_W, TRAIN_SEQ
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(7),
                    device=dev)
    n_params = M.param_count(params)
    opt = O.get("adamw", lr=TRAIN_LR)
    opt_state = opt.init(params)
    n_byz = int(ADAPT_TRAIN_ALPHA * (W - 1))
    blocks = sum(-(-p.numel() // RR.WIRE_CHUNK) for p in leaves(params))
    print(f"[adapt] (b) {cfg.name} at full width and {cfg.n_layers} "
          f"layers (QWEN_CUT_LAYERS), W = {W} x {S} tokens, "
          f"AdamW lr {TRAIN_LR}; the adaptive wire walks {blocks} column "
          f"blocks of {RR.WIRE_CHUNK} (an f32 block [{W}, {RR.WIRE_CHUNK}] "
          f"is {W * RR.WIRE_CHUNK * 4 / 1e6:.0f} MB); AdaptiveState momentum "
          f"{4 * n_params / 1e9:.2f} GB f32")

    def batch(i):
        return lm_batch(cfg, i, W, S, device=dev)

    # (i) honest: each arm's adaptive aggregate of one stack against its
    # fixed baseline's, the state at its unit fixed point; this pass is the
    # warm-up, and its synchronised parts the split of a step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stack = stacked_grads(cfg, params, batch(20), W)
    torch.cuda.synchronize()
    t_grads = time.perf_counter() - t0
    t_agg = {}
    for arm in ("vrmom_adaptive", "auto_gm"):
        est = Estimator(arm, K=TRAIN_K)
        st = est.init_adaptive_state(W, n_params, device=dev)
        t0 = time.perf_counter()
        agg, st = RR.aggregate_stacked_adaptive(stack, st, est)
        torch.cuda.synchronize()
        t_agg[arm] = time.perf_counter() - t0
        honest_w, honest_a = st.weights.tolist(), float(st.alpha_hat)
        del st
        if arm == "vrmom_adaptive":
            base = RR.aggregate(stack, mode="stacked-auto",
                                est=Estimator("vrmom", K=TRAIN_K))
        else:
            y = RR.weiszfeld_stacked(stack, torch.ones(W, device=dev))
            parts, off = [], 0
            for p in leaves(params):
                parts.append(y[off:off + p.numel()].reshape(p.shape)
                             .to(p.dtype))
                off += p.numel()
            del y
            base = unflatten(params, parts)
        same = stacked_equal(torch, agg, base)
        del base
        fixed = ("B1 vrmom" if arm == "vrmom_adaptive"
                 else "the geometric median")
        print(f"[adapt] (b) {arm} (i) honest stack: aggregate bitwise equal "
              f"to {fixed} {same}; state weights {honest_w}, alpha_hat "
              f"{honest_a}; adaptive aggregation {t_agg[arm]:.4f} s "
              f"synchronised ({card})")
        require(same and honest_w == [1.0] * W and honest_a == 0.0,
                f"(b) {arm} honest: aggregate equal {same}, weights "
                f"{honest_w}, alpha_hat {honest_a}")
    del stack
    t0 = time.perf_counter()
    opt.update(agg, opt_state, params)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    del agg
    print(f"[adapt] (b) the split of a step, synchronised: workers' forward "
          f"+ backward {t_grads:.4f} s, adaptive aggregation "
          + ", ".join(f"{a} {t:.4f} s" for a, t in t_agg.items())
          + f", AdamW {t_opt:.4f} s ({card})")

    launches = 0
    for arm in ("vrmom_adaptive", "auto_gm"):
        est = Estimator(arm, K=TRAIN_K)
        # (ii) ipm on int(0.4 * 7) = 2 rows, the state carried over steps
        setup = make_train_step(cfg, W, estimator=est, optimizer=opt,
                                byzantine_frac=ADAPT_TRAIN_ALPHA,
                                attack="ipm", device=dev)
        st = setup.init_state()
        walls, losses = [], []
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()   # ---- the main path: counts from 0
        for s in range(1, ADAPT_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, loss, st = setup.step_fn(params, opt_state, batch(20 + s),
                                           None, st)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t0)
            a = float(st.alpha_hat)
            w = st.weights.tolist()
            want_a = float(np.float32((1 - 0.5 ** s) * 0.25))
            want_w = float(np.float32(0.5 ** s + (1 - 0.5 ** s) * 0.5))
            print(f"[adapt] (b) {arm} (ii) ipm step {s}: loss {losses[-1]:.5f}"
                  f", {walls[-1]:.4f} s; state alpha_hat {a!r} (EMA "
                  f"{want_a!r}), weights {w}")
            ulp = float(np.spacing(np.float32(want_a)))
            require(abs(a - want_a) <= ulp and w[:W - n_byz] == [1.0] * (
                W - n_byz) and all(abs(x - want_w) <= float(
                    np.spacing(np.float32(want_w))) for x in w[W - n_byz:]),
                f"(b) {arm} step {s}: alpha_hat {a} (want {want_a}), "
                f"weights {w} (attacked rows want {want_w})")
        counts = K.launch_counts()
        launches += counts["aggregate"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        require(all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0] + 0.5,
                f"(b) {arm}: losses {losses} not finite or not stable")
        # a block: the census centre, and for vrmom_adaptive the centre
        # again and each rung; B2 twice a layer and worker (remat)
        want_b1 = blocks * (2 + len(k_ladder(TRAIN_K))
                            if arm == "vrmom_adaptive" else 1)
        want_b2 = W * cfg.n_layers * (2 if cfg.remat else 1)
        require(counts["aggregate"] == ADAPT_STEPS * want_b1
                and counts["flash_attention"] == ADAPT_STEPS * want_b2,
                f"(b) {arm}: the steps launched {counts}; expected B1 "
                f"{ADAPT_STEPS * want_b1}, B2 {ADAPT_STEPS * want_b2}")
        step_s = statistics.median(walls)
        print(f"[adapt] (b) {arm} (ii): step {step_s:.4f} s (median of "
              f"{[round(x, 4) for x in walls]}), {W * S / step_s:.1f} "
              f"tokens/s; B1 {counts['aggregate'] // ADAPT_STEPS} "
              f"launches a step, B2 {counts['flash_attention'] // ADAPT_STEPS}"
              f"; peak memory over the steps {peak:.2f} GB ({card})")
        del st, setup
        torch.cuda.empty_cache()
    del params, opt_state
    torch.cuda.empty_cache()
    return launches


def adaptive_serve(torch, dev, card: str):
    """Phase 8 (c): qwen3-1.7b served with the adaptive tail, under the
    captured decode step. Returns the traced B1 launches of its main
    path."""
    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.core.adaptive import k_ladder
    from repro_torch.core.estimator import Estimator
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, ServeEngine

    cfg = at_depth(get_arch("qwen3-1.7b"), QWEN_CUT_LAYERS)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    tokens = torch.randint(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    batch = {"tokens": tokens}
    # phase 3's clean tokens (the same seeded weights, depth and prompts)
    clean = ServeEngine(cfg, params, max_len=MAX_LEN, device=dev).generate(
        batch, NEW_TOKENS)
    engines = {}
    for arm in ("vrmom_adaptive", "auto_gm"):
        for attack in ("none", "signflip", "gaussian"):
            engines[(arm, attack)] = ServeEngine(
                cfg, params, max_len=MAX_LEN, device=dev,
                robust=RobustDecodeConfig(m=8, estimator=Estimator(arm, K=8),
                                          attack=attack, alpha=0.25))
    launches = {}
    K.reset_launch_counts()   # ---- the main path: counts from 0
    for (arm, attack), eng in engines.items():
        r = graph_and_eager(torch, K, eng, batch, f"{arm} {attack}", seed=5)
        add_counts(launches, r["launches"])
        same = torch.equal(r["toks"], clean)
        per_tok = r["eager_n"]["aggregate"] / NEW_TOKENS
        print(f"[adapt] (c) {arm:15s} {attack:9s} traced walls: graph "
              f"{r['first_ms']:7.1f} ms (capture {r['capture_s'] * 1e3:6.1f} "
              f"ms), replayed {r['graph_ms']:6.1f} ms, eager "
              f"{r['eager_ms']:7.1f} ms; graph == eager {r['same']}, == "
              f"phase 3's clean tokens {same}; B1 {per_tok:.0f} a token; "
              f"traced launches a generate {json.dumps(r['graph_n'])}")
        require(r["same"] and same, f"(c) {arm} {attack}: graph == eager "
                                    f"{r['same']}, == clean {same}")
        want_b1 = (1 + len(k_ladder(8))) if arm == "vrmom_adaptive" else 1
        require(r["graph_n"]["aggregate"] == want_b1 * NEW_TOKENS
                and r["graph_n"]["aggregate_sample"] == 0,
                f"(c) {arm} {attack}: a generate ran {r['graph_n']}, "
                f"expected B1 {want_b1} a token and no B4")
    counted = K.launch_counts()
    for name in ("aggregate", "flash_attention", "decode_attention"):
        require(launches.get(name, 0) > 0,
                f"(c) kernel {name} never launched on the main path")
    print(f"[adapt] (c) main-path launches {json.dumps(launches)} (traces; "
          f"the wrappers counted {json.dumps(counted)}, eager only)")
    mean = ServeEngine(cfg, params, max_len=MAX_LEN, device=dev,
                       robust=RobustDecodeConfig(m=8, estimator="mean",
                                                 attack="gaussian",
                                                 alpha=0.25))
    bad = mean.generate(batch, NEW_TOKENS,
                        generator=torch.Generator(device=dev).manual_seed(5))
    require(not torch.equal(bad, clean), "(c) the mean control under the "
                                         "gaussian attack served clean tokens")
    print(f"[adapt] (c) the mean control under gaussian: "
          f"{int((bad != clean).sum())} of {bad.numel()} tokens differ")
    prefill_ms = prefill_median(torch, engines[("vrmom_adaptive", "none")],
                                batch)
    # profiled once (a trace of ~50,000 device kernels); auto_gm's walls
    for arm in ("vrmom_adaptive", "auto_gm"):
        report_decode(torch, f"[adapt] (c) qwen3-1.7b robust m=8 {arm} "
                      f"greedy (none, shared), B={N_PROMPTS}, prompt "
                      f"{PROMPT_LEN}", engines[(arm, "none")], batch,
                      prefill_ms, card, profiled=arm == "vrmom_adaptive")
    del engines, mean, params
    torch.cuda.empty_cache()
    return launches["aggregate"]


def phase_adaptive(torch, dev, card: str):
    """Phase 8: the adaptive tier (census, vrmom_adaptive, auto_gm) on the
    coverage harness, the train step and the serving tail. Returns the
    ``kernels`` records of B1 at the phase's three shapes, each with the
    launches of its sub-path."""
    t_phase = time.perf_counter()
    flush = make_flush(torch, dev)
    cov_launches, tri = adaptive_coverage(torch, dev, card)
    print(f"[time] phase 8 (a) {time.perf_counter() - t_phase:.1f} s")
    t = time.perf_counter()
    train_launches = adaptive_train(torch, dev, card)
    print(f"[time] phase 8 (b) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    serve_launches = adaptive_serve(torch, dev, card)
    print(f"[time] phase 8 (c) {time.perf_counter() - t:.1f} s")
    from repro_torch.dist import robust_reduce as RR

    g = torch.Generator(device=dev).manual_seed(81)
    recs = [
        b1_record(torch, flush, f"B1 aggregate on the coverage statistics "
                  f"(vrmom_adaptive's rungs and census centre; timed at the "
                  f"rung K=10 on the triangle stack [101, "
                  f"{ADAPT_BATCH}*15] f32)", tri, 10, cov_launches),
        b1_record(torch, flush, f"B1 aggregate on the adaptive training "
                  f"wire (census centre and rungs a column block; timed at "
                  f"the rung K={TRAIN_K} on a block [{TRAIN_W}, "
                  f"{RR.WIRE_CHUNK}] f32)", torch.randn(
                      (TRAIN_W, RR.WIRE_CHUNK), generator=g, device=dev),
                  TRAIN_K, train_launches),
        b1_record(torch, flush, f"B1 aggregate in the adaptive serving tail "
                  f"(census centre and rungs a token; timed at the rung K=8 "
                  f"on [8, {N_PROMPTS}*151936] f32)", 4.0 * torch.randn(
                      (8, N_PROMPTS * 151936), generator=g, device=dev),
                  8, serve_launches)]
    for r in recs:
        print(f"[adapt] (d) {r['name']}: {r['ms'] * 1e3:.2f} us device, "
              f"plain {r['plain_ms']:.3f} ms, bytes bound "
              f"{r['bound_ms'] * 1e3:.2f} us, {r['launches']} launches on "
              f"the main path ({card})")
    print(f"[adapt] phase 8 in {time.perf_counter() - t_phase:.1f} s")
    return recs


def consensus_grid(torch, dev, card):
    """Phase 9 (a): BENCH_dist.json's degradation grid, gated against the
    closed forms of the fault statistics."""
    from repro_torch.core import attacks as TA
    from repro_torch.core.estimator import Estimator
    from repro_torch.dist.consensus import (ConsensusConfig,
                                            consensus_aggregate)
    from repro_torch.dist.faults import FaultPlan

    record = {(r["attack"], r["dropout"]): r for r in json.loads(
        (ROOT / "BENCH_dist.json").read_text())["degradation"]}
    n, S = CONS_N, CONS_SEEDS
    cfg = ConsensusConfig(f=1, trim="midpoint").validate(n)
    mask = torch.arange(n, device=dev) >= n - 1
    g = torch.Generator(device=dev).manual_seed(90)
    v = torch.randn((S, n, CONS_C), generator=g, device=dev)
    honest = v[:, :n - 1].mean(dim=1)
    # fault-free, mean trim, no pin: the decision is B1's direct aggregate
    est = Estimator("vrmom", K=10)
    got, _ = consensus_aggregate(v, est, config=ConsensusConfig(f=1))
    require(torch.equal(got, est.apply(v, axis=1)),
            "(a) the fault-free consensus decision differs from the direct "
            "aggregate")
    print(f"[cons] (a) fault-free (mean trim, no pin) decision of {S} "
          f"[{n}, {CONS_C}] stacks == B1's direct aggregate: True")
    for attack in CONS_ATTACKS:
        x = TA.attack_stack(attack, None, v, mask, axis=1)
        ref, _ = consensus_aggregate(x, "vrmom", config=cfg, pin_mask=mask)
        for d in CONS_DROPOUTS:
            plan = FaultPlan(dropout=d)
            P = cfg.phases(plan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, aux = consensus_aggregate(x, "vrmom", config=cfg, plan=plan,
                                           generator=g, pin_mask=mask)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            q = (1 - d) ** 7 + 7 * d * (1 - d) ** 6   # P(Bin(7, 1-d) >= 6)
            lost_p = (1 - q) ** n
            edges = P * n * (n - 1)
            stats = {
                "quorum": (float(aux.quorum.mean()), q,
                           math.sqrt(q * (1 - q) / (n * P * S))),
                "messages_dropped": (
                    float(aux.messages_dropped.double().mean()), edges * d,
                    math.sqrt(edges * d * (1 - d) / S)),
                "quorum_lost": (float(aux.quorum_lost.double().mean()),
                                lost_p, math.sqrt(lost_p * (1 - lost_p) / S))}
            err = float((out - ref).abs().amax(-1).mean())
            err_h = float((out - honest).abs().amax(-1).mean())
            r2e = float(aux.rounds_to_eps.double().mean())
            jr = record[(attack, d)]
            print(f"[cons] (a) {attack:10s} dropout {d:.2f}: "
                  + ", ".join(f"{k} {o:.6g} (closed form {w:.6g} ± "
                              f"{se:.3g})" for k, (o, w, se) in stats.items())
                  + f"; err_vs_no_dropout {err:.6g}, err_vs_honest_mean "
                  f"{err_h:.6g}, rounds_to_eps {r2e:.4g} (the JAX record, 8 "
                  f"seeds: quorum {jr['quorum_mean']:.4g}, dropped "
                  f"{jr['messages_dropped_mean']:.6g}, lost "
                  f"{jr['quorum_lost_frac']:.4g}, err_vs_honest_mean "
                  f"{jr['err_vs_honest_mean']:.4g}, rounds_to_eps "
                  f"{jr['rounds_to_eps_mean']:.4g}); {S} seeds x {P} rounds "
                  f"in {wall:.3f} s ({card})")
            require(bool(torch.isfinite(out).all()),
                    f"(a) {attack} dropout {d}: non-finite decision")
            for k, (o, w, se) in stats.items():
                require(abs(o - w) <= 4 * se + 1e-9,
                        f"(a) {attack} dropout {d}: {k} {o}, closed form "
                        f"{w} ± {se}")
            if d == 0.0:
                require(torch.equal(out, ref), f"(a) {attack}: the decision "
                        f"at dropout 0 differs from the fault-free run's")


def consensus_round_cost(torch, dev, card):
    """Phase 9 (b): one consensus round at the train wire's block. Returns
    (the B1 record on identical rows without launches, the fault-path
    round's ms)."""
    from repro_torch.core.estimator import Estimator
    from repro_torch.dist import consensus as CS
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.kernels.vrmom import aggregate, aggregate_plain

    flush = make_flush(torch, dev)
    W, C = TRAIN_W, RR.WIRE_CHUNK
    g = torch.Generator(device=dev).manual_seed(91)
    row = torch.randn((1, C), generator=g, device=dev)
    same = row.expand(W, C).contiguous()
    got = aggregate(same, "vrmom", K=TRAIN_K)
    want = aggregate_plain(same, "vrmom", K=TRAIN_K)
    require(torch.equal(got, want) and torch.equal(got, row[0]),
            f"(b) B1 on identical rows: plain version equal "
            f"{torch.equal(got, want)}, the row itself "
            f"{torch.equal(got, row[0])}")
    bb = bound(same.numel() * 4 + C * 4)
    rec = dict(
        name=f"B1 aggregate in a fault-free consensus round on identical "
             f"rows (the MAD is 0: the degenerate-scale branch), vrmom "
             f"K={TRAIN_K}, [{W}, {C}] f32 (the train wire's block)",
        route="cuda", source="src/repro_torch/kernels/csrc/vrmom.cu",
        replaces="src/repro/kernels/vrmom.py:142", max_abs_err=max_err(
            got, want),
        ms=timed_ms(lambda: aggregate(same, "vrmom", K=TRAIN_K), torch,
                    flush),
        plain_ms=timed_ms(lambda: aggregate_plain(same, "vrmom", K=TRAIN_K),
                          torch, flush, iters=5, spin=PLAIN_SPIN_CYCLES),
        bound_ms=bb[0], bound_by=bb[1], library_ms=None)
    est = Estimator("vrmom", K=TRAIN_K)
    x = torch.randn((W, C), generator=g, device=dev)
    pin = torch.arange(W, device=dev) >= W - 1
    cfg1 = CS.ConsensusConfig(f=1, max_rounds=1)
    free, faulty = FaultPlan(), FaultPlan(dropout=0.1)
    v_free = CS._round_views(free, W, 1, W - 1, device=dev)
    v_fault = CS._round_views(faulty, W, 1, W - 1, generator=g, device=dev)
    recv = v_fault.recv[0]
    times = {
        "B1 on distinct rows": timed_ms(lambda: est.apply(x, axis=0), torch,
                                        flush),
        "a fault-free round, one pinned row (B1, the sent rows, the "
        "spread, the update)": timed_ms(
            lambda: CS._iterate(x, est, cfg1, free, v_free, pin), torch,
            flush, iters=5, spin=PLAIN_SPIN_CYCLES),
        "a fault-path round (8 receivers' masked trim by the network, the "
        "spread, the update)": timed_ms(
            lambda: CS._iterate(x, est, cfg1, faulty, v_fault, pin), torch,
            flush, iters=5, spin=PLAIN_SPIN_CYCLES),
        "the masked trim of 8 receivers alone": timed_ms(
            lambda: CS._masked_trim(x.unsqueeze(-3), recv, 1, "mean"), torch,
            flush, iters=5, spin=PLAIN_SPIN_CYCLES),
        "the same views through torch.sort (not used)": timed_ms(
            lambda: torch.sort(torch.where(recv[..., None], x, CS._MISSING),
                               dim=-2), torch, flush, iters=5,
            spin=PLAIN_SPIN_CYCLES),
        "the spread": timed_ms(lambda: CS._spread(x, ~pin), torch, flush)}
    for what, ms in times.items():
        print(f"[cons] (b) [{W}, {C}] f32: {what}: {ms:.4f} ms device "
              f"({card})")
    print(f"[cons] (b) B1 on identical rows {rec['ms'] * 1e3:.2f} us (plain "
          f"{rec['plain_ms']:.3f} ms, bytes bound {rec['bound_ms'] * 1e3:.2f}"
          f" us), bitwise its plain version and the row ({card})")
    fault_ms = times["a fault-path round (8 receivers' masked trim by the "
                     "network, the spread, the update)"]
    del same, x
    torch.cuda.empty_cache()
    return rec, fault_ms


def consensus_coverage(torch, dev, card):
    """Phase 9 (c): tests/test_consensus.py's coverage cell under the
    consensus wire with message loss."""
    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.infer import coverage_run

    walls, s = [], None
    for _ in range(2):   # the first call warms the path up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell = coverage_run(model="linear", attack="alie", alpha=0.1,
                            estimator="vrmom", K=5, reps=CONS_REPS,
                            N_per_machine=100, m_workers=20, p=3, rounds=4,
                            batch_size=CONS_BATCH, seed=0,
                            reduce_backend="consensus",
                            consensus=ConsensusConfig(f=2),
                            fault_plan=FaultPlan(dropout=0.1), device=dev)
        s = cell.summary()
        walls.append(time.perf_counter() - t0)
    print(f"[cons] (c) coverage cell (linear, alie alpha 0.1, vrmom K 5, m "
          f"20, n 100, p 3, 4 rounds, f 2, dropout 0.1), {CONS_REPS} "
          f"replications in chunks of {CONS_BATCH}: coverage "
          f"{s['coverage']:.4f}, width {s['mean_width']:.6f}, RMSE "
          f"{s['rmse']:.6f}; {walls[1]:.3f} s a cell (first call "
          f"{walls[0]:.3f} s) ({card})")
    require(s["coverage"] >= 0.6 and math.isfinite(s["rmse"]),
            f"(c) coverage {s['coverage']}, RMSE {s['rmse']}")


def consensus_train(torch, dev, card, fault_ms):
    """Phase 9 (d): phase 7's training on the consensus wire. Returns the
    B1 launches of its main path (the alie steps)."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch import optim as O
    from repro_torch.configs import get as get_arch
    from repro_torch.convert import expected_shapes
    from repro_torch.core import attacks as TA
    from repro_torch.core.estimator import Estimator
    from repro_torch.data import lm_batch
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step, stacked_grads
    from repro_torch.tree import leaves, paths

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_arch("qwen3-1.7b")
    cfg = at_depth(full, QWEN_CUT_LAYERS)
    W, S = TRAIN_W, TRAIN_SEQ
    est = Estimator("vrmom", K=TRAIN_K)
    cons = ConsensusConfig(f=1)
    P = cons.phases()

    def wire_blocks(c):
        return sum(-(-math.prod(shape) // RR.WIRE_CHUNK)
                   for _, shape in paths(expected_shapes(c)))

    def init(c):
        return M.init(c, torch.Generator(device=dev).manual_seed(7),
                      device=dev)

    params, blocks = init(cfg), wire_blocks(cfg)
    opt = O.get("adamw", lr=TRAIN_LR)
    opt_state = opt.init(params)
    n_byz = int(TRAIN_ALPHA * (W - 1))
    mask = torch.arange(W, device=dev) >= W - n_byz
    print(f"[cons] (d) {cfg.name} at full width and {cfg.n_layers} of "
          f"{full.n_layers} layers (QWEN_CUT_LAYERS), W = {W} x {S} tokens, "
          f"VRMOM K {TRAIN_K}, AdamW lr {TRAIN_LR}, reduce_backend="
          f"consensus f {cons.f} ({P} rounds fault-free); the wire walks "
          f"{blocks} column blocks of {RR.WIRE_CHUNK}")

    def batch(i):
        return lm_batch(cfg, i, W, S, device=dev)

    # (i) honest, trivial plan, on one stack: bitwise phase 7's aggregate;
    # then the same stack under alie is the split of a step, synchronised
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stack = stacked_grads(cfg, params, batch(40), W)
    torch.cuda.synchronize()
    t_grads = time.perf_counter() - t0
    direct = RR.aggregate(stack, mode="stacked-auto", est=est)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agg, caux = RR.aggregate(stack, mode="stacked-consensus", est=est,
                             consensus=cons)
    torch.cuda.synchronize()
    t_honest = time.perf_counter() - t0
    same = stacked_equal(torch, agg, direct)
    print(f"[cons] (d) (i) honest stack, trivial plan: consensus aggregate "
          f"bitwise the stacked-auto aggregate {same}; {t_honest:.4f} s, "
          f"rounds_run {int(caux.rounds_run)}, rounds_to_eps "
          f"{int(caux.rounds_to_eps)}, spread {float(caux.spread):.3g} "
          f"({card})")
    require(same and not bool(caux.quorum_lost),
            f"(d) honest consensus aggregate equal {same}")
    del direct, agg
    t0 = time.perf_counter()
    for gl in leaves(stack):
        gl.copy_(TA.get("alie")(None, gl, mask))
    torch.cuda.synchronize()
    t_att = time.perf_counter() - t0
    agg, caux = RR.aggregate(stack, mode="stacked-consensus", est=est,
                             consensus=cons, pin_mask=mask)
    torch.cuda.synchronize()
    t_agg = time.perf_counter() - t0 - t_att
    opt.update(agg, opt_state, params)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0 - t_att - t_agg
    del stack, agg
    print(f"[cons] (d) the split of an alie step, synchronised: workers' "
          f"forward + backward {t_grads:.4f} s, alie {t_att:.4f} s, "
          f"consensus aggregation {t_agg:.4f} s ({int(caux.rounds_run)} "
          f"rounds over {blocks} blocks: {t_agg / blocks / P * 1e3:.4f} ms a "
          f"block and round), AdamW {t_opt:.4f} s ({card})")

    # (ii) alie on the pinned last row, trivial plan, the step's own path
    setup = make_train_step(cfg, W, estimator=est, optimizer=opt,
                            byzantine_frac=TRAIN_ALPHA, attack="alie",
                            reduce_backend="consensus", device=dev)
    walls, losses = [], []
    K.reset_launch_counts()   # ---- the main path: counts from 0
    for i in range(1, CONS_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss, caux = setup.step_fn(params, opt_state, batch(40 + i))
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
        require(math.isfinite(losses[-1]) and not bool(caux.quorum_lost),
                f"(d) alie step {i}: loss {losses[-1]}, quorum lost "
                f"{bool(caux.quorum_lost)}")
    counts = K.launch_counts()
    want_b1 = CONS_STEPS * blocks * P
    require(counts["aggregate"] == want_b1,
            f"(d) the alie steps launched B1 {counts['aggregate']} times; "
            f"expected {want_b1} (a block and round: the pinned row keeps "
            f"the rows apart)")
    step_s = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[cons] (d) (ii) alie on {n_byz} pinned row, trivial plan: "
          f"losses {[round(x, 5) for x in losses]}, step {step_s:.4f} s "
          f"(median of {[round(w, 4) for w in walls]}), "
          f"{W * S / step_s:.1f} tokens/s; rounds_run "
          f"{int(caux.rounds_run)}, rounds_to_eps {int(caux.rounds_to_eps)},"
          f" quorum {float(caux.quorum):.4f}; launches {json.dumps(counts)};"
          f" peak memory {peak:.2f} GB ({card})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (iii) repro's plan (tests/test_consensus.py:262) under alie, one step
    plan = FaultPlan(dropout=0.1, n_crashed=1, crash_round=2)
    Pf = cons.phases(plan)
    blocks_full = wire_blocks(full)
    reckon = blocks_full * Pf * fault_ms / 1e3
    depth = cfg.n_layers  # the deepest cut whose rounds fit the budget
    while depth > 1 and wire_blocks(dataclasses.replace(
            cfg, n_layers=depth)) * Pf * fault_ms / 1e3 > CONS_FAULT_BUDGET_S:
        depth -= 1
    del params, opt_state
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=depth)
    params, blocks_cut = init(cut), wire_blocks(cut)
    opt_state = opt.init(params)
    print(f"[cons] (d) (iii) plan {tuple(plan)}: reckoned at full depth "
          f"{blocks_full} blocks x {Pf} rounds x {fault_ms:.3f} ms = "
          f"{reckon:.1f} s of fault-path rounds; run at {depth} of "
          f"{full.n_layers} "
          f"layers ({blocks_cut} blocks; every width as published), "
          f"reckoned {blocks_cut * Pf * fault_ms / 1e3:.1f} s")
    faulted = make_train_step(cut, W, estimator=est, optimizer=opt,
                              byzantine_frac=TRAIN_ALPHA, attack="alie",
                              reduce_backend="consensus", fault_plan=plan,
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(92)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, loss, caux = faulted.step_fn(
        params, opt_state, lm_batch(cut, 50, W, S, device=dev), gen)
    loss = float(loss)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[cons] (d) (iii) one faulted step at {depth} layers: loss "
          f"{loss:.5f}, {wall:.3f} s, rounds_run {int(caux.rounds_run)}, "
          f"quorum {float(caux.quorum):.4f}, quorum_lost "
          f"{bool(caux.quorum_lost)}, messages_dropped "
          f"{int(caux.messages_dropped)} (40 * 56 * 0.1 less the crashed "
          f"peer's: reckoned {sum(0.1 * (56 if p < 2 else 42) for p in range(Pf)):.0f}),"
          f" rounds_to_eps {int(caux.rounds_to_eps)}; peak memory "
          f"{peak:.2f} GB ({card})")
    require(math.isfinite(loss) and not bool(caux.quorum_lost),
            f"(d) faulted step: loss {loss}, quorum lost "
            f"{bool(caux.quorum_lost)}")
    del params, opt_state
    torch.cuda.empty_cache()
    return counts["aggregate"]


def phase_consensus(torch, dev, card):
    """Phase 9: the consensus backend and fault injection. Returns the
    ``kernels`` record of B1 on a fault-free round's identical rows, with
    the B1 launches of the phase's main path (the training of (d))."""
    t_phase = time.perf_counter()
    consensus_grid(torch, dev, card)
    print(f"[time] phase 9 (a) {time.perf_counter() - t_phase:.1f} s")
    t = time.perf_counter()
    rec, fault_ms = consensus_round_cost(torch, dev, card)
    print(f"[time] phase 9 (b) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    consensus_coverage(torch, dev, card)
    print(f"[time] phase 9 (c) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rec["launches"] = consensus_train(torch, dev, card, fault_ms)
    print(f"[time] phase 9 (d) {time.perf_counter() - t:.1f} s")
    print(f"[cons] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return [rec]


def routed(fn):
    """``fn()`` with ``models.moe.route`` wrapped to keep every routing it
    makes, in call order (a layer a call) -> (fn's result, [Routing])."""
    from repro_torch.models import moe as X

    real, calls = X.route, []

    def keep(x, router, cfg):
        r = real(x, router, cfg)
        calls.append(r)
        return r

    X.route = keep
    try:
        out = fn()
    finally:
        X.route = real
    return out, calls


def routing_parts(torch, ra, rb, rows=None):
    """The first call at which two runs' routings differ (the experts in
    slot order, over the first ``rows`` groups of each, else all): None,
    or (call, tokens that differ, whether every one is a near-tie, the
    largest such gap, the largest difference). A near-tie: the least gap
    between adjacent probabilities of run a's top k + 1 is within twice
    the largest difference of the two runs' router probabilities at that
    token."""
    for i, (a, b) in enumerate(zip(ra, rb)):
        ea, eb, pa, pb = a.expert, b.expert, a.probs, b.probs
        if rows is not None:
            ea, eb, pa, pb = ea[:rows], eb[:rows], pa[:rows], pb[:rows]
        diff = (ea != eb).any(-1)
        if not bool(diff.any()):
            continue
        k = min(ea.shape[-1] + 1, pa.shape[-1])
        top = torch.topk(pa, k, dim=-1).values
        gap = (top[..., :-1] - top[..., 1:]).amin(-1)[diff]
        d = (pa - pb).abs().amax(-1)[diff]
        return (i, int(diff.sum()), bool((gap <= 2 * d).all()),
                float(gap.max()), float(d.max()))
    return None


def instances_ran(torch, eng, params, cfg, batch, tok):
    """The B2 and B3 instances one prefill and one decode step of ``eng``
    launch, read from the device kernels' names in one profiler trace
    (thousands of kernels; the tracer may drop a trace's first events, so
    the names are read as a set, not split per call as kernels_in_calls
    does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import kernel_instance
    from repro_torch.models import model as M

    _, caches = eng.prefill(batch)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        eng.prefill(batch)
        M.decode_step(params, cfg, caches, tok)
        torch.cuda.synchronize()
    ran = {ev.name() for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == DeviceType.CUDA}
    return ({kernel_instance(n, "flash_fwd_wgmma") for n in ran} - {None},
            {kernel_instance(n, "decode_split_kernel") for n in ran} - {None})


def graph_traced(torch, K, eng, batch, what: str, want: dict,
                 trace_eager: bool = False):
    """``graph_and_eager`` with the eager loop untraced unless
    ``trace_eager``: its launches are then the wrappers' counts (every
    eager launch counts), which must be ``want``, as must each of the
    traced calls' (the first generate runs a step eagerly, captures it and
    replays; the second only replays, its wrappers counting no decode
    kernel). The eager loop's trace of tens of thousands of small kernels
    is the one the tracer most often loses events from, and phase 10 (a)
    has no time to take it again. ``events``: each traced call's port
    kernels in launch order, as (name, device µs)."""
    from repro_torch.serve.engine import GREEDY

    retraced = 0

    def traced(fn):
        nonlocal retraced
        for _ in range(TRACE_TRIES):
            *call, again = traced_call(torch, K,
                                       lambda: fn(batch, NEW_TOKENS),
                                       f"'{what}' {fn.__name__}")
            retraced += again
            if call[3] == want:
                return call
            retraced += 1
            print(f"[trace] '{what}' {fn.__name__}: the trace holds "
                  f"{call[3]}, expected {want}; traced again")
        raise CheckFailed(f"'{what}' {fn.__name__}: {TRACE_TRIES} traces "
                          f"differ from the launches expected")

    events = []
    if trace_eager:
        eager, eager_ms, eager_c, _, ev = traced(eng.generate_python_loop)
        events.append(ev)
    else:
        before = K.launch_counts()
        t0 = time.perf_counter()
        eager = eng.generate_python_loop(batch, NEW_TOKENS)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        after = K.launch_counts()
        eager_c = {k: after[k] - before[k] for k in after}
    require(eager_c == want, f"'{what}': the eager loop launched {eager_c}, "
                             f"expected {want}")
    first, first_ms, _, first_t, ev = traced(first_generate(eng, GREEDY))
    events.append(ev)
    graph, graph_ms, graph_c, graph_t, ev = traced(eng.generate)
    events.append(ev)
    require(graph_c["decode_attention"] == 0,
            f"'{what}': a replayed generate's wrappers counted {graph_c}")
    launches = dict(eager_c)
    add_counts(launches, first_t)
    add_counts(launches, graph_t)
    return dict(toks=graph, first_ms=first_ms, graph_ms=graph_ms,
                eager_ms=eager_ms, graph_n=graph_t, graph_counted=graph_c,
                launches=launches, capture_s=eng.graphs[GREEDY].capture_s,
                retraced=retraced, events=events,
                same=torch.equal(first, graph) and torch.equal(graph, eager))


def run_matrix(torch, K, cfg, runs, batch, traced, n_attn, tag,
               n_decode=None, trace_eager=False):
    """The main path of phases 10 (a), 11 (a) and 12 (a). With the
    wrappers' counts from 0, the runs of ``traced`` (keys (layout, attack,
    fused) of ``runs``, its engines) are held against their eager loops
    with their generates traced (``graph_traced``, with ``trace_eager``:
    ``n_attn`` B2 launches a generate, ``n_decode`` (else as many) B3 a
    decode step), and every other run serves one untraced
    graph generate; the greedy tokens must be identical within each layout
    and graph = eager. Returns (the results by key, the traced launches in
    all and by layout, the wrappers' counts)."""
    K.reset_launch_counts()
    res = {}
    for key in traced:
        tail = NEW_TOKENS if key[2] else 0
        res[key] = graph_traced(
            torch, K, runs[key], batch,
            f"{cfg.name} {' '.join(map(str, key))}",
            dict(aggregate=NEW_TOKENS - tail, aggregate_sample=tail,
                 flash_attention=n_attn,
                 decode_attention=(n_attn if n_decode is None else n_decode)
                 * (NEW_TOKENS - 1)), trace_eager)
    walls = {}
    for key, eng in runs.items():
        if key in res:
            continue
        t = time.perf_counter()
        res[key] = dict(toks=eng.generate(batch, NEW_TOKENS))
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t
    counted = K.launch_counts()
    counts, by_layout = {}, {"shared": {}, "replicated": {}}
    for key in traced:
        add_counts(counts, res[key]["launches"])
        add_counts(by_layout[key[0]], res[key]["launches"])
    ref = res["shared", "none", True]["toks"]
    require(ref.shape == (N_PROMPTS, NEW_TOKENS)
            and bool(((ref >= 0) & (ref < cfg.vocab)).all()),
            f"{cfg.name}: tokens of shape {tuple(ref.shape)} or outside the "
            f"vocabulary")
    for key, r in res.items():
        base = res[key[0], "none", True]["toks"]
        same = torch.equal(r["toks"], base)
        what = f"{key[0]} {key[1]} {'fused' if key[2] else 'unfused'}"
        extra = (f"traced walls: graph {r['first_ms']:7.1f} ms (capture "
                 f"{r['capture_s'] * 1e3:6.1f} ms), replayed "
                 f"{r['graph_ms']:6.1f} ms, eager {r['eager_ms']:7.1f} ms; "
                 f"traced launches a generate {json.dumps(r['graph_n'])}; "
                 f"calls traced again {r['retraced']}" if "graph_n" in r
                 else f"untraced graph generate {walls[key]:.2f} s")
        print(f"[{tag}] {cfg.name} {what:27s} graph == eager "
              f"{r.get('same', 'not run')}, identical in layout {same}; "
              f"{extra}")
        require(r.get("same", True), f"{cfg.name} {what}: generate (graph) "
                                     f"and generate_python_loop (eager) "
                                     f"differ")
        require(same, f"{cfg.name}: greedy tokens of {what} differ from "
                      f"{key[0]} none fused")
    return res, counts, by_layout, counted


def moe_records(recs, card, tag="moe"):
    """Each (``kernels`` record, its main path's launches) printed, the
    launches written in -> the records."""
    for rec, launches in recs:
        rec["launches"] = launches
        print(f"[{tag}] {rec['name']}: {rec['ms'] * 1e3:.2f} us device cold, "
              f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}), "
              f"library " + ("none" if rec["library_ms"] is None else
                             f"{rec['library_ms'] * 1e3:.2f} us") +
              f", plain {rec['plain_ms']:.3f} ms, max err "
              f"{rec['max_abs_err']:.3g}, launches {launches} ({card})")
    return [rec for rec, _ in recs]


def moe_granite(torch, dev, card, flush):
    """Phase 10 (a): granite-moe-3b-a800m at full width and
    MOE_GRANITE_LAYERS of its 32 layers, phase 3's workload. Returns (cfg,
    params, the ``kernels`` records)."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.core.estimator import Estimator
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, ServeEngine

    full = get_arch("granite-moe-3b-a800m")
    cfg = dataclasses.replace(full, n_layers=MOE_GRANITE_LAYERS)
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    n_active = M.active_param_count(params, cfg)
    L, H, Hkv, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    w_ms = 2 * n_params / HBM_BYTES_PER_S * 1e3
    print(f"[moe] {cfg.name} at full width, depth cut to {L} of "
          f"{full.n_layers} layers (MOE_GRANITE_LAYERS): d "
          f"{cfg.d_model}, heads {H}/{Hkv} (G {G}), dh {dh}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff "
          f"{cfg.d_ff} an expert, vocab {cfg.vocab}, {n_params / 1e9:.3f} B "
          f"params ({n_active / 1e9:.3f} B active) bf16 "
          f"({2 * n_params / 1e9:.2f} GB), seeded init "
          f"{time.perf_counter() - t0:.1f} s; {N_PROMPTS} x {PROMPT_LEN} "
          f"tokens, {NEW_TOKENS} new")
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN),
                                     generator=g, device=dev)}

    def rcfg(**kw):
        return RobustDecodeConfig(**{**dict(m=8, estimator="vrmom", K=8,
                                            alpha=0.25), **kw})

    def engine(robust, **kw):
        return ServeEngine(cfg, params, max_len=MAX_LEN, robust=robust,
                           device=dev, **kw)

    runs = {(layout, attack, fuse): engine(rcfg(
        attack=attack, fuse_tail=fuse,
        share_replica_compute=layout == "shared"))
        for layout in ("shared", "replicated")
        for attack in ("none", "signflip", "gaussian")
        for fuse in (True, False)}
    warm = runs["shared", "none", True]
    warm.generate_python_loop(batch, 2)  # warm-up
    warm.generate(batch, 2)
    torch.cuda.synchronize()

    # ---- the main path: counts from 0; launches from its traces ---------
    res, counts, by_layout, counted = run_matrix(
        torch, K, cfg, runs, batch, MOE_TRACED, L, "moe")
    ref = res["shared", "none", True]["toks"]
    fused = res["shared", "signflip", True]["graph_n"]
    require(fused["flash_attention"] == L
            and fused["decode_attention"] == L * (NEW_TOKENS - 1)
            and fused["aggregate_sample"] == NEW_TOKENS
            and fused["aggregate"] == 0,
            f"{cfg.name}: fused greedy launches {fused}")
    for name in ("aggregate", "aggregate_sample", "flash_attention",
                 "decode_attention"):
        require(counts[name] > 0 and counted[name] > 0,
                f"{cfg.name}: kernel {name} never launched on the main path")
    print(f"[moe] {cfg.name} main-path launches {json.dumps(counts)} "
          f"(traced; the wrappers counted {json.dumps(counted)}, eager "
          f"launches only) ({card})")
    print(f"[moe] {cfg.name} shared vs replicated: " + layout_check(
        torch, cfg, params, batch, MAX_LEN, ref,
        res["replicated", "signflip", True]["toks"]))
    flash, dec = instances_ran(torch, warm, params, cfg, batch, ref[:, 0])
    want_dec = (dh, 8 if G <= 8 else 16)
    require(flash == {(dh,)} and dec == {want_dec},
            f"{cfg.name}: instances {flash} (B2) and {dec} (B3), expected "
            f"{(dh,)} and {want_dec}")
    print(f"[moe] {cfg.name} instances: B2 flash_fwd_wgmma<{dh}> (prefill),"
          f" B3 decode_split_kernel<{want_dec[0]}, {want_dec[1]}> (decode "
          f"step)")
    # ---- prefill on the kernel path against the plain path, and what
    # capacity dropped ----------------------------------------------------
    eng_p = engine(rcfg(estimator=Estimator(method="vrmom", K=8,
                                            backend="torch")),
                   attn_backend="torch")
    (lk, _), rk = routed(lambda: warm.prefill(batch))
    (lp, _), rp = routed(lambda: eng_p.prefill(batch))
    drops = [int(torch.sum(~r.keep)) for r in rk]
    pairs = rk[0].keep.numel()
    print(f"[moe] {cfg.name} prefill routing: {sum(drops)} of {pairs * L} "
          f"(token, slot) pairs dropped by capacity "
          f"({100 * sum(drops) / (pairs * L):.2f} %; C = {rk[0].capacity} "
          f"rows an expert at T = {PROMPT_LEN}); by layer " + ", ".join(
              f"{100 * n / pairs:.1f}" for n in drops) + " %")
    rel = max_err(lk, lp) / float(lp.float().abs().max())
    part = routing_parts(torch, rk, rp)
    note = ("the two paths route alike in every layer" if part is None else
            f"the routing first parts at layer {part[0]}, {part[1]} tokens, "
            f"near-ties {part[2]} (largest top-{cfg.moe.top_k + 1} gap "
            f"{part[3]:.3g}, largest probability difference {part[4]:.3g})")
    # bf16 rounds at other places on the two paths; past a flipped expert
    # (a near-tie of the router) capacity moves the later tokens' rows too
    require(bool(torch.isfinite(lk.float()).all())
            and (rel <= 5e-2 or (part is not None and part[2]
                                 and part[4] <= FLIP_PROB_TOL)),
            f"{cfg.name}: prefill logits kernel vs plain: {rel}; {note}")
    print(f"[moe] {cfg.name}: prefill logits kernel vs plain path max err / "
          f"max|logit| = {rel:.3g} (tolerance 5e-2 unless a near-tie flips "
          f"an expert); {note}")
    report_decode(torch, f"[moe] {cfg.name} robust m=8 vrmom greedy (shared "
                  f"none)", warm, batch, prefill_median(torch, warm, batch),
                  card)
    print(f"[moe] {cfg.name} weight bound: every expert read each step, "
          f"{2 * n_params / 1e9:.2f} GB / {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"= {w_ms:.2f} ms a step ({card})")

    # ---- the kernels at this config's shapes ----------------------------
    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    recs = [(attn_record(
        torch, flush, f"B2 flash_attention (causal, {cfg.name}: q "
        f"[{N_PROMPTS},{PROMPT_LEN},{H},{dh}], k/v [{N_PROMPTS},{PROMPT_LEN},"
        f"{Hkv},{dh}] bf16)", rand(N_PROMPTS, PROMPT_LEN, H, dh),
        rand(N_PROMPTS, PROMPT_LEN, Hkv, dh),
        rand(N_PROMPTS, PROMPT_LEN, Hkv, dh), decode=False),
        counts["flash_attention"]),
        (attn_record(
            torch, flush, f"B3 decode_attention ({cfg.name}: dh {dh}, G {G},"
            f" q [{N_PROMPTS},1,{H},{dh}], cache [{N_PROMPTS},{MAX_LEN},{Hkv},"
            f"{dh}] bf16)", rand(N_PROMPTS, 1, H, dh),
            rand(N_PROMPTS, MAX_LEN, Hkv, dh),
            rand(N_PROMPTS, MAX_LEN, Hkv, dh), decode=True),
         by_layout["shared"]["decode_attention"]),
        (pool_b3_record(
            torch, flush, torch.full((8 * N_PROMPTS,), MAX_LEN,
                                     dtype=torch.int32, device=dev),
            H, Hkv, dh, MAX_LEN, g, dev,
            where=f"{cfg.name} replicated, the last step"),
         by_layout["replicated"]["decode_attention"])]
    tail = pool_tail_records(torch, flush, N_PROMPTS, cfg.vocab, g, dev,
                             where=f"{cfg.name} generate",
                             b1_what=f"{cfg.name} unfused tail")
    recs += [(tail["aggregate_sample"], counts["aggregate_sample"]),
             (tail["aggregate"], counts["aggregate"])]
    out = moe_records(recs, card)
    del runs, warm, eng_p, lk, lp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, params, out


def moe_pool(torch, dev, card, cfg, params):
    """Phase 10 (b): granite-moe-3b-a800m behind ``Scheduler`` over 8 slots
    of 512 (robust m = 8, the pool's step replayed)."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import RobustDecodeConfig, Scheduler, ServeEngine

    rs = np.random.RandomState(10)
    reqs = []
    for _ in range(MOE_POOL_REQUESTS):
        S = int(rs.randint(POOL_PROMPT[0], POOL_PROMPT[1] + 1))
        n = int(rs.randint(POOL_NEW[0], POOL_NEW[1] + 1))
        reqs.append((rs.randint(0, cfg.vocab, size=(S,)).astype(np.int32), n))
    budget = sum(n for _, n in reqs)
    print(f"[moe] {cfg.name} ServeEngine(max_len={POOL_MAX_LEN}, n_slots="
          f"{MOE_POOL_SLOTS}, robust m=8 vrmom K=8 shared fused, obs), "
          f"Scheduler(decode_block={POOL_BLOCK}), greedy; "
          f"{MOE_POOL_REQUESTS} requests, prompts {POOL_PROMPT[0]}.."
          f"{POOL_PROMPT[1]}, budgets {POOL_NEW[0]}..{POOL_NEW[1]} ({budget}"
          f" tokens)")
    scheds = {}
    for attack in ("none", "signflip", "gaussian"):
        eng = ServeEngine(cfg, params, max_len=POOL_MAX_LEN,
                          n_slots=MOE_POOL_SLOTS, obs=MetricsRegistry(),
                          robust=RobustDecodeConfig(m=8, estimator="vrmom",
                                                    K=8, alpha=0.25,
                                                    attack=attack),
                          device=dev)
        scheds[attack] = Scheduler(eng, decode_block=POOL_BLOCK)
    K.reset_launch_counts()
    comp1, _, wall1 = drain(torch, scheds["none"], reqs)
    comp2, _, wall2 = drain(torch, scheds["none"], reqs)
    toks = [c.tokens for c in comp2]
    require(toks == [c.tokens for c in comp1]
            and all(c.finished_by == "length" and len(c.tokens) == n
                    and all(0 <= t < cfg.vocab for t in c.tokens)
                    for c, (_, n) in zip(comp2, reqs)),
            f"{cfg.name} pool: two drains differ, or a completion lacks its "
            f"budget or leaves the vocabulary")
    for attack in ("signflip", "gaussian"):
        got, _, wall = drain(torch, scheds[attack], reqs)
        require([c.tokens for c in got] == toks,
                f"{cfg.name} pool tokens under {attack} differ from 'none'")
        print(f"[moe] {cfg.name} pool {attack} a=0.25: tokens identical to "
              f"none (drain with set-up {wall:.3f} s)")
    counted = K.launch_counts()
    for name in ("aggregate_sample", "flash_attention", "decode_attention"):
        require(counted[name] > 0, f"{cfg.name} pool: kernel {name} never "
                                   f"launched")
    eng = scheds["none"].engine
    step = eng.obs.histograms["serve.decode_step_s"]
    print(f"[moe] {cfg.name} pool drain {budget} tokens in {wall2:.3f} s = "
          f"{budget / wall2:.1f} tok/s (round 2; round 1 with set-up "
          f"{wall1:.3f} s); decode step p50 {step.percentile(50) * 1e3:.2f} "
          f"ms p95 {step.percentile(95) * 1e3:.2f} ms ({step.count} blocks);"
          f" the wrappers counted {json.dumps(counted)} (eager launches) "
          f"({card})")
    for i, (p, n) in enumerate(reqs[:MOE_POOL_SOLO]):
        batch = {"tokens": torch.from_numpy(p)[None].to(dev)}
        solo = eng.generate(batch, n)
        pooled = torch.tensor([toks[i]], dtype=solo.dtype, device=dev)
        print(f"[moe] {cfg.name} request {i} (prompt {len(p)}): solo vs pool "
              + ("tokens identical" if torch.equal(solo, pooled) else
                 layout_check(torch, cfg, params, batch, POOL_MAX_LEN, solo,
                              pooled, m=MOE_POOL_SLOTS, what="solo vs pool")))
    del scheds, eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def moe_mixtral(torch, dev, card, flush):
    """Phase 10 (c): mixtral-8x7b at MOE_MIXTRAL_LAYERS of its 32 layers,
    every width as published: phase 3's workload (no B2: its window routes
    the prefill to the plain ``mha``), and a prompt that runs the 4096-slot
    ring past its end. Returns the ``kernels`` records."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, ServeEngine

    full = get_arch("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=MOE_MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    L, H, Hkv, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    W = cfg.sliding_window
    print(f"[moe] {cfg.name}: depth cut to {L} of {full.n_layers} layers "
          f"(the whole model's bf16 weights do not fit 80 GB); d "
          f"{cfg.d_model}, heads {H}/{Hkv}, dh {dh}, {cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"window {W}; {n_params / 1e9:.3f} B params "
          f"({M.active_param_count(params, cfg) / 1e9:.3f} B active) bf16 "
          f"({2 * n_params / 1e9:.2f} GB), seeded init "
          f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN),
                                     generator=g, device=dev)}

    def engine(attack, max_len=MAX_LEN):
        return ServeEngine(cfg, params, max_len=max_len, device=dev,
                           robust=RobustDecodeConfig(
                               m=8, estimator="vrmom", K=8, alpha=0.25,
                               attack=attack))

    runs = {a: engine(a) for a in ("none", "signflip")}
    runs["none"].generate_python_loop(batch, 2)  # warm-up
    runs["none"].generate(batch, 2)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    res = {a: graph_and_eager(torch, K, eng, batch, f"{cfg.name} {a}")
           for a, eng in runs.items()}
    counted = K.launch_counts()
    counts = {}
    for r in res.values():
        add_counts(counts, r["launches"])
    for a, r in res.items():
        print(f"[moe] {cfg.name} {a:9s} traced walls: graph "
              f"{r['first_ms']:7.1f} ms (capture {r['capture_s'] * 1e3:6.1f} "
              f"ms), replayed {r['graph_ms']:6.1f} ms, eager "
              f"{r['eager_ms']:7.1f} ms; graph == eager {r['same']}; traced "
              f"launches a generate {json.dumps(r['graph_n'])}")
        require(r["same"], f"{cfg.name} {a}: graph and eager tokens differ")
        require(r["graph_n"]["flash_attention"] == 0
                and r["graph_n"]["decode_attention"] == L * (NEW_TOKENS - 1),
                f"{cfg.name} {a}: launches {r['graph_n']}, expected no B2 "
                f"(the window routes the prefill to mha) and B3 once a layer "
                f"a step")
    require(torch.equal(res["none"]["toks"], res["signflip"]["toks"]),
            f"{cfg.name}: signflip tokens differ from none")
    require(counts["decode_attention"] > 0 and counts["aggregate_sample"] > 0
            and counts["flash_attention"] == 0
            and counted["flash_attention"] == 0,
            f"{cfg.name}: main-path launches {counts}")
    flash, dec = instances_ran(torch, runs["none"], params, cfg, batch,
                               res["none"]["toks"][:, 0])
    require(not flash and dec == {(dh, 8)},
            f"{cfg.name}: instances {flash} (B2) and {dec} (B3)")
    print(f"[moe] {cfg.name} main-path launches {json.dumps(counts)} "
          f"(traced; the wrappers counted {json.dumps(counted)}); no B2 "
          f"instance ran, B3 decode_split_kernel<{dh}, 8> over the ring of "
          f"{W} slots ({card})")
    report_decode(torch, f"[moe] {cfg.name} ({L} layers) robust m=8 vrmom "
                  f"greedy (shared none)", runs["none"], batch,
                  prefill_median(torch, runs["none"], batch), card)
    # ---- the ring past its end: one prompt of MOE_RING_PROMPT tokens ----
    ring = engine("none", max_len=MOE_RING_PROMPT + NEW_TOKENS)
    one = {"tokens": torch.randint(0, cfg.vocab, (1, MOE_RING_PROMPT),
                                   generator=g, device=dev)}
    K.reset_launch_counts()
    t = time.perf_counter()
    got = ring.generate(one, NEW_TOKENS)
    want = ring.generate_python_loop(one, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    wrapped = K.launch_counts()
    require(torch.equal(got, want) and bool(((got >= 0)
                                             & (got < cfg.vocab)).all()),
            f"{cfg.name}: over the ring's end, graph and eager tokens differ")
    require(wrapped["flash_attention"] == 0
            and wrapped["decode_attention"] > 0,
            f"{cfg.name} ring: the wrappers counted {wrapped}")
    last = MOE_RING_PROMPT + NEW_TOKENS - 1
    print(f"[moe] {cfg.name} ring: prompt {MOE_RING_PROMPT} + {NEW_TOKENS} "
          f"new, positions {MOE_RING_PROMPT}..{last} over {W} slots (wraps "
          f"at {W}): graph == eager tokens; graph + eager generates "
          f"{wall:.2f} s ({card})")

    recs = [(pool_b3_record(
        torch, flush, torch.full((N_PROMPTS,), MAX_LEN, dtype=torch.int32,
                                 device=dev), H, Hkv, dh, W, g, dev,
        where=f"{cfg.name}: G {H // Hkv} over the ring, the last step"),
        counts["decode_attention"]),
        (pool_tail_records(torch, flush, N_PROMPTS, cfg.vocab, g, dev,
                           where=f"{cfg.name} generate")["aggregate_sample"],
         counts["aggregate_sample"])]
    out = moe_records(recs, card)
    del runs, ring, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def phase_moe(torch, dev, card):
    """Phase 10: the moe family. Returns the ``kernels`` records with the
    launches of their paths."""
    t_phase = time.perf_counter()
    flush = make_flush(torch, dev)
    cfg, params, recs = moe_granite(torch, dev, card, flush)
    print(f"[time] phase 10 (a) {time.perf_counter() - t_phase:.1f} s")
    t = time.perf_counter()
    moe_pool(torch, dev, card, cfg, params)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[time] phase 10 (b) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    recs += moe_mixtral(torch, dev, card, flush)
    print(f"[time] phase 10 (c) {time.perf_counter() - t:.1f} s")
    return recs


def ssm_reckoning(cfg, n_params: int, rows: int) -> dict:
    """The bytes one decode step must move at ``rows`` cache rows, read
    once and written once: every bf16 weight (the embedding as the
    unembedding; a hybrid's shared block once for each application), each
    row's f32 SSM state and conv tails read and written, and a hybrid's
    K/V read at the decode's mean length -> dict of GB and the bound ms."""
    s = cfg.ssm
    E = s.expand * cfg.d_model
    H, GN = E // s.head_dim, 2 * s.n_groups * s.d_state
    state = cfg.n_layers * (H * s.head_dim * s.d_state * 4
                            + (s.d_conv - 1) * (E + GN) * 2)
    weights, kv = 2 * n_params, 0
    if cfg.family == "hybrid":
        D, F = cfg.d_model, cfg.d_ff
        shared = 2 * (2 * D * D + 2 * D * cfg.n_heads * cfg.head_dim
                      + 2 * D * cfg.n_kv_heads * cfg.head_dim + 3 * D * F)
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        weights += shared * (n_attn - 1)
        mean_len = PROMPT_LEN + NEW_TOKENS / 2
        kv = n_attn * 2 * mean_len * cfg.n_kv_heads * cfg.head_dim * 2
    total = weights + rows * (2 * state + kv)
    return dict(weights_gb=weights / 1e9, state_mb=state / 1e6,
                kv_mb=kv / 1e6, total_gb=total / 1e9,
                ms=total / HBM_BYTES_PER_S * 1e3)


def ssm_serve(torch, dev, card, flush, name):
    """Phase 11 (a): ``name`` (mamba2-2.7b or zamba2-7b) at full width and
    the depth of SSM_SERVE_LAYERS, phase 3's workload. Returns (cfg,
    params, [(``kernels`` record, its main path's launches)])."""
    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.core.estimator import Estimator
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, ServeEngine

    full = get_arch(name)
    cfg = at_depth(full, SSM_SERVE_LAYERS[name])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    s = cfg.ssm
    E = s.expand * cfg.d_model
    hybrid = cfg.family == "hybrid"
    n_attn = cfg.n_layers // cfg.hybrid_attn_every if hybrid else 0
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    attn = (f"the shared attention block after every "
            f"{cfg.hybrid_attn_every} ({n_attn} applications; heads "
            f"{H}/{Hkv}, dh {dh}, d_ff {cfg.d_ff})" if hybrid
            else "no attention")
    print(f"[ssm] {cfg.name} at full width, depth cut to {cfg.n_layers} of "
          f"{full.n_layers} mamba2 layers (SSM_SERVE_LAYERS; d "
          f"{cfg.d_model}, d_inner {E}, {E // s.head_dim} heads of "
          f"{s.head_dim}, d_state {s.d_state}, chunk {s.chunk}), {attn}, "
          f"vocab {cfg.vocab}; {n_params / 1e9:.3f} B params bf16 "
          f"({2 * n_params / 1e9:.2f} GB), seeded init "
          f"{time.perf_counter() - t0:.1f} s; {N_PROMPTS} x {PROMPT_LEN} "
          f"tokens, {NEW_TOKENS} new")
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN),
                                     generator=g, device=dev)}

    def rcfg(**kw):
        return RobustDecodeConfig(**{**dict(m=8, estimator="vrmom", K=8,
                                            alpha=0.25), **kw})

    def engine(robust, **kw):
        return ServeEngine(cfg, params, max_len=MAX_LEN, robust=robust,
                           device=dev, **kw)

    runs = {key: engine(rcfg(attack=key[1], fuse_tail=key[2],
                             share_replica_compute=key[0] == "shared"))
            for key in SSM_RUNS}
    warm = runs["shared", "none", True]
    warm.generate_python_loop(batch, 2)  # warm-up
    warm.generate(batch, 2)
    torch.cuda.synchronize()

    # ---- the main path: counts from 0; launches from its traces ---------
    lap = time.perf_counter()
    res, counts, by_layout, counted = run_matrix(
        torch, K, cfg, runs, batch, SSM_TRACED[name], n_attn, "ssm")
    t_runs = time.perf_counter() - lap
    lap = time.perf_counter()
    ref = res["shared", "none", True]["toks"]
    fused = res["shared", "signflip", True]["graph_n"]
    require(fused == dict(aggregate=0, aggregate_sample=NEW_TOKENS,
                          flash_attention=n_attn,
                          decode_attention=n_attn * (NEW_TOKENS - 1)),
            f"{cfg.name}: fused greedy launches {fused}")
    # every kernel of the path launched (the wrappers count the eager
    # launches of every run); the traces hold those the records time
    path = (("aggregate", "aggregate_sample", "flash_attention",
             "decode_attention") if hybrid
            else ("aggregate", "aggregate_sample"))
    for k in path:
        require(counted[k] > 0, f"{cfg.name}: kernel {k} never launched on "
                                f"the main path")
    for k in (("flash_attention", "decode_attention") if hybrid else
              ("aggregate", "aggregate_sample")):
        require(counts[k] > 0, f"{cfg.name}: no traced launch of {k}")
    print(f"[ssm] {cfg.name} main-path launches {json.dumps(counts)} "
          f"(traced; the wrappers counted {json.dumps(counted)}, eager "
          f"launches only) ({card})")
    print(f"[ssm] {cfg.name} shared vs replicated: " + layout_check(
        torch, cfg, params, batch, MAX_LEN, ref,
        res["replicated", "signflip", True]["toks"]))
    t_layout = time.perf_counter() - lap
    lap = time.perf_counter()
    flash, dec = instances_ran(torch, warm, params, cfg, batch, ref[:, 0])
    want = ({(dh,)}, {(dh, 8 if G <= 8 else 16)}) if hybrid else (set(),
                                                                  set())
    require((flash, dec) == want, f"{cfg.name}: instances {flash} (B2) and "
                                  f"{dec} (B3), expected {want}")
    print(f"[ssm] {cfg.name} instances: " + (
        f"B2 flash_fwd_wgmma<{dh}> (the shared block's prefill), B3 "
        f"decode_split_kernel<{dh}, 8> (its decode, G {G})" if hybrid
        else "no B2 or B3 instance ran (no attention)"))
    # ---- prefill on the kernel path against the plain path --------------
    eng_p = engine(rcfg(estimator=Estimator(method="vrmom", K=8,
                                            backend="torch")),
                   attn_backend="torch")
    lk, _ = warm.prefill(batch)
    lp, _ = eng_p.prefill(batch)
    rel = max_err(lk, lp) / float(lp.float().abs().max())
    if hybrid:
        require(bool(torch.isfinite(lk.float()).all()) and rel <= LAYOUT_TOL,
                f"{cfg.name}: prefill logits kernel vs plain: {rel}")
    else:
        require(torch.equal(lk, lp), f"{cfg.name}: with no attention the "
                                     f"kernel and plain prefills differ: "
                                     f"{rel}")
    print(f"[ssm] {cfg.name}: prefill logits kernel vs plain path max err / "
          f"max|logit| = {rel:.3g} " + (
              f"(tolerance {LAYOUT_TOL}: B2 at dh {dh} against the plain "
              f"mha)" if hybrid else "(required 0: no attention, the same "
                                     "bits)"))
    del eng_p, lk, lp
    t_checks = time.perf_counter() - lap
    lap = time.perf_counter()
    # ---- times and bounds -----------------------------------------------
    pre_ms = prefill_median(torch, warm, batch)
    report_decode(torch, f"[ssm] {cfg.name} robust m=8 vrmom greedy (shared "
                  f"none)", warm, batch, pre_ms, card, profiled="graph")
    rep_eng = runs["replicated", "none", True]
    rep_walls = []
    for _ in range(3):
        t = time.perf_counter()
        rep_eng.generate(batch, NEW_TOKENS)
        torch.cuda.synchronize()
        rep_walls.append((time.perf_counter() - t) * 1e3)
    rep_ms = statistics.median(rep_walls)
    print(f"[ssm] {cfg.name} replicated (32 rows) none fused, graph: "
          f"generate walls " + ", ".join(f"{w:.1f}" for w in rep_walls) +
          f" ms: median {rep_ms:.1f}, decode "
          f"{(rep_ms - pre_ms) / (NEW_TOKENS - 1):.2f} ms/token ({card})")
    for rows, layout in ((N_PROMPTS, "shared"), (8 * N_PROMPTS,
                                                  "replicated")):
        b = ssm_reckoning(cfg, n_params, rows)
        print(f"[ssm] {cfg.name} decode bound, {layout} ({rows} rows): "
              f"weights {b['weights_gb']:.2f} GB" + (
                  f" (the shared block once an application)" if hybrid
                  else "") + f" + {rows} x (2 x {b['state_mb']:.1f} MB "
              f"state read and written" + (
                  f" + {b['kv_mb']:.1f} MB K/V read" if hybrid else "") +
              f") = {b['total_gb']:.2f} GB / {HBM_BYTES_PER_S / 1e12:.2f} "
              f"TB/s = {b['ms']:.2f} ms a step ({card})")
    print(f"[ssm] {cfg.name} peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} "
          f"({card})")

    t_report = time.perf_counter() - lap
    lap = time.perf_counter()

    # ---- the kernels at this config's shapes ----------------------------
    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    if hybrid:
        recs = [(attn_record(
            torch, flush, f"B2 flash_attention (causal, {cfg.name}'s shared "
            f"block: q/k/v [{N_PROMPTS},{PROMPT_LEN},{H},{dh}] bf16, G {G})",
            rand(N_PROMPTS, PROMPT_LEN, H, dh),
            rand(N_PROMPTS, PROMPT_LEN, Hkv, dh),
            rand(N_PROMPTS, PROMPT_LEN, Hkv, dh), decode=False),
            counts["flash_attention"]),
            (attn_record(
                torch, flush, f"B3 decode_attention ({cfg.name}'s shared "
                f"block: dh {dh}, G {G}, q [{N_PROMPTS},1,{H},{dh}], cache "
                f"[{N_PROMPTS},{MAX_LEN},{Hkv},{dh}] bf16)",
                rand(N_PROMPTS, 1, H, dh), rand(N_PROMPTS, MAX_LEN, Hkv, dh),
                rand(N_PROMPTS, MAX_LEN, Hkv, dh), decode=True),
             by_layout["shared"]["decode_attention"]),
            (pool_b3_record(
                torch, flush, torch.full((8 * N_PROMPTS,), MAX_LEN,
                                         dtype=torch.int32, device=dev),
                H, Hkv, dh, MAX_LEN, g, dev,
                where=f"{cfg.name} replicated, the last step"),
             by_layout["replicated"]["decode_attention"])]
    else:
        tail = pool_tail_records(torch, flush, N_PROMPTS, cfg.vocab, g, dev,
                                 where=f"{cfg.name} generate",
                                 b1_what=f"{cfg.name} unfused tail")
        recs = [(tail["aggregate_sample"], counts["aggregate_sample"]),
                (tail["aggregate"], counts["aggregate"])]
    print(f"[time] phase 11 (a) {cfg.name}: runs {t_runs:.1f} s, layouts "
          f"{t_layout:.1f}, instances and prefill {t_checks:.1f}, times "
          f"{t_report:.1f}, kernels {time.perf_counter() - lap:.1f}")
    del runs, warm, rep_eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, params, recs


def ssm_pool(torch, dev, card, cfg, params):
    """Phase 11 (b): zamba2-7b behind ``Scheduler`` over 8 slots of 512
    (robust m = 8, the pool's step replayed): the pool holds both kinds of
    cache, K/V masked by length and SSM states that every admission must
    overwrite."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import RobustDecodeConfig, Scheduler, ServeEngine

    rs = np.random.RandomState(10)
    reqs = []
    for _ in range(MOE_POOL_REQUESTS):
        S = int(rs.randint(POOL_PROMPT[0], POOL_PROMPT[1] + 1))
        n = int(rs.randint(POOL_NEW[0], POOL_NEW[1] + 1))
        reqs.append((rs.randint(0, cfg.vocab, size=(S,)).astype(np.int32), n))
    budget = sum(n for _, n in reqs)
    print(f"[ssm] {cfg.name} ServeEngine(max_len={POOL_MAX_LEN}, n_slots="
          f"{MOE_POOL_SLOTS}, robust m=8 vrmom K=8 shared fused, obs), "
          f"Scheduler(decode_block={POOL_BLOCK}), greedy; "
          f"{MOE_POOL_REQUESTS} requests, prompts {POOL_PROMPT[0]}.."
          f"{POOL_PROMPT[1]}, budgets {POOL_NEW[0]}..{POOL_NEW[1]} ({budget}"
          f" tokens)")
    scheds = {}
    for attack in ("none", "signflip", "gaussian"):
        eng = ServeEngine(cfg, params, max_len=POOL_MAX_LEN,
                          n_slots=MOE_POOL_SLOTS, obs=MetricsRegistry(),
                          robust=RobustDecodeConfig(m=8, estimator="vrmom",
                                                    K=8, alpha=0.25,
                                                    attack=attack),
                          device=dev)
        scheds[attack] = Scheduler(eng, decode_block=POOL_BLOCK)
    eng = scheds["none"].engine
    slots, admit = [], eng.admit

    def admit_noted(pool, slot, batch, **kw):
        slots.append(slot)
        return admit(pool, slot, batch, **kw)

    eng.admit = admit_noted
    K.reset_launch_counts()
    comp1, _, wall1 = drain(torch, scheds["none"], reqs)
    comp2, _, wall2 = drain(torch, scheds["none"], reqs)
    del eng.admit
    toks = [c.tokens for c in comp2]
    require(all(c.finished_by == "length" and len(c.tokens) == n
                and all(0 <= t < cfg.vocab for t in c.tokens)
                for c, (_, n) in zip(comp2, reqs)),
            f"{cfg.name} pool: a completion lacks its budget or leaves the "
            f"vocabulary")
    # the second drain admits every request into a slot an earlier request
    # held (whose state kept moving while the slot sat free): each must
    # give its tokens of the first drain
    require(toks == [c.tokens for c in comp1],
            f"{cfg.name} pool: a request admitted into an evicted slot "
            f"differs from its run in the first drain")
    for attack in ("signflip", "gaussian"):
        got, _, wall = drain(torch, scheds[attack], reqs)
        require([c.tokens for c in got] == toks,
                f"{cfg.name} pool tokens under {attack} differ from 'none'")
        print(f"[ssm] {cfg.name} pool {attack} a=0.25: tokens identical to "
              f"none (drain with set-up {wall:.3f} s)")
    counted = K.launch_counts()
    for name in ("aggregate_sample", "flash_attention", "decode_attention"):
        require(counted[name] > 0, f"{cfg.name} pool: kernel {name} never "
                                   f"launched")
    step = eng.obs.histograms["serve.decode_step_s"]
    print(f"[ssm] {cfg.name} pool drain {budget} tokens in {wall2:.3f} s = "
          f"{budget / wall2:.1f} tok/s (round 2; round 1 with set-up "
          f"{wall1:.3f} s); decode step p50 {step.percentile(50) * 1e3:.2f} "
          f"ms p95 {step.percentile(95) * 1e3:.2f} ms ({step.count} blocks);"
          f" the wrappers counted {json.dumps(counted)} (eager launches) "
          f"({card})")
    # the first request of the first drain admitted into a freed slot,
    # against the same request alone in a new pool at that slot (the same
    # batch of rows: the same bits)
    first = slots[:MOE_POOL_REQUESTS]
    i = next(j for j in range(len(first)) if first[j] in first[:j])
    p, n = reqs[i]
    pool = eng.make_pool()
    pool, tok0 = eng.admit(pool, first[i], {"tokens": torch.from_numpy(
        p)[None].to(dev)})
    cur = torch.zeros((MOE_POOL_SLOTS,), dtype=torch.int32)
    cur[first[i]] = tok0
    pool, more = eng.decode_pool(pool, cur, n - 1)
    alone = [tok0] + more[:, first[i]].tolist()
    require(alone == toks[i], f"{cfg.name} pool: request {i}, admitted into "
                              f"slot {first[i]} after an eviction, differs "
                              f"from its run alone in a new pool")
    print(f"[ssm] {cfg.name} request {i} (prompt {len(p)}), admitted into "
          f"slot {first[i]} after an eviction: tokens identical to its run "
          f"alone in a new pool; drain 2 (every admission into a freed "
          f"slot) identical to drain 1")
    for j in list(range(MOE_POOL_SOLO)) + [i]:
        p, n = reqs[j]
        batch = {"tokens": torch.from_numpy(p)[None].to(dev)}
        solo = eng.generate(batch, n)
        pooled = torch.tensor([toks[j]], dtype=solo.dtype, device=dev)
        print(f"[ssm] {cfg.name} request {j} (prompt {len(p)}): solo vs pool "
              + ("tokens identical" if torch.equal(solo, pooled) else
                 layout_check(torch, cfg, params, batch, POOL_MAX_LEN, solo,
                              pooled, m=MOE_POOL_SLOTS, what="solo vs pool")))
    del scheds, eng, pool
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_ssm(torch, dev, card):
    """Phase 11: the ssm and hybrid families. Returns the ``kernels``
    records with the launches of their paths."""
    flush = make_flush(torch, dev)
    recs = []
    for name in SSM_CONFIGS:
        t = time.perf_counter()
        cfg, params, more = ssm_serve(torch, dev, card, flush, name)
        recs += more
        print(f"[time] phase 11 (a) {name} {time.perf_counter() - t:.1f} s")
        if cfg.family == "hybrid":
            t = time.perf_counter()
            ssm_pool(torch, dev, card, cfg, params)
            print(f"[time] phase 11 (b) {time.perf_counter() - t:.1f} s")
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return moe_records(recs, card, tag="ssm")


def encdec_reckoning(cfg, n_dec: int, rows: int) -> dict:
    """The bytes one decode step of an encdec model must move at ``rows``
    cache rows, each read once: the decoder's bf16 weights and the tied
    embedding (the unembedding; the encoder does not run), each row's
    cross K/V whole and its self K/V at the decode's mean length -> dict
    of GB and MB and the bound ms."""
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    cross = kv * cfg.encoder.n_frames
    self_kv = kv * (PROMPT_LEN + NEW_TOKENS / 2)
    total = 2 * n_dec + rows * (cross + self_kv)
    return dict(weights_gb=2 * n_dec / 1e9, cross_mb=cross / 1e6,
                self_mb=self_kv / 1e6, total_gb=total / 1e9,
                ms=total / HBM_BYTES_PER_S * 1e3)


def encdec_roles(res, traced, Le: int, L: int) -> dict:
    """The device µs of each B2 and B3 launch in the traces of ``traced``
    (keys of ``res``, run by ``run_matrix`` with ``trace_eager``), by role
    and layout: a call's prefill launches B2 for the ``Le`` encoder layers,
    then a self and a cross launch a decoder layer; each decode step B3
    self, then cross, a decoder layer -> {(role, layout): [µs, ...]}."""
    roles = {}
    for key in traced:
        for call in res[key]["events"]:
            b2 = [us for name, us in call
                  if any(k in name for k in WRAPPER_KERNELS[
                      "flash_attention"])]
            b3 = [us for name, us in call if "decode_split_kernel" in name]
            for i, us in enumerate(b2):
                role = ("b2 encoder" if i < Le else
                        ("b2 self", "b2 cross")[(i - Le) % 2])
                roles.setdefault((role, key[0]), []).append(us)
            for j, us in enumerate(b3):
                roles.setdefault((("b3 self", "b3 cross")[j % 2], key[0]),
                                 []).append(us)
    return roles


def encdec_serve(torch, dev, card, flush):
    """Phase 12 (a): whisper-medium at full width and ENCDEC_LAYERS of its
    24 + 24 layers, phase 3's workload with numpy-seeded frames. Returns
    (cfg, params, [(``kernels`` record, its main path's launches)])."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.core.estimator import Estimator
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, ServeEngine

    full = get_arch("whisper-medium")
    cfg = at_depth(full, ENCDEC_LAYERS)
    L, Le, F = cfg.n_layers, cfg.encoder.n_layers, cfg.encoder.n_frames
    H, Hkv, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    require((full.n_layers, full.encoder.n_layers, F) == (24, 24, 1500)
            and (L, Le) == (ENCDEC_LAYERS, ENCDEC_LAYERS),
            f"{cfg.name}: {L} + {Le} layers over {F} frames")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    n_dec = (M.param_count(params["dec_layers"]) + params["embed"].numel()
             + params["norm_f"].numel())
    print(f"[encdec] {cfg.name} at full width, depth cut to {Le} of "
          f"{full.encoder.n_layers} encoder and {L} of {full.n_layers} "
          f"decoder layers (ENCDEC_LAYERS; d {D}, heads {H}/{Hkv} of {dh}, "
          f"d_ff {cfg.d_ff} SwiGLU, sinusoidal positions), {F} stub frames, "
          f"vocab {cfg.vocab} tied; {n_params / 1e9:.3f} B params bf16 "
          f"({2 * n_params / 1e9:.2f} GB; decoder and embedding "
          f"{2 * n_dec / 1e9:.3f} GB), seeded init "
          f"{time.perf_counter() - t0:.1f} s; {N_PROMPTS} x {PROMPT_LEN} "
          f"tokens, {NEW_TOKENS} new")
    g = torch.Generator(device=dev).manual_seed(1)
    frames = np.random.RandomState(ENCDEC_SEED).standard_normal(
        (N_PROMPTS, F, D)).astype(np.float32)
    batch = {"tokens": torch.randint(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN),
                                     generator=g, device=dev),
             "frames": torch.from_numpy(frames).to(dev, torch.bfloat16)}

    def rcfg(**kw):
        return RobustDecodeConfig(**{**dict(m=8, estimator="vrmom", K=8,
                                            alpha=0.25), **kw})

    def engine(robust, **kw):
        return ServeEngine(cfg, params, max_len=MAX_LEN, robust=robust,
                           device=dev, **kw)

    runs = {key: engine(rcfg(attack=key[1], fuse_tail=key[2],
                             share_replica_compute=key[0] == "shared"))
            for key in SSM_RUNS}
    warm = runs["shared", "none", True]
    warm.generate_python_loop(batch, 2)  # warm-up
    warm.generate(batch, 2)
    torch.cuda.synchronize()

    # ---- the main path: counts from 0; launches from its traces ---------
    # B2 once an encoder layer and twice a decoder layer (self, cross) a
    # prefill; B3 twice a decoder layer a step
    n_flash, n_b3 = Le + 2 * L, 2 * L
    lap = time.perf_counter()
    res, counts, _, counted = run_matrix(
        torch, K, cfg, runs, batch, ENCDEC_TRACED, n_flash, "encdec",
        n_decode=n_b3, trace_eager=True)
    t_runs = time.perf_counter() - lap
    lap = time.perf_counter()
    ref = res["shared", "none", True]["toks"]
    fused = res["shared", "signflip", True]["graph_n"]
    require(fused == dict(aggregate=0, aggregate_sample=NEW_TOKENS,
                          flash_attention=n_flash,
                          decode_attention=n_b3 * (NEW_TOKENS - 1)),
            f"{cfg.name}: fused greedy launches {fused}")
    for k in ("aggregate", "aggregate_sample", "flash_attention",
              "decode_attention"):
        require(counted[k] > 0, f"{cfg.name}: kernel {k} never launched on "
                                f"the main path")
    for k in ("aggregate", "aggregate_sample", "flash_attention",
              "decode_attention"):
        require(counts[k] > 0, f"{cfg.name}: no traced launch of {k}")
    print(f"[encdec] {cfg.name} main-path launches {json.dumps(counts)} "
          f"(traced; the wrappers counted {json.dumps(counted)}, eager "
          f"launches only) ({card})")
    print(f"[encdec] {cfg.name} shared vs replicated: " + layout_check(
        torch, cfg, params, batch, MAX_LEN, ref,
        res["replicated", "signflip", True]["toks"]))
    t_layout = time.perf_counter() - lap
    lap = time.perf_counter()
    flash, dec = instances_ran(torch, warm, params, cfg, batch, ref[:, 0])
    want = ({(dh,)}, {(dh, 8)})
    require((flash, dec) == want, f"{cfg.name}: instances {flash} (B2) and "
                                  f"{dec} (B3), expected {want}")
    print(f"[encdec] {cfg.name} instances: B2 flash_fwd_wgmma<{dh}> (the "
          f"encoder, non-causal; the decoder's causal self and non-causal "
          f"cross attention), B3 decode_split_kernel<{dh}, 8> (self and "
          f"cross, G {H // Hkv})")
    # ---- prefill on the kernel path against the plain path --------------
    eng_p = engine(rcfg(estimator=Estimator(method="vrmom", K=8,
                                            backend="torch")),
                   attn_backend="torch")
    lk, _ = warm.prefill(batch)
    lp, _ = eng_p.prefill(batch)
    rel = max_err(lk, lp) / float(lp.float().abs().max())
    require(bool(torch.isfinite(lk.float()).all()) and rel <= LAYOUT_TOL,
            f"{cfg.name}: prefill logits kernel vs plain: {rel}")
    print(f"[encdec] {cfg.name}: prefill logits kernel vs plain path max "
          f"err / max|logit| = {rel:.3g} (tolerance {LAYOUT_TOL}: B2 "
          f"non-causal over {F} frames and causal, against the plain mha)")
    del eng_p, lk, lp
    t_checks = time.perf_counter() - lap
    lap = time.perf_counter()
    # ---- times and bounds -----------------------------------------------
    pre_ms = prefill_median(torch, warm, batch)
    report_decode(torch, f"[encdec] {cfg.name} robust m=8 vrmom greedy "
                  f"(shared none)", warm, batch, pre_ms, card,
                  profiled="graph")
    rep_eng = runs["replicated", "none", True]
    rep_walls = []
    for _ in range(3):
        t = time.perf_counter()
        rep_eng.generate(batch, NEW_TOKENS)
        torch.cuda.synchronize()
        rep_walls.append((time.perf_counter() - t) * 1e3)
    rep_ms = statistics.median(rep_walls)
    print(f"[encdec] {cfg.name} replicated (32 rows) none fused, graph: "
          f"generate walls " + ", ".join(f"{w:.1f}" for w in rep_walls) +
          f" ms: median {rep_ms:.1f}, decode "
          f"{(rep_ms - pre_ms) / (NEW_TOKENS - 1):.2f} ms/token ({card})")
    for rows, layout in ((N_PROMPTS, "shared"), (8 * N_PROMPTS,
                                                  "replicated")):
        b = encdec_reckoning(cfg, n_dec, rows)
        print(f"[encdec] {cfg.name} decode bound, {layout} ({rows} rows): "
              f"decoder weights and embedding {b['weights_gb']:.3f} GB + "
              f"{rows} x ({b['cross_mb']:.1f} MB cross K/V + "
              f"{b['self_mb']:.1f} MB self K/V read) = {b['total_gb']:.2f} "
              f"GB / {HBM_BYTES_PER_S / 1e12:.2f} TB/s = {b['ms']:.2f} ms a "
              f"step ({card})")
    print(f"[encdec] {cfg.name} peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} "
          f"({card})")
    t_report = time.perf_counter() - lap
    lap = time.perf_counter()

    # ---- the kernels at this config's shapes ----------------------------
    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    S, B, R = PROMPT_LEN, N_PROMPTS, 8 * N_PROMPTS
    # each row's launches and time inside the main path, from its traces
    roles = encdec_roles(res, ENCDEC_TRACED, Le, L)

    def role(name, *layouts):
        return [us for lay in layouts for us in roles.get((name, lay), [])]

    in_path = [role("b2 encoder", "shared", "replicated"),
               role("b2 cross", "shared", "replicated"),
               role("b2 self", "shared", "replicated"),
               role("b3 cross", "shared"), role("b3 cross", "replicated"),
               role("b3 self", "shared")]
    recs = [
        (attn_record(torch, flush, f"B2 flash_attention (non-causal, "
                     f"{cfg.name}'s encoder: q/k/v [{B},{F},{H},{dh}] bf16)",
                     rand(B, F, H, dh), rand(B, F, Hkv, dh),
                     rand(B, F, Hkv, dh), decode=False, causal=False),
         len(in_path[0])),
        (attn_record(torch, flush, f"B2 flash_attention (non-causal, "
                     f"{cfg.name}'s cross attention: q [{B},{S},{H},{dh}], "
                     f"k/v [{B},{F},{Hkv},{dh}] bf16)",
                     rand(B, S, H, dh), rand(B, F, Hkv, dh),
                     rand(B, F, Hkv, dh), decode=False, causal=False),
         len(in_path[1])),
        (attn_record(torch, flush, f"B2 flash_attention (causal, "
                     f"{cfg.name}'s decoder self attention: q/k/v "
                     f"[{B},{S},{H},{dh}] bf16)",
                     rand(B, S, H, dh), rand(B, S, Hkv, dh),
                     rand(B, S, Hkv, dh), decode=False),
         len(in_path[2])),
        (attn_record(torch, flush, f"B3 decode_attention ({cfg.name}'s "
                     f"cross attention: q [{B},1,{H},{dh}] over the whole "
                     f"encoder cache [{B},{F},{Hkv},{dh}] bf16, no length "
                     f"mask)", rand(B, 1, H, dh), rand(B, F, Hkv, dh),
                     rand(B, F, Hkv, dh), decode=True),
         len(in_path[3])),
        (attn_record(torch, flush, f"B3 decode_attention ({cfg.name}'s "
                     f"cross attention, replicated: q [{R},1,{H},{dh}] over "
                     f"the whole encoder cache [{R},{F},{Hkv},{dh}] bf16, no "
                     f"length mask)", rand(R, 1, H, dh), rand(R, F, Hkv, dh),
                     rand(R, F, Hkv, dh), decode=True),
         len(in_path[4])),
        (pool_b3_record(torch, flush, torch.full((B,), MAX_LEN,
                                                 dtype=torch.int32,
                                                 device=dev),
                        H, Hkv, dh, MAX_LEN, g, dev,
                        where=f"{cfg.name}'s decoder self attention, the "
                              f"last step"),
         len(in_path[5]))]
    for (rec, n), us in zip(recs, in_path):
        require(n > 0, f"{cfg.name}: no launch of {rec['name']} in the "
                       f"main path's traces")
        rec["in_path_ms"] = statistics.median(us) / 1e3
        print(f"[encdec] {rec['name']}: in the main path "
              f"{rec['in_path_ms'] * 1e3:.2f} us (median over its {n} "
              f"launches in the traces of {len(ENCDEC_TRACED)} runs' eager "
              f"loops and generates), cold {rec['ms'] * 1e3:.2f} us, SDPA "
              f"{rec['library_ms'] * 1e3:.2f} us ({card})")
    tail = pool_tail_records(torch, flush, N_PROMPTS, cfg.vocab, g, dev,
                             where=f"{cfg.name} generate",
                             b1_what=f"{cfg.name} unfused tail")
    recs += [(tail["aggregate_sample"], counts["aggregate_sample"]),
             (tail["aggregate"], counts["aggregate"])]
    print(f"[time] phase 12 (a): runs {t_runs:.1f} s, layouts "
          f"{t_layout:.1f}, instances and prefill {t_checks:.1f}, times "
          f"{t_report:.1f}, kernels {time.perf_counter() - lap:.1f}")
    del runs, warm, rep_eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, params, recs


def encdec_pool(torch, dev, card, cfg, params):
    """Phase 12 (b): whisper-medium behind ``Scheduler`` over 8 slots of 512
    (robust m = 8, the pool's step replayed), 16 requests each with its own
    numpy-seeded frames: every admission encodes its frames and writes its
    slot's cross K/V."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import RobustDecodeConfig, Scheduler, ServeEngine

    F, D = cfg.encoder.n_frames, cfg.d_model
    rs = np.random.RandomState(ENCDEC_SEED + 1)
    reqs = []
    for _ in range(MOE_POOL_REQUESTS):
        S = int(rs.randint(POOL_PROMPT[0], POOL_PROMPT[1] + 1))
        n = int(rs.randint(POOL_NEW[0], POOL_NEW[1] + 1))
        reqs.append((rs.randint(0, cfg.vocab, size=(S,)).astype(np.int32), n,
                     {"frames": rs.standard_normal((F, D)).astype(
                         np.float32)}))
    budget = sum(r[1] for r in reqs)
    print(f"[encdec] {cfg.name} ServeEngine(max_len={POOL_MAX_LEN}, n_slots="
          f"{MOE_POOL_SLOTS}, robust m=8 vrmom K=8 shared fused, obs), "
          f"Scheduler(decode_block={POOL_BLOCK}), greedy; "
          f"{MOE_POOL_REQUESTS} requests, prompts {POOL_PROMPT[0]}.."
          f"{POOL_PROMPT[1]}, budgets {POOL_NEW[0]}..{POOL_NEW[1]} ({budget}"
          f" tokens), {F} frames each")
    scheds = {}
    for attack in ("none", "signflip", "gaussian"):
        eng = ServeEngine(cfg, params, max_len=POOL_MAX_LEN,
                          n_slots=MOE_POOL_SLOTS, obs=MetricsRegistry(),
                          robust=RobustDecodeConfig(m=8, estimator="vrmom",
                                                    K=8, alpha=0.25,
                                                    attack=attack),
                          device=dev)
        scheds[attack] = Scheduler(eng, decode_block=POOL_BLOCK)
    eng = scheds["none"].engine
    # a slot's self K/V over max_len and cross K/V over the frames, every
    # layer, and its position
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    want = kv * (POOL_MAX_LEN + F) + 4
    got = eng.obs.gauges["serve.kv_bytes_per_slot"]
    require(got == want, f"{cfg.name}: kv_bytes_per_slot {got}, expected "
                         f"{want} (the cross K/V counted)")
    print(f"[encdec] {cfg.name} serve.kv_bytes_per_slot {got:.0f} bytes = "
          f"{kv * POOL_MAX_LEN / 1e6:.1f} MB self K/V + {kv * F / 1e6:.1f} "
          f"MB cross K/V + 4 (its position)")
    K.reset_launch_counts()
    comp1, _, wall1 = drain(torch, scheds["none"], reqs)
    comp2, _, wall2 = drain(torch, scheds["none"], reqs)
    toks = [c.tokens for c in comp2]
    require(toks == [c.tokens for c in comp1]
            and all(c.finished_by == "length" and len(c.tokens) == r[1]
                    and all(0 <= t < cfg.vocab for t in c.tokens)
                    for c, r in zip(comp2, reqs)),
            f"{cfg.name} pool: two drains differ, or a completion lacks its "
            f"budget or leaves the vocabulary")
    for attack in ("signflip", "gaussian"):
        got, _, wall = drain(torch, scheds[attack], reqs)
        require([c.tokens for c in got] == toks,
                f"{cfg.name} pool tokens under {attack} differ from 'none'")
        print(f"[encdec] {cfg.name} pool {attack} a=0.25: tokens identical "
              f"to none (drain with set-up {wall:.3f} s)")
    counted = K.launch_counts()
    for name in ("aggregate_sample", "flash_attention", "decode_attention"):
        require(counted[name] > 0, f"{cfg.name} pool: kernel {name} never "
                                   f"launched")
    step = eng.obs.histograms["serve.decode_step_s"]
    print(f"[encdec] {cfg.name} pool drain {budget} tokens in {wall2:.3f} s "
          f"= {budget / wall2:.1f} tok/s (round 2; round 1 with set-up "
          f"{wall1:.3f} s); decode step p50 {step.percentile(50) * 1e3:.2f} "
          f"ms p95 {step.percentile(95) * 1e3:.2f} ms ({step.count} blocks);"
          f" the wrappers counted {json.dumps(counted)} (eager launches) "
          f"({card})")
    for i, (p, n, ex) in enumerate(reqs[:MOE_POOL_SOLO]):
        batch = {"tokens": torch.from_numpy(p)[None].to(dev),
                 "frames": torch.from_numpy(ex["frames"])[None].to(dev)}
        solo = eng.generate(batch, n)
        pooled = torch.tensor([toks[i]], dtype=solo.dtype, device=dev)
        print(f"[encdec] {cfg.name} request {i} (prompt {len(p)}): solo vs "
              f"pool " + ("tokens identical" if torch.equal(solo, pooled)
                          else layout_check(torch, cfg, params, batch,
                                            POOL_MAX_LEN, solo, pooled,
                                            m=MOE_POOL_SLOTS,
                                            what="solo vs pool")))
    del scheds, eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_encdec(torch, dev, card):
    """Phase 12: the encdec family. Returns the ``kernels`` records with
    the launches of their paths."""
    flush = make_flush(torch, dev)
    t = time.perf_counter()
    cfg, params, recs = encdec_serve(torch, dev, card, flush)
    print(f"[time] phase 12 (a) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    encdec_pool(torch, dev, card, cfg, params)
    print(f"[time] phase 12 (b) {time.perf_counter() - t:.1f} s")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return moe_records(recs, card, tag="encdec")


def encdec_train_reckoning(cfg, n_params: int, seq: int) -> dict:
    """GB a stacked AdamW step of an encdec model should hold at its peak
    (``train_reckoning``'s terms for both stacks): bf16 params and
    autograd grads, the bf16 stack of W workers, f32 moments, the remat
    boundaries of one worker's encoder (its frames) and decoder (``seq``
    tokens), one recomputed encoder layer's ``mha`` (f32 scores and
    probabilities of [H, frames, frames], every chunk kept by autograd)
    and one f32 loss chunk of logits."""
    D, H, V = cfg.d_model, cfg.n_heads, cfg.vocab
    Le, Fr = cfg.encoder.n_layers, cfg.encoder.n_frames
    return {"params": 2 * n_params / 1e9, "grads": 2 * n_params / 1e9,
            "stack": 2 * n_params * TRAIN_W / 1e9,
            "adamw m, v": 8 * n_params / 1e9,
            "remat boundaries": (Le * Fr + cfg.n_layers * seq) * D * 2 / 1e9,
            "one encoder layer's recompute": 2 * H * Fr * Fr * 4 / 1e9,
            "loss chunk": min(cfg.loss_chunk, seq) * V * 4 / 1e9}


def encdec_products(cfg, seq: int) -> int:
    """The 3-D x 2-D products of one whisper forward over ``seq`` decoder
    tokens, each one B1 on its ``dW`` stack in an inloop backward: q, k,
    v, o and the MLP's gate, up, down an encoder layer; the self
    attention's four, the cross attention's q, k, v (k and v over the
    encoder output), o and the MLP's three a decoder layer; the tied
    unembedding once a loss chunk."""
    return (7 * cfg.encoder.n_layers + 11 * cfg.n_layers
            + -(-seq // cfg.loss_chunk))


def phase_train_encdec(torch, dev, card: str):
    """Phase 13: Byzantine-robust training of whisper-medium at full width
    and depth (24 encoder and 24 decoder layers, d 1024, 16 heads of 64,
    V 51865 tied, bf16, seeded weights; no cut), phase 7's W = 8 workers
    emulated on the card, each with 1500 stub frames and 448 decoder
    tokens. Returns the ``kernels`` records of the phase with the
    launches of its main path (the timed stacked steps and the inloop
    steps)."""
    from repro_torch.configs import get as get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "train-encdec"
    cfg = get_arch("whisper-medium")
    W, S, L = TRAIN_W, ENCDEC_TRAIN_SEQ, cfg.n_layers
    Le, Fr = cfg.encoder.n_layers, cfg.encoder.n_frames
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(13),
                    device=dev)
    n_params = M.param_count(params)
    n_enc = M.param_count(params["enc_layers"]) + params["norm_enc"].numel()
    n_dec = n_params - n_enc
    n_leaves = len(list(leaves(params)))
    est, opt, opt_state, setup, clean, n_byz = train_setups(cfg, params, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"[{tag}] {cfg.name} at full width and depth ({Le} encoder + {L} "
          f"decoder layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, V {cfg.vocab} tied; {n_params / 1e9:.4f} B "
          f"params: encoder {n_enc / 1e9:.4f}, decoder and embedding "
          f"{n_dec / 1e9:.4f}; bf16), W = {W} workers of one sample each "
          f"({Fr} frames, {S} decoder tokens), VRMOM K {TRAIN_K}, AdamW lr "
          f"{TRAIN_LR}, alpha {TRAIN_ALPHA} = int({TRAIN_ALPHA} * {W - 1}) "
          f"= {n_byz} signflip row(s), remat {cfg.remat}")

    def batch(i):
        return lm_batch(cfg, i, W, S, device=dev)

    # -- (a) stacked-auto ------------------------------------------------------
    r = train_main_path(torch, cfg, params, opt_state, setup, clean, batch,
                        gen)
    counts = r["counts"]
    n_fwd = 2 if cfg.remat else 1
    n_attn = Le + 2 * L   # B2: the encoder's, then a self and a cross
    require(counts["aggregate"] == 3 * n_leaves
            and counts["flash_attention"] == 3 * W * n_fwd * n_attn,
            f"stacked steps launched {counts}; expected B1 {3 * n_leaves}, "
            f"B2 {3 * W * n_fwd * n_attn}")
    report_main_path(
        tag, card, r, W * S, 6 * (n_enc * Fr + n_dec * S) * W,
        f"6*(N_enc*{Fr} + N_dec*{S})*W", encdec_train_reckoning(
            cfg, n_params, S))
    # one profiled step, for the split of device time only: the tracer
    # drops a trace's first events (the launch checks use the counter)
    n_b1, n_b2 = report_profiled_step(
        torch, tag, card,
        lambda: setup.step_fn(params, opt_state, batch(4), gen))
    print(f"[{tag}] (a) the counter's launches a step: B1 {n_leaves}, B2 "
          f"{W * n_fwd * n_attn}; the trace held {n_b1} and {n_b2}")

    # -- the split of a step, and (b) the robustness contract ------------------
    split_and_robustness(torch, cfg, params, opt, opt_state, est, gen,
                         batch(5), n_byz, tag, card)

    # -- (c) inloop: the whole global batch in one forward ---------------------
    inloop = make_train_step(cfg, W, estimator=est, mode="inloop",
                             optimizer=opt, device=dev)
    in_losses, in_walls, in_counts, in_peak = inloop_steps(
        torch, inloop, params, opt_state, [batch(10 + i) for i in range(2)])
    n_dots = encdec_products(cfg, S)
    require(in_counts["aggregate"] == 2 * n_dots
            and in_counts["flash_attention"] == 2 * n_fwd * n_attn,
            f"inloop steps launched {in_counts}; expected B1 {2 * n_dots}, "
            f"B2 {2 * n_fwd * n_attn}")
    print(f"[{tag}] (c) inloop at {W} x ({Fr} frames, {S} tokens), "
          f"{n_dots} products a step: losses "
          f"{[round(x, 5) for x in in_losses]}, steps "
          f"{[round(w, 4) for w in in_walls]} s (median "
          f"{statistics.median(in_walls):.4f}), peak memory {in_peak:.2f} "
          f"GB; launches {json.dumps(in_counts)} ({card})")
    del params, opt_state
    torch.cuda.empty_cache()

    # -- (d) the kernels at the training shapes --------------------------------
    flush = make_flush(torch, dev)
    g = torch.Generator(device=dev).manual_seed(130)
    D, Ff, H, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    C = Le * D * Ff   # enc_layers.mlp.w_gate, the largest leaf
    recs = [b1_stack_record(
        torch, flush, g, C,
        f"B1 aggregate on whisper-medium's gradient stacks (vrmom "
        f"K={TRAIN_K}, bf16; timed at enc_layers.mlp.w_gate [{W},{C}])",
        counts["aggregate"]), b1_record(
        torch, flush, f"B1 aggregate in whisper-medium's inloop backward "
        f"(one MLP product's dW, vrmom K={TRAIN_K}, [{W},{D}*{Ff}] f32)",
        torch.randn((W, D * Ff), generator=g, device=dev), TRAIN_K,
        in_counts["aggregate"])]

    def qkv(s, t):
        return (torch.randn((1, n, H, dh), generator=g, device=dev,
                            dtype=torch.bfloat16) for n in (s, t, t))

    # per role, its share of the counted B2 launches of the timed steps
    # (every encoder layer one, every decoder layer a self and a cross,
    # each twice under remat), held exact above
    per_layer = 3 * W * n_fwd
    for role, (s, t), causal, n in (("encoder", (Fr, Fr), False, Le),
                                    ("cross", (S, Fr), False, L),
                                    ("decoder self", (S, S), True, L)):
        q, k, v = qkv(s, t)
        what = (f"q [1,{s},{H},{dh}], k/v [1,{t},{H},{dh}] bf16 "
                + ("causal" if causal else "non-causal"))
        rec = attn_record(
            torch, flush, f"B2 flash_attention forward, whisper-medium "
            f"training, {role} ({what}; launches: the role's share of the "
            f"stacked steps' counted B2)", q, k, v, decode=False,
            causal=causal)
        rec["launches"] = per_layer * n
        recs.append(rec)
        if not causal:
            recs.append(b2_autograd_record(
                torch, flush, g,
                f"B2 under autograd, whisper-medium training, {role} "
                f"(FlashAttentionFn: B2 forward + the mha recompute "
                f"backward; max_abs_err is the recompute's gradient against "
                f"the plain path's), {what}; library: SDPA forward + "
                f"backward", q, k, v, causal=False, chunk=cfg.attn_chunk,
                launches=per_layer * n))
    print_train_records(tag, card, recs)
    print(f"[{tag}] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return recs


def moe_train_reckoning(cfg, n_params: int, seq: int) -> dict:
    """``train_reckoning``'s terms for a moe model, plus what autograd
    keeps of the recomputed layer's routing: the dispatched rows [E, G C,
    D] and the experts' output and its padded copy (bf16), the experts'
    four [E, G C, F] hidden tensors (bf16), and the combine's [G, T, k, D]
    gathered rows in bf16, their f32 cast and its weighted product, over
    the G groups of one worker's ``seq`` tokens."""
    from repro_torch.models import moe as X

    m = cfg.moe
    c = min(X.MOE_SEQ_CHUNK, seq)
    c = c if seq % c == 0 else seq
    G, C = seq // c, X.capacity(cfg, c)
    E, D, Fd = m.n_experts, cfg.d_model, cfg.d_ff
    rows = E * G * C
    return dict(train_reckoning(cfg, n_params, seq), **{
        "one layer's dispatch and experts": (
            3 * 2 * rows * D + 4 * 2 * rows * Fd
            + (2 + 4 + 4) * G * c * m.top_k * D) / 1e9})


def drop_share(calls) -> tuple:
    """(share of (token, slot) pairs past capacity over ``calls``, the
    least and the largest share of one call)."""
    per = [float((~r.keep).float().mean()) for r in calls]
    n = sum(r.keep.numel() for r in calls)
    return (sum(int((~r.keep).sum()) for r in calls) / n, min(per),
            max(per))


def recompute_routes(calls, L: int) -> list:
    """The forward layer each call after the first ``L`` (the backward's
    recomputes) routes as, matched by its decisions: a list of the layers
    each matches (one, when the recompute routed as the forward did)."""
    return [[i for i, a in enumerate(calls[:L])
             if a.expert.equal(r.expert) and a.pos.equal(r.pos)]
            for r in calls[L:]]


def grads_parted(torch, ga, gb) -> dict:
    """For each leaf whose two gradients are not bit-equal: (entries that
    differ, the largest difference, the leaf's largest entry)."""
    from repro_torch.tree import paths

    out = {}
    for (path, a), (_, b) in zip(paths(ga), paths(gb)):
        if torch.equal(a, b):
            continue
        d = (a.float() - b.float()).abs()
        out[".".join(path)] = (int((d > 0).sum()), float(d.max()),
                               float(a.float().abs().max()))
    return out


def update_controls(torch, params, p0, dev, measure, apart=None) -> dict:
    """The loss gate's controls on the update the main path made, d = p -
    p0 (``p0`` the leaves before it, on the host): ``measure()`` with the
    params at p0 - d (the update reversed: what a backward of the wrong
    sign applies) and at p0 + s d with each entry's sign s drawn at random
    (a backward whose signs carry nothing of the loss, each entry moved as
    far). ``apart``: (name, a predicate on a leaf's dotted key path) adds
    p0 + d with only those leaves' signs drawn (phase 14: the moe leaves,
    the router's and the experts' share of the update). The params are
    restored after."""
    from repro_torch.tree import paths

    now = [(".".join(k), x, x.clone()) for k, x in paths(params)]
    g = torch.Generator(device=dev).manual_seed(141)
    out = {}
    for name in ("reversed", "random signs") + (() if apart is None
                                                 else (apart[0],)):
        for (path, x, x1), x0 in zip(now, p0):
            x0 = x0.to(dev).float()
            d = x1.float() - x0
            if name == "reversed":
                d = -d
            elif name == "random signs" or apart[1](path):
                d = torch.where(torch.rand(d.shape, generator=g, device=dev)
                                < 0.5, -d, d)
            x.copy_(x0 + d)
            del x0, d
        out[name] = measure()
    for _, x, x1 in now:
        x.copy_(x1)
    return out


def phase_train_moe(torch, dev, card: str):
    """Phase 14: Byzantine-robust training of granite-moe-3b-a800m at full
    width (d 1536, 24 heads over 8 kv heads of 64, 40 experts top-8 of
    d_ff 512, V 49155 tied, bf16, seeded weights), MOE_TRAIN_LAYERS of its
    32 layers, phase 7's W = 8 workers emulated on the card, each one
    4096-token row. Returns the ``kernels`` records of the phase with the
    launches of its main path (the timed stacked steps and the inloop
    steps)."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe as X
    from repro_torch.models import transformer as T
    from repro_torch.train.step import loss_and_grads, make_train_step
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "train-moe"
    full = get_arch("granite-moe-3b-a800m")
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    W, S, L = TRAIN_W, TRAIN_SEQ, cfg.n_layers
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(14),
                    device=dev)
    n_params = M.param_count(params)
    n_active = M.active_param_count(params, cfg)
    n_leaves = len(list(leaves(params)))
    est, opt, opt_state, setup, clean, n_byz = train_setups(
        cfg, params, dev, lr=MOE_TRAIN_LR)
    gen = torch.Generator(device=dev).manual_seed(0)
    chunk = min(X.MOE_SEQ_CHUNK, S)
    print(f"[{tag}] {cfg.name} at full width, depth cut to {L} of "
          f"{full.n_layers} layers (MOE_TRAIN_LAYERS; the whole model "
          f"reckons at 92.4 GB before activations): d {D}, {H} heads over "
          f"{Hkv} kv heads of {dh}, {E} experts top-{k} of d_ff {cfg.d_ff}, "
          f"V {cfg.vocab} tied; {n_params / 1e9:.4f} B params "
          f"({n_active / 1e9:.4f} B active a token), {n_leaves} leaves, "
          f"bf16; W = {W} workers of one {S}-token row each ({S // chunk} "
          f"routing groups of {chunk}, capacity {X.capacity(cfg, chunk)} "
          f"rows an expert), VRMOM K {TRAIN_K}, AdamW lr {MOE_TRAIN_LR}, "
          f"alpha "
          f"{TRAIN_ALPHA} = int({TRAIN_ALPHA} * {W - 1}) = {n_byz} signflip "
          f"row(s), remat {cfg.remat}")

    def batch(i, seq=S):
        return lm_batch(cfg, i, W, seq, device=dev)

    def ce_aux(b):
        """(next-token CE, load-balance sum over the layers) of ``b``."""
        with torch.no_grad():
            h, _, aux = T.forward(params, cfg, b)
            return (float(T.next_token_ce(params, cfg, h, b["tokens"])),
                    float(aux))

    # -- (a) stacked-auto ------------------------------------------------------
    before = ce_aux(batch(0))
    p0 = [x.cpu() for x in leaves(params)]
    r = train_main_path(torch, cfg, params, opt_state, setup, clean, batch,
                        gen)
    after = ce_aux(batch(0))
    controls = update_controls(
        torch, params, p0, dev, lambda: ce_aux(batch(0)),
        apart=("moe leaves' signs random", lambda path: ".moe." in path))
    del p0

    def loss(ca):
        return ca[0] + 0.01 * ca[1]

    def show(ca):
        return (f"CE {ca[0]:.5f}, load-balance sum {ca[1]:.4f}, loss "
                f"{loss(ca):.5f}")

    print(f"[{tag}] (a) batch 0 (the loss adds 0.01 x the load-balance sum "
          f"over the layers): at the start {show(before)}; after the 4 "
          f"steps {show(after)}; the controls, the update " + "; ".join(
              f"{name}: {show(ca)}" for name, ca in controls.items()))
    # the CE falls too, not the load-balance term alone; the gate fails
    # for the reversed update; random signs, over every leaf or over the
    # moe leaves alone, lower neither the CE nor the loss as far as the
    # update made (the attention's and the embedding's updates make most
    # of the fall, so this last holds the router's and experts' own)
    rev, rnd = controls["reversed"], controls["random signs"]
    moe = controls["moe leaves' signs random"]
    require(after[0] < before[0],
            f"batch 0's next-token CE did not fall: {before[0]} -> "
            f"{after[0]}")
    require(rev[0] > before[0] and loss(rev) > loss(before),
            f"the update reversed did not raise batch 0's CE and loss "
            f"({rev} from {before}): the gate would pass a backward of "
            f"the wrong sign")
    require(rnd[0] > after[0] and loss(rnd) > loss(after),
            f"the update with random signs lowered batch 0's CE or loss "
            f"as far as the update made ({rnd} against {after})")
    require(moe[0] > after[0] and loss(moe) > loss(after),
            f"the update with the moe leaves' signs random lowered batch "
            f"0's CE or loss as far as the update made ({moe} against "
            f"{after})")
    counts = r["counts"]
    n_fwd = 2 if cfg.remat else 1
    require(counts["aggregate"] == 3 * n_leaves
            and counts["flash_attention"] == 3 * W * n_fwd * L,
            f"stacked steps launched {counts}; expected B1 {3 * n_leaves}, "
            f"B2 {3 * W * n_fwd * L}")
    report_main_path(tag, card, r, W * S, 6 * n_active * W * S,
                     f"6*N_active*tokens (N_active {n_active / 1e9:.4f} B: "
                     f"top-{k} of {E} experts)",
                     moe_train_reckoning(cfg, n_params, S))
    # the (token, slot) pairs capacity drops in the next step's forward:
    # its 8 workers' rows routed as the step routes them (one row a
    # forward, the same params)
    b4 = batch(4)
    with torch.no_grad():
        _, calls = routed(lambda: [M.loss(params, cfg, {
            key: v[w:w + 1] for key, v in b4.items()}) for w in range(W)])
    share, lo, hi = drop_share(calls)
    print(f"[{tag}] (a) capacity drops in the profiled step's forward: "
          f"{100 * share:.2f} % of its {W} x {S} x {k} (token, slot) pairs "
          f"({len(calls)} routings: {W} workers x {L} layers x {S // chunk} "
          f"groups each; one layer and worker {100 * lo:.2f}-{100 * hi:.2f} "
          f"%)")
    del calls
    # one profiled step, for the split of device time only: the tracer
    # drops a trace's first events (the launch checks use the counter)
    n_b1, n_b2 = report_profiled_step(
        torch, tag, card, lambda: setup.step_fn(params, opt_state, b4, gen),
        MOE_ROUTING_KERNELS)
    print(f"[{tag}] (a) the counter's launches a step: B1 {n_leaves}, B2 "
          f"{W * n_fwd * L}; the trace held {n_b1} and {n_b2}")

    # -- one worker's gradients twice: the recompute's routing, determinism ---
    b5 = batch(5)
    bw = {key: v[:1] for key, v in b5.items()}
    (la, ga), calls = routed(lambda: loss_and_grads(cfg, params, bw))
    redo = recompute_routes(calls, L)
    print(f"[{tag}] one worker's backward: {len(calls) - L} recomputed "
          f"routings, each matched to the forward layer(s) "
          f"{[m[0] if len(m) == 1 else m for m in redo]}")
    require(len(calls) == 2 * L and all(len(m) == 1 for m in redo)
            and sorted(m[0] for m in redo) == list(range(L)),
            f"the backward's recompute did not route as the forward: "
            f"{len(calls)} routings, matches {redo}")
    del calls
    lb, gb = loss_and_grads(cfg, params, bw)
    parted = grads_parted(torch, ga, gb)
    print(f"[{tag}] determinism: one worker's loss_and_grads twice on one "
          f"batch: loss {float(la)!r} and {float(lb)!r} "
          f"({'bit-equal' if torch.equal(la, lb) else 'parted'}); "
          + ("every leaf's gradient bit-equal" if not parted else
             f"{len(parted)} of {n_leaves} leaves parted (entries that "
             f"differ, largest difference, the leaf's largest |entry|): "
             + "; ".join(f"{p} {n}, {d:.4g}, {m:.4g}"
                         for p, (n, d, m) in sorted(parted.items())))
          + f" ({card})")
    del ga, gb

    # -- the split of a step, and (b) the robustness contract ------------------
    split_and_robustness(torch, cfg, params, opt, opt_state, est, gen,
                         batch(6), n_byz, tag, card,
                         apart=[f"layers.moe.{n}" for n in
                                ("router", "w_gate", "w_up", "w_down")])

    # -- (c) inloop: the whole global batch in one forward ---------------------
    inloop = make_train_step(cfg, W, estimator=est, mode="inloop",
                             optimizer=opt, device=dev)
    in_losses, in_walls, in_counts, in_peak = inloop_steps(
        torch, inloop, params, opt_state,
        [batch(10 + i, INLOOP_SEQ) for i in range(2)])
    # q, k, v, o a layer; the tied unembedding once a loss chunk
    n_dots = 4 * L + -(-INLOOP_SEQ // cfg.loss_chunk)
    require(in_counts["aggregate"] == 2 * n_dots
            and in_counts["flash_attention"] == 2 * n_fwd * L,
            f"inloop steps launched {in_counts}; expected B1 {2 * n_dots}, "
            f"B2 {2 * n_fwd * L}")
    n_wire = (M.param_count(params["layers"]["attn"])
              + params["embed"].numel())
    print(f"[{tag}] (c) inloop at {W} x {INLOOP_SEQ} tokens (a routing "
          f"group of {INLOOP_SEQ} a row, capacity "
          f"{X.capacity(cfg, INLOOP_SEQ)}), {n_dots} products a step on the "
          f"wire: losses {[round(x, 5) for x in in_losses]}, steps "
          f"{[round(w, 4) for w in in_walls]} s (median "
          f"{statistics.median(in_walls):.4f}), peak memory {in_peak:.2f} "
          f"GB; launches {json.dumps(in_counts)}; the wire covers "
          f"{n_wire / 1e9:.4f} B of {n_params / 1e9:.4f} B params "
          f"({100 * n_wire / n_params:.2f} %: q, k, v, o and the tied "
          f"embedding; the router and the experts take the plain batch "
          f"gradient, as in repro) ({card})")
    del params, opt_state
    torch.cuda.empty_cache()

    # -- (d) the kernels at the training shapes --------------------------------
    flush = make_flush(torch, dev)
    g = torch.Generator(device=dev).manual_seed(140)
    C = L * E * D * cfg.d_ff   # layers.moe.w_gate, the largest leaf
    recs = [b1_stack_record(
        torch, flush, g, C,
        f"B1 aggregate on granite-moe-3b-a800m's gradient stacks (vrmom "
        f"K={TRAIN_K}, bf16; timed at layers.moe.w_gate [{W},{C}], {L} "
        f"layers)", counts["aggregate"]), b1_record(
        torch, flush, f"B1 aggregate in granite-moe-3b-a800m's inloop "
        f"backward (one attention product's dW, vrmom K={TRAIN_K}, "
        f"[{W},{D}*{H * dh}] f32)",
        torch.randn((W, D * H * dh), generator=g, device=dev), TRAIN_K,
        in_counts["aggregate"])]
    q = torch.randn((1, S, H, dh), generator=g, device=dev,
                    dtype=torch.bfloat16)
    kk, v = (torch.randn((1, S, Hkv, dh), generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    what = f"q [1,{S},{H},{dh}], k/v [1,{S},{Hkv},{dh}] bf16 causal (G " \
           f"{H // Hkv})"
    rec = attn_record(
        torch, flush, f"B2 flash_attention forward, granite-moe-3b-a800m "
        f"training ({what})", q, kk, v, decode=False)
    rec["launches"] = counts["flash_attention"]
    recs.append(rec)
    recs.append(b2_autograd_record(
        torch, flush, g,
        f"B2 under autograd, granite-moe-3b-a800m training (FlashAttentionFn: "
        f"B2 forward + the mha recompute backward; max_abs_err is the "
        f"recompute's gradient against the plain path's, launches are the "
        f"stacked steps' B2 forwards), {what}; library: SDPA forward + "
        f"backward", q, kk, v, causal=True, chunk=cfg.attn_chunk,
        launches=counts["flash_attention"]))
    print_train_records(tag, card, recs)
    print(f"[{tag}] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return recs


def ssm_train_reckoning(cfg, n_params: int, seq: int) -> dict:
    """``train_reckoning``'s terms for the ssm and hybrid families. What
    autograd keeps of one recomputed mamba layer: the SSD's [nc, 1, H, L,
    L] tensors (the decay matrix and C.B weighted by it in f32, C.B and
    the scan's weights in bf16: 12 B an entry) and ten [seq, d_inner] bf16
    tensors (the projections, the conv, the gate, the norm). A hybrid adds
    each application's kept shared-block activations (its input, x, the
    norms, q, k, v, the attention's output: twelve [seq, D] bf16 tensors,
    four [seq, d_ff] of the MLP and four [seq, D] f32 of the norms and the
    rotary) and ``train_reckoning``'s ``mha`` recompute at its H heads;
    the ssm family has no attention."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    out = train_reckoning(cfg, n_params, seq)
    mha = out.pop("one layer's recompute")
    out["one mamba layer's recompute"] = (
        12 * seq * H * s.chunk + 10 * 2 * seq * d_inner) / 1e9
    if cfg.family == "hybrid":
        D, G = cfg.d_model, cfg.n_layers // cfg.hybrid_attn_every
        out["the shared block's activations"] = G * seq * (
            2 * (12 * D + 4 * cfg.d_ff) + 4 * 4 * D) / 1e9
        out["the shared block's mha recompute"] = mha
    return out


def train_ssm_model(torch, dev, card: str, name: str, n_layers: int,
                    seed: int) -> list:
    """Phase 15 for one model: ``name`` at full width and ``n_layers``
    layers (seeded bf16 weights, remat on), phase 7's W workers of one
    4096-token row. Returns its ``kernels`` records with the launches of
    its main path (the timed stacked steps and the inloop steps)."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves, paths

    t_model = time.perf_counter()
    tag = f"train-{name.split('-')[0]}"
    full = get_arch(name)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    W, S, L, D, V = TRAIN_W, TRAIN_SEQ, n_layers, cfg.d_model, cfg.vocab
    s = cfg.ssm
    d_inner = s.expand * D
    hybrid = cfg.family == "hybrid"
    # the shared block's applications: G groups of `every`, then the tail
    G = L // cfg.hybrid_attn_every if hybrid else 0
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    n_params = M.param_count(params)
    n_shared = M.param_count(params["shared"]) if hybrid else 0
    # 6 N tokens with the shared block counted once an application
    n_flop = n_params + max(G - 1, 0) * n_shared
    n_leaves = len(list(leaves(params)))
    est, opt, opt_state, setup, clean, n_byz = train_setups(cfg, params, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    what = (f"{G} groups of {cfg.hybrid_attn_every} mamba layers, each "
            f"followed by the shared block ({cfg.n_heads} heads of "
            f"{cfg.head_dim}, G 1, d_ff {cfg.d_ff}, {n_shared / 1e9:.4f} B "
            f"params), then a tail of {L - G * cfg.hybrid_attn_every}"
            if hybrid else "no attention")
    print(f"[{tag}] {cfg.name} at full width, depth cut to {L} of "
          f"{full.n_layers} layers: d {D}, {d_inner // s.head_dim} mamba "
          f"heads of {s.head_dim}, N {s.d_state}, chunk {s.chunk}, {what}; "
          f"V {V} tied; {n_params / 1e9:.4f} B params, {n_leaves} leaves, "
          f"bf16; W = {W} workers of one {S}-token row each, VRMOM K "
          f"{TRAIN_K}, AdamW lr {TRAIN_LR}, alpha {TRAIN_ALPHA} = "
          f"int({TRAIN_ALPHA} * {W - 1}) = {n_byz} signflip row(s), remat "
          f"{cfg.remat}")

    def batch(i, seq=S):
        return lm_batch(cfg, i, W, seq, device=dev)

    def loss_b0():
        with torch.no_grad():
            return float(M.loss(params, cfg, batch(0)))

    # -- (a) stacked-auto ------------------------------------------------------
    before = loss_b0()
    p0 = [x.to("cpu", copy=True) for x in leaves(params)]
    r = train_main_path(torch, cfg, params, opt_state, setup, clean, batch,
                        gen)
    after = r["loss0_after"]
    controls = update_controls(torch, params, p0, dev, loss_b0)
    del p0
    print(f"[{tag}] (a) batch 0's loss: at the start {before:.5f}; after "
          f"the 4 steps {after:.5f}; the controls, the update " + "; ".join(
              f"{k}: {v:.5f}" for k, v in controls.items()))
    # the gate fails for the reversed update; random signs lower the loss
    # less far than the update made
    rev, rnd = controls["reversed"], controls["random signs"]
    require(rev > before,
            f"the update reversed did not raise batch 0's loss ({rev} from "
            f"{before}): the gate would pass a backward of the wrong sign")
    require(rnd > after,
            f"the update with random signs lowered batch 0's loss as far "
            f"as the update made ({rnd} against {after})")
    counts = r["counts"]
    # B1 once a leaf; B2 once an application and worker: hybrid.forward
    # checkpoints the mamba layers only, so the shared block keeps its
    # activations and is not recomputed
    require(counts["aggregate"] == 3 * n_leaves
            and counts["flash_attention"] == 3 * W * G,
            f"stacked steps launched {counts}; expected B1 {3 * n_leaves}, "
            f"B2 {3 * W * G}")
    report_main_path(tag, card, r, W * S, 6 * n_flop * W * S,
                     f"6*N*tokens (N {n_flop / 1e9:.4f} B"
                     + (", the shared block once an application" if hybrid
                        else "")
                     + "; the SSD's intra-chunk products are not in 6N)",
                     ssm_train_reckoning(cfg, n_params, S))
    n_b1, n_b2 = report_profiled_step(
        torch, tag, card,
        lambda: setup.step_fn(params, opt_state, batch(4), gen),
        (("scan", "scan"), ("Scan", "scan")))
    print(f"[{tag}] (a) the counter's launches a step: B1 {n_leaves}, B2 "
          f"{W * G}; the trace held {n_b1} and {n_b2}")

    # -- the split of a step, and (b) the robustness contract ------------------
    split_and_robustness(
        torch, cfg, params, opt, opt_state, est, gen, batch(5), n_byz, tag,
        card, apart=[".".join(k) for k, _ in paths(params)
                     if k[0] not in ("embed", "norm_f")])

    # -- (c) inloop: the whole global batch in one forward ---------------------
    inloop = make_train_step(cfg, W, estimator=est, mode="inloop",
                             optimizer=opt, device=dev)
    in_losses, in_walls, in_counts, in_peak = inloop_steps(
        torch, inloop, params, opt_state,
        [batch(10 + i, INLOOP_SEQ) for i in range(2)])
    # the tied unembedding once a loss chunk; an application's q, k, v, o,
    # gate, up and down. The mamba projections and the shared block's
    # in_proj are plain products (as in repro), off the wire
    n_dots = 7 * G + -(-INLOOP_SEQ // cfg.loss_chunk)
    require(in_counts["aggregate"] == 2 * n_dots
            and in_counts["flash_attention"] == 2 * G,
            f"inloop steps launched {in_counts}; expected B1 {2 * n_dots}, "
            f"B2 {2 * G}")
    n_wire = params["embed"].numel() + (
        M.param_count(params["shared"]["attn"])
        + M.param_count(params["shared"]["mlp"]) if hybrid else 0)
    print(f"[{tag}] (c) inloop at {W} x {INLOOP_SEQ} tokens, {n_dots} "
          f"products a step on the wire: losses "
          f"{[round(x, 5) for x in in_losses]}, steps "
          f"{[round(w, 4) for w in in_walls]} s (median "
          f"{statistics.median(in_walls):.4f}), peak memory {in_peak:.2f} "
          f"GB; launches {json.dumps(in_counts)}; the wire covers "
          f"{n_wire / 1e9:.4f} B of {n_params / 1e9:.4f} B params "
          f"({100 * n_wire / n_params:.2f} %: the tied embedding"
          + (", the shared block's q, k, v, o, gate, up and down" if hybrid
             else "") + "; the mamba projections take the plain batch "
          f"gradient, as in repro) ({card})")
    del params, opt_state
    torch.cuda.empty_cache()
    t_d = time.perf_counter()

    # -- (d) the kernels at the training shapes --------------------------------
    flush = make_flush(torch, dev)
    g = torch.Generator(device=dev).manual_seed(150 + seed)
    # the in_proj_z stack: zamba2's groups (its tail is a leaf apart)
    stacked = "mamba_g" if hybrid else "layers"
    C = (G * cfg.hybrid_attn_every if hybrid else L) * D * d_inner
    recs = [b1_stack_record(
        torch, flush, g, C,
        f"B1 aggregate on {name}'s gradient stacks (vrmom K={TRAIN_K}, "
        f"bf16; timed at {stacked}.ssm.in_proj_z [{W},{C}], {L} layers)",
        counts["aggregate"])]
    if hybrid:
        H, dh = cfg.n_heads, cfg.head_dim
        recs.append(b1_record(
            torch, flush, f"B1 aggregate in {name}'s inloop backward (the "
            f"shared block's wq dW, vrmom K={TRAIN_K}, [{W},{D}*{H * dh}] "
            f"f32)", torch.randn((W, D * H * dh), generator=g, device=dev),
            TRAIN_K, in_counts["aggregate"]))
        q, k, v = (torch.randn((1, S, H, dh), generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        shape = f"q/k/v [1,{S},{H},{dh}] bf16 causal (G 1)"
        rec = attn_record(
            torch, flush, f"B2 flash_attention forward, {name} training's "
            f"shared block ({shape})", q, k, v, decode=False)
        rec["launches"] = counts["flash_attention"]
        recs.append(rec)
        recs.append(b2_autograd_record(
            torch, flush, g,
            f"B2 under autograd, {name} training's shared block "
            f"(FlashAttentionFn: B2 forward + the mha recompute backward; "
            f"max_abs_err is the recompute's gradient against the plain "
            f"path's, launches are the stacked steps' B2 forwards), {shape}; "
            f"library: SDPA forward + backward", q, k, v, causal=True,
            chunk=cfg.attn_chunk, launches=counts["flash_attention"]))
        del q, k, v
    else:
        recs.append(b1_record(
            torch, flush, f"B1 aggregate in {name}'s inloop backward (the "
            f"tied unembedding's dW, vrmom K={TRAIN_K}, [{W},{D}*{V}] f32)",
            torch.randn((W, D * V), generator=g, device=dev), TRAIN_K,
            in_counts["aggregate"]))
    print_train_records(tag, card, recs)
    torch.cuda.empty_cache()
    print(f"[time] phase 15 {name}: (a)-(c) {t_d - t_model:.1f} s, (d) "
          f"{time.perf_counter() - t_d:.1f} s")
    return recs


def phase_train_ssm(torch, dev, card: str):
    """Phase 15: Byzantine-robust training of the ssm and hybrid families
    at full width, mamba2-2.7b at SSM_TRAIN_LAYERS of its 64 layers and
    zamba2-7b at HYBRID_TRAIN_LAYERS of its 81, one after the other.
    Returns the ``kernels`` records with the launches of their main
    paths."""
    torch.cuda.empty_cache()
    return (train_ssm_model(torch, dev, card, "mamba2-2.7b",
                            SSM_TRAIN_LAYERS, 15)
            + train_ssm_model(torch, dev, card, "zamba2-7b",
                              HYBRID_TRAIN_LAYERS, 16))


def phase_lint(torch, dev, card: str) -> None:
    """Phase 16: the AST rules over the port's tree, the RL2xx audit on the
    card, and RL209's capture check at full width."""
    from repro_torch import kernels as K
    from repro_torch.configs import get as get_arch
    from repro_torch.lint import (AUDIT_CHECKS, Report, default_paths,
                                  iter_py_files, lint_paths)
    from repro_torch.lint.auditor import engine_capture_stability, run_audit
    from repro_torch.models import model as M
    from repro_torch.serve import RobustDecodeConfig, Sampling, ServeEngine

    t = time.perf_counter()
    paths = default_paths(str(ROOT))
    findings = lint_paths(paths, str(ROOT))
    report = Report(findings=findings, audit=[])
    waived = [f for f in findings if f.waived]
    print(f"[lint] (a) AST rules over {len(iter_py_files(paths, str(ROOT)))}"
          f" files: {len(report.errors)} errors, {len(waived)} waived "
          f"({time.perf_counter() - t:.2f} s)")
    require(not report.errors, "lint errors:\n" + "\n".join(
        f.render() for f in report.errors))
    require(all(f.waive_reason for f in waived), "a waiver with no reason")
    print(f"[time] phase 16 (a) {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    K.reset_launch_counts()
    results = run_audit(dev)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for r in results:
        print(f"[lint] (b) {r.render()}")
    fails = [r.render() for r in results if r.status == "fail"]
    require(not fails, "audit failures:\n" + "\n".join(fails))
    skipped = sorted({r.check_id for r in results if r.status == "skip"})
    require(skipped == ["RL201"], f"audit skips {skipped}, not RL201 only")
    missing = {c.id for c in AUDIT_CHECKS} - {r.check_id for r in results}
    require(not missing, f"audit checks that reported nothing: {missing}")
    print(f"[lint] (b) launches by the wrappers' counters: B1 "
          f"{counts['aggregate']}, B4 {counts['aggregate_sample']}, B2 "
          f"{counts['flash_attention']}, B3 {counts['decode_attention']}")
    print(f"[time] phase 16 (b) {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    cfg = get_arch("qwen3-1.7b")
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    tokens = torch.randint(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    eng = ServeEngine(cfg, params, max_len=PROMPT_LEN + LINT_NEW_TOKENS,
                      robust=RobustDecodeConfig(m=8, estimator="vrmom", K=8),
                      device=dev)
    detail, first = engine_capture_stability(
        eng, {"tokens": tokens}, n_tokens=LINT_NEW_TOKENS,
        sampling=Sampling("greedy"), pool=False)
    require(tuple(first.shape) == (N_PROMPTS, LINT_NEW_TOKENS),
            f"tokens {tuple(first.shape)}")
    require(bool(((first >= 0) & (first < cfg.vocab)).all()),
            "tokens outside the vocabulary")
    print(f"[lint] (c) {cfg.name} at full width ({cfg.n_layers} layers), "
          f"robust m 8 VRMOM K 8, {N_PROMPTS} x {PROMPT_LEN} tokens + "
          f"{LINT_NEW_TOKENS} new: {detail}; the third generate's tokens "
          f"equal the first's; capture "
          f"{next(iter(eng.graphs.values())).capture_s * 1e3:.1f} ms")
    del eng, params
    torch.cuda.empty_cache()
    print(f"[time] phase 16 (c) {time.perf_counter() - t:.1f} s [card] "
          f"{card}")


LAUNCH_SEED = 17


def launch_parts(meta, card) -> dict:
    """{op: (meta [calls, flops, bytes], card [...])} of the ops whose
    counts part between two ``OpCost``s."""
    return {op: (meta.by_op.get(op), card.by_op.get(op))
            for op in sorted(set(meta.by_op) | set(card.by_op))
            if meta.by_op.get(op) != card.by_op.get(op)}


def phase_launch(torch, dev, card: str):
    """Phase 17: ``launch.op_cost`` / ``launch.dryrun`` on the meta device
    held against the same calls on the card. Returns the ``kernels``
    records of the phase with the launches of its card run."""
    from repro_torch import kernels as K
    from repro_torch import optim as O
    from repro_torch.configs import InputShape, get as get_arch, input_specs
    from repro_torch.core.estimator import Estimator
    from repro_torch.data import lm_batch
    # the package's names are the wrappers: the modules by their paths
    DA = importlib.import_module("repro_torch.kernels.decode_attention")
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    VR = importlib.import_module("repro_torch.kernels.vrmom")
    from repro_torch.launch import dryrun, report
    from repro_torch.launch.op_cost import counting, tensor_bytes
    from repro_torch.models import model as M
    from repro_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    t = t_phase = time.perf_counter()
    cfg = get_arch("qwen3-1.7b")
    W, S, B = TRAIN_W, TRAIN_SEQ, N_PROMPTS
    opt = O.get("adamw", lr=TRAIN_LR)

    def main_path(params, tokens, batch, opt_state, reckon=False):
        """The three counted calls on ``params``' device -> {name: OpCost},
        and the prefill's outputs."""
        setup = make_train_step(cfg, W, mode="stacked-rrs", optimizer=opt,
                                device=tokens.device)
        res = {}
        with counting("cuda") as res["prefill"]:
            logits, caches = M.prefill(params, cfg, {"tokens": tokens},
                                       cache_len=MAX_LEN, last_only=True)
        tok = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        with counting("cuda") as res["decode"]:
            M.decode_step(params, cfg, caches, tok)
        with counting("cuda", reckon=reckon) as res["train"]:
            setup.step_fn(params, opt_state, batch)
        return res, setup, (logits, caches, tok)

    # -- (a) the meta count --------------------------------------------------
    pm = M.init(cfg, torch.Generator(), device="meta")
    st_m = opt.init(pm)
    batch_m = input_specs(cfg, InputShape("phase 7", S, W, "train"))
    toks_m = torch.empty((B, PROMPT_LEN), dtype=torch.int32, device="meta")
    meta, _, _ = main_path(pm, toks_m, batch_m, st_m)
    t_whole = time.perf_counter() - t
    t1 = time.perf_counter()
    setup_m = make_train_step(cfg, W, mode="stacked-rrs", optimizer=opt,
                              device="meta")
    with counting("cuda", reckon=True) as reck:
        setup_m.step_fn(pm, st_m, batch_m)
    t_reck = time.perf_counter() - t1
    whole = meta["train"]
    require((whole.cost.flops, whole.cost.bytes, whole.peak,
             whole.kernels) == (reck.cost.flops, reck.cost.bytes, reck.peak,
                                reck.kernels),
            f"the trip-count reckoning parts from the whole trace: "
            f"{launch_parts(whole, reck)}, peaks {whole.peak} (at "
            f"{whole.peak_op}) and {reck.peak} (at {reck.peak_op}), "
            f"kernels {whole.kernels} and {reck.kernels}")
    args_m = tensor_bytes((pm, st_m, batch_m))
    meta_peak = args_m + whole.peak
    # phase 7's step: stacked-auto, signflip on int(0.25 * 7) = 1 row
    p7 = make_train_step(cfg, W, estimator=Estimator("vrmom", K=TRAIN_K),
                         mode="stacked-auto", optimizer=opt,
                         byzantine_frac=TRAIN_ALPHA, attack="signflip",
                         device="meta")
    with counting("cuda", reckon=True) as oc7:
        p7.step_fn(pm, st_m, batch_m)
    print(f"[launch] (a) phase 7's step (stacked-auto, signflip on 1 row) "
          f"on meta: peak {(args_m + oc7.peak) / 1e9:.3f} GB (at "
          f"{oc7.peak_op}), {(oc7.peak - whole.peak) / 1e9:+.3f} GB over "
          f"the clean stacked-rrs step")
    want = {"prefill": {"flash_attention": cfg.n_layers},
            "decode": {"decode_attention": cfg.n_layers},
            "train": {"aggregate": 13, "flash_attention":
                      W * cfg.n_layers * (2 if cfg.remat else 1)}}
    for name, oc in meta.items():
        calls = {k: v["calls"] for k, v in oc.kernels.items()}
        require(calls == want[name], f"meta {name}: kernel calls {calls}, "
                f"expected {want[name]}")
        print(f"[launch] (a) meta {name}: {oc.cost.flops:.6e} FLOPs, "
              f"{oc.cost.bytes:.6e} bytes, peak {oc.peak / 1e9:.3f} GB "
              f"above the arguments (at {oc.peak_op}), kernels {calls}")
    print(f"[launch] (a) the train step traced whole in {t_whole:.1f} s "
          f"(the three calls) and by trip count in {t_reck:.1f} s: equal "
          f"FLOPs, bytes, peak and kernel calls; meta peak "
          f"{meta_peak / 1e9:.3f} GB = arguments {args_m / 1e9:.3f} "
          f"(params, AdamW m and v, batch) + {whole.peak / 1e9:.3f} (at "
          f"{whole.peak_op})")
    print(f"[time] phase 17 (a) {time.perf_counter() - t:.1f} s")

    # -- (b) the same calls on the card, counted ------------------------------
    t = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(
        LAUNCH_SEED), device=dev)
    opt_state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT_LEN), generator=torch
                           .Generator(device=dev).manual_seed(LAUNCH_SEED),
                           device=dev, dtype=torch.int32)
    batch = lm_batch(cfg, LAUNCH_SEED, W, S, device=dev)
    # warm-up: libraries loaded, B3's split scratch made for this shape
    _, caches = M.prefill(params, cfg, {"tokens": tokens}, cache_len=MAX_LEN,
                          last_only=True)
    M.decode_step(params, cfg, caches, torch.zeros(
        (B,), dtype=torch.int32, device=dev))
    del caches
    torch.cuda.synchronize()
    K.reset_launch_counts()
    cardc, setup, (logits, caches, tok) = main_path(params, tokens, batch,
                                                    opt_state)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    kernel_calls = {}
    for oc in meta.values():
        for k, v in oc.kernels.items():
            kernel_calls[k] = kernel_calls.get(k, 0) + v["calls"]
    require({k: n for k, n in launches.items() if n} == kernel_calls,
            f"the card's launch counters {launches} against the meta "
            f"count's kernel calls {kernel_calls}")
    for name in meta:
        m, c = meta[name], cardc[name]
        parts = launch_parts(m, c)
        # op by op: a branch on the device (an item assignment dispatches
        # fill_ on the card and scalar_tensor + copy_ on meta) shows here
        require(not parts, f"{name}: the card's count parts from the meta "
                           f"count at {parts}")
        print(f"[launch] (b) card {name}: FLOPs {c.cost.flops:.6e} and "
              f"bytes {c.cost.bytes:.6e} equal the meta count's, op by op; "
              f"kernels {({k: v['calls'] for k, v in c.kernels.items()})}")

    # untraced walls against the roofline bounds
    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {
        "prefill": wall(lambda: M.prefill(params, cfg, {"tokens": tokens},
                                          cache_len=MAX_LEN,
                                          last_only=True)),
        "decode": wall(lambda: M.decode_step(params, cfg, caches, tok)),
    }
    del logits, caches
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls["train"] = wall(lambda: setup.step_fn(params, opt_state, batch))
    args_c = tensor_bytes((params, opt_state, batch))
    card_peak = torch.cuda.max_memory_allocated() - base + args_c
    for name, oc in meta.items():
        b_ms, b_by = bound(oc.cost.bytes, oc.cost.flops)
        print(f"[launch] (b) {name}: wall {walls[name] * 1e3:.3f} ms "
              f"untraced, roofline bound {b_ms:.3f} ms ({b_by}): "
              f"{100 * b_ms / 1e3 / walls[name]:.2f} % of the bound "
              f"({card})")
    gap = card_peak / meta_peak - 1
    print(f"[launch] (b) train step peak: max_memory_allocated "
          f"{card_peak / 1e9:.3f} GB (the step's arguments "
          f"{args_c / 1e9:.3f} + {(card_peak - args_c) / 1e9:.3f} above "
          f"them) against the meta peak {meta_peak / 1e9:.3f} GB: "
          f"{100 * gap:+.2f} % ({card})")
    require(abs(gap) <= 0.10, f"the step's peak {card_peak} is not within "
                              f"10 % of the meta peak {meta_peak}")
    del params, opt_state, batch, setup
    torch.cuda.empty_cache()
    print(f"[time] phase 17 (b) {time.perf_counter() - t:.1f} s")

    # -- (c) the dry run of every arch at decode_32k --------------------------
    t = time.perf_counter()
    res = {}
    for arch in report.ORDER_ARCHS:
        r = dryrun.dryrun_one(arch, "decode_32k", verbose=False)
        require(r["flops_per_chip"] > 0 and r["hbm_bytes_per_chip"] > 0
                and math.isfinite(r["compute_s"] + r["memory_s"]),
                f"dryrun {arch}: {r}")
        res[(arch, "decode_32k", dryrun.MESH)] = r
        print(f"[launch] (c) {arch} x decode_32k: {r['flops_per_chip']:.4e} "
              f"FLOPs, {r['hbm_bytes_per_chip']:.4e} bytes, peak "
              f"{r['peak_memory_bytes'] / 1e9:.1f} GB, {r['bottleneck']}, "
              f"kernels {r['kernels']}, counted in {r['host_s']:.2f} s")
    table = report.roofline_table(res, dryrun.MESH)
    for line in table.splitlines():
        if "decode_32k" in line or line.startswith("| arch") or "---" in line:
            print(f"[launch] (c) {line}")
    print(f"[time] phase 17 (c) {time.perf_counter() - t:.1f} s")

    # -- (e) one rank of repro's 16x16 worker axes; phase 18's wire call -----
    t = time.perf_counter()
    r = dryrun.dryrun_one(cfg.name, "train_4k", mesh=dryrun.MESHES["16x16"],
                          verbose=False)
    P, n = r["chips"], M.param_count(pm)
    c = -(-n // P)
    # the RRS wire: the padded raveled f32 gradient out, the rank's slice
    # back; and the losses' gather, one f32 a rank
    want = {"all-to-all": P * c * 4, "all-gather": c * 4 + 4}
    require(r["collectives"] == want and r["mesh"] == "16xH100",
            f"the 16-rank dry run's collectives {r['collectives']}, "
            f"expected {want}")
    print(f"[launch] (e) {cfg.name} x train_4k on one of {P} worker ranks "
          f"({r['mesh']}; repro's 16x16, the model axis not sharded), a "
          f"fake process group on meta: collectives {r['collectives']} "
          f"bytes a rank ({r['collective_bytes_per_chip']:.6e} in all); "
          f"roofline compute {r['compute_s']:.4f} s, memory "
          f"{r['memory_s']:.4f} s, collective {r['collective_s']:.6f} s "
          f"(NVLink {dryrun.H100_NVLINK_BW / 1e9:.0f} GB/s) -> "
          f"{r['bottleneck']}; peak {r['peak_memory_bytes'] / 1e9:.3f} GB; "
          f"kernels {r['kernels']}; counted in {r['host_s']:.2f} s")
    print(f"[launch] (e) phase 18's counted wire call ({'/'.join(CONS_LEAF)}"
          f" of {cfg.name} at {WIRE_LAYERS} layers, one worker a rank) on "
          f"meta under a fake group of {WIRE_W}: {wire_meta_count()} bytes "
          f"a rank")
    print(f"[time] phase 17 (e) {time.perf_counter() - t:.1f} s")

    # -- (d) the kernels at phase 17's shapes, bounds from kernels/*.cost -----
    flush = make_flush(torch, dev)
    g = torch.Generator(device=dev).manual_seed(LAUNCH_SEED)
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    def with_bound(rec, cost):
        rec["bound_ms"], rec["bound_by"] = bound(cost[1], cost[0])
        return rec

    q, k, v = randn(1, S, H, dh), randn(1, S, Hkv, dh), randn(1, S, Hkv, dh)
    rec_b2 = with_bound(attn_record(
        torch, flush, f"B2 flash_attention under launch.op_cost (q "
        f"[1,{S},{H},{dh}] bf16 causal; launches: phase 17's card prefill "
        f"and train step)", q, k, v, decode=False),
        FA.cost(q.shape, k.shape, q.dtype, causal=True))
    rec_b2["launches"] = launches["flash_attention"]
    q, k, v = randn(B, 1, H, dh), randn(B, MAX_LEN, Hkv, dh), randn(
        B, MAX_LEN, Hkv, dh)
    rec_b3 = with_bound(attn_record(
        torch, flush, f"B3 decode_attention under launch.op_cost (q "
        f"[{B},1,{H},{dh}] over [{B},{MAX_LEN},{Hkv},{dh}] bf16; launches: "
        f"phase 17's card decode step)", q, k, v, decode=True),
        DA.cost(q.shape, k.shape, q.dtype, k.dtype, MAX_LEN))
    rec_b3["launches"] = launches["decode_attention"]
    C = cfg.n_layers * cfg.d_model * Hkv * dh   # layers.attn.wk
    rec_b1 = b1_stack_record(
        torch, flush, g, C, f"B1 aggregate under launch.op_cost (vrmom "
        f"K={TRAIN_K}, bf16; timed at layers.attn.wk [{W},{C}]; launches: "
        f"phase 17's card train step, one a leaf)", launches["aggregate"])
    with_bound(rec_b1, VR.aggregate_cost((W, C), torch.bfloat16))
    del q, k, v
    recs = [rec_b1, rec_b2, rec_b3]
    print_train_records("launch", card, recs)
    print(f"[launch] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return recs


# phase 18, the RRS wire over ranks: WIRE_W ranks on the one card, each
# one worker of one TRAIN_SEQ-token sample, joined in a gloo group through
# a FileStore; qwen3-1.7b at full width, cut in depth so that the four
# ranks fit the card together (~28 B a param a rank: bf16 params and
# grads, f32 AdamW moments, the f32 wire and its all_to_all and all_gather
# buffers; 0.41 B params at 2 of 28 layers, ~46 GB for four before
# activations); signflip on the last rank's worker (int(0.34 * 3) = 1)
WIRE_W, WIRE_LAYERS, WIRE_SEED, WIRE_ALPHA = 4, 2, 18, 0.34
WIRE_TIMEOUT_S = 600
# (g)'s consensus run: one stale straggler, f = 0 (4 peers allow no more:
# n > 5f), on one leaf of (a)'s gradient (one WIRE_CHUNK block)
CONS_LEAF = ("layers", "attn", "wk")
CONS_STALE = dict(n_stragglers=1, stale_rounds=1)
# (h): PAPER_LINREG's gaussian alpha 0.1 cell at phase 4's settings over
# the ranks, each rank's replications in one chunk; its coverage gate: 4
# binomial standard errors over 2,500 CIs (500 replications of 30
# coordinates give 15,000, correlated within a replication)
CELL_ESTIMATORS, CELL_SE_CIS = ("vrmom", "median"), 2500
# the leaves whose every use is a 3-D x 2-D product (robust_dot under
# inloop): (e) sums every other leaf over the ranks, the tied embedding
# included (its lookup half)
WIRE_PRODUCTS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_gate",
                 "mlp/w_up", "mlp/w_down")
# the ranks fork from a server that has imported these once (no CUDA
# there): spawning each rank's interpreter anew costs ~19 s of the phase
# (torch._dynamo and sympy come in lazily with the first checkpointed
# backward: ~800 modules, seconds a rank)
WIRE_PRELOAD = ("__main__", "torch", "torch.distributed", "torch._dynamo",
                "repro_torch.train.step", "repro_torch.dist.robust_reduce",
                "repro_torch.lint.auditor")


def _tree_sha(torch, trees, threads: int = 4):
    """{leaf path: SHA-256 of its bytes} of a tree (or a list of them), the
    leaves hashed in threads (hashlib lets go of the GIL on large
    buffers)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.tree import paths

    many = isinstance(trees, list)
    flat = [[("/".join(p), t.detach().contiguous().view(torch.uint8).cpu())
             for p, t in paths(tree)] for tree in (trees if many else [trees])]

    def one(t):
        import hashlib

        return hashlib.sha256(t.numpy()).hexdigest()

    with ThreadPoolExecutor(threads) as ex:
        out = [dict(zip([k for k, _ in f], ex.map(one, [t for _, t in f])))
               for f in flat]
    return out if many else out[0]


# odd 64-bit multipliers of _fingerprint (two's complement in int64)
_FP_MUL, _FP_ADD = -0x61C8864680B583EB, 0x632BE59BD9B4E019


def _fingerprint(torch, tree) -> dict:
    """{leaf path: a 64-bit digest of its bits}, computed on the tensors'
    device: the sum over elements of (bits + 1) * w(i) mod 2^64, w(i) odd
    and different for every index i, so any one element that differs
    changes it. Cheap next to a host hash of 0.8 GB; used where two runs
    must agree after each step, with SHA-256 kept for the gradients and
    aggregates of (a)."""
    from repro_torch.tree import paths

    out = {}
    for p, t in paths(tree):
        x = t.detach().contiguous().view(-1)
        bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
        mask = (1 << 8 * x.element_size()) - 1
        h = torch.zeros((), dtype=torch.int64, device=x.device)
        for a in range(0, x.numel(), 1 << 24):
            b = x[a:a + (1 << 24)].view(bits).to(torch.int64) & mask
            i = torch.arange(a, a + b.numel(), dtype=torch.int64,
                             device=x.device)
            h += torch.sum((b + 1) * ((i * _FP_MUL + _FP_ADD) | 1))
        out["/".join(p)] = int(h)
    return out


def gloo_moved(prof) -> dict:
    """{``gloo:`` event name: elements of its recorded input shapes} of a
    profiler trace taken with ``record_shapes``: what each collective took
    from this rank."""
    moved = {}
    for e in prof.events():
        if e.name.startswith("gloo:"):
            moved[e.name] = moved.get(e.name, 0) + sum(
                math.prod(sh) for sh in e.input_shapes if sh)
    return moved


def wire_meta_count() -> dict:
    """{kind: operand bytes} of phase 18's counted wire call, one
    ``aggregate_stacked_rrs`` of a rank's one-worker ``CONS_LEAF`` stack,
    counted on meta under a fake process group of WIRE_W ranks (this
    process must hold no default group)."""
    import torch

    from repro_torch.configs import get as get_arch
    from repro_torch.core.estimator import Estimator
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.launch.op_cost import counting, fake_group
    from repro_torch.models import model as M
    from repro_torch.tree import at

    cfg = at_depth(get_arch("qwen3-1.7b"), WIRE_LAYERS)
    leaf = at(M.init(cfg, torch.Generator(), device="meta"), CONS_LEAF)
    stack = {CONS_LEAF[-1]: torch.empty((1,) + tuple(leaf.shape),
                                        dtype=leaf.dtype, device="meta")}
    with fake_group(WIRE_W) as g, counting("cuda") as oc:
        RR.aggregate_stacked_rrs(stack, g, Estimator("vrmom", K=TRAIN_K))
    return dict(oc.cost.coll)


def wire_cell_kw(estimator: str) -> dict:
    """(h)'s cell: phase 4's PAPER_LINREG gaussian alpha 0.1 cell, a
    rank's replications in one chunk."""
    from repro_torch.configs.paper_glm import PAPER_LINREG

    kw = paper_kw(PAPER_LINREG, attack="gaussian", alpha=0.1,
                  estimator=estimator)
    kw["batch_size"] = kw["reps"] // WIRE_W
    return kw


def wire_setup(torch, dev):
    """Phase 18's model, estimator and batches, the same in every rank and
    in the parent: (cfg, params, est, batch(i))."""
    from repro_torch.configs import get as get_arch
    from repro_torch.core.estimator import Estimator
    from repro_torch.data import lm_batch
    from repro_torch.models import model as M

    cfg = at_depth(get_arch("qwen3-1.7b"), WIRE_LAYERS)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(WIRE_SEED),
                    device=dev)
    est = Estimator("vrmom", K=TRAIN_K)

    def batch(i, seq=TRAIN_SEQ):
        return lm_batch(cfg, i, WIRE_W, seq, device=dev)

    return cfg, params, est, batch


def wire_dot_rows(torch, dev):
    """(c)'s product: x, dy [WIRE_W, TRAIN_SEQ, D] f32 and w [D, H dh] f32
    at qwen3's ``wq`` width, seeded alike everywhere."""
    g = torch.Generator(device=dev).manual_seed(WIRE_SEED + 1)
    D = 2048
    x = torch.randn((WIRE_W, TRAIN_SEQ, D), generator=g, device=dev)
    dy = torch.randn((WIRE_W, TRAIN_SEQ, D), generator=g, device=dev)
    w = torch.randn((D, D), generator=g, device=dev) / D ** 0.5
    return x, dy, w


def wire_train_setup(cfg, est, dev, group, mode="stacked-rrs"):
    from repro_torch import optim as O
    from repro_torch.train.step import make_train_step

    opt = O.get("adamw", lr=TRAIN_LR)
    return opt, make_train_step(cfg, WIRE_W, estimator=est,
                                mode=mode, optimizer=opt,
                                byzantine_frac=WIRE_ALPHA, attack="signflip",
                                device=dev, group=group)


def wire_rank(rank: int, world: int, tmp: str, t_start: float) -> None:
    """One rank of phase 18 (started by ``torch.multiprocessing``): the
    library built in phase 1 is loaded, never built; results go to
    ``rank<r>.json`` in ``tmp``, rank 0's tensors to ``.pt`` files there.
    A failure raises, and the parent's join raises with it."""
    import datetime
    import os

    t_entry = time.time()
    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.kernels import build
    from repro_torch.launch.op_cost import counting
    from repro_torch.lint.auditor import _check_rrs_wire
    from repro_torch.train.step import worker_grads
    from repro_torch.tree import at

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in build.SOURCES:
        require(build.library_path(name).exists(),
                f"rank {rank}: {name} is not built (phase 1 builds it)")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(
            seconds=WIRE_TIMEOUT_S))
    G = dist.group.WORLD
    out = {"rank": rank, "t": {"start": t_entry - t_start,
                               "join the group": time.time() - t_entry}}
    t_rank = t_mark = time.perf_counter()

    def mark(what):
        nonlocal t_mark
        now = time.perf_counter()
        out["t"][what] = out["t"].get(what, 0.0) + now - t_mark
        t_mark = now

    def sync_wall(fn):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    # -- (a) one worker's gradient down the wire ------------------------------
    cfg, params, est, batch = wire_setup(torch, dev)
    b = {k: v[rank:rank + 1] for k, v in batch(0).items()}
    mark("set-up")
    losses, stack = worker_grads(cfg, params, b, 1)
    out["loss_a"] = float(losses[0])
    mark("first gradient")
    out["grad_sha"] = _tree_sha(torch, stack)
    mark("hashes")
    K.reset_launch_counts()   # ---- the main path: counts from 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        agg, out["wire_s"] = sync_wall(lambda: RR.aggregate_stacked_rrs(
            stack, G, est))
    out["launches_a"] = K.launch_counts()
    mark("(a) wire")
    # the wire's parts: its spans' host walls (the collectives block the
    # host; B1's launch returns at once and the all_gather's copy to the
    # host waits for it)
    out["spans_s"] = {e.key: e.cpu_time_total / 1e6
                      for e in prof.key_averages()
                      if e.key.startswith("rrs.")}
    out["agg_sha"] = _tree_sha(torch, agg)
    mark("hashes")
    if rank == 0:
        torch.save({k: v.cpu() for k, v in _flat(agg).items()},
                   os.path.join(tmp, "agg.pt"))
    n = sum(t[0].numel() for t in _flat(stack).values())
    out["slice"] = [world, -(-n // world)]
    del agg            # (a)'s gradient stays for (f) and (g)
    mark("saves")

    # -- the counted wire call: (a)'s CONS_LEAF under op_cost.counting -------
    K.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        with counting("cuda") as oc:
            RR.aggregate_stacked_rrs({CONS_LEAF[-1]: at(stack, CONS_LEAF)},
                                     G, est)
        torch.cuda.synchronize()
    out["counted"] = dict(coll=dict(oc.cost.coll), moved=gloo_moved(prof),
                          launches=K.launch_counts())
    del prof, oc
    mark("the counted wire call")

    # -- (b) two stacked-rrs steps over the group -----------------------------
    opt, setup = wire_train_setup(cfg, est, dev, G)
    opt_state = opt.init(params)
    out["steps"] = []
    mark("set-up")
    for i in (1, 2):
        K.reset_launch_counts()
        (params, opt_state, loss), wall = sync_wall(
            lambda: setup.step_fn(params, opt_state, batch(i)))
        launches = K.launch_counts()
        mark("(b) steps")
        fp = _fingerprint(torch, params)
        fps = [None] * world
        dist.all_gather_object(fps, fp)
        out["steps"].append(dict(loss=float(loss), wall_s=wall,
                                 launches=launches, fp=fp,
                                 same_on_every_rank=all(f == fp
                                                        for f in fps)))
        mark("hashes")
    if rank == 0:   # the last step's params, for the largest difference
        torch.save({k: v.cpu() for k, v in _flat(params).items()},
                   os.path.join(tmp, "params.pt"))
    del params, opt_state, setup
    mark("saves")

    # -- (c) one robust_dot product at wq's width -----------------------------
    x, dy, w0 = wire_dot_rows(torch, dev)
    w = w0.clone().requires_grad_(True)
    K.reset_launch_counts()

    def dot():
        with RR.robust_backward(WIRE_W, est, G):
            y = RR.robust_dot(x[rank:rank + 1], w)
        y.backward(dy[rank:rank + 1])

    _, out["dot_s"] = sync_wall(dot)
    out["launches_c"] = K.launch_counts()
    if rank == 0:
        torch.save(w.grad.cpu(), os.path.join(tmp, "dw.pt"))
    else:
        require(not bool(torch.any(w.grad)), "a rank but 0 carried dW")
    del x, dy, w0, w
    mark("(c) robust_dot")

    # -- (d) RL201 ------------------------------------------------------------
    (r,) = _check_rrs_wire(dev)
    out["rl201"] = [r.status, r.detail]
    mark("(d) RL201")

    # -- (e) one inloop step over the group ------------------------------------
    cfg, params, est, batch = wire_setup(torch, dev)
    opt, setup = wire_train_setup(cfg, est, dev, G, mode="inloop")
    opt_state = opt.init(params)
    mark("set-up")
    K.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        (params, opt_state, loss), wall = sync_wall(
            lambda: setup.step_fn(params, opt_state, batch(3, INLOOP_SEQ)))
    launches = K.launch_counts()
    mark("(e) inloop step")
    moved = gloo_moved(prof)  # elements a collective took on this rank
    fp = _fingerprint(torch, params)
    fps = [None] * world
    dist.all_gather_object(fps, fp)
    flat = _flat(params)
    out["inloop"] = dict(
        loss=float(loss), wall_s=wall, launches=launches, moved=moved,
        spans_s={e.key: e.cpu_time_total / 1e6
                 for e in prof.key_averages()
                 if e.key.startswith(("rrs.", "train."))},
        off_wire=sum(t.numel() for k, t in flat.items()
                     if not k.endswith(WIRE_PRODUCTS)),
        products=sum(t.numel() for k, t in flat.items()
                     if k.endswith(WIRE_PRODUCTS)),
        same_on_every_rank=all(f == fp for f in fps))
    del params, opt_state, setup, flat, prof
    mark("hashes")

    # -- (f) and (g): the consensus wire over the ranks -----------------------
    out.update(wire_consensus(torch, rank, world, tmp, stack, est, G,
                              sync_wall))
    del stack
    mark("(f) (g) consensus")

    # -- (h) the paper's cells over the ranks, (a)'s gradient freed ----------
    torch.cuda.empty_cache()
    out["cells"] = wire_cells(torch, rank, world, G, dev, sync_wall)
    mark("(h) coverage cells")

    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["rank_s"] = time.perf_counter() - t_rank
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def wire_consensus(torch, rank: int, world: int, tmp: str, stack, est, G,
                   sync_wall) -> dict:
    """Phase 18's (f) and (g) on one rank: (a)'s worker gradient down the
    consensus wire fault-free (f = 0, trivial plan, no pins: one
    ``all_gather`` and one B1 a block), and its ``CONS_LEAF`` with one
    stale straggler; the ``all_gather`` calls counted at
    ``robust_reduce.all_gather_into``, B1 by the wrappers' counter. Rank 0
    saves (g)'s aggregate."""
    import os

    from repro_torch import kernels as K
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.dist.consensus import (ConsensusConfig,
                                            aggregate_stacked_consensus)
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.tree import at

    calls, real = [], RR.all_gather_into

    def counting(o, x, group):
        calls.append(x.numel())
        return real(o, x, group)

    def aux_values(aux):
        return [getattr(aux, f).tolist() for f in aux._fields]

    out = {}
    cfg = ConsensusConfig(f=0)
    RR.all_gather_into = counting
    try:
        K.reset_launch_counts()   # ---- (f), the main path: counts from 0
        (agg, aux), wall = sync_wall(lambda: aggregate_stacked_consensus(
            stack, G, est, config=cfg))
        out["cons_f"] = dict(
            wall_s=wall, launches=K.launch_counts(), gathers=len(calls),
            blocks=-(-sum(t[0].numel() for t in _flat(stack).values())
                     // RR.WIRE_CHUNK),
            sha=_tree_sha(torch, agg), aux=aux_values(aux))
        del agg
        calls.clear()
        leaf = {CONS_LEAF[-1]: at(stack, CONS_LEAF)}
        gen = torch.Generator(device=leaf[CONS_LEAF[-1]].device).manual_seed(
            WIRE_SEED + 3)
        K.reset_launch_counts()   # ---- (g)
        (agg, aux), wall = sync_wall(lambda: aggregate_stacked_consensus(
            leaf, G, est, config=cfg, plan=FaultPlan(**CONS_STALE),
            generator=gen))
        out["cons_g"] = dict(
            wall_s=wall, launches=K.launch_counts(), gathers=len(calls),
            blocks=-(-leaf[CONS_LEAF[-1]][0].numel() // RR.WIRE_CHUNK),
            p_end=cfg.phases(FaultPlan(**CONS_STALE)),
            sha=_tree_sha(torch, agg), aux=aux_values(aux))
    finally:
        RR.all_gather_into = real
    if rank == 0:
        torch.save(agg[CONS_LEAF[-1]].cpu(), os.path.join(tmp, "cons_g.pt"))
    return out


def wire_cells(torch, rank: int, world: int, G, dev, sync_wall) -> dict:
    """Phase 18 (h) on one rank: ``wire_cell_kw``'s cell over the group for
    each of CELL_ESTIMATORS, after a warm-up cell of the rank's size (not
    counted): its synchronised wall, B1's launches (the wrappers' counter),
    summary and SHA-256, and whether every rank's cell is the same. Rank 0
    then re-runs the WIRE_W one-process slices (seeded ``rank_seed``),
    each with B1's launches counted, and records whether their
    concatenation equals the group cell bit for bit and every rank's
    launches."""
    import hashlib

    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.infer import coverage_run
    from repro_torch.infer.coverage import rank_seed

    def sha(cell) -> str:
        return hashlib.sha256(b"".join(
            t.cpu().contiguous().view(torch.uint8).numpy().tobytes()
            for t in cell)).hexdigest()

    def gathered(value) -> list:
        out = [None] * world
        dist.all_gather_object(out, value, group=G)
        return out

    out = {}
    first = wire_cell_kw(CELL_ESTIMATORS[0])
    n = first["reps"] // world
    coverage_run(device=dev, **dict(first, reps=n,
                                    seed=rank_seed(first["seed"], rank)))
    for est in CELL_ESTIMATORS:
        kw = wire_cell_kw(est)
        K.reset_launch_counts()   # ---- the main path: counts from 0
        cell, wall = sync_wall(lambda: coverage_run(group=G, device=dev,
                                                    **kw))
        launches = K.launch_counts()["aggregate"]
        h = sha(cell)
        rec = dict(wall_s=wall, launches=launches, sha=h,
                   summary=cell.summary(),
                   same_on_every_rank=len(set(gathered(h))) == 1,
                   ranks_launches=gathered(launches))
        if rank == 0:
            parts, rec["slice_launches"] = [], []
            for r in range(world):
                K.reset_launch_counts()
                parts.append(coverage_run(device=dev, **dict(
                    kw, reps=n, seed=rank_seed(kw["seed"], r))))
                rec["slice_launches"].append(
                    K.launch_counts()["aggregate"])
            rec["equals_slices"] = all(
                torch.equal(x, torch.cat([p[i] for p in parts]))
                for i, x in enumerate(cell))
            del parts
        out[est] = rec
        del cell
    return out


def _flat(tree) -> dict:
    from repro_torch.tree import paths

    return {"/".join(p): t for p, t in paths(tree)}


def wire_references(torch, dev) -> dict:
    """What phase 18's ranks must equal, computed here in one process:
    the four workers' gradient SHA-256s and ``aggregate_stacked_auto`` of
    their stack (a), the one-process consensus emulation of their
    ``CONS_LEAF`` with one stale straggler (g), the params' SHA-256s after
    each of two one-process stacked-rrs steps, the last params and the
    losses (b), and the one-process ``_RobustDot`` dW (c)."""
    from repro_torch.dist import robust_reduce as RR
    from repro_torch.train.step import worker_grads

    ref = {"t": {}}
    t = time.perf_counter()

    def mark(what):
        nonlocal t
        torch.cuda.synchronize()
        ref["t"][what] = time.perf_counter() - t
        t = time.perf_counter()

    cfg, params, est, batch = wire_setup(torch, dev)
    _, stack = worker_grads(cfg, params, batch(0), WIRE_W)
    mark("gradients")
    ref["grad_sha"] = _tree_sha(torch, [{k: v[w:w + 1] for k, v in
                                         _flat(stack).items()}
                                        for w in range(WIRE_W)], threads=8)
    mark("hashes")
    ref["agg"] = _flat(RR.aggregate_stacked_auto(stack, est))
    mark("aggregate")
    # (g): the one-process consensus emulation on the four workers' leaf,
    # the generator seeded as each rank's
    from repro_torch.dist.consensus import ConsensusConfig
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.tree import at

    leaf = {CONS_LEAF[-1]: at(stack, CONS_LEAF)}
    g_agg, g_aux = RR.aggregate(
        leaf, mode="stacked-consensus", est=est,
        consensus=ConsensusConfig(f=0), plan=FaultPlan(**CONS_STALE),
        generator=torch.Generator(device=dev).manual_seed(WIRE_SEED + 3))
    ref["cons_g"] = g_agg[CONS_LEAF[-1]]
    ref["cons_g_aux"] = [getattr(g_aux, f).tolist() for f in g_aux._fields]
    del stack, leaf, g_agg
    mark("consensus emulation")
    opt, setup = wire_train_setup(cfg, est, dev, None)
    opt_state = opt.init(params)
    ref["fp"], ref["losses"] = [], []
    for i in (1, 2):
        params, opt_state, loss = setup.step_fn(params, opt_state, batch(i))
        ref["fp"].append(_fingerprint(torch, params))
        ref["losses"].append(float(loss))
    ref["params"] = _flat(params)
    del opt_state, setup
    mark("two steps")
    x, dy, w0 = wire_dot_rows(torch, dev)
    w = w0.clone().requires_grad_(True)
    with RR.robust_backward(WIRE_W, est):
        y = RR.robust_dot(x, w)
    y.backward(dy)
    ref["dw"] = w.grad
    mark("robust_dot")
    return ref


def phase_wire(torch, dev, card: str):
    """Phase 18: the RRS wire over WIRE_W ranks on the card, each a worker,
    against the one-process paths, which this process computes while the
    ranks start (the forkserver's imports take one core; once the ranks'
    gloo copies and sockets run, they keep the host's cores busy and work
    beside them slows both). Returns B1's ``kernels`` record at the
    wire's slice."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="wire18-") as tmp:
        return _phase_wire(torch, dev, card, tmp)


def _phase_wire(torch, dev, card: str, tmp: str):
    """Phase 18 with its FileStore, the ranks' results and rank 0's
    tensors (~1.6 GB) in ``tmp``, which the caller removes."""
    import os

    import torch.multiprocessing as mp

    from repro_torch.dist.robust_reduce import WIRE_CHUNK
    from repro_torch.kernels import vrmom as VR
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, params, est, batch = wire_setup(torch, dev)
    n_params = M.param_count(params)
    del params
    print(f"[wire] {cfg.name} at full width, {WIRE_LAYERS} of 28 layers "
          f"({n_params / 1e9:.4f} B params, bf16), {WIRE_W} ranks on one "
          f"card over gloo (FileStore), one worker of one {TRAIN_SEQ}-token "
          f"sample each; VRMOM K {TRAIN_K}, AdamW lr {TRAIN_LR}; reckoned "
          f"~28 B a param a rank = {28 * n_params * WIRE_W / 1e9:.1f} GB "
          f"for the ranks before activations")

    # -- the ranks, and the one-process references meanwhile ------------------
    t = time.perf_counter()
    mp.get_context("forkserver").set_forkserver_preload(list(WIRE_PRELOAD))
    ctx = mp.start_processes(wire_rank, args=(WIRE_W, tmp, time.time()),
                             nprocs=WIRE_W, join=False,
                             start_method="forkserver")
    # start_processes returns once the server has made its imports
    server_s = time.perf_counter() - t
    try:
        ref = wire_references(torch, dev)
        ref_s = time.perf_counter() - t - server_s
        torch.cuda.empty_cache()
        while not ctx.join(timeout=0.5):
            require(time.perf_counter() - t < WIRE_TIMEOUT_S,
                    f"the ranks still ran after {WIRE_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(WIRE_W):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    ranks_s = time.perf_counter() - t
    n_fwd = 2 if cfg.remat else 1
    # (e)'s products: 7 a layer and the tied unembedding once a loss chunk
    n_products = WIRE_LAYERS * len(WIRE_PRODUCTS) + -(-INLOOP_SEQ
                                                       // cfg.loss_chunk)
    for r in ranks:
        sp = r["spans_s"]
        walls = ", ".join("%.3f s" % s["wall_s"] for s in r["steps"])
        losses = ", ".join("%.4f" % s["loss"] for s in r["steps"])
        steps = [(s["launches"]["aggregate"], s["launches"]["flash_attention"])
                 for s in r["steps"]]
        print(f"[wire] rank {r['rank']}: (a) loss {r['loss_a']:.4f}, the "
              f"wire {r['wire_s'] * 1e3:.1f} ms, synchronised; its spans' "
              f"host walls: pack {sp['rrs.pack'] * 1e3:.1f}, all_to_all "
              f"{sp['rrs.all_to_all'] * 1e3:.1f}, estimator (B1's launch) "
              f"{sp['rrs.estimator'] * 1e3:.2f}, all_gather (B1's device "
              f"time inside) {sp['rrs.all_gather'] * 1e3:.1f} ms; B1 "
              f"{r['launches_a']['aggregate']} launch; (b) steps {walls}, "
              f"losses {losses}, B1 and B2 a step {steps}; (c) robust_dot "
              f"{r['dot_s'] * 1e3:.1f} ms; peak {r['peak_gb']:.1f} GB; the "
              f"rank's wall {r['rank_s']:.1f} s: "
              + ", ".join(f"{k} {v:.1f}" for k, v in r["t"].items()))
    print(f"[wire] the ranks took {ranks_s:.1f} s (the forkserver's "
          f"imports {server_s:.1f} s, then the ranks' start, set-up and "
          f"(a)-(d)), the one-process references here {ref_s:.1f} s while "
          f"the ranks started ("
          + ", ".join(f"{k} {v:.1f}" for k, v in ref["t"].items())
          + f"); slice [{ranks[0]['slice'][0]}, {ranks[0]['slice'][1]}] "
          f"f32 a rank")
    for r in ranks:
        require(r["launches_a"]["aggregate"] == 1,
                f"rank {r['rank']}: the wire launched B1 "
                f"{r['launches_a']['aggregate']} times, not once")
        require(r["launches_c"]["aggregate"] == 1,
                f"rank {r['rank']}: robust_dot launched B1 "
                f"{r['launches_c']['aggregate']} times, not once")
        for i, s in enumerate(r["steps"]):
            require(s["launches"]["aggregate"] == 1
                    and s["launches"]["flash_attention"]
                    == WIRE_LAYERS * n_fwd,
                    f"rank {r['rank']} step {i + 1}: launched "
                    f"{s['launches']}; expected B1 1, B2 "
                    f"{WIRE_LAYERS * n_fwd}")
            require(s["same_on_every_rank"],
                    f"step {i + 1}: params differ across the ranks")
            require(math.isfinite(s["loss"]), f"step {i + 1}: loss {s}")
        require(r["rl201"][0] == "ok", f"rank {r['rank']}: RL201 {r['rl201']}")
        e = r["inloop"]
        require(e["launches"]["aggregate"] == n_products
                and e["launches"]["flash_attention"] == WIRE_LAYERS * n_fwd,
                f"rank {r['rank']} (e): launched {e['launches']}; expected "
                f"B1 {n_products} (a product's dW), B2 "
                f"{WIRE_LAYERS * n_fwd}")
        require(e["same_on_every_rank"],
                "(e): params differ across the ranks after the inloop step")
        require(math.isfinite(e["loss"]), f"(e): loss {e['loss']}")
        require(e["moved"].get("gloo:all_reduce", 0) == e["off_wire"],
                f"rank {r['rank']} (e): all_reduce summed "
                f"{e['moved'].get('gloo:all_reduce', 0)} elements; the "
                f"leaves off the wire hold {e['off_wire']}")
        require(r["agg_sha"] == ranks[0]["agg_sha"],
                f"rank {r['rank']}'s aggregate differs from rank 0's")
    print(f"[wire] (d) RL201 ok on every rank: {ranks[0]['rl201'][1]}")
    for r in ranks:
        e = r["inloop"]
        sp = e["spans_s"]
        print(f"[wire] (e) rank {r['rank']}: one inloop step over the group "
              f"(a worker of {INLOOP_SEQ} tokens a rank) "
              f"{e['wall_s']:.3f} s, synchronised, loss {e['loss']:.4f}; B1 "
              f"{e['launches']['aggregate']} (one a product's dW), B2 "
              f"{e['launches']['flash_attention']}; spans' host walls: "
              f"all_to_all {sp.get('rrs.all_to_all', 0.0):.3f}, all_gather "
              f"{sp.get('rrs.all_gather', 0.0):.3f}, the sum over the ranks "
              f"{sp.get('train.sum_over_ranks', 0.0):.3f} s; elements into "
              f"each collective on this rank {e['moved']}")
    e = ranks[0]["inloop"]
    print(f"[wire] (e) params identical on every rank; the all_reduce "
          f"after the backward summed {e['off_wire']} elements, the leaves "
          f"off the wire (norms, the tied embedding), and not the "
          f"{e['products']} of the products whose dW came off the wire")

    # -- (a) against the one-process stacked path -----------------------------
    parted = [(w, k) for w in range(WIRE_W) for k, h in
              ranks[w]["grad_sha"].items() if ref["grad_sha"][w][k] != h]
    require(not parted, f"workers' gradients differ between the ranks and "
                        f"this process: {parted[:6]} (ROADMAP §C)")
    got = torch.load(os.path.join(tmp, "agg.pt"))
    want = ref["agg"]
    diff = max(max_err(got[k].to(dev), want[k]) for k in want)
    require(all(torch.equal(got[k].to(dev), want[k]) for k in want),
            f"rank 0's aggregate differs from aggregate_stacked_auto by "
            f"{diff}")
    print(f"[wire] (a) every worker's gradient equals its rank's (SHA-256 "
          f"of each of {len(want)} leaves); every rank's aggregate is "
          f"the same; rank 0's equals aggregate_stacked_auto (B1 leaf by "
          f"leaf) bit for bit")
    del got, want

    # -- (b) against the one-process stacked-rrs step -------------------------
    for i in (1, 2):
        parted = [k for k, h in ranks[0]["steps"][i - 1]["fp"].items()
                  if ref["fp"][i - 1][k] != h]
        require(not parted, f"step {i}: the group's params part from the "
                            f"one-process step's in {parted}")
        require(ref["losses"][i - 1] == ranks[0]["steps"][i - 1]["loss"],
                f"step {i}: loss {ref['losses'][i - 1]} in one process, "
                f"{ranks[0]['steps'][i - 1]['loss']} over the group")
    got = torch.load(os.path.join(tmp, "params.pt"))
    worst = max(max_err(got[k].to(dev), v) for k, v in ref["params"].items())
    print(f"[wire] (b) 2 stacked-rrs steps over the group (signflip on rank "
          f"{WIRE_W - 1}'s worker): params identical on every rank and to "
          f"the one-process step's after each (a 64-bit digest of every "
          f"leaf's bits); the "
          f"largest difference after step 2 {worst} (gate 0, as the CPU "
          f"test); losses equal")
    require(worst == 0.0, f"the group's params part from the one-process "
                          f"step's by {worst}")

    # -- (c) robust_dot against the one-process product -----------------------
    got = torch.load(os.path.join(tmp, "dw.pt")).to(dev)
    require(torch.equal(got, ref["dw"]), f"(c) robust_dot over the group "
                                         f"parts from one process by "
                                         f"{max_err(got, ref['dw'])}")
    print(f"[wire] (c) robust_dot's dW [2048, 2048] f32 over the group "
          f"equals the one-process _RobustDot bit for bit")

    # -- (f) and (g): the consensus wire over the ranks -----------------------
    f0, g0 = ranks[0]["cons_f"], ranks[0]["cons_g"]
    for r in ranks:
        f, g = r["cons_f"], r["cons_g"]
        print(f"[wire] (f) rank {r['rank']}: the consensus wire fault-free "
              f"(f = 0, trivial plan, no pins) {f['wall_s']:.3f} s, "
              f"synchronised; {f['blocks']} blocks of {WIRE_CHUNK} "
              f"coordinates, {f['gathers']} all_gathers, B1 "
              f"{f['launches']['aggregate']}; (g) one stale straggler on "
              f"{'/'.join(CONS_LEAF)} {g['wall_s']:.3f} s, p_end "
              f"{g['p_end']}, {g['gathers']} all_gathers over "
              f"{g['blocks']} block(s), B1 "
              f"{g['launches']['aggregate']}")
        require(f["launches"]["aggregate"] == f["blocks"]
                and f["gathers"] == f["blocks"],
                f"rank {r['rank']} (f): B1 {f['launches']['aggregate']} and "
                f"{f['gathers']} all_gathers over {f['blocks']} blocks; "
                f"expected one of each a block")
        parted = [k for k, h in f["sha"].items() if r["agg_sha"][k] != h]
        require(not parted, f"rank {r['rank']} (f): the fault-free "
                            f"consensus aggregate parts from (a)'s RRS "
                            f"aggregate in {parted}")
        require(f["aux"] == f0["aux"] and g["aux"] == g0["aux"],
                f"rank {r['rank']}: the consensus aux differs from rank "
                f"0's: (f) {f['aux']} / {f0['aux']}, (g) {g['aux']} / "
                f"{g0['aux']}")
        require(g["sha"] == g0["sha"], f"rank {r['rank']} (g): the "
                                       f"aggregate differs from rank 0's")
        require(g["gathers"] == g["blocks"] * (g["p_end"] + 1),
                f"rank {r['rank']} (g): {g['gathers']} all_gathers; "
                f"expected p_end + 1 = {g['p_end'] + 1} a block, "
                f"{g['blocks']} blocks")
    got = torch.load(os.path.join(tmp, "cons_g.pt")).to(dev)
    require(torch.equal(got, ref["cons_g"]),
            f"(g): the wire parts from the one-process emulation by "
            f"{max_err(got, ref['cons_g'])}")
    require(g0["aux"] == ref["cons_g_aux"],
            f"(g): aux {g0['aux']} over the group, {ref['cons_g_aux']} in "
            f"one process")
    print(f"[wire] (f) every rank's fault-free consensus aggregate equals "
          f"(a)'s RRS aggregate (SHA-256 of each leaf), aux the same on "
          f"every rank {f0['aux']}; (g) every rank's aggregate and aux are "
          f"rank 0's, which equal the one-process "
          f"aggregate(mode='stacked-consensus') bit for bit, aux "
          f"{g0['aux']}")
    del got, ref
    torch.cuda.empty_cache()

    # -- the counted wire call against the profiler and the meta count --------
    meta = wire_meta_count()
    for r in ranks:
        cnt = r["counted"]
        shapes = {kind: 4 * sum(v for name, v in cnt["moved"].items()
                                if kind.replace("-", "_") in name)
                  for kind in ("all-to-all", "all-gather")}
        require(cnt["coll"] == shapes == meta
                and cnt["launches"]["aggregate"] == 1,
                f"rank {r['rank']}: the counted wire call's collectives "
                f"{cnt['coll']}, the profiler's gloo shapes x 4 {shapes}, "
                f"the meta count {meta}; B1 {cnt['launches']}")
    print(f"[wire] the counted wire call ({'/'.join(CONS_LEAF)}, one RRS "
          f"call under op_cost.counting on the card): every rank's "
          f"collectives {ranks[0]['counted']['coll']} bytes = the "
          f"profiler's gloo shapes x 4 ({ranks[0]['counted']['moved']} "
          f"elements) = the meta count under a fake group of {WIRE_W}; B1 "
          f"once")

    # -- (h) the paper's cells over the ranks ---------------------------------
    from repro_torch.configs.paper_glm import PAPER_LINREG
    from repro_torch.infer import coverage_run

    one = {}
    for est in CELL_ESTIMATORS:
        t = time.perf_counter()
        one[est] = coverage_run(device=dev, **paper_kw(
            PAPER_LINREG, attack="gaussian", alpha=0.1, estimator=est)
            ).summary()
        torch.cuda.synchronize()
        one[est]["wall_s"] = time.perf_counter() - t
    cells = {est: [r["cells"][est] for r in ranks] for est in CELL_ESTIMATORS}
    kw = wire_cell_kw(CELL_ESTIMATORS[0])
    for est, recs in cells.items():
        c0, ref = recs[0], one[est]
        summ = c0["summary"]
        wall = max(x["wall_s"] for x in recs)
        se = math.sqrt(ref["coverage"] * (1 - ref["coverage"]) / CELL_SE_CIS)
        print(f"[wire] (h) PAPER_LINREG gaussian a0.1 {est} over {WIRE_W} "
              f"ranks ({kw['reps']} replications, {kw['batch_size']} a rank "
              f"in one chunk): coverage {summ['coverage']:.4f}, mean width "
              f"{summ['mean_width']:.6f}, RMSE {summ['rmse']:.6f}; "
              f"{wall:.3f} s synchronised = {kw['reps'] / wall:.1f} "
              f"replications/s; B1 a rank {c0['ranks_launches']} (the "
              f"one-process slices {c0['slice_launches']}); this process's "
              f"one-process cell at phase 4's settings: coverage "
              f"{ref['coverage']:.4f}, RMSE {ref['rmse']:.6f}, "
              f"{ref['wall_s']:.3f} s; 4 s.e. {4 * se:.4f} ({card})")
        require(all(x["same_on_every_rank"] and x["sha"] == c0["sha"]
                    for x in recs), f"(h) {est}: the ranks' cells differ")
        require(c0["equals_slices"], f"(h) {est}: the group cell is not the "
                                     f"one-process slices' concatenation")
        require(c0["ranks_launches"] == c0["slice_launches"],
                f"(h) {est}: B1 launches a rank {c0['ranks_launches']}, its "
                f"one-process slice's {c0['slice_launches']}")
        require(abs(summ["coverage"] - ref["coverage"]) <= 4 * se,
                f"(h) {est}: coverage {summ['coverage']} over the ranks, "
                f"{ref['coverage']} in one process: more than 4 s.e. "
                f"({se}) apart")
    rmse = {est: cells[est][0]["summary"]["rmse"] for est in cells}
    require(rmse["vrmom"] < rmse["median"],
            f"(h): VRMOM-RCSL RMSE {rmse['vrmom']} not below MOM-RCSL's "
            f"{rmse['median']} over the ranks")
    print(f"[wire] (h) every rank's cell is the same and equals rank 0's "
          f"re-run of the {WIRE_W} one-process slices bit for bit, B1's "
          f"launches a rank equal its slice's; RMSE VRMOM "
          f"{rmse['vrmom']:.6f} < MOM {rmse['median']:.6f}")

    # -- B1 at the wire's slice -----------------------------------------------
    flush = make_flush(torch, dev)
    W, c = ranks[0]["slice"]
    g = torch.Generator(device=dev).manual_seed(WIRE_SEED + 2)
    xs = torch.randn((W, c), generator=g, device=dev)
    rec = b1_record(torch, flush, f"B1 aggregate on the RRS wire's slice "
                    f"(vrmom K={TRAIN_K}, [{W},{c}] f32, a rank's share of "
                    f"{cfg.name} at {WIRE_LAYERS} layers; launches: phase "
                    f"18's ranks, (a) + (b) + (c) + (e))", xs, TRAIN_K,
                    sum(r["launches_a"]["aggregate"]
                        + r["launches_c"]["aggregate"]
                        + sum(s["launches"]["aggregate"] for s in r["steps"])
                        + r["inloop"]["launches"]["aggregate"]
                        for r in ranks))
    rec["bound_ms"], rec["bound_by"] = bound(
        VR.aggregate_cost((W, c), torch.float32)[1])
    xs = torch.randn((W, WIRE_CHUNK), generator=g, device=dev)
    cons = b1_record(torch, flush, f"B1 aggregate on the consensus wire's "
                     f"block (vrmom K={TRAIN_K}, [{W},{WIRE_CHUNK}] f32, "
                     f"round 0 of a fault-free block over {W} ranks; "
                     f"launches: phase 18 (f), one a block and rank)", xs,
                     TRAIN_K, sum(r["cons_f"]["launches"]["aggregate"]
                                  for r in ranks))
    cons["bound_ms"], cons["bound_by"] = bound(
        VR.aggregate_cost((W, WIRE_CHUNK), torch.float32)[1])
    m1, tri = PAPER_LINREG.m_workers + 1, PAPER_LINREG.p * (
        PAPER_LINREG.p + 1) // 2
    xs = torch.randn((m1, kw["batch_size"] * tri), generator=g, device=dev)
    paper = b1_record(torch, flush, f"B1 aggregate on the paper path over "
                      f"ranks (vrmom K={PAPER_LINREG.K}, "
                      f"[{m1},{kw['batch_size'] * tri}] f32, a rank's chunk "
                      f"of PAPER_LINREG's triangle statistics; launches: "
                      f"phase 18 (h), the {WIRE_W} ranks' two cells)", xs,
                      PAPER_LINREG.K, sum(x["launches"] for recs in
                                          cells.values() for x in recs))
    paper["bound_ms"], paper["bound_by"] = bound(
        VR.aggregate_cost(tuple(xs.shape), torch.float32)[1])
    del xs
    print_train_records("wire", card, [rec, cons, paper])
    print(f"[wire] phase 18 in {time.perf_counter() - t_phase:.1f} s "
          f"(the ranks' peak {max(r['peak_gb'] for r in ranks):.1f} GB "
          f"each at most) [card] {card}")
    return [rec, cons, paper]


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    try:
        t_all = t0 = time.perf_counter()

        def lap(what):
            nonlocal t0
            t = time.perf_counter()
            print(f"[time] {what} {t - t0:.1f} s")
            t0 = t

        phase_build()
        lap("phase 1 (build)")
        rec = phase_kernels(torch, dev)
        lap("phase 2 (kernels)")
        counts = phase_serve(torch, dev, card)
        lap("phase 3 (serve qwen3-1.7b)")
        paper_launches, paper_rec = phase_paper(torch, dev, card)
        lap("phase 4 (paper path)")
        config_recs = phase_configs(torch, dev, card)
        lap("phase 5 (configs)")
        pool_recs = phase_pool(torch, dev, card)
        lap("phase 6 (continuous batching)")
        train_recs = phase_train(torch, dev, card)
        lap("phase 7 (training)")
        adaptive_recs = phase_adaptive(torch, dev, card)
        lap("phase 8 (the adaptive tier)")
        consensus_recs = phase_consensus(torch, dev, card)
        lap("phase 9 (consensus)")
        moe_recs = phase_moe(torch, dev, card)
        lap("phase 10 (moe)")
        ssm_recs = phase_ssm(torch, dev, card)
        lap("phase 11 (ssm and hybrid)")
        encdec_recs = phase_encdec(torch, dev, card)
        lap("phase 12 (encdec)")
        train_encdec_recs = phase_train_encdec(torch, dev, card)
        lap("phase 13 (training encdec)")
        train_moe_recs = phase_train_moe(torch, dev, card)
        lap("phase 14 (training moe)")
        train_ssm_recs = phase_train_ssm(torch, dev, card)
        lap("phase 15 (training ssm and hybrid)")
        phase_lint(torch, dev, card)
        lap("phase 16 (static analysis and the audit)")
        launch_recs = phase_launch(torch, dev, card)
        lap("phase 17 (one-card accounting)")
        wire_recs = phase_wire(torch, dev, card)
        lap("phase 18 (the RRS wire over ranks)")
        print(f"[time] all phases {time.perf_counter() - t_all:.1f} s")
    except (CheckFailed, AssertionError) as exc:
        print(f"chip_smoke.py: check failed: {exc}", file=sys.stderr)
        return 1
    kernels = []
    for name in ("aggregate", "aggregate_sample", "flash_attention",
                 "decode_attention"):
        kernels.append(dict(rec[name], launches=counts[name]))
    kernels.append(dict(paper_rec, launches=paper_launches))
    kernels.extend(config_recs)
    kernels.extend(pool_recs)
    kernels.extend(train_recs)
    kernels.extend(adaptive_recs)
    kernels.extend(consensus_recs)
    kernels.extend(moe_recs)
    kernels.extend(ssm_recs)
    kernels.extend(encdec_recs)
    kernels.extend(train_encdec_recs)
    kernels.extend(train_moe_recs)
    kernels.extend(train_ssm_recs)
    kernels.extend(launch_recs)
    kernels.extend(wire_recs)
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
