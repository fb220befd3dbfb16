#!/usr/bin/env python3
"""Drive the PyTorch port's pruned-CNN inference and serving, Yi-9B serving
(at (16, 16) and the reference's default (128, 128) tiles) and Yi-9B
training paths, OLMoE-1B-7B serving (and its smoke config's head dim 24),
the other model families' serving, the families' training and the
multi-chip path on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result):

1. build   -- compile every CUDA kernel of ``src/repro_torch/kernels/*/csrc``
              into ``build/kernels/`` (one ``nvcc`` per source, all started
              together) and print the card's name and power limit.
2. kernels -- each CNN kernel against its plain PyTorch version at main-path
              shapes (ResNet-50 res3a/1x1a, res4b/3x3, res4b/1x1b with its
              residual tail, res5a/3x3; AlexNet conv2), batch 8 at 224 px:
              one JSON line per (kernel, layer) with ``max_abs_err``,
              ``kernel_ms`` (CUDA events over back-to-back launches, after a
              warm-up, L2 warm; ``kernel_device_ms`` the profiler's device
              time, which leaves out the wrapper's host time that a short
              kernel's events measure), ``plain_ms``, ``library_ms``
              (``F.conv2d`` with bias on the dense pruned weights, TF32 off;
              a yardstick the port never calls; ``library_device_ms`` its
              device time) and ``bound_ms`` (the larger of the bytes the
              conv must move over 3.35 TB/s and its f32 operations over
              67 TFLOP/s).  The bytes count the input elements the conv
              reads, not the padded copy the wrapper builds (a stride-2 1x1
              conv reads a quarter of its input), the weights, bias and
              residual once, and the output once.  The ELL kernel must equal
              its plain version bit for bit in its pipelined and its
              blocking schedule (``resolve_schedule`` with ``pipeline``
              None and False; the line carries the schedule and both
              times; a 1x1 layer stages nothing and has one schedule).  The BCSR kernel, on the tensor cores with its f32
              operands split into TF32 halves, must lie within
              1e-4 x (1 + max |y|) of its plain version, and the same
              check must reject ``bsr_conv_split_plain(lo=False)``, one
              product on operands rounded once to TF32; the split's plain
              mirror is reported beside it, and ``bound_tc_ms`` prices the
              three TF32 products of the split at 495 TFLOP/s.  Beside
              each layer's f32 rows, the variants: the ELL kernel on int8
              and e4m3 banks (``quantize_values``), bit for bit the f32
              kernel on ``dequantize(bank)`` and the plain version, both
              schedules; the BCSR kernel on int8 and e4m3 (8, 128) banks
              and at (32, 128) and (64, 128) blocks (f32), each within
              1e-4 x (1 + max |y|) of its plain version.  Their bounds
              count the narrow value streams and scale rows (the same
              operations; ``bound_tc_ms`` two TF32 products for a quantised
              bank), ``library_ms`` ``F.conv2d`` on the dequantised
              weights, ``f32_ms`` the f32 row's time.
3. path    -- ResNet-50, GoogLeNet and AlexNet at full width, random pruned
              weights from ``--seed``, through ``cnn_forward`` with
              ``pallas``, ``bsr`` and ``dense``.  For each net and kernel
              method the launch counters are set to 0, one forward runs, and
              the counts must equal the net's sparse conv layers (39 / 49 /
              4): every sparse layer runs its kernel.  Both kernel methods
              must agree with ``dense`` within rtol = 1e-4 of the output's
              largest magnitude, and give finite (batch, 1000) logits.
              Each (net, method) line carries the forward time (host clock
              over 3 synchronised forwards) and, from one forward under
              ``torch.profiler``, the device's busy time, its idle share of
              the unprofiled forward time, and the kernels that took the
              most device time.
3b. auto   -- ``method="auto"`` on the same three nets (224 px, batch 8):
              the engine's own roofline plan (priced from the bound
              weights), a ``quantize=True`` roofline plan run after
              ``apply_plan_to_params``, and a plan pinning the ELL kernel
              on int8 and e4m3 banks by turns; ResNet-50 block-pruned in
              (64, 128) tiles (``block_prune_conv``) under its roofline
              plans and a plan pinning (32, 128) and (64, 128) blocks, f32
              and quantised, by turns, beside its ``dense``, ``pallas`` and
              ``bsr`` forwards; AlexNet tuned in wall mode on the card
              (every candidate timed with CUDA events), saved under
              ``build/plans/``, reloaded with every layer a cache hit, and
              run.  Every forward is counted and must launch exactly what
              its plan asks (variants included), its ``ExecutionReport``
              must show 0 fallbacks, f32 plans must lie within 1e-4 x
              max(1, max |dense|) of ``dense`` and quantised ones within a
              relative Frobenius norm of 0.05.  Each line carries the
              layers per method, block and value dtype, the forward time,
              the profiled busy time, idle share and launches; the wall
              line the seconds the tuning took, the candidates measured
              and the layers where its winner differs from the roofline's.
3c. preflight -- the static verifier (``repro_torch.analysis``) on the
              card's terms: the auto phase's roofline plans, saved as plan
              caches under ``build/plans/``, and the AlexNet wall plan
              audited by ``run_check`` at batch 8 and backend ``cuda`` (the
              CUDA lints over the four ``.cu`` sources included) and bound
              through ``preflight`` as ``CnnEngine(strict=True)`` runs it:
              0 errors.  Then the agreement sweep on ResNet-50: every
              candidate of the tuning space (f32, int8 and e4m3) and three
              pinned bad entries (tm = m - 1, tm = 63, a (48, 128) block) on
              each sparse conv, preflight's verdict against whether the
              engine's ``execution_report`` refuses the entry or falls back:
              0 disagreements.  The bad entries must raise from real
              forwards, and a plan of statically clean entries (each sparse
              conv takes one of its clean f32 kernel entries, in turn),
              bound with ``strict=True``, runs counted, launching what it
              asks, within 1e-4 x max(1, max |dense|) of ``dense``.  The
              line carries the entries checked, the errors by rule and the
              seconds.
3d. cnn-serve -- ``RobustCnnServer`` on ``WallClock`` at full width, f32
              activations, seeded images: ResNet-50 and GoogLeNet in
              buckets (3, 224, 224) and (3, 160, 160) of 8, AlexNet (whose
              fc6 fixes its input) in (3, 224, 224); requests of 224, 200
              and 160 px (AlexNet 224), deadlines uniform in 0.05-0.5 s.
              The capacity is 8 images over the tuned rung's measured tick
              (a forward and the copy to the host); a steady run sends 512
              requests at 0.8 of it, an overload run the same at 2x, which
              must shed ``queue_full`` and step down for ``overload``; on
              ResNet-50 also the steady run with every sparse conv pinned
              to the ELL kernel (which the roofline picks for no layer),
              and a chaos run at the overload rate with the reference
              CLI's rates (step faults 0.35, plan corruption 0.5, stragglers
              0.1, seed 0), its 224 bucket pinned to the ELL kernel (which
              the corruption drops, ``sched.unsupported_tm``) and its 160
              bucket to the BCSR kernel (whose ladder must step down), then
              replayed twice on ``VirtualClock`` with equal ``SloReport``s.
              Every run is counted and must lose and duplicate nothing,
              launch what its rungs' plans ask for the ticks each ran, and
              hold each completed image within 1e-4 x max(1, max |dense|) of
              a ``dense`` forward of its own padded image (a relative norm
              of 0.05 on the int8 rung).  Each line carries images/s, p50
              and p99 latency, ticks, rung ticks, rejections by reason, and
              one tuned tick's device busy time, idle share and launches.
              The nets are freed afterwards.
4. llm kernels -- on Yi-9B shapes with ``--seed`` weights block-pruned to
              0.8 with (16, 16) tiles, bf16: ``bsr_matmul`` on wq
              (4096 -> 4096), wk (4096 -> 512), gate (4096 -> 11008) and
              down (11008 -> 4096) on (B, T, N) activations of 4 x 1 (the
              serve phase's decode step), 16 x 1 and 32 x 1 (larger decode
              batches, below the schedules' crossover) and 4 x 2048 (a
              prefill): the kernel on the (B*T, N) view ``ops.bsr_matmul``
              hands it, against ``bsr_matmul_plain`` within 1e-4 x max(1,
              max |y|), its bf16 output (as the model asks for it) the f32
              output rounded once, bit for bit, and the wrapper's bf16
              (B, T, M) output within one bf16 rounding of the plain
              version's plus that limit; decode rows must run the ``rows``
              schedule, 8192 the ``wgmma`` one; times are of the
              bf16-output call the model makes; ``library_ms`` from
              ``torch.matmul`` on the dense pruned weight.  The ``rows``
              rows also carry ``kernel_cold_ms`` and ``library_cold_ms``:
              the profiler's device time of the call alone with the L2
              flushed before each call (a 128 MB buffer written, another
              read; their kernels not counted; the kernel and the library
              call in one profiler session), as a decode step finds the
              weights.  Flash
              attention (the tensor-core forward, ``flash_attention_tc``),
              causal, B 4, H 32, KV 4, T = S = 2048, d 128, bf16, on
              the (B, H, T, d) views of (B, T, H, d) tensors that
              ``ops.flash_attention_bthd`` hands the kernel, against
              ``flash_attention_plain`` on f32 copies: each element of O
              within one bf16 rounding (2^-8 of its magnitude) plus 1e-3 of
              O's rms, lse within 1e-4, and the same O check must reject two
              controls (faults the lse check cannot see): the plain version
              with p rounded to bf16 before p v, and the split's plain
              mirror (``flash_attention_split_plain``) with p's hi half
              alone; the mirror with both halves is reported beside them.
              ``library_ms`` from
              ``F.scaled_dot_product_attention(is_causal=True,
              enable_gqa=True)``.  ``bound_ms`` is the larger of the bytes
              (each input once, each output once; only the kept tiles) over
              3.35 TB/s and the operations (only the kept tiles, only the
              causal half) over their peaks: bf16 x bf16 products with f32
              sums (``bsr_matmul``, flash's q k^T) at 989 TFLOP/s on the
              tensor cores, and flash's p v, whose p is f32, as the design
              that keeps its precision computes it, two bf16 products (of
              p's hi and lo halves) at 989 TFLOP/s; the flash row also
              carries ``bound_all_bf16_ms`` (p v as one bf16 product, as
              SDPA computes it) and ``bound_fma_ms`` (p v in f32 on the FMA
              units at 67 TFLOP/s).
              ``kernel_ms``, ``plain_ms`` and ``library_ms``
              are device time per call under ``torch.profiler`` (a
              decode-sized kernel is shorter than its launch, so CUDA events
              around back-to-back launches time the host);
              ``kernel_event_ms`` is the CUDA-event time beside it.
5. consistency -- Yi-9B at full width in f32, sparsity 0.8, B 2, T 64:
              ``forward`` under flash attention against 64 ``decode_step``s
              through the KV cache; logits within rtol = atol = 1e-2 and
              argmax agreement >= 0.95 (``tests/test_decode_consistency.py``).
6. prefill -- Yi-9B in bf16, B 4, T 2048, ``make_prefill_step`` under flash
              attention at sparsity 0.8 and 0.0: one counted forward must
              launch ``bsr_matmul`` 336 times (7 projections x 48 layers),
              all through its ``wgmma`` schedule, and the tensor-core flash
              forward 48 times (0 and 48 dense),
              with finite (4, 64000)
              logits; each line carries ``forward_ms`` (host clock over 3
              synchronised forwards) and the profiled device breakdown.
7. serve   -- Yi-9B in bf16 at sparsity 0.8 behind ``ServeEngine`` (4 slots,
              max_len 128), 8 requests with 8-48 prompt tokens and budgets
              of 16-32 new tokens from ``--seed``: every request served to
              its budget with ids below 64000, every tick 336 ``bsr_matmul``
              (all through ``rows``, 0 through ``wgmma``) and 0 flash
              launches; the line carries ticks, ms per tick,
              generated tokens per second and one profiled decode step,
              with ``bsr_matmul_rows_ms``, the device time of its
              ``bsr_matmul_rows`` kernels, and their share of the busy
              time.
8. llm bwd kernels -- both flash backward kernels at Yi-9B's ``train_4k``
              shape (B 1, H 32, KV 4, T = S = 4096, d 128, causal, bf16) on
              the (B, H, T, d) views of (B, T, H, d) tensors that the
              autograd Function hands them, with O and lse from the forward
              kernel, against ``flash_attention_bwd_plain`` on f32 copies:
              each element of dQ, dK and dV within one bf16 rounding (2^-8
              of its magnitude) plus 1e-3 of the gradient's rms, and the same
              check must reject two controls: the plain backward with p
              rounded to bf16 wherever it is used (dS and dV), and the
              split's mirror with hi halves alone (dS in bf16 for dQ).
              bf16 runs the tensor-core dQ (``flash_attention_bwd_dq_tc``)
              and dK/dV with its group sum (``flash_attention_bwd_dkv_tc``)
              and no f32 kernel; two launches of each on the same operands
              must agree bit for bit.
              ``library_ms`` is the backward of
              ``F.scaled_dot_product_attention(is_causal=True,
              enable_gqa=True)`` on the same operands (dQ, dK and dV in one
              call, given on both rows, as is the plain backward's time).
              ``bound_ms`` prices, over the causal half, q k^T and dO v^T
              (bf16 x bf16) as one bf16 product each and each product of
              the f32 p or ds (dQ: ds k; dK/dV: p^T dO and ds^T q) as two,
              all at 989 TFLOP/s; ``bound_all_bf16_ms`` one each;
              ``bound_fma_ms`` the f32-operand products at 67 TFLOP/s.
8b. flash f32 -- the split-TF32 forward, dQ and dK/dV kernels (dK/dV
              with its group sum: G = 8), which f32 operands launch, at the
              train consistency shape (B 1, H 32, KV 4, T = S = 2048, d 128,
              causal, f32) against their plain versions: O, dQ, dK and dV
              within 1e-4 of their largest magnitude (the train consistency
              phase's measure), lse within 1e-4; each also against its
              split-TF32 mirror (``flash_attention_fwd_tf32_plain``,
              ``flash_attention_bwd_tf32_plain``, reported), and the same
              check must reject their controls (``lo=False``: one TF32
              product on operands rounded once; its errors reported), O's
              among them; ``library_ms`` from SDPA in f32 (the backward
              rows: SDPA's whole backward under the named, pinned
              efficient-attention backend on K and V expanded to the H
              heads, timed once and given on both rows), ``bound_ms`` the
              split's three TF32 products a product at 495 TFLOP/s,
              ``bound_fma_ms`` every product on the FMA units at 67
              TFLOP/s.
9. train consistency -- Yi-9B at full width in f32, 2 layers, B 1 x T 2048:
              the gradient of every parameter through ``flash`` against
              through ``chunked``, each within 1e-4 of that parameter's
              largest chunked gradient, and the losses within 1e-5; then one
              counted ``make_train_step`` step under flash must launch the
              split-TF32 forward, dQ and dK/dV kernels (and its group sum)
              once per layer each.
10. train  -- Yi-9B at full width cut to 6 of its 48 layers (``reduced``),
              bf16 params, f32 AdamW state, one ``train_4k`` sequence (B 1 x
              T 4096) from ``SyntheticLMDataset``, repeated, under flash
              attention: ``make_train_step`` under ``StepRunner`` for 1
              warm-up and 5 timed steps, each counted (12 tensor-core
              forwards, 12 tensor-core dQ, 12 tensor-core dK/dV and their
              group sums, no f32 flash kernel, no ``bsr_matmul``), the
              schedule's warm-up spanning the run, with a
              finite loss that falls on the repeated batch; the runner saves a
              checkpoint after the last step (into ``build/``, removed
              afterwards), and it must restore bit for bit.  The line
              carries ms per step, tokens per second, peak memory, one
              profiled step's device busy time, idle share and top kernels,
              and the share of the busy time the four flash kernels take.
11. flash dims -- every flash kernel at head dims 80 (HuBERT-XLarge: B 1,
              H = KV = 16, T 2048, bidirectional) and 96 (Phi-3-Vision: B 1,
              H = KV = 32, T 2048, causal) against its plain version, as
              the llm kernels and llm bwd kernels phases hold them: the
              tensor-core forward (bf16; O within one bf16 rounding plus
              1e-3 of its rms, rejecting the two controls; lse within 1e-4),
              dQ and dK/dV (bf16, through autograd; each gradient within one
              bf16 rounding plus 1e-3 of its rms, rejecting p in bf16 and
              the split's hi half alone; two launches bit for bit), and the
              split-TF32 forward, dQ and dK/dV (f32; within 1e-4 of the
              largest magnitude, rejecting the one-product controls); the
              tensor-core backward also at
              d 96 over GQA
              32:8 and at d 80 over a ragged T of 2000 (the kernels line's
              ``arch_rows``); ``library_ms`` SDPA (its whole backward for
              dQ and dK/dV), which the port never calls.
11b. blocks -- Yi-9B at the reference's default (128, 128) tiles:
              ``bsr_matmul`` at (128, 128) and (64, 128) on wq, wk, gate and
              down at 4 rows (``rows``) and 8192 (``wgmma``) against its
              plain version (PERF.md row 3d; the (64, 128) rows the kernels
              line's ``arch_rows``); one layer's bf16 forward (B 1 x T 512)
              through the kernels against the same forward through their
              plain versions (relative norm 1e-2); at full width and depth,
              bf16, the prefill (B 4 x T 2048, every projection through
              ``wgmma``) and ``ServeEngine`` (8 requests, every projection
              of every tick through ``rows``), then the f32 forward against
              decode cut to 8 layers; every projection counted by schedule
              and block (``by_block``).
11c. any dim -- the flash kernels at head dims they run in a larger
              instantiation: the forward, dQ and dK/dV, bf16 and f32, at d
              24 (instantiation 32) and 48 (64) at HuBERT-XLarge's shape,
              against their plain versions as the flash dims phase holds
              them (PERF.md rows 4c-6c; d 48 the ``arch_rows``); rows
              the 16-byte copies cannot cover (bf16 d 132, f32 d 130)
              refused at the raw launcher with no launch; OLMoE-1B-7B's
              smoke config (head dim 24): its flash prefill (B 4 x T 256)
              in bf16 and f32 against chunked attention's, the f32
              gradients through flash against chunked (the train
              consistency phase's check, 2 layers, T 2048) and one bf16
              train step, each counted by head dim and instantiation.
11d. wide heads -- head dims above 128 through the kernels' output-column
              split (one block a 128-column slice): the six kernels at d
              256 and 160 at Gemma-7B's attention shape (B 1, H = KV =
              16, T 2048, causal) against their plain versions as above,
              SDPA pinned for the library times, the split's bound beside
              the math's (PERF.md rows 4d-6d); at d 256 also GQA 16:2 and
              a ragged bidirectional T of 2000 (``arch_rows``); each of
              the six at each dim, in both dtypes, launched 20 times on the
              raw launchers (uncounted) over GQA 16:2 (T 2048 causal, T
              2000 bidirectional) with every operand a view into a buffer
              that holds NaN past d and around it: every output element
              written, nothing outside it, no NaN read, the same bits each
              time and as the wrappers' on contiguous copies;
              ``flash_attention_bthd``'s forward and backward counted at
              each dim; Yi-9B re-headed to 16 heads of 256 over 2 kv heads
              (d_model 4096, G 8), cut to 4 layers: its bf16 flash prefill
              (B 1 x T 2048) against chunked, its f32 gradients against
              chunked (2 layers) and one bf16 train step, every flash
              launch counted at the wide key (``(kind, d, "128x2")``).
12. moe     -- OLMoE-1B-7B at full width and depth (16 layers, d_model
              2048, 64 experts top-8), bf16, weights from ``--seed``:
              ``bsr_matmul`` on wq (2048 -> 2048) at 4 and 8192 rows and the
              flash forward at B 4, H = KV = 16, T 2048, d 128 against their
              plain versions; ``make_prefill_step`` at B 4 x T 2048,
              sparsity 0.8 and 0.0, each forward counted (16 tensor-core
              flash forwards; 64 ``bsr_matmul`` through ``wgmma`` when
              sparse), its lines with the (token, expert) assignments the
              capacity dropped (counted around that forward alone); ``ServeEngine`` at sparsity 0.8 as the
              Yi-9B serve phase runs it (every tick 64 ``bsr_matmul``
              through ``rows``, nothing else); the f32 consistency of the
              consistency phase, cut to 2 layers, at a capacity factor of 8
              (E / top_k: no assignment dropped).
13. families -- at full width, counted, finite logits, peak memory and
              times: Mamba2-2.7B (64 layers) through ``serve.py``'s loop
              (B 4, prompt 32, gen 16) at sparsity 0.8 (every step 128
              ``bsr_matmul`` through ``rows``) and 0.0, ``bsr_matmul`` on
              its in_proj (2560 -> 10576) against its plain version, and a
              sparse prefill (B 4 x T 1024: the chunked SSD scan,
              ``wgmma``); ``bsr_matmul`` through ``rows`` against its plain
              version on Phi-3-Vision's wq (3072 -> 3072) at 2048 rows and
              Jamba's in_proj (8192 -> 33280) at 1024, the row counts of
              their forwards below; Phi-3-Vision (32 layers)
              ``forward_embeds`` at B 1 x T 2048, sparse, through the
              tensor-core flash forward at d 96, then 16 decode steps; HuBERT-XLarge (48 layers)
              ``forward_embeds``, bidirectional, through it at d 80;
              DeepSeek-V3 cut to 4 layers (3 dense, 1 MoE of 256 experts;
              its MLA attention takes the chunked path, so no kernel runs),
              prefill B 1 x T 512 and 8 absorbed decode steps; Jamba-1.5-
              Large cut to 2 layers (Mamba2 + MoE, Mamba2 + MLP), sparse,
              prefill B 1 x T 1024 and 8 decode steps; then HuBERT and
              Phi-3-Vision cut to 2 layers in f32, through the split-TF32
              flash forward at d 80 and 96, within 1e-4 of the chunked
              attention's largest logit.
14. families train -- ``make_train_step`` (the state updated in place),
              flash attention, B 1 x T 2048, bf16 params, f32
              AdamW state, weights from ``--seed``: HuBERT-XLarge at full
              width and depth (48 layers) on the data pipeline's f32
              embeddings (f32 activations: the split-TF32 flash forward, dQ
              and dK/dV at d 80, 48 of each a step, no group
              sum): first the loss and the gradient norm of
              one forward and backward at full depth under flash within
              1e-5 of those under chunked attention; then under
              ``StepRunner``, 1 warm-up and 3 timed steps (the warm-up of
              their schedule spans them; the loss on the repeated batch
              must fall), a checkpoint saved into ``build/`` and restored
              bit for bit, then one step on bf16 embeddings (the
              tensor-core kernels at d 80), then the control: the same 4
              steps from the same weights with a one-step warm-up, their
              losses recorded; Phi-3-Vision-4.2B at full
              width and depth (32 layers) on bf16 embeddings: one forward
              and backward of the same params and batch under remat none,
              dots and full (the flash forward 32, 64, 64 times; the
              activations the forward keeps full < dots < none, the peaks
              full <= dots <= none with full < none; losses within 1e-5),
              then 1 + 3 steps under full remat with the checkpoint (the
              loss must fall); DeepSeek-V3 at
              full width cut to its first (dense) layer and the MTP block
              (``reduced``: a MoE layer's state does not fit a card), one
              step on tokens (MLA takes the chunked path: no kernel), its
              loss with and without the MTP term finite and the step's
              loss the MTP one; then HuBERT and Phi-3-Vision in f32 cut to
              2 layers as the train consistency phase holds Yi-9B (the
              split-TF32 backward at d 80 and 96).  Every step counted; each line
              carries ms a step, tokens/s, peak and state GB, the losses.
15. mesh    -- the multi-chip path (``distributed/``, the meshed
              ``make_train_step``, ``moe_ep.py``) on this one card, flash
              attention, weights from ``--seed``.  (a) Qwen1.5-0.5B at full
              width and depth (24 layers, bf16, B 4 x T 2048): 3 steps of
              the meshed step in a world of one over NCCL on a (1, 1)
              ("data", "model") mesh, each counted (24 tensor-core flash
              forwards, dQ, dK/dV and group sums), loss and grad norm
              within 1e-5 relative of the meshless step from the same
              state (the line says whether bit-identical).  OLMoE-1B-7B's
              one-rank forward through the gather dispatch (B 1 x T 2048),
              its capacity factor raised through 1.25, 2, 4, 8 until no
              assignment drops.  Then two ranks spawned on the card over
              gloo (NCCL refuses two ranks on one device), the kernels
              loaded from the build above, a join timeout, a rank's failure
              the run's: (b) Qwen1.5-0.5B's 3 steps on a (1, 2) mesh (tp
              mode A, 8 heads a rank), losses within 1e-3 and grad norms
              within 2e-3 relative of the meshless ones; OLMoE-1B-7B's
              forward with ``MOE_IMPL = "ep"`` (32 experts a rank, 16
              tensor-core flash forwards a rank), its capacity raised the
              same way until the world drops nothing; without drops it is
              the gather forward's function, so its logits may lie at most
              2x as far (relative norm) from the same model's f32 forward
              as the one-rank bf16 gather forward's do (bf16 over 16 random
              layers puts either a few per cent away); then each rank's
              projections pruned to BCSR at 0.8 and ``make_prefill_step``
              run (64 ``bsr_matmul`` a rank on its shards); then both again
              in f32 on the ranks' shards cast (the split-TF32 flash
              forward, f32
              tiles), no drop: the EP logits within 1e-4 (relative norm) of
              the one-rank f32 forward's, the sparse prefill's last logits
              within 1e-4 of the one-rank f32 prefill on the same pruned
              weights (gathered whole, dense); (c) Qwen1.5-0.5B's 3 steps on
              a (2, 1, 1) ("pod", "data", "model") mesh, uncompressed
              (losses and grad norms as (b)) and with ``compress_cross_pod``
              (the int8 all-reduce): every compressed gradient leaf of the
              first step within its int8 bound of the uncompressed one
              (``_int8_error``), the step's grad norm within 1e-3 of the
              compressed gradient's, the losses within 1e-2 of the
              uncompressed ones, and both pods' states bit-equal after the
              steps.
              Then the meshed decode on the (1, 2) mesh (``_mesh_decode``,
              bf16, weights from the seed): Qwen1.5-0.5B at full width and
              depth (its KV heads over tp) serving 4 rows (a cache of 128,
              32 prompt tokens fed one by one through ``make_serve_step``,
              then 32 greedy ones: the distributed argmax), dense and with
              each rank's shards pruned at 0.8 (``sparsify_shards``: 168
              BCSR banks a rank, ``bsr_matmul``'s rows schedule on every
              projection of every step, 24 x 7 x 64 launches a run a rank,
              nothing else); DeepSeek-V3 at full width cut to its first
              (dense-MLP) layer, no MTP head, 96 steps (its latent cache
              split by sequence, the write crossing to rank 1 at 64).  Each
              run again in f32 on the shards cast, teacher-forced with the
              bf16 run's tokens; rank 0 decodes the same tokens meshless on
              the weights gathered whole (pruned, dense, where sparse): the
              f32 steps within 1e-4 x max(1, max |logit|), the bf16 logits
              at most 2x as far (relative norm) from the meshless f32 ones
              as the meshless bf16 decode's, the f32 next tokens the
              meshless argmax wherever its top two differ by more than the
              f32 tolerance; a ``mesh_decode`` line with ms a step, the
              launches, the distances and the part's seconds.  Mamba2's
              state split over tp is left to the CPU tests.
              Every step and forward counted in each rank; the lines carry
              step times, peak memory a rank and the card, and a line of
              each rank's launches.
16. bf16    -- the two conv kernels on bf16 activations: every sparse conv
              of ResNet-50 at full width (batch 8, 224 px, a random input
              at each layer's geometry) through ``ops.sparse_conv`` (a bf16
              bank: its bf16 words, one fmaf a nonzero and pixel, the
              paired slab at stride 1) and ``ops.bsr_conv`` (bf16 (8, 128)
              tiles, groups of up to 128 channels), each once,
              counted (39 + 39 bf16 launches, nothing else); then each
              layer's ELL output bit for bit its plain version on the card
              and the BCSR output within one bf16 ulp of its plain version
              (2^-7 |y| + 2^-8 max(1, max |y|)), and both within
              ``BF16_TOL`` (3e-2 + 3e-2 |y|, the reference's bf16
              tolerance) of the f32 kernels on the same weights (widened)
              and the f32 input;
              then rows 1c and 2e timed at the kernel phase's five layers
              (``bound_ms`` at bf16's item size; ``library_ms``
              ``F.conv2d`` in bf16, cuDNN).
17. dryrun  -- ``python -m repro_torch.launch.dryrun`` in a subprocess
              with no card visible (``CUDA_VISIBLE_DEVICES=""``), the cells
              one after another in a background thread under the kernels'
              build (four torch threads each), joined before the first
              timed phase, so no timed phase runs beside them, and checked
              here: Yi-9B x
              train_4k on 16 x 16 with ``--attn-impl flash`` and the probes,
              OLMoE-1B-7B x prefill_32k on 2 x 16 x 16, and Yi-9B x
              decode_32k on 16 x 16 under ``--sparse-weights 0.8`` (its KV
              cache split by sequence, kv 4 on tp 16; BCSR banks counted
              by the kernel op's flop formula), each rank 0's meta step in a fake world of
              256 / 512 ranks; each cell's roofline lines printed, its JSON
              read back (under ``experiments/dryrun_torch/``, tag
              ``smoke``) with FLOPs and collective bytes above 0 (the
              decode cell: ``sparse_weights`` 0.8 and the cache aliased).
              It proves the fake process group and the counters work on
              the card machine's torch build.
18. the ``kernels`` JSON line (each entry's ``arch_rows``: its rows at the
   other archs' shapes, counted in its ``max_abs_err``), then the card's
   name and power limit, then the device line last.

Every counted run sets all forty launch counters (``COUNTERS``) to 0 just
before it and reads them just after; launches made to compare a kernel with
its plain version are not counted, and every kernel must have launched in
some counted run.  The prefill phase's forwards must all go through the
tensor-core forward and the ``wgmma`` BCSR matmul (bf16), the train step's
through the tensor-core flash kernels, the consistency phases' through
the split-TF32 forward and backward (f32).  Peak rates are the H100 SXM
data sheet's (dense, 700 W): 3.35 TB/s HBM3, 989 TFLOP/s bf16 tensor
cores, 495 TFLOP/s TF32 tensor cores, 67 TFLOP/s f32.

Tolerances against the plain versions: the ELL kernel rounds each multiply
and add as its plain version does, in the same order, so it is held to bit
identity; the BCSR conv kernel splits its operands into TF32 halves (about
21 bits each) and sums in another order than the plain version's library
contraction, and is held to 1e-4 x (1 + max |y|).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import atexit
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 without tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12   # H100 SXM, bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12   # H100 SXM, TF32 tensor cores, dense
EXPECTED_SPARSE = {"resnet50": 39, "googlenet": 49, "alexnet": 4}
KERNEL_LAYERS = [("resnet50", "res3a/1x1a"), ("resnet50", "res4b/3x3"),
                 ("resnet50", "res4b/1x1b"), ("resnet50", "res5a/3x3"),
                 ("alexnet", "conv2")]
BATCH = 8
IMAGE = 224
BSR_TOL = 1e-4                        # x (1 + max |y|)
PATH_RTOL = 1e-4
BF16_TOL = 3e-2                       # rtol = atol, the reference's bf16 tests
# the dry run's cells (arch, shape, flags): the 16 x 16 train cell with its
# probes and the flash kernels' meta branch, a 2 x 16 x 16 prefill cell
DRYRUN_CELLS = (("yi-9b", "train_4k", ("--attn-impl", "flash")),
                ("olmoe-1b-7b", "prefill_32k", ("--multi-pod",)),
                ("yi-9b", "decode_32k", ("--sparse-weights", "0.8")))
DRYRUN_TIMEOUT_S = 300
# The head dims whose flash launches have counters of their own, and the
# instantiation each runs in (budget.flash_instance)
DIM_INSTANCES = ((80, 80), (96, 96), (24, 32), (256, "128x2"),
                 (160, "128x2"))
# Each kernel's launch counter: (its wrapper in mods["kernels"], the
# attribute[, the key of a dict attribute]); a launch of the kernel adds
# one to it and nothing else does.
# The flash forward, dQ and dK/dV each have a split-TF32 kernel (f32
# operands) and a tensor-core one (bf16); dK/dV's tensor-core kernel is
# followed by its group sum, its split-TF32 one by its group sum when G > 1.
COUNTERS = {
    "sparse_conv": ("sparse_conv", "launches"),
    "bsr_conv": ("bsr_conv", "launches"),
    # the conv kernels' variants: the ELL kernel on int8 and e4m3 banks, the
    # BCSR kernel on int8 and e4m3 banks and at block heights 32 and 64
    # (each also counted in its kernel's total)
    "sparse_conv_int8": ("sparse_conv", "int8_launches"),
    "sparse_conv_e4m3": ("sparse_conv", "e4m3_launches"),
    "bsr_conv_int8": ("bsr_conv", "int8_launches"),
    "bsr_conv_e4m3": ("bsr_conv", "e4m3_launches"),
    "bsr_conv_bm32": ("bsr_conv", "bm32_launches"),
    "bsr_conv_bm64": ("bsr_conv", "bm64_launches"),
    # ... and on bf16 activations (the bf16 phase)
    "sparse_conv_bf16": ("sparse_conv", "bf16_launches"),
    "bsr_conv_bf16": ("bsr_conv", "bf16_launches"),
    "bsr_matmul": ("bsr_matmul", "launches"),
    "bsr_matmul_wgmma": ("bsr_matmul", "wgmma_launches"),
    "flash_attention": ("flash_attention", "launches"),
    "flash_attention_bwd_dq": ("flash_attention_bwd_dq", "launches"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd_dkv", "launches"),
    "flash_attention_tc": ("flash_attention", "tc_launches"),
    "flash_attention_bwd_dq_tc": ("flash_attention_bwd_dq", "tc_launches"),
    "flash_attention_bwd_dkv_tc": ("flash_attention_bwd_dkv", "tc_launches"),
    "flash_attention_dkv_reduce": ("flash_attention_bwd_dkv",
                                   "reduce_launches"),
    "flash_attention_dkv_reduce_tf32": ("flash_attention_bwd_dkv",
                                        "tf32_reduce_launches"),
    # the forwards at head dims 80 (HuBERT-XLarge), 96 (Phi-3-Vision) and
    # 24 (OLMoE's smoke config, in the instantiation 32), and the wide
    # kernels (the output-column split) at 256 (Gemma-7B's) and 160, two
    # 128-column slices: their launches by head dim, (kernel, d, D) in the
    # wrapper's ``by_head_dim`` (each also counted in its kernel's total)
    **{f"flash_attention{tc}_d{d}": ("flash_attention", "by_head_dim",
                                      (kind, d, inst))
       for d, inst in DIM_INSTANCES
       for tc, kind in (("_tc", "tc"), ("", "tf32"))},
    # the backward kernels at those dims, the same way (the tensor-core
    # dK/dV's group sum counted with it; f32 runs the split-TF32 kernels)
    **{f"flash_attention_bwd_{part}{tc}_d{d}": (
        f"flash_attention_bwd_{part}", "by_head_dim", (kind, d, inst))
       for part in ("dq", "dkv")
       for d, inst in DIM_INSTANCES
       for tc, kind in (("_tc", "tc"), ("", "tf32"))},
    # bsr_matmul on the reference's default (128, 128) tiles, by schedule:
    # (schedule, bm, bn) in the wrapper's ``by_block`` (each also counted
    # in its kernel's total)
    "bsr_matmul_rows_b128": ("bsr_matmul", "by_block", ("rows", 128, 128)),
    "bsr_matmul_wgmma_b128": ("bsr_matmul", "by_block",
                              ("wgmma", 128, 128)),
}
KERNEL_NAMES = tuple(COUNTERS)
# the CNN path's counters (the conv kernels and their variants); the others
# are the transformer path's
CNN_NAMES = tuple(n for n in KERNEL_NAMES if n.startswith(("sparse_conv",
                                                           "bsr_conv")))
LLM_NAMES = tuple(n for n in KERNEL_NAMES if n not in CNN_NAMES)
# the variants the kernel phase times beside each conv kernel's f32 row:
# (name, value dtype, BCSR block)
ELL_VARIANTS = (("sparse_conv_int8", "int8"),
                ("sparse_conv_e4m3", "float8_e4m3fn"))
BSR_VARIANTS = (("bsr_conv_int8", "int8", (8, 128)),
                ("bsr_conv_e4m3", "float8_e4m3fn", (8, 128)),
                ("bsr_conv_bm32", None, (32, 128)),
                ("bsr_conv_bm64", None, (64, 128)))
# the auto phase: quantised plans against dense by the reference's
# quantisation bound (relative Frobenius norm)
QUANT_REL_TOL = 0.05
# block-pruned ResNet-50: tiles of the tallest block, so that every block
# height of the ladder keeps the same fraction
BLOCK_PRUNE = (64, 128)
# the cnn-serve phase: buckets of CNN_SERVE_BATCH images a tick, (c, s, s)
# for each bucket size s (AlexNet's fc6 fixes its input at 224),
# CNN_SERVE_REQUESTS requests of the CNN_SERVE_SHAPES sizes padded up into
# the smallest bucket that holds them, deadlines uniform in
# CNN_SERVE_DEADLINE_S seconds, arrivals at CNN_SERVE_STEADY and
# CNN_SERVE_OVERLOAD times the tuned rung's measured capacity, and the
# reference CLI's chaos rates
CNN_SERVE_BATCH = 8
CNN_SERVE_BUCKETS = {"resnet50": (224, 160), "googlenet": (224, 160),
                     "alexnet": (224,)}
CNN_SERVE_SHAPES = {"resnet50": (224, 200, 160),
                    "googlenet": (224, 200, 160), "alexnet": (224,)}
CNN_SERVE_REQUESTS = 512
CNN_SERVE_DEADLINE_S = (0.05, 0.5)
CNN_SERVE_STEADY = 0.8
CNN_SERVE_OVERLOAD = 2.0
CNN_SERVE_CHAOS = dict(seed=0, step_fault_rate=0.35,
                       plan_corruption_rate=0.5, straggler_rate=0.1)

# The transformer path: Yi-9B (48 layers, d_model 4096, 32 heads over 4 kv
# heads, head_dim 128, d_ff 11008, vocab 64000), weights block-pruned with
# (16, 16) tiles as `sparsify_params` prunes them.
LLM_SPARSITY = 0.8
LLM_BLOCK = (16, 16)
LLM_PROJECTIONS = [("wq", 4096, 4096), ("wk", 4096, 512),
                   ("gate", 4096, 11008), ("down", 11008, 4096)]
# (B, T): decode steps of 4 (the serve phase's slots), 16 and 32 rows (up
# to the rows schedule's crossover), a prefill
LLM_ACTIVATIONS = ((4, 1), (16, 1), (32, 1), (4, 2048))
# bytes written (then as many read) between the calls of a cold timing:
# over twice the H100's 50 MB L2
L2_FLUSH_BYTES = 128 * 2**20
# profiles taken of a timing before falling back to CUDA events; a call
# whose kernels take at least PROFILE_LONG_MS each by CUDA events is not
# waiting on the host, so a profile summing to less than PROFILE_MIN_SHARE
# of its event time lost kernels' durations (a host-bound call's profile
# rightly sums to less: the host's gaps are not device time)
PROFILE_TRIES = 3
PROFILE_LONG_MS, PROFILE_MIN_SHARE = 0.1, 0.5
FLASH_SHAPE = (4, 32, 4, 2048, 128)   # B, H, KV, T = S, d
BSR_MATMUL_TOL = 1e-4                 # x max(1, max |y|)
# bf16 O, per element: one bf16 rounding (2^-8 of |O|) + FLASH_O_ATOL x rms(O)
FLASH_O_ATOL = 1e-3
FLASH_LSE_TOL = 1e-4
# f32 O, dQ, dK and dV of the f32 kernels: max |error| within FLASH_F32_TOL x
# max |plain|, the train consistency phase's measure for f32 gradients at
# the same shape (f32 sums of up to G x T = 16,384 terms in another order
# than the plain version's)
FLASH_F32_TOL = 1e-4
CONSIST_SHAPE = (2, 64)               # f32 forward vs decode steps
CONSIST_TOL = 1e-2                    # rtol = atol, tests/test_decode_consistency.py
CONSIST_AGREE = 0.95
PREFILL_SHAPE = (4, 2048)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS = 4, 128, 8
SERVE_PROMPT, SERVE_BUDGET = (8, 48), (16, 32)
# The training path: Yi-9B's train_4k shape (src/repro/models/config.py:149).
BWD_SHAPE = (1, 32, 4, 4096, 128)     # B, H, KV, T = S, d
# bf16 dQ, dK, dV, per element: one bf16 rounding + FLASH_BWD_ATOL x rms
FLASH_BWD_ATOL = 1e-3
TRAIN_CONSIST_LAYERS, TRAIN_CONSIST_SHAPE = 2, (1, 2048)
TRAIN_GRAD_TOL = 1e-4                 # x the leaf's largest chunked gradient
TRAIN_LOSS_TOL = 1e-5                 # x |loss|
TRAIN_LAYERS, TRAIN_SHAPE = 6, (1, 4096)
TRAIN_WARMUP, TRAIN_TIMED = 1, 5
# a train run's schedule is this many times its steps long, so that its
# warm-up (a tenth of the schedule) spans the run
TRAIN_SCHEDULE = 10
# The MoE path: OLMoE-1B-7B (16 layers, d_model 2048, 16 heads of 128,
# 64 experts top-8 of d_ff 1024, vocab 50304) at full width and depth.  Its
# BCSR projections are the four attention ones of each layer (the experts
# are stacked (E, in, out) banks and stay dense, as the reference's are).
MOE_ARCH = "olmoe-1b-7b"
MOE_PROJECTIONS = 4
# bsr_matmul on wq (2048 -> 2048): a decode tick of 4 slots, the prefill
MOE_KERNEL_ROWS = ((4, 1), (4, 2048))
MOE_FLASH_SHAPE = (4, 16, 16, 2048, 128)  # B, H, KV, T = S, d
# the consistency check cut to 2 layers, at a capacity factor of E / top_k:
# every expert's capacity is the whole group, so no assignment is dropped
MOE_CONSIST_LAYERS, MOE_CONSIST_CAPACITY = 2, 8.0
# Yi-9B at the reference's default (128, 128) tiles (its
# SparsityConfig.block, and its dry run's (M / tp, 128)): the prefill and
# ServeEngine at full depth, counted by schedule and block; the f32
# forward against decode cut to BLOCKS_CONSIST_LAYERS layers (the (16, 16)
# phase runs it at full depth); bsr_matmul's rows 3d at each of
# BLOCKS_ROW_BLOCKS on LLM_PROJECTIONS, 4 rows (rows) and 8192 (wgmma)
BLOCKS_BLOCK = (128, 128)
BLOCKS_ROW_BLOCKS = ((128, 128), (64, 128))
BLOCKS_CONSIST_LAYERS = 8
# a layer's forward through the kernels against the same forward through
# their plain versions (bf16 logits, relative norm)
BLOCKS_PLAIN_RTOL = 1e-2
# Head dims the kernels run in a larger instantiation: OLMoE-1B-7B's
# smoke config (d 24, instantiation 32) through its flash prefill and a
# train step in bf16 and f32; rows 4c-6c at d 24 and 48 at HuBERT-XLarge's
# shape (B 1, H 16, KV 16, T = S 2048, bidirectional); head dims whose
# rows the kernels' 16-byte copies cannot cover (bf16 132: 264 bytes; f32
# 130: 520), refused at the raw launcher on the card
ANY_DIM_ARCH = "olmoe-1b-7b"
ANY_DIM_DIMS = (24, 48)
ANY_DIM_SHAPE = (1, 16, 16, 2048)
ANY_DIM_PREFILL = (4, 256)
ANY_DIM_REFUSED = (("bfloat16", 132), ("float32", 130))
# Head dims above 128, the kernels' wide forms (the output-column split):
# rows 4d-6d, the six kernels at Gemma-7B's attention shape (B 1, H = KV
# = 16, T = S 2048, causal; google/gemma-7b's config: 16 heads of 256) at
# each of WIDE_DIMS, and at d 256 over GQA 16:WIDE_GQA_KV (causal) and a
# ragged bidirectional T; SDPA pinned to WIDE_LIBRARY's backend by dtype;
# flash_attention_bthd's forward and backward counted at each dim; then
# Yi-9B re-headed to Gemma-7B's head dim (WIDE_HEADS: d_model 4096, G 8
# as Yi-9B's), cut to WIDE_LAYERS layers: its bf16 flash prefill against
# chunked, its f32 gradients against chunked (2 layers) and a bf16 train
# step
WIDE_DIMS = (256, 160)
WIDE_SHAPE = (1, 16, 16, 2048)        # B, H, KV, T = S
WIDE_GQA_KV, WIDE_RAGGED_T = 2, 2000
WIDE_LIBRARY = {"bfloat16": "FLASH_ATTENTION",
                "float32": "EFFICIENT_ATTENTION"}
WIDE_HEADS = dict(n_heads=16, n_kv_heads=2, head_dim=256)
WIDE_LAYERS = 4
WIDE_PREFILL = (1, 2048)
# The wide kernels' guard: WIDE_GUARD_REPEATS launches of each on views
# whose rows have WIDE_GUARD_PAD NaN columns past d, with WIDE_GUARD_PAD NaN
# elements before and after each buffer
WIDE_GUARD_REPEATS, WIDE_GUARD_PAD = 20, 64
# The flash forward at the new head dims: (B, H, KV, T = S, d), causal
FLASH_DIM_SHAPES = {80: ("hubert-xlarge", (1, 16, 16, 2048, 80), False),
                    96: ("phi-3-vision-4.2b", (1, 32, 32, 2048, 96), True)}
# the tensor-core backward's other cases there: GQA (32 query heads over 8)
# at d 96, and a ragged bidirectional length (no multiple of 64) at d 80
FLASH_GQA_KV, FLASH_RAGGED_T = 8, 2000
# The other families: serve.py's loop (batch, prompt, gen: its defaults),
# prefill and forward shapes, decode steps, the depth cuts memory forces
FAMILY_SERVE = (4, 32, 16)
MAMBA2_PREFILL = (4, 1024)
# bsr_matmul on Mamba2's in_proj (2560 -> 10576, 661 block-rows): a decode
# step and its prefill
MAMBA2_KERNEL_ROWS = ((4, 1), (4, 1024))
EMBEDS_SHAPE = (1, 2048)
PHI3_DECODE = 16
DEEPSEEK_LAYERS, DEEPSEEK_SHAPE, DEEPSEEK_DECODE = 4, (1, 512), 8
JAMBA_LAYERS, JAMBA_SHAPE, JAMBA_DECODE = 2, (1, 1024), 8
EMBEDS_CONSIST_LAYERS, EMBEDS_CONSIST_SHAPE = 2, (1, 512)
# The families' training: B 1 x T 2048; DeepSeek-V3 cut to its first
# (dense) layer and the MTP block (a MoE layer's state is ~135 GB)
FAMILY_TRAIN_SHAPE = (1, 2048)
FAMILY_TRAIN_WARMUP, FAMILY_TRAIN_TIMED = 1, 3
DEEPSEEK_TRAIN_LAYERS = 1
REMAT_POLICIES = ("none", "dots", "full")
# The mesh: Qwen1.5-0.5B trained at full width and depth (B 4 x T 2048,
# bf16) on (1, 1) over NCCL, (1, 2) and (2, 1, 1) over gloo; OLMoE-1B-7B's
# EP forward at B 1 x T 2048 on (1, 2)
MESH_ARCH = "qwen1.5-0.5b"
MESH_TRAIN_SHAPE = (4, 2048)
MESH_STEPS = 3
MESH_MOE_SHAPE = (1, 2048)
MESH_CAPACITIES = (1.25, 2.0, 4.0, 8.0)  # raised until a path drops none
MESH_SPARSITY = 0.8
MESH_ONE_RTOL = 1e-5    # the (1, 1) mesh against the meshless step
# two ranks' bf16 partial sums in another order, against the meshless
# step: losses (5.2e-5 seen on (1, 2), 1.0e-5 on (2, 1, 1)) and grad norms
# (6.5e-4 and 5.4e-5 seen)
MESH_TP_RTOL = 1e-3
MESH_GNORM_RTOL = 2e-3
MESH_INT8_RTOL = 1e-2   # the loss under int8-rounded gradients
# the int8 step's grad norm against the norm of the compressed gradient
# computed apart from the step (the same state and batch)
MESH_INT8_NORM_RTOL = 1e-3
# the EP path's logits (bf16) may lie at most this many times as far from
# the f32 forward's (relative norm) as the one-rank bf16 gather forward's
MESH_LOGIT_FACTOR = 2.0
# f32 on the two ranks against f32 on one (relative norm): the EP forward's
# logits and the sparse prefill's last logits (5e-7 on the CPU)
MESH_F32_RTOL = 1e-4
MESH_BLOCK = (16, 16)   # sparsify_params's block: the ranks' pruning
# of the sparse prefill's 16 x 2048 token updates, how many may lie past
# MESH_F32_RTOL: tokens whose top-8 routing sits on a near-tie
MESH_ROUTING_FLIPS = 16
MESH_JOIN_S = 600       # the two ranks' world, start to join
# The meshed decode on the (1, 2) mesh, bf16, weights from the seed:
# Qwen1.5-0.5B at full width and depth serving a few requests (4 rows, a
# cache of 128, 32 prompt tokens fed one by one, then 32 greedy ones),
# dense and with each rank's shards pruned at MESH_SPARSITY (its KV heads
# over tp: 8 a rank); DeepSeek-V3 at full width cut to its first
# (dense-MLP) layer without the MTP head (decode never runs it; a MoE
# layer is ~22.5 GB), 96 steps, so that the latent cache's write (its
# sequence over tp, 64 positions a rank) crosses to rank 1 at position 64
MESH_DECODE_ROWS, MESH_DECODE_LEN, MESH_DECODE_PROMPT = 4, 128, 32
MESH_DECODE = (("qwen1.5-0.5b", False, 64), ("qwen1.5-0.5b", True, 64),
               ("deepseek-v3-671b", False, 96))
MESH_DECODE_PROJECTIONS = 7   # wq, wk, wv, wo, gate, up, down a layer
# a step's f32 logits on the two ranks (the shards cast) against one
# rank's meshless f32 decode on the same weights gathered whole, in units
# of max(1, max |logit|); bf16 takes MESH_LOGIT_FACTOR's rule
MESH_DECODE_F32_RTOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_cuda(torch, fn, reps: int, warmup: int) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, launches_per_call: int = 1) -> float:
    """Device milliseconds per call: the CUDA kernels of ``reps`` calls of
    ``fn`` (after one warm-up call), summed under ``torch.profiler``.  Host
    launch overhead is left out, which CUDA events around back-to-back
    launches do not do when a kernel is shorter than its launch.  Where the
    profiler records no device time, or fewer kernels than the calls
    launched (at least ``launches_per_call`` each), in PROFILE_TRIES tries,
    CUDA events time the calls instead (said on stderr).  A profile that
    sums to less than PROFILE_MIN_SHARE of the calls' CUDA-event time,
    where that time is at least PROFILE_LONG_MS a recorded kernel, dropped
    kernels too."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    event = None
    for _ in range(PROFILE_TRIES):  # the profiler drops kernels at times
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels)
        recorded = sum(e.count for e in kernels)
        if total > 0 and recorded >= reps * launches_per_call:
            ms = total / 1e3 / reps
            if event is None:
                event = time_cuda(torch, fn, reps=reps, warmup=0)
            if (event * reps / recorded < PROFILE_LONG_MS
                    or ms >= PROFILE_MIN_SHARE * event):
                return ms
    print(f"chip_smoke: the profiler recorded {recorded} kernels and "
          f"{total / 1e3} ms of device time for {reps} calls; timed with "
          f"CUDA events", file=sys.stderr, flush=True)
    return time_cuda(torch, fn, reps=reps, warmup=1)


class L2Flush:
    """Evicts the L2 between the calls of a cold timing: writes one
    L2_FLUSH_BYTES buffer, then reads another, so that no dirty line of
    the flush is written back during the timed call.  ``names`` are the
    flush's own kernels, which ``cold_device_ms`` leaves out."""


    def __init__(self, torch, device):
        n = L2_FLUSH_BYTES // 4
        self.w = torch.empty(n, device=device)
        self.r = torch.ones(n, device=device)
        self.names = set(_kernel_times(torch, self, 1))

    def __call__(self):
        self.w.fill_(1.0)
        self.r.sum()


def _kernel_times(torch, fn, reps: int) -> dict:
    """Kernel name -> (device ms, count) summed over ``reps`` calls of
    ``fn`` under ``torch.profiler``, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def cold_device_ms(torch, fns, reps: int, flush: L2Flush, first: str):
    """Device ms per call of each of ``fns`` with the L2 flushed before
    each call, all in one profiler session (flush, fns[0], flush, fns[1],
    ...): the first's kernels are those whose names hold ``first``, the
    second's the others that are not the flush's.  Where the profiler
    recorded fewer kernels than calls in PROFILE_TRIES tries, CUDA events
    recorded just before and after each call instead (said on stderr): the
    stream reaches them only once the flush before them has ended, so the
    host's launch time falls outside them."""
    def calls():
        for fn in fns:
            flush()
            fn()
    for _ in range(PROFILE_TRIES):
        times = _kernel_times(torch, calls, reps)
        parts = [[v for name, v in times.items() if first in name],
                 [v for name, v in times.items()
                  if first not in name and name not in flush.names]]
        if all(sum(n for _, n in part) >= reps for part in parts):
            return [sum(ms for ms, _ in part) / reps for part in parts]
    print(f"chip_smoke: the profiler recorded too few kernels for {reps} "
          f"cold calls; timed with CUDA events", file=sys.stderr, flush=True)
    out = []
    for fn in fns:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in pairs:
            flush()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        out.append(sum(s.elapsed_time(e) for s, e in pairs) / reps)
    return out


def bound(nbytes: float, flops_f32: float = 0.0, flops_bf16: float = 0.0,
          flops_tf32: float = 0.0):
    """The larger of the bytes over 3.35 TB/s and the operations over their
    peaks: f32 on the FMA units at 67 TFLOP/s, bf16 products with f32 sums
    on the tensor cores at 989 TFLOP/s, TF32 ones at 495 TFLOP/s."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops_f32 / PEAK_F32_FLOPS + flops_bf16 / PEAK_BF16_FLOPS
             + flops_tf32 / PEAK_TF32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_bytes(op, w, batch: int, itemsize: int = 4) -> int:
    """Bytes the conv itself must move, apart from its weights: the input
    elements it reads once (the unpadded input's channels that hold a nonzero
    weight, at the rows and columns some output reaches through a tap that
    holds one; a strided 1x1 conv reads only every stride-th row and column),
    the residual once and the output once, each of ``itemsize`` bytes (the
    activations' dtype), and the f32 bias once."""
    nz = w != 0
    chans = int(nz.any(dim=3).any(dim=2).any(dim=0).sum())
    taps_r = nz.any(dim=3).any(dim=1).any(dim=0).nonzero().flatten().tolist()
    taps_s = nz.any(dim=2).any(dim=1).any(dim=0).nonzero().flatten().tolist()
    rows = {e * op.stride + r - op.pad for e in range(op.e) for r in taps_r}
    cols = {f * op.stride + s - op.pad for f in range(op.f) for s in taps_s}
    rows = sum(0 <= i < op.h for i in rows)
    cols = sum(0 <= j < op.w for j in cols)
    out = batch * op.m * op.e * op.f
    return itemsize * (batch * chans * rows * cols
                       + (out if op.res is not None else 0) + out) + 4 * op.m


def device_breakdown(torch, fn, forward_ms: float, top: int = 6,
                     group=()) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time summed over
    the CUDA kernels it ran (one stream, so the sum is the busy time), the
    idle share of an unprofiled forward of ``forward_ms`` (the profiler's own
    host overhead would inflate a profiled wall time), and the kernels that
    took the most device time; with ``group``, also the device time of the
    kernels whose names hold one of its strings, its share of the busy
    time, and each such kernel's time and launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    out = {"device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / forward_ms),
           "kernel_launches": sum(k[2] for k in kernels),
           "top_kernels": [[name[:60], ms, n] for name, ms, n in kernels[:top]]}
    if group:
        members = [[name[:60], ms, n] for name, ms, n in kernels
                   if any(g in name for g in group)]
        group_ms = sum(ms for _, ms, _ in members)
        out.update(group_ms=group_ms,
                   group_share=group_ms / busy_ms if busy_ms else 0.0,
                   group_kernels=members)
    return out


def kernel_phase(torch, mods, nets, device, batch, seed):
    """Each kernel against its plain version at the listed layers; returns
    per-kernel lists of row dicts."""
    F = torch.nn.functional
    np = mods["np"]
    ops_ell, ops_bsr = mods["ops_ell"], mods["ops_bsr"]
    rows = {name: [] for name in CNN_NAMES}
    rng = np.random.default_rng(seed + 1)
    for net_name, layer in KERNEL_LAYERS:
        program, params = nets[net_name]
        op = {o.name: o for o in program.conv_ops}[layer]
        entry = params[layer]
        x = torch.from_numpy(rng.standard_normal(
            (batch, op.c, op.h, op.w)).astype(np.float32)).to(device)
        bias = torch.from_numpy(
            rng.standard_normal(op.m).astype(np.float32)).to(device)
        res = None
        if op.res is not None:
            res = torch.from_numpy(rng.standard_normal(
                (batch, op.m, op.e, op.f)).astype(np.float32)).to(device)
        xpad = mods["pad_in"](x, op.pad)
        w = entry["w"]

        def library():
            return F.conv2d(x, w, bias, stride=op.stride, padding=op.pad)

        library_ms = time_cuda(torch, library, reps=20, warmup=3)
        library_device_ms = device_ms(torch, library, reps=10)

        # -- ELL direct sparse conv --------------------------------------
        ell = entry["ell"]
        packed = ops_ell.pack_indices(ell)
        args = (xpad, ell.value, packed, ell.nnz, bias, res)
        kw = dict(rs=op.k * op.k, s=op.k, e=op.e, f=op.f, stride=op.stride,
                  fuse_relu=op.fuse_relu)
        geo = dict(n=batch, c=op.c, r=op.k, s=op.k, stride=op.stride,
                   hp=xpad.shape[2], wp=xpad.shape[3])
        sched, reason = ops_ell.resolve_schedule(op.m, ell.k, op.e, op.f,
                                                 **geo)
        check(sched is not None, f"{layer}: no ELL schedule ({reason})")
        blocking, _ = ops_ell.resolve_schedule(op.m, ell.k, op.e, op.f,
                                               pipeline=False, **geo)
        want = mods["ell_plain"](*args, **kw)
        got = {}
        for sc in (sched, blocking):
            got[sc.pipeline] = mods["ell_kernel"](*args, schedule=sc, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got[sc.pipeline], want),
                  f"{layer}: ELL kernel ({'pipelined' if sc.pipeline else 'blocking'}) "
                  f"not bit-identical to its plain version (max_abs_err "
                  f"{float((got[sc.pipeline] - want).abs().max())})")
        check(torch.equal(got[True], got[False]) if sched.pipeline else True,
              f"{layer}: pipelined and blocking ELL kernels differ")
        err = float((got[sched.pipeline] - want).abs().max())
        ms = time_cuda(torch, lambda: mods["ell_kernel"](
            *args, schedule=sched, **kw), reps=20, warmup=3)
        dev_ms = device_ms(torch, lambda: mods["ell_kernel"](
            *args, schedule=sched, **kw), reps=10)
        blocking_ms = time_cuda(torch, lambda: mods["ell_kernel"](
            *args, schedule=blocking, **kw), reps=20, warmup=3)
        plain_ms = time_cuda(torch, lambda: mods["ell_plain"](*args, **kw),
                             reps=2, warmup=1)
        nnz_total = int(ell.nnz.sum())
        act_bytes = conv_bytes(op, w, batch)
        moved = act_bytes + nnz_total * 8 + ell.nnz.numel() * 4
        b_ms, b_by = bound(moved, 2.0 * nnz_total * batch * op.e * op.f)
        row = {"kernel": "sparse_conv", "net": net_name, "layer": layer,
               "shape": {"n": batch, "c": op.c, "h": op.h, "m": op.m,
                         "k": op.k, "stride": op.stride, "pad": op.pad,
                         "nnz": nnz_total, "K": ell.k, "residual":
                         res is not None},
               "schedule": dataclasses.asdict(sched),
               "bit_identical": True, "max_abs_err": err, "kernel_ms": ms,
               "blocking_ms": blocking_ms, "kernel_device_ms": dev_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_ms": library_device_ms, "bound_ms": b_ms,
               "bound_by": b_by, "bound_bytes": moved}
        print(json.dumps(row), flush=True)
        rows["sparse_conv"].append(row)
        f32_row = row

        # -- the ELL kernel on quantised banks: bit for bit the f32 kernel
        # on the dequantised bank (and the plain version), both schedules
        for name, vdt in ELL_VARIANTS:
            q = mods["quantize"](ell, vdt)
            d = mods["dequantize"](q)
            qargs = (xpad, q.value, packed, q.nnz, bias, res)
            dargs = (xpad, d.value, packed, d.nnz, bias, res)
            want = mods["ell_plain"](*qargs, scale=q.scale, **kw)
            for sc in (sched, blocking):
                gq = mods["ell_kernel"](*qargs, schedule=sc, scale=q.scale,
                                        **kw)
                gd = mods["ell_kernel"](*dargs, schedule=sc, **kw)
                torch.cuda.synchronize()
                check(torch.equal(gq, gd) and torch.equal(gq, want),
                      f"{layer}: ELL kernel on the {vdt} bank "
                      f"({'pipelined' if sc.pipeline else 'blocking'}) not "
                      f"bit-identical to the f32 kernel on the dequantised "
                      f"bank (max_abs_err {float((gq - gd).abs().max())}) "
                      f"or its plain version")
            run = lambda sc=sched: mods["ell_kernel"](  # noqa: E731
                *qargs, schedule=sc, scale=q.scale, **kw)
            ms = time_cuda(torch, run, reps=20, warmup=3)
            dev_ms = device_ms(torch, run, reps=10)
            blocking_ms = time_cuda(torch, lambda: run(blocking), reps=20,
                                    warmup=3)
            plain_ms = time_cuda(torch, lambda: mods["ell_plain"](
                *qargs, scale=q.scale, **kw), reps=2, warmup=1)
            # the dequantised weights, dense, for the library yardstick
            wq = torch.zeros((op.m, op.c * op.k * op.k), device=device)
            wq.scatter_add_(1, packed.long(), d.value)
            wq = wq.view(op.m, op.c, op.k, op.k)
            lib = lambda: F.conv2d(x, wq, bias, stride=op.stride,  # noqa: E731
                                   padding=op.pad)
            lib_ms = time_cuda(torch, lib, reps=20, warmup=3)
            # one 32-bit word a nonzero and the scale row, where the f32
            # bank streams 8 bytes a nonzero; the same operations
            moved = act_bytes + nnz_total * 4 + ell.nnz.numel() * 4 + op.m * 4
            b_ms, b_by = bound(moved, 2.0 * nnz_total * batch * op.e * op.f)
            vrow = {"kernel": name, "net": net_name, "layer": layer,
                    "value_dtype": vdt,
                    "schedule": dataclasses.asdict(sched),
                    "bit_identical": True, "max_abs_err": 0.0,
                    "kernel_ms": ms, "blocking_ms": blocking_ms,
                    "kernel_device_ms": dev_ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "bound_bytes": moved,
                    "f32_ms": f32_row["kernel_ms"]}
            print(json.dumps(vrow), flush=True)
            rows[name].append(vrow)

        # -- BCSR block-sparse conv --------------------------------------
        bc = mods["bcsr_from_dense"](w.cpu().numpy(), block=mods["block"],
                                     device=device)
        halves = mods["split_weights"](bc.blocks)
        gbm, kb_dim, bm, bn = bc.blocks.shape
        mpad = gbm * bm
        tile, reason = ops_bsr.resolve_bsr_schedule(
            bm, bn, op.e, op.f, n=batch, m=mpad, crs=op.c * op.k * op.k)
        check(tile is not None, f"{layer}: no BCSR schedule ({reason})")
        bpad = torch.zeros(mpad, device=device)
        bpad[:op.m] = bias
        rpad = None
        if res is not None:
            rpad = torch.zeros((batch, mpad, op.e, op.f), device=device)
            rpad[:, :op.m] = res
        bargs = (xpad, bc.blocks, bc.blockcol, bc.nblocks, bpad, rpad)
        bkw = dict(kw, n_tile=tile[0], wgs=tile[1], halves=halves)
        got = mods["bsr_kernel"](*bargs, **bkw)
        torch.cuda.synchronize()
        want = mods["bsr_plain"](*bargs, **kw)
        limit = BSR_TOL * (1 + float(want.abs().max()))
        err = float((got - want).abs().max())
        split_err = float((mods["bsr_split_plain"](*bargs, **kw)
                           - want).abs().max())
        control_err = float((mods["bsr_split_plain"](*bargs, lo=False, **kw)
                             - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"{layer}: BCSR kernel not finite")
        check(err <= limit,
              f"{layer}: BCSR kernel disagrees with its plain version "
              f"(max_abs_err {err}, tolerance {limit})")
        check(control_err > limit,
              f"{layer}: the BCSR check does not reject one product on "
              f"operands rounded once ({control_err} <= {limit})")
        ms = time_cuda(torch, lambda: mods["bsr_kernel"](*bargs, **bkw),
                       reps=20, warmup=3)
        dev_ms = device_ms(torch, lambda: mods["bsr_kernel"](*bargs, **bkw),
                           reps=10)
        plain_ms = time_cuda(torch, lambda: mods["bsr_plain"](*bargs, **kw),
                             reps=2, warmup=1)
        kept = int(bc.nblocks.sum())
        moved = act_bytes + kept * bm * bn * 4 + kept * 4 + gbm * 4
        flops = 2.0 * kept * bm * bn * batch * op.e * op.f
        b_ms, b_by = bound(moved, flops)
        tc_ms, tc_by = bound(moved, flops_tf32=3 * flops)
        row = {"kernel": "bsr_conv", "net": net_name, "layer": layer,
               "shape": {"n": batch, "c": op.c, "h": op.h, "m": op.m,
                         "k": op.k, "stride": op.stride, "pad": op.pad,
                         "block": [bm, bn], "kept_tiles": kept,
                         "tiles": gbm * (-(-op.c * op.k * op.k // bn)),
                         "residual": res is not None},
               "schedule": {"n_tile": tile[0], "warpgroups": tile[1],
                            "pixels": 64 * tile[1]},
               "max_abs_err": err, "tolerance": limit,
               "split_plain_err": split_err, "control_err": control_err,
               "kernel_ms": ms, "kernel_device_ms": dev_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_ms": library_device_ms, "bound_ms": b_ms,
               "bound_by": b_by, "bound_tc_ms": tc_ms, "bound_tc_by": tc_by,
               "bound_bytes": moved}
        print(json.dumps(row), flush=True)
        rows["bsr_conv"].append(row)
        f32_row = row

        # -- the BCSR kernel on quantised banks and at taller blocks ------
        for name, vdt, block in BSR_VARIANTS:
            bc = mods["bcsr_from_dense"](w.cpu().numpy(), block=block,
                                         device=device)
            if vdt is not None:
                bc = mods["quantize"](bc, vdt)
            halves = None if vdt else mods["split_weights"](bc.blocks)
            gbm, kb_dim, bm, bn = bc.blocks.shape
            mpad = gbm * bm
            tile, reason = ops_bsr.resolve_bsr_schedule(
                bm, bn, op.e, op.f, n=batch, m=mpad,
                crs=op.c * op.k * op.k, value_dtype=bc.value_dtype)
            check(tile is not None,
                  f"{layer}: no BCSR schedule for {name} ({reason})")
            bpad = torch.zeros(mpad, device=device)
            bpad[:op.m] = bias
            rpad = None
            if res is not None:
                rpad = torch.zeros((batch, mpad, op.e, op.f), device=device)
                rpad[:, :op.m] = res
            bargs = (xpad, bc.blocks, bc.blockcol, bc.nblocks, bpad, rpad)
            vkw = dict(kw, scale=bc.scale)
            bkw = dict(vkw, n_tile=tile[0], wgs=tile[1], halves=halves)
            got = mods["bsr_kernel"](*bargs, **bkw)
            torch.cuda.synchronize()
            want = mods["bsr_plain"](*bargs, **vkw)
            limit = BSR_TOL * (1 + float(want.abs().max()))
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()),
                  f"{layer}: {name} not finite")
            check(err <= limit, f"{layer}: {name} disagrees with its plain "
                  f"version (max_abs_err {err}, tolerance {limit})")
            ms = time_cuda(torch, lambda: mods["bsr_kernel"](*bargs, **bkw),
                           reps=20, warmup=3)
            dev_ms = device_ms(torch, lambda: mods["bsr_kernel"](
                *bargs, **bkw), reps=10)
            plain_ms = time_cuda(torch, lambda: mods["bsr_plain"](
                *bargs, **vkw), reps=2, warmup=1)
            wq = mods["bcsr_to_dense"](bc)
            lib = lambda: F.conv2d(x, wq, bias, stride=op.stride,  # noqa: E731
                                   padding=op.pad)
            lib_ms = time_cuda(torch, lib, reps=20, warmup=3)
            kept = int(bc.nblocks.sum())
            width = 1 if vdt else 4
            moved = (act_bytes + kept * bm * bn * width + kept * 4 + gbm * 4
                     + (mpad * 4 if vdt else 0))
            flops = 2.0 * kept * bm * bn * batch * op.e * op.f
            b_ms, b_by = bound(moved, flops)
            # a quantised tile is exact in TF32: two products, not three
            tc_ms, tc_by = bound(moved, flops_tf32=(2 if vdt else 3) * flops)
            vrow = {"kernel": name, "net": net_name, "layer": layer,
                    "value_dtype": vdt or "float32", "block": [bm, bn],
                    "kept_tiles": kept,
                    "schedule": {"n_tile": tile[0], "warpgroups": tile[1]},
                    "max_abs_err": err, "tolerance": limit,
                    "kernel_ms": ms, "kernel_device_ms": dev_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": tc_ms,
                    "bound_tc_by": tc_by, "bound_bytes": moved,
                    "f32_ms": f32_row["kernel_ms"]}
            print(json.dumps(vrow), flush=True)
            rows[name].append(vrow)
    return rows


def _one_ulp_bf16(got, want) -> float:
    """The largest |got - want| as a share of one bf16 ulp's allowance,
    2^-7 |want| + 2^-8 max(1, max |want|) (<= 1 passes)."""
    g, w = got.float(), want.float()
    tol = 2.0 ** -7 * w.abs() + 2.0 ** -8 * max(1.0, float(w.abs().max()))
    return float(((g - w).abs() / tol).max())


def _bf16_vs_f32(got, want) -> float:
    """The largest |got - want| as a share of BF16_TOL (1 + |want|)."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (BF16_TOL * (1 + w.abs()))).max())


def _even_slab(torch, mods, op, xpad):
    """A bf16 padded input as ``ops.sparse_conv`` gives it to the staged
    kernel: one more zero column where its width is odd."""
    wp = xpad.shape[3]
    if op.k == 1:
        return xpad
    return torch.nn.functional.pad(xpad, (0, mods["slab_width"](wp, 2) - wp))


def _ell_plain_bf16(torch, mods, op, xpad, ell, bias, res):
    """The ELL plain version on the operands ``ops.sparse_conv`` gives the
    kernel at bf16."""
    xpad = _even_slab(torch, mods, op, xpad)
    return mods["ell_plain"](
        xpad, ell.value, mods["ops_ell"].pack_indices(ell), ell.nnz, bias,
        res, rs=op.k * op.k, s=op.k, e=op.e, f=op.f, stride=op.stride,
        fuse_relu=op.fuse_relu)


def bf16_phase(torch, mods, nets, device, batch, seed, f32_rows):
    """The two conv kernels on bf16 activations: ResNet-50's 39 sparse convs
    counted through both ops, each output held to its plain version and to
    the f32 kernel; then rows 1c and 2e timed at ``KERNEL_LAYERS`` (beside
    the kernel phase's f32 rows, ``f32_rows``).  Returns (rows by kernel,
    launches by kernel)."""
    np, dc = mods["np"], dataclasses
    F = torch.nn.functional
    ops_ell, ops_bsr = mods["ops_ell"], mods["ops_bsr"]
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 23)

    def operands(net_name, op):
        entry = nets[net_name][1][op.name]
        x = torch.from_numpy(rng.standard_normal(
            (batch, op.c, op.h, op.w)).astype(np.float32)).to(device)
        bias = torch.from_numpy(
            rng.standard_normal(op.m).astype(np.float32)).to(device)
        res = (torch.from_numpy(rng.standard_normal(
            (batch, op.m, op.e, op.f)).astype(np.float32)).to(device)
            if op.res is not None else None)
        # the bf16 banks, and the same weights widened for the f32 kernels
        ell16 = dc.replace(entry["ell"], value=entry["ell"].value.to(bf16))
        bc = mods["bcsr_from_dense"](entry["w"].cpu().numpy(),
                                     block=mods["block"], device=device)
        bc16 = dc.replace(bc, blocks=bc.blocks.to(bf16))
        return dict(op=op, w=entry["w"], x=x, bias=bias, res=res,
                    ell=dc.replace(ell16, value=ell16.value.float()),
                    bc=dc.replace(bc16, blocks=bc16.blocks.float()),
                    x16=x.to(bf16),
                    res16=None if res is None else res.to(bf16),
                    ell16=ell16, bc16=bc16)

    def run(L, bf, kind):
        op = L["op"]
        kw = dict(stride=op.stride, padding=op.pad, bias=L["bias"],
                  fuse_relu=op.fuse_relu,
                  residual=L["res16"] if bf else L["res"])
        x = L["x16"] if bf else L["x"]
        if kind == "ell":
            return ops_ell.sparse_conv(x, L["ell16"] if bf else L["ell"],
                                       layer=op.name, **kw)
        return ops_bsr.bsr_conv(x, L["bc16"] if bf else L["bc"],
                                layer=op.name, **kw)

    program = nets["resnet50"][0]
    layers = [operands("resnet50", op) for op in program.conv_ops
              if op.sparsity > 0]
    n = len(layers)
    check(n == EXPECTED_SPARSE["resnet50"],
          f"bf16: {n} sparse convs, expected {EXPECTED_SPARSE['resnet50']}")
    for L in layers:          # warm-up: stretched banks, column checks
        run(L, True, "ell"), run(L, True, "bsr")
    torch.cuda.synchronize()
    reset_counts(mods)
    outs = [(run(L, True, "ell"), run(L, True, "bsr")) for L in layers]
    torch.cuda.synchronize()
    counts = read_counts(mods)
    want = expect(sparse_conv=n, sparse_conv_bf16=n, bsr_conv=n,
                  bsr_conv_bf16=n)
    check(counts == want, f"bf16: kernel launches {counts}, expected {want}")
    worst = {"ell_plain": 0.0, "bsr_plain_ulps": 0.0, "ell_vs_f32": 0.0,
             "bsr_vs_f32": 0.0}
    for L, (ye, yb) in zip(layers, outs):
        op = L["op"]
        check(ye.dtype == yb.dtype == bf16, f"bf16 {op.name}: output dtype "
              f"{ye.dtype} / {yb.dtype}")
        check(bool(torch.isfinite(ye).all() and torch.isfinite(yb).all()),
              f"bf16 {op.name}: non-finite output")
        pe = _ell_plain_bf16(torch, mods, op,
                             mods["pad_in"](L["x16"], op.pad),
                             L["ell16"], L["bias"], L["res16"])
        err = float((ye.float() - pe.float()).abs().max())
        check(torch.equal(ye, pe), f"bf16 {op.name}: ELL kernel not bit for "
              f"bit its plain version (max_abs_err {err})")
        pb = mods["bsr_blocked_ref"](L["x16"], L["bc16"], stride=op.stride,
                                     padding=op.pad, bias=L["bias"],
                                     fuse_relu=op.fuse_relu,
                                     residual=L["res16"])
        ulps = _one_ulp_bf16(yb, pb)
        check(ulps <= 1.0, f"bf16 {op.name}: BCSR kernel past one bf16 ulp "
              f"of its plain version ({ulps:.3f} of the allowance)")
        e32 = _bf16_vs_f32(ye, run(L, False, "ell"))
        b32 = _bf16_vs_f32(yb, run(L, False, "bsr"))
        check(e32 <= 1.0 and b32 <= 1.0, f"bf16 {op.name}: past {BF16_TOL} "
              f"of the f32 kernels (ELL {e32:.3f}, BCSR {b32:.3f} of it)")
        for key, v in (("ell_plain", err), ("bsr_plain_ulps", ulps),
                       ("ell_vs_f32", e32), ("bsr_vs_f32", b32)):
            worst[key] = max(worst[key], v)
    outs.clear()
    layers.clear()

    rows = {"sparse_conv_bf16": [], "bsr_conv_bf16": []}
    for net_name, layer in KERNEL_LAYERS:
        op = {o.name: o for o in nets[net_name][0].conv_ops}[layer]
        L = operands(net_name, op)
        kw = dict(rs=op.k * op.k, s=op.k, e=op.e, f=op.f, stride=op.stride,
                  fuse_relu=op.fuse_relu)
        w16 = L["w"].to(bf16)
        b16 = L["bias"].to(bf16)
        lib = lambda: F.conv2d(L["x16"], w16, b16, stride=op.stride,  # noqa: E731
                               padding=op.pad)
        lib_ms = time_cuda(torch, lib, reps=20, warmup=3)
        act = conv_bytes(op, L["w"], batch, itemsize=2)
        flops_per = batch * op.e * op.f
        f32_ms = {k: next(r["kernel_ms"] for r in f32_rows[k]
                          if (r["net"], r["layer"]) == (net_name, layer))
                  for k in ("sparse_conv", "bsr_conv")}

        # -- 1c: the ELL kernel on a bf16 bank and bf16 activations ------
        ell = L["ell16"]
        xpad = _even_slab(torch, mods, op, mods["pad_in"](L["x16"], op.pad))
        args = (xpad, ell.value, ops_ell.pack_indices(ell), ell.nnz,
                L["bias"], L["res16"])
        sched, reason = ops_ell.resolve_schedule(
            op.m, ell.k, op.e, op.f, n=batch, c=op.c, r=op.k, s=op.k,
            stride=op.stride, hp=op.h + 2 * op.pad, wp=op.w + 2 * op.pad,
            itemsize=2, paired=True)
        check(sched is not None, f"bf16 {layer}: no ELL schedule ({reason})")
        got = mods["ell_kernel"](*args, schedule=sched, **kw)
        plain = mods["ell_plain"](*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, plain),
              f"bf16 {layer}: ELL kernel not bit for bit its plain version")
        run_ell = lambda: mods["ell_kernel"](  # noqa: E731
            *args, schedule=sched, **kw)
        ms = time_cuda(torch, run_ell, reps=20, warmup=3)
        dev_ms = device_ms(torch, run_ell, reps=10)
        plain_ms = time_cuda(torch, lambda: mods["ell_plain"](*args, **kw),
                             reps=2, warmup=1)
        nnz = int(ell.nnz.sum())
        # a bf16 value and an int32 index a nonzero, the row lengths
        moved = act + nnz * 6 + ell.nnz.numel() * 4
        # bf16 products summed in f32: the card's bf16 peak prices them;
        # the f32 FMA units' peak and ELL_FLOPS are extra columns
        b_ms, b_by = bound(moved, flops_bf16=2.0 * nnz * flops_per)
        fma_ms, _ = bound(moved, flops_f32=2.0 * nnz * flops_per)
        ell_ms = max(moved / PEAK_BYTES, 2.0 * nnz * flops_per
                     / mods["roofline"].ELL_FLOPS) * 1e3
        words, paired = mods["ell_entry_format"](
            ell.value.dtype, 2, op.k * op.k, op.k, xpad.shape[3], sched)
        row = {"kernel": "sparse_conv_bf16", "net": net_name,
               "layer": layer, "schedule": dataclasses.asdict(sched),
               "bf16_words": words, "paired": paired,
               "bit_identical": True, "max_abs_err": 0.0, "kernel_ms": ms,
               "kernel_device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_f32_fma_ms": fma_ms, "bound_ell_ms": ell_ms,
               "bound_bytes": moved,
               "f32_ms": f32_ms["sparse_conv"]}
        print(json.dumps(row), flush=True)
        rows["sparse_conv_bf16"].append(row)

        # -- 2e: the BCSR kernel on bf16 tiles, one bf16 wgmma a step -----
        bc = L["bc16"]
        gbm, _, bm, bn = bc.blocks.shape
        mpad = gbm * bm
        tile, reason = ops_bsr.resolve_bsr_schedule(
            bm, bn, op.e, op.f, n=batch, m=mpad, crs=op.c * op.k * op.k,
            value_dtype=bc.value_dtype, itemsize=2)
        check(tile is not None, f"bf16 {layer}: no BCSR schedule ({reason})")
        bpad = torch.zeros(mpad, device=device)
        bpad[:op.m] = L["bias"]
        rpad = None
        if L["res16"] is not None:
            rpad = torch.zeros((batch, mpad, op.e, op.f), dtype=bf16,
                               device=device)
            rpad[:, :op.m] = L["res16"]
        bargs = (mods["pad_in"](L["x16"], op.pad), bc.blocks, bc.blockcol,
                 bc.nblocks, bpad, rpad)
        bkw = dict(kw, n_tile=tile[0], wgs=tile[1])
        got = mods["bsr_kernel"](*bargs, **bkw)
        plain = mods["bsr_plain"](*bargs, **kw)
        torch.cuda.synchronize()
        ulps = _one_ulp_bf16(got, plain)
        check(ulps <= 1.0, f"bf16 {layer}: BCSR kernel past one bf16 ulp")
        run_bsr = lambda: mods["bsr_kernel"](*bargs, **bkw)  # noqa: E731
        ms = time_cuda(torch, run_bsr, reps=20, warmup=3)
        dev_ms = device_ms(torch, run_bsr, reps=10)
        plain_ms = time_cuda(torch, lambda: mods["bsr_plain"](*bargs, **kw),
                             reps=2, warmup=1)
        kept = int(bc.nblocks.sum())
        moved = act + kept * bm * bn * 2 + kept * 4 + gbm * 4
        b_ms, b_by = bound(moved, flops_bf16=2.0 * kept * bm * bn * flops_per)
        row = {"kernel": "bsr_conv_bf16", "net": net_name, "layer": layer,
               "schedule": {"n_tile": tile[0], "warpgroups": tile[1]},
               "max_abs_err": float((got.float() - plain.float()).abs()
                                    .max()),
               "ulp_share": ulps, "kernel_ms": ms, "kernel_device_ms": dev_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by, "bound_tc_ms": b_ms, "bound_bytes": moved,
               "f32_ms": f32_ms["bsr_conv"]}
        print(json.dumps(row), flush=True)
        rows["bsr_conv_bf16"].append(row)
    print(json.dumps({"phase": "bf16", "layers": n, "launches": counts,
                      "worst": worst,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return rows, {name: counts[name] for name in KERNEL_NAMES}


def path_phase(torch, mods, nets, device, batch, image, seed):
    """Full-width forwards through ``cnn_forward``; returns launches per
    kernel over the counted forwards."""
    np = mods["np"]
    cnn = mods["cnn"]
    launches = {"sparse_conv": 0, "bsr_conv": 0}
    rng = np.random.default_rng(seed + 2)
    for net_name in ("resnet50", "googlenet", "alexnet"):
        program, params = nets[net_name]
        net = cnn.NETWORKS[net_name]()
        sparse = [op for op in program.conv_ops if op.sparsity > 0]
        check(len(sparse) == EXPECTED_SPARSE[net_name],
              f"{net_name}: {len(sparse)} sparse convs, expected "
              f"{EXPECTED_SPARSE[net_name]}")
        x = torch.from_numpy(rng.standard_normal(
            (batch, 3, image, image)).astype(np.float32)).to(device)
        out = {}
        for method in ("dense", "pallas", "bsr"):
            # warm-up: cuDNN's algorithm choice and the BCSR banks, built
            # once per layer on first use, stay out of the counted forward
            cnn.cnn_forward(net, params, x, method)
            torch.cuda.synchronize()
            reset_counts(mods)
            y = cnn.cnn_forward(net, params, x, method)
            torch.cuda.synchronize()
            counts = read_counts(mods)
            want = {name: 0 for name in KERNEL_NAMES}
            want.update({"pallas": {"sparse_conv": len(sparse)},
                         "bsr": {"bsr_conv": len(sparse)}}.get(method, {}))
            check(counts == want, f"{net_name}/{method}: kernel launches "
                  f"{counts}, expected {want}")
            for name in launches:
                launches[name] += counts[name]
            check(tuple(y.shape) == (batch, 1000),
                  f"{net_name}/{method}: output shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()),
                  f"{net_name}/{method}: non-finite output")
            t0 = time.perf_counter()
            reps = 3
            for _ in range(reps):
                cnn.cnn_forward(net, params, x, method)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) / reps * 1e3
            out[method] = y
            row = {"phase": "path", "net": net_name, "method": method,
                   "batch": batch, "image": image, "launches": counts,
                   "forward_ms": fwd_ms}
            row.update(device_breakdown(
                torch, lambda: cnn.cnn_forward(net, params, x, method),
                fwd_ms))
            if method != "dense":
                err = float((y - out["dense"]).abs().max())
                scale = float(out["dense"].abs().max())
                row.update(max_abs_err_vs_dense=err, dense_absmax=scale)
                check(err <= PATH_RTOL * max(1.0, scale),
                      f"{net_name}/{method}: disagrees with dense "
                      f"(max_abs_err {err}, tolerance {PATH_RTOL}*"
                      f"max(1, {scale}))")
            print(json.dumps(row), flush=True)
    return launches



def _copy_params(params):
    """A params dict whose layer entries are copies (the tensors shared), so
    that ``apply_plan_to_params`` adds its banks to the copy only."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in params.items()}


def _plan_counts(plan, program):
    """The launches a forward under ``plan`` must make, by counter."""
    want = {name: 0 for name in KERNEL_NAMES}
    for op in program.conv_ops:
        pe = plan[op.name]
        if op.sparsity <= 0 or pe.method not in ("pallas", "bsr"):
            continue
        kernel = "sparse_conv" if pe.method == "pallas" else "bsr_conv"
        want[kernel] += 1
        if pe.value_dtype != "float32":
            want[kernel + ("_int8" if pe.value_dtype == "int8"
                           else "_e4m3")] += 1
        if pe.method == "bsr" and pe.block_m in (32, 64):
            want[f"bsr_conv_bm{pe.block_m}"] += 1
    return want


def _layers(plan):
    out = {}
    for pe in plan.values():
        key = pe.method + ("" if pe.method != "bsr" else
                           f"/{pe.block_m}") + f"/{pe.value_dtype}"
        out[key] = out.get(key, 0) + 1
    return out


def auto_phase(torch, mods, nets, device, batch, image, seed):
    """``method="auto"`` at full width: each net under the engine's own
    roofline plan, a ``quantize=True`` roofline plan, and a plan pinning
    the ELL kernel on int8 and e4m3 banks; block-pruned ResNet-50 under
    its roofline plans and a plan pinning the tall BCSR blocks; AlexNet
    tuned in wall mode on the card, saved under ``build/``, reloaded and
    run.  Returns the CNN counters' launches over the counted forwards and
    each net's roofline plan."""
    np, cnn = mods["np"], mods["cnn"]
    tun = mods["tuning"]
    t_phase = time.perf_counter()
    launches = {name: 0 for name in CNN_NAMES}
    rng = np.random.default_rng(seed + 4)

    def fwd_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def run(label, net_name, eng, x, plan, dense, quantised):
        """Warm-up (plan, banks), one counted forward, checks, the row."""
        eng(x, "auto")
        torch.cuda.synchronize()
        reset_counts(mods)
        y = eng(x, "auto")
        torch.cuda.synchronize()
        counts = read_counts(mods)
        plan = plan if plan is not None else eng._auto_plans[batch]
        want = _plan_counts(plan, eng.program)
        check(counts == want, f"{net_name}/{label}: launches {counts}, "
              f"expected {want}")
        for name in CNN_NAMES:
            launches[name] += counts[name]
        report = eng.execution_report(x, "auto")
        check(report.fallback_count == 0, f"{net_name}/{label}: "
              f"{report.fallback_count} fallbacks\n{report.format()}")
        check(tuple(y.shape) == (batch, 1000) and bool(
            torch.isfinite(y).all()), f"{net_name}/{label}: bad output")
        ms = fwd_ms(lambda: eng(x, "auto"))
        row = {"phase": "auto", "net": net_name, "plan": label,
               "batch": batch, "image": image, "layers": _layers(plan),
               "launches": {k: v for k, v in counts.items() if v},
               "forward_ms": ms,
               "report": {"fallback_count": report.fallback_count,
                          "methods_executed": report.methods_executed,
                          "roofline_est_ms": report.est_s * 1e3}}
        row.update(device_breakdown(torch, lambda: eng(x, "auto"), ms))
        scale = float(dense.abs().max())
        err = float((y - dense).abs().max())
        rel = float(torch.linalg.norm(y - dense) / torch.linalg.norm(dense))
        row.update(max_abs_err_vs_dense=err, dense_absmax=scale,
                   rel_norm_vs_dense=rel)
        if quantised:
            check(rel < QUANT_REL_TOL, f"{net_name}/{label}: relative norm "
                  f"{rel} against dense, limit {QUANT_REL_TOL}")
        else:
            check(err <= PATH_RTOL * max(1.0, scale),
                  f"{net_name}/{label}: disagrees with dense (max_abs_err "
                  f"{err}, tolerance {PATH_RTOL}*max(1, {scale}))")
        print(json.dumps(row), flush=True)
        return row

    def method_ms(net, params, x):
        out = {}
        for method in ("dense", "pallas", "bsr"):
            out[method] = fwd_ms(lambda: cnn.cnn_forward(net, params, x,
                                                         method))
        return out

    def pinned(program, plan, make):
        """``plan`` with its i-th sparse layer's entry ``make(i)``."""
        out = dict(plan)
        sparse = [op for op in program.conv_ops if op.sparsity > 0]
        for i, op in enumerate(sparse):
            out[op.name] = make(i)
        return out

    roofline = {}
    for net_name in ("resnet50", "googlenet", "alexnet"):
        program, params = nets[net_name]
        net = cnn.NETWORKS[net_name]()
        x = torch.from_numpy(rng.standard_normal(
            (batch, 3, image, image)).astype(np.float32)).to(device)
        dense = cnn.cnn_forward(net, params, x, "dense")
        # the engine's own roofline plan, priced from the bound weights
        eng = cnn.engine_for(net, params, tuple(x.shape[1:]))
        run("roofline", net_name, eng, x, None, dense, False)
        roofline[net_name] = eng._auto_plans[batch]
        # quantize=True: narrow value streams where the roofline likes them
        qplan = tun.plan_program(program, batch=batch, params=params,
                                 quantize=True, device=device)
        qparams = tun.apply_plan_to_params(_copy_params(params), qplan)
        run("roofline-quantised", net_name,
            mods["CnnEngine"](program, qparams, qplan, device=device), x,
            qplan, dense, True)
        # the ELL kernel on its quantised banks: int8 and e4m3 by turns
        eplan = pinned(program, qplan, lambda i: mods["PlanEntry"](
            method="pallas", fuse=True, pipeline=True, source="pinned",
            value_dtype=("int8", "float8_e4m3fn")[i % 2]))
        eparams = tun.apply_plan_to_params(_copy_params(params), eplan)
        run("ell-int8-e4m3-pinned", net_name,
            mods["CnnEngine"](program, eparams, eplan, device=device), x,
            eplan, dense, True)
        del qparams, eparams
        torch.cuda.empty_cache()

    # block-pruned ResNet-50: every sparse layer pruned in (64, 128) tiles
    # at its sparsity, so that the BCSR banks keep that fraction of tiles
    program, params = nets["resnet50"]
    net = cnn.NETWORKS["resnet50"]()
    wrng = np.random.default_rng(seed + 5)
    np_params = {"_fc_rng": params["_fc_rng"]}
    for op in program.conv_ops:
        w = (wrng.standard_normal((op.m, op.c, op.k, op.k)).astype(np.float32)
             * (2.0 / (op.c * op.k * op.k)) ** 0.5)
        if op.sparsity > 0:
            w = mods["block_prune_conv"](w, op.sparsity, BLOCK_PRUNE)
        np_params[op.name] = {"w": w, "b": np.zeros(op.m, np.float32)}
    bparams = mods["params_from_reference"](np_params, device=device)
    x = torch.from_numpy(rng.standard_normal(
        (batch, 3, image, image)).astype(np.float32)).to(device)
    dense = cnn.cnn_forward(net, bparams, x, "dense")
    eng = cnn.engine_for(net, bparams, tuple(x.shape[1:]))
    row = run("roofline", "resnet50-block-pruned", eng, x, None, dense,
              False)
    bplan = eng._auto_plans[batch]
    qplan = tun.plan_program(program, batch=batch, params=bparams,
                             quantize=True, device=device)
    qparams = tun.apply_plan_to_params(_copy_params(bparams), qplan)
    run("roofline-quantised", "resnet50-block-pruned",
        mods["CnnEngine"](program, qparams, qplan, device=device), x, qplan,
        dense, True)
    # the tall blocks on the path: bm 32 and 64, f32 and quantised, by turns
    cycle = ((32, "float32"), (64, "float32"), (32, "float8_e4m3fn"),
             (64, "int8"))
    tplan = pinned(program, bplan, lambda i: mods["PlanEntry"](
        method="bsr", block_m=cycle[i % 4][0], block_n=128, fuse=True,
        value_dtype=cycle[i % 4][1], source="pinned"))
    tparams = tun.apply_plan_to_params(_copy_params(bparams), tplan)
    trow = run("bsr-tall-pinned", "resnet50-block-pruned",
               mods["CnnEngine"](program, tparams, tplan, device=device), x,
               tplan, dense, True)
    ms = method_ms(net, bparams, x)
    print(json.dumps({"phase": "auto", "net": "resnet50-block-pruned",
                      "plan": "methods", "forward_ms": ms,
                      "auto_roofline_ms": row["forward_ms"],
                      "auto_tall_pinned_ms": trow["forward_ms"]}),
          flush=True)
    del bparams, qparams, tparams, eng
    torch.cuda.empty_cache()

    # AlexNet in wall mode on the card: every candidate measured, the plan
    # saved under build/, reloaded with every layer a cache hit, then run
    program, params = nets["alexnet"]
    net = cnn.NETWORKS["alexnet"]()
    x = torch.from_numpy(rng.standard_normal(
        (batch, 3, image, image)).astype(np.float32)).to(device)
    dense = cnn.cnn_forward(net, params, x, "dense")
    path = os.path.join(ROOT, "build", "plans", "alexnet_wall.json")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    wplan = tun.plan_program(program, batch=batch, mode="wall",
                             cache=mods["PlanCache"](path), params=params,
                             device=device, warmup=1, iters=3)
    tune_s = time.perf_counter() - t0
    keys, measured = set(), 0
    for op in program.conv_ops:
        g = tun.geometry_of_op(op, batch=batch)
        key = tun.layer_key(g, "cuda")
        if op.sparsity > 0 and key not in keys:
            keys.add(key)
            measured += sum(tun.measurable(c, "cuda")
                            for c in tun.enumerate_candidates(g))
    with mods["telemetry"].enabled():
        mods["telemetry"].reset()
        reload = tun.plan_program(program, batch=batch, mode="wall",
                                  cache=mods["PlanCache"](path),
                                  params=params, device=device)
        hits = mods["telemetry"].snapshot().get(
            "tuning.plan.cache_hit", {}).get("value", 0)
        mods["telemetry"].reset()
    check(reload == wplan and hits == len(program.conv_ops) and all(
        pe.provenance == "cache_hit" for pe in reload.values()),
        f"alexnet: the wall plan did not round-trip through {path} "
        f"({hits} cache hits of {len(program.conv_ops)})")
    eng = cnn.engine_for(net, params, tuple(x.shape[1:]), reload)
    wrow = run("wall", "alexnet", eng, x, reload, dense, False)
    ms = method_ms(net, params, x)
    differ = {}
    for name, pe in wplan.items():
        rf = roofline["alexnet"][name]
        pick = lambda e: (e.method, e.block_m, e.tm, e.value_dtype,  # noqa
                          e.fuse, e.pipeline, e.permute)
        if pick(pe) != pick(rf):
            differ[name] = {"wall": pe.to_dict(), "roofline": rf.to_dict()}
    print(json.dumps({"phase": "auto", "net": "alexnet", "plan": "wall-tune",
                      "tune_s": tune_s, "candidates_measured": measured,
                      "layers_tuned": len(keys), "plan_cache": os.path.relpath(
                          path, ROOT),
                      "forward_ms": ms, "auto_wall_ms": wrow["forward_ms"],
                      "differ_from_roofline": differ,
                      "phase_s": time.perf_counter() - t_phase}), flush=True)
    return launches, roofline


# ---------------------------------------------------------------------------
# the pre-flight verifier and the CNN serving tier
# ---------------------------------------------------------------------------

def _counted_forward(torch, mods, fn):
    """One counted run: the launch counters set to 0 just before ``fn``,
    read just after."""
    torch.cuda.synchronize()
    reset_counts(mods)
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(mods)


def _close_to_dense(y, dense, quantised):
    """(ok, max_abs_err, relative norm) of one output against ``dense``:
    within 1e-4 x max(1, max |dense|), or a relative norm of 0.05 for a
    quantised plan."""
    err = float(abs(y - dense).max())
    rel = float(((y - dense) ** 2).sum() ** 0.5 / ((dense ** 2).sum() ** 0.5))
    if quantised:
        return rel < QUANT_REL_TOL, err, rel
    return err <= PATH_RTOL * max(1.0, float(abs(dense).max())), err, rel


def preflight_phase(torch, mods, nets, device, batch, roofline, seed):
    """The static verifier on the card's terms: ``run_check`` over the auto
    phase's roofline plans (saved as plan caches) and the AlexNet wall plan
    at backend ``cuda``, the bound plans through ``preflight`` as a strict
    bind runs it, the CUDA lints; then the agreement sweep on ResNet-50
    (every candidate of the tuning space and the pinned bad entries on each
    sparse conv: preflight against the engine's ``execution_report``), the
    bad entries raised from real forwards, and one clean plan from the
    sweep run (counted) against ``dense``.  Returns the counted launches."""
    np, cnn, tun = mods["np"], mods["cnn"], mods["tuning"]
    an = mods["analysis"]
    PlanEntry = mods["PlanEntry"]
    t0 = time.perf_counter()
    launches = {name: 0 for name in CNN_NAMES}
    errors, entries = {}, 0
    paths = []
    for net_name, plan in roofline.items():
        program, params = nets[net_name]
        path = os.path.join(ROOT, "build", "plans",
                            f"{net_name}_roofline.json")
        if os.path.exists(path):
            os.remove(path)
        saved = tun.plan_program(program, batch=batch, params=params,
                                 device=device,
                                 cache=mods["PlanCache"](path))
        check(saved == plan, f"{net_name}: the roofline plan saved to {path} "
              f"differs from the auto phase's")
        paths.append(path)
        # the bound plan, as CnnEngine(strict=True) verifies it
        for d in an["preflight"](program, plan, params, batch=batch,
                                 backend="cuda"):
            if d.severity == "error":
                errors[d.rule] = errors.get(d.rule, 0) + 1
        entries += sum(pe.method in ("pallas", "bsr") for pe in plan.values())
    wall = os.path.join(ROOT, "build", "plans", "alexnet_wall.json")
    paths.append(wall)
    program, params = nets["alexnet"]
    wplan = tun.plan_program(program, batch=batch, mode="wall", params=params,
                             device=device, cache=mods["PlanCache"](wall))
    for d in an["preflight"](program, wplan, params, batch=batch,
                             backend="cuda"):
        if d.severity == "error":
            errors[d.rule] = errors.get(d.rule, 0) + 1
    report = an["run_check"](nets=list(roofline), plan_caches=paths,
                             batch=batch, backend="cuda")
    for d in report.errors:
        errors[d.rule] = errors.get(d.rule, 0) + 1
    for p in paths:
        with open(p) as fh:
            entries += len(json.load(fh)["entries"])
    lint_paths = an["kernel_paths"]()
    lint_kernels = sum(len(an["kernels_of"](p)) for p in lint_paths)
    check(not errors, f"preflight: errors on the card's plans or sources: "
          f"{errors}\n{report.format_human()}")
    check(not report.warnings, f"preflight: warnings "
          f"{[d.format() for d in report.warnings]}")

    # the agreement sweep: every candidate and the pinned bad entries on
    # each sparse conv of ResNet-50, at 224 px and batch 8
    program, params = nets["resnet50"]
    eng = mods["CnnEngine"](program, params, device=device)
    shape = (batch, 3, IMAGE, IMAGE)
    sweep = {"entries": 0, "flagged": 0, "refused": 0, "fallbacks": 0,
             "disagreements": []}
    clean = {}
    sparse = [op for op in program.conv_ops if op.sparsity > 0]
    for op in sparse:
        g = tun.geometry_of_op(op, batch=batch)
        cands = [PlanEntry(**c.to_dict()) for c in tun.enumerate_candidates(
            g, value_dtypes=tun.allowed_value_dtypes("cuda"))]
        bad = [PlanEntry(method="pallas", tm=op.m - 1),
               PlanEntry(method="pallas", tm=63, pipeline=True),
               PlanEntry(method="bsr", block_m=48, block_n=128)]
        for entry in cands + bad:
            flagged = any(d.severity == "error" for d in an["preflight"](
                program, {op.name: entry}, params, batch=batch,
                backend="cuda"))
            try:
                rep = eng.execution_report(shape, "auto",
                                           plan_override={op.name: entry})
                accepted = rep.fallback_count == 0
                sweep["fallbacks"] += rep.fallback_count
            except mods["NoKernelSchedule"]:
                accepted = False
                sweep["refused"] += 1
            sweep["entries"] += 1
            sweep["flagged"] += flagged
            if flagged == accepted or (entry in bad and accepted):
                sweep["disagreements"].append([op.name, entry.to_dict()])
            if accepted and entry.method in ("pallas", "bsr") and (
                    entry.value_dtype == "float32"):
                clean.setdefault(op.name, []).append(entry)
    check(not sweep["disagreements"], f"preflight sweep: preflight and the "
          f"engine disagree on {sweep['disagreements'][:5]}")

    # the pinned bad entries raise from a real forward on the card
    x = torch.from_numpy(np.random.default_rng(seed + 7).standard_normal(
        shape).astype(np.float32)).to(device)
    raised = 0
    for op in sparse[:2]:
        for entry in (PlanEntry(method="pallas", tm=op.m - 1),
                      PlanEntry(method="pallas", tm=63),
                      PlanEntry(method="bsr", block_m=48, block_n=128)):
            try:
                mods["CnnEngine"](program, params, {op.name: entry},
                                  device=device)(x, "auto")
                torch.cuda.synchronize()
            except ValueError:
                raised += 1
            else:
                check(False, f"preflight: {op.name} {entry} ran on the card")
    # ... and one plan of statically clean entries launches, counted: each
    # sparse conv takes a clean f32 kernel entry of the sweep, in turn
    plan = {op.name: PlanEntry(method="dense") for op in program.conv_ops}
    for i, op in enumerate(sparse):
        plan[op.name] = clean[op.name][(7 * i) % len(clean[op.name])]
    strict = mods["CnnEngine"](program, params, plan, strict=True,
                               device=device)
    dense = strict(x, "dense")
    strict(x, "auto")
    y, counts = _counted_forward(torch, mods, lambda: strict(x, "auto"))
    want = _plan_counts(plan, program)
    check(counts == want, f"preflight: the clean plan launched {counts}, "
          f"expected {want}")
    for name in CNN_NAMES:
        launches[name] += counts[name]
    ok, err, rel = _close_to_dense(y, dense, False)
    check(ok, f"preflight: the clean plan disagrees with dense "
          f"(max_abs_err {err})")
    print(json.dumps({
        "phase": "preflight", "nets": list(roofline), "batch": batch,
        "plan_files": [os.path.relpath(p, ROOT) for p in paths],
        "entries_checked": entries, "errors_by_rule": errors,
        "warnings": len(report.warnings), "infos": len(
            report.by_severity("info")),
        "lint_files": len(lint_paths), "lint_kernels": lint_kernels,
        "sweep": {k: (len(v) if isinstance(v, list) else v)
                  for k, v in sweep.items()},
        "sweep_layers": len(sparse), "bad_entries_raised": raised,
        "clean_plan": {"layers": _layers(plan),
                       "launches": {k: v for k, v in counts.items() if v},
                       "max_abs_err_vs_dense": err},
        "seconds": time.perf_counter() - t0}), flush=True)
    return launches


def _tally(items):
    out = {}
    for x in items:
        out[x] = out.get(x, 0) + 1
    return out


class _CountedEngine:
    """A bucket's engine that counts its forwards by ladder rung."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = {}

    def __call__(self, x, method="dense", **kw):
        rung = kw.get("rung")
        self.calls[rung] = self.calls.get(rung, 0) + 1
        return self.engine(x, method, **kw)

    def __getattr__(self, name):
        return getattr(self.engine, name)


def cnn_serve_phase(torch, mods, nets, device, seed):
    """``RobustCnnServer`` on the card at full width: each net on
    ``WallClock`` with seeded images, a steady run (512 requests at 80 % of
    the capacity first measured for the tuned rung) and an overload run
    (the same requests at 2x that), and on ResNet-50 a chaos run (the
    reference CLI's rates, seed 0) replayed twice on ``VirtualClock``.
    Each run is counted; returns the launches."""
    np, cnn = mods["np"], mods["cnn"]
    tun, srv = mods["tuning"], mods["serving"]
    t_phase = time.perf_counter()
    launches = {name: 0 for name in CNN_NAMES}

    def build(net_name, clock, plan, chaos=None):
        program, params = nets[net_name]
        server = srv.RobustCnnServer(
            cnn.NETWORKS[net_name](), params,
            [srv.BucketSpec(3, s, s, batch=CNN_SERVE_BATCH)
             for s in CNN_SERVE_BUCKETS[net_name]],
            plan=plan, clock=clock, chaos=chaos, device=device)
        for b in server._buckets:
            check(all(r.report.fallback_count == 0 for r in b.rungs),
                  f"{net_name}: a served rung falls back")
            x = torch.zeros((CNN_SERVE_BATCH,) + b.spec.shape, device=device)
            for r in b.rungs:   # banks, halves, cuDNN's choice: not counted
                b.engine(x, "auto", plan_override=r.plan, rung=r.name)
            b.engine = _CountedEngine(b.engine)
        torch.cuda.synchronize()
        return server

    def images(trace):
        return {a.rid: np.random.default_rng(seed * 100003 + a.rid)
                .standard_normal(a.shape).astype(np.float32) for a in trace}

    def serve(label, net_name, server, trace, imgs, check_results=True):
        """One counted run of ``trace``; checks and the row."""
        make = lambda a: srv.InferenceRequest(  # noqa: E731
            rid=a.rid, x=imgs[a.rid], deadline_s=a.deadline_s)
        t0 = time.perf_counter()
        rep, counts = _counted_forward(
            torch, mods, lambda: server.run_trace(trace, request_factory=make))
        wall_s = time.perf_counter() - t0
        check(rep.lost == 0 and rep.duplicated == 0,
              f"{net_name}/{label}: lost {rep.lost}, duplicated "
              f"{rep.duplicated}\n{rep.format()}")
        want = {name: 0 for name in KERNEL_NAMES}
        rung_ticks = {}
        for b in server._buckets:
            by_name = {r.name: r for r in b.rungs}
            for rung, n in b.engine.calls.items():
                rung_ticks[f"{b.spec.key}/{rung}"] = n
                for k, v in _plan_counts(by_name[rung].plan,
                                         b.program).items():
                    want[k] += n * v
        check(counts == want, f"{net_name}/{label}: launches {counts}, "
              f"expected {want} from the rungs' plans")
        for name in CNN_NAMES:
            launches[name] += counts[name]
        worst = {"f32": 0.0, "quantised_rel": 0.0}
        if check_results:
            for b in server._buckets:
                done = [r for r in server.requests
                        if r.status == "done" and r.bucket == b.spec.key]
                for i in range(0, len(done), CNN_SERVE_BATCH):
                    part = done[i:i + CNN_SERVE_BATCH]
                    x = np.zeros((len(part),) + b.spec.shape, np.float32)
                    for j, r in enumerate(part):
                        c, h, w = r.x.shape
                        x[j, :c, :h, :w] = r.x
                    dense = b.engine.engine(x, "dense").cpu().numpy()
                    for j, r in enumerate(part):
                        quant = r.rung == "quantised"
                        ok, err, rel = _close_to_dense(r.result, dense[j],
                                                       quant)
                        check(ok, f"{net_name}/{label}: request {r.rid} at "
                              f"{r.rung} disagrees with dense (max_abs_err "
                              f"{err}, relative norm {rel})")
                        if quant:
                            worst["quantised_rel"] = max(
                                worst["quantised_rel"], rel)
                        else:
                            worst["f32"] = max(worst["f32"], err)
        row = {"phase": "cnn-serve", "net": net_name, "run": label,
               "requests": rep.submitted, "completed": rep.completed,
               "images_per_s": rep.completed / wall_s, "wall_s": wall_s,
               "p50_ms": rep.p50_latency_s * 1e3,
               "p99_ms": rep.p99_latency_s * 1e3,
               "max_ms": rep.max_latency_s * 1e3, "ticks": rep.ticks,
               "rung_ticks": rung_ticks, "rejected": rep.rejected,
               "retries": rep.retries, "deadline_misses": rep.deadline_misses,
               "straggler_ticks": rep.straggler_ticks,
               "degradations": [f"{e.bucket}: {e.from_rung}->{e.to_rung} "
                                f"({e.reason})" for e in rep.degradations],
               "dropped_rungs": [
                   {"bucket": d["bucket"], "rung": d["rung"],
                    "preflight_errors": _tally(d["preflight_errors"]),
                    "fallback_reasons": _tally(d["fallback_reasons"])}
                   for d in rep.dropped_rungs],
               "launches": {k: v for k, v in counts.items() if v},
               "max_abs_err_vs_dense": worst["f32"],
               "quantised_rel_norm_vs_dense": worst["quantised_rel"]}
        return rep, row

    for net_name in ("resnet50", "googlenet", "alexnet"):
        program, params = nets[net_name]
        plans = {}

        def roofline(prog, batch, params=params, plans=plans):
            key = (prog.in_shape, batch)
            if key not in plans:
                plans[key] = tun.plan_program(prog, batch=batch,
                                              params=params, device=device)
            return plans[key]

        shapes = [(3, s, s) for s in CNN_SERVE_SHAPES[net_name]]
        server = build(net_name, srv.WallClock(), roofline)
        top = server._buckets[0]
        check(top.rungs[0].name == "tuned", f"{net_name}: the top bucket's "
              f"ladder {[r.name for r in top.rungs]} has no tuned rung")
        tuned = top.rungs[0]
        xb = torch.from_numpy(np.random.default_rng(seed + 8).standard_normal(
            (CNN_SERVE_BATCH,) + top.spec.shape).astype(np.float32)).to(device)
        tick = lambda: top.engine.engine(  # noqa: E731
            xb, "auto", plan_override=tuned.plan, rung="tuned").cpu()
        tick()
        t0 = time.perf_counter()
        for _ in range(5):
            tick()
        tick_s = (time.perf_counter() - t0) / 5
        capacity = CNN_SERVE_BATCH / tick_s
        one_tick = device_breakdown(torch, tick, tick_s * 1e3)
        for label, load in (("steady", CNN_SERVE_STEADY), ("overload",
                                                       CNN_SERVE_OVERLOAD)):
            trace = srv.arrival_trace(
                CNN_SERVE_REQUESTS, shapes, seed=seed + 9,
                mean_gap_s=1.0 / (load * capacity),
                deadline_s=CNN_SERVE_DEADLINE_S)
            if label == "overload":
                server = build(net_name, srv.WallClock(), roofline)
            rep, row = serve(label, net_name, server, trace, images(trace))
            if label == "overload":
                check(rep.rejected.get("queue_full", 0) > 0 and any(
                    e.reason == "overload" for e in rep.degradations),
                    f"{net_name}/overload: no queue_full and overload "
                    f"step-down\n{rep.format()}")
            row.update(capacity_images_per_s=capacity, load=load,
                       tuned_tick_ms=tick_s * 1e3,
                       ladders={b.spec.key: [r.name for r in b.rungs]
                                for b in server._buckets},
                       one_tick=one_tick)
            print(json.dumps(row), flush=True)
        del server, top
        torch.cuda.empty_cache()
        if net_name != "resnet50":
            continue

        def ell_plan(prog, batch):
            return {op.name: (mods["PlanEntry"](
                method="pallas", fuse=True, pipeline=True, source="pinned")
                if op.sparsity > 0 else mods["PlanEntry"](method="dense"))
                for op in prog.conv_ops}

        # the steady traffic through the ELL kernel: the roofline picks it
        # for no layer, so a plan pins it (tuned: f32 banks, quantised:
        # int8)
        trace = srv.arrival_trace(
            CNN_SERVE_REQUESTS, shapes, seed=seed + 9,
            mean_gap_s=1.0 / (CNN_SERVE_STEADY * capacity),
            deadline_s=CNN_SERVE_DEADLINE_S)
        server = build(net_name, srv.WallClock(), ell_plan)
        rep, row = serve("steady-ell", net_name, server, trace,
                         images(trace))
        check(any(k.endswith("/tuned") for k in row["rung_ticks"]),
              f"{net_name}/steady-ell: the ELL rung served nothing")
        row.update(load=CNN_SERVE_STEADY, ladders={
            b.spec.key: [r.name for r in b.rungs] for b in server._buckets})
        print(json.dumps(row), flush=True)
        del server

        # chaos, at the overload run's rate: the top bucket pins every
        # sparse conv to the ELL kernel, which the injector corrupts (tm =
        # m - 1) at half its entries, so that bucket keeps its dense rung
        # alone; the other pins the BCSR kernel, which the injector leaves
        # alone (as the reference's does), so its ladder keeps the rungs
        # that faults and overload step down through
        top_shape = (3,) + (CNN_SERVE_BUCKETS[net_name][0],) * 2

        def chaos_plan(prog, batch):
            if prog.in_shape == top_shape:
                return ell_plan(prog, batch)
            return {op.name: (mods["PlanEntry"](
                method="bsr", block_m=8, block_n=128, fuse=True,
                source="pinned")
                if op.sparsity > 0 else mods["PlanEntry"](method="dense"))
                for op in prog.conv_ops}

        def chaos():
            return srv.ChaosInjector(srv.ChaosConfig(**CNN_SERVE_CHAOS))

        trace = srv.arrival_trace(
            CNN_SERVE_REQUESTS, shapes, seed=seed + 10,
            mean_gap_s=1.0 / (CNN_SERVE_OVERLOAD * capacity),
            deadline_s=CNN_SERVE_DEADLINE_S)
        imgs = images(trace)
        inj = chaos()
        server = build(net_name, srv.WallClock(), chaos_plan, inj)
        rep, row = serve("chaos", net_name, server, trace, imgs)
        dropped = {r for d in rep.dropped_rungs
                   for r in d["preflight_errors"]}
        check("sched.unsupported_tm" in dropped and any(
            e.reason in ("escalate", "overload") for e in rep.degradations),
            f"{net_name}/chaos: no rung dropped for sched.unsupported_tm or "
            f"no step-down\n{rep.format()}")
        row.update(chaos=inj.summary(), ladders={
            b.spec.key: [r.name for r in b.rungs] for b in server._buckets})
        del server
        replays = []
        for _ in range(2):
            server = build(net_name, srv.VirtualClock(), chaos_plan, chaos())
            replay, _ = serve("chaos-virtual", net_name, server, trace, imgs,
                              check_results=False)
            replays.append(replay.to_dict())
            del server
        check(replays[0] == replays[1], f"{net_name}/chaos: two replays on "
              f"VirtualClock differ")
        row.update(virtual_replays_equal=True, virtual_replay={
            k: replays[0][k] for k in ("completed", "rejected", "retries",
                                       "ticks", "rungs_executed",
                                       "p50_latency_s", "p99_latency_s")})
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "cnn-serve", "seconds":
                      time.perf_counter() - t_phase}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# the transformer serving path (Yi-9B)
# ---------------------------------------------------------------------------

def reset_counts(mods):
    for fn, attr, *key in COUNTERS.values():
        if key:
            getattr(mods["kernels"][fn], attr).clear()
        else:
            setattr(mods["kernels"][fn], attr, 0)


def read_counts(mods):
    return {name: (getattr(mods["kernels"][fn], attr).get(key[0], 0) if key
                   else getattr(mods["kernels"][fn], attr))
            for name, (fn, attr, *key) in COUNTERS.items()}


def dim_key(mods, kind: str, d: int) -> tuple:
    """The flash wrappers' ``by_head_dim`` key of head dim ``d``: (kind, d,
    the instantiation it runs in: D, or "128x2" for the wide kernels at d
    256)."""
    return kind, d, mods["budget"].flash_instance(d)


def block_counts(sched: str, block, n: int) -> dict:
    """The by-block counters a run of ``n`` bsr_matmul launches of
    ``sched`` on ``block`` tiles adds to (none but at (128, 128))."""
    return ({f"bsr_matmul_{sched}_b128": n}
            if tuple(block) == BLOCKS_BLOCK else {})


def expect(**counts) -> dict:
    """Every counter 0 but those given."""
    want = {name: 0 for name in KERNEL_NAMES}
    want.update(counts)
    return want


def flash_step_launches(n: int, bf16: bool, d: int, forwards=None,
                        grouped: bool = False) -> dict:
    """The counts of a train step (or a forward and backward) whose ``n``
    attention layers run flash at head dim ``d``: the tensor-core kernels
    for bf16 (the dK/dV group sum with each dK/dV), the split-TF32 kernels
    for f32 (the dK/dV group sum with each dK/dV when
    ``grouped``: more query heads than kv heads), their instantiation's
    counters at each head dim of DIM_INSTANCES, ``forwards`` forward
    launches (``n``; ``2 n`` when remat recomputes each), every other
    counter 0."""
    forwards = n if forwards is None else forwards
    tc = "_tc" if bf16 else ""
    want = {f"flash_attention{tc}": forwards,
            f"flash_attention_bwd_dq{tc}": n,
            f"flash_attention_bwd_dkv{tc}": n}
    if bf16:
        want["flash_attention_dkv_reduce"] = n
    elif grouped:
        want["flash_attention_dkv_reduce_tf32"] = n
    if d in dict(DIM_INSTANCES):
        want.update({f"flash_attention{tc}_d{d}": forwards,
                     f"flash_attention_bwd_dq{tc}_d{d}": n,
                     f"flash_attention_bwd_dkv{tc}_d{d}": n})
    return expect(**want)


def llm_params(torch, mods, cfg, sparsity, seed, device, block=LLM_BLOCK):
    """Yi-9B params drawn on the card from ``seed``, then, at ``sparsity``,
    block-pruned with ``block`` tiles and converted to BCSR in place, one
    matrix at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = mods["T"].init_params(cfg, gen, device)
    if sparsity > 0:
        params = mods["sparsify"](params, cfg, sparsity, block)
    torch.cuda.synchronize()
    return params


def o_excess(o, want) -> float:
    """Largest error of ``o`` against the f32 ``want`` beyond one bf16
    rounding of the output (2^-8 of |want|), in units of ``want``'s rms."""
    err = (o.float() - want).abs() - 2.0 ** -8 * want.abs()
    return float(err.max() / want.pow(2).mean().sqrt())


def flash_pv_bf16(torch, q, k, v, sc, causal=True):
    """Attention as the plain version computes it, causal or full, but with
    p rounded to bf16 before p v: a fault that leaves the softmax (and lse)
    right, which the O check must reject.  q (B, H, T, d), k/v
    (B, KV, S, d)."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    qf = q.reshape(b, kv, h // kv, t, d).float() * sc
    logits = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2))
    if causal:
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    del logits
    out = torch.matmul(p.to(torch.bfloat16).float(), v.float()[:, :, None])
    out = out / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, t, d).to(q.dtype)


def pruned_bank(torch, mods, gen, d_in, d_out, device, block=LLM_BLOCK):
    """A (d_in, d_out) bf16 weight drawn as ``init_params`` draws it,
    block-pruned to LLM_SPARSITY with ``block`` tiles as
    ``sparsify_params`` prunes it: (its BCSR bank of bf16 tiles, the dense
    pruned weight in bf16, the library call's operand)."""
    bf16 = torch.bfloat16
    w = mods["dense_init"](gen, d_in, d_out, bf16, device)   # (in, out)
    pruned = mods["block_prune"](w.float(), LLM_SPARSITY, block)
    bc = mods["bcsr_matrix"](pruned.T, block)
    bc = mods["dc"].replace(bc, blocks=bc.blocks.to(bf16))
    return bc, pruned.to(bf16)


def bsr_matmul_row(torch, mods, gen, device, bc, w_lib, name, b, t,
                   flush=None, arch="yi-9b"):
    """``bsr_matmul`` on one bank at (B, T, N) bf16 activations, through
    the kernel and the wrapper the model calls, against its plain version;
    with ``flush``, a ``rows`` launch is also timed with the L2 cold.
    Prints and returns the row."""
    bf16 = torch.bfloat16
    bk, plain = mods["kernels"]["bsr_matmul"], mods["matmul_plain"]
    d_out, d_in = bc.shape
    gm, kb_dim, bm, bn = bc.blocks.shape
    kept = int(bc.nblocks.sum())
    rows = b * t
    x3 = torch.randn((b, t, d_in), generator=gen, device=device).to(bf16)
    # the (rows, N) view ops.bsr_matmul hands the kernel (N is a multiple
    # of bn: no padding)
    x = x3.reshape(rows, d_in)
    args = (x, bc.blocks, bc.blockcol, bc.nblocks)
    got = bk(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    check(bool(torch.isfinite(got).all()), f"bsr_matmul {name}: not finite")
    check(err <= BSR_MATMUL_TOL * scale,
          f"bsr_matmul {name} x {rows} rows disagrees with its plain "
          f"version (max_abs_err {err}, tolerance {BSR_MATMUL_TOL}*{scale})")
    # bf16 from the epilogue: the same f32 sums rounded once
    check(torch.equal(bk(*args, out_dtype=bf16), got.to(bf16)),
          f"bsr_matmul {name} x {rows} rows: the bf16 output is not "
          f"the f32 output rounded once")
    # through the wrapper the model calls: bf16 back in (B, T, M)
    y3 = mods["bsr_matmul"](x3, bc)
    check(tuple(y3.shape) == (b, t, d_out) and y3.dtype == bf16,
          f"bsr_matmul {name}: wrapper returned {tuple(y3.shape)} "
          f"{y3.dtype}")
    want3 = want[:, :d_out].reshape(b, t, d_out)
    ops_err = float(((y3.float() - want3).abs()
                     - 2.0 ** -8 * want3.abs()).max())
    check(ops_err <= BSR_MATMUL_TOL * scale,
          f"bsr_matmul {name} x {rows} rows: the wrapper's bf16 output "
          f"is {ops_err} beyond one rounding of the plain version's "
          f"(tolerance {BSR_MATMUL_TOL}*{scale})")
    sched = mods["bsr_schedule"](rows, bf16)
    want_sched = ("rows" if rows <= mods["budget"].BSR_MATMUL_ROWS_MAX
                  else "wgmma")
    check(sched == want_sched, f"bsr_matmul {name} x {rows} rows runs the "
          f"{sched} schedule, not {want_sched}")
    reps = 50 if rows <= 64 else 10
    # as the model calls it: x's dtype out
    event_ms = time_cuda(torch, lambda: bk(*args, out_dtype=bf16),
                         reps=reps, warmup=3)
    ms = device_ms(torch, lambda: bk(*args, out_dtype=bf16), reps, 1)
    plain_ms = device_ms(torch, lambda: plain(*args), 1)
    library_ms = device_ms(torch, lambda: torch.matmul(x, w_lib), reps)
    cold = {}
    if sched == "rows" and flush is not None:   # the weights from memory
        pair = cold_device_ms(
            torch, (lambda: bk(*args, out_dtype=bf16),
                    lambda: torch.matmul(x, w_lib)), 20, flush,
            "bsr_matmul_rows")
        cold = {"kernel_cold_ms": pair[0], "library_cold_ms": pair[1]}
    moved = (rows * d_in * 2 + kept * bm * bn * 2 + kept * 4 + gm * 4
             + rows * gm * bm * 2)
    b_ms, b_by = bound(moved, flops_bf16=2.0 * rows * kept * bm * bn)
    row = {"kernel": "bsr_matmul", "arch": arch, "proj": name, "rows": rows,
           "shape": {"b": b, "t": t, "in": d_in, "out": d_out,
                     "block": [bm, bn], "kept_tiles": kept,
                     "tiles": gm * (d_in // bn), "KB": kb_dim},
           "schedule": sched,
           "max_abs_err": err, "wrapper_excess": ops_err,
           "kernel_ms": ms,
           "kernel_event_ms": event_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **cold, "bound_ms": b_ms,
           "bound_by": b_by, "bound_bytes": moved}
    print(json.dumps(row), flush=True)
    return row


def sdpa_ms(torch, fn, backend, what):
    """(device ms a call of ``fn``, an SDPA call, what it timed): under the
    SDPA backend named ``backend`` pinned where one is given, (None, why)
    where that backend refuses the call; the port never calls it."""
    if backend is None:
        return device_ms(torch, fn, 5), what
    from torch.nn.attention import SDPBackend, sdpa_kernel
    try:
        with sdpa_kernel(getattr(SDPBackend, backend)):
            return (device_ms(torch, fn, 5),
                    f"{what}, backend {backend} (pinned)")
    except RuntimeError as e:
        return None, (f"{what}: backend {backend} (pinned) refused it: "
                      f"{str(e).strip().splitlines()[0][:160]}")


def split_bound(mods, d, moved, products, scores, math_products, flops,
                peak):
    """A wide head dim's extra row fields (none up to 128): its slices,
    the output-column split's products over the math's (``math_products``
    products over all of d, ``scores`` of them score products that each
    slice recomputes), and the bound priced on the work the split runs
    (``products`` of the design's, of ``flops`` each, at ``peak``:
    "flops_bf16" or "flops_tf32")."""
    budget = mods["budget"]
    if not budget.flash_wide(d):
        return {}
    ms, by = bound(moved, **{peak: budget.flash_split_products(
        d, products, scores) * products * flops})
    return {"slices": budget.flash_slices(d),
            "split_products_over_math": budget.flash_split_products(
                d, math_products, scores),
            "bound_split_ms": ms, "bound_split_by": by}


def flash_tc_row(torch, mods, gen, device, shape, causal, kernel,
                 arch="yi-9b", library_backend=None):
    """The tensor-core flash forward at ``shape`` (B, H, KV, T = S, d),
    bf16, on the (B, H, T, d) views of (B, T, H, d) tensors that
    ``ops.flash_attention_bthd`` hands it, against ``flash_attention_plain``
    on f32 copies (O within one bf16 rounding plus FLASH_O_ATOL of its rms,
    rejecting two controls; lse within FLASH_LSE_TOL).  ``library_backend``
    pins SDPA's backend for the library time.  Prints and returns the
    row."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    b, h, kv, t, d = shape
    fk, fplain = mods["kernels"]["flash_attention"], mods["flash_plain"]
    split_plain = mods["flash_split_plain"]
    q4 = torch.randn((b, t, h, d), generator=gen, device=device).to(bf16)
    k4 = torch.randn((b, t, kv, d), generator=gen, device=device).to(bf16)
    v4 = torch.randn((b, t, kv, d), generator=gen, device=device).to(bf16)
    q, k, v = q4.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)
    sc = d ** -0.5
    o4 = mods["flash_bthd"](q4, k4, v4, causal=causal)
    launched = fk.tc_launches
    o, lse = fk(q, k, v, sc=sc, causal=causal)
    torch.cuda.synchronize()
    check(fk.tc_launches == launched + 1,
          "flash_attention: bf16 operands did not launch the tensor-core "
          "kernel")
    check(torch.equal(o4, o.transpose(1, 2)),
          "flash_attention_bthd differs from the kernel on its own views")
    # the plain version on f32 copies: O before its rounding to bf16
    o_want, lse_want = fplain(q.float(), k.float(), v.float(), sc=sc,
                              causal=causal)
    excess = o_excess(o4.transpose(1, 2), o_want)
    # against the plain version's own bf16 output (its f32 O rounded)
    err = float((o.float() - o_want.to(bf16).float()).abs().max())
    lse_err = float((lse - lse_want).abs().max())
    o_rms = float(o_want.pow(2).mean().sqrt())
    control = o_excess(flash_pv_bf16(torch, q, k, v, sc, causal), o_want)
    # the split's design on whole rows (ref.flash_attention_split_plain):
    # hi + lo, and hi alone, which the check must reject too
    mirror = o_excess(split_plain(q, k, v, sc=sc, causal=causal)[0].to(bf16),
                      o_want)
    hi_only = o_excess(split_plain(q, k, v, sc=sc, causal=causal,
                                   lo=False)[0].to(bf16), o_want)
    what = f"{kernel} (d {d}, causal {causal})"
    check(bool(torch.isfinite(o).all()), f"{what}: O not finite")
    check(excess <= FLASH_O_ATOL,
          f"{what} disagrees with its plain version on O: "
          f"{excess} x rms(O) beyond one bf16 rounding (tolerance "
          f"{FLASH_O_ATOL})")
    check(control > FLASH_O_ATOL,
          f"{what}: the O check does not reject p v in bf16 ({control} x "
          f"rms(O), tolerance {FLASH_O_ATOL})")
    check(hi_only > FLASH_O_ATOL,
          f"{what}: the O check does not reject the split's hi half alone "
          f"({hi_only} x rms(O), tolerance {FLASH_O_ATOL})")
    check(lse_err <= FLASH_LSE_TOL,
          f"{what} disagrees with its plain version on lse "
          f"(max_abs_err {lse_err}, tolerance {FLASH_LSE_TOL})")
    del o_want, lse_want, o4
    torch.cuda.empty_cache()
    event_ms = time_cuda(torch, lambda: fk(q, k, v, sc=sc, causal=causal),
                         reps=5, warmup=1)
    ms = device_ms(torch, lambda: fk(q, k, v, sc=sc, causal=causal), 5, 1)
    plain_ms = device_ms(torch, lambda: fplain(q, k, v, sc=sc,
                                               causal=causal), 1)
    library_ms, library_is = sdpa_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), library_backend,
        "SDPA forward, bf16")
    # (query, key) pairs: the causal half, or all of them
    pairs = b * h * t * (t + 1) // 2 if causal else b * h * t * t
    product = 2.0 * pairs * d                 # one product over them
    moved = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 + b * h * t * 4
    # the precision-keeping design on the tensor cores: q k^T one bf16
    # product, p v (p in f32) two, of p's bf16 halves
    b_ms, b_by = bound(moved, flops_bf16=3 * product)
    # both products in bf16, as SDPA computes them
    b16_ms, b16_by = bound(moved, flops_bf16=2 * product)
    # p v priced on the f32 FMA units (the bound before the split)
    fma_ms, _ = bound(moved, flops_f32=product, flops_bf16=product)
    row = {"kernel": kernel, "arch": arch,
           "shape": {"b": b, "h": h, "kv": kv, "t": t, "s": t, "d": d,
                     "causal": causal, "dtype": "bfloat16",
                     "layout": "(B, T, H, d) views"},
           "max_abs_err": err, "o_excess": excess,
           "o_excess_pv_bf16": control, "o_excess_split_plain": mirror,
           "o_excess_hi_only": hi_only, "o_rms": o_rms,
           "lse_max_abs_err": lse_err,
           "kernel_ms": ms, "kernel_event_ms": event_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_is": library_is,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_bytes": moved, "bound_all_bf16_ms": b16_ms,
           "bound_all_bf16_by": b16_by, "bound_fma_ms": fma_ms,
           "tflops": 2 * product / ms / 1e9,
           **split_bound(mods, d, moved, 3, 1, 2, product, "flops_bf16")}
    print(json.dumps(row), flush=True)
    del q4, k4, v4, q, k, v, o, lse
    torch.cuda.empty_cache()
    return row


def llm_kernel_phase(torch, mods, device, seed):
    """``bsr_matmul`` on four Yi-9B projections at decode and prefill row
    counts, and flash attention at prefill shape, each through the wrapper
    the model calls, on the layout it hands the kernel, against its plain
    version; returns per-kernel lists of row dicts."""
    rows_out = {"bsr_matmul": [], "flash_attention_tc": []}
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    flush = L2Flush(torch, device)
    for name, d_in, d_out in LLM_PROJECTIONS:
        bc, w_lib = pruned_bank(torch, mods, gen, d_in, d_out, device)
        for b, t in LLM_ACTIVATIONS:
            rows_out["bsr_matmul"].append(bsr_matmul_row(
                torch, mods, gen, device, bc, w_lib, name, b, t, flush))
        del w_lib, bc
        torch.cuda.empty_cache()
    del flush

    # -- flash attention forward at prefill shape (tensor cores, bf16) ----
    rows_out["flash_attention_tc"].append(flash_tc_row(
        torch, mods, gen, device, FLASH_SHAPE, True, "flash_attention_tc"))
    return rows_out


def llm_consistency_phase(torch, mods, device, seed, cfg=None,
                          projections=7, phase="consistency",
                          block=LLM_BLOCK):
    """A model at full width in f32, sparsity 0.8 in ``block`` tiles
    (Yi-9B unless ``cfg``; ``projections`` its BCSR projections a layer):
    the full-sequence forward under flash attention against token-by-token
    decode steps."""
    np, T = mods["np"], mods["T"]
    if cfg is None:
        cfg = mods["dc"].replace(mods["yi9b"], dtype="float32")
    params = llm_params(torch, mods, cfg, LLM_SPARSITY, seed + 10, device,
                        block)
    b, t = CONSIST_SHAPE
    toks = torch.from_numpy(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab, (b, t))).to(device)
    reset_counts(mods)
    mods["flags"].set_attn_impl("flash")
    try:
        ref, _ = T.forward(params, toks, cfg)
    finally:
        mods["flags"].set_attn_impl("chunked")
    fwd_counts = read_counts(mods)
    cache = T.init_cache(cfg, b, t, device)
    got = []
    for i in range(t):
        lg, cache = T.decode_step(params, cfg, toks[:, i:i + 1], cache, i)
        got.append(lg)
    got = torch.stack(got, dim=1)
    torch.cuda.synchronize()
    n_proj = cfg.n_layers * projections
    want = expect(bsr_matmul=n_proj, flash_attention=cfg.n_layers,
                  **block_counts("rows", block, n_proj))
    check(fwd_counts == want, f"{phase} forward launched {fwd_counts}, "
          f"expected {want}")
    check(bool(torch.isfinite(ref).all()) and bool(torch.isfinite(got).all()),
          f"{phase}: non-finite logits")
    diff = (got - ref).abs()
    excess = float((diff - (CONSIST_TOL + CONSIST_TOL * ref.abs())).max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    row = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.n_layers, "sparsity": LLM_SPARSITY,
           "block": list(block), "batch": b,
           "seq": t, "forward_launches": fwd_counts,
           "max_abs_diff": float(diff.max()), "logits_absmax":
           float(ref.abs().max()), "argmax_agreement": agree,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(row), flush=True)
    check(excess <= 0, f"{phase}: decode logits differ from the forward's "
          f"beyond rtol = atol = {CONSIST_TOL} (max |diff| {float(diff.max())})")
    check(agree >= CONSIST_AGREE, f"{phase}: argmax agreement {agree} "
          f"< {CONSIST_AGREE}")
    del params, cache, ref, got, diff
    torch.cuda.empty_cache()
    return fwd_counts


@contextlib.contextmanager
def counted_drops(mods):
    """The (token, expert) assignments MoE layers drop over capacity while
    the block runs: ``layers.moe_route`` (which ``_moe_group`` looks up in
    its module) is wrapped to add each group's drops to the list yielded,
    as device scalars; the serving path itself counts nothing."""
    layers = mods["layers"]
    route, drops = layers.moe_route, []

    def counting(p, xg, cfg, capacity):
        out = route(p, xg, cfg, capacity)
        drops.append(xg.shape[0] * cfg.top_k - out[3].sum())
        return out

    layers.moe_route = counting
    try:
        yield drops
    finally:
        layers.moe_route = route


def llm_prefill_phase(torch, mods, device, seed, cfg=None, projections=7,
                      phase="prefill", block=LLM_BLOCK,
                      sparsities=(LLM_SPARSITY, 0.0)):
    """A model in bf16 (Yi-9B unless ``cfg``) through ``make_prefill_step``
    under flash attention, at each of ``sparsities`` (``block`` tiles);
    returns the counted launches.  A MoE model's lines carry the (token,
    expert) assignments its capacity dropped."""
    np = mods["np"]
    cfg = mods["yi9b"] if cfg is None else cfg
    b, t = PREFILL_SHAPE
    toks = torch.from_numpy(np.random.default_rng(seed + 20).integers(
        0, cfg.vocab, (b, t))).to(device)
    batch = {"tokens": toks}
    step = mods["make_prefill_step"](cfg)
    counted = {name: 0 for name in KERNEL_NAMES}
    mods["flags"].set_attn_impl("flash")
    try:
        for sparsity in sparsities:
            torch.cuda.reset_peak_memory_stats()
            params = llm_params(torch, mods, cfg, sparsity, seed + 21, device,
                                block)
            step(params, batch)                   # warm-up
            torch.cuda.synchronize()
            with counted_drops(mods) as drops:
                reset_counts(mods)
                logits, _ = step(params, batch)
                torch.cuda.synchronize()
                counts = read_counts(mods)
            dropped = int(sum(drops)) if drops else 0
            # every bf16 forward through the tensor-core kernel
            n_proj = cfg.n_layers * projections if sparsity else 0
            want = expect(bsr_matmul=n_proj, bsr_matmul_wgmma=n_proj,
                          flash_attention_tc=cfg.n_layers,
                          **block_counts("wgmma", block, n_proj))
            check(counts == want, f"{phase} at sparsity {sparsity}: "
                  f"launches {counts}, expected {want}")
            for name in counted:
                counted[name] += counts[name]
            check(tuple(logits.shape) == (b, cfg.vocab),
                  f"{phase}: logits shape {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits).all()),
                  f"{phase} at sparsity {sparsity}: non-finite logits")
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                step(params, batch)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) / reps * 1e3
            row = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
                   "sparsity": sparsity, "block": list(block), "batch": b,
                   "seq": t,
                   "launches": counts, "forward_ms": fwd_ms,
                   "tokens_per_s": b * t / fwd_ms * 1e3,
                   "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
            if cfg.n_experts:
                row.update(moe_assignments=(b * t * cfg.top_k * sum(
                    cfg.layer_has_moe(i) for i in range(cfg.n_layers))),
                    moe_dropped=dropped, moe_capacity=mods["layers"]
                    .moe_capacity(b * t, cfg, mods["flags"].MOE_CAPACITY))
            row.update(device_breakdown(torch, lambda: step(params, batch),
                                        fwd_ms))
            print(json.dumps(row), flush=True)
            del params, logits
            torch.cuda.empty_cache()
    finally:
        mods["flags"].set_attn_impl("chunked")
    return counted


def llm_serve_phase(torch, mods, device, seed, cfg=None, projections=7,
                    phase="serve", block=LLM_BLOCK):
    """A model in bf16 (Yi-9B unless ``cfg``) at sparsity 0.8 in ``block``
    tiles behind ``ServeEngine``: 4 slots, max_len 128, 8 requests with
    prompts and budgets from ``seed``; returns the counted launches."""
    np, T = mods["np"], mods["T"]
    cfg = mods["yi9b"] if cfg is None else cfg
    params = llm_params(torch, mods, cfg, LLM_SPARSITY, seed + 30, device,
                        block)
    step = mods["make_serve_step"](cfg)
    per_tick = []

    def counted_step(p, tokens, cache, cur_len):
        before = read_counts(mods)
        out = step(p, tokens, cache, cur_len)
        after = read_counts(mods)
        per_tick.append({k: after[k] - before[k] for k in after})
        return out

    n_slots, max_len = SERVE_SLOTS, SERVE_MAX_LEN
    engine = mods["ServeEngine"](counted_step, params,
                                 T.init_cache(cfg, n_slots, max_len, device),
                                 n_slots, max_len, device=device)
    rng = np.random.default_rng(seed + 31)
    reqs = [mods["Request"](i, rng.integers(0, cfg.vocab, int(rng.integers(
                SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))).tolist(),
                            max_new_tokens=int(rng.integers(
                                SERVE_BUDGET[0], SERVE_BUDGET[1] + 1)))
            for i in range(SERVE_REQUESTS)]
    # warm-up: one decode step on a scratch cache, outside the counted run
    step(params, torch.zeros((n_slots, 1), dtype=torch.int64, device=device),
         T.init_cache(cfg, n_slots, 4, device), 0)
    torch.cuda.synchronize()
    for r in reqs:
        engine.submit(r)
    reset_counts(mods)
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(mods)
    check(done.drained and len(done) == len(reqs),
          f"{phase}: drained {done.drained}, {len(done)} of {len(reqs)} "
          f"served")
    for r in reqs:
        check(r.done and len(r.output) == r.max_new_tokens,
              f"{phase}: request {r.rid} has {len(r.output)} of "
              f"{r.max_new_tokens} tokens")
        check(all(0 <= tok < cfg.vocab for tok in r.output),
              f"{phase}: request {r.rid} has an id outside the vocabulary")
    n_proj = cfg.n_layers * projections
    tick = expect(bsr_matmul=n_proj, **block_counts("rows", block, n_proj))
    check(len(per_tick) == done.ticks and all(c == tick for c in per_tick),
        f"{phase}: a tick did not launch bsr_matmul {n_proj} times (rows) "
        f"and nothing else ({per_tick[:3]} ...)")
    tokens = sum(len(r.output) for r in reqs)
    tick_ms = wall / done.ticks * 1e3
    row = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
           "sparsity": LLM_SPARSITY, "block": list(block), "slots": n_slots,
           "max_len": max_len,
           "requests": len(reqs), "ticks": done.ticks, "launches": counts,
           "generated_tokens": tokens, "ms_per_tick": tick_ms,
           "tokens_per_s": tokens / wall,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    cache = T.init_cache(cfg, n_slots, max_len, device)
    toks = torch.zeros((n_slots, 1), dtype=torch.int64, device=device)
    prof = device_breakdown(torch, lambda: step(params, toks, cache, 0),
                            tick_ms, group=("bsr_matmul_rows",))
    row.update(bsr_matmul_rows_ms=prof.pop("group_ms"),
               bsr_matmul_rows_share=prof.pop("group_share"),
               bsr_matmul_rows_kernels=prof.pop("group_kernels"), **prof)
    print(json.dumps(row), flush=True)
    del params, engine, cache
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the transformer training path (Yi-9B)
# ---------------------------------------------------------------------------

def flash_bwd_p_bf16(torch, q, k, v, o, lse, do, sc, causal=True):
    """The plain backward, causal or full, with p rounded to bf16 wherever
    it is used (dS and dV): a fault of the precision the backward keeps p
    in, which the gradient check must reject.  Returns f32 (dQ, dK, dV)."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, kv, g, t, d).float()
    dof = do.reshape(b, kv, g, t, d).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    logits = torch.matmul(qf * sc, kf.transpose(-1, -2))
    if causal:
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.exp(logits - lse.reshape(b, kv, g, t, 1))
    del logits
    p = p.to(torch.bfloat16).float()
    delta = (dof * o.reshape(b, kv, g, t, d).float()).sum(dim=-1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * sc
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(dim=2) * sc
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=2)
    return dq.reshape(b, h, t, d), dk, dv


def flash_bwd_tc_rows(torch, mods, gen, device, shape, causal, names,
                      arch="yi-9b", library_backend=None):
    """Both tensor-core flash backward kernels at ``shape`` (B, H, KV,
    T = S, d), bf16: dQ, dK and dV through ``flash_attention_bthd`` and
    autograd on the model's (B, T, H, d) tensors, which is the code the
    training path runs (the Function's backward, its dO handling and
    delta), against the plain backward on the strided views the Function
    hands the kernels, with its two controls rejected and two launches of
    each kernel bit for bit; then each kernel timed alone.  ``names``: the
    (dQ, dK/dV) row names; ``library_backend`` pins SDPA's backend for the
    library time.  Prints the rows and returns them by name."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    b, h, kv, t, d = shape
    sc = d ** -0.5
    fwd = mods["kernels"]["flash_attention"]
    dq_k = mods["kernels"]["flash_attention_bwd_dq"]
    dkv_k = mods["kernels"]["flash_attention_bwd_dkv"]
    plain = mods["flash_bwd_plain"]
    what = f"flash backward (d {d}, causal {causal})"

    def rand(heads):
        return torch.randn((b, t, heads, d), generator=gen,
                           device=device).to(bf16)

    leaves = [rand(h).requires_grad_(), rand(kv).requires_grad_(),
              rand(kv).requires_grad_()]
    do_bthd = rand(h)
    out = mods["flash_bthd"](*leaves, causal=causal)
    check(out.grad_fn is not None, f"{what}: flash_attention_bthd's output "
          f"has no grad_fn")

    def bwd_counts():
        return (dq_k.launches, dq_k.tc_launches, dkv_k.launches,
                dkv_k.tc_launches, dkv_k.reduce_launches,
                dq_k.by_head_dim.get(dim_key(mods, "tc", d), 0),
                dkv_k.by_head_dim.get(dim_key(mods, "tc", d), 0))

    launched = bwd_counts()
    out.backward(do_bthd)
    torch.cuda.synchronize()
    check(bwd_counts() == (launched[0], launched[1] + 1, launched[2],
                           launched[3] + 1, launched[4] + 1, launched[5] + 1,
                           launched[6] + 1),
          f"{what}: autograd did not launch the tensor-core dQ, the "
          f"tensor-core dK/dV and its group sum once each at d {d}, and no "
          f"f32 kernel")
    dq, dk, dv = (x.grad.transpose(1, 2) for x in leaves)
    # the operands and residuals as the Function hands them to the kernels
    q, k, v, do = (x.detach().transpose(1, 2)
                   for x in (*leaves, do_bthd))
    o, lse = fwd(q, k, v, sc=sc, causal=causal)
    check(torch.equal(o, out.detach().transpose(1, 2)),
          f"{what}: the forward is not deterministic")
    del leaves, out, do_bthd
    # the plain version on f32 copies: gradients before their bf16 rounding
    want = plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                 sc=sc, causal=causal)
    got = (dq, dk, dv)
    stats = {}
    for name, gk, w in zip(("dq", "dk", "dv"), got, want):
        check(gk.dtype == bf16, f"{what}: {name} is {gk.dtype}")
        check(bool(torch.isfinite(gk).all()), f"{what}: {name} not finite")
        stats[name] = {"excess": o_excess(gk, w),
                       "max_abs_err": float((gk.float() - w.to(bf16).float())
                                            .abs().max()),
                       "rms": float(w.pow(2).mean().sqrt())}
    del want
    torch.cuda.empty_cache()
    control = flash_bwd_p_bf16(torch, q, k, v, o, lse, do, sc, causal)
    want = plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                 sc=sc, causal=causal)
    for name, c, w in zip(("dq", "dk", "dv"), control, want):
        stats[name]["control_excess"] = o_excess(c, w)
    del control
    torch.cuda.empty_cache()
    # the split's design on whole rows (ref.flash_attention_bwd_split_plain),
    # and its hi half alone (dS and p in bf16 where they are products'
    # operands), which every check must reject too
    split_plain = mods["flash_bwd_split_plain"]
    for lo, key in ((True, "split_plain_excess"), (False, "hi_only_excess")):
        mirror = split_plain(q, k, v, o, lse, do, sc=sc, causal=causal,
                             lo=lo)
        for name, m, w in zip(("dq", "dk", "dv"), mirror, want):
            stats[name][key] = o_excess(m.to(bf16), w)
        del mirror
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()
    for name, st in stats.items():
        check(st["excess"] <= FLASH_BWD_ATOL,
              f"{what} disagrees with its plain version on {name}: "
              f"{st['excess']} x rms beyond one bf16 rounding (tolerance "
              f"{FLASH_BWD_ATOL})")
        check(st["control_excess"] > FLASH_BWD_ATOL,
              f"{what}: the {name} check does not reject p in bf16 "
              f"({st['control_excess']} x rms, tolerance {FLASH_BWD_ATOL})")
        check(st["hi_only_excess"] > FLASH_BWD_ATOL,
              f"{what}: the {name} check does not reject the split's hi "
              f"half alone ({st['hi_only_excess']} x rms, tolerance "
              f"{FLASH_BWD_ATOL})")

    delta = mods["bwd_delta"](o, do)
    dq_name, dkv_name = names

    def run_dq():
        return dq_k(q, k, v, do, lse, delta, sc=sc, causal=causal)

    def run_dkv():
        return dkv_k(q, k, v, do, lse, delta, sc=sc, causal=causal)

    # no atomics: dQ is written by one thread an element, the group sums
    # run in one order, so two launches agree bit for bit
    identical = {}
    for name, fn in ((dq_name, run_dq), (dkv_name, run_dkv)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        identical[name] = (torch.equal(first, second) if name == dq_name
                           else all(torch.equal(a, b_)
                                    for a, b_ in zip(first, second)))
        check(identical[name], f"{what}: two {name} launches on the same "
              f"operands differ")
        del first, second

    times = {}
    for name, fn, n_kernels in ((dq_name, run_dq, 1), (dkv_name, run_dkv, 2)):
        times[name] = (device_ms(torch, fn, 5, n_kernels),
                       time_cuda(torch, fn, reps=5, warmup=1))
    plain_ms = device_ms(torch, lambda: plain(q, k, v, o, lse, do, sc=sc,
                                              causal=causal), 1)
    torch.cuda.empty_cache()
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    library_is = "the whole SDPA backward (dQ, dK, dV)"
    if library_backend is None:
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=True)

        def library():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)

        library_ms = device_ms(torch, library, 5)
        library_event_ms = time_cuda(torch, library, reps=5, warmup=1)
        del out
    else:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        try:
            with sdpa_kernel(getattr(SDPBackend, library_backend)):
                out = F.scaled_dot_product_attention(
                    *leaves, is_causal=causal, enable_gqa=True)

                def library():
                    return torch.autograd.grad(out, leaves, do,
                                               retain_graph=True)

                library_ms = device_ms(torch, library, 5)
                library_event_ms = time_cuda(torch, library, reps=5,
                                             warmup=1)
                del out
            library_is += f", bf16, backend {library_backend} (pinned)"
        except RuntimeError as e:
            library_ms = library_event_ms = None
            library_is += (f": backend {library_backend} (pinned) refused "
                           f"it: {str(e).strip().splitlines()[0][:160]}")
    del leaves
    # (query, key) pairs: the causal half, or all of them
    pairs = b * h * t * (t + 1) // 2 if causal else b * h * t * t
    flops = 2.0 * pairs * d                   # one product over them
    qkv_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * 2
    stat_bytes = 2 * b * h * t * 4            # lse, delta
    rows = {}
    for name, shape_out, f32_products, outs in (
            (dq_name, "dq", 1, q.numel()),
            (dkv_name, "dk, dv", 2, k.numel() + v.numel())):
        ms, event_ms = times[name]
        moved = qkv_bytes + stat_bytes + outs * 2
        # the precision-keeping design on the tensor cores: q k^T and
        # dO v^T one bf16 product each, a product with an f32 operand (ds k;
        # p^T dO, ds^T q) two, of its bf16 halves
        b_ms, b_by = bound(moved, flops_bf16=(2 + 2 * f32_products) * flops)
        b16_ms, b16_by = bound(moved, flops_bf16=(2 + f32_products) * flops)
        # the f32-operand products on the FMA units (the bound before)
        fma_ms, _ = bound(moved, flops_f32=f32_products * flops,
                          flops_bf16=2 * flops)
        errs = [stats[n.strip()] for n in shape_out.split(",")]
        row = {"kernel": name, "arch": arch,
               "shape": {"b": b, "h": h, "kv": kv, "t": t, "s": t, "d": d,
                         "causal": causal, "dtype": "bfloat16",
                         "layout": "(B, T, H, d) views"},
               "gradients": {n.strip(): stats[n.strip()]
                             for n in shape_out.split(",")},
               "max_abs_err": max(e["max_abs_err"] for e in errs),
               "kernel_ms": ms, "kernel_event_ms": event_ms,
               "plain_ms": plain_ms, "plain_is": "the whole plain backward",
               "library_ms": library_ms, "library_event_ms": library_event_ms,
               "library_is": library_is,
               "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": moved,
               "bound_all_bf16_ms": b16_ms, "bound_all_bf16_by": b16_by,
               "bound_fma_ms": fma_ms,
               "tflops": (2 + f32_products) * flops / ms / 1e9,
               "bit_identical_across_launches": identical[name],
               **split_bound(mods, d, moved, 2 + 2 * f32_products, 2,
                             2 + f32_products, flops, "flops_bf16")}
        print(json.dumps(row), flush=True)
        rows[name] = row
    del q, k, v, do, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rows


def llm_bwd_kernel_phase(torch, mods, device, seed):
    """Both tensor-core flash backward kernels at Yi-9B's train_4k shape
    (``flash_bwd_tc_rows``); returns per-kernel lists of row dicts."""
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    rows = flash_bwd_tc_rows(torch, mods, gen, device, BWD_SHAPE, True,
                             ("flash_attention_bwd_dq_tc",
                              "flash_attention_bwd_dkv_tc"))
    return {name: [row] for name, row in rows.items()}


def sdpa_f32_backward(torch, q, k, v, do, causal):
    """The yardstick of the f32 backward rows: SDPA's whole backward (dQ,
    dK, dV) under one named, pinned backend, efficient attention, on k and
    v expanded to q's heads (that backend takes no ``enable_gqa``).
    Returns (profiler device ms a call, the backend's name), or (None, why)
    where the backend refuses the call; the port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    g = q.shape[1] // k.shape[1]
    leaves = [x.detach().requires_grad_() for x in (
        q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1))]
    backend = SDPBackend.EFFICIENT_ATTENTION
    try:
        with sdpa_kernel(backend):
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            ms = device_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), 5)
    except RuntimeError as e:   # the backend refuses the shape: no time
        return None, (f"{backend.name}, which refused it: "
                      f"{str(e).strip().splitlines()[0][:160]}")
    return ms, backend.name


def flash_f32_rows(torch, mods, gen, device, shape, causal, names,
                   arch="yi-9b", library_backend=None):
    """The f32 flash kernels at ``shape`` (B, H, KV, T = S, d) on the
    (B, H, T, d) views of (B, T, H, d) tensors: the split-TF32 forward, dQ
    and dK/dV (and its group sum when H > KV), against their plain
    versions: O, dQ, dK and dV within FLASH_F32_TOL of their largest
    magnitude (the rms beside it), lse within FLASH_LSE_TOL; each also
    against its split-TF32 mirror (reported), and the check must reject
    the mirrors' one-product controls.  ``names``: the (forward, dQ,
    dK/dV) row names; ``library_backend`` pins SDPA's backend for the
    forward's library time (the backward's is always pinned).  Prints the
    rows and returns them by name."""
    F = torch.nn.functional
    b, h, kv, t, d = shape
    sc = d ** -0.5
    grouped = h != kv
    fwd = mods["kernels"]["flash_attention"]
    dq_k = mods["kernels"]["flash_attention_bwd_dq"]
    dkv_k = mods["kernels"]["flash_attention_bwd_dkv"]
    what = f"flash f32 (d {d}, causal {causal})"
    q, k, v, do = (torch.randn((b, t, heads, d), generator=gen,
                               device=device).transpose(1, 2)
                   for heads in (h, kv, kv, h))

    def counts():
        return (fwd.launches, fwd.tc_launches, dq_k.launches,
                dq_k.tc_launches, dkv_k.launches, dkv_k.tc_launches,
                dkv_k.tf32_reduce_launches,
                dq_k.by_head_dim.get(dim_key(mods, "tf32", d), 0),
                dkv_k.by_head_dim.get(dim_key(mods, "tf32", d), 0))

    launched = counts()
    o, lse = fwd(q, k, v, sc=sc, causal=causal)
    delta = mods["bwd_delta"](o, do)
    dq = dq_k(q, k, v, do, lse, delta, sc=sc, causal=causal)
    dk, dv = dkv_k(q, k, v, do, lse, delta, sc=sc, causal=causal)
    torch.cuda.synchronize()
    check(counts() == (launched[0] + 1, launched[1], launched[2] + 1,
                       launched[3], launched[4] + 1, launched[5],
                       launched[6] + grouped, launched[7] + 1,
                       launched[8] + 1),
          f"{what}: f32 operands did not launch the split-TF32 forward, dQ "
          f"and dK/dV (with its group sum when H > KV)")
    o_want, lse_want = mods["flash_plain"](q, k, v, sc=sc, causal=causal)
    dq_want, dk_want, dv_want = mods["flash_bwd_plain"](
        q, k, v, o, lse, do, sc=sc, causal=causal)
    errs = {}
    for name, got, want in (("o", o, o_want), ("dq", dq, dq_want),
                            ("dk", dk, dk_want), ("dv", dv, dv_want)):
        check(bool(torch.isfinite(got).all()), f"{what}: {name} not finite")
        err = float((got - want).abs().max())
        errs[name] = (err, err / float(want.abs().max()),
                      err / float(want.pow(2).mean().sqrt()))
        check(errs[name][1] <= FLASH_F32_TOL,
              f"{what}: {name} disagrees with its plain version "
              f"({errs[name][1]} x max |plain|, tolerance {FLASH_F32_TOL})")
    lse_err = float((lse - lse_want).abs().max())
    check(lse_err <= FLASH_LSE_TOL, f"{what}: lse disagrees with its plain "
          f"version (max_abs_err {lse_err})")
    del lse_want, dq_want, dk_want, dv_want
    torch.cuda.empty_cache()
    # the split-TF32 design (the forward chunk by chunk, the backward on
    # whole rows): the kernels' distance from it
    mirror = (mods["flash_fwd_tf32_plain"](q, k, v, sc=sc, causal=causal)[0],
              *mods["flash_bwd_tf32_plain"](q, k, v, o, lse, do, sc=sc,
                                            causal=causal))
    from_mirror = {name: float((got - m).abs().max() / m.abs().max())
                   for name, got, m in zip(("o", "dq", "dk", "dv"),
                                           (o, dq, dk, dv), mirror)}
    del mirror
    torch.cuda.empty_cache()
    # the controls: one TF32 product on operands rounded once must fail the
    # check the kernels pass, against the same plain versions
    control = (mods["flash_fwd_tf32_plain"](q, k, v, sc=sc, causal=causal,
                                            lo=False)[0],
               *mods["flash_bwd_tf32_plain"](q, k, v, o, lse, do, sc=sc,
                                             causal=causal, lo=False))
    plain = (o_want, *mods["flash_bwd_plain"](q, k, v, o, lse, do, sc=sc,
                                              causal=causal))
    control_err = {name: float((c - w).abs().max() / w.abs().max())
                   for name, c, w in zip(("o", "dq", "dk", "dv"), control,
                                         plain)}
    del control, plain, o_want
    torch.cuda.empty_cache()
    check(control_err["o"] > FLASH_F32_TOL
          and max(control_err.values()) > FLASH_F32_TOL,
          f"{what}: the check does not reject one TF32 product on operands "
          f"rounded once ({control_err} x max |plain|, tolerance "
          f"{FLASH_F32_TOL})")

    def run_fwd():
        return fwd(q, k, v, sc=sc, causal=causal)

    def run_dq():
        return dq_k(q, k, v, do, lse, delta, sc=sc, causal=causal)

    def run_dkv():
        return dkv_k(q, k, v, do, lse, delta, sc=sc, causal=causal)

    def plain_bwd():
        return mods["flash_bwd_plain"](q, k, v, o, lse, do, sc=sc,
                                       causal=causal)

    library_bwd_ms, backend = sdpa_f32_backward(torch, q, k, v, do, causal)
    torch.cuda.empty_cache()
    plain_bwd_ms = device_ms(torch, plain_bwd, 1)
    pairs = b * h * t * (t + 1) // 2 if causal else b * h * t * t
    product = 2.0 * pairs * d
    qkv_bytes = (q.numel() + 2 * k.numel()) * 4
    stats_bytes = 2 * b * h * t * 4                      # lse, delta
    rows = {}
    for name, fn, plain_ms, moved, products, scores, max_err in (
            (names[0], run_fwd, None,
             qkv_bytes + q.numel() * 4 + b * h * t * 4, 2, 1, errs["o"][0]),
            (names[1], run_dq, plain_bwd_ms,
             qkv_bytes + q.numel() * 4 + stats_bytes + q.numel() * 4, 3, 2,
             errs["dq"][0]),
            (names[2], run_dkv, plain_bwd_ms,
             qkv_bytes + q.numel() * 4 + stats_bytes + 2 * k.numel() * 4, 4,
             2, max(errs["dk"][0], errs["dv"][0]))):
        n_kernels = 1 + (grouped and fn is run_dkv)
        ms = device_ms(torch, fn, 5, n_kernels)
        # the design: three TF32 products a product on the tensor cores;
        # beside it every product in f32 on the FMA units
        b_ms, b_by = bound(moved, flops_tf32=3 * products * product)
        fma_ms, fma_by = bound(moved, flops_f32=products * product)
        parts = ("o",) if fn is run_fwd else (
            ("dq",) if fn is run_dq else ("dk", "dv"))
        row = {"kernel": name, "arch": arch,
               "shape": {"b": b, "h": h, "kv": kv, "t": t, "s": t, "d": d,
                         "causal": causal, "dtype": "float32",
                         "layout": "(B, T, H, d) views"},
               "max_abs_err": max_err,
               "err_over_max": {n: e[1] for n, e in errs.items()},
               "err_over_rms": {n: e[2] for n, e in errs.items()},
               "lse_max_abs_err": lse_err,
               "kernel_ms": ms,
               "kernel_event_ms": time_cuda(torch, fn, reps=5, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": moved,
               "design": "split TF32",
               "err_from_mirror_over_max": {n: from_mirror[n] for n in parts},
               "control_one_product_err_over_max": {
                   n: control_err[n] for n in parts},
               "bound_fma_ms": fma_ms, "bound_fma_by": fma_by,
               "tflops": products * product / ms / 1e9,
               **split_bound(mods, d, moved, products, scores, products,
                             3 * product, "flops_tf32")}
        if fn is run_fwd:
            # a pinned backend may refuse GQA (efficient attention does):
            # there k and v expanded to q's heads
            g = h // kv if library_backend is not None else 1
            ke, ve = (x.repeat_interleave(g, dim=1) for x in (k, v))
            library_ms, library_is = sdpa_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, ke, ve, is_causal=causal, enable_gqa=True),
                library_backend, "SDPA forward, f32" + (
                    f", k and v expanded to {h} heads" if g > 1 else ""))
            del ke, ve
            row.update({
                "plain_ms": device_ms(torch, lambda: mods["flash_plain"](
                    q, k, v, sc=sc, causal=causal), 1),
                "library_ms": library_ms, "library_is": library_is})
        else:
            row.update({
                "group_sum": grouped,
                "plain_ms": plain_ms, "plain_is": "the whole plain backward",
                "library_ms": library_bwd_ms,
                "library_is": f"the whole SDPA backward (dQ, dK, dV), f32, "
                              f"backend {backend} (pinned), k and v "
                              f"expanded to {h} heads; one timing, given on "
                              f"both rows"})
        print(json.dumps(row), flush=True)
        rows[name] = row
    del q, k, v, do, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rows


def flash_f32_kernel_phase(torch, mods, device, seed):
    """The split-TF32 forward, dQ and dK/dV kernels (``flash_f32_rows``)
    at the train consistency shape (B 1, H 32, KV 4,
    T = S = 2048, d 128, causal, f32), which the consistency and train
    consistency phases launch; returns per-kernel lists of row dicts."""
    b, h, kv, _, d = BWD_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    rows = flash_f32_rows(torch, mods, gen, device,
                          (b, h, kv, TRAIN_CONSIST_SHAPE[1], d), True,
                          ("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"))
    return {name: [row] for name, row in rows.items()}


def train_consistency_phase(torch, mods, device, seed, full=None):
    """``full`` (Yi-9B by default) at full width in f32, 2 layers: every
    parameter's gradient through flash against through chunked, then one
    counted train step; returns its launches.  The encoder and the VLM
    train on the data pipeline's embeddings."""
    T, flags = mods["T"], mods["flags"]
    full = mods["yi9b"] if full is None else full
    cfg = mods["dc"].replace(full, dtype="float32",
                             n_layers=TRAIN_CONSIST_LAYERS)
    b, t = TRAIN_CONSIST_SHAPE
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed + 40)
    params = T.init_params(cfg, gen, device)
    batch = mods["SyntheticLMDataset"](mods["DataConfig"](
        seq_len=t, global_batch=b, vocab=cfg.vocab, seed=seed + 41,
        embed_dim=embed_dim(cfg))).batch_for(0)
    on_card = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    paths = [p for p, _ in mods["tree_paths"](params)]
    grads, losses = {}, {}
    for impl in ("chunked", "flash"):
        flags.set_attn_impl(impl)
        try:
            loss, grads[impl] = mods["loss_and_grads"](cfg, params, on_card)
        finally:
            flags.set_attn_impl("chunked")
        losses[impl] = float(loss)
    worst, worst_path = 0.0, None
    for path, gf, gc in zip(paths, grads["flash"], grads["chunked"]):
        check(bool(torch.isfinite(gf).all()),
              f"train consistency: no finite flash gradient for {path}")
        # a leaf the batch never reaches (the token embedding of a model
        # fed embeddings) has a zero gradient both ways
        limit = TRAIN_GRAD_TOL * float(gc.abs().max())
        err = float((gf - gc).abs().max())
        ratio = err / limit if limit else (0.0 if err == 0 else math.inf)
        if ratio > worst:
            worst, worst_path = ratio, path
    loss_err = abs(losses["flash"] - losses["chunked"])
    del grads
    torch.cuda.empty_cache()
    # one counted step of the train step under flash
    opt_cfg = mods["AdamWConfig"]()
    state = {"params": params, "opt": mods["adamw_init"](params, opt_cfg)}
    step = mods["make_train_step"](cfg, opt_cfg, total_steps=10)
    flags.set_attn_impl("flash")
    try:
        reset_counts(mods)
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        counts = read_counts(mods)
    finally:
        flags.set_attn_impl("chunked")
    row = {"phase": "train consistency", "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "batch": b, "seq": t,
           "reduced": {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"},
           "loss_flash": losses["flash"], "loss_chunked": losses["chunked"],
           "grad_leaves": len(paths),
           "worst_grad_err_over_tol": worst, "worst_grad_leaf": worst_path,
           "grad_tol": f"{TRAIN_GRAD_TOL} x max |chunked grad| per leaf",
           "step_launches": counts, "step_loss": float(metrics["loss"]),
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(row), flush=True)
    check(worst <= 1.0, f"train consistency: the flash gradient of "
          f"{worst_path} differs from the chunked one by {worst} x the "
          f"tolerance ({TRAIN_GRAD_TOL} x its largest magnitude)")
    check(loss_err <= TRAIN_LOSS_TOL * abs(losses["chunked"]),
          f"train consistency: losses {losses}")
    want = flash_step_launches(cfg.n_layers, False, cfg.head_dim,
                               grouped=cfg.n_heads != cfg.n_kv_heads)
    check(counts == want, f"train consistency {cfg.name}: a step launched "
          f"{counts}, expected {want}")
    check(bool(torch.isfinite(metrics["loss"])), "train consistency: loss "
          "not finite")
    del params, state
    torch.cuda.empty_cache()
    return counts


def embed_dim(cfg) -> int:
    """The data pipeline's embedding width for ``cfg``: the encoder and the
    VLM train on precomputed embeddings (f32), the others on tokens."""
    return cfg.d_model if cfg.family in ("vlm", "encoder") else 0


class RepeatLoader:
    """A loader that yields one batch again and again."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.batch

    def close(self):
        pass


def run_training(torch, mods, cfg, holder, batch, want, opt_cfg, *, warmup,
                 timed):
    """``warmup`` + ``timed`` counted steps of ``make_train_step`` under
    ``StepRunner`` on ``batch`` repeated, from the state in
    ``holder["state"]`` (put back at the end, so that no name here keeps a
    step's state alive beside the next), each step's launches held to
    ``want``, with finite losses, the last below the first; the runner
    saves a checkpoint after the last step (into ``build/``, removed
    afterwards), which must restore bit for bit.  The schedule's warm-up
    (a tenth of its length) spans the run: lr at its peak on the second
    step overshoots (HuBERT-XLarge's loss rises at its third step).
    Returns (the step, the row's numbers)."""
    import shutil
    n_steps = warmup + timed
    step_fn = mods["make_train_step"](cfg, opt_cfg,
                                      total_steps=TRAIN_SCHEDULE * n_steps)
    per_step = []

    def counted_step(st, bt):
        reset_counts(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step_fn(st, bt)
        torch.cuda.synchronize()
        per_step.append((read_counts(mods), time.perf_counter() - t0))
        return st, m

    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = mods["CheckpointManager"](ckpt_dir, keep=1)
    runner = mods["StepRunner"](counted_step, mgr,
                                lambda s: RepeatLoader(batch),
                                ckpt_every=n_steps)
    losses = []

    def on_metrics(step, m):
        if "straggler_flag" not in m:
            losses.append(m["loss"])

    what = f"train {cfg.name}"
    try:
        t0 = time.perf_counter()
        state, end = runner.run(holder.pop("state"), 0, n_steps,
                                on_metrics=on_metrics)
        run_s = time.perf_counter() - t0
        check(end == n_steps and len(per_step) == n_steps,
              f"{what}: ran to step {end}, {len(per_step)} steps")
        for i, (counts, _) in enumerate(per_step):
            check(counts == want, f"{what}: step {i} launched {counts}, "
                  f"expected {want}")
        check(all(math.isfinite(x) for x in losses) and len(losses) == n_steps,
              f"{what}: losses {losses}")
        check(losses[-1] < losses[0], f"{what}: the loss on "
              f"the repeated batch did not fall ({losses})")
        step_ms = sum(dt for _, dt in per_step[warmup:]) / timed * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        # the runner saved step n_steps: it must restore bit for bit
        t0 = time.perf_counter()
        restored, ck_step = mgr.restore_latest(state, device="cpu")
        restore_s = time.perf_counter() - t0
        check(ck_step == n_steps, f"{what}: latest checkpoint {ck_step}")
        live = dict(mods["tree_paths"](state))
        for path, leaf in mods["tree_paths"](restored):
            check(leaf.dtype == live[path].dtype
                  and torch.equal(leaf, live[path].cpu()),
                  f"{what}: checkpoint leaf {path} differs after restore")
        del restored, live
        holder["state"] = state
        del state
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    tokens = math.prod(batch["labels"].shape)
    return step_fn, {
        "steps": n_steps, "schedule_steps": TRAIN_SCHEDULE * n_steps,
        "timed_steps": timed, "losses": losses,
        "ms_per_step": step_ms,
        "step_ms_each": [dt * 1e3 for _, dt in per_step],
        "tokens_per_s": tokens / (step_ms / 1e3), "peak_gb": peak_gb,
        "launches_per_step": per_step[-1][0], "runner_s": run_s,
        "restore_s": restore_s, "runs": [c for c, _ in per_step]}


def profiled_step(torch, step_fn, holder, batch, step_ms) -> dict:
    """One more step of ``step_fn`` on ``holder``'s state under the
    profiler (``device_breakdown``), with the device time and share of the
    flash kernels."""
    def one_step():
        holder["state"], _ = step_fn(holder["state"], batch)

    out = device_breakdown(torch, one_step, step_ms, top=8,
                           group=("flash_fwd", "flash_bwd",
                                  "flash_dkv_reduce"))
    out["attention_ms"] = out.pop("group_ms")
    out["attention_share"] = out.pop("group_share")
    out["attention_kernels"] = out.pop("group_kernels")
    return out


def train_phase(torch, mods, device, seed):
    """Yi-9B at full width, 6 layers, bf16, through make_train_step under
    StepRunner, with a checkpoint saved and restored; returns the counted
    launches."""
    flags = mods["flags"]
    full = mods["yi9b"]
    cfg = mods["dc"].replace(full, n_layers=TRAIN_LAYERS)
    b, t = TRAIN_SHAPE
    opt_cfg = mods["AdamWConfig"]()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2**30
    holder = {"state": mods["init_state"](cfg, opt_cfg, torch.Generator(
        device=device).manual_seed(seed + 50), device)}
    n_params = sum(x.numel() for x in mods["tree_flatten"](
        holder["state"]["params"])[0])
    state_gb = torch.cuda.memory_allocated() / 2**30 - base_gb
    batch = mods["SyntheticLMDataset"](mods["DataConfig"](
        seq_len=t, global_batch=b, vocab=cfg.vocab, seed=seed + 51)
    ).batch_for(0)
    # every bf16 forward and backward through the tensor-core kernels
    want = flash_step_launches(cfg.n_layers, True, cfg.head_dim)
    flags.set_attn_impl("flash")
    try:
        step_fn, res = run_training(torch, mods, cfg, holder, batch, want,
                                    opt_cfg, warmup=TRAIN_WARMUP,
                                    timed=TRAIN_TIMED)
        res.update(profiled_step(torch, step_fn, holder, batch,
                                 res["ms_per_step"]))
    finally:
        flags.set_attn_impl("chunked")
    runs = res.pop("runs")
    row = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "params": n_params,
           "reduced": {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"},
           "batch": b, "seq": t, "optimizer": "AdamW, f32 state",
           **res, "state_gb": state_gb}
    print(json.dumps(row), flush=True)
    holder.clear()
    torch.cuda.empty_cache()
    return sum_counts(runs)


# ---------------------------------------------------------------------------
# the model families: training at full width (HuBERT-XLarge and
# Phi-3-Vision at full depth, DeepSeek-V3 cut to one layer and its MTP
# block)
# ---------------------------------------------------------------------------

def _family_state(torch, mods, cfg, opt_cfg, seed, device):
    """A fresh train state in a holder, the peak-memory count restarted
    before it; returns (holder, its params, its GB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    holder = {"state": mods["init_state"](cfg, opt_cfg, torch.Generator(
        device=device).manual_seed(seed), device)}
    n_params = sum(x.numel() for x in mods["tree_flatten"](
        holder["state"]["params"])[0])
    return holder, n_params, (torch.cuda.memory_allocated() - base) / 2**30


def _family_batch(torch, mods, cfg, shape, seed, device, embeds_dtype=None):
    """The data pipeline's batch (B, T) for ``cfg``: f32 embeddings for the
    encoder and the VLM (``embeds_dtype`` casts them on the card), tokens
    for the others."""
    b, t = shape
    batch = mods["SyntheticLMDataset"](mods["DataConfig"](
        seq_len=t, global_batch=b, vocab=cfg.vocab, seed=seed,
        embed_dim=embed_dim(cfg))).batch_for(0)
    if embeds_dtype is not None:
        batch["embeds"] = torch.from_numpy(batch["embeds"]).to(
            device, embeds_dtype)
    return batch


def _counted_step(torch, mods, step_fn, holder, batch):
    """One counted step of ``step_fn`` on ``holder``'s state; returns
    (metrics as floats, counts, ms)."""
    reset_counts(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    holder["state"], m = step_fn(holder.pop("state"), batch)
    metrics = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    return metrics, read_counts(mods), (time.perf_counter() - t0) * 1e3


def _remat_fwd_bwd(torch, mods, cfg, holder, batch, device) -> dict:
    """The loss and gradients of ``holder``'s params on ``batch`` (the
    step's forward and backward) under the current remat policy, with the
    GB its forward keeps for the backward, the peak and the time."""
    T = mods["T"]
    leaves = mods["tree_flatten"](holder["state"]["params"])[0]
    labels = torch.from_numpy(batch["labels"]).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for p in leaves:
        p.requires_grad_()
    try:
        loss = T.loss_fn(holder["state"]["params"], None, labels, cfg,
                         embeds=batch["embeds"])
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        loss.backward()
        # (the token embedding of a model fed embeddings gets none)
        gnorm = float(torch.sqrt(sum(p.grad.float().pow(2).sum()
                                     for p in leaves if p.grad is not None)))
        torch.cuda.synchronize()
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    return {"loss": float(loss.detach()), "grad_norm": gnorm,
            "forward_backward_ms": (time.perf_counter() - t0) * 1e3,
            "held_gb": held / 2**30,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def full_depth_agreement(torch, mods, cfg, holder, batch, device) -> dict:
    """The loss and the global gradient norm of ``holder``'s params on
    ``batch`` at full depth under chunked attention (the plain path) and
    under flash (the kernels), each within TRAIN_LOSS_TOL of the chunked
    one: the whole model's gradient, where the train consistency phase
    holds every leaf at 2 layers.  Returns both, with the seconds each
    took and the peak GB of the two; the peak count restarts after them."""
    flags = mods["flags"]
    on_card = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out = {}
    for impl in ("chunked", "flash"):
        flags.set_attn_impl(impl)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = mods["loss_and_grads"](cfg, holder["state"]["params"],
                                                 on_card)
            gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                         for g in grads)))
            out[impl] = {"loss": float(loss), "grad_norm": gnorm,
                         "s": time.perf_counter() - t0}
            del grads
        finally:
            flags.set_attn_impl("flash")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    for key in ("loss", "grad_norm"):
        want, got = out["chunked"][key], out["flash"][key]
        check(math.isfinite(got) and abs(got - want) <= TRAIN_LOSS_TOL
              * abs(want), f"families train {cfg.name}: full-depth {key} "
              f"{got} under flash, {want} under chunked")
    return out


def families_train_phase(torch, mods, device, seed):
    """The families' training path on the card (``make_train_step``, which
    updates the state in place, under flash attention): HuBERT-XLarge (48
    layers, the data pipeline's f32 embeddings: the split-TF32 forward and
    backward at d 80):
    the full-depth loss and gradient norm under flash against chunked,
    then under ``StepRunner`` 1 warm-up and 3 timed steps whose loss must
    fall with a checkpoint saved and restored, one step on bf16 embeddings
    (the tensor-core kernels at d 80), and the one-step-warm-up control;
    Phi-3-Vision-4.2B (32 layers, bf16 embeddings, d 96): the
    forward and backward of one batch under remat none, dots and full
    (the activations kept full < dots < none, peaks full < none, the same
    loss), then 1 + 3 steps under full remat with a checkpoint, the loss
    falling; DeepSeek-V3 at full width cut to its first
    layer and the MTP block: one step on tokens, the loss with and without
    the MTP term; then HuBERT and Phi-3-Vision in f32 cut to 2 layers,
    flash gradients against chunked ones (the split-TF32 backward at d 80
    and 96).  Returns the counted launches."""
    T, flags, configs = mods["T"], mods["flags"], mods["configs"]
    opt_cfg = mods["AdamWConfig"]()
    runs = []
    flags.set_attn_impl("flash")
    try:
        # -- HuBERT-XLarge: f32 embeddings, then bf16 ---------------------
        cfg = configs.get_config("hubert-xlarge")
        holder, n_params, state_gb = _family_state(torch, mods, cfg, opt_cfg,
                                                   seed + 60, device)
        batch = _family_batch(torch, mods, cfg, FAMILY_TRAIN_SHAPE, seed + 61,
                              device)
        check(batch["embeds"].dtype == mods["np"].float32
              and cfg.dtype == "bfloat16",
              "families train: the pipeline's HuBERT embeddings are not f32")
        agree = full_depth_agreement(torch, mods, cfg, holder, batch,
                                     device)
        want = flash_step_launches(cfg.n_layers, False, cfg.head_dim,
                                   grouped=cfg.n_heads != cfg.n_kv_heads)
        step_fn, res = run_training(torch, mods, cfg, holder, batch, want,
                                    opt_cfg, warmup=FAMILY_TRAIN_WARMUP,
                                    timed=FAMILY_TRAIN_TIMED)
        res.update(profiled_step(torch, step_fn, holder, batch,
                                 res["ms_per_step"]))
        runs += res.pop("runs")
        _family_row(torch, "families train", cfg, runs[-1], want,
                    params=n_params, state_gb=state_gb, remat="none",
                    embeds="float32", batch=FAMILY_TRAIN_SHAPE[0],
                    seq=FAMILY_TRAIN_SHAPE[1], full_depth=agree, **res)
        bf16_batch = _family_batch(torch, mods, cfg, FAMILY_TRAIN_SHAPE, seed + 61,
                                   device, torch.bfloat16)
        step_fn = mods["make_train_step"](cfg, opt_cfg, total_steps=10)
        metrics, counts, ms = _counted_step(torch, mods, step_fn, holder,
                                            bf16_batch)
        check(math.isfinite(metrics["loss"]), f"families train {cfg.name}: "
              f"bf16 embeds loss {metrics['loss']}")
        runs.append(counts)
        _family_row(torch, "families train", cfg, counts,
                    flash_step_launches(cfg.n_layers, True, cfg.head_dim),
                    remat="none", embeds="bfloat16", loss=metrics["loss"],
                    step_ms=ms)
        holder.clear()
        # the control: the same run from the same weights with a one-step
        # warm-up (lr at its peak on the second step)
        holder = _family_state(torch, mods, cfg, opt_cfg, seed + 60,
                               device)[0]
        step_fn = mods["make_train_step"](
            cfg, opt_cfg, total_steps=FAMILY_TRAIN_WARMUP + FAMILY_TRAIN_TIMED)
        control = []
        for _ in range(FAMILY_TRAIN_WARMUP + FAMILY_TRAIN_TIMED):
            metrics, counts, _ = _counted_step(torch, mods, step_fn, holder,
                                               batch)
            check(counts == want, f"families train {cfg.name}: a control "
                  f"step launched {counts}, expected {want}")
            runs.append(counts)
            control.append(metrics)
        _family_row(torch, "families train", cfg, counts, want,
                    what="the control: a one-step warm-up",
                    embeds="float32",
                    losses=[m["loss"] for m in control],
                    grad_norms=[m["grad_norm"] for m in control],
                    lrs=[m["lr"] for m in control])
        check(all(math.isfinite(m["loss"]) for m in control),
              f"families train {cfg.name}: control losses {control}")
        holder.clear()
        del batch, bf16_batch, step_fn

        # -- Phi-3-Vision: remat none / dots / full, then training --------
        cfg = configs.get_config("phi-3-vision-4.2b")
        holder, n_params, state_gb = _family_state(torch, mods, cfg, opt_cfg,
                                                   seed + 62, device)
        batch = _family_batch(torch, mods, cfg, FAMILY_TRAIN_SHAPE, seed + 63,
                              device, torch.bfloat16)
        n = cfg.n_layers
        remat = {}
        for policy in REMAT_POLICIES:
            flags.set_remat(policy)
            try:
                # the first call under a policy loads what its checkpoint
                # needs (dots: seconds); the second is counted and timed
                _remat_fwd_bwd(torch, mods, cfg, holder, batch, device)
                reset_counts(mods)
                remat[policy] = _remat_fwd_bwd(torch, mods, cfg, holder,
                                               batch, device)
                counts = read_counts(mods)
            finally:
                flags.set_remat("none")
            want = flash_step_launches(n, True, cfg.head_dim,
                                       forwards=n if policy == "none"
                                       else 2 * n)
            check(counts == want, f"families train {cfg.name} remat "
                  f"{policy}: launches {counts}, expected {want}")
            runs.append(counts)
        base = remat["none"]["loss"]
        print(json.dumps({"phase": "families train", "arch": cfg.name,
                          "what": "one forward and backward of the same "
                                  "params and batch under each remat",
                          "batch": FAMILY_TRAIN_SHAPE[0],
                          "seq": FAMILY_TRAIN_SHAPE[1], "remat": remat}),
              flush=True)
        check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                  for r in remat.values()),
              f"families train {cfg.name}: remat losses {remat}")
        check(all(abs(r["loss"] - base) <= TRAIN_LOSS_TOL * abs(base)
                  for r in remat.values()),
              f"families train {cfg.name}: the remat policies' losses "
              f"differ: {remat}")
        # what each policy keeps for the backward orders them strictly; the
        # peak adds the gradients, which end the backward beside the state
        held = {p: r["held_gb"] for p, r in remat.items()}
        peaks = {p: r["peak_gb"] for p, r in remat.items()}
        check(held["full"] < held["dots"] < held["none"],
              f"families train {cfg.name}: activations kept {held}, "
              f"expected full < dots < none")
        check(peaks["full"] <= peaks["dots"] <= peaks["none"]
              and peaks["full"] < peaks["none"],
              f"families train {cfg.name}: peaks {peaks}, expected full "
              f"<= dots <= none and full < none")
        torch.cuda.reset_peak_memory_stats()
        want = flash_step_launches(n, True, cfg.head_dim, forwards=2 * n)
        flags.set_remat("full")
        try:
            step_fn, res = run_training(torch, mods, cfg, holder, batch,
                                        want, opt_cfg,
                                        warmup=FAMILY_TRAIN_WARMUP,
                                        timed=FAMILY_TRAIN_TIMED)
            res.update(profiled_step(torch, step_fn, holder, batch,
                                     res["ms_per_step"]))
        finally:
            flags.set_remat("none")
        runs += res.pop("runs")
        _family_row(torch, "families train", cfg, runs[-1], want,
                    params=n_params, state_gb=state_gb, remat="full",
                    embeds="bfloat16", batch=FAMILY_TRAIN_SHAPE[0],
                    seq=FAMILY_TRAIN_SHAPE[1], **res)
        holder.clear()
        del batch

        # -- DeepSeek-V3 with its MTP term, cut to one layer --------------
        full = configs.get_config("deepseek-v3-671b")
        cfg = mods["dc"].replace(full, n_layers=DEEPSEEK_TRAIN_LAYERS)
        check(cfg.mtp_depth == 1, f"{cfg.name}: no MTP head")
        holder, n_params, state_gb = _family_state(torch, mods, cfg, opt_cfg,
                                                   seed + 64, device)
        batch = _family_batch(torch, mods, cfg, FAMILY_TRAIN_SHAPE, seed + 65,
                              device)
        params = holder["state"]["params"]
        toks, labels = (torch.from_numpy(batch[k]).to(device)
                        for k in ("tokens", "labels"))
        with torch.no_grad():
            loss_mtp = float(T.loss_fn(params, toks, labels, cfg))
            loss_base = float(T.loss_fn(params, None, labels, cfg,
                                        embeds=T.embed(params, toks, cfg)))
        del params
        step_fn = mods["make_train_step"](cfg, opt_cfg, total_steps=10)
        metrics, counts, ms = _counted_step(torch, mods, step_fn, holder,
                                            batch)
        runs.append(counts)
        check(all(math.isfinite(x) for x in (loss_mtp, loss_base,
                                              metrics["loss"],
                                              metrics["grad_norm"])),
              f"families train {cfg.name}: losses {loss_mtp}, {loss_base}, "
              f"{metrics}")
        check(loss_mtp > loss_base, f"families train {cfg.name}: the MTP "
              f"term adds nothing ({loss_mtp} <= {loss_base})")
        check(abs(metrics["loss"] - loss_mtp) <= TRAIN_LOSS_TOL * loss_mtp,
              f"families train {cfg.name}: the step's loss "
              f"{metrics['loss']} is not the MTP loss {loss_mtp}")
        _family_row(torch, "families train", cfg, counts, expect(),
                    params=n_params, state_gb=state_gb,
                    reduced={"n_layers": f"{full.n_layers} -> "
                                         f"{cfg.n_layers}, and the MTP block"},
                    batch=FAMILY_TRAIN_SHAPE[0],
                    seq=FAMILY_TRAIN_SHAPE[1], loss=metrics["loss"],
                    loss_without_mtp=loss_base, loss_mtp_before_step=loss_mtp,
                    grad_norm=metrics["grad_norm"], step_ms=ms)
        holder.clear()
        del step_fn, batch, toks, labels
        torch.cuda.empty_cache()
    finally:
        flags.set_attn_impl("chunked")
        flags.set_remat("none")
    for arch in ("hubert-xlarge", "phi-3-vision-4.2b"):
        runs.append(train_consistency_phase(torch, mods, device, seed,
                                            full=configs.get_config(arch)))
    return sum_counts(runs)


# ---------------------------------------------------------------------------
# the model families: OLMoE-1B-7B (MoE) served at full width, the flash
# forward at head dims 80 and 96, and Mamba2, Phi-3-Vision, HuBERT,
# DeepSeek-V3 and Jamba at full width
# ---------------------------------------------------------------------------

def flash_dims_kernel_phase(torch, mods, device, seed):
    """Every flash kernel at head dims 80 (HuBERT-XLarge: 16 heads, B 1,
    T 2048, bidirectional) and 96 (Phi-3-Vision: 32 heads, B 1, T 2048,
    causal), each against its plain version: both forwards, the
    tensor-core kernels in bf16 (``flash_tc_row``, ``flash_bwd_tc_rows``)
    and the split-TF32 kernels in f32 (``flash_f32_rows``);
    then the tensor-core backward at d 96 over GQA 32:8 and at d 80 over a
    ragged bidirectional T of 2000.  Returns (per-kernel lists of rows, the
    GQA and ragged rows by kernel)."""
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    rows = {}
    for d, (arch, shape, causal) in FLASH_DIM_SHAPES.items():
        rows[f"flash_attention_tc_d{d}"] = [flash_tc_row(
            torch, mods, gen, device, shape, causal,
            f"flash_attention_tc_d{d}", arch=arch)]
        bwd = flash_bwd_tc_rows(
            torch, mods, gen, device, shape, causal,
            (f"flash_attention_bwd_dq_tc_d{d}",
             f"flash_attention_bwd_dkv_tc_d{d}"), arch=arch)
        bwd.update(flash_f32_rows(
            torch, mods, gen, device, shape, causal,
            (f"flash_attention_d{d}", f"flash_attention_bwd_dq_d{d}",
             f"flash_attention_bwd_dkv_d{d}"), arch=arch))
        rows.update({name: [row] for name, row in bwd.items()})
    extra = {}
    for d, (arch, (b, h, kv, t, _), causal) in FLASH_DIM_SHAPES.items():
        shape, label = ((b, h, FLASH_GQA_KV, t, d), f"{arch}, GQA {h}:"
                        f"{FLASH_GQA_KV}") if causal else (
            (b, h, kv, FLASH_RAGGED_T, d), f"{arch}, T {FLASH_RAGGED_T}")
        for name, row in flash_bwd_tc_rows(
                torch, mods, gen, device, shape, causal,
                (f"flash_attention_bwd_dq_tc_d{d}",
                 f"flash_attention_bwd_dkv_tc_d{d}"), arch=label).items():
            extra.setdefault(name, []).append(row)
    return rows, extra


# ---------------------------------------------------------------------------
# any block, any head dim: Yi-9B at (128, 128) tiles, OLMoE's head dim 24
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_launches(torch, mods):
    """The bsr_matmul and flash forward launchers swapped for their plain
    versions while the block runs, on the same CUDA tensors (the
    comparison's other side; nothing is counted)."""
    bm, fm = mods["launchers"]["bsr_matmul"], mods["launchers"]["flash"]
    saved = bm._launch, fm._launch
    bm._launch = (lambda x, blocks, blockcol, nblocks, out_dtype, sched=None:
                  mods["matmul_plain"](x, blocks, blockcol,
                                       nblocks).to(out_dtype))
    fm._launch = (lambda q, k, v, sc, causal:
                  mods["flash_plain"](q, k, v, sc=sc, causal=causal))
    try:
        yield
    finally:
        bm._launch, fm._launch = saved


def blocks_plain_layer(torch, mods, device, seed) -> dict:
    """Yi-9B cut to one layer, bf16, sparsity 0.8 in (128, 128) tiles: the
    forward's logits (B 1, T 512) through the kernels against the same
    forward through their plain versions (relative norm within
    BLOCKS_PLAIN_RTOL)."""
    np, T = mods["np"], mods["T"]
    cfg = mods["dc"].replace(mods["yi9b"], n_layers=1)
    params = llm_params(torch, mods, cfg, LLM_SPARSITY, seed, device,
                        BLOCKS_BLOCK)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, 512))).to(device)
    mods["flags"].set_attn_impl("flash")
    try:
        reset_counts(mods)
        got, _ = T.forward(params, toks, cfg)
        torch.cuda.synchronize()
        counts = read_counts(mods)
        with plain_launches(torch, mods):
            want, _ = T.forward(params, toks, cfg)
    finally:
        mods["flags"].set_attn_impl("chunked")
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    want_counts = expect(bsr_matmul=7, flash_attention_tc=1,
                         **block_counts("rows", BLOCKS_BLOCK, 7))
    row = {"phase": "blocks plain layer", "arch": cfg.name,
           "block": list(BLOCKS_BLOCK), "layers": 1, "batch": 1, "seq": 512,
           "launches": counts, "logits_rel_norm_from_plain": rel,
           "tolerance": BLOCKS_PLAIN_RTOL}
    print(json.dumps(row), flush=True)
    check(counts == want_counts, f"blocks plain layer: launches {counts}, "
          f"expected {want_counts}")
    check(bool(torch.isfinite(got).all()), "blocks plain layer: non-finite "
          "logits")
    check(rel <= BLOCKS_PLAIN_RTOL, f"blocks plain layer: the kernels' "
          f"logits are {rel} from the plain versions' (relative norm, "
          f"tolerance {BLOCKS_PLAIN_RTOL})")
    del params, got, want
    torch.cuda.empty_cache()
    return counts


def blocks_phase(torch, mods, device, seed):
    """Yi-9B at the reference's default (128, 128) tiles: bsr_matmul's rows
    3d (``bsr_matmul_row`` at each of BLOCKS_ROW_BLOCKS on LLM_PROJECTIONS,
    4 rows on the rows schedule, 8192 on wgmma, each against its plain
    version); one layer's forward against its plain versions; the prefill
    (B 4 x T 2048, wgmma) and ServeEngine (8 requests, rows) at full width
    and depth, and the f32 forward against decode cut to
    BLOCKS_CONSIST_LAYERS layers, every projection counted by schedule and
    block.  Returns (the counted launches, rows by kernel, the (64, 128)
    rows by kernel)."""
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    rows, extra = {}, {}
    for block in BLOCKS_ROW_BLOCKS:
        for name, d_in, d_out in LLM_PROJECTIONS:
            bc, w_lib = pruned_bank(torch, mods, gen, d_in, d_out, device,
                                    block)
            for b, t in (LLM_ACTIVATIONS[0], LLM_ACTIVATIONS[-1]):
                row = bsr_matmul_row(torch, mods, gen, device, bc, w_lib,
                                     name, b, t,
                                     arch=f"yi-9b, {block} tiles")
                key = f"bsr_matmul_{row['schedule']}_b128"
                (rows if tuple(block) == BLOCKS_BLOCK
                 else extra).setdefault(key, []).append(row)
            del bc, w_lib
            torch.cuda.empty_cache()
    yi = mods["yi9b"]
    runs = [blocks_plain_layer(torch, mods, device, seed + 6),
            llm_prefill_phase(torch, mods, device, seed + 7,
                              phase="blocks_prefill", block=BLOCKS_BLOCK,
                              sparsities=(LLM_SPARSITY,)),
            llm_serve_phase(torch, mods, device, seed + 8,
                            phase="blocks_serve", block=BLOCKS_BLOCK),
            llm_consistency_phase(
                torch, mods, device, seed + 9, mods["dc"].replace(
                    yi, dtype="float32", n_layers=BLOCKS_CONSIST_LAYERS),
                phase="blocks_consistency", block=BLOCKS_BLOCK)]
    return sum_counts(runs), rows, extra


def any_dim_refused(torch, mods, device) -> None:
    """Head dims whose rows the kernels' 16-byte copies cannot cover
    (ANY_DIM_REFUSED): the raw forward launcher raises on the card, naming
    the row, and launches nothing (no fallback; flash_attention_bthd pads
    such a d first)."""
    fwd = mods["kernels"]["flash_attention"]
    for dt, d in ANY_DIM_REFUSED:
        q = torch.zeros((1, 2, 64, d), device=device,
                        dtype=getattr(torch, dt))
        row = d * q.element_size()
        before = read_counts(mods)
        try:
            fwd(q, q, q, sc=d ** -0.5, causal=True)
            raised = ""
        except ValueError as e:
            raised = str(e)
        check(f"a row of {row} bytes" in raised, f"flash at head dim {d} "
              f"({dt}) did not raise naming its {row}-byte row: {raised!r}")
        check(read_counts(mods) == before, f"flash at head dim {d} "
              f"launched a kernel")
        print(json.dumps({"phase": "any dim refused", "d": d, "dtype": dt,
                          "raised": raised}), flush=True)


def any_dim_phase(torch, mods, device, seed):
    """Head dims the kernels run in a larger instantiation.  Rows 4c-6c:
    the tensor-core forward, dQ and dK/dV (bf16) and the split-TF32 ones
    (f32) at each of ANY_DIM_DIMS at HuBERT-XLarge's shape, each against
    its plain version (``flash_tc_row``, ``flash_bwd_tc_rows``,
    ``flash_f32_rows``); d ANY_DIM_REFUSED refused.  Then OLMoE-1B-7B's
    smoke config (d 24) through flash: its prefill in bf16 and f32 against
    the same prefill through chunked attention, and a train step: in f32
    the gradients against chunked (``train_consistency_phase``, at a
    capacity that drops no assignment), in bf16 one counted step.
    Returns (the counted launches, rows by kernel, the d 48 rows by
    kernel)."""
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    rows, extra = {}, {}
    main_d = ANY_DIM_DIMS[0]
    for d in ANY_DIM_DIMS:
        shape = (*ANY_DIM_SHAPE, d)
        arch = f"hubert-xlarge shape, d {d}"
        got = {f"flash_attention_tc_d{main_d}": flash_tc_row(
            torch, mods, gen, device, shape, False,
            f"flash_attention_tc_d{main_d}", arch=arch)}
        got.update(flash_bwd_tc_rows(
            torch, mods, gen, device, shape, False,
            (f"flash_attention_bwd_dq_tc_d{main_d}",
             f"flash_attention_bwd_dkv_tc_d{main_d}"), arch=arch))
        got.update(flash_f32_rows(
            torch, mods, gen, device, shape, False,
            (f"flash_attention_d{main_d}", f"flash_attention_bwd_dq_d{main_d}",
             f"flash_attention_bwd_dkv_d{main_d}"), arch=arch))
        for name, row in got.items():
            (rows if d == main_d else extra).setdefault(name, []).append(row)
    any_dim_refused(torch, mods, device)

    np, T, flags = mods["np"], mods["T"], mods["flags"]
    smoke = mods["configs"].get_config(ANY_DIM_ARCH, smoke=True)
    check(smoke.head_dim == main_d, f"{smoke.name}: head dim "
          f"{smoke.head_dim}, not {main_d}")
    runs = []
    b, t = ANY_DIM_PREFILL
    for dtype in ("bfloat16", "float32"):
        cfg = mods["dc"].replace(smoke, dtype=dtype)
        params = T.init_params(cfg, torch.Generator(
            device=device).manual_seed(seed + 9), device)
        toks = torch.from_numpy(np.random.default_rng(seed + 9).integers(
            0, cfg.vocab, (b, t))).to(device)
        step = mods["make_prefill_step"](cfg)
        logits = {}
        for impl in ("chunked", "flash"):
            flags.set_attn_impl(impl)
            try:
                reset_counts(mods)
                logits[impl], _ = step(params, {"tokens": toks})
                torch.cuda.synchronize()
                counts = read_counts(mods)
            finally:
                flags.set_attn_impl("chunked")
        tc = "_tc" if dtype == "bfloat16" else ""
        want = expect(**{f"flash_attention{tc}": cfg.n_layers,
                         f"flash_attention{tc}_d{main_d}": cfg.n_layers})
        got_l, want_l = logits["flash"].float(), logits["chunked"].float()
        rel = float((got_l - want_l).norm() / want_l.norm())
        tol = BF16_TOL if dtype == "bfloat16" else MESH_F32_RTOL
        row = {"phase": "any dim prefill", "arch": cfg.name, "dtype": dtype,
               "head_dim": cfg.head_dim, "batch": b, "seq": t,
               "launches": counts, "logits_rel_norm_from_chunked": rel,
               "tolerance": tol}
        print(json.dumps(row), flush=True)
        check(counts == want, f"any dim prefill {dtype}: launches {counts}, "
              f"expected {want}")
        check(bool(torch.isfinite(got_l).all()), f"any dim prefill {dtype}: "
              f"non-finite logits")
        check(rel <= tol, f"any dim prefill {dtype}: flash logits {rel} "
              f"from chunked (relative norm, tolerance {tol})")
        runs.append(counts)
        del params, logits
        torch.cuda.empty_cache()
    saved = flags.MOE_CAPACITY
    flags.set_moe_capacity(MOE_CONSIST_CAPACITY)
    try:
        runs.append(train_consistency_phase(torch, mods, device, seed + 10,
                                            full=smoke))
    finally:
        flags.set_moe_capacity(saved)
    opt_cfg = mods["AdamWConfig"]()
    holder, _, _ = _family_state(torch, mods, smoke, opt_cfg, seed + 11,
                                 device)
    batch = _family_batch(torch, mods, smoke, (b, t), seed + 11, device)
    step = mods["make_train_step"](smoke, opt_cfg, total_steps=10)
    flags.set_attn_impl("flash")
    try:
        metrics, counts, ms = _counted_step(torch, mods, step, holder, batch)
    finally:
        flags.set_attn_impl("chunked")
    want = flash_step_launches(smoke.n_layers, True, main_d)
    print(json.dumps({"phase": "any dim train", "arch": smoke.name,
                      "dtype": smoke.dtype, "batch": b, "seq": t,
                      "launches": counts, "loss": metrics["loss"],
                      "step_ms": ms}), flush=True)
    check(counts == want, f"any dim train bf16: a step launched {counts}, "
          f"expected {want}")
    check(math.isfinite(metrics["loss"]), "any dim train bf16: loss not "
          "finite")
    runs.append(counts)
    del holder
    torch.cuda.empty_cache()
    return sum_counts(runs), rows, extra


# ---------------------------------------------------------------------------
# wide heads: head dims above 128 through the output-column split
# ---------------------------------------------------------------------------

def wide_counted(torch, mods, device, seed) -> list:
    """flash_attention_bthd's forward and backward at each of WIDE_DIMS,
    bf16 and f32, at Gemma-7B's attention shape, each counted: the wide
    kernels at their head dim's key, nothing else.  Returns the counts."""
    b, h, kv, t = WIDE_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed)
    runs = []
    for d in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            leaves = [torch.randn((b, t, n, d), generator=gen, device=device)
                      .to(dtype).requires_grad_() for n in (h, kv, kv)]
            do = torch.randn((b, t, h, d), generator=gen,
                             device=device).to(dtype)
            reset_counts(mods)
            out = mods["flash_bthd"](*leaves, causal=True)
            out.backward(do)
            torch.cuda.synchronize()
            counts = read_counts(mods)
            bf16 = dtype == torch.bfloat16
            want = flash_step_launches(1, bf16, d)
            print(json.dumps({"phase": "wide counted", "d": d,
                              "dtype": str(dtype).split(".")[-1],
                              "shape": [b, h, kv, t], "launches": counts}),
                  flush=True)
            check(counts == want, f"wide counted d {d} {dtype}: launches "
                  f"{counts}, expected {want}")
            check(all(bool(torch.isfinite(x.grad).all()) for x in leaves),
                  f"wide counted d {d} {dtype}: gradients not finite")
            runs.append(counts)
            del leaves, do, out
    torch.cuda.empty_cache()
    return runs


def wide_path(torch, mods, device, seed) -> list:
    """Yi-9B re-headed to Gemma-7B's head dim (WIDE_HEADS), cut to
    WIDE_LAYERS layers: its bf16 flash prefill (WIDE_PREFILL) against the
    same prefill through chunked attention, its f32 gradients through
    flash against chunked (``train_consistency_phase``, 2 layers), and one
    counted bf16 train step; every flash launch at the wide key.  Returns
    the counts."""
    np, T, flags = mods["np"], mods["T"], mods["flags"]
    yi = mods["yi9b"]
    full = mods["dc"].replace(yi, name=f"{yi.name}-d256", **WIDE_HEADS)
    check(full.n_heads * full.head_dim == full.d_model == yi.d_model
          and full.n_heads // full.n_kv_heads
          == yi.n_heads // yi.n_kv_heads, f"{full.name}: not Yi-9B's width "
          f"and group size")
    cfg = mods["dc"].replace(full, n_layers=WIDE_LAYERS)
    d = cfg.head_dim
    runs = []
    b, t = WIDE_PREFILL
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t))).to(device)
    step = mods["make_prefill_step"](cfg)
    logits = {}
    for impl in ("chunked", "flash"):
        flags.set_attn_impl(impl)
        try:
            reset_counts(mods)
            logits[impl], _ = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            counts = read_counts(mods)
        finally:
            flags.set_attn_impl("chunked")
    want = expect(**{"flash_attention_tc": cfg.n_layers,
                     f"flash_attention_tc_d{d}": cfg.n_layers})
    got_l, want_l = logits["flash"].float(), logits["chunked"].float()
    rel = float((got_l - want_l).norm() / want_l.norm())
    row = {"phase": "wide prefill", "arch": cfg.name, "dtype": cfg.dtype,
           "heads": [cfg.n_heads, cfg.n_kv_heads, d],
           "d_model": cfg.d_model, "layers": cfg.n_layers,
           "reduced": {"n_layers": f"{yi.n_layers} -> {cfg.n_layers}"},
           "batch": b, "seq": t, "launches": counts,
           "logits_rel_norm_from_chunked": rel, "tolerance": BF16_TOL}
    print(json.dumps(row), flush=True)
    check(counts == want, f"wide prefill: launches {counts}, expected "
          f"{want}")
    check(bool(torch.isfinite(got_l).all()), "wide prefill: non-finite "
          "logits")
    check(rel <= BF16_TOL, f"wide prefill: flash logits {rel} from chunked "
          f"(relative norm, tolerance {BF16_TOL})")
    runs.append(counts)
    del params, logits, got_l, want_l
    torch.cuda.empty_cache()
    runs.append(train_consistency_phase(torch, mods, device, seed + 1,
                                        full=full))
    opt_cfg = mods["AdamWConfig"]()
    holder, n_params, state_gb = _family_state(torch, mods, cfg, opt_cfg,
                                               seed + 2, device)
    batch = _family_batch(torch, mods, cfg, WIDE_PREFILL, seed + 2, device)
    step = mods["make_train_step"](cfg, opt_cfg, total_steps=10)
    flags.set_attn_impl("flash")
    try:
        metrics, counts, ms = _counted_step(torch, mods, step, holder, batch)
    finally:
        flags.set_attn_impl("chunked")
    want = flash_step_launches(cfg.n_layers, True, d)
    print(json.dumps({"phase": "wide train", "arch": cfg.name,
                      "dtype": cfg.dtype, "layers": cfg.n_layers,
                      "params": n_params, "state_gb": state_gb,
                      "batch": b, "seq": t, "launches": counts,
                      "loss": metrics["loss"], "step_ms": ms,
                      "peak_gb": torch.cuda.max_memory_allocated() / 2**30}),
          flush=True)
    check(counts == want, f"wide train bf16: a step launched {counts}, "
          f"expected {want}")
    check(math.isfinite(metrics["loss"]), "wide train bf16: loss not "
          "finite")
    runs.append(counts)
    del holder
    torch.cuda.empty_cache()
    return runs


def wide_guard(torch, mods, device, seed) -> None:
    """Each wide kernel at each of WIDE_DIMS, bf16 and f32, over GQA
    16:WIDE_GQA_KV (T 2048 causal, WIDE_RAGGED_T bidirectional), launched
    WIDE_GUARD_REPEATS times on the raw launchers (uncounted), every
    operand a view into a buffer with NaN past d and around it: each
    launch must write every output element (all finite), nothing outside
    it (the NaN there intact), read nothing past d (a NaN read would reach
    the outputs), and give the bits of the first launch and of the
    wrappers on contiguous copies.  A launch fault raises here."""
    fk = mods["launchers"]["flash"]
    gen = torch.Generator(device=device).manual_seed(seed)
    b, h, _, t2 = WIDE_SHAPE
    kv, pad, nan = WIDE_GQA_KV, WIDE_GUARD_PAD, float("nan")

    def guarded(shape, dtype, cols):
        """A ``shape`` view into a NaN buffer of rows ``cols`` wide, with
        ``pad`` elements before and after; returns (view, buffer)."""
        n = math.prod(shape[:-1]) * cols
        buf = torch.full((n + 2 * pad,), nan, dtype=dtype, device=device)
        return buf[pad:pad + n].view(*shape[:-1], cols)[..., :shape[-1]], buf

    def intact(view, buf):
        return (torch.isfinite(view).all()
                & (torch.isnan(buf).sum() == buf.numel() - view.numel()))

    for d in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            tag = "_tc" if dtype == torch.bfloat16 else ""
            for t, causal in ((t2, True), (WIDE_RAGGED_T, False)):
                sizes, sc = (b, h, kv, t, t, d), d ** -0.5
                q, k, v, do = (guarded((b, n, t, d), dtype, d + pad)[0]
                               for n in (h, kv, kv, h))
                for x in (q, k, v, do):
                    x.copy_(torch.randn(x.shape, generator=gen,
                                        device=device))
                out = {"o": guarded((b, h, t, d), dtype, d + pad),
                       "lse": guarded((b, h, t), torch.float32, t),
                       "dq": guarded((b, h, t, d), dtype, d + pad),
                       "dk": guarded((b, kv, t, d), dtype, d + pad),
                       "dv": guarded((b, kv, t, d), dtype, d + pad)}
                # the group sums' f32 parts (B, H, S, d): margins only
                parts = [guarded((b, h, t, d), torch.float32, d)
                         for _ in range(2)]
                lse_in = guarded((b, h, t), torch.float32, t)[0]
                delta = guarded((b, h, t), torch.float32, t)[0]
                o, lse, dq, dk, dv = (out[n][0] for n in out)
                launches = {
                    "fwd": ((q, k, v, o, lse), (q, k, v, o), ("o", "lse")),
                    "bwd_dq": ((q, k, v, do, lse_in, delta, dq),
                               (q, k, v, do, dq), ("dq",)),
                    "bwd_dkv": ((q, k, v, do, lse_in, delta, dk, dv,
                                 parts[0][0], parts[1][0]),
                                (q, k, v, do, dk, dv), ("dk", "dv"))}
                qc, kc, vc, doc = (x.contiguous() for x in (q, k, v, do))
                ok = torch.ones((), dtype=torch.bool, device=device)
                first, wrapped = {}, {}
                for part, (pointers, strided, names) in launches.items():
                    for r in range(WIDE_GUARD_REPEATS):
                        for n in names:
                            out[n][1].fill_(nan)
                        fk._call(f"flash_attention_{part}{tag}", pointers,
                                 sizes, strided, sc, causal, dtype)
                        for n in names:
                            ok &= intact(*out[n])
                            if r == 0:
                                first[n] = out[n][0].clone()
                            else:
                                ok &= (out[n][0] == first[n]).all()
                        for _, buf in parts:
                            ok &= (torch.isnan(buf[:pad]).all()
                                   & torch.isnan(buf[-pad:]).all())
                    if part == "fwd":
                        wrapped["o"], wrapped["lse"] = fk.flash_attention_fwd(
                            qc, kc, vc, sc=sc, causal=causal)
                        lse_in.copy_(wrapped["lse"])
                        delta.copy_(fk.bwd_delta(wrapped["o"], doc))
                wrapped["dq"] = fk.flash_attention_bwd_dq(
                    qc, kc, vc, doc, lse_in.clone(), delta.clone(), sc=sc,
                    causal=causal)
                wrapped["dk"], wrapped["dv"] = fk.flash_attention_bwd_dkv(
                    qc, kc, vc, doc, lse_in.clone(), delta.clone(), sc=sc,
                    causal=causal)
                guard_ok = bool(ok)
                same = all(torch.equal(first[n], wrapped[n]) for n in first)
                row = {"phase": "wide guard", "d": d,
                       "dtype": str(dtype).split(".")[-1],
                       "shape": [b, h, kv, t], "causal": causal,
                       "repeats": WIDE_GUARD_REPEATS, "pad": pad,
                       "written_guarded_identical": guard_ok,
                       "same_as_wrappers": same}
                print(json.dumps(row), flush=True)
                check(guard_ok, f"wide guard d {d} {dtype} T {t}: an output "
                      f"element unwritten or non-finite, a write outside "
                      f"the outputs, or two launches' bits differ")
                check(same, f"wide guard d {d} {dtype} T {t}: the raw "
                      f"launches differ from the wrappers'")
                del q, k, v, do, out, parts, first, wrapped, qc, kc, vc, doc
    torch.cuda.empty_cache()


def wide_phase(torch, mods, device, seed):
    """Head dims above 128 (11d).  Rows 4d-6d: the tensor-core forward, dQ
    and dK/dV (bf16) and the split-TF32 ones (f32) at each of WIDE_DIMS at
    Gemma-7B's attention shape, each against its plain version
    (``flash_tc_row``, ``flash_bwd_tc_rows``, ``flash_f32_rows``; SDPA
    pinned for the library times); at d 256 the same over GQA and a ragged
    bidirectional T.  Then ``wide_guard``, ``wide_counted`` and
    ``wide_path``.  Returns
    (the counted launches, rows by kernel, the GQA and ragged rows by
    kernel)."""
    gen = torch.Generator(device=device).manual_seed(seed + 12)
    b, h, kv, t = WIDE_SHAPE
    d0 = WIDE_DIMS[0]
    cases = [((b, h, kv, t, d), True, f"gemma-7b attention, d {d}", True)
             for d in WIDE_DIMS]
    cases += [((b, h, WIDE_GQA_KV, t, d0), True,
               f"gemma-7b attention, d {d0}, GQA {h}:{WIDE_GQA_KV}", False),
              ((b, h, kv, WIDE_RAGGED_T, d0), False,
               f"gemma-7b attention, d {d0}, T {WIDE_RAGGED_T}, "
               f"bidirectional", False)]
    rows, extra = {}, {}
    for shape, causal, arch, main in cases:
        d = shape[-1]
        got = {f"flash_attention_tc_d{d}": flash_tc_row(
            torch, mods, gen, device, shape, causal,
            f"flash_attention_tc_d{d}", arch=arch,
            library_backend=WIDE_LIBRARY["bfloat16"])}
        got.update(flash_bwd_tc_rows(
            torch, mods, gen, device, shape, causal,
            (f"flash_attention_bwd_dq_tc_d{d}",
             f"flash_attention_bwd_dkv_tc_d{d}"), arch=arch,
            library_backend=WIDE_LIBRARY["bfloat16"]))
        got.update(flash_f32_rows(
            torch, mods, gen, device, shape, causal,
            (f"flash_attention_d{d}", f"flash_attention_bwd_dq_d{d}",
             f"flash_attention_bwd_dkv_d{d}"), arch=arch,
            library_backend=WIDE_LIBRARY["float32"]))
        for name, row in got.items():
            (rows if main else extra).setdefault(name, []).append(row)
    wide_guard(torch, mods, device, seed + 15)
    runs = wide_counted(torch, mods, device, seed + 13)
    runs += wide_path(torch, mods, device, seed + 14)
    return sum_counts(runs), rows, extra


def sum_counts(runs) -> dict:
    return {name: sum(run[name] for run in runs) for name in KERNEL_NAMES}


def moe_phase(torch, mods, device, seed):
    """OLMoE-1B-7B at full width and depth, bf16: ``bsr_matmul`` on wq and
    the flash forward at its shapes against their plain versions; the
    prefill (B 4 x T 2048) at sparsity 0.8 and 0.0 and ``ServeEngine`` at
    sparsity 0.8, counted (the Yi-9B phases' functions); then the f32
    prefill-vs-decode consistency cut to 2 layers at a capacity factor
    that drops no assignment.  Returns the counted launches and the kernel
    rows, by kernel."""
    cfg = mods["configs"].get_config(MOE_ARCH)
    gen = torch.Generator(device=device).manual_seed(seed + 40)
    bc, w_lib = pruned_bank(torch, mods, gen, cfg.d_model,
                            cfg.n_heads * cfg.head_dim, device)
    rows = {"bsr_matmul": [bsr_matmul_row(torch, mods, gen, device, bc,
                                          w_lib, "wq", b, t, arch=cfg.name)
                           for b, t in MOE_KERNEL_ROWS]}
    del bc, w_lib
    rows["flash_attention_tc"] = [flash_tc_row(
        torch, mods, gen, device, MOE_FLASH_SHAPE, True,
        "flash_attention_tc", arch=cfg.name)]
    runs = [llm_prefill_phase(torch, mods, device, seed + 40, cfg,
                              MOE_PROJECTIONS, "moe_prefill"),
            llm_serve_phase(torch, mods, device, seed + 40, cfg,
                            MOE_PROJECTIONS, "moe_serve")]
    flags = mods["flags"]
    saved = flags.MOE_CAPACITY
    flags.set_moe_capacity(MOE_CONSIST_CAPACITY)
    try:
        runs.append(llm_consistency_phase(
            torch, mods, device, seed + 40, mods["dc"].replace(
                cfg, dtype="float32", n_layers=MOE_CONSIST_LAYERS),
            MOE_PROJECTIONS, "moe_consistency"))
    finally:
        flags.set_moe_capacity(saved)
    return sum_counts(runs), rows


def _family_row(torch, phase, cfg, counts, want, **extra):
    """Checks a counted run's launches against ``want``; prints the row."""
    check(counts == want, f"{phase} {cfg.name}: launches {counts}, "
          f"expected {want}")
    row = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
           "dtype": cfg.dtype, "launches": {k: v for k, v in counts.items()
                                            if v},
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30, **extra}
    print(json.dumps(row), flush=True)
    return row


def _bsr(torch, mods, n_proj, rows) -> dict:
    """The ``bsr_matmul`` counts of ``n_proj`` launches at ``rows`` bf16
    rows: every one through the schedule ``schedule()`` picks there."""
    wgmma = mods["bsr_schedule"](rows, torch.bfloat16) == "wgmma"
    return {"bsr_matmul": n_proj, "bsr_matmul_wgmma": n_proj if wgmma else 0}


def _timed(torch, fn, reps=3):
    """Host-clock ms per call of ``fn`` over ``reps`` synchronised calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _decode_run(torch, mods, cfg, params, toks, n, device):
    """``n`` decode steps from an empty cache on the first column of
    ``toks`` then on each step's argmax, counted; returns (logits of the
    last step, counts, ms a step)."""
    T = mods["T"]
    cache = T.init_cache(cfg, toks.shape[0], n, device)
    step = mods["make_serve_step"](cfg)
    step(params, toks[:, :1], T.init_cache(cfg, toks.shape[0], 2, device), 0)
    torch.cuda.synchronize()
    reset_counts(mods)
    t0 = time.perf_counter()
    nxt = toks[:, 0]
    for i in range(n - 1):
        nxt, cache = step(params, nxt[:, None], cache, i)
    logits, cache = T.decode_step(params, cfg, nxt[:, None], cache, n - 1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    return logits, read_counts(mods), ms


def families_phase(torch, mods, device, seed):
    """The other five families at full width, each counted, with finite
    logits, peak memory and time: Mamba2-2.7B (64 layers) through
    ``serve.py``'s loop sparse and dense and a sparse prefill; Phi-3-Vision
    (32 layers, flash at d 96) ``forward_embeds`` and 16 decode steps,
    sparse; HuBERT-XLarge (48 layers, flash at d 80, bidirectional)
    ``forward_embeds``; DeepSeek-V3 cut to 4 layers (3 dense, 1 MoE of 256
    experts), prefill and absorbed MLA decode; Jamba-1.5-Large cut to 2
    layers (Mamba2 + MoE, Mamba2 + MLP), sparse prefill and decode; then
    HuBERT and Phi-3-Vision cut to 2 layers in f32, ``forward_embeds``
    through the split-TF32 flash forward at d 80 and 96 against the chunked
    attention.  ``bsr_matmul`` is held to its plain version at each
    family's shapes first: Mamba2's in_proj at a decode step and its
    prefill, Phi-3-Vision's wq at its forward's 2048 rows and Jamba's
    in_proj at its prefill's 1024 (both the ``rows`` schedule).  Returns
    the counted launches and those rows."""
    np, T, dc = mods["np"], mods["T"], mods["dc"]
    get = mods["configs"].get_config
    flags = mods["flags"]
    runs, kernel_rows = [], []
    gen = torch.Generator(device=device).manual_seed(seed + 50)
    rng = np.random.default_rng(seed + 51)

    def bank_rows(cfg, name, d_in, d_out, shapes):
        bc, w_lib = pruned_bank(torch, mods, gen, d_in, d_out, device)
        kernel_rows.extend(bsr_matmul_row(torch, mods, gen, device, bc,
                                          w_lib, name, b, t, arch=cfg.name)
                           for b, t in shapes)
        del bc, w_lib
        torch.cuda.empty_cache()

    def tokens(cfg, b, t):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (b, t))).to(device)

    def embeds(cfg, b, t, dtype):
        return (torch.randn((b, t, cfg.d_model), generator=gen, device=device)
                * 0.02).to(dtype)

    flags.set_attn_impl("flash")
    try:
        # -- Mamba2-2.7B: serve.py's loop, then a prefill ------------------
        cfg = get("mamba2-2.7b")
        bank_rows(cfg, "in_proj", cfg.d_model, _in_proj_width(cfg),
                  MAMBA2_KERNEL_ROWS)
        b, p, g = FAMILY_SERVE
        for sparsity in (LLM_SPARSITY, 0.0):
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            reset_counts(mods)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mods["serve_main"](["--arch", cfg.name, "--batch", str(b),
                                    "--prompt-len", str(p), "--gen", str(g),
                                    "--sparsity", str(sparsity), "--seed",
                                    str(seed + 52)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts(mods)
            out = buf.getvalue().strip().splitlines()
            check(any(f"generated {g} tokens x {b} seqs" in line
                      for line in out), f"serve.py {cfg.name}: {out}")
            n_proj = (p + g - 1) * cfg.n_layers * 2 if sparsity else 0
            _family_row(torch, "family_serve", cfg, counts,
                        expect(bsr_matmul=n_proj), seconds=wall,
                        sparsity=sparsity,
                        batch=b, prompt=p, gen=g, serve_output=out)
            runs.append(counts)
        torch.cuda.reset_peak_memory_stats()
        params = llm_params(torch, mods, cfg, LLM_SPARSITY, seed + 53,
                            device)
        b, t = MAMBA2_PREFILL
        batch = {"tokens": tokens(cfg, b, t)}
        step = mods["make_prefill_step"](cfg)
        (logits, _), counts = _counted_forward(torch, mods,
                                               lambda: step(params, batch))
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} prefill: "
              f"non-finite logits")
        ms = _timed(torch, lambda: step(params, batch))
        n_proj = cfg.n_layers * 2
        _family_row(torch, "family_prefill", cfg, counts,
                    expect(**_bsr(torch, mods, n_proj, b * t)),
                    sparsity=LLM_SPARSITY, batch=b, seq=t, forward_ms=ms,
                    tokens_per_s=b * t / ms * 1e3,
                    **device_breakdown(torch, lambda: step(params, batch), ms))
        runs.append(counts)
        del params, logits
        torch.cuda.empty_cache()

        # -- Phi-3-Vision: forward_embeds at d 96, then decode -------------
        cfg = get("phi-3-vision-4.2b")
        bank_rows(cfg, "wq", cfg.d_model, cfg.n_heads * cfg.head_dim,
                  (EMBEDS_SHAPE,))
        torch.cuda.reset_peak_memory_stats()
        params = llm_params(torch, mods, cfg, LLM_SPARSITY, seed + 54,
                            device)
        b, t = EMBEDS_SHAPE
        x = embeds(cfg, b, t, torch.bfloat16)
        fwd = lambda: T.forward_embeds(params, x, cfg)  # noqa: E731
        (logits, _), counts = _counted_forward(torch, mods, fwd)
        check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
            b, t, cfg.vocab), f"{cfg.name}: logits {tuple(logits.shape)}")
        ms = _timed(torch, fwd)
        n_proj = cfg.n_layers * 7
        _family_row(torch, "family_forward_embeds", cfg, counts, expect(
            **_bsr(torch, mods, n_proj, b * t),
            flash_attention_tc=cfg.n_layers,
            flash_attention_tc_d96=cfg.n_layers), sparsity=LLM_SPARSITY,
            batch=b, seq=t, head_dim=cfg.head_dim, forward_ms=ms,
            **device_breakdown(torch, fwd, ms))
        runs.append(counts)
        logits, counts, step_ms = _decode_run(torch, mods, cfg, params,
                                              tokens(cfg, 1, 1), PHI3_DECODE,
                                              device)
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} decode: "
              f"non-finite logits")
        _family_row(torch, "family_decode", cfg, counts,
                    expect(bsr_matmul=n_proj * PHI3_DECODE),
                    sparsity=LLM_SPARSITY, steps=PHI3_DECODE,
                    ms_per_step=step_ms)
        runs.append(counts)
        del params, logits, x
        torch.cuda.empty_cache()

        # -- HuBERT-XLarge: bidirectional forward_embeds at d 80 -----------
        cfg = get("hubert-xlarge")
        torch.cuda.reset_peak_memory_stats()
        params = llm_params(torch, mods, cfg, 0.0, seed + 55, device)
        b, t = EMBEDS_SHAPE
        x = embeds(cfg, b, t, torch.bfloat16)
        fwd = lambda: T.forward_embeds(params, x, cfg)  # noqa: E731
        (logits, _), counts = _counted_forward(torch, mods, fwd)
        check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite "
              f"logits")
        ms = _timed(torch, fwd)
        _family_row(torch, "family_forward_embeds", cfg, counts, expect(
            flash_attention_tc=cfg.n_layers,
            flash_attention_tc_d80=cfg.n_layers), sparsity=0.0, batch=b,
            seq=t, head_dim=cfg.head_dim, causal=cfg.causal, forward_ms=ms,
            **device_breakdown(torch, fwd, ms))
        runs.append(counts)
        del params, logits, x
        torch.cuda.empty_cache()

        # -- DeepSeek-V3 cut to 4 layers: MLA prefill, absorbed decode -----
        cfg = dc.replace(get("deepseek-v3-671b"), n_layers=DEEPSEEK_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        params = llm_params(torch, mods, cfg, 0.0, seed + 56, device)
        b, t = DEEPSEEK_SHAPE
        batch = {"tokens": tokens(cfg, b, t)}
        step = mods["make_prefill_step"](cfg)
        (logits, _), counts = _counted_forward(torch, mods,
                                               lambda: step(params, batch))
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} prefill: "
              f"non-finite logits")
        ms = _timed(torch, lambda: step(params, batch), reps=2)
        # MLA's 192/128 head dims take the chunked attention (the
        # reference's rule): no kernel of the port runs
        _family_row(torch, "family_prefill", cfg, counts, expect(),
                    sparsity=0.0, batch=b, seq=t, forward_ms=ms,
                    reduced=f"{DEEPSEEK_LAYERS} of 61 layers",
                    **device_breakdown(torch, lambda: step(params, batch),
                                       ms))
        runs.append(counts)
        logits, counts, step_ms = _decode_run(
            torch, mods, cfg, params, batch["tokens"], DEEPSEEK_DECODE,
            device)
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} decode: "
              f"non-finite logits")
        _family_row(torch, "family_decode", cfg, counts, expect(),
                    sparsity=0.0, steps=DEEPSEEK_DECODE, ms_per_step=step_ms,
                    cache="MLA latent (absorbed decode)")
        runs.append(counts)
        del params, logits, batch
        torch.cuda.empty_cache()

        # -- Jamba-1.5-Large cut to 2 layers: Mamba2 + MoE, Mamba2 + MLP ---
        cfg = dc.replace(get("jamba-1.5-large-398b"), n_layers=JAMBA_LAYERS)
        bank_rows(cfg, "in_proj", cfg.d_model, _in_proj_width(cfg),
                  (JAMBA_SHAPE,))
        torch.cuda.reset_peak_memory_stats()
        params = llm_params(torch, mods, cfg, LLM_SPARSITY, seed + 57,
                            device)
        b, t = JAMBA_SHAPE
        batch = {"tokens": tokens(cfg, b, t)}
        step = mods["make_prefill_step"](cfg)
        (logits, _), counts = _counted_forward(torch, mods,
                                               lambda: step(params, batch))
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} prefill: "
              f"non-finite logits")
        ms = _timed(torch, lambda: step(params, batch), reps=2)
        # in_proj and out_proj of both Mamba2 layers, the MLP's three
        n_proj = 2 * 2 + 3
        _family_row(torch, "family_prefill", cfg, counts,
                    expect(**_bsr(torch, mods, n_proj, b * t)),
                    sparsity=LLM_SPARSITY, batch=b, seq=t, forward_ms=ms,
                    reduced=f"{JAMBA_LAYERS} of 72 layers",
                    **device_breakdown(torch, lambda: step(params, batch),
                                       ms))
        runs.append(counts)
        logits, counts, step_ms = _decode_run(
            torch, mods, cfg, params, batch["tokens"], JAMBA_DECODE, device)
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} decode: "
              f"non-finite logits")
        _family_row(torch, "family_decode", cfg, counts,
                    expect(bsr_matmul=n_proj * JAMBA_DECODE),
                    sparsity=LLM_SPARSITY, steps=JAMBA_DECODE,
                    ms_per_step=step_ms)
        runs.append(counts)
        del params, logits, batch
        torch.cuda.empty_cache()

        # -- f32, 2 layers: the split-TF32 forward at d 80 and 96 ----------
        for arch, name in (("hubert-xlarge", "flash_attention_d80"),
                           ("phi-3-vision-4.2b", "flash_attention_d96")):
            cfg = dc.replace(get(arch), dtype="float32",
                             n_layers=EMBEDS_CONSIST_LAYERS)
            params = llm_params(torch, mods, cfg, 0.0, seed + 58, device)
            b, t = EMBEDS_CONSIST_SHAPE
            x = embeds(cfg, b, t, torch.float32)
            (got, _), counts = _counted_forward(
                torch, mods, lambda: T.forward_embeds(params, x, cfg))
            flags.set_attn_impl("chunked")
            want, _ = T.forward_embeds(params, x, cfg)
            flags.set_attn_impl("flash")
            err = float((got - want).abs().max())
            over_max = err / float(want.abs().max())
            check(over_max <= FLASH_F32_TOL, f"{cfg.name} f32: flash "
                  f"logits {over_max} x max |chunked| away (tolerance "
                  f"{FLASH_F32_TOL})")
            _family_row(torch, "family_f32_flash_vs_chunked", cfg, counts,
                        expect(flash_attention=cfg.n_layers,
                               **{name: cfg.n_layers}), batch=b, seq=t,
                        max_abs_diff=err, diff_over_max=over_max)
            runs.append(counts)
            del params, got, want, x
            torch.cuda.empty_cache()
    finally:
        flags.set_attn_impl("chunked")
    return sum_counts(runs), {"bsr_matmul": kernel_rows}


# ---------------------------------------------------------------------------
# the mesh: the multi-chip path on one card (a world of one over NCCL; two
# ranks that share the card over gloo)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_batch(mods, cfg, seed):
    b, t = MESH_TRAIN_SHAPE
    return mods["SyntheticLMDataset"](mods["DataConfig"](
        seq_len=t, global_batch=b, vocab=cfg.vocab, seed=seed + 90)
    ).batch_for(0)


def _mesh_train(torch, mods, cfg, batch, seed, device, mesh=None,
                compress=False) -> dict:
    """``MESH_STEPS`` counted ``make_train_step`` steps of ``cfg`` (flash
    attention) from the state drawn from ``seed``, placed on ``mesh`` (by
    ``state_placements``, under the default rules) or meshless: the
    losses, grad norms, ms a step, peak GB and the launches."""
    flags, S = mods["flags"], mods["S"]
    flags.set_attn_impl("flash")
    opt_cfg = mods["AdamWConfig"]()
    rules = (S.use_rules(S.default_rules(mesh), mesh) if mesh is not None
             else contextlib.nullcontext())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with rules:
            state = mods["init_state"](cfg, opt_cfg, torch.Generator(
                device=device).manual_seed(seed + 91), device)
            if mesh is not None:
                tp = S.axis_size("model")
                state = mods["place_state"](state, mods["state_placements"](
                    cfg, mesh, tp), mesh)
                torch.cuda.empty_cache()
            step = mods["make_train_step"](cfg, opt_cfg,
                                           compress_cross_pod=compress,
                                           total_steps=MESH_STEPS)
            losses, gnorms, ms, runs = [], [], [], []
            for _ in range(MESH_STEPS):
                reset_counts(mods)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                runs.append(read_counts(mods))
            digest = (_state_digest(torch, mods, state) if mesh is not None
                      else None)
            del state
    finally:
        flags.set_attn_impl("chunked")
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"mesh train {cfg.name}: losses {losses}, grad norms {gnorms}")
    return {"losses": losses, "grad_norms": gnorms, "step_ms": ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "runs": runs, "digest": digest}


def _state_digest(torch, mods, state) -> list:
    """This rank's shard of every leaf of a train state as two integers
    over its bits (their sum and the sum of their squares, in int64):
    ranks that hold the same shards (pod replicas) give the same list."""
    out = []
    for _, x in mods["tree_paths"](state):
        t = (x.to_local() if hasattr(x, "to_local") else x).contiguous()
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32
                      if t.element_size() == 4 else torch.int64
                      ).to(torch.int64)
        out.append([int(bits.sum()), int((bits * bits).sum())])
    return out


def _int8_error(torch, mods, cfg, batch, seed, device, mesh) -> dict:
    """The compressed cross-pod exchange of the meshed step, held leaf by
    leaf, from the state ``_mesh_train`` draws from ``seed`` and its first
    batch: the gradient of ``steps.reduce_grads`` compressed (Gc) and at
    full precision (G).  Pod p's mean gradient x_p is quantised with scale
    s_p = max|x_p| / 127 and the int8 sum dequantised with the mean scale
    s, so an element of Gc lies within (1/n) sum_p (s_p / 2 + 127 |s -
    s_p|) of G's, plus the bf16 rounding of both (2^-8 of each); returns
    the largest error over that bound (at most 1), ||Gc|| and ||G||."""
    S, st, C = mods["S"], mods["steps"], mods["C"]
    flags = mods["flags"]
    flags.set_attn_impl("flash")
    opt_cfg = mods["AdamWConfig"]()
    try:
        with S.use_rules(S.default_rules(mesh), mesh):
            state = mods["init_state"](cfg, opt_cfg, torch.Generator(
                device=device).manual_seed(seed + 91), device)
            state = mods["place_state"](state, mods["state_placements"](
                cfg, mesh, S.axis_size("model")), mesh)
            leaves, rebuild = mods["tree_flatten"](state["params"])
            pls = [x.placements for x in leaves]
            local = rebuild([x.to_local() for x in leaves])
            del state
            _, grads = st.loss_and_grads(cfg, local, mods["place_batch"](
                batch, device, mesh))
            n_pod = S.axis_size("pod", mesh)
            axes = st.shard_axes(pls, mesh)
            gc = st.reduce_grads(grads, pls, mesh, True)
            g = st.reduce_grads(grads, pls, mesh, False)
            pod_sum = st._sum_replicated(list(grads), pls, mesh,
                                         skip=("pod",))
            del grads
            amax = torch.stack([C.value_max(torch.amax(torch.abs(
                x.float())) * n_pod, a) for x, a in zip(pod_sum, axes)])
            del pod_sum
            s_p = C.all_gather((torch.clamp(amax, min=1e-12) / 127.0)[None],
                               0, "pod")
            s = s_p.mean(0)
            bound = (s_p / 2 + 127 * (s - s_p).abs()).sum(0) / n_pod
            over = []
            for i, (a, b) in enumerate(zip(gc, g)):
                a, b = a.float(), b.float()
                e = ((a - b).abs() - 2.0**-8 * (a.abs() + b.abs())).amax()
                over.append(C.value_max(e, axes[i]) / bound[i])
            res = {"max_over_bound": float(torch.stack(over).max()),
                   "gc_norm": float(st.mesh_norm(gc, pls, mesh)),
                   "g_norm": float(st.mesh_norm(g, pls, mesh))}
            del gc, g, local
    finally:
        flags.set_attn_impl("chunked")
    torch.cuda.empty_cache()
    return res


def _moe_inputs(torch, mods, seed, device):
    cfg = mods["configs"].get_config(MOE_ARCH)
    b, t = MESH_MOE_SHAPE
    tokens = torch.randint(0, cfg.vocab, (b, t), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(seed + 95))
    params = mods["T"].init_params(cfg, torch.Generator(
        device=device).manual_seed(seed + 94), device)
    return cfg, tokens, params


def mesh_moe_reference(torch, mods, device, seed):
    """OLMoE-1B-7B's one-rank forward through the gather dispatch, B 1 x
    T 2048, its capacity factor raised through ``MESH_CAPACITIES`` until no
    assignment drops; and the same model's f32 forward (params cast, the
    last factor: an expert's capacity is every token): (the bf16 logits,
    the f32 logits, on the host, the factor, the drops at each factor
    tried)."""
    flags = mods["flags"]
    cfg, tokens, params = _moe_inputs(torch, mods, seed, device)
    flags.set_attn_impl("flash")
    tried = {}
    try:
        for cf in MESH_CAPACITIES:
            flags.set_moe_capacity(cf)
            with counted_drops(mods) as drops, torch.no_grad():
                logits = mods["T"].forward(params, tokens, cfg)[0]
            tried[cf] = int(sum(int(d) for d in drops))
            if not tried[cf]:
                break
        check(not tried[cf], f"mesh moe: the gather path still drops "
              f"{tried} at every capacity factor tried")
        out = logits.cpu()
        del logits
        flags.set_moe_capacity(MESH_CAPACITIES[-1])
        p32 = mods["tree_map"](lambda x: x.float(), params)
        del params
        with counted_drops(mods) as drops, torch.no_grad():
            logits = mods["T"].forward(p32, tokens, mods["dc"].replace(
                cfg, dtype="float32"))[0]
        check(not int(sum(int(d) for d in drops)),
              "mesh moe: the f32 forward dropped assignments")
        out32 = logits.cpu()
        del p32, logits
    finally:
        flags.set_moe_capacity(1.25)
        flags.set_attn_impl("chunked")
    torch.cuda.empty_cache()
    return out, out32, cf, tried


def _set_path(tree, path: str, value) -> None:
    """Replace the leaf at ``path`` (``tree_paths``'s form) in place."""
    *parts, last = path.split("/")
    for p in parts:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    if isinstance(tree, list):
        tree[int(last)] = value
    else:
        tree[last] = value


def mesh_sparse_reference(torch, mods, device, seed, pruned, layers):
    """OLMoE-1B-7B in f32 on one rank (B 1 x T 2048, the last capacity
    factor, no drop) with the pruned projections the two ranks ran as
    BCSR shards (``pruned``, whole, by tree path) as dense weights: each
    layer run on the two ranks' input to it (``layers``: (input, output)
    pairs), and each token's update (output - input) held to theirs
    (relative norm a row); and the whole prefill.  Returns (the rows'
    errors, all layers, on the host; the prefill's last logits)."""
    flags, T = mods["flags"], mods["T"]
    cfg, tokens, params = _moe_inputs(torch, mods, seed, device)
    for k, w in pruned.items():
        _set_path(params, k, w.to(device))
    p32 = mods["tree_map"](lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    cfg32 = mods["dc"].replace(cfg, dtype="float32")
    descs = T.layer_descs(cfg32)
    b, t = tokens.shape
    pos = torch.arange(t, dtype=torch.int32, device=device).expand(b, t)
    flags.set_attn_impl("flash")
    flags.set_moe_capacity(MESH_CAPACITIES[-1])
    errs = []
    try:
        with counted_drops(mods) as drops, torch.no_grad():
            for i, (x, y) in enumerate(layers):
                x = x.to(device)
                want = T._layer_fwd(cfg32, descs[i], p32["layers"][i], x,
                                    pos, None, None, i) - x
                got = y.to(device) - x
                errs.append(((got - want).norm(dim=-1)
                             / want.norm(dim=-1)).reshape(-1).cpu())
                del x, want, got
            last, _ = mods["make_prefill_step"](cfg32)(p32,
                                                       {"tokens": tokens})
        check(not int(sum(int(d) for d in drops)),
              "mesh sparse: the one-rank f32 layers dropped assignments")
        out = (torch.cat(errs), last.cpu())
        del p32, last
    finally:
        flags.set_moe_capacity(1.25)
        flags.set_attn_impl("chunked")
    torch.cuda.empty_cache()
    return out


def _world_drops(torch, drops) -> int:
    import torch.distributed as dist
    total = torch.tensor(sum(int(d) for d in drops))
    dist.all_reduce(total)
    return int(total)


def _mesh_ep(torch, mods, seed, device, mesh, out_dir, rank) -> dict:
    """OLMoE-1B-7B at full width and depth on ``mesh`` (1, 2) under
    ``MOE_IMPL = "ep"`` (32 experts a rank): the forward, counted, its
    capacity factor raised until the EP path drops nothing (the world's
    drops summed); rank 0 writes the gathered logits; then each rank's
    local projections pruned to BCSR at ``MESH_SPARSITY`` and
    ``make_prefill_step`` run, counted.  Then the same in f32 (the shards
    cast, the last capacity factor), each counted: the forward, whose
    logits rank 0 writes, and the sparse prefill, whose last logits rank 0
    writes with the pruned projections gathered whole (bf16 holds them
    exactly: the f32 weights are bf16 ones cast), for the one-rank f32
    prefill on the same weights."""
    flags, S, T = mods["flags"], mods["S"], mods["T"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, tokens, params = _moe_inputs(torch, mods, seed, device)
    flags.set_moe_impl("ep")
    flags.set_attn_impl("flash")
    tried, res = {}, {}
    try:
        with S.use_rules(S.default_rules(mesh), mesh):
            pls = mods["state_placements"](cfg, mesh,
                                           S.axis_size("model"))["params"]
            placed = mods["place_state"](params, pls, mesh)
            del params
            torch.cuda.empty_cache()
            batch = mods["place_batch"]({"tokens": tokens}, device, mesh)
            for cf in MESH_CAPACITIES:
                flags.set_moe_capacity(cf)
                reset_counts(mods)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with mods["moe_ep"].count_drops() as drops, torch.no_grad():
                    logits = T.forward(placed, batch["tokens"], cfg)[0]
                torch.cuda.synchronize()
                fwd_ms = (time.perf_counter() - t0) * 1e3
                counts = read_counts(mods)
                tried[cf] = _world_drops(torch, drops)
                if not tried[cf]:
                    break
            check(not tried[cf], f"mesh ep: the EP path still drops {tried}")
            full = S.full_tensor(logits)
            if rank == 0:
                torch.save(full.cpu(), os.path.join(out_dir, "ep_logits.pt"))
            res.update(capacity=cf, drops=tried, forward_ms=fwd_ms,
                       forward_runs=[counts],
                       finite=bool(torch.isfinite(full).all()))
            del logits, full
            # block-sparse projections: each rank prunes its own shards
            local = T.local_shards(placed)
            mods["sparsify"](local, cfg, MESH_SPARSITY)
            prefill = mods["make_prefill_step"](cfg)
            reset_counts(mods)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                last, _ = prefill(local, batch)
            torch.cuda.synchronize()
            res["sparse_prefill_ms"] = (time.perf_counter() - t0) * 1e3
            res["sparse_runs"] = [read_counts(mods)]
            last = S.full_tensor(last)
            res["sparse_finite"] = bool(torch.isfinite(last).all())
            res["sparse_shape"] = list(last.shape)
            del local, last
            res.update(_mesh_ep_f32(torch, mods, cfg, placed, batch, out_dir,
                                    rank))
            del placed
    finally:
        flags.set_moe_impl("gather")
        flags.set_moe_capacity(1.25)
        flags.set_attn_impl("chunked")
    torch.cuda.empty_cache()
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def _mesh_ep_f32(torch, mods, cfg, placed, batch, out_dir, rank) -> dict:
    """``_mesh_ep``'s f32 part on the placed bf16 params (freed here)."""
    S, T = mods["S"], mods["T"]
    cfg32 = mods["dc"].replace(cfg, dtype="float32")
    placed32 = mods["tree_map"](
        lambda x: S.map_local(lambda t: t.float(), x), placed)
    placed.clear()
    torch.cuda.empty_cache()
    mods["flags"].set_moe_capacity(MESH_CAPACITIES[-1])
    res = {}
    reset_counts(mods)
    with mods["moe_ep"].count_drops() as drops, torch.no_grad():
        logits = T.forward(placed32, batch["tokens"], cfg32)[0]
    res["f32_forward_runs"] = [read_counts(mods)]
    res["f32_drops"] = _world_drops(torch, drops)
    full = S.full_tensor(logits)
    if rank == 0:
        torch.save(full.cpu(), os.path.join(out_dir, "ep_logits32.pt"))
    del logits, full
    # the sparse prefill on each rank's pruned f32 shards, and the pruned
    # projections (sparsify_params's pruning of the same shards) whole
    local = T.local_shards(placed32)
    dense = dict(mods["tree_paths"](local))
    pls = {k: x.placements for k, x in mods["tree_paths"](placed32)}
    mods["sparsify"](local, cfg32, MESH_SPARSITY)
    pruned = {}
    for k, x in mods["tree_paths"](local):
        if isinstance(x, mods["BcsrMatrix"]):
            w = mods["block_prune"](dense[k], MESH_SPARSITY,
                                    MESH_BLOCK).to(torch.bfloat16)
            w = S.full_tensor(S.wrap(w, pls[k]))
            if rank == 0:
                pruned[k] = w.cpu()
            del w
    del dense
    prefill = mods["make_prefill_step"](cfg32)
    # each layer's input and output, gathered whole (collectives, no
    # kernel), for the one-rank layers on the same inputs
    io, layer_fwd = [], T._layer_fwd

    def recording(cfg_, desc, p, x, *rest):
        y = layer_fwd(cfg_, desc, p, x, *rest)
        pair = (S.full_tensor(x), S.full_tensor(y))
        if rank == 0:
            io.append(tuple(t.cpu() for t in pair))
        return y

    reset_counts(mods)
    T._layer_fwd = recording
    try:
        with mods["moe_ep"].count_drops() as drops, torch.no_grad():
            last, _ = prefill(local, batch)
    finally:
        T._layer_fwd = layer_fwd
    res["f32_sparse_runs"] = [read_counts(mods)]
    res["f32_sparse_drops"] = _world_drops(torch, drops)
    last = S.full_tensor(last)
    if rank == 0:
        torch.save({"last": last.cpu(), "layers": io, "pruned": pruned},
                   os.path.join(out_dir, "sparse32.pt"))
    del local, last, placed32, pruned, io
    torch.cuda.empty_cache()
    return res


def _cast32(mods, tree):
    """A placed param tree with every DTensor shard and BCSR bank cast to
    f32."""
    S, Bcsr = mods["S"], mods["BcsrMatrix"]

    def one(x):
        if isinstance(x, Bcsr):
            return Bcsr(blocks=x.blocks.float(), blockcol=x.blockcol,
                        nblocks=x.nblocks, shape=x.shape, block=x.block)
        return S.map_local(lambda t: t.float(), x)
    return mods["tree_map"](one, tree)


def _mesh_decode_run(torch, mods, cfg, params, tokens, steps, mesh,
                     device, greedy):
    """``steps`` counted ``make_serve_step`` calls on ``mesh`` over a placed
    cache of MESH_DECODE_LEN at cur_len 0, 1, ...: the fed tokens are
    ``tokens``' columns, past the prompt the last next tokens where
    ``greedy``.  Returns (the fed tokens, the logits of every step gathered
    whole (steps, rows, V) in f32, the next tokens (steps, rows), ms a
    step, the launches).  The timed window holds the steps and the next
    tokens gathered whole (what feeds the next step); the logits are
    kept as the step returns them (no copy) and gathered after it."""
    S, T, st = mods["S"], mods["T"], mods["steps"]
    cache = st.place_cache(T.init_cache(cfg, tokens.shape[0],
                                        MESH_DECODE_LEN, device),
                           cfg, mesh, S.axis_size("model"))
    serve = mods["make_serve_step"](cfg)
    fed, local, nxt, pls = tokens.clone(), [], [], []
    decode_step = T.decode_step

    def recording(*a, **k):
        lg, c = decode_step(*a, **k)
        local.append(lg.to_local())
        pls[:] = lg.placements
        return lg, c

    reset_counts(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T.decode_step = recording
    try:
        with torch.no_grad():
            for t in range(steps):
                if greedy and t >= MESH_DECODE_PROMPT:
                    fed[:, t] = nxt[-1]
                tk = st.place_tokens(fed[:, t:t + 1], device, mesh)
                n, cache = serve(params, tk, cache, t)
                nxt.append(S.full_tensor(n))
    finally:
        T.decode_step = decode_step
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = read_counts(mods)
    stacked = [type(p)(p.dim + 1) if hasattr(p, "dim") else p for p in pls]
    logits = S.full_tensor(S.wrap(torch.stack(local).float(), stacked))
    return fed, logits, torch.stack(nxt), ms, counts


def _meshless_decode(torch, mods, cfg, params, fed, device):
    """One rank's meshless decode of ``fed`` (teacher-forced), the logits
    of every step (steps, rows, V) in f32."""
    T = mods["T"]
    cache = T.init_cache(cfg, fed.shape[0], MESH_DECODE_LEN, device)
    out = []
    with torch.no_grad():
        for t in range(fed.shape[1]):
            lg, cache = T.decode_step(params, cfg, fed[:, t:t + 1], cache, t)
            out.append(lg.float())
    return torch.stack(out)


def _mesh_decode(torch, mods, seed, device, mesh, rank) -> list:
    """``MESH_DECODE``'s models on ``mesh``: each run greedy in bf16, then
    in f32 on the shards cast, teacher-forced with the bf16 run's tokens;
    a sparse model's shards pruned by ``sparse_weights.sparsify_shards``.
    Rank 0 also decodes the same tokens meshless on the weights gathered
    whole (dense; pruned where sparse), in f32 and bf16, and measures each
    step's f32 error (in units of max(1, max |logit|)), the relative norms
    of the bf16 logits from the meshless f32 ones, and the f32 next
    tokens' agreement with the meshless argmax where its top two differ by
    more than the f32 tolerance."""
    from repro_torch.launch import sparse_weights
    S, T = mods["S"], mods["T"]
    out = []
    with S.use_rules(S.default_rules(mesh), mesh):
        for i, (arch, sparse, steps) in enumerate(MESH_DECODE):
            cfg = mods["configs"].get_config(arch)
            if cfg.use_mla:
                cfg = mods["dc"].replace(cfg, n_layers=1, mtp_depth=0)
            t_model = time.perf_counter()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            whole = T.init_params(cfg, torch.Generator(
                device=device).manual_seed(seed + 97), device)
            pls = mods["tree_map"](lambda sp: S.placements(sp, mesh),
                                   T.param_specs(cfg, S.axis_size("model")))
            placed = mods["place_state"](whole, pls, mesh)
            n_bcsr = 0
            if sparse:
                # the pruned shards, and the same weights gathered whole
                placed = sparse_weights.sparsify_shards(placed, cfg,
                                                        MESH_SPARSITY)
                by_path = dict(mods["tree_paths"](pls))
                flat = []
                for (k, w), d in zip(mods["tree_paths"](placed),
                                     mods["tree_flatten"](whole)[0]):
                    if isinstance(w, mods["BcsrMatrix"]):
                        n_bcsr += 1
                        d = S.full_tensor(S.wrap(
                            mods["bcsr_to_dense_matrix"](w).T.contiguous(),
                            sparse_weights.whole_but_tp(by_path[k], mesh)))
                    flat.append(d)
                whole = mods["tree_flatten"](whole)[1](flat)
            prompt = torch.randint(
                0, cfg.vocab, (MESH_DECODE_ROWS, steps), device=device,
                generator=torch.Generator(device=device).manual_seed(
                    seed + 98 + i))
            fed, lg16, nx16, ms16, c16 = _mesh_decode_run(
                torch, mods, cfg, placed, prompt, steps, mesh, device, True)
            cfg32 = mods["dc"].replace(cfg, dtype="float32")
            placed32 = _cast32(mods, placed)
            _, lg32, nx32, ms32, c32 = _mesh_decode_run(
                torch, mods, cfg32, placed32, fed, steps, mesh, device,
                False)
            del placed, placed32
            res = {"arch": arch, "sparse": sparse, "steps": steps,
                   "layers": cfg.n_layers, "bcsr_leaves": n_bcsr,
                   "step_ms": ms16, "f32_step_ms": ms32, "runs": [c16, c32],
                   "finite": bool(torch.isfinite(lg16).all()
                                  and torch.isfinite(lg32).all())}
            if rank == 0:
                whole32 = mods["tree_map"](lambda x: x.float(), whole)
                ref32 = _meshless_decode(torch, mods, cfg32, whole32, fed,
                                         device)
                del whole32
                ref16 = _meshless_decode(torch, mods, cfg, whole, fed,
                                         device)
                scale = torch.clamp(ref32.abs().amax(dim=(1, 2)), min=1.0)
                err32 = ((lg32 - ref32).abs().amax(dim=(1, 2)) / scale)
                rel = lambda a, b: float((a - b).norm() / b.norm())
                top2 = torch.topk(ref32, 2, dim=-1).values
                clear = (top2[..., 0] - top2[..., 1]
                         > MESH_DECODE_F32_RTOL * scale[:, None])
                agree = (nx32.long() == ref32.argmax(-1))[clear]
                res.update(
                    f32_err=float(err32.max()),
                    bf16_vs_f32=rel(lg16, ref32),
                    one_bf16_vs_f32=rel(ref16, ref32),
                    next_clear=int(clear.sum()),
                    next_agree=int(agree.sum()),
                    greedy_agree=float((nx16.long() == ref16.argmax(-1))
                                       .float().mean()))
                del ref32, ref16
            del whole, lg16, lg32
            res["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
            res["seconds"] = time.perf_counter() - t_model
            out.append(res)
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank, world, port, seed, out_dir):
    """One rank of the two that share the card: (b) Qwen1.5-0.5B trained on
    a (1, 2) ("data", "model") mesh (tp mode A, 8 heads a rank),
    OLMoE-1B-7B's EP forward and sparse prefill on it, and the meshed
    decode (``_mesh_decode``); (c) Qwen1.5-0.5B on
    a (2, 1, 1) ("pod", "data", "model") mesh, uncompressed and with
    ``compress_cross_pod`` (and the compressed exchange held leaf by leaf,
    ``_int8_error``).  Writes its results to ``rank<r>.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    try:
        mods = load_modules()
        make_mesh = mods["make_mesh"]
        cfg = mods["configs"].get_config(MESH_ARCH)
        batch = _mesh_batch(mods, cfg, seed)
        tp_mesh = make_mesh((1, world), ("data", "model"),
                            device_type="cuda")
        res = {"rank": rank,
               "tp": _mesh_train(torch, mods, cfg, batch, seed, device,
                                 tp_mesh),
               "ep": _mesh_ep(torch, mods, seed, device, tp_mesh, out_dir,
                              rank),
               "decode": _mesh_decode(torch, mods, seed, device, tp_mesh,
                                      rank)}
        pod_mesh = make_mesh((world, 1, 1), ("pod", "data", "model"),
                             device_type="cuda")
        res["dp"] = _mesh_train(torch, mods, cfg, batch, seed, device,
                                pod_mesh)
        res["int8_error"] = _int8_error(torch, mods, cfg, batch, seed,
                                        device, pod_mesh)
        res["int8"] = _mesh_train(torch, mods, cfg, batch, seed, device,
                                  pod_mesh, compress=True)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def mesh_phase(torch, mods, device, seed):
    """(a) Qwen1.5-0.5B at full width and depth (B 4 x T 2048, bf16, flash)
    through the meshed ``make_train_step`` in a world of one over NCCL on a
    (1, 1) mesh, against the meshless step from the same seed; OLMoE's
    one-rank gather forward for (b); then a spawned gloo world of two
    ranks on the card (``_mesh_rank``), held to these.  Returns the
    counted launches (this process's and the ranks')."""
    import shutil
    import torch.distributed as dist
    import torch.multiprocessing as mp

    card = mods["card"]
    cfg = mods["configs"].get_config(MESH_ARCH)
    batch = _mesh_batch(mods, cfg, seed)
    want_step = flash_step_launches(cfg.n_layers, True, cfg.head_dim)
    t_phase = time.perf_counter()

    # (a) a world of one over NCCL
    meshless = _mesh_train(torch, mods, cfg, batch, seed, device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        one = _mesh_train(torch, mods, cfg, batch, seed, device,
                          mods["make_mesh"]((1, 1), ("data", "model"),
                                            device_type="cuda"))
    finally:
        dist.destroy_process_group()
    for i in range(MESH_STEPS):
        check(one["runs"][i] == want_step, f"mesh (1, 1): step {i} launched "
              f"{one['runs'][i]}, expected {want_step}")
        for key in ("losses", "grad_norms"):
            check(_rel(one[key][i], meshless[key][i]) <= MESH_ONE_RTOL,
                  f"mesh (1, 1) {key}: {one[key]} vs meshless "
                  f"{meshless[key]}")
    print(json.dumps({
        "phase": "mesh one", "arch": cfg.name, "mesh": [1, 1],
        "backend": "nccl", "batch": MESH_TRAIN_SHAPE[0],
        "seq": MESH_TRAIN_SHAPE[1], "dtype": cfg.dtype,
        "losses": one["losses"], "grad_norms": one["grad_norms"],
        "meshless_losses": meshless["losses"],
        "meshless_grad_norms": meshless["grad_norms"],
        "bit_identical": (one["losses"] == meshless["losses"]
                          and one["grad_norms"] == meshless["grad_norms"]),
        "step_ms": one["step_ms"], "meshless_step_ms": meshless["step_ms"],
        "peak_gb": one["peak_gb"], "meshless_peak_gb": meshless["peak_gb"],
        "tolerance": MESH_ONE_RTOL, "card": card}), flush=True)

    ref_logits, ref32, ref_cf, ref_tried = mesh_moe_reference(
        torch, mods, device, seed)

    # (b) and (c): two ranks that share the card, over gloo
    out_dir = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_mesh_rank, args=(2, _free_port(), seed,
                                               out_dir),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_JOIN_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise SmokeFailure(f"mesh: the two ranks did not finish in "
                                   f"{MESH_JOIN_S} s")
    except mp.ProcessRaisedException as e:
        raise SmokeFailure(f"mesh: a rank failed: {e}") from None
    except mp.ProcessExitedException as e:
        raise SmokeFailure(f"mesh: a rank exited: {e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    world_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = torch.load(os.path.join(out_dir, "ep_logits.pt"))
    got32 = torch.load(os.path.join(out_dir, "ep_logits32.pt"))
    sparse32 = torch.load(os.path.join(out_dir, "sparse32.pt"))
    shutil.rmtree(out_dir, ignore_errors=True)
    row_errs, one_last = mesh_sparse_reference(
        torch, mods, device, seed, sparse32["pruned"], sparse32["layers"])

    moe_cfg = mods["configs"].get_config(MOE_ARCH)
    want_ep = expect(flash_attention_tc=moe_cfg.n_layers)
    # the four attention projections of every layer from each rank's
    # banks (the experts and the head stay dense), the attention as in the
    # dense forward
    want_sparse = expect(flash_attention_tc=moe_cfg.n_layers,
                         bsr_matmul=4 * moe_cfg.n_layers)
    # f32: the split-TF32 flash forward; f32 tiles take bsr_matmul's rows
    # schedule
    want_f32 = expect(flash_attention=moe_cfg.n_layers)
    want_f32_sparse = expect(flash_attention=moe_cfg.n_layers,
                             bsr_matmul=4 * moe_cfg.n_layers)
    for res in ranks:
        r = res["rank"]
        for part in ("tp", "dp", "int8"):
            for i, counts in enumerate(res[part]["runs"]):
                check(counts == want_step, f"mesh rank {r} {part} step {i}: "
                      f"launched {counts}, expected {want_step}")
        check(res["ep"]["forward_runs"][0] == want_ep,
              f"mesh rank {r} ep forward: {res['ep']['forward_runs'][0]}")
        sparse = res["ep"]["sparse_runs"][0]
        check(sparse["bsr_matmul"] == want_sparse["bsr_matmul"]
              and sparse["flash_attention_tc"] == moe_cfg.n_layers,
              f"mesh rank {r} sparse prefill: launched {sparse}")
        check(res["ep"]["finite"] and res["ep"]["sparse_finite"],
              f"mesh rank {r}: logits not finite")
        check(res["ep"]["f32_forward_runs"][0] == want_f32,
              f"mesh rank {r} f32 ep forward: "
              f"{res['ep']['f32_forward_runs'][0]}, expected {want_f32}")
        check(res["ep"]["f32_sparse_runs"][0] == want_f32_sparse,
              f"mesh rank {r} f32 sparse prefill: "
              f"{res['ep']['f32_sparse_runs'][0]}, expected "
              f"{want_f32_sparse}")
        check(res["ep"]["f32_drops"] == 0 == res["ep"]["f32_sparse_drops"],
              f"mesh rank {r} f32: the EP path dropped "
              f"{res['ep']['f32_drops']} / {res['ep']['f32_sparse_drops']}")
    tp, ep = ranks[0]["tp"], ranks[0]["ep"]
    for i in range(MESH_STEPS):
        for name, run in (("(1, 2)", tp), ("(2, 1, 1)", ranks[0]["dp"])):
            for key, tol in (("losses", MESH_TP_RTOL),
                             ("grad_norms", MESH_GNORM_RTOL)):
                check(_rel(run[key][i], meshless[key][i]) <= tol,
                      f"mesh {name} {key} {run[key]} vs meshless "
                      f"{meshless[key]} (limit {tol})")
        check(_rel(ranks[0]["int8"]["losses"][i],
                   ranks[0]["dp"]["losses"][i]) <= MESH_INT8_RTOL,
              f"mesh int8 losses {ranks[0]['int8']['losses']} vs "
              f"uncompressed {ranks[0]['dp']['losses']}")
    # the pod replicas hold the same state after the steps
    for part in ("dp", "int8"):
        check(ranks[0][part]["digest"] == ranks[1][part]["digest"],
              f"mesh (2, 1, 1) {part}: the two pods' states differ")
    int8_err = ranks[0]["int8_error"]
    for res in ranks:
        check(res["int8_error"]["max_over_bound"] <= 1.0,
              f"mesh int8 rank {res['rank']}: a compressed gradient leaf "
              f"lies {res['int8_error']['max_over_bound']} x its int8 bound "
              f"from the uncompressed one")
    check(_rel(ranks[0]["int8"]["grad_norms"][0], int8_err["gc_norm"])
          <= MESH_INT8_NORM_RTOL,
          f"mesh int8: the step's grad norm {ranks[0]['int8']['grad_norms']}"
          f" is not the compressed gradient's {int8_err['gc_norm']}")
    check(_rel(int8_err["g_norm"], meshless["grad_norms"][0])
          <= MESH_GNORM_RTOL,
          f"mesh int8: the uncompressed gradient's norm {int8_err['g_norm']}"
          f" vs meshless {meshless['grad_norms'][0]}")
    check(tuple(got.shape) == tuple(ref_logits.shape),
          f"mesh ep logits {tuple(got.shape)} vs {tuple(ref_logits.shape)}")
    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / b.float().norm())
    logit_rel = rel(got, ref_logits)
    ep_f32, gather_f32 = rel(got, ref32), rel(ref_logits, ref32)
    argmax_agree = float((got.float().argmax(-1)
                          == ref_logits.float().argmax(-1)).float().mean())
    check(ep_f32 <= MESH_LOGIT_FACTOR * gather_f32,
          f"mesh ep logits: {ep_f32} from the f32 forward (relative norm), "
          f"more than {MESH_LOGIT_FACTOR} x the one-rank bf16 forward's "
          f"{gather_f32}")
    f32_rel = rel(got32, ref32)
    check(f32_rel <= MESH_F32_RTOL, f"mesh ep f32 logits: {f32_rel} from "
          f"the one-rank f32 forward (relative norm), limit {MESH_F32_RTOL}")
    # the sparse prefill layer by layer: a token's routing near a tie may
    # take another expert under another summation order, which changes
    # that row (and, through attention, every later one at full depth)
    sparse_rel = rel(sparse32["last"], one_last)
    n_rows = int(row_errs.numel())
    over = int((row_errs > MESH_F32_RTOL).sum())
    sparse_rows = {"rows": n_rows, "over": over,
                   "median": float(row_errs.median()),
                   "max": float(row_errs.max()),
                   "last_logits_rel": sparse_rel}
    check(n_rows == moe_cfg.n_layers * MESH_MOE_SHAPE[0] * MESH_MOE_SHAPE[1]
          and over <= MESH_ROUTING_FLIPS, f"mesh sparse f32: {over} of "
          f"{n_rows} token updates (layer by layer) more than "
          f"{MESH_F32_RTOL} from the one-rank layers on the same pruned "
          f"weights and inputs (at most {MESH_ROUTING_FLIPS})")
    print(json.dumps({
        "phase": "mesh", "card": card, "world_s": world_s,
        "tp": {"mesh": [1, 2], "backend": "gloo", "arch": cfg.name,
               "heads_a_rank": cfg.n_heads // 2,
               "losses": tp["losses"], "grad_norms": tp["grad_norms"],
               "step_ms": tp["step_ms"],
               "peak_gb": [x["tp"]["peak_gb"] for x in ranks],
               "tolerance": MESH_TP_RTOL,
               "gnorm_tolerance": MESH_GNORM_RTOL},
        "dp": {"mesh": [2, 1, 1], "losses": ranks[0]["dp"]["losses"],
               "grad_norms": ranks[0]["dp"]["grad_norms"],
               "pods_equal": True},
        "ep": {"arch": MOE_ARCH, "experts_a_rank": moe_cfg.n_experts // 2,
               "batch": MESH_MOE_SHAPE[0], "seq": MESH_MOE_SHAPE[1],
               "capacity": ep["capacity"], "drops": ep["drops"],
               "gather_capacity": ref_cf, "gather_drops": ref_tried,
               "logit_rel_err": logit_rel, "argmax_agree": argmax_agree,
               "ep_vs_f32": ep_f32, "gather_vs_f32": gather_f32,
               "factor": MESH_LOGIT_FACTOR,
               "f32_vs_one_rank_f32": f32_rel,
               "f32_sparse_layers": sparse_rows,
               "f32_tolerance": MESH_F32_RTOL,
               "forward_ms": ep["forward_ms"],
               "sparse_prefill_ms": ep["sparse_prefill_ms"],
               "sparsity": MESH_SPARSITY,
               "peak_gb": [x["ep"]["peak_gb"] for x in ranks]},
        "int8": {"mesh": [2, 1, 1], "losses": ranks[0]["int8"]["losses"],
                 "grad_norms": ranks[0]["int8"]["grad_norms"],
                 "uncompressed_losses": ranks[0]["dp"]["losses"],
                 "uncompressed_grad_norms": ranks[0]["dp"]["grad_norms"],
                 "max_err_over_int8_bound": max(
                     x["int8_error"]["max_over_bound"] for x in ranks),
                 "compressed_grad_norm": int8_err["gc_norm"],
                 "uncompressed_grad_norm": int8_err["g_norm"],
                 "pods_equal": True,
                 "step_ms": ranks[0]["int8"]["step_ms"],
                 "uncompressed_step_ms": ranks[0]["dp"]["step_ms"],
                 "peak_gb": [x["int8"]["peak_gb"] for x in ranks],
                 "tolerance": MESH_INT8_RTOL},
        "phase_s": time.perf_counter() - t_phase}), flush=True)
    mesh_decode_check(ranks, card)
    per_rank = []
    for res in ranks:
        per_rank.append({"rank": res["rank"], **{
            name: n for name, n in sum_counts(_rank_runs(res)).items() if n}})
    print(json.dumps({"phase": "mesh launches", "ranks": per_rank}),
          flush=True)
    runs = one["runs"] + [r for res in ranks for r in _rank_runs(res)]
    return sum_counts(runs)


def _rank_runs(res) -> list:
    """A mesh rank's counted runs."""
    return (res["tp"]["runs"] + res["ep"]["forward_runs"]
            + res["ep"]["sparse_runs"] + res["ep"]["f32_forward_runs"]
            + res["ep"]["f32_sparse_runs"] + res["dp"]["runs"]
            + res["int8"]["runs"]
            + [c for d in res["decode"] for c in d["runs"]])


def mesh_decode_check(ranks, card) -> None:
    """The meshed decode's checks (``_mesh_decode``) and its line: every
    run of a rank counted (a sparse model's: ``bsr_matmul`` once a
    projection a layer a step, nothing else; a dense one's: no kernel),
    its logits finite; rank 0's f32 steps within MESH_DECODE_F32_RTOL of
    one rank's, its bf16 logits at most MESH_LOGIT_FACTOR as far (relative
    norm) from the meshless f32 ones as the meshless bf16 decode's, and
    its f32 next tokens the meshless argmax wherever that is clear."""
    for res in ranks:
        for d in res["decode"]:
            per_run = d["layers"] * MESH_DECODE_PROJECTIONS * d["steps"]
            want = expect(bsr_matmul=per_run) if d["sparse"] else expect()
            for c in d["runs"]:
                check(c == want, f"mesh decode rank {res['rank']} "
                      f"{d['arch']} (sparse {d['sparse']}): launched {c}, "
                      f"expected {want}")
            check(d["finite"], f"mesh decode rank {res['rank']} "
                  f"{d['arch']}: logits not finite")
            check(d["bcsr_leaves"] == (d["layers"] * MESH_DECODE_PROJECTIONS
                                       if d["sparse"] else 0),
                  f"mesh decode {d['arch']}: {d['bcsr_leaves']} BCSR "
                  f"leaves")
    for d in ranks[0]["decode"]:
        what = f"mesh decode {d['arch']} (sparse {d['sparse']})"
        check(d["f32_err"] <= MESH_DECODE_F32_RTOL,
              f"{what}: an f32 step lies {d['f32_err']} x max(1, max "
              f"|logit|) from one rank's (limit {MESH_DECODE_F32_RTOL})")
        check(d["bf16_vs_f32"] <= MESH_LOGIT_FACTOR * d["one_bf16_vs_f32"],
              f"{what}: bf16 logits {d['bf16_vs_f32']} from the meshless f32 "
              f"ones (relative norm), more than {MESH_LOGIT_FACTOR} x the "
              f"meshless bf16 decode's {d['one_bf16_vs_f32']}")
        check(d["next_agree"] == d["next_clear"] > 0,
              f"{what}: f32 next tokens agree with the meshless argmax at "
              f"{d['next_agree']} of {d['next_clear']} clear positions")
    print(json.dumps({
        "phase": "mesh_decode", "card": card, "mesh": [1, 2],
        "backend": "gloo", "rows": MESH_DECODE_ROWS,
        "max_len": MESH_DECODE_LEN, "prompt": MESH_DECODE_PROMPT,
        "sparsity": MESH_SPARSITY, "f32_tolerance": MESH_DECODE_F32_RTOL,
        "bf16_factor": MESH_LOGIT_FACTOR,
        "runs": [{k: v for k, v in d.items() if k != "runs"}
                 | {"launches": [{n: c for n, c in r.items() if c}
                                 for r in d["runs"]]}
                 for d in ranks[0]["decode"]],
        "rank1_step_ms": [d["step_ms"] for d in ranks[1]["decode"]],
        "phase_s": sum(d["seconds"] for d in ranks[0]["decode"])}),
        flush=True)


def _in_proj_width(cfg) -> int:
    """A Mamba2 layer's in_proj outputs: z and x (d_inner each), B and C
    (ssm_state each), dt (one a head)."""
    return 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads


class DryRun:
    """The dry run's cells, one after another in a background thread, each
    in a subprocess that sees no card and takes four torch threads: started
    before the kernels' build, joined (``join``) before the first timed
    phase.  ``stop`` kills the cell running, and no other starts."""

    def __init__(self):
        self.results = []
        self.proc = None
        self.stopped = False
        self.lock = threading.Lock()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="4")
        for arch, shape, flags in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--tag", "smoke", *flags]
            t1 = time.perf_counter()
            with self.lock:
                if self.stopped:
                    return
                self.proc = subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            try:
                out, err = self.proc.communicate(timeout=DRYRUN_TIMEOUT_S)
                rc = self.proc.returncode
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, err = self.proc.communicate()
                rc = f"killed after {DRYRUN_TIMEOUT_S} s"
            self.results.append((arch, shape, flags, rc, out, err,
                                 time.perf_counter() - t1))

    def join(self) -> float:
        """Wait for the cells; the seconds waited."""
        t0 = time.perf_counter()
        self.thread.join()
        return time.perf_counter() - t0

    def stop(self):
        with self.lock:
            self.stopped = True
            proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        self.thread.join()


def dryrun_phase(dry: DryRun, waited: float):
    """The dry run's cells (run by ``DryRun`` under the build, ``waited``
    the seconds the smoke waited for them after it): each cell's roofline
    lines printed and its JSON checked."""
    check(len(dry.results) == len(DRYRUN_CELLS),
          f"dryrun: {len(dry.results)} of {len(DRYRUN_CELLS)} cells ran")
    for arch, shape, flags, rc, stdout, stderr, seconds in dry.results:
        check(rc == 0, f"dryrun {arch} x {shape}: exit {rc}: "
              f"{stderr[-2000:]}")
        for line in stdout.splitlines():
            if line.startswith(("==", "   ")):
                print(line, flush=True)
        mesh = "2x16x16" if "--multi-pod" in flags else "16x16"
        path = os.path.join(ROOT, "experiments", "dryrun_torch",
                            f"{arch}__{shape}__{mesh}__smoke.json")
        with open(path) as f:
            out = json.load(f)
        check(out["flops"] > 0 and out["coll_bytes"] > 0
              and out["hbm_bytes"] > 0, f"dryrun {arch} x {shape}: empty "
              f"counts {out}")
        check((out["probe_info"] is not None) == (mesh == "16x16"),
              f"dryrun {arch} x {shape}: probes {out['probe_info']}")
        if "--sparse-weights" in flags:
            sw = float(flags[flags.index("--sparse-weights") + 1])
            check(out["sparse_weights"] == sw and out["mem_alias_bytes"] > 0,
                  f"dryrun {arch} x {shape}: sparse_weights "
                  f"{out['sparse_weights']}, alias {out['mem_alias_bytes']}")
        keep = ("flops", "hbm_bytes", "coll_bytes", "coll_breakdown",
                "coll_cross_bytes", "model_flops", "t_compute", "t_memory",
                "t_collective", "bottleneck", "useful_ratio",
                "mem_arg_bytes", "mem_temp_bytes", "mem_alias_bytes",
                "sparse_weights", "lower_s")
        print(json.dumps({"phase": "dryrun", "arch": arch, "shape": shape,
                          "mesh": mesh, **{k: out[k] for k in keep},
                          "seconds": seconds}), flush=True)
    print(json.dumps({"phase": "dryrun", "waited_seconds": waited}),
          flush=True)


# what the split-TF32 rows' numbers are: all of them, then the backward's
F32_TERMS = ("bound_ms prices every product as the split's three TF32 "
             "products on the tensor cores (495 TFLOP/s), bound_fma_ms on "
             "the f32 FMA units (67 TFLOP/s); err_from_mirror the distance "
             "from flash_attention_fwd_tf32_plain or "
             "flash_attention_bwd_tf32_plain")
F32_BWD_TERMS = (F32_TERMS + "; plain: the whole plain backward; library: "
                 "SDPA's whole backward under its pinned backend "
                 "(library_is), timed once a shape")


def kernel_entries(rows, launches, arch_rows):
    """The ``kernels`` JSON line's entries: each kernel's source, the TPU
    kernel it replaces, its counted launches, and its rows' error, times
    and bound; ``arch_rows`` (by kernel) are the rows held at the other
    archs' shapes, listed one by one in the entry and counted in its
    ``max_abs_err``."""
    meta = {
        "sparse_conv": ("src/repro_torch/kernels/sparse_conv/csrc/sparse_conv.cu",
                        "src/repro/kernels/sparse_conv/kernel.py:213"),
        "bsr_conv": ("src/repro_torch/kernels/bsr_conv/csrc/bsr_conv.cu",
                     "src/repro/kernels/bsr_conv/kernel.py:155"),
        **{name: ("src/repro_torch/kernels/sparse_conv/csrc/sparse_conv.cu",
                  "src/repro/kernels/sparse_conv/kernel.py:213")
           for name, _ in ELL_VARIANTS},
        **{name: ("src/repro_torch/kernels/bsr_conv/csrc/bsr_conv.cu",
                  "src/repro/kernels/bsr_conv/kernel.py:155")
           for name, _, _ in BSR_VARIANTS},
        "sparse_conv_bf16": (
            "src/repro_torch/kernels/sparse_conv/csrc/sparse_conv.cu",
            "src/repro/kernels/sparse_conv/kernel.py:213"),
        "bsr_conv_bf16": ("src/repro_torch/kernels/bsr_conv/csrc/bsr_conv.cu",
                          "src/repro/kernels/bsr_conv/kernel.py:155"),
        "bsr_matmul": ("src/repro_torch/kernels/bsr_matmul/csrc/bsr_matmul.cu",
                       "src/repro/kernels/bsr_matmul/kernel.py:49"),
        "flash_attention": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:136"),
        "flash_attention_bwd_dq": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:170"),
        "flash_attention_bwd_dkv": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:187"),
        "flash_attention_tc": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:136"),
        "flash_attention_bwd_dq_tc": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:170"),
        "flash_attention_bwd_dkv_tc": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:187"),
        **{f"flash_attention{kind}_d{d}": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:136")
           for kind in ("_tc", "")
           for d, _ in DIM_INSTANCES},
        **{f"flash_attention_bwd_{part}{kind}_d{d}": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            f"src/repro/kernels/flash_attention/kernel.py:{line}")
           for part, line in (("dq", 170), ("dkv", 187))
           for kind in ("_tc", "")
           for d, _ in DIM_INSTANCES},
        **{f"bsr_matmul_{sched}_b128": (
            "src/repro_torch/kernels/bsr_matmul/csrc/bsr_matmul.cu",
            "src/repro/kernels/bsr_matmul/kernel.py:49")
           for sched in ("rows", "wgmma")},
    }
    times_are = {
        "sparse_conv": f"sums over the kernel phase's {len(rows['sparse_conv'])}"
                       f" main-path layers, batch {BATCH}; ms the pipelined "
                       f"schedule, blocking_ms the blocking one (CUDA events), "
                       f"kernel_device_ms and library_device_ms profiler "
                       f"device time",
        "bsr_conv": f"sums over the kernel phase's {len(rows['bsr_conv'])} "
                    f"main-path layers, batch {BATCH}; bound_ms prices the "
                    f"products on the f32 FMA units, bound_tc_ms as the "
                    f"three TF32 products of the split on the tensor cores; "
                    f"kernel_device_ms and library_device_ms profiler "
                    f"device time",
        **{name: f"the ELL kernel on {vdt} banks (one 32-bit word a "
                 f"nonzero, the scale row): sums over the kernel phase's "
                 f"{len(rows[name])} layers, batch {BATCH}, pipelined "
                 f"(blocking_ms the blocking schedule), bit for bit the f32 "
                 f"kernel on the dequantised bank; f32_ms the f32 bank's "
                 f"kernel_ms; library_ms F.conv2d on the dequantised "
                 f"weights; launches from the auto phase's counted forwards"
           for name, vdt in ELL_VARIANTS},
        **{name: f"the BCSR kernel, {'(8, 128) blocks of ' + vdt + ' tiles' if vdt else f'{block} blocks of f32 tiles'}: "
                 f"sums over the kernel phase's {len(rows[name])} layers, "
                 f"batch {BATCH}; bound_tc_ms prices "
                 f"{'two' if vdt else 'three'} TF32 products; f32_ms the "
                 f"(8, 128) f32 bank's kernel_ms; library_ms F.conv2d on the "
                 f"(dequantised) weights; launches from the auto phase"
           for name, vdt, block in BSR_VARIANTS},
        "sparse_conv_bf16": f"the ELL kernel on bf16 activations and a bf16 "
                            f"bank (widened to f32 pairs), pipelined: sums "
                            f"over the kernel phase's "
                            f"{len(rows['sparse_conv_bf16'])} layers, batch "
                            f"{BATCH}; bound_ms bf16 bytes and bf16 "
                            f"operations at 989 TFLOP/s, bound_f32_fma_ms "
                            f"the operations at the FMA units' 67 TFLOP/s, "
                            f"bound_ell_ms at launch/roofline.py's "
                            f"ELL_FLOPS; f32_ms the f32 "
                            f"kernel_ms; library_ms F.conv2d in bf16 "
                            f"(cuDNN); launches from the bf16 phase's "
                            f"counted run (ResNet-50's 39 sparse convs)",
        "bsr_conv_bf16": f"the BCSR kernel on bf16 activations and bf16 "
                         f"(8, 128) tiles, one bf16 wgmma a 16-deep step: "
                         f"sums over the kernel phase's "
                         f"{len(rows['bsr_conv_bf16'])} layers, batch "
                         f"{BATCH}; bound_ms at 989 TFLOP/s bf16; f32_ms the "
                         f"f32 kernel_ms; library_ms F.conv2d in bf16 "
                         f"(cuDNN); launches from the bf16 phase's counted "
                         f"run",
        "bsr_matmul": "sums over wq, wk, gate and down at 4 rows (the rows "
                      "schedule) and 8192 rows (the wgmma schedule), Yi-9B, "
                      "bf16 in and out, sparsity 0.8; rows_* and wgmma_* "
                      "keys: each schedule's sums; rows_cold_ms and "
                      "rows_library_cold_ms the 4 rows' with the L2 "
                      "flushed between calls; decode_rows: the rows "
                      "schedule's sums at each decode row count",
        "flash_attention": "the split-TF32 kernel (flash_fwd_tf32_kernel, "
                           "f32 operands): one causal forward, B 1, H 32, "
                           "KV 4, T 2048, d 128, f32; " + F32_TERMS,
        "flash_attention_bwd_dq": "the split-TF32 kernel "
                                  "(flash_bwd_dq_tf32_kernel, f32 operands): "
                                  "one causal dQ, B 1, H 32, KV 4, T 2048, "
                                  "d 128, f32; " + F32_BWD_TERMS,
        "flash_attention_bwd_dq_tc": "the tensor-core kernel "
                                     "(flash_bwd_dq_tc_kernel, bf16 "
                                     "operands): one causal dQ, B 1, H 32, "
                                     "KV 4, T 4096, d 128; plain and "
                                     "library: the whole backward",
        "flash_attention_bwd_dkv": "the split-TF32 kernel "
                                   "(flash_bwd_dkv_tf32_kernel) and its group "
                                   "sum (flash_dkv_reduce_kernel<float>), f32 "
                                   "operands: one causal dK/dV, B 1, H 32, "
                                   "KV 4, T 2048, d 128, f32; "
                                   + F32_BWD_TERMS,
        "flash_attention_tc": "the tensor-core kernel (flash_fwd_tc_kernel, "
                              "bf16 operands): one causal forward, B 4, H 32, "
                              "KV 4, T 2048, d 128, bf16",
        "flash_attention_bwd_dkv_tc": "the tensor-core kernel "
                                      "(flash_bwd_dkv_tc_kernel) and its "
                                      "group sum (flash_dkv_reduce_kernel), "
                                      "bf16 operands: one causal dK/dV, B 1, "
                                      "H 32, KV 4, T 4096, d 128; plain and "
                                      "library: the whole backward",
    }
    for d, (arch, (b, h, kv, t, _), causal) in FLASH_DIM_SHAPES.items():
        shape = (f"one {'causal' if causal else 'bidirectional'} forward, "
                 f"B {b}, H {h}, KV {kv}, T {t}, d {d} ({arch})")
        times_are[f"flash_attention_tc_d{d}"] = (
            f"the tensor-core kernel (flash_fwd_tc_kernel<{d}>, bf16 "
            f"operands): {shape}, bf16; launches from the {arch} forwards")
        times_are[f"flash_attention_d{d}"] = (
            f"the split-TF32 kernel (flash_fwd_tf32_kernel<{d}>, f32 "
            f"operands): {shape}, f32; {F32_TERMS}; launches from the "
            f"{arch} f32 forwards cut to {EMBEDS_CONSIST_LAYERS} layers and "
            f"its f32 training")
        bwd = shape.replace("one ", "").replace("forward", "backward")
        for part, kernel in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
            extra = (" and its group sum (flash_dkv_reduce_kernel<bf16>)"
                     if part == "dkv" else "")
            times_are[f"flash_attention_bwd_{part}_tc_d{d}"] = (
                f"the tensor-core kernel ({kernel}_tc_kernel<{d}>){extra}, "
                f"bf16 operands: the {part} of one {bwd}, bf16; plain and "
                f"library: the whole backward; arch_rows: "
                f"{'GQA 32:8' if causal else f'T {FLASH_RAGGED_T}'}; "
                f"launches from the {arch} bf16 training")
            times_are[f"flash_attention_bwd_{part}_d{d}"] = (
                f"the split-TF32 kernel ({kernel}_tf32_kernel<{d}>, no group "
                f"sum), f32 operands: the {part} of one {bwd}, f32; "
                f"{F32_BWD_TERMS}; launches from the {arch} f32 training")

    d24, d48 = ANY_DIM_DIMS
    b_, h_, kv_, t_ = ANY_DIM_SHAPE
    shape = (f"B {b_}, H {h_}, KV {kv_}, T {t_}, bidirectional "
             f"(HuBERT-XLarge's shape)")
    for kind, inst, dt in (("_tc", "tc", "bf16"), ("", "tf32", "f32")):
        for part, kernel in (("", "flash_fwd"), ("_bwd_dq", "flash_bwd_dq"),
                             ("_bwd_dkv", "flash_bwd_dkv")):
            times_are[f"flash_attention{part}{kind}_d{d24}"] = (
                f"the {'tensor-core' if inst == 'tc' else 'split-TF32'} "
                f"kernel ({kernel}_{inst}_kernel<32>, run-time head dim "
                f"{d24}, {dt} operands): {shape}, d {d24}; arch_rows the "
                f"same at d {d48} (instantiation 64); launches from "
                f"OLMoE-1B-7B's smoke config (d {d24}): its flash prefill "
                f"and train step in {dt}")
    b_, h_, kv_, t_ = WIDE_SHAPE
    for d in WIDE_DIMS:
        shape = (f"one causal {{}} at Gemma-7B's attention shape, B {b_}, "
                 f"H {h_}, KV {kv_}, T {t_}, d {d} (two 128-column slices)")
        others = (f"; arch_rows the same over GQA {h_}:{WIDE_GQA_KV} and at "
                  f"a bidirectional T of {WIDE_RAGGED_T}"
                  if d == WIDE_DIMS[0] else "")
        path = (f" and Yi-9B re-headed to 16 heads of {d} over 2 (its bf16 "
                f"prefill and train step, its f32 gradients and step)"
                if d == WIDE_DIMS[0] else "")
        for kind, inst, dt in (("_tc", "tc", "bf16"), ("", "tf32", "f32")):
            for part, kernel, what in (
                    ("", "flash_fwd", "forward"),
                    ("_bwd_dq", "flash_bwd_dq", "dQ"),
                    ("_bwd_dkv", "flash_bwd_dkv", "dK/dV")):
                group = (" and its group sum (flash_dkv_reduce_kernel)"
                         if part == "_bwd_dkv" and inst == "tc" else "")
                design = "tensor-core" if inst == "tc" else "split-TF32"
                times_are[f"flash_attention{part}{kind}_d{d}"] = (
                    f"the wide {design} kernel ({kernel}_{inst}_wide_kernel"
                    f"<128>{group}, {dt} operands): " + shape.format(what)
                    + others + "; bound_ms prices the math's products, "
                    "bound_split_ms the products the split runs "
                    "(split_products_over_math); library_ms SDPA pinned to "
                    "the backend library_is names; launches from "
                    "flash_attention_bthd's counted forward and backward at "
                    "this dim" + path)
    for sched, rows_n in (("rows", SERVE_SLOTS), ("wgmma", 8192)):
        times_are[f"bsr_matmul_{sched}_b128"] = (
            f"the {sched} schedule on (128, 128) tiles (sub-rows of (16, "
            f"128) pieces): sums over Yi-9B's wq, wk, gate and down at "
            f"{rows_n} rows, bf16 in and out, sparsity 0.8; arch_rows the "
            f"same on (64, 128) tiles; launches from Yi-9B at (128, 128) "
            f"tiles: " + ("its ServeEngine, one-layer plain check and f32 "
                          "consistency" if sched == "rows" else
                          "its prefill"))

    def sums(rs):
        b_bytes = sum(r["bound_ms"] for r in rs if r["bound_by"] == "bytes")
        b_ops = sum(r["bound_ms"] for r in rs if r["bound_by"] == "operations")
        library = [r["library_ms"] for r in rs]
        return {"max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["kernel_ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": b_bytes + b_ops,
                "bound_by": "bytes" if b_bytes > b_ops else "operations",
                # null where a pinned backend refused the shape
                "library_ms": (None if None in library else sum(library))}

    kernels = []
    for name, (source, replaces) in meta.items():
        # bsr_matmul: the serve phase's decode rows and the prefill's, as
        # the times_are says
        main = [r for r in rows[name]
                if name != "bsr_matmul" or r["schedule"] == "wgmma"
                or r["rows"] == SERVE_SLOTS]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 **sums(main), "times_are": times_are[name]}
        if name in ("sparse_conv", "bsr_conv"):
            for key in ("kernel_device_ms", "library_device_ms"):
                entry[key] = sum(r[key] for r in rows[name])
        if name in CNN_NAMES and name not in ("sparse_conv", "bsr_conv"):
            for key in ("kernel_device_ms", "f32_ms"):
                entry[key] = sum(r[key] for r in rows[name])
        if name in dict(ELL_VARIANTS):
            entry["blocking_ms"] = sum(r["blocking_ms"] for r in rows[name])
        if name.startswith("bsr_conv_"):
            entry["bound_tc_ms"] = sum(r["bound_tc_ms"] for r in rows[name])
        if name == "sparse_conv":
            entry["blocking_ms"] = sum(r["blocking_ms"] for r in rows[name])
        if name == "sparse_conv_bf16":
            for key in ("bound_f32_fma_ms", "bound_ell_ms"):
                entry[key] = sum(r[key] for r in rows[name])
        if name == "bsr_conv":
            entry["bound_tc_ms"] = sum(r["bound_tc_ms"] for r in rows[name])
        if arch_rows.get(name):
            entry["max_abs_err"] = max(entry["max_abs_err"], *(
                r["max_abs_err"] for r in arch_rows[name]))
            entry["arch_rows"] = [{
                "arch": r["arch"], "proj": r.get("proj"),
                "rows": r.get("rows"), "shape": r["shape"],
                "schedule": r.get("schedule"),
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
                for r in arch_rows[name]]
        if name == "flash_attention_bwd_dkv_tc":
            entry["reduce_launches"] = launches["flash_attention_dkv_reduce"]
        if name == "flash_attention_bwd_dkv":
            entry["reduce_launches"] = launches[
                "flash_attention_dkv_reduce_tf32"]
        if rows[name] and "err_from_mirror_over_max" in rows[name][0]:
            entry["bound_fma_ms"] = sum(r["bound_fma_ms"]
                                        for r in rows[name])
            entry["err_from_mirror_over_max"] = max(
                e for r in rows[name]
                for e in r["err_from_mirror_over_max"].values())
            entry["library_is"] = rows[name][0]["library_is"]
        if name.startswith("flash_attention_bwd_dkv_tc_d"):
            entry["reduce_launches"] = launches[name]
        if rows[name] and "bound_split_ms" in rows[name][0]:
            entry.update({key: rows[name][0][key] for key in (
                "slices", "split_products_over_math", "bound_split_ms",
                "bound_split_by", "library_is")})
        if name == "bsr_matmul":
            entry["wgmma_launches"] = launches["bsr_matmul_wgmma"]
            entry["rows_launches"] = (launches["bsr_matmul"]
                                      - launches["bsr_matmul_wgmma"])
            for sched in ("rows", "wgmma"):
                part = sums([r for r in main if r["schedule"] == sched])
                entry.update({f"{sched}_{k}": v for k, v in part.items()})
            decode = {}
            for r in rows[name]:
                if r["schedule"] == "rows":
                    decode.setdefault(r["rows"], []).append(r)
            entry["decode_rows"] = {
                str(n): {**sums(rs), **{
                    key: sum(r[key] for r in rs)
                    for key in ("kernel_cold_ms", "library_cold_ms")}}
                for n, rs in decode.items()}
            serve = entry["decode_rows"][str(SERVE_SLOTS)]
            entry["rows_cold_ms"] = serve["kernel_cold_ms"]
            entry["rows_library_cold_ms"] = serve["library_cold_ms"]
        kernels.append(entry)
    return kernels


def load_modules() -> dict:
    """The port's modules the phases use (``src/`` on the path)."""
    import numpy as np

    from repro_torch import serving, telemetry, tuning
    from repro_torch.analysis import cuda_lints
    from repro_torch.analysis.checker import (default_kernel_paths,
                                              preflight, run_check)
    from repro_torch.engine import NoKernelSchedule
    from repro_torch.core.direct_conv import pad_in
    from repro_torch.core.pruning import block_prune_conv
    from repro_torch.core.sparse_format import (bcsr_conv_from_dense,
                                                bcsr_conv_to_dense,
                                                dequantize, quantize_values)
    from repro_torch.engine import CnnEngine, params_from_reference
    from repro_torch.tuning import PlanCache, PlanEntry
    from repro_torch.engine.engine import DEFAULT_BSR_BLOCK
    from repro_torch.engine.lower import lower
    from repro_torch.kernels import _build, budget
    from repro_torch.kernels.bsr_conv import ops as ops_bsr
    from repro_torch.kernels.bsr_conv.kernel import (bsr_conv_kernel,
                                                     split_weights)
    from repro_torch.kernels.bsr_conv.ref import (bsr_conv_plain,
                                                  bsr_conv_split_plain)
    from repro_torch.kernels.sparse_conv import ops as ops_ell
    from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel
    from repro_torch.kernels.sparse_conv.ref import (entry_format,
                                                     slab_width,
                                                     sparse_conv_plain)
    from repro_torch.kernels.bsr_conv.ref import bsr_conv_blocked_ref
    from repro_torch.launch import roofline
    from repro_torch.models import cnn
    from repro_torch import configs
    from repro_torch.core.pruning import block_prune
    from repro_torch.core.sparse_format import bcsr_from_dense
    from repro_torch.kernels.bsr_matmul import kernel as bsr_matmul_mod
    from repro_torch.kernels.bsr_matmul.kernel import (bsr_matmul_kernel,
                                                       schedule)
    from repro_torch.kernels.bsr_matmul.ops import bsr_matmul
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels.flash_attention.kernel import (
        bwd_delta, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention import kernel as flash_mod
    from repro_torch.kernels.flash_attention.ops import flash_attention_bthd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_bwd_split_plain,
        flash_attention_bwd_tf32_plain, flash_attention_fwd_tf32_plain,
        flash_attention_plain, flash_attention_split_plain)
    from repro_torch.launch.serve import sparsify_params
    from repro_torch.launch.steps import (init_state, loss_and_grads,
                                          make_prefill_step, make_serve_step,
                                          make_train_step, place_batch,
                                          place_state, state_placements)
    from repro_torch.core.sparse_format import BcsrMatrix, bcsr_to_dense
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe_ep
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import StepRunner
    from repro_torch.tree import tree_flatten, tree_map, tree_paths
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import flags
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import dense_init
    from repro_torch.serving import Request, ServeEngine

    mods = dict(np=np, cnn=cnn, pad_in=pad_in, ops_ell=ops_ell,
                quantize=quantize_values, dequantize=dequantize,
                bcsr_to_dense=bcsr_conv_to_dense, tuning=tuning,
                telemetry=telemetry, CnnEngine=CnnEngine, serving=serving,
                NoKernelSchedule=NoKernelSchedule,
                analysis=dict(preflight=preflight, run_check=run_check,
                              kernel_paths=default_kernel_paths,
                              kernels_of=cuda_lints.kernels_of),
                PlanEntry=PlanEntry, PlanCache=PlanCache,
                block_prune_conv=block_prune_conv,
                params_from_reference=params_from_reference,
                ops_bsr=ops_bsr, ell_kernel=sparse_conv_kernel,
                ell_plain=sparse_conv_plain, bsr_kernel=bsr_conv_kernel,
                bsr_plain=bsr_conv_plain, bsr_split_plain=bsr_conv_split_plain,
                split_weights=split_weights,
                bcsr_from_dense=bcsr_conv_from_dense,
                block=DEFAULT_BSR_BLOCK,
                kernels={"sparse_conv": sparse_conv_kernel,
                         "bsr_conv": bsr_conv_kernel,
                         "bsr_matmul": bsr_matmul_kernel,
                         "flash_attention": flash_attention_fwd,
                         "flash_attention_bwd_dq": flash_attention_bwd_dq,
                         "flash_attention_bwd_dkv": flash_attention_bwd_dkv},
                matmul_plain=bsr_matmul_plain, bsr_schedule=schedule,
                bsr_matmul=bsr_matmul, flash_bthd=flash_attention_bthd,
                flash_plain=flash_attention_plain, bcsr_matrix=bcsr_from_dense,
                block_prune=block_prune, dense_init=dense_init, T=T,
                sparsify=sparsify_params, flags=flags, dc=dataclasses,
                make_prefill_step=make_prefill_step,
                make_serve_step=make_serve_step, ServeEngine=ServeEngine,
                Request=Request, yi9b=configs.get_config("yi-9b"),
                flash_bwd_plain=flash_attention_bwd_plain,
                flash_bwd_tf32_plain=flash_attention_bwd_tf32_plain,
                flash_fwd_tf32_plain=flash_attention_fwd_tf32_plain,
                flash_split_plain=flash_attention_split_plain,
                flash_bwd_split_plain=flash_attention_bwd_split_plain,
                bwd_delta=bwd_delta,
                CheckpointManager=CheckpointManager, DataConfig=DataConfig,
                SyntheticLMDataset=SyntheticLMDataset, init_state=init_state,
                make_train_step=make_train_step, AdamWConfig=AdamWConfig,
                adamw_init=adamw_init, StepRunner=StepRunner,
                loss_and_grads=loss_and_grads, tree_flatten=tree_flatten,
                tree_paths=tree_paths, tree_map=tree_map, configs=configs,
                layers=layers,
                serve_main=serve_main, budget=budget, S=S,
                make_mesh=make_mesh, moe_ep=moe_ep, place_batch=place_batch,
                place_state=place_state, state_placements=state_placements,
                steps=steps_mod, C=C, BcsrMatrix=BcsrMatrix,
                bcsr_to_dense_matrix=bcsr_to_dense,
                slab_width=slab_width, bsr_blocked_ref=bsr_conv_blocked_ref,
                ell_entry_format=entry_format, roofline=roofline,
                launchers={"bsr_matmul": bsr_matmul_mod, "flash": flash_mod})
    return mods


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.engine.lower import lower
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]

    dry = DryRun()   # on the host's cores under the build
    atexit.register(dry.stop)   # its cell killed if the smoke dies first
    t0 = time.perf_counter()

    def mark(phase):
        """The seconds since the build started, at the end of ``phase``
        (the host's clock: where the script's time goes)."""
        print(json.dumps({"phase_done": phase,
                          "elapsed_s": time.perf_counter() - t0}),
              flush=True)

    paths = _build.build()
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "libraries": {k: os.path.relpath(str(v), ROOT)
                                    for k, v in paths.items()}}), flush=True)
    for name, log in _build.BUILD_LOGS.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"[ptxas {name} {entry}] {line.strip()}", flush=True)

    mods = load_modules()
    mods["card"] = card
    np, cnn = mods["np"], mods["cnn"]
    nets = {}
    for i, name in enumerate(("resnet50", "googlenet", "alexnet")):
        net = cnn.NETWORKS[name]()
        params = cnn.init_cnn(net, 3, np.random.default_rng(args.seed + i),
                              IMAGE)
        nets[name] = (lower(net, (3, IMAGE, IMAGE)), params)
    dry_waited = dry.join()   # no timed phase runs beside the dry run
    mark("setup")

    try:
        rows = kernel_phase(torch, mods, nets, device, BATCH, args.seed)
        mark("kernel")
        launches = path_phase(torch, mods, nets, device, BATCH,
                              IMAGE, args.seed)
        mark("path")
        auto, roofline = auto_phase(torch, mods, nets, device, BATCH, IMAGE,
                                    args.seed)
        mark("auto")
        pre = preflight_phase(torch, mods, nets, device, BATCH, roofline,
                              args.seed)
        mark("preflight")
        serve_cnn = cnn_serve_phase(torch, mods, nets, device, args.seed)
        mark("cnn-serve")
        bf16_rows, bf16 = bf16_phase(torch, mods, nets, device, BATCH,
                                     args.seed, rows)
        mark("bf16")
        rows.update(bf16_rows)
        for name in CNN_NAMES:
            launches[name] = (launches.get(name, 0) + auto[name] + pre[name]
                              + serve_cnn[name] + bf16[name])
        nets.clear()
        torch.cuda.empty_cache()
        rows.update(llm_kernel_phase(torch, mods, device, args.seed))
        mark("llm kernel")
        decode_consist = llm_consistency_phase(torch, mods, device, args.seed)
        mark("consistency")
        prefill = llm_prefill_phase(torch, mods, device, args.seed)
        mark("prefill")
        serve = llm_serve_phase(torch, mods, device, args.seed)
        mark("serve")
        rows.update(llm_bwd_kernel_phase(torch, mods, device, args.seed))
        mark("bwd kernel")
        rows.update(flash_f32_kernel_phase(torch, mods, device, args.seed))
        mark("flash f32")
        consist = train_consistency_phase(torch, mods, device, args.seed)
        mark("train consistency")
        train = train_phase(torch, mods, device, args.seed)
        mark("train")
        dims_rows, dims_extra = flash_dims_kernel_phase(torch, mods, device,
                                                        args.seed)
        mark("flash dims")
        rows.update(dims_rows)
        blocks, blocks_rows, blocks_extra = blocks_phase(torch, mods, device,
                                                         args.seed)
        mark("blocks")
        rows.update(blocks_rows)
        any_dim, any_dim_rows, any_dim_extra = any_dim_phase(
            torch, mods, device, args.seed)
        mark("any dim")
        rows.update(any_dim_rows)
        wide, wide_rows, wide_extra = wide_phase(torch, mods, device,
                                                 args.seed)
        mark("wide heads")
        rows.update(wide_rows)
        moe, moe_rows = moe_phase(torch, mods, device, args.seed)
        mark("moe")
        families, family_rows = families_phase(torch, mods, device,
                                               args.seed)
        mark("families")
        families_train = families_train_phase(torch, mods, device, args.seed)
        mark("families train")
        mesh = mesh_phase(torch, mods, device, args.seed)
        mark("mesh")
        dryrun_phase(dry, dry_waited)
        mark("dryrun")
        extras = (moe_rows, family_rows, dims_extra, blocks_extra,
                  any_dim_extra, wide_extra)
        arch_rows = {name: [r for ex in extras for r in ex.get(name, [])]
                     for ex in extras for name in ex}
        for name in LLM_NAMES:
            launches[name] = sum(run[name] for run in (
                decode_consist, prefill, serve, consist, train, blocks,
                any_dim, wide, moe, families, families_train, mesh))
        never = [name for name in KERNEL_NAMES if not launches[name]]
        check(not never, f"kernels of the path never launched in its counted "
              f"runs: {never}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = kernel_entries(rows, launches, arch_rows)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
