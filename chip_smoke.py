#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (no exception is caught; any failure exits non-zero with no final line):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. the build: nvcc compiles the four sources under adversarialvlm_tpu_torch/csrc/ (dgrad,
     flash_full, causal_fwd, causal_bwd), in parallel, and ptxas's register, spill and
     shared-memory lines are printed; cuobjdump's SASS of the wgmma libraries must hold HGMMA
     instructions in every instantiation of each of their kernels (flash_full's three, dgrad's,
     causal_fwd's forward and its head_dim-256 forward, causal_bwd's dq, dk/dv and head_dim-256
     dk/dv), dq's and the two forwards' head_dim-256 instantiations among them, the forward's, dq's
     and dk/dv's two head_dim-96 instantiations (causal and segment-only) too, and ptxas must
     report no spills for any of them;
  3. every kernel against its plain version on the card, at the shapes the main paths give it,
     with the error measured per row as |got - ref| / |ref| (worst row reported; |ref| floored
     at 1% of the median row norm; real rows only for the flash and fused kernels) against the
     stated tolerance, and each kernel's device time (each timing window queued behind a
     device-side sleep, so the host's launch cost is not counted) beside its plain version's, one
     PyTorch library call's
     (a yardstick only; the port never calls it: for attention the fastest of SDPA with the boolean
     mask and, where that mask is plain causal or full, with is_causal or no mask) and its bound
     on this card. dgrad runs at the
     shapes of the LLaVA batch-1 and batch-4 steps and of the Gemma-3 step, with its time over
     torch.matmul's weighted by the step's launches; the causal backward's dq + dk/dv is printed
     over SDPA's whole backward and each attention forward over SDPA's forward; a dgrad, attention
     forward or attention backward launch repeated on the same inputs must give equal outputs (no
     atomics; dgrad's split of O adds its partials in a fixed order). The fused_sdpa kernels at
     five timed shapes, causal and not, and over packed multi-segment rows, then their path:
     cli/bench_fused_attention.py at its defaults against the plain einsum attention, with its
     launches counted from zero. The head_dim-256 kernels (Gemma-3's global layers) at the safety
     judge's text-only prefill shape: 16 rows of T 704, 8 heads, 4 kv heads, each row left-padded by
     a seeded 0-160 tokens, and without pads, batched and over one row (the batch-1 route);
  4L. the LLaVA-1.5-7B victim from a checkpoint directory: its seed-0 random bf16 parameters at
     full width and depth, drawn on the card, are written by the port's fabricator
     (cli/fabricate_ckpt.py: sharded safetensors, config.json, the Llama-style tokenizer.json)
     under the git-ignored adversarialvlm_tpu_torch/build/, and loaded back the CLI's way
     (resolve_checkpoint -> build_victim_from_checkpoint): every tensor equal to the written one,
     the patched config equal to llava_1_5_7b(); the directory stays for 4X and 4D. This victim, with
     the checkpoint's tokenizer, is the victim of phases 3 (the LLaVA shapes), 4, 4t, 4b, 4R and 5;
  4. the batch-1 path: the loaded LLaVA-1.5-7B single-victim attack through ``train()`` for
     1 warm-up step + 5 steps, with each kernel's launches counted over that run only;
  4t. the batch-1 path with the paper's blur (kernel 5, σ 7), the local crop and a 256² random
     square mask moved every step, through ``train(run_tests=True)``, counted from zero: the same
     kernel launches per step as 4, and the saved image is the blurred one;
  4b. the batch-4 path: the same victim at the attack's default batch of 4 over the default
     prompt pool through ``train(run_tests=True)``, whose save boundaries greedy-decode the 50
     held-out questions (64 new tokens) and write their CSVs; launches are counted over that run
     and attributed to the step, the monitor and the decode by a probe around the forward;
  4Z. --remat_policy on the same resident weights at batch 4: one step (loss and image gradient) under none,
     dgrad, dgrad_lean and gate on the same draws, each with its ms and its peak from an emptied cache; each
     policy's loss within 1e-2 relative of none's and its gradient at cosine >= 0.99, and a named policy's
     step launching the flash forward twice a layer (the recompute), the backward and dgrad as none's;
  4R. true resume and the profiler: at batch 1 with 4t's transforms and transform_prob 0.5 (every
     generator drawn from), an uninterrupted run of 6 steps against one of 3 steps resumed from its
     saved attack state to 6 with a profile directory: the resumed metrics.jsonl rows and final
     image equal the uninterrupted ones, and the trace of the second chunk names the dgrad and
     causal kernels;
  5. depth-cut references (the loaded weights' first 2 decoder and 2 vision layers), the card in
     bf16 through the kernels against the CPU in f32 on the plain path: the attack step at batch 1
     and at batch 4, the batch-1 step with 4t's transforms (crop box and square injected), and the
     test decode, teacher-forced.
  B. cli/bench.py at its defaults but for its timed windows, 3 of them (bench.py's configuration on its own
     random-weight 7B, the LLaVA victim freed first): its JSON line.
Then, with the LLaVA victim freed so that each phase's peak memory is its own, the Gemma-3-4B
victim, whose 4096-patch SigLIP tower runs the non-causal flash_full kernels (their phase-3
checks run first, before any victim is resident, and print each kernel's time over SDPA's:
the forward over SDPA's forward, dq + dk/dv over SDPA's whole backward):
  4G. the Gemma-3-4B-it victim from a checkpoint directory, as in 4L (the Gemma-style
     tokenizer.json of 262,145 tokens): the victim of 4g, 4c and 5c;
  4g. the Gemma-3 safety judge's text-only prefill at full width and depth on the victim's
     weights: ``gemma3.forward(..., logits_last_k=1)`` over 16 left-padded rows of T 704 under
     no_grad, counted from zero: exactly one head_dim-256 flash forward per global layer (5 of 34)
     and forward, no backward; each forward timed, with the flash launches' share of it;
  4c. the full-width, full-depth Gemma-3-4B-it attack on the loaded victim at the default batch
     of 4 through ``train(run_tests=True)``: 1 warm-up + 2 steps, save boundaries at iterations 0
     and 2, each decoding the 50 held-out questions at 64 new tokens; launches are attributed to
     the step, the monitor and the decode as in 4b;
  5c. depth-cut references at full width (the loaded weights' first 6 decoder layers, so five
     sliding-window layers and the global one run; 2 vision layers at the full 4096 patches),
     the card in bf16 against the CPU in f32 on the plain path: the batch-4 step, the test
     decode, teacher-forced, and the judge's text-only prefill over 2 rows of T 704 (one
     left-padded), whose global layer takes the head_dim-256 flash forward on the card:
     last-position logits cosine >= 0.99.
Then, with the Gemma-3 victim freed, the cross-model universal attack, both victims loaded again
from the directories of 4L and 4G and resident on the card. From 4X to 4B each directory's tree and
tokenizer are read once and handed to every later load of the same directory (``shared_loads``), so
those phases' peaks hold both trees:
  4X. cli/crossattack_models.py at the reference script's settings (scripts/attacks/
     attack_cross.sh: batch 1, ε 0.4 by default, the list prompts, random targets) on
     llava-hf/llava-1.5-7b-hf,google/gemma-3-4b-it: 1 warm-up + 4 steps, save boundaries at
     iterations 0 and 4, each decoding MESH_TEST_QUESTIONS held-out questions (MESH_DECODE_TOKENS new tokens,
     one chunk) with both victims; counted from
     zero after the load, per cross step exactly LLaVA's and Gemma's dgrad launches (364 + 346),
     32 of each batch-1 causal kernel and 27 of each flash_full kernel. Then every kernel of that
     run against its plain version and timed, as in 3, at the shapes the run gave it, read from
     the victims the CLI built: dgrad over both victims' linears at batch 1 (LLaVA's T, Gemma's
     T), the batch-1 causal kernels at LLaVA's T with the first step's pad, flash_full forward and
     backward at batch 1 (the step, the monitor and Gemma's decode prefill) and the flash forward
     at LLaVA's decode prefill, whose (batch, T) must be the run's. Then the cross step beside each
     victim's step alone on the same resident victims, pools and draws, in turns (1 round of 3
     steps each, with the allocator's device allocations) and under torch.profiler (wall and
     device-busy time of 1 step), and the steps' peak memory from an emptied cache. Then the same
     CLI with --use_gaussian_blur for 3 steps, without the test decode the first run checked: the
     saved image is x₀ + blur at the last step's σ;
  5X. depth-cut references of the cross step (model weights 1.0 and 0.5): LLaVA's first 2 decoder
     and 2 vision layers with Gemma-3's first 6 decoder and 2 vision layers, from the weights 4X
     loaded, the card in bf16 through the kernels against the CPU in f32 on the plain path with
     the same injected draws: loss, loss_0 and loss_1 within 1e-2 relative, gradient cosine >= 0.99;
  4D. DPO through the cross CLI with LLaVA alone (--DPO_flag --refuse_prob 0.5, batch 1, without the
     test decode): an uninterrupted run of 6 steps against one of 3 steps resumed from its
     attack_state_latest.pt to 6: the resumed metrics.jsonl rows (every refuse_flag and target_idx among them) and the
     final image equal, the run refusing at some steps and not at others; and --DPO_flag with
     Gemma-3 among the victims raises ValueError before any file is read.
Then, with the cross victims freed, the judge and the three-stage evaluation through the port's
eval CLIs (--device cuda), the judge the full-width, full-depth Gemma-3-4B-it and the SafeBench
victim LLaVA-1.5-7B, both from the directories of 4L and 4G (the trees 4X read):
  4J. A: cli/find_best_iter.py over 4X's run (LLaVA's and Gemma's answers to the 8 held-out
     questions at iterations 0 and 4) at batch 16: the FSM's build (vocab_bytes, the native table,
     the distances), the table's shape and size, min_close_tokens and the budget, verdicts/s, each
     judge call's prefill and median cached step, the peak; every verdict parses, the detail rows
     are questions x models, the pivot has a row per iteration and ALL_MODELS_MEAN, best.txt names
     an iteration, each judge call launches exactly 5 head_dim-256 flash forwards (its prefill) and
     nothing else. Then the depth-cut judge (6 decoder layers) decodes two answers under the FSM on
     the card in bf16 and on the CPU in f32, teacher-forced: logits cosine >= 0.99, every card
     token legal in the table, both outputs parse; the token table's native and plain builders on
     every 8th vocabulary piece, timed and equal; and the same CLI again judges nothing and leaves
     the pivot's bytes. B: cli/safebench_test.py --model_suf llava-hf on the saved image nearest
     best.txt whose --iter (its iteration - 1) is >= 0, over categories 1-2 of 8 held-out
     questions each (batch 8, 128 new tokens, at least 32): prefill ms, tokens/s, peak; 32 flash
     forwards a prefill and nothing else; 8 rows a category. C: cli/guard_eval.py over B's
     answers: a mean ASR in [0, 1], 2 rows of results, 2 columns of 8 verdicts, every verdict
     parsed, 5 flash forwards a judge call. After each stage, the flash forward against its plain
     version at every attention mask that stage's prefills ran at, timed once a (batch, T).
Then, with the eval victims freed, the baseline benchmarks on the LLaVA tree 4X read:
  4B. cli/baseline_tests.py on LLaVA-1.5-7B at its defaults (batch 8, 128 new tokens, at least 32),
     the victim built by the first run and handed to the later ones: the text modes reference, shii and
     gcg over SafeBench_Text category 1 (8 held-out questions), MM-SafetyBench SD_TYPO over 1 category
     of 8 1024² JPEGs (the committed fixtures of tests/data/, 4:2:0 and 4:4:4 in turn, which must decode
     to the SHA-256 of PIL's pixels recorded beside them) and FigStep over 1 category of 8 760² PNGs: every
     CSV has its 8 rows and no ERROR row, MM-SafetyBench took its batched path in every category, 32
     flash forwards a prefill and none in a cached step; the flash forward at every (batch, T, mask) the
     prefills ran at; prefill ms, tokens/s and peak by suite, the host's JPEG decode and resize ms.
Then, with the baseline victims and the shared trees freed, int8 weights, both victims loaded again from the
directories of 4L and 4G:
  4Q. cli/attack_model.py --int8_weights at batch 1 on the bench's configuration (the one question, the
     one target, a 512² x₀ of 0.47), 1 warm-up + 3 steps with its test decode at iterations 0 and 3:
     the load under quantize-on-load (seconds, resident bytes, quantized fraction; its peak within the
     int8 tree + the largest dense tensor + 1 GiB), 8 quantized tensors equal to quantize_weight of the
     dense loaded ones, per step the dense step's dgrad and batch-1 attention launches, the step ms
     beside phase 4's dense step; dgrad at the int8 step's shapes (Q in bf16); the depth-cut reference
     of the int8 tree (2 + 2 layers, the card in bf16 against the CPU in f32 on the same int8
     weights): loss within 1e-2 relative, gradient cosine >= 0.99; a 50 × 640 test-decode chunk with
     the int8 KV cache, which pick_decode_config takes under a co-resident's reserved bytes, against
     the same chunk teacher-forced through a bf16 cache: last logits cosine >= 0.99, the greedy
     tokens' agreement, prefill ms and tokens/s of both. Then cli/guard_eval.py --int8_weights over
     4J's SafeBench answers: every verdict parses, 5 flash forwards a judge call, prefill and
     cached-step ms beside 4J's dense judge, the verdicts' agreement with it; the flash forward at its
     masks.
Then, with the int8 victims freed, the Qwen2-VL family at full width and depth (Qwen2-VL-2B-Instruct: 28 decoder
layers of 1536, 12 heads over 2 kv heads of 128, M-RoPE; a 32-layer tower of 1280, 16 heads of 80, a 2×2 merger):
  4V. its seed-0 random bf16 parameters drawn on the card and written by the fabricator (Qwen2-style tokenizer.json),
     then scripts/attacks/attack_clamp_tanh_qwen2vl.sh on one card through cli/attack_model.py (gray.png, 512²
     planned to 504²: 1296 patches, 324 image tokens; the list prompts, lr 1e-2, batch 2), 1 warm-up + 3 steps, save
     boundaries at iterations 0 and 3, each decoding the 50 held-out questions: the CLI's victim equal to the written
     tensors; per step 270 dgrad launches and 28 of each batch-2 flash kernel (the tower on the plain sdpa), 28 flash
     forwards a decode prefill and none in a cached step; dgrad, the batch-2 flash kernels, the decode prefill's flash
     forward and the batch-1 causal kernels (n_rep 6) at the run's shapes against their plain versions, timed;
  5V. depth-cut references (2 decoder and 2 vision layers), the card in bf16 against the CPU in f32 on the plain
     path: the step at batch 1 and 2 (loss within 1e-2 relative, gradient cosine >= 0.99) and the test decode,
     teacher-forced over 8 tokens whose cached steps take the prefill's rope_delta (logits cosine >= 0.99);
  4V1. batch 1 from a 1024² source (980²: 4900 patches, 1225 image tokens), 2 steps through train() without the test
     decode: per step 32 of each head_dim-80 flash_full kernel and 28 of each batch-1 causal kernel; the D-80 kernels
     at (1, 4900, 16, 80) against flash_full_plain (forward 1e-2, backward 2e-2 worst row; a second launch equal),
     timed beside their bound and SDPA; the build phase requires HGMMA in each kernel's D-72 and D-80 instantiation;
  4P. cli/test_post.py over 4V's saved images on the victim loaded again: summary.csv a row per image, each image's
     CSV its 50 questions, the decode's launches flash forwards of 28 a prefill only;
  4XV. scripts/attacks/attack_cross_onechip.sh through cli/crossattack_models.py (Qwen2-VL-2B + Gemma-3-4B-it from the
     directories of 4V and 4G, weights 1.0 and 0.5, ε 0.4, random targets, batch 1), 1 warm-up + 3 steps with both
     victims' test decodes: launches a cross step exactly each victim's own (Qwen's 270 dgrad and 28 of each batch-1
     causal kernel, Gemma's 346 dgrad and 27 of each flash_full kernel), the kernels at the run's shapes, the cross step
     beside each victim's alone in turns and under torch.profiler, the peak, and the depth-cut cross reference as 5X.
Then, with the Qwen2-VL and Gemma-3 victims freed, the Phi-3.5-vision family at full width and depth
(microsoft/Phi-3.5-vision-instruct: 32 decoder layers of 3072, 32 MHA heads of 96, LongRoPE; the CLIP ViT-L/14-336
tower over HD tiles of 336², a 2×2 merge with the sub_GN/glb_GN separators and a 2-layer projection to 3072):
  4H. its seed-0 random bf16 parameters drawn on the card and written by the fabricator (the hub's fused qkv_proj and
     gate_up_proj, config.json with synthetic LongRoPE factors, a Llama-style tokenizer.json with Phi-3's chat
     specials), then scripts/attacks/attack_clamp_tanh_phi3.sh on one card through cli/attack_model.py (gray.png,
     512² planned to 672²: a 2×2 tile grid and the global view, 757 image tokens; the list prompts, lr 1e-2, batch 2),
     1 warm-up + 3 steps, save boundaries at iterations 0 and 3, each decoding the 50 held-out questions: the CLI's
     victim equal to the written tensors; per step 364 dgrad launches and 32 of each batch-2 head_dim-96 flash
     kernel (the tower's 577-token tiles on the plain sdpa), 32 flash forwards a decode prefill and none in a cached
     step; dgrad, the D-96 flash kernels at the step's and the decode prefill's shapes and the D-96 batch-1 causal
     kernels at the step's T against their plain versions (forward 1e-2, backward 2e-2 worst row; a second launch
     equal), timed beside their bound and SDPA;
  5H. depth-cut references (2 decoder and 2 vision layers; T far below original_max_position_embeddings, so the short
     LongRoPE factors, as the run), the card in bf16 against the CPU in f32 on the plain path: the step at batch 1 and
     2 (loss within 1e-2 relative, gradient cosine >= 0.99) and the test decode, teacher-forced (logits cosine >=
     0.99);
  4XH. scripts/attacks/attack_cross_onechip_int8.sh through cli/crossattack_models.py (LLaVA-1.5-7B + Phi-3.5-vision
     from the directories of 4L and 4H, int8 weights quantized as they load, ε 0.4, random targets, batch 1), 1
     warm-up + 3 steps with both victims' test decodes (cut as 4X's; 4XV's too): each tree's resident GB and
     quantized fraction, launches a
     cross step exactly each victim's own (LLaVA's 364 dgrad and 32 of each D-128 batch-1 causal kernel, Phi's 364
     and 32 of each at D 96), dgrad at the int8 step's shapes, the D-96 batch-1 kernels at Phi's T timed, the cross
     step beside each victim's alone in turns and under torch.profiler, and the steps' peak;
  4TL. the mesh phase of the main path's victim (below).
Each checkpoint directory is deleted once its last phase is done (Gemma-3's after 4XV, LLaVA's after 4XH, mllama's,
Phi-3.5's and Qwen2-VL's after 4X3, the mesh phases' depth cuts after their phases), in an order that keeps at most
three of the largest on the disk at once, within the script's disk budget of 45 GiB (the blocks a deleted file held
count until they are written again): LLaVA-1.5-7B's is gone before mllama's is written. After 4XH and 4TL (below),
the mllama family runs at full width and depth
(alpindale/Llama-3.2-11B-Vision-Instruct: 40 decoder layers of 4096, cross-attention layers 3, 8, ..., 38,
32 heads over 8 kv heads of 128, MLP 14336, vocabulary 128256 + 8; the tiled tower, 32 local and 8 gated global
layers of 1280, 16 heads of 80, 4 tiles of 560², intermediates of layers 3, 7, 15, 23 and 30):
  4M. its seed-0 random bf16 parameters drawn on the card and written by the fabricator (the hub's key layout,
     non-zero tanh gates, a Llama-3 tokenizer.json), then scripts/attacks/attack_clamp_tanh_llama.sh through
     cli/attack_model.py (gray.png, 512² planned to a 560² canvas: 1 real tile of 4, every tile slot through the
     tower at T 6432 on the chunked rank-1 sdpa; the list prompts, lr 5e-3, batch 1), 1 warm-up + 2 steps, save
     boundaries at iterations 0 and 2, each decoding the 50 held-out questions with the cross k/v cached: the
     CLI's victim equal to the written tensors; per step the dgrad launches the layer structure predicts (500),
     32 batch-1 causal forwards and 29 of each backward at head_dim 128 (the 3 layers before the first cross
     layer depend on no image), no flash_full launch; 32 flash forwards a decode prefill and none in a cached
     step; each step's ms, the steps' peak and the image-gradient norms; dgrad at the run's shapes, the
     batch-1 causal kernels (n_rep 4) at the step's T and the flash forward at the decode prefill against their
     plain versions, timed;
  5M. depth-cut references (decoder layers 0-3, so cross layer 3 runs; 2 local and 1 global tower layers at the
     full T 6432, on the chunked path; the intermediate indices remapped into the cut, logged), the card in bf16
     against the CPU in f32 on the plain path: the batch-1 step (loss within 1e-2 relative, gradient cosine >=
     0.99) and the test decode, teacher-forced (logits cosine >= 0.99);
  4X3. scripts/attacks/attack_cross.sh on one rank (its flags and its three model names, without its --mesh_model 8,
     which 4T3 runs): Phi-3.5-vision, Llama-3.2-11B-Vision and Qwen2-VL-2B at full width and depth from the
     directories of 4H, 4M and 4V, resident on the card together (about 34 GB of bf16 weights), ε 0.4, random
     targets, batch 1, 1 warm-up + 2 steps, each save boundary's test decode of every victim cut to
     MESH_TEST_QUESTIONS questions of MESH_DECODE_TOKENS tokens: launches a cross step exactly the three victims' own
     (1134 dgrad: 364 + 500 + 270; 32 of each batch-1 causal kernel at head_dim 96; at 128, 32 forwards and 29 of
     each backward of mllama (n_rep 4) and 28 of each of Qwen2-VL (n_rep 6); no flash_full), each decode prefill's
     flash forwards those of its decoder's self-attention layers; dgrad, the batch-1 causal kernels and each test
     decode's prefill at the run's shapes against their plain versions, timed; the steps' peak; and the depth-cut
     cross reference (Phi-3.5's and Qwen2-VL's first 2 decoder and 2 tower layers, mllama's 5M cut; weights 1.0
     each): each victim's loss and the total within 1e-2 relative, gradient cosine >= 0.99.
The f32 CPU halves of the depth-cut references 5, 5c, 5X, 4XV's, 5V, 5H, 5M and 4X3's run in one spawned worker
process with its own thread count (CPU_REF_THREADS) and a lower priority, beside the card's next phases: each phase
runs its card half, writes the CPU half's inputs under the git-ignored build/ and goes on; the worker's results are
checked where they are joined, after 4XH (before 4TL) and after 4T3 (before 4T; 5M's and 4X3's run beside 4X3 and
4T3). The (data × model) mesh phases (4TL after 4XH, 4T3 and 4T last) run through an attack CLI with its mesh flags
(parallel/mesh.py::launch spawns the ranks; all share the one card, so the process group is gloo), each rank spied
on in its own process (the
seconds from the launch to its process, to its probe and to its train() logged), then the same command without them
on one rank here; each test decode MESH_DECODE_TOKENS new tokens over MESH_TEST_QUESTIONS questions. Each runs on
depth-cut directories the fabricator writes under a root of their own from the seed-0 parameters of the cut
configurations (CUT_TEXT: every width the configuration's; LLaVA-1.5-7B, Phi-3.5 and Qwen2-VL 4 decoder layers,
mllama 5 with cross layer 3 and a self-attention layer after it, its tower 2 local + 1 global layers at T 6432, the
other towers whole; 8 ranks each holding the three replicated towers at full depth would not fit the card, and the
depth is what the script's time limit gives: PERF.md §4):
  4T3. scripts/attacks/attack_cross.sh as written, --mesh_model 8 (8 ranks), through cli/crossattack_models.py,
     STEPS_X3 steps: Qwen2-VL's 12 heads
     over 2 kv heads in whole-head groups (ranks of 2 and of 1 query head over one kv head), Phi-3.5's 4 MHA heads a
     rank, mllama's 4 over 1 and its cross-attention likewise. The checks of 4T below, each victim's step-1 loss too,
     the collectives of the three decoders (mllama's input-gradient all-reduces from its first cross layer on), the
     launches a step by head dim; then dgrad and the batch-1 causal kernels at each kind of rank's local shapes
     (Qwen2-VL's two) against their plain versions, timed; STEPS_MESH steps in 4T and 4TL:
  4T. scripts/attacks/attack_clamp_tanh_qwen2vl.sh as written (4T3's Qwen2-VL-2B cut, --mesh_data 2 --mesh_model 4:
     8 ranks, batch 2 split into one row a data rank, the decoder's 12 heads over 2 kv heads split 3 a rank over the
     kv head they read);
  4TL. the main path's victim at bench.py's configuration (the LLaVA-1.5-7B cut, batch 1, --mesh_model 2: 16 MHA
     heads a rank).
  Each checks every rank's p after each step bit for bit equal; step 1's loss within 1e-2 relative of the one-rank
  run's, its image gradient (AdamW's first moment) and the first decode prefill's last logits at cosine >= 0.99; a
  rank's launches a step from the layer structure (4T: 150 dgrad, 4 of each batch-1 causal kernel at n_rep 3, the
  one-rank batch 2 taking the flash ones; 4TL: 168 dgrad, 4 of each batch-1 causal kernel), L flash forwards a decode
  prefill and none in a cached step; the collectives a step (1 + 2L reductions, 1 gather, 2L + 1 input-gradient
  all-reduces, one data all-reduce in 4T) with none of a weight's shape; and logs the step's ms and each rank's peak
  beside the one-rank run's and the backend. Then dgrad (each shard routed by its
  whole weight's shape), the batch-1 causal kernels and the flash prefill at a rank's shapes against their plain
  versions, timed.
It then prints each checkpoint directory's write and load seconds and GB/s, the resume verdict,
the bench line, the cross step's numbers, the int8, baseline, Qwen2-VL, Phi-3.5 and mllama numbers and the run's total,
the kernels' JSON line (each kernel with its launches per cross step; dgrad at the int8 step's shapes, the
flash forward at the baseline and int8-judge prefills; the head_dim-96 instantiations as rows of their own; the
n_rep-4 shapes of 4M and the shapes of 4X3 with their entries; a mesh rank's dgrad, batch-1 causal and flash-prefill
kernels of 4T and 4TL, and each kind of 4T3 rank's dgrad and batch-1 causal kernels, as rows of their own), the
card's name and power limit, and
as its last line {"ok": true, "device": {...}}. Without a card it exits non-zero before printing
anything.
"""

import contextlib
import csv
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
QUESTION = "Tell me the forbidden info."
TARGET = "sure, here it is!"
STEPS = 6                 # 1 warm-up + 5 timed
STEPS4 = 4                # batch-4 path: 1 warm-up + 3 timed; save boundaries at iterations 0 and 3
STEPS_G = 3               # Gemma-3 path: 1 warm-up + 2 timed; save boundaries at iterations 0 and 2
STEPS_T = 3               # blur + crop path: 1 warm-up + 2 timed; save boundaries at iterations 0 and 2
DECODE_TOKENS = 64        # the engine's test_max_new_tokens
REF_DECODE_TOKENS = 8
TOL_DGRAD = 1e-2
TOL_ATTN_FWD = 1e-2
TOL_ATTN_BWD = 2e-2
TOL_REF_LOSS = 1e-2       # relative loss difference, depth-cut card vs CPU f32
TOL_REF_COSINE = 0.99     # gradient cosine, depth-cut card vs CPU f32
TOL_DECODE_COSINE = 0.99  # per (row, step) logits cosine, cached card decode vs uncached CPU f32
DECODE_MARGIN = 3.0       # the card's token within this many max|card - CPU| of the CPU's top logit
JUDGE_B, JUDGE_T = 16, 704  # the Gemma-3 safety judge's text-only prefill: its default batch, a 64-bucketed T
JUDGE_PAD_MAX = 160       # each judge row left-padded by a seeded 0..160 tokens
JUDGE_FORWARDS = 3        # timed judge prefill forwards, after one warm-up
RESUME_STEPS, RESUME_CUT = 6, 3  # phase 4R: an uninterrupted run, and one resumed after this many steps
STEPS_X = 5               # phase 4X: 1 warm-up + 4 timed; save boundaries at iterations 0 and 4
STEPS_XB = 3              # phase 4X with the blur: save boundaries at iterations 0 and 2
PROFILE_ROUNDS, TIMED_STEPS = 1, 3  # phase 4X: rounds of timed steps of the cross step and each victim alone
PROFILE_STEPS = 1         # phase 4X: profiled steps of the cross step and of each victim alone
DPO_STEPS, DPO_CUT = 6, 3  # phase 4D: an uninterrupted DPO run, and one resumed after this many steps
CROSS_WEIGHTS = (1.0, 0.5)  # phase 5X's model weights


T_START = time.perf_counter()
REFS = None               # the CpuReferences worker, made in main()


def log(phase, msg):
    """A line of the log, behind the seconds since the script started (the time limit's clock)."""
    print(f"{time.perf_counter() - T_START:7.1f} [{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def spill_lines(log):
    """ptxas's spill lines of a build log that report a spill (stores or loads above 0 bytes)."""
    import re

    return [line.strip() for line in log.splitlines()
            if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))]


def hgmma_counts(lib_path):
    """{kernel name: HGMMA instructions} in the SASS of a built library (cuobjdump beside nvcc)."""
    from adversarialvlm_tpu_torch.ops.kernels.build import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


HOLD_CYCLES = 20_000_000  # about 10 ms of device-side sleep at the H100's clock


def time_ms(fn, reps=10, windows=5):
    """Median device time per call over ``windows`` CUDA-event windows of ``reps`` calls each,
    after a warm-up. Each window is queued behind a device-side sleep that outlasts the host's
    enqueue of the window, so the events time the device's work alone, not the host's launch cost
    (a wrapper's checks, autograd's engine), which would otherwise pace a call of a few tens of
    microseconds. Where the host's enqueue outlasts the sleep, the sleep doubles (up to 8x) and the
    window is taken again."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles, per_call = HOLD_CYCLES, []
    while len(per_call) < windows:
        hold, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        hold.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        b.record()
        b.synchronize()
        if host_ms >= hold.elapsed_time(a) and cycles < 8 * HOLD_CYCLES:
            cycles *= 2
            continue
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_times(label, q, k, v, allowed, do, scale, causal):
    """(forward ms, backward ms, call) of the fastest scaled_dot_product_attention call that computes
    the function: with the boolean mask ``allowed`` (B, T, T), which PyTorch sends to its
    memory-efficient backend, and, where that mask is the plain causal pattern (or, not causal,
    allows every pair), also with ``is_causal=True`` (or no mask), which its flash and cuDNN
    backends take. q, k, v, do (B, H, T, D), k and v already repeated to q's heads; a backward is
    one SDPA backward (dq, dk and dv together). A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    T = q.shape[2]
    idx = torch.arange(T, device=q.device)
    plain = idx[:, None] >= idx[None, :] if causal else torch.ones((T, T), dtype=torch.bool, device=q.device)
    calls = {"boolean mask": {"attn_mask": allowed[:, None]}}
    if bool((allowed == plain).all()):
        calls["is_causal" if causal else "no mask"] = {"is_causal": True} if causal else {}
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    times = {}
    for call, kw in calls.items():
        fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale, **kw))
        out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale, **kw)
        times[call] = (fwd, time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)))
        log("kernels", f"{label}: SDPA with {call}: forward {times[call][0]:.4f} ms, backward "
            f"{times[call][1]:.4f} ms")
    call = min(times, key=lambda c: times[c][0])
    return min(t[0] for t in times.values()), min(t[1] for t in times.values()), call


def row_errors(got, ref):
    """(worst per-row relative error, max abs error); rows are all but the last dim. A row's
    error is |got - ref| / |ref|, with |ref| floored at 1% of the median row norm: some rows'
    exact value is zero (an attention row that sees one key has dq = 0), and there both sides
    hold only rounding noise. A skipped or misplaced tile still shows as O(1) on its rows."""
    d = (got.float() - ref.float()).reshape(-1, ref.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1]).norm(dim=1)
    rel = d.norm(dim=1) / r.clamp(min=0.01 * float(r.median()))
    return float(rel.max()), float(d.abs().max())


def llava_dgrad_cases(victim_params, vlm_cfg, t_text, batch=1):
    """(rows, O, I, launches per step, weight) of every frozen linear whose input gradient the
    step at ``batch`` takes through the dgrad kernel: the CLIP layers that run over the batch's
    images (each row's noise makes its own), the projector and the decoder over its tokens."""
    v, t = vlm_cfg.vision, vlm_cfg.text
    t_vis = (v.image_size // v.patch_size) ** 2 + 1
    n_vis = v.num_layers + 1 + vlm_cfg.vision_feature_layer
    d, hd = t.hidden_size, t.head_dim_
    rows_v, rows_p, rows_t = batch * t_vis, batch * (t_vis - 1), batch * t_text
    shapes = [
        (rows_v, v.hidden_size, v.hidden_size, 4 * n_vis),
        (rows_v, v.intermediate_size, v.hidden_size, n_vis),
        (rows_v, v.hidden_size, v.intermediate_size, n_vis),
        (rows_p, d, v.hidden_size, 1),
        (rows_p, d, d, 1),
        (rows_t, t.num_heads * hd, d, t.num_layers),
        (rows_t, t.num_kv_heads * hd, d, 2 * t.num_layers),
        (rows_t, d, t.num_heads * hd, t.num_layers),
        (rows_t, t.intermediate_size, d, 2 * t.num_layers),
        (rows_t, d, t.intermediate_size, t.num_layers),
    ]
    merged = {}
    for T, O, I, n in shapes:
        merged[(T, O, I)] = merged.get((T, O, I), 0) + n
    lm = victim_params["language_model"]["layers"][0]
    vt = victim_params["vision_tower"]["layers"][0]
    proj = victim_params["multi_modal_projector"]
    weights = {w.shape: w for w in (
        vt["self_attn"]["q_proj"]["weight"], vt["mlp"]["fc1"]["weight"], vt["mlp"]["fc2"]["weight"],
        proj["linear_1"]["weight"], lm["self_attn"]["q_proj"]["weight"],
        lm["mlp"]["gate_proj"]["weight"], lm["mlp"]["down_proj"]["weight"],
    )}
    return [(T, O, I, n, weights[(O, I)]) for (T, O, I), n in merged.items()]


def gemma_dgrad_cases(victim_params, vlm_cfg, batch, t_text):
    """(rows, O, I, launches per step, weight) of the Gemma-3 step's dgrad launches: the tower's
    q/k/v/out (1152², its 4304-wide MLP stays off the kernel, as the JAX rule keeps it) over the
    batch's 4096-patch images, and the decoder's seven linears over the batch's tokens."""
    v, t = vlm_cfg.vision, vlm_cfg.text
    vt = victim_params["vision_tower"]["layers"][0]["self_attn"]
    lm = victim_params["language_model"]["layers"][0]
    rows_v = batch * (v.image_size // v.patch_size) ** 2
    rows_t = batch * t_text
    return [
        (rows_v, v.hidden_size, v.hidden_size, 4 * v.num_layers, vt["q_proj"]["weight"]),
        (rows_t, *lm["self_attn"]["q_proj"]["weight"].shape, t.num_layers, lm["self_attn"]["q_proj"]["weight"]),
        (rows_t, *lm["self_attn"]["k_proj"]["weight"].shape, 2 * t.num_layers, lm["self_attn"]["k_proj"]["weight"]),
        (rows_t, *lm["self_attn"]["o_proj"]["weight"].shape, t.num_layers, lm["self_attn"]["o_proj"]["weight"]),
        (rows_t, *lm["mlp"]["gate_proj"]["weight"].shape, 2 * t.num_layers, lm["mlp"]["gate_proj"]["weight"]),
        (rows_t, *lm["mlp"]["down_proj"]["weight"].shape, t.num_layers, lm["mlp"]["down_proj"]["weight"]),
    ]


def check_dgrad(cases, label="dgrad"):
    """The dgrad kernel against its plain version at each (T, O, I) of ``cases``, twice on the same
    inputs (the outputs must be equal), timed; returns the per-launch numbers weighted by each
    shape's launches per step."""
    import torch

    from adversarialvlm_tpu_torch.ops.kernels.dgrad import dgrad, dgrad_plain, dgrad_plan

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for T, O, I, calls, w in cases:
        dy = torch.randn((T, O), generator=gen, device="cuda", dtype=torch.bfloat16)
        got = dgrad(dy, w)
        ref = dy.float() @ w.float()
        rel, abs_err = row_errors(got, ref)
        if not rel <= TOL_DGRAD:
            raise AssertionError(f"{label} T={T} O={O} I={I}: worst row rel err {rel} > {TOL_DGRAD}")
        if not torch.equal(got, dgrad(dy, w)):
            raise AssertionError(f"{label} T={T} O={O} I={I}: two launches on the same inputs differ")
        ms = time_ms(lambda: dgrad(dy, w))
        plain_ms = time_ms(lambda: dgrad_plain(dy, w))
        lib_ms = time_ms(lambda: torch.matmul(dy, w))
        b_ms, b_by = bound(2.0 * T * O * I, 2.0 * (T * O + O * I + T * I))
        log("kernels", f"{label} T={T} O={O} I={I} launches/step={calls} split, pair={dgrad_plan(T, O, I)} "
            f"worst_row_rel={rel:.3g} max_abs={abs_err:.3g} (tol {TOL_DGRAD}) deterministic ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} ({ms / lib_ms:.2f}x) bound_ms={b_ms:.4f} "
            f"({b_by}) TFLOP/s={2.0 * T * O * I / ms / 1e9:.1f}")
        rows.append(dict(calls=calls, rel=rel, abs=abs_err, ms=ms, plain=plain_ms, lib=lib_ms, bound=b_ms, by=b_by))
    n = sum(r["calls"] for r in rows)

    def weighted(key):
        return sum(r[key] * r["calls"] for r in rows) / n

    summary = {
        "rel": max(r["rel"] for r in rows), "abs": max(r["abs"] for r in rows),
        "ms": weighted("ms"), "plain_ms": weighted("plain"), "library_ms": weighted("lib"),
        "bound_ms": weighted("bound"),
        "bound_by": max(rows, key=lambda r: r["calls"] * r["bound"])["by"],
        "per_step": n,
    }
    log("kernels", f"{label} per launch, weighted by the step's {n} launches: "
        + " ".join(f"{k}={summary[k]:.4f}" for k in ("ms", "plain_ms", "library_ms", "bound_ms"))
        + f" ({summary['bound_by']}); kernel over torch.matmul {summary['ms'] / summary['library_ms']:.3f}x, "
        f"worst shape {max(r['ms'] / r['lib'] for r in rows):.2f}x")
    return summary


def walk_counts(seg, causal):
    """The forward's tile walk over the rows of ``seg`` (B, T), counted by
    ``flash.causal_fwd_tiles``, the kernel's walk rule written out in Python (not read from the
    kernel; a tile the kernel skipped wrongly shows as an error on its rows)."""
    from adversarialvlm_tpu_torch.ops.kernels import flash as Fl

    walks = [Fl.causal_fwd_tiles(row, causal) for row in seg.cpu()]
    n = -(-seg.shape[1] // Fl.TILE)
    pairs = seg.shape[0] * (n * (n + 1) // 2 if causal else n * n)
    return (f"by causal_fwd_tiles the forward walks {sum(map(len, walks))} of the {pairs} "
            f"{'causal ' if causal else ''}tile pairs, {sum(sum(w.values()) for w in walks)} of them masked")


def judge_seg(pads=True):
    """(B, T) int32 attention masks of the judge's prefill: each row left-padded by a seeded 0..160
    tokens, or, with ``pads=False``, none."""
    import torch

    if not pads:
        return torch.ones((JUDGE_B, JUDGE_T), dtype=torch.int32, device="cuda")
    n = torch.randint(0, JUDGE_PAD_MAX + 1, (JUDGE_B,), generator=torch.Generator().manual_seed(0))
    return (torch.arange(JUDGE_T)[None, :] >= n[:, None]).to(torch.int32).cuda()


def judge_cases():
    """The head_dim-256 kernels (Gemma-3's global layers: 8 heads, 4 kv heads of 256) at the judge's
    prefill shape, with its left pads and without, timed: the batched flash entries over its 16 rows
    and the batch-1 entries over one row of it; each against its plain version and SDPA."""
    from adversarialvlm_tpu_torch.models.configs import gemma3_4b_it

    cfg = gemma3_4b_it().text
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    seg = judge_seg()
    pad0 = JUDGE_T - int(seg[0].sum())
    return {
        "flash": flash_case("judge prefill", seg, h, hkv, d, timed=True),
        "flash_no_pad": flash_case("judge prefill, no pad", judge_seg(pads=False), h, hkv, d, timed=True),
        "attention": attention_case(JUDGE_T, h, hkv, d, pad0, timed=True),
        "attention_no_pad": attention_case(JUDGE_T, h, hkv, d, 0, timed=True),
    }


def attention_case(T, H, Hkv, D, pad, timed=False):
    """Each attention kernel against its plain version on the same inputs and residuals."""
    import torch

    from adversarialvlm_tpu_torch.ops.kernels import attention as A
    from adversarialvlm_tpu_torch.ops.kernels.flash import allowed_pairs

    gen = torch.Generator(device="cuda").manual_seed(T * 1000 + H + D)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = randn(1, T, H, D), randn(1, T, Hkv, D), randn(1, T, Hkv, D), randn(1, T, H, D)
    seg = torch.ones(T, dtype=torch.int32, device="cuda")
    seg[:pad] = 0
    scale = D**-0.5
    f32 = [x.float() for x in (q, k, v, do)]

    o, lse = A.attention_fwd(q, k, v, seg, scale)
    dq, delta = A.attention_bwd_dq(q, k, v, seg, o, lse, do, scale)
    dk, dv = A.attention_bwd_dkdv(q, k, v, seg, lse, delta, do, scale)
    again = (*A.attention_fwd(q, k, v, seg, scale), *A.attention_bwd_dq(q, k, v, seg, o, lse, do, scale),
             *A.attention_bwd_dkdv(q, k, v, seg, lse, delta, do, scale))
    if not all(torch.equal(a, b) for a, b in zip((o, lse, dq, delta, dk, dv), again)):
        raise AssertionError(f"attention T={T} H={H} D={D}: two launches on the same inputs differ")
    o_ref, lse_ref = A.attention_plain(f32[0], f32[1], f32[2], seg, scale)
    dq_ref, delta_ref = A.attention_bwd_dq_plain(f32[0], f32[1], f32[2], seg, o.float(), lse, f32[3], scale)
    dk_ref, dv_ref = A.attention_bwd_dkdv_plain(f32[0], f32[1], f32[2], seg, lse, delta, f32[3], scale)
    # rows: (t, head) for o and dq, (t, kv head) for dk and dv, one head's T values for lse and δ
    errs = {
        "o": row_errors(o, o_ref), "lse": row_errors(lse, lse_ref),
        "dq": row_errors(dq, dq_ref), "delta": row_errors(delta, delta_ref),
        "dk": row_errors(dk, dk_ref), "dv": row_errors(dv, dv_ref),
    }
    for name, (rel, _) in errs.items():
        tol = TOL_ATTN_FWD if name in ("o", "lse") else TOL_ATTN_BWD
        if not rel <= tol:
            raise AssertionError(f"attention T={T} H={H} Hkv={Hkv} D={D} pad={pad} {name}: "
                                 f"worst row rel err {rel} > {tol}")
    log("kernels", f"attention T={T} H={H} Hkv={Hkv} D={D} pad={pad} worst_row_rel "
        + " ".join(f"{n}={e[0]:.3g}" for n, e in errs.items())
        + f" (tol fwd {TOL_ATTN_FWD}, bwd {TOL_ATTN_BWD})")
    if not timed:
        return None

    allowed = allowed_pairs(seg[None])[0]
    pairs = float(allowed.sum())
    el = 2.0 * T * D
    fb = bound(4 * pairs * D * H, el * (2 * H + 2 * Hkv) + 4 * H * T)
    qb = bound(6 * pairs * D * H, el * (4 * H + 2 * Hkv) + 8 * H * T)
    kb = bound(8 * pairs * D * H, el * (2 * H + 4 * Hkv) + 8 * H * T)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    kt, vt = (x.repeat_interleave(H // Hkv, dim=1) for x in (kt, vt))
    lib_fwd, lib_bwd, lib_call = sdpa_times(f"attention T={T} H={H} D={D} pad={pad}", qt, kt, vt, allowed[None],
                                            dot, scale, causal=True)
    times = {
        "attention_fwd": (
            time_ms(lambda: A.attention_fwd(q, k, v, seg, scale)),
            time_ms(lambda: A.attention_plain(q, k, v, seg, scale)), lib_fwd, fb),
        "attention_bwd_dq": (
            time_ms(lambda: A.attention_bwd_dq(q, k, v, seg, o, lse, do, scale)),
            time_ms(lambda: A.attention_bwd_dq_plain(q, k, v, seg, o, lse, do, scale)), lib_bwd, qb),
        "attention_bwd_dkdv": (
            time_ms(lambda: A.attention_bwd_dkdv(q, k, v, seg, lse, delta, do, scale)),
            time_ms(lambda: A.attention_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale)), lib_bwd, kb),
    }
    out = {}
    for name, (ms, plain_ms, lib_ms, (b_ms, b_by)) in times.items():
        err_keys = {"attention_fwd": ("o",), "attention_bwd_dq": ("dq",), "attention_bwd_dkdv": ("dk", "dv")}[name]
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library_call": lib_call, "bound_ms": b_ms,
            "bound_by": b_by, "rel": max(errs[e][0] for e in err_keys), "abs": max(errs[e][1] for e in err_keys),
        }
        log("kernels", f"{name} T={T} H={H} D={D} pad={pad} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    log("kernels", f"library_ms is the fastest SDPA call above (forward: with {lib_call}); that of both "
        "backward kernels is one SDPA backward (dq, dk and dv together)")
    log("kernels", f"attention T={T} H={H} D={D}: forward {out['attention_fwd']['ms'] / lib_fwd:.2f}x "
        "SDPA's forward")
    bwd_ms = out["attention_bwd_dq"]["ms"] + out["attention_bwd_dkdv"]["ms"]
    log("kernels", f"attention T={T} H={H} D={D}: dq + dk/dv {bwd_ms:.4f} ms, "
        f"{bwd_ms / lib_bwd:.2f}x SDPA's backward")
    return out


def flash_case(label, seg, H, Hkv, D, timed=False, backward=True):
    """The flash kernels against their plain versions on the same inputs and residuals, over
    the batch of left-padded rows whose segment ids (attention masks) are ``seg`` (B, T);
    errors on real rows only (pad rows are finite but unspecified). Untimed, returns the
    forward's errors alone."""
    import torch

    from adversarialvlm_tpu_torch.ops.kernels import flash as Fl

    B, T = seg.shape
    gen = torch.Generator(device="cuda").manual_seed(B * 100000 + T)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = randn(B, T, H, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D), randn(B, T, H, D)
    scale = D**-0.5
    f32 = [x.float() for x in (q, k, v, do)]
    real = seg.bool()
    o, lse = Fl.flash_fwd(q, k, v, seg, scale)
    if not all(torch.equal(a, b) for a, b in zip((o, lse), Fl.flash_fwd(q, k, v, seg, scale))):
        raise AssertionError(f"flash {label} B={B} T={T} D={D}: two forward launches on the same inputs differ")
    o_ref, lse_ref = Fl.flash_plain(f32[0], f32[1], f32[2], seg, scale)
    errs = {"o": row_errors(o[real], o_ref[real]),
            "lse": row_errors(lse.transpose(1, 2)[real], lse_ref.transpose(1, 2)[real])}
    if backward:
        dq, delta = Fl.flash_bwd_dq(q, k, v, seg, o, lse, do, scale)
        dk, dv = Fl.flash_bwd_dkdv(q, k, v, seg, lse, delta, do, scale)
        again = (*Fl.flash_bwd_dq(q, k, v, seg, o, lse, do, scale),
                 *Fl.flash_bwd_dkdv(q, k, v, seg, lse, delta, do, scale))
        if not all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), again)):
            raise AssertionError(f"flash {label} B={B} T={T} D={D}: two backward launches on the same "
                                 "inputs differ")
        dq_ref, delta_ref = Fl.flash_bwd_dq_plain(f32[0], f32[1], f32[2], seg, o.float(), lse, f32[3], scale)
        dk_ref, dv_ref = Fl.flash_bwd_dkdv_plain(f32[0], f32[1], f32[2], seg, lse, delta, f32[3], scale)
        errs.update({
            "dq": row_errors(dq[real], dq_ref[real]),
            "delta": row_errors(delta.transpose(1, 2)[real], delta_ref.transpose(1, 2)[real]),
            "dk": row_errors(dk[real], dk_ref[real]), "dv": row_errors(dv[real], dv_ref[real]),
        })
    for name, (rel, _) in errs.items():
        tol = TOL_ATTN_FWD if name in ("o", "lse") else TOL_ATTN_BWD
        if not rel <= tol:
            raise AssertionError(f"flash {label} B={B} T={T} H={H} Hkv={Hkv} D={D} {name}: "
                                 f"worst real row rel err {rel} > {tol}")
    pads = [int(T - n) for n in seg.sum(1).tolist()]
    log("kernels", f"flash {label} B={B} T={T} H={H} Hkv={Hkv} D={D} left pads={pads} (pad share "
        f"{sum(pads) / (B * T):.4f}; {walk_counts(seg, True)}) worst_real_row_rel " + " ".join(f"{n}={e[0]:.3g}" for n, e in errs.items())
        + f" (tol fwd {TOL_ATTN_FWD}, bwd {TOL_ATTN_BWD})")
    if not timed:
        return {"flash_fwd": {"rel": errs["o"][0], "abs": errs["o"][1]}}

    allowed = Fl.allowed_pairs(seg)
    pairs = float((allowed & real[:, :, None]).sum())  # the real rows' causal pairs
    el = 2.0 * B * T * D
    bounds = {
        "flash_fwd": bound(4 * pairs * D * H, el * (2 * H + 2 * Hkv) + 4 * B * H * T),
        "flash_bwd_dq": bound(6 * pairs * D * H, el * (4 * H + 2 * Hkv) + 8 * B * H * T),
        "flash_bwd_dkdv": bound(8 * pairs * D * H, el * (2 * H + 4 * Hkv) + 8 * B * H * T),
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    kt, vt = (x.repeat_interleave(H // Hkv, dim=1) for x in (kt, vt))
    lib_fwd, lib_bwd, lib_call = sdpa_times(f"flash {label}", qt, kt, vt, allowed, dot, scale, causal=True)
    times = {"flash_fwd": (
        time_ms(lambda: Fl.flash_fwd(q, k, v, seg, scale)),
        time_ms(lambda: Fl.flash_plain(q, k, v, seg, scale)), lib_fwd)}
    if backward:
        times["flash_bwd_dq"] = (
            time_ms(lambda: Fl.flash_bwd_dq(q, k, v, seg, o, lse, do, scale)),
            time_ms(lambda: Fl.flash_bwd_dq_plain(q, k, v, seg, o, lse, do, scale)), lib_bwd)
        times["flash_bwd_dkdv"] = (
            time_ms(lambda: Fl.flash_bwd_dkdv(q, k, v, seg, lse, delta, do, scale)),
            time_ms(lambda: Fl.flash_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale)), lib_bwd)
    err_keys = {"flash_fwd": ("o",), "flash_bwd_dq": ("dq",), "flash_bwd_dkdv": ("dk", "dv")}
    out = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        b_ms, b_by = bounds[name]
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library_call": lib_call, "bound_ms": b_ms,
            "bound_by": b_by, "rel": max(errs[e][0] for e in err_keys[name]),
            "abs": max(errs[e][1] for e in err_keys[name]),
        }
        log("kernels", f"{name} {label} B={B} T={T} H={H} D={D} real pairs={pairs:.0f} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    log("kernels", f"flash {label} B={B} T={T} D={D}: forward {out['flash_fwd']['ms'] / lib_fwd:.2f}x "
        f"SDPA's forward (with {lib_call})")
    if backward:
        log("kernels", "library_ms of both flash backward kernels is one SDPA backward (dq, dk and dv "
            "together), the fastest call above")
        bwd_ms = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkdv"]["ms"]
        log("kernels", f"flash {label} B={B} T={T} D={D}: dq + dk/dv {bwd_ms:.4f} ms, "
            f"{bwd_ms / lib_bwd:.2f}x SDPA's backward")
    return out


def flash_full_case(label, B, H, T, D, timed=False, backward=True):
    """The non-causal flash_full kernels against their plain versions on the same inputs and
    residuals; every token is real, so every row counts. Each plain reference is freed before the
    next (at B 4, T 4096 one f32 (B, H, T, T) tensor is 4 GiB)."""
    import torch
    import torch.nn.functional as F

    from adversarialvlm_tpu_torch.ops.kernels import flash as Fl

    gen = torch.Generator(device="cuda").manual_seed(B * 100000 + T + 7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = (randn(B, T, H, D) for _ in range(4))
    scale = D**-0.5
    f32 = [x.float() for x in (q, k, v, do)]
    o, lse = Fl.flash_full_fwd(q, k, v, scale)
    o_ref, lse_ref = Fl.flash_full_plain(f32[0], f32[1], f32[2], scale)
    errs = {"o": row_errors(o, o_ref), "lse": row_errors(lse, lse_ref)}
    del o_ref, lse_ref
    if backward:
        dq, delta = Fl.flash_full_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = Fl.flash_full_bwd_dkdv(q, k, v, lse, delta, do, scale)
        dq_ref, delta_ref = Fl.flash_full_bwd_dq_plain(f32[0], f32[1], f32[2], o.float(), lse, f32[3], scale)
        errs.update({"dq": row_errors(dq, dq_ref), "delta": row_errors(delta, delta_ref)})
        del dq_ref, delta_ref
        dk_ref, dv_ref = Fl.flash_full_bwd_dkdv_plain(f32[0], f32[1], f32[2], lse, delta, f32[3], scale)
        errs.update({"dk": row_errors(dk, dk_ref), "dv": row_errors(dv, dv_ref)})
        del dk_ref, dv_ref
    outs, again = (o, lse), Fl.flash_full_fwd(q, k, v, scale)
    if backward:
        outs = (*outs, dq, delta, dk, dv)
        again = (*again, *Fl.flash_full_bwd_dq(q, k, v, o, lse, do, scale),
                 *Fl.flash_full_bwd_dkdv(q, k, v, lse, delta, do, scale))
    if not all(torch.equal(a, b) for a, b in zip(outs, again)):
        raise AssertionError(f"flash_full {label} D={D}: two launches on the same inputs differ")
    del again
    del f32
    torch.cuda.empty_cache()
    for name, (rel, _) in errs.items():
        tol = TOL_ATTN_FWD if name in ("o", "lse") else TOL_ATTN_BWD
        if not rel <= tol:
            raise AssertionError(f"flash_full {label} B={B} H={H} T={T} D={D} {name}: "
                                 f"worst row rel err {rel} > {tol}")
    log("kernels", f"flash_full {label} B={B} H={H} T={T} D={D} worst_row_rel "
        + " ".join(f"{n}={e[0]:.3g}" for n, e in errs.items())
        + f" (tol fwd {TOL_ATTN_FWD}, bwd {TOL_ATTN_BWD}); a second launch equal")
    if not timed:
        return None

    pairs = float(B) * T * T  # every pair is allowed
    el = 2.0 * B * T * D  # one bf16 (B, T, H=1, D) tensor; the real D, not the padded 80
    work = {  # (operations, bytes): each input read once, each output written once
        "flash_full_fwd": (4 * pairs * D * H, el * 4 * H + 4 * B * H * T),
        "flash_full_bwd_dq": (6 * pairs * D * H, el * 6 * H + 8 * B * H * T),
        "flash_full_bwd_dkdv": (8 * pairs * D * H, el * 6 * H + 8 * B * H * T),
    }
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    times = {"flash_full_fwd": (
        time_ms(lambda: Fl.flash_full_fwd(q, k, v, scale)),
        time_ms(lambda: Fl.flash_full_plain(q, k, v, scale)),
        time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))}
    if backward:
        lib_out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True))
        times["flash_full_bwd_dq"] = (
            time_ms(lambda: Fl.flash_full_bwd_dq(q, k, v, o, lse, do, scale)),
            time_ms(lambda: Fl.flash_full_bwd_dq_plain(q, k, v, o, lse, do, scale)), lib_bwd)
        times["flash_full_bwd_dkdv"] = (
            time_ms(lambda: Fl.flash_full_bwd_dkdv(q, k, v, lse, delta, do, scale)),
            time_ms(lambda: Fl.flash_full_bwd_dkdv_plain(q, k, v, lse, delta, do, scale)), lib_bwd)
    err_keys = {"flash_full_fwd": ("o",), "flash_full_bwd_dq": ("dq",), "flash_full_bwd_dkdv": ("dk", "dv")}
    out = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        b_ms, b_by = bound(*work[name])
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "rel": max(errs[e][0] for e in err_keys[name]), "abs": max(errs[e][1] for e in err_keys[name]),
        }
        log("kernels", f"{name} {label} B={B} H={H} T={T} D={D} pairs={pairs:.0f} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"TFLOP/s={work[name][0] / ms / 1e9:.1f}")
    fwd = out["flash_full_fwd"]
    log("kernels", f"flash_full {label}: forward {fwd['ms'] / fwd['library_ms']:.2f}x SDPA's forward "
        f"({work['flash_full_fwd'][0] / fwd['ms'] / 1e9:.1f} TFLOP/s)")
    if backward:
        log("kernels", "library_ms of both flash_full backward kernels is one non-causal "
            "scaled_dot_product_attention backward (dq, dk and dv together)")
        bwd_ms = out["flash_full_bwd_dq"]["ms"] + out["flash_full_bwd_dkdv"]["ms"]
        bwd_ops = work["flash_full_bwd_dq"][0] + work["flash_full_bwd_dkdv"][0]
        log("kernels", f"flash_full {label}: dq + dk/dv {bwd_ms:.4f} ms, {bwd_ms / lib_bwd:.2f}x SDPA's "
            f"backward ({bwd_ops / bwd_ms / 1e9:.1f} TFLOP/s)")
    torch.cuda.empty_cache()
    return out


def fused_case(label, B, H, T, D, causal, pad=0, timed=False, runs=None):
    """The fused_sdpa kernels against their plain versions on the same inputs and residuals, in
    (B, H, T, D) layout with ``pad`` left pads on every row (segment 0) and segment-masked pairs,
    or with each row's segment ids given as ``runs``, a list per row of (id, length) runs (0 =
    pad); errors on real rows only (pad rows are finite but unspecified), with the pad rows' dO
    zeroed as the JAX entry's contract has it."""
    import torch

    from adversarialvlm_tpu_torch.ops.kernels import fused as Fu

    gen = torch.Generator(device="cuda").manual_seed(B * 100000 + T * 10 + D)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    seg = torch.ones((B, T), dtype=torch.int32, device="cuda")
    seg[:, :pad] = 0
    if runs is not None:
        seg = torch.tensor([[i for i, n in row for _ in range(n)] for row in runs], dtype=torch.int32,
                           device="cuda")
        assert seg.shape == (B, T), seg.shape
    real = seg.bool()
    q, k, v = (randn(B, H, T, D) for _ in range(3))
    do = randn(B, H, T, D) * real[:, None, :, None]
    scale = D**-0.5
    f32 = [x.float() for x in (q, k, v, do)]
    o, lse = Fu.fused_fwd(q, k, v, seg, scale, causal)
    dq, delta = Fu.fused_bwd_dq(q, k, v, seg, o, lse, do, scale, causal)
    dk, dv = Fu.fused_bwd_dkdv(q, k, v, seg, lse, delta, do, scale, causal)
    again = (*Fu.fused_fwd(q, k, v, seg, scale, causal), *Fu.fused_bwd_dq(q, k, v, seg, o, lse, do, scale, causal),
             *Fu.fused_bwd_dkdv(q, k, v, seg, lse, delta, do, scale, causal))
    if not all(torch.equal(a, b) for a, b in zip((o, lse, dq, delta, dk, dv), again)):
        raise AssertionError(f"fused {label} B={B} H={H} T={T} D={D} causal={causal}: two launches on the "
                             "same inputs differ")
    o_ref, lse_ref = Fu.fused_plain(f32[0], f32[1], f32[2], seg, scale, causal)
    dq_ref, delta_ref = Fu.fused_bwd_dq_plain(f32[0], f32[1], f32[2], seg, o.float(), lse, f32[3], scale, causal)
    dk_ref, dv_ref = Fu.fused_bwd_dkdv_plain(f32[0], f32[1], f32[2], seg, lse, delta, f32[3], scale, causal)

    def rows(x):  # (B, H, T, ·) -> the real rows' (row, head) vectors
        return x.transpose(1, 2)[real]

    errs = {"o": row_errors(rows(o), rows(o_ref)), "lse": row_errors(rows(lse[..., None]), rows(lse_ref[..., None])),
            "dq": row_errors(rows(dq), rows(dq_ref)),
            "delta": row_errors(rows(delta[..., None]), rows(delta_ref[..., None])),
            "dk": row_errors(rows(dk), rows(dk_ref)), "dv": row_errors(rows(dv), rows(dv_ref))}
    for name, (rel, _) in errs.items():
        tol = TOL_ATTN_FWD if name in ("o", "lse") else TOL_ATTN_BWD
        if not rel <= tol:
            raise AssertionError(f"fused {label} B={B} H={H} T={T} D={D} causal={causal} pad={pad} {name}: "
                                 f"worst real row rel err {rel} > {tol}")
    layout = f"segment runs={runs}" if runs is not None else f"left pads={pad}"
    log("kernels", f"fused {label} B={B} H={H} T={T} D={D} causal={causal} {layout} ({walk_counts(seg, causal)}) "
        "worst_real_row_rel " + " ".join(f"{n}={e[0]:.3g}" for n, e in errs.items()) + f" (tol fwd {TOL_ATTN_FWD}, bwd {TOL_ATTN_BWD})")
    if not timed:
        return None

    allowed = Fu.allowed_pairs(seg, causal)
    pairs = float((allowed & real[:, :, None]).sum())  # the real rows' allowed pairs
    el = 2.0 * B * T * D  # one bf16 (B, 1, T, D) head
    work = {  # (operations, bytes): each input read once, each output written once
        "fused_fwd": (4 * pairs * D * H, el * 4 * H + 4 * B * H * T),
        "fused_bwd_dq": (6 * pairs * D * H, el * 6 * H + 8 * B * H * T),
        "fused_bwd_dkdv": (8 * pairs * D * H, el * 6 * H + 8 * B * H * T),
    }
    lib_fwd, lib_bwd, lib_call = sdpa_times(f"fused {label}", q, k, v, allowed, do, scale, causal)
    times = {
        "fused_fwd": (time_ms(lambda: Fu.fused_fwd(q, k, v, seg, scale, causal)),
                      time_ms(lambda: Fu.fused_plain(q, k, v, seg, scale, causal)), lib_fwd),
        "fused_bwd_dq": (time_ms(lambda: Fu.fused_bwd_dq(q, k, v, seg, o, lse, do, scale, causal)),
                         time_ms(lambda: Fu.fused_bwd_dq_plain(q, k, v, seg, o, lse, do, scale, causal)), lib_bwd),
        "fused_bwd_dkdv": (time_ms(lambda: Fu.fused_bwd_dkdv(q, k, v, seg, lse, delta, do, scale, causal)),
                           time_ms(lambda: Fu.fused_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, scale, causal)),
                           lib_bwd),
    }
    err_keys = {"fused_fwd": ("o",), "fused_bwd_dq": ("dq",), "fused_bwd_dkdv": ("dk", "dv")}
    out = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        b_ms, b_by = bound(*work[name])
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library_call": lib_call, "bound_ms": b_ms,
            "bound_by": b_by, "rel": max(errs[e][0] for e in err_keys[name]),
            "abs": max(errs[e][1] for e in err_keys[name]),
        }
        log("kernels", f"{name} {label} B={B} H={H} T={T} D={D} real pairs={pairs:.0f} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"TFLOP/s={work[name][0] / ms / 1e9:.1f}")
    log("kernels", f"library_ms is the fastest SDPA call above (forward: with {lib_call}); that of both "
        "fused backward kernels is one SDPA backward (dq, dk and dv together)")
    bwd_ms = out["fused_bwd_dq"]["ms"] + out["fused_bwd_dkdv"]["ms"]
    log("kernels", f"fused {label} B={B} H={H} T={T} D={D} causal={causal}: forward "
        f"{out['fused_fwd']['ms'] / lib_fwd:.2f}x SDPA's forward; dq + dk/dv "
        f"{bwd_ms:.4f} ms, {bwd_ms / lib_bwd:.2f}x SDPA's backward")
    return out


def fused_harness():
    """The fused_sdpa path: cli/bench_fused_attention.py at its defaults, counted from zero. Each
    rep launches each of the three fused kernels once; the harness runs a warm-up window and
    ``windows`` timed windows of ``reps`` reps."""
    from adversarialvlm_tpu_torch.cli import bench_fused_attention as H
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    out = H.main([])
    launches = launch_counts()
    n = (H.DEFAULTS["windows"] + 1) * H.DEFAULTS["reps"]  # a warm-up window, then the timed ones
    want = {k: n for k in ("fused_fwd", "fused_bwd_dq", "fused_bwd_dkdv")}
    log("fused", f"bench_fused_attention at its defaults {H.DEFAULTS}, {H.PADS} left pads: fused "
        f"{out['fused_ms']:.3f} ms/rep, plain {out['plain_ms']:.3f} ms/rep, fused/plain "
        f"{out['ratio']:.3f}, checks fused {out['fused_check']:.1f} plain {out['plain_check']:.1f}; "
        f"launches {launches} (expected {want}, one per kernel per rep) in "
        f"{time.perf_counter() - t0:.1f} s")
    others = {k: n for k, n in launches.items() if n and k not in want}
    if any(launches[k] != n for k, n in want.items()) or others:
        raise AssertionError(f"fused harness launches {launches} != {want}")
    rel = abs(out["fused_check"] - out["plain_check"]) / abs(out["plain_check"])
    if not rel <= TOL_REF_LOSS:
        raise AssertionError(f"fused harness: the two paths' chained losses differ by {rel}")
    return launches


class PathProbe:
    """Wraps a bundle's forward for one run. Each forward's kernel launches are attributed to its
    phase: the attack step ("step", under grad), the resaved-loss monitor ("monitor"), the decode
    prefill ("prefill", cache index 0) or a cached decode step ("decode_step"); what launches
    outside the forward is the step's backward. Each test-decode chunk is timed with CUDA events
    from its prefill to its last forward, with its prefill's attention mask (the shape and the
    pads its flash forward ran at) and its peak memory: the peak statistics are reset
    where a chunk begins (when its KV caches are allocated, before its prefill) and where it
    ends, so the steps' peak is kept apart from the caches'. The attention entries' launches are
    also kept by head dim (``launches_d``). Probes on the victims of one run
    share ``group``: a chunk ends where any of them runs a forward other than a cached decode
    step or allocates caches, so one victim's decode peak is never read as another's steps'."""

    def __init__(self, bundle, group=None):
        from collections import Counter

        self.group = [] if group is None else group
        self.group.append(self)
        self.bundle, self.inner, self.inner_caches = bundle, bundle.forward, bundle.make_caches
        self.launches = {p: Counter() for p in ("step", "monitor", "prefill", "decode_step")}
        self.launches_d = {p: Counter() for p in self.launches}
        self.calls = Counter()
        self.chunks, self.cur, self.step_peak, self.caches_made = [], None, 0, False
        bundle.forward = self
        bundle.make_caches = self._make_caches

    def _steps_peak_so_far(self):
        import torch

        self.step_peak = max(self.step_peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def _make_caches(self, *args, **kw):
        """A decode chunk begins: close the open ones, keep the steps' peak so far, reset."""
        for probe in self.group:
            probe._close_chunk()
        self._steps_peak_so_far()
        self.caches_made = True
        return self.inner_caches(*args, **kw)

    @staticmethod
    def _event():
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __call__(self, params, input_ids, attention_mask, pixel_inputs=None, **kw):
        import torch

        from adversarialvlm_tpu_torch.ops.kernels import launch_counts, launch_counts_by_head_dim

        if kw.get("kv_caches") is None:
            phase = "step" if torch.is_grad_enabled() else "monitor"
        else:
            phase = "prefill" if kw["cache_index"] == 0 else "decode_step"
        if phase != "decode_step":
            for probe in self.group:
                probe._close_chunk()
        if phase == "prefill":
            if not self.caches_made:
                self._steps_peak_so_far()
            self.caches_made = False
            self.cur = {"batch": int(input_ids.shape[0]), "T": int(input_ids.shape[1]),
                        "mask": attention_mask.detach().to(torch.int32).clone(), "start": self._event(), "ends": []}
        before, before_d = launch_counts(), launch_counts_by_head_dim()
        out = self.inner(params, input_ids, attention_mask, pixel_inputs, **kw)
        delta = {k: n - before[k] for k, n in launch_counts().items()}
        self.launches[phase].update(delta)
        self.launches_d[phase].update({k: n - before_d.get(k, 0) for k, n in launch_counts_by_head_dim().items()})
        self.calls[phase] += 1
        if self.cur is not None:
            self.cur["ends"].append(self._event())
            if phase == "prefill":
                self.cur["prefill_launches"] = delta
        return out

    def _close_chunk(self):
        import torch

        c, self.cur = self.cur, None
        if c is None or not c["ends"]:  # none open, or its prefill raised
            return
        c["ends"][-1].synchronize()
        c["prefill_ms"] = c["start"].elapsed_time(c["ends"][0])
        c["decode_ms"] = c["start"].elapsed_time(c["ends"][-1])
        c["tokens"] = c["batch"] * len(c["ends"])  # one new token per row per forward
        c["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        self.chunks.append(c)

    def finish(self):
        import torch

        self._close_chunk()
        self.step_peak = max(self.step_peak, torch.cuda.max_memory_allocated())
        self.bundle.forward, self.bundle.make_caches = self.inner, self.inner_caches


def decode_reference(gpu_v, cpu_v, questions, x_img, expect):
    """Teacher-forced check of the cached test decode: the card (bf16, flash prefill, plain
    cached steps) generates; the CPU (f32, plain, uncached) runs one forward over prompt +
    the card's tokens. Per row and step: logits cosine >= TOL_DECODE_COSINE, and the card's
    token scores within DECODE_MARGIN × that row's max |card - CPU| of the CPU's top logit (bf16
    argmax may flip on near-ties under random weights, so exact tokens are not required). The
    bundle's decode extras ride with every forward (Qwen2-VL: each row's rope_delta, which every
    cached step's M-RoPE positions take, while the CPU's uncached forward derives them from the
    token layout, so a wrong delta shows)."""
    import torch

    d = decode_card(gpu_v, questions, x_img, expect)
    with torch.no_grad():
        cpu = cpu_v.bundle.forward(cpu_v.bundle.params, d["seq"], d["mask"], d["pixel"], logits_last_k=d["n"]).double()
    decode_check(d, cpu)


def decode_card(gpu_v, questions, x_img, expect):
    """The card's half of :func:`decode_reference`: the cached decode and its recorded logits, and
    the CPU's inputs (prompt + the card's tokens, their mask, the pixels on the host, the steps)."""
    import torch

    from adversarialvlm_tpu_torch.models.generate import generate_core
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.processors import normalize_pixel_inputs
    from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets

    ai, bundle = gpu_v.adv_inputs, gpu_v.bundle
    inputs = ai.get_inputs_inference_batch(questions)
    ids_np, am_np, _ = pad_to_buckets(inputs["input_ids"], inputs["attention_mask"], ai.pad_token_id)
    ids, am = (torch.as_tensor(a, device=bundle.device) for a in (ids_np, am_np))
    extras = {k: torch.as_tensor(v, device=bundle.device) for k, v in bundle.decode_extras(ids_np, am_np).items()}
    with torch.no_grad():
        pixel = normalize_pixel_inputs(bundle.family, gpu_v.adv_processor.process(
            torch.as_tensor(x_img, device=bundle.device)))
    recorded = []

    def recording_forward(params, input_ids, attention_mask, pixel_inputs=None, **kw):
        logits = bundle.forward(params, input_ids, attention_mask, pixel_inputs, **kw)
        recorded.append(logits[:, -1].float().cpu())
        return logits

    reset_launches()
    tokens = generate_core(
        recording_forward, bundle.make_caches, bundle.params, ids, am, pixel,
        max_new_tokens=REF_DECODE_TOKENS, min_new_tokens=0, eos_token_ids=bundle.eos_token_ids,
        pad_token_id=ai.pad_token_id, cache_dtype=torch.bfloat16, logits_last_k=1, extras=extras,
    ).cpu()
    launches = launch_counts()
    if any(launches[k] != n for k, n in expect.items()):
        raise AssertionError(f"decode reference: expected launches {expect}, got {launches}")
    n = len(recorded)
    return {"card": torch.stack(recorded, dim=1).double(),  # (B, n, V)
            "seq": torch.cat([ids.cpu(), tokens[:, : n - 1]], dim=1),
            "mask": torch.cat([am.cpu(), torch.ones((len(questions), n - 1), dtype=am.dtype)], dim=1),
            "pixel": {k: x.cpu() for k, x in pixel.items()}, "n": n, "tokens": tokens, "ids": ids.cpu(),
            "am_np": am_np, "extras": extras, "launches": launches, "eos": bundle.eos_token_ids}


def decode_inputs(d):
    """The CPU's teacher-forced forward of :func:`decode_card`'s decode: (ids, mask, pixels, n)."""
    return d["seq"], d["mask"], d["pixel"], d["n"]


def decode_check(d, cpu):
    """The comparison of :func:`decode_reference`: the card's recorded logits and tokens ``d``
    against the CPU's teacher-forced logits ``cpu`` (B, n, V)."""
    import torch

    card, tokens, n, ids, am_np, extras = d["card"], d["tokens"], d["n"], d["ids"], d["am_np"], d["extras"]
    cos = torch.nn.functional.cosine_similarity(card, cpu, dim=-1)  # (B, n)
    diff = (card - cpu).abs().amax(-1)
    chosen = cpu.gather(-1, tokens[:, :n, None]).squeeze(-1)
    gap = cpu.amax(-1) - chosen
    finished_before = torch.zeros_like(tokens[:, :n], dtype=torch.bool)
    is_eos = torch.isin(tokens[:, :n], torch.tensor(d["eos"]))
    finished_before[:, 1:] = torch.cumsum(is_eos, dim=1)[:, :-1] > 0
    ok_tok = (gap <= DECODE_MARGIN * diff) | finished_before
    log("reference", f"decode: {card.shape[0]} rows, T={ids.shape[1]} left pads="
        f"{[int(ids.shape[1] - m) for m in am_np.sum(1)]}, {n} tokens, extras "
        f"{ {k: v.tolist() for k, v in extras.items()} }, launches={d['launches']}; "
        f"min logits cosine={float(cos.min()):.6f} (min {TOL_DECODE_COSINE}); worst token gap / "
        f"max|card-CPU|={float((gap / diff).max()):.3f} (max {DECODE_MARGIN}); exact tokens "
        f"{int((cpu.argmax(-1) == tokens[:, :n]).sum())}/{tokens[:, :n].numel()}")
    if not (float(cos.min()) >= TOL_DECODE_COSINE and bool(ok_tok.all())):
        raise AssertionError("decode reference: the card's cached decode and the CPU disagree")
    return float(cos.min())


CPU_REF_THREADS = 4       # the CPU references' worker: intra-op threads, of the host's 8 cores


class CpuReferences:
    """The CPU halves of the depth-cut references (5, 5c, 5X, 4XV's, 5V, 5H and 5M: the same cut model in
    f32 on the plain path), run in one spawned worker process with its own thread count, beside
    the card's next phases. A phase runs its card half, writes the CPU half's inputs to a file
    (:func:`reference_victim`: the cut weights in the card's dtype, which the worker casts to f32)
    and submits it with the check that compares the two; :meth:`join` waits for each result and
    runs its check, so a disagreement fails the script there, before phase 4T. The worker runs at a
    lower priority, so the host-paced card phases keep the cores they need."""

    def __init__(self, root, threads=CPU_REF_THREADS):
        import concurrent.futures
        import multiprocessing

        self.root, self.jobs = root, []
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"), initializer=_cpu_worker_init, initargs=(threads,))

    def submit(self, tag, job, check):
        import torch

        path = os.path.join(self.root, f"cpu_reference_{len(self.jobs)}.pt")
        torch.save(job, path)
        self.jobs.append((tag, self.pool.submit(cpu_reference, path, tag), check))
        log("reference", f"{tag}: the CPU half submitted to the worker")

    def join(self):
        """Wait for every CPU half submitted so far and run its check; the worker stays for later ones."""
        import torch

        t0 = time.perf_counter()
        jobs, self.jobs = self.jobs, []
        for tag, fut, check in jobs:
            out = fut.result()
            check(torch.load(out, weights_only=False))
            os.remove(out)
        log("reference", f"{len(jobs)} CPU references joined, {time.perf_counter() - t0:.1f} s waited")


def _cpu_worker_init(threads):
    """The worker's own thread count, and a lower priority than the script's host-paced card phases."""
    import torch

    torch.set_num_threads(threads)
    os.nice(10)


def reference_victim(family, cut, params, grid, ai):
    """What the worker needs of a depth-cut victim: its family and config, the cut weights on the
    host (in the card's dtype), its static grid and its handles' prompt and target pools."""
    return {"family": family, "cut": cut, "params": _map(params, lambda t: t.cpu()), "grid": grid,
            "arrays": {"prompt_pool": ai.prompt_pool, "prompt_lengths": ai.prompt_lengths,
                       "target_pool": ai.target_pool, "target_mask_pool": ai.target_mask_pool,
                       "suffix_lengths": ai.suffix_lengths, "shift": ai.shift, "pad_token_id": ai.pad_token_id}}


def cpu_reference(path, tag):
    """The worker's side: the job in ``path`` (victims of :func:`reference_victim`, x₀ and p₀;
    ``steps``, each (label, draws, its AttackConfig, model weights or None); ``forwards``, each
    name -> (ids, mask, pixels or None, n), the first victim's forward over those tokens, as the
    teacher-forced decode's and a text-only prefill's), run in f32 on the CPU's plain path.
    Writes each step's [loss, (loss_i...)] and gradient, and each forward's last n logits, beside
    the job and returns that file's path."""
    import functools

    import torch

    from adversarialvlm_tpu_torch.attack.setup import image_processor
    from adversarialvlm_tpu_torch.attack.step import VictimHandles, build_attack_step
    from adversarialvlm_tpu_torch.models.registry import make_bundle

    t0 = time.perf_counter()
    job = torch.load(path, weights_only=False)
    os.remove(path)
    cpu = torch.device("cpu")
    bundles, handles = [], []
    for vs in job["victims"]:
        bundle = make_bundle("cut", vs["family"], vs["cut"], cpu, params=_map(vs["params"], lambda t: t.float()),
                             grid_hw=vs["grid"])
        proc = image_processor(vs["cut"], (512, 512), "cpu")
        a = vs["arrays"]
        handles.append(VictimHandles(
            name="cut", forward=bundle.forward, params=bundle.params,
            process=functools.partial(_normalized, vs["family"], proc), prompt_pool=a["prompt_pool"],
            prompt_lengths=a["prompt_lengths"], target_pool=torch.as_tensor(a["target_pool"]),
            target_mask_pool=torch.as_tensor(a["target_mask_pool"]),
            suffix_lengths=torch.as_tensor(a["suffix_lengths"]), shift=a["shift"], pad_token_id=a["pad_token_id"],
            device=cpu))
        bundles.append(bundle)
    x0 = torch.as_tensor(job["x0"])
    out = {"steps": {}, "forwards": {}}
    for label, xs, step_cfg, weights in job["steps"]:
        step = build_attack_step(handles, step_cfg, x0, torch.ones_like(x0),
                                 model_weights=list(weights) if weights else None, cross=weights is not None)
        loss, img_loss, ces, _, grad = step.loss_and_grad(job["p0"], xs, torch.tensor(step_cfg.sigma))
        extra = [float(w * ce + img_loss) for w, ce in zip(weights, ces)] if weights else []
        out["steps"][label] = ([float(loss), *extra], grad.double())
    for name, (seq, mask, pixel, n) in job.get("forwards", {}).items():
        with torch.no_grad():
            out["forwards"][name] = bundles[0].forward(bundles[0].params, seq, mask, pixel, logits_last_k=n).double()
    torch.save(out, path + ".out")
    log("reference", f"{tag}: the CPU half in the worker in {time.perf_counter() - t0:.1f} s")
    return path + ".out"


def _normalized(family, proc, img):
    from adversarialvlm_tpu_torch.processors import normalize_pixel_inputs

    return normalize_pixel_inputs(family, proc.process(img))


def check_step_reference(tag, card, cpu, reference):
    """A depth-cut step's card results ``card`` ([loss, ...], gradient) against the CPU's: every
    loss within TOL_REF_LOSS relative, the gradient at cosine >= TOL_REF_COSINE; the verdict goes
    into ``reference``."""
    (l_gpu, g_gpu), (l_cpu, g_cpu) = card, cpu
    rel = [abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu)]
    cos = float((g_cpu * g_gpu).sum() / (g_cpu.norm() * g_gpu.norm()))
    log("reference", f"{tag}: losses card {l_gpu} cpu {l_cpu}, rel diff={[f'{r:.3g}' for r in rel]} (tol "
        f"{TOL_REF_LOSS}) grad cosine={cos:.6f} (min {TOL_REF_COSINE}) grad norm ratio="
        f"{float(g_gpu.norm() / g_cpu.norm()):.4f}")
    if not (max(rel) <= TOL_REF_LOSS and cos >= TOL_REF_COSINE):
        raise AssertionError(f"{tag} depth-cut reference: card and CPU disagree")
    reference.update({"loss_rel": rel if len(rel) > 1 else rel[0], "cosine": cos})


def card_step_references(family, gpu_v, cut, grid, cfg, x0, p0, labels, noise, decode_expect):
    """A single-victim depth-cut reference (5V, 5H, 5M): the card's half now (each (label, rows)
    step of ``labels`` from p₀ with ``noise``, then the teacher-forced test decode of three
    held-out questions), the CPU's submitted to the worker. Returns the verdicts' dict, which
    :meth:`CpuReferences.join` fills."""
    import dataclasses

    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.step import build_attack_step
    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    ai = gpu_v.adv_inputs
    card, steps, reference = {}, [], {}
    x0_d = torch.as_tensor(x0, device="cuda")
    for label, row_idx in labels:
        xs = {"t_idx": 0, "rows": [torch.from_numpy(ai.prompt_pool[0, row_idx])],
              "lens": [torch.from_numpy(ai.prompt_lengths[0, row_idx])], "noise": [noise[: len(row_idx)]]}
        step = build_attack_step([gpu_v.handles()], dataclasses.replace(cfg, batch_size=len(row_idx)), x0_d,
                                 torch.ones_like(x0_d))
        reset_launches()
        t1 = time.perf_counter()
        loss, _, _, _, grad = step.loss_and_grad(p0.cuda(), xs, torch.tensor(cfg.sigma, device="cuda"))
        card[label] = ([float(loss)], grad.double().cpu())
        log("reference", f"{family} {label} cuda: loss={float(loss)} grad_norm={float(grad.norm())} T={ai.max_len} "
            f"in {time.perf_counter() - t1:.1f} s, launches={ {k: n for k, n in launch_counts().items() if n} }")
        steps.append((label, xs, dataclasses.replace(cfg, batch_size=len(row_idx)), None))
        reference[label] = {}
    x_img = np.clip(x0 + cfg.epsilon * np.tanh(p0.numpy()), 0.0, 1.0).astype(np.float32)
    d = decode_card(gpu_v, list(corpora.not_safe_questions_test[:3]), x_img, decode_expect)

    def check(out):
        for label in card:
            check_step_reference(f"{family} {label}", card[label], out["steps"][label], reference[label])
        reference["decode_cosine"] = decode_check(d, out["forwards"]["decode"])

    REFS.submit(f"{family} depth cut", {"victims": [reference_victim(family, cut, gpu_v.bundle.params, grid, ai)],
                                         "x0": x0, "p0": p0, "steps": steps,
                                         "forwards": {"decode": decode_inputs(d)}}, check)
    return reference


def transform_path(victim, x0, dgrad_per_step, n_layers, plain_med, plain_peak):
    """Phase 4t: train() at batch 1 with the paper's blur (5, σ 7), the local crop at its default
    scale and ratio, and a 256² random square mask moved every step, with the test decode at the
    save boundaries, counted from zero. The transforms add no kernel: per step the same 364 dgrad
    and 32 of each batch-1 attention kernel as the plain step. The saved image must be x₀ plus the
    blurred perturbation of the final p."""
    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack import engine
    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.ops.blur import gaussian_blur
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    cfg = AttackConfig(exp_name="chip_smoke_blur_crop", num_iterations=STEPS_T, save_steps=10,
                       batch_size=1, grad_accum_steps=1, lr=1e-2, target_text_random=False,
                       use_gaussian_blur=True, gblur_kernel_size=5, gblur_sigma=7.0,
                       use_local_crop=True, mask_type="random_square", mask_size=256,
                       mask_refresh_random_square=True)
    seen, real_init = {}, engine.init_state
    with tempfile.TemporaryDirectory() as runs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the path's peak counts its own blocks, not an earlier phase's leftovers
        torch.cuda.reset_peak_memory_stats()
        probe = PathProbe(victim.bundle)
        engine.init_state = lambda c, x: seen.setdefault("state", real_init(c, x))
        reset_launches()
        t0 = time.perf_counter()
        try:
            exp = engine.train(cfg, [victim], x0, base_path=runs, device="cuda", run_tests=True,
                               test_max_new_tokens=DECODE_TOKENS)
            torch.cuda.synchronize()
        finally:
            engine.init_state = real_init
            probe.finish()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        files = sorted(os.listdir(exp))
        saved = np.fromfile(os.path.join(exp, "optimized_image_iter_final.bin"), np.float32).reshape(x0.shape)
        mask = torch.load(os.path.join(exp, "mask.pt"))
    steps = [r for r in rows if "loss" in r]
    for r in steps:
        log("transforms", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} "
            f"adversarial_std={r['adversarial_std']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    log("transforms", f"blur (5, 7.0) + crop (0.6-1.0, 0.75-1.33) + moving 256² square, batch 1: median "
        f"step_ms (steps 1..{STEPS_T - 1})={med:.2f} warm-up step_ms={steps[0]['step_ms']:.2f} steps' "
        f"peak_memory_GiB={probe.step_peak / 2**30:.3f} train wall_s={wall:.1f}; the plain batch-1 path "
        f"of this call: median step_ms={plain_med:.2f} peak_memory_GiB={plain_peak:.3f}")
    if len(steps) != STEPS_T or not all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps):
        raise AssertionError(f"transform path: bad steps {[(r.get('loss'), r.get('grad_norm')) for r in steps]}")
    for need in ("mask.pt", "optimized_image_iter_final.png", "test_results_iter_0.csv",
                 f"test_results_iter_{STEPS_T - 1}.csv"):
        if need not in files:
            raise AssertionError(f"transform path: {need} missing from {files}")
    if float(mask.sum()) != 3 * 256 * 256:
        raise AssertionError("transform path: the saved mask is not one 256² square")
    x = gaussian_blur(0.5 * torch.tanh(seen["state"]["p"].detach()), 5, 7.0)
    blur_err = float(np.abs(saved - (x0 + x.cpu().numpy())).max())
    raw_err = float(np.abs(saved - (x0 + 0.5 * torch.tanh(seen["state"]["p"].detach()).cpu().numpy())).max())
    log("transforms", f"saved image against x0 + blur(0.5 tanh p): max |diff|={blur_err:.3g}; against the "
        f"unblurred x0 + 0.5 tanh p: {raw_err:.3g}")
    if not (blur_err <= 1e-6 < raw_err):
        raise AssertionError("transform path: the saved image is not the blurred one")
    bwd = {k: launches[k] - sum(probe.launches[p][k] for p in probe.launches) for k in launches}
    per_step = {
        "dgrad": bwd["dgrad"] / STEPS_T,
        "attention_fwd": probe.launches["step"]["attention_fwd"] / STEPS_T,
        "attention_bwd_dq": bwd["attention_bwd_dq"] / STEPS_T,
        "attention_bwd_dkdv": bwd["attention_bwd_dkdv"] / STEPS_T,
    }
    expected = {"dgrad": dgrad_per_step, "attention_fwd": n_layers, "attention_bwd_dq": n_layers,
                "attention_bwd_dkdv": n_layers}
    log("transforms", f"launches over the run: {launches}; by phase: "
        + "; ".join(f"{p} x{probe.calls[p]} {dict(+c)}" for p, c in probe.launches.items())
        + f"; per step: {per_step} (expected {expected}; the decode prefill pads its rows to a "
        "batch and takes the flash kernel)")
    # the steps and their backward launch nothing else
    others = {k: n for k, n in launches.items()
              if k not in expected and n - sum(probe.launches[p][k] for p in ("monitor", "prefill", "decode_step"))}
    if per_step != expected or others:
        raise AssertionError(f"transform path launches {per_step} != {expected} (others: {others})")
    return {"median_ms": med, "peak_GiB": probe.step_peak / 2**30}


def depth_cut(params, n_text, n_vision):
    """The tree of the first ``n_text`` decoder and ``n_vision`` tower layers (tensors shared):
    the ``vision_tower`` layers of LLaVA and Gemma-3, Qwen2-VL's ``visual`` blocks or Phi-3.5's
    ``img_processor`` layers."""
    lm = params["language_model"]
    out = {**params, "language_model": {**lm, "layers": lm["layers"][:n_text]}}
    if "visual" in params:
        out["visual"] = {**params["visual"], "blocks": params["visual"]["blocks"][:n_vision]}
    elif "img_processor" in params:
        out["img_processor"] = {**params["img_processor"], "layers": params["img_processor"]["layers"][:n_vision]}
    else:
        vt = params["vision_tower"]
        out["vision_tower"] = {**vt, "layers": vt["layers"][:n_vision]}
    return out


def checkpoint_victim(model, cfg, root, **prompts):
    """Phases 4L and 4G: the seed-0 random parameters of ``model`` at full width and depth, drawn
    on the card, are written by the port's fabricator (cli/fabricate_ckpt.py) as an HF checkpoint
    directory under ``root`` (in the git-ignored adversarialvlm_tpu_torch/build/); the victim is
    then built the CLI's way, resolve_checkpoint -> build_victim_from_checkpoint, with the HF
    name. Every loaded tensor must equal the written one (norms come back in f32, the rest in
    bf16) and the patched VLMConfig the model's own. The directory stays for the cross phases,
    which load both victims from ``root`` through the cross CLI. Returns the victim and the write
    and load numbers."""
    import torch

    from adversarialvlm_tpu_torch.attack.setup import build_victim_from_checkpoint
    from adversarialvlm_tpu_torch.cli.attack_model import resolve_checkpoint
    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import MODELS, fabricate
    from adversarialvlm_tpu_torch.models.loading import named_leaves
    from adversarialvlm_tpu_torch.models.registry import _MODELS
    from adversarialvlm_tpu_torch.processors import family_of

    hf_name, make_cfg, dtype = MODELS[model]
    family, vlm_cfg = family_of(hf_name), make_cfg()
    tag = f"load {family}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    written = _MODELS[family].init_params(torch.Generator(device="cuda").manual_seed(0), vlm_cfg, dtype, "cuda")
    n_params = sum(t.numel() for t in _leaves(written))
    log(tag, f"{n_params / 1e9:.3f} B seed-0 parameters drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"free disk under {root}: {shutil.disk_usage(root).free / 1e9:.1f} GB")
    t0 = time.perf_counter()
    out = fabricate(model, root, params=written)
    write_s = time.perf_counter() - t0
    shards = sorted(f for f in os.listdir(out) if f.endswith(".safetensors"))
    nbytes = sum(os.path.getsize(os.path.join(out, f)) for f in shards)
    log(tag, f"wrote {out} in {write_s:.1f} s: {len(shards)} shards, {nbytes / 1e9:.3f} GB "
        f"({nbytes / 1e9 / write_s:.2f} GB/s), files {sorted(os.listdir(out))}")
    path = resolve_checkpoint(hf_name, root)
    t0 = time.perf_counter()
    victim = build_victim_from_checkpoint(hf_name, path, cfg, (512, 512), dtype=dtype,
                                          device="cuda", **prompts)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got, want = dict(named_leaves(victim.bundle.params)), dict(named_leaves(written))
    if set(got) != set(want):
        raise AssertionError(f"{tag}: loaded keys differ: missing {sorted(set(want) - set(got))[:5]}, "
                             f"extra {sorted(set(got) - set(want))[:5]}")
    unequal = [k for k in want if not torch.equal(got[k], want[k].to(got[k].dtype))]
    f32 = sorted({k.split(".")[-2] for k in got if got[k].dtype == torch.float32})
    if unequal or victim.bundle.cfg != vlm_cfg:
        raise AssertionError(f"{tag}: loaded tensors {unequal[:5]} differ from the written ones, or "
                             f"the patched config differs: {victim.bundle.cfg != vlm_cfg}")
    peak, n_tensors = torch.cuda.max_memory_allocated() / 2**30, len(got)
    del written, got, want
    gc.collect()
    torch.cuda.empty_cache()
    tok = victim.adv_inputs.tokenizer
    log(tag, f"loaded {hf_name} through resolve_checkpoint -> build_victim_from_checkpoint in {load_s:.1f} s "
        f"({nbytes / 1e9 / load_s:.2f} GB/s): {n_tensors} tensors, each equal to the written one (f32: "
        f"{f32}), VLMConfig equal to {model}'s; tokenizer {type(tok).__name__} of {tok.vocab_size} tokens; "
        f"peak {peak:.3f} GiB; {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return victim, {"GB": nbytes / 1e9, "write_s": write_s, "load_s": load_s, "peak_GiB": peak,
                    "tensors": n_tensors}


REMAT_POLICIES = ("none", "dgrad", "dgrad_lean", "gate")  # phase 4Z
REMAT_REPS = 3            # phase 4Z: timed steps a policy, after a warm-up and the counted one


def remat_phase(victim, x0, cfg, dgrad_per_step):
    """Phase 4Z: ``--remat_policy`` on the resident LLaVA-1.5-7B at batch 4 (its weights shared, the
    policy set on the decoder's config as the CLIs set it): one step (the loss and its image
    gradient) under each of REMAT_POLICIES on the same draws and p₀, its peak from an emptied cache
    and its ms (median of REMAT_REPS, CUDA events); each policy's loss within TOL_REF_LOSS relative
    of ``none``'s and its gradient at cosine >= TOL_REF_COSINE; a named policy recomputes each
    decoder layer in the backward, so its step launches the flash forward twice a layer and the
    backward kernels and dgrad as ``none`` does."""
    import dataclasses

    import torch

    from adversarialvlm_tpu_torch.attack.engine import VictimSetup
    from adversarialvlm_tpu_torch.attack.step import build_attack_step, sample_chunk_xs
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.processors import normalize_pixel_inputs

    t_phase = time.perf_counter()
    b, n_layers = victim.bundle, victim.bundle.cfg.text.num_layers
    x0_d = torch.as_tensor(x0, device="cuda")
    xs = sample_chunk_xs(torch.Generator().manual_seed(cfg.seed), 1, cfg, [victim.handles()])[0]
    with torch.no_grad():
        pv = normalize_pixel_inputs(b.family, victim.adv_processor.process(x0_d))["pixel_values"]
    xs["noise"] = [torch.randn((cfg.batch_size, *pv.shape[1:]), generator=torch.Generator().manual_seed(11))]
    p0 = (0.3 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(12))).cuda()
    sigma = torch.tensor(cfg.sigma, device="cuda")
    out, ref = {}, None
    for policy in REMAT_POLICIES:
        cfg_p = dataclasses.replace(b.cfg, text=dataclasses.replace(b.cfg.text, remat_policy=policy))
        v = VictimSetup(b.name, make_bundle(b.name, b.family, cfg_p, b.device, params=b.params),
                        victim.adv_processor, victim.adv_inputs, victim.compute_dtype)
        step = build_attack_step([v.handles()], cfg, x0_d, torch.ones_like(x0_d))
        step.loss_and_grad(p0, xs, sigma)  # warm-up
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        loss, _, _, _, grad = step.loss_and_grad(p0, xs, sigma)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: n for k, n in launch_counts().items() if n}
        loss, grad = float(loss), grad.double().cpu()
        ms = []
        for _ in range(REMAT_REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            step.loss_and_grad(p0, xs, sigma)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        if ref is None:
            ref = (loss, grad)
        rel = abs(loss - ref[0]) / abs(ref[0])
        cos = float((grad * ref[1]).sum() / (grad.norm() * ref[1].norm()))
        want = {"dgrad": dgrad_per_step, "flash_fwd": n_layers * (1 if policy == "none" else 2),
                "flash_bwd_dq": n_layers, "flash_bwd_dkdv": n_layers}
        out[policy] = {"ms": statistics.median(ms), "peak_GiB": peak / 2**30,
                       "above_resident_GiB": (peak - resident) / 2**30, "loss": loss, "loss_rel": rel, "cosine": cos,
                       "bitwise": bool(loss == ref[0] and torch.equal(grad, ref[1])), "launches": launches}
        log("remat", f"--remat_policy {policy}: batch {cfg.batch_size} step ms {[round(x, 2) for x in ms]} (median "
            f"{out[policy]['ms']:.2f}); peak {peak / 2**30:.3f} GiB, {(peak - resident) / 2**30:.3f} above the "
            f"{resident / 2**30:.3f} resident; loss {loss} (rel {rel:.3g} to none's), gradient cosine {cos:.6f}, bit for "
            f"bit none's: {out[policy]['bitwise']}; launches {launches} (expected {want})")
        if rel > TOL_REF_LOSS or cos < TOL_REF_COSINE or launches != want:
            raise AssertionError(f"remat {policy}: differs from none's step or launched {launches}")
        del v, step, grad
        gc.collect()
        torch.cuda.empty_cache()
    log("remat", f"phase 4Z in {time.perf_counter() - t_phase:.1f} s")
    return out


def resume_phase(victim, x0, dgrad_per_step, n_layers):
    """Phase 4R: true resume and the profiler on the loaded victim at batch 1, with the blur, the
    local crop, the moving square and transform_prob 0.5, so that every generator of the run is
    drawn from (questions, noise, crop boxes, coins, square positions). An uninterrupted run of
    RESUME_STEPS steps, a run of RESUME_CUT steps, and a run resumed from the state the latter
    saved at iteration RESUME_CUT - 1 (attack_state_iter_<RESUME_CUT>.pt: files are numbered by
    optimizer steps, as the PNGs) to RESUME_STEPS with --profile_dir set. The resumed run's
    metrics.jsonl rows (all but step_ms) and final image must equal the uninterrupted run's, and
    its trace must name the dgrad and causal kernels."""
    import dataclasses

    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import train
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    cfg = AttackConfig(exp_name="straight", num_iterations=RESUME_STEPS, save_steps=2, batch_size=1,
                       grad_accum_steps=1, lr=1e-2, target_text_random=False,
                       use_gaussian_blur=True, gblur_kernel_size=5, gblur_sigma=7.0,
                       use_local_crop=True, transform_prob=0.5, mask_type="random_square",
                       mask_size=256, mask_refresh_random_square=True)

    def rows(exp):
        out = []
        for line in open(os.path.join(exp, "metrics.jsonl")):
            r = json.loads(line)
            r.pop("step_ms", None)
            if "_config" not in r:
                out.append(r)
        return out

    with tempfile.TemporaryDirectory() as runs:
        t0 = time.perf_counter()
        straight = train(cfg, [victim], x0, base_path=runs, device="cuda", run_tests=False)
        part1 = train(dataclasses.replace(cfg, exp_name="part1", num_iterations=RESUME_CUT), [victim], x0,
                      base_path=runs, device="cuda", run_tests=False)
        state = os.path.join(part1, f"attack_state_iter_{RESUME_CUT}.pt")
        prof_dir = os.path.join(runs, "profile")
        reset_launches()
        t1 = time.perf_counter()
        part2 = train(dataclasses.replace(cfg, exp_name="part2", resume_state=state, profile_dir=prof_dir),
                      [victim], x0, base_path=runs, device="cuda", run_tests=False)
        torch.cuda.synchronize()
        resumed_s, launches = time.perf_counter() - t1, launch_counts()
        want = [r for r in rows(straight) if r["iteration"] >= RESUME_CUT]
        got = rows(part2)
        final = [np.fromfile(os.path.join(e, "optimized_image_iter_final.bin"), np.float32)
                 for e in (straight, part2)]
        traces = sorted(os.listdir(prof_dir))
        trace_text = open(os.path.join(prof_dir, traces[0])).read() if traces else ""
        trace_mb = os.path.getsize(os.path.join(prof_dir, traces[0])) / 1e6 if traces else 0.0
        log("resume", f"uninterrupted {RESUME_STEPS} steps, {RESUME_CUT} steps, then resumed from "
            f"{os.path.basename(state)} to {RESUME_STEPS} in {time.perf_counter() - t0:.1f} s (the resumed "
            f"run {resumed_s:.1f} s, its launches {dict((k, n) for k, n in launches.items() if n)}); "
            f"{sorted(os.listdir(part1))}")
    steps = [r for r in got if "loss" in r]
    for r in steps:
        log("resume", f"resumed step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']}")
    per_step = {k: launches[k] / len(steps) for k in ("dgrad", "attention_bwd_dq", "attention_bwd_dkdv")}
    if per_step != {"dgrad": dgrad_per_step, "attention_bwd_dq": n_layers, "attention_bwd_dkdv": n_layers}:
        raise AssertionError(f"resumed run: backward launches per step {per_step}")
    if [r["iteration"] for r in steps] != list(range(RESUME_CUT, RESUME_STEPS)):
        raise AssertionError(f"resumed run: iterations {[r['iteration'] for r in steps]}")
    equal = got == want and np.array_equal(final[0], final[1])
    if equal:
        verdict = (f"equal: {len(got)} metrics.jsonl rows (steps {RESUME_CUT}-{RESUME_STEPS - 1}, monitors, "
                   f"checkpoints) and the final image bit for bit")
    else:
        diff = sorted({k for a, b in zip(got, want) for k in set(a) | set(b) if a.get(k) != b.get(k)})
        a, b = final
        cos = float(np.dot(a - x0.ravel(), b - x0.ravel()) /
                    (np.linalg.norm(a - x0.ravel()) * np.linalg.norm(b - x0.ravel())))
        loss_rel = max(abs(r["loss"] - w["loss"]) / abs(w["loss"])
                       for r, w in zip(steps, [w for w in want if "loss" in w]))
        verdict = (f"NOT equal (fields {diff}): held to loss within 1e-3 relative per step ({loss_rel:.3g}) "
                   f"and perturbation cosine >= 0.9999 ({cos:.6f})")
        if len(got) != len(want) or not (loss_rel <= 1e-3 and cos >= 0.9999):
            raise AssertionError(f"resume: {verdict}")
    log("resume", verdict)
    names = ("dgrad_kernel", "causal_fwd_kernel", "causal_dq_kernel", "causal_dkdv_kernel")
    found = {n: trace_text.count(n) for n in names}
    log("resume", f"trace {traces} ({trace_mb:.1f} MB): occurrences of the kernels' symbols {found}")
    if len(traces) != 1 or not all(found.values()):
        raise AssertionError(f"resume: the profiler trace does not name the port's kernels: {found}")
    return {"verdict": verdict, "equal": equal, "trace_MB": trace_mb, "kernel_mentions": found}


BENCH_WINDOWS = 3          # phase B: cli/bench.py's timed windows (its default is 5)


def bench_phase():
    """Phase B: cli/bench.py at its defaults (its own random-weight LLaVA-1.5-7B) but for its timed
    windows, BENCH_WINDOWS of them; its JSON line is printed as it prints it."""
    from adversarialvlm_tpu_torch.cli import bench

    t0 = time.perf_counter()
    default_windows, bench.BENCH_WINDOWS = bench.BENCH_WINDOWS, BENCH_WINDOWS
    try:
        result = bench.main([])
    finally:
        bench.BENCH_WINDOWS = default_windows
    sys.stdout.flush()
    log("bench", f"cli/bench.py in {time.perf_counter() - t0:.1f} s: {result}")
    if not (result["metric"] == "attack_steps_per_sec_llava7b" and result["value"] > 0
            and result["mfu"] is not None):
        raise AssertionError(f"bench: {result}")
    return result


def llava_phases(ckpt_root):
    """Phases 3 (the LLaVA shapes), 4, 4b and 5 on the LLaVA-1.5-7B victim; returns the kernel
    statistics and launch counts of the JSON line. Its tensors are freed on return."""
    import dataclasses

    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import VictimSetup, train
    from adversarialvlm_tpu_torch.attack.setup import questions_and_targets
    from adversarialvlm_tpu_torch.attack.step import build_attack_step, sample_chunk_xs
    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.eval.generation import _pick_decode
    from adversarialvlm_tpu_torch.models.configs import llava_1_5_7b
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.crop import sample_crop_box
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.ops.masks import random_square_mask, square_position
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs
    from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets

    # the main-path victim: its prompts fix the kernels' shapes. The batch-4 path shares its
    # weights and runs the attack's default prompt pool.
    vlm_cfg = llava_1_5_7b()
    t = vlm_cfg.text
    cfg = AttackConfig(exp_name="chip_smoke", num_iterations=STEPS, save_steps=10, batch_size=1,
                       grad_accum_steps=1, lr=1e-2, target_text_random=False)
    cfg4 = AttackConfig(exp_name="chip_smoke_b4", num_iterations=STEPS4, save_steps=10,
                        batch_size=4, grad_accum_steps=1, lr=1e-2)
    # 4L. the victim, loaded from the directory the port's fabricator writes
    victim, load_stats = checkpoint_victim("llava-1.5-7b", cfg, ckpt_root, questions=[QUESTION], targets=[TARGET],
                                           test_questions=[QUESTION])
    t_text = int(victim.adv_inputs.max_len)
    pad = t_text - int(victim.adv_inputs.prompt_lengths[0, 0])
    log("main", f"victim from its checkpoint directory: T={t_text} (the fabricated tokenizer's), "
        f"pad={pad}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    ai1 = victim.adv_inputs
    questions4, targets4 = questions_and_targets(cfg4)
    ai4 = AdvInputs(ai1.spec, ai1.tokenizer, questions4, corpora.not_safe_questions_test,
                    cfg4.batch_size, targets4, ai1.num_image_tokens, ai1.image_token_id,
                    ai1.pad_token_id)
    victim4 = VictimSetup(victim.name, victim.bundle, victim.adv_processor, ai4, torch.bfloat16)
    xs4 = sample_chunk_xs(torch.Generator().manual_seed(cfg4.seed), 1, cfg4, [victim4.handles()])[0]
    t4 = int(ai4.max_len)
    seg4 = (torch.arange(t4)[None, :] >= t4 - xs4["lens"][0][:, None]).to(torch.int32).cuda()
    test_qs = ai4.test_questions
    decode_bs, _ = _pick_decode(victim4.bundle, ai4, test_qs, DECODE_TOKENS, 50, torch.bfloat16)
    probe_in = ai4.get_inputs_inference_batch(test_qs[:decode_bs])
    _, am_prefill, _ = pad_to_buckets(probe_in["input_ids"], probe_in["attention_mask"],
                                      ai4.pad_token_id, batch_to=decode_bs)
    seg_prefill = torch.as_tensor(am_prefill, dtype=torch.int32, device="cuda")
    log("main", f"batch-4 path: prompt pool {len(questions4)} questions x {len(targets4)} targets, "
        f"T={t4}; first step's rows have lengths {xs4['lens'][0].tolist()}; test decode at batch "
        f"{decode_bs} (pick_decode_config), prefill T={am_prefill.shape[1]}")

    # 3. kernels against their plain versions
    dg = check_dgrad(llava_dgrad_cases(victim.bundle.params, vlm_cfg, t_text))
    dg4 = check_dgrad(llava_dgrad_cases(victim.bundle.params, vlm_cfg, t4, batch=4), "dgrad llava batch 4")
    attn = attention_case(t_text, t.num_heads, t.num_kv_heads, t.head_dim_, pad, timed=True)
    attention_case(t_text, t.num_heads, t.num_kv_heads, t.head_dim_, 53)
    attention_case(301, 8, 2, 128, 37)
    attention_case(200, 4, 1, 256, 64)
    flash = flash_case("batch-4 step", seg4, t.num_heads, t.num_kv_heads, t.head_dim_, timed=True)
    prefill = flash_case("test-decode prefill", seg_prefill, t.num_heads, t.num_kv_heads,
                         t.head_dim_, timed=True, backward=False)["flash_fwd"]
    seg_gqa = torch.ones((3, 301), dtype=torch.int32, device="cuda")
    seg_gqa[0, :37], seg_gqa[2, :120] = 0, 0
    flash_case("GQA", seg_gqa, 8, 2, 128)
    flash_case("D=256", seg_gqa[:, :200].contiguous(), 4, 1, 256)  # head_dim 256, timed in judge_cases
    torch.cuda.empty_cache()

    # 4. the batch-1 path, counted from zero
    x0 = np.full((3, 512, 512), 0.47, np.float32)
    pr3_kernels = ("dgrad", "attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv")
    with tempfile.TemporaryDirectory() as runs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the path's peak counts its own blocks, not an earlier phase's leftovers
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        exp = train(cfg, [victim], x0, base_path=runs, device="cuda", run_tests=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        artifacts = sorted(os.listdir(exp))
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    steps = [r for r in rows if "loss" in r]
    monitors = [r for r in rows if "loss_resaved" in r]
    for r in steps:
        log("main", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    log("main", f"T={t_text} median step_ms (steps 1..{STEPS - 1})={med:.2f} warm-up step_ms="
        f"{steps[0]['step_ms']:.2f} peak_memory_GiB={peak:.3f} train wall_s={wall:.1f}")
    if len(steps) != STEPS or not all(np.isfinite(r["loss"]) for r in steps):
        raise AssertionError(f"main path: non-finite or missing losses {[r.get('loss') for r in steps]}")
    if not all(r["grad_norm"] > 0 for r in steps):
        raise AssertionError("main path: zero image gradient")
    for need in ("config.json", "mask.png", "mask.pt", "metrics.jsonl", "optimized_image_iter_final.png"):
        if need not in artifacts:
            raise AssertionError(f"main path: {need} missing from {artifacts}")
    # the resaved-loss monitor adds one forward (attention_fwd only) per boundary
    per_step = {
        "dgrad": launches["dgrad"] / STEPS,
        "attention_fwd": (launches["attention_fwd"] - len(monitors) * t.num_layers) / STEPS,
        "attention_bwd_dq": launches["attention_bwd_dq"] / STEPS,
        "attention_bwd_dkdv": launches["attention_bwd_dkdv"] / STEPS,
    }
    expected = {"dgrad": dg["per_step"], "attention_fwd": t.num_layers,
                "attention_bwd_dq": t.num_layers, "attention_bwd_dkdv": t.num_layers}
    log("main", f"launches over {STEPS} steps and {len(monitors)} resaved-loss monitor forwards: {launches}")
    log("main", f"launches per step: {per_step} (expected {expected})")
    if any(launches[n] == 0 for n in pr3_kernels) or per_step != expected:
        raise AssertionError(f"main path launches {per_step} != expected {expected}")
    if any(launches[n] for n in launches if n not in pr3_kernels):
        raise AssertionError(f"batch-1 path launched a kernel outside its path: {launches}")

    # 4t. the batch-1 path with the blur, the local crop and a random square moved every step
    transforms = transform_path(victim, x0, dg["per_step"], t.num_layers, med, peak)

    # 4b. the batch-4 path with the test decode, counted from zero
    with tempfile.TemporaryDirectory() as runs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the path's peak counts its own blocks, not an earlier phase's leftovers
        torch.cuda.reset_peak_memory_stats()
        probe = PathProbe(victim4.bundle)
        reset_launches()
        t0 = time.perf_counter()
        try:
            exp = train(cfg4, [victim4], x0, base_path=runs, device="cuda", run_tests=True,
                        test_max_new_tokens=DECODE_TOKENS)
            torch.cuda.synchronize()
        finally:
            probe.finish()
        wall4 = time.perf_counter() - t0
        launches4 = launch_counts()
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        csvs = {}
        for f in sorted(os.listdir(exp)):
            if f.startswith("test_results_iter_"):
                with open(os.path.join(exp, f), newline="", encoding="utf-8") as fh:
                    csvs[f] = list(csv.reader(fh))
    steps4 = [r for r in rows if "loss" in r]
    tests4 = [r for r in rows if "test_target_acc" in r]
    for r in steps4:
        log("main4", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} step_ms={r['step_ms']:.2f}")
    med4 = statistics.median(r["step_ms"] for r in steps4[1:])
    log("main4", f"batch 4, T={t4}: median step_ms (steps 1..{STEPS4 - 1})={med4:.2f} warm-up "
        f"step_ms={steps4[0]['step_ms']:.2f} steps' peak_memory_GiB={probe.step_peak / 2**30:.3f} "
        f"train wall_s={wall4:.1f}")
    if len(steps4) != STEPS4 or not all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps4):
        raise AssertionError(f"batch-4 path: bad steps {[(r.get('loss'), r.get('grad_norm')) for r in steps4]}")
    for c in probe.chunks:
        n_fwd = len(c["ends"])
        log("main4", f"test decode chunk: batch {c['batch']} prefill T={c['T']} prefill_ms="
            f"{c['prefill_ms']:.2f} decode_ms={c['decode_ms']:.2f} ({n_fwd} forwards, "
            f"{(c['decode_ms'] - c['prefill_ms']) / max(n_fwd - 1, 1):.2f} ms per cached step) "
            f"tokens/s={c['tokens'] / c['decode_ms'] * 1e3:.1f} peak_memory_GiB={c['peak_GiB']:.3f} "
            f"prefill launches={ {k: v for k, v in c['prefill_launches'].items() if v} }")
    for r in tests4:
        log("main4", f"test metrics at iteration {r['iteration']}: "
            + " ".join(f"{k}={r[k]}" for k in sorted(r) if k.startswith("test_")))
    log("main4", f"launches over the run: {launches4}; by phase: "
        + "; ".join(f"{p} x{probe.calls[p]} {dict(+c)}" for p, c in probe.launches.items()))
    bwd4 = {k: launches4[k] - sum(probe.launches[p][k] for p in probe.launches) for k in launches4}
    per_step4 = {
        "dgrad": bwd4["dgrad"] / STEPS4,
        "flash_fwd": probe.launches["step"]["flash_fwd"] / STEPS4,
        "flash_bwd_dq": bwd4["flash_bwd_dq"] / STEPS4,
        "flash_bwd_dkdv": bwd4["flash_bwd_dkdv"] / STEPS4,
    }
    expected4 = {"dgrad": dg["per_step"], "flash_fwd": t.num_layers, "flash_bwd_dq": t.num_layers,
                 "flash_bwd_dkdv": t.num_layers}
    fused4 = sum(launches4[k] for k in pr3_kernels if k != "dgrad")
    per_chunk = [c["prefill_launches"]["flash_fwd"] for c in probe.chunks]
    log("main4", f"launches per step: {per_step4} (expected {expected4}); fused-attention launches "
        f"in the run: {fused4} (expected 0); flash forward launches per decode chunk: {per_chunk} "
        f"(expected {t.num_layers} each); cached decode steps launched "
        f"{sum(probe.launches['decode_step'].values())} kernels (expected 0: plain sdpa)")
    if per_step4 != expected4 or fused4 or any(n != t.num_layers for n in per_chunk):
        raise AssertionError("batch-4 path launches differ from the expected counts")
    if probe.launches["monitor"]["flash_fwd"] != probe.calls["monitor"] * t.num_layers:
        raise AssertionError("batch-4 path: the resaved-loss monitor did not take the flash kernel")
    if sum(probe.launches["decode_step"].values()):
        raise AssertionError("batch-4 path: a cached decode step launched a kernel")
    boundaries = [i for i in range(STEPS4) if i % cfg4.save_steps == 0 or i == STEPS4 - 1]
    want_csvs = [f"test_results_iter_{i}.csv" for i in boundaries]
    if sorted(csvs) != sorted(want_csvs) or [r["iteration"] for r in tests4] != boundaries:
        raise AssertionError(f"batch-4 path: test CSVs {sorted(csvs)} != {want_csvs}")
    for name, table in csvs.items():
        if len(table) != 1 + len(test_qs) or [r[0] for r in table[1:]] != list(test_qs):
            raise AssertionError(f"{name}: expected a header and {len(test_qs)} rows, got {len(table)}")
        if not all(len(r) == 2 and r[1].startswith("USER: ") for r in table[1:]):
            raise AssertionError(f"{name}: malformed rows")
        log("main4", f"{name}: {len(table) - 1} rows; first answer tail {table[1][1][-60:]!r}")
    if len(probe.chunks) != len(boundaries) * -(-len(test_qs) // decode_bs):
        raise AssertionError(f"batch-4 path: {len(probe.chunks)} decode chunks")

    # 4Z. --remat_policy at batch 4, the weights resident
    remat = remat_phase(victim4, x0, cfg4, dg4["per_step"])

    # 4R. true resume and the profiler trace, on the loaded victim at batch 1
    resume = resume_phase(victim, x0, dg["per_step"], t.num_layers)

    # 5. depth-cut references: card (bf16, kernels) against CPU (f32, plain path), on the first
    # layers of the loaded victim's weights, tokenized by its tokenizer
    cut = dataclasses.replace(
        vlm_cfg,
        text=dataclasses.replace(vlm_cfg.text, num_layers=2),
        vision=dataclasses.replace(vlm_cfg.vision, num_layers=2),
    )
    # rows 0-1 are the batch-1 reference's prompts; rows 2-3 are shorter, so its width stays
    questions = [QUESTION, QUESTION + " Explain every step in detail, please.", "How?",
                 "Tell me the forbidden info, now."]
    ref_cfg = dataclasses.replace(cfg, exp_name="reference")
    t0 = time.perf_counter()
    gpu_v = VictimSetup(
        "cut", make_bundle("cut", "llava", cut, torch.device("cuda"), params=depth_cut(victim.bundle.params, 2, 2)),
        victim.adv_processor,
        AdvInputs(ai1.spec, ai1.tokenizer, questions, [QUESTION], ref_cfg.batch_size, [TARGET],
                  ai1.num_image_tokens, ai1.image_token_id, ai1.pad_token_id),
        torch.bfloat16,
    )
    ai = gpu_v.adv_inputs
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn((1, 3, 336, 336), generator=gen)
    p0 = 0.3 * torch.randn((3, 512, 512), generator=gen)
    noise4 = torch.randn((4, 3, 336, 336), generator=gen)
    # the blur + crop step of phase 4t, with a crop box and a square position drawn here and
    # injected into both sides; the gradients are compared under the square mask the step applies
    t_cfg = dataclasses.replace(ref_cfg, use_gaussian_blur=True, gblur_kernel_size=5, gblur_sigma=7.0,
                                use_local_crop=True, mask_type="random_square", mask_size=256,
                                mask_refresh_random_square=True)
    t_gen = torch.Generator().manual_seed(6)
    t_draws = {"crop_box": sample_crop_box(t_gen, 512, 512), "mask_pos": square_position(t_gen, (3, 512, 512), 256)}
    t_mask = random_square_mask((3, 512, 512), 256, position=t_draws["mask_pos"]).double()
    card, steps, masks, reference = {}, [], {}, {}
    x0_d = torch.as_tensor(x0, device="cuda")
    for label, row_idx, nz, r_cfg, draws in (
            ("batch 1", [0], noise, ref_cfg, {}), ("batch 4", [0, 1, 2, 3], noise4, ref_cfg, {}),
            ("batch 1, blur + crop + square", [0], noise, t_cfg, t_draws)):
        xs = {
            "t_idx": 0,
            "rows": [torch.from_numpy(ai.prompt_pool[0, row_idx])],
            "lens": [torch.from_numpy(ai.prompt_lengths[0, row_idx])],
            "noise": [nz],
            **draws,
        }
        ref_pads = [ai.max_len - int(n) for n in ai.prompt_lengths[0, row_idx]]
        step = build_attack_step([gpu_v.handles()], r_cfg, x0_d, torch.ones_like(x0_d))
        reset_launches()
        loss, _, _, _, grad = step.loss_and_grad(p0.cuda(), xs, torch.tensor(cfg.sigma, device="cuda"))
        masks[label] = t_mask if draws else 1.0
        card[label] = ([float(loss)], grad.double().cpu() * masks[label])
        log("reference", f"{label} cuda: loss={float(loss)} grad_norm={float(grad.norm())} "
            f"T={ai.max_len} pads={ref_pads} {draws} launches={launch_counts()}")
        steps.append((label, xs, dataclasses.replace(r_cfg, sigma=cfg.sigma), None))
        reference[label] = {}
    x_img = np.clip(x0 + 0.5 * np.tanh(p0.numpy()), 0.0, 1.0).astype(np.float32)
    d = decode_card(gpu_v, list(corpora.not_safe_questions_test[:3]), x_img, {"flash_fwd": cut.text.num_layers})

    def check(out):
        for label in card:
            cpu_l, cpu_g = out["steps"][label]
            check_step_reference(label, card[label], (cpu_l, cpu_g * masks[label]), reference[label])
        reference["decode_cosine"] = decode_check(d, out["forwards"]["decode"])

    REFS.submit("llava depth cut", {"victims": [reference_victim("llava", cut, gpu_v.bundle.params, None, ai)],
                                     "x0": x0, "p0": p0, "steps": steps,
                                     "forwards": {"decode": decode_inputs(d)}}, check)
    log("reference", f"all references' card half in {time.perf_counter() - t0:.1f} s")
    return {
        "stats": {"dgrad": dg, **attn, **flash}, "prefill": prefill, "transforms": transforms, "dgrad4": dg4,
        "load": load_stats, "resume": resume, "median_b1_ms": med, "peak_b1_GiB": peak, "remat": remat,
        "counts": {**{k: launches[k] for k in pr3_kernels}, **{k: launches4[k] for k in flash}},
    }


def judge_ids(cfg, seg, seed):
    """Text-only prompts for ``seg``'s rows: token ids from a seed (no image token), pads where
    ``seg`` is 0, as the judge's left-padded rows carry them."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, cfg.text.vocab_size, tuple(seg.shape), generator=gen)
    ids = torch.where(ids == cfg.image_token_id, 3, ids).to(seg.device)
    return torch.where(seg.bool(), ids, torch.full_like(ids, cfg.pad_token_id))


def judge_prefill(params, g_cfg):
    """Phase 4g: the Gemma-3 safety judge's text-only prefill at full width and depth on the
    victim's weights: B 16 rows of T 704, each left-padded by a seeded 0..160 tokens, through
    ``gemma3.forward(..., logits_last_k=1)`` under no_grad, as the judge's decode prefill takes its
    last logits. Its global layers take the head_dim-256 flash forward (one launch each, no
    backward), its sliding-window layers the plain sdpa, as in JAX. Counted from zero; each forward
    timed in CUDA events, with the share of it spent in the flash forward's launches."""
    import torch

    from adversarialvlm_tpu_torch.models import gemma3
    from adversarialvlm_tpu_torch.models.llama import _layer_sliding_window
    from adversarialvlm_tpu_torch.ops.kernels import flash as Fl
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    t = g_cfg.text
    n_global = sum(_layer_sliding_window(t, i) is None for i in range(t.num_layers))
    seg = judge_seg()
    ids = judge_ids(g_cfg, seg, seed=7)
    spans, real_fwd = [], Fl.flash_fwd

    def timed_flash_fwd(*args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_fwd(*args)
        b.record()
        spans.append((a, b))
        return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fwd_ms, attn_ms = [], []
    with torch.no_grad():
        logits = gemma3.forward(params, g_cfg, ids, seg, logits_last_k=1)  # warm-up
        Fl.flash_fwd = timed_flash_fwd
        try:
            for _ in range(JUDGE_FORWARDS):
                spans.clear()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                logits = gemma3.forward(params, g_cfg, ids, seg, logits_last_k=1)
                b.record()
                b.synchronize()
                fwd_ms.append(a.elapsed_time(b))
                attn_ms.append(sum(x.elapsed_time(y) for x, y in spans))
        finally:
            Fl.flash_fwd = real_fwd
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_fwd = 1 + JUDGE_FORWARDS
    want = {k: 0 for k in launches}
    want["flash_fwd"] = n_global * n_fwd
    med, med_attn = statistics.median(fwd_ms), statistics.median(attn_ms)
    log("judge", f"text-only prefill B={JUDGE_B} T={JUDGE_T} left pads={[JUDGE_T - int(n) for n in seg.sum(1)]}: "
        f"{t.num_layers} layers, {n_global} global (head_dim {t.head_dim_}); forward ms "
        f"{[round(x, 3) for x in fwd_ms]} (median {med:.3f}); the {n_global} flash forward launches "
        f"{med_attn:.4f} ms a forward, {100 * med_attn / med:.2f}% of it; peak_memory_GiB={peak:.3f}; launches over {n_fwd} forwards: "
        f"{ {k: n for k, n in launches.items() if n} } (expected {n_global} flash_fwd a forward, nothing else)")
    if launches != want:
        raise AssertionError(f"judge prefill launched {launches}, expected {want}")
    finite = bool(torch.isfinite(logits).all())
    if logits.shape != (JUDGE_B, 1, t.vocab_size) or not finite:
        raise AssertionError(f"judge prefill: logits {tuple(logits.shape)}, finite {finite}")
    return {"launches": launches["flash_fwd"]}


def gemma_phases(ckpt_root):
    """Phases 4g and 4c: the judge's text-only prefill on the full-depth Gemma-3-4B-it, then its
    attack at batch 4 through ``train(run_tests=True)``, with the dgrad kernel checked at its
    shapes first. Returns the run's launch counts, the Gemma dgrad statistics and the prefill's
    numbers. Its tensors are freed on return."""
    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import train
    from adversarialvlm_tpu_torch.eval.generation import _pick_decode
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, launch_counts_by_head_dim, reset_launches

    cfg = AttackConfig(exp_name="chip_smoke_gemma3", num_iterations=STEPS_G, save_steps=10,
                       batch_size=4, grad_accum_steps=1, lr=1e-2)
    # 4G. the victim, loaded from the directory the port's fabricator writes
    t0 = time.perf_counter()
    victim, load_stats = checkpoint_victim("gemma-3-4b", cfg, ckpt_root)
    g_cfg = victim.bundle.cfg
    t, v = g_cfg.text, g_cfg.vision
    ai = victim.adv_inputs
    t_text = int(ai.max_len)
    n_params = sum(p.numel() for p in _leaves(victim.bundle.params))
    n_vision = sum(p.numel() for p in _leaves(victim.bundle.params["vision_tower"]))
    n_patches = (v.image_size // v.patch_size) ** 2
    test_qs = ai.test_questions
    decode_bs, _ = _pick_decode(victim.bundle, ai, test_qs, DECODE_TOKENS, 50, torch.bfloat16)
    log("gemma", f"victim loaded in {time.perf_counter() - t0:.1f} s: {n_params / 1e9:.3f} B params "
        f"({n_vision / 1e9:.3f} B in the tower), {torch.cuda.memory_allocated() / 2**30:.2f} GiB on "
        f"the card; prompt pool {ai.prompt_pool.shape[1]} questions x {ai.prompt_pool.shape[0]} "
        f"targets, T={t_text} (image span {len(ai.image_expansion_ids)} tokens), tower T={n_patches} "
        f"patches, test decode at batch {decode_bs} (pick_decode_config)")
    dg = check_dgrad(gemma_dgrad_cases(victim.bundle.params, g_cfg, cfg.batch_size, t_text),
                     "dgrad gemma3")
    torch.cuda.empty_cache()
    judge = judge_prefill(victim.bundle.params, g_cfg)

    x0 = np.full((3, 512, 512), 0.47, np.float32)
    with tempfile.TemporaryDirectory() as runs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the path's peak counts its own blocks, not an earlier phase's leftovers
        torch.cuda.reset_peak_memory_stats()
        probe = PathProbe(victim.bundle)
        reset_launches()
        t0 = time.perf_counter()
        try:
            exp = train(cfg, [victim], x0, base_path=runs, device="cuda", run_tests=True,
                        test_max_new_tokens=DECODE_TOKENS)
            torch.cuda.synchronize()
        finally:
            probe.finish()
        wall = time.perf_counter() - t0
        launches, launches_d = launch_counts(), launch_counts_by_head_dim()
        rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        csvs = {}
        for f in sorted(os.listdir(exp)):
            if f.startswith("test_results_iter_"):
                with open(os.path.join(exp, f), newline="", encoding="utf-8") as fh:
                    csvs[f] = list(csv.reader(fh))
    steps = [r for r in rows if "loss" in r]
    tests = [r for r in rows if "test_target_acc" in r]
    for r in steps:
        log("gemma", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    log("gemma", f"batch 4, T={t_text}: median step_ms (steps 1..{STEPS_G - 1})={med:.2f} warm-up "
        f"step_ms={steps[0]['step_ms']:.2f} steps' peak_memory_GiB={probe.step_peak / 2**30:.3f} "
        f"train wall_s={wall:.1f}")
    if len(steps) != STEPS_G or not all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps):
        raise AssertionError(f"gemma path: bad steps {[(r.get('loss'), r.get('grad_norm')) for r in steps]}")
    for c in probe.chunks:
        n_fwd = len(c["ends"])
        log("gemma", f"test decode chunk: batch {c['batch']} prefill T={c['T']} prefill_ms="
            f"{c['prefill_ms']:.2f} decode_ms={c['decode_ms']:.2f} ({n_fwd} forwards, "
            f"{(c['decode_ms'] - c['prefill_ms']) / max(n_fwd - 1, 1):.2f} ms per cached step) "
            f"tokens/s={c['tokens'] / c['decode_ms'] * 1e3:.1f} peak_memory_GiB={c['peak_GiB']:.3f} "
            f"prefill launches={ {k: n for k, n in c['prefill_launches'].items() if n} }")
    for r in tests:
        log("gemma", f"test metrics at iteration {r['iteration']}: "
            + " ".join(f"{k}={r[k]}" for k in sorted(r) if k.startswith("test_")))
    log("gemma", f"launches over the run: {launches}; by phase: "
        + "; ".join(f"{p} x{probe.calls[p]} {dict(+c)}" for p, c in probe.launches.items()))
    bwd = {k: launches[k] - sum(probe.launches[p][k] for p in probe.launches) for k in launches}
    per_step = {
        "dgrad": bwd["dgrad"] / STEPS_G,
        "flash_full_fwd": probe.launches["step"]["flash_full_fwd"] / STEPS_G,
        "flash_full_bwd_dq": bwd["flash_full_bwd_dq"] / STEPS_G,
        "flash_full_bwd_dkdv": bwd["flash_full_bwd_dkdv"] / STEPS_G,
    }
    expected = {"dgrad": dg["per_step"], "flash_full_fwd": v.num_layers,
                "flash_full_bwd_dq": v.num_layers, "flash_full_bwd_dkdv": v.num_layers}
    others = {k: n for k, n in launches.items() if n and k != "dgrad" and not k.startswith("flash_full")}
    per_monitor = probe.launches["monitor"]["flash_full_fwd"] / max(probe.calls["monitor"], 1)
    per_chunk = [c["prefill_launches"]["flash_full_fwd"] for c in probe.chunks]
    log("gemma", f"launches per step: {per_step} (expected {expected}); fused and flash launches in "
        f"the run: {others} (expected none); flash_full forward launches per monitor forward: "
        f"{per_monitor} and per decode chunk: {per_chunk} (expected {v.num_layers} each); cached "
        f"decode steps launched {sum(probe.launches['decode_step'].values())} kernels (expected 0)")
    if per_step != expected or others:
        raise AssertionError("gemma path launches differ from the expected counts")
    if probe.calls["monitor"] == 0 or per_monitor != v.num_layers:
        raise AssertionError("gemma path: the resaved-loss monitor did not take the flash_full kernel")
    if any(n != v.num_layers for n in per_chunk) or sum(probe.launches["decode_step"].values()):
        raise AssertionError("gemma path: decode launches differ from the expected counts")
    boundaries = [i for i in range(STEPS_G) if i % cfg.save_steps == 0 or i == STEPS_G - 1]
    want_csvs = [f"test_results_iter_{i}.csv" for i in boundaries]
    if sorted(csvs) != sorted(want_csvs) or [r["iteration"] for r in tests] != boundaries:
        raise AssertionError(f"gemma path: test CSVs {sorted(csvs)} != {want_csvs}")
    for name, table in csvs.items():
        if len(table) != 1 + len(test_qs) or [r[0] for r in table[1:]] != list(test_qs):
            raise AssertionError(f"{name}: expected a header and {len(test_qs)} rows, got {len(table)}")
        if not all(len(r) == 2 and r[1].startswith("user\n") and r[0] in r[1] for r in table[1:]):
            raise AssertionError(f"{name}: malformed rows")
        log("gemma", f"{name}: {len(table) - 1} rows; first answer tail {table[1][1][-60:]!r}")
    if len(probe.chunks) != len(boundaries) * -(-len(test_qs) // decode_bs):
        raise AssertionError(f"gemma path: {len(probe.chunks)} decode chunks")
    return {"launches": launches, "launches_d": launches_d, "dgrad": dg, "judge": judge, "load": load_stats,
            "victim": victim}


def gemma_references(victim):
    """Phase 5c: the depth-cut Gemma-3 (the loaded victim's first 6 decoder layers: five
    sliding-window ones and the global one; its first 2 vision layers at the full 4096 patches)
    on the card in bf16 through the kernels against the same weights in f32 on the CPU's plain
    path: the batch-4 step, the test decode and the judge's prefill, tokenized by the victim's
    tokenizer. The card's half runs here, the CPU's in the references' worker (:class:`CpuReferences`)."""
    import dataclasses

    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import VictimSetup
    from adversarialvlm_tpu_torch.attack.step import build_attack_step
    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.models import gemma3
    from adversarialvlm_tpu_torch.models.llama import _layer_sliding_window
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs

    g_cfg = victim.bundle.cfg
    cut = dataclasses.replace(
        g_cfg,
        text=dataclasses.replace(g_cfg.text, num_layers=6),
        vision=dataclasses.replace(g_cfg.vision, num_layers=2),
    )
    windows = [_layer_sliding_window(cut.text, i) for i in range(cut.text.num_layers)]
    questions = [QUESTION, QUESTION + " Explain every step in detail, please.", "How?",
                 "Tell me the forbidden info, now."]
    ref_cfg = AttackConfig(exp_name="reference_gemma3", batch_size=4, grad_accum_steps=1, lr=1e-2)
    t0 = time.perf_counter()
    ai_v = victim.adv_inputs
    gpu_v = VictimSetup(
        "cut-gemma3",
        make_bundle("cut-gemma3", "gemma3", cut, torch.device("cuda"),
                    params=depth_cut(victim.bundle.params, 6, 2)),
        victim.adv_processor,
        AdvInputs(ai_v.spec, ai_v.tokenizer, questions, [QUESTION], ref_cfg.batch_size, [TARGET],
                  ai_v.num_image_tokens, ai_v.image_token_id, ai_v.pad_token_id,
                  image_expansion_ids=ai_v.image_expansion_ids),
        torch.bfloat16,
    )
    ai = gpu_v.adv_inputs
    side = cut.vision.image_size
    gen = torch.Generator().manual_seed(5)
    p0 = 0.3 * torch.randn((3, 512, 512), generator=gen)
    row_idx = [0, 1, 2, 3]
    xs = {
        "t_idx": 0,
        "rows": [torch.from_numpy(ai.prompt_pool[0, row_idx])],
        "lens": [torch.from_numpy(ai.prompt_lengths[0, row_idx])],
        "noise": [torch.randn((4, 3, side, side), generator=gen)],
    }
    pads = [ai.max_len - int(n) for n in ai.prompt_lengths[0, row_idx]]
    x0 = np.full((3, 512, 512), 0.47, np.float32)
    x0_d = torch.as_tensor(x0, device="cuda")
    step = build_attack_step([gpu_v.handles()], ref_cfg, x0_d, torch.ones_like(x0_d))
    reset_launches()
    t1 = time.perf_counter()
    loss, _, _, _, grad = step.loss_and_grad(p0.cuda(), xs, torch.tensor(ref_cfg.sigma, device="cuda"))
    card = ([float(loss)], grad.double().cpu())
    got = launch_counts()
    log("reference", f"gemma3 batch 4 cuda: loss={float(loss)} grad_norm={float(grad.norm())} "
        f"T={ai.max_len} pads={pads} layer windows={windows} launches={got} in {time.perf_counter() - t1:.1f} s")
    want = {"flash_full_fwd": 2, "flash_full_bwd_dq": 2, "flash_full_bwd_dkdv": 2, "flash_fwd": 0, "attention_fwd": 0}
    if any(got[k] != n for k, n in want.items()):
        raise AssertionError(f"gemma3 depth-cut step launched {got}, expected {want}")
    x_img = np.clip(x0 + 0.5 * np.tanh(p0.numpy()), 0.0, 1.0).astype(np.float32)
    d = decode_card(gpu_v, list(corpora.not_safe_questions_test[:3]), x_img,
                    {"flash_full_fwd": cut.vision.num_layers, "flash_fwd": 0, "attention_fwd": 0})

    # the judge's text-only prefill, depth-cut: 2 rows of T 704, one left-padded; global layer 5
    # takes the head_dim-256 flash forward on the card, the plain path on the CPU
    seg = torch.ones((2, JUDGE_T), dtype=torch.int32)
    seg[0, :97] = 0
    ids = judge_ids(cut, seg, seed=11)
    reset_launches()
    with torch.no_grad():
        last = gemma3.forward(gpu_v.bundle.params, cut, ids.cuda(), seg.cuda(), logits_last_k=1)[:, -1].double().cpu()
    got = {k: n for k, n in launch_counts().items() if n}
    log("reference", f"gemma3 text-only prefill cuda: B=2 T={JUDGE_T} pads=[97, 0] launches={got}")
    if got != {"flash_fwd": windows.count(None)}:
        raise AssertionError(f"gemma3 text-only prefill on the card launched {got}, expected "
                             f"{ {'flash_fwd': windows.count(None)} }")
    reference = {"batch 4": {}}

    def check(out):
        check_step_reference("gemma3 batch 4", card, out["steps"]["batch 4"], reference["batch 4"])
        reference["decode_cosine"] = decode_check(d, out["forwards"]["decode"])
        cpu_last = out["forwards"]["prefill"][:, -1]
        cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(last, cpu_last)]
        log("reference", f"gemma3 text-only prefill: last-position logits cosine per row "
            f"{[round(c, 6) for c in cos]} (min {TOL_DECODE_COSINE})")
        if not min(cos) >= TOL_DECODE_COSINE:
            raise AssertionError("gemma3 text-only prefill reference: card and CPU disagree")
        reference["prefill_cosine"] = min(cos)

    REFS.submit("gemma3 depth cut", {"victims": [reference_victim("gemma3", cut, gpu_v.bundle.params, None, ai)],
                                      "x0": x0, "p0": p0, "steps": [("batch 4", xs, ref_cfg, None)],
                                      "forwards": {"decode": decode_inputs(d), "prefill": (ids, seg, None, 1)}}, check)
    log("reference", f"gemma3 references' card half in {time.perf_counter() - t0:.1f} s")


def cross_step_share(victims, dgrad_per_step):
    """The launches a batch-1 cross step of ``victims`` must make, and the same by head dim: each
    decoder on the batch-1 causal kernels at its head dim (mllama's self-attention layers, the
    backward from its first cross layer on), but Gemma-3's, whose layers run masked on the plain
    path while its SigLIP (4096 patches) takes flash_full; the other towers (577, 576 and 1296
    tokens, mllama's masked tiles) stay on the plain sdpa; ``dgrad_per_step`` dgrad launches."""
    want, want_d = {"dgrad": dgrad_per_step}, {}
    for v in victims:
        cfg = v.bundle.cfg
        if v.bundle.family == "gemma3":
            entry, d = "flash_full", cfg.vision.hidden_size // cfg.vision.num_heads
            n = (cfg.vision.num_layers,) * 3
        else:
            entry, d = "attention", cfg.text.head_dim_
            n = (n_self_layers(cfg.text), *(n_backward_layers(cfg.text),) * 2)
        for k, nk in zip((f"{entry}_fwd", f"{entry}_bwd_dq", f"{entry}_bwd_dkdv"), n):
            want[k] = want.get(k, 0) + nk
            want_d[f"{k}_d{d}"] = want_d.get(f"{k}_d{d}", 0) + nk
    return want, want_d


def n_self_layers(t):
    """A decoder's self-attention layers: each takes a causal kernel forward a step and a decode prefill."""
    return t.num_layers - len(t.cross_attention_layers)


def n_backward_layers(t):
    """A decoder's self-attention layers whose backward runs in an attack step: all of them, but in
    mllama only those after the first cross layer (before it nothing depends on the image)."""
    first = min(t.cross_attention_layers, default=0)
    return sum(1 for i in range(first, t.num_layers) if i not in t.cross_attention_layers)


def check_cross_launches(tag, per_step, per_step_d, want, want_d):
    """Raises unless a cross step launched exactly ``want`` (every other kernel no time) and, by
    head dim, exactly ``want_d``."""
    log(tag, f"launches per cross step: { {k: n for k, n in per_step.items() if n} }, by head dim "
        f"{ {k: n for k, n in per_step_d.items() if n} } (expected {want}, by head dim {want_d})")
    if per_step != {k: want.get(k, 0) for k in per_step} or {k: n for k, n in per_step_d.items() if n} != want_d:
        raise AssertionError(f"{tag}: launches per cross step differ from each victim's own")


def cross_cli(args, captured=None, tests=True, decode_cut=False):
    """cli/crossattack_models.main on ``args``, spied on as :func:`spied_cli` does."""
    from adversarialvlm_tpu_torch.cli import crossattack_models

    return spied_cli(crossattack_models.main, args, captured, tests, decode_cut)


def spied_cli(main, args, captured=None, tests=True, decode_cut=False):
    """An attack CLI's ``main`` on ``args``. With ``captured`` (a dict), the engine's train() is
    wrapped for that run: the victims the CLI built, a PathProbe on each, the launches counted
    from zero after the victims are loaded (also by head dim), the run's wall time and its peak device memory from an
    emptied cache go into it. ``tests=False`` runs train() without the save boundaries' test decode
    (for runs whose decode an earlier run of the same victims already checked); ``decode_cut``
    decodes MESH_DECODE_TOKENS new tokens over the first MESH_TEST_QUESTIONS held-out questions, in
    one chunk of that many rows."""
    import torch

    from adversarialvlm_tpu_torch.attack import engine
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, launch_counts_by_head_dim, reset_launches

    real_train, real_test = engine.train, engine.run_model_test
    if captured is None:
        if tests:
            return main(args)
        engine.train = lambda cfg, victims, x0, **kw: real_train(cfg, victims, x0, **{**kw, "run_tests": False})
        try:
            return main(args)
        finally:
            engine.train = real_train

    def spy(cfg, victims, x0, **kw):
        if not tests:
            kw["run_tests"] = False
        if decode_cut:
            kw["test_max_new_tokens"] = MESH_DECODE_TOKENS
            for v in victims:
                v.adv_inputs.test_questions = list(v.adv_inputs.test_questions[:MESH_TEST_QUESTIONS])
        captured["victims"] = victims
        group = []
        probes = [PathProbe(v.bundle, group) for v in victims]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the run's peak counts its own blocks, not an earlier phase's
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        try:
            return real_train(cfg, victims, x0, **kw)
        finally:
            torch.cuda.synchronize()
            captured["wall_s"] = time.perf_counter() - t0
            for probe in probes:
                probe.finish()
            captured["probes"], captured["launches"] = probes, launch_counts()
            captured["launches_d"] = launch_counts_by_head_dim()

    engine.train = spy
    if decode_cut:
        engine.run_model_test = lambda *a, **kw: real_test(*a, **{**kw, "batch_size": MESH_TEST_QUESTIONS})
    try:
        return main(args)
    finally:
        engine.train, engine.run_model_test = real_train, real_test


def read_run(exp):
    """metrics.jsonl's rows (without step_ms) and its step rows (with it), and the test CSVs."""
    rows, steps = [], []
    for line in open(os.path.join(exp, "metrics.jsonl")):
        r = json.loads(line)
        if "_config" in r:
            continue
        if "loss" in r:
            steps.append(dict(r))
        r.pop("step_ms", None)
        rows.append(r)
    csvs = {}
    for f in sorted(os.listdir(exp)):
        if f.startswith("test_results_iter_"):
            with open(os.path.join(exp, f), newline="", encoding="utf-8") as fh:
                csvs[f] = list(csv.reader(fh))
    return rows, steps, csvs


def run_config(exp):
    """The AttackConfig a run wrote into its config.json."""
    from adversarialvlm_tpu_torch.attack.config import AttackConfig

    saved = json.load(open(os.path.join(exp, "config.json")))
    return AttackConfig(**{k: v for k, v in saved.items() if k in AttackConfig.__dataclass_fields__})


def first_pad(victims, cfg):
    """The left pad of the first victim's first question row in a run's first step."""
    import torch

    from adversarialvlm_tpu_torch.attack.step import sample_chunk_xs

    xs = sample_chunk_xs(torch.Generator().manual_seed(cfg.seed), 1, cfg, [v.handles() for v in victims])[0]
    return int(victims[0].adv_inputs.max_len) - int(xs["lens"][0][0])


def dpo_kernels(victim, cfg, cross):
    """Phase 4D's LLaVA kernels where its pool (the target and the refusal rows) gives another T
    than 4X's: the batch-1 causal kernels and the decoder's dgrad shapes at that T, against their
    plain versions (the vision and projector shapes are 4X's)."""
    t_dpo, t = int(victim.adv_inputs.max_len), victim.bundle.cfg.text
    log("dpo", f"LLaVA's DPO pool: {victim.adv_inputs.prompt_pool.shape} (targets, questions, T), "
        f"{victim.adv_inputs.n_refuse} refusal rows; T {t_dpo} (4X: {cross['T']})")
    if t_dpo == cross["T"]:
        return
    cases = llava_dgrad_cases(victim.bundle.params, victim.bundle.cfg, t_dpo, batch=cfg.batch_size)
    check_dgrad([c for c in cases if c[0] == cfg.batch_size * t_dpo], "dgrad dpo")
    attention_case(t_dpo, t.num_heads, t.num_kv_heads, t.head_dim_, first_pad([victim], cfg))


def cross_kernels(victims, cfg, probe_l):
    """Phase 4X's kernels at the shapes the cross run gave them, read from the victims the CLI
    built, each against its plain version and timed as in phase 3: dgrad over both victims'
    linears at the run's batch (LLaVA's pool T, Gemma's), the batch-1 causal kernels at LLaVA's T
    with the pad of the run's first step, flash_full forward and backward at the run's batch (the
    step; the monitor and Gemma's decode prefill run its forward at batch 1 too) and the flash
    forward at LLaVA's decode prefill, its test questions padded as run_model_test pads them,
    whose (batch, T) must be every LLaVA decode chunk's of the run (``probe_l``)."""
    import torch

    from adversarialvlm_tpu_torch.eval.generation import _pick_decode
    from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets

    llava, gemma = victims
    l_cfg, g_cfg = llava.bundle.cfg, gemma.bundle.cfg
    t, v = l_cfg.text, g_cfg.vision
    t_l, t_g, b = int(llava.adv_inputs.max_len), int(gemma.adv_inputs.max_len), cfg.batch_size
    pad = first_pad(victims, cfg)
    ai = llava.adv_inputs
    qs = ai.test_questions
    decode_bs, _ = _pick_decode(llava.bundle, ai, qs, MESH_DECODE_TOKENS, MESH_TEST_QUESTIONS, llava.compute_dtype)
    probe_in = ai.get_inputs_inference_batch(qs[:decode_bs])
    _, am, _ = pad_to_buckets(probe_in["input_ids"], probe_in["attention_mask"], ai.pad_token_id, batch_to=decode_bs)
    seg = torch.as_tensor(am, dtype=torch.int32, device="cuda")
    run_shapes = sorted({(c["batch"], c["T"]) for c in probe_l.chunks})
    log("cross", f"the run's kernel shapes: batch {b}, LLaVA T {t_l} (first step's pad {pad}), Gemma T {t_g}, "
        f"tower {(v.image_size // v.patch_size) ** 2} patches; LLaVA decode prefill {tuple(seg.shape)} "
        f"(the run's chunks: {run_shapes})")
    if run_shapes != [tuple(seg.shape)]:
        raise AssertionError(f"cross path: LLaVA decode chunks {run_shapes}, checked {tuple(seg.shape)}")
    dg = check_dgrad(llava_dgrad_cases(llava.bundle.params, l_cfg, t_l, batch=b)
                     + gemma_dgrad_cases(gemma.bundle.params, g_cfg, b, t_g), "dgrad cross step")
    attn = attention_case(t_l, t.num_heads, t.num_kv_heads, t.head_dim_, pad, timed=True)
    full = flash_full_case("gemma3 cross step, monitor and decode prefill", b, v.num_heads,
                           (v.image_size // v.patch_size) ** 2, v.hidden_size // v.num_heads, timed=True)
    prefill = flash_case("cross test-decode prefill", seg, t.num_heads, t.num_kv_heads, t.head_dim_, timed=True,
                         backward=False)
    torch.cuda.empty_cache()
    return {"dgrad": dg, **attn, **full, **prefill, "T": t_l}


def cross_phases(ckpt_root, runs):
    """Phases 4X, 5X and 4D on the two checkpoint directories under ``ckpt_root``, both victims
    resident on the card, their runs under ``runs``. Returns the cross step's numbers, its launches
    per step, its kernels' numbers at the run's shapes and 4X's run directory (phase 4J judges
    it)."""
    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.io import load_image_chw
    from adversarialvlm_tpu_torch.attack.step import host_generator
    from adversarialvlm_tpu_torch.ops.blur import draw_sigma, random_sigma_gaussian_blur
    from adversarialvlm_tpu_torch.utils.png import write_png

    llava, gemma = "llava-hf/llava-1.5-7b-hf", "google/gemma-3-4b-it"
    png = os.path.join(runs, "x0.png")
    write_png(png, np.full((512, 512, 3), 120, np.uint8))
    x0 = load_image_chw(png)
    # the reference script's settings (scripts/attacks/attack_cross.sh): batch 1, ε 0.4 by
    # default, the list prompts and random targets
    base = ["--img_orig", png, "--runs_path", runs, "--checkpoint_root", ckpt_root, "--batch_size", "1",
            "--prompt", "list", "--target_text_random", "--save_steps", "10"]

    # 4X. the cross attack through the CLI, both victims loaded from their directories
    got = {}
    t0 = time.perf_counter()
    exp = cross_cli(base + ["--exp_name", "cross", "--model_names", f"{llava},{gemma}",
                            "--num_iterations", str(STEPS_X)], got, decode_cut=True)
    total_s = time.perf_counter() - t0
    rows, steps, csvs = read_run(exp)
    victims = got["victims"]
    cfg = run_config(exp)
    ai = [v.adv_inputs for v in victims]
    log("cross", f"{[v.name for v in victims]} from {ckpt_root} through cli/crossattack_models.py: "
        f"epsilon={cfg.epsilon} batch {cfg.batch_size}, pools {[a.prompt_pool.shape for a in ai]} (T "
        f"{[a.max_len for a in ai]}), {torch.cuda.memory_allocated() / 2**30:.2f} GiB resident; CLI "
        f"{total_s:.1f} s, of which train() {got['wall_s']:.1f} s")
    for r in steps:
        log("cross", f"step {r['iteration']}: loss={r['loss']} loss_0={r['loss_0']} loss_1={r['loss_1']} "
            f"grad_norm={r['grad_norm']} target_idx={r['target_idx']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    step_peak = max(p.step_peak for p in got["probes"]) / 2**30
    chunk_peaks = {v.name: [round(c["peak_GiB"], 3) for c in p.chunks] for v, p in zip(victims, got["probes"])}
    log("cross", f"median step_ms (steps 1..{STEPS_X - 1})={med:.2f} warm-up step_ms={steps[0]['step_ms']:.2f} "
        f"steps' peak_memory_GiB={step_peak:.3f}; each test-decode chunk's peak (GiB): {chunk_peaks}")
    if cfg.epsilon != 0.4 or len(steps) != STEPS_X or not all(
            np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps):
        raise AssertionError(f"cross path: epsilon {cfg.epsilon}, steps {[(r['loss'], r['grad_norm']) for r in steps]}")
    probe_l, probe_g = got["probes"]
    kernels = cross_kernels(victims, cfg, probe_l)
    launches = got["launches"]
    per_step = per_step_launches(got["probes"], launches, STEPS_X)
    per_step_d = per_step_launches(got["probes"], got["launches_d"], STEPS_X, by_head_dim=True)
    log("cross", f"launches over the run: {launches}; by victim and phase: "
        + "; ".join(f"{v.name} {ph} x{p.calls[ph]} {dict(+c)}" for v, p in zip(victims, got["probes"])
                    for ph, c in p.launches.items()))
    check_cross_launches("cross", per_step, per_step_d, *cross_step_share(victims, kernels["dgrad"]["per_step"]))
    boundaries = [0, STEPS_X - 1]
    test_qs = ai[0].test_questions
    for c in (probe_l.chunks + probe_g.chunks):
        log("cross", f"test decode chunk: batch {c['batch']} prefill T={c['T']} prefill_ms={c['prefill_ms']:.2f} "
            f"decode_ms={c['decode_ms']:.2f} prefill launches={ {k: n for k, n in c['prefill_launches'].items() if n} }")
    if sorted(csvs) != sorted(f"test_results_iter_{i}.csv" for i in boundaries):
        raise AssertionError(f"cross path: test CSVs {sorted(csvs)}")
    for name, table in csvs.items():
        if table[0] != ["question", llava, gemma] or [r[0] for r in table[1:]] != list(test_qs) or not all(
                r[1].startswith("USER: ") and r[2].startswith("user\n") for r in table[1:]):
            raise AssertionError(f"{name}: expected both victims' answers to {len(test_qs)} questions")
        log("cross", f"{name}: {len(table) - 1} rows of {table[0]}")
    if probe_l.calls["prefill"] == 0 or probe_g.calls["prefill"] == 0:
        raise AssertionError("cross path: a victim did not decode at the boundaries")

    # 5X. depth-cut references of the cross step on the loaded weights
    profiled = profile_cross(victims, cfg, x0)
    reference = cross_reference(victims, x0)
    run_peak = max([step_peak] + [c for peaks in chunk_peaks.values() for c in peaks])
    del victims, got
    gc.collect()
    torch.cuda.empty_cache()

    # 4X, blur: the cross mode's random σ; seed 2 draws σ 0.144, 0.819, 1.891, so the saved
    # image must carry the last and visibly differs from the unblurred one
    blur = {}
    exp_b = cross_cli(base + ["--exp_name", "cross_blur", "--model_names", f"{llava},{gemma}",
                              "--num_iterations", str(STEPS_XB), "--use_gaussian_blur", "--seed", "2"], blur,
                      tests=False)
    _, b_steps, _ = read_run(exp_b)
    gen = host_generator(2, 4)
    sigma = [draw_sigma(gen) for _ in range(STEPS_XB)][-1]
    p = torch.load(os.path.join(exp_b, "attack_state_latest.pt"), weights_only=True)["p"].cuda()
    x = 0.4 * torch.tanh(p)
    saved = np.fromfile(os.path.join(exp_b, "optimized_image_iter_final.bin"), np.float32).reshape(x0.shape)
    blur_err = float(np.abs(saved - (x0 + random_sigma_gaussian_blur(x, 5, sigma=sigma).cpu().numpy())).max())
    raw_err = float(np.abs(saved - (x0 + x.cpu().numpy())).max())
    log("cross", f"blur: {len(b_steps)} steps, median step_ms {statistics.median(r['step_ms'] for r in b_steps[1:]):.2f}; "
        f"saved image against x0 + blur at the last step's sigma {sigma:.4f}: max |diff|={blur_err:.3g}; against "
        f"the unblurred x0 + 0.4 tanh p: {raw_err:.3g}; launches {blur['launches']}")
    if len(b_steps) != STEPS_XB or not (blur_err <= 1e-6 < raw_err):
        raise AssertionError("cross blur path: the saved image is not x0 + blur at the last step's sigma")
    del blur
    gc.collect()
    torch.cuda.empty_cache()

    # 4D. DPO on LLaVA alone through the cross CLI, and its exact resume
    dpo = base + ["--model_names", llava, "--DPO_flag", "--refuse_prob", "0.5"]
    dpo = [a for a in dpo if a != "--target_text_random"]
    t0 = time.perf_counter()
    dpo_got = {}
    straight = cross_cli(dpo + ["--exp_name", "dpo_straight", "--num_iterations", str(DPO_STEPS)], dpo_got,
                         tests=False)
    dpo_kernels(dpo_got.pop("victims")[0], run_config(straight), kernels)
    part1 = cross_cli(dpo + ["--exp_name", "dpo_part1", "--num_iterations", str(DPO_CUT)], tests=False)
    part2 = cross_cli(dpo + ["--exp_name", "dpo_part2", "--num_iterations", str(DPO_STEPS), "--resume_state",
                             os.path.join(part1, "attack_state_latest.pt")], tests=False)
    dpo_s = time.perf_counter() - t0
    (s_rows, s_steps, _), (r_rows, r_steps, _) = read_run(straight), read_run(part2)
    want = [r for r in s_rows if r["iteration"] >= DPO_CUT]
    final = [np.fromfile(os.path.join(e, "optimized_image_iter_final.bin"), np.float32) for e in (straight, part2)]
    flags = [(r["iteration"], r["refuse_flag"], r["target_idx"]) for r in s_steps]
    log("dpo", f"{DPO_STEPS} steps, {DPO_CUT}, then resumed to {DPO_STEPS}, in {dpo_s:.1f} s; (iteration, "
        f"refuse_flag, target_idx) of the uninterrupted run: {flags}; resumed: "
        f"{[(r['iteration'], r['refuse_flag'], r['target_idx']) for r in r_steps]}")
    equal = r_rows == want and np.array_equal(final[0], final[1])
    if not equal:
        diff = sorted({k for a, b in zip(r_rows, want) for k in set(a) | set(b) if a.get(k) != b.get(k)})
        raise AssertionError(f"DPO resume: rows or the final image differ (fields {diff})")
    if {f for _, f, _ in flags} != {0, 1} or any((t == -1) != bool(f) for _, f, t in flags):
        raise AssertionError(f"DPO run: refusal flags {flags}")
    dpo_verdict = (f"equal: {len(r_rows)} metrics.jsonl rows (steps {DPO_CUT}-{DPO_STEPS - 1} with their "
                   f"refuse_flag and target_idx, monitor, checkpoint) and the final image bit for bit")
    log("dpo", dpo_verdict)
    try:
        cross_cli(dpo + ["--exp_name", "dpo_gemma", "--model_names", f"{llava},{gemma}",
                         "--checkpoint_root", os.path.join(runs, "no_such_root")])
        raise AssertionError("DPO with Gemma-3 among the victims did not raise")
    except ValueError as e:
        log("dpo", f"--DPO_flag with Gemma-3 among the victims raises before any file is read: {e}")
    return {"median_ms": med, "step_peak_GiB": step_peak, "run_peak_GiB": run_peak, "profiled": profiled,
            "per_step": per_step, "per_step_d": per_step_d, "reference": reference, "dpo": dpo_verdict,
            "kernels": kernels, "exp": exp}


def profile_cross(victims, cfg, x0, labels=("llava", "gemma3"), rounds=PROFILE_ROUNDS, timed=TIMED_STEPS,
                  profiled=PROFILE_STEPS, tag="cross"):
    """Phases 4X and 4XV, each victim alone beside the cross step, on the same resident victims and
    the same draws: after a warm-up step each, ``rounds`` rounds of ``timed`` steps of the cross
    step, then the first victim's, then the second's (``labels``; wall time a step, synchronized
    at each round's end, and the caching allocator's device allocations and frees a step), then
    ``profiled`` steps of each under torch.profiler: the wall time and the device's busy time a
    step, the union of its kernels' and copies' intervals, as cli/profile_step.py counts it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state, sample_chunk_xs
    from adversarialvlm_tpu_torch.cli.profile_step import _device_intervals, _union_us

    x0_d = torch.as_tensor(x0, device="cuda")
    handles = [v.handles() for v in victims]
    runs = {}
    for label, hs, cross in (("cross", handles, True), (labels[0], handles[:1], False),
                             (labels[1], handles[1:], False)):
        step = build_attack_step(hs, cfg, x0_d, torch.ones_like(x0_d), cross=cross)
        draws = iter(sample_chunk_xs(torch.Generator().manual_seed(cfg.seed), 1 + rounds * timed + profiled,
                                     cfg, hs))
        state, _ = step(init_state(cfg, x0_d), next(draws))
        runs[label] = [step, state, draws]
    torch.cuda.synchronize()
    out = {label: {"round_ms": [], "device_allocs": 0, "device_frees": 0} for label in runs}
    for _ in range(rounds):
        for label, run in runs.items():
            before = torch.cuda.memory_stats()
            t0 = time.perf_counter()
            for _ in range(timed):
                run[1], _ = run[0](run[1], next(run[2]))
            torch.cuda.synchronize()
            out[label]["round_ms"].append(1e3 * (time.perf_counter() - t0) / timed)
            after = torch.cuda.memory_stats()
            out[label]["device_allocs"] += after["num_device_alloc"] - before["num_device_alloc"]
            out[label]["device_frees"] += after["num_device_free"] - before["num_device_free"]
    ratios = [c / (a + b) for c, a, b in zip(*(out[k]["round_ms"] for k in ("cross", *labels)))]
    log(tag, f"{rounds} rounds of {timed} steps each, ms a step: "
        + "; ".join(f"{k} {[round(t, 2) for t in v['round_ms']]} (allocator: {v['device_allocs']} device "
                    f"allocations, {v['device_frees']} frees)" for k, v in out.items())
        + f"; the cross step over the sum of the two alone, by round: {[round(r, 4) for r in ratios]}")
    for label, run in runs.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled):
                run[1], _ = run[0](run[1], next(run[2]))
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / profiled
        busy = _union_us(_device_intervals(prof)) / 1e3 / profiled
        out[label].update(wall_ms=wall, busy_ms=busy)
        log(tag, f"profiled {label} step, {profiled} steps: wall {wall:.2f} ms a step, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}% of the wall)")
    return {**out, "ratios": ratios}


def cross_reference(victims, x0, tag="cross"):
    """Phases 5X and 4XV: the cross step of the depth-cut victims (LLaVA or Qwen2-VL: the first 2
    decoder and 2 vision layers; Gemma-3: 6 decoder layers, five sliding-window ones and the global
    one, and 2 vision layers at 4096 patches), from the loaded weights, on the card in bf16 through the kernels
    against the CPU in f32 on the plain path, with the same injected draws, model weights
    CROSS_WEIGHTS: loss, loss_0 and loss_1 within TOL_REF_LOSS relative, the perturbation
    gradient at cosine >= TOL_REF_COSINE."""
    import dataclasses

    import torch

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import VictimSetup
    from adversarialvlm_tpu_torch.attack.step import build_attack_step
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.processors import grid_hw_for, normalize_pixel_inputs
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs

    t0 = time.perf_counter()
    cfg = AttackConfig(exp_name="reference_cross", batch_size=1, grad_accum_steps=1, lr=1e-2, epsilon=0.4)
    gen = torch.Generator().manual_seed(7)
    pairs, noise, cpu_victims = [], [], []
    for v, (n_text, n_vision) in zip(victims, ((2, 2), (6, 2))):
        vc = v.bundle.cfg
        cut = dataclasses.replace(vc, text=dataclasses.replace(vc.text, num_layers=n_text),
                                  vision=dataclasses.replace(vc.vision, num_layers=n_vision))
        a = v.adv_inputs
        inputs = AdvInputs(a.spec, a.tokenizer, [QUESTION], [QUESTION], 1, [TARGET], a.num_image_tokens,
                           a.image_token_id, a.pad_token_id, image_expansion_ids=a.image_expansion_ids)
        grid = grid_hw_for(v.bundle.family, v.adv_processor, (512, 512), cut)  # Qwen2-VL's static grid
        gpu = VictimSetup(f"cut-{v.bundle.family}", make_bundle("cut", v.bundle.family, cut, torch.device("cuda"),
                                                                params=depth_cut(v.bundle.params, n_text, n_vision),
                                                                grid_hw=grid),
                          v.adv_processor, inputs, torch.bfloat16)
        pairs.append(gpu)
        cpu_victims.append(reference_victim(v.bundle.family, cut, gpu.bundle.params, grid, inputs))
        with torch.no_grad():
            pv = normalize_pixel_inputs(v.bundle.family, v.adv_processor.process(
                torch.as_tensor(x0, device="cuda")))["pixel_values"]
        noise.append(torch.randn((1, *pv.shape[1:]), generator=gen))  # one image's pixel layout
    p0 = 0.3 * torch.randn(x0.shape, generator=gen)
    xs = {"t_idx": 0, "rows": [torch.from_numpy(g.adv_inputs.prompt_pool[0, [0]]) for g in pairs],
          "lens": [torch.from_numpy(g.adv_inputs.prompt_lengths[0, [0]]) for g in pairs], "noise": noise}
    x0_d = torch.as_tensor(x0, device="cuda")
    step = build_attack_step([g.handles() for g in pairs], cfg, x0_d, torch.ones_like(x0_d),
                             model_weights=list(CROSS_WEIGHTS), cross=True)
    reset_launches()
    loss, img_loss, ces, _, grad = step.loss_and_grad(p0.cuda(), xs, torch.tensor(cfg.sigma, device="cuda"))
    card = ([float(loss), *[float(w * ce + img_loss) for w, ce in zip(CROSS_WEIGHTS, ces)]], grad.double().cpu())
    counts = launch_counts()
    log("reference", f"{tag} cuda: loss, loss_0, loss_1 = {card[0]} grad_norm={float(grad.norm())} "
        f"T={[g.adv_inputs.max_len for g in pairs]} launches={ {k: n for k, n in counts.items() if n} } "
        f"in {time.perf_counter() - t0:.1f} s")
    want = {"attention_fwd": 2, "attention_bwd_dq": 2, "attention_bwd_dkdv": 2, "flash_full_fwd": 2,
            "flash_full_bwd_dq": 2, "flash_full_bwd_dkdv": 2}
    if any(counts[k] != n for k, n in want.items()) or counts["dgrad"] == 0:
        raise AssertionError(f"cross depth-cut step launched {counts}, expected {want} and dgrad")
    reference = {}
    REFS.submit(tag, {"victims": cpu_victims, "x0": x0, "p0": p0, "steps": [("cross", xs, cfg, CROSS_WEIGHTS)]},
                lambda out: check_step_reference(tag, card, out["steps"]["cross"], reference))
    return reference


JUDGE = "google/gemma-3-4b-it"
SFB_CATEGORIES, SFB_PER_CATEGORY = 2, 8  # phase 4J's SafeBench: categories 1-2 of the held-out questions
JUDGE_REF_LAYERS = 6      # phase 4J's depth-cut judge: five sliding-window layers and the global one
TABLE_SAMPLE = 8          # phase 4J times the token table's two builders on every 8th vocabulary piece


def judge_cli(main, argv):
    """``main(argv)`` of an eval CLI that judges, with cli/judge_common.build_checker wrapped: the
    checker it built and its build seconds, a PathProbe on the judge's bundle, every verdict, the
    launches counted from zero once the judge is built, the judging's wall time and its peak
    device memory from an emptied cache. Returns (main's result, that record)."""
    import torch

    from adversarialvlm_tpu_torch.cli import judge_common
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    rec = {"verdicts": []}
    real = judge_common.build_checker

    def spy(*args, **kw):
        t0 = time.perf_counter()
        checker = real(*args, **kw)
        torch.cuda.synchronize()
        rec["build_s"], rec["checker"] = time.perf_counter() - t0, checker
        evaluate = checker.evaluate_text

        def recording(texts, max_tokens=512):
            out = evaluate(texts, max_tokens=max_tokens)
            rec["verdicts"].extend(out)
            return out

        checker.evaluate_text = recording
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec["probe"] = PathProbe(checker.bundle)
        reset_launches()
        rec["t0"] = time.perf_counter()
        return checker

    judge_common.build_checker = spy
    try:
        result = main(argv)
    finally:
        judge_common.build_checker = real
    torch.cuda.synchronize()
    rec["judge_s"] = time.perf_counter() - rec["t0"]
    probe = rec["probe"]
    probe.finish()
    rec["launches"] = launch_counts()
    rec["peak_GiB"] = max([probe.step_peak / 2**30] + [c["peak_GiB"] for c in probe.chunks])
    return result, rec


def check_judge_calls(stage, rec, n_global):
    """Phase 4J: every verdict parsed; each judge call one prefill with exactly ``n_global`` flash
    forward launches (the global layers) and nothing else, then budget - 1 cached steps that launch
    nothing (the plain sdpa), as judge_prefill counts them. Prints each call's prefill and median
    cached-step time. Returns the calls' (batch, T)."""
    checker, probe = rec["checker"], rec["probe"]
    budget = checker.budget(10)
    bad = [v.thoughts for v in rec["verdicts"] if "unparseable" in v.thoughts or "Error occurred" in v.thoughts]
    calls = probe.chunks
    zero = {k: 0 for k in rec["launches"]}
    want_prefill = {**zero, "flash_fwd": n_global}
    for i, c in enumerate(calls):
        steps = [a.elapsed_time(b) for a, b in zip(c["ends"], c["ends"][1:])]
        log("judge eval", f"{stage} judge call {i}: batch {c['batch']} T={c['T']} prefill_ms={c['prefill_ms']:.2f} "
            f"median cached step ms={statistics.median(steps):.3f} over {len(steps)} steps; call ms "
            f"{c['decode_ms']:.2f}; prefill launches { {k: n for k, n in c['prefill_launches'].items() if n} }")
    log("judge eval", f"{stage}: {len(rec['verdicts'])} verdicts ({sum(not v.is_safe for v in rec['verdicts'])} "
        f"unsafe) in {rec['judge_s']:.2f} s, {len(rec['verdicts']) / rec['judge_s']:.2f} verdicts/s; {len(calls)} "
        f"judge calls; launches {({k: n for k, n in rec['launches'].items() if n})}; peak {rec['peak_GiB']:.3f} GiB")
    if bad:
        raise AssertionError(f"{stage}: {len(bad)} verdicts did not parse, e.g. {bad[0]}")
    if any(c["prefill_launches"] != want_prefill or len(c["ends"]) != budget for c in calls) or any(
            probe.launches["decode_step"].values()) or rec["launches"] != {**zero, "flash_fwd": n_global * len(calls)}:
        raise AssertionError(f"{stage}: expected {n_global} flash_fwd a judge call, nothing else, and "
                             f"{budget} forwards a call")


def judge_call_times(rec):
    """Each judge call's (batch, T, prefill ms, median cached-step ms) from judge_cli's record."""
    return [(c["batch"], c["T"], c["prefill_ms"],
             statistics.median(a.elapsed_time(b) for a, b in zip(c["ends"], c["ends"][1:])))
            for c in rec["probe"].chunks]


def eval_flash_cases(label, chunks, per_call, H, Hkv, D):
    """Phase 4J: the flash forward against its plain version at every distinct attention mask
    that ``chunks`` (a PathProbe's decode calls) prefilled with, timed at the first mask of each
    distinct (batch, T). Returns one entry a (batch, T): that mask's timings, the worst errors
    over its masks, how many masks and calls ran at it, and its launches (``per_call`` a call)."""
    seen, shapes = set(), {}
    for c in chunks:
        seg = c["mask"]
        shape = tuple(seg.shape)
        sh = shapes.setdefault(shape, {"calls": 0, "masks": 0, "errs": []})
        sh["calls"] += 1
        key = (shape, seg.cpu().numpy().tobytes())
        if key in seen:
            continue
        seen.add(key)
        res = flash_case(label, seg, H, Hkv, D, timed=not sh["masks"], backward=False)["flash_fwd"]
        sh.setdefault("timing", res)
        sh["masks"] += 1
        sh["errs"].append((res["rel"], res["abs"]))
    out = [{**sh["timing"], "shape": list(shape), "rel": max(e[0] for e in sh["errs"]),
            "abs": max(e[1] for e in sh["errs"]), "masks": sh["masks"], "calls": sh["calls"],
            "launches": per_call * sh["calls"]} for shape, sh in shapes.items()]
    for e in out:
        log("judge eval", f"{label}: flash_fwd at {e['shape']}: {e['masks']} distinct masks of {e['calls']} calls "
            f"held, worst real row rel {e['rel']:.3g}, max abs {e['abs']:.3g}; {e['launches']} launches")
    return out


def safebench_cli(argv):
    """cli/safebench_test.main(argv) with eval/safebench.run_safebench wrapped: the victim the CLI
    built, a PathProbe on its bundle, the launches counted from zero once it is built, the run's
    wall time. Returns (output directory, that record)."""
    import torch

    from adversarialvlm_tpu_torch.cli import safebench_test
    from adversarialvlm_tpu_torch.eval import safebench
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    rec = {}
    real = safebench.run_safebench

    def spy(victim, *args, **kw):
        rec["victim"] = victim
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        probe = PathProbe(victim.bundle)
        reset_launches()
        t0 = time.perf_counter()
        try:
            return real(victim, *args, **kw)
        finally:
            torch.cuda.synchronize()
            rec["s"] = time.perf_counter() - t0
            probe.finish()
            rec["probe"], rec["launches"] = probe, launch_counts()

    safebench.run_safebench = spy
    try:
        return safebench_test.main(argv), rec
    finally:
        safebench.run_safebench = real


def judge_reference(checker, texts):
    """Phase 4J's reference: the depth-cut judge (the loaded judge's first 6 decoder layers: five
    sliding-window ones and the global one) decodes ``texts`` under the FSM at the checker's
    budget, on the card in bf16 (the flash prefill, plain cached steps) and on the CPU in f32 on
    the plain path. Teacher-forced over prompt + the card's tokens, per (row, step) before the row
    finished: the logits' cosine >= TOL_DECODE_COSINE, each card token legal in the table from the
    state it was chosen in, and within DECODE_MARGIN x max|card - CPU| of the CPU's top
    constrained logit; the card's and the CPU's own constrained decodes both parse."""
    import dataclasses
    import types

    import torch

    from adversarialvlm_tpu_torch.models.generate import _fsm_mask, generate_core
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets

    cfg = checker.bundle.cfg
    cut = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=JUDGE_REF_LAYERS))
    lm = checker.bundle.params["language_model"]
    cut_lm = {**lm, "layers": lm["layers"][:JUDGE_REF_LAYERS]}
    gpu_b = make_bundle("cut-judge", "gemma3", cut, torch.device("cuda"), params={"language_model": cut_lm})
    cpu_b = make_bundle("cut-judge", "gemma3", cut, torch.device("cpu"),
                        params={"language_model": _map(cut_lm, lambda p: p.float().cpu())})
    c = checker.constraint
    cpu_c = types.SimpleNamespace(table=c.table.cpu(), dist=c.dist.cpu(), penalty=c.penalty)
    tok, pad = checker.tokenizer, checker.tokenizer.pad_token_id
    ids_np, am_np = checker._batch_ids(texts)
    ids_np, am_np, _ = pad_to_buckets(ids_np, am_np, pad, len_multiple=64, batch_to=len(texts))
    ids, am = torch.as_tensor(ids_np), torch.as_tensor(am_np)
    budget = checker.budget(10)
    recorded = []

    def recording_forward(params, input_ids, attention_mask, pixel_inputs=None, **kw):
        logits = gpu_b.forward(params, input_ids, attention_mask, pixel_inputs, **kw)
        recorded.append(logits[:, -1].float().cpu())
        return logits

    t0 = time.perf_counter()
    reset_launches()
    tokens = generate_core(
        recording_forward, gpu_b.make_caches, gpu_b.params, ids.cuda(), am.cuda(), None, max_new_tokens=budget,
        min_new_tokens=0, eos_token_ids=gpu_b.eos_token_ids, pad_token_id=pad, cache_dtype=torch.bfloat16,
        logits_last_k=1, constraint=c,
    ).cpu()
    launches = {k: n for k, n in launch_counts().items() if n}
    n = len(recorded)
    card = torch.stack(recorded, dim=1).double()  # (B, n, V)
    seq = torch.cat([ids, tokens[:, : n - 1]], dim=1)
    mask = torch.cat([am, torch.ones((len(texts), n - 1), dtype=am.dtype)], dim=1)
    with torch.no_grad():
        cpu = cpu_b.forward(cpu_b.params, seq, mask, None, logits_last_k=n).double()
        cpu_tokens = generate_core(
            cpu_b.forward, cpu_b.make_caches, cpu_b.params, ids, am, None, max_new_tokens=budget, min_new_tokens=0,
            eos_token_ids=cpu_b.eos_token_ids, pad_token_id=pad, cache_dtype=torch.float32, logits_last_k=1,
            constraint=cpu_c)
    state = torch.zeros(len(texts), dtype=torch.int32)
    is_eos = torch.isin(tokens[:, :n], torch.tensor(gpu_b.eos_token_ids))
    finished_before = torch.zeros_like(is_eos)
    finished_before[:, 1:] = torch.cumsum(is_eos, dim=1)[:, :-1] > 0
    live = ~finished_before
    cos, ok_tok, legal = [], [], []
    for t in range(n):
        m = _fsm_mask(cpu_c.table, cpu_c.dist, state, budget - t, c.penalty).double()
        tok_t = tokens[:, t]
        nxt = cpu_c.table[state.long(), tok_t.long()]
        legal.append((nxt >= 0) | finished_before[:, t])
        cos.append(torch.nn.functional.cosine_similarity(card[:, t], cpu[:, t], dim=-1))
        diff = (card[:, t] - cpu[:, t]).abs().amax(-1)
        cons = cpu[:, t] + m
        gap = cons.amax(-1) - cons.gather(-1, tok_t[:, None].long()).squeeze(-1)
        ok_tok.append((gap <= DECODE_MARGIN * diff) | finished_before[:, t])
        state = torch.where(nxt >= 0, nxt, state)
    cos, ok_tok, legal = torch.stack(cos, 1), torch.stack(ok_tok, 1), torch.stack(legal, 1)
    outs = {"card": [tok.decode(r, skip_special_tokens=True) for r in tokens],
            "cpu": [tok.decode(r, skip_special_tokens=True) for r in cpu_tokens]}
    parsed = {k: [_parses(o) for o in v] for k, v in outs.items()}
    min_cos = float(cos[live].min())
    log("judge eval", f"reference: {len(texts)} rows T={ids.shape[1]} left pads {[int(ids.shape[1] - x) for x in am.sum(1)]}, "
        f"{JUDGE_REF_LAYERS} layers, {n} tokens (budget {budget}), card launches {launches}; min logits cosine "
        f"{min_cos:.6f} (min {TOL_DECODE_COSINE}) over {int(live.sum())} live steps; every card token legal: "
        f"{bool(legal.all())}; within the margin: {bool(ok_tok.all())}; outputs card {outs['card']} cpu "
        f"{outs['cpu']}, parse {parsed}; in {time.perf_counter() - t0:.1f} s")
    if launches != {"flash_fwd": 1}:
        raise AssertionError(f"judge reference: the depth-cut prefill launched {launches}, expected one flash_fwd")
    if not (min_cos >= TOL_DECODE_COSINE and bool(ok_tok.all()) and bool(legal.all())
            and all(parsed["card"]) and all(parsed["cpu"])):
        raise AssertionError("judge reference: the card's constrained decode and the CPU's disagree")
    return {"min_cosine": min_cos, "tokens": n}


def _parses(text):
    try:
        json.loads(text, strict=False)["is_safe"]
    except Exception:
        return False
    return True


def write_safebench(root):
    """Phase 4J's SafeBench directory: categories 1-2, each 8 of the held-out questions, one per
    line as the benchmark's CSVs hold them."""
    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.eval.tables import write_table

    qs = list(corpora.not_safe_questions_test)
    os.makedirs(root, exist_ok=True)
    for i in range(SFB_CATEGORIES):
        write_table(os.path.join(root, f"{i + 1}.csv"), None,
                    [[q] for q in qs[i * SFB_PER_CATEGORY:(i + 1) * SFB_PER_CATEGORY]])
    return root


def judge_eval_phases(ckpt_root, runs, cross_exp):
    """Phase 4J: the three-stage evaluation through the port's CLIs on the card, the judge the
    full Gemma-3-4B-it and the SafeBench victim LLaVA-1.5-7B, both from the directories of 4L and
    4G. A: cli/find_best_iter over 4X's run (test_results_iter_{0,4}.csv, LLaVA's and Gemma's
    answers to its 8 held-out questions), then the depth-cut judge against the CPU, the table's
    two builders on a sample of the judge's vocabulary, and the same CLI again, which judges
    nothing. B: cli/safebench_test on the saved image nearest best.txt whose iteration - 1 is a
    test iteration (>= 0). C: cli/guard_eval over B's answers. After each stage, the flash forward
    against its plain version at every attention mask that stage's prefills ran at, timed once a
    (batch, T). Returns the numbers."""
    import re

    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.cli import find_best_iter as fbi_cli
    from adversarialvlm_tpu_torch.cli import guard_eval as guard_cli
    from adversarialvlm_tpu_torch.eval.tables import read_column, read_table
    from adversarialvlm_tpu_torch.judge.fsm import (RegexDFA, build_token_table_native, build_token_table_plain,
                                                    json_bool_field_pattern, vocab_bytes)
    from adversarialvlm_tpu_torch.models.llama import _layer_sliding_window

    t_phase = time.perf_counter()
    exp = os.path.basename(cross_exp)
    base = ["--judge_model", JUDGE, "--checkpoint_root", ckpt_root, "--device", "cuda"]

    # A. find_best_iter on the full-depth judge
    fbi_args = ["--exps", exp, "--runs_path", runs] + base
    best, a = judge_cli(fbi_cli.main, fbi_args)
    checker = a["checker"]
    t = checker.bundle.cfg.text
    n_global = sum(_layer_sliding_window(t, i) is None for i in range(t.num_layers))
    table = checker.constraint.table
    log("judge eval", f"A: {JUDGE} from {ckpt_root} through cli/find_best_iter.py: judge built in {a['build_s']:.1f} s "
        f"(checkpoint load, tokenizer and the FSM); vocab_bytes {checker.build_seconds['vocab_bytes']:.2f} s, native "
        f"table {checker.build_seconds['table']:.3f} s, dist {checker.build_seconds['dist']:.2f} s; table "
        f"{tuple(table.shape)} {table.dtype} {table.numel() * table.element_size() / 1e6:.1f} MB on the card; "
        f"min_close_tokens {checker.min_close_tokens}, budget {checker.budget(10)} for the CLI's max_tokens 10; "
        f"{t.num_layers} layers, {n_global} global")
    check_judge_calls("A", a, n_global)
    judge_dir = os.path.join(cross_exp, "safety_details", JUDGE.split("/")[-1])
    iters = sorted(int(f[len("test_results_iter_"):-4]) for f in os.listdir(cross_exp)
                   if f.startswith("test_results_iter_"))
    for it in iters:
        names, cols = read_table(os.path.join(cross_exp, f"test_results_iter_{it}.csv"))
        _, details = read_table(os.path.join(judge_dir, f"safety_details_iter_{it}.csv"), sep=";")
        if len(details["model"]) != len(cols[names[0]]) * (len(names) - 1):
            raise AssertionError(f"A: iteration {it}: {len(details['model'])} detail rows, expected "
                                 f"{len(cols[names[0]])} questions x {len(names) - 1} models")
    pivot_path = os.path.join(cross_exp, "unsafe_metrics_models.csv")
    pivot = open(pivot_path, "rb").read()
    p_names, p_cols = read_table(pivot_path)
    best_txt = open(os.path.join(cross_exp, "best.txt")).read()
    log("judge eval", f"A: iterations {iters}; pivot {p_names} rows {p_cols['iteration']}; best.txt {best_txt}; "
        f"CLI result {best}")
    if p_cols["iteration"] != iters or "ALL_MODELS_MEAN" not in p_names or int(best_txt) not in iters:
        raise AssertionError("A: the pivot or best.txt is not what the run's iterations give")
    a_numbers = {"verdicts": len(a["verdicts"]), "verdicts_per_s": len(a["verdicts"]) / a["judge_s"],
                 "calls": len(a["probe"].chunks), "peak_GiB": a["peak_GiB"], "build": checker.build_seconds,
                 "prefill_ms": [c["prefill_ms"] for c in a["probe"].chunks]}

    # the depth-cut judge against the CPU, on two of the judged answers
    answers = [x for x in details["text_answer"] if isinstance(x, str) and x.strip()][:2]
    reference = judge_reference(checker, answers)
    # the table's builders, the host C++ and the plain Python walk, on every TABLE_SAMPLE-th piece
    # of the judge's vocabulary (the walk over all of it would outlast the phase's budget)
    vocab = vocab_bytes(checker.tokenizer)[::TABLE_SAMPLE]
    dfa = RegexDFA.from_pattern(json_bool_field_pattern("is_safe"))
    t0 = time.perf_counter()
    native = build_token_table_native(dfa, vocab)
    t1 = time.perf_counter()
    plain = build_token_table_plain(dfa, vocab)
    t2 = time.perf_counter()
    table_s = {"pieces": len(vocab), "native_s": t1 - t0, "plain_s": t2 - t1}
    log("judge eval", f"A: token table over {len(vocab)} pieces (1 in {TABLE_SAMPLE}) x {dfa.n_states} states: "
        f"native {table_s['native_s']:.3f} s, plain walk {table_s['plain_s']:.2f} s "
        f"({table_s['plain_s'] / table_s['native_s']:.0f}x); x{TABLE_SAMPLE}: plain about "
        f"{TABLE_SAMPLE * table_s['plain_s']:.1f} s over the whole vocabulary")
    if not np.array_equal(native, plain):
        raise AssertionError("A: the native token table differs from the plain walk's")
    judge_kernels = eval_flash_cases("judge call, stage A", a["probe"].chunks, n_global, t.num_heads, t.num_kv_heads,
                                     t.head_dim_)
    del checker, a
    gc.collect()
    torch.cuda.empty_cache()

    again, a2 = judge_cli(fbi_cli.main, fbi_args)
    log("judge eval", f"A again: {len(a2['verdicts'])} verdicts, launches {({k: n for k, n in a2['launches'].items() if n})}, "
        f"pivot unchanged {open(pivot_path, 'rb').read() == pivot}, best {again}")
    if a2["verdicts"] or any(a2["launches"].values()) or open(pivot_path, "rb").read() != pivot or again != best:
        raise AssertionError("A again: the resumed run judged something or changed the pivot")
    del a2
    gc.collect()
    torch.cuda.empty_cache()

    # B. SafeBench on LLaVA-1.5-7B, the image of the iteration + 1 nearest best.txt
    saved = sorted(int(m.group(1)) for f in os.listdir(cross_exp)
                   if (m := re.fullmatch(r"optimized_image_iter_(\d+)\.png", f)))
    usable = [k - 1 for k in saved if k >= 1]  # --iter N reads image N + 1
    if not usable:
        raise AssertionError(f"B: no saved image {saved} has a test iteration (>= 0) before it")
    it = min(usable, key=lambda i: (abs(i - int(best_txt)), i))
    sfb = write_safebench(os.path.join(runs, "SafeBench_Text"))
    tests = os.path.join(runs, "tests_out")
    out, b = safebench_cli(["--exp", exp, "--iter", str(it), "--model_suf", "llava-hf", "--sfb_path", sfb,
                            "--runs_path", runs, "--tests_path", tests, "--checkpoint_root", ckpt_root,
                            "--categories", f"1-{SFB_CATEGORIES}", "--device", "cuda"])
    victim, probe = b["victim"], b["probe"]
    lt = victim.bundle.cfg.text
    zero = {k: 0 for k in b["launches"]}
    for c in probe.chunks:
        log("judge eval", f"B chunk: batch {c['batch']} prefill T={c['T']} prefill_ms={c['prefill_ms']:.2f} "
            f"decode_ms={c['decode_ms']:.2f} ({c['tokens'] / c['decode_ms'] * 1e3:.1f} tokens/s) peak {c['peak_GiB']:.3f} "
            f"GiB prefill launches { {k: n for k, n in c['prefill_launches'].items() if n} }")
    rows = {i: read_column(os.path.join(out, f"{i}.csv")) for i in range(1, SFB_CATEGORIES + 1)}
    tokens = sum(c["tokens"] for c in probe.chunks)
    decode_s = sum(c["decode_ms"] for c in probe.chunks) / 1e3
    log("judge eval", f"B: best.txt {best_txt}, saved images {saved}, so --iter {it} (image {it + 1}); wrote {out}: "
        f"rows {({i: len(r) for i, r in rows.items()})}; {len(probe.chunks)} chunks, {tokens} tokens in "
        f"{decode_s:.2f} s of decode ({tokens / decode_s:.1f} tokens/s); CLI run {b['s']:.1f} s; launches "
        f"{({k: n for k, n in b['launches'].items() if n})}")
    if any(len(r) != SFB_PER_CATEGORY for r in rows.values()) or len(probe.chunks) != SFB_CATEGORIES:
        raise AssertionError(f"B: expected {SFB_CATEGORIES} chunks and {SFB_PER_CATEGORY} rows a category")
    if any(c["prefill_launches"] != {**zero, "flash_fwd": lt.num_layers} for c in probe.chunks) or any(
            probe.launches["decode_step"].values()) or b["launches"] != {**zero, "flash_fwd": lt.num_layers * len(probe.chunks)}:
        raise AssertionError(f"B: expected {lt.num_layers} flash_fwd a prefill and nothing else")
    sfb_kernels = eval_flash_cases("SafeBench prefill, stage B", probe.chunks, lt.num_layers, lt.num_heads,
                                   lt.num_kv_heads, lt.head_dim_)
    b_numbers = {"prefill_ms": [c["prefill_ms"] for c in probe.chunks], "tokens_per_s": tokens / decode_s,
                 "peak_GiB": max(c["peak_GiB"] for c in probe.chunks), "iter": it}
    del victim, probe, b
    gc.collect()
    torch.cuda.empty_cache()

    # C. guard_eval over B's answers with the same judge
    mean, cg = judge_cli(guard_cli.main, [out, "--categories", f"1-{SFB_CATEGORIES}"] + base)
    check_judge_calls("C", cg, n_global)
    guard_kernels = eval_flash_cases("judge call, stage C", cg["probe"].chunks, n_global, t.num_heads, t.num_kv_heads,
                                     t.head_dim_)
    results = read_table(os.path.join(out, "results_gemma.csv"))[1]["asr"]
    g_names, g_cols = read_table(os.path.join(out, "guard_gemma.csv"))
    text = open(os.path.join(out, "mean_result_gemma.txt")).read()
    log("judge eval", f"C: mean ASR {text} (CLI {mean}); results_gemma.csv {results}; guard_gemma.csv columns {g_names} "
        f"of {[len(v) for v in g_cols.values()]}")
    if not (0.0 <= float(text) <= 1.0) or float(text) != mean or len(results) != SFB_CATEGORIES or len(g_names) != \
            SFB_CATEGORIES or any(len(v) != SFB_PER_CATEGORY for v in g_cols.values()):
        raise AssertionError("C: the guard artifacts are not 3 categories of 8 verdicts with a mean in [0, 1]")
    c_numbers = {"verdicts_per_s": len(cg["verdicts"]) / cg["judge_s"], "mean": mean, "out": out,
                 "is_safe": [v.is_safe for v in cg["verdicts"]], "calls": judge_call_times(cg)}
    del cg
    gc.collect()
    torch.cuda.empty_cache()
    log("judge eval", f"phase 4J in {time.perf_counter() - t_phase:.1f} s")
    return {"A": a_numbers, "B": b_numbers, "C": c_numbers, "reference": reference, "table": table_s,
            "kernels": {"judge": [{**e, "stage": "A"} for e in judge_kernels] + [{**e, "stage": "C"} for e in guard_kernels],
                        "safebench": [{**e, "stage": "B"} for e in sfb_kernels]}}


INT8_STEPS = 4            # phase 4Q: the int8 attack CLI, 1 warm-up + 3 timed; save boundaries at iterations 0 and 3
INT8_SAMPLES = 8          # phase 4Q: quantized tensors held against quantize_weight of the dense loaded tensor
BASE_CATEGORIES, BASE_PER_CATEGORY = 1, 8  # phase 4B: categories of each suite, questions or images in each
FIGSTEP_SIDE = 760        # phase 4B: FigStep's typographic images are 760² PNGs
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")


def attack_cli_int8(argv):
    """cli/attack_model.main(argv) with its build_victim wrapped: the victim it built, the load's
    seconds and peak, a PathProbe on its bundle, and the launches counted from zero once it is
    built. Returns (experiment path, that record)."""
    import torch

    from adversarialvlm_tpu_torch.cli import attack_model
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    rec, real = {}, attack_model.build_victim

    def spy(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec["base_bytes"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        victim = real(*args, **kw)
        torch.cuda.synchronize()
        rec["load_s"], rec["load_peak"] = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        rec["victim"] = victim
        torch.cuda.reset_peak_memory_stats()
        rec["probe"] = PathProbe(victim.bundle)
        reset_launches()
        return victim

    attack_model.build_victim = spy
    try:
        exp = attack_model.main(argv)
    finally:
        attack_model.build_victim = real
    torch.cuda.synchronize()
    rec["probe"].finish()
    rec["launches"] = launch_counts()
    return exp, rec


def int8_sampled_tensors(params, path):
    """INT8_SAMPLES quantized linears, spread over the tree, each equal (values and scales) to
    quantize_weight of its dense tensor as loaded from the checkpoint directory in bf16."""
    import torch

    from adversarialvlm_tpu_torch.models.loading import convert_llava_state_dict, named_leaves
    from adversarialvlm_tpu_torch.models.quant import quantize_weight
    from adversarialvlm_tpu_torch.utils.safetensors import read_dir

    got = dict(named_leaves(params))
    dense = dict(named_leaves(convert_llava_state_dict(read_dir(path))))
    qkeys = sorted(k for k in got if k.endswith(".weight_q"))
    sample = qkeys[:: max(1, len(qkeys) // INT8_SAMPLES)][:INT8_SAMPLES]
    bad = []
    for k in sample:
        q, s = quantize_weight(dense[k[: -len("_q")]].to("cuda", torch.bfloat16))
        if not (torch.equal(q, got[k]) and torch.equal(s, got[k[: -len("_q")] + "_scale"])):
            bad.append(k)
    if bad:
        raise AssertionError(f"int8: loaded quantized tensors {bad} differ from quantize_weight of the dense ones")
    return sample


def int8_dgrad_cases(params, vlm_cfg, t_text):
    """llava_dgrad_cases on the int8 tree: each sampled weight is the int8 values in bf16 (exact),
    the operand LinearInt8's backward hands the dgrad kernel (with dy ⊙ s)."""
    import torch

    def w(node):
        return {"weight": node["weight_q"].to(torch.bfloat16)}

    lm, vt = params["language_model"]["layers"][0], params["vision_tower"]["layers"][0]
    shim = {
        "language_model": {"layers": [{"self_attn": {"q_proj": w(lm["self_attn"]["q_proj"])},
                                       "mlp": {"gate_proj": w(lm["mlp"]["gate_proj"]),
                                               "down_proj": w(lm["mlp"]["down_proj"])}}]},
        "vision_tower": {"layers": [{"self_attn": {"q_proj": w(vt["self_attn"]["q_proj"])},
                                     "mlp": {"fc1": w(vt["mlp"]["fc1"]), "fc2": w(vt["mlp"]["fc2"])}}]},
        "multi_modal_projector": {"linear_1": w(params["multi_modal_projector"]["linear_1"])},
    }
    return llava_dgrad_cases(shim, vlm_cfg, t_text)


def int8_reference(victim, x0):
    """Phase 4Q's depth-cut reference: the int8 victim's first 2 decoder and 2 vision layers on the
    card in bf16 (LinearInt8, its backward through dgrad; the batch-1 causal kernels) against the
    same quantized weights on the CPU in f32 on the plain path: the batch-1 step's loss within
    TOL_REF_LOSS relative and gradient cosine >= TOL_REF_COSINE."""
    import dataclasses

    import torch

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import VictimSetup
    from adversarialvlm_tpu_torch.attack.setup import image_processor
    from adversarialvlm_tpu_torch.attack.step import build_attack_step
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs

    vlm_cfg = victim.bundle.cfg
    cut = dataclasses.replace(vlm_cfg, text=dataclasses.replace(vlm_cfg.text, num_layers=2),
                              vision=dataclasses.replace(vlm_cfg.vision, num_layers=2))
    ai1 = victim.adv_inputs
    ai = AdvInputs(ai1.spec, ai1.tokenizer, [QUESTION], [QUESTION], 1, [TARGET], ai1.num_image_tokens,
                   ai1.image_token_id, ai1.pad_token_id)
    gpu_params = depth_cut(victim.bundle.params, 2, 2)
    gpu_v = VictimSetup("cut", make_bundle("cut", "llava", cut, torch.device("cuda"), params=gpu_params),
                        victim.adv_processor, ai, torch.bfloat16)
    cpu_params = _map(gpu_params, lambda p: p.cpu() if p.dtype == torch.int8 else p.float().cpu())
    cpu_v = VictimSetup("cut", make_bundle("cut", "llava", cut, torch.device("cpu"), params=cpu_params),
                        image_processor(cut, x0.shape[1:], "cpu"), ai)
    cfg = AttackConfig(exp_name="reference", batch_size=1, grad_accum_steps=1, lr=1e-2)
    gen = torch.Generator().manual_seed(7)
    xs = {"t_idx": 0, "rows": [torch.from_numpy(ai.prompt_pool[0, [0]])],
          "lens": [torch.from_numpy(ai.prompt_lengths[0, [0]])],
          "noise": [torch.randn((1, 3, 336, 336), generator=gen)]}
    p0 = 0.3 * torch.randn(x0.shape, generator=gen)
    results = {}
    for name, v, dev in (("cpu", cpu_v, "cpu"), ("cuda", gpu_v, "cuda")):
        x0_d = torch.as_tensor(x0, device=dev)
        step = build_attack_step([v.handles()], cfg, x0_d, torch.ones_like(x0_d))
        reset_launches()
        loss, _, _, _, grad = step.loss_and_grad(p0.to(dev), xs, torch.tensor(cfg.sigma, device=dev))
        results[name] = (float(loss), grad.double().cpu(), {k: n for k, n in launch_counts().items() if n})
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, launches) = results["cpu"], results["cuda"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    cos = float((g_cpu * g_gpu).sum() / (g_cpu.norm() * g_gpu.norm()))
    log("int8", f"depth-cut reference (2 + 2 layers of the int8 tree): loss card {l_gpu} cpu {l_cpu}, rel diff "
        f"{rel:.3g} (tol {TOL_REF_LOSS}); grad cosine {cos:.6f} (min {TOL_REF_COSINE}); card launches {launches}")
    if not (rel <= TOL_REF_LOSS and cos >= TOL_REF_COSINE) or not launches.get("dgrad"):
        raise AssertionError("int8 depth-cut reference: card and CPU disagree, or the card's step ran no dgrad")
    return {"loss_rel": rel, "grad_cosine": cos}


def int8_cache_decode(victim, x0):
    """Phase 4Q: the 50 held-out questions as one 50 × 640 test-decode chunk (64 new tokens) on the
    int8 victim with the int8 KV cache, which pick_decode_config takes when a co-resident's
    reserved bytes make the bf16 cache bind (the bf16 batch it would clamp to is printed), then the
    same chunk teacher-forced on the int8 run's tokens through a bf16 cache: each step's last
    logits at cosine >= TOL_DECODE_COSINE (a limit) and the greedy tokens' agreement (a report);
    prefill ms and tokens/s of both, and each prefill's 32 flash forwards."""
    import torch

    from adversarialvlm_tpu_torch.models.generate import (DEFAULT_SLACK_BYTES, _prefill_aux, device_memory_bytes,
                                                          generate_core, max_decode_batch, param_bytes,
                                                          pick_decode_config)
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.utils.batching import pad_to_buckets

    bundle, ai = victim.bundle, victim.adv_inputs
    t = bundle.cfg.text
    qs = list(ai.test_questions)
    inputs = ai.get_inputs_inference_batch(qs)
    ids_np, am_np, _ = pad_to_buckets(inputs["input_ids"], inputs["attention_mask"], ai.pad_token_id,
                                      len_multiple=64, batch_to=len(qs))
    b, T = ids_np.shape
    total = T + DECODE_TOKENS
    per_bf16 = 2 * t.num_layers * t.num_kv_heads * total * t.head_dim_ * 2
    per_i8 = 2 * t.num_layers * t.num_kv_heads * total * (t.head_dim_ + 4) + 4 * t.num_kv_heads * t.head_dim_ * total
    budget = b * (per_bf16 + per_i8) // 2  # between the two caches' needs at b rows
    reserved = device_memory_bytes("cuda") - param_bytes(bundle.params) - DEFAULT_SLACK_BYTES - budget
    bs, dt = pick_decode_config(t, bundle.params, total, b, torch.bfloat16, reserved_bytes=reserved)
    bs16 = max_decode_batch(t, total, bundle.params, cache_bytes=2, reserved_bytes=reserved)
    log("int8", f"decode budget with {reserved / 1e9:.2f} GB reserved by a co-resident: the bf16 cache would clamp "
        f"{b} rows to {bs16}; pick_decode_config gives batch {bs}, cache {dt}")
    if dt != torch.int8 or bs != b or bs16 >= b:
        raise AssertionError("int8: pick_decode_config did not take the int8 cache at the full batch")
    ids, am = (torch.as_tensor(a, device="cuda") for a in (ids_np, am_np))
    with torch.no_grad():
        pixel = victim.adv_processor.process(torch.as_tensor(x0, device="cuda"))
    runs = {}

    def timed(name, run):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        marks, logits = [], []

        def forward(params, input_ids, attention_mask, pixel_inputs=None, **kw):
            if not marks:
                marks.append(PathProbe._event())
            out = bundle.forward(params, input_ids, attention_mask, pixel_inputs, **kw)
            marks.append(PathProbe._event())
            logits.append(out[:, -1].float())
            return out

        tokens = run(forward)
        marks[-1].synchronize()
        prefill_ms, decode_ms = marks[0].elapsed_time(marks[1]), marks[0].elapsed_time(marks[-1])
        runs[name] = {"tokens": tokens, "logits": torch.stack(logits, 1), "prefill_ms": prefill_ms,
                      "tokens_per_s": b * DECODE_TOKENS / decode_ms * 1e3,
                      "peak_GiB": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": {k: n for k, n in launch_counts().items() if n}}
        log("int8", f"{name}: batch {b} T={T} prefill {prefill_ms:.2f} ms, {DECODE_TOKENS} tokens in {decode_ms:.1f} ms "
            f"({runs[name]['tokens_per_s']:.1f} tokens/s), peak {runs[name]['peak_GiB']:.3f} GiB, launches "
            f"{runs[name]['launches']}")
        if runs[name]["launches"] != {"flash_fwd": t.num_layers}:
            raise AssertionError(f"int8 decode ({name}): expected {t.num_layers} flash forwards, the prefill's")

    timed("int8 cache", lambda fwd: generate_core(
        fwd, bundle.make_caches, bundle.params, ids, am, pixel, max_new_tokens=DECODE_TOKENS, min_new_tokens=0,
        eos_token_ids=(), pad_token_id=ai.pad_token_id, cache_dtype=torch.int8, logits_last_k=1))
    tokens = runs["int8 cache"]["tokens"]

    @torch.no_grad()
    def forced(fwd):  # the int8 run's tokens fed through a bf16 cache
        caches = bundle.make_caches(b, total, torch.bfloat16)
        positions, kv_mask, kv_pos = _prefill_aux(am, DECODE_TOKENS)
        fwd(bundle.params, ids, am, pixel, positions=positions, kv_caches=caches, cache_index=0,
            kv_attention_mask=kv_mask, kv_positions=kv_pos, logits_last_k=1)
        ones = torch.ones((b, 1), dtype=am.dtype, device="cuda")
        for step in range(DECODE_TOKENS - 1):
            kv_mask[:, T + step] = 1
            fwd(bundle.params, tokens[:, step:step + 1], ones, None, positions=kv_pos[:, T + step:T + step + 1],
                kv_caches=caches, cache_index=T + step, kv_attention_mask=kv_mask, kv_positions=kv_pos,
                logits_last_k=1)
        return tokens

    timed("bf16 cache, teacher-forced", forced)
    a, c = runs["int8 cache"]["logits"].double(), runs["bf16 cache, teacher-forced"]["logits"].double()
    cos = torch.nn.functional.cosine_similarity(a, c, dim=-1)
    agree = float((c.argmax(-1) == tokens).double().mean())
    log("int8", f"int8 cache against the bf16 cache, teacher-forced over {b} rows x {DECODE_TOKENS} steps: min last-logits "
        f"cosine {float(cos.min()):.6f} (min {TOL_DECODE_COSINE}), median {float(cos.median()):.6f}; greedy tokens "
        f"agree {agree:.4f}")
    if not float(cos.min()) >= TOL_DECODE_COSINE:
        raise AssertionError("int8 decode: the int8 cache's logits disagree with the bf16 cache's")
    return {"batch": b, "T": T, "bf16_batch": bs16, "min_cosine": float(cos.min()), "token_agreement": agree,
            **{f"{k}_{n}": r[k] for n, r in (("int8", runs["int8 cache"]), ("bf16", runs["bf16 cache, teacher-forced"]))
               for k in ("prefill_ms", "tokens_per_s", "peak_GiB")}}


def int8_phases(ckpt_root, runs, evals, dense):
    """Phase 4Q: int8 weights on LLaVA-1.5-7B from 4L's directory and on the Gemma-3-4B-it judge from
    4G's. cli/attack_model.py --int8_weights at batch 1 on the bench's configuration (the one
    question, the one target, a 512² x₀ of 0.47) for INT8_STEPS steps with its test decode: the
    load under quantize-on-load (seconds, resident bytes, quantized fraction, peak within the int8
    tree + the largest dense tensor + 1 GiB), INT8_SAMPLES tensors equal to quantize_weight of the
    dense ones, per step the dense step's 364 dgrad launches, the step ms beside phase 4's dense
    step (``dense``); dgrad at the int8 step's shapes; the depth-cut reference; the int8 KV cache's
    decode chunk. Then cli/guard_eval.py --int8_weights over 4J's SafeBench answers: every verdict
    parses, 5 flash forwards a judge call, prefill and cached-step ms beside 4J's dense judge, the
    verdicts' agreement with it (a report); the flash forward at its masks."""
    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.cli import guard_eval as guard_cli
    from adversarialvlm_tpu_torch.cli.attack_model import resolve_checkpoint
    from adversarialvlm_tpu_torch.models.generate import param_bytes
    from adversarialvlm_tpu_torch.models.llama import _layer_sliding_window
    from adversarialvlm_tpu_torch.models.quant import quantized_fraction
    from adversarialvlm_tpu_torch.utils.png import write_png

    t_phase = time.perf_counter()
    name = "llava-hf/llava-1.5-7b-hf"
    x0 = np.full((3, 512, 512), 0.47, np.float32)
    img = os.path.join(runs, "gray047.png")
    write_png(img, np.full((512, 512, 3), 0.47 * 255, np.float32).astype(np.uint8))
    exp, r = attack_cli_int8(["--model_name", name, "--checkpoint_root", ckpt_root, "--int8_weights",
                              "--batch_size", "1", "--num_iterations", str(INT8_STEPS), "--save_steps", "10",
                              "--prompt", QUESTION, "--target_text", TARGET, "--img_orig", img,
                              "--runs_path", runs, "--exp_name", "chip_smoke_int8", "--device", "cuda"])
    victim, probe = r["victim"], r["probe"]
    params, vlm_cfg = victim.bundle.params, victim.bundle.cfg
    t = vlm_cfg.text
    resident = param_bytes(params)
    largest_dense = max(x.numel() * x.element_size() for x in _leaves(params) if x.dtype != torch.int8)
    limit = r["base_bytes"] + resident + largest_dense + 2**30
    frac = quantized_fraction(params)
    log("int8", f"{name} under quantize-on-load through the CLI: {r['load_s']:.1f} s, resident {resident / 1e9:.3f} GB "
        f"(quantized fraction {frac:.4f}), largest dense tensor {largest_dense / 1e9:.3f} GB, load peak "
        f"{(r['load_peak'] - r['base_bytes']) / 2**30:.3f} GiB above the {r['base_bytes'] / 2**30:.3f} GiB resident before "
        f"(limit {(limit - r['base_bytes']) / 2**30:.3f} GiB)")
    if r["load_peak"] > limit or not 0.9 < frac < 1.0:
        raise AssertionError("int8: the load's peak passed the int8 tree + the largest dense tensor + 1 GiB, or "
                             "the quantized fraction is off")
    sample = int8_sampled_tensors(params, resolve_checkpoint(name, ckpt_root))
    log("int8", f"{len(sample)} sampled tensors equal quantize_weight of the dense loaded ones: {sample}")
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    steps = [x for x in rows if "loss" in x]
    monitors = [x for x in rows if "loss_resaved" in x]
    med = statistics.median(x["step_ms"] for x in steps[1:])
    t_text = int(victim.adv_inputs.max_len)
    launches = r["launches"]
    dg_cases = int8_dgrad_cases(params, vlm_cfg, t_text)
    dg_per_step = sum(c[3] for c in dg_cases)
    per_step = {"dgrad": launches["dgrad"] / len(steps),
                "attention_fwd": (launches["attention_fwd"] - len(monitors) * t.num_layers) / len(steps),
                "attention_bwd_dq": launches["attention_bwd_dq"] / len(steps),
                "attention_bwd_dkdv": launches["attention_bwd_dkdv"] / len(steps)}
    chunks = probe.chunks
    log("int8", f"attack CLI --int8_weights, batch 1, T={t_text}: {len(steps)} steps, losses "
        f"{[round(x['loss'], 4) for x in steps]}, median step_ms (steps 1..{len(steps) - 1}) {med:.2f} against the dense "
        f"step's {dense['median_b1_ms']:.2f} in phase 4 ({med / dense['median_b1_ms']:.3f}x); steps' peak "
        f"{probe.step_peak / 2**30:.3f} GiB (the dense path's {dense['peak_b1_GiB']:.3f}); launches {launches}; per step {per_step} (dgrad expected {dg_per_step}); "
        f"{len(chunks)} test-decode chunks: " + "; ".join(
            f"batch {c['batch']} T={c['T']} prefill {c['prefill_ms']:.2f} ms, {c['tokens'] / c['decode_ms'] * 1e3:.1f} "
            f"tokens/s, peak {c['peak_GiB']:.3f} GiB" for c in chunks))
    if len(steps) != INT8_STEPS or not all(np.isfinite(x["loss"]) and x["grad_norm"] > 0 for x in steps):
        raise AssertionError("int8 attack: missing or non-finite losses, or a zero image gradient")
    if per_step != {"dgrad": dg_per_step, "attention_fwd": t.num_layers, "attention_bwd_dq": t.num_layers,
                    "attention_bwd_dkdv": t.num_layers} or launches["flash_fwd"] != t.num_layers * len(chunks):
        raise AssertionError(f"int8 attack: launches per step {per_step} are not the dense step's")
    dg = check_dgrad(dg_cases, "dgrad int8 step")
    reference = int8_reference(victim, x0)
    decode = int8_cache_decode(victim, x0)
    load_s, step_peak, load_peak = r["load_s"], probe.step_peak / 2**30, (r["load_peak"] - r["base_bytes"]) / 2**30
    del victim, params, probe, r, dg_cases
    gc.collect()
    torch.cuda.empty_cache()

    # the int8 judge over 4J's SafeBench answers
    base = ["--judge_model", JUDGE, "--checkpoint_root", ckpt_root, "--device", "cuda"]
    mean, q = judge_cli(guard_cli.main, [evals["C"]["out"], "--categories", f"1-{SFB_CATEGORIES}", "--int8_weights"] + base)
    checker = q["checker"]
    jt = checker.bundle.cfg.text
    n_global = sum(_layer_sliding_window(jt, i) is None for i in range(jt.num_layers))
    check_judge_calls("Q", q, n_global)
    j_resident, j_frac = param_bytes(checker.bundle.params), quantized_fraction(checker.bundle.params)
    dense_safe, int8_safe = evals["C"]["is_safe"], [v.is_safe for v in q["verdicts"]]
    agree = sum(a == b for a, b in zip(dense_safe, int8_safe)) / max(len(dense_safe), 1)
    calls = judge_call_times(q)
    log("int8", f"judge --int8_weights: built in {q['build_s']:.1f} s, resident {j_resident / 1e9:.3f} GB (quantized "
        f"fraction {j_frac:.4f}); calls (batch, T, prefill ms, median cached-step ms) {[(b_, t_, round(p, 2), round(s_, 3)) for b_, t_, p, s_ in calls]} "
        f"against the dense judge's {[(b_, t_, round(p, 2), round(s_, 3)) for b_, t_, p, s_ in evals['C']['calls']]}; "
        f"{len(int8_safe)} verdicts, agreement with the dense judge {agree:.4f}; mean ASR {mean} (dense "
        f"{evals['C']['mean']}); peak {q['peak_GiB']:.3f} GiB")
    if len(int8_safe) != len(dense_safe) or not 0.5 < j_frac < 1.0:  # its tied 262k embedding stays bf16
        raise AssertionError("int8 judge: a verdict is missing, or the judge was not quantized")
    judge_kernels = eval_flash_cases("int8 judge call", q["probe"].chunks, n_global, jt.num_heads, jt.num_kv_heads,
                                     jt.head_dim_)
    del checker, q
    gc.collect()
    torch.cuda.empty_cache()
    log("int8", f"phase 4Q in {time.perf_counter() - t_phase:.1f} s")
    return {"load_s": load_s, "dgrad": {**dg, "per_step": dg_per_step, "launches": launches["dgrad"]},
            "reference": reference, "decode": decode, "judge_kernels": judge_kernels,
            "numbers": {"resident_GB": resident / 1e9, "quantized_fraction": frac, "step_ms": med,
                        "step_peak_GiB": step_peak, "load_peak_GiB": load_peak,
                        "dense_step_ms": dense["median_b1_ms"], "judge_resident_GB": j_resident / 1e9,
                        "verdict_agreement": agree, "judge_calls": calls, "dense_judge_calls": evals["C"]["calls"]}}


def baseline_datasets(root):
    """Phase 4B's fabricated datasets under ``root`` (the real ones are not in the repository):
    SafeBench_Text with 4J's categories of held-out questions; MM-SafetyBench's
    images/<cat>/SD_TYPO/<id>.jpg (the committed 1024² JPEG fixtures, 4:2:0 and 4:4:4 in turn, as
    its SD images are 1024²) and text/<cat>.json of rephrased questions; FigStep's
    images/<cat>_with_titles/<id>.png, 760² typography-like PNGs (dark bars of seeded lengths on
    white) written by utils/png.py. Returns (sfb path, dataset root, fixture hashes)."""
    import numpy as np

    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.utils.png import write_png

    sfb = write_safebench(os.path.join(root, "SafeBench_Text"))
    ds = os.path.join(root, "datasets")
    qs = list(corpora.not_safe_questions_test)
    names = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
    rng = np.random.default_rng(0)
    for c in range(1, BASE_CATEGORIES + 1):
        d = os.path.join(ds, "MM_SafetyBench", "images", str(c), "SD_TYPO")
        os.makedirs(d)
        entries = {}
        for i in range(BASE_PER_CATEGORY):
            shutil.copy(os.path.join(FIXTURES, names[i % len(names)]), os.path.join(d, f"{i}.jpg"))
            q = qs[(c - 1) * BASE_PER_CATEGORY + i]
            entries[str(i)] = {"Question": q, "Rephrased Question": f"The bottom of the image shows a phrase. {q}",
                               "Rephrased Question(SD)": q}
        os.makedirs(os.path.join(ds, "MM_SafetyBench", "text"), exist_ok=True)
        with open(os.path.join(ds, "MM_SafetyBench", "text", f"{c}.json"), "w") as f:
            json.dump(entries, f)
        d = os.path.join(ds, "FigStep", "images", f"{c}_with_titles")
        os.makedirs(d)
        for i in range(BASE_PER_CATEGORY):
            page = np.full((FIGSTEP_SIDE, FIGSTEP_SIDE, 3), 255, np.uint8)
            for line in range(6):
                y = 60 + line * 110
                page[y:y + 40, 40:40 + int(rng.integers(200, FIGSTEP_SIDE - 80))] = 20
            write_png(os.path.join(d, f"{i}.png"), page)
    with open(os.path.join(FIXTURES, "jpeg_fixtures.json")) as f:
        return sfb, ds, json.load(f)


def baseline_cli(argv, cache):
    """cli/baseline_tests.main(argv) with its build_victim wrapped: the victim is built by the
    first run and handed to the later ones (each CLI run would load it again; 4L times the load),
    a PathProbe on its bundle, its decode configurations and the launches counted from zero once
    it is handed over, the run's wall time. Returns (output directory, that record)."""
    import torch

    from adversarialvlm_tpu_torch.cli import attack_model, baseline_tests
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

    rec, real = {}, attack_model.build_victim

    def spy(*args, **kw):
        if "victim" not in cache:
            t0 = time.perf_counter()
            cache["victim"] = real(*args, **kw)
            cache["load_s"] = time.perf_counter() - t0
        victim = cache["victim"]
        victim.bundle.decode_configs.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec["probe"] = PathProbe(victim.bundle)
        reset_launches()
        rec["t0"] = time.perf_counter()
        return victim

    attack_model.build_victim = spy
    try:
        out = baseline_tests.main(argv)
    finally:
        attack_model.build_victim = real
    torch.cuda.synchronize()
    rec["s"] = time.perf_counter() - rec["t0"]
    rec["probe"].finish()
    rec["launches"] = launch_counts()
    rec["configs"] = cache["victim"].bundle.generate_program_counts()
    return out, rec


def baseline_phases(ckpt_root, runs):
    """Phase 4B: cli/baseline_tests.py on LLaVA-1.5-7B from 4L's directory at its defaults (batch
    8, 128 new tokens, at least 32): the text modes reference, shii and gcg on SafeBench_Text
    category 1, MM-SafetyBench SD_TYPO and FigStep, each over BASE_CATEGORIES (1) categories of 8. Every CSV has
    its 8 rows and no ERROR row; MM-SafetyBench took the batched path in each category (its
    counter); 32 flash forwards a batch-8 prefill and none in a cached step; the flash forward
    against its plain version at every (batch, T, mask) the prefills ran at; prefill ms,
    tokens/s and peak by suite. On the host: the fixtures decode to the SHA-256 of PIL's pixels,
    and the JPEG decode and the resizes are timed per image."""
    import hashlib

    import torch

    from adversarialvlm_tpu_torch.eval import mm_safetybench
    from adversarialvlm_tpu_torch.eval.generation import bucket_hw
    from adversarialvlm_tpu_torch.eval.tables import read_column
    from adversarialvlm_tpu_torch.utils.images import read_rgb, resize_bilinear
    from adversarialvlm_tpu_torch.utils.native import host_library

    t_phase = time.perf_counter()
    sfb, ds, hashes = baseline_datasets(os.path.join(runs, "baselines"))
    t0 = time.perf_counter()
    host_library("jpeg_decode.cpp")  # g++ at first use in a fresh checkout: timed apart from the decodes
    host = {"jpeg library build or load s": time.perf_counter() - t0}
    for name, digest in hashes.items():
        path = os.path.join(FIXTURES, name)
        t0 = time.perf_counter()
        rgb = read_rgb(path)
        host[f"decode_ms {name}"] = 1e3 * (time.perf_counter() - t0)
        got = hashlib.sha256(rgb.tobytes()).hexdigest()
        if got != digest:
            raise AssertionError(f"baselines: {name} decodes to {got}, not PIL's {digest}")
        t0 = time.perf_counter()
        resize_bilinear(rgb, bucket_hw(*rgb.shape[:2]))
        host[f"resize_ms {name} to {bucket_hw(*rgb.shape[:2])}"] = 1e3 * (time.perf_counter() - t0)
    fig = os.path.join(ds, "FigStep", "images", "1_with_titles", "0.png")
    t0 = time.perf_counter()
    page = read_rgb(fig)
    host["read_ms figstep png"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    resize_bilinear(page, bucket_hw(*page.shape[:2]))
    host[f"resize_ms figstep to {bucket_hw(*page.shape[:2])}"] = 1e3 * (time.perf_counter() - t0)
    log("baselines", f"fixtures decode to PIL's SHA-256 {sorted(hashes)}; host ms an image {host}")

    tests = os.path.join(runs, "baselines", "tests")
    common = ["--model", "llava", "--checkpoint_root", ckpt_root, "--sfb_path", sfb, "--dataset_root", ds,
              "--tests_path", tests, "--categories", f"1-{BASE_CATEGORIES}", "--device", "cuda"]
    cache, suites, kernels = {}, {}, []
    batched0 = mm_safetybench.PATH_COUNTS["batched"]
    for mode in ("reference", "shii", "gcg", "mm_safetybench", "figstep"):
        out, rec = baseline_cli(common + ["--mode", mode], cache)
        probe, lt = rec["probe"], cache["victim"].bundle.cfg.text
        chunks = probe.chunks
        csvs = sorted(f for f in os.listdir(out) if f.endswith(".csv"))
        rows = {f: [str(x) for x in read_column(os.path.join(out, f))] for f in csvs}
        errors = [x for r in rows.values() for x in r if x.startswith("ERROR:")]
        zero = {k: 0 for k in rec["launches"]}
        tokens = sum(c["tokens"] for c in chunks)
        decode_s = sum(c["decode_ms"] for c in chunks) / 1e3
        suites[mode] = {"prefill_ms": [c["prefill_ms"] for c in chunks], "shapes": [(c["batch"], c["T"]) for c in chunks],
                        "tokens_per_s": tokens / decode_s, "decode_ms_per_row": 1e3 * decode_s / sum(c["batch"] for c in chunks),
                        "peak_GiB": max(c["peak_GiB"] for c in chunks), "configs": rec["configs"], "s": rec["s"]}
        log("baselines", f"{mode}: wrote {out}: rows {({f: len(r) for f, r in rows.items()})}; {len(chunks)} chunks "
            f"(batch, T) {suites[mode]['shapes']}, prefill ms {[round(x, 2) for x in suites[mode]['prefill_ms']]}, "
            f"{tokens} tokens in {decode_s:.2f} s of decode ({suites[mode]['tokens_per_s']:.1f} tokens/s), peak "
            f"{suites[mode]['peak_GiB']:.3f} GiB; generate_programs {rec['configs']}; launches "
            f"{({k: n for k, n in rec['launches'].items() if n})}; CLI run {rec['s']:.1f} s")
        if csvs != [f"{c}.csv" for c in range(1, BASE_CATEGORIES + 1)] or any(
                len(r) != BASE_PER_CATEGORY for r in rows.values()) or errors:
            raise AssertionError(f"baselines {mode}: expected {BASE_CATEGORIES} CSVs of {BASE_PER_CATEGORY} rows and no "
                                 f"ERROR row, got {({f: len(r) for f, r in rows.items()})}, errors {errors[:2]}")
        if len(chunks) != BASE_CATEGORIES or any(c["batch"] != BASE_PER_CATEGORY for c in chunks):
            raise AssertionError(f"baselines {mode}: expected {BASE_CATEGORIES} decode chunks of batch {BASE_PER_CATEGORY}")
        if any(c["prefill_launches"] != {**zero, "flash_fwd": lt.num_layers} for c in chunks) or any(
                probe.launches["decode_step"].values()) or rec["launches"] != {**zero, "flash_fwd": lt.num_layers * len(chunks)}:
            raise AssertionError(f"baselines {mode}: expected {lt.num_layers} flash_fwd a prefill and nothing else")
        kernels += [{**e, "suite": mode} for e in eval_flash_cases(f"{mode} prefill", chunks, lt.num_layers,
                                                                   lt.num_heads, lt.num_kv_heads, lt.head_dim_)]
        del probe, rec
    if mm_safetybench.PATH_COUNTS != {"batched": batched0 + BASE_CATEGORIES, "per_image": 0}:
        raise AssertionError(f"baselines: MM-SafetyBench left its batched path: {mm_safetybench.PATH_COUNTS}")
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    log("baselines", f"phase 4B in {time.perf_counter() - t_phase:.1f} s")
    return {"suites": suites, "host": host, "kernels": kernels, "seconds": time.perf_counter() - t_phase}


QWEN = "Qwen/Qwen2-VL-2B-Instruct"
STEPS_V = 4               # phase 4V: 1 warm-up + 3 timed; save boundaries at iterations 0 and 3
STEPS_V1 = 2              # phase 4V1: the 1024² source at batch 1, 1 warm-up + 1 timed, no test decode
STEPS_PAIR = 4            # phases 4XV and 4XH: 1 warm-up + 3 timed; save boundaries at iterations 0 and 3
PAIR_ROUNDS, PAIR_TIMED, PAIR_PROFILED = 1, 3, 1  # phases 4XV and 4XH: the cross step beside each victim's alone


def qwen_dgrad_cases(params, vlm_cfg, batch, t_text, n_patches):
    """(rows, O, I, launches per step, weight) of the Qwen2-VL step's dgrad launches: the tower's
    qkv, proj, fc1 and fc2 over the batch's images (each row's EoT noise makes its own), the
    merger's two linears over the merged patches, and the decoder's q, o, gate, up and down over
    its tokens (k and v, 256 wide, stay off the kernel, as the JAX rule keeps them)."""
    from adversarialvlm_tpu_torch.ops.kernels.dgrad import dgrad_eligible

    v, t = vlm_cfg.vision, vlm_cfg.text
    blk, m = params["visual"]["blocks"][0], params["visual"]["merger"]
    lm = params["language_model"]["layers"][0]
    rows_v, rows_m, rows_t = batch * n_patches, batch * n_patches // v.spatial_merge_size**2, batch * t_text
    linears = [
        (rows_v, blk["attn"]["qkv"], v.num_layers), (rows_v, blk["attn"]["proj"], v.num_layers),
        (rows_v, blk["mlp"]["fc1"], v.num_layers), (rows_v, blk["mlp"]["fc2"], v.num_layers),
        (rows_m, m["mlp_0"], 1), (rows_m, m["mlp_2"], 1),
        (rows_t, lm["self_attn"]["q_proj"], t.num_layers), (rows_t, lm["self_attn"]["o_proj"], t.num_layers),
        (rows_t, lm["mlp"]["gate_proj"], 2 * t.num_layers), (rows_t, lm["mlp"]["down_proj"], t.num_layers),
    ]
    off = (lm["self_attn"]["k_proj"]["weight"], lm["self_attn"]["v_proj"]["weight"])
    if any(dgrad_eligible(w) for w in off) or not all(dgrad_eligible(p["weight"]) for _, p, _ in linears):
        raise AssertionError("qwen2vl: the dgrad-eligible linears are not the expected ones")
    merged, weights = {}, {}
    for rows, p, n in linears:
        key = (rows, *p["weight"].shape)
        merged[key] = merged.get(key, 0) + n
        weights[key] = p["weight"]
    return [(*key, n, weights[key]) for key, n in merged.items()]


def attack_cli(argv, captured=None):
    """cli/attack_model.main on ``argv``, spied on as :func:`spied_cli` does."""
    from adversarialvlm_tpu_torch.cli import attack_model

    return spied_cli(attack_model.main, argv, captured)


def per_step_launches(probes, launches, steps, by_head_dim=False):
    """Each kernel's launches a step of a run, from its total ``launches`` (by head dim: the
    attention entries' ``"<name>_d<D>"`` counts): the step's forwards (the probes' "step" phase)
    and the backward (what launched outside every forward)."""
    counts = [p.launches_d if by_head_dim else p.launches for p in probes]
    fwd = {k: sum(c[ph][k] for c in counts for ph in c) for k in launches}
    return {k: (sum(c["step"][k] for c in counts) + launches[k] - fwd[k]) / steps for k in launches}


def decode_chunks(tag, probe, n_layers):
    """The test-decode chunks of a probe: each logged (prefill ms, tokens/s, peak); exactly
    ``n_layers`` flash forwards a prefill and no kernel in a cached step."""
    for c in probe.chunks:
        n_fwd = len(c["ends"])
        log(tag, f"test decode chunk: batch {c['batch']} prefill T={c['T']} prefill_ms={c['prefill_ms']:.2f} "
            f"decode_ms={c['decode_ms']:.2f} ({n_fwd} forwards, "
            f"{(c['decode_ms'] - c['prefill_ms']) / max(n_fwd - 1, 1):.2f} ms per cached step) tokens/s="
            f"{c['tokens'] / c['decode_ms'] * 1e3:.1f} peak_memory_GiB={c['peak_GiB']:.3f} prefill launches="
            f"{ {k: n for k, n in c['prefill_launches'].items() if n} }")
        if c["prefill_launches"]["flash_fwd"] != n_layers or sum(c["prefill_launches"].values()) != n_layers:
            raise AssertionError(f"{tag}: a decode prefill launched {c['prefill_launches']}")
    if sum(probe.launches["decode_step"].values()):
        raise AssertionError(f"{tag}: a cached decode step launched a kernel")
    return [{"batch": c["batch"], "T": c["T"], "prefill_ms": c["prefill_ms"],
             "tokens_per_s": c["tokens"] / c["decode_ms"] * 1e3, "peak_GiB": c["peak_GiB"]} for c in probe.chunks]


def qwen_phases(ckpt_root, runs):
    """Phases 4V, 5V, 4V1 and 4P on Qwen2-VL-2B-Instruct at full width and depth; the checkpoint
    directory stays under ``ckpt_root`` for 4XV. Returns the phases' numbers and kernel statistics."""
    import dataclasses

    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import VictimSetup, train
    from adversarialvlm_tpu_torch.attack.io import load_image_chw
    from adversarialvlm_tpu_torch.attack.setup import image_processor
    from adversarialvlm_tpu_torch.attack.step import sample_chunk_xs
    from adversarialvlm_tpu_torch.cli import test_post
    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import MODELS, fabricate
    from adversarialvlm_tpu_torch.eval.tables import read_rows
    from adversarialvlm_tpu_torch.models.loading import named_leaves
    from adversarialvlm_tpu_torch.models.qwen2vl import init_params
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.processors import grid_hw_for
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs
    from adversarialvlm_tpu_torch.utils.png import write_png

    t_phase = time.perf_counter()
    _, make_cfg, dtype = MODELS["qwen2vl-2b"]
    vlm_cfg = make_cfg()
    t, v = vlm_cfg.text, vlm_cfg.vision
    # 4V. the directory from the seed-0 parameters drawn on the card; the CLI loads it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = init_params(torch.Generator(device="cuda").manual_seed(0), vlm_cfg, dtype, "cuda")
    path = fabricate("qwen2vl-2b", ckpt_root, params=written)
    write_s = time.perf_counter() - t0
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in shards)
    log("qwen", f"{sum(x.numel() for x in _leaves(written)) / 1e9:.3f} B seed-0 parameters drawn on the card and "
        f"written to {path} in {write_s:.1f} s: {len(shards)} shards, {nbytes / 1e9:.3f} GB, files {sorted(os.listdir(path))}")
    gray = os.path.join(os.path.dirname(os.path.abspath(__file__)), "images", "gray.png")
    # scripts/attacks/attack_clamp_tanh_qwen2vl.sh on one card: gray.png, the list prompts, the
    # target, lr 1e-2, batch 2 (its mesh flags belong to the JAX package's TP/DP layout)
    argv = ["--exp_name", "qwen", "--img_orig", gray, "--prompt", "list", "--target_text", TARGET,
            "--model_name", QWEN, "--checkpoint_root", ckpt_root, "--lr", "1e-2", "--num_iterations",
            str(STEPS_V), "--save_steps", "10", "--batch_size", "2", "--runs_path", runs]
    got = {}
    t0 = time.perf_counter()
    exp = attack_cli(argv, got)
    cli_s = time.perf_counter() - t0
    victim = got["victims"][0]
    loaded, want = dict(named_leaves(victim.bundle.params)), dict(named_leaves(written))
    want_cfg = dataclasses.replace(vlm_cfg, extra_eos_token_ids=(vlm_cfg.pad_token_id,))  # generation_config.json
    if set(loaded) != set(want) or any(not torch.equal(loaded[k], want[k].to(loaded[k].dtype)) for k in want) \
            or victim.bundle.cfg != want_cfg:
        raise AssertionError("qwen: the CLI's victim is not the written directory's")
    del written, loaded, want
    gc.collect()
    rows, steps, csvs = read_run(exp)
    probe = got["probes"][0]
    ai = victim.adv_inputs
    _, gh, gw = victim.adv_processor.grid_thw((512, 512))
    t_text, n_patch = int(ai.max_len), gh * gw
    run_launches = got["launches"]
    log("qwen", f"{QWEN} through cli/attack_model.py in {cli_s:.1f} s (train() {got['wall_s']:.1f} s): every "
        f"tensor equal to the written one, config {QWEN}'s with generation_config.json's eos ids; pool "
        f"{ai.prompt_pool.shape} (targets, questions, T), {ai.num_image_tokens} image tokens (512² -> 504², "
        f"{n_patch} patches), tokenizer {type(ai.tokenizer).__name__} of {ai.tokenizer.vocab_size}")
    for r in steps:
        log("qwen", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    step_peak = probe.step_peak / 2**30
    if len(steps) != STEPS_V or not all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps):
        raise AssertionError(f"qwen path: bad steps {[(r['loss'], r['grad_norm']) for r in steps]}")
    cfg = run_config(exp)
    xs = sample_chunk_xs(torch.Generator().manual_seed(cfg.seed), 1, cfg, [victim.handles()])[0]
    seg = (torch.arange(t_text)[None, :] >= t_text - xs["lens"][0][:, None]).to(torch.int32).cuda()
    pad = t_text - int(xs["lens"][0][0])
    dg = check_dgrad(qwen_dgrad_cases(victim.bundle.params, vlm_cfg, 2, t_text, n_patch), "dgrad qwen2vl batch 2")
    per_step = per_step_launches([probe], got["launches"], STEPS_V)
    expected = {k: 0 for k in per_step}
    expected.update({"dgrad": dg["per_step"], "flash_fwd": t.num_layers, "flash_bwd_dq": t.num_layers,
                     "flash_bwd_dkdv": t.num_layers})
    log("qwen", f"launches over the run: {got['launches']}; by phase: "
        + "; ".join(f"{ph} x{probe.calls[ph]} {dict(+c)}" for ph, c in probe.launches.items()))
    log("qwen", f"launches per step: { {k: n for k, n in per_step.items() if n} } (expected "
        f"{ {k: n for k, n in expected.items() if n} }); the tower at {n_patch} patches takes the plain sdpa")
    if per_step != expected:
        raise AssertionError("qwen path: launches per step differ from the expected counts")
    chunks = decode_chunks("qwen", probe, t.num_layers)
    boundaries = [0, STEPS_V - 1]
    test_qs = ai.test_questions
    if sorted(csvs) != sorted(f"test_results_iter_{i}.csv" for i in boundaries) or not all(
            [r[0] for r in tab[1:]] == list(test_qs) and tab[0] == ["question", QWEN] for tab in csvs.values()):
        raise AssertionError(f"qwen path: test CSVs {sorted(csvs)}")
    flash = flash_case("qwen2vl batch-2 step", seg, t.num_heads, t.num_kv_heads, t.head_dim_, timed=True)
    masks = sorted({(c["batch"], c["T"]) for c in probe.chunks})
    prefill = flash_case("qwen2vl test-decode prefill", probe.chunks[0]["mask"].cuda(), t.num_heads, t.num_kv_heads,
                         t.head_dim_, timed=True, backward=False)["flash_fwd"]
    attn = attention_case(t_text, t.num_heads, t.num_kv_heads, t.head_dim_, pad, timed=True)
    log("qwen", f"4V: median step_ms (steps 1..{STEPS_V - 1})={med:.2f} warm-up {steps[0]['step_ms']:.2f}; steps' peak "
        f"{step_peak:.3f} GiB; decode chunks (batch, T) {masks}; kernels held at the run's shapes")

    # 5V. depth-cut references: the first 2 decoder and 2 vision layers, the card in bf16 through
    # the kernels against the CPU in f32 on the plain path
    t0 = time.perf_counter()
    cut = dataclasses.replace(vlm_cfg, text=dataclasses.replace(t, num_layers=2),
                              vision=dataclasses.replace(v, num_layers=2))
    questions = [QUESTION, QUESTION + " Explain every step in detail, please."]
    ref_ai = AdvInputs(ai.spec, ai.tokenizer, questions, [QUESTION], 2, [TARGET], ai.num_image_tokens,
                       ai.image_token_id, ai.pad_token_id)
    grid = grid_hw_for("qwen2vl", victim.adv_processor, (512, 512), cut)
    gpu_v = VictimSetup("cut", make_bundle("cut", "qwen2vl", cut, torch.device("cuda"),
                                           params=depth_cut(victim.bundle.params, 2, 2), grid_hw=grid),
                        victim.adv_processor, ref_ai, torch.bfloat16)
    x0 = load_image_chw(gray)
    gen = torch.Generator().manual_seed(5)
    p0 = 0.3 * torch.randn(x0.shape, generator=gen)
    noise = torch.randn((2, n_patch, 3 * v.temporal_patch_size * v.patch_size**2), generator=gen)
    reference = card_step_references("qwen2vl", gpu_v, cut, grid, cfg, x0, p0, (("batch 1", [0]), ("batch 2", [0, 1])),
                                     noise, {"flash_fwd": cut.text.num_layers})
    log("reference", f"qwen2vl references' card half in {time.perf_counter() - t0:.1f} s")
    del gpu_v
    gc.collect()

    # 4V1. batch 1 from a 1024² source (980², 4900 patches): the tower takes flash_full at head_dim 80
    t0 = time.perf_counter()
    big = os.path.join(runs, "x0_1024.png")
    write_png(big, np.full((1024, 1024, 3), 120, np.uint8))
    x1 = load_image_chw(big)
    proc1 = image_processor(vlm_cfg, (1024, 1024), "cuda")
    _, gh1, gw1 = proc1.grid_thw((1024, 1024))
    n_img1, n_patch1 = proc1.num_image_tokens((1024, 1024)), gh1 * gw1
    ai1 = AdvInputs(ai.spec, ai.tokenizer, [QUESTION], [QUESTION], 1, [TARGET], n_img1, ai.image_token_id,
                    ai.pad_token_id)
    victim1 = VictimSetup(QWEN, make_bundle(QWEN, "qwen2vl", victim.bundle.cfg, torch.device("cuda"),
                                            params=victim.bundle.params,
                                            grid_hw=grid_hw_for("qwen2vl", proc1, (1024, 1024))),
                          proc1, ai1, torch.bfloat16)
    cfg1 = AttackConfig(exp_name="qwen_1024", num_iterations=STEPS_V1, save_steps=10, batch_size=1, lr=1e-2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe1 = PathProbe(victim1.bundle)
    reset_launches()
    try:
        exp1 = train(cfg1, [victim1], x1, base_path=runs, device="cuda", run_tests=False)
        torch.cuda.synchronize()
    finally:
        probe1.finish()
    launches1 = launch_counts()
    _, steps1, _ = read_run(exp1)
    t1 = int(ai1.max_len)
    dg1 = check_dgrad(qwen_dgrad_cases(victim.bundle.params, vlm_cfg, 1, t1, n_patch1), "dgrad qwen2vl 1024²")
    per_step1 = per_step_launches([probe1], launches1, STEPS_V1)
    expected1 = {k: 0 for k in per_step1}
    expected1.update({"dgrad": dg1["per_step"], "attention_fwd": t.num_layers, "attention_bwd_dq": t.num_layers,
                      "attention_bwd_dkdv": t.num_layers, "flash_full_fwd": v.num_layers,
                      "flash_full_bwd_dq": v.num_layers, "flash_full_bwd_dkdv": v.num_layers})
    for r in steps1:
        log("qwen 1024", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} step_ms={r['step_ms']:.2f}")
    log("qwen 1024", f"batch 1, {n_img1} image tokens (T={t1}), tower {n_patch1} patches: launches over the run "
        f"{ {k: n for k, n in launches1.items() if n} }; per step { {k: n for k, n in per_step1.items() if n} } "
        f"(expected { {k: n for k, n in expected1.items() if n} }); steps' peak {probe1.step_peak / 2**30:.3f} GiB")
    if per_step1 != expected1 or len(steps1) != STEPS_V1 or not all(
            np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps1):
        raise AssertionError("qwen 1024² path: steps or launches differ from the expected")
    full80 = flash_full_case("qwen2vl 1024² tower", 1, v.num_heads, n_patch1, v.embed_dim // v.num_heads, timed=True)
    flash_full_case("qwen2vl tower, two images", 2, v.num_heads, 2116, v.embed_dim // v.num_heads)
    attention_case(t1, t.num_heads, t.num_kv_heads, t.head_dim_, t1 - int(ai1.prompt_lengths[0, 0]))
    v1 = {"median_ms": statistics.median(r["step_ms"] for r in steps1[1:]), "peak_GiB": probe1.step_peak / 2**30,
          "launches": launches1, "T": t1, "patches": n_patch1, "seconds": time.perf_counter() - t0}
    log("qwen 1024", f"4V1 in {v1['seconds']:.1f} s")
    del victim1, probe1
    gc.collect()
    torch.cuda.empty_cache()

    # 4P. cli/test_post.py over 4V's saved images, on the same victim loaded again by the CLI
    t0 = time.perf_counter()
    images = sorted(int(f[len("optimized_image_iter_"):-4]) for f in os.listdir(exp)
                    if f.startswith("optimized_image_iter_") and f.endswith(".png")
                    and f[len("optimized_image_iter_"):-4].isdigit())
    name = os.path.basename(exp)
    del victim, got, probe
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = test_post.main(["--exp", name, "--model_name", QWEN, "--checkpoint_root", ckpt_root, "--runs_path", runs,
                          "--question_set_name", "held_out", "--iterations", *map(str, images), "--device", "cuda"])
    torch.cuda.synchronize()
    post_launches = launch_counts()
    summary = read_rows(os.path.join(out, "summary.csv"))
    files = sorted(os.listdir(out))
    log("post", f"cli/test_post.py over {name}'s images {images} in {time.perf_counter() - t0:.1f} s: {files}; summary "
        f"{summary}; launches { {k: n for k, n in post_launches.items() if n} }; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if [r["iteration"] for r in summary] != images or any(
            len(read_rows(os.path.join(out, f"test_results_iter_{it}.csv"))) != len(test_qs) for it in images):
        raise AssertionError("4P: summary.csv lacks a row, or an iteration's CSV lacks its questions")
    if post_launches["flash_fwd"] == 0 or post_launches["flash_fwd"] % t.num_layers or \
            sum(post_launches.values()) != post_launches["flash_fwd"]:
        raise AssertionError(f"4P: the re-test decode launched {post_launches}")
    log("qwen", f"phases 4V, 5V, 4V1 and 4P in {time.perf_counter() - t_phase:.1f} s")
    return {"median_ms": med, "step_peak_GiB": step_peak, "chunks": chunks, "reference": reference, "v1": v1,
            "stats": {"dgrad": dg, **flash, **attn}, "prefill": prefill, "dgrad1": dg1, "full80": full80,
            "launches": run_launches, "per_step": per_step, "post": {"images": images, "summary": summary},
            "seconds": time.perf_counter() - t_phase, "write_s": write_s, "GB": nbytes / 1e9}


def pair_cross_phase(tag, names, labels, ckpt_root, runs, extra, dgrad_cases, kernel_cases, reference=False,
                     n_steps=STEPS_PAIR, profile=True):
    """Phases 4XV, 4XH and 4X3: a one-card cross attack script through cli/crossattack_models.py, the
    victims ``names`` loaded from the directories of earlier phases and resident on the card (ε 0.4,
    batch 1, random targets, the list prompts, ``extra`` arguments; ``n_steps`` steps): a cross step
    launches exactly each victim's own, also by head dim (:func:`cross_step_share`), the dgrad
    kernel at the run's shapes (``dgrad_cases(victims, T)``), the test decode (cut as
    :func:`spied_cli`'s ``decode_cut``) of each victim whose decoder runs the flash kernels (Gemma-3's
    runs masked, on the plain path), each tree's resident GB, the attention kernels at the run's shapes
    (``kernel_cases(victims, T, pads, probes)``), with ``profile`` the cross step beside each
    victim's alone (``labels``) in turns and under torch.profiler, the steps' peak and, with
    ``reference`` (True: :func:`cross_reference`, or a function of the victims and x0), the depth-cut
    cross reference."""
    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.io import load_image_chw
    from adversarialvlm_tpu_torch.attack.step import sample_chunk_xs
    from adversarialvlm_tpu_torch.models.generate import param_bytes
    from adversarialvlm_tpu_torch.models.quant import quantized_fraction

    t_phase = time.perf_counter()
    gray = os.path.join(os.path.dirname(os.path.abspath(__file__)), "images", "gray.png")
    x0 = load_image_chw(gray)
    argv = ["--exp_name", "cross_" + "_".join(labels), "--img_orig", gray, "--prompt", "list", "--target_text",
            TARGET, "--model_names", ",".join(names), *extra, "--lr", "1e-2", "--num_iterations", str(n_steps),
            "--save_steps", "10", "--batch_size", "1", "--epsilon", "0.4", "--target_text_random",
            "--checkpoint_root", ckpt_root, "--runs_path", runs]
    got = {}
    t0 = time.perf_counter()
    exp = cross_cli(argv, got, decode_cut=True)
    cli_s = time.perf_counter() - t0
    _, steps, csvs = read_run(exp)
    victims, probes = got["victims"], got["probes"]
    cfg = run_config(exp)
    ai = [v.adv_inputs for v in victims]
    ts = [int(a.max_len) for a in ai]
    resident = {v.name: (param_bytes(v.bundle.params) / 1e9, quantized_fraction(v.bundle.params)) for v in victims}
    log(tag, f"{names} through cli/crossattack_models.py {' '.join(extra)} in {cli_s:.1f} s (train() "
        f"{got['wall_s']:.1f} s): epsilon={cfg.epsilon} weights {cfg.model_weights} batch {cfg.batch_size}, pools "
        f"{[a.prompt_pool.shape for a in ai]}; resident GB (quantized fraction) "
        f"{ {k: (round(g, 3), round(f, 4)) for k, (g, f) in resident.items()} }, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    for r in steps:
        log(tag, f"step {r['iteration']}: loss={r['loss']} "
            + " ".join(f"loss_{i}={r[f'loss_{i}']}" for i in range(len(names)))
            + f" grad_norm={r['grad_norm']} target_idx={r['target_idx']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    step_peak = max(p.step_peak for p in probes) / 2**30
    int8 = "--int8_weights" in extra
    if cfg.epsilon != 0.4 or len(steps) != n_steps or not all(
            np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps) or not all(
            (0.9 < f < 1.0) if int8 else f == 0 for _, f in resident.values()):
        raise AssertionError(f"{tag} path: bad steps, epsilon or quantized fraction")
    dg = check_dgrad(dgrad_cases(victims, ts), f"dgrad {tag} step")
    per_step = per_step_launches(probes, got["launches"], n_steps)
    per_step_d = per_step_launches(probes, got["launches_d"], n_steps, by_head_dim=True)
    check_cross_launches(tag, per_step, per_step_d, *cross_step_share(victims, dg["per_step"]))
    chunks = {}
    for v, p in zip(victims, probes):
        if v.bundle.family != "gemma3":
            chunks[v.name] = decode_chunks(tag, p, n_self_layers(v.bundle.cfg.text))
            continue
        for c in p.chunks:  # Gemma's decoder layers are all masked: no kernel in its prefill but the tower's
            log(tag, f"Gemma test decode chunk: batch {c['batch']} T={c['T']} prefill_ms={c['prefill_ms']:.2f} "
                f"prefill launches { {k: n for k, n in c['prefill_launches'].items() if n} }")
    if sorted(csvs) != sorted(f"test_results_iter_{i}.csv" for i in (0, n_steps - 1)) or not all(
            tab[0] == ["question", *names] and len(tab) == 1 + len(ai[0].test_questions) for tab in csvs.values()):
        raise AssertionError(f"{tag} path: test CSVs {sorted(csvs)}")
    xs = sample_chunk_xs(torch.Generator().manual_seed(cfg.seed), 1, cfg, [v.handles() for v in victims])[0]
    pads = [t - int(xs["lens"][i][0]) for i, t in enumerate(ts)]
    attn = kernel_cases(victims, ts, pads, probes)
    profiled = profile_cross(victims, cfg, x0, labels=labels, rounds=PAIR_ROUNDS, timed=PAIR_TIMED,
                             profiled=PAIR_PROFILED, tag=tag) if profile else None
    ref = (reference(victims, x0) if callable(reference) else cross_reference(victims, x0, tag=tag) if reference
           else None)
    log(tag, f"median step_ms (steps 1..{n_steps - 1})={med:.2f}; steps' peak {step_peak:.3f} GiB; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    out = {"median_ms": med, "step_peak_GiB": step_peak, "per_step": per_step, "per_step_d": per_step_d,
           "launches_d": got["launches_d"], "profiled": profiled, "reference": ref, "dgrad": dg, "attention": attn,
           "chunks": chunks, "resident": resident, "T": ts, "seconds": time.perf_counter() - t_phase}
    del victims, got, probes
    gc.collect()
    torch.cuda.empty_cache()
    return out


def qwen_cross_phases(ckpt_root, runs):
    """Phase 4XV: scripts/attacks/attack_cross_onechip.sh, Qwen2-VL-2B (the directory of 4V) and
    Gemma-3-4B-it (4G's), model weights 1.0 and 0.5, through :func:`pair_cross_phase`: the batch-1
    causal kernels at Qwen's T and its test-decode prefills, and the depth-cut cross reference."""
    def dgrad_cases(victims, ts):
        (qv, gv), (t_q, t_g) = victims, ts
        _, gh, gw = qv.adv_processor.grid_thw((512, 512))
        return (qwen_dgrad_cases(qv.bundle.params, qv.bundle.cfg, 1, t_q, gh * gw)
                + gemma_dgrad_cases(gv.bundle.params, gv.bundle.cfg, 1, t_g))

    def kernel_cases(victims, ts, pads, probes):
        t = victims[0].bundle.cfg.text
        attn = attention_case(ts[0], t.num_heads, t.num_kv_heads, t.head_dim_, pads[0], timed=True)
        for mask in {tuple(c["mask"].shape): c["mask"] for c in probes[0].chunks}.values():
            flash_case("cross qwen test-decode prefill", mask.cuda(), t.num_heads, t.num_kv_heads, t.head_dim_,
                       backward=False)
        return attn

    return pair_cross_phase("cross qwen", [QWEN, JUDGE], ("qwen2vl", "gemma3"), ckpt_root, runs,
                            ["--model_weights", "1.0", "0.5"], dgrad_cases, kernel_cases, reference=True)


PHI = "microsoft/Phi-3.5-vision-instruct"
LLAVA = "llava-hf/llava-1.5-7b-hf"
STEPS_H = 4               # phase 4H: 1 warm-up + 3 timed; save boundaries at iterations 0 and 3


def phi_dgrad_cases(params, vlm_cfg, batch, t_text, n_tiles, n_img):
    """(rows, O, I, launches per step, weight) of the Phi-3.5-vision step's dgrad launches: the CLIP
    tower's q/k/v/out, fc1 and fc2 over the batch's used tiles (``n_tiles`` a row, 577 tokens each;
    the layers up to feature layer -2), the projection's two linears over the rows' ``n_img`` image
    tokens, and the decoder's q, k, v, o (3072² each: 32 MHA heads of 96), gate, up and down over its
    tokens (the lm_head, 32064 rows, stays off the kernel). An int8 tree gives each weight as its
    int8 values in bf16, the operand LinearInt8's backward hands the kernel (with dy ⊙ s)."""
    import torch

    from adversarialvlm_tpu_torch.ops.kernels.dgrad import dgrad_eligible

    def w(node):
        return node["weight"] if "weight" in node else node["weight_q"].to(torch.bfloat16)

    v, t = vlm_cfg.vision, vlm_cfg.text
    n_vis = v.num_layers + 1 + vlm_cfg.vision_feature_layer
    vt, lm = params["img_processor"]["layers"][0], params["language_model"]["layers"][0]
    rows_v = batch * n_tiles * ((v.image_size // v.patch_size) ** 2 + 1)
    rows_p, rows_t = batch * n_img, batch * t_text
    linears = [
        (rows_v, w(vt["self_attn"]["q_proj"]), 4 * n_vis), (rows_v, w(vt["mlp"]["fc1"]), n_vis),
        (rows_v, w(vt["mlp"]["fc2"]), n_vis), (rows_p, w(params["img_projection_0"]), 1),
        (rows_p, w(params["img_projection_2"]), 1), (rows_t, w(lm["self_attn"]["q_proj"]), 4 * t.num_layers),
        (rows_t, w(lm["mlp"]["gate_proj"]), 2 * t.num_layers), (rows_t, w(lm["mlp"]["down_proj"]), t.num_layers),
    ]
    others = [lm["self_attn"][n] for n in ("k_proj", "v_proj", "o_proj")] + [lm["mlp"]["up_proj"]]
    if not all(dgrad_eligible(x) for _, x, _ in linears) or not all(dgrad_eligible(w(n)) for n in others) \
            or dgrad_eligible(w(params["language_model"]["lm_head"])):
        raise AssertionError("phi3v: the dgrad-eligible linears are not the expected ones")
    merged, weights = {}, {}
    for rows, x, n in linears:
        key = (rows, *x.shape)
        merged[key] = merged.get(key, 0) + n
        weights[key] = x
    return [(*key, n, weights[key]) for key, n in merged.items()]


def phi_phases(ckpt_root, runs):
    """Phases 4H and 5H on Phi-3.5-vision at full width and depth; the checkpoint directory stays
    under ``ckpt_root`` for 4XH. Returns the phases' numbers and kernel statistics."""
    import dataclasses

    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.engine import VictimSetup
    from adversarialvlm_tpu_torch.attack.io import load_image_chw
    from adversarialvlm_tpu_torch.attack.step import sample_chunk_xs
    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import MODELS, fabricate
    from adversarialvlm_tpu_torch.models.loading import named_leaves
    from adversarialvlm_tpu_torch.models.phi3v import init_params
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.processors import grid_hw_for
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs

    t_phase = time.perf_counter()
    _, make_cfg, dtype = MODELS["phi3.5-vision"]
    vlm_cfg = make_cfg()
    t, v = vlm_cfg.text, vlm_cfg.vision
    # 4H. the directory from the seed-0 parameters drawn on the card; the CLI loads it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = init_params(torch.Generator(device="cuda").manual_seed(0), vlm_cfg, dtype, "cuda")
    path = fabricate("phi3.5-vision", ckpt_root, params=written)
    write_s = time.perf_counter() - t0
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in shards)
    torch.cuda.empty_cache()
    log("phi", f"{sum(x.numel() for x in _leaves(written)) / 1e9:.3f} B seed-0 parameters drawn on the card and "
        f"written to {path} in {write_s:.1f} s: {len(shards)} shards, {nbytes / 1e9:.3f} GB (the fused qkv_proj "
        f"and gate_up_proj, the wte copy), files {sorted(os.listdir(path))}")
    gray = os.path.join(os.path.dirname(os.path.abspath(__file__)), "images", "gray.png")
    # scripts/attacks/attack_clamp_tanh_phi3.sh: gray.png, the list prompts, the target, lr 1e-2,
    # batch 2, the scheduler held (step 100, gamma 1.0)
    argv = ["--exp_name", "phi", "--img_orig", gray, "--prompt", "list", "--target_text", TARGET,
            "--model_name", PHI, "--checkpoint_root", ckpt_root, "--lr", "1e-2", "--num_iterations",
            str(STEPS_H), "--save_steps", "10", "--batch_size", "2", "--scheduler_step_size", "100",
            "--scheduler_gamma", "1.0", "--runs_path", runs]
    got = {}
    t0 = time.perf_counter()
    exp = attack_cli(argv, got)
    cli_s = time.perf_counter() - t0
    victim = got["victims"][0]
    loaded, want = dict(named_leaves(victim.bundle.params)), dict(named_leaves(written))
    if set(loaded) != set(want) or any(not torch.equal(loaded[k], want[k].to(loaded[k].dtype)) for k in want) \
            or victim.bundle.cfg != vlm_cfg:
        raise AssertionError("phi: the CLI's victim is not the written directory's")
    del written, loaded, want
    gc.collect()
    rows, steps, csvs = read_run(exp)
    probe, run_launches, run_launches_d = got["probes"][0], got["launches"], got["launches_d"]
    ai = victim.adv_inputs
    grid = grid_hw_for("phi3v", victim.adv_processor, (512, 512))
    n_tiles, n_img = 1 + grid[0] * grid[1], ai.num_image_tokens
    t_text = int(ai.max_len)
    log("phi", f"{PHI} through cli/attack_model.py in {cli_s:.1f} s (train() {got['wall_s']:.1f} s): every tensor "
        f"equal to the written one, config the fabricator's (LongRoPE factors from config.json); pool "
        f"{ai.prompt_pool.shape} (targets, questions, T), {n_img} image tokens (512² -> 672², tile grid {grid}, "
        f"{n_tiles} of {victim.adv_processor.num_crops + 1} slots through the tower), tokenizer "
        f"{type(ai.tokenizer).__name__} of {ai.tokenizer.vocab_size}, shift {ai.shift}")
    for r in steps:
        log("phi", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    step_peak = probe.step_peak / 2**30
    if len(steps) != STEPS_H or n_img != 757 or not all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps):
        raise AssertionError(f"phi path: bad steps {[(r['loss'], r['grad_norm']) for r in steps]} or image tokens")
    cfg = run_config(exp)
    xs = sample_chunk_xs(torch.Generator().manual_seed(cfg.seed), 1, cfg, [victim.handles()])[0]
    seg = (torch.arange(t_text)[None, :] >= t_text - xs["lens"][0][:, None]).to(torch.int32).cuda()
    pad = t_text - int(xs["lens"][0][0])
    dg = check_dgrad(phi_dgrad_cases(victim.bundle.params, vlm_cfg, 2, t_text, n_tiles, n_img),
                     "dgrad phi3.5 batch 2")
    per_step = per_step_launches([probe], got["launches"], STEPS_H)
    per_step_d = per_step_launches([probe], run_launches_d, STEPS_H, by_head_dim=True)
    expected = {k: 0 for k in per_step}
    expected.update({"dgrad": dg["per_step"], "flash_fwd": t.num_layers, "flash_bwd_dq": t.num_layers,
                     "flash_bwd_dkdv": t.num_layers})
    expected_d = {f"{k}_d{t.head_dim_}": t.num_layers for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    log("phi", f"launches over the run: {got['launches']}; by phase: "
        + "; ".join(f"{ph} x{probe.calls[ph]} {dict(+c)}" for ph, c in probe.launches.items()))
    log("phi", f"launches per step: { {k: n for k, n in per_step.items() if n} }, by head dim "
        f"{ {k: n for k, n in per_step_d.items() if n} } (expected { {k: n for k, n in expected.items() if n} }, "
        f"by head dim {expected_d}); the tower's {n_tiles} tiles a row of 577 tokens on the plain sdpa, the "
        "decoder's 32 heads of 96 on the head_dim-96 flash kernels")
    if per_step != expected or {k: n for k, n in per_step_d.items() if n} != expected_d:
        raise AssertionError("phi path: launches per step differ from the expected counts")
    chunks = decode_chunks("phi", probe, t.num_layers)
    if sorted(csvs) != sorted(f"test_results_iter_{i}.csv" for i in (0, STEPS_H - 1)) or not all(
            [r[0] for r in tab[1:]] == list(ai.test_questions) and tab[0] == ["question", PHI] for tab in csvs.values()):
        raise AssertionError(f"phi path: test CSVs {sorted(csvs)}")
    # the head_dim-96 kernels at the step's shape (batch 2), the decode prefill's and batch 1 (the
    # cross step's route), each against its plain version, a second launch equal, timed
    flash = flash_case("phi3.5 batch-2 step", seg, t.num_heads, t.num_kv_heads, t.head_dim_, timed=True)
    masks = sorted({(c["batch"], c["T"]) for c in probe.chunks})
    prefill = flash_case("phi3.5 test-decode prefill", probe.chunks[0]["mask"].cuda(), t.num_heads, t.num_kv_heads,
                         t.head_dim_, timed=True, backward=False)["flash_fwd"]
    attn = attention_case(t_text, t.num_heads, t.num_kv_heads, t.head_dim_, pad, timed=True)
    log("phi", f"4H: median step_ms (steps 1..{STEPS_H - 1})={med:.2f} warm-up {steps[0]['step_ms']:.2f}; steps' peak "
        f"{step_peak:.3f} GiB; decode chunks (batch, T) {masks}; the D-96 kernels held at the run's shapes")
    torch.cuda.empty_cache()

    # 5H. depth-cut references: the first 2 decoder and 2 vision layers, the card in bf16 through
    # the kernels against the CPU in f32 on the plain path; T far below original_max_position_embeddings
    # (4096), so both sides take the short LongRoPE factors, as the run does
    t0 = time.perf_counter()
    cut = dataclasses.replace(vlm_cfg, text=dataclasses.replace(t, num_layers=2),
                              vision=dataclasses.replace(v, num_layers=2))
    questions = [QUESTION, QUESTION + " Explain every step in detail, please."]
    ref_ai = AdvInputs(ai.spec, ai.tokenizer, questions, [QUESTION], 2, [TARGET], n_img, ai.image_token_id,
                       ai.pad_token_id)
    gpu_v = VictimSetup("cut", make_bundle("cut", "phi3v", cut, torch.device("cuda"),
                                           params=depth_cut(victim.bundle.params, 2, 2), grid_hw=grid),
                        victim.adv_processor, ref_ai, torch.bfloat16)
    x0 = load_image_chw(gray)
    gen = torch.Generator().manual_seed(5)
    p0 = 0.3 * torch.randn(x0.shape, generator=gen)
    noise = torch.randn((2, victim.adv_processor.num_crops + 1, 3, v.image_size, v.image_size), generator=gen)
    reference = card_step_references("phi3v", gpu_v, cut, grid, cfg, x0, p0, (("batch 1", [0]), ("batch 2", [0, 1])),
                                     noise, {"flash_fwd": cut.text.num_layers})
    log("reference", f"phi3.5 references' card half in {time.perf_counter() - t0:.1f} s")
    del gpu_v, victim, got, probe
    gc.collect()
    torch.cuda.empty_cache()
    log("phi", f"phases 4H and 5H in {time.perf_counter() - t_phase:.1f} s")
    return {"median_ms": med, "step_peak_GiB": step_peak, "chunks": chunks, "reference": reference,
            "stats": {"dgrad": dg, **flash, **attn}, "prefill": prefill, "per_step": per_step,
            "launches": run_launches, "launches_d": run_launches_d, "seconds": time.perf_counter() - t_phase,
            "write_s": write_s, "GB": nbytes / 1e9, "T": t_text}


def phi_cross_phases(ckpt_root, runs):
    """Phase 4XH: scripts/attacks/attack_cross_onechip_int8.sh, LLaVA-1.5-7B and Phi-3.5-vision loaded
    from the directories of 4L and 4H with int8 weights, quantized as they load, through
    :func:`pair_cross_phase`: the batch-1 causal kernels at both decoders' T, LLaVA's at head_dim
    128 and Phi's at 96 (timed)."""
    from adversarialvlm_tpu_torch.processors import grid_hw_for

    def dgrad_cases(victims, ts):
        (lv, pv), (t_l, t_p) = victims, ts
        grid = grid_hw_for("phi3v", pv.adv_processor, (512, 512))
        return (int8_dgrad_cases(lv.bundle.params, lv.bundle.cfg, t_l)
                + phi_dgrad_cases(pv.bundle.params, pv.bundle.cfg, 1, t_p, 1 + grid[0] * grid[1],
                                  pv.adv_inputs.num_image_tokens))

    def kernel_cases(victims, ts, pads, probes):
        lt, pt = (v.bundle.cfg.text for v in victims)
        attention_case(ts[0], lt.num_heads, lt.num_kv_heads, lt.head_dim_, pads[0])
        return attention_case(ts[1], pt.num_heads, pt.num_kv_heads, pt.head_dim_, pads[1], timed=True)

    return pair_cross_phase("cross phi", [LLAVA, PHI], ("llava", "phi3v"), ckpt_root, runs, ["--int8_weights"],
                            dgrad_cases, kernel_cases)

MLLAMA = "alpindale/Llama-3.2-11B-Vision-Instruct"
STEPS_M = 3               # phase 4M: 1 warm-up + 2 timed; save boundaries at iterations 0 and 2
MLLAMA_CUT_TEXT, MLLAMA_CUT_LOCAL, MLLAMA_CUT_GLOBAL = 4, 2, 1  # phase 5M: cross layer 3 runs; T stays 6432


@contextlib.contextmanager
def shared_loads(tag):
    """Within the block, each checkpoint directory's dense LLaVA or Gemma-3 tree and its tokenizer are
    read from disk once: models/loading.py's load_llava and load_gemma3 and HFTokenizer.from_pretrained
    hand later calls the first call's tree and tokenizer (the weights are frozen, and nothing the
    phases do writes them). A load under quantize_on_load reads the directory as before. The shared
    trees stay on the card until the block ends, so the peaks measured inside it hold them."""
    from adversarialvlm_tpu_torch.models import loading
    from adversarialvlm_tpu_torch.utils.tokenization import HFTokenizer

    cache, hits = {}, [0]
    real = {name: getattr(loading, name) for name in ("load_llava", "load_gemma3")}
    real_tok = HFTokenizer.__dict__["from_pretrained"]

    def shared(key, read):
        if key in cache:
            hits[0] += 1
        else:
            cache[key] = read()
        return cache[key]

    def sharing(name, fn):
        def load(path, dtype=None, device="cuda"):
            import torch

            dtype = dtype or torch.bfloat16
            if loading._QUANT_ON_LOAD[0] is not None:
                return fn(path, dtype, device)
            return shared((name, os.path.realpath(path), dtype, str(device)), lambda: fn(path, dtype, device))
        return load

    for name, fn in real.items():
        setattr(loading, name, sharing(name, fn))
    HFTokenizer.from_pretrained = classmethod(
        lambda cls, path: shared(("tokenizer", os.path.realpath(path)), lambda: real_tok.__func__(cls, path)))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(loading, name, fn)
        HFTokenizer.from_pretrained = real_tok
        log("disk", f"{tag}: {len(cache)} trees and tokenizers read once, handed out {hits[0]} more times")
        cache.clear()


def drop_dirs(root, names):
    """Delete the checkpoint directories of ``names`` under ``root`` once their last phase is done,
    so the disk holds only the directories later phases still load."""
    for name in names:
        shutil.rmtree(os.path.join(root, name))
    log("disk", f"deleted {list(names)}; left under {root}: "
        f"{sorted(os.path.relpath(os.path.join(d), root) for d, sub, files in os.walk(root) if 'config.json' in files)}; "
        f"free {shutil.disk_usage(root).free / 1e9:.1f} GB")


def mllama_dgrad_cases(params, vlm_cfg, t_text, k_rows):
    """(rows, O, I, launches per step, weight) of the mllama batch-1 step's dgrad launches, from the
    layer structure: the tower's q/k/v/o (1280²), fc1 and fc2 over every tile slot's padded tokens
    (T 6432) in all 32 local and 8 global layers; the projector (7680 -> 4096) and each cross
    layer's k/v over the 6404 cross states; the decoder over its T tokens, only from the first cross
    layer on (before it no input depends on the image): that layer's o and MLP (its q reads text
    alone), every later cross layer's q, o and MLP, every later self-attention layer's q, k, v, o
    and MLP; the lm_head (128256 rows, 128-aligned, so on the kernel) over the ``k_rows`` scored
    positions."""
    from adversarialvlm_tpu_torch.ops.kernels.dgrad import dgrad_eligible

    v, t = vlm_cfg.vision, vlm_cfg.text
    vis = params["vision_model"]["transformer"]["layers"][0]
    lm = params["language_model"]
    first = min(t.cross_attention_layers)
    cross, selfs = lm["layers"][first], lm["layers"][first + 1]
    n_cross = len(t.cross_attention_layers)
    n_self_after = sum(1 for i in range(first, t.num_layers) if i not in t.cross_attention_layers)
    n_p1 = (v.image_size // v.patch_size) ** 2 + 1
    t_vis = v.max_num_tiles * (n_p1 + (8 - n_p1 % 8) % 8)
    s_cross = v.max_num_tiles * n_p1
    n_vis = v.num_layers + v.num_global_layers
    ca = cross["cross_attn"]
    linears = [
        (t_vis, vis["self_attn"]["q_proj"]["weight"], 4 * n_vis),
        (t_vis, vis["mlp"]["fc1"]["weight"], n_vis), (t_vis, vis["mlp"]["fc2"]["weight"], n_vis),
        (s_cross, params["multi_modal_projector"]["weight"], 1),
        (s_cross, ca["k_proj"]["weight"], 2 * n_cross),
        (t_text, selfs["self_attn"]["q_proj"]["weight"], 2 * n_self_after + 2 * n_cross - 1),
        (t_text, selfs["self_attn"]["k_proj"]["weight"], 2 * n_self_after),
        (t_text, selfs["mlp"]["gate_proj"]["weight"], 2 * (n_self_after + n_cross)),
        (t_text, selfs["mlp"]["down_proj"]["weight"], n_self_after + n_cross),
        (k_rows, lm["lm_head"]["weight"], 1),
    ]
    if not all(dgrad_eligible(w) for _, w, _ in linears):
        raise AssertionError("mllama: the dgrad-eligible linears are not the expected ones")
    merged, weights = {}, {}
    for rows, w, n in linears:
        key = (rows, *w.shape)
        merged[key] = merged.get(key, 0) + n
        weights[key] = w
    return [(*key, n, weights[key]) for key, n in merged.items()]


def mllama_cut_config(vlm_cfg, n_text=MLLAMA_CUT_TEXT):
    """The configuration of an mllama depth cut: the first ``n_text`` decoder layers (cross layer 3
    among them), MLLAMA_CUT_LOCAL local and MLLAMA_CUT_GLOBAL global tower layers at the full 4
    tiles (T 6432, the chunked rank-1 path). The k-th intermediate index is remapped to local layer
    min(k, MLLAMA_CUT_LOCAL - 1), so the projector keeps its 7680 inputs."""
    import dataclasses

    t, v = vlm_cfg.text, vlm_cfg.vision
    inter = tuple(min(k, MLLAMA_CUT_LOCAL - 1) for k in range(len(v.intermediate_layers_indices)))
    return dataclasses.replace(
        vlm_cfg,
        text=dataclasses.replace(t, num_layers=n_text, cross_attention_layers=tuple(
            i for i in t.cross_attention_layers if i < n_text)),
        vision=dataclasses.replace(v, num_layers=MLLAMA_CUT_LOCAL, num_global_layers=MLLAMA_CUT_GLOBAL,
                                   intermediate_layers_indices=inter))


def mllama_depth_cut(params, vlm_cfg):
    """(params, config) of phase 5M's cut (:func:`mllama_cut_config`), tensors shared."""
    v = vlm_cfg.vision
    cut = mllama_cut_config(vlm_cfg)
    inter = cut.vision.intermediate_layers_indices
    vm, lm = params["vision_model"], params["language_model"]
    out = {**params, "language_model": {**lm, "layers": lm["layers"][:MLLAMA_CUT_TEXT]},
           "vision_model": {**vm, "transformer": {"layers": vm["transformer"]["layers"][:MLLAMA_CUT_LOCAL]},
                            "global_transformer": {"layers": vm["global_transformer"]["layers"][:MLLAMA_CUT_GLOBAL]}}}
    log("reference", f"mllama cut: decoder layers 0-{MLLAMA_CUT_TEXT - 1} (cross {cut.text.cross_attention_layers}), "
        f"{MLLAMA_CUT_LOCAL} local + {MLLAMA_CUT_GLOBAL} global tower layers; intermediate indices "
        f"{v.intermediate_layers_indices} -> {inter}")
    return out, cut


def mllama_phases(ckpt_root, runs):
    """Phases 4M and 5M on Llama-3.2-11B-Vision-Instruct at full width and depth; the checkpoint
    directory stays for 4X3. Returns the phases' numbers and kernel statistics."""
    import numpy as np
    import torch

    from adversarialvlm_tpu_torch.attack.engine import VictimSetup
    from adversarialvlm_tpu_torch.attack.io import load_image_chw
    from adversarialvlm_tpu_torch.attack.step import sample_chunk_xs
    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import MODELS, fabricate
    from adversarialvlm_tpu_torch.models.loading import named_leaves
    from adversarialvlm_tpu_torch.models.mllama import init_params
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.processors import grid_hw_for
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs

    t_phase = time.perf_counter()
    _, make_cfg, dtype = MODELS["mllama-11b"]
    vlm_cfg = make_cfg()
    t, v = vlm_cfg.text, vlm_cfg.vision
    # 4M. the directory from the seed-0 parameters drawn on the card (dropped before the CLI loads
    # it, so the run's peak holds one copy; drawn again afterwards for the comparison)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = init_params(torch.Generator(device="cuda").manual_seed(0), vlm_cfg, dtype, "cuda")
    n_params = sum(x.numel() for x in _leaves(written))
    path = fabricate("mllama-11b", ckpt_root, params=written)
    del written
    gc.collect()
    torch.cuda.empty_cache()
    write_s = time.perf_counter() - t0
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in shards)
    log("mllama", f"{n_params / 1e9:.3f} B seed-0 parameters drawn on the card and written to {path} in "
        f"{write_s:.1f} s: {len(shards)} shards, {nbytes / 1e9:.3f} GB, files {sorted(os.listdir(path))}")
    gray = os.path.join(os.path.dirname(os.path.abspath(__file__)), "images", "gray.png")
    # scripts/attacks/attack_clamp_tanh_llama.sh: gray.png, the list prompts, the target, lr 5e-3,
    # batch 1
    argv = ["--exp_name", "mllama", "--img_orig", gray, "--prompt", "list", "--target_text", TARGET,
            "--model_name", MLLAMA, "--checkpoint_root", ckpt_root, "--lr", "5e-3", "--num_iterations",
            str(STEPS_M), "--save_steps", "10", "--batch_size", "1", "--runs_path", runs]
    got = {}
    t0 = time.perf_counter()
    exp = attack_cli(argv, got)
    cli_s = time.perf_counter() - t0
    victim = got["victims"][0]
    probe, run_launches, run_launches_d = got["probes"][0], got["launches"], got["launches_d"]
    written = init_params(torch.Generator(device="cuda").manual_seed(0), vlm_cfg, dtype, "cuda")
    loaded, want = dict(named_leaves(victim.bundle.params)), dict(named_leaves(written))
    if set(loaded) != set(want) or any(not torch.equal(loaded[k], want[k].to(loaded[k].dtype)) for k in want) \
            or victim.bundle.cfg != vlm_cfg:
        raise AssertionError("mllama: the CLI's victim is not the written directory's")
    del written, loaded, want
    gc.collect()
    torch.cuda.empty_cache()
    rows, steps, csvs = read_run(exp)
    ai = victim.adv_inputs
    grid = grid_hw_for("mllama", victim.adv_processor, (512, 512), vlm_cfg)
    t_text, k_rows = int(ai.max_len), int(ai.target_pool.shape[1]) + 1
    log("mllama", f"{MLLAMA} through cli/attack_model.py in {cli_s:.1f} s (train() {got['wall_s']:.1f} s): every "
        f"tensor equal to the written one, config the fabricator's; pool {ai.prompt_pool.shape} (targets, "
        f"questions, T), {ai.num_image_tokens} <|image|> token a row, plan {victim.adv_processor.plan((512, 512))}, "
        f"grid (real tiles, max tiles) {grid}, tokenizer {type(ai.tokenizer).__name__} of "
        f"{ai.tokenizer.vocab_size}, shift {ai.shift}")
    for r in steps:
        log("mllama", f"step {r['iteration']}: loss={r['loss']} grad_norm={r['grad_norm']} step_ms={r['step_ms']:.2f}")
    med = statistics.median(r["step_ms"] for r in steps[1:])
    step_peak = probe.step_peak / 2**30
    if len(steps) != STEPS_M or grid != (1, 4) or ai.num_image_tokens != 1 or not all(
            np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps):
        raise AssertionError(f"mllama path: bad steps {[(r['loss'], r['grad_norm']) for r in steps]} or grid {grid}")
    cfg = run_config(exp)
    xs = sample_chunk_xs(torch.Generator().manual_seed(cfg.seed), 1, cfg, [victim.handles()])[0]
    pad = t_text - int(xs["lens"][0][0])
    dg = check_dgrad(mllama_dgrad_cases(victim.bundle.params, vlm_cfg, t_text, k_rows), "dgrad mllama batch 1")
    per_step = per_step_launches([probe], run_launches, STEPS_M)
    per_step_d = per_step_launches([probe], run_launches_d, STEPS_M, by_head_dim=True)
    # forward: every self-attention layer on the batch-1 kernels; backward: those after the first
    # cross layer (before it nothing depends on the image, so autograd runs no backward there)
    n_self = t.num_layers - len(t.cross_attention_layers)
    n_bwd = sum(1 for i in range(min(t.cross_attention_layers), t.num_layers) if i not in t.cross_attention_layers)
    expected = {k: 0 for k in per_step}
    expected.update({"dgrad": dg["per_step"], "attention_fwd": n_self, "attention_bwd_dq": n_bwd,
                     "attention_bwd_dkdv": n_bwd})
    expected_d = {"attention_fwd_d128": n_self, "attention_bwd_dq_d128": n_bwd, "attention_bwd_dkdv_d128": n_bwd}
    log("mllama", f"launches over the run: {run_launches}; by phase: "
        + "; ".join(f"{ph} x{probe.calls[ph]} {dict(+c)}" for ph, c in probe.launches.items()))
    log("mllama", f"launches per step: { {k: n for k, n in per_step.items() if n} }, by head dim "
        f"{ {k: n for k, n in per_step_d.items() if n} } (expected { {k: n for k, n in expected.items() if n} }, "
        f"by head dim {expected_d}); flash_full none: the tower's 6432 tokens take the chunked rank-1 sdpa")
    if per_step != expected or {k: n for k, n in per_step_d.items() if n} != expected_d:
        raise AssertionError("mllama path: launches per step differ from the expected counts")
    if any(n for k, n in run_launches.items() if k.startswith("flash_full")):
        raise AssertionError(f"mllama path: the tower reached flash_full: {run_launches}")
    chunks = decode_chunks("mllama", probe, n_self)
    if sorted(csvs) != sorted(f"test_results_iter_{i}.csv" for i in (0, STEPS_M - 1)) or not all(
            [r[0] for r in tab[1:]] == list(ai.test_questions) and tab[0] == ["question", MLLAMA] for tab in csvs.values()):
        raise AssertionError(f"mllama path: test CSVs {sorted(csvs)}")
    # the causal kernels at n_rep 4: the batch-1 step's shape and the decode prefill's (flash)
    attn = attention_case(t_text, t.num_heads, t.num_kv_heads, t.head_dim_, pad, timed=True)
    prefill = flash_case("mllama test-decode prefill", probe.chunks[0]["mask"].cuda(), t.num_heads, t.num_kv_heads,
                         t.head_dim_, timed=True, backward=False)["flash_fwd"]
    log("mllama", f"4M: median step_ms (steps 1..{STEPS_M - 1})={med:.2f} warm-up {steps[0]['step_ms']:.2f}; steps' "
        f"peak {step_peak:.3f} GiB; grad norms {[r['grad_norm'] for r in steps]}; the n_rep-4 kernels held at the "
        f"run's shapes")
    torch.cuda.empty_cache()

    # 5M. the depth-cut reference: the card in bf16 through the kernels against the CPU in f32 on the
    # plain path, the same weights, the tower at the full T 6432 on the chunked path on both
    t0 = time.perf_counter()
    cut_params, cut = mllama_depth_cut(victim.bundle.params, vlm_cfg)
    ref_ai = AdvInputs(ai.spec, ai.tokenizer, [QUESTION], [QUESTION], 1, [TARGET], 1, ai.image_token_id,
                       ai.pad_token_id)
    gpu_v = VictimSetup("cut", make_bundle("cut", "mllama", cut, torch.device("cuda"), params=cut_params,
                                           grid_hw=grid), victim.adv_processor, ref_ai, torch.bfloat16)
    x0 = load_image_chw(gray)
    gen = torch.Generator().manual_seed(5)
    p0 = 0.3 * torch.randn(x0.shape, generator=gen)
    noise = torch.randn((1, 1, v.max_num_tiles, 3, v.image_size, v.image_size), generator=gen)
    n_cut_self = cut.text.num_layers - len(cut.text.cross_attention_layers)
    reference = card_step_references("mllama", gpu_v, cut, grid, cfg, x0, p0, (("batch 1", [0]),), noise,
                                     {"flash_fwd": n_cut_self})
    log("reference", f"mllama references' card half in {time.perf_counter() - t0:.1f} s")
    del gpu_v, victim, got, probe, cut_params
    gc.collect()
    torch.cuda.empty_cache()
    log("mllama", f"phases 4M and 5M in {time.perf_counter() - t_phase:.1f} s")
    return {"median_ms": med, "step_peak_GiB": step_peak, "chunks": chunks, "reference": reference,
            "stats": {"dgrad": dg, **attn}, "prefill": prefill, "per_step": per_step, "per_step_d": per_step_d,
            "launches": run_launches, "launches_d": run_launches_d, "seconds": time.perf_counter() - t_phase,
            "write_s": write_s, "GB": nbytes / 1e9, "T": t_text, "grad_norms": [r["grad_norm"] for r in steps]}


STEPS_MESH = 3            # phases 4T and 4TL: a warm-up, a timed step and one more, p checked after each
MESH_DECODE_TOKENS = 8    # phases 4T and 4TL: each test decode's new tokens and held-out questions (the
MESH_TEST_QUESTIONS = 8   # engine's 64 and 50, cut: a mesh rank's prefill and each cached step make 2L + 2
                          # all-reduces of the chunk's activations, through the host under gloo)
TOL_MESH_LOSS = 1e-2      # step 1's loss, a mesh run's rank 0 against the one-rank run (relative)
TOL_MESH_COSINE = 0.99    # step 1's image gradient and the first decode prefill's last logits (cosine)


@contextlib.contextmanager
def mesh_probe(out_dir, tag, t_launch=None):
    """Spies, in this process, on the attack an attack CLI runs here (one rank of a mesh run, or
    the one-rank run), and writes what it saw to ``<out_dir>/<tag>.json`` and ``.pt``:
    engine.train is wrapped with a PathProbe on each victim (decode chunks, the steps' peak) and
    each step (AttackStep.__call__, from a drained queue) records its device ms, loss, the
    SHA-256 of p after it, its kernel launches (by head dim too), its collectives (count, bytes,
    shapes), and after step 1 the
    AdamW first moment (0.1·g); the first decode prefill's last logits, the rank's coordinates
    and backend, the shapes of its tensor-parallel weights (whole and sharded) and its rows' pads
    go in too, with the wall seconds from ``t_launch`` (the launch's ``time.time()``) to this
    process's probe and to its train(). Each test decode runs MESH_DECODE_TOKENS new tokens over the
    first MESH_TEST_QUESTIONS held-out questions."""
    import hashlib

    import torch

    from adversarialvlm_tpu_torch.attack import engine
    from adversarialvlm_tpu_torch.attack import step as step_mod
    from adversarialvlm_tpu_torch.models.loading import named_leaves
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, launch_counts_by_head_dim, reset_launches
    from adversarialvlm_tpu_torch.parallel import collectives
    from adversarialvlm_tpu_torch.parallel.mesh import active_mesh

    t_ref = time.time() if t_launch is None else t_launch
    rec, tensors = {"tag": tag, "steps": [], "t_probe": time.time() - t_ref}, {}
    real_train, real_call, real_test = engine.train, step_mod.AttackStep.__call__, engine.run_model_test

    def test(*args, **kw):  # a decode chunk of MESH_TEST_QUESTIONS rows, not one bucketed to the default 50
        return real_test(*args, **{**kw, "batch_size": MESH_TEST_QUESTIONS})

    def call(self, state, xs):
        torch.cuda.synchronize()
        l0, d0 = launch_counts(), launch_counts_by_head_dim()
        c0, b0, n0 = collectives.collective_counts(), dict(collectives.BYTES), dict(collectives.SHAPES)
        if not rec["steps"]:
            lens = xs["lens"][0][self.rows]
            rec.update(T=int(xs["rows"][0].shape[1]), pads=[int(xs["rows"][0].shape[1] - n) for n in lens],
                       Ts=[int(r.shape[1]) for r in xs["rows"]],
                       pads_by_victim=[[int(r.shape[1] - n) for n in ls[self.rows]]
                                       for r, ls in zip(xs["rows"], xs["lens"])])
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_call(self, state, xs)
        e1.record()
        torch.cuda.synchronize()
        rec["steps"].append({
            "ms": e0.elapsed_time(e1), "loss": float(out[1]["loss"]),
            "losses": [float(out[1][f"loss_{i}"]) for i in range(len(self.victims)) if f"loss_{i}" in out[1]],
            "p_sha256": hashlib.sha256(state["p"].detach().cpu().numpy().tobytes()).hexdigest(),
            "launches": {k: n - l0[k] for k, n in launch_counts().items() if n != l0[k]},
            "launches_d": {k: n - d0.get(k, 0) for k, n in launch_counts_by_head_dim().items() if n != d0.get(k, 0)},
            "collectives": {k: n - c0[k] for k, n in collectives.collective_counts().items()},
            "collective_bytes": {k: n - b0.get(k, 0) for k, n in collectives.BYTES.items() if n != b0.get(k, 0)},
            "shapes": sorted({sh for (kind, sh), n in collectives.SHAPES.items() if n != n0.get((kind, sh), 0)}),
        })
        if len(rec["steps"]) == 1:
            tensors["exp_avg_1"] = state["optimizer"].state[state["p"]]["exp_avg"].detach().cpu()
        return out

    def spy(cfg, victims, x0, **kw):
        rec["t_train"] = time.time() - t_ref
        kw["test_max_new_tokens"] = MESH_DECODE_TOKENS
        for v in victims:
            v.adv_inputs.test_questions = list(v.adv_inputs.test_questions[:MESH_TEST_QUESTIONS])
        mesh = active_mesh()
        rec.update(rank=mesh.rank if mesh else 0, data_rank=mesh.data_rank if mesh else 0,
                   model_rank=mesh.model_rank if mesh else 0, backend=mesh.backend if mesh else None)
        group = []
        probes = [PathProbe(v.bundle, group) for v in victims]
        bundle, inner = victims[0].bundle, victims[0].bundle.forward

        def first_prefill(params, ids, am, pixel_inputs=None, **k):
            out = inner(params, ids, am, pixel_inputs, **k)
            if k.get("cache_index") == 0 and "prefill_logits" not in tensors:
                tensors["prefill_logits"] = out[:, -1].float().cpu()
                tensors["prefill_mask"] = am.detach().cpu()
            return out

        bundle.forward = first_prefill
        shapes = set()
        for v in victims:
            for _, t in named_leaves(v.bundle.params):
                if hasattr(t, "tp_full_shape"):
                    shapes.update((tuple(sorted(t.tp_full_shape)), tuple(sorted(t.shape))))
        rec["weight_shapes"] = sorted(shapes)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        collectives.reset_counts()
        t0 = time.perf_counter()
        try:
            return real_train(cfg, victims, x0, **kw)
        finally:
            torch.cuda.synchronize()
            rec["wall_s"] = time.perf_counter() - t0
            for probe in probes:
                probe.finish()
            rec["step_peak_GiB"] = max(p.step_peak for p in probes) / 2**30
            rec["chunks"] = [{k: c[k] for k in ("batch", "T", "prefill_ms", "decode_ms", "tokens", "peak_GiB",
                                                  "prefill_launches")} for p in probes for c in p.chunks]
            rec["decode_step_launches"] = sum(sum(p.launches["decode_step"].values()) for p in probes)
            rec["launches_run"] = launch_counts()

    engine.train, step_mod.AttackStep.__call__, engine.run_model_test = spy, call, test
    try:
        yield rec
    finally:
        engine.train, step_mod.AttackStep.__call__, engine.run_model_test = real_train, real_call, real_test
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump(rec, f)
        torch.save(tensors, os.path.join(out_dir, f"{tag}.pt"))


T_IMPORT = time.time()    # when this module was imported: in a mesh rank, when its process had started


def mesh_rank(mesh, fn, args, out_dir, t_launch):
    """A rank of a mesh run launched by an attack CLI, under :func:`mesh_probe`; its record also
    holds the wall seconds from the launch to this module's import in the rank's process (the
    process start and Python's), which the rest of ``t_probe`` follows (torch, the port and the
    process group)."""
    with mesh_probe(out_dir, f"rank{mesh.rank}", t_launch) as rec:
        rec["t_import"] = T_IMPORT - t_launch
        return fn(mesh, *args)


def mesh_cli(argv, out_dir, cross=False):
    """cli/attack_model.main (``cross``: cli/crossattack_models.main) on ``argv`` (with its mesh
    flags): the CLI's own launch, each rank under :func:`mesh_probe`."""
    from adversarialvlm_tpu_torch.cli import attack_model, crossattack_models
    from adversarialvlm_tpu_torch.parallel import mesh as pmesh

    real = pmesh.launch

    def probed(fn, data, model, device="cuda", args=()):
        return real(mesh_rank, data, model, device=device, args=(fn, args, out_dir, time.time()))

    pmesh.launch = probed
    try:
        return (crossattack_models if cross else attack_model).main(argv)
    finally:
        pmesh.launch = real


def tp_decoder_dgrad_cases(t, rows, tp, rank=0):
    """(rows, O, I, launches per step, weight) of a llama-family decoder's dgrad launches on model
    rank ``rank`` of ``tp``: q/k/v and gate/up at their shards' output rows (q and k/v by the rank's
    whole heads), o and down at their shards' input columns, each taken by its whole weight's shape
    (the JAX rule under pjit), the weights random at the shard's shape. mllama's decoder counts the
    launches of its layers from the first cross layer on (each cross layer's q but the first's, its
    o and MLP; each later self-attention layer's all), not its cross k/v over the image."""
    import torch

    from adversarialvlm_tpu_torch.ops.kernels.dgrad import dgrad_eligible
    from adversarialvlm_tpu_torch.parallel.sharding import local_heads

    d, hd, inter = t.hidden_size, t.head_dim_, t.intermediate_size
    hq, hkv = local_heads(t.num_heads, t.num_kv_heads, tp, rank)
    n_self, n_cross = n_backward_layers(t), len(t.cross_attention_layers)
    n_q = n_self + max(n_cross - 1, 0)
    linears = [((t.num_heads * hd, d), (hq * hd, d), n_q), ((t.num_kv_heads * hd, d), (hkv * hd, d), 2 * n_self),
               ((d, t.num_heads * hd), (d, hq * hd), n_self + n_cross), ((inter, d), (inter // tp, d), 2 * (n_self + n_cross)),
               ((d, inter), (d, inter // tp), n_self + n_cross)]
    gen = torch.Generator(device="cuda").manual_seed(tp * 100 + rank)
    merged = {}  # shards of one shape (Phi-3.5's q and k/v at 8) are one case
    for full, local, n in linears:
        if dgrad_eligible(torch.empty(full, device="meta")):
            merged[local] = merged.get(local, 0) + n
    return [(rows, *local, n, torch.randn(local, generator=gen, device="cuda", dtype=torch.bfloat16) * local[1] ** -0.5)
            for local, n in merged.items()]


def mesh_runs(tag, argv, mesh_flags, n_ranks, out_dir, cross=False):
    """An attack CLI (``cross``: the cross CLI) on ``argv`` with ``mesh_flags`` (every rank on the
    one card), then the same command without them on one rank here, each under :func:`mesh_probe`;
    logs the launch's seconds and the backend, and checks every rank's p after each step bit for bit
    equal. Returns (the ranks' records, the one-rank run's, their tensors, the two runs' seconds)."""
    import torch

    from adversarialvlm_tpu_torch.cli import attack_model, crossattack_models

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mesh_cli(argv + mesh_flags, out_dir, cross)
    mesh_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with mesh_probe(out_dir, "one"):
        (crossattack_models if cross else attack_model).main(argv + ["--exp_name", f"{tag}_one"])
    one_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(n_ranks)]
    one = json.load(open(os.path.join(out_dir, "one.json")))
    tens = {k: torch.load(os.path.join(out_dir, f"{k}.pt")) for k in ("rank0", "one")}
    log(tag, f"{' '.join(mesh_flags)}: {n_ranks} ranks on the one card through the CLI in {mesh_s:.1f} s, backend "
        f"{sorted({r['backend'] for r in ranks})}; by rank, s from the launch to the rank's process "
        f"{[round(r['t_import'], 1) for r in ranks]}, to its probe {[round(r['t_probe'], 1) for r in ranks]}, "
        f"to its train() {[round(r['t_train'], 1) for r in ranks]}, train() {[round(r['wall_s'], 1) for r in ranks]}; "
        f"the one-rank run in {one_s:.1f} s (train() {one['wall_s']:.1f} s)")
    for k in range(len(one["steps"])):
        shas = {r["steps"][k]["p_sha256"] for r in ranks}
        if len(shas) != 1 or any(len(r["steps"]) != len(one["steps"]) for r in ranks):
            raise AssertionError(f"{tag}: the ranks' p differ after step {k + 1}: {shas}")
    return ranks, one, tens, mesh_s, one_s


def mesh_step1(tag, ranks, one, tens):
    """Step 1 of rank 0 against the one-rank run's: the loss (and each victim's in a cross run) within
    TOL_MESH_LOSS relative, the image gradient (AdamW's first moment) and the first decode prefill's
    last logits at cosine >= TOL_MESH_COSINE. Returns (the relative differences, the two cosines)."""
    import torch

    got, want = ranks[0]["steps"][0], one["steps"][0]
    rel = [abs(a - b) / abs(b) for a, b in zip([got["loss"], *got["losses"]], [want["loss"], *want["losses"]])]
    g_mesh, g_one = (tens[k]["exp_avg_1"].double().ravel() for k in ("rank0", "one"))
    g_cos = float(g_mesh @ g_one / (g_mesh.norm() * g_one.norm()))
    a, b = (tens[k]["prefill_logits"].double() for k in ("rank0", "one"))
    logit_cos = float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
    log(tag, f"step 1: loss (and each victim's) {[got['loss'], *got['losses']]} against the one-rank run's "
        f"{[want['loss'], *want['losses']]} (rel {[f'{r:.3g}' for r in rel]}, tol {TOL_MESH_LOSS}); image gradient "
        f"cosine {g_cos:.6f}; the first victim's first decode prefill's last logits, min cosine over {a.shape[0]} rows "
        f"{logit_cos:.6f} (min {TOL_MESH_COSINE}); every rank's p equal after each of the {len(one['steps'])} steps")
    if not (len(rel) == 1 + len(want["losses"]) and max(rel) <= TOL_MESH_LOSS and g_cos >= TOL_MESH_COSINE
            and logit_cos >= TOL_MESH_COSINE):
        raise AssertionError(f"{tag}: the mesh run and the one-rank run disagree")
    return rel, g_cos, logit_cos


def mesh_step_checks(tag, ranks, one, want_step, want_one, want_coll, want_d=None):
    """Each step of every rank launched exactly ``want_step`` (by head dim ``want_d``, when given) and
    made exactly the collectives ``want_coll``, none of a weight's shape; the one-rank run's steps
    launched ``want_one`` (its route may differ by design)."""
    for r in ranks:
        for k, st in enumerate(r["steps"]):
            if (st["launches"] != want_step or st["collectives"] != want_coll
                    or (want_d is not None and st["launches_d"] != want_d)):
                raise AssertionError(f"{tag}: rank {r['rank']} step {k + 1} launched {st['launches']} "
                                     f"({st['launches_d']}) with collectives {st['collectives']}; expected "
                                     f"{want_step} ({want_d}) and {want_coll}")
            weighty = [sh for sh in st["shapes"] if tuple(sorted(sh)) in {tuple(w) for w in r["weight_shapes"]}]
            if weighty or not r["weight_shapes"]:
                raise AssertionError(f"{tag}: rank {r['rank']} step {k + 1}: collectives of weight shapes {weighty}")
    for k, st in enumerate(one["steps"]):
        if st["launches"] != want_one or (want_d is not None and st["launches_d"] != want_d):
            raise AssertionError(f"{tag}: the one-rank run's step {k + 1} launched {st['launches']} "
                                 f"({st['launches_d']}), expected {want_one} ({want_d})")


def mesh_numbers(ranks, one, rel, g_cos, logit_cos, mesh_s, one_s):
    """A mesh phase's numbers: each rank's step-2 ms and steps' peak beside the one-rank run's, the
    backend, step 1's agreement, the seconds."""
    return {
        "step_ms": [r["steps"][1]["ms"] for r in ranks], "one_step_ms": one["steps"][1]["ms"],
        "peak_GiB": [r["step_peak_GiB"] for r in ranks], "one_peak_GiB": one["step_peak_GiB"],
        "backend": ranks[0]["backend"], "loss_rel": rel, "grad_cosine": g_cos, "logit_cosine": logit_cos,
        "mesh_s": mesh_s, "one_s": one_s, "t_import": [r["t_import"] for r in ranks],
        "t_probe": [r["t_probe"] for r in ranks], "t_train": [r["t_train"] for r in ranks],
    }


def mesh_phase(tag, argv, mesh_flags, shape, vlm_cfg, tower_cases, want_step, want_one, out_dir):
    """A mesh phase (4T, 4TL): the attack CLI with ``mesh_flags`` (every rank on the one card), then
    the same command without them in this process, each under :func:`mesh_probe`. Checks every
    rank's p after each step bit for bit equal; step 1's loss within TOL_MESH_LOSS of the one-rank
    run's and its image gradient (AdamW's first moment) and the first decode prefill's last logits
    at cosine >= TOL_MESH_COSINE; each rank's kernel launches a step (``want_step``; the one-rank
    run's ``want_one``, whose route may differ by design) and its collectives a step against the
    layer structure, none of a weight's shape; 0 kernels in a cached decode step and L flash
    forwards a prefill. Logs the step's ms and each rank's peak beside the one-rank run's and the
    backend; then dgrad, the batch-1 causal kernels and
    the flash prefill at a rank's shapes against their plain versions, timed. ``tower_cases``: the
    replicated tower's and projector's dgrad cases at a data rank's batch."""
    import torch

    from adversarialvlm_tpu_torch.parallel.sharding import local_heads

    t_phase = time.perf_counter()
    data, model = shape
    t = vlm_cfg.text
    ranks, one, tens, mesh_s, one_s = mesh_runs(tag, argv, mesh_flags, data * model, out_dir)
    rel, g_cos, logit_cos = mesh_step1(tag, ranks, one, tens)
    # launches and collectives a step, from the layer structure
    L = t.num_layers
    want_coll = {"reduce_from_model": 1 + 2 * L if model > 1 else 0, "gather_from_model": 1 if model > 1 else 0,
                 "copy_to_model": 2 * L + 1 if model > 1 else 0, "data": 1 if data > 1 else 0}
    mesh_step_checks(tag, ranks, one, want_step, want_one, want_coll)
    for r in ranks:
        for c in r["chunks"]:
            if c["prefill_launches"] != {**{k: 0 for k in c["prefill_launches"]}, "flash_fwd": L}:
                raise AssertionError(f"{tag}: rank {r['rank']}: a decode prefill launched {c['prefill_launches']}")
        if r["decode_step_launches"] or not r["chunks"]:
            raise AssertionError(f"{tag}: rank {r['rank']}: a cached decode step launched a kernel, or no chunk ran")
    st0 = ranks[0]["steps"]
    log(tag, f"a rank's step: launches {st0[0]['launches']}, by head dim {st0[0]['launches_d']}; collectives "
        f"{st0[0]['collectives']} carrying {st0[0]['collective_bytes']} bytes, shapes {st0[0]['shapes']}; none of the "
        f"{len(ranks[0]['weight_shapes'])} weight shapes; the one-rank step: {one['steps'][0]['launches']}")
    numbers = mesh_numbers(ranks, one, rel[0], g_cos, logit_cos, mesh_s, one_s)
    numbers.update({
        "chunks": [(c["batch"], c["T"], round(c["prefill_ms"], 2), round(c["tokens"] / c["decode_ms"] * 1e3, 1))
                   for c in ranks[0]["chunks"]],
        "one_chunks": [(c["batch"], c["T"], round(c["prefill_ms"], 2), round(c["tokens"] / c["decode_ms"] * 1e3, 1))
                       for c in one["chunks"]],
    })
    log(tag, f"step 2 ms by rank {[round(x, 2) for x in numbers['step_ms']]} against the one-rank run's "
        f"{numbers['one_step_ms']:.2f}; steps' peak GiB by rank {[round(x, 3) for x in numbers['peak_GiB']]} against "
        f"{numbers['one_peak_GiB']:.3f}; decode chunks (batch, T, prefill ms, tokens/s) rank 0 "
        f"{numbers['chunks']}, one-rank {numbers['one_chunks']}")
    # the kernels at a rank's shapes
    hq, hkv = local_heads(t.num_heads, t.num_kv_heads, model)
    r0 = ranks[0]
    rows_t = len(r0["pads"]) * r0["T"]
    cases = tower_cases + tp_decoder_dgrad_cases(t, rows_t, model)
    if sum(c[3] for c in cases) != want_step["dgrad"]:
        raise AssertionError(f"{tag}: the layer structure gives {sum(c[3] for c in cases)} dgrad launches a step")
    stats = {"dgrad": check_dgrad(cases, label=f"dgrad {tag} rank")}
    route = "attention" if len(r0["pads"]) == 1 else "flash"
    if route == "attention":
        stats.update(attention_case(r0["T"], hq, hkv, t.head_dim_, r0["pads"][0], timed=True))
    stats["flash_fwd"] = flash_case(f"{tag} decode prefill", tens["rank0"]["prefill_mask"].to("cuda", torch.int32), hq,
                                    hkv, t.head_dim_, timed=True, backward=False)["flash_fwd"]
    log(tag, f"phase in {time.perf_counter() - t_phase:.1f} s")
    per_step = {**want_step, "flash_fwd": L}  # the flash forward's launches are a decode prefill's
    return {"numbers": numbers, "stats": stats, "per_step": per_step, "heads": (hq, hkv), "T": r0["T"],
            "launches": r0["launches_run"], "seconds": time.perf_counter() - t_phase}


def mesh_args(ckpt_root, runs):
    """The attack flags 4T and 4TL share: gray.png, the target, lr 1e-2, STEPS_MESH steps."""
    gray = os.path.join(os.path.dirname(os.path.abspath(__file__)), "images", "gray.png")
    return ["--img_orig", gray, "--target_text", TARGET, "--lr", "1e-2", "--num_iterations", str(STEPS_MESH),
            "--save_steps", "10", "--checkpoint_root", ckpt_root, "--runs_path", runs]


def qwen_mesh_phase(ckpt_root, runs, q_cfg):
    """Phase 4T: scripts/attacks/attack_clamp_tanh_qwen2vl.sh as written (--mesh_data 2 --mesh_model 4,
    batch 2) on the depth-cut Qwen2-VL-2B directory of configuration ``q_cfg`` under ``ckpt_root``, beside
    the same command on one rank, through :func:`mesh_phase`: a data rank's batch 1 takes the batch-1
    causal kernels, the one-rank batch 2 the flash ones; dgrad a step the layer structure's."""
    import torch

    from adversarialvlm_tpu_torch.models import qwen2vl as qwen_model

    params = qwen_model.init_params(torch.Generator(device="cuda").manual_seed(0), q_cfg, torch.bfloat16, "cuda")
    n_patch = 1296  # 512² -> 504²: a 36 x 36 grid
    t_text_guess = 1  # the decoder rows come from the run; only the tower's cases are kept here
    cases = qwen_dgrad_cases(params, q_cfg, 1, t_text_guess, n_patch)
    tower, n_dgrad = [c for c in cases if c[0] != t_text_guess], sum(c[3] for c in cases)
    del params, cases
    torch.cuda.empty_cache()
    L = q_cfg.text.num_layers
    return mesh_phase(
        "4T", ["--exp_name", "qwen_mesh", "--prompt", "list", "--model_name", QWEN, "--batch_size", "2",
               *mesh_args(ckpt_root, runs)],
        ["--mesh_data", "2", "--mesh_model", "4"], (2, 4), q_cfg, tower,
        {"dgrad": n_dgrad, "attention_fwd": L, "attention_bwd_dq": L, "attention_bwd_dkdv": L},
        {"dgrad": n_dgrad, "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkdv": L}, os.path.join(runs, "mesh_4T"))


def llava_mesh_phase(ckpt_root, runs, l_cfg):
    """Phase 4TL: the main path's victim at bench.py's configuration (batch 1), --mesh_model 2 (its 32
    MHA heads split 16 a rank), on the depth-cut LLaVA-1.5-7B directory of configuration ``l_cfg``
    under ``ckpt_root``, beside the same command on one rank, through :func:`mesh_phase`."""
    import torch

    from adversarialvlm_tpu_torch.models import llava as llava_model

    params = llava_model.init_params(torch.Generator(device="cuda").manual_seed(0), l_cfg, torch.bfloat16, "cuda")
    cases = llava_dgrad_cases(params, l_cfg, 1, 1)
    tower, n_dgrad = [c for c in cases if c[0] != 1], sum(c[3] for c in cases)
    del params, cases
    torch.cuda.empty_cache()
    L = l_cfg.text.num_layers
    want = {"dgrad": n_dgrad, "attention_fwd": L, "attention_bwd_dq": L, "attention_bwd_dkdv": L}
    return mesh_phase(
        "4TL", ["--exp_name", "llava_mesh", "--prompt", QUESTION, "--model_name", LLAVA, "--batch_size", "1",
                *mesh_args(ckpt_root, runs)],
        ["--mesh_model", "2"], (1, 2), l_cfg, tower, want, want, os.path.join(runs, "mesh_4TL"))


# --- scripts/attacks/attack_cross.sh: Phi-3.5-vision + Llama-3.2-11B-Vision + Qwen2-VL-2B ------------

STEPS_X3 = 3              # phases 4X3 and 4T3: 1 warm-up + 2 timed; save boundaries at iterations 0 and 2
X3_NAMES = (PHI, MLLAMA, QWEN)  # attack_cross.sh's --model_names, in its order
X3_LABELS = ("phi3v", "mllama", "qwen2vl")
X3_MODELS = ("phi3.5-vision", "mllama-11b", "qwen2vl-2b")  # cli/fabricate_ckpt.py's names of the three
X3_WEIGHTS = (1.0, 1.0, 1.0)  # the script passes no --model_weights: 1.0 each
X3_REF_TEXT = 2           # phase 4X3's depth-cut reference: Phi-3.5's and Qwen2-VL's first 2 decoder and
X3_REF_VISION = 2         # 2 tower layers; mllama's cut is 5M's (decoder layers 0-3, 2 local + 1 global)
# the mesh phases' depth cut (PERF.md §4): every width the configuration's; the first decoder layers of
# each victim (mllama's: cross layer 3 and the self-attention layer after it, so its backward runs),
# mllama's tower 2 local + 1 global layers at T 6432; the other towers whole
CUT_TEXT = {"phi3.5-vision": 4, "mllama-11b": 5, "qwen2vl-2b": 4, "llava-1.5-7b": 4}
T3_MODEL = 8              # attack_cross.sh's --mesh_model


def x3_dgrad_cases(victims, ts):
    """(rows, O, I, launches per step, weight) of a batch-1 cross step of the three victims, each
    from its family's own (:func:`phi_dgrad_cases`, :func:`mllama_dgrad_cases`,
    :func:`qwen_dgrad_cases`) at the run's T."""
    from adversarialvlm_tpu_torch.processors import grid_hw_for

    (hv, mv, qv), (t_h, t_m, t_q) = victims, ts
    grid = grid_hw_for("phi3v", hv.adv_processor, (512, 512))
    _, gh, gw = qv.adv_processor.grid_thw((512, 512))
    k_rows = int(mv.adv_inputs.target_pool.shape[1]) + 1
    return (phi_dgrad_cases(hv.bundle.params, hv.bundle.cfg, 1, t_h, 1 + grid[0] * grid[1],
                            hv.adv_inputs.num_image_tokens)
            + mllama_dgrad_cases(mv.bundle.params, mv.bundle.cfg, t_m, k_rows)
            + qwen_dgrad_cases(qv.bundle.params, qv.bundle.cfg, 1, t_q, gh * gw))


def cross3_phase(ckpt_root, runs):
    """Phase 4X3: scripts/attacks/attack_cross.sh as written on one rank (its flags, its three model
    names; no --mesh_model, whose 8 ranks 4T3 runs), the three victims at full width and depth from
    the directories of 4H, 4M and 4V, resident on the card together, through :func:`pair_cross_phase`:
    a cross step launches exactly each victim's own (dgrad, the batch-1 causal kernels at head_dim
    96 and at 128 with n_rep 4 and 6, no flash_full), each kernel at the run's shapes, the test
    decode of each victim (MESH_TEST_QUESTIONS questions of MESH_DECODE_TOKENS tokens) and its
    prefill's flash forward, and the depth-cut cross reference (:func:`cross3_reference`)."""
    def kernel_cases(victims, ts, pads, probes):
        out = {}
        for label, v, t_len, pad, probe in zip(X3_LABELS, victims, ts, pads, probes):
            t = v.bundle.cfg.text
            out[label] = attention_case(t_len, t.num_heads, t.num_kv_heads, t.head_dim_, pad, timed=True)
            out[label]["flash_fwd"] = flash_case(f"cross3 {label} test-decode prefill", probe.chunks[0]["mask"].cuda(),
                                                 t.num_heads, t.num_kv_heads, t.head_dim_, timed=True,
                                                 backward=False)["flash_fwd"]
        return out

    return pair_cross_phase("cross3", list(X3_NAMES), X3_LABELS, ckpt_root, runs, [], x3_dgrad_cases, kernel_cases,
                            reference=cross3_reference, n_steps=STEPS_X3, profile=False)


def cross3_reference(victims, x0, tag="cross3"):
    """Phase 4X3's depth-cut reference: the cross step of the three victims cut (Phi-3.5 and Qwen2-VL:
    the first X3_REF_TEXT decoder and X3_REF_VISION tower layers; mllama: 5M's cut), from the loaded
    weights, with the script's weights X3_WEIGHTS, on the card in bf16 through the kernels against the
    CPU in f32 on the plain path (in the worker), with the same injected draws: each victim's loss
    and the total within TOL_REF_LOSS relative, the perturbation gradient at cosine >=
    TOL_REF_COSINE."""
    import dataclasses

    import torch

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import VictimSetup
    from adversarialvlm_tpu_torch.attack.step import build_attack_step
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
    from adversarialvlm_tpu_torch.processors import grid_hw_for, normalize_pixel_inputs
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs

    t0 = time.perf_counter()
    cfg = AttackConfig(exp_name="reference_cross3", batch_size=1, grad_accum_steps=1, lr=1e-2, epsilon=0.4)
    gen = torch.Generator().manual_seed(9)
    cut_victims, noise, cpu_victims = [], [], []
    for v in victims:
        vc, family = v.bundle.cfg, v.bundle.family
        if family == "mllama":
            params, cut = mllama_depth_cut(v.bundle.params, vc)
        else:
            cut = dataclasses.replace(vc, text=dataclasses.replace(vc.text, num_layers=X3_REF_TEXT),
                                      vision=dataclasses.replace(vc.vision, num_layers=X3_REF_VISION))
            params = depth_cut(v.bundle.params, X3_REF_TEXT, X3_REF_VISION)
        a = v.adv_inputs
        inputs = AdvInputs(a.spec, a.tokenizer, [QUESTION], [QUESTION], 1, [TARGET], a.num_image_tokens,
                           a.image_token_id, a.pad_token_id, image_expansion_ids=a.image_expansion_ids)
        grid = grid_hw_for(family, v.adv_processor, (512, 512), cut)
        gpu = VictimSetup(f"cut-{family}", make_bundle("cut", family, cut, torch.device("cuda"), params=params,
                                                       grid_hw=grid), v.adv_processor, inputs, torch.bfloat16)
        cut_victims.append(gpu)
        cpu_victims.append(reference_victim(family, cut, gpu.bundle.params, grid, inputs))
        with torch.no_grad():
            pv = normalize_pixel_inputs(family, v.adv_processor.process(
                torch.as_tensor(x0, device="cuda")))["pixel_values"]
        noise.append(torch.randn((1, *pv.shape[1:]), generator=gen))
    p0 = 0.3 * torch.randn(x0.shape, generator=gen)
    xs = {"t_idx": 0, "rows": [torch.from_numpy(g.adv_inputs.prompt_pool[0, [0]]) for g in cut_victims],
          "lens": [torch.from_numpy(g.adv_inputs.prompt_lengths[0, [0]]) for g in cut_victims], "noise": noise}
    x0_d = torch.as_tensor(x0, device="cuda")
    step = build_attack_step([g.handles() for g in cut_victims], cfg, x0_d, torch.ones_like(x0_d),
                             model_weights=list(X3_WEIGHTS), cross=True)
    reset_launches()
    loss, img_loss, ces, _, grad = step.loss_and_grad(p0.cuda(), xs, torch.tensor(cfg.sigma, device="cuda"))
    card = ([float(loss), *[float(w * ce + img_loss) for w, ce in zip(X3_WEIGHTS, ces)]], grad.double().cpu())
    counts = launch_counts()
    log("reference", f"{tag} cuda: loss, loss_0..2 = {card[0]} grad_norm={float(grad.norm())} "
        f"T={[g.adv_inputs.max_len for g in cut_victims]} launches={ {k: n for k, n in counts.items() if n} } "
        f"in {time.perf_counter() - t0:.1f} s")
    texts = [g.bundle.cfg.text for g in cut_victims]
    n_fwd, n_bwd = sum(map(n_self_layers, texts)), sum(map(n_backward_layers, texts))
    want = {"attention_fwd": n_fwd, "attention_bwd_dq": n_bwd, "attention_bwd_dkdv": n_bwd}
    if any(counts[k] != n for k, n in want.items()) or counts["dgrad"] == 0 or any(
            counts[k] for k in counts if k.startswith("flash")):
        raise AssertionError(f"{tag} depth-cut step launched {counts}, expected {want}, dgrad and no flash kernel")
    reference = {}
    REFS.submit(tag, {"victims": cpu_victims, "x0": x0, "p0": p0, "steps": [("cross", xs, cfg, X3_WEIGHTS)]},
                lambda out: check_step_reference(tag, card, out["steps"]["cross"], reference))
    return reference


def cut_directories(root, models):
    """The mesh phases' depth-cut directories of ``models`` (CUT_TEXT; mllama's tower cut as
    :func:`mllama_cut_config`) under ``root``, each written by the port's fabricator from the seed-0
    parameters of its cut configuration drawn on the card; returns {model: (its cut configuration,
    GB written)}."""
    import dataclasses

    import torch

    from adversarialvlm_tpu_torch.cli.fabricate_ckpt import MODELS, fabricate
    from adversarialvlm_tpu_torch.models.registry import _MODELS
    from adversarialvlm_tpu_torch.processors import family_of

    out = {}
    t0 = time.perf_counter()
    for model in models:
        hf_name, make_cfg, dtype = MODELS[model]
        full, family = make_cfg(), family_of(hf_name)
        cut = (mllama_cut_config(full, CUT_TEXT[model]) if family == "mllama"
               else dataclasses.replace(full, text=dataclasses.replace(full.text, num_layers=CUT_TEXT[model])))
        params = _MODELS[family].init_params(torch.Generator(device="cuda").manual_seed(0), cut, dtype, "cuda")
        path = fabricate(model, root, params=params, cfg=cut)
        del params
        torch.cuda.empty_cache()
        gb = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path) if f.endswith(".safetensors")) / 1e9
        out[model] = (cut, gb)
        log("disk", f"{hf_name} cut to {cut.text.num_layers} decoder layers (cross {cut.text.cross_attention_layers}), "
            f"tower {cut.vision.num_layers} + {getattr(cut.vision, 'num_global_layers', 0)} layers: {gb:.3f} GB written")
    log("disk", f"{len(models)} depth-cut directories in {time.perf_counter() - t0:.1f} s; free disk "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB")
    return out


def tp_rank_kinds(t, model):
    """{(query heads, kv heads): the model ranks holding that many} of ``t``'s decoder at ``model``."""
    from adversarialvlm_tpu_torch.parallel.sharding import local_heads

    kinds = {}
    for r in range(model):
        kinds.setdefault(local_heads(t.num_heads, t.num_kv_heads, model, r), []).append(r)
    return kinds


def mesh_cross_phase(ckpt_root, runs, cuts):
    """Phase 4T3: scripts/attacks/attack_cross.sh as written, ``--mesh_model 8``, 8 gloo ranks sharing
    the card, on the depth-cut directories ``cuts`` of :func:`cut_directories` under ``ckpt_root`` (full
    width), beside the same command on one rank: every rank's p bit for bit equal after each step; step 1's loss and each
    victim's within TOL_MESH_LOSS of the one-rank run's, its image gradient and the first decode
    prefill's last logits (Phi-3.5's) at cosine >= TOL_MESH_COSINE; a rank's launches a step exactly
    the three layer structures' (dgrad by each whole weight, the batch-1 causal kernels at D 96 and
    128), its collectives a step the three decoders' (each: 1 + 2L reductions and one gather forward;
    backward 2L + 1 input-gradient all-reduces, mllama's 2(L - first cross layer) + 1), none of a
    weight's shape; the backend. Then the kernels at each kind of rank's local shapes (Qwen2-VL's 12
    heads over 2 at 8: ranks of 2 and of 1 query head over one kv head; Phi-3.5's 4 MHA heads of 96;
    mllama's 4 over 1), against their plain versions, timed."""
    import torch

    from adversarialvlm_tpu_torch.models.registry import _MODELS

    t_phase = time.perf_counter()
    argv = ["--exp_name", "gray_crossattack_phi_llama_qwen_0.4", "--img_orig",
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "images", "gray.png"), "--prompt", "list",
            "--target_text", TARGET, "--model_names", ",".join(X3_NAMES), "--lr", "1e-2", "--num_iterations",
            str(STEPS_X3), "--save_steps", "10", "--batch_size", "1", "--epsilon", "0.4", "--target_text_random",
            "--checkpoint_root", ckpt_root, "--runs_path", runs]
    ranks, one, tens, mesh_s, one_s = mesh_runs("4T3", argv, ["--mesh_model", str(T3_MODEL)], T3_MODEL,
                                                os.path.join(runs, "mesh_4T3"), cross=True)
    rel, g_cos, logit_cos = mesh_step1("4T3", ranks, one, tens)
    # launches and collectives a step, from the three layer structures
    texts = [cut.text for cut, _ in (cuts[m] for m in X3_MODELS)]
    meta = [_MODELS[c.family].init_params(None, c, torch.bfloat16, "meta") for c, _ in (cuts[m] for m in X3_MODELS)]
    dgrad_n = sum(c[3] for c in x3_meta_dgrad_cases(meta, [c for c, _ in (cuts[m] for m in X3_MODELS)]))
    n_fwd, n_bwd = sum(map(n_self_layers, texts)), sum(map(n_backward_layers, texts))
    want_step = {"dgrad": dgrad_n, "attention_fwd": n_fwd, "attention_bwd_dq": n_bwd, "attention_bwd_dkdv": n_bwd}
    want_d = {}
    for t in texts:
        for k, n in (("attention_fwd", n_self_layers(t)), ("attention_bwd_dq", n_backward_layers(t)),
                     ("attention_bwd_dkdv", n_backward_layers(t))):
            want_d[f"{k}_d{t.head_dim_}"] = want_d.get(f"{k}_d{t.head_dim_}", 0) + n
    want_coll = {"reduce_from_model": sum(1 + 2 * t.num_layers for t in texts), "gather_from_model": len(texts),
                 "copy_to_model": sum(2 * (t.num_layers - min(t.cross_attention_layers, default=0)) + 1 for t in texts),
                 "data": 0}
    mesh_step_checks("4T3", ranks, one, want_step, want_step, want_coll, want_d)
    for r in ranks:
        n_pref = {c["T"]: c["prefill_launches"] for c in r["chunks"]}
        if len(r["chunks"]) != 2 * len(texts) or r["decode_step_launches"] or any(
                sum(c.values()) != c["flash_fwd"] or c["flash_fwd"] not in [n_self_layers(t) for t in texts]
                for c in n_pref.values()):
            raise AssertionError(f"4T3: rank {r['rank']}: decode chunks {len(r['chunks'])}, prefill launches "
                                 f"{n_pref}, cached-step launches {r['decode_step_launches']}")
    st0 = ranks[0]["steps"]
    numbers = {**mesh_numbers(ranks, one, rel, g_cos, logit_cos, mesh_s, one_s),
               "cut_GB": {m: round(gb, 3) for m, (_, gb) in cuts.items()}}
    log("4T3", f"a rank's step: launches {st0[0]['launches']}, by head dim {st0[0]['launches_d']}; collectives "
        f"{st0[0]['collectives']} carrying {st0[0]['collective_bytes']} bytes; none of the "
        f"{len(ranks[0]['weight_shapes'])} weight shapes; step 2 ms by rank {[round(x, 2) for x in numbers['step_ms']]} "
        f"against the one-rank run's {numbers['one_step_ms']:.2f}; steps' peak GiB by rank "
        f"{[round(x, 3) for x in numbers['peak_GiB']]} against {numbers['one_peak_GiB']:.3f}")
    # the kernels at each kind of rank's local shapes, at rank 0's T of each victim (batch 1)
    stats = {}
    r0 = ranks[0]
    for label, t, t_len, pads in zip(X3_LABELS, texts, r0["Ts"], r0["pads_by_victim"]):
        for (hq, hkv), held in sorted(tp_rank_kinds(t, T3_MODEL).items(), reverse=True):
            key = f"{label}_{hq}q{hkv}kv"
            cases = tp_decoder_dgrad_cases(t, t_len, T3_MODEL, held[0])
            st = {"dgrad": check_dgrad(cases, label=f"dgrad 4T3 {key} rank")}
            st.update(attention_case(t_len, hq, hkv, t.head_dim_, pads[0], timed=True))
            st["ranks"], st["heads"], st["T"] = held, [hq, hkv], t_len
            stats[key] = st
            log("4T3", f"{label} ranks {held}: {hq} query heads over {hkv} kv heads of {t.head_dim_}, T {t_len}: the "
                f"local dgrad shapes {[(c[0], c[1], c[2]) for c in cases]} and the batch-1 causal kernels held")
    log("4T3", f"phase in {time.perf_counter() - t_phase:.1f} s")
    return {"numbers": numbers, "stats": stats, "per_step": want_step, "launches": r0["launches_run"],
            "seconds": time.perf_counter() - t_phase}


def x3_meta_dgrad_cases(params, cfgs):
    """:func:`x3_dgrad_cases` on the three victims' meta-device trees: the launches a step of each
    eligible shape, for counting (the rows are placeholders)."""
    (hp, mp, qp), (hc, mc, qc) = params, cfgs
    return (phi_dgrad_cases(hp, hc, 1, 1, 5, 1) + mllama_dgrad_cases(mp, mc, 1, 1)
            + qwen_dgrad_cases(qp, qc, 1, 1, 1296))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    from adversarialvlm_tpu_torch.models.configs import gemma3_4b_it
    from adversarialvlm_tpu_torch.ops.kernels.build import build_all

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32 in every reference
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    log("card", card)
    log("card", f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. the build
    t0 = time.perf_counter()
    built = build_all()
    for name, res in built.items():
        for line in res.log.splitlines():
            if any(s in line for s in ("registers", "spill", "stack frame", "Compiling entry")):
                log("build", f"{name}: {line.strip()}")
        log("build", f"{name}: {res.path.name} in {res.seconds:.1f} s")
    log("build", f"{len(built)} kernel libraries ready in {time.perf_counter() - t0:.1f} s")
    if sorted(built) != ["causal_bwd", "causal_fwd", "dgrad", "flash_full"]:
        raise AssertionError(f"expected the four wgmma libraries, built {sorted(built)}")
    wgmma_kernels = {"flash_full": ("full_fwd_kernel", "full_dq_kernel", "full_dkdv_kernel"),
                     "dgrad": ("dgrad_kernel",), "causal_fwd": ("causal_fwd_kernel", "causal_fwd256_kernel"),
                     "causal_bwd": ("causal_dq_kernel", "causal_dkdv_kernel", "causal_dkdv_split_kernel")}
    # head_dim 256's kernels and the mark of that instantiation in their mangled names
    d256 = {"causal_fwd256_kernel": "", "causal_dq_kernel": "ILi256E", "causal_dkdv_split_kernel": "ILi256E"}
    # flash_full's kernels at head_dim 72 (SigLIP) and 80 (Qwen2-VL's tower), one instantiation each
    full_dims = {"full_fwd_kernel", "full_dq_kernel", "full_dkdv_kernel"}
    # the causal kernels at head_dim 96 (Phi-3.5's decoder; the causal one of each is also fused_sdpa's)
    d96 = {"causal_fwd_kernel", "causal_dq_kernel", "causal_dkdv_kernel"}
    for lib, kernels in wgmma_kernels.items():
        hgmma = hgmma_counts(built[lib].path)
        for kernel in kernels:
            counts = [c for name, c in hgmma.items() if kernel in name]
            at256 = [c for name, c in hgmma.items() if kernel in name and d256.get(kernel, "@") in name]
            log("build", f"{lib}: {kernel}, {len(counts)} instantiations, holds {counts} HGMMA instructions "
                f"in their SASS" + (f"; at head_dim 256: {at256}" if kernel in d256 else ""))
            if not counts or min(counts) == 0:
                raise AssertionError(f"{lib}: {kernel} was compiled without wgmma (no HGMMA in its SASS)")
            if kernel in d256 and (len(at256) != 1 or at256[0] == 0):
                raise AssertionError(f"{lib}: {kernel} has no head_dim-256 instantiation holding HGMMA")
            if kernel in full_dims:
                by_d = {d: [c for name, c in hgmma.items() if kernel in name and f"ILi{d}E" in name] for d in (72, 80)}
                log("build", f"{lib}: {kernel} HGMMA instructions by head dim {by_d}")
                if any(len(c) != 1 or c[0] == 0 for c in by_d.values()):
                    raise AssertionError(f"{lib}: {kernel} lacks a head_dim-72 or -80 instantiation holding HGMMA")
            if kernel in d96:
                at96 = {name: c for name, c in hgmma.items() if kernel in name and "ILi96E" in name}
                log("build", f"{lib}: {kernel} at head_dim 96 (causal and segment-only): {list(at96.values())} "
                    "HGMMA instructions")
                if len(at96) != 2 or min(at96.values()) == 0:
                    raise AssertionError(f"{lib}: {kernel} lacks head_dim-96 instantiations holding HGMMA")
        spills = spill_lines(built[lib].log)
        log("build", f"{lib}: ptxas reports {len(spills)} spilling functions")
        if spills:
            raise AssertionError(f"{lib}: ptxas spills registers: {spills}")

    # 3. the non-causal flash_full kernels at the SigLIP tower's shapes (B = the step's batch of
    # 4 images; batch 1, the decode prefill's one shared image among them, in 4X) and a ragged
    # case, before any victim
    g = gemma3_4b_it().vision
    g_t, g_h, g_d = (g.image_size // g.patch_size) ** 2, g.num_heads, g.hidden_size // g.num_heads
    full = flash_full_case("gemma3 step", 4, g_h, g_t, g_d, timed=True)
    flash_full_case("ragged", 2, 4, 2100, g_d)

    # 3. the fused_sdpa kernels at its harness's own shape (its defaults: the path below), at the
    # 7B decoder's batch-1 T of 641, at head_dim 96, and non-causal with and without pads; then
    # its path, the harness
    from adversarialvlm_tpu_torch.cli.bench_fused_attention import DEFAULTS, PADS
    fused = fused_case("harness shape", 1, DEFAULTS["H"], DEFAULTS["T"], DEFAULTS["D"], True, PADS,
                       timed=True)
    fused_641 = fused_case("7B decoder T", 1, 32, 641, 128, True, 23, timed=True)
    fused_d96 = fused_case("head_dim 96", 1, 32, 641, 96, True, 0, timed=True)
    fused_case("non-causal, pads", 2, 8, 310, 64, False, 17, timed=True)
    fused_case("non-causal", 1, 4, 150, 32, False, 0, timed=True)
    # packed segments crossing tile boundaries: more than two ids, an id that recurs after another
    # (non-monotone), left pads, tiles of one id (walked unmasked) and disjoint intervals (skipped)
    runs = [[(0, 23), (1, 90), (2, 150), (1, 40), (3, 200), (2, 107)], [(3, 128), (4, 200), (5, 282)]]
    fused_case("packed segments", 2, 8, 610, 128, True, runs=runs)
    fused_case("packed segments, non-causal", 2, 8, 610, 64, False, runs=runs)
    fused_launches = fused_harness()
    torch.cuda.empty_cache()

    # 3. the head_dim-256 causal kernels at the Gemma-3 judge's text-only prefill shape
    judge = judge_cases()
    torch.cuda.empty_cache()

    # both checkpoint directories stay under one root until the cross phases have loaded them
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "adversarialvlm_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="ckpt_", dir=build)
    cut_root = tempfile.mkdtemp(prefix="ckpt_cut_", dir=build)  # the mesh phases' depth cuts, under the same names
    runs = tempfile.mkdtemp(prefix="runs_", dir=build)
    global REFS
    REFS = CpuReferences(runs)
    try:
        llava = llava_phases(ckpt_root)
        gc.collect()
        torch.cuda.empty_cache()
        log("bench", f"LLaVA victim freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        bench = bench_phase()
        gc.collect()
        torch.cuda.empty_cache()
        gem = gemma_phases(ckpt_root)
        gemma_references(gem.pop("victim"))
        gc.collect()
        torch.cuda.empty_cache()
        log("cross", f"Gemma-3 victim freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        with shared_loads("cross, judge eval and baselines"):  # 4X, its blur run, 4D, 4J and 4B read each directory once
            cross = cross_phases(ckpt_root, runs)
            gc.collect()
            torch.cuda.empty_cache()
            log("judge eval", f"cross victims freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
                "(the shared trees stay)")
            evals = judge_eval_phases(ckpt_root, runs, cross["exp"])
            gc.collect()
            torch.cuda.empty_cache()
            log("baselines", f"eval victims freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
                "(the shared trees stay)")
            base = baseline_phases(ckpt_root, runs)
        gc.collect()
        torch.cuda.empty_cache()
        log("int8", f"baseline victims and the shared trees freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            "on the card")
        quant = int8_phases(ckpt_root, runs, evals, llava)
        gc.collect()
        torch.cuda.empty_cache()
        log("qwen", f"int8 victims freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        qwen = qwen_phases(ckpt_root, runs)
        gc.collect()
        torch.cuda.empty_cache()
        log("cross qwen", f"Qwen2-VL victims freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        xq = qwen_cross_phases(ckpt_root, runs)
        drop_dirs(ckpt_root, ("google/gemma-3-4b-it",))  # its last phase was 4XV; Qwen2-VL's stays for 4X3 and 4T
        gc.collect()
        torch.cuda.empty_cache()
        # the order keeps at most three of the largest directories on the disk at once (the script's disk
        # budget, module docstring): LLaVA's goes after 4XH, before mllama's is written for 4M and 4X3
        log("phi", f"Qwen2-VL + Gemma-3 victims freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        phi = phi_phases(ckpt_root, runs)
        gc.collect()
        torch.cuda.empty_cache()
        log("cross phi", f"Phi-3.5 victim freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        xh = phi_cross_phases(ckpt_root, runs)  # Phi-3.5's directory stays for 4X3
        drop_dirs(ckpt_root, (LLAVA,))  # its last phase at full depth was 4XH
        gc.collect()
        torch.cuda.empty_cache()
        REFS.join()  # the references' CPU halves so far, before the mesh's ranks take the host
        log("mesh", f"LLaVA + Phi-3.5 victims freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        cut = cut_directories(cut_root, ("llava-1.5-7b",))
        mesh = {"4TL": llava_mesh_phase(cut_root, runs, cut["llava-1.5-7b"][0])}
        drop_dirs(cut_root, (LLAVA,))
        gc.collect()
        torch.cuda.empty_cache()
        log("mllama", f"4TL's ranks done: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        ml = mllama_phases(ckpt_root, runs)  # its directory stays for 4X3
        gc.collect()
        torch.cuda.empty_cache()
        log("cross3", f"mllama victim freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        x3 = cross3_phase(ckpt_root, runs)
        drop_dirs(ckpt_root, X3_NAMES)  # their last phase at full depth was 4X3
        gc.collect()
        torch.cuda.empty_cache()
        # 4T3 runs beside the worker's last CPU halves (5M's and 4X3's); 4T after them, on 4T3's Qwen2-VL cut
        log("mesh", f"Phi-3.5 + mllama + Qwen2-VL victims freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on "
            "the card")
        cut = cut_directories(cut_root, X3_MODELS)
        t3 = mesh_cross_phase(cut_root, runs, cut)
        REFS.join()
        mesh["4T"] = qwen_mesh_phase(cut_root, runs, cut["qwen2vl-2b"][0])
        drop_dirs(cut_root, X3_NAMES)
    finally:
        REFS.pool.shutdown(cancel_futures=True)
        shutil.rmtree(ckpt_root)
        shutil.rmtree(cut_root)
        shutil.rmtree(runs)

    for name, st in (("llava-1.5-7b", llava["load"]), ("gemma-3-4b", gem["load"])):
        log("done", f"{name} checkpoint directory: {st['GB']:.3f} GB written in {st['write_s']:.1f} s "
            f"({st['GB'] / st['write_s']:.2f} GB/s), loaded in {st['load_s']:.1f} s "
            f"({st['GB'] / st['load_s']:.2f} GB/s), peak {st['peak_GiB']:.3f} GiB")
    log("done", f"resume: {llava['resume']['verdict']}; bench: {json.dumps(bench)}")
    prof = cross["profiled"]
    log("done", f"cross step (LLaVA-1.5-7B + Gemma-3-4B-it, batch 1), ms a step in turns over {PROFILE_ROUNDS} "
        f"rounds of {TIMED_STEPS}: " + "; ".join(f"{k} {prof[k]['round_ms']}" for k in ("cross", "llava", "gemma3"))
        + f"; the cross step over the sum of the two alone {prof['ratios']}; device busy a step "
        f"{ {k: prof[k]['busy_ms'] for k in ('cross', 'llava', 'gemma3')} } ms; steps' peak "
        f"{cross['step_peak_GiB']:.3f} GiB (run peak, test decode included, {cross['run_peak_GiB']:.3f}); "
        f"depth-cut reference {cross['reference']}; DPO resume: {cross['dpo']}")
    ea, eb = evals["A"], evals["B"]
    log("done", f"judge and eval (4J): stage A {ea['verdicts']} verdicts in {ea['calls']} judge calls, "
        f"{ea['verdicts_per_s']:.2f} verdicts/s, prefill ms {[round(x, 2) for x in ea['prefill_ms']]}, peak "
        f"{ea['peak_GiB']:.3f} GiB, the FSM built in {ea['build']} s, the table's builders on a sample "
        f"{evals['table']}; stage B (--iter {eb['iter']}, image {eb['iter'] + 1}) {eb['tokens_per_s']:.1f} tokens/s, "
        f"prefill ms {[round(x, 2) for x in eb['prefill_ms']]}, peak {eb['peak_GiB']:.3f} GiB; stage C "
        f"{evals['C']['verdicts_per_s']:.2f} verdicts/s, mean ASR {evals['C']['mean']}; depth-cut judge "
        f"{evals['reference']}")
    qn, qd = quant["numbers"], quant["decode"]
    log("done", f"int8 (4Q): LLaVA-1.5-7B loaded in {quant['load_s']:.1f} s, resident {qn['resident_GB']:.3f} GB "
        f"(quantized fraction {qn['quantized_fraction']:.4f}); the int8 step {qn['step_ms']:.2f} ms against the dense "
        f"{qn['dense_step_ms']:.2f} ({qn['step_ms'] / qn['dense_step_ms']:.3f}x); depth-cut reference "
        f"{quant['reference']}; load peak {qn['load_peak_GiB']:.3f} GiB, steps' peak {qn['step_peak_GiB']:.3f} GiB; the "
        f"int8-cache chunk {qd}; the int8 judge resident {qn['judge_resident_GB']:.3f} GB, verdict agreement "
        f"{qn['verdict_agreement']:.4f}, its calls (batch, T, prefill ms, median cached-step ms) "
        f"{[tuple(round(x, 2) for x in c) for c in qn['judge_calls']]} against the dense judge's "
        f"{[tuple(round(x, 2) for x in c) for c in qn['dense_judge_calls']]}")
    log("done", "baselines (4B): " + "; ".join(
        f"{m} {v['tokens_per_s']:.1f} tokens/s, prefill ms {[round(x, 2) for x in v['prefill_ms']]} at {v['shapes']}, "
        f"decode {v['decode_ms_per_row']:.1f} ms a row, peak {v['peak_GiB']:.3f} GiB" for m, v in base["suites"].items())
        + f"; host {base['host']}; phase {base['seconds']:.1f} s")
    qp = xq["profiled"]
    log("done", f"Qwen2-VL-2B (4V, 5V, 4V1, 4P; {qwen['seconds']:.1f} s): the batch-2 step {qwen['median_ms']:.2f} ms, "
        f"steps' peak {qwen['step_peak_GiB']:.3f} GiB, test-decode chunks {qwen['chunks']}; directory {qwen['GB']:.3f} GB "
        f"written in {qwen['write_s']:.1f} s; depth-cut reference {qwen['reference']}; the 1024² batch-1 step "
        f"{qwen['v1']['median_ms']:.2f} ms, peak {qwen['v1']['peak_GiB']:.3f} GiB; re-test {qwen['post']}")
    log("done", f"cross step (Qwen2-VL-2B + Gemma-3-4B-it, batch 1; 4XV, {xq['seconds']:.1f} s): {xq['median_ms']:.2f} ms "
        f"in the run; in turns over {PAIR_ROUNDS} rounds of {PAIR_TIMED}: "
        + "; ".join(f"{k} {qp[k]['round_ms']}" for k in ("cross", "qwen2vl", "gemma3"))
        + f"; the cross step over the sum of the two alone {qp['ratios']}; device busy a step "
        f"{ {k: qp[k]['busy_ms'] for k in ('cross', 'qwen2vl', 'gemma3')} } ms; steps' peak {xq['step_peak_GiB']:.3f} "
        f"GiB; depth-cut reference {xq['reference']}")
    hp = xh["profiled"]
    log("done", f"Phi-3.5-vision (4H, 5H; {phi['seconds']:.1f} s): the batch-2 step {phi['median_ms']:.2f} ms at T "
        f"{phi['T']}, steps' peak {phi['step_peak_GiB']:.3f} GiB, test-decode chunks {phi['chunks']}; directory "
        f"{phi['GB']:.3f} GB written in {phi['write_s']:.1f} s; depth-cut reference {phi['reference']}")
    log("done", f"cross step (LLaVA-1.5-7B + Phi-3.5-vision, int8, batch 1, T {xh['T']}; 4XH, {xh['seconds']:.1f} s): "
        f"{xh['median_ms']:.2f} ms in the run; resident GB (quantized fraction) {xh['resident']}; in turns over "
        f"{PAIR_ROUNDS} rounds of {PAIR_TIMED}: " + "; ".join(f"{k} {hp[k]['round_ms']}" for k in ("cross", "llava", "phi3v"))
        + f"; the cross step over the sum of the two alone {hp['ratios']}; device busy a step "
        f"{ {k: hp[k]['busy_ms'] for k in ('cross', 'llava', 'phi3v')} } ms; steps' peak {xh['step_peak_GiB']:.3f} GiB")
    log("done", f"Llama-3.2-11B-Vision (4M, 5M; {ml['seconds']:.1f} s): the batch-1 step {ml['median_ms']:.2f} ms at T "
        f"{ml['T']}, steps' peak {ml['step_peak_GiB']:.3f} GiB, image-gradient norms {ml['grad_norms']}, test-decode "
        f"chunks {ml['chunks']}; directory {ml['GB']:.3f} GB written in {ml['write_s']:.1f} s; depth-cut reference "
        f"{ml['reference']}")
    rz = llava["remat"]
    log("done", "--remat_policy (4Z, LLaVA-1.5-7B batch 4): " + "; ".join(
        f"{k} {v['ms']:.2f} ms, peak {v['peak_GiB']:.3f} GiB ({v['above_resident_GiB']:.3f} above the weights), loss "
        f"rel {v['loss_rel']:.3g}, cosine {v['cosine']:.6f}, bit for bit {v['bitwise']}" for k, v in rz.items()))
    log("done", f"attack_cross.sh on one rank (4X3: Phi-3.5-vision + Llama-3.2-11B-Vision + Qwen2-VL-2B, batch 1, T "
        f"{x3['T']}; {x3['seconds']:.1f} s): {x3['median_ms']:.2f} ms a cross step; resident GB {x3['resident']}; steps' "
        f"peak {x3['step_peak_GiB']:.3f} GiB; test-decode chunks {x3['chunks']}; depth-cut reference {x3['reference']}")
    n3 = t3["numbers"]
    log("done", f"attack_cross.sh as written (4T3: --mesh_model {T3_MODEL}, backend {n3['backend']}, depth cut "
        f"{CUT_TEXT}, {n3['cut_GB']} GB; {t3['seconds']:.1f} s): step 2 ms by rank {[round(x, 2) for x in n3['step_ms']]} "
        f"against the one-rank run's {n3['one_step_ms']:.2f}; steps' peak GiB by rank "
        f"{[round(x, 3) for x in n3['peak_GiB']]} against {n3['one_peak_GiB']:.3f}; step 1 loss rel {[f'{r:.3g}' for r in n3['loss_rel']]}, "
        f"gradient cosine {n3['grad_cosine']:.6f}, prefill logits cosine {n3['logit_cosine']:.6f}")
    for tag, m in mesh.items():
        n = m["numbers"]
        log("done", f"{tag} (mesh, backend {n['backend']}, {m['seconds']:.1f} s): step 2 ms by rank "
            f"{[round(x, 2) for x in n['step_ms']]} against the one-rank run's {n['one_step_ms']:.2f}; steps' peak GiB "
            f"by rank {[round(x, 3) for x in n['peak_GiB']]} against {n['one_peak_GiB']:.3f}; step 1 loss rel {n['loss_rel']:.3g}, gradient cosine "
            f"{n['grad_cosine']:.6f}, prefill logits cosine {n['logit_cosine']:.6f}; decode chunks {n['chunks']} "
            f"(one-rank {n['one_chunks']})")
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s; the blur + crop step "
        f"{llava['transforms']['median_ms']:.2f} ms at batch 1")
    sources = {"dgrad": "dgrad.cu", "attention_fwd": "causal_fwd.cu", "attention_bwd_dq": "causal_bwd.cu",
               "attention_bwd_dkdv": "causal_bwd.cu", "flash_fwd": "causal_fwd.cu",
               "flash_bwd_dq": "causal_bwd.cu", "flash_bwd_dkdv": "causal_bwd.cu",
               "flash_full_fwd": "flash_full.cu", "flash_full_bwd_dq": "flash_full.cu",
               "flash_full_bwd_dkdv": "flash_full.cu", "fused_fwd": "causal_fwd.cu",
               "fused_bwd_dq": "causal_bwd.cu", "fused_bwd_dkdv": "causal_bwd.cu"}
    replaces = {
        "dgrad": "adversarialvlm_tpu/ops/pallas/matmul.py:35",
        "attention_fwd": "adversarialvlm_tpu/ops/pallas/fused_attention.py:436",
        "attention_bwd_dq": "adversarialvlm_tpu/ops/pallas/fused_attention.py:457",
        "attention_bwd_dkdv": "adversarialvlm_tpu/ops/pallas/fused_attention.py:457",
        "flash_fwd": "adversarialvlm_tpu/ops/pallas/attention.py:178",
        "flash_bwd_dq": "adversarialvlm_tpu/ops/pallas/attention.py:178",
        "flash_bwd_dkdv": "adversarialvlm_tpu/ops/pallas/attention.py:178",
        "flash_full_fwd": "adversarialvlm_tpu/ops/pallas/attention.py:214",
        "flash_full_bwd_dq": "adversarialvlm_tpu/ops/pallas/attention.py:214",
        "flash_full_bwd_dkdv": "adversarialvlm_tpu/ops/pallas/attention.py:214",
        "fused_fwd": "adversarialvlm_tpu/ops/pallas/fused_attention.py:208",
        "fused_bwd_dq": "adversarialvlm_tpu/ops/pallas/fused_attention.py:229",
        "fused_bwd_dkdv": "adversarialvlm_tpu/ops/pallas/fused_attention.py:229",
    }
    stats = {**llava["stats"], **full, **fused}
    counts = {**llava["counts"], **{k: gem["launches"][k] for k in full},
              **{k: fused_launches[k] for k in fused}}
    kernels = [
        {
            "name": name, "route": "cuda", "source": f"adversarialvlm_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": counts[name], "max_abs_err": stats[name]["abs"],
            "worst_row_rel_err": stats[name]["rel"], "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"], "bound_ms": stats[name]["bound_ms"],
            "bound_by": stats[name]["bound_by"], "library_ms": stats[name]["library_ms"],
            "library_call": stats[name].get("library_call"),
        }
        for name in sources
    ]
    timing_keys = ("ms", "plain_ms", "library_ms", "library_call", "bound_ms", "bound_by")

    def pick(stats, keys):  # the keys a case has: library_call only where SDPA is the yardstick
        return {k: stats[k] for k in keys if k in stats}

    kernels[4]["at_prefill_shape"] = pick(llava["prefill"], timing_keys)
    kernels[7]["at_prefill_shape"] = pick(cross["kernels"]["flash_full_fwd"], timing_keys)  # batch 1
    kernels[0]["at_llava_batch4_shapes"] = pick(llava["dgrad4"], (*timing_keys, "per_step"))
    kernels[0]["at_gemma3_shapes"] = pick(gem["dgrad"], (*timing_keys, "per_step"))
    # head_dim 256, at the judge's prefill shape: the D-256 instantiations of the same entries, their
    # launches from phase 4g (the backward has no path: no attack step runs an unmasked D-256 layer)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        st, batch1 = judge["flash"][name], judge["attention"][name.replace("flash", "attention")]
        kernels.append({
            "name": f"{name}_d256", "route": "cuda", "source": f"adversarialvlm_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name],
            # the forward's launches are the judge prefill's (4g), the backward's the Gemma attack's (4G)
            "launches": gem["judge"]["launches"] if name == "flash_fwd" else gem["launches_d"].get(f"{name}_d256", 0),
            "max_abs_err": st["abs"], "worst_row_rel_err": st["rel"], **pick(st, timing_keys),
            "at_no_pad": pick(judge["flash_no_pad"][name], timing_keys),
            "at_batch_1": {"worst_row_rel_err": batch1["rel"], **pick(batch1, timing_keys)},
            "at_batch_1_no_pad": pick(judge["attention_no_pad"][name.replace("flash", "attention")], timing_keys),
        })
    # phase 4J's shapes, one entry a (stage, batch, T): the flash forward at SafeBench's LLaVA prefills
    # (D 128) and at the judge calls' prefills (D 256), held at every mask of that shape, with its launches
    timing_4j = (*timing_keys, "stage", "shape", "masks", "calls", "launches")
    for i, cases in ((4, evals["kernels"]["safebench"]), (len(sources), evals["kernels"]["judge"])):
        kernels[i]["at_eval_shapes"] = [{"max_abs_err": e["abs"], "worst_row_rel_err": e["rel"], **pick(e, timing_4j)}
                                        for e in cases]
    # phases 4Q and 4B: dgrad at the int8 step's shapes (Q in bf16), launches counted in its CLI run;
    # the flash forward at the baseline prefills (D 128) and at the int8 judge's prefills (D 256)
    kernels[0]["at_int8_step_shapes"] = {"max_abs_err": quant["dgrad"]["abs"], "worst_row_rel_err": quant["dgrad"]["rel"],
                                         "launches": quant["dgrad"]["launches"],
                                         **pick(quant["dgrad"], (*timing_keys, "per_step"))}
    timing_4b = (*timing_4j, "suite")
    kernels[4]["at_baseline_prefills"] = [{"max_abs_err": e["abs"], "worst_row_rel_err": e["rel"], **pick(e, timing_4b)}
                                          for e in base["kernels"]]
    kernels[len(sources)]["at_int8_judge_shapes"] = [{"max_abs_err": e["abs"], "worst_row_rel_err": e["rel"],
                                                      **pick(e, timing_4j)} for e in quant["judge_kernels"]]
    for i, name in enumerate(sources):
        if name in cross["kernels"]:  # 4X's shapes; flash_fwd's is LLaVA's decode prefill
            st = cross["kernels"][name]
            kernels[i]["at_cross_run_shapes"] = {"max_abs_err": st["abs"], "worst_row_rel_err": st["rel"],
                                                 **pick(st, (*timing_keys, "per_step"))}
        if name in fused:
            kernels[i]["at_T_641"] = pick(fused_641[name], timing_keys)
            kernels[i]["at_head_dim_96"] = pick(fused_d96[name], timing_keys)
    # phases 4V, 4V1 and 4XV: Qwen2-VL's shapes. The D-80 flash_full instantiations are rows of their own,
    # their launches those of 4V1's run (the 1024² source); the causal kernels at n_rep 6 and dgrad at
    # Qwen's linears ride with their entries
    q_stats = qwen["stats"]
    for name in ("flash_full_fwd", "flash_full_bwd_dq", "flash_full_bwd_dkdv"):
        st = qwen["full80"][name]
        kernels.append({
            "name": f"{name}_d80", "route": "cuda", "source": f"adversarialvlm_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": qwen["v1"]["launches"][name],
            "max_abs_err": st["abs"], "worst_row_rel_err": st["rel"], **pick(st, timing_keys),
            "shape": [1, qwen["v1"]["patches"], 16, 80],
        })
    for i, name in enumerate(sources):
        at = {}
        if name in q_stats:  # 4V: the batch-2 step (flash), a batch-1 row (fused), dgrad at batch 2
            st = q_stats[name]
            at["at_qwen2vl_step_shapes"] = {"max_abs_err": st["abs"], "worst_row_rel_err": st["rel"],
                                            "launches": qwen["launches"][name],
                                            **pick(st, (*timing_keys, "per_step"))}
        if name == "flash_fwd":
            at["at_qwen2vl_prefill_shape"] = pick(qwen["prefill"], timing_keys)
        if name == "dgrad":
            at["at_qwen2vl_1024_shapes"] = pick(qwen["dgrad1"], (*timing_keys, "per_step"))
            at["at_qwen_gemma_cross_shapes"] = pick(xq["dgrad"], (*timing_keys, "per_step"))
        if name in xq["attention"]:
            at["at_qwen_gemma_cross_shapes"] = pick(xq["attention"][name], timing_keys)
        kernels[i].update(at)
    # phases 4H and 4XH: Phi-3.5-vision's shapes. The head_dim-96 instantiations of the causal entries are
    # rows of their own: the flash kernels with 4H's launches (the batch-2 step, the forward also at the
    # decode prefill), the batch-1 ones with 4XH's (the int8 cross step); dgrad at Phi's linears rides
    # with its entry
    h_stats = phi["stats"]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "attention_fwd", "attention_bwd_dq",
                 "attention_bwd_dkdv"):
        st = h_stats[name] if name.startswith("flash") else xh["attention"][name]
        row = {
            "name": f"{name}_d96", "route": "cuda", "source": f"adversarialvlm_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "max_abs_err": st["abs"], "worst_row_rel_err": st["rel"],
            **pick(st, timing_keys),
            "launches": (phi if name.startswith("flash") else xh)["launches_d"].get(f"{name}_d96", 0),
        }
        if name == "flash_fwd":
            row["at_prefill_shape"] = pick(phi["prefill"], timing_keys)
        kernels.append(row)
    kernels[0]["at_phi3v_step_shapes"] = {"max_abs_err": h_stats["dgrad"]["abs"],
                                          "worst_row_rel_err": h_stats["dgrad"]["rel"],
                                          **pick(h_stats["dgrad"], (*timing_keys, "per_step"))}
    kernels[0]["at_llava_phi3v_int8_cross_shapes"] = pick(xh["dgrad"], (*timing_keys, "per_step"))
    # phase 4M: Llama-3.2-11B-Vision's shapes ride with their entries (the causal kernels at n_rep 4, head_dim
    # 128: the batch-1 step and the decode prefill's flash forward; dgrad at the 11B's linears), each with
    # its launches a step of 4M's run
    m_stats = ml["stats"]
    for i, name in enumerate(sources):
        if name in m_stats:
            st = m_stats[name]
            kernels[i]["at_mllama_step_shapes"] = {
                "max_abs_err": st["abs"], "worst_row_rel_err": st["rel"],
                "launches_per_step": ml["per_step"][name], **pick(st, (*timing_keys, "per_step"))}
        if name == "flash_fwd":
            kernels[i]["at_mllama_prefill_shape"] = {"max_abs_err": ml["prefill"]["abs"],
                                                     "worst_row_rel_err": ml["prefill"]["rel"],
                                                     **pick(ml["prefill"], timing_keys)}
    # each cross run's launches a step, measured: a row of one head dim reads its instantiation's count
    # (the base causal rows are head_dim 128's, flash_full's 72's), dgrad and the fused rows their entry's
    runs_by_pair = {"llava+gemma3": cross, "qwen2vl+gemma3": xq, "llava+phi3v int8": xh, "phi3v+mllama+qwen2vl": x3}
    for row in kernels:
        name, d = row["name"], None
        if re.fullmatch(r".*_d\d+", name):
            d = name
        elif name.startswith(("attention", "flash")):
            d = f"{name}_d72" if name.startswith("flash_full") else f"{name}_d128"
        row["launches_cross_step"] = {pair: (run["per_step"][name] if d is None else run["per_step_d"].get(d, 0))
                                      for pair, run in runs_by_pair.items()}
    # phase 4X3: each kernel at the shapes attack_cross.sh's one-rank run gave it (dgrad over the three
    # victims' linears; the batch-1 causal kernels and each test decode's prefill by victim)
    kernels[0]["at_cross3_shapes"] = pick(x3["dgrad"], (*timing_keys, "per_step"))
    for i, name in enumerate(sources):
        if name.startswith("attention") or name == "flash_fwd":
            kernels[i]["at_cross3_shapes"] = {
                label: {"max_abs_err": st[name]["abs"], "worst_row_rel_err": st[name]["rel"], **pick(st[name], timing_keys)}
                for label, st in x3["attention"].items()}
    # phase 4T3: the kernels at each kind of mesh rank's shapes (attack_cross.sh at --mesh_model 8), rows
    # of their own; launches are rank 0's over its run
    for key, st3 in t3["stats"].items():
        for name in ("dgrad", "attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv"):
            st = st3[name]
            kernels.append({
                "name": f"{name}_4T3_{key}_rank", "route": "cuda",
                "source": f"adversarialvlm_tpu_torch/csrc/{sources[name]}", "replaces": replaces[name],
                "launches": t3["launches"][name], "max_abs_err": st["abs"], "worst_row_rel_err": st["rel"],
                **pick(st, timing_keys), "launches_per_step": t3["per_step"][name], "heads": st3["heads"],
                "ranks": st3["ranks"], "T": st3["T"],
            })
    # phases 4T and 4TL: the kernels at one mesh rank's shapes (its heads, its shards, its data rank's
    # rows), rows of their own; launches are rank 0's over its run
    for tag, m in mesh.items():
        for name in ("dgrad", "attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv", "flash_fwd"):
            st = m["stats"][name]
            kernels.append({
                "name": f"{name}_{tag}_rank", "route": "cuda", "source": f"adversarialvlm_tpu_torch/csrc/{sources[name]}",
                "replaces": replaces[name], "launches": m["launches"][name], "max_abs_err": st["abs"],
                "worst_row_rel_err": st["rel"], **pick(st, timing_keys), "launches_per_step": m["per_step"][name],
                "heads": list(m["heads"]), "T": m["T"],
            })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
