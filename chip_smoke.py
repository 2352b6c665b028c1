#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tdax_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port from this checkout (never ``jax``, never ``tdax``)
and runs these phases, printing JSON lines:

1. env      the card's name and power limit (nvidia-smi), torch/CUDA
            versions; builds every kernel of the port from the sources
            in the checkout (one nvcc per source, all started together,
            and the native Rips engine's g++ beside them); prints ptxas's
            register, spill, C7508 and setmaxnreg lines (and, for the
            Hopper sources, ptxas's wgmma warnings C75xx) and fails if
            flash_fwd_sm90.cu, flash_bwd_sm90.cu, qmm_sm90.cu,
            sqdist_sm90.cu, flash_decode_sm90.cu, qmm_decode_sm90.cu or
            vit_elementwise_sm90.cu
            spills or has setmaxnreg ignored (C7508).
2. kernels  each kernel's wrapper against its plain PyTorch version on
            the card.  flash_fwd, both kernels: the route must send the
            capture's three attention shapes (decoder, ViT, resampler;
            batch 16, bf16, the model's strided views) and the training
            shape [4, 1024, 32, 128] (causal, with lse) to the Hopper
            kernel (flash_fwd_sm90.cu); each is checked on it and on the
            mma kernel (flash_fwd.cu, forced by the private _kernel="mma")
            and both are timed beside SDPA, the plain version and the
            bound (kernel_case lines: ms, ms_mma, library_ms, bound_ms);
            the launch counters must move as the route says.  The decode
            step's [16, 1, 352, 32, 128] with ragged key validity: the
            route must send it to flash_decode_sm90.cu (split-KV), checked
            there (with and without lse, causal, one split's keys all
            masked, [8, 1, 352, 16, 128] at a tp rank's 16 heads, a
            bitwise repeat) and on flash_fwd.cu (forced), both timed by
            the card's kernel time (torch.profiler) beside SDPA's and the
            plain version's.  Latent attention (MLA_SHAPE: Kimi-VL's
            capture, [16, 320, 16] causal, q.k over 192 columns and v of
            128, right-padded keys): the route must send it to the sm90
            kernel flash_fwd_mla_kernel, with and without lse, checked
            there and on flash_fwd.cu (forced), the counters (LAUNCHES,
            LAUNCHES_SM90, LAUNCHES_MLA) moving as the route says, timed
            beside SDPA, the plain version and benchmark.roofline's
            bound.  The mma kernel alone: f32 at the shapes of
            tests/test_flash_attention.py; fully masked rows on both
            (finite, lse 0).
            sqdist (SQDIST_SHAPES, an aligned strided view,
            SQDIST_ANY_LAYOUT and the scale path's [10000, 4096]):
            sqdist.cu (forced by the private _kernel="fma") and
            sqdist_sm90.cu (3xTF32) at every case; the route must send
            the scale path's x and SQDIST_ANY_LAYOUT's view to
            sqdist_sm90.cu, the view bitwise its contiguous copy's
            result and within 1e-5 (|x_i|^2 + |x_j|^2) of f64; both
            kernels within 1e-5 (|x_i|^2 + |x_j|^2) of the plain
            version, exactly symmetric, the counters moving as the
            choice says; the split pass bitwise equal to
            tf32_split_plain (padded to d rounded up to 4); two sm90
            runs at the scale shape bitwise equal; each kernel's error
            against f64 reported; the routed call, the product and the
            split alone, sqdist.cu and torch.cdist timed.  qmm:
            bf16 at every (M, K, N) of the int8 capture and of a decode
            step (QMM_SITES); the route must send every capture site but
            vit.patch_w (K = 588) to qmm_sm90.cu, which is checked and
            timed there and on qmm.cu (forced by the private
            _kernel="mma"), the counters moving as the choice says; the
            decode sites (M = 16) to qmm_decode_sm90.cu (split K), checked
            and timed there and on qmm.cu by the card's kernel time, each
            repeated bitwise; vit.patch_w stays on qmm.cu.  Ragged bf16
            shapes (QMM_RAGGED_SHAPES: M, N, K off the 256 x 128 x 64
            tile) on both kernels, untimed, and QMM_DECODE_RAGGED_SHAPES
            (M <= 64) on qmm_decode_sm90.cu and qmm.cu, repeated bitwise;
            f32 at small ragged shapes on qmm.cu; the gradient in x
            through qmm (QuantMatmul, tdax's _qmm_bwd) at QMM_GRAD_SITES,
            one on qmm_sm90.cu and one on qmm_decode_sm90.cu: present,
            one launch, within QMM_GRAD_TOL of the plain version's
            autograd gradient.  vit_elementwise: vit_ln_rows and
            vit_bias_epilogue (the tower's LayerNorms and bias / GELU /
            residual epilogues) at every site of a capture batch
            (VIT_SITES), bf16 and f32, against their plain versions
            (LayerNorm, bias and residual bitwise, GELU within one ulp),
            each launch counted, bf16 timed by the card's
            kernel time beside the plain version and the bound.  Raises on a
            case outside its tolerance.  Times the kernel, the plain
            version and one PyTorch library call (SDPA; torch.cdist
            against the Euclidean wrapper; torch.matmul on the weight
            pre-converted to bf16; used nowhere in the port) with CUDA
            events, beside the least time the card could take (H100 SXM
            peaks: 989 TFLOP/s bf16, 67 TFLOP/s f32 without tensor
            cores, 3.35 TB/s).
3. capture  the port's main path at full width and depth: the 48-sample
            dataset, the full QwenVLConfig() in bf16 with random weights
            drawn on the card from a seed, extract_activations at batch
            16.  Checks the [32, 48, 4096] capture, finiteness, the .pt
            and .npz schemas, and that every attention went through the
            sm90 kernel (both counters = 3 batches x (48 + 1 + 32) = 243)
            and every LayerNorm and bias epilogue of the tower through
            vit_ln_rows (3 x 100) and vit_bias_epilogue (3 x 196),
            then times the same capture once more, warm, and each of
            its host stages alone (tokenize, image decode, .npz, .pt).
            Before that, a tiny f32 model's capture on the card is held
            against the same capture on the CPU (plain attention), and
            its int8 tree's capture and generate (8 new tokens, fp and
            int8 caches) likewise: activations and logits within
            TINY_TOL, greedy tokens identical.  The bf16 capture must
            launch no qmm kernel.
4. profile  one batch's forward alone (synchronised host clock), then
            under torch.profiler: device busy time by kind (qmm kernel,
            flash kernel, GEMMs, other) and the idle share.
4b. int8     the capture's own bf16 weights quantized on the card, then
            extract_activations with ExtractConfig(quantize_int8=True):
            the [32, 48, 4096] capture, finite, tdax's schemas, qmm
            launches 3 x (199 + 160) = 1077, 3 x 358 = 1074 of them on
            qmm_sm90.cu and the 3 vit.patch_w on qmm.cu, flash 243,
            all sm90, and the tower's 300 + 588 as in capture, minimum
            cosine per captured vector > 0.98 against the bf16 capture;
            the same profile of one batch.
4c. generate init_params_quantized(QwenVLConfig(), "cuda", seed=0), the
            first 16 samples' prompts (images, ToyTokenizer, padded to
            320), greedy generate of 32 tokens with bf16 caches and with
            kv_int8: ids in range, qmm launches 360 + 31 x 161 = 5351
            (the prefill's 358 on qmm_sm90.cu, its patch embedding on
            qmm.cu, its lm_head and every decode step's, 1 + 31 x 161 =
            4992, on qmm_decode_sm90.cu)
            and flash 81 + 31 x 32 = 1073 each, the prefill's 81 on the
            sm90 kernel and the decode steps' 992 on flash_decode_sm90.cu
            (Tq = 1); the prefill's and the
            first two decode steps' logits against the uncached forward
            (CACHE_TOL), kv_int8's first decode logits within 0.05 x
            max|logit| of the bf16 cache's; a profile of one decode
            step.
4d. w8a8    W8A8 serving (set_w8a8: int8 activations x int8 weights,
            torch._int_mm) on generate's int8 weights, the switch off
            again after it whatever happens.  At every QMM_SITES shape a
            seeded bf16 x through qdot on the card (one int8 product, no
            qmm launch) bitwise equal to the CPU's on its first
            W8A8_SITE_ROWS rows; the quantize pass, int8_mm, torch._int_mm
            alone on the column-major and the row-major weight, and the
            whole qdot timed beside the qmm phase's qmm_sm90.cu and cuBLAS
            bf16 times and the int8 bound (INT8_PEAK).  The tiny f32
            model's int8 tree under W8A8: capture, decode logits and
            generate (8 tokens) on the card against the CPU within
            W8A8_REL_TOL, greedy tokens identical, every product of the
            card's runs bitwise the CPU's on its input.  The full capture
            with the switch on: [32, 48, 4096], finite, tdax's schemas,
            int8 products 3 x 359 = 1077 and no qmm launch, flash 243 all
            sm90, min cosine per vector >= INT8_MIN_COSINE against the
            weight-only int8 capture; one batch profiled, the quantize
            passes and int8_mm as ranges.  generate (16 x 32, bf16 caches):
            ids in range, int8 products 5351 and no qmm launch, flash 1073
            (81 sm90, 992 decode), the prefill's and two decode steps' logits against
            the uncached W8A8 forward within W8A8_CACHE_TOL, a decode step
            profiled.
5. sweep    the port's run_tda_sweep on the activations the capture
            wrote, read back through the port's load_activations: 32
            layers x 36 bound samples x 4096, UMAP (cosine, k 6, 3-d,
            500 epochs, spectral init), Rips H0/H1 in the native engine,
            shape and colour silhouettes (diagram PNGs and the evolution
            plot only where matplotlib is installed).  Checks
            summary_stats.json (32 entries, tdax's keys in tdax's order,
            finite) and the peak layer.  Then run_tda_sweep on bench.py's
            make_clouds recipe (seed 42, layer 25 clustered) on the card
            and, in the same process, on the CPU: the shape-silhouette
            peak must be layer 25 on both, silhouettes and max-H1 must
            agree within SWEEP_SIL_TOL / SWEEP_H1_TOL.  Times each stage.
5p. ph_backends  the fallback Rips backends on that sweep's [32, 36, 3]
            clouds: rips_tiny_batched on the card at maxdim 1 (twice) and
            2 (tdax's chunks), and on the CPU at maxdim 1 and for
            PH_CPU_H2_CLOUDS clouds at maxdim 2, each with the native
            engine's bar counts and within TINY_PH_TOL (bottleneck) of its
            diagrams (the CPU of the card's); sweep counts and times beside
            the native thread pool's; run_tda_sweep on make_clouds with
            RipsConfig(backend="device") on the card: peak 25, max-H1
            within SWEEP_H1_TOL of the "auto" sweep's; the python oracle
            on four clouds within ORACLE_TOL of the engine; a 9-point
            cloud at maxdim 4 through the oracle, the engine not called.
            No kernel counter may move.
5a. report   the reference's remaining surface on that capture and
            sweep: the peak layer's two HTML files (visualize_peak_layer,
            png_fallback=False: the card's machine has no matplotlib),
            each holding the 36 bound points once at the .npy cloud's
            coordinates and no http src; the legacy sweep
            (legacy_sweep_config: one reducer shared by every layer,
            peak by max H1) on the card and on the CPU: peak = argmax of
            max-H1 on both and the same, silhouettes within
            SWEEP_SIL_TOL, max-H1 within SWEEP_H1_TOL plus the CPU's own
            spread at that layer under LEGACY_MOVE (reported); the
            geometry metrics (effective and TwoNN dimensionality, both
            windowed into GEOMETRY_WINDOWS, matrix entropy at alpha 1
            and 2) on the card against the CPU at the capture's [32, 36,
            4096] and a seeded GEOMETRY_LARGE, within GEOMETRY_RTOL, NaN
            alike, each timed by CUDA events; the Wasserstein distance
            (orders 1 and 2) of the card sweep's peak H1 diagram and its
            neighbour's equal to the same from the clouds on the CPU.
            Reports the capture's flash_fwd_sm90 launches.
5b. checkpoint  an HF-named bf16 state (hf_state: the values of tdax's
            random_hf_state and random_hf_visual_state) at the full
            widths of QwenVLConfig(), cut to SNAPSHOT_LAYERS decoder
            layers and ViT blocks, drawn on the card from seed 0 and
            written as the reference snapshot's pytorch_model-*.bin
            shards plus index under the run's temp dir; load_qwen_checkpoint
            must give a tree bitwise equal to convert_hf_state_dict of
            the same state (write and load seconds, the load's GB/s, the
            host's peak RSS during the load, peak device memory).  Then
            extract_activations over the 48 samples with
            ExtractConfig(model_dir=snapshot): [8, 48, 4096], finite,
            bitwise equal to the capture from the in-memory tree, 51
            flash launches all sm90; and with quantize_int8 (the weights
            quantized as read): qmm_sm90.cu on all but the patch
            embedding (237 launches, 234 sm90), bitwise equal to the
            int8 capture from quantize_params of the in-memory tree, its
            cosine against the bf16 capture reported (these N(0, 0.05)
            weights are far from a trained model's: see the phase's
            record).
5c. adversarial  on the same loaded weights: the 720 adversarial pairs
            (36/180/180/324), their capture with save_interval
            ADV_SMOKE_SAVE_INTERVAL (240: 3 rewrites, where the
            reference's 50 makes 11) through the .tmp.npz checkpointing
            path ([8, 720, 4096],
            finite, tdax's schemas, 765 flash launches all sm90, the
            forward's device time and the file writes timed apart), the
            4-condition run_adversarial_sweep of it on the card
            (summary.json in tdax's schema, every stat finite), and
            run_adversarial_sweep on structured synthetic clouds of the
            720 samples (adversarial_clouds, --seed) on the card and on
            the CPU: layer ADV_CLUSTERED_LAYER the img_shape silhouette
            peak of every condition on both, silhouettes and max-H1
            within SWEEP_SIL_TOL / SWEEP_H1_TOL at every other layer, the
            clustered layer's silhouettes within ADV_CLUSTERED_SIL_TOL
            (its max-H1 reported: see the constant's note).
            (phase_adversarial_full_depth, run alone, measures the same
            capture at the full depth.)
5d. multidevice  multi-device serving over torch.distributed, the parent
            holding no full-depth tree, torch.cuda.mem_get_info printed
            first; every rank a spawned process whose failure or timeout
            (MD_TIMEOUT_S) fails the phase.  (a) A world of one over NCCL
            on cuda:0: QwenVLConfig() in bf16 from seed 0,
            extract_activations of the 48 samples at batch 16 under the
            group (its dp path): the capture bitwise equal to phase
            capture's, 243 flash launches all sm90, an NCCL all_gather
            run.  (b) Four ranks on cuda:0 over gloo (NCCL refuses two
            ranks on one card), each loading phase checkpoint's 8 + 8-layer
            snapshot: dp=4 extraction (tp=1) uninterrupted, then crashed
            after its first checkpoint and resumed, within MD_RESUME_TOL
            (bitwise reported), no .tmp.npz left.  Then, for the snapshot
            and for the model's own init at its shape (init_params, seed
            0), rank 0's one-device references (the capture, the same
            capture with every product summed in another order: the
            control, and generation), then the tree sharded dp=2 tp=2
            (shard_params): the capture, each rank 8 rows of each batch
            of 16, every rank's 51 attentions on flash_fwd_sm90.cu at 8
            ViT, 16 resampler and 16 decoder heads, timed (on the init,
            one more batch with its tp all_reduces timed alone); each
            captured vector's cosine against one device, gated >=
            MD_MIN_COSINE on the init (the snapshot's N(0, 0.05) weights
            amplify any summation order: its cosine and its control's are
            reported), max relative error by layer reported; generation
            of 16 prompts x MD_NEW_TOKENS (bf16 and int8 caches): the
            prefill logits' error and the greedy tokens' agreement with
            one device reported.  The tiny f32 model at dp=2 tp=2
            against one device: capture within TINY_TOL, greedy tokens
            equal, int8-cache decode logits within MD_KV_INT8_TOL.
            Then tdax's dry-run stages 2 and 3 (the sweep's layers split
            over the ranks; row-sharded distances, kNN and sparse edge
            extraction), to H1 (MD_SCALE_MAXDIM), each stage's wall, its
            gathers' bytes and seconds, each rank's peak memory and the
            collectives reported.  (a) In the NCCL world: run_tda_sweep
            of phase capture's activations, stats and clouds bitwise
            equal to phase sweep's; distance_matrix(mesh=) on the scale
            cloud bitwise the true-f32 expansion form symmetrised,
            rips_at_scale(mesh=); rips_at_scale_sparse(mesh=,
            fused_max=0) with one device's n_edges and bitwise diagrams;
            the mesh paths launch no sqdist kernel.  (b) In the gloo
            world at dp=4: the sweep, 8 layers a rank, its peak layer
            phase sweep's, silhouettes within MD_SWEEP_SIL_TOL, each
            layer's pairwise-distance correlation > MD_UMAP_CORR;
            sharded_knn (k = MD_KNN_K) on the scale cloud, every row
            exact or its disputed neighbours within MD_KNN_TIE of each
            other; rips_at_scale(mesh=) (true f32) within
            SMALL_BOTTLENECK_TOL of the diagrams of rank 0's one-device
            true-f32 matrix (the expansion form in one product), and
            against rank 0's one-device rips_at_scale (through
            sqdist_sm90.cu's 3xTF32: one launch and one split) its
            bottleneck reported, not gated (the expansion form's f32
            cancellation at the cloud's small distances: phase scale's
            h0_deaths_sm90_vs_fma);
            rips_at_scale_sparse(mesh=, fused_max=0) with one device's
            n_edges and diagrams within CROSS_ENGINE_TOL; every rank's
            results equal.  Then tdax's dry-run stages 4 and 8 and the
            edge-list UMAP's mesh variants.  (a) In the NCCL world:
            phase train's first step again under flash_sharding over the
            dp=1 tp=1 mesh (full QwenVLConfig() decoder, bf16, remat,
            --seed's init and batch), its loss and the fingerprint of its
            params and both AdamW moments bitwise phase train's after its
            warm step, 64 / 32 / 32 flash launches all sm90;
            embed_sparse(mesh=) at UMAP_N and UMAP_LARGE_N x 4096 bitwise
            phase umap_sparse's embeddings and transform_sparse(mesh=)
            bitwise its transform.  (b) In the gloo world: the full
            decoder widths cut to MD_TRAIN_LAYERS layers, dp=2 tp=2,
            MD_TRAIN_STEPS plain steps and as many sequence-parallel ones
            (sp_mesh), remat, against rank 0's one-device steps from the
            same init (computed and freed first): each step's loss within
            MD_TRAIN_LOSS_RTOL of one device's, equal on every rank, the
            flash launches all sm90; the max relative error of each leaf
            of rank 0's updated shard, each run's collectives by axis
            (count, bytes, seconds), step walls and every rank's peak
            memory reported.  Then tdax's dry-run stages 11 and 12: FSDP
            (fsdp_sharding_rules, param_shardings) and the hybrid mesh.
            (a) In the NCCL world: phase train's first step once more
            under FSDP at dp=1 (every large leaf's rule names dp, so each
            is gathered where a block reads it and its gradient
            reduce-scattered, over a group of one), bitwise phase train's
            as above, the same launches, its gathers and reduce-scatters
            counted and its peak memory reported.  (b) In the gloo world:
            the same 2-layer config at dp=2 tp=2 under FSDP with
            MD_FSDP_ACCUM microbatches and remat (stage 11's recipe), a
            cold and a warm step: each loss within MD_TRAIN_LOSS_RTOL of
            rank 0's one-device steps', equal on every rank, the flash
            launches all sm90, layers/attn_qkv_w and both its moments at
            1/4 a rank on every rank, each rank's peak memory below its
            plain dp=2 tp=2 step's; the updated shard's error by leaf,
            the collectives by axis and the step walls reported.  The
            hybrid mesh at dcn=2 dp=2 tp=1 (two slices of two ranks):
            stage 12's capture of the 48 samples on the model's own init
            at the snapshot's shape, the batch over (dcn, dp) (4 rows of
            each batch of 16 a rank), 51 flash launches all sm90 a rank,
            each captured vector's cosine against rank 0's one-device
            capture >= MD_MIN_COSINE; and one FSDP step within the slice
            on the 2-layer config (1 row a rank): its loss within
            MD_TRAIN_LOSS_RTOL of one device's, attn_qkv_w at 1/2 a rank,
            every weight all_gather over dp, the gradients' all_reduces
            over dcn, no collective but an all_reduce over dcn.
            embed_sparse(mesh=) at dp=4 on UMAP_N x 4096: planted-cluster
            silhouette above UMAP_SIL_MIN, a transform_sparse(mesh=)
            against it placing at least UMAP_PLACED_MIN, its pairwise-
            distance correlation with phase umap_sparse's reported;
            transform_sparse(mesh=) against phase umap_sparse's
            embedding bitwise its transform; knn_blocked(mesh=) every row
            exact or its disputed neighbours within MD_KNN_TIE; every
            rank's results equal.  Then tdax's dry-run stage 10, context
            parallelism, on the four gloo ranks alone: NCCL refuses two
            ranks on one card, and a world of one has no cp axis (tdax's
            make_mesh at cp = 1 has none), so the NCCL world runs no cp
            stage.  The ring alone at dp=1 tp=1 cp=MD_RING_CP: q, k, v
            MD_RING_SHAPE bf16 (the full decoder's heads; local chunks of
            2048, zigzag halves of 1024, so every step takes
            flash_fwd_sm90.cu and flash_bwd_sm90.cu, at Tq != Tk off the
            diagonal), MD_RING_CASES (causal zigzag, causal contiguous
            under TDAX_NO_ZIGZAG=1, dense, causal with ragged key validity
            and one chunk wholly invalid for one row), each rank's output
            and gradients of sum(sin(o) * valid) against one device's
            FlashAttention of the whole sequence within the ring's bf16
            bound (MD_RING_CASES' note; rows that see no key masked); the
            same cases in f32 at MD_RING_F32_SHAPE on flash_fwd.cu and
            flash_bwd.cu within tdax's ring gates (MD_RING_FWD_TOL,
            MD_RING_GRAD_TOL); each rank's sm90 and mma launches gated at
            the schedule's count (one of each kind a step, a causal
            contiguous rank my + 1), the permutes' count, bytes and
            seconds reported.  Then the cp training step: MD_TRAIN_LAYERS
            full-width layers at dp=1 tp=2 cp=2 (heads over tp inside the
            ring), remat, MD_CP_BATCH x MD_CP_SEQ ids with the last
            MD_CP_MASKED positions of every row masked, MD_TRAIN_STEPS
            steps against rank 0's one-device steps (computed and freed
            first): each loss within MD_TRAIN_LOSS_RTOL of one device's
            and equal on every rank, every flash launch on sm90 (two a
            layer and step for each forward, replay and backward kernel),
            cp permutes and the (dp, cp) all_reduce run; the collectives
            by axis, the step walls and every rank's peak memory reported
            (tp = 2 because four replicas of the 1.65B-parameter config
            with AdamW's moments do not fit one card side by side).
            Then FSDP under context parallelism (make_train_step with
            cp_mesh and param_shardings): the same config, init, batch
            and steps at dp=2 tp=1 cp=2 under fsdp_sharding_rules (one
            row a dp rank, 1024 positions a cp rank; each large leaf's
            dp half the same on both cp ranks, gathered where a block
            reads it, its f32 gradient reduce-scattered over dp and the
            share all_reduced over cp): each loss within
            MD_TRAIN_LOSS_RTOL of the cp stage's one-device losses and
            of its plain cp losses, equal on every rank, the cp stage's
            flash launches a rank, attn_qkv_w and both moments at half
            the whole on every rank and the same on the two cp ranks of
            a dp index, a cp all_reduce for each dp reduce-scatter; the
            collectives by axis, the step walls, the local params and
            every rank's peak memory reported.
            Then tdax's dry-run stage 9, pipeline parallelism, on the four
            gloo ranks alone (the NCCL world of one would be one stage,
            which sends nothing): make_pp_mesh(pp=4, dp=1), the full
            widths cut to MD_PP_LAYERS decoder layers (one a stage;
            2,054,246,400 params), text-only, bf16, seed 0, remat, AdamW
            at MD_TRAIN_LR, each stage holding its layer and only the
            leaves it reads (wte on the first, ln_f and lm_head on the
            last).  Rank 0 first runs the one-device forward and
            MD_TRAIN_STEPS one-device steps and frees them.  (i)
            pipeline_forward on MD_PP_FWD_BATCH x MD_PP_FWD_SEQ ids at
            MD_PP_FWD_MICRO microbatches: each position's logits' cosine
            against one device >= MD_MIN_COSINE, the largest |delta| /
            max|logit| and bitwise equality reported, each rank's
            MD_PP_FWD_MICRO launches on flash_fwd_sm90.cu.  (ii)
            MD_TRAIN_STEPS 1F1B steps (make_train_step_pp) on MD_PP_BATCH
            x MD_PP_SEQ ids at MD_PP_MICRO microbatches (M = 2S: warm-up,
            steady state and cool-down, 22 slots), the last row's final
            MD_TRAIN_MASKED positions masked: each loss within
            MD_TRAIN_LOSS_RTOL of one device's and equal on every rank;
            a rank's launches a step and layer, all on the sm90 kernels,
            3M forwards (a forward slot without grad, then the backward
            slot's recompute and remat's replay; 2M on the last stage,
            whose forward slot only saves its input) and M of each
            backward kernel; its transfers M activations and M gradients
            (none forward from the last stage, none back from the first),
            2M(S - 1) a step over the group, 8 MiB each, with their bytes
            and seconds; the loss's and the clip's all_reduce over pp.
            (iii) One schedule="gpipe" step from the same init: its loss
            beside the 1F1B step's, within MD_TRAIN_LOSS_RTOL of one
            device's, the same launches.  Each step's wall, each rank's
            params, memory after the init and peak memory reported.
            Phases 6, 6b, 6c and 9 run before this one, inside the run's
            temp dir.
6. scale    rips_at_scale on bench_scale.py's seeded 3-sphere cloud,
            10000 x 4096, threshold for ~40 neighbours, maxdim
            SCALE_MAXDIM: the distance matrix through sqdist_sm90.cu (its
            counters and its split pass's must read exactly 1; the
            stages of distance_matrix timed apart; Boruvka's H0 deaths
            from sqdist.cu's matrix beside, reported), H0 by Boruvka on
            the card, H1+ in the native engine.  Boruvka's H0 must equal
            the engine's dim-0 bars on the same matrix; a small
            two-cluster cloud (60 points, sqdist.cu) and the same recipe
            at 160 points (sqdist_sm90.cu) must give the CPU's diagrams
            (bottleneck <= SMALL_BOTTLENECK_TOL per dimension).  Times
            each stage.
6b. scale_sparse  rips_at_scale_sparse on the same cloud (maxdim
            SCALE_MAXDIM, degree SCALE_DEGREE).  The fused branch three
            times, as bench_scale.py:53-72 (cold, warm from the host
            array, warm from the cloud on the card): the sqdist counters,
            set to 0 just before each call, must read one sqdist_sm90.cu
            launch and one split pass after it; the three thresholds,
            edge counts and bar counts equal; one more run profiled.  The
            blocked branch (fused_max=0, SPARSE_BLOCK_ROWS rows a block)
            must launch no sqdist kernel.  The cross-engine gate of both
            (bench_scale.py:83-117): the dense engine on f64 distances of
            the cloud (f64 torch on the card, no kernel of the port) at
            each branch's threshold, every dimension's bottleneck <=
            CROSS_ENGINE_TOL, timed.  The CSR each branch gave the engine:
            indptr monotone, rows sorted and unique without self entries,
            symmetric, the values of (r, c) and (c, r) bitwise equal.
            Then bench_scale.py's recipe at SPARSE_LARGE_N x 4096,
            H1, blocked, once from the host array: stage timings, edges,
            bars, peak device memory and the same CSR checks.
6c. umap_sparse  the edge-list UMAP (UMAP.fit past sparse_threshold).
            bench_umap.py's recipe (umap_cloud: 8 planted clusters on a
            16-d subspace, seed 42; cosine, k 15, 3-d, random_state 42,
            500 epochs) at UMAP_N x 4096 three times (cold, warm from the
            host array, warm from the cloud on the card), each call's
            stages (LAST_TIMINGS: upload, kNN + calibration, COO
            symmetrization, LOBPCG init and its iterations, layout), peak
            memory, the planted-cluster silhouette on a 4000-point
            subsample above UMAP_SIL_MIN; the card's and the host's
            embeddings bitwise equal; one more call profiled.  Then
            UMAP_TRANSFORM_N fresh points of the mixture through
            UMAP.transform (the edge list): finite, the training side
            unchanged, at least UMAP_PLACED_MIN of them nearest their own
            cluster's centroid, a second transform bitwise equal.  The card
            against the CPU at 3000 x 64 in 3 clusters (tolerances at
            UMAP_INIT_COS_MIN): kNN lists, the LOBPCG init from one start,
            the 30-epoch layout from one init and one set of negatives, the
            whole path from those draws (reported), and the full fit on
            both (silhouette above 0.7, the same clusters).  The shared
            sweep (embed_and_silhouettes, reducer_mode "shared") on a
            UMAP_SWEEP_SHAPE stack of the mixture equal to a serial
            UMAP.fit + transform loop.  Then UMAP_LARGE_N x 4096 once
            (200 epochs) from the host array, its stages, peak memory, the
            same silhouette gate, and a profiled call's idle share.  No
            kernel counter of the port may move in the phase.
7. flash_bwd the flash backward kernels (dq; dk/dv) and the forward's
            lse output against their plain versions, bf16 and f32, at the
            decoder's training shape [4, 1024, 32, 128] (causal, the last
            row's final 128 keys masked), the ViT's (4 x 1024, 16 heads,
            hd 104), the resampler's (256 x 1024 keys, hd 128) and a
            ragged one.  bf16 goes to flash_bwd_sm90.cu (the route must
            say so) and is checked there and on flash_bwd.cu (forced by
            the private _kernel="mma"), the counters moving as the choice
            says; f32 stays on flash_bwd.cu.  At the training shape two
            runs of the sm90 pair must agree bitwise.  Kernel times of
            both pairs and SDPA's backward alone (autograd.grad over a
            retained graph; medians and spreads of 5 x 10 calls, and
            the profiler's device time, SDPA's yardstick), bound and
            plain times.
8. tiny_train the tiny f32 config trained on the card (kernels) and on the
            CPU (plain versions): loss and every gradient, three
            make_train_step steps, a with_images step, and train_loop
            stopped at step 4 and resumed to 6 bitwise equal to the
            uninterrupted run (checkpoint through tmp).
9. train    the full decoder width (QwenVLConfig(), text-only, bf16,
            7.72B params), default_optimizer(warmup_cosine_lr(1e-4, 2, 8)),
            remat, a fixed 4 x 1024 batch from --seed's numpy generator
            (the last row's final 128 positions masked): one warm step,
            five timed steps (64 flash forwards, all sm90, 32 dq and 32
            dk/dv launches each, all sm90), losses finite, decreasing
            and, at --seed 0, within TRAIN_LOSS_TOL of the reference
            trajectory, peak memory,
            the share of 989 TFLOP/s (bench_train.py's convention), and a
            profiled step's device time by kind.
10. the kernels line (flash_fwd, flash_bwd_*, sqdist and qmm name both sources
            and the launches of each kernel on each path, the checkpoint
            and adversarial captures', the multidevice worlds' (rank
            0's), the W8A8 capture's and
            generate's and each scale_sparse call's included; the W8A8
            product is torch._int_mm, a library call, whose times are on
            the w8a8 line; vit_elementwise its two kernels' launches on
            the bf16 and int8 captures and a batch's times), the nvidia-smi
            line, then the last
            line {"ok": true, "device": {...}}.  Kernel times are
            reported, never gated: only correctness and launch counts
            fail the run.

Any failure raises, so the script exits non-zero and prints no result;
it also exits non-zero when no CUDA card is present.  ``--seed`` (default
0) draws the training phase's batch.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12      # H100 SXM dense TF32 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12

# bf16: the kernel rounds the un-normalized p to bf16 where the plain
# version rounds the normalized probabilities, and the two f32 results
# may round to neighbouring bf16 outputs (one ulp is 2^-7 relative).
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
F32_TOL = 2e-5          # tests/test_flash_attention.py:65
TINY_TOL = 1e-4         # tiny f32 capture, card vs CPU
# tiny decode logits through int8 caches, card vs CPU: a cache value ~1e-6
# from an int8 rounding edge may round the other way on the two devices,
# which moves it by its scale (1/127 of its row's max)
TINY_KV_INT8_TOL = 5e-3
# qmm bf16: one bf16 rounding of the output (2^-7 relative) plus room for
# the order of the f32 sum; f32: the sum's rounding is bounded by the sum
# of the magnitudes of its terms, |x| @ |q| * s
QMM_BF16_RTOL, QMM_BF16_ATOL_OF_MAX = 2.0 ** -7, 1e-3
QMM_F32_REL_TOL = 1e-5
QMM_F32_SHAPES = [(8, 256, 128), (130, 588, 384), (1, 33, 7)]
# (site, M, K, N, calls per int8 capture batch, calls per decode step)
QMM_SITES = [
    ("vit.patch_w", 16 * 1024, 588, 1664, 1, 0),
    ("vit.attn_qkv_w", 16 * 1024, 1664, 4992, 48, 0),
    ("vit.attn_proj_w", 16 * 1024, 1664, 1664, 48, 0),
    ("vit.mlp_fc_w", 16 * 1024, 1664, 8192, 48, 0),
    ("vit.mlp_proj_w", 16 * 1024, 8192, 1664, 48, 0),
    ("resampler.kv_proj_w", 16 * 1024, 1664, 4096, 1, 0),
    ("resampler.attn_q_w", 16 * 256, 4096, 4096, 1, 0),
    ("resampler.attn_k_w", 16 * 1024, 4096, 4096, 1, 0),
    ("resampler.attn_v_w", 16 * 1024, 4096, 4096, 1, 0),
    ("resampler.attn_out_w", 16 * 256, 4096, 4096, 1, 0),
    ("visual.proj", 16 * 256, 4096, 4096, 1, 0),
    ("decoder.attn_qkv_w", 16 * 320, 4096, 12288, 32, 0),
    ("decoder.attn_proj_w", 16 * 320, 4096, 4096, 32, 0),
    ("decoder.mlp_w1+w2", 16 * 320, 4096, 11008, 64, 0),
    ("decoder.mlp_proj_w", 16 * 320, 11008, 4096, 32, 0),
    ("decode.attn_qkv_w", 16, 4096, 12288, 0, 32),
    ("decode.attn_proj_w", 16, 4096, 4096, 0, 32),
    ("decode.mlp_w1+w2", 16, 4096, 11008, 0, 64),
    ("decode.mlp_proj_w", 16, 11008, 4096, 0, 32),
    ("decode.lm_head", 16, 4096, 151936, 0, 1),
]
QMM_PER_CAPTURE_BATCH, QMM_PER_DECODE_STEP = 359, 161
# the int8 product's gradient in x (QuantMatmul, tdax's _qmm_bwd) at a
# capture site on qmm_sm90.cu and a decode site on qmm_decode_sm90.cu,
# against the
# plain version's autograd gradient on the card within tdax's own
# tolerance for that backward (tests/test_quantize.py:190)
QMM_GRAD_SITES = ("decoder.attn_proj_w", "decode.mlp_proj_w")
QMM_GRAD_TOL = 3e-2
# of a capture batch's (and of generate's prefill's) 359 products, all but
# vit.patch_w (K = 588, rows TMA cannot read) take qmm_sm90.cu
QMM_SM90_PER_CAPTURE_BATCH = 358
# ragged bf16 products held on both kernels (not timed): M, N and K not
# multiples of the Hopper kernel's 256 x 128 x 64 tile
QMM_RAGGED_SHAPES = [(200, 1000, 1664), (129, 72, 272), (1000, 4104, 4112)]
# bf16 products of at most 64 rows held on qmm_decode_sm90.cu and qmm.cu,
# each repeated bitwise: M, N and K off its 16 x 128 x 128 tile (split 7
# ways), and a dp rank's decode rows at a tp rank's qkv columns
QMM_DECODE_RAGGED_SHAPES = [(40, 4104, 4112), (8, 4096, 6144)]
# int8 capture against the bf16 capture of the same weights: tdax's gate
# (tests/test_quantize.py:60)
INT8_MIN_COSINE = 0.98
# generate: cached logits against the uncached forward, relative to
# max|logit| (bf16: the decode step's reductions run at other shapes, and
# a one-ulp bf16 difference can grow through 32 random layers); kv_int8
# against bf16 caches as tests/test_generate.py:94
CACHE_TOL, KV_INT8_TOL = 3e-2, 5e-2
GEN_BATCH, GEN_PROMPT_LEN, GEN_NEW_TOKENS = 16, 320, 32
INT8_PEAK = 1979e12     # H100 SXM dense int8 tensor-core OP/s
# W8A8 sites, card against CPU: the CPU computes each site's first rows
# only (a row of the product depends on its own row of x alone)
W8A8_SITE_ROWS = 256
# W8A8, card against CPU end to end: the values upstream of each
# quantization differ by summation order (~1e-7), and an activation that
# close to an int8 rounding boundary lands a level apart (1/127 of its
# row's max), which later layers carry on; the bound is tdax's own between
# W8A8 and the weight-only product (tests/test_quantize.py), relative to
# the largest value.  Each product is held bitwise besides.
W8A8_REL_TOL = 2e-2
# W8A8 generate, cached decode logits against the uncached forward,
# relative to max|logit|: a bf16 ulp (2^-8) upstream moves x / s_x by up to
# half a level near 127, so in bf16 many activations land a level apart
# between the cached step and the uncached forward (measured on the card:
# 3.8% under W8A8 against 1.5% weight-only); the bound is KV_INT8_TOL's,
# tdax's where int8 rounding enters the cached decode
# (tests/test_generate.py:94)
W8A8_CACHE_TOL = KV_INT8_TOL
# sqdist: kernel and plain version are expansion forms summed in other
# orders (one f32 FMA chain per entry in sqdist.cu, 3xTF32 on the tensor
# cores in sqdist_sm90.cu, against a library product), so the bound is
# relative to the cancelled terms: 1e-5 * (|x_i|^2 + |x_j|^2).
SQDIST_REL_TOL = 1e-5
# + the scale path's, an aligned strided view and SQDIST_ANY_LAYOUT; both
# kernels run every case (n and d on and off sqdist_sm90.cu's 128 x 32
# tile; the split pass reads any layout, so the route reads n alone)
SQDIST_SHAPES = [(36, 3), (100, 17), (130, 257), (1001, 333), (128, 4096), (129, 4096),
                 (1000, 4100), (1001, 332)]
# (n, d, row stride, offset in floats): an odd d at an odd row stride
# from a base one float past a 16-byte boundary, routed to
# sqdist_sm90.cu and held bitwise to the result on its contiguous copy
SQDIST_ANY_LAYOUT = (1000, 4095, 4097, 1)
SCALE_N, SCALE_D, SCALE_DEGREE, SCALE_MAXDIM = 10_000, 4096, 40, 2
# the sparse path (phase scale_sparse): the blocked branch's rows a block
# (10000 = 4 x 2048 + 1808), the 10x point (README.md:310, bench_scale.py's
# recipe at 100k, H1, blocked) and BASELINE.json's cross-engine bar:
# every dimension's bottleneck between the sparse path's diagrams and the
# dense engine's on f64 distances at the same threshold (bench_scale.py:83-117)
SPARSE_BLOCK_ROWS = 2048
SPARSE_LARGE_N, SPARSE_LARGE_MAXDIM = 100_000, 1
CROSS_ENGINE_TOL = 1e-5
# the card's matrix (kernel) and the CPU's (plain version) are both
# expansion forms, so distances near 0.6 between points of norm ~11 may
# differ by ~1e-5 relative (tests/test_scale_ops.py:91-95 allows 1e-4)
SMALL_BOTTLENECK_TOL = 1e-4
# the edge-list UMAP (phase umap_sparse): bench_umap.py's recipe (cosine,
# k 15, 3-d, random_state 42) at its 10k default and at the 100k point
# of README.md:321, its gate (the 8 planted clusters' silhouette on a
# 4000-point subsample above 0.6, bench_umap.py:61-67) and the transform
# placement bar of tests/test_umap_sparse.py:242-247
UMAP_N, UMAP_LARGE_N, UMAP_D, UMAP_K = 10_000, 100_000, 4096, 15
UMAP_SIL_MIN, UMAP_SUBSAMPLE = 0.6, 4000
UMAP_TRANSFORM_N, UMAP_PLACED_MIN = 2000, 0.95
# card against CPU: 3000 x 64 in 3 clusters (one connected kNN graph, so
# the init's eigenvectors are distinct), 30 epochs from injected draws.
# kNN distances within the CPU tests' 2e-3 (expansion form, two BLAS);
# the LOBPCG init from one start and one edge list: |cosine| >= 0.999 a
# column (a CPU run with weights moved 1e-6 relative reads 0.999996);
# the layout from one edge list, init and negatives: the epochs are
# chaotic (on the CPU an init moved 1e-7 relative moves the 30-epoch
# points by median 6e-4, p99 0.018, max 0.14 on a cloud of max-abs ~9),
# so the gate is the median and the 99th percentile of the per-point
# gap, against O(1) for a wrong formula.  The full fit (500 epochs) on
# 3 well-separated clusters of the same recipe (centres 3x further
# apart: three components, every point's nearest centroid in the CPU's
# embedding at least 5 ahead of the next): silhouette above
# tests/test_umap_sparse.py's 0.7 on both, the same nearest-centroid
# cluster of every point.  On the connected cloud the points between
# clusters are ambiguous: on an H100 one of them landed in another
# cluster than on the CPU.
UMAP_PARITY_N, UMAP_PARITY_D, UMAP_PARITY_EPOCHS = 3000, 64, 30
UMAP_PARITY_SPREAD, UMAP_FIT_SPREAD = 0.8, 3.0
UMAP_INIT_COS_MIN = 0.999
UMAP_LAYOUT_MEDIAN_TOL, UMAP_LAYOUT_P99_TOL = 0.05, 0.5
UMAP_PARITY_SIL_MIN = 0.7
UMAP_SWEEP_SHAPE = (3, 2100, 256)
# the sweep on the card against the same sweep on the CPU: eigh may
# return other signs (and another basis of a repeated eigenvalue) on the
# card, and the 500-epoch layout amplifies rounding.  A CPU run with
# flipped eigenvector signs moved silhouettes by 0.003 and max-H1 by
# 0.006; on an H100 the widest gaps are 0.0144 (silhouette, layer 25,
# whose graph has six components, so its init is any basis of a six-fold
# eigenvalue) and 0.0160 (max-H1, of a mean max-H1 of 0.41), the same
# in every run.  The limits leave under 2x room over those gaps.
SWEEP_SIL_TOL, SWEEP_H1_TOL = 0.02, 0.03
# rips_tiny_batched against the native engine, per cloud and dimension:
# tdax's own bound (tests/test_rips_tiny_device.py: f32 distances against
# the engine's f64); the oracle against the engine on the same f64 distances
TINY_PH_TOL, ORACLE_TOL = 5e-5, 1e-9
PH_CPU_H2_CLOUDS = 4    # the H2 matrices of all 32 clouds are ~3.4 GB on the host
STATS_KEYS = ["layer", "n_h1_features", "max_h1_persistence", "all_h1_persistence_values",
              "n_h0_features", "max_h0_persistence", "silhouette_shape", "silhouette_color"]

# the report phase's geometry metrics, card against CPU: the CPU tests'
# tolerances against tdax (tests/test_torch_geometry.py), relative; NaN
# in the same places.  The capture's clouds [32, 36, 4096] and a seeded
# [4, 1024, 4096] (the training step's batch and length at the decoder's
# width), each windowed into GEOMETRY_WINDOWS.
GEOMETRY_RTOL = {"effective_dimensionality": 1e-4, "fixed_window_ed": 1e-4,
                 "intrinsic_dimensionality": 1e-3, "fixed_window_id": 1e-3,
                 "matrix_entropy_alpha1": 1e-4, "matrix_entropy_alpha2": 1e-4}
GEOMETRY_LARGE = (4, 1024, 4096)
GEOMETRY_WINDOWS = 4

# the legacy sweep (one reducer shared by every layer) of the capture,
# card against CPU: silhouettes within SWEEP_SIL_TOL and the same peak at
# every run; max-H1 within SWEEP_H1_TOL plus what the CPU alone moves at
# that layer when the capture's values move by LEGACY_MOVE relative
# (LEGACY_MOVES seeded draws).  On an H100 the capture's layer 16 holds a
# small loop whose persistence follows the layout's drift: card vs CPU
# 0.0399, and the CPU alone up to 0.0372 over these draws.
LEGACY_MOVE, LEGACY_MOVES = 1e-7, 4

# the checkpoint and adversarial phases: the full widths of QwenVLConfig()
# at SNAPSHOT_LAYERS decoder layers and ViT blocks, written in shards of
# about SNAPSHOT_SHARD_BYTES (the reference snapshot's ten .bin shards
# hold ~1.9 GB each)
SNAPSHOT_LAYERS = 8
SNAPSHOT_SHARD_BYTES = 2 << 30
ADV_COUNTS = {"matched": 36, "color_mismatch": 180, "shape_mismatch": 180,
              "both_mismatch": 324}
ADV_SAVE_INTERVAL = 50  # extract_adversarial_activations.py:58
# the smoke run's adversarial capture checkpoints every 240 samples (3
# .tmp.npz writes of the 720 pairs) where the reference's 50 gives 11:
# each write rewrites the whole compressed archive (128 s of its 158 s
# in PR 17's final run), and 3 still exercise the checkpointing path;
# phase_adversarial_full_depth keeps the reference's 50
ADV_SMOKE_SAVE_INTERVAL = 240
ADV_STATS_KEYS = ["layer", "n_h1_features", "max_h1_persistence", "max_h0_persistence",
                  "silhouette_img_color", "silhouette_img_shape", "silhouette_txt_color",
                  "silhouette_txt_shape"]
# the synthetic adversarial clouds' layer clustered by image shape
ADV_CLUSTERED_LAYER = 5
# card against CPU at that layer: its fuzzy graph has six components (one
# per shape), so the spectral init is any basis of a six-fold zero
# eigenvalue, and rounding rotates it.  On the CPU alone, inputs changed
# by 1e-7 relative moved its silhouettes by up to 0.0134 and its max-H1 by
# up to 1.17 (shape_mismatch), the connected layers' by 1e-4 and 0.0073.
# So the clustered layer's silhouettes get a limit of their own (an H100
# read 0.0477, matched; its silhouette_img_shape is 0.86-0.94 against
# -0.2 to -0.05 elsewhere) and its max-H1 is reported, not compared; the
# other layers are held to SWEEP_SIL_TOL / SWEEP_H1_TOL.
ADV_CLUSTERED_SIL_TOL = 0.1
# phase multidevice: tdax's stage-5 resume tolerance and stage-6 int8-cache
# decode tolerance (__graft_entry__.py:246, :289); the dp=2 tp=2 bf16
# capture's floor on the cosine of each captured vector against one
# device, on the model's own init (the tp sums differ from one device's
# in order only: an H100 read 0.99993, as one device with its sums
# reordered); 8 new tokens of 16 prompts; the tiny model's 6 (the dry run's)
MD_RESUME_TOL = dict(rtol=1e-5, atol=1e-6)
MD_KV_INT8_TOL = dict(rtol=2e-3, atol=5e-3)
MD_MIN_COSINE = 0.999
MD_NEW_TOKENS, MD_TINY_NEW_TOKENS = 8, 6
MD_TIMEOUT_S = 600
# phase multidevice's sweep and scale stages (tdax's dry-run stages 2 and
# 3).  Four ranks' sweep (8 layers a rank) against phase sweep's on one
# device: the 500-epoch layouts amplify a batch's rounding as they amplify
# the card's against the CPU's (SWEEP_SIL_TOL), so silhouettes within
# 0.03, and tdax's stage-2 gate, each layer's pairwise-distance
# correlation > 0.995.  kNN at k = 15 on the scale cloud: a row's disputed
# neighbours within tdax's 1e-5 x max(1, d) of each other and its
# distances the k smallest within the same.  rips_at_scale(mesh=) (true
# f32) is held to the diagrams of one device's true-f32 matrix within
# SMALL_BOTTLENECK_TOL: against the one-device call through
# sqdist_sm90.cu's 3xTF32 its H0 deaths differ by up to 6.75e-3 on an
# H100, the gap phase scale reports as h0_deaths_sm90_vs_fma, the f32
# expansion form's cancellation at distances ~0.1 between points of norm
# ~32.  The scale stages run to H1.
MD_SWEEP_SIL_TOL, MD_UMAP_CORR = 0.03, 0.995
MD_KNN_K, MD_KNN_TIE = 15, 1e-5
MD_SCALE_MAXDIM = 1
MD_SPARSE_KW = dict(maxdim=MD_SCALE_MAXDIM, target_degree=SCALE_DEGREE, fused_max=0,
                    block_rows=SPARSE_BLOCK_ROWS)
# phase multidevice's training (tdax's dry-run stages 4 and 8): the full
# decoder widths cut to MD_TRAIN_LAYERS layers (depth only: four ranks
# and rank 0's one-device reference share one card's memory and the
# phase's time), text-only, bf16, remat, a fixed MD_TRAIN_BATCH x
# MD_TRAIN_SEQ batch whose last row's final MD_TRAIN_MASKED positions
# are masked (the dp ranks' token counts differ), AdamW at a constant lr,
# MD_TRAIN_STEPS plain steps and as many sequence-parallel ones at dp=2
# tp=2 against rank 0's one-device steps from the same init.  Each
# step's loss within MD_TRAIN_LOSS_RTOL relative of one device's: the
# sharded step rounds the same bf16 math in another order (the tp
# partials summed in f32 across ranks, the dp halves' CE summed apart),
# which moves a logit by a bf16 step here and there and the mean CE over
# ~1000 tokens by far less than 1e-3 of it, while a gradient missing a
# rank's share moves the second step's loss (the first step moves it by
# ~10%) by more.
MD_TRAIN_LAYERS, MD_TRAIN_STEPS, MD_TRAIN_LR = 2, 2, 1e-4
MD_TRAIN_BATCH, MD_TRAIN_SEQ, MD_TRAIN_MASKED = 4, 256, 32
MD_TRAIN_LOSS_RTOL = 1e-3
# phase multidevice's FSDP steps (tdax's dry-run stage 11): the gloo
# world's dp=2 tp=2 steps take the batch in MD_FSDP_ACCUM microbatches;
# the hybrid mesh's FSDP step (stage 12) runs MD_HYBRID_STEPS step
MD_FSDP_ACCUM, MD_HYBRID_STEPS = 2, 1
# phase multidevice's context parallelism (tdax's dry-run stage 10) on the
# four gloo ranks.  The ring alone on a dp=1 tp=1 cp=4 mesh at the full
# decoder's heads: q, k, v MD_RING_SHAPE bf16 (local chunks of 2048, zigzag
# halves of 1024: flash_fwd_sm90.cu and flash_bwd_sm90.cu at Tq != Tk), four
# cases (MD_RING_CASES: causal zigzag, causal contiguous under
# TDAX_NO_ZIGZAG=1, dense, causal with ragged key validity and one chunk
# wholly invalid for one row), and the same four in f32 at
# MD_RING_F32_SHAPE on flash_fwd.cu and flash_bwd.cu.  Each against one
# device's FlashAttention of the whole sequence (every rank computes it on
# the same seeded inputs and compares its own chunk): the output, rows that
# see no key masked as tdax's tests mask them, and the gradients of tdax's
# test loss sum(sin(o) * valid).  f32: tdax's ring gates (1e-5 on the
# output, rtol 1e-4 + atol 1e-5 on the gradients).  bf16: phase flash_bwd's
# bound (BWD_BF16_*) with its absolute part once for each of the cp partial
# results: the ring rounds each step's o, dq, dk and dv to bf16 apart
# (the kernels write bf16) before it merges o in f32 or autograd adds the
# gradients in bf16, where one device rounds each output once; a partial's
# rounding is 2^-8 of its size and its size is of the order of the row's,
# so |ring - one| <= BWD_BF16_RTOL |one| + cp (BWD_BF16_ATOL_OF_MAX +
# BWD_BF16_TERMS) max|one| over the row (a query row of o and dq, a key
# row of dk and dv: its heads and head dims).  A ring that lost a chunk
# moves a late row by a sizeable share of its own magnitude, far past it.
MD_RING_CP = 4
MD_RING_SHAPE, MD_RING_F32_SHAPE = (2, 8192, 32, 128), (2, 1024, 4, 64)
MD_RING_CASES = (("causal_zigzag", True, False, False), ("causal_contiguous", True, False, True),
                 ("dense", False, False, False), ("causal_ragged", True, True, False))
MD_RING_FWD_TOL, MD_RING_GRAD_TOL = 1e-5, dict(rtol=1e-4, atol=1e-5)
# the cp training step: MD_TRAIN_LAYERS full-width layers at dp=1 tp=2 cp=2
# with remat, MD_CP_BATCH x MD_CP_SEQ ids whose last MD_CP_MASKED positions
# are masked in every row (stage 10's mask, __graft_entry__.py:417),
# MD_TRAIN_STEPS steps against rank 0's one-device steps (MD_TRAIN_LOSS_RTOL)
MD_CP_BATCH, MD_CP_SEQ, MD_CP_MASKED = 2, 2048, 5
# phase multidevice's pipeline (tdax's dry-run stage 9) on the four gloo
# ranks at pp=4 dp=1: MD_PP_LAYERS full-width layers (one a stage); the
# forward on MD_PP_FWD_BATCH x MD_PP_FWD_SEQ ids in MD_PP_FWD_MICRO
# microbatches, gated at MD_MIN_COSINE against one device (the
# microbatches' GEMMs have other shapes, so their sums other orders); the
# 1F1B steps on MD_PP_BATCH x MD_PP_SEQ ids in MD_PP_MICRO microbatches
# (M = 2S), MD_TRAIN_STEPS of them against one device's
# (MD_TRAIN_LOSS_RTOL), the last row's final MD_TRAIN_MASKED positions
# masked so the microbatches' token counts differ
MD_PP, MD_PP_LAYERS = 4, 4
MD_PP_FWD_BATCH, MD_PP_FWD_SEQ, MD_PP_FWD_MICRO = 4, 256, 4
MD_PP_BATCH, MD_PP_SEQ, MD_PP_MICRO = 8, 1024, 8

# (name, B, Tq, Tk, nh, hd, causal, calls per batch on the main path)
MAIN_SHAPES = [
    ("decoder", 16, 320, 320, 32, 128, True, 32),
    ("vit", 16, 1024, 1024, 16, 104, False, 48),
    ("resampler", 16, 256, 1024, 32, 128, False, 1),
]
# Kimi-VL's latent attention in a capture batch: (name, B, T, nh, q.k
# width, v width, calls a batch), causal, one call a decoder layer
MLA_SHAPE = ("mla", 16, 320, 16, 192, 128, 27)
# the training step's attention: causal, with lse, 2 x 32 calls a step
# (forward and remat replay)
TRAIN_SHAPE = ("train", 4, 1024, 1024, 32, 128, True, 64)
# the decode step's attention: one query row over the 352-row cache; and
# at a tp rank's 16 heads (dp=2 tp=2: 8 rows)
DECODE_SHAPE = ("decode", 16, 1, 352, 32, 128, False)
DECODE_TP_SHAPE = ("decode_tp", 8, 1, 352, 16, 128, False)
F32_SHAPES = [  # tests/test_flash_attention.py:37-50, batch 2, plus hd 104
    (40, 40, 2, 16, True), (40, 40, 2, 16, False), (8, 40, 2, 20, False),
    (130, 130, 1, 128, True), (16, 260, 1, 32, False), (64, 192, 2, 128, False),
    (256, 256, 2, 128, True), (1024, 1024, 1, 128, True), (128, 640, 2, 128, True),
    (70, 70, 2, 104, True),
]


# the visual tower's elementwise kernels (vit_elementwise_sm90.cu) at a
# capture batch's sites: (site, rows, cols, form, calls a batch), 100
# LayerNorms and 196 epilogues (2 and 4 a block, ln_pre, ln_kv, ln_q,
# ln_post, the resampler's four bias adds)
VIT_SITES = [
    ("ln_pre/ln_1/ln_2", 16 * 1024, 1664, "layer_norm", 97),
    ("ln_kv", 16 * 1024, 4096, "layer_norm", 1),
    ("ln_post", 16 * 256, 4096, "layer_norm", 1),
    ("ln_q", 256, 4096, "layer_norm", 1),
    ("qkv", 16 * 1024, 4992, "bias", 48),
    ("fc", 16 * 1024, 8192, "gelu", 48),
    ("attn_proj/mlp_proj", 16 * 1024, 1664, "residual", 96),
    ("resampler_k/v", 16 * 1024, 4096, "bias", 2),
    ("resampler_q/out", 16 * 256, 4096, "bias", 2),
]
VIT_LN_PER_BATCH, VIT_EPILOGUE_PER_BATCH = 100, 196
VIT_EPS = 1e-6
# the card test's limits (tests/test_torch_vit_elementwise_cuda.py): the
# LayerNorm (summed in the order of PyTorch's CUDA reduce) and the bias
# and residual forms bitwise; the GELU within one ulp of the type


# the flash backward: (name, B, Tq, Tk, nh, hd, causal, calls per training step)
BWD_SHAPES = [
    ("decoder", 4, 1024, 1024, 32, 128, True, 32),
    ("vit", 4, 1024, 1024, 16, 104, False, 0),
    ("resampler", 4, 256, 1024, 32, 128, False, 0),
    ("ragged", 3, 77, 131, 3, 40, True, 0),
]
# f32: the kernel and the plain version sum in other orders; the bound is
# relative to the magnitude of the summed terms (ds's size bound
# p (|dO|.|v| + |delta|) scale times |k| or |q|; p |dO| for dv).  bf16:
# 2^-7 |plain| + 1e-3 max|plain| for the output's rounding, plus 2^-8 of
# the summed terms' magnitude (|ds| |k|, |ds| |q|, p |dO|): each ds or p
# is rounded to bf16 before its product, and where the kernel's f32 value
# and the plain version's lie on two sides of a rounding edge the term
# moves by one bf16 step (2^-8 relative).  lse: 1e-5 relative to 1 + |lse|.
BWD_F32_REL_TOL = 1e-5
BWD_BF16_RTOL, BWD_BF16_ATOL_OF_MAX, BWD_BF16_TERMS = 2.0 ** -7, 1e-3, 2.0 ** -8
LSE_TOL = 1e-5
# flash_bwd_sm90.cu is held to the same bf16 bound: its p = 2^(s log2 e -
# lse log2 e) on the MUFU ex2 differs from flash_bwd.cu's expf by ~2^-22
# relative, far inside one bf16 step (2^-8) of the rounded p and ds
BWD_REPEATS = 5         # timed repeats of each backward: median and spread
# tiny f32 training, card against CPU: gradients within 1e-4 of each
# leaf's largest magnitude; params after three AdamW steps within 1e-4
# relative + 3e-5 (Adam divides by the root of the second moment, so a
# gradient rounding differently near zero moves its update more than its
# own error; tests/test_torch_train_step.py holds tdax to the same)
TINY_GRAD_TOL, TINY_PARAM_RTOL, TINY_PARAM_ATOL = 1e-4, 1e-4, 3e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKED, TRAIN_TIMED_STEPS = 4, 1024, 128, 5
# the training phase's seven losses at --seed 0 through flash_bwd.cu (an
# H100 80GB HBM3 at 700 W); two runs of equal math but other kernels' sum
# orders (flash_fwd.cu and flash_fwd_sm90.cu) moved them by at most 0.016,
# bf16 noise.  A wrong gradient moves the descent far more.
TRAIN_REF_LOSSES_SEED0 = [12.400, 12.400, 11.078, 9.922, 8.478, 7.562, 6.211]
TRAIN_LOSS_TOL = 0.1


# the sources ptxas must compile without a spill and with setmaxnreg kept
SM90_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "qmm_sm90", "sqdist_sm90",
                "flash_decode_sm90", "qmm_decode_sm90", "vit_elementwise_sm90")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def import_port():
    sys.path.insert(0, str(HERE))
    import tdax_torch
    where = Path(tdax_torch.__file__).resolve().parent
    if where != HERE / "tdax_torch":
        raise RuntimeError(f"tdax_torch imported from {where}, not from this checkout")
    return tdax_torch


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(b, tq, tk, nh, hd, causal, itemsize):
    """(ms, 'operations' | 'bytes'): the least time for one call."""
    flops = 4.0 * b * nh * tq * tk * hd / (2 if causal else 1)
    nbytes = (2 * b * tq + 2 * b * tk) * nh * hd * itemsize + 4 * b * tk  # q, o, k, v, bias
    peak = BF16_PEAK if itemsize == 2 else F32_PEAK
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_env() -> dict:
    import concurrent.futures
    import importlib.util

    import torch
    smi = nvidia_smi()
    from tdax_torch.ops import _build
    from tdax_torch.ops.rips import native
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        engine = pool.submit(lambda: (native.build(), time.perf_counter() - t0)[1])
        _build.build()
        build_s = time.perf_counter() - t0
        engine_s = engine.result()
    ptxas = []
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        ptxas += [ln.strip() for ln in log.read_text().splitlines()
                  if any(w in ln for w in ("registers", "spill", "C7508", "setmaxnreg"))]
    # the Hopper kernels: setmaxnreg ignored (C7508) or any spill is a fault
    sm90_regs = {}
    for name in SM90_SOURCES:
        sm90_log = (_build.BUILD_DIR / f"{name}.log").read_text()
        sm90_regs[name] = [ln.strip() for ln in sm90_log.splitlines()
                           if any(w in ln for w in ("registers", "spill", "C75", "setmaxnreg"))]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", sm90_log)]
        if "C7508" in sm90_log or "setmaxnreg ignored" in sm90_log or any(spills):
            raise AssertionError(f"{_build.SOURCES[name]}: ptxas ignored setmaxnreg or "
                                 f"spilled:\n" + sm90_log[-4000:])
    info = {"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
            "build_s": round(build_s, 3), "built": sorted(_build.BUILD_SECONDS),
            "build_s_by_source": {n: round(t, 3) for n, t in _build.BUILD_SECONDS.items()},
            "engine_build_s": engine_s, "ptxas": ptxas, "ptxas_sm90": sm90_regs,
            "matplotlib": importlib.util.find_spec("matplotlib") is not None}
    emit(info)
    return info


def _case_inputs(gen, b, tq, tk, nh, hd, dtype, device, strided_kv: bool, strided_q: bool):
    """q/k/v as the model hands them over: views of a fused projection
    where the model splits one (ViT: q, k, v; decoder: v)."""
    import torch

    def fused(t, n):
        x = torch.randn((b, t, n * nh * hd), generator=gen, device=device, dtype=dtype)
        return [c.reshape(b, t, nh, hd) for c in x.split(nh * hd, dim=-1)]

    def plain(t):
        return torch.randn((b, t, nh, hd), generator=gen, device=device, dtype=dtype)

    if strided_q:
        q, k, v = fused(tq, 3)
    else:
        q = plain(tq)
        k, v = (fused(tk, 2) if strided_kv else (plain(tk), plain(tk)))
    return q, k, v


def _visible(valid, tq, tk, causal):
    import torch
    keyed = (valid > 0)[:, None, :].expand(valid.shape[0], tq, tk)
    if causal:
        keyed = keyed & torch.ones((tq, tk), dtype=torch.bool, device=valid.device).tril()
    return keyed.any(-1)  # [B, Tq]


def _check_case(fa, q, k, v, valid, causal, atol, rtol, label, kernel=None, with_lse=False):
    """One forward kernel (the routed one, or ``kernel="mma"``) against
    the plain version on the rows that see a key; with ``with_lse`` the
    lse on every row within LSE_TOL * (1 + |lse|).  Returns (bias,
    max |kernel - plain|, rows checked, rows, max |lse - plain lse|)."""
    import torch
    bias = torch.where(valid > 0, 0.0, fa.NEG_INF).to(torch.float32)
    got = fa.flash_attention(q, k, v, bias, causal, with_lse, _kernel=kernel)
    want = fa.flash_attention_plain(q, k, v, bias, causal, with_lse)
    torch.cuda.synchronize()
    lse_err = None
    if with_lse:
        (got, lse), (want, lse_want) = got, want
        lse_err = float((lse - lse_want).abs().max())
        if float(((lse - lse_want).abs() - LSE_TOL * (1 + lse_want.abs())).max()) > 0:
            raise AssertionError(f"{label}: lse differs from the plain version's by {lse_err:.3e}")
    if got.shape != want.shape or got.dtype != q.dtype:
        raise AssertionError(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    rows = _visible(valid, q.shape[1], k.shape[1], causal)
    g, w = got.float()[rows], want.float()[rows]
    err = (g - w).abs()
    max_abs = float(err.max())
    excess = float((err - (atol + rtol * w.abs())).max())
    if excess > 0:
        raise AssertionError(f"{label}: max |kernel - plain| = {max_abs:.3e} exceeds "
                             f"atol {atol} + rtol {rtol} * |plain|")
    return bias, max_abs, int(rows.sum()), int(rows.numel()), lse_err


def phase_kernels() -> dict:
    """Every kernel of the path against its plain version, on the card."""
    import torch
    import torch.nn.functional as F
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.runtime import get_device

    device = get_device()
    gen = torch.Generator(device=device).manual_seed(1234)
    sites, train = [], None
    for name, b, tq, tk, nh, hd, causal, calls in MAIN_SHAPES + [TRAIN_SHAPE]:
        with_lse = name == "train"
        q, k, v = _case_inputs(gen, b, tq, tk, nh, hd, torch.bfloat16, device,
                               strided_kv=name in ("decoder", "train"), strided_q=name == "vit")
        valid = torch.ones((b, tk), dtype=torch.int32, device=device)
        if name == "decoder":  # right-padded rows of different lengths, one full
            lengths = torch.randint(200, tk, (b,), generator=gen, device=device)
            lengths[0] = tk
            valid = (torch.arange(tk, device=device)[None] < lengths[:, None]).to(torch.int32)
        elif name == "train":  # the training batch's mask
            valid[-1, -TRAIN_MASKED:] = 0
        route = fa._route(q, k, v)
        if route != "sm90":
            raise AssertionError(f"bf16 {name}: routed to the {route} kernel, not sm90")
        err = {}
        for kernel in ("sm90", "mma"):
            before = (fa.LAUNCHES, fa.LAUNCHES_SM90)
            bias, err[kernel], n_rows, n_all, err[kernel + "_lse"] = _check_case(
                fa, q, k, v, valid, causal, BF16_ATOL, BF16_RTOL, f"bf16 {name} ({kernel})",
                kernel=None if kernel == "sm90" else "mma", with_lse=with_lse)
            moved = (fa.LAUNCHES - before[0], fa.LAUNCHES_SM90 - before[1])
            if moved != (1, int(kernel == "sm90")):
                raise AssertionError(f"bf16 {name} ({kernel}): launch counters moved {moved}")
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, bias, causal, with_lse), iters=20)
        ms_mma = cuda_ms(lambda: fa.flash_attention(q, k, v, bias, causal, with_lse,
                                                    _kernel="mma"), iters=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias, causal, with_lse),
                           iters=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if name == "decoder":
            mask = (valid > 0)[:, None, None, :] & torch.ones(
                (tq, tk), dtype=torch.bool, device=device).tril()
        # the training shape: SDPA's forward with is_causal and no key mask,
        # as PR 4 timed it
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=name == "train"), iters=20)
        bound_ms, bound_by = bound(b, tq, tk, nh, hd, causal, 2)
        site = {"site": name, "shape": [b, tq, tk, nh, hd], "causal": causal,
                "dtype": "bfloat16", "route": route, "lse": with_lse,
                "max_abs_err": err["sm90"], "max_abs_err_mma": err["mma"],
                "lse_max_abs_err": err["sm90_lse"], "lse_max_abs_err_mma": err["mma_lse"],
                "rows_checked": n_rows, "rows": n_all, "ms": ms, "ms_mma": ms_mma,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                "share_of_bound_mma": bound_ms / ms_mma,
                ("calls_per_train_step" if with_lse else "calls_per_batch"): calls}
        emit({"phase": "kernel_case", **site})
        if with_lse:
            train = site
        else:
            sites.append(site)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()

    decode = _decode_cases(fa, gen, device)
    mla = _mla_case(fa, gen, device)

    f32_errs = []
    for tq, tk, nh, hd, causal in F32_SHAPES:
        b = 2
        q, k, v = _case_inputs(gen, b, tq, tk, nh, hd, torch.float32, device,
                               strided_kv=False, strided_q=False)
        valid = torch.ones((b, tk), dtype=torch.int32, device=device)
        valid[0, tk - 7:] = 0
        _, max_abs, _, _, _ = _check_case(fa, q, k, v, valid, causal, F32_TOL, F32_TOL,
                                          f"f32 {(tq, tk, nh, hd, causal)}")
        f32_errs.append(max_abs)
    emit({"phase": "kernel_f32", "shapes": F32_SHAPES, "max_abs_err": f32_errs,
          "tolerance": F32_TOL})

    # all-masked rows: the output must be finite and lse 0 (both kernels)
    q, k, v = _case_inputs(gen, 2, 64, 64, 2, 32, torch.bfloat16, device, False, False)
    for kernel in (None, "mma"):
        out, lse = fa.flash_attention(q, k, v, torch.full((2, 64), fa.NEG_INF, device=device),
                                      True, True, _kernel=kernel)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all() or not (lse == 0).all():
            raise AssertionError(f"fully masked rows ({kernel or 'sm90'}): non-finite output "
                                 "or lse not 0")
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    vit = _vit_elementwise_cases(device)
    return {"sites": sites, "train": train, "decode": decode, "f32_max_abs_err": max(f32_errs),
            "vit": vit, "mla": mla}


def _mla_case(fa, gen, device) -> dict:
    """Latent attention at Kimi-VL's capture shape: q and k of 192
    columns, v of 128 (a view of the second half of each head of one kv
    product, as the decoder hands it over), causal, rows right-padded to
    lengths of 200 and more.  The route must pick the sm90 kernel
    (flash_fwd_mla_kernel); it and flash_fwd.cu (forced) are checked
    against the plain version with and without lse and timed."""
    import torch
    import torch.nn.functional as F
    from benchmark.roofline import attn_fwd_bound

    name, b, t, nh, hd, hd_v, calls = MLA_SHAPE
    q, k = (torch.randn((b, t, nh, hd), generator=gen, device=device, dtype=torch.bfloat16)
            for _ in range(2))
    v = torch.randn((b, t, nh, 2 * hd_v), generator=gen, device=device,
                    dtype=torch.bfloat16)[..., hd_v:]
    lengths = torch.randint(200, t, (b,), generator=gen, device=device)
    lengths[0] = t
    valid = (torch.arange(t, device=device)[None] < lengths[:, None]).to(torch.int32)
    route = fa._route(q, k, v)
    if route != "sm90":
        raise AssertionError(f"bf16 {name}: routed to the {route} kernel, not sm90")
    err, lse_err = {}, {}
    for kernel in ("sm90", "mma"):
        for with_lse in (False, True):
            before = (fa.LAUNCHES, fa.LAUNCHES_SM90, fa.LAUNCHES_MLA)
            bias, e, n_rows, n_all, le = _check_case(
                fa, q, k, v, valid, True, BF16_ATOL, BF16_RTOL,
                f"bf16 {name} ({kernel}, lse {with_lse})",
                kernel=None if kernel == "sm90" else "mma", with_lse=with_lse)
            moved = (fa.LAUNCHES - before[0], fa.LAUNCHES_SM90 - before[1],
                     fa.LAUNCHES_MLA - before[2])
            on_sm90 = int(kernel == "sm90")
            if moved != (1, on_sm90, on_sm90):
                raise AssertionError(f"bf16 {name} ({kernel}): launch counters moved {moved}")
            err[kernel] = max(err.get(kernel, 0.0), e)
            if le is not None:
                lse_err[kernel] = le
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (valid > 0)[:, None, None, :] & torch.ones((t, t), dtype=torch.bool,
                                                      device=device).tril()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                         iters=20)
    case = {"site": name, "shape": [b, t, t, nh, hd], "hd_v": hd_v, "causal": True,
            "dtype": "bfloat16", "route": route, "kernel": "flash_fwd_mla_kernel",
            "max_abs_err": err["sm90"], "max_abs_err_mma": err["mma"],
            "lse_max_abs_err": lse_err["sm90"], "lse_max_abs_err_mma": lse_err["mma"],
            "rows_checked": n_rows, "rows": n_all,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, bias, True), iters=20),
            "ms_mma": cuda_ms(lambda: fa.flash_attention(q, k, v, bias, True, _kernel="mma"),
                              iters=10),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias, True), iters=3),
            "library_ms": library_ms,
            "bound_ms": 1e3 * attn_fwd_bound(b, t, t, nh, hd, True, 2, hd_v=hd_v),
            "calls_per_batch": calls}
    case["share_of_bound"] = _share(case["bound_ms"], case["ms"])
    case["share_of_bound_mma"] = _share(case["bound_ms"], case["ms_mma"])
    emit({"phase": "kernel_case", **case})
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return case


def _ulps(got, want, scale):
    """The largest |got - want| in units in the last place of got's type
    at max(scale, |want|) (the smallest normal's at 0)."""
    import torch
    mantissa = {torch.bfloat16: 7, torch.float32: 23}[got.dtype]
    mag = torch.maximum(scale, want.float().abs()).clamp_min_(torch.finfo(got.dtype).tiny)
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), (e - 1 - mantissa).int())
    return float(((got.float() - want.float()).abs_() / ulp).max())


def _vit_elementwise_case(ve, gen, device, site, dtype) -> dict:
    """One site of VIT_SITES: the wrapper (layer_norm; bias_epilogue_ on a
    copy of the product) against the plain version on the same inputs,
    one launch counted; in bf16 the kernel, the plain version and the
    bound timed."""
    import torch
    name, rows, cols, form, calls = site
    x = (torch.randn(rows, cols, generator=gen, device=device) * 2 + 0.3).to(dtype)
    v = (torch.randn(2, cols, generator=gen, device=device) * 0.5).to(dtype)
    w, b = (v[0] + 1).contiguous(), v[1].contiguous()
    label = f"vit_elementwise {name} [{rows}, {cols}] {form} {str(dtype)[6:]}"
    before = (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE)
    if form == "layer_norm":
        got = ve.layer_norm(x, w, b, VIT_EPS)
        want = ve.layer_norm_plain(x, w, b, VIT_EPS)
        moved = (1, 0)
        rec = {"bitwise": bool(torch.equal(got, want))}
        if not rec["bitwise"]:
            raise AssertionError(f"{label}: {int((got != want).sum())} elements differ from "
                                 "the plain version's")
    else:
        res = (x * 0.5).to(dtype) if form == "residual" else None
        gelu = form == "gelu"
        work = x.clone()
        got = ve.bias_epilogue_(work, b, gelu=gelu, residual=res)
        want = ve.bias_epilogue_plain(x, b, gelu, res)
        moved = (0, 1)
        if got is not work:
            raise AssertionError(f"{label}: the result is not written over the product")
        if gelu:
            rec = {"max_ulps": _ulps(got, want, want.float().abs()), "ulps_limit": 1}
            if rec["max_ulps"] > 1:
                raise AssertionError(f"{label}: {rec} against the plain version")
        else:
            rec = {"bitwise": bool(torch.equal(got, want))}
            if not rec["bitwise"]:
                raise AssertionError(f"{label}: differs from the plain version's bits")
    torch.cuda.synchronize()
    if (ve.LAUNCHES_LN - before[0], ve.LAUNCHES_EPILOGUE - before[1]) != moved:
        raise AssertionError(f"{label}: the launch counters did not move by {moved}")
    if got.dtype != dtype or got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)}, or non-finite")
    rec = {"site": name, "shape": [rows, cols], "form": form, "dtype": str(dtype)[6:],
           "calls_per_batch": calls, **rec}
    if dtype == torch.bfloat16:
        if form == "layer_norm":
            fn = lambda: ve.layer_norm_cuda(x, w, b, VIT_EPS)  # noqa: E731
            plain = lambda: ve.layer_norm_plain(x, w, b, VIT_EPS)  # noqa: E731
            nbytes = 2 * rows * cols + 2 * cols
        else:
            fn = lambda: ve.bias_epilogue_cuda(work, b, gelu, res, in_place=True)  # noqa: E731
            plain = lambda: ve.bias_epilogue_plain(x, b, gelu, res)  # noqa: E731
            nbytes = (2 + (res is not None)) * rows * cols + cols
        rec["ms"] = _device_ms(fn, 30)
        rec["plain_ms"] = _device_ms(plain, 10)
        rec["bound_ms"] = 1e3 * nbytes * x.element_size() / HBM_BYTES_PER_S
        rec["share_of_bound"] = _share(rec["bound_ms"], rec["ms"])
    emit({"phase": "kernel_case", "kernel": "vit_elementwise", **rec})
    return rec


def _vit_elementwise_cases(device) -> dict:
    """vit_ln_rows and vit_bias_epilogue at every site of a capture batch
    (VIT_SITES), bf16 (timed) and f32, against their plain versions; the
    batch's totals weighted by each site's calls."""
    import torch
    import tdax_torch.ops.vit_elementwise as ve
    gen = torch.Generator(device=device).manual_seed(26)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for site in VIT_SITES:
            cases.append(_vit_elementwise_case(ve, gen, device, site, dtype))
            torch.cuda.empty_cache()
    timed = [c for c in cases if "ms" in c]

    def total(key):
        values = [c[key] * c["calls_per_batch"] if isinstance(c[key], float) else None
                  for c in timed]
        return sum(values) if None not in values else "not measured"

    return {"cases": cases, "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "gelu_max_ulps": {dt: max(c["max_ulps"] for c in cases
                                      if c["form"] == "gelu" and c["dtype"] == dt)
                              for dt in ("bfloat16", "float32")},
            "bitwise": all(c["bitwise"] for c in cases if "bitwise" in c)}


def _decode_case(fa, gen, device, shape, masked_split: bool) -> dict:
    """One decode-step attention on flash_decode_sm90.cu (the route's
    choice) and flash_fwd.cu (forced): q of one row, k/v the layer's
    cache, valid keys up to each sample's own position (one sample at the
    cache's last row); with ``masked_split`` the keys of the kernel's
    second split (of 2 x warps) masked on every row.  Each checked against
    the plain version (with lse too, and causal), repeated bitwise, and
    timed by the card's kernel time beside SDPA's and the plain
    version's."""
    import torch
    import torch.nn.functional as F
    from tdax_torch.runtime import sm_count
    name, b, tq, tk, nh, hd, causal = shape
    q, k, v = _case_inputs(gen, b, tq, tk, nh, hd, torch.bfloat16, device, False, False)
    cur = torch.randint(200, tk, (b,), generator=gen, device=device)
    cur[0] = tk - 1
    valid = (torch.arange(tk, device=device)[None] <= cur[:, None]).to(torch.int32)
    warps = fa._decode_warps(b, nh, tk, sm_count(device.index or 0))
    slots, at_once = 2 * warps, fa.DECODE_KEYS_AT_ONCE
    chunk = math.ceil(math.ceil(tk / slots) / at_once) * at_once  # keys a split
    if masked_split:
        valid[:, chunk:2 * chunk] = 0
    route = fa._route(q, k, v)
    if route != "decode":
        raise AssertionError(f"bf16 {name}: routed to the {route} kernel, not decode")
    label = f"bf16 {name}" + (" (split 1 masked)" if masked_split else "")
    err, lse_err = {}, {}
    for kernel in ("decode", "mma"):
        forced = None if kernel == "decode" else "mma"
        for with_lse, c in ((False, causal), (True, causal), (False, True)):
            before = (fa.LAUNCHES, fa.LAUNCHES_SM90, fa.LAUNCHES_DECODE)
            bias, e, _, _, le = _check_case(fa, q, k, v, valid, c, BF16_ATOL, BF16_RTOL,
                                            f"{label} ({kernel}, lse {with_lse}, causal {c})",
                                            kernel=forced, with_lse=with_lse)
            moved = (fa.LAUNCHES - before[0], fa.LAUNCHES_SM90 - before[1],
                     fa.LAUNCHES_DECODE - before[2])
            if moved != (1, 0, int(kernel == "decode")):
                raise AssertionError(f"{label} ({kernel}): launch counters moved {moved}")
            err[kernel] = max(err.get(kernel, 0.0), e)
            if le is not None:
                lse_err[kernel] = le
    bias = torch.where(valid > 0, 0.0, fa.NEG_INF).to(torch.float32)
    first = fa.flash_attention(q, k, v, bias, causal, True)
    again = fa.flash_attention(q, k, v, bias, causal, True)
    bitwise = bool(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]))
    if not bitwise:
        raise AssertionError(f"{label}: a repeat differs")
    mask = (valid > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    case = {"site": name, "shape": [b, tq, tk, nh, hd], "causal": causal, "dtype": "bfloat16",
            "route": route, "warps": warps, "splits": slots, "keys_a_split": chunk,
            "masked_split": masked_split, "max_abs_err": err["decode"],
            "max_abs_err_mma": err["mma"], "lse_max_abs_err": lse_err["decode"],
            "lse_max_abs_err_mma": lse_err["mma"], "bitwise_repeat": bitwise}
    if not masked_split:
        case.update(
            ms=_device_ms(lambda: fa.flash_attention(q, k, v, bias, causal), 50),
            ms_mma=_device_ms(lambda: fa.flash_attention(q, k, v, bias, causal,
                                                         _kernel="mma"), 50),
            plain_ms=_device_ms(lambda: fa.flash_attention_plain(q, k, v, bias, causal), 10),
            library_ms=_device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), 50),
            ms_events=cuda_ms(lambda: fa.flash_attention(q, k, v, bias, causal), iters=50),
            timed_by="torch.profiler kernel time (ms_events: CUDA events over back-to-back "
                     "calls, the wrapper's host time included)")
        case["bound_ms"], case["bound_by"] = bound(b, tq, tk, nh, hd, causal, 2)
        case["share_of_bound"] = _share(case["bound_ms"], case["ms"])
        case["share_of_bound_mma"] = _share(case["bound_ms"], case["ms_mma"])
    emit({"phase": "kernel_case", **case})
    del q, k, v, qt, kt, vt, mask
    return case


def _share(bound_ms, ms):
    return bound_ms / ms if isinstance(ms, float) and ms > 0 else "not measured"


def _decode_cases(fa, gen, device) -> dict:
    """The decode step's attention on flash_decode_sm90.cu: the main path's
    shape (timed), one split masked, a tp rank's 16 heads (timed)."""
    main = _decode_case(fa, gen, device, DECODE_SHAPE, False)
    masked = _decode_case(fa, gen, device, DECODE_SHAPE, True)
    tp = _decode_case(fa, gen, device, DECODE_TP_SHAPE, False)
    keys = ("max_abs_err", "max_abs_err_mma", "lse_max_abs_err", "lse_max_abs_err_mma")
    return {**main, "calls_per_decode_step": 32, "masked_split_case": masked, "tp_case": tp,
            **{key: max(c[key] for c in (main, masked, tp)) for key in keys}}


def qmm_bound(m, k, n, x_bytes):
    """(ms, 'operations' | 'bytes'): 2MNK tensor-core flops; x, q, s read
    once and the output written once."""
    t_ops = 2.0 * m * n * k / BF16_PEAK
    t_bytes = (m * k * x_bytes + k * n + 4 * n + m * n * x_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _qmm_check(qm, x, w, label, kernel=None) -> float:
    """The kernel the route picks (or ``kernel``, forced) against the
    plain version; max |kernel - plain|.  The launch counters must move
    as the choice says."""
    import torch
    x2 = x.reshape(-1, x.shape[-1])
    route = kernel or qm._route(x2, w["q"], w["s"])
    before = (qm.LAUNCHES, qm.LAUNCHES_SM90, qm.LAUNCHES_DECODE)
    got = qm.quant_matmul(x, w["q"], w["s"], _kernel=kernel)
    if (qm.LAUNCHES, qm.LAUNCHES_SM90, qm.LAUNCHES_DECODE) != (
            before[0] + 1, before[1] + (route == "sm90"), before[2] + (route == "decode")):
        raise AssertionError(f"qmm {label}: the launch counters did not move as the {route} "
                             "kernel says")
    want = qm.quant_matmul_plain(x, w["q"], w["s"])
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != x.dtype:
        raise AssertionError(f"qmm {label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"qmm {label}: non-finite kernel output")
    err = (got.float() - want.float()).abs_()
    if x.dtype == torch.bfloat16:
        ref = want.float().abs_()
        limit = ref.mul_(QMM_BF16_RTOL).add_(QMM_BF16_ATOL_OF_MAX * float(ref.max()))
    else:
        limit = (x.abs() @ w["q"].float().abs()) * w["s"] * QMM_F32_REL_TOL
    excess = float((err - limit).max())
    max_abs = float(err.max())
    if excess > 0:
        raise AssertionError(f"qmm {label}: max |kernel - plain| = {max_abs:.3e} is outside "
                             f"the tolerance by {excess:.3e}")
    return max_abs


def _qmm_repeat(qm, x, w, label: str) -> bool:
    """Two launches on the same inputs give the same bits."""
    import torch
    if not torch.equal(qm.quant_matmul(x, w["q"], w["s"]), qm.quant_matmul(x, w["q"], w["s"])):
        raise AssertionError(f"qmm {label}: a repeat differs")
    return True


def _qmm_grad_check(qm, x, w, label: str) -> dict:
    """x's gradient through ``qmm`` with grad on (QuantMatmul): present,
    one kernel launch counted as the route says, and within QMM_GRAD_TOL
    (relative and absolute) of the plain version's autograd gradient on
    the card for the same dy."""
    import torch
    route = qm._route(x.reshape(-1, x.shape[-1]), w["q"], w["s"])
    xg = x.detach().clone().requires_grad_()
    before = (qm.LAUNCHES, qm.LAUNCHES_SM90, qm.LAUNCHES_DECODE)
    out = qm.qmm(xg, w["q"], w["s"])
    launched = [qm.LAUNCHES - before[0], qm.LAUNCHES_SM90 - before[1],
                qm.LAUNCHES_DECODE - before[2]]
    dy = torch.randn(out.shape, generator=torch.Generator(device=x.device).manual_seed(7),
                     device=x.device, dtype=out.dtype)
    out.backward(dy)
    xp = x.detach().clone().requires_grad_()
    qm.quant_matmul_plain(xp, w["q"], w["s"]).backward(dy)
    torch.cuda.synchronize()
    if xg.grad is None or launched != [1, int(route == "sm90"), int(route == "decode")]:
        raise AssertionError(f"qmm grad {label}: x.grad {xg.grad is not None}, launches "
                             f"{launched} on {route}")
    err = (xg.grad.float() - xp.grad.float()).abs_()
    ref = xp.grad.float().abs_()
    excess = float((err - QMM_GRAD_TOL * (1.0 + ref)).max())
    rec = {"site": label, "shape": [*x.shape, w["q"].shape[1]], "route": route,
           "launches": launched, "max_abs_err": float(err.max()),
           "max_abs_grad": float(ref.max())}
    if excess > 0:
        raise AssertionError(f"qmm grad {label}: {rec}")
    return rec


def phase_qmm() -> dict:
    """The int8 matmul kernels against their plain version at every site of
    the int8 capture and of a decode step, on the card: the kernel the
    route picks, and qmm.cu (forced) where that is qmm_sm90.cu, both
    timed; ragged shapes on both, untimed; f32 on qmm.cu; the gradient
    through qmm at QMM_GRAD_SITES."""
    import torch
    from tdax_torch.models.qwen_vl.quantize import quantize_weight
    from tdax_torch.ops import quant_matmul as qm
    from tdax_torch.runtime import get_device, sm_count

    device = get_device()
    gen = torch.Generator(device=device).manual_seed(2468)
    f32_errs = []
    for m, k, n in QMM_F32_SHAPES:
        x = torch.randn((m, k), generator=gen, device=device)
        w = quantize_weight(torch.randn((k, n), generator=gen, device=device) / math.sqrt(k))
        f32_errs.append(_qmm_check(qm, x, w, f"f32 {(m, k, n)}"))
    emit({"phase": "kernel_qmm_f32", "shapes": QMM_F32_SHAPES, "max_abs_err": f32_errs,
          "tolerance": f"{QMM_F32_REL_TOL} * (|x| @ |q| * s)"})

    ragged = []
    for m, k, n in QMM_RAGGED_SHAPES:
        x = torch.randn((m, k), generator=gen, device=device, dtype=torch.bfloat16)
        w = quantize_weight(torch.randn((k, n), generator=gen, device=device) / math.sqrt(k))
        route = qm._route(x, w["q"], w["s"])
        if route != "sm90":
            raise AssertionError(f"qmm ragged {(m, k, n)}: routed to {route}, not sm90")
        ragged.append({"shape": [m, k, n], "route": route,
                       "max_abs_err": _qmm_check(qm, x, w, f"ragged {(m, k, n)}"),
                       "max_abs_err_mma": _qmm_check(qm, x, w, f"ragged {(m, k, n)} (mma)",
                                                     kernel="mma")})
    for m, k, n in QMM_DECODE_RAGGED_SHAPES:
        x = torch.randn((m, k), generator=gen, device=device, dtype=torch.bfloat16)
        w = quantize_weight(torch.randn((k, n), generator=gen, device=device) / math.sqrt(k))
        route = qm._route(x, w["q"], w["s"])
        if route != "decode":
            raise AssertionError(f"qmm ragged {(m, k, n)}: routed to {route}, not decode")
        ragged.append({"shape": [m, k, n], "route": route,
                       "split": list(qm._decode_split(k, n, sm_count(device.index or 0))),
                       "max_abs_err": _qmm_check(qm, x, w, f"ragged {(m, k, n)}"),
                       "max_abs_err_mma": _qmm_check(qm, x, w, f"ragged {(m, k, n)} (mma)",
                                                     kernel="mma"),
                       "bitwise_repeat": _qmm_repeat(qm, x, w, f"ragged {(m, k, n)}")})
    emit({"phase": "kernel_qmm_ragged", "cases": ragged,
          "tolerance": f"{QMM_BF16_RTOL} |plain| + {QMM_BF16_ATOL_OF_MAX} max|plain|"})

    sites, grads = [], []
    for name, m, k, n, per_batch, per_step in QMM_SITES:
        x = torch.randn((m, k), generator=gen, device=device, dtype=torch.bfloat16)
        w = quantize_weight(torch.randn((k, n), generator=gen, device=device) / math.sqrt(k))
        route = qm._route(x, w["q"], w["s"])
        want_route = ("mma" if name == "vit.patch_w" else "sm90" if m >= qm.SM90_MIN_M
                      else "decode" if m <= qm.DECODE_MAX_M else "mma")
        if route != want_route:
            raise AssertionError(f"qmm {name}: routed to {route}, expected {want_route}")
        max_abs = _qmm_check(qm, x, w, name)
        dense = (w["q"].float() * w["s"]).to(torch.bfloat16)  # the library's operand
        # a decode product takes microseconds, less than the wrapper's host
        # time: it is timed by the card's kernel time (torch.profiler)
        decode = route == "decode"
        timed = ((lambda fn, iters: _device_ms(fn, iters)) if decode else
                 (lambda fn, iters: cuda_ms(fn, iters=iters)))
        iters = 50 if decode else 10
        site = {"site": name, "shape": [m, k, n], "dtype": "bfloat16", "route": route,
                "calls_per_capture_batch": per_batch, "calls_per_decode_step": per_step,
                "max_abs_err": max_abs,
                "ms": timed(lambda: qm.quant_matmul(x, w["q"], w["s"]), iters),
                "timed_by": "torch.profiler kernel time" if decode else "CUDA events"}
        if route in ("sm90", "decode"):
            site["max_abs_err_mma"] = _qmm_check(qm, x, w, f"{name} (mma)", kernel="mma")
            site["ms_mma"] = timed(lambda: qm.quant_matmul(x, w["q"], w["s"], _kernel="mma"),
                                   iters)
        else:
            site["max_abs_err_mma"], site["ms_mma"] = max_abs, site["ms"]
        if decode:
            site["split"] = list(qm._decode_split(k, n, sm_count(device.index or 0)))
            site["bitwise_repeat"] = _qmm_repeat(qm, x, w, name)
            site["ms_events"] = cuda_ms(lambda: qm.quant_matmul(x, w["q"], w["s"]), iters=50)
        site["plain_ms"] = timed(lambda: qm.quant_matmul_plain(x, w["q"], w["s"]), 3)
        site["library_ms"] = timed(lambda: torch.matmul(x, dense), iters)
        site["bound_ms"], site["bound_by"] = qmm_bound(m, k, n, 2)
        site["share_of_bound"] = _share(site["bound_ms"], site["ms"])
        site["achieved_tflops"] = 2.0 * m * n * k / (site["ms"] * 1e-3) / 1e12
        site["achieved_weight_gb_per_s"] = k * n / (site["ms"] * 1e-3) / 1e9
        emit({"phase": "kernel_case", "kernel": "qmm", **site})
        sites.append(site)
        if name in QMM_GRAD_SITES:
            grads.append(_qmm_grad_check(qm, x, w, name))
        del x, w, dense
        torch.cuda.empty_cache()
    if [g["route"] for g in grads] != ["sm90", "decode"]:
        raise AssertionError(f"qmm grad: routes {[g['route'] for g in grads]}, expected one "
                             "site on qmm_sm90.cu and one on qmm_decode_sm90.cu")
    emit({"phase": "kernel_qmm_grad", "sites": grads,
          "tolerance": f"{QMM_GRAD_TOL} (1 + |plain|)"})
    errs = [s["max_abs_err"] for s in sites] + [r["max_abs_err"] for r in ragged]
    errs_mma = [s["max_abs_err_mma"] for s in sites] + [r["max_abs_err_mma"] for r in ragged]
    return {"sites": sites, "ragged": ragged, "grad": grads,
            "max_abs_err": max(*errs, *f32_errs), "max_abs_err_mma": max(*errs_mma, *f32_errs)}


def scale_cloud(n: int = SCALE_N):
    """bench_scale.py:36-40: n points on a 3-sphere embedded in 4096-d
    (seed 42), and the generator, which then picks the threshold's rows."""
    import numpy as np
    rng = np.random.default_rng(42)
    z = rng.normal(size=(n, 4))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    proj = rng.normal(size=(4, SCALE_D)) / np.sqrt(4)
    x = (z @ proj + rng.normal(0, 1e-3, (n, SCALE_D))).astype(np.float32)
    return x, rng


def sqdist_bound(n, d):
    """(ms, 'operations' | 'bytes') of sqdist_sm90.cu's work: the
    symmetric half, n (n + 1) / 2 pairs of 2 d flops, in three TF32
    passes; x read once, the [n, n] output written once."""
    t_ops = 3 * 2.0 * d * n * (n + 1) / 2 / TF32_PEAK
    t_bytes = (4.0 * n * d + 4.0 * n * n) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sqdist_f32_bound(n, d):
    """(ms, 'operations' | 'bytes') of sqdist.cu's work: the full 2 n^2 d
    product in f32 FMA on the CUDA cores; the same bytes."""
    t_ops = 2.0 * n * n * d / F32_PEAK
    t_bytes = (4.0 * n * d + 4.0 * n * n) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _sqdist_counts(sqdist) -> tuple:
    return sqdist.LAUNCHES, sqdist.LAUNCHES_SM90, sqdist.SPLIT_LAUNCHES


def _sqdist_check(sqdist, x, label, kernel=None):
    """One kernel (the routed one, or ``kernel``) against the plain
    version: the bound, exact symmetry, and the counters moving as the
    choice says.  Returns (output, max |kernel - plain|, max error over
    the scale, the kernel)."""
    import torch
    picked = sqdist._pick(x, kernel)
    before = _sqdist_counts(sqdist)
    got = sqdist.pairwise_sq_euclidean_cuda(x, _kernel=kernel)
    want = sqdist.pairwise_sq_euclidean_plain(x)
    torch.cuda.synchronize()
    sm90 = int(picked == "sm90")
    if _sqdist_counts(sqdist) != (before[0] + 1, before[1] + sm90, before[2] + sm90):
        raise AssertionError(f"sqdist {label} ({picked}): counters {before} -> "
                             f"{_sqdist_counts(sqdist)}")
    sq = (x.double() ** 2).sum(1)
    err = (got.double() - want.double()).abs()
    ratio = float((err / (sq[:, None] + sq[None, :]).clamp_min(1e-30)).max())
    max_abs = float(err.max())
    del err, want
    if got.shape != (x.shape[0], x.shape[0]) or got.dtype != torch.float32:
        raise AssertionError(f"sqdist {label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all() or not (got >= 0).all():
        raise AssertionError(f"sqdist {label} ({picked}): non-finite or negative output")
    if ratio > SQDIST_REL_TOL:
        raise AssertionError(f"sqdist {label} ({picked}): |kernel - plain| / (|x_i|^2 + "
                             f"|x_j|^2) = {ratio:.3e} exceeds {SQDIST_REL_TOL}")
    if not torch.equal(got, got.T):
        raise AssertionError(f"sqdist {label} ({picked}): output is not exactly symmetric")
    return got, max_abs, ratio, picked


def _split_check(sqdist, x, label):
    """The split pass against tf32_split_plain: hi and lo bitwise, the
    norms within 1e-6 relative (f32 sums in other orders)."""
    import torch
    hi, lo, sq = sqdist.tf32_split_cuda(x)
    p_hi, p_lo, p_sq = sqdist.tf32_split_plain(x)
    torch.cuda.synchronize()
    if not (torch.equal(hi.view(torch.int32), p_hi.view(torch.int32))
            and torch.equal(lo.view(torch.int32), p_lo.view(torch.int32))):
        raise AssertionError(f"sqdist split {label}: hi/lo differ from tf32_split_plain")
    sq_err = float(((sq - p_sq).abs() / p_sq.abs().clamp_min(1e-30)).max())
    if sq_err > 1e-6:
        raise AssertionError(f"sqdist split {label}: norms differ by {sq_err:.3e} relative")
    return sq_err


def _sqdist_vs_f64(x, got) -> float:
    """max |got - exact| / (|x_i|^2 + |x_j|^2), exact the expansion form
    of x in f64."""
    x64 = x.double()
    sq64 = (x64 ** 2).sum(1)
    scale = sq64[:, None] + sq64[None, :]
    exact = (scale - 2.0 * (x64 @ x64.T)).clamp_min_(0.0)
    return float((got.double() - exact).abs_().div_(scale).max())


def _sqdist_any_layout(sqdist, gen, device) -> dict:
    """SQDIST_ANY_LAYOUT's view through the route: sqdist_sm90.cu (one
    split, one product), bitwise the result on its contiguous copy,
    within SQDIST_REL_TOL of f64; both kernels against the plain version
    and the split pass against its plain version."""
    import torch
    n, d, ld, offset = SQDIST_ANY_LAYOUT
    base = torch.randn(n * ld + offset, generator=gen, device=device)
    x = base[offset:].view(n, ld)[:, :d]
    if sqdist._route(x) != "sm90" or x.data_ptr() % 16 == 0:
        raise AssertionError(f"sqdist any layout: routed to {sqdist._route(x)}, base "
                             f"{x.data_ptr() % 16} past 16 bytes")
    before = _sqdist_counts(sqdist)
    got = sqdist.sqdist(x)
    if _sqdist_counts(sqdist) != (before[0] + 1, before[1] + 1, before[2] + 1):
        raise AssertionError(f"sqdist any layout: counters {before} -> "
                             f"{_sqdist_counts(sqdist)}")
    bitwise = bool(torch.equal(got, sqdist.sqdist(x.contiguous())))
    vs_f64 = _sqdist_vs_f64(x, got)
    del got
    if not bitwise or not vs_f64 <= SQDIST_REL_TOL:
        raise AssertionError(f"sqdist any layout: bitwise the contiguous copy's {bitwise}, "
                             f"{vs_f64:.3e} of f64 (limit {SQDIST_REL_TOL})")
    case = {"shape": [n, d], "stride": ld, "offset_floats": offset, "route": "sm90",
            "bitwise_contiguous_copy": bitwise, "max_err_over_scale_vs_f64": vs_f64}
    for kernel in ("fma", "sm90"):
        _, max_abs, ratio, _ = _sqdist_check(sqdist, x, "any layout", kernel)
        case[f"max_abs_err_{kernel}"] = max_abs
        case[f"max_err_over_scale_{kernel}"] = ratio
    case["split_sq_rel_err"] = _split_check(sqdist, x, "any layout")
    return case


def phase_sqdist() -> dict:
    """Both sqdist kernels against the plain version, on the card; the
    split pass bitwise against its plain version; times at the scale
    path's shape."""
    import torch
    import tdax_torch.ops.sqdist as sqdist
    from tdax_torch.runtime import get_device

    device = get_device()
    gen = torch.Generator(device=device).manual_seed(4321)
    cases = []
    inputs = [((n, d), torch.randn((n, d), generator=gen, device=device))
              for n, d in SQDIST_SHAPES]
    # a view with a row stride of 4104 (a multiple of 4) and a 16-byte base
    wide = torch.randn((300, 4104), generator=gen, device=device)
    inputs.append(("strided [300, 4096] of [300, 4104]", wide[:, 4:4100]))
    for label, x in inputs:
        case = {"shape": list(x.shape), "stride": x.stride(0), "route": sqdist._route(x)}
        for kernel in ("fma", "sm90"):
            _, max_abs, ratio, _ = _sqdist_check(sqdist, x, f"{label}", kernel)
            case[f"max_abs_err_{kernel}"] = max_abs
            case[f"max_err_over_scale_{kernel}"] = ratio
        case["split_sq_rel_err"] = _split_check(sqdist, x, f"{label}")
        cases.append(case)
    del inputs, wide
    cases.append(_sqdist_any_layout(sqdist, gen, device))
    emit({"phase": "kernel_sqdist_cases", "cases": cases, "tolerance": SQDIST_REL_TOL})

    x_np, _ = scale_cloud()
    x = torch.as_tensor(x_np, device=device)
    if sqdist._route(x) != "sm90":
        raise AssertionError(f"sqdist: the scale path's x routes to {sqdist._route(x)}")
    got, max_abs, ratio, _ = _sqdist_check(sqdist, x, "scale path")
    again = sqdist.sqdist(x)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("sqdist scale path: two sm90 runs differ")
    del again
    # each kernel's and the plain version's error against the same
    # expansion form in f64 (reported, not gated)
    vs_f64 = {"sm90": _sqdist_vs_f64(x, got)}
    del got
    fma_out, max_abs_fma, ratio_fma, _ = _sqdist_check(sqdist, x, "scale path", "fma")
    vs_f64["fma"] = _sqdist_vs_f64(x, fma_out)
    del fma_out
    vs_f64["plain"] = _sqdist_vs_f64(x, sqdist.pairwise_sq_euclidean_plain(x))
    split_err = _split_check(sqdist, x, "scale path")
    torch.cuda.empty_cache()
    hi, lo, sq = sqdist.tf32_split_cuda(x)
    ms = cuda_ms(lambda: sqdist.sqdist(x), iters=10)
    kernel_ms = cuda_ms(lambda: sqdist.sm90_product(hi, lo, sq), iters=10)
    split_ms = cuda_ms(lambda: sqdist.tf32_split_cuda(x), iters=10)
    ms_fma = cuda_ms(lambda: sqdist.pairwise_sq_euclidean_cuda(x, _kernel="fma"), iters=10)
    plain_ms = cuda_ms(lambda: sqdist.pairwise_sq_euclidean_plain(x), iters=5)
    euclid_ms = cuda_ms(lambda: sqdist.euclidean(x), iters=10)
    library_ms = cuda_ms(lambda: torch.cdist(x, x, compute_mode="use_mm_for_euclid_dist"),
                         iters=10)
    del hi, lo, sq
    bound_ms, bound_by = sqdist_bound(SCALE_N, SCALE_D)
    f32_bound_ms, _ = sqdist_f32_bound(SCALE_N, SCALE_D)
    site = {"site": "scale", "shape": [SCALE_N, SCALE_D], "dtype": "float32", "route": "sm90",
            "max_abs_err": max_abs, "max_err_over_scale": ratio,
            "max_abs_err_fma": max_abs_fma, "max_err_over_scale_fma": ratio_fma,
            "max_err_over_scale_vs_f64": vs_f64,
            "split_sq_rel_err": split_err, "ms": ms, "kernel_ms": kernel_ms,
            "split_ms": split_ms, "ms_fma": ms_fma, "plain_ms": plain_ms,
            "euclid_ms": euclid_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "kernel_bound_share": bound_ms / kernel_ms,
            "f32_full_product_bound_ms": f32_bound_ms,
            "fma_f32_bound_share": f32_bound_ms / ms_fma,
            "achieved_tflops": 3 * 2.0 * SCALE_D * SCALE_N * (SCALE_N + 1) / 2
            / (kernel_ms * 1e-3) / 1e12}
    emit({"phase": "kernel_case", **site})
    torch.cuda.empty_cache()
    errs = [max_abs, max_abs_fma] + [v for c in cases for k, v in c.items()
                                     if k.startswith("max_abs_err")]
    return {"site": site, "max_abs_err": max(errs)}


def make_clouds(seed: int = 42):
    """bench.py:31-43: 32 x 36 x 4096 synthetic activation clouds with
    shape-clustered structure at layer 25, and their labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shapes = [f"s{i}" for i in range(6)]
    colors = [f"c{i}" for i in range(6)]
    shape_labels = [shapes[i // 6] for i in range(36)]
    color_labels = [colors[i % 6] for i in range(36)]
    clouds = rng.normal(size=(32, 36, 4096))
    centers = rng.normal(size=(6, 4096)) * 3
    for j in range(36):
        clouds[25, j] = centers[j // 6] + rng.normal(0, 0.5, 4096)
    return clouds, shape_labels, color_labels


def profile_device(fn) -> dict:
    """Wall time of fn() (synchronised host clock) and, from one more run
    under torch.profiler, the device's busy time, kernel count and idle
    share; the device time by kind (qmm, flash, GEMMs, other) and the top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n_kernels = sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
    kinds = _device_time_by_kind(prof)
    busy_ms = kinds.pop("busy_ms")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "device_ops": n_kernels,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms > 0 else "not measured", **kinds}


def synthetic_capture(root: Path):
    """make_clouds() in the capture's nested-dict schema, with a
    metadata.json beside it, so that run_tda_sweep reads it as it reads
    a capture (sample ids sort in the clouds' order)."""
    clouds, shape_labels, color_labels = make_clouds()
    metadata = [{"id": f"synthetic_{j:02d}", "type": "bound", "shape": s, "color": c}
                for j, (s, c) in enumerate(zip(shape_labels, color_labels))]
    root.mkdir(parents=True, exist_ok=True)
    (root / "metadata.json").write_text(json.dumps(metadata))
    all_data = {m["id"]: {"metadata": m, "activations": {f"layer_{i}": clouds[i, j]
                                                         for i in range(clouds.shape[0])}}
                for j, m in enumerate(metadata)}
    labels = {"shape": shape_labels, "color": color_labels}
    return all_data, str(root / "metadata.json"), clouds, labels


def _check_stats(stats, n_layers, label):
    import numpy as np
    if len(stats) != n_layers:
        raise AssertionError(f"{label}: {len(stats)} stats entries, expected {n_layers}")
    for s in stats:
        if list(s) != STATS_KEYS:
            raise AssertionError(f"{label}: stats keys {list(s)} are not tdax's {STATS_KEYS}")
        values = [v for k, v in s.items() if k != "all_h1_persistence_values"]
        values += s["all_h1_persistence_values"]
        if not np.isfinite(np.asarray(values, dtype=np.float64)).all():
            raise AssertionError(f"{label}: non-finite stats at layer {s['layer']}")


def _check_sweep(result, n_layers, label):
    import numpy as np
    _check_stats(result["stats"], n_layers, label)
    if not np.isfinite(result["clouds_3d"]).all():
        raise AssertionError(f"{label}: non-finite embedding")


def phase_sweep(tmp: Path, smi: str) -> dict:
    """The port's run_tda_sweep on its own capture, then on bench.py's
    synthetic clouds on the card and on the CPU."""
    import importlib.util

    from tdax_torch.config import SweepConfig
    from tdax_torch.data.io import load_activations
    from tdax_torch.pipeline.tda_sweep import embed_and_silhouettes, peak, run_tda_sweep

    rendered = importlib.util.find_spec("matplotlib") is not None
    if not rendered:
        print("chip_smoke: matplotlib is not installed on this machine: the sweep ran with "
              "save_diagrams off, so its PNGs were not rendered on the card", flush=True)
    data_dir = tmp / "data"
    t0 = time.perf_counter()
    all_data = load_activations(str(data_dir / "all_activations.npz"))
    load_s = time.perf_counter() - t0
    out_dir = tmp / "tda_debug_output"
    cfg = SweepConfig(output_dir=str(out_dir), save_diagrams=rendered)
    t0 = time.perf_counter()
    result = run_tda_sweep(all_data, str(data_dir / "metadata.json"), cfg, verbose=False)
    sweep_s = time.perf_counter() - t0
    stats, peak_layer = result["stats"], result["peak_layer"]
    _check_sweep(result, 32, "capture sweep")
    if rendered:
        n_png = len(list((out_dir / "diagrams").glob("*.png")))
        if n_png != 32 or not (out_dir / "summary_evolution_plot.png").exists():
            raise AssertionError(f"sweep wrote {n_png} diagram PNGs and no evolution plot")
    written = json.loads((out_dir / "summary_stats.json").read_text())
    if not 0 <= peak_layer < 32 or written != stats:
        raise AssertionError(f"capture sweep: peak layer {peak_layer} / summary_stats.json "
                             f"differs from the returned stats")
    info = {"phase": "sweep", "nvidia_smi": smi, "clouds": [32, 36, 4096],
            "load_s": load_s, "sweep_s": sweep_s, "png_rendered": rendered,
            "peak_layer": peak_layer, "peak_rule": cfg.peak_rule,
            "peak_silhouette_shape": stats[peak_layer]["silhouette_shape"],
            "timings": result["timings"]}

    # bench.py's synthetic clouds: the card twice (first and steady state),
    # then the CPU
    all_data, meta_path, clouds, labels = synthetic_capture(tmp / "synthetic")
    runs = {}
    for dev, repeats in (("cuda", 2), ("cpu", 1)):
        for _ in range(repeats):
            res = run_tda_sweep(all_data, meta_path,
                                SweepConfig(output_dir=str(tmp / f"synthetic_{dev}"),
                                            save_diagrams=False),
                                verbose=False, device=dev)
            _check_sweep(res, 32, f"synthetic sweep on {dev}")
            runs.setdefault(dev, []).append(res)
    card, cpu = runs["cuda"][0]["stats"], runs["cpu"][0]["stats"]
    info["synthetic_embed_profile"] = profile_device(
        lambda: embed_and_silhouettes(clouds, SweepConfig(), labels))
    peaks = {dev: peak(r[0]["stats"], "shape_silhouette") for dev, r in runs.items()}
    sil_err = max(abs(a[k] - b[k]) for a, b in zip(card, cpu)
                  for k in ("silhouette_shape", "silhouette_color"))
    h1_err = max(abs(a["max_h1_persistence"] - b["max_h1_persistence"])
                 for a, b in zip(card, cpu))
    info.update({"synthetic_peak_card": peaks["cuda"], "synthetic_peak_cpu": peaks["cpu"],
                 "synthetic_peak_silhouette": card[25]["silhouette_shape"],
                 "card_vs_cpu_max_silhouette_diff": sil_err,
                 "card_vs_cpu_max_h1_diff": h1_err,
                 "tolerances": [SWEEP_SIL_TOL, SWEEP_H1_TOL],
                 "synthetic_card_first": runs["cuda"][0]["timings"],
                 "synthetic_card_again": runs["cuda"][1]["timings"],
                 "synthetic_cpu": runs["cpu"][0]["timings"],
                 "mean_max_h1": [sum(s["max_h1_persistence"] for s in st) / len(st)
                                 for st in (card, cpu)]})
    emit(info)
    if peaks["cuda"] != 25 or peaks["cpu"] != 25:
        raise AssertionError(f"synthetic sweep: shape-silhouette peak {peaks}, expected 25")
    if sil_err > SWEEP_SIL_TOL or h1_err > SWEEP_H1_TOL:
        raise AssertionError(f"synthetic sweep: card vs CPU silhouettes {sil_err:.4f} "
                             f"(limit {SWEEP_SIL_TOL}), max H1 {h1_err:.4f} "
                             f"(limit {SWEEP_H1_TOL})")
    return info


def _diagram_gaps(got: list, want: list) -> tuple:
    """Per cloud and dimension: (bar counts equal everywhere, the largest
    bottleneck distance)."""
    from tdax_torch.metrics.persistence import bottleneck_distance
    same = all(len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b))
               for a, b in zip(got, want))
    gap = max(bottleneck_distance(x, y) for a, b in zip(got, want) for x, y in zip(a, b))
    return same, gap


def phase_ph_backends(tmp: Path, smi: str) -> dict:
    """The fallback Rips backends on the capture sweep's [32, 36, 3] clouds:
    rips_tiny_batched on the card at maxdim 1 and 2 (tdax's chunks) and on
    the CPU (maxdim 1, and PH_CPU_H2_CLOUDS clouds at maxdim 2) against the
    native engine's thread pool, timed; run_tda_sweep with
    RipsConfig(backend="device") on make_clouds; the python oracle against
    the native engine, and maxdim 4 through the oracle."""
    import numpy as np
    import torch
    from tdax_torch.config import RipsConfig, SweepConfig
    from tdax_torch.ops.rips import native, rips
    from tdax_torch.ops.rips import tiny_device as tt
    from tdax_torch.pipeline.tda_sweep import peak, persistence_per_layer, run_tda_sweep

    t_phase = time.perf_counter()
    cloud_dir = tmp / "tda_debug_output" / "point_clouds_3d"
    clouds = np.stack([np.load(cloud_dir / f"layer_{i}_cloud.npy") for i in range(32)])
    kernels_before = _kernel_counters()
    info = {"phase": "ph_backends", "nvidia_smi": smi, "clouds": list(clouds.shape)}
    native_dgms = {}
    for md in (1, 2):
        t0 = time.perf_counter()
        native_dgms[md] = persistence_per_layer(clouds, maxdim=md)
        info[f"native_pool_maxdim{md}_s"] = time.perf_counter() - t0

    card = {}
    for md, label in ((1, "h1_first"), (1, "h1"), (2, "h2")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card[md] = tt.rips_tiny_batched(clouds, maxdim=md)
        info[f"card_{label}"] = {"wall_s": time.perf_counter() - t0, **tt.LAST_RUN}
        same, gap = _diagram_gaps(card[md], native_dgms[md])
        info[f"card_{label}"].update(bar_counts_equal_native=same, bottleneck_vs_native=gap)
        if not same or gap > TINY_PH_TOL:
            raise AssertionError(f"rips_tiny_batched maxdim {md} on the card against the native "
                                 f"engine: bar counts equal {same}, bottleneck {gap:.3e}")

    cpu = {}
    for md, part in ((1, clouds), (2, clouds[:PH_CPU_H2_CLOUDS])):
        t0 = time.perf_counter()
        cpu[md] = tt.rips_tiny_batched(part, maxdim=md, device="cpu")
        info[f"cpu_maxdim{md}"] = {"wall_s": time.perf_counter() - t0, **tt.LAST_RUN}
        same, gap = _diagram_gaps(cpu[md], card[md][:len(part)])
        info[f"cpu_maxdim{md}"].update(bar_counts_equal_card=same, bottleneck_vs_card=gap)
        if not same or gap > TINY_PH_TOL:
            raise AssertionError(f"rips_tiny_batched maxdim {md}: CPU against the card: bar "
                                 f"counts equal {same}, bottleneck {gap:.3e}")

    # the sweep with the device batch, beside the native engine's, on the card
    all_data, meta_path, _, _ = synthetic_capture(tmp / "synthetic_ph")
    sweeps = {}
    for backend in ("auto", "device"):
        t0 = time.perf_counter()
        res = run_tda_sweep(all_data, meta_path,
                            SweepConfig(output_dir=str(tmp / f"synthetic_ph_{backend}"),
                                        save_diagrams=False, rips=RipsConfig(backend=backend)),
                            verbose=False)
        _check_sweep(res, 32, f"synthetic sweep, backend {backend}")
        sweeps[backend] = res
        info[f"sweep_{backend}"] = {"wall_s": time.perf_counter() - t0, **res["timings"]}
    dev_peak = peak(sweeps["device"]["stats"], "shape_silhouette")
    h1_gap = max(abs(a["max_h1_persistence"] - b["max_h1_persistence"])
                 for a, b in zip(sweeps["device"]["stats"], sweeps["auto"]["stats"]))
    info.update(sweep_device_peak=dev_peak, sweep_device_vs_auto_max_h1_diff=h1_gap,
                sweep_clouds_bitwise_equal=bool(np.array_equal(sweeps["device"]["clouds_3d"],
                                                               sweeps["auto"]["clouds_3d"])))
    if dev_peak != 25 or h1_gap > SWEEP_H1_TOL:
        raise AssertionError(f"device-backend sweep: peak {dev_peak} (expected 25), max-H1 "
                             f"against the auto sweep {h1_gap:.4f} (limit {SWEEP_H1_TOL})")

    # the python oracle against the native engine, and past maxdim 3
    t0 = time.perf_counter()
    oracle = [rips(c.astype(np.float64), maxdim=1, backend="python")["dgms"] for c in clouds[:4]]
    info["oracle_4_clouds_s"] = time.perf_counter() - t0
    engine = [rips(c.astype(np.float64), maxdim=1, backend="native")["dgms"] for c in clouds[:4]]
    same, gap = _diagram_gaps(oracle, engine)
    info.update(oracle_bar_counts_equal_native=same, oracle_bottleneck_vs_native=gap)
    if not same or gap > ORACLE_TOL:
        raise AssertionError(f"oracle against the native engine: bar counts equal {same}, "
                             f"bottleneck {gap:.3e}")
    nine = np.random.default_rng(9).normal(size=(9, 3))
    real_native = native.rips_native

    def refuse(*args, **kwargs):
        raise AssertionError("the native engine was called at maxdim 4")
    native.rips_native = refuse
    try:
        high = rips(nine, maxdim=4)["dgms"]
    finally:
        native.rips_native = real_native
    want = rips(nine, maxdim=4, backend="python")["dgms"]
    if len(high) != 5 or not all(np.array_equal(a, b) for a, b in zip(high, want)):
        raise AssertionError("rips at maxdim 4 did not give the oracle's five diagrams")
    info["maxdim4_bars"] = [len(d) for d in high]
    if _kernel_counters() != kernels_before:
        raise AssertionError("ph_backends moved a kernel counter: no kernel of the port is on "
                             "this path")
    info["phase_s"] = time.perf_counter() - t_phase
    emit(info)
    return info


def _geometry_metrics():
    from tdax_torch.metrics import geometry as geo
    return {"effective_dimensionality": geo.compute_effective_dimensionality,
            "fixed_window_ed": lambda x: geo.compute_fixed_window_ed(x, GEOMETRY_WINDOWS),
            "intrinsic_dimensionality": geo.compute_intrinsic_dimensionality,
            "fixed_window_id": lambda x: geo.compute_fixed_window_id(x, GEOMETRY_WINDOWS),
            "matrix_entropy_alpha1": lambda x: geo.matrix_entropy(x, 1.0),
            "matrix_entropy_alpha2": lambda x: geo.matrix_entropy(x, 2.0)}


def _geometry_on_card_and_cpu(x_cpu, label) -> list:
    """Each geometry metric on the card (CUDA events, one warm-up) and on
    the CPU (host clock) on the same f32 values; the card within
    GEOMETRY_RTOL of the CPU, NaN in the same places."""
    import numpy as np
    import torch

    x_card = x_cpu.to("cuda")
    rows = []
    for name, fn in _geometry_metrics().items():
        card = fn(x_card).cpu().numpy()
        ms = cuda_ms(lambda: fn(x_card), iters=3, warmup=1)
        t0 = time.perf_counter()
        cpu = fn(x_cpu).numpy()
        cpu_s = time.perf_counter() - t0
        nan_card, nan_cpu = np.isnan(card), np.isnan(cpu)
        both = ~nan_card & ~nan_cpu
        rel = float(np.max(np.abs(card[both] - cpu[both]) / np.maximum(np.abs(cpu[both]), 1e-30),
                           initial=0.0))
        row = {"metric": name, "input": label, "shape": list(x_cpu.shape),
               "out_shape": list(card.shape), "ms": ms, "cpu_s": cpu_s,
               "max_rel_err": rel, "tolerance": GEOMETRY_RTOL[name],
               "nan": int(nan_card.sum()), "value_range": [float(np.nanmin(card)),
                                                           float(np.nanmax(card))]
               if not nan_card.all() else None}
        rows.append(row)
        if (nan_card != nan_cpu).any() or rel > GEOMETRY_RTOL[name]:
            emit({"phase": "report_geometry_failed", **row})
            raise AssertionError(f"{name} on {label}: card vs CPU {rel:.3e} (limit "
                                 f"{GEOMETRY_RTOL[name]}), NaN at {nan_card.sum()} / "
                                 f"{nan_cpu.sum()} places")
        torch.cuda.empty_cache()
    return rows


def _html_traces(path: Path) -> list:
    text = path.read_text()
    if re.search(r"""src\s*=\s*["']?https?:""", text, re.IGNORECASE):
        raise AssertionError(f"{path.name} loads a script from the network")
    match = re.search(r"var traces = (.*);\n", text)
    if match is None:
        raise AssertionError(f"{path.name} holds no traces")
    return json.loads(match.group(1))


def phase_report(tmp: Path, smi: str, sweep: dict, capture_flash_sm90: int) -> dict:
    """The reference's remaining surface on the capture and the sweep
    that phase_sweep left in tmp: the peak layer's 3-D HTML, the legacy
    sweep (one shared reducer, peak by max H1) on the card and the CPU,
    the geometry metrics on the card and the CPU at two sizes, and the
    Wasserstein distance between the peak layer's H1 diagram and its
    neighbour's."""
    import numpy as np
    import torch

    from tdax_torch.data.io import activations_to_layer_clouds, load_activations
    from tdax_torch.metrics import wasserstein_distance
    from tdax_torch.ops.rips import rips
    from tdax_torch.pipeline.report import legacy_sweep_config, visualize_peak_layer
    from tdax_torch.pipeline.tda_sweep import run_tda_sweep

    data_dir, out_dir = tmp / "data", tmp / "tda_debug_output"
    meta_path = str(data_dir / "metadata.json")
    peak = sweep["peak_layer"]
    info = {"phase": "report", "nvidia_smi": smi, "peak_layer": peak,
            "capture_flash_launches_sm90": capture_flash_sm90}

    # the peak layer's two HTML files (no PNG: the card's machine has no matplotlib)
    t0 = time.perf_counter()
    paths = visualize_peak_layer(peak, str(out_dir), meta_path, png_fallback=False)
    info["html_s"] = time.perf_counter() - t0
    metadata = json.loads(Path(meta_path).read_text())
    ids = sorted(m["id"] for m in metadata if m["type"] == "bound")
    cloud = np.load(out_dir / "point_clouds_3d" / f"layer_{peak}_cloud.npy").astype(float)
    info["html_bytes"] = []
    for path in map(Path, paths):
        points = {}
        for trace in _html_traces(path):
            for k, sid in enumerate(trace["text"]):
                if sid in points:
                    raise AssertionError(f"{path.name}: {sid} twice")
                points[sid] = (trace["x"][k], trace["y"][k], trace["z"][k])
        if sorted(points) != ids or len(ids) != 36:
            raise AssertionError(f"{path.name}: {len(points)} points, expected the 36 bound ids")
        if any(points[sid] != tuple(cloud[j]) for j, sid in enumerate(ids)):
            raise AssertionError(f"{path.name}: coordinates differ from the .npy cloud")
        info["html_bytes"].append(path.stat().st_size)

    # the legacy sweep on the card, then on the CPU
    all_data = load_activations(str(data_dir / "all_activations.npz"))
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg = legacy_sweep_config(all_data, output_dir=str(tmp / f"tda_legacy_{dev}"))
        t0 = time.perf_counter()
        res = run_tda_sweep(all_data, meta_path, cfg, verbose=False, device=dev)
        info[f"legacy_{dev}_s"] = time.perf_counter() - t0
        _check_sweep(res, 32, f"legacy sweep on {dev}")
        h1 = [s["max_h1_persistence"] for s in res["stats"]]
        if res["peak_layer"] != int(np.argmax(h1)):
            raise AssertionError(f"legacy sweep on {dev}: peak {res['peak_layer']} is not the "
                                 f"max-H1 layer {int(np.argmax(h1))}")
        info[f"legacy_{dev}_timings"] = res["timings"]
        runs[dev] = res
    card, cpu = runs["cuda"]["stats"], runs["cpu"]["stats"]
    peaks = {dev: runs[dev]["peak_layer"] for dev in runs}
    sil_err = max(abs(a[k] - b[k]) for a, b in zip(card, cpu)
                  for k in ("silhouette_shape", "silhouette_color"))
    h1 = {dev: np.array([s["max_h1_persistence"] for s in runs[dev]["stats"]]) for dev in runs}
    h1_gap = np.abs(h1["cuda"] - h1["cpu"])
    # what the CPU alone moves when the inputs move by LEGACY_MOVE relative
    rng = np.random.default_rng(0)
    spread = np.zeros(len(cpu))
    for _ in range(LEGACY_MOVES):
        moved = {sid: {"metadata": e["metadata"],
                       "activations": {k: v * (1 + LEGACY_MOVE * rng.standard_normal(v.shape))
                                       for k, v in e["activations"].items()}}
                 for sid, e in all_data.items()}
        res = run_tda_sweep(moved, meta_path,
                            legacy_sweep_config(moved, output_dir=str(tmp / "tda_legacy_moved")),
                            verbose=False, device="cpu")
        if res["peak_layer"] != peaks["cpu"]:
            raise AssertionError(f"legacy sweep on the CPU: peak {res['peak_layer']} with the "
                                 f"inputs moved by {LEGACY_MOVE}, {peaks['cpu']} without")
        spread = np.maximum(spread, np.abs([s["max_h1_persistence"] for s in res["stats"]]
                                           - h1["cpu"]))
    h1_over = [i for i in range(len(cpu)) if h1_gap[i] > SWEEP_H1_TOL + spread[i]]
    info.update({"legacy_n_neighbors": legacy_sweep_config(all_data).umap.n_neighbors,
                 "legacy_peak_card": peaks["cuda"],
                 "legacy_peak_cpu": peaks["cpu"],
                 "legacy_card_vs_cpu_max_silhouette_diff": sil_err,
                 "legacy_card_vs_cpu_max_h1_diff": float(h1_gap.max()),
                 "legacy_card_vs_cpu_max_h1_diff_layer": int(h1_gap.argmax()),
                 "legacy_max_h1": {dev: h1[dev].tolist() for dev in runs},
                 "legacy_cpu_max_h1_spread": spread.tolist(),
                 "legacy_cpu_max_h1_spread_max": float(spread.max()),
                 "legacy_h1_over_limit_layers": h1_over,
                 "tolerances": [SWEEP_SIL_TOL, SWEEP_H1_TOL],
                 "legacy_move": [LEGACY_MOVE, LEGACY_MOVES]})

    # Wasserstein between the card sweep's peak H1 diagram and its
    # neighbour's: host code, so the diagrams computed again on the CPU
    # from the saved clouds give the same distances exactly
    lp = peaks["cuda"]
    nb = lp + 1 if lp + 1 < 32 else lp - 1
    legacy_clouds = tmp / "tda_legacy_cuda" / "point_clouds_3d"
    again = [rips(np.load(legacy_clouds / f"layer_{i}_cloud.npy").astype(np.float64),
                  maxdim=1)["dgms"][1] for i in (lp, nb)]
    dg = runs["cuda"]["diagrams"]
    w = {}
    for order in (1.0, 2.0):
        got = wasserstein_distance(dg[lp][1], dg[nb][1], order)
        want = wasserstein_distance(again[0], again[1], order)
        if got != want or not np.isfinite(got):
            raise AssertionError(f"wasserstein order {order}: {got} from the sweep's diagrams, "
                                 f"{want} from the same clouds on the CPU")
        w[f"order_{order:g}"] = got
    info["wasserstein_h1"] = {"layers": [lp, nb], "bars": [len(dg[lp][1]), len(dg[nb][1])], **w}
    del runs, all_data
    gc.collect()

    # the geometry metrics: the capture's bound clouds, then a seeded
    # cloud at the decoder's width
    clouds, _ = activations_to_layer_clouds(load_activations(str(data_dir /
                                                                 "all_activations.npz")), 32)
    gen = torch.Generator().manual_seed(0)
    info["geometry"] = (
        _geometry_on_card_and_cpu(torch.as_tensor(clouds, dtype=torch.float32), "capture")
        + _geometry_on_card_and_cpu(torch.randn(GEOMETRY_LARGE, generator=gen), "seeded"))
    emit(info)
    if sil_err > SWEEP_SIL_TOL or h1_over or peaks["cuda"] != peaks["cpu"]:
        raise AssertionError(f"legacy sweep: card vs CPU silhouettes {sil_err:.4f} "
                             f"(limit {SWEEP_SIL_TOL}), max H1 over {SWEEP_H1_TOL} + the CPU's "
                             f"own spread at layers {h1_over}, peaks {peaks}")
    return info


def snapshot_config():
    """QwenVLConfig()'s widths at SNAPSHOT_LAYERS decoder layers and ViT blocks."""
    import dataclasses

    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    full = QwenVLConfig()
    return dataclasses.replace(full, num_layers=SNAPSHOT_LAYERS,
                               visual=dataclasses.replace(full.visual, layers=SNAPSHOT_LAYERS))


def hf_state(cfg, device, seed: int = 0) -> dict:
    """A Qwen-VL-Chat state dict with the checkpoint's names, bf16, on
    ``device``, with the values of tests/test_model.py::random_hf_state and
    tests/test_checkpoint_convert.py::random_hf_visual_state: N(0, 0.05)
    weights and biases, 1 + N(0, 0.01) norm weights, N(0, 0.01) norm
    biases, N(0, 0.02) positions and queries, and the query-grid sincos
    table as attn_pool.pos_embed; drawn in f32 from a torch.Generator on
    ``device`` seeded with ``seed``."""
    import torch
    from tdax_torch.models.qwen_vl.vit import sincos_2d

    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, s=0.05):
        return (torch.randn(shape, generator=gen, device=device) * s).to(torch.bfloat16)

    def norm(n):
        return 1 + r(n, s=0.01).float()

    def ln(prefix, n):
        return {prefix + "weight": norm(n).to(torch.bfloat16), prefix + "bias": r(n, s=0.01)}

    h, f2 = cfg.hidden_size, cfg.ff_half
    state = {"transformer.wte.weight": r(cfg.vocab_size, h),
             "transformer.ln_f.weight": norm(h).to(torch.bfloat16),
             "lm_head.weight": r(cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        state.update({p + "ln_1.weight": norm(h).to(torch.bfloat16),
                      p + "ln_2.weight": norm(h).to(torch.bfloat16),
                      p + "attn.c_attn.weight": r(3 * h, h), p + "attn.c_attn.bias": r(3 * h),
                      p + "attn.c_proj.weight": r(h, h),
                      p + "mlp.w1.weight": r(f2, h), p + "mlp.w2.weight": r(f2, h),
                      p + "mlp.c_proj.weight": r(h, f2)})
    v = cfg.visual
    w, d = v.width, v.output_dim
    pv = "transformer.visual."
    state.update({pv + "conv1.weight": r(w, 3, v.patch_size, v.patch_size),
                  pv + "positional_embedding": r(v.n_patches, w, s=0.02),
                  **ln(pv + "ln_pre.", w), **ln(pv + "ln_post.", d),
                  pv + "proj": r(d, d)})
    for i in range(v.layers):
        pb = f"{pv}transformer.resblocks.{i}."
        state.update({**ln(pb + "ln_1.", w), **ln(pb + "ln_2.", w),
                      pb + "attn.in_proj_weight": r(3 * w, w),
                      pb + "attn.in_proj_bias": r(3 * w),
                      pb + "attn.out_proj.weight": r(w, w), pb + "attn.out_proj.bias": r(w),
                      pb + "mlp.c_fc.weight": r(v.mlp_dim, w), pb + "mlp.c_fc.bias": r(v.mlp_dim),
                      pb + "mlp.c_proj.weight": r(w, v.mlp_dim), pb + "mlp.c_proj.bias": r(w)})
    rp = pv + "attn_pool."
    q_pos = sincos_2d(math.isqrt(v.n_queries), d)
    state.update({rp + "query": r(v.n_queries, d, s=0.02),
                  rp + "pos_embed": torch.from_numpy(q_pos).to(device, torch.bfloat16),
                  rp + "kv_proj.weight": r(d, w), **ln(rp + "ln_q.", d), **ln(rp + "ln_kv.", d),
                  rp + "attn.in_proj_weight": r(3 * d, d), rp + "attn.in_proj_bias": r(3 * d),
                  rp + "attn.out_proj.weight": r(d, d), rp + "attn.out_proj.bias": r(d)})
    return state


def write_bin_snapshot(state: dict, out_dir: Path,
                       shard_bytes: int = SNAPSHOT_SHARD_BYTES) -> int:
    """``state`` in the layout of the snapshot the reference downloads:
    ``pytorch_model-0000k-of-0000N.bin`` shards of at most about
    ``shard_bytes`` (a tensor is never split), in the state's key order,
    and ``pytorch_model.bin.index.json``.  Each shard is copied to the
    host alone.  Returns the bytes written."""
    import torch

    shards, size = [[]], 0
    for key, t in state.items():
        nbytes = t.numel() * t.element_size()
        if shards[-1] and size + nbytes > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(key)
        size += nbytes
    out_dir.mkdir(parents=True, exist_ok=True)
    weight_map, total = {}, 0
    for k, keys in enumerate(shards):
        name = f"pytorch_model-{k + 1:05d}-of-{len(shards):05d}.bin"
        torch.save({key: state[key].cpu() for key in keys}, out_dir / name)
        weight_map.update(dict.fromkeys(keys, name))
        total += (out_dir / name).stat().st_size
    (out_dir / "pytorch_model.bin.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def _rss() -> int:
    """The process's resident set now (VmRSS of /proc/self/status), bytes."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class PeakRSS:
    """The largest resident set seen while the block runs: VmRSS sampled
    every ``period`` seconds by a thread (the process's lifetime peak,
    getrusage's ru_maxrss, cannot be reset to time one stage)."""

    def __init__(self, period: float = 0.002):
        import threading
        self.period, self.peak, self._stop = period, 0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, _rss())
            self._stop.wait(self.period)

    def __enter__(self):
        self.before = self.peak = _rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, _rss())


def _tree_diff(got: dict, want: dict, path: str = "") -> list:
    """Paths of the leaves of two parameter trees that differ in keys,
    dtype, shape or any bit."""
    import torch
    if list(got) != list(want):
        return [f"{path}: keys {list(got)} against {list(want)}"]
    bad = []
    for k, leaf in want.items():
        if isinstance(leaf, dict):
            bad += _tree_diff(got[k], leaf, f"{path}.{k}")
        elif got[k].dtype != leaf.dtype or not torch.equal(got[k], leaf):
            bad.append(f"{path}.{k}")
    return bad


def _stack(results, metadata, n_layers):
    import numpy as np
    return np.stack([np.stack([results[m["id"]]["activations"][f"layer_{i}"] for m in metadata])
                     for i in range(n_layers)])


def _cosines(ref, got) -> dict:
    """Cosine of each captured vector [L, n, H] against its reference:
    the minimum, the median, and the minimum at each layer."""
    import numpy as np
    ref, got = ref.astype(np.float64), got.astype(np.float64)
    cos = (ref * got).sum(-1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(got, axis=-1))
    return {"min": float(cos.min()), "median": float(np.median(cos)),
            "min_by_layer": cos.min(axis=1).tolist()}


def qmm_per_capture_batch(cfg) -> int:
    """The int8 products of one capture batch: 4 per ViT block and 5 per
    decoder layer (mlp w1 and w2 apart), the patch embedding, the
    resampler's five and the visual projection."""
    return 4 * cfg.visual.layers + 5 * cfg.num_layers + 7


def _checkpoint_writes(batches, save_interval: int) -> int:
    """The .tmp.npz writes of a capture: one whenever save_interval
    samples have accumulated, at batch granularity."""
    writes = since = 0
    for n in batches:
        since += n
        if since >= save_interval:
            writes, since = writes + 1, 0
    return writes


def capture_timed(metadata, out_path: str, cfg, ecfg, params=None):
    """extract_activations on the card with each batch's forward timed by
    CUDA events and each file write by the host clock (the extract
    module's functions wrapped for the run), launch counters set to 0
    just before and read just after.  Returns (results, record)."""
    import statistics

    import torch
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    import tdax_torch.pipeline.extract as ex

    names = ("extract_layer_activations", "save_activations_npz", "save_activations")
    orig = {n: getattr(ex, n) for n in names}
    events = []
    writes = {"tmp_npz_s": 0.0, "tmp_npz_writes": 0, "npz_s": 0.0, "pt_s": 0.0}

    def forward(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig["extract_layer_activations"](*args, **kw)
        end.record()
        events.append((start, end))
        return out

    def npz(path, *args):
        t0 = time.perf_counter()
        orig["save_activations_npz"](path, *args)
        key = "tmp_npz" if path.endswith(".tmp.npz") else "npz"
        writes[f"{key}_s"] += time.perf_counter() - t0
        writes["tmp_npz_writes"] += key == "tmp_npz"

    def pt(*args):
        t0 = time.perf_counter()
        orig["save_activations"](*args)
        writes["pt_s"] += time.perf_counter() - t0

    ex.extract_layer_activations, ex.save_activations_npz, ex.save_activations = forward, npz, pt
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.LAUNCHES_SM90 = qm.LAUNCHES = qm.LAUNCHES_SM90 = 0
    try:
        t0 = time.perf_counter()
        results = ex.extract_activations(metadata, out_path, cfg, ecfg, params=params,
                                         device="cuda", verbose=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(ex, n, orig[n])
    launches = {"flash_fwd": fa.LAUNCHES, "flash_fwd_sm90": fa.LAUNCHES_SM90,
                "qmm": qm.LAUNCHES, "qmm_sm90": qm.LAUNCHES_SM90}
    forward_ms = [start.elapsed_time(end) for start, end in events]
    record = {"wall_s": wall_s, "batches": len(events), "forward_s": sum(forward_ms) / 1e3,
              "forward_ms_median": statistics.median(forward_ms), **writes,
              "writes_s": writes["tmp_npz_s"] + writes["npz_s"] + writes["pt_s"],
              "launches": launches, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    record["rest_s"] = wall_s - record["forward_s"] - record["writes_s"]
    return results, record


def phase_checkpoint(tmp: Path, smi: str):
    """An HF-named state at the full widths (SNAPSHOT_LAYERS deep) written
    as the reference snapshot's .bin shards, loaded back through
    load_qwen_checkpoint and captured from through extract_activations
    (bf16 and int8); returns its record and what the adversarial phase
    reuses."""
    import resource

    import torch
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl.convert import convert_hf_state_dict, load_qwen_checkpoint
    from tdax_torch.models.qwen_vl.quantize import quantize_params
    from tdax_torch.models.qwen_vl.tokenizer import get_tokenizer

    cfg = snapshot_config()
    data_dir = tmp / "snapshot_data"
    metadata = generate_dataset(DatasetConfig(data_dir=str(data_dir)))
    snap = tmp / "snapshot"

    t0 = time.perf_counter()
    state = hf_state(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in state.values())
    t0 = time.perf_counter()
    snapshot_bytes = write_bin_snapshot(state, snap)
    write_s = time.perf_counter() - t0
    n_shards = len(list(snap.glob("pytorch_model-*.bin")))

    gc.collect()
    torch.cuda.synchronize()
    with PeakRSS() as rss:
        t0 = time.perf_counter()
        loaded = load_qwen_checkpoint(str(snap), cfg, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    ru_maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    in_memory = convert_hf_state_dict(state, cfg, "cuda")
    tree_diff = _tree_diff(loaded, in_memory)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    sites = cfg.visual.layers + 1 + cfg.num_layers
    n_batches = math.ceil(len(metadata) / 16)
    ecfg = ExtractConfig(model_dir=str(snap), batch_size=16)
    results, bf16 = capture_timed(metadata, str(data_dir / "all_activations.pt"), cfg, ecfg)
    acts, _ = _check_capture(str(data_dir / "all_activations.pt"), metadata, results,
                             "snapshot capture", cfg.num_layers, cfg.hidden_size)
    mem = capture_timed(metadata, str(data_dir / "in_memory.pt"), cfg,
                        ExtractConfig(model_dir=None, batch_size=16), params=in_memory)[0]
    bitwise = bool((acts == _stack(mem, metadata, cfg.num_layers)).all())
    # bf16 shards: the weights as read are the bf16 tree's, so quantizing
    # as read equals quantize_params of the in-memory tree
    in_memory_int8 = quantize_params(in_memory)
    del in_memory, mem
    torch.cuda.empty_cache()

    ecfg8 = ExtractConfig(model_dir=str(snap), batch_size=16, quantize_int8=True)
    results8, int8 = capture_timed(metadata, str(data_dir / "int8.pt"), cfg, ecfg8)
    acts8, _ = _check_capture(str(data_dir / "int8.pt"), metadata, results8,
                              "snapshot int8 capture", cfg.num_layers, cfg.hidden_size)
    mem8 = capture_timed(metadata, str(data_dir / "in_memory_int8.pt"), cfg,
                         ExtractConfig(model_dir=None, batch_size=16, quantize_int8=True),
                         params=in_memory_int8)[0]
    bitwise8 = bool((acts8 == _stack(mem8, metadata, cfg.num_layers)).all())
    del in_memory_int8, mem8
    torch.cuda.empty_cache()
    cosine = _cosines(acts, acts8)

    expected = {"flash_fwd": n_batches * sites, "flash_fwd_sm90": n_batches * sites,
                "qmm": 0, "qmm_sm90": 0}
    expected8 = {**expected, "qmm": n_batches * qmm_per_capture_batch(cfg),
                 "qmm_sm90": n_batches * (qmm_per_capture_batch(cfg) - 1)}
    info = {"phase": "checkpoint", "nvidia_smi": smi,
            "config": {"hidden": cfg.hidden_size, "ff": cfg.intermediate_size,
                       "vocab": cfg.vocab_size, "vit_width": cfg.visual.width,
                       "vit_mlp": cfg.visual.mlp_dim, "resampler": [cfg.visual.n_queries,
                                                                    cfg.visual.output_dim]},
            "cut": f"depth: {cfg.num_layers} of 32 decoder layers, {cfg.visual.layers} of 48 "
                   "ViT blocks; widths those of QwenVLConfig()",
            "params": n_params, "layout": "pytorch_model-*.bin + index, bf16",
            "shards": n_shards, "snapshot_bytes": snapshot_bytes, "draw_s": draw_s,
            "write_s": write_s, "write_GB_per_s": snapshot_bytes / write_s / 1e9,
            "load_s": load_s, "load_GB_per_s": snapshot_bytes / load_s / 1e9,
            "rss_before_load_bytes": rss.before, "peak_rss_during_load_bytes": rss.peak,
            "peak_rss_above_before_bytes": rss.peak - rss.before,
            "ru_maxrss_bytes": ru_maxrss, "largest_shard_bytes": max(
                f.stat().st_size for f in snap.glob("pytorch_model-*.bin")),
            "loaded_tree_bitwise_equal_in_memory": not tree_diff, "tree_diff": tree_diff[:5],
            "tokenizer": type(get_tokenizer(str(snap), cfg)).__name__,
            "capture_shape": list(acts.shape), "capture_bitwise_equal_in_memory": bitwise,
            "capture": bf16, "expected_launches": expected,
            "int8_capture": int8, "expected_launches_int8": expected8,
            "int8_capture_bitwise_equal_in_memory_quantized": bitwise8,
            "int8_cosine_vs_bf16": cosine}
    emit(info)
    if tree_diff:
        raise AssertionError(f"checkpoint: loaded leaves differ from the in-memory conversion: "
                             f"{tree_diff[:5]}")
    if not bitwise:
        raise AssertionError("checkpoint: the capture from the snapshot differs from the "
                             "capture from the in-memory tree")
    if bf16["launches"] != expected or int8["launches"] != expected8:
        raise AssertionError(f"checkpoint captures launched {bf16['launches']} and "
                             f"{int8['launches']}, expected {expected} and {expected8}")
    if not bitwise8:
        raise AssertionError("checkpoint int8 capture: the capture from the snapshot differs "
                             "from the capture from quantize_params of the in-memory tree")
    return info, {"cfg": cfg, "params": loaded, "snapshot": str(snap), "data_dir": data_dir,
                  "base_metadata": metadata}


def adversarial_clouds(metadata, seed: int, n_layers: int = SNAPSHOT_LAYERS) -> dict:
    """Structured synthetic activations of the adversarial samples in the
    capture's nested-dict schema: N(0, 1) vectors of width 4096 at every
    layer but ADV_CLUSTERED_LAYER, where each sample's vector is the
    centre of its image shape (N(0, 1) x 3) plus N(0, 0.5) noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shapes = sorted({m["img_shape"] for m in metadata})
    clouds = rng.normal(size=(n_layers, len(metadata), 4096))
    centers = rng.normal(size=(len(shapes), 4096)) * 3
    for j, m in enumerate(metadata):
        clouds[ADV_CLUSTERED_LAYER, j] = (centers[shapes.index(m["img_shape"])]
                                          + rng.normal(0, 0.5, 4096))
    return {m["id"]: {"metadata": m, "activations": {f"layer_{i}": clouds[i, j]
                                                     for i in range(n_layers)}}
            for j, m in enumerate(metadata)}


def _check_adversarial_summary(summary, out_dir: Path, n_layers: int, label: str) -> None:
    """summary.json and the artifact tree in tdax's schema, every stat finite."""
    import numpy as np
    written = json.loads((out_dir / "summary.json").read_text())
    if list(written) != ["condition_stats", "n_samples_per_condition"] or written != summary:
        raise AssertionError(f"{label}: summary.json keys {list(written)} are not tdax's, or "
                             "it differs from the returned summary")
    counts = written["n_samples_per_condition"]
    if counts != ADV_COUNTS or list(counts) != list(ADV_COUNTS):
        raise AssertionError(f"{label}: n_samples_per_condition {counts}, expected {ADV_COUNTS}")
    for condition, stats in written["condition_stats"].items():
        if len(stats) != n_layers or any(list(s) != ADV_STATS_KEYS for s in stats):
            raise AssertionError(f"{label}: {condition} stats are not tdax's "
                                 f"{n_layers} x {ADV_STATS_KEYS}")
        if not np.isfinite([[v for v in s.values()] for s in stats]).all():
            raise AssertionError(f"{label}: non-finite stats for {condition}")
        if json.loads((out_dir / condition / "layer_stats.json").read_text()) != stats:
            raise AssertionError(f"{label}: {condition}/layer_stats.json differs")
        if len(list((out_dir / condition / "point_clouds").glob("*.npy"))) != n_layers:
            raise AssertionError(f"{label}: {condition}/point_clouds is incomplete")


def phase_adversarial(tmp: Path, smi: str, ckpt: dict, seed: int) -> dict:
    """The adversarial workflow on the snapshot's weights: the 720 pairs,
    their capture through the checkpointing path, the 4-condition sweep
    of it on the card, then the sweep of structured synthetic clouds of
    the same samples on the card and on the CPU."""
    import importlib.util

    from tdax_torch.config import DatasetConfig, ExtractConfig, SweepConfig
    from tdax_torch.data.adversarial import condition_counts, generate_adversarial_metadata
    from tdax_torch.data.io import load_activations
    from tdax_torch.pipeline.adversarial import run_adversarial_sweep

    cfg = ckpt["cfg"]
    ds = DatasetConfig(data_dir=str(ckpt["data_dir"]))
    metadata = generate_adversarial_metadata(ckpt["base_metadata"], ds, save=True)
    counts = condition_counts(metadata)
    if counts != ADV_COUNTS or len(metadata) != 720:
        raise AssertionError(f"adversarial metadata: {len(metadata)} samples, {counts}")

    ecfg = ExtractConfig(model_dir=ckpt["snapshot"], batch_size=16,
                         save_interval=ADV_SMOKE_SAVE_INTERVAL)
    out_path = ds.adversarial_activations_path
    results, capture = capture_timed(metadata, out_path, cfg, ecfg, params=ckpt["params"])
    _check_capture(out_path, metadata, results, "adversarial capture", cfg.num_layers,
                   cfg.hidden_size)
    batches = [min(16, len(metadata) - s) for s in range(0, len(metadata), 16)]
    sites = cfg.visual.layers + 1 + cfg.num_layers
    expected = {"flash_fwd": len(batches) * sites, "flash_fwd_sm90": len(batches) * sites,
                "qmm": 0, "qmm_sm90": 0}
    expected_writes = _checkpoint_writes(batches, ADV_SMOKE_SAVE_INTERVAL)

    rendered = importlib.util.find_spec("matplotlib") is not None
    out_dir = tmp / "tda_adversarial_output"
    t0 = time.perf_counter()
    all_data = load_activations(out_path.replace(".pt", ".npz"))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = run_adversarial_sweep(all_data, str(out_dir), SweepConfig(save_diagrams=rendered),
                                    verbose=False)
    sweep_s = time.perf_counter() - t0
    _check_adversarial_summary(summary, out_dir, cfg.num_layers, "adversarial sweep")
    if rendered and not (out_dir / "comparison" / "all_conditions_comparison.png").exists():
        raise AssertionError("adversarial sweep: no comparison figure with diagrams on")

    synthetic = adversarial_clouds(metadata, seed)
    runs, walls = {}, {}
    for dev in ("cuda", "cpu"):
        out = tmp / f"adversarial_synthetic_{dev}"
        t0 = time.perf_counter()
        runs[dev] = run_adversarial_sweep(synthetic, str(out), SweepConfig(save_diagrams=False),
                                          verbose=False, device=dev)
        walls[dev] = time.perf_counter() - t0
        _check_adversarial_summary(runs[dev], out, SNAPSHOT_LAYERS, f"synthetic sweep on {dev}")
    peaks, gaps = {}, {}
    for condition in ADV_COUNTS:
        card, cpu = (runs[d]["condition_stats"][condition] for d in ("cuda", "cpu"))
        peaks[condition] = [max(range(len(st)), key=lambda i: st[i]["silhouette_img_shape"])
                            for st in (card, cpu)]
        gaps[condition] = {
            "silhouette_by_layer": [max(abs(a[k] - b[k]) for k in ADV_STATS_KEYS[4:])
                                    for a, b in zip(card, cpu)],
            "max_h1_by_layer": [abs(a["max_h1_persistence"] - b["max_h1_persistence"])
                                for a, b in zip(card, cpu)],
            "clustered_silhouette_img_shape": [st[ADV_CLUSTERED_LAYER]["silhouette_img_shape"]
                                               for st in (card, cpu)]}
    others = [i for i in range(SNAPSHOT_LAYERS) if i != ADV_CLUSTERED_LAYER]
    sil_gap = max(g["silhouette_by_layer"][i] for g in gaps.values() for i in others)
    h1_gap = max(g["max_h1_by_layer"][i] for g in gaps.values() for i in others)
    clustered_gap = max(g["silhouette_by_layer"][ADV_CLUSTERED_LAYER] for g in gaps.values())
    info = {"phase": "adversarial", "nvidia_smi": smi, "samples": len(metadata),
            "conditions": counts, "capture": capture, "expected_launches": expected,
            "expected_tmp_npz_writes": expected_writes, "capture_shape": [
                cfg.num_layers, len(metadata), cfg.hidden_size],
            "sweep_load_s": load_s, "sweep_s": sweep_s, "png_rendered": rendered,
            "synthetic_clustered_layer": ADV_CLUSTERED_LAYER,
            "synthetic_peak_layer_card_cpu": peaks, "card_vs_cpu_gaps": gaps,
            "card_vs_cpu_max_silhouette_diff": sil_gap, "card_vs_cpu_max_h1_diff": h1_gap,
            "tolerances": [SWEEP_SIL_TOL, SWEEP_H1_TOL],
            "card_vs_cpu_clustered_silhouette_diff": clustered_gap,
            "clustered_tolerance": ADV_CLUSTERED_SIL_TOL,
            "synthetic_sweep_s": walls}
    emit(info)
    if capture["launches"] != expected or capture["tmp_npz_writes"] != expected_writes:
        raise AssertionError(f"adversarial capture launched {capture['launches']} and wrote "
                             f"{capture['tmp_npz_writes']} checkpoints, expected {expected} "
                             f"and {expected_writes}")
    if any(p != [ADV_CLUSTERED_LAYER] * 2 for p in peaks.values()):
        raise AssertionError(f"synthetic adversarial sweep: img_shape silhouette peaks "
                             f"{peaks}, expected layer {ADV_CLUSTERED_LAYER} on card and CPU")
    if (sil_gap > SWEEP_SIL_TOL or h1_gap > SWEEP_H1_TOL
            or clustered_gap > ADV_CLUSTERED_SIL_TOL):
        raise AssertionError(f"synthetic adversarial sweep: card vs CPU silhouettes "
                             f"{sil_gap:.4f} (limit {SWEEP_SIL_TOL}), max H1 {h1_gap:.4f} "
                             f"(limit {SWEEP_H1_TOL}) off the clustered layer; its "
                             f"silhouettes {clustered_gap:.4f} (limit {ADV_CLUSTERED_SIL_TOL})")
    return info


def phase_adversarial_full_depth(smi: str) -> dict:
    """The adversarial capture at the full QwenVLConfig() (bf16, random
    weights drawn on the card from seed 0, save_interval 50), its wall
    split into the forward and the file writes.  Not part of the smoke
    run; measured alone:

        python3 -c 'import chip_smoke as c; c.import_port();
                    c.phase_adversarial_full_depth(c.nvidia_smi())'
    """
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.adversarial import generate_adversarial_metadata
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params

    cfg = QwenVLConfig()
    with tempfile.TemporaryDirectory(prefix="tdax_torch_adversarial_") as tmp:
        ds = DatasetConfig(data_dir=tmp)
        metadata = generate_adversarial_metadata(generate_dataset(ds), ds, save=False)
        params = init_params(cfg, "cuda", seed=0)
        ecfg = ExtractConfig(model_dir=None, batch_size=16, save_interval=ADV_SAVE_INTERVAL)
        results, capture = capture_timed(metadata, ds.adversarial_activations_path, cfg, ecfg,
                                         params=params)
        _check_capture(ds.adversarial_activations_path, metadata, results,
                       "full-depth adversarial capture")
    sites = cfg.visual.layers + 1 + cfg.num_layers
    info = {"phase": "adversarial_full_depth", "nvidia_smi": smi, "samples": len(metadata),
            "capture_shape": [cfg.num_layers, len(metadata), cfg.hidden_size],
            "capture": capture, "expected_flash_launches": math.ceil(len(metadata) / 16) * sites}
    emit(info)
    if capture["launches"]["flash_fwd_sm90"] != info["expected_flash_launches"]:
        raise AssertionError(f"full-depth adversarial capture launches {capture['launches']}")
    return info


def _distance_parts(sqdist, x) -> dict:
    """distance_matrix's stages one by one on x (CUDA events; the copy to
    the host on the host clock): the kernel (split pass and product as
    routed), the square root and zeroed diagonal, tdax's exact
    symmetrising (d + d^T) / 2, and the copy to the host."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    d = sqdist.sqdist(x)
    ev[1].record()
    d.sqrt_().fill_diagonal_(0.0)
    ev[2].record()
    d = (d + d.T).mul_(0.5)
    ev[3].record()
    ev[3].synchronize()
    t0 = time.perf_counter()
    d.cpu()
    to_host_s = time.perf_counter() - t0
    return {"kernel_ms": ev[0].elapsed_time(ev[1]), "sqrt_diag_ms": ev[1].elapsed_time(ev[2]),
            "symmetrise_ms": ev[2].elapsed_time(ev[3]), "to_host_ms": 1e3 * to_host_s}


def _h0_deaths_delta(sqdist, x, thresh, dgm0) -> dict:
    """Boruvka's H0 deaths from sqdist.cu's matrix (the same stages as
    distance_matrix, the kernel forced) against those rips_at_scale gave
    through sqdist_sm90.cu: reported, not gated."""
    import numpy as np
    from tdax_torch.ops.rips.mst import h0_diagram_device
    d = sqdist.pairwise_sq_euclidean_cuda(x, _kernel="fma").sqrt_().fill_diagonal_(0.0)
    d = (d + d.T).mul_(0.5)
    fma0 = h0_diagram_device(d, thresh)
    del d
    a = np.sort(dgm0[np.isfinite(dgm0[:, 1]), 1])
    b = np.sort(fma0[np.isfinite(fma0[:, 1]), 1])
    info = {"finite_deaths": [int(len(a)), int(len(b))]}
    if len(a) == len(b) and len(a):
        info["max_abs_delta"] = float(np.abs(a - b).max())
        info["max_rel_delta"] = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
    return info


def phase_scale(smi: str) -> dict:
    """rips_at_scale at 10000 x 4096 on the card, and a small cloud against the CPU."""
    import numpy as np
    import torch
    import tdax_torch.ops.sqdist as sqdist
    from tdax_torch.metrics.persistence import bottleneck_distance
    from tdax_torch.ops.rips import rips_from_distances
    from tdax_torch.pipeline.scale import distance_matrix, rips_at_scale

    x_np, rng = scale_cloud()
    t0 = time.perf_counter()
    x = torch.as_tensor(x_np).to("cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    # the threshold as bench_scale.py:132-135 picks it: the median over 512
    # rows of each row's 40th-smallest distance (rounded to f32, the
    # precision both Boruvka and the f32 engine compare in)
    t0 = time.perf_counter()
    host = distance_matrix(x).cpu().numpy()
    sample = rng.choice(SCALE_N, size=min(512, SCALE_N), replace=False)
    kth = np.partition(host[sample], SCALE_DEGREE, axis=1)[:, SCALE_DEGREE]
    thresh = float(np.float32(np.median(kth)))
    thresh_s = time.perf_counter() - t0

    sqdist.LAUNCHES = sqdist.LAUNCHES_SM90 = sqdist.SPLIT_LAUNCHES = 0
    t0 = time.perf_counter()
    out = rips_at_scale(x, maxdim=SCALE_MAXDIM, thresh=thresh)
    wall_s = time.perf_counter() - t0
    launches = {"sqdist": sqdist.LAUNCHES, "sqdist_sm90": sqdist.LAUNCHES_SM90,
                "split": sqdist.SPLIT_LAUNCHES}
    if launches != {"sqdist": 1, "sqdist_sm90": 1, "split": 1}:
        raise AssertionError(f"rips_at_scale launched the sqdist kernels {launches}, expected "
                             f"one launch of sqdist_sm90.cu (and its split pass)")
    parts = _distance_parts(sqdist, x)
    h0_delta = _h0_deaths_delta(sqdist, x, thresh, out["dgms"][0])

    profile = profile_device(lambda: rips_at_scale(x, maxdim=SCALE_MAXDIM, thresh=thresh))

    # Boruvka's H0 against the engine's dim-0 bars on the same matrix
    engine0 = rips_from_distances(host, maxdim=0, thresh=thresh)["dgms"][0]
    mst0 = out["dgms"][0]
    same = (np.array_equal(np.sort(mst0[np.isfinite(mst0[:, 1]), 1]),
                           np.sort(engine0[np.isfinite(engine0[:, 1]), 1]))
            and np.isinf(mst0[:, 1]).sum() == np.isinf(engine0[:, 1]).sum())
    if not same:
        raise AssertionError("Boruvka H0 differs from the engine's dim-0 bars")
    bars = [int(len(g)) for g in out["dgms"]]
    if len(bars) != SCALE_MAXDIM + 1 or not all(np.isfinite(g[:, 0]).all() for g in out["dgms"]):
        raise AssertionError(f"rips_at_scale: diagrams {bars}")

    # a small cloud: the card's diagrams against the CPU's
    small_rng = np.random.default_rng(5)  # tests/test_scale_ops.py:78-95
    small = np.concatenate([small_rng.normal(0, 0.5, (30, 8)),
                            small_rng.normal(4, 0.5, (30, 8))]).astype(np.float32)
    card = rips_at_scale(torch.as_tensor(small).to("cuda"), maxdim=1, thresh=2.5)["dgms"]
    cpu = rips_at_scale(small, maxdim=1, thresh=2.5, device="cpu")["dgms"]
    small_bn = [bottleneck_distance(a, b) for a, b in zip(card, cpu)]
    # the same recipe at 2 x 80 points, past SM90_MIN_N: through the main
    # path's kernel, sqdist_sm90.cu
    wide_rng = np.random.default_rng(5)
    wide = np.concatenate([wide_rng.normal(0, 0.5, (80, 8)),
                           wide_rng.normal(4, 0.5, (80, 8))]).astype(np.float32)
    before = sqdist.LAUNCHES_SM90
    card = rips_at_scale(torch.as_tensor(wide).to("cuda"), maxdim=1, thresh=2.5)["dgms"]
    if sqdist.LAUNCHES_SM90 != before + 1:
        raise AssertionError("the 160-point cloud did not go through sqdist_sm90.cu")
    cpu = rips_at_scale(wide, maxdim=1, thresh=2.5, device="cpu")["dgms"]
    wide_bn = [bottleneck_distance(a, b) for a, b in zip(card, cpu)]
    info = {"phase": "scale", "nvidia_smi": smi, "n": SCALE_N, "dim": SCALE_D,
            "maxdim": SCALE_MAXDIM, "target_degree": SCALE_DEGREE, "thresh": thresh,
            "launches": launches, "bars": bars,
            "h0_equals_engine": True, "distance_parts_ms": parts,
            "h0_deaths_sm90_vs_fma": h0_delta,
            "upload_s": upload_s, "thresh_select_s": thresh_s, "rips_at_scale_s": wall_s,
            "timings": out["timings"], "profile": profile,
            "small_cloud_bottleneck_card_vs_cpu": small_bn,
            "sm90_cloud_bottleneck_card_vs_cpu": wide_bn}
    emit(info)
    if max(small_bn) > SMALL_BOTTLENECK_TOL:
        raise AssertionError(f"small cloud: card vs CPU bottleneck {small_bn}")
    if max(wide_bn) > SMALL_BOTTLENECK_TOL:
        raise AssertionError(f"160-point cloud (sqdist_sm90.cu): card vs CPU bottleneck "
                             f"{wide_bn}")
    return info


def _check_csr(csr: dict, n: int, label: str) -> dict:
    """The CSR the engine got: indptr monotone from 0 to nnz, each row's
    columns ascending and unique with no self entry, (r, c) present iff
    (c, r) is, and their values bitwise equal."""
    import numpy as np
    indptr, indices, data = csr["indptr"], csr["indices"], csr["data"]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    same_row = rows[1:] == rows[:-1]
    key = rows * n + cols
    pos = np.minimum(np.searchsorted(key, cols * n + rows), len(key) - 1)
    checks = {
        "indptr_monotone": bool(indptr[0] == 0 and (np.diff(indptr) >= 0).all()
                                and indptr[-1] == len(indices) == len(data)),
        "rows_sorted_unique": bool((np.diff(cols)[same_row] > 0).all() and (rows != cols).all()),
        "symmetric": bool((key[pos] == cols * n + rows).all()),
        "values_bitwise_symmetric": bool(np.array_equal(data.view(np.uint32),
                                                        data[pos].view(np.uint32))),
        "finite_nonnegative": bool(np.isfinite(data).all() and (data >= 0).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"scale_sparse {label}: CSR invariants {checks}")
    return {**checks, "directed_entries": int(len(indices)),
            "added_by_union": int(csr["added_by_union"])}


def _sparse_run(x, label: str, **kwargs) -> tuple:
    """One rips_at_scale_sparse call with the sqdist counters set to 0
    just before it and read just after: (the result, its record)."""
    import numpy as np
    import tdax_torch.ops.sqdist as sqdist
    from tdax_torch.pipeline.scale import rips_at_scale_sparse
    sqdist.LAUNCHES = sqdist.LAUNCHES_SM90 = sqdist.SPLIT_LAUNCHES = 0
    t0 = time.perf_counter()
    out = rips_at_scale_sparse(x, _with_csr=True, **kwargs)
    wall = time.perf_counter() - t0
    launches = dict(zip(("sqdist", "sqdist_sm90", "split"), _sqdist_counts(sqdist)))
    if not all(np.isfinite(g[:, 0]).all() for g in out["dgms"]):
        raise AssertionError(f"scale_sparse {label}: non-finite births")
    return out, {"run": label, "wall_s": wall, "thresh": out["thresh"],
                 "n_edges": out["n_edges"], "bars": [int(len(g)) for g in out["dgms"]],
                 "essential": [int(np.isinf(g[:, 1]).sum()) for g in out["dgms"]],
                 "timings": out["timings"], "launches": launches}


def phase_scale_sparse(smi: str) -> dict:
    """rips_at_scale_sparse at BASELINE.json configs[4] (10000 x 4096, H2,
    degree 40) on both branches, gated against the dense engine on f64
    distances, and at 100000 x 4096, H1."""
    import numpy as np
    import torch
    from tdax_torch.metrics.persistence import bottleneck_distance
    from tdax_torch.ops.rips import rips_from_distances

    kwargs = {"maxdim": SCALE_MAXDIM, "target_degree": SCALE_DEGREE}
    x_np, _ = scale_cloud()
    # (a) the fused branch, three times as bench_scale.py:53-72
    runs, x_card = [], None
    for label in ("cold", "warm_host", "warm_device"):
        if label == "warm_device":
            x_card = torch.as_tensor(x_np).to("cuda")
            torch.cuda.synchronize()
        fused, rec = _sparse_run(x_card if x_card is not None else x_np, label, **kwargs)
        if rec["launches"] != {"sqdist": 1, "sqdist_sm90": 1, "split": 1}:
            raise AssertionError(f"scale_sparse fused {label}: sqdist counters {rec['launches']}, "
                                 f"expected one sqdist_sm90.cu launch and one split")
        runs.append(rec)
    first = runs[0]
    if any((r["thresh"], r["n_edges"], r["bars"]) != (first["thresh"], first["n_edges"],
                                                       first["bars"]) for r in runs):
        raise AssertionError(f"scale_sparse fused: the three runs differ {runs}")
    fused_csr = _check_csr(fused["_csr"], SCALE_N, "fused")
    profile = profile_device(lambda: _sparse_run(x_card, "profiled", **kwargs))

    # (b) the blocked branch on the same cloud: no sqdist kernel
    blocked, blocked_rec = _sparse_run(x_card, "blocked", fused_max=0,
                                       block_rows=SPARSE_BLOCK_ROWS, **kwargs)
    if any(blocked_rec["launches"].values()):
        raise AssertionError(f"scale_sparse blocked: sqdist counters {blocked_rec['launches']}")
    blocked_csr = _check_csr(blocked["_csr"], SCALE_N, "blocked")

    # (c) the cross-engine gate: the dense engine on f64 distances (f64
    # torch on the card, no sqdist kernel) at each branch's threshold
    t0 = time.perf_counter()
    x64 = x_card.double()
    sq = (x64 * x64).sum(1)
    d = (sq[:, None] + sq[None, :] - 2.0 * (x64 @ x64.T)).clamp_min_(0.0).sqrt_()
    d = (d + d.T).mul_(0.5).fill_diagonal_(0.0)
    dist64 = d.cpu().numpy()
    del d, x64
    f64_s = time.perf_counter() - t0
    gates, dense_by_thresh = {}, {}
    for name, out in (("fused", fused), ("blocked", blocked)):
        t0 = time.perf_counter()
        if out["thresh"] not in dense_by_thresh:
            dense_by_thresh[out["thresh"]] = rips_from_distances(
                dist64, maxdim=SCALE_MAXDIM, thresh=out["thresh"])["dgms"]
        dense = dense_by_thresh[out["thresh"]]
        engine_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bns = [bottleneck_distance(g, w) for g, w in zip(out["dgms"], dense)]
        gates[name] = {"bottleneck_per_dim": bns, "dense_engine_s": engine_s,
                       "bottleneck_s": time.perf_counter() - t0,
                       "dense_bars": [int(len(g)) for g in dense]}
    del dist64

    # (e) 100000 x 4096, H1, blocked (the default block rows), from the host
    t0 = time.perf_counter()
    x_large, _ = scale_cloud(SPARSE_LARGE_N)
    draw_s = time.perf_counter() - t0
    del x_card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    large, large_rec = _sparse_run(x_large, "large", maxdim=SPARSE_LARGE_MAXDIM,
                                   target_degree=SCALE_DEGREE)
    large_rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    large_rec["draw_s"] = draw_s
    if any(large_rec["launches"].values()):
        raise AssertionError(f"scale_sparse 100k: sqdist counters {large_rec['launches']}")
    large_csr = _check_csr(large["_csr"], SPARSE_LARGE_N, "100k")
    del large, x_large

    info = {"phase": "scale_sparse", "nvidia_smi": smi, "n": SCALE_N, "dim": SCALE_D,
            "maxdim": SCALE_MAXDIM, "target_degree": SCALE_DEGREE,
            "fused_runs": runs, "fused_csr": fused_csr, "fused_profile": profile,
            "blocked": blocked_rec, "blocked_csr": blocked_csr,
            "branches_n_edges_difference": blocked_rec["n_edges"] - first["n_edges"],
            "branches_thresh_difference": blocked_rec["thresh"] - first["thresh"],
            "f64_distances_s": f64_s, "cross_engine": gates,
            "large": {"n": SPARSE_LARGE_N, **large_rec, "csr": large_csr}}
    emit(info)
    for name, gate in gates.items():
        if not max(gate["bottleneck_per_dim"]) <= CROSS_ENGINE_TOL:
            raise AssertionError(f"scale_sparse {name}: cross-engine bottleneck "
                                 f"{gate['bottleneck_per_dim']} exceeds {CROSS_ENGINE_TOL}")
    return info


def umap_cloud(n: int, d: int = UMAP_D, seed: int = 42, n_new: int = 0):
    """bench_umap.py:27-37's make_cloud: 8 Gaussian clusters on a random
    16-d subspace embedded in d dims, and its labels; with n_new, also
    n_new fresh points of the same mixture (the same centres and
    projection, a second generator) and theirs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, 16)) * 4.0
    labels = rng.integers(0, 8, n)
    z = centers[labels] + rng.normal(size=(n, 16))
    proj = rng.normal(size=(16, d)) / 4.0
    x = (z @ proj).astype(np.float32)
    if not n_new:
        return x, labels
    rng2 = np.random.default_rng(seed + 1)
    labels_new = rng2.integers(0, 8, n_new)
    z_new = centers[labels_new] + rng2.normal(size=(n_new, 16))
    return x, labels, (z_new @ proj).astype(np.float32), labels_new


def _kernel_counters() -> dict:
    """Every launch counter of the port's kernels."""
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    import tdax_torch.ops.sqdist as sq
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
            for mod in (fa, qm, sq) for name in dir(mod)
            if name.endswith(("LAUNCHES", "LAUNCHES_SM90", "LAUNCHES_DECODE"))}


def _subsample_silhouette(emb, labels) -> float:
    """bench_umap.py:61-64: the port's silhouette on the card over a seeded subsample."""
    import numpy as np
    from tdax_torch.metrics.silhouette import silhouette_score
    sub = np.random.default_rng(0).choice(len(emb), min(len(emb), UMAP_SUBSAMPLE),
                                          replace=False)
    return silhouette_score(emb[sub], labels[sub])


def _umap_fit(x, labels, label: str) -> tuple:
    """One bench_umap.py fit (cosine, k 15, 3-d, random_state 42): (the
    reducer, its embedding, its record); fails on a non-finite embedding
    or a planted-cluster silhouette at or below UMAP_SIL_MIN."""
    import numpy as np
    import torch
    from tdax_torch.ops.umap import UMAP, sparse_path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reducer = UMAP(n_neighbors=UMAP_K, n_components=3, metric="cosine", random_state=42)
    emb = reducer.fit_transform(x)
    wall = time.perf_counter() - t0
    if emb.shape != (len(labels), 3) or not np.isfinite(emb).all():
        raise AssertionError(f"umap_sparse {label}: embedding {emb.shape}, finite "
                             f"{bool(np.isfinite(emb).all())}")
    sil = _subsample_silhouette(emb, labels)
    rec = {"run": label, "wall_s": wall, "timings": dict(sparse_path.LAST_TIMINGS),
           "silhouette_8clusters": sil,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if not sil > UMAP_SIL_MIN:
        raise AssertionError(f"umap_sparse {label}: planted clusters collapsed: "
                             f"{json.dumps(rec)}")
    return reducer, emb, rec


def _parity_cloud(spread: float):
    """3000 x 64 in 3 unit-variance clusters around N(0, spread^2) centres
    (spread 0.8: one connected kNN graph at k 15; 3.0: three components)."""
    import numpy as np
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(3, UMAP_PARITY_D)) * spread
    labels = np.repeat(np.arange(3), UMAP_PARITY_N // 3)
    x = centers[labels] + rng.normal(size=(UMAP_PARITY_N, UMAP_PARITY_D))
    return x.astype(np.float32), labels


def _nearest_centroid(emb, labels, points=None):
    """The label whose centroid in ``emb`` lies nearest each of ``points``
    (``emb`` itself by default)."""
    import numpy as np
    cents = np.stack([emb[labels == c].mean(0) for c in np.unique(labels)])
    pts = emb if points is None else points
    return np.argmin(np.linalg.norm(pts[:, None] - cents[None], axis=-1), 1)


def _umap_card_vs_cpu() -> dict:
    """The edge-list path at 3000 x 64 on the card and on the CPU, on the
    connected cloud: the kNN lists, the LOBPCG init from one start and one
    edge list, the 30-epoch layout from one edge list, init and set of
    negatives; the whole path from those draws (reported: the init's
    rounding, amplified by the epochs).  The full fit by invariants on
    the separated cloud.  Fails on a gap past its tolerance."""
    import numpy as np
    import torch
    from tdax_torch.metrics.silhouette import silhouette_score
    from tdax_torch.ops.umap import UMAP, fuzzy, sparse_path as sp
    from tdax_torch.ops.umap.umap import find_ab_params
    x, labels = _parity_cloud(UMAP_PARITY_SPREAD)
    x_fit, labels_fit = _parity_cloud(UMAP_FIT_SPREAD)
    n, k, epochs = UMAP_PARITY_N, UMAP_K, UMAP_PARITY_EPOCHS
    a, b = find_ab_params(1.0, 0.1)
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(n, 4)).astype(np.float32)
    negs = [rng.integers(0, n, (n, sp.NEG_POOL)) for _ in range(epochs)]
    knn, init, layout, whole, fit = {}, {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        idx, dists = sp.knn_blocked(torch.as_tensor(x).to(dev), k, "euclidean")
        sigma, rho = fuzzy.smooth_knn_dist(dists, float(k))
        w = fuzzy.membership_strengths_knn(idx, dists, sigma, rho)
        knn[dev] = (idx.cpu().numpy(), dists.cpu().numpy(),
                    sp.build_sym_edges(idx.cpu().numpy(), w.cpu().numpy()))
    edges = [torch.as_tensor(v) for v in knn["cpu"][2]]
    for dev in ("cuda", "cpu"):
        head, tail, wgt = edges[0].long().to(dev), edges[1].long().to(dev), edges[2].to(dev)
        emb, iters = sp.spectral_init_lobpcg(head, tail, wgt, n, 2, 42, _x0=x0)
        init[dev] = (emb.cpu().numpy(), iters)
    for dev in ("cuda", "cpu"):
        head, tail, wgt = edges[0].long().to(dev), edges[1].long().to(dev), edges[2].to(dev)
        layout[dev] = sp.optimize_layout_edges(
            torch.as_tensor(init["cpu"][0]).to(dev), head, tail, wgt, n, epochs, 42, a, b,
            _negatives=lambda e: negs[e]).cpu().numpy()
        whole[dev] = sp.embed_sparse(x, k, 2, "euclidean", epochs, 42, a, b, 1.0, 5, 1.0, 1.0,
                                     1.0, device=dev, _x0=x0, _negatives=lambda e: negs[e])
        t0 = time.perf_counter()
        emb = UMAP(random_state=42, device=dev).fit_transform(x_fit)
        fit[dev] = {"s": time.perf_counter() - t0, "timings": dict(sp.LAST_TIMINGS),
                    "silhouette": silhouette_score(emb, labels_fit, device=dev),
                    "clusters": _nearest_centroid(emb, labels_fit)}
    (ci, cd, ce), (gi, gd, ge) = knn["cuda"], knn["cpu"]
    x64 = x.astype(np.float64)
    sq = (x64 * x64).sum(1)
    srt = np.sort(np.sqrt(np.maximum(sq[:, None] + sq[None] - 2 * x64 @ x64.T, 0)), axis=1)
    clear = srt[:, k] - srt[:, k - 1] > 2 * 2e-3
    u, v = init["cuda"][0], init["cpu"][0]
    cos = np.abs((u * v).sum(0)) / (np.linalg.norm(u, axis=0) * np.linalg.norm(v, axis=0))
    gap = np.linalg.norm(layout["cuda"] - layout["cpu"], axis=1)
    signs = np.sign((whole["cuda"] * whole["cpu"]).sum(0))
    whole_gap = np.linalg.norm(whole["cuda"] - signs * whole["cpu"], axis=1)
    rec = {"shape": [n, UMAP_PARITY_D], "epochs": epochs,
           "knn_dist_max_gap": float(np.abs(cd - gd).max()),
           "knn_rows_equal_sets": float(np.mean([set(p) == set(q) for p, q in zip(ci, gi)])),
           "knn_clear_rows": int(clear.sum()),
           "knn_clear_rows_equal_sets": bool(all(set(ci[r]) == set(gi[r])
                                                 for r in np.flatnonzero(clear))),
           "edges_card_cpu": [len(ce[0]), len(ge[0])],
           "init_abs_cosine": cos.tolist(), "init_iterations": [init["cuda"][1],
                                                                init["cpu"][1]],
           "layout_gap_median": float(np.median(gap)),
           "layout_gap_p99": float(np.quantile(gap, 0.99)), "layout_gap_max": float(gap.max()),
           "whole_path_gap_median_sign_aligned": float(np.median(whole_gap)),
           "whole_path_gap_max_sign_aligned": float(whole_gap.max()),
           "fit_silhouette_card_cpu": [fit["cuda"]["silhouette"], fit["cpu"]["silhouette"]],
           "fit_cluster_accuracy_card_cpu": [float((fit[d]["clusters"] == labels_fit).mean())
                                             for d in ("cuda", "cpu")],
           "fit_same_clusters": bool((fit["cuda"]["clusters"] == fit["cpu"]["clusters"]).all()),
           "fit_s_card_cpu": [fit["cuda"]["s"], fit["cpu"]["s"]],
           "fit_timings_card_cpu": [fit["cuda"]["timings"], fit["cpu"]["timings"]],
           "tolerances": {"knn": 2e-3, "init_cos_min": UMAP_INIT_COS_MIN,
                          "layout_median": UMAP_LAYOUT_MEDIAN_TOL,
                          "layout_p99": UMAP_LAYOUT_P99_TOL, "fit_sil_min": UMAP_PARITY_SIL_MIN}}
    faults = []
    if not (np.abs(cd - gd) <= 2e-3 + 2e-3 * np.abs(gd)).all():
        faults.append("kNN distances")
    if not rec["knn_clear_rows_equal_sets"]:
        faults.append("kNN index sets")
    if not cos.min() >= UMAP_INIT_COS_MIN:
        faults.append("LOBPCG init")
    if not (rec["layout_gap_median"] <= UMAP_LAYOUT_MEDIAN_TOL
            and rec["layout_gap_p99"] <= UMAP_LAYOUT_P99_TOL):
        faults.append("layout")
    if not (min(rec["fit_silhouette_card_cpu"]) > UMAP_PARITY_SIL_MIN
            and rec["fit_same_clusters"]):
        faults.append("full fit")
    rec["faults"] = faults
    return rec


def phase_umap_sparse(smi: str) -> dict:
    """The edge-list UMAP through UMAP.fit / transform and the shared
    sweep: bench_umap.py at 10,000 x 4096 (cold, warm from the host, warm
    from the card, a profiled call), a 2000-point transform, the card
    against the CPU at 3000 x 64, 100,000 x 4096 once, and the shared
    sweep past the threshold against the serial loop.  No kernel of the
    port may launch."""
    import numpy as np
    import torch
    from tdax_torch.config import SweepConfig, UMAPConfig
    from tdax_torch.ops.umap import UMAP
    from tdax_torch.pipeline.tda_sweep import embed_and_silhouettes

    counters = _kernel_counters()
    info = {"phase": "umap_sparse", "nvidia_smi": smi}
    # (a) bench_umap.py:50-84 at 10k: cold, warm from the host, warm from the card
    x, labels, x_new, labels_new = umap_cloud(UMAP_N, n_new=UMAP_TRANSFORM_N)
    _, emb_cold, cold = _umap_fit(x, labels, "cold")
    _, emb_host, warm_host = _umap_fit(x, labels, "warm_host")
    x_card = torch.as_tensor(x).to("cuda")
    torch.cuda.synchronize()
    reducer, emb_card, warm_card = _umap_fit(x_card, labels, "warm_device")
    info["runs"] = [cold, warm_host, warm_card]
    info["cold_equals_warm"] = bool(np.array_equal(emb_cold, emb_host))
    info["profile_warm_device"] = profile_device(
        lambda: UMAP(n_neighbors=UMAP_K, n_components=3, metric="cosine",
                     random_state=42).fit(x_card))
    if not np.array_equal(emb_card, emb_host):
        raise AssertionError("umap_sparse: the embeddings from the host and from the card "
                             f"differ (max {np.abs(emb_card - emb_host).max()})")

    # (b) 2000 fresh points of the mixture against (a)'s fit (the edge list)
    before = reducer.embedding_.copy()
    t0 = time.perf_counter()
    got = reducer.transform(x_new)
    transform_s = time.perf_counter() - t0
    again = reducer.transform(x_new)
    placed = float((_nearest_centroid(emb_card, labels, got) == labels_new).mean())
    info["transform"] = {"n_new": UMAP_TRANSFORM_N, "wall_s": transform_s, "placed": placed,
                         "repeat_equal": bool(np.array_equal(got, again))}
    if (got.shape != (UMAP_TRANSFORM_N, 3) or not np.isfinite(got).all()
            or not np.array_equal(before, reducer.embedding_) or placed < UMAP_PLACED_MIN
            or not np.array_equal(got, again)):
        raise AssertionError(f"umap_sparse transform: {info['transform']}, shape {got.shape}, "
                             f"finite {bool(np.isfinite(got).all())}, train side unchanged "
                             f"{bool(np.array_equal(before, reducer.embedding_))}")
    del reducer, x_card

    # (c) the card against the CPU
    info["card_vs_cpu"] = _umap_card_vs_cpu()
    if info["card_vs_cpu"]["faults"]:
        emit(info)
        raise AssertionError(f"umap_sparse card vs CPU: {info['card_vs_cpu']['faults']}")

    # (e) the shared sweep past the threshold against the serial loop
    rng = np.random.default_rng(3)
    n_layers, n_sw, d_sw = UMAP_SWEEP_SHAPE
    centers = rng.normal(size=(8, 16)) * 4.0
    sw_labels = rng.integers(0, 8, n_sw)
    proj = rng.normal(size=(16, d_sw)) / 4.0
    clouds = np.stack([(centers[sw_labels] + rng.normal(size=(n_sw, 16))) @ proj
                       for _ in range(n_layers)]).astype(np.float32)
    ucfg = UMAPConfig(n_neighbors=UMAP_K)
    t0 = time.perf_counter()
    embs, sils = embed_and_silhouettes(clouds, SweepConfig(reducer_mode="shared", umap=ucfg),
                                       {"cluster": [str(c) for c in sw_labels]})
    sweep_s = time.perf_counter() - t0
    serial = UMAP.from_config(ucfg)
    serial.fit(clouds[-1])
    serial = np.stack([serial.transform(c) for c in clouds])
    info["shared_sweep"] = {"shape": list(UMAP_SWEEP_SHAPE), "wall_s": sweep_s,
                            "silhouettes": sils["cluster"].tolist(),
                            "equals_serial_loop": bool(np.array_equal(embs, serial))}
    if not np.isfinite(embs).all() or not np.array_equal(embs, serial):
        raise AssertionError(f"umap_sparse shared sweep: {info['shared_sweep']}")

    # (d) 100,000 x 4096 once, from the host array (the default 200 epochs)
    t0 = time.perf_counter()
    x_large, labels_large = umap_cloud(UMAP_LARGE_N)
    draw_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    _, emb_large, large = _umap_fit(x_large, labels_large, "large")
    large["draw_s"] = draw_s
    info["large"] = {"n": UMAP_LARGE_N, **large}
    info["profile_large"] = profile_device(
        lambda: UMAP(n_neighbors=UMAP_K, n_components=3, metric="cosine",
                     random_state=42).fit(x_large))
    del x_large

    moved = {k: v - counters[k] for k, v in _kernel_counters().items() if v != counters[k]}
    info["kernel_counters_moved"] = moved
    emit(info)
    if moved:
        raise AssertionError(f"umap_sparse launched kernels of the port: {moved}")
    # phase multidevice's mesh calls are held to these one-device results
    info["arrays"] = {"embedding": emb_card, "transform": got, "embedding_large": emb_large}
    return info


def phase_tiny_parity(tmp: Path) -> dict:
    """A tiny f32 model's capture: the card (kernels) against the CPU
    (plain attention), same parameters, same samples."""
    import numpy as np
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig.tiny(dtype="float32")
    metadata = generate_dataset(DatasetConfig(data_dir=str(tmp / "tiny_data")))
    cpu_params = init_params(cfg, "cpu", seed=7)

    card_params = _to_card(cpu_params)
    ecfg = ExtractConfig(batch_size=16)
    runs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", card_params)):
        res = extract_activations(metadata, str(tmp / f"tiny_{dev}.pt"), cfg, ecfg,
                                  params=params, device=dev, verbose=False)
        runs[dev] = _stack(res, metadata, cfg.num_layers)
    err = float(np.abs(runs["cuda"] - runs["cpu"]).max())
    scale = float(np.abs(runs["cpu"]).max())
    info = {"phase": "tiny_parity", "shape": list(runs["cuda"].shape), "max_abs_err": err,
            "max_abs_value": scale, "tolerance": TINY_TOL}
    emit(info)
    if not np.isfinite(runs["cuda"]).all() or err > TINY_TOL * max(1.0, scale):
        raise AssertionError(f"tiny capture: card vs CPU max abs err {err:.3e}")
    return info


def _to_card(tree):
    return {name: _to_card(leaf) if isinstance(leaf, dict) else leaf.to("cuda")
            for name, leaf in tree.items()}


def phase_tiny_int8(tmp: Path) -> dict:
    """A tiny f32 model's int8 tree: the int8 capture and generate on the
    card (kernels) against the same on the CPU (plain versions)."""
    import numpy as np
    import torch
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.generate import _decode_step, generate, prefill
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch
    from tdax_torch.models.qwen_vl.quantize import quantize_params
    from tdax_torch.models.qwen_vl.tokenizer import ToyTokenizer, batch_encode
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig.tiny(dtype="float32")
    metadata = generate_dataset(DatasetConfig(data_dir=str(tmp / "tiny_int8_data")))
    cpu_params = quantize_params(init_params(cfg, "cpu", seed=7))
    params = {"cpu": cpu_params, "cuda": _to_card(cpu_params)}
    ecfg = ExtractConfig(batch_size=16, quantize_int8=True)
    enc = batch_encode(ToyTokenizer(cfg), metadata[:6], cfg)
    images = load_image_batch(enc["image_paths"], cfg.visual.image_size)
    acts, logits, toks = {}, {}, {}
    for dev in ("cpu", "cuda"):
        res = extract_activations(metadata, str(tmp / f"tiny_int8_{dev}.pt"), cfg, ecfg,
                                  params=params[dev], device=dev, verbose=False)
        acts[dev] = _stack(res, metadata, cfg.num_layers)
        batch = {"input_ids": torch.as_tensor(enc["input_ids"], device=dev).long(),
                 "attn_mask": torch.as_tensor(enc["attn_mask"], device=dev),
                 "images": torch.as_tensor(images, device=dev),
                 "image_positions": torch.as_tensor(enc["image_positions"], device=dev).long()}
        lengths = batch["attn_mask"].sum(1).long()
        for kv_int8 in (False, True):
            with torch.inference_mode():
                _, ks, vs = prefill(params[dev], cfg, t_max=enc["input_ids"].shape[1] + 8,
                                    kv_int8=kv_int8, **batch)
                step, _, _ = _decode_step(params[dev], cfg, batch["input_ids"][:, 0], lengths,
                                          ks, vs)
            logits[dev, kv_int8] = step.cpu().numpy()
            toks[dev, kv_int8] = generate(params[dev], cfg, max_new_tokens=8, kv_int8=kv_int8,
                                          **batch).cpu().numpy()
    err = float(np.abs(acts["cuda"] - acts["cpu"]).max())
    scale = float(np.abs(acts["cpu"]).max())
    logit_err = {str(k): float(np.abs(logits["cuda", k] - logits["cpu", k]).max())
                 for k in (False, True)}
    logit_scale = max(float(np.abs(v).max()) for v in logits.values())
    same = {str(k): bool(np.array_equal(toks["cuda", k], toks["cpu", k])) for k in (False, True)}
    info = {"phase": "tiny_int8_parity", "capture_shape": list(acts["cuda"].shape),
            "capture_max_abs_err": err, "capture_max_abs_value": scale,
            "decode_logits_max_abs_err_by_kv_int8": logit_err, "logits_max_abs": logit_scale,
            "greedy_tokens_identical_by_kv_int8": same, "tokens": toks["cuda", False].tolist(),
            "tolerance": TINY_TOL, "kv_int8_logits_tolerance": TINY_KV_INT8_TOL}
    emit(info)
    if not np.isfinite(acts["cuda"]).all() or err > TINY_TOL * max(1.0, scale):
        raise AssertionError(f"tiny int8 capture: card vs CPU max abs err {err:.3e}")
    if (logit_err["False"] > TINY_TOL * max(1.0, logit_scale)
            or logit_err["True"] > TINY_KV_INT8_TOL * max(1.0, logit_scale)):
        raise AssertionError(f"tiny int8 decode logits: card vs CPU {logit_err}")
    if not all(same.values()):
        raise AssertionError(f"tiny int8 generate: card and CPU tokens differ {same}")
    return info


def phase_capture(tmp: Path, smi: str):
    """The port's main path at full width and depth; returns its record
    and the state the int8 and generate phases reuse (the bf16 params,
    the capture, the dataset and its encoding)."""
    import torch
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    import tdax_torch.ops.vit_elementwise as ve
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.data.io import save_activations, save_activations_npz
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch
    from tdax_torch.models.qwen_vl.tokenizer import ToyTokenizer, batch_encode
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig()
    ds = DatasetConfig(data_dir=str(tmp / "data"))
    metadata = generate_dataset(ds)
    if len(metadata) != 48:
        raise AssertionError(f"dataset has {len(metadata)} samples, expected 48")

    t0 = time.perf_counter()
    params = init_params(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = 0
    stack = [params]
    while stack:
        for leaf in stack.pop().values():
            if isinstance(leaf, dict):
                stack.append(leaf)
            else:
                n_params += leaf.numel()

    ecfg = ExtractConfig(batch_size=16)
    out_path = str(tmp / "data" / "all_activations.pt")
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.LAUNCHES_SM90 = qm.LAUNCHES = qm.LAUNCHES_SM90 = 0
    ve.LAUNCHES_LN = ve.LAUNCHES_EPILOGUE = 0
    t0 = time.perf_counter()
    results = extract_activations(metadata, out_path, cfg, ecfg, params=params,
                                  device="cuda", verbose=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, sm90_launches, qmm_launches = fa.LAUNCHES, fa.LAUNCHES_SM90, qm.LAUNCHES
    vit_launches = {"vit_ln_rows": ve.LAUNCHES_LN, "vit_bias_epilogue": ve.LAUNCHES_EPILOGUE}
    peak = torch.cuda.max_memory_allocated()

    acts, ids = _check_capture(out_path, metadata, results, "bf16 capture")
    n_batches = math.ceil(len(metadata) / ecfg.batch_size)
    expected = n_batches * (cfg.visual.layers + 1 + cfg.num_layers)
    if launches != expected or sm90_launches != expected or qmm_launches != 0:
        raise AssertionError(f"flash kernels launched {launches} times ({sm90_launches} sm90), "
                             f"expected {expected}, all sm90; qmm {qmm_launches} times, "
                             "expected 0 (fp weights)")
    vit_expected = {"vit_ln_rows": n_batches * VIT_LN_PER_BATCH,
                    "vit_bias_epilogue": n_batches * VIT_EPILOGUE_PER_BATCH}
    if vit_launches != vit_expected:
        raise AssertionError(f"the tower's elementwise kernels launched {vit_launches}, "
                             f"expected {vit_expected}")

    # the same run again, warm: the difference is first-call set-up
    t0 = time.perf_counter()
    extract_activations(metadata, str(tmp / "data" / "again.pt"), cfg, ecfg, params=params,
                        device="cuda", verbose=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # the host stages of the capture, each alone on the same data
    host = {}
    t0 = time.perf_counter()
    encoded = batch_encode(ToyTokenizer(cfg), metadata, cfg)
    host["tokenize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_image_batch(encoded["image_paths"], cfg.visual.image_size)
    host["images_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_activations_npz(str(tmp / "host.npz"), acts, ids, metadata)
    host["npz_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_activations(str(tmp / "host.pt"), acts, ids, metadata)
    host["pt_s"] = time.perf_counter() - t0
    max_len = math.ceil((encoded["input_ids"].shape[1] + 1) / 64) * 64
    tokens = n_batches * ecfg.batch_size * (max_len + cfg.visual.n_patches)
    info = {"phase": "capture", "nvidia_smi": smi, "params": n_params,
            "param_dtype": cfg.dtype, "init_s": init_s, "capture_shape": list(acts.shape),
            "finite": True, "flash_launches": launches, "flash_launches_sm90": sm90_launches,
            "expected_launches": expected,
            "qmm_launches": qmm_launches, "vit_launches": vit_launches,
            "wall_s": wall_s, "max_len": max_len, "tokens": tokens, "tokens_per_s": tokens / wall_s,
            "wall_warm_s": warm_s, "tokens_per_s_warm": tokens / warm_s, "host": host,
            "max_memory_allocated_bytes": peak, "image_path": "PIL"}
    emit(info)
    info["profile"] = phase_profile(params, cfg, encoded, max_len, ecfg.batch_size, smi, "bf16")
    state = {"params": params, "acts": acts, "metadata": metadata, "encoded": encoded,
             "max_len": max_len}
    return info, state


def _check_capture(out_path: str, metadata, results, label, n_layers: int = 32,
                   hidden: int = 4096):
    """The capture's files in tdax's schemas: [n_layers, len(metadata),
    hidden], finite, .npz ids and metadata, .pt entries equal to the .npz,
    no checkpoint file left."""
    import os

    import numpy as np
    import torch
    from tdax_torch.data.io import load_activations_npz

    acts, ids, meta = load_activations_npz(out_path.rsplit(".", 1)[0] + ".npz")
    shape = (n_layers, len(metadata), hidden)
    if acts.shape != shape:
        raise AssertionError(f"{label}: shape {acts.shape}, expected {shape}")
    if not np.isfinite(acts).all():
        raise AssertionError(f"{label}: non-finite values")
    if ids != [m["id"] for m in metadata] or meta != metadata:
        raise AssertionError(f"{label}: .npz sample_ids / metadata_json do not match the dataset")
    pt = torch.load(out_path, map_location="cpu", weights_only=False)
    if list(pt) != ids:
        raise AssertionError(f"{label}: .pt keys do not match the sample ids")
    for j, sid in enumerate(ids):
        entry = pt[sid]
        if entry["metadata"] != metadata[j] or list(entry["activations"]) != [
                f"layer_{i}" for i in range(n_layers)]:
            raise AssertionError(f"{label}: .pt entry {sid} does not have the tdax schema")
        if not np.array_equal(entry["activations"][f"layer_{n_layers - 1}"].numpy(),
                              acts[n_layers - 1, j]):
            raise AssertionError(f"{label}: .pt and .npz disagree for {sid}")
    if set(results) != set(ids):
        raise AssertionError(f"{label}: returned results do not cover the dataset")
    if np.abs(acts[:, 0] - acts[:, 1]).max() == 0:
        raise AssertionError(f"{label}: two different samples gave identical activations")
    if os.path.exists(out_path + ".tmp.npz"):
        raise AssertionError(f"{label}: the checkpoint file was left behind")
    return acts, ids


def _device_time_by_kind(prof) -> dict:
    """Device time (ms) of a profiled run, summed by kind, and the top
    kernels."""
    import torch
    kinds = {"qmm": 0.0, "flash": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "gemm": 0.0, "other": 0.0}
    top = []
    qmm_sm90_us = qmm_decode_us = flash_decode_us = int8_us = 0.0
    ranges = {}
    for ev in prof.key_averages():
        # a record_function range (torch.optim's "Optimizer.step#...", the
        # W8A8 phase's "w8a8.*") shows as a device event spanning its
        # kernels: not a kernel of its own
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.key.startswith("w8a8."):
            ranges[ev.key] = {"device_ms": getattr(ev, "device_time_total", 0.0) / 1e3,
                              "count": ev.count}
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or ev.key.startswith(("Optimizer.", "w8a8."))):
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        name = ev.key.lower()
        kind = ("qmm" if "qmm_" in name else
                "flash" if ("flash_fwd" in name or "flash_decode" in name) else
                "flash_bwd_dq" if "bwd_dq_" in name else
                "flash_bwd_dkv" if "bwd_dkv_" in name else
                "gemm" if any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma")) else
                "other")
        kinds[kind] += us / 1e3
        qmm_sm90_us += us if "qmm_sm90" in name else 0.0
        qmm_decode_us += us if "qmm_decode" in name else 0.0
        flash_decode_us += us if "flash_decode" in name else 0.0
        int8_us += us if kind == "gemm" and any(w in name for w in ("s8", "i8", "imma")) else 0
        top.append((us / 1e3, ev.count, ev.key[:90]))
    top.sort(reverse=True)
    # qmm_ms holds every qmm kernel, qmm_sm90_ms and qmm_decode_ms each Hopper
    # one's share of it; flash_decode_ms the decode kernel's share of
    # flash_ms; int8_gemm_ms the int8 x int8 GEMMs' share of gemm_ms
    out = {"busy_ms": sum(kinds.values()), **{f"{k}_ms": v for k, v in kinds.items()},
           "qmm_sm90_ms": qmm_sm90_us / 1e3, "qmm_decode_ms": qmm_decode_us / 1e3,
           "flash_decode_ms": flash_decode_us / 1e3, "int8_gemm_ms": int8_us / 1e3,
           "top_kernels_ms_count_name": top[:12]}
    if ranges:
        out["ranges"] = ranges
    return out


def phase_profile(params, cfg, encoded, max_len, bs, smi, label) -> dict:
    """Where one batch's forward spends the card's time: the forward
    alone (host clock, synchronised, median of 3 after one warm-up),
    then one forward under torch.profiler, kernel time summed by kind."""
    import numpy as np
    import torch
    from tdax_torch.models.qwen_vl.model import extract_layer_activations
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch

    pad = max_len - encoded["input_ids"].shape[1]

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to("cuda", dtype)

    batch = (dev(np.pad(encoded["input_ids"][:bs], ((0, 0), (0, pad))), torch.long),
             dev(np.pad(encoded["attn_mask"][:bs], ((0, 0), (0, pad))), torch.int32),
             dev(encoded["last_token_idx"][:bs], torch.long),
             dev(load_image_batch(encoded["image_paths"][:bs], cfg.visual.image_size),
                 torch.float32),
             dev(encoded["image_positions"][:bs], torch.long))

    def forward():
        with torch.inference_mode():
            return extract_layer_activations(params, cfg, *batch)

    forward()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    forward_ms = 1e3 * sorted(times)[1]

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    kinds = _device_time_by_kind(prof)
    busy_ms = kinds.pop("busy_ms")
    info = {"phase": "profile", "weights": label, "nvidia_smi": smi, "batch": bs,
            "forward_ms": forward_ms, "forward_ms_runs": [1e3 * t for t in times],
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "idle_share": (1 - busy_ms / forward_ms) if busy_ms > 0 else "not measured",
            **kinds}
    emit(info)
    return info


def _fingerprint(params) -> list:
    """Slices of a few int8 leaves, to compare two int8 trees cheaply."""
    return [params["layers"]["attn_qkv_w"]["q"][-1, :64].clone(),
            params["layers"]["mlp_proj_w"]["s"][-1].clone(),
            params["lm_head"]["q"][:64, -1024:].clone(),
            params["visual"]["blocks"]["mlp_fc_w"]["q"][-1, :64].clone(),
            params["wte"]["s"].clone()]


def phase_int8_capture(tmp: Path, smi: str, state: dict, bf16_peak: int) -> dict:
    """The capture with int8 weight-only matmuls: the bf16 capture's own
    weights quantized on the card (the bf16 tree is then freed), then
    extract_activations with quantize_int8."""
    import numpy as np
    import torch
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    import tdax_torch.ops.vit_elementwise as ve
    from tdax_torch.config import ExtractConfig
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.quantize import quantize_params, quantized_bytes
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig()
    metadata = state["metadata"]
    bf16 = state.pop("params")
    bf16_bytes = quantized_bytes(bf16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = quantize_params(bf16)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del bf16
    torch.cuda.empty_cache()
    int8_bytes = quantized_bytes(params)

    ecfg = ExtractConfig(batch_size=16, quantize_int8=True)
    out_dir = tmp / "int8"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = str(out_dir / "all_activations.pt")
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.LAUNCHES_SM90 = qm.LAUNCHES = qm.LAUNCHES_SM90 = 0
    ve.LAUNCHES_LN = ve.LAUNCHES_EPILOGUE = 0
    t0 = time.perf_counter()
    results = extract_activations(metadata, out_path, cfg, ecfg, params=params, device="cuda",
                                  verbose=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"qmm": qm.LAUNCHES, "qmm_sm90": qm.LAUNCHES_SM90, "flash_fwd": fa.LAUNCHES,
                "flash_fwd_sm90": fa.LAUNCHES_SM90, "vit_ln_rows": ve.LAUNCHES_LN,
                "vit_bias_epilogue": ve.LAUNCHES_EPILOGUE}
    peak = torch.cuda.max_memory_allocated()

    acts, _ = _check_capture(out_path, metadata, results, "int8 capture")
    n_batches = math.ceil(len(metadata) / ecfg.batch_size)
    expected = {"qmm": n_batches * QMM_PER_CAPTURE_BATCH,
                "qmm_sm90": n_batches * QMM_SM90_PER_CAPTURE_BATCH,
                "flash_fwd": n_batches * (cfg.visual.layers + 1 + cfg.num_layers),
                "flash_fwd_sm90": n_batches * (cfg.visual.layers + 1 + cfg.num_layers),
                "vit_ln_rows": n_batches * VIT_LN_PER_BATCH,
                "vit_bias_epilogue": n_batches * VIT_EPILOGUE_PER_BATCH}
    ref = state["acts"].astype(np.float64)
    got = acts.astype(np.float64)
    cos = (ref * got).sum(-1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(got, axis=-1))
    tokens = n_batches * ecfg.batch_size * (state["max_len"] + cfg.visual.n_patches)
    info = {"phase": "int8_capture", "nvidia_smi": smi, "quantize_s": quantize_s,
            "weight_bytes_bf16": bf16_bytes, "weight_bytes_int8": int8_bytes,
            "capture_shape": list(acts.shape), "finite": True, "launches": launches,
            "expected_launches": expected, "wall_s": wall_s, "tokens": tokens,
            "tokens_per_s": tokens / wall_s, "max_memory_allocated_bytes": peak,
            "max_memory_allocated_bytes_bf16_capture": bf16_peak,
            "cosine_vs_bf16_min": float(cos.min()), "cosine_vs_bf16_median": float(np.median(cos)),
            "cosine_limit": INT8_MIN_COSINE}
    emit(info)
    if launches != expected:
        raise AssertionError(f"int8 capture launches {launches}, expected {expected}")
    if not cos.min() > INT8_MIN_COSINE:
        raise AssertionError(f"int8 capture: min cosine {cos.min():.4f} against the bf16 capture")
    info["profile"] = phase_profile(params, cfg, state["encoded"], state["max_len"],
                                    ecfg.batch_size, smi, "int8")
    info["fingerprint"] = _fingerprint(params)
    state["int8_acts"] = acts
    return info


def _cache_bytes(*caches) -> int:
    tensors = [t for c in caches for t in (c.values() if isinstance(c, dict) else [c])]
    return sum(t.numel() * t.element_size() for t in tensors)


def _generate_inputs(state: dict) -> dict:
    """The first GEN_BATCH samples' prompts padded to GEN_PROMPT_LEN, on the card."""
    import numpy as np
    import torch
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch
    from tdax_torch.models.qwen_vl.tokenizer import ToyTokenizer

    cfg = QwenVLConfig()
    enc, b = state["encoded"], GEN_BATCH
    pad = GEN_PROMPT_LEN - enc["input_ids"].shape[1]

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to("cuda", dtype)

    mask = dev(np.pad(enc["attn_mask"][:b], ((0, 0), (0, pad))), torch.int32)
    return {"ids": dev(np.pad(enc["input_ids"][:b], ((0, 0), (0, pad)),
                              constant_values=ToyTokenizer(cfg).pad_id), torch.long),
            "mask": mask,
            "images": dev(load_image_batch(enc["image_paths"][:b], cfg.visual.image_size),
                          torch.float32),
            "pos": dev(enc["image_positions"][:b], torch.long),
            "lengths": mask.sum(1).long(), "rows": torch.arange(b, device="cuda")}


def _launches() -> dict:
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    return {"qmm": qm.LAUNCHES, "qmm_sm90": qm.LAUNCHES_SM90, "qmm_decode": qm.LAUNCHES_DECODE,
            "int8_mm": qm.LAUNCHES_INT8, "flash_fwd": fa.LAUNCHES,
            "flash_fwd_sm90": fa.LAUNCHES_SM90, "flash_decode": fa.LAUNCHES_DECODE}


def _zero_launches() -> None:
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    fa.LAUNCHES = fa.LAUNCHES_SM90 = qm.LAUNCHES = qm.LAUNCHES_SM90 = qm.LAUNCHES_INT8 = 0
    fa.LAUNCHES_DECODE = qm.LAUNCHES_DECODE = 0


def _generate_run(params, cfg, inp: dict, kv_int8: bool, expected: dict, label: str) -> dict:
    """generate's GEN_NEW_TOKENS greedy tokens (timed, launches counted and
    held against ``expected``), then the same steps by hand: the prefill
    alone (timed), its logits and two decode steps', and a profile of one
    more decode step."""
    import torch
    from tdax_torch.models.qwen_vl.decoder import rms_norm
    from tdax_torch.models.qwen_vl.generate import _decode_step, generate, prefill
    from tdax_torch.models.qwen_vl.quantize import qdot

    b, n_steps = GEN_BATCH, GEN_NEW_TOKENS - 1
    ids, mask, images, pos, lengths = (inp[k] for k in ("ids", "mask", "images", "pos",
                                                        "lengths"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    toks = generate(params, cfg, ids, mask, max_new_tokens=GEN_NEW_TOKENS, images=images,
                    image_positions=pos, kv_int8=kv_int8)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    if toks.shape != (b, GEN_NEW_TOKENS) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{label}: ids {tuple(toks.shape)} out of shape or range")
    if launches != expected:
        raise AssertionError(f"{label} (kv_int8={kv_int8}): launches {launches}, "
                             f"expected {expected}")

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden, ks, vs = prefill(params, cfg, ids, mask, images, pos,
                                 t_max=GEN_PROMPT_LEN + GEN_NEW_TOKENS, kv_int8=kv_int8)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        last = rms_norm(hidden[inp["rows"], lengths - 1], params["ln_f"], cfg.layer_norm_eps)
        logits = [qdot(last, params["lm_head"]).float()]
        tok = [logits[0].argmax(-1)]
        del hidden
        for i in range(2):
            step, ks, vs = _decode_step(params, cfg, tok[-1], lengths + i, ks, vs)
            logits.append(step)
            tok.append(step.argmax(-1))
        step_profile = profile_device(
            lambda: _decode_step(params, cfg, tok[-1], lengths + 2, ks, vs))
    info = {"kv_int8": kv_int8, "wall_s": wall_s, "prefill_s": prefill_s,
            "decode_ms_per_step": 1e3 * (wall_s - prefill_s) / n_steps,
            "tokens_per_s": b * GEN_NEW_TOKENS / wall_s, "cache_bytes": _cache_bytes(ks, vs),
            "max_memory_allocated_bytes": peak, "launches": launches,
            "expected_launches": expected, "decode_step_profile": step_profile}
    del ks, vs
    torch.cuda.empty_cache()
    return {"tokens": toks, "logits": logits, "tok": tok, "info": info}


def _check_first_tokens(run: dict, label: str) -> None:
    import torch
    if not torch.equal(run["tokens"][:, :3], torch.stack(run["tok"], 1)):
        raise AssertionError(f"{label}: the first tokens differ from the same steps by hand")


def _cached_vs_uncached(params, cfg, inp: dict, run: dict) -> tuple:
    """The cached logits of a run against the uncached forward on prompt +
    the generated prefix, at each sample's last real position: the error
    over max|logit| and the argmax agreement, per step."""
    import torch
    from tdax_torch.models.qwen_vl.model import forward

    rows, lengths = inp["rows"], inp["lengths"]
    ids2, mask2 = inp["ids"].clone(), inp["mask"].clone()
    for j in range(2):
        ids2[rows, lengths + j] = run["tok"][j]
        mask2[rows, lengths + j] = 1
    with torch.inference_mode():
        full = forward(params, cfg, ids2, mask2, inp["images"], inp["pos"])
        ref = [full[rows, lengths - 1 + j] for j in range(3)]
    del full
    err = [float((c - r).abs().max() / r.abs().max()) for c, r in zip(run["logits"], ref)]
    agree = [float((c.argmax(-1) == r.argmax(-1)).float().mean())
             for c, r in zip(run["logits"], ref)]
    return err, agree


def phase_generate(smi: str, state: dict, fingerprint: list) -> dict:
    """KV-cached greedy generation at full width from
    init_params_quantized, with bf16 caches and with int8 caches.  Leaves
    the int8 tree in ``state["int8_params"]`` for the W8A8 phase."""
    import torch
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.quantize import init_params_quantized, quantized_bytes

    cfg = QwenVLConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params_quantized(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(_fingerprint(params), fingerprint)):
        raise AssertionError("init_params_quantized differs from quantize_params(init_params)")

    inp = _generate_inputs(state)
    n_steps = GEN_NEW_TOKENS - 1
    # the prefill's attention on the sm90 kernel, the decode steps' (Tq = 1)
    # on flash_decode_sm90.cu; the prefill's int8 products as a capture
    # batch's (358 on qmm_sm90.cu, the patch embedding on qmm.cu), its
    # lm_head on the 16 last rows and every decode step's (M = 16) on
    # qmm_decode_sm90.cu
    expected = {"qmm": QMM_PER_CAPTURE_BATCH + 1 + n_steps * QMM_PER_DECODE_STEP,
                "qmm_sm90": QMM_SM90_PER_CAPTURE_BATCH,
                "qmm_decode": 1 + n_steps * QMM_PER_DECODE_STEP, "int8_mm": 0,
                "flash_fwd": cfg.visual.layers + 1 + cfg.num_layers + n_steps * cfg.num_layers,
                "flash_fwd_sm90": cfg.visual.layers + 1 + cfg.num_layers,
                "flash_decode": n_steps * cfg.num_layers}
    runs = {kv_int8: _generate_run(params, cfg, inp, kv_int8, expected, "generate")
            for kv_int8 in (False, True)}

    ref_run = runs[False]
    cache_err, cache_agree = _cached_vs_uncached(params, cfg, inp, ref_run)
    l_bf16, l_int8 = runs[False]["logits"][1], runs[True]["logits"][1]
    kv_err = float((l_int8 - l_bf16).abs().max() / l_bf16.abs().max())
    token_agree = float((runs[True]["tokens"] == runs[False]["tokens"]).float().mean())
    info = {"phase": "generate", "nvidia_smi": smi, "init_s": init_s,
            "weight_bytes_int8": quantized_bytes(params), "batch": GEN_BATCH,
            "prompt_len": GEN_PROMPT_LEN, "prompt_lengths": inp["lengths"].tolist(),
            "max_new_tokens": GEN_NEW_TOKENS, "t_max": GEN_PROMPT_LEN + GEN_NEW_TOKENS,
            "runs": [runs[k]["info"] for k in (False, True)],
            "cached_vs_uncached_max_err_over_max_logit": cache_err,
            "cached_vs_uncached_argmax_agreement": cache_agree, "cache_tolerance": CACHE_TOL,
            "kv_int8_vs_bf16_cache_max_err_over_max_logit": kv_err,
            "kv_int8_tolerance": KV_INT8_TOL,
            "kv_int8_vs_bf16_cache_token_agreement": token_agree,
            "tokens_bf16_cache_first_rows": runs[False]["tokens"][:2].tolist()}
    emit(info)
    if max(cache_err) > CACHE_TOL:
        raise AssertionError(f"generate: cached vs uncached logits {cache_err} over {CACHE_TOL}")
    if kv_err > KV_INT8_TOL:
        raise AssertionError(f"generate: kv_int8 vs bf16 cache logits {kv_err} over "
                             f"{KV_INT8_TOL}")
    _check_first_tokens(ref_run, "generate")
    state["int8_params"] = params
    return info


def w8a8_bound(m, k, n):
    """(ms, 'operations' | 'bytes'): the int8 product's 2MNK int8 tensor-core
    operations; int8 x and q read once, the int32 product written once."""
    t_ops = 2.0 * m * n * k / INT8_PEAK
    t_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bits(t):
    """A tensor's bits, to compare two results bitwise."""
    import torch
    return t.contiguous().view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _w8a8_sites(qmm_sites: list) -> list:
    """W8A8 qdot at every QMM_SITES shape on the card against the CPU,
    bitwise, and timed by parts: the quantize pass, int8_mm (padding, the
    weight's column-major copy kept from its first call), the copy alone
    (made once per weight), torch._int_mm alone on the column-major and on
    the row-major weight, the whole qdot."""
    import torch
    import torch.nn.functional as F
    from tdax_torch.models.qwen_vl.quantize import qdot, quantize_activations
    from tdax_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(1357)
    by_site = {s["site"]: s for s in qmm_sites}
    sites = []
    for name, m, k, n, per_batch, per_step in QMM_SITES:
        x = torch.randn((m, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        w = {"q": torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                                dtype=torch.int8),
             "s": torch.rand((n,), generator=gen, device="cuda") / (127 * math.sqrt(k))}
        before = (qm.LAUNCHES_INT8, qm.LAUNCHES)
        got = qdot(x, w)
        if (qm.LAUNCHES_INT8, qm.LAUNCHES) != (before[0] + 1, before[1]):
            raise AssertionError(f"w8a8 {name}: not one int8 product and no qmm launch")
        rows = min(m, W8A8_SITE_ROWS)
        want = qdot(x[:rows].cpu(), {"q": w["q"].cpu(), "s": w["s"].cpu()})
        torch.cuda.synchronize()
        if got.dtype != x.dtype or not torch.equal(_bits(got[:rows].cpu()), _bits(want)):
            diff = (got[:rows].cpu().float() - want.float()).abs()
            raise AssertionError(f"w8a8 {name}: card and CPU differ at {int((diff > 0).sum())} "
                                 f"of {diff.numel()} values (max {float(diff.max()):.3e})")
        iters = 50 if m <= 64 else 10
        xq, _ = quantize_activations(x)
        mp, kp = (m if m > 16 else 32), -(-k // 8) * 8
        a = F.pad(xq, (0, kp - k, 0, mp - m))
        bt = F.pad(w["q"].t(), (0, kp - k)).contiguous()
        site = {"site": name, "shape": [m, k, n], "calls_per_capture_batch": per_batch,
                "calls_per_decode_step": per_step, "bitwise_rows": rows,
                "quantize_ms": cuda_ms(lambda: quantize_activations(x), iters=iters),
                "int8_mm_ms": cuda_ms(lambda: qm.int8_mm(xq, w["q"]), iters=iters),
                "column_major_copy_ms": cuda_ms(lambda: qm._column_major(w["q"], kp, n),
                                                iters=iters),
                "int_mm_col_major_ms": cuda_ms(lambda: torch._int_mm(a, bt.t()), iters=iters),
                "qdot_ms": cuda_ms(lambda: qdot(x, w), iters=iters)}
        try:
            row_major = F.pad(w["q"], (0, 0, 0, kp - k))
            site["int_mm_row_major_ms"] = cuda_ms(lambda: torch._int_mm(a, row_major),
                                                  iters=iters)
        except RuntimeError as e:
            site["int_mm_row_major_ms"] = f"refused: {str(e)[:160]}"
        site["bound_ms"], site["bound_by"] = w8a8_bound(m, k, n)
        site["int8_mm_tops"] = 2.0 * m * n * k / (site["int8_mm_ms"] * 1e-3) / 1e12
        site["qmm_ms"] = by_site[name]["ms"]
        site["cublas_bf16_ms"] = by_site[name]["library_ms"]
        emit({"phase": "w8a8_site", **site})
        sites.append(site)
        del x, w, got, xq, a, bt
        torch.cuda.empty_cache()
    return sites


def _w8a8_totals(sites: list, calls_key: str) -> dict:
    keys = ("quantize_ms", "int8_mm_ms", "column_major_copy_ms", "int_mm_col_major_ms",
            "qdot_ms", "bound_ms", "qmm_ms", "cublas_bf16_ms")
    return {k: sum(s[k] * s[calls_key] for s in sites) for k in keys}


def _checked_products(stats: dict):
    """A stand-in for the model modules' ``qdot`` that holds every int8
    product on the card bitwise against the CPU's on the same input."""
    import torch
    from tdax_torch.models.qwen_vl.quantize import is_quantized, qdot

    def check(x, w):
        out = qdot(x, w)
        if is_quantized(w) and x.is_cuda:
            want = qdot(x.cpu(), {"q": w["q"].cpu(), "s": w["s"].cpu()})
            stats["products"] += 1
            stats["bitwise"] += int(torch.equal(_bits(out.cpu()), _bits(want)))
        return out
    return check


def _w8a8_tiny(tmp: Path) -> dict:
    """The tiny f32 model's int8 tree under W8A8: capture, decode logits and
    generate (8 tokens) on the card against the CPU, every product of the
    card's runs bitwise the CPU's on its input."""
    import numpy as np
    import torch
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl import decoder, model, vit
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.generate import _decode_step, generate, prefill
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch
    from tdax_torch.models.qwen_vl.quantize import quantize_params
    from tdax_torch.models.qwen_vl.tokenizer import ToyTokenizer, batch_encode
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig.tiny(dtype="float32")
    metadata = generate_dataset(DatasetConfig(data_dir=str(tmp / "tiny_w8a8_data")))
    cpu_params = quantize_params(init_params(cfg, "cpu", seed=7))
    params = {"cpu": cpu_params, "cuda": _to_card(cpu_params)}
    enc = batch_encode(ToyTokenizer(cfg), metadata[:6], cfg)
    images = load_image_batch(enc["image_paths"], cfg.visual.image_size)
    stats = {"products": 0, "bitwise": 0}
    modules = (decoder, vit, model)  # generate's LM head is model.lm_logits
    saved = [m.qdot for m in modules]
    for m in modules:
        m.qdot = _checked_products(stats)
    acts, logits, toks = {}, {}, {}
    try:
        for dev in ("cpu", "cuda"):
            res = extract_activations(metadata, str(tmp / f"tiny_w8a8_{dev}.pt"), cfg,
                                      ExtractConfig(batch_size=16, quantize_int8=True),
                                      params=params[dev], device=dev, verbose=False)
            acts[dev] = _stack(res, metadata, cfg.num_layers)
            batch = {"input_ids": torch.as_tensor(enc["input_ids"], device=dev).long(),
                     "attn_mask": torch.as_tensor(enc["attn_mask"], device=dev),
                     "images": torch.as_tensor(images, device=dev),
                     "image_positions": torch.as_tensor(enc["image_positions"],
                                                        device=dev).long()}
            with torch.inference_mode():
                _, ks, vs = prefill(params[dev], cfg, t_max=enc["input_ids"].shape[1] + 8,
                                    **batch)
                step, _, _ = _decode_step(params[dev], cfg, batch["input_ids"][:, 0],
                                          batch["attn_mask"].sum(1).long(), ks, vs)
            logits[dev] = step.cpu().numpy()
            toks[dev] = generate(params[dev], cfg, max_new_tokens=8, **batch).cpu().numpy()
    finally:
        for m, f in zip(modules, saved):
            m.qdot = f
    err = float(np.abs(acts["cuda"] - acts["cpu"]).max())
    scale = float(np.abs(acts["cpu"]).max())
    logit_err = float(np.abs(logits["cuda"] - logits["cpu"]).max())
    logit_scale = float(np.abs(logits["cpu"]).max())
    info = {"phase": "w8a8_tiny", "capture_shape": list(acts["cuda"].shape),
            "capture_max_abs_err": err,
            "capture_max_abs_value": scale,
            "capture_values_over_tiny_tol": int((np.abs(acts["cuda"] - acts["cpu"])
                                                 > TINY_TOL * max(1.0, scale)).sum()),
            "decode_logits_max_abs_err": logit_err, "logits_max_abs": logit_scale,
            "greedy_tokens_identical": bool(np.array_equal(toks["cuda"], toks["cpu"])),
            "card_products_bitwise_cpu": stats, "tolerance_rel": W8A8_REL_TOL,
            "tiny_tol": TINY_TOL}
    emit(info)
    if stats["products"] == 0 or stats["bitwise"] != stats["products"]:
        raise AssertionError(f"w8a8 tiny: card products bitwise the CPU's: {stats}")
    if not np.isfinite(acts["cuda"]).all() or err > W8A8_REL_TOL * scale:
        raise AssertionError(f"w8a8 tiny capture: card vs CPU max abs err {err:.3e}")
    if logit_err > W8A8_REL_TOL * logit_scale:
        raise AssertionError(f"w8a8 tiny decode logits: card vs CPU {logit_err:.3e}")
    if not info["greedy_tokens_identical"]:
        raise AssertionError("w8a8 tiny generate: card and CPU tokens differ")
    return info


def phase_w8a8(tmp: Path, smi: str, state: dict, qmm: dict) -> dict:
    """W8A8 serving (int8 activations x int8 weights) on the int8 capture's
    and generate's weights: every QMM_SITES shape bitwise against the CPU
    and timed by parts; the tiny model card against CPU; the full capture
    and generate with the switch on, their launch counts, fidelity and
    profiles.  The switch is off again after the phase, whatever happens."""
    import numpy as np
    import torch
    from tdax_torch.config import ExtractConfig
    from tdax_torch.models.qwen_vl import quantize
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig()
    params, metadata = state["int8_params"], state["metadata"]
    t_phase = time.perf_counter()
    quantize.set_w8a8(True)
    try:
        sites = _w8a8_sites(qmm["sites"])
        tiny = _w8a8_tiny(tmp)

        # the full capture with the switch on
        out_dir = tmp / "w8a8"
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path = str(out_dir / "all_activations.pt")
        ecfg = ExtractConfig(batch_size=16, quantize_int8=True)
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        results = extract_activations(metadata, out_path, cfg, ecfg, params=params,
                                      device="cuda", verbose=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        acts, _ = _check_capture(out_path, metadata, results, "w8a8 capture")
        n_batches = math.ceil(len(metadata) / ecfg.batch_size)
        flash = n_batches * (cfg.visual.layers + 1 + cfg.num_layers)
        expected = {"qmm": 0, "qmm_sm90": 0, "qmm_decode": 0,
                    "int8_mm": n_batches * QMM_PER_CAPTURE_BATCH,
                    "flash_fwd": flash, "flash_fwd_sm90": flash, "flash_decode": 0}
        ref = state["int8_acts"].astype(np.float64)
        got = acts.astype(np.float64)
        cos = (ref * got).sum(-1) / (np.linalg.norm(ref, axis=-1)
                                     * np.linalg.norm(got, axis=-1))
        capture = {"phase": "w8a8_capture", "capture_shape": list(acts.shape), "finite": True,
                   "launches": launches,
                   "expected_launches": expected, "wall_s": wall_s,
                   "max_memory_allocated_bytes": peak,
                   "cosine_vs_weight_only_min": float(cos.min()),
                   "cosine_vs_weight_only_median": float(np.median(cos)),
                   "cosine_limit": INT8_MIN_COSINE}
        emit(capture)
        if launches != expected:
            raise AssertionError(f"w8a8 capture launches {launches}, expected {expected}")
        if not cos.min() >= INT8_MIN_COSINE:
            raise AssertionError(f"w8a8 capture: min cosine {cos.min():.4f} against the "
                                 "weight-only capture")
        # one batch profiled, the quantize passes and int8_mm as ranges
        wrapped = {name: getattr(quantize, name) for name in ("quantize_activations", "int8_mm")}
        for name, fn in wrapped.items():
            def ranged(*args, _fn=fn, _name=name):
                with torch.profiler.record_function(f"w8a8.{_name}"):
                    return _fn(*args)
            setattr(quantize, name, ranged)
        try:
            capture["profile"] = phase_profile(params, cfg, state["encoded"], state["max_len"],
                                               ecfg.batch_size, smi, "w8a8")
        finally:
            for name, fn in wrapped.items():
                setattr(quantize, name, fn)

        # generate with bf16 caches
        inp = _generate_inputs(state)
        n_steps = GEN_NEW_TOKENS - 1
        expected = {"qmm": 0, "qmm_sm90": 0, "qmm_decode": 0,
                    "int8_mm": QMM_PER_CAPTURE_BATCH + 1 + n_steps * QMM_PER_DECODE_STEP,
                    "flash_fwd": cfg.visual.layers + 1 + cfg.num_layers
                    + n_steps * cfg.num_layers,
                    "flash_fwd_sm90": cfg.visual.layers + 1 + cfg.num_layers,
                    "flash_decode": n_steps * cfg.num_layers}
        run = _generate_run(params, cfg, inp, False, expected, "w8a8 generate")
        cache_err, cache_agree = _cached_vs_uncached(params, cfg, inp, run)
        _check_first_tokens(run, "w8a8 generate")
        emit({"phase": "w8a8_generate", **run["info"],
              "cached_vs_uncached_max_err_over_max_logit": cache_err,
              "cached_vs_uncached_argmax_agreement": cache_agree,
              "cache_tolerance": W8A8_CACHE_TOL})
        if max(cache_err) > W8A8_CACHE_TOL:
            raise AssertionError(f"w8a8 generate: cached vs uncached logits {cache_err} over "
                                 f"{W8A8_CACHE_TOL}")
    finally:
        quantize.set_w8a8(False)
    info = {"phase": "w8a8", "nvidia_smi": smi,
            "capture_batch": {"calls": QMM_PER_CAPTURE_BATCH,
                              **_w8a8_totals(sites, "calls_per_capture_batch")},
            "decode_step": {"calls": QMM_PER_DECODE_STEP,
                            **_w8a8_totals(sites, "calls_per_decode_step")},
            "sites_bitwise": len(sites), "tokens_first_rows": run["tokens"][:2].tolist(),
            "phase_s": time.perf_counter() - t_phase}
    emit(info)
    return {**info, "tiny": tiny, "capture": capture, "generate": run["info"]}


def _visible_pairs(tq, tk, causal) -> int:
    """(query, key) pairs a causal or dense tile walk must compute."""
    if not causal:
        return tq * tk
    return sum(min(i + 1, tk) for i in range(tq))


def bwd_bound(b, tq, tk, nh, hd, causal, itemsize, products, out_rows):
    """(ms, 'operations' | 'bytes') of one backward kernel: `products`
    matrix products of 2 hd flops over the visible pairs; q, k, v, dO,
    bias, lse and delta read once, `out_rows` rows of hd written once."""
    flops = 2.0 * products * b * nh * _visible_pairs(tq, tk, causal) * hd
    nbytes = ((2 * b * tq + 2 * b * tk + out_rows) * nh * hd * itemsize
              + 4 * (b * tk + 2 * b * nh * tq))
    peak = BF16_PEAK if itemsize == 2 else F32_PEAK
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bwd_terms(fa, q, k, v, bias, lse, delta, do, causal):
    """The magnitude of the terms each gradient sums: |ds| (in f32 its
    size bound, as ds cancels dp against delta) times |k| or |q|; p |dO|."""
    import torch
    p, mag = fa._probs_and_ds(q, k, v, bias, lse, delta, do, causal)
    if q.dtype == torch.float32:
        dp_mag = torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), v.float().abs())
        mag = p * (dp_mag + delta.abs()[..., None]) / math.sqrt(q.shape[-1])
        del dp_mag
    mag = mag.abs_()
    return {"dq": torch.einsum("bhqk,bkhd->bqhd", mag, k.float().abs()),
            "dk": torch.einsum("bhqk,bqhd->bkhd", mag, q.float().abs()),
            "dv": torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())}


def _bwd_counts(fa) -> list:
    return [fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES, fa.BWD_DQ_LAUNCHES_SM90,
            fa.BWD_DKV_LAUNCHES_SM90]


def _bwd_check(fa, q, k, v, do, bias, causal, label, kernel=None):
    """The forward's lse and one backward kernel pair (the routed one, or
    ``kernel="mma"``) against their plain versions; the launch counters
    must move as the choice says.  Returns (max |kernel - plain| per
    output, lse, delta)."""
    import torch
    o, lse = fa.flash_attention(q, k, v, bias, causal, return_lse=True)
    _, lse_plain = fa.flash_attention_plain(q, k, v, bias, causal, return_lse=True)
    lse_excess = float(((lse - lse_plain).abs() - LSE_TOL * (1 + lse_plain.abs())).max())
    if lse.shape != lse_plain.shape or lse_excess > 0:
        raise AssertionError(f"{label}: lse differs from the plain version's")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    sm90 = int((kernel or fa._bwd_route(q, k, v, do)) == "sm90")
    before = _bwd_counts(fa)
    got = {"dq": fa.flash_bwd_dq(q, k, v, bias, lse, delta, do, causal, _kernel=kernel)}
    got["dk"], got["dv"] = fa.flash_bwd_dkv(q, k, v, bias, lse, delta, do, causal,
                                            _kernel=kernel)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_bwd_counts(fa), before)]
    if moved != [1, 1, sm90, sm90]:
        raise AssertionError(f"{label}: backward launch counters moved {moved}")
    want = {"dq": fa.flash_bwd_dq_plain(q, k, v, bias, lse, delta, do, causal)}
    want["dk"], want["dv"] = fa.flash_bwd_dkv_plain(q, k, v, bias, lse, delta, do, causal)
    terms = _bwd_terms(fa, q, k, v, bias, lse, delta, do, causal)
    errs = {"lse": float((lse - lse_plain).abs().max())}
    for name in ("dq", "dk", "dv"):
        g, w = got[name], want[name]
        if g.shape != w.shape or g.dtype != q.dtype or not torch.isfinite(g).all():
            raise AssertionError(f"{label} {name}: shape/dtype {tuple(g.shape)} {g.dtype} "
                                 f"or non-finite")
        err = (g.float() - w.float()).abs_()
        if q.dtype == torch.bfloat16:
            ref = w.float().abs_()
            limit = ref.mul_(BWD_BF16_RTOL).add_(BWD_BF16_ATOL_OF_MAX * float(ref.max()))
            limit.add_(terms[name], alpha=BWD_BF16_TERMS)
        else:
            limit = terms[name] * BWD_F32_REL_TOL
        excess = float((err - limit).max())
        errs[name] = float(err.max())
        if excess > 0:
            raise AssertionError(f"{label} {name}: max |kernel - plain| = {errs[name]:.3e} is "
                                 f"outside the tolerance by {excess:.3e}")
    return errs, lse, delta


def _device_ms(fn, iters: int) -> float:
    """The card's kernel time per call of ``fn`` (torch.profiler, summed
    over every kernel it launches): free of host gaps between launches,
    such as autograd's hand-off to its device thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else "not measured"


def _median_spread(fn, iters: int) -> tuple:
    """(median, max - min) ms of BWD_REPEATS timings of ``iters`` calls."""
    runs = sorted(cuda_ms(fn, iters) for _ in range(BWD_REPEATS))
    return runs[len(runs) // 2], runs[-1] - runs[0]


def phase_flash_bwd(smi: str) -> dict:
    """The flash backward kernels and the forward's lse against their
    plain versions at the training path's shapes, bf16 and f32; at each
    site the route sends to flash_bwd_sm90.cu, that pair and flash_bwd.cu
    (forced) both, bitwise repeats at the training shape; times."""
    import torch
    import torch.nn.functional as F
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.runtime import get_device

    device = get_device()
    gen = torch.Generator(device=device).manual_seed(97)
    sites, f32_errs = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, tq, tk, nh, hd, causal, calls in BWD_SHAPES:
            q, k, v = _case_inputs(gen, b, tq, tk, nh, hd, dtype, device,
                                   strided_kv=name == "decoder", strided_q=name == "vit")
            do = torch.randn((b, tq, nh, hd), generator=gen, device=device, dtype=dtype)
            valid = torch.ones((b, tk), dtype=torch.int32, device=device)
            if name == "decoder":
                valid[-1, -TRAIN_MASKED:] = 0
            elif name == "ragged":
                valid[0, -20:] = 0
            bias = torch.where(valid > 0, 0.0, fa.NEG_INF).to(torch.float32)
            label = f"{str(dtype)[6:]} {name}"
            route = fa._bwd_route(q, k, v, do)
            if route != ("sm90" if dtype == torch.bfloat16 else "mma"):
                raise AssertionError(f"{label}: the backward is routed to the {route} kernels")
            errs, lse, delta = _bwd_check(fa, q, k, v, do, bias, causal, f"{label} ({route})")
            if dtype == torch.float32:
                f32_errs[name] = errs
                continue
            errs_mma, _, _ = _bwd_check(fa, q, k, v, do, bias, causal, f"{label} (mma)", "mma")
            args = (q, k, v, bias, lse, delta, do, causal)
            if name == "decoder":  # no atomics: the same inputs give the same bits
                first, again = ([fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args)]
                                for _ in range(2))
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    raise AssertionError(f"{label}: two runs of the sm90 backward differ")
                del first, again
            site = {"site": name, "shape": [b, tq, tk, nh, hd], "causal": causal,
                    "dtype": "bfloat16", "route": route, "key_mask": "last row's final 128 keys"
                    if name == "decoder" else "first row's final 20 keys"
                    if name == "ragged" else None,
                    "calls_per_train_step": calls, "max_abs_err": errs,
                    "max_abs_err_mma": errs_mma, "bitwise_repeat": name == "decoder" or None,
                    "timing": f"median and spread of {BWD_REPEATS} x 10 calls; *_device_ms: "
                              "profiled kernel time per call over 10"}
            for kind, fn in (("dq", fa.flash_bwd_dq), ("dkv", fa.flash_bwd_dkv)):
                site[f"{kind}_ms"], site[f"{kind}_spread_ms"] = _median_spread(
                    lambda: fn(*args), 10)
                site[f"{kind}_ms_mma"], site[f"{kind}_spread_ms_mma"] = _median_spread(
                    lambda: fn(*args, _kernel="mma"), 10)
            site.update({
                "fwd_lse_ms": cuda_ms(lambda: fa.flash_attention(
                    q, k, v, bias, causal, return_lse=True), iters=10),
                "plain_dq_ms": cuda_ms(lambda: fa.flash_bwd_dq_plain(*args), iters=3),
                "plain_dkv_ms": cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args), iters=3)})
            # SDPA (is_causal, no key mask): its whole backward (dq, dk, dv)
            # alone, autograd.grad over a retained graph
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2)
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            site["library_bwd_ms"], site["library_bwd_spread_ms"] = _median_spread(
                lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 10)
            for key, fn in (("library_bwd_device_ms", lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True)),
                    ("dq_device_ms", lambda: fa.flash_bwd_dq(*args)),
                    ("dkv_device_ms", lambda: fa.flash_bwd_dkv(*args))):
                site[key] = _device_ms(fn, 10)
            site["library_mask"] = f"is_causal={causal}, no key mask"
            site["dq_bound_ms"], site["dq_bound_by"] = bwd_bound(b, tq, tk, nh, hd, causal, 2,
                                                                 3, b * tq)
            site["dkv_bound_ms"], site["dkv_bound_by"] = bwd_bound(b, tq, tk, nh, hd, causal,
                                                                   2, 4, 2 * b * tk)
            # the yardstick: SDPA's profiled device time (its CUDA-event time
            # carries autograd's host hand-off and spread 0.4 ms in one run)
            profiled = isinstance(site["library_bwd_device_ms"], float)
            site["library_ms"] = site["library_bwd_device_ms" if profiled else "library_bwd_ms"]
            site["library_timed_by"] = "torch.profiler device time" if profiled else "CUDA events"
            site["pair_ms"] = site["dq_ms"] + site["dkv_ms"]
            site["pair_over_library"] = site["pair_ms"] / site["library_ms"]
            emit({"phase": "kernel_case", "kernel": "flash_bwd", "nvidia_smi": smi, **site})
            sites.append(site)
            del q, k, v, do, qt, kt, vt, dot, out, lse, delta, args
            torch.cuda.empty_cache()
    emit({"phase": "kernel_flash_bwd_f32", "max_abs_err": f32_errs,
          "tolerance": f"{BWD_F32_REL_TOL} x the summed terms' magnitude"})
    return {"sites": sites, "f32_max_abs_err": f32_errs}


def _tree_to(tree, device):
    """A copy of a params tree on ``device`` (training updates in place)."""
    return {name: _tree_to(leaf, device) if isinstance(leaf, dict)
            else leaf.to(device, copy=True) for name, leaf in tree.items()}


def _tree_err(got, want, path=""):
    """{path: (max |got - want|, max |want|)} over two trees of tensors."""
    out = {}
    for name, w in want.items():
        if isinstance(w, dict):
            out.update(_tree_err(got[name], w, f"{path}{name}/"))
        else:
            g = got[name].detach().cpu().float()
            w = w.detach().cpu().float()
            out[path + name] = (float((g - w).abs().max()), float(w.abs().max()))
    return out


def _tiny_batch(cfg, seed, device, images=False):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    b, t = 2, 24
    ids = rng.integers(1, 64, (b, t))
    mask = np.ones((b, t), np.int32)
    mask[-1, t - 5:] = 0
    batch = {"input_ids": torch.as_tensor(ids, device=device).long(),
             "attn_mask": torch.as_tensor(mask, device=device)}
    if images:
        nq, size = cfg.visual.n_queries, cfg.visual.image_size
        pos = np.full((b, nq), -1)
        pos[0] = np.arange(2, 2 + nq)
        batch["image_positions"] = torch.as_tensor(pos, device=device).long()
        batch["images"] = torch.as_tensor(
            rng.normal(size=(b, 3, size, size)).astype(np.float32), device=device)
    return batch


def phase_tiny_train(tmp: Path) -> dict:
    """The tiny f32 config trained on the card (kernels) and on the CPU
    (plain versions), and a bitwise resume on the card."""
    import torch
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import (default_optimizer, lm_loss, make_train_step, train_loop,
                                     warmup_cosine_lr)

    cfg = QwenVLConfig.tiny(dtype="float32")
    text_tree = init_params(cfg, "cpu", seed=11, with_visual=False)
    info = {"phase": "tiny_train", "grad_tolerance": TINY_GRAD_TOL,
            "param_tolerance": [TINY_PARAM_RTOL, TINY_PARAM_ATOL]}

    # loss and every gradient
    grads, losses = {}, {}
    for dev in ("cpu", "cuda"):
        state = default_optimizer().init(_tree_to(text_tree, dev))
        batch = _tiny_batch(cfg, 1, dev)
        loss = lm_loss(state.tree, cfg, batch["input_ids"], batch["attn_mask"])
        grads[dev] = state.stack(torch.autograd.grad(loss, state.leaves))
        losses[dev] = float(loss.detach())
    grad_err = _tree_err(grads["cuda"], grads["cpu"])
    info["loss_card_cpu"] = [losses["cuda"], losses["cpu"]]
    info["grad_max_err_over_max"] = max(e / max(m, 1e-30) for e, m in grad_err.values())
    if (abs(losses["cuda"] - losses["cpu"]) > 1e-5 * abs(losses["cpu"])
            or info["grad_max_err_over_max"] > TINY_GRAD_TOL):
        raise AssertionError(f"tiny train: card vs CPU loss {info['loss_card_cpu']} or "
                             f"gradients {grad_err}")

    # three make_train_step steps
    runs = {}
    for dev in ("cpu", "cuda"):
        opt = default_optimizer(warmup_cosine_lr(1e-3, 2, 6))
        params = _tree_to(text_tree, dev)
        state = opt.init(params)
        step = make_train_step(cfg, opt, device=dev)
        step_losses = []
        for i in range(3):
            params, state, loss = step(params, state, _tiny_batch(cfg, 10 + i, dev))
            step_losses.append(float(loss))
        runs[dev] = (params, state, step_losses)
    param_err = _tree_err(runs["cuda"][0], runs["cpu"][0])
    mu_err = _tree_err(runs["cuda"][1].mu, runs["cpu"][1].mu)
    info["step_losses_card_cpu"] = [runs["cuda"][2], runs["cpu"][2]]
    info["param_max_abs_err"] = max(e for e, _ in param_err.values())
    info["mu_max_err_over_max"] = max(e / max(m, 1e-30) for e, m in mu_err.values())
    bad = [k for k, (e, m) in param_err.items() if e > TINY_PARAM_ATOL + TINY_PARAM_RTOL * m]
    if bad or info["mu_max_err_over_max"] > TINY_GRAD_TOL or any(
            abs(a - b) > 1e-5 * abs(b) for a, b in zip(*info["step_losses_card_cpu"])):
        raise AssertionError(f"tiny train steps: card vs CPU params {bad}, moments "
                             f"{info['mu_max_err_over_max']:.3e}, losses "
                             f"{info['step_losses_card_cpu']}")

    # a with_images step: the ViT's and the resampler's backward
    vis_tree = init_params(cfg, "cpu", seed=12)
    img_losses = {}
    for dev in ("cpu", "cuda"):
        opt = default_optimizer(1e-3)
        params = _tree_to(vis_tree, dev)
        state = opt.init(params)
        step = make_train_step(cfg, opt, with_images=True, device=dev)
        fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
        _, _, loss = step(params, state, _tiny_batch(cfg, 20, dev, images=True))
        img_losses[dev] = float(loss)
        launches = [fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES]
    expected = cfg.num_layers + cfg.visual.layers + 1
    info["images_step_loss_card_cpu"] = [img_losses["cuda"], img_losses["cpu"]]
    info["images_step_launches_fwd_dq_dkv"] = launches
    if launches != [expected] * 3 or abs(img_losses["cuda"] - img_losses["cpu"]) > 1e-5 * abs(
            img_losses["cpu"]):
        raise AssertionError(f"tiny with_images step: launches {launches} (expected "
                             f"{expected} each), losses {info['images_step_loss_card_cpu']}")

    # train_loop stopped at step 4 and resumed to 6, on the card
    fixed = [_tiny_batch(cfg, 40 + i, "cuda") for i in range(6)]

    def loop(n_steps, **kw):
        return train_loop(_tree_to(text_tree, "cuda"), cfg, lambda i: fixed[i], n_steps,
                          optimizer=default_optimizer(warmup_cosine_lr(1e-3, 2, 6)),
                          device="cuda", **kw)

    straight, s_state, all_losses = loop(6)
    ck = str(tmp / "tiny_train_ck")
    loop(4, checkpoint_path=ck, checkpoint_every=4)
    resumed, r_state, rest = loop(6, checkpoint_path=ck, checkpoint_every=100)
    same = (rest == all_losses[4:] and r_state.count == s_state.count == 6 and all(
        e == 0 for tree_a, tree_b in ((straight, resumed), (s_state.mu, r_state.mu),
                                      (s_state.nu, r_state.nu))
        for e, _ in _tree_err(tree_a, tree_b).values()))
    info["resume_bitwise"] = same
    info["resume_losses"] = [all_losses, rest]
    emit(info)
    if not same:
        raise AssertionError("tiny train_loop resumed from its checkpoint differs from the "
                             "uninterrupted run")
    return info


def train_flops(cfg, b, t) -> float:
    """bench_train.py's count for one step: 3 x the forward (decoder
    matmuls, LM head, attention), remat's recompute not credited."""
    h, ff = cfg.hidden_size, cfg.ff_half
    per_token = cfg.num_layers * 2 * (h * 3 * h + h * h + 3 * h * ff)
    fwd = b * t * (per_token + 2 * h * cfg.vocab_size) + cfg.num_layers * 4 * t * t * h * b
    return 3.0 * fwd


def _train_batch(cfg, seed: int, device) -> dict:
    """Phase train's fixed batch: TRAIN_BATCH x TRAIN_SEQ ids from
    ``seed``'s numpy generator, the last row's final TRAIN_MASKED
    positions masked."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    mask = np.ones((TRAIN_BATCH, TRAIN_SEQ), np.int32)
    mask[-1, -TRAIN_MASKED:] = 0
    return {"input_ids": torch.as_tensor(ids, device=device).long(),
            "attn_mask": torch.as_tensor(mask, device=device)}


def _f32_bits(x) -> int:
    """The bit pattern of an f32 scalar (a loss), to compare bitwise."""
    import numpy as np
    return int(np.float32(float(x)).view(np.uint32))


def _train_fingerprint(params, state) -> list:
    """Exact integer sums of the bits of every leaf of the params and of
    AdamW's two moments (the sum of the 16-bit words and the sum weighted
    by position mod 65521, in int64 over 2^24-word chunks), so that equal
    trees give equal lists and a one-bit change shows."""
    import torch
    out = []
    for tree in (params, state.mu, state.nu):
        for leaf in _md_leaves(tree):
            words = leaf.detach().reshape(-1).view(torch.int16)
            total = weighted = 0
            for c0 in range(0, words.numel(), 1 << 24):
                chunk = words[c0:c0 + (1 << 24)].long()
                pos = torch.arange(c0, c0 + chunk.numel(), device=chunk.device) % 65521 + 1
                total += int(chunk.sum())
                weighted += int((chunk * pos).sum())
            out.append([total, weighted])
    return out


def phase_train(smi: str, seed: int) -> dict:
    """The training step at the full decoder width on the card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import default_optimizer, make_train_step, warmup_cosine_lr

    cfg = QwenVLConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, "cuda", seed=seed, with_visual=False)
    opt = default_optimizer(warmup_cosine_lr(1e-4, 2, 8))
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(leaf.numel() for leaf in state.leaves)
    step = make_train_step(cfg, opt, remat=True)

    batch = _train_batch(cfg, seed, "cuda")

    losses = []
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batch)
    losses.append(loss)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # phase multidevice's NCCL world of one takes this first step again
    reference = {"seed": seed, "loss_bits": _f32_bits(loss),
                 "fingerprint": _train_fingerprint(params, state)}

    fa.LAUNCHES = fa.LAUNCHES_SM90 = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    fa.BWD_DQ_LAUNCHES_SM90 = fa.BWD_DKV_LAUNCHES_SM90 = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
    launches = {"flash_fwd": fa.LAUNCHES, "flash_fwd_sm90": fa.LAUNCHES_SM90,
                "flash_bwd_dq": fa.BWD_DQ_LAUNCHES, "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES,
                "flash_bwd_dq_sm90": fa.BWD_DQ_LAUNCHES_SM90,
                "flash_bwd_dkv_sm90": fa.BWD_DKV_LAUNCHES_SM90}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]

    # one more step split in two (host clock), then one profiled the same way
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = step.loss_and_grads(params, state, batch)
    torch.cuda.synchronize()
    parts = {"loss_and_grads_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    state.update(grads)
    torch.cuda.synchronize()
    parts["update_s"] = time.perf_counter() - t0
    losses.append(float(loss))
    del grads

    profiled = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, grads = step.loss_and_grads(params, state, batch)
        torch.cuda.synchronize()
        profiled["loss_and_grads_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    kinds = _device_time_by_kind(prof)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state.update(grads)
        torch.cuda.synchronize()
        profiled["update_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    opt_kinds = _device_time_by_kind(prof)
    del grads
    busy = kinds["busy_ms"] + opt_kinds["busy_ms"]
    wall = profiled["loss_and_grads_wall_ms"] + profiled["update_wall_ms"]
    profiled.update({
        "gemm_ms": kinds["gemm_ms"], "flash_fwd_ms": kinds["flash_ms"],
        "flash_bwd_dq_ms": kinds["flash_bwd_dq_ms"], "flash_bwd_dkv_ms": kinds["flash_bwd_dkv_ms"],
        "elementwise_and_other_ms": kinds["other_ms"], "optimizer_ms": opt_kinds["busy_ms"],
        "optimizer_gemm_ms": opt_kinds["gemm_ms"],
        "device_busy_ms": busy if busy > 0 else "not measured",
        "idle_share": (1 - busy / wall) if busy > 0 else "not measured",
        "top_kernels_ms_count_name": kinds["top_kernels_ms_count_name"][:8],
        "optimizer_top_kernels": opt_kinds["top_kernels_ms_count_name"][:5]})

    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    expected = {"flash_fwd": 2 * cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_fwd_sm90": 2 * cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_bwd_dq": cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_bwd_dkv": cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_bwd_dq_sm90": cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_bwd_dkv_sm90": cfg.num_layers * TRAIN_TIMED_STEPS}
    ref_gap = (max(abs(a - b) for a, b in zip(losses, TRAIN_REF_LOSSES_SEED0))
               if seed == 0 else None)
    info = {"phase": "train", "nvidia_smi": smi, "params": n_params, "dtype": cfg.dtype,
            "batch": [TRAIN_BATCH, TRAIN_SEQ], "masked_positions": TRAIN_MASKED,
            "remat": True, "seed": seed, "init_s": init_s, "warm_step_s": warm_s,
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "flops_per_step": flops, "tflops": flops / step_s / 1e12,
            "share_of_989_tflops": flops / step_s / BF16_PEAK,
            "max_memory_allocated_bytes": peak, "launches": launches,
            "expected_launches": expected, "losses": losses,
            "max_gap_to_reference_losses": ref_gap, "split_step": parts,
            "profiled_step": profiled}
    emit(info)
    info["reference"] = reference
    if n_params != 7_721_324_544:
        raise AssertionError(f"train: {n_params} parameters, expected 7,721,324,544")
    if launches != expected:
        raise AssertionError(f"train: launches {launches}, expected {expected}")
    if not np.isfinite(losses).all() or not losses[TRAIN_TIMED_STEPS] < losses[0]:
        raise AssertionError(f"train: losses {losses} not finite or not decreasing")
    if ref_gap is not None and ref_gap > TRAIN_LOSS_TOL:
        raise AssertionError(f"train: losses {losses} leave the reference trajectory "
                             f"{TRAIN_REF_LOSSES_SEED0} by {ref_gap:.4f}")
    return info


def _md_world(fn, world: int, work: Path, *args, timeout_s: float) -> list:
    """``fn(rank, world, store_path, work, *args)`` on ``world`` spawned
    processes (torch.multiprocessing, spawn), each joining the process
    group through a FileStore in ``work``; returns each rank's result
    (``rank<r>.pt``).  A rank's exception fails the call (its traceback
    raised here), and so does the world outliving ``timeout_s``: its
    processes are killed first."""
    import torch
    work.mkdir(parents=True, exist_ok=True)
    ctx = torch.multiprocessing.start_processes(
        _md_entry, args=(fn, world, str(work), args), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"multidevice: a world of {world} still ran after {timeout_s} s")
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _md_entry(rank: int, fn, world: int, work: str, args: tuple) -> None:
    import torch
    import_port()
    out = fn(rank, world, str(Path(work) / "store"), Path(work), *args)
    torch.save(out, Path(work) / f"rank{rank}.pt")


class _FlashCalls:
    """(query rows, heads, kernel) of each flash forward launched while
    active: the wrapper ``mha`` calls, noted around it."""

    def __enter__(self):
        import tdax_torch.ops.flash_attention as fa
        self.fa, self.calls, self.orig = fa, [], fa.flash_attention

        def noted(q, k, v, *args, **kw):
            self.calls.append((q.shape[1], q.shape[2], fa._route(q, k, v)))
            return self.orig(q, k, v, *args, **kw)

        fa.flash_attention = noted
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention = self.orig


class _TimedCollectives:
    """Count, bytes and host seconds of every mesh all_reduce, all_gather,
    reduce_scatter, ppermute and send_recv while active, by
    axis and kind ("tp.all_reduce", "dp.all_gather", "dcn+dp.all_reduce",
    "cp.ppermute", "pp.ppermute" for a send_recv, ...), a call counted
    once: the bytes of each result on this rank (a ppermute's: of every
    tensor it moved, counted once per op; a send_recv's: of what it
    received), the
    device synchronised before and after each, so the time is the
    collective's, gloo's host staging included.  ``total(kind)`` sums a
    kind over the axes."""

    _KINDS = {"all_reduce": "all_reduce", "all_gather": "all_gather",
              "reduce_scatter": "reduce_scatter", "_exchange": "ppermute",
              "send_recv": "ppermute"}

    def __enter__(self):
        from tdax_torch.parallel import mesh as pm
        self.pm, self.stats = pm, {}
        self.orig = {name: getattr(pm, name) for name in self._KINDS}
        for name, fn in self.orig.items():
            setattr(pm, name, self._timed(self._KINDS[name], fn))
        return self

    def _timed(self, kind, fn):
        import torch

        def timed(x, mesh, axis, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, mesh, axis, *args, **kw)
            torch.cuda.synchronize()
            rec = self.stats.setdefault(f"{self.pm.axis_label(axis)}.{kind}",
                                        {"count": 0, "bytes": 0, "seconds": 0.0})
            rec["count"] += 1
            rec["bytes"] += sum(t.numel() * t.element_size()
                                for t in (out if isinstance(out, list) else [out]))
            rec["seconds"] += time.perf_counter() - t0
            return out

        return timed

    def total(self, kind: str) -> dict:
        recs = [r for key, r in self.stats.items() if key.endswith("." + kind)]
        return {f: sum(r[f] for r in recs) for f in ("count", "bytes", "seconds")}

    def __exit__(self, *exc):
        for kind, fn in self.orig.items():
            setattr(self.pm, kind, fn)


def _md_stage(rec: dict, name: str, fn):
    """fn()'s result; rec[name] its wall (synchronised host clock), its
    gathers (calls, the bytes they brought to this rank, their seconds)
    and its all_reduces (calls, seconds)."""
    import torch
    torch.cuda.synchronize()
    with _TimedCollectives() as tc:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    g, r = tc.total("all_gather"), tc.total("all_reduce")
    rec[name] = {"wall_s": wall, "gathers": g["count"], "gathered_bytes": g["bytes"],
                 "gather_s": g["seconds"], "all_reduces": r["count"],
                 "all_reduce_s": r["seconds"]}
    return out


def _md_sweep(rec: dict, data_dir: str, out_dir: Path) -> dict:
    """run_tda_sweep of phase capture's activations under the process group
    (the layers split over its ranks), as phase sweep runs it."""
    from tdax_torch.config import SweepConfig
    from tdax_torch.data.io import load_activations
    from tdax_torch.pipeline.tda_sweep import run_tda_sweep
    all_data = load_activations(str(Path(data_dir) / "all_activations.npz"))
    return _md_stage(rec, "sweep", lambda: run_tda_sweep(
        all_data, str(Path(data_dir) / "metadata.json"),
        SweepConfig(output_dir=str(out_dir), save_diagrams=False), verbose=False))


def _md_sweep_ref(sweep_dir: str) -> tuple:
    """Phase sweep's stats, clouds and peak layer (one device, the same capture)."""
    import numpy as np
    from tdax_torch.pipeline.tda_sweep import peak
    d = Path(sweep_dir)
    stats = json.loads((d / "summary_stats.json").read_text())
    clouds = np.stack([np.load(d / "point_clouds_3d" / f"layer_{i}_cloud.npy")
                       for i in range(len(stats))])
    return stats, clouds, peak(stats, "shape_silhouette")


def _md_scale_inputs(device):
    """The scale cloud on the card and its sparse path's threshold (the
    median over 512 rows of the SCALE_DEGREE-th distance)."""
    import torch
    from tdax_torch.pipeline.scale import _select_threshold
    x = torch.as_tensor(scale_cloud()[0]).to(device)
    return x, _select_threshold(x, SCALE_N, SCALE_DEGREE)


def _digest(*arrays) -> str:
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _md_nccl_sweep_scale(device, data_dir: str, sweep_dir: str, work: Path) -> dict:
    """(a) Stages 2 and 3 in the NCCL world of one: the sweep against phase
    sweep's, the gathered matrix against the expansion form, the dense
    and the sparse scale paths (see the module's docstring)."""
    import numpy as np
    import torch
    import tdax_torch.ops.sqdist as sqdist
    from tdax_torch.parallel import mesh as pm
    from tdax_torch.pipeline.scale import (_expansion_rows, distance_matrix, rips_at_scale,
                                           rips_at_scale_sparse)

    torch.cuda.reset_peak_memory_stats()
    pm.COLLECTIVES.clear()
    rec = {}
    res = _md_sweep(rec, data_dir, work / "sweep")
    stats, clouds, peak_layer = _md_sweep_ref(sweep_dir)
    rec["sweep"].update(stats_equal=res["stats"] == stats,
                        clouds_bitwise=bool(np.array_equal(res["clouds_3d"], clouds)),
                        peak_layer=res["peak_layer"], one_device_peak_layer=peak_layer,
                        timings=res["timings"])
    del res
    x, thresh = _md_scale_inputs(device)
    mesh = pm.make_mesh()
    sqdist.LAUNCHES = sqdist.LAUNCHES_SM90 = sqdist.SPLIT_LAUNCHES = 0
    d = _md_stage(rec, "distance_matrix", lambda: distance_matrix(x, mesh=mesh))
    sq = (x * x).sum(1)
    ref = _expansion_rows(x, x, sq, sq)
    rec["distance_matrix"]["bitwise_expansion_form"] = bool(torch.equal(d, (ref + ref.T).mul_(0.5)))
    del d, ref
    dense = _md_stage(rec, "rips_at_scale", lambda: rips_at_scale(
        x, maxdim=MD_SCALE_MAXDIM, thresh=thresh, mesh=mesh))
    rec["rips_at_scale"].update(bars=[int(len(g)) for g in dense["dgms"]],
                                timings=dense["timings"])
    sp = _md_stage(rec, "rips_at_scale_sparse", lambda: rips_at_scale_sparse(
        x, mesh=mesh, **MD_SPARSE_KW))
    rec["mesh_sqdist_launches"] = list(_sqdist_counts(sqdist))
    one = _md_stage(rec, "rips_at_scale_sparse_one_device", lambda: rips_at_scale_sparse(
        x, **MD_SPARSE_KW))
    rec["rips_at_scale_sparse"].update(
        n_edges=sp["n_edges"], n_edges_one_device=one["n_edges"], thresh=sp["thresh"],
        bars=[int(len(g)) for g in sp["dgms"]], timings=sp["timings"],
        dgms_bitwise_one_device=len(sp["dgms"]) == len(one["dgms"]) and all(
            np.array_equal(a, b) for a, b in zip(sp["dgms"], one["dgms"])))
    rec.update(thresh=thresh, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               collectives=dict(pm.COLLECTIVES))
    return rec


def _pdist_corr(a, b) -> float:
    """tdax's stage-2 measure: the correlation of two embeddings' pairwise distances."""
    import numpy as np

    def pdist(e):
        return np.linalg.norm(e[:, None] - e[None, :], axis=-1).ravel()
    return float(np.corrcoef(pdist(a), pdist(b))[0, 1])


def _md_knn_check(x, idx, dists) -> dict:
    """Rank 0's check of sharded_knn's rows against the true-f32 expansion
    form of the whole cloud in one product (tdax's stage-3 gate, its 1e-5
    taken relative as max(1, d) takes it): a row that differs must differ
    in neighbours whose distances lie within MD_KNN_TIE of each other, and
    its distances must be the k smallest within the same."""
    import numpy as np
    import torch
    from tdax_torch.pipeline.scale import _expansion_rows
    sq = (x * x).sum(1)
    d = _expansion_rows(x, x, sq, sq)
    ref_d, ref_idx = torch.topk(d, MD_KNN_K, dim=1, largest=False, sorted=True)
    got = torch.as_tensor(idx, device=x.device).long()
    got_d = torch.as_tensor(dists, device=x.device)
    rows = torch.nonzero((got.sort(1).values != ref_idx.sort(1).values).any(1)).flatten().tolist()
    worst_tie = worst_dist = 0.0
    for i in rows:
        dv = d[i, sorted(set(got[i].tolist()) ^ set(ref_idx[i].tolist()))]
        worst_tie = max(worst_tie, float(dv.max() - dv.min()) / max(1.0, float(dv.max())))
        worst_dist = max(worst_dist, float((got_d[i] - ref_d[i]).abs().max())
                         / max(1.0, float(ref_d[i].max())))
    ascending = bool(np.all(np.diff(dists, axis=1) >= 0))
    return {"rows": int(len(idx)), "rows_differing": len(rows),
            "worst_tie_spread_rel": worst_tie, "worst_dist_err_rel": worst_dist,
            "max_abs_dist_err_all_rows": float((got_d - ref_d).abs().max()),
            "ascending": ascending,
            "ok": ascending and worst_tie <= MD_KNN_TIE and worst_dist <= MD_KNN_TIE}


def _md_true_f32_dgms(x, thresh: float) -> list:
    """rips_at_scale's diagrams from one device's true-f32 matrix: the
    expansion form in one product (the arithmetic the mesh path shares
    with tdax's), symmetrised, H0 by Boruvka on the card, H1 in the
    engine."""
    from tdax_torch.ops.rips import rips_from_distances
    from tdax_torch.ops.rips.mst import h0_diagram_device
    from tdax_torch.pipeline.scale import _expansion_rows
    sq = (x * x).sum(1)
    d = _expansion_rows(x, x, sq, sq)
    d = (d + d.T).mul_(0.5)
    dgms = rips_from_distances(d.cpu().numpy(), maxdim=MD_SCALE_MAXDIM, thresh=thresh)["dgms"]
    dgms[0] = h0_diagram_device(d, thresh)
    return dgms


def _md_gloo_sweep_scale(rank: int, device, data_dir: str, sweep_dir: str,
                         work: Path) -> dict:
    """(b) Stages 2 and 3 over four gloo ranks at dp=4, with rank 0's
    one-device references (see the module's docstring).  Every rank
    returns its walls, gathers, peak memory and collectives and the
    digests of its results; rank 0 the comparisons too."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import tdax_torch.ops.sqdist as sqdist
    from tdax_torch.metrics.persistence import bottleneck_distance
    from tdax_torch.parallel import mesh as pm
    from tdax_torch.parallel.sharded_ops import sharded_knn
    from tdax_torch.pipeline.scale import rips_at_scale, rips_at_scale_sparse

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pm.COLLECTIVES.clear()
    rec, cmp = {}, {}
    mesh = pm.make_mesh(dp=4)
    res = _md_sweep(rec, data_dir, work / "sweep")
    if rank == 0:
        stats, clouds, peak_layer = _md_sweep_ref(sweep_dir)
        cmp["sweep"] = {
            "peak_layer": res["peak_layer"], "one_device_peak_layer": peak_layer,
            "max_silhouette_diff": max(abs(a[k] - b[k]) for a, b in zip(res["stats"], stats)
                                       for k in ("silhouette_shape", "silhouette_color")),
            "max_h1_diff": max(abs(a["max_h1_persistence"] - b["max_h1_persistence"])
                               for a, b in zip(res["stats"], stats)),
            "pdist_corr": [_pdist_corr(g, w) for g, w in zip(res["clouds_3d"], clouds)],
            "timings": res["timings"]}
    digests = {"sweep": _digest(res["clouds_3d"]), "sweep_peak": res["peak_layer"]}
    del res

    x, thresh = _md_scale_inputs(device)
    sqdist.LAUNCHES = sqdist.LAUNCHES_SM90 = sqdist.SPLIT_LAUNCHES = 0
    idx, dists = _md_stage(rec, "sharded_knn", lambda: sharded_knn(x, MD_KNN_K, mesh))
    digests["knn"] = _digest(idx, dists)
    if rank == 0:
        cmp["knn"] = _md_knn_check(x, idx, dists)
    dist.barrier()
    dense = _md_stage(rec, "rips_at_scale", lambda: rips_at_scale(
        x, maxdim=MD_SCALE_MAXDIM, thresh=thresh, mesh=mesh))
    sp = _md_stage(rec, "rips_at_scale_sparse", lambda: rips_at_scale_sparse(
        x, mesh=mesh, **MD_SPARSE_KW))
    rec["mesh_sqdist_launches"] = list(_sqdist_counts(sqdist))
    digests.update(dense=_digest(*dense["dgms"]), sparse=_digest(*sp["dgms"]),
                   sparse_n_edges=sp["n_edges"])
    if rank == 0:
        one = _md_stage(rec, "rips_at_scale_one_device", lambda: rips_at_scale(
            x, maxdim=MD_SCALE_MAXDIM, thresh=thresh))
        one_launches = list(_sqdist_counts(sqdist))
        f32 = _md_stage(rec, "rips_true_f32_one_device", lambda: _md_true_f32_dgms(x, thresh))
        one_sp = _md_stage(rec, "rips_at_scale_sparse_one_device", lambda: rips_at_scale_sparse(
            x, **MD_SPARSE_KW))
        cmp["rips_at_scale"] = {
            "bottleneck_per_dim": [bottleneck_distance(a, b)
                                   for a, b in zip(dense["dgms"], f32)],
            "bitwise_true_f32_one_device": all(np.array_equal(a, b)
                                               for a, b in zip(dense["dgms"], f32)),
            "bottleneck_per_dim_vs_3xtf32": [bottleneck_distance(a, b)
                                             for a, b in zip(dense["dgms"], one["dgms"])],
            "bars": [int(len(g)) for g in dense["dgms"]],
            "bars_one_device": [int(len(g)) for g in one["dgms"]],
            "one_device_sqdist_launches": one_launches,
            "timings": dense["timings"], "one_device_timings": one["timings"]}
        cmp["rips_at_scale_sparse"] = {
            "n_edges": sp["n_edges"], "n_edges_one_device": one_sp["n_edges"],
            "bottleneck_per_dim": [bottleneck_distance(a, b)
                                   for a, b in zip(sp["dgms"], one_sp["dgms"])],
            "bars": [int(len(g)) for g in sp["dgms"]], "timings": sp["timings"]}
    dist.barrier()
    return {"stages": rec, "compared": cmp, "digests": digests, "thresh": thresh,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "collectives": dict(pm.COLLECTIVES)}


def _train_launches() -> dict:
    import tdax_torch.ops.flash_attention as fa
    return {"flash_fwd": fa.LAUNCHES, "flash_fwd_sm90": fa.LAUNCHES_SM90,
            "flash_bwd_dq": fa.BWD_DQ_LAUNCHES, "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES,
            "flash_bwd_dq_sm90": fa.BWD_DQ_LAUNCHES_SM90,
            "flash_bwd_dkv_sm90": fa.BWD_DKV_LAUNCHES_SM90}


def _zero_train_launches() -> None:
    import tdax_torch.ops.flash_attention as fa
    fa.LAUNCHES = fa.LAUNCHES_SM90 = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    fa.BWD_DQ_LAUNCHES_SM90 = fa.BWD_DKV_LAUNCHES_SM90 = 0


def _expected_train_launches(layers: int, steps: int) -> dict:
    """A remat step's flash launches: a forward and its replay a layer,
    one dq and one dk/dv launch a layer, all on the sm90 kernels."""
    fwd, bwd = 2 * layers * steps, layers * steps
    return {"flash_fwd": fwd, "flash_fwd_sm90": fwd, "flash_bwd_dq": bwd,
            "flash_bwd_dkv": bwd, "flash_bwd_dq_sm90": bwd, "flash_bwd_dkv_sm90": bwd}


def _md_umap_args(n: int) -> tuple:
    """embed_sparse's arguments as UMAP.fit passes them for bench_umap.py's
    reducer (cosine, k 15, 3-d, random_state 42) at n points."""
    from tdax_torch.ops.umap import UMAP
    from tdax_torch.ops.umap.umap import _default_epochs
    u = UMAP(n_neighbors=UMAP_K, n_components=3, metric="cosine", random_state=42)
    return (min(u.n_neighbors, n - 1), u.n_components, u.metric,
            _default_epochs(n, u.n_epochs), u.random_state, u._a, u._b, u.learning_rate,
            u.negative_sample_rate, u.repulsion_strength, u.local_connectivity,
            u.set_op_mix_ratio)


def _md_transform_args(n_train: int, n_new: int) -> tuple:
    """transform_sparse's arguments after the train points, as
    UMAP.transform passes them for the same reducer."""
    from tdax_torch.ops.umap import UMAP
    from tdax_torch.ops.umap.umap import _transform_epochs
    u = UMAP(n_neighbors=UMAP_K, n_components=3, metric="cosine", random_state=42)
    return (min(u.n_neighbors, n_train), u.metric, _transform_epochs(u.n_epochs, n_new),
            u.random_state, u._a, u._b, u.learning_rate, u.negative_sample_rate,
            u.repulsion_strength, u.local_connectivity)


def _md_nccl_umap(device, ref: dict) -> dict:
    """(a) embed_sparse(mesh=) at UMAP_N and UMAP_LARGE_N x 4096 and
    transform_sparse(mesh=) of UMAP_TRANSFORM_N points against phase
    umap_sparse's one-device embedding, in the NCCL world of one: each
    against phase umap_sparse's own result, bitwise."""
    import numpy as np
    import torch
    from tdax_torch.ops.umap.sparse_path import LAST_TIMINGS, embed_sparse, transform_sparse
    from tdax_torch.parallel import mesh as pm

    mesh = pm.make_mesh()
    rec = {}
    x, _, x_new, _ = umap_cloud(UMAP_N, n_new=UMAP_TRANSFORM_N)
    xd = torch.as_tensor(x).to(device)
    emb = _md_stage(rec, "embed_sparse", lambda: embed_sparse(xd, *_md_umap_args(UMAP_N),
                                                              mesh=mesh))
    rec["embed_sparse"]["timings"] = dict(LAST_TIMINGS)
    tr = _md_stage(rec, "transform_sparse", lambda: transform_sparse(
        x_new, xd, ref["embedding"], *_md_transform_args(UMAP_N, UMAP_TRANSFORM_N),
        mesh=mesh))
    del xd
    x_large, _ = umap_cloud(UMAP_LARGE_N)
    large = _md_stage(rec, "embed_sparse_large", lambda: embed_sparse(
        x_large, *_md_umap_args(UMAP_LARGE_N), device=device, mesh=mesh))
    rec["embed_sparse_large"]["timings"] = dict(LAST_TIMINGS)
    rec.update(embed_bitwise=bool(np.array_equal(emb, ref["embedding"])),
               transform_bitwise=bool(np.array_equal(tr, ref["transform"])),
               embed_large_bitwise=bool(np.array_equal(large, ref["embedding_large"])))
    return rec


def _md_nccl_train(device, ref: dict, fsdp: bool = False) -> dict:
    """(a) phase train's first step in the NCCL world of one: the full
    QwenVLConfig() decoder (text-only, bf16, remat), its init and batch
    from ``ref['seed']``, inside flash_sharding over the dp=1 tp=1 mesh;
    its loss and fingerprint against phase train's after its warm step
    (whose learning rate is 0: the params are the init, AdamW's moments
    carry the gradient's bits).  With ``fsdp`` the step runs under
    fsdp_sharding_rules at dp=1: every large leaf gathered (over a group
    of one) where a block reads it, its gradient reduce-scattered."""
    import torch
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.ops.flash_attention import flash_sharding
    from tdax_torch.parallel import default_optimizer, make_train_step, warmup_cosine_lr
    from tdax_torch.parallel import mesh as pm

    cfg = QwenVLConfig()
    mesh = pm.make_mesh()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, device, seed=ref["seed"], with_visual=False)
    kw = {}
    if fsdp:
        rules = pm.fsdp_sharding_rules(params, mesh)
        params = pm.shard_params(params, mesh, rules, cfg=cfg)  # dp = 1: the same tensors
        kw["param_shardings"] = pm.named_shardings(mesh, rules)
    opt = default_optimizer(warmup_cosine_lr(1e-4, 2, 8))
    state = opt.init(params)
    step = make_train_step(cfg, opt, remat=True, device=device, **kw)
    batch = _train_batch(cfg, ref["seed"], device)
    _zero_train_launches()
    pm.COLLECTIVES.clear()
    pm.COLLECTIVES_BY_AXIS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with flash_sharding(mesh, "dp", "tp"):
        params, state, loss = step(params, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fingerprint = _train_fingerprint(params, state)
    return {"step_s": wall, "loss": float(loss),
            "loss_bitwise_phase_train": _f32_bits(loss) == ref["loss_bits"],
            "fingerprint_bitwise_phase_train": fingerprint == ref["fingerprint"],
            "leaves_fingerprinted": len(fingerprint), "launches": _train_launches(),
            "collectives": dict(pm.COLLECTIVES),
            "collectives_by_axis": dict(pm.COLLECTIVES_BY_AXIS),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def _max_rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f32, 8192 rows of dim 0 at a time."""
    err = top = 0.0
    for r0 in range(0, want.shape[0], 8192):
        a, b = got[r0:r0 + 8192].float(), want[r0:r0 + 8192].float()
        err = max(err, float((a - b).abs().max()))
        top = max(top, float(b.abs().max()))
    return err / max(top, 1e-30)


def _md_train_rows(whole: dict, mesh, accum: int) -> dict:
    """This rank's rows of the training batch over the mesh's batch axis;
    with ``accum`` the batch cut into that many microbatches first, each
    split over the batch axis (tdax's [accum, b / accum, ...] batch)."""
    import torch
    from tdax_torch.parallel import mesh as pm
    if accum == 1:
        return {k: pm.split_batch(v, mesh) for k, v in whole.items()}
    return {k: torch.stack([pm.split_batch(m, mesh)
                            for m in v.reshape(accum, v.shape[0] // accum, *v.shape[1:])])
            for k, v in whole.items()}


def _md_gloo_train(rank: int, device) -> dict:
    """(b) Training on the four gloo ranks (MD_TRAIN_* constants): rank 0's
    one-device reference steps first (its updated tree kept as each run's
    shard, the rest freed), then every rank's runs, each from the seed-0
    init sharded: at dp=2 tp=2 the plain steps, the sequence-parallel
    steps and the FSDP steps (MD_FSDP_ACCUM microbatches, tdax's stage
    11), then the FSDP step on the hybrid mesh at dcn=2 dp=2 tp=1 (stage
    12, MD_HYBRID_STEPS step).  Per run the losses, each step's wall, the
    flash launches, the collectives by axis (count, bytes, seconds) and
    the peak memory; under FSDP the local and whole sizes of
    layers/attn_qkv_w and its moments; rank 0 also each step's loss error
    and each leaf of its updated shard's max relative error against one
    device."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.ops.flash_attention import flash_sharding
    from tdax_torch.parallel import default_optimizer, make_train_step
    from tdax_torch.parallel import mesh as pm

    cfg = dataclasses.replace(QwenVLConfig(), num_layers=MD_TRAIN_LAYERS)
    mesh = pm.make_mesh(dp=2, tp=2)
    hybrid = pm.make_hybrid_mesh(dcn=2, dp=2, tp=1)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, (MD_TRAIN_BATCH, MD_TRAIN_SEQ))
    mask = np.ones((MD_TRAIN_BATCH, MD_TRAIN_SEQ), np.int32)
    mask[-1, -MD_TRAIN_MASKED:] = 0
    whole = {"input_ids": torch.as_tensor(ids, device=device).long(),
             "attn_mask": torch.as_tensor(mask, device=device)}
    # (name, mesh, FSDP or not, microbatches, steps, step keywords)
    runs = [("plain", mesh, False, 1, MD_TRAIN_STEPS, {}),
            ("sp", mesh, False, 1, MD_TRAIN_STEPS, {"sp_mesh": mesh}),
            ("fsdp", mesh, True, MD_FSDP_ACCUM, MD_TRAIN_STEPS, {}),
            ("hybrid_fsdp", hybrid, True, 1, MD_HYBRID_STEPS, {})]

    def rules_of(tree, m, fsdp):
        return pm.fsdp_sharding_rules(tree, m) if fsdp else None

    gc.collect()
    torch.cuda.empty_cache()
    out = {"mem_free_before_bytes": torch.cuda.mem_get_info()[0]}
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, device, seed=0, with_visual=False)
        opt = default_optimizer(MD_TRAIN_LR)
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat=True, device=device)
        t0 = time.perf_counter()
        ref_losses = [float(step(params, state, whole)[2]) for _ in range(MD_TRAIN_STEPS)]
        out["one_device"] = {"losses": ref_losses, "wall_s": time.perf_counter() - t0,
                             "params": sum(t.numel() for t in _md_leaves(params)),
                             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        # rank 0's shard of the updated tree under each run's mesh and rules
        # (no collective: shard_params only slices)
        ref_local = {name: pm.shard_params(params, m, rules_of(params, m, fsdp), cfg=cfg)
                     for name, m, fsdp, _, _, _ in runs}
        del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    for name, m, fsdp, accum, n_steps, kw in runs:
        torch.cuda.reset_peak_memory_stats()
        full = init_params(cfg, device, seed=0, with_visual=False)
        rules = rules_of(full, m, fsdp)
        local = pm.shard_params(full, m, rules, cfg=cfg)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        opt = default_optimizer(MD_TRAIN_LR)
        state = opt.init(local)
        if rules is not None:
            kw = {**kw, "param_shardings": pm.named_shardings(m, rules)}
        step = make_train_step(cfg, opt, remat=True, device=device, accum_steps=accum, **kw)
        rows = _md_train_rows(whole, m, accum)
        _zero_train_launches()
        losses, walls = [], []
        with flash_sharding(m, m.batch_axis, "tp"), _TimedCollectives() as tc:
            for _ in range(n_steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, state, loss = step(local, state, rows)
                losses.append(float(loss))
                walls.append(time.perf_counter() - t0)
        rec = {"losses": losses, "step_s": walls, "launches": _train_launches(),
               "local_params": sum(t.numel() for t in _md_leaves(local)),
               "collectives": tc.stats,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        if rules is not None:
            rec["attn_qkv_w"] = {
                "whole": cfg.num_layers * cfg.hidden_size * 3 * cfg.hidden_size,
                **{k: t["layers"]["attn_qkv_w"].numel()
                   for k, t in (("params", local), ("mu", state.mu), ("nu", state.nu))}}
        if rank == 0:
            rec["loss_rel_err"] = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
            # a zero-init bias whose gradient is zero in exact arithmetic
            # (the key third of attn_qkv_b) takes Adam's near-sign steps
            # on rounding noise: relative errors near 2 there
            rec["param_rel_err_by_leaf"] = {
                path: _max_rel_err(a, b) for (path, a), (_, b) in zip(
                    _md_named_leaves(local), _md_named_leaves(ref_local[name]))}
        out[name] = rec
        del local, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _md_umap_knn_check(xd, idx, dists) -> dict:
    """Rank 0's check of knn_blocked(mesh=)'s cosine rows against one
    device's: a row that differs must differ in neighbours whose
    distances lie within MD_KNN_TIE (relative to max(1, d)) of each
    other, and its distances must be one device's within the same."""
    import torch
    from tdax_torch.ops.umap.sparse_path import knn_blocked
    ref_idx, ref_d = knn_blocked(xd, UMAP_K, "cosine")
    xn = xd / torch.linalg.vector_norm(xd, dim=1, keepdim=True).clamp_min(1e-30)
    exact = (idx == ref_idx).all(1) & (dists == ref_d).all(1)
    rows = torch.nonzero(~exact).flatten().tolist()
    worst_tie = worst_dist = 0.0
    for i in rows:
        disputed = sorted(set(idx[i].tolist()) ^ set(ref_idx[i].tolist()))
        if disputed:
            dv = (1.0 - xn[disputed] @ xn[i]).clamp(0.0, 2.0)
            worst_tie = max(worst_tie, float(dv.max() - dv.min()) / max(1.0, float(dv.max())))
        worst_dist = max(worst_dist, float((dists[i] - ref_d[i]).abs().max()))
    return {"rows": int(idx.shape[0]), "rows_not_exact": len(rows),
            "worst_tie_spread_rel": worst_tie, "worst_dist_err": worst_dist,
            "ok": worst_tie <= MD_KNN_TIE and worst_dist <= MD_KNN_TIE}


def _md_gloo_umap(rank: int, device, ref: dict) -> dict:
    """(b) the edge-list UMAP at dp=4 on bench_umap.py's UMAP_N x 4096:
    embed_sparse(mesh=) (rank 0: its planted-cluster silhouette, the
    placement of a transform_sparse(mesh=) against it, its pairwise-
    distance correlation with phase umap_sparse's embedding on a
    2000-point subsample), transform_sparse(mesh=) against phase
    umap_sparse's embedding (rank 0: bitwise its transform) and
    knn_blocked(mesh=) (rank 0: against one device's); every rank's
    digests and stage walls."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tdax_torch.ops.umap.sparse_path import embed_sparse, knn_blocked, transform_sparse
    from tdax_torch.parallel import mesh as pm

    mesh = pm.make_mesh(dp=4)
    rec, cmp = {}, {}
    x, labels, x_new, labels_new = umap_cloud(UMAP_N, n_new=UMAP_TRANSFORM_N)
    xd = torch.as_tensor(x).to(device)
    targs = _md_transform_args(UMAP_N, UMAP_TRANSFORM_N)
    emb = _md_stage(rec, "embed_sparse", lambda: embed_sparse(xd, *_md_umap_args(UMAP_N),
                                                              mesh=mesh))
    own = _md_stage(rec, "transform_sparse_own_fit", lambda: transform_sparse(
        x_new, xd, emb, *targs, mesh=mesh))
    tr = _md_stage(rec, "transform_sparse", lambda: transform_sparse(
        x_new, xd, ref["embedding"], *targs, mesh=mesh))
    idx, dists = _md_stage(rec, "knn_blocked", lambda: knn_blocked(xd, UMAP_K, "cosine",
                                                                   mesh=mesh))
    digests = {"embed": _digest(emb), "transform": _digest(tr),
               "knn": _digest(idx.cpu().numpy(), dists.cpu().numpy())}
    if rank == 0:
        sub = np.random.default_rng(0).choice(UMAP_N, min(UMAP_N, 2000), replace=False)
        cmp = {"silhouette_8clusters": _subsample_silhouette(emb, labels),
               "placed": float((_nearest_centroid(emb, labels, own) == labels_new).mean()),
               "pdist_corr_one_device": _pdist_corr(emb[sub], ref["embedding"][sub]),
               "transform_bitwise_one_device": bool(np.array_equal(tr, ref["transform"])),
               "transform_max_abs_err": float(np.abs(tr - ref["transform"]).max()),
               "knn": _md_umap_knn_check(xd, idx, dists)}
    dist.barrier()
    return {"stages": rec, "compared": cmp, "digests": digests}


def _visible_rows(kv, causal: bool):
    """[B, T] bool: the query rows that see a valid key (tdax's _row_ok)."""
    import torch
    if causal:
        return torch.cumsum(kv, dim=1) > 0
    return kv.any(dim=1, keepdim=True).expand_as(kv)


def _ring_bf16_excess(got, want, cp: int) -> float:
    """max over the elements of |got - want| / the ring's bf16 bound (see
    MD_RING_CASES' note): at most 1 where the bound holds.  Rows: dim 1."""
    import torch
    want, got = want.float(), got.float()
    row = want.abs().amax(dim=(2, 3), keepdim=True)
    bound = (BWD_BF16_RTOL * want.abs()
             + cp * (BWD_BF16_ATOL_OF_MAX + BWD_BF16_TERMS) * row)
    return float(((got - want).abs() / bound.clamp_min(torch.finfo(torch.float32).tiny)).max())


def _ring_expected(case_causal: bool, contiguous: bool, cp: int, my: int) -> int:
    """The flash launches of each kind one rank's ring makes in a forward
    (and its dq and dk/dv launches in the backward): one a step, but a
    causal contiguous ring skips the my + 1 .. cp - 1 chunks."""
    return my + 1 if case_causal and contiguous else cp


def _md_ring_case(mesh, device, shape, dtype, causal, ragged, contiguous, seed) -> dict:
    """One ring case on this rank (see MD_RING_CASES): the one-device
    FlashAttention of the whole sequence first, then the ring on this
    rank's chunk, its launches counted (set to 0 just before, read just
    after), its permutes timed; this rank's errors against one device."""
    import os
    import torch
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.parallel import mesh as pm

    b, t, nh, hd = shape
    cp, my = mesh.shape["cp"], mesh.local_rank("cp")
    tl = t // cp
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3))
    kv = torch.ones((b, t), dtype=torch.int32, device=device)
    if ragged:
        kv = (torch.rand((b, t), generator=gen, device=device) > 0.2).to(torch.int32)
        kv[1, :tl] = 0  # one chunk wholly invalid for one row
    w = kv[:, :, None, None].float()
    one = [x.clone().requires_grad_() for x in (q, k, v)]
    o_one = fa.mha(*one, fa.AttnSpec(kv_valid=kv, causal=causal))
    (torch.sin(o_one.float()) * w).sum().backward()
    rows = slice(my * tl, (my + 1) * tl)
    loc = [x[:, rows].clone().requires_grad_() for x in (q, k, v)]
    if contiguous:
        os.environ["TDAX_NO_ZIGZAG"] = "1"
    torch.cuda.synchronize()
    _zero_train_launches()
    try:
        with _TimedCollectives() as tc:
            t0 = time.perf_counter()
            with fa.flash_sharding(mesh, "dp", "tp", seq_axis="cp"):
                o = fa.mha(*loc, fa.AttnSpec(kv_valid=kv[:, rows], causal=causal))
            (torch.sin(o.float()) * w[:, rows]).sum().backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        os.environ.pop("TDAX_NO_ZIGZAG", None)
    launches = _train_launches()
    seen = _visible_rows(kv, causal)[:, rows, None, None]
    want = [o_one[:, rows].detach() * seen] + [x.grad[:, rows] for x in one]
    got = [o.detach() * seen] + [x.grad for x in loc]
    rec = {"wall_s": wall, "launches": launches, "permutes": tc.stats,
           "max_abs_err": {name: float((a.float() - b.float()).abs().max())
                           for name, a, b in zip(("o", "dq", "dk", "dv"), got, want)}}
    if dtype == torch.float32:
        fwd_ok = rec["max_abs_err"]["o"] <= MD_RING_FWD_TOL
        grads_ok = all(torch.allclose(a, b, **MD_RING_GRAD_TOL) for a, b in zip(got[1:], want[1:]))
        rec["within_tol"] = bool(fwd_ok and grads_ok)
    else:
        rec["bound_excess"] = {name: _ring_bf16_excess(a, b, cp)
                               for name, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
        rec["within_tol"] = max(rec["bound_excess"].values()) <= 1.0
    n = _ring_expected(causal, contiguous, cp, my)
    sm90 = n if dtype == torch.bfloat16 else 0
    rec["launches_as_scheduled"] = launches == {
        "flash_fwd": n, "flash_fwd_sm90": sm90, "flash_bwd_dq": n, "flash_bwd_dkv": n,
        "flash_bwd_dq_sm90": sm90, "flash_bwd_dkv_sm90": sm90}
    return rec


def _md_gloo_ring(rank: int, device) -> dict:
    """(b) The ring alone on the four gloo ranks at dp=1 tp=1 cp=MD_RING_CP:
    MD_RING_CASES in bf16 at MD_RING_SHAPE, then in f32 at
    MD_RING_F32_SHAPE; each case's record from every rank."""
    import torch
    import torch.distributed as dist
    from tdax_torch.parallel import mesh as pm

    mesh = pm.make_mesh(dp=1, tp=1, cp=MD_RING_CP)
    out = {}
    for dtype, shape in ((torch.bfloat16, MD_RING_SHAPE), (torch.float32, MD_RING_F32_SHAPE)):
        for i, (name, causal, ragged, contiguous) in enumerate(MD_RING_CASES):
            label = f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
            out[label] = _md_ring_case(mesh, device, shape, dtype, causal, ragged, contiguous,
                                       seed=100 + i)
            gc.collect()
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def _md_gloo_cp_train(rank: int, device) -> dict:
    """(b) The cp training step on the four gloo ranks: MD_TRAIN_LAYERS
    full-width layers at dp=1 tp=2 cp=2, remat, MD_CP_BATCH x MD_CP_SEQ ids
    with the last MD_CP_MASKED positions of every row masked;
    MD_TRAIN_STEPS steps from the seed-0 init against rank 0's one-device
    steps (computed and freed first).  Per rank the losses, each step's
    wall, the flash launches, the collectives by axis (count, bytes,
    seconds) and the peak memory; rank 0 also each loss's relative error."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import default_optimizer, make_train_step
    from tdax_torch.parallel import mesh as pm

    cfg = dataclasses.replace(QwenVLConfig(), num_layers=MD_TRAIN_LAYERS)
    mesh = pm.make_mesh(dp=1, tp=2, cp=2)
    rng = np.random.default_rng(0)
    mask = np.ones((MD_CP_BATCH, MD_CP_SEQ), np.int32)
    mask[:, -MD_CP_MASKED:] = 0
    whole = {"input_ids": torch.as_tensor(rng.integers(1, cfg.vocab_size, mask.shape),
                                          device=device).long(),
             "attn_mask": torch.as_tensor(mask, device=device)}
    gc.collect()
    torch.cuda.empty_cache()
    out = {"mesh": dict(mesh.shape), "cp_rank": mesh.local_rank("cp"),
           "tp_rank": mesh.local_rank("tp")}
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, device, seed=0, with_visual=False)
        opt = default_optimizer(MD_TRAIN_LR)
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat=True, device=device)
        t0 = time.perf_counter()
        ref = [float(step(params, state, whole)[2]) for _ in range(MD_TRAIN_STEPS)]
        out["one_device"] = {"losses": ref, "wall_s": time.perf_counter() - t0,
                             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    full = init_params(cfg, device, seed=0, with_visual=False)
    local = pm.shard_params(full, mesh, cfg=cfg)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    opt = default_optimizer(MD_TRAIN_LR)
    state = opt.init(local)
    step = make_train_step(cfg, opt, remat=True, cp_mesh=mesh, device=device)
    rows = {k: pm.split_batch(v, mesh) for k, v in whole.items()}
    _zero_train_launches()
    losses, walls = [], []
    with _TimedCollectives() as tc:
        for _ in range(MD_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, loss = step(local, state, rows)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t0)
    out.update(losses=losses, step_s=walls, launches=_train_launches(), collectives=tc.stats,
               local_params=sum(t.numel() for t in _md_leaves(local)),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if rank == 0:
        out["loss_rel_err"] = [abs(a - b) / abs(b)
                               for a, b in zip(losses, out["one_device"]["losses"])]
    del local, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _md_gloo_cp_fsdp_train(rank: int, device) -> dict:
    """(b) FSDP under context parallelism on the four gloo ranks: the cp
    stage's config and batch (MD_TRAIN_LAYERS full-width layers, remat,
    MD_CP_BATCH x MD_CP_SEQ ids, the last MD_CP_MASKED of every row
    masked, the seed-0 init, MD_TRAIN_LR) at dp=2 tp=1 cp=2 under
    fsdp_sharding_rules at dp = 2: one row a dp rank, 1024 positions a cp
    rank, each large leaf's dp share the same on both cp ranks.
    MD_TRAIN_STEPS steps, held (by _md_check_cp_fsdp) to the one-device
    losses the cp stage's rank 0 computed on the same batch.  Per rank
    the losses, each step's wall, the flash launches, the collectives by
    axis (count, bytes, seconds), the local parameter count, the sizes of
    layers/attn_qkv_w and its moments with a digest of the local share
    after the steps, and the peak memory."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import default_optimizer, make_train_step
    from tdax_torch.parallel import mesh as pm

    cfg = dataclasses.replace(QwenVLConfig(), num_layers=MD_TRAIN_LAYERS)
    mesh = pm.make_mesh(dp=2, tp=1, cp=2)
    rng = np.random.default_rng(0)
    mask = np.ones((MD_CP_BATCH, MD_CP_SEQ), np.int32)
    mask[:, -MD_CP_MASKED:] = 0
    whole = {"input_ids": torch.as_tensor(rng.integers(1, cfg.vocab_size, mask.shape),
                                          device=device).long(),
             "attn_mask": torch.as_tensor(mask, device=device)}
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    full = init_params(cfg, device, seed=0, with_visual=False)
    rules = pm.fsdp_sharding_rules(full, mesh)
    local = pm.shard_params(full, mesh, rules, cfg=cfg)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    opt = default_optimizer(MD_TRAIN_LR)
    state = opt.init(local)
    step = make_train_step(cfg, opt, remat=True, cp_mesh=mesh,
                           param_shardings=pm.named_shardings(mesh, rules), device=device)
    rows = {k: pm.split_batch(v, mesh) for k, v in whole.items()}
    out = {"mesh": dict(mesh.shape), "dp_rank": mesh.local_rank("dp"),
           "cp_rank": mesh.local_rank("cp"), "local_rows": int(rows["input_ids"].shape[0]),
           "memory_after_init_bytes": torch.cuda.memory_allocated()}
    _zero_train_launches()
    losses, walls = [], []
    with _TimedCollectives() as tc:
        for _ in range(MD_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, loss = step(local, state, rows)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t0)
    qkv = local["layers"]["attn_qkv_w"]
    out.update(losses=losses, step_s=walls, launches=_train_launches(), collectives=tc.stats,
               local_params=sum(t.numel() for t in _md_leaves(local)),
               attn_qkv_w={"whole": cfg.num_layers * cfg.hidden_size * 3 * cfg.hidden_size,
                           **{k: t["layers"]["attn_qkv_w"].numel()
                              for k, t in (("params", local), ("mu", state.mu),
                                           ("nu", state.nu))}},
               attn_qkv_w_digest=_digest(qkv.view(torch.int16).cpu().numpy()),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    del local, state, step, qkv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _md_pp_launches(last: bool, steps: int) -> dict:
    """A pipeline stage's flash launches over ``steps`` remat steps of
    MD_PP_MICRO microbatches, one layer a stage: a microbatch's forward
    slot without grad, its backward slot's recompute and remat's replay
    (3 forwards; 2 on the last stage, whose forward slot only saves its
    input), one dq and one dk/dv launch; all on the sm90 kernels."""
    fwd = (2 if last else 3) * MD_PP_MICRO * steps
    bwd = MD_PP_MICRO * steps
    return {"flash_fwd": fwd, "flash_fwd_sm90": fwd, "flash_bwd_dq": bwd,
            "flash_bwd_dkv": bwd, "flash_bwd_dq_sm90": bwd, "flash_bwd_dkv_sm90": bwd}


def _md_counts_since(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def _md_gloo_pp(rank: int, device) -> dict:
    """(b) tdax's dry-run stage 9 on the four gloo ranks at pp=4 dp=1 (see
    the module's docstring): rank 0's one-device forward and steps first
    (computed and freed), then (i) pipeline_forward, (ii) MD_TRAIN_STEPS
    1F1B steps and (iii) one GPipe step from the same init.  Per rank its
    stage, each run's flash launches, losses, walls and collectives (the
    counters' sends by axis, the timed calls' count, bytes and seconds),
    its params, memory after the init and peak memory; rank 0 also the
    forward's cosines against one device and each loss's relative
    error."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import forward, init_params
    from tdax_torch.parallel import (default_optimizer, make_pp_mesh, make_train_step,
                                     make_train_step_pp, pipeline_forward, shard_params_pp)
    from tdax_torch.parallel import mesh as pm

    cfg = dataclasses.replace(QwenVLConfig(), num_layers=MD_PP_LAYERS)
    mesh = make_pp_mesh(pp=MD_PP, dp=1)
    rng = np.random.default_rng(0)
    fwd_ids = torch.as_tensor(rng.integers(1, cfg.vocab_size, (MD_PP_FWD_BATCH, MD_PP_FWD_SEQ)),
                              device=device).long()
    mask = np.ones((MD_PP_BATCH, MD_PP_SEQ), np.int32)
    mask[-1, -MD_TRAIN_MASKED:] = 0
    batch = {"input_ids": torch.as_tensor(rng.integers(1, cfg.vocab_size, mask.shape),
                                          device=device).long(),
             "attn_mask": torch.as_tensor(mask, device=device)}
    gc.collect()
    torch.cuda.empty_cache()
    out = {"stage": mesh.local_rank("pp"), "mesh": dict(mesh.shape)}
    one_logits = None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, device, seed=0, with_visual=False)
        with torch.no_grad():
            one_logits = forward(params, cfg, fwd_ids, torch.ones_like(fwd_ids))
        opt = default_optimizer(MD_TRAIN_LR)
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat=True, device=device)
        t0 = time.perf_counter()
        ref = [float(step(params, state, batch)[2]) for _ in range(MD_TRAIN_STEPS)]
        out["one_device"] = {"losses": ref, "wall_s": time.perf_counter() - t0,
                             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    def stage_tree():
        full = init_params(cfg, device, seed=0, with_visual=False)
        local = shard_params_pp(full, mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        return local

    def run(name, fn):
        """fn() timed with its launches and collectives, into out[name]."""
        _zero_train_launches()
        before = dict(pm.COLLECTIVES_BY_AXIS)
        sent = pm.COLLECTIVE_BYTES.get("gloo.ppermute", 0)
        with _TimedCollectives() as tc:
            torch.cuda.synchronize()
            t0, start = time.perf_counter(), time.time()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[name] = {"wall_s": wall, "start_unix_s": start, "end_unix_s": time.time(),
                     "launches": _train_launches(), "collectives": tc.stats,
                     "by_axis": _md_counts_since(before, pm.COLLECTIVES_BY_AXIS),
                     "sent_bytes": pm.COLLECTIVE_BYTES.get("gloo.ppermute", 0) - sent}
        return res

    torch.cuda.reset_peak_memory_stats()
    local = stage_tree()
    logits = run("forward", lambda: pipeline_forward(local, cfg, fwd_ids,
                                                     torch.ones_like(fwd_ids), mesh,
                                                     MD_PP_FWD_MICRO))
    if rank == 0:
        got, want = logits.flatten(0, 1), one_logits.flatten(0, 1)
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        out["forward"].update(cosine_min=float(cos.min()), cosine_mean=float(cos.mean()),
                              max_abs_err_of_max=float((got - want).abs().max()
                                                       / want.abs().max()),
                              bitwise=bool(torch.equal(got, want)))
    del logits, one_logits
    opt = default_optimizer(MD_TRAIN_LR)
    state = opt.init(local)
    out.update(local_params=sum(t.numel() for t in _md_leaves(local)),
               memory_after_init_bytes=torch.cuda.memory_allocated())
    step = make_train_step_pp(cfg, opt, mesh, MD_PP_MICRO, remat=True)
    walls = []

    def steps():
        losses = []
        for _ in range(MD_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(local, state, batch)[2]))
            walls.append((time.time(), time.perf_counter() - t0))
        return losses

    out["losses"] = run("train", steps)
    out["train"].update(step_s=[w for _, w in walls], step_end_unix_s=[t for t, _ in walls],
                        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    del local, state, step
    gc.collect()
    torch.cuda.empty_cache()
    local = stage_tree()
    state = opt.init(local)
    gpipe = make_train_step_pp(cfg, opt, mesh, MD_PP_MICRO, remat=True, schedule="gpipe")
    out["gpipe_loss"] = float(run("gpipe", lambda: gpipe(local, state, batch)[2]))
    if rank == 0:
        ref = out["one_device"]["losses"]
        out["loss_rel_err"] = [abs(a - b) / abs(b) for a, b in zip(out["losses"], ref)]
        out["gpipe_loss_rel_err"] = abs(out["gpipe_loss"] - ref[0]) / abs(ref[0])
    del local, state, gpipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _md_nccl_rank(rank: int, world: int, store: str, work: Path, data_dir: str,
                  sweep_dir: str, umap_ref: dict, train_ref: dict) -> dict:
    """(a) The world of one over NCCL: the full QwenVLConfig() in bf16 from
    seed 0 on the card, extract_activations of the 48 samples at batch
    16 under the process group (its dp path: the rows gathered by an
    NCCL all_gather); then the sweep and scale stages, the edge-list
    UMAP's mesh calls against phase umap_sparse's ``umap_ref`` and phase
    train's first step against its ``train_ref``, plain and under FSDP."""
    import torch
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.config import ExtractConfig
    from tdax_torch.data.io import load_metadata
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import mesh as pm
    from tdax_torch.pipeline.extract import extract_activations

    device = pm.init_distributed("cuda:0", rank=rank, world_size=world, store_path=store)
    try:
        backend = torch.distributed.get_backend()
        cfg = QwenVLConfig()
        params = init_params(cfg, device, seed=0)
        metadata = load_metadata(str(Path(data_dir) / "metadata.json"))
        fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
        pm.COLLECTIVES.clear()
        t0 = time.perf_counter()
        extract_activations(metadata, str(work / "nccl.pt"), cfg, ExtractConfig(batch_size=16),
                            params=params, device=device, verbose=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        out = {"backend": backend, "wall_s": wall_s, "collectives": dict(pm.COLLECTIVES),
               "launches": {"flash_fwd": fa.LAUNCHES, "flash_fwd_sm90": fa.LAUNCHES_SM90},
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["sweep_scale"] = _md_nccl_sweep_scale(device, data_dir, sweep_dir, work)
        gc.collect()
        torch.cuda.empty_cache()
        out["umap"] = _md_nccl_umap(device, umap_ref)
        gc.collect()
        torch.cuda.empty_cache()
        out["train"] = _md_nccl_train(device, train_ref)
        gc.collect()
        torch.cuda.empty_cache()
        out["train_fsdp"] = _md_nccl_train(device, train_ref, fsdp=True)
        return out
    finally:
        pm.shutdown()


def _md_batches(cfg, metadata, tokenizer, bs: int):
    """The extraction's batches as its own host code builds them: the
    dataset tokenized once and padded to round_up(longest + 1, 64)."""
    import numpy as np
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch
    from tdax_torch.models.qwen_vl.tokenizer import batch_encode
    enc = batch_encode(tokenizer, metadata, cfg)
    max_len = math.ceil((enc["input_ids"].shape[1] + 1) / 64) * 64
    pad = max_len - enc["input_ids"].shape[1]
    ids = np.pad(enc["input_ids"], ((0, 0), (0, pad)), constant_values=tokenizer.pad_id)
    mask = np.pad(enc["attn_mask"], ((0, 0), (0, pad)))
    for s in range(0, len(metadata), bs):
        images = load_image_batch(enc["image_paths"][s:s + bs], cfg.visual.image_size)
        yield (ids[s:s + bs], mask[s:s + bs], enc["last_token_idx"][s:s + bs], images,
               enc["image_positions"][s:s + bs])


def _md_to(arrays, device, mesh=None):
    """Host batch -> tensors on ``device`` (this rank's dp rows with a mesh)."""
    import numpy as np
    import torch
    from tdax_torch.parallel import mesh as pm
    out = []
    for a, dtype in zip(arrays, (torch.long, torch.int32, torch.long, torch.float32,
                                 torch.long)):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
        out.append(pm.split_batch(t, mesh) if mesh is not None else t)
    return out


def _md_extraction(cfg, params, metadata, work: Path, device) -> dict:
    """(b) dp=4 extraction (tp=1): uninterrupted, then crashed after its
    first checkpoint and resumed, as tdax's stage 5."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tdax_torch.config import ExtractConfig
    from tdax_torch.pipeline.extract import extract_activations

    ecfg = ExtractConfig(model_dir=None, batch_size=16, save_interval=16)

    def run(meta, name):
        res = extract_activations(meta, str(work / name), cfg, ecfg, params=params,
                                  device=device, verbose=False)
        return _stack(res, meta, cfg.num_layers)

    t0 = time.perf_counter()
    full = run(metadata, "dp_full.pt")
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    run(metadata[:16], "dp_res.pt")
    if dist.get_rank() == 0:  # the crash: only the checkpoint is left
        (work / "dp_res.npz").replace(work / "dp_res.pt.tmp.npz")
        (work / "dp_res.pt").unlink()
    dist.barrier()
    resumed = run(metadata, "dp_res.pt")
    return {"full": full, "full_s": full_s,
            "resume_within_tol": bool(np.allclose(resumed, full, **MD_RESUME_TOL)),
            "resume_bitwise": bool(np.array_equal(resumed, full)),
            "resume_max_abs_err": float(np.abs(resumed - full).max()),
            "tmp_left": (work / "dp_res.pt.tmp.npz").exists()}


def _md_prefill_logits(params, cfg, ids, mask, images, pos, kv_int8: bool):
    """The prefill's logits at each prompt's last real token."""
    import torch
    from tdax_torch.models.qwen_vl.decoder import rms_norm
    from tdax_torch.models.qwen_vl.generate import prefill
    from tdax_torch.models.qwen_vl.model import lm_logits
    hidden, _, _ = prefill(params, cfg, ids, mask, images, pos,
                           t_max=ids.shape[1] + MD_NEW_TOKENS, kv_int8=kv_int8)
    lengths = mask.sum(1).long()
    last = hidden[torch.arange(ids.shape[0], device=ids.device), lengths - 1]
    return lm_logits(rms_norm(last, params["ln_f"], cfg.layer_norm_eps), params, cfg)


def _md_generation(params, cfg, batch, device, mesh=None) -> dict:
    """MD_GEN_PROMPTS prompts (this rank's dp rows with a mesh): greedy
    generate of MD_NEW_TOKENS with bf16 and with int8 caches, and the
    prefill's logits; gathered over dp."""
    import torch
    from tdax_torch.models.qwen_vl.generate import generate
    from tdax_torch.parallel import mesh as pm
    ids, mask, _, images, pos = _md_to(batch, device, mesh)
    out = {}
    with torch.inference_mode():
        for kv_int8 in (False, True):
            key = "int8" if kv_int8 else "bf16"
            toks = generate(params, cfg, ids, mask, max_new_tokens=MD_NEW_TOKENS,
                            images=images, image_positions=pos, kv_int8=kv_int8)
            out[f"tokens_{key}"] = toks if mesh is None else pm.gather_batch(toks, mesh)
        logits = _md_prefill_logits(params, cfg, ids, mask, images, pos, False)
        out["prefill_logits"] = logits if mesh is None else pm.gather_batch(logits, mesh)
    return {k: v.cpu() for k, v in out.items()}


def _md_tiny(device, mesh) -> dict:
    """The tiny f32 model (seed 0) at dp=2 tp=2 against one device, both on
    the card in this process: the capture, greedy tokens and the
    int8-cache decode logits (tdax's stage-6 rules)."""
    import numpy as np
    import torch
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.generate import _decode_step, generate, prefill
    from tdax_torch.models.qwen_vl.model import extract_layer_activations, init_params
    from tdax_torch.ops.flash_attention import flash_sharding
    from tdax_torch.parallel import mesh as pm

    cfg = QwenVLConfig.tiny(dtype="float32")
    params = init_params(cfg, device, seed=0)
    local = pm.shard_params(params, mesh, cfg=cfg)
    rng = np.random.default_rng(0)
    b, t, nq, s = 4, 64, cfg.visual.n_queries, cfg.visual.image_size
    cap = _md_to((rng.integers(1, cfg.vocab_size, (b, t)), np.ones((b, t)), np.full(b, t - 1),
                  rng.normal(size=(b, 3, s, s)), np.tile(np.arange(2, 2 + nq), (b, 1))), device)
    gen_ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, 16))).to(device)
    gen_mask = torch.ones_like(gen_ids, dtype=torch.int32)

    def both(p, m):
        rows = (lambda x: pm.split_batch(x, m)) if m is not None else (lambda x: x)
        back = (lambda x: pm.gather_batch(x, m)) if m is not None else (lambda x: x)
        with torch.inference_mode():
            acts = extract_layer_activations(p, cfg, *map(rows, cap))
            ids, mask = rows(gen_ids), rows(gen_mask)
            toks = generate(p, cfg, ids, mask, max_new_tokens=MD_TINY_NEW_TOKENS)
            _, ks, vs = prefill(p, cfg, ids, mask, t_max=17, kv_int8=True)
            lengths = torch.full((ids.shape[0],), 16, dtype=torch.long, device=device)
            logits = _decode_step(p, cfg, ids[:, -1], lengths, ks, vs)[0]
        return (pm.gather_batch(acts, m, dim=1) if m is not None else acts,
                back(toks), back(logits))

    one = both(params, None)
    with flash_sharding(mesh, "dp", "tp"):
        got = both(local, mesh)
    capture_err = float((got[0] - one[0]).abs().max())
    int8_ok = bool(torch.allclose(got[2], one[2], **MD_KV_INT8_TOL))
    return {"capture_max_abs_err": capture_err,
            "capture_within_tol": bool(torch.allclose(got[0], one[0], rtol=TINY_TOL,
                                                      atol=TINY_TOL)),
            "tokens_equal": bool(torch.equal(got[1], one[1])),
            "int8_logits_max_abs_err": float((got[2] - one[2]).abs().max()),
            "int8_logits_within_tol": int8_ok}


def _md_one_device(full, cfg, batches, device) -> dict:
    """Rank 0's one-device references for a tree: the capture of the
    batches, the same capture with every product's sum taken in another
    order (f32 matmuls of the bf16 operands, cast once: the order change
    a tp split makes, without the split), and the generation."""
    import numpy as np
    import torch
    import tdax_torch.models.qwen_vl.decoder as dec
    import tdax_torch.models.qwen_vl.vit as vit
    from tdax_torch.models.qwen_vl.model import extract_layer_activations

    def capture():
        with torch.inference_mode():
            return np.concatenate([extract_layer_activations(full, cfg, *_md_to(b, device))
                                   .float().cpu().numpy() for b in batches], axis=1)

    acts = capture()
    orig = dec.qdot, vit.qdot
    dec.qdot = vit.qdot = lambda x, w: torch.matmul(x.float(), w.float()).to(x.dtype)
    try:
        reordered = capture()
    finally:
        dec.qdot, vit.qdot = orig
    return {"acts": acts, "reordered_cosine": _cosines(acts, reordered),
            "generation": _md_generation(full, cfg, batches[0], device)}


def _md_sharded(local, cfg, batches, device, mesh, timed: bool) -> dict:
    """A rank's dp=2 tp=2 capture of the batches (its 8 rows of each),
    gathered, and its generation; each flash launch noted; with
    ``timed`` one more batch with each tp sum timed alone."""
    import torch
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.models.qwen_vl.model import extract_layer_activations
    from tdax_torch.ops.flash_attention import flash_sharding
    from tdax_torch.parallel import mesh as pm

    fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
    pm.COLLECTIVES.clear()
    acts, forward_s = [], []
    out = {}
    with torch.inference_mode(), flash_sharding(mesh, "dp", "tp"):
        with _FlashCalls() as calls:
            for batch in batches:
                rows = _md_to(batch, device, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a = extract_layer_activations(local, cfg, *rows)
                torch.cuda.synchronize()
                forward_s.append(time.perf_counter() - t0)
                acts.append(pm.gather_batch(a.float(), mesh, dim=1).cpu().numpy())
        out["capture"] = {"forward_s": forward_s, "calls": calls.calls,
                          "launches": {"flash_fwd": fa.LAUNCHES,
                                       "flash_fwd_sm90": fa.LAUNCHES_SM90},
                          "collectives": dict(pm.COLLECTIVES)}
        if timed:
            with _TimedCollectives() as tc:
                rows = _md_to(batches[0], device, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                extract_layer_activations(local, cfg, *rows)
                torch.cuda.synchronize()
                out["capture"].update(timed_batch_s=time.perf_counter() - t0,
                                      all_reduce_s=tc.total("all_reduce")["seconds"],
                                      all_reduces=tc.total("all_reduce")["count"])
    fa.LAUNCHES = fa.LAUNCHES_SM90 = fa.LAUNCHES_DECODE = 0
    with flash_sharding(mesh, "dp", "tp"):
        t0 = time.perf_counter()
        out["generation"] = _md_generation(local, cfg, batches[0], device, mesh)
        torch.cuda.synchronize()
    out["generate"] = {"wall_s": time.perf_counter() - t0,
                       "launches": {"flash_fwd": fa.LAUNCHES, "flash_fwd_sm90": fa.LAUNCHES_SM90,
                                    "flash_decode": fa.LAUNCHES_DECODE}}
    out["acts"] = acts
    return out


def _md_hybrid_capture(full, cfg, batches, device) -> dict:
    """(b) tdax's stage-12 capture: the hybrid mesh at dcn=2 dp=2 tp=1
    (two slices of two ranks), every rank the whole tree, the batch over
    (dcn, dp): each rank 4 rows of each batch of 16, gathered; the flash
    launches and the collectives by axis noted."""
    import torch
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.models.qwen_vl.model import extract_layer_activations
    from tdax_torch.ops.flash_attention import flash_sharding
    from tdax_torch.parallel import mesh as pm

    mesh = pm.make_hybrid_mesh(dcn=2, dp=2, tp=1)
    local = pm.shard_params(full, mesh, cfg=cfg)  # tp = 1: the same tensors
    fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
    pm.COLLECTIVES_BY_AXIS.clear()
    acts, forward_s = [], []
    with torch.inference_mode(), flash_sharding(mesh, mesh.batch_axis, "tp"):
        for batch in batches:
            rows = _md_to(batch, device, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = extract_layer_activations(local, cfg, *rows)
            torch.cuda.synchronize()
            forward_s.append(time.perf_counter() - t0)
            acts.append(pm.gather_batch(a.float(), mesh, dim=1).cpu().numpy())
    return {"acts": acts, "forward_s": forward_s, "local_rows": rows[0].shape[0],
            "launches": {"flash_fwd": fa.LAUNCHES, "flash_fwd_sm90": fa.LAUNCHES_SM90},
            "collectives_by_axis": dict(pm.COLLECTIVES_BY_AXIS)}


def _md_compare(got: dict, one: dict) -> dict:
    """Rank 0's comparison of a tree's dp x tp run with one device."""
    import numpy as np
    acts, ref = np.concatenate(got.pop("acts"), axis=1), one["acts"]
    err = np.abs(acts - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    gen, gen1 = got.pop("generation"), one["generation"]
    d = (gen["prefill_logits"] - gen1["prefill_logits"]).abs()
    return {**got, "shape": list(acts.shape), "cosine": _cosines(ref, acts),
            "max_rel_err_by_layer": err.tolist(),
            "one_device_reordered_sums_cosine": one["reordered_cosine"],
            "prefill_logits_max_err_over_max": float(d.max()
                                                     / gen1["prefill_logits"].abs().max()),
            "prefill_argmax_agree": float((gen["prefill_logits"].argmax(-1)
                                           == gen1["prefill_logits"].argmax(-1)).float().mean()),
            **{f"{k}_agree": float((gen[k] == gen1[k]).float().mean())
               for k in ("tokens_bf16", "tokens_int8")}}


def _md_gloo_rank(rank: int, world: int, store: str, work: Path, snap: str, data_dir: str,
                  ref_npz: str, capture_dir: str, sweep_dir: str, umap_ref: dict) -> dict:
    """(b) Four ranks on cuda:0 over gloo.  Each loads the 8 + 8-layer
    snapshot: dp=4 extraction with crash and resume on the whole
    weights, then the weights sharded dp=2 tp=2 for the capture of the
    48 samples (each rank 8 rows of each batch of 16) and generation.
    The same for a tree of the model's own init at the snapshot's shape
    (init_params, seed 0), whose capture also runs on the hybrid mesh at
    dcn=2 dp=2 tp=1; then the tiny f32 model, then the sweep and scale
    stages at dp=4, training (dp=2 tp=2 plain, sequence-parallel and
    FSDP; FSDP on the hybrid mesh), the edge-list UMAP at dp=4, and
    context parallelism: the ring alone at cp=4, then the cp training
    step at dp=1 tp=2 cp=2, then the pipeline at pp=4.  Rank 0 computes
    each one-device reference before the sharded run (the ring's: every
    rank)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.data.io import load_activations_npz, load_metadata
    from tdax_torch.models.qwen_vl.convert import load_qwen_checkpoint
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.models.qwen_vl.tokenizer import get_tokenizer
    from tdax_torch.parallel import mesh as pm

    device = pm.init_distributed("cuda:0", rank=rank, world_size=world, store_path=store,
                                 backend="gloo")
    try:
        out = {"backend": dist.get_backend()}
        cfg = snapshot_config()
        metadata = load_metadata(str(Path(data_dir) / "metadata.json"))
        batches = list(_md_batches(cfg, metadata, get_tokenizer(snap, cfg), 16))
        mesh = pm.make_mesh(dp=2, tp=2)
        for name in ("snapshot", "init"):
            t0 = time.perf_counter()
            full = (load_qwen_checkpoint(snap, cfg, device) if name == "snapshot"
                    else init_params(cfg, device, seed=0))
            torch.cuda.synchronize()
            rec = {"load_s": time.perf_counter() - t0}
            if name == "snapshot":
                fa.LAUNCHES = fa.LAUNCHES_SM90 = 0
                out["extraction"] = _md_extraction(cfg, full, metadata, work, device)
                out["extraction"]["launches"] = {"flash_fwd": fa.LAUNCHES,
                                                 "flash_fwd_sm90": fa.LAUNCHES_SM90}
            one = _md_one_device(full, cfg, batches, device) if rank == 0 else None
            dist.barrier()
            if name == "init":
                hybrid = _md_hybrid_capture(full, cfg, batches, device)
                acts = np.concatenate(hybrid.pop("acts"), axis=1)
                if rank == 0:
                    hybrid["cosine"] = _cosines(one["acts"], acts)
                out["hybrid_capture"] = hybrid
                del acts
            local = pm.shard_params(full, mesh, cfg=cfg)
            del full
            gc.collect()
            torch.cuda.empty_cache()
            rec.update(local_params=sum(t.numel() for t in _md_leaves(local)),
                       memory_after_shard_bytes=torch.cuda.memory_allocated())
            rec.update(_md_sharded(local, cfg, batches, device, mesh, timed=name == "init"))
            del local
            gc.collect()
            torch.cuda.empty_cache()
            if rank == 0:
                rec = _md_compare(rec, one)
                if name == "snapshot":
                    ext = out["extraction"]
                    ref = load_activations_npz(ref_npz)[0]
                    rec["one_device_bitwise_phase_checkpoint"] = bool(
                        np.array_equal(one["acts"], ref))
                    ext["cosine_vs_one_device"] = _cosines(one["acts"], ext["full"])
            else:
                rec.pop("acts")
                rec.pop("generation")
            out[name] = rec
        out["extraction"].pop("full")
        out["tiny"] = _md_tiny(device, mesh)
        out["sweep_scale"] = _md_gloo_sweep_scale(rank, device, capture_dir, sweep_dir, work)
        gc.collect()
        torch.cuda.empty_cache()
        out["train"] = _md_gloo_train(rank, device)
        out["umap"] = _md_gloo_umap(rank, device, umap_ref)
        gc.collect()
        torch.cuda.empty_cache()
        out["ring"] = _md_gloo_ring(rank, device)
        out["cp_train"] = _md_gloo_cp_train(rank, device)
        out["cp_fsdp_train"] = _md_gloo_cp_fsdp_train(rank, device)
        out["pp"] = _md_gloo_pp(rank, device)
        return out
    finally:
        pm.shutdown()


def _md_named_leaves(tree, prefix: str = ""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _md_named_leaves(leaf, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", leaf


def _md_leaves(tree):
    for leaf in tree.values():
        if isinstance(leaf, dict):
            yield from _md_leaves(leaf)
        else:
            yield leaf


def phase_multidevice(tmp: Path, smi: str, capture_dir: Path, capture_wall_s: float, snap: str,
                      snap_data: Path, sweep_dir: Path, umap_ref: dict,
                      train_ref: dict) -> dict:
    """Multi-device serving, sweep, scale, training and the edge-list UMAP
    over torch.distributed on the one card: (a) a world of one over NCCL
    at the full config against phase capture's capture in
    ``capture_dir`` (its wall ``capture_wall_s``), phase sweep's output
    in ``sweep_dir``, phase umap_sparse's embeddings ``umap_ref`` and
    phase train's first step ``train_ref``, (b) four ranks on cuda:0
    over gloo on the 8 + 8-layer snapshot ``snap`` (its one-device
    capture in ``snap_data``), on the model's own init at that shape,
    then on phase capture's capture and the scale cloud, then dp=2 tp=2
    training and the UMAP at dp=4.  See the module's docstring."""
    import numpy as np
    import torch
    from tdax_torch.data.io import load_activations_npz

    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    print(f"multidevice: torch.cuda.mem_get_info() before the spawn: {free} free of {total} "
          "bytes", flush=True)
    t0 = time.perf_counter()
    (a,) = _md_world(_md_nccl_rank, 1, tmp / "md_nccl", str(capture_dir), str(sweep_dir),
                     umap_ref, train_ref, timeout_s=MD_TIMEOUT_S)
    a["world_s"] = time.perf_counter() - t0
    a["phase_capture_wall_s"] = capture_wall_s
    got = load_activations_npz(str(tmp / "md_nccl" / "nccl.npz"))[0]
    want = load_activations_npz(str(capture_dir / "all_activations.npz"))[0]
    a["bitwise_equal_capture"] = bool(got.shape == want.shape and np.array_equal(got, want))

    free_b, _ = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    ranks = _md_world(_md_gloo_rank, 4, tmp / "md_gloo", snap, str(snap_data),
                      str(snap_data / "all_activations.npz"), str(capture_dir), str(sweep_dir),
                      umap_ref, timeout_s=MD_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    cfg = snapshot_config()
    # each batch of the capture: the ViT blocks, the resampler, the decoder
    # layers, at tp=2 heads, on the Hopper kernel
    heads = ([(cfg.visual.heads // 2, "sm90")] * cfg.visual.layers
             + [(cfg.visual.resampler_heads // 2, "sm90")]
             + [(cfg.num_heads // 2, "sm90")] * cfg.num_layers) * 3
    # a rank's generation: three prefills (two generates and the prefill's
    # logits) on the sm90 kernel, two generates' decode steps on
    # flash_decode_sm90.cu at its 16 heads
    prefill = cfg.visual.layers + 1 + cfg.num_layers
    decode = 2 * (MD_NEW_TOKENS - 1) * cfg.num_layers
    md_generate = {"flash_fwd": 3 * prefill + decode, "flash_fwd_sm90": 3 * prefill,
                   "flash_decode": decode}
    calls_ok = {name: all([(h, route) for _, h, route in r[name]["capture"]["calls"]] == heads
                          for r in ranks) for name in ("snapshot", "init")}
    b = ranks[0]
    for name in ("snapshot", "init"):
        b[name]["capture"].pop("calls")
    scale_by_rank = [r.pop("sweep_scale") for r in ranks]
    train_by_rank = [r.pop("train") for r in ranks]
    umap_by_rank = [r.pop("umap") for r in ranks]
    ring_by_rank = [r.pop("ring") for r in ranks]
    cp_by_rank = [r.pop("cp_train") for r in ranks]
    cp_fsdp_by_rank = [r.pop("cp_fsdp_train") for r in ranks]
    pp_by_rank = [r.pop("pp") for r in ranks]
    info = {"phase": "multidevice", "nvidia_smi": smi,
            "mem_get_info_before_spawn": {"free_bytes": free, "total_bytes": total},
            "nccl_world_of_one": a,
            "gloo_dp2_tp2": {"world_s": world_s, "mem_free_before_spawn_bytes": free_b,
                             "backend": b["backend"], "extraction": b["extraction"],
                             "snapshot": b["snapshot"], "init": b["init"],
                             "capture_calls_as_expected": calls_ok,
                             "tiny_by_rank": [r["tiny"] for r in ranks]},
            "gloo_dp4_sweep_scale": {
                "compared": scale_by_rank[0]["compared"], "thresh": scale_by_rank[0]["thresh"],
                "stages_by_rank": [r["stages"] for r in scale_by_rank],
                "max_memory_allocated_bytes_by_rank": [r["max_memory_allocated_bytes"]
                                                       for r in scale_by_rank],
                "collectives_by_rank": [r["collectives"] for r in scale_by_rank],
                "results_equal_on_every_rank": all(r["digests"] == scale_by_rank[0]["digests"]
                                                   for r in scale_by_rank)},
            "gloo_dp2_tp2_train": {
                "layers": MD_TRAIN_LAYERS, "batch": [MD_TRAIN_BATCH, MD_TRAIN_SEQ],
                "fsdp_accum_steps": MD_FSDP_ACCUM,
                "one_device_rank0": train_by_rank[0].get("one_device"),
                "by_rank": [{k: v for k, v in r.items() if k != "one_device"}
                            for r in train_by_rank]},
            "gloo_hybrid_capture_by_rank": [r["hybrid_capture"] for r in ranks],
            "gloo_dp4_umap": {
                "compared": umap_by_rank[0]["compared"],
                "stages_by_rank": [r["stages"] for r in umap_by_rank],
                "results_equal_on_every_rank": all(r["digests"] == umap_by_rank[0]["digests"]
                                                   for r in umap_by_rank)},
            "gloo_cp": {
                "ring": {"cp": MD_RING_CP, "shape_bf16": list(MD_RING_SHAPE),
                         "shape_f32": list(MD_RING_F32_SHAPE), "by_rank": ring_by_rank},
                "train": {"layers": MD_TRAIN_LAYERS, "batch": [MD_CP_BATCH, MD_CP_SEQ],
                          "one_device_rank0": cp_by_rank[0].get("one_device"),
                          "by_rank": [{k: v for k, v in r.items() if k != "one_device"}
                                      for r in cp_by_rank]},
                "fsdp_train": {
                    "layers": MD_TRAIN_LAYERS, "batch": [MD_CP_BATCH, MD_CP_SEQ],
                    "mesh": {"dp": 2, "tp": 1, "cp": 2},
                    # rank 0's losses against the cp stage's one-device and
                    # plain cp losses on the same batch
                    "loss_rel_err": _rel_errs(cp_fsdp_by_rank[0]["losses"],
                                              cp_by_rank[0]["one_device"]["losses"]),
                    "loss_rel_err_vs_plain_cp": _rel_errs(cp_fsdp_by_rank[0]["losses"],
                                                          cp_by_rank[0]["losses"]),
                    "by_rank": cp_fsdp_by_rank}},
            "gloo_pp": {"pp": MD_PP, "layers": MD_PP_LAYERS,
                        "forward_batch": [MD_PP_FWD_BATCH, MD_PP_FWD_SEQ],
                        "forward_micro": MD_PP_FWD_MICRO, "batch": [MD_PP_BATCH, MD_PP_SEQ],
                        "micro": MD_PP_MICRO,
                        "one_device_rank0": pp_by_rank[0].get("one_device"),
                        "by_rank": [{k: v for k, v in r.items() if k != "one_device"}
                                    for r in pp_by_rank]},
            "phase_s": time.perf_counter() - t_phase,
            "note": "times of four ranks sharing one card: they say nothing of scaling"}
    emit(info)
    _md_check_cp(info["gloo_cp"])
    _md_check_pp(info["gloo_pp"])
    _md_check_sweep_scale(a["sweep_scale"], info["gloo_dp4_sweep_scale"], scale_by_rank)
    _md_check_train_umap(a, info["gloo_dp2_tp2_train"], info["gloo_dp4_umap"])
    _md_check_fsdp_hybrid(a, info["gloo_dp2_tp2_train"], info["gloo_hybrid_capture_by_rank"],
                          len(heads))
    if a["backend"] != "nccl" or a["collectives"].get("nccl.all_gather", 0) < 1:
        raise AssertionError(f"multidevice (a): backend {a['backend']}, collectives "
                             f"{a['collectives']}: no NCCL gather ran")
    if a["launches"] != {"flash_fwd": 243, "flash_fwd_sm90": 243}:
        raise AssertionError(f"multidevice (a): launches {a['launches']}, expected 243 sm90")
    if not a["bitwise_equal_capture"]:
        raise AssertionError("multidevice (a): the NCCL world's capture differs from phase "
                             "capture's")
    for r in ranks:
        ext = r["extraction"]
        if not (ext["resume_within_tol"] and not ext["tmp_left"]):
            raise AssertionError(f"multidevice (b): dp=4 resume {ext}")
        for name in ("snapshot", "init"):
            got = r[name]["capture"]["launches"]
            if got != {"flash_fwd": len(heads), "flash_fwd_sm90": len(heads)}:
                raise AssertionError(f"multidevice (b) {name}: capture launches {got}, expected "
                                     f"{len(heads)}, all sm90, a rank")
            got = r[name]["generate"]["launches"]
            if got != md_generate:
                raise AssertionError(f"multidevice (b) {name}: generate launches {got}, "
                                     f"expected {md_generate} a rank")
        t = r["tiny"]
        if not (t["capture_within_tol"] and t["tokens_equal"] and t["int8_logits_within_tol"]):
            raise AssertionError(f"multidevice (b) tiny: {t}")
    if not all(calls_ok.values()):
        raise AssertionError(f"multidevice (b): a rank's attention did not run on "
                             f"flash_fwd_sm90.cu at its shard's heads: {calls_ok}")
    if b["init"]["cosine"]["min"] < MD_MIN_COSINE:
        raise AssertionError(f"multidevice (b): min cosine {b['init']['cosine']['min']} "
                             f"< {MD_MIN_COSINE} on the model's init")
    return info


def _md_check_cp(cp: dict) -> None:
    """The gates of the context-parallel stages (see MD_RING_CASES' note)."""
    for i, r in enumerate(cp["ring"]["by_rank"]):
        for label, rec in r.items():
            if not rec["launches_as_scheduled"]:
                raise AssertionError(f"multidevice (b) ring {label} rank {i}: launches "
                                     f"{rec['launches']} are not the schedule's")
            if not rec["within_tol"]:
                raise AssertionError(f"multidevice (b) ring {label} rank {i}: errors "
                                     f"{rec['max_abs_err']} {rec.get('bound_excess')} against "
                                     "one device")
    t = cp["train"]["by_rank"]
    want = _expected_train_launches(MD_TRAIN_LAYERS, MD_TRAIN_STEPS)
    want = {k: n * 2 for k, n in want.items()}  # the ring: one launch a step, cp = 2 steps
    for i, r in enumerate(t):
        if r["launches"] != want:
            raise AssertionError(f"multidevice (b) cp train rank {i}: launches {r['launches']}, "
                                 f"expected {want}")
        if r["losses"] != t[0]["losses"]:
            raise AssertionError("multidevice (b) cp train: the ranks' losses differ")
        if not {"cp.ppermute", "dp+cp.all_reduce"} <= set(r["collectives"]):
            raise AssertionError(f"multidevice (b) cp train rank {i}: collectives "
                                 f"{sorted(r['collectives'])}")
    errs = t[0]["loss_rel_err"]
    if not max(errs) <= MD_TRAIN_LOSS_RTOL:
        raise AssertionError(f"multidevice (b) cp train: loss relative errors {errs} against one "
                             f"device (limit {MD_TRAIN_LOSS_RTOL})")
    _md_check_cp_fsdp(cp["fsdp_train"], want)


def _rel_errs(got: list, want: list) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def _md_check_cp_fsdp(f: dict, want: dict) -> None:
    """The gates of the FSDP cp stage: the plain cp stage's launches a
    rank (``want``), the losses equal on every rank and within
    MD_TRAIN_LOSS_RTOL of the one-device losses and of the plain cp
    step's, layers/attn_qkv_w and its moments at half the whole on every
    rank, the same share on the two cp ranks of a dp index, and a dp
    reduce-scatter and a cp all_reduce of each sharded gradient."""
    by_rank = f["by_rank"]
    for i, r in enumerate(by_rank):
        if r["launches"] != want:
            raise AssertionError(f"multidevice (b) cp fsdp rank {i}: launches {r['launches']}, "
                                 f"expected {want}")
        if r["losses"] != by_rank[0]["losses"]:
            raise AssertionError("multidevice (b) cp fsdp: the ranks' losses differ")
        q = r["attn_qkv_w"]
        if not q["params"] == q["mu"] == q["nu"] == q["whole"] // 2:
            raise AssertionError(f"multidevice (b) cp fsdp rank {i}: attn_qkv_w shares {q}, "
                                 "expected half the whole")
        c = r["collectives"]
        if not ({"dp.all_gather", "dp.reduce_scatter", "cp.all_reduce", "cp.ppermute",
                 "dp+cp.all_reduce"} <= set(c)
                and c["cp.all_reduce"]["count"] == c["dp.reduce_scatter"]["count"]):
            raise AssertionError(f"multidevice (b) cp fsdp rank {i}: collectives "
                                 f"{ {k: v['count'] for k, v in c.items()} }")
    for d in (0, 1):
        digests = {r["attn_qkv_w_digest"] for r in by_rank if r["dp_rank"] == d}
        if len(digests) != 1:
            raise AssertionError(f"multidevice (b) cp fsdp: the cp ranks of dp index {d} hold "
                                 "different shares")
    errs = f["loss_rel_err"] + f["loss_rel_err_vs_plain_cp"]
    if not max(errs) <= MD_TRAIN_LOSS_RTOL:
        raise AssertionError(f"multidevice (b) cp fsdp: loss relative errors {errs} against one "
                             f"device and the plain cp step (limit {MD_TRAIN_LOSS_RTOL})")


def _md_check_pp(pp: dict) -> None:
    """The gates of the pipeline stage (see the module's docstring)."""
    ranks = pp["by_rank"]
    r0 = ranks[0]
    if not r0["forward"]["cosine_min"] >= MD_MIN_COSINE:
        raise AssertionError(f"multidevice (b) pp forward: min cosine "
                             f"{r0['forward']['cosine_min']} < {MD_MIN_COSINE}")
    fwd = {k: 0 for k in _md_pp_launches(False, 1)}
    fwd.update(flash_fwd=MD_PP_FWD_MICRO, flash_fwd_sm90=MD_PP_FWD_MICRO)
    for r in ranks:
        s, last = r["stage"], r["stage"] == MD_PP - 1
        for name, want in (("forward", fwd), ("train", _md_pp_launches(last, MD_TRAIN_STEPS)),
                           ("gpipe", _md_pp_launches(last, 1))):
            if r[name]["launches"] != want:
                raise AssertionError(f"multidevice (b) pp {name} stage {s}: launches "
                                     f"{r[name]['launches']}, expected {want}")
        sends = MD_PP_MICRO * ((s < MD_PP - 1) + (s > 0))
        for name, steps in (("train", MD_TRAIN_STEPS), ("gpipe", 1)):
            want = {"pp.ppermute": sends * steps, "pp.all_reduce": 2 * steps}
            if r[name]["by_axis"] != want:
                raise AssertionError(f"multidevice (b) pp {name} stage {s}: collectives "
                                     f"{r[name]['by_axis']}, expected {want}")
        if r["losses"] != r0["losses"] or r["gpipe_loss"] != r0["gpipe_loss"]:
            raise AssertionError("multidevice (b) pp: the ranks' losses differ")
    total = sum(r["train"]["by_axis"]["pp.ppermute"] for r in ranks)
    if total != 2 * MD_PP_MICRO * (MD_PP - 1) * MD_TRAIN_STEPS:
        raise AssertionError(f"multidevice (b) pp: {total} transfers over the group")
    errs = r0["loss_rel_err"] + [r0["gpipe_loss_rel_err"]]
    if not max(errs) <= MD_TRAIN_LOSS_RTOL:
        raise AssertionError(f"multidevice (b) pp: loss relative errors {errs} against one "
                             f"device (limit {MD_TRAIN_LOSS_RTOL})")


def _md_check_train_umap(a: dict, train: dict, umap: dict) -> None:
    """The gates of the training and UMAP stages (see the module's docstring)."""
    t = a["train"]
    if not (t["loss_bitwise_phase_train"] and t["fingerprint_bitwise_phase_train"]):
        raise AssertionError(f"multidevice (a) train: not bitwise phase train's first step: {t}")
    if t["launches"] != _expected_train_launches(32, 1):
        raise AssertionError(f"multidevice (a) train: launches {t['launches']}, expected "
                             f"{_expected_train_launches(32, 1)}")
    u = a["umap"]
    if not (u["embed_bitwise"] and u["transform_bitwise"] and u["embed_large_bitwise"]):
        raise AssertionError(f"multidevice (a) umap: not bitwise phase umap_sparse's: {u}")
    want = _expected_train_launches(MD_TRAIN_LAYERS, MD_TRAIN_STEPS)
    for i, r in enumerate(train["by_rank"]):
        for name in ("plain", "sp"):
            if r[name]["launches"] != want:
                raise AssertionError(f"multidevice (b) train {name} rank {i}: launches "
                                     f"{r[name]['launches']}, expected {want}")
            if r[name]["losses"] != train["by_rank"][0][name]["losses"]:
                raise AssertionError(f"multidevice (b) train {name}: the ranks' losses differ")
    for name in ("plain", "sp"):
        errs = train["by_rank"][0][name]["loss_rel_err"]
        if not max(errs) <= MD_TRAIN_LOSS_RTOL:
            raise AssertionError(f"multidevice (b) train {name}: loss relative errors {errs} "
                                 f"against one device (limit {MD_TRAIN_LOSS_RTOL})")
    c = umap["compared"]
    if not (c["silhouette_8clusters"] > UMAP_SIL_MIN and c["placed"] >= UMAP_PLACED_MIN
            and c["transform_bitwise_one_device"] and c["knn"]["ok"]
            and umap["results_equal_on_every_rank"]):
        raise AssertionError(f"multidevice (b) umap at dp=4: {umap}")


def _md_check_fsdp_hybrid(a: dict, train: dict, hybrid_capture: list,
                          capture_launches: int) -> None:
    """The gates of the FSDP and hybrid-mesh stages (see the module's
    docstring)."""
    t = a["train_fsdp"]
    if not (t["loss_bitwise_phase_train"] and t["fingerprint_bitwise_phase_train"]):
        raise AssertionError(f"multidevice (a) FSDP train: not bitwise phase train's first "
                             f"step: {t}")
    if t["launches"] != _expected_train_launches(32, 1):
        raise AssertionError(f"multidevice (a) FSDP train: launches {t['launches']}")
    if not (t["collectives_by_axis"].get("dp.all_gather", 0) > 0
            and t["collectives_by_axis"].get("dp.reduce_scatter", 0) > 0):
        raise AssertionError(f"multidevice (a) FSDP train: no weight gather or gradient "
                             f"reduce-scatter over dp: {t['collectives_by_axis']}")
    runs = train["by_rank"]
    for name, micro_steps, share in (("fsdp", MD_TRAIN_STEPS * MD_FSDP_ACCUM, 4),
                                     ("hybrid_fsdp", MD_HYBRID_STEPS, 2)):
        want = _expected_train_launches(MD_TRAIN_LAYERS, micro_steps)
        for i, r in enumerate(runs):
            rec = r[name]
            if rec["launches"] != want:
                raise AssertionError(f"multidevice (b) {name} rank {i}: launches "
                                     f"{rec['launches']}, expected {want}")
            if rec["losses"] != runs[0][name]["losses"]:
                raise AssertionError(f"multidevice (b) {name}: the ranks' losses differ")
            q = rec["attn_qkv_w"]
            if not q["params"] == q["mu"] == q["nu"] == q["whole"] // share:
                raise AssertionError(f"multidevice (b) {name} rank {i}: attn_qkv_w and its "
                                     f"moments {q}, expected 1/{share} each")
            keys = set(rec["collectives"])
            if name == "hybrid_fsdp" and not (
                    {k for k in keys if k.startswith("dcn.")} == {"dcn.all_reduce"}
                    and {"dp.all_gather", "dp.reduce_scatter"} <= keys):
                raise AssertionError(f"multidevice (b) {name} rank {i}: collectives {keys}: "
                                     "the weights must be gathered over dp and only the "
                                     "gradients' all_reduce may cross dcn")
        errs = runs[0][name]["loss_rel_err"]
        if not max(errs) <= MD_TRAIN_LOSS_RTOL:
            raise AssertionError(f"multidevice (b) {name}: loss relative errors {errs} against "
                                 f"one device (limit {MD_TRAIN_LOSS_RTOL})")
    for i, r in enumerate(runs):
        fsdp, plain = (r[k]["max_memory_allocated_bytes"] for k in ("fsdp", "plain"))
        if not fsdp < plain:
            raise AssertionError(f"multidevice (b) FSDP rank {i}: peak {fsdp} bytes, not below "
                                 f"the plain dp=2 tp=2 step's {plain}")
    for i, h in enumerate(hybrid_capture):
        if h["launches"] != {"flash_fwd": capture_launches, "flash_fwd_sm90": capture_launches}:
            raise AssertionError(f"multidevice (b) hybrid capture rank {i}: launches "
                                 f"{h['launches']}, expected {capture_launches}, all sm90")
        if [k for k in h["collectives_by_axis"] if not k.startswith("dcn+dp.")]:
            raise AssertionError(f"multidevice (b) hybrid capture rank {i}: collectives "
                                 f"{h['collectives_by_axis']}")
    if hybrid_capture[0]["cosine"]["min"] < MD_MIN_COSINE:
        raise AssertionError(f"multidevice (b) hybrid capture: min cosine "
                             f"{hybrid_capture[0]['cosine']['min']} < {MD_MIN_COSINE}")


def _md_check_sweep_scale(a: dict, b: dict, ranks: list) -> None:
    """The gates of the sweep and scale stages (see the module's docstring)."""
    sw = a["sweep"]
    if not (sw["stats_equal"] and sw["clouds_bitwise"]
            and sw["peak_layer"] == sw["one_device_peak_layer"]):
        raise AssertionError(f"multidevice (a) sweep: not bitwise phase sweep's {sw}")
    if not a["distance_matrix"]["bitwise_expansion_form"]:
        raise AssertionError("multidevice (a): distance_matrix(mesh=) differs from the "
                             "expansion form symmetrised")
    sp = a["rips_at_scale_sparse"]
    if not (sp["n_edges"] == sp["n_edges_one_device"] and sp["dgms_bitwise_one_device"]):
        raise AssertionError(f"multidevice (a) sparse: {sp}")
    for label, launches in [("a", a["mesh_sqdist_launches"])] + [
            (f"b rank {i}", r["stages"]["mesh_sqdist_launches"]) for i, r in enumerate(ranks)]:
        if any(launches):
            raise AssertionError(f"multidevice ({label}): the mesh paths launched the sqdist "
                                 f"kernels {launches}")
    c = b["compared"]
    sw = c["sweep"]
    if sw["peak_layer"] != sw["one_device_peak_layer"]:
        raise AssertionError(f"multidevice (b) sweep: peak layer {sw['peak_layer']}, one "
                             f"device {sw['one_device_peak_layer']}")
    if sw["max_silhouette_diff"] > MD_SWEEP_SIL_TOL or min(sw["pdist_corr"]) <= MD_UMAP_CORR:
        raise AssertionError(f"multidevice (b) sweep: silhouettes {sw['max_silhouette_diff']} "
                             f"(limit {MD_SWEEP_SIL_TOL}), pdist correlation "
                             f"{min(sw['pdist_corr'])} (floor {MD_UMAP_CORR})")
    if not c["knn"]["ok"]:
        raise AssertionError(f"multidevice (b) sharded_knn: {c['knn']}")
    dense = c["rips_at_scale"]
    if dense["one_device_sqdist_launches"] != [1, 1, 1]:
        raise AssertionError(f"multidevice (b): the one-device rips_at_scale launched "
                             f"{dense['one_device_sqdist_launches']}, expected one "
                             "sqdist_sm90.cu launch and one split")
    if max(dense["bottleneck_per_dim"]) > SMALL_BOTTLENECK_TOL:
        raise AssertionError(f"multidevice (b) rips_at_scale(mesh=): {dense}")
    sp = c["rips_at_scale_sparse"]
    if sp["n_edges"] != sp["n_edges_one_device"] or max(sp["bottleneck_per_dim"]) > \
            CROSS_ENGINE_TOL:
        raise AssertionError(f"multidevice (b) rips_at_scale_sparse(mesh=): {sp}")
    if not b["results_equal_on_every_rank"]:
        raise AssertionError("multidevice (b): the ranks' sweep or scale results differ")


def _qmm_totals(sites, calls_key) -> dict:
    """Kernel (as routed, and all on qmm.cu), plain, library and bound ms
    summed over the sites of one capture batch or one decode step, each
    weighted by its calls."""
    out = {key: sum(s[key] * s[calls_key] for s in sites)
           for key in ("ms", "ms_mma", "plain_ms", "bound_ms", "library_ms")}
    by_ops = sum(s["bound_ms"] * s[calls_key] for s in sites if s["bound_by"] == "operations")
    out["bound_by"] = "operations" if by_ops >= out["bound_ms"] - by_ops else "bytes"
    return out


def _flash_split(launches: dict) -> dict:
    """A path's forward launches by kernel."""
    decode = launches.get("flash_decode", 0)
    return {"sm90": launches["flash_fwd_sm90"], "decode": decode,
            "mma": launches["flash_fwd"] - launches["flash_fwd_sm90"] - decode}


def _generate_paths(gen: dict, w8: dict, md: dict) -> list:
    """(path, launches) of every generate: phase generate's two runs, W8A8's,
    and rank 0's dp=2 tp=2 generation on the snapshot and on the init."""
    return [*((f"generate{'_kv_int8' if run['kv_int8'] else ''}", run["launches"])
              for run in gen["runs"]),
            ("w8a8_generate", w8["generate"]["launches"]),
            *((f"multidevice_dp2_tp2_{name}_generate_rank0",
               md["gloo_dp2_tp2"][name]["generate"]["launches"]) for name in ("snapshot", "init"))]


def _per_step(value, calls: int):
    return value * calls if isinstance(value, float) else value


def _train_paths(train: dict, md: dict) -> list:
    """(path, flash launches) of every training run: phase train's five
    timed steps, the NCCL world's plain and FSDP steps, rank 0's dp=2 tp=2
    plain, sequence-parallel and FSDP steps, its hybrid FSDP step, its cp
    step, its FSDP cp step and each of its ring cases (forward and
    backward once), and each pipeline stage's forward, 1F1B steps and
    GPipe step."""
    runs = md["gloo_dp2_tp2_train"]["by_rank"][0]
    return [("train", train["launches"]),
            ("multidevice_nccl_train", md["nccl_world_of_one"]["train"]["launches"]),
            ("multidevice_nccl_train_fsdp", md["nccl_world_of_one"]["train_fsdp"]["launches"]),
            ("multidevice_dp2_tp2_train_rank0", runs["plain"]["launches"]),
            ("multidevice_dp2_tp2_train_sp_rank0", runs["sp"]["launches"]),
            ("multidevice_dp2_tp2_train_fsdp_rank0", runs["fsdp"]["launches"]),
            ("multidevice_hybrid_train_fsdp_rank0", runs["hybrid_fsdp"]["launches"]),
            ("multidevice_cp2_tp2_train_rank0", md["gloo_cp"]["train"]["by_rank"][0]["launches"]),
            ("multidevice_cp2_dp2_fsdp_train_rank0",
             md["gloo_cp"]["fsdp_train"]["by_rank"][0]["launches"]),
            *((f"multidevice_ring_cp{MD_RING_CP}_{label}_rank0", rec["launches"])
              for label, rec in md["gloo_cp"]["ring"]["by_rank"][0].items()),
            *((f"multidevice_pp{MD_PP}_{run}_stage{r['stage']}", r[run]["launches"])
              for r in md["gloo_pp"]["by_rank"] for run in ("forward", "train", "gpipe"))]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="the training batch's seed")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import_port()
    from tdax_torch.runtime import get_device
    get_device()  # cuda, with TF32 off

    env = phase_env()
    smi = env["nvidia_smi"]
    kern = phase_kernels()
    sq = phase_sqdist()
    qmm = phase_qmm()
    fbwd = phase_flash_bwd(smi)
    with tempfile.TemporaryDirectory(prefix="tdax_torch_smoke_") as tmp:
        phase_tiny_parity(Path(tmp))
        phase_tiny_int8(Path(tmp))
        phase_tiny_train(Path(tmp))
        capture, state = phase_capture(Path(tmp), smi)
        int8 = phase_int8_capture(Path(tmp), smi, state, capture["max_memory_allocated_bytes"])
        gen = phase_generate(smi, state, int8.pop("fingerprint"))
        w8 = phase_w8a8(Path(tmp), smi, state, qmm)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        sweep = phase_sweep(Path(tmp), smi)
        phase_ph_backends(Path(tmp), smi)
        phase_report(Path(tmp), smi, sweep, capture["flash_launches_sm90"])
        ckpt, ckpt_state = phase_checkpoint(Path(tmp), smi)
        adv = phase_adversarial(Path(tmp), smi, ckpt_state, args.seed)
        snap, snap_data = ckpt_state["snapshot"], ckpt_state["data_dir"]
        del ckpt_state
        gc.collect()
        torch.cuda.empty_cache()
        scale = phase_scale(smi)
        gc.collect()
        torch.cuda.empty_cache()
        sparse = phase_scale_sparse(smi)
        gc.collect()
        torch.cuda.empty_cache()
        umap_ref = phase_umap_sparse(smi)["arrays"]
        gc.collect()
        torch.cuda.empty_cache()
        train = phase_train(smi, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        # after the phases whose one-device results its mesh paths are held to
        md = phase_multidevice(Path(tmp), smi, Path(tmp) / "data", capture["wall_s"], snap,
                               snap_data, Path(tmp) / "tda_debug_output", umap_ref,
                               train.pop("reference"))

    def total(key):
        return sum(s[key] * s["calls_per_batch"] for s in kern["sites"])

    dec = next(s for s in fbwd["sites"] if s["site"] == "decoder")
    dcd = kern["decode"]
    qdec = [s for s in qmm["sites"] if s["route"] == "decode"]
    calls = dec["calls_per_train_step"]
    by_ops = sum(s["bound_ms"] * s["calls_per_batch"] for s in kern["sites"]
                 if s["bound_by"] == "operations")
    by_bytes = total("bound_ms") - by_ops
    tr = kern["train"]
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/flash_fwd_sm90.cu",
        "sources": {"sm90": "tdax_torch/ops/csrc/flash_fwd_sm90.cu",
                    "mma": "tdax_torch/ops/csrc/flash_fwd.cu"},
        "replaces": "tdax/ops/flash_attention.py:164",
        "launches": capture["flash_launches_sm90"],
        "launches_by_kernel": {
            "capture": {"sm90": capture["flash_launches_sm90"],
                        "mma": capture["flash_launches"] - capture["flash_launches_sm90"]},
            "int8_capture": {"sm90": int8["launches"]["flash_fwd_sm90"],
                             "mma": int8["launches"]["flash_fwd"]
                             - int8["launches"]["flash_fwd_sm90"]},
            **{path: _flash_split(launches) for path, launches in _generate_paths(gen, w8, md)},
            "w8a8_capture": _flash_split(w8["capture"]["launches"]),
            **{path: {"sm90": launches["flash_fwd_sm90"],
                      "mma": launches["flash_fwd"] - launches["flash_fwd_sm90"]}
               for path, launches in _train_paths(train, md)},
            **{path: {"sm90": rec["launches"]["flash_fwd_sm90"],
                      "mma": rec["launches"]["flash_fwd"] - rec["launches"]["flash_fwd_sm90"]}
               for path, rec in (("checkpoint_capture", ckpt["capture"]),
                                 ("checkpoint_int8_capture", ckpt["int8_capture"]),
                                 ("adversarial_capture", adv["capture"]),
                                 ("multidevice_nccl_capture", md["nccl_world_of_one"]),
                                 ("multidevice_dp4_extraction_rank0",
                                  md["gloo_dp2_tp2"]["extraction"]),
                                 ("multidevice_hybrid_capture_rank0",
                                  md["gloo_hybrid_capture_by_rank"][0]),
                                 *((f"multidevice_dp2_tp2_{name}_capture_rank0",
                                    md["gloo_dp2_tp2"][name]["capture"])
                                   for name in ("snapshot", "init")))}},
        "max_abs_err": max(s["max_abs_err"] for s in kern["sites"] + [tr]),
        "ms": total("ms"),
        "ms_mma": total("ms_mma"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": total("library_ms"),
        "per": "one batch of 16: 48 ViT + 1 resampler + 32 decoder calls, bf16, on the sm90 "
               "kernel the route picks; ms_mma is flash_fwd.cu at the same calls",
        "train_step_with_lse": {k: tr[k] for k in ("shape", "ms", "ms_mma", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms",
                                                   "lse_max_abs_err", "calls_per_train_step")},
    }, {
        "name": "flash_fwd_mla",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/flash_fwd_sm90.cu",
        "kernel": "flash_fwd_mla_kernel",
        "sources": {"sm90": "tdax_torch/ops/csrc/flash_fwd_sm90.cu",
                    "mma": "tdax_torch/ops/csrc/flash_fwd.cu"},
        "replaces": "none: tdax has no latent attention (Kimi-VL's decoder is the port's own)",
        "launches_per_capture_batch": kern["mla"]["calls_per_batch"],
        "max_abs_err": kern["mla"]["max_abs_err"],
        "max_abs_err_mma": kern["mla"]["max_abs_err_mma"],
        "lse_max_abs_err": kern["mla"]["lse_max_abs_err"],
        **{key: _per_step(kern["mla"][key], kern["mla"]["calls_per_batch"])
           for key in ("ms", "ms_mma", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "operations",
        "share_of_bound": kern["mla"]["share_of_bound"],
        "per_call": {key: kern["mla"][key] for key in (
            "shape", "hd_v", "ms", "ms_mma", "plain_ms", "library_ms", "bound_ms",
            "share_of_bound", "share_of_bound_mma")},
        "per": f"one Kimi-VL capture batch: {kern['mla']['calls_per_batch']} calls at "
               f"{kern['mla']['shape']} (q.k 192, v 128) causal bf16 on the sm90 kernel the "
               "route picks, by CUDA events; ms_mma is flash_fwd.cu at the same calls; "
               "library_ms SDPA with the boolean causal and key mask; bound_ms "
               "benchmark.roofline.attn_fwd_bound",
    }, {
        "name": "flash_decode",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/flash_decode_sm90.cu",
        "replaces": "tdax/ops/flash_attention.py:164",
        "launches": gen["runs"][0]["launches"]["flash_decode"],
        "launches_by_path": {path: launches["flash_decode"]
                             for path, launches in _generate_paths(gen, w8, md)},
        "max_abs_err": dcd["max_abs_err"],
        "max_abs_err_mma": dcd["max_abs_err_mma"],
        "lse_max_abs_err": dcd["lse_max_abs_err"],
        **{key: _per_step(dcd[key], dcd["calls_per_decode_step"])
           for key in ("ms", "ms_mma", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": dcd["bound_by"],
        "share_of_bound": dcd["share_of_bound"],
        "per_call": {key: dcd[key] for key in (
            "shape", "warps", "splits", "ms", "ms_mma", "ms_events", "plain_ms", "library_ms",
            "bound_ms", "share_of_bound", "share_of_bound_mma")},
        "tp_rank_call": {key: dcd["tp_case"][key] for key in (
            "shape", "warps", "splits", "ms", "ms_mma", "library_ms", "bound_ms",
            "share_of_bound")},
        "per": f"one decode step: {dcd['calls_per_decode_step']} calls at "
               f"{dcd['shape']} bf16 (the cache's 352 keys, each row valid up to its own "
               "position) on flash_decode_sm90.cu as routed; ms_mma is flash_fwd.cu at the "
               "same calls; library_ms SDPA with the boolean key mask; all by "
               f"{dcd['timed_by']}",
    }, *({
        "name": f"flash_bwd_{kind}",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/flash_bwd_sm90.cu",
        "sources": {"sm90": "tdax_torch/ops/csrc/flash_bwd_sm90.cu",
                    "mma": "tdax_torch/ops/csrc/flash_bwd.cu"},
        "replaces": f"tdax/ops/flash_attention.py:{line}",
        "launches": train["launches"][f"flash_bwd_{kind}"],
        "launches_by_kernel": {path: {
            "sm90": launches[f"flash_bwd_{kind}_sm90"],
            "mma": launches[f"flash_bwd_{kind}"] - launches[f"flash_bwd_{kind}_sm90"]}
            for path, launches in _train_paths(train, md)},
        "max_abs_err": max(s["max_abs_err"][o] for s in fbwd["sites"] for o in outs),
        "max_abs_err_mma": max(s["max_abs_err_mma"][o] for s in fbwd["sites"] for o in outs),
        "ms": dec[f"{kind}_ms"] * calls,
        "ms_mma": dec[f"{kind}_ms_mma"] * calls,
        "plain_ms": dec[f"plain_{kind}_ms"] * calls,
        "bound_ms": dec[f"{kind}_bound_ms"] * calls,
        "bound_by": dec[f"{kind}_bound_by"],
        "library_ms": dec["library_ms"] * calls,
        "per": f"one training step ({TRAIN_TIMED_STEPS} timed steps' launches): {calls} calls "
               "at [4, 1024, 32, 128] causal bf16 on the sm90 kernels the route picks (medians "
               f"of {BWD_REPEATS} x 10 calls); ms_mma is flash_bwd.cu at the same calls; "
               "library_ms is SDPA's whole backward (dq, dk and dv) alone at that shape, "
               f"is_causal=True without the key mask, by {dec['library_timed_by']}",
    } for kind, line, outs in (("dq", 395, ("dq",)), ("dkv", 446, ("dk", "dv")))), {
        "name": "sqdist",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/sqdist_sm90.cu",
        "sources": {"sm90": "tdax_torch/ops/csrc/sqdist_sm90.cu",
                    "fma": "tdax_torch/ops/csrc/sqdist.cu"},
        "replaces": "tdax/ops/pallas_distances.py:27",
        "launches": scale["launches"]["sqdist"],
        "launches_by_kernel": {
            "scale": {"sm90": scale["launches"]["sqdist_sm90"],
                      "fma": scale["launches"]["sqdist"] - scale["launches"]["sqdist_sm90"],
                      "split": scale["launches"]["split"]},
            **{f"scale_sparse_{run['run']}": {
                "sm90": run["launches"]["sqdist_sm90"],
                "fma": run["launches"]["sqdist"] - run["launches"]["sqdist_sm90"],
                "split": run["launches"]["split"]}
               for run in (*sparse["fused_runs"], sparse["blocked"], sparse["large"])},
            **{path: {"sm90": n[1], "fma": n[0] - n[1], "split": n[2]} for path, n in (
                ("multidevice_nccl_mesh_paths", md["nccl_world_of_one"]["sweep_scale"][
                    "mesh_sqdist_launches"]),
                ("multidevice_dp4_mesh_paths_rank0", md["gloo_dp4_sweep_scale"][
                    "stages_by_rank"][0]["mesh_sqdist_launches"]),
                ("multidevice_dp4_one_device_reference_rank0", md["gloo_dp4_sweep_scale"][
                    "compared"]["rips_at_scale"]["one_device_sqdist_launches"]))}},
        "max_abs_err": sq["max_abs_err"],
        **{k: sq["site"][k] for k in ("ms", "kernel_ms", "split_ms", "ms_fma", "plain_ms",
                                      "bound_ms", "bound_by", "bound_share", "library_ms",
                                      "f32_full_product_bound_ms")},
        "per": "one call at the scale path's [10000, 4096] f32 as routed (sqdist_sm90.cu: "
               "split pass + 3xTF32 product over the symmetric half; kernel_ms the product "
               "alone, split_ms the split alone, ms_fma sqdist.cu); bound_ms the symmetric "
               "half in three TF32 passes; library_ms is torch.cdist, the Euclidean "
               "function, whose wrapper (kernel + sqrt + zero diagonal) takes "
               f"{sq['site']['euclid_ms']:.4f} ms",
    }, {
        "name": "qmm",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/qmm_sm90.cu",
        "sources": {"sm90": "tdax_torch/ops/csrc/qmm_sm90.cu",
                    "mma": "tdax_torch/ops/csrc/qmm.cu"},
        "replaces": "tdax/ops/quant_matmul.py:40",
        "launches": int8["launches"]["qmm"],
        "launches_generate": gen["runs"][0]["launches"]["qmm"],
        "launches_by_kernel": {
            "int8_capture": {"sm90": int8["launches"]["qmm_sm90"],
                             "mma": int8["launches"]["qmm"] - int8["launches"]["qmm_sm90"]},
            **{f"generate{'_kv_int8' if run['kv_int8'] else ''}": {
                "sm90": run["launches"]["qmm_sm90"], "decode": run["launches"]["qmm_decode"],
                "mma": run["launches"]["qmm"] - run["launches"]["qmm_sm90"]
                - run["launches"]["qmm_decode"]} for run in gen["runs"]},
            "checkpoint_int8_capture": {
                "sm90": ckpt["int8_capture"]["launches"]["qmm_sm90"],
                "mma": ckpt["int8_capture"]["launches"]["qmm"]
                - ckpt["int8_capture"]["launches"]["qmm_sm90"]}},
        "max_abs_err": qmm["max_abs_err"],
        "max_abs_err_mma": qmm["max_abs_err_mma"],
        "grad": qmm["grad"],
        **_qmm_totals(qmm["sites"], "calls_per_capture_batch"),
        "per": f"one int8 capture batch of 16 ({QMM_PER_CAPTURE_BATCH} calls: "
               f"{QMM_SM90_PER_CAPTURE_BATCH} on qmm_sm90.cu and vit.patch_w on qmm.cu, as "
               "the route picks); ms_mma is every call on qmm.cu; library_ms is torch.matmul "
               "on the same weight pre-converted to bf16",
    }, {
        "name": "qmm_decode",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/qmm_decode_sm90.cu",
        "replaces": "tdax/ops/quant_matmul.py:40",
        "launches": gen["runs"][0]["launches"]["qmm_decode"],
        "launches_by_path": {f"generate{'_kv_int8' if run['kv_int8'] else ''}":
                             run["launches"]["qmm_decode"] for run in gen["runs"]},
        "max_abs_err": max(s["max_abs_err"] for s in qdec),
        "max_abs_err_mma": max(s["max_abs_err_mma"] for s in qdec),
        **_qmm_totals(qdec, "calls_per_decode_step"),
        "sites": {s["site"]: {key: s[key] for key in (
            "shape", "split", "ms", "ms_mma", "ms_events", "library_ms", "bound_ms",
            "share_of_bound", "calls_per_decode_step")} for s in qdec},
        "ragged": [r for r in qmm["ragged"] if r["route"] == "decode"],
        "per": f"one decode step ({QMM_PER_DECODE_STEP} calls at M = 16 over the five sites, "
               "each weighted by its calls) on qmm_decode_sm90.cu as routed; ms_mma is every "
               "call on qmm.cu; library_ms torch.matmul on the weight pre-converted to bf16; "
               "all by the card's kernel time (torch.profiler)",
    }, {
        "name": "vit_elementwise",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/vit_elementwise_sm90.cu",
        "kernels": ["vit_ln_rows", "vit_bias_epilogue"],
        "replaces": "none: tdax/models/qwen_vl/vit.py's layer_norm, gelu_tanh and bias and "
                    "residual adds are jnp, fused by XLA on the TPU",
        "launches": capture["vit_launches"],
        "launches_by_path": {"capture": capture["vit_launches"],
                             "int8_capture": {k: int8["launches"][k]
                                              for k in ("vit_ln_rows", "vit_bias_epilogue")}},
        "gelu_max_ulps": kern["vit"]["gelu_max_ulps"],
        "layer_norm_bias_and_residual_bitwise": kern["vit"]["bitwise"],
        "ms": kern["vit"]["ms"],
        "plain_ms": kern["vit"]["plain_ms"],
        "bound_ms": kern["vit"]["bound_ms"],
        "bound_by": "bytes",
        "sites": {c["site"]: {key: c[key] for key in (
            "shape", "form", "calls_per_batch", "ms", "plain_ms", "bound_ms", "share_of_bound")}
            for c in kern["vit"]["cases"] if "ms" in c},
        "per": f"one capture batch of 16 ({VIT_LN_PER_BATCH} vit_ln_rows and "
               f"{VIT_EPILOGUE_PER_BATCH} vit_bias_epilogue launches, each site weighted by "
               "its calls), bf16; bound_ms each input read and each output written once at "
               "3.35 TB/s; all by the card's kernel time (torch.profiler), L2 not flushed",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
