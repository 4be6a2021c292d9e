#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py [--frames 81]

Needs one CUDA card (exits non-zero without one, and outside a checkout of
the repository).  Phases, each printing one JSON line:

1. env      card name and power limit, torch/CUDA versions, TF32 flags and
            the time nvcc took to build every kernel of csrc/ (one nvcc per
            source, in parallel).
2. check    each kernel against its plain PyTorch version on the card, from
            the same bf16 inputs (plain version in fp32), at small and
            ragged shapes.  Dense, kv-masked, block-sparse and Sol flash
            attention: mean abs err <= 2e-2 * mean|ref| and max abs err <=
            2e-1 * max|ref| (bf16 rounding of P and the summation order;
            relative, since attention outputs shrink like 1/sqrt(S)); a
            fully masked batch item must come out as exact zeros; Sol's
            logsumexp: max abs err <= 1e-2; int8, int4, W8A8 and W4A8
            matmuls: relative Frobenius error <= 1e-2.  W8 and W4 also on
            structured weights with integer x, where every sum is exact:
            bit-equal to the plain version; and at shapes their TMA maps do
            not take, which the wrappers pad (the padding counters move).
            W8A8 and W4A8 also bit-equal to the plain product on the same
            int8 activations (the integer product is exact; the count of
            differing elements must be 0), at M = 1, ragged M, padded K
            and N, W4A8 with K < 2 KH, and on inputs with an all-zero row
            and a row whose x / sx fall on .5 ties; the activation
            quantization (act_quant) bit-equal to its plain version (x_q
            and the bits of sx) on each of those inputs and on the 14B 720p
            fc2 input (151,200 x 13,824).  Dense flash also at the i2v
            image cross-attention's ragged S = 257 (B 2, N 40).
            The table-driven kernels also where their 128-key tiles and the
            kv blocks do not line up (block_kv 64 and 192, S ending in the
            first tile of the last block), at block_q 64 and 192, D 64,
            with a q block of count 0 that must write zeros (Sol: and lse
            -1e30).  Dense flash also at the 5B's 24 heads (B 2, ragged L
            = 1,000, S = 512) and at Multitalk's audio cross-attention
            (1,560 tokens a latent frame over 32 audio tokens, k and v the
            strided halves of one projection); W8 (and W8A8) at the audio
            kv projection, 1,344 x 768 x 10,240.  Flash where the TMA
            maps refuse q, k or v and the wrapper pads D (80, 96) or copies
            (k, v rows 132 elements apart; q 8 bytes off), each counted as
            a padded launch.  The fp32 W8 and W4 GEMVs (csrc/wo_gemv.cu):
            relative Frobenius error <= 1e-5 (only the sum order differs)
            at (K)'s and (L)'s modulation shapes, at M = 2, 3 with
            N = 1,001, at M = 16 and with x's rows scaled by 1e-20, 1 and
            1e20 (each row held to the limit); two launches bit-equal.
            Dense flash also at HunyuanVideo 1.5's 16 heads
            over a ragged L = S = 1,000, and at (M)'s a2v / v2a shapes
            (27,280 x 251 and 251 x 27,280, 32 heads of 64).  The fp32 W8
            and W4 tile kernels (csrc/wo_f32_matmul.cu: x split into three
            exact bf16 parts for bf16 wgmma) at M = 17, 31, 251 and 1,001,
            the token tiles' edges 32, 33, 64, 65, K 128 / 256 / 1000 /
            2048 / 4096, N ragged, and rows scaled by 1e-20, 1 and 1e20:
            relative Frobenius error <= 1e-5, the GEMV not launched, two
            launches bit-equal.  Flash also at (P)'s joint attention (B 2,
            L = S = 4,624, 24 heads) and (Q)'s three (L = S = 4,608, 4,096
            and 512, 30 heads), W8 at (P)'s image-stream q and MLP (M =
            7,200) and text-stream q (M = 2,048), both GEMVs at (P)'s
            modulation (2 x 3,072 x 18,432).
            The Wan2.2 VAE decode at full width (random
            weights) against the same decode on the CPU for one small tile
            (2 x 4 x 4 latents): max abs err <= 1e-3.  The HunyuanVideo 1
            (884-16c) VAE at full width: decode (2 x 4 x 4 latents) and
            encode (5 frames of 32 x 32) against the CPU within 1e-4 *
            max|ref|, and a one-tile tiled decode equal to the whole.
3. dit      a small DiT forward on the card, through the kernels, against
            the same forward on the CPU through the plain versions: Wan
            with bf16, int8 and int8a8 weights and dense attention (48
            tokens), int4 weights with the radial mask and W4A8 with Sol
            (1,024 tokens, so both engage); a Wan i2v forward (in_dim 36
            with y, 257 CLIP tokens through the image cross-attention: 3
            flash launches a layer); a VACE + audio forward in bf16 and
            int8 (2 layers, 1 VACE block, audio of 32 tokens of 768 a
            latent frame: 8 flash and 37 W8 launches); Krea 2 at head_dim
            128 (its masked self-attention and text refiner); a Flux
            forward at full width with 2 double and 2 single blocks in
            bf16, int8 and int4 (4 flash; 20 W8 or W4 and 6 fp32 GEMV
            launches); a HunyuanVideo 1.5 forward at full width with 2
            double blocks at batch 2, one item's text masks all zero, in
            bf16 and int8 (2 flash; 24 W8 and 6 fp32 GEMV launches); an
            LTX-2 22B forward at full width with 2 blocks, audio on, over
            17 latent frames (68 video and 20 audio tokens, so the adaLN
            products run above 16 rows) in bf16 (12 flash), int8 from a
            quanto state dict with every linear quantized (72 W8, 22 fp32
            tile-kernel and 6 fp32 GEMV launches), int4 likewise (on the W4
            kernels) and a CFG batch 2 over contexts of 7 and 4 rows padded
            with a key mask (8 flash, 4 kv-masked); the other Flux forwards
            at full width with 2 double and 2 single blocks in bf16 (4
            flash each): FLUX.2 Klein 9B, the same with pi-FLUX.2's
            mixture heads, Chroma, Chroma-Radiance (its head made
            non-zero), FLUX.1 dev with Kontext's conditioning tokens and
            with USO's style tokens; a HunyuanVideo 1 forward at full
            width with 2 double + 2 single blocks, embedded guidance and
            CLIP's vector, in bf16 and int8 (4 flash; 28 W8 and 8 fp32
            GEMV launches): max abs err <= 3e-2 * max|ref|.
4. time     each kernel at the main paths' shapes beside its bound, its
            plain version and one PyTorch library call (yardstick only);
            the kernel's output there is held to the plain version in fp32
            with the limits of phase 2.  The 14B 720p shapes for the four
            kernels of the 14B path, with the radial mask's density and
            Sol's mean count over its table width, both with their share
            of the bound and their time per attended (query, key, head)
            against the dense kernel's at 14B; Krea 2's masked
            self-attention and text refiner at (O)'s 512 text slots beside
            the dense kernel, and its layer-wise text blocks through the
            dense kernel; W8 and W8A8
            at the 1.3B linears and cross k/v (M = 1,024), W8A8 at the 14B
            ones.  W8 and W4 rows add their share of the bound and their
            time over cuBLAS's.  A8 rows time the call (with its
            quantization), the product alone on activations quantized
            beforehand and the quantization alone, each with its share of
            its bound, beside torch._int_mm and the weight-only kernel at
            the same shape; act_quant alone at every A8 input shape.  W4
            and W4A8 at K=N=5120 run once more first, before any other
            timing.  The batch-1 shapes of (C) below: Sol at B1, the cross
            flash at B1 (S=512), W4A8 and act_quant at M = 75,600 and the
            cross k/v's M = 512, each with its launches per (C) forward.
            (F)'s flash shapes (14B at 832x480, CFG batch 2: self, text
            cross S = 512, image cross S = 257) and (G)'s (the 14B
            self-attention at 1280x720 at batch 2, W8 at the 14B linears
            and cross k/v) and (I)'s (the 5B's self- and cross-attention
            at B 2 over 27,280 tokens, 24 heads; W8 at its four linear
            shapes) and (J)'s (the audio cross-attention at 42 x 1,560
            tokens over 32 with strided k/v; W8 at the 14B linears at
            M = 65,520 and at the audio kv projection) and (K)'s (the
            joint attention at B1 L = S = 3,856, 24 heads; W8 at every block
            linear shape, M = 3,600 image, 256 text and 3,856 single-block
            tokens; the fp32 W8 and W4 GEMVs at M = 1, K = 3072, N = 18,432
            and 9,216, each launch on another of four weights so that the
            weight is cold in L2, beside torch.matmul on the fp32 weight)
            and (L)'s (the joint attention at B2 L = S = 10,262, 16 heads;
            W8 at the image stream's four linears, M = 19,500, and the text
            stream's qkv, M = 1,024; the fp32 W8 GEMV at M = 2, K = 2048,
            N = 12,288 and 4,096) and (M)'s (flash at the video
            self-attention, B1 L = S = 27,280, 32 heads of 128, its text
            cross, the audio self-attention at 251 tokens, 32 heads of 64,
            and the a2v / v2a crosses; W8 at the video q/k/v/out and FFN at
            M = 27,280 and the audio FFN; the fp32 W8 tile kernel at all
            twelve shapes (M) runs it at (the adaLN tables' t1, t2 and
            linear at M = 31 / 251, patchify and proj_out of both streams),
            the W4 one at the largest four, beside torch.matmul on the fp32
            weight; the GEMV at the prompt tables' six), each with its
            launches per forward.  (O)'s: the masked kernel at Krea 2's
            self-attention under the Qwen3 encoder (CFG batch 2 over 512
            text slots, of which the prompt's and the negative prompt's
            tokens are valid, then 4,096 image tokens) and at its text
            refiner (512 slots), the dense kernel at its layer-wise blocks
            (512 items of 12 layers).  (P)'s: flash at B2 L = S = 4,624
            over 24 heads, W8 at both streams' six block linears (M =
            7,200 and 2,048), the fp32 W8 GEMV at 2 x 3,072 x 18,432;
            (Q)'s: flash over 30 heads at 4,608, 4,096 and 512 tokens.
            (R)'s: flash at B1 L = S = 4,608 over 32 heads; (S)'s: flash
            at B1 L = S = 8,704 over 24 heads, W8 at its block linears
            (M = 8,192 image, 512 text, 8,704 single-block rows).
            (U)'s: flash at HV1's joint B1 L = S = 39,256 over 24 heads,
            W8 at the double blocks' image linears (M = 39,000: qkv, proj,
            mlp1, mlp2) and the single blocks' linear1 / linear2 (M =
            39,256), the fp32 W8 GEMV at the refiner's adaLN (1 x 3,072 x
            6,144).
            The fp32 rows time the call (in turns
            with the library call) and the kernel alone (a CUDA graph of
            the launches); the tile kernel's bound is three bf16 products
            or the bytes, with the fp32-SIMT bound beside it.
5. service  GenerationService on cuda answers 2 t2v_1.3B requests (832x480,
            guidance 5.0, UniPC, 2 steps) in bf16, 1 with quantize="int8"
            and 1 with quantize="int8a8"; then 14B (t2v) requests at
            1280x720x81f: (A) quantize="int4a8", attention_mode="sol",
            A_LAYERS = 20 of its 40 layers; (B) quantize="int4",
            attention_mode="radial",
            B_LAYERS = 5 of its 40 layers.  Every launch counter is reset
            just before each model's requests and read just after; the
            launches per DiT forward (Krea 2: and per request) are
            asserted, and that no
            W8, W4, W8A8 or W4A8 launch of a Wan request padded its
            operands.  Then three paths whose forwards are recorded one by
            one (launches, seconds, whether it ran the block stack), each
            forward's launches asserted against its calc/skip flag and the
            flags against the skip plan, the frames checked finite:
            (C) the JAX package's bench default on (A)'s pipeline: 14B
                720p int4a8 + Sol, sequential CFG (two batch-1 forwards a
                step), TeaCache for 1.75x (C_STEPS = 6 steps, 3 computed),
                bf16 residuals, through WanPipeline.generate;
            (D) t2v_1.3B from files: random weights exported as a
                quanto-int8 DiT file and a torch-layout VAE file, loaded by
                the service through make_checkpoints_resolver (the loaded
                tree equal to the written tensors bit for bit); DPM++, NAG
                2.0, MagCache, 8 steps (W8 on the loaded int8 weights);
            (E) t2v_1.3B sliding windows: 157 frames in two windows of 81
                overlapping by 5, Euler, first-block cache, 2 steps a
                window;
            (H) t2v_1.3B continue-video: (E)'s output continued by 81
                frames, overlap 5 (its last 5 frames encoded to the 2
                latent frames pinned at the window's start, asserted),
                2 UniPC steps, stitched to 233 frames;
            (N) t2v (Wan2.1 14B) in bf16, dense, N_LAYERS = 10 of its 40
                layers, at
                1280x720x81 through the service with the profile "wan/
                Lightx2v t2v Cfg Step Distill Rank32 - 4 Steps" (guidance
                1, so batch 1; flow_shift 2), STEPS of its 4 UniPC steps:
                its rank-32 LoRA, written from random weights under the
                profile URL's basename in <lora_root>/wan (every self- and
                cross-attention q/k/v/o and ffn.0/ffn.2 of the blocks
                with alpha, four .diff_b keys and a text_embedding pair),
                found by the resolver and merged at multiplier 1 (10 paths
                a layer matched, 1 unmatched, asserted); 2 flash launches a
                layer a forward and no W8; a merged q and fc1 slice within one
                bf16 ulp of the port's CPU merge from the file; after the
                service restores the base weights (what a request without
                LoRA does first) every DiT leaf's checksum equal to its
                value before the merge; LoRA write, read and merge, step,
                decode, request and restore seconds, the 4-step projection,
                the load, denoise and decode peaks and the host bytes held
                for the restore;
            (O) krea2_raw (Krea 2, all O_LAYERS = 28 layers, 12.8 B
                parameters) from its files at 1024x1024, guidance 3.5 (CFG as batch 2), 2
                steps, two requests writing PNGs: the DiT random on the
                card, exported block by block to a host state dict in the
                reference names and read back by load_krea2_params; the
                Qwen3-4B tower (36 layers, width 2560) random on the card,
                exported in HF names and read back by load_qwen_lm_params;
                the image VAE as qwen_vae.safetensors (bf16); all three
                through the service's checkpoints resolver and the
                handler's loaders (the loaded DiT re-exported equal to the
                state dict); the prompt hashed into Qwen3's vocabulary, 12
                hidden layers over the 512-token template: a masked flash
                launch a layer a forward, 4 masked and 4 dense a request;
            (P) qwen_image_20B (Qwen-Image: all P_LAYERS = 60 blocks
                of 3072, 24 heads of 128, 20.4 B parameters) from its
                files at the
                definition's 1280x720, guidance 4 (true CFG as batch 2), 2
                of its 25 steps: the DiT random on the card, exported
                block by block to a pinned host state dict in the layout
                of the definition's quanto-int8 file (every block linear
                int8, 20.56 GB) and freed; the Qwen2.5-VL-7B text tower
                (28 layers, width 3584, qkv bias, 7.6 B) likewise in HF
                names; the image VAE as qwen_vae.safetensors; all three
                through the resolver and the handler's loaders (the loaded
                DiT re-exported equal to the state dict); the prompt's
                states [1, 1,024, 3,584] (asserted): a flash, 12 W8 and
                2 fp32 W8 GEMV launches a block a forward, none padded;
            (Q) z_image (Z-Image Turbo: dim 3840, 30 heads, 30 + 2 + 2
                blocks, 6.15 B parameters) from its files at 1024x1024,
                guidance 0, 2 of its 8 unified steps: the DiT (bf16) and
                the Qwen3-4B tower as (P)'s, the Flux.1 AE written in
                diffusers' AutoencoderKL names and read through
                normalize_diffusers_vae_sd; the prompt's states [1, 512,
                2,560] (asserted): 34 flash launches a forward;
            (R) flux2_klein_9b (FLUX.2 Klein 9B: 8 double + 24 single
                blocks of 4096, 32 heads of 128, 9.08 B parameters) from
                its files at 1024x1024, the definition's 4 steps, bf16,
                guidance 1: the DiT and the Qwen3 tower at the JAX
                handler's width (4,096, 6.44 B) random on the card and
                exported to pinned host state dicts, the FLUX.2 VAE (32
                latent channels, quant convs, BatchNorm statistics) as
                flux2_vae.safetensors, read through the resolver and the
                handler's loaders (the loaded DiT's ends equal to the state
                dict); the prompt's layers 9, 18 and 27 over 512 tokens,
                [1, 512, 12,288] (asserted): 32 flash launches a forward;
            (S) flux_dev_kontext (FLUX.1 Kontext dev, 19 + 38 blocks, 11.9
                B) at 1024x1024 with one 1024x1024 reference image,
                quantize="int8", 2 of its 25 steps: the DiT through a
                pinned host state dict (its ends checked before the service
                quantizes it) and the AE file; a full-size random T5 v1.1
                XXL makes the context, a random CLIP vector `_vec_y`; the
                reference VAE-encoded to 128 x 128 latents (asserted), L =
                S = 8,704: 57 flash, 228 W8 and 76 fp32 W8 GEMV launches a
                forward, none padded; then USO on the same DiT: SigLIP
                so400m and the projector as bf16 files read back equal,
                one 512x512 style image through flux_dev_uso, 768 style
                tokens (asserted), the same launches;
            (T) flux_chroma, flux_chroma_radiance and pi_flux2 from random
                weights at full width and T_DOUBLE = 2 double + T_SINGLE
                = 4 single blocks, 1024x1024, 2 steps each (Radiance in
                pixel space with no VAE; pi-FLUX.2's heads written and read
                back equal, its 128-substep rollout): 6 flash launches a
                forward;
            (F) i2v (Wan2.1 14B image-to-video) at 832x480x81, bf16, dense,
                F_LAYERS = 10 of its 40 layers, a full-width CLIP ViT-H/14,
                from a 640x360 PNG (so both resizes run), 2 UniPC steps,
                guidance 5.0: CLIP, encode, step and decode seconds and
                peaks; 3 flash launches a layer a forward;
            (G) i2v_2_2 (Wan2.2 A14B) at 1280x720x81, quantize="int8" on
                both experts, dense, G_LAYERS = 5 of each expert's 40
                layers, the definition's two phases over 2 UniPC steps:
                the high-noise expert on the first forward and the
                low-noise one on the second (asserted), 2 flash and 10 W8
                launches a layer a forward, none
                padded; the 720p frame-chunked encode's seconds and peak;
            (I) ti2v_2_2 (Wan2.2 TI2V 5B: dim 3072, 24 heads, all
                I_LAYERS = 30 layers, 48 latent channels) from its files,
                as (D): a quanto-int8
                DiT under the name of the definition's second URL and a
                Wan2.2 VAE file (written from random weights, the loaded
                trees equal to them), at 1280x704x121 (31 x 44 x 80
                latents, 27,280 tokens), UniPC 2 steps, joint CFG,
                guidance 5, flow_shift 5, dense: 2 flash and 10 W8
                launches a layer a forward, none padded; the Wan2.2
                decode in 28 spatial tiles (asserted) of at most 31 x 16
                x 16 latents: write, load, step, decode and request
                seconds and the load, denoise and decode peaks;
            (J) vace_multitalk_14B (14B, J_LAYERS = 6 of its 40 layers,
                5 VACE blocks, the multitalk module's audio
                cross-attention in every block)
                at 832x480x81 through WanPipeline.generate_multitalk with a
                VACE context: the DiT random and quantized int8 in
                process, the multitalk module (bf16) and a wav2vec2-base
                (fp32) written as files from random weights and read back
                by their loaders (the read-back tensors equal to the
                written ones); a 16 kHz WAV of 81 / 25 s through wav2vec2,
                a control video with a half-frame mask through
                build_vace_conditioning, 2 UniPC steps at guidance 1 and
                audio guidance 4 (one batch-2 forward a step: 24 flash and
                111 W8 launches, none padded), the Wan2.1 decode: init,
                write, read, quantize, wav2vec2, encode, step, decode and
                request seconds and the load, encode, denoise and decode
                peaks;
            (K) flux_schnell (Flux.1 schnell at full width, K_DOUBLE = 5
                of its 19 double and K_SINGLE = 10 of its 38 single blocks
                (10 + 19 before), so that the files the whole
                script writes stay under the 45 GiB a one-card call may
                write and the script in its time) at the definition's
                1280x720 and 10 steps (its file overrides the handler's 4),
                from files written from random weights (the DiT in bf16
                under the definition's first URL, the AE and CLIP-L) and
                loaded through the resolver (read-back trees equal to the
                written ones); a full-size random T5 v1.1 XXL encodes the
                prompt's 256 hash ids into the requests' context (t5_s); a
                bf16 request, the same tree quantized int8 in process and a
                second request, then a quantize="int4" service loads the
                file again for 2 steps: a flash a block a forward, and 8 W8
                and 2 fp32 W8 GEMVs a double block, 2 W8 and 1 GEMV a
                single block (int8; int4: the same on W4), none padded;
                write, load, quantize, step, decode and request
                seconds and the peaks;
            (L) hunyuan_1_5_480_t2v (HunyuanVideo 1.5, 8.3 B: L_LAYERS =
                14 of its 54 double blocks, hidden 2048, 16
                heads of 128) at the definition's
                832x480x97 and guidance 6.0 (CFG as batch 2: the empty
                negative prompt through the same LM), flow_shift 5, 2 Euler
                steps (the definition: 30), from files written from random
                weights (the DiT as a quanto-int8 file under the
                definition's second URL, picked by the resolver for
                quantization "int8"; the HV1.5 VAE in fp32; byT5-small with
                a grown vocabulary; CLIP-L; the loaded DiT equal to the
                written tensors); the LLaMA-3 8B tower random on the card
                over hash ids; a quoted "OPEN" in the prompt through byT5
                and the glyph mapper; the video decoded in 15 tiles
                (asserted): a flash, 8 W8 and 2 fp32 W8 GEMV launches a
                block a forward (the refiner's 8 W8 and 2 GEMVs more), none
                padded; init, write, load, LM, byT5, CLIP,
                step, decode and request seconds and the load, denoise and
                decode peaks;
            (M) ltx2_22B_distilled (LTX-2 22B: M_LAYERS = 12 of its 48
                blocks, video 32 x 128,
                audio 32 x 64, gated attention, prompt adaLN) at
                1280x704x241 (the definition's 1280x720 does not divide by
                the 32-pixel stride), its guidance 1 and 2 of its 8
                distilled steps: Gemma-3 12B random on the card, through an
                in-memory state dict and its loader at full depth, encodes
                the prompt's bytes (per-token RMS features, a random caption
                projection) and is freed; the DiT random on the card,
                exported to an in-memory quanto-int8 state dict (every
                linear) and read back by the loader; the untiled video
                decode, the audio decode and vocoder; one AVI with a stereo
                24 kHz PCM16 stream (asserted): 6 flash and 34 W8 a block
                (4 W8 more), 22 fp32 tile-kernel and 6 fp32 GEMV launches
                a forward, none padded;
                Gemma init, export/load and encode, DiT init, export and
                load, step, decode, audio and request seconds and the encode,
                load, denoise and decode peaks.  Then the DiT at 2 blocks
                (quanto int8, under the definition's second URL), the video
                VAE (bf16), the audio VAE, the vocoder and the caption
                projection as files, loaded through the service's resolver
                and held to the written tensors bit for bit.
            (U) hunyuan (HunyuanVideo 1 13B: all U_DOUBLE = 20 double +
                U_SINGLE = 40 single blocks of 3072) at its handler's
                832x480x97 (39,000 image + 256 LM tokens), guidance 1 with
                embedded guidance 6 (batch 1), flow_shift 7, 2 of its 30
                steps: the DiT random on the card, exported to an
                in-memory quanto-int8 state dict in the definition's second
                URL's layout and served to the handler's loader (re-exported
                equal); the 884 VAE (fp32) and CLIP-L written and read
                through the resolver; the LLaMA-3 8B tower random on the
                card over hash ids; the 15-tile decode (asserted); 60 flash,
                248 W8 and 82 fp32 GEMV launches a forward, none padded;
                init, export, write, load, LM, CLIP, step, decode and
                request seconds and the peaks.  Then the DiT at 2 + 4
                blocks as a file under the definition's second URL, loaded
                with the VAE and CLIP files through the resolver and held
                to the written tensors.
            (V) hunyuan_i2v and hunyuan_1_5_480_i2v from an 832x480 PNG
                through their own VAEs' encode (latent_concat),
                hunyuan_custom with the PNG as its reference, hunyuan_avatar
                through generate_custom (random Whisper-tiny window
                features, a face box, motion, fps) and
                hunyuan_1_5_upsampler (SR720, 4 meanflow steps at
                1280x704), random weights at (T)'s depth (HV1 2 + 4
                blocks, HV1.5 4), latents out; a flash a block a forward.
6. t5       a full-width random UMT5-XXL encodes one prompt.
7. disk     the bytes the script wrote (checkpoints, LoRA, outputs; files
            it deleted included).
8. kernels  every ported kernel with its check, launches and times.

Then the card's `nvidia-smi` name and power limit, and the last line
{"ok": true, "device": {...}}.  Any failure raises (exit code 1) before it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12         # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
STEPS = 2                       # denoise steps per service request
# depths cut to keep the script inside its 1200 s with (N) and (O), then
# (P) and (Q), then (U) and (V) (each: the depths before -> now, of the
# model's own)
B_LAYERS = 5                    # (B) t2v 14B: 40 -> 10 -> 5 of 40 layers
A_LAYERS = 20                   # (A) and (C) t2v 14B: 40 -> 30 -> 20 of 40
F_LAYERS = 10                   # (F) i2v 14B: 40 -> 20 -> 10 of 40 layers
G_LAYERS = 5                    # (G) i2v_2_2: 40 -> 10 -> 5 of each expert's
J_LAYERS = 6                    # (J) vace_multitalk_14B: 40 -> 10 -> 6 of 40
I_LAYERS = 30                   # (I) ti2v_2_2 5B: all 30 layers
# cut to make room for (R), (S) and (T), then for (U) and (V)
N_LAYERS = 10                   # (N) t2v 14B + LoRA: 40 -> 20 -> 10 of 40
M_LAYERS = 12                   # (M) ltx2_22B_distilled: 48 -> 24 -> 12
L_LAYERS = 14                   # (L) hunyuan_1_5_480_t2v: 54 -> 27 -> 14
O_LAYERS = 28                   # (O) krea2_raw: all 28 layers
P_LAYERS = 60                   # (P) qwen_image_20B: all 60 blocks
# (N): t2v 14B in bf16 at 1280x720x81 through the Lightx2v profile (one
# rank-32 LoRA at multiplier 1, guidance 1, flow_shift 2, 4 steps), its
# LoRA written from random weights under the URL's basename
N_PROFILE = "wan/Lightx2v t2v Cfg Step Distill Rank32 - 4 Steps"
N_RANK = 32
N_PROFILE_STEPS = 4
# (O): krea2_raw from its files: 12 Qwen3 hidden layers over the 512-token
# template; 4,096 image tokens after them
O_TEXT = 512
# (P): qwen_image_20B from its files at the definition's 1280x720 (90 x 160
# latents, 45 x 80 = 3,600 image tokens) after the Qwen2.5-VL encoder's
# 1,024 text slots; true CFG as batch 2; the DiT a quanto-int8 state dict
P_W, P_H = 1280, 720
P_IMG = (P_H // 16) * (P_W // 16)
P_TXT = 1024
P_TOKENS = P_TXT + P_IMG
# launches per (P) forward: a block's joint flash, W8 on each stream's q,
# k, v, out, mlp1 and mlp2 (12: the image stream at M = 2 x 3,600, the
# text at 2 x 1,024) and the fp32 GEMV on img_mod and txt_mod (2)
P_PER_FORWARD = {
    "joint_qwen_P": P_LAYERS,
    f"{2 * P_IMG}x3072x3072": 4 * P_LAYERS,
    f"{2 * P_IMG}x3072x12288": P_LAYERS, f"{2 * P_IMG}x12288x3072": P_LAYERS,
    f"{2 * P_TXT}x3072x3072": 4 * P_LAYERS,
    f"{2 * P_TXT}x3072x12288": P_LAYERS, f"{2 * P_TXT}x12288x3072": P_LAYERS,
    "2x3072x18432": 2 * P_LAYERS}
P_KERNELS = {"flash_attention": P_LAYERS, "matmul_w8": 12 * P_LAYERS,
             "matmul_w8_gemv": 2 * P_LAYERS}
# (Q): z_image (Turbo) at 1024x1024: 4,096 image tokens (a multiple of 32:
# no pad) and the Qwen3 encoder's 512 caption slots; guidance 0, batch 1;
# a forward: 30 main blocks over both, 2 noise- and 2 context-refiner
# blocks over each alone
Q_W = Q_H = 1024
Q_IMG, Q_TXT = (Q_H // 16) * (Q_W // 16), 512
Q_PER_FORWARD = {"main_zimage_Q": 30, "noise_refiner_zimage_Q": 2,
                 "context_refiner_zimage_Q": 2}
Q_KERNELS = {"flash_attention": 34}
FLASH_MEAN_REL, FLASH_MAX_REL = 2e-2, 2e-1     # of mean|ref|, max|ref|
LSE_MAX_ABS = 1e-2
MM_REL_FRO = 1e-2               # int8 / int4 / W8A8 / W4A8 matmuls
GEMV_REL_FRO = 1e-5             # the fp32 GEMV: only the sum order differs
FLUX_CHECK_TOKENS = (16, 8, 8)  # text tokens, image token rows, columns
KREA2_TEXT = 64                 # tokens of the random Krea 2 text encoder
VAE22_MAX_ABS = 1e-3            # Wan2.2 VAE decode, card against CPU (fp32)
# (K): flux_schnell at its definition's 1280x720: 45 x 80 image tokens
# after schnell's 256 T5 tokens
K_W, K_H, K_TXT = 1280, 720, 256
# (K)'s depth, of flux-schnell's 19 double and 38 single blocks: cut so that
# the files the script writes stay under the 45 GiB a one-card machine lets
# a call write ((L) adds 14.4 GB), then (10 + 19 -> 5 + 10) to make
# room for (R), (S) and (T) in the time limit
K_DOUBLE, K_SINGLE = 5, 10
K_TOKENS = K_TXT + (K_H // 16) * (K_W // 16)
# (I): Wan2.2 TI2V 5B at its definition's 121 frames and the Wan2.2
# generate.py size for ti2v-5B (1280x720 gives 45 latent rows, which the
# 2x2 patch does not divide): 31 x 44 x 80 latents, 27,280 tokens
I_FRAMES, I_W, I_H = 121, 1280, 704
# (L): hunyuan_1_5_480_t2v at its definition's 832x480x97: 25 x 30 x 52
# latents, 25 x 15 x 26 = 9,750 image tokens after the 2x2 patch, then the
# LM's 256 and byT5's 256 tokens in the joint sequence; CFG as batch 2
L_W, L_H, L_FRAMES = 832, 480, 97
L_IMG = ((L_FRAMES - 1) // 4 + 1) * (L_H // 32) * (L_W // 32)
L_TXT = 256 + 256
L_TOKENS = L_IMG + L_TXT
# (M): ltx2_22B_distilled at 1280x704x241 (its definition's 1280x720 gives
# 22.5 latent rows, which the (8, 32, 32) stride does not divide): 31 x 22 x
# 40 = 27,280 video tokens, 241 / 24 s x 25 = 251 audio tokens, the
# prompt's UTF-8 bytes as Gemma ids
M_W, M_H, M_FRAMES = 1280, 704, 241
M_GRID = ((M_FRAMES - 1) // 8 + 1, M_H // 32, M_W // 32)
M_TOKENS = M_GRID[0] * M_GRID[1] * M_GRID[2]
M_AUDIO = int(M_FRAMES / 24 * 25)
M_PROMPT = ("a red fox trots through fresh snow at dawn, its breath "
            "steaming; crows call from the pines and the snow creaks")
# (M)'s DiT file (written after the request, loaded back): its depth
M_FILE_LAYERS = 2
# (U): hunyuan (HunyuanVideo 1 13B, all 20 double + 40 single blocks) at
# its handler's 832x480x97: 25 x 60 x 104 latents at the 884 VAE's (4, 8,
# 8) stride, 25 x 30 x 52 = 39,000 image tokens after the 2x2 patch, then
# the LM's 256 tokens; guidance 1 (embedded 6): batch 1
U_W, U_H, U_FRAMES = 832, 480, 97
U_DOUBLE, U_SINGLE = 20, 40
U_IMG = ((U_FRAMES - 1) // 4 + 1) * (U_H // 16) * (U_W // 16)
U_TXT = 256
U_TOKENS = U_IMG + U_TXT
# (U)'s DiT files (written after the request, loaded back): their depth
U_FILE_DOUBLE, U_FILE_SINGLE = 2, 4
U_PROMPT = (
    "A lighthouse stands on a rocky cliff at dusk while heavy waves break "
    "against the stones far below, sending white spray into the cold air; "
    "gulls circle and cry in the strong wind, a small fishing boat with a "
    "red hull rocks on the swell near the harbour wall, its lantern "
    "swinging, and the lighthouse beam sweeps slowly across the dark sea "
    "and the low clouds; the camera drifts along the cliff edge toward the "
    "tower, the grass bending in the gusts, the last orange light fading "
    "on the horizon, cinematic, detailed, gentle film grain and a calm, "
    "quiet mood")
# launches per (U) forward (int8 from a quanto state dict): a flash a
# block; W8 on each double block's image and text qkv, proj, mlp1, mlp2,
# on each single block's linear1 and linear2, and on the refiner's 2
# blocks (4 each); the fp32 W8 GEMV on each double block's two
# modulations, each single block's one and the refiner's 2 adaLN
U_PER_FORWARD = {"joint_hv1_U": U_DOUBLE + U_SINGLE,
                 f"{U_IMG}x3072x9216": U_DOUBLE,
                 f"{U_IMG}x3072x3072": U_DOUBLE,
                 f"{U_IMG}x3072x12288": U_DOUBLE,
                 f"{U_IMG}x12288x3072": U_DOUBLE,
                 f"{U_TOKENS}x3072x21504": U_SINGLE,
                 f"{U_TOKENS}x15360x3072": U_SINGLE,
                 "1x3072x18432": 2 * U_DOUBLE, "1x3072x9216": U_SINGLE,
                 "1x3072x6144": 2}
U_KERNELS = {"flash_attention": U_DOUBLE + U_SINGLE,
             "matmul_w8": 8 * U_DOUBLE + 2 * U_SINGLE + 8,
             "matmul_w8_gemv": 2 * U_DOUBLE + U_SINGLE + 2}
# (V): the other HunyuanVideo rows at (T)'s depth (HV1: 2 double + 4
# single blocks; HV1.5: 4 double blocks), random weights, latents out
V_HV1 = (2, 4)
V_HV15 = 4
HV1_VAE_REL = 1e-4              # the 884 VAE, card against CPU (fp32)
F32_REL_FRO = 1e-5              # the fp32 tile kernel: only the sum order
# (R): flux2_klein_9b at 1024x1024, the definition's 4 steps: the Qwen3
# tower's 512 text tokens, then 64 x 64 image tokens; batch 1; a forward:
# one joint flash a block (8 double + 24 single)
R_W = R_H = 1024
R_TXT = 512
R_TOKENS = R_TXT + (R_H // 16) * (R_W // 16)
R_STEPS = 4
R_KERNELS = {"flash_attention": 32}
R_PER_FORWARD = {"joint_klein9b_R": 32}
# (S): flux_dev_kontext at 1024x1024 with one 1024x1024 reference image:
# 512 T5 tokens, 4,096 noise and 4,096 reference tokens; quantize int8;
# a forward: 57 joint flash; W8 on each stream's qkv, proj, mlp.0, mlp.2 of
# the 19 double blocks (the image stream at M = 8,192, the text at 512)
# and linear1 / linear2 of the 38 single blocks (M = 8,704); the fp32
# GEMV on each block's modulation
S_W = S_H = 1024
S_TXT = 512
S_IMG = 2 * (S_H // 16) * (S_W // 16)
S_TOKENS = S_TXT + S_IMG
S_PER_FORWARD = {"joint_kontext_S": 57,
                 **{f"{m}x{k}x{n}": 19 for m in (S_IMG, S_TXT)
                    for k, n in ((3072, 9216), (3072, 3072), (3072, 12288),
                                 (12288, 3072))},
                 f"{S_TOKENS}x3072x21504": 38, f"{S_TOKENS}x15360x3072": 38,
                 "1x3072x18432": 38, "1x3072x9216": 38}
S_KERNELS = {"flash_attention": 57, "matmul_w8": 228, "matmul_w8_gemv": 76}
# (S)'s USO request: SigLIP so400m's 768 style tokens before the text
USO_STYLE = 768
# (T): flux_chroma, flux_chroma_radiance and pi_flux2 at full width and
# 1024x1024 from random weights, each cut to 2 double + 4 single blocks
T_DOUBLE, T_SINGLE = 2, 4
T_W = T_H = 1024
REPO = os.path.dirname(os.path.abspath(__file__))
# logs and the (deleted after checking) outputs, beside the built kernels
OUT = os.path.join(REPO, "wan2gp_tpu_torch", "_build", "chip_smoke")


T_START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line: the phase, the seconds since the script started, and
    the phase's fields."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - T_START,
                      **fields}), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches, in ms."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least time in ms, "operations" | "bytes") on the card's peaks."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def rates(flops: float, ms: float, bound_ms: float) -> dict:
    """Achieved tensor-core rate and the share of the bound reached."""
    return {"tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}


# PyTorch's fused attention backends; the yardstick of a flash kernel is the
# fastest of them that takes its inputs
SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_ms(q, k, v, reps: int, **kw) -> dict:
    """F.scaled_dot_product_attention on heads-first q, k, v, timed with
    each fused backend alone: {backend: ms}, for those that take the inputs
    (the default call picks one of them)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in SDPA_BACKENDS:
        try:
            with warnings.catch_warnings(), \
                    sdpa_kernel([getattr(SDPBackend, name)]):
                warnings.simplefilter("ignore")
                out[name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, **kw), reps)
        except RuntimeError:            # this backend refuses these inputs
            pass
    if not out:
        raise AssertionError("no fused SDPA backend takes these inputs")
    return out


def library_sdpa(times: dict, what: str) -> dict:
    best = min(times, key=times.get)
    return {"library_ms": times[best], "sdpa_ms": times,
            "library_call": f"F.scaled_dot_product_attention{what}, fastest "
                            f"fused backend: {best}"}


def randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ------------------------------------------------------------------ phases

def phase_env():
    from wan2gp_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(_cuda.BUILD, ignore_errors=True)    # build from source
    t0 = time.perf_counter()
    logs = _cuda.build_all()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "nvcc.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    ptxas = []              # "<mangled kernel>: spills; registers, smem"
    warnings = []           # "(C75xx) <function>": serialized wgmmas
    for log in logs.values():
        entry = spill = ""
        for ln in log.splitlines():
            if "(C75" in ln:
                warnings.append(ln[ln.index("(C75"):][:7] + " "
                                + ln.rsplit("function", 1)[-1].strip(" '"))
            elif "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif "spill" in ln:
                spill = ln.strip()
            elif "Used" in ln and "registers" in ln:
                ptxas.append(f"{entry}: {spill}; "
                             f"{ln.split(':', 1)[1].strip()}")
    emit("env", card=nvidia_smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         kernels_built=sorted(logs), build_s=build_s, ptxas=ptxas,
         ptxas_warnings=warnings)


_ATTN_TOL = (f"mean_abs<={FLASH_MEAN_REL}*mean|ref|, "
             f"max_abs<={FLASH_MAX_REL}*max|ref|")
TOLERANCE = {"flash_attention": _ATTN_TOL,
             "flash_attention_kvmask": _ATTN_TOL + ", fully masked item == 0",
             "sparse_flash": _ATTN_TOL,
             "sol_flash": _ATTN_TOL + f", lse max_abs<={LSE_MAX_ABS}",
             "matmul_w8": f"rel_fro<={MM_REL_FRO}",
             "matmul_w8a8": f"rel_fro<={MM_REL_FRO}, wrong_elements==0",
             "matmul_w4": f"rel_fro<={MM_REL_FRO}",
             "matmul_w4a8": f"rel_fro<={MM_REL_FRO}, wrong_elements==0",
             "act_quant": "x_q and the bits of sx equal the plain version's",
             "matmul_w8_gemv": f"rel_fro<={GEMV_REL_FRO}",
             "matmul_w4_gemv": f"rel_fro<={GEMV_REL_FRO}",
             "matmul_w8_f32": f"rel_fro<={F32_REL_FRO}",
             "matmul_w4_f32": f"rel_fro<={F32_REL_FRO}",
             "vae22_decode": f"max_abs<={VAE22_MAX_ABS} against the CPU"}


def counters():
    """{kernel name: (module, attribute)} of every launch counter."""
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    from wan2gp_tpu_torch.ops import sparse_attention as SP
    from wan2gp_tpu_torch.ops import sol_attention as SOL
    return {"flash_attention": (A, "launches"),
            "flash_attention_kvmask": (A, "kvmask_launches"),
            "matmul_w8": (Q, "launches"),
            "matmul_w8a8": (Q, "w8a8_launches"),
            "sparse_flash": (SP, "launches"),
            "sol_flash": (SOL, "launches"),
            "matmul_w4": (Q, "w4_launches"),
            "matmul_w4a8": (Q, "w4a8_launches"),
            "act_quant": (Q, "act_quant_launches"),
            "matmul_w8_gemv": (Q, "w8_gemv_launches"),
            "matmul_w4_gemv": (Q, "w4_gemv_launches"),
            "matmul_w8_f32": (Q, "w8_f32_launches"),
            "matmul_w4_f32": (Q, "w4_f32_launches")}


def reset_pads():
    """Zero the counts of launches whose operands were padded or copied."""
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    A.flash_pad_launches = 0
    Q.w8_pad_launches = Q.w4_pad_launches = 0
    Q.w8a8_pad_launches = Q.w4a8_pad_launches = 0
    Q.w8_f32_pad_launches = Q.w4_f32_pad_launches = 0


def read_pads() -> int:
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    return (A.flash_pad_launches + Q.w8_pad_launches + Q.w4_pad_launches
            + Q.w8a8_pad_launches + Q.w4a8_pad_launches
            + Q.w8_f32_pad_launches + Q.w4_f32_pad_launches)


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in counters().items()}


def phase_check():
    """Each kernel against its plain version; returns the errors."""
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_cases = {
        "self_ragged_d128": (1, 1000, 1000, 2, 128),
        "self_ragged_d64": (1, 1000, 1000, 2, 64),
        "cross_s512": (2, 4096, 512, 12, 128),
        # one query row over 70 keys: mostly kv tail, fails unless masked
        "tail_l1_s70": (1, 1, 70, 3, 128),
        # Krea 2's layer-wise text blocks: B*L_txt items of the 12 layers
        "krea2_layerwise": (64, 12, 12, 20, 128),
        # the i2v image cross-attention: 257 CLIP tokens, a ragged S
        "image_cross_s257": (2, 1000, 257, 40, 128),
        # the 5B's 24 heads over a ragged L, at its cross-attention's S
        "ti2v_5B_n24_l1000_s512": (2, 1000, 512, 24, 128),
        # HunyuanVideo 1.5's 16 heads over a ragged joint sequence
        "hv15_n16_l1000": (2, 1000, 1000, 16, 128),
        # (M)'s audio -> video and video -> audio cross-attentions: 32 heads
        # of 64 between the 27,280 video and 251 audio tokens
        "ltx2_a2v_d64": (1, M_TOKENS, M_AUDIO, 32, 64),
        "ltx2_v2a_d64": (1, M_AUDIO, M_TOKENS, 32, 64),
        # (P)'s joint attention at CFG batch 2; (Q)'s main, noise-refiner
        # and context-refiner self-attentions, 30 heads
        "qwen_P_joint_b2_n24": (2, P_TOKENS, P_TOKENS, 24, 128),
        "zimage_Q_main_n30": (1, Q_TXT + Q_IMG, Q_TXT + Q_IMG, 30, 128),
        "zimage_Q_noise_refiner_n30": (1, Q_IMG, Q_IMG, 30, 128),
        "zimage_Q_context_refiner_n30": (1, Q_TXT, Q_TXT, 30, 128),
    }
    flash = {}
    for name, (b, l, s, n, d) in flash_cases.items():
        q, k, v = (randn(sh, gen) for sh in
                   ((b, l, n, d), (b, s, n, d), (b, s, n, d)))
        flash[name] = flash_check(name, q, k, v,
                                  A.flash_attention(q, k, v, _scale(q)))
    # strided views of a packed [B, L, 3, N, D] tensor (no copies)
    qkv = randn((2, 777, 3, 4, 128), gen)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    flash["strided_qkv"] = flash_check(
        "strided_qkv", q, k, v, A.flash_attention(q, k, v, _scale(q)))
    # Multitalk's audio cross-attention: each latent frame's tokens over
    # its 32 audio tokens, k and v the two halves of one kv projection
    q, k, v = audio_qkv(6, 1560, gen)
    flash["audio_cross_strided_s32"] = flash_check(
        "audio_cross_strided_s32", q, k, v,
        A.flash_attention(q, k, v, _scale(q)))
    # what the TMA maps refuse, padded or copied by the wrapper: D 80 and
    # 96 (zero-padded to 128), k and v rows 132 elements apart, q 8 bytes
    # past an aligned base
    for name, (b, l, s, n, d) in {
            "relaid_d80": (1, 500, 300, 3, 80),
            "relaid_d96": (2, 300, 777, 2, 96),
            "relaid_kv_stride_132": (2, 400, 300, 3, 128),
            "relaid_q_offset_8_bytes": (1, 300, 300, 2, 128)}.items():
        q, k, v = (randn(sh, gen) for sh in
                   ((b, l, n, d), (b, s, n, d), (b, s, n, d)))
        if name == "relaid_kv_stride_132":
            k, v = (randn((b, s, n, 132), gen)[..., :128] for _ in range(2))
        elif name == "relaid_q_offset_8_bytes":
            q = randn((q.numel() + 4,), gen)[4:].view(q.shape)
        pads = A.flash_pad_launches
        flash[name] = flash_check(name, q, k, v,
                                  A.flash_attention(q, k, v, _scale(q)))
        if A.flash_pad_launches != pads + 1:
            raise AssertionError(f"flash_attention {name}: not counted as "
                                 f"a padded launch")

    w8_cases = {"qkvo_1536x1536": (4096, 1536, 1536),
                "fc1_1536x8960": (4096, 1536, 8960),
                "fc2_8960x1536": (4096, 8960, 1536),
                "ragged_m": (333, 1536, 1536),
                "ragged_mnk": (77, 100, 51),
                # Multitalk's audio kv projection: 42 frames x 32 tokens
                "audio_kv_768x10240": (1344, 768, 10240)}
    w8 = {}
    for name, (m, k, n) in w8_cases.items():
        x = randn((m, k), gen)
        wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        pads = Q.w8_pad_launches
        w8[name] = mm_check("matmul_w8", name, Q.matmul_w8(x, wq, sc),
                            Q.matmul_w8_ref(x.float(), wq, sc))
        w8[name]["padded"] = Q.w8_pad_launches - pads
    # (P)'s image-stream q and MLP and its text-stream q (W8 only)
    for name, (m, k, n) in {"qwen_P_img_q": (2 * P_IMG, 3072, 3072),
                            "qwen_P_img_mlp1": (2 * P_IMG, 3072, 12288),
                            "qwen_P_img_mlp2": (2 * P_IMG, 12288, 3072),
                            "qwen_P_txt_q": (2 * P_TXT, 3072, 3072)}.items():
        x = randn((m, k), gen)
        wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        pads = Q.w8_pad_launches
        w8[name] = mm_check("matmul_w8", name, Q.matmul_w8(x, wq, sc),
                            Q.matmul_w8_ref(x.float(), wq, sc))
        w8[name]["padded"] = Q.w8_pad_launches - pads
    w8["structured_exact"] = structured_check("w8", 600, 1536, 1536)

    from wan2gp_tpu_torch.ops import sparse_attention as SP
    from wan2gp_tpu_torch.ops import sol_attention as SOL
    # (B, L, N, D, block_q, block_kv, every row reads the last kv block);
    # the 128-key tiles against the kv blocks: block_kv 64 (two blocks a
    # tile), 192 (a tile half past each block end), S in the first tile of
    # the last block (the next tiles lie wholly past S, and no key of them
    # may count); block_q 64 and 192 take the 64-row CTA
    sparse = {}
    for name, (b, l, n, d, bq, bkv, tail) in {
            "ragged_d128_q128_kv64": (1, 1000, 2, 128, 128, 64, False),
            "ragged_d64_q64_kv256": (2, 777, 3, 64, 64, 256, False),
            "q512_kv256": (1, 2048, 2, 128, 512, 256, False),
            "kv64_q256": (1, 1000, 2, 128, 256, 64, True),
            "q64_kv128": (2, 700, 2, 128, 64, 128, True),
            "kv192_q192_d64": (1, 1000, 2, 64, 192, 192, True),
            "s_in_first_tile_kv256": (1, 800, 2, 128, 128, 256, True),
            "s_in_first_tile_kv512_d64": (1, 1100, 2, 64, 512, 512,
                                          True)}.items():
        q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
        mask = torch.rand((-(-l // bq), -(-l // bkv)), generator=gen,
                          device="cuda") < 0.5
        if tail:
            mask[:, -1] = True
        mask[1] = False                      # a q block that attends nothing
        kv_idx, counts = (torch.from_numpy(a).cuda() for a in
                          SP.compress_block_mask(mask.cpu().numpy()))
        got = SP.sparse_flash(q, k, v, kv_idx, counts, _scale(q), bq, bkv)
        ref = SP.table_attention_ref(q.float(), k.float(), v.float(),
                                     kv_idx[None], counts[None], _scale(q),
                                     bq, bkv)[0]
        if got[:, bq:2 * bq].any():
            raise AssertionError(f"sparse_flash {name}: the q block with "
                                 f"count 0 is not zero")
        sparse[name] = attn_check("sparse_flash", name, q, k, got, ref)
        sparse[name]["blocks"] = [bq, bkv]
    # (B, L, N, D, block_q, block_kv); group 1's first q block attends
    # nothing (zeros, lse -1e30)
    sol = {}
    for name, (b, l, n, d, bq, bkv) in {
            "ragged_l1500": (1, 1500, 2, 128, 512, 256),
            "b2_l2048": (2, 2048, 3, 128, 512, 256),
            "d64": (1, 1500, 2, 64, 512, 256),
            "q128_kv64": (1, 1000, 2, 128, 128, 64),
            "q64_kv256": (1, 777, 2, 128, 64, 256),
            "s_in_first_tile_kv256": (1, 1300, 2, 128, 512, 256)}.items():
        q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
        idx, cnt, _, _ = SOL.sol_route(q, k, _scale(q), 0.5, bq, bkv,
                                       budget=0.5)
        cnt[1, 0] = 0                        # a row that attends nothing
        got, lse = SOL.sol_flash(q, k, v, idx, cnt, _scale(q), bq, bkv)
        ref, ref_lse = SP.table_attention_ref(q.float(), k.float(),
                                              v.float(), idx, cnt,
                                              _scale(q), bq, bkv)
        zb, zh = divmod(1, n)
        if got[zb, :bq, zh].any() or not (lse[zb, zh, :bq] == -1e30).all():
            raise AssertionError(f"sol_flash {name}: the row with count 0 "
                                 f"is not zero with lse -1e30")
        sol[name] = sol_check(name, q, k, got, lse, ref, ref_lse)
        sol[name]["blocks"] = [bq, bkv]
    w4, w4a8, aq = {}, {}, {}
    for name, (m, k, n) in {"qkvo_5120x5120": (4096, 5120, 5120),
                            "fc1_ragged_m": (333, 5120, 13824),
                            "fc2_ragged_m": (77, 13824, 512),
                            "ragged_mnk": (77, 100, 51)}.items():
        x = randn((m, k), gen)
        wp, sc = Q.quantize_int4(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        pads = Q.w4_pad_launches
        w4[name] = mm_check("matmul_w4", name, Q.matmul_w4(x, wp, sc),
                            Q.matmul_w4_ref(x.float(), wp, sc))
        w4[name]["padded"] = Q.w4_pad_launches - pads
        x = a8_rows(x)
        aq[f"w4a8_{name}"] = act_quant_check(x)
        w4a8[name] = a8_check("matmul_w4a8", name, x, wp, sc)
    # M = 1; K < 2 KH with K and N padded; 40 packed rows padded to 64,
    # which moves x's high half
    for name, (m, k, n, block_k) in {"m1": (1, 5120, 5120, 512),
                                     "k_lt_2kh_pad": (129, 1000, 200, 512),
                                     "kh40_moved": (50, 70, 32, 20)}.items():
        x = a8_rows(randn((m, k), gen))
        wp, sc = Q.quantize_int4(torch.randn((k, n), generator=gen,
                                             device="cuda"), block_k)
        aq[f"w4a8_{name}"] = act_quant_check(x)
        w4a8[name] = a8_check("matmul_w4a8", name, x, wp, sc)
    w4["structured_exact"] = structured_check("w4", 600, 5120, 1536)
    for kernel, cases in (("matmul_w8", w8), ("matmul_w4", w4)):
        # only the (77, 100, 51) case has a K and an N the TMA maps refuse
        if {n for n, e in cases.items() if e.get("padded")} != {"ragged_mnk"}:
            raise AssertionError(f"{kernel}: padded launches {cases}")
    kvmask = {}
    # (B, L, S, N, D, valid keys, fully masked batch item)
    for name, (b, l, s, n, d, valid, dead) in {
            "ragged_random_d128": (2, 300, 333, 4, 128, None, None),
            "dead_item_d64": (3, 70, 130, 2, 64, None, 1),
            "refiner_1x64x20": (1, 64, 64, 20, 128, 64, None),
            "packed_txt64_img1024": (2, 1280, 1280, 4, 128,
                                     KREA2_TEXT + 1024, None)}.items():
        q, k, v = (randn(sh, gen) for sh in
                   ((b, l, n, d), (b, s, n, d), (b, s, n, d)))
        if valid is None:
            mask = torch.rand((b, s), generator=gen, device="cuda") < 0.6
        else:
            mask = torch.arange(s, device="cuda")[None].expand(b, s) < valid
        if dead is not None:
            mask[dead] = False
        got = A.flash_attention(q, k, v, _scale(q), mask)
        kvmask[name] = kvmask_check(name, q, k, v, mask, got, dead)
    w8a8 = {}
    # beside the W8 cases: M = 1, and K % 16 == 8 (padded)
    for name, (m, k, n) in {**w8_cases, "m1": (1, 1536, 1536),
                            "k_pad_1544": (64, 1544, 1552)}.items():
        x = a8_rows(randn((m, k), gen))
        wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                             device="cuda"))
        aq[f"w8a8_{name}"] = act_quant_check(x)
        w8a8[name] = a8_check("matmul_w8a8", name, x, wq, sc)
    for kernel, cases, want in (
            ("matmul_w8a8", w8a8, {"ragged_mnk", "k_pad_1544"}),
            ("matmul_w4a8", w4a8, {"ragged_mnk", "k_lt_2kh_pad",
                                   "kh40_moved"})):
        if {n for n, e in cases.items() if e["padded"]} != want:
            raise AssertionError(f"{kernel}: padded launches {cases}")
    # the 14B fc2 input, and K past what the one-pass CTA holds (two-pass)
    for m, k in ((151200, 13824), (3, 20000)):
        aq[f"{m}x{k}"] = act_quant_check(a8_rows(randn((m, k), gen)))
    gemv = gemv_checks(gen)
    f32 = f32_checks(gen)
    vae22 = vae22_check()
    hv1_vae = vae_hv1_check()
    emit("check", flash_attention=flash, flash_attention_kvmask=kvmask,
         matmul_w8=w8, matmul_w8a8=w8a8, sparse_flash=sparse, sol_flash=sol,
         matmul_w4=w4, matmul_w4a8=w4a8, act_quant=aq, vae22_decode=vae22,
         hv1_vae=hv1_vae,
         **gemv, **f32, tolerance=TOLERANCE)
    return {"flash_attention": flash, "flash_attention_kvmask": kvmask,
            "matmul_w8": w8, "matmul_w8a8": w8a8, "sparse_flash": sparse,
            "sol_flash": sol, "matmul_w4": w4, "matmul_w4a8": w4a8,
            "act_quant": aq, **gemv, **f32}


def _gemv_kernels():
    """(kernel, quantize, wrapper, plain version) of the two GEMVs."""
    from wan2gp_tpu_torch.ops import quant as Q
    return (("matmul_w8_gemv", Q.quantize_int8, Q.matmul_w8,
             Q.matmul_w8_ref),
            ("matmul_w4_gemv", Q.quantize_int4, Q.matmul_w4,
             Q.matmul_w4_ref))


def scaled_rows(x):
    """x with its rows scaled by 1e-20, 1 and 1e20 in turn."""
    scales = torch.tensor([1e-20, 1.0, 1e20], device=x.device)
    return x * scales[torch.arange(x.shape[0], device=x.device) % 3, None]


def f32_case(kernel, name, qfn, fn, ref_fn, m, k, n, gen, limit, counter,
             scaled=False):
    """One fp32 GEMV or tile-kernel case: one launch of the kernel (and of
    no other fp32 kernel), fp32 out, two launches bit-equal, the relative
    Frobenius error against the plain version in fp32 <= limit (scaled:
    x's rows at 1e-20, 1 and 1e20 in turn, each row held to the limit)."""
    from wan2gp_tpu_torch.ops import quant as Q
    x = torch.randn((m, k), generator=gen, device="cuda")
    if scaled:
        x = scaled_rows(x)
    wq, sc = qfn(torch.randn((k, n), generator=gen, device="cuda"))
    names = ("w8_gemv_launches", "w4_gemv_launches", "w8_f32_launches",
             "w4_f32_launches")
    before = {a: getattr(Q, a) for a in names}
    got = fn(x, wq, sc)
    want = {a: before[a] + (a == counter[1]) for a in names}
    if {a: getattr(Q, a) for a in names} != want \
            or got.dtype != torch.float32:
        raise AssertionError(f"{kernel} {name}: not one launch")
    if not torch.equal(got, fn(x, wq, sc)):
        raise AssertionError(f"{kernel} {name}: two launches differ")
    ref = ref_fn(x, wq, sc)
    if not scaled:
        return mm_check(kernel, name, got, ref, limit)
    diff = ref - got
    # rel_fro: the worst row's; max_abs: over the rows at scale 1
    e = {"rel_fro": (diff.norm(dim=1) / ref.norm(dim=1)).max().item(),
         "max_abs": diff[1::3].abs().max().item()}
    if not (e["rel_fro"] <= limit and torch.isfinite(got).all()):
        raise AssertionError(f"{kernel} {name}: {e}")
    return e


def gemv_checks(gen):
    """The fp32 W8 and W4 GEMVs against their plain versions in fp32: at
    (K)'s modulation shapes (M = 1, K = 3072, N = 18,432 and 9,216), at
    (L)'s (M = 2, K = 2048, N = 12,288), at M = 2 and 3 with N = 1,001 (not
    a multiple of the columns a thread loads) and, for W4, K = 1,000 < 2 KH,
    at M = 16 (the most the GEMV takes) and with x's rows at 1e-20, 1 and
    1e20 (each row held to the limit).  One launch a case, two launches
    bit-equal."""
    out = {}
    for kernel, qfn, fn, ref_fn in _gemv_kernels():
        counter = counters()[kernel]
        out[kernel] = {}
        for name, (m, k, n) in {"double_mod_1x3072x18432": (1, 3072, 18432),
                                "single_mod_1x3072x9216": (1, 3072, 9216),
                                "m2_3072x1001": (2, 3072, 1001),
                                # (L): HV1.5's modulation at CFG batch 2
                                "hv15_mod_2x2048x12288": (2, 2048, 12288),
                                # (P): Qwen-Image's modulation at CFG batch 2
                                "qwen_mod_2x3072x18432": (2, 3072, 18432),
                                "m3_1000x1001": (3, 1000, 1001),
                                "m16_2048x4096": (16, 2048, 4096),
                                "scaled_3x3072x9216": (3, 3072, 9216)
                                }.items():
            out[kernel][name] = f32_case(
                kernel, name, qfn, fn, ref_fn, m, k, n, gen, GEMV_REL_FRO,
                counter, scaled=name.startswith("scaled"))
    return out


def _f32_kernels():
    """(kernel, quantize, wrapper, plain version) of the two fp32 tile
    kernels (csrc/wo_f32_matmul.cu: fp32 x above GEMV_MAX_M rows)."""
    from wan2gp_tpu_torch.ops import quant as Q
    return (("matmul_w8_f32", Q.quantize_int8, Q.matmul_w8,
             Q.matmul_w8_ref),
            ("matmul_w4_f32", Q.quantize_int4, Q.matmul_w4,
             Q.matmul_w4_ref))


def f32_checks(gen):
    """The fp32 W8 and W4 tile kernels against their plain versions in
    fp32 (relative Frobenius error <= F32_REL_FRO), one launch each and
    none of the GEMV, two launches bit-equal: M = 17 (the first above the
    GEMV), 31 and 251 ((M)'s per-frame and per-audio-step adaLN rows), the
    token tiles' edges 32, 33, 64 and 65, and a ragged 1,001, at K 256 /
    2048 / 4096 and ragged N; W4 also with K < 2 KH and at K = 128 <= KH
    (patchify: the low half only); x's rows at 1e-20, 1 and 1e20 (each row
    held to the limit)."""
    cases = {"17x256x4096": (17, 256, 4096), "31x256x4096": (31, 256, 4096),
             "32x256x4096": (32, 256, 4096), "33x256x4096": (33, 256, 4096),
             "64x2048x4096": (64, 2048, 4096),
             "65x2048x4096": (65, 2048, 4096),
             "31x4096x36864": (31, 4096, 36864),
             "251x2048x18432": (251, 2048, 18432),
             "1001x2048x1000": (1001, 2048, 1000),
             "1001x4096x4100": (1001, 4096, 4100),
             "251x1000x1001": (251, 1000, 1001),
             "2000x128x4096": (2000, 128, 4096),
             "scaled_40x4096x4096": (40, 4096, 4096)}
    out = {}
    for kernel, qfn, fn, ref_fn in _f32_kernels():
        counter = counters()[kernel]
        out[kernel] = {}
        for name, (m, k, n) in cases.items():
            out[kernel][name] = f32_case(
                kernel, name, qfn, fn, ref_fn, m, k, n, gen, F32_REL_FRO,
                counter, scaled=name.startswith("scaled"))
    return out


def vae22_check():
    """The Wan2.2 VAE decode at full width (random weights, fp32, TF32
    off) on the card against the same decode of the same latents on the
    CPU: one small tile, 2 latent frames of 4 x 4 cells -> 5 frames of
    64 x 64."""
    from wan2gp_tpu_torch.models.wan import vae2_2
    cfg = vae2_2.Wan22VAEConfig()
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = vae2_2.init_wan22_vae(gen, cfg)
    z = torch.randn((1, 2, 4, 4, cfg.z_dim), generator=gen, device="cuda")
    got = vae2_2.wan22_vae_decode(params, cfg, z).cpu()
    t0 = time.perf_counter()
    ref = vae2_2.wan22_vae_decode(_tree_to(params, "cpu"), cfg, z.cpu())
    cpu_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    err = float((got - ref).abs().max())
    out = {"shape": list(got.shape), "max_abs": err,
           "mean_abs_ref": float(ref.abs().mean()),
           "clipped_share": float((ref.abs() == 1).float().mean()),
           "cpu_s": cpu_s}
    if got.shape != (1, 5, 64, 64, 3) or not err <= VAE22_MAX_ABS:
        raise AssertionError(f"vae22 decode, card against CPU: {out}")
    return out


def vae_hv1_check():
    """The HunyuanVideo 1 (884-16c) VAE at full width (random weights,
    fp32, TF32 off) on the card against the CPU: the decode of 2 x 4 x 4
    latents (5 frames of 32 x 32) and the encode of a 5-frame 32 x 32 clip,
    each within HV1_VAE_REL * max|ref|; and the tiled decode of a latent of
    one tile (3 x 8 x 8 cells) equal to the whole decode."""
    from wan2gp_tpu_torch.models.hyvideo import vae as hv
    cfg = hv.HunyuanVAEConfig()
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = hv.init_hunyuan_vae(gen, cfg)
    z = torch.randn((1, 16, 2, 4, 4), generator=gen, device="cuda")
    video = torch.rand((1, 3, 5, 32, 32), generator=gen,
                       device="cuda") * 2 - 1
    got = {"decode": hv.hunyuan_vae_decode(params, cfg, z).cpu(),
           "encode": hv.hunyuan_vae_encode(params, cfg, video).cpu()}
    t0 = time.perf_counter()
    pc = _tree_to(params, "cpu")
    ref = {"decode": hv.hunyuan_vae_decode(pc, cfg, z.cpu()),
           "encode": hv.hunyuan_vae_encode(pc, cfg, video.cpu())}
    cpu_s = time.perf_counter() - t0
    del pc
    out = {"cpu_s": cpu_s}
    for k in got:
        err = float((got[k] - ref[k]).abs().max())
        ref_max = float(ref[k].abs().max())
        out[k] = {"shape": list(got[k].shape), "max_abs": err,
                  "ref_max": ref_max}
        if not err <= HV1_VAE_REL * ref_max:
            raise AssertionError(f"HV1 VAE {k}, card against CPU: {out}")
    if out["decode"]["shape"] != [1, 3, 5, 32, 32] or \
            out["encode"]["shape"] != [1, 16, 2, 4, 4]:
        raise AssertionError(f"HV1 VAE shapes: {out}")
    one = torch.randn((1, 16, 3, 8, 8), generator=gen, device="cuda")
    tiled = hv.hunyuan_vae_decode_tiled(params, cfg, one)
    whole = hv.hunyuan_vae_decode(params, cfg, one)
    out["one_tile_equal"] = bool(torch.equal(tiled, whole))
    if not out["one_tile_equal"]:
        raise AssertionError("HV1 VAE: a one-tile tiled decode is not the "
                             "whole decode")
    del params
    torch.cuda.empty_cache()
    return out


def a8_rows(x):
    """x [M, K] bf16 with, where M > 2, row 1 all zeros (sx = 1e-8 *
    fp32(1/127)) and row 2 of absmax 127 (sx = 1.0) whose other values are
    -126.5 .. 126.5 in steps of 1, so that each x / sx is a .5 tie that
    rounds to even."""
    if x.shape[0] > 2:
        x[1] = 0
        ties = torch.arange(x.shape[1], device=x.device) % 254 - 126.5
        ties[0] = 127
        x[2] = ties.to(x.dtype)
    return x


def act_quant_check(x):
    """quantize_act_int8 (the kernel) against its plain version: x_q and the
    bits of sx must be equal."""
    from wan2gp_tpu_torch.ops import quant as Q
    xq, sx = Q.quantize_act_int8(x)
    rq, rsx = Q.quantize_act_int8_ref(x)
    e = {"shape": list(x.shape),
         "wrong_elements": int((xq != rq).sum().item()),
         "wrong_scales": int((sx.view(torch.int32)
                              != rsx.view(torch.int32)).sum().item())}
    del xq, sx, rq, rsx
    if e["wrong_elements"] or e["wrong_scales"]:
        raise AssertionError(f"act_quant {list(x.shape)}: {e}")
    return {**e, "max_abs": 0.0}


def a8_check(kernel, name, x, w, sc):
    """An A8 kernel against its plain versions: the relative Frobenius
    error against the fp32 plain version from x, and the count of output
    elements that differ from the plain product on the same int8
    activations (exact integer sums: it must be 0); `padded`: whether the
    launch padded its operands."""
    from wan2gp_tpu_torch.ops import quant as Q
    if kernel == "matmul_w8a8":
        fn, ref_fn, prod_ref = Q.matmul_w8a8, Q.matmul_w8a8_ref, \
            Q.w8a8_product_ref
        pad = "w8a8_pad_launches"
    else:
        fn, ref_fn, prod_ref = Q.matmul_w4a8, Q.matmul_w4a8_ref, \
            Q.w4a8_product_ref
        pad = "w4a8_pad_launches"
    pads = getattr(Q, pad)
    got = fn(x, w, sc)
    padded = getattr(Q, pad) - pads
    e = mm_check(kernel, name, got, ref_fn(x.float(), w, sc))
    exact = prod_ref(*Q.quantize_act_int8_ref(x), w, sc, got.dtype)
    e["wrong_elements"] = int((got != exact).sum().item())
    e["shape"], e["padded"] = [x.shape[0], x.shape[1], sc.shape[0]], padded
    del got, exact
    if e["wrong_elements"]:
        raise AssertionError(f"{kernel} {name}: {e}")
    return e


def _scale(q):
    return 1.0 / math.sqrt(q.shape[-1])


def audio_qkv(frames, tokens, gen, n=40, d=128, s=32):
    """q [frames, tokens, n, d] and the k, v halves of one [frames, s,
    2 n d] tensor viewed as [frames, s, n, d] (strided, as Multitalk's
    audio cross-attention hands them to the kernel)."""
    q = randn((frames, tokens, n, d), gen)
    kv = randn((frames, s, 2 * n * d), gen)
    k, v = (t.reshape(frames, s, n, d) for t in kv.chunk(2, dim=-1))
    return q, k, v


def flash_check(name, q, k, v, got):
    """The kernel's output `got` against the plain version in fp32 from the
    same bf16 inputs; raises past the limits."""
    from wan2gp_tpu_torch.ops import attention as A
    ref = A.flash_attention_ref(q.float(), k.float(), v.float(), _scale(q))
    return attn_check("flash_attention", name, q, k, got, ref)


def attn_check(kernel, name, q, k, got, ref):
    """An attention kernel's output against its fp32 plain version `ref`
    (consumed); raises past the limits."""
    err = (got.float() - ref).abs_()
    ref = ref.abs_()
    e = {"shape": list(q.shape[:3]) + [k.shape[1], q.shape[3]],
         "max_abs": err.max().item(), "mean_abs": err.mean().item(),
         "max_ref": ref.max().item(), "mean_ref": ref.mean().item()}
    del err
    if not (e["mean_abs"] <= FLASH_MEAN_REL * e["mean_ref"]
            and e["max_abs"] <= FLASH_MAX_REL * e["max_ref"]):
        raise AssertionError(f"{kernel} {name}: {e}")
    return e


def kvmask_check(name, q, k, v, mask, got, dead=None):
    """The masked kernel's output against its plain version in fp32;
    batch item `dead` (all keys masked) must be exact zeros."""
    from wan2gp_tpu_torch.ops import attention as A
    ref = A.flash_attention_ref(q.float(), k.float(), v.float(), _scale(q),
                                mask)
    if dead is not None and got[dead].any():
        raise AssertionError(f"flash_attention_kvmask {name}: fully masked "
                             f"item {dead} is not zero")
    e = attn_check("flash_attention_kvmask", name, q, k, got, ref)
    e["valid_keys"] = int((mask > 0).sum().item())
    return e


def sol_check(name, q, k, got, lse, ref, ref_lse):
    e = attn_check("sol_flash", name, q, k, got, ref)
    e["lse_max_abs"] = (lse - ref_lse).abs_().max().item()
    if not e["lse_max_abs"] <= LSE_MAX_ABS:
        raise AssertionError(f"sol_flash {name} lse: {e}")
    return e


def mm_check(kernel, name, got, ref, limit=MM_REL_FRO):
    """A matmul kernel's output against its fp32 plain version; raises past
    the limit."""
    diff = ref.float()
    ref_norm = diff.norm().item()
    diff.sub_(got.float())
    e = {"rel_fro": diff.norm().item() / ref_norm,
         "max_abs": diff.abs_().max().item()}
    if not e["rel_fro"] <= limit:
        raise AssertionError(f"{kernel} {name}: {e}")
    return e


def structured_check(kernel, m, k, n):
    """W8 or W4 on a weight whose value at (k, n) is a fixed pattern, with
    x one-hot in its first m/2 rows (row i picks weight row 7i mod K) and
    small integers after: every sum is exact in fp32, so the kernel must
    return the plain version's bits, and a misplaced weight element (a
    wrong swizzle, nibble or k order) shows as a wrong output element."""
    from wan2gp_tpu_torch.ops import quant as Q
    kk = torch.arange(k, device="cuda")[:, None]
    nn = torch.arange(n, device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(8)
    xi = torch.randint(-3, 4, (m, k), generator=gen, device="cuda")
    hot = min(m // 2, k)
    xi[:hot] = 0
    rows = torch.arange(hot, device="cuda")
    xi[rows, (7 * rows) % k] = 1
    x = xi.to(torch.bfloat16)
    scale = 1.0 + torch.rand(n, generator=gen, device="cuda")
    if kernel == "w8":
        wq = ((kk * 31 + nn * 17) % 255 - 127).to(torch.int8)
        got = Q.matmul_w8(x, wq, scale)
        ref = Q.matmul_w8_ref(x.float(), wq, scale)
    else:
        wi = (kk * 5 + nn * 3) % 15 - 7
        kh = k // 2
        wq = ((wi[:kh] & 0xF) | ((wi[kh:] & 0xF) << 4)).to(
            torch.uint8).view(torch.int8)
        got = Q.matmul_w4(x, wq, scale)
        ref = Q.matmul_w4_ref(x.float(), wq, scale)
    wrong = int((got != ref.to(torch.bfloat16)).sum().item())
    if wrong:
        raise AssertionError(f"matmul_{kernel} structured {m}x{k}x{n}: "
                             f"{wrong} elements differ from the plain "
                             f"version")
    return {"shape": [m, k, n], "wrong_elements": wrong, "rel_fro": 0.0,
            "max_abs": 0.0}


def phase_dit():
    """Small DiT forwards: card (kernels) against CPU (plain versions)."""
    import dataclasses
    from wan2gp_tpu_torch.models.wan import dit
    from wan2gp_tpu_torch.ops.rope import build_rope_3d
    from wan2gp_tpu_torch.runtime.service import (quantize_dit_params,
                                                  activation_mode)
    cfg = dit.WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                           text_len=16)
    rng = np.random.default_rng(0)
    t = torch.tensor([900.0, 250.0])
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 4096),
                                               dtype=np.float32))
    out = {}
    # (mode, attention backend, latent grid): 1,024 tokens for the sparse
    # backends (Sol engages from 1,024; radial needs frames x tokens)
    for mode, backend, grid in (("bf16", "auto", (3, 4, 4)),
                                ("int8", "auto", (3, 4, 4)),
                                ("int8a8", "auto", (3, 4, 4)),
                                ("int4", "radial:4:256", (4, 16, 16)),
                                ("int4a8", "sol", (4, 16, 16))):
        lat = torch.from_numpy(rng.standard_normal(
            (2, 16, grid[0], 2 * grid[1], 2 * grid[2]), dtype=np.float32))
        p = dit.init_wan_dit(torch.Generator().manual_seed(0), cfg)
        if mode != "bf16":
            p = quantize_dit_params(p, mode)
        mcfg = dataclasses.replace(cfg, act_quant=activation_mode(mode))
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(p, dev)
            cos, sin = build_rope_3d(grid, head_dim=cfg.head_dim, device=dev)
            res[dev] = dit.wan_dit_forward(
                pd, mcfg, lat.to(dev), t.to(dev), ctx.to(dev), cos,
                sin, attn_backend=backend).float().cpu()
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"attention": backend, "tokens": int(np.prod(grid)),
                     "max_abs": err, "ref_max": ref_max,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max):
            raise AssertionError(f"small DiT forward ({mode}): {out[mode]}")
    out["i2v"] = dit_i2v()
    out["vace_audio"] = dit_vace_audio()
    out["krea2"] = dit_krea2()
    out["flux"] = dit_flux()
    out["flux_rest"] = dit_flux_rest()
    out["hv15"] = dit_hv15()
    out["hv1"] = dit_hv1()
    out["ltx2"], int4_launches = dit_ltx2()
    emit("dit", tolerance="max_abs<=3e-2*max|ref|", **out)
    return {"ltx2_int4": int4_launches}


def dit_i2v():
    """A small Wan i2v forward (in_dim 36 with y, 257 CLIP tokens through
    img_emb and the image cross-attention), card against CPU; the card's
    forward launches the flash kernel 3 times a layer."""
    from wan2gp_tpu_torch.models.wan import dit
    from wan2gp_tpu_torch.ops import attention as A
    from wan2gp_tpu_torch.ops.rope import build_rope_3d
    cfg = dit.WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                           text_len=16, in_dim=36, model_type="i2v")
    rng = np.random.default_rng(2)
    grid = (3, 4, 4)
    lat, y = (torch.from_numpy(rng.standard_normal(
        (2, c, grid[0], 2 * grid[1], 2 * grid[2]), dtype=np.float32))
        for c in (16, 20))
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 4096),
                                               dtype=np.float32))
    clip_fea = torch.from_numpy(rng.standard_normal((2, 257, 1280),
                                                    dtype=np.float32))
    t = torch.tensor([900.0, 250.0])
    p = dit.init_wan_dit(torch.Generator().manual_seed(3), cfg)
    res = {}
    for dev in ("cpu", "cuda"):
        pd = _tree_to(p, dev)
        cos, sin = build_rope_3d(grid, head_dim=cfg.head_dim, device=dev)
        before = A.launches
        res[dev] = dit.wan_dit_forward(
            pd, cfg, lat.to(dev), t.to(dev), ctx.to(dev), cos, sin,
            clip_fea=clip_fea.to(dev), y=y.to(dev)).float().cpu()
        launched = A.launches - before
    ref_max = res["cpu"].abs().max().item()
    err = (res["cuda"] - res["cpu"]).abs().max().item()
    out = {"config": "dim 256, 2 heads of 128, 2 layers, in_dim 36, "
                     "257 CLIP tokens", "tokens": int(np.prod(grid)),
           "max_abs": err, "ref_max": ref_max, "flash_launches": launched,
           "finite": bool(torch.isfinite(res["cuda"]).all())}
    if not (out["finite"] and err <= 3e-2 * ref_max
            and launched == 3 * cfg.num_layers):
        raise AssertionError(f"small i2v DiT forward: {out}, want "
                             f"{3 * cfg.num_layers} flash launches")
    return out


def dit_vace_audio():
    """A small vace_multitalk forward (2 layers, so 1 VACE block; audio
    cross-attention over 32 tokens of 768 a latent frame) in bf16 and
    int8, card against CPU.  The card's forward launches the flash kernel
    3 times a main layer (self, text, audio) and twice a VACE block, and
    (int8) W8 10 times a main layer, 3 times a layer for the audio (q, kv,
    o) and 11 times a VACE block (with after_proj)."""
    from wan2gp_tpu_torch.models.wan import dit
    from wan2gp_tpu_torch.models.wan.multitalk import \
        init_multitalk_audio_attn
    from wan2gp_tpu_torch.ops import attention as A, quant as Q
    from wan2gp_tpu_torch.ops.rope import build_rope_3d
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params
    cfg = dit.WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                           text_len=16, vace=True)
    rng = np.random.default_rng(4)
    grid = (3, 4, 4)
    lat = torch.from_numpy(rng.standard_normal(
        (2, 16, grid[0], 2 * grid[1], 2 * grid[2]), dtype=np.float32))
    vctx = torch.from_numpy(rng.standard_normal(
        (1, 96, grid[0], 2 * grid[1], 2 * grid[2]), dtype=np.float32))
    audio = torch.from_numpy(rng.standard_normal((2, grid[0], 32, 768),
                                                 dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 4096),
                                               dtype=np.float32))
    t = torch.tensor([900.0, 250.0])
    want = {"flash_attention": 3 * 2 + 2,
            "matmul_w8": 10 * 2 + 3 * 2 + 11}
    out = {"config": "dim 256, 2 heads of 128, 2 layers (1 VACE block), "
                     "audio 3 frames x 32 tokens of 768",
           "tokens": int(np.prod(grid))}
    for mode in ("bf16", "int8"):
        p = dit.init_wan_dit(torch.Generator().manual_seed(5), cfg)
        p["audio_attn_blocks"] = init_multitalk_audio_attn(
            torch.Generator().manual_seed(6), cfg, cfg.num_layers)
        if mode == "int8":
            p = quantize_dit_params(p, "int8")
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(p, dev)
            cos, sin = build_rope_3d(grid, head_dim=cfg.head_dim, device=dev)
            before = A.launches, Q.launches
            res[dev] = dit.wan_dit_forward(
                pd, cfg, lat.to(dev), t.to(dev), ctx.to(dev), cos, sin,
                vace_context=vctx.to(dev), vace_scale=0.8,
                audio_tokens=audio.to(dev)).float().cpu()
            launched = {"flash_attention": A.launches - before[0],
                        "matmul_w8": Q.launches - before[1]}
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"max_abs": err, "ref_max": ref_max,
                     "launches": launched,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        ok_launches = (launched == want if mode == "int8" else
                       launched["flash_attention"] == want["flash_attention"]
                       and launched["matmul_w8"] == 0)
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max
                and ok_launches):
            raise AssertionError(f"small VACE + audio DiT forward ({mode}): "
                                 f"{out[mode]}, want {want}")
    return out


def dit_krea2():
    """A small Krea 2 (head_dim 128, as the full model) fused context and
    forward, card against CPU, with text masks that pad each prompt."""
    from wan2gp_tpu_torch.models.krea2 import dit as kd
    from wan2gp_tpu_torch.ops import attention as A
    cfg = kd.Krea2Config(features=512, heads=4, kvheads=2, txtdim=256,
                         txtheads=2, txtkvheads=2, multiplier=2, layers=2,
                         txtlayers=3)
    rng = np.random.default_rng(1)
    h_tok = w_tok = 16
    l_txt = 20
    img = torch.from_numpy(rng.standard_normal(
        (2, h_tok * w_tok, cfg.channels * cfg.patch ** 2), dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal(
        (2, l_txt, cfg.txtlayers, cfg.txtdim), dtype=np.float32))
    mask = (torch.arange(l_txt)[None] < torch.tensor([[13], [20]])).int()
    t = torch.tensor([0.8, 0.3])
    pad_to = 512                      # 20 + 256 tokens, to a multiple of 256
    p = kd.init_krea2(torch.Generator().manual_seed(0), cfg)
    res = {}
    for dev in ("cpu", "cuda"):
        pd = _tree_to(p, dev)
        cos, sin = kd.build_krea2_rope(l_txt, h_tok, w_tok, cfg, pad_to,
                                       device=dev)
        before = A.kvmask_launches
        fused = kd.prepare_context(pd, cfg, ctx.to(dev), mask.to(dev))
        res[dev] = kd.krea2_forward(pd, cfg, img.to(dev), fused, t.to(dev),
                                    cos, sin, mask.to(dev)).float().cpu()
        launched = A.kvmask_launches - before
    ref_max = res["cpu"].abs().max().item()
    err = (res["cuda"] - res["cpu"]).abs().max().item()
    out = {"config": "features 512, 4/2 heads of 128, txtdim 256, 2 layers",
           "tokens": pad_to, "max_abs": err, "ref_max": ref_max,
           "kvmask_launches": launched,
           "finite": bool(torch.isfinite(res["cuda"]).all())}
    want = cfg.layers + cfg.n_fusion_blocks
    if not (out["finite"] and err <= 3e-2 * ref_max and launched == want):
        raise AssertionError(f"small Krea 2 forward: {out}, want {want} "
                             f"masked launches")
    return out


def dit_flux():
    """A Flux forward at full width (hidden 3072, 24 heads of 128, MLP
    12,288, T5 and CLIP widths) with 2 double and 2 single blocks, card
    against CPU, in bf16 and with int8 and int4 block weights: 4 joint
    attentions, and when quantized 20 W8 / W4 launches and 6 fp32
    modulation GEMVs (batch 1)."""
    from wan2gp_tpu_torch.models.flux import dit as fd
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params
    cfg = fd.FluxConfig(depth=2, depth_single_blocks=2)
    l_txt, h_tok, w_tok = FLUX_CHECK_TOKENS
    rng = np.random.default_rng(2)
    img, txt, vec_y = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)) for shape in (
        (1, h_tok * w_tok, cfg.in_channels), (1, l_txt, cfg.context_in_dim),
        (1, cfg.vec_in_dim)))
    t = torch.tensor([0.7])
    ids = np.concatenate([np.zeros((l_txt, 3)),
                          fd.make_img_ids(h_tok, w_tok)], axis=0)
    # drawn and quantized on the card (on the CPU the draw alone takes
    # 15 s), copied to the CPU for the plain run
    p = fd.init_flux(torch.Generator(device="cuda").manual_seed(3), cfg)
    out = {}
    for mode, want in (("bf16", {"flash_attention": 4}),
                       ("int8", {"flash_attention": 4, "matmul_w8": 20,
                                 "matmul_w8_gemv": 6}),
                       ("int4", {"flash_attention": 4, "matmul_w4": 20,
                                 "matmul_w4_gemv": 6})):
        # quantize_dit_params takes each float weight out of its node: it
        # gets new nodes over the same tensors
        pm = p if mode == "bf16" else quantize_dit_params(_nodes(p), mode)
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(pm, "cpu") if dev == "cpu" else pm
            cos, sin = fd.rope_from_ids(ids, cfg.axes_dim, cfg.theta,
                                        device=dev)
            before = read_counts()
            res[dev] = fd.flux_forward(pd, cfg, img.to(dev), txt.to(dev),
                                       vec_y.to(dev), t.to(dev), cos,
                                       sin).float().cpu()
            launched = {k: v - before[k] for k, v in read_counts().items()
                        if v != before[k]}
            del pd
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"tokens": l_txt + h_tok * w_tok, "max_abs": err,
                     "ref_max": ref_max, "launches": launched,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max
                and launched == want):
            raise AssertionError(f"small Flux forward ({mode}): "
                                 f"{out[mode]}, want launches {want}")
        del pm
    del p
    torch.cuda.empty_cache()
    return {"config": "hidden 3072, 24 heads of 128, mlp 12288, 2 double + "
                      "2 single blocks, batch 1", **out}


def dit_flux_rest():
    """The other Flux forwards at full width with 2 double and 2 single
    blocks in bf16, card against CPU (4 flash launches each): FLUX.2 Klein
    9B (4096 wide, 32 heads, SwiGLU, one shared modulation, four-axis RoPE
    at theta 2000) and the same with pi-FLUX.2's mixture heads in place of
    the final projection; Chroma (its 5-layer 5,120-wide fp32 modulation
    MLP over 344 rows); Chroma-Radiance (16x16 pixel patches of 768
    features, the generated GLU head and the 3x3 conv, made non-zero);
    FLUX.1 dev with Kontext's 64 conditioning tokens after the noise tokens
    (time index 1) and with USO's 24 style tokens before the text."""
    from wan2gp_tpu_torch.models.flux import dit as fd
    from wan2gp_tpu_torch.models.flux import piflow as fp
    l_txt, h_tok, w_tok = FLUX_CHECK_TOKENS
    n_img = h_tok * w_tok
    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda")
    t, g = torch.tensor([0.7]), torch.tensor([3.5])

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    def flat(r):
        if isinstance(r, dict):
            return torch.cat([v.float().flatten() for v in r.values()])
        return r.float().flatten()

    def run(name, cfg, p, pc, img, txt, ids, **kw):
        """p: the tree on the card; pc: its CPU copy."""
        res, secs = {}, {}
        for dev in ("cpu", "cuda"):
            t0 = time.perf_counter()
            pd = pc if dev == "cpu" else p
            cos, sin = fd.rope_from_ids(ids, cfg.axes_dim, cfg.theta,
                                        device=dev)
            extra = {k: _tree_to(v, dev) if isinstance(v, dict)
                     else v.to(dev) if torch.is_tensor(v) else v
                     for k, v in kw.items()}
            vec_y = extra.pop("vec_y", torch.zeros((1, 1), device=dev))
            before = read_counts()
            r = fd.flux_forward(pd, cfg, img.to(dev), txt.to(dev), vec_y,
                                t.to(dev), cos, sin, **extra)
            launched = {k: v - before[k] for k, v in read_counts().items()
                        if v != before[k]}
            res[dev] = flat(r).cpu()
            secs[f"{dev}_s"] = time.perf_counter() - t0
            del pd
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        rec = {"tokens": txt.shape[1] + img.shape[1], "max_abs": err,
               "ref_max": ref_max, "launches": launched, **secs,
               "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (rec["finite"] and err <= 3e-2 * ref_max
                and launched == {"flash_attention": 4}):
            raise AssertionError(f"small Flux forward ({name}): {rec}")
        return rec

    out = {}
    two = dict(depth=2, depth_single_blocks=2)
    cfg = fd.FluxConfig(**{**fd.FLUX2_KLEIN_9B, **two})
    p = fd.init_flux(gen.manual_seed(31), cfg)
    ids = fd.make_ids_flux2(h_tok, w_tok, l_txt)
    img, txt = rnd(1, n_img, cfg.in_channels), rnd(1, l_txt,
                                                   cfg.context_in_dim)
    pc = _tree_to(p, "cpu")
    out["flux2_klein_9b"] = run("Klein 9B", cfg, p, pc, img, txt, ids)
    heads = fp.init_piflow_heads(gen.manual_seed(32), cfg,
                                 means_dim=8 * cfg.out_channels)
    out["piflow_heads"] = run("pi-Flow heads", cfg, p, pc, img, txt, ids,
                              piflow_heads=heads)
    del p, pc, heads
    cfg = fd.FluxConfig(**{**fd.CHROMA, **two})
    p = fd.init_flux(gen.manual_seed(33), cfg)
    ids = np.concatenate([np.zeros((l_txt, 3)), fd.make_img_ids(h_tok,
                                                                 w_tok)])
    txt = rnd(1, l_txt, cfg.context_in_dim)
    out["chroma"] = run("Chroma", cfg, p, _tree_to(p, "cpu"),
                        rnd(1, n_img, cfg.in_channels), txt, ids)
    del p
    cfg = fd.FluxConfig(**{**fd.CHROMA_RADIANCE, **two})
    p = fd.init_flux(gen.manual_seed(34), cfg)
    rad = p["radiance"]
    for leaf, sd in ((rad["img_in_patch"], 0.02), (rad["final_conv"], 0.1)):
        leaf["w"] = sd * torch.randn(leaf["w"].shape, generator=gen,
                                     device="cuda")
    out["chroma_radiance"] = run("Radiance", cfg, p, _tree_to(p, "cpu"),
                                 rnd(1, n_img, cfg.in_channels), txt, ids,
                                 radiance_grid_hw=(h_tok, w_tok))
    del p, rad
    cfg = fd.FluxConfig(guidance_embed=True, **two)
    p = fd.init_flux(gen.manual_seed(35), cfg)
    txt, vec_y = rnd(1, l_txt, cfg.context_in_dim), rnd(1, cfg.vec_in_dim)
    kontext_ids = np.concatenate([ids, fd.make_img_ids(h_tok, w_tok, 1)])
    pc = _tree_to(p, "cpu")
    out["kontext"] = run("Kontext", cfg, p, pc, rnd(1, 2 * n_img, 64), txt,
                         kontext_ids, guidance=g, vec_y=vec_y)
    style = rnd(1, 24, cfg.hidden_size)
    uso_ids = np.concatenate([np.zeros((24, 3)), ids])
    out["uso"] = run("USO", cfg, p, pc, rnd(1, n_img, 64), txt, uso_ids,
                     guidance=g, vec_y=vec_y, style_tokens=style)
    del p, pc
    torch.cuda.empty_cache()
    return {"config": "full widths (Klein 9B 4096 / 32 heads, Chroma and "
                      "FLUX.1 dev 3072 / 24 heads), 2 double + 2 single "
                      "blocks, bf16, batch 1", **out}


def dit_hv15():
    """A HunyuanVideo 1.5 forward at full width (hidden 2048, 16 heads of
    128, MLP 8192, the LM's 4096 and byT5's 1472 inputs) with 2 double
    blocks, card against CPU, in bf16 and with int8 block weights, at batch
    2 with the second item's text and byT5 masks all zero (the refiner's
    fully masked rows, as CFG's null side has them): 2 joint attentions,
    and when quantized 24 W8 launches (8 a block, 8 for the refiner's 2
    blocks) and 6 fp32 GEMVs (each block's 2 modulations, the refiner's 2
    adaLN)."""
    from wan2gp_tpu_torch.families.hyvideo import HunyuanFamilyHandler
    from wan2gp_tpu_torch.models.hyvideo import dit as hd
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params
    cfg = dataclasses.replace(
        HunyuanFamilyHandler.dit_config("hunyuan_1_5_t2v"),
        mm_double_blocks_depth=2)
    rng = np.random.default_rng(4)
    lat, states, byt5 = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)) for shape in (
        (2, cfg.in_channels, 2, 8, 8), (2, 16, cfg.text_states_dim),
        (2, 8, cfg.byt5_in_dim)))
    mask = torch.tensor([[1] * 10 + [0] * 6, [0] * 16], dtype=torch.int32)
    bmask = torch.tensor([[1] * 5 + [0] * 3, [0] * 8], dtype=torch.int32)
    t = torch.tensor([900.0, 900.0])
    p = hd.init_hunyuan(torch.Generator(device="cuda").manual_seed(5), cfg)
    out = {}
    for mode, want in (("bf16", {"flash_attention": 2}),
                       ("int8", {"flash_attention": 2, "matmul_w8": 24,
                                 "matmul_w8_gemv": 6})):
        pm = p if mode == "bf16" else quantize_dit_params(_nodes(p), mode)
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(pm, "cpu") if dev == "cpu" else pm
            before = read_counts()
            res[dev] = hd.hunyuan_forward(
                pd, cfg, lat.to(dev), t.to(dev), states.to(dev),
                mask.to(dev), byt5_states=byt5.to(dev),
                byt5_mask=bmask.to(dev)).float().cpu()
            launched = {k: v - before[k] for k, v in read_counts().items()
                        if v != before[k]}
            del pd
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"tokens": 32 + 16 + 8, "max_abs": err,
                     "ref_max": ref_max, "launches": launched,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max
                and launched == want):
            raise AssertionError(f"small HV1.5 forward ({mode}): "
                                 f"{out[mode]}, want launches {want}")
        del pm
    del p
    torch.cuda.empty_cache()
    return {"config": "hidden 2048, 16 heads of 128, mlp 8192, 2 double "
                      "blocks, batch 2 (a fully masked text item)", **out}


def dit_hv1():
    """A HunyuanVideo 1 forward at full width (hidden 3072, 24 heads of
    128, MLP 12,288, the LM's 4096 and CLIP's 768 inputs, embedded
    guidance) with 2 double and 2 single blocks, card against CPU, in bf16
    and with int8 block weights, at batch 1 with a partly masked text:
    4 joint attentions, and when quantized 28 W8 launches (8 a double
    block, 2 a single block, 8 for the refiner's 2 blocks) and 8 fp32
    GEMVs (2 modulations a double block, 1 a single block, the refiner's 2
    adaLN)."""
    from wan2gp_tpu_torch.families.hyvideo import HunyuanFamilyHandler
    from wan2gp_tpu_torch.models.hyvideo import dit as hd
    from wan2gp_tpu_torch.runtime.service import quantize_dit_params
    cfg = dataclasses.replace(HunyuanFamilyHandler.dit_config("hunyuan"),
                              mm_double_blocks_depth=2,
                              mm_single_blocks_depth=2)
    rng = np.random.default_rng(6)
    lat, states, pooled = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)) for shape in (
        (1, cfg.in_channels, 2, 8, 8), (1, 16, cfg.text_states_dim),
        (1, cfg.text_states_dim_2)))
    mask = torch.tensor([[1] * 11 + [0] * 5], dtype=torch.int32)
    t, g = torch.tensor([900.0]), torch.tensor([6000.0])
    p = hd.init_hunyuan(torch.Generator(device="cuda").manual_seed(7), cfg)
    out = {}
    for mode, want in (("bf16", {"flash_attention": 4}),
                       ("int8", {"flash_attention": 4, "matmul_w8": 28,
                                 "matmul_w8_gemv": 8})):
        pm = p if mode == "bf16" else quantize_dit_params(_nodes(p), mode)
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(pm, "cpu") if dev == "cpu" else pm
            before = read_counts()
            res[dev] = hd.hunyuan_forward(
                pd, cfg, lat.to(dev), t.to(dev), states.to(dev),
                mask.to(dev), text_pooled=pooled.to(dev),
                guidance=g.to(dev)).float().cpu()
            launched = {k: v - before[k] for k, v in read_counts().items()
                        if v != before[k]}
            del pd
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"tokens": 32 + 16, "max_abs": err, "ref_max": ref_max,
                     "launches": launched,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max
                and launched == want):
            raise AssertionError(f"small HV1 forward ({mode}): "
                                 f"{out[mode]}, want launches {want}")
        del pm
    del p
    torch.cuda.empty_cache()
    return {"config": "hidden 3072, 24 heads of 128, mlp 12288, 2 double + "
                      "2 single blocks, batch 1, embedded guidance", **out}


# (M)'s small forward: grid and audio tokens of phase 3 (17 frames, so that
# the per-frame adaLN products run at M = 17 > GEMV_MAX_M)
M_CHECK_GRID, M_CHECK_AUDIO = (17, 2, 2), 20


def dit_ltx2():
    """An LTX-2 22B forward at full width (video 32 x 128, audio 32 x 64,
    caption 3840, gated attention, prompt adaLN) with 2 blocks, audio on,
    card against CPU: in bf16 (12 flash); int8 from a quanto state dict
    with every linear quantized, read back by `load_ltx2_params` (72 W8,
    22 fp32 W8 above 16 rows: patchify, proj_out and the adaLN tables at
    M = 17 / 20, 6 fp32 GEMVs: the prompt adaLN at M = 1); int4 with every
    linear quantized (the same counts on the W4 kernels); and a CFG batch 2
    in bf16 over contexts of 7 and 4 rows padded to 7 with a key mask (8
    flash, 4 kv-masked text crosses).  Returns the results and the int4
    forward's launches."""
    from wan2gp_tpu_torch.families.ltx2 import LTX2FamilyHandler
    from wan2gp_tpu_torch.io.ltx2_checkpoint import (load_ltx2_params,
                                                     ltx2_state_dict)
    from wan2gp_tpu_torch.models.ltx2 import dit as ld
    from wan2gp_tpu_torch.models.ltx2 import pipeline as lp
    from wan2gp_tpu_torch.ops.quant import quantize_params_tree
    cfg = dataclasses.replace(LTX2FamilyHandler.dit_config("ltx2_22B"),
                              num_layers=2)
    rng = np.random.default_rng(6)
    f, h, w = M_CHECK_GRID
    tv = f * h * w
    vt, at = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
              for s in ((2, tv, cfg.in_channels),
                        (2, M_CHECK_AUDIO, cfg.audio_in_channels)))
    ctx = torch.from_numpy(rng.standard_normal((2, 7, cfg.caption_dim),
                                               dtype=np.float32))
    mask2 = torch.tensor([[1] * 7, [1] * 4 + [0] * 3], dtype=torch.int32)
    ctx[1, 4:] = 0.0
    t_v = torch.linspace(0.2, 0.9, f)[None].repeat(2, 1)
    t_a = torch.full((2, M_CHECK_AUDIO), 0.6)
    p = ld.init_ltx2_dit(torch.Generator(device="cuda").manual_seed(7), cfg)
    blocks = 34 * cfg.num_layers + 4
    quant = {"bf16": p,
             "int8": load_ltx2_params(ltx2_state_dict(p, cfg, quanto=True),
                                      cfg, device="cuda")[0],
             "int4": quantize_params_tree(_nodes(p), bits=4, min_dim=1)}
    wants = {"bf16": {"flash_attention": 12},
             "int8": {"flash_attention": 12, "matmul_w8": blocks,
                      "matmul_w8_f32": 22, "matmul_w8_gemv": 6},
             "int4": {"flash_attention": 12, "matmul_w4": blocks,
                      "matmul_w4_f32": 22, "matmul_w4_gemv": 6},
             "cfg_masked": {"flash_attention": 8,
                            "flash_attention_kvmask": 4}}
    out, int4_launches = {}, None
    for mode, want in wants.items():
        pm = quant["bf16" if mode == "cfg_masked" else mode]
        b = 2 if mode == "cfg_masked" else 1
        res = {}
        for dev in ("cpu", "cuda"):
            pd = _tree_to(pm, "cpu") if dev == "cpu" else pm
            ropes = lp.build_ltx2_ropes(cfg, M_CHECK_GRID, M_CHECK_AUDIO,
                                        device=dev)
            before = read_counts()
            v, a = ld.ltx2_dit_forward(
                pd, cfg, vt[:b].to(dev), t_v[:b].to(dev), ctx[:b].to(dev),
                ropes[0], ropes[2], audio_tokens=at[:b].to(dev),
                t_audio=t_a[:b].to(dev), audio_rope=ropes[1],
                audio_cross_rope=ropes[3],
                context_mask=mask2.to(dev) if b == 2 else None)
            res[dev] = torch.cat([v.flatten(), a.flatten()]).float().cpu()
            launched = {k: n - before[k] for k, n in read_counts().items()
                        if n != before[k]}
            del pd
        ref_max = res["cpu"].abs().max().item()
        err = (res["cuda"] - res["cpu"]).abs().max().item()
        out[mode] = {"video_tokens": b * tv, "audio_tokens": b * M_CHECK_AUDIO,
                     "max_abs": err, "ref_max": ref_max, "launches": launched,
                     "finite": bool(torch.isfinite(res["cuda"]).all())}
        if not (out[mode]["finite"] and err <= 3e-2 * ref_max
                and launched == want):
            raise AssertionError(f"small LTX-2 forward ({mode}): "
                                 f"{out[mode]}, want launches {want}")
        if mode == "int4":
            int4_launches = launched
    del p, quant
    torch.cuda.empty_cache()
    return {"config": "22B: video 32 x 128, audio 32 x 64, caption 3840, "
                      "gated, prompt adaLN, 2 blocks, 68 video + 20 audio "
                      "tokens; CFG batch 2 with contexts of 7 and 4 rows",
            **out}, int4_launches


def _nodes(tree):
    """tree's dicts and lists anew, its tensors shared."""
    if isinstance(tree, dict):
        return {k: _nodes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nodes(v) for v in tree]
    return tree


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def time_flash(name, b, l, s, n, d):
    from wan2gp_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (randn(sh, gen) for sh in
               ((b, l, n, d), (b, s, n, d), (b, s, n, d)))
    scale = _scale(q)
    big = b * n * l * s > 1e10
    err = flash_check(name, q, k, v, A.flash_attention(q, k, v, scale))
    ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale), 3 if big else 20,
                 warmup=0)
    plain_ms = cuda_ms(lambda: A.flash_attention_ref(q, k, v, scale), 1,
                       warmup=0 if big else 1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = library_sdpa(sdpa_ms(qt, kt, vt, 3 if big else 20, scale=scale),
                           "")
    del qt, kt, vt
    flops = 4.0 * b * n * l * s * d
    bound_ms, by = bound(flops, 2.0 * (2 * b * l * n * d + 2 * b * s * n * d))
    return {"shape": [b, l, s, n, d], "ms": ms, "plain_ms": plain_ms,
            **library, "bound_ms": bound_ms, "bound_by": by,
            **rates(flops, ms, bound_ms), "err": err}


def time_flash_audio(frames, tokens, n=40, d=128, s=32):
    """Multitalk's audio cross-attention: q [frames, tokens, n, d] over
    the strided k, v halves of one [frames, s, 2 n d] projection, as the
    DiT hands them over; the yardstick's SDPA takes contiguous copies."""
    from wan2gp_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = audio_qkv(frames, tokens, gen, n, d, s)
    scale = _scale(q)
    err = flash_check("audio_cross", q, k, v,
                      A.flash_attention(q, k, v, scale))
    ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale), 20)
    plain_ms = cuda_ms(lambda: A.flash_attention_ref(q, k, v, scale), 1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = library_sdpa(sdpa_ms(qt, kt, vt, 20, scale=scale),
                           " (on contiguous copies of k and v)")
    del qt, kt, vt
    b, l = frames, tokens
    flops = 4.0 * b * n * l * s * d
    bound_ms, by = bound(flops, 2.0 * (2 * b * l * n * d + 2 * b * s * n * d))
    return {"shape": [b, l, s, n, d], "kv_strides": list(k.stride()),
            "ms": ms, "plain_ms": plain_ms, **library, "bound_ms": bound_ms,
            "bound_by": by, **rates(flops, ms, bound_ms), "err": err}


def time_kvmask(name, b, l, n, d, valid, text):
    """The masked kernel at a Krea 2 shape (L = S), beside the dense kernel
    at the same shape: the keys [0, text) are a text slot of which each
    batch item's first valid[i] are valid, and every key after them is
    (Krea 2's packed [text, image] sequence under the Qwen3 encoder's 512
    slots)."""
    from wan2gp_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
    pos = torch.arange(l, device="cuda")[None].expand(b, l)
    mask = (pos < torch.tensor(valid, device="cuda")[:, None]) | (pos >= text)
    scale = _scale(q)
    err = kvmask_check(name, q, k, v, mask,
                       A.flash_attention(q, k, v, scale, mask))
    ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale, mask), 20)
    dense_ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale), 20)
    plain_ms = cuda_ms(lambda: A.flash_attention_ref(q, k, v, scale, mask),
                       1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = library_sdpa(sdpa_ms(qt, kt, vt, 20,
                                   attn_mask=mask[:, None, None, :],
                                   scale=scale),
                           " with the [B, 1, 1, S] bool mask")
    del qt, kt, vt
    # the work and the bytes this mask needs: q and o in full, k and v at
    # the valid keys only, and the mask
    keys = int(mask.sum())
    flops = 4.0 * n * l * d * keys
    bound_ms, by = bound(flops, 2.0 * (2 * b * l * n * d + 2 * keys * n * d)
                         + b * l)
    return {"shape": [b, l, l, n, d], "valid_keys": valid,
            "text_slots": text, "ms": ms,
            "dense_kernel_ms": dense_ms, "plain_ms": plain_ms, **library,
            "bound_ms": bound_ms, "bound_by": by,
            **rates(flops, ms, bound_ms), "err": err}


def time_o(flash, kvmask):
    """(O)'s shapes: Krea 2 from its files, the Qwen3 encoder's 512 text
    slots of which the prompt's and the negative prompt's tokens are
    valid, then 4,096 image tokens (4,608, a multiple of 256: no padding);
    the text refiner over the 512 slots; the layer-wise blocks as 512
    items of the 12 collected layers."""
    o_valid = o_text_tokens()
    kvmask["self_krea2_O"] = time_kvmask("self_krea2_O", 2, O_TEXT + 4096,
                                         48, 128, o_valid, text=O_TEXT)
    kvmask["refiner_krea2_O"] = time_kvmask(
        "refiner_krea2_O", 1, O_TEXT, 20, 128, o_valid[:1], text=O_TEXT)
    kvmask["self_krea2_O"]["launches_per_forward_O"] = O_LAYERS
    kvmask["refiner_krea2_O"]["launches_per_request_O"] = 4
    flash["layerwise_krea2_O"] = time_flash("layerwise_krea2_O", O_TEXT, 12,
                                            12, 20, 128)
    flash["layerwise_krea2_O"]["launches_per_request_O"] = 4


def o_text_tokens():
    """The valid tokens of (O)'s prompt and negative prompt in the Krea 2
    template, as the handler's hash tokenizer counts them."""
    from wan2gp_tpu_torch.families import krea2 as kfam
    from wan2gp_tpu_torch.utils.tokenizer import load_tokenizer
    tok = load_tokenizer(None, vocab_size=151936)
    return [int(tok([kfam.TEMPLATE.format(p)], O_TEXT)[1].sum())
            for p in ("a red fox 0", "")]


def time_a8(kernel, x, w, sc, w_int, reps):
    """An A8 call at one main-path shape: the call (the wrapper with its
    quantization; `ms`), the product alone on activations quantized
    beforehand and the quantization alone, each beside its bound, the
    plain version, torch._int_mm on the same int8 activations and w_int
    (the weight as int8), and the weight-only kernel on the same weight."""
    from wan2gp_tpu_torch.ops import quant as Q
    fn, ref_fn, wo_fn, w_bytes = {
        "matmul_w8a8": (Q.matmul_w8a8, Q.matmul_w8a8_ref, Q.matmul_w8, 1.0),
        "matmul_w4a8": (Q.matmul_w4a8, Q.matmul_w4a8_ref, Q.matmul_w4,
                        0.5)}[kernel]
    m, k = x.shape
    n = sc.shape[0]
    err = a8_check(kernel, f"{m}x{k}x{n}", x, w, sc)
    xq = Q.quantize_act_int8(x)
    flops = 2.0 * m * k * n
    out = {"shape": [m, k, n],
           "ms": cuda_ms(lambda: fn(x, w, sc), reps),
           "product_ms": cuda_ms(lambda: fn(x, w, sc, xq), reps),
           "act_quant_ms": cuda_ms(lambda: Q.quantize_act_int8(x), reps),
           "weight_only_ms": cuda_ms(lambda: wo_fn(x, w, sc), reps),
           "plain_ms": cuda_ms(lambda: ref_fn(x, w, sc), 1),
           "library_ms": (cuda_ms(lambda: torch._int_mm(xq[0], w_int), reps)
                          if m > 16 else None),
           "library_call": "torch._int_mm on the int8 activations and the "
                           "weight as int8 (int32 out, no scales)",
           "err": err}
    # the call reads bf16 x; the product int8 x_q and fp32 sx; the
    # quantization reads bf16 x and writes x_q and sx
    out["bound_ms"], out["bound_by"] = bound(
        flops, 2 * m * k + k * n * w_bytes + 4 * n + 2 * m * n,
        peak=PEAK_INT8_OPS)
    out["product_bound_ms"], _ = bound(
        flops, m * k + 4 * m + k * n * w_bytes + 4 * n + 2 * m * n,
        peak=PEAK_INT8_OPS)
    out["act_quant_bound_ms"], _ = bound(0.0, 3 * m * k + 4 * m)
    for key in ("", "product_", "act_quant_"):
        out[f"{key}bound_share"] = out[f"{key}bound_ms"] / out[f"{key}ms"]
    out["ms_over_weight_only"] = out["ms"] / out["weight_only_ms"]
    del xq
    torch.cuda.empty_cache()
    return out


def time_w8a8(m, k, n):
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = randn((m, k), gen)
    wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    return time_a8("matmul_w8a8", x, wq, sc, wq,
                   5 if m * k * n > 1e12 else 20)


def time_act_quant(m, k):
    """quantize_act_int8 at an A8 input shape, checked bit for bit."""
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = randn((m, k), gen)
    err = act_quant_check(x)
    ms = cuda_ms(lambda: Q.quantize_act_int8(x), 20)
    plain_ms = cuda_ms(lambda: Q.quantize_act_int8_ref(x), 3)
    bound_ms, by = bound(0.0, 3 * m * k + 4 * m)
    del x
    torch.cuda.empty_cache()
    return {"shape": [m, k], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library_call": "none: no single PyTorch call quantizes per row "
                            "to int8 on the card",
            "bound_ms": bound_ms, "bound_by": by,
            "bound_share": bound_ms / ms, "err": err}


def time_w8(name, m, k, n):
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = randn((m, k), gen)
    wq, sc = Q.quantize_int8(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    err = mm_check("matmul_w8", name, Q.matmul_w8(x, wq, sc),
                   Q.matmul_w8_ref(x.float(), wq, sc))
    w_bf16 = (wq.float() * sc).to(torch.bfloat16)
    ms = cuda_ms(lambda: Q.matmul_w8(x, wq, sc), 20)
    plain_ms = cuda_ms(lambda: Q.matmul_w8_ref(x, wq, sc),
                       3 if m > 4096 else 20)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_bf16), 20)
    bound_ms, by = bound(2.0 * m * k * n, 2 * m * k + k * n + 4 * n
                         + 2 * m * n)
    return {"shape": [m, k, n], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "torch.matmul on a bf16 weight dequantized "
                            "beforehand (reads 2 bytes per weight)",
            "bound_ms": bound_ms, "bound_by": by,
            **rates(2.0 * m * k * n, ms, bound_ms),
            "over_library": ms / library_ms, "err": err}


def graph_ms(fn, reps: int) -> float:
    """Device time of one fn() in ms: reps calls captured in a CUDA graph
    and replayed between two events, so no host work lies between the
    launches (cuda_ms's back-to-back calls also measure the host's call
    rate)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / reps


def time_gemv(kernel, m, k, n):
    """An fp32 GEMV (or, above GEMV_MAX_M rows, the fp32 tile kernel) at
    one main-path shape, each launch on another of four weights (the four
    exceed the 50 MB L2, as the forward finds the weight cold), beside
    torch.matmul on the weight dequantized to fp32 beforehand (four copies,
    taken in turn too).  ms: the call (events around back-to-back calls,
    host included; in turns with the library call, each the mean of two
    runs); device_ms: the kernel alone (graph_ms).  The tile
    kernel's bound is three bf16 products (its fp32-exact method) or the
    bytes; the fp32-SIMT bound beside it is labelled as such."""
    import itertools
    from wan2gp_tpu_torch.ops import quant as Q
    _, qfn, fn, ref_fn = next(g for g in (*_gemv_kernels(), *_f32_kernels())
                              if g[0] == kernel)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((m, k), generator=gen, device="cuda")
    ws = [qfn(torch.randn((k, n), generator=gen, device="cuda"))
          for _ in range(4)]
    name = f"{m}x{k}x{n}"
    tile = m > Q.GEMV_MAX_M
    err = mm_check(kernel, name, fn(x, *ws[0]), ref_fn(x, *ws[0]),
                   F32_REL_FRO if tile else GEMV_REL_FRO)
    it = itertools.cycle(ws)
    reps = 200 if m <= 256 else 10
    deq = [wq.float() * sc if kernel.startswith("matmul_w8")
           else Q.unpack_int4(wq, sc, k) for wq, sc in ws]
    dit = itertools.cycle(deq)
    # the call and the library's in turns (library, kernel, kernel,
    # library): where the host sets both, the order moves them
    turns = [cuda_ms(lambda: torch.matmul(x, next(dit)), reps, 5),
             cuda_ms(lambda: fn(x, *next(it)), reps, 5),
             cuda_ms(lambda: fn(x, *next(it)), reps, 5),
             cuda_ms(lambda: torch.matmul(x, next(dit)), reps, 5)]
    ms, library_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    device_ms = graph_ms(lambda: fn(x, *next(it)), reps)
    plain_ms = cuda_ms(lambda: ref_fn(x, *next(it)), 20 if m <= 256 else 3)
    w_bytes = ws[0][0].numel()
    rows = ws[0][0].shape[0]
    nbytes = 4 * m * k + w_bytes + 4 * n + 4 * m * n
    simt_ms, simt_by = bound(2.0 * m * k * n, nbytes, peak=PEAK_FP32_FLOPS)
    if tile:
        bound_ms, by = bound(3 * 2.0 * m * k * n, nbytes)
        extra = {"bound_method": "3 bf16 products (x split in 3 exact bf16 "
                                 "parts) at 989 TFLOP/s, or bytes",
                 "bound_fp32_simt_ms": simt_ms, "bound_fp32_simt_by": simt_by,
                 "plan_tile_split": list(Q.f32_plan(
                     m, -(-n // 16) * 16,
                     Q.f32_steps(k, None if kernel.startswith("matmul_w8")
                                 else rows)))}
    else:
        bound_ms, by = simt_ms, simt_by
        rows = rows if kernel.startswith("matmul_w8") else min(rows, k)
        extra = {"bound_method": "fp32 FMAs at 67 TFLOP/s, or bytes",
                 "plan_cp_cluster": list(Q.gemv_plan(m, rows, n))}
    del ws, deq, dit, it
    torch.cuda.empty_cache()
    return {"shape": [m, k, n], "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "torch.matmul on an fp32 weight dequantized "
                            "beforehand (reads 4 bytes per weight)",
            "bound_ms": bound_ms, "bound_by": by, **extra,
            "bound_share": bound_ms / ms,
            "device_bound_share": bound_ms / device_ms,
            "over_library": ms / library_ms, "err": err}


def _pairs(kv_idx, counts, l, s_len, block_q, block_kv):
    """(query, key) pairs a table attends, summed over its rows: the work
    these inputs need.  kv_idx [G, nQb, W], counts [G, nQb]."""
    keys = torch.clamp(s_len - kv_idx.long() * block_kv, 0, block_kv)
    slot = torch.arange(kv_idx.shape[-1], device=kv_idx.device)
    keys = (keys * (slot < counts[..., None])).sum(-1)      # [G, nQb]
    rows = torch.clamp(l - torch.arange(kv_idx.shape[1],
                                        device=kv_idx.device) * block_q,
                       0, block_q)
    return int((keys * rows).sum().item())


def time_sparse(b, l, n, d, frames, tpf):
    """The radial mask of the 14B 720p grid through sparse_flash."""
    from wan2gp_tpu_torch.ops import attention as A
    from wan2gp_tpu_torch.ops import sparse_attention as SP
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
    scale, bq = _scale(q), 512
    kv_idx, counts, bkv = A._structured_tables(
        f"radial:{frames}:{tpf}", l, l, bq, 256, str(q.device))
    got = SP.sparse_flash(q, k, v, kv_idx, counts, scale, bq, bkv)
    err = attn_check("sparse_flash", "radial_720p", q, k, got,
                     SP.table_attention_ref(q.float(), k.float(), v.float(),
                                            kv_idx[None], counts[None],
                                            scale, bq, bkv)[0])
    del got
    ms = cuda_ms(lambda: SP.sparse_flash(q, k, v, kv_idx, counts, scale, bq,
                                         bkv), 3)
    plain_ms = cuda_ms(lambda: SP.table_attention_ref(
        q, k, v, kv_idx[None], counts[None], scale, bq, bkv), 1, warmup=0)
    pairs = _pairs(kv_idx[None], counts[None], l, l, bq, bkv)
    # yardstick: SDPA (memory-efficient backend) with the block mask
    # expanded to a [L, S] additive bf16 bias
    blocks = torch.zeros((kv_idx.shape[0], -(-l // bkv)), dtype=torch.bool,
                         device="cuda")
    slot = torch.arange(kv_idx.shape[1], device="cuda")
    blocks[torch.arange(kv_idx.shape[0], device="cuda")[:, None]
           .expand_as(kv_idx)[slot < counts[:, None]],
           kv_idx.long()[slot < counts[:, None]]] = True
    dense = blocks.repeat_interleave(bq, 0)[:l].repeat_interleave(bkv, 1)[
        :, :l]
    bias = torch.zeros((l, l), dtype=torch.bfloat16, device="cuda")
    bias.masked_fill_(~dense, float("-inf"))
    del dense
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias[None, None], scale=scale), 3)
    del bias, qt, kt, vt
    torch.cuda.empty_cache()
    flops = 4.0 * d * b * n * pairs
    bound_ms, by = bound(flops,
                         2.0 * (2 * b * l * n * d + 2 * b * l * n * d))
    return {"shape": [b, l, l, n, d], "block_q": bq, "block_kv": bkv,
            "density": pairs / (l * l), "pairs": b * n * pairs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention (memory-"
                            "efficient backend) with the block mask as a "
                            "[L, S] bf16 bias",
            "bound_ms": bound_ms, "bound_by": by,
            **rates(flops, ms, bound_ms), "err": err}


def time_sol(b, l, n, d):
    """Sol's exact branch at the 14B 720p shape, tables from sol_route."""
    from wan2gp_tpu_torch.ops import sparse_attention as SP
    from wan2gp_tpu_torch.ops import sol_attention as SOL
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (randn((b, l, n, d), gen) for _ in range(3))
    scale, bq, bkv = _scale(q), 512, 256
    idx, cnt, _, _ = SOL.sol_route(q, k, scale, 1.0, bq, bkv)
    got, lse = SOL.sol_flash(q, k, v, idx, cnt, scale, bq, bkv)
    ref, ref_lse = SP.table_attention_ref(q.float(), k.float(), v.float(),
                                          idx, cnt, scale, bq, bkv)
    err = sol_check("sol_720p", q, k, got, lse, ref, ref_lse)
    del got, lse, ref, ref_lse
    ms = cuda_ms(lambda: SOL.sol_flash(q, k, v, idx, cnt, scale, bq, bkv), 3)
    plain_ms = cuda_ms(lambda: SP.table_attention_ref(
        q, k, v, idx, cnt, scale, bq, bkv), 1, warmup=0)
    pairs = _pairs(idx, cnt, l, l, bq, bkv)
    flops = 4.0 * d * pairs
    bound_ms, by = bound(flops, 2.0 * 4 * b * l * n * d + 4.0 * b * n * l)
    return {"shape": [b, l, l, n, d], "block_q": bq, "block_kv": bkv,
            "table_width": idx.shape[-1],
            "mean_count_over_w": cnt.float().mean().item() / idx.shape[-1],
            "density": pairs / (b * n * l * l), "pairs": pairs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library_call": "none: no single PyTorch call computes a "
                            "per-head table-driven attention",
            "bound_ms": bound_ms, "bound_by": by,
            **rates(flops, ms, bound_ms), "err": err}


def time_w4(m, k, n):
    """matmul_w4 and matmul_w4a8 at one (M, K, N) of the 14B path."""
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = randn((m, k), gen)
    wp, sc = Q.quantize_int4(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    name = f"{m}x{k}x{n}"
    reps = 5 if m * k * n > 1e12 else 20
    out = {}
    w_int = Q._unpack_nibbles(wp, k)
    # W4: bf16 activations
    err = mm_check("matmul_w4", name, Q.matmul_w4(x, wp, sc),
                   Q.matmul_w4_ref(x.float(), wp, sc))
    w_bf16 = (w_int.float() * sc).to(torch.bfloat16)
    b_ms, b_by = bound(2.0 * m * k * n, 2 * m * k + k * n / 2 + 4 * n
                       + 2 * m * n)
    ms = cuda_ms(lambda: Q.matmul_w4(x, wp, sc), reps)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_bf16), reps)
    out["matmul_w4"] = {
        "shape": [m, k, n], "ms": ms,
        "plain_ms": cuda_ms(lambda: Q.matmul_w4_ref(x, wp, sc), 1),
        "library_ms": library_ms,
        "library_call": "torch.matmul on a bf16 weight dequantized "
                        "beforehand (reads 2 bytes per weight)",
        "bound_ms": b_ms, "bound_by": b_by,
        **rates(2.0 * m * k * n, ms, b_ms),
        "over_library": ms / library_ms, "err": err}
    del w_bf16
    # W4A8: int8 activations, int32 product
    out["matmul_w4a8"] = time_a8("matmul_w4a8", x, wp, sc,
                                 w_int.contiguous(), reps)
    del w_int
    torch.cuda.empty_cache()
    return out


def time_w4a8(m, k, n):
    """matmul_w4a8 alone at one (M, K, N) (the batch-1 shapes of
    sequential CFG at 14B)."""
    from wan2gp_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = randn((m, k), gen)
    wp, sc = Q.quantize_int4(torch.randn((k, n), generator=gen,
                                         device="cuda"))
    out = time_a8("matmul_w4a8", x, wp, sc,
                  Q._unpack_nibbles(wp, k).contiguous(),
                  5 if m * k * n > 1e12 else 20)
    del x, wp, sc
    torch.cuda.empty_cache()
    return out


# launches per batch-1 DiT forward of (C) (14B, sequential CFG) at the
# shapes only (C) runs: per layer one Sol and one cross flash; W4A8 on
# q, k, v, o of the self-attention and q, o of the cross-attention
# (5120x5120), fc1 and fc2 at M = 75,600, cross k and v at M = 512; one
# quantization for q/k/v, one for each other input at M = 75,600 and one
# for the 512 text tokens
C_PER_FORWARD = {"sol_720p_b1": A_LAYERS, "cross_14B_720p_b1": A_LAYERS,
                 "75600x5120x5120": 6 * A_LAYERS,
                 "75600x5120x13824": A_LAYERS,
                 "75600x13824x5120": A_LAYERS, "75600x5120": 5 * A_LAYERS,
                 "75600x13824": A_LAYERS, "512x5120x5120": 2 * A_LAYERS,
                 "512x5120": A_LAYERS}
# (A) and (C), each computed forward: per layer one Sol and one cross
# flash, ten W4A8 products from seven quantizations
A_KERNELS = {"sol_flash": A_LAYERS, "flash_attention": A_LAYERS,
             "matmul_w4a8": 10 * A_LAYERS, "act_quant": 7 * A_LAYERS}
# launches per DiT forward of (F) (14B i2v, 832x480, bf16, CFG batch 2):
# per layer self, text cross and image cross flash
F_PER_FORWARD = {"self_14B_480p": F_LAYERS, "cross_14B_480p": F_LAYERS,
                 "image_cross_14B_480p": F_LAYERS}
# launches per DiT forward of (G) (Wan2.2 i2v at 1280x720, int8, CFG
# batch 2), either expert: per layer one self and one cross flash; W8 on
# q, k, v, o of the self-attention and q, o of the cross-attention, fc1,
# fc2 at M = 151,200 and cross k, v at M = 1,024
G_PER_FORWARD = {"self_14B_720p_b2": G_LAYERS, "cross_14B_720p": G_LAYERS,
                 "151200x5120x5120": 6 * G_LAYERS,
                 "151200x5120x13824": G_LAYERS,
                 "151200x13824x5120": G_LAYERS,
                 "1024x5120x5120": 2 * G_LAYERS}
# launches per DiT forward of (N) (t2v 14B at 1280x720, bf16, guidance 1:
# batch 1): per layer one self and one text cross flash, no W8
N_PER_FORWARD = {"self_14B_720p": N_LAYERS, "cross_14B_720p_b1": N_LAYERS}


# launches per DiT forward of (I) (Wan2.2 5B at 1280x704x121, int8 from its
# file, CFG batch 2): per layer one self and one cross flash (24 heads); W8
# on q, k, v, o of the self-attention and q, o of the cross-attention (K =
# N = 3072), fc1, fc2 at M = 54,560 and the cross k, v at M = 1,024
I_TOKENS = ((I_FRAMES - 1) // 4 + 1) * (I_H // 32) * (I_W // 32)
I_PER_FORWARD = {"self_5B": I_LAYERS, "cross_5B": I_LAYERS,
                 f"{2 * I_TOKENS}x3072x3072": 6 * I_LAYERS,
                 f"{2 * I_TOKENS}x3072x14336": I_LAYERS,
                 f"{2 * I_TOKENS}x14336x3072": I_LAYERS,
                 "1024x3072x3072": 2 * I_LAYERS}
# launches per DiT forward of (J) (vace_multitalk_14B at 832x480x81, int8,
# the two audio-CFG branches as batch 2) at J_LAYERS main blocks and a
# VACE block every second layer: per main block a self, a text cross and
# an audio cross flash, per VACE block a self and a text cross; W8 at M =
# 65,520 on self q, k, v, o and cross q, o of every block, the audio q, o
# and the VACE after_proj; fc1, fc2 of every block; cross k, v at M =
# 1,024; the audio kv at M = 42 x 32
J_TOKENS = 21 * 30 * 52
J_VACE = J_LAYERS // 2
J_BLOCKS = J_LAYERS + J_VACE
J_PER_FORWARD = {"self_14B_480p": J_BLOCKS, "cross_14B_480p": J_BLOCKS,
                 "audio_cross_J": J_LAYERS,
                 f"{2 * J_TOKENS}x5120x5120": (6 * J_BLOCKS + 2 * J_LAYERS
                                               + J_VACE),
                 f"{2 * J_TOKENS}x5120x13824": J_BLOCKS,
                 f"{2 * J_TOKENS}x13824x5120": J_BLOCKS,
                 "1024x5120x5120": 2 * J_BLOCKS, "1344x768x10240": J_LAYERS}
J_KERNELS = {"flash_attention": 2 * J_BLOCKS + J_LAYERS,
             "matmul_w8": 10 * J_BLOCKS + 3 * J_LAYERS + J_VACE}


# launches per DiT forward of (K) (flux_schnell at 1280x720, batch 1, at
# K_DOUBLE double and K_SINGLE single blocks): one joint attention a block;
# under int8 / int4 the double blocks' qkv, proj, mlp.0, mlp.2 of the
# image (M = 3,600) and text (M = 256) streams, the single blocks' linear1
# and linear2 (M = 3,856), and one fp32 modulation GEMV a stream (K =
# 3072, N = 18,432 / 9,216)
K_IMG = K_TOKENS - K_TXT
K_PER_FORWARD = {"self_flux_K": K_DOUBLE + K_SINGLE,
                 **{f"{m}x{k}x{n}": K_DOUBLE for m in (K_IMG, K_TXT)
                    for k, n in ((3072, 9216), (3072, 3072), (3072, 12288),
                                 (12288, 3072))},
                 f"{K_TOKENS}x3072x21504": K_SINGLE,
                 f"{K_TOKENS}x15360x3072": K_SINGLE,
                 "1x3072x18432": 2 * K_DOUBLE, "1x3072x9216": K_SINGLE}
# the same by kernel: flash, W8 / W4, the fp32 GEMV
K_KERNELS = (K_DOUBLE + K_SINGLE, 8 * K_DOUBLE + 2 * K_SINGLE,
             2 * K_DOUBLE + K_SINGLE)


# launches per DiT forward of (L) (HunyuanVideo 1.5 at 832x480x97, int8
# from its quanto file, CFG batch 2): one joint attention a double block
# (54); W8 on each stream's qkv, proj, mlp1, mlp2 at the image (M = 19,500)
# and text (M = 1,024) tokens, and on the refiner's 2 blocks (M = 512);
# the fp32 W8 GEMV on each stream's modulation (K = 2048, N = 12,288) and
# the refiner's adaLN (N = 4,096)
L_LINEARS = ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048))
L_PER_FORWARD = {"self_hv15_L": L_LAYERS,
                 **{f"{m}x{k}x{n}": L_LAYERS for m in (2 * L_IMG, 2 * L_TXT)
                    for k, n in L_LINEARS},
                 **{f"512x{k}x{n}": 2 for k, n in L_LINEARS},
                 "2x2048x12288": 2 * L_LAYERS, "2x2048x4096": 2}
L_KERNELS = {"flash_attention": L_LAYERS, "matmul_w8": 8 * L_LAYERS + 8,
             "matmul_w8_gemv": 2 * L_LAYERS + 2}


def phase_time(tokens: int):
    # W4 and W4A8 at K=N=5120 first, before any other timing, and again in
    # their place below: does the order of the phase move their times?
    first = time_w4(151200, 5120, 5120)
    flash = {name: time_flash(name, *shape) for name, shape in (
        ("self_1.3B", (2, tokens, tokens, 12, 128)),
        ("cross_1.3B", (2, tokens, 512, 12, 128)),
        ("self_14B_720p", (1, 75600, 75600, 40, 128)),
        ("cross_14B_720p", (2, 75600, 512, 40, 128)))}
    w8 = {f"{k}x{n}": time_w8(f"{k}x{n}", 2 * tokens, k, n)
          for k, n in ((1536, 1536), (1536, 8960), (8960, 1536))}
    # cross-attention k/v: 2 x 512 text tokens
    w8["1024x1536x1536"] = time_w8("1024x1536x1536", 1024, 1536, 1536)
    sparse = {"radial_720p": time_sparse(2, 75600, 40, 128, 21, 3600)}
    sol = {"sol_720p": time_sol(2, 75600, 40, 128),
           # (C): one branch at a time under sequential CFG
           "sol_720p_b1": time_sol(1, 75600, 40, 128)}
    flash["cross_14B_720p_b1"] = time_flash("cross_14B_720p_b1", 1, 75600,
                                            512, 40, 128)
    # time per attended (query, key, head) against the dense kernel's
    dense = flash["self_14B_720p"]
    dense_ps = dense["ms"] * 1e9 / math.prod(dense["shape"][:4])
    for t in (sparse["radial_720p"], sol["sol_720p"], sol["sol_720p_b1"]):
        t["ps_per_pair"] = t["ms"] * 1e9 / t["pairs"]
        t["dense_ps_per_pair"] = dense_ps
        t["pair_time_over_dense"] = t["ps_per_pair"] / dense_ps
    w4 = {"151200x5120x5120_first": first["matmul_w4"]}
    w4a8 = {"151200x5120x5120_first": first["matmul_w4a8"]}
    shapes_14b = ((151200, 5120, 5120), (151200, 5120, 13824),
                  (151200, 13824, 5120), (1024, 5120, 5120))
    for m, k, n in shapes_14b:
        t = time_w4(m, k, n)
        w4[f"{m}x{k}x{n}"] = t["matmul_w4"]
        w4a8[f"{m}x{k}x{n}"] = t["matmul_w4a8"]
    kvmask = {}
    time_o(flash, kvmask)
    w8a8 = {f"{k}x{n}": time_w8a8(2 * tokens, k, n)
            for k, n in ((1536, 1536), (1536, 8960), (8960, 1536))}
    w8a8["1024x1536x1536"] = time_w8a8(1024, 1536, 1536)
    w8a8.update({f"{m}x{k}x{n}": time_w8a8(m, k, n)
                 for m, k, n in shapes_14b})
    # (C)'s batch-1 products at M = 75,600
    w4a8.update({f"{m}x{k}x{n}": time_w4a8(m, k, n) for m, k, n in (
        (75600, 5120, 5120), (75600, 5120, 13824), (75600, 13824, 5120))})
    # (C)'s cross k/v products at M = 512
    w4a8["512x5120x5120"] = time_w4a8(512, 5120, 5120)
    # every A8 input: the 1.3B and 14B linears' K at their M
    aq = {f"{m}x{k}": time_act_quant(m, k) for m, k in (
        (2 * tokens, 1536), (2 * tokens, 8960), (1024, 1536),
        (151200, 5120), (151200, 13824), (1024, 5120), (75600, 5120),
        (75600, 13824), (512, 5120))}
    # (F): 14B i2v at 832x480 (the 1.3B's tokens), CFG batch 2; (G): the
    # 14B self-attention at 1280x720 at batch 2, W8 at the 14B linears
    for name, shape in (
            ("self_14B_480p", (2, tokens, tokens, 40, 128)),
            ("cross_14B_480p", (2, tokens, 512, 40, 128)),
            ("image_cross_14B_480p", (2, tokens, 257, 40, 128)),
            ("self_14B_720p_b2", (2, 75600, 75600, 40, 128))):
        flash[name] = time_flash(name, *shape)
    w8.update({f"{m}x{k}x{n}": time_w8(f"{m}x{k}x{n}", m, k, n)
               for m, k, n in shapes_14b})
    # (I): the 5B at 1280x704x121, CFG batch 2
    for name, shape in (("self_5B", (2, I_TOKENS, I_TOKENS, 24, 128)),
                        ("cross_5B", (2, I_TOKENS, 512, 24, 128))):
        flash[name] = time_flash(name, *shape)
    w8.update({f"{m}x{k}x{n}": time_w8(f"{m}x{k}x{n}", m, k, n)
               for m, k, n in ((2 * I_TOKENS, 3072, 3072),
                               (2 * I_TOKENS, 3072, 14336),
                               (2 * I_TOKENS, 14336, 3072),
                               (1024, 3072, 3072))})
    # (J): the audio cross-attention (42 latent-frame items of 1,560
    # tokens over 32 audio tokens) and W8 at the 14B linears at 480p and at
    # the audio kv projection (K = 768)
    flash["audio_cross_J"] = time_flash_audio(2 * 21, 30 * 52)
    w8.update({f"{m}x{k}x{n}": time_w8(f"{m}x{k}x{n}", m, k, n)
               for m, k, n in ((2 * J_TOKENS, 5120, 5120),
                               (2 * J_TOKENS, 5120, 13824),
                               (2 * J_TOKENS, 13824, 5120),
                               (1344, 768, 10240))})
    # (K): the joint attention of Flux at 1280x720 (256 text + 3,600 image
    # tokens, 24 heads), W8 at its block linears, the two fp32 GEMVs
    flash["self_flux_K"] = time_flash("self_flux_K", 1, K_TOKENS, K_TOKENS,
                                      24, 128)
    w8.update({case: time_w8(case, *map(int, case.split("x")))
               for case in K_PER_FORWARD if case.count("x") == 2
               and not case.startswith("1x")})
    gemv = {kernel: {f"1x3072x{n}": time_gemv(kernel, 1, 3072, n)
                     for n in (18432, 9216)}
            for kernel in ("matmul_w8_gemv", "matmul_w4_gemv")}
    time_l(flash, w8, gemv)
    time_pq(flash, w8, gemv)
    time_rs(flash, w8, gemv)
    time_u(flash, w8, gemv)
    f32 = time_m(flash, w8, gemv)
    for table in (flash, w8, *gemv.values()):
        for case, t in table.items():
            if case in K_PER_FORWARD:
                t["launches_per_forward_K"] = K_PER_FORWARD[case]
    for table in (flash, sol, w4a8, aq):
        for case, t in table.items():
            if case in C_PER_FORWARD:
                t["launches_per_forward_C"] = C_PER_FORWARD[case]
    for case, n in F_PER_FORWARD.items():
        flash[case]["launches_per_forward_F"] = n
    for case, n in N_PER_FORWARD.items():
        flash[case]["launches_per_forward_N"] = n
    for case, n in G_PER_FORWARD.items():
        (flash if case in flash else w8)[case]["launches_per_forward_G"] = n
    for case, n in I_PER_FORWARD.items():
        (flash if case in flash else w8)[case]["launches_per_forward_I"] = n
    for case, n in J_PER_FORWARD.items():
        (flash if case in flash else w8)[case]["launches_per_forward_J"] = n
    emit("time", flash_attention=flash, flash_attention_kvmask=kvmask,
         matmul_w8=w8, matmul_w8a8=w8a8, sparse_flash=sparse, sol_flash=sol,
         matmul_w4=w4, matmul_w4a8=w4a8, act_quant=aq, **gemv, **f32,
         tolerance=TOLERANCE)
    return {"flash_attention": flash, "flash_attention_kvmask": kvmask,
            "matmul_w8": w8, "matmul_w8a8": w8a8, "sparse_flash": sparse,
            "sol_flash": sol, "matmul_w4": w4, "matmul_w4a8": w4a8,
            "act_quant": aq, **gemv, **f32}


def time_l(flash, w8, gemv):
    """(L)'s rows: the joint attention at B2 L = S = 10,262 over 16 heads,
    W8 at the image stream's four linears (M = 19,500) and the text
    stream's qkv (M = 1,024), the fp32 W8 GEMV at the modulations and the
    refiner's adaLN (M = 2, N 12,288 and 4,096), each with its launches per
    (L) forward."""
    flash["self_hv15_L"] = time_flash("self_hv15_L", 2, L_TOKENS, L_TOKENS,
                                      16, 128)
    for m, k, n in ((2 * L_IMG, *L_LINEARS[0]), (2 * L_IMG, *L_LINEARS[1]),
                    (2 * L_IMG, *L_LINEARS[2]), (2 * L_IMG, *L_LINEARS[3]),
                    (2 * L_TXT, *L_LINEARS[0])):
        w8[f"{m}x{k}x{n}"] = time_w8(f"{m}x{k}x{n}", m, k, n)
    for n in (12288, 4096):
        gemv["matmul_w8_gemv"][f"2x2048x{n}"] = time_gemv("matmul_w8_gemv", 2,
                                                          2048, n)
    for table in (flash, w8, gemv["matmul_w8_gemv"]):
        for case, t in table.items():
            if case in L_PER_FORWARD:
                t["launches_per_forward_L"] = L_PER_FORWARD[case]


def time_pq(flash, w8, gemv):
    """(P)'s rows: the joint attention at B2 L = S = 4,624 over 24 heads,
    W8 at both streams' block linears (M = 7,200 image, 2,048 text rows),
    the fp32 W8 GEMV at the modulation (M = 2, K = 3072, N = 18,432);
    (Q)'s: its self-attentions over 30 heads at 4,608 (main), 4,096
    (noise refiner) and 512 (context refiner) tokens; each with its
    launches per forward."""
    flash["joint_qwen_P"] = time_flash("joint_qwen_P", 2, P_TOKENS, P_TOKENS,
                                       24, 128)
    w8.update({case: time_w8(case, *map(int, case.split("x")))
               for case in P_PER_FORWARD if case.count("x") == 2
               and not case.startswith("2x")})
    gemv["matmul_w8_gemv"]["2x3072x18432"] = time_gemv("matmul_w8_gemv", 2,
                                                       3072, 18432)
    for name, tokens in (("main_zimage_Q", Q_TXT + Q_IMG),
                         ("noise_refiner_zimage_Q", Q_IMG),
                         ("context_refiner_zimage_Q", Q_TXT)):
        flash[name] = time_flash(name, 1, tokens, tokens, 30, 128)
    for table in (flash, w8, gemv["matmul_w8_gemv"]):
        for case, t in table.items():
            for key, per in (("P", P_PER_FORWARD), ("Q", Q_PER_FORWARD)):
                if case in per:
                    t[f"launches_per_forward_{key}"] = per[case]


def time_rs(flash, w8, gemv):
    """(R)'s row: the joint attention of FLUX.2 Klein 9B at B1 L = S =
    4,608 over 32 heads; (S)'s: Kontext's joint attention at B1 L = S =
    8,704 over 24 heads and W8 at its block linears (M = 8,192 image, 512
    text and 8,704 single-block rows; its modulation GEMVs are (K)'s
    shapes); each with its launches per forward."""
    flash["joint_klein9b_R"] = time_flash("joint_klein9b_R", 1, R_TOKENS,
                                          R_TOKENS, 32, 128)
    flash["joint_kontext_S"] = time_flash("joint_kontext_S", 1, S_TOKENS,
                                          S_TOKENS, 24, 128)
    w8.update({case: time_w8(case, *map(int, case.split("x")))
               for case in S_PER_FORWARD if case.count("x") == 2
               and not case.startswith("1x")})
    for table in (flash, w8, gemv["matmul_w8_gemv"]):
        for case, t in table.items():
            for key, per in (("R", R_PER_FORWARD), ("S", S_PER_FORWARD)):
                if case in per:
                    t[f"launches_per_forward_{key}"] = per[case]


def time_u(flash, w8, gemv):
    """(U)'s rows: HV1's joint attention at B1 L = S = 39,256 over 24
    heads, W8 at the double blocks' image-stream linears (M = 39,000) and
    the single blocks' linear1 / linear2 (M = 39,256), the fp32 W8 GEMV at
    the refiner's adaLN (1 x 3072 x 6144; the modulations' shapes are
    (K)'s), each with its launches per (U) forward."""
    flash["joint_hv1_U"] = time_flash("joint_hv1_U", 1, U_TOKENS, U_TOKENS,
                                      24, 128)
    w8.update({case: time_w8(case, *map(int, case.split("x")))
               for case in U_PER_FORWARD if case.count("x") == 2
               and not case.startswith("1x")})
    gemv["matmul_w8_gemv"]["1x3072x6144"] = time_gemv("matmul_w8_gemv", 1,
                                                      3072, 6144)
    for table in (flash, w8, gemv["matmul_w8_gemv"]):
        for case, t in table.items():
            if case in U_PER_FORWARD:
                t["launches_per_forward_U"] = U_PER_FORWARD[case]


# launches per DiT forward of (M) (LTX-2 22B at 1280x704x241, int8 from a
# quanto state dict with every linear quantized, batch 1): per block 6
# flash (video self 27,280 N32 D128, its text cross, audio self 251 N32
# D64, its text cross, a2v, v2a); W8 on q, k, v, out and the gate of each
# of the 6 attentions and on the two FFNs (34 a block) and the 4 caption
# projection linears; the fp32 tile kernel on patchify and proj_out of both
# streams and the 6 adaLN tables' t1, t2 and linear at M = 31 / 251 (22);
# the fp32 GEMV on the 2 prompt adaLN tables' t1, t2 and linear at M = 1
# (6)
M_KERNELS = {"flash_attention": 6 * M_LAYERS, "matmul_w8": 34 * M_LAYERS + 4,
             "matmul_w8_f32": 22, "matmul_w8_gemv": 6}
# the tile kernel's shapes: video tables (adaLN 9 x 4096, the a/v cross
# scale-shift 4 x 4096, the a2v gate 4096; t1 from the 256 sinusoid, t2
# 4096 x 4096), audio tables likewise at 2048, patchify and proj_out
M_F32 = {f"{M_GRID[0]}x256x4096": 3, f"{M_GRID[0]}x4096x4096": 4,
         f"{M_GRID[0]}x4096x36864": 1, f"{M_GRID[0]}x4096x16384": 1,
         f"{M_AUDIO}x256x2048": 3, f"{M_AUDIO}x2048x2048": 4,
         f"{M_AUDIO}x2048x18432": 1, f"{M_AUDIO}x2048x8192": 1,
         f"{M_TOKENS}x128x4096": 1, f"{M_AUDIO}x128x2048": 1,
         f"{M_TOKENS}x4096x128": 1, f"{M_AUDIO}x2048x128": 1}
# the GEMV's: the video and audio prompt tables (2 x 4096, 2 x 2048)
M_GEMV = {"1x256x4096": 1, "1x4096x4096": 1, "1x4096x8192": 1,
          "1x256x2048": 1, "1x2048x2048": 1, "1x2048x4096": 1}
assert sum(M_F32.values()) == M_KERNELS["matmul_w8_f32"]
assert sum(M_GEMV.values()) == M_KERNELS["matmul_w8_gemv"]
M_PER_FORWARD = {"self_ltx2_M": M_LAYERS, "text_cross_ltx2_M": M_LAYERS,
                 "audio_self_ltx2_M": M_LAYERS, "a2v_ltx2_M": M_LAYERS,
                 "v2a_ltx2_M": M_LAYERS,
                 f"{M_TOKENS}x4096x4096": 6 * M_LAYERS,
                 f"{M_TOKENS}x4096x16384": M_LAYERS,
                 f"{M_TOKENS}x16384x4096": M_LAYERS,
                 f"{M_AUDIO}x2048x8192": M_LAYERS}


def time_m(flash, w8, gemv):
    """(M)'s rows: flash at the video self-attention (B1 L = S = 27,280,
    32 heads of 128), its text cross (S = the prompt's bytes), the audio
    self-attention (251, 32 x 64) and the a2v / v2a crosses; W8 at the
    video q/k/v/out (K = N = 4096), the FFN (4096 x 16,384 and back) and the
    audio FFN; the fp32 W8 tile kernel at every shape (M) runs it at
    (M_F32: the adaLN tables' t1, t2 and linear at M = 31 / 251, patchify
    and proj_out of both streams), the W4 one at the largest four; the fp32
    GEMV at the prompt tables' (M_GEMV, M = 1).  Returns the tile kernel's
    rows."""
    n_txt = len(M_PROMPT.encode())
    for name, shape in (
            ("self_ltx2_M", (1, M_TOKENS, M_TOKENS, 32, 128)),
            ("text_cross_ltx2_M", (1, M_TOKENS, n_txt, 32, 128)),
            ("audio_self_ltx2_M", (1, M_AUDIO, M_AUDIO, 32, 64)),
            ("a2v_ltx2_M", (1, M_TOKENS, M_AUDIO, 32, 64)),
            ("v2a_ltx2_M", (1, M_AUDIO, M_TOKENS, 32, 64))):
        flash[name] = time_flash(name, *shape)
    w8.update({f"{m}x{k}x{n}": time_w8(f"{m}x{k}x{n}", m, k, n)
               for m, k, n in ((M_TOKENS, 4096, 4096),
                               (M_TOKENS, 4096, 16384),
                               (M_TOKENS, 16384, 4096),
                               (M_AUDIO, 2048, 8192))})
    f32 = {"matmul_w8_f32": {case: time_gemv("matmul_w8_f32",
                                             *map(int, case.split("x")))
                             for case in M_F32},
           # no path runs W4 on fp32 x above 16 rows: the largest shapes
           "matmul_w4_f32": {case: time_gemv("matmul_w4_f32",
                                             *map(int, case.split("x")))
                             for case in (f"{M_GRID[0]}x4096x36864",
                                          f"{M_AUDIO}x2048x18432",
                                          f"{M_TOKENS}x128x4096",
                                          f"{M_TOKENS}x4096x128")}}
    for case in M_GEMV:
        gemv["matmul_w8_gemv"][case] = time_gemv("matmul_w8_gemv",
                                                 *map(int, case.split("x")))
    for table, per_forward in ((flash, M_PER_FORWARD), (w8, M_PER_FORWARD),
                               (gemv["matmul_w8_gemv"], M_GEMV),
                               (f32["matmul_w8_f32"], M_F32)):
        for case, t in table.items():
            if case in per_forward:
                t["launches_per_forward_M"] = per_forward[case]
    return f32


# the denoise steps of (C): the fewest at which a TeaCache plan for 1.75x
# (int(6 / 1.75) = 3 computed steps) skips a step
C_STEPS = 6
# the first-block cache's threshold in (E): far above the rel-L1 of block
# 0's output between two steps, so every step that may skip does
E_FBC_THRESHOLD = 1e3
# while a list is pushed, each DiT forward of the pipeline appends to it:
# calc (whether it ran the block stack), its launches by kernel, seconds
FORWARDS = []


def record_forwards():
    """Wraps the pipeline's DiT forward to record each forward while
    FORWARDS holds a list; returns the real forward."""
    from wan2gp_tpu_torch.models.wan import pipeline as P
    real = P.wan_dit_forward

    def recorder(*a, **kw):
        if not FORWARDS:
            return real(*a, **kw)
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counts()
        skip, fbc = kw.get("skip_state"), kw.get("fbc_state")
        if skip is not None:
            calc = bool(skip[0])
        elif fbc is not None:           # a skip hands the tail back as is
            calc = out[1][1] is not fbc[1]
        else:
            calc = True
        FORWARDS[-1].append({"calc": calc, "s": dt, "params": id(a[0]),
                             "launches": {k: after[k] - before[k]
                                          for k in after
                                          if after[k] != before[k]}})
        return out
    P.wan_dit_forward = recorder
    return real


def tea_threshold(pipe, sched, speed: float, pixels: int):
    """The TeaCache threshold for `speed` on these weights: the smallest
    partial sum of the per-step deltas (just above it) whose plan computes
    int(steps / speed) steps.  The auto threshold searches 0.01..0.6 and so
    skips nothing on random weights, whose time embeddings move by a
    rel-L1 near 1 a step (trained ones by about 0.1).  Returns (threshold,
    rel-L1s)."""
    from wan2gp_tpu_torch import caches
    from wan2gp_tpu_torch.models.wan.dit import time_embedding_vec
    e = [time_embedding_vec(pipe.dit_params, pipe.dit_cfg, torch.tensor(
        [t], dtype=torch.float32, device=pipe.device)).cpu().numpy()
         for t in sched.timesteps]
    co = caches.teacache_coefficients(pipe.base_model_type, False, pixels)
    rel = caches.teacache_rel_l1s(e)
    deltas = [abs(np.poly1d(co)(r)) for r in rel]
    target = int(len(e) / speed)
    cands = sorted({sum(deltas[i:j]) * (1 + 1e-6)
                    for i in range(1, len(e)) for j in range(i + 1,
                                                             len(e) + 1)})
    hit = [t for t in cands
           if caches._teacache_decide(rel, co, t, 0).sum() == target]
    if not hit:
        raise AssertionError(f"no TeaCache threshold plans {target} of "
                             f"{len(e)} steps (deltas {deltas})")
    return hit[0], rel


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


class _VaeSD(dict):
    """A torch-layout VAE state dict, written from a port VAE tree: the key
    names `io.wan_checkpoint`'s VAE loaders consume."""

    def conv(self, pre, c):
        self[f"{pre}.weight"], self[f"{pre}.bias"] = c["w"], c["b"]

    def gamma(self, key, g, ndim):      # RMS_norm gamma [C, 1, 1(, 1)]
        self[key] = g.reshape(-1, *([1] * ndim))

    def res(self, pre, r):
        self.gamma(f"{pre}.residual.0.gamma", r["norm1"], 3)
        self.conv(f"{pre}.residual.2", r["conv1"])
        self.gamma(f"{pre}.residual.3.gamma", r["norm2"], 3)
        self.conv(f"{pre}.residual.6", r["conv2"])
        if "shortcut" in r:
            self.conv(f"{pre}.shortcut", r["shortcut"])

    def attn(self, pre, a):
        self.gamma(f"{pre}.norm.gamma", a["norm"], 2)
        self.conv(f"{pre}.to_qkv", a["qkv"])
        self.conv(f"{pre}.proj", a["proj"])

    def resample(self, pre, q):
        self.conv(f"{pre}.resample.1", q["conv"])
        if "time_conv" in q:
            self.conv(f"{pre}.time_conv", q["time_conv"])

    def around_towers(self, p):
        enc, dec = p["encoder"], p["decoder"]
        self.conv("encoder.conv1", enc["conv1"])
        for prefix, m in (("encoder.middle", enc["mid"]),
                          ("decoder.middle", dec["mid"])):
            self.res(f"{prefix}.0", m[0])
            self.attn(f"{prefix}.1", m[1])
            self.res(f"{prefix}.2", m[2])
        self.gamma("encoder.head.0.gamma", enc["head_norm"], 3)
        self.conv("encoder.head.2", enc["head_conv"])
        self.conv("conv1", p["conv1"])
        self.conv("conv2", p["conv2"])
        self.conv("decoder.conv1", dec["conv1"])
        self.gamma("decoder.head.0.gamma", dec["head_norm"], 3)
        self.conv("decoder.head.2", dec["head_conv"])
        return dict(self)


def vae_state_dict(p, cfg):
    """A port Wan2.1 VAE tree as the reference's state dict
    (`load_wan_vae_params`' keys)."""
    from wan2gp_tpu_torch.models.wan.vae import encoder_plan, decoder_plan
    sd = _VaeSD()
    for plan, prefix, ps in (
            (encoder_plan(cfg), "encoder.downsamples", p["encoder"]["down"]),
            (decoder_plan(cfg), "decoder.upsamples", p["decoder"]["up"])):
        for j, ((op, _, _), q) in enumerate(zip(plan, ps)):
            pre = f"{prefix}.{j}"
            if op == "res":
                sd.res(pre, q)
            elif op == "attn":
                sd.attn(pre, q)
            else:
                sd.resample(pre, q)
    return sd.around_towers(p)


def flux2_vae_state_dict(p, gen):
    """A FLUX.2 VAE file's state dict from a port AE tree at 32 latent
    channels: the AE's keys, its two 1x1 quant convs (near identities) and
    the BatchNorm statistics of the 128 packed channels, which the loader
    drops."""
    from wan2gp_tpu_torch.io import flux_checkpoint as fck
    sd = fck.flux_vae_state_dict(p)
    for name, c in (("decoder.post_quant_conv", 32),
                    ("encoder.quant_conv", 64)):
        sd[f"{name}.weight"] = (torch.eye(c, device="cuda") + 0.01 * (
            torch.randn((c, c), generator=gen, device="cuda")))[:, :, None,
                                                                None]
        sd[f"{name}.bias"] = torch.zeros(c, device="cuda")
    sd["bn.running_mean"] = torch.zeros(128, device="cuda")
    sd["bn.running_var"] = torch.ones(128, device="cuda")
    sd["bn.num_batches_tracked"] = torch.zeros((), device="cuda")
    return sd


def flux_ends_state_dict(tree, cfg):
    """The BFL state dict (bf16) of a Flux tree's first and last double and
    single blocks and everything outside the blocks, under the full
    tree's key names."""
    from wan2gp_tpu_torch.io import flux_checkpoint as fck
    d, s = cfg.depth, cfg.depth_single_blocks

    def ends(x, n):
        if isinstance(x, dict):
            return {k: ends(v, n) for k, v in x.items()}
        return x[[0, n - 1]]
    two = {**tree, "double_blocks": ends(tree["double_blocks"], d),
           "single_blocks": ends(tree["single_blocks"], s)}
    out = {}
    for k, v in fck.flux_state_dict(two, dataclasses.replace(
            cfg, depth=2, depth_single_blocks=2)).items():
        for pre, n in (("double_blocks.1.", d), ("single_blocks.1.", s)):
            if k.startswith(pre):
                k = f"{pre[:-2]}{n - 1}.{k[len(pre):]}"
        out[k] = v.to(torch.bfloat16)
    return out


def vae22_state_dict(p):
    """A port Wan2.2 VAE tree as the reference's state dict
    (`load_wan22_vae_params`' keys: stage i's blocks at
    `{i}.downsamples.{j}` / `{i}.upsamples.{j}`, its resample after
    them)."""
    sd = _VaeSD()
    for prefix, inner, stages in (
            ("encoder.downsamples", "downsamples", p["encoder"]["down"]),
            ("decoder.upsamples", "upsamples", p["decoder"]["up"])):
        for i, stage in enumerate(stages):
            pre = f"{prefix}.{i}.{inner}"
            for j, r in enumerate(stage["blocks"]):
                sd.res(f"{pre}.{j}", r)
            if "resample" in stage:
                sd.resample(f"{pre}.{len(stage['blocks'])}",
                            stage["resample"])
    return sd.around_towers(p)


def leaf_checksums(tree):
    """{leaf path: a position-weighted sum of its bits}, on the card, one
    layer slice at a time: equal leaves give equal sums, and a changed
    element, or two swapped, changes it."""
    out = {}
    for path, t in _flat(tree):
        total = 0
        for part in (t if t.dim() >= 3 else [t]):
            x = part.contiguous().reshape(-1).view(torch.int16).long()
            w = torch.arange(1, x.numel() + 1, device=x.device) % 65521
            total += int((x * w).sum())
        out[path] = total
    return out


def n_lora_state_dict(cfg, seed: int = 31):
    """(N)'s LoRA on the host, in the key layout of the public
    Wan21_T2V_14B_lightx2v_cfg_step_distill_lora_rank32 file
    (diffusion_model.blocks.N.*.lora_down / lora_up + alpha): every self-
    and cross-attention q, k, v, o and ffn.0 / ffn.2 of the blocks at rank
    N_RANK (bf16, N(0, 0.02^2)), four `.diff_b` keys (dropped by the
    conversion) and a `text_embedding.0` pair (no weight of the tree:
    unmatched)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, f, r = cfg.dim, cfg.ffn_dim, N_RANK
    sd = {}

    def rnd(shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.02).to(torch.bfloat16).cpu()

    def put(path, din, dout):
        sd[f"diffusion_model.{path}.lora_down.weight"] = rnd((r, din))
        sd[f"diffusion_model.{path}.lora_up.weight"] = rnd((dout, r))
        sd[f"diffusion_model.{path}.alpha"] = torch.tensor(float(r))
    for i in range(cfg.num_layers):
        for attn in ("self_attn", "cross_attn"):
            for x in "qkvo":
                put(f"blocks.{i}.{attn}.{x}", d, d)
        put(f"blocks.{i}.ffn.0", d, f)
        put(f"blocks.{i}.ffn.2", f, d)
    put("text_embedding.0", cfg.text_dim, d)
    for i in range(4):
        sd[f"diffusion_model.blocks.{i}.self_attn.q.diff_b"] = rnd((d,))
    return sd


def bf16_ulps(got, ref):
    """|got - ref| in bf16 ulps of ref, elementwise (fp32 on the host)."""
    g, r = got.float(), ref.float()
    e = torch.floor(torch.log2(r.abs().clamp_min(1e-30)))
    return (g - r).abs() / torch.exp2(e - 7)


def run_k(out_dir, timed, split, seen):
    """(K): flux_schnell at its definition's 1280x720 and step count, at
    full width (19 double + 38 single blocks, 11.9 B parameters), from
    files.  Random weights are written under the reference key names (the
    DiT as `flux1-schnell_bf16.safetensors` in bf16, the AE and CLIP-L in
    fp32) and loaded by the service through the resolver, asked for the
    transformer, VAE and CLIP roles (the loaded DiT and AE equal the
    written tensors).  T5 v1.1 XXL (4.76 B parameters, random) encodes the
    prompt's hash ids at schnell's 256 tokens into the requests' `_context`.
    One request in bf16, then `quantize_dit_params(..., "int8")` on the same
    tree in process and one more; then a service with quantize="int4" loads
    the file again for a 2-step request.  Each request's launches are
    asserted (57 flash a forward; int8: 228 W8 and 76 fp32 W8 GEMVs; int4:
    228 W4 and 76 W4 GEMVs), none padded."""
    from wan2gp_tpu_torch.families import flux as ffam
    from wan2gp_tpu_torch.io import flux_checkpoint as fck
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
    from wan2gp_tpu_torch.models.flux import clip as fclip
    from wan2gp_tpu_torch.models.flux import dit as fdit
    from wan2gp_tpu_torch.models.flux import pipeline as fpipe
    from wan2gp_tpu_torch.models.flux import vae as fvae
    from wan2gp_tpu_torch.models.wan import t5
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils import media
    handler = ffam.FluxFamilyHandler
    prompt = "a red fox in the snow, photograph"
    out = {}
    # T5 v1.1 XXL at full size from random weights: the requests' context
    tcfg = t5.T5Config(**handler.T5_CFG_KW)
    t0 = time.perf_counter()
    tp = t5.init_t5_encoder(torch.Generator(device="cuda").manual_seed(21),
                            tcfg)
    torch.cuda.synchronize()
    out["t5_init_s"] = time.perf_counter() - t0
    out["t5_params"] = sum(v.numel() for v in _leaves(tp))
    ids, mask = ffam._tokenizer(None, tcfg.vocab_size)(
        [prompt], handler.text_seq_len("flux_schnell"))
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    t5.t5_encode(tp, tcfg, ids, mask)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = t5.t5_encode(tp, tcfg, ids, mask).float()
    torch.cuda.synchronize()
    out["t5_s"] = time.perf_counter() - t0
    if tuple(ctx.shape) != (1, K_TXT, 4096) or not torch.isfinite(ctx).all():
        raise AssertionError(f"(K) T5: {tuple(ctx.shape)}")
    del tp
    torch.cuda.empty_cache()

    ckdir = os.path.join(OUT, "ckpts")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    model_def = svc_mod.GenerationService(
        init_random_weights=True).registry.get("flux_schnell")
    if not model_def["URLs"][0].endswith("/flux1-schnell_bf16.safetensors"):
        raise AssertionError(f"(K): the definition's URLs {model_def}")
    paths = {role: os.path.join(ckdir, name) for role, name in (
        ("transformer", "flux1-schnell_bf16.safetensors"),
        ("vae", "flux_vae.safetensors"),
        ("clip", "clip_vit_large_patch14.safetensors"))}
    cfg = dataclasses.replace(handler.dit_config("flux_schnell"),
                              depth=K_DOUBLE, depth_single_blocks=K_SINGLE)
    gen = torch.Generator(device="cuda").manual_seed(22)
    t0 = time.perf_counter()
    params = fdit.init_flux(gen, cfg)
    vcfg = fvae.FluxVAEConfig()
    gen.manual_seed(23)
    vp = fvae.init_flux_vae(gen, vcfg)
    ccfg = fclip.ClipTextConfig()
    gen.manual_seed(24)
    cp = fclip.init_clip_text(gen, ccfg)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["dit_params"] = sum(v.numel() for v in _leaves(params))
    t0 = time.perf_counter()
    # a BFL file holds every tensor in bf16
    sd = {k: v.to(torch.bfloat16)
          for k, v in fck.flux_state_dict(params, cfg).items()}
    save_safetensors(paths["transformer"], sd)
    del sd
    save_safetensors(paths["vae"], fck.flux_vae_state_dict(vp))
    save_safetensors(paths["clip"], fck.clip_text_state_dict(cp, ccfg))
    out["write_s"] = time.perf_counter() - t0
    out["files_bytes"] = {os.path.basename(p): os.path.getsize(p)
                          for p in paths.values()}
    del cp
    torch.cuda.empty_cache()
    resolver = make_checkpoints_resolver(
        [ckdir], roles=("transformer", "vae", "clip"))
    svc = svc_mod.GenerationService(checkpoints_resolver=resolver,
                                    output_dir=out_dir)
    # the service's loads read the file at (K)'s depth
    arch = ffam._ARCH["flux_schnell"]
    ffam._ARCH["flux_schnell"] = {**arch, "depth": K_DOUBLE,
                                  "depth_single_blocks": K_SINGLE}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = svc.get_pipeline("flux_schnell")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    leaves = 0
    for name, got, want in (("dit", pipe.dit_params, params),
                            ("vae", pipe.vae_params, vp)):
        a, b = dict(_flat(got)), dict(_flat(want))
        if sorted(a) != sorted(b):
            raise AssertionError(f"(K) {name}: keys {sorted(set(a) ^ set(b))}")
        for k in a:
            w = b[k].to(torch.bfloat16) if name == "dit" else b[k]
            if not torch.equal(a[k], w.to(a[k].dtype)):
                raise AssertionError(f"(K) {name}{k}: not the written tensor")
        leaves += len(a)
    out["leaves_equal"] = leaves
    del params, vp, a, b
    torch.cuda.empty_cache()
    steps = svc.registry.default_settings("flux_schnell")[
        "num_inference_steps"]
    out["steps_from_definition"] = steps
    out["steps_handler_default"] = handler.default_settings(
        "flux_schnell")["num_inference_steps"]

    def request(label, per_forward, n_steps, seed):
        reset_counts()
        reset_pads()
        seen.clear()
        split.clear()
        settings = {"model_type": "flux_schnell", "prompt": prompt,
                    "seed": seed, "_context": ctx}
        if n_steps != steps:
            settings["num_inference_steps"] = n_steps
        t0 = time.perf_counter()
        got = svc.generate(settings)
        req_s = time.perf_counter() - t0
        ok = (len(got) == 1 and got[0].endswith(".png")
              and media.read_image(got[0]).shape == (K_H, K_W, 3)
              and seen and seen[0]["finite"]
              and seen[0]["shape"] == [K_H, K_W, 3]
              and media.read_image_metadata(got[0])[
                  "num_inference_steps"] == n_steps)
        if not ok:
            raise AssertionError(f"(K) {label}: {got} {seen}")
        counts = read_counts()
        want = {k: per_forward.get(k, 0) * n_steps for k in counts}
        if counts != want or read_pads():
            raise AssertionError(f"(K) {label}: launches {counts}, want "
                                 f"{want}, padded {read_pads()}")
        os.remove(got[0])
        return {"steps": n_steps, "request_s": req_s, **split,
                "step_s": split["denoise_s"] / n_steps, "launches": counts,
                "launches_per_forward": per_forward, "padded_launches": 0}

    real_denoise, real_decode = fpipe.flux_denoise, fpipe.flux_vae_decode
    fpipe.flux_denoise = timed("denoise", real_denoise)
    fpipe.flux_vae_decode = timed("decode", real_decode)
    launches = {}
    n_flash, n_mm, n_gemv = K_KERNELS
    try:
        pipe.clip_encode_fn = timed("clip", pipe.clip_encode_fn)
        out["bf16"] = request("bf16", {"flash_attention": n_flash}, steps, 5)
        t0 = time.perf_counter()
        pipe.dit_params = svc_mod.quantize_dit_params(pipe.dit_params,
                                                      "int8")
        torch.cuda.synchronize()
        out["quantize_s"] = time.perf_counter() - t0
        out["int8"] = request("int8", {"flash_attention": n_flash,
                                       "matmul_w8": n_mm,
                                       "matmul_w8_gemv": n_gemv}, steps, 5)
        svc.release_model()
        del pipe
        torch.cuda.empty_cache()
        # the service's own quantize on load: the file read again, int4
        svc = svc_mod.GenerationService(checkpoints_resolver=resolver,
                                        output_dir=out_dir, quantize="int4")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc.get_pipeline("flux_schnell")
        torch.cuda.synchronize()
        out["int4_load_s"] = time.perf_counter() - t0
        out["int4_load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["int4"] = request("int4", {"flash_attention": n_flash,
                                       "matmul_w4": n_mm,
                                       "matmul_w4_gemv": n_gemv}, STEPS, 6)
    finally:
        fpipe.flux_denoise, fpipe.flux_vae_decode = real_denoise, real_decode
        ffam._ARCH["flux_schnell"] = arch
    for mode in ("bf16", "int8", "int4"):
        for k, v in out[mode]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    svc.release_model()
    del svc
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"label": "(K) flux_schnell 1280x720 from its files: bf16, int8 "
                     "in process, int4 on load",
            "tokens": K_TOKENS, "launches": launches, **out}


# a prompt long enough that the LM keeps tokens after the video template's
# 95-token prefix (the hash tokenizer splits on whitespace), with a quoted
# text for byT5 and the glyph mapper
L_PROMPT = (
    'A small bakery on a rainy street at dusk, a shop sign that says "OPEN" '
    "glowing in warm neon above the door, people with umbrellas walking "
    "past, reflections shimmering on wet cobblestones, a cat sleeping on "
    "the windowsill, steam rising from fresh bread in the window, the "
    "camera slowly pushing in toward the sign, soft cinematic lighting, "
    "shallow depth of field, gentle film grain and a calm quiet mood")
# byT5-small's 384 rows grown by Glyph-SDXL-v2's color and font tokens (a
# stand-in size, not the released table's)
L_BYT5_VOCAB = 1510


def run_l(out_dir, timed, split, seen):
    """(L): hunyuan_1_5_480_t2v (HunyuanVideo 1.5 at L_LAYERS = 14 of its
    54 double blocks, hidden 2048, 8.3 B parameters at 54) at
    its definition's 832x480x97 from files.
    Random weights are written under the reference key names: the DiT as
    a quanto-int8 file named as the definition's second URL (the resolver
    picks it for quantization "int8"), the HV1.5 VAE (fp32), byT5-small
    with a grown vocabulary and CLIP-L (the loaded DiT tree equal to the
    written tensors).  The LLaMA-3 8B tower is random on the card and reads
    hash ids (no tokenizer files).  One request through the service at the
    definition's guidance 6.0 (CFG as batch 2; the empty negative prompt
    through the same LM) and flow_shift 5, STEPS Euler steps, the prompt's
    quoted "OPEN" through byT5, the video decoded in 15 tiles (asserted).
    Launches asserted: a flash, 8 W8 and 2 fp32 W8 GEMVs a block a forward
    (the refiner's 8 W8 and 2 GEMVs more), none padded."""
    from wan2gp_tpu_torch.families import hyvideo as hfam
    from wan2gp_tpu_torch.io import hyvideo_dit_checkpoint as hck
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.io.flux_checkpoint import clip_text_state_dict
    from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
    from wan2gp_tpu_torch.io.wan_checkpoint import hf_t5_state_dict
    from wan2gp_tpu_torch.models.flux import clip as fclip
    from wan2gp_tpu_torch.models.hyvideo import dit as hdit
    from wan2gp_tpu_torch.models.hyvideo import glyph
    from wan2gp_tpu_torch.models.hyvideo import pipeline as hpipe
    from wan2gp_tpu_torch.models.hyvideo import vae15
    from wan2gp_tpu_torch.models.qwen import text_encoder as lm
    from wan2gp_tpu_torch.models.wan import t5
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils.tokenizer import HashTokenizer
    handler = hfam.HunyuanFamilyHandler
    model_type = "hunyuan_1_5_480_t2v"
    out = {}
    ckdir = os.path.join(OUT, "ckpts")
    shutil.rmtree(ckdir, ignore_errors=True)
    model_def = svc_mod.GenerationService(
        init_random_weights=True).registry.get(model_type)
    dit_name = "hunyuan_video_1.5_480_quanto_bf16_int8.safetensors"
    if not model_def["URLs"][1].endswith("/" + dit_name):
        raise AssertionError(f"(L): the definition's URLs {model_def}")
    specs = {f["role"]: f for f in handler.query_model_files(
        "hunyuan_1_5_t2v", model_def)}
    paths = {"transformer": os.path.join(ckdir, dit_name)}
    for role in ("vae", "byt5", "clip"):
        spec = specs[role]
        os.makedirs(os.path.join(ckdir, spec.get("subdir", "")),
                    exist_ok=True)
        paths[role] = os.path.join(ckdir, spec.get("subdir", ""),
                                   os.path.basename(spec["urls"][0]))
    cfg = dataclasses.replace(handler.dit_config("hunyuan_1_5_t2v"),
                              mm_double_blocks_depth=L_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(31)
    t0 = time.perf_counter()
    params = hdit.init_hunyuan(gen, cfg)
    vcfg = vae15.Hunyuan15VAEConfig()
    gen.manual_seed(32)
    vp = vae15.init_hunyuan15_vae(gen, vcfg)
    bcfg = dataclasses.replace(glyph.BYT5_SMALL, vocab_size=L_BYT5_VOCAB)
    gen.manual_seed(33)
    bp = t5.init_t5_encoder(gen, bcfg)
    ccfg = fclip.ClipTextConfig()
    gen.manual_seed(34)
    cp = fclip.init_clip_text(gen, ccfg)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["dit_params"] = sum(v.numel() for v in _leaves(params))
    out["vae_params"] = sum(v.numel() for v in _leaves(vp))
    t0 = time.perf_counter()
    sd = hck.hunyuan_dit_state_dict(params, cfg, quanto=True)
    del params
    save_safetensors(paths["transformer"], sd)
    save_safetensors(paths["vae"], vae15.hunyuan15_vae_state_dict(vp))
    save_safetensors(paths["byt5"], hf_t5_state_dict(bp, bcfg))
    save_safetensors(paths["clip"], clip_text_state_dict(cp, ccfg))
    out["write_s"] = time.perf_counter() - t0
    out["files_bytes"] = {os.path.basename(p): os.path.getsize(p)
                          for p in paths.values()}
    del vp, bp, cp
    torch.cuda.empty_cache()
    resolver = make_checkpoints_resolver(
        [ckdir], quantization="int8",
        roles=("transformer", "vae", "byt5", "clip"))
    svc = svc_mod.GenerationService(checkpoints_resolver=resolver,
                                    output_dir=out_dir)
    arch = hfam._ARCH["hunyuan_1_5_t2v"]
    hfam._ARCH["hunyuan_1_5_t2v"] = {**arch, "mm_double_blocks_depth":
                                     L_LAYERS}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        pipe = svc.get_pipeline(model_type)
    finally:
        hfam._ARCH["hunyuan_1_5_t2v"] = arch
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the loaded DiT, exported again, is the written file's tensors
    again = hck.hunyuan_dit_state_dict(pipe.dit_params, cfg, quanto=True)
    if sorted(again) != sorted(sd):
        raise AssertionError(f"(L) dit: keys {sorted(set(again) ^ set(sd))}")
    for k, v in sd.items():
        if not torch.equal(again[k], v):
            raise AssertionError(f"(L) dit {k}: not the written tensor")
    out["tensors_equal"] = len(sd)
    del sd, again
    torch.cuda.empty_cache()
    # the LLaMA-3 8B tower, random on the card, over hash ids
    lcfg = lm.QwenLMConfig(**hfam.LM_ARCH)
    t0 = time.perf_counter()
    lp = lm.init_qwen_lm(torch.Generator(device="cuda").manual_seed(35),
                         lcfg)
    torch.cuda.synchronize()
    out["lm_init_s"] = time.perf_counter() - t0
    out["lm_params"] = sum(v.numel() for v in _leaves(lp))
    valid = []
    encode = handler.text_encoder(lp, lcfg, HashTokenizer(lcfg.vocab_size),
                                  timed("clip", pipe.clip_encode_fn))

    def text_fn(prompts):
        states, mask, pooled = encode(prompts)
        valid.append(mask.sum(1).tolist())
        return states, mask, pooled
    pipe.text_encode_fn = timed("text", text_fn)
    pipe.byt5_encode_fn = timed("byt5", pipe.byt5_encode_fn)
    pipe.vae_decode_fn = timed("decode", pipe.vae_decode_fn)
    tiles = []
    real_tile, real_denoise = vae15.hunyuan15_vae_decode, hpipe.hunyuan_denoise

    def tile(p_, c_, z):
        tiles.append(list(z.shape[2:]))
        return real_tile(p_, c_, z)
    vae15.hunyuan15_vae_decode = tile
    hpipe.hunyuan_denoise = timed("denoise", real_denoise)
    try:
        reset_counts()
        reset_pads()
        seen.clear()
        split.clear()
        t0 = time.perf_counter()
        got = svc.generate({"model_type": model_type, "prompt": L_PROMPT,
                            "negative_prompt": "", "seed": 7,
                            "num_inference_steps": STEPS})
        req_s = time.perf_counter() - t0
    finally:
        vae15.hunyuan15_vae_decode = real_tile
        hpipe.hunyuan_denoise = real_denoise
    merged = svc.registry.default_settings(model_type)
    ok = (len(got) == 1 and got[0].endswith(".avi") and seen
          and seen[0]["finite"]
          and seen[0]["shape"] == [L_FRAMES, L_H, L_W, 3]
          and len(tiles) == 15 and valid and valid[0][0] > 0
          and valid[0][1] == 0)
    if not ok:
        raise AssertionError(f"(L): {got} {seen} tiles {tiles} valid LM "
                             f"tokens {valid}")
    counts = read_counts()
    want = {k: L_KERNELS.get(k, 0) * STEPS for k in counts}
    if counts != want or read_pads():
        raise AssertionError(f"(L): launches {counts}, want {want}, padded "
                             f"{read_pads()}")
    out["request"] = {
        "steps": STEPS, "request_s": req_s, **split,
        "lm_s": split["text_s"] - split.get("clip_s", 0.0),
        "step_s": split["denoise_s"] / STEPS, "decode_tiles": len(tiles),
        "tile_latents": tiles[0], "lm_valid_tokens": valid[0],
        "byt5_tokens": len('Text "OPEN". '.encode()) + 1,
        "video_bytes": os.path.getsize(got[0])}
    os.remove(got[0])
    svc.release_model()
    del svc, pipe, lp, encode
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"label": "(L) hunyuan_1_5_480_t2v 832x480x97 from its files, "
                     "int8 (quanto file), guidance 6",
            "resolution": f"{L_W}x{L_H}", "frames": L_FRAMES,
            "guidance_scale": merged["guidance_scale"],
            "flow_shift": merged["flow_shift"],
            "definition_steps": merged["num_inference_steps"],
            "tokens": L_TOKENS, "launches": counts,
            "launches_per_forward": dict(L_KERNELS), "padded_launches": 0,
            **out}


def run_u(out_dir, timed, split, seen):
    """(U): hunyuan (HunyuanVideo 1 13B: all U_DOUBLE = 20 double and
    U_SINGLE = 40 single blocks of 3072, 24 heads of 128) at its handler's
    832x480x97 through the service, guidance 1 with embedded guidance 6
    (batch 1), flow_shift 7, STEPS of its 30 Euler steps.  The DiT random
    on the card, exported to an in-memory quanto-int8 state dict in the
    layout of the definition's second URL (every block linear int8) and
    served to the handler's loader by a `load_weights` stand-in (the disk
    has no room for its file), the loaded tree re-exported equal to it;
    the 884 VAE (fp32) and CLIP-L written as the files the handler names
    and read back through the resolver; the LLaMA-3 8B tower random on the
    card over hash ids.  The video decoded in 15 tiles of 256 pixels
    (asserted).  Launches asserted: U_KERNELS a forward (a flash a block,
    248 W8, 82 fp32 GEMVs), none padded.  Then the DiT at U_FILE_DOUBLE +
    U_FILE_SINGLE blocks written under the definition's second URL with
    the VAE and CLIP files, loaded through the resolver, the loaded tree
    equal to the written tensors."""
    from wan2gp_tpu_torch.families import hyvideo as hfam
    from wan2gp_tpu_torch.io import hyvideo_checkpoint as vck
    from wan2gp_tpu_torch.io import hyvideo_dit_checkpoint as hck
    from wan2gp_tpu_torch.io import safetensors_reader as st
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.io.flux_checkpoint import clip_text_state_dict
    from wan2gp_tpu_torch.models.flux import clip as fclip
    from wan2gp_tpu_torch.models.hyvideo import dit as hdit
    from wan2gp_tpu_torch.models.hyvideo import pipeline as hpipe
    from wan2gp_tpu_torch.models.hyvideo import vae as hvae
    from wan2gp_tpu_torch.models.qwen import text_encoder as lm
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils.tokenizer import HashTokenizer
    handler = hfam.HunyuanFamilyHandler
    model_type = "hunyuan"
    out = {}
    ckdir = os.path.join(OUT, "ckpts")
    shutil.rmtree(ckdir, ignore_errors=True)

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    model_def = svc_mod.GenerationService(
        init_random_weights=True).registry.get(model_type)
    dit_name = "hunyuan_video_720_quanto_int8.safetensors"
    if not model_def["URLs"][1].endswith("/" + dit_name):
        raise AssertionError(f"(U): the definition's URLs {model_def}")
    specs = {f["role"]: f for f in handler.query_model_files(model_type,
                                                              model_def)}
    paths = {}
    for role in ("vae", "clip"):
        spec = specs[role]
        os.makedirs(os.path.join(ckdir, spec.get("subdir", "")),
                    exist_ok=True)
        paths[role] = os.path.join(ckdir, spec.get("subdir", ""),
                                   os.path.basename(spec["urls"][0]))
    if os.path.basename(paths["vae"]) != "hunyuan_video_VAE_fp32.safetensors":
        raise AssertionError(f"(U): the VAE file {paths['vae']}")
    cfg = handler.dit_config(model_type)
    if (cfg.mm_double_blocks_depth, cfg.mm_single_blocks_depth,
            cfg.hidden_size) != (U_DOUBLE, U_SINGLE, 3072):
        raise AssertionError(f"(U): the row's config {cfg}")
    gen = torch.Generator(device="cuda").manual_seed(61)
    # 1. the DiT: random, a quanto-int8 state dict on the card
    t0 = time.perf_counter()
    params = hdit.init_hunyuan(gen, cfg)
    out["init_s"] = sync_s(t0)
    out["dit_params"] = sum(v.numel() for v in _leaves(params))
    t0 = time.perf_counter()
    sd = hck.hunyuan_dit_state_dict(params, cfg, quanto=True)
    out["export_s"] = sync_s(t0)
    del params
    torch.cuda.empty_cache()
    out["state_dict_gb"] = sum(v.numel() * v.element_size()
                               for v in sd.values()) / 1e9
    # 2. the VAE (fp32) and CLIP-L as files
    vcfg = hvae.HunyuanVAEConfig()
    gen.manual_seed(62)
    vp = hvae.init_hunyuan_vae(gen, vcfg)
    ccfg = fclip.ClipTextConfig()
    gen.manual_seed(63)
    cp = fclip.init_clip_text(gen, ccfg)
    out["vae_params"] = sum(v.numel() for v in _leaves(vp))
    t0 = time.perf_counter()
    vae_sd = vck.hunyuan_vae_state_dict(vp)
    st.save_safetensors(paths["vae"], vae_sd)
    st.save_safetensors(paths["clip"], clip_text_state_dict(cp, ccfg))
    out["write_s"] = sync_s(t0)
    out["files_bytes"] = {os.path.basename(p_): os.path.getsize(p_)
                          for p_ in paths.values()}
    del vp, cp
    # 3. the service loads the three roles
    mem = {"memory:transformer": sd}

    def resolver(model_type_, handler_, base, model_def_):
        return {"transformer": "memory:transformer", **paths}
    real_load = st.load_weights
    st.load_weights = lambda path: mem[path] if path in mem \
        else real_load(path)
    svc = svc_mod.GenerationService(checkpoints_resolver=resolver,
                                    output_dir=out_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        pipe = svc.get_pipeline(model_type)
    finally:
        st.load_weights = real_load
    out["load_s"] = sync_s(t0)
    out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    again = hck.hunyuan_dit_state_dict(pipe.dit_params, cfg, quanto=True)
    if sorted(again) != sorted(sd) or any(
            not torch.equal(again[k], v) for k, v in sd.items()):
        raise AssertionError("(U) dit: the loaded tree is not the state dict")
    out["tensors_equal"] = len(sd)
    del sd, again, mem
    back = vck.hunyuan_vae_state_dict(
        vck.load_hunyuan_vae_params(real_load(paths["vae"]), vcfg,
                                    device="cuda")[0])
    if any(not torch.equal(back[k], v) for k, v in vae_sd.items()):
        raise AssertionError("(U) VAE: the file read back differs")
    del back, vae_sd
    torch.cuda.empty_cache()
    # 4. the LLaMA-3 8B tower, random on the card, over hash ids
    lcfg = lm.QwenLMConfig(**hfam.LM_ARCH)
    t0 = time.perf_counter()
    lp = lm.init_qwen_lm(torch.Generator(device="cuda").manual_seed(64),
                         lcfg)
    out["lm_init_s"] = sync_s(t0)
    out["lm_params"] = sum(v.numel() for v in _leaves(lp))
    valid = []
    encode = handler.text_encoder(lp, lcfg, HashTokenizer(lcfg.vocab_size),
                                  timed("clip", pipe.clip_encode_fn))

    def text_fn(prompts):
        states, mask, pooled = encode(prompts)
        valid.append(mask.sum(1).tolist())
        return states, mask, pooled
    pipe.text_encode_fn = timed("text", text_fn)
    pipe.vae_decode_fn = timed("decode", pipe.vae_decode_fn)
    tiles = []
    real_tile, real_denoise = hvae.hunyuan_vae_decode, hpipe.hunyuan_denoise

    def tile(p_, c_, z):
        tiles.append(list(z.shape[2:]))
        return real_tile(p_, c_, z)
    hvae.hunyuan_vae_decode = tile
    hpipe.hunyuan_denoise = timed("denoise", real_denoise)
    try:
        reset_counts()
        reset_pads()
        seen.clear()
        split.clear()
        t0 = time.perf_counter()
        got = svc.generate({"model_type": model_type, "prompt": U_PROMPT,
                            "seed": 7, "num_inference_steps": STEPS})
        req_s = time.perf_counter() - t0
    finally:
        hvae.hunyuan_vae_decode = real_tile
        hpipe.hunyuan_denoise = real_denoise
    merged = svc.registry.default_settings(model_type)
    ok = (len(got) == 1 and got[0].endswith(".avi") and seen
          and seen[0]["finite"]
          and seen[0]["shape"] == [U_FRAMES, U_H, U_W, 3]
          and len(tiles) == 15 and valid == [[valid[0][0]]]
          and valid[0][0] > 0)
    if not ok:
        raise AssertionError(f"(U): {got} {seen} tiles {tiles} valid LM "
                             f"tokens {valid}")
    counts = read_counts()
    want = {k: U_KERNELS.get(k, 0) * STEPS for k in counts}
    if counts != want or read_pads():
        raise AssertionError(f"(U): launches {counts}, want {want}, padded "
                             f"{read_pads()}")
    out["request"] = {
        "steps": STEPS, "request_s": req_s, **split,
        "lm_s": split["text_s"] - split.get("clip_s", 0.0),
        "step_s": split["denoise_s"] / STEPS, "decode_tiles": len(tiles),
        "tile_latents": tiles[0], "lm_valid_tokens": valid[0],
        "video_bytes": os.path.getsize(got[0])}
    os.remove(got[0])
    svc.release_model()
    del svc, pipe, lp, encode
    torch.cuda.empty_cache()
    # 5. the DiT as a file at U_FILE_DOUBLE + U_FILE_SINGLE blocks, loaded
    # with the VAE and CLIP files through the resolver
    fcfg = dataclasses.replace(cfg, mm_double_blocks_depth=U_FILE_DOUBLE,
                               mm_single_blocks_depth=U_FILE_SINGLE)
    gen.manual_seed(65)
    t0 = time.perf_counter()
    fsd = hck.hunyuan_dit_state_dict(hdit.init_hunyuan(gen, fcfg), fcfg,
                                     quanto=True)
    dit_path = os.path.join(ckdir, dit_name)
    st.save_safetensors(dit_path, fsd)
    out["file_write_s"] = sync_s(t0)
    out["file_bytes"] = os.path.getsize(dit_path)
    arch = hfam._ARCH[model_type]
    hfam._ARCH[model_type] = {**arch,
                              "mm_double_blocks_depth": U_FILE_DOUBLE,
                              "mm_single_blocks_depth": U_FILE_SINGLE}
    svc = svc_mod.GenerationService(
        checkpoints_resolver=make_checkpoints_resolver(
            [ckdir], quantization="int8",
            roles=("transformer", "vae", "clip")), output_dir=out_dir)
    t0 = time.perf_counter()
    try:
        pipe = svc.get_pipeline(model_type)
    finally:
        hfam._ARCH[model_type] = arch
    out["file_load_s"] = sync_s(t0)
    again = hck.hunyuan_dit_state_dict(pipe.dit_params, fcfg, quanto=True)
    if sorted(again) != sorted(fsd) or any(
            not torch.equal(again[k], v) for k, v in fsd.items()):
        raise AssertionError("(U) dit file: not the written tensors")
    out["file_tensors_equal"] = len(fsd)
    svc.release_model()
    del svc, pipe, fsd, again
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"label": "(U) hunyuan (HunyuanVideo 1 13B) 832x480x97, all "
                     "20 + 40 blocks, int8 (quanto state dict), guidance 1 "
                     "with embedded guidance 6",
            "resolution": f"{U_W}x{U_H}", "frames": U_FRAMES,
            "guidance_scale": merged["guidance_scale"],
            "embedded_guidance_scale": merged["embedded_guidance_scale"],
            "flow_shift": merged["flow_shift"],
            "definition_steps": merged["num_inference_steps"],
            "tokens": U_TOKENS, "image_tokens": U_IMG, "launches": counts,
            "launches_per_forward": dict(U_KERNELS), "padded_launches": 0,
            **out}


def run_v(out_dir, timed, split, seen):
    """(V): the other HunyuanVideo rows from random weights on the card at
    (T)'s depth (HV1: V_HV1 = 2 double + 4 single blocks; HV1.5: V_HV15 =
    4 double blocks), bf16, latents out (no decode), STEPS Euler steps each
    (the upsampler: 4 meanflow steps): `hunyuan_i2v` (latent_concat, 33
    channels) and `hunyuan_1_5_480_i2v` (latent_concat, 65 channels, CFG
    at 6), each from an 832x480 PNG through its own VAE's encode;
    `hunyuan_custom` with the PNG as its reference (CFG at 7.5);
    `hunyuan_avatar` through `generate_custom` with the PNG's latents on
    every frame, random Whisper-tiny window features, a face box, motion
    and fps (CFG at 7.5); `hunyuan_1_5_upsampler` at 1280x704 from random
    low-resolution latents through SR720 (full width, random).  Each row's
    flash launches asserted (one a block a forward)."""
    from wan2gp_tpu_torch.families import hyvideo as hfam
    from wan2gp_tpu_torch.models.hyvideo import custom as hcustom
    from wan2gp_tpu_torch.models.hyvideo.pipeline import \
        HunyuanSamplingConfig
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils import media
    png = os.path.join(OUT, "hv_image.png")
    yy, xx = np.meshgrid(np.linspace(0, 1, U_H), np.linspace(0, 1, U_W),
                         indexing="ij")
    media.save_image((np.stack([xx, yy, 1 - xx * yy], -1) * 2 - 1)
                     .astype(np.float32), png)
    rows = (("hunyuan_i2v", "hunyuan_i2v"),
            ("hunyuan_1_5_480_i2v", "hunyuan_1_5_i2v"),
            ("hunyuan_custom", "hunyuan_custom"),
            ("hunyuan_avatar", "hunyuan_avatar"),
            ("hunyuan_1_5_upsampler", "hunyuan_1_5_upsampler"))
    out = {}
    for model_type, base in rows:
        hv15 = hfam.is_hv15(base)
        arch = hfam._ARCH[base]
        depth = ({"mm_double_blocks_depth": V_HV15} if hv15 else
                 {"mm_double_blocks_depth": V_HV1[0],
                  "mm_single_blocks_depth": V_HV1[1]})
        hfam._ARCH[base] = {**arch, **depth}
        try:
            svc = svc_mod.GenerationService(init_random_weights=True,
                                            output_dir=out_dir)
            t0 = time.perf_counter()
            pipe = svc.get_pipeline(model_type)
            torch.cuda.synchronize()
            rec = {"init_s": time.perf_counter() - t0}
        finally:
            hfam._ARCH[base] = arch
        merged = svc.registry.default_settings(model_type)
        steps = 4 if base == "hunyuan_1_5_upsampler" else STEPS
        sampling = HunyuanSamplingConfig(
            steps=steps, shift=float(merged["flow_shift"]),
            guide_scale=float(merged.get("guidance_scale", 1.0)),
            embedded_guidance=float(merged["embedded_guidance_scale"]))
        kw = hfam._text_kwargs(pipe, merged, sampling.guide_scale != 1.0)
        common = dict(width=U_W, height=U_H, frame_num=U_FRAMES, seed=3,
                      sampling=sampling, return_latents=True, **kw)
        split.clear()
        encode = timed("encode", lambda: hfam._encode_image(pipe, png, U_W,
                                                            U_H))
        reset_counts()
        reset_pads()
        t0 = time.perf_counter()
        if "i2v" in base:
            img = encode()
            rec["image_latents"] = list(img.shape)
            lat = pipe.generate(img_latents=img,
                                i2v_condition_type="latent_concat", **common)
        elif base == "hunyuan_custom":
            ref = encode()
            rec["ref_latents"] = list(ref.shape)
            lat = pipe.generate_custom(ref_latents=ref, **common)
        elif base == "hunyuan_avatar":
            ref = encode()
            f_lat = (U_FRAMES - 1) // 4 + 1
            ref = ref.expand(-1, -1, f_lat, -1, -1).contiguous()
            gen = torch.Generator().manual_seed(5)
            feats = hcustom.window_audio_features(
                torch.randn((2 * U_FRAMES + 10, 5, 384),
                            generator=gen).numpy(), U_FRAMES)
            face = np.zeros((U_H, U_W), np.float32)
            face[U_H // 4:3 * U_H // 4, U_W // 3:2 * U_W // 3] = 1.0
            rec["ref_latents"] = list(ref.shape)
            rec["audio_windows"] = list(feats.shape)
            lat = pipe.generate_custom(
                ref_latents=ref, audio_prompts=torch.from_numpy(feats),
                face_mask=face, motion_exp=torch.full((1, 4), 5.0),
                motion_pose=torch.full((1, 4), 2.0), fps_value=25.0,
                **common)
        else:
            u_w, u_h = 1280, 704
            lq = torch.randn((1, 32, (U_FRAMES - 1) // 4 + 1, u_h // 16,
                              u_w // 16), generator=torch.Generator(
                                  device="cuda").manual_seed(6),
                             device="cuda")
            lat = pipe.generate_upsample(
                lq, sr_params=pipe.sr_params, sr_cfg=pipe.sr_cfg, seed=3,
                sampling=sampling, text_states=kw["text_states"],
                text_mask=kw["text_mask"])
            rec["sr"] = type(pipe.sr_cfg).__name__
        torch.cuda.synchronize()
        rec["run_s"] = time.perf_counter() - t0
        rec.update(split)
        counts = read_counts()
        per = (V_HV15 if hv15 else sum(V_HV1))
        want = {k: (per * steps if k == "flash_attention" else 0)
                for k in counts}
        rec.update(latents=list(lat.shape), steps=steps,
                   guidance_scale=sampling.guide_scale,
                   finite=bool(torch.isfinite(lat).all()), launches=counts)
        if counts != want or read_pads() or not rec["finite"]:
            raise AssertionError(f"(V) {model_type}: {rec}, want launches "
                                 f"{want}, padded {read_pads()}")
        out[model_type] = rec
        svc.release_model()
        del svc, pipe, lat
        torch.cuda.empty_cache()
    os.remove(png)
    return {"label": "(V) the other HunyuanVideo rows from random weights, "
                     f"HV1 at {V_HV1[0]} + {V_HV1[1]} blocks, HV1.5 at "
                     f"{V_HV15}, latents out",
            "resolution": f"{U_W}x{U_H}", "frames": U_FRAMES, **out}


def run_m(out_dir, timed, split, seen):
    """(M): ltx2_22B_distilled (LTX-2 22B at M_LAYERS = 12 of its 48
    blocks, 19.5 B parameters in the DiT at 48) at
    1280x704x241 (the definition's 1280x720 gives 22.5 latent rows; the
    handler refuses it): 31 x 22 x 40 = 27,280 video and 251 audio
    tokens.  Gemma-3 12B random on the card, through an
    in-memory HF state dict and `load_gemma3_params` at full depth, encodes
    the prompt's bytes through a random caption projection (per-token RMS,
    the 22B's) and is freed; the DiT random on the card, exported to an
    in-memory quanto-int8 state dict (every linear, the top-level ones too)
    and read back by `load_ltx2_params` (the loaded tree re-exported equals
    it); the 22B video VAE, the audio VAE and the vocoder random.  One
    request through the service: the definition's guidance 1, 2 of its 8
    distilled steps, the untiled decode, the audio decode and vocoder, an
    AVI with its stereo stream at 24 kHz (asserted).  Launches asserted:
    6 flash and 34 W8 a block (4 W8 more), 22 fp32 W8 above 16 rows and 6
    fp32 GEMVs a forward, none padded.  Then the DiT at M_FILE_LAYERS
    blocks (quanto int8, under the definition's second URL), the video VAE
    (bf16), the audio VAE, the vocoder and the caption projection (bf16)
    as files,
    loaded through the service's resolver and held to the written tensors
    bit for bit."""
    from wan2gp_tpu_torch.families import ltx2 as lfam
    from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
    from wan2gp_tpu_torch.io.ltx2_checkpoint import (load_ltx2_params,
                                                     ltx2_state_dict)
    from wan2gp_tpu_torch.io.safetensors_reader import (load_weights,
                                                        save_safetensors)
    from wan2gp_tpu_torch.models.ltx2 import audio_vae as lav
    from wan2gp_tpu_torch.models.ltx2 import dit as ld
    from wan2gp_tpu_torch.models.ltx2 import gemma as lg
    from wan2gp_tpu_torch.models.ltx2 import pipeline as lp
    from wan2gp_tpu_torch.models.ltx2 import vae as lv
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils import media
    handler = lfam.LTX2FamilyHandler
    model_type = "ltx2_22B_distilled"
    bf16 = torch.bfloat16
    out = {}
    svc = svc_mod.GenerationService(init_random_weights=True,
                                    output_dir=out_dir)
    model_def = svc.registry.get(model_type)
    merged = svc.registry.default_settings(model_type)
    if (merged["resolution"], merged["video_length"],
            merged["num_inference_steps"], merged["guidance_scale"]) != (
            "1280x720", M_FRAMES, 8, 1.0):
        raise AssertionError(f"(M): the definition's settings {merged}")
    ckdir = os.path.join(OUT, "ckpts")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    specs = {f["role"]: f["urls"] for f in handler.query_model_files(
        "ltx2_22B", model_def)}
    paths = {role: os.path.join(ckdir, os.path.basename(urls[0]))
             for role, urls in specs.items()}
    paths["transformer"] = os.path.join(
        ckdir, os.path.basename(specs["transformer"][1]))
    if "quanto_int8" not in paths["transformer"]:
        raise AssertionError(f"(M): the definition's URLs {specs}")
    written = {}

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # 1. Gemma-3 12B, random on the card, through its loader; the prompt
    gcfg = lg.Gemma3Config()
    gen = torch.Generator(device="cuda").manual_seed(41)
    t0 = time.perf_counter()
    gp = lg.init_gemma3(gen, gcfg)
    out["gemma_init_s"] = sync_s(t0)
    out["gemma_params"] = sum(v.numel() for v in _leaves(gp))
    t0 = time.perf_counter()
    sd = lg.gemma3_state_dict(gp, gcfg)
    del gp
    gp, left = lg.load_gemma3_params(sd, gcfg, device="cuda")
    del sd
    out["gemma_export_load_s"] = sync_s(t0)
    if left:
        raise AssertionError(f"(M) gemma: left over {left[:4]}")
    d_in = gcfg.dim * (gcfg.n_layers + 1)
    proj_w = torch.randn((d_in, 3840), generator=gen,
                         device="cuda").div_(math.sqrt(d_in))
    written["text_projection"] = {
        "aggregate_embed.weight": proj_w.t().to(bf16).contiguous()}
    proj_w = written["text_projection"]["aggregate_embed.weight"].float().t()
    encode = lg.make_caption_encoder(gp, gcfg, proj_w,
                                     handler.caption_mode("ltx2_22B"),
                                     device="cuda")
    encode([M_PROMPT])                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx, cmask = encode([M_PROMPT])
    out["encode_s"] = sync_s(t0)
    out["encode_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n_txt = len(M_PROMPT.encode())
    if tuple(ctx.shape) != (1, n_txt, 3840) or not bool(
            torch.isfinite(ctx).all()) or int(cmask.sum()) != n_txt:
        raise AssertionError(f"(M) encode: {tuple(ctx.shape)}")
    del gp, proj_w, encode
    torch.cuda.empty_cache()
    # 2. the DiT: random, a quanto-int8 state dict in memory, the loader
    cfg = dataclasses.replace(handler.dit_config("ltx2_22B"),
                              num_layers=M_LAYERS)
    gen.manual_seed(43)
    t0 = time.perf_counter()
    params = ld.init_ltx2_dit(gen, cfg)
    out["init_s"] = sync_s(t0)
    out["dit_params"] = sum(v.numel() for v in _leaves(params))
    t0 = time.perf_counter()
    sd = ltx2_state_dict(params, cfg, quanto=True)
    out["export_s"] = sync_s(t0)
    del params
    out["state_dict_gb"] = sum(v.numel() * v.element_size()
                               for v in sd.values()) / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dp, left = load_ltx2_params(sd, cfg, device="cuda")
    out["load_s"] = sync_s(t0)
    out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if left:
        raise AssertionError(f"(M) dit: left over {left[:4]}")
    again = ltx2_state_dict(dp, cfg, quanto=True)
    if sorted(again) != sorted(sd) or any(
            not torch.equal(again[k], v.to(again[k].dtype))
            for k, v in sd.items()):
        raise AssertionError("(M) dit: the loaded tree is not the state dict")
    out["tensors_equal"] = len(sd)
    del sd, again
    torch.cuda.empty_cache()
    # 3. the decoders, random on the card
    vcfg = handler.vae_config("ltx2_22B")
    acfg, wcfg = lav.LTX2AudioVAEConfig(), lav.LTX2VocoderConfig()
    gen.manual_seed(44)
    vp = lv.init_ltx2_vae(gen, vcfg)
    ap = lav.init_ltx2_audio_vae(gen, acfg)
    wp = lav.init_ltx2_vocoder(gen, wcfg)
    out["vae_params"] = sum(v.numel() for v in _leaves(vp))
    written["video_vae"] = {k: v.to(bf16) for k, v in
                            lv.ltx2_vae_state_dict(vp, vcfg).items()}
    written["audio_vae"] = lav.ltx2_audio_vae_state_dict(ap, acfg)
    written["vocoder"] = lav.ltx2_vocoder_state_dict(wp, wcfg)
    vp = lv.load_ltx2_vae_params(written["video_vae"], vcfg,
                                 device="cuda")[0]
    pipe = lp.LTX2Pipeline(
        dp, cfg,
        vae_decode=timed("decode", lambda z: lv.ltx2_vae_decode(vp, vcfg, z)),
        audio_decode=timed("audio_decode",
                           lambda z: lav.ltx2_audio_decode(ap, acfg, z)),
        vocoder=timed("vocoder", lambda m: lav.ltx2_vocoder(wp, wcfg, m)),
        device="cuda")
    pipe.distilled = True
    svc._pipelines[model_type] = pipe
    audio = []
    real_denoise, real_save = lp.ltx2_denoise, media.save_video

    def save_with_audio(frames_, path, **kw):
        audio.append((kw.get("audio").shape, kw.get("audio_sample_rate")))
        return real_save(frames_, path, **kw)
    lp.ltx2_denoise = timed("denoise", real_denoise)
    media.save_video = save_with_audio
    try:
        reset_counts()
        reset_pads()
        seen.clear()
        split.clear()
        t0 = time.perf_counter()
        got = svc.generate({"model_type": model_type, "prompt": M_PROMPT,
                            "resolution": f"{M_W}x{M_H}", "seed": 7,
                            "num_inference_steps": STEPS,
                            "_text_context": ctx})
        req_s = time.perf_counter() - t0
    finally:
        lp.ltx2_denoise, media.save_video = real_denoise, real_save
    counts = read_counts()
    want = {k: M_KERNELS.get(k, 0) * STEPS for k in counts}
    if counts != want or read_pads():
        raise AssertionError(f"(M): launches {counts}, want {want}, padded "
                             f"{read_pads()}")
    samples = (4 * M_AUDIO - 3) * wcfg.hop
    pcm, rate = media.read_avi_audio(got[0])
    ok = (len(got) == 1 and seen and seen[-1]["finite"]
          and seen[-1]["shape"] == [M_FRAMES, M_H, M_W, 3]
          and audio == [((2, samples), 24000)] and rate == 24000
          and pcm.shape == (samples, 2))
    if not ok:
        raise AssertionError(f"(M): {got} {seen} audio {audio} {rate} "
                             f"{pcm.shape}")
    out["request"] = {
        "steps": STEPS, "request_s": req_s, **split,
        "step_s": split["denoise_s"] / STEPS,
        "audio_s": split["audio_decode_s"] + split["vocoder_s"],
        "video_bytes": os.path.getsize(got[0]), "audio_samples": samples,
        "audio_rate": rate}
    os.remove(got[0])
    svc.release_model()
    del svc, pipe, dp, vp, ap, wp, ctx
    torch.cuda.empty_cache()
    # 4. the files, at M_FILE_LAYERS blocks, through the resolver
    cfg2 = dataclasses.replace(cfg, num_layers=M_FILE_LAYERS)
    gen.manual_seed(45)
    p2 = ld.init_ltx2_dit(gen, cfg2)
    written["transformer"] = ltx2_state_dict(p2, cfg2, quanto=True)
    del p2
    t0 = time.perf_counter()
    for role, sd in written.items():
        save_safetensors(paths[role], sd)
    out["write_s"] = time.perf_counter() - t0
    out["files_bytes"] = {os.path.basename(paths[r]): os.path.getsize(
        paths[r]) for r in written}
    resolver = make_checkpoints_resolver(
        [ckdir], quantization="int8",
        roles=("transformer", "video_vae", "audio_vae", "vocoder"))
    svc = svc_mod.GenerationService(checkpoints_resolver=resolver,
                                    output_dir=out_dir)
    arch = lfam._ARCH["ltx2_22B"]
    lfam._ARCH["ltx2_22B"] = {**arch, "num_layers": M_FILE_LAYERS}
    try:
        t0 = time.perf_counter()
        pipe = svc.get_pipeline(model_type)
        out["read_s"] = sync_s(t0)
    finally:
        lfam._ARCH["ltx2_22B"] = arch
    proj = lfam.load_text_projection(load_weights(paths["text_projection"]),
                                     device="cuda")
    back = {"transformer": ltx2_state_dict(pipe.dit_params, cfg2,
                                           quanto=True),
            "video_vae": lv.ltx2_vae_state_dict(pipe.vae_params, vcfg),
            "audio_vae": lav.ltx2_audio_vae_state_dict(pipe.audio_vae_params,
                                                       acfg),
            "vocoder": lav.ltx2_vocoder_state_dict(pipe.vocoder_params, wcfg),
            "text_projection": {"aggregate_embed.weight": proj.t()}}
    for role, sd in written.items():
        if sorted(back[role]) != sorted(sd) or any(
                not torch.equal(back[role][k], v.to(back[role][k].dtype))
                for k, v in sd.items()):
            raise AssertionError(f"(M) {role}: read back differs")
    out["files_equal"] = {r: len(sd) for r, sd in written.items()}
    svc.release_model()
    del svc, pipe, written, back, proj
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"label": "(M) ltx2_22B_distilled 1280x704x241, int8 (quanto "
                     "state dict), guidance 1, audio on",
            "resolution": f"{M_W}x{M_H}", "frames": M_FRAMES,
            "latent_grid": list(M_GRID), "video_tokens": M_TOKENS,
            "audio_tokens": M_AUDIO, "text_tokens": n_txt,
            "guidance_scale": merged["guidance_scale"],
            "definition_steps": merged["num_inference_steps"],
            "file_layers": M_FILE_LAYERS, "launches": counts,
            "launches_per_forward": dict(M_KERNELS), "padded_launches": 0,
            **out}


def phase_service(frames: int):
    """The main paths through GenerationService on cuda, each with the
    launch counters reset just before its requests and read just after."""
    from wan2gp_tpu_torch.families import wan as fam
    from wan2gp_tpu_torch.models.krea2 import pipeline as krea2_pipe
    from wan2gp_tpu_torch.models.qwen import pipeline as qwen_pipe
    from wan2gp_tpu_torch.models.wan import pipeline as pipe_mod
    from wan2gp_tpu_torch.models.zimage import pipeline as zimage_pipe
    from wan2gp_tpu_torch.models.wan.pipeline import WanPipeline
    from wan2gp_tpu_torch.ops import quant as Q
    from wan2gp_tpu_torch.runtime import service as svc_mod
    from wan2gp_tpu_torch.utils import media

    # the service writes uint8 frames / pixels; check the floats before that
    seen = []
    real_save, real_save_image = media.save_video, media.save_image

    def save_checked(frames_, path, **kw):
        seen.append({"shape": list(frames_.shape),
                     "finite": bool(np.isfinite(frames_).all())})
        return real_save(frames_, path, **kw)

    def save_image_checked(img, path, **kw):
        seen.append({"shape": list(img.shape),
                     "finite": bool(np.isfinite(img).all())})
        return real_save_image(img, path, **kw)

    # wall-clock split and peak device memory of each request
    split = {}

    def timed(name, fn):
        """Seconds and peak of each call, summed and maxed over the calls
        of one request (a sliding-window request makes one a window)."""
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            split[name + "_s"] = (split.get(name + "_s", 0.0)
                                  + time.perf_counter() - t0)
            split[name + "_peak_gb"] = max(
                split.get(name + "_peak_gb", 0.0),
                torch.cuda.max_memory_allocated() / 1e9)
            return r
        return wrapper

    media.save_video, media.save_image = save_checked, save_image_checked
    real_forward = record_forwards()
    real_denoise, real_decode = WanPipeline.denoise, WanPipeline.decode
    real_encode, real_clip = (WanPipeline.encode_video,
                              pipe_mod.clip_vision_encode)
    real_multitalk = pipe_mod.multitalk_denoise
    real_krea2_denoise = krea2_pipe.krea2_denoise
    real_qwen_denoise = qwen_pipe.qwen_denoise
    real_zimage_denoise = zimage_pipe.zimage_denoise
    WanPipeline.denoise = timed("denoise", real_denoise)
    WanPipeline.decode = timed("decode", real_decode)
    WanPipeline.encode_video = timed("encode", real_encode)
    pipe_mod.clip_vision_encode = timed("clip", real_clip)
    pipe_mod.multitalk_denoise = timed("denoise", real_multitalk)
    krea2_pipe.krea2_denoise = timed("denoise", real_krea2_denoise)
    qwen_pipe.qwen_denoise = timed("denoise", real_qwen_denoise)
    zimage_pipe.zimage_denoise = timed("denoise", real_zimage_denoise)
    out_dir = os.path.join(OUT, "outputs")

    def run(label, model_type, quantize, attention, n_req, w, h, layers,
            per_forward, after=None, settings=None):
        """n_req requests; per_forward: the launches one DiT forward must
        make, by kernel (the others must make none).  after(svc): more
        work on the loaded pipeline before it is released.  settings: more
        keys of each request."""
        arch = fam._ARCH[model_type]
        fam._ARCH[model_type] = {**arch, "num_layers": layers}
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir,
                                        quantize=quantize)
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            svc.get_pipeline(model_type)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            load_peak = torch.cuda.max_memory_allocated() / 1e9
        finally:
            fam._ARCH[model_type] = arch
        reset_counts()
        reset_pads()
        reqs = []
        for i in range(n_req):
            seen.clear()
            split.clear()
            t0 = time.perf_counter()
            paths = svc.generate({
                "model_type": model_type, "prompt": f"a red fox {i}",
                "resolution": f"{w}x{h}", "video_length": frames,
                "num_inference_steps": STEPS, "guidance_scale": 5.0,
                "sample_solver": "unipc", "seed": i,
                "attention_mode": attention, **(settings or {})})
            req_s = time.perf_counter() - t0
            ok = (len(paths) == 1 and os.path.getsize(paths[0]) > 0
                  and seen and seen[0]["finite"]
                  and seen[0]["shape"] == [frames, h, w, 3])
            if not ok:
                raise AssertionError(f"{label} request {i}: {paths} {seen}")
            reqs.append({"request_s": req_s, **split,
                         "step_s": split["denoise_s"] / STEPS,
                         "bytes": os.path.getsize(paths[0])})
            os.remove(paths[0])             # frames are stored uncompressed
        counts = read_counts()
        want = {name: per_forward.get(name, 0) * STEPS * n_req
                for name in counts}
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        padded = read_pads()
        if padded:
            raise AssertionError(f"{label}: {padded} launches padded or "
                                 f"copied their operands")
        extra = after(svc) if after else None
        svc.release_model()
        del svc
        torch.cuda.empty_cache()
        return {"model": model_type, "resolution": f"{w}x{h}",
                "quantize": quantize or "bf16", "attention": attention,
                "layers": layers, "requests": reqs, "load_s": load_s,
                "load_peak_gb": load_peak, "launches": counts,
                "launches_per_forward": per_forward, "padded_launches": 0,
                **({"then": extra} if extra else {})}

    def run_c(svc):
        """(C), the JAX package's bench default, on the pipeline loaded
        for (A): sequential CFG (two batch-1 forwards a step), TeaCache at
        1.75x, bf16 residuals, guidance 5.0, through WanPipeline.generate
        (no service setting selects sequential CFG or the residual dtype,
        in either package)."""
        from wan2gp_tpu_torch.models.wan.pipeline import SamplingConfig
        from wan2gp_tpu_torch.schedulers import make_schedule
        pipe = svc.get_pipeline("t2v")
        cfg0 = pipe.dit_cfg
        pipe.dit_cfg = dataclasses.replace(cfg0,
                                           residual_dtype=torch.bfloat16)
        base = dict(solver="unipc", steps=C_STEPS, shift=5.0,
                    guide_scale=5.0, joint_pass=False, host_loop=True,
                    cache_type="tea", cache_speed_factor=1.75)
        sched = make_schedule("unipc", C_STEPS, 5.0)
        auto = pipe.skip_schedule(SamplingConfig(**base), sched, 1280, 720)
        thresh, rel = tea_threshold(pipe, sched, 1.75, 1280 * 720)
        sampling = SamplingConfig(**base, cache_threshold=thresh)
        plan = pipe.skip_schedule(sampling, sched, 1280, 720)
        if plan.all():
            raise AssertionError(f"(C): the TeaCache plan {plan} skips "
                                 "no step")
        per_forward = dict(A_KERNELS)
        try:
            out = recorded_request(
                "(C)", lambda: pipe.generate(
                    "a red fox", width=1280, height=720, frame_num=frames,
                    sampling=sampling, seed=0),
                np.repeat(plan, 2), per_forward, {}, frames, 720, 1280)
        finally:
            pipe.dit_cfg = cfg0
        return {"label": "(C) 14B 720p int4a8 + Sol, sequential CFG, "
                         "TeaCache, bf16 residuals", "steps": C_STEPS,
                "solver": "unipc", "guidance_scale": 5.0,
                "teacache_auto_plan": auto.astype(int).tolist(),
                "teacache_rel_l1": rel.tolist(),
                "teacache_threshold": thresh, "plan": plan.astype(int)
                .tolist(), "launches_per_calc_forward": per_forward, **out}

    def recorded_request(label, fn, calc_flags, per_calc, per_skip, n_frames,
                         h, w, keep=False):
        """Runs fn (a request) with every DiT forward recorded; checks each
        forward's launches against per_calc / per_skip by its calc flag,
        the flags against calc_flags (None: the data decided them), the
        total against the counters, and the frames.  keep: leave the
        service's output file (its path is returned as "path")."""
        reset_counts()
        seen.clear()
        split.clear()
        FORWARDS.clear()
        FORWARDS.append([])
        t0 = time.perf_counter()
        try:
            video = fn()
        finally:
            fw = FORWARDS.pop()
        req_s = time.perf_counter() - t0
        counts = read_counts()
        flags = [f["calc"] for f in fw]
        if calc_flags is not None and flags != [bool(c) for c in calc_flags]:
            raise AssertionError(f"{label}: forwards {flags}, plan "
                                 f"{list(calc_flags)}")
        for i, f in enumerate(fw):
            want = {k: v for k, v in (per_calc if f["calc"]
                                      else per_skip).items() if v}
            if f["launches"] != want:
                raise AssertionError(f"{label}: forward {i} launched "
                                     f"{f['launches']}, want {want}")
        total = {k: sum(f["launches"].get(k, 0) for f in fw) for k in counts}
        if counts != total:
            raise AssertionError(f"{label}: launches {counts} outside the "
                                 f"forwards {total}")
        nbytes = path = None
        if isinstance(video, torch.Tensor):      # WanPipeline.generate
            seen.append({"shape": list(video.shape),
                         "finite": bool(torch.isfinite(video).all())})
        else:                                    # the service's paths
            if len(video) != 1 or os.path.getsize(video[0]) == 0:
                raise AssertionError(f"{label}: outputs {video}")
            nbytes = os.path.getsize(video[0])
            if keep:
                path = video[0]
            else:
                os.remove(video[0])         # frames are stored uncompressed
        if not (seen and seen[0]["finite"]
                and seen[0]["shape"] == [n_frames, h, w, 3]):
            raise AssertionError(f"{label}: frames {seen}")
        n_calc = sum(flags)
        calc_s = sum(f["s"] for f in fw if f["calc"])
        return {"forwards": len(fw), "calc_forwards": n_calc,
                "calc_flags": [int(c) for c in flags],
                "forward_s": [f["s"] for f in fw],
                "forward_params": [f["params"] for f in fw],
                "calc_forward_s": calc_s / max(n_calc, 1),
                "request_s": req_s, **split, "launches": counts,
                "frames": seen[0]["shape"], "bytes": nbytes,
                **({"path": path} if keep else {})}

    def run_d():
        """(D): 1.3B from checkpoint files through the service.  Random
        DiT weights are exported as a quanto-int8 file, with a
        torch-layout VAE file; the service loads both through the
        resolver (no random weights, no quantize: the file's int8 w_q run
        the W8 kernel as loaded).  The 1.3B definition names only its bf16
        file, so the run's definition adds the quanto one, named as t2v's
        definition names the 14B's, and the resolver picks it for
        quantization "int8".  There is no UMT5 file: the resolver is
        asked for the transformer and the VAE only, and prompts are
        embedded by their hash."""
        from wan2gp_tpu_torch.caches import (MAGCACHE_DEF_RATIOS,
                                             magcache_auto_threshold,
                                             magcache_interp_ratios,
                                             magcache_schedule)
        from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
        from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
        from wan2gp_tpu_torch.io.save_quantized import \
            export_quantized_wan_dit
        from wan2gp_tpu_torch.models.wan.dit import init_wan_dit
        from wan2gp_tpu_torch.models.wan.vae import (WanVAEConfig,
                                                     init_wan_vae)
        ckdir = os.path.join(OUT, "ckpts")
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        model_def = dict(svc_mod.GenerationService(
            init_random_weights=True).registry.get("t2v_1.3B"))
        url = model_def["URLs"][0].replace("_mbf16", "_quanto_mbf16_int8")
        model_def["URLs"] = [*model_def["URLs"], url]
        dit_path = os.path.join(ckdir, os.path.basename(url))
        vae_path = os.path.join(ckdir, "Wan2.1_VAE.safetensors")
        cfg = fam.WanFamilyHandler.dit_config("t2v_1.3B")
        gen = torch.Generator(device="cuda").manual_seed(11)
        params = init_wan_dit(gen, cfg)
        vae_cfg = WanVAEConfig()
        gen.manual_seed(12)
        vae_params = init_wan_vae(gen, vae_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_quantized_wan_dit(params, dit_path)
        save_safetensors(vae_path, vae_state_dict(vae_params, vae_cfg))
        write_s = time.perf_counter() - t0
        # what the file must load back as: the block linears quantized as
        # the export quantizes them, every other tensor as it was
        want = {"dit": params, "vae": vae_params}
        blocks = params["blocks"]
        for lin in [blocks[a][m] for a in ("self_attn", "cross_attn")
                    for m in "qkvo"] + list(blocks["ffn"].values()):
            lin["w_q"], lin["scale"] = Q.quantize_int8(lin.pop("w").float())
        svc = svc_mod.GenerationService(
            checkpoints_resolver=make_checkpoints_resolver(
                [ckdir], quantization="int8", roles=("transformer", "vae")),
            output_dir=out_dir)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = svc.get_pipeline("t2v_1.3B", model_def)
        if pipe.t5_params is not None:
            raise AssertionError("(D): a text encoder was loaded")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        leaves = 0
        for name, got in (("dit", pipe.dit_params), ("vae", pipe.vae_params)):
            a, b = dict(_flat(got)), dict(_flat(want[name]))
            if sorted(a) != sorted(b):
                raise AssertionError(
                    f"(D) {name}: keys {sorted(set(a) ^ set(b))}")
            for k in a:
                if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
                    raise AssertionError(f"(D) {name}{k}: not the written "
                                         "tensor")
            leaves += len(a)
        del want, params, vae_params, blocks
        torch.cuda.empty_cache()
        n = 8
        ratios = magcache_interp_ratios(MAGCACHE_DEF_RATIOS["t2v_1.3B"], n)
        plan = magcache_schedule(ratios, magcache_auto_threshold(ratios,
                                                                 1.75))
        # NAG: the context_neg k/v products and a second cross flash
        per_forward = {"flash_attention": 90, "matmul_w8": 360}
        out = recorded_request("(D)", lambda: svc.generate({
            "model_type": "t2v_1.3B", "prompt": "a red fox",
            "resolution": "832x480", "video_length": frames,
            "num_inference_steps": n, "guidance_scale": 5.0,
            "sample_solver": "dpm++", "NAG_scale": 2.0, "NAG_tau": 3.5,
            "NAG_alpha": 0.5, "cache_type": "mag", "seed": 3}),
            plan, per_forward, {}, frames, 480, 832)
        svc.release_model()
        del svc, pipe
        files = {os.path.basename(p): os.path.getsize(p)
                 for p in (dit_path, vae_path)}
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        return {"label": "(D) 1.3B 480p from checkpoint files: quanto-int8 "
                         "DiT (W8 as loaded), DPM++, NAG 2.0, MagCache",
                "text_encoder": "none (prompts embedded by their hash)",
                "files_bytes": files, "write_s": write_s, "load_s": load_s,
                "load_peak_gb": load_peak, "leaves_equal": leaves,
                "steps": n, "plan": plan.astype(int).tolist(),
                "launches_per_calc_forward": per_forward, **out}

    def run_e():
        """(E): 1.3B sliding windows through the service: two windows of
        81 frames overlapping by 5, Euler, first-block cache, 2 steps a
        window.  The cache's threshold (E_FBC_THRESHOLD, far above any
        rel-L1 of block 0's output) makes each window's second step a
        skip, so both of its branches run on the card."""
        from wan2gp_tpu_torch.windows import plan_windows
        n_frames = 157
        plans = plan_windows(n_frames, 81, 5)
        total = sum(p.size for p in plans) - sum(p.overlap for p in plans)
        if len(plans) != 2 or total != n_frames:
            raise AssertionError(f"(E): plan {plans}")
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir)
        svc.get_pipeline("t2v_1.3B")
        # a computed forward: 30 self + 30 cross; a skipped one: block 0's;
        # a window's first step is computed, its second skipped
        out = recorded_request("(E)", lambda: svc.generate({
            "model_type": "t2v_1.3B", "prompt": "a red fox",
            "resolution": "832x480", "video_length": n_frames,
            "sliding_window_size": 81, "sliding_window_overlap": 5,
            "num_inference_steps": 2, "guidance_scale": 5.0,
            "sample_solver": "euler", "cache_type": "fbc",
            "cache_threshold": E_FBC_THRESHOLD, "seed": 4}),
            [1, 0, 1, 0], {"flash_attention": 60}, {"flash_attention": 2},
            total, 480, 832, keep=True)
        svc.release_model()
        del svc
        torch.cuda.empty_cache()
        return {"label": "(E) 1.3B 480p sliding windows: 2 x 81 frames, "
                         "overlap 5, Euler, first-block cache",
                "windows": [vars(p) for p in plans],
                "stitched_frames": total, "steps_per_window": 2,
                "fbc_threshold": E_FBC_THRESHOLD,
                "plan": out["calc_flags"], **out}

    def run_h(source):
        """(H): t2v_1.3B continue-video through the service: (E)'s
        157-frame output continued by 81 frames, overlap 5, UniPC, 2
        steps.  The source's last 5 frames encode to the 2 latent frames
        pinned at the start of the only window; the result is the source
        with the continuation cross-faded onto its last 5 frames."""
        n_src = media.read_avi(source).shape[0]
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc.get_pipeline("t2v_1.3B")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        pinned = []
        timed_denoise = WanPipeline.denoise

        def spy(self, *a, overlap_latents=None, **kw):
            pinned.append(None if overlap_latents is None
                          else list(overlap_latents.shape))
            return timed_denoise(self, *a, overlap_latents=overlap_latents,
                                 **kw)
        WanPipeline.denoise = spy
        try:
            out = recorded_request("(H)", lambda: svc.generate({
                "model_type": "t2v_1.3B", "prompt": "a red fox",
                "video_source": source, "video_length": frames,
                "sliding_window_overlap": 5, "num_inference_steps": STEPS,
                "guidance_scale": 5.0, "sample_solver": "unipc",
                "seed": 6}), [1] * STEPS, {"flash_attention": 60}, {},
                n_src + frames - 5, 480, 832)
        finally:
            WanPipeline.denoise = timed_denoise
        if pinned != [[1, 16, 2, 60, 104]]:
            raise AssertionError(f"(H): pinned overlaps {pinned}")
        svc.release_model()
        del svc
        torch.cuda.empty_cache()
        return {"label": "(H) 1.3B 480p continue-video: (E)'s output "
                         "continued by 81 frames, overlap 5",
                "source_frames": n_src, "new_frames": frames,
                "pinned_overlap": pinned[0], "steps": STEPS,
                "load_s": load_s, "load_peak_gb": load_peak, **out}

    def run_g(png):
        """(G): i2v_2_2 (Wan2.2 A14B image-to-video) at 1280x720x81 with
        quantize="int8" on both experts, dense attention, G_LAYERS of each
        expert's 40 layers, the definition's two phases (switch_threshold
        900, guidance 3.5 / 3.5, flow_shift 5) over 2 UniPC steps: t = 999
        runs the high-noise expert, t = 833 the low-noise one."""
        from wan2gp_tpu_torch.models.wan.pipeline import plan_phases
        from wan2gp_tpu_torch.schedulers import make_schedule
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir,
                                        quantize="int8")
        sampling = fam.sampling_from_settings({
            **svc.registry.default_settings("i2v_2_2"),
            "num_inference_steps": STEPS})
        sched = make_schedule("unipc", STEPS, sampling.shift)
        phases = plan_phases(sched.timesteps, sampling, True)
        if [p[3] for p in phases] != [0, 1]:
            raise AssertionError(f"(G): phases {phases}")
        arch = fam._ARCH["i2v_2_2"]
        fam._ARCH["i2v_2_2"] = {**arch, "num_layers": G_LAYERS}
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe = svc.get_pipeline("i2v_2_2")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            load_peak = torch.cuda.max_memory_allocated() / 1e9
        finally:
            fam._ARCH["i2v_2_2"] = arch
        reset_pads()
        per_forward = {"flash_attention": 2 * G_LAYERS,
                       "matmul_w8": 10 * G_LAYERS}
        out = recorded_request("(G)", lambda: svc.generate({
            "model_type": "i2v_2_2", "prompt": "a red fox",
            "resolution": "1280x720", "video_length": frames,
            "num_inference_steps": STEPS, "sample_solver": "unipc",
            "image_start": png, "seed": 5}), [1] * STEPS, per_forward, {},
            frames, 720, 1280)
        experts = [{id(pipe.dit_params): 0, id(pipe.dit_params2): 1}
                   .get(i) for i in out.pop("forward_params")]
        if experts != [0, 1]:
            raise AssertionError(f"(G): experts by forward {experts}")
        padded = read_pads()
        if padded:
            raise AssertionError(f"(G): {padded} matmul launches padded")
        svc.release_model()
        del svc, pipe
        torch.cuda.empty_cache()
        return {"label": "(G) Wan2.2 i2v A14B 720p, int8 on both experts, "
                         "two phases", "steps": STEPS,
                "layers": f"{G_LAYERS} of each expert's 40 (cut from 10)",
                "timesteps": sched.timesteps.tolist(),
                "phases": [list(p) for p in phases],
                "experts_by_forward": experts, "load_s": load_s,
                "load_peak_gb": load_peak, "padded_launches": padded,
                "launches_per_forward": per_forward, **out}

    def run_i():
        """(I): Wan2.2 TI2V 5B (`ti2v_2_2`) at all I_LAYERS = 30 layers
        from its files at 1280x704x121.
        Random weights are written as the quanto-int8 DiT file the
        definition's second URL names and as a Wan2.2 VAE file; the
        service loads both through the resolver (quantization "int8",
        roles transformer and VAE; the loaded trees must equal the written
        tensors), so W8 runs on the file's int8 weights.  UniPC, 2 steps,
        joint CFG at guidance 5, flow_shift 5, dense attention; the Wan2.2
        decode in 4 x 7 spatial tiles of the whole clip."""
        from wan2gp_tpu_torch.io.downloads import make_checkpoints_resolver
        from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
        from wan2gp_tpu_torch.io.save_quantized import \
            export_quantized_wan_dit
        from wan2gp_tpu_torch.models.wan import vae2_2
        from wan2gp_tpu_torch.models.wan.dit import init_wan_dit
        ckdir = os.path.join(OUT, "ckpts")
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        model_def = svc_mod.GenerationService(
            init_random_weights=True).registry.get("ti2v_2_2")
        url = model_def["URLs"][1]
        if not url.endswith("_5B_quanto_mbf16_int8.safetensors"):
            raise AssertionError(f"(I): the definition's URLs {model_def}")
        dit_path = os.path.join(ckdir, os.path.basename(url))
        vae_path = os.path.join(ckdir, "Wan2.2_VAE.safetensors")
        cfg = dataclasses.replace(fam.WanFamilyHandler.dit_config("ti2v_2_2"),
                                  num_layers=I_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(13)
        params = init_wan_dit(gen, cfg)
        vae_cfg = vae2_2.Wan22VAEConfig()
        gen.manual_seed(14)
        vae_params = vae2_2.init_wan22_vae(gen, vae_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_quantized_wan_dit(params, dit_path)
        save_safetensors(vae_path, vae22_state_dict(vae_params))
        write_s = time.perf_counter() - t0
        want = {"dit": params, "vae": vae_params}
        blocks = params["blocks"]
        for lin in [blocks[a][m] for a in ("self_attn", "cross_attn")
                    for m in "qkvo"] + list(blocks["ffn"].values()):
            lin["w_q"], lin["scale"] = Q.quantize_int8(lin.pop("w").float())
        svc = svc_mod.GenerationService(
            checkpoints_resolver=make_checkpoints_resolver(
                [ckdir], quantization="int8", roles=("transformer", "vae")),
            output_dir=out_dir)
        arch = fam._ARCH["ti2v_2_2"]
        fam._ARCH["ti2v_2_2"] = {**arch, "num_layers": I_LAYERS}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            pipe = svc.get_pipeline("ti2v_2_2")
        finally:
            fam._ARCH["ti2v_2_2"] = arch
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        leaves = 0
        for name, got in (("dit", pipe.dit_params), ("vae", pipe.vae_params)):
            a, b = dict(_flat(got)), dict(_flat(want[name]))
            if sorted(a) != sorted(b):
                raise AssertionError(
                    f"(I) {name}: keys {sorted(set(a) ^ set(b))}")
            for k in a:
                if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
                    raise AssertionError(f"(I) {name}{k}: not the written "
                                         "tensor")
            leaves += len(a)
        del want, params, vae_params, blocks
        torch.cuda.empty_cache()
        tiles = []
        real_tile = vae2_2.wan22_vae_decode

        def tile(p, c, z):
            tiles.append(list(z.shape[1:4]))
            return real_tile(p, c, z)
        reset_pads()
        per_forward = {"flash_attention": 2 * I_LAYERS,
                       "matmul_w8": 10 * I_LAYERS}
        vae2_2.wan22_vae_decode = tile
        try:
            out = recorded_request("(I)", lambda: svc.generate({
                "model_type": "ti2v_2_2", "prompt": "a red fox",
                "resolution": f"{I_W}x{I_H}", "video_length": I_FRAMES,
                "num_inference_steps": STEPS, "sample_solver": "unipc",
                "guidance_scale": 5.0, "flow_shift": 5.0,
                "attention_mode": "auto", "seed": 7}), [1] * STEPS,
                per_forward, {}, I_FRAMES, I_H, I_W)
        finally:
            vae2_2.wan22_vae_decode = real_tile
        out.pop("forward_params")
        lat = [(I_FRAMES - 1) // 4 + 1, I_H // 16, I_W // 16]
        if len(tiles) != 28 or max(tiles) != [lat[0], 16, 16]:
            raise AssertionError(f"(I): decode tiles {tiles}")
        padded = read_pads()
        if padded:
            raise AssertionError(f"(I): {padded} launches padded")
        svc.release_model()
        del svc, pipe
        files = {os.path.basename(p): os.path.getsize(p)
                 for p in (dit_path, vae_path)}
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        return {"label": "(I) Wan2.2 TI2V 5B 1280x704x121 from its files: "
                         "quanto-int8 DiT (W8 as loaded), Wan2.2 VAE, "
                         "tiled decode",
                "latents": [cfg.out_dim, *lat], "tokens": I_TOKENS,
                "steps": STEPS, "solver": "unipc", "guidance_scale": 5.0,
                "flow_shift": 5.0, "files_bytes": files, "write_s": write_s,
                "load_s": load_s, "load_peak_gb": load_peak,
                "leaves_equal": leaves, "decode_tiles": len(tiles),
                "tile_latents": sorted({tuple(t) for t in tiles}),
                "step_s": out["denoise_s"] / STEPS,
                "padded_launches": padded,
                "launches_per_forward": per_forward, **out}

    def run_j():
        """(J): vace_multitalk_14B (Wan2.1 14B with VACE and the multitalk
        module) at 832x480x81, through WanPipeline.generate_multitalk with
        a VACE context (the JAX handler never passes one).  The DiT
        (J_LAYERS of its 40 layers, a VACE block every second layer) is
        random and quantized int8 in process; the
        multitalk module (reference key names, bf16) and a wav2vec2-base
        (HF key names, fp32) are written from random weights under
        `ckpts`, read back by their loaders and placed in the pipeline as
        load_model places them.  A 16 kHz WAV of 81 / 25 s is read and
        turned into features by wav2vec2; a control video with a
        half-frame mask becomes the VACE context; 2 UniPC steps at
        guidance 1 and audio guidance 4 (the definition's 10 steps cut to
        STEPS), the two audio-CFG branches as one batch-2 forward a step;
        the Wan2.1 decode."""
        from wan2gp_tpu_torch.io.safetensors_reader import (
            load_weights, save_safetensors)
        from wan2gp_tpu_torch.models.wan import multitalk as mt
        from wan2gp_tpu_torch.models.wan.pipeline import SamplingConfig
        ckdir = os.path.join(OUT, "ckpts")
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        model_def = svc_mod.GenerationService(
            init_random_weights=True).registry.get("vace_multitalk_14B")
        defaults = model_def["settings"]
        if (defaults["guidance_scale"], defaults["num_inference_steps"],
                defaults["resolution"], defaults["video_length"]) != (
                    1, 10, "832x480", 81):
            raise AssertionError(f"(J): the definition {defaults}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        arch = fam._ARCH["vace_multitalk_14B"]
        fam._ARCH["vace_multitalk_14B"] = {**arch, "num_layers": J_LAYERS}
        try:
            pipe = fam.WanFamilyHandler.load_model(
                "vace_multitalk_14B", model_def, init_random=True, seed=21)
        finally:
            fam._ARCH["vace_multitalk_14B"] = arch
        cfg = pipe.dit_cfg
        # the module (load_model's random one) and wav2vec2 as files
        module_sd = mt.multitalk_module_state_dict(
            pipe.audio_proj_params, pipe.dit_params.pop("audio_attn_blocks"))
        pipe.audio_proj_params = None
        gen = torch.Generator(device="cuda").manual_seed(22)
        w2v_cfg = mt.Wav2Vec2Config()
        w2v_sd = mt.wav2vec2_state_dict(mt.init_wav2vec2(gen, w2v_cfg))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        module_path = os.path.join(
            ckdir, "Wan2.1_multitalk_14B_mbf16.safetensors")
        w2v_path = os.path.join(ckdir, "chinese-wav2vec2-base",
                                "model.safetensors")
        os.makedirs(os.path.dirname(w2v_path))
        t0 = time.perf_counter()
        save_safetensors(module_path, module_sd)
        save_safetensors(w2v_path, w2v_sd)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ap, ap_cfg, blocks = mt.load_multitalk_module_params(
            load_weights(module_path), cfg.num_layers, torch.bfloat16)
        w2v = mt.load_wav2vec2_params(load_weights(w2v_path), w2v_cfg)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        leaves = 0
        again = {**mt.multitalk_module_state_dict(ap, blocks),
                 **{"w2v/" + k: v for k, v in
                    mt.wav2vec2_state_dict(w2v).items()}}
        for k, v in {**module_sd, **{"w2v/" + k: v for k, v in
                                     w2v_sd.items()}}.items():
            if again[k].dtype != v.dtype or not torch.equal(again[k], v):
                raise AssertionError(f"(J) {k}: not the written tensor")
            leaves += 1
        if len(again) != leaves:
            raise AssertionError(f"(J): {len(again)} tensors read back, "
                                 f"{leaves} written")
        del module_sd, w2v_sd, again
        pipe.dit_params["audio_attn_blocks"] = blocks
        pipe.audio_proj_params, pipe.audio_proj_cfg = ap, ap_cfg
        pipe.wav2vec = (w2v, w2v_cfg)
        t0 = time.perf_counter()
        pipe.dit_params = svc_mod.quantize_dit_params(pipe.dit_params,
                                                      "int8")
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        del blocks
        torch.cuda.empty_cache()
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        weights_gb = sum(t.numel() * t.element_size()
                         for t in _leaves(pipe.dit_params)) / 1e9
        # the audio: a 16 kHz WAV of 81 / 25 s, as the handler reads it
        frames, h, w, fps = 81, 480, 832, 25
        tt = np.arange(frames * 16000 // fps) / 16000
        wav = media.save_audio((0.3 * np.sin(2 * np.pi * (200 + 300 * tt)
                                             * tt)).astype(np.float32),
                               os.path.join(ckdir, "voice.wav"))
        # the control video: a moving gradient, the mask its right half
        yy, xx = torch.meshgrid(torch.linspace(-1, 1, h, device="cuda"),
                                torch.linspace(-1, 1, w, device="cuda"),
                                indexing="ij")
        ph = torch.arange(frames, device="cuda")[:, None, None] / frames
        control = torch.stack([torch.sin(3 * xx + 6 * ph), yy.expand_as(
            torch.sin(3 * xx + 6 * ph)), torch.cos(2 * yy - 6 * ph)], -1)
        masks = (xx > 0).float().expand(frames, h, w)
        sampling = SamplingConfig(solver="unipc", steps=STEPS, shift=5.0,
                                  guide_scale=1.0)
        extra = {}

        def request():
            t0 = time.perf_counter()
            pcm, rate = media.read_wav(wav)
            mono = pcm.astype(np.float32).mean(axis=1) / 32767.0
            mono = (mono - mono.mean()) / (mono.std() + 1e-7)
            emb = mt.wav2vec2_extract(
                w2v, w2v_cfg, torch.from_numpy(mono[None]).cuda(), frames)
            torch.cuda.synchronize()
            extra["wav2vec_s"] = time.perf_counter() - t0
            extra["audio_features"] = list(emb.shape)
            extra["sample_rate"] = rate
            vctx, refs = pipe.build_vace_conditioning(control, masks)
            extra["vace_context"] = list(vctx.shape)
            return pipe.generate_multitalk(
                "a person talking", emb[0], width=w, height=h,
                frame_num=frames, sampling=sampling, seed=9,
                audio_guide_scale=4.0, vace_context=vctx)
        per_forward = dict(J_KERNELS)
        reset_pads()
        out = recorded_request("(J)", request, [1] * STEPS, per_forward, {},
                               frames, h, w)
        out.pop("forward_params")
        padded = read_pads()
        if padded:
            raise AssertionError(f"(J): {padded} matmul launches padded")
        if (extra["audio_features"] != [1, frames, 12, 768]
                or extra["vace_context"] != [1, 96, 21, 60, 104]):
            raise AssertionError(f"(J): {extra}")
        files = {os.path.relpath(p, ckdir): os.path.getsize(p)
                 for p in (module_path, w2v_path)}
        del pipe, w2v, ap
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        return {"label": "(J) vace_multitalk_14B 832x480x81: VACE (half-"
                         "frame mask) + audio (wav2vec2 from a WAV), int8, "
                         "guidance 1, audio guidance 4",
                "layers": cfg.num_layers, "vace_blocks": len(cfg.vace_layers),
                "depth": f"{J_LAYERS} of 40 layers (cut from 10)",
                "steps": STEPS, "solver": "unipc", "init_s": init_s,
                "write_s": write_s, "read_s": read_s,
                "quantize_s": quantize_s, "files_bytes": files,
                "leaves_equal": leaves, "load_peak_gb": load_peak,
                "dit_weights_gb": weights_gb, **extra,
                "step_s": out["denoise_s"] / STEPS,
                "padded_launches": padded,
                "launches_per_forward": per_forward, **out}

    def run_n():
        """(N): t2v (Wan2.1 14B) in bf16, dense, N_LAYERS = 10 of its 40
        layers (all 40 before), at
        1280x720x81 through GenerationService with the Lightx2v profile:
        its rank-32 LoRA (n_lora_state_dict, written under the profile
        URL's basename in <lora_root>/wan) merged at multiplier 1,
        guidance 1 (batch 1), flow_shift 2, STEPS of the profile's 4
        UniPC steps.  Checks: a merged q and fc1 slice within one bf16 ulp
        of the port's CPU merge from the same file; once the service has
        restored the base weights (what a request without LoRA does
        first), every DiT leaf bit-equal to its value before the merge (a
        checksum of each)."""
        from wan2gp_tpu_torch import lora as L
        from wan2gp_tpu_torch.config.profiles import load_profile
        from wan2gp_tpu_torch.io.safetensors_reader import save_safetensors
        prof = load_profile(*N_PROFILE.split("/", 1))
        if (prof["guidance_scale"], prof["flow_shift"],
                prof["num_inference_steps"], prof["loras_multipliers"]) != (
                    1, 2, N_PROFILE_STEPS, "1"):
            raise AssertionError(f"(N): the profile {prof}")
        lora_root = os.path.join(OUT, "loras")
        shutil.rmtree(lora_root, ignore_errors=True)
        lora_path = os.path.join(lora_root, "wan", os.path.basename(
            prof["activated_loras"][0]))
        os.makedirs(os.path.dirname(lora_path))
        svc = svc_mod.GenerationService(init_random_weights=True,
                                        output_dir=out_dir,
                                        lora_root=lora_root)
        arch = fam._ARCH["t2v"]
        fam._ARCH["t2v"] = {**arch, "num_layers": N_LAYERS}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            pipe = svc.get_pipeline("t2v")
        finally:
            fam._ARCH["t2v"] = arch
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        cfg = pipe.dit_cfg
        t0 = time.perf_counter()
        before = leaf_checksums(pipe.dit_params)
        checksum_s = time.perf_counter() - t0
        blocks = pipe.dit_params["blocks"]
        last = N_LAYERS - 1
        probes = {"blocks.7.self_attn.q": ("self_attn", "q", 7),
                  f"blocks.{last}.ffn.0": ("ffn", "fc1", last)}
        base = {p: blocks[a][b]["w"][i].cpu()
                for p, (a, b, i) in probes.items()}
        t0 = time.perf_counter()
        sd = n_lora_state_dict(cfg)
        save_safetensors(lora_path, sd)
        write_s = time.perf_counter() - t0
        lora_keys, lora_bytes = len(sd), os.path.getsize(lora_path)
        del sd
        info = {}
        real_read, real_merge = L.read_lora, L.MergedLoras.merge

        def read(path):
            d = real_read(path)
            info["paths"] = len(d)
            return d

        def merge(self, *a, **kw):
            info["unmatched"] = real_merge(self, *a, **kw)
            return info["unmatched"]
        real_reserve = L.MergedLoras.reserve

        def reserve(self, slots):
            t0 = time.perf_counter()
            real_reserve(self, slots)
            info["reserve_s"] = time.perf_counter() - t0
        L.read_lora = timed("lora_read", read)
        L.MergedLoras.merge = timed("lora_merge", merge)
        L.MergedLoras.reserve = reserve
        status = []
        try:
            out = recorded_request("(N)", lambda: svc.generate({
                "model_type": "t2v", "prompt": "a red fox",
                "resolution": "1280x720", "video_length": frames,
                "profile": N_PROFILE, "num_inference_steps": STEPS,
                "seed": 11}, on_progress=lambda k, m: status.append(m)),
                [1] * STEPS, {"flash_attention": 2 * N_LAYERS}, {}, frames,
                720, 1280)
        finally:
            L.read_lora, L.MergedLoras.merge = real_read, real_merge
            L.MergedLoras.reserve = real_reserve
        out.pop("forward_params")
        matched = info["paths"] - len(info["unmatched"])
        if (matched, info["unmatched"]) != (10 * cfg.num_layers,
                                            ["text_embedding.0"]) \
                or "1 unmatched LoRA keys" not in status:
            raise AssertionError(f"(N): {info} {status}")
        state = svc._merged["t2v"]
        host_bytes = state.host_bytes
        arena = state._arena.buf
        arena_bytes, pinned = arena.numel(), arena.is_pinned()
        del arena
        # a merged slice on the card against the port's CPU merge
        lora_cpu = L.read_lora(lora_path)
        merge_check = {}
        for path, (a, b, i) in probes.items():
            sub = path.split(".", 2)[2]
            node = {"w": base[path][None].clone()}
            L.merge_lora({"blocks": {a: {b: node}}},
                         {f"blocks.0.{sub}": lora_cpu[path]}, 1.0)
            card = blocks[a][b]["w"][i].cpu()
            ulps = bf16_ulps(card, node["w"][0])
            merge_check[path] = {
                "max_ulps": float(ulps.max()),
                "bit_equal_share": float((card == node["w"][0]).float()
                                         .mean()),
                "changed_share": float((card != base[path]).float().mean())}
            if merge_check[path]["max_ulps"] > 1 \
                    or merge_check[path]["changed_share"] < 0.5:
                raise AssertionError(f"(N) {path}: {merge_check[path]}")
        # what a request without LoRA does first: the base weights back
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.sync_loras("t2v", pipe, None)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        after = leaf_checksums(pipe.dit_params)
        if after != before or state.host_bytes:
            raise AssertionError(
                f"(N): leaves not restored: "
                f"{[k for k in before if after.get(k) != before[k]][:8]}")
        svc.release_model()
        del svc, pipe, blocks
        shutil.rmtree(lora_root, ignore_errors=True)
        torch.cuda.empty_cache()
        step_s = out["denoise_s"] / STEPS
        return {"label": "(N) t2v 14B 720p bf16 dense, the Lightx2v profile "
                         "(rank-32 LoRA merged, guidance 1, flow_shift 2)",
                "profile": N_PROFILE, "steps": STEPS,
                "profile_steps": N_PROFILE_STEPS, "layers": cfg.num_layers,
                "load_s": load_s, "load_peak_gb": load_peak,
                "lora_write_s": write_s, "lora_bytes": lora_bytes,
                "lora_keys": lora_keys, "lora_paths": info["paths"],
                "matched": matched, "unmatched": info["unmatched"],
                "restore_host_bytes": host_bytes,
                "restore_arena_bytes": arena_bytes,
                "restore_arena_pinned": pinned,
                "lora_merge_reserve_s": info["reserve_s"],
                "restore_s": restore_s, "checksum_s": checksum_s,
                "leaves_restored": len(after), "merge_check": merge_check,
                "step_s": step_s,
                "projected_request_s_at_4_steps": out["request_s"]
                + (N_PROFILE_STEPS - STEPS) * step_s,
                "launches_per_forward": {"flash_attention": 2 * N_LAYERS},
                **out}

    def run_o():
        """(O): krea2_raw from its files at 1024x1024, two requests at
        guidance 3.5 (CFG as batch 2), STEPS steps.  The DiT (12.8 B, all
        O_LAYERS = 28 layers) is random on the card, exported block by
        block to a host state dict in the reference names and freed; the
        Qwen3-4B
        tower (36 layers, width 2560) likewise, in HF names; the image VAE
        is written as qwen_vae.safetensors (bf16).  A GenerationService
        loads the three roles through its checkpoints resolver and the
        handler's loaders (the two state dicts stand in for their files);
        the prompt is hashed into Qwen3's vocabulary and its 12
        SELECT_LAYERS hidden layers over the 512-token template condition
        the DiT: a masked flash launch a layer a forward, 4 masked (text
        refiner) and 4 dense (layer-wise text blocks) a request."""
        from wan2gp_tpu_torch.families import krea2 as kfam
        from wan2gp_tpu_torch.io import krea2_checkpoint as kck
        from wan2gp_tpu_torch.lora import HostArena
        from wan2gp_tpu_torch.models.krea2.dit import Krea2Config, init_krea2
        from wan2gp_tpu_torch.models.qwen import text_encoder as qlm
        from wan2gp_tpu_torch.models.wan.vae import WanVAEConfig, \
            init_wan_vae
        gen = torch.Generator(device="cuda")
        vcfg = WanVAEConfig()
        vae_sd = vae_state_dict(init_wan_vae(gen.manual_seed(41), vcfg),
                                vcfg)

        def build(gen_, clock):
            cfg = Krea2Config(layers=O_LAYERS)
            t0 = time.perf_counter()
            params = init_krea2(gen_.manual_seed(42), cfg, torch.bfloat16)
            clock("dit_init_s", t0)
            t0 = time.perf_counter()
            arena = HostArena(list(_leaves(params)), pin=True)
            sd = {k: arena.put(v) for k, v in
                  kck.krea2_state_dict(params, cfg, layers=()).items()}
            for i in range(cfg.layers):
                sd.update({k: arena.put(v) for k, v in kck.krea2_state_dict(
                    params, cfg, layers=[i], rest=False).items()})
            clock("dit_export_s", t0)
            del params
            return sd, arena, cfg, lambda tree: kck.krea2_state_dict(
                tree, cfg, layers=(0, cfg.layers - 1))
        arch = kfam._ARCH
        kfam._ARCH = {**arch, "layers": O_LAYERS}
        try:
            svc, pipe, rec = from_host_files(
                "(O)", "krea2_raw", gen, build, qlm.QWEN3_4B,
                "qwen_vae.safetensors", vae_sd,
                lm_prefix="model.language_model.")
        finally:
            kfam._ARCH = arch
        del vae_sd
        if rec["roles"] != {"transformer": "Krea2Raw_bf16.safetensors",
                            "text_encoder":
                                "Qwen3-VL-4B-Instruct_text_bf16.safetensors",
                            "vae": "qwen_vae.safetensors"}:
            raise AssertionError(f"(O): the roles' files {rec['roles']}")
        cfg = Krea2Config(layers=O_LAYERS)
        pipe.vae_decode_fn = timed("decode", pipe.vae_decode_fn)
        pipe.text_encode_fn = timed("lm", pipe.text_encode_fn)
        valid = o_text_tokens()
        reset_counts()
        reqs = []
        for i in range(2):
            seen.clear()
            split.clear()
            t0 = time.perf_counter()
            paths = svc.generate({
                "model_type": "krea2_raw", "prompt": f"a red fox {i}",
                "resolution": "1024x1024", "num_inference_steps": STEPS,
                "guidance_scale": 3.5, "seed": i})
            req_s = time.perf_counter() - t0
            ok = (len(paths) == 1 and paths[0].endswith(".png")
                  and media.read_image(paths[0]).shape == (1024, 1024, 3)
                  and seen and seen[0]["finite"]
                  and seen[0]["shape"] == [1024, 1024, 3]
                  and media.read_image_metadata(paths[0])["seed"] == i)
            if not ok:
                raise AssertionError(f"(O) request {i}: {paths} {seen}")
            reqs.append({"request_s": req_s, **split,
                         "step_s": split["denoise_s"] / STEPS,
                         "bytes": os.path.getsize(paths[0])})
            os.remove(paths[0])
        counts = read_counts()
        per_forward = {"flash_attention_kvmask": cfg.layers}
        per_request = {"flash_attention_kvmask": 2 * cfg.n_fusion_blocks,
                       "flash_attention": 2 * cfg.n_fusion_blocks}
        want = {name: 2 * (per_forward.get(name, 0) * STEPS
                           + per_request.get(name, 0)) for name in counts}
        if counts != want:
            raise AssertionError(f"(O): launches {counts}, want {want}")
        svc.release_model()
        del svc, pipe
        torch.cuda.empty_cache()
        return {"label": "(O) krea2_raw 1024x1024 from its files: DiT and "
                         "Qwen3-4B tower through host state dicts, the "
                         "image VAE file", "model": "krea2_raw",
                "resolution": "1024x1024", "layers": cfg.layers,
                "text_slots": O_TEXT, "valid_text_tokens": valid,
                "tokens": O_TEXT + 4096, "guidance_scale": 3.5,
                "steps": STEPS, **rec, "requests": reqs, "launches": counts,
                "launches_per_forward": per_forward,
                "launches_per_request_besides": per_request}

    def from_host_files(label, model_type, gen, build, lm_arch, vae_file,
                        vae_sd, quantization="", lm_prefix="model."):
        """A model of the port served from its files: `build(gen)` makes
        the DiT's host state dict (in a pinned arena, the DiT freed on the
        card) and returns (state dict, arena, config, the exporter of the
        loaded tree); the text tower of `lm_arch` is random on the card and
        exported to a pinned arena in HF names under `lm_prefix`; the
        VAE's state dict is
        written as `vae_file` (bf16).  A GenerationService loads the three
        roles through its resolver and the handler's loaders (the two
        state dicts stand in for their files); the loaded DiT, exported
        again, must be the state dict (its first and last blocks and the
        keys outside them).  The file names of the roles that name URLs
        are recorded as the resolver would pick them for `quantization`.
        Returns (service, pipeline, record)."""
        from wan2gp_tpu_torch.io import downloads
        from wan2gp_tpu_torch.io import safetensors_reader as st
        from wan2gp_tpu_torch.lora import HostArena
        from wan2gp_tpu_torch.models.qwen import text_encoder as qlm
        bf16 = torch.bfloat16
        ckdir = os.path.join(OUT, f"ckpts_{model_type}")
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        times = {}

        def clock(name, t0):
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vae_path = os.path.join(ckdir, vae_file)
        st.save_safetensors(vae_path, {k: v.to(bf16)
                                       for k, v in vae_sd.items()})
        clock("vae_write_s", t0)
        vae_bytes = os.path.getsize(vae_path)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dit_sd, dit_arena, cfg, export = build(gen, clock)
        clock("dit_init_export_s", t0)
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        lm_cfg = qlm.QwenLMConfig(**lm_arch, compute_dtype=bf16)
        t0 = time.perf_counter()
        lm = qlm.init_qwen_lm(gen.manual_seed(43), lm_cfg, bf16)
        clock("lm_init_s", t0)
        t0 = time.perf_counter()
        lm_arena = HostArena(list(_leaves(lm)), pin=True)
        lm_sd = {k: lm_arena.put(v) for k, v in
                 qlm.qwen_lm_state_dict(lm, lm_cfg, lm_prefix).items()}
        clock("lm_export_s", t0)
        del lm
        torch.cuda.empty_cache()
        mem = {"memory:transformer": dit_sd, "memory:text_encoder": lm_sd}
        names = {}

        def resolver(model_type_, handler, base, model_def):
            for spec in handler.query_model_files(base, model_def):
                if spec["urls"]:
                    names[spec["role"]] = os.path.basename(
                        downloads.pick_checkpoint_url(spec["urls"],
                                                      quantization))
            return {"transformer": "memory:transformer",
                    "text_encoder": "memory:text_encoder", "vae": vae_path}
        real_load = st.load_weights
        st.load_weights = lambda path: mem[path] if path in mem \
            else real_load(path)
        svc = svc_mod.GenerationService(output_dir=out_dir,
                                        checkpoints_resolver=resolver)
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe = svc.get_pipeline(model_type)
            clock("load_s", t0)
        finally:
            st.load_weights = real_load
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        again = export(pipe.dit_params)
        for k, v in again.items():
            if not torch.equal(v.cpu(), dit_sd[k]):
                raise AssertionError(f"{label} {k}: not the exported tensor")
        record = {"parameters": sum(v.numel() for v in dit_sd.values()),
                  "dit_bytes": sum(v.numel() * v.element_size()
                                   for v in dit_sd.values()),
                  "lm_parameters": sum(v.numel() for v in lm_sd.values()),
                  "pinned_gb": (dit_arena.buf.numel()
                                + lm_arena.buf.numel()) / 1e9,
                  "roles": names, "vae_file_bytes": vae_bytes,
                  "dit_init_peak_gb": init_peak, "load_peak_gb": load_peak,
                  **times}
        del again, dit_sd, lm_sd, mem, dit_arena, lm_arena
        torch._C._host_emptyCache()
        shutil.rmtree(ckdir, ignore_errors=True)
        return svc, pipe, record

    def one_image(label, svc, pipe, request, w, h, per_forward,
                  steps=STEPS, wrap=(("text_encode_fn", "lm"),
                                     ("vae_decode_fn", "decode")),
                  release=True):
        """One request writing a PNG of h x w (checked), the launches of
        its `steps` forwards asserted against per_forward (none padded).
        wrap: (pipeline attribute, split name) of the callables timed in
        this request; the shapes the "lm" one returns are recorded as the
        text states.  release: the model is released after it."""
        texts = []
        saved = {a: getattr(pipe, a) for a, _ in wrap}

        def recorded(real):
            def text_fn(*a):
                out = real(*a)
                texts.append([list(t.shape) for t in
                              (out if isinstance(out, tuple) else (out,))])
                return out
            return text_fn
        for a, name in wrap:
            setattr(pipe, a, timed(name, recorded(saved[a]) if name == "lm"
                                   else saved[a]))
        reset_counts()
        reset_pads()
        seen.clear()
        split.clear()
        t0 = time.perf_counter()
        try:
            paths = svc.generate(request)
        finally:
            for a, fn in saved.items():
                setattr(pipe, a, fn)
        req_s = time.perf_counter() - t0
        ok = (len(paths) == 1 and paths[0].endswith(".png")
              and media.read_image(paths[0]).shape == (h, w, 3)
              and seen and seen[0]["finite"] and seen[0]["shape"] == [h, w, 3]
              and media.read_image_metadata(paths[0])["seed"]
              == request["seed"])
        if not ok:
            raise AssertionError(f"{label} request: {paths} {seen}")
        counts = read_counts()
        want = {name: per_forward.get(name, 0) * steps for name in counts}
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        if read_pads():
            raise AssertionError(f"{label}: {read_pads()} launches padded "
                                 "or copied their operands")
        out = {"request_s": req_s, **split,
               "step_s": split["denoise_s"] / steps, "steps": steps,
               "bytes": os.path.getsize(paths[0]), "text_states": texts,
               "launches": counts, "launches_per_forward": per_forward}
        os.remove(paths[0])
        if release:
            svc.release_model()
            torch.cuda.empty_cache()
        return out

    def run_p():
        """(P): qwen_image_20B (all P_LAYERS = 60 blocks of 3072, 20.4 B
        parameters) from its files at 1280x720,
        guidance 4 (true CFG as batch 2), STEPS steps: the DiT random on
        the card (bf16), exported block by block to a host quanto-int8
        state dict in the reference names (the
        definition's second URL's layout: every block linear int8, the
        modulations among them) and freed; the Qwen2.5-VL-7B text tower
        (28 layers, width 3584, qkv bias) likewise in HF names; the image
        VAE as qwen_vae.safetensors.  A flash, 12 W8 and 2 fp32 GEMV
        launches a forward; the prompt's states [1, 1,024, 3,584] (the
        template's 34-token prefix dropped), so L = S = 4,624."""
        from wan2gp_tpu_torch.families import qwen as qfam
        from wan2gp_tpu_torch.io import qwen_checkpoint as qck
        from wan2gp_tpu_torch.lora import HostArena
        from wan2gp_tpu_torch.models.qwen import text_encoder as qlm
        from wan2gp_tpu_torch.models.qwen.dit import (QwenImageConfig,
                                                      init_qwen_image)
        from wan2gp_tpu_torch.models.wan.vae import (WanVAEConfig,
                                                     init_wan_vae)
        gen = torch.Generator(device="cuda")
        vcfg = WanVAEConfig()
        vae_sd = vae_state_dict(init_wan_vae(gen.manual_seed(51), vcfg),
                                vcfg)

        def build(gen_, clock):
            cfg = QwenImageConfig(num_layers=P_LAYERS)
            t0 = time.perf_counter()
            params = init_qwen_image(gen_.manual_seed(52), cfg,
                                     torch.bfloat16)
            clock("dit_init_s", t0)
            t0 = time.perf_counter()

            def part(**kw):
                return qck.qwen_image_state_dict(params, cfg, quanto=True,
                                                 **kw)
            rest, first = part(layers=()), part(layers=[0], rest=False)
            arena = HostArena([*rest.values(), *first.values()]
                              + [*first.values()] * (cfg.num_layers - 1),
                              pin=True)
            sd = {k: arena.put(v) for k, v in {**rest, **first}.items()}
            del rest, first
            for i in range(1, cfg.num_layers):
                sd.update({k: arena.put(v) for k, v in
                           part(layers=[i], rest=False).items()})
            clock("dit_export_s", t0)
            del params
            return sd, arena, cfg, lambda tree: qck.qwen_image_state_dict(
                tree, cfg, layers=(0, cfg.num_layers - 1))
        arch = qfam._ARCH
        qfam._ARCH = {**arch, "num_layers": P_LAYERS}
        try:
            svc, pipe, rec = from_host_files(
                "(P)", "qwen_image_20B", gen, build, qlm.QWEN25_VL_7B_TEXT,
                "qwen_vae.safetensors", vae_sd, quantization="int8")
        finally:
            qfam._ARCH = arch
        del vae_sd
        # the text tower's file has no recorded public name: the resolver
        # names it
        want = {"transformer": "qwen_image_20B_quanto_bf16_int8.safetensors",
                "vae": "qwen_vae.safetensors"}
        if rec["roles"] != want:
            raise AssertionError(f"(P): the roles' files {rec['roles']}")
        req = one_image("(P)", svc, pipe, {
            "model_type": "qwen_image_20B", "prompt": "a red fox 0",
            "resolution": f"{P_W}x{P_H}", "num_inference_steps": STEPS,
            "guidance_scale": 4.0, "seed": 0}, P_W, P_H, P_KERNELS)
        if req["text_states"] != [[[1, P_TXT, 3584], [1, P_TXT, 3584]]]:
            raise AssertionError(f"(P): text states {req['text_states']}")
        del svc, pipe
        torch.cuda.empty_cache()
        return {"label": "(P) qwen_image_20B 1280x720 from its files: the "
                         "quanto-int8 DiT and the Qwen2.5-VL-7B tower "
                         "through pinned host state dicts, the image VAE "
                         "file", "model": "qwen_image_20B",
                "resolution": f"{P_W}x{P_H}", "layers": P_LAYERS,
                "tokens": P_TOKENS, "image_tokens": P_IMG,
                "text_slots": P_TXT, "guidance_scale": 4.0, "steps": STEPS,
                **rec, "request": req}

    def flux_timers():
        """Times the Flux pipelines' denoise (pi-Flow's sampler too),
        FLUX.1 decode and reference encode; returns the undo."""
        from wan2gp_tpu_torch.models.flux import pipeline as fpipe
        real = (fpipe.flux_denoise, fpipe.flux_vae_decode,
                fpipe.flux_vae_encode, fpipe.FluxPipeline._piflow)
        fpipe.flux_denoise = timed("denoise", real[0])
        fpipe.flux_vae_decode = timed("decode", real[1])
        fpipe.flux_vae_encode = timed("encode", real[2])
        fpipe.FluxPipeline._piflow = timed("denoise", real[3])

        def undo():
            (fpipe.flux_denoise, fpipe.flux_vae_decode,
             fpipe.flux_vae_encode, fpipe.FluxPipeline._piflow) = real
        return undo

    def run_r():
        """(R): flux2_klein_9b (FLUX.2 Klein 9B: 8 double + 24 single
        blocks of 4096, 32 heads, 9.1 B parameters) from its files at
        1024x1024 and the definition's 4 steps, bf16, guidance 1 (batch
        1): the DiT random on the card, exported to a pinned host state
        dict in BFL names (bf16) and freed; the Qwen3 tower at the JAX
        handler's width (4,096 = 12,288 / 3, Qwen3-4B's other widths)
        likewise in HF names; the FLUX.2 VAE (32 latent channels, its quant
        convs and BatchNorm statistics) as flux2_vae.safetensors; all three
        through the resolver and the handler's loaders (the loaded DiT's
        first and last blocks and outer keys re-exported equal to the state
        dict).  The prompt's hidden layers 9, 18 and 27 over 512 tokens,
        [1, 512, 12,288] (asserted), so the joint attention runs at L = S
        = 4,608: 32 flash launches a forward."""
        from wan2gp_tpu_torch.families import flux as ffam
        from wan2gp_tpu_torch.io import flux_checkpoint as fck
        from wan2gp_tpu_torch.lora import HostArena
        from wan2gp_tpu_torch.models.flux import dit as fdit
        from wan2gp_tpu_torch.models.flux import vae as fvae
        from wan2gp_tpu_torch.models.qwen import text_encoder as qlm
        handler = ffam.FluxFamilyHandler
        gen = torch.Generator(device="cuda")
        vae_sd = flux2_vae_state_dict(fvae.init_flux_vae(
            gen.manual_seed(71), fvae.FluxVAEConfig(z_channels=32)), gen)

        def build(gen_, clock):
            cfg = handler.dit_config("flux2_klein_9b")
            t0 = time.perf_counter()
            params = fdit.init_flux(gen_.manual_seed(72), cfg)
            clock("dit_init_s", t0)
            t0 = time.perf_counter()
            arena = HostArena(list(_leaves(params)), pin=True)
            sd = {k: arena.put(v.to(torch.bfloat16))
                  for k, v in fck.flux_state_dict(params, cfg).items()}
            clock("dit_export_s", t0)
            del params
            return sd, arena, cfg, lambda tree: flux_ends_state_dict(tree,
                                                                     cfg)
        cfg = handler.dit_config("flux2_klein_9b")
        lm_arch = {**qlm.QWEN3_4B, "dim": cfg.context_in_dim // 3}
        svc, pipe, rec = from_host_files(
            "(R)", "flux2_klein_9b", gen, build, lm_arch,
            "flux2_vae.safetensors", vae_sd)
        del vae_sd
        want = {"transformer": "flux-2-klein-9b.safetensors",
                "vae": "flux2_vae.safetensors"}
        if rec["roles"] != want:
            raise AssertionError(f"(R): the roles' files {rec['roles']}")
        steps = svc.registry.default_settings("flux2_klein_9b")[
            "num_inference_steps"]
        if steps != R_STEPS:
            raise AssertionError(f"(R): the definition's steps {steps}")
        undo = flux_timers()
        try:
            req = one_image("(R)", svc, pipe, {
                "model_type": "flux2_klein_9b", "prompt": "a red fox 0",
                "resolution": f"{R_W}x{R_H}", "seed": 0}, R_W, R_H,
                R_KERNELS, R_STEPS, wrap=(("t5_encode_fn", "lm"),))
        finally:
            undo()
        if req["text_states"] != [[[1, R_TXT, 3 * lm_arch["dim"]]]]:
            raise AssertionError(f"(R): text states {req['text_states']}")
        del svc, pipe
        torch.cuda.empty_cache()
        return {"label": "(R) flux2_klein_9b 1024x1024 from its files: the "
                         "bf16 DiT and the Qwen3 tower (4,096 wide) "
                         "through pinned host state dicts, the FLUX.2 VAE "
                         "file", "model": "flux2_klein_9b",
                "resolution": f"{R_W}x{R_H}", "layers": "8 + 24",
                "tokens": R_TOKENS, "text_slots": R_TXT,
                "embedded_guidance_scale": 1, **rec, "request": req}

    def run_s():
        """(S): flux_dev_kontext (FLUX.1 Kontext dev: 19 double + 38
        single blocks of 3072, 11.9 B parameters) at 1024x1024 with one
        1024x1024 reference image, quantize="int8", STEPS of its 25 steps:
        the DiT random on the card, exported to a pinned host state dict
        in BFL names (bf16) and freed, the AE as flux_vae.safetensors;
        both through the resolver and the handler's loaders (the loaded
        DiT's ends equal to the state dict before the service quantizes
        it); a full-size random T5 v1.1 XXL encodes the prompt's 512 hash
        ids into `_context`, a random CLIP vector is `_vec_y`.  The
        reference is VAE-encoded to 128 x 128 latents (asserted) and packed
        after the noise tokens: L = S = 8,704; 57 flash, 228 W8 and 76 fp32
        GEMV launches a forward.  Then USO on the same DiT: SigLIP so400m
        and the projector written as bf16 files and read back by the
        handler's loader (equal to the written tensors), one 512x512 style
        image through the service's flux_dev_uso row: 768 style tokens
        (asserted) before the text, the same launches."""
        from wan2gp_tpu_torch.families import flux as ffam
        from wan2gp_tpu_torch.io import flux_checkpoint as fck
        from wan2gp_tpu_torch.io import safetensors_reader as st
        from wan2gp_tpu_torch.lora import HostArena
        from wan2gp_tpu_torch.models.flux import dit as fdit
        from wan2gp_tpu_torch.models.flux import siglip as fsig
        from wan2gp_tpu_torch.models.flux import vae as fvae
        from wan2gp_tpu_torch.models.wan import t5
        handler = ffam.FluxFamilyHandler
        bf16 = torch.bfloat16
        prompt = "make the fox wear a red scarf"
        gen = torch.Generator(device="cuda")
        out, times = {}, {}

        def clock(name, t0):
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
        ckdir = os.path.join(OUT, "ckpts_flux_dev_kontext")
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        tcfg = t5.T5Config(**handler.T5_CFG_KW)
        t0 = time.perf_counter()
        tp = t5.init_t5_encoder(gen.manual_seed(81), tcfg)
        ids, mask = ffam._tokenizer(None, tcfg.vocab_size)(
            [prompt], handler.text_seq_len("flux_dev_kontext"))
        ctx = t5.t5_encode(tp, tcfg, torch.from_numpy(ids),
                           torch.from_numpy(mask)).float()
        clock("t5_s", t0)
        if tuple(ctx.shape) != (1, S_TXT, 4096):
            raise AssertionError(f"(S) T5: {tuple(ctx.shape)}")
        del tp
        vec_y = torch.randn((1, 768), generator=gen, device="cuda")
        cfg = handler.dit_config("flux_dev_kontext")
        t0 = time.perf_counter()
        params = fdit.init_flux(gen.manual_seed(82), cfg)
        clock("dit_init_s", t0)
        t0 = time.perf_counter()
        arena = HostArena(list(_leaves(params)), pin=True)
        sd = {k: arena.put(v.to(bf16))
              for k, v in fck.flux_state_dict(params, cfg).items()}
        clock("dit_export_s", t0)
        del params
        torch.cuda.empty_cache()
        vae_path = os.path.join(ckdir, "flux_vae.safetensors")
        st.save_safetensors(vae_path, {
            k: v.to(bf16) for k, v in fck.flux_vae_state_dict(
                fvae.init_flux_vae(gen.manual_seed(83),
                                   fvae.FluxVAEConfig())).items()})
        mem = {"memory:transformer": sd}
        real_load, real_quantize = st.load_weights, svc_mod.quantize_dit_params
        checked = []

        def quantize_checked(tree, mode):
            for k, v in flux_ends_state_dict(tree, cfg).items():
                if not torch.equal(v.cpu(), sd[k]):
                    raise AssertionError(f"(S) {k}: not the exported tensor")
            checked.append(mode)
            return real_quantize(tree, mode)
        st.load_weights = lambda path: mem[path] if path in mem \
            else real_load(path)
        svc_mod.quantize_dit_params = quantize_checked
        svc = svc_mod.GenerationService(
            output_dir=out_dir, quantize="int8",
            checkpoints_resolver=lambda *a: {
                "transformer": "memory:transformer", "vae": vae_path})
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe = svc.get_pipeline("flux_dev_kontext")
            clock("load_s", t0)
        finally:
            st.load_weights, svc_mod.quantize_dit_params = (real_load,
                                                            real_quantize)
        if checked != ["int8"]:
            raise AssertionError(f"(S): quantized {checked}")
        out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["parameters"] = sum(v.numel() for v in sd.values())
        del sd, mem, arena
        torch._C._host_emptyCache()
        yy, xx = np.meshgrid(np.linspace(0, 1, S_H), np.linspace(0, 1, S_W),
                             indexing="ij")
        ref = (np.stack([xx, yy, xx * yy], -1) * 255).astype(np.uint8)
        encoded = []
        undo = flux_timers()
        from wan2gp_tpu_torch.models.flux import pipeline as fpipe
        enc = fpipe.flux_vae_encode
        fpipe.flux_vae_encode = lambda *a: encoded.append(
            list((z := enc(*a)).shape)) or z
        real_sig = fsig.siglip_forward, fsig.uso_project
        styles = []
        try:
            req = one_image("(S)", svc, pipe, {
                "model_type": "flux_dev_kontext", "prompt": prompt,
                "resolution": f"{S_W}x{S_H}", "num_inference_steps": STEPS,
                "seed": 0, "image_refs": [ref], "_context": ctx,
                "_vec_y": vec_y}, S_W, S_H, S_KERNELS, wrap=(),
                release=False)
            if encoded != [[1, S_H // 8, S_W // 8, 16]]:
                raise AssertionError(f"(S): reference latents {encoded}")
            req["reference_latents"] = encoded[0]
            out["request"] = req
            # USO on the same DiT: the tower and projector from bf16 files
            paths = {"siglip": os.path.join(
                ckdir, "siglip-so400m-patch14-384.safetensors"),
                "module": os.path.join(ckdir, "uso_projector.safetensors")}
            scfg = fsig.SiglipVisionConfig()
            t0 = time.perf_counter()
            sp = fsig.init_siglip(gen.manual_seed(84), scfg)
            proj = fsig.init_uso_projector(gen.manual_seed(85))
            st.save_safetensors(paths["siglip"], fsig.siglip_state_dict(
                sp, scfg, dtype=bf16))
            st.save_safetensors(paths["module"],
                                fsig.uso_projector_state_dict(proj, bf16))
            clock("uso_write_s", t0)
            t0 = time.perf_counter()
            sig, lcfg, lproj = ffam._uso_parts(paths, False, 0, pipe.dit_cfg,
                                               "cuda")
            clock("uso_load_s", t0)
            for name, got, want in (("siglip", sig, sp),
                                    ("projector", lproj, proj)):
                a, b = dict(_flat(got)), dict(_flat(want))
                if sorted(a) != sorted(b) or not all(
                        torch.equal(a[k], b[k].to(bf16).float())
                        for k in a):
                    raise AssertionError(f"(S) {name}: not the written "
                                         "tensors")
            out["siglip_parameters"] = sum(v.numel() for v in _leaves(sp))
            out["uso_files_bytes"] = {os.path.basename(p): os.path.getsize(p)
                                      for p in paths.values()}
            del sp, proj
            pipe.uso = (sig, lcfg, lproj)
            svc._pipelines["flux_dev_uso"] = pipe
            fsig.siglip_forward = timed("siglip", real_sig[0])
            fsig.uso_project = lambda *a: styles.append(
                list((y := real_sig[1](*a)).shape)) or y
            style = (np.stack([yy, xx, yy * xx], -1)[::2, ::2] * 255).astype(
                np.uint8)
            req = one_image("(S) USO", svc, pipe, {
                "model_type": "flux_dev_uso", "prompt": prompt,
                "resolution": f"{S_W}x{S_H}", "num_inference_steps": STEPS,
                "seed": 1, "image_refs": [style], "_context": ctx,
                "_vec_y": vec_y}, S_W, S_H, S_KERNELS, wrap=())
            if styles != [[1, USO_STYLE, 3072]]:
                raise AssertionError(f"(S) USO: style tokens {styles}")
            req["tokens"] = USO_STYLE + S_TXT + S_IMG // 2
            out["uso_request"] = req
        finally:
            undo()
            fpipe.flux_vae_encode = enc
            fsig.siglip_forward, fsig.uso_project = real_sig
        del svc, pipe
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        return {"label": "(S) flux_dev_kontext 1024x1024 with a 1024x1024 "
                         "reference, int8, the DiT through a pinned host "
                         "state dict; then USO (SigLIP so400m, projector "
                         "from bf16 files) on the same DiT",
                "model": "flux_dev_kontext", "resolution": f"{S_W}x{S_H}",
                "layers": "19 + 38", "tokens": S_TOKENS, "text_slots": S_TXT,
                "quantize": "int8", **times, **out}

    def run_t():
        """(T): flux_chroma, flux_chroma_radiance and pi_flux2 from random
        weights at full width, each cut to T_DOUBLE = 2 double and
        T_SINGLE = 4 single blocks, one STEPS-step request each at
        1024x1024 in bf16: Chroma (its modulation MLP, the FLUX.1 AE
        decode), Chroma-Radiance (pixel space: 64 x 64 patch tokens, the
        head, no VAE), pi-FLUX.2 (FLUX.2 dev, 6144 wide, 48 heads; its
        heads written to a file and read back equal; one mixture
        prediction an outer step and the 128-substep rollout; the FLUX.2
        VAE decode).  6 flash launches a forward."""
        from wan2gp_tpu_torch.families import flux as ffam
        from wan2gp_tpu_torch.io import safetensors_reader as st
        from wan2gp_tpu_torch.models.flux import piflow as fpi
        out = {}
        per = {"flash_attention": T_DOUBLE + T_SINGLE}
        for label, mt in (("Chroma", "flux_chroma"),
                          ("Radiance", "flux_chroma_radiance"),
                          ("pi-FLUX.2", "pi_flux2")):
            arch = ffam._ARCH[mt]
            ffam._ARCH[mt] = {**arch, "depth": T_DOUBLE,
                              "depth_single_blocks": T_SINGLE}
            undo = flux_timers()
            try:
                svc = svc_mod.GenerationService(init_random_weights=True,
                                                output_dir=out_dir)
                t0 = time.perf_counter()
                pipe = svc.get_pipeline(mt)
                torch.cuda.synchronize()
                rec = {"init_s": time.perf_counter() - t0}
                if mt == "pi_flux2":
                    path = os.path.join(OUT, "pi_flux2_heads.safetensors")
                    st.save_safetensors(path, fpi.export_piflow_heads(
                        pipe.piflow_heads))
                    heads, left = fpi.load_piflow_heads(
                        st.load_weights(path), device="cuda")
                    a, b = dict(_flat(heads)), dict(_flat(pipe.piflow_heads))
                    if left or sorted(a) != sorted(b) or not all(
                            torch.equal(a[k], b[k]) for k in a):
                        raise AssertionError("(T) pi-Flow heads: not the "
                                             "written tensors")
                    rec["heads_file_bytes"] = os.path.getsize(path)
                    os.remove(path)
                    pipe.piflow_heads = heads
                rec["hidden_size"] = pipe.dit_cfg.hidden_size
                rec["request"] = one_image(
                    f"(T) {label}", svc, pipe, {
                        "model_type": mt, "prompt": "a red fox 0",
                        "resolution": f"{T_W}x{T_H}",
                        "num_inference_steps": STEPS, "seed": 0},
                    T_W, T_H, per, wrap=())
                del svc, pipe
            finally:
                ffam._ARCH[mt] = arch
                undo()
            torch.cuda.empty_cache()
            out[mt] = rec
        return {"label": "(T) Chroma, Chroma-Radiance and pi-FLUX.2 at "
                         "1024x1024 from random weights",
                "layers": f"{T_DOUBLE} + {T_SINGLE} of each model's blocks",
                **out}

    def run_q():
        """(Q): z_image (Z-Image Turbo: dim 3840, 30 heads, 30 + 2 + 2
        blocks, 6.15 B parameters) from its files at 1024x1024, guidance 0
        (batch 1), STEPS of its 8 unified steps: the DiT random on the
        card (bf16), exported block by block to a host state dict in the
        reference names and freed; the Qwen3-4B tower likewise in HF
        names; the Flux.1 AE random, written in diffusers' AutoencoderKL
        names as ZImageTurbo_VAE_bf16.safetensors and read back through
        normalize_diffusers_vae_sd.  34 flash launches a forward; the
        prompt's states [1, 512, 2,560]."""
        from wan2gp_tpu_torch.io import flux_checkpoint as fck
        from wan2gp_tpu_torch.io import zimage_checkpoint as zck
        from wan2gp_tpu_torch.lora import HostArena
        from wan2gp_tpu_torch.models.flux.vae import (FluxVAEConfig,
                                                      init_flux_vae)
        from wan2gp_tpu_torch.models.qwen import text_encoder as qlm
        from wan2gp_tpu_torch.models.zimage.dit import (ZImageConfig,
                                                        init_zimage)
        gen = torch.Generator(device="cuda")
        vae_sd = fck.flux_vae_diffusers_state_dict(init_flux_vae(
            gen.manual_seed(61), FluxVAEConfig()))

        def build(gen_, clock):
            cfg = ZImageConfig()
            t0 = time.perf_counter()
            params = init_zimage(gen_.manual_seed(62), cfg, torch.bfloat16)
            clock("dit_init_s", t0)
            t0 = time.perf_counter()
            arena = HostArena(list(_leaves(params)), pin=True)
            sd = {k: arena.put(v) for k, v in
                  zck.zimage_state_dict(params, cfg, layers=()).items()}
            for i in range(cfg.n_layers):
                sd.update({k: arena.put(v) for k, v in zck.zimage_state_dict(
                    params, cfg, layers=[i], rest=False).items()})
            clock("dit_export_s", t0)
            del params
            return sd, arena, cfg, lambda tree: zck.zimage_state_dict(
                tree, cfg, layers=(0, cfg.n_layers - 1))
        svc, pipe, rec = from_host_files(
            "(Q)", "z_image", gen, build, qlm.QWEN3_4B,
            "ZImageTurbo_VAE_bf16.safetensors", vae_sd)
        del vae_sd
        want = {"transformer": "ZImageTurbo_bf16.safetensors",
                "text_encoder": "Qwen3-4B_bf16.safetensors",
                "vae": "ZImageTurbo_VAE_bf16.safetensors"}
        if rec["roles"] != want:
            raise AssertionError(f"(Q): the roles' files {rec['roles']}")
        req = one_image("(Q)", svc, pipe, {
            "model_type": "z_image", "prompt": "a red fox 0",
            "resolution": f"{Q_W}x{Q_H}", "num_inference_steps": STEPS,
            "seed": 0}, Q_W, Q_H, Q_KERNELS)
        if req["text_states"] != [[[1, Q_TXT, 2560]]]:
            raise AssertionError(f"(Q): text states {req['text_states']}")
        del svc, pipe
        torch.cuda.empty_cache()
        return {"label": "(Q) z_image 1024x1024 from its files: the bf16 "
                         "DiT and the Qwen3-4B tower through pinned host "
                         "state dicts, the diffusers-format VAE file",
                "model": "z_image", "resolution": f"{Q_W}x{Q_H}",
                "layers": "30 + 2 noise-refiner + 2 context-refiner",
                "tokens": Q_TXT + Q_IMG, "image_tokens": Q_IMG,
                "text_slots": Q_TXT, "guidance_scale": 0, "steps": STEPS,
                "solver": "unified", **rec, "request": req}

    path_s = {}

    class Clocked(dict):
        """The results; path_s gets each path's wall seconds, from the end
        of the path before (or the phase's start) to its result."""
        mark = time.perf_counter()

        def __setitem__(self, key, value):
            now = time.perf_counter()
            path_s[key] = now - self.mark
            self.mark = now
            super().__setitem__(key, value)

    results = Clocked()
    try:
        h, w = 480, 832
        results["bf16"] = run("1.3B bf16", "t2v_1.3B", "", "auto", 2, w, h,
                              30, {"flash_attention": 60})
        results["int8"] = run("1.3B int8", "t2v_1.3B", "int8", "auto", 1, w,
                              h, 30, {"flash_attention": 60,
                                      "matmul_w8": 300})
        # A8: 10 products a layer from 7 quantizations (q, k and v share
        # one, cross k and v another)
        results["int8a8"] = run("1.3B int8a8", "t2v_1.3B", "int8a8", "auto",
                                1, w, h, 30, {"flash_attention": 60,
                                              "matmul_w8a8": 300,
                                              "act_quant": 210})
        # 14B at 1280x720: (A) at A_LAYERS, (C) on (A)'s pipeline; (B)
        results["14B_int4a8_sol"] = run(
            "14B int4a8 sol", "t2v", "int4a8", "sol", 1, 1280, 720,
            A_LAYERS, dict(A_KERNELS), after=run_c)
        results["14B_int4_radial"] = run(
            "14B int4 radial", "t2v", "int4", "radial", 1, 1280, 720,
            B_LAYERS, {"sparse_flash": B_LAYERS, "flash_attention": B_LAYERS,
                       "matmul_w4": 10 * B_LAYERS})
        results["14B_bf16_lora_N"] = run_n()
        results["krea2_raw_O"] = run_o()
        results["qwen_image_P"] = run_p()
        results["z_image_Q"] = run_q()
        results["flux2_klein_9b_R"] = run_r()
        results["flux_dev_kontext_S"] = run_s()
        results["flux_T"] = run_t()
        results["1.3B_checkpoint_D"] = run_d()
        results["1.3B_sliding_E"] = run_e()
        source = results["1.3B_sliding_E"].pop("path")
        results["1.3B_continue_H"] = run_h(source)
        os.remove(source)
        # the image of (F) and (G), at another size than either request
        png = os.path.join(OUT, "image_start.png")
        yy, xx = np.meshgrid(np.linspace(0, 1, 360), np.linspace(0, 1, 640),
                             indexing="ij")
        real_save_image((np.stack([xx, yy, xx * yy], -1) * 2 - 1)
                        .astype(np.float32), png)
        # a self, a text cross and an image cross flash a layer
        results["14B_i2v_F"] = run(
            "(F) 14B i2v", "i2v", "", "auto", 1, 832, 480, F_LAYERS,
            {"flash_attention": 3 * F_LAYERS}, settings={"image_start": png})
        results["14B_i2v_2_2_G"] = run_g(png)
        os.remove(png)
        results["5B_ti2v_I"] = run_i()
        results["14B_vace_multitalk_J"] = run_j()
        results["flux_schnell_K"] = run_k(out_dir, timed, split, seen)
        results["hv15_t2v_L"] = run_l(out_dir, timed, split, seen)
        results["ltx2_22B_distilled_M"] = run_m(out_dir, timed, split, seen)
        results["hunyuan_U"] = run_u(out_dir, timed, split, seen)
        results["hunyuan_rows_V"] = run_v(out_dir, timed, split, seen)
    finally:
        media.save_video, media.save_image = real_save, real_save_image
        pipe_mod.wan_dit_forward = real_forward
        WanPipeline.denoise, WanPipeline.decode = real_denoise, real_decode
        WanPipeline.encode_video = real_encode
        pipe_mod.clip_vision_encode = real_clip
        pipe_mod.multitalk_denoise = real_multitalk
        krea2_pipe.krea2_denoise = real_krea2_denoise
        qwen_pipe.qwen_denoise = real_qwen_denoise
        zimage_pipe.zimage_denoise = real_zimage_denoise
    emit("service", frames=frames, latent_frames=(frames - 1) // 4 + 1,
         steps=STEPS, guidance_scale=5.0, solver="unipc",
         b_layers=f"14B (B) runs {B_LAYERS} of 40 layers",
         depth_cuts={"A and C": f"{A_LAYERS} of 40 layers (cut from 30)",
                     "B": f"{B_LAYERS} of 40 layers (cut from 10)",
                     "F": f"{F_LAYERS} of 40 layers (cut from 20)",
                     "G": f"{G_LAYERS} of each expert's 40 layers (cut "
                          "from 10)",
                     "J": f"{J_LAYERS} of 40 layers (cut from 10)",
                     "N": f"{N_LAYERS} of 40 layers (cut from 20)",
                     "L": f"{L_LAYERS} of 54 double blocks (cut from 27)",
                     "M": f"{M_LAYERS} of 48 blocks (cut from 24)",
                     "K": f"{K_DOUBLE} + {K_SINGLE} of 19 + 38 blocks (cut "
                          "from 10 + 19)",
                     "T": f"{T_DOUBLE} double + {T_SINGLE} single blocks "
                          "of each model's"},
         path_s=path_s, **results)
    return results


def phase_t5():
    from wan2gp_tpu_torch.models.wan import t5
    from wan2gp_tpu_torch.utils.tokenizer import load_tokenizer
    cfg = t5.T5Config()
    t0 = time.perf_counter()
    params = t5.init_t5_encoder(torch.Generator(device="cuda").manual_seed(0),
                                cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids, mask = load_tokenizer(None)(["a red fox runs through the snow"],
                                     512)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    t5.t5_encode(params, cfg, ids, mask)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = t5.t5_encode(params, cfg, ids, mask)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(out).all())
    if tuple(out.shape) != (1, 512, 4096) or not finite:
        raise AssertionError(f"t5: shape {tuple(out.shape)} finite {finite}")
    emit("t5", config="UMT5-XXL 24 layers, dim 4096, 64 heads, ffn 10240, "
         "vocab 256384 (random weights)", shape=list(out.shape),
         finite=finite, init_s=init_s, encode_s=encode_s,
         params=sum(v.numel() for v in _leaves(params)))
    del params, out
    torch.cuda.empty_cache()


WRITTEN = {"bytes": 0, "files": 0}


def count_writes():
    """Wraps the writers the paths use (safetensors, AVI, PNG, WAV) to add
    up the bytes the script writes, files deleted later included."""
    from wan2gp_tpu_torch.io import safetensors_reader as st
    from wan2gp_tpu_torch.utils import media

    def wrap(mod, name):
        real = getattr(mod, name)

        def counted(*a, **kw):
            out = real(*a, **kw)
            path = out if isinstance(out, str) else kw.get("path", a[0])
            WRITTEN["bytes"] += os.path.getsize(path)
            WRITTEN["files"] += 1
            return out
        setattr(mod, name, counted)
    wrap(st, "save_safetensors")
    for name in ("save_video", "save_image", "save_audio"):
        wrap(media, name)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=81,
                    help="frames per service request (81 = 32,760 tokens)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    count_writes()
    phase_env()
    checks = phase_check()
    dit_launches = phase_dit()
    tokens = ((args.frames - 1) // 4 + 1) * 30 * 52
    times = phase_time(tokens)
    svc = phase_service(args.frames)
    phase_t5()
    # (kernel, source, replaced TPU kernel, service run that counts its
    # launches, the timed case in the kernels line)
    table = (
        ("flash_attention", "flash_attention.cu",
         "wan2gp_tpu/ops/attention.py:33", "bf16", "self_1.3B"),
        ("flash_attention_kvmask", "flash_attention.cu",
         "wan2gp_tpu/ops/attention.py:79", "krea2_raw_O", "self_krea2_O"),
        ("matmul_w8", "w8_matmul.cu", "wan2gp_tpu/ops/quant.py:32", "int8",
         "1536x8960"),
        ("matmul_w8a8", "w8_matmul.cu", "wan2gp_tpu/ops/quant.py:239",
         "int8a8", "1536x8960"),
        ("sparse_flash", "sparse_flash.cu",
         "wan2gp_tpu/ops/sparse_attention.py:179", "14B_int4_radial",
         "radial_720p"),
        ("sol_flash", "sparse_flash.cu",
         "wan2gp_tpu/ops/sol_attention.py:166", "14B_int4a8_sol",
         "sol_720p"),
        ("matmul_w4", "w4_matmul.cu", "wan2gp_tpu/ops/quant.py:127",
         "14B_int4_radial", "151200x5120x13824"),
        ("matmul_w4a8", "w4_matmul.cu", "wan2gp_tpu/ops/quant.py:304",
         "14B_int4a8_sol", "151200x5120x13824"),
        ("act_quant", "act_quant.cu",
         "wan2gp_tpu/ops/quant.py:222 quantize_act_int8 (XLA; the JAX "
         "package has no Pallas kernel for it)", "14B_int4a8_sol",
         "151200x13824"),
        ("matmul_w8_gemv", "wo_gemv.cu",
         "wan2gp_tpu/ops/quant.py:32 (_w8_kernel on fp32 x)",
         "flux_schnell_K", "1x3072x18432"),
        ("matmul_w4_gemv", "wo_gemv.cu",
         "wan2gp_tpu/ops/quant.py:127 (_w4_kernel on fp32 x)",
         "flux_schnell_K", "1x3072x18432"),
        ("matmul_w8_f32", "wo_f32_matmul.cu",
         "wan2gp_tpu/ops/quant.py:32 (_w8_kernel on fp32 x, M > 16)",
         "ltx2_22B_distilled_M", f"{M_GRID[0]}x4096x36864"),
        # no service path runs W4 on fp32 x above 16 rows: its launches are
        # those of phase 3's int4 LTX-2 forward
        ("matmul_w4_f32", "wo_f32_matmul.cu",
         "wan2gp_tpu/ops/quant.py:127 (_w4_kernel on fp32 x, M > 16)",
         "ltx2_int4", f"{M_GRID[0]}x4096x36864"),
    )
    svc = {**svc, **{k: {"launches": v} for k, v in dit_launches.items()}}
    kernels = []
    for name, src, replaces, run, case in table:
        # errors over every case of the check and time phases
        errs = [*checks[name].values(),
                *(t["err"] for t in times[name].values())]
        timed = {k: v for k, v in times[name][case].items()
                 if k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "library_call")}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"wan2gp_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": svc[run]["launches"][name],
            "max_abs_err": max(e["max_abs"] for e in errs),
            "check": "pass", **timed})
    emit("disk", written_bytes=WRITTEN["bytes"],
         written_gb=WRITTEN["bytes"] / 1e9, files=WRITTEN["files"])
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
