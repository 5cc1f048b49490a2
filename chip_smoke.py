# SPDX-License-Identifier: Apache-2.0
"""Chip smoke test of hqq_tpu_torch: HQQ Llama-2-7B on one GPU, ten ways, the
RMSNorm families (Gemma-2-9B through the server), the LayerNorm families
(Falcon-7B through the server), the MoE families (Mixtral-8x7B through
the server), DeepSeek-V3 (Moonlight-16B-A3B through the server,
DeepSeek-V3's own width at 5 layers) and vision-language serving
(LLaVA-1.5-7B through the server with images, Qwen2-VL-7B through
`engine/vl` and the M-RoPE dense engine), Aria (`engine/vl` and the dense
engine at full width) and ViT-L/16 (`engine/vision`), and HQQ+'s sub-word
groups (Llama-2-7B at 2-bit g8 through the server and with adapters
through Generator).

    python3 chip_smoke.py            # on cuda:0, every phase
    python3 chip_smoke.py --time quant_matmul 512 4096 4096      # one kernel
    python3 chip_smoke.py --time quant_matmul_ax0 512 4096 4096 3-64-fp32  # nbits-g-meta
    python3 chip_smoke.py --time quant_matmul_ax0 512 4096 4096 3-64-fp32 element-stores
    python3 chip_smoke.py --time qmm_fp32 512 4096 4096          # fp32 x; [RANK | NBITS-G-META]
    python3 chip_smoke.py --time w4a8_matmul 4 4096 11008 2-8-fp32 no-fold  # axis=1; [VARIANT]
    python3 chip_smoke.py --time dequant_canonical 1 11008 4096 3-64-fp32  # W [N, K]; M unused
    python3 chip_smoke.py --time paged_attention 8 1024 32 32 int8  # slots, length, heads, kv
                                                                    # heads[, bf16 | int8 pages]
    python3 chip_smoke.py --time flash_attention 1 1023 32 32    # batch, T, heads, kv heads
    python3 chip_smoke.py --time flash_attention_backward_dkv 1 1024 32 32   # or _dq, _fp32
    python3 chip_smoke.py --time flash_attention_backward_dq 1 1024 32 32-128-fp32  # KV-HD-TYPE
    python3 chip_smoke.py --time flash_attention_backward_dkv_fp32 1 512 8 8-256 no-swap
    python3 chip_smoke.py --time layer_norm 1024 4544 4544 bf16  # rows, d, d, type; or rms_norm
    python3 chip_smoke.py --ids          # phase g's greedy ids, to compare two checkouts
    python3 chip_smoke.py --windows      # verify-window rows against decode steps' logits
    python3 chip_smoke.py --norm         # the rms_norm and layer_norm kernels, PyTorch's sums
    python3 chip_smoke.py --phase k      # path K alone, after phase b's grouped-kernel rows
    python3 chip_smoke.py --phase p      # path P alone, after phase b's rows at its shapes
    python3 chip_smoke.py --phase n      # path N alone, after phase b's rows at its shapes
    python3 chip_smoke.py --phase t      # path T alone, after phase b's rows at its shapes
    python3 chip_smoke.py --phase u      # path U alone, after phase b's rows of its routes

Phases (any failure exits non-zero):
  (a) device and build: the card, its power limit, an nvcc build of every
      kernel under hqq_tpu_torch/csrc/ (seconds per source, registers and
      spill stores of each kernel instantiation of the eight wgmma sources
      and of paged_attention), the wgmma (HGMMA) and TMA (UTMALDG)
      instructions in the SASS of those eight (quant_matmul,
      quant_matmul_ax0, quant_matmul_lora, qmm_fp32, flash_prefill,
      flash_fp32_sm90, flash_backward_sm90, flash_backward_fp32_sm90), the
      bulk copies (UBLKCP) of paged_attention, and the int8 MMAs (IMMA) and
      TMA loads of w4a8_matmul; the instantiations of w4a8_matmul and dequant
      must not spill;
  (b) each kernel against its plain PyTorch version at the main paths'
      shapes: largest error against the stated tolerance, kernel time, plain
      time, the least time the card could take (bound), and for the matmuls
      torch.matmul on the pre-dequantized bf16 weight (a yardstick only; for
      the LoRA kernels the sum of the three torch.matmul calls; the w4a8
      kernels at M = 1, 4, 8, 32 on fp32 and bf16 scale and zs, three runs
      bit-equal, controls a neighbour's scale and, for bf16, the zs offset
      dropped; for the two
      attention kernels scaled_dot_product_attention, on the gathered dense
      K/V for the paged one); the axis=1 kernels on bf16 scale and zs, and
      the fp32 routes (qmm_fp32, flash_attention_fp32), each with controls
      that must miss its bar (a neighbour's scale, the 4-bit zs offset
      dropped; the inputs rounded to bf16; one TF32 product, torch.matmul
      with TF32 allowed, for qmm_fp32 and for the plain attention); the
      flash backward kernels (dK/dV
      and dQ) at path I's shape and around it, in bf16, fp16 and fp32 (the
      fp32 route at (1, 8/8, 512), path I's (1, 32/32, 1024), GQA
      (1, 32/8, 1023), and (1, 8/8, 512) at head size 256, on the CUDA
      cores by the plan), against the plain backward from the same saved
      statistics and autograd of the plain forward in fp32, controls (D
      dropped, the mask shifted by one; for fp32 also one TF32 product, the
      plain backward with TF32 allowed), repeated runs bit-equal, SDPA's
      backward as the yardstick; the forward with and without its
      log-sum-exp; the dequant kernel's three entries bit-equal to their
      plain twins, with controls, three runs bit-equal, ms against the byte
      bound: the kernel layouts at 4096 x 11008 (fp32 and bf16 meta, axis=0
      2-bit g16) and the canonical QTensor at path I's three shapes, 2-bit
      g16 axis=0, 3-bit g64, bf16 meta and meta-quantized (the control c*s
      - z*s in place of (c - z)*s);
  (c) the main path: Llama-2-7B at full width and depth with random weights
      from a seed, quantize_model(4-bit, g64), prepare_for_inference("w4a8"),
      generate for 4 prompts of 100 tokens (prefill M = 4*128 = 512 rows),
      one sampled request of batch 1, and .dequantize() of a prepared layer;
      every kernel's launch count must move. The launch window runs the
      decode loop eagerly (compile_mode "partial"); then the same generates
      as a replayed CUDA graph ("full", the default): greedy ids equal,
      the launches recorded into each graph equal a partial decode step's,
      decode tok/s and the busy share of an 8-token generate in both modes
      (phases e and f likewise);
  (d) end to end, on a 2-layer model at 7B width: prefill logits under
      "pallas" against "xla" on the same quantized weights; four decode
      steps under "w4a8", each w4a8 call held to its plain version on the
      same inputs, and the logits against the same steps through the plain
      version; wrong-meta controls that every bar must catch;
  (e) HQQ+ serving: the 7B model, 4-bit g64, a rank-8 LoRA adapter on every
      linear but lm_head (B random from a seed), "w4a8": prefill through
      quant_matmul_lora, decode through w4a8_lora_matmul. Launch counts,
      prefill ms, tok/s, peak memory; every fused call of a prefill and two
      decode steps against its plain version on the spot; on a 2-layer
      model, logits against the unfused path and the plain versions, with a
      control that must fail every bar: the same adapter with B = 0;
  (f) axis=0 serving: the 7B model, attention 3-bit g64 axis=0, MLP 2-bit
      g16 axis=0, "w4a8": prefill and decode through quant_matmul_ax0, and
      .dequantize() through the dequant kernel. The same measurements and
      checks; the control reads each group's neighbour's scale;
  (g) paged continuous-batching serving, on phase c's model: a
      PagedBatchingEngine of 8 slots over a bf16 pool of 1024 pages of 16
      rows (8 GiB) answers 12 greedy requests of 64-640 prompt tokens and 32
      new ones, so that slots refill; then the same over int8 pages; requests
      that share a 256-token prefix with and without the prefix cache; a
      chunked prefill against an unchunked one; one cancel. Every decode
      step launches paged_attention once per layer. Decode tok/s, step ms
      and its byte bound, the device's busy share, peak memory; some decode
      steps call by call, kernel against plain on the path's own q, pool and
      block table, with controls that must fail the bar (lengths - 1, a page
      of another slot, for int8 a neighbour row's scale); on a 2-layer
      model, the logits of paged decode steps against the dense-cache steps;
  (h) cache-free perplexity evaluation, on the same model: `perplexity` over
      4096 token ids from a seed, windows of 1024 by a stride of 512: 7
      windows of T = 1023, each with 32 flash_attention launches and
      quant_matmul at M = 1023. Seconds per window and the value; one
      window's calls kernel against plain with a control (the mask shifted by
      one); on the 2-layer model, cache=None logits against the dense-cache
      forward, and the perplexity through the kernel against the one through
      its plain version;
  (v) speculative decoding, on the same model: SpeculativeGenerator (k = 4,
      a 100-token prompt, 64 greedy new tokens) with the target itself
      ("perfect") and its first 2 layers ("layer-skip") as drafts, each
      round one replayed CUDA graph: ids against Generator's (a graph too)
      by the near-tie rule (teacher forcing: the plain decode's route run
      on the speculative ids, each of which must be its greedy choice on
      that prefix or lie within NEAR_TIE_BAR of its top logit; a control,
      the ids shifted by one, must fail it), the perfect draft's accepted
      share >= 0.9, the launches recorded into a round's graph equal to an
      eager round's, tok/s beside Generator's, the busy share of 4
      replayed rounds; one sampled request; then SpeculativeBatchingEngine
      (8 slots, max_len 1024) and SpeculativePagedEngine (phase g's pool)
      with the layer-skip draft on 8 of phase g's requests (one cut so
      that its last windows do not fit its pages: the plain-step fallback
      runs), ids against the plain engines, teacher-forced on them, by the
      near-tie rule, every verify step's w4a8 calls at M = 32 and its
      paged_attention launches (4 x 32) counted, tok/s; the launches of
      the speculative runs alone make the phase's window;
  (m) multi-LoRA serving, on the same model: three rank-8 adapters (B from
      seeds 1-3) on every linear but lm_head stacked over the w4a8 base; a
      PagedBatchingEngine answers 6 requests on adapters 0, 1, 2, 0, 1, 2,
      each request's ids bit-equal to a run in which every other slot
      carries another adapter, and the same through an InferenceServer (id
      3 answered 400); tok/s against the bare base's, torch.bmm calls
      (counted by the script: the library product has no launch count) and
      their device time; on a 2-layer model at 7B width each row of a mixed
      batch against that row alone through its adapter's LoRALinear, with
      the control every row on adapter 0;
  (i) HQQ+ LoRA training: the 7B model, 4-bit g64 (the canonical layers,
      "xla"), LoRA r = 8 on the 224 linears, 4 AdamW steps on 1 x 1025 ids
      through causal_lm_loss and make_lora_train_step, then merge_lora. Every
      step launches the flash forward, the dK/dV and the dQ kernel 32 times
      each and the canonical dequant 445 times (each linear's W in its
      forward and again in its backward, but layer 0's q, k and v, whose
      backward never runs), never the plain dequantization; the loss falls;
      step ms, tokens/s, the device's busy share, peak memory, the step's
      device time and the canonical dequant's share of it. On 2-layer
      models at 7B width: the LoRA gradients through the kernels against
      the plain attention backward, in bf16 and in fp32
      (the fp32 forward and the fp32 dK/dV and dQ kernels, 2 launches each,
      and their device time in the step), with the control D dropped; fp32
      HQQ+ serving through qmm_fp32 and flash_attention_fp32 against the
      plain versions, with a bf16 control. On 2 layers at Gemma-7B's widths
      (the `gemma` family, fp32, head size 256): the LoRA gradients through
      causal_lm_loss against the plain attention backward (control D
      dropped), the fp32 backward kernels on their cluster route, 2
      launches each a pass, then two make_lora_train_step steps.
  (q) the README quick start: a 2-layer model at 7B width written as a
      Hugging Face directory (config.json, two shards, the index) by the
      port's safetensors writer and read by
      HQQModelForCausalLM.from_pretrained, every tensor and a 16-token
      forward's logits bit-equal; then C's 32-layer model (seed 0, 4-bit
      g64) through save_quantized and from_quantized (GB and seconds, every
      tensor bit-equal), prepare_for_inference("w4a8") and generate in
      "partial" and "full": greedy ids equal to each other and to phase
      c's (sha1 printed), a sampled request (top_k 20, top_p 0.9, seed 1)
      equal in both modes, on_token fired once a token with the returned
      ids; decode tok/s and busy share in both modes, capture seconds,
      peak memory. The directory is removed at the end, after phase s.
  (s) the one-command server: `hqq_tpu_torch.serve.main` on phase q's
      checkpoint with its defaults (paged engine, w4a8, q/k/v and gate/up
      fused by fuse_for_decode), phase g's pool and a horizon of 8, started
      in-process; a warm-up request, then phase g's 12 requests (64-640
      prompt tokens, 32 new, greedy) from 12 client threads at once over
      http.client, 6 blocking and 6 streamed, and the same window again
      under the profiler; a 13th stream cancelled through /cancel after its
      first chunk; /healthz before and after. Every request's ids must
      equal those of a PagedBatchingEngine on the same tree run in-process,
      streamed chunks must concatenate to the final ids, a decode step
      must make 128 w4a8_matmul launches (224 on the unfused tree of the
      same checkpoint), and each fused layer (qkv_proj, gate_up_proj of the
      first and last layer) is held on the path's own activations against
      its plain twin (phase b's bars and controls) and against the unfused
      layers' kernels side by side. Boot seconds, time to first token (the
      streams), request latency (the blocking requests), tokens/s at the
      client and in-process, busy share, the server's peak memory (boot and
      windows, before the comparison engines are built). Then
      on a 2-layer model at 7B width: `--engine dense --backend int8
      --int8-kv`, 4 requests whose ids equal the in-process
      ContinuousBatchingEngine's and torch._int_mm called in the window
      (counted by the script: the library product has no launch count),
      torch._int_mm's int32 products bit-equal
      to the plain int8 product (control: a neighbour row's weights), and
      the logits of decode steps over the int8 dense cache at per-slot
      positions against the bf16 cache's (control: K scales of one).
      Phase b also times the fused widths, w4a8_matmul at (8, 4096, 12288)
      and (8, 4096, 22016) and quant_matmul at M = 512, beside the summed
      time of their unfused parts.
  (r) the RMSNorm families: Gemma-2-9B at full width, 4 of its 42 layers (R_LAYERS; google/
      gemma-2-9b's config: hidden 3584, ffn 14336, 42 layers, 16/8 heads
      of 256, vocab 256000, window 4096, softcaps 50/30), random bf16
      weights from seed 0, quantize_model(4-bit g64), save_quantized, then
      `serve.main` on the checkpoint with its defaults (paged, w4a8, fused),
      G's pool and a horizon of 8; G's 12 requests from 12 client threads
      (6 streamed), ids equal to an in-process PagedBatchingEngine's on the
      served tree; a decode step makes 168 w4a8_matmul (294 on the
      `--no-fuse` tree), 169 rms_norm and no paged_attention launches
      (every Gemma-2 layer has a softcap: the gather route); decode tok/s against a byte bound that counts the
      tied 256000 x 3584 embedding, busy share, peak memory; Generator on
      the served tree, "partial" and "full" (ids equal, the graphs'
      recorded launches a partial step's). Then one 2-layer model at the
      published width of Mistral-7B-v0.1, granite-3.0-8b, gemma-7b,
      gemma-3-12b (one sliding and one full layer), Phi-3-mini-4k and
      OLMo-2-1124-7B: the checkpoint through save_quantized and
      from_quantized bit-equal, a prefill and 4 decode steps under w4a8
      with every w4a8_matmul, quant_matmul and rms_norm call held to its
      plain twin (2^-7 with a neighbour's scale as the control; the norm
      bit-equal with the offset toggled as the control), and where the
      family has a paged branch, paged decode against the dense cache with
      every paged_attention call held (Gemma-3's full layer at head size
      256, Granite's layers at 128). Phase b times rms_norm at 4, 32 and
      1024 rows of 4096 and 1024 of 3584 with offset 1 against its twin
      (bit-equal; every row normed alone bit-equal to the same row in calls
      of 4, 32 and 1024 rows, where PyTorch's fp32 mean must not be) and
      torch.nn.functional.rms_norm, the w4a8 and quant_matmul kernels at
      Gemma-2-9B's shapes, and paged_attention at 16/8 heads of 256.
  (l) the LayerNorm families: Falcon-7B at full width, 4 of its 32 layers (L_LAYERS)
      (tiiuae/falcon-7b: hidden 4544, 32 layers, 71 heads of 64,
      multi-query, parallel attention from one norm, no bias, vocab 65024,
      tied head), random bf16 weights from seed 0, quantize_model(4-bit
      g64), save_quantized, then `serve.main` on the checkpoint with its
      defaults (w4a8, fused, which leaves Falcon's tree as it is; no paged
      branch: the dense engine of 8 slots) and max_len 2048; G's 12
      requests from 12 client threads (6 streamed), ids equal to an
      in-process ContinuousBatchingEngine's on the served tree; a decode
      step makes 128 w4a8_matmul, 33 layer_norm and 0 rms_norm launches;
      the first and last layer's four linears held on the path's own
      activations at decode and prefill (phase b's bars and controls; K =
      4544, not whole 256-code stages, on a line of its own); decode tok/s
      against a byte bound that counts the tied embedding, busy share, peak
      memory; Generator "partial" and "full". Then one 2-layer model at the
      published widths of starcoder2-7b, phi-2, c4ai-command-r-plus,
      gpt2-xl (K = 1600 on a line of its own), bloom-7b1 and falcon-rw-1b
      (ALiBi), norm weights and biases drawn: the checkpoint through
      save_quantized and from_quantized bit-equal, a prefill and 4 decode
      steps under w4a8 with every w4a8_matmul, quant_matmul and layer_norm
      call held to its plain twin (the norm bit-equal; controls mu left out
      and, but for Cohere's weight-only norm, the bias dropped). Phase b
      holds layer_norm bit-equal to its twin over fp32/bf16/fp16 rows of the
      families' widths with and without a bias and per-head weights, with
      those controls, every row normed alone bit-equal inside calls of 4, 32
      and 1024 rows, and times it at 4, 32 and 1024 rows of 4544 and 4096
      against the byte bound and torch.nn.functional.layer_norm; and the
      w4a8 and quant_matmul kernels at Falcon-7B's shapes.
  (x) the MoE families: Mixtral-8x7B at full width, 2 of its 32 layers
      (X_LAYERS: the depth cut so that the whole script stays inside its
      time with paths P and N; mistralai/Mixtral-8x7B-v0.1 from memory: hidden
      4096, ffn 14336, 32/8 heads, 8 experts, top-2, vocab 32000 untied,
      rope theta 1e6), random bf16 weights from seed 0 drawn and quantized one layer
      at a time by quantize_mixtral (4-bit g64; the router in bf16) at
      capacity factor 4.0 (= E / top_k: nothing dropped), save_quantized,
      then `serve.main` on the checkpoint with its defaults (paged, w4a8,
      fused) and G's pool; G's 12 requests from 12 client threads (6
      streamed), ids equal to an in-process PagedBatchingEngine's; a decode
      step makes 3, 1, 2 and 2 launches a layer of grouped_matmul,
      paged_attention, rms_norm (and one more) and w4a8_matmul, a prefill
      3 stacked dequant_canonical a layer (every
      expert holds more than 32 rows: torch.bmm on the dequantized stack);
      the first and last layer's expert stacks held on the path's own
      activations with their controls; step ms against the byte bound of
      every expert's codes and meta, busy share, peak memory; Generator
      "partial" and "full" on the served tree; then the same requests
      in-process at the default capacity factor 2.0, with the share of
      assignments dropped. Then 2-layer Qwen3-30B-A3B and gpt-oss-20b at
      published width (from memory): their quantizers, checkpoints
      bit-equal, a prefill and 4 decode steps with every w4a8, quant_matmul,
      rms_norm, grouped_matmul and stacked-dequant call held to its twin,
      paged decode against the dense cache. Phase b holds grouped_matmul to
      its twin at path X's stacks (Mixtral's at C = 1, 4, 8, 32, Qwen3-MoE's
      at C = 1, gpt-oss's at C = 2; fp32 meta, and bf16 at three) within
      2^-7 of max|y| with the controls a neighbour's scale and expert e+1's
      codes, three runs bit-equal, against its byte bound and torch.bmm on
      the dequantized stack, and each stack's one-launch dequant bit-equal
      to E single calls.
  (k) DeepSeek-V3 (MLA, group-limited sigmoid routing, a dense-compute MoE
      with shared experts): Moonlight-16B-A3B at full width, 3 of its 27
      layers (K_MOONLIGHT_LAYERS, cut for the script's time with paths P and N;
      moonshotai/Moonlight-16B-A3B from memory: hidden 2048, the first
      dense, 16 heads, q_proj, kv_lora 512, 64 experts top-6 in
      one group, 2 shared, vocab 163840), random bf16 weights from seed 0
      drawn and quantized a layer at a time (4-bit g64; the experts by
      quantize_experts, the router in fp32), save_quantized, then
      `serve.main` with its defaults (w4a8, fused; no paged branch: the
      dense engine of 8 slots) and max_len 2048; G's 12 requests from 12
      client threads, ids equal to an in-process ContinuousBatchingEngine's;
      a decode step makes 7 w4a8_matmul, 3 grouped_matmul (every expert on
      every token) a layer, 3 rms_norm a layer (and one more) and no
      paged_attention launches, a prefill 7 quant_matmul and 3 stacked
      dequants a layer; the MLA projections
      and expert stacks of the first and last layers held on the path's own
      activations, and the latent's norm over a strided slice bit-equal to
      its twin (control: a wrong stride); step ms against the byte bound,
      busy share, peak memory; Generator "partial" and "full". Then
      DeepSeek-V3 at published width (128 heads, q_lora 1536, 256 experts
      in 8 groups, top-8 of 4 groups, YaRN factor 40), 5 layers (3 dense, 2
      MoE), the experts drawn and quantized 32 at a time: a prefill of 4 x
      8 tokens and 4 decode steps with every w4a8, rms_norm (1536, 512,
      7168) and grouped_matmul call held to its twin, no quant_matmul; the
      router against its CPU twin (control: TF32); the logits against the
      plain path, the (token, layer) expert sets that differ counted and
      left out; the broadcast [E, T, D] copy timed; Generator "partial" and
      "full". Phase b also times grouped_matmul at both models' stacks.
  (p) vision-language serving: LLaVA-1.5-7B at full width, 8 of its 32
      text layers (P_LLAVA_LAYERS, cut for the script's time when path U came in)
      (llava-hf/llava-1.5-7b-hf from memory: Llama-2-7B with vocab 32064,
      image_token_index 32000; CLIP ViT-L/14-336, 23 of its 24 layers
      run; the projector 1024 -> 4096 -> 4096), random bf16 weights from
      seed 0, `HQQVLModel.quantize_model` 4-bit g64 and save_quantized,
      then `serve.main` with its defaults (paged, w4a8, fused; the tower
      unprepared, each W dequantized by the canonical kernel) and 12
      requests from 12 client threads, 8 with an image's pixel_values (576
      placeholders and 16-64 text tokens) and 4 text-only, 6 streamed: ids
      equal to the in-process engine's on the embedder's rows; launches a
      decode step, a prefill and an image; the tower an image on both
      routes (as served and engine/vl's "pallas", row 1); every kernel call
      of an image and a text request held to its twin; the prefix cache
      with two images behind the same ids (no page shared, each its own
      ids). Then Qwen2-VL-7B at full width, 6 of its 28 text layers
      (P_QWEN_LAYERS) and its 32 tower blocks, 4-bit g64, "w4a8" (the tower on row 1): generate on
      one 448 x 448 image (1024 patches, 256 merged rows) and its launches;
      the dense engine with mrope_offsets beside a text request, ids
      against generate's by the near-tie rule (teacher forcing), the
      control at offset 0 failing it; every kernel call of a short
      generate held to its twin. Phase b times layer_norm at 577 x 1024 and
      1024 x 1280 and quant_matmul at both towers' matmuls.
  (n) Aria (rhymes-ai/Aria from memory: a 28-layer MoE at 2560, 20/20
      heads, 64 experts of 1664 top-6 and 2 shared, vocab 100352; the
      SigLIP-so400m tower, 27 layers at 1152 over 980 x 980 images, 4900
      patches, 256 queries) at full width, 6 of its 28 text layers
      (N_LAYERS, cut for the script's time when path U came in), random bf16 weights
      from seed 0, the text drawn and quantized a layer at a time by
      quantize_aria (4-bit g64; the router, lm_head, the tower and the
      projector bf16) at capacity factor E / top_k, save_quantized and
      AutoHQQVLModel.from_quantized bit-equal, "w4a8"; generate on two image
      prompts (256 placeholders, 16-64 text tokens) and a text-only one, 32
      new tokens each (its launch window); the dense engine in-process with
      aria.forward as its forward hooks, 8 slots, 8 image requests and 4
      text-only (each image encoded and spliced inside its window): ids
      against generate's (the near-tie rule where they part), step ms
      against the byte bound of every expert's codes and meta, tok/s, busy
      share; the same requests at the default capacity factor 2.0 with
      the share of assignments dropped; every w4a8, quant_matmul,
      grouped_matmul, stacked dequant, rms_norm and layer_norm call of a
      short generate held to its twin; the MoE block of a 2-layer cut
      against its plain twin, with fc1's halves swapped as the control.
      Phase b times grouped_matmul and the stacked dequant at Aria's stacks
      (C = 1, 2), w4a8 at its decode, quant_matmul at its prefill,
      layer_norm at 4900 and 256 rows of 1152 (bf16, fp32), rms_norm at
      2560.
  (t) ViT-L/16 (google/vit-large-patch16-224 from memory) at published
      width, random weights from seed 0, in bf16 and in fp32:
      HQQVisionModel.quantize_model (4-bit g64), save_quantized and
      from_quantized bit-equal, prepare_for_inference("pallas"), 32 images
      (6304 rows) with the "cls" and "mean" pools: 144 quant_matmul (bf16)
      or qmm_fp32 (fp32) and 49 layer_norm launches a batch, ms a batch,
      the first and last layers' matmuls and every layer_norm held to their
      twins. Phase b times quant_matmul and qmm_fp32 at its three matmuls
      and layer_norm over 6304 rows of 1024 (bf16, fp32).
  (u) HQQ+'s sub-word groups (2-bit and 1.58-bit g8, 1-bit g8 and g16,
      axis=1: a 32-bit word spans 2 or 4 groups, each 4-code field with its
      own group's scale and zs): Llama-2-7B at full width and depth, random
      bf16 weights from seed 0, quantize_model(2-bit g8) (HQQ+'s
      mobiuslabs/Llama-2-7b-chat-hf_2bitgs8_hqq names the recipe; nothing
      is downloaded), save_quantized. U-plus: rank-8 adapters on all 224
      linears (B from a seed), "w4a8" (A8LoRAQuantLinear: row 8 on the
      small-group route at decode, row 7 at prefill), serve_7b's window
      (prefill ms at M = 512, Generator "partial" and "full" decode tok/s
      at B = 4 against the byte bound, busy share, peak, quantize s), every
      fused call of a prefill and two decode steps against its twin with
      the control "the word's other group" (each field on the meta of the
      other group of its pair in the word), and the decode's routes: every
      plan and launch on the small-group route, no canonical dequant and no
      F.linear but lm_head's in a partial step, only w4a8_group_mma_kernel
      among the w4a8 kernels of a replayed graph. U-serve: `serve.main --nbits 2
      --group-size 8` on the checkpoint with its defaults (paged, w4a8,
      fused), G's pool, G's 12 requests from 12 client threads: ids equal
      to the in-process engine's, every w4a8 launch of the window on the
      small-group route and only its kernel among the steady steps' w4a8
      kernels, boot s, time to first token, tokens/s at the client and
      in-process, ms a step against the byte bound, busy share, peak.
      Kernel coverage: 2-layer models at 7B width at each
      sub-word config and 2-bit g8 in fp32, "pallas" and "w4a8", with and
      without adapters, through Generator, and their prefill and decode
      logits against the canonical QuantLinear route (w4a8's decode against
      its plain twins), the word's-other-group control failing each bar.
      Phase b holds every route at these configs to its twin (rows 2/3 and
      8 at `U_GROUP_CASES`: U's decode shapes, M = 32, 4-bit g16 and g24,
      and the CUDA-core kernel at one shape off the 16-byte rule, each also
      with row 0 bit-equal at M = 1, 4, 8, 32; rows 1 and 7 at its prefill,
      row 4, qmm_fp32 with fp32 x) with that control and three bit-equal
      runs, timed against the bound, the twin and torch.matmul.
Phases g, h, v and m run right after c, on its model, then q and s, then r,
then l, then x, then k, then p, then n, then t, then u, then d.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.

With ``--time KERNEL M K N [RANK]`` it builds the kernels, times one wrapper
at one shape as phase b does, three times over, and prints one JSON line:
for comparing two checkouts on one card. Unpack the parent beside the change
(`git archive`) and run both from one shell command, in turns: parent,
change, change, parent; several runs go in one call joined by "+" (KERNEL M
K N ... + KERNEL M K N ...). KERNEL is quant_matmul, w4a8_matmul,
quant_matmul_lora or w4a8_lora_matmul (4-bit g64, RANK 8 unless given; the
w4a8 pair also an axis=1 config NBITS-G-META, e.g. 2-8-fp32 or 1.58-8-bf16,
then a VARIANT: no-fold, no-mma, no-meta or loads-only builds the
small-group kernel without that work, ring-S or tile-R-S launches it with
another ring or tile, several joined by commas),
quant_matmul_ax0 or dequant_ax0 (2-bit g16, bf16 scale and zs, or the
config NBITS-G-META given after N, e.g. 3-64-fp32, path F's attention, and
for quant_matmul_ax0 then a variant of AX0_VARIANTS), dequant and
dequant_canonical (W [N, K] to bf16 from the axis=1 kernel layout or a
canonical QTensor, 4-bit g64 fp32 meta or a config NBITS-G-META; M unused),
qmm_fp32 (fp32 x
through quant_matmul at 4-bit g64, quant_matmul_lora given a RANK, or
quant_matmul_ax0 given a config); for
paged_attention the four numbers are slots, length, query heads and kv heads
(pages of 16 rows, head size 128; bf16 unless int8 follows), for
flash_attention, the two
backward kernels (flash_attention_backward_dkv, flash_attention_backward_dq)
and flash_attention_fp32 batch, T, query heads and kv heads (causal, head
size 128; bf16, fp32 for the last); the backward kernels take the kv heads
as KV[-HD[-TYPE]], e.g. 8-64-fp16, for another head size and type (with
fp32, the fp32 route: flash_attention_backward_dkv_fp32 and _dq_fp32 name
the same with fp32 as the default type, and take a VARIANT of
BWD_FP32_VARIANTS: no-swap, no-second). layer_norm and rms_norm take ROWS D
D and a type (bf16 or fp32), and time F.layer_norm or F.rms_norm beside
the kernel; to time an older checkout's norm kernel in the same call, run
this script copied into that checkout's root.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of every kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}
ROTATE_BYTES = 160 * 2**20  # cycle through input copies larger than the 50 MB L2

SRC = "hqq_tpu_torch/csrc/"
# the sources of the Hopper mainloops (TMA, wgmma)
WGMMA_SOURCES = ("quant_matmul.cu", "quant_matmul_ax0.cu", "quant_matmul_lora.cu",
                 "qmm_fp32.cu", "flash_prefill.cu", "flash_fp32_sm90.cu",
                 "flash_backward_sm90.cu", "flash_backward_fp32_sm90.cu")
# the source that moves pages by bulk copy (cp.async.bulk without a tensor map)
BULK_SOURCES = ("paged_attention.cu",)
# the source on the int8 tensor cores (mma.sync, IMMA) fed by TMA
IMMA_SOURCES = ("w4a8_matmul.cu",)
# the source on the bf16 tensor cores (mma.sync, HMMA) without TMA
HMMA_SOURCES = ("grouped_matmul.cu",)
# the sources whose kernel instantiations must not spill
NO_SPILL_SOURCES = IMMA_SOURCES + HMMA_SOURCES + ("dequant.cu",)
# wrapper -> (source, the TPU kernel it replaces, a second one it replaces)
KERNELS = {
    "w4a8_matmul": ("w4a8_matmul.cu", "hqq_tpu/ops/fused_matmul.py:524",
                    "hqq_tpu/ops/fused_matmul.py:776"),
    "quant_matmul": ("quant_matmul.cu", "hqq_tpu/ops/fused_matmul.py:307", None),
    "dequant": ("dequant.cu", "hqq_tpu/ops/fused_matmul.py:982", None),
    # the canonical QTensor's dequantization, which hqq_tpu leaves to XLA's
    # fusion (no Pallas kernel): the weight of the canonical QuantLinear
    "dequant_canonical": ("dequant.cu", "hqq_tpu/core/quantize.py:381", None),
    "quant_matmul_ax0": ("quant_matmul_ax0.cu", "hqq_tpu/ops/fused_matmul.py:1223",
                         "hqq_tpu/ops/fused_matmul.py:1318"),
    "quant_matmul_lora": ("quant_matmul_lora.cu", "hqq_tpu/ops/fused_matmul.py:1521", None),
    "w4a8_lora_matmul": ("w4a8_matmul.cu", "hqq_tpu/ops/fused_matmul.py:1609", None),
    # the small-group route of both w4a8 wrappers (rows 2, 3 and 8 where a
    # group is not whole k32 steps: HQQ+'s 2-bit and 1.58-bit g8, 1-bit g8
    # and g16), its own kernel: `w4a8_group_mma_kernel`
    "w4a8_group_mma": ("w4a8_matmul.cu", "hqq_tpu/ops/fused_matmul.py:524",
                       "hqq_tpu/ops/fused_matmul.py:776, :1609"),
    "paged_attention": ("paged_attention.cu", "hqq_tpu/ops/paged.py:275", None),
    "flash_attention": ("flash_prefill.cu", "hqq_tpu/ops/attention.py:66", None),
    # the library flash attention's backward kernels, which the training
    # step of hqq_tpu/utils/training.py:98 reaches through its custom VJP
    "flash_attention_backward_dkv": (
        "flash_backward_sm90.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:941", None),
    "flash_attention_backward_dq": (
        "flash_backward_sm90.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:1287", None),
    # the fp32 routes: what the TPU kernels do for fp32 inputs
    "qmm_fp32": ("qmm_fp32.cu", "hqq_tpu/ops/fused_matmul.py:307",
                 "hqq_tpu/ops/fused_matmul.py:1223, :1318, :1521"),
    "flash_attention_fp32": ("flash_fp32_sm90.cu", "hqq_tpu/ops/attention.py:66", None),
    "flash_attention_backward_dkv_fp32": (
        "flash_backward_fp32_sm90.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        None),
    "flash_attention_backward_dq_fp32": (
        "flash_backward_fp32_sm90.cu", "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        None),
    # RMSNorm, which hqq_tpu leaves to XLA's fusion (no Pallas kernel): one
    # fixed-order fp32 kernel, so that a row's norm does not depend on its
    # neighbours; Gemma's (1 + w) norm with offset 1
    "rms_norm": ("rms_norm.cu", "hqq_tpu/models/llama.py:268", "hqq_tpu/models/gemma.py:68"),
    # LayerNorm, which hqq_tpu also leaves to XLA's fusion: the same fixed
    # order, two sums a row; the LayerNorm families' norms
    "layer_norm": ("rms_norm.cu", "hqq_tpu/models/vit.py:131",
                   "hqq_tpu/models/phi.py:153, hqq_tpu/models/cohere.py:75"),
    # the MoE experts' dequant-matmul, which hqq_tpu leaves to XLA (a vmapped
    # dequantize and one einsum, no Pallas kernel): the packed 4-bit codes of
    # every expert read once, the dense W never written
    "grouped_matmul": ("grouped_matmul.cu", "hqq_tpu/nn/moe.py:110",
                       "hqq_tpu/core/quantize.py:381 (vmapped over the experts)"),
}
# the row of phase b that stands for each kernel in the last-but-one line
PICK = {
    "w4a8_matmul": (4, 4096, 11008, ""),
    "quant_matmul": (512, 4096, 4096, ""),
    "dequant": (None, 11008, 4096, ""),
    "dequant_canonical": (None, 11008, 4096, "canonical 4-bit g64 axis=1, fp32 meta"),
    "quant_matmul_ax0": (4, 4096, 11008, "2-bit g16 axis=0, bf16 meta"),
    "quant_matmul_lora": (512, 4096, 4096, "r=8"),
    "w4a8_lora_matmul": (4, 4096, 11008, "r=8"),
    "w4a8_group_mma": (4, 4096, 11008, "2-bit g8 axis=1"),
    "paged_attention": (8, 1024, 32, "bf16 pages of 16 rows, 32/32 heads, head size 128"),
    "flash_attention": (1, 1023, 32, "bf16, causal, 32/32 heads, head size 128"),
    "flash_attention_backward_dkv": (1, 1024, 32, "bf16, causal, 32/32 heads, head size 128"),
    "flash_attention_backward_dq": (1, 1024, 32, "bf16, causal, 32/32 heads, head size 128"),
    "qmm_fp32": (512, 4096, 4096, "fp32 x, 4-bit g64 axis=1"),
    "flash_attention_fp32": (1, 512, 8, "fp32, causal, 8/8 heads, head size 128"),
    # Gemma-7B's heads: the cluster route of phase i's Gemma-width step
    "flash_attention_backward_dkv_fp32": (1, 2048, 16, "fp32, causal, 16/16 heads, head size 256"),
    "flash_attention_backward_dq_fp32": (1, 2048, 16, "fp32, causal, 16/16 heads, head size 256"),
    "rms_norm": (4, 4096, 4096, "bf16, offset 0"),
    "layer_norm": (4, 4544, 4544, "bf16, bias"),
    "grouped_matmul": (8, 4096, 14336, "8 experts, 4-bit g64, fp32 meta"),
}
# head size and page geometry of the attention rows and of paths G and H
HEAD_DIM, PAGE, MAX_PAGES = 128, 16, 64
# path R's Gemma-2-9B matmuls (M, K, N): q (unfused), the fused q/k/v and
# gate/up, down, o at decode; the fused q/k/v and gate/up at prefill
R_DECODE_SHAPES = [(4, 3584, 4096), (4, 3584, 8192), (4, 3584, 28672), (4, 14336, 3584),
                   (4, 4096, 3584)]
R_PREFILL_SHAPES = [(512, 3584, 8192), (512, 3584, 28672)]
# path L's Falcon-7B matmuls (M, K, N) at the dense engine's decode (8
# slots): query_key_value, dense_h_to_4h, dense_4h_to_h; at prefill
L_DECODE_SHAPES = [(8, 4544, 4672), (8, 4544, 18176), (8, 18176, 4544)]
L_PREFILL_SHAPES = [(512, 4544, 4672), (512, 4544, 18176)]
# fuse_for_decode's widths at 7B: fused N -> (the N of its parts, how many)
FUSED_WIDTHS = {12288: (4096, 3), 22016: (11008, 2)}
LORA_RANK, LORA_ALPHA, LORA_B_STD = 8, 16, 0.05


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float, kind: str, fp32_ops: float = 0.0) -> tuple[float, str]:
    """The least time for ``nbytes`` moved and ``ops`` operations of ``kind``
    (plus ``fp32_ops`` outside the tensor cores): the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / PEAK_OPS[kind] + fp32_ops / PEAK_OPS["fp32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@contextlib.contextmanager
def tf32_allowed():
    """TF32 products in torch.matmul for the block (a control), then the
    setting it found (main turns it off: fp32 routers and twins run fp32)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def containers(tree):
    """New dicts and lists over the same leaves: prepare_for_inference swaps
    layers in place, and the tree it is given a copy of stays as it is."""
    if isinstance(tree, dict):
        return {k: containers(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [containers(v) for v in tree]
    return tree


def checked(kernel, plain, controls: dict, log: dict, key=None):
    """``kernel`` held on the spot to ``plain`` on the same inputs (the
    activations the path really produces), and each control likewise. The
    result stands in for the wrapper (mock.patch) and returns the kernel's
    output, so the path runs on it. The wrapper counts its launches on
    whatever its module name holds, here this function. ``key(*args)``,
    where given, is logged with each call under "keys"."""
    def fn(*args):
        y = kernel(*args)
        ref = plain(*args)
        log.setdefault("kernel", []).append(rel(y, ref))
        if key is not None:
            log.setdefault("keys", []).append(key(*args))
        for name, control in controls.items():
            log.setdefault(name, []).append(rel(control(*args), ref))
        return y

    fn.launches = 0
    return fn


def _device_events(fns, iters: int, only: str) -> list:
    """torch.profiler's CUDA events (one per kernel or copy name, with its
    count and summed duration) of ``iters`` calls cycling through ``fns``,
    those whose name holds ``only``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and only in e.key]


def _event_ms(fns, iters: int) -> float:
    """Time of one call, cycling through ``fns``, between two CUDA events
    around ``iters`` calls: host gaps between launches count here."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fns, iters: int, only: str = "") -> float:
    """Device time of one call, cycling through ``fns`` (one per input
    copy): the summed duration of every kernel and copy the calls ran on
    the card (of those whose name holds ``only``, where given), from
    torch.profiler's CUDA trace, over ``iters`` calls after a warm-up. Host
    time between launches is not counted (at decode sizes it exceeds the
    kernels' own). A trace with fewer device events than calls is measured
    again, up to three times; if each still lost events, every kernel is
    priced at its mean over the events kept times its launches in a
    one-call trace. Where the traces kept too little for that (the
    profiler now and then records no device event at all in a process),
    the call is timed between CUDA events instead, all its kernels
    together and host gaps included, and a line says so."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    for _ in range(3):  # the trace now and then loses a run's events: take another
        events = _device_events(fns, iters, only)
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0 and sum(e.count for e in events) >= iters:  # a kernel per call at least
            return total_us / 1e3 / iters
    kept = {e.key: e.self_device_time_total / e.count for e in events if e.count}
    # launches of each kernel per call: a one-call trace, else the kept
    # events' counts over the calls, rounded (the trace loses a few)
    per_call = {e.key: e.count for e in _device_events(fns[:1], 1, only)} or {
        e.key: round(e.count / iters) for e in events if round(e.count / iters)}
    if not per_call or not set(per_call) <= set(kept):
        ms = _event_ms(fns, iters)
        log(f"[time] the profiler kept {sum(e.count for e in events)} device events of {iters} "
            f"calls four times: {ms:.4f} ms per call between CUDA events (every kernel of the "
            f"call{'' if not only else f', not only {only!r}'}; host gaps included)")
        return ms
    log(f"[time] the trace kept {sum(e.count for e in events)} events of {iters} calls three "
        f"times: mean time per kernel x its {sum(per_call.values())} launches in one call")
    return sum(kept[k] * n for k, n in per_call.items()) / 1e3


def device_share(fn) -> dict:
    """Run ``fn`` once under torch.profiler: the wall time, the share of it
    the device spent in kernels and copies (one stream, so their durations
    add up) and that device time, the five kernels with the most device
    time, the device time of the w4a8 kernels by name, and of every kernel
    by its full name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    if not events:
        log("[time] the profiler kept no device event of this run: the busy share below is "
            "not measured")
    w4a8 = {}  # the w4a8 kernels' device time by name (the tensor-core and small-group routes)
    for e in events:
        name = re.search(r"w4a8_\w+_kernel(<[^>]*>)?", e.key)
        if name:
            w4a8[name.group(0)] = round(w4a8.get(name.group(0), 0.0)
                                        + e.self_device_time_total / 1e3, 3)
    return dict(wall_ms=wall_ms, busy_share=device_ms / wall_ms, device_ms=device_ms,
                top={e.key[:40]: round(e.self_device_time_total / 1e3, 3) for e in top},
                w4a8=w4a8, by_name={e.key: e.self_device_time_total / 1e3 for e in events},
                events=sum(e.count for e in events))


def card_state() -> str:
    """SM clock and power draw now, as nvidia-smi reads them: a card that
    runs slower under load shows it here."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_a(name: str, power: str) -> None:
    from hqq_tpu_torch.ops import _build

    log(f"[a] device: {name}; count {torch.cuda.device_count()}; nvidia-smi: {power}")
    log(f"[a] torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    logs = _build.build_all()
    log(f"[a] built {sorted(logs) or 'nothing (cached)'} in {time.time() - t0:.1f} s, one nvcc "
        f"per source in parallel")
    for kname, (seconds, text) in sorted(logs.items()):  # one entry per source
        regs = re.findall(r"Used (\d+) registers", text)
        spills = re.findall(r"(\d+) bytes spill stores", text)
        log(f"[a]   {kname}: built in {seconds:.1f} s, {len(regs)} instantiations, registers "
            f"{min(map(int, regs))}-{max(map(int, regs))}, spill stores up to "
            f"{max(map(int, spills))} bytes")
        if kname in WGMMA_SOURCES + BULK_SOURCES + IMMA_SOURCES:
            serial = len(re.findall(r"wgmma.mma_async instructions are serialized", text))
            log(f"[a]     ptxas notes of serialized wgmma (C751x): {serial}")
            # per kernel instantiation: (template arguments, registers, spill bytes)
            for fn, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling|\Z)",
                                       text, flags=re.S):
                reg = re.search(r"Used (\d+) registers", body)
                spill = re.search(r"(\d+) bytes spill stores", body)
                if "kernel" in fn and reg:
                    log(f"[a]     {fn.split('EEv')[0]}: {reg.group(1)} registers, "
                        f"{spill.group(1) if spill else '?'} bytes spill stores")
        if kname in NO_SPILL_SOURCES:  # a spill, or no note of one, fails
            entries = re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling|\Z)", text,
                                 flags=re.S)
            spilled = [fn for fn, body in entries
                       if int((re.search(r"(\d+) bytes spill stores", body) or [0, 1])[1])]
            log(f"[a]     {len(entries)} kernel instantiations, {len(spilled)} spill")
            if spilled:
                raise AssertionError(f"{kname}: {len(spilled)} kernel instantiations spill, "
                                     f"e.g. {spilled[0]}")
    # the Hopper mainloops really issue wgmma (HGMMA) and TMA loads (UTMALDG)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")

    def dump(source):
        return subprocess.run([cuobjdump, "-sass", _build._lib_path(source)],
                              capture_output=True, text=True, check=True, timeout=300).stdout

    # one cuobjdump per library, all at once
    sources = WGMMA_SOURCES + IMMA_SOURCES + HMMA_SOURCES + BULK_SOURCES
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        sasses = dict(zip(sources, pool.map(dump, sources)))
    for source in WGMMA_SOURCES:
        sass = sasses[source]
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}
        log(f"[a]   {source} SASS: {counts['HGMMA']} HGMMA and {counts['UTMALDG']} UTMALDG "
            f"instructions")
        if not all(counts.values()):
            raise AssertionError(f"{source} issues no wgmma or no TMA load: {counts}")
    for source in IMMA_SOURCES:
        sass = sasses[source]
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("IMMA", "UTMALDG")}
        log(f"[a]   {source} SASS: {counts['IMMA']} IMMA (int8 mma.sync) and "
            f"{counts['UTMALDG']} UTMALDG instructions")
        if not all(counts.values()):
            raise AssertionError(f"{source} issues no int8 MMA or no TMA load: {counts}")
    for source in HMMA_SOURCES:
        sass = sasses[source]
        hmma = len(re.findall(r"\bHMMA\b", sass))
        log(f"[a]   {source} SASS: {hmma} HMMA (bf16 mma.sync) instructions")
        if not hmma:
            raise AssertionError(f"{source} issues no bf16 MMA")
    for source in BULK_SOURCES:
        sass = sasses[source]
        bulk = len(re.findall(r"\bUBLKCP\b", sass))
        log(f"[a]   {source} SASS: {bulk} UBLKCP (bulk copy) instructions")
        if not bulk:
            raise AssertionError(f"{source} issues no bulk copy")


def _make_kqt(n: int, k: int, g: int, nbits: int, seed: int):
    from hqq_tpu_torch.core.quantize import quantize
    from hqq_tpu_torch.ops.fused_matmul import to_kernel_layout

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device="cuda") / k**0.5
    qt = quantize(w, nbits=nbits, group_size=g, axis=1, round_zero=(nbits == 4))
    return to_kernel_layout(qt)


def _make_kqt0(n: int, k: int, g: int, nbits: int, meta_dtype, seed: int):
    from hqq_tpu_torch.core.quantize import quantize
    from hqq_tpu_torch.ops.fused_matmul import to_kernel_layout_ax0

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device="cuda") / k**0.5
    return to_kernel_layout_ax0(quantize(w, nbits=nbits, group_size=g, axis=0), meta_dtype)


def _make_lora(k: int, n: int, seed: int, r: int = LORA_RANK):
    """A [K, r] kaiming-uniform and B [r, N] normal with the scaling folded
    in, as the serving modules hold them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.rand((k, r), generator=gen, device="cuda") * 2 - 1) * (6.0 / k) ** 0.5
    b = torch.randn((r, n), generator=gen, device="cuda") * LORA_B_STD
    return a, b * (LORA_ALPHA / r)


def _weight_bytes(kqt) -> int:
    return sum(t.numel() * t.element_size() for t in (kqt.wq, kqt.scale, kqt.zs))


def _copies(kqt, x, bytes_each: int):
    """Input copies enough to overflow L2, so that each timed call reads its
    weight from device memory as the model's calls do."""
    import dataclasses

    n = max(1, min(16, -(-ROTATE_BYTES // max(bytes_each, 1))))
    kqts = [kqt] + [dataclasses.replace(kqt, wq=kqt.wq.clone(), scale=kqt.scale.clone(),
                                        zs=kqt.zs.clone()) for _ in range(n - 1)]
    xs = [x] + [x.clone() for _ in range(n - 1)] if x is not None else [None] * n
    return kqts, xs



def _paged_inputs(lengths, nh: int, n_kv: int, int8: bool, n_tables: int, seed: int,
                  hd: int = HEAD_DIM):
    """A page pool with random rows and ``n_tables`` block tables over
    disjoint pages of it (page 0 stays scratch; entries past a slot's pages
    point at it, as the engine's do). Returns (q, k, v, lengths, tables, ks,
    vs): bf16 pages with bf16 q, or int8 pages with their scales and fp32 q."""
    from hqq_tpu_torch.ops.paged import quant_rows

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = len(lengths)
    per = -(-max(lengths) // PAGE)
    num_pages = 1 + n_tables * b * per
    shape = (n_kv, num_pages, PAGE, hd)
    k = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((b, nh, hd), generator=gen, device="cuda") * hd**-0.5
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    perm = 1 + torch.randperm(num_pages - 1, generator=gen, device="cuda")
    tabs = torch.zeros((n_tables, b, MAX_PAGES), dtype=torch.int32, device="cuda")
    tabs[:, :, :per] = perm.reshape(n_tables, b, per).to(torch.int32)
    used = (lens[:, None] + PAGE - 1) // PAGE
    tabs = torch.where(torch.arange(MAX_PAGES, device="cuda")[None, None, :] < used[None], tabs, 0)
    if int8:
        k, ks = quant_rows(k)
        v, vs = quant_rows(v)
        return q, k, v, lens, tabs, ks, vs
    return q.to(torch.bfloat16), k, v, lens, tabs, None, None


def _gathered_dense(pages, scales, tab, nh: int):
    """The block table's rows of a pool as dense bf16 [B, nh, S, hd] (int8
    pages dequantized, kv heads repeated): what a library call would take."""
    seq = pages[:, tab.long()]  # [H, B, MP, pg, hd]
    if scales is not None:
        seq = seq.float() * (scales[:, tab.long()] / 127.0)
    h, b, mp, pg, hd = seq.shape
    seq = seq.permute(1, 0, 2, 3, 4).reshape(b, h, mp * pg, hd).to(torch.bfloat16)
    return seq.repeat_interleave(nh // h, dim=1) if nh > h else seq


def _paged_bound(lengths, nh: int, n_kv: int, int8: bool, hd: int = HEAD_DIM):
    """Bytes and fp32 operations of one paged-attention call: the attended K
    and V rows (and their scales) read once, q read and out written once."""
    rows = float(sum(lengths)) * n_kv
    esize = 1 if int8 else 2
    qsize = 4 if int8 else 2
    nbytes = (2 * rows * hd * esize + (8 * rows if int8 else 0)
              + 2 * len(lengths) * nh * hd * qsize + len(lengths) * (4 + 4 * MAX_PAGES))
    return nbytes, 4.0 * sum(lengths) * nh * hd


def _flash_inputs(b: int, nh: int, n_kv: int, t: int, copies: int, seed: int,
                  hd: int = HEAD_DIM):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def one(heads):
        return torch.randn((b, heads, t, hd), generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    return [(one(nh), one(n_kv), one(n_kv)) for _ in range(copies)]


def _sdpa_causal(q, k, v):
    import torch.nn.functional as F

    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


# bars of the attention kernels against their plain versions, of max|out|.
# Two bf16 roundings of nearly equal values can fall to different sides, one
# step (2^-7 of the value) apart. paged, bf16 pages: the kernel rounds the
# output once; the plain version also rounds the probabilities to bf16, an
# error of the size of one more rounding of the output: two steps. flash,
# bf16: both round the probabilities (the plain version normalised, the
# kernel before the division by the fp32 sum) and the output: two steps.
# paged, int8 pages (all fp32): sums in another order and another exp.
TOL_PAGED_BF16, TOL_PAGED_INT8, TOL_FLASH_BF16 = 2.0**-6, 2e-5, 2.0**-6
# against the plain version on the same values in fp32 (probabilities and
# output unrounded) only the kernel's own rounding of the output is left,
# half a step: the bar of the call-by-call checks of path G
TOL_PAGED_BF16_VS_FP32 = 2.0**-7


def phase_b_attention(record, held, iters: int) -> None:
    import torch.nn.functional as F

    from hqq_tpu_torch.ops import attention as at
    from hqq_tpu_torch.ops import paged as pa

    around = {256: [200, 230, 256, 257, 270, 300, 240, 290],
              1024: [1024, 1000, 990, 1010, 960, 1024, 1017, 975]}
    # the last: Gemma-2-9B's and Gemma-3's heads (16/8 of head size 256), where
    # path R's Gemma-3 full layers reach the kernel
    cases = [(32, 32, False, 256, HEAD_DIM), (32, 32, False, 1024, HEAD_DIM),
             (32, 32, True, 256, HEAD_DIM), (32, 32, True, 1024, HEAD_DIM),
             (32, 8, False, 1024, HEAD_DIM), (16, 8, False, 1024, 256)]
    for nh, n_kv, int8, nominal, hd in cases:
        lengths = around[nominal]
        nbytes, fp32_ops = _paged_bound(lengths, nh, n_kv, int8, hd)
        n_tables = max(1, min(16, -(-ROTATE_BYTES // int(nbytes))))
        q, k, v, lens, tabs, ks, vs = _paged_inputs(lengths, nh, n_kv, int8, n_tables,
                                                    seed=nominal + n_kv + int8, hd=hd)
        what = (f"{'int8' if int8 else 'bf16'} pages {nh}/{n_kv} heads of {hd}, lengths around "
                f"{nominal}")
        err = held("paged_attention", pa.paged_attention(q, k, v, lens, tabs[0], ks, vs),
                   pa.paged_attention_plain(q, k, v, lens, tabs[0], ks, vs),
                   TOL_PAGED_INT8 if int8 else TOL_PAGED_BF16, what)
        ms = time_ms([lambda tab=tab: pa.paged_attention(q, k, v, lens, tab, ks, vs)
                      for tab in tabs], iters)
        plain = time_ms([lambda: pa.paged_attention_plain(q, k, v, lens, tabs[0], ks, vs)],
                        max(3, iters // 10))
        dense_k, dense_v = _gathered_dense(k, ks, tabs[0], nh), _gathered_dense(v, vs, tabs[0], nh)
        q4 = q.to(torch.bfloat16)[:, :, None, :]
        mask = (torch.arange(dense_k.shape[2], device="cuda")[None, :] < lens[:, None])[:, None, None]
        lib = time_ms([lambda: F.scaled_dot_product_attention(q4, dense_k, dense_v, attn_mask=mask,
                                                              scale=1.0)], iters)
        del dense_k, dense_v, k, v, ks, vs
        b_ms, by = bound_ms(nbytes, 0.0, "bf16", fp32_ops=fp32_ops)
        note = (f"{'int8' if int8 else 'bf16'} pages of {PAGE} rows, {nh}/{n_kv} heads, "
                f"head size {hd}")
        record("paged_attention", dict(
            kernel="paged_attention", m=len(lengths), k=nominal, n=nh, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=lib, note=note,
            library="scaled_dot_product_attention on the gathered dense bf16 K/V (the gather "
                    "not timed)",
            shape=dict(slots=len(lengths), lengths=lengths, heads=nh, kv_heads=n_kv,
                       head_dim=hd, page_size=PAGE, pages="int8" if int8 else "bf16")))
        torch.cuda.empty_cache()

    for b, nh, n_kv, t in [(1, 32, 32, 1023), (4, 32, 32, 512), (1, 32, 8, 1023)]:
        each = 2 * b * t * HEAD_DIM * (2 * nh + 2 * n_kv)  # q, out, k, v in bf16
        qkv = _flash_inputs(b, nh, n_kv, t, max(1, min(16, -(-ROTATE_BYTES // each))), seed=t + n_kv)
        q, k, v = qkv[0]
        err = held("flash_attention", at.flash_attention(q, k, v, True),
                   at.flash_attention_plain(q, k, v, True), TOL_FLASH_BF16,
                   f"B={b} heads {nh}/{n_kv} T={t}")
        ms = time_ms([lambda a=a: at.flash_attention(*a, True) for a in qkv], iters)
        plain = time_ms([lambda: at.flash_attention_plain(q, k, v, True)], max(3, iters // 10))
        lib = time_ms([lambda: _sdpa_causal(q, k, v)], iters)
        # 2 * B * H * T * T * hd multiply-adds, halved for causality
        b_ms, by = bound_ms(each, 2.0 * b * nh * t * t * HEAD_DIM, "bf16")
        record("flash_attention", dict(
            kernel="flash_attention", m=b, k=t, n=nh, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=by, library_ms=lib,
            note=f"bf16, causal, {nh}/{n_kv} heads, head size {HEAD_DIM}",
            library="scaled_dot_product_attention(is_causal=True)",
            shape=dict(batch=b, heads=nh, kv_heads=n_kv, t=t, head_dim=HEAD_DIM, causal=True)))
        del qkv
        torch.cuda.empty_cache()


# rms_norm's timed rows: C's decode (4 rows), the engines' verify windows
# (32) and a prefill or training window (1024) at 4096; Gemma-2-9B's 3584
# with Gemma's (1 + w)
NORM_ROWS = [(4, 4096, 0.0), (32, 4096, 0.0), (1024, 4096, 0.0), (1024, 3584, 1.0)]
# widths checked bit for bit as well: head sizes 64-256, OLMo-2's k over
# 1024, the families' hidden sizes, and 100 (not whole 16-byte vectors)
NORM_WIDTHS = [64, 96, 100, 128, 256, 1024, 3072, 3584, 4096, 14336]


def _fp32_rms_norm(x, w, eps, offset=0.0):
    """The norm with its mean square summed by PyTorch in fp32 (the order
    of `torch.mean`, which depends on the rows one call reduces)."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (w.to(torch.float32) + offset)).to(dt)


def _fp64_rms_norm(x, w, eps, offset=0.0):
    """The route the norm kernel replaced: the mean square summed by
    PyTorch in fp64, rounded to fp32."""
    dt = x.dtype
    x = x.to(torch.float32)
    ms = torch.mean(x * x, dim=-1, keepdim=True, dtype=torch.float64).to(torch.float32)
    return ((x * torch.rsqrt(ms + eps)) * (w.to(torch.float32) + offset)).to(dt)


def _rows_invariant(fn, x, w, eps: float, offset: float, counts=(4, 32, 1024)) -> float:
    """The share of x's rows (1024 of them) whose norm computed alone is
    bit-equal to the same row's inside calls of 4, 32 and 1024 rows."""
    alone = torch.cat([fn(x[i:i + 1], w, eps, offset) for i in range(x.shape[0])])
    same = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for c in counts:
        got = torch.cat([fn(x[i:i + c], w, eps, offset) for i in range(0, x.shape[0], c)])
        same &= (got == alone).all(-1)
    return same.float().mean().item()


def phase_b_norm(record, iters: int) -> None:
    """rms_norm (csrc/rms_norm.cu) against its plain twin, bit for bit, over
    fp32, bf16 and fp16 rows of the widths the families norm, offsets 0 and
    1, with a strided input; each row normed alone bit-equal to the same row
    inside calls of 4, 32 and 1024 rows, where the control (PyTorch's fp32
    mean, whose order depends on the rows of the call) must fail; then the
    timed rows against the byte bound, the twin and
    torch.nn.functional.rms_norm (a yardstick the port never calls)."""
    import torch.nn.functional as F

    from hqq_tpu_torch.ops import norm as nm

    gen = torch.Generator(device="cuda").manual_seed(5)
    eps = 1e-6
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for d in NORM_WIDTHS:
            x = (torch.randn((37, d), generator=gen, device="cuda") * 3).to(dt)
            for offset in (0.0, 1.0):
                w = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dt)
                y, ref = nm.rms_norm(x, w, eps, offset), nm.rms_norm_plain(x, w, eps, offset)
                if not torch.equal(y, ref) or not torch.isfinite(y.float()).all():
                    err = (y.float() - ref.float()).abs().max().item()
                    raise AssertionError(f"rms_norm {dt} d={d} offset {offset}: not bit-equal "
                                         f"to its twin, max |err| {err}")
    x = torch.randn((3, 5, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(128, generator=gen, device="cuda").to(torch.float32)
    xt = x.transpose(1, 2)  # a strided [B, H, T, hd] view, as q's heads are
    if not torch.equal(nm.rms_norm(xt, w, eps, 1.0), nm.rms_norm_plain(xt, w, eps, 1.0)):
        raise AssertionError("rms_norm of a strided view with fp32 weights: not bit-equal")
    log(f"[b] rms_norm: bit-equal to its twin over {3 * len(NORM_WIDTHS) * 2} cases (fp32, bf16, "
        f"fp16 rows of {NORM_WIDTHS}, offsets 0 and 1) and a strided view")

    for rows, d, offset in NORM_ROWS:
        _rms_row(record, gen, rows, d, offset, iters, eps)


def _rms_row(record, gen, rows: int, d: int, offset: float, iters: int, eps: float) -> dict:
    """rms_norm over ``rows`` bf16 rows of ``d``: each row normed alone
    bit-equal to the same row in calls of 4, 32 and 1024 rows (PyTorch's
    fp32 mean the control that must not be), bit-equal to its twin, timed
    against the byte bound, the twin and F.rms_norm; recorded."""
    import torch.nn.functional as F

    from hqq_tpu_torch.ops import norm as nm

    x = torch.randn((max(rows, 1024), d), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    inv = _rows_invariant(nm.rms_norm, x, w, eps, offset)
    ctl = _rows_invariant(_fp32_rms_norm, x, w, eps, offset)
    if inv != 1.0 or not ctl < 1.0:
        raise AssertionError(f"rms_norm d={d}: rows invariant {inv} (must be 1), the fp32 "
                             f"mean's control {ctl} (must be < 1)")
    x = x[:rows]
    y, ref = nm.rms_norm(x, w, eps, offset), nm.rms_norm_plain(x, w, eps, offset)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"rms_norm {rows} x {d}: max |err| {err} against its twin")
    each = 2 * x.numel() * x.element_size()
    xs = [x] + [x.clone() for _ in range(max(1, min(64, -(-ROTATE_BYTES // each))) - 1)]
    ms = time_ms([lambda a=a: nm.rms_norm(a, w, eps, offset) for a in xs], iters)
    plain = time_ms([lambda: nm.rms_norm_plain(x, w, eps, offset)], max(3, iters // 10))
    w_lib = (w.float() + offset).to(torch.bfloat16)
    lib = time_ms([lambda a=a: F.rms_norm(a, (d,), w_lib, eps) for a in xs], iters)
    del xs
    b_ms, by = bound_ms(each + d * w.element_size(), 0.0, "bf16", fp32_ops=4.0 * x.numel())
    row = dict(
        kernel="rms_norm", m=rows, k=d, n=d, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=by, library_ms=lib, note=f"bf16, offset {offset:g}",
        library="torch.nn.functional.rms_norm (weight w + offset made before timing)",
        rows_invariant=inv, control_fp32_mean_invariant=ctl,
        plan=str(nm.norm_launch_plan(d, torch.bfloat16)),
        shape=dict(rows=rows, d=d, dtype="bf16", offset=offset))
    record("rms_norm", row)
    return row


# layer_norm's widths: Cohere's per-head q/k (128), gpt2-xl 1600, falcon-rw
# 2048, phi-2 2560, bloom 4096, Falcon-7B 4544, StarCoder2-7B 4608, 8192,
# Command-R+ 12288, and 100 (not whole 16-byte vectors); the timed rows:
# Falcon-7B's and bloom's widths at 4, 32 and 1024 rows
LN_WIDTHS = [100, 128, 1600, 2048, 2560, 4096, 4544, 4608, 8192, 12288]
LN_ROWS = [(rows, d) for d in (4544, 4096) for rows in (4, 32, 1024)]


def _fp32_layer_norm(x, w, b, eps):
    """LayerNorm with its means taken by PyTorch in fp32 (the order of
    `torch.mean`, which depends on the rows one call reduces)."""
    dt = x.dtype
    x = x.to(torch.float32)
    c = x - x.mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps) * w.to(torch.float32)
    return (y if b is None else y + b.to(torch.float32)).to(dt)


def _ln_fp32_rows(x, w, eps, b):
    """`_fp32_layer_norm` in `_rows_invariant`'s argument order."""
    return _fp32_layer_norm(x, w, b, eps)


def _ln_no_bias(x, w, b, eps):
    """A control of layer_norm: the bias dropped."""
    from hqq_tpu_torch.ops import norm as nm

    return nm.layer_norm_plain(x, w, None, eps)


def _ln_no_mean(x, w, b, eps):
    """A control of layer_norm: mu left out (the RMS form), bias kept."""
    from hqq_tpu_torch.ops import norm as nm

    y = nm.rms_norm_plain(x, w, eps).to(torch.float32)
    return (y if b is None else y + b.to(torch.float32)).to(x.dtype)


def phase_b_layer_norm(record, iters: int) -> None:
    """layer_norm (csrc/rms_norm.cu) against its plain twin, bit for bit,
    over fp32, bf16 and fp16 rows of the families' widths, with and
    without a bias, and per-head weights [H, 128] on a strided view (Cohere's
    q/k norm); the controls (the bias dropped, mu left out) must miss; each
    row normed alone bit-equal to the same row inside calls of 4, 32 and
    1024 rows, where the control (PyTorch's fp32 means) must not be; then
    the timed rows against the byte bound, the twin and
    torch.nn.functional.layer_norm (a yardstick the port never calls)."""
    from hqq_tpu_torch.ops import norm as nm

    gen = torch.Generator(device="cuda").manual_seed(6)
    eps = 1e-5
    misses = {"bias dropped": [], "mu left out": []}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for d in LN_WIDTHS:
            x = (torch.randn((37, d), generator=gen, device="cuda") * 3 + 1).to(dt)
            w = (1 + torch.randn(d, generator=gen, device="cuda") * 0.1).to(dt)
            b = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dt)
            for bias in (b, None):
                y, ref = nm.layer_norm(x, w, bias, eps), nm.layer_norm_plain(x, w, bias, eps)
                if not torch.equal(y, ref) or not torch.isfinite(y.float()).all():
                    err = (y.float() - ref.float()).abs().max().item()
                    raise AssertionError(f"layer_norm {dt} d={d} bias {bias is not None}: not "
                                         f"bit-equal to its twin, max |err| {err}")
            ref = nm.layer_norm_plain(x, w, b, eps)
            misses["bias dropped"].append(rel(_ln_no_bias(x, w, b, eps), ref))
            misses["mu left out"].append(rel(_ln_no_mean(x, w, b, eps), ref))
    x = torch.randn((3, 5, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
    w = (1 + torch.randn((5, 128), generator=gen, device="cuda") * 0.1).to(torch.float32)
    xt = x.transpose(1, 2)  # [B, T, H, hd] as a strided view, H = 5
    if not torch.equal(nm.layer_norm(xt, w, None, eps), nm.layer_norm_plain(xt, w, None, eps)):
        raise AssertionError("layer_norm of a strided view with per-head weights: not bit-equal")
    least = {c: min(v) for c, v in misses.items()}
    log(f"[b] layer_norm: bit-equal to its twin over {3 * len(LN_WIDTHS) * 2} cases (fp32, bf16, "
        f"fp16 rows of {LN_WIDTHS}, with and without a bias) and per-head weights on a strided "
        f"view; controls, rel err at the least {least} (each must exceed 0)")
    if not all(v > 0 for v in least.values()):
        raise AssertionError(f"layer_norm: a control matched the twin: {least}")

    for rows, d in LN_ROWS:
        _ln_row(record, gen, rows, d, iters, eps)


def _ln_row(record, gen, rows: int, d: int, iters: int, eps: float = 1e-5,
            dtype=torch.bfloat16) -> dict:
    """layer_norm over ``rows`` rows of ``d`` (bf16, or ``dtype``) with a
    bias: each row normed alone bit-equal to the same row in calls of 4, 32
    and 1024 rows (PyTorch's fp32 means the control that must not be),
    bit-equal to its twin, timed against the byte bound, the twin and
    F.layer_norm; recorded and returned."""
    import torch.nn.functional as F

    from hqq_tpu_torch.ops import norm as nm

    x = (torch.randn((max(rows, 1024), d), generator=gen, device="cuda") + 1).to(dtype)
    w = (1 + torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
    b = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
    # `_rows_invariant` hands its last argument on: here the bias
    inv = _rows_invariant(lambda a, w_, e, b_: nm.layer_norm(a, w_, b_, e), x, w, eps, b)
    ctl = _rows_invariant(_ln_fp32_rows, x, w, eps, b)
    if inv != 1.0 or not ctl < 1.0:
        raise AssertionError(f"layer_norm d={d}: rows invariant {inv} (must be 1), the fp32 "
                             f"means' control {ctl} (must be < 1)")
    x = x[:rows]
    y, ref = nm.layer_norm(x, w, b, eps), nm.layer_norm_plain(x, w, b, eps)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"layer_norm {rows} x {d}: max |err| {err} against its twin")
    each = 2 * x.numel() * x.element_size()
    xs = [x] + [x.clone() for _ in range(max(1, min(64, -(-ROTATE_BYTES // each))) - 1)]
    ms = time_ms([lambda a=a: nm.layer_norm(a, w, b, eps) for a in xs], iters)
    plain = time_ms([lambda: nm.layer_norm_plain(x, w, b, eps)], max(3, iters // 10))
    lib = time_ms([lambda a=a: F.layer_norm(a, (d,), w, b, eps) for a in xs], iters)
    del xs
    b_ms, by = bound_ms(each + 2 * d * w.element_size(), 0.0, "bf16",
                        fp32_ops=8.0 * x.numel())
    name = {torch.bfloat16: "bf16", torch.float32: "fp32"}[dtype]
    row = dict(
        kernel="layer_norm", m=rows, k=d, n=d, max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=by, library_ms=lib, note=f"{name}, bias",
        library="torch.nn.functional.layer_norm", rows_invariant=inv,
        control_fp32_mean_invariant=ctl, plan=str(nm.norm_launch_plan(d, dtype, layer=True)),
        shape=dict(rows=rows, d=d, dtype=name, bias=True))
    record("layer_norm", row)
    return row


def _qmm_row(record, gen, m: int, k: int, n: int, iters: int, g: int = 64,
             note: str = "") -> dict:
    """quant_matmul at (M, K, N), 4-bit g64 fp32 meta: within 2^-7 of
    max|y| of its plain twin, its time against the bound, the twin and
    torch.matmul on the dequantized bf16 W; recorded and returned."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    kqt = _make_kqt(n, k, g, 4, seed=k * 3 + n)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    y = fm.quant_matmul(x, kqt).float()
    ref = fm.quant_matmul_plain(x, kqt).float()
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    # identical bf16 operands and exact products; fp32 sums in another
    # order, then one bf16 rounding of the output (2^-7 of its magnitude)
    if not (err <= 2.0**-7 * scale) or not torch.isfinite(y).all():
        raise AssertionError(f"quant_matmul M={m} K={k} N={n}: err {err} > 2^-7 * {scale}")
    wbytes = kqt.wq.numel() + 8 * kqt.scale.numel()
    kq, xq = _copies(kqt, x, wbytes)
    ms = time_ms([lambda a=a, b=b: fm.quant_matmul(b, a) for a, b in zip(kq, xq)], iters)
    plain = time_ms([lambda: fm.quant_matmul_plain(x, kqt)], max(3, iters // 10))
    w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
    lib = time_ms([lambda: torch.matmul(x, w_bf16.t())], iters)
    del w_bf16, kq, xq
    b_ms, by = bound_ms(wbytes + 2 * m * k + 2 * m * n, 2.0 * m * n * k, "bf16")
    row = dict(kernel="quant_matmul", m=m, k=k, n=n, max_abs_err=err, ms=ms, plain_ms=plain,
               bound_ms=b_ms, bound_by=by, library_ms=lib, note=note)
    record("quant_matmul", row)
    return row


def phase_b() -> dict:
    from hqq_tpu_torch.ops import fused_matmul as fm

    iters = 100
    g = 64
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(1)

    def record(key, row):
        rows.setdefault(key, []).append(row)
        log("[b] " + json.dumps(row))

    # -- w4a8_matmul: M in {1, 4, 8, 32} at the 7B shapes, and K % 8g != 0;
    # each on fp32 and on bf16 scale and zs of the same weight --------------
    shapes = [(4096, 4096), (4096, 11008), (11008, 4096)]
    cases = [(m, k, n) for (k, n) in shapes for m in (1, 4, 8, 32)]
    cases.append((4, 4096 + 3 * g, 4096))  # K % 8g != 0 (the `_qmm_a8_kernel` route)
    cases += [(8, 4096, n) for n in FUSED_WIDTHS]  # fuse_for_decode's q/k/v and gate/up
    cases += R_DECODE_SHAPES  # path R's Gemma-2-9B
    cases += L_DECODE_SHAPES  # path L's Falcon-7B (K = 4544: not whole 256-code stages)
    for (m, k, n) in cases:
        _w4a8_b_rows(record, gen, m, k, n, iters)

    # -- quant_matmul at the prefill shapes of paths C (M = 512) and H (M =
    # 1023), and at M = 4 (the pallas backend's decode, 8-bit weights) ------
    qmm_shapes = [(4096, 4096), (4096, 11008), (11008, 4096)]
    for (m, k, n) in [(m, k, n) for m in (512, 1023) for (k, n) in qmm_shapes] + [(4, 4096, 4096)] \
            + [(512, 4096, n) for n in FUSED_WIDTHS] + R_PREFILL_SHAPES + L_PREFILL_SHAPES:
        _qmm_row(record, gen, m, k, n, iters)

    def held(name, y, ref, tol_rel, what):
        """Largest error of ``y`` against ``ref``, held to tol_rel * max|ref|."""
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not (err <= tol_rel * scale) or not torch.isfinite(y).all():
            raise AssertionError(f"{name} {what}: err {err} > {tol_rel} * {scale}")
        return err

    r = LORA_RANK
    # -- quant_matmul_lora at the prefill shapes of path E, and at M = 4 (the
    # pallas backend's decode) --------------------------------------------
    for (m, k, n) in [(512, 4096, 4096), (512, 4096, 11008), (512, 11008, 4096), (4, 4096, 4096)]:
        kqt = _make_kqt(n, k, g, 4, seed=k * 11 + n)
        a, b = _make_lora(k, n, seed=12)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        # as quant_matmul, plus the rank-r partial's own fp32 sums: 2^-7 of max|y|
        err = held("quant_matmul_lora", fm.quant_matmul_lora(x, kqt, a, b),
                   fm.quant_matmul_lora_plain(x, kqt, a, b), 2.0**-7, f"M={m} K={k} N={n} r={r}")
        wbytes = _weight_bytes(kqt)
        kq, xq = _copies(kqt, x, wbytes)
        # as the serving layers call it: A^T built from a at each call
        calls = [lambda p=p, q=q: fm.quant_matmul_lora(q, p, a, b) for p, q in zip(kq, xq)]
        ms = time_ms(calls, iters)
        plain = time_ms([lambda: fm.quant_matmul_lora_plain(x, kqt, a, b)], max(3, iters // 10))
        w_bf16, a_bf16 = fm.dequant_plain(kqt, torch.bfloat16), a.to(torch.bfloat16)
        lib = time_ms([lambda: torch.matmul(x, w_bf16.t()).float()
                       + torch.matmul(torch.matmul(x, a_bf16).float(), b)], iters)
        del w_bf16
        b_ms, by = bound_ms(wbytes + 2 * m * k + 2 * m * n + 4 * r * (k + n),
                            2.0 * m * n * k + 2.0 * m * k * r, "bf16", fp32_ops=2.0 * m * r * n)
        record("quant_matmul_lora", dict(
            kernel="quant_matmul_lora", m=m, k=k, n=n, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=by, library_ms=lib,
            note="r=8", library="three torch.matmul calls and their sum"))
        alone = time_ms(calls, iters, only="qmm_")
        log(f"[b] quant_matmul_lora M={m} K={k} N={n}: {ms:.4f} ms with A^T built per call, "
            f"{alone:.4f} ms of it in the qmm_ kernels")
        del kq, xq

    # -- w4a8_lora_matmul at the decode shapes of path E (M = 4) and of a
    # paged engine of 8 slots, on fp32 and bf16 scale and zs ----------------
    for (m, k, n) in [(4, 4096, 4096), (4, 4096, 11008), (4, 11008, 4096), (1, 4096, 4096),
                      (8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096)]:
        a, b = _make_lora(k, n, seed=m)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        x8, sx = fm.quantize_activations_int8(x)
        xa = x.float() @ a
        for kqt in (_make_kqt(n, k, g, 4, seed=k * 5 + n), _make_kqt_bf16(n, k, g, 4, seed=k * 5 + n)):
            meta = "bf16 meta" if kqt.scale.dtype == torch.bfloat16 else ""
            worst = _w4a8_held(f"w4a8_lora_matmul M={m} K={k} N={n} {meta}", kqt,
                               lambda q, dt: fm.w4a8_lora_matmul(x8, sx, q, xa, b, dt),
                               lambda q, dt: fm.w4a8_lora_matmul_plain(x8, sx, q, xa, b, dt))
            wbytes = _weight_bytes(kqt)
            kq, xq = _copies(kqt, x8, wbytes)
            ms = time_ms([lambda p=p, q=q: fm.w4a8_lora_matmul(q, sx, p, xa, b, torch.bfloat16)
                          for p, q in zip(kq, xq)], iters)
            plain = time_ms([lambda: fm.w4a8_lora_matmul_plain(x8, sx, kqt, xa, b,
                                                               torch.bfloat16)],
                            max(3, iters // 10))
            w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
            lib = time_ms([lambda: torch.matmul(x, w_bf16.t()).float()
                           + torch.matmul(torch.matmul(x.float(), a), b)], iters)
            del w_bf16, kq, xq
            b_ms, by = bound_ms(wbytes + m * k + 4 * m + 4 * m * r + 4 * r * n + 2 * m * n,
                                2.0 * m * n * k, "int8", fp32_ops=2.0 * m * r * n)
            record("w4a8_lora_matmul", dict(
                kernel="w4a8_lora_matmul", m=m, k=k, n=n, max_abs_err=worst, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=lib,
                note="r=8" + (", " + meta if meta else ""),
                library="three torch.matmul calls and their sum"))

    # -- quant_matmul_ax0 with path F's configs at path F's shapes (attention
    # 3-bit g64, MLP 2-bit g16), decode and prefill; fp32 meta at 2-bit g16
    # too, which the path does not run, for what bf16 meta buys
    mlp_shapes = [(4096, 11008), (11008, 4096)]
    for nbits, g0, meta, kn in [(3, 64, torch.float32, [(4096, 4096)]),
                                (2, 16, torch.bfloat16, mlp_shapes),
                                (2, 16, torch.float32, mlp_shapes[:1])]:
        note = f"{nbits}-bit g{g0} axis=0, {'bf16' if meta == torch.bfloat16 else 'fp32'} meta"
        for (m, k, n) in [(m, k, n) for (k, n) in kn for m in (4, 512)]:
            kqt = _make_kqt0(n, k, g0, nbits, meta, seed=nbits * 100 + m)
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            # the bar of quant_matmul: fp32 sums in another order (split over
            # K at small M), then one bf16 rounding of the output
            err = held("quant_matmul_ax0", fm.quant_matmul_ax0(x, kqt),
                       fm.quant_matmul_ax0_plain(x, kqt), 2.0**-7, f"{note} M={m} K={k} N={n}")
            wbytes = _weight_bytes(kqt)
            kq, xq = _copies(kqt, x, wbytes)
            ms = time_ms([lambda p=p, q=q: fm.quant_matmul_ax0(q, p) for p, q in zip(kq, xq)], iters)
            plain = time_ms([lambda: fm.quant_matmul_ax0_plain(x, kqt)], max(3, iters // 10))
            w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
            lib = time_ms([lambda: torch.matmul(x, w_bf16.t())], iters)
            del w_bf16, kq, xq
            b_ms, by = bound_ms(wbytes + 2 * m * k + 2 * m * n, 2.0 * m * n * k, "bf16")
            record("quant_matmul_ax0", dict(
                kernel="quant_matmul_ax0", m=m, k=k, n=n, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=by, library_ms=lib, note=note))

    fused_against_parts(rows)
    phase_b_dequant(record, iters)
    phase_b_grouped(record, iters)
    torch.cuda.empty_cache()
    phase_b_attention(record, held, iters)
    phase_b_norm(record, iters)
    phase_b_layer_norm(record, iters)
    phase_b_p(record, iters)
    phase_b_n(record, iters)
    phase_b_t(record, iters)
    phase_b_bf16_meta(record, held, iters)
    phase_b_fp32(record, held, iters)
    phase_b_backward(record, held, iters)
    phase_b_u(record)
    log(f"[b] card right after the timings: {card_state()}")
    return rows


def _w4a8_b_rows(record, gen, m: int, k: int, n: int, iters: int,
                 bf16_meta: bool = True) -> None:
    """w4a8_matmul at (M, K, N), 4-bit g64, on fp32 scale and zs (and on
    bf16 ones of the same weight): held to its twin with phase b's bars and
    controls (`_w4a8_held`), timed against the bound, the twin and
    torch.matmul on the dequantized bf16 W; recorded."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    g = 64
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    x8, sx = fm.quantize_activations_int8(x)
    kqts = [_make_kqt(n, k, g, 4, seed=k * 7 + n)]
    if bf16_meta:
        kqts.append(_make_kqt_bf16(n, k, g, 4, seed=k * 7 + n))
    for kqt in kqts:
        note = "4-bit g64 axis=1, bf16 meta" if kqt.scale.dtype == torch.bfloat16 else ""
        worst = _w4a8_held(f"w4a8_matmul M={m} K={k} N={n} {note}", kqt,
                           lambda q, dt: fm.w4a8_matmul(x8, sx, q, dt),
                           lambda q, dt: fm.w4a8_matmul_plain(x8, sx, q, dt))
        wbytes = _weight_bytes(kqt)
        kq, xq = _copies(kqt, x8, wbytes)
        sxs = [sx.clone() for _ in kq]
        ms = time_ms([lambda a=a, b=b, s=s: fm.w4a8_matmul(b, s, a, torch.bfloat16)
                      for a, b, s in zip(kq, xq, sxs)], iters)
        plain = time_ms([lambda: fm.w4a8_matmul_plain(x8, sx, kqt, torch.bfloat16)],
                        max(3, iters // 10))
        w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
        lib = time_ms([lambda: torch.matmul(x, w_bf16.t())], iters)
        del w_bf16, kq, xq, sxs
        nbytes = wbytes + m * k + 4 * m + 2 * m * n
        b_ms, by = bound_ms(nbytes, 2.0 * m * n * k, "int8")
        plan = fm.w4a8_launch_plan(m, n, k, kqt.container_bits, g, kqt.scale.dtype)
        record("w4a8_matmul", dict(kernel="w4a8_matmul", m=m, k=k, n=n, max_abs_err=worst,
                                   ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                                   library_ms=lib, note=note,
                                   plan=f"{plan.route} {plan.col_tile} rows x "
                                        f"{plan.k_slices} slices, ring {plan.stages}"))


def fused_against_parts(rows) -> None:
    """Each fused width of phase b beside the summed time of the unfused
    layers it joins, at the same M: q/k/v (12288) as three of 4096,
    gate/up (22016) as two of 11008; the launch plans of the fused widths
    from M = 64 to 1024 (the prefill buckets)."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    for kernel, m in (("w4a8_matmul", 8), ("quant_matmul", 512)):
        ms = {r["n"]: r["ms"] for r in rows[kernel]
              if (r["m"], r["k"], r.get("note", "")) == (m, 4096, "")}
        for n, (part, count) in FUSED_WIDTHS.items():
            log(f"[b] {kernel} M={m} K=4096: fused N={n} {ms[n]:.4f} ms against {count} x "
                f"N={part} {count * ms[part]:.4f} ms ({ms[n] / (count * ms[part]):.3f}x)")
    for n in FUSED_WIDTHS:
        plans = {m: fm.qmm_launch_plan(m, n, 4096, 4, 64) for m in (64, 128, 256, 512, 1024)}
        log(f"[b] qmm_launch_plan at N={n}: " + "; ".join(
            f"M={m}: tile {p.token_tile}, ring {p.stages}, grid {p.grid}" for m, p in plans.items()))


def _make_kqt_bf16(n: int, k: int, g: int, nbits: int, seed: int):
    from hqq_tpu_torch.core.quantize import quantize
    from hqq_tpu_torch.ops.fused_matmul import to_kernel_layout

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device="cuda") / k**0.5
    return to_kernel_layout(quantize(w, nbits=nbits, group_size=g, axis=1,
                                     round_zero=(nbits == 4)), torch.bfloat16)


def _meta_controls(kqt):
    """Two wrong readings of a bf16-meta axis=1 layout, as fp32-meta layouts
    for the plain versions: each group with its neighbour's scale, and zs
    read without the 8 * scale that the 4-bit container's stored zs lacks."""
    import dataclasses

    groups = kqt.k // kqt.group_size
    scale = kqt.scale[:, :groups].float().contiguous()
    zs = kqt.zs[:, :groups].float().contiguous()
    return {"neighbour's scale": dataclasses.replace(kqt, scale=scale.roll(1, dims=1),
                                                     zs=zs + 8 * scale),
            "zs offset dropped": dataclasses.replace(kqt, scale=scale, zs=zs)}


def _word_neighbour(kqt):
    """The fault that groups shorter than a word invite: each field read with
    the scale and zs of the other group of its pair in the same 32-bit word
    (group j with j ^ 1's), as an fp32-meta layout for the plain twins; None
    where a group is whole words."""
    import dataclasses

    from hqq_tpu_torch.ops import fused_matmul as fm

    groups = kqt.k // kqt.group_size
    if kqt.group_size * kqt.container_bits >= 32 or groups % 2:
        return None
    scale, zs = fm._ax1_meta(kqt)
    pair = torch.arange(groups, device=scale.device) ^ 1
    return dataclasses.replace(kqt, scale=scale[:, pair].contiguous(),
                               zs=zs[:, pair].contiguous())


def _w4a8_controls(kqt):
    """Wrong readings of a w4a8 layout, for the plain twins: each group with
    its neighbour's scale; for bf16 meta in the 4-bit container also zs read
    without the 8 * scale that its stored zs lacks (`_meta_controls`); for
    groups shorter than a word, each field with the meta of the other group
    of its pair in the word (`_word_neighbour`)."""
    import dataclasses

    from hqq_tpu_torch.ops import fused_matmul as fm

    if kqt.scale.dtype == torch.bfloat16:
        controls = _meta_controls(kqt)
        if not fm._ax1_zs_offset(kqt.container_bits, kqt.scale.dtype):
            del controls["zs offset dropped"]  # no offset to drop outside the 4-bit container
    else:
        controls = {"neighbour's scale": dataclasses.replace(kqt, scale=kqt.scale.roll(1, dims=1))}
    word = _word_neighbour(kqt)
    if word is not None:
        controls["the word's other group"] = word
    return controls


def _w4a8_held(what: str, kqt, kernel, plain) -> float:
    """``kernel(kqt, dtype)`` against ``plain(kqt, dtype)``: within 1e-5 of
    max|y| in fp32 (exact group dots, fp32 folds in another order) and 2^-7
    in bf16 (one rounding more); each control of `_w4a8_controls` must miss
    both bars; three runs bit-equal. Returns the largest error."""
    worst = 0.0
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
        y, ref = kernel(kqt, dt), plain(kqt, dt)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        if not (err <= tol * ref.float().abs().max().item()) or not torch.isfinite(y).all():
            raise AssertionError(f"{what} {dt}: err {err} > {tol} * max|y|")
        worst = max(worst, err)
    ref = plain(kqt, torch.float32)
    misses = {c: rel(plain(bad, torch.float32), ref) for c, bad in _w4a8_controls(kqt).items()}
    runs = [kernel(kqt, torch.float32) for _ in range(3)]
    equal = all(torch.equal(r, runs[0]) for r in runs[1:])
    log(f"[b] {what}: rel err fp32 {rel(runs[0], ref):.3e} (tol 1e-5); controls "
        f"{ {c: round(v, 4) for c, v in misses.items()} } (must exceed 2^-7); three runs "
        f"bit-equal: {equal}")
    if not all(v > 2.0**-7 for v in misses.values()):
        raise AssertionError(f"{what}: the bar does not catch a wrong meta")
    if not equal:
        raise AssertionError(f"{what}: repeated runs differ")
    return worst


def _qt_bytes(qt) -> int:
    """Bytes of a canonical QTensor's codes and meta (meta-quantized meta
    counted by its own codes and meta)."""
    from hqq_tpu_torch.core.quantize import QTensor

    def size(t):
        return _qt_bytes(t) if isinstance(t, QTensor) else t.numel() * t.element_size()

    return size(qt.wq) + size(qt.scale) + size(qt.zero)


def _qt_copies(qt, bytes_each: int):
    """Copies of a canonical QTensor enough to overflow L2 (`_copies`)."""
    import dataclasses

    from hqq_tpu_torch.core.quantize import QTensor

    def clone(t):
        if isinstance(t, QTensor):
            return dataclasses.replace(t, wq=t.wq.clone(), scale=clone(t.scale),
                                       zero=clone(t.zero))
        return t.clone()

    n = max(1, min(16, -(-ROTATE_BYTES // max(bytes_each, 1))))
    return [qt] + [clone(qt) for _ in range(n - 1)]


def _canonical_control(qt, dtype):
    """The kernel layouts' formula c*s - z*s in place of (c - z)*s, in the
    meta type T, by plain torch on the card: must not be bit-equal."""
    from hqq_tpu_torch.core.quantize import resolve_meta, unpack_codes

    qt = resolve_meta(qt)
    c = unpack_codes(qt, torch.promote_types(qt.scale.dtype, qt.zero.dtype))
    return (c * qt.scale - qt.zero * qt.scale).reshape(qt.shape).to(dtype)


def _dequant_case(record, kernel: str, note: str, k: int, n: int, run, plain, controls: dict,
                  copies: list, nbytes: int, iters: int) -> None:
    """One dequant case of phase b: ``run(copy)`` against ``plain()`` bit for
    bit (err must be exactly 0), each control (name -> W) not bit-equal to
    the plain W, three runs bit-equal; device ms over the input copies, plain
    ms, and the bound by the bytes (inputs read once, W written once)."""
    y, ref = run(copies[0]), plain()
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    if err != 0.0 or not torch.equal(y, ref):
        raise AssertionError(f"{kernel} {note} {n}x{k}: err {err} != 0")
    misses = {c: rel(w, ref) for c, w in controls.items() if not torch.equal(w, ref)}
    runs = [run(copies[0]) for _ in range(3)]
    equal = all(torch.equal(r, runs[0]) for r in runs[1:])
    del y, ref, runs
    ms = time_ms([lambda c=c: run(c) for c in copies], iters)
    plain_ms = time_ms([plain], max(3, iters // 10))
    b_ms, by = bound_ms(nbytes, 2.0 * n * k, "fp32")
    log(f"[b] {kernel} {note or '4-bit g64 axis=1, fp32 meta'}, W [{n}, {k}] to bf16: err "
        f"{err} (must be 0); controls {misses} (each must differ: "
        f"{sorted(controls)}); three runs bit-equal: {equal}; {ms:.4f} ms, "
        f"{b_ms / ms:.0%} of the byte bound {b_ms:.4f} ms; plain {plain_ms:.4f} ms")
    if len(misses) != len(controls):
        raise AssertionError(f"{kernel} {note}: a control is bit-equal to the plain W")
    if not equal:
        raise AssertionError(f"{kernel} {note}: repeated runs differ")
    record(kernel, dict(kernel=kernel, m=None, k=k, n=n, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                        note=note))


def phase_b_dequant(record, iters: int) -> None:
    """The dequant kernel's three entries to bf16, each bit-equal to its
    plain twin: row 4 (the axis=1 kernel layout, 4-bit g64 at 4096 x 11008,
    fp32 and bf16 meta; the axis=0 one, 2-bit g16 bf16 meta) with the
    controls a neighbour's scale and, for bf16 meta, the zs offset dropped;
    the canonical QTensor at path I's three shapes (4-bit g64 axis=1, fp32
    meta) and in 2-bit g16 axis=0, 3-bit g64, bf16 meta and meta-quantized,
    with the control c*s - z*s in place of (c - z)*s. No PyTorch call
    computes the function (library ms: none)."""
    import dataclasses
    from unittest import mock

    from hqq_tpu_torch.core.quantize import quantize
    from hqq_tpu_torch.ops import fused_matmul as fm

    bf16 = torch.bfloat16
    n, k = 4096, 11008
    for note, kqt in (("", _make_kqt(n, k, 64, 4, seed=5)),
                      ("4-bit g64 axis=1, bf16 meta",
                       _make_kqt_bf16(n, k, 64, 4, seed=k + n + len("dequant")))):
        controls = {c: fm.dequant_plain(bad, bf16) for c, bad in _w4a8_controls(kqt).items()}
        wbytes = _weight_bytes(kqt)
        kq, _ = _copies(kqt, None, wbytes + 2 * n * k)
        _dequant_case(record, "dequant", note, k, n, lambda q: fm.dequant(q, bf16),
                      lambda: fm.dequant_plain(kqt, bf16), controls, kq, wbytes + 2 * n * k,
                      iters)
        del kq, controls
    n, k = 11008, 4096
    kqt = _make_kqt0(n, k, 16, 2, bf16, seed=6)
    wbytes = _weight_bytes(kqt)
    bad = dataclasses.replace(kqt, scale=kqt.scale.roll(1, dims=0))
    kq, _ = _copies(kqt, None, wbytes + 2 * n * k)
    _dequant_case(record, "dequant", "2-bit g16 axis=0, bf16 meta", k, n,
                  lambda q: fm.dequant(q, bf16), lambda: fm.dequant_plain(kqt, bf16),
                  {"neighbour's scale": fm.dequant_plain(bad, bf16)}, kq, wbytes + 2 * n * k,
                  iters)
    del kq, bad, kqt
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = [("canonical 4-bit g64 axis=1, fp32 meta", n_, k_, dict(nbits=4, group_size=64))
             for n_, k_ in ((4096, 4096), (11008, 4096), (4096, 11008))] + [
        ("canonical 2-bit g16 axis=0, fp32 meta", 11008, 4096,
         dict(nbits=2, group_size=16, axis=0)),
        ("canonical 3-bit g64 axis=1, fp32 meta", 4096, 4096, dict(nbits=3, group_size=64)),
        ("canonical 4-bit g64 axis=1, bf16 meta", 4096, 11008,
         dict(nbits=4, group_size=64, meta_dtype=bf16)),
        ("canonical 4-bit g64 axis=1, 8-bit meta-quantized scale and zero", 4096, 11008,
         dict(nbits=4, group_size=64, scale_quant_params={}, zero_quant_params={}))]
    for note, n, k, kw in cases:
        w = torch.randn((n, k), generator=gen, device="cuda") / k**0.5
        qt = quantize(w, round_zero=kw["nbits"] == 4, **kw)
        del w
        nbytes = _qt_bytes(qt) + 2 * n * k
        copies = _qt_copies(qt, nbytes)

        def plain(qt=qt):  # meta-quantized meta through the plain twin too
            with mock.patch.object(fm, "dequant_canonical", fm.dequantize_plain):
                return fm.dequantize_plain(qt, bf16)

        _dequant_case(record, "dequant_canonical", note, k, n,
                      lambda q: fm.dequant_canonical(q, bf16), plain,
                      {"c*s - z*s": _canonical_control(qt, bf16)}, copies, nbytes, iters)
        del copies, qt
        torch.cuda.empty_cache()


# the experts' stacks of paths X (E, N, K) and the rows an expert holds
# there: Mixtral-8x7B's w1/w3 and w2 at C = 1, 4 (8 slots at capacity
# factor 2), 8 (8 slots at capacity factor 4.0, as phase x serves it) and 32
# (the kernel's largest); Qwen3-30B-A3B's at C = 1 and gpt-oss-20b's at C = 2
# (8 slots: top-8 of 128 and top-4 of 32 at 2.0); path K's, where every
# expert takes every token: Moonlight-16B-A3B's w1/w3 and w2 at C = 8 (the
# dense engine's 8 slots), DeepSeek-V3's at C = 4 (a decode step of 4) and
# 32 (a prefill of 4 x 8)
GROUPED_CASES = [(8, 14336, 4096, c) for c in (1, 4, 8, 32)] + [(8, 4096, 14336, c)
                                                                for c in (1, 4, 8, 32)] + [
    (128, 768, 2048, 1), (128, 2048, 768, 1), (32, 5760, 2880, 2), (32, 2880, 2880, 2),
    (64, 1408, 2048, 8), (64, 2048, 1408, 8)] + [
    (256, n, k, c) for c in (4, 32) for n, k in ((2048, 7168), (7168, 2048))]
GROUPED_BF16_META = {(8, 14336, 4096, 4), (128, 768, 2048, 1), (32, 5760, 2880, 2)}


def _grouped_stack(e: int, n: int, k: int, meta, seed: int):
    """A stack of E random 4-bit g64 experts [N, K] (codes and meta drawn
    directly, no solver: the kernel's arithmetic does not care), as the
    stacked QTensor of a GroupedQuantLinear."""
    from hqq_tpu_torch.nn.moe import GroupedQuantLinear

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = n * k // 64
    wq = torch.randint(0, 256, (e, rows // 2, 64), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.uint8)
    scale = (torch.rand((e, rows, 1), generator=gen, device="cuda") * 0.02 + 1e-3).to(meta)
    zero = torch.randint(0, 16, (e, rows, 1), generator=gen, device="cuda").float().to(meta)
    return GroupedQuantLinear(wq, scale, zero, 4, 64, 1, (n, k), "4bit_u8",
                              torch.bfloat16).qtensor()


def _grouped_controls(qt) -> dict:
    """Inputs that must miss the bar: each group with its neighbour's scale,
    and expert e reading expert e+1's codes."""
    import dataclasses

    return {"neighbour's scale": dataclasses.replace(qt, scale=qt.scale.roll(1, 1)),
            "expert e+1's codes": dataclasses.replace(qt, wq=qt.wq.roll(-1, 0))}


def phase_b_grouped(record, iters: int, cases=None) -> None:
    """The grouped expert kernel against its plain twin at paths X's and K's stacks
    (`GROUPED_CASES`; fp32 meta, and bf16 meta at three of them): within
    2^-7 of max|y|, three runs bit-equal, the controls past the bar; device
    ms, plain ms, the byte bound (all E experts' codes and meta, x and y),
    and `torch.bmm` on the pre-dequantized bf16 stack as the library call.
    The stacked `dequant_canonical` of each case bit-equal to E single
    calls and to its plain twin, timed against its byte bound."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    bf16 = torch.bfloat16
    if cases is None:  # paths X's and K's stacks
        cases = [(c, torch.float32) for c in GROUPED_CASES] + [
            (c, bf16) for c in GROUPED_CASES if c in GROUPED_BF16_META]
    dequant_done = set()
    for i, ((e, n, k, c), meta) in enumerate(cases):
        qt = _grouped_stack(e, n, k, meta, seed=100 + i)
        x = torch.randn((e, c, k), generator=torch.Generator(device="cuda").manual_seed(i),
                        device="cuda").to(bf16)
        note = f"{e} experts, 4-bit g64, {'bf16' if meta == bf16 else 'fp32'} meta"
        plan = fm.grouped_plan_for(x, qt)
        if plan.route != "kernel":
            raise AssertionError(f"grouped_matmul {note} C={c}: the plan sends it to {plan.route}")
        y, ref = fm.grouped_matmul(x, qt), fm.grouped_matmul_plain(x, qt)
        err = rel(y, ref)
        misses = {name: rel(fm.grouped_matmul_plain(x, bad), ref)
                  for name, bad in _grouped_controls(qt).items()}
        runs = [fm.grouped_matmul(x, qt) for _ in range(3)]
        equal = all(torch.equal(r, y) for r in runs)
        del y, ref, runs
        ms = time_ms([lambda: fm.grouped_matmul(x, qt)], iters)
        plain_ms = time_ms([lambda: fm.grouped_matmul_plain(x, qt)], max(3, iters // 20))
        w = fm.dequant_stacked_plain(qt, bf16)
        lib = time_ms([lambda: torch.bmm(x, w.transpose(1, 2))], iters)
        nbytes = _qt_bytes(qt) + 2 * e * c * (k + n)
        b_ms, by = bound_ms(nbytes, 2.0 * e * c * n * k, "bf16")
        log(f"[b] grouped_matmul {note}, x [{e}, {c}, {k}] . W^T [{n}, {k}]: rel err {err:.3e} "
            f"(bar 2^-7), controls {misses}, three runs bit-equal: {equal}; {ms:.4f} ms, "
            f"{b_ms / ms:.0%} of the byte bound {b_ms:.4f} ms; plain {plain_ms:.4f} ms; "
            f"torch.bmm on the dequantized bf16 stack {lib:.4f} ms; plan {plan.why}")
        if not err <= 2.0**-7 or not all(v > 2.0**-7 for v in misses.values()) or not equal:
            raise AssertionError(f"grouped_matmul {note} C={c} [{n}, {k}]: err {err:.3e}, "
                                 f"controls {misses}, repeated runs equal {equal}")
        record("grouped_matmul", dict(kernel="grouped_matmul", m=c, k=k, n=n, max_abs_err=err,
                                      ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                      library_ms=lib, note=note))
        if (e, n, k, meta) not in dequant_done:  # the stacked canonical dequant, once a stack
            dequant_done.add((e, n, k, meta))
            wk = fm.dequant_canonical(qt, bf16)
            singles = all(torch.equal(wk[j], fm.dequant_canonical(fm.expert_qtensor(qt, j), bf16))
                          for j in range(e))
            twin = torch.equal(wk, w)
            del wk
            dms = time_ms([lambda: fm.dequant_canonical(qt, bf16)], iters)
            dplain = time_ms([lambda: fm.dequant_stacked_plain(qt, bf16)], max(3, iters // 20))
            dbytes = _qt_bytes(qt) + 2 * e * n * k
            db_ms, dby = bound_ms(dbytes, 2.0 * e * n * k, "fp32")
            log(f"[b] dequant_canonical over a stack of {note}, W [{e}, {n}, {k}] to bf16 in one "
                f"launch: bit-equal to {e} single calls {singles}, to the plain twin {twin}; "
                f"{dms:.4f} ms, {db_ms / dms:.0%} of the byte bound {db_ms:.4f} ms; plain "
                f"{dplain:.4f} ms")
            if not (singles and twin):
                raise AssertionError(f"the stacked dequant of {note} [{n}, {k}] is not bit-equal")
            record("dequant_canonical", dict(kernel="dequant_canonical", m=None, k=k, n=n,
                                             max_abs_err=0.0, ms=dms, plain_ms=dplain,
                                             bound_ms=db_ms, bound_by=dby, library_ms=None,
                                             note=f"stacked: {note}"))
        del w, qt, x
        torch.cuda.empty_cache()


def phase_b_bf16_meta(record, held, iters: int) -> None:
    """Fault 1: the axis=1 kernels on a layout with bf16 scale and zs (the
    meta hqq_tpu serves), against their plain versions at the bars of the
    fp32-meta rows; each control must miss the bar."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    gen = torch.Generator(device="cuda").manual_seed(7)
    note = "4-bit g64 axis=1, bf16 meta"
    r = LORA_RANK
    for kernel, (m, k, n) in [("quant_matmul", (512, 4096, 4096)),
                              ("quant_matmul_lora", (512, 4096, 4096)),
                              ("w4a8_matmul", (4, 4096, 11008)),
                              ("w4a8_lora_matmul", (4, 4096, 11008))]:
        kqt = _make_kqt_bf16(n, k, 64, 4, seed=k + n + len(kernel))
        a, b = _make_lora(k, n, seed=13)
        mm = m
        x = torch.randn((mm, k), generator=gen, device="cuda").to(torch.bfloat16)
        x8, sx = fm.quantize_activations_int8(x)
        xa = x.float() @ a
        wbytes = _weight_bytes(kqt)
        calls = {  # kernel(kqt), plain(kqt), bar, bytes, ops, library
            "quant_matmul": (lambda q: fm.quant_matmul(x, q), lambda q: fm.quant_matmul_plain(x, q),
                             2.0**-7, wbytes + 4 * mm * k, 2.0 * mm * n * k),
            "quant_matmul_lora": (lambda q: fm.quant_matmul_lora(x, q, a, b),
                                  lambda q: fm.quant_matmul_lora_plain(x, q, a, b), 2.0**-7,
                                  wbytes + 4 * mm * k + 4 * r * (k + n), 2.0 * mm * n * k),
            "w4a8_matmul": (lambda q: fm.w4a8_matmul(x8, sx, q, torch.float32),
                            lambda q: fm.w4a8_matmul_plain(x8, sx, q, torch.float32), 1e-5,
                            wbytes + mm * k + 4 * mm * n, 2.0 * mm * n * k),
            "w4a8_lora_matmul": (lambda q: fm.w4a8_lora_matmul(x8, sx, q, xa, b, torch.float32),
                                 lambda q: fm.w4a8_lora_matmul_plain(x8, sx, q, xa, b,
                                                                     torch.float32),
                                 1e-5, wbytes + mm * k + 4 * mm * n + 4 * r * (mm + n),
                                 2.0 * mm * n * k),
        }
        run, plain, tol, nbytes, ops = calls[kernel]
        err = held(kernel, run(kqt), plain(kqt), tol, f"{note} M={m} K={k} N={n}")
        misses = {c: rel(plain(bad), plain(kqt)) for c, bad in _meta_controls(kqt).items()}
        log(f"[b] {kernel} {note}: controls {misses} (must exceed {tol})")
        if not all(v > tol for v in misses.values()):
            raise AssertionError(f"[b] {kernel}: the bar does not catch a wrong bf16 meta")
        kq, _ = _copies(kqt, None, wbytes)
        ms = time_ms([lambda q=q: run(q) for q in kq], iters)
        plain_ms = time_ms([lambda: plain(kqt)], max(3, iters // 10))
        lib = None
        if kernel == "quant_matmul_lora":  # the three calls and their sum, as for fp32 meta
            w_bf16, a_bf16 = fm.dequant_plain(kqt, torch.bfloat16), a.to(torch.bfloat16)
            lib = time_ms([lambda: torch.matmul(x, w_bf16.t()).float()
                           + torch.matmul(torch.matmul(x, a_bf16).float(), b)], iters)
            del w_bf16
        else:
            w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
            lib = time_ms([lambda: torch.matmul(x, w_bf16.t())], iters)
            del w_bf16
        del kq
        kind = "int8" if kernel.startswith("w4a8") else "bf16"
        b_ms, by = bound_ms(nbytes, ops, kind)
        record(kernel, dict(kernel=kernel, m=m, k=k, n=n, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=lib,
                            note=note))
        torch.cuda.empty_cache()


# fp32 routes against their fp32 plain versions: the same fp32 products
# summed in another order (matmuls: the w4a8 bar in fp32; qmm_fp32 forms
# them from three TF32 products, dropping small x small, ~2^-22 of each),
# and exp2 against exp with sums in another order (attention); a bf16
# rounding of the inputs is 2^-9 of them and must miss both, and so must one
# TF32 product (~2^-11 of each)
TOL_QMM_FP32, TOL_FLASH_FP32 = 1e-5, 1e-4


def phase_b_fp32(record, held, iters: int) -> None:
    """Fault 2: fp32 activations through the fp32 routes (qmm_fp32 for the
    three matmuls, flash_attention_fp32), against their plain versions; the
    control runs the bf16 kernel on the inputs rounded to bf16, and for
    qmm_fp32 a second control is one TF32 product (torch.matmul with TF32
    allowed on the dequantized fp32 weight), which shows that the kernel's
    passing the bar is its 3xTF32 split."""
    import torch.nn.functional as F

    from hqq_tpu_torch.ops import attention as at
    from hqq_tpu_torch.ops import fused_matmul as fm

    gen = torch.Generator(device="cuda").manual_seed(8)
    r = LORA_RANK
    for mode, (m, k, n) in [("axis=1", (512, 4096, 4096)), ("axis=0", (512, 4096, 11008)),
                            ("lora", (512, 4096, 4096))]:
        if mode == "axis=0":
            kqt = _make_kqt0(n, k, 16, 2, torch.bfloat16, seed=21)
            note = "fp32 x, 2-bit g16 axis=0, bf16 meta"
            run, plain = fm.quant_matmul_ax0, fm.quant_matmul_ax0_plain
        else:
            kqt = _make_kqt(n, k, 64, 4, seed=22)
            note = "fp32 x, 4-bit g64 axis=1" + (", r=8" if mode == "lora" else "")
            a, b = _make_lora(k, n, seed=23)
            if mode == "lora":
                def run(x, q):
                    return fm.quant_matmul_lora(x, q, a, b)

                def plain(x, q):
                    return fm.quant_matmul_lora_plain(x, q, a, b)
            else:
                run, plain = fm.quant_matmul, fm.quant_matmul_plain
        x = torch.randn((m, k), generator=gen, device="cuda")
        launches = fm.qmm_fp32.launches
        y = run(x, kqt)
        if fm.qmm_fp32.launches != launches + 1 or y.dtype != torch.float32:
            raise AssertionError(f"[b] fp32 x did not take the fp32 route ({mode})")
        ref = plain(x, kqt)
        err = held("qmm_fp32", y, ref, TOL_QMM_FP32, f"{note} M={m} K={k} N={n}")
        cast = rel(run(x.to(torch.bfloat16), kqt), ref)
        w32 = fm.dequant_plain(kqt, torch.float32)
        term = (lambda: (x @ a) @ b) if mode == "lora" else (lambda: 0.0)
        with tf32_allowed():
            one_tf32 = rel(torch.matmul(x, w32.t()) + term(), ref)
        log(f"[b] qmm_fp32 {note}: {err / ref.abs().max().item():.3e} of max|y|; controls, x "
            f"rounded to bf16 through the bf16 kernel {cast:.3e}, one TF32 product "
            f"(torch.matmul, allow_tf32) {one_tf32:.3e} (each must exceed {TOL_QMM_FP32})")
        if not cast > TOL_QMM_FP32:
            raise AssertionError("[b] the fp32 bar does not catch a bf16 cast")
        if not one_tf32 > TOL_QMM_FP32:
            raise AssertionError("[b] the fp32 bar does not catch one TF32 product")
        wbytes = _weight_bytes(kqt)
        kq, xq = _copies(kqt, x, wbytes)
        ms = time_ms([lambda q=q, xx=xx: run(xx, q) for q, xx in zip(kq, xq)], max(10, iters // 5))
        plain_ms = time_ms([lambda: plain(x, kqt)], max(3, iters // 10))
        lib = time_ms([lambda: torch.matmul(x, w32.t())], iters)
        del w32, kq, xq
        # the least time of an fp32-accurate product: three TF32 products at
        # the tensor cores' TF32 rate (the LoRA term in fp32 beside it); one
        # fp32 product at the CUDA cores' rate is reported beside it
        nbytes = wbytes + 4 * m * k + 4 * m * n + (4 * r * (k + n) if mode == "lora" else 0)
        lora_ops = 2.0 * m * r * (k + n) if mode == "lora" else 0.0
        b_ms, by = bound_ms(nbytes, 3 * 2.0 * m * n * k, "tf32", fp32_ops=lora_ops)
        fma_ms, _ = bound_ms(nbytes, 0.0, "fp32", fp32_ops=2.0 * m * n * k + lora_ops)
        record("qmm_fp32", dict(kernel="qmm_fp32", m=m, k=k, n=n, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=lib,
                                bound_fp32_fma_ms=fma_ms, one_tf32_rel=one_tf32,
                                note=note, library="torch.matmul in fp32 on the dequantized "
                                                   "fp32 weight"))
        torch.cuda.empty_cache()

    for b, nh, n_kv, t in [(1, 8, 8, 512), (1, 32, 32, 1024)]:
        gq = torch.Generator(device="cuda").manual_seed(t)
        q = torch.randn((b, nh, t, HEAD_DIM), generator=gq, device="cuda")
        k = torch.randn((b, n_kv, t, HEAD_DIM), generator=gq, device="cuda")
        v = torch.randn((b, n_kv, t, HEAD_DIM), generator=gq, device="cuda")
        launches = at.flash_attention_fp32.launches
        y = at.flash_attention(q, k, v, True)
        if at.flash_attention_fp32.launches != launches + 1:
            raise AssertionError("[b] fp32 attention did not take the fp32 route")
        ref = at.flash_attention_plain(q, k, v, True)
        what = f"fp32, causal, {nh}/{n_kv} heads, T={t}"
        err = held("flash_attention_fp32", y, ref, TOL_FLASH_FP32, what)
        cast = rel(at.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), True), ref)
        with tf32_allowed():
            one_tf32 = rel(at.flash_attention_plain(q, k, v, True), ref)
        log(f"[b] flash_attention_fp32 {what}: {err / ref.abs().max().item():.3e} of max|out|; "
            f"controls, bf16 inputs through the bf16 kernel {cast:.3e}, one TF32 product (the "
            f"plain version, allow_tf32) {one_tf32:.3e} (each must exceed {TOL_FLASH_FP32})")
        if not cast > TOL_FLASH_FP32:
            raise AssertionError("[b] the fp32 attention bar does not catch a bf16 cast")
        if not one_tf32 > TOL_FLASH_FP32:
            raise AssertionError("[b] the fp32 attention bar does not catch one TF32 product")
        ms = time_ms([lambda: at.flash_attention(q, k, v, True)], max(10, iters // 5))
        plain_ms = time_ms([lambda: at.flash_attention_plain(q, k, v, True)], max(3, iters // 10))
        lib = time_ms([lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)],
                      max(10, iters // 5))
        # the least time of fp32-accurate products: three TF32 products of
        # 2 * B * H * T * T * hd FLOP each (causal) at the TF32 rate; one fp32
        # product at the CUDA cores' rate is reported beside it
        each = 4 * b * t * HEAD_DIM * (2 * nh + 2 * n_kv)
        flop = 2.0 * b * nh * t * t * HEAD_DIM
        b_ms, by = bound_ms(each, 3 * flop, "tf32")
        fma_ms, _ = bound_ms(each, 0.0, "fp32", fp32_ops=flop)
        record("flash_attention_fp32", dict(
            kernel="flash_attention_fp32", m=b, k=t, n=nh, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=lib,
            bound_fp32_fma_ms=fma_ms, one_tf32_rel=one_tf32,
            note=f"fp32, causal, {nh}/{n_kv} heads, head size {HEAD_DIM}",
            library="scaled_dot_product_attention(is_causal=True) in fp32"))
        del q, k, v
        torch.cuda.empty_cache()


def _bwd_shifted(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """Control of the backward checks: the plain backward with the causal
    mask shifted by one, so that every query also sees the key after it."""
    hd = q.shape[3]
    scale = hd**-0.5 if sm_scale is None else sm_scale
    rep = q.shape[1] // k.shape[1]
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    if rep > 1:
        kf, vf = kf.repeat_interleave(rep, dim=1), vf.repeat_interleave(rep, dim=1)
    t = q.shape[2]
    p = torch.exp(torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale - lse[..., None])
    p = p * torch.ones((t, t), dtype=torch.bool, device=q.device).tril(diagonal=1)
    ds = p * (torch.einsum("bhtd,bhsd->bhts", dof, vf) - (dof * of).sum(-1, keepdim=True))
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf) * scale
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf) * scale
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    if rep > 1:
        b, _, _, _ = dk.shape
        dk = dk.reshape(b, k.shape[1], rep, t, hd).sum(2)
        dv = dv.reshape(b, k.shape[1], rep, t, hd).sum(2)
    return dq, dk, dv


def _no_d(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """Control: the plain backward with the D = rowsum(dO * O) term dropped."""
    from hqq_tpu_torch.ops import attention as at

    return at.flash_attention_backward_plain(q, k, v, torch.zeros_like(o), lse, do, causal,
                                             sm_scale)


# the backward kernels against their plain twin from the same saved
# statistics. Both sides round P and scale * dS to the inputs' type before
# the second products (dV, dK, dQ), where the library's backward kernels
# round them, sum every product in fp32 and round each output once; P and
# dS come from fp32 S and dP summed in another order (and exp2 against
# exp), so a few of their roundings, and of the outputs', fall to the other
# side, one step apart: two steps of max|grad| in bf16 and fp16 (fp32: no
# rounding, the attention fp32 bar). Against autograd of the plain forward
# in fp32 on the same values, the kernels also carry the forward's
# roundings (its probabilities and its output, from which D comes) and
# their own of P and dS: four steps.
TOL_BWD = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10, torch.float32: TOL_FLASH_FP32}
TOL_BWD_AUTOGRAD = {torch.bfloat16: 2.0**-5, torch.float16: 2.0**-8,
                    torch.float32: TOL_FLASH_FP32}


def _sdpa_backward(q, k, v, do):
    """scaled_dot_product_attention's backward alone, causal, GQA by its own
    option: the forward is taken once, the timed call is autograd.grad."""
    import torch.nn.functional as F

    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=q.shape[1] != k.shape[1])
    return lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True)


def _one_tf32(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """Control of the fp32 backward: the plain backward with TF32 allowed,
    one TF32 product for each product."""
    from hqq_tpu_torch.ops import attention as at

    with tf32_allowed():
        return at.flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm_scale)


def phase_b_backward(record, held, iters: int) -> None:
    """Rows 11-12, the dK/dV and dQ kernels, at the training path's shape
    and around it: against the plain backward from the same saved
    statistics, and against autograd of the plain forward in fp32; the
    controls (D dropped, the mask shifted by one, for fp32 one TF32 product)
    must miss the bar; three runs bit-equal. Then the log-sum-exp option of
    the forward, timed against the forward without it (it must cost path H
    nothing)."""
    from hqq_tpu_torch.ops import attention as at

    cases = [(1, 32, 32, 1024, 128, torch.bfloat16), (1, 32, 8, 1023, 128, torch.bfloat16),
             (2, 8, 8, 300, 64, torch.bfloat16), (1, 8, 8, 512, 256, torch.bfloat16),
             (1, 32, 32, 1024, 128, torch.float16), (1, 8, 8, 512, 128, torch.float32),
             (1, 32, 32, 1024, 128, torch.float32), (1, 32, 8, 1023, 128, torch.float32),
             # fp32 at hd 256: a cluster of two blocks a resident tile; Gemma-7B's
             # heads and Gemma-2-9B's GQA at T = 2048
             (1, 8, 8, 512, 256, torch.float32), (1, 16, 16, 2048, 256, torch.float32),
             (1, 16, 8, 2048, 256, torch.float32)]
    for b, nh, n_kv, t, hd, dtype in cases:
        gq = torch.Generator(device="cuda").manual_seed(t + hd)
        q = torch.randn((b, nh, t, hd), generator=gq, device="cuda").to(dtype)
        k = torch.randn((b, n_kv, t, hd), generator=gq, device="cuda").to(dtype)
        v = torch.randn((b, n_kv, t, hd), generator=gq, device="cuda").to(dtype)
        do = torch.randn((b, nh, t, hd), generator=gq, device="cuda").to(dtype)
        out, lse = at._flash_forward(q, k, v, True, None, with_lse=True)
        got = at.flash_attention_backward(q, k, v, out, lse, do, True)
        ref = at.flash_attention_backward_plain(q, k, v, out, lse, do, True)
        name = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}[dtype]
        what = f"{name}, causal, B={b} heads {nh}/{n_kv} T={t} hd={hd}"
        errs = [held("flash backward " + g, x, r, TOL_BWD[dtype], what)
                for g, x, r in zip(("dq", "dk", "dv"), got, ref)]
        q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
        auto = torch.autograd.grad(at.flash_attention_plain(q32, k32, v32, True),
                                   (q32, k32, v32), do.float())
        auto_err = max(rel(x, r) for x, r in zip(got, auto))
        wrong = [("D dropped", _no_d), ("mask shifted by one", _bwd_shifted)]
        if dtype == torch.float32:
            wrong.append(("one TF32 product", _one_tf32))
        controls = {c: max(rel(x, r) for x, r in zip(fn(q, k, v, out, lse, do), ref))
                    for c, fn in wrong}
        again = [at.flash_attention_backward(q, k, v, out, lse, do, True) for _ in range(2)]
        equal = all(torch.equal(x, y) for run in again for x, y in zip(run, got))
        log(f"[b] flash backward {what}: dq/dk/dv rel err vs plain "
            f"{[f'{e / r.float().abs().max().item():.3e}' for e, r in zip(errs, ref)]} "
            f"(tol {TOL_BWD[dtype]:.3e}); vs autograd of the plain forward in fp32 "
            f"{auto_err:.3e} (tol {TOL_BWD_AUTOGRAD[dtype]:.3e}); controls {controls} (must "
            f"exceed {TOL_BWD[dtype]:.3e}); three runs bit-equal: {equal}")
        if not auto_err <= TOL_BWD_AUTOGRAD[dtype]:
            raise AssertionError(f"[b] flash backward {what} disagrees with autograd")
        if not all(c > TOL_BWD[dtype] for c in controls.values()):
            raise AssertionError(f"[b] the backward bar does not catch a control ({what})")
        if not equal:
            raise AssertionError(f"[b] flash backward {what}: repeated runs differ")
        del auto, q32, k32, v32, again

        # each kernel alone, from the operands its wrapper prepares (dK/dV
        # with what its launch adds: lse and D padded where T is not a
        # multiple of 4, and under GQA the sum of the query heads' partials)
        ops = at._backward_operands(q, k, v, out, lse, do, None)
        n = max(3, iters // 20)
        dkv_ms = time_ms([lambda: at._launch_dkv(ops, True)], n)
        dq_ms = time_ms([lambda: at._launch_dq(ops, True)], n)
        plain_ms = time_ms([lambda: at.flash_attention_backward_plain(q, k, v, out, lse, do)],
                           max(2, iters // 50))
        sdpa = _sdpa_backward(q, k, v, do)
        lib = time_ms([sdpa], max(3, iters // 10))
        esize = q.element_size()
        qo = b * nh * t * hd * esize
        kv = b * n_kv * t * hd * esize
        stats = 2 * b * nh * t * 4
        fp32 = dtype == torch.float32
        suffix = "_fp32" if fp32 else ""
        unit = b * nh * t * t * hd  # one causal product: 2 * T * T * hd / 2 per head
        for kname, ms, products, nbytes, e in (
                ("flash_attention_backward_dkv" + suffix, dkv_ms, 4, 2 * qo + 4 * kv + stats,
                 max(errs[1:])),
                ("flash_attention_backward_dq" + suffix, dq_ms, 3, 3 * qo + 2 * kv + stats,
                 errs[0])):
            # fp32: an fp32-accurate product from three TF32 products at the
            # tensor cores' TF32 rate, the bound used; one fp32 product at
            # the CUDA cores' rate beside it
            b_ms, by = bound_ms(nbytes, (3 if fp32 else 1) * products * unit,
                                "tf32" if fp32 else "bf16")
            extra = {}
            if fp32:
                extra = dict(bound_fp32_fma_ms=bound_ms(nbytes, 0.0, "fp32",
                                                        fp32_ops=products * unit)[0],
                             one_tf32_rel=controls["one TF32 product"])
                log(f"[b] {kname} {what}: {ms:.4f} ms; bound {b_ms:.4f} ms (three TF32 "
                    f"products), {extra['bound_fp32_fma_ms']:.4f} ms at the fp32 rate; SDPA's "
                    f"whole fp32 backward {lib:.4f} ms")
            record(kname, dict(
                kernel=kname, m=b, k=t, n=nh, max_abs_err=e, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=lib, **extra,
                note=f"{name}, causal, {nh}/{n_kv} heads, head size {hd}",
                library="the whole backward of scaled_dot_product_attention(is_causal=True), "
                        "dQ, dK and dV (autograd.grad alone)",
                plain="the whole plain backward"))
        del ops, sdpa, got, ref
        torch.cuda.empty_cache()

    # the log-sum-exp option of the forward kernel at path H's shape
    qkv = _flash_inputs(1, 32, 32, 1023, 4, seed=5)
    lse_off = time_ms([lambda a=a: at.flash_attention(*a, True) for a in qkv], iters)
    lse_on = time_ms([lambda a=a: at._flash_forward(*a, True, None, with_lse=True)
                      for a in qkv], iters)
    log(f"[b] flash_attention (1, 32/32, 1023, 128) bf16: {lse_off:.4f} ms without the "
        f"log-sum-exp, {lse_on:.4f} ms writing it (the training forward)")


PROMPTS_SHAPE, NEW_TOKENS = (4, 100), 32
LINEARS_PER_PASS = 7 * 32  # q, k, v, o, gate, up, down of each of the 32 layers
NORMS_PER_PASS = 2 * 32 + 1  # rms_norm: two a layer and the final one


def _prompts(cfg):
    return torch.randint(0, cfg.vocab_size, PROMPTS_SHAPE,
                         generator=torch.Generator().manual_seed(0)).numpy()


def _fill_lora_b(params, seed: int) -> None:
    """Every adapter's B from a seeded generator: a zero B would hide it."""
    from hqq_tpu_torch.core.peft import _map_lora

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def fill(_, layer):
        layer.lora_b.data = torch.randn(layer.lora_b.shape, generator=gen,
                                        device="cuda") * LORA_B_STD

    _map_lora(params, fill)


def _step_weight_bytes(tree) -> int:
    """What a decode step must read of the model: every linear's codes,
    scale and zs and its adapter (and lm_head's bf16 weight) once."""
    if isinstance(tree, dict):
        return sum(_step_weight_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_step_weight_bytes(v) for v in tree)
    if hasattr(tree, "n_experts") and hasattr(tree, "wq"):  # a quantized expert stack
        return sum(t.numel() * t.element_size() for t in (tree.wq, tree.scale, tree.zero))
    if hasattr(tree, "kqt"):
        return _weight_bytes(tree.kqt) + sum(
            t.numel() * t.element_size() for t in (getattr(tree, "a", None),
                                                   getattr(tree, "b", None)) if t is not None)
    if hasattr(tree, "weight"):
        return tree.weight.numel() * tree.weight.element_size()
    return 0


def launch_counts() -> dict:
    """Every wrapper's launches, and under "w4a8_group_mma" those of the two
    w4a8 wrappers that went to the small-group kernel."""
    from hqq_tpu_torch import ops
    from hqq_tpu_torch.ops import fused_matmul as fm

    counts = {w.__name__: w.launches for w in ops.kernel_wrappers()}
    counts["w4a8_group_mma"] = fm.W4A8_ROUTE_LAUNCHES["group_mma"]
    return counts


def serve_7b(tag: str, dev_tag: str, quant_config, expect: dict, after_quantize=None,
             extra=None):
    """Drive one main path at the full width and depth of Llama-2-7B: random
    weights from seed 0, quantize_model(quant_config), ``after_quantize``
    (the adapters of path E), prepare_for_inference("w4a8"), then the window
    in which launches count: every count set to 0 just before, read just
    after. ``expect`` maps a wrapper's name to its launches per prefill and
    per decode step; ``extra(model)`` runs inside the window. Returns
    (launches of the window, the model)."""
    from hqq_tpu_torch import ops
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama2_7b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    log(f"[{tag}] init_params {cfg.num_hidden_layers} layers: {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    model = HQQModel(params, cfg)
    del params
    t0 = time.time()
    model.quantize_model(quant_config)
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    if after_quantize is not None:
        after_quantize(model)
    t0 = time.time()
    model.prepare_for_inference("w4a8")
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    gc.collect()
    log(f"[{tag}] quantize_model {quant_s:.2f} s, prepare_for_inference(w4a8) {prep_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    prompts = _prompts(cfg)
    new = NEW_TOKENS

    # the least a decode step must read: the weights, plus the K/V of the
    # positions attended, here on average prompt + new/2 (embeddings: B
    # rows, left out)
    step_bytes = _step_weight_bytes

    kv_bytes = (2 * cfg.num_hidden_layers * prompts.shape[0] * cfg.num_key_value_heads
                * cfg.head_dim_ * 2 * (prompts.shape[1] + new // 2))
    bound_step_ms = (step_bytes(model.params) + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] decode bound: {step_bytes(model.params) / 1e9:.3f} GB of weights and meta + "
        f"{kv_bytes / 1e9:.3f} GB of K/V per step -> {bound_step_ms:.3f} ms per step, "
        f"{prompts.shape[0] / bound_step_ms * 1e3:.1f} tok/s at B={prompts.shape[0]}")

    counts = launch_counts
    partial = dict(compile_mode="partial")  # an eager decode loop: every launch counts

    # the main path's window: every count from 0, read right after
    ops.reset_launch_counts()
    model.generate(prompts, max_new_tokens=1, **partial)  # first call: lazy set-up
    torch.cuda.synchronize()
    per_prefill = counts()
    t0 = time.time()
    model.generate(prompts, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    prefill_ms = (time.time() - t0) * 1e3
    before = counts()
    t0 = time.time()
    out = model.generate(prompts, max_new_tokens=new, **partial)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    after = counts()
    decode_tok_s = prompts.shape[0] * (new - 1) / (gen_s - prefill_ms / 1e3)
    if extra is not None:
        extra(model)
    busy = device_share(lambda: model.generate(prompts, max_new_tokens=8, **partial))
    torch.cuda.synchronize()
    launches = counts()
    log(f"[{tag}] launches in the main path: {launches}")
    # after the window: the prefill's device time, all kernels and those of
    # the dequant-matmul mainloop
    prefill_dev = time_ms([lambda: model.generate(prompts, max_new_tokens=1)], 2)
    prefill_qmm = time_ms([lambda: model.generate(prompts, max_new_tokens=1)], 2, only="qmm_")
    full = decode_full(tag, dev_tag, model, prompts, out, prefill_ms, busy,
                       {name: per_step for name, (_, per_step) in expect.items() if per_step})

    if out.shape != (prompts.shape[0], new) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"unexpected output: shape {out.shape}, ids {out.min()}..{out.max()}")
    for name, (per_pre, per_step) in expect.items():
        got_step = (after[name] - before[name] - per_prefill[name]) / (new - 1)
        if per_prefill[name] != per_pre or got_step != per_step:
            raise AssertionError(f"{name}: {per_prefill[name]} launches per prefill and "
                                 f"{got_step} per decode step, expected {per_pre} and {per_step}")
    log(f"[{tag}] launches per prefill and per decode step: "
        f"{ {k: (per_prefill[k], v[1]) for k, v in expect.items()} }")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] greedy ids[0][:8] {out[0][:8].tolist()}")
    log(f"[{tag}] {dev_tag}: prefill (B=4, t_pad=128, + first token) {prefill_ms:.1f} ms; "
        f"decode {decode_tok_s:.1f} tok/s total over B=4; peak memory {peak:.2f} GiB; "
        f"quantize {quant_s:.2f} s")
    log(f"[{tag}] {dev_tag}: prefill device time {prefill_dev:.3f} ms, {prefill_qmm:.3f} ms of it "
        f"in the qmm_ kernels")
    log(f"[{tag}] {dev_tag}: 8-token generate (B=4): device busy {busy['busy_share']:.3f} of "
        f"{busy['wall_ms']:.1f} ms wall; device ms by kernel: {busy['top']}")
    log(f"[{tag}] {dev_tag}: 8-token generate (B=4): w4a8 kernels' device ms {busy['w4a8']}")
    log(f"[{tag}] {dev_tag}: decode tok/s (B=4) partial {decode_tok_s:.1f}, full "
        f"{full['tok_s']:.1f}; 8-token generate busy share partial {busy['busy_share']:.3f} "
        f"of {busy['wall_ms']:.1f} ms, full {full['busy']['busy_share']:.3f} of "
        f"{full['busy']['wall_ms']:.1f} ms")
    log(f"[{tag}] card right after it: {card_state()}")
    return launches, model, out


def decode_full(tag: str, dev_tag: str, model, prompts, partial_ids, prefill_ms: float,
                partial_busy: dict, per_step: dict) -> dict:
    """The decode loop as a replayed CUDA graph (compile_mode "full", the
    default) on a prepared model, after its "partial" window: the greedy
    ids must equal "partial"'s, and the launches recorded into each graph
    equal "partial"'s per decode step (``per_step``: wrapper -> launches).
    Returns decode tok/s (the formula of `serve_7b`), the 8-token
    generate's busy share and the capture seconds. A replay calls no
    wrapper, so the launch counts do not move here. The model's graphs are
    released at the end, so later phases do not carry their buffers."""
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch.serving.generate import Generator, _fingerprint, next_power_of_2

    new = partial_ids.shape[1]
    b = prompts.shape[0]
    ids = model.generate(prompts, max_new_tokens=new)  # captures (B, 256)
    model.generate(prompts, max_new_tokens=8)  # captures (B, 128)
    torch.cuda.synchronize()
    if not np.array_equal(ids, partial_ids):
        raise AssertionError(f"[{tag}] the graph's greedy ids differ from the eager loop's")
    captures = model.generator().captures()
    for key, cap in captures.items():
        if cap["launches"] != per_step:
            raise AssertionError(f"[{tag}] graph {key} recorded {cap['launches']} launches, "
                                 f"a partial decode step makes {per_step}")
    t0 = time.time()
    model.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    tok_s = b * (new - 1) / (gen_s - prefill_ms / 1e3)
    # the host's check, at each graphed generate, that the tree is the one
    # the graphs were captured on
    t0 = time.perf_counter()
    _fingerprint(model.params)
    check_ms = (time.perf_counter() - t0) * 1e3
    # the K/V caches both loops leave after the same 8-token generate: every
    # layer's projections of every step, bit-equal unless a library kernel
    # chose another algorithm on the capture stream (then held to phase b's
    # bar); the eager loop's cache is caught as its call allocates it
    model.generate(prompts, max_new_tokens=8)
    graph = model.generator()._graphs[(b, next_power_of_2(prompts.shape[1] + 8 + 1))].cache
    made = []
    new_state = Generator._new_state

    def recorded(gen, *a):
        made.append(new_state(gen, *a))
        return made[-1]

    with mock.patch.object(Generator, "_new_state", recorded):
        model.generate(prompts, max_new_tokens=8, compile_mode="partial")
    eager = made[-1].cache
    kv_err = max(rel(graph.k, eager.k), rel(graph.v, eager.v))
    del made, eager, graph
    if not kv_err <= 2.0**-7:
        raise AssertionError(f"[{tag}] the graph's K/V cache differs from the eager loop's by "
                             f"{kv_err:.3e} of max|kv|")

    def generate8():
        model.generate(prompts, max_new_tokens=8)

    busy = device_share(generate8)
    if busy["events"] < 0.9 * partial_busy["events"]:
        # the profiler kept fewer of the replays' kernels than the eager
        # loop ran: time the replayed generate between CUDA events instead
        torch.cuda.synchronize()
        t0 = time.time()
        ms = _event_ms([generate8], 3)
        wall_ms = (time.time() - t0) * 1e3 / 3
        log(f"[time] the profiler kept {busy['events']} device events of the replayed "
            f"generate, the eager one {partial_busy['events']}: the busy share below is the "
            f"generate's time between CUDA events ({ms:.3f} ms, host gaps before and between "
            f"the replays included, so an upper bound) over its wall time ({wall_ms:.3f} ms)")
        busy = dict(busy, busy_share=ms / wall_ms, device_ms=ms, wall_ms=wall_ms)
    log(f"[{tag}] {dev_tag}: full (CUDA graph): greedy ids equal partial's, K/V caches "
        f"{'bit-equal' if kv_err == 0 else f'within {kv_err:.3e} of max|kv|'}; capture "
        f"{ {k: round(c['seconds'], 3) for k, c in captures.items()} } s, each recording "
        f"{per_step} launches; parameter-tree check {check_ms:.2f} ms a generate; decode "
        f"{tok_s:.1f} tok/s at B={b}; 8-token generate busy "
        f"{busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall, device ms "
        f"{busy['device_ms']:.3f}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    model.release_graphs()
    return dict(tok_s=tok_s, busy=busy, captures=captures)


def check_calls(tag: str, model, wrappers: dict, steps: int = 2) -> None:
    """One prefill and ``steps`` decode steps of the full model with every
    wrapper of ``wrappers`` (name -> (plain version, controls)) held call by
    call to its plain version on the inputs the path really produces, under
    the bar of phase b (2^-7 of max|y| for bf16 outputs); every control must
    miss that bar in every call."""
    from unittest import mock

    from hqq_tpu_torch.models.llama import forward, init_cache
    from hqq_tpu_torch.ops import fused_matmul as fm

    cfg = model.cfg
    toks = torch.from_numpy(_prompts(cfg)).to("cuda")
    t = 128  # the main path's prefill: M = 4 * 128 rows
    toks = torch.cat([toks, toks], dim=1)[:, :t + steps]
    logs = {name: {} for name in wrappers}
    with torch.inference_mode():
        patches = [mock.patch.object(fm, name, checked(getattr(fm, name), plain, controls,
                                                       logs[name]))
                   for name, (plain, controls) in wrappers.items()]
        for pt in patches:
            pt.start()
        try:
            cache = init_cache(cfg, toks.shape[0], 256, torch.bfloat16, "cuda")
            logits, cache = forward(model.params, cfg, toks[:, :t], cache, 0)
            for i in range(steps):
                logits, cache = forward(model.params, cfg, toks[:, t + i:t + i + 1], cache, t + i)
        finally:
            for pt in patches:
                pt.stop()
    tol = 2.0**-7
    if not torch.isfinite(logits).all():
        raise AssertionError(f"[{tag}] non-finite logits")
    for name, per_call in logs.items():
        worst = max(per_call["kernel"])
        least = {c: min(v) for c, v in per_call.items() if c != "kernel"}
        log(f"[{tag}] {name}: {len(per_call['kernel'])} calls of a prefill (M={4 * t}) and "
            f"{steps} decode steps, each vs its plain version on the same inputs: rel err up "
            f"to {worst:.3e} (tol {tol:.3e}); controls at the least {least} (must exceed it)")
        if not worst <= tol:
            raise AssertionError(f"[{tag}] {name} disagrees with its plain version")
        if not all(v > tol for v in least.values()):
            raise AssertionError(f"[{tag}] the bar does not catch a control of {name}")


def phase_c(dev_tag: str):
    """Returns (launches of the window, the prepared model, its greedy
    ids): phases g and h go on with the model, phase q with the ids."""
    from hqq_tpu_torch import BaseQuantizeConfig

    seen = {}

    def extra(model):
        sampled = model.generate(_prompts(model.cfg)[:1], max_new_tokens=16, do_sample=True,
                                 top_k=20, top_p=0.9, seed=1)
        w_dq = model.params["layers"][0]["mlp"]["down_proj"].dequantize()
        if sampled.shape != (1, 16) or sampled.min() < 0 or sampled.max() >= model.cfg.vocab_size:
            raise AssertionError(f"unexpected sampled output {sampled.shape}")
        if tuple(w_dq.shape) != (4096, 11008) or w_dq.dtype != torch.bfloat16 \
                or not torch.isfinite(w_dq).all():
            raise AssertionError("dequantize() of a prepared layer is wrong")
        seen["sampled"] = sampled[0][:8].tolist()

    n = LINEARS_PER_PASS
    launches, model, ids = serve_7b("c", dev_tag, BaseQuantizeConfig(nbits=4, group_size=64),
                               {"quant_matmul": (n, 0), "w4a8_matmul": (0, n),
                                "rms_norm": (NORMS_PER_PASS, NORMS_PER_PASS)}, extra=extra)
    log(f"[c] sampled {seen['sampled']}")
    missing = [k for k in ("w4a8_matmul", "quant_matmul", "dequant") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches, model, ids


def _write_hf_dir(path: str, params: dict, cfg) -> int:
    """``params`` as a Hugging Face Llama directory, written by the port's
    own safetensors writer: config.json, two shards (the embedding and the
    first half of the layers, then the rest) and the index. Returns the
    bytes of the tensors."""
    from hqq_tpu_torch.models._safetensors import save_file

    half = cfg.num_hidden_layers // 2
    shards = [{"model.embed_tokens.weight": params["embed_tokens"]}, {}]
    for i, layer in enumerate(params["layers"]):
        named = {f"self_attn.{k}.weight": m.weight for k, m in layer["self_attn"].items()}
        named.update({f"mlp.{k}.weight": m.weight for k, m in layer["mlp"].items()})
        named["input_layernorm.weight"] = layer["input_layernorm"]
        named["post_attention_layernorm.weight"] = layer["post_attention_layernorm"]
        shards[i >= half].update({f"model.layers.{i}.{k}": v for k, v in named.items()})
    shards[1]["model.norm.weight"] = params["norm"]
    shards[1]["lm_head.weight"] = params["lm_head"].weight
    os.makedirs(path)
    weight_map, total = {}, 0
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file(shard, os.path.join(path, fname))
        weight_map.update(dict.fromkeys(shard, fname))
        total += sum(t.numel() * t.element_size() for t in shard.values())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    hf = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
          "torch_dtype": "bfloat16", **{k: getattr(cfg, k) for k in (
              "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
              "rms_norm_eps", "rope_theta", "tie_word_embeddings")}}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return total


def _bit_equal_trees(tag: str, got, want) -> int:
    """Every tensor of two parameter trees bit-equal (the checkpoint
    format's flattening); returns how many were compared."""
    from hqq_tpu_torch.models.serialize import tree_to_state

    got_flat, got_struct = tree_to_state(got)
    want_flat, want_struct = tree_to_state(want)
    if got_struct != want_struct or list(got_flat) != list(want_flat):
        raise AssertionError(f"[{tag}] the loaded tree's structure differs")
    for k, w in want_flat.items():
        g = got_flat[k]
        if g.dtype != w.dtype or g.shape != w.shape or g.device != w.device \
                or not torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"[{tag}] {k} differs from what was written")
    return len(want_flat)


def phase_q(dev_tag: str, c_ids) -> dict:
    """The README quick start on the card: a 2-layer HF directory at 7B
    width through `HQQModelForCausalLM.from_pretrained`; then C's model
    (32 layers, seed 0, 4-bit g64) through save_quantized, from_quantized,
    prepare_for_inference("w4a8") and generate, in "partial" and in "full";
    then phase s serves the same checkpoint. Returns the launches of its
    window and of phase s's."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.engine.hf import HQQModel, HQQModelForCausalLM
    from hqq_tpu_torch.models.llama import LlamaConfig, forward, init_params

    def sha(ids):
        return hashlib.sha1(np.ascontiguousarray(ids).tobytes()).hexdigest()[:12]

    root = tempfile.mkdtemp(prefix="hqq-quickstart-")
    try:
        # 1. from_pretrained on an HF directory: 2 layers at 7B width, bf16
        cfg2 = dataclasses.replace(LlamaConfig.llama2_7b(), num_hidden_layers=2)
        params = init_params(cfg2, torch.Generator(device="cuda").manual_seed(0),
                             torch.bfloat16, "cuda")
        hf_dir = os.path.join(root, "hf")
        t0 = time.time()
        nbytes = _write_hf_dir(hf_dir, params, cfg2)
        write_s = time.time() - t0
        t0 = time.time()
        loaded = HQQModelForCausalLM.from_pretrained(hf_dir)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        if loaded.cfg != cfg2:
            raise AssertionError(f"[q] from_pretrained read config {loaded.cfg}")
        n = _bit_equal_trees("q", loaded.params, params)
        toks = torch.from_numpy(_prompts(cfg2)[:, :16]).to("cuda")
        with torch.inference_mode():
            got, _ = loaded.forward(toks)
            want, _ = forward(params, cfg2, toks)
        if not torch.isfinite(got).all() or not torch.equal(got, want):
            raise AssertionError("[q] from_pretrained's logits differ from the tree's")
        log(f"[q] HF directory (2 layers at 7B width, 2 shards + index, {nbytes / 1e9:.3f} GB, "
            f"written in {write_s:.2f} s): from_pretrained {load_s:.2f} s; {n} tensors "
            f"bit-equal; logits of a 16-token forward bit-equal to the tree's")
        del params, loaded, got, want
        gc.collect()
        torch.cuda.empty_cache()

        # 2. save_quantized / from_quantized at full depth, then generate
        torch.cuda.reset_peak_memory_stats()
        cfg = LlamaConfig.llama2_7b()
        model = HQQModel(init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                     torch.bfloat16, "cuda"), cfg)
        model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
        ckpt = os.path.join(root, "ckpt")
        t0 = time.time()
        model.save_quantized(ckpt)
        save_s = time.time() - t0
        written = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        t0 = time.time()
        model_q = HQQModelForCausalLM.from_quantized(ckpt)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        n = _bit_equal_trees("q", model_q.params, model.params)
        if model_q.cfg != cfg or not model_q.quantized:
            raise AssertionError(f"[q] from_quantized read config {model_q.cfg}")
        log(f"[q] save_quantized (32 layers, 4-bit g64): {written / 1e9:.3f} GB in "
            f"{len(os.listdir(ckpt)) - 1} shards, {save_s:.2f} s; from_quantized {load_s:.2f} s; "
            f"{n} tensors bit-equal")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model_q.prepare_for_inference("w4a8")

        prompts = _prompts(cfg)
        new = NEW_TOKENS
        partial = dict(compile_mode="partial")
        ops.reset_launch_counts()
        model_q.generate(prompts, max_new_tokens=1, **partial)  # lazy set-up
        torch.cuda.synchronize()
        t0 = time.time()
        model_q.generate(prompts, max_new_tokens=1, **partial)
        torch.cuda.synchronize()
        prefill_ms = (time.time() - t0) * 1e3
        t0 = time.time()
        ids = model_q.generate(prompts, max_new_tokens=new, **partial)
        torch.cuda.synchronize()
        tok_s = prompts.shape[0] * (new - 1) / (time.time() - t0 - prefill_ms / 1e3)
        busy = device_share(lambda: model_q.generate(prompts, max_new_tokens=8, **partial))
        launches = launch_counts()
        log(f"[q] launches in the quick start's window: {launches}")
        if not np.array_equal(ids, c_ids):
            raise AssertionError(f"[q] greedy ids sha1 {sha(ids)}, phase c's {sha(c_ids)}")
        full = decode_full("q", dev_tag, model_q, prompts, ids, prefill_ms, busy,
                           {"w4a8_matmul": LINEARS_PER_PASS, "rms_norm": NORMS_PER_PASS})

        sampled = dict(do_sample=True, top_k=20, top_p=0.9, seed=1)
        s_partial = model_q.generate(prompts, max_new_tokens=new, **sampled, **partial)
        s_full = model_q.generate(prompts, max_new_tokens=new, **sampled)
        if not np.array_equal(s_partial, s_full):
            raise AssertionError("[q] sampled ids differ between partial and full")
        calls = []
        streamed = model_q.generate(prompts, max_new_tokens=new, on_token=calls.append)
        if len(calls) != new or not np.array_equal(np.stack(calls, axis=1), streamed) \
                or not np.array_equal(streamed, ids):
            raise AssertionError(f"[q] on_token fired {len(calls)} times, or with other ids")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[q] greedy ids sha1 {sha(ids)} (phase c: {sha(c_ids)}), equal in partial and "
            f"full; sampled (top_k 20, top_p 0.9, seed 1) sha1 {sha(s_full)}, equal in both; "
            f"on_token fired {len(calls)} times with the returned ids")
        log(f"[q] {dev_tag}: decode tok/s (B=4) partial {tok_s:.1f}, full {full['tok_s']:.1f}; "
            f"8-token generate busy share partial {busy['busy_share']:.3f} of "
            f"{busy['wall_ms']:.1f} ms, full {full['busy']['busy_share']:.3f} of "
            f"{full['busy']['wall_ms']:.1f} ms; capture "
            f"{ {k: round(c['seconds'], 3) for k, c in full['captures'].items()} } s; "
            f"prefill {prefill_ms:.1f} ms; peak {peak:.2f} GiB")
        del model_q
        gc.collect()
        torch.cuda.empty_cache()
        t_s = time.time()
        served = phase_s(dev_tag, ckpt)
        log(f"[s] phase s on C's checkpoint: {time.time() - t_s:.1f} s")
        return launches, served
    finally:
        shutil.rmtree(root)


# path S: the one-command server (`python -m hqq_tpu_torch.serve`) on the
# checkpoint of phase q (C's model), G's requests sent over HTTP
S_HORIZON = 8
S_DENSE_SLOTS, S_DENSE_MAX_LEN = 4, 1024


def _http(port: int, method: str, path: str, obj=None):
    """(status, JSON body) of one request to the server on localhost."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, None if obj is None else json.dumps(obj),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _s_request(port: int, prompt, new: int, stream: bool, t0: float, on_first=None,
               extra=None) -> dict:
    """One greedy /generate, blocking or streamed (server-sent events).
    Returns its uid, ids, streamed chunks, and the client's seconds from
    ``t0`` to its first token (a blocking request gets all of its tokens
    with the response) and to its end; ``on_first(event)`` runs when a
    stream's first chunk arrives. ``extra`` joins the body (an image's
    "pixel_values")."""
    import http.client

    body = {"prompt_ids": [int(t) for t in prompt], "max_new_tokens": new, "stream": stream,
            **(extra or {})}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/generate", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"[s] /generate answered {resp.status}: {resp.read()[:2000]}")
    if not stream:
        out = json.loads(resp.read())
        done = time.time() - t0
        return dict(uid=out["uid"], tokens=out["tokens"], chunks=None, first_s=done, done_s=done)
    chunks, first, final = [], None, None
    for line in resp:
        if not line.startswith(b"data: "):
            continue
        event = json.loads(line[6:])
        if "error" in event:
            raise AssertionError(f"[s] the stream ended in an error: {event['error']}")
        if event.get("done"):
            final = event
            break
        if first is None:
            first = time.time() - t0
            if on_first is not None:
                on_first(event)
        chunks.append(event["tokens"])
    if final is None:
        raise AssertionError("[s] a stream closed without its last event")
    return dict(uid=final["uid"], tokens=final["tokens"], chunks=chunks, first_s=first,
                done_s=time.time() - t0)


def _s_window(port: int, prompts, new: int, extras=None):
    """Every prompt from its own client thread, all sent at once, the odd
    ones streamed; ``extras[i]`` joins request i's body. Returns (the
    results in prompt order, seconds from the first send to the last
    end)."""
    import threading

    results, errors = [None] * len(prompts), []

    def call(i):
        try:
            results[i] = _s_request(port, prompts[i], new, i % 2 == 1, t0,
                                    extra=None if extras is None else extras[i])
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("[s] a client thread did not finish")
    return results, max(r["done_s"] for r in results)


def _s_fused_checks(fused_tree, unfused_tree, captured) -> None:
    """Each fused layer on the path's own activations (``captured``:
    (layer, name) -> inputs of a prefill and of decode steps): its kernel
    against the plain twin (at decode M, phase b's w4a8 bar with its
    controls and three bit-equal runs; at prefill M, quant_matmul's 2^-7),
    and against the unfused layers' kernels side by side (the same bars:
    the fused N changes the launch plan and so the order of the fp32 sums),
    with the parts in the wrong order as the control; the fused layout is
    the parts' rows, bit for bit."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    parts_of = {"qkv_proj": ("self_attn", ("q_proj", "k_proj", "v_proj")),
                "gate_up_proj": ("mlp", ("gate_proj", "up_proj"))}
    tol = 2.0**-7
    for (li, name), xs in sorted(captured.items()):
        sub, names = parts_of[name]
        fused = fused_tree["layers"][li][sub][name].kqt
        parts = [unfused_tree["layers"][li][sub][n].kqt for n in names]
        for field in ("wq", "scale", "zs"):
            if not torch.equal(getattr(fused, field), torch.cat([getattr(p, field) for p in parts])):
                raise AssertionError(f"[s] layer {li} {name}: {field} is not its parts' rows")
        for x in xs[:3]:  # the prefill and two decode steps
            m = x.shape[0]
            what = f"[s] layer {li} {name} (N={fused.n}) M={m}"
            if m <= fm.A8_MAX_M:
                x8, sx = fm.quantize_activations_int8(x)
                worst = _w4a8_held(what, fused, lambda q, dt: fm.w4a8_matmul(x8, sx, q, dt),
                                   lambda q, dt: fm.w4a8_matmul_plain(x8, sx, q, dt))
                y = fm.w4a8_matmul(x8, sx, fused, torch.float32)
                side = [fm.w4a8_matmul(x8, sx, p, torch.float32) for p in parts]
                part_tol = 1e-5
            else:
                y, ref = fm.quant_matmul(x, fused), fm.quant_matmul_plain(x, fused)
                worst = rel(y, ref)
                controls = {c: rel(fm.quant_matmul_plain(x, bad), ref)
                            for c, bad in _w4a8_controls(fused).items()}
                if not worst <= tol or not all(v > tol for v in controls.values()):
                    raise AssertionError(f"{what}: quant_matmul rel err {worst:.3e} (tol "
                                         f"{tol}), controls {controls}")
                side = [fm.quant_matmul(x, p) for p in parts]
                part_tol = tol
            joined = rel(y, torch.cat(side, dim=-1))
            wrong = rel(y, torch.cat(side[1:] + side[:1], dim=-1))
            log(f"{what}: kernel vs plain {worst:.3e}; vs the unfused kernels side by side "
                f"{joined:.3e} (tol {part_tol:.0e}); control, the parts in another order "
                f"{wrong:.3e} (must exceed {tol:.3e})")
            if not (joined <= part_tol and wrong > tol):
                raise AssertionError(f"{what}: the fused layer disagrees with its parts")


def phase_s(dev_tag: str, ckpt: str) -> dict:
    """The one-command server on the card: `hqq_tpu_torch.serve.main` on
    C's checkpoint (written by phase q) with its defaults (paged engine,
    w4a8, q/k/v and gate/up fused), G's pool and a horizon of 8; a warm-up
    request, then G's 12 requests from 12 client threads at once (6
    blocking, 6 streamed), timed, and again under the profiler; a 13th
    stream cancelled after its first chunk; /healthz before and after.
    Then the same requests through an in-process engine on the same tree
    (ids equal, tokens/s), the unfused tree's decode step (224 w4a8
    launches against 128), and the fused layers held on the path's own
    activations. Returns the launches of the timed window."""
    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.serve import build_engine, make_parser
    from hqq_tpu_torch.serve import main as serve_main
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    argv = ["--model", ckpt, "--port", "0", "--engine", "paged", "--backend", "w4a8",
            "--slots", str(G_SLOTS), "--num-pages", str(G_PAGES), "--page-size", str(PAGE),
            "--max-pages-per-seq", str(MAX_PAGES), "--horizon", str(S_HORIZON)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    srv = serve_main(argv, serve=False).start()
    boot_s = time.time() - t0
    eng = srv.engine
    params, cfg = eng.params, eng.cfg
    layers = cfg.num_hidden_layers
    if not all(set(layer["self_attn"]) == {"qkv_proj", "o_proj"}
               and set(layer["mlp"]) == {"gate_up_proj", "down_proj"}
               and isinstance(layer["self_attn"]["qkv_proj"], A8QuantLinear)
               and isinstance(layer["mlp"]["gate_up_proj"], A8QuantLinear)
               for layer in params["layers"]):
        raise AssertionError("[s] the served tree is not fused")
    prompts = _g_prompts(cfg, np.random.default_rng(0))
    new = G_NEW
    steps = []  # the decode steps of each of the engine's decode calls
    decode = eng._decode

    def counted(h):
        steps.append(h)
        return decode(h)

    eng._decode = counted
    try:
        health = [_http(srv.port, "GET", "/healthz")]
        t_warm = time.time()
        _s_request(srv.port, prompts[0][:64], 8, False, t_warm)
        warm_s = time.time() - t_warm

        # the main path's window: every count from 0, read right after
        ops.reset_launch_counts()
        steps.clear()
        results, window_s = _s_window(srv.port, prompts, new)
        launches = launch_counts()
        n_steps = sum(steps)
        profiled = {}
        busy = device_share(lambda: profiled.update(zip(("results", "s"),
                                                        _s_window(srv.port, prompts, new))))
        cancelled = []
        cut = _s_request(srv.port, prompts[1], new, True, time.time(), on_first=lambda e:
                         cancelled.append(_http(srv.port, "POST", "/cancel", {"uid": e["uid"]})))
        health.append(_http(srv.port, "GET", "/healthz"))
        # the server's own peak: boot, the windows and the cancelled
        # stream, before the in-process and unfused engines are built
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
    eng.close()
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()

    idle = (200, {"ok": True, "active": 0, "queued": 0})
    if health != [idle, idle]:
        raise AssertionError(f"[s] /healthz before and after: {health}")
    per_step = {"w4a8_matmul": 4 * layers, "paged_attention": layers}
    for name, n in per_step.items():
        if launches[name] != n * n_steps:
            raise AssertionError(f"[s] {launches[name]} {name} launches in {n_steps} decode steps, "
                                 f"expected {n} a step")
    if launches["quant_matmul"] != 4 * layers * len(prompts):  # each prefill: M = t_pad > 32
        raise AssertionError(f"[s] {launches['quant_matmul']} quant_matmul launches for "
                             f"{len(prompts)} prefills, expected {4 * layers} each")
    for r in results:
        if r["chunks"] is not None and [t for c in r["chunks"] for t in c] != r["tokens"]:
            raise AssertionError("[s] a stream's chunks do not concatenate to its ids")
    if [r["tokens"] for r in profiled["results"]] != [r["tokens"] for r in results]:
        raise AssertionError("[s] the profiled window gave other ids")
    if cancelled != [(200, {"cancelled": True})] or not 0 < len(cut["tokens"]) < new \
            or [t for c in cut["chunks"] for t in c] != cut["tokens"]:
        raise AssertionError(f"[s] cancel: {cancelled}, {len(cut['tokens'])} tokens")

    # the same requests through the same tree's engine, in-process
    ref_eng = PagedBatchingEngine(params, cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                                  page_size=PAGE, max_pages_per_seq=MAX_PAGES, horizon=S_HORIZON)
    torch.cuda.synchronize()
    t0 = time.time()
    uids = [ref_eng.add_request(p, max_new_tokens=new) for p in prompts]
    ref_out = ref_eng.run()
    torch.cuda.synchronize()
    inproc_s = time.time() - t0
    same = [r["tokens"] == ref_out[u] for r, u in zip(results, uids)]
    # the fused layers' inputs on the path: a prefill and decode steps
    captured, hooks = {}, []
    for li in (0, layers - 1):
        for sub, name in (("self_attn", "qkv_proj"), ("mlp", "gate_up_proj")):
            def grab(mod, args, key=(li, name)):
                captured.setdefault(key, []).append(
                    args[0].detach().reshape(-1, args[0].shape[-1]).clone())
            hooks.append(params["layers"][li][sub][name].register_forward_pre_hook(grab))
    ref_eng.add_request(prompts[2], max_new_tokens=3)
    ref_eng.run()
    for h in hooks:
        h.remove()
    ref_eng.close()
    del ref_eng
    gc.collect()
    torch.cuda.empty_cache()

    # the unfused tree of the same checkpoint: launches of a decode step
    unfused_eng = build_engine(make_parser().parse_args(argv + ["--no-fuse"]))
    u_steps = []
    u_decode = unfused_eng._decode
    unfused_eng._decode = lambda h: (u_steps.append(h), u_decode(h))[1]
    ops.reset_launch_counts()
    unfused_eng.add_request(prompts[2], max_new_tokens=4)
    unfused_eng.run()
    unfused_per_step = launch_counts()["w4a8_matmul"] / sum(u_steps)
    _s_fused_checks(params, unfused_eng.params, captured)
    unfused_eng.close()
    del unfused_eng, params
    gc.collect()
    torch.cuda.empty_cache()

    tokens = sum(len(r["tokens"]) for r in results)
    # time to first token from the streams; a blocking request's first
    # token comes with its whole response, so its figure is request latency
    first = sorted(r["first_s"] for r in results if r["chunks"] is not None)
    blocking = sorted(r["done_s"] for r in results if r["chunks"] is None)
    log(f"[s] {dev_tag}: serve.main (paged, w4a8, fused, {G_SLOTS} slots, {G_PAGES} pages of "
        f"{PAGE} rows, horizon {S_HORIZON}) to a started server: {boot_s:.2f} s (checkpoint "
        f"load, prepare, fuse, the pool); warm-up request {warm_s:.2f} s")
    log(f"[s] {dev_tag}: 12 requests (prompts {[len(p) for p in prompts]}, {new} new, greedy) "
        f"from 12 client threads at once, 6 blocking and 6 streamed: window {window_s:.3f} s, "
        f"{tokens} tokens, {tokens / window_s:.1f} tok/s at the client; time to first token "
        f"over the {len(first)} streams median {first[len(first) // 2]:.3f} s, max "
        f"{first[-1]:.3f} s; request latency over the {len(blocking)} blocking requests median "
        f"{blocking[len(blocking) // 2]:.3f} s, max {blocking[-1]:.3f} s; {n_steps} decode steps "
        f"in {len(steps)} engine calls")
    log(f"[s] {dev_tag}: the same requests in-process (add_request, run): {inproc_s:.3f} s, "
        f"{tokens / inproc_s:.1f} tok/s; ids equal the server's in {sum(same)} of {len(same)}")
    log(f"[s] {dev_tag}: the window again under the profiler: device busy "
        f"{busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall, {busy['events']} device "
        f"events; device ms by kernel: {busy['top']}")
    log(f"[s] launches in the window: {launches}; a decode step: "
        f"{launches['w4a8_matmul'] / n_steps:.0f} w4a8_matmul (fused), {unfused_per_step:.0f} "
        f"unfused; cancel after the first chunk: {len(cut['tokens'])} of {new} tokens kept; "
        f"/healthz before and after {health[0][1]}; the server's peak {peak:.2f} GiB (boot "
        f"and windows)")
    if not all(same):
        raise AssertionError(f"[s] the server's ids differ from the in-process engine's in "
                             f"{len(same) - sum(same)} of {len(same)} requests")
    if unfused_per_step != 7 * layers:
        raise AssertionError(f"[s] the unfused decode step made {unfused_per_step} w4a8 launches")
    return launches


def phase_s_dense_int8(dev_tag: str) -> dict:
    """`serve.main --engine dense --backend int8 --int8-kv` on a 2-layer
    model at 7B width (4-bit g64 checkpoint, seed 30): 4 requests over HTTP
    (2 blocking, 2 streamed) whose ids equal the in-process
    ContinuousBatchingEngine's on the same tree; the int8 layer's products
    (`torch._int_mm`) against its plain twin, bit for bit, on the path's
    own activations; the logits of decode steps over the int8 dense cache
    (per-slot positions) against the bf16 cache's, with a control that
    must miss the bar. Returns the launches of its window."""
    import dataclasses
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.backends import int8_backend as i8
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models.llama import LlamaConfig, forward, init_cache, init_params
    from hqq_tpu_torch.serve import main as serve_main
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    int_mm = torch._int_mm
    int_mm_calls = [0]

    def counted_int_mm(*args):  # the library product has no launch count of its own
        int_mm_calls[0] += 1
        return int_mm(*args)

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_hidden_layers=2)
    root = tempfile.mkdtemp(prefix="hqq-serve-int8-")
    try:
        model = HQQModel(init_params(cfg, torch.Generator(device="cuda").manual_seed(30),
                                     torch.bfloat16, "cuda"), cfg)
        model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
        model.save_quantized(root)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(30)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in rng.integers(64, 401, 4)]
        srv = serve_main(["--model", root, "--port", "0", "--engine", "dense", "--backend", "int8",
                          "--int8-kv", "--slots", str(S_DENSE_SLOTS), "--max-len",
                          str(S_DENSE_MAX_LEN), "--horizon", str(S_HORIZON)], serve=False).start()
        try:
            _s_request(srv.port, prompts[0][:64], 4, False, time.time())  # warm-up
            ops.reset_launch_counts()
            with mock.patch.object(torch, "_int_mm", counted_int_mm):
                results, window_s = _s_window(srv.port, prompts, G_NEW)
            launches = launch_counts()
            int8_launches = int_mm_calls[0]
        finally:
            srv.stop()
    finally:
        shutil.rmtree(root)
    eng = srv.engine
    params = eng.params
    if not (eng.cache.quantized and isinstance(params["layers"][0]["self_attn"]["qkv_proj"],
                                                i8.Int8QuantLinear)):
        raise AssertionError("[s] the dense server does not hold int8 pools and fused int8 layers")
    eng.close()
    ref = ContinuousBatchingEngine(params, cfg, batch_slots=S_DENSE_SLOTS, max_len=S_DENSE_MAX_LEN,
                                   horizon=S_HORIZON, quantize_kv=True)
    uids = [ref.add_request(p, max_new_tokens=G_NEW) for p in prompts]
    ref_out = ref.run()
    same = sum(r["tokens"] == ref_out[u] for r, u in zip(results, uids))
    # the int8 layer on its own activations: a prefill and decode steps
    xs = []
    layer = params["layers"][0]["self_attn"]["qkv_proj"]
    hook = layer.register_forward_pre_hook(
        lambda mod, args: xs.append(args[0].detach().reshape(-1, args[0].shape[-1]).clone()))
    ref.add_request(prompts[1], max_new_tokens=3)
    ref.run()
    hook.remove()
    ref.close()
    exact, control_equal = True, False
    for x in xs:
        x8, _ = i8.quantize_activations_int8(x.to(layer.compute_dtype))
        acc = i8.int8_matmul(x8, layer.w8)
        exact &= torch.equal(acc, i8.int8_matmul_plain(x8, layer.w8))
        control_equal |= torch.equal(acc, i8.int8_matmul_plain(x8, layer.w8.roll(1, dims=0)))
    # decode over the int8 dense cache against the bf16 cache: the same
    # prefill, then 8 steps at per-slot positions
    toks = torch.randint(0, cfg.vocab_size, (4, 108), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(31))
    t = 100
    out = {}
    with torch.inference_mode():
        for name in ("bf16 cache", "int8 cache", "control"):
            cache = init_cache(cfg, 4, 256, torch.bfloat16, "cuda", quantize_kv=name != "bf16 cache")
            forward(params, cfg, toks[:, :t], cache, 0)
            if name == "control":  # the prompt's K rows read with scales of one
                cache.k_scales[:, :, :, :t] = 1.0
            steps = []
            for i in range(8):
                pos = torch.full((4,), t + i, dtype=torch.long, device="cuda")
                logits, cache = forward(params, cfg, toks[:, t + i:t + i + 1], cache, pos)
                steps.append(logits)
            out[name] = torch.cat(steps, dim=1)
    err, control = rel(out["int8 cache"], out["bf16 cache"]), rel(out["control"], out["bf16 cache"])
    # the int8 rows round every K/V value to 8 bits of its row's absmax, and
    # the int8 activations carry a changed attention output into flipped
    # roundings, as over int8 pages: phase g's bar between those paths
    tol = 0.1
    log(f"[s] {dev_tag}: dense engine, int8 backend (fused), int8 pools, 2 layers at 7B width: "
        f"4 requests over HTTP (prompts {[len(p) for p in prompts]}, {G_NEW} new) in "
        f"{window_s:.3f} s; ids equal the in-process engine's in {same} of 4; "
        f"{int8_launches} torch._int_mm calls; launches {launches}")
    log(f"[s] int8 layer (layer 0 qkv_proj, N={layer.out_features}): {len(xs)} calls, int32 "
        f"products of torch._int_mm bit-equal to the plain twin: {exact}; control, a "
        f"neighbour row's weights, equal: {control_equal} (must be False)")
    log(f"[s] 8 decode steps at per-slot positions after a {t}-token prefill: logits over the "
        f"int8 dense cache vs the bf16 cache, rel err {err:.3e} (tol {tol}); control, the "
        f"prompt's K rows read with scales of one: {control:.3e} (must exceed it)")
    if same != 4 or not int8_launches:
        raise AssertionError("[s] the dense int8 server differs from its engine in-process")
    if not exact or control_equal:
        raise AssertionError("[s] torch._int_mm disagrees with the plain int8 product")
    if not (err < tol < control) or not torch.isfinite(out["int8 cache"]).all():
        raise AssertionError("[s] the int8 dense cache's logits are off")
    del params, ref, eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- path R: the RMSNorm families. Gemma-2-9B (google/gemma-2-9b's config) at
# full width, R_LAYERS deep, through the server, then one 2-layer model at the
# published width of each other family
R_NEW, R_GEN_NEW = 32, 16
# the depth cuts for the script's time: Gemma-2-9B at 4 of its 42 layers,
# Falcon-7B at 4 of its 32 (10 and 8 when paths N and T came in, 4 and 4
# since path U)
R_LAYERS, L_LAYERS = 4, 4
# the bar of paged decode logits against the dense cache's: phase g's 0.1,
# except Granite's: its attention multiplier (1/128, not 1/sqrt(128))
# flattens the softmax and its residual multiplier (0.22) shrinks what
# attention adds, so even another slot's pages move its logits by only a
# few hundredths (0.026 in the first run) where the paged route reads 0.002
R_PAGED_BAR = {"granite": 1e-2}


def _r_configs() -> dict:
    """model_type -> (module, config at its published widths, cut to 2
    layers, seed): Mistral-7B-v0.1, granite-3.0-8b, gemma-7b, gemma-3-12b's
    text model (one sliding and one full layer), Phi-3-mini-4k, and
    OLMo-2-1124-7B."""
    import dataclasses

    from hqq_tpu_torch.models import gemma, gemma3, granite, mistral, olmo2, phi3

    two = dict(num_hidden_layers=2)
    return {
        "mistral": (mistral, mistral.MistralConfig(**two), 31),
        "granite": (granite, granite.GraniteConfig(
            vocab_size=49155, hidden_size=4096, intermediate_size=12800, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=4096, rms_norm_eps=1e-5,
            rope_theta=10000.0, tie_word_embeddings=True, embedding_multiplier=12.0,
            residual_multiplier=0.22, attention_multiplier=0.0078125, logits_scaling=16.0,
            **two), 32),
        "gemma": (gemma, gemma.GemmaConfig(
            vocab_size=256000, hidden_size=3072, intermediate_size=24576, num_attention_heads=16,
            num_key_value_heads=16, head_dim=256, max_position_embeddings=8192, **two), 33),
        "gemma3_text": (gemma3, dataclasses.replace(
            gemma3.Gemma3Config.gemma3_12b(), layer_types=("sliding_attention", "full_attention"),
            **two), 34),
        "phi3": (phi3, phi3.Phi3Config(
            vocab_size=32064, hidden_size=3072, intermediate_size=8192, num_attention_heads=32,
            num_key_value_heads=32, max_position_embeddings=4096, rms_norm_eps=1e-5,
            sliding_window=2047, **two), 35),
        "olmo2": (olmo2, dataclasses.replace(olmo2.Olmo2Config.olmo2_7b(), **two), 36),
    }


def _offset_toggled(x, w, eps, offset=0.0):
    """A control of the norm: (w + 1 - offset) in place of (w + offset)."""
    from hqq_tpu_torch.ops import norm as nm

    return nm.rms_norm_plain(x, w, eps, 1.0 - offset)


def _r_calls(tag: str, fwd, params, cfg, toks, t: int, steps: int, norm=None,
             extra=(), absent=()) -> dict:
    """A prefill of ``t`` tokens (M = 4 t) and ``steps`` decode steps over
    the dense cache, every w4a8_matmul, quant_matmul and norm call held
    on the spot to its plain twin on the path's own inputs: the matmuls
    within phase b's 2^-7 of max|y| (controls: each group with its
    neighbour's scale), the norm bit-equal (rms_norm's control: the offset
    toggled; ``norm`` = (wrapper name, plain twin, controls) for another).
    ``extra``: more wrappers held, as (module, name, plain twin, controls,
    bar). ``absent``: held wrappers the path must not call (a prefill of at
    most 32 rows takes w4a8, not quant_matmul). The cache is the family's
    (`llama.cache_for`). Returns the readings by wrapper, the matmuls'
    worst also by K, the norms' by width, the stacks' by (C, N, K)."""
    import dataclasses
    from unittest import mock

    from hqq_tpu_torch.models.llama import cache_for
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.ops import norm as nm

    def w4a8_scale(x8, sx, kqt, dt):
        return fm.w4a8_matmul_plain(x8, sx, dataclasses.replace(kqt, scale=kqt.scale.roll(1, 1)),
                                    dt)

    def qmm_scale(x, kqt):
        return fm.quant_matmul_plain(x, dataclasses.replace(kqt, scale=kqt.scale.roll(1, 1)))

    norm = norm or ("rms_norm", nm.rms_norm_plain, {"offset toggled": _offset_toggled})
    held = [(fm, "w4a8_matmul", fm.w4a8_matmul_plain, {"neighbour's scale": w4a8_scale}, 2.0**-7),
            (fm, "quant_matmul", fm.quant_matmul_plain, {"neighbour's scale": qmm_scale},
             2.0**-7),
            (nm, norm[0], norm[1], norm[2], 0.0), *extra]
    logs = {h[1]: {} for h in held}
    k_of = {"w4a8_matmul": lambda *a: a[2].k, "quant_matmul": lambda *a: a[1].k,
            norm[0]: lambda *a: a[0].shape[-1],
            "grouped_matmul": lambda x, qt: (x.shape[1], qt.shape[0], qt.shape[1])}
    with torch.inference_mode():
        patches = [mock.patch.object(mod, name, checked(getattr(mod, name), plain, ctl,
                                                        logs[name], k_of.get(name)))
                   for mod, name, plain, ctl, _ in held]
        for pt in patches:
            pt.start()
        try:
            cache = cache_for(cfg)(cfg, toks.shape[0], 256, torch.bfloat16, "cuda")
            logits, _ = fwd(params, cfg, toks[:, :t], cache, 0)
            for i in range(steps):
                logits, _ = fwd(params, cfg, toks[:, t + i:t + i + 1], cache, t + i)
        finally:
            for pt in patches:
                pt.stop()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"[{tag}] non-finite logits")
    out = {}
    for _, name, _, _, tol in held:
        per_call = logs[name]
        if name in absent:
            if per_call:
                raise AssertionError(f"[{tag}] {name} ran {len(per_call['kernel'])} times on a "
                                     f"path that must not call it")
            continue
        worst = max(per_call["kernel"])
        least = {c: min(v) for c, v in per_call.items() if c not in ("kernel", "keys")}
        out[name] = dict(calls=len(per_call["kernel"]), worst=worst, least=least)
        if "keys" in per_call:
            by_k = {}
            for k, e in zip(per_call["keys"], per_call["kernel"]):
                by_k[k] = max(by_k.get(k, 0.0), e)
            out[name]["worst_by_k"] = by_k
        if not worst <= tol or not all(v > tol for v in least.values()):
            raise AssertionError(f"[{tag}] {name}: {len(per_call['kernel'])} calls, rel err up "
                                 f"to {worst:.3e} (bar {tol:.1e}); controls at the least {least} "
                                 f"(each must exceed the bar)")
    return out


def _r_paged(tag: str, fwd, params, cfg, toks, kernel_layers: int) -> dict:
    """Paged decode against the dense cache (phase g's 2-layer check): a
    100-token dense prefill copied into bf16 pages, 8 decode steps through
    the family's paged branch against the dense steps (bar 0.1 of max|logit|;
    control: every slot on its neighbour's pages). Every paged_attention
    call is held to its plain version with phase g's controls, and must
    launch ``kernel_layers`` times a step (the layers without a window or a
    softcap)."""
    from unittest import mock

    from hqq_tpu_torch.models.llama import KVCache, init_cache
    from hqq_tpu_torch.ops import paged as pa
    from hqq_tpu_torch.ops.paged import PagedKVCache, init_paged_cache
    from hqq_tpu_torch.serving.paged import splice_prefill_into_pages

    b, t, steps = toks.shape[0], 100, 8
    tab = torch.zeros((b, 8), dtype=torch.int32, device="cuda")
    tab[:, :7] = 1 + torch.arange(b * 7, dtype=torch.int32, device="cuda").reshape(b, 7)
    per_call, out = {}, {}
    with torch.inference_mode():
        cache = init_cache(cfg, b, 256, torch.bfloat16, "cuda")
        fwd(params, cfg, toks[:, :t], cache, 0)
        pc = init_paged_cache(cfg, 1 + b * 7, PAGE, torch.bfloat16)
        for s in range(b):
            splice_prefill_into_pages(pc, KVCache(k=cache.k[:, s:s + 1], v=cache.v[:, s:s + 1]),
                                      tab[s, :7].tolist(), t)
        pools = {"paged": pc, "control": PagedKVCache(k=pc.k.clone(), v=pc.v.clone(),
                                                      page_size=PAGE)}
        dense = torch.cat([fwd(params, cfg, toks[:, t + i:t + i + 1], cache, t + i)[0]
                           for i in range(steps)], dim=1)
        for name, pool in pools.items():
            table = tab.roll(1, dims=0) if name == "control" else tab
            # the wrapper counts its launches on what its module name holds
            held = checked(pa.paged_attention, _paged_plain, PAGED_CONTROLS,
                           per_call if name == "paged" else {})
            with mock.patch.object(pa, "paged_attention", held):
                got = []
                for i in range(steps):
                    lengths = torch.full((b,), t + i, dtype=torch.int32, device="cuda")
                    got.append(fwd(params, cfg, toks[:, t + i:t + i + 1], pool, lengths,
                                   page_indices=table)[0])
            out[name] = rel(torch.cat(got, dim=1), dense)
            if name == "paged":
                out["launches"] = held.launches
    tol = R_PAGED_BAR.get(tag.split()[-1], 0.1)
    if not (out["paged"] < tol < out["control"]):
        raise AssertionError(f"[{tag}] paged logits vs dense {out['paged']:.3e}, control "
                             f"{out['control']:.3e} (bar {tol})")
    if out["launches"] != kernel_layers * steps:
        raise AssertionError(f"[{tag}] {out['launches']} paged_attention launches in {steps} "
                             f"steps, expected {kernel_layers} a step")
    if kernel_layers:
        worst = max(per_call["kernel"])
        least = {c: min(v) for c, v in per_call.items() if c != "kernel"}
        out["kernel_calls"] = dict(calls=len(per_call["kernel"]), worst=worst, least=least)
        if not worst <= TOL_PAGED_BF16_VS_FP32 or not all(
                v > TOL_PAGED_BF16_VS_FP32 for v in least.values()):
            raise AssertionError(f"[{tag}] paged_attention calls: rel err up to {worst:.3e}, "
                                 f"controls {least}")
    return out


def _kernel_layers(model_type: str, cfg) -> int:
    """The layers whose paged step reaches the paged-attention kernel: no
    window and no softcap (Granite's paged step takes no window, as in
    `hqq_tpu`)."""
    if model_type == "granite":
        return cfg.num_hidden_layers
    if model_type == "gpt_oss":  # sinks: every layer takes the gather route
        return 0
    if hasattr(cfg, "layer_is_sliding"):
        if getattr(cfg, "attn_logit_softcapping", None) is not None:
            return 0
        return sum(not cfg.layer_is_sliding(i) for i in range(cfg.num_hidden_layers))
    return 0 if cfg.sliding_window is not None else cfg.num_hidden_layers


def _r_two_layer(model_type: str, module, cfg, seed: int, norm=None, prepare=None) -> dict:
    """One family at its published width, 2 layers: random bf16 weights
    from ``seed``, 4-bit g64; its checkpoint through save_quantized and
    from_quantized (every tensor bit-equal, the config equal); w4a8; a
    prefill and 4 decode steps with every kernel call held (`_r_calls`,
    ``norm`` its norm's twin and controls); where the family has a paged
    branch, paged decode against the dense cache (`_r_paged`).
    ``prepare(params, generator)`` changes the drawn tree first. Returns
    the calls' readings."""
    import inspect
    import shutil
    import tempfile

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.hf import HQQModel, HQQModelForCausalLM
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    tag = f"{'r' if norm is None else 'l'} {model_type}"
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = module.init_params(cfg, gen, torch.bfloat16, "cuda")
    if prepare is not None:
        prepare(params, gen)
    quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=64))
    root = tempfile.mkdtemp(prefix="hqq-families-")
    try:
        HQQModel(params, cfg, model_type, quantized=True).save_quantized(root)
        back = HQQModelForCausalLM.from_quantized(root)
        n_tensors = _bit_equal_trees(tag, back.params, params)
        if back.cfg != cfg or type(back.cfg) is not type(cfg):
            raise AssertionError(f"[{tag}] the checkpoint's config came back as {back.cfg}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del back
    params = prepare_for_inference(params, "w4a8")
    toks = torch.randint(0, cfg.vocab_size, (4, 132), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    calls = _r_calls(tag, module.forward, params, cfg, toks, 128, 4, norm)
    paged = None
    if "page_indices" in inspect.signature(module.forward).parameters:
        paged = _r_paged(tag, module.forward, params, cfg, toks, _kernel_layers(model_type, cfg))
    ffn = getattr(cfg, "intermediate_size", 4 * cfg.hidden_size)
    log(f"[{tag}] 2 layers at published width (hidden {cfg.hidden_size}, ffn "
        f"{ffn}, heads {cfg.num_attention_heads}/{cfg.num_key_value_heads} of "
        f"{cfg.head_dim_}, vocab {cfg.vocab_size}): checkpoint {n_tensors} tensors bit-equal; "
        f"a prefill (M=512) and 4 decode steps, calls against their plain twins (calls, worst, "
        f"controls at the least): {calls}; paged decode against the dense cache: {paged}; "
        f"{time.time() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def _r_gemma2_9b(dev_tag: str) -> list:
    """Gemma-2-9B at full width, R_LAYERS of its depth (google/gemma-2-9b: hidden 3584,
    ffn 14336, 42 layers, 16/8 heads of 256, vocab 256000, window 4096,
    softcaps 50/30, query_pre_attn_scalar 256): random bf16 weights from
    seed 0, 4-bit g64, save_quantized; `serve.main` on the checkpoint with
    its defaults (paged, w4a8, fused), G's pool and a horizon of 8; G's 12
    requests from 12 client threads (6 streamed), ids equal to an
    in-process PagedBatchingEngine's on the served tree; then `Generator`
    on that tree, "partial" and "full", 4 prompts of 100 tokens; and the
    `--no-fuse` tree's decode step (294 w4a8 launches against 168). Returns
    the launch windows of the server and of the partial generate."""
    import dataclasses
    import shutil
    import tempfile

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models import gemma2
    from hqq_tpu_torch.serve import main as serve_main

    cfg = dataclasses.replace(gemma2.Gemma2Config.gemma2_9b(), num_hidden_layers=R_LAYERS)
    layers = cfg.num_hidden_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = gemma2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    model = HQQModel(params, cfg, "gemma2")
    del params
    t0 = time.time()
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    root = tempfile.mkdtemp(prefix="hqq-gemma2-9b-")
    try:
        t0 = time.time()
        model.save_quantized(root)
        save_s = time.time() - t0
        gb = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e9
        del model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[r] {dev_tag} Gemma-2-9B ({layers} of 42 layers): init {init_s:.1f} s, "
            f"quantize_model (4-bit "
            f"g64, {7 * layers} linears) {quant_s:.2f} s, save_quantized {gb:.3f} GB in "
            f"{save_s:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        argv = ["--model", root, "--port", "0", "--engine", "paged", "--backend", "w4a8",
                "--slots", str(G_SLOTS), "--num-pages", str(G_PAGES), "--page-size", str(PAGE),
                "--max-pages-per-seq", str(MAX_PAGES), "--horizon", str(S_HORIZON)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srv = serve_main(argv, serve=False).start()
        return _r_served(dev_tag, cfg, argv, srv, time.time() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _r_served(dev_tag: str, cfg, argv: list, srv, boot_s: float) -> list:
    """The rest of `_r_gemma2_9b`, on the started server ``srv`` of
    ``argv``'s checkpoint: the window, the in-process engine, a steady
    window's busy share, Generator, and the unfused tree's decode step."""
    import types

    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.serve import build_engine, make_parser

    layers, norms = cfg.num_hidden_layers, 4 * cfg.num_hidden_layers + 1
    eng = srv.engine
    params, fwd = eng.params, eng._fwd
    prompts = _g_prompts(cfg, np.random.default_rng(0))
    steps = []
    decode = eng._decode

    def counted(h):
        steps.append(h)
        return decode(h)

    eng._decode = counted
    try:
        if not all(set(layer["self_attn"]) == {"qkv_proj", "o_proj"}
                   and set(layer["mlp"]) == {"gate_up_proj", "down_proj"}
                   and isinstance(layer["self_attn"]["qkv_proj"], A8QuantLinear)
                   and isinstance(layer["mlp"]["gate_up_proj"], A8QuantLinear)
                   for layer in params["layers"]):
            raise AssertionError("[r] the served tree is not fused")
        t_warm = time.time()
        _s_request(srv.port, prompts[0][:64], 8, False, t_warm)
        warm_s = time.time() - t_warm
        # the main path's window: every count from 0, read right after
        ops.reset_launch_counts()
        steps.clear()
        results, window_s = _s_window(srv.port, prompts, R_NEW)
        launches = launch_counts()
        n_steps = sum(steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
    eng.close()
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    expect = {"w4a8_matmul": 4 * layers * n_steps, "paged_attention": 0,
              "rms_norm": norms * (n_steps + len(prompts)),
              "quant_matmul": 4 * layers * len(prompts)}
    for name, n in expect.items():
        if launches[name] != n:
            raise AssertionError(f"[r] {launches[name]} {name} launches in the window ({n_steps} "
                                 f"decode steps, {len(prompts)} prefills), expected {n}")

    # the same requests through the served tree in-process, decode timed
    outs, recs, inproc_s, _ = _serve_paged(types.SimpleNamespace(params=params, cfg=cfg),
                                           prompts, R_NEW, horizon=S_HORIZON, forward_fn=fwd)
    same = [r["tokens"] == o for r, o in zip(results, outs)]
    decode_s = sum(r["ms"] for r in recs) / 1e3
    dec_steps = sum(r["steps"] for r in recs)
    tokens = sum(r["live"] * r["steps"] for r in recs)
    embed = cfg.vocab_size * cfg.hidden_size * 2  # the tied head, read by every step
    weights = _step_weight_bytes(params) + embed
    kv = (sum(r["rows"] for r in recs) / len(recs)
          * 2 * layers * cfg.num_key_value_heads * cfg.head_dim_ * 2)
    bound = (weights + kv) / HBM_BYTES_PER_S * 1e3
    all_tokens = sum(len(r["tokens"]) for r in results)
    first = sorted(r["first_s"] for r in results if r["chunks"] is not None)
    log(f"[r] {dev_tag}: serve.main (paged, w4a8, fused, {G_SLOTS} slots, {G_PAGES} pages of "
        f"{PAGE} rows, horizon {S_HORIZON}) to a started server {boot_s:.2f} s, warm-up "
        f"{warm_s:.2f} s; 12 requests (prompts {[len(p) for p in prompts]}, {R_NEW} new, greedy) "
        f"from 12 client threads, 6 streamed: window {window_s:.3f} s, {all_tokens / window_s:.1f} "
        f"tok/s at the client; time to first token median {first[len(first) // 2]:.3f} s, max "
        f"{first[-1]:.3f} s; in-process {inproc_s:.3f} s, {all_tokens / inproc_s:.1f} tok/s, "
        f"ids equal the server's in {sum(same)} of {len(same)}; decode {tokens / decode_s:.1f} "
        f"tok/s over all slots, {decode_s / dec_steps * 1e3:.2f} ms a step against a byte bound "
        f"of {bound:.3f} ms ({weights / 1e9:.3f} GB of weights, meta and the tied "
        f"{cfg.vocab_size} x {cfg.hidden_size} bf16 embedding + {kv / 1e9:.3f} GB of K/V rows on "
        f"average); the server's peak {peak:.2f} GiB")
    log(f"[r] launches in the server's window ({n_steps} decode steps, {len(prompts)} "
        f"prefills): {launches}; a decode step: {4 * layers} w4a8_matmul, {norms} rms_norm, 0 "
        f"paged_attention (every layer of Gemma-2 has a softcap: the gather route)")
    if not all(same):
        raise AssertionError(f"[r] the server's ids differ from the in-process engine's in "
                             f"{len(same) - sum(same)} of {len(same)} requests")

    # the device's share of a steady decode window: 8 live slots, 8 steps
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    eng = PagedBatchingEngine(params, cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                              page_size=PAGE, max_pages_per_seq=MAX_PAGES, forward_fn=fwd)
    rng = np.random.default_rng(1)
    for _ in range(G_SLOTS):
        eng.add_request(rng.integers(0, cfg.vocab_size, 256), max_new_tokens=R_NEW)
    eng.step()
    busy = device_share(lambda: [eng.step() for _ in range(8)])
    eng.close()
    del eng
    log(f"[r] {dev_tag}: 8 decode steps of 8 slots at lengths around 260: device busy "
        f"{busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall; device ms by kernel "
        f"{busy['top']}")

    # Generator on the served tree: "partial" (the launch window), then "full"
    model = HQQModel(params, cfg, "gemma2", quantized=True)
    prompts4 = _prompts(cfg)
    partial = dict(compile_mode="partial")
    ops.reset_launch_counts()
    model.generate(prompts4, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    per_prefill = launch_counts()
    t0 = time.time()
    model.generate(prompts4, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    before = launch_counts()
    t0 = time.time()
    ids = model.generate(prompts4, max_new_tokens=R_GEN_NEW, **partial)
    torch.cuda.synchronize()
    partial_tok_s = 4 * (R_GEN_NEW - 1) / (time.time() - t0 - prefill_s)
    gen_window = launch_counts()
    per_step = {k: (gen_window[k] - before[k] - per_prefill[k]) / (R_GEN_NEW - 1)
                for k in ("w4a8_matmul", "rms_norm", "paged_attention")}
    if per_step != {"w4a8_matmul": 4 * layers, "rms_norm": norms, "paged_attention": 0}:
        raise AssertionError(f"[r] a partial decode step launched {per_step}")
    full_ids = model.generate(prompts4, max_new_tokens=R_GEN_NEW)
    captures = model.generator().captures()
    t0 = time.time()
    model.generate(prompts4, max_new_tokens=R_GEN_NEW)
    torch.cuda.synchronize()
    full_tok_s = 4 * (R_GEN_NEW - 1) / (time.time() - t0 - prefill_s)
    full_busy = device_share(lambda: model.generate(prompts4, max_new_tokens=8))
    model.release_graphs()
    log(f"[r] {dev_tag}: Generator on the served tree, 4 prompts of 100 tokens, {R_GEN_NEW} new: "
        f"partial {partial_tok_s:.1f} tok/s, full {full_tok_s:.1f} tok/s (prefill "
        f"{prefill_s * 1e3:.1f} ms); ids full == partial: {np.array_equal(ids, full_ids)}; "
        f"graphs' recorded launches {[c['launches'] for c in captures.values()]}; an 8-token "
        f"full generate busy {full_busy['busy_share']:.3f} of {full_busy['wall_ms']:.1f} ms, "
        f"device ms {full_busy['device_ms']:.3f}")
    if not np.array_equal(ids, full_ids):
        raise AssertionError("[r] the graph's greedy ids differ from the eager loop's")
    for key, cap in captures.items():
        if cap["launches"] != {"w4a8_matmul": 4 * layers, "rms_norm": norms}:
            raise AssertionError(f"[r] graph {key} recorded {cap['launches']}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # the unfused tree of the same checkpoint: the w4a8 launches of a step
    unfused = build_engine(make_parser().parse_args(argv + ["--no-fuse"]))
    u_steps = []
    u_decode = unfused._decode
    unfused._decode = lambda h: (u_steps.append(h), u_decode(h))[1]
    ops.reset_launch_counts()
    unfused.add_request(prompts[2], max_new_tokens=4)
    unfused.run()
    u_counts = launch_counts()
    unfused.close()
    del unfused
    gc.collect()
    torch.cuda.empty_cache()
    u_per_step = u_counts["w4a8_matmul"] / sum(u_steps)
    log(f"[r] the unfused tree (--no-fuse): {u_per_step:.0f} w4a8_matmul launches a decode step "
        f"against the fused tree's {4 * layers}")
    if u_per_step != 7 * layers:
        raise AssertionError(f"[r] the unfused decode step made {u_per_step} w4a8 launches")
    return [launches, gen_window]


def phase_r(dev_tag: str) -> list:
    """Path R, the RMSNorm families: `_r_gemma2_9b`, then `_r_two_layer`
    for each other family. Returns the launch windows of Gemma-2-9B."""
    t0 = time.time()
    windows = _r_gemma2_9b(dev_tag)
    for model_type, (module, cfg, seed) in _r_configs().items():
        _r_two_layer(model_type, module, cfg, seed)
    log(f"[r] phase r: {time.time() - t0:.1f} s")
    return windows


# -- path L: the LayerNorm families ---------------------------------------------
L_MAX_LEN = 2048  # Falcon-7B's positions: G's longest prompt (640, t_pad 1024) + 32 new


def _l_configs() -> dict:
    """model_type -> (module, config at its published widths, cut to 2
    layers, seed): bigcode/starcoder2-7b, microsoft/phi-2,
    CohereForAI/c4ai-command-r-plus, gpt2-xl, bigscience/bloom-7b1 and
    tiiuae/falcon-rw-1b (ALiBi, sequential blocks, biases)."""
    import dataclasses

    from hqq_tpu_torch.models import bloom, cohere, falcon, gpt2, phi, starcoder2

    two = dict(num_hidden_layers=2)
    return {
        "starcoder2": (starcoder2, dataclasses.replace(
            starcoder2.Starcoder2Config.starcoder2_7b(), **two), 41),
        "phi": (phi, dataclasses.replace(phi.PhiConfig.phi2(), **two), 42),
        "cohere": (cohere, dataclasses.replace(cohere.CohereConfig.command_r_plus(), **two), 43),
        "gpt2": (gpt2, dataclasses.replace(gpt2.GPT2Config.gpt2_xl(), **two), 44),
        "bloom": (bloom, bloom.BloomConfig(vocab_size=250880, hidden_size=4096,
                                           num_attention_heads=32, **two), 45),
        "falcon": (falcon, falcon.FalconConfig(
            vocab_size=50304, hidden_size=2048, num_attention_heads=32, alibi=True,
            multi_query=False, parallel_attn=False, bias=True, **two), 46),
    }


def _l_perturb(params, gen) -> None:
    """Every norm weight 1 + N(0, 0.1^2) and every norm and linear bias
    N(0, 0.1^2) (init leaves them 1 and 0, where a dropped bias would not
    show), in place, from ``gen``."""
    def draw(t, base):
        return (base + 0.1 * torch.randn(t.shape, generator=gen, device=t.device)).to(t.dtype)

    def walk(node, name=""):
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, torch.Tensor):
                    if k == "bias":
                        node[k] = draw(v, 0.0)
                    elif "norm" in k or "ln" in name or "norm" in name:
                        node[k] = draw(v, 1.0)
                else:
                    walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, name)
        elif getattr(node, "bias", None) is not None:
            node.bias.data = draw(node.bias.data, 0.0)

    walk(params)


def _l_norm(cfg):
    """layer_norm's twin and controls for `_r_calls`: mu left out (the RMS
    form) always, the bias dropped where the norms have one (not Cohere's)."""
    from hqq_tpu_torch.models.cohere import CohereConfig
    from hqq_tpu_torch.ops import norm as nm

    controls = {"mu left out": _ln_no_mean}
    if not isinstance(cfg, CohereConfig):
        controls["bias dropped"] = _ln_no_bias
    return "layer_norm", nm.layer_norm_plain, controls


def _l_falcon_7b(dev_tag: str) -> list:
    """Falcon-7B at full width, L_LAYERS of its depth (tiiuae/falcon-7b: hidden 4544, 32
    layers, 71 heads of 64, multi-query, parallel attention from one norm,
    no bias, no ALiBi, vocab 65024, tied head): random bf16 weights from
    seed 0, 4-bit g64, save_quantized; `serve.main` on the checkpoint with
    its defaults (w4a8, fused: Falcon's tree stays as it is; the paged
    engine asked, the dense one served) and a max_len of 2048; G's 12
    requests from 12 client threads (6 streamed), ids equal to an
    in-process ContinuousBatchingEngine's on the served tree; the first and
    last layer's four linears held on the path's own activations; then
    `Generator` on the tree, "partial" and "full". Returns the launch
    windows of the server and of the partial generate."""
    import dataclasses
    import shutil
    import tempfile

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models import falcon
    from hqq_tpu_torch.serve import main as serve_main

    cfg = dataclasses.replace(falcon.FalconConfig.falcon_7b(), num_hidden_layers=L_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = falcon.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    model = HQQModel(params, cfg, "falcon")
    del params
    t0 = time.time()
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    root = tempfile.mkdtemp(prefix="hqq-falcon-7b-")
    try:
        t0 = time.time()
        model.save_quantized(root)
        save_s = time.time() - t0
        gb = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e9
        del model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[l] {dev_tag} Falcon-7B ({cfg.num_hidden_layers} of 32 layers): init {init_s:.1f} "
            f"s, quantize_model (4-bit "
            f"g64, {4 * cfg.num_hidden_layers} linears) {quant_s:.2f} s, save_quantized "
            f"{gb:.3f} GB in {save_s:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB")
        argv = ["--model", root, "--port", "0", "--max-len", str(L_MAX_LEN)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srv = serve_main(argv, serve=False).start()
        return _l_served(dev_tag, cfg, srv, time.time() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


FALCON_LINEARS = {"query_key_value": "self_attn", "dense": "self_attn", "dense_h_to_4h": "mlp",
                  "dense_4h_to_h": "mlp"}


def _l_linear_checks(params, captured, subs=None, tag: str = "l") -> dict:
    """The first and last layer's four linears on the path's own inputs
    (``captured``: (layer, name) -> a prefill's and decode steps' x): at
    decode M the w4a8 kernel against its twin with phase b's bars and
    controls (`_w4a8_held`), at prefill M quant_matmul within 2^-7 with the
    neighbour's-scale control. Returns the largest relative error by K."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    subs = subs or FALCON_LINEARS
    tol, by_k = 2.0**-7, {}
    for (li, name), xs in sorted(captured.items()):
        kqt = params["layers"][li][subs[name]][name].kqt
        for x in xs[:3]:  # the prefill and two decode steps
            m = x.shape[0]
            what = f"[{tag}] layer {li} {name} (K={kqt.k}, N={kqt.n}) M={m}"
            if m <= fm.A8_MAX_M:
                x8, sx = fm.quantize_activations_int8(x)
                _w4a8_held(what, kqt, lambda q, dt: fm.w4a8_matmul(x8, sx, q, dt),
                           lambda q, dt: fm.w4a8_matmul_plain(x8, sx, q, dt))
                err = rel(fm.w4a8_matmul(x8, sx, kqt, torch.bfloat16),
                          fm.w4a8_matmul_plain(x8, sx, kqt, torch.bfloat16))
            else:
                ref = fm.quant_matmul_plain(x, kqt)
                err = rel(fm.quant_matmul(x, kqt), ref)
                controls = {c: rel(fm.quant_matmul_plain(x, bad), ref)
                            for c, bad in _w4a8_controls(kqt).items()}
                log(f"{what}: quant_matmul rel err {err:.3e} (tol 2^-7); controls "
                    f"{ {c: round(v, 4) for c, v in controls.items()} }")
                if not err <= tol or not all(v > tol for v in controls.values()):
                    raise AssertionError(f"{what}: quant_matmul rel err {err:.3e}, controls "
                                         f"{controls}")
            key = ("w4a8" if m <= fm.A8_MAX_M else "quant_matmul", kqt.k)
            by_k[key] = max(by_k.get(key, 0.0), err)
    return by_k


def _l_served(dev_tag: str, cfg, srv, boot_s: float) -> list:
    """The rest of `_l_falcon_7b`, on the started server ``srv``."""
    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    layers, norms = cfg.num_hidden_layers, cfg.num_hidden_layers + 1
    eng = srv.engine
    params, fwd = eng.params, eng._fwd
    prompts = _g_prompts(cfg, np.random.default_rng(0))
    steps = []
    decode = eng._decode

    def counted(h):
        steps.append(h)
        return decode(h)

    eng._decode = counted
    try:
        if not isinstance(eng, ContinuousBatchingEngine) or eng.s != G_SLOTS:
            raise AssertionError(f"[l] the server runs {type(eng).__name__} of {eng.s} slots, not "
                                 f"the dense engine of {G_SLOTS}")
        if not all(set(layer["self_attn"]) == {"query_key_value", "dense"}
                   and all(isinstance(m, A8QuantLinear) for m in
                           (*layer["self_attn"].values(), *layer["mlp"].values()))
                   for layer in params["layers"]):
            raise AssertionError("[l] the served tree is not Falcon's w4a8 tree as it was")
        t_warm = time.time()
        _s_request(srv.port, prompts[0][:64], 8, False, t_warm)
        warm_s = time.time() - t_warm
        # the main path's window: every count from 0, read right after
        ops.reset_launch_counts()
        steps.clear()
        results, window_s = _s_window(srv.port, prompts, R_NEW)
        launches = launch_counts()
        n_steps = sum(steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
    del srv
    expect = {"w4a8_matmul": 4 * layers * n_steps, "layer_norm": norms * (n_steps + len(prompts)),
              "quant_matmul": 4 * layers * len(prompts), "rms_norm": 0, "paged_attention": 0}
    log(f"[l] launches in the server's window ({n_steps} decode steps, {len(prompts)} "
        f"prefills): {launches}; a decode step: {4 * layers} w4a8_matmul, {norms} layer_norm, 0 "
        f"rms_norm expected")
    for name, n in expect.items():
        if launches[name] != n:
            raise AssertionError(f"[l] {launches[name]} {name} launches in the window ({n_steps} "
                                 f"decode steps, {len(prompts)} prefills), expected {n}: a step "
                                 f"must make {4 * layers} w4a8_matmul, {norms} layer_norm and no "
                                 f"rms_norm launches")

    # the same requests through the served tree in-process, decode timed
    ref = ContinuousBatchingEngine(params, cfg, batch_slots=G_SLOTS, max_len=L_MAX_LEN,
                                   horizon=S_HORIZON, forward_fn=fwd)
    recs, ref_decode = [], ref._decode

    def timed(h):
        live = len(ref.active)
        torch.cuda.synchronize()
        t0 = time.time()
        out = ref_decode(h)  # ends in a read-back of the tokens
        recs.append(dict(steps=h, live=live, ms=(time.time() - t0) * 1e3))
        return out

    ref._decode = timed
    torch.cuda.synchronize()
    t0 = time.time()
    uids = [ref.add_request(p, max_new_tokens=R_NEW) for p in prompts]
    ref_out = ref.run()
    torch.cuda.synchronize()
    inproc_s = time.time() - t0
    same = [r["tokens"] == ref_out[u] for r, u in zip(results, uids)]
    # the four linears of the first and last layer on the path's inputs
    captured, hooks = {}, []
    for li in (0, layers - 1):
        for sub, name in (("self_attn", "query_key_value"), ("self_attn", "dense"),
                          ("mlp", "dense_h_to_4h"), ("mlp", "dense_4h_to_h")):
            def grab(mod, args, key=(li, name)):
                captured.setdefault(key, []).append(
                    args[0].detach().reshape(-1, args[0].shape[-1]).clone())
            hooks.append(params["layers"][li][sub][name].register_forward_pre_hook(grab))
    ref.add_request(prompts[2], max_new_tokens=3)
    ref.run()
    for h in hooks:
        h.remove()
    # the device's share of a steady decode window: 8 live slots, 8 steps
    rng = np.random.default_rng(1)
    for _ in range(G_SLOTS):
        ref.add_request(rng.integers(0, cfg.vocab_size, 256), max_new_tokens=R_NEW)
    ref.step()
    busy = device_share(lambda: [ref.step() for _ in range(8)])
    ref.close()
    eng.close()
    del ref, eng
    gc.collect()
    torch.cuda.empty_cache()
    by_k = _l_linear_checks(params, captured)
    log(f"[l] Falcon-7B's K = 4544 (17.75 stages of 256 codes, the first K on a path that is "
        f"not whole stages): largest rel err w4a8 {by_k[('w4a8', 4544)]:.3e}, quant_matmul "
        f"{by_k[('quant_matmul', 4544)]:.3e} (bar 2^-7 = {2.0**-7:.3e}); K = 18176: w4a8 "
        f"{by_k[('w4a8', 18176)]:.3e}, quant_matmul {by_k[('quant_matmul', 18176)]:.3e}")

    decode_s = sum(r["ms"] for r in recs) / 1e3
    dec_steps = sum(r["steps"] for r in recs)
    tokens = sum(r["live"] * r["steps"] for r in recs)
    embed = cfg.vocab_size * cfg.hidden_size * 2  # the tied head, read by every step
    weights = _step_weight_bytes(params) + embed
    bound = weights / HBM_BYTES_PER_S * 1e3
    all_tokens = sum(len(r["tokens"]) for r in results)
    first = sorted(r["first_s"] for r in results if r["chunks"] is not None)
    log(f"[l] {dev_tag}: serve.main (defaults: w4a8, fused, the dense engine of {G_SLOTS} slots, "
        f"max_len {L_MAX_LEN}, horizon {S_HORIZON}) to a started server {boot_s:.2f} s, warm-up "
        f"{warm_s:.2f} s; 12 requests (prompts {[len(p) for p in prompts]}, {R_NEW} new, greedy) "
        f"from 12 client threads, 6 streamed: window {window_s:.3f} s, {all_tokens / window_s:.1f} "
        f"tok/s at the client; time to first token median {first[len(first) // 2]:.3f} s, max "
        f"{first[-1]:.3f} s; in-process {inproc_s:.3f} s, {all_tokens / inproc_s:.1f} tok/s, "
        f"ids equal the server's in {sum(same)} of {len(same)}; decode {tokens / decode_s:.1f} "
        f"tok/s over all slots, {decode_s / dec_steps * 1e3:.2f} ms a step against a byte bound "
        f"of {bound:.3f} ms ({weights / 1e9:.3f} GB of codes, meta and the tied "
        f"{cfg.vocab_size} x {cfg.hidden_size} bf16 embedding; K/V rows of one kv head "
        f"aside); the server's peak {peak:.2f} GiB")
    top = sorted(busy["by_name"].items(), key=lambda kv: -kv[1])[:6]
    log(f"[l] {dev_tag}: 8 decode steps of 8 slots at lengths around 260: device busy "
        f"{busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall, device "
        f"{busy['device_ms']:.3f} ms; device ms by kernel "
        f"{ {k[:110]: round(v, 3) for k, v in top} }")
    if not all(same):
        raise AssertionError(f"[l] the server's ids differ from the in-process engine's in "
                             f"{len(same) - sum(same)} of {len(same)} requests")

    # Generator on the served tree: "partial" (the launch window), then "full"
    model = HQQModel(params, cfg, "falcon", quantized=True)
    prompts4 = _prompts(cfg)
    partial = dict(compile_mode="partial")
    ops.reset_launch_counts()
    model.generate(prompts4, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    per_prefill = launch_counts()
    t0 = time.time()
    model.generate(prompts4, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    before = launch_counts()
    t0 = time.time()
    ids = model.generate(prompts4, max_new_tokens=R_GEN_NEW, **partial)
    torch.cuda.synchronize()
    partial_tok_s = 4 * (R_GEN_NEW - 1) / (time.time() - t0 - prefill_s)
    gen_window = launch_counts()
    step = {"w4a8_matmul": 4 * layers, "layer_norm": norms}
    per_step = {k: (gen_window[k] - before[k] - per_prefill[k]) / (R_GEN_NEW - 1)
                for k in ("w4a8_matmul", "layer_norm", "rms_norm")}
    if per_step != dict(step, rms_norm=0):
        raise AssertionError(f"[l] a partial decode step launched {per_step}")
    full_ids = model.generate(prompts4, max_new_tokens=R_GEN_NEW)
    captures = model.generator().captures()
    t0 = time.time()
    model.generate(prompts4, max_new_tokens=R_GEN_NEW)
    torch.cuda.synchronize()
    full_tok_s = 4 * (R_GEN_NEW - 1) / (time.time() - t0 - prefill_s)
    full_busy = device_share(lambda: model.generate(prompts4, max_new_tokens=8))
    model.release_graphs()
    log(f"[l] {dev_tag}: Generator on the served tree, 4 prompts of 100 tokens, {R_GEN_NEW} new: "
        f"partial {partial_tok_s:.1f} tok/s, full {full_tok_s:.1f} tok/s (prefill "
        f"{prefill_s * 1e3:.1f} ms); ids full == partial: {np.array_equal(ids, full_ids)}; "
        f"graphs' recorded launches {[c['launches'] for c in captures.values()]}; an 8-token "
        f"full generate busy {full_busy['busy_share']:.3f} of {full_busy['wall_ms']:.1f} ms, "
        f"device ms {full_busy['device_ms']:.3f}")
    if not np.array_equal(ids, full_ids):
        raise AssertionError("[l] the graph's greedy ids differ from the eager loop's")
    for key, cap in captures.items():
        if cap["launches"] != step:
            raise AssertionError(f"[l] graph {key} recorded {cap['launches']}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return [launches, gen_window]


def phase_l(dev_tag: str) -> list:
    """Path L, the LayerNorm families: `_l_falcon_7b`, then `_r_two_layer`
    for one model of each family at its published widths (norms and biases
    drawn, layer_norm held bit-equal with its controls). Returns the launch
    windows of Falcon-7B."""
    t0 = time.time()
    windows = _l_falcon_7b(dev_tag)
    for model_type, (module, cfg, seed) in _l_configs().items():
        calls = _r_two_layer(model_type, module, cfg, seed, norm=_l_norm(cfg),
                             prepare=_l_perturb)
        if model_type == "gpt2":
            log(f"[l] gpt2-xl's K = 1600 (6.25 stages of 256 codes): largest rel err w4a8 "
                f"{calls['w4a8_matmul']['worst_by_k'][1600]:.3e}, quant_matmul "
                f"{calls['quant_matmul']['worst_by_k'][1600]:.3e} (bar 2^-7)")
    log(f"[l] phase l: {time.time() - t0:.1f} s")
    return windows


X_CAPACITY = 4.0  # Mixtral's E / top_k: no assignment is dropped, a request's ids are its own
X_LAYERS = 2  # of Mixtral-8x7B's 32: the depth cut for the script's time (paths P, N, U came in)


def _x_mixtral_8x7b(dev_tag: str) -> list:
    """Mixtral-8x7B at full width, X_LAYERS of its 32 layers
    (mistralai/Mixtral-8x7B-v0.1, from memory: hidden 4096, ffn 14336,
    32/8 heads, 8 experts,
    top-2, vocab 32000 untied, rope theta 1e6, no window): random bf16
    weights from seed 0 drawn and quantized one layer at a time (the bf16
    model, 93 GB, does not fit the card) by `quantize_mixtral` (attention
    and experts 4-bit g64, the router in bf16), capacity factor 4.0,
    save_quantized; `serve.main` on the checkpoint with its defaults
    (paged, w4a8, fused), G's pool and a horizon of 8; G's 12 requests from
    12 client threads (6 streamed), ids equal to an in-process
    PagedBatchingEngine's on the served tree. Returns the launch windows of
    the server and of Generator's partial generate."""
    import dataclasses
    import shutil
    import tempfile

    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models import mixtral
    from hqq_tpu_torch.serve import main as serve_main

    cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(), capacity_factor=X_CAPACITY,
                              num_hidden_layers=X_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    params = mixtral.init_params(dataclasses.replace(cfg, num_hidden_layers=0), gen,
                                 torch.bfloat16, "cuda")  # the embedding, norm and lm_head
    one = dataclasses.replace(cfg, num_hidden_layers=1, vocab_size=8)
    init_s, quant_s = time.time() - t0, 0.0
    for _ in range(cfg.num_hidden_layers):
        t0 = time.time()
        layer = mixtral.init_params(one, gen, torch.bfloat16, "cuda")["layers"][0]
        torch.cuda.synchronize()
        t1 = time.time()
        mixtral.quantize_mixtral({"layers": [layer]})
        torch.cuda.synchronize()
        init_s, quant_s = init_s + t1 - t0, quant_s + time.time() - t1
        params["layers"].append(layer)
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    root = tempfile.mkdtemp(prefix="hqq-mixtral-8x7b-")
    try:
        t0 = time.time()
        HQQModel(params, cfg, "mixtral", quantized=True).save_quantized(root)
        save_s = time.time() - t0
        gb = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e9
        del params, layer
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[x] {dev_tag} Mixtral-8x7B ({cfg.num_hidden_layers} of 32 layers): init {init_s:.1f} s, quantize_mixtral "
            f"(4-bit g64: 4 attention linears and 3 stacks of 8 experts a layer; the router in "
            f"bf16), layer by layer, {quant_s:.2f} s, save_quantized {gb:.3f} GB in {save_s:.2f} "
            f"s, peak {build_peak:.2f} GiB")
        argv = ["--model", root, "--port", "0", "--engine", "paged", "--backend", "w4a8",
                "--slots", str(G_SLOTS), "--num-pages", str(G_PAGES), "--page-size", str(PAGE),
                "--max-pages-per-seq", str(MAX_PAGES), "--horizon", str(S_HORIZON)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srv = serve_main(argv, serve=False).start()
        return _x_served(dev_tag, cfg, srv, time.time() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _x_expert_checks(params, captured, block: str = "block_sparse_moe") -> dict:
    """The first and last layer's expert stacks on the path's own inputs
    (``captured``: (layer, name) -> x [E, C, K] of decode steps and a
    prefill): at C <= 32 the kernel against its twin within 2^-7 of max|y|
    with its controls (a neighbour's scale, expert e+1's codes), above it
    the dequantized stack and torch.bmm against the same twin."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    worst, least, n = {"kernel": 0.0, "bmm": 0.0}, {}, {"kernel": 0, "bmm": 0}
    for (li, name), xs in captured.items():
        gq = params["layers"][li][block]["experts"][name]
        qt = gq.qtensor()
        for x in xs:
            route = fm.grouped_plan_for(x, qt).route
            ref = fm.grouped_matmul_plain(x, qt)
            y = fm.grouped_matmul(x, qt) if route == "kernel" else gq(x)
            worst[route] = max(worst[route], rel(y, ref))
            n[route] += 1
            if route == "kernel":
                for c, bad in _grouped_controls(qt).items():
                    v = rel(fm.grouped_matmul_plain(x, bad), ref)
                    least[c] = min(least.get(c, v), v)
    if not (n["kernel"] and n["bmm"]) or max(worst.values()) > 2.0**-7 or not all(
            v > 2.0**-7 for v in least.values()):
        raise AssertionError(f"[{block}] expert calls on the path's inputs: {n} calls, worst "
                             f"{worst}, controls {least}")
    return dict(calls=n, worst=worst, controls=least)


def _x_served(dev_tag: str, cfg, srv, boot_s: float) -> list:
    """The rest of `_x_mixtral_8x7b`, on the started server ``srv``: the
    window, the in-process engine, the expert calls held, a steady window's
    busy share, Generator partial and full, and the same requests at the
    default capacity factor 2.0 with the share of assignments dropped."""
    import dataclasses
    import types
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models import mixtral
    from hqq_tpu_torch.nn import moe
    from hqq_tpu_torch.nn.moe import GroupedQuantLinear

    layers, norms = cfg.num_hidden_layers, 2 * cfg.num_hidden_layers + 1
    eng = srv.engine
    params, fwd = eng.params, eng._fwd
    prompts = _g_prompts(cfg, np.random.default_rng(0))
    steps = []
    decode = eng._decode

    def counted(h):
        steps.append(h)
        return decode(h)

    eng._decode = counted
    try:
        if not all(set(layer["self_attn"]) == {"qkv_proj", "o_proj"}
                   and isinstance(layer["self_attn"]["qkv_proj"], A8QuantLinear)
                   and type(layer["block_sparse_moe"]["gate"]).__name__ == "Linear"
                   and all(isinstance(v, GroupedQuantLinear)
                           for v in layer["block_sparse_moe"]["experts"].values())
                   for layer in params["layers"]):
            raise AssertionError("[x] the served tree is not Mixtral's fused w4a8 tree")
        if eng.cfg.capacity_factor != X_CAPACITY:
            raise AssertionError(f"[x] the served config's capacity factor is "
                                 f"{eng.cfg.capacity_factor}")
        t_warm = time.time()
        _s_request(srv.port, prompts[0][:64], 8, False, t_warm)
        warm_s = time.time() - t_warm
        # the main path's window: every count from 0, read right after
        ops.reset_launch_counts()
        steps.clear()
        results, window_s = _s_window(srv.port, prompts, R_NEW)
        launches = launch_counts()
        n_steps = sum(steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
    eng.close()
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {"w4a8_matmul": 2 * layers, "grouped_matmul": 3 * layers,
                "paged_attention": layers, "rms_norm": norms}
    per_prefill = {"quant_matmul": 2 * layers, "dequant_canonical": 3 * layers, "rms_norm": norms}
    expect = {k: per_step.get(k, 0) * n_steps + per_prefill.get(k, 0) * len(prompts)
              for k in set(per_step) | set(per_prefill)}
    log(f"[x] launches in the server's window ({n_steps} decode steps, {len(prompts)} "
        f"prefills): {launches}; a decode step: {per_step}; a prefill (every expert holds more "
        f"than 32 rows: the stack dequantized once, then torch.bmm): {per_prefill}")
    for name, n in expect.items():
        if launches[name] != n:
            raise AssertionError(f"[x] {launches[name]} {name} launches in the window ({n_steps} "
                                 f"decode steps, {len(prompts)} prefills), expected {n}")

    # the same requests through the served tree in-process, decode timed
    model_ns = types.SimpleNamespace(params=params, cfg=cfg)
    outs, recs, inproc_s, _ = _serve_paged(model_ns, prompts, R_NEW, horizon=S_HORIZON,
                                           forward_fn=fwd)
    same = [r["tokens"] == o for r, o in zip(results, outs)]
    decode_s = sum(r["ms"] for r in recs) / 1e3
    dec_steps = sum(r["steps"] for r in recs)
    tokens = sum(r["live"] * r["steps"] for r in recs)
    weights = _step_weight_bytes(params)
    kv = (sum(r["rows"] for r in recs) / len(recs)
          * 2 * layers * cfg.num_key_value_heads * cfg.head_dim_ * 2)
    bound = (weights + kv) / HBM_BYTES_PER_S * 1e3
    all_tokens = sum(len(r["tokens"]) for r in results)
    first = sorted(r["first_s"] for r in results if r["chunks"] is not None)
    log(f"[x] {dev_tag}: serve.main (paged, w4a8, fused, {G_SLOTS} slots, {G_PAGES} pages of "
        f"{PAGE} rows, horizon {S_HORIZON}) to a started server {boot_s:.2f} s, warm-up "
        f"{warm_s:.2f} s; 12 requests (prompts {[len(p) for p in prompts]}, {R_NEW} new, greedy) "
        f"from 12 client threads, 6 streamed: window {window_s:.3f} s, {all_tokens / window_s:.1f} "
        f"tok/s at the client; time to first token median {first[len(first) // 2]:.3f} s, max "
        f"{first[-1]:.3f} s; in-process {inproc_s:.3f} s, {all_tokens / inproc_s:.1f} tok/s, "
        f"ids equal the server's in {sum(same)} of {len(same)}; decode {tokens / decode_s:.1f} "
        f"tok/s over all slots, {decode_s / dec_steps * 1e3:.2f} ms a step against a byte bound "
        f"of {bound:.3f} ms ({weights / 1e9:.3f} GB of codes and meta of every expert and "
        f"linear, the routers and the bf16 lm_head + {kv / 1e9:.3f} GB of K/V rows on average); "
        f"the server's peak {peak:.2f} GiB")
    if not all(same):
        raise AssertionError(f"[x] the server's ids differ from the in-process engine's in "
                             f"{len(same) - sum(same)} of {len(same)} requests")
    # a request's ids are its own: the same requests in the reverse order,
    # so that each shares its decode steps and its experts' slots with others
    rev = _serve_paged(model_ns, prompts[::-1], R_NEW, horizon=S_HORIZON, forward_fn=fwd)[0]
    same_rev = [a == b for a, b in zip(rev[::-1], outs)]
    log(f"[x] the same requests in-process in the reverse order: ids equal in {sum(same_rev)} "
        f"of {len(same_rev)}")
    if not all(same_rev):
        raise AssertionError(f"[x] {len(same_rev) - sum(same_rev)} requests' ids move with the "
                             f"requests beside them")

    # the first and last layer's expert stacks on the path's own inputs
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    captured, hooks = {}, []
    for li in (0, layers - 1):
        for name in ("w1", "w2", "w3"):
            def grab(mod, args, key=(li, name)):
                captured.setdefault(key, []).append(args[0].detach().clone())
            hooks.append(params["layers"][li]["block_sparse_moe"]["experts"][name]
                         .register_forward_pre_hook(grab))
    eng = PagedBatchingEngine(params, cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                              page_size=PAGE, max_pages_per_seq=MAX_PAGES, forward_fn=fwd)
    for p in prompts[:3]:
        eng.add_request(p[:200], max_new_tokens=3)
    eng.run()
    for h in hooks:
        h.remove()
    checks = _x_expert_checks(params, captured)
    del captured
    log(f"[x] the expert stacks of layers 0 and {layers - 1} on the path's inputs: {checks}")
    # the device's share of a steady decode window: 8 live slots, 8 steps
    rng = np.random.default_rng(1)
    for _ in range(G_SLOTS):
        eng.add_request(rng.integers(0, cfg.vocab_size, 256), max_new_tokens=R_NEW)
    eng.step()
    busy = device_share(lambda: [eng.step() for _ in range(8)])
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    top = sorted(busy["by_name"].items(), key=lambda kv: -kv[1])[:6]
    log(f"[x] {dev_tag}: 8 decode steps of 8 slots at lengths around 260: device busy "
        f"{busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall, device "
        f"{busy['device_ms']:.3f} ms; device ms by kernel "
        f"{ {k[:90]: round(v, 3) for k, v in top} }")

    # Generator on the served tree: "partial" (the launch window), then "full"
    model = HQQModel(params, cfg, "mixtral", quantized=True)
    prompts4 = _prompts(cfg)
    partial = dict(compile_mode="partial")
    ops.reset_launch_counts()
    model.generate(prompts4, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    first_counts = launch_counts()
    t0 = time.time()
    model.generate(prompts4, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    before = launch_counts()
    t0 = time.time()
    ids = model.generate(prompts4, max_new_tokens=R_GEN_NEW, **partial)
    torch.cuda.synchronize()
    partial_tok_s = 4 * (R_GEN_NEW - 1) / (time.time() - t0 - prefill_s)
    gen_window = launch_counts()
    got = {k: (gen_window[k] - before[k] - first_counts[k]) / (R_GEN_NEW - 1)
           for k in ("w4a8_matmul", "rms_norm", "grouped_matmul", "paged_attention")}
    want = dict(per_step, paged_attention=0)  # Generator decodes over the dense cache
    if got != want:
        raise AssertionError(f"[x] a partial decode step launched {got}, expected {want}")
    full_ids = model.generate(prompts4, max_new_tokens=R_GEN_NEW)
    captures = model.generator().captures()
    t0 = time.time()
    model.generate(prompts4, max_new_tokens=R_GEN_NEW)
    torch.cuda.synchronize()
    full_tok_s = 4 * (R_GEN_NEW - 1) / (time.time() - t0 - prefill_s)
    full_busy = device_share(lambda: model.generate(prompts4, max_new_tokens=8))
    model.release_graphs()
    log(f"[x] {dev_tag}: Generator on the served tree, 4 prompts of 100 tokens, {R_GEN_NEW} new: "
        f"partial {partial_tok_s:.1f} tok/s, full {full_tok_s:.1f} tok/s (prefill "
        f"{prefill_s * 1e3:.1f} ms); ids full == partial: {np.array_equal(ids, full_ids)}; "
        f"graphs' recorded launches {[c['launches'] for c in captures.values()]}; an 8-token "
        f"full generate busy {full_busy['busy_share']:.3f} of {full_busy['wall_ms']:.1f} ms, "
        f"device ms {full_busy['device_ms']:.3f}")
    if not np.array_equal(ids, full_ids):
        raise AssertionError("[x] the graph's greedy ids differ from the eager loop's")
    graph_step = {k: v for k, v in want.items() if v}
    for key, cap in captures.items():
        if cap["launches"] != graph_step:
            raise AssertionError(f"[x] graph {key} recorded {cap['launches']}")
    del model

    # the same requests in-process at the default capacity factor (2.0):
    # the assignments the capacity drops, counted on the device
    cfg2 = dataclasses.replace(cfg, capacity_factor=2.0)
    kept = {"decode": torch.zeros((), dtype=torch.int64, device="cuda"),
            "prefill": torch.zeros((), dtype=torch.int64, device="cuda")}
    total = {"decode": 0, "prefill": 0}
    inner = moe.moe_dispatch

    def counting(probs, k, capacity):
        d, c = inner(probs, k, capacity)
        kind = "decode" if probs.shape[0] <= G_SLOTS else "prefill"
        kept[kind] += d.sum()
        total[kind] += probs.shape[0] * k
        return d, c

    with mock.patch.object(moe, "moe_dispatch", counting):
        outs2, _, _, _ = _serve_paged(
            types.SimpleNamespace(params=params, cfg=cfg2), prompts, R_NEW, horizon=S_HORIZON,
            forward_fn=lambda p, t, c, s, ptab=None: mixtral.forward(p, cfg2, t, c, s,
                                                                     page_indices=ptab))
    dropped = {k: 1 - int(kept[k]) / total[k] for k in total}
    log(f"[x] the same 12 requests in-process at capacity factor 2.0 (capacity "
        f"{moe.moe_capacity(G_SLOTS, 2, 8, 2.0)} a decode step of {G_SLOTS} slots): share of "
        f"assignments dropped: decode {dropped['decode']:.4f} of {total['decode']}, prefill "
        f"{dropped['prefill']:.4f} of {total['prefill']} (padding rows included); requests "
        f"whose ids equal those at 4.0: {sum(a == b for a, b in zip(outs2, outs))} of 12")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return [launches, gen_window]


class _RoutingReplay:
    """`moe_dispatch` for `_r_paged` on an MoE model: its calls come as the
    dense prefill (one a layer, passed through), the 8 dense decode steps
    (recorded), then the paged steps and the control's (each replays the
    dense step's dispatch and combine). At random weights a router's k-th
    and (k+1)-th choice lie close (top-8 of 128), and the paged kernel's
    rounding, within its bar, would move a token to another expert now and
    then; the replay keeps the check on the attention. How many of the
    paged steps' own routings differ from the dense ones is counted."""

    def __init__(self, module, layers: int, steps: int = 8):
        self.inner, self.layers, self.steps = module.moe_dispatch, layers, steps
        self.recorded, self.calls, self.differ = [], 0, 0

    def __call__(self, probs, k, capacity):
        d, c = self.inner(probs, k, capacity)
        i, self.calls = self.calls, self.calls + 1
        if i < self.layers:
            return d, c
        if i < self.layers * (1 + self.steps):
            self.recorded.append((d, c))
            return d, c
        rd, rc = self.recorded[(i - self.layers) % len(self.recorded)]
        if i < self.layers * (1 + 2 * self.steps):  # the paged steps (not the control)
            self.differ += int(not torch.equal(d, rd))
        return rd, rc

    def summary(self) -> dict:
        return dict(replayed_calls=self.layers * self.steps,
                    paged_routing_differs_in=self.differ)


def _x_configs() -> dict:
    """The 2-layer MoE models of path X at their published widths (from
    memory, no config.json in the repo): Qwen/Qwen3-30B-A3B and
    openai/gpt-oss-20b (one sliding and one full layer), at capacity
    factor E / top_k (16 and 8), which drops nothing, as on Mixtral's path
    (at the default 2.0 Qwen3-MoE's 4 decode rows give each expert one
    slot)."""
    import dataclasses

    from hqq_tpu_torch.models import gpt_oss, qwen3_moe

    qwen = qwen3_moe.Qwen3MoeConfig.qwen3_30b_a3b()
    oss = gpt_oss.GptOssConfig.gpt_oss_20b(num_hidden_layers=2)
    return {
        "qwen3_moe": (qwen3_moe, dataclasses.replace(
            qwen, num_hidden_layers=2,
            capacity_factor=qwen.num_experts / qwen.num_experts_per_tok),
            "quantize_qwen3_moe", 31),
        "gpt_oss": (gpt_oss, dataclasses.replace(
            oss, capacity_factor=oss.num_local_experts / oss.num_experts_per_tok),
            "quantize_gpt_oss", 32),
    }


def _x_two_layer(model_type: str, module, cfg, quantizer: str, seed: int) -> dict:
    """One MoE family at its published width, 2 layers: random bf16 weights
    from ``seed`` (gpt-oss's biases and sinks drawn), the family's quantizer
    (4-bit g64); the checkpoint through save_quantized and from_quantized,
    every tensor bit-equal; w4a8; a prefill (M = 512, the experts through
    the stacked dequant and torch.bmm) and 4 decode steps (the grouped
    kernel) with every w4a8, quant_matmul, rms_norm, grouped_matmul and
    stacked dequant call held to its twin; paged decode against the dense
    cache, the paged steps taking the dense steps' routing
    (`_RoutingReplay`)."""
    import dataclasses
    import shutil
    import tempfile
    from unittest import mock

    from hqq_tpu_torch.engine.hf import HQQModel, HQQModelForCausalLM
    from hqq_tpu_torch.nn import moe
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    tag = f"x {model_type}"
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = module.init_params(cfg, gen, torch.bfloat16, "cuda")
    if model_type == "gpt_oss":
        for layer in params["layers"]:
            for t in (layer["self_attn"]["sinks"], layer["mlp"]["gate_up_bias"],
                      layer["mlp"]["down_bias"], layer["mlp"]["router"].bias):
                t.data.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.1)
    getattr(module, quantizer)(params)
    root = tempfile.mkdtemp(prefix="hqq-moe-")
    try:
        HQQModel(params, cfg, model_type, quantized=True).save_quantized(root)
        back = HQQModelForCausalLM.from_quantized(root)
        n_tensors = _bit_equal_trees(tag, back.params, params)
        if back.cfg != cfg or type(back.cfg) is not type(cfg):
            raise AssertionError(f"[{tag}] the checkpoint's config came back as {back.cfg}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del back
    params = prepare_for_inference(params, "w4a8")
    toks = torch.randint(0, cfg.vocab_size, (4, 132), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(seed + 1))

    def grouped_bad(name):
        return lambda x, qt: fm.grouped_matmul_plain(x, _grouped_controls(qt)[name])

    def dequant_bad(qt, dtype):
        return fm.dequant_stacked_plain(dataclasses.replace(qt, scale=qt.scale.roll(1, 1)), dtype)

    extra = [(moe, "grouped_matmul", fm.grouped_matmul_plain,
              {c: grouped_bad(c) for c in ("neighbour's scale", "expert e+1's codes")}, 2.0**-7),
             (moe, "dequant_canonical", fm.dequant_stacked_plain,
              {"neighbour's scale": dequant_bad}, 0.0)]
    calls = _r_calls(tag, module.forward, params, cfg, toks, 128, 4, extra=extra)
    replay = _RoutingReplay(moe, cfg.num_hidden_layers)
    with mock.patch.object(moe, "moe_dispatch", replay):
        paged = _r_paged(tag, module.forward, params, cfg, toks, _kernel_layers(model_type, cfg))
    paged["routing"] = replay.summary()
    experts = getattr(cfg, "num_experts", getattr(cfg, "num_local_experts", None))
    log(f"[{tag}] 2 layers at published width (hidden {cfg.hidden_size}, heads "
        f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} of {cfg.head_dim_}, {experts} "
        f"experts, top-{cfg.num_experts_per_tok}, vocab {cfg.vocab_size}): checkpoint "
        f"{n_tensors} tensors bit-equal; a prefill (M=512) and 4 decode steps, calls against "
        f"their plain twins (calls, worst, controls at the least): {calls}; paged decode "
        f"against the dense cache: {paged}; {time.time() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def phase_x(dev_tag: str) -> list:
    """Path X, the MoE families: `_x_mixtral_8x7b` (Mixtral-8x7B through
    the server), then `_x_two_layer` for Qwen3-30B-A3B and gpt-oss-20b at
    their published widths. Returns the launch windows of Mixtral-8x7B."""
    t0 = time.time()
    windows = _x_mixtral_8x7b(dev_tag)
    for model_type, (module, cfg, quantizer, seed) in _x_configs().items():
        _x_two_layer(model_type, module, cfg, quantizer, seed)
    log(f"[x] phase x: {time.time() - t0:.1f} s")
    return windows


# -- path K: DeepSeek-V3 (MLA, group-limited sigmoid routing, dense-compute
# MoE with shared experts). Both configurations are written from memory: no
# copy of either config.json is in this repo.
#
# moonshotai/Moonlight-16B-A3B's config.json (model_type deepseek_v3): the
# query by q_proj (no q_lora_rank), one expert group, top-6 of 64 routed
# experts and 2 shared ones; rope_interleave is HF's default (True)
K_MOONLIGHT = dict(
    vocab_size=163840, hidden_size=2048, intermediate_size=11264, moe_intermediate_size=1408,
    num_hidden_layers=27, num_attention_heads=16, n_routed_experts=64, n_shared_experts=2,
    num_experts_per_tok=6, n_group=1, topk_group=1, norm_topk_prob=True,
    routed_scaling_factor=2.446, first_k_dense_replace=1, q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, rms_norm_eps=1e-5,
    rope_theta=50000.0, rope_scaling=None, max_position_embeddings=8192)
# of Moonlight's 27 layers (the first dense, then 4 MoE): the depth cut for
# the script's time (paths P and N came in)
K_MOONLIGHT_LAYERS = 3  # 5 until path U came in
# deepseek-ai/DeepSeek-V3's config.json: the published widths are the
# dataclass's defaults (hidden 7168, 128 heads, q_lora 1536, 256 experts in
# 8 groups, top-8 of the best 4 groups, 1 shared); its YaRN block; cut to
# 5 layers (first_k_dense_replace 3 as published, then 2 MoE layers): the
# 61 layers do not fit one card
K_V3_LAYERS = 5
K_V3_YARN = {"rope_type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1, "mscale": 1.0,
             "mscale_all_dim": 1.0, "original_max_position_embeddings": 4096}
K_V3_BATCH, K_V3_PROMPT, K_V3_NEW = 4, 8, 8
# DeepSeek-V3's logits against the plain path, of max|logit|: phase d's
# end-to-end bar. The routes differ by the w4a8 and grouped kernels' sums
# in another order (2^-7 a call), which flip some bf16 roundings and then,
# through the next layer's int8 activations, many; the router's inputs
# move with them. A token whose expert set differs between the two routes
# in some layer is left out of the bar: it sums other experts. Each such
# (token, layer) must be a near-tie: the plain route's k-th and (k+1)-th
# masked scores lie within 2 d (an expert swapped), or its topk_group-th
# and next group scores (sums of two) within 4 d (a group swapped), d the
# largest move of the row's scores between the routes. At random weights
# the sigmoid scores of the 128 experts in the chosen groups crowd at the
# top (a development run on the card: 32 of 96 differed, every one a
# near-tie), so up to half may differ; the others' tokens are held to the
# bar.
K_V3_LOGIT_BAR, K_V3_FLIPS_ALLOWED = 0.1, 0.5
# the router's weights on the card against its fp32 twin on the CPU: fp32
# sums in another order, no TF32. A development run on the card read 6.0e-8
# and, for the control (the logits product in TF32, ~2^-11 of each logit),
# 1.2e-5: the bar lies between them
K_ROUTER_BAR = 1e-6


def _k_counts(cfg) -> dict:
    """Launches of one pass (a decode step, or a prefill of more than 32
    rows) of the served tree (w4a8, fused): its w4a8 linears (the MLA
    projections, a dense layer's fused gate/up and down, a MoE layer's
    three shared-expert projections, which stay unfused), its norms (input,
    post-attention, the latent's, the low-rank query's, the final one), its
    routed stacks (three a MoE layer)."""
    layers = cfg.num_hidden_layers
    moe = layers - cfg.first_k_dense_replace
    attn = 4 if cfg.q_lora_rank is None else 5
    return dict(linears=attn * layers + 2 * cfg.first_k_dense_replace + 3 * moe,
                norms=(attn - 1) * layers + 1, stacks=3 * moe)


def _k_check_tree(tag: str, params, cfg) -> None:
    """The tree `serve.main` serves (w4a8, fused): every projection an
    `A8QuantLinear`, a dense layer's gate/up fused, a MoE layer's router in
    fp32, its routed stacks `GroupedQuantLinear`, its shared experts
    unfused."""
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.nn.moe import GroupedQuantLinear

    for i, layer in enumerate(params["layers"]):
        mlp = layer["mlp"]
        ok = all(isinstance(v, A8QuantLinear) for k, v in layer["self_attn"].items()
                 if k.endswith("proj") or k.endswith("mqa"))
        if i < cfg.first_k_dense_replace:
            ok &= set(mlp) == {"gate_up_proj", "down_proj"}
        else:
            ok &= (mlp["gate_weight"].dtype == torch.float32
                   and all(isinstance(v, GroupedQuantLinear) for v in mlp["experts"].values())
                   and set(mlp["shared_experts"]) == {"gate_proj", "up_proj", "down_proj"}
                   and all(isinstance(v, A8QuantLinear) for v in mlp["shared_experts"].values()))
        if not ok:
            raise AssertionError(f"[{tag}] layer {i} is not the served w4a8 tree")


def _k_latent_norm(params, cfg, x) -> dict:
    """The latent's norm reads ckv[..., :kv_lora_rank], a strided slice of
    the 576-wide row: the norm kernel on that slice bit-equal to its plain
    twin on a contiguous copy; control: the rows read as if contiguous (a
    wrong stride)."""
    from hqq_tpu_torch.ops import norm as nm

    sa = params["layers"][0]["self_attn"]
    ckv = sa["kv_a_proj_with_mqa"](x)
    lat = ckv[..., :cfg.kv_lora_rank]
    w = sa["kv_a_layernorm"]
    ref = nm.rms_norm_plain(lat.contiguous(), w, cfg.rms_norm_eps)
    got = nm.rms_norm(lat, w, cfg.rms_norm_eps)
    wrong = ckv.reshape(-1)[:lat.numel()].reshape(lat.shape)
    out = dict(strided=not lat.is_contiguous(), bit_equal=torch.equal(got, ref),
               wrong_stride=rel(nm.rms_norm_plain(wrong, w, cfg.rms_norm_eps), ref))
    if not (out["strided"] and out["bit_equal"] and out["wrong_stride"] > 2.0**-7):
        raise AssertionError(f"[k] the latent's norm over a strided slice: {out}")
    return out


def _k_broadcast_ms(shapes) -> dict:
    """Device ms of x2 [T, D] broadcast to [E, T, D] and made contiguous,
    as `deepseek3._moe_block` does once a layer for the w1 and w3 stacks."""
    out = {}
    for e, t, d in shapes:
        x2 = torch.randn((t, d), device="cuda").to(torch.bfloat16)
        out[f"E={e} T={t} D={d}"] = round(time_ms([lambda: x2.expand(e, t, d).contiguous()],
                                                  50), 4)
    return out


def _k_moonlight(dev_tag: str) -> list:
    """Moonlight-16B-A3B at full width, K_MOONLIGHT_LAYERS of its 27
    layers (`K_MOONLIGHT`): random
    bf16 weights from seed 0 drawn and quantized a layer at a time (4-bit
    g64 axis=1: `quantize_model` for the linears, `nn.moe.quantize_experts`
    for the routed stacks, the router in fp32), save_quantized;
    `serve.main` on the checkpoint with its defaults (w4a8, fused, 8 slots,
    the paged engine asked and the dense one served) and a max_len of 2048;
    G's 12 requests from 12 client threads (6 streamed), ids equal to an
    in-process ContinuousBatchingEngine's; then `Generator` on the tree.
    Returns the launch windows of the server and of the partial generate."""
    import dataclasses
    import shutil
    import tempfile

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models import deepseek3
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.nn.moe import quantize_experts
    from hqq_tpu_torch.serve import main as serve_main

    cfg = deepseek3.DeepseekV3Config(**dict(K_MOONLIGHT, num_hidden_layers=K_MOONLIGHT_LAYERS))
    qc = BaseQuantizeConfig(nbits=4, group_size=64)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    params = deepseek3.init_params(dataclasses.replace(cfg, num_hidden_layers=0), gen,
                                   torch.bfloat16, "cuda")  # the embedding, norm and lm_head
    init_s, quant_s = time.time() - t0, 0.0
    for i in range(cfg.num_hidden_layers):
        t0 = time.time()
        layer = deepseek3.init_layer(cfg, i, gen, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        t1 = time.time()
        quantize_model({"layers": [layer]}, qc)
        if "experts" in layer["mlp"]:
            quantize_experts(layer["mlp"]["experts"], ("w1", "w2", "w3"), qc, torch.bfloat16)
        torch.cuda.synchronize()
        init_s, quant_s = init_s + t1 - t0, quant_s + time.time() - t1
        params["layers"].append(layer)
    del layer
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    root = tempfile.mkdtemp(prefix="hqq-moonlight-")
    try:
        t0 = time.time()
        HQQModel(params, cfg, "deepseek_v3", quantized=True).save_quantized(root)
        save_s = time.time() - t0
        gb = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e9
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[k] {dev_tag} Moonlight-16B-A3B ({cfg.num_hidden_layers} of 27 layers): init "
            f"{init_s:.1f} s, quantize (4-bit g64: every linear but lm_head, 3 stacks of "
            f"{cfg.n_routed_experts} experts in each of "
            f"{cfg.num_hidden_layers - cfg.first_k_dense_replace} MoE layers; the router in "
            f"fp32), layer by layer, {quant_s:.2f} s, save_quantized {gb:.3f} GB in {save_s:.2f} "
            f"s, peak {build_peak:.2f} GiB")
        argv = ["--model", root, "--port", "0", "--max-len", str(L_MAX_LEN)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srv = serve_main(argv, serve=False).start()
        return _k_served(dev_tag, cfg, srv, time.time() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


MLA_LINEARS = {"q_proj": "self_attn", "kv_a_proj_with_mqa": "self_attn", "kv_b_proj": "self_attn",
               "o_proj": "self_attn"}


def _k_served(dev_tag: str, cfg, srv, boot_s: float) -> list:
    """The rest of `_k_moonlight`, on the started server ``srv``: the window
    and its launches, the in-process engine, the linears and expert stacks
    of the first and last layers on the path's own inputs, the latent's
    strided norm, a steady window's busy share, Generator partial and
    full."""
    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    layers = cfg.num_hidden_layers
    eng = srv.engine
    params, fwd = eng.params, eng._fwd
    prompts = _g_prompts(cfg, np.random.default_rng(0))
    steps = []
    decode = eng._decode

    def counted(h):
        steps.append(h)
        return decode(h)

    eng._decode = counted
    try:
        if not isinstance(eng, ContinuousBatchingEngine) or eng.s != G_SLOTS:
            raise AssertionError(f"[k] the server runs {type(eng).__name__} of {eng.s} slots, not "
                                 f"the dense engine of {G_SLOTS}")
        _k_check_tree("k", params, cfg)
        t_warm = time.time()
        _s_request(srv.port, prompts[0][:64], 8, False, t_warm)
        warm_s = time.time() - t_warm
        # the main path's window: every count from 0, read right after
        ops.reset_launch_counts()
        steps.clear()
        results, window_s = _s_window(srv.port, prompts, R_NEW)
        launches = launch_counts()
        n_steps = sum(steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
    del srv
    per = _k_counts(cfg)
    step = {"w4a8_matmul": per["linears"], "grouped_matmul": per["stacks"],
            "rms_norm": per["norms"]}
    prefill = {"quant_matmul": per["linears"], "dequant_canonical": per["stacks"],
               "rms_norm": per["norms"]}
    expect = {k: step.get(k, 0) * n_steps + prefill.get(k, 0) * len(prompts)
              for k in (*step, *prefill, "paged_attention")}
    log(f"[k] launches in the server's window ({n_steps} decode steps, {len(prompts)} prefills): "
        f"{launches}; a decode step: {step}; a prefill (every stack at more than 32 rows an "
        f"expert: dequantized once, then torch.bmm): {prefill}")
    for name, n in expect.items():
        if launches[name] != n:
            raise AssertionError(f"[k] {launches[name]} {name} launches in the window ({n_steps} "
                                 f"decode steps, {len(prompts)} prefills), expected {n}")

    # the same requests through the served tree in-process, decode timed
    ref = ContinuousBatchingEngine(params, cfg, batch_slots=G_SLOTS, max_len=L_MAX_LEN,
                                   horizon=S_HORIZON, forward_fn=fwd)
    recs, ref_decode = [], ref._decode

    def timed(h):
        live = len(ref.active)
        torch.cuda.synchronize()
        t0 = time.time()
        out = ref_decode(h)  # ends in a read-back of the tokens
        recs.append(dict(steps=h, live=live, ms=(time.time() - t0) * 1e3,
                         rows=float(np.mean(ref._pos))))
        return out

    ref._decode = timed
    torch.cuda.synchronize()
    t0 = time.time()
    uids = [ref.add_request(p, max_new_tokens=R_NEW) for p in prompts]
    ref_out = ref.run()
    torch.cuda.synchronize()
    inproc_s = time.time() - t0
    same = [r["tokens"] == ref_out[u] for r, u in zip(results, uids)]
    decode_s = sum(r["ms"] for r in recs) / 1e3
    dec_steps = sum(r["steps"] for r in recs)
    tokens = sum(r["live"] * r["steps"] for r in recs)
    rows = sum(r["rows"] * r["steps"] for r in recs) / dec_steps
    # the first and last layer's linears and expert stacks on the path's inputs
    lin_x, exp_x, hooks = {}, {}, []
    last = layers - 1
    for li in (0, last):
        for name in MLA_LINEARS:
            def grab(mod, args, key=(li, name)):
                lin_x.setdefault(key, []).append(
                    args[0].detach().reshape(-1, args[0].shape[-1]).clone())
            hooks.append(params["layers"][li]["self_attn"][name].register_forward_pre_hook(grab))
    for li in (cfg.first_k_dense_replace, last):
        for name in ("w1", "w2", "w3"):
            def grab_e(mod, args, key=(li, name)):
                exp_x.setdefault(key, []).append(args[0].detach().clone())
            hooks.append(params["layers"][li]["mlp"]["experts"][name]
                         .register_forward_pre_hook(grab_e))
    ref.add_request(prompts[2], max_new_tokens=3)
    ref.run()
    for h in hooks:
        h.remove()
    # the device's share of a steady decode window: 8 live slots, a horizon
    # of 8 decode steps an engine step, until the requests end
    rng = np.random.default_rng(1)
    for _ in range(G_SLOTS):
        ref.add_request(rng.integers(0, cfg.vocab_size, 256), max_new_tokens=R_NEW)
    ref.step()
    n0 = len(recs)
    busy = device_share(lambda: [ref.step() for _ in range(8)])
    busy_steps = sum(r["steps"] for r in recs[n0:])
    ref.close()
    eng.close()
    del ref, eng
    gc.collect()
    torch.cuda.empty_cache()
    by_k = _l_linear_checks(params, lin_x, MLA_LINEARS, "k")
    experts = _x_expert_checks(params, exp_x, "mlp")
    latent = _k_latent_norm(params, cfg, lin_x[(0, "kv_a_proj_with_mqa")][1])
    del lin_x, exp_x
    log(f"[k] the MLA projections of layers 0 and {last} on the path's inputs, largest rel err "
        f"by (route, K) (bar 2^-7): { {f'{a} K={b}': round(v, 5) for (a, b), v in by_k.items()} }; "
        f"the expert stacks of layers {cfg.first_k_dense_replace} and {last}: {experts}; the "
        f"latent's norm over ckv[..., :{cfg.kv_lora_rank}] of a {cfg.kv_lora_rank + 64}-wide "
        f"row: {latent}")

    routers = sum(layer["mlp"]["gate_weight"].numel() * 4 for layer in params["layers"]
                  if "experts" in layer["mlp"])
    weights = _step_weight_bytes(params) + routers
    kv = (G_SLOTS * rows * layers * cfg.num_attention_heads
          * (cfg.qk_head_dim + cfg.v_head_dim) * 2)
    bound = (weights + kv) / HBM_BYTES_PER_S * 1e3
    all_tokens = sum(len(r["tokens"]) for r in results)
    first = sorted(r["first_s"] for r in results if r["chunks"] is not None)
    log(f"[k] {dev_tag}: serve.main (defaults: w4a8, fused, the dense engine of {G_SLOTS} slots, "
        f"max_len {L_MAX_LEN}, horizon {S_HORIZON}) to a started server {boot_s:.2f} s, warm-up "
        f"{warm_s:.2f} s; 12 requests (prompts {[len(p) for p in prompts]}, {R_NEW} new, greedy) "
        f"from 12 client threads, 6 streamed: window {window_s:.3f} s, {all_tokens / window_s:.1f} "
        f"tok/s at the client; time to first token median {first[len(first) // 2]:.3f} s, max "
        f"{first[-1]:.3f} s; in-process {inproc_s:.3f} s, {all_tokens / inproc_s:.1f} tok/s, "
        f"ids equal the server's in {sum(same)} of {len(same)}; decode {tokens / decode_s:.1f} "
        f"tok/s over all slots, {decode_s / dec_steps * 1e3:.2f} ms a step against a byte bound "
        f"of {bound:.3f} ms ({weights / 1e9:.3f} GB of codes and meta of every routed expert "
        f"(each step runs them all) and linear, the fp32 routers and the bf16 lm_head + "
        f"{kv / 1e9:.3f} GB of MLA K/V rows of all 8 slots, {rows:.0f} rows on average); the "
        f"server's peak {peak:.2f} GiB")
    top = sorted(busy["by_name"].items(), key=lambda kv_: -kv_[1])[:6]
    log(f"[k] {dev_tag}: {busy_steps} decode steps of 8 slots (8 engine steps of a horizon of "
        f"{S_HORIZON}, until the requests end) at lengths from 256: device busy "
        f"{busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall, device "
        f"{busy['device_ms']:.3f} ms ({busy['device_ms'] / busy_steps:.3f} a step); device ms by "
        f"kernel { {k[:90]: round(v, 3) for k, v in top} }")
    if not all(same):
        raise AssertionError(f"[k] the server's ids differ from the in-process engine's in "
                             f"{len(same) - sum(same)} of {len(same)} requests")

    # Generator on the served tree: "partial" (the launch window), then "full"
    model = HQQModel(params, cfg, "deepseek_v3", quantized=True)
    prompts4 = _prompts(cfg)
    partial = dict(compile_mode="partial")
    ops.reset_launch_counts()
    model.generate(prompts4, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    per_prefill = launch_counts()
    t0 = time.time()
    model.generate(prompts4, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    before = launch_counts()
    t0 = time.time()
    ids = model.generate(prompts4, max_new_tokens=R_GEN_NEW, **partial)
    torch.cuda.synchronize()
    partial_tok_s = 4 * (R_GEN_NEW - 1) / (time.time() - t0 - prefill_s)
    gen_window = launch_counts()
    got = {k: (gen_window[k] - before[k] - per_prefill[k]) / (R_GEN_NEW - 1)
           for k in (*step, "paged_attention")}
    if got != dict(step, paged_attention=0):
        raise AssertionError(f"[k] a partial decode step launched {got}, expected {step}")
    full_ids = model.generate(prompts4, max_new_tokens=R_GEN_NEW)
    captures = model.generator().captures()
    t0 = time.time()
    model.generate(prompts4, max_new_tokens=R_GEN_NEW)
    torch.cuda.synchronize()
    full_tok_s = 4 * (R_GEN_NEW - 1) / (time.time() - t0 - prefill_s)
    full_busy = device_share(lambda: model.generate(prompts4, max_new_tokens=8))
    model.release_graphs()
    log(f"[k] {dev_tag}: Generator on the served tree, 4 prompts of 100 tokens, {R_GEN_NEW} new: "
        f"partial {partial_tok_s:.1f} tok/s, full {full_tok_s:.1f} tok/s (prefill "
        f"{prefill_s * 1e3:.1f} ms); ids full == partial: {np.array_equal(ids, full_ids)}; "
        f"graphs' recorded launches {[c['launches'] for c in captures.values()]}; an 8-token "
        f"full generate busy {full_busy['busy_share']:.3f} of {full_busy['wall_ms']:.1f} ms, "
        f"device ms {full_busy['device_ms']:.3f}")
    if not np.array_equal(ids, full_ids):
        raise AssertionError("[k] the graph's greedy ids differ from the eager loop's")
    for key, cap in captures.items():
        if cap["launches"] != step:
            raise AssertionError(f"[k] graph {key} recorded {cap['launches']}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return [launches, gen_window]


def _grouped_plain_chunked(x, qt, chunk: int = 32):
    """`grouped_matmul_plain` over ``chunk`` experts at a time: the same
    products (each expert's W dequantized to x's type, fp32 sums), without
    the whole stack's fp32 copy (15 GB at DeepSeek-V3's 256 x [2048, 7168])."""
    import dataclasses

    from hqq_tpu_torch.ops import fused_matmul as fm

    parts = []
    for s in range(0, x.shape[0], chunk):
        sub = dataclasses.replace(qt, wq=qt.wq[s:s + chunk], scale=qt.scale[s:s + chunk],
                                  zero=qt.zero[s:s + chunk])
        parts.append(fm.grouped_matmul_plain(x[s:s + chunk], sub))
    return torch.cat(parts)


def _k_v3_stack(gen, e: int, out_f: int, in_f: int, qc: dict):
    """A routed stack of ``e`` experts [out_f, in_f] drawn in bf16 and
    quantized 32 experts at a time (`quantize_grouped`, one expert at a
    time): at most 32 bf16 experts are held (a whole bf16 stack of
    DeepSeek-V3 is 7.5 GB)."""
    from hqq_tpu_torch.nn.moe import GroupedQuantLinear, quantize_grouped

    wqp = qc["weight_quant_params"]
    parts = []
    for s in range(0, e, 32):
        w = (torch.randn((min(32, e - s), out_f, in_f), generator=gen, device="cuda")
             / in_f**0.5).to(torch.bfloat16)
        parts.append(quantize_grouped(w, nbits=wqp["nbits"], group_size=wqp["group_size"],
                                      axis=wqp["axis"], round_zero=wqp["round_zero"]))
        del w
    p0 = parts[0]
    return GroupedQuantLinear(torch.cat([p.wq for p in parts]),
                              torch.cat([p.scale for p in parts]),
                              torch.cat([p.zero for p in parts]), nbits=p0.nbits,
                              group_size=p0.group_size, axis=p0.axis, shape=p0.shape,
                              packing=p0.packing, compute_dtype=p0.compute_dtype)


def _k_routes(module, fn):
    """Run ``fn`` with `deepseek3._router` recording each call's expert
    sets (sorted), its inputs and its router; returns (fn's result, the
    (sets, x2, mlp) of each call in call order)."""
    from unittest import mock

    inner, calls = module._router, []

    def rec(mlp, cfg, x2):
        idx, w = inner(mlp, cfg, x2)
        calls.append((idx.sort(-1).values, x2.detach().clone(), mlp))
        return idx, w

    with mock.patch.object(module, "_router", rec):
        return fn(), calls


def _k_margins(mlp, cfg, x2):
    """The router's scores of rows x2 (sigmoid plus bias, fp32) and the
    margins of its two choices: the k-th minus the (k+1)-th masked score,
    and the topk_group-th minus the next group score (inf for one group)."""
    scores = torch.sigmoid(x2.float() @ mlp["gate_weight"].float().t())
    choice = scores + mlp["e_score_correction_bias"].float()[None, :]
    ng, tg, k = cfg.n_group, cfg.topk_group, cfg.num_experts_per_tok
    groups = choice.reshape(-1, ng, choice.shape[-1] // ng).topk(2, -1).values.sum(-1)
    gv, gidx = groups.sort(-1, descending=True)
    g_margin = (gv[:, tg - 1] - gv[:, tg]) if tg < ng else torch.full_like(gv[:, 0], float("inf"))
    keep = torch.zeros_like(groups).scatter_(1, gidx[:, :tg], 1.0).repeat_interleave(
        choice.shape[-1] // ng, -1)
    ev = torch.where(keep > 0, choice, 0.0).sort(-1, descending=True).values
    return choice, ev[:, k - 1] - ev[:, k], g_margin


def _k_v3_logits(params, cfg, toks, w4a8=None, plain: bool = False):
    """The logits of a prefill of K_V3_PROMPT tokens and 4 decode steps over
    the MLA cache, and the expert sets of every MoE call: through the
    kernels, or with every wrapper replaced by its plain twin (``w4a8``: the
    w4a8 one, a control where given)."""
    from unittest import mock

    from hqq_tpu_torch.models import deepseek3
    from hqq_tpu_torch.models.llama import cache_for
    from hqq_tpu_torch.nn import moe
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.ops import norm as nm

    t = K_V3_PROMPT

    def run():
        cache = cache_for(cfg)(cfg, toks.shape[0], 64, torch.bfloat16, "cuda")
        out = [deepseek3.forward(params, cfg, toks[:, :t], cache, 0)[0]]
        for i in range(toks.shape[1] - t):
            out.append(deepseek3.forward(params, cfg, toks[:, t + i:t + i + 1], cache, t + i)[0])
        return torch.cat(out, dim=1)

    with contextlib.ExitStack() as stack, torch.inference_mode():
        if plain:
            for mod, name, twin in ((fm, "w4a8_matmul", w4a8 or fm.w4a8_matmul_plain),
                                    (nm, "rms_norm", nm.rms_norm_plain),
                                    (moe, "grouped_matmul", _grouped_plain_chunked)):
                stack.enter_context(mock.patch.object(mod, name, twin))
        return _k_routes(deepseek3, run)


def _k_v3_against_plain(params, cfg, toks) -> dict:
    """`_k_v3_logits` through the kernels against the plain path: the
    (token, layer) expert sets that differ, counted, and the logits of the
    other tokens within K_V3_LOGIT_BAR of max|logit|; control: the plain
    path with each w4a8 group reading its neighbour's scale must miss the
    bar."""
    import dataclasses

    from hqq_tpu_torch.ops import fused_matmul as fm

    def bad_scale(x8, sx, kqt, dt):
        return fm.w4a8_matmul_plain(x8, sx, dataclasses.replace(kqt, scale=kqt.scale.roll(1, 1)),
                                    dt)

    b, t = toks.shape[0], K_V3_PROMPT
    got, calls_k = _k_v3_logits(params, cfg, toks)
    want, calls_p = _k_v3_logits(params, cfg, toks, plain=True)
    control, _ = _k_v3_logits(params, cfg, toks, w4a8=bad_scale, plain=True)
    # the calls come a forward at a time, one a MoE layer: the prefill's
    # rows are (slot, position) of the prompt, a step's one row a slot
    moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    flipped = torch.zeros((b, toks.shape[1]), dtype=torch.bool, device="cuda")
    decisions, flips, far, worst = 0, 0, 0, 0.0
    for n, ((a, xk, mlp), (c, xp, _)) in enumerate(zip(calls_k, calls_p)):
        differ = (a != c).any(-1)
        decisions += differ.numel()
        flips += int(differ.sum())
        if differ.any():
            choice_k = _k_margins(mlp, cfg, xk[differ])[0]
            choice_p, e_margin, g_margin = _k_margins(mlp, cfg, xp[differ])
            d = (choice_k - choice_p).abs().amax(-1)
            near = (e_margin <= 2 * d) | (g_margin <= 4 * d)
            far += int((~near).sum())
            worst = max(worst, torch.minimum(e_margin / d, g_margin / (2 * d)).max().item())
        fwd = n // moe_layers
        if fwd == 0:
            flipped[:, :t] |= differ.reshape(b, t)
        else:
            flipped[:, t + fwd - 1] |= differ
    keep = ~flipped

    def err(x):
        return ((x - want).abs()[keep].max() / want.abs()[keep].max()).item()

    out = dict(logits=err(got), control=err(control), tokens_left_out=int(flipped.sum()),
               of_tokens=flipped.numel(), expert_sets_differ=flips, of_decisions=decisions,
               not_near_ties=far, largest_margin_over_move=worst,
               finite=bool(torch.isfinite(got).all()))
    if not (out["finite"] and out["logits"] <= K_V3_LOGIT_BAR < out["control"]
            and flips <= K_V3_FLIPS_ALLOWED * decisions and far == 0):
        raise AssertionError(f"[k v3] logits against the plain path: {out} (bar "
                             f"{K_V3_LOGIT_BAR}; at most {K_V3_FLIPS_ALLOWED:.0%} of the expert "
                             f"sets may differ, each a near-tie)")
    return out


def _k_router_check(params, cfg, x2) -> dict:
    """The router on the card (fp32, TF32 off) against its twin on the CPU
    (fp32, where no product runs in TF32) on the path's own x2: the expert
    sets equal but at near-ties, the weights within K_ROUTER_BAR; control:
    the logits product in TF32 (~2^-11 of each logit) must miss the bar."""
    from hqq_tpu_torch.models import deepseek3

    mlp = next(layer["mlp"] for layer in params["layers"] if "experts" in layer["mlp"])
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("[k v3] TF32 is allowed in torch.matmul: the router would not be fp32")
    cpu = {k: mlp[k].cpu() for k in ("gate_weight", "e_score_correction_bias")}
    ridx, rw = deepseek3._router(cpu, cfg, x2.cpu())

    def against(idx, w):
        same = (idx.cpu() == ridx).all(-1)  # the same experts in the same k order
        err = (w.cpu() - rw).abs()[same].max().item() if same.any() else float("inf")
        return int(same.sum()), err

    n_same, err = against(*deepseek3._router(mlp, cfg, x2))
    with tf32_allowed():
        _, control = against(*deepseek3._router(mlp, cfg, x2))
    out = dict(tokens=int(x2.shape[0]), sets_equal=n_same, weights_err=err,
               tf32_control=control)
    if not (err <= K_ROUTER_BAR < control and n_same >= 0.9 * x2.shape[0]):
        raise AssertionError(f"[k v3] the router against its CPU twin: {out} (bar {K_ROUTER_BAR})")
    return out


def _k_deepseek_v3(dev_tag: str) -> list:
    """DeepSeek-V3 at its published width (`K_V3_*`), 5 layers: random bf16
    weights from seed 1 drawn and quantized a layer at a time (the routed
    experts 32 at a time, `_k_v3_stack`), w4a8, fused; the kernel calls of a
    prefill (4 prompts of 8 tokens: 32 rows an expert) and 4 decode steps
    held to their plain twins on the path's own inputs (w4a8 at the MLA's
    shapes, rms_norm at 1536, 512 and 7168, grouped_matmul at both stacks'
    shapes, quant_matmul never called: no projection sees more than 32
    rows); the router against fp64; the logits against the plain path;
    then `Generator` "full" and "partial". Returns the partial generate's
    launch window."""
    import dataclasses

    import numpy as np

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models import deepseek3
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.models.llama import LlamaConfig
    from hqq_tpu_torch.nn import moe
    from hqq_tpu_torch.utils.patching import fuse_for_decode, prepare_for_inference

    tag = "k v3"
    cfg = deepseek3.DeepseekV3Config(
        num_hidden_layers=K_V3_LAYERS, max_position_embeddings=163840,
        rope_scaling=LlamaConfig._canon_rope_scaling(K_V3_YARN))
    qc = BaseQuantizeConfig(nbits=4, group_size=64)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.time()
    params = deepseek3.init_params(dataclasses.replace(cfg, num_hidden_layers=0), gen,
                                   torch.bfloat16, "cuda")
    for i in range(cfg.num_hidden_layers):
        layer = deepseek3.init_layer(
            cfg, i, gen, torch.bfloat16, "cuda",
            experts=lambda o, i_: _k_v3_stack(gen, cfg.n_routed_experts, o, i_, qc))
        quantize_model({"layers": [layer]}, qc)
        params["layers"].append(layer)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    del layer
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    params = fuse_for_decode(prepare_for_inference(params, "w4a8"))
    gc.collect()
    torch.cuda.empty_cache()
    _k_check_tree(tag, params, cfg)
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"[{tag}] {dev_tag} DeepSeek-V3 at published width, {K_V3_LAYERS} of 61 layers "
        f"({cfg.first_k_dense_replace} dense, {K_V3_LAYERS - cfg.first_k_dense_replace} MoE of "
        f"{cfg.n_routed_experts} experts): drawn and quantized (4-bit g64, the routed experts 32 "
        f"at a time) in {build_s:.1f} s, peak {build_peak:.2f} GiB; w4a8, fused: {resident:.2f} "
        f"GiB resident; attn_scale_ {cfg.attn_scale_:.6f} (qk_head_dim^-0.5 times mscale^2)")

    toks = torch.randint(0, cfg.vocab_size, (K_V3_BATCH, K_V3_PROMPT + 4), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))

    def grouped_bad(name):
        return lambda x, qt: _grouped_plain_chunked(x, _grouped_controls(qt)[name])

    extra = [(moe, "grouped_matmul", _grouped_plain_chunked,
              {c: grouped_bad(c) for c in ("neighbour's scale", "expert e+1's codes")}, 2.0**-7)]
    calls = _r_calls(tag, deepseek3.forward, params, cfg, toks, K_V3_PROMPT, 4, extra=extra,
                     absent=("quant_matmul",))
    widths = set(calls["rms_norm"]["worst_by_k"])
    want_widths = {cfg.q_lora_rank, cfg.kv_lora_rank, cfg.hidden_size}
    shapes = set(calls["grouped_matmul"]["worst_by_k"])
    want_shapes = {(c, n, k) for c in (K_V3_BATCH * K_V3_PROMPT, K_V3_BATCH)
                   for n, k in ((cfg.moe_intermediate_size, cfg.hidden_size),
                                (cfg.hidden_size, cfg.moe_intermediate_size))}
    log(f"[{tag}] a prefill (M = {K_V3_BATCH * K_V3_PROMPT}) and 4 decode steps, every call "
        f"against its plain twin on the path's inputs (calls, worst, controls at the least; by K, "
        f"width or (C, N, K)): {calls}")
    if widths != want_widths or shapes != want_shapes:
        raise AssertionError(f"[{tag}] norms at widths {widths} (expected {want_widths}), stacks "
                             f"at {shapes} (expected {want_shapes})")

    # the router on the path's own input: the first MoE layer's x2 of a prefill
    with torch.inference_mode():
        _, calls = _k_routes(deepseek3, lambda: deepseek3.forward(params, cfg,
                                                                  toks[:, :K_V3_PROMPT]))
    router = _k_router_check(params, cfg, calls[0][1])
    del calls
    against = _k_v3_against_plain(params, cfg, toks)
    copies = _k_broadcast_ms([(cfg.n_routed_experts, K_V3_BATCH, cfg.hidden_size),
                              (cfg.n_routed_experts, K_V3_BATCH * K_V3_PROMPT, cfg.hidden_size),
                              (K_MOONLIGHT["n_routed_experts"], G_SLOTS,
                               K_MOONLIGHT["hidden_size"])])
    log(f"[{tag}] the router of layer {cfg.first_k_dense_replace} on the path's prefill rows "
        f"against its fp32 twin on the CPU: {router} (bar {K_ROUTER_BAR}; TF32 off); logits of the prefill and 4 "
        f"decode steps against the plain path: {against} (bar {K_V3_LOGIT_BAR} of max|logit|, "
        f"control past it; at most {K_V3_FLIPS_ALLOWED:.0%} of the expert sets may differ, each "
        f"a near-tie: margin within 2 d, or the groups' within 4 d); "
        f"x broadcast to [E, T, D] and made contiguous once a MoE layer, device ms: {copies}")

    # Generator: "partial" (the launch window), then "full"
    model = HQQModel(params, cfg, "deepseek_v3", quantized=True)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (K_V3_BATCH, K_V3_PROMPT))
    per = _k_counts(cfg)
    step = {"w4a8_matmul": per["linears"], "grouped_matmul": per["stacks"],
            "rms_norm": per["norms"]}
    partial = dict(compile_mode="partial")
    ops.reset_launch_counts()
    model.generate(prompts, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    per_prefill = launch_counts()
    if {k: per_prefill[k] for k in (*step, "quant_matmul", "dequant_canonical")} != dict(
            step, quant_matmul=0, dequant_canonical=0):
        raise AssertionError(f"[{tag}] a prefill of {K_V3_BATCH} x {K_V3_PROMPT} launched "
                             f"{per_prefill}, expected {step} and no quant_matmul or stacked "
                             f"dequant (32 rows: the grouped kernel)")
    t0 = time.time()
    model.generate(prompts, max_new_tokens=1, **partial)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    before = launch_counts()
    t0 = time.time()
    ids = model.generate(prompts, max_new_tokens=K_V3_NEW, **partial)
    torch.cuda.synchronize()
    partial_tok_s = K_V3_BATCH * (K_V3_NEW - 1) / (time.time() - t0 - prefill_s)
    gen_window = launch_counts()
    got = {k: (gen_window[k] - before[k] - per_prefill[k]) / (K_V3_NEW - 1) for k in step}
    if got != step:
        raise AssertionError(f"[{tag}] a partial decode step launched {got}, expected {step}")
    full_ids = model.generate(prompts, max_new_tokens=K_V3_NEW)
    captures = model.generator().captures()
    t0 = time.time()
    model.generate(prompts, max_new_tokens=K_V3_NEW)
    torch.cuda.synchronize()
    full_tok_s = K_V3_BATCH * (K_V3_NEW - 1) / (time.time() - t0 - prefill_s)
    full_busy = device_share(lambda: model.generate(prompts, max_new_tokens=K_V3_NEW))
    model.release_graphs()
    stacks = sum(t.numel() * t.element_size() for layer in params["layers"]
                 if "experts" in layer["mlp"] for g in layer["mlp"]["experts"].values()
                 for t in (g.wq, g.scale, g.zero))
    weights = _step_weight_bytes(params)
    log(f"[{tag}] {dev_tag}: Generator, {K_V3_BATCH} prompts of {K_V3_PROMPT} tokens, {K_V3_NEW} "
        f"new: partial {partial_tok_s:.1f} tok/s, full {full_tok_s:.1f} tok/s (prefill "
        f"{prefill_s * 1e3:.1f} ms); ids full == partial: {np.array_equal(ids, full_ids)}; a "
        f"decode step {step}; graphs' recorded launches "
        f"{[c['launches'] for c in captures.values()]}; an {K_V3_NEW}-token full generate busy "
        f"{full_busy['busy_share']:.3f} of {full_busy['wall_ms']:.1f} ms, device ms "
        f"{full_busy['device_ms']:.3f}; a step's byte bound {weights / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms ({weights / 1e9:.3f} GB, {stacks / 1e9:.3f} GB of it the routed stacks); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.array_equal(ids, full_ids):
        raise AssertionError(f"[{tag}] the graph's greedy ids differ from the eager loop's")
    for key, cap in captures.items():
        if cap["launches"] != step:
            raise AssertionError(f"[{tag}] graph {key} recorded {cap['launches']}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return [gen_window]


def phase_k(dev_tag: str) -> list:
    """Path K, DeepSeek-V3: `_k_moonlight` (Moonlight-16B-A3B through the
    server), then `_k_deepseek_v3` (DeepSeek-V3's width, 5 layers,
    through Generator). Returns their launch windows."""
    t0 = time.time()
    windows = _k_moonlight(dev_tag)
    t1 = time.time()
    windows += _k_deepseek_v3(dev_tag)
    log(f"[k] phase k: {time.time() - t0:.1f} s (Moonlight {t1 - t0:.1f} s, DeepSeek-V3 "
        f"{time.time() - t1:.1f} s)")
    return windows


# ---------------------------------------------------------------------------
# path P: vision-language serving
# ---------------------------------------------------------------------------

# llava-hf/llava-1.5-7b-hf (from memory): Llama-2-7B's text model with the
# vocabulary grown to 32064, image_token_index 32000; the CLIP ViT-L/14-336
# tower (hidden 1024, 24 layers, 16 heads, ffn 4096, image 336, patch 14,
# quick_gelu: `llava.ClipVisionConfig`'s defaults), the projector 1024 ->
# 4096 -> 4096, vision_feature_layer -2 (23 of 24 layers run), CLS dropped
P_LLAVA_VOCAB = 32064
# P's requests: 8 with one image, 4 text-only (at 2, 5, 8 and 11: the odd
# ones, streamed, hold both kinds), 32 new tokens each
P_TEXT_ONLY_AT, P_NEW = (2, 5, 8, 11), 32
# Qwen/Qwen2-VL-7B-Instruct (from memory): text hidden 3584, 28 layers,
# 28/4 heads, ffn 18944, vocab 152064, rope theta 1e6, q/k/v bias, RMSNorm
# eps 1e-6, an untied head, mrope_section (16, 24, 24); the tower is
# `qwen2_vl.VisionConfig`'s defaults (depth 32, embed 1280, 16 heads, mlp
# ratio 4, patch 14, temporal 2, merge 2, into 3584)
P_QWEN_TEXT = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                   num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
                   max_position_embeddings=32768, rms_norm_eps=1e-6, rope_theta=1e6,
                   attention_bias=True)
P_QWEN_VISION_END = 151653
# the text depths the script runs: LLaVA-1.5-7B's 8 of 32 and Qwen2-VL-7B's 6
# of 28 (cut for the script's time when path U came in); the towers
# run at full depth
P_LLAVA_LAYERS, P_QWEN_LAYERS = 8, 6
# one 448 x 448 image: 32 x 32 patches of 14, 1024 rows, 256 merged tokens
P_QWEN_GRID = ((1, 32, 32),)
P_QWEN_NEW = 16
# the towers' matmuls (M, K, N) on engine/vl's "pallas" route: CLIP's
# q/k/v/o, fc1 and fc2 at 577 rows; Qwen2-VL's attn_qkv, attn_proj, fc1
# and fc2 at 1024 (K = 1280: 20 groups of 64)
P_TOWER_SHAPES = [(577, 1024, 1024), (577, 1024, 4096), (577, 4096, 1024),
                  (1024, 1280, 3840), (1024, 1280, 1280), (1024, 1280, 5120),
                  (1024, 5120, 1280)]
P_LN_ROWS = [(577, 1024), (1024, 1280)]
P_LLAVA_LINEARS = {"qkv_proj": "self_attn", "o_proj": "self_attn", "gate_up_proj": "mlp",
                   "down_proj": "mlp"}
P_QWEN_LINEARS = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
                  "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp",
                  "down_proj": "mlp"}
# the first decode step's logits through the M-RoPE serving forward against
# Generate's route at one row: the same kernels on the same inputs (bar),
# and the control (offset 0, plain RoPE from the cache length) past 10x it
P_MROPE_BAR = 1e-3


def phase_b_p(record, iters: int) -> None:
    """Path P's new shapes: layer_norm over a CLIP image's 577 rows of 1024
    and a Qwen2-VL image's 1024 of 1280, and quant_matmul (row 1) at the
    towers' matmuls on the "pallas" route, each beside torch.matmul."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    for rows, d in P_LN_ROWS:
        _ln_row(record, gen, rows, d, iters, 1e-6 if d == 1280 else 1e-5)
    for m, k, n in P_TOWER_SHAPES:
        row = _qmm_row(record, gen, m, k, n, iters, note="a vision tower's matmul")
        log(f"[b] quant_matmul M={m} K={k} N={n}, a vision tower's: {row['ms']:.4f} ms, "
            f"{row['ms'] / row['library_ms']:.2f}x torch.matmul ({row['library_ms']:.4f} ms on "
            f"the dequantized bf16 W), {row['bound_ms'] / row['ms']:.2f} of its bound")


def _p_requests(cfg, rng):
    """P's 12 prompts and their images: an image request is BOS, 4-16 text
    tokens, the 576 placeholders, then text up to 16-64 tokens in all, its
    pixels [1, 3, 336, 336] multiples of 2^-8 in [-2, 2) (short in JSON);
    a text-only request 40-64 tokens (a prefill of 64 rows, past w4a8's
    32). Every text id lies below the placeholder's."""
    import numpy as np

    vc = cfg.vision
    prompts, pixels = [], []
    for i in range(12):
        if i in P_TEXT_ONLY_AT:
            prompts.append([1] + rng.integers(2, cfg.image_token_index, int(rng.integers(39, 64)))
                           .tolist())
            pixels.append(None)
            continue
        n = int(rng.integers(16, 65))
        a = int(rng.integers(4, 17))
        prompts.append([1] + rng.integers(2, cfg.image_token_index, a).tolist()
                       + [cfg.image_token_index] * vc.num_patches
                       + rng.integers(2, cfg.image_token_index, n - a).tolist())
        pixels.append((rng.integers(-512, 512, (1, vc.num_channels, vc.image_size,
                                               vc.image_size)) / 256).astype(np.float32))
    return prompts, pixels


def _p_qmm_checks(tag: str, layers: dict, captured: dict, tol: float = 2.0**-7) -> float:
    """quant_matmul (row 1; for fp32 x its fp32 route, qmm_fp32) on the
    path's own inputs (``captured``: key -> x's; ``layers``: key -> the
    kernel-layout module): within ``tol`` (2^-7) of its twin, each control
    (`_w4a8_controls`) past it. Returns the largest relative error."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    worst = 0.0
    for key, xs in sorted(captured.items()):
        kqt = layers[key].kqt
        x = xs[0].reshape(-1, kqt.k)
        ref = fm.quant_matmul_plain(x, kqt)
        err = rel(fm.quant_matmul(x, kqt), ref)
        controls = {c: rel(fm.quant_matmul_plain(x, bad), ref)
                    for c, bad in _w4a8_controls(kqt).items()}
        if not err <= tol or not all(v > tol for v in controls.values()):
            raise AssertionError(f"[{tag}] {key} (M={x.shape[0]} K={kqt.k} N={kqt.n}): "
                                 f"quant_matmul rel err {err:.3e}, controls {controls}")
        worst = max(worst, err)
    return worst


def _p_norm_patches(norm_log: dict, ln_log: dict):
    """Both norm wrappers held on the spot to their twins (mock patches of
    `ops.norm`), with a control each: the offset toggled, mu left out (the
    towers' random LayerNorm biases are zero: dropping them changes
    nothing)."""
    from unittest import mock

    from hqq_tpu_torch.ops import norm as nm

    return (mock.patch.object(nm, "rms_norm", checked(nm.rms_norm, nm.rms_norm_plain,
                                                      {"offset toggled": _offset_toggled},
                                                      norm_log)),
            mock.patch.object(nm, "layer_norm", checked(nm.layer_norm, nm.layer_norm_plain,
                                                        {"mu left out": _ln_no_mean}, ln_log)))


def _p_bit_equal(tag: str, what: str, found: dict) -> str:
    """A norm's calls must be bit-equal to their twin, and each control
    must part from it."""
    worst = max(found["kernel"])
    least = {c: min(v) for c, v in found.items() if c != "kernel"}
    if worst != 0.0 or not all(v > 0 for v in least.values()):
        raise AssertionError(f"[{tag}] {what}: {len(found['kernel'])} calls, largest rel err "
                             f"{worst} (must be 0), controls {least}")
    return f"{what} {len(found['kernel'])} calls bit-equal, controls at the least {least}"


def _p_llava(dev_tag: str) -> list:
    """LLaVA-1.5-7B at full width, P_LLAVA_LAYERS of 32 + 24 layers: random bf16
    weights from seed 0, `HQQVLModel.quantize_model` (4-bit g64; the patch
    projection and the projector stay bf16), save_quantized; `serve.main`
    on the checkpoint with its defaults (paged, w4a8, fused; the tower
    unprepared); P's 12 requests from 12 client threads. Returns the
    server's launch window."""
    import dataclasses
    import shutil
    import tempfile

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.vl import HQQVLModel
    from hqq_tpu_torch.models import llava
    from hqq_tpu_torch.models.llama import LlamaConfig
    from hqq_tpu_torch.serve import main as serve_main

    cfg = llava.LlavaConfig(text=dataclasses.replace(LlamaConfig.llama2_7b(),
                                                     vocab_size=P_LLAVA_VOCAB,
                                                     num_hidden_layers=P_LLAVA_LAYERS))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = llava.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    model = HQQVLModel({"text": params.pop("text"), "vision": params}, cfg, "llava")
    del params
    t0 = time.time()
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    root = tempfile.mkdtemp(prefix="hqq-llava-")
    try:
        t0 = time.time()
        model.save_quantized(root)
        save_s = time.time() - t0
        gb = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e9
        del model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[p] {dev_tag} LLaVA-1.5-7B ({cfg.text.num_hidden_layers} text layers, "
            f"{cfg.vision.num_hidden_layers} CLIP layers of which {cfg.tower_layers} run): init "
            f"{init_s:.1f} s, quantize_model (4-bit g64, both towers; patch_proj and the "
            f"projector bf16) {quant_s:.2f} s, save_quantized {gb:.3f} GB in {save_s:.2f} s, peak "
            f"{build_peak:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srv = serve_main(["--model", root, "--port", "0"], serve=False).start()
        return _p_served(dev_tag, cfg, srv, time.time() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _p_served(dev_tag: str, cfg, srv, boot_s: float) -> list:
    """The rest of `_p_llava`, on the started server: the window and its
    launches (a decode step, a prefill, an image), the in-process engine on
    the embedder's rows, the tower's ms an image on both routes, every
    kernel call of an image request and a text request held to its twin,
    the prefix cache's two images, a steady window's busy share."""
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.core.quantize import dequantize_plain
    from hqq_tpu_torch.models import llava
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.ops import paged as pa
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    eng, embedder = srv.engine, srv.embedder
    text, vt = eng.params, embedder.vision_tree
    layers, tower = cfg.text.num_hidden_layers, cfg.tower_layers
    prompts, pixels = _p_requests(cfg, np.random.default_rng(0))
    extras = [None if px is None else {"pixel_values": px.tolist()} for px in pixels]
    n_img = sum(px is not None for px in pixels)
    steps, decode = [], eng._decode

    def counted(h):
        steps.append(h)
        return decode(h)

    eng._decode = counted
    try:
        if not isinstance(eng, PagedBatchingEngine) or eng.s != G_SLOTS:
            raise AssertionError(f"[p] the server runs {type(eng).__name__} of {eng.s} slots, not "
                                 f"the paged engine of {G_SLOTS}")
        t_warm = time.time()
        _s_request(srv.port, prompts[0], 4, False, t_warm, extra=extras[0])
        _s_request(srv.port, prompts[P_TEXT_ONLY_AT[0]], 4, False, t_warm)
        warm_s = time.time() - t_warm
        # the main path's window: every count from 0, read right after
        ops.reset_launch_counts()
        steps.clear()
        results, window_s = _s_window(srv.port, prompts, P_NEW, extras)
        launches = launch_counts()
        n_steps = sum(steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
    del srv
    step = {"w4a8_matmul": 4 * layers, "rms_norm": 2 * layers + 1, "paged_attention": layers}
    prefill = {"quant_matmul": 4 * layers, "rms_norm": 2 * layers + 1}
    image = {"dequant_canonical": 6 * tower, "layer_norm": 2 * tower + 1}
    names = {*step, *prefill, *image}
    expect = {k: step.get(k, 0) * n_steps + prefill.get(k, 0) * len(prompts)
              + image.get(k, 0) * n_img for k in names}
    log(f"[p] launches in the server's window ({n_steps} decode steps, {len(prompts)} prefills, "
        f"{n_img} images): { {k: v for k, v in launches.items() if v} }; a decode step: {step}; "
        f"a prefill (M = 64 or 1024 rows): {prefill}; an image through the unprepared tower: "
        f"{image}")
    for name in set(launches) | names:
        if launches.get(name, 0) != expect.get(name, 0):
            raise AssertionError(f"[p] {launches.get(name, 0)} {name} launches in the window, "
                                 f"expected {expect.get(name, 0)}")

    # the same requests in-process, on the embedder's rows, decode timed
    def engine(**kw):
        return PagedBatchingEngine(text, cfg.text, batch_slots=G_SLOTS, num_pages=512,
                                   page_size=PAGE, max_pages_per_seq=MAX_PAGES,
                                   horizon=S_HORIZON, **kw)

    embeds = [None if px is None else embedder(p, {"pixel_values": px})
              for p, px in zip(prompts, pixels)]
    ref = engine()
    recs, ref_decode = [], ref._decode

    def timed(h):
        live = len(ref.active)
        torch.cuda.synchronize()
        t0 = time.time()
        out = ref_decode(h)  # ends in a read-back of the tokens
        recs.append(dict(steps=h, live=live, ms=(time.time() - t0) * 1e3,
                         rows=float(np.mean(ref._pos))))
        return out

    ref._decode = timed
    torch.cuda.synchronize()
    t0 = time.time()
    uids = [ref.add_request(p, max_new_tokens=P_NEW, inputs_embeds=e)
            for p, e in zip(prompts, embeds)]
    ref_out = ref.run()
    torch.cuda.synchronize()
    inproc_s = time.time() - t0
    same = [r["tokens"] == ref_out[u] for r, u in zip(results, uids)]
    decode_s = sum(r["ms"] for r in recs) / 1e3
    dec_steps = sum(r["steps"] for r in recs)
    tokens = sum(r["live"] * r["steps"] for r in recs)
    rows = sum(r["rows"] * r["steps"] for r in recs) / dec_steps
    # the device's share of a steady window: 8 image requests, 4 engine steps
    for p, e in [(p, e) for p, e in zip(prompts, embeds) if e is not None][:G_SLOTS]:
        ref.add_request(p, max_new_tokens=P_NEW, inputs_embeds=e)
    ref.step()
    n0 = len(recs)
    busy = device_share(lambda: [ref.step() for _ in range(4)])
    busy_steps = sum(r["steps"] for r in recs[n0:])
    ref.close()
    del ref
    kv = G_SLOTS * rows * layers * 2 * cfg.text.num_key_value_heads * cfg.text.head_dim_ * 2
    weights = _step_weight_bytes(text)
    bound = (weights + kv) / HBM_BYTES_PER_S * 1e3
    all_tokens = sum(len(r["tokens"]) for r in results)
    first = sorted(r["first_s"] for r in results if r["chunks"] is not None)
    log(f"[p] {dev_tag}: serve.main (defaults: paged, w4a8, fused, {G_SLOTS} slots, 512 pages "
        f"of {PAGE}, horizon {S_HORIZON}) to a started server {boot_s:.2f} s, warm-up "
        f"{warm_s:.2f} s; 12 requests ({n_img} with an image: prompts "
        f"{[len(p) for p in prompts]}, {P_NEW} new, greedy) from 12 client threads, 6 streamed: "
        f"window {window_s:.3f} s, {all_tokens / window_s:.1f} tok/s at the client; time to "
        f"first token median {first[len(first) // 2]:.3f} s, max {first[-1]:.3f} s; in-process "
        f"{inproc_s:.3f} s, {all_tokens / inproc_s:.1f} tok/s, ids equal the server's in "
        f"{sum(same)} of {len(same)}; decode {tokens / decode_s:.1f} tok/s over all slots, "
        f"{decode_s / dec_steps * 1e3:.2f} ms a step against a byte bound of {bound:.3f} ms "
        f"({weights / 1e9:.3f} GB of codes, meta and the bf16 head + {kv / 1e9:.3f} GB of K/V, "
        f"{rows:.0f} rows on average); the server's peak {peak:.2f} GiB")
    top = sorted(busy["by_name"].items(), key=lambda kv_: -kv_[1])[:6]
    log(f"[p] {dev_tag}: {busy_steps} decode steps of 8 image requests (4 engine steps): device "
        f"busy {busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall, device "
        f"{busy['device_ms']:.3f} ms ({busy['device_ms'] / max(busy_steps, 1):.3f} a step); by "
        f"kernel { {k[:90]: round(v, 3) for k, v in top} }")
    if not all(same):
        raise AssertionError(f"[p] the server's ids differ from the in-process engine's in "
                             f"{len(same) - sum(same)} of {len(same)} requests")

    # the tower an image on both routes: as served (each W dequantized by
    # the canonical kernel, then F.linear) and engine/vl's "pallas" (row 1)
    px = torch.as_tensor(pixels[0], device="cuda")
    pallas = prepare_for_inference(containers(vt), "pallas")
    routes = {}
    with torch.inference_mode():
        for route, tree in (("unprepared", vt), ("pallas", pallas)):
            y = llava.vision_forward(tree, cfg, px)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            llava.vision_forward(tree, cfg, px)
            counts = {k: v for k, v in launch_counts().items() if v}
            t0 = time.time()
            for _ in range(5):
                llava.vision_forward(tree, cfg, px)
            torch.cuda.synchronize()
            host = (time.time() - t0) / 5 * 1e3
            dev = time_ms([lambda t=tree: llava.vision_forward(t, cfg, px)], 5)
            routes[route] = dict(y=y, counts=counts, host_ms=host, device_ms=dev)
    agree = rel(routes["pallas"]["y"], routes["unprepared"]["y"])
    want = {"unprepared": image, "pallas": {"quant_matmul": 6 * tower,
                                            "layer_norm": 2 * tower + 1}}
    log(f"[p] {dev_tag}: the CLIP tower and projector an image (577 rows): "
        + "; ".join(f"{r}: {v['host_ms']:.2f} ms host, {v['device_ms']:.3f} ms device, launches "
                    f"{v['counts']}" for r, v in routes.items())
        + f"; the image rows of the two routes part by {agree:.3e} of max|y| (bf16 roundings "
          f"in other places over {tower} layers)")
    for route, v in routes.items():
        if v["counts"] != want[route]:
            raise AssertionError(f"[p] the {route} tower launched {v['counts']}, expected "
                                 f"{want[route]}")
    if not agree < 0.1:
        raise AssertionError(f"[p] the pallas tower's rows part from the served ones by {agree}")
    del routes

    # every kernel call of an image request and a text request (3 new
    # tokens, 2 of 8 slots live) held to its twin on the path's own inputs
    lin_x, vis_x, hooks = {}, {}, []
    for li in (0, layers - 1):
        for name, sub in P_LLAVA_LINEARS.items():
            def grab(mod, args, key=(li, name)):
                lin_x.setdefault(key, []).append(
                    args[0].detach().reshape(-1, args[0].shape[-1]).clone())
            hooks.append(text["layers"][li][sub][name].register_forward_pre_hook(grab))
    for li in (0, tower - 1):
        for name in ("q_proj", "fc1", "fc2"):
            def grab_v(mod, args, key=(li, name)):
                vis_x.setdefault(key, []).append(args[0].detach().clone())
            hooks.append(vt["vision"]["layers"][li][name].register_forward_pre_hook(grab_v))
    norm_log, ln_log, paged_log = {}, {}, {}
    chk = engine()
    rms_patch, ln_patch = _p_norm_patches(norm_log, ln_log)
    with rms_patch, ln_patch, mock.patch.object(
            pa, "paged_attention", checked(pa.paged_attention, _paged_plain, PAGED_CONTROLS,
                                           paged_log)):
        emb = embedder(prompts[0], {"pixel_values": pixels[0]})
        chk.add_request(prompts[0], max_new_tokens=3, inputs_embeds=emb)
        chk.add_request(prompts[P_TEXT_ONLY_AT[0]], max_new_tokens=3)
        chk.run()
    chk.close()
    for h in hooks:
        h.remove()
    by_k = _l_linear_checks(text, lin_x, P_LLAVA_LINEARS, "p")
    canon = []
    for (li, name), _ in sorted(vis_x.items()):
        qt = vt["vision"]["layers"][li][name].qweight
        w, ref_w = fm.dequant_canonical(qt), dequantize_plain(qt, qt.compute_dtype)
        if not torch.equal(w, ref_w) or torch.equal(_canonical_control(qt, qt.compute_dtype),
                                                    ref_w):
            raise AssertionError(f"[p] CLIP layer {li} {name}: the canonical dequant is not "
                                 f"bit-equal to its twin, or the control is")
        canon.append(f"{li}.{name}")
    tower_err = _p_qmm_checks("p", {k: pallas["vision"]["layers"][k[0]][k[1]] for k in vis_x},
                              vis_x)
    worst_paged = max(paged_log["kernel"])
    least_paged = {c: min(v) for c, v in paged_log.items() if c != "kernel"}
    log(f"[p] an image request and a text request on the path's own inputs: text linears of "
        f"layers 0 and {layers - 1}, largest rel err by (route, K) (bar 2^-7): "
        f"{ {f'{a} K={b}': round(v, 5) for (a, b), v in by_k.items()} }; the canonical dequant "
        f"of CLIP's {canon} bit-equal to its twin (control c*s - z*s parts); the same layers on "
        f"the pallas route, quant_matmul rel err up to {tower_err:.3e} (controls past 2^-7); "
        f"{len(paged_log['kernel'])} paged_attention calls, rel err up to {worst_paged:.3e} "
        f"(bar {TOL_PAGED_BF16_VS_FP32:.3e}), controls at the least {least_paged}; "
        f"{_p_bit_equal('p', 'rms_norm', norm_log)}; {_p_bit_equal('p', 'layer_norm', ln_log)}")
    if not worst_paged <= TOL_PAGED_BF16_VS_FP32 or not all(
            v > TOL_PAGED_BF16_VS_FP32 for v in least_paged.values()):
        raise AssertionError(f"[p] paged_attention: {worst_paged}, controls {least_paged}")

    # the prefix cache: two requests with the same ids and different images
    toks = prompts[0]
    emb_b = embedder(toks, {"pixel_values": pixels[1]})
    pc = engine(enable_prefix_cache=True)
    ua = pc.add_request(toks, max_new_tokens=P_NEW, inputs_embeds=embeds[0])
    ub = pc.add_request(toks, max_new_tokens=P_NEW, inputs_embeds=emb_b)
    pc_out = pc.run()
    hits = pc.prefix_cache_hits
    pc.close()
    alone = engine()
    u_b = alone.add_request(toks, max_new_tokens=P_NEW, inputs_embeds=emb_b)
    alone_b = alone.run()[u_b]
    alone.close()
    alone_a = ref_out[uids[0]]
    log(f"[p] prefix cache on, the same {len(toks)} ids with two images: ids each its own "
        f"({pc_out[ua] == alone_a}, {pc_out[ub] == alone_b}; the two differ: "
        f"{alone_a != alone_b}), prefix_cache_hits {hits}")
    if pc_out[ua] != alone_a or pc_out[ub] != alone_b or alone_a == alone_b or hits != 0:
        raise AssertionError("[p] the prefix cache aliased two images, or they did not part")
    del embeds, emb, emb_b, pallas, text, vt, embedder, eng
    gc.collect()
    torch.cuda.empty_cache()
    return [launches]


def _p_qwen2_vl(dev_tag: str) -> list:
    """Qwen2-VL-7B at full width, P_QWEN_LAYERS of 28 + 32 layers, random bf16
    weights from seed 0, 4-bit g64 both towers, prepared with "w4a8" (the
    tower on row 1): `HQQVLModel.generate` on one 448 x 448 image (its
    launch window), then the dense engine with ``mrope_offsets``: the image
    request's ids against generate's by the near-tie rule, a text request
    beside it, and the control (offset 0) that must fail the rule. Returns
    generate's launch window."""
    import numpy as np

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.engine.vl import HQQVLModel
    from hqq_tpu_torch.models import llama, qwen2_vl
    from hqq_tpu_torch.models.llama import LlamaConfig
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    cfg = qwen2_vl.Qwen2VLConfig(text=LlamaConfig(**dict(P_QWEN_TEXT,
                                                         num_hidden_layers=P_QWEN_LAYERS)),
                                 vision=qwen2_vl.VisionConfig())
    vc, layers = cfg.vision, cfg.text.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = qwen2_vl.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    model = HQQVLModel(params, cfg, "qwen2_vl")
    del params
    t0 = time.time()
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    model.prepare_for_inference("w4a8")
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    text = model.params["text"]
    rng = np.random.default_rng(1)
    n_img = sum(t * h * w for t, h, w in P_QWEN_GRID) // vc.spatial_merge_size**2
    toks = (rng.integers(0, 151643, 12).tolist() + [cfg.vision_start_token_id]
            + [cfg.image_token_id] * n_img + [P_QWEN_VISION_END]
            + rng.integers(0, 151643, 24).tolist())
    text_toks = rng.integers(0, 151643, 40).tolist()
    patches = torch.as_tensor(rng.standard_normal((n_img * 4, vc.patch_dim)),
                              dtype=torch.bfloat16, device="cuda")

    def generate(new):
        return model.generate(toks, pixel_values=patches, grid_thw=P_QWEN_GRID,
                              max_new_tokens=new)

    generate(2)  # warm-up
    ops.reset_launch_counts()
    ids = generate(P_QWEN_NEW)
    torch.cuda.synchronize()
    window = launch_counts()
    tower_n, decode_n = vc.depth, P_QWEN_NEW - 1
    expect = {"quant_matmul": 4 * tower_n + 7 * layers, "layer_norm": 2 * tower_n + 1,
              "w4a8_matmul": 7 * layers * decode_n, "rms_norm": (2 * layers + 1) * P_QWEN_NEW}
    got = {k: v for k, v in window.items() if v}
    log(f"[p] {dev_tag} Qwen2-VL-7B ({layers} text layers, {vc.depth} tower blocks): init "
        f"{init_s:.1f} s, quantize_model (4-bit g64; patch_embed and the merger bf16) and "
        f"prepare_for_inference('w4a8') {quant_s:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; generate of a {len(toks)}-token "
        f"prompt with one {P_QWEN_GRID} image ({vc.patch_dim}-wide patches, {n_img} merged "
        f"rows), {P_QWEN_NEW} new: launches {got} (expected {expect}: the tower's 4 a block on "
        f"quant_matmul, the prefill's 7 a layer at M = {len(toks)}, then w4a8 at M = 1)")
    if got != expect:
        raise AssertionError(f"[p] generate launched {got}, expected {expect}")
    times = {}
    for new in (1, P_QWEN_NEW):
        torch.cuda.synchronize()
        t0 = time.time()
        generate(new)
        torch.cuda.synchronize()
        times[new] = time.time() - t0
    tower_ms = time_ms([lambda: model.encode_images(patches, P_QWEN_GRID)], 5)

    emb, pos = model.embed(toks, patches, P_QWEN_GRID)
    mp = int(pos.max()) + 1
    pos_t = torch.from_numpy(pos).cuda()
    fwd, efwd = qwen2_vl.serving_forward_fns(cfg)

    def engine_ids(offset):
        eng = ContinuousBatchingEngine(text, cfg.text, batch_slots=2, max_len=1024,
                                       forward_fn=fwd, embeds_forward_fn=efwd,
                                       mrope_offsets=True)
        u = eng.add_request(toks, max_new_tokens=P_QWEN_NEW, inputs_embeds=emb[0],
                            position_ids=pos[:, 0], pos_offset=offset)
        ut = eng.add_request(text_toks, max_new_tokens=P_QWEN_NEW)
        out = eng.run()
        eng.close()
        return out[u], out[ut]

    def forced(got_ids):
        """generate's route (one row, the M-RoPE decode position mp + j)
        teacher-forced on ``got_ids``: (its greedy choices, its logits)."""
        cache = llama.init_cache(cfg.text, 1, 512, torch.bfloat16, "cuda")
        logits, cache = qwen2_vl.forward(text, cfg, None, cache, 0, position_ids=pos_t,
                                         inputs_embeds=emb)
        rows = [logits[0, -1]]
        for j, tok in enumerate(got_ids[:-1]):
            logits, cache = qwen2_vl.forward(
                text, cfg, torch.tensor([[tok]], device="cuda"), cache, len(toks) + j,
                position_ids=torch.full((3, 1, 1), mp + j, device="cuda"))
            rows.append(logits[0, -1])
        table = torch.stack(rows).float()
        return table.argmax(-1).tolist(), table

    with torch.inference_mode():
        eng_ids, eng_text = engine_ids(mp - len(toks))
        choices, table = forced(eng_ids)
        rule = _near_tie("p", eng_ids, choices, table)
        ctl_ids, _ = engine_ids(0)
        ctl_choices, ctl_table = forced(ctl_ids)
        try:
            _near_tie("p control", ctl_ids, ctl_choices, ctl_table)
            caught = False
        except AssertionError:
            caught = True
        # the first decode step at one row: the serving forward at the
        # request's offset and at 0 against generate's forward
        cache = llama.init_cache(cfg.text, 1, 512, torch.bfloat16, "cuda")
        _, cache = qwen2_vl.forward(text, cfg, None, cache, 0, position_ids=pos_t,
                                    inputs_embeds=emb)
        tok = torch.tensor([[ids[0]]], device="cuda")
        step = {}
        for name, off in (("generate", None), ("offset", mp - len(toks)), ("control", 0)):
            c = llama.KVCache(k=cache.k.clone(), v=cache.v.clone())
            if off is None:
                step[name] = qwen2_vl.forward(text, cfg, tok, c, len(toks),
                                              position_ids=torch.full((3, 1, 1), mp,
                                                                      device="cuda"))[0]
            else:
                step[name] = fwd(text, tok, c, torch.tensor([len(toks)], device="cuda"),
                                 torch.tensor([off], device="cuda"))[0]
    at_offset, at_zero = rel(step["offset"], step["generate"]), rel(step["control"],
                                                                    step["generate"])
    log(f"[p] {dev_tag}: generate {times[P_QWEN_NEW]:.3f} s for {P_QWEN_NEW} new tokens "
        f"({times[1]:.3f} s to the first: the tower {tower_ms:.3f} device ms, the prefill), "
        f"decode {(P_QWEN_NEW - 1) / (times[P_QWEN_NEW] - times[1]):.1f} tok/s at B = 1; the "
        f"dense engine with mrope_offsets (2 slots, the image request at offset "
        f"{mp - len(toks)} beside a {len(text_toks)}-token text request): ids equal "
        f"generate's: {eng_ids == ids}; the near-tie rule by teacher forcing {rule}; the text "
        f"request {len(eng_text)} ids; the control at offset 0 fails the rule: {caught}; the "
        f"first decode step's logits, the serving forward against generate's: {at_offset:.3e} "
        f"of max|logit| at the offset (bar {P_MROPE_BAR}), {at_zero:.3e} at 0 (must exceed "
        f"10x the bar)")
    if not caught or not at_offset <= P_MROPE_BAR or not at_zero > 10 * P_MROPE_BAR:
        raise AssertionError(f"[p] M-RoPE: the control passed ({not caught}), or the first "
                             f"step's logits {at_offset} / {at_zero}")
    if len(eng_text) != P_QWEN_NEW:
        raise AssertionError(f"[p] the text request gave {len(eng_text)} ids")

    # every kernel call of a short generate held to its twin on its inputs
    lin_x, vis_x, hooks = {}, {}, []
    for li in (0, layers - 1):
        for name, sub in P_QWEN_LINEARS.items():
            def grab(mod, args, key=(li, name)):
                lin_x.setdefault(key, []).append(
                    args[0].detach().reshape(-1, args[0].shape[-1]).clone())
            hooks.append(text["layers"][li][sub][name].register_forward_pre_hook(grab))
    blocks = model.params["vision"]["blocks"]
    for li in (0, vc.depth - 1):
        for name in ("attn_qkv", "attn_proj", "fc1", "fc2"):
            def grab_v(mod, args, key=(li, name)):
                vis_x.setdefault(key, []).append(args[0].detach().clone())
            hooks.append(blocks[li][name].register_forward_pre_hook(grab_v))
    norm_log, ln_log = {}, {}
    rms_patch, ln_patch = _p_norm_patches(norm_log, ln_log)
    with rms_patch, ln_patch:
        generate(3)
    for h in hooks:
        h.remove()
    by_k = _l_linear_checks(text, lin_x, P_QWEN_LINEARS, "p")
    tower_err = _p_qmm_checks("p", {k: blocks[k[0]][k[1]] for k in vis_x}, vis_x)
    log(f"[p] a 3-token generate on the path's own inputs: text linears of layers 0 and "
        f"{layers - 1}, largest rel err by (route, K) (bar 2^-7): "
        f"{ {f'{a} K={b}': round(v, 5) for (a, b), v in by_k.items()} }; the tower's blocks 0 "
        f"and {vc.depth - 1} on quant_matmul, rel err up to {tower_err:.3e} (controls past "
        f"2^-7); {_p_bit_equal('p', 'rms_norm', norm_log)}; "
        f"{_p_bit_equal('p', 'layer_norm', ln_log)}")
    del model, text, blocks, emb, lin_x, vis_x
    gc.collect()
    torch.cuda.empty_cache()
    return [window]


def phase_p(dev_tag: str) -> list:
    """Path P: LLaVA-1.5-7B through the server, then Qwen2-VL-7B through
    generate and the M-RoPE dense engine. Returns the launch windows."""
    t0 = time.time()
    windows = _p_llava(dev_tag)
    windows += _p_qwen2_vl(dev_tag)
    log(f"[p] phase p: {time.time() - t0:.1f} s")
    return windows


# rhymes-ai/Aria (from memory: no copy of its config.json is in this repo):
# the text MoE hidden 2560, 28 layers, 20/20 heads of 128, experts of width
# 1664, 64 experts top-6 and 2 shared, vocab 100352, rope theta 5e6; the
# tower Idefics3's SigLIP-so400m (`aria.IdeficsVisionConfig`'s defaults:
# 1152 wide, 27 layers, 4304, 16 heads, patch 14, image 980: 4900 patches
# and 256 queries); image_token_index 9
N_TEXT = dict(vocab_size=100352, hidden_size=2560, intermediate_size=1664, num_hidden_layers=28,
              num_attention_heads=20, num_key_value_heads=20, max_position_embeddings=65536,
              rms_norm_eps=1e-6, rope_theta=5e6, moe_num_experts=64, moe_topk=6,
              moe_num_shared_experts=2)
N_CAPACITY = 64 / 6  # E / top_k: nothing dropped, a request's ids are its own
N_LAYERS = 6  # of Aria's 28 text layers: the depth cut for the script's time (path U)
# N's 12 requests: 8 with one 980 x 980 image, 4 text-only (at 2, 5, 8 and
# 11), 32 new tokens each; generate on the first three; the dense engine of 8
# slots over 1024 rows
N_TEXT_ONLY_AT, N_NEW, N_SLOTS, N_MAX_LEN, N_GENERATED = (2, 5, 8, 11), 32, 8, 1024, 3
# Aria's matmuls (M, K, N): q/k/v/o and the shared experts' gate/up and
# down at decode (M = 1) and at the engine's image prefill (512 rows); the
# expert stacks (E, N, K, C): fc1 and fc2 at C = 1 and 2 (decode)
N_DECODE_SHAPES = [(1, 2560, 2560), (1, 2560, 3328), (1, 3328, 2560)]
N_PREFILL_SHAPES = [(512, 2560, 2560), (512, 2560, 3328), (512, 3328, 2560)]
N_GROUPED_CASES = [(64, 3328, 2560, c) for c in (1, 2)] + [(64, 2560, 1664, c) for c in (1, 2)]
# layer_norm: the tower's 4900 rows of 1152 (eps 1e-6), the projector's 256
# queries (eps 1e-5)
N_LN_ROWS = [(4900, 1152, 1e-6), (256, 1152, 1e-5)]
N_LINEARS = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
             "o_proj": "self_attn", "gate_proj": "shared_experts", "up_proj": "shared_experts",
             "down_proj": "shared_experts"}
# google/vit-large-patch16-224 (from memory): 1024 wide, 24 layers, 4096,
# 16 heads, patch 16, image 224 (197 rows with CLS), 1000 labels, eps 1e-12
T_VIT = dict(image_size=224, patch_size=16, hidden_size=1024, intermediate_size=4096,
             num_hidden_layers=24, num_attention_heads=16, layer_norm_eps=1e-12, num_labels=1000)
T_BATCH = 32  # images a forward: M = 32 x 197 = 6304 rows
T_SHAPES = [(6304, 1024, 1024), (6304, 1024, 4096), (6304, 4096, 1024)]
T_LINEARS = ("query", "key", "value", "dense", "fc1", "fc2")


def _qmm_fp32_row(record, gen, m: int, k: int, n: int, iters: int, note: str) -> dict:
    """quant_matmul on fp32 x (its fp32 route, qmm_fp32) at (M, K, N), 4-bit
    g64: within TOL_QMM_FP32 of max|y| of its twin, the controls of phase
    b's fp32 rows past it (x rounded to bf16 through the bf16 kernel, one
    TF32 product), timed against the bound (three TF32 products), the twin
    and torch.matmul in fp32 on the dequantized W; recorded."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    kqt = _make_kqt(n, k, 64, 4, seed=k * 13 + n)
    x = torch.randn((m, k), generator=gen, device="cuda")
    before = fm.qmm_fp32.launches
    y = fm.quant_matmul(x, kqt)
    if fm.qmm_fp32.launches != before + 1 or y.dtype != torch.float32:
        raise AssertionError(f"[b] fp32 x at M={m} K={k} N={n} did not take the fp32 route")
    ref = fm.quant_matmul_plain(x, kqt)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    cast = rel(fm.quant_matmul(x.to(torch.bfloat16), kqt), ref)
    w32 = fm.dequant_plain(kqt, torch.float32)
    with tf32_allowed():
        one_tf32 = rel(torch.matmul(x, w32.t()), ref)
    log(f"[b] qmm_fp32 {note} M={m} K={k} N={n}: {err / scale:.3e} of max|y|; controls, x "
        f"rounded to bf16 {cast:.3e}, one TF32 product {one_tf32:.3e} (each must exceed "
        f"{TOL_QMM_FP32})")
    if not err <= TOL_QMM_FP32 * scale or not cast > TOL_QMM_FP32 \
            or not one_tf32 > TOL_QMM_FP32 or not torch.isfinite(y).all():
        raise AssertionError(f"qmm_fp32 M={m} K={k} N={n}: err {err} against {scale}, controls "
                             f"{cast}, {one_tf32}")
    del y, ref
    wbytes = _weight_bytes(kqt)
    kq, xq = _copies(kqt, x, wbytes)
    ms = time_ms([lambda q=q, xx=xx: fm.quant_matmul(xx, q) for q, xx in zip(kq, xq)],
                 max(10, iters // 5))
    plain_ms = time_ms([lambda: fm.quant_matmul_plain(x, kqt)], max(3, iters // 10))
    lib = time_ms([lambda: torch.matmul(x, w32.t())], iters)
    del w32, kq, xq
    b_ms, by = bound_ms(wbytes + 4 * m * k + 4 * m * n, 3 * 2.0 * m * n * k, "tf32")
    row = dict(kernel="qmm_fp32", m=m, k=k, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=by, library_ms=lib, note=f"fp32 x, 4-bit g64, {note}",
               library="torch.matmul fp32 on the dequantized W")
    record("qmm_fp32", row)
    torch.cuda.empty_cache()
    return row


def phase_b_n(record, iters: int) -> None:
    """Path N's shapes: grouped_matmul and the stacked canonical dequant at
    Aria's expert stacks, w4a8_matmul at its decode matmuls (fp32 meta, as
    served), quant_matmul (row 1) at its prefill, layer_norm at the tower's
    and the projector's rows in bf16 and fp32, rms_norm at width 2560."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    phase_b_grouped(record, iters, [(c, torch.float32) for c in N_GROUPED_CASES])
    for m, k, n in N_DECODE_SHAPES:
        _w4a8_b_rows(record, gen, m, k, n, iters, bf16_meta=False)
    for m, k, n in N_PREFILL_SHAPES:
        row = _qmm_row(record, gen, m, k, n, iters, note="Aria's prefill")
        log(f"[b] quant_matmul M={m} K={k} N={n}, Aria's prefill: {row['ms']:.4f} ms, "
            f"{row['ms'] / row['library_ms']:.2f}x torch.matmul, {row['bound_ms'] / row['ms']:.2f} "
            f"of its bound")
    for rows, d, eps in N_LN_ROWS:
        for dt in (torch.bfloat16, torch.float32):
            _ln_row(record, gen, rows, d, iters, eps, dt)
    for rows in (N_SLOTS, 512):
        _rms_row(record, gen, rows, N_TEXT["hidden_size"], 0.0, iters, N_TEXT["rms_norm_eps"])


def phase_b_t(record, iters: int) -> None:
    """Path T's shapes: quant_matmul (row 1, bf16) and its fp32 route
    (qmm_fp32) at ViT-L/16's three matmuls over 32 images (6304 rows), and
    layer_norm over those rows of 1024 in bf16 and fp32 (eps 1e-12)."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    for m, k, n in T_SHAPES:
        row = _qmm_row(record, gen, m, k, n, iters, note="ViT-L/16's matmul")
        log(f"[b] quant_matmul M={m} K={k} N={n}, ViT-L/16's: {row['ms']:.4f} ms, "
            f"{row['ms'] / row['library_ms']:.2f}x torch.matmul, {row['bound_ms'] / row['ms']:.2f} "
            f"of its bound")
        _qmm_fp32_row(record, gen, m, k, n, iters, "ViT-L/16's matmul")
    for dt in (torch.bfloat16, torch.float32):
        _ln_row(record, gen, T_SHAPES[0][0], T_VIT["hidden_size"], iters,
                T_VIT["layer_norm_eps"], dt)


def _n_requests(cfg, rng):
    """N's 12 prompts and their images: an image request is BOS, 4-16 text
    tokens, the 256 placeholders, then text up to 16-64 tokens in all, its
    pixels [1, 3, 980, 980] uniform in [-1, 1) on the card; a text-only
    request 40-64 tokens (a prefill of 64 rows, past w4a8's 32). Text ids
    lie above the placeholder's."""
    vc, vocab = cfg.vision, cfg.text.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompts, pixels = [], []
    for i in range(12):
        if i in N_TEXT_ONLY_AT:
            prompts.append([1] + rng.integers(10, vocab, int(rng.integers(39, 64))).tolist())
            pixels.append(None)
            continue
        n, a = int(rng.integers(16, 65)), int(rng.integers(4, 17))
        prompts.append([1] + rng.integers(10, vocab, a).tolist()
                       + [cfg.image_token_index] * cfg.max_query_num
                       + rng.integers(10, vocab, n - a).tolist())
        pixels.append(torch.rand((1, vc.num_channels, vc.image_size, vc.image_size),
                                 generator=gen, device="cuda") * 2 - 1)
    return prompts, pixels


def _n_launches(cfg, prefills: int, steps: int, images: int) -> dict:
    """Launches of ``prefills`` prefills of more than 32 rows, ``steps``
    decode steps of up to 32 rows and ``images`` images through the tower:
    a pass runs q/k/v/o and the shared experts' gate/up/down (7 a layer:
    quant_matmul at prefill, w4a8 at decode), fc1 and fc2 (2 a layer: the
    stack dequantized once at more than 32 rows an expert, else the grouped
    kernel) and 2 rms_norm a layer and the final one; an image 2 layer_norm
    a tower layer and 3 in the projector (the router, lm_head, the tower's
    and the projector's products are unquantized F.linear)."""
    layers, tower = cfg.text.num_hidden_layers, cfg.tower_layers
    return {"quant_matmul": 7 * layers * prefills, "dequant_canonical": 2 * layers * prefills,
            "w4a8_matmul": 7 * layers * steps, "grouped_matmul": 2 * layers * steps,
            "rms_norm": (2 * layers + 1) * (prefills + steps), "layer_norm": (2 * tower + 3) * images}


def _n_swapped_block(mlp, cfg, x):
    """`aria._moe_block` with fc1's halves read the other way round: the
    gate first, then the projection (the control)."""
    import torch.nn.functional as F

    from hqq_tpu_torch.models import llama
    from hqq_tpu_torch.nn import moe

    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    combine, expert_in = moe.route_tokens(mlp["router"], xf, cfg.moe_topk, cfg.capacity_factor)
    gate, proj = mlp["experts"]["fc1"](expert_in).chunk(2, dim=-1)
    out = mlp["experts"]["fc2"](F.silu(proj) * gate)
    routed = moe.combine_experts(combine, out, cfg.moe_topk).reshape(b, t, d).to(x.dtype)
    return routed + llama._mlp(mlp["shared_experts"], x)


def _n_block_control(model, emb) -> dict:
    """On the served tree's first 2 layers: the MoE block of each layer on
    the inputs a prefill over an image request's embeddings and one decode
    step give it, through the kernels against the same block with every
    kernel wrapper replaced by its plain twin (2^-7 of max|y|: the router's
    product is the same bf16 F.linear in both, so both dispatch alike); the
    control, the plain block with fc1's halves swapped, must miss the bar."""
    import dataclasses
    from unittest import mock

    from hqq_tpu_torch.models import aria, llama
    from hqq_tpu_torch.nn import moe
    from hqq_tpu_torch.ops import fused_matmul as fm

    cfg, text = model.cfg, model.params["text"]
    two = dict(text, layers=text["layers"][:2])
    tcfg = dataclasses.replace(cfg.text, num_hidden_layers=2)
    inputs, inner = [], aria._moe_block

    def rec(mlp, c, x):
        inputs.append((mlp, x.detach().clone()))
        return inner(mlp, c, x)

    with torch.inference_mode(), mock.patch.object(aria, "_moe_block", rec):
        cache = llama.init_cache(tcfg, 1, 1024, torch.bfloat16, "cuda")
        t = emb.shape[1]
        logits, cache = aria.forward(two, tcfg, None, cache, 0, inputs_embeds=emb)
        aria.forward(two, tcfg, logits[:, -1:].argmax(-1), cache, t)

    def stack_plain(qt, dtype):
        return fm.dequant_stacked_plain(qt, dtype)

    plain = [(moe, "grouped_matmul", fm.grouped_matmul_plain),
             (moe, "dequant_canonical", stack_plain),
             (fm, "w4a8_matmul", fm.w4a8_matmul_plain),
             (fm, "quant_matmul", fm.quant_matmul_plain)]
    worst, least = 0.0, float("inf")
    with torch.inference_mode():
        for mlp, x in inputs:
            y = aria._moe_block(mlp, tcfg, x)
            with contextlib.ExitStack() as stack:
                for mod, name, twin in plain:
                    stack.enter_context(mock.patch.object(mod, name, twin))
                ref = aria._moe_block(mlp, tcfg, x)
                ctl = _n_swapped_block(mlp, tcfg, x)
            worst, least = max(worst, rel(y, ref)), min(least, rel(ctl, ref))
    found = dict(blocks=len(inputs), rows=[int(x.shape[1]) for _, x in inputs], worst=worst,
                 control_least=least)
    if len(inputs) != 4 or not worst <= 2.0**-7 or not least > 2.0**-7:
        raise AssertionError(f"[n] the MoE block against its plain twin: {found}")
    return found


def _n_forced(model, prompt, pixels, got):
    """generate's route (the tower, the splice, a prefill into a cache of
    generate's length at B = 1, then one-token steps) teacher-forced on
    ``got``: (its greedy choices, its logits [n, V])."""
    import numpy as np

    from hqq_tpu_torch.models import aria, llama

    cfg, text = model.cfg, model.params["text"]
    t0, n = len(prompt), len(got)
    cache = llama.init_cache(cfg.text, 1, 1 << int(np.ceil(np.log2(t0 + N_NEW + 1))),
                             torch.bfloat16, "cuda")
    with torch.inference_mode():
        if pixels is None:
            logits, cache = aria.forward(text, cfg, torch.tensor([prompt], device="cuda"), cache, 0)
        else:
            emb, _ = model.embed(prompt, pixels)
            logits, cache = aria.forward(text, cfg, None, cache, 0, inputs_embeds=emb)
        rows = [logits[0, -1]]
        for i in range(n - 1):
            logits, cache = aria.forward(text, cfg, torch.tensor([[int(got[i])]], device="cuda"),
                                         cache, t0 + i)
            rows.append(logits[0, -1])
    table = torch.stack(rows).float()
    return table.argmax(-1).tolist(), table


def _n_build(dev_tag: str):
    """Aria at full width, N_LAYERS of its 28 text layers, random bf16 weights from seed 0: the
    tower and projector drawn at once, the text model a layer at a time,
    each layer quantized as it is drawn (`aria.quantize_aria`: attention,
    shared experts and the stacks at 4-bit g64; the router in bf16), then
    save_quantized and `AutoHQQVLModel.from_quantized`, every tensor
    bit-equal. Returns the loaded model."""
    import dataclasses
    import shutil
    import tempfile

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.vl import AutoHQQVLModel, HQQVLModel
    from hqq_tpu_torch.models import aria

    tc = aria.AriaTextConfig(**dict(N_TEXT, num_hidden_layers=N_LAYERS),
                             capacity_factor=N_CAPACITY)
    cfg = aria.AriaConfig(text=tc, image_token_index=9)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    params = aria.init_params(dataclasses.replace(cfg, text=dataclasses.replace(
        tc, num_hidden_layers=0)), gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s, quant_s = time.time() - t0, 0.0
    qc = BaseQuantizeConfig(nbits=4, group_size=64)
    for _ in range(tc.num_hidden_layers):
        t0 = time.time()
        layer = aria.init_layer(tc, gen, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        t1 = time.time()
        aria.quantize_aria({"text": {"layers": [layer]}, "vision": None, "projector": None}, qc,
                           qc)
        torch.cuda.synchronize()
        init_s, quant_s = init_s + t1 - t0, quant_s + time.time() - t1
        params["text"]["layers"].append(layer)
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    model = HQQVLModel({"text": params["text"], "vision": {"vision": params["vision"],
                                                           "projector": params["projector"]}},
                       cfg, "aria", quantized=True)
    del params, layer
    root = tempfile.mkdtemp(prefix="hqq-aria-")
    try:
        t0 = time.time()
        model.save_quantized(root)
        save_s = time.time() - t0
        gb = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e9
        t0 = time.time()
        loaded = AutoHQQVLModel.from_quantized(root)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        n_tensors = _bit_equal_trees("n", loaded.params, model.params)
        if loaded.cfg != cfg or loaded.model_type != "aria":
            raise AssertionError(f"[n] the loaded config differs: {loaded.cfg}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[n] {dev_tag} Aria ({tc.num_hidden_layers} text layers of {tc.moe_num_experts} experts "
        f"top-{tc.moe_topk} and {tc.moe_num_shared_experts} shared, a {cfg.vision.num_hidden_layers}"
        f"-layer tower): init {init_s:.1f} s, quantize_aria layer by layer (4-bit g64: 4 "
        f"attention linears, 3 shared-expert linears and 2 stacks of {tc.moe_num_experts} experts "
        f"a layer; the router, lm_head, the tower and the projector bf16) {quant_s:.2f} s, "
        f"save_quantized {gb:.3f} GB in {save_s:.2f} s, from_quantized {load_s:.2f} s, "
        f"{n_tensors} tensors bit-equal; peak while quantizing {build_peak:.2f} GiB")
    return loaded


def phase_n(dev_tag: str) -> list:
    """Path N: Aria at full width, N_LAYERS deep (`_n_build`), prepared with
    "w4a8": `HQQVLModel.generate` on two image prompts and a text prompt
    (its launch window), the dense engine in-process with `aria.forward`
    as its forward hooks on 8 slots over N's 12 requests (the images
    encoded and spliced inside its launch window), ids against generate's,
    the share of assignments the default capacity factor 2.0 drops, a
    steady window's busy share; every kernel call of a short generate held
    to its twin; the MoE block's control. Returns the two launch windows."""
    import dataclasses
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.models import aria
    from hqq_tpu_torch.nn import moe
    from hqq_tpu_torch.nn.moe import GroupedQuantLinear
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    t_phase = time.time()
    model = _n_build(dev_tag)
    cfg = model.cfg
    tc, layers = cfg.text, cfg.text.num_hidden_layers
    t0 = time.time()
    model.prepare_for_inference("w4a8")
    prepare_s = time.time() - t0
    text = model.params["text"]
    if not all(isinstance(layer["self_attn"][f"{n}_proj"], A8QuantLinear) for n in "qkvo"
               for layer in text["layers"]) or not all(
            isinstance(layer["mlp"]["shared_experts"][n], A8QuantLinear)
            and isinstance(layer["mlp"]["experts"][e], GroupedQuantLinear)
            and type(layer["mlp"]["router"]).__name__ == "Linear"
            for n in ("gate_proj", "up_proj", "down_proj") for e in ("fc1", "fc2")
            for layer in text["layers"]):
        raise AssertionError("[n] the prepared tree is not Aria's w4a8 tree")
    prompts, pixels = _n_requests(cfg, np.random.default_rng(1))

    # the tower an image: device time, and host time of the call
    px = pixels[0]
    tower_ms = time_ms([lambda: model.encode_images(px)], 5)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(3):
        model.encode_images(px)
    torch.cuda.synchronize()
    tower_host_ms = (time.time() - t0) / 3 * 1e3
    emb, _ = model.embed(prompts[0], px)
    with torch.inference_mode():
        cache = aria.init_cache(cfg, 1, 512, torch.bfloat16, "cuda")
        prefill_ms = time_ms([lambda: aria.forward(text, cfg, None, cache, 0,
                                                   inputs_embeds=emb)], 3)

    # generate: its launch window over N_GENERATED prompts, then timings
    torch.cuda.reset_peak_memory_stats()
    model.generate(prompts[0], pixel_values=px, max_new_tokens=2)  # warm-up
    ops.reset_launch_counts()
    gen_ids, gen_s = [], []
    for p, x in zip(prompts[:N_GENERATED], pixels[:N_GENERATED]):
        torch.cuda.synchronize()
        t0 = time.time()
        gen_ids.append(model.generate(p, pixel_values=x, max_new_tokens=N_NEW))
        torch.cuda.synchronize()
        gen_s.append(time.time() - t0)
    gen_window = launch_counts()
    n_img = sum(x is not None for x in pixels[:N_GENERATED])
    want = _n_launches(cfg, N_GENERATED, N_GENERATED * (N_NEW - 1), n_img)
    got = {k: v for k, v in gen_window.items() if v}
    log(f"[n] generate on {N_GENERATED} prompts ({[len(p) for p in prompts[:N_GENERATED]]} "
        f"tokens, {n_img} with an image), {N_NEW} new each: launches {got} (expected {want})")
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"[n] generate launched {got}, expected {want}")
    torch.cuda.synchronize()
    t0 = time.time()
    model.generate(prompts[0], pixel_values=px, max_new_tokens=1)
    torch.cuda.synchronize()
    times = {1: time.time() - t0, N_NEW: gen_s[0]}  # the window's first generate
    gen_tok_s = (N_NEW - 1) / (times[N_NEW] - times[1])

    # the dense engine in-process, aria.forward as its hooks: the launch window
    def hooks(tcfg):
        return dict(forward_fn=lambda p, toks, c, pos: aria.forward(p, tcfg, toks, c, pos),
                    embeds_forward_fn=lambda p, e, c, pos: aria.forward(p, tcfg, None, c, pos,
                                                                        inputs_embeds=e))

    def engine(tcfg):
        eng = ContinuousBatchingEngine(text, tcfg, batch_slots=N_SLOTS, max_len=N_MAX_LEN,
                                       **hooks(tcfg))
        records, decode = [], eng._decode

        def timed(h):
            live = list(eng.active)
            rows = sum(int(eng._pos[s]) + 1 for s in live)
            torch.cuda.synchronize()
            t0 = time.time()
            out = decode(h)  # ends in a read-back of the tokens
            records.append(dict(steps=h, live=len(live), rows=rows, ms=(time.time() - t0) * 1e3))
            return out

        eng._decode = timed
        return eng, records

    def serve(eng):
        """N's 12 requests: each image encoded and spliced, then queued;
        returns (ids in request order, wall seconds)."""
        t0 = time.time()
        uids = []
        for p, x in zip(prompts, pixels):
            emb_i = None if x is None else model.embed(p, x)[0][0]
            uids.append(eng.add_request(p, max_new_tokens=N_NEW, inputs_embeds=emb_i))
        out = eng.run()
        torch.cuda.synchronize()
        return [out[u] for u in uids], time.time() - t0

    eng, records = engine(tc)
    ops.reset_launch_counts()
    outs, wall = serve(eng)
    eng_window = launch_counts()
    steps = sum(r["steps"] for r in records)
    want = _n_launches(cfg, len(prompts), steps, sum(x is not None for x in pixels))
    got = {k: v for k, v in eng_window.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"[n] the engine's window launched {got}, expected {want}")
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    decode_s = sum(r["ms"] for r in records) / 1e3
    tokens = sum(r["live"] * r["steps"] for r in records)
    weights = _step_weight_bytes(text)
    kv = (sum(r["rows"] for r in records) / len(records)
          * 2 * layers * tc.num_key_value_heads * tc.head_dim_ * 2)
    bound = (weights + kv) / HBM_BYTES_PER_S * 1e3
    same = [o == g for o, g in zip(outs, gen_ids)]
    rules = []
    for i, (o, g) in enumerate(zip(outs, gen_ids)):
        if o != g:  # the engine's 8-row steps and generate's 1-row steps take other plans
            choices, table = _n_forced(model, prompts[i], pixels[i], o)
            rules.append(_near_tie(f"n request {i}", o, choices, table))
    # a steady window: 8 live slots, 8 steps
    rng = np.random.default_rng(4)
    for _ in range(N_SLOTS):
        eng.add_request(rng.integers(10, tc.vocab_size, 64), max_new_tokens=N_NEW)
    eng.step()
    busy = device_share(lambda: [eng.step() for _ in range(8)])
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    top = sorted(busy["by_name"].items(), key=lambda kv: -kv[1])[:6]
    log(f"[n] {dev_tag}: the tower an image ({cfg.vision.num_patches} patches, "
        f"{cfg.tower_layers} layers, {cfg.max_query_num} queries) {tower_ms:.3f} device ms, "
        f"{tower_host_ms:.2f} host ms; prepare_for_inference('w4a8') {prepare_s:.2f} s; the "
        f"prefill of a {len(prompts[0])}-token image prompt {prefill_ms:.3f} device ms; generate "
        f"{times[N_NEW]:.3f} s for {N_NEW} new tokens ({times[1]:.3f} s to the first), "
        f"{gen_tok_s:.1f} tok/s at B = 1; the dense engine ({N_SLOTS} slots, max_len "
        f"{N_MAX_LEN}, capacity factor E / top_k = {N_CAPACITY:.4f}) on 12 requests (prompts "
        f"{[len(p) for p in prompts]}, 8 with an image) in {wall:.3f} s: {decode_s / steps * 1e3:.2f} "
        f"ms a decode step, {tokens / decode_s:.1f} tok/s over the slots, against a byte bound "
        f"of {bound:.3f} ms a step ({weights / 1e9:.3f} GB of codes and meta of every expert, "
        f"the attention and shared experts, the router and the bf16 lm_head + {kv / 1e9:.4f} GB "
        f"of K/V rows on average); launches a decode step "
        f"{ {k: v for k, v in _n_launches(cfg, 0, 1, 0).items() if v} }, an image "
        f"{ {k: v for k, v in _n_launches(cfg, 0, 0, 1).items() if v} }; ids equal generate's "
        f"in {sum(same)} of {len(same)}, the others by the near-tie rule {rules}; 8 steps of 8 "
        f"live slots busy {busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms, device "
        f"{busy['device_ms']:.3f} ms, by kernel { {k[:80]: round(v, 3) for k, v in top} }; "
        f"peak while serving {serve_peak:.2f} GiB")

    # the same requests at the default capacity factor 2.0: assignments dropped
    tc2 = dataclasses.replace(tc, capacity_factor=2.0)
    kept = {"decode": torch.zeros((), dtype=torch.int64, device="cuda"),
            "prefill": torch.zeros((), dtype=torch.int64, device="cuda")}
    total = {"decode": 0, "prefill": 0}
    inner = moe.moe_dispatch

    def counting(probs, k, capacity):
        d, c = inner(probs, k, capacity)
        kind = "decode" if probs.shape[0] <= N_SLOTS else "prefill"
        kept[kind] += d.sum()
        total[kind] += probs.shape[0] * k
        return d, c

    eng2, _ = engine(tc2)
    with mock.patch.object(moe, "moe_dispatch", counting):
        outs2, _ = serve(eng2)
    eng2.close()
    del eng2
    dropped = {k: 1 - int(kept[k]) / total[k] for k in total}
    log(f"[n] the same 12 requests at capacity factor 2.0 (capacity "
        f"{moe.moe_capacity(N_SLOTS, tc.moe_topk, tc.moe_num_experts, 2.0)} a decode step of "
        f"{N_SLOTS} slots): share of assignments dropped: decode {dropped['decode']:.4f} of "
        f"{total['decode']}, prefill {dropped['prefill']:.4f} of {total['prefill']} (padding "
        f"rows included); requests whose ids equal those at E / top_k: "
        f"{sum(a == b for a, b in zip(outs2, outs))} of 12")

    # every kernel call of a short generate held to its twin on its inputs
    lin_x, exp_x, hooks_ = {}, {}, []
    for li in (0, layers - 1):
        layer = text["layers"][li]
        for name, sub in N_LINEARS.items():
            mod = layer["self_attn"][name] if sub == "self_attn" else \
                layer["mlp"]["shared_experts"][name]

            def grab(m, args, key=(li, name)):
                lin_x.setdefault(key, []).append(
                    args[0].detach().reshape(-1, args[0].shape[-1]).clone())
            hooks_.append(mod.register_forward_pre_hook(grab))
        for name in ("fc1", "fc2"):
            def grab_e(m, args, key=(li, name)):
                exp_x.setdefault(key, []).append(args[0].detach().clone())
            hooks_.append(layer["mlp"]["experts"][name].register_forward_pre_hook(grab_e))
    norm_log, ln_log = {}, {}
    rms_patch, ln_patch = _p_norm_patches(norm_log, ln_log)
    with rms_patch, ln_patch:
        model.generate(prompts[0], pixel_values=px, max_new_tokens=3)
    for h in hooks_:
        h.remove()
    shim = {"layers": [{"self_attn": layer["self_attn"],
                        "shared_experts": layer["mlp"]["shared_experts"]}
                       for layer in text["layers"]]}
    by_k = _l_linear_checks(shim, lin_x, N_LINEARS, "n")
    experts = _x_expert_checks(text, exp_x, block="mlp")
    control = _n_block_control(model, emb)
    log(f"[n] a 3-token generate on the path's own inputs: the attention and shared-expert "
        f"linears of layers 0 and {layers - 1}, largest rel err by (route, K) (bar 2^-7): "
        f"{ {f'{a} K={b}': round(v, 5) for (a, b), v in by_k.items()} }; their expert stacks "
        f"{experts}; {_p_bit_equal('n', 'rms_norm', norm_log)}; "
        f"{_p_bit_equal('n', 'layer_norm', ln_log)}; the MoE block of a 2-layer cut against its "
        f"plain twin, and the control with fc1's halves swapped: {control}")
    del model, text, emb, lin_x, exp_x, cache
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[n] phase n: {time.time() - t_phase:.1f} s")
    return [gen_window, eng_window]


def phase_t(dev_tag: str) -> list:
    """Path T: ViT-L/16 at published width, random weights from seed 0, in
    bf16 (row 1) and fp32 (qmm_fp32): `HQQVisionModel.quantize_model`
    (4-bit g64; the patch projection and the classifier full precision),
    save_quantized and `AutoHQQVisionModel.from_quantized` bit-equal,
    prepare_for_inference("pallas"), a forward of 32 images with the "cls"
    pool (its launch window) and the "mean" pool; ms a batch, host and
    device; every matmul and layer_norm call of the first and last layers
    held to its twin on the batch's own activations. Returns the two
    launch windows."""
    import shutil
    import tempfile

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.backends.pallas_backend import PallasQuantLinear
    from hqq_tpu_torch.engine.vision import AutoHQQVisionModel, HQQVisionModel
    from hqq_tpu_torch.models import vit

    t_phase = time.time()
    cfg = vit.ViTConfig(**T_VIT)
    layers = cfg.num_hidden_layers
    px = torch.randn((T_BATCH, cfg.num_channels, cfg.image_size, cfg.image_size),
                     generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    windows = []
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        model = HQQVisionModel(vit.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                               dt, "cuda"), cfg)
        t0 = time.time()
        model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64), compute_dtype=dt)
        torch.cuda.synchronize()
        quant_s = time.time() - t0
        root = tempfile.mkdtemp(prefix="hqq-vit-")
        try:
            t0 = time.time()
            model.save_quantized(root)
            save_s = time.time() - t0
            gb = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e9
            loaded = AutoHQQVisionModel.from_quantized(root)
            n_tensors = _bit_equal_trees("t", loaded.params, model.params)
            if loaded.cfg != cfg:
                raise AssertionError(f"[t] the loaded config differs: {loaded.cfg}")
        finally:
            shutil.rmtree(root, ignore_errors=True)
        del model
        loaded.prepare_for_inference("pallas")
        tree = loaded.params
        if not all(isinstance(blk[sub][n], PallasQuantLinear) for blk in tree["layers"]
                   for sub, names in (("attention", T_LINEARS[:4]), ("mlp", T_LINEARS[4:]))
                   for n in names) or type(tree["patch_proj"]).__name__ != "Linear" \
                or type(tree["classifier"]).__name__ != "Linear":
            raise AssertionError("[t] the prepared tree is not ViT's pallas tree")
        x = px.to(dt)
        with torch.inference_mode():
            loaded(x)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            logits, hidden = loaded(x, "cls")
            torch.cuda.synchronize()
            window = launch_counts()
            mean_logits, mean_hidden = loaded(x, "mean")
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(3):
                loaded(x)
            torch.cuda.synchronize()
            host_ms = (time.time() - t0) / 3 * 1e3
            device_ms = time_ms([lambda: loaded(x)], 3)
        windows.append(window)
        route = "quant_matmul" if dt == torch.bfloat16 else "qmm_fp32"
        want = {route: 6 * layers, "layer_norm": 2 * layers + 1}
        got = {k: v for k, v in window.items() if v}
        ok = (logits.shape == (T_BATCH, cfg.num_labels) and hidden.dtype == dt
              and hidden.shape == (T_BATCH, cfg.num_patches + 1, cfg.hidden_size)
              and bool(torch.isfinite(logits).all()) and bool(torch.isfinite(mean_logits).all())
              and not torch.equal(logits, mean_logits))
        # the first and last layers' matmuls and every layer_norm on their inputs
        mats, hooks_ = {}, []
        for li in (0, layers - 1):
            for sub, names in (("attention", T_LINEARS[:4]), ("mlp", T_LINEARS[4:])):
                for n in names:
                    def grab(m, args, key=(li, n)):
                        mats.setdefault(key, []).append(args[0].detach().clone())
                    hooks_.append(tree["layers"][li][sub][n].register_forward_pre_hook(grab))
        norm_log, ln_log = {}, {}
        _, ln_patch = _p_norm_patches(norm_log, ln_log)
        with ln_patch, torch.inference_mode():
            loaded(x)
        for h in hooks_:
            h.remove()
        mod = {k: tree["layers"][k[0]]["attention" if k[1] in T_LINEARS[:4] else "mlp"][k[1]]
               for k in mats}
        worst = _p_qmm_checks("t", mod, mats, 2.0**-7 if dt == torch.bfloat16 else TOL_QMM_FP32)
        log(f"[t] {dev_tag} ViT-L/16 in {name} ({layers} layers at {cfg.hidden_size}, "
            f"{T_BATCH} images of {cfg.image_size}: M = {T_BATCH * (cfg.num_patches + 1)}): "
            f"quantize_model {quant_s:.2f} s, save_quantized {gb:.3f} GB in {save_s:.2f} s, "
            f"{n_tensors} tensors bit-equal after from_quantized; a batch {device_ms:.3f} device "
            f"ms, {host_ms:.2f} host ms, launches {got} (expected {want}); logits "
            f"{tuple(logits.shape)} with both pools finite and apart: {ok}; layers 0 and "
            f"{layers - 1}'s matmuls ({route}) on the batch's inputs, rel err up to {worst:.3e}; "
            f"{_p_bit_equal('t', 'layer_norm', ln_log)}")
        if got != want or not ok:
            raise AssertionError(f"[t] {name}: launches {got} (expected {want}), outputs {ok}")
        del loaded, tree, logits, hidden, mean_logits, mean_hidden, mats
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[t] phase t: {time.time() - t_phase:.1f} s")
    return windows


# path U: HQQ+'s sub-word groups. U's model is Llama-2-7B at 2-bit g8 axis=1
# (HQQ+'s published mobiuslabs/Llama-2-7b-chat-hf_2bitgs8_hqq names the
# recipe); the kernel coverage adds the other configs whose group is shorter
# than a 32-bit word: (nbits, g), 2 or 4 groups a word
U_NBITS, U_GROUP = 2, 8
U_CONFIGS = [(2, 8), (1.58, 8), (1, 8), (1, 16)]
# U's decode shapes (M, K, N) under w4a8: a layer's down_proj input side at
# B = 4, and the fused q/k/v, gate/up and down of the paged engine's 8
# slots; its prefill (B = 4 x t_pad 128); qmm_fp32's row (fp32 x)
U_DECODE_SHAPES = [(4, 4096, 11008), (8, 4096, 12288), (8, 4096, 22016), (8, 11008, 4096)]
U_PREFILL_SHAPE = (512, 4096, 11008)
U_FP32_SHAPE = (512, 4096, 4096)
U_DEQUANT_SHAPE = (11008, 4096)  # W [N, K] of the MLP's gate and up
U_ITERS = 50


def _u_note(nbits, g, meta=torch.float32) -> str:
    return f"{nbits}-bit g{g} axis=1" + (", bf16 meta" if meta == torch.bfloat16 else "")


def _u_kqt(n: int, k: int, nbits, g: int, seed: int, meta=torch.float32):
    from hqq_tpu_torch.core.quantize import quantize
    from hqq_tpu_torch.ops.fused_matmul import to_kernel_layout

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device="cuda") / k**0.5
    return to_kernel_layout(quantize(w, nbits=nbits, group_size=g, axis=1), meta)


def _u_tile_held(what: str, kqt, run, plain, tol: float) -> float:
    """A tile kernel's ``run(kqt)`` against ``plain(kqt)`` within ``tol`` of
    max|y|; every control of `_w4a8_controls` through the plain twin must
    miss it (the word's other group among them); three runs bit-equal.
    Returns the largest error."""
    y, ref = run(kqt), plain(kqt)
    err = rel(y, ref)
    misses = {c: rel(plain(bad), ref) for c, bad in _w4a8_controls(kqt).items()}
    runs = [run(kqt) for _ in range(3)]
    equal = all(torch.equal(r, runs[0]) for r in runs[1:])
    log(f"[b] {what}: rel err {err:.3e} (tol {tol:.1e}); controls "
        f"{ {c: round(v, 4) for c, v in misses.items()} } (must exceed it); three runs "
        f"bit-equal: {equal}")
    if not (err <= tol) or not torch.isfinite(y).all():
        raise AssertionError(f"{what}: err {err} > {tol}")
    if not all(v > tol for v in misses.values()) or "the word's other group" not in misses:
        raise AssertionError(f"{what}: the bar does not catch a wrong group's meta")
    if not equal:
        raise AssertionError(f"{what}: repeated runs differ")
    return (y.float() - ref.float()).abs().max().item()


def _u_rows_by_m(what: str, run, x, xa) -> None:
    """Row 0 of ``run(x8, sx, xa_rows)`` is bit-equal at M = 1, 4, 8 and 32
    from the same row of x (32 bf16 rows) and of the adapter's input xa
    (fp32, or None; computed once for all rows, since a library GEMM's row
    0 may differ with M): the small-group plan sums a row in one order at
    every M, and x8 scales per row."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    rows = []
    for m in (1, 4, 8, 32):
        x8, sx = fm.quantize_activations_int8(x[:m])
        rows.append(run(x8, sx, None if xa is None else xa[:m])[0])
    same = [torch.equal(r, rows[0]) for r in rows[1:]]
    log(f"[b] {what}: row 0 at M = 4, 8, 32 bit-equal to M = 1: {same}")
    if not all(same):
        raise AssertionError(f"{what}: row 0 differs across M")


def _u_group_case(record, gen, m: int, k: int, n: int, nbits, g: int, meta, rank: int,
                  iters: int, plain_iters: int) -> None:
    """Row 2/3 (rank 0, `w4a8_matmul`) or row 8 (`w4a8_lora_matmul`) at one
    shape and config on the route its plan names (the small-group kernel,
    or the CUDA-core kernel where rows break the 16-byte rule): held to the
    plain twin with the controls (a neighbour's scale, the word's other
    group where a word spans groups), three bit-equal runs, row 0 bit-equal
    at M = 1, 4, 8, 32; timed against the byte bound, the twin and
    torch.matmul on the dequantized W (three calls with the adapter)."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    cb = fm._KERNEL_CONTAINER_BITS[nbits]
    kqt = _u_kqt(n, k, nbits, g, seed=k + n + g + rank, meta=meta)
    plan = fm.w4a8_launch_plan(m, n, k, cb, g, meta)
    a, b = _make_lora(k, n, seed=g, r=rank) if rank else (None, None)
    note = ("r=8, " if rank else "") + _u_note(nbits, g, meta)
    kernel = "w4a8_lora_matmul" if rank else "w4a8_matmul"
    what = f"{kernel} M={m} K={k} N={n} {note} ({plan.route})"

    def run(x8, sx, xa, q=kqt, dt=torch.float32):
        if rank:
            return fm.w4a8_lora_matmul(x8, sx, q, xa, b, dt)
        return fm.w4a8_matmul(x8, sx, q, dt)

    def twin(x8, sx, xa, q=kqt, dt=torch.float32):
        if rank:
            return fm.w4a8_lora_matmul_plain(x8, sx, q, xa, b, dt)
        return fm.w4a8_matmul_plain(x8, sx, q, dt)

    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    x8, sx = fm.quantize_activations_int8(x)
    xa = x.float() @ a if rank else None
    worst = _w4a8_held(what, kqt, lambda q, dt: run(x8, sx, xa, q, dt),
                       lambda q, dt: twin(x8, sx, xa, q, dt))
    x32 = torch.randn((32, k), generator=gen, device="cuda").to(torch.bfloat16)
    _u_rows_by_m(what, run, x32, x32.float() @ a if rank else None)
    wbytes = _weight_bytes(kqt)
    kq, xq = _copies(kqt, x8, wbytes)
    if rank:
        calls = [lambda p=p, q=q: fm.w4a8_lora_matmul(q, sx, p, xa, b, torch.bfloat16)
                 for p, q in zip(kq, xq)]
    else:
        calls = [lambda p=p, q=q: fm.w4a8_matmul(q, sx, p, torch.bfloat16) for p, q in zip(kq, xq)]
    ms = time_ms(calls, iters)
    plain = time_ms([lambda: twin(x8, sx, xa, kqt, torch.bfloat16)], plain_iters)
    w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
    if rank:
        lib = time_ms([lambda: torch.matmul(x, w_bf16.t()).float()
                       + torch.matmul(torch.matmul(x.float(), a), b)], iters)
        b_ms, by = bound_ms(wbytes + m * k + 4 * m + 4 * m * rank + 4 * rank * n + 2 * m * n,
                            2.0 * m * n * k, "int8", fp32_ops=2.0 * m * rank * n)
    else:
        lib = time_ms([lambda: torch.matmul(x, w_bf16.t())], iters)
        b_ms, by = bound_ms(wbytes + m * k + 4 * m + 2 * m * n, 2.0 * m * n * k, "int8")
    del w_bf16, kq, xq
    key = "w4a8_group_mma" if plan.route == "group_mma" else kernel
    record(key, dict(
        kernel=kernel, m=m, k=k, n=n, max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=by, library_ms=lib, note=note,
        library="three torch.matmul calls and their sum" if rank else "torch.matmul",
        plan=f"{plan.route}, {plan.col_tile} rows x {plan.k_slices} slices, ring {plan.stages}, "
             f"grid {plan.grid}, {plan.smem} B of shared memory"))


# rows 2/3 and 8 on the small-group route (M, K, N, nbits, g, meta, rank):
# U's decode at 2-bit g8 (fp32 and bf16 meta, the fused M = 8 widths, the
# speculative engines' verify at M = 32), the other sub-word configs, 4-bit
# g16 and g24, row 8 with a rank-8 adapter at the four sub-word configs; and
# the CUDA-core kernel at 1-bit code rows off the 16-byte rule (K = 4544)
U_GROUP_CASES = (
    [(4, 4096, 11008, 2, 8, torch.float32, 0), (4, 4096, 11008, 2, 8, torch.bfloat16, 0)]
    + [(m, k, n, 2, 8, torch.float32, 0) for (m, k, n) in U_DECODE_SHAPES[1:]]
    + [(32, 4096, 11008, 2, 8, torch.float32, 0)]
    + [(4, 4096, 11008, nbits, g, torch.float32, 0) for (nbits, g) in U_CONFIGS[1:]]
    + [(4, 4096, 11008, 4, 16, torch.float32, 0), (4, 4608, 11008, 4, 24, torch.float32, 0)]
    + [(4, 4096, 11008, nbits, g, torch.float32, LORA_RANK) for (nbits, g) in U_CONFIGS]
    + [(4, 4544, 4672, 1, 8, torch.float32, 0)])


def phase_b_u(record, iters: int = U_ITERS) -> None:
    """Phase b's rows of path U: every route that takes the sub-word groups,
    each config at U's shapes, held to its plain twin with the controls
    (the word's other group, a neighbour's scale) and three bit-equal runs,
    timed against its bound, the twin and the library call: rows 2/3 and 8
    (w4a8, the small-group route) at `U_GROUP_CASES`, each also with row 0
    bit-equal at M = 1, 4, 8, 32; row 1 and row 7 at U's prefill, row 4
    (dequant) of W [11008, 4096], `qmm_fp32` at 2-bit g8."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    gen = torch.Generator(device="cuda").manual_seed(22)
    plain_iters = 3
    for case in U_GROUP_CASES:
        _u_group_case(record, gen, *case, iters, plain_iters)
    for nbits, g in U_CONFIGS:
        note = _u_note(nbits, g)
        r = LORA_RANK
        # -- rows 1 and 7 at U's prefill, on the qmm_sm90.cuh mainloop
        m, k, n = U_PREFILL_SHAPE
        kqt = _u_kqt(n, k, nbits, g, seed=k * 5 + g)
        a, b = _make_lora(k, n, seed=g + 1)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        wbytes = _weight_bytes(kqt)
        kq, xq = _copies(kqt, x, wbytes)
        w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
        for kernel in ("quant_matmul", "quant_matmul_lora"):
            lora = kernel == "quant_matmul_lora"
            fn = getattr(fm, kernel)
            plain_fn = getattr(fm, kernel + "_plain")
            extra_args = (a, b) if lora else ()
            what = f"{kernel} M={m} K={k} N={n}{' r=8' if lora else ''} {note}"
            worst = _u_tile_held(what, kqt, lambda q: fn(x, q, *extra_args),
                                 lambda q: plain_fn(x, q, *extra_args), 2.0**-7)
            ms = time_ms([lambda p=p, q=q: fn(q, p, *extra_args) for p, q in zip(kq, xq)], iters)
            plain = time_ms([lambda: plain_fn(x, kqt, *extra_args)], plain_iters)
            if lora:
                a16 = a.to(torch.bfloat16)
                lib = time_ms([lambda: torch.matmul(x, w_bf16.t()).float()
                               + torch.matmul(torch.matmul(x, a16).float(), b)], iters)
                b_ms, by = bound_ms(wbytes + 2 * m * k + 2 * m * n + 4 * r * (k + n),
                                    2.0 * m * n * k + 2.0 * m * k * r, "bf16",
                                    fp32_ops=2.0 * m * r * n)
            else:
                lib = time_ms([lambda: torch.matmul(x, w_bf16.t())], iters)
                b_ms, by = bound_ms(wbytes + 2 * m * k + 2 * m * n, 2.0 * m * n * k, "bf16")
            record(kernel, dict(kernel=kernel, m=m, k=k, n=n, max_abs_err=worst, ms=ms,
                                plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=lib,
                                note=f"r=8, {note}" if lora else note))
        del kq, xq, w_bf16
        # -- row 4: the dequant kernel, W [N, K] to bf16, bit-equal
        n, k = U_DEQUANT_SHAPE
        kqt = _u_kqt(n, k, nbits, g, seed=n + g)
        out = fm.dequant(kqt, torch.bfloat16)
        ref = fm.dequant_plain(kqt, torch.bfloat16)
        bad = {c: torch.equal(fm.dequant_plain(q, torch.bfloat16), ref)
               for c, q in _w4a8_controls(kqt).items()}
        equal = all(torch.equal(fm.dequant(kqt, torch.bfloat16), out) for _ in range(3))
        log(f"[b] dequant W [{n}, {k}] {note}: bit-equal to its twin {torch.equal(out, ref)}; "
            f"controls bit-equal {bad} (must be False); three runs bit-equal {equal}")
        if not torch.equal(out, ref) or any(bad.values()) or not equal:
            raise AssertionError(f"[b] dequant {note} disagrees with its twin or its controls")
        wbytes = _weight_bytes(kqt)
        kq, _ = _copies(kqt, None, wbytes + 2 * n * k)
        ms = time_ms([lambda q=q: fm.dequant(q, torch.bfloat16) for q in kq], iters)
        plain = time_ms([lambda: fm.dequant_plain(kqt, torch.bfloat16)], plain_iters)
        del kq
        b_ms, by = bound_ms(wbytes + 2 * n * k, 0.0, "bf16")
        record("dequant", dict(kernel="dequant", m=None, k=n, n=k, max_abs_err=0.0, ms=ms,
                               plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=None,
                               note=note))
    # -- qmm_fp32: fp32 x at 2-bit g8 (hqq_tpu multiplies in x's type)
    m, k, n = U_FP32_SHAPE
    kqt = _u_kqt(n, k, U_NBITS, U_GROUP, seed=7)
    x = torch.randn((m, k), generator=gen, device="cuda")
    note = f"fp32 x, {_u_note(U_NBITS, U_GROUP)}"
    worst = _u_tile_held(f"qmm_fp32 M={m} K={k} N={n} {note}", kqt,
                         lambda q: fm.quant_matmul(x, q), lambda q: fm.quant_matmul_plain(x, q),
                         TOL_QMM_FP32)
    wbytes = _weight_bytes(kqt)
    kq, xq = _copies(kqt, x, wbytes)
    ms = time_ms([lambda p=p, q=q: fm.quant_matmul(q, p) for p, q in zip(kq, xq)], iters)
    plain = time_ms([lambda: fm.quant_matmul_plain(x, kqt)], plain_iters)
    w32 = fm.dequant_plain(kqt, torch.float32)
    lib = time_ms([lambda: torch.matmul(x, w32.t())], iters)
    del kq, xq, w32
    b_ms, by = bound_ms(wbytes + 4 * m * k + 4 * m * n, 3 * 2.0 * m * n * k, "tf32")
    record("qmm_fp32", dict(kernel="qmm_fp32", m=m, k=k, n=n, max_abs_err=worst, ms=ms,
                            plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=lib, note=note))
    torch.cuda.empty_cache()


def _u_route_checks(model) -> None:
    """U-plus's prepared tree: every linear an `A8LoRAQuantLinear` of 2-bit
    g8 whose decode plan is the small-group route; a partial decode step
    with no canonical dequant and no `F.linear` on any weight but lm_head's,
    its w4a8 launches all on that route; the replayed graph's kernels: the
    w4a8 ones all `w4a8_group_mma_kernel`, no canonical dequant kernel."""
    from unittest import mock

    import torch.nn.functional as F

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.backends.pallas_backend import A8LoRAQuantLinear
    from hqq_tpu_torch.ops import fused_matmul as fm

    layers = [mod for layer in model.params["layers"] for block in ("self_attn", "mlp")
              for mod in layer[block].values()]
    if len(layers) != LINEARS_PER_PASS or not all(
            isinstance(mod, A8LoRAQuantLinear) and mod.kqt.container_bits == 2
            and mod.kqt.group_size == U_GROUP for mod in layers):
        raise AssertionError("[u] U-plus's tree is not 224 A8LoRAQuantLinear of 2-bit g8")
    routes = {(mod.kqt.k, mod.kqt.n): fm.w4a8_launch_plan(4, mod.kqt.n, mod.kqt.k, 2, U_GROUP,
                                                          mod.kqt.scale.dtype).route
              for mod in layers}
    if set(routes.values()) != {"group_mma"}:
        raise AssertionError(f"[u] decode plans {routes}")
    prompts = _prompts(model.cfg)
    linear = F.linear
    weights = []

    def recorded(x, w, *a, **kw):
        weights.append(tuple(w.shape))
        return linear(x, w, *a, **kw)

    ops.reset_launch_counts()
    with mock.patch.object(F, "linear", recorded):
        model.generate(prompts, max_new_tokens=2, compile_mode="partial")
    torch.cuda.synchronize()
    counts = launch_counts()
    head = tuple(model.params["lm_head"].weight.shape)
    if counts["dequant_canonical"] or set(weights) - {head}:
        raise AssertionError(f"[u] a partial step ran the canonical route: "
                             f"{counts['dequant_canonical']} canonical dequants, F.linear on "
                             f"{sorted(set(weights))}")
    if not counts["w4a8_lora_matmul"] or counts["w4a8_group_mma"] != counts["w4a8_lora_matmul"]:
        raise AssertionError(f"[u] {counts['w4a8_group_mma']} of {counts['w4a8_lora_matmul']} "
                             f"w4a8 launches of a partial step on the small-group route")
    model.generate(prompts, max_new_tokens=8)  # captures the graph
    busy = device_share(lambda: model.generate(prompts, max_new_tokens=8))
    names = busy["by_name"]
    w4a8 = sorted(busy["w4a8"])
    canonical = [k for k in names if "dequant_canonical" in k]
    model.release_graphs()
    log(f"[u] U-plus's decode: plans {sorted(set(routes.values()))} at {sorted(routes)}; a "
        f"partial prefill and decode step: {counts['w4a8_lora_matmul']} w4a8_lora_matmul "
        f"({counts['w4a8_group_mma']} on the small-group route), "
        f"{counts['quant_matmul_lora']} quant_matmul_lora, 0 canonical dequants, F.linear only "
        f"on {sorted(set(weights))}; a replayed 8-token generate's w4a8 kernels {busy['w4a8']} "
        f"ms, canonical dequant kernels {canonical}")
    if not w4a8 or not all("group_mma" in k for k in w4a8) or canonical:
        raise AssertionError(f"[u] the replayed decode ran {w4a8} and {canonical}")


def _u_plus(dev_tag: str, root: str) -> tuple:
    """U-plus: Llama-2-7B at full width and depth, random bf16 weights from
    seed 0, 2-bit g8 axis=1 (saved to ``root`` before the adapters go on,
    for U-serve), rank-8 adapters on all 224 linears with B from a seed,
    "w4a8" (`A8LoRAQuantLinear`: row 8 at decode, row 7 at prefill):
    `serve_7b`'s window (prefill ms, Generator "partial" and "full" decode
    tok/s at B = 4 against the byte bound, busy share, peak, quantize s),
    every fused call of a prefill and two decode steps against its twin with
    the word's-other-group control, and `_u_route_checks`. Returns the
    launch window."""
    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.core.peft import PeftUtils, lora_config
    from hqq_tpu_torch.ops import fused_matmul as fm

    saved = {}

    def save_then_adapt(model):
        t0 = time.time()
        model.save_quantized(root)
        saved["s"] = time.time() - t0
        saved["gb"] = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e9
        PeftUtils.add_lora(model.params, lora_config(r=LORA_RANK, lora_alpha=LORA_ALPHA),
                           torch.Generator(device="cuda").manual_seed(22))
        _fill_lora_b(model.params, 23)

    n = LINEARS_PER_PASS
    launches, model, _ = serve_7b(
        "u", dev_tag, BaseQuantizeConfig(nbits=U_NBITS, group_size=U_GROUP),
        {"quant_matmul_lora": (n, 0), "w4a8_lora_matmul": (0, n),
         "rms_norm": (NORMS_PER_PASS, NORMS_PER_PASS)}, after_quantize=save_then_adapt)
    log(f"[u] save_quantized of the 2-bit g8 base: {saved['gb']:.3f} GB in {saved['s']:.2f} s")

    def word_swapped(plain):
        def fn(*args):
            args = list(args)
            i = next(j for j, v in enumerate(args) if isinstance(v, fm.KernelQTensor))
            args[i] = _word_neighbour(args[i])
            return plain(*args)
        return fn

    check_calls("u", model, {
        "quant_matmul_lora": (fm.quant_matmul_lora_plain,
                              {"the word's other group": word_swapped(fm.quant_matmul_lora_plain)}),
        "w4a8_lora_matmul": (fm.w4a8_lora_matmul_plain,
                             {"the word's other group": word_swapped(fm.w4a8_lora_matmul_plain)}),
    })
    _u_route_checks(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _u_serve(dev_tag: str, root: str) -> dict:
    """U-serve: `serve.main --nbits 2 --group-size 8` on U's checkpoint with
    its defaults (paged engine, w4a8, fuse_for_decode), G's pool and a
    horizon of 8; a warm-up, G's 12 requests from 12 client threads (6
    streamed): ids equal to an in-process engine's on the served tree;
    boot s, time to first token, tokens/s at the client and in-process, ms
    a step against the byte bound, the busy share of 8 steady steps, the
    server's peak. Returns the launch window."""
    import types

    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.serve import main as serve_main
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    argv = ["--model", root, "--port", "0", "--nbits", str(U_NBITS), "--group-size",
            str(U_GROUP), "--slots", str(G_SLOTS), "--num-pages", str(G_PAGES), "--page-size",
            str(PAGE), "--max-pages-per-seq", str(MAX_PAGES), "--horizon", str(S_HORIZON)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    srv = serve_main(argv, serve=False).start()
    boot_s = time.time() - t0
    eng = srv.engine
    params, cfg = eng.params, eng.cfg
    layers = cfg.num_hidden_layers
    fused = [layer[b][name] for layer in params["layers"]
             for b, name in (("self_attn", "qkv_proj"), ("mlp", "gate_up_proj"))]
    if not all(isinstance(f, A8QuantLinear) and f.kqt.container_bits == 2
               and f.kqt.group_size == U_GROUP for f in fused):
        raise AssertionError("[u] the served tree is not fused 2-bit g8 A8QuantLinear layers")
    prompts = _g_prompts(cfg, np.random.default_rng(0))
    steps = []
    decode = eng._decode
    eng._decode = lambda h: (steps.append(h), decode(h))[1]
    try:
        t_warm = time.time()
        _s_request(srv.port, prompts[0][:64], 8, False, t_warm)
        warm_s = time.time() - t_warm
        ops.reset_launch_counts()  # the main path's window
        steps.clear()
        results, window_s = _s_window(srv.port, prompts, G_NEW)
        launches = launch_counts()
        n_steps = sum(steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        srv.stop()
    eng.close()
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    expect = {"w4a8_matmul": 4 * layers * n_steps, "w4a8_group_mma": 4 * layers * n_steps,
              "paged_attention": layers * n_steps, "quant_matmul": 4 * layers * len(prompts),
              "dequant_canonical": 0}
    for name, want in expect.items():
        if launches[name] != want:
            raise AssertionError(f"[u] {launches[name]} {name} launches in the window ({n_steps} "
                                 f"decode steps, {len(prompts)} prefills), expected {want}")
    outs, recs, inproc_s, _ = _serve_paged(types.SimpleNamespace(params=params, cfg=cfg),
                                           prompts, G_NEW, horizon=S_HORIZON)
    same = [r["tokens"] == o for r, o in zip(results, outs)]
    decode_s = sum(rc["ms"] for rc in recs) / 1e3
    dec_steps = sum(rc["steps"] for rc in recs)
    tokens = sum(rc["live"] * rc["steps"] for rc in recs)
    weights = _step_weight_bytes(params)
    kv = (sum(rc["rows"] for rc in recs) / len(recs)
          * 2 * layers * cfg.num_key_value_heads * cfg.head_dim_ * 2)
    bound = (weights + kv) / HBM_BYTES_PER_S * 1e3
    eng = PagedBatchingEngine(params, cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                              page_size=PAGE, max_pages_per_seq=MAX_PAGES)
    rng = np.random.default_rng(1)
    for _ in range(G_SLOTS):
        eng.add_request(rng.integers(0, cfg.vocab_size, 256), max_new_tokens=G_NEW)
    eng.step()
    busy = device_share(lambda: [eng.step() for _ in range(8)])
    eng.close()
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    all_tokens = sum(len(r["tokens"]) for r in results)
    first = sorted(r["first_s"] for r in results if r["chunks"] is not None)
    log(f"[u] {dev_tag}: U-serve, serve.main --nbits 2 --group-size 8 (paged, w4a8, fused, "
        f"{G_SLOTS} slots, {G_PAGES} pages of {PAGE} rows, horizon {S_HORIZON}) to a started "
        f"server {boot_s:.2f} s, warm-up {warm_s:.2f} s; 12 requests (prompts "
        f"{[len(p) for p in prompts]}, {G_NEW} new, greedy) from 12 client threads, 6 streamed: "
        f"window {window_s:.3f} s, {all_tokens / window_s:.1f} tok/s at the client; time to "
        f"first token median {first[len(first) // 2]:.3f} s, max {first[-1]:.3f} s; in-process "
        f"{inproc_s:.3f} s, {all_tokens / inproc_s:.1f} tok/s, ids equal the server's in "
        f"{sum(same)} of {len(same)}; decode {tokens / decode_s:.1f} tok/s over all slots, "
        f"{decode_s / dec_steps * 1e3:.2f} ms a step against a byte bound of {bound:.3f} ms "
        f"({weights / 1e9:.3f} GB of codes, fp32 meta and the bf16 head + {kv / 1e9:.3f} GB of "
        f"K/V rows on average); the server's peak {peak:.2f} GiB")
    log(f"[u] {dev_tag}: 8 decode steps of 8 slots at lengths around 260: device busy "
        f"{busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall, device {busy['device_ms']:.3f}"
        f" ms; device ms by kernel {busy['top']}; w4a8 kernels {busy['w4a8']}")
    log(f"[u] launches in the server's window ({n_steps} decode steps, {len(prompts)} prefills): "
        f"{launches}")
    if not all(same):
        raise AssertionError(f"[u] the server's ids differ from the in-process engine's in "
                             f"{len(same) - sum(same)} of {len(same)} requests")
    if not busy["w4a8"] or not all("group_mma" in k for k in busy["w4a8"]):
        raise AssertionError(f"[u] U-serve's steady steps ran the w4a8 kernels {busy['w4a8']}")
    return launches


# the bars of the 2-layer logits: phase d's (the same bf16 weights summed in
# another order; int8 activations whose roundings flip between two paths
# that differ in a last bit), phase e's with an adapter, and the fp32 route's
U_TOL = {"prefill": 2e-2, "prefill lora": 5e-2, "decode w4a8": 0.1, "fp32": TOL_FLASH_FP32}


def _u_two_layer() -> dict:
    """Kernel coverage: a 2-layer model at 7B width for each config of
    U_CONFIGS (`_two_layer`, seed 60 + 2i), and 2-bit g8 in fp32 compute; each "pallas"
    and "w4a8", without and with rank-8 adapters: `Generator` (4 prompts of
    100 tokens, 4 new, "partial") and the logits of a prefill (M = 512) and
    4 decode steps. Prefill logits against the canonical `QuantLinear`
    route (LoRALinear over it with an adapter), "pallas" decode likewise,
    "w4a8" decode against the same steps through the plain twins; the
    control, every layer with each field on the word's other group's meta
    (the twins on `_word_neighbour`), must miss each bar. Returns the launch
    window."""
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.core.peft import PeftUtils, lora_config
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    window = {}
    twins = {name: getattr(fm, name + "_plain") for name in
             ("quant_matmul", "quant_matmul_lora", "w4a8_matmul", "w4a8_lora_matmul")}

    def plain_fp32(x2, kqt, a=None, b=None):
        return (fm.quant_matmul_plain(x2, kqt) if a is None
                else fm.quant_matmul_lora_plain(x2, kqt, a, b))

    twins["qmm_fp32"] = plain_fp32

    def on_twins(word=False):
        """Every matmul wrapper replaced by its plain twin (on the word's
        other group's meta where ``word``)."""
        def swap(fn):
            def run(*args):
                args = [(_word_neighbour(v) if word and isinstance(v, fm.KernelQTensor) else v)
                        for v in args]
                return fn(*args)
            return run
        return [mock.patch.object(fm, name, swap(fn)) for name, fn in twins.items()]

    def logits_with(tree, cfg, toks, dtype, patches=()):
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            return _logits(tree, cfg, toks, dtype=dtype)

    cases = [(nbits, g, torch.bfloat16) for nbits, g in U_CONFIGS] + \
        [(U_NBITS, U_GROUP, torch.float32)]
    for i, (nbits, g, dtype) in enumerate(cases):
        cfg, base, toks = _two_layer(BaseQuantizeConfig(nbits=nbits, group_size=g), 60 + 2 * i,
                                     dtype)
        lora = containers(base)
        PeftUtils.add_lora(lora, lora_config(r=LORA_RANK, lora_alpha=LORA_ALPHA),
                           torch.Generator(device="cuda").manual_seed(70 + i))
        _fill_lora_b(lora, 80 + i)
        prompts = toks[:, :100].cpu().numpy()
        t = 128
        name = f"{nbits}-bit g{g}" + (", fp32" if dtype == torch.float32 else "")
        for adapters, tree in (("", base), (" + LoRA r=8", lora)):
            with torch.inference_mode():
                canonical = _logits(tree, cfg, toks, dtype=dtype)
            for backend in ("pallas", "w4a8"):
                prepared = prepare_for_inference(containers(tree), backend)
                ops.reset_launch_counts()
                ids = HQQModel(prepared, cfg, quantized=True).generate(
                    prompts, max_new_tokens=4, compile_mode="partial", cache_dtype=dtype)
                with torch.inference_mode():
                    got = _logits(prepared, cfg, toks, dtype=dtype)
                counts = {k: v for k, v in launch_counts().items() if v}
                for k, v in counts.items():
                    window[k] = window.get(k, 0) + v
                with torch.inference_mode():
                    control = logits_with(prepared, cfg, toks, dtype, on_twins(word=True))
                    twin = (logits_with(prepared, cfg, toks, dtype, on_twins())
                            if backend == "w4a8" else canonical)
                pre = (U_TOL["fp32"] if dtype == torch.float32
                       else U_TOL["prefill lora" if adapters else "prefill"])
                bars = {"prefill": (pre, canonical),
                        "decode": (U_TOL["decode w4a8"], twin) if backend == "w4a8"
                        else (pre, canonical)}
                errs, misses = {}, {}
                for part, (tol, ref) in bars.items():
                    sl = slice(0, t) if part == "prefill" else slice(t, None)
                    errs[part] = rel(got[:, sl], ref[:, sl])
                    misses[part] = rel(control[:, sl], ref[:, sl])
                log(f"[u] 2-layer 7B-width {name}{adapters}, {backend}: Generator ids "
                    f"{np.asarray(ids)[0].tolist()}; launches {counts}; logits rel err "
                    f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tol "
                    f"{ {k: v[0] for k, v in bars.items()} }); control, the word's other "
                    f"group, { {k: f'{v:.3e}' for k, v in misses.items()} } (must exceed it)")
                if ids.shape != (4, 4) or not torch.isfinite(got).all():
                    raise AssertionError(f"[u] {name}{adapters} {backend}: bad output")
                if not all(errs[p] <= bars[p][0] < misses[p] for p in bars):
                    raise AssertionError(f"[u] {name}{adapters} {backend}: a bar is missed or "
                                         f"its control passes")
                kernels = ({"qmm_fp32"} if dtype == torch.float32
                           else {"quant_matmul_lora" if adapters else "quant_matmul"})
                if backend == "w4a8":
                    kernels.add("w4a8_lora_matmul" if adapters else "w4a8_matmul")
                if not kernels <= set(counts) or counts.get("dequant_canonical"):
                    raise AssertionError(f"[u] {name}{adapters} {backend}: launches {counts}")
                del prepared
        del base, lora
        gc.collect()
        torch.cuda.empty_cache()
    return window


def phase_u(dev_tag: str) -> list:
    """Path U, HQQ+'s 2-bit g8 recipe: U-plus (adapters, Generator), U-serve
    (the server on the same base's checkpoint) and the 2-layer kernel
    coverage of every sub-word config. Returns the launch windows."""
    import shutil
    import tempfile

    t_u = time.time()
    root = tempfile.mkdtemp(prefix="hqq-llama2-2bit-g8-")
    try:
        windows = [_u_plus(dev_tag, root)]
        windows.append(_u_serve(dev_tag, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    windows.append(_u_two_layer())
    log(f"[u] phase u: {time.time() - t_u:.1f} s")
    return windows


def phase_d(n_layers: int = 2) -> None:
    import dataclasses
    from unittest import mock

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.models.llama import (KVCache, LlamaConfig, forward, init_cache,
                                            init_params)
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_hidden_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2), torch.bfloat16, "cuda")
    quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=64))
    t, steps = 128, 4
    toks = torch.randint(0, cfg.vocab_size, (4, t + steps), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))

    def prefill(backend_params):
        return forward(backend_params, cfg, toks[:, :t],
                       init_cache(cfg, 4, 256, torch.bfloat16, "cuda"), 0)

    def wrong(field):
        # a control: each group takes its neighbour's scale (or zs)
        def fn(x8, sx, kqt, out_dtype):
            bad = dataclasses.replace(kqt, **{field: getattr(kqt, field).roll(1, dims=1)})
            return fm.w4a8_matmul_plain(x8, sx, bad, out_dtype)
        return fn

    controls = {"scale": wrong("scale"), "zs": wrong("zs")}
    per_call = {}
    # the wrapper, taken before decode() patches its name
    held = checked(fm.w4a8_matmul, fm.w4a8_matmul_plain, controls, per_call)

    with torch.inference_mode():
        # prefill (M = 512): the pallas backend against xla
        xla_pre, _ = prefill(params)
        pal_pre, _ = prefill(prepare_for_inference(containers(params), "pallas"))

        # decode steps of M = 4 rows (the w4a8 route) from one w4a8 prefill
        a8 = prepare_for_inference(params, "w4a8")
        _, cache = prefill(a8)

        def decode(w4a8_fn):
            """Logits of the decode steps from a copy of the cache, with
            ``w4a8_fn`` in place of the w4a8 kernel's wrapper."""
            c = KVCache(k=cache.k.clone(), v=cache.v.clone())
            out = []
            with mock.patch.object(fm, "w4a8_matmul", w4a8_fn):
                for i in range(steps):
                    logits, c = forward(a8, cfg, toks[:, t + i:t + i + 1], c, t + i)
                    out.append(logits)
            return torch.cat(out, dim=1)

        a8_dec = decode(held)
        plain_dec = decode(fm.w4a8_matmul_plain)
        e2e = {"kernel": rel(a8_dec, plain_dec),
               **{f: rel(decode(fn), plain_dec) for f, fn in controls.items()}}

    r_pre = rel(pal_pre, xla_pre)
    call = {k: (min(v), max(v)) for k, v in per_call.items()}
    # pallas vs xla: the same bf16 weights; bf16 activations summed in
    # another order change some bf16 roundings, which two layers carry into
    # the logits. w4a8 kernel vs plain, call by call on the same inputs: the
    # group dots are exact, the fp32 epilogue sums in another order, then
    # one bf16 rounding of the output (2^-7 of max|y|, the bar of phase b).
    # The same, end to end: one bf16 step of an output near its row's max
    # is half an int8 step of the next layer's activations, so the paths
    # flip some roundings and then many; the bar lies between those
    # readings and the controls' (a wrong group scale or zs).
    tol_pre, tol_call, tol_e2e = 2e-2, 2.0**-7, 0.1
    log(f"[d] {n_layers}-layer 7B-width prefill logits, pallas vs xla: rel err {r_pre:.3e} "
        f"(tol {tol_pre})")
    log(f"[d] {steps} decode steps, {len(per_call['kernel'])} w4a8 calls, each vs its plain "
        f"version on the same inputs: rel err up to {call['kernel'][1]:.3e} (tol {tol_call:.3e}); "
        f"controls, neighbour's scale {call['scale'][0]:.3e} and neighbour's zs "
        f"{call['zs'][0]:.3e} at the least (must exceed it)")
    log(f"[d] {steps} decode steps, logits through the kernel vs through its plain version: "
        f"rel err {e2e['kernel']:.3e} (tol {tol_e2e}); controls, neighbour's scale "
        f"{e2e['scale']:.3e}, neighbour's zs {e2e['zs']:.3e} (must exceed it)")
    if not (torch.isfinite(pal_pre).all() and torch.isfinite(a8_dec).all()):
        raise AssertionError("non-finite logits")
    if not (r_pre < tol_pre and call["kernel"][1] <= tol_call and e2e["kernel"] < tol_e2e):
        raise AssertionError("the pallas or w4a8 path disagrees with its reference")
    if not (min(call["scale"][0], call["zs"][0]) > tol_call
            and min(e2e["scale"], e2e["zs"]) > tol_e2e):
        raise AssertionError("a bar does not catch a wrong group scale or zs")
    del params, a8, cache
    gc.collect()
    torch.cuda.empty_cache()


def _two_layer(quant_config, seed: int, dtype=torch.bfloat16):
    """A 2-layer model at 7B width, quantized, its compute in ``dtype``:
    (cfg, params, tokens [4, 132])."""
    import dataclasses

    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_hidden_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), dtype, "cuda")
    quantize_model(params, quant_config, compute_dtype=dtype)
    toks = torch.randint(0, cfg.vocab_size, (4, 132), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    return cfg, params, toks


def _logits(params, cfg, toks, t: int = 128, dtype=torch.bfloat16):
    """Logits of a prefill of ``t`` tokens (M = 4*t rows) and of the decode
    steps over the rest of ``toks``, one after the other, over a dense
    cache in ``dtype``: [4, t + steps, V]."""
    from hqq_tpu_torch.models.llama import forward, init_cache

    cache = init_cache(cfg, toks.shape[0], 256, dtype, "cuda")
    out, cache = forward(params, cfg, toks[:, :t], cache, 0)
    out = [out]
    for i in range(t, toks.shape[1]):
        logits, cache = forward(params, cfg, toks[:, i:i + 1], cache, i)
        out.append(logits)
    return torch.cat(out, dim=1)


def phase_e(dev_tag: str) -> dict:
    from unittest import mock

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.core.peft import PeftUtils, lora_config
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    qcfg = BaseQuantizeConfig(nbits=4, group_size=64)
    adapters = lora_config(r=LORA_RANK, lora_alpha=LORA_ALPHA)

    def add_adapters(params, seed):
        PeftUtils.add_lora(params, adapters, torch.Generator(device="cuda").manual_seed(seed))
        _fill_lora_b(params, seed + 1)

    n = LINEARS_PER_PASS
    launches, model, _ = serve_7b(
        "e", dev_tag, qcfg, {"quant_matmul_lora": (n, 0), "w4a8_lora_matmul": (0, n),
                             "rms_norm": (NORMS_PER_PASS, NORMS_PER_PASS)},
        after_quantize=lambda model: add_adapters(model.params, 4))

    # the control: the same call with B = 0, the adapter left out
    def lora_no_b(x2, kqt, a, b):
        return fm.quant_matmul_lora_plain(x2, kqt, a, torch.zeros_like(b))

    def a8_lora_no_b(x8, sx, kqt, xa, b, out_dtype):
        return fm.w4a8_lora_matmul_plain(x8, sx, kqt, xa, torch.zeros_like(b), out_dtype)

    check_calls("e", model, {
        "quant_matmul_lora": (fm.quant_matmul_lora_plain, {"B=0": lora_no_b}),
        "w4a8_lora_matmul": (fm.w4a8_lora_matmul_plain, {"B=0": a8_lora_no_b}),
    })
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # end to end on 2 layers: the fused modules against LoRALinear over the
    # xla path (prefill, full-precision activations), and the decode steps
    # through the kernel against the same steps through its plain version
    cfg, params, toks = _two_layer(qcfg, seed=6)
    add_adapters(params, 8)
    t = 128
    with torch.inference_mode():
        unfused = _logits(params, cfg, toks[:, :t])
        fused_params = prepare_for_inference(containers(params), "w4a8")
        fused = _logits(fused_params, cfg, toks)
        with mock.patch.object(fm, "w4a8_lora_matmul", fm.w4a8_lora_matmul_plain):
            plain = _logits(fused_params, cfg, toks)
        for layer in fused_params["layers"]:
            for block in (layer["self_attn"], layer["mlp"]):
                for mod in block.values():
                    mod.b.data.zero_()
        control = _logits(fused_params, cfg, toks)
    r_pre, c_pre = rel(fused[:, :t], unfused), rel(control[:, :t], unfused)
    r_dec, c_dec = rel(fused[:, t:], plain[:, t:]), rel(control[:, t:], plain[:, t:])
    # prefill: the same bf16 weights, but the kernel rounds A to bf16 and the
    # sum of base and adapter once, where LoRALinear multiplies A in fp32 and
    # rounds the base and the adapter's term each; two layers carry those
    # roundings into the logits (phase d's pallas-vs-xla bar, widened for
    # the adapter's). decode: the bar of phase d, int8 activations whose
    # roundings flip between two paths that differ in a last bit
    tol_pre, tol_dec = 5e-2, 0.1
    log(f"[e] 2-layer 7B-width HQQ+ model, prefill logits, fused vs LoRALinear over xla: rel "
        f"err {r_pre:.3e} (tol {tol_pre}); control B=0 {c_pre:.3e} (must exceed it)")
    log(f"[e] {toks.shape[1] - t} decode steps, logits through w4a8_lora_matmul vs through "
        f"its plain version: rel err {r_dec:.3e} (tol {tol_dec}); control B=0 {c_dec:.3e} "
        f"(must exceed it)")
    if not torch.isfinite(fused).all():
        raise AssertionError("[e] non-finite logits")
    if not (r_pre < tol_pre and r_dec < tol_dec):
        raise AssertionError("[e] the HQQ+ path disagrees with its reference")
    if not (c_pre > tol_pre and c_dec > tol_dec):
        raise AssertionError("[e] a bar does not catch a missing adapter")
    del params, fused_params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_f(dev_tag: str) -> dict:
    import dataclasses
    from unittest import mock

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    attn = BaseQuantizeConfig(nbits=3, group_size=64, axis=0)
    mlp = BaseQuantizeConfig(nbits=2, group_size=16, axis=0)
    qcfg = {f"self_attn.{p}_proj": attn for p in "qkvo"}
    qcfg.update({f"mlp.{p}_proj": mlp for p in ("gate", "up", "down")})

    def extra(model):
        w_dq = model.params["layers"][0]["mlp"]["down_proj"].dequantize()
        if tuple(w_dq.shape) != (4096, 11008) or w_dq.dtype != torch.bfloat16 \
                or not torch.isfinite(w_dq).all():
            raise AssertionError("dequantize() of a prepared axis=0 layer is wrong")

    n = LINEARS_PER_PASS
    launches, model, _ = serve_7b("f", dev_tag, qcfg, {"quant_matmul_ax0": (n, n),
                                                       "rms_norm": (NORMS_PER_PASS, NORMS_PER_PASS)},
                                  extra=extra)
    if launches["dequant"] == 0:
        raise AssertionError("the dequant kernel never launched on path F")
    layer0 = model.params["layers"][0]
    metas = {f"{type(m.kqt).__name__}:{m.kqt.scale.dtype}"
             for block in ("self_attn", "mlp") for m in layer0[block].values()}
    log(f"[f] layouts and meta types of layer 0: {sorted(metas)}")

    # the control: each group reads its neighbour's scale (the next column's)
    def wrong_scale(x2, kqt):
        bad = dataclasses.replace(kqt, scale=kqt.scale.roll(1, dims=1))
        return fm.quant_matmul_ax0_plain(x2, bad)

    check_calls("f", model, {"quant_matmul_ax0": (fm.quant_matmul_ax0_plain,
                                                  {"neighbour's scale": wrong_scale})})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # end to end on 2 layers: prefill and decode logits through the kernel
    # against the same through its plain version, and against the xla path
    cfg, params, toks = _two_layer(qcfg, seed=10)
    with torch.inference_mode():
        xla = _logits(params, cfg, toks)
        fused_params = prepare_for_inference(containers(params), "w4a8")
        fused = _logits(fused_params, cfg, toks)
        with mock.patch.object(fm, "quant_matmul_ax0", fm.quant_matmul_ax0_plain):
            plain = _logits(fused_params, cfg, toks)
        with mock.patch.object(fm, "quant_matmul_ax0", wrong_scale):
            control = _logits(fused_params, cfg, toks)
    r_plain, r_xla, c_plain = rel(fused, plain), rel(fused, xla), rel(control, plain)
    # kernel vs plain: the same bf16 weights and full-precision activations;
    # fp32 sums in another order change some bf16 roundings, which two layers
    # carry into the logits (the bar of phase d's pallas-vs-xla check). vs
    # xla the MLP's scale and zs are also rounded to bf16 (the default
    # policy for 2-bit g16), about 5e-3 of each weight: a wider bar
    tol_plain, tol_xla = 2e-2, 5e-2
    log(f"[f] 2-layer 7B-width axis=0 model, prefill and {toks.shape[1] - 128} decode steps, "
        f"logits through quant_matmul_ax0 vs through its plain version: rel err {r_plain:.3e} "
        f"(tol {tol_plain}); control, neighbour's scale {c_plain:.3e} (must exceed it); "
        f"vs the xla path {r_xla:.3e} (tol {tol_xla})")
    if not torch.isfinite(fused).all():
        raise AssertionError("[f] non-finite logits")
    if not (r_plain < tol_plain and r_xla < tol_xla):
        raise AssertionError("[f] the axis=0 path disagrees with its reference")
    if not c_plain > tol_xla:
        raise AssertionError("[f] a bar does not catch a wrong group scale")
    del params, fused_params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


G_SLOTS, G_PAGES, G_NEW = 8, 1024, 32


def _serve_paged(model, prompts, new: int, **kw):
    """Answer ``prompts`` through a PagedBatchingEngine over phase g's pool.
    Returns (outputs in request order, one record per decode call, wall
    seconds, the engine's end state)."""
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    eng = PagedBatchingEngine(model.params, model.cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                              page_size=PAGE, max_pages_per_seq=MAX_PAGES, **kw)
    records = []
    decode = eng._decode

    def timed(steps):
        live = list(eng.active)
        rows = sum(int(eng._pos[s]) + 1 for s in live)  # keys attended in the first step
        torch.cuda.synchronize()
        t0 = time.time()
        out = decode(steps)  # ends in a read-back of the tokens
        records.append(dict(steps=steps, live=len(live), rows=rows, ms=(time.time() - t0) * 1e3))
        return out

    eng._decode = timed
    torch.cuda.synchronize()
    t0 = time.time()
    uids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    state = dict(hits=eng.prefix_cache_hits, free=len(eng.free_pages))
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    outs = [out[u] for u in uids]
    vocab = model.cfg.vocab_size
    if any(len(o) != new or min(o) < 0 or max(o) >= vocab for o in outs):
        raise AssertionError(f"unexpected outputs: lengths {[len(o) for o in outs]}")
    return outs, records, wall, state


def _g_prompts(cfg, rng):
    """Phase g's 12 prompts of 64-640 random tokens."""
    return [rng.integers(0, cfg.vocab_size, int(n)) for n in rng.integers(64, 641, 12)]


def greedy_ids() -> dict:
    """``--ids``: phase g's 12 greedy requests over bf16 and int8 pages on
    phase c's model, every request's ids, to hold two checkouts to each
    other (run from both, as ``--time``)."""
    import numpy as np

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama2_7b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, "cuda")
    model = HQQModel(params, cfg)
    del params
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    model.prepare_for_inference("w4a8")
    prompts = _g_prompts(cfg, np.random.default_rng(0))
    return {name: [list(map(int, o)) for o in _serve_paged(model, prompts, G_NEW, **kw)[0]]
            for name, kw in (("bf16 pages", {}), ("int8 pages", dict(quantize_kv=True)))}


def phase_g(dev_tag: str, model) -> dict:
    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    cfg = model.cfg
    layers, n_kv = cfg.num_hidden_layers, cfg.num_key_value_heads
    rng = np.random.default_rng(0)
    prompts = _g_prompts(cfg, rng)
    weights = _step_weight_bytes(model.params)
    torch.cuda.reset_peak_memory_stats()

    # the main path's window: every count from 0, read right after
    ops.reset_launch_counts()
    runs = {}
    for name, kw in (("bf16 pages", {}), ("int8 pages", dict(quantize_kv=True))):
        before = launch_counts()["paged_attention"]
        outs, recs, wall, state = _serve_paged(model, prompts, G_NEW, **kw)
        got = launch_counts()["paged_attention"] - before
        steps = sum(r["steps"] for r in recs)
        if got != layers * steps or steps < G_NEW - 1:
            raise AssertionError(f"[g] {name}: {got} paged_attention launches in {steps} decode "
                                 f"steps, expected {layers} per step")
        if state["free"] != G_PAGES - 1:
            raise AssertionError(f"[g] {name}: {state['free']} pages free at the end")
        decode_s = sum(r["ms"] for r in recs) / 1e3
        tokens = sum(r["live"] * r["steps"] for r in recs)
        row_bytes = 2 * layers * n_kv * HEAD_DIM * (1 if kw else 2) + (8 * layers * n_kv if kw else 0)
        kv = sum(r["rows"] for r in recs) / len(recs) * row_bytes
        bound = (weights + kv) / HBM_BYTES_PER_S * 1e3
        log(f"[g] {dev_tag} {name}: 12 requests (prompts {[len(p) for p in prompts]}, "
            f"{G_NEW} new tokens each) over {G_SLOTS} slots in {wall:.2f} s; {steps} decode steps, "
            f"{got} paged_attention launches ({layers} per step); decode {tokens / decode_s:.1f} "
            f"tok/s over all slots, {decode_s / steps * 1e3:.2f} ms per step; byte bound of a step "
            f"{bound:.3f} ms ({weights / 1e9:.3f} GB of weights and meta + {kv / 1e9:.3f} GB of "
            f"K/V rows on average); ids[0][:8] {outs[0][:8]}; sha1 of all ids "
            f"{hashlib.sha1(repr([list(map(int, o)) for o in outs]).encode()).hexdigest()[:12]}")
        runs[name] = outs
    same = sum(a == b for a, b in zip(runs["bf16 pages"], runs["int8 pages"]))
    log(f"[g] int8 pages give the tokens of bf16 pages in {same} of 12 requests (not required: "
        f"the K/V rows are rounded to 8 bits)")

    # the device's share of a steady decode window: 8 live slots, 8 steps
    eng = PagedBatchingEngine(model.params, cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                              page_size=PAGE, max_pages_per_seq=MAX_PAGES)
    for _ in range(G_SLOTS):
        eng.add_request(rng.integers(0, cfg.vocab_size, 256), max_new_tokens=G_NEW)
    eng.step()
    busy = device_share(lambda: [eng.step() for _ in range(8)])
    eng.run()
    eng.close()
    del eng
    log(f"[g] {dev_tag}: 8 decode steps of 8 slots at lengths around 260: device busy "
        f"{busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall; device ms by kernel: "
        f"{busy['top']}")
    log(f"[g] {dev_tag}: 8 decode steps of 8 slots: w4a8 kernels' device ms {busy['w4a8']}")

    # prefix cache: requests that share their first 256 tokens (suffixes of
    # more than 32 tokens: see the chunked prefill below)
    head = rng.integers(0, cfg.vocab_size, 256)
    shared = [np.concatenate([head, rng.integers(0, cfg.vocab_size, int(n))])
              for n in rng.integers(64, 129, 6)]
    cached, _, wall_c, state = _serve_paged(model, shared, 16, enable_prefix_cache=True)
    uncached, _, wall_u, _ = _serve_paged(model, shared, 16)
    agree = sum(a == b for a, b in zip(cached, uncached))
    log(f"[g] prefix cache: 6 requests sharing 256 tokens: {state['hits']} pages reused, "
        f"{wall_c:.2f} s against {wall_u:.2f} s without; the same tokens in {agree} of 6 requests")
    if agree != 6:
        raise AssertionError("[g] the prefix cache changes the tokens")
    if state["hits"] != 5 * (256 // PAGE):
        raise AssertionError(f"[g] {state['hits']} prefix pages reused, expected {5 * 256 // PAGE}")

    # chunked prefill against unchunked. Every chunk here keeps more than 32
    # rows, the route of `quant_matmul`: a last chunk of 32 tokens or fewer
    # goes through the int8-activation kernel, as in `hqq_tpu`, and may then
    # round to other tokens than the unchunked prefill
    long = [rng.integers(0, cfg.vocab_size, n) for n in (600, 300, 560)]
    chunked, recs_c, _, _ = _serve_paged(model, long, 16, prefill_chunk=256)
    whole, _, _, _ = _serve_paged(model, long, 16)
    agree = sum(a == b for a, b in zip(chunked, whole))
    log(f"[g] chunked prefill (256 tokens a step): the tokens of the unchunked prefill in "
        f"{agree} of 3 requests; {sum(r['steps'] for r in recs_c)} decode steps between chunks")
    if agree != 3:
        raise AssertionError("[g] chunked prefill changes the tokens")

    # one cancel: a running request gives its pages back at once
    eng = PagedBatchingEngine(model.params, cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                              page_size=PAGE, max_pages_per_seq=MAX_PAGES)
    uids = [eng.add_request(rng.integers(0, cfg.vocab_size, 100), max_new_tokens=G_NEW)
            for _ in range(4)]
    eng.step()
    eng.step()
    free = len(eng.free_pages)
    found = (eng.cancel(uids[1]), eng.cancel(uids[1]))
    given_back = len(eng.free_pages) - free
    out = eng.run()
    end_free = len(eng.free_pages)
    eng.close()
    del eng
    log(f"[g] cancel of a running request: found {found}, {given_back} pages back at once, "
        f"{len(out[uids[1]])} tokens kept; the other three ran to {G_NEW} tokens")
    if found != (True, False) or given_back != -(-(100 + G_NEW) // PAGE) or len(out[uids[1]]) != 3 \
            or any(len(out[u]) != G_NEW for u in (uids[0], uids[2], uids[3])) \
            or end_free != G_PAGES - 1:
        raise AssertionError("[g] cancel went wrong")

    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[g] launches in the main path: {launches}; peak memory {peak:.2f} GiB")
    log(f"[g] card right after it: {card_state()}")
    gc.collect()
    torch.cuda.empty_cache()

    check_prefill_options(model, shared[:2], long[0])
    check_paged_calls(model, [p[:int(n)] for p, n in zip(prompts, rng.integers(64, 201, 8))])
    return launches


def _first_token_logits(model, prompts, **kw):
    """Serve ``prompts`` one after the other through one engine. Returns,
    for each, the logits its first token was drawn from (the last prompt
    position of its last prefill call), and the pages the prefix cache
    reused in all."""
    from hqq_tpu_torch.models import llama
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    cfg = model.cfg
    last = {}

    def fwd(params, toks, cache, pos, ptab=None):
        logits, cache = llama.forward(params, cfg, toks, cache, pos, page_indices=ptab)
        if ptab is None:  # a prefill call: a dense mini cache from position pos
            last["pos"], last["logits"] = int(pos), logits
        return logits, cache

    eng = PagedBatchingEngine(model.params, cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                              page_size=PAGE, max_pages_per_seq=MAX_PAGES, forward_fn=fwd, **kw)
    rows = []
    for p in prompts:
        eng.add_request(p, max_new_tokens=2)
        eng.run()
        rows.append(last["logits"][0, len(p) - last["pos"] - 1].clone())
    hits = eng.prefix_cache_hits
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rows, hits


def check_prefill_options(model, shared, long) -> None:
    """The prefix cache and chunked prefill change how a prompt's K/V comes
    about, not what follows from it: the logits the first token is drawn
    from, of a request served from cached prefix pages and of one prefilled
    in chunks, against the same prompt prefilled whole; the control is a
    prompt whose first 256 tokens are another's."""
    import numpy as np

    (_, cached), hits = _first_token_logits(model, shared, enable_prefix_cache=True)
    (whole_shared,), _ = _first_token_logits(model, shared[1:])
    (chunked,), _ = _first_token_logits(model, [long], prefill_chunk=256)
    (whole_long,), _ = _first_token_logits(model, [long])
    other = np.concatenate([shared[0][:256], long[256:]])
    (control,), _ = _first_token_logits(model, [other])
    r_cache, r_chunk = rel(cached, whole_shared), rel(chunked, whole_long)
    c = rel(control, whole_long)
    # a row of a tile-kernel matmul or of the dense attention does not depend
    # on how many rows go with it, and bf16 pages hold the prefix as the
    # mini cache did, so the readings are 0 while every prefill call keeps
    # more than 32 rows; the bar is that of phase d's prefill check
    tol = 2e-2
    log(f"[g] logits of the first token, full model: prefix of {hits} cached pages vs prefilled "
        f"whole: rel err {r_cache:.3e}; prefilled in chunks of 256 vs whole: {r_chunk:.3e} (tol "
        f"{tol}); control, another prompt's first 256 tokens: {c:.3e} (must exceed it)")
    if hits != 256 // PAGE:
        raise AssertionError(f"[g] {hits} prefix pages reused, expected {256 // PAGE}")
    if not (r_cache < tol and r_chunk < tol):
        raise AssertionError("[g] the prefix cache or chunked prefill changes the logits")
    if not c > tol:
        raise AssertionError("[g] the bar does not catch another prefix")


def _paged_plain(q, k, v, lens, tab, ks=None, vs=None):
    """The plain paged attention; for bf16 pages on the same values in fp32,
    so that its own rounding of the probabilities does not blur the bar."""
    from hqq_tpu_torch.ops import paged as pa

    if ks is None:
        q, k, v = q.float(), k.float(), v.float()
    return pa.paged_attention_plain(q, k, v, lens, tab, ks, vs)


def _paged_shorter(q, k, v, lens, tab, ks=None, vs=None):  # the newest key left out
    return _paged_plain(q, k, v, lens - 1, tab, ks, vs)


def _paged_other_page(q, k, v, lens, tab, ks=None, vs=None):  # a neighbour slot's first page
    tab = tab.clone()
    tab[:, 0] = tab[:, 0].roll(1)
    return _paged_plain(q, k, v, lens, tab, ks, vs)


# the controls of every paged_attention call held on a path
PAGED_CONTROLS = {"lengths - 1": _paged_shorter, "another slot's page": _paged_other_page}


def check_paged_calls(model, prompts) -> None:
    """Three decode steps of 8 live slots of the full model, over bf16 and
    over int8 pages, every paged_attention call held on the spot to its plain
    version on the path's own q, pool and block table (for bf16 pages on
    their values in fp32); each control must miss the bar in every call."""
    from unittest import mock

    from hqq_tpu_torch.ops import paged as pa
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    def neighbour_scale(q, k, v, lens, tab, ks, vs):  # each K row takes the next row's scale
        return _paged_plain(q, k, v, lens, tab, ks.roll(1, dims=2), vs)

    for name, kw, tol, controls in (
            ("bf16 pages", {}, TOL_PAGED_BF16_VS_FP32, PAGED_CONTROLS),
            ("int8 pages", dict(quantize_kv=True), TOL_PAGED_INT8,
             {**PAGED_CONTROLS, "neighbour row's scale": neighbour_scale})):
        per_call = {}
        eng = PagedBatchingEngine(model.params, model.cfg, batch_slots=G_SLOTS, num_pages=G_PAGES,
                                  page_size=PAGE, max_pages_per_seq=MAX_PAGES, **kw)
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
        with mock.patch.object(pa, "paged_attention",
                               checked(pa.paged_attention, _paged_plain, controls, per_call)):
            eng.run()
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        worst = max(per_call["kernel"])
        least = {c: min(v) for c, v in per_call.items() if c != "kernel"}
        log(f"[g] {name}: {len(per_call['kernel'])} paged_attention calls of 3 decode steps "
            f"(8 slots, lengths {[len(p) for p in prompts]} and on), each vs its plain version on "
            f"the same inputs: rel err up to {worst:.3e} (tol {tol:.3e}); controls at the least "
            f"{least} (must exceed it)")
        if not worst <= tol:
            raise AssertionError(f"[g] paged_attention disagrees with its plain version ({name})")
        if not all(v > tol for v in least.values()):
            raise AssertionError(f"[g] the bar does not catch a control ({name})")


def _a8_two_layer(seed: int):
    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    cfg, params, toks = _two_layer(BaseQuantizeConfig(nbits=4, group_size=64), seed=seed)
    return cfg, prepare_for_inference(params, "w4a8"), toks


def phase_g_two_layer() -> None:
    """On a 2-layer model at 7B width: the logits of paged decode steps (the
    dense prefill copied into pages, then `forward` over the pool) against
    the dense-cache steps on the same tokens."""
    from hqq_tpu_torch.models.llama import KVCache, forward, init_cache
    from hqq_tpu_torch.ops.paged import PagedKVCache, init_paged_cache
    from hqq_tpu_torch.serving.paged import splice_prefill_into_pages

    cfg, a8, toks = _a8_two_layer(seed=20)
    b, t, steps = toks.shape[0], 100, 8
    tab = torch.zeros((b, 8), dtype=torch.int32, device="cuda")
    tab[:, :7] = 1 + torch.arange(b * 7, dtype=torch.int32, device="cuda").reshape(b, 7)
    readings = {}
    with torch.inference_mode():
        cache = init_cache(cfg, b, 256, torch.bfloat16, "cuda")
        _, cache = forward(a8, cfg, toks[:, :t], cache, 0)
        pools = {}
        for name, int8 in (("bf16 pages", False), ("int8 pages", True)):
            pc = init_paged_cache(cfg, 1 + b * 7, PAGE, torch.bfloat16, quantize_kv=int8)
            for s in range(b):
                mini = KVCache(k=cache.k[:, s:s + 1], v=cache.v[:, s:s + 1])
                splice_prefill_into_pages(pc, mini, tab[s, :7].tolist(), t)
            pools[name] = pc
        # the control: every slot reads and writes its neighbour's pages
        pools["control"] = PagedKVCache(k=pools["bf16 pages"].k.clone(),
                                        v=pools["bf16 pages"].v.clone(), page_size=PAGE)
        dense = []
        for i in range(steps):
            logits, cache = forward(a8, cfg, toks[:, t + i:t + i + 1], cache, t + i)
            dense.append(logits)
        dense = torch.cat(dense, dim=1)
        for name, pc in pools.items():
            table = tab.roll(1, dims=0) if name == "control" else tab
            out = []
            for i in range(steps):
                lengths = torch.full((b,), t + i, dtype=torch.int32, device="cuda")
                logits, pc = forward(a8, cfg, toks[:, t + i:t + i + 1], pc, lengths,
                                     page_indices=table)
                out.append(logits)
            out = torch.cat(out, dim=1)
            if not torch.isfinite(out).all():
                raise AssertionError(f"[g] non-finite logits ({name})")
            readings[name] = rel(out, dense)
    # paged vs dense on the same weights and tokens: the kernel keeps the
    # probabilities in fp32 where the dense path rounds them to bf16, and one
    # bf16 step of an attention output is half an int8 step of the next
    # linear's activations, so some roundings flip and two layers carry them
    # into the logits (the bar of phase d's decode check); int8 pages add
    # the rounding of every K/V row to 8 bits
    tol = 0.1
    log(f"[g] 2-layer 7B-width model, {steps} decode steps after a {t}-token prefill, logits of "
        f"the paged path vs the dense-cache path: rel err {readings['bf16 pages']:.3e} over bf16 "
        f"pages, {readings['int8 pages']:.3e} over int8 pages (tol {tol}); control, the "
        f"neighbour slot's pages {readings['control']:.3e} (must exceed it)")
    if not (readings["bf16 pages"] < tol and readings["int8 pages"] < tol):
        raise AssertionError("[g] the paged path disagrees with the dense-cache path")
    if not readings["control"] > tol:
        raise AssertionError("[g] the bar does not catch another slot's pages")
    del a8, cache, pools
    gc.collect()
    torch.cuda.empty_cache()


def _flash_shifted(q, k, v, causal=True, sm_scale=None):
    """The control of the flash checks: the plain version with the causal
    mask shifted by one, so that every query also sees the key after it."""
    from hqq_tpu_torch.ops import attention as at

    t = q.shape[2]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    visible = torch.ones((t, t), dtype=torch.bool, device=q.device).tril(diagonal=1)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    mask = torch.where(visible, zero, torch.finfo(torch.float32).min)[None, None]
    return at._naive(q, k, v, mask, q.shape[3]**-0.5 if sm_scale is None else sm_scale)


H_TOKENS, H_WINDOW, H_STRIDE = 4096, 1024, 512


def phase_h(dev_tag: str, model) -> dict:
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.models import llama
    from hqq_tpu_torch.ops import attention as at
    from hqq_tpu_torch.utils.eval import loglikelihood, perplexity

    cfg = model.cfg
    layers = cfg.num_hidden_layers
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, H_TOKENS)
    seconds = []

    def timed_forward(params, cfg_, tokens):
        torch.cuda.synchronize()
        t0 = time.time()
        out = llama.forward(params, cfg_, tokens)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    # the main path's window: every count from 0, read right after
    ops.reset_launch_counts()
    t0 = time.time()
    ppl = perplexity(model.params, cfg, ids, max_length=H_WINDOW, stride=H_STRIDE,
                     forward_fn=timed_forward)
    total_s = time.time() - t0
    launches = launch_counts()
    windows = len(seconds)
    log(f"[h] launches in the main path: {launches}")
    if windows != 7 or launches["flash_attention"] != layers * windows \
            or launches["quant_matmul"] != 7 * layers * windows:
        raise AssertionError(f"[h] {windows} windows, {launches['flash_attention']} "
                             f"flash_attention and {launches['quant_matmul']} quant_matmul "
                             f"launches; expected 7, {layers} and {7 * layers} per window")
    if not (np.isfinite(ppl) and 1e3 < ppl < 1e6):
        raise AssertionError(f"[h] perplexity {ppl} of a random model over random ids")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[h] {dev_tag}: perplexity over {H_TOKENS} random ids, windows of {H_WINDOW} by "
        f"{H_STRIDE}: {windows} windows of T = {H_WINDOW - 1}, {layers} flash_attention and "
        f"{7 * layers} quant_matmul (M = {H_WINDOW - 1}) launches each; first window "
        f"{seconds[0]:.3f} s, the others {sum(seconds[1:]) / (windows - 1):.3f} s each, "
        f"{total_s:.2f} s in all; perplexity {ppl:.1f} (vocabulary {cfg.vocab_size}); peak "
        f"memory {peak:.2f} GiB")
    busy = device_share(lambda: loglikelihood(model.params, cfg, ids[None, :H_WINDOW]))
    log(f"[h] {dev_tag}: one window: device busy {busy['busy_share']:.3f} of "
        f"{busy['wall_ms']:.1f} ms wall; device ms by kernel: {busy['top']}")
    log(f"[h] card right after it: {card_state()}")

    # one window call by call: the kernel against its plain version on the
    # path's own q, k and v; the control shifts the mask by one
    per_call = {}
    with mock.patch.object(at, "flash_attention",
                           checked(at.flash_attention, at.flash_attention_plain,
                                   {"mask shifted by one": _flash_shifted}, per_call)):
        loglikelihood(model.params, cfg, ids[None, :H_WINDOW])
    worst, least = max(per_call["kernel"]), min(per_call["mask shifted by one"])
    log(f"[h] flash_attention: {len(per_call['kernel'])} calls of one window, each vs its plain "
        f"version on the same inputs: rel err up to {worst:.3e} (tol {TOL_FLASH_BF16:.3e}); "
        f"control, the mask shifted by one, at the least {least:.3e} (must exceed it)")
    if not worst <= TOL_FLASH_BF16:
        raise AssertionError("[h] flash_attention disagrees with its plain version")
    if not least > TOL_FLASH_BF16:
        raise AssertionError("[h] the bar does not catch a shifted mask")
    return launches


# the speculative phase: k, the generator's new tokens, the draft's layers,
# the engines' new tokens; the near-tie rule's bar in logits
V_K, V_NEW, V_DRAFT_LAYERS, V_ENGINE_NEW = 4, 64, 2, 16
# A verify window's logits and a decode step's over the same ids come from
# two routes: the engines' windows run the w4a8 kernel at M = 32 (a token
# tile of 32) where their steps run M = 8, whose K slices fold the fp32
# sums in another order. That moves a last bit (one bf16 step) of some bf16
# outputs, which the next layer's int8 activations (steps of 1/127 of a
# row's largest value) turn into flipped roundings, 32 layers over. How far
# that grows is measured, not derived: `--windows` on this model read a
# largest |logit gap| of 0.2344 between the two routes over 128 rows (M = 5
# against M = 1, the generator's: 0, bit-equal; H100 80GB HBM3, 700 W).
# Where the window picks token a and the step's argmax is b, the step's
# logit of a lies under its top by at most a's gap and b's gap together, so
# the bar is twice that reading, rounded up: 0.5, 16 bf16 steps of a top
# logit in [4, 8) and 32 in [2, 4), where this model's top logits lie.
NEAR_TIE_BAR = 0.5
# the multi-LoRA phase: adapters of the stack (their seeds), requests' adapters, new tokens
M_SEEDS, M_ADAPTERS, M_NEW, M_PAGES = (1, 2, 3), (0, 1, 2, 0, 1, 2), 8, 256


def _near_tie(tag: str, got, choices, logits) -> dict:
    """The near-tie rule, by teacher forcing: ``choices`` [n] and ``logits``
    [n, V] are the plain decode's own greedy choice and logits at each new
    token after the prompt and ``got``'s tokens before it. Every token of
    ``got`` must be that choice, or lie within NEAR_TIE_BAR of the row's top
    logit: the first parting and every token after it are checked, each on
    its own prefix. Returns the first parting's position (None where there
    is none), the number of tokens parted and the largest distance under the
    top of a parted token; raises past the bar."""
    got = [int(t) for t in got]
    choices = [int(t) for t in choices]
    if len(got) != len(choices):
        raise AssertionError(f"[{tag}] {len(got)} ids against {len(choices)} forced steps")
    parted = [i for i, (a, b) in enumerate(zip(got, choices)) if a != b]
    found = dict(position=parted[0] if parted else None, parted=len(parted), worst=0.0)
    if not parted:
        return found
    top = torch.topk(logits, 2)
    picked = logits.gather(1, torch.tensor(got, device=logits.device)[:, None])[:, 0]
    below = (top.values[:, 0] - picked).tolist()
    j = parted[0]
    found["worst"] = max(below[i] for i in parted)
    log(f"[{tag}] parts from the plain decode at new token {j}: {got[j]} for {choices[j]}; the "
        f"target's top two there {top.indices[j].tolist()}, gap "
        f"{(top.values[j, 0] - top.values[j, 1]).item():.4f}; the chosen token "
        f"{below[j]:.4f} under the top; {len(parted)} of its {len(got)} tokens part, each on its "
        f"own prefix, the furthest {found['worst']:.4f} under its top (bar {NEAR_TIE_BAR})")
    if found["worst"] > NEAR_TIE_BAR:
        raise AssertionError(f"[{tag}] a token lies {found['worst']:.4f} under the target's top "
                             f"logit on its own prefix, past the near-tie bar {NEAR_TIE_BAR}")
    return found


def _shifted_control(tag: str, outs, forced) -> None:
    """The near-tie rule's control: each request's ids shifted by one
    position (what a window one row off would emit), against the same
    forced logits, must fail the rule: some token past the bar in every
    request."""
    within = total = caught = 0
    for got, (_, logits) in zip(outs, forced):
        top = logits.max(-1).values[:-1]
        nxt = torch.tensor([int(t) for t in got[1:]], device=logits.device)
        below = top - logits[:-1].gather(1, nxt[:, None])[:, 0]
        within += int((below <= NEAR_TIE_BAR).sum())
        total += below.numel()
        caught += bool((below > NEAR_TIE_BAR).any())
    log(f"[{tag}] control, the ids shifted by one position: the rule rejects {caught} of "
        f"{len(outs)} requests (must be all; {within} of {total} tokens within the bar, the "
        f"random model's top logits lie close together)")
    if caught != len(outs):
        raise AssertionError(f"[{tag}] the near-tie rule passes ids shifted by one")


def _forced_generator(params, cfg, prompt, got):
    """`Generator`'s route (a prefill into a dense cache of its length,
    then one-token steps at a 0-d device position) teacher-forced on
    ``got``: (the greedy choices [n], the logits [n, V] in fp32)."""
    from hqq_tpu_torch.models.llama import forward, init_cache
    from hqq_tpu_torch.serving.generate import next_power_of_2

    dev = params["embed_tokens"].device
    t, n = len(prompt), len(got)
    cache = init_cache(cfg, 1, next_power_of_2(t + n + 1), torch.bfloat16, dev)
    toks = torch.zeros((1, next_power_of_2(max(t, 2))), dtype=torch.long, device=dev)
    toks[0, :t] = torch.as_tensor(prompt, device=dev)
    with torch.inference_mode():
        rows = [forward(params, cfg, toks, cache, 0)[0][0, t - 1]]
        for i in range(n - 1):
            step = torch.tensor([[int(got[i])]], device=dev)
            rows.append(forward(params, cfg, step, cache,
                                torch.tensor(t + i, device=dev))[0][0, -1])
    logits = torch.stack(rows).float()
    return logits.argmax(-1).tolist(), logits


def _eager_round_launches(spec, cache_len: int) -> dict:
    """The launches of one round run eagerly on fresh buffers of
    ``cache_len`` (the graph's plain twin)."""
    st = spec._new_state(cache_len)
    before = launch_counts()
    with torch.inference_mode():
        spec._round(st)
    torch.cuda.synchronize()
    after = launch_counts()
    del st
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _w4a8_rows():
    """A stand-in for the operand step of the w4a8 wrappers that records
    each launch's M (rows), and the list it records into. The wrapper
    itself stays in place and counts its own launches."""
    from hqq_tpu_torch.ops import fused_matmul as fm

    operands, rows = fm._w4a8_operands, []

    def fn(x8, *args):
        rows.append(x8.shape[0])
        return operands(x8, *args)

    return fn, rows


def _teacher_forcing(eng, module, forced_outs):
    """Patches that make the plain engine ``eng`` (of ``module``) emit
    ``forced_outs`` [request][token] in place of its own greedy choices,
    each request in the order it was added, and record at every token the
    engine's own choice and its logits row. Returns (the patches, the
    records by request: [(choice, logits)])."""
    from unittest import mock

    first, batch = module.sample_token, module.sample_token_batch
    admit, decode = eng._admit, eng._decode
    index, records, state = {}, [[] for _ in forced_outs], dict(req=None, j=0)

    def forced_admit(slot, req):
        state["req"] = index.setdefault(req.uid, len(index))
        return admit(slot, req)

    def forced_first(logits, *args, **kw):
        tok = first(logits, *args, **kw)
        i = state["req"]
        records[i].append((tok[0], logits[0]))
        return torch.full_like(tok, int(forced_outs[i][0]))

    def forced_decode(steps):
        state["j"] = 0
        return decode(steps)

    def forced_batch(logits, *args, **kw):
        tok = batch(logits, *args, **kw)
        slots, toks = [], []
        for slot, req in eng.active.items():
            i = index[req.uid]
            n = len(req.output) + state["j"]
            if n < len(forced_outs[i]):
                records[i].append((tok[slot], logits[slot]))
                slots.append(slot)
                toks.append(int(forced_outs[i][n]))
        state["j"] += 1
        out = tok.clone()
        out[slots] = torch.tensor(toks, dtype=out.dtype).to(out.device)
        return out

    patches = [mock.patch.object(eng, "_admit", forced_admit),
               mock.patch.object(eng, "_decode", forced_decode),
               mock.patch.object(module, "sample_token", forced_first),
               mock.patch.object(module, "sample_token_batch", forced_batch)]
    return patches, records


def _v_engine(kind: str, spec: bool, params, draft, cfg, dcfg, prompts, new: int,
              forced_outs=None):
    """Serve ``prompts`` through one of the four engines of phase v (dense
    or paged, speculative or plain) on phase c's tree. A plain engine given
    ``forced_outs`` is teacher-forced on them (`_teacher_forcing`). Returns
    (outputs in request order, wall seconds, decode steps or verify steps,
    the engine's fallback steps, the w4a8 rows per call of one verify step,
    the device's busy share of 4 steps with every slot live, the forced
    records: per request (choices, fp32 logits [n, V]))."""
    import contextlib
    from unittest import mock

    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.serving import batching, paged
    from hqq_tpu_torch.serving.speculative import (SpeculativeBatchingEngine,
                                                   SpeculativePagedEngine)

    if kind == "dense":
        kw = dict(batch_slots=G_SLOTS, max_len=1024)
        eng = (SpeculativeBatchingEngine(params, draft, cfg, draft_cfg=dcfg, k_draft=V_K, **kw)
               if spec else batching.ContinuousBatchingEngine(params, cfg, **kw))
    else:
        kw = dict(batch_slots=G_SLOTS, num_pages=G_PAGES, page_size=PAGE,
                  max_pages_per_seq=MAX_PAGES)
        eng = (SpeculativePagedEngine(params, draft, cfg, draft_cfg=dcfg, k_draft=V_K, **kw)
               if spec else paged.PagedBatchingEngine(params, cfg, **kw))
    patches, records = ([], None) if forced_outs is None else _teacher_forcing(
        eng, batching if kind == "dense" else paged, forced_outs)
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        uids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
        steps, rows, busy = 0, [], None
        inner = eng._eng if spec else eng
        while inner.queue or inner.active or getattr(inner, "_prefilling", None):
            if steps == 2 and spec:  # a verify step with every slot live: its rows per w4a8 call
                fn, rows = _w4a8_rows()
                with mock.patch.object(fm, "_w4a8_operands", fn):
                    eng.step()
            elif steps == 3:
                busy = device_share(lambda: [eng.step() for _ in range(4)])
                steps += 3
            else:
                eng.step()
            steps += 1
    torch.cuda.synchronize()
    wall = time.time() - t0
    out = eng.finished
    outs = [out[u].output for u in uids]
    fallback = getattr(eng, "fallback_steps", 0)
    eng.close()
    del eng
    forced = None
    if records is not None:
        forced = [(torch.stack([c for c, _ in r]).tolist(),
                   torch.stack([row for _, row in r]).float()) for r in records]
    gc.collect()
    torch.cuda.empty_cache()
    return outs, wall, steps, fallback, rows, busy, forced


def _window_rows_bit_equal(params, cfg, seq, t0: int, windows: int) -> float:
    """The share of verify-window rows whose logits are bit-equal to those
    of one-token decode steps over the same ids ``seq`` [T] after a prefill
    of ``t0``: windows of V_K + 1 rows (M = 5, the w4a8 kernel's token tile
    of 8 as at M = 1) against single steps, both over the dense cache."""
    from hqq_tpu_torch.models.llama import forward, init_cache
    from hqq_tpu_torch.serving.generate import next_power_of_2

    w = V_K + 1
    n = windows * w
    out = []
    for rows in (1, w):
        cache = init_cache(cfg, 1, next_power_of_2(t0 + n), torch.bfloat16, "cuda")
        with torch.inference_mode():
            forward(params, cfg, seq[None, :t0], cache, 0)
            logits = [forward(params, cfg, seq[None, i:i + rows], cache,
                              torch.tensor(i, device="cuda"))[0][0]
                      for i in range(t0, t0 + n, rows)]
        out.append(torch.cat(logits))
    return (out[0] == out[1]).all(-1).float().mean().item()


def _add_counts(window: dict, counts: dict) -> None:
    for k, v in counts.items():
        window[k] = window.get(k, 0) + v


def phase_v(dev_tag: str, model) -> dict:
    """Speculative decoding on phase c's model. Returns the launches of its
    main path: the speculative runs alone, each counted from 0 just before
    it and read just after (the plain references and the checks left out)."""
    import dataclasses

    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.serving.generate import _to_numpy
    from hqq_tpu_torch.serving.speculative import SpeculativeGenerator

    cfg, params = model.cfg, model.params
    layers = cfg.num_hidden_layers
    dcfg = dataclasses.replace(cfg, num_hidden_layers=V_DRAFT_LAYERS)
    drafts = {"perfect": (params, cfg),
              "layer-skip": (dict(params, layers=params["layers"][:V_DRAFT_LAYERS]), dcfg)}
    prompt = _prompts(cfg)[0]
    t0_all = time.time()
    torch.cuda.reset_peak_memory_stats()
    window = {}

    ref = model.generate(prompt[None], max_new_tokens=V_NEW)  # the plain decode as a graph
    # RMSNorm sums in fp64 (`models.llama.rms_norm`), and the w4a8 kernel
    # takes M = 1 and M = 5 through one plan: a window row is a decode step
    seq = torch.cat([torch.as_tensor(prompt), torch.as_tensor(ref[0])]).long().cuda()
    same = _window_rows_bit_equal(params, cfg, seq, prompt.shape[0], 6)
    log(f"[v] {6 * (V_K + 1)} rows of 6 verify windows (M = {V_K + 1}) against one-token "
        f"decode steps over the same ids: logits bit-equal in a share {same:.3f}; "
        f"{time.time() - t0_all:.1f} s into phase v")
    if same != 1.0:
        raise AssertionError("[v] a verify window's logits differ from decode steps'")
    torch.cuda.synchronize()
    t0 = time.time()
    model.generate(prompt[None], max_new_tokens=V_NEW)
    torch.cuda.synchronize()
    plain_tok_s = V_NEW / (time.time() - t0)
    model.release_graphs()
    results = {}
    for name, (dparams, dc) in drafts.items():
        spec = SpeculativeGenerator(params, dparams, cfg, k=V_K, draft_cfg=dc)
        ops.reset_launch_counts()
        ids = spec.generate(prompt, max_new_tokens=V_NEW)  # captures the round
        torch.cuda.synchronize()
        t0 = time.time()
        ids2 = spec.generate(prompt, max_new_tokens=V_NEW)
        torch.cuda.synchronize()
        tok_s = V_NEW / (time.time() - t0)
        _add_counts(window, launch_counts())
        if not np.array_equal(ids, ids2):
            raise AssertionError(f"[v] {name}: two greedy generates differ")
        share = spec.accepted / (spec.rounds * V_K)
        (cache_len, cap), = spec.captures().items()
        eager = _eager_round_launches(spec, cache_len)
        st = spec._graphs[cache_len]
        busy = device_share(lambda: [(st.graph.replay(), _to_numpy(st.packed))
                                     for _ in range(4)])
        parting = None
        if not np.array_equal(ids[0], ref[0]):  # teacher-forced through Generator's route
            choices, logits = _forced_generator(params, cfg, prompt, ids[0])
            parting = _near_tie(f"v {name}", ids[0], choices, logits)
            del logits
        results[name] = dict(share=share, tok_s=tok_s, rounds=spec.rounds, parting=parting)
        log(f"[v] {dev_tag} {name} draft (k={V_K}): {V_NEW} greedy ids "
            f"{'equal to' if parting is None else 'by the near-tie rule against'} the plain "
            f"decode's; {spec.rounds} rounds, accepted share {share:.3f} of the proposals; "
            f"{tok_s:.1f} tok/s against the plain graph's {plain_tok_s:.1f} (whole generates, "
            f"prefill included); a round's graph records {cap['launches']} launches, an eager "
            f"round makes {eager} (capture {cap['seconds']:.2f} s); 4 replayed rounds: device "
            f"busy {busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms wall, device ms by "
            f"kernel {busy['top']}; {time.time() - t0_all:.1f} s into phase v")
        if cap["launches"] != eager:
            raise AssertionError(f"[v] {name}: the round's graph recorded {cap['launches']} "
                                 f"launches, an eager round makes {eager}")
        spec.release_graphs()
        del spec, st
    if results["perfect"]["share"] < 0.9:
        raise AssertionError(f"[v] the perfect draft accepted {results['perfect']['share']:.3f} "
                             f"of its proposals, under 0.9")
    sampled = SpeculativeGenerator(params, drafts["layer-skip"][0], cfg, k=V_K, draft_cfg=dcfg,
                                   do_sample=True, temperature=1.0, seed=1)
    ops.reset_launch_counts()
    s_ids = sampled.generate(prompt, max_new_tokens=16)
    _add_counts(window, launch_counts())
    if s_ids.shape != (1, 16) or s_ids.min() < 0 or s_ids.max() >= cfg.vocab_size:
        raise AssertionError(f"[v] unexpected sampled ids {s_ids}")
    log(f"[v] sampled (temperature 1.0, seed 1, layer-skip draft): {s_ids[0].tolist()}, "
        f"accepted share {sampled.accepted / (sampled.rounds * V_K):.3f}")
    del sampled
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[v] the generator's checks: {time.time() - t0_all:.1f} s")
    # the engines on 8 of phase g's requests, those of at most 512 tokens
    # (a dense slot of 1024 rows takes a 512-token bucket), 16 new tokens;
    # the 87-token prompt cut to 80, so that its new tokens end on the last
    # row of its 6th page and its last windows do not fit: the fallback
    g = [p for p in _g_prompts(cfg, np.random.default_rng(0)) if len(p) <= 512][:8]
    g = [p[:80] if len(p) == 87 else p for p in g]
    draft, _ = drafts["layer-skip"]
    new = V_ENGINE_NEW
    for kind in ("dense", "paged"):
        ops.reset_launch_counts()
        outs, wall, steps, fallback, rows, busy, _ = _v_engine(kind, True, params, draft, cfg,
                                                               dcfg, g, new)
        spec_counts = launch_counts()
        _add_counts(window, spec_counts)
        # the plain engine on the same tree, teacher-forced on the speculative ids
        _, p_wall, p_steps, _, _, p_busy, forced = _v_engine(kind, False, params, None, cfg,
                                                             None, g, new, forced_outs=outs)
        partings = [_near_tie(f"v {kind} engine, request {i}", a, *f)
                    for i, (a, f) in enumerate(zip(outs, forced))]
        _shifted_control(f"v {kind} engine", outs, forced)
        del forced
        verify_rows = sorted(set(rows[-7 * layers:]))  # the target's calls, after the draft's
        log(f"[v] {dev_tag} {kind} speculative engine (layer-skip draft, k_draft={V_K}, 8 slots): "
            f"8 requests (prompts {[len(p) for p in g]}, {new} new) in {steps} steps, "
            f"{wall:.2f} s, {8 * new / wall:.1f} tok/s; the plain engine (teacher-forced on the "
            f"speculative ids) {p_steps} steps, {p_wall:.2f} s, {8 * new / p_wall:.1f} tok/s; busy "
            f"share of 4 steps {busy['busy_share']:.3f} of {busy['wall_ms']:.1f} ms (plain "
            f"{p_busy['busy_share']:.3f} of {p_busy['wall_ms']:.1f} ms); ids equal to the plain "
            f"engine's in {sum(p['position'] is None for p in partings)} of 8, the others by the "
            f"near-tie rule ({sum(p['parted'] for p in partings)} of {8 * new} tokens part, each "
            f"on its own prefix, the furthest {max(p['worst'] for p in partings):.4f} under its "
            f"top); launches {spec_counts}; a verify step's w4a8 calls: the draft's at rows "
            f"{sorted(set(rows[:-7 * layers]))}, the target's at {verify_rows}; fallback steps "
            f"{fallback}; {time.time() - t0_all:.1f} s into phase v")
        if verify_rows != [G_SLOTS * V_K] or len(rows) != 7 * layers + (V_K - 1) * 7 * V_DRAFT_LAYERS:
            raise AssertionError(f"[v] {kind}: a verify step made {len(rows)} w4a8 calls, the "
                                 f"target's at rows {verify_rows}, expected {G_SLOTS * V_K}")
        # every step a verify step (the draft's k - 1 steps and the target's
        # window) or, in the paged engine, a plain step for want of room
        per_verify = 7 * layers + (V_K - 1) * 7 * V_DRAFT_LAYERS
        want = {"w4a8_matmul": (steps - fallback) * per_verify + fallback * 7 * layers}
        if kind == "paged":
            want["paged_attention"] = (steps - fallback) * V_K * layers + fallback * layers
            if fallback < 1:
                raise AssertionError("[v] the paged engine never fell back to a plain step")
        got = {k: spec_counts.get(k, 0) for k in want}
        log(f"[v] {kind}: launches {got} in {steps - fallback} verify and {fallback} plain "
            f"steps ({per_verify} w4a8 and {V_K * layers} paged_attention a verify step)")
        if got != want:
            raise AssertionError(f"[v] {kind}: launches {got}, expected {want}")
    log(f"[v] launches in the main path (the speculative runs alone): {window}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase v {time.time() - t0_all:.1f} s")
    return window


def _lora_tree(params, seed: int):
    """New dicts and lists over ``params``' leaves, every kernel-layout
    linear but lm_head wrapped in a rank-8 LoRALinear, A from ``seed``, B
    from ``seed`` (`_fill_lora_b`)."""
    from hqq_tpu_torch.core.peft import LoRALinear

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def wrap(node, path):
        if isinstance(node, dict):
            return {k: wrap(v, f"{path}.{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [wrap(v, f"{path}.{i}") for i, v in enumerate(node)]
        if hasattr(node, "kqt") and "lm_head" not in path:
            return LoRALinear.wrap(node, r=LORA_RANK, lora_alpha=LORA_ALPHA, generator=gen,
                                   device="cuda")
        return node

    tree = wrap(params, "")
    _fill_lora_b(tree, seed)
    return tree


def _m_run(tree, cfg, prompts, adapters, new: int, profile: bool = False):
    """Serve ``prompts`` with their ``adapters`` through one paged engine.
    Returns (outputs in request order, decode seconds, decode tokens, the
    profile of a decode window when asked)."""
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    eng = PagedBatchingEngine(tree, cfg, batch_slots=G_SLOTS, num_pages=M_PAGES, page_size=PAGE,
                              max_pages_per_seq=MAX_PAGES)
    decode, spent = eng._decode, []

    def timed(steps):
        live = len(eng.active)
        torch.cuda.synchronize()
        t0 = time.time()
        out = decode(steps)
        spent.append((time.time() - t0, live * steps))
        return out

    eng._decode = timed
    uids = [eng.add_request(p, max_new_tokens=new, adapter_id=a) for p, a in zip(prompts, adapters)]
    prof = None
    if profile:
        eng.step()  # every request admitted
        kept = len(spent)
        prof = _profile_ops(lambda: [eng.step() for _ in range(4)])
        del spent[kept:]  # the profiled steps' time is not the engine's
    out = eng.run()
    eng.close()
    outs = [out[u] for u in uids]
    if any(len(o) != new for o in outs):
        raise AssertionError(f"[m] unexpected output lengths {[len(o) for o in outs]}")
    return outs, sum(s for s, _ in spent), sum(n for _, n in spent), prof


def _profile_ops(fn) -> dict:
    """{op or kernel name: (calls, device ms)} of ``fn`` under
    torch.profiler: the device time of a host op is that of the kernels it
    launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, (getattr(e, "device_time_total", None)
                             or getattr(e, "cuda_time_total", 0.0)) / 1e3)
            for e in prof.key_averages()}


def phase_m(dev_tag: str, model) -> dict:
    """Multi-LoRA serving on phase c's model. Returns the launches of its
    main path: the mixed batch and the server, each counted alone."""
    import threading
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch import ops
    from hqq_tpu_torch.nn.multilora import MultiLoRALinear, stack_adapters
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine
    from hqq_tpu_torch.serving.server import InferenceServer

    cfg, base = model.cfg, model.params
    t0_all = time.time()
    torch.cuda.reset_peak_memory_stats()
    before_mem = torch.cuda.memory_allocated()
    multi = stack_adapters([_lora_tree(base, s) for s in M_SEEDS], base)
    gc.collect()
    stacks = sum(m.a_stack.numel() + m.b_stack.numel() for layer in multi["layers"]
                 for block in (layer["self_attn"], layer["mlp"]) for m in block.values()
                 if isinstance(m, MultiLoRALinear))
    log(f"[m] {len(M_SEEDS)} rank-{LORA_RANK} adapters stacked over the w4a8 base: "
        f"{stacks * 4 / 2**20:.1f} MiB of stacks, "
        f"{(torch.cuda.memory_allocated() - before_mem) / 2**20:.1f} MiB allocated")
    prompts = [p[:256] for p in _g_prompts(cfg, np.random.default_rng(1))[:len(M_ADAPTERS)]]

    bmm, calls = torch.bmm, [0]

    def counted_bmm(*args):  # the library product has no launch count of its own
        calls[0] += 1
        return bmm(*args)

    # the main path: the mixed batch and the server, each counted from 0
    # just before it and read just after (the neighbour checks left out)
    window = {}
    ops.reset_launch_counts()
    with mock.patch.object(torch, "bmm", counted_bmm):
        mixed, dec_s, dec_tok, prof = _m_run(multi, cfg, prompts, M_ADAPTERS, M_NEW, True)
    _add_counts(window, launch_counts())
    # each adapter's requests again, every other slot carrying another adapter
    alone = [None] * len(prompts)
    for a in sorted(set(M_ADAPTERS)):
        others = [(a + 1 + i % 2) % len(M_SEEDS) for i in range(len(prompts))]
        adapters = [a if b == a else o for b, o in zip(M_ADAPTERS, others)]
        outs, _, _, _ = _m_run(multi, cfg, prompts, adapters, M_NEW)
        for i, b in enumerate(M_ADAPTERS):
            if b == a:
                alone[i] = outs[i]
    # the same requests over HTTP, all at once
    srv = InferenceServer(PagedBatchingEngine(multi, cfg, batch_slots=G_SLOTS,
                                              num_pages=M_PAGES, page_size=PAGE,
                                              max_pages_per_seq=MAX_PAGES), port=0).start()
    ops.reset_launch_counts()
    try:
        answers = [None] * len(prompts)

        def ask(i):
            answers[i] = _http(srv.port, "POST", "/generate", {
                "prompt_ids": [int(t) for t in prompts[i]], "max_new_tokens": M_NEW,
                "adapter_id": M_ADAPTERS[i]})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
        with mock.patch.object(torch, "bmm", counted_bmm):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        refused = _http(srv.port, "POST", "/generate",
                        {"prompt_ids": [1, 2, 3], "adapter_id": len(M_SEEDS)})
    finally:
        srv.stop()
        srv.engine.close()
    _add_counts(window, launch_counts())
    bmm_calls = calls[0]
    launches = window
    base_outs, base_s, base_tok, _ = _m_run(base, cfg, prompts, [0] * len(prompts), M_NEW)
    same_alone = sum(a == b for a, b in zip(mixed, alone))
    same_http = sum(a is not None and a[0] == 200 and a[1]["tokens"] == b
                    for a, b in zip(answers, mixed))
    differ = len({tuple(o) for o in mixed[:3]})
    bmm_ms = prof.get("aten::bmm", (0, 0.0))
    w4a8_ms = sum(ms for key, (_, ms) in prof.items() if re.search(r"w4a8_\w+_kernel", key))
    log(f"[m] {dev_tag}: 6 requests (prompts {[len(p) for p in prompts]}, {M_NEW} new) on "
        f"adapters {list(M_ADAPTERS)} through one paged engine: each request's ids equal to a "
        f"run where every other slot carries another adapter in {same_alone} of 6 (exact); "
        f"over HTTP equal in {same_http} of 6; adapter {len(M_SEEDS)} answered {refused[0]}; "
        f"{differ} different outputs on the 3 adapters' first requests")
    log(f"[m] {dev_tag}: decode {dec_tok / dec_s:.1f} tok/s against the bare base's "
        f"{base_tok / base_s:.1f} (same requests, adapter 0 of nothing); torch.bmm called "
        f"{bmm_calls} times in the window (the mixed batch and the server; 2 a MultiLoRALinear call); 4 decode steps of 6 "
        f"slots under the profiler: aten::bmm {bmm_ms[0]} calls, {bmm_ms[1]:.3f} device ms, "
        f"the w4a8 kernels {w4a8_ms:.3f} device ms; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if same_alone != len(prompts):
        raise AssertionError("[m] a request's ids depend on its neighbours' adapters")
    if same_http != len(prompts) or refused[0] != 400:
        raise AssertionError(f"[m] the server's answers differ: {answers}, {refused}")
    if differ != 3:
        raise AssertionError("[m] the adapters give the same ids")
    if bmm_calls == 0 or launches.get("w4a8_matmul", 0) == 0:
        raise AssertionError("[m] the adapters' products or the base's kernel never ran")
    del multi, srv
    gc.collect()
    torch.cuda.empty_cache()
    phase_m_two_layer()
    log(f"[m] phase m {time.time() - t0_all:.1f} s")
    return launches


def phase_m_two_layer() -> None:
    """On a 2-layer model at 7B width (4-bit g64, w4a8): each row of a
    mixed batch (rows on adapters 0, 1, 2) against that row alone through
    its own adapter's LoRALinear over the same base; the control puts every
    row on adapter 0 and must miss the bar on rows 1 and 2."""
    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.models.llama import forward
    from hqq_tpu_torch.nn.multilora import adapter_context, stack_adapters
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    cfg, params, toks = _two_layer(BaseQuantizeConfig(nbits=4, group_size=64), seed=40)
    base = prepare_for_inference(params, "w4a8")
    loras = [_lora_tree(base, s) for s in M_SEEDS]
    multi = stack_adapters(loras, base)
    x = toks[:3, :8]  # M = 24 rows: the w4a8 route
    with torch.inference_mode():
        with adapter_context(torch.arange(3, device="cuda")):
            mixed = forward(multi, cfg, x)[0]
        with adapter_context(torch.zeros(3, dtype=torch.long, device="cuda")):
            control = forward(multi, cfg, x)[0]
        alone = [forward(loras[i], cfg, x[i:i + 1])[0][0] for i in range(3)]
    errs = [rel(mixed[i], alone[i]) for i in range(3)]
    ctrl = [rel(control[i], alone[i]) for i in range(3)]
    # the base rows through the same kernel at M = 24 and 8, the adapter's
    # term by torch.bmm against torch.matmul in fp32 with the scaling folded
    # into B: some bf16 roundings move, which the next layer's int8
    # activations carry on (phase d's decode bar)
    tol = 0.1
    log(f"[m] 2-layer 7B-width w4a8 model, 3 rows of 8 tokens on adapters 0, 1, 2: each row "
        f"against itself alone through its adapter's LoRALinear, rel err {errs} (tol {tol}); "
        f"control, every row on adapter 0: {ctrl} (rows 1 and 2 must exceed it)")
    if not (torch.isfinite(mixed).all() and max(errs) < tol):
        raise AssertionError("[m] a row of the mixed batch disagrees with its adapter alone")
    if not min(ctrl[1:]) > tol:
        raise AssertionError("[m] the bar does not catch a row on another adapter")
    del params, base, loras, multi
    gc.collect()
    torch.cuda.empty_cache()


def phase_h_two_layer() -> None:
    """On a 2-layer model at 7B width: cache=None logits against the
    dense-cache forward of the same tokens, and the perplexity through the
    kernel against the one through its plain version."""
    from unittest import mock

    import numpy as np

    from hqq_tpu_torch.models.llama import forward, init_cache
    from hqq_tpu_torch.ops import attention as at
    from hqq_tpu_torch.utils.eval import perplexity

    cfg, a8, _ = _a8_two_layer(seed=30)
    t = H_WINDOW - 1
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, 2048)
    toks = torch.from_numpy(ids[None, :t]).to("cuda")
    with torch.inference_mode():
        nocache, _ = forward(a8, cfg, toks)
        dense, _ = forward(a8, cfg, toks, init_cache(cfg, 1, H_WINDOW, torch.bfloat16, "cuda"), 0)
        with mock.patch.object(at, "flash_attention", _flash_shifted):
            control, _ = forward(a8, cfg, toks)
    ppl = perplexity(a8, cfg, ids, max_length=H_WINDOW, stride=H_STRIDE)
    with mock.patch.object(at, "flash_attention", at.flash_attention_plain):
        ppl_plain = perplexity(a8, cfg, ids, max_length=H_WINDOW, stride=H_STRIDE)
    r, c = rel(nocache, dense), rel(control, dense)
    r_ppl = abs(ppl - ppl_plain) / ppl_plain
    # the same bf16 weights and full-precision activations on both sides; the
    # kernel rounds its probabilities before the division by their sum and the
    # dense path after it, and sums in another order: some bf16 roundings
    # change, which two layers carry into the logits (the bar of phase d's
    # pallas-vs-xla check). The perplexity averages those over 2047 targets.
    tol, tol_ppl = 2e-2, 2e-3
    log(f"[h] 2-layer 7B-width model, T = {t}: cache=None logits vs the dense-cache forward: rel "
        f"err {r:.3e} (tol {tol}); control, the mask shifted by one {c:.3e} (must exceed it); "
        f"perplexity over 2048 ids through the kernel {ppl:.2f} vs through its plain version "
        f"{ppl_plain:.2f}: rel diff {r_ppl:.3e} (tol {tol_ppl})")
    if not torch.isfinite(nocache).all():
        raise AssertionError("[h] non-finite logits")
    if not (r < tol and r_ppl < tol_ppl):
        raise AssertionError("[h] the cache-free path disagrees with its reference")
    if not c > tol:
        raise AssertionError("[h] the bar does not catch a shifted mask")
    del a8
    gc.collect()
    torch.cuda.empty_cache()


# path I: HQQ+ LoRA training, hqq_tpu's recipe at Llama-2-7B width and depth
I_TOKENS, I_STEPS, I_RANK, I_ALPHA, I_LR = 1025, 4, 8, 8, 1e-3


def _train_counts(window: dict, counts: dict) -> None:
    for name, n in counts.items():
        window[name] = window.get(name, 0) + n


def phase_i(dev_tag: str) -> dict:
    """Path I: quantize_model (4-bit g64 axis=1, bf16 compute, the canonical
    QuantLinear on the "xla" path), PeftUtils.add_lora (r = 8, alpha 8,
    fp32 A/B) on the 224 linears, TrainableParams, make_lora_train_step with
    AdamW(lr=1e-3, weight_decay=0) for 4 steps on one batch of 1 x 1025 ids
    (T = 1024 after the shift), then PeftUtils.merge_lora. Every step's
    launch counts from 0: 32 each of the flash forward and the two backward
    kernels, and 445 of the canonical dequant kernel (224 linears forward,
    221 backward); the plain dequantization never runs, and the profile of a
    fifth step holds none of its kernels. Returns the launches of the 4
    steps."""
    from unittest import mock

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.core.peft import LoRALinear, PeftUtils, TrainableParams, lora_config
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.models.llama import LlamaConfig, forward, init_params
    from hqq_tpu_torch.nn.linear import QuantLinear
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.utils.training import make_lora_train_step

    cfg = LlamaConfig.llama2_7b()
    layers = cfg.num_hidden_layers
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, "cuda")
    t0 = time.time()
    quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=64))
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    PeftUtils.add_lora(params, lora_config(r=I_RANK, lora_alpha=I_ALPHA),
                       generator=torch.Generator(device="cuda").manual_seed(1))
    trainable = TrainableParams(params)
    n_train = sum(v.numel() for v in trainable.values())
    optimizer = torch.optim.AdamW(trainable.values(), lr=I_LR, weight_decay=0.0)
    step = make_lora_train_step(cfg, trainable, optimizer)
    batch = torch.randint(0, cfg.vocab_size, (1, I_TOKENS), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(2))
    gc.collect()
    log(f"[i] {layers} layers quantized in {quant_s:.1f} s; {len(trainable.paths)} trainable "
        f"leaves, {n_train} values; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    window, losses, step_s = {}, [], []
    # the canonical dequant, once per quantized linear in the forward and once
    # in the backward of each linear whose input carries a gradient: all but
    # layer 0's q, k and v projections, which read the frozen embedding's
    # normed output (tests/test_torch_dequant_plan.py counts it on a tiny model)
    linears = len(trainable.paths) // 2
    expect = {"flash_attention": layers, "flash_attention_backward_dkv": layers,
              "flash_attention_backward_dq": layers, "dequant_canonical": 2 * linears - 3}
    with mock.patch.object(fm, "dequantize_plain", wraps=fm.dequantize_plain) as plain_calls:
        for i in range(I_STEPS):
            # the main path's window: every count from 0, read right after
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            loss = step(params, batch)
            torch.cuda.synchronize()
            step_s.append(time.time() - t0)
            counts = launch_counts()
            _train_counts(window, counts)
            losses.append(loss.item())
            per = {k: counts[k] for k in expect}
            log(f"[i] step {i + 1}: loss {losses[-1]:.5f}, {step_s[-1] * 1e3:.1f} ms, "
                f"launches {per}")
            if per != expect:
                raise AssertionError(f"[i] step {i + 1}: launches {per}, expected {expect}")
    if plain_calls.call_count:
        raise AssertionError(f"[i] the plain dequantization ran {plain_calls.call_count} times "
                             f"on the card")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(lambda x: x == x and abs(x) < 1e4, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[i] losses {losses}: not finite, or not lower after step "
                             f"{I_STEPS} than at step 1")
    ms = sorted(s * 1e3 for s in step_s[1:])[len(step_s[1:]) // 2]
    busy = device_share(lambda: step(params, batch))  # a fifth step, under the profiler
    log(f"[i] {dev_tag}: Llama-2-7B 4-bit g64 + LoRA r={I_RANK} on {linears} "
        f"linears, T = {I_TOKENS - 1}: step {ms:.1f} ms (median of steps 2-{I_STEPS}), "
        f"{(I_TOKENS - 1) / ms * 1e3:.1f} tokens/s; losses {losses}; peak memory {peak:.2f} "
        f"GiB; a fifth step under the profiler: device busy {busy['busy_share']:.3f} of "
        f"{busy['wall_ms']:.1f} ms wall; device ms by kernel: {busy['top']}")
    # the plain dequantization's unpacking (a uint8 shift and mask) runs
    # nowhere else in the step
    dq = {k: v for k, v in busy["by_name"].items() if "hqq_dequant_canonical_kernel" in k}
    unpack = [k for k in busy["by_name"]
              if "rshift_kernel_cuda" in k or "BitwiseAndFunctor<unsigned char>" in k]
    log(f"[i] the fifth step: {busy['device_ms']:.3f} ms of device time, "
        f"{sum(dq.values()):.3f} ms of it in the canonical dequant kernel "
        f"({expect['dequant_canonical']} launches: {sorted(k[:90] for k in dq)}); kernels of "
        f"the plain dequantization: {unpack or 'none'}")
    if not dq or unpack:
        raise AssertionError("[i] the step's profile lacks the canonical dequant kernel, or "
                             "holds the plain dequantization's")
    log(f"[i] card right after it: {card_state()}")
    del optimizer, step
    for v in trainable.values():
        v.grad = None
    t0 = time.time()
    PeftUtils.merge_lora(params)
    torch.cuda.synchronize()
    merged = [x for layer in params["layers"] for sub in layer.values() if isinstance(sub, dict)
              for x in sub.values()]
    if not all(isinstance(x, QuantLinear) for x in merged) or \
            any(isinstance(x, LoRALinear) for x in merged):
        raise AssertionError("[i] merge_lora left a layer unmerged")
    with torch.no_grad():
        logits, _ = forward(params, cfg, batch[:, :64])
    if not torch.isfinite(logits).all():
        raise AssertionError("[i] non-finite logits after merge_lora")
    log(f"[i] merge_lora of {len(merged)} linears: {time.time() - t0:.1f} s; the merged model's "
        f"logits are finite")
    del params, trainable, logits
    gc.collect()
    torch.cuda.empty_cache()
    return window


# LoRA gradients through the kernels against the same model with the plain
# attention backward: bf16, the backward's outputs rounded once on both
# sides, so some of their bf16 roundings flip and two layers carry them (the
# bar of phase d's pallas-vs-xla check); fp32, sums in another order
TOL_I_GRADS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _i_two_layer(dtype, seed: int, quant_config=None, lora_tags=None):
    """A 2-layer model at 7B width, quantized with compute in ``dtype``,
    LoRA r = 8 on the linears of ``lora_tags`` (all but lm_head when None),
    B filled from a seed (a zero B leaves dA = 0)."""
    import dataclasses

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.core.peft import PeftUtils, lora_config
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_hidden_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), dtype, "cuda")
    quantize_model(params, quant_config or BaseQuantizeConfig(nbits=4, group_size=64),
                   compute_dtype=dtype)
    lcfg = lora_config(r=I_RANK, lora_alpha=I_ALPHA)
    PeftUtils.add_lora(params, lcfg if lora_tags is None else {t: lcfg for t in lora_tags},
                       generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    _fill_lora_b(params, seed + 2)
    return cfg, params


def phase_i_two_layer() -> dict:
    """On 2-layer models at 7B width: (1) the LoRA gradients of one training
    step through the kernels against the plain attention backward, in bf16
    and in fp32 (the fp32 forward and backward kernels), with a control that
    must miss the bar (D dropped); (2) fp32 HQQ+ serving, "pallas":
    attention 4-bit g64 axis=1 with adapters, MLP 2-bit g16 axis=0, a
    cache-free forward at T = 512 through qmm_fp32 and flash_attention_fp32,
    logits against the same served layers through the plain versions, and a
    control that rounds the matmuls' activations to bf16. Returns the
    launches of the fp32 runs."""
    from unittest import mock

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.core.peft import TrainableParams
    from hqq_tpu_torch.models.llama import forward
    from hqq_tpu_torch.ops import attention as at
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.utils.patching import prepare_for_inference
    from hqq_tpu_torch.utils.training import causal_lm_loss

    window = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg, params = _i_two_layer(dtype, seed=40)
        trainable = TrainableParams(params)
        vals = trainable.values()
        batch = torch.randint(0, cfg.vocab_size, (1, I_TOKENS), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(43))

        def grads(backward=None):
            for v in vals:
                v.grad = None
            with mock.patch.object(at, "flash_attention_backward",
                                   backward or at.flash_attention_backward):
                causal_lm_loss(params, cfg, batch).backward()
            return [v.grad.clone() for v in vals]

        ops.reset_launch_counts()
        kernel = grads()
        counts = launch_counts()
        suffix = "" if dtype == torch.bfloat16 else "_fp32"
        per = {k + suffix: counts[k + suffix] for k in (
            "flash_attention", "flash_attention_backward_dkv", "flash_attention_backward_dq")}
        if any(v != 2 for v in per.values()):
            raise AssertionError(f"[i] 2-layer step: launches {per}, expected 2 each")
        if dtype == torch.float32:
            _train_counts(window, counts)
            # the device time of the step's backward kernels (flash_bwd_fp32_kernel)
            bwd = _device_events([grads], 1, "flash_bwd_fp32")
            log(f"[i] 2-layer 7B-width fp32 step: its backward kernels took "
                + (f"{sum(e.self_device_time_total for e in bwd) / 1e3:.4f} ms of device time in "
                   f"{sum(e.count for e in bwd)} launches" if bwd else
                   "a time not measured (the profiler kept no device event of this run)"))

        def plain_backward(q, k, v, o, lse, do, causal=True, sm_scale=None):
            return at.flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm_scale)

        plain = grads(plain_backward)
        control = grads(_no_d)

        def worst(gs):
            return max(rel(g, r) for g, r in zip(gs, plain))

        tol = TOL_I_GRADS[dtype]
        name = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}[dtype]
        log(f"[i] 2-layer 7B-width, {name} compute, T = {I_TOKENS - 1}: {len(vals)} LoRA "
            f"gradients through the kernels vs the plain attention backward: rel err up to "
            f"{worst(kernel):.3e} (tol {tol}); control, D dropped, {worst(control):.3e} (must "
            f"exceed it); launches {per}")
        if not all(torch.isfinite(g).all() for g in kernel) or not worst(kernel) <= tol:
            raise AssertionError(f"[i] {name} LoRA gradients disagree with the plain backward")
        if not worst(control) > tol:
            raise AssertionError(f"[i] the {name} gradient bar does not catch D dropped")
        del params, trainable, vals, kernel, plain, control
        gc.collect()
        torch.cuda.empty_cache()

    attn = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj")
    mlp = ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
    qc = {**{t: BaseQuantizeConfig(nbits=4, group_size=64) for t in attn},
          **{t: BaseQuantizeConfig(nbits=2, group_size=16, axis=0) for t in mlp}}
    cfg, params = _i_two_layer(torch.float32, seed=50, quant_config=qc, lora_tags=attn)
    toks = torch.randint(0, cfg.vocab_size, (1, 512), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(53))
    with torch.no_grad():
        served = prepare_for_inference(containers(params), "pallas")
        ops.reset_launch_counts()
        got, _ = forward(served, cfg, toks)
        counts = launch_counts()
        _train_counts(window, counts)

        def plain_route(x2, kqt, a=None, b=None, dtype=torch.float32):
            x2 = x2.to(dtype)
            if isinstance(kqt, fm.KernelQTensor0):
                return fm.quant_matmul_ax0_plain(x2, kqt).float()
            if a is None:
                return fm.quant_matmul_plain(x2, kqt).float()
            return fm.quant_matmul_lora_plain(x2, kqt, a, b).float()

        with mock.patch.object(fm, "qmm_fp32", plain_route), \
                mock.patch.object(at, "flash_attention", at.flash_attention_plain):
            ref, _ = forward(served, cfg, toks)
        with mock.patch.object(fm, "qmm_fp32",
                               lambda *a: plain_route(*a, dtype=torch.bfloat16)):
            control, _ = forward(served, cfg, toks)
        fwd_ms = time_ms([lambda: forward(served, cfg, toks)], 3)
        qmm_ms = time_ms([lambda: forward(served, cfg, toks)], 3, only="qmm_fp32")
    per = {k: counts[k] for k in ("qmm_fp32", "flash_attention_fp32")}
    r, c = rel(got, ref), rel(control, ref)
    log(f"[i] 2-layer 7B-width fp32 HQQ+ serving, T = 512: device time {fwd_ms:.3f} ms per "
        f"forward, {qmm_ms:.3f} ms of it in the 14 qmm_fp32 launches")
    log(f"[i] 2-layer 7B-width fp32 HQQ+ serving (pallas; attention 4-bit g64 + LoRA r=8, MLP "
        f"2-bit g16 axis=0, bf16 meta), T = 512: logits vs the same layers through the plain "
        f"versions: rel err {r:.3e} (tol "
        f"{TOL_FLASH_FP32}); control, activations rounded to bf16 in the matmuls, {c:.3e} (must "
        f"exceed it); launches {per}")
    if per != {"qmm_fp32": 14, "flash_attention_fp32": 2}:
        raise AssertionError(f"[i] fp32 serving launches {per}, expected 14 and 2")
    if not torch.isfinite(got).all() or not r <= TOL_FLASH_FP32:
        raise AssertionError("[i] fp32 serving disagrees with the plain path")
    if not c > TOL_FLASH_FP32:
        raise AssertionError("[i] the fp32 serving bar does not catch a bf16 cast")
    del params, served
    gc.collect()
    torch.cuda.empty_cache()
    return window


# path I's step at Gemma-7B's widths (google/gemma-7b config.json: hidden
# 3072, 16 heads and 16 kv heads of 256, intermediate 24576, vocab 256000),
# cut to 2 layers: the fp32 backward kernels at head size 256
I_GEMMA = dict(hidden_size=3072, intermediate_size=24576, num_attention_heads=16,
               num_key_value_heads=16, head_dim=256, vocab_size=256000, num_hidden_layers=2)


def phase_i_gemma(dev_tag: str) -> dict:
    """Path I at Gemma-7B's widths, 2 layers, fp32 compute (the `gemma`
    family: embeddings scaled, (1 + w) norms, GeGLU, the tied head), 4-bit
    g64 with LoRA r = 8 on every linear: the LoRA gradients of one step
    through `causal_lm_loss` (with `gemma.forward`) against the same step
    with the plain attention backward, the control D dropped; then two
    steps of `make_lora_train_step` (AdamW), the loss finite. Each pass
    makes 2 launches of the fp32 forward and of each fp32 backward kernel,
    at head size 256: the cluster route. Returns the launches."""
    import functools
    from unittest import mock

    from hqq_tpu_torch import BaseQuantizeConfig, ops
    from hqq_tpu_torch.core.peft import PeftUtils, TrainableParams, lora_config
    from hqq_tpu_torch.models import gemma
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.ops import attention as at
    from hqq_tpu_torch.utils.training import causal_lm_loss, make_lora_train_step

    t0 = time.time()
    cfg = gemma.GemmaConfig(**I_GEMMA)
    params = gemma.init_params(cfg, torch.Generator(device="cuda").manual_seed(60),
                               torch.float32, "cuda")
    quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=64),
                   compute_dtype=torch.float32)
    PeftUtils.add_lora(params, lora_config(r=I_RANK, lora_alpha=I_ALPHA),
                       generator=torch.Generator(device="cuda").manual_seed(61))
    _fill_lora_b(params, 62)
    trainable = TrainableParams(params)
    vals = trainable.values()
    batch = torch.randint(0, cfg.vocab_size, (1, I_TOKENS), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(63))
    loss_fn = functools.partial(causal_lm_loss, forward=gemma.forward)
    plan = at.flash_backward_launch_plan(1, 16, 16, I_TOKENS - 1, 256)
    if plan.fp32_route != "wgmma_cluster":
        raise AssertionError(f"[i] Gemma's backward plan: {plan.fp32_route}")

    def grads(backward=None):
        for v in vals:
            v.grad = None
        with mock.patch.object(at, "flash_attention_backward",
                               backward or at.flash_attention_backward):
            loss_fn(params, cfg, batch).backward()
        return [v.grad.clone() for v in vals]

    names = ("flash_attention_fp32", "flash_attention_backward_dkv_fp32",
             "flash_attention_backward_dq_fp32")
    window = {}
    ops.reset_launch_counts()
    kernel = grads()
    counts = launch_counts()
    _train_counts(window, counts)
    per = {k: counts[k] for k in names}
    if any(v != 2 for v in per.values()):
        raise AssertionError(f"[i] Gemma-width step: launches {per}, expected 2 each")
    bwd = _device_events([grads], 1, "flash_bwd_fp32")
    plain = grads(lambda q, k, v, o, lse, do, causal=True, sm_scale=None:
                  at.flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm_scale))
    control = grads(_no_d)

    def worst(gs):
        return max(rel(g, r) for g, r in zip(gs, plain))

    tol = TOL_I_GRADS[torch.float32]
    log(f"[i] {dev_tag} 2-layer Gemma-7B-width (3072, 16/16 heads of 256, 24576, vocab "
        f"256000), fp32 compute, T = {I_TOKENS - 1}: {len(vals)} LoRA gradients through the "
        f"kernels vs the plain attention backward: rel err up to {worst(kernel):.3e} (tol "
        f"{tol}); control, D dropped, {worst(control):.3e} (must exceed it); launches {per}; "
        f"the backward kernels "
        + (f"{sum(e.self_device_time_total for e in bwd) / 1e3:.4f} ms of device time in "
           f"{sum(e.count for e in bwd)} launches" if bwd else "not timed (no device event)"))
    if not all(torch.isfinite(g).all() for g in kernel) or not worst(kernel) <= tol:
        raise AssertionError("[i] Gemma-width fp32 LoRA gradients disagree with the plain "
                             "backward")
    if not worst(control) > tol:
        raise AssertionError("[i] the Gemma-width gradient bar does not catch D dropped")
    del kernel, plain, control
    optimizer = torch.optim.AdamW(vals, lr=I_LR, weight_decay=0.0)
    step = make_lora_train_step(cfg, trainable, optimizer, loss_fn=loss_fn)
    losses = []
    for _ in range(2):
        ops.reset_launch_counts()
        losses.append(step(params, batch).item())
        counts = launch_counts()
        _train_counts(window, counts)
        if {k: counts[k] for k in names} != per:
            raise AssertionError(f"[i] Gemma-width train step: launches "
                                 f"{ {k: counts[k] for k in names} }, expected {per}")
    log(f"[i] Gemma-width make_lora_train_step: losses {losses}; phase {time.time() - t0:.1f} s")
    if not all(x == x and abs(x) < 1e4 for x in losses):
        raise AssertionError(f"[i] Gemma-width losses {losses}: not finite")
    del params, trainable, vals, optimizer, step
    gc.collect()
    torch.cuda.empty_cache()
    return window


# --time quant_matmul_ax0|dequant_ax0 M K N [CONFIG [VARIANT]]: NBITS-G-META, META
# fp32 or bf16; VARIANT builds quant_matmul_ax0.cu without one of its two
# designs (csrc/qmm_sm90.cuh `Ax0Layout`), for what each buys
AX0_TIME_DEFAULT = "2-16-bf16"
AX0_VARIANTS = {"element-stores": "-DHQQ_AX0_RUN_STORES=0",
                "meta-per-row": "-DHQQ_AX0_SHARED_META=0"}


# --time w4a8_matmul|w4a8_lora_matmul M K N NBITS-G-META VARIANT builds
# w4a8_matmul.cu's small-group route without one part of its work
# (`HQQ_W4A8_GROUP_VARIANT`), for what each costs: its results are wrong
# (or, as ring-S or tile-R-S, launches it with S ring slots, or R rows and S
# k-slices a block, in place of the plan's)
W4A8_VARIANTS = {"no-fold": "-DHQQ_W4A8_GROUP_VARIANT=1", "no-mma": "-DHQQ_W4A8_GROUP_VARIANT=2",
                 "no-meta": "-DHQQ_W4A8_GROUP_VARIANT=3", "loads-only": "-DHQQ_W4A8_GROUP_VARIANT=4"}


def _w4a8_plan_variant(how: str) -> None:
    """ring-S: the small-group plan with S ring slots; tile-R-S: with R rows
    and S k-slices a block (the ring the plan's, or S slots if fewer)."""
    import dataclasses

    from hqq_tpu_torch.ops import fused_matmul as fm

    plan_of = fm.w4a8_launch_plan
    words = how.split("-")

    def plan(m, n, k, cb, g, meta=torch.float32):
        p = plan_of(m, n, k, cb, g, meta)
        if p.route != "group_mma":
            return p
        rows, slices, stages = p.col_tile, p.k_slices, p.stages
        if words[0] == "ring":
            stages = int(words[1])
        else:
            rows, slices = int(words[1]), int(words[2])
            stages = max(slices, stages // slices * slices)
        smem = fm.w4a8_group_smem(p.stage_codes, p.token_tile, rows, p.meta_boxes,
                                  fm.w4a8_group_pieces(g), slices, stages)
        return dataclasses.replace(p, col_tile=rows, k_slices=slices, stages=stages, smem=smem,
                                   grid=(-(-n // rows),))

    fm.w4a8_launch_plan = plan


# --time paged_attention B LEN H KV TYPE:VARIANT builds or launches the paged
# kernel without one part of its design, for what each part buys
PAGED_VARIANTS = ("global-scales", "copy", "head-blocks")


def _paged_variant(how: str) -> None:
    """global-scales: each row's scales read from device memory in the key
    loop (a library of its own); copy: every page by the producer lanes'
    cp.async, no bulk copy; head-blocks: one block per query head, each
    reading its kv head's pages."""
    import dataclasses

    from hqq_tpu_torch.ops import _build
    from hqq_tpu_torch.ops import paged as pa

    if how == "global-scales":
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DHQQ_PAGED_GLOBAL_SCALES=1",)
        return
    plan_of = pa.paged_launch_plan

    def plan(b, nh, n_kv, hd, pg, mp, dtype):
        p = plan_of(b, nh, n_kv, hd, pg, mp, dtype)
        if how == "copy":
            return dataclasses.replace(p, bulk=False)
        pairs = b * nh
        splits = max(1, min(pa._SMS * (pa._SM_WARPS // p.warps) // pairs, p.splits))
        return dataclasses.replace(
            p, heads_per_block=1, splits=splits,
            smem=pa.paged_smem_bytes(hd * pa._PAGE_BYTES[dtype], pg, p.pages_per_stage, p.stages,
                                     dtype == torch.int8, 1, hd, p.warps))

    pa.paged_launch_plan = plan


# --time flash_attention_backward_dkv_fp32|_dq_fp32 B T H KV-HD VARIANT builds
# flash_backward_fp32_sm90.cu without one part of its work
# (`HQQ_BWD_FP32_VARIANT`), for where its time goes: its results are wrong
BWD_FP32_VARIANTS = {"no-swap": "-DHQQ_BWD_FP32_VARIANT=1", "no-second": "-DHQQ_BWD_FP32_VARIANT=2"}


def time_norm(kernel: str, rows: int, d: int, dtype: str) -> dict:
    """``--time layer_norm|rms_norm ROWS D D [bf16|fp32]``: the wrapper over
    ``rows`` rows of ``d`` (a bias, or offset 0) and, in the same process,
    its PyTorch call (F.layer_norm, F.rms_norm), three timings each as phase
    b takes them (inputs rotated past the L2). Uses only what the norm
    module has had since it was ported, so that the script can time an
    older checkout's kernel (run a copy of it from that checkout's root)."""
    import torch.nn.functional as F

    from hqq_tpu_torch.ops import norm as nm

    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn((rows, d), generator=gen, device="cuda") + 1).to(dt)
    w = (1 + torch.randn(d, generator=gen, device="cuda") * 0.1).to(dt)
    b = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dt)
    each = 2 * x.numel() * x.element_size()
    xs = [x] + [x.clone() for _ in range(max(1, min(64, -(-ROTATE_BYTES // each))) - 1)]
    if kernel == "layer_norm":
        def call(a):
            return nm.layer_norm(a, w, b, 1e-5)

        def lib(a):
            return F.layer_norm(a, (d,), w, b, 1e-5)
    else:
        def call(a):
            return nm.rms_norm(a, w, 1e-6, 0.0)

        def lib(a):
            return F.rms_norm(a, (d,), w, 1e-6)
    ms = [time_ms([lambda a=a: call(a) for a in xs], 100) for _ in range(3)]
    lib_ms = [time_ms([lambda a=a: lib(a) for a in xs], 100) for _ in range(3)]
    return dict(kernel=kernel, rows=rows, d=d, dtype=dtype, ms=ms, library_ms=lib_ms)


def time_one(kernel: str, m: int, k: int, n: int, extra: "str | None" = None,
             variant: "str | None" = None) -> dict:
    """Three phase-b timings of one wrapper at one shape (``--time``).
    ``extra``: the LoRA rank, the kv heads of the attention kernels, or the
    axis=0 config (``AX0_TIME_DEFAULT``); for qmm_fp32 (fp32 x, 4-bit g64
    axis=1) a LoRA rank or an axis=0 config; for dequant and
    dequant_canonical the config NBITS-G-META of an axis=1 weight (default
    4-64-fp32), as for w4a8_matmul and w4a8_lora_matmul (for these a rank
    otherwise). ``variant``: one of ``AX0_VARIANTS``, for quant_matmul_ax0;
    the page type (bf16 or int8) for paged_attention; for the w4a8 pair
    names of ``W4A8_VARIANTS``, ring-S and tile-R-S joined by commas; for
    the fp32 backward one of ``BWD_FP32_VARIANTS``. layer_norm and
    rms_norm: `time_norm`."""
    from hqq_tpu_torch.ops import _build
    from hqq_tpu_torch.ops import fused_matmul as fm

    if kernel in ("layer_norm", "rms_norm"):  # rows, d, d [dtype]
        return time_norm(kernel, m, k, extra or "bf16")
    if variant is not None and kernel.startswith("flash_attention_backward"):
        if variant not in BWD_FP32_VARIANTS or not kernel.endswith("_fp32"):
            raise SystemExit(f"the fp32 backward's variants are {sorted(BWD_FP32_VARIANTS)}")
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + (BWD_FP32_VARIANTS[variant],)  # its own library
    elif variant is not None and kernel.startswith("w4a8"):  # several joined by commas
        for how in variant.split(","):
            if how.startswith(("ring-", "tile-")):
                _w4a8_plan_variant(how)
            elif how not in W4A8_VARIANTS:
                raise SystemExit(f"the w4a8 variants are {sorted(W4A8_VARIANTS)}, ring-S, tile-R-S")
            else:
                _build.NVCC_FLAGS = _build.NVCC_FLAGS + (W4A8_VARIANTS[how],)  # a library of its own
    elif variant is not None and kernel != "paged_attention":
        if kernel != "quant_matmul_ax0" or variant not in AX0_VARIANTS:
            raise SystemExit(f"variants are quant_matmul_ax0's: {sorted(AX0_VARIANTS)}")
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + (AX0_VARIANTS[variant],)  # a library of its own
    if kernel in ("dequant", "dequant_canonical"):  # W [N, K] to bf16; M unused
        from hqq_tpu_torch.core.quantize import quantize

        nbits, g, meta = (extra or "4-64-fp32").split("-")
        meta = {"fp32": torch.float32, "bf16": torch.bfloat16}[meta]
        if kernel == "dequant":
            kqt = (_make_kqt if meta == torch.float32 else _make_kqt_bf16)(n, k, int(g),
                                                                            int(nbits), seed=1)
            copies, _ = _copies(kqt, None, _weight_bytes(kqt) + 2 * n * k)
            call = lambda q: fm.dequant(q, torch.bfloat16)  # noqa: E731
        else:
            w = torch.randn((n, k), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1)) / k**0.5
            qt = quantize(w, nbits=int(nbits), group_size=int(g), meta_dtype=meta,
                          round_zero=nbits == "4")
            copies = _qt_copies(qt, _qt_bytes(qt) + 2 * n * k)
            call = lambda q: fm.dequant_canonical(q, torch.bfloat16)  # noqa: E731
        ms = [time_ms([lambda q=q: call(q) for q in copies], 100) for _ in range(3)]
        return dict(kernel=kernel, k=k, n=n, config=extra, variant=variant, ms=ms)
    if kernel in ("quant_matmul_ax0", "dequant_ax0"):
        config = extra or AX0_TIME_DEFAULT
        r = None
    elif kernel == "qmm_fp32":
        config = extra if extra and "-" in extra else None
        r = int(extra) if extra and config is None else 0
    elif kernel.startswith("flash_attention_backward"):  # KV[-HD[-DTYPE]]
        config, r = (extra or "").split("-"), None
        if kernel.endswith("_fp32"):  # the fp32 route through the wrapper both trees have
            kernel = kernel[:-5]
            config = (config + [""] * 3)[:3]
            config[1], config[2] = config[1] or str(HEAD_DIM), config[2] or "fp32"
            config[0] = config[0] or str(n)
    elif kernel.startswith("w4a8") and extra and "-" in extra:  # an axis=1 NBITS-G-META
        config, r = extra, None
    else:
        config, r = None, int(extra) if extra else None

    if kernel == "paged_attention":  # slots, length, query heads, kv heads, page type
        from hqq_tpu_torch.ops import paged as pa

        n_kv = r or n
        pages, _, how = (variant or "bf16").partition(":")
        if pages not in ("bf16", "int8") or how not in ("",) + tuple(PAGED_VARIANTS):
            raise SystemExit(f"paged_attention takes bf16 or int8 pages and a variant of "
                             f"{sorted(PAGED_VARIANTS)}, not {variant!r}")
        if how:
            _paged_variant(how)
        int8 = pages == "int8"
        lengths = [k] * m
        nbytes, _ = _paged_bound(lengths, n, n_kv, int8)
        q, kp, vp, lens, tabs, ks, vs = _paged_inputs(
            lengths, n, n_kv, int8, max(1, min(16, -(-ROTATE_BYTES // int(nbytes)))), seed=1)
        ms = [time_ms([lambda tab=tab: pa.paged_attention(q, kp, vp, lens, tab, ks, vs)
                       for tab in tabs], 100) for _ in range(3)]
        return dict(kernel=kernel, slots=m, length=k, heads=n, kv_heads=n_kv, pages=pages, ms=ms)
    if kernel == "flash_attention":  # batch, T, query heads, kv heads
        from hqq_tpu_torch.ops import attention as at

        n_kv = r or n
        qkv = _flash_inputs(m, n, n_kv, k, 4, seed=1)
        ms = [time_ms([lambda a=a: at.flash_attention(*a, True) for a in qkv], 100)
              for _ in range(3)]
        return dict(kernel=kernel, batch=m, t=k, heads=n, kv_heads=n_kv, ms=ms)
    if kernel in ("flash_attention_backward_dkv", "flash_attention_backward_dq",
                  "flash_attention_fp32"):  # batch, T, query heads, kv heads
        from hqq_tpu_torch.ops import attention as at

        n_kv, hd, dtype = r or n, HEAD_DIM, torch.bfloat16
        if kernel == "flash_attention_fp32":
            dtype = torch.float32
        elif config[0]:  # the backward's kv heads, head size and type: 8-64-fp16
            n_kv = int(config[0])
            hd = int(config[1]) if len(config) > 1 else hd
            dtype = getattr(torch, {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}[
                config[2] if len(config) > 2 else "bf16"])
        q, kk, v = (x.to(dtype) for x in _flash_inputs(m, n, n_kv, k, 1, seed=1, hd=hd)[0])
        if kernel == "flash_attention_fp32":
            call = lambda: at.flash_attention(q, kk, v, True)  # noqa: E731
        else:
            do = torch.randn_like(q)
            out, lse = at._flash_forward(q, kk, v, True, None, with_lse=True)
            ops_ = at._backward_operands(q, kk, v, out, lse, do, None)
            launch = at._launch_dkv if kernel.endswith("dkv") else at._launch_dq
            call = lambda: launch(ops_, True)  # noqa: E731
        ms = [time_ms([call], 20) for _ in range(3)]
        return dict(kernel=kernel, batch=m, t=k, heads=n, kv_heads=n_kv, head_dim=hd,
                    dtype=str(dtype)[6:], variant=variant, ms=ms)
    fp32_rank = r if kernel == "qmm_fp32" else None
    r = r or LORA_RANK

    x = torch.randn((m, k), device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    x = x.to(torch.float32 if kernel == "qmm_fp32" else torch.bfloat16)
    if config is not None and kernel.startswith("w4a8"):  # axis=1, HQQ+'s sub-word groups too
        nbits, g, meta = config.split("-")
        kqt = _u_kqt(n, k, float(nbits) if "." in nbits else int(nbits), int(g), seed=1,
                     meta={"fp32": torch.float32, "bf16": torch.bfloat16}[meta])
    elif config is not None:
        nbits, g, meta = config.split("-")
        kqt = _make_kqt0(n, k, int(g), int(nbits),
                         {"fp32": torch.float32, "bf16": torch.bfloat16}[meta], seed=1)
    else:
        kqt = _make_kqt(n, k, 64, 4, seed=1)
    a, b = _make_lora(k, n, seed=2, r=r)
    if kernel.startswith("w4a8"):
        xa = x.float() @ a
        x, sx = fm.quantize_activations_int8(x)
    calls = {
        "quant_matmul": lambda q, p: fm.quant_matmul(q, p),
        "quant_matmul_ax0": lambda q, p: fm.quant_matmul_ax0(q, p),
        "dequant_ax0": lambda q, p: fm.dequant(p, torch.bfloat16),  # W [N, K]; M unused
        "quant_matmul_lora": lambda q, p: fm.quant_matmul_lora(q, p, a, b),
        "w4a8_matmul": lambda q, p: fm.w4a8_matmul(q, sx, p, torch.bfloat16),
        "w4a8_lora_matmul": lambda q, p: fm.w4a8_lora_matmul(q, sx, p, xa, b, torch.bfloat16),
        # fp32 x takes the fp32 route of the wrapper of its weight and adapter
        "qmm_fp32": (lambda q, p: fm.quant_matmul_ax0(q, p)) if config is not None
        else (lambda q, p: fm.quant_matmul_lora(q, p, a, b)) if fp32_rank
        else (lambda q, p: fm.quant_matmul(q, p)),
    }
    if kernel not in calls:
        raise SystemExit(f"unknown kernel {kernel!r}: one of {sorted(calls)}")
    call = calls[kernel]
    kq, xq = _copies(kqt, x, _weight_bytes(kqt))
    launches = fm.qmm_fp32.launches
    ms = [time_ms([lambda p=p, q=q: call(q, p) for p, q in zip(kq, xq)], 100) for _ in range(3)]
    if kernel == "qmm_fp32" and fm.qmm_fp32.launches == launches:
        raise AssertionError("fp32 x did not take the fp32 route")
    return dict(kernel=kernel, m=m, k=k, n=n, r=r if kernel != "qmm_fp32" else fp32_rank,
                config=config, variant=variant, ms=ms)


def norm_cost(power: str) -> None:
    """``--norm``: the device time of a call of `models.llama.rms_norm` (the
    fixed-order kernel, csrc/rms_norm.cu) against the route it replaced
    (the mean square summed in fp64) and PyTorch's fp32 sum, bf16 rows of
    4096 at the
    row counts of C's decode step (4), the engines' verify (32) and a
    prefill or training window (1024), each the mean of 100 calls under
    torch.profiler. A 7B forward makes 65 norms (two a layer and the final
    one). Then the same for `ops.norm.layer_norm` on rows of 4544 (Falcon-7B,
    33 norms a pass) against PyTorch's fp32 means and F.layer_norm."""
    from hqq_tpu_torch.models import llama

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(4096, generator=gen, device="cuda").to(torch.bfloat16)
    routes = (("kernel", llama.rms_norm), ("fp64 sum", _fp64_rms_norm),
              ("fp32 sum", _fp32_rms_norm))
    for rows in (4, 32, 1024):
        x = torch.randn((rows, 4096), generator=gen, device="cuda").to(torch.bfloat16)
        got = {}
        for name, fn in routes:
            fn(x, w, 1e-5)
            prof = device_share(lambda: [fn(x, w, 1e-5) for _ in range(100)])
            got[name] = (prof["device_ms"] / 100, prof["events"] / 100)
        log(f"[norm] [{power}] rms_norm of {rows} rows of 4096 (bf16), device ms a call "
            f"(kernels a call): " + "; ".join(f"{k} {ms:.5f} ({n:g})" for k, (ms, n) in got.items())
            + f"; in 65 norms, the kernel against the fp64 sum: "
            f"{65 * (got['kernel'][0] - got['fp64 sum'][0]):+.4f} ms")
    # layer_norm at Falcon-7B's width: the kernel against PyTorch's fp32
    # means and its fused LayerNorm (a yardstick the port never calls)
    import torch.nn.functional as F

    from hqq_tpu_torch.ops import norm as nm

    w = (1 + 0.1 * torch.randn(4544, generator=gen, device="cuda")).to(torch.bfloat16)
    b = (0.1 * torch.randn(4544, generator=gen, device="cuda")).to(torch.bfloat16)
    routes = (("kernel", nm.layer_norm), ("fp32 means", _fp32_layer_norm),
              ("F.layer_norm", lambda x_, w_, b_, e: F.layer_norm(x_, (4544,), w_, b_, e)))
    for rows in (4, 32, 1024):
        x = (torch.randn((rows, 4544), generator=gen, device="cuda") + 1).to(torch.bfloat16)
        got = {}
        for name, fn in routes:
            fn(x, w, b, 1e-5)
            prof = device_share(lambda: [fn(x, w, b, 1e-5) for _ in range(100)])
            got[name] = (prof["device_ms"] / 100, prof["events"] / 100)
        log(f"[norm] [{power}] layer_norm of {rows} rows of 4544 (bf16, bias), device ms a call "
            f"(kernels a call): " + "; ".join(f"{k} {ms:.5f} ({n:g})" for k, (ms, n) in got.items())
            + f"; in Falcon-7B's 33 norms a step, the kernel against the fp32 means: "
            f"{33 * (got['kernel'][0] - got['fp32 means'][0]):+.4f} ms")


def window_probe(power: str) -> None:
    """``--windows``: do a speculative verify window's rows compute what
    one-token decode steps compute? C's model (seed 0, 4-bit g64, w4a8),
    a 100-token prompt and its own 60 greedy tokens: the logits of 12
    windows of 5 rows (M = 5, a k = 4 round's verify) against 60 one-token
    steps (M = 1) over the dense cache, the share of rows bit-equal and of
    rows whose argmax agrees, the largest logit gap. Variants: the port as
    it is (RMSNorm by the fixed-order kernel: every row must be
    bit-equal); the mean square summed by PyTorch in fp64 (the route the
    kernel replaced) and in fp32 (before that); fp32 with attention and
    lm_head a window row at a time; fp32 with RMSNorm a row at a time. Then
    the engines' route: 8 slots, windows of 4 (M = 32) against steps
    (M = 8)."""
    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models import llama

    attention, logits_of = llama._attention, llama._logits
    fp32_norm = _fp32_rms_norm

    def rows(fn, arg: int):
        """``fn`` one row of dim 1 at a time where that dim holds 2-8 rows."""
        def run(*args):
            x = args[arg]
            if x.ndim != 3 or not 1 < x.shape[1] <= 8:
                return fn(*args)
            return torch.cat([fn(*args[:arg], x[:, j:j + 1], *args[arg + 1:])
                              for j in range(x.shape[1])], dim=1)
        return run

    def attention_rows(layer, cfg_, x, cache, i, start_pos, mask, cos, sin):
        """`llama._attention` with scores, softmax and product a query row
        at a time (the projections and the cache write as they are)."""
        t = x.shape[1]
        if not 1 < t <= 8:
            return attention(layer, cfg_, x, cache, i, start_pos, mask, cos, sin)
        b, nh, hd = x.shape[0], cfg_.num_attention_heads, cfg_.head_dim_
        q, k, v = llama._qkv_rope(layer, cfg_, x, cos, sin)
        llama._update_stacked_cache(cache.k, cache.v, i, k, v, start_pos)
        keys, vals = cache.k[i], cache.v[i]
        outs = []
        for j in range(t):
            scores = (q[:, :, j:j + 1].float() @ keys.float().transpose(-1, -2)) / hd**0.5
            probs = torch.softmax(scores + mask[:, :, j:j + 1], dim=-1).to(q.dtype)
            outs.append(probs @ vals)
        return layer["o_proj"](torch.cat(outs, dim=2).transpose(1, 2).reshape(b, t, nh * hd))

    def compare(params, cfg_, seqs, t0: int, n: int, w: int):
        out = []
        for width in (1, w):
            cache = llama.init_cache(cfg_, seqs.shape[0], 256, torch.bfloat16, "cuda")
            llama.forward(params, cfg_, seqs[:, :t0], cache, 0)
            got = [llama.forward(params, cfg_, seqs[:, i:i + width], cache,
                                 torch.full((seqs.shape[0],), i, device="cuda"))[0]
                   for i in range(t0, t0 + n, width)]
            out.append(torch.cat(got, dim=1))
        step, win = out
        return ((win == step).all(-1).float().mean().item(),
                (win.argmax(-1) == step.argmax(-1)).float().mean().item(),
                (win - step).abs().max().item())

    cfg = llama.LlamaConfig.llama2_7b()
    model = HQQModel(llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                       torch.bfloat16, "cuda"), cfg)
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    model.prepare_for_inference("w4a8")
    prompt = torch.from_numpy(_prompts(cfg)[:1])
    ids = model.generate(prompt.numpy(), max_new_tokens=64, compile_mode="partial")
    seq = torch.cat([prompt.long(), torch.from_numpy(ids).long()], dim=1).cuda()
    variants = {
        "as it is (the RMSNorm kernel)": {},
        "fp64-summed RMSNorm": {"rms_norm": _fp64_rms_norm},
        "fp32-summed RMSNorm": {"rms_norm": fp32_norm},
        "fp32 RMSNorm, attention and lm_head a row at a time": {
            "rms_norm": fp32_norm, "_attention": attention_rows, "_logits": rows(logits_of, 2)},
        "fp32 RMSNorm a row at a time": {"rms_norm": rows(fp32_norm, 0)},
    }
    with torch.inference_mode():
        for name, patches in variants.items():
            saved = {k: getattr(llama, k) for k in patches}
            for k, fn in patches.items():
                setattr(llama, k, fn)
            try:
                same, agree, gap = compare(model.params, cfg, seq, 100, 60, 5)
            finally:
                for k, fn in saved.items():
                    setattr(llama, k, fn)
            log(f"[windows] [{power}] 12 windows of 5 rows vs one-token steps, {name}: rows "
                f"bit-equal {same:.3f}, argmax agreeing {agree:.3f}, max |logit gap| {gap:.4f}")
            if not patches and same != 1.0:
                raise AssertionError(f"[windows] with the norm kernel {same:.3f} of the window "
                                     f"rows are bit-equal to decode steps, not all")
        seqs = torch.randint(0, cfg.vocab_size, (8, 116),
                             generator=torch.Generator().manual_seed(1)).cuda()
        same, agree, gap = compare(model.params, cfg, seqs, 100, 16, 4)
        log(f"[windows] [{power}] engines: 8 slots, windows of 4 (M = 32) vs steps (M = 8), "
            f"128 rows: bit-equal {same:.3f}, argmax agreeing {agree:.3f}, max |logit gap| "
            f"{gap:.4f}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    import hqq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev_tag = f"[{power}]"
    if argv and argv[0] == "--time":  # KERNEL M K N [EXTRA [VARIANT]] [+ KERNEL M K N ...]
        from hqq_tpu_torch.ops import _build

        flags = _build.NVCC_FLAGS
        runs = [[]]
        for arg in argv[1:]:
            runs.append([]) if arg == "+" else runs[-1].append(arg)
        from hqq_tpu_torch.ops import fused_matmul as fm

        plan_of = fm.w4a8_launch_plan
        for run in runs:
            log(json.dumps(dict(time_one(run[0], *map(int, run[1:4]), *run[4:6]), card=power)))
            _build.NVCC_FLAGS = flags  # a variant holds for its own run alone
            _build._load.cache_clear()
            fm.w4a8_launch_plan = plan_of
        return 0
    if argv and argv[0] == "--ids":
        log(json.dumps(dict(greedy_ids(), card=power)))
        return 0
    if argv and argv[0] == "--windows":
        window_probe(power)
        return 0
    if argv and argv[0] == "--norm":
        norm_cost(power)
        return 0
    if argv[:2] == ["--phase", "p"]:  # path P alone, after phase b's rows at its shapes
        from hqq_tpu_torch.ops import _build

        built = _build.build_all(["w4a8_matmul", "quant_matmul", "dequant_canonical",
                                  "paged_attention", "rms_norm", "layer_norm"])
        log(f"[a] built {sorted(built)}: {max((v[0] for v in built.values()), default=0):.1f} s")
        phase_b_p(lambda key, row: log("[b] " + json.dumps(row)), 100)
        phase_p(dev_tag)
        log(power)
        return 0
    if argv[:2] == ["--phase", "n"]:  # path N alone, after phase b's rows at its shapes
        from hqq_tpu_torch.ops import _build

        built = _build.build_all(["w4a8_matmul", "quant_matmul", "dequant_canonical",
                                  "grouped_matmul", "rms_norm", "layer_norm"])
        log(f"[a] built {sorted(built)}: {max((v[0] for v in built.values()), default=0):.1f} s")
        phase_b_n(lambda key, row: log("[b] " + json.dumps(row)), 100)
        phase_n(dev_tag)
        log(power)
        return 0
    if argv[:2] == ["--phase", "t"]:  # path T alone, after phase b's rows at its shapes
        from hqq_tpu_torch.ops import _build

        built = _build.build_all(["quant_matmul", "qmm_fp32", "layer_norm"])
        log(f"[a] built {sorted(built)}: {max((v[0] for v in built.values()), default=0):.1f} s")
        phase_b_t(lambda key, row: log("[b] " + json.dumps(row)), 100)
        phase_t(dev_tag)
        log(power)
        return 0
    if argv[:2] == ["--phase", "u"]:  # path U alone, after phase b's rows of its routes
        from hqq_tpu_torch.ops import _build

        built = _build.build_all(["w4a8_matmul", "quant_matmul", "quant_matmul_lora", "qmm_fp32",
                                  "dequant", "dequant_canonical", "paged_attention", "rms_norm"])
        log(f"[a] built {sorted(built)}: {max((v[0] for v in built.values()), default=0):.1f} s")
        phase_b_u(lambda key, row: log("[b] " + json.dumps(row)))
        phase_u(dev_tag)
        log(power)
        return 0
    if argv[:2] == ["--phase", "k"]:  # path K alone, after the grouped kernel's rows
        phase_b_grouped(lambda key, row: log("[b] " + json.dumps(row)), 100)
        phase_k(dev_tag)
        log(power)
        return 0

    t_start = time.time()

    def lap(what):  # seconds since the start, after each phase
        log(f"[t] {time.time() - t_start:.1f} s: {what} done")

    phase_a(name, power)
    lap("a")
    rows = phase_b()
    lap("b")
    launches, model, c_ids = phase_c(dev_tag)
    lap("c")
    windows = [launches, phase_g(dev_tag, model), phase_h(dev_tag, model)]
    lap("g, h")
    t_vm = time.time()
    windows.append(phase_v(dev_tag, model))
    windows.append(phase_m(dev_tag, model))
    log(f"[v] phases v and m: {time.time() - t_vm:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_q = time.time()
    windows.extend(phase_q(dev_tag, c_ids))
    log(f"[q] phases q and s: {time.time() - t_q:.1f} s")
    windows.append(phase_s_dense_int8(dev_tag))
    lap("v, m, q, s")
    windows.extend(phase_r(dev_tag))
    lap("r")
    windows.extend(phase_l(dev_tag))
    lap("l")
    windows.extend(phase_x(dev_tag))
    lap("x")
    windows.extend(phase_k(dev_tag))
    lap("k")
    windows.extend(phase_p(dev_tag))
    lap("p")
    windows.extend(phase_n(dev_tag))
    lap("n")
    windows.extend(phase_t(dev_tag))
    lap("t")
    windows.extend(phase_u(dev_tag))
    lap("u")
    phase_g_two_layer()
    phase_h_two_layer()
    phase_d()
    lap("g, h two-layer, d")
    windows.append(phase_e(dev_tag))
    windows.append(phase_f(dev_tag))
    lap("e, f")
    windows.append(phase_i(dev_tag))
    windows.append(phase_i_two_layer())
    windows.append(phase_i_gemma(dev_tag))
    lap("i")

    kernels = []
    for kname, (source, replaces, also) in KERNELS.items():
        m, k, n, note = PICK[kname]
        row = next(r for r in rows[kname]
                   if (r["m"], r["k"], r["n"], r["note"]) == (m, k, n, note))
        entry = dict(name=kname, route="cuda", source=SRC + source, replaces=replaces,
                     launches=sum(w.get(kname, 0) for w in windows),
                     max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=row["library_ms"],
                     shape=row.get("shape", dict(m=m, k=k, n=n, note=note)))
        if also:
            entry["also_replaces"] = also
        if entry["launches"] == 0:
            raise AssertionError(f"{kname} was launched on no main path")
        kernels.append(entry)
    log(f"[done] {time.time() - t_start:.1f} s")
    log(power)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
