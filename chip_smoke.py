#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit, then the build of every kernel source
   with each kernel's registers, static shared memory and spill bytes (nvcc
   ``-Xptxas -v``); every ``flash_fwd_wgmma`` and ``flash_bwd_wgmma``
   instantiation (``flash_bwd_wgmma<64/128>`` and, past head dim 128,
   ``flash_bwd_wgmma_dkdv<256>`` and ``flash_bwd_wgmma_dq<256>``),
   ``rglru_scan_tma`` and ``rglru_scan_bwd_tma`` must spill nothing;
2. every kernel against its plain PyTorch version on the card: the reference
   test shapes (fp32 at 2e-5 with TF32 off; bf16 within 2e-2 and, per
   element, within 1.6e-2 of the value plus 1e-2 of its row's RMS, NaN-free;
   the RG-LRU scan at 1e-5), each flash case naming the kernel variant it
   launched (every bf16 case must launch ``wgmma``), then each serving shape,
   timed beside its bound and, where one PyTorch call computes the same
   function, that call as yardstick; then the flash backward: the forward's
   lse against the plain version's (1e-4), and dq, dk, dv against the plain
   backward on the kernel's own output and against the oracle's autograd on
   fp32 upcasts (fp32 within 1e-4 of both; bf16 per element against the
   plain backward and in relative L2 against the oracle, see ``GRAD_RTOL``),
   each case naming its variant (``wgmma`` for bf16 that the TMA can load,
   up to head dim 256, with Tk other than Tq where a key tile sees no query;
   ``simt`` for fp32 and for bf16 with a head dim no multiple of 8 or off
   16-byte aligned storage);
   then the forward and the backward at llama3-8b's training shape (head dim
   128), at recurrentgemma-9b's (head dim 256, MQA, window 2048: the
   backward on ``flash_bwd_wgmma_dkdv`` and ``flash_bwd_wgmma_dq``), at
   deepseek-v2-236b's MLA in phase 6(g)'s microbatch (B 2, T 4096, 128
   heads, dk 192 / dv 128), at hubert-xlarge's (B 4, T 1500, 16 heads of
   d 80, no causal mask) and at internvl2-76b's in phase 6(h)'s microbatch
   (B 1, T 2048, 64 heads over 8 at d 128), each
   timed beside its plain version, its bound (at d 256 also the bound of the
   seven products the split design runs, a second call that must repeat
   the first bit for bit, and the time at every head-group count the
   launch can choose; where dk or dv is under the kernel's D, the bound of
   the work zero-filled to D) and SDPA (a window as a boolean mask; its
   backends pinned to the fused ones, the math backend only where none
   takes the shape, said so; the backend that ran is named), the
   backward's device time split by launch; the plain versions run over
   slices of the heads where their fp32 scores would pass ``PLAIN_BYTES``;
   then the
   RG-LRU scan's forward and its backward kernel (``rglru_scan_bwd``)
   against their plain versions at 1e-5, each case naming its variant
   (``tma`` for every shape the TMA can address, with T no multiple of the
   ring's stage and shorter than one, T 1, and W no multiple of its column;
   ``lane`` for W % 4 != 0 and for inputs off 16-byte aligned storage; the
   backward also with a large h0), each timed at recurrentgemma-9b's prefill
   shape (B 4) and training shape (B 1) on ``tma`` and on ``lane`` (the
   earlier kernels), beside its bound, an elementwise add over the
   forward's bytes, its ring's configured capacity, and its plain
   version (the backward's: the oracle's autograd with its forward, and the
   plain reverse loop); at both shapes ``tma``'s h must equal ``lane``'s and
   a second call's bit for bit, and the backward must repeat bit for bit
   (its difference from ``lane`` is printed);
3. the port against its own plain CPU path on small fp32 models
   (llama3.2-1b, recurrentgemma-9b, deepseek-v2-236b, xlstm-1.3b, the
   internvl2-76b vision stub's prefill and decode, and the hubert-xlarge
   encoder's logits);
4. the main paths, each with every kernel launch counted from zero and
   with its peak memory and decode's weight-read floor:
   ``serve("llama3.2-1b")`` at full width, batch 8 x prompt 1024 x 32
   generated tokens; then ``serve("recurrentgemma-9b")`` at full width and
   depth (38 layers, bf16), batch 4 x prompt 4096 x 32 generated tokens;
   then ``serve("deepseek-v2-236b")`` at published widths cut to 4 of its 60
   layers (``get_config`` patched in serve's namespace: the dense lead layer
   and 3 MoE layers of 160 routed experts top-6 and 2 shared), batch 4 x
   prompt 4096 x 32 generated tokens; then ``serve("xlstm-1.3b")`` at
   published width and depth (48 blocks, bf16), batch 8 x prompt 2048 x 32
   generated tokens, whose mLSTM and sLSTM blocks launch no kernel (its
   decode floor adds the states read and written), with its own checks at
   that width: the first mLSTM block's chunkwise form against the
   sequential oracle over the prompt (``XLSTM_CHUNKWISE_TOL``), CUDA-event
   times by block kind for a prefill and a decode step, and, on the same
   config in fp32, prefill and one decode step against a forward over the
   prompt plus that token (``XLSTM_DECODE_TOL``; a decode from fresh
   states must miss); then ``serve("internvl2-76b")`` at published widths
   cut to 8 of its 80 layers, batch 4 x a prompt of 256 stub image
   embeddings and 1792 text tokens x 32 generated tokens.  Every
   flash-attention launch must be ``wgmma`` (one per attention layer in
   prefill, none in decode), every scan launch ``tma``, and no plain version
   may run.  Then the encoder: hubert-xlarge at published width and depth
   (48 layers) through ``build_encode_step``, batch 8 x 1500 frames, one
   ``wgmma`` flash launch per layer and no plain call, with its seconds,
   frames/s, model-FLOPs share and peak memory, and its logits beside those
   with the plain flash version in the kernel's place;
5. admitted serving: llama3.2-1b's phase-4 request again, admitted through
   the lock table (``admission_slots=4``), with the kernel libraries
   unloaded first: the libraries are loaded when the slot is taken, the card
   is idle at each keepalive, the tokens equal phase 4's, the lease counters
   are 1 grant, 4 fast renewals, 0 expirations and 0 RDMA operations on the
   serving host, and flash attention launches 16 times on ``wgmma``; then
   three server threads share two slots, never more than two inside a
   lease, each with phase 4's tokens and its own fence token; then the host
   time of admit, keepalive and complete, and bare against admitted serving
   (through a private table and through a gate built beforehand) over three
   requests each, in turns, with the garbage collector's time in each;
6. training: (a) flash attention's gradients on the card through its
   autograd Function (fp32 and bf16, causal and windowed, GQA and MQA)
   against the plain backward and the oracle's autograd, with phase 2's
   tolerances, then three fp32 train steps of
   llama3.2-1b, recurrentgemma-9b, xlstm-1.3b, hubert-xlarge,
   internvl2-76b, deepseek-v2-236b and deepseek-v3-671b (``SMOKE_TRAIN``;
   the MLA archs with their up-projections conditioned,
   :func:`condition_mla`, at lr ``SMOKE_MLA_LR``) at smoke width on the
   card and on the
   CPU from one init (losses, grads' norms and final parameters within the
   CPU parity tests' atol 1e-5, rtol 1e-4; each kernel's launches printed,
   the scan backward's among them, and equal to what ``layer_plan`` implies,
   a MoE model's dense lead layers and deepseek-v3's MTP block attending
   once each way outside remat); (b) a smoke run checkpointed at
   step 3 and resumed through step 6 gives an uninterrupted run's losses
   exactly; (c) the main path's second half: ``train("llama3.2-1b")`` at its
   published widths (16 layers, bf16 parameters, fp32 AdamW moments, block
   remat), ``train_4k``'s 4096 tokens per row at global batch 8 in 8
   microbatches, 6 steps at lr 3e-4 with 2 warmup steps, launches counted
   from zero: every loss finite, 256 flash launches and 128 flash backward
   launches per step, all ``wgmma``, no call of a plain version, and the
   6th loss below the 1st; then one microbatch's backward timed with CUDA
   events around the whole and around each attention backward (the
   kernel); then that microbatch's loss and every gradient through the
   kernels against the same with the plain versions in the forward, remat's
   recompute and the backward, within ``TRAIN_BF16_TOL``, and a recompute
   that is wrong on purpose must exceed it; then the forward and the
   backward at this shape, as in phase 2; (d) the main path's third part:
   ``train("recurrentgemma-9b")`` at its published widths cut to 8 layers
   (two ``(rec, rec, attn)`` super-blocks under remat and the two tail
   ``rec`` layers; ``get_config`` patched in train's namespace for the
   call), bf16 parameters, fp32 AdamW moments, 4 rows of 4096 tokens in 4
   microbatches, 6 steps at lr 3e-4 with 2 warmup steps: every loss finite,
   the 6th below the 1st, each step's launches counted from zero and equal
   to what ``layer_plan`` implies (scan forward 40 and scan backward 24,
   both required on ``tma``, flash forward 16 and flash backward 8, both
   required on ``wgmma``), no call of
   a plain version, with
   s/step, tokens/s, the model-FLOPs share and the peak memory; then one
   microbatch's backward timed with CUDA events (the whole, each scan
   backward, each attention backward), and again with the parent tree's
   scan route (its backward the oracle's autograd) swapped in for that
   measurement only; then that microbatch's loss and every gradient
   through the kernels against the plain versions in the forward, remat's
   recompute and the backward, within ``RG_TRAIN_BF16_TOL``, and a scan
   backward wrong on purpose (da from h_t) must exceed it; (e) the main
   path's fourth part: ``train("xlstm-1.3b")`` at published width cut to 8
   of its 48 blocks (one ``("mlstm",) * 7 + ("slstm",)`` super-block under
   remat), bf16 parameters, fp32 AdamW moments, 4 rows of 2048 tokens in one
   microbatch, 2 steps at lr 3e-4 with 1 warmup step (``XLSTM_TRAIN``):
   every loss finite, the trained weights moved, no launch of any kernel and
   no call of a plain version, with s/step, tokens/s, the model-FLOPs share (6
   N per token plus the mLSTM chunkwise products, ``xlstm_step_flops``), the
   peak memory and the losses (printed: the model does not learn measurably
   in 4 steps from these weights, see ``XLSTM_TRAIN``); then one
   microbatch's forward and backward timed with CUDA events, the sLSTM scans
   over time apart (forward, remat's recompute and backward).  It holds the
   first step's loss to the fp32 loss of the same weights (``XLSTM_LOSS_RTOL``)
   and, in fp32 on one row at published width cut to 8 blocks, the gradient
   against the loss's change along it (``gradient_slope``, ``XLSTM_SLOPE``);
   (f) ``train("hubert-xlarge")`` at published width and depth (48 layers
   under remat, no causal mask), bf16 parameters, fp32 AdamW moments, 8 rows
   of 1500 frames in 2 microbatches, 6 steps at lr 3e-4 with 2 warmup steps
   (``HUBERT_TRAIN``): every loss finite, each step's launches 192 flash and
   96 flash backward, all ``wgmma``, no call of a plain version, the weight
   matrices moved and ``embed.table``'s moments still zero (its gradient
   exactly zero: the audio stub replaces the embedding), with s/step,
   frames/s, the model-FLOPs share, the peak memory and the losses (printed:
   the stub's embeddings carry nothing of the labels); then one microbatch
   through the kernels against the plain versions in the forward, remat's
   recompute and the backward, within ``HUBERT_TRAIN_BF16_TOL``, and a
   recompute with the causal mask on purpose must exceed it; (g)
   ``train("deepseek-v2-236b")`` at published widths cut to 2 of its 60
   layers (the dense lead layer and one MoE layer of 160 routed experts
   top-6 and 2 shared, 5.359 G parameters), bf16 parameters, fp32 AdamW
   moments, block remat, 2 rows of 4096 tokens in one microbatch, 4 steps
   at lr 3e-4 with 1 warmup step (``DEEPSEEK_TRAIN``), and (h)
   ``train("internvl2-76b")`` at published widths cut to 1 of its 80 layers
   (2.957 G parameters), 4 rows of 2048 positions (256 stub image
   embeddings, then 1792 text tokens) in 4 microbatches, 4 steps
   (``INTERNVL2_TRAIN``), each through :func:`published_width_training`:
   every loss finite, every weight matrix moved (the router and the experts
   among them), each step's launches counted from zero and equal to what
   ``layer_plan`` implies (flash forward 3 and backward 2 for deepseek,
   forward 8 and backward 4 for internvl2, all ``wgmma``), no call of a
   plain version, with s/step, positions/s, the model-FLOPs share (6 per
   active weight per position: 6 of 160 routed experts, no embedding
   lookup, the unembedding at the text positions; plus attention) and the
   peak memory; then one microbatch timed (the attention backward apart)
   and through the kernels against the plain versions in the forward,
   remat's recompute and the backward, within ``DEEPSEEK_TRAIN_BF16_TOL`` and
   ``INTERNVL2_TRAIN_BF16_TOL``, and a recompute without the causal mask on
   purpose must exceed them;
7. training in pods: ``train("llama3.2-1b")`` at published width, cut to
   ``POD_LAYERS`` layers, on a 2 pods x 1 data mesh (``POD_TRAIN``), two
   ranks spawned with
   ``launch.mesh.spawn_ranks`` (they share the card where it is the only
   one; the pod exchange then goes over gloo through host memory), 6(c)'s
   global batch of 8 x 4096 at lr 3e-4 split as 4 rows in 4 microbatches a
   rank, 2 steps each of ``flat``, ``sync``, ``sync`` + int8 and ``local``
   with budget 2 (:func:`pod_rank`), held by :func:`check_pod_training`:
   flat and sync agree step by step (``POD_LOSS_RTOL``) and their first
   loss with one rank's step 1 of the same cut and batch
   (``POD_FIRST_RTOL``), a planted fault (one step of sync
   with every rank on pod 0's rows, ``POD_FAULT``) lies outside both, int8
   within ``POD_INT8_ATOL`` of exact after the last step, local's pods part
   after step 1 and are bit-identical after step 2 (the other modes' after
   every step), each step's wire bytes on
   each group equal ``core/asymmetry.py``'s formulas, and each rank's
   launches are the cut's per-row share, all ``wgmma``, with no call of a
   plain version; it prints each mode's seconds and exchange seconds per
   step, each group's backend, and each rank's peak memory and
   ``mem_get_info``;
8. FSDP and tensor parallelism (``sharding/rules.py`` and
   ``sharding/shard.py``): llama3.2-1b at published width and depth, (a)
   served with phase 4's request on a ``(data 1, model 2)`` mesh
   (:func:`tp_serve_rank`, two ranks): the prefill's last-token logits
   within ``TP_LOGITS_RTOL`` of phase 4's, every first token equal, the
   ``model`` group's bytes of the prefill and of each decode step equal to
   ``core/asymmetry.py``'s formulas, 16 flash launches a prefill on
   ``wgmma`` and no plain call (:func:`check_tp_serving`); (b) trained 2
   steps of 4 x 4096 on ``(data 2, model 2)`` (:func:`tp_train_rank`, four
   ranks): step 1's loss and grad-norm within ``TP_LOSS_RTOL`` and
   ``TP_NORM_RTOL`` of a one-rank run of the same weights and batch made
   here first, each group's bytes a step equal to the formulas
   (:func:`tp_wire_bytes`), each rank's parameter and moment bytes its
   blocks' by the rules (:func:`shard_bytes`), 32 flash and 16 flash
   backward launches a rank and step on ``wgmma`` and no plain call
   (:func:`check_tp_training`); in both, a planted fault (``wi`` split
   contiguously, :func:`contiguous_wi`) must lie outside every limit. It
   prints prefill s, decode ms/token, s and exchange s per step by group,
   the backends, and each rank's parameter bytes and peak memory;
9. expert parallelism (``models/moe.py``'s all-to-all island) and MLA's
   tensor parallelism: deepseek-v2-236b at published widths cut to 2 of its
   60 layers, on the reference's production MoE settings (``ep_a2a``, 16
   groups: :func:`ep_config`), two ranks on ``(data 1, model 2)`` (each 80
   of the 160 experts and 64 of the 128 heads), held to a one-rank run of
   the same weights made here first whose MoE routes each model rank's
   slice as a group of its own (:func:`island_groups`,
   :func:`ep_references`): (a) phase 4's deepseek request served
   (:func:`ep_serve_rank`): the prefill's last-token logits within
   ``EP_LOGITS_RTOL``, every first token the one rank's, the ``model``
   group's bytes of the prefill and of each decode step equal to the
   formulas (:func:`ep_serve_wire_bytes`), 2 flash launches a prefill on
   ``wgmma`` and no plain call, the dropped choices printed
   (:func:`check_ep_serving`); (b) 6(g)'s 2 x 4096 trained 2 steps with
   bf16 AdamW moments (:func:`ep_train_rank`): step 1's loss and
   grad-norm within ``EP_LOSS_RTOL`` and ``EP_NORM_RTOL``, each step's
   bytes equal to the formulas (:func:`ep_wire_bytes`: the island's
   all-to-alls in the forward, remat's recompute and the backward among
   them), each rank's parameter and moment bytes its blocks' by the rules,
   3 flash and 2 flash backward launches a rank and step on ``wgmma``
   (:func:`check_ep_training`); in both, a planted fault (the results
   returned in reverse source order, :func:`wrong_source_order`) must lie
   outside every limit.  Phase 2 times flash at a rank's shapes (64 heads,
   B 4 and B 2 x 4096);
10. tensor parallelism for RG-LRU and xLSTM blocks, and the head-dim split
   of KV heads that do not divide over ``model``: recurrentgemma-9b at
   published widths cut to 6(d)'s 8 layers and xlstm-1.3b cut to 6(e)'s 8
   blocks (xlstm in fp32, see ``TPR_SERVE``), two ranks on ``(data 1,
   model 2)`` spawned as phase 7's (:func:`tp_recurrent_rank`): each served
   with its phase-4 request (xlstm's generated tokens cut to
   ``TPR_XLSTM_TOKENS``) (:func:`tp_serve_rank`) and held to one rank's prefill of the same cut
   on the same prompts (:func:`check_tp_recurrent_serving`: the last-token
   logits within ``TP_LOGITS_RTOL``, every first token the one rank's
   argmax, the ``model`` group's bytes of the prefill and of each decode
   step equal to :func:`tpr_wire_bytes`, per prefill one flash launch an
   attention layer on ``wgmma`` and one scan launch an RG-LRU layer on
   ``tma``, none in decode, no plain call); each trained (``TPR_TRAIN``:
   recurrentgemma 6(d)'s run cut to 2 steps, xlstm one step of 4 x 256,
   :func:`tp_train_rank`) with step 1's loss and grad-norm within phase 8's
   limits of one rank's step 1 of the same run (6(d)'s for recurrentgemma),
   each step's bytes
   equal to the formulas, each rank's parameter and moment bytes its
   blocks', and each step's launches what ``layer_plan`` implies, flash on
   ``wgmma`` and the scan on ``tma`` (:func:`check_tp_recurrent_training`);
   two planted faults must lie outside their limits: RoPE on a rank's
   head-dim slice before the gather (:func:`rope_before_gather`, in
   recurrentgemma's prefill logits) and ``w_if``'s partial through *g* then
   sliced (:func:`w_if_through_g`, in the fp32 gradient of ``w_up`` at the
   initial weights on 6(e)'s slope row, each rank's block against one
   rank's within ``TPR_GRAD_RTOL``: :func:`grad_probe`,
   :func:`check_grad_probe`).  Phase 2 times flash and the scan at a rank's
   shapes (8 query heads over the one KV head at d 256; 2048 channels);
11. pods combined with FSDP and tensor parallelism, the reference's ``(pod,
   data, model)`` mesh: llama3.2-1b at published width and depth on ``(pod
   2, data 1, model 2)`` (``POD_TP_MESH``), four ranks spawned as phase 7's
   (:func:`pod_tp_rank`), every pod holding its model ranks' blocks and
   only those crossing ``pod``: (a) phase 4's request served, each pod its 4
   rows (:func:`check_pod_tp_serving`: each rank's prefill held its ``(pod,
   data)`` share of the rows, its last-token logits within
   ``TP_LOGITS_RTOL`` of phase 4's for them, every first token phase 4's,
   the ``model`` group's bytes of the prefill and of each decode step equal
   to the formulas, 16 flash launches a prefill on ``wgmma``, no plain
   call); (b) phase 8's 4 x 4096 trained 2 steps in each pod mode, 2 rows a
   pod in 2 microbatches (``POD_TP_TRAIN``, :func:`pod_rank`), held by
   :func:`check_pod_tp_training`: step 1 of sync and flat within phase 8's
   limits of phase 8's one-rank step 1, flat within ``POD_LOSS_RTOL`` of
   sync, int8 within ``POD_INT8_ATOL`` after the last step, the pods' blocks
   at each ``(data, model)`` coordinate bit-identical after every step (in
   local parted after step 1), each group's bytes a step equal to
   :func:`pod_tp_wire_bytes`, each rank's parameter and moment bytes its
   blocks', 64 flash and 32 flash backward launches a step and rank on
   ``wgmma``; a planted fault (the pod groups built across model ranks,
   :func:`crossed_pod_group`, two steps of sync) must part the pods' blocks
   and move step 2's loss outside ``POD_LOSS_RTOL``.  It prints a rank's
   state reckoned before the run (:func:`pod_tp_memory`), then each rank's
   peak memory and ``mem_get_info``.

12. MoE served on ``(pod, data)`` rows: phase 9's config on ``(pod 2,
   data 1, model 2)`` (``EP_POD_MESH``), four ranks spawned as phase 7's
   (:func:`ep_pod_rank`; their models built at once where four ranks' init
   peaks, counted on the meta device by :func:`init_need`, leave
   ``EP_POD_AT_ONCE_FREE`` of the card free, else :func:`one_at_a_time`), serving
   phase 9's request with 2 rows a rank: the island inside each pod in
   prefill (MLA flash on ``wgmma`` on every rank), the scatter path with one
   group over both pods' rows in decode; held by
   :func:`check_ep_pod_serving` to one rank's prefill and greedy decode
   whose MoE routes each pod's model-rank slice as a group
   (:func:`ep_serve_reference`): prefill and first decode logits within
   ``EP_LOGITS_RTOL``, every rank's tokens equal and their first ones the
   one rank's, each group's bytes equal to
   :func:`ep_pod_serve_wire_bytes`, decode's slot offsets on pod 1 equal to
   pod 0's counts (:func:`slot_offsets`), and a planted fault that routes
   each pod alone (:func:`pod_alone_rows`) must fail that probe.
13. the dry run (``launch/dryrun.py``) on this machine's CPU, every tensor on
   the meta device, its cells in worker processes started after phase 1
   and running beside phases 2-12 (:func:`start_dry_cells`,
   :func:`dry_cell`): (a) all ten published configs built, each one's
   parameter count printed; (b) the one-card cells that phases 4 and 6(c)
   measured, at their settings (``DRY_MEASURED``): each peak estimate beside
   the phase's ``max_memory_allocated`` within ``DRY_PEAK_BAND``, each
   measured time at least the roofline's largest term, and
   ``model_flops_estimate`` beside the script's own count within
   ``DRY_FLOPS_BAND``; (c) two production cells' roofline rows
   (``DRY_PRODUCTION``), estimates on the H100 data sheet's constants;
14. tensor parallelism on widths that do not divide over ``model``:
   xlstm-1.3b cut to 6(e)'s 8 blocks in fp32 (phase 10(b)'s config) on
   ``(data 1, model 8)`` (``UNEVEN_MESH``), eight ranks spawned as phase 7's
   (:func:`tp_recurrent_rank`): its 4 heads do not split over 8, so each
   rank gathers its columns of the up-projection whole, runs the heads'
   work whole and cuts the cell's output back to its columns
   (``models/xlstm.py``).  Served with phase 10(b)'s prompts and
   ``UNEVEN_DECODE`` generated tokens, held by
   :func:`check_tp_recurrent_serving` to phase 10's one-rank prefill logits
   and first tokens, its ``model`` bytes to :func:`tpr_wire_bytes`; one step
   of ``TPR_TRAIN``'s xlstm run, held by :func:`check_tp_recurrent_training`
   to phase 10's one-rank step 1, each rank's parameter and moment bytes its
   ``fit_pspec`` blocks (``wq``, ``wk``, ``wv`` and the sLSTM block whole);
   the fp32 gradient of the whole ``wq`` on 6(e)'s slope row on every rank
   against one rank's within ``TPR_GRAD_RTOL``, and the planted fault
   (:func:`plain_column_cut`: the cut as a plain slice) outside it.
15. MoE on counts that do not divide: phase 9's cut of deepseek-v2-236b on
   ``ep2d`` with 16 groups over ``(data 3, model 1)`` (``UNEVEN_EP_MESH``),
   three ranks spawned as phase 7's (:func:`uneven_ep_rank`; built one at a
   time unless three ranks' init peaks leave ``EP_POD_AT_ONCE_FREE`` free):
   the 160 experts do not divide over 3, so every rank holds and runs all of
   them, and the 16 groups of 768 tokens straddle the ranks' 4096.  Serving
   one row of 4096 a rank and 2 generated tokens (``UNEVEN_EP_SERVE``),
   held by :func:`check_uneven_ep_serving` to one rank's prefill and decode
   of the same rows (:func:`ep_serve_reference` of this config): logits
   within ``EP_LOGITS_RTOL``, first tokens equal, every rank's 160 experts,
   each group's bytes equal to :func:`uneven_ep_wire_bytes`, every MoE
   call's slot offsets equal to the counts of its group's pieces on the
   ranks before (:func:`piece_offsets`), and a planted fault that takes
   each rank's own counts (:func:`own_counts`) must fail that probe.

In phases 8-12, 14 and 15 every rank prints its peak memory right after its sharded
model is built, the peak statistics reset before the build
(:func:`build_peaks`).

Before each of phases 3-12, 14 and 15 a ``[memory]`` line prints what the phases before
it left allocated on the card, which adds to every later peak reading.  The
last lines are the script's seconds (and whether they passed ``TARGET_S``),
the kernels' JSON record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  The script imports nothing of
JAX; with no CUDA card, or without the repository beside it, it exits 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, fp32 CUDA
# cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# tests/test_kernels.py's FLASH_CASES (fp32 on the simt variant, bf16 on
# wgmma), then bf16 cases at every wgmma head dim (D 64, 128, 256) and its
# edges: a window, d 128 with H/K = 4, dk 192 / dv 128 (MLA), recurrentgemma's
# windowed MQA at d 256, Tq no multiple of the 128-row work tile at d 256
# with a window, and a window that is no multiple of the KV tile; then bf16
# without the causal mask (the encoder's attention): hubert's d 80 on
# flash_fwd_wgmma<128> (columns 80-127 zero-filled by the TMA) with a T that
# no tile divides, GQA at d 64, and d 128.
# B, T, H, K, dk, dv, causal, window, dtype
FLASH_CASES = [
    (2, 64, 4, 2, 32, 32, True, 0, "float32"),
    (1, 96, 8, 8, 64, 64, True, 24, "float32"),
    (2, 48, 4, 1, 16, 16, False, 0, "float32"),
    (1, 80, 4, 2, 32, 16, True, 0, "bfloat16"),
    (1, 50, 2, 2, 16, 16, True, 0, "float32"),
    (3, 32, 6, 3, 8, 8, True, 0, "float32"),
    (2, 200, 8, 2, 64, 64, True, 48, "bfloat16"),
    (1, 130, 4, 2, 128, 128, True, 0, "bfloat16"),
    (2, 256, 8, 2, 128, 128, True, 0, "bfloat16"),
    (1, 70, 2, 1, 192, 128, True, 0, "bfloat16"),
    (1, 300, 4, 1, 192, 128, True, 0, "bfloat16"),
    (1, 300, 4, 1, 256, 256, True, 64, "bfloat16"),
    (2, 333, 4, 2, 256, 256, True, 200, "bfloat16"),
    (2, 500, 4, 2, 64, 64, True, 77, "bfloat16"),
    (2, 300, 4, 4, 80, 80, False, 0, "bfloat16"),
    (1, 200, 8, 2, 64, 64, False, 0, "bfloat16"),
    (1, 130, 4, 2, 128, 128, False, 0, "bfloat16"),
]
FLASH_SLICES = {  # prefill attention of each main path
    "llama3.2-1b": (8, 1024, 32, 8, 64, 64, True, 0, "bfloat16"),
    "recurrentgemma-9b": (4, 4096, 16, 1, 256, 256, True, 2048, "bfloat16"),
    # MLA: 128 heads with their own K (the latents expanded per head), dk 192
    # = 128 nope + 64 rope, dv 128; on flash_fwd_wgmma<256>.
    "deepseek-v2-236b": (4, 4096, 128, 128, 192, 128, True, 0, "bfloat16"),
    # hubert-xlarge's encode: 16 heads of d 80 over every pair of 1500 frames
    # (30 s of audio at 20 ms a frame), on flash_fwd_wgmma<128>.
    "hubert-xlarge": (8, 1500, 16, 16, 80, 80, False, 0, "bfloat16"),
    # internvl2-76b's prefill: 64 heads over 8 KV heads at d 128.
    "internvl2-76b": (4, 2048, 64, 8, 128, 128, True, 0, "bfloat16"),
    # llama3.2-1b's prefill on a rank of model 2 (phase 8(a)): its 16 query
    # heads over 4 KV heads.
    "llama3.2-1b model 2": (8, 1024, 16, 4, 64, 64, True, 0, "bfloat16"),
    # deepseek-v2-236b's MLA prefill on a rank of model 2 (phase 9(a)): its
    # 64 of the 128 heads.
    "deepseek-v2-236b model 2": (4, 4096, 64, 64, 192, 128, True, 0, "bfloat16"),
    # recurrentgemma-9b's prefill on a rank of model 2 (phase 10(a)): its 8
    # query heads over the one KV head, gathered whole (the head-dim split).
    "recurrentgemma-9b model 2": (4, 4096, 8, 1, 256, 256, True, 2048, "bfloat16"),
    # deepseek-v2-236b's MLA prefill on a rank of data 3 (phase 15): one row
    # of 4096 at all 128 heads.
    "deepseek-v2-236b data 3": (1, 4096, 128, 128, 192, 128, True, 0, "bfloat16"),
}
# The plain versions run over slices of the KV heads whose fp32 scores take at
# most this many bytes: whole, MLA's 128 heads would not fit the card
# (34 GB of scores at B 4).  Every other shape here stays in one piece.
PLAIN_BYTES = 2 ** 32
# Largest |out - ref| allowed.  fp32 differs in summation order only.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 is also held per element to |out - ref| <= BF16_RTOL |ref| + BF16_ROW
# rms(ref's row over dv).  Rounding the output moves an element by at most
# one bf16 ulp of its value (2^-7 of it; the bound allows two); rounding P to
# bf16 adds noise of about 2^-9 of the row's scale.  A late row of 2048 keys
# has an RMS near 0.03, so one key more or less at a window edge, or a KV
# tile dropped or doubled, fails the bound where 2e-2 absolute would not.
BF16_RTOL, BF16_ROW = 1.6e-2, 1e-2

# tests/test_kernels.py's RG-LRU cases (T 64: one whole stage of the tma
# variant's ring), then the ring's edges (64-step stages, 32-lane columns):
# T no multiple of a stage (257, 4097) and shorter than one (7, 1), W a
# multiple of 4 but not of the column (20, 36, 4100); then what the TMA
# cannot address, which must take "lane": W % 4 != 0, and inputs one element
# off 16-byte aligned storage.  B, T, W, offset in elements.  Then
# recurrentgemma-9b's prefill scan.
RGLRU_CASES = [(2, 100, 48, 0), (1, 64, 128, 0), (3, 33, 20, 0), (2, 257, 4100, 0),
               (1, 4097, 256, 0), (2, 7, 36, 0), (2, 1, 64, 0), (2, 50, 30, 0), (2, 100, 48, 1)]
RGLRU_SLICE = (4, 4096, 4096)
# Its scans on a rank of model 2 (phase 10(a)): the prefill's and a training
# microbatch's, each over the rank's 2048 channels.
RGLRU_TP_SLICE, RGLRU_TP_TRAIN = (4, 4096, 2048), (1, 4096, 2048)
# The scan's backward: RGLRU_CASES and an h0 ten times the others' (every
# case has a nonzero h0).  B, T, W, offset, h0 scale.
RGLRU_BWD_CASES = [(*c, 1.0) for c in RGLRU_CASES] + [(2, 33, 96, 0, 10.0)]
# recurrentgemma-9b's training scan: one row of train_4k's 4096 tokens.
RGLRU_TRAIN = (1, 4096, 4096)
RGLRU_TOL = 1e-5  # atol and rtol: fp32, fma against mul-then-add rounding only

# Main paths: arch, batch, prompt, generated tokens, layers (None: the
# published depth).  deepseek-v2-236b at published widths is 236 G parameters
# over 60 layers; 4 layers (the dense lead layer and 3 MoE layers) hold 13.3 G,
# 26.6 GB in bf16.  xlstm-1.3b's prompt is its published training context,
# 2048 (arXiv:2405.04517 section 4).  internvl2-76b at published widths cut
# from 80 to 8 layers is 8.946 G parameters, 17.9 GB in bf16; its prompt is
# one image's 256 stub patch embeddings, then 1792 text tokens.
SERVE = [("llama3.2-1b", 8, 1024, 32, None), ("recurrentgemma-9b", 4, 4096, 32, None),
         ("deepseek-v2-236b", 4, 4096, 32, 4), ("xlstm-1.3b", 8, 2048, 32, None),
         ("internvl2-76b", 4, 2048, 32, 8)]
# The encoder's main path (phase 4): hubert-xlarge at published width and
# depth (48 layers, 945.0 M parameters) through build_encode_step: arch,
# batch, frames.  1500 frames are 30 s of audio at the 20 ms frame rate of
# HuBERT's CNN feature extractor (arXiv:2106.07447), whose output the audio
# stub stands in for.
ENCODE = ("hubert-xlarge", 8, 1500)
# Its logits against those with the plain flash version in the kernel's
# place, in relative L2 over the whole output: an H100 read 1.385e-02 (bf16
# rounding carried through 48 layers); a wrong mask moves every row.
ENCODE_PLAIN_TOL = 5e-2
# xlstm-1.3b at published width, phase 4, each in relative L2 over the whole
# output.  The chunkwise form rounds the decay weights, the carried state and
# the products' sums to bf16 where the sequential oracle keeps fp32: each
# term moves by up to 2^-8 of its value; the limit is the CPU tests' bf16
# tolerance.
XLSTM_CHUNKWISE_TOL = 2e-2
# Prefill and one decode step against a forward over the prompt plus that
# token, on the same config in fp32, with tests/test_models_smoke.py's
# tolerances (summation order only).  Not in bf16: there the forward's last
# position reads the carried state through the bf16 roundings above, and a
# stack of 48 random-weight blocks carries them into logits 40 % apart in
# relative L2 (a CPU run at width 256), each as far from fp32.  A decode from
# fresh states (the prompt forgotten) must miss.
XLSTM_PREFILL_TOL = dict(atol=2e-4, rtol=1e-3)
XLSTM_DECODE_TOL = dict(atol=5e-3, rtol=1e-2)
# Phase 3: the port on the card against its CPU path at smoke width.
CHECK = ("llama3.2-1b", "recurrentgemma-9b", "deepseek-v2-236b", "xlstm-1.3b",
         "hubert-xlarge", "internvl2-76b")
# Phase 6(a): smoke training on the card against the CPU, every arch the port
# trains (the MLA archs with their up-projections conditioned: see
# condition_mla).
SMOKE_TRAIN = ("llama3.2-1b", "recurrentgemma-9b", "xlstm-1.3b", "hubert-xlarge",
               "internvl2-76b", "deepseek-v2-236b", "deepseek-v3-671b")
# Their peak learning rate there (the others take 1e-3).  At 1e-3 an H100 read
# one element of deepseek-v3's embed.table 1.096 times TRAIN_TOL from the CPU
# after the third step, every other parameter under 0.05 of it, every step-0
# gradient under 0.11 and every moment under 0.002: that element's row first
# has a gradient at step 3, its own 2.1e-7, under the card-CPU difference of
# that tensor's gradients (up to 2.1e-6), and AdamW's eps term (1e-8) turns a
# difference of a quarter of such a gradient into 2 % of lr in its update.
# An update's difference scales with lr.
SMOKE_MLA_LR = 1e-4

# Phase 6.  Flash gradient cases (B, T, H, K, dk, dv, causal, window, dtype):
# fp32 on simt, bf16 on wgmma; llama's d 64 GQA and recurrentgemma's d 256 MQA.
GRAD_CASES = [
    (2, 64, 4, 2, 32, 32, True, 0, "float32"),
    (1, 96, 8, 8, 64, 64, True, 24, "float32"),
    (2, 256, 8, 2, 64, 64, True, 0, "bfloat16"),
    (1, 300, 4, 1, 256, 256, True, 64, "bfloat16"),
]
# Flash backward cases: GRAD_CASES, then d 128 with H/K = 4, a d 64 window that
# is no multiple of the KV tile over a ragged tail, and dk 192 / dv 128 (MLA,
# on the d-256 kernels); then the edges of the wgmma backward's schedule:
# H/K = 1 and H/K = 8 at d 64 (the group sets the number of steps and which
# consumer owns each step's dQ), a T whose last 128-key block leaves the
# second consumer only padding keys, and a window at d 128; then those of the
# d-256 kernels: H/K = 16 (each head its own group of blocks), a window
# shorter than half a 64-key tile (whole consumer halves masked), Tq with a
# ragged last 64-row tile under a window, and Tk 300 against Tq 100 (an
# optional tenth entry): key tiles past the last query see no query tile, so
# every head group of theirs walks no step; then bf16 that the TMA cannot
# load, on the simt backward: dv 60, and d 256 with q, k and v one element
# off 16-byte aligned storage (an optional eleventh entry); then bf16
# without the causal mask, each key tile walking every query tile: hubert's
# d 80 on flash_bwd_wgmma<128> (dq's fp32 reductions go out in 32-column
# boxes, the one at columns 64-95 clipped at 80) with a T that no tile
# divides, GQA at d 64, and d 128.  bwd_want names the variant each case must
# launch.
BWD_CASES = GRAD_CASES + [
    (2, 256, 8, 2, 128, 128, True, 0, "bfloat16"),
    (2, 500, 4, 2, 64, 64, True, 77, "bfloat16"),
    (1, 70, 2, 1, 192, 128, True, 0, "bfloat16"),
    (1, 512, 8, 8, 64, 64, True, 0, "bfloat16"),
    (1, 512, 8, 1, 64, 64, True, 0, "bfloat16"),
    (1, 4160, 4, 2, 64, 64, True, 0, "bfloat16"),
    (1, 600, 4, 1, 128, 128, True, 100, "bfloat16"),
    (1, 320, 16, 1, 256, 256, True, 128, "bfloat16"),
    (1, 200, 4, 2, 256, 256, True, 16, "bfloat16"),
    (2, 333, 4, 2, 256, 256, True, 200, "bfloat16"),
    (1, 100, 8, 1, 256, 256, True, 0, "bfloat16", 300),
    (1, 70, 2, 1, 64, 60, True, 0, "bfloat16"),
    (1, 130, 4, 1, 256, 256, True, 64, "bfloat16", None, 1),
    (2, 300, 4, 4, 80, 80, False, 0, "bfloat16"),
    (1, 200, 8, 2, 64, 64, False, 0, "bfloat16"),
    (1, 130, 4, 2, 128, 128, False, 0, "bfloat16"),
]
# llama3-8b's attention at train_4k's length (B, T, H, K, dk, dv, causal,
# window, dtype), timed in phase 2: the flash kernels at head dim 128.
TRAIN_D128 = (1, 4096, 32, 8, 128, 128, True, 0, "bfloat16")
# recurrentgemma-9b's attention in one training microbatch (phase 6(d)): MQA
# at d 256 with the 2048 window, forward and backward on wgmma.
TRAIN_RG_ATTN = (1, 4096, 16, 1, 256, 256, True, 2048, "bfloat16")
# deepseek-v2-236b's MLA in phase 6(g)'s microbatch (two rows of train_4k):
# forward and backward on the d-256 kernels.
TRAIN_MLA = (2, 4096, 128, 128, 192, 128, True, 0, "bfloat16")
# internvl2-76b's attention in phase 6(h)'s microbatch: one row of 2048
# positions (256 image embeddings, then text), 64 heads over 8 at d 128.
TRAIN_INTERNVL2_ATTN = (1, 2048, 64, 8, 128, 128, True, 0, "bfloat16")
# hubert-xlarge's attention in one training microbatch (phase 6(f)): 4 rows of
# 1500 frames, 16 heads of d 80, no causal mask; forward and backward on
# wgmma at D 128.
TRAIN_HUBERT_ATTN = (4, 1500, 16, 16, 80, 80, False, 0, "bfloat16")
# llama3.2-1b's attention on a rank of data 2 x model 2 (phase 8(b)): its 2
# rows, its 16 query heads over 4 KV heads.
TRAIN_TP_ATTN = (2, 4096, 16, 4, 64, 64, True, 0, "bfloat16")
# deepseek-v2-236b's MLA on a rank of model 2 (phase 9(b)): 6(g)'s 2 rows,
# 64 of the 128 heads.
TRAIN_EP_ATTN = (2, 4096, 64, 64, 192, 128, True, 0, "bfloat16")
# recurrentgemma-9b's attention on a rank of model 2 (phase 10(a)): 6(d)'s
# microbatch, 8 query heads over the one KV head gathered whole.
TRAIN_TPR_ATTN = (1, 4096, 8, 1, 256, 256, True, 2048, "bfloat16")
# The launches of one flash_attention_bwd call on each variant (``wgmma`` up
# to head dim 128, ``wgmma`` past it, ``simt``), each with the name its
# kernel has in a profiler trace, and the main kernels of each.
BWD_LAUNCHES = {
    "wgmma": {"dq_acc zeroing": "FillFunctor", "flash_bwd_rows": "flash_bwd_rows",
              "flash_bwd_wgmma": "flash_bwd_wgmma<", "flash_bwd_dq_cast": "flash_bwd_dq_cast"},
    "wgmma d 256": {"flash_bwd_rows": "flash_bwd_rows",
                    "flash_bwd_wgmma_dkdv": "flash_bwd_wgmma_dkdv<",
                    "flash_bwd_wgmma_dq": "flash_bwd_wgmma_dq<",
                    "flash_bwd_dkdv_sum": "flash_bwd_dkdv_sum"},
    "simt": {"flash_bwd_rows": "flash_bwd_rows", "flash_bwd_simt_dkdv": "flash_bwd_simt_dkdv",
             "flash_bwd_simt_dq": "flash_bwd_simt_dq"},
}
BWD_MAIN = {"wgmma": ("flash_bwd_wgmma",),
            "wgmma d 256": ("flash_bwd_wgmma_dkdv", "flash_bwd_wgmma_dq"),
            "simt": ("flash_bwd_simt_dkdv", "flash_bwd_simt_dq")}
LSE_TOL = 1e-4  # the forward's lse against the plain version's: fp32 order only
# fp32 gradients: largest |g - oracle|, the oracle's autograd on the same inputs.
GRAD_FP32_TOL = 1e-4
# bf16 gradients are held per element to |g - w| <= GRAD_RTOL |w| + GRAD_ROW
# rms(w's row over d) + GRAD_FLOOR rms(w), w the plain backward in fp32 on fp32
# upcasts of the inputs and the kernel's bf16 output (the floor is for rows
# whose terms cancel, as dq's first row).  tests/test_torch_flash_bwd.py holds
# the bound to both sides on the CPU: an emulation of the wgmma variant's
# roundings (P and dS in bf16, outputs in bf16) reads under 0.5 of it, a window
# off by one key above 2, a dropped KV tile above 10.  The oracle's autograd on
# the same upcasts is not the per-element reference: its D = rowsum(dO O) uses
# the unrounded output, which moves rows whose terms cancel (dq's first row is
# 0 there).  Against it each gradient is held to a relative L2 error of
# GRAD_ORACLE_L2 (bf16 rounding reads about 2.5e-3; lse in the wrong units or a
# wrong mask reads near 1).
GRAD_RTOL, GRAD_ROW, GRAD_FLOOR = 1.6e-2, 2e-2, 1e-3
GRAD_ORACLE_L2 = 1e-2
# The CPU parity tests' tolerance for losses, gradients and parameters (fp32).
TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)
# One full-width bf16 microbatch through the kernel against the same through
# its plain version: relative loss gap, the worst leaf's relative L2 gap of
# its gradient, and the worst leaf's relative gap of the gradient norms.  On
# an H100 the kernel read 3.4e-5, 2.8e-2 (the first layer's wk) and 9.7e-4;
# a recompute wrong on purpose (window 2048 in remat's calls) 0, 0.36 and
# 6.1e-2.  The limits sit about twice and five times above the kernel.
TRAIN_BF16_TOL = {"loss": 5e-4, "grad": 6e-2, "norm": 5e-3}
# Full width: arch, rows per step, tokens per row, microbatches, steps (10
# before phase 11; 6 since, for the script's time: the 6th loss sat 0.33 %
# below the 1st on an H100).
TRAIN = ("llama3.2-1b", 8, 4096, 8, 6)
# Phase 6(d): recurrentgemma-9b at published widths cut to 8 layers (two
# (rec, rec, attn) super-blocks and the two tail rec layers): arch, layers,
# rows per step, tokens per row, microbatches, steps.
RG_TRAIN = ("recurrentgemma-9b", 8, 4, 4096, 4, 6)
# Phase 6(e): xlstm-1.3b at published width cut to 8 of its 48 blocks (one
# super-block of 7 mLSTM and 1 sLSTM under remat): arch, blocks, rows per
# step, tokens per row (the published training context), microbatches,
# steps, peak learning rate (1 warmup step).  Cuts: depth 48 to 8 (a step at
# 48 blocks took ~47-52 s on an H100, the phase ~200-225 s of the script's
# time limit; at 16 blocks 16.3 s, 74 s in train(); 8 leaves room for phase
# 10, whose one-rank reference this run's step 1 is; 48 blocks stay in phase
# 4's serving and in tests/test_torch_xlstm_depth.py); global batch 256 to 4
# rows in one microbatch, not two (the sLSTM's loop over time sets the
# step's pace on the host, alike at 2 rows or 4: on an H100 a step took 114 s
# in two microbatches and 47 s in one); 2 steps (the script's time); no
# checkpoint.
#
# The loss is printed, not held to fall: from these initial weights the
# model does not learn measurably in 4 steps at lr 3e-4, in fp32 as in bf16
# (tools/xlstm_train_witness.py on an H100: the 4th loss above the 1st and
# the first batch's loss higher under the trained weights in both), and the
# port's fp32 is JAX's at 48 blocks (tests/test_torch_xlstm_depth.py).  The
# phase holds instead (1) the first step's loss against the fp32 loss of the
# same weights on the same batch, within XLSTM_LOSS_RTOL: the CPU test at 48
# blocks reads the port's bf16 2.3e-4 and JAX's 7.2e-4 from fp32, an H100
# 1.2e-4 here; (2) the gradient at published width, in fp32 on one row: the
# loss's change between the weights moved by -t g and by +t g against g
# times the displacement that the weights took (after rounding), t set so
# that each side's first-order change is the given change, within the given
# tolerance.  Depth and row are cut for this check alone: at 48 blocks, or
# at 2048 tokens, the loss curves off its tangent before the change along it
# rises above fp32's rounding (the witness's slope leg: ratios -46 to 2.1 at
# 48 blocks and 256 tokens, -0.12 to 0.21 at 8 blocks and 2048).  At 8
# blocks and 256 tokens an H100 reads 0.993 (0.69 at 1e-2), the CPU 1.008
# (vocabulary 1024); a gradient of the wrong scale or sign reads far off.
XLSTM_TRAIN = ("xlstm-1.3b", 8, 4, 2048, 1, 2, 3e-4)
XLSTM_LOSS_RTOL = 2e-3
# The gradient check: blocks, tokens on the row, change a side, tolerance.
XLSTM_SLOPE = (8, 256, 1e-3, 0.05)
# Its microbatch through the kernels against the plain versions, read as
# TRAIN_BF16_TOL.  On an H100 the kernels read 3.9e-5, 2.0e-2 (the last tail
# layer's w_a) and 3.3e-4; a scan backward wrong on purpose (da from h_t) 0,
# 1.44 (the first super-block's lam) and 2.4e-2.  The limits sit about five,
# two and five times above the kernels.
RG_TRAIN_BF16_TOL = {"loss": 2e-4, "grad": 4e-2, "norm": 1.5e-3}
# Phase 6(f): hubert-xlarge at published width and depth (48 layers, each its
# own super-block under remat), bf16 parameters, fp32 AdamW moments: arch,
# rows per step, frames per row, microbatches, steps, peak learning rate (2
# warmup steps).  Cut: global batch, to 8 rows of 30 s of audio; no
# checkpoint.  The loss is printed, not held to fall: the audio stub's
# embeddings are drawn independently of the labels (data/pipeline.py), so the
# model can learn at most the labels' marginal distribution.
HUBERT_TRAIN = ("hubert-xlarge", 8, 1500, 2, 6, 3e-4)
# Its microbatch (4 x 1500) through the kernels against the plain versions,
# read as TRAIN_BF16_TOL.  On an H100 the kernels read 1.9e-5, 1.9e-2 (the
# first layer's wq) and 1.8e-4; the limits sit about five, two and five
# times above.  A recompute wrong on purpose (the causal mask in remat's
# calls, against the forward's lse) gives gradients that are not finite,
# which read as infinitely far.
HUBERT_TRAIN_BF16_TOL = {"loss": 1e-4, "grad": 4e-2, "norm": 1e-3}
# Phase 6(g): deepseek-v2-236b at published widths cut to 2 of its 60 layers
# (the dense lead layer and one MoE layer of 160 routed experts top-6 and 2
# shared: 5.359 G parameters), bf16 parameters, fp32 AdamW moments, block
# remat: arch, layers, rows per step, tokens per row (train_4k's), microbatches,
# steps, peak learning rate (1 warmup step).  Cuts: depth 60 to 2, global
# batch 256 to 2 rows.  One microbatch: the state alone is 64.3 GB (2 + 2 + 8
# bytes a parameter for the weights, the gradients and the moments), and a
# second microbatch adds fp32 accumulators of every gradient (21.4 GB).
DEEPSEEK_TRAIN = ("deepseek-v2-236b", 2, 2, 4096, 1, 4, 3e-4)
# Its microbatch (2 x 4096) through the kernels against the plain versions,
# read as TRAIN_BF16_TOL.  On an H100 the kernels read 1.457e-5, 1.542e-1
# (the routed experts' wo: the attention's bf16 rounding moves the router's
# inputs, and a choice that flips moves its experts' gradients whole) and
# 1.63e-3; a recompute without the causal mask 0, 1.098 (the router) and
# 0.312.  The limits sit about five, two and five times above the kernels.
DEEPSEEK_TRAIN_BF16_TOL = {"loss": 7.5e-5, "grad": 0.3, "norm": 8e-3}
# Phase 6(h): internvl2-76b at published widths cut to 1 of its 80 layers
# (2.957 G parameters), 4 rows of 2048 positions (256 stub image embeddings,
# then 1792 text tokens; the loss over the text) in 4 microbatches, 4 steps.
# Cuts: depth 80 to 1, the global batch to 4 rows.
INTERNVL2_TRAIN = ("internvl2-76b", 1, 4, 2048, 4, 4, 3e-4)
# Its microbatch (1 x 2048), read as above: on an H100 the kernels read
# 1.226e-5, 8.75e-3 (embed.table) and 1.42e-4; a recompute without the
# causal mask 0, 0.906 (the layer's ln2 scale) and 0.298.
INTERNVL2_TRAIN_BF16_TOL = {"loss": 6e-5, "grad": 2e-2, "norm": 7e-4}
# Phase 7: llama3.2-1b at published width trained in 2 pods x 1 data, one
# rank a pod (two processes; they share the card where it is the only one):
# arch, global rows, tokens per row, microbatches per rank (4 rows each:
# phase 6(c)'s 1 x 4096 microbatch), steps per mode, peak learning rate.
# Warmup 0, so that the first update moves the parameters (local mode's pods
# must part after step 1); 6(c)'s warmup of 2 would not.  Cut from 3 steps a
# mode to 2, and from 16 layers to 8 and then to POD_LAYERS, to make room
# for phases 11 and 15 in the script's time: local's pods still part after
# step 1 and meet after step 2 (its parting again after step 3, and int8's
# third step of error feedback, are left to tests/test_torch_multipod_train.py
# on the CPU);
# phase 11 trains every pod mode at published depth.
POD_TRAIN = ("llama3.2-1b", 8, 4096, 4, 2, 3e-4)
POD_LAYERS = 4
POD_MESH = ((2, 1), ("pod", "data"))
POD_MODES = (("flat", {"sync_mode": "flat"}), ("sync", {"sync_mode": "sync"}),
             ("sync+int8", {"sync_mode": "sync", "compress_int8": True}),
             ("local", {"sync_mode": "local", "sync_budget": 2}))
# flat's step 1 against one rank's step 1 of the same cut (6(c)'s batch and
# microbatches at POD_LAYERS), relative: a mean of the same 8 rows' losses
# from the same weights and kernels, summed in another order (a few fp32
# ulps, under 1e-6; against 6(c)'s step 1 at 16 layers it read 0 in every
# run on an H100).
POD_FIRST_RTOL = 1e-6
# flat against sync, step by step, relative.  Step 1 is again the same rows;
# later steps apply gradients summed over other splits of the rows (flat
# hands each rank every second row, sync each pod 4 consecutive rows) and so
# rounded elsewhere, and an update's bf16 rounding then lands on another
# value for a few elements.  Sound runs read 6.3e-6, 6.9e-6, 3.5e-6 and
# 1.46e-5 on an H100 (700 W); the planted fault (``POD_FAULT``) read 4.3e-4,
# and must read above this limit, and above POD_FIRST_RTOL against 6(c).
POD_LOSS_RTOL = 5e-5
# The planted fault: sync in which every rank takes pod 0's rows (a wrong
# split of the batch, :func:`pod_zero_rows`), one step.
POD_FAULT = ("fault: sync on pod 0's rows", {"sync_mode": "sync"}, "pod_zero_rows", 1)
# sync with int8 against exact sync after the last step, absolute
# (tests/test_system.py's bound for the JAX package).
POD_INT8_ATOL = 5e-3
# Phase 8: FSDP and tensor parallelism from sharding/rules.py on a (data,
# model) mesh, llama3.2-1b at published width and depth, its ranks spawned
# as phase 7's (they share the card where it is the only one).  (a) serving
# phase 4's request (SERVE[0]: 8 x 1024 prompt, 32 tokens) at model 2; (b)
# training at data 2 x model 2: global rows, tokens per row, microbatches a
# rank (2 rows each), steps, peak learning rate.  Cut from 6(c): the global
# batch, 8 rows to 4.
TP_SERVE_MESH = ((1, 2), ("data", "model"))
TP_TRAIN_MESH = ((2, 2), ("data", "model"))
TP_TRAIN = ("llama3.2-1b", 4, 4096, 1, 2, 3e-4)
# (a) the prefill's last-token logits against phase 4's one-rank logits, in
# relative L2 over the batch; (b) step 1's loss and grad-norm against a
# one-rank run of the same weights and batch, relative.  The sharded path
# rounds its partial products to bf16 on each rank before it sums them; the
# planted fault (``wi`` split contiguously, so that one model rank holds all
# of gate and the other all of up) must lie outside every limit.  On an H100
# (700 W) a sound run read 1.73e-2, 1.06e-5 and 3.7e-6, the fault 1.31,
# 7.5e-4 and 2.2e-2; at smoke width on the CPU (the rehearsal) sound 9.7e-3,
# 3.4e-6 and 4.6e-4, the fault 1.21, 6.1e-5 and 2.3e-2.
TP_LOGITS_RTOL = 5e-2
TP_LOSS_RTOL = 3e-5
TP_NORM_RTOL = 5e-3
# Phase 9: expert parallelism (models/moe.py's island) with MLA's tensor
# parallelism: deepseek-v2-236b at published widths cut to 2 of its 60 layers
# (the dense lead layer and one MoE layer of 160 routed experts top-6 and 2
# shared: 5.359 G parameters) on the reference's production MoE settings
# (src/repro/launch/dryrun.py: ep_a2a, 16 groups), on (data 1, model 2): two
# ranks spawned as phase 7's (they share the card where it is the only one),
# each with 80 of the experts and 64 of the 128 heads.  (a) phase 4's
# deepseek request: rows, prompt, generated tokens; (b) 6(g)'s 2 x 4096 in
# one microbatch: rows, tokens per row, microbatches, steps, peak learning
# rate (warmup 0), AdamW moments in bf16 as the reference's production run
# for this arch (fp32 moments would take the two ranks' state to 64 GB of the
# card's 80).  (2, 2) and deepseek-v3's 2-D layout wait for meta-device init
# (ROADMAP's item 4): four ranks drawing the whole tree would pass 80 GB.
EP_MESH = ((1, 2), ("data", "model"))
EP_LAYERS = 2
EP_SERVE = ("deepseek-v2-236b", 4, 4096, 32)
EP_TRAIN = ("deepseek-v2-236b", 2, 4096, 1, 2, 3e-4)
# Against a one-rank run of the same weights in which each model rank's slice
# is routed as a group of its own (island_groups): (a) the prefill's
# last-token logits in relative L2 over the batch; (b) step 1's loss and
# grad-norm, relative.  The ranks round their partial sums (MLA's heads, the
# shared experts) to bf16 before they add them.  On an H100 (700 W) a sound
# run read 1.716e-2, 2.85e-6 and 9.35e-6; the planted fault (results in
# reverse source order) 2.224e-2, 1.917e-5 and 6.49e-6: at the reference's
# init the router's softmax over 160 experts gives each chosen expert a gate
# near 1/160, so the routed experts move the logits and the grad-norm less
# than the bf16 sharding does, and only the loss of these three tells the
# fault.  What does: the island's output against the one-rank route of the
# same inputs on the same rank (island_probe: each slice a group, every
# expert's weights gathered over model), in relative L2 over a call: 0 in
# the sound runs (serving and training, on the H100 and at smoke width on
# the CPU), 1.39 under the fault.  The fault must lie outside it in (a) and
# (b), and outside the loss's limit; the limit leaves room for expert
# products that another batch shape would round otherwise.
EP_LOGITS_RTOL = 5e-2
EP_LOSS_RTOL = 1e-5
EP_NORM_RTOL = 1e-4
EP_ISLAND_RTOL = 1e-2
# Phase 10: tensor parallelism for RG-LRU and xLSTM blocks, and the head-dim
# split of KV heads that do not divide over model, on (data 1, model 2): two
# ranks spawned as phase 7's (they share the card where it is the only one).
# Served: each (arch, config fields, rows, prompt, generated tokens, planted
# fault); recurrentgemma-9b at 6(d)'s cut (8 of 38 layers: two (rec, rec,
# attn) super-blocks and two tail rec layers) with phase 4's request,
# xlstm-1.3b at 6(e)'s (one super-block of 7 mLSTM and 1 sLSTM blocks) with
# phase 4's, in fp32: in bf16 the TP ranks' other rounding of the same sums
# moved its logits 0.19 in relative L2 and step 1's grad-norm 4 % from one
# rank's on an H100 (phase 4's XLSTM_PREFILL_TOL says why: its blocks carry
# bf16 rounding into the logits).  Each served cut is held to one rank's
# prefill of it on the same prompts.  Since PR 32 xlstm generates
# TPR_XLSTM_TOKENS tokens, not phase 4's 32, for the script's time (phase
# 14 came in): at 72-121 ms a token that is 2-3 s.
TPR_MESH = ((1, 2), ("data", "model"))
TPR_XLSTM = {"num_layers": XLSTM_TRAIN[1], "dtype": "float32"}
TPR_XLSTM_TOKENS = 8
TPR_SERVE = ((RG_TRAIN[0], {"num_layers": RG_TRAIN[1]}, *SERVE[1][1:4], "rope_before_gather"),
             (XLSTM_TRAIN[0], TPR_XLSTM, *SERVE[3][1:3], TPR_XLSTM_TOKENS, None))
# Trained: each (arch, config fields, rows, tokens per row, microbatches,
# steps, peak lr, warmup steps), held to one rank's step 1: recurrentgemma-9b
# 6(d)'s run cut to 2 steps, whose step 1 is 6(d)'s (at 2 of its rows a step,
# 4 microbatches' bytes halved, step 1's loss read 4.86e-5 from one rank's on
# an H100, over the 3e-5 limit, where 6(d)'s 4 rows read 1.15e-6: the limit
# sits at this arch's bf16 rounding over ranks); xlstm-1.3b one step of 4
# rows of 6(e)'s slope row length in fp32, held to one rank's step made here
# (at 2048 tokens the sLSTM's loop over time makes a step 13-18 s).
TPR_TRAIN = ((RG_TRAIN[0], {"num_layers": RG_TRAIN[1]}, *RG_TRAIN[2:5], 2, 3e-4, 2),
             (XLSTM_TRAIN[0], TPR_XLSTM, XLSTM_TRAIN[2], XLSTM_SLOPE[1], 1, 1,
              XLSTM_TRAIN[6], 1))
# The mLSTM's planted fault (w_if_through_g) leaves the forward as it is and
# drops part of the gates' gradient, which flows into w_up.  The probe reads
# w_up's gradient in fp32 at the initial weights on 6(e)'s slope row (arch,
# layers, tokens, key), each rank's block against one rank's, in relative
# L2.  On an H100 (700 W) one rank's gradient moved 5.7e-4 between the row
# taken once and twice, and 7.0e-4 between the card and its host's CPU (the
# xLSTM's exponential gates carry fp32's summation order that far); the
# ranks read 3.6e-4 and 3.8e-4, the fault 0.50 and 0.52.
TPR_PROBE = (XLSTM_TRAIN[0], XLSTM_SLOPE[0], XLSTM_SLOPE[1], "blocks.b0.cell.w_up")
TPR_GRAD_RTOL = 5e-3
# Phase 11: pods combined with FSDP and tensor parallelism, the reference's
# (pod, data, model) mesh: llama3.2-1b at published width and depth on (pod
# 2, data 1, model 2), four ranks spawned as phase 7's (they share the card
# where it is the only one), every pod holding its model ranks' blocks.
# (a) serving phase 4's request (SERVE[0]: 8 x 1024 prompt, 32 tokens), each
# pod its 4 rows, held to phase 4's one-rank logits within TP_LOGITS_RTOL;
# (b) training phase 8's batch (TP_TRAIN: 4 rows x 4096 at lr 3e-4, warmup
# 0): global rows, tokens per row, microbatches a rank (2 rows a pod, one row
# each), steps in each of POD_MODES, peak learning rate; step 1 held to
# phase 8's one-rank step 1 of the same weights and rows within TP_LOSS_RTOL
# and TP_NORM_RTOL, flat to sync within POD_LOSS_RTOL, int8 to sync within
# POD_INT8_ATOL.
POD_TP_MESH = ((2, 1, 2), ("pod", "data", "model"))
POD_TP_TRAIN = ("llama3.2-1b", 4, 4096, 2, 2, 3e-4)
# The planted fault: the pod groups built across model ranks (pod 0's model
# rank m with pod 1's model rank M-1-m, :func:`crossed_pod_group`), so that
# a rank's blocks are summed with another rank's blocks of each leaf; two
# steps of sync.  Step 1's loss comes before any exchange and cannot show
# it: the pods' blocks at one (data, model) coordinate must part after step
# 1, and step 2's loss must lie outside POD_LOSS_RTOL of sound sync's.
POD_TP_FAULT = ("fault: pod groups across model ranks", {"sync_mode": "sync"},
                "crossed_pod_group", 2)
# Phase 12: MoE served on (pod, data) rows: phase 9's config (ep_config:
# deepseek-v2-236b at published widths cut to 2 of its 60 layers, ep_a2a, 16
# groups) on (pod 2, data 1, model 2), four ranks spawned as phase 7's (they
# share the card where it is the only one), each pod's model ranks holding 80
# of the 160 experts and 64 of the 128 heads, serving phase 9's request
# (EP_SERVE: 4 x 4096, 32 tokens), 2 rows a rank.  The prefill runs the island
# inside each pod (capacity per source slice: a model rank's slice of its
# pod's 2 rows); decode runs the scatter path, its one group (4 tokens do not
# split into 16 groups) spanning both pods' rows.  Held to one rank's
# prefill and greedy decode of the same weights and prompts whose MoE routes
# each pod's model-rank slice as a group (island_groups with pods 2): logits
# within EP_LOGITS_RTOL, first tokens equal (later tokens are printed: the
# ranks' bf16 rounding flips near-tied greedy choices, after which a row goes
# its own way, as phase 8's rows do).  At 4 rows no expert drops a decode
# choice, so the tokens cannot tell a group over one pod from one over both;
# the probe (slot_offsets) reads decode's slot offsets on pod 1's ranks,
# which must be pod 0's counts, and the planted fault (pod_alone_rows, each
# pod routed alone) must fail it.  The ranks draw their weights at once where
# four ranks' init peaks (init_need) leave 8 GB of the card free, else one at
# a time (one_at_a_time).  Training over pods at published width does not fit one
# card: one replica peaks at 71 GB on one rank (6(g)), and two pods hold two;
# it is held to JAX on CPU ranks only (tests/test_torch_pod_shard.py).
EP_POD_MESH = ((2, 1, 2), ("pod", "data", "model"))
# The free memory that four ranks' init peaks must leave for phase 12 to
# build its ranks at once.
EP_POD_AT_ONCE_FREE = 8e9
# Phase 15: MoE on counts that do not divide.  deepseek-v2-236b at phase 9's
# cut (EP_LAYERS of 60 layers: the dense lead and one MoE layer of 160
# experts top-6 and 2 shared) on ep2d with 16 groups, over (data 3, model 1):
# three ranks share the card, their exchanges over gloo.  160 experts do not
# divide over 3 ranks (fit_pspec leaves wi and wo whole: every rank holds and
# runs all of them), and 16 groups of 768 tokens straddle the three ranks'
# 4096 each; d_model 5120 and the vocab do not divide by 3 either, so a rank
# holds nearly the whole 5.36 G parameters.  With model 1 the reference's
# fault on (3, 2) (ROADMAP's Queue 3) does not arise.  Served: one row of
# 4096 prompt tokens a rank and 2 generated tokens (rows, prompt, generated),
# held to one rank's prefill and decode of the same three rows, routed in the
# reference's 16 groups of the whole batch; the ranks' slot offsets probed
# (piece_offsets) and the planted fault (own_counts: each rank's pieces
# offset by nothing, their groups' counts its own) must fail the probe.  A
# training step does not fit one card (three replicas of gradients and
# moments); CPU ranks hold it to JAX (tests/test_torch_moe_uneven.py).
UNEVEN_EP_MESH = ((3, 1), ("data", "model"))
UNEVEN_EP_SERVE = (3, 4096, 2)
# Phase 13: the dry run (launch/dryrun.py) on this machine's CPU, every
# tensor on the meta device.  (b) The one-card cells that earlier phases
# measured, at their settings: name, arch, (positions, rows, kind),
# microbatches, cache length: 6(c)'s training step, phase 4's llama3.2-1b
# prefill (its cache as long as the request's prompt and tokens) and phase
# 4's hubert-xlarge encode.  (c) Two production cells: arch, shape, pods.
DRY_MEASURED = (
    ("llama3.2-1b train", TRAIN[0], (TRAIN[2], TRAIN[1], "train"), TRAIN[3], None),
    ("llama3.2-1b prefill", SERVE[0][0], (SERVE[0][2], SERVE[0][1], "prefill"), None,
     SERVE[0][2] + SERVE[0][3]),
    ("hubert-xlarge encode", ENCODE[0], (ENCODE[2], ENCODE[1], "prefill"), None, None))
DRY_PRODUCTION = (("llama3-8b", "train_4k", False), ("deepseek-v3-671b", "train_4k", True))
# The bands that PERF.md stated before the first run: each peak estimate over
# the phase's max_memory_allocated, and model_flops_estimate over the
# script's own count of the model FLOPs.  Every measured time must be at
# least the roofline's largest term.  The phase's budget in seconds.
DRY_PEAK_BAND = (0.7, 1.4)
DRY_FLOPS_BAND = (0.75, 1.25)
DRY_BUDGET_S = 60
# Phase 14: tensor parallelism on widths that do not divide over model,
# xlstm-1.3b at phase 10(b)'s cut and dtype (8 blocks, fp32) on (data 1,
# model 8), eight ranks spawned as phase 7's (they share the card where it is
# the only one).  Its 4 heads do not divide over 8 (its inner width 4096
# does): fit_pspec keeps wq, wk and wv whole, and the sLSTM's FFN (2 x 2730
# columns) and cell stay whole too.  Served: phase 10(b)'s request (8 x 2048
# prompt), decode cut to UNEVEN_DECODE tokens, held to phase 10's one-rank
# prefill logits and first tokens; trained: TPR_TRAIN's xlstm step, held to
# phase 10's one-rank step 1; probed: the fp32 gradient of the whole wq.
# Generated tokens cut to 2 (one decode step after the prefill's token): an
# H100 read 650 ms a token over the 8 ranks, and the script's time on the
# slowest machine seen projected past 1100 s with 8.
UNEVEN_MESH = ((1, 8), ("data", "model"))
UNEVEN_DECODE = 2
UNEVEN_SERVE = ((*TPR_SERVE[1][:4], UNEVEN_DECODE, None),)
UNEVEN_TRAIN = (TPR_TRAIN[1],)
UNEVEN_PROBE = (*TPR_PROBE[:3], "blocks.b0.cell.wq")
# The script's target time (ROADMAP), half of its 1200 s time limit: the
# last line before the JSON says when a run went over it.
TARGET_S = 600
# The ops-level functions that the plain versions replace in a microbatch.
KERNEL_ENTRIES = ("_flash_fwd", "_flash_bwd", "_scan_fwd", "_scan_bwd")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def condition_mla(model) -> None:
    """Scale each MLA up-projection (``w_uq``, ``w_uk``, ``w_uv``, each
    ``[..., rank, heads, d]``) by sqrt(heads / rank) in place: drawn at
    1 / sqrt(rank), the fan-in of the rank it contracts over, where the
    reference's initializer reads the heads axis (4 at smoke width).  At the
    draws as they are, the smoke models' attention scores have a standard
    deviation near 8 and their gradients are finer than fp32 resolves: a
    relative change of 1e-7 in ``embed.table`` moves deepseek-v3's by up to
    86 times TRAIN_TOL, so two fp32 runs that differ in summation order
    alone (card and CPU) disagree by more than it
    (``tests/test_torch_moe_train.py``)."""
    import torch

    with torch.no_grad():
        for key, p in model.named_parameters():
            if key.rsplit(".", 1)[-1] in ("w_uq", "w_uk", "w_uv"):
                p.mul_(math.sqrt(p.shape[-2] / p.shape[-3]))


def smoke_train_steps(arch: str, dev, steps: int = 3):
    """``steps`` fp32 train steps of ``arch``'s smoke config on ``dev`` and on
    the CPU from one init (drawn on ``dev``; MLA's up-projections conditioned,
    :func:`condition_mla`); two microbatches per step.  Returns each step's
    (loss on dev, loss on CPU, grad-norm on dev, on CPU) and the largest
    parameter difference; raises on a disagreement."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.launch.train import to_device
    from repro_torch.models import Model

    cfg = get_config(arch, smoke=True).with_overrides(dtype="float32")
    mla = cfg.attention == "mla"
    run = RunConfig(learning_rate=SMOKE_MLA_LR if mla else 1e-3, warmup_steps=1,
                    total_steps=steps, microbatches=2)
    card = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    if mla:
        condition_mla(card)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    models = {"card": card, "cpu": cpu}
    states = {k: init_train_state(m, run) for k, m in models.items()}
    fns = {k: build_train_step(m, run) for k, m in models.items()}
    data = SyntheticLMDataset(cfg, ShapeConfig("smoke", 64, 4, "train"), seed=0)
    rows = []
    for i in range(steps):
        batch = {k: to_device(v, torch.device("cpu")) for k, v in data.batch(i).items()}
        out = {}
        for k, m in models.items():
            states[k], metrics = fns[k](states[k], {n: t.to(m.device) for n, t in batch.items()})
            out[k] = (metrics["loss"].item(), metrics["grad_norm"].item())
        rows.append((out["card"][0], out["cpu"][0], out["card"][1], out["cpu"][1]))
        for got, want in ((out["card"][0], out["cpu"][0]), (out["card"][1], out["cpu"][1])):
            torch.testing.assert_close(torch.tensor(got), torch.tensor(want), **TRAIN_TOL)
    worst = 0.0
    for key, p in cpu.named_parameters():
        got = card.get_parameter(key).detach().cpu()
        torch.testing.assert_close(got, p.detach(), **TRAIN_TOL, msg=f"{arch} {key}")
        worst = max(worst, (got - p.detach()).abs().max().item())
    return rows, worst


def resumed_losses(arch: str, dev, directory: str):
    """Losses of a 6-step smoke run, and of a run checkpointed at step 3 and
    resumed through step 6, in ``directory``."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch.train import train

    shape = ShapeConfig("smoke", 32, 4, "train")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=6, checkpoint_every=3)
    whole = train(arch, steps=6, shape=shape, log_every=1, device=dev,
                  run=RunConfig(checkpoint_dir=f"{directory}/whole", **kw))
    run = RunConfig(checkpoint_dir=f"{directory}/split", **kw)
    first = train(arch, steps=3, shape=shape, log_every=1, device=dev, run=run)
    rest = train(arch, steps=6, shape=shape, log_every=1, device=dev, run=run, resume=True)
    return ([h["loss"] for h in whole["history"]],
            [h["loss"] for h in first["history"] + rest["history"]])


def plain_entries(wrong_scan_bwd: bool = False):
    """The plain versions in place of ``ops``' kernel entries
    (:data:`KERNEL_ENTRIES`), flash attention's over the slices of
    :func:`head_slices` (whole, MLA's 128 heads at 2 x 4096 take 17 GB of
    fp32 scores, and the backward three times that); with
    ``wrong_scan_bwd``, a scan backward that is wrong on purpose: da from
    h_t in place of h_{t-1}."""
    import torch

    from repro_torch.kernels import ref

    def slices(q, k):
        return head_slices(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2])

    def flash_fwd(q, k, v, causal, window, scale, lse=False):
        fn = ref.flash_attention_lse_ref if lse else ref.flash_attention_ref
        parts = [fn(q[:, :, hq], k[:, :, hk], v[:, :, hk], causal=causal, window=window,
                    scale=scale) for hq, hk in slices(q, k)]
        if len(parts) == 1:
            return parts[0]
        if not lse:
            return torch.cat(parts, dim=2)
        return torch.cat([o for o, _ in parts], dim=2), torch.cat([m for _, m in parts], dim=1)

    def flash_bwd(q, k, v, out, lse, g, causal, window, scale):
        parts = [ref.flash_attention_bwd_ref(q[:, :, hq], k[:, :, hk], v[:, :, hk],
                                             out[:, :, hq], lse[:, hq], g[:, :, hq],
                                             causal=causal, window=window, scale=scale)
                 for hq, hk in slices(q, k)]
        return parts[0] if len(parts) == 1 else tuple(torch.cat(x, dim=2) for x in zip(*parts))

    def scan_bwd(a, h, h0, g):
        da, db, dh0 = ref.rglru_scan_bwd_ref(a, h, h0, g)
        return (db * h, db, dh0) if wrong_scan_bwd else (da, db, dh0)

    return {"_flash_fwd": flash_fwd, "_flash_bwd": flash_bwd,
            "_scan_fwd": lambda a, b, h0: ref.rglru_scan_ref(a, b, h0), "_scan_bwd": scan_bwd}


def microbatch_grads(model, batch, swap=None):
    """One microbatch's loss and every parameter's gradient (zeros for one the
    loss does not read); ``swap`` maps names of :data:`KERNEL_ENTRIES` to
    functions that ``ops`` calls in their place (the forward, remat's
    recompute and the backward), the autograd Functions staying as they
    are."""
    import torch

    from repro_torch.kernels import ops

    names, params = zip(*model.named_parameters())
    real = {name: getattr(ops, name) for name in KERNEL_ENTRIES}
    for name, fn in (swap or {}).items():
        setattr(ops, name, fn)
    try:
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return loss.item(), dict(zip(names, grads))


def expected_launches(plan, microbatches: int, mtp_depth: int = 0):
    """Kernel launches of one training step under block remat: per
    microbatch, each layer's forward once and the stacked super-blocks' once
    more in remat's recompute, and each layer's backward once; a MoE model's
    dense lead layers and DeepSeek-V3's MTP block (``mtp_depth``) attend
    outside remat, once each way."""
    def count(kind, recompute):
        once = plan.tail.count(kind) + plan.lead.count(f"{kind}_dense")
        if kind == "attn":
            once += mtp_depth
        return microbatches * ((1 + recompute) * plan.n_scan * plan.pattern.count(kind) + once)

    return {"flash_attention": count("attn", 1), "flash_attention_bwd": count("attn", 0),
            "rglru_scan": count("rec", 1), "rglru_scan_bwd": count("rec", 0)}


def forward_flash_calls(cfg) -> int:
    """The flash calls of one microbatch's forward, ahead of remat's
    recompute: every attention layer's and the MTP block's, one each, as
    many as the backward's."""
    from repro_torch.models import layer_plan

    return expected_launches(layer_plan(cfg), 1, cfg.mtp_depth)["flash_attention_bwd"]


def expected_counts(plan, microbatches, mtp_depth: int = 0):
    """launch_counts()' keys for one training step: the kernels' launches
    (:func:`expected_launches`) and, by variant, every flash launch, forward
    and backward, on ``wgmma`` and every scan launch, forward and backward,
    on ``tma``."""
    out = dict.fromkeys(launch_counts(), 0)
    out.update(expected_launches(plan, microbatches, mtp_depth))
    for name, kind in (("flash_attention", "wgmma"), ("flash_attention_bwd", "wgmma"),
                       ("rglru_scan", "tma"), ("rglru_scan_bwd", "tma")):
        out[f"{name}:{kind}"] = out[name]
    return out


@contextlib.contextmanager
def counted_plain_calls():
    """Count every call of a plain version (``kernels/ref.py``) in the block;
    yields the counts by name."""
    from repro_torch.kernels import ref

    calls = {}
    names = ("flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref",
             "rglru_scan_ref", "rglru_scan_bwd_ref")
    real = {name: getattr(ref, name) for name in names}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(ref, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(ref, name, fn)


@contextlib.contextmanager
def timed_backwards(functions):
    """CUDA events around each call of each autograd Function's backward in
    the block, and the transient memory it took; yields, per label of
    ``functions`` ({label: Function}), a list of (start, end, peak bytes)."""
    import torch

    log = {label: [] for label in functions}
    real = {label: fn.__dict__["backward"] for label, fn in functions.items()}

    def timed(label):
        inner = real[label].__func__

        def backward(ctx, *grads):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start.record()
            out = inner(ctx, *grads)
            end.record()
            log[label].append((start, end, torch.cuda.max_memory_allocated() - base))
            return out
        return staticmethod(backward)

    for label, fn in functions.items():
        fn.backward = timed(label)
    try:
        yield log
    finally:
        for label, fn in functions.items():
            fn.backward = real[label]


def timed_microbatch(model, batch, functions):
    """One microbatch's forward and backward (every parameter's gradient),
    each timed with CUDA events, and each call of the backward of each
    autograd Function in ``functions`` ({label: Function}): returns (forward
    ms, backward ms, {label: [(ms, transient bytes)]})."""
    import torch

    params = list(model.parameters())
    with timed_backwards(functions) as log:
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        loss, _ = model.loss(batch)
        mid.record()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        end.record()
        end.synchronize()
    del loss, grads
    return (start.elapsed_time(mid), mid.elapsed_time(end),
            {label: [(a.elapsed_time(b), peak) for a, b, peak in calls]
             for label, calls in log.items()})


def launch_counts():
    """Every kernel wrapper's launches, in all and by variant."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd

    out = {"flash_attention": flash_attention_fwd.launches,
           "flash_attention_bwd": flash_attention_bwd.launches,
           "rglru_scan": rglru_scan_fwd.launches, "rglru_scan_bwd": rglru_scan_bwd.launches}
    for name, fn in (("flash_attention", flash_attention_fwd),
                     ("flash_attention_bwd", flash_attention_bwd),
                     ("rglru_scan", rglru_scan_fwd), ("rglru_scan_bwd", rglru_scan_bwd)):
        out.update((f"{name}:{v}", c) for v, c in fn.launches_by_variant.items())
    return out


@contextlib.contextmanager
def timed_optimizer():
    """CUDA events around each AdamW update that a train step makes in the
    block (the global norm, the clip factor and the chunked update); yields
    a list of (start, end)."""
    import torch

    from repro_torch.launch import steps

    log = []
    real = steps.adamw_update

    def update(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real(*args, **kwargs)
        end.record()
        log.append((start, end))
        return out

    steps.adamw_update = update
    try:
        yield log
    finally:
        steps.adamw_update = real


def reset_counts():
    """Every kernel wrapper's launches, in all and by variant, set to 0."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd

    for fn in (flash_attention_fwd, flash_attention_bwd, rglru_scan_fwd, rglru_scan_bwd):
        fn.launches = 0
        fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)


@contextlib.contextmanager
def at_depth(module, layers, **over):
    """``get_config`` in ``module``'s namespace patched to cut every config to
    ``layers`` layers in the block, and to set its fields ``over`` (no knob
    of the entry point changes); with neither, nothing is patched."""
    real = module.get_config
    if layers:
        over["num_layers"] = layers
    if over:
        module.get_config = lambda a, smoke=False: real(a, smoke).with_overrides(**over)
    try:
        yield
    finally:
        module.get_config = real


def counted_training(arch, layers, shape, run, device, smoke=False):
    """``train(arch)`` for ``run.total_steps`` steps at ``layers`` layers:
    ``get_config`` is patched in train's namespace for the call (no knob of
    train() changes), and each step's launches are counted from zero.
    Returns (train's result, each step's launch_counts(), the calls of each
    plain version during the run)."""
    from repro_torch.launch import train as train_mod

    step_counts = []
    real_step = train_mod.build_train_step

    def counted_step(model, run_, mesh=None):
        step = real_step(model, run_, mesh)

        def call(state, batch):
            before = launch_counts()
            out = step(state, batch)
            step_counts.append({k: c - before[k] for k, c in launch_counts().items()})
            return out
        return call

    train_mod.build_train_step = counted_step
    try:
        with at_depth(train_mod, layers), counted_plain_calls() as plain_calls:
            res = train_mod.train(arch, smoke=smoke, steps=run.total_steps, shape=shape,
                                  run=run, log_every=1, device=device)
    finally:
        train_mod.build_train_step = real_step
    return res, step_counts, plain_calls


def train_step_flops(cfg, params, rows: int, T: int):
    """Model FLOPs of one training step of a decoder over ``rows`` x ``T``
    positions, and the attention's part: 6 per active weight per position it
    is used at (a MoE layer's routed experts count top_k of num_experts of
    theirs; the embedding table, a lookup, none; the unembedding only at the
    positions the loss covers: a vision stub's image positions are left
    out), plus causal attention's QK^T and PV (2 FLOP per multiply-add over
    dk + dv) over the T(T+1)/2 unmasked pairs of each row and head, three
    times (forward and backward) in every attention layer.  Remat's
    recompute and the capacity buffer's empty slots are not model work and
    are not counted.  ``params``: {key: tensor}."""
    from repro_torch.models import layer_plan

    text = T - cfg.frontend_tokens if cfg.frontend == "vision" else T
    head = "embed.table" if cfg.tie_embeddings else "unembed.w"
    stack = unembed = 0.0
    for key, p in params.items():
        n = p.numel()
        if key == head:
            unembed = n
        elif key == "embed.table":
            continue
        elif (cfg.moe and key.endswith(("ffn.wi", "ffn.wo")) and p.ndim >= 3
              and p.shape[-3] == cfg.moe.num_experts):
            stack += n * cfg.moe.top_k / cfg.moe.num_experts
        else:
            stack += n
    if cfg.attention == "mla":
        dk, dv = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim, cfg.mla.v_head_dim
    else:
        dk = dv = cfg.resolved_head_dim
    plan = layer_plan(cfg)
    n_attn = (len(plan.lead) + plan.n_scan * plan.pattern.count("attn")
              + plan.tail.count("attn"))
    attn = 3 * 2 * (dk + dv) * cfg.num_heads * (T * (T + 1) // 2) * rows * n_attn
    return 6 * (stack * T + unembed * text) * rows + attn, attn, stack + unembed


def param_digest(params) -> int:
    """A digest of the parameters' bits: the sum over every element of its
    bits (as an integer) times a fixed pseudo-random weight of its position,
    wrapping in int64.  Equal bits give equal digests; one element that
    differs changes it, but for a chance near 2^-64."""
    import torch

    chunk = 2 ** 24
    some = next(iter(params.values()))
    weights = torch.randint(1, 2 ** 62, (chunk,), dtype=torch.int64, device=some.device,
                            generator=torch.Generator(some.device).manual_seed(0))
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    total = torch.zeros((), dtype=torch.int64, device=some.device)
    for p in params.values():
        flat = p.detach().reshape(-1).view(bits[p.element_size()]).to(torch.int64)
        for i in range(0, flat.numel(), chunk):
            part = flat[i:i + chunk]
            total += (part * weights[:part.numel()]).sum()
    return int(total)


@contextlib.contextmanager
def pod_zero_rows():
    """Phase 7's planted fault: every rank takes pod 0's rows (``rank_rows``
    patched in the steps' namespace), a wrong split of the batch."""
    from repro_torch.launch import steps as steps_mod

    real = steps_mod.rank_rows
    steps_mod.rank_rows = lambda batch, mesh, *a: real(
        batch, dataclasses.replace(mesh, coords={**mesh.coords, "pod": 0}), *a)
    try:
        yield
    finally:
        steps_mod.rank_rows = real


@contextlib.contextmanager
def crossed_pod_group():
    """Phase 11's planted fault: meshes made in the block build each ``pod``
    group of a 2-pod ``(pod, data, model)`` mesh across model ranks, pod 0's
    model rank ``m`` with pod 1's model rank ``M - 1 - m`` (the data rank
    kept), so that a rank's blocks are summed with another rank's blocks of
    each leaf."""
    from repro_torch.launch import mesh as mesh_mod

    real = mesh_mod.group_ranks

    def crossed(sizes, span):
        if tuple(span) != ("pod",):
            return real(sizes, span)
        D, M = sizes.get("data", 1), sizes.get("model", 1)
        return [[d * M + m, (D + d) * M + M - 1 - m] for d in range(D) for m in range(M)]

    mesh_mod.group_ranks = crossed
    try:
        yield
    finally:
        mesh_mod.group_ranks = real


def pod_rank(arch, rows, seq, micro, n_steps, lr, smoke=False, device=None,
             mesh_spec=POD_MESH, fault=POD_FAULT, over=None):
    """One rank of phase 7 (and of 11), spawned (``launch.mesh.spawn_ranks``):
    ``train(arch)`` (its config's fields ``over`` set by :func:`at_depth`)
    on ``mesh_spec`` in each mode of ``POD_MODES``, then
    ``fault[3]`` steps of ``fault`` (its run config, under the context
    manager of this module named ``fault[2]``: phase 7's
    :func:`pod_zero_rows`, 11's :func:`crossed_pod_group`), with
    ``build_train_step`` wrapped (in train's namespace) to count each step's
    launches from zero and take a :func:`param_digest` of the rank's
    parameters (its blocks on a sharded mesh) after it (its own seconds
    apart, after a device synchronisation).  Returns, per mode, the history,
    the steps' launches, digests and digest seconds, the calls of the plain
    versions, the groups' backends, the rank's coordinates, the parameters'
    count, bytes and leaves, the moments' bytes, the peak memory and
    ``mem_get_info`` at the end."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import train as train_mod

    real_step, out = train_mod.build_train_step, []
    for name, kw, *_ in POD_MODES + (fault,):
        steps, seen = [], {}
        mode_steps = fault[3] if name == fault[0] else n_steps

        def counted_step(model, run_, mesh=None):
            step = real_step(model, run_, mesh)
            seen.update(backends=dict(mesh.backends), device=str(mesh.device),
                        coords=dict(mesh.coords))

            def call(state, batch):
                before = launch_counts()
                new_state, metrics = step(state, batch)
                counts = {k: c - before[k] for k, c in launch_counts().items()}
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
                t0 = time.perf_counter()
                digest = param_digest(new_state["params"])
                steps.append({"launches": counts, "digest": digest,
                              "digest_s": time.perf_counter() - t0})
                return new_state, metrics
            return call

        train_mod.build_train_step = counted_step
        planted = globals()[fault[2]]() if name == fault[0] else contextlib.nullcontext()
        try:
            with (tempfile.TemporaryDirectory() as tmp, counted_plain_calls() as plain,
                  planted, at_depth(train_mod, None, **(over or {}))):
                if device is None:
                    torch.cuda.reset_peak_memory_stats()
                run = RunConfig(learning_rate=lr, warmup_steps=0, total_steps=n_steps,
                                microbatches=micro, checkpoint_every=10 ** 9,
                                checkpoint_dir=tmp, **kw)
                res = train_mod.train(arch, smoke=smoke, steps=mode_steps,
                                      shape=ShapeConfig("train_4k", seq, rows, "train"),
                                      mesh_shape=mesh_spec[0], mesh_axes=mesh_spec[1], run=run,
                                      log_every=1, device=device)
        finally:
            train_mod.build_train_step = real_step
        state = res["final_state"]
        params = state["params"]
        rec = {"mode": name, "history": res["history"], "steps": steps, "plain": dict(plain),
               "n_params": sum(p.numel() for p in params.values()), "n_leaves": len(params),
               "param_bytes": sum(p.numel() * p.element_size() for p in params.values()),
               "moment_bytes": sum(t.numel() * t.element_size() for g in ("mu", "nu")
                                   for t in state["opt"][g].values()),
               **seen}
        del res, state, params
        gc.collect()
        if device is None:
            torch.cuda.empty_cache()
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["free_total_gb"] = tuple(b / 1e9 for b in torch.cuda.mem_get_info())
        out.append(rec)
    return out


def check_step_launches(who, steps, plain, per_step):
    """Each training step's launches (``steps``: the counts of each step) of
    ``per_step``'s keys equal it, flash's all on ``wgmma``, with no call of
    a plain version (``plain``); ``per_step`` None, on the CPU: no launch."""
    if per_step is not None and plain:
        raise AssertionError(f"{who} called the plain versions {plain}")
    for i, s in enumerate(steps):
        got = {k: s[k] for k in (per_step or {})}
        wgmma = {k: s.get(f"{k}:wgmma", 0) for k in ("flash_attention", "flash_attention_bwd")}
        if per_step is None and any(s.values()):
            raise AssertionError(f"{who}: launches on the CPU")
        if per_step is not None and (got != per_step or any(
                wgmma[k] != per_step[k] for k in wgmma)):
            raise AssertionError(f"step {i + 1} {who}: launches {s}, expected {per_step}, "
                                 "all wgmma")


def pods_equal(recs):
    """Per step, over the ranks' :func:`pod_rank` records of one mode: whether
    the pods' parameters (their blocks on a sharded mesh) are bit-identical
    at every ``(data, model)`` coordinate, by their digests."""
    at = {}
    for rec in recs:
        c = rec["coords"]
        at.setdefault((c.get("data", 0), c.get("model", 0)), []).append(
            [s["digest"] for s in rec["steps"]])
    return [all(len({d[i] for d in digests}) == 1 for digests in at.values())
            for i in range(len(recs[0]["steps"]))]


def pod_wire_bytes(mode, n_params, n_leaves, n_metrics, step, budget=2):
    """The wire bytes per rank that one step of ``mode`` must count on each
    group of the 2 x 1 pod mesh, by ``core/asymmetry.py``'s formulas:
    gradients fp32 (several microbatches), ``n_metrics`` fp32 values
    averaged over the world, one (grad-norm) over the pods in local mode."""
    from repro_torch.core.asymmetry import all_gather_wire_bytes, allreduce_wire_bytes

    P, grads = 2, 4 * n_params
    world = {"world": allreduce_wire_bytes(4 * n_metrics, P)}
    if mode == "flat":
        # one all-reduce per leaf: the sum of the formula over the leaves is
        # the formula of their sum (it is linear)
        return {"world": world["world"] + allreduce_wire_bytes(grads, P)}
    if mode == "sync":
        return {"pod": allreduce_wire_bytes(grads, P), **world}
    if mode == "sync+int8":
        return {"pod": all_gather_wire_bytes(P * n_params, P)
                + all_gather_wire_bytes(P * 4 * n_leaves, P), **world}
    reconcile = allreduce_wire_bytes(grads, P) if step % budget == 0 else 0.0
    return {"pod": allreduce_wire_bytes(4, P) + reconcile, **world}


def check_pod_training(ranks, first_loss, per_step, smi):
    """Phase 7's checks and lines over the ranks' :func:`pod_rank` records:
    (1) flat and sync agree step by step within ``POD_LOSS_RTOL``, their
    first loss with ``first_loss`` (one rank's step 1 of the same cut;
    None: not held) within
    ``POD_FIRST_RTOL``, and the ``POD_FAULT`` run's loss lies outside both; (2)
    int8 within ``POD_INT8_ATOL`` of sync after the last step; (3) in local
    mode the pods' parameters differ after odd steps and are equal after
    even ones, the budget's (the other modes: equal after every step); (4) each step's
    wire bytes on each group equal :func:`pod_wire_bytes`; (5) each step's
    launches on each rank equal ``per_step``, all ``wgmma``, and no plain
    version is called (``per_step`` None, on the CPU: no launch, and the plain
    versions run).  Returns each mode's losses."""
    by_mode = {rec["mode"]: [r[i] for r in ranks] for i, rec in enumerate(ranks[0])}
    fault = by_mode.pop(POD_FAULT[0])[0]["history"][0]["loss"]
    losses = {}
    for mode, recs in by_mode.items():
        hist = recs[0]["history"]
        losses[mode] = [h["loss"] for h in hist]
        for rank, rec in enumerate(recs):
            if [h["loss"] for h in rec["history"]] != losses[mode]:
                raise AssertionError(f"{mode}: rank {rank}'s losses differ from rank 0's")
        n_metrics = len(set(hist[0]) - {"grad_norm", "step", "seconds_per_step",
                                        "wire_bytes", "exchange_seconds"})
        for i, h in enumerate(hist):
            want = pod_wire_bytes(mode, recs[0]["n_params"], recs[0]["n_leaves"], n_metrics,
                                  i + 1)
            for rank, rec in enumerate(recs):
                got = rec["history"][i]["wire_bytes"]
                if got != want:
                    raise AssertionError(f"{mode} step {i + 1} rank {rank}: wire bytes {got}, "
                                         f"asymmetry's formulas {want}")
        equal = pods_equal(recs)
        want_equal = ([i % 2 == 1 for i in range(len(equal))] if mode == "local"
                      else [True] * len(equal))
        if equal != want_equal:
            raise AssertionError(f"{mode}: the pods' parameters equal after each step "
                                 f"{equal}, expected {want_equal}")
        for rank, rec in enumerate(recs):
            check_step_launches(f"{mode} rank {rank}", [st["launches"] for st in rec["steps"]],
                                rec["plain"], per_step)
        step_s = [h["seconds_per_step"] - s["digest_s"]
                  for h, s in zip(hist, recs[0]["steps"])]
        exch = [sum(h["exchange_seconds"].values()) for h in hist]
        print(f"[pods] {mode}: losses {losses[mode]}, grad-norms "
              f"{[round(h['grad_norm'], 6) for h in hist]}; s per step "
              f"{[round(t, 4) for t in step_s]} (the digest's "
              f"{[round(s['digest_s'], 4) for s in recs[0]['steps']]} s taken out), "
              f"exchange s per step {[round(t, 4) for t in exch]} "
              f"({[{g: round(t, 4) for g, t in h['exchange_seconds'].items()} for h in hist]}); "
              f"wire bytes per step {[h['wire_bytes'] for h in hist]} = asymmetry's formulas; "
              f"pods' parameters equal after each step {equal}; backends {recs[0]['backends']}; "
              f"launches per step and rank "
              f"{ {k: c for k, c in recs[0]['steps'][0]['launches'].items() if c} }; calls of the "
              f"plain versions {recs[0]['plain']}; {smi}")
        for rank, rec in enumerate(recs):
            if "peak_gb" in rec:
                print(f"[pods] {mode} rank {rank} on {rec['device']}: peak memory "
                      f"{rec['peak_gb']:.2f} GB, mem_get_info free {rec['free_total_gb'][0]:.2f} "
                      f"of {rec['free_total_gb'][1]:.2f} GB")
    flat, sync = losses["flat"], losses["sync"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(flat, sync))
    first = abs(flat[0] - first_loss) / abs(first_loss) if first_loss is not None else 0.0
    print(f"[pods] flat against sync: largest relative loss gap {rel:.3e} (limit "
          f"{POD_LOSS_RTOL}); step 1 against one rank's step 1 ({first_loss}): {first:.3e} "
          f"(limit {POD_FIRST_RTOL})")
    if rel > POD_LOSS_RTOL or first > POD_FIRST_RTOL:
        raise AssertionError(f"flat {flat} and sync {sync} (one rank's step 1: {first_loss}) "
                             f"differ beyond {POD_LOSS_RTOL} (step 1: {POD_FIRST_RTOL})")
    fault_rel = abs(fault - sync[0]) / abs(sync[0])
    fault_first = abs(fault - first_loss) / abs(first_loss) if first_loss is not None else None
    print(f"[pods] the planted fault ({POD_FAULT[0]}), step 1: loss {fault}, {fault_rel:.3e} "
          f"from sync's, {fault_first if fault_first is None else f'{fault_first:.3e}'} from "
          f"one rank's; it must exceed {POD_LOSS_RTOL} and {POD_FIRST_RTOL}")
    if not (fault_rel > POD_LOSS_RTOL and (fault_first is None or fault_first > POD_FIRST_RTOL)):
        raise AssertionError(f"the planted fault's loss {fault} lies within the limits of "
                             f"sync's {sync[0]}: the checks cannot tell a wrong split")
    gap = abs(losses["sync+int8"][-1] - sync[-1])
    print(f"[pods] int8 against exact sync after step {len(sync)}: {gap:.3e} "
          f"(limit {POD_INT8_ATOL})")
    if not gap < POD_INT8_ATOL:
        raise AssertionError(f"int8 loss {losses['sync+int8'][-1]} is {gap} from exact "
                             f"{sync[-1]}")
    return losses


def cpu_mesh(shape, axes=("data", "model")):
    """A rank's ``Mesh`` of ``shape`` with no process group: what the rules
    and the byte formulas read of a mesh."""
    import torch

    from repro_torch.launch.mesh import Mesh

    return Mesh(axes=tuple(axes), shape=dict(zip(axes, shape)), coords=dict.fromkeys(axes, 0),
                device=torch.device("cpu"))


@contextlib.contextmanager
def contiguous_wi():
    """The planted fault of phase 8: models built in the block split swiglu's
    ``wi`` ``[gate | up]`` contiguously over ``model`` (model rank 0 holds
    all of gate), as a sharding that ignores the fused layout would."""
    from repro_torch.models import transformer
    from repro_torch.sharding.shard import Placement

    real = transformer.param_layout
    transformer.param_layout = lambda *a: {k: Placement(p.spec) for k, p in real(*a).items()}
    try:
        yield
    finally:
        transformer.param_layout = real


def shard_bytes(cfg, shape, moment_bytes=8, keys=None):
    """(parameter bytes, AdamW moment bytes: ``moment_bytes`` a parameter
    element, 8 for fp32 moments) of one rank's blocks on a ``(data, model)``
    mesh of ``shape``, from the rules alone; with ``keys``, of the leaves
    whose key holds that string."""
    import torch

    from repro_torch.models import model_specs
    from repro_torch.sharding.shard import named_leaves, param_layout

    mesh = cpu_mesh(shape)
    specs = {k: s for k, s in named_leaves(model_specs(cfg)) if keys is None or keys in k}
    layout = param_layout(model_specs(cfg), cfg.act, mesh)
    numel = {k: math.prod(n // math.prod(mesh.size(a) for a in layout[k].axes(d))
                          for d, n in enumerate(s.shape)) for k, s in specs.items()}
    params = sum(n * torch.empty((), dtype=specs[k].dtype).element_size()
                 for k, n in numel.items())
    return params, moment_bytes * sum(numel.values())


def tp_wire_bytes(cfg, shape, rows, seq, micro, n_metrics):
    """The wire bytes per rank that one train step on a ``(data, model)``
    mesh of ``shape`` must count on each group, by ``core/asymmetry.py``'s
    formulas, for ``rows`` global rows of ``seq`` positions in ``micro``
    microbatches a rank.  ``data``: per microbatch each parameter's block
    gathered whole over ``data`` on use (a stacked super-block's twice under
    remat: the forward and the recompute; the rest once) and its gradient
    reduce-scattered in fp32 once; a leaf whole on ``data`` averaged in one
    fp32 bucket; the ``n_metrics`` metrics averaged over the data ranks
    (``world`` without a model axis).  ``model``: per microbatch Megatron's
    *g* after the vocab-parallel embedding and after each attention and FFN
    output in the forward, and in remat's recompute all but a super-block's
    last (nothing that the backward keeps depends on it, so the recompute
    stops before it); *f*'s in the backward, two a layer and one ahead of the
    logits; the cross-entropy's max, sum of exponents and label logit over
    the vocab shards, recomputed per chunk of ``chunked_xent``.  ``world``:
    the global norm's sum."""
    import torch

    from repro_torch.core.asymmetry import (all_gather_wire_bytes, allreduce_wire_bytes,
                                            reduce_scatter_wire_bytes)
    from repro_torch.models import layer_plan, model_specs
    from repro_torch.sharding.shard import named_leaves, param_layout

    mesh = cpu_mesh(shape)
    D, M = shape
    layout = param_layout(model_specs(cfg), cfg.act, mesh)
    plan = layer_plan(cfg)
    remat = cfg.remat != "none"
    out = {}

    def add(group, b):
        if b:
            out[group] = out.get(group, 0.0) + b

    whole = 0
    for key, spec in named_leaves(model_specs(cfg)):
        pl = layout[key]
        n = math.prod(spec.shape) // math.prod(mesh.size("model") for d in range(len(spec.shape))
                                               if "model" in pl.axes(d))
        size = torch.empty((), dtype=spec.dtype).element_size()
        if key == "embed.table" and cfg.frontend == "audio" and not cfg.tie_embeddings:
            continue  # never read: never gathered
        if pl.dim_of("data") is None:
            whole += n
            continue
        uses = 2 if remat and key.startswith("blocks.") else 1
        add("data", micro * (uses * all_gather_wire_bytes(n * size, D)
                             + reduce_scatter_wire_bytes(4 * n, D)))
    if D > 1:
        add("data", allreduce_wire_bytes(4 * whole, D))
        add("data" if M > 1 else "world", allreduce_wire_bytes(4 * n_metrics, D))
    add("world", allreduce_wire_bytes(4, D * M))
    if M > 1:
        b = rows // D // micro
        esize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        text = seq - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        vocab = "model" in layout["embed.table" if cfg.tie_embeddings else "unembed.w"].axes(
            0 if cfg.tie_embeddings else 1)
        n_attn = plan.pattern.count("attn")
        layers = plan.n_scan * n_attn + plan.lead.count("attn") + plan.tail.count("attn")
        recompute = plan.n_scan * (2 * n_attn - 1) if remat else 0
        act = allreduce_wire_bytes(b * seq * cfg.d_model * esize, M)
        per = (4 * layers + recompute) * act
        if vocab:
            per += allreduce_wire_bytes(b * text * cfg.d_model * esize, M)  # f ahead of logits
            if cfg.frontend != "audio":
                per += allreduce_wire_bytes(b * text * cfg.d_model * esize, M)  # embedding
            chunked = text >= 2048 and text % 1024 == 0
            per += (2 if chunked else 1) * 3 * allreduce_wire_bytes(4 * b * text, M)
        add("model", micro * per)
    return out


def tp_serve_wire_bytes(cfg, model_size, batch, positions):
    """The ``model`` group's wire bytes per rank of one prefill over
    ``positions`` (1: one decode step) on a mesh of one data rank: *g* after
    the vocab-parallel embedding and after each attention and FFN output, and
    the last position's logits gathered over the vocab shards."""
    import torch

    from repro_torch.core.asymmetry import all_gather_wire_bytes, allreduce_wire_bytes
    from repro_torch.models import layer_plan

    plan = layer_plan(cfg)
    layers = (plan.n_scan * plan.pattern.count("attn") + plan.lead.count("attn")
              + plan.tail.count("attn"))
    esize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    act = allreduce_wire_bytes(batch * positions * cfg.d_model * esize, model_size)
    return {"model": (2 * layers + 1) * act
            + all_gather_wire_bytes(batch * cfg.vocab_size * esize, model_size)}


def recorded_model(rec, drops=None):
    """A ``Model`` that records into ``rec``: itself (``model``), its
    parameter bytes, the prefill's rows and last-token logits, the first
    decode step's last-token logits, and the launches and
    wire bytes of the prefill and of each decode step; with ``drops`` (a
    :func:`counted_drops` log) the choices the prefill's MoE calls dropped."""
    from repro_torch.models import Model

    rec.update(decode_bytes=[], decode_launches=[])

    class Recorded(Model):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["model"] = self
            rec["param_bytes"] = sum(p.numel() * p.element_size() for p in self.parameters())

        def _call(self, fn, *args):
            before, counts = dict(self.mesh.traffic.wire_bytes), launch_counts()
            out = fn(*args)
            wire = {g: b - before.get(g, 0.0) for g, b in self.mesh.traffic.wire_bytes.items()}
            return out, wire, {k: c - counts[k] for k, c in launch_counts().items()}

        def prefill(self, batch_, max_len):
            n = len(drops or ())
            (logits, caches), rec["prefill_bytes"], rec["prefill_launches"] = self._call(
                super().prefill, batch_, max_len)
            rec["logits"] = logits[:, -1].float().cpu().numpy()
            rec["prefill_rows"] = int(logits.shape[0])
            if drops is not None:
                rec["prefill_drops"] = [int(d) for d in drops[n:]]
            return logits, caches

        def decode_step(self, caches, tokens):
            out, wire, launches = self._call(super().decode_step, caches, tokens)
            if not rec["decode_bytes"]:
                rec["decode_logits"] = out[0][:, -1].float().cpu().numpy()
            rec["decode_bytes"].append(wire)
            rec["decode_launches"].append(launches)
            return out

    return Recorded


@contextlib.contextmanager
def counted_steps(train_mod, steps, seen):
    """``build_train_step`` wrapped in train's namespace for the block: each
    step's launches, counted from zero, appended to ``steps``; ``seen``
    takes the mesh, the config, the run and step 1's batch."""
    real = train_mod.build_train_step

    def counted_step(model, run_, mesh=None):
        step = real(model, run_, mesh)
        seen.update(mesh=mesh, cfg=model.cfg, run=run_)

        def call(state, batch):
            seen.setdefault("batch", batch)
            before = launch_counts()
            new_state, metrics = step(state, batch)
            steps.append({k: c - before[k] for k, c in launch_counts().items()})
            return new_state, metrics
        return call

    train_mod.build_train_step = counted_step
    try:
        yield
    finally:
        train_mod.build_train_step = real


def check_rank_steps(ranks, want, blocks, per_step):
    """The checks that phases 8(b), 9(b) and 10 share, over the ranks'
    records: every rank's losses equal; each step's wire bytes on each group
    equal ``want``; each rank's (parameter, moment) bytes equal ``blocks``;
    each step's launches of ``per_step``'s keys equal it, flash's all
    ``wgmma``, with no plain call (``per_step`` None, on the CPU: no
    launch).  Returns rank 0's losses."""
    losses = [h["loss"] for h in ranks[0]["history"]]
    for rank, r in enumerate(ranks):
        if [h["loss"] for h in r["history"]] != losses:
            raise AssertionError(f"rank {rank}'s losses differ from rank 0's")
        for i, h in enumerate(r["history"]):
            if h["wire_bytes"] != want:
                raise AssertionError(f"step {i + 1} rank {rank}: wire bytes {h['wire_bytes']}, "
                                     f"asymmetry's formulas {want}")
        if (r["param_bytes"], r["moment_bytes"]) != blocks:
            raise AssertionError(f"rank {rank} holds {r['param_bytes']} B of parameters and "
                                 f"{r['moment_bytes']} B of moments; its blocks by the rules "
                                 f"are {blocks[0]} and {blocks[1]} B")
        check_step_launches(f"rank {rank}", r["steps"], r["plain"], per_step)
    return losses


def tp_serve_rank(arch, batch, prompt_len, gen_len, smoke=False, device=None, over=None,
                  mesh_spec=TP_SERVE_MESH, fault="contiguous_wi"):
    """One rank of phase 8(a) (and of 10), spawned: ``serve(arch)`` (its
    config's fields ``over`` set by :func:`at_depth`) on ``mesh_spec`` with the
    launches counted from zero around it, ``Model.prefill`` and
    ``decode_step`` wrapped to record the prefill's last-token logits, the
    launches of each call and the wire bytes it put on each group; then one
    prefill of the same prompts by a model built and run under the planted
    fault (``fault``, the name of a context manager here: phase 8's
    :func:`contiguous_wi`; None: no fault).  Returns the tokens, logits, the
    fault's logits, times, launches, bytes, the parameter bytes held, the
    plain versions' calls and the peak memory."""
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Model, input_specs, rank_inputs

    rec, over = {}, over or {}
    cfg = get_config(arch, smoke=smoke).with_overrides(**over)
    Recorded = recorded_model(rec)
    serve_mod.Model = Recorded
    try:
        with counted_plain_calls() as plain, at_depth(serve_mod, None, **over):
            if device is None:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            res = serve_mod.serve(arch, smoke=smoke, batch=batch, prompt_len=prompt_len,
                                  gen_len=gen_len, mesh_shape=mesh_spec[0],
                                  mesh_axes=mesh_spec[1], device=device)
            launches = launch_counts()
    finally:
        serve_mod.Model = Model
    mesh = rec.pop("model").mesh
    out = {"tokens": res["tokens"].numpy(), "prefill_s": res["prefill_seconds"],
           "decode_ms": res["decode_seconds_per_token"] * 1e3, "launches": launches,
           "plain": dict(plain), "backends": dict(mesh.backends), "device": str(mesh.device),
           "coords": dict(mesh.coords), **rec}
    if device is None:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del res
    gc.collect()
    if fault is None:
        return out
    pshape = ShapeConfig("serve", prompt_len, batch, "prefill")
    with globals()[fault]():
        wrong = Model(cfg, device=mesh.device,
                      generator=torch.Generator(mesh.device).manual_seed(0), mesh=mesh)
        prompts = rank_inputs(input_specs(cfg, pshape,
                                          generator=torch.Generator(mesh.device).manual_seed(1),
                                          device=mesh.device), cfg, pshape, wrong.mesh)
        logits, _ = wrong.prefill(prompts, prompt_len + gen_len)
    out["fault_logits"] = logits[:, -1].float().cpu().numpy()
    return out


def check_tp_serving(ranks, cfg, batch, prompt_len, ref_logits, ref_tokens, smi):
    """Phase 8(a)'s checks and lines over the ranks' :func:`tp_serve_rank`
    records, against the one-rank ``ref_logits`` (numpy ``[batch, V]``) and
    ``ref_tokens``: each rank's prefill logits within ``TP_LOGITS_RTOL`` in
    relative L2 and the fault's outside it; every row's first token equal to
    the one rank's; the ``model`` group's bytes of the prefill and of each
    decode step equal :func:`tp_serve_wire_bytes`; on the card (``smi`` not
    None) 16 flash launches a prefill, all ``wgmma``, none in decode, and no
    call of a plain version (on the CPU: no launch).  Returns the largest
    relative L2."""
    import numpy as np

    M = TP_SERVE_MESH[0][1]
    rel = lambda a: float(np.linalg.norm(a - ref_logits) / np.linalg.norm(ref_logits))
    worst, fault = 0.0, []
    for rank, r in enumerate(ranks):
        gap, fgap = rel(r["logits"]), rel(r["fault_logits"])
        worst, fault = max(worst, gap), fault + [fgap]
        if not gap <= TP_LOGITS_RTOL:
            raise AssertionError(f"rank {rank}: prefill logits {gap:.3e} from one rank's "
                                 f"(limit {TP_LOGITS_RTOL})")
        if not fgap > TP_LOGITS_RTOL:
            raise AssertionError(f"rank {rank}: the planted fault's logits lie {fgap:.3e} from "
                                 f"one rank's, within {TP_LOGITS_RTOL}: the check cannot tell")
        if not np.array_equal(r["tokens"][:, 0], ref_tokens[:, 0]):
            raise AssertionError(f"rank {rank}: first tokens {r['tokens'][:, 0]} differ from "
                                 f"one rank's {ref_tokens[:, 0]}")
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"rank {rank}'s tokens differ from rank 0's")
        want = tp_serve_wire_bytes(cfg, M, batch, prompt_len)
        if r["prefill_bytes"] != want:
            raise AssertionError(f"rank {rank}: prefill wire bytes {r['prefill_bytes']}, "
                                 f"asymmetry's formulas {want}")
        want_d = tp_serve_wire_bytes(cfg, M, batch, 1)
        if any(w != want_d for w in r["decode_bytes"]):
            raise AssertionError(f"rank {rank}: decode wire bytes {r['decode_bytes'][:2]}..., "
                                 f"asymmetry's formulas {want_d}")
        flash = {k: v for k, v in r["prefill_launches"].items() if v}
        decode = {k: v for d in r["decode_launches"] for k, v in d.items() if v}
        if smi is not None:
            n = forward_flash_calls(cfg)
            if (flash != {"flash_attention": n, "flash_attention:wgmma": n} or decode
                    or r["plain"]):
                raise AssertionError(f"rank {rank}: prefill launches {flash}, decode {decode}, "
                                     f"plain versions {r['plain']}; expected {n} flash, all "
                                     "wgmma, and no plain call")
        elif flash or decode:
            raise AssertionError(f"rank {rank}: launches on the CPU")
    same = int((ranks[0]["tokens"] == ref_tokens).sum())
    print(f"[tp] serving {cfg.name} on {dict(zip(*reversed(TP_SERVE_MESH)))}: prefill logits "
          f"against one rank's, relative L2 {[round(rel(r['logits']), 6) for r in ranks]} "
          f"(limit {TP_LOGITS_RTOL}); the planted fault (wi split contiguously) "
          f"{[round(f, 4) for f in fault]}; first tokens equal; {same} of {ref_tokens.size} "
          f"tokens equal one rank's; prefill s {[round(r['prefill_s'], 4) for r in ranks]}, "
          f"decode ms/token {[round(r['decode_ms'], 3) for r in ranks]}; model-group wire "
          f"bytes per prefill {ranks[0]['prefill_bytes']} and per token "
          f"{ranks[0]['decode_bytes'][0]} = asymmetry's formulas; flash launches per rank "
          f"and prefill {[r['prefill_launches'].get('flash_attention', 0) for r in ranks]} "
          f"(wgmma {[r['prefill_launches'].get('flash_attention:wgmma', 0) for r in ranks]}); "
          f"calls of the plain versions {ranks[0]['plain']}; backends {ranks[0]['backends']}; "
          f"{smi}")
    one = shard_bytes(cfg, (1, 1))[0]
    for rank, r in enumerate(ranks):
        print(f"[tp] serving rank {rank} on {r['device']}: parameters {r['param_bytes']} B "
              f"against one rank's {one} B ({r['param_bytes'] / one:.4f})"
              + (f", peak memory {r['peak_gb']:.2f} GB" if "peak_gb" in r else ""))
    return worst


def trained_rank(res, steps, plain, mesh, device):
    """What a spawned rank of phase 8(b) or 9(b) returns of its ``train()``
    run ``res``: the history, the steps' launches, the plain versions'
    calls, the groups' backends, its coordinates, the parameter and moment
    bytes it holds, and on the card its peak memory and ``mem_get_info``."""
    import torch

    state = res["final_state"]
    out = {"history": res["history"], "steps": steps, "plain": dict(plain),
           "backends": dict(mesh.backends), "device": str(mesh.device),
           "coords": dict(mesh.coords),
           "param_bytes": sum(p.numel() * p.element_size() for p in state["params"].values()),
           "moment_bytes": sum(t.numel() * t.element_size() for g in ("mu", "nu")
                               for t in state["opt"][g].values())}
    if device is None:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["mem_get_info"] = [x / 1e9 for x in torch.cuda.mem_get_info()]
    return out


def tp_train_rank(arch, rows, seq, micro, n_steps, lr, smoke=False, device=None, over=None,
                  mesh_spec=TP_TRAIN_MESH, fault="contiguous_wi", warmup=0):
    """One rank of phase 8(b) (and of 10), spawned: ``train(arch)`` (its
    config's fields ``over`` set by :func:`at_depth`) on ``mesh_spec`` with
    ``build_train_step`` wrapped (in train's namespace) to count each step's
    launches from zero; then, unless ``fault`` is None, one step of a model
    built and run under the planted fault (the name of a context manager
    here: phase 8's :func:`contiguous_wi`) on step 1's batch.  Returns the
    history, the steps' launches, the plain versions' calls, the groups'
    backends, the parameter and moment bytes held, the fault's loss and
    grad-norm, and the peak memory."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models import Model

    steps, seen = [], {}
    with (tempfile.TemporaryDirectory() as tmp, counted_plain_calls() as plain,
          counted_steps(train_mod, steps, seen), at_depth(train_mod, None, **(over or {}))):
        if device is None:
            torch.cuda.reset_peak_memory_stats()
        run = RunConfig(learning_rate=lr, warmup_steps=warmup, total_steps=n_steps,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        res = train_mod.train(arch, smoke=smoke, steps=n_steps,
                              shape=ShapeConfig("train_4k", seq, rows, "train"),
                              mesh_shape=mesh_spec[0], mesh_axes=mesh_spec[1],
                              run=run, log_every=1, device=device)
    mesh = seen["mesh"]
    out = trained_rank(res, steps, plain, mesh, device)
    del res
    gc.collect()
    if device is None:
        torch.cuda.empty_cache()
    if fault is None:
        return out
    with globals()[fault]():
        wrong = Model(seen["cfg"], device=mesh.device,
                      generator=torch.Generator(mesh.device).manual_seed(seen["run"].seed),
                      mesh=mesh)
        _, m = build_train_step(wrong, seen["run"], mesh)(
            init_train_state(wrong, seen["run"], mesh), seen["batch"])
    out["fault"] = (float(m["loss"]), float(m["grad_norm"]))
    return out


def check_tp_training(ranks, cfg, ref, per_step, smi):
    """Phase 8(b)'s checks and lines over the ranks' :func:`tp_train_rank`
    records: every rank's losses equal; step 1's loss and grad-norm within
    ``TP_LOSS_RTOL`` and ``TP_NORM_RTOL`` of ``ref`` (a one-rank run's step
    1, (loss, grad-norm)) and the planted fault's outside both; each step's
    wire bytes on each group equal :func:`tp_wire_bytes`; each rank's
    parameter and moment bytes equal its blocks' by the rules
    (:func:`shard_bytes`); each step's launches equal ``per_step``, all
    ``wgmma``, with no plain call (:func:`check_rank_steps`).  Returns step
    1's gaps."""
    arch, rows, seq, micro, n_steps, lr = TP_TRAIN
    shape = TP_TRAIN_MESH[0]
    hist = ranks[0]["history"]
    losses = [h["loss"] for h in hist]
    n_metrics = len(set(hist[0]) - {"grad_norm", "step", "seconds_per_step", "wire_bytes",
                                    "exchange_seconds"})
    check_rank_steps(ranks, tp_wire_bytes(cfg, shape, rows, seq, micro, n_metrics),
                     shard_bytes(cfg, shape), per_step)
    gaps = (abs(losses[0] - ref[0]) / abs(ref[0]), abs(hist[0]["grad_norm"] - ref[1]) / ref[1])
    fault = ranks[0]["fault"]
    fgaps = (abs(fault[0] - ref[0]) / abs(ref[0]), abs(fault[1] - ref[1]) / ref[1])
    print(f"[tp] training {arch} on {dict(zip(*reversed(TP_TRAIN_MESH)))}: losses {losses}, "
          f"grad-norms {[h['grad_norm'] for h in hist]}; step 1 against one rank's "
          f"(loss {ref[0]}, grad-norm {ref[1]}): relative {gaps[0]:.3e} and {gaps[1]:.3e} "
          f"(limits {TP_LOSS_RTOL}, {TP_NORM_RTOL}); the planted fault (wi split "
          f"contiguously), step 1: loss {fault[0]}, grad-norm {fault[1]}, relative "
          f"{fgaps[0]:.3e} and {fgaps[1]:.3e}; s per step "
          f"{[round(h['seconds_per_step'], 4) for h in hist]}, exchange s per step "
          f"{[{g: round(t, 4) for g, t in h['exchange_seconds'].items()} for h in hist]}; "
          f"wire bytes per step {hist[0]['wire_bytes']} = asymmetry's formulas; backends "
          f"{ranks[0]['backends']}; launches per step and rank "
          f"{ {k: c for k, c in ranks[0]['steps'][0].items() if c} }; calls of the plain "
          f"versions {ranks[0]['plain']}; {smi}")
    one = shard_bytes(cfg, (1, 1))
    for rank, r in enumerate(ranks):
        print(f"[tp] training rank {rank} {r['coords']} on {r['device']}: parameters "
              f"{r['param_bytes']} B and moments {r['moment_bytes']} B = its blocks by the "
              f"rules, {(r['param_bytes'] + r['moment_bytes']) / sum(one):.4f} of one rank's "
              f"{sum(one) / 1e9:.3f} GB"
              + (f"; peak memory {r['peak_gb']:.2f} GB" if "peak_gb" in r else ""))
    if gaps[0] > TP_LOSS_RTOL or gaps[1] > TP_NORM_RTOL:
        raise AssertionError(f"step 1 on {shape}: loss {losses[0]}, grad-norm "
                             f"{hist[0]['grad_norm']} against one rank's {ref}: {gaps}")
    if not (fgaps[0] > TP_LOSS_RTOL and fgaps[1] > TP_NORM_RTOL):
        raise AssertionError(f"the planted fault's step 1 {fault} lies within the limits of "
                             f"one rank's {ref}: the checks cannot tell")
    return gaps


def pod_tp_wire_bytes(mode, cfg, shape, rows, seq, micro, n_metrics, step, n_rank,
                      n_leaves, budget=2):
    """The wire bytes per rank that one train step of ``mode`` must count on
    each group of a ``(pod, data, model)`` mesh of ``shape``, by
    ``core/asymmetry.py``'s formulas, for ``rows`` global rows of ``seq``
    positions in ``micro`` microbatches a rank, a rank holding ``n_rank``
    elements in ``n_leaves`` leaves: inside the pod what a pod's rows cost
    on a ``(data, model)`` mesh (:func:`tp_wire_bytes`: FSDP's gathers and
    reduce-scatters, TP's *g* and *f*; the global norm's sum on the pod's
    own ranks), the ``n_metrics`` metrics averaged over the rows' ranks,
    and over ``pod`` the rank's blocks alone: in ``flat`` and ``sync`` one
    fp32 all-reduce of them (``micro`` above 1: the gradients are fp32
    sums), under int8 the blocks' int8 and the leaves' scales all-gathered
    (each scale first a max over the pod's own ranks), in ``local`` the
    grad-norm averaged and every ``budget`` steps the parameter blocks in
    fp32."""
    from repro_torch.core.asymmetry import all_gather_wire_bytes, allreduce_wire_bytes

    P, D, M = shape
    mesh = cpu_mesh(shape, ("pod", "data", "model"))
    own, rows_axes = mesh.group_name(("data", "model")), mesh.group_name(("pod", "data"))
    pod = mesh.group_name(("pod",))
    out = {}

    def add(group, b):
        if b:
            out[group] = out.get(group, 0.0) + b

    for group, b in tp_wire_bytes(cfg, (D, M), rows // P, seq, micro, 0).items():
        add(own if group == "world" else group, b)
    add(rows_axes, allreduce_wire_bytes(4 * n_metrics, P * D))
    if mode in ("flat", "sync"):
        add(pod, allreduce_wire_bytes(4 * n_rank, P))
    elif mode == "sync+int8":
        add(own, allreduce_wire_bytes(4 * n_leaves, D * M))
        add(pod, all_gather_wire_bytes(P * n_rank, P) + all_gather_wire_bytes(P * 4 * n_leaves, P))
    else:
        add(pod, allreduce_wire_bytes(4, P)
            + (allreduce_wire_bytes(4 * n_rank, P) if step % budget == 0 else 0.0))
    return out


def pod_tp_rank(serving, training, smoke=False, device=None):
    """One rank of phase 11, spawned: :func:`tp_serve_rank` of ``serving``
    (arch, rows, prompt, generated tokens) on ``POD_TP_MESH`` with no fault,
    then :func:`pod_rank` of ``training`` (arch, rows, tokens per row,
    microbatches, steps, peak lr) on it, each mode of ``POD_MODES`` and then
    ``POD_TP_FAULT``."""
    serve = tp_serve_rank(*serving, smoke, device, None, POD_TP_MESH, None)
    return {"serve": serve,
            "train": pod_rank(*training, smoke, device, POD_TP_MESH, POD_TP_FAULT)}


def pod_tp_memory(cfg) -> str:
    """Phase 11's reckoning of a rank's state on ``POD_TP_MESH``, before the
    run: the rank's blocks of the parameters (bf16) and of the fp32 AdamW
    moments by the rules, the fp32 gradient sums (``micro`` above 1), int8's
    ``ef`` (one fp32 block), and init's draw of the whole tree on the rank
    before it keeps its blocks; activations come on top."""
    P, D, M = POD_TP_MESH[0]
    params, moments = shard_bytes(cfg, (D, M))
    whole = shard_bytes(cfg, (1, 1))[0]
    blocks = moments // 8
    return (f"parameter blocks {params / 1e9:.3f} GB, moments {moments / 1e9:.3f} GB, fp32 "
            f"gradient sums {4 * blocks / 1e9:.3f} GB, int8's ef {4 * blocks / 1e9:.3f} GB, "
            f"init's whole draw {whole / 1e9:.3f} GB: state "
            f"{(params + moments + 4 * blocks) / 1e9:.3f} GB, "
            f"{(params + moments + 8 * blocks) / 1e9:.3f} GB under int8, plus one microbatch's "
            f"activations (1 x {POD_TP_TRAIN[2]} at {cfg.num_heads // M} heads)")


def check_pod_tp_serving(ranks, cfg, batch, prompt_len, ref_logits, ref_tokens, smi):
    """Phase 11(a)'s checks and lines over the ranks' :func:`tp_serve_rank`
    records on ``POD_TP_MESH``, against phase 4's one-rank ``ref_logits``
    (numpy ``[batch, V]``) and ``ref_tokens``: each rank's prefill held
    ``batch / (P·D)`` rows, its pod and data rank's share, pod-major (not
    the whole batch: the rows split over ``(pod, data)``); its last-token
    logits within ``TP_LOGITS_RTOL`` in relative L2 of the one rank's for
    those rows; every rank's tokens equal, their first ones the one rank's;
    the ``model`` group's bytes of the prefill and of each decode step equal
    :func:`tp_serve_wire_bytes` at the rank's rows; on the card (``smi`` not
    None) one flash launch an attention layer a prefill on ``wgmma``, none
    in decode, and no call of a plain version (on the CPU: no launch).
    Returns the largest relative L2."""
    import numpy as np

    P, D, M = POD_TP_MESH[0]
    share = batch // (P * D)
    worst, gaps = 0.0, []
    for rank, r in enumerate(ranks):
        i = r["coords"]["pod"] * D + r["coords"]["data"]
        want = ref_logits[i * share:(i + 1) * share]
        gap = float(np.linalg.norm(r["logits"] - want) / np.linalg.norm(want))
        worst, gaps = max(worst, gap), gaps + [gap]
        if r["prefill_rows"] != share:
            raise AssertionError(f"rank {rank} {r['coords']}: its prefill held "
                                 f"{r['prefill_rows']} rows, its (pod, data) share is {share} "
                                 f"of {batch}")
        if not gap <= TP_LOGITS_RTOL:
            raise AssertionError(f"rank {rank}: prefill logits {gap:.3e} from one rank's "
                                 f"(limit {TP_LOGITS_RTOL})")
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"rank {rank}'s tokens differ from rank 0's")
        if not np.array_equal(r["tokens"][:, 0], ref_tokens[:, 0]):
            raise AssertionError(f"rank {rank}: first tokens {r['tokens'][:, 0]} differ from "
                                 f"one rank's {ref_tokens[:, 0]}")
        for what, got, want_b in (
                ("prefill", [r["prefill_bytes"]], tp_serve_wire_bytes(cfg, M, share, prompt_len)),
                ("decode", r["decode_bytes"], tp_serve_wire_bytes(cfg, M, share, 1))):
            if any(g != want_b for g in got):
                raise AssertionError(f"rank {rank}: {what} wire bytes {got[:2]}, asymmetry's "
                                     f"formulas {want_b}")
        flash = {k: v for k, v in r["prefill_launches"].items() if v}
        decode = {k: v for d in r["decode_launches"] for k, v in d.items() if v}
        if smi is not None:
            n = forward_flash_calls(cfg)
            if (flash != {"flash_attention": n, "flash_attention:wgmma": n} or decode
                    or r["plain"]):
                raise AssertionError(f"rank {rank}: prefill launches {flash}, decode {decode}, "
                                     f"plain versions {r['plain']}; expected {n} flash, all "
                                     "wgmma, and no plain call")
        elif flash or decode:
            raise AssertionError(f"rank {rank}: launches on the CPU")
    same = int((ranks[0]["tokens"] == ref_tokens).sum())
    print(f"[podtp] serving {cfg.name} on {dict(zip(*reversed(POD_TP_MESH)))}: each rank's "
          f"prefill held {[r['prefill_rows'] for r in ranks]} of {batch} rows; prefill logits "
          f"against one rank's, relative L2 {[round(g, 6) for g in gaps]} (limit "
          f"{TP_LOGITS_RTOL}); first tokens equal; {same} of {ref_tokens.size} tokens equal one "
          f"rank's; prefill s {[round(r['prefill_s'], 4) for r in ranks]}, decode ms/token "
          f"{[round(r['decode_ms'], 3) for r in ranks]}; model-group wire bytes per prefill "
          f"{ranks[0]['prefill_bytes']} and per token {ranks[0]['decode_bytes'][0]} = "
          f"asymmetry's formulas; flash launches per rank and prefill "
          f"{[r['prefill_launches'].get('flash_attention', 0) for r in ranks]} (wgmma "
          f"{[r['prefill_launches'].get('flash_attention:wgmma', 0) for r in ranks]}); calls of "
          f"the plain versions {ranks[0]['plain']}; backends {ranks[0]['backends']}; {smi}")
    one = shard_bytes(cfg, (1, 1))[0]
    for rank, r in enumerate(ranks):
        print(f"[podtp] serving rank {rank} {r['coords']} on {r['device']}: parameters "
              f"{r['param_bytes']} B against one rank's {one} B ({r['param_bytes'] / one:.4f})"
              + (f", peak memory {r['peak_gb']:.2f} GB" if "peak_gb" in r else ""))
    return worst


def check_pod_tp_training(ranks, cfg, ref, per_step, smi):
    """Phase 11(b)'s checks and lines over the ranks' :func:`pod_rank`
    records on ``POD_TP_MESH`` (``POD_TP_TRAIN``): in each mode every rank's
    losses equal; each step's wire bytes on each group equal
    :func:`pod_tp_wire_bytes`; each rank's parameter and moment bytes its
    blocks' by the rules (:func:`shard_bytes`); the pods' blocks at each
    ``(data, model)`` coordinate bit-identical after every step of flat,
    sync and int8, and in local parted after odd steps and equal after even
    ones; each step's launches ``per_step``, all ``wgmma``, with no plain
    call (``per_step`` None, on the CPU: no launch); step 1's loss and
    grad-norm of sync and flat within ``TP_LOSS_RTOL`` and ``TP_NORM_RTOL``
    of ``ref`` (a one-rank step 1 of the same weights and rows; None: not
    held), flat within ``POD_LOSS_RTOL`` of sync at every step, int8 within
    ``POD_INT8_ATOL`` after the last; and ``POD_TP_FAULT``'s run must part
    the pods' blocks after step 1 and lie outside ``POD_LOSS_RTOL`` of
    sync's step 2.  Returns each mode's losses."""
    arch, rows, seq, micro, n_steps, lr = POD_TP_TRAIN
    P, D, M = POD_TP_MESH[0]
    blocks = shard_bytes(cfg, (D, M))
    by_mode = {rec["mode"]: [r[i] for r in ranks] for i, rec in enumerate(ranks[0])}

    fault = by_mode.pop(POD_TP_FAULT[0])
    losses, equal = {}, {}
    for mode, recs in by_mode.items():
        hist = recs[0]["history"]
        losses[mode] = [h["loss"] for h in hist]
        n_metrics = len(set(hist[0]) - {"grad_norm", "step", "seconds_per_step",
                                        "wire_bytes", "exchange_seconds"})
        for rank, rec in enumerate(recs):
            if [h["loss"] for h in rec["history"]] != losses[mode]:
                raise AssertionError(f"{mode}: rank {rank}'s losses differ from rank 0's")
            if (rec["param_bytes"], rec["moment_bytes"]) != blocks:
                raise AssertionError(f"{mode} rank {rank} holds {rec['param_bytes']} B of "
                                     f"parameters and {rec['moment_bytes']} B of moments; its "
                                     f"blocks by the rules are {blocks}")
            for i, h in enumerate(rec["history"]):
                want = pod_tp_wire_bytes(mode, cfg, POD_TP_MESH[0], rows, seq, micro, n_metrics,
                                         i + 1, rec["n_params"], rec["n_leaves"])
                if h["wire_bytes"] != want:
                    raise AssertionError(f"{mode} step {i + 1} rank {rank}: wire bytes "
                                         f"{h['wire_bytes']}, asymmetry's formulas {want}")
            check_step_launches(f"{mode} rank {rank}", [st["launches"] for st in rec["steps"]],
                                rec["plain"], per_step)
        equal[mode] = pods_equal(recs)
        want_equal = ([i % 2 == 1 for i in range(n_steps)] if mode == "local"
                      else [True] * n_steps)
        if equal[mode] != want_equal:
            raise AssertionError(f"{mode}: the pods' blocks equal after each step "
                                 f"{equal[mode]}, expected {want_equal}")
        step_s = [h["seconds_per_step"] - s["digest_s"] for h, s in zip(hist, recs[0]["steps"])]
        print(f"[podtp] {mode}: losses {losses[mode]}, grad-norms "
              f"{[round(h['grad_norm'], 6) for h in hist]}; s per step "
              f"{[round(t, 4) for t in step_s]}, exchange s per step "
              f"{[{g: round(t, 4) for g, t in h['exchange_seconds'].items()} for h in hist]}; "
              f"wire bytes per step {[h['wire_bytes'] for h in hist]} = asymmetry's formulas; "
              f"pods' blocks equal after each step {equal[mode]}; launches per step and rank "
              f"{ {k: c for k, c in recs[0]['steps'][0]['launches'].items() if c} }; calls of "
              f"the plain versions {recs[0]['plain']}; {smi}")
        for rank, rec in enumerate(recs):
            if "peak_gb" in rec:
                print(f"[podtp] {mode} rank {rank} {rec['coords']} on {rec['device']}: peak "
                      f"memory {rec['peak_gb']:.2f} GB, mem_get_info free "
                      f"{rec['free_total_gb'][0]:.2f} of {rec['free_total_gb'][1]:.2f} GB")
    from repro_torch.models import model_specs
    from repro_torch.sharding.shard import named_leaves

    rec0 = by_mode["sync"][0]
    one = shard_bytes(cfg, (1, 1))
    pod_b = rec0["history"][0]["wire_bytes"][cpu_mesh(*POD_TP_MESH).group_name(("pod",))]
    n_whole = sum(math.prod(spec.shape) for _, spec in named_leaves(model_specs(cfg)))
    whole_b = pod_wire_bytes("sync", n_whole, 0, 0, 1)["pod"]
    print(f"[podtp] each rank's parameters {rec0['param_bytes']} B and moments "
          f"{rec0['moment_bytes']} B = its blocks by the rules, "
          f"{(rec0['param_bytes'] + rec0['moment_bytes']) / sum(one):.4f} of one rank's "
          f"{sum(one) / 1e9:.3f} GB; sync's pod bytes a rank and step {pod_b} against a whole "
          f"replica's {whole_b} (phase 7's formula): {pod_b / whole_b:.4f}")
    flat, sync = losses["flat"], losses["sync"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(flat, sync))
    gaps = {m: (abs(losses[m][0] - ref[0]) / abs(ref[0]),
                abs(by_mode[m][0]["history"][0]["grad_norm"] - ref[1]) / ref[1])
            for m in ("sync", "flat")} if ref is not None else {}
    int8 = abs(losses["sync+int8"][-1] - sync[-1])
    f_hist = fault[0]["history"]
    f_equal = pods_equal(fault)
    f_rel = abs(f_hist[-1]["loss"] - sync[len(f_hist) - 1]) / abs(sync[len(f_hist) - 1])
    print(f"[podtp] step 1 against phase 8's one rank (loss, grad-norm {ref}): "
          f"{ {m: (f'{a:.3e}', f'{b:.3e}') for m, (a, b) in gaps.items()} } (limits "
          f"{TP_LOSS_RTOL}, {TP_NORM_RTOL}); flat against sync: largest relative loss gap "
          f"{rel:.3e} (limit {POD_LOSS_RTOL}); int8 against exact sync after step {len(sync)}: "
          f"{int8:.3e} (limit {POD_INT8_ATOL})")
    print(f"[podtp] the planted fault ({POD_TP_FAULT[0]}): losses "
          f"{[h['loss'] for h in f_hist]}, pods' blocks equal after each step {f_equal}; step "
          f"{len(f_hist)} {f_rel:.3e} from sync's; it must part the pods and exceed "
          f"{POD_LOSS_RTOL}")
    for m, (a, b) in gaps.items():
        if a > TP_LOSS_RTOL or b > TP_NORM_RTOL:
            raise AssertionError(f"{m} step 1: loss and grad-norm {a:.3e}, {b:.3e} from one "
                                 f"rank's {ref}")
    if rel > POD_LOSS_RTOL:
        raise AssertionError(f"flat {flat} and sync {sync} differ beyond {POD_LOSS_RTOL}")
    if not int8 < POD_INT8_ATOL:
        raise AssertionError(f"int8 loss {losses['sync+int8'][-1]} is {int8} from exact "
                             f"{sync[-1]}")
    if all(f_equal) or not f_rel > POD_LOSS_RTOL:
        raise AssertionError(f"the planted fault (pods equal {f_equal}, step {len(f_hist)} "
                             f"{f_rel:.3e} from sync's) lies within the checks: they cannot "
                             "tell a pod group across model ranks")
    return losses


def ep_config(smoke=False):
    """Phase 9's config: deepseek-v2-236b (published widths, or smoke width)
    cut to ``EP_LAYERS`` layers, on the reference's production MoE settings
    (``src/repro/launch/dryrun.py``: ``ep_a2a``, 16 groups)."""
    from repro_torch.configs import get_config

    cfg = get_config(EP_SERVE[0], smoke=smoke)
    return cfg.with_overrides(num_layers=EP_LAYERS, moe=dataclasses.replace(
        cfg.moe, expert_sharding="ep_a2a", groups=16))


@contextlib.contextmanager
def island_groups(model_size, pods=1):
    """Phase 9's (and 12's) one-rank reference: each MoE call whose T
    divides by ``model_size`` routes model rank i's slice of every row of
    pod p (the rows split into ``pods`` equal blocks) as a group, as the
    island does on each pod's ranks (its capacity is per slice); other calls
    (decode) as they are."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import mlp

    real = moe_mod.moe_ffn

    def sliced(p, x, cfg, mesh=None, rows=None):
        B, T, D = x.shape
        if mesh is not None or T % model_size:
            return real(p, x, cfg, mesh, rows)
        P, M, Tl = pods, model_size, T // model_size
        groups = x.reshape(P, B // P, M, Tl, D).transpose(1, 2).reshape(P * M, B // P * Tl, D)
        yg, aux = moe_mod._scatter_moe(p, groups, cfg.moe)
        y = yg.reshape(P, M, B // P, Tl, D).transpose(1, 2).reshape(B, T, D)
        return (y + mlp(p["shared"], x, "swiglu") if cfg.moe.num_shared else y), aux

    moe_mod.moe_ffn = sliced
    try:
        yield
    finally:
        moe_mod.moe_ffn = real


@contextlib.contextmanager
def wrong_source_order():
    """Phase 9's planted fault: the island's results come back with their
    chunks in reverse source order (every second exchange of the island's
    forward is the return)."""
    import torch

    from repro_torch.models import moe as moe_mod

    real, calls = moe_mod.all_to_all, [0]

    def exchange(t, axes, mesh):
        calls[0] += 1
        out = real(t, axes, mesh)
        return torch.flip(out, [0]) if calls[0] % 2 == 0 else out

    moe_mod.all_to_all = exchange
    try:
        yield
    finally:
        moe_mod.all_to_all = real


@contextlib.contextmanager
def island_probe(log):
    """The first call of ``models/moe.py``'s island in the block also runs,
    on the same inputs, the one-rank route of the MoE (each model rank's
    slice a group of its own, every expert's weights gathered over
    ``model``) and appends the relative L2 gap of the island's output from
    it to ``log`` (the 1-D layout at data 1).  The probe's gathers count in
    a traffic record of their own."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.sharding.shard import _gather

    real = moe_mod._island

    def probed(p, x, xf, m, mesh):
        y, aux = real(p, x, xf, m, mesh)
        if log:
            return y, aux
        traffic, mesh.traffic = mesh.traffic, type(mesh.traffic)()
        try:
            with torch.no_grad():
                whole = {"router": p["router"].detach(),
                         **{w: _gather(p[w].detach(), 0, "model", mesh) for w in ("wi", "wo")}}
                M, (B, T, D) = mesh.size("model"), x.shape
                ref, _ = moe_mod._scatter_moe(
                    whole, x.detach().unflatten(1, (M, T // M)).transpose(0, 1).reshape(
                        M, B * T // M, D), m)
                del whole
                ref = ref.reshape(M, B, T // M, D).transpose(0, 1).reshape(B, T, D).float()
                log.append(float((y.detach().float() - ref).norm() / ref.norm()))
        finally:
            mesh.traffic = traffic
        return y, aux

    moe_mod._island = probed
    try:
        yield
    finally:
        moe_mod._island = real


@contextlib.contextmanager
def counted_drops(log):
    """``models/moe.py``'s ``_slots`` wrapped: each call appends the choices
    it drops (position at the capacity or past it), a 0-d tensor, to
    ``log``."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod._slots

    def slots(flat_e, pos, C, E, local=None):
        log.append((pos >= C).sum())
        return real(flat_e, pos, C, E, local)

    moe_mod._slots = slots
    try:
        yield
    finally:
        moe_mod._slots = real


def ep_serve_wire_bytes(cfg, model_size, batch, positions):
    """The ``model`` group's wire bytes per rank of one prefill over
    ``positions`` (1: one decode step) on a mesh of one data rank: *g* after
    the vocab-parallel embedding and after each attention and FFN output
    (a MoE layer's: the shared experts'), and where the island runs (T a
    multiple of the model axis) per MoE layer its two all-to-alls of the
    ``[E·C, D]`` send buffer and the gather of the token slices; then the
    last position's logits gathered over the vocab shards."""
    import torch

    from repro_torch.core.asymmetry import (all_gather_wire_bytes, all_to_all_wire_bytes,
                                            allreduce_wire_bytes)
    from repro_torch.models import layer_plan
    from repro_torch.models.moe import _capacity

    M, m, plan = model_size, cfg.moe, layer_plan(cfg)
    esize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    tokens = batch * positions * cfg.d_model * esize
    out = ((2 * cfg.num_layers + 1) * allreduce_wire_bytes(tokens, M)
           + all_gather_wire_bytes(batch * cfg.vocab_size * esize, M))
    if positions % M == 0:
        C = _capacity(batch * positions // M, m)
        n_moe = cfg.num_layers - len(plan.lead)
        out += n_moe * (2 * all_to_all_wire_bytes(m.num_experts * C * cfg.d_model * esize, M)
                        + all_gather_wire_bytes(tokens, M))
    return {"model": out}


def ep_wire_bytes(cfg, model_size, rows, seq):
    """The wire bytes per rank that one train step of one microbatch on a
    mesh of (data 1, model ``model_size``) must count, by
    ``core/asymmetry.py``'s formulas.  ``model``: in the forward *g* after
    the vocab-parallel embedding and after each attention and FFN output,
    and per MoE layer (the island) its two all-to-alls of the ``[E·C, D]``
    send buffer and the gather of the token slices; in remat's recompute of
    each super-block the same but its last *g* (the shared experts', which
    nothing that the backward keeps depends on); in the backward *f* ahead
    of the logits, MLA's three *f*'s (on the query latent, the KV latent and
    the rope key), a dense FFN's *f*, and per MoE layer the FFN input's *f*,
    the gates' *f* and the two all-to-alls again; the cross-entropy's max,
    sum of exponents and label logit over the vocab shards, per chunk of
    ``chunked_xent`` and again in its backward.  ``world``: the global
    norm's sum."""
    import torch

    from repro_torch.core.asymmetry import (all_gather_wire_bytes, all_to_all_wire_bytes,
                                            allreduce_wire_bytes)
    from repro_torch.models import layer_plan
    from repro_torch.models.moe import _capacity

    M, m, mla, plan = model_size, cfg.moe, cfg.mla, layer_plan(cfg)
    esize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    pos = rows * seq
    act = allreduce_wire_bytes(pos * cfg.d_model * esize, M)
    a2a = 2 * all_to_all_wire_bytes(
        m.num_experts * _capacity(pos // M, m) * cfg.d_model * esize, M)
    island = a2a + all_gather_wire_bytes(pos * cfg.d_model * esize, M)
    n_moe = cfg.num_layers - len(plan.lead)
    forward = act + 2 * cfg.num_layers * act + n_moe * island
    recompute = plan.n_scan * (len(plan.pattern) * (2 * act + island) - act)
    latents = allreduce_wire_bytes(
        pos * (mla.q_lora_rank + mla.kv_lora_rank + mla.rope_head_dim) * esize, M)
    backward = (act + cfg.num_layers * latents + len(plan.lead) * act
                + n_moe * (act + allreduce_wire_bytes(4 * pos * m.top_k, M) + a2a))
    chunked = seq >= 2048 and seq % 1024 == 0
    xent = (2 if chunked else 1) * 3 * allreduce_wire_bytes(4 * pos, M)
    return {"model": forward + recompute + backward + xent,
            "world": allreduce_wire_bytes(4, M)}


def ep_serve_reference(serving, pods=1, smoke=False, device="cuda", decode=False, cfg=None):
    """The one-rank reference of phase 9's (``pods`` 1) or phase 12's
    (``pods`` 2) serving under :func:`island_groups`: the last-token logits
    (numpy ``[batch, V]``) of the prefill of ``serving``'s request (rows,
    prompt, generated tokens; ``serve()``'s weights and prompts); with
    ``decode``, also the logits of the first decode step and ``serve()``'s
    greedy tokens ``[batch, generated]``.  With ``cfg`` (phase 15's), that
    config routed as one device routes it, in the reference's groups of the
    whole batch."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import Model, input_specs

    routed = island_groups(EP_MESH[0][1], pods) if cfg is None else contextlib.nullcontext()
    cfg, dev = cfg or ep_config(smoke), torch.device(device)
    batch, prompt_len, gen_len = serving
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    prompts = input_specs(cfg, ShapeConfig("serve", prompt_len, batch, "prefill"),
                          generator=torch.Generator(dev).manual_seed(1), device=dev)
    out = {}
    with routed:
        logits, caches = model.prefill(prompts, prompt_len + gen_len)
        out["logits"] = logits[:, -1].float().cpu().numpy()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        tokens = [tok]
        for i in range(gen_len - 1 if decode else 0):
            logits, caches = model.decode_step(caches, tok)
            if i == 0:
                out["decode_logits"] = logits[:, -1].float().cpu().numpy()
            tok = logits[:, -1].argmax(-1, keepdim=True)
            tokens.append(tok)
    if decode:
        out["tokens"] = torch.cat(tokens, dim=1).cpu().numpy()
    del model, prompts, caches, logits
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ep_references(serving, training, smoke=False, device="cuda"):
    """Phase 9's one-rank references under :func:`island_groups`: the
    last-token logits (numpy ``[batch, V]``) of the prefill of ``serving``'s
    request (:func:`ep_serve_reference`), and step 1's (loss, grad-norm) of
    ``train()`` on ``training`` (rows, tokens per row, microbatches, steps,
    peak lr; bf16 moments)."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import train as train_mod

    cfg, M, dev = ep_config(smoke), EP_MESH[0][1], torch.device(device)
    logits = ep_serve_reference(serving, 1, smoke, device)["logits"]
    rows, seq, micro, n_steps, lr = training
    real = train_mod.get_config
    train_mod.get_config = lambda a, smoke=False: cfg
    try:
        with tempfile.TemporaryDirectory() as tmp, island_groups(M):
            run = RunConfig(learning_rate=lr, warmup_steps=0, total_steps=n_steps,
                            microbatches=micro, optimizer_state_dtype="bfloat16",
                            checkpoint_every=10 ** 9, checkpoint_dir=tmp)
            hist = train_mod.train(cfg.name, smoke=smoke, steps=1,
                                   shape=ShapeConfig("train_4k", seq, rows, "train"), run=run,
                                   log_every=1, device=device)["history"]
    finally:
        train_mod.get_config = real
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return logits, (hist[0]["loss"], hist[0]["grad_norm"])


def ep_serve_rank(batch, prompt_len, gen_len, smoke=False, device=None):
    """One rank of phase 9(a), spawned: ``serve()`` of :func:`ep_config` on
    ``EP_MESH`` (``get_config`` patched in serve's namespace) with the
    launches counted from zero around it, ``Model.prefill`` and
    ``decode_step`` wrapped to record the prefill's last-token logits, the
    launches and wire bytes of each call and the choices each MoE call
    dropped; then two prefills of the same prompts on the same model under
    :func:`island_probe`, the second also under :func:`wrong_source_order`."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import input_specs, rank_inputs

    cfg, rec, drops = ep_config(smoke), {}, []
    Recorded = recorded_model(rec, drops)

    real = serve_mod.Model, serve_mod.get_config
    serve_mod.Model, serve_mod.get_config = Recorded, lambda a, smoke=False: cfg
    try:
        with counted_plain_calls() as plain, counted_drops(drops):
            if device is None:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            res = serve_mod.serve(cfg.name, smoke=smoke, batch=batch, prompt_len=prompt_len,
                                  gen_len=gen_len, mesh_shape=EP_MESH[0],
                                  mesh_axes=EP_MESH[1], device=device)
            launches = launch_counts()
    finally:
        serve_mod.Model, serve_mod.get_config = real
    model = rec.pop("model")
    mesh = model.mesh
    out = {"tokens": res["tokens"].numpy(), "prefill_s": res["prefill_seconds"],
           "decode_ms": res["decode_seconds_per_token"] * 1e3, "launches": launches,
           "plain": dict(plain), "backends": dict(mesh.backends), "device": str(mesh.device),
           "exchange_s": dict(mesh.traffic.seconds),
           "decode_drops": sum(int(d) for d in drops) - sum(rec["prefill_drops"]), **rec}
    if device is None:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["mem_get_info"] = [x / 1e9 for x in torch.cuda.mem_get_info()]
    del res
    pshape = ShapeConfig("serve", prompt_len, batch, "prefill")
    prompts = rank_inputs(input_specs(cfg, pshape,
                                      generator=torch.Generator(mesh.device).manual_seed(1),
                                      device=mesh.device), cfg, pshape, mesh)
    sound, fault = [], []
    with island_probe(sound):
        model.prefill(prompts, prompt_len + gen_len)
    with wrong_source_order(), island_probe(fault):
        logits, _ = model.prefill(prompts, prompt_len + gen_len)
    out["fault_logits"] = logits[:, -1].float().cpu().numpy()
    out["island_gap"], out["fault_island_gap"] = sound[0], fault[0]
    return out


def ep_train_rank(rows, seq, micro, n_steps, lr, smoke=False, device=None):
    """One rank of phase 9(b), spawned: ``train()`` of :func:`ep_config` on
    ``EP_MESH`` with bf16 AdamW moments, ``build_train_step`` wrapped (in
    train's namespace) to count each step's launches from zero; then one
    step of a fresh model on step 1's batch under
    :func:`wrong_source_order`.  Returns the history, the steps' launches,
    the plain versions' calls, the groups' backends, the parameter and
    moment bytes held, the fault's loss and grad-norm, and the peak
    memory."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models import Model

    cfg, steps, seen = ep_config(smoke), [], {}
    real_cfg = train_mod.get_config
    train_mod.get_config = lambda a, smoke=False: cfg
    try:
        with (tempfile.TemporaryDirectory() as tmp, counted_plain_calls() as plain,
              counted_steps(train_mod, steps, seen)):
            if device is None:
                torch.cuda.reset_peak_memory_stats()
            run = RunConfig(learning_rate=lr, warmup_steps=0, total_steps=n_steps,
                            microbatches=micro, optimizer_state_dtype="bfloat16",
                            checkpoint_every=10 ** 9, checkpoint_dir=tmp)
            res = train_mod.train(cfg.name, smoke=smoke, steps=n_steps,
                                  shape=ShapeConfig("train_4k", seq, rows, "train"),
                                  mesh_shape=EP_MESH[0], mesh_axes=EP_MESH[1], run=run,
                                  log_every=1, device=device)
    finally:
        train_mod.get_config = real_cfg
    mesh = seen["mesh"]
    out = trained_rank(res, steps, plain, mesh, device)
    del res
    gc.collect()
    if device is None:
        torch.cuda.empty_cache()
    fault = Model(cfg, device=mesh.device,
                  generator=torch.Generator(mesh.device).manual_seed(seen["run"].seed),
                  mesh=mesh)
    sound, wrong = [], []
    with torch.no_grad(), island_probe(sound):
        fault.loss(seen["batch"])            # step 1's forward, probed
    with wrong_source_order(), island_probe(wrong):
        _, m = build_train_step(fault, seen["run"], mesh)(
            init_train_state(fault, seen["run"], mesh), seen["batch"])
    out["fault"] = (float(m["loss"]), float(m["grad_norm"]))
    out["island_gap"], out["fault_island_gap"] = sound[0], wrong[0]
    return out


def ep_rank(serving, training, smoke=False, device=None):
    """One rank of phase 9, spawned: :func:`ep_serve_rank` of ``serving``
    (rows, prompt, generated tokens), then, in the same process,
    :func:`ep_train_rank` of ``training`` (rows, tokens per row,
    microbatches, steps, peak lr)."""
    import torch

    serve = ep_serve_rank(*serving, smoke, device)
    gc.collect()
    if device is None:
        torch.cuda.empty_cache()
    return {"serve": serve, "train": ep_train_rank(*training, smoke, device)}


def check_ep_serving(ranks, cfg, batch, prompt_len, ref_logits, smi):
    """Phase 9(a)'s checks and lines over the ranks' :func:`ep_serve_rank`
    records, against the one-rank ``ref_logits`` (numpy ``[batch, V]``,
    routed by :func:`island_groups`): each rank's prefill logits within
    ``EP_LOGITS_RTOL`` in relative L2 (the fault's printed); the island's
    output within ``EP_ISLAND_RTOL`` of the one-rank route of its inputs
    (:func:`island_probe`) and the fault's outside it; every row's first
    token the one rank's argmax; the ``model`` group's bytes of
    the prefill and of each decode step equal :func:`ep_serve_wire_bytes`;
    on the card (``smi`` not None) one flash launch a prefill per MLA layer,
    all ``wgmma``, none in decode, and no call of a plain version (on the
    CPU: no launch).  Returns the largest relative L2."""
    import numpy as np

    M = EP_MESH[0][1]
    rel = lambda a: float(np.linalg.norm(a - ref_logits) / np.linalg.norm(ref_logits))
    first = ref_logits.argmax(-1)
    worst, fault = 0.0, []
    for rank, r in enumerate(ranks):
        gap, fgap = rel(r["logits"]), rel(r["fault_logits"])
        worst, fault = max(worst, gap), fault + [fgap]
        if not gap <= EP_LOGITS_RTOL:
            raise AssertionError(f"rank {rank}: prefill logits {gap:.3e} from one rank's "
                                 f"(limit {EP_LOGITS_RTOL})")
        if not r["island_gap"] <= EP_ISLAND_RTOL:
            raise AssertionError(f"rank {rank}: the island's output lies {r['island_gap']:.3e} "
                                 f"from the one-rank route (limit {EP_ISLAND_RTOL})")
        if not r["fault_island_gap"] > EP_ISLAND_RTOL:
            raise AssertionError(f"rank {rank}: the planted fault's island output lies "
                                 f"{r['fault_island_gap']:.3e} from the one-rank route, within "
                                 f"{EP_ISLAND_RTOL}: the check cannot tell")
        if not np.array_equal(r["tokens"][:, 0], first):
            raise AssertionError(f"rank {rank}: first tokens {r['tokens'][:, 0]} differ from "
                                 f"one rank's {first}")
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"rank {rank}'s tokens differ from rank 0's")
        want = ep_serve_wire_bytes(cfg, M, batch, prompt_len)
        if r["prefill_bytes"] != want:
            raise AssertionError(f"rank {rank}: prefill wire bytes {r['prefill_bytes']}, "
                                 f"asymmetry's formulas {want}")
        want_d = ep_serve_wire_bytes(cfg, M, batch, 1)
        if any(w != want_d for w in r["decode_bytes"]):
            raise AssertionError(f"rank {rank}: decode wire bytes {r['decode_bytes'][:2]}..., "
                                 f"asymmetry's formulas {want_d}")
        flash = {k: v for k, v in r["prefill_launches"].items() if v}
        decode = {k: v for d in r["decode_launches"] for k, v in d.items() if v}
        if smi is not None:
            n = forward_flash_calls(cfg)
            if (flash != {"flash_attention": n, "flash_attention:wgmma": n} or decode
                    or r["plain"]):
                raise AssertionError(f"rank {rank}: prefill launches {flash}, decode {decode}, "
                                     f"plain versions {r['plain']}; expected {n} flash, all "
                                     "wgmma, and no plain call")
        elif flash or decode:
            raise AssertionError(f"rank {rank}: launches on the CPU")
    same = int((ranks[0]["tokens"][:, 0] == first).sum())
    print(f"[ep] serving {cfg.name} ({cfg.num_layers} layers, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k} on {cfg.moe.expert_sharding}, {cfg.moe.groups} groups) on "
          f"{dict(zip(*reversed(EP_MESH)))}: prefill logits against one rank's (each model "
          f"rank's slice routed as a group), relative L2 "
          f"{[round(rel(r['logits']), 6) for r in ranks]} (limit {EP_LOGITS_RTOL}); the island's "
          f"output against the one-rank route of its inputs "
          f"{[r['island_gap'] for r in ranks]} (limit {EP_ISLAND_RTOL}); "
          f"the planted fault (results in reverse source order): logits "
          f"{[round(f, 6) for f in fault]}, island "
          f"{[round(r['fault_island_gap'], 4) for r in ranks]}; first tokens "
          f"equal ({same} of {len(first)}); prefill s {[round(r['prefill_s'], 4) for r in ranks]}"
          f", decode ms/token {[round(r['decode_ms'], 3) for r in ranks]}; exchange s by group "
          f"{[{g: round(t, 4) for g, t in r['exchange_s'].items()} for r in ranks]}; model-group "
          f"wire bytes per prefill {ranks[0]['prefill_bytes']} and per token "
          f"{ranks[0]['decode_bytes'][0]} = asymmetry's formulas; dropped choices of the MoE "
          f"layer in the prefill by rank {[r['prefill_drops'] for r in ranks]}, in "
          f"{len(ranks[0]['decode_bytes'])} decode steps {[r['decode_drops'] for r in ranks]}; "
          f"flash launches per rank and prefill "
          f"{[r['prefill_launches'].get('flash_attention', 0) for r in ranks]} (wgmma "
          f"{[r['prefill_launches'].get('flash_attention:wgmma', 0) for r in ranks]}); calls of "
          f"the plain versions {ranks[0]['plain']}; backends {ranks[0]['backends']}; {smi}")
    for rank, r in enumerate(ranks):
        print(f"[ep] serving rank {rank} on {r['device']}: parameters {r['param_bytes']} B"
              + (f", peak memory {r['peak_gb']:.2f} GB, mem_get_info free "
                 f"{r['mem_get_info'][0]:.2f} of {r['mem_get_info'][1]:.2f} GB"
                 if "peak_gb" in r else ""))
    return worst


def check_ep_training(ranks, cfg, ref, per_step, smi):
    """Phase 9(b)'s checks and lines over the ranks' :func:`ep_train_rank`
    records: every rank's losses equal; step 1's loss and grad-norm within
    ``EP_LOSS_RTOL`` and ``EP_NORM_RTOL`` of ``ref`` (a one-rank run's step
    1 under :func:`island_groups`, (loss, grad-norm)), the island's output
    in step 1's forward within ``EP_ISLAND_RTOL`` of the one-rank route of
    its inputs (:func:`island_probe`), and the planted fault's loss and
    island output outside their limits (its grad-norm printed); each
    step's wire bytes on each group equal :func:`ep_wire_bytes`; each
    rank's parameter and bf16 moment bytes equal its blocks' by the rules
    (:func:`shard_bytes`); each step's launches equal ``per_step``, all
    ``wgmma``, with no plain call (:func:`check_rank_steps`).  Returns step
    1's gaps."""
    arch, rows, seq, micro, n_steps, lr = EP_TRAIN
    M = EP_MESH[0][1]
    hist = ranks[0]["history"]
    losses = [h["loss"] for h in hist]
    experts = shard_bytes(cfg, EP_MESH[0], moment_bytes=4, keys="blocks.b0.ffn.w")
    check_rank_steps(ranks, ep_wire_bytes(cfg, M, rows // micro, seq),
                     shard_bytes(cfg, EP_MESH[0], moment_bytes=4), per_step)
    gaps = (abs(losses[0] - ref[0]) / abs(ref[0]), abs(hist[0]["grad_norm"] - ref[1]) / ref[1])
    fault = ranks[0]["fault"]
    fgaps = (abs(fault[0] - ref[0]) / abs(ref[0]), abs(fault[1] - ref[1]) / ref[1])
    print(f"[ep] training {arch} ({cfg.num_layers} layers) on "
          f"{dict(zip(*reversed(EP_MESH)))}: losses {losses}, grad-norms "
          f"{[h['grad_norm'] for h in hist]}; step 1 against one rank's (loss {ref[0]}, "
          f"grad-norm {ref[1]}): relative {gaps[0]:.3e} and {gaps[1]:.3e} (limits "
          f"{EP_LOSS_RTOL}, {EP_NORM_RTOL}); the planted fault (results in reverse source "
          f"order), step 1: loss {fault[0]}, grad-norm {fault[1]}, relative {fgaps[0]:.3e} and "
          f"{fgaps[1]:.3e}; s per step {[round(h['seconds_per_step'], 4) for h in hist]}, "
          f"exchange s per step "
          f"{[{g: round(t, 4) for g, t in h['exchange_seconds'].items()} for h in hist]}; wire "
          f"bytes per step {hist[0]['wire_bytes']} = asymmetry's formulas; backends "
          f"{ranks[0]['backends']}; launches per step and rank "
          f"{ {k: c for k, c in ranks[0]['steps'][0].items() if c} }; calls of the plain "
          f"versions {ranks[0]['plain']}; {smi}")
    one = shard_bytes(cfg, (1, 1), moment_bytes=4)
    one_experts = shard_bytes(cfg, (1, 1), moment_bytes=4, keys="blocks.b0.ffn.w")
    for rank, r in enumerate(ranks):
        print(f"[ep] training rank {rank} {r['coords']} on {r['device']}: parameters "
              f"{r['param_bytes']} B and bf16 moments {r['moment_bytes']} B = its blocks by the "
              f"rules, {(r['param_bytes'] + r['moment_bytes']) / sum(one):.4f} of one rank's "
              f"{sum(one) / 1e9:.3f} GB (the routed experts' "
              f"{sum(experts) / sum(one_experts):.4f})"
              + (f"; peak memory {r['peak_gb']:.2f} GB, mem_get_info free "
                 f"{r['mem_get_info'][0]:.2f} of {r['mem_get_info'][1]:.2f} GB"
                 if "peak_gb" in r else ""))
    island = [r["island_gap"] for r in ranks]
    fisland = [r["fault_island_gap"] for r in ranks]
    print(f"[ep] training: the island's output in step 1's forward against the one-rank route "
          f"of its inputs {island} (limit {EP_ISLAND_RTOL}); the planted fault's {fisland}")
    if gaps[0] > EP_LOSS_RTOL or gaps[1] > EP_NORM_RTOL or max(island) > EP_ISLAND_RTOL:
        raise AssertionError(f"step 1 on {EP_MESH[0]}: loss {losses[0]}, grad-norm "
                             f"{hist[0]['grad_norm']} against one rank's {ref}: {gaps}; the "
                             f"island {island}")
    if not (fgaps[0] > EP_LOSS_RTOL and min(fisland) > EP_ISLAND_RTOL):
        raise AssertionError(f"the planted fault's step 1 {fault} and island {fisland} lie "
                             f"within the limits of one rank's {ref}: the checks cannot tell")
    return gaps


@contextlib.contextmanager
def pod_alone_rows():
    """Phase 12's planted fault, the route before ROADMAP's item 3f: every
    MoE call routes its pod's rows alone (its groups over one pod's ``data``
    ranks), where a serving step's groups span the ``(pod, data)`` ranks."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod.moe_ffn

    def alone(p, x, cfg, mesh=None, rows=None):
        return real(p, x, cfg, mesh, rows and moe_mod.Rows(rows.mesh, ("data",)))

    moe_mod.moe_ffn = alone
    try:
        yield
    finally:
        moe_mod.moe_ffn = real


@contextlib.contextmanager
def slot_offsets(log, on):
    """Phase 12's probe: ``models/moe.py``'s ``_slots`` wrapped; while
    ``on[0]``, each call appends to ``log`` the ``[E]`` counts of the
    rank's (token, choice) pairs by expert and each expert's first slot
    position among them (its offset: the slots that the group's ranks
    before this one filled; -1 for an expert the rank did not choose),
    numpy."""
    import torch

    from repro_torch.models import moe as moe_mod

    real = moe_mod._slots

    def slots(flat_e, pos, C, E, local=None):
        if on[0]:
            e, p = flat_e.reshape(-1), pos.reshape(-1)
            first = torch.full((E,), -1, dtype=p.dtype, device=p.device).scatter_reduce(
                0, e, p, "amin", include_self=False)
            log.append((torch.bincount(e, minlength=E).cpu().numpy(), first.cpu().numpy()))
        return real(flat_e, pos, C, E, local)

    moe_mod._slots = slots
    try:
        yield
    finally:
        moe_mod._slots = real


def one_at_a_time(cls):
    """``cls`` (a ``Model``) built on one rank of the process group at a
    time, the card's cache emptied after each: a sharded rank draws each
    tensor whole in fp32 before it keeps its block, so ranks that share a
    card and draw at once each hold their blocks, the largest whole fp32
    draw and its block together (:func:`init_need`; phase 12 builds its
    ranks this way only where four of those do not leave
    ``EP_POD_AT_ONCE_FREE`` free)."""
    import torch
    import torch.distributed as dist

    class OneAtATime(cls):
        def __init__(self, *a, **kw):
            for r in range(dist.get_world_size()):
                if r == dist.get_rank():
                    super().__init__(*a, **kw)
                    if torch.cuda.is_available():
                        torch.cuda.empty_cache()
                dist.barrier()

    return OneAtATime


def ep_pod_serve_wire_bytes(cfg, batch, positions):
    """Each group's wire bytes per rank of one prefill over ``positions``
    (1: one decode step) of ``batch`` global rows on ``EP_POD_MESH``: the
    ``model`` group's as :func:`ep_serve_wire_bytes` at a rank's rows; on
    the rows' group (``(pod, data)``, named ``pod`` at data 1), where the
    scatter path runs (T no multiple of the model axis) with groups that
    span R row ranks, per MoE layer the all-gather of every rank's ``[E]``
    int64 counts."""
    from repro_torch.core.asymmetry import all_gather_wire_bytes
    from repro_torch.models import layer_plan
    from repro_torch.sharding.shard import ROWS

    (P, D, M), axes = EP_POD_MESH
    R, m = P * D, cfg.moe
    out = ep_serve_wire_bytes(cfg, M, batch // R, positions)
    S = batch * positions
    G = m.groups if S % m.groups == 0 else 1
    if positions % M and G < R:
        n_moe = cfg.num_layers - len(layer_plan(cfg).lead)
        rows = cpu_mesh(EP_POD_MESH[0], axes).group_name(ROWS)
        out[rows] = n_moe * all_gather_wire_bytes(R * m.num_experts * 8, R)
    return out


def ep_pod_rank(batch, prompt_len, gen_len, smoke=False, device=None, at_once=False):
    """One rank of phase 12, spawned: ``serve()`` of :func:`ep_config` on
    ``EP_POD_MESH`` (the model built :func:`one_at_a_time` unless
    ``at_once``) with the
    launches counted from zero around it, ``Model.prefill`` and
    ``decode_step`` wrapped to record the logits, launches and wire bytes
    of each call and the choices each MoE call dropped, and decode's slot
    offsets read by :func:`slot_offsets`; then the same model's prefill of
    the same prompts and its greedy decode under :func:`pod_alone_rows`,
    the offsets read again."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Model, input_specs, rank_inputs

    cfg, rec, drops, offsets, on = ep_config(smoke), {}, [], [], [False]

    class Probed(recorded_model(rec, drops)):
        def decode_step(self, caches, tokens):
            on[0] = True
            try:
                return super().decode_step(caches, tokens)
            finally:
                on[0] = False

    real = serve_mod.Model, serve_mod.get_config
    serve_mod.Model = Probed if at_once else one_at_a_time(Probed)
    serve_mod.get_config = lambda a, smoke=False: cfg
    try:
        with counted_plain_calls() as plain, counted_drops(drops), slot_offsets(offsets, on):
            if device is None:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            res = serve_mod.serve(cfg.name, smoke=smoke, batch=batch, prompt_len=prompt_len,
                                  gen_len=gen_len, mesh_shape=EP_POD_MESH[0],
                                  mesh_axes=EP_POD_MESH[1], device=device)
            launches = launch_counts()
    finally:
        serve_mod.Model, serve_mod.get_config = real
    model = rec.pop("model")
    mesh = model.mesh
    out = {"tokens": res["tokens"].numpy(), "prefill_s": res["prefill_seconds"],
           "decode_ms": res["decode_seconds_per_token"] * 1e3, "launches": launches,
           "plain": dict(plain), "backends": dict(mesh.backends), "device": str(mesh.device),
           "coords": dict(mesh.coords), "exchange_s": dict(mesh.traffic.seconds),
           "offsets": offsets, "decode_drops": sum(int(d) for d in drops)
           - sum(rec["prefill_drops"]), **rec}
    if device is None:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["mem_get_info"] = [x / 1e9 for x in torch.cuda.mem_get_info()]
    del res
    pshape = ShapeConfig("serve", prompt_len, batch, "prefill")
    prompts = rank_inputs(input_specs(cfg, pshape,
                                      generator=torch.Generator(mesh.device).manual_seed(1),
                                      device=mesh.device), cfg, pshape, mesh)
    # The plain model's methods: the recording ones would add to the records.
    fault = []
    logits, caches = Model.prefill(model, prompts, prompt_len + gen_len)
    with pod_alone_rows(), slot_offsets(fault, [True]):
        for _ in range(gen_len - 1):
            logits, caches = Model.decode_step(model, caches,
                                               logits[:, -1].argmax(-1, keepdim=True))
    out["fault_offsets"] = fault
    return out


def check_span_offsets(ranks, key="offsets"):
    """Phase 12's probe over the ranks' ``key`` logs (:func:`slot_offsets`
    in each decode step): on every rank of a later pod each expert's offset
    is the sum of the counts of the same model coordinate's ranks in the
    pods before it (the group spans both pods' rows), and at least one such
    offset is above 0 (else the probe cannot tell a group over one pod).
    Returns the number of offsets above 0 read; raises where one differs."""
    import numpy as np

    by = {(r["coords"]["pod"], r["coords"]["model"]): r[key] for r in ranks}
    seen = 0
    for (p, m), log in by.items():
        if not log:
            raise AssertionError(f"pod {p} model rank {m}: no slot offsets read in decode")
        for j, (counts, first) in enumerate(log):
            before = sum((by[(q, m)][j][0] for q in range(p)), np.zeros_like(counts))
            chosen = first >= 0
            if not np.array_equal(first[chosen], before[chosen]):
                bad = np.flatnonzero(chosen & (first != before))
                raise AssertionError(
                    f"pod {p} model rank {m}, decode call {j}: experts {bad.tolist()} start at "
                    f"slots {first[bad].tolist()}, the counts of the pods before it are "
                    f"{before[bad].tolist()}: the group does not span the pods' rows")
            seen += int((first[chosen] > 0).sum())
    if not seen:
        raise AssertionError("no expert of a later pod had an offset above 0: the probe cannot "
                             "tell a group over one pod")
    return seen


def check_ep_pod_serving(ranks, cfg, batch, prompt_len, ref, smi):
    """Phase 12's checks and lines over the ranks' :func:`ep_pod_rank`
    records, against the one-rank ``ref`` (:func:`ep_serve_reference` with
    pods 2: logits, decode_logits, tokens): each rank's prefill held its
    ``(pod, data)`` share of the rows; its prefill's and first decode step's
    last-token logits within ``EP_LOGITS_RTOL`` in relative L2 of the one
    rank's for those rows; every rank's tokens equal, their first ones the
    one rank's (later ones are printed: in bf16 the ranks' rounding of the
    sharded sums flips near-tied greedy choices, and a row goes its own way
    after a flip, as phase 8's llama rows do); each group's
    bytes of the prefill and of each decode step equal
    :func:`ep_pod_serve_wire_bytes`; decode's slot offsets span the pods
    (:func:`check_span_offsets`) and the planted fault's do not; on the
    card (``smi`` not None) one flash launch a prefill per MLA layer on
    ``wgmma`` on every rank, none in decode, and no call of a plain version
    (on the CPU: no launch).  Returns the largest relative L2."""
    import numpy as np

    (P, D, M), R = EP_POD_MESH[0], EP_POD_MESH[0][0] * EP_POD_MESH[0][1]
    share = batch // R
    worst, gaps = 0.0, []
    for rank, r in enumerate(ranks):
        i = r["coords"]["pod"] * D + r["coords"]["data"]
        rows = slice(i * share, (i + 1) * share)
        for what, got, want in (("prefill", r["logits"], ref["logits"][rows]),
                                ("decode", r["decode_logits"], ref["decode_logits"][rows])):
            gap = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            worst, gaps = max(worst, gap), gaps + [gap]
            if not gap <= EP_LOGITS_RTOL:
                raise AssertionError(f"rank {rank} {r['coords']}: {what} logits {gap:.3e} from "
                                     f"one rank's (limit {EP_LOGITS_RTOL})")
        if r["prefill_rows"] != share:
            raise AssertionError(f"rank {rank} {r['coords']}: its prefill held "
                                 f"{r['prefill_rows']} rows, its (pod, data) share is {share} "
                                 f"of {batch}")
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"rank {rank}'s tokens differ from rank 0's")
        if not np.array_equal(r["tokens"][:, 0], ref["tokens"][:, 0]):
            raise AssertionError(f"rank {rank}: first tokens {r['tokens'][:, 0]} differ from "
                                 f"one rank's {ref['tokens'][:, 0]}")
        for what, got, want_b in (
                ("prefill", [r["prefill_bytes"]], ep_pod_serve_wire_bytes(cfg, batch, prompt_len)),
                ("decode", r["decode_bytes"], ep_pod_serve_wire_bytes(cfg, batch, 1))):
            if any(g != want_b for g in got):
                raise AssertionError(f"rank {rank}: {what} wire bytes {got[:2]}, asymmetry's "
                                     f"formulas {want_b}")
        flash = {k: v for k, v in r["prefill_launches"].items() if v}
        decode = {k: v for d in r["decode_launches"] for k, v in d.items() if v}
        if smi is not None:
            n = forward_flash_calls(cfg)
            if (flash != {"flash_attention": n, "flash_attention:wgmma": n} or decode
                    or r["plain"]):
                raise AssertionError(f"rank {rank}: prefill launches {flash}, decode {decode}, "
                                     f"plain versions {r['plain']}; expected {n} flash, all "
                                     "wgmma, and no plain call")
        elif flash or decode:
            raise AssertionError(f"rank {rank}: launches on the CPU")
    seen = check_span_offsets(ranks)
    try:
        check_span_offsets(ranks, "fault_offsets")
    except AssertionError as e:
        fault = str(e)
    else:
        raise AssertionError("the planted fault's slot offsets (each pod's rows routed alone) "
                             "pass the probe: it cannot tell")
    print(f"[eppod] serving {cfg.name} ({cfg.num_layers} layers, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k} on {cfg.moe.expert_sharding}, {cfg.moe.groups} groups) on "
          f"{dict(zip(*reversed(EP_POD_MESH)))}: each rank's prefill held "
          f"{[r['prefill_rows'] for r in ranks]} of {batch} rows; prefill and first decode "
          f"logits against one rank's (each pod's model-rank slice a group), relative L2 "
          f"{[round(g, 6) for g in gaps]} (limit {EP_LOGITS_RTOL}); first tokens equal; "
          f"{int((ranks[0]['tokens'] == ref['tokens']).sum())} of {ref['tokens'].size} tokens "
          f"equal one rank's; decode's slot offsets on pod 1 "
          f"equal pod 0's counts ({seen} offsets above 0 read), the planted fault (each pod's "
          f"rows routed alone): {fault}; prefill s {[round(r['prefill_s'], 4) for r in ranks]}"
          f", decode ms/token {[round(r['decode_ms'], 3) for r in ranks]}; exchange s by group "
          f"{[{g: round(t, 4) for g, t in r['exchange_s'].items()} for r in ranks]}; wire bytes "
          f"per prefill {ranks[0]['prefill_bytes']} and per token {ranks[0]['decode_bytes'][0]} "
          f"= asymmetry's formulas; dropped choices in the prefill by rank "
          f"{[r['prefill_drops'] for r in ranks]}, in {len(ranks[0]['decode_bytes'])} decode "
          f"steps {[r['decode_drops'] for r in ranks]}; flash launches per rank and prefill "
          f"{[r['prefill_launches'].get('flash_attention', 0) for r in ranks]} (wgmma "
          f"{[r['prefill_launches'].get('flash_attention:wgmma', 0) for r in ranks]}); calls of "
          f"the plain versions {ranks[0]['plain']}; backends {ranks[0]['backends']}; {smi}")
    one = shard_bytes(cfg, (1, 1))[0]
    for rank, r in enumerate(ranks):
        print(f"[eppod] serving rank {rank} {r['coords']} on {r['device']}: parameters "
              f"{r['param_bytes']} B against one rank's {one} B ({r['param_bytes'] / one:.4f})"
              + (f", peak memory {r['peak_gb']:.2f} GB, mem_get_info free "
                 f"{r['mem_get_info'][0]:.2f} of {r['mem_get_info'][1]:.2f} GB"
                 if "peak_gb" in r else ""))
    return worst


def uneven_ep_config(smoke=False):
    """Phase 15's config: deepseek-v2-236b (published widths, or smoke width)
    cut to ``EP_LAYERS`` layers, its experts on ``ep2d`` in 16 groups."""
    from repro_torch.configs import get_config

    cfg = get_config(EP_SERVE[0], smoke=smoke)
    return cfg.with_overrides(num_layers=EP_LAYERS, moe=dataclasses.replace(
        cfg.moe, expert_sharding="ep2d", groups=16))


@contextlib.contextmanager
def piece_offsets(log, on):
    """Phase 15's probe: ``models/moe.py``'s ``_piece_offsets`` wrapped;
    while ``on[0]``, each call appends to ``log`` the groups of the rank's
    pieces, their ``[P, E]`` counts and the ``[P, E]`` slot offsets it
    returns (numpy), which the pieces' slots start from."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod._piece_offsets

    def offsets(counts, pc):
        offset, total = real(counts, pc)
        if on[0]:
            log.append((list(pc.groups), counts.cpu().numpy(), offset.cpu().numpy()))
        return offset, total

    moe_mod._piece_offsets = offsets
    try:
        yield
    finally:
        moe_mod._piece_offsets = real


@contextlib.contextmanager
def own_counts():
    """Phase 15's planted fault: each rank's pieces take their offsets and
    their groups' counts from the rank's own counts (offsets 0, as if every
    group it touches lay whole on it), with no exchange."""
    import torch

    from repro_torch.models import moe as moe_mod

    real = moe_mod._piece_offsets
    moe_mod._piece_offsets = lambda counts, pc: (torch.zeros_like(counts), counts)
    try:
        yield
    finally:
        moe_mod._piece_offsets = real


def uneven_ep_wire_bytes(cfg, batch, positions):
    """Each group's wire bytes per rank of one prefill over ``positions`` (1:
    one decode step) of ``batch`` global rows on ``UNEVEN_EP_MESH``: on
    ``data``, each leaf that splits over it gathered once (the FSDP gather on
    use); on the rows' group (``(pod, data)``, named ``world`` at model 1),
    where the MoE groups straddle or span the row ranks, per MoE layer the
    all-gather of every rank's ``[G, E]`` int64 counts."""
    from repro_torch.core.asymmetry import all_gather_wire_bytes
    from repro_torch.launch.mesh import meta_mesh
    from repro_torch.models import Model, layer_plan
    from repro_torch.models.moe import Rows, pieces
    from repro_torch.sharding.shard import ROWS

    (D, _), axes = UNEVEN_EP_MESH
    mesh = meta_mesh(*UNEVEN_EP_MESH)
    model = Model(cfg, mesh=mesh)
    out = {"data": sum(all_gather_wire_bytes(D * p.numel() * p.element_size(), D)
                       for k, p in model.state_dict().items()
                       if model.layout[k].dim_of("data") is not None)}
    pc = pieces(batch // D * positions, cfg.moe, Rows(mesh))
    if pc.rows is not None:
        n_moe = cfg.num_layers - len(layer_plan(cfg).lead)
        out[cpu_mesh(*UNEVEN_EP_MESH).group_name(ROWS)] = n_moe * all_gather_wire_bytes(
            D * pc.n_groups * cfg.moe.num_experts * 8, D)
    return {g: b for g, b in out.items() if b}


def uneven_ep_rank(batch, prompt_len, gen_len, smoke=False, device=None, at_once=False):
    """One rank of phase 15, spawned: ``serve()`` of :func:`uneven_ep_config`
    on ``UNEVEN_EP_MESH`` (the model built :func:`one_at_a_time` unless
    ``at_once``) with the launches counted from zero around it,
    ``Model.prefill`` and ``decode_step`` wrapped to record the logits,
    launches and wire bytes of each call and the choices each MoE call
    dropped, and the slot offsets of every MoE call read by
    :func:`piece_offsets`; then the same model's prefill of the same
    prompts under :func:`own_counts`, the offsets read again."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Model, input_specs, rank_inputs

    cfg, rec, drops, offsets, on = uneven_ep_config(smoke), {}, [], [], [True]
    recorded = recorded_model(rec, drops)
    real = serve_mod.Model, serve_mod.get_config
    serve_mod.Model = recorded if at_once else one_at_a_time(recorded)
    serve_mod.get_config = lambda a, smoke=False: cfg
    try:
        with counted_plain_calls() as plain, counted_drops(drops), piece_offsets(offsets, on):
            if device is None:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            res = serve_mod.serve(cfg.name, smoke=smoke, batch=batch, prompt_len=prompt_len,
                                  gen_len=gen_len, mesh_shape=UNEVEN_EP_MESH[0],
                                  mesh_axes=UNEVEN_EP_MESH[1], device=device)
            launches = launch_counts()
    finally:
        serve_mod.Model, serve_mod.get_config = real
    model = rec.pop("model")
    mesh = model.mesh
    out = {"tokens": res["tokens"].numpy(), "prefill_s": res["prefill_seconds"],
           "decode_ms": res["decode_seconds_per_token"] * 1e3, "launches": launches,
           "plain": dict(plain), "backends": dict(mesh.backends), "device": str(mesh.device),
           "coords": dict(mesh.coords), "exchange_s": dict(mesh.traffic.seconds),
           "offsets": offsets, "experts": int(model.blocks["b0"]["ffn"]["wi"].shape[1]),
           "decode_drops": sum(int(d) for d in drops) - sum(rec["prefill_drops"]), **rec}
    if device is None:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["mem_get_info"] = [x / 1e9 for x in torch.cuda.mem_get_info()]
    del res
    pshape = ShapeConfig("serve", prompt_len, batch, "prefill")
    prompts = rank_inputs(input_specs(cfg, pshape,
                                      generator=torch.Generator(mesh.device).manual_seed(1),
                                      device=mesh.device), cfg, pshape, mesh)
    fault = []
    # The plain model's method: the recording one would add to the records.
    with own_counts(), piece_offsets(fault, [True]):
        Model.prefill(model, prompts, prompt_len + gen_len)
    out["fault_offsets"] = fault
    return out


def check_piece_offsets(ranks, key="offsets"):
    """Phase 15's probe over the ranks' ``key`` logs (:func:`piece_offsets`,
    one entry per MoE call): in every call each rank's piece of group g
    starts each expert's slots at the sum of that expert's counts in group
    g's pieces on the data ranks before it, and at least one offset is above
    0 (else the probe cannot tell a group that straddles the ranks from one
    whole on a rank).  Returns the number of offsets above 0 read; raises
    where one differs."""
    import numpy as np

    by = sorted(ranks, key=lambda r: r["coords"]["data"])
    calls = {len(r[key]) for r in by}
    if len(calls) != 1 or not calls.pop():
        raise AssertionError(f"the ranks read {[len(r[key]) for r in by]} MoE calls' offsets")
    seen = 0
    for j in range(len(by[0][key])):
        before = {}
        for r in by:
            groups, counts, offset = r[key][j]
            for g, c, o in zip(groups, counts, offset):
                want = before.get(g, np.zeros_like(c))
                if not np.array_equal(o, want):
                    bad = np.flatnonzero(o != want)
                    raise AssertionError(
                        f"data rank {r['coords']['data']}, MoE call {j}, group {g}: {bad.size} "
                        f"experts, {bad[:6].tolist()} first, start at slots "
                        f"{o[bad[:6]].tolist()}, the counts of its pieces on the ranks before "
                        f"are {want[bad[:6]].tolist()}: the group does not straddle the ranks")
                seen += int((o > 0).sum())
                before[g] = want + c
    if not seen:
        raise AssertionError("no piece had an offset above 0: the probe cannot tell a group "
                             "that straddles the ranks from one whole on a rank")
    return seen


def check_uneven_ep_serving(ranks, cfg, batch, prompt_len, ref, smi):
    """Phase 15's checks and lines over the ranks' :func:`uneven_ep_rank`
    records, against the one-rank ``ref`` (:func:`ep_serve_reference` of
    phase 15's config: logits, decode_logits, tokens): each rank's prefill
    held its data share of the rows; its prefill's and first decode step's
    last-token logits within ``EP_LOGITS_RTOL`` in relative L2 of the one
    rank's for those rows; every rank's first tokens the one rank's; every
    rank holds every expert; each group's bytes of the prefill and of each
    decode step equal :func:`uneven_ep_wire_bytes`; the slot offsets of
    every MoE call straddle the ranks (:func:`check_piece_offsets`) and the
    planted fault's do not; on the card (``smi`` not None) one flash launch
    a prefill per MLA layer on ``wgmma`` on every rank, none in decode, and
    no call of a plain version (on the CPU: no launch).  Returns the largest
    relative L2."""
    import numpy as np

    (D, _), E = UNEVEN_EP_MESH[0], cfg.moe.num_experts
    share = batch // D
    pf, dc = (uneven_ep_wire_bytes(cfg, batch, n) for n in (prompt_len, 1))
    worst, gaps = 0.0, []
    for rank, r in enumerate(ranks):
        rows = slice(r["coords"]["data"] * share, (r["coords"]["data"] + 1) * share)
        for what, got, want in (("prefill", r["logits"], ref["logits"][rows]),
                                ("decode", r["decode_logits"], ref["decode_logits"][rows])):
            gap = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            worst, gaps = max(worst, gap), gaps + [gap]
            if not gap <= EP_LOGITS_RTOL:
                raise AssertionError(f"rank {rank} {r['coords']}: {what} logits {gap:.3e} from "
                                     f"one rank's (limit {EP_LOGITS_RTOL})")
        if r["prefill_rows"] != share:
            raise AssertionError(f"rank {rank} {r['coords']}: its prefill held "
                                 f"{r['prefill_rows']} rows, its data share is {share} of "
                                 f"{batch}")
        if not np.array_equal(r["tokens"][:, 0], ref["tokens"][:, 0]):
            raise AssertionError(f"rank {rank}: first tokens {r['tokens'][:, 0]} differ from "
                                 f"one rank's {ref['tokens'][:, 0]}")
        if r["experts"] != E:
            raise AssertionError(f"rank {rank}: holds {r['experts']} of the {E} experts")
        for what, got, want_b in (("prefill", [r["prefill_bytes"]], pf),
                                  ("decode", r["decode_bytes"], dc)):
            if any(g != want_b for g in got):
                raise AssertionError(f"rank {rank}: {what} wire bytes {got[:2]}, asymmetry's "
                                     f"formulas {want_b}")
        flash = {k: v for k, v in r["prefill_launches"].items() if v}
        decode = {k: v for d in r["decode_launches"] for k, v in d.items() if v}
        if smi is not None:
            n = forward_flash_calls(cfg)
            if (flash != {"flash_attention": n, "flash_attention:wgmma": n} or decode
                    or r["plain"]):
                raise AssertionError(f"rank {rank}: prefill launches {flash}, decode {decode}, "
                                     f"plain versions {r['plain']}; expected {n} flash, all "
                                     "wgmma, and no plain call")
        elif flash or decode:
            raise AssertionError(f"rank {rank}: launches on the CPU")
    seen = check_piece_offsets(ranks)
    try:
        check_piece_offsets(ranks, "fault_offsets")
    except AssertionError as e:
        fault = str(e)
    else:
        raise AssertionError("the planted fault's slot offsets (each rank's own counts) pass "
                             "the probe: it cannot tell")
    print(f"[unevenep] serving {cfg.name} ({cfg.num_layers} layers, {E} experts top-"
          f"{cfg.moe.top_k} on {cfg.moe.expert_sharding}, {cfg.moe.groups} groups) on "
          f"{dict(zip(*reversed(UNEVEN_EP_MESH)))}: every rank holds {E} experts; each rank's "
          f"prefill held {[r['prefill_rows'] for r in ranks]} of {batch} rows; prefill and "
          f"first decode logits against one rank's (the reference's groups of the whole "
          f"batch), relative L2 {[round(g, 6) for g in gaps]} (limit {EP_LOGITS_RTOL}); first "
          f"tokens equal; slot offsets of every MoE call equal the counts of the pieces before "
          f"them ({seen} offsets above 0 read), the planted fault (each rank's own counts): "
          f"{fault}; prefill s {[round(r['prefill_s'], 4) for r in ranks]}, decode ms/token "
          f"{[round(r['decode_ms'], 3) for r in ranks]}; exchange s by group "
          f"{[{g: round(t, 4) for g, t in r['exchange_s'].items()} for r in ranks]}; wire bytes "
          f"per prefill {ranks[0]['prefill_bytes']} and per token {ranks[0]['decode_bytes'][0]} "
          f"= the formulas ({pf}, {dc}); dropped choices in the prefill by rank "
          f"{[r['prefill_drops'] for r in ranks]}, in decode {[r['decode_drops'] for r in ranks]}"
          f"; flash launches per rank and prefill "
          f"{[r['prefill_launches'].get('flash_attention', 0) for r in ranks]} (wgmma "
          f"{[r['prefill_launches'].get('flash_attention:wgmma', 0) for r in ranks]}); calls of "
          f"the plain versions {ranks[0]['plain']}; backends {ranks[0]['backends']}; {smi}")
    one = shard_bytes(cfg, (1, 1))[0]
    for rank, r in enumerate(ranks):
        print(f"[unevenep] serving rank {rank} {r['coords']} on {r['device']}: parameters "
              f"{r['param_bytes']} B against one rank's {one} B ({r['param_bytes'] / one:.4f})"
              + (f", peak memory {r['peak_gb']:.2f} GB, mem_get_info free "
                 f"{r['mem_get_info'][0]:.2f} of {r['mem_get_info'][1]:.2f} GB"
                 if "peak_gb" in r else ""))
    return worst


@contextlib.contextmanager
def rope_before_gather():
    """Phase 10's planted fault in the head-dim split: each rank rotates its
    own contiguous slice of k's columns, as if it were whole heads of
    ``hd/M``, before the gather (RoPE pairs ``x[:d/2]`` with ``x[d/2:]`` of a
    whole head, which no slice holds)."""
    import torch

    from repro_torch.models import attention
    from repro_torch.models.layers import rope
    from repro_torch.sharding.shard import all_gather_model

    real = attention._kv_whole

    def kv_whole(p, x, cfg, positions, tp):
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        k = rope((x @ p["wk"]).unflatten(-1, (K, -1)), positions, cfg.rope_theta).flatten(-2)
        kv = all_gather_model(torch.stack([k, x @ p["wv"]]), tp)
        return kv.unflatten(-1, (K, hd)).unbind(0)

    attention._kv_whole = kv_whole
    try:
        yield
    finally:
        attention._kv_whole = real


@contextlib.contextmanager
def w_if_through_g():
    """Phase 10's planted fault in the mLSTM: ``w_if``'s partial summed over
    ``model`` by *g* and the rank's heads then sliced out.  The forward is
    the sound one; *g*'s identity backward leaves each rank only its own
    heads' share of the gates' gradient, so the rest of it never reaches
    ``w_up`` (the sum over ``model`` that the reduce-scatter's backward
    makes is lost)."""
    from repro_torch.models import xlstm
    from repro_torch.sharding.shard import reduce_from_model

    real = xlstm.reduce_scatter_model

    def summed_then_sliced(x, tp, dim=-1, blocks=1):
        if tp is None:
            return x
        dim, M = dim % x.ndim, tp.size("model")
        whole = reduce_from_model(x, tp)
        return whole.unflatten(dim, (blocks, M, -1)).select(dim + 1, tp.coords["model"]).flatten(
            dim, dim + 1)

    xlstm.reduce_scatter_model = summed_then_sliced
    try:
        yield
    finally:
        xlstm.reduce_scatter_model = real


@contextlib.contextmanager
def plain_column_cut():
    """Phase 14's planted fault in the mLSTM whose heads do not split over
    ``model``: the whole cell output cut to the rank's columns by a plain
    slice, whose backward does not gather.  The forward is the sound one;
    each rank's whole ``wq``, ``wk`` and ``wv`` then get only their share of
    the gradient through the rank's own columns, a different gradient on
    every rank."""
    from repro_torch.models import xlstm

    real = xlstm._rank_columns

    def plain(h, tp):
        n = h.shape[-1] // tp.size("model")
        return h.narrow(-1, tp.coords["model"] * n, n)

    xlstm._rank_columns = plain
    try:
        yield
    finally:
        xlstm._rank_columns = real


def uneven_phase(smi, ref_logits, ref_first):
    """Phase 14 on the card, held to phase 10's one-rank references of the
    same cut: ``ref_logits`` (the prefill's last-token logits, numpy) and
    ``ref_first`` (step 1's loss and grad-norm).  Computes one rank's
    gradient of the probed ``wq``, spawns the ranks, checks their records
    and prints the phase's lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks

    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    arch, over, batch, prompt_len, gen_len, _ = UNEVEN_SERVE[0]
    cfg = get_config(arch).with_overrides(**over)
    n_ranks = math.prod(UNEVEN_MESH[0])
    name, limit = (x.strip() for x in smi.split(",", 1))
    print(f"[uneven] {n_ranks} ranks sharing one {name} ({limit}); the model group's exchange "
          "over gloo through host memory" if torch.cuda.device_count() < n_ranks else
          f"[uneven] {n_ranks} ranks, each on its own {name} ({limit})")
    print("[uneven] " + uneven_layout(cfg, UNEVEN_MESH[0]))
    probe_ref = grad_probe(*UNEVEN_PROBE, device="cuda", fault=None)["sound"]
    torch.cuda.empty_cache()
    print(f"[uneven] one rank's fp32 gradient of {UNEVEN_PROBE[3]} in "
          f"{time.perf_counter() - t14:.1f} s", flush=True)
    ranks = spawn_ranks(peaks_rank, n_ranks, ("uneven", tp_recurrent_rank, UNEVEN_SERVE,
                                               UNEVEN_TRAIN, UNEVEN_PROBE, False, None,
                                               UNEVEN_MESH, "plain_column_cut"), timeout=900)
    check_tp_recurrent_serving([r["serve"][0] for r in ranks], cfg, batch, prompt_len,
                               ref_logits, smi, UNEVEN_MESH, "uneven")
    _, _, rows, seq, micro, n_steps, _, _ = UNEVEN_TRAIN[0]
    check_tp_recurrent_training([r["train"][0] for r in ranks], cfg, (rows, seq, micro, n_steps),
                                ref_first, smi, UNEVEN_MESH, "uneven")
    check_grad_probe(ranks, get_config(arch).with_overrides(num_layers=UNEVEN_PROBE[1]),
                     UNEVEN_PROBE[3], probe_ref, UNEVEN_MESH, "uneven",
                     "the whole cell's output cut to the rank's columns by a plain slice")
    for r in ranks:
        print(f"[uneven] rank {r['coords']}: peak memory by job "
              f"{[round(j['peak_gb'], 2) for j in r['serve'] + r['train'] if 'peak_gb' in j]} GB")
    print(f"[uneven] {arch} at published width cut to {cfg.num_layers} blocks in fp32, served, "
          f"trained and probed on {UNEVEN_MESH[0]} over {UNEVEN_MESH[1]}: phase 14 took "
          f"{time.perf_counter() - t14:.1f} s; {smi}")


def uneven_layout(cfg, shape) -> str:
    """Which of ``cfg``'s leaves ``param_layout`` keeps whole on a ``(data,
    model)`` mesh of ``shape``, by leaf name, and the mLSTM's layout there."""
    from repro_torch.models import model_specs
    from repro_torch.sharding.shard import param_layout

    layout = param_layout(model_specs(cfg), cfg.act, cpu_mesh(shape))
    whole = sorted({k.split(".", 2)[-1] for k, pl in layout.items()
                    if k.startswith("blocks.") and pl.dim_of("model") is None})
    split = sorted({k.split(".", 2)[-1] for k, pl in layout.items()
                    if k.startswith("blocks.") and pl.dim_of("model") is not None})
    M, H = shape[1], cfg.num_heads
    return (f"{cfg.name} on model {M}: {H} heads {'split' if H % M == 0 else 'whole'}, the "
            f"block leaves whole on model {whole}, split {split}")


def tpr_layer_bytes(cfg, kind, M, pos, cache=0):
    """One layer's ``model``-group wire bytes per rank over ``pos`` positions
    (rows times positions), by ``core/asymmetry.py``'s formulas: (the
    forward's exchanges in order, whether the last is the output's *g*, the
    backward's sum).  ``cache``: a decode step's cache positions, which the
    head-dim split gathers whole.  RG-LRU: the gates' partials
    reduce-scattered ``[pos, 2W]``, *g* after the block and after the FFN;
    backward the gates' all-gather, *f* after each norm, and the all-gathers
    of ``b_a``, ``b_i`` and ``lam``'s slices.  GQA attention: where the KV
    heads do not split, k and v gathered whole (and in decode the cache),
    their gradient reduce-scattered; *g* and *f* as above.  mLSTM: ``w_if``'s
    fp32 partials reduce-scattered ``[pos, 2H]``, the squares' fp32 sum
    all-reduced, *g*; backward their all-gather and all-reduce, *f*, and the
    all-gathers of ``b_if``'s and ``gnorm.scale``'s slices; where its heads
    do not divide (the inner width does), the up-projection ``[pos, inner]``
    gathered, ``w_if``'s fp32 partials all-reduced ``[pos, 2H]``, the squares
    and *g*; backward the squares, the cell output's gradient gathered
    ``[pos, inner]`` (``slice_model``), *f* and ``gnorm.scale``'s gather
    (``b_if`` is whole); where the inner width does not divide, nothing.
    sLSTM: the FFN as ``[gate_m | up_m]`` *g* and *f*; split contiguously
    the projection gathered and *f*; whole, nothing."""
    import torch

    from repro_torch.core.asymmetry import (all_gather_wire_bytes, allreduce_wire_bytes,
                                            reduce_scatter_wire_bytes)

    e = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    act = allreduce_wire_bytes(pos * cfg.d_model * e, M)
    ag = lambda n: all_gather_wire_bytes(n, M)
    if kind == "rec":
        W = cfg.rglru.width or cfg.d_model
        rs = reduce_scatter_wire_bytes(pos * 2 * W * e, M)
        return [rs, act, act], True, ag(pos * 2 * W * e) + 2 * act + ag(W * e) * 2 + ag(W * 4)
    if kind == "attn":
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        if K % M == 0:
            return [act, act], True, 2 * act
        kv = 2 * pos * K * hd * e
        gathers = [ag(kv)] + ([ag(kv * cache)] if cache else [])
        return gathers + [act, act], True, reduce_scatter_wire_bytes(kv, M) + 2 * act
    if kind == "mlstm":
        H, inner = cfg.num_heads, int(cfg.xlstm.proj_factor_m * cfg.d_model)
        gates, squares = pos * 2 * H * 4, allreduce_wire_bytes(pos * 4, M)
        if inner % M:
            return [], False, 0
        if H % M:
            up = ag(pos * inner * e)
            return ([up, allreduce_wire_bytes(gates, M), squares, act], True,
                    squares + up + act + ag(inner * e))
        return ([reduce_scatter_wire_bytes(gates, M), squares, act], True,
                ag(gates) + squares + act + ag(2 * H * 4) + ag(inner * e))
    dff = int(cfg.xlstm.proj_factor_s * cfg.d_model)
    if dff % M == 0:
        return [act], True, act
    if (2 * dff) % M == 0:
        return [ag(pos * 2 * dff * e)], False, act
    return [], False, 0


def tpr_wire_bytes(cfg, M, rows, positions, micro=0, cache=0):
    """The ``model`` group's wire bytes per rank on a mesh of one data rank
    and ``M`` model ranks (:func:`tpr_layer_bytes`): with ``micro`` 0 one
    prefill over ``positions`` (1 with ``cache``: a decode step) of
    ``rows``: *g* after the vocab-parallel embedding, each layer's forward
    and the last position's logits gathered over the vocab shards; with
    ``micro`` microbatches, one train step of ``rows`` rows: per microbatch
    the forward, remat's recompute of each super-block (all but its last
    *g*, which nothing that the backward keeps depends on), the backward
    and *f* ahead of the logits, and the cross-entropy's max, sum of
    exponents and label logit over the vocab shards (twice per chunk of
    ``chunked_xent``); ``world``: the global norm's sum."""
    import torch

    from repro_torch.core.asymmetry import all_gather_wire_bytes, allreduce_wire_bytes
    from repro_torch.models import layer_plan

    plan = layer_plan(cfg)
    e = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    b = rows // max(micro, 1)
    pos = b * positions
    vocab = cfg.vocab_size % M == 0  # the rules split the vocab where it divides
    act = allreduce_wire_bytes(pos * cfg.d_model * e, M) if vocab else 0
    kinds = list(plan.lead) + list(plan.pattern) * plan.n_scan + list(plan.tail)
    layers = {k: tpr_layer_bytes(cfg, k, M, pos, cache) for k in set(kinds)}
    forward = act + sum(sum(layers[k][0]) for k in kinds)
    if not micro:
        return {"model": forward + vocab * all_gather_wire_bytes(rows * cfg.vocab_size * e, M)}
    last = layers[plan.pattern[-1]]
    recompute = plan.n_scan * (sum(sum(layers[k][0]) for k in plan.pattern)
                               - (last[0][-1] if last[1] else 0))
    chunked = positions >= 2048 and positions % 1024 == 0
    xent = vocab * (2 if chunked else 1) * 3 * allreduce_wire_bytes(4 * pos, M)
    backward = act + sum(layers[k][2] for k in kinds)
    return {"model": micro * (forward + recompute + backward + xent),
            "world": allreduce_wire_bytes(4, M)}


def grad_probe(arch, layers, seq, key, smoke=False, device=None, mesh=None,
               fault="w_if_through_g"):
    """The fp32 gradient of parameter ``key`` of ``arch`` (published width
    cut to ``layers`` layers, or smoke width) at its initial weights on the
    first row's first ``seq`` tokens of 6(e)'s batch (6(e)'s slope row), as
    one rank computes it whole (``mesh`` None) or as this rank of ``mesh``
    computes its block: sound and under ``fault`` (the name of a context
    manager here: phase 10's :func:`w_if_through_g`, phase 14's
    :func:`plain_column_cut`)."""
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import Model

    cfg = get_config(arch, smoke=smoke).with_overrides(dtype="float32")
    if layers:
        cfg = cfg.with_overrides(num_layers=layers)
    dev = mesh.device if mesh is not None else torch.device(device or "cuda")
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0), mesh=mesh)
    row = SyntheticLMDataset(cfg, ShapeConfig("row", seq, 1, "train"), seed=0).batch(0)
    row = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in row.items()}
    param = dict(model.named_parameters())[key]
    out = {}
    faults = (("fault", globals()[fault]),) if fault else ()
    for name, ctx in (("sound", contextlib.nullcontext),) + faults:
        with ctx():
            g, = torch.autograd.grad(model.loss(row)[0], [param])
        out[name] = g.cpu().numpy()
    return out


def one_rank_step(arch, over, rows, seq, micro, lr, warmup, smoke=False, device="cuda"):
    """Step 1's (loss, grad-norm) of ``train(arch)`` on one rank, its
    config's fields ``over`` set (:func:`at_depth`)."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import train as train_mod

    with tempfile.TemporaryDirectory() as tmp, at_depth(train_mod, None, **over):
        run = RunConfig(learning_rate=lr, warmup_steps=warmup, total_steps=1,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        hist = train_mod.train(arch, smoke=smoke, steps=1,
                               shape=ShapeConfig("train_4k", seq, rows, "train"), run=run,
                               log_every=1, device=device)["history"]
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return hist[0]["loss"], hist[0]["grad_norm"]


def tp_recurrent_rank(serving, training, probe, smoke=False, device=None,
                      mesh_spec=TPR_MESH, probe_fault="w_if_through_g"):
    """One rank of phase 10 (and of 14), spawned: :func:`tp_serve_rank` on
    ``mesh_spec`` for each (arch, config fields, batch, prompt, generated
    tokens, fault) of ``serving``, :func:`tp_train_rank` for each (arch,
    config fields, rows, tokens per row, microbatches, steps, peak lr,
    warmup) of ``training`` (no fault: the training fault is the probe's),
    then :func:`grad_probe` of ``probe`` (arch, layers, tokens, key) on the
    mesh, its fault ``probe_fault``.  Returns their records."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    def free():
        gc.collect()
        if device is None:
            torch.cuda.empty_cache()

    out = {"serve": [], "train": []}
    for arch, over, batch, prompt_len, gen_len, fault in serving:
        out["serve"].append(tp_serve_rank(arch, batch, prompt_len, gen_len, smoke, device,
                                          over, mesh_spec, fault))
        free()
    for arch, over, rows, seq, micro, n_steps, lr, warmup in training:
        out["train"].append(tp_train_rank(arch, rows, seq, micro, n_steps, lr, smoke, device,
                                          over, mesh_spec, None, warmup))
        free()
    mesh = make_mesh(*mesh_spec, device=device)
    out["probe"] = grad_probe(*probe, smoke=smoke, mesh=mesh, fault=probe_fault)
    out["coords"] = dict(mesh.coords)
    return out


def check_tp_recurrent_serving(ranks, cfg, batch, prompt_len, ref_logits, smi,
                               mesh_spec=TPR_MESH, tag="tpr"):
    """Phase 10's (and 14's, on ``mesh_spec``, its lines tagged ``tag``)
    serving checks over the ranks' :func:`tp_serve_rank`
    records of ``cfg`` (cut to its depth), against the one-rank
    ``ref_logits`` (numpy ``[batch, V]``): each rank's prefill logits within
    ``TP_LOGITS_RTOL`` in relative L2, and where the rank ran a fault its
    logits outside it; every row's first token the one rank's argmax and
    every rank's tokens rank 0's; the ``model`` group's bytes of the
    prefill and of each decode step equal :func:`tpr_wire_bytes`; on the
    card (``smi`` not None) per prefill one flash launch an attention layer
    on ``wgmma`` and one scan launch an RG-LRU layer on ``tma``, none in
    decode, and no plain call (on the CPU: no launch).  Returns the largest
    relative L2."""
    import numpy as np

    from repro_torch.models import layer_plan

    M = mesh_spec[0][1]
    rel = lambda a: float(np.linalg.norm(a - ref_logits) / np.linalg.norm(ref_logits))
    first = ref_logits.argmax(-1)
    plan = layer_plan(cfg)
    per = lambda k: plan.n_scan * plan.pattern.count(k) + plan.tail.count(k)
    want_launches = {k: v for k, v in (
        ("flash_attention", per("attn")), ("flash_attention:wgmma", per("attn")),
        ("rglru_scan", per("rec")), ("rglru_scan:tma", per("rec"))) if v}
    S = min(prompt_len + len(ranks[0]["decode_bytes"]) + 1, cfg.window or 1 << 62)
    want = tpr_wire_bytes(cfg, M, batch, prompt_len)
    want_d = tpr_wire_bytes(cfg, M, batch, 1, cache=S)
    worst, fault = 0.0, []
    for rank, r in enumerate(ranks):
        gap = rel(r["logits"])
        worst = max(worst, gap)
        if not gap <= TP_LOGITS_RTOL:
            raise AssertionError(f"{cfg.name} rank {rank}: prefill logits {gap:.3e} from one "
                                 f"rank's (limit {TP_LOGITS_RTOL})")
        if "fault_logits" in r:
            fault.append(rel(r["fault_logits"]))
            if not fault[-1] > TP_LOGITS_RTOL:
                raise AssertionError(f"{cfg.name} rank {rank}: the planted fault's logits lie "
                                     f"{fault[-1]:.3e} from one rank's, within "
                                     f"{TP_LOGITS_RTOL}: the check cannot tell")
        if not np.array_equal(r["tokens"][:, 0], first):
            raise AssertionError(f"{cfg.name} rank {rank}: first tokens {r['tokens'][:, 0]} "
                                 f"differ from one rank's {first}")
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"{cfg.name} rank {rank}'s tokens differ from rank 0's")
        if r["prefill_bytes"] != want:
            raise AssertionError(f"{cfg.name} rank {rank}: prefill wire bytes "
                                 f"{r['prefill_bytes']}, asymmetry's formulas {want}")
        if any(w != want_d for w in r["decode_bytes"]):
            raise AssertionError(f"{cfg.name} rank {rank}: decode wire bytes "
                                 f"{r['decode_bytes'][:2]}..., asymmetry's formulas {want_d}")
        launched = {k: v for k, v in r["prefill_launches"].items() if v}
        decode = {k: v for d in r["decode_launches"] for k, v in d.items() if v}
        if smi is not None and (launched != want_launches or decode or r["plain"]):
            raise AssertionError(f"{cfg.name} rank {rank}: prefill launches {launched}, "
                                 f"decode {decode}, plain versions {r['plain']}; expected "
                                 f"{want_launches}, none in decode, no plain call")
        if smi is None and (launched or decode):
            raise AssertionError(f"{cfg.name} rank {rank}: launches on the CPU")
    print(f"[{tag}] serving {cfg.name} ({cfg.num_layers} layers) on "
          f"{dict(zip(*reversed(mesh_spec)))}: prefill logits against one rank's, relative L2 "
          f"{[round(rel(r['logits']), 6) for r in ranks]} (limit {TP_LOGITS_RTOL})"
          + (f"; the planted fault (RoPE on the rank's head-dim slice before the gather) "
             f"{[round(f, 4) for f in fault]}" if fault else "")
          + f"; first tokens equal; prefill s {[round(r['prefill_s'], 4) for r in ranks]}, "
          f"decode ms/token {[round(r['decode_ms'], 3) for r in ranks]}; model-group wire bytes "
          f"per prefill {ranks[0]['prefill_bytes']} and per token {ranks[0]['decode_bytes'][0]} "
          f"= asymmetry's formulas; launches per rank and prefill {ranks[0]['prefill_launches']}"
          f"; calls of the plain versions {ranks[0]['plain']}; backends {ranks[0]['backends']}; "
          f"{smi}")
    one = shard_bytes(cfg, (1, 1))[0]
    for rank, r in enumerate(ranks):
        print(f"[{tag}] serving {cfg.name} rank {rank} on {r['device']}: parameters "
              f"{r['param_bytes']} B against one rank's {one} B ({r['param_bytes'] / one:.4f}; "
              f"the leaves split on model "
              f"{tpr_split_share(cfg, r['param_bytes'], mesh_spec):.4f})"
              + (f", peak memory {r['peak_gb']:.2f} GB" if "peak_gb" in r else ""))
    return worst, fault


def tpr_split_share(cfg, param_bytes, mesh_spec=TPR_MESH):
    """Of a rank's ``param_bytes`` on ``mesh_spec``, the share of the leaves
    that the rules split on ``model``: (``param_bytes`` less the bytes of the
    leaves whole on ``model``) over those split leaves' whole bytes."""
    import torch

    from repro_torch.models import model_specs
    from repro_torch.sharding.shard import named_leaves, param_layout

    layout = param_layout(model_specs(cfg), cfg.act, cpu_mesh(mesh_spec[0]))
    whole = {True: 0, False: 0}
    for key, spec in named_leaves(model_specs(cfg)):
        size = math.prod(spec.shape) * torch.empty((), dtype=spec.dtype).element_size()
        whole[layout[key].dim_of("model") is not None] += size
    return (param_bytes - whole[False]) / whole[True]


def check_tp_recurrent_training(ranks, cfg, run, ref, smi, mesh_spec=TPR_MESH, tag="tpr"):
    """Phase 10's (and 14's, on ``mesh_spec``, its lines tagged ``tag``)
    training checks over the ranks' :func:`tp_train_rank`
    records of ``cfg`` (cut to its depth) trained with ``run`` (rows, tokens
    per row, microbatches, steps), by :func:`check_rank_steps`: every rank's
    losses equal; each step's wire bytes equal :func:`tpr_wire_bytes`; each
    rank's parameter and moment bytes its blocks' by the rules
    (:func:`shard_bytes`); each step's launches on the card (``smi`` not
    None) ``expected_counts``: flash forward and backward on ``wgmma``, the
    scan's on ``tma``, and no plain call (on the CPU: no launch); then step
    1's loss and grad-norm within ``TP_LOSS_RTOL`` and ``TP_NORM_RTOL`` of
    ``ref`` (a one-rank run's step 1, (loss, grad-norm)).  Returns step 1's
    gaps."""
    from repro_torch.models import layer_plan

    rows, seq, micro, n_steps = run
    hist = ranks[0]["history"]
    losses = check_rank_steps(ranks, tpr_wire_bytes(cfg, mesh_spec[0][1], rows, seq, micro),
                              shard_bytes(cfg, mesh_spec[0]),
                              expected_counts(layer_plan(cfg), micro) if smi else None)
    if len(losses) != n_steps:
        raise AssertionError(f"{cfg.name}: {len(losses)} steps, expected {n_steps}")
    gaps = (abs(losses[0] - ref[0]) / abs(ref[0]), abs(hist[0]["grad_norm"] - ref[1]) / ref[1])
    print(f"[{tag}] training {cfg.name} ({cfg.num_layers} layers) on "
          f"{dict(zip(*reversed(mesh_spec)))}, {rows} x {seq} in {micro} microbatches: losses "
          f"{losses}, grad-norms {[h['grad_norm'] for h in hist]}; step 1 against one rank's "
          f"(loss {ref[0]}, grad-norm {ref[1]}): relative {gaps[0]:.3e} and {gaps[1]:.3e} "
          f"(limits {TP_LOSS_RTOL}, {TP_NORM_RTOL}); s per step "
          f"{[round(h['seconds_per_step'], 4) for h in hist]}, exchange s per step "
          f"{[{g: round(t, 4) for g, t in h['exchange_seconds'].items()} for h in hist]}; wire "
          f"bytes per step {hist[0]['wire_bytes']} = asymmetry's formulas; launches per step and "
          f"rank { {k: c for k, c in ranks[0]['steps'][0].items() if c} }; calls of the plain "
          f"versions {ranks[0]['plain']}; {smi}")
    one = shard_bytes(cfg, (1, 1))
    for rank, r in enumerate(ranks):
        print(f"[{tag}] training {cfg.name} rank {rank} on {r['device']}: parameters "
              f"{r['param_bytes']} B and moments {r['moment_bytes']} B = its blocks by the "
              f"rules, {(r['param_bytes'] + r['moment_bytes']) / sum(one):.4f} of one rank's "
              f"{sum(one) / 1e9:.3f} GB"
              + (f"; peak memory {r['peak_gb']:.2f} GB, mem_get_info free "
                 f"{r['mem_get_info'][0]:.2f} of {r['mem_get_info'][1]:.2f} GB"
                 if "peak_gb" in r else ""))
    if gaps[0] > TP_LOSS_RTOL or gaps[1] > TP_NORM_RTOL:
        raise AssertionError(f"{cfg.name} step 1 on {mesh_spec[0]}: loss {losses[0]}, grad-norm "
                             f"{hist[0]['grad_norm']} against one rank's {ref}: {gaps}")
    return gaps


def check_grad_probe(ranks, cfg, key, ref, mesh_spec=TPR_MESH, tag="tpr",
                     fault="w_if's partial through g, then sliced"):
    """Phase 10's (and 14's) probe of the mLSTM's gradient over the ranks'
    :func:`grad_probe` records against one rank's whole gradient ``ref``:
    each rank's block of it (its layout on ``mesh_spec``) in relative L2
    within ``TPR_GRAD_RTOL``, and under the planted fault (described by
    ``fault``) outside it.  Returns (the sound gaps, the fault's)."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model_specs
    from repro_torch.sharding.shard import param_layout, shard

    axes = mesh_spec[1]
    pl = param_layout(model_specs(cfg), cfg.act, cpu_mesh(mesh_spec[0]))[key]
    gaps = {"sound": [], "fault": []}
    for r in ranks:
        mesh = Mesh(axes=axes, shape=dict(zip(axes, mesh_spec[0])), coords=r["coords"],
                    device=torch.device("cpu"))
        want = shard(torch.from_numpy(ref), pl, mesh).numpy()
        for name in gaps:
            gaps[name].append(float(np.linalg.norm(r["probe"][name] - want) / np.linalg.norm(want)))
    print(f"[{tag}] {cfg.name}'s fp32 gradient of {key} at the initial weights on one row, "
          f"each rank's block against one rank's, relative L2: {gaps['sound']} (limit "
          f"{TPR_GRAD_RTOL}); the planted fault ({fault}) {gaps['fault']}")
    if not max(gaps["sound"]) <= TPR_GRAD_RTOL:
        raise AssertionError(f"{key}'s gradient lies {gaps['sound']} from one rank's "
                             f"(limit {TPR_GRAD_RTOL})")
    if not min(gaps["fault"]) > TPR_GRAD_RTOL:
        raise AssertionError(f"the planted fault's gradient of {key} lies {gaps['fault']} from "
                             f"one rank's, within {TPR_GRAD_RTOL}: the check cannot tell")
    return gaps["sound"], gaps["fault"]


def published_width_training(arch, layers, rows, seq, micro, n_steps, lr, tol, smi,
                             smoke=False, device="cuda"):
    """Phases 6(g) and 6(h): ``train(arch)`` at published widths cut to
    ``layers`` layers (``get_config`` patched in train's namespace), bf16
    parameters, fp32 AdamW moments, block remat, ``rows`` x ``seq`` positions
    a step in ``micro`` microbatches, ``n_steps`` steps at peak ``lr`` (1
    warmup step), each step's launches counted from zero.  It must show
    every loss finite, the weight matrices moved (the router and the experts
    among them), each step's flash launches as ``layer_plan`` implies, all
    ``wgmma``, and no call of a plain version; it prints s/step, positions/s,
    the model-FLOPs share (:func:`train_step_flops`) and the peak memory.
    Then one microbatch's forward and backward timed with CUDA events, the
    attention backward apart, and that microbatch's loss and every gradient
    through the kernels against the plain versions in the forward, remat's
    recompute and the backward, within ``tol``; a recompute without the
    causal mask, wrong on purpose, must exceed it.  Returns the run's
    launches and the attention backward's ms per call in the microbatch.
    ``smoke`` and ``device="cpu"`` rehearse the phase on the CPU at smoke
    width, where no kernel launches."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.train import to_device
    from repro_torch.models import Model, layer_plan

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = get_config(arch, smoke=smoke).with_overrides(num_layers=layers)
    plan = layer_plan(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(learning_rate=lr, warmup_steps=1, total_steps=n_steps,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        reset_counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        shape = ShapeConfig(f"train_{seq}", seq, rows, "train")
        with timed_optimizer() if on_card else contextlib.nullcontext([]) as updates:
            res, step_counts, plain_calls = counted_training(arch, layers, shape, run, device,
                                                             smoke=smoke)
        train_s = time.perf_counter() - t
    adamw_ms = [start.elapsed_time(end) for start, end in updates[1:]] if on_card else []
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else math.nan
    hist = res["history"]
    trained = res["final_state"]["params"]
    del res  # the moments: 8 bytes a parameter
    gc.collect()
    n_params = sum(t.numel() for t in trained.values())
    model_flops, attn_flops, active = train_step_flops(cfg, trained, rows, seq)
    init = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(run.seed))
    # Every weight matrix must have moved from its init; the norm scales (1 at
    # init) need not: a step of lr 3e-4 is under half of bf16's spacing at 1.
    unmoved = [k for k, p in init.named_parameters()
               if not k.endswith(".scale") and torch.equal(p, trained[k])]
    del init, trained
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    for h, counts in zip(hist, step_counts):
        print(f"[train] {arch} {layers} layers step {h['step']}: loss {h['loss']:.6f}, grad-norm "
              f"{h['grad_norm']:.6f}, {h['seconds_per_step']:.4f} s; launches "
              + ", ".join(f"{n} {c}" for n, c in counts.items() if c))
    step_s = statistics.mean(h["seconds_per_step"] for h in hist[1:])
    expect = (expected_counts(plan, micro, cfg.mtp_depth) if on_card
              else dict.fromkeys(launch_counts(), 0))
    moe = (f", {cfg.moe.num_experts} routed experts top-{cfg.moe.top_k} and "
           f"{cfg.moe.num_shared} shared" if cfg.moe else "")
    print(f"[train] {arch} published widths at {layers} of {get_config(arch).num_layers} layers "
          f"({plan.lead} + {plan.n_scan} x {plan.pattern} + {plan.tail}{moe}), bf16 (fp32 "
          f"moments, block remat), {n_params} parameters ({active:.0f} active a position), "
          f"{rows} rows x {seq} positions in {micro} microbatches (reduced: depth and the "
          f"global batch), lr {run.learning_rate} (warmup {run.warmup_steps}): {step_s:.4f} s per "
          f"step after the first (mean of steps 2-{n_steps}), {rows * seq / step_s:.1f} "
          f"positions/s, model FLOPs {model_flops / 1e12:.2f} T per step ({attn_flops / 1e12:.2f} "
          f"T attention), {100 * model_flops / step_s / PEAK_BF16_FLOPS:.2f} % of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory {peak_gb:.2f} GB; the AdamW "
          f"update (norm, clip, chunked update; CUDA events, steps 2-{n_steps}) "
          + (f"{statistics.mean(adamw_ms):.1f} ms = "
             f"{100 * statistics.mean(adamw_ms) / 1e3 / step_s:.1f} % of the step"
             if adamw_ms else "not measured")
          + f"; {train_s:.1f} s in train(); losses {[round(h['loss'], 6) for h in hist]}; "
          f"launches per step expected " + ", ".join(f"{n} {c}" for n, c in expect.items() if c)
          + f"; weight matrices left at their init {unmoved or 'none'}; calls of the plain "
          f"versions {plain_calls}; {smi}")
    if len(step_counts) != n_steps or len(hist) != n_steps:
        raise AssertionError(f"{arch} trained {len(step_counts)} steps, expected {n_steps}")
    if any(c != expect for c in step_counts) or (plain_calls and on_card):
        raise AssertionError(f"{arch} training launched {step_counts}, expected {expect} per "
                             f"step, and called the plain versions {plain_calls} times, "
                             f"expected never")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss in {[h['loss'] for h in hist]}")
    if unmoved:
        raise AssertionError(f"{arch}: weights that did not move {unmoved}")

    # One microbatch, timed, then through the kernels against the plain
    # versions; the wrong recompute drops the causal mask in remat's calls,
    # which come after the forward's.
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    mb = SyntheticLMDataset(cfg, ShapeConfig("mb", seq, rows // micro, "train"), seed=0).batch(0)
    mb = {k: to_device(v, dev) for k, v in mb.items()}
    attn_ms = None
    if on_card:
        fwd_ms, bwd_ms, timed = timed_microbatch(model, mb, {"attention": ops._FlashAttention})
        attn = timed["attention"]
        attn_ms = sum(t for t, _ in attn) / len(attn)
        print(f"[train] {arch} {layers} layers, one microbatch ({rows // micro} x {seq}): forward "
              f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (with remat's recompute), of which the "
              f"attention backward (the kernel) {attn_ms * len(attn):.2f} ms in {len(attn)} calls "
              f"= {100 * attn_ms * len(attn) / bwd_ms:.1f} %, {attn_ms:.3f} ms and "
              f"{max(p for _, p in attn) / 1e9:.2f} GB of transient memory per call; {micro} "
              f"microbatches {micro * (fwd_ms + bwd_ms):.1f} ms of the {step_s * 1e3:.1f} ms "
              f"step; {smi}")
    plain = plain_entries()
    forward = forward_flash_calls(cfg)
    calls = []

    def wrong_recompute(q, k, v, causal, window, scale, lse=False):
        calls.append(None)  # the forward's calls first, then remat's
        return plain["_flash_fwd"](q, k, v, causal and len(calls) <= forward, window, scale,
                                   lse)

    before = launch_counts()
    kernel_run = microbatch_grads(model, mb)
    mb_launches = {k: c - before[k] for k, c in launch_counts().items()}
    before = launch_counts()
    plain_run = microbatch_grads(model, mb, plain)
    plain_launches = {k: c - before[k] for k, c in launch_counts().items() if c != before[k]}
    gaps = grad_gaps(kernel_run, plain_run)
    del kernel_run
    wrong_run = microbatch_grads(model, mb, {**plain, "_flash_fwd": wrong_recompute})
    wrong = grad_gaps(wrong_run, plain_run)
    del model, mb, plain_run, wrong_run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mb_expect = (expected_counts(plan, 1, cfg.mtp_depth) if on_card
                 else dict.fromkeys(launch_counts(), 0))
    print(f"[train] {arch} {layers} layers, one microbatch ({rows // micro} x {seq}), kernels "
          f"(launches " + ", ".join(f"{n} {c}" for n, c in mb_launches.items() if c)
          + f") vs plain versions in forward, recompute and backward: relative loss gap "
          f"{gaps[0]:.3e} (limit {tol['loss']}); worst leaf |g - g_plain| / |g_plain| "
          f"{gaps[1]:.3e} ({gaps[3]}; limit {tol['grad']}); worst leaf norm gap {gaps[2]:.3e} "
          f"(limit {tol['norm']}); a recompute without the causal mask: {wrong[0]:.3e}, "
          f"{wrong[1]:.3e} ({wrong[3]}), {wrong[2]:.3e}; {smi}")
    if mb_launches != mb_expect or plain_launches or len(calls) != forward + plan.n_scan * (
            plan.pattern.count("attn")):
        raise AssertionError(f"the kernels' microbatch launched {mb_launches}, expected "
                             f"{mb_expect}; the plain one {plain_launches}; the wrong run "
                             f"called the plain forward {len(calls)} times")
    if not (gaps[0] <= tol["loss"] and gaps[1] <= tol["grad"] and gaps[2] <= tol["norm"]):
        raise AssertionError(f"{arch} training through the kernels disagrees with the plain "
                             f"versions at published widths: {gaps}")
    if wrong[1] <= tol["grad"]:
        raise AssertionError(f"the gradient check does not see a wrong recompute: {wrong}")
    return launches, attn_ms


def parent_scan():
    """The RG-LRU scan's autograd Function as the parent tree had it, for a
    measurement only: the forward kernel, saving a, b and h0; the backward
    the oracle's autograd, its forward recomputed on detached copies."""
    import torch

    from repro_torch.kernels import ops, ref

    class ParentScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b, h0):
            ctx.save_for_backward(a, b, h0)
            return ops._scan_fwd(a, b, h0)

        @staticmethod
        def backward(ctx, g):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
                return torch.autograd.grad(ref.rglru_scan_ref(*xs), xs, g)

    return ParentScan


def device_times(fn, tries=1):
    """{name: (device us, count)} of each kernel and copy in a torch.profiler
    trace of one call of ``fn``.  A trace can come back without device time:
    up to ``tries`` traces are taken, and {} is returned if none has any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            us = getattr(ev, "self_cuda_time_total", 0) if us is None else us
            if us > 0:
                times[ev.key] = (us, ev.count)
        if times:
            return times
    return {}


def sdpa_backend(fn, tries=3):
    """The SDPA backend that ran ``fn``, read from the names of the kernels a
    profiler trace of one call shows (flash, efficient, cudnn or math), and
    the three kernels that took the most device time; not named if none of
    ``tries`` traces has device time."""
    times = device_times(fn, tries)
    if not times:
        return f"not named (no device time in {tries} profiler traces)", []
    names = " ".join(times).lower()
    backend = next((label for label, keys in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                                               ("efficient", ("fmha", "efficient", "mem_eff")))
                    if any(k in names for k in keys)), "math")
    top = sorted(times, key=lambda n: times[n][0], reverse=True)[:3]
    return backend, [name[:90] for name in top]


def head_slices(B: int, Tq: int, Tk: int, H: int, K: int):
    """(query-head slice, KV-head slice) pairs that cover the heads in whole
    GQA groups, each group's fp32 scores [B, H/K, Tq, Tk] together at most
    PLAIN_BYTES (one slice wherever one group alone is more)."""
    G = H // K
    n = max(1, min(K, PLAIN_BYTES // (B * G * Tq * Tk * 4)))
    return [(slice(i * G, min(i + n, K) * G), slice(i, min(i + n, K))) for i in range(0, K, n)]


def plain_fwd(q, k, v, **mask):
    """The plain forward (``ref.flash_attention_ref``) over the slices of
    :func:`head_slices`, joined on the heads."""
    import torch

    from repro_torch.kernels import ref

    parts = [ref.flash_attention_ref(q[:, :, hq], k[:, :, hk], v[:, :, hk], **mask)
             for hq, hk in head_slices(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                                       k.shape[2])]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def plain_bwd_oracle(q, k, v, g, **mask):
    """A call that runs the oracle's autograd with its forward (the plain
    backward as the reference takes it) over the slices of :func:`head_slices`,
    each slice its own leaves; for timing."""
    import torch

    from repro_torch.kernels import ref

    parts = []
    for hq, hk in head_slices(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2]):
        leaves = [x.detach().requires_grad_() for x in (q[:, :, hq], k[:, :, hk], v[:, :, hk])]
        parts.append((leaves, g[:, :, hq]))
    return lambda: [torch.autograd.grad(ref.flash_attention_ref(*leaves, **mask), leaves, gs)
                    for leaves, gs in parts]


FUSED_SDPA = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_backends(q, k, v, grad=False, **kw):
    """The SDPA backends to pin for these inputs ([B, heads, T, d]) and a
    note: the fused ones (cuDNN, flash, efficient), so that a comparison
    cannot fall to the math backend unseen; where none of them takes the shape
    (the forward, and with ``grad`` its backward), the math backend, said so."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fused = [getattr(SDPBackend, name) for name in FUSED_SDPA]
    try:
        with sdpa_kernel(fused):
            leaves = [x.detach().requires_grad_(grad) for x in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, **kw)
            if grad:
                torch.autograd.grad(out, leaves, torch.ones_like(out))
        return fused, "pinned to the fused backends"
    except RuntimeError as exc:
        if not any(m in str(exc) for m in ("No available kernel", "No viable backend")):
            raise
    return [SDPBackend.MATH], "no fused SDPA backend takes this shape: the math backend"


def attn_pairs(T: int, causal: bool, window: int):
    """The [T, T] mask of kept (query, key) pairs, True = kept, on the CPU."""
    import torch

    pos = torch.arange(T)
    keep = torch.ones(T, T, dtype=torch.bool)
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    return keep


def grad_gaps(got, want):
    """(relative loss gap, worst leaf's |g - g'| / |g'|, worst leaf's
    relative gap of the norms, that leaf's name) between two
    :func:`microbatch_grads` readings, in fp32.  A leaf whose gradient is
    zero in ``want`` (a parameter the loss does not read) gaps 0 where
    ``got``'s is zero too, and infinitely otherwise; a gap that is not a
    number (a NaN in either gradient or loss) reads as infinite."""
    (loss, grads), (loss_w, grads_w) = got, want
    finite = lambda x: x if not math.isnan(x) else math.inf
    l2, norm = {}, {}
    for key, w in grads_w.items():
        gn, wn, dn = chunked_norms(grads[key], w)
        if wn == 0:
            l2[key] = norm[key] = math.inf if gn != 0 else 0.0
            continue
        l2[key] = finite(dn / wn)
        norm[key] = finite(abs(gn - wn) / wn)
    worst = max(l2, key=l2.get)
    return finite(abs(loss - loss_w) / abs(loss_w)), l2[worst], max(norm.values()), worst


def chunked_norms(g, w, chunk: int = 2 ** 26):
    """(|g|, |w|, |g - w|) in fp32, over slices of at most ``chunk``
    elements (a whole fp32 copy of deepseek-v2's routed experts is 10 GB)."""
    import torch

    sums = [0.0, 0.0, 0.0]
    for a, b in zip(g.reshape(-1).split(chunk), w.reshape(-1).split(chunk)):
        a, b = a.float(), b.float()
        for i, x in enumerate((a, b, a - b)):
            sums[i] += torch.linalg.vector_norm(x).item() ** 2
    return tuple(math.sqrt(x) for x in sums)


def rel_l2(got, want) -> float:
    """|got - want| / |want| over every element, in fp32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def gradient_slope(model, batch, changes):
    """For each ``change``: the loss of ``batch`` at the weights moved by -t g
    and by +t g (g the gradient there, t = change / |g|^2), as (measured
    change between the two, the first-order prediction g . (the displacement
    the weights took)).  The weights are left moved."""
    import torch

    from repro_torch.launch.steps import grad_fn

    _, _, grads = grad_fn(model, 1)(batch)
    params = dict(model.named_parameters())
    gg = sum(float(torch.sum(g.double() ** 2)) for g in grads.values())
    base = {k: p.detach().clone() for k, p in params.items()}
    out = []
    for change in changes:
        loss, moved = {}, {}
        with torch.no_grad():
            for sign in (-1, 1):
                for k, p in params.items():
                    p.copy_(base[k] + sign * (change / gg) * grads[k])
                loss[sign] = model.loss(batch)[0].item()
                moved[sign] = sum(float(torch.sum(grads[k].double() * (p.double() - base[k])))
                                  for k, p in params.items())
        out.append((loss[1] - loss[-1], moved[1] - moved[-1]))
    return out


@contextlib.contextmanager
def timed_block_kinds():
    """CUDA events around each block that ``Model`` runs in the block; yields
    {kind: [(start, end)]}."""
    import torch

    from repro_torch.models import transformer

    log = {}
    real = transformer._block_apply

    def call(cfg, kind, *args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real(cfg, kind, *args)
        end.record()
        log.setdefault(kind, []).append((start, end))
        return out

    transformer._block_apply = call
    try:
        yield log
    finally:
        transformer._block_apply = real


def event_ms(pairs) -> float:
    """The summed time of (start, end) event pairs, in ms, once they ended."""
    for _, end in pairs:
        end.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs)


@contextlib.contextmanager
def timed_slstm_scans():
    """CUDA events around each sLSTM scan over time in the block, forward
    calls (a step's forward, then remat's recompute) and, through hooks on the
    scan's input and output, each backward; yields {"forward": [(start, end)],
    "backward": [(start, end)]}.  A recompute's hooks never fire: its graph
    only refills the saved tensors."""
    import torch

    from repro_torch.models import xlstm

    log = {"forward": [], "backward": []}
    real = xlstm._slstm_scan_local

    def scan(p_r, wx, state, cfg):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        hs, new = real(p_r, wx, state, cfg)
        end.record()
        log["forward"].append((start, end))
        if hs.requires_grad and wx.requires_grad:
            back = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

            def done(grad):  # returns None: the gradient passes unchanged
                back[1].record()
                log["backward"].append(back)

            hs.register_hook(lambda grad: back[0].record())
            wx.register_hook(done)
        return hs, new

    xlstm._slstm_scan_local = scan
    try:
        yield log
    finally:
        xlstm._slstm_scan_local = real


def xlstm_serving_checks(model, tokens):
    """At ``model``'s width and depth, on the prompt ``tokens`` [B, T]: the
    first mLSTM block's chunkwise form against the sequential oracle, and
    CUDA-event times by block kind for a prefill and one decode step; then,
    on the same config in fp32 from the same seed, that prefill and decode
    step against a forward over the prompt plus the token, and a decode from
    fresh states that must miss.  Returns the readings and raises where a
    check fails."""
    import torch

    from repro_torch.models import Model, layers, xlstm

    cfg = model.cfg
    j = cfg.block_pattern.index("mlstm")
    p = model.blocks.layer(0)[f"b{j}"]
    with torch.no_grad():
        x = layers.rmsnorm(p["ln"], layers.embed(model.embed, tokens))
        chunked, _ = xlstm.mlstm_block(p["cell"], x, cfg)
        chunk_err = rel_l2(chunked, xlstm.mlstm_reference(p["cell"], x, cfg))
    del x, chunked
    if chunk_err > XLSTM_CHUNKWISE_TOL:
        raise AssertionError(f"mlstm_chunkwise against mlstm_reference: {chunk_err}")

    B, T = tokens.shape
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=tokens.device,
                        generator=torch.Generator(tokens.device).manual_seed(9))
    with timed_block_kinds() as log:
        _, caches = model.prefill({"tokens": tokens}, T + 1)
    prefill_ms = {kind: (len(ev), event_ms(ev)) for kind, ev in log.items()}
    with timed_block_kinds() as log:
        model.decode_step(caches, tok)
    decode_ms = {kind: (len(ev), event_ms(ev)) for kind, ev in log.items()}
    # Every block of the config timed once in each: a block that Model ran
    # past the timer would drop out of the split unseen.
    plan = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.num_layers)]
    want = {kind: plan.count(kind) for kind in set(plan)}
    for label, got in (("prefill", prefill_ms), ("decode", decode_ms)):
        if {kind: n for kind, (n, _) in got.items()} != want:
            raise AssertionError(f"{label} timed blocks {got}, expected {want}")
    # One more decode step under the profiler: its kernels' device time and,
    # in the same call, its time on the host clock (which the profiler's own
    # work lengthens a little), so the step's idle share.
    host = {}

    def step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.decode_step(caches, tok)
        torch.cuda.synchronize()
        host["ms"] = (time.perf_counter() - t) * 1e3

    trace = device_times(step)
    busy_ms = sum(us for us, _ in trace.values()) / 1e3 if trace else None
    top = sorted(((us / 1e3, n, name[:60]) for name, (us, n) in trace.items()), reverse=True)[:3]
    step_ms = host["ms"]
    del caches

    f32 = Model(cfg.with_overrides(dtype="float32"), device=tokens.device,
                generator=torch.Generator(tokens.device).manual_seed(0))
    logits_p, caches = f32.prefill({"tokens": tokens}, T + 1)
    logits_d, _ = f32.decode_step(caches, tok)
    del caches
    logits_w, _ = f32.decode_step(f32.cache(B, T + 1), tok)
    with torch.no_grad():
        h, _ = f32.forward({"tokens": torch.cat([tokens, tok], dim=1)})
        ref_p, ref_d = f32._logits(h[:, -2:-1]), f32._logits(h[:, -1:])
    del h, f32
    torch.testing.assert_close(logits_p, ref_p, **XLSTM_PREFILL_TOL,
                               msg=lambda m: f"fp32 prefill against the forward: {m}")
    torch.testing.assert_close(logits_d, ref_d, **XLSTM_DECODE_TOL,
                               msg=lambda m: f"fp32 decode against the forward: {m}")
    if torch.allclose(logits_w, ref_d, **XLSTM_DECODE_TOL):
        raise AssertionError("the decode check does not see a forgotten prompt")
    return {"chunkwise": chunk_err, "prefill": rel_l2(logits_p, ref_p),
            "decode": rel_l2(logits_d, ref_d), "fresh decode": rel_l2(logits_w, ref_d),
            "decode max": (logits_d - ref_d).abs().max().item(),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms, "step_ms": step_ms,
            "busy_ms": busy_ms, "top": top}


def mlstm_pairs(T: int, chunk: int) -> int:
    """The (query, key) pairs that the chunkwise form's products inside each
    chunk keep over T steps: a chunk of r real steps keeps r (r + 1) / 2."""
    K = min(chunk, T)
    return sum(r * (r + 1) // 2 for r in (min(K, T - s) for s in range(0, T, K)))


def mlstm_flops(cfg, T: int) -> int:
    """Forward FLOPs (2 per multiply-add) of one mLSTM layer's chunkwise
    products for one row of T tokens, all heads: QK^T and W V over the kept
    pairs inside each chunk, the carried state's read (q C and q n) and its
    update (the weighted k v^T)."""
    H = cfg.num_heads
    dh = int(cfg.xlstm.proj_factor_m * cfg.d_model) // H
    dqk = dh // 2
    return 2 * H * (mlstm_pairs(T, cfg.xlstm.chunk) * (dqk + dh)
                    + T * (2 * dqk * dh + dqk))


def xlstm_step_flops(cfg, n_params: int, rows: int, T: int):
    """Model FLOPs of one xLSTM training step, and the mLSTM products' part:
    6 N per token, plus :func:`mlstm_flops` three times (forward and
    backward) in every mLSTM layer of every row.  Remat's recompute is not
    model work and is not counted."""
    n_mlstm = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "mlstm"
                  for i in range(cfg.num_layers))
    mlstm = 3 * rows * n_mlstm * mlstm_flops(cfg, T)
    return 6 * n_params * rows * T + mlstm, mlstm


def build_peaks(tag: str):
    """A context in which every ``Model`` built on a sharded mesh on the card
    has the card's peak statistics reset before its build and prints the
    rank's peak memory right after it (phases 8-12, 14 and 15)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.sharding.shard import sharded

    real = transformer.Model.__init__

    def init(self, cfg, *args, **kw):
        mesh = kw.get("mesh")
        watched = sharded(mesh) and mesh.device.type == "cuda"
        if watched:
            torch.cuda.reset_peak_memory_stats(mesh.device)
        real(self, cfg, *args, **kw)
        if watched:
            blocks = sum(p.numel() * p.element_size() for p in self.parameters())
            print(f"[{tag}] rank {dict(mesh.coords)}: {cfg.name} built, {blocks / 1e9:.3f} GB "
                  f"of parameter blocks; peak memory from the build's start "
                  f"{torch.cuda.max_memory_allocated(mesh.device) / 1e9:.2f} GB", flush=True)

    @contextlib.contextmanager
    def patched():
        transformer.Model.__init__ = init
        try:
            yield
        finally:
            transformer.Model.__init__ = real

    return patched()


def peaks_rank(tag, fn, *args):
    """``fn(*args)`` on a spawned rank under :func:`build_peaks`."""
    with build_peaks(tag):
        return fn(*args)


def init_need(cfg, mesh_spec):
    """A rank's bytes at the peak of its sharded init on ``mesh_spec`` (shape,
    axes), counted on the meta device: (its parameter blocks, the largest
    whole fp32 draw, that draw's block in its parameter's dtype, which the
    init casts while the draw is alive)."""
    from repro_torch.launch.mesh import meta_mesh
    from repro_torch.models import Model
    from repro_torch.models.transformer import model_specs
    from repro_torch.sharding.shard import named_leaves

    params = dict(Model(cfg, mesh=meta_mesh(*mesh_spec)).named_parameters())
    blocks = sum(p.numel() * p.element_size() for p in params.values())
    n, key = max((math.prod(spec.shape), key) for key, spec in named_leaves(model_specs(cfg))
                 if spec.init not in ("zeros", "ones"))
    return blocks, 4 * n, params[key].numel() * params[key].element_size()


def dry_cell(job):
    """One cell of phase 13 in a worker process: the dry run
    (``launch/dryrun.py``) of one rank's step on the meta device, counted.
    ``job``: ``("measured", name, arch, (seq, rows, kind), microbatches,
    max_len)`` for a one-card cell of an earlier phase, or ``("production",
    arch, shape, multi_pod)``.  Returns the record (``dryrun.run_cell``'s
    layout), its roofline row and the seconds it took."""
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models.transformer import model_specs
    from repro_torch.models import param_count

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if job[0] == "production":
        _, arch, shape, multi_pod = job
        with tempfile.TemporaryDirectory() as tmp:
            rec = dryrun.run_cell(arch, shape, multi_pod, "sync", tmp, skip_existing=False)
        return {"job": job, "rec": rec, "row": roofline.roofline_terms(rec),
                "seconds": time.perf_counter() - t0}
    _, name, arch, (seq, rows, kind), micro, max_len = job
    cfg = get_config(arch)
    shape = ShapeConfig(name, seq, rows, kind)
    cfg, shape, mesh, run, args, counted = dryrun.run_rank(
        arch, shape, False, "sync", max_len=max_len, microbatches=micro, cfg=cfg,
        mesh_shape=((1, 1), ("data", "model")))
    n_params = param_count(model_specs(cfg))
    rec = {"cell": name, "num_devices": 1, "params": n_params,
           "model_flops": dryrun.model_flops_estimate(cfg, shape, n_params),
           "memory_analysis": {"argument_bytes_per_device": args,
                               "peak_estimate_bytes_per_device": args + counted.peak_bytes},
           "parsed": {"flops_per_device": counted.flops, "hbm_bytes_per_device": counted.bytes,
                      "ici_wire_bytes_per_chip": 0.0, "dcn_wire_bytes_per_chip": 0.0},
           "kernel_launches": counted.kernels}
    return {"job": job, "rec": rec, "row": roofline.roofline_terms(rec),
            "seconds": time.perf_counter() - t0}


def start_dry_cells():
    """Phase 13's cells (:func:`dry_cell`) started in worker processes, one
    a cell: CPU work on the meta device that no card phase waits on, so it
    runs beside phases 2-12.  Returns (the pool, its pending result, the
    start time)."""
    import multiprocessing

    jobs = ([("measured", *cell) for cell in DRY_MEASURED]
            + [("production", *cell) for cell in DRY_PRODUCTION])
    pool = multiprocessing.get_context("spawn").Pool(len(jobs))
    pending = pool.map_async(dry_cell, jobs)
    pool.close()
    return pool, pending, time.perf_counter()


def dry_run_phase(measured, smi, started):
    """Phase 13: the dry run on this machine's CPU (see the module's
    docstring), its cells those of :func:`start_dry_cells` (``started``),
    held to ``measured`` (by ``DRY_MEASURED`` name: the measured seconds
    ``s``, what they time, ``peak_gb`` and, where the phase counted them,
    ``model_flops``); raises where a check fails."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch.roofline import format_table
    from repro_torch.models import Model

    t13 = time.perf_counter()
    for arch in ARCHS:
        meta = Model(get_config(arch), device="meta")
        print(f"[dryrun] {arch} built on meta: {sum(p.numel() for p in meta.parameters())} "
              "parameters")
    del meta
    pool, pending, t0 = started
    waited = time.perf_counter()
    cells = pending.get(timeout=900)
    pool.join()
    print(f"[dryrun] the cells ran in {len(cells)} worker processes beside phases 2-12, "
          f"from {t13 - t0:.1f} s before this phase; waited {time.perf_counter() - waited:.1f} "
          "s for them here")
    faults = []
    for cell in cells:
        job, rec, row = cell["job"], cell["rec"], cell["row"]
        if job[0] != "measured":
            continue
        _, name, arch, (seq, rows, kind), _, _ = job
        got = measured[name]
        cfg = get_config(arch)
        est_gb = rec["memory_analysis"]["peak_estimate_bytes_per_device"] / 1e9
        terms = {k: row[f"{k}_s"] for k in ("compute", "memory", "collective")}
        largest = max(terms, key=terms.get)
        if "model_flops" in got:
            own = got["model_flops"]
        else:  # train_step_flops: training's; a forward is a third of it
            params = dict(Model(cfg, device="meta").named_parameters())
            own = train_step_flops(cfg, params, rows, seq)[0] / (3 if kind == "prefill" else 1)
        peak_ratio, flops_ratio = est_gb / got["peak_gb"], rec["model_flops"] / own
        print(f"[dryrun] {name} ({rows} x {seq}, {cell['seconds']:.1f} s on the CPU): peak "
              f"estimate {est_gb:.2f} GB beside the measured max_memory_allocated "
              f"{got['peak_gb']:.2f} GB (ratio {peak_ratio:.3f}, band {DRY_PEAK_BAND}); the "
              f"roofline's largest term {largest} {terms[largest]:.4f} s (compute "
              f"{terms['compute']:.4f}, memory {terms['memory']:.4f}) beside the measured "
              f"{got['time']} {got['s']:.4f}; model_flops_estimate "
              f"{rec['model_flops'] / 1e12:.2f} T beside the script's count {own / 1e12:.2f} T "
              f"(ratio {flops_ratio:.3f}, band {DRY_FLOPS_BAND}); counted "
              f"{rec['parsed']['flops_per_device'] / 1e12:.2f} T FLOPs, "
              f"{rec['parsed']['hbm_bytes_per_device'] / 1e9:.1f} GB unfused, launches "
              f"{rec['kernel_launches']}")
        if got["s"] < terms[largest]:
            faults.append(f"{name}: measured {got['s']} s under the roofline's {terms[largest]}")
        if not DRY_PEAK_BAND[0] <= peak_ratio <= DRY_PEAK_BAND[1]:
            faults.append(f"{name}: peak estimate / measured {peak_ratio} off {DRY_PEAK_BAND}")
        if not DRY_FLOPS_BAND[0] <= flops_ratio <= DRY_FLOPS_BAND[1]:
            faults.append(f"{name}: model FLOPs ratio {flops_ratio} off {DRY_FLOPS_BAND}")
    production = [c for c in cells if c["job"][0] == "production"]
    print("[dryrun] production cells, estimates on the H100 data sheet's constants:\n"
          + format_table([c["row"] for c in production]))
    for c in production:
        rec, mem = c["rec"], c["rec"]["memory_analysis"]
        print(f"[dryrun] {rec['cell']} ({c['seconds']:.1f} s on the CPU): "
              f"{rec['parsed']['flops_per_device'] / 1e12:.2f} T FLOPs a rank, "
              f"{rec['parsed']['hbm_bytes_per_device'] / 1e9:.1f} GB unfused, wire bytes "
              f"{rec['collectives']}, state {mem['argument_bytes_per_device'] / 1e9:.2f} GB, "
              f"peak estimate {mem['peak_estimate_bytes_per_device'] / 1e9:.2f} GB")
    took = time.perf_counter() - t13
    print(f"[dryrun] phase 13 took {took:.1f} s (budget {DRY_BUDGET_S} s"
          + (", over it" if took > DRY_BUDGET_S else "") + f"); {smi}")
    if faults:
        raise AssertionError("phase 13: " + "; ".join(faults))



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import build, ops, ref, work
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import rglru_scan as scan_mod
    from repro_torch.kernels.flash_attention import (MAX_FUSED_BWD_DIM, flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import BatchAdmission, serve
    from repro_torch.launch.steps import build_encode_step
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import to_device, train
    from repro_torch.models import MLSTMState, Model, SLSTMState, input_specs, layer_plan
    from repro_torch.models.attention import KVCache, MLACache

    started = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------- 1. build --
    t0 = time.perf_counter()
    built = build.build()
    print(f"[build] {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    no_spill = set()
    for name in build.sources():
        for use in build.ptxas_usage(build.log_path(name).read_text()):
            kernel = use["kernel"]
            print(f"[build] {name}.cu {kernel}: {use['registers']} registers at launch, "
                  f"static shared memory {use['static_smem']} B (dynamic: requested at "
                  f"launch), spill stores {use['spill_stores']} B, "
                  f"spill loads {use['spill_loads']} B")
            if kernel.startswith(("flash_fwd_wgmma<", "flash_bwd_wgmma", "rglru_scan_tma",
                                  "rglru_scan_bwd_tma")):
                no_spill.add(kernel)
                if use["spill_stores"] or use["spill_loads"]:
                    raise AssertionError(f"{kernel} spills registers: {use}")
    wanted = ({f"flash_fwd_wgmma<{d}>" for d in (64, 128, 256)}
              | {f"flash_bwd_wgmma<{d}>" for d in (64, 128)}
              | {"flash_bwd_wgmma_dkdv<256>", "flash_bwd_wgmma_dq<256>"}
              | {"rglru_scan_tma", "rglru_scan_bwd_tma"})
    if no_spill != wanted:
        raise AssertionError(f"nvcc's log shows {sorted(no_spill)}, expected {sorted(wanted)}")
    dry_cells = start_dry_cells()  # phase 13's CPU work, beside the card's phases

    # --------------------------------------------------------- 2. kernels --
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def time_ms(fn, iters, warmup=3):
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def bound(flops, peak_flops, nbytes):
        t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    def flash_inputs(B, T, H, K, dk, dv, dtype, Tk=None, offset=0):
        """q, k, v; with ``offset``, each in storage that starts that many
        elements into its buffer."""
        dt, Tk = getattr(torch, dtype), Tk or T
        out = []
        for shape in ((B, T, H, dk), (B, Tk, K, dk), (B, Tk, K, dv)):
            x = randn(*shape).to(dt)
            if offset:
                buf = torch.empty(x.numel() + offset, dtype=dt, device=dev)
                x = buf[offset:].view(shape).copy_(x)
            out.append(x)
        return out

    def flash_run(case, q, k, v):
        """The kernel's output, its plain version's, and the variant launched."""
        causal, window = case[6:8]
        before = dict(flash_attention_fwd.launches_by_variant)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        kind, = (n for n, c in flash_attention_fwd.launches_by_variant.items()
                 if c != before[n])
        expect = plain_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        return out, expect, kind

    def flash_check(case, out, expect, kind):
        """Max abs error and, for bf16, the largest share of the per-element
        bound; raises on a disagreement, a NaN, or bf16 off wgmma."""
        dtype = case[-1]
        o, e = out.float(), expect.float()
        diff = (o - e).abs()
        err, share = diff.max().item(), 0.0
        if dtype == "bfloat16":
            limit = BF16_RTOL * e.abs() + BF16_ROW * e.pow(2).mean(-1, keepdim=True).sqrt()
            share = (diff / limit).max().item()
        if not (err <= TOL[dtype] and share <= 1.0) or bool(torch.isnan(out).any()):
            raise AssertionError(f"flash_attention ({kind}) disagrees with its plain version "
                                 f"on {case}: max_abs_err {err}, share of the bf16 bound "
                                 f"{share}")
        if dtype == "bfloat16" and kind != "wgmma":
            raise AssertionError(f"bf16 case {case} ran the {kind} variant, not wgmma")
        return err, share

    for case in FLASH_CASES:
        B, T, H, K, dk, dv, causal, window, dtype = case
        q, k, v = flash_inputs(B, T, H, K, dk, dv, dtype)
        out, expect, kind = flash_run(case, q, k, v)
        err, share = flash_check(case, out, expect, kind)
        print(f"[kernel] flash_attention {case} {kind}: max_abs_err {err:.3e} (tol {TOL[dtype]})"
              + (f", {share:.3f} of the per-element bound" if dtype == "bfloat16" else ""))

    def sdpa_yardstick(q, k, v, causal, window, keep, grad=False):
        """SDPA's inputs ([B, heads, T, d] copies of q, k, v), keyword
        arguments (a window as a boolean mask; ``enable_gqa`` where H != K),
        and the backends to pin with their note (:func:`sdpa_backends`)."""
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kw = dict(attn_mask=keep.to(dev)) if window else dict(is_causal=causal)
        if q.shape[2] != k.shape[2]:
            kw["enable_gqa"] = True
        backends, note = sdpa_backends(qt, kt, vt, grad=grad, **kw)
        return (qt, kt, vt), kw, backends, note

    def padded_dim(dk, dv):
        """The D of the wgmma kernels that take dk and dv (64, 128 or 256):
        the TMA zero-fills the columns past dk and dv to D, so every product
        they run is D wide."""
        return next(d for d in (64, 128, 256) if max(dk, dv) <= d)

    records = {}  # kernel entries of the JSON line, keyed by the path they serve
    for arch, case in FLASH_SLICES.items():
        B, T, H, K, dk, dv, causal, window, dtype = case
        q, k, v = flash_inputs(B, T, H, K, dk, dv, dtype)
        out, expect, kind = flash_run(case, q, k, v)
        err, share = flash_check(case, out, expect, kind)
        del expect
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal, window=window), 20)
        plain_ms = time_ms(lambda: plain_fwd(q, k, v, causal=causal, window=window), 3)
        # Work this run's inputs need (kernels/work.py): unmasked (q, k)
        # pairs, 2 FLOP per multiply-add in QK^T (dk) and PV (dv); each of
        # q, k, v, o moved once.
        keep = attn_pairs(T, causal, window)
        pairs = B * H * work.attn_pairs(T, T, causal, window)
        flops, nbytes = work.flash_fwd_work(q, k, v, causal, window)
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
        D = padded_dim(dk, dv)
        padded_ms, _ = bound(2 * 2 * D * pairs, PEAK_BF16_FLOPS, nbytes)
        # Yardstick: SDPA on the same q, k, v, its backends pinned.
        (qt, kt, vt), kw, backends, note = sdpa_yardstick(q, k, v, causal, window, keep)
        with sdpa_kernel(backends):
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw), 20)
            backend, top = sdpa_backend(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw))
        padded = (f"; the work flash_fwd_wgmma<{D}> runs, dk {dk} and dv {dv} zero-filled to "
                  f"{D}, bounds it at {padded_ms:.4f} ms "
                  f"(the needed work is {100 * bound_ms / padded_ms:.1f} % of it)"
                  if padded_ms > bound_ms else "")
        print(f"[kernel] flash_attention {case} {kind} ({arch} prefill): max_abs_err {err:.3e}, "
              f"{share:.3f} of the per-element bound; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms ({note}; "
              f"ran {backend}: {top}), bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB){padded}; {smi}")
        records[("flash_attention", arch)] = {
            "name": "flash_attention",
            "variant": kind,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:128",
            "shape": list(case),
            "launches": None,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "library_backend": backend,
            "library_note": note,
            **({"padded_bound_ms": padded_ms} if padded_ms > bound_ms else {}),
        }
        del q, k, v, qt, kt, vt, out, kw
        torch.cuda.empty_cache()

    def grad_refs(case, q, k, v, out, lse, g):
        """The plain backward on the kernel's output and lse, and the
        oracle's autograd, both in fp32 on fp32 upcasts of the inputs."""
        causal, window = case[6:8]
        qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, g))
        plain, oracle = [], []
        for hq, hk in head_slices(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2]):
            plain.append(ref.flash_attention_bwd_ref(
                qf[:, :, hq], kf[:, :, hk], vf[:, :, hk], of[:, :, hq], lse[:, hq], gf[:, :, hq],
                causal=causal, window=window))
            leaves = [x.clone().requires_grad_() for x in (qf[:, :, hq], kf[:, :, hk],
                                                           vf[:, :, hk])]
            oracle.append(torch.autograd.grad(
                ref.flash_attention_ref(*leaves, causal=causal, window=window), leaves,
                gf[:, :, hq]))
            del leaves
        if len(plain) == 1:
            return plain[0], oracle[0]
        return tuple(tuple(torch.cat(x, dim=2) for x in zip(*parts)) for parts in (plain, oracle))

    def bwd_want(case):
        """The backward variant a case must launch: ``wgmma`` for bf16 that
        the TMA can load (dk and dv multiples of 8, 16-byte aligned storage),
        ``simt`` otherwise."""
        dk, dv, dtype, offset = *case[4:6], case[8], (case[10:] or (0,))[0]
        tma = dtype == "bfloat16" and dk % 8 == 0 and dv % 8 == 0 and offset % 8 == 0
        return "wgmma" if tma else "simt"

    def grad_check(case, kind, got, plain, oracle):
        """Largest |g - oracle| over dq, dk, dv and, for bf16, the largest
        share of the per-element bound against the plain backward and the
        largest relative L2 error against the oracle; raises on a
        disagreement, a NaN or the wrong variant."""
        dtype, want = case[8], bwd_want(case)
        err, share, l2 = 0.0, 0.0, 0.0
        for g, w, o in zip(got, plain, oracle):
            g = g.float()
            err = max(err, (g - o).abs().max().item())
            if dtype == "bfloat16":
                limit = (GRAD_RTOL * w.abs() + GRAD_ROW * w.pow(2).mean(-1, keepdim=True).sqrt()
                         + GRAD_FLOOR * w.pow(2).mean().sqrt())
                share = max(share, ((g - w).abs() / limit).max().item())
                l2 = max(l2, ((g - o).norm() / o.norm()).item())
            elif (g - w).abs().max().item() > GRAD_FP32_TOL:
                err = math.inf
        nan = any(bool(torch.isnan(x).any()) for x in got)
        ok = (share <= 1.0 and l2 <= GRAD_ORACLE_L2 if dtype == "bfloat16"
              else err <= GRAD_FP32_TOL)
        if not ok or nan or kind != want:
            raise AssertionError(f"flash_attention backward ({kind}, expected {want}) on {case}: "
                                 f"max_abs_err vs the oracle {err}, share of the bf16 bound "
                                 f"{share}, relative L2 vs the oracle {l2}, NaN {nan}")
        return err, share, l2

    def bwd_note(dtype, err, share, l2):
        if dtype == "bfloat16":
            return (f"dq/dk/dv max_abs_err vs the fp32 oracle {err:.3e}, relative L2 {l2:.3e} "
                    f"(limit {GRAD_ORACLE_L2}), {share:.3f} of the per-element bound vs the "
                    f"plain backward")
        return f"dq/dk/dv max_abs_err vs the oracle {err:.3e} (tol {GRAD_FP32_TOL})"

    def bwd_split(kind, q, k, v, out, lse, g, causal, window, calls=10):
        """Device ms of each launch of one flash_attention_bwd call on the
        ``kind`` key of BWD_LAUNCHES, the mean of torch.profiler's kernel
        times over ``calls`` calls."""
        launches = BWD_LAUNCHES[kind]
        trace = device_times(lambda: [flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                                          window=window) for _ in range(calls)])
        us, count = dict.fromkeys(launches, 0.0), dict.fromkeys(launches, 0)
        for name, (t, n) in trace.items():
            for part, key in launches.items():
                if key in name:
                    us[part] += t
                    count[part] += n
        # The trace may miss a launch at its edges; more than one per call is
        # a fault.
        if not all(0 < count[n] <= calls and us[n] > 0 for n in launches):
            raise AssertionError(f"launches {count} and device us {us} in {calls} calls")
        return {n: us[n] / count[n] / 1e3 for n in launches}

    def attention_at_train_shape(case, label):
        """Flash attention's forward and backward at a training shape, each
        checked against its plain version and timed beside it, its bound and
        SDPA (the window as a boolean mask; the backward under autograd),
        with the SDPA backend that ran; the backward's time split by launch.
        Returns the two JSON records, ``launches`` still None."""
        B, T, H, K, dk, dv, causal, window, dtype = case
        q, k, v = flash_inputs(B, T, H, K, dk, dv, dtype)
        out, expect, kind = flash_run(case, q, k, v)
        err, share = flash_check(case, out, expect, kind)
        del expect
        mask = dict(causal=causal, window=window)
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, **mask), 20)
        plain_ms = time_ms(lambda: plain_fwd(q, k, v, **mask), 3)
        keep = attn_pairs(T, causal, window)
        # Yardstick: SDPA on the same q, k, v, its backends pinned for the
        # forward and the backward; a window goes in as a mask.
        (qt, kt, vt), sdpa_kw, backends, sdpa_note = sdpa_yardstick(q, k, v, causal, window,
                                                                   keep, grad=True)
        with sdpa_kernel(backends):
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw), 20)
            fwd_backend, fwd_top = sdpa_backend(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **sdpa_kw))
        pairs = B * H * work.attn_pairs(T, T, causal, window)  # unmasked (query, key) pairs
        flops, nbytes = work.flash_fwd_work(q, k, v, causal, window)
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
        D = padded_dim(dk, dv)
        padded_ms, _ = bound(2 * 2 * D * pairs, PEAK_BF16_FLOPS, nbytes)
        padded = (f"; the work flash_fwd_wgmma<{D}> runs, dk {dk} and dv {dv} zero-filled to "
                  f"{D}, bounds it at {padded_ms:.4f} ms" if padded_ms > bound_ms else "")
        print(f"[kernel] flash_attention {case} {kind} ({label}): max_abs_err {err:.3e}"
              + (f", {share:.3f} of the per-element bound" if dtype == "bfloat16" else "")
              + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
              f"({sdpa_note}; ran {fwd_backend}: {fwd_top}), bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e9:.2f} GFLOP, "
              f"{pairs} pairs){padded}; {smi}")
        fwd = {"name": "flash_attention", "variant": kind, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:128",
               "shape": list(case), "launches": None, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "library_note": sdpa_note,
               "library_backend": fwd_backend,
               **({"padded_bound_ms": padded_ms} if padded_ms > bound_ms else {})}

        # The backward: checked against its plain version and the oracle,
        # then timed beside the oracle's autograd (its forward recomputed, as
        # a backward through the oracle does it), its bound and SDPA's.
        g = randn(*out.shape).to(out.dtype)
        out, lse = flash_attention_fwd(q, k, v, lse=True, **mask)
        before = dict(flash_attention_bwd.launches_by_variant)
        got = flash_attention_bwd(q, k, v, out, lse, g, **mask)
        bwd_kind, = (n for n, c in flash_attention_bwd.launches_by_variant.items()
                     if c != before[n])
        plain, oracle = grad_refs(case, q, k, v, out, lse, g)
        torch.cuda.synchronize()
        bwd_err, bwd_share, bwd_l2 = grad_check(case, bwd_kind, got, plain, oracle)
        del plain, oracle
        split_kind = ("wgmma d 256" if bwd_kind == "wgmma" and max(dk, dv) > MAX_FUSED_BWD_DIM
                      else bwd_kind)
        # The d-256 kernels use no atomics: a second call must repeat the first
        # bit for bit.
        repeat_note = ""
        if split_kind == "wgmma d 256":
            again = flash_attention_bwd(q, k, v, out, lse, g, **mask)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd on {case} does not repeat bit for bit")
            repeat_note = "; a second call repeats it bit for bit"
            del again
        del got
        torch.cuda.empty_cache()
        bwd_ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, g, **mask), 20)
        split = bwd_split(split_kind, q, k, v, out, lse, g, **mask)
        # Past head dim 128: the time at every head-group count the launch
        # could choose (a divisor of H/K), beside bwd_groups' choice.
        groups_rec = {}
        if split_kind == "wgmma d 256":
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            chosen = flash_mod.bwd_groups(B, K, T, H // K, sms)
            choose, by_groups = flash_mod.bwd_groups, {}
            try:
                for n in (n for n in range(1, H // K + 1) if (H // K) % n == 0):
                    flash_mod.bwd_groups = lambda *_, n=n: n
                    by_groups[n] = time_ms(
                        lambda: flash_attention_bwd(q, k, v, out, lse, g, **mask), 20)
            finally:
                flash_mod.bwd_groups = choose
            print(f"[kernel] flash_attention_bwd {case} ({label}) ms per call by head groups "
                  f"(blocks = {B * K * -(-T // 64)} key tiles x groups on {sms} SMs): "
                  + ", ".join(f"{n} {t:.4f}" for n, t in by_groups.items())
                  + f"; bwd_groups chooses {chosen}")
            groups_rec = {"head_groups": chosen,
                          "ms_by_head_groups": {str(n): t for n, t in by_groups.items()}}
        bwd_plain_ms = time_ms(plain_bwd_oracle(q, k, v, g, **mask), 3)
        qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
        gt = g.transpose(1, 2).contiguous()
        with sdpa_kernel(backends):
            o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
            bwd_library_ms = time_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), gt,
                                                                 retain_graph=True), 20)
            backend, top = sdpa_backend(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw), (qt, kt, vt), gt))
        del o_sdpa, gt
        # Five products per unmasked pair (S, dP, dV, dK, dQ: 2 FLOP per
        # multiply-add over 3 dk + 2 dv); q, k, v, out, dout, lse read once
        # and dq, dk, dv written once (kernels/work.py).
        bwd_flops, bwd_bytes = work.flash_bwd_work(q, k, v, causal, window)
        bwd_bound_ms, bwd_bound_by = bound(bwd_flops, PEAK_BF16_FLOPS, bwd_bytes)
        main_ms = sum(split[n] for n in BWD_MAIN[split_kind])
        # Past head dim 128 the dq kernel recomputes S and dP: seven products
        # per unmasked pair (4 dk + 3 dv).
        design_note, design = "", {}
        if split_kind == "wgmma d 256":
            flops7 = 2 * (4 * dk + 3 * dv) * pairs
            bound7_ms, _ = bound(flops7, PEAK_BF16_FLOPS, bwd_bytes)
            design_note = (f"; the split design's seven products {flops7 / 1e9:.2f} GFLOP, bound "
                           f"{bound7_ms:.4f} ms, of which the main kernels reach "
                           f"{100 * bound7_ms / main_ms:.1f} %")
            design = {"bound_7_products_ms": bound7_ms}
            if D * 7 * 2 * pairs > flops7:  # dk, dv zero-filled to D in every product
                bound7_padded_ms, _ = bound(2 * 7 * D * pairs, PEAK_BF16_FLOPS, bwd_bytes)
                design_note += (f"; the seven products as the kernels run them, dk {dk} and dv "
                                f"{dv} zero-filled to {D}, bound {bound7_padded_ms:.4f} ms")
                design["bound_7_products_padded_ms"] = bound7_padded_ms
        elif split_kind == "wgmma" and D > max(dk, dv):  # the TMA zero-fills dk, dv to D
            bwd_padded_ms, _ = bound(2 * 5 * D * pairs, PEAK_BF16_FLOPS, bwd_bytes)
            design_note = (f"; the five products as flash_bwd_wgmma<{D}> runs them, dk {dk} and "
                           f"dv {dv} zero-filled to {D}, bound {bwd_padded_ms:.4f} ms, of which "
                           f"the main kernel reaches {100 * bwd_padded_ms / main_ms:.1f} %")
            design = {"padded_bound_ms": bwd_padded_ms}
        print(f"[kernel] flash_attention_bwd {case} {bwd_kind} ({label}): "
              + bwd_note(dtype, bwd_err, bwd_share, bwd_l2) + repeat_note
              + f"; kernel {bwd_ms:.4f} ms, plain (the oracle's autograd, forward recomputed) "
              f"{bwd_plain_ms:.4f} ms, sdpa backward {bwd_library_ms:.4f} ms (forward and "
              f"backward on SDPA's {backend} backend, {sdpa_note}: {top}), bound "
              f"{bwd_bound_ms:.4f} ms ({bwd_bound_by}: {bwd_flops / 1e9:.2f} GFLOP, "
              f"{bwd_bytes / 1e6:.1f} MB); {smi}")
        print(f"[kernel] flash_attention_bwd {case} ({label}) device ms per call by launch: "
              + ", ".join(f"{n} {t:.4f}" for n, t in split.items())
              + f" (sum {sum(split.values()):.4f}); the main kernel"
              f"{'s' if len(BWD_MAIN[split_kind]) > 1 else ''} reach "
              f"{100 * bwd_bound_ms / main_ms:.1f} % of the bound, the call "
              f"{100 * bwd_bound_ms / bwd_ms:.1f} %" + design_note)
        bwd = {"name": "flash_attention_bwd", "variant": bwd_kind, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:128",
               "replaces_note": "the backward of its custom_vjp (src/repro/kernels/ops.py:30-60), "
                                "the oracle's vjp",
               "shape": list(case), "launches": None, "max_abs_err": bwd_err, "ms": bwd_ms,
               "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
               "library_ms": bwd_library_ms, "library_backend": backend,
               "library_note": sdpa_note, "split_ms": split, **design, **groups_rec}
        del q, k, v, qt, kt, vt, out, lse, g
        torch.cuda.empty_cache()
        return fwd, bwd

    # The backward against its plain version and the oracle's autograd.
    for case in BWD_CASES:
        B, T, H, K, dk, dv, causal, window, dtype, *tk = case
        q, k, v = flash_inputs(B, T, H, K, dk, dv, dtype, *tk)
        g = randn(B, T, H, dv).to(q.dtype)
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, lse=True)
        _, lse_plain = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
        before = dict(flash_attention_bwd.launches_by_variant)
        got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
        kind, = (n for n, c in flash_attention_bwd.launches_by_variant.items() if c != before[n])
        plain, oracle = grad_refs(case, q, k, v, out, lse, g)
        torch.cuda.synchronize()
        lse_err = (lse - lse_plain).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash_attention lse on {case}: max_abs_err {lse_err}")
        err, share, l2 = grad_check(case, kind, got, plain, oracle)
        print(f"[kernel] flash_attention_bwd {case} {kind}: lse max_abs_err {lse_err:.3e} "
              f"(tol {LSE_TOL}); " + bwd_note(dtype, err, share, l2))
        del q, k, v, g, out, lse, got, plain, oracle

    # llama3-8b's training shape (d 128): no main path runs it yet; its
    # records take their wrappers' launches on the training path (phase 6).
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_D128, "llama3-8b training shape")
    for rec in (fwd_rec, bwd_rec):
        rec["launches_note"] = ("the wrapper's launches on llama3.2-1b's training path "
                                "(d 64); no main path runs d 128 yet")
    records[("flash_attention", "llama3-8b train")] = fwd_rec
    records[("flash_attention_bwd", "llama3-8b train")] = bwd_rec
    # recurrentgemma-9b's training shape (d 256, MQA, window 2048); its records
    # take phase 6(d)'s launches.
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_RG_ATTN,
                                                "recurrentgemma-9b training microbatch")
    records[("flash_attention", "recurrentgemma-9b train")] = fwd_rec
    records[("flash_attention_bwd", "recurrentgemma-9b train")] = bwd_rec
    # deepseek-v2-236b's MLA in phase 6(g)'s microbatch; its records take
    # phase 6(g)'s launches.
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_MLA, "deepseek-v2-236b training microbatch")
    records[("flash_attention", "deepseek-v2-236b train")] = fwd_rec
    records[("flash_attention_bwd", "deepseek-v2-236b train")] = bwd_rec
    # internvl2-76b's training microbatch (d 128, 64 heads over 8); its records
    # take phase 6(h)'s launches.
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_INTERNVL2_ATTN,
                                                "internvl2-76b training microbatch")
    records[("flash_attention", "internvl2-76b train")] = fwd_rec
    records[("flash_attention_bwd", "internvl2-76b train")] = bwd_rec
    # hubert-xlarge's training microbatch (d 80, no causal mask); its records
    # take phase 6(f)'s launches.
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_HUBERT_ATTN,
                                                "hubert-xlarge training microbatch")
    records[("flash_attention", "hubert-xlarge train")] = fwd_rec
    records[("flash_attention_bwd", "hubert-xlarge train")] = bwd_rec
    # llama3.2-1b's attention on a rank of data 2 x model 2; its records
    # take phase 8(b)'s launches of one rank.
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_TP_ATTN,
                                                "llama3.2-1b rank of data 2 x model 2")
    records[("flash_attention", "llama3.2-1b model 2 train")] = fwd_rec
    records[("flash_attention_bwd", "llama3.2-1b model 2 train")] = bwd_rec
    # deepseek-v2-236b's MLA on a rank of model 2; its records take phase
    # 9(b)'s launches of one rank.
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_EP_ATTN,
                                                "deepseek-v2-236b rank of model 2")
    records[("flash_attention", "deepseek-v2-236b model 2 train")] = fwd_rec
    records[("flash_attention_bwd", "deepseek-v2-236b model 2 train")] = bwd_rec
    # recurrentgemma-9b's attention on a rank of model 2; its records take
    # phase 10(a)'s launches of one rank.
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_TPR_ATTN,
                                                "recurrentgemma-9b rank of model 2")
    records[("flash_attention", "recurrentgemma-9b model 2 train")] = fwd_rec
    records[("flash_attention_bwd", "recurrentgemma-9b model 2 train")] = bwd_rec

    def scan_inputs(B, T, W, offset=0):
        """a, b, h0; a and b ``offset`` elements past their storage's start."""
        a = torch.sigmoid(randn(B, T, W)) * 0.6 + 0.3
        return off_storage(a, offset), off_storage(randn(B, T, W) * 0.1, offset), randn(B, W) * 0.1

    def off_storage(x, offset):
        if not offset:
            return x
        return torch.empty(x.numel() + offset, device=dev)[offset:].view(x.shape).copy_(x)

    def scan_want(W, offset):
        """The variant the wrapper must launch: the TMA addresses rows of a
        multiple of 16 bytes from 16-byte aligned storage."""
        return "tma" if W % 4 == 0 and offset % 4 == 0 else "lane"

    def launched(fn, kind, call):
        """call() once; it must launch ``fn``'s kernel once, on ``kind``."""
        before = dict(fn.launches_by_variant)
        out = call()
        if fn.launches_by_variant != {**before, kind: before[kind] + 1}:
            raise AssertionError(f"{fn.__name__} launched {fn.launches_by_variant} after "
                                 f"{before}, expected one {kind} launch")
        return out

    @contextlib.contextmanager
    def scan_forced(kind):
        """The scan wrappers with their variant fixed, for timing the one the
        rule does not choose."""
        saved, scan_mod.variant = scan_mod.variant, lambda *_: kind
        try:
            yield
        finally:
            scan_mod.variant = saved

    def scan_err(a, b, h0, kind):
        out = launched(rglru_scan_fwd, kind, lambda: rglru_scan_fwd(a, b, h0))
        expect = ref.rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        err = (out - expect).abs().max().item()
        if not torch.allclose(out, expect, atol=RGLRU_TOL, rtol=RGLRU_TOL):
            raise AssertionError(f"rglru_scan disagrees with its plain version at "
                                 f"{tuple(a.shape)}: max_abs_err {err}")
        return err

    def scan_bwd_err(a, h, h0, g, kind):
        """Largest |kernel - plain| over da, db and dh0; raises beyond RGLRU_TOL."""
        got = launched(rglru_scan_bwd, kind, lambda: rglru_scan_bwd(a, h, h0, g))
        want = ref.rglru_scan_bwd_ref(a, h, h0, g)
        torch.cuda.synchronize()
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        if not all(torch.allclose(x, y, atol=RGLRU_TOL, rtol=RGLRU_TOL)
                   for x, y in zip(got, want)):
            raise AssertionError(f"rglru_scan_bwd disagrees with its plain version at "
                                 f"{tuple(a.shape)}: max_abs_err {err}")
        return err

    for B, T, W, offset in RGLRU_CASES:
        kind = scan_want(W, offset)
        err = scan_err(*scan_inputs(B, T, W, offset), kind)
        print(f"[kernel] rglru_scan {(B, T, W)} (offset {offset}): {kind}, max_abs_err "
              f"{err:.3e} (tol {RGLRU_TOL})")
    for B, T, W, offset, scale in RGLRU_BWD_CASES:
        kind = scan_want(W, offset)
        a, b, h0 = scan_inputs(B, T, W, offset)
        h0 = h0 * scale
        h = off_storage(rglru_scan_fwd(a, b, h0), offset)
        err = scan_bwd_err(a, h, h0, off_storage(randn(B, T, W), offset), kind)
        print(f"[kernel] rglru_scan_bwd {(B, T, W)} (offset {offset}, h0 x {scale:g}): {kind}, "
              f"da/db/dh0 max_abs_err {err:.3e} (atol and rtol {RGLRU_TOL})")

    def scan_record(name, shape, err, ms, plain_ms, bound_ms, bound_by, **extra):
        return {"name": name, "variant": "tma", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
                "replaces": "src/repro/kernels/rglru_scan.py:78", "shape": list(shape),
                "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "library_note": "no single PyTorch call computes the recurrence", **extra}

    # The tma ring as the kernel source configures it (quoted from the .cu):
    # a configured capacity, not a reading of what the card holds in flight.
    scan_src = (build.CSRC / "rglru_scan.cu").read_text()
    ring_cfg = {k: int(re.search(rf"constexpr int {k} = (\d+);", scan_src)[1])
                for k in ("LANES", "ROWS", "FWD_STAGES", "BWD_STAGES")}

    def ring_text(B, W, inputs, stages):
        blocks, lanes, rows = B * -(-W // ring_cfg["LANES"]), ring_cfg["LANES"], ring_cfg["ROWS"]
        block_bytes = stages * inputs * rows * lanes * 4
        per_sm = -(-blocks // sms)
        return (f"ring capacity (configured): {blocks} blocks of {lanes} lanes, {stages} stages "
                f"of {rows} steps = {block_bytes / 1024:.0f} KB a block, {per_sm} blocks = "
                f"{per_sm * block_bytes / 1024:.0f} KB per SM with the blocks spread evenly")

    # Timed: the forward at the prefill and the training shape, the backward
    # at both, each on the tma variant the rule chooses and on the lane variant
    # (the earlier kernels).
    # The forward moves a, b in and h out, one fma per element; the backward
    # g, a, h in and da, db out, an add and two multiplies per element; both
    # read h0 (and the backward writes dh0) once (fp32; kernels/work.py).  The backward's plain
    # time is the oracle's autograd with its forward, as the parent tree ran
    # it; the plain reverse loop is timed beside it.  tma's h must equal
    # lane's, and a second call's, bit for bit.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scan_times = {}
    for shape in (RGLRU_SLICE, RGLRU_TRAIN, RGLRU_TP_SLICE, RGLRU_TP_TRAIN):
        B, T, W = shape
        a, b, h0 = scan_inputs(*shape)
        g = randn(*shape)
        err = scan_err(a, b, h0, "tma")
        h = rglru_scan_fwd(a, b, h0)
        bwd_err = scan_bwd_err(a, h, h0, g, "tma")
        got = rglru_scan_bwd(a, h, h0, g)
        with scan_forced("lane"):
            h_lane = launched(rglru_scan_fwd, "lane", lambda: rglru_scan_fwd(a, b, h0))
            got_lane = launched(rglru_scan_bwd, "lane", lambda: rglru_scan_bwd(a, h, h0, g))
        same = {"forward repeats": torch.equal(h, rglru_scan_fwd(a, b, h0)),
                "forward equals lane": torch.equal(h, h_lane),
                "backward repeats": all(map(torch.equal, got, rglru_scan_bwd(a, h, h0, g)))}
        bwd_vs_lane = max((x - y).abs().max().item() for x, y in zip(got, got_lane))
        print(f"[kernel] rglru_scan {shape}: tma against lane and a second call: "
              + ", ".join(f"{k} {v}" for k, v in same.items())
              + f"; backward tma - lane max_abs {bwd_vs_lane:.3e}")
        if not all(same.values()):
            raise AssertionError(f"rglru_scan at {shape} is not bit for bit: {same}")
        del h_lane, got, got_lane
        fwd = dict(ms=time_ms(lambda: rglru_scan_fwd(a, b, h0), 50),
                   plain_ms=time_ms(lambda: ref.rglru_scan_ref(a, b, h0), 1, warmup=1))
        fwd_flops, fwd_bytes = work.scan_fwd_work(a, h0)
        fwd.update(zip(("bound_ms", "bound_by"), bound(fwd_flops, PEAK_FP32_FLOPS, fwd_bytes)))
        leaves = [x.detach().requires_grad_() for x in (a, b, h0)]
        # A rank's prefill scan (phase 10) has no backward: its plain
        # versions, seconds at this shape, are not timed.
        timed_bwd = shape != RGLRU_TP_SLICE
        bwd = dict(ms=time_ms(lambda: rglru_scan_bwd(a, h, h0, g), 50),
                   plain_ms=time_ms(lambda: torch.autograd.grad(
                       ref.rglru_scan_ref(*leaves), leaves, g), 1, warmup=1),
                   plain_loop_ms=time_ms(lambda: ref.rglru_scan_bwd_ref(a, h, h0, g), 1,
                                         warmup=1)) if timed_bwd else {}
        bwd_flops, bwd_bytes = work.scan_bwd_work(a, h0)
        bwd.update(zip(("bound_ms", "bound_by"), bound(bwd_flops, PEAK_FP32_FLOPS, bwd_bytes)))
        with scan_forced("lane"):
            fwd["earlier_ms"] = time_ms(lambda: rglru_scan_fwd(a, b, h0), 50)
            if timed_bwd:
                bwd["earlier_ms"] = time_ms(lambda: rglru_scan_bwd(a, h, h0, g), 50)
        # What streaming the forward's bytes takes on this card: PyTorch's
        # elementwise a + b reads and writes the same 12 bytes per element.
        out = torch.empty_like(a)
        fwd["stream_ms"] = time_ms(lambda: torch.add(a, b, out=out), 50)
        del out
        fwd["earlier_variant"] = "lane: one thread per lane, loads 16 steps ahead in registers"
        bwd["earlier_variant"] = ("lane: one warp per block, loads 32 steps ahead in registers; "
                                  "it now rounds each product and sum on its own (__fmul_rn, "
                                  "__fadd_rn), so its time is not that of the lane kernel "
                                  "before that change")
        rings = {"rglru_scan": ring_text(B, W, 2, ring_cfg["FWD_STAGES"]),
                 "rglru_scan_bwd": ring_text(B, W, 3, ring_cfg["BWD_STAGES"])}
        scan_times[shape] = (err, fwd, bwd_err, bwd)
        for name, rec, e, nbytes in (("rglru_scan", fwd, err, fwd_bytes),
                                     ("rglru_scan_bwd", bwd, bwd_err, bwd_bytes))[:1 + timed_bwd]:
            plain = (f"plain (the oracle's autograd, forward recomputed) {rec['plain_ms']:.4f} ms, "
                     f"plain reverse loop {rec['plain_loop_ms']:.4f} ms"
                     if name == "rglru_scan_bwd" else f"plain {rec['plain_ms']:.4f} ms")
            stream = (f" (an elementwise a + b over the same bytes: {rec['stream_ms']:.4f} ms, "
                      f"{100 * rec['bound_ms'] / rec['stream_ms']:.1f} % of the bound)"
                      if "stream_ms" in rec else "")
            print(f"[kernel] {name} {shape}: max_abs_err {e:.3e}; tma {rec['ms']:.4f} ms "
                  f"({100 * rec['bound_ms'] / rec['ms']:.1f} % of the bound{stream}), lane "
                  f"{rec['earlier_ms']:.4f} ms ({100 * rec['bound_ms'] / rec['earlier_ms']:.1f} "
                  f"%); {plain}, no library call (no single PyTorch call computes this "
                  f"recurrence), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                  f"{nbytes / 1e6:.1f} MB); {rings[name]}; {smi}")
        del a, b, h0, g, h, leaves
        torch.cuda.empty_cache()
    err, fwd, _, _ = scan_times[RGLRU_SLICE]
    records[("rglru_scan", "recurrentgemma-9b")] = scan_record(
        "rglru_scan", RGLRU_SLICE, err, **fwd)
    err, fwd, bwd_err, bwd = scan_times[RGLRU_TRAIN]
    records[("rglru_scan", "recurrentgemma-9b train")] = scan_record(
        "rglru_scan", RGLRU_TRAIN, err, **fwd)
    prefill_bwd = scan_times[RGLRU_SLICE][3]
    records[("rglru_scan_bwd", "recurrentgemma-9b train")] = scan_record(
        "rglru_scan_bwd", RGLRU_TRAIN, bwd_err, **bwd,
        replaces_note="the backward of its custom_vjp (src/repro/kernels/ops.py:63-78), the vjp "
                      "of ref.rglru_scan_ref",
        prefill_shape={"shape": list(RGLRU_SLICE), "max_abs_err": scan_times[RGLRU_SLICE][2],
                       **prefill_bwd})
    # A rank of model 2 (phase 10(a)); the records take its launches.
    err, fwd, _, _ = scan_times[RGLRU_TP_SLICE]
    records[("rglru_scan", "recurrentgemma-9b model 2")] = scan_record(
        "rglru_scan", RGLRU_TP_SLICE, err, **fwd)
    err, fwd, bwd_err, bwd = scan_times[RGLRU_TP_TRAIN]
    records[("rglru_scan", "recurrentgemma-9b model 2 train")] = scan_record(
        "rglru_scan", RGLRU_TP_TRAIN, err, **fwd)
    records[("rglru_scan_bwd", "recurrentgemma-9b model 2 train")] = scan_record(
        "rglru_scan_bwd", RGLRU_TP_TRAIN, bwd_err, **bwd,
        replaces_note="the backward of its custom_vjp (src/repro/kernels/ops.py:63-78), the vjp "
                      "of ref.rglru_scan_ref")

    def held(phase):
        """What earlier phases leave allocated on the card: it adds to every
        later peak-memory reading."""
        before = torch.cuda.memory_allocated()
        gc.collect()
        print(f"[memory] allocated before phase {phase}: {before / 1e9:.3f} GB, "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB after a garbage collection; "
              f"{time.perf_counter() - started:.1f} s into the run")

    def mark(part):
        """When a part of a phase starts, for the script's time budget."""
        print(f"[time] {part} starts {time.perf_counter() - started:.1f} s into the run")

    # -------------------------------- 3. port vs its plain path, small input --
    held(3)
    for arch in CHECK:
        cfg = get_config(arch, smoke=True).with_overrides(dtype="float32")
        gpu = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
        cpu = Model(cfg, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        prompt = input_specs(cfg, ShapeConfig("p", 24, 2, "prefill"),
                             generator=torch.Generator().manual_seed(1), device="cpu",
                             dtype=torch.float32)
        on_card = {k: v.to(dev) for k, v in prompt.items()}
        if not cfg.causal:  # an encoder: every position's logits, no decode
            lg = build_encode_step(gpu)(on_card)
            lc = build_encode_step(cpu)(prompt)
            torch.testing.assert_close(lg.cpu(), lc, atol=2e-4, rtol=1e-3)
            print(f"[check] {arch} smoke fp32 (no causal mask, {cfg.frontend} stub frontend): "
                  f"card encode logits {tuple(lg.shape)} match the CPU path")
            del gpu, cpu
            continue
        lg, cg = gpu.prefill(on_card, 32)
        lc, cc = cpu.prefill(prompt, 32)
        for step in range(4):
            torch.testing.assert_close(lg.cpu(), lc, atol=2e-4, rtol=1e-3)
            tok = torch.argmax(lc[:, -1], dim=-1, keepdim=True)
            lg, cg = gpu.decode_step(cg, tok.to(dev))
            lc, cc = cpu.decode_step(cc, tok)
        torch.testing.assert_close(lg.cpu(), lc, atol=5e-3, rtol=1e-2)
        ffn = ("MoE" if cfg.moe else "dense FFN" if "attn" in cfg.block_pattern
               else "xLSTM blocks")
        front = f", {cfg.frontend} stub frontend" if cfg.frontend != "none" else ""
        print(f"[check] {arch} smoke fp32 (window {cfg.window}, attention {cfg.attention}, "
              f"{ffn}{front}): card prefill + 4 decode steps match the CPU path")
        del gpu, cpu

    # ----------------------------------------------------- 4. main paths --
    held(4)
    kernels = {"flash_attention": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
               "rglru_scan": rglru_scan_fwd, "rglru_scan_bwd": rglru_scan_bwd}

    served = {}  # each main path's result
    dry_measured = {}  # what phase 13's dry run is held to: seconds and peak GB
    for arch, batch, prompt_len, gen_len, layers in SERVE:
        full = get_config(arch)
        if layers:
            full = full.with_overrides(num_layers=layers)
        plan = layer_plan(full)
        kinds = plan.lead + plan.pattern * plan.n_scan + plan.tail
        expect = {"flash_attention": kinds.count("attn") + kinds.count("attn_dense"),
                  "flash_attention_bwd": 0, "rglru_scan": kinds.count("rec"),
                  "rglru_scan_bwd": 0}
        # Same weights and prompts as serve() draws from seed 0: the first token
        # it serves must be the argmax of these finite logits.
        model = Model(full, device=dev, generator=torch.Generator(dev).manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        # What one decode step reads at least: every weight (a MoE layer's
        # experts all go through the capacity buffer), the embedding table
        # only in its rows where it is not also the unembedding.
        read = sum(p.numel() * p.element_size() for p in model.parameters())
        if not full.tie_embeddings:
            read -= model.embed["table"].numel() * model.embed["table"].element_size()
        prompts = input_specs(full, ShapeConfig("serve", prompt_len, batch, "prefill"),
                              generator=torch.Generator(dev).manual_seed(1), device=dev)
        logits, caches = model.prefill(prompts, prompt_len + gen_len)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} full-width prefill logits are not finite")
        first = torch.argmax(logits[:, -1], dim=-1).cpu()
        if arch == SERVE[0][0]:
            tp_ref_logits = logits[:, -1].float().cpu().numpy()  # held in phase 8(a)
        # For xLSTM the floor also reads and writes every layer's state; for
        # attention, each decode step reads its caches up to the step's
        # length (the mean over the decode steps; a window caps it at S).
        layer_caches = [c for group in caches.values()
                        for c in (group.values() if isinstance(group, dict) else group)]
        state = sum(t.numel() * t.element_size() for c in layer_caches
                    if isinstance(c, (MLSTMState, SLSTMState)) for t in c)
        S = min(prompt_len + gen_len, full.window) if full.window else prompt_len + gen_len
        kv = (sum(t.numel() * t.element_size() for c in layer_caches
                  if isinstance(c, (KVCache, MLACache)) for t in c if isinstance(t, torch.Tensor))
              * statistics.mean(min(prompt_len + i + 1, S) for i in range(gen_len - 1)) / S)
        del logits, caches, layer_caches
        if "mlstm" in full.block_pattern:
            xl = xlstm_serving_checks(model, prompts["tokens"])
            times = lambda ms: ", ".join(f"{n} {k} blocks {t:.2f} ms" for k, (n, t) in ms.items())
            print(f"[serve] {arch} full width bf16, batch {batch} x prompt {prompt_len}: "
                  f"mlstm_chunkwise against mlstm_reference (block 0) relative L2 "
                  f"{xl['chunkwise']:.3e} (limit {XLSTM_CHUNKWISE_TOL}); in fp32 against a forward "
                  f"over the prompt and one more token, relative L2 of the logits: prefill "
                  f"{xl['prefill']:.3e}, one decode step {xl['decode']:.3e} (largest "
                  f"|difference| {xl['decode max']:.3e}; {XLSTM_DECODE_TOL}), a decode from "
                  f"fresh states {xl['fresh decode']:.3e}; by block kind (CUDA events, bf16): "
                  f"prefill "
                  f"{times(xl['prefill_ms'])}, one decode step {times(xl['decode_ms'])}; one "
                  f"decode step under the profiler {xl['step_ms']:.2f} ms on the host clock, its "
                  f"kernels "
                  + ("not measured (no device time in the trace)" if xl["busy_ms"] is None else
                     f"{xl['busy_ms']:.2f} ms on the device (idle share "
                     f"{1 - xl['busy_ms'] / xl['step_ms']:.1%}), the most: "
                     + "; ".join(f"{ms:.2f} ms in {n} x {name}" for ms, n, name in xl["top"]))
                  + f"; {smi}")
        del model, prompts
        torch.cuda.empty_cache()

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with at_depth(serve_mod, layers), counted_plain_calls() as plain_calls:
            res = served[arch] = serve(arch, smoke=False, batch=batch, prompt_len=prompt_len,
                                       gen_len=gen_len, device="cuda")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if arch == DRY_MEASURED[1][1]:
            dry_measured[DRY_MEASURED[1][0]] = {"s": res["prefill_seconds"], "peak_gb": peak_gb,
                                            "time": "prefill s"}
        launches = {name: fn.launches for name, fn in kernels.items()}
        flash_variants = dict(flash_attention_fwd.launches_by_variant)
        scan_variants = dict(rglru_scan_fwd.launches_by_variant)
        toks = res["tokens"]
        depth = (f"{full.num_layers} of {get_config(arch).num_layers} layers ({plan.lead} + "
                 f"{plan.n_scan} x {plan.pattern} + {plan.tail})" if layers
                 else f"{full.num_layers} layers")
        print(f"[serve] {arch} full width bf16, {depth}, {n_params} parameters, batch {batch} x "
              f"prompt {prompt_len} x {gen_len} tokens: prefill "
              f"{res['prefill_seconds']:.4f} s, decode "
              f"{res['decode_seconds_per_token'] * 1e3:.3f} ms/token, "
              f"{res['throughput_tok_s']:.1f} tok/s, peak memory {peak_gb:.2f} GB; decode's "
              f"weight-read floor {read / 1e9:.2f} GB a token"
              + (f" plus {state / 1e9:.2f} GB of state read and as much written" if state else "")
              + (f" plus {kv / 1e9:.3f} GB of KV cache read (the mean over the decode steps)"
                 if kv else "")
              + f" = {(read + 2 * state + kv) / PEAK_BYTES_PER_S * 1e3:.3f} ms at "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; "
              f"launches "
              + ", ".join(f"{n} {c}" for n, c in launches.items())
              + " (flash by variant: " + ", ".join(f"{n} {c}" for n, c in flash_variants.items())
              + "; scan by variant: " + ", ".join(f"{n} {c}" for n, c in scan_variants.items())
              + f"); calls of the plain versions {plain_calls}; {smi}")
        torch.cuda.empty_cache()
        if tuple(toks.shape) != (batch, gen_len):
            raise AssertionError(f"tokens shape {tuple(toks.shape)} != {(batch, gen_len)}")
        if not bool(((toks >= 0) & (toks < full.vocab_size)).all()):
            raise AssertionError("generated tokens out of vocabulary range")
        if not torch.equal(toks[:, 0], first):
            raise AssertionError("first served token is not the argmax of the prefill logits")
        if launches != expect:
            raise AssertionError(f"{arch} prefill launched {launches}, expected {expect} "
                                 "(one per layer of each kernel's kind)")
        if flash_variants["wgmma"] != launches["flash_attention"]:
            raise AssertionError(f"{arch} prefill launched flash attention as {flash_variants}: "
                                 "every launch must be wgmma")
        if scan_variants["tma"] != launches["rglru_scan"]:
            raise AssertionError(f"{arch} prefill launched the scan as {scan_variants}: "
                                 "every launch must be tma")
        if plain_calls:
            raise AssertionError(f"{arch} serving called the plain versions {plain_calls}")
        for (name, path), rec in records.items():
            if path == arch:
                rec["launches"] = launches[name]

    # The encoder's main path: hubert-xlarge at published width and depth,
    # encoded through build_encode_step with every launch counted from zero;
    # then the same inputs with the plain flash version in the kernel's place.
    arch, batch, frames = ENCODE
    cfg = get_config(arch)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    n_read = n_params - model.embed["table"].numel()  # the stub replaces the embedding
    encode = build_encode_step(model)
    inputs = input_specs(cfg, ShapeConfig("encode", frames, batch, "prefill"),
                         generator=torch.Generator(dev).manual_seed(1), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with counted_plain_calls() as plain_calls:
        t = time.perf_counter()
        logits = encode(inputs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in kernels.items()}
    flash_variants = dict(flash_attention_fwd.launches_by_variant)
    finite = bool(torch.isfinite(logits).all())
    times = []
    for _ in range(3):
        t = time.perf_counter()
        encode(inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    encode_s = statistics.median(times)
    real_fwd = ops._flash_fwd
    ops._flash_fwd = plain_entries()["_flash_fwd"]
    try:
        plain_gap = rel_l2(logits, encode(inputs))
    finally:
        ops._flash_fwd = real_fwd
    # Model FLOPs of one encode: 2 per weight read per frame, and the
    # attention's QK^T and PV (2 FLOP per multiply-add over dk + dv) over every
    # (query, key) pair of each row, in every layer.
    attn_flops = 2 * 2 * hd * H * frames * frames * batch * L
    model_flops = 2 * n_read * batch * frames + attn_flops
    dry_measured[DRY_MEASURED[2][0]] = {"s": encode_s, "peak_gb": peak_gb, "time": "encode s",
                                    "model_flops": model_flops}
    print(f"[encode] {arch} published width and depth bf16, {L} layers, {n_params} parameters "
          f"({n_read} read: the audio stub replaces the token embedding), batch {batch} x "
          f"{frames} frames ({frames * 0.02:g} s of audio at 20 ms a frame): logits "
          f"{tuple(logits.shape)}, finite {finite}; first call {first_s:.4f} s, then "
          f"{[round(x, 5) for x in times]} s (median {encode_s:.5f} s, "
          f"{batch * frames / encode_s:.1f} frames/s), model FLOPs {model_flops / 1e12:.2f} T "
          f"({attn_flops / 1e12:.2f} T attention over all {frames * frames} pairs per row and "
          f"head), {100 * model_flops / encode_s / PEAK_BF16_FLOPS:.2f} % of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory {peak_gb:.2f} GB; launches "
          + ", ".join(f"{n} {c}" for n, c in launches.items())
          + " (flash by variant: " + ", ".join(f"{n} {c}" for n, c in flash_variants.items())
          + f"); calls of the plain versions {plain_calls}; the plain flash version in the "
          f"kernel's place: logits relative L2 {plain_gap:.3e} (limit {ENCODE_PLAIN_TOL}); {smi}")
    expect = {"flash_attention": L, "flash_attention_bwd": 0, "rglru_scan": 0,
              "rglru_scan_bwd": 0}
    if tuple(logits.shape) != (batch, frames, cfg.vocab_size) or not finite:
        raise AssertionError(f"{arch} encode gave logits {tuple(logits.shape)}, finite {finite}")
    if not plain_gap <= ENCODE_PLAIN_TOL:
        raise AssertionError(f"{arch} encode's logits sit {plain_gap} from the plain version's")
    if launches != expect or flash_variants["wgmma"] != L or plain_calls:
        raise AssertionError(f"{arch} encode launched {launches} ({flash_variants}), expected "
                             f"{expect} all wgmma, and called the plain versions {plain_calls}")
    records[("flash_attention", arch)]["launches"] = launches["flash_attention"]
    del model, encode, inputs, logits
    torch.cuda.empty_cache()

    # ----------------------------------------------- 5. admitted serving --
    held(5)
    arch, batch, prompt_len, gen_len, _ = SERVE[0]
    kw = dict(smoke=False, batch=batch, prompt_len=prompt_len, gen_len=gen_len, device="cuda")
    bare = served[arch]
    host_us = {"admit": [], "keepalive": [], "complete": []}
    seen = []  # what admit and each keepalive found on the host and the card
    real = {name: getattr(BatchAdmission, name) for name in host_us}

    def instrumented(name):
        def call(self, *args, **kwargs):
            if name == "admit":
                seen.append(("admit", sorted(build._loaded)))
            elif name == "keepalive":
                seen.append(("keepalive", torch.cuda.current_stream().query()))
            t = time.perf_counter_ns()
            out = real[name](self, *args, **kwargs)
            host_us[name].append((time.perf_counter_ns() - t) / 1e3)
            return out
        return call

    build._loaded.clear()  # serve() must load the libraries again before it admits
    for name in host_us:
        setattr(BatchAdmission, name, instrumented(name))
    try:
        reset_counts()
        t = time.perf_counter()
        res = serve(arch, admission_slots=4, **kw)
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in kernels.items()}
        flash_variants = dict(flash_attention_fwd.launches_by_variant)
    finally:
        for name, fn in real.items():
            setattr(BatchAdmission, name, fn)
    adm = res["admission"]
    request_s = res["prefill_seconds"] + res["decode_seconds_per_token"] * (gen_len - 1)
    print(f"[admission] {arch} batch {batch} x prompt {prompt_len} x {gen_len} tokens "
          f"admitted via {adm['slot_key']} (fence token {adm['fence_token']}): grants "
          f"{adm['grants']}, fast renewals {adm['fast_renews']}, expirations "
          f"{adm['expirations']}, RDMA ops on the serving host {adm['local_rdma_ops']}; "
          f"launches " + ", ".join(f"{n} {c}" for n, c in launches.items())
          + f" (flash by variant: " + ", ".join(f"{n} {c}" for n, c in flash_variants.items())
          + f"); libraries loaded at admit {seen[0][1]}, card idle at each keepalive "
          f"{[ok for what, ok in seen[1:]]}")
    if not torch.equal(res["tokens"], bare["tokens"]):
        raise AssertionError("admitted serve's tokens differ from the bare serve's")
    counters = {k: adm[k] for k in ("grants", "fast_renews", "expirations", "local_rdma_ops")}
    if counters != {"grants": 1, "fast_renews": 4, "expirations": 0, "local_rdma_ops": 0}:
        raise AssertionError(f"admission counters {counters}")
    if (launches != {"flash_attention": 16, "flash_attention_bwd": 0, "rglru_scan": 0,
                     "rglru_scan_bwd": 0} or flash_variants["wgmma"] != 16):
        raise AssertionError(f"admitted serve launched {launches}, flash {flash_variants}")
    if seen[0] != ("admit", ["flash_attention"]):
        raise AssertionError(f"admit found the kernel libraries {seen[0][1]} loaded")
    if [what for what, _ in seen[1:]] != ["keepalive"] * 4 or not all(ok for _, ok in seen[1:]):
        raise AssertionError(f"keepalives found the card busy or were not 4: {seen[1:]}")
    records[("flash_attention", arch)]["admitted_launches"] = launches["flash_attention"]

    # Three server threads, two slots.
    guard, inside, peak = threading.Lock(), [0], [0]

    class Counted(BatchAdmission):
        def admit(self, *args, **kwargs):
            lease = super().admit(*args, **kwargs)
            with guard:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            return lease

        def complete(self, lease, worker=None):
            with guard:
                inside[0] -= 1
            return super().complete(lease, worker)

    gate = Counted(num_slots=2)
    results, errors = [None] * 3, []

    def server(i):
        try:
            results[i] = serve(arch, admission=gate, **kw)
        except BaseException as exc:
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=server, args=(i,)) for i in range(3)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    threaded_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    if errors:
        raise AssertionError(f"server threads failed: {errors}")
    fences = [(r["admission"]["slot_key"], r["admission"]["fence_token"]) for r in results]
    print(f"[admission] 3 server threads, 2 slots: at most {peak[0]} inside a lease, "
          f"fences {fences}, {threaded_s:.3f} s for the three requests")
    if not 1 <= peak[0] <= 2 or inside[0] != 0:
        raise AssertionError(f"{peak[0]} batches inside their leases at once with 2 slots")
    if not all(torch.equal(r["tokens"], bare["tokens"]) for r in results):
        raise AssertionError("a threaded serve's tokens differ from the single-thread serve's")
    if len(set(fences)) != 3:
        raise AssertionError(f"admissions share a fence: {fences}")

    # Host time of one admission's calls, in the request and over many.
    loop = BatchAdmission(num_slots=4)
    cycle = {name: [] for name in host_us}
    for _ in range(2000):
        t0 = time.perf_counter_ns()
        lease = loop.admit(timeout=1.0)
        t1 = time.perf_counter_ns()
        lease = loop.keepalive(lease)
        t2 = time.perf_counter_ns()
        loop.complete(lease)
        t3 = time.perf_counter_ns()
        for name, ns in zip(cycle, (t1 - t0, t2 - t1, t3 - t2)):
            cycle[name].append(ns / 1e3)
    print(f"[admission] host us in the request: admit {host_us['admit'][0]:.1f}, keepalives "
          f"{[round(x, 1) for x in host_us['keepalive']]}, complete "
          f"{host_us['complete'][0]:.1f}; request {request_s:.4f} s of prefill and decode, "
          f"{wall:.3f} s for the whole call; {smi}")
    print("[admission] host us over 2000 admit-keepalive-complete cycles, median / p99: "
          + ", ".join(f"{name} {statistics.median(v):.2f} / "
                      f"{sorted(v)[int(0.99 * len(v))]:.2f}" for name, v in cycle.items())
          + f"; {smi}")

    # Bare against admitted, in turns (the order rotates each round):
    # admitted through a private table that serve() builds, and through a
    # gate built beforehand; with the time the Python garbage collector took
    # during each call.
    gc_ms, gc_t0 = [0.0, 0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3
            gc_ms[1] += info["generation"] == 2

    modes = {"bare": {}, "admitted": {"admission_slots": 4},
             "shared gate": {"admission": BatchAdmission(num_slots=4)}}
    runs, gcs = {m: [] for m in modes}, {m: [] for m in modes}
    gc.callbacks.append(on_gc)
    try:
        for i in range(3):
            order = list(modes)[i:] + list(modes)[:i]
            for mode in order:
                gc_ms[:] = [0.0, 0]
                runs[mode].append(serve(arch, **modes[mode], **kw))
                gcs[mode].append((round(gc_ms[0], 3), gc_ms[1]))
                torch.cuda.empty_cache()
    finally:
        gc.callbacks.remove(on_gc)
    for mode, rs in runs.items():
        print(f"[admission] {mode} x {len(rs)}: prefill s "
              f"{[round(r['prefill_seconds'], 5) for r in rs]}, decode ms/token "
              f"{[round(r['decode_seconds_per_token'] * 1e3, 4) for r in rs]}, "
              f"garbage collection in the call (ms, full collections) {gcs[mode]}")
        if not all(torch.equal(r["tokens"], bare["tokens"]) for r in rs):
            raise AssertionError(f"a {mode} serve's tokens differ from phase 4's")

    # -------------------------------------------------------- 6. training --
    held(6)
    # (a) Flash gradients on the card, through the autograd Function, against
    # the plain backward and the oracle's autograd.
    for case in GRAD_CASES:
        B, T, H, K, dk, dv, causal, window, dtype = case
        inputs = flash_inputs(B, T, H, K, dk, dv, dtype)
        leaves = [x.clone().requires_grad_() for x in inputs]
        before = dict(flash_attention_fwd.launches_by_variant)
        before_bwd = dict(flash_attention_bwd.launches_by_variant)
        out = ops.flash_attention(*leaves, causal, window)
        kind, = (n for n, c in flash_attention_fwd.launches_by_variant.items()
                 if c != before[n])
        g = randn(*out.shape).to(out.dtype)
        grads = torch.autograd.grad(out, leaves, g)
        bwd_kind, = (n for n, c in flash_attention_bwd.launches_by_variant.items()
                     if c != before_bwd[n])
        expect, lse = ref.flash_attention_lse_ref(*inputs, causal=causal, window=window)
        plain, oracle = grad_refs(case, *inputs, out.detach(), lse, g)
        torch.cuda.synchronize()
        err, share = flash_check(case, out.detach(), expect, kind)
        print(f"[train] flash_attention grads {case} forward {kind}, backward {bwd_kind}: "
              f"forward max_abs_err {err:.3e}; "
              + bwd_note(dtype, *grad_check(case, bwd_kind, grads, plain, oracle)))
        del inputs, leaves, out, g, grads, expect, lse, plain, oracle

    for arch in SMOKE_TRAIN:
        reset_counts()
        rows, worst = smoke_train_steps(arch, dev)
        launches = {name: fn.launches for name, fn in kernels.items()}
        smoke_cfg = get_config(arch, smoke=True)
        lr = SMOKE_MLA_LR if smoke_cfg.attention == "mla" else 1e-3
        print(f"[train] {arch} smoke fp32, 3 steps x 2 microbatches at lr {lr:g}, card vs CPU "
              f"from one init: "
              f"losses {[(round(a, 6), round(b, 6)) for a, b, _, _ in rows]}, grad-norms "
              f"{[(round(c, 6), round(d, 6)) for _, _, c, d in rows]}, largest parameter "
              f"difference {worst:.3e} (atol {TRAIN_TOL['atol']}, rtol {TRAIN_TOL['rtol']}); "
              f"card launches " + ", ".join(f"{n} {c}" for n, c in launches.items()))
        # 3 steps of 2 microbatches.
        expect = {name: 3 * c for name, c in
                  expected_launches(layer_plan(smoke_cfg), 2, smoke_cfg.mtp_depth).items()}
        if launches != expect:
            raise AssertionError(f"{arch} smoke training launched {launches}, expected {expect}")

    mark("6(b)")
    # (b) Resume on the card.
    with tempfile.TemporaryDirectory() as tmp:
        whole, resumed = resumed_losses("llama3.2-1b", dev, tmp)
    print(f"[train] llama3.2-1b smoke resume: checkpoint at step 3, resumed through step 6: "
          f"losses {resumed} vs uninterrupted {whole}")
    if resumed != whole:
        raise AssertionError("the resumed run's losses differ from the uninterrupted run's")
    torch.cuda.empty_cache()

    mark("6(c)")
    # (c) The main path's second half: full-width llama3.2-1b training.
    arch, rows, seq, micro, n_steps = TRAIN
    full = get_config(arch)
    shape = ShapeConfig("train_4k", seq, rows, "train")
    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(learning_rate=3e-4, warmup_steps=2, total_steps=n_steps,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        # Calls of the plain versions during the run: there must be none.
        with counted_plain_calls() as plain_calls:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            res = train(arch, smoke=False, steps=n_steps, shape=shape, run=run, log_every=1,
                        device="cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in kernels.items()}
    flash_variants = dict(flash_attention_fwd.launches_by_variant)
    bwd_variants = dict(flash_attention_bwd.launches_by_variant)
    hist = res["history"]
    n_params = sum(t.numel() for t in res["final_state"]["params"].values())
    del res
    torch.cuda.empty_cache()
    for h in hist:
        print(f"[train] {arch} full width step {h['step']}: loss {h['loss']:.6f}, grad-norm "
              f"{h['grad_norm']:.6f}, {h['seconds_per_step']:.4f} s")
    step_s = statistics.mean(h["seconds_per_step"] for h in hist[1:])
    dry_measured[DRY_MEASURED[0][0]] = {"s": step_s, "peak_gb": peak_gb, "time": "s per step"}
    tokens = rows * seq
    H, hd, L = full.num_heads, full.resolved_head_dim, full.num_layers
    # Model FLOPs: 6 N per token, plus causal attention's QK^T and PV (2 FLOP
    # per multiply-add over dk + dv) over the T(T+1)/2 unmasked pairs, three
    # times (forward and backward) in every layer.  Remat's recompute is not
    # model work and is not counted.
    attn_flops = 3 * 2 * 2 * hd * H * (seq * (seq + 1) // 2) * rows * L
    model_flops = 6 * n_params * tokens + attn_flops
    share = model_flops / step_s / PEAK_BF16_FLOPS
    print(f"[train] {arch} full width bf16 (fp32 moments, block remat), {L} layers, "
          f"{n_params} parameters, {rows} rows x {seq} tokens in {micro} microbatches, "
          f"lr {run.learning_rate} (warmup {run.warmup_steps}): {step_s:.4f} s per step after "
          f"the first (mean of steps 2-{n_steps}), {tokens / step_s:.1f} tokens/s, model FLOPs "
          f"{model_flops / 1e12:.2f} T per step ({attn_flops / 1e12:.2f} T attention), "
          f"{100 * share:.2f} % of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory "
          f"{peak_gb:.2f} GB; launches per step " + ", ".join(
              f"{n} {c / n_steps:g}" for n, c in launches.items())
          + " (flash by variant: " + ", ".join(
              f"{n} {c / n_steps:g}" for n, c in flash_variants.items())
          + "; backward by variant: " + ", ".join(
              f"{n} {c / n_steps:g}" for n, c in bwd_variants.items())
          + f"); calls of the plain versions {plain_calls}; {smi}")
    per_step = expected_launches(layer_plan(full), micro)
    expect_flash = per_step["flash_attention"] * n_steps
    expect_bwd = per_step["flash_attention_bwd"] * n_steps
    if (launches["flash_attention_bwd"] != expect_bwd or bwd_variants["wgmma"] != expect_bwd
            or plain_calls):
        raise AssertionError(f"training launched the flash backward "
                             f"{launches['flash_attention_bwd']} times ({bwd_variants}), "
                             f"expected {expect_bwd}, all wgmma, and called the plain "
                             f"versions {plain_calls} times, expected never")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss in {[h['loss'] for h in hist]}")
    if launches["flash_attention"] != expect_flash or flash_variants["wgmma"] != expect_flash:
        raise AssertionError(f"training launched flash {launches['flash_attention']} times "
                             f"({flash_variants}), expected {expect_flash}, all wgmma")
    if launches["rglru_scan"] or launches["rglru_scan_bwd"]:
        raise AssertionError(f"llama training launched the scan: {launches}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"loss did not fall: step 1 {hist[0]['loss']}, "
                             f"step {n_steps} {hist[-1]['loss']}")

    # One microbatch's backward, with events around the whole and around each
    # attention backward (the kernel); the flash kernels at this shape beside
    # their plain versions and SDPA.
    model = Model(full, device=dev, generator=torch.Generator(dev).manual_seed(0))
    mb = SyntheticLMDataset(full, ShapeConfig("mb", seq, 1, "train"), seed=0).batch(0)
    mb = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in mb.items()}
    for _ in range(2):  # the first warms up; the second is reported
        fwd_ms, bwd_ms, calls = timed_microbatch(model, mb, {"attention": ops._FlashAttention})
    attn = calls["attention"]
    attn_ms = sum(t for t, _ in attn)
    print(f"[train] {arch} one microbatch (1 x {seq}): forward {fwd_ms:.2f} ms, backward "
          f"{bwd_ms:.2f} ms (with remat's recompute), of which the attention backward "
          f"(the kernel) {attn_ms:.2f} ms in {len(attn)} calls = "
          f"{100 * attn_ms / bwd_ms:.1f} %, {attn_ms / len(attn):.2f} ms and "
          f"{max(p for _, p in attn) / 1e9:.2f} GB of transient memory per call; {smi}")

    # The same microbatch and weights with the plain versions in place of the
    # kernels, in the forward, remat's recompute and the backward: the wgmma
    # kernels under autograd and remat at the training shape, held to the
    # plain versions' loss and gradients in bf16.  Then a recompute that is
    # wrong on purpose (window 2048 in remat's calls only) must exceed the
    # limits.
    plain = plain_entries()
    calls = []

    def wrong_recompute(q, k, v, causal, window, scale, lse=False):
        calls.append(None)  # the first L calls are the forward, then remat's
        return plain["_flash_fwd"](q, k, v, causal, seq // 2 if len(calls) > L else window,
                                   scale, lse)

    before = flash_attention_fwd.launches_by_variant["wgmma"]
    before_bwd = flash_attention_bwd.launches_by_variant["wgmma"]
    kernel_run = microbatch_grads(model, mb)
    wgmma = flash_attention_fwd.launches_by_variant["wgmma"] - before
    wgmma_bwd = flash_attention_bwd.launches_by_variant["wgmma"] - before_bwd
    plain_run = microbatch_grads(model, mb, plain)
    wrong_run = microbatch_grads(model, mb, {**plain, "_flash_fwd": wrong_recompute})
    del model
    gaps = grad_gaps(kernel_run, plain_run)
    wrong = grad_gaps(wrong_run, plain_run)
    print(f"[train] {arch} one microbatch (1 x {seq}), kernels (wgmma launches: forward "
          f"{wgmma}, backward {wgmma_bwd}) vs plain versions in forward, recompute and "
          f"backward: loss {kernel_run[0]:.6f} vs {plain_run[0]:.6f}, "
          f"relative gap {gaps[0]:.3e} (limit {TRAIN_BF16_TOL['loss']}); worst leaf "
          f"|g - g_plain| / |g_plain| {gaps[1]:.3e} ({gaps[3]}; limit {TRAIN_BF16_TOL['grad']}); "
          f"worst leaf norm gap {gaps[2]:.3e} (limit {TRAIN_BF16_TOL['norm']}); a wrong "
          f"recompute (window {seq // 2}): {wrong[0]:.3e}, {wrong[1]:.3e} ({wrong[3]}), "
          f"{wrong[2]:.3e}")
    if wgmma != 2 * L or wgmma_bwd != L:
        raise AssertionError(f"the kernel's microbatch launched wgmma {wgmma} / {wgmma_bwd} "
                             f"times (forward / backward), expected {2 * L} / {L}")
    if not (gaps[0] <= TRAIN_BF16_TOL["loss"] and gaps[1] <= TRAIN_BF16_TOL["grad"]
            and gaps[2] <= TRAIN_BF16_TOL["norm"]):
        raise AssertionError(f"training through the kernel disagrees with the plain version "
                             f"at the training shape: {gaps}")
    if wrong[1] <= TRAIN_BF16_TOL["grad"]:
        raise AssertionError(f"the gradient check does not see a wrong recompute: {wrong}")
    del kernel_run, plain_run, wrong_run
    torch.cuda.empty_cache()

    case = (1, seq, full.num_heads, full.num_kv_heads, hd, hd, True, 0, "bfloat16")
    fwd_rec, bwd_rec = attention_at_train_shape(case, f"{arch} training microbatch")
    fwd_rec["launches"] = launches["flash_attention"]
    in_step_ms = attn_ms / len(attn)
    print(f"[kernel] flash_attention_bwd at {arch}'s training shape: {in_step_ms:.4f} ms per "
          f"call in the microbatch's backward; {smi}")
    fwd_rec.update(
        backward_ms=bwd_rec["ms"], backward_ms_in_step=in_step_ms,
        backward_plain_ms=bwd_rec["plain_ms"], backward_bound_ms=bwd_rec["bound_ms"],
        backward_library_ms=bwd_rec["library_ms"],
        backward_launches=launches["flash_attention_bwd"])
    bwd_rec["launches"] = launches["flash_attention_bwd"]
    records[("flash_attention", f"{arch} train")] = fwd_rec
    records[("flash_attention_bwd", f"{arch} train")] = bwd_rec
    for name in ("flash_attention", "flash_attention_bwd"):
        records[(name, "llama3-8b train")]["launches"] = launches[name]
    torch.cuda.empty_cache()

    mark("6(d)")
    # (d) recurrentgemma-9b training at published widths, cut to 8 layers,
    # through train() with get_config patched in its namespace for the call.
    arch, layers, rows, seq, micro, n_steps = RG_TRAIN
    cfg = get_config(arch).with_overrides(num_layers=layers)
    plan = layer_plan(cfg)
    H, hd = cfg.num_heads, cfg.resolved_head_dim

    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(learning_rate=3e-4, warmup_steps=2, total_steps=n_steps,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res, step_counts, plain_calls = counted_training(
            arch, layers, ShapeConfig("train_4k", seq, rows, "train"), run, "cuda")
        launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    tpr_first = {arch: (hist[0]["loss"], hist[0]["grad_norm"])}  # phase 10's reference
    n_params = sum(t.numel() for t in res["final_state"]["params"].values())
    trained_layers = res["config"].num_layers
    del res
    torch.cuda.empty_cache()
    for h, counts in zip(hist, step_counts):
        print(f"[train] {arch} {layers} layers step {h['step']}: loss {h['loss']:.6f}, grad-norm "
              f"{h['grad_norm']:.6f}, {h['seconds_per_step']:.4f} s; launches "
              + ", ".join(f"{n} {c}" for n, c in counts.items() if c))
    step_s = statistics.mean(h["seconds_per_step"] for h in hist[1:])
    tokens = rows * seq
    n_attn = plan.n_scan * plan.pattern.count("attn") + plan.tail.count("attn")
    pairs = int(attn_pairs(seq, cfg.causal, cfg.window).sum())
    # Model FLOPs: 6 N per token, plus windowed causal attention's QK^T and PV
    # (2 FLOP per multiply-add over dk + dv) over the unmasked pairs of each
    # row, three times (forward and backward) in each attention layer.  Remat's
    # recompute is not model work and is not counted.
    attn_flops = 3 * 2 * 2 * hd * H * pairs * rows * n_attn
    model_flops = 6 * n_params * tokens + attn_flops
    share = model_flops / step_s / PEAK_BF16_FLOPS
    expect = expected_counts(plan, micro)
    print(f"[train] {arch} published widths at {trained_layers} layers ({plan.n_scan} x "
          f"{plan.pattern} + {plan.tail}), bf16 (fp32 moments, block remat), {n_params} "
          f"parameters, {rows} rows x {seq} tokens in {micro} microbatches, lr "
          f"{run.learning_rate} (warmup {run.warmup_steps}): {step_s:.4f} s per step after the "
          f"first (mean of steps 2-{n_steps}), {tokens / step_s:.1f} tokens/s, model FLOPs "
          f"{model_flops / 1e12:.2f} T per step ({attn_flops / 1e12:.2f} T attention over "
          f"{pairs} pairs per row and head), {100 * share:.2f} % of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory {peak_gb:.2f} GB; launches per "
          f"step expected " + ", ".join(f"{n} {c}" for n, c in expect.items() if c)
          + f" (flash forward and backward at d {hd} both on wgmma, the scan both ways on "
          f"tma); calls of the plain "
          f"versions {plain_calls}; {smi}")
    if trained_layers != layers or len(step_counts) != n_steps:
        raise AssertionError(f"trained {trained_layers} layers in {len(step_counts)} steps")
    if any(c != expect for c in step_counts) or plain_calls:
        raise AssertionError(f"{arch} training launched {step_counts}, expected {expect} per "
                             f"step, and called the plain versions {plain_calls} times, "
                             f"expected never")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss in {[h['loss'] for h in hist]}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"loss did not fall: step 1 {hist[0]['loss']}, "
                             f"step {n_steps} {hist[-1]['loss']}")

    # One microbatch's backward: events around the whole, each scan backward
    # and each attention backward; then the same microbatch with the parent
    # tree's scan route (its backward the oracle's autograd), swapped in for
    # this measurement only.
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    mb = SyntheticLMDataset(cfg, ShapeConfig("mb", seq, 1, "train"), seed=0).batch(0)
    mb = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in mb.items()}
    timed = {"scan": ops._RGLRUScan, "attention": ops._FlashAttention}
    for _ in range(2):  # the first warms up; the second is reported
        fwd_ms, bwd_ms, calls = timed_microbatch(model, mb, timed)
    oracle_scan, real_scan = parent_scan(), ops._RGLRUScan
    ops._RGLRUScan = oracle_scan
    try:
        _, oracle_bwd_ms, oracle_calls = timed_microbatch(model, mb, {**timed,
                                                                       "scan": oracle_scan})
    finally:
        ops._RGLRUScan = real_scan
    per_call = {label: sum(t for t, _ in c) / len(c) for label, c in calls.items()}

    def part(label, c):
        ms = sum(t for t, _ in c)
        return (f"the {label} backward {ms:.2f} ms in {len(c)} calls ({ms / len(c):.3f} ms each, "
                f"{100 * ms / bwd_ms:.1f} %)")

    print(f"[train] {arch} {layers} layers, one microbatch (1 x {seq}): forward {fwd_ms:.2f} ms, "
          f"backward {bwd_ms:.2f} ms (with remat's recompute), of which "
          + ", ".join(part(label, c) for label, c in calls.items())
          + f"; the parent's route (the scan backward through the oracle's autograd): backward "
          f"{oracle_bwd_ms:.2f} ms, of which the scan backward "
          f"{sum(t for t, _ in oracle_calls['scan']):.2f} ms in {len(oracle_calls['scan'])} "
          f"calls; {smi}")

    # The same microbatch through the kernels against the plain versions in the
    # forward, remat's recompute and the backward; then a scan backward wrong
    # on purpose (da from h_t) must exceed the limits.
    before = launch_counts()
    kernel_run = microbatch_grads(model, mb)
    mb_launches = {k: c - before[k] for k, c in launch_counts().items()}
    before = launch_counts()
    plain_run = microbatch_grads(model, mb, plain_entries())
    plain_launches = {k: c - before[k] for k, c in launch_counts().items() if c != before[k]}
    wrong_run = microbatch_grads(model, mb, plain_entries(wrong_scan_bwd=True))
    del model
    gaps = grad_gaps(kernel_run, plain_run)
    wrong = grad_gaps(wrong_run, plain_run)
    tol = RG_TRAIN_BF16_TOL
    print(f"[train] {arch} {layers} layers, one microbatch (1 x {seq}), kernels (launches "
          + ", ".join(f"{n} {c}" for n, c in mb_launches.items() if c)
          + f") vs plain versions in forward, recompute and backward: loss {kernel_run[0]:.6f} "
          f"vs {plain_run[0]:.6f}, relative gap {gaps[0]:.3e} (limit {tol['loss']}); worst leaf "
          f"|g - g_plain| / |g_plain| {gaps[1]:.3e} ({gaps[3]}; limit {tol['grad']}); worst leaf "
          f"norm gap {gaps[2]:.3e} (limit {tol['norm']}); a scan backward wrong on purpose "
          f"(da from h_t): {wrong[0]:.3e}, {wrong[1]:.3e} ({wrong[3]}), {wrong[2]:.3e}")
    if mb_launches != expected_counts(plan, 1) or plain_launches:
        raise AssertionError(f"the kernels' microbatch launched {mb_launches}, expected "
                             f"{expected_counts(plan, 1)}; the plain one {plain_launches}")
    if not (gaps[0] <= tol["loss"] and gaps[1] <= tol["grad"] and gaps[2] <= tol["norm"]):
        raise AssertionError(f"{arch} training through the kernels disagrees with the plain "
                             f"versions at published widths: {gaps}")
    if wrong[1] <= tol["grad"]:
        raise AssertionError(f"the gradient check does not see a wrong scan backward: {wrong}")
    del kernel_run, plain_run, wrong_run
    torch.cuda.empty_cache()

    for (name, path), rec in records.items():
        if path == f"{arch} train":
            rec["launches"] = launches[name]
            rec["launches_per_step"] = launches[name] // n_steps
    records[("rglru_scan_bwd", f"{arch} train")]["ms_in_step"] = per_call["scan"]
    records[("flash_attention_bwd", f"{arch} train")]["ms_in_step"] = per_call["attention"]

    mark("6(e)")
    # (e) xlstm-1.3b at published width and depth: its blocks launch no kernel
    # of the port, and the sLSTM's loop over time runs on the host.
    arch, layers, rows, seq, micro, n_steps, lr = XLSTM_TRAIN
    cfg = get_config(arch).with_overrides(num_layers=layers)
    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(learning_rate=lr, warmup_steps=1, total_steps=n_steps,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        shape = ShapeConfig(f"train_{seq}", seq, rows, "train")
        res, step_counts, plain_calls = counted_training(arch, layers, shape, run, "cuda")
        train_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    n_params = sum(t.numel() for t in res["final_state"]["params"].values())
    trained_layers = res["config"].num_layers
    # The first step's batch under the initial and the trained weights: the
    # steps' own losses are each on another batch, whose spread (steps 1 and
    # 2 run one set of weights) the run's few updates need not exceed.
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(run.seed))
    first = SyntheticLMDataset(cfg, shape, seed=run.seed).batch(0)
    first = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in first.items()}
    with torch.no_grad():
        before = model.loss(first)[0].item()
        f32 = Model(cfg.with_overrides(dtype="float32"), device=dev,
                    generator=torch.Generator(dev).manual_seed(run.seed))
        f32.load_state_dict(model.state_dict())  # the bf16 weights, upcast
        before_f32 = f32.loss(first)[0].item()
        del f32
        model.load_state_dict(res["final_state"]["params"])
        after = model.loss(first)[0].item()
    del res, first
    torch.cuda.empty_cache()
    for h in hist:
        print(f"[train] {arch} step {h['step']}: loss {h['loss']:.6f}, grad-norm "
              f"{h['grad_norm']:.6f}, {h['seconds_per_step']:.4f} s")
    step_s = statistics.mean(h["seconds_per_step"] for h in hist[1:])
    tokens = rows * seq
    model_flops, mlstm_part = xlstm_step_flops(cfg, n_params, rows, seq)
    share = model_flops / step_s / PEAK_BF16_FLOPS
    plan = layer_plan(cfg)
    print(f"[train] {arch} published width at {cfg.num_layers} of 48 blocks ({plan.n_scan} x "
          f"{plan.pattern.count('mlstm')} mlstm + {plan.pattern.count('slstm')} slstm), bf16 "
          f"(fp32 moments, block remat), {n_params} parameters, {rows} rows x {seq} tokens in "
          f"{micro} microbatches, lr {run.learning_rate} (warmup {run.warmup_steps}): "
          f"{step_s:.4f} s per step after the first (mean of steps 2-{n_steps}), "
          f"{tokens / step_s:.1f} tokens/s, model FLOPs {model_flops / 1e12:.2f} T per step "
          f"({mlstm_part / 1e12:.2f} T of mLSTM chunkwise products), {100 * share:.3f} % of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory {peak_gb:.2f} GB; {train_s:.1f} s "
          f"in train(); the first step's batch: loss {before:.6f} under the initial weights, "
          f"{after:.6f} under the trained ones, {before_f32:.6f} under the initial ones in "
          f"fp32 (relative gap {abs(before - before_f32) / before_f32:.3e}, limit "
          f"{XLSTM_LOSS_RTOL}); the last step's loss below the 1st's: "
          f"{hist[-1]['loss'] < hist[0]['loss']}; launches of any kernel "
          f"{sum(sum(c.values()) for c in step_counts)}; calls of the plain versions "
          f"{plain_calls}; {smi}")
    if trained_layers != layers or len(step_counts) != n_steps:
        raise AssertionError(f"trained {trained_layers} layers in {len(step_counts)} steps")
    if any(any(c.values()) for c in step_counts) or plain_calls:
        raise AssertionError(f"{arch} training launched {step_counts} and called the plain "
                             f"versions {plain_calls}, expected neither")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss in {[h['loss'] for h in hist]}")
    if after == before:
        raise AssertionError(f"training left the loss of its first batch at {before}")
    if not abs(before - before_f32) / before_f32 < XLSTM_LOSS_RTOL:
        raise AssertionError(f"the first batch's loss in bf16 {before}, in fp32 {before_f32}")

    # One microbatch's forward and backward, with the sLSTM scans over time
    # timed apart (their forward, remat's recompute and their backward).
    mb = SyntheticLMDataset(cfg, ShapeConfig("mb", seq, rows // micro, "train"), seed=0).batch(0)
    mb = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in mb.items()}
    with timed_slstm_scans() as scans:
        fwd_ms, bwd_ms, _ = timed_microbatch(model, mb, {})
    del model, mb
    torch.cuda.empty_cache()
    n_slstm = plan.n_scan * plan.pattern.count("slstm")
    if len(scans["forward"]) != 2 * n_slstm or len(scans["backward"]) != n_slstm:
        raise AssertionError(f"timed {len(scans['forward'])} sLSTM scan forwards and "
                             f"{len(scans['backward'])} backwards, expected {2 * n_slstm} and "
                             f"{n_slstm}")
    scan_fwd = event_ms(scans["forward"][:n_slstm])
    scan_rec = event_ms(scans["forward"][n_slstm:])
    scan_bwd = event_ms(scans["backward"])
    scan_all = scan_fwd + scan_rec + scan_bwd
    print(f"[train] {arch} one microbatch ({rows // micro} x {seq}): forward {fwd_ms:.2f} ms, "
          f"backward {bwd_ms:.2f} ms (with remat's recompute); the sLSTM scans over time: "
          f"forward {scan_fwd:.2f} ms, recompute {scan_rec:.2f} ms, backward {scan_bwd:.2f} ms "
          f"in {n_slstm} calls each, {scan_all:.2f} ms = "
          f"{100 * scan_all / (fwd_ms + bwd_ms):.1f} % of the microbatch; {smi}")

    # The gradient at published width, in fp32 on one row of the first
    # batch, depth and row cut (XLSTM_SLOPE): the loss's change along it
    # against its prediction.
    layers_s, seq_s, change, tol = XLSTM_SLOPE
    cut = cfg.with_overrides(dtype="float32", num_layers=layers_s)
    f32 = Model(cut, device=dev, generator=torch.Generator(dev).manual_seed(run.seed))
    row = SyntheticLMDataset(cut, ShapeConfig("row", seq_s, 1, "train"), seed=run.seed).batch(0)
    row = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in row.items()}
    [(measured, predicted)] = gradient_slope(f32, row, [change])
    del f32, row
    torch.cuda.empty_cache()
    print(f"[train] {arch} fp32 gradient at published width, {layers_s} blocks, 1 x {seq_s}: "
          f"the loss moved {measured:.6e} between -t g and +t g, predicted {predicted:.6e} "
          f"(ratio {measured / predicted:.4f}, limit 1 +- {tol}); {smi}")
    if not abs(measured / predicted - 1) < tol:
        raise AssertionError(f"{arch}'s gradient predicts a change of {predicted} along it, "
                             f"the loss moved {measured}")

    mark("6(f)")
    # (f) hubert-xlarge at published width and depth through train(): every
    # step's launches counted from zero, then one microbatch through the
    # kernels against the plain versions.
    arch, rows, frames, micro, n_steps, lr = HUBERT_TRAIN
    cfg = get_config(arch)
    plan = layer_plan(cfg)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(learning_rate=lr, warmup_steps=2, total_steps=n_steps,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        shape = ShapeConfig(f"train_{frames}", frames, rows, "train")
        res, step_counts, plain_calls = counted_training(arch, None, shape, run, "cuda")
        train_s = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    final = res["final_state"]
    n_params = sum(t.numel() for t in final["params"].values())
    n_read = n_params - final["params"]["embed.table"].numel()
    # The moments of embed.table stay exactly zero only if every gradient it
    # got was exactly zero.  Every weight matrix the step reads must have
    # moved from its init; the norm scales (1 at init) need not, since a step
    # of lr 3e-4 is under half of bf16's spacing at 1 (2^-7).
    table_moments = [bool(final["opt"][m]["embed.table"].any()) for m in ("mu", "nu")]
    init = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(run.seed))
    unmoved = [k for k, p in init.named_parameters()
               if k != "embed.table" and not k.endswith(".scale")
               and torch.equal(p, final["params"][k])]
    del res, final, init
    torch.cuda.empty_cache()
    for h, counts in zip(hist, step_counts):
        print(f"[train] {arch} step {h['step']}: loss {h['loss']:.6f}, grad-norm "
              f"{h['grad_norm']:.6f}, {h['seconds_per_step']:.4f} s; launches "
              + ", ".join(f"{n} {c}" for n, c in counts.items() if c))
    step_s = statistics.mean(h["seconds_per_step"] for h in hist[1:])
    tokens = rows * frames
    # Model FLOPs: 6 per weight read per frame (the stub replaces the token
    # embedding, which the step never reads), plus the attention's QK^T and PV
    # (2 FLOP per multiply-add over dk + dv) over every (query, key) pair of
    # each row, three times (forward and backward) in every layer.  Remat's
    # recompute is not model work and is not counted.
    attn_flops = 3 * 2 * 2 * hd * H * frames * frames * rows * L
    model_flops = 6 * n_read * tokens + attn_flops
    expect = expected_counts(plan, micro)
    print(f"[train] {arch} published width and depth ({L} layers, no causal mask), bf16 (fp32 "
          f"moments, block remat), {n_params} parameters, {rows} rows x {frames} frames in "
          f"{micro} microbatches (reduced: the global batch), lr {run.learning_rate} (warmup "
          f"{run.warmup_steps}): {step_s:.4f} s per step after the first (mean of steps "
          f"2-{n_steps}), "
          f"{tokens / step_s:.1f} frames/s, model FLOPs {model_flops / 1e12:.2f} T per step "
          f"({attn_flops / 1e12:.2f} T attention over all {frames * frames} pairs per row and "
          f"head), {100 * model_flops / step_s / PEAK_BF16_FLOPS:.2f} % of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory {peak_gb:.2f} GB; {train_s:.1f} s "
          f"in train(); losses {[round(h['loss'], 6) for h in hist]} (printed, not held to "
          f"fall: the stub's embeddings are drawn independently of the labels); launches per "
          f"step expected " + ", ".join(f"{n} {c}" for n, c in expect.items() if c)
          + f"; embed.table's AdamW moments nonzero {table_moments} (its gradient exactly "
          f"zero at every step: False, False); weight matrices left at their init "
          f"{unmoved or 'none'}; calls of the plain versions {plain_calls}; {smi}")
    if len(step_counts) != n_steps:
        raise AssertionError(f"{arch} trained {len(step_counts)} steps, expected {n_steps}")
    if any(c != expect for c in step_counts) or plain_calls:
        raise AssertionError(f"{arch} training launched {step_counts}, expected {expect} per "
                             f"step, and called the plain versions {plain_calls} times, "
                             f"expected never")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss in {[h['loss'] for h in hist]}")
    if any(table_moments) or unmoved:
        raise AssertionError(f"embed.table's moments nonzero {table_moments}; weights that did "
                             f"not move {unmoved}")

    # One microbatch's forward and backward, with events around the whole and
    # around each attention backward (the kernel): what two of them leave of
    # the step is the optimizer, the data and the host.
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    mb = SyntheticLMDataset(cfg, ShapeConfig("mb", frames, rows // micro, "train"),
                            seed=0).batch(0)
    mb = {k: to_device(v, dev) for k, v in mb.items()}
    for _ in range(2):  # the first warms up; the second is reported
        fwd_ms, bwd_ms, timed = timed_microbatch(model, mb, {"attention": ops._FlashAttention})
    attn_ms = sum(t for t, _ in timed["attention"])
    attn_calls = len(timed["attention"])
    print(f"[train] {arch} one microbatch ({rows // micro} x {frames}): forward {fwd_ms:.2f} ms, "
          f"backward {bwd_ms:.2f} ms (with remat's recompute), of which the attention backward "
          f"(the kernel) {attn_ms:.2f} ms in {attn_calls} calls = "
          f"{100 * attn_ms / bwd_ms:.1f} %, {attn_ms / attn_calls:.3f} ms per call; "
          f"{micro} microbatches {micro * (fwd_ms + bwd_ms):.1f} ms of the "
          f"{step_s * 1e3:.1f} ms step; {smi}")
    # The same microbatch under the profiler: its kernels' device time and,
    # in the same call, its host time, so the card's idle share, and the
    # kernels that took the most.
    host = {}

    def one_microbatch():
        t = time.perf_counter()
        loss, _ = model.loss(mb)
        torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        torch.cuda.synchronize()
        host["ms"] = (time.perf_counter() - t) * 1e3

    trace = device_times(one_microbatch)
    busy_ms = sum(us for us, _ in trace.values()) / 1e3
    top = sorted(((us / 1e3, n, name[:70]) for name, (us, n) in trace.items()), reverse=True)
    print(f"[train] {arch} one microbatch under the profiler: {host['ms']:.1f} ms on the host "
          f"clock, its kernels "
          + ("not measured (no device time in the trace)" if not trace else
             f"{busy_ms:.1f} ms on the device (idle share {1 - busy_ms / host['ms']:.1%}), the "
             f"most: " + "; ".join(f"{ms:.1f} ms in {n} x {name}" for ms, n, name in top[:8]))
          + f"; {smi}")

    # That microbatch through the kernels against the plain versions in the
    # forward, remat's recompute and the backward; then a recompute wrong on
    # purpose (the causal mask in remat's calls) must exceed the limits.
    plain = plain_entries()
    calls = []

    def wrong_recompute(q, k, v, causal, window, scale, lse=False):
        calls.append(None)  # the first L calls are the forward, then remat's
        return plain["_flash_fwd"](q, k, v, causal or len(calls) > L, window, scale, lse)

    before = launch_counts()
    kernel_run = microbatch_grads(model, mb)
    mb_launches = {k: c - before[k] for k, c in launch_counts().items()}
    before = launch_counts()
    plain_run = microbatch_grads(model, mb, plain)
    plain_launches = {k: c - before[k] for k, c in launch_counts().items() if c != before[k]}
    wrong_run = microbatch_grads(model, mb, {**plain, "_flash_fwd": wrong_recompute})
    del model
    gaps = grad_gaps(kernel_run, plain_run)
    wrong = grad_gaps(wrong_run, plain_run)
    table_zero = [not run_[1]["embed.table"].any() for run_ in (kernel_run, plain_run)]
    tol = HUBERT_TRAIN_BF16_TOL
    print(f"[train] {arch} one microbatch ({rows // micro} x {frames}), kernels (launches "
          + ", ".join(f"{n} {c}" for n, c in mb_launches.items() if c)
          + f") vs plain versions in forward, recompute and backward: loss {kernel_run[0]:.6f} "
          f"vs {plain_run[0]:.6f}, relative gap {gaps[0]:.3e} (limit {tol['loss']}); worst leaf "
          f"|g - g_plain| / |g_plain| {gaps[1]:.3e} ({gaps[3]}; limit {tol['grad']}); worst leaf "
          f"norm gap {gaps[2]:.3e} (limit {tol['norm']}); embed.table's gradient exactly zero "
          f"(kernels, plain) {table_zero}; a wrong recompute (causal): {wrong[0]:.3e}, "
          f"{wrong[1]:.3e} ({wrong[3]}), {wrong[2]:.3e}; {smi}")
    if mb_launches != expected_counts(plan, 1) or plain_launches:
        raise AssertionError(f"the kernels' microbatch launched {mb_launches}, expected "
                             f"{expected_counts(plan, 1)}; the plain one {plain_launches}")
    if not all(table_zero):
        raise AssertionError(f"embed.table's gradient is not exactly zero: {table_zero}")
    if not (gaps[0] <= tol["loss"] and gaps[1] <= tol["grad"] and gaps[2] <= tol["norm"]):
        raise AssertionError(f"{arch} training through the kernels disagrees with the plain "
                             f"versions at published width: {gaps}")
    if wrong[1] <= tol["grad"]:
        raise AssertionError(f"the gradient check does not see a wrong recompute: {wrong}")
    del kernel_run, plain_run, wrong_run, mb
    torch.cuda.empty_cache()
    for (name, path), rec in records.items():
        if path == f"{arch} train":
            rec["launches"] = launches[name]
            rec["launches_per_step"] = launches[name] // n_steps
    records[("flash_attention_bwd", f"{arch} train")]["ms_in_step"] = attn_ms / attn_calls

    # (g) deepseek-v2-236b at published widths, 2 of 60 layers, and (h)
    # internvl2-76b at published widths, 1 of 80 layers, through train().
    for (arch, layers, rows, seq, micro, n_steps, lr), tol in (
            (DEEPSEEK_TRAIN, DEEPSEEK_TRAIN_BF16_TOL), (INTERNVL2_TRAIN, INTERNVL2_TRAIN_BF16_TOL)):
        held(f"6 ({arch})")
        launches, attn_ms = published_width_training(arch, layers, rows, seq, micro, n_steps,
                                                     lr, tol, smi)
        for (name, path), rec in records.items():
            if path == f"{arch} train":
                rec["launches"] = launches[name]
                rec["launches_per_step"] = launches[name] // n_steps
        records[("flash_attention_bwd", f"{arch} train")]["ms_in_step"] = attn_ms
        torch.cuda.empty_cache()

    # ------------------------------------------------ 7. training in pods --
    # llama3.2-1b at published width, cut to POD_LAYERS layers, on a 2 pods x
    # 1 data mesh, two ranks spawned (they share the card where it is the
    # only one), in each pod mode, held to one rank's step 1 of the same cut
    # made here first; each rank's launches counted from zero around each
    # step.
    held(7)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[memory] before phase 7's ranks: this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved; mem_get_info free "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB")
    arch, rows, seq, micro, n_steps, lr = POD_TRAIN
    n_ranks = math.prod(POD_MESH[0])
    name, limit = (x.strip() for x in smi.split(",", 1))
    if torch.cuda.device_count() < n_ranks:
        print(f"[pods] {n_ranks} ranks sharing one {name} ({limit}); pod exchange over gloo "
              "through host memory")
    else:
        print(f"[pods] {n_ranks} ranks, each on its own {name} ({limit})")
    t0 = time.perf_counter()
    cut = {"num_layers": POD_LAYERS}
    first_loss, _ = one_rank_step(arch, cut, rows, seq, TRAIN[3], lr, 0)
    print(f"[pods] one rank's step 1 at {POD_LAYERS} layers, 6(c)'s batch in {TRAIN[3]} "
          f"microbatches: loss {first_loss}, in {time.perf_counter() - t0:.1f} s")
    ranks = spawn_ranks(pod_rank, n_ranks, (arch, rows, seq, micro, n_steps, lr, False, None,
                                            POD_MESH, POD_FAULT, cut), timeout=900)
    check_pod_training(ranks, first_loss,
                       expected_launches(layer_plan(get_config(arch).with_overrides(**cut)),
                                         micro), smi)
    print(f"[pods] {arch} at published width, {POD_LAYERS} of 16 layers, {rows} x {seq} tokens "
          f"a step over {n_ranks} ranks ({micro} microbatches of one row each), {n_steps} steps "
          f"in each of {[m for m, _ in POD_MODES]} at lr {lr}: phase 7 took "
          f"{time.perf_counter() - t0:.1f} s; {smi}")

    # ------------------------------- 8. FSDP and tensor parallelism --
    # llama3.2-1b at published width and depth on (data, model) meshes, the
    # parameters sharded by sharding/rules.py: (a) phase 4's request served
    # at model 2, (b) trained at data 2 x model 2; each rank's launches
    # counted from zero around its serve() and each of its steps.
    held(8)
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    name, limit = (x.strip() for x in smi.split(",", 1))
    arch, batch, prompt_len, gen_len, _ = SERVE[0]
    n_ranks = math.prod(TP_SERVE_MESH[0])
    print(f"[tp] {n_ranks} ranks sharing one {name} ({limit}); the model group's exchange over "
          "gloo through host memory" if torch.cuda.device_count() < n_ranks else
          f"[tp] {n_ranks} ranks, each on its own {name} ({limit})")
    ranks = spawn_ranks(peaks_rank, n_ranks, ("tp", tp_serve_rank, arch, batch, prompt_len,
                                                gen_len), timeout=600)
    check_tp_serving(ranks, get_config(arch), batch, prompt_len, tp_ref_logits,
                     served[arch]["tokens"].numpy(), smi)
    records[("flash_attention", f"{arch} model 2")]["launches"] = (
        ranks[0]["launches"]["flash_attention"])
    del ranks
    mark("8(b)")
    arch, rows, seq, micro, n_steps, lr = TP_TRAIN
    n_data = TP_TRAIN_MESH[0][0]
    with tempfile.TemporaryDirectory() as tmp:
        # The one-rank reference: the same weights and first batch, each data
        # rank's rows in a microbatch of their own.
        one = train(arch, smoke=False, steps=1, shape=ShapeConfig("train_4k", seq, rows, "train"),
                    run=RunConfig(learning_rate=lr, warmup_steps=0, total_steps=n_steps,
                                  microbatches=n_data * micro, checkpoint_every=10 ** 9,
                                  checkpoint_dir=tmp), log_every=1, device="cuda")
    ref = (one["history"][0]["loss"], one["history"][0]["grad_norm"])
    tp_first = ref  # held again in phase 11
    del one
    gc.collect()
    torch.cuda.empty_cache()
    n_ranks = math.prod(TP_TRAIN_MESH[0])
    ranks = spawn_ranks(peaks_rank, n_ranks, ("tp", tp_train_rank, arch, rows, seq, micro,
                                               n_steps, lr), timeout=900)
    check_tp_training(ranks, get_config(arch), ref,
                      expected_launches(layer_plan(get_config(arch)), micro), smi)
    for name in ("flash_attention", "flash_attention_bwd"):
        rec = records[(name, f"{arch} model 2 train")]
        rec["launches"] = sum(s[name] for s in ranks[0]["steps"])
        rec["launches_per_step"] = rec["launches"] // n_steps
        rec["launches_note"] = f"rank 0's of {n_ranks} ranks"
    del ranks
    print(f"[tp] {arch} at published width and depth: served on {TP_SERVE_MESH[0]} and trained "
          f"{n_steps} steps of {rows} x {seq} tokens on {TP_TRAIN_MESH[0]} over "
          f"{TP_TRAIN_MESH[1]}: phase 8 took {time.perf_counter() - t8:.1f} s; {smi}")

    # ------------------------ 9. expert parallelism and MLA's TP --
    # deepseek-v2-236b at published widths, 2 of 60 layers, on the reference's
    # production MoE settings over (data 1, model 2): (a) phase 4's deepseek
    # request served, (b) 6(g)'s batch trained 2 steps; each held to a
    # one-rank run of the same weights made here first, whose MoE routes each
    # model rank's slice as a group of its own (island_groups).
    held(9)
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    cfg = ep_config()
    arch, batch, prompt_len, gen_len = EP_SERVE
    _, rows, seq, micro, n_steps, lr = EP_TRAIN
    n_ranks = math.prod(EP_MESH[0])
    name, limit = (x.strip() for x in smi.split(",", 1))
    print(f"[ep] {n_ranks} ranks sharing one {name} ({limit}); the model group's exchange over "
          "gloo through host memory" if torch.cuda.device_count() < n_ranks else
          f"[ep] {n_ranks} ranks, each on its own {name} ({limit})")
    ref_logits, ref_train = ep_references((batch, prompt_len, gen_len),
                                          (rows, seq, micro, n_steps, lr))
    free, total = torch.cuda.mem_get_info()
    print(f"[ep] one-rank references in {time.perf_counter() - t9:.1f} s: step 1 loss "
          f"{ref_train[0]}, grad-norm {ref_train[1]}; before the ranks this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, mem_get_info free {free / 1e9:.2f} "
          f"of {total / 1e9:.2f} GB")
    mark("9's ranks")
    ranks = spawn_ranks(peaks_rank, n_ranks, ("ep", ep_rank, (batch, prompt_len, gen_len),
                                               (rows, seq, micro, n_steps, lr)), timeout=900)
    serving, training = [r["serve"] for r in ranks], [r["train"] for r in ranks]
    del ranks
    check_ep_serving(serving, cfg, batch, prompt_len, ref_logits, smi)
    records[("flash_attention", f"{arch} model 2")]["launches"] = (
        serving[0]["launches"]["flash_attention"])
    check_ep_training(training, cfg, ref_train, expected_launches(layer_plan(cfg), micro), smi)
    for name in ("flash_attention", "flash_attention_bwd"):
        rec = records[(name, f"{arch} model 2 train")]
        rec["launches"] = sum(s[name] for s in training[0]["steps"])
        rec["launches_per_step"] = rec["launches"] // n_steps
        rec["launches_note"] = f"rank 0's of {n_ranks} ranks"
    del serving, training
    print(f"[ep] {arch} at published widths, {cfg.num_layers} of 60 layers: served on "
          f"{EP_MESH[0]} and trained {n_steps} steps of {rows} x {seq} tokens over "
          f"{EP_MESH[1]}: phase 9 took {time.perf_counter() - t9:.1f} s; {smi}")

    # ------- 10. TP for RG-LRU and xLSTM blocks, and the head-dim split --
    # recurrentgemma-9b (8 layers) and xlstm-1.3b (8 blocks) at published
    # widths on (data 1, model 2): each served and trained, held to one rank;
    # the mLSTM's gradient probed in fp32.
    held(10)
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    n_ranks = math.prod(TPR_MESH[0])
    name, limit = (x.strip() for x in smi.split(",", 1))
    print(f"[tpr] {n_ranks} ranks sharing one {name} ({limit}); the model group's exchange "
          "over gloo through host memory" if torch.cuda.device_count() < n_ranks else
          f"[tpr] {n_ranks} ranks, each on its own {name} ({limit})")
    tpr_logits = {}
    for arch, over, batch, prompt_len, gen_len, _ in TPR_SERVE:
        cfg = get_config(arch).with_overrides(**over)
        model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
        prompts = input_specs(cfg, ShapeConfig("serve", prompt_len, batch, "prefill"),
                              generator=torch.Generator(dev).manual_seed(1), device=dev)
        logits, _ = model.prefill(prompts, prompt_len + gen_len)
        tpr_logits[arch] = logits[:, -1].float().cpu().numpy()
        del model, prompts, logits, _
        gc.collect()
        torch.cuda.empty_cache()
    for arch, over, rows, seq, micro, _, lr, warmup in TPR_TRAIN:
        if arch not in tpr_first:
            tpr_first[arch] = one_rank_step(arch, over, rows, seq, micro, lr, warmup)
    probe_ref = grad_probe(*TPR_PROBE, device="cuda")["sound"]
    torch.cuda.empty_cache()
    print(f"[tpr] one-rank references in {time.perf_counter() - t10:.1f} s (the prefills; "
          f"step 1 of 6(d) and of xlstm-1.3b's fp32 run, {tpr_first}; the probe's fp32 "
          "gradient)")
    mark("10's ranks")
    ranks = spawn_ranks(peaks_rank, n_ranks, ("tpr", tp_recurrent_rank, TPR_SERVE, TPR_TRAIN,
                                               TPR_PROBE), timeout=900)
    for i, (arch, over, batch, prompt_len, gen_len, _) in enumerate(TPR_SERVE):
        check_tp_recurrent_serving([r["serve"][i] for r in ranks],
                                   get_config(arch).with_overrides(**over), batch, prompt_len,
                                   tpr_logits[arch], smi)
    for i, (arch, over, rows, seq, micro, n_steps, _, _) in enumerate(TPR_TRAIN):
        check_tp_recurrent_training([r["train"][i] for r in ranks],
                                    get_config(arch).with_overrides(**over),
                                    (rows, seq, micro, n_steps), tpr_first[arch], smi)
    check_grad_probe(ranks, get_config(TPR_PROBE[0]).with_overrides(num_layers=TPR_PROBE[1]),
                     TPR_PROBE[3], probe_ref)
    rg_serve, rg_train = ranks[0]["serve"][0], ranks[0]["train"][0]
    for name in ("flash_attention", "rglru_scan"):
        records[(name, "recurrentgemma-9b model 2")]["launches"] = rg_serve["launches"][name]
    for name in ("flash_attention", "flash_attention_bwd", "rglru_scan", "rglru_scan_bwd"):
        rec = records[(name, "recurrentgemma-9b model 2 train")]
        rec["launches"] = sum(st[name] for st in rg_train["steps"])
        rec["launches_per_step"] = rec["launches"] // len(rg_train["steps"])
        rec["launches_note"] = f"rank 0's of {n_ranks} ranks"
    for r in ranks:
        print(f"[tpr] rank {r['coords']}: peak memory by job "
              f"{[round(j['peak_gb'], 2) for j in r['serve'] + r['train'] if 'peak_gb' in j]} GB")
    del ranks, rg_serve, rg_train
    print(f"[tpr] recurrentgemma-9b and xlstm-1.3b at published widths cut to 8 layers, served "
          f"and trained on {TPR_MESH[0]} over {TPR_MESH[1]}: phase 10 took "
          f"{time.perf_counter() - t10:.1f} s; {smi}")

    # ------------ 11. pods combined with FSDP and tensor parallelism --
    # llama3.2-1b at published width and depth on (pod 2, data 1, model 2):
    # (a) phase 4's request served, each pod its rows; (b) phase 8's batch
    # trained in every pod mode, held to phase 8's one-rank step 1, and the
    # planted fault; each rank's launches counted from zero.
    held(11)
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    cfg = get_config(POD_TP_TRAIN[0])
    n_ranks = math.prod(POD_TP_MESH[0])
    name, limit = (x.strip() for x in smi.split(",", 1))
    print(f"[podtp] {n_ranks} ranks sharing one {name} ({limit}); the pod and model groups' "
          "exchanges over gloo through host memory" if torch.cuda.device_count() < n_ranks
          else f"[podtp] {n_ranks} ranks, each on its own {name} ({limit})")
    print("[podtp] reckoned before the run, per rank: " + pod_tp_memory(cfg))
    serving, training = SERVE[0][:4], POD_TP_TRAIN
    ranks = spawn_ranks(peaks_rank, n_ranks, ("podtp", pod_tp_rank, serving, training),
                        timeout=900)
    check_pod_tp_serving([r["serve"] for r in ranks], cfg, serving[1], serving[2],
                         tp_ref_logits, served[serving[0]]["tokens"].numpy(), smi)
    check_pod_tp_training([r["train"] for r in ranks], cfg, tp_first,
                          expected_launches(layer_plan(cfg), POD_TP_TRAIN[3]), smi)
    del ranks
    print(f"[podtp] {cfg.name} at published width and depth: served and trained on "
          f"{POD_TP_MESH[0]} over {POD_TP_MESH[1]}: phase 11 took "
          f"{time.perf_counter() - t11:.1f} s; {smi}")

    # ------------------------------- 12. MoE served on (pod, data) rows --
    # deepseek-v2-236b at phase 9's cut on (pod 2, data 1, model 2): phase 9's
    # request served, 2 rows a rank, held to one rank whose MoE routes each
    # pod's model-rank slice as a group; decode's slot offsets probed.
    held(12)
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    cfg = ep_config()
    _, batch, prompt_len, gen_len = EP_SERVE
    n_ranks = math.prod(EP_POD_MESH[0])
    name, limit = (x.strip() for x in smi.split(",", 1))
    print(f"[eppod] {n_ranks} ranks sharing one {name} ({limit}); the pod and model groups' "
          "exchanges over gloo through host memory" if torch.cuda.device_count() < n_ranks
          else f"[eppod] {n_ranks} ranks, each on its own {name} ({limit})")
    ref = ep_serve_reference((batch, prompt_len, gen_len), EP_POD_MESH[0][0], decode=True)
    print(f"[eppod] one-rank reference in {time.perf_counter() - t12:.1f} s")
    # Build the ranks at once only where four ranks' init peaks leave
    # EP_POD_AT_ONCE_FREE of the card free.
    torch.cuda.empty_cache()
    blocks, draw, block = init_need(cfg, EP_POD_MESH)
    need = n_ranks * (blocks + draw + block)
    free, total = torch.cuda.mem_get_info()
    at_once = free - need >= EP_POD_AT_ONCE_FREE
    print(f"[eppod] a rank's init peak, counted on meta: parameter blocks {blocks / 1e9:.3f} GB "
          f"+ the largest whole fp32 draw {draw / 1e9:.3f} GB + its block {block / 1e9:.3f} GB; "
          f"{n_ranks} ranks at once need {need / 1e9:.3f} GB beside the "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB this process holds; mem_get_info free "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB, leaving {(free - need) / 1e9:.2f} GB: the "
          f"ranks build " + ("at once" if at_once else "one at a time")
          + f" (at once where {EP_POD_AT_ONCE_FREE / 1e9:g} GB are left)")
    mark("12's ranks")
    ranks = spawn_ranks(peaks_rank, n_ranks, ("eppod", ep_pod_rank, batch, prompt_len, gen_len,
                                              False, None, at_once), timeout=600)
    check_ep_pod_serving(ranks, cfg, batch, prompt_len, ref, smi)
    del ranks, ref
    print(f"[eppod] {cfg.name} at published widths, {cfg.num_layers} of 60 layers: served on "
          f"{EP_POD_MESH[0]} over {EP_POD_MESH[1]}: phase 12 took "
          f"{time.perf_counter() - t12:.1f} s; {smi}")

    # --------------------------------------------------- 13. the dry run --
    # launch/dryrun.py on this machine's CPU, every tensor on meta: (a) every
    # published config built; (b) the one-card cells that earlier phases
    # measured, each estimate beside its measurement; (c) two production
    # cells' roofline rows.  The cells ran in worker processes started after
    # phase 1 (start_dry_cells).
    dry_run_phase(dry_measured, smi, dry_cells)

    # --------- 14. TP on widths that do not divide over model --
    # xlstm-1.3b (8 blocks, fp32) on (data 1, model 8): its 4 heads over 8
    # ranks; served, trained and its whole wq's gradient probed, each held to
    # phase 10's one-rank references.
    held(14)
    mark("14")
    arch = UNEVEN_SERVE[0][0]
    uneven_phase(smi, tpr_logits[arch], tpr_first[arch])

    # ------------ 15. MoE on counts that do not divide --
    # deepseek-v2-236b at phase 9's cut on ep2d with 16 groups over (data 3,
    # model 1): 160 experts whole on every rank, groups that straddle the
    # data ranks; one row a rank served, held to one rank of the same rows;
    # the ranks' slot offsets probed.
    held(15)
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    cfg = uneven_ep_config()
    batch, prompt_len, gen_len = UNEVEN_EP_SERVE
    n_ranks = math.prod(UNEVEN_EP_MESH[0])
    name, limit = (x.strip() for x in smi.split(",", 1))
    print(f"[unevenep] {n_ranks} ranks sharing one {name} ({limit}); the data group's exchange "
          "over gloo through host memory" if torch.cuda.device_count() < n_ranks
          else f"[unevenep] {n_ranks} ranks, each on its own {name} ({limit})")
    ref = ep_serve_reference(UNEVEN_EP_SERVE, decode=True, cfg=cfg)
    print(f"[unevenep] one-rank reference in {time.perf_counter() - t15:.1f} s")
    torch.cuda.empty_cache()
    blocks, draw, block = init_need(cfg, UNEVEN_EP_MESH)
    need = n_ranks * (blocks + draw + block)
    free, total = torch.cuda.mem_get_info()
    at_once = free - need >= EP_POD_AT_ONCE_FREE
    print(f"[unevenep] a rank's init peak, counted on meta: parameter blocks "
          f"{blocks / 1e9:.3f} GB + the largest whole fp32 draw {draw / 1e9:.3f} GB + its block "
          f"{block / 1e9:.3f} GB; {n_ranks} ranks at once need {need / 1e9:.3f} GB; "
          f"mem_get_info free {free / 1e9:.2f} of {total / 1e9:.2f} GB: the ranks build "
          + ("at once" if at_once else "one at a time")
          + f" (at once where {EP_POD_AT_ONCE_FREE / 1e9:g} GB are left)")
    mark("15's ranks")
    ranks = spawn_ranks(peaks_rank, n_ranks, ("unevenep", uneven_ep_rank, batch, prompt_len,
                                              gen_len, False, None, at_once), timeout=600)
    check_uneven_ep_serving(ranks, cfg, batch, prompt_len, ref, smi)
    records[("flash_attention", f"{cfg.name} data 3")]["launches"] = (
        ranks[0]["prefill_launches"]["flash_attention"])
    del ranks, ref
    print(f"[unevenep] {cfg.name} at published widths, {cfg.num_layers} of 60 layers: served "
          f"on {UNEVEN_EP_MESH[0]} over {UNEVEN_EP_MESH[1]}: phase 15 took "
          f"{time.perf_counter() - t15:.1f} s; {smi}")

    ran = time.perf_counter() - started
    print(f"[time] chip_smoke.py ran {ran:.1f} s"
          + (f", over the {TARGET_S} s target" if ran > TARGET_S else "") + f"; {smi}")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
