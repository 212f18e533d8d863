#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100
and hold its hand-written CUDA kernels against their plain PyTorch
versions.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. setup    print the card (``nvidia-smi``), turn TF32 off, build the
              kernel libraries from ``src/repro_torch/kernels/csrc`` with
              nvcc, one process per source, in parallel; each Hopper flash
              kernel (the forward, the backward's dq and dk/dv), at each
              head dim, must show no spills in ``ptxas -v`` and HGMMA
              (wgmma) in its SASS (``cuobjdump -sass``); each bus
              attention kernel (forward and backward, every dtype, head
              dim and count of 8-key tiles) no spills and its products
              on the tensor cores, HMMA.1688.F32.TF32 (mma.sync m16n8k8
              in tf32) in its SASS; the 3xTF32 flash forward (its split
              and main kernels, D=64 and 128) no spills and tf32 wgmma
              (HGMMA ... F32.TF32) in each main kernel; the 3xTF32 flash
              backward (each call's split, the dq and dk/dv kernels, D=64
              and 128) no spills and tf32 wgmma in each main kernel; the
              PQ scan's
              seven kernels no spills, and 16-byte code loads and float4
              stores (LDG.E.128, STG.E.128) in the tiled kernel's wide
              instantiations; the EmbeddingBag's 13 kernels (the
              forward; the backward's keys, chunk and combine passes) no
              spills.
  1b. gnn     DimeNet (the GNN family) at the width of ``DIMENET`` (6
              blocks, d 128, 8 bilinear, 7 spherical, 6 radial, cutoff
              5.0), f32, TF32 off, seeded random weights, through
              the registry's cells (``configs.get_arch("dimenet")
              .cells[shape]``: ``make_fn()``, ``meta["model_flops"]``) on
              ``gnn_family.train_batch`` at molecule (128 graphs, N 3,840,
              E 8,192, T 16,384), full_graph_sm (N 2,708, E 10,752, T
              32,768, 1,433 features) and minibatch_lg (fanouts 15, 10 on
              a random graph of Reddit's size: N 169,984, E 168,960, T
              262,144, 602 features): 1 warm-up and GNN_TIMED synchronised
              steps each (s/step, valid edges/s and triplets/s, model
              TFLOP/s as the JAX cell counts them, peak memory, finite
              losses, Adam's count). At molecule and full_graph_sm the
              loss and every gradient leaf on the card are first held to
              the port on the CPU on the same weights and batch
              (TOL_GNN_LOSS, TOL_GNN_GRAD). ogb_products must be refused
              by name. No kernel counter may move across the phase: no
              hand-written kernel lies on this path (gathers, scatter-adds
              and GEMMs are PyTorch's own).
  1c. registry every arch of ``configs`` (the ten assigned and
              speedyfeed) runs its reduced smoke on the card, dimenet
              through ``launch.train.main(["--arch", "dimenet"])``; each
              must launch exactly the kernels REGISTRY_KERNELS names for
              its family, which the ``kernels`` line adds under each
              row's ``launches_by_path["registry"]``, by arch. Spies on
              the kernel wrappers (REGISTRY_WRAPPERS) keep the inputs of
              the first call at each shape the smokes give them (the SIMT
              flash pair at the reduced LMs' [4, 32, H, 16] f32 and
              Scout's chunks, the SIMT bus pair at the speedyfeed PLM's
              head dim 8, the EmbeddingBag and its backward at the
              reduced CTR widths); after the smokes each wrapper is held
              to plain on those inputs, within its limit of the plain
              output's (or gradient's) largest magnitude (TOL_FLASH and
              TOL_LSE, TOL_FLASH_BWD, TOL_BUS, TOL_BWD, TOL_RS_BULK,
              TOL_EBAG_BWD), beside a control on broken inputs that must
              miss it; the holds go into the ``kernels`` line as
              ``registry_shapes``, their launches under
              ``check_launches``.
  1d. roofline the dry-run (``launch/dryrun.py``) of every registry cell:
              each non-skipped cell of the eleven archs counted on meta
              tensors on the host (FLOPs by dtype, bytes, peak live
              bytes, against the H100's peaks, TF32 off), with no kernel
              counter moving, in ROOFLINE_WORKERS processes at once (the
              count is Python on the host), all counted before any is
              measured; each that fits one card and has a batch
              builder at its own shape (``Cell.concrete_args``: at least
              ROOFLINE_MUST) measured on the card, one warm-up and 3
              synchronised steps: ``measured_s``, ``achieved``
              (``step_time_lb`` over it) and ``mfu``. A measured step may
              beat neither its counted compute term nor its floor by more
              than ROOFLINE_SLACK (a count that does, is wrong); the CTR
              cells must launch the EmbeddingBag (and, to train, its
              backward), the others no kernel, and the ``kernels`` line
              adds those launches under ``launches_by_path["roofline"]``,
              by cell. One line a cell; every record, its op-class
              breakdown included, in ``chiprun_out/roofline.jsonl``.
  2. slice    the serve path at full width: the production PLM (12
              layers, d 768, 12 heads, d_ff 3072, vocab 30720, K=3, S=32,
              news_dim 768, random weights from a seeded generator) over a
              16,384-news corpus: the two halves of
              ``Recommender.build_index`` timed apart (``_encode_corpus``,
              then ``build_index_from``: the IVF-PQ build), a warm-up
              batch a shape bucket (the scheduler's warm-up calls), 128
              requests through ``micro_batch_loop`` on the
              continuous-batching ``RequestScheduler`` (max batch 16),
              and ``measure_recall`` on a probe of 16. The latencies are
              the registry's ``query_latency_ms``: e2e a request (queued
              plus execute) as ``query_p50_ms`` / ``query_p99_ms``, and
              the batch's execute time as ``query_execute_p50_ms`` /
              ``_p99_ms`` (what ``query_p50_ms`` read before the
              scheduler). The kernels' launch counts are set to 0 just
              before and read just after; both serve kernels must have
              risen.
  3. index    the served IVF-PQ build against the same build of the same
              embeddings on the CPU: the share of residual energy the PQ
              codes lose (``launch.profile.pq_distortion``) within 0.01.
  4. plain    re-run the encode of 512 news with the plain bus attention
              on the card (embeddings within 5e-4), and redo one query
              batch's two stages with the plain LUT scan on the inputs the
              served IVF-PQ search gathers (equal top-k id sets).
  4b. serve-front the serving front end on the slice's Recommender, the
              launch counts set to 0 before and read after: (e) OPQ
              (``PQConfig(opq_iters=2)``) built on the card over the
              slice's embeddings, its PQ distortion within 0.01 of a CPU
              OPQ build's and not above plain PQ's, recall@10 of both
              read (not held); (b) ``open_loop_harness`` with
              ``--rebuild-mid-loop``, ``--slo-ms`` 50, 2 s a point, at
              0.25x, 0.5x and 1.5x of the closed loop's sustained rate
              (16 requests over its execute p50), then a
              ``during_rebuild`` point at 0.5x while a churn thread
              publishes and fully rebuilds: nothing rejected or late at
              0.25x, rejects or late-drops at 1.5x, finite goodput and
              percentiles, at least one swap inside the rebuild point's
              window; every point on its own line and merged into
              ``chiprun_out/serve_sweep.json``; (c) the same harness with
              ``--chaos-rebuild-failures 2`` at 0.5x, 1 s a point: the
              plan fires twice, the index health goes degraded and back,
              ``health()`` ends healthy, every point served with no
              error; (d) a service over the same store and snapshot with
              a delta hard cap of 8: the publish past it raises
              ``BackpressureError`` and leaves the store and view as they
              were, queries still answer; (f) ``--autotune`` over nprobe
              {4, 8, 16, 32} x k' {40, 64, 128}, the grid printed and the
              winner installed. Every scan of the phase on the tiled PQ
              kernel; then that kernel held to plain (TOL_PQ) at B = 1,
              2, 4, 8 on the served snapshot's codes and at B=16 on the
              OPQ snapshot's rotated LUT. Prints the phase's seconds.
  5. train    Algorithm 1 at PROD, full width and depth (E=4096 encoded
              news per step, remat on): ``Trainer.fit`` for 4 steps over
              the DynamicBatcher on the slice's store with the paper's
              token budget of 39,800. Finite losses, moved parameters,
              cache rows written = news encoded, and launch counts of
              exactly 2 x 12 x steps forward (remat runs it twice) and
              12 x steps backward bus kernels. Then 3 synchronised
              ``Trainer.step`` calls on one top-bucket batch: s/step,
              encoded rows/s, peak device memory.
  6. plain    one train step at PROD widths with E cut to 256, through the
     (train) kernels and through the plain path on the same parameters,
              batch and draws: loss within 1e-4, every gradient leaf
              within 1e-3 of that leaf's largest magnitude.
  7. ckpt     checkpoints, resume and supervised restarts at PROD on the
              train phase's store and batcher, under build/ckpt_smoke
              (removed at the end): free disk of at least 2.5 x the
              snapshot's bytes; ``save_state`` of the train phase's final
              state, ``restore_state`` into ``init_state(seed=1)`` (every
              leaf ``torch.equal``, the same step and generator state);
              one ``Trainer.step`` on the top-bucket batch from the
              restored and from the saved state (the same loss within
              1e-4, reported bit for bit or as its difference); the
              ``AsyncCheckpointer``'s host snapshot and write. Then
              ``fit_supervised`` of a new PROD trainer for 4 steps,
              checkpointing every 2, with a fault armed at ``train.step``
              step 3: 1 restart, resumed from step 2, 4 steps done, finite
              losses, and, counted around that fit alone, exactly 2 x 12 x
              5 forward and 12 x 5 backward bus launches (3 steps before
              the crash, 2 after the resume), none on the SIMT pair.
              Prints the snapshot's bytes and the seconds and GB/s of the
              save, the restore and the async snapshot beside the card.
  7b. mesh    SpeedyFeed on a data mesh, on the one card (the machine has
              one H100, so NCCL across cards is not exercised here), after
              the train phase's state is freed. (a) The served IVF-PQ
              snapshot and an IVF-Flat build of the same embeddings (nlist
              64, nprobe 16), each ``shard_snapshot`` over MESH_SHARDS
              devices (``cuda:0`` repeated): the serving batch's top-10
              ids equal to the unsharded snapshot's, scores within 1e-4 of
              the largest (at least 1); a sharded IVF-PQ search launches
              the tiled PQ scan once a shard (counted from 0 around one
              search), each shard's scan held to plain (TOL_PQ) on its own
              window; ``unshard_snapshot`` gives the build back. (b)
              ``run_on_mesh`` spawns MESH_RANKS gloo ranks on ``cuda:0``
              (on a thread: they import and join their group while the
              parent runs the one-process PROD step from ``init_state(0)``
              on the top-bucket batch with seeded draws injected, 3 steps,
              then frees what it holds, prints what stays resident and
              lets them allocate), each the ``"speedyfeed"`` Trainer on
              its mesh from the same state, batch and draws (1 warm-up,
              MESH_TIMED synchronised steps, each rank encoding E /
              MESH_RANKS rows): every rank's losses within TOL_MESH of the
              one process's; after the first step the ranks' parameters
              equal and within TOL_MESH of each leaf's largest magnitude
              of the one process's (the leaves that start at 0, the
              biases, against the largest of any leaf: Adam's first step
              on a near-eps gradient), each rank's cache block the one
              process's rows (written_step exactly); each rank exactly 2 x
              12 forward and 12 backward bus launches a step (remat), none
              on the SIMT pair, added to the bus rows'
              ``launches_by_path["mesh"]``; each rank's peak memory and
              the step time. A checkpoint of the mesh state (rank 0
              gathers the cache rows and writes under
              build/mesh_ckpt_smoke, removed after), restored in the
              parent on one device, every leaf's digest the mesh's. One
              ``compressed_all_reduce`` of seeded CUDA gradients (PROD's
              attention and FFN shapes) across the ranks, within one
              quantisation step of numpy's evaluation of JAX's formula.
              Prints the phase's seconds, held under MESH_PHASE_S.
  8. conventional the conventional workflow (the paper's baseline) at
              PROD, full width and depth, remat, f32: the registry's
              ``"speedyfeed_conventional"`` Trainer and one
              ``build_conventional_batch`` of ``CONV_ONE_CARD``'s 32 users
              (the first 32 histories with at least 2 clicks; 32 x (100 +
              2) = 3,264 news a step, pad slots included) on the slice's
              store. One warm-up and CONV_TIMED synchronised
              ``Trainer.step`` calls: finite losses, moved parameters, the
              cache untouched (the same tensors, still blank), and, counted
              around the timed steps, exactly 2 x 12 forward and 12
              backward bus launches a step, none on the SIMT pair; s/step,
              news encoded a second, clicks a second, data efficiency and
              the peak device memory (under 80 GB) beside the card. Then
              one conventional loss and its gradients at 4 users (408
              news), through the kernels and through ``impl="plain"`` on
              the trained parameters: loss within 1e-4, every gradient leaf
              within 1e-3 of its magnitude (the key biases ~0). The bus
              kernels are held to plain at the step's own M=3,264 in
              phase 14.
  9. lm       the LM family's serving path: Qwen3-14B at full width and
              depth (40 layers, d 5120, 40/8 heads of 128, d_ff 17,408,
              vocab 151,936, qk-norm) in bf16, random weights from a
              seeded generator. One warm-up and one timed prefill at B=1,
              S=32,768 (exactly 40 launches of the Hopper flash forward,
              none of the SIMT one; finite last-row logits); 32 greedy
              decode steps at B=16 against an 8,192-slot bf16 KV cache,
              then 8 against the int8 cache (no flash launch); prefill
              of B=4, T=64 against the logits of
              the T-th decode step from an empty cache, and a prefill at
              S=2,048 through the kernel against ``impl="plain"``: in
              bf16 (logits reported; every layer's attention output,
              kernel vs plain on the same input, within TOL_ATTN_BF16),
              then with the weights cast to f32 in place, each within
              TOL_LM_REL_F32 of the largest logit; bf16 goes through the
              Hopper flash forward, f32 through the 3xTF32 one.
  9b. lm-moe  the MoE members of the LM family, after the lm phase's
              weights are freed: (a) first the chunked-local route
              (``nn.attention.chunked_flash``, one flash launch over the
              hard chunks) against plain at Scout's 40/8 heads of 128,
              B=1, S=16,384, chunk 8,192, in f32 and bf16, plain taken a
              chunk at a time in query blocks of 512 (TOL_FLASH; bf16
              also element-wise, beside the dropped-key-tile control).
              Then DBRX-132B and Llama-4-Scout, each at full width and its
              ``lm_family.ONE_CARD_SERVE`` depth (6 of 40 layers; 8 of 48,
              two super-blocks of 3 chunked-local and 1 global NoPE
              layer), bf16, seeded random weights, through ``make_fn``:
              init seconds and parameter GB; a warm-up and a timed
              prefill at B=1, S=32,768 (tokens/s, peak GB, finite
              last-row logits; exactly L Hopper flash forward launches, 6
              and 8, Scout's 6 local ones on [4, 8,192] views; the dropped
              assignments per layer, from ``_route``'s experts and
              ``capacity_for``); decode, no flash launch: DBRX 32 greedy
              steps at B=16 on 8,192 slots, Scout 8 steps at B=16 on a
              seeded 16,384-slot cache from slot 12,288 and 8 at
              long_500k's B=1 on 524,288 slots from slot 524,280 (17.2 GB
              of cache), each under 80 GB. (d) Layer by layer in bf16 at
              the cut, S=2,048: each layer's attention output, kernel vs
              plain on the same input, within TOL_ATTN_BF16, the carried
              gap read. Then the first MOE_CHECK_DEPTH layers cast to f32
              (DBRX 2, Scout 4): (b) prefill of B=1, T=8 against the 8th
              decode step from an empty cache and (c) prefill at S=2,048
              through the kernel against ``impl="plain"``, each within
              TOL_LM_REL_F32 of the largest logit, with the (layer,
              token) expert sets that differ between (c)'s two runs read.
  10. lm-train the LM family's training path: Qwen3-14B at full width, 8
              of its 40 layers, bf16 parameters and f32 Adam moments
              (seeded), B=2 at train_4k's S=4,096 (labels the tokens
              shifted left, -100 last), through ``make_fn(cfg,
              "train")``: 1 warm-up and 3 synchronised timed steps
              (s/step, tokens/s, peak memory, model TFLOP/s as the JAX
              cell counts them), finite losses, every leaf's moments
              written and every matrix moved, ``count`` 4, and exactly 16
              Hopper flash forward (with the remat recompute), 8 Hopper dq
              and 8 Hopper dk/dv launches per step (the f32 check below:
              the 3xTF32 forward and the 3xTF32 backward). One more bf16
              step captures
              layer 0's attention inputs and the dO the loss sends back
              to them (a spy on ``ops.flash_attention`` and a hook on its
              output); the Hopper backward on them, with dO brought to
              unit RMS by a power of two (the gradients scale exactly in
              both versions), is held to plain as at the train shape
              below. Then at
              depth 2: one step with
              ``accum_steps=2`` (twice the launches), and, in f32 with
              TF32 off at B=1, the loss and every gradient leaf through
              the kernels against ``impl="plain"`` (TOL_LOSS, TOL_GRAD);
              then, on those gradients, the in-place Adam over each leaf
              it splits into row chunks (embed, head, FFN) against the
              same update of the whole leaf and against Adam in f64
              (TOL_ADAM).
  10b. lm-mesh the LM family on a (data=2, model=2) mesh: LM_MESH_RANKS
              gloo ranks share the one card (``run_on_mesh(...,
              model=2)``), started once for the whole phase while the
              parent runs its one-process references, then waiting for a
              ``go`` file before they allocate. Parameters drawn placed by
              ``lm_family.init_placed`` (``lm_rules(fsdp=True)``: tensor
              parallel over ``model``, FSDP over ``data``), one rank at a
              time. (a) Holds, f32, TF32 off, at the depths of
              LM_MESH_HOLD and full width: Qwen3-14B, and DBRX-132B
              (``moe_impl="ep"`` -> ``nn.moe_ep``; its train hold at d_ff
              LM_MESH_DBRX_DFF: a full-width layer's f32 Adam state is 71
              GB in one process), each ``make_fn(cfg, "prefill", mesh)``
              at B=2, S=LM_MESH_HOLD_SEQ, 4 decode steps on a
              LM_MESH_HOLD_SLOTS-slot cache, and 2 steps of
              ``make_fn(cfg, "train", mesh)`` from Adam's count at
              LM_MESH_OPT_COUNT, against one process on the card running
              the same functions on the same draws (for DBRX each data
              half alone, its own capacity and balance loss, the train
              loss their mean: the mesh's routing). Logits, losses,
              global grad norms, and every parameter leaf before and after
              the steps and both moments after them (read at up to
              LM_MESH_SAMPLE evenly spaced elements, each rank its own
              block's) within TOL_LM_MESH of the largest; each leaf's
              change within TOL_LM_MESH["change"] of the norm of one
              process's change, a limit the state left unchanged must
              miss. (b) bf16 at full width, after a warm-up of the Hopper
              flash kernels alone, the launch counts set to 0 just before
              and read just after, per rank, each run timed once between
              barriers (the slowest rank's) with each rank's peak memory:
              on (2, 2), Qwen3-14B prefill at LM_MESH_PREFILL_LAYERS of
              its 40 layers (B=2, S=LM_MESH_PREFILL_SEQ; the depth cut
              for the smoke's time) and a train step at
              LM_MESH_TRAIN_LAYERS of ONE_CARD_TRAIN's 8 (B=2, S=4,096;
              cut for the same reason); on the world re-cut as a (data=1,
              model=4) mesh, where nothing is gathered over ``data``, a
              Qwen3-14B decode step at B=16 on 8,192 slots, DBRX at
              ONE_CARD_SERVE's 6 layers, prefill and a decode step the
              same, and a DBRX train step at 1 layer (an FSDP decode
              gathers every layer each step through the host, ~25 s on
              (2, 2); DBRX's 54 GB of train state and the four ranks'
              gathered layers pass the card there). The flash launches,
              exactly the plan's, go to the flash rows'
              ``launches_by_path["lm_mesh"]`` by rank. Each run's first
              flash forward and backward (a rank's own heads and batch:
              Qwen3-14B 20/4 heads, DBRX 12/2) are kept on the host, then
              held to plain one rank at a time: the forward launched again
              on its inputs, its first, a middle and the last FLASH_ROWS
              rows against plain (TOL_FLASH and the element-wise bf16
              limit, with the dropped-key-tile control), the backward as
              the lm-train phase's layer-0 check (dO brought to unit RMS
              by a power of two; f32 before the cast and the casts
              element-wise, with the controls); their launches apart,
              under the rows' ``check_launches["lm_mesh_bf16_holds"]``.
              (c) The head plan: the ranks re-cut as a (data=1,
              model=4) mesh hold ChatGLM3-6B (32 query heads over 2 KV
              heads: each KV head replicated over 2 ranks, 8 query heads
              a rank) at LM_MESH_HEADS_HOLD's depth, full width, f32, as
              (a) holds Qwen3-14B: prefill, 4 decode steps and 2 train
              steps against one process; its parameters and moments
              within TOL_LM_MESH of each leaf's largest or
              LM_MESH_FLOOR_X times one process's own spread (its train
              steps again on the batch's two halves), the larger; the
              biases that start at 0 against the part's largest leaf and
              the key bias's parameters (LM_MESH_NOISE) by no element;
              the control: the same steps without the sum of each KV
              head's gradient over the ranks that share it, whose k and
              v leaves must miss the change limit.
  10c. flash-groups the flash pair at the head plan's rank shapes, where
              the Hopper and 3xTF32 kernels map Hq query heads to one KV
              head (Qwen3-14B and Scout at model=16: 3 and 2): at
              [FLASH_GROUP_B, FLASH_GROUP_S, Hq, 1, FLASH_GROUP_D], Hq
              in FLASH_GROUP_HQ, bf16 and f32, the forward and the
              backward against plain with the kernel rows' limits and
              controls (``flash_group_holds``); their launches apart,
              under the four rows' ``check_launches["flash_groups"]``.
  11. recsys  the recsys family's serving path at full width, f32,
              seeded random weights, batches from ``recsys_synth``:
              DLRM-RM2 (26 fields, criteo_like_vocab, d 64: a fused
              32,710,656 x 64 table, 8.37 GB), Wide&Deep (40 fields, d
              32, nnz 2, plus the d=1 wide table) and DCN-v2 (d 16, 3
              cross layers of 429), each through ``make_fn``: serve_p99
              (B=512, p50/p99 over RS_P99_CALLS synchronised calls after
              3 warm-ups) and serve_bulk (B=262,144, samples/s), the
              EmbeddingBag launches per forward (1, 2, 1) and per cell,
              peak memory; DLRM-RM2's retrieval_cand (1 query against
              10^6 x 128 candidates, top-100). Kernel vs plain: the p99
              logits within TOL_RS_LOGITS of the largest, the bulk
              lookups within TOL_RS_BULK; on the fused table the last
              row, negative indices and out-of-range -> NaN; a bf16 table
              within TOL_RS_BF16; the kernel's row timed at serve_bulk's
              shape. BERT4Rec (3M items, d 64, seq 200): serve_p99 (B=512
              against the whole catalogue) and retrieval_cand, 0 kernel
              launches, its first rows against the same serve on the CPU;
              its serve_bulk would need a 3.1 TB score matrix and is left
              out. Each config's tables are freed before the next.
  12. recsys-train the recsys family's training path at full width, f32,
              seeded random weights, ``recsys_synth`` batches at
              train_batch's B=65,536: first the EmbeddingBag backward
              kernel against its plain version in f64 (within
              TOL_EBAG_BWD of the largest |g|; a bf16 dout within one
              bf16 ulp plus that), each launched twice (bit for bit) and
              with untouched rows 0: at DLRM-RM2's train shape ([65,536,
              26, 1], d 64, V 32,710,656), all slots on one row, negative
              and out-of-range indices, bf16, and the Wide&Deep wide
              table (d 1, nnz 2); timed there beside plain, the byte
              bound, ``index_add_`` into zeros and ``F.embedding_bag``'s
              backward. Then DLRM-RM2, Wide&Deep, DCN-v2 and BERT4Rec
              through ``make_fn(cfg, "train")`` with ``adam_init``'s
              state: for each CTR config one step's gradients through
              the kernels against ``impl="plain"`` (each leaf within
              TOL_RS_TRAIN_GRAD of its largest magnitude); 1 warm-up and
              RS_TRAIN_TIMED synchronised steps (BERT4Rec's step takes
              the batch as B4R_ONE_CARD_ACCUM = 16 microbatches of
              4,096: ``optim.make_train_step`` over ``bert4rec.loss``
              with RS_OPT and that ``accum_steps``), with the counts
              set to 0 just before and read just after: s/step,
              samples/s, peak memory above what was resident (under 80
              GB in all), finite losses, every leaf moved, Adam's count,
              and exactly 1, 2, 1, 0 launches of ``embedding_bag`` and
              of ``embedding_bag_bwd`` a step. Each config is freed
              before the next.
  12b. recsys-mesh the recsys family on a (data, model) mesh:
              RS_MESH_RANKS gloo ranks share the one card
              (``run_on_mesh(..., model=2)``), started once for the
              phase while the parent runs each run of RS_MESH_PLAN in one
              process on the card, then waiting for a ``go`` file. All
              four configs at full width, f32, TF32 off, seeded weights
              (``recsys_family.init_placed``: ``recsys_rules``, the
              tables cut by rows over ``model``, one rank drawing at a
              time), ``recsys_synth`` batches, through ``make_fn(cfg,
              kind, mesh=)``: DCN-v2 and Wide&Deep on (2, 2), serve_p99
              (B=512) and a train hold; DLRM-RM2 serve_p99 and
              retrieval_cand (1 query, 10^6 x 128 candidates over the
              data axes) on (2, 2), its train hold on the world re-cut as
              (1, 4) (its 8.37 GB table, gradient and moments a quarter a
              rank); BERT4Rec ``serve_sharded`` at B=512 on (1, 4) and
              (2, 2), a serve_bulk cut of RS_MESH_BULK_B (of 262,144;
              its [B, 3M] scores would be 196 GB) on (2, 2), its first
              RS_MESH_BULK_HELD rows of each data block held to one
              process's ``serve`` on those rows, retrieval_cand and a
              train hold of RS_MESH_B4R_MICRO microbatches of 4,096
              (``accum_steps``, B4R_ONE_CARD_ACCUM's microbatch) on (2,
              2). The CTR train holds take RS_MESH_TRAIN_B (a cut of
              train_batch's 65,536). Holds against one process: logits
              within TOL_RS_MESH["logits"] of the largest; top-100 ids
              equal (as sets over scores tied within the limit), scores
              within TOL_RS_MESH["scores"]; a train hold's 2 steps:
              losses within TOL_RS_MESH["loss"]; at the first step each
              leaf (the parameters before and after it, its gradient as
              Adam gets it, both moments after it) read at up to
              RS_MESH_ROWS of the rows the batch names in a table and
              LM_MESH_SAMPLE positions elsewhere, each rank its own,
              within TOL_RS_MESH["leaf"] of the leaf's largest; over
              both steps each leaf's change within TOL_RS_MESH["change"]
              of the norm of one process's, which the unchanged state
              must miss (the parameters after the second step read,
              not held element by element: ``rs_mesh_train_holds``).
              One call or
              step each timed between barriers (serve and retrieval after
              a warm-up call, the hold's second step; the slowest
              rank's), each rank's peak memory (x RS_MESH_RANKS under 80
              GB). The EmbeddingBag launches of each rank, set to 0 just
              before the runs and read just after, exactly
              ``rs_mesh_expected_launches``, under the rows'
              ``launches_by_path["recsys_mesh"]`` by rank; each rank's
              first forward and backward kept on the host and held to
              plain one rank at a time at the rank's shapes
              (``registry_hold``: 1e-6 and 1e-5 of the largest, each
              beside a control that must miss), their launches apart
              under ``check_launches["recsys_mesh_holds"]``.
  12c. gnn-mesh DimeNet on a mesh: GNN_MESH_RANKS gloo ranks share the
              one card, DimeNet at GNN_MESH_CELL (minibatch_lg) at full
              width (6 blocks, d 128), f32, TF32 off, on each (data,
              model) mesh of GNN_MESH_SHAPES ((4, 1) and (2, 2), the
              world re-cut by ``submesh``), through
              ``gnn_family.make_fn(cfg, "train", mesh=)``: the parameters
              whole on every rank, the batch whole, each rank's block of
              the edges and triplets (``gnn_batch_specs``). The parent
              builds the batch (seed GNN_SEED) and draws the parameters
              (a CPU generator of seed 0) once, and the ranks load both;
              while they start it runs one process on the card: in f64
              the loss and each gradient leaf (held to the port on the
              CPU in f64 within TOL_GNN_MESH: the gnn phase's CPU check,
              at minibatch_lg) and GNN_MESH_STEPS steps, then in f32
              GNN_MESH_STEPS timed steps. Each mesh against it, in f64:
              the loss, each gradient leaf as Adam takes it
              (``sync_grads`` over ``dimenet.grad_axes``) and each
              leaf's change over the steps within TOL_GNN_MESH (the
              unchanged state must miss), every rank's the same; then
              the f32 steps, each timed between barriers (the slowest
              rank's), their losses read, each rank's peak memory (x
              GNN_MESH_RANKS under 80 GB); no kernel launched (DimeNet's
              path has none).
  13. quality the paper's quality experiments. (a) The news baselines
              (``models.news``: NPA, NAML, LSTUR, NRMS) at
              ``NewsBaselineConfig``'s full defaults (vocab 30,522,
              100,000 users, d 64, 4 heads, CNN width 3, 3 views, f32) on
              one ``build_conventional_batch`` at CONV_BATCH (512 users,
              L=100, 2 candidates, K=3 x S=32: 52,224 news a step;
              ``user_id`` as table3 sets it): the slice's corpus with a
              click log of 512 users of its own (the slice's log has
              400), tokenized at the baselines' vocabulary. For each, one
              step's loss at QUALITY_CPU_USERS users on the card against
              the CPU's (TOL_QUALITY_CPU), then through
              ``optim.make_train_step`` with table3's Adam (lr 1e-3) one
              warm-up and QUALITY_TIMED synchronised steps: finite
              losses, every leaf moved but an attention's key bias (an
              exactly-0 gradient), no kernel launched (NRMS's attention is
              masked: plain, never flash), s/step, clicks/s, news/s and
              the peak memory. (b) PROD with ``user_kind="nrms"`` (4
              heads of 192) through the ``"speedyfeed"`` Trainer on the
              train phase's top-bucket batch: one warm-up and
              QUALITY_TIMED ``Trainer.step`` calls, finite losses, the
              user self-attention's leaves moved, exactly 2 x 12 forward
              and 12 backward bus launches a step. (c) ``python -m
              repro_torch.launch.tables`` at ``bench`` (its ``main``, on
              the card, writing ``chiprun_out/tables.jsonl``): every
              table's rows printed on lines of their own, 25 finite
              rows, accuracies in [0, 1], and exactly the bus launches
              its runs make (2 layers a step of each Algorithm-1 run with
              the bus, its warm-up included; 2 a fig9 encode at K > 1),
              none on the SIMT pair. Prints the phase's seconds.
  14. kernels each kernel against its plain version at the main paths'
              shapes, timed with CUDA events beside its bound and a
              PyTorch call as a yardstick (for the bus kernels
              ``F.scaled_dot_product_attention``'s forward and backward,
              the forward held and timed at the serve chunk, M=256, and
              at the train step's shape, M=4096, the backward at the
              latter, and both held (not timed) at the conventional
              step's M=3,264 and at every bucket S of the fit's batcher,
              M=64, and at the quality phase's shapes, M=256 at 4 heads
              of 16 with the bench buckets and fig9's splits of 48
              tokens (K x S = 3 x 8, 3 x 16, 2 x 24, 4 x 12, 6 x 8);
              each launched twice on the same
              inputs, which must agree bit for bit, beside a control
              that must miss its limit: plain with the bus columns' v
              zeroed; every one of these launches checked to be on the
              tensor-core pair; the SIMT pair, the route for shapes the
              tensor-core kernels do not take, held and timed the same
              way at S=64, its ``launches`` 0 on the main paths,
              for flash its causal forward and, for the flash backward,
              its causal GQA backward on the same data, for the
              EmbeddingBag ``F.embedding_bag``). The PQ scan's two
              kernels (``pq_route``: the tiled one takes the serve path,
              the general one the other shapes) at the serve path's own
              inputs (the query batch's LUT and codes off the snapshot,
              and shared codes) and at two deployment shapes over PROD's
              1,204,224 news, seeded: IVF (nlist 64, nprobe 16, cap
              32,768: N = 524,288) and flat (codes shared by 16 queries);
              at each, both kernels held to plain within TOL_PQ on the
              codes and on a copy with codes past K (NaN and -inf slots
              exact), each launched twice (bit for bit), and timed in
              turns (general, tiled, tiled, general), beside plain, the
              byte bound and, flat, ``F.embedding_bag`` over offset codes.
              The flash forward on its three routes: the 3xTF32 kernel in
              f32 at S=4,096, timed in turns against the SIMT kernel named
              on the same call; the SIMT kernel on its own route, f32 at
              head dim 96 (timed) and bf16 at 80; the Hopper kernel in
              bf16 at S=4,096 (Sq = Sk and Sq = S/4), at the prefill shape
              (the launch held to plain on its first, a middle and its
              last FLASH_ROWS rows), at the lm-moe prefills' shapes (DBRX's
              48/8 heads over S=32,768; Scout's chunked route, [4, 8,192]
              at 40/8 heads; held the same way on the last chunk, timed
              beside SDPA) and timed at the train shape; the bf16
              checks are element-wise, each beside a control that must
              fail them. Every flash forward launch is expected on the
              route ``forward_route`` picks. The main paths are bf16 at
              head dim 128, so the 3xTF32 and SIMT rows' ``launches`` are
              0; the f32 LM and train checks' 3xTF32 launches and the SIMT
              checks' own, each counted from 0, stand under
              ``check_launches``. The flash
              backward at the train shape on each route
              (``backward_route``), on that dtype's forward o and lse:
              f32 on the 3xTF32 pair (1e-4 of each gradient's largest,
              beside a control that drops the last key tile and must miss
              it, launched twice bit for bit, timed in turns against the
              SIMT pair named on the same call); bf16 on the Hopper pair,
              whose f32 gradients before the wrapper's cast are held
              within the same 1e-4 of plain's f32 ones and whose casts
              element-wise, beside controls that drop the last key tile
              and must miss both (the casts' flat difference and plain's
              own distance from the gradient in f64 are read beside
              them); each timed beside plain and SDPA's backward in its
              dtype; the SIMT pair on its own route, f32 at head dim 96,
              held the same way and timed. The 3xTF32 and SIMT rows'
              ``launches`` are 0 on the main paths (bf16) as the
              forward's, their checks' under ``check_launches``.

The line before the last holds the card's name and power limit, the one
before it the per-kernel JSON; the last line is the ``{"ok": true, ...}``
object. Details also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_NEWS = 16384
N_REQUESTS = 128
BATCH = 16
TOL_BUS, TOL_PQ, TOL_ENCODE = 2e-4, 1e-5, 5e-4
TOL_DISTORTION = 0.01            # share of residual energy PQ codes lose
TOL_BWD = 1e-4                   # backward kernel vs plain, f32
TOL_LOSS, TOL_GRAD = 1e-4, 1e-3  # train step, kernel vs plain path
TRAIN_STEPS, TIMED_STEPS, PLAIN_E = 4, 3, 256
# the conventional phase: timed steps after one warm-up, and the users of
# the kernel vs plain check (4 x (100 + 2) = 408 news)
CONV_TIMED, CONV_PLAIN_USERS = 2, 4
# the quality phase: timed steps after one warm-up (the baselines and the
# NRMS-user PROD step); the users whose loss on the card is held to the
# CPU's within TOL_QUALITY_CPU (f32 with TF32 off, sums in other orders);
# the seed of the baselines' click log over the slice's corpus
QUALITY_TIMED, QUALITY_CPU_USERS, QUALITY_LOG_SEED = 2, 4, 1
TOL_QUALITY_CPU = 1e-5
# the serve-front phase: the open-loop sweep's offered rates as shares of
# the closed loop's sustained rate (BATCH requests over its execute p50),
# seconds a point, the SLO; the chaos run's injected rebuild failures, its
# rate share and seconds a point; the backpressure service's delta hard
# cap; OPQ's alternations; the scan's batch buckets held to plain
FRONT_RATE_SHARES = (0.25, 0.5, 1.5)
FRONT_DURATION_S, FRONT_SLO_MS = 2.0, 50.0
CHAOS_FAILURES, CHAOS_DURATION_S = 2, 1.0
BACKPRESSURE_CAP, OPQ_ITERS = 8, 2
FRONT_SCAN_BATCHES = (1, 2, 4, 8)
# the ckpt phase: free disk for two snapshots and a half (the supervised
# fit holds two on disk at once); a fit of CKPT_STEPS checkpointing every
# CKPT_EVERY, crashed once after step CKPT_CRASH_AT
CKPT_DISK_FACTOR, CKPT_STEPS, CKPT_EVERY, CKPT_CRASH_AT = 2.5, 4, 2, 3
TOL_FLASH = {"float32": 2e-4, "bfloat16": 2e-2}   # the JAX tests' own
# bf16 flash output, element-wise, on top of the flat limit: both versions
# round an f32 result to bf16, so they differ by at most one bf16 ulp,
# which is at most 2^-7 of the value (the absolute term covers values
# near 0). A flat 2e-2 is close to a typical |o| (~0.03 at S=4,096), so
# a key tile's PV dropped would pass it; each check also runs such a
# control through the plain version and fails if the limit misses it.
RTOL_FLASH_BF16, ATOL_FLASH_BF16 = 2.0 ** -7, 1e-4
TOL_LSE = 1e-4                   # f32 in both versions, sums reordered
FLASH_ROWS = 512                 # rows of the S=32,768 launch held to plain
# the flash forward's three routes (kernels/flash_attention.py:
# forward_route): the SIMT kernel (head dims other than 64 and 128), the
# Hopper kernel (bf16 at 64 or 128) and the 3xTF32 kernel (f32 at 64 or
# 128); then the backward's (backward_route), by the same rule: the SIMT
# dq and dk/dv kernels, the Hopper pair and the 3xTF32 pair
FLASH_FWD = ("flash_attention", "flash_attention_wgmma",
             "flash_attention_tf32")
FLASH_BWD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq_wgmma", "flash_attention_bwd_dkv_wgmma",
             "flash_attention_bwd_dq_tf32", "flash_attention_bwd_dkv_tf32")
FLASH_KERNELS = FLASH_FWD + FLASH_BWD
# the Hopper kernels' libraries, whose ptxas and SASS the setup checks:
# the flash kernels' (wgmma) and the bus attention kernels' (mma.sync in
# tf32: 2 kernels x 3 dtypes x 4 head dims x 4 counts of 8-key tiles)
HOPPER_LIBS = ("flash_attention_wgmma", "flash_attention_bwd_wgmma")
# the 3xTF32 flash forward's library (its main kernel's products are tf32
# wgmma, HGMMA...F32.TF32 in SASS) and the PQ scan's (the tiled kernel's
# 16-byte code loads and float4 stores, LDG.E.128 and STG.E.128)
TF32_LIB, TF32_MMA = "flash_attention_tf32", "F32.TF32"
# the 3xTF32 flash backward's library: each call's split and the dq and
# dk/dv kernels, at D=64 and 128; tf32 wgmma in both main kernels
TF32_BWD_LIB = "flash_attention_bwd_tf32"
PQ_LIB, PQ_SASS = "pq_scoring", ("LDG.E.128", "STG.E.128", "LDS")
EBAG_LIB = "embedding_bag"      # the EmbeddingBag forward and backward
# the SIMT forward's own checks, at shapes still on its route: f32 at head
# dim 96 (timed) and bf16 at head dim 80
SIMT_CHECKS = (("float32_d96", "float32", 96), ("bfloat16_d80", "bfloat16",
                                                80))
# the SIMT backward's own check, at a shape still on its route: f32 at
# head dim 96, the train shape's batch and heads (held and timed)
SIMT_BWD_CHECKS = (("float32_d96", "float32", 96),)
BUS_LIB, BUS_INSTANTIATIONS, BUS_MMA = "bus_attention", 96, \
    "HMMA.1688.F32.TF32"
# the bus kernels at each of the fit's buckets: news a check (the bucket's
# own compiled kernel is held to plain; the timed rows stay at S=32); and
# the segment length at which the SIMT pair is held and timed (PROD's
# widths, a segment longer than the tensor-core kernels take)
BUS_BUCKET_M, BUS_SIMT_S = 64, 64
# LM logits, kernel path against decode or plain, relative to the largest
# |logit|. In bf16 the paths round at other places (the decode's einsums
# round to bf16, the kernel accumulates in f32), and at depth 40 with
# random weights that rounding moves the logits by several % of the
# largest: bf16 logits are reported, and the same comparisons with the
# weights cast to f32 are held to TOL_LM_REL_F32. What is held in bf16 is
# each layer's attention output, kernel against plain on the same input
# (the plain path's hidden state), relative to its largest value: one
# ulp of rounding before the output projection and one after it, within
# TOL_ATTN_BF16; the hidden-state gap the layers accumulate is reported
# beside it.
TOL_LM_REL_F32 = 1e-3
TOL_ATTN_BF16 = 2.0 ** -6
LM_PREFILL_SEQ = 32768           # prefill_32k's sequence; batch cut 32 -> 1
LM_DECODE_BATCH, LM_DECODE_SLOTS = 16, 8192   # decode_32k cut: 128, 32,768
LM_DECODE_STEPS, LM_Q8_STEPS = 32, 8
LM_CHECK_B, LM_CHECK_T, LM_PLAIN_SEQ, FLASH_CHECK_SEQ = 4, 64, 2048, 4096
# the lm-moe phase, the MoE configs at lm_family.ONE_CARD_SERVE's depths.
# Scout's decode runs (batch, slots, first slot, steps, cache filled from
# a seeded generator): decode_32k's B cut 128 -> 16 over 16,384 slots from
# slot 12,288 (its local layers read a trailing window of 8,192, its
# global ones 12,289 entries), and long_500k whole (B=1, 524,288 slots,
# 17.2 GB of cache) from slot 524,280. The chunked route is held to plain
# at S=16,384 (two chunks of 8,192) in query blocks of 512 (the whole
# chunked logits would be three 21.5 GB copies). Prefill against decode
# at B=1, T=8 stays inside the first chunk with at most 8 tokens a call,
# where no expert can overflow its 8 slots: past the chunk the prefill's
# hard chunks and the decode's trailing window are different functions,
# and a call's capacity depends on its token count (both as in the JAX
# package). Those checks and kernel vs plain at S=2,048 run in f32 at
# the first MOE_CHECK_DEPTH layers (31 and 43.5 GB of f32 weights).
MOE_SCOUT_DECODE = (16, 16384, 12288, 8, True)
MOE_LONG_DECODE = (1, 524288, 524280, 8, True)
MOE_CHUNK_CHECK_SEQ, MOE_PLAIN_BLOCK, MOE_CHECK_T = 16384, 512, 8
MOE_CHECK_DEPTH = {"dbrx-132b": 2, "llama4-scout-17b-a16e": 4}
# recsys: timed calls per cell; kernel vs plain forward logits within
# TOL_RS_LOGITS of the largest |logit| (f32 products and sums reordered);
# the bulk lookups (nnz <= 2, f32, products rounded then added in order
# as plain does) within TOL_RS_BULK; a bf16 table within the JAX tests'
# 2e-2 of the largest output; BERT4Rec's scores on the card against the
# CPU within TOL_RS_B4R_CPU (f32 GEMMs in other orders)
# LM training: train_4k's sequence at lm_family.ONE_CARD_TRAIN's depth
# and batch (8 of 40 layers, 2 of 256 rows); the kernel vs plain,
# accumulation and chunked-Adam checks at depth 2. The in-place Adam by
# row chunks, ADAM_CHECK_STEPS steps with the clip off, against the whole
# leaf and against Adam in f64: parameters and moments within TOL_ADAM
# of each one's largest magnitude (a few f32 roundings an element); the
# clip's norm, a sum of up to 2^26 f32 squares a chunk, within
# TOL_ADAM_NORM of the f64 norm (~u*sqrt(n)/3 = 1e-6 at n = 2^26)
LM_TRAIN_TIMED, LM_CHECK_LAYERS = 3, 2
ADAM_CHECK_STEPS, TOL_ADAM, TOL_ADAM_NORM = 2, 1e-6, 1e-5
# flash backward vs plain, relative to each gradient's largest magnitude
# at this length: f32 within the JAX tests' 1e-4. The bf16 route (the
# Hopper pair) writes f32 gradients, as the TPU kernel writes dk and dv,
# and the wrapper casts them: the f32 values before the cast are held to
# the same 1e-4 of plain's f32 gradients before its cast, and the casts
# element-wise as the forward (RTOL/ATOL_FLASH_BF16). The JAX tests' flat
# 2e-2 is not held on the casts here: at the train shape dk and dv reach
# ~12, where one bf16 ulp is 2^-5 or 2^-4, so a flat 2e-2 asks every value
# above 4 to round as plain's f32 happens to; its reading stays in the
# row (max_abs_err), beside plain f32's own distance from the gradient in
# f64 after the cast
TOL_FLASH_BWD = {"float32": 1e-4}
RS_P99_CALLS, RS_BULK_CALLS, RS_RETRIEVAL_CALLS, RS_B4R_CALLS = 100, 5, 20, 50
# recsys training: timed steps after one warm-up; one step's gradients,
# the kernels against impl="plain", within TOL_RS_TRAIN_GRAD of each
# leaf's largest magnitude (f32 sums of a row's slots in another order);
# the EmbeddingBag backward against plain's in f64 within TOL_EBAG_BWD of
# the largest |g| (f32), or one bf16 ulp (EBAG_BF16_RTOL) plus that
# the gnn phase: DimeNet's three one-card shapes (ogb_products is refused
# by name), timed steps after one warm-up, the seed of the batches; the
# shapes whose loss and gradients on the card are held to the port on the
# CPU (f32, TF32 off; index_add_ sums with atomics on the card, in order
# on the CPU): the loss within TOL_GNN_LOSS of its value, each gradient
# leaf within TOL_GNN_GRAD of its largest magnitude
GNN_RUN = ("molecule", "full_graph_sm", "minibatch_lg")
GNN_TIMED, GNN_SEED = 3, 0
GNN_CPU_CHECK = ("molecule", "full_graph_sm")
TOL_GNN_LOSS, TOL_GNN_GRAD = 1e-4, 1e-3
# the registry phase: the kernels each family's reduced smoke must launch
# (and no other): the LMs' f32 attention at head dim 16 on the SIMT flash
# pair, the CTR lookups on the EmbeddingBag and its backward, the
# speedyfeed PLM's head dim 8 on the SIMT bus pair; BERT4Rec and DimeNet
# none
REGISTRY_KERNELS = {
    "lm": {"flash_attention", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv"},
    "recsys": {"embedding_bag", "embedding_bag_bwd"},
    "gnn": set(), "news": {"bus_attention_simt", "bus_attention_bwd_simt"}}
# the kernels line's rows that count more than the counter of their name
ROW_COUNTERS = {
    "flash_attention_bwd_wgmma": ("flash_attention_bwd_dq_wgmma",
                                  "flash_attention_bwd_dkv_wgmma"),
    "flash_attention_bwd": ("flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv"),
    "flash_attention_bwd_tf32": ("flash_attention_bwd_dq_tf32",
                                 "flash_attention_bwd_dkv_tf32")}
# the roofline phase: the cells it must measure (each fits one card and
# has a batch builder in the port at its own shape), and how far a
# measured step may beat its counted floor: by no more than timing noise
ROOFLINE_MUST = ("dimenet/molecule", "dimenet/full_graph_sm",
                 "dimenet/minibatch_lg", "dlrm-rm2/serve_p99",
                 "dlrm-rm2/train_batch", "wide-deep/serve_p99",
                 "wide-deep/train_batch", "dcn-v2/serve_p99",
                 "dcn-v2/train_batch")
ROOFLINE_SLACK = 1.05
# processes that count the cells on meta, beside this one (the card's
# host has 8 cores)
ROOFLINE_WORKERS = 6
RS_TRAIN_TIMED, TOL_RS_TRAIN_GRAD = 3, 1e-5
TOL_EBAG_BWD, EBAG_BF16_RTOL = 1e-5, 2.0 ** -7
TOL_RS_LOGITS, TOL_RS_BULK, TOL_RS_BF16 = 1e-5, 1e-6, 2e-2
TOL_RS_B4R_CPU = 1e-4
RS_B4R_CPU_ROWS = 4

# the mesh phase: MESH_RANKS gloo ranks share cuda:0 (the machine has one
# card), each encoding E / MESH_RANKS rows of PROD's step; 1 warm-up and
# MESH_TIMED synchronised steps, held to the one-process step (losses, and
# each parameter leaf after the warm-up within TOL_MESH of its largest
# magnitude); the phase under MESH_PHASE_S seconds
MESH_RANKS, MESH_TIMED, TOL_MESH, MESH_PHASE_S = 4, 2, 1e-4, 150.0
# the lm-mesh phase: LM_MESH_RANKS gloo ranks on the one card as a (data,
# model) mesh; the f32 holds' depths, batch, sequence and cache slots; the
# DBRX train hold's d_ff (10,752 / 8: one process's f32 Adam state of a
# full-width layer is 4 x 17.8 GB, and the ranks' the same again; the
# serve hold runs at the full 10,752); Adam's step count the train holds
# start from (the schedule's warm-up: lr at its peak, 3e-4, so each step
# moves a weight by ~1e-3; at count 0 it is 1.5e-6, below the limits);
# each leaf read at up to LM_MESH_SAMPLE evenly spaced elements;
# tolerances over the largest element (logits, loss, grad norm, parameter
# and moment leaves) and, for a leaf's change over the steps, over the
# norm of one process's change (Adam divides each element's step by that
# element's own gradient RMS, so where a gradient is near 0 rounding sets
# the step: element by element changes differ far more than over a leaf;
# the CPU tests' worst is 2.7e-4 against JAX, 1.9e-4 against one
# process); the bf16 prefill's sequence (B=2) and depth, decode's batch
# and slots, its timed steps
LM_MESH_RANKS, LM_MESH_SHAPE = 4, (2, 2)
LM_MESH_HOLD = {"qwen3-14b": 2, "dbrx-132b": 1}
LM_MESH_HOLD_B, LM_MESH_HOLD_SEQ, LM_MESH_HOLD_SLOTS = 2, 256, 16
LM_MESH_DBRX_DFF = 1344
LM_MESH_OPT_COUNT = 200
LM_MESH_SAMPLE = 1 << 16
TOL_LM_MESH = {"logits": 1e-4, "loss": 1e-4, "grad_norm": 1e-4,
               "param": 1e-4, "moment": 1e-4, "change": 1e-3}
LM_MESH_PREFILL_SEQ, LM_MESH_PREFILL_LAYERS = 8192, 6
LM_MESH_TRAIN_LAYERS = 2
LM_MESH_DECODE = (16, 8192)
LM_MESH_DECODE_STEPS = 1
# the head plan's hold: ChatGLM3-6B (32 query heads over n_kv 2) on the
# ranks re-cut as a (data=1, model=4) mesh, each KV head replicated over
# 2 of them (8 query heads a rank), at this depth, f32, full width
LM_MESH_HEADS_HOLD = {"chatglm3-6b": 2}
LM_MESH_HEADS_SHAPE = (1, 4)
# its train hold's floor: one process run again on the batch's two halves
# (the same function summed in another order) parts from the first by
# 8.0e-5 of ChatGLM3-6B's layer-0 k weight's largest after 2 steps, the
# mesh by 1.08e-4 (tools/lm_mesh_phase.py on an NVIDIA H100 80GB HBM3 at
# 700 W): its leaves are held within TOL_LM_MESH or LM_MESH_FLOOR_X times
# that spread, the larger (``lm_mesh_hold_check``'s ``floor``)
LM_MESH_FLOOR_X = 4.0
# the flash pair at the head plan's rank shapes (Qwen3-14B and Scout at
# model=16: 3 and 2 query heads over one KV head): [B, S, Hq, Hkv=1, D]
FLASH_GROUP_B, FLASH_GROUP_S, FLASH_GROUP_D = 2, 4096, 128
FLASH_GROUP_HQ = (3, 2)

# the recsys-mesh phase: RS_MESH_RANKS gloo ranks on the one card; its runs
# in order, each (config, (data, model), what it runs); the CTR train
# holds' batch (a cut of train_batch's 65,536) and BERT4Rec's microbatches
# of train_batch // B4R_ONE_CARD_ACCUM (4,096) a train hold takes (16 at
# 65,536); the BERT4Rec serve_bulk cut (of 262,144) and the rows of each
# rank's block held there to one process; up to RS_MESH_ROWS of the rows
# a train batch names read in each table leaf (LM_MESH_SAMPLE positions in
# every other leaf); the seed; the limits: logits and scores over the
# largest, the loss absolute (a loss near 0.69), leaves over their
# largest (a leaf that starts at 0 over the largest leaf's), a leaf's
# change over the norm of one process's change; BERT4Rec's key biases,
# whose gradient is 0 in exact arithmetic (their gradients and moments
# held over the largest leaf, their parameters not)
RS_MESH_RANKS, RS_MESH_SHAPE = 4, (2, 2)
RS_MESH_PLAN = (("dcn-v2", (2, 2), ("serve", "train")),
                ("wide-deep", (2, 2), ("serve", "train")),
                ("dlrm-rm2", (2, 2), ("serve", "retrieval")),
                ("dlrm-rm2", (1, 4), ("train",)),
                ("bert4rec", (1, 4), ("serve",)),
                ("bert4rec", (2, 2), ("serve", "bulk", "retrieval",
                                      "train")))
RS_MESH_TRAIN_B, RS_MESH_B4R_MICRO = 16384, 2
RS_MESH_BULK_B, RS_MESH_BULK_HELD = 16384, 256
RS_MESH_ROWS, RS_MESH_SEED = 1 << 12, 35
TOL_RS_MESH = {"logits": 1e-5, "scores": 1e-5, "loss": 1e-5, "leaf": 1e-4,
               "change": 1e-3}
RS_MESH_NOISE = "attn/k/b"
# the LM holds' leaf whose gradient is 0 in exact arithmetic (ChatGLM3-6B's
# key bias: b . q shifts each of a query's key logits alike, which the
# softmax removes): its moments are held against the part's largest leaf
# and its parameters after the steps not, as the recsys-mesh phase holds
# BERT4Rec's (Adam moves a rounding-noise gradient by ~lr either way)
LM_MESH_NOISE = "attn/k/b"

# the gnn-mesh phase: GNN_MESH_RANKS gloo ranks on the one card as each
# (data, model) mesh of GNN_MESH_SHAPES, DimeNet at GNN_MESH_CELL's full
# width (the edges and triplets over every axis), GNN_MESH_STEPS train
# steps a run. The holds run in f64: DimeNet's f32 gradients at random
# init part by ~1e-3 of a leaf's largest between any two summation orders
# (one process against f64: 1.4e-3 at molecule on the CPU; the card
# against the CPU at molecule: 4.3e-4), so an f32 hold could not tell a
# misplaced sum from rounding, where f64's rounding sits near 1e-12. The
# limits, against one process on the card (and that process's loss and
# gradients against the CPU's): the losses over their magnitude, each
# gradient leaf (as Adam takes it) over its largest, each leaf's change
# over both steps over the norm of one process's change (the global-norm
# clip takes its norm in f32 in both: ~1e-7 of a change). The f32 steps,
# as the cell runs, are timed, their losses read.
GNN_MESH_RANKS, GNN_MESH_SHAPES = 4, ((4, 1), (2, 2))
GNN_MESH_CELL, GNN_MESH_STEPS = "minibatch_lg", 2
TOL_GNN_MESH = {"loss": 1e-9, "grad": 1e-8, "change": 1e-5}

# the sharded index: shards over the one card; the int8 reduction's
# gradients (PROD's attention and FFN shapes)
MESH_SHARDS = 4
MESH_INT8_SHAPES = {"attn_q_w": (768, 768), "ffn_up_w": (768, 3072)}

def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events).

    A large matrix product is queued first, so that the timed launches
    are all enqueued while the device is still busy with it: the events
    then measure the device running them back to back, not the host's
    launch rate (which would dominate for a kernel of a few µs)."""
    for _ in range(warmup):
        fn()
    filler = torch.ones(8192, 8192, device="cuda")
    torch.cuda.synchronize()
    torch.mm(filler, filler)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(work: dict, flop_per_s: float | None = None,
             products: int = 1):
    """(ms, "bytes" or "operations"): the least time the card could take
    for a kernel's ``work`` (its module's ``work()``): its bytes at the
    HBM rate or its FLOPs at ``flop_per_s`` (the f32 rate by default),
    whichever is longer, the rates ``launch/roofline.py``'s; ``products``
    products for each of the work's (3xTF32 takes three TF32 products an
    f32 one)."""
    from repro_torch.launch import roofline as rl
    rate = rl.F32_FLOP_PER_S if flop_per_s is None else flop_per_s
    t_bytes = work["bytes"] / rl.HBM_BYTES_PER_S
    t_ops = products * work["flops"] / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_work(q, k, backward: bool = False) -> dict:
    """``kernels/flash_attention.py:work`` of a causal call on q, k."""
    from repro_torch.kernels.flash_attention import work
    B, Sq, Hq, D = q.shape
    return work(B, Sq, k.shape[1], Hq, k.shape[2], D, q.dtype, True,
                backward)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def flash_miss(o, o_p) -> float:
    """Largest |o - o_p| over the bf16 limit RTOL * |o_p| + ATOL: the
    check passes at <= 1."""
    o_p = o_p.float()
    lim = RTOL_FLASH_BF16 * o_p.abs() + ATOL_FLASH_BF16
    return float(((o.float() - o_p).abs() / lim).max())


def dropped_tile(v, start: int, width: int = 64):
    """v with one key tile's values zeroed: the control that the flash
    checks must catch (a kernel that lost that tile's PV)."""
    v = v.clone()
    v[:, start:start + width] = 0
    return v


def flash_fwd_launches(dtype, head_dim: int, n: int) -> dict:
    """``n`` flash forward launches at ``dtype`` and ``head_dim``, by
    route: all on the one ``kernels/flash_attention.py:forward_route``
    picks, none on the other."""
    from repro_torch.kernels.flash_attention import forward_route
    route = forward_route(dtype, head_dim)
    return {name: n if name == route else 0 for name in FLASH_FWD}


def flash_bwd_launches(dtype, head_dim: int, n: int) -> dict:
    """``n`` launches of each flash backward kernel (dq, dk/dv) at
    ``dtype`` and ``head_dim``, by route: all on the pair
    ``kernels/flash_attention.py:backward_route`` picks, none on the
    other."""
    from repro_torch.kernels.flash_attention import backward_route
    route = backward_route(dtype, head_dim)
    return {name: n if name in route else 0 for name in FLASH_BWD}


def hopper_library(name: str):
    """The built library's path of the Hopper kernel library ``name``."""
    from repro_torch.kernels import ops
    libs = {lib.name: lib for lib, _ in ops.KERNELS.values()}
    return libs[name].library_path()


def wgmma_kernel(symbol: str):
    """``flash_..._wgmma_kernel<D>`` for a mangled wgmma kernel symbol,
    else None."""
    import re
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)ILi(\d+)E",
                  symbol)
    return f"{m[1]}<{m[2]}>" if m else None


def bus_kernel(symbol: str):
    """``bus_{fwd,bwd}_kernel<dtype,D,NT>`` for a mangled bus attention
    kernel symbol, else None."""
    import re
    m = re.search(r"(bus_(?:fwd|bwd)_kernel)I(f|13__nv_bfloat16|6__half)"
                  r"Li(\d+)ELi(\d+)E", symbol)
    dtypes = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "fp16"}
    return f"{m[1]}<{dtypes[m[2]]},{m[3]},{m[4]}>" if m else None


_SASS: dict = {}


def sass_count(lib, namer=wgmma_kernel, instr: str = "HGMMA") -> dict:
    """``instr`` instructions in the SASS (``cuobjdump -sass``, run once a
    library) of each kernel instantiation ``namer`` names in the built
    library (by default HGMMA in each wgmma kernel<D>)."""
    from repro_torch.kernels._build import find_nvcc
    if str(lib) not in _SASS:
        cuobjdump = pathlib.Path(find_nvcc()).parent / "cuobjdump"
        _SASS[str(lib)] = subprocess.run(
            [str(cuobjdump), "-sass", str(lib)], capture_output=True,
            text=True, check=True).stdout
    return {namer(fn.split(None, 1)[0]): fn.count(instr)
            for fn in _SASS[str(lib)].split("Function : ")[1:]
            if namer(fn.split(None, 1)[0])}


def ptxas_by_kernel(log: str, namer=wgmma_kernel) -> dict:
    """``ptxas -v``'s spill and register lines of each kernel
    instantiation ``namer`` names in a build log (by default each wgmma
    kernel<D>)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = namer(ln)
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip().replace(
                "ptxas info    : ", ""))
    return out


def tf32_kernel(symbol: str):
    """``flash_fwd_tf32_kernel<D>`` or ``split_kv_kernel<D>`` for a mangled
    3xTF32 forward symbol, else None."""
    import re
    m = re.search(r"(flash_fwd_tf32_kernel|split_kv_kernel)ILi(\d+)E",
                  symbol)
    return f"{m[1]}<{m[2]}>" if m else None


def tf32_bwd_kernel(symbol: str):
    """``split_planes_kernel<D>``, ``flash_bwd_dq_tf32_kernel<D>`` or
    ``flash_bwd_dkv_tf32_kernel<D>`` for a mangled 3xTF32 backward symbol,
    else None."""
    import re
    m = re.search(r"(split_planes_kernel|flash_bwd_dq_tf32_kernel|"
                  r"flash_bwd_dkv_tf32_kernel)ILi(\d+)E", symbol)
    return f"{m[1]}<{m[2]}>" if m else None


def pq_kernel(symbol: str):
    """``pq_tiled_kernel<M/8,W>`` or ``pq_lut_scores_kernel<codes,vec8>``
    for a mangled PQ scan symbol, else None."""
    import re
    m = re.search(r"pq_tiled_kernelILi(\d)ELi(\d)E", symbol)
    if m:
        return f"pq_tiled_kernel<{m[1]},{m[2]}>"
    m = re.search(r"pq_lut_scores_kernelI(h|i)Lb(\d)E", symbol)
    return (f"pq_lut_scores_kernel<{'uint8' if m[1] == 'h' else 'int32'},"
            f"{m[2]}>" if m else None)


def check_no_spills(name: str, ptxas: dict):
    """Every instantiation in ``ptxas`` reports 0 bytes of spills."""
    lines = [ln for kern in ptxas.values() for ln in kern]
    spills = [ln for ln in lines if "spill" in ln
              and ln != "0 bytes stack frame, 0 bytes spill stores, "
                        "0 bytes spill loads"]
    check(sum("spill" in ln for ln in lines) == len(ptxas) > 0
          and not spills, f"{name}: ptxas reports spills: {ptxas}")


def bwd_f64(q, k, v, o, lse, do):
    """Plain's causal flash backward (Sq = Sk) in f64, for batch 0's first
    kv head and its G q heads, on the same q/k/v/o/lse/dO: the function
    whose f32 evaluations the kernel and plain are. Returns (dq [S, G, D],
    dk [S, D], dv [S, D])."""
    import torch
    G, D = q.shape[2] // k.shape[2], q.shape[-1]
    scale = D ** -0.5
    qd, od, dod = (t[0, :, :G].double().transpose(0, 1) for t in (q, o, do))
    kd, vd = (t[0, :, 0].double() for t in (k, v))
    p = qd @ kd.T * scale                                    # [G, S, S]
    S = p.shape[-1]
    p.masked_fill_(torch.ones(S, S, dtype=torch.bool, device=q.device)
                   .triu(1), float("-inf"))
    p.sub_(lse[0, :G, :, None].double()).exp_()
    delta = (dod * od).sum(-1, keepdim=True)
    ds = p * (dod @ vd.T - delta)
    dq = (ds @ kd * scale).transpose(0, 1)
    dk = (ds.transpose(1, 2) @ qd).sum(0) * scale
    dv = (p.transpose(1, 2) @ dod).sum(0)
    return dq, dk, dv


def flash_fwd_errors(o, lse, q, k, v, dtype, label: str) -> dict:
    """Hold (o, lse) of a causal kernel launch against the plain version
    on q/k/v; in bf16 also element-wise, with a control: the plain
    version with the last key tile's PV dropped must miss (under the flat
    limit alone it would pass: that tile carries ~1/64 of the weight of
    the rows that see it)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd_plain
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, True)
    e = {"o": float((o.float() - o_p.float()).abs().max()),
         "lse": float((lse - lse_p).abs().max())}
    ok = e["o"] <= TOL_FLASH[str(dtype)[6:]] and e["lse"] <= TOL_LSE
    if dtype == torch.bfloat16:
        e["o_over_limit"] = flash_miss(o, o_p)
        o_c = flash_attention_fwd_plain(
            q, k, dropped_tile(v, k.shape[1] - 64), True)[0]
        e["control_o_over_limit"] = flash_miss(o_c, o_p)
        e["control_o"] = float((o_c.float() - o_p.float()).abs().max())
        ok = ok and e["o_over_limit"] <= 1
        check(e["control_o_over_limit"] > 1,
              f"flash_attention {label}: the bf16 limit misses a dropped "
              f"key tile: {e}")
    check(ok, f"flash_attention {label} differs from plain: {e}")
    return e


def last_tile_controls(q, k, v, o, lse, do, exp):
    """Plain's f32 gradients ``exp`` (causal, Sq = Sk) as a kernel that lost
    the last key tile would give them: dk and dv of that tile zero; dq's
    last rows without that tile's ds k, which is plain on the last tile
    alone (row i of it sees keys up to i, as the global row does)."""
    from repro_torch.kernels.flash_attention import _bwd_plain_f32
    t0 = q.shape[1] - 64
    last = _bwd_plain_f32(q[:, t0:], k[:, t0:], v[:, t0:], o[:, t0:],
                          lse[..., t0:], do[:, t0:], True)[0]
    dq_c = exp[0].clone()
    dq_c[:, t0:] -= last
    return dq_c, dropped_tile(exp[1], t0), dropped_tile(exp[2], t0)


def bwd_f32_errors(q, k, v, o, lse, do, got, exp, label: str) -> dict:
    """An f32 flash backward's (dq, dk, dv) ``got`` against plain's ``exp``
    on causal f32 inputs with Sq = Sk: each within TOL_FLASH_BWD["float32"]
    of plain's largest magnitude, and the controls of a kernel that lost
    the last key tile (``last_tile_controls``) over that limit."""
    rel_tol = TOL_FLASH_BWD["float32"]
    e = {}
    controls = last_tile_controls(q, k, v, o, lse, do, exp)
    for gname, a, b, c in zip(("dq", "dk", "dv"), got, exp, controls):
        top = float(b.abs().max())
        e[gname] = float((a - b).abs().max())
        e[gname + "_rel"] = e[gname] / top
        e[gname + "_control_rel"] = float((c - b).abs().max()) / top
    del controls
    check(all(e[n + "_control_rel"] > rel_tol for n in ("dq", "dk", "dv")),
          f"flash_attention_bwd {label}: the limit misses a dropped key "
          f"tile: {e}")
    check(all(e[n + "_rel"] <= rel_tol for n in ("dq", "dk", "dv")),
          f"flash_attention_bwd {label} differs from plain: {e}")
    return e


def bwd_hopper_errors(q, k, v, o, lse, do, got, exp, label: str) -> dict:
    """The Hopper backward's f32 (dq, dk, dv) ``got`` against plain's f32
    ``exp`` (both before the cast) on causal bf16 q/k/v/o/lse/dO with Sq =
    Sk. Held: each f32 gradient within TOL_FLASH_BWD["float32"] of plain's
    largest magnitude (``_f32_over_limit`` <= 1), and each bf16 cast within
    the element-wise limit of plain's cast (``_over_limit`` <= 1). The
    controls of a kernel that lost the last key tile
    (``last_tile_controls``) must miss both. Read beside them: the casts'
    largest abs difference (the flat limit's reading), and how far plain's
    f32 and the kernel's, and their casts, lie from the gradient in f64
    (``bwd_f64``, one kv head)."""
    import torch
    rel_tol = TOL_FLASH_BWD["float32"]
    e = {}
    for gname, a, b, t in zip(("dq", "dk", "dv"), got, exp, (q, k, v)):
        a16, b16 = a.to(t.dtype), b.to(t.dtype)
        e[gname] = float((a16.float() - b16.float()).abs().max())
        e[gname + "_f32_rel"] = float((a - b).abs().max() / b.abs().max())
        e[gname + "_f32_over_limit"] = e[gname + "_f32_rel"] / rel_tol
        e[gname + "_over_limit"] = flash_miss(a16, b16)
    controls = last_tile_controls(q, k, v, o, lse, do, exp)
    for gname, c, b, t in zip(("dq", "dk", "dv"), controls, exp, (q, k, v)):
        e[gname + "_control_f32_over_limit"] = float(
            (c - b).abs().max() / b.abs().max()) / rel_tol
        e[gname + "_control_over_limit"] = flash_miss(c.to(t.dtype),
                                                      b.to(t.dtype))
        check(e[gname + "_control_f32_over_limit"] > 1
              and e[gname + "_control_over_limit"] > 1,
              f"flash_attention_bwd {label} {gname}: a limit misses a "
              f"dropped key tile: {e}")
    del controls
    G = q.shape[2] // k.shape[2]
    f64 = bwd_f64(q, k, v, o, lse, do)
    e["vs_f64"] = {}
    for gname, x, a, b, t in zip(("dq", "dk", "dv"), f64, got, exp,
                                 (q, k, v)):
        a, b = (y[0, :, :G] if gname == "dq" else y[0, :, 0] for y in (a, b))
        x16 = x.to(t.dtype).double()
        r = {}
        for who, y in (("plain", b), ("kernel", a)):
            r[who + "_f32_rel"] = float((y - x).abs().max() / x.abs().max())
            y16 = y.to(t.dtype).double()
            r[who + "_bf16_max_abs"] = float((y16 - x16).abs().max())
            r[who + "_bf16_mismatch_share"] = float((y16 != x16).float()
                                                    .mean())
        e["vs_f64"][gname] = r
    del f64
    ok = all(e[n + "_f32_over_limit"] <= 1 and e[n + "_over_limit"] <= 1
             for n in ("dq", "dk", "dv"))
    check(ok, f"flash_attention_bwd {label} differs from plain: {e}")
    return e


def bus_zeroed(v, S: int):
    """v with the bus columns' values zeroed (keys S..Sk): the control the
    bus checks must catch (a kernel that lost the bus keys)."""
    v = v.clone()
    v[:, :, S:] = 0
    return v


def masked_segment(K: int) -> int:
    """The segment ``bus_inputs`` masks whole in every 7th news: 2, or the
    last when there are fewer."""
    return min(2, K - 1)


def bus_inputs(torch, g, M: int, K: int, S: int, H: int, D: int, dev):
    """q, k, v, kv_mask and do for M news at segment length S (Sk = S + K),
    f32 from ``g``; a quarter of the keys masked, key 0 kept, and segment
    ``masked_segment(K)`` of every 7th news all masked."""
    Sk = S + K
    q = torch.randn(M, K, S, H, D, generator=g, device=dev)
    k = torch.randn(M, K, Sk, H, D, generator=g, device=dev)
    v = torch.randn(M, K, Sk, H, D, generator=g, device=dev)
    do = torch.randn(M, K, S, H, D, generator=g, device=dev)
    kv_mask = torch.rand(M, K, Sk, generator=g, device=dev) < 0.75
    kv_mask[:, :, 0] = True
    kv_mask[::7, masked_segment(K)] = False  # all-masked segments
    return q, k, v, kv_mask, do


def bus_fwd_checks(torch, q, k, v, kv_mask) -> dict:
    """The bus forward held to plain within TOL_BUS, two launches bit for
    bit, and the zeroed-bus-v control over the limit."""
    from repro_torch.kernels.bus_attention import (bus_attention_cuda,
                                                   bus_attention_plain)
    M, K, S = q.shape[:3]
    at = f"M={M}, S={S}"
    out = bus_attention_cuda(q, k, v, kv_mask)
    err = float((out - bus_attention_plain(q, k, v, kv_mask)).abs().max())
    same = torch.equal(out, bus_attention_cuda(q, k, v, kv_mask))
    ctl = float((out - bus_attention_plain(q, k, bus_zeroed(v, S),
                                           kv_mask)).abs().max())
    check(err <= TOL_BUS, f"bus_attention at {at} differs from plain by "
          f"{err}")
    check(same, f"two bus_attention launches at {at} differ")
    check(ctl > TOL_BUS, f"the zeroed-bus-v control passes the forward's "
          f"limit at {at} ({ctl} <= {TOL_BUS})")
    return {"max_abs_err": err, "bitwise_repeat": same,
            "zeroed_bus_v_control_err": ctl}


def bus_bwd_checks(torch, q, k, v, kv_mask, do) -> dict:
    """The bus backward held to plain within TOL_BWD, dv nonzero on the
    all-masked segments, two launches bit for bit, and the zeroed-bus-v
    control over the limit."""
    from repro_torch.kernels.bus_attention import (bus_attention_bwd_cuda,
                                                   bus_attention_bwd_plain)
    M, K, S = q.shape[:3]
    at = f"M={M}, S={S}"
    got = bus_attention_bwd_cuda(q, k, v, kv_mask, do)
    ref = bus_attention_bwd_plain(q, k, v, kv_mask, do)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    del ref
    check(err <= TOL_BWD, f"bus_attention_bwd at {at} differs from plain by "
          f"{err}")
    check(float(got[2][::7, masked_segment(K)].abs().max()) > 0,
          f"dv is zero on an all-masked segment at {at}")
    again = bus_attention_bwd_cuda(q, k, v, kv_mask, do)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    ctl = max(float((a - b).abs().max()) for a, b in zip(
        got, bus_attention_bwd_plain(q, k, bus_zeroed(v, S), kv_mask, do)))
    check(same, f"two bus_attention_bwd launches at {at} differ")
    check(ctl > TOL_BWD, f"the zeroed-bus-v control passes the backward's "
          f"limit at {at} ({ctl} <= {TOL_BWD})")
    return {"max_abs_err": err, "bitwise_repeat": same,
            "zeroed_bus_v_control_err": ctl}


def on_route(ops, name: str, fn, routes=None):
    """``fn()``'s result, after checking that its launches among
    ``routes`` (by default the bus kernels', ``bus_attention.ROUTES``) all
    went to kernel ``name`` and the others got none."""
    if routes is None:
        from repro_torch.kernels.bus_attention import ROUTES as routes
    before = ops.launch_counts()
    res = fn()
    after = ops.launch_counts()
    moved = {n: after[n] - before[n] for n in routes}
    check(moved[name] > 0 and not any(c for n, c in moved.items()
                                      if n != name),
          f"launches went {moved}, expected all on {name}")
    return res


def pq_shape_row(torch, ops, lut, codes, valid, iters: int,
                 plain_iters: int) -> dict:
    """The PQ scan at one shape, on both kernels: each held to plain on
    the codes and on a copy with a few codes pushed past K (TOL_PQ; NaN
    and -inf slots exact) and launched twice (bit for bit), on the route
    named; then timed in turns (general, tiled, tiled, general), beside
    plain, the byte bound and, for a flat scan (codes shared, no
    validity), ``F.embedding_bag`` over the codes offset by m K into the
    [M K, B] table (offsets built outside the timing)."""
    from repro_torch.kernels.pq_scoring import (ROUTES, pq_lut_scores_cuda,
                                                pq_lut_scores_plain)
    from repro_torch.kernels.pq_scoring import work as pq_work
    B, M, K = lut.shape
    past = codes.clone()
    past[..., ::997, M // 2] = K if K < 256 else 0
    row = {"shape": [B, M, K, codes.shape[1]], "Bc": codes.shape[0],
           "Bv": None if valid is None else valid.shape[0]}
    for c, label in ((codes, ""), (past, "_codes_past_k")):
        ref = pq_lut_scores_plain(lut, c, valid)
        for route in ROUTES:
            out, again = (on_route(ops, route, lambda: pq_lut_scores_cuda(
                lut, c, valid, route=route), ROUTES) for _ in range(2))
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            check(torch.equal(out.isnan(), ref.isnan())
                  and torch.equal(out == float("-inf"), ref == float("-inf"))
                  and torch.equal(torch.isfinite(out), fin),
                  f"{route}: NaN/-inf slots differ from plain {row['shape']}")
            check(torch.equal(out.view(torch.int32), again.view(torch.int32)),
                  f"{route}: two launches differ {row['shape']}")
            err = float((out[fin] - ref[fin]).abs().max())
            check(err <= TOL_PQ, f"{route} differs from plain by {err}")
            row[f"{route}_err{label}"] = err
            row[f"{route}_nan_slots{label}"] = int(out.isnan().sum())
        del ref, out, again
    if K < 256:
        check(row["pq_lut_scores_nan_slots_codes_past_k"] > 0,
              f"codes past K={K} scored no NaN {row['shape']}")
    row["turns_ms"] = [(route, time_ms(torch, lambda: pq_lut_scores_cuda(
        lut, codes, valid, route=route), iters=iters))
        for route in ("pq_lut_scores_general", "pq_lut_scores",
                      "pq_lut_scores", "pq_lut_scores_general")]
    row["ms"] = sum(ms for r, ms in row["turns_ms"]
                    if r == "pq_lut_scores") / 2
    row["general_ms"] = sum(ms for r, ms in row["turns_ms"]
                            if r == "pq_lut_scores_general") / 2
    row["plain_ms"] = time_ms(torch, lambda: pq_lut_scores_plain(
        lut, codes, valid), iters=plain_iters, warmup=1)
    row["bound_ms"], row["bound_by"] = bound_ms(pq_work(
        B, M, K, codes.shape[1], codes.shape[0], codes.element_size(),
        0 if valid is None else valid.shape[0]))
    row["library_ms"] = None
    if codes.shape[0] == 1 and valid is None:
        idx = (codes[0].long() + K * torch.arange(M, device=codes.device))
        table = lut.reshape(B, M * K).t().contiguous()
        bag = torch.nn.functional.embedding_bag(idx, table, mode="sum")
        ref = pq_lut_scores_plain(lut, codes)
        row["library_err"] = float((bag.t() - ref).abs().max())
        check(row["library_err"] <= TOL_PQ,
              f"embedding_bag yardstick differs by {row['library_err']}")
        row["library_ms"] = time_ms(torch, lambda: torch.nn.functional
                                    .embedding_bag(idx, table, mode="sum"),
                                    iters=iters)
        del idx, table, bag, ref
    return row


def bus_sdpa_inputs(torch, q, k, v, kv_mask, grad: bool = False):
    """q/k/v as SDPA's [M*K, H, S|Sk, D] and the mask as an additive -1e30
    bias: the same attention for the library call."""
    M, K, S, H, D = q.shape
    Sk = k.shape[2]
    qs, ks, vs = (t.permute(0, 1, 3, 2, 4).reshape(M * K, H, -1, D)
                  .contiguous().requires_grad_(grad) for t in (q, k, v))
    add = torch.zeros(M * K, 1, 1, Sk, device=q.device).masked_fill(
        ~kv_mask.reshape(M * K, 1, 1, Sk), -1e30)
    return qs, ks, vs, add


def bus_fwd_row(torch, q, k, v, kv_mask, iters: int = 20) -> dict:
    """The bus forward on q/k/v/mask (``bus_fwd_checks``); its time beside
    plain's, its bound and one SDPA call (additive -1e30 mask)."""
    from repro_torch.kernels.bus_attention import (bus_attention_cuda,
                                                   bus_attention_plain, work)
    M, K, S, H, D = q.shape
    Sk = k.shape[2]
    row = bus_fwd_checks(torch, q, k, v, kv_mask)
    qs, ks, vs, add = bus_sdpa_inputs(torch, q, k, v, kv_mask)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b_ms, b_by = bound_ms(work(M, K, S, Sk, H, D, q.dtype))
    return {**row,
            "ms": time_ms(torch, lambda: bus_attention_cuda(q, k, v,
                                                            kv_mask), iters),
            "plain_ms": time_ms(torch, lambda: bus_attention_plain(
                q, k, v, kv_mask), iters),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: sdpa(qs, ks, vs,
                                                      attn_mask=add), iters),
            "shape": [M, K, S, Sk, H, D], "dtype": str(q.dtype)[6:]}


def bus_bwd_row(torch, q, k, v, kv_mask, do, iters: int = 10) -> dict:
    """The bus backward on q/k/v/mask/do (``bus_bwd_checks``); its time
    beside plain's, its bound and SDPA's backward alone on the same data
    (additive -1e30 mask)."""
    from repro_torch.kernels.bus_attention import (bus_attention_bwd_cuda,
                                                   bus_attention_bwd_plain,
                                                   work)
    M, K, S, H, D = q.shape
    Sk = k.shape[2]
    row = bus_bwd_checks(torch, q, k, v, kv_mask, do)
    qs, ks, vs, add = bus_sdpa_inputs(torch, q, k, v, kv_mask, grad=True)
    dos = do.permute(0, 1, 3, 2, 4).reshape(M * K, H, S, D).contiguous()
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=add)
    b_ms, b_by = bound_ms(work(M, K, S, Sk, H, D, q.dtype, backward=True))
    return {**row,
            "ms": time_ms(torch, lambda: bus_attention_bwd_cuda(
                q, k, v, kv_mask, do), iters),
            "plain_ms": time_ms(torch, lambda: bus_attention_bwd_plain(
                q, k, v, kv_mask, do), max(iters // 2, 1)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                o_sdpa, (qs, ks, vs), dos, retain_graph=True), iters),
            "shape": [M, K, S, Sk, H, D], "dtype": str(q.dtype)[6:]}


def latencies_ms(torch, fn, n: int, warmup: int = 3) -> list:
    """Host-clock ms of ``n`` synchronised calls of ``fn`` after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def tree_to(tree, device):
    """A copy of a nested dict/list of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def distinct_rows(idx, V: int) -> int:
    """Distinct table rows an EmbeddingBag call reads: the in-range
    indices, a negative one naming row V + i. A row that several slots
    name needs one read from device memory; the repeats can come from
    L2."""
    i = idx[(idx >= -V) & (idx < V)].long()
    return int(i.remainder(V).unique().numel())


def recsys_phase(torch, np, dev):
    """The recsys family's serving path at full width (see the module
    docstring, phase 11). Returns (report, the embedding_bag kernel row).
    Memory is reported above what was resident when a config began."""
    import gc

    from repro_torch.configs import recsys_family as rf
    from repro_torch.data import recsys_synth
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import (embedding_bag_cuda,
                                                   embedding_bag_plain)
    from repro_torch.kernels.embedding_bag import work as ebag_work
    from repro_torch.models.recsys import bert4rec, common, ctr

    rep = {"tol_logits_rel": TOL_RS_LOGITS, "tol_bulk_lookup": TOL_RS_BULK}
    B_p99 = rf.RS_SHAPES["serve_p99"]["batch"]
    B_bulk = rf.RS_SHAPES["serve_bulk"]["batch"]
    n_cand = rf.RS_SHAPES["retrieval_cand"]["n_cand"]
    rng = np.random.default_rng(7)
    row = None

    def ctr_batch(cfg, B):
        return recsys_synth.ctr_batch(
            rng, batch=B, n_dense=cfg.n_dense,
            vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz,
            device=dev)

    def resident() -> int:
        """Free what the last config left, restart the peak; the bytes
        still allocated (earlier phases' leftovers), which each config's
        memory figures are counted above."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    for cfg, per_forward in ((rf.DLRM_RM2, 1), (rf.WIDE_DEEP, 2),
                             (rf.DCN_V2, 1)):
        base = resident()
        t0 = time.perf_counter()
        params = ctr.init(torch.Generator(device=dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        r = {"resident_before_gb": base / 1e9,
             "init_s": time.perf_counter() - t0,
             "params_gb": (torch.cuda.memory_allocated() - base) / 1e9,
             "table_rows": int(params["tables"]["fused"].shape[0]),
             "embed_dim": cfg.sparse.embed_dim, "nnz": cfg.sparse.nnz,
             "fields": cfg.sparse.n_fields}
        serve = rf.make_fn(cfg, "serve")
        small, bulk = ctr_batch(cfg, B_p99), ctr_batch(cfg, B_bulk)

        # serve_p99: the counts from 0 before the timed calls, read after
        ops.reset_launch_counts()
        serve(params, small)
        r["launches_per_forward"] = ops.launch_counts()["embedding_bag"]
        ops.reset_launch_counts()
        ms = latencies_ms(torch, lambda: serve(params, small), RS_P99_CALLS)
        r["serve_p99"] = {
            "batch": B_p99, "calls": RS_P99_CALLS,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "launches": ops.launch_counts()["embedding_bag"]}
        ops.reset_launch_counts()
        ms = latencies_ms(torch, lambda: serve(params, bulk), RS_BULK_CALLS,
                          warmup=1)
        r["serve_bulk"] = {
            "batch": B_bulk, "calls": RS_BULK_CALLS,
            "ms": float(np.mean(ms)),
            "samples_per_s": B_bulk / (float(np.mean(ms)) / 1e3),
            "launches": ops.launch_counts()["embedding_bag"]}
        logits = serve(params, small)
        bulk_logits = serve(params, bulk)
        check(tuple(logits.shape) == (B_p99,)
              and tuple(bulk_logits.shape) == (B_bulk,),
              f"{cfg.name} logits {tuple(logits.shape)}, "
              f"{tuple(bulk_logits.shape)}")
        check(bool(torch.isfinite(logits).all()
                   and torch.isfinite(bulk_logits).all()),
              f"non-finite {cfg.name} logits")
        check(r["launches_per_forward"] == per_forward,
              f"{cfg.name}: {r['launches_per_forward']} embedding_bag "
              f"launches per forward, expected {per_forward}")
        for cell, n in (("serve_p99", RS_P99_CALLS + 3),
                        ("serve_bulk", RS_BULK_CALLS + 1)):
            check(r[cell]["launches"] == n * per_forward,
                  f"{cfg.name} {cell}: {r[cell]['launches']} embedding_bag "
                  f"launches, expected {n * per_forward}")

        # kernel vs plain: the p99 forward's logits, the bulk lookups
        with torch.no_grad():
            plain = ctr.forward(params, cfg, small, impl="plain")
            top = float(plain.abs().max())
            r["logits_max_rel_err"] = float((logits - plain).abs().max()) / top
            errs = []
            tables = [(params["tables"], cfg.sparse)]
            if cfg.wide:
                tables.append((params["wide"], cfg.wide_spec))
            for t, spec in tables:
                got = common.lookup(t, spec, bulk["sparse_idx"],
                                    bulk["sparse_w"])
                exp = common.lookup(t, spec, bulk["sparse_idx"],
                                    bulk["sparse_w"], impl="plain")
                errs.append(float((got - exp).abs().max()))
                del got, exp
            del tables, t
        r["bulk_lookup_max_abs_err"] = errs
        check(r["logits_max_rel_err"] <= TOL_RS_LOGITS,
              f"{cfg.name} logits, kernel vs plain, differ by "
              f"{r['logits_max_rel_err']} of the largest")
        check(max(errs) <= TOL_RS_BULK,
              f"{cfg.name} bulk lookups, kernel vs plain, differ by {errs}")

        if cfg is rf.DLRM_RM2:
            # retrieval_cand: one query against 10^6 precomputed candidates
            retrieve = rf.make_fn(cfg, "retrieval")
            cand = torch.randn(n_cand, rf.ctr_repr_dim(cfg), device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(3))
            one = ctr_batch(cfg, 1)
            ops.reset_launch_counts()
            ms = latencies_ms(torch, lambda: retrieve(params, one, cand),
                              RS_RETRIEVAL_CALLS)
            scores, rows = retrieve(params, one, cand)
            with torch.no_grad():
                u = ctr.user_repr(params, cfg, one)
            re = float((scores - (cand[rows[0]] @ u[0])[None]).abs().max())
            r["retrieval_cand"] = {
                "candidates": n_cand, "dim": rf.ctr_repr_dim(cfg),
                "calls": RS_RETRIEVAL_CALLS, "ms": float(np.mean(ms)),
                "p99_ms": float(np.percentile(ms, 99)),
                "launches": ops.launch_counts()["embedding_bag"],
                "rescore_max_abs_err": re}
            check(tuple(scores.shape) == (1, 100)
                  and bool((scores[0, :-1] >= scores[0, 1:]).all()),
                  "retrieval scores are not a sorted top-100")
            check(re <= 1e-4, f"retrieval scores differ from a rescore by "
                  f"{re}")
            del cand

            # the kernel at serve_bulk's shape, on the fused table
            table = params["tables"]["fused"]
            V, d = table.shape
            idx = (bulk["sparse_idx"] + common.field_offsets(
                cfg.sparse, dev)[None, :, None]).contiguous()
            w = bulk["sparse_w"]
            out = embedding_bag_cuda(table, idx, w)
            exp = embedding_bag_plain(table, idx, w)
            torch.cuda.synchronize()
            err = float((out - exp).abs().max())
            check(err <= TOL_RS_BULK, f"embedding_bag at the bulk shape "
                  f"differs from plain by {err}")
            del exp
            Bk, Fk, nnz = idx.shape
            flat_idx, flat_w = idx.view(Bk * Fk, nnz), w.view(Bk * Fk, nnz)
            lib = torch.nn.functional.embedding_bag
            b_ms, b_by = bound_ms(ebag_work(V, d, Bk, Fk, nnz, table.dtype,
                                            True, distinct_rows(idx, V)))
            row = {
                "name": "embedding_bag", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
                "replaces": "src/repro/kernels/embedding_bag.py:37",
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: embedding_bag_cuda(table, idx,
                                                                w)),
                "plain_ms": time_ms(torch, lambda: embedding_bag_plain(
                    table, idx, w), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(torch, lambda: lib(
                    flat_idx, table, per_sample_weights=flat_w,
                    mode="sum")),
                "shape": [Bk, Fk, nnz, V, d], "dtype": "float32",
                "index_slots": idx.numel(),
                "distinct_rows": distinct_rows(idx, V)}
            del out

            # the table's last row, negative indices, out-of-range -> NaN
            edge = torch.tensor([[[V - 1, 0], [-1, 5], [V, 1], [-V - 1, 2],
                                  [-V, V - 2]]], dtype=torch.int32,
                                device=dev)
            ew = torch.ones(edge.shape, device=dev)
            ew[0, 2, 0] = 0.0                  # weight 0 does not hide it
            got = embedding_bag_cuda(table, edge, ew)
            exp = torch.stack([table[V - 1] + table[0], table[V - 1]
                               + table[5], table[1], table[2],
                               table[0] + table[V - 2]])
            nan = torch.isnan(got[0]).all(dim=-1).tolist()
            fin = [0, 1, 4]
            e_err = float((got[0, fin] - exp[fin]).abs().max())
            r["edge_indices"] = {"nan_bags": nan, "max_abs_err": e_err,
                                 "last_row": V - 1}
            check(nan == [False, False, True, True, False],
                  f"out-of-range bags are not NaN (only): {nan}")
            check(e_err == 0.0, f"edge-index bags differ by {e_err}")

            # a bf16 table against plain
            nb = min(V, 1_000_000)
            tb = table[:nb].to(torch.bfloat16)
            bi = torch.randint(0, nb, (4096, 26, 2), device=dev,
                               dtype=torch.int32)
            bw = torch.rand(bi.shape, device=dev)
            got = embedding_bag_cuda(tb, bi, bw).float()
            exp = embedding_bag_plain(tb, bi, bw).float()
            r["bf16_max_rel_err"] = float((got - exp).abs().max()
                                          / exp.abs().max())
            check(r["bf16_max_rel_err"] <= TOL_RS_BF16,
                  f"bf16 embedding_bag differs from plain by "
                  f"{r['bf16_max_rel_err']} of the largest")
            del tb, bi, bw, got, exp, idx, w, flat_idx, flat_w, table
        r["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        rep[cfg.name] = r
        print(f"recsys {cfg.name}: " + json.dumps(r), flush=True)
        del params, small, bulk, logits, bulk_logits, plain

    # BERT4Rec: masked attention takes the plain path, so 0 launches
    base = resident()
    cfg = rf.BERT4REC
    params = bert4rec.init(torch.Generator(device=dev).manual_seed(0), cfg)
    r = {"resident_before_gb": base / 1e9,
         "params_gb": (torch.cuda.memory_allocated() - base) / 1e9,
         "items": cfg.n_items, "serve_bulk": "left out: a [262144, 3M] "
         "f32 score matrix is 3.1 TB"}
    toks = recsys_synth.bert4rec_batch(
        rng, batch=B_p99, seq_len=cfg.seq_len, n_items=cfg.n_items,
        n_mask=cfg.n_mask, n_neg=cfg.n_neg, mask_token=cfg.mask_token,
        device=dev)["tokens"]
    batch = {"tokens": toks}
    serve = rf.make_fn(cfg, "serve")
    ops.reset_launch_counts()
    ms = latencies_ms(torch, lambda: serve(params, batch), RS_B4R_CALLS)
    scores, ids = serve(params, batch)
    r["serve_p99"] = {"batch": B_p99, "calls": RS_B4R_CALLS,
                      "p50_ms": float(np.percentile(ms, 50)),
                      "p99_ms": float(np.percentile(ms, 99)),
                      "launches": ops.launch_counts()["embedding_bag"]}
    retrieve = rf.make_fn(cfg, "retrieval")
    cand_ids = torch.randint(1, cfg.n_items, (n_cand,), device=dev,
                             dtype=torch.int32)
    one = {"tokens": toks[:1]}
    ops.reset_launch_counts()
    ms = latencies_ms(torch, lambda: retrieve(params, one, cand_ids),
                      RS_RETRIEVAL_CALLS)
    r["retrieval_cand"] = {"candidates": n_cand, "calls": RS_RETRIEVAL_CALLS,
                           "ms": float(np.mean(ms)),
                           "p99_ms": float(np.percentile(ms, 99)),
                           "launches": ops.launch_counts()["embedding_bag"]}
    r["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    # the first rows against the same serve on the CPU
    cpu_params = tree_to(params, "cpu")
    with torch.no_grad():
        n = RS_B4R_CPU_ROWS
        s_cpu, i_cpu = bert4rec.serve(cpu_params, cfg,
                                      {"tokens": toks[:n].cpu()})
    r["cpu_check"] = {
        "rows": n,
        "scores_max_abs_err": float((scores[:n].cpu() - s_cpu).abs().max()),
        "top10_sets_equal": all(
            set(a[:10]) == set(b[:10]) for a, b in
            zip(ids[:n].cpu().tolist(), i_cpu.tolist()))}
    rep[cfg.name] = r
    print(f"recsys {cfg.name}: " + json.dumps(r), flush=True)
    check(tuple(scores.shape) == (B_p99, 100)
          and bool(torch.isfinite(scores).all()), "BERT4Rec serve scores")
    check(r["serve_p99"]["launches"] == 0
          and r["retrieval_cand"]["launches"] == 0,
          "BERT4Rec launched embedding_bag")
    check(r["cpu_check"]["scores_max_abs_err"] <= TOL_RS_B4R_CPU
          and r["cpu_check"]["top10_sets_equal"],
          f"BERT4Rec serve on the card vs the CPU: {r['cpu_check']}")
    del params, cpu_params, scores, ids, cand_ids
    gc.collect()
    torch.cuda.empty_cache()
    return rep, row


def adam_by_chunks(torch, names, params, grads) -> dict:
    """Each leaf of ``params`` the in-place Adam splits into row chunks
    takes ADAM_CHECK_STEPS steps of the LM's TRAIN_OPT, at its full lr (no
    warm-up: every element moves by ~lr) and with the clip off, over its
    gradient: once by ``adam.CHUNK`` and once with CHUNK above the leaf.
    Returns, per leaf, the errors of p, m and v chunked against whole and
    whole against Adam in f64, each relative to the largest magnitude,
    and the clip's global norm (summed by chunks) against the f64 norm."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import lm_family
    from repro_torch.optim import adam

    acfg = dataclasses.replace(lm_family.TRAIN_OPT, grad_clip=0.0)
    chunk0 = adam.CHUNK

    def rel(a, b) -> float:
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    out = {"chunk": chunk0, "steps": ADAM_CHECK_STEPS, "lr": acfg.lr,
           "leaves": {}}
    for n, p, g in zip(names, params, grads):
        if p.numel() <= chunk0:
            continue
        runs = []
        for chunk in (chunk0, p.numel()):
            adam.CHUNK = chunk
            try:
                tree = {"w": p.detach().clone()}
                st = optim.adam_init(tree)
                for _ in range(ADAM_CHECK_STEPS):
                    tree, st, _ = optim.adam_update(tree, {"w": g}, st,
                                                    acfg)
            finally:
                adam.CHUNK = chunk0
            runs.append((tree["w"], st["m"]["w"], st["v"]["w"]))
            del tree, st
        (pc, mc, vc), (pw, mw, vw) = runs
        leaf = {"shape": list(p.shape),
                "chunk_rows": chunk0 // p[0].numel(),
                "chunked_vs_whole": {"p": rel(pc, pw), "m": rel(mc, mw),
                                     "v": rel(vc, vw)}}
        # Adam in f64 over the whole leaf, a chunk of rows at a time
        err = {k: [0.0, 0.0] for k in "pmv"}
        sq, moved = 0.0, 0.0
        for rows in zip(*(t.split(leaf["chunk_rows"])
                          for t in (p.detach(), g, pw, mw, vw))):
            p0, gs = rows[0].double(), rows[1].double()
            sq += float(gs.square().sum())
            pr, mr, vr = p0, 0.0, 0.0
            for t in range(1, ADAM_CHECK_STEPS + 1):
                mr = acfg.b1 * mr + (1 - acfg.b1) * gs
                vr = acfg.b2 * vr + (1 - acfg.b2) * gs * gs
                upd = (mr / (1 - acfg.b1 ** t)) / (
                    (vr / (1 - acfg.b2 ** t)).sqrt() + acfg.eps)
                pr = pr - acfg.lr * (upd + acfg.weight_decay * pr)
            for k, got, ref in zip("pmv", rows[2:], (pr, mr, vr)):
                err[k][0] = max(err[k][0],
                                float((got.double() - ref).abs().max()))
                err[k][1] = max(err[k][1], float(ref.abs().max()))
            moved = max(moved, float((rows[2].double() - p0).abs().max()))
        leaf["whole_vs_f64"] = {k: e / max(m, 1e-30)
                                for k, (e, m) in err.items()}
        leaf["moved"] = moved
        norm = float(optim.clip_by_global_norm([g.clone()], 1.0))
        leaf["norm"] = {"chunked": norm, "f64": sq ** 0.5,
                        "rel_err": abs(norm / sq ** 0.5 - 1)}
        out["leaves"][n] = leaf
        del runs, pc, mc, vc, pw, mw, vw
    return out


def lm_train_phase(torch, np, dev):
    """The LM family's training path (see the module docstring, phase 10).
    Returns (report, the launch counts of the timed run's four steps)."""
    import dataclasses
    import gc

    from repro_torch import optim
    from repro_torch.configs import lm_family
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        _bwd_cuda_as_written, _bwd_plain_f32, flash_attention_cuda)
    from repro_torch.models import lm
    from repro_torch.optim.adam import leaves

    S = lm_family.LM_SHAPES["train_4k"]["seq"]
    B = lm_family.ONE_CARD_TRAIN["batch"]
    bf16 = torch.bfloat16
    gt = torch.Generator(device=dev).manual_seed(4)

    def batch_of(cfg, B):
        return lm_family.train_batch(cfg, B, S, gt, dev)

    def resident() -> int:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def launches_since(before):
        now = ops.launch_counts()
        return {k: now[k] - before[k] for k in FLASH_KERNELS}

    # ---- the timed run: depth 8, B=2, S=4,096, bf16
    base = resident()
    cfg = dataclasses.replace(lm_family.QWEN3_14B,
                              n_layers=lm_family.ONE_CARD_TRAIN["n_layers"])
    L = cfg.n_layers
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, bf16)
    opt = optim.adam_init(params)
    state_gb = (torch.cuda.memory_allocated() - base) / 1e9
    before = {p: t.detach().to("cpu", copy=True) for p, t in leaves(params)}
    step = lm_family.make_fn(cfg, "train")
    batch = batch_of(cfg, B)
    tokens = B * S
    losses, step_s, per_step = [], [], []
    ops.reset_launch_counts()
    for _ in range(1 + LM_TRAIN_TIMED):
        b0 = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        per_step.append(launches_since(b0))
    launches = ops.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    s_step = float(np.mean(step_s[1:]))
    changed = {p: int((t != before[p].to(dev)).sum())
               for p, t in leaves(params)}
    m_zero = [p for p, t in leaves(opt["m"]) if not bool(t.ne(0).any())]
    rep = {"config": cfg.name, "layers": L, "batch": B,
           "seq": S, "params": cfg.param_count(), "state_gb": state_gb,
           "losses": losses, "step_s": step_s, "s_per_step": s_step,
           "tokens_per_s": tokens / s_step,
           "model_tflop_per_s": 6 * cfg.active_param_count() * tokens
           / s_step / 1e12,
           "peak_gb": peak_gb, "resident_before_gb": base / 1e9,
           "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
           "count": int(opt["count"]), "launches_per_step": per_step,
           "launches": {k: launches[k] for k in per_step[0]},
           "elements_changed": changed}
    print("lm-train: " + json.dumps({k: v for k, v in rep.items()
                                     if k != "elements_changed"}),
          flush=True)
    check(all(np.isfinite(losses)), f"LM train losses {losses}")
    check(rep["count"] == 1 + LM_TRAIN_TIMED, f"opt count {rep['count']}")
    # the forward and its remat recompute on the route forward_route picks,
    # the backward on backward_route's (bf16 at head dim 128: the Hopper
    # kernels)
    want = {**flash_fwd_launches(bf16, cfg.hd, 2 * L),
            **flash_bwd_launches(bf16, cfg.hd, L)}
    check(all(c == want for c in per_step),
          f"LM train launches per step {per_step}, expected {want}")
    # every leaf got a gradient and an update of its moments; every matrix
    # moved. A norm scale (1.0 in bf16, an ulp of 2^-7) cannot move by an
    # Adam step of lr ~1e-5: its count is reported, not held
    check(not m_zero, f"leaves whose first moment is still 0: {m_zero}")
    still = [p for p, t in leaves(params) if t.dim() >= 2 and changed[p] == 0]
    check(not still, f"matrices that did not move: {still}")

    # ---- the Hopper backward on layer 0's own attention inputs in a bf16
    # step: q, k, v as that layer's projections give them and dO as the
    # loss sends it back (the output's gradient, by a hook), o and lse
    # from the Hopper forward on them; held to plain as at the train shape
    # below (bwd_hopper_errors: f32 before the cast, element-wise after
    # it, the dropped-key-tile controls)
    acts = {}
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True):
        out = real(q, k, v, causal=causal)
        if not acts and out.requires_grad:         # layer 0's first call
            acts.update(q=q.detach().clone(), k=k.detach().clone(),
                        v=v.detach().clone())
            out.register_hook(
                lambda g: acts.setdefault("do", g.detach().clone()))
        return out

    ops.flash_attention = spy
    try:
        params, opt, m = step(params, opt, batch)
    finally:
        ops.flash_attention = real
    del params, opt, before, batch, step, m
    resident()
    q, k, v, do = (acts[n] for n in ("q", "k", "v", "do"))
    # the gradients are linear in dO, and a power of two scales bf16 and
    # every f32 product exactly, in both versions: dO is brought to an RMS
    # in [0.5, 1) so that the element-wise limit's absolute term (1e-4, for
    # unit-scale gradients) stays below them, as on the random inputs
    # (layer 0's own dO is ~1e-4, where the absolute term alone would pass
    # a dropped key tile; the f32 limit, relative, is unmoved by the scale)
    do_rms = float(do.float().square().mean().sqrt())
    do_scale = 2.0 ** -torch.frexp(torch.tensor(do_rms)).exponent.item()
    do = do * do_scale
    o, lse = flash_attention_cuda(q, k, v, True)
    # a check's launches, counted from 0 (the kernels line's
    # check_launches)
    ops.reset_launch_counts()
    got = _bwd_cuda_as_written(q, k, v, o, lse, do, True)
    act_launches = {n: ops.launch_counts()[n] for n in FLASH_KERNELS}
    exp = _bwd_plain_f32(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    check(act_launches == {**flash_fwd_launches(bf16, cfg.hd, 0),
                           **flash_bwd_launches(bf16, cfg.hd, 1)},
          f"layer-0 backward launches {act_launches}")
    rep["layer0_bwd"] = {
        "shape": list(q.shape) + [k.shape[2]], "launches": act_launches,
        "do_rms": do_rms, "do_scale": do_scale,
        **bwd_hopper_errors(q, k, v, o, lse, do, got, exp, "layer 0")}
    print("lm-train layer-0 backward: " + json.dumps(rep["layer0_bwd"]),
          flush=True)
    del acts, q, k, v, do, o, lse, got, exp

    # ---- accumulation over two microbatches of 1 x 4,096: depth 2
    base = resident()
    cfg2 = dataclasses.replace(lm_family.QWEN3_14B, n_layers=LM_CHECK_LAYERS)
    L2 = cfg2.n_layers
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg2, bf16)
    opt = optim.adam_init(params)
    step = optim.make_train_step(
        lambda p, b: lm.lm_loss(p, cfg2, b),
        dataclasses.replace(lm_family.TRAIN_OPT, accum_steps=2),
        lm_family.TRAIN_SCHEDULE)
    b0 = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch_of(cfg2, 2))
    torch.cuda.synchronize()
    rep["accum"] = {"layers": L2, "accum_steps": 2, "microbatch": [1, S],
                    "s": time.perf_counter() - t0, "loss": float(m["loss"]),
                    "launches": launches_since(b0),
                    "peak_gb": (torch.cuda.max_memory_allocated() - base)
                    / 1e9}
    print("lm-train accum: " + json.dumps(rep["accum"]), flush=True)
    want = {**flash_fwd_launches(bf16, cfg2.hd, 4 * L2),
            **flash_bwd_launches(bf16, cfg2.hd, 2 * L2)}
    check(np.isfinite(rep["accum"]["loss"]), "non-finite accumulated loss")
    check(rep["accum"]["launches"] == want, f"accumulated step launches "
          f"{rep['accum']['launches']}, expected {want}")
    del params, opt, step, m

    # ---- kernel vs plain: loss and gradients, depth 2, f32, B=1
    base = resident()
    cfgf = dataclasses.replace(cfg2, dtype="float32")
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfgf,
                     torch.float32)
    names = [p for p, _ in leaves(params)]
    flat = [t.requires_grad_() for _, t in leaves(params)]
    batch = batch_of(cfgf, 1)
    res = {}
    for impl in ("kernel", "plain"):
        ops.reset_launch_counts()
        b0 = ops.launch_counts()
        loss, _ = lm.lm_loss(params, cfgf, batch, impl=impl)
        res[impl] = (float(loss.detach()),
                     torch.autograd.grad(loss, flat), launches_since(b0))
        del loss
    (lk, gk, ck), (lp, gp, cp) = res["kernel"], res["plain"]
    ratios = {n: float((a - b).abs().max()) / max(float(b.abs().max()),
                                                  1e-30)
              for n, a, b in zip(names, gk, gp)}
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    rep["plain"] = {"layers": L2, "batch": 1, "seq": S, "dtype": "float32",
                    "loss_kernel": lk, "loss_plain": lp,
                    "loss_abs_err": abs(lk - lp),
                    "grad_worst_rel_err": worst[0][1],
                    "grad_worst_leaves": worst, "n_grad_leaves": len(names),
                    "launches_kernel": ck, "launches_plain": cp,
                    "peak_gb": (torch.cuda.max_memory_allocated() - base)
                    / 1e9}
    print("lm-train plain: " + json.dumps(rep["plain"]), flush=True)
    check(abs(lk - lp) <= TOL_LOSS, f"LM train loss kernel {lk} vs plain "
          f"{lp}")
    check(worst[0][1] <= TOL_GRAD, f"LM gradient leaf {worst[0][0]} "
          f"differs by {worst[0][1]} of its magnitude")
    # f32 at head dim 128: the forward and the backward on the 3xTF32
    # kernels
    check(sum(cp.values()) == 0 and ck == {
        **flash_fwd_launches(torch.float32, cfgf.hd, 2 * L2),
        **flash_bwd_launches(torch.float32, cfgf.hd, L2)},
        f"launches kernel {ck}, plain {cp}")
    del res, gp, batch

    # ---- the in-place Adam by row chunks, on the card, over the f32
    # kernel gradients
    rep["adam"] = adam_by_chunks(torch, names, flat, gk)
    print("lm-train adam: " + json.dumps(rep["adam"]), flush=True)
    split = rep["adam"]["leaves"]
    check(len(split) == 2 + 3 * L2,
          f"Adam split {sorted(split)}, expected embed, head and "
          f"{3 * L2} FFN matrices")
    bad = {n: e for n, e in split.items()
           if max(*e["chunked_vs_whole"].values(),
                  *e["whole_vs_f64"].values()) > TOL_ADAM
           or e["norm"]["rel_err"] > TOL_ADAM_NORM}
    check(not bad, f"Adam by row chunks: {bad}")
    del params, flat, gk
    resident()
    return rep, launches


def cast_(torch, tree, dtype):
    """Cast every tensor of a nested dict/list in place, one at a time
    (the peak is the new tree plus one old leaf)."""
    keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
    for key in list(keys):
        if torch.is_tensor(tree[key]):
            tree[key] = tree[key].to(dtype)
        else:
            cast_(torch, tree[key], dtype)


def routed(fn):
    """Run fn() with ``moe._route`` spied on: returns (fn's result, the
    experts [T, k] of every MoE call in order)."""
    from repro_torch.nn import moe
    real, seen = moe._route, []

    def spy(p, x2d, mcfg):
        out = real(p, x2d, mcfg)
        seen.append(out[1])
        return out

    moe._route = spy
    try:
        return fn(), seen
    finally:
        moe._route = real


def lm_by_layer(torch, params, cfg, toks) -> dict:
    """Layer by layer at S=toks' length, in cfg's dtype: each layer's
    attention output (chunked-local or global, as ``cfg.is_local``)
    through the kernel against plain on the plain path's hidden state
    (``local``), and the gap between the hidden states the two paths
    carry to the next layer (``carried``), each relative to the plain
    value's largest magnitude. Two flash launches a layer. For an MoE
    config also the tokens whose expert set differs between the two
    paths' layers (``expert_sets_differ``): a hard top-k turns a
    rounding-sized gap into a different expert."""
    from repro_torch.models import lm
    from repro_torch.nn import attention, embed, rmsnorm
    local, carried = [], []

    def run():
        with torch.no_grad():
            x = embed(params["embed"], toks, dtype=cfg.torch_dtype)
            x_k = x
            for i, layer in enumerate(params["layers"]):
                acfg = cfg.attn_cfg(local=cfg.is_local(i))
                h = rmsnorm(layer["ln1"], x)
                a_k = attention(layer["attn"], h, acfg,
                                impl="kernel").float()
                a_p = attention(layer["attn"], h, acfg,
                                impl="plain").float()
                local.append(float((a_k - a_p).abs().max()
                                   / a_p.abs().max()))
                x_k = lm._block(layer, x_k, cfg, "kernel",
                                cfg.is_local(i))[0]
                x = lm._block(layer, x, cfg, "plain", cfg.is_local(i))[0]
                carried.append(float((x_k.float() - x.float()).abs().max()
                                     / x.float().abs().max()))

    # an MoE layer routes twice: the kernel path's block, then the plain's
    _, seen = routed(run)
    out = {"seq": toks.shape[1], "attn_local_max_rel_err": local,
           "hidden_carried_max_rel_err": carried}
    if cfg.is_moe:
        out["expert_sets_differ"] = [
            int((e_k.sort(-1)[0] != e_p.sort(-1)[0]).any(-1).sum())
            for e_k, e_p in zip(seen[0::2], seen[1::2])]
    return out


def chunked_plain(torch, q, k, v, chunk: int, block: int):
    """The chunked-local function in plain PyTorch without its whole
    logits: each hard chunk a causal sequence of its own, ``block`` query
    rows at a time through the flash kernel's plain version (rows i..i +
    block of a chunk see the chunk's keys up to i + block, the causal
    diagonal at the end). Returns (o, lse)."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd_plain
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    for c0 in range(0, S, chunk):
        for i in range(0, chunk, block):
            rows, keys = slice(c0 + i, c0 + i + block), slice(c0,
                                                              c0 + i + block)
            o[:, rows], lse[:, :, rows] = flash_attention_fwd_plain(
                q[:, rows], k[:, keys], v[:, keys], True)
    return o, lse


def chunked_route_check(torch, dev, cfg) -> tuple:
    """Check (a) of the lm-moe phase: ``nn.attention.chunked_flash`` (the
    chunked-local route, one flash launch over the B S/chunk hard chunks)
    against ``chunked_plain`` at cfg's heads, B=1, S=MOE_CHUNK_CHECK_SEQ,
    in f32 and bf16, with the flash checks' limits (bf16 also
    element-wise, beside the dropped-key-tile control that must miss).
    Returns (errors by dtype, the launches by route, each counted from
    0)."""
    from repro_torch.kernels import ops
    from repro_torch.nn.attention import chunked_flash
    c, S = cfg.chunk_size, MOE_CHUNK_CHECK_SEQ
    g = torch.Generator(device=dev).manual_seed(3)
    errs, launches = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q = torch.randn(1, S, cfg.n_heads, cfg.hd, generator=g,
                        device=dev).to(dtype)
        k, v = (torch.randn(1, S, cfg.n_kv, cfg.hd, generator=g,
                            device=dev).to(dtype) for _ in range(2))
        ops.reset_launch_counts()
        o = chunked_flash(q, k, v, chunk=c)
        torch.cuda.synchronize()
        now = ops.launch_counts()
        launches[name] = {n: now[n] for n in FLASH_FWD}
        check(launches[name] == flash_fwd_launches(dtype, cfg.hd, 1),
              f"the chunked route in {name} launched {launches[name]}")
        o_p, _ = chunked_plain(torch, q, k, v, c, MOE_PLAIN_BLOCK)
        e = {"o": float((o.float() - o_p.float()).abs().max()),
             "shape": [1, S, cfg.n_heads, cfg.n_kv, cfg.hd], "chunk": c}
        ok = e["o"] <= TOL_FLASH[name]
        if dtype == torch.bfloat16:
            e["o_over_limit"] = flash_miss(o, o_p)
            # the control: chunk 0's last key tile dropped, which only that
            # chunk's last 64 rows see
            o_c, _ = chunked_plain(torch, q, k, dropped_tile(v, c - 64), c,
                                   MOE_PLAIN_BLOCK)
            e["control_o_over_limit"] = flash_miss(o_c, o_p)
            ok = ok and e["o_over_limit"] <= 1
            check(e["control_o_over_limit"] > 1,
                  f"chunked route: the bf16 limit misses a dropped key "
                  f"tile: {e}")
            del o_c
        errs[name] = e
        check(ok, f"the chunked route in {name} differs from plain: {e}")
        del q, k, v, o, o_p
    return errs, launches


def lm_moe_phase(torch, np, dev):
    """The MoE members of the LM family (see the module docstring, phase
    9b). Returns (report, the flash forward launches by route of each
    config's timed prefill and decode runs)."""
    import dataclasses

    from repro_torch.configs import lm_family
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.nn import moe as moe_mod

    bf16 = torch.bfloat16
    rep = {}
    t_phase = time.perf_counter()
    # (a) the chunked route against plain, at Scout's heads
    rep["chunked_route"], chunk_launches = chunked_route_check(
        torch, dev, lm_family.LLAMA4_SCOUT)
    rep["chunked_route"]["launches"] = chunk_launches
    print("lm-moe chunked route: " + json.dumps(rep["chunked_route"]),
          flush=True)
    main_launches = {}

    def flash_shapes(fn):
        """Run fn() with ``ops.flash_attention`` spied on: returns (fn's
        result, [B, S] of q in each call)."""
        real, seen = ops.flash_attention, []

        def spy(q, k, v, *, causal=True):
            seen.append(list(q.shape[:2]))
            return real(q, k, v, causal=causal)

        ops.flash_attention = spy
        try:
            return fn(), seen
        finally:
            ops.flash_attention = real

    for base in (lm_family.DBRX_132B, lm_family.LLAMA4_SCOUT):
        cfg = lm_family.one_card_serve(base)
        mcfg = cfg.moe_cfg()
        L, V = cfg.n_layers, cfg.vocab
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                         bf16)
        torch.cuda.synchronize()
        r = {"config": dataclasses.asdict(cfg),
             "full_depth": base.n_layers,
             "params": cfg.param_count(),
             "active_params": cfg.active_param_count(),
             "params_gb": torch.cuda.memory_allocated() / 1e9,
             "init_s": time.perf_counter() - t0}
        prefill = lm_family.make_fn(cfg, "prefill")
        decode = lm_family.make_fn(cfg, "decode")
        gl = torch.Generator(device=dev).manual_seed(2)

        # ---- prefill at B=1, S=32,768: a warm-up (its routing read back
        # for the dropped assignments), then the timed one
        toks = torch.randint(0, V, (1, LM_PREFILL_SEQ), generator=gl,
                             device=dev)
        t0 = time.perf_counter()
        _, experts = routed(lambda: prefill(params, toks))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        C = moe_mod.capacity_for(LM_PREFILL_SEQ, mcfg)
        dropped = []
        for e in experts:
            counts = torch.bincount(e.reshape(-1), minlength=mcfg.n_experts)
            dropped.append(int((counts - C).clamp_min(0).sum()))
        del experts
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        last, shapes = flash_shapes(lambda: prefill(params, toks))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        now = ops.launch_counts()
        flash_n = {n: now[n] for n in FLASH_FWD}
        n_chunked = sum(s == [LM_PREFILL_SEQ // cfg.chunk_size,
                              cfg.chunk_size] for s in shapes) \
            if cfg.chunk_size else 0
        n_local = sum(cfg.is_local(i) for i in range(L)) \
            if cfg.chunk_size else 0
        r["prefill"] = {
            "batch": 1, "seq": LM_PREFILL_SEQ, "warmup_s": warm_s,
            "s": prefill_s, "tokens_per_s": LM_PREFILL_SEQ / prefill_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": flash_n, "flash_q_shapes": shapes,
            "chunked_launches": n_chunked, "capacity": C,
            "assignments_per_layer": LM_PREFILL_SEQ * mcfg.top_k,
            "dropped_per_layer": dropped}
        print(f"lm-moe {cfg.name} prefill: " + json.dumps(r["prefill"]),
              flush=True)
        check(tuple(last.shape) == (1, V), f"{cfg.name} prefill logits "
              f"{tuple(last.shape)}")
        check(bool(torch.isfinite(last).all()),
              f"non-finite {cfg.name} prefill logits")
        want = flash_fwd_launches(bf16, cfg.hd, L)
        check(flash_n == want, f"{cfg.name} prefill flash launches "
              f"{flash_n}, expected {want}")
        check(len(shapes) == L and n_chunked == n_local,
              f"{cfg.name}: {n_chunked} chunked flash launches of "
              f"{len(shapes)} ({shapes}), expected {n_local}")
        check(r["prefill"]["peak_gb"] < 80, f"{cfg.name} prefill peak "
              f"{r['prefill']['peak_gb']} GB")
        del toks, last
        gc_collect(torch)

        # ---- decode: greedy steps from a given slot, synchronised
        def run_decode(batch, slots, start, steps, fill):
            torch.cuda.reset_peak_memory_stats()
            cache = lm.init_cache(cfg, batch, slots, bf16, device=dev)
            if fill:                     # the slots before start, seeded
                gf = torch.Generator(device=dev).manual_seed(5)
                for t in cache.values():
                    t.normal_(generator=gf)
            tok = torch.randint(0, V, (batch, 1), generator=gl, device=dev)
            ops.reset_launch_counts()
            ms = []
            for t in range(start, start + steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = decode(params, tok, cache, t)
                tok = logits.argmax(dim=-1, keepdim=True)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            now = ops.launch_counts()
            d = {"batch": batch, "slots": slots, "start": start,
                 "steps": steps, "cache_gb": sum(
                     nbytes(t) for t in cache.values()) / 1e9,
                 "filled": fill, "first_step_ms": ms[0],
                 "ms_per_step": float(np.mean(ms[1:])),
                 "ms_per_step_median": float(np.median(ms[1:])),
                 "tokens_per_s": batch * 1e3 / float(np.mean(ms[1:])),
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "flash_launches": {n: now[n] for n in FLASH_FWD}}
            check(bool(torch.isfinite(logits).all()),
                  f"non-finite {cfg.name} decode logits")
            check(not any(d["flash_launches"].values()),
                  f"{cfg.name} decode launched the flash forward "
                  f"{d['flash_launches']}")
            check(d["peak_gb"] < 80, f"{cfg.name} decode peak "
                  f"{d['peak_gb']} GB")
            del cache, logits
            gc_collect(torch)
            return d

        runs = ({"decode": (LM_DECODE_BATCH, LM_DECODE_SLOTS, 0,
                            LM_DECODE_STEPS, False)} if not cfg.chunk_size
                else {"decode": MOE_SCOUT_DECODE,
                      "long_500k": MOE_LONG_DECODE})
        for name, args in runs.items():
            r[name] = run_decode(*args)
            print(f"lm-moe {cfg.name} {name}: " + json.dumps(r[name]),
                  flush=True)
        main_launches[cfg.name] = {"prefill": flash_n, **{
            name: r[name]["flash_launches"] for name in runs}}

        # ---- (d) layer by layer in bf16 at the serving cut
        plain_toks = torch.randint(0, V, (1, LM_PLAIN_SEQ), generator=gl,
                                   device=dev)
        dec_toks = torch.randint(0, V, (1, MOE_CHECK_T), generator=gl,
                                 device=dev)
        ops.reset_launch_counts()
        r["by_layer"] = lm_by_layer(torch, params, cfg, plain_toks)
        now = ops.launch_counts()
        r["by_layer"]["flash_launches"] = {n: now[n] for n in FLASH_FWD}
        print(f"lm-moe {cfg.name} by_layer: " + json.dumps(r["by_layer"]),
              flush=True)
        local = r["by_layer"]["attn_local_max_rel_err"]
        worst = int(np.argmax(local))
        check(local[worst] <= TOL_ATTN_BF16,
              f"{cfg.name}: bf16 attention of layer {worst}, kernel vs "
              f"plain on the same input, differs by {local[worst]}")
        check(r["by_layer"]["flash_launches"]
              == flash_fwd_launches(bf16, cfg.hd, 2 * L),
              f"{cfg.name} by-layer flash launches "
              f"{r['by_layer']['flash_launches']}")

        # ---- (b), (c) in f32 at a reduced depth: the first layers, cast
        depth = MOE_CHECK_DEPTH[cfg.name]
        del params["layers"][depth:]
        gc_collect(torch)
        cast_(torch, params, torch.float32)
        c32 = dataclasses.replace(cfg, n_layers=depth, dtype="float32")
        ops.reset_launch_counts()
        with torch.no_grad():
            ref = lm.prefill(params, c32, dec_toks).float()
            cache = lm.init_cache(c32, 1, MOE_CHECK_T, torch.float32,
                                  device=dev)
            for t in range(MOE_CHECK_T):
                logits, cache = lm.decode_step(params, c32,
                                               dec_toks[:, t:t + 1], cache, t)
            kern, e_k = routed(lambda: lm.prefill(params, c32, plain_toks))
            plain_l, e_p = routed(lambda: lm.prefill(params, c32, plain_toks,
                                                     impl="plain"))
        now = ops.launch_counts()
        differ = sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
                     for a, b in zip(e_k, e_p))
        r["check"] = {
            "depth": depth, "tol_rel_f32": TOL_LM_REL_F32,
            "prefill_vs_decode": {
                "batch": 1, "T": MOE_CHECK_T,
                "max_rel_err": float((logits.float() - ref).abs().max()
                                     / ref.abs().max()),
                "argmax_agree": bool((logits.argmax(-1)
                                      == ref.argmax(-1)).all())},
            "kernel_vs_plain": {
                "seq": LM_PLAIN_SEQ,
                "max_rel_err": float((kern.float() - plain_l.float())
                                     .abs().max() / plain_l.abs().max()),
                "expert_sets_differ": differ,
                "expert_sets": depth * LM_PLAIN_SEQ},
            "flash_launches": {n: now[n] for n in FLASH_FWD}}
        print(f"lm-moe {cfg.name} check: " + json.dumps(r["check"]),
              flush=True)
        check(len(e_k) == len(e_p) == depth, f"{cfg.name}: {len(e_k)}, "
              f"{len(e_p)} MoE calls, expected {depth}")
        for name in ("prefill_vs_decode", "kernel_vs_plain"):
            err = r["check"][name]["max_rel_err"]
            check(err <= TOL_LM_REL_F32, f"{cfg.name} f32 {name} logits "
                  f"differ by {err} of the largest")
        # two kernel prefills (T=8, S=2,048), each a launch a layer, on
        # the f32 route
        check(r["check"]["flash_launches"]
              == flash_fwd_launches(torch.float32, cfg.hd, 2 * depth),
              f"{cfg.name} f32 check flash launches "
              f"{r['check']['flash_launches']}")
        del params, ref, cache, logits, kern, plain_l, e_k, e_p
        gc_collect(torch)
        rep[cfg.name] = r
    rep["s"] = time.perf_counter() - t_phase
    print(f"lm-moe: {rep['s']:.1f} s", flush=True)
    return rep, main_launches


def ebag_kernel(symbol: str):
    """``embedding_bag_kernel<dtype,VEC>`` or ``ebag_bwd_*_kernel<...>``
    for a mangled EmbeddingBag symbol, else None."""
    import re
    m = re.search(r"(embedding_bag_kernel|ebag_bwd_chunk_kernel|"
                  r"ebag_bwd_combine_kernel)I(f|13__nv_bfloat16)Li(\d)E",
                  symbol)
    if m:
        return f"{m[1]}<{'float' if m[2] == 'f' else 'bf16'},{m[3]}>"
    return "ebag_bwd_keys_kernel" if "ebag_bwd_keys_kernel" in symbol \
        else None


def leaf_sum(torch, t) -> float:
    """The f64 sum of a leaf, by row chunks (no f64 copy of a whole
    leaf): a fingerprint that moves when the leaf moves."""
    return float(sum(c.double().sum()
                     for c in t.detach().reshape(-1).split(1 << 24)))


def chunked_max_abs(torch, a, b) -> float:
    """max |a - b| in f64 over chunks of the first axis of two tensors."""
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a.split(1 << 20), b.split(1 << 20)))


def ebag_bwd_checks(torch, np, dev, rng, ptxas) -> dict:
    """The EmbeddingBag backward kernel against its plain version in f64 at
    the train shapes (see the module docstring, phase 12); returns the
    kernel row (its ``launches`` filled in by the caller)."""
    import gc

    from repro_torch.configs import recsys_family as rf
    from repro_torch.data import recsys_synth
    from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_cuda,
                                                   embedding_bag_bwd_plain)
    from repro_torch.kernels.embedding_bag import bwd_work as ebag_bwd_work
    from repro_torch.models.recsys import common

    B = rf.RS_SHAPES["train_batch"]["batch"]
    g = torch.Generator(device=dev).manual_seed(11)

    def shifted(cfg, spec):
        b = recsys_synth.ctr_batch(
            rng, batch=B, n_dense=cfg.n_dense, vocab_sizes=spec.vocab_sizes,
            nnz=spec.nnz, device=dev)
        idx = (b["sparse_idx"] + common.field_offsets(spec, dev)[
            None, :, None]).contiguous()
        return idx, b["sparse_w"], common.padded_rows(spec.total_rows)

    def hold(label, dout, idx, w, V) -> dict:
        got = embedding_bag_bwd_cuda(dout, idx, w, V)
        again = embedding_bag_bwd_cuda(dout, idx, w, V)
        torch.cuda.synchronize()
        r = {"shape": list(idx.shape) + [V, dout.shape[-1]],
             "dtype": str(dout.dtype).replace("torch.", ""),
             "bitwise_repeat": bool(torch.equal(got, again))}
        del again
        exp = embedding_bag_bwd_plain(dout.double(), idx, w, V)
        top = float(exp.abs().max())
        r["max_abs_g"], r["max_abs_err"] = top, chunked_max_abs(torch, got,
                                                                exp)
        r["rel_err"] = r["max_abs_err"] / max(top, 1e-30)
        if dout.dtype == torch.bfloat16:
            # one bf16 ulp of each value plus the f32 limit
            r["over_bf16_ulp"] = int(sum(
                int(((x.double() - y).abs() > EBAG_BF16_RTOL * y.abs()
                     + TOL_EBAG_BWD * top).sum())
                for x, y in zip(got.split(1 << 20), exp.split(1 << 20))))
            ok = r["over_bf16_ulp"] == 0
        else:
            ok = r["rel_err"] <= TOL_EBAG_BWD
        r["zero_rows_match"] = bool(all(
            torch.equal(x == 0, y == 0) for x, y in
            zip(got.split(1 << 20), exp.split(1 << 20))))
        print(f"embedding_bag_bwd {label}: " + json.dumps(r), flush=True)
        check(ok, f"embedding_bag_bwd {label} differs from plain in f64: "
              f"{r}")
        check(r["bitwise_repeat"], f"embedding_bag_bwd {label} does not "
              f"repeat bit for bit")
        check(r["zero_rows_match"],
              f"embedding_bag_bwd {label}: rows no slot names are not 0")
        del got, exp
        gc.collect()
        torch.cuda.empty_cache()
        return r

    checks = {}
    idx, w, V = shifted(rf.DLRM_RM2, rf.DLRM_RM2.sparse)
    d = rf.DLRM_RM2.sparse.embed_dim
    dout = torch.randn(*idx.shape[:2], d, generator=g, device=dev)
    checks["dlrm_train_shape"] = hold("dlrm_train_shape", dout, idx, w, V)
    hot = torch.full_like(idx, V // 3)           # every slot on one row
    checks["hot_row"] = hold("hot_row", dout, hot, w, V)
    del hot
    edge = idx.clone()                 # negatives count from the end;
    edge.view(-1)[::7] -= V            # every 13th slot out of range
    edge.view(-1)[1::13] += V
    checks["negative_and_out_of_range"] = hold(
        "negative_and_out_of_range", dout, edge, w, V)
    del edge
    checks["bf16"] = hold("bf16", dout.bfloat16(), idx, w, V)
    wide = rf.WIDE_DEEP.wide_spec
    w_idx, w_w, w_V = shifted(rf.WIDE_DEEP, wide)
    w_dout = torch.randn(*w_idx.shape[:2], 1, generator=g, device=dev)
    checks["wide_d1"] = hold("wide_d1", w_dout, w_idx, w_w, w_V)
    del w_idx, w_w, w_dout

    # timed at DLRM-RM2's train shape, f32, beside plain and the library
    Bk, Fk, nnz = idx.shape
    flat = idx.view(-1).long()
    src = (dout[:, :, None, :] * w[..., None]).reshape(-1, d)
    row = {
        "name": "embedding_bag_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/nn/embedding_bag.py:29 (no Pallas "
                    "counterpart: XLA's scatter-add, the transpose of "
                    "jnp.take)",
        "max_abs_err": checks["dlrm_train_shape"]["max_abs_err"],
        "ms": time_ms(torch, lambda: embedding_bag_bwd_cuda(dout, idx, w, V),
                      iters=10),
        "plain_ms": time_ms(torch, lambda: embedding_bag_bwd_plain(
            dout, idx, w, V), iters=3, warmup=1),
        "library_ms": time_ms(torch, lambda: torch.zeros(
            V, d, device=dev).index_add_(0, flat, src), iters=10),
        "library": "torch.zeros + index_add_ (float atomics)",
        "shape": [Bk, Fk, nnz, V, d], "dtype": "float32",
        "index_slots": idx.numel(), "distinct_rows": distinct_rows(idx, V),
        "checks": checks, "ptxas": ptxas}
    row["bound_ms"], row["bound_by"] = bound_ms(
        ebag_bwd_work(V, d, Bk, Fk, nnz, dout.dtype, True))
    del src
    # F.embedding_bag's backward alone (its graph kept), as a second yardstick
    table = torch.zeros(V, d, device=dev, requires_grad=True)
    out = torch.nn.functional.embedding_bag(
        idx.view(Bk * Fk, nnz), table, per_sample_weights=w.view(Bk * Fk, nnz),
        mode="sum")
    gout = dout.view(Bk * Fk, d)
    row["library_embedding_bag_bwd_ms"] = time_ms(
        torch, lambda: torch.autograd.grad(out, table, gout,
                                           retain_graph=True), iters=5)
    del out, table, gout, dout, idx, w, flat
    gc.collect()
    torch.cuda.empty_cache()
    return row


def recsys_train_phase(torch, np, dev, ptxas):
    """The recsys family's training path at full width (see the module
    docstring, phase 12). Returns (report, the embedding_bag_bwd kernel
    row, the main path's embedding_bag launches by config)."""
    import dataclasses
    import gc

    from repro_torch import optim
    from repro_torch.configs import recsys_family as rf
    from repro_torch.data import recsys_synth
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import bert4rec, ctr
    from repro_torch.optim.adam import leaves

    B = rf.RS_SHAPES["train_batch"]["batch"]
    rng = np.random.default_rng(23)

    def resident() -> int:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    resident()
    row = ebag_bwd_checks(torch, np, dev, rng, ptxas)
    rep = {"tol_grad_rel": TOL_RS_TRAIN_GRAD, "batch": B}
    fwd_launches = {}
    for cfg, per_step in ((rf.DLRM_RM2, 1), (rf.WIDE_DEEP, 2),
                          (rf.DCN_V2, 1), (rf.BERT4REC, 0)):
        base = resident()
        is_ctr = cfg is not rf.BERT4REC
        gen = torch.Generator(device=dev).manual_seed(0)
        params = (ctr if is_ctr else bert4rec).init(gen, cfg)
        t0 = time.perf_counter()
        if is_ctr:
            batch = recsys_synth.ctr_batch(
                rng, batch=B, n_dense=cfg.n_dense,
                vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz,
                device=dev)
            accum = 1
        else:
            batch = recsys_synth.bert4rec_batch(
                rng, batch=B, seq_len=cfg.seq_len, n_items=cfg.n_items,
                n_mask=cfg.n_mask, n_neg=cfg.n_neg,
                mask_token=cfg.mask_token, device=dev)
            accum = rf.B4R_ONE_CARD_ACCUM
        r = {"resident_before_gb": base / 1e9,
             "params_gb": (torch.cuda.memory_allocated() - base) / 1e9,
             "batch_s": time.perf_counter() - t0,
             "accum_steps": accum, "microbatch": B // accum}

        if is_ctr:
            # one step's gradients, the kernels against impl="plain"
            flat = [p.requires_grad_() for _, p in leaves(params)]
            grads = {}
            for impl in ("kernel", "plain"):
                with torch.enable_grad():
                    loss, _ = ctr.loss(params, cfg, batch, impl=impl)
                    grads[impl] = torch.autograd.grad(loss, flat)
                del loss
            errs = {}
            for (path, _), a, b in zip(leaves(params), grads["kernel"],
                                       grads["plain"]):
                top = max(float(b.abs().max()), 1e-30)
                errs[path] = chunked_max_abs(torch, a.reshape(-1),
                                             b.reshape(-1)) / top
            del grads, a, b
            worst = max(errs, key=errs.get)
            r["grad_vs_plain"] = {"worst_leaf": worst,
                                  "worst_rel_err": errs[worst],
                                  "by_leaf": errs}
            check(errs[worst] <= TOL_RS_TRAIN_GRAD,
                  f"{cfg.name} gradient of {worst}, kernels vs plain, "
                  f"differs by {errs[worst]} of its largest magnitude")
            for p in flat:
                p.requires_grad_(False)
            del flat
            gc.collect()
            torch.cuda.empty_cache()

        r["grad_check_peak_gb"] = (torch.cuda.max_memory_allocated()
                                   - base) / 1e9
        torch.cuda.reset_peak_memory_stats()
        state = [params, optim.adam_init(params)]
        if is_ctr:
            step = rf.make_fn(cfg, "train")
        else:     # the batch as microbatches, as the LM accumulation checks
            step = optim.make_train_step(
                lambda p, b: bert4rec.loss(p, cfg, b),
                dataclasses.replace(rf.RS_OPT, accum_steps=accum))
        before = {path: leaf_sum(torch, p) for path, p in leaves(params)}
        losses = []

        def one_step():
            state[0], state[1], m = step(state[0], state[1], batch)
            losses.append(float(m["loss"]))

        # the main path: the counts from 0 just before, read just after
        ops.reset_launch_counts()
        one_step()                                       # warm-up
        torch.cuda.synchronize()
        warm = ops.launch_counts()
        ms = []
        for _ in range(RS_TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        n_steps = 1 + RS_TRAIN_TIMED
        launched = {k: counts[k] for k in ("embedding_bag",
                                           "embedding_bag_bwd")}
        fwd_launches[cfg.name] = launched["embedding_bag"]
        r.update({
            "steps": n_steps, "losses": losses,
            "s_per_step": float(np.mean(ms)) / 1e3,
            "step_ms": ms,
            "samples_per_s": B / (float(np.mean(ms)) / 1e3),
            "launches": launched,
            "launches_per_step": {k: warm[k] for k in launched},
            "count": int(state[1]["count"]),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "peak_total_gb": torch.cuda.max_memory_allocated() / 1e9})
        after = {path: leaf_sum(torch, p) for path, p in leaves(state[0])}
        r["leaves_moved"] = sum(before[k] != after[k] for k in before)
        r["leaves"] = len(before)
        rep[cfg.name] = r
        print(f"recsys-train {cfg.name}: " + json.dumps(
            {k: v for k, v in r.items() if k != "grad_vs_plain"}), flush=True)
        check(all(np.isfinite(losses)), f"{cfg.name} train losses {losses}")
        check(r["leaves_moved"] == r["leaves"],
              f"{cfg.name}: {r['leaves'] - r['leaves_moved']} parameter "
              f"leaves did not move")
        check(r["count"] == n_steps, f"{cfg.name} Adam count {r['count']}")
        check(r["peak_total_gb"] < 80.0, f"{cfg.name} peak "
              f"{r['peak_total_gb']} GB")
        for k, n in launched.items():
            check(n == n_steps * per_step and warm[k] == per_step,
                  f"{cfg.name}: {n} {k} launches in {n_steps} steps "
                  f"({warm[k]} in the first), expected {per_step} a step")
        del state, params, batch, step
    resident()
    return rep, row, fwd_launches


def grad_agreement(names, gk, gp) -> dict:
    """Kernel against plain gradients, leaf by leaf (``gk``, ``gp`` in the
    order of ``names``): each leaf's max-abs error over its own largest
    magnitude. The key projection's bias is the exception: its gradient is
    0 in exact arithmetic (softmax ignores a shift shared by all keys), so
    both paths must return ~0 there, read against the largest magnitude of
    any leaf. ``check_grad_agreement`` holds the result."""
    check(all((a is None) == (b is None) for a, b in zip(gk, gp)),
          "kernel and plain paths reach different gradient leaves")
    rows = [(n, a, b) for n, a, b in zip(names, gk, gp) if b is not None]
    top_mag = max(float(b.abs().max()) for _, _, b in rows)
    ratios, zero_leaves = {}, {}
    for n, a, b in rows:
        if n.endswith("attn/k/b"):
            zero_leaves[n] = max(float(a.abs().max()),
                                 float(b.abs().max())) / top_mag
        else:
            ratios[n] = float((a - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    return {"grad_worst_rel_err": worst[0][1], "grad_worst_leaves": worst,
            "key_bias_grad_over_top": max(zero_leaves.values()),
            "n_grad_leaves": len(rows)}


def check_grad_agreement(label: str, rep: dict):
    """Every leaf within TOL_GRAD of its magnitude; key biases within 1e-5
    of the largest magnitude (``grad_agreement``)."""
    name, worst = rep["grad_worst_leaves"][0]
    check(worst <= TOL_GRAD, f"{label}: gradient leaf {name} differs by "
          f"{worst} of its magnitude")
    check(rep["key_bias_grad_over_top"] <= 1e-5,
          f"{label}: key-bias gradients are not ~0: "
          f"{rep['key_bias_grad_over_top']}")


def ckpt_phase(torch, np, dev, cfg, card, trainer, state, top_batch, top,
               make_batcher):
    """The checkpoint, resume and restart path at PROD (see the module
    docstring, phase 7). Returns (report, the bus launches of the
    supervised fit)."""
    import shutil

    from repro_torch import checkpoint as ckpt, training
    from repro_torch.kernels import ops
    from repro_torch.optim.adam import leaves
    from repro_torch.resilience import FaultPlan, faults, fit_supervised

    def state_leaves(s):
        return ([t for _, t in leaves(s.params)]
                + [t for _, t in leaves(s.opt)]
                + [s.cache.emb, s.cache.written_step])

    root = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        # the snapshot's bytes, as written: every leaf of the on-disk tree
        snap_bytes = sum(int(t.numel()) * t.element_size()
                         for t in state_leaves(state)) + 4 \
            + state.rng.get_state().numel()
        free = shutil.disk_usage(root).free
        rep = {"card": card, "snapshot_bytes": snap_bytes,
               "disk_free_bytes": free}
        check(free >= CKPT_DISK_FACTOR * snap_bytes,
              f"ckpt: {free} bytes free under {root}, need "
              f"{CKPT_DISK_FACTOR} x the snapshot's {snap_bytes}")

        # a synchronous save of the train phase's final state, and its
        # restore into a fresh state of another seed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        training.save_state(str(root / "sync"), state.step, state)
        rep["save_s"] = time.perf_counter() - t0
        like = trainer.init_state(seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, got = training.restore_state(str(root / "sync"), like)
        torch.cuda.synchronize()
        rep["restore_s"] = time.perf_counter() - t0
        del like
        same = [torch.equal(a, b) for a, b in
                zip(state_leaves(got), state_leaves(state))]
        rep["leaves_equal"] = f"{sum(same)}/{len(same)}"
        check(all(same), f"ckpt: restored leaves differ ({rep['leaves_equal']}"
              f" equal)")
        check(step == got.step == state.step,
              f"ckpt: restored step {step}/{got.step}, saved {state.step}")
        check(got.rng.device.type == dev.type and torch.equal(
            got.rng.get_state(), state.rng.get_state()),
            "ckpt: the restored generator's state differs")

        # one step on one top-bucket batch from each: the same loss
        got, m_got = trainer.step(got, top_batch, top)
        state, m_saved = trainer.step(state, top_batch, top)
        l_got, l_saved = float(m_got["loss"]), float(m_saved["loss"])
        rep.update({"loss_restored": l_got, "loss_saved": l_saved,
                    "loss_bit_for_bit": bool(torch.equal(m_got["loss"],
                                                         m_saved["loss"])),
                    "loss_abs_diff": abs(l_got - l_saved)})
        check(np.isfinite(l_got) and abs(l_got - l_saved) <= TOL_LOSS,
              f"ckpt: a step from the restored state gives loss {l_got}, "
              f"from the saved one {l_saved}")
        del got, m_got, m_saved

        # the async writer: the host snapshot (what save blocks on) and
        # the write behind it
        writer = ckpt.AsyncCheckpointer(str(root / "async"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        training.save_state(str(root / "async"), state.step, state,
                            writer=writer)
        rep["async_snapshot_s"] = time.perf_counter() - t0
        writer.wait()
        rep["async_total_s"] = time.perf_counter() - t0
        for k in ("save", "restore", "async_snapshot", "async_total"):
            rep[f"{k}_gb_per_s"] = snap_bytes / 1e9 / rep[f"{k}_s"]
        shutil.rmtree(root / "sync")
        shutil.rmtree(root / "async")
        torch.cuda.empty_cache()

        # supervised restarts: a crash after step 3, the resume from the
        # step-2 checkpoint, steps 3 and 4 again
        plan = FaultPlan().fail("train.step", step=CKPT_CRASH_AT)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with faults.armed(plan):
            res = fit_supervised(
                training.get_trainer("speedyfeed", cfg=cfg, device=dev),
                make_batcher, steps=CKPT_STEPS, ckpt_dir=str(root / "fit"),
                ckpt_every=CKPT_EVERY, max_restarts=1, backoff_s=0,
                log_every=CKPT_EVERY)
        torch.cuda.synchronize()
        fit_launches = ops.launch_counts()
        rep["supervised"] = {
            "fit_s": time.perf_counter() - t0, "restarts": res.restarts,
            "resumed_from": res.resumed_from, "steps_done": res.steps_done,
            "losses_after_resume": res.losses,
            "faults_fired": plan.fired("train.step"),
            "launches": fit_launches}
        print("ckpt: " + json.dumps(rep), flush=True)
        check(res.restarts == 1 and plan.fired("train.step") == 1,
              f"ckpt: {res.restarts} restarts, "
              f"{plan.fired('train.step')} faults fired")
        check(res.resumed_from == CKPT_EVERY,
              f"ckpt: resumed from {res.resumed_from}")
        check(res.steps_done == res.state.step == CKPT_STEPS,
              f"ckpt: {res.steps_done} steps done")
        check(len(res.losses) == CKPT_STEPS - CKPT_EVERY
              and all(np.isfinite(res.losses)),
              f"ckpt: losses after the resume {res.losses}")
        # 3 steps before the crash, 2 after the resume from step 2
        n = CKPT_CRASH_AT + CKPT_STEPS - CKPT_EVERY
        L = cfg.plm.n_layers
        check(fit_launches["bus_attention"] == 2 * L * n
              and fit_launches["bus_attention_bwd"] == L * n,
              f"ckpt: bus launches {fit_launches}, expected {2 * L * n} "
              f"forward and {L * n} backward")
        check(fit_launches["bus_attention_simt"] == 0
              and fit_launches["bus_attention_bwd_simt"] == 0,
              "ckpt: the supervised fit sent a bus launch to the SIMT "
              "kernels")
        del res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rep, state, fit_launches


def conventional_phase(torch, np, dev, cfg, card, log, store, lcfg):
    """The conventional workflow at PROD (see the module docstring, phase
    8). Returns (report, the bus launches of the timed steps)."""
    from repro_torch import core, training
    from repro_torch.configs.speedyfeed_arch import CONV_ONE_CARD
    from repro_torch.kernels import ops
    from repro_torch.launch.speedup import conventional_batch_from_log
    from repro_torch.optim.adam import leaves

    B, C = CONV_ONE_CARD["users"], CONV_ONE_CARD["cands"]
    L = CONV_ONE_CARD["hist"]
    check(lcfg.hist_len == L, f"conventional: the store's L {lcfg.hist_len}")

    def batch_of(n):
        # the first n histories with at least 2 clicks, as the ladder's
        raw = conventional_batch_from_log(cfg, log, store, lcfg, n_users=n)
        check(raw["cand_tokens"].shape[1] == C,
              f"conventional: {raw['cand_tokens'].shape[1]} candidates")
        return ({k: torch.as_tensor(v, device=dev) for k, v in raw.items()
                 if not k.startswith("_")}, raw["_stats"])

    torch.cuda.reset_peak_memory_stats()
    trainer = training.get_trainer("speedyfeed_conventional", cfg=cfg,
                                   device=dev)
    state = trainer.init_state(seed=0)
    cache = state.cache
    watch = {p: t.detach().clone() for p, t in leaves(state.params)
             if p in ("plm/layers/0/attn/q/w", "plm/out_proj/w",
                      "user/proj/w")}
    batch, stats = batch_of(B)
    n_news = B * (L + C)
    state, m = trainer.step(state, batch)               # warm-up
    losses = [float(m["loss"])]
    ops.reset_launch_counts()
    step_s = []
    for _ in range(CONV_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = ops.launch_counts()
    now = dict(leaves(state.params))
    moved = {p: float((t - now[p].detach()).abs().max())
             for p, t in watch.items()}
    s_step = float(np.mean(step_s))
    rep = {"card": card, "users": B, "hist_len": L, "cands": C,
           "news_per_step": n_news, "steps": 1 + CONV_TIMED,
           "losses": losses, "click_acc": float(m["click_acc"]),
           "step_s": step_s, "s_per_step": s_step,
           "news_encoded_per_s": n_news / s_step,
           "clicks_per_s": B / s_step,
           "data_efficiency": stats["data_efficiency"],
           "numpy": np.__version__,
           "pad_news_share": float((~batch["hist_mask"]).float().mean()),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "param_moved": moved, "launches": launches,
           "model_tflop_per_step": 4 * core.plm_flops(cfg.plm, n_news) / 1e12}
    n = CONV_TIMED * cfg.plm.n_layers
    check(all(np.isfinite(losses)), f"conventional: losses {losses}")
    check(all(v > 0 for v in moved.values()),
          f"conventional: params did not move {moved}")
    check(state.cache is cache and bool((cache.emb == 0).all())
          and bool((cache.written_step == core.NEVER).all()),
          "conventional: the step touched the cache")
    check(state.step == 1 + CONV_TIMED, f"conventional: step {state.step}")
    check(launches["bus_attention"] == 2 * n
          and launches["bus_attention_bwd"] == n,
          f"conventional: bus launches {launches}, expected {2 * n} forward"
          f" and {n} backward")
    check(launches["bus_attention_simt"] == 0
          and launches["bus_attention_bwd_simt"] == 0,
          "conventional: a bus launch went to the SIMT kernels")
    check(rep["max_memory_allocated_gb"] < 80,
          f"conventional: peak {rep['max_memory_allocated_gb']} GB")
    del batch, watch, now

    # one loss and its gradients, kernels against the plain path, on the
    # trained parameters and CONV_PLAIN_USERS users' batch (pad slots in)
    small, _ = batch_of(CONV_PLAIN_USERS)
    flat = [p for _, p in leaves(state.params)]
    grads = {}
    for impl in ("kernel", "plain"):
        loss, _ = core.conventional_forward(state.params, cfg, small,
                                            impl=impl)
        grads[impl] = (float(loss.detach()), torch.autograd.grad(
            loss, flat, allow_unused=True))
    (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
    rep["plain"] = {"users": CONV_PLAIN_USERS,
                    "news": CONV_PLAIN_USERS * (L + C), "loss_kernel": lk,
                    "loss_plain": lp, "loss_abs_err": abs(lk - lp),
                    **grad_agreement([p for p, _ in leaves(state.params)],
                                     gk, gp)}
    print("conventional: " + json.dumps(rep), flush=True)
    check(abs(lk - lp) <= TOL_LOSS,
          f"conventional: loss kernel {lk} vs plain {lp}")
    check_grad_agreement("conventional", rep["plain"])
    return rep, launches


def quality_phase(torch, np, dev, cfg, card, corpus, serve_lcfg, top_batch,
                  top):
    """The paper's quality experiments (see the module docstring, phase
    13): (a) the four news baselines at their full default widths, (b)
    the PROD Algorithm-1 step with the NRMS user encoder, (c) every table
    of ``launch.tables`` at ``bench``. Returns (report, the bus launches
    of each part by kernel name)."""
    import copy
    import dataclasses

    from repro_torch import data, optim, training
    from repro_torch.kernels import ops
    from repro_torch.kernels.bus_attention import ROUTES
    from repro_torch.launch import tables
    from repro_torch.models import news
    from repro_torch.optim.adam import leaves

    rep, launches = {"card": card}, {}
    t_phase = time.perf_counter()
    # ------------------------------------------- (a) the four baselines
    batch, rep["baseline_batch"] = baseline_batch(torch, np, dev, corpus,
                                                  serve_lcfg)
    B = rep["baseline_batch"]["users"]
    n_news = rep["baseline_batch"]["news_per_step"]
    small = {k: v[:QUALITY_CPU_USERS] for k, v in batch.items()}
    adam = optim.AdamConfig(lr=1e-3)            # table3's for NRMS
    for name in news.NAMES:
        bcfg = news.NewsBaselineConfig(name=name)
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9
        params = news.init(torch.Generator(device=dev).manual_seed(0), bcfg)
        opt = optim.adam_init(params)
        step = optim.make_train_step(
            lambda p, b, c=bcfg: news.loss(p, c, b), adam)
        start = {p: t.detach().clone() for p, t in leaves(params)}
        # one step's loss on the card against the CPU's, on a copy of the
        # initial parameters and QUALITY_CPU_USERS users
        losses_small = {}
        for label, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
            p_c = copy.deepcopy(tree_to(params, where))
            b_c = {k: v.to(where) for k, v in small.items()}
            _, _, m_c = step(p_c, optim.adam_init(p_c), b_c)
            losses_small[label] = float(m_c["loss"])
            del p_c, b_c
        ops.reset_launch_counts()
        params, opt, m = step(params, opt, batch)          # warm-up
        losses = [float(m["loss"])]
        step_s = []
        for _ in range(QUALITY_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        counts = ops.launch_counts()
        now = dict(leaves(params))
        unmoved = [p for p, t in start.items() if torch.equal(t, now[p])]
        s_step = float(np.mean(step_s))
        r = {"config": dataclasses.asdict(bcfg),
             "params": sum(t.numel() for t in start.values()),
             "losses": losses, "click_acc": float(m["click_acc"]),
             "step_s": step_s, "s_per_step": s_step,
             "clicks_per_s": B / s_step, "news_encoded_per_s": n_news / s_step,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "resident_before_gb": resident, "unmoved_leaves": unmoved,
             "kernel_launches": {k: v for k, v in counts.items() if v},
             "loss_cuda_vs_cpu": {**losses_small, "users": QUALITY_CPU_USERS,
                                  "abs_err": abs(losses_small["cuda"]
                                                 - losses_small["cpu"])}}
        rep[name] = r
        print(f"quality {name}: " + json.dumps(r), flush=True)
        check(all(np.isfinite(losses)), f"quality {name}: losses {losses}")
        # an attention's key bias has an exactly-0 gradient and may keep
        # its value; every other leaf moves
        check(all(p.endswith("attn/k/b") for p in unmoved),
              f"quality {name}: leaves did not move: {unmoved}")
        check(not any(counts.values()),
              f"quality {name}: a kernel launched: {r['kernel_launches']}")
        check(r["loss_cuda_vs_cpu"]["abs_err"] <= TOL_QUALITY_CPU,
              f"quality {name}: loss on the card {losses_small['cuda']} vs "
              f"the CPU {losses_small['cpu']}")
        check(r["peak_gb"] < 80, f"quality {name}: peak {r['peak_gb']} GB")
        del params, opt, step, start, now, m
    del batch, small

    # ------------------------------------ (b) PROD with the NRMS user model
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    ncfg = dataclasses.replace(cfg, user=dataclasses.replace(
        cfg.user, kind="nrms"))
    trainer = training.get_trainer("speedyfeed", cfg=ncfg, device=dev)
    state = trainer.init_state(seed=0)
    watch = {p: t.detach().clone() for p, t in leaves(state.params)
             if p.startswith("user/self_attn/")}
    check(len(watch) == 8, f"quality nrms-user: self_attn leaves {watch}")
    state, m = trainer.step(state, top_batch, top)          # warm-up
    losses = [float(m["loss"])]
    ops.reset_launch_counts()
    step_s = []
    for _ in range(QUALITY_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, top_batch, top)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches["nrms_user"] = ops.launch_counts()
    now = dict(leaves(state.params))
    moved = {p: float((t - now[p].detach()).abs().max())
             for p, t in watch.items()}
    nL = ncfg.plm.n_layers
    rep["nrms_user"] = {
        "user": dataclasses.asdict(ncfg.user), "bucket": top,
        "losses": losses, "step_s": step_s,
        "s_per_step": float(np.mean(step_s)),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "self_attn_moved": moved, "launches": launches["nrms_user"]}
    print("quality nrms-user: " + json.dumps(rep["nrms_user"]), flush=True)
    check(all(np.isfinite(losses)), f"quality nrms-user: losses {losses}")
    check(all(v > 0 for k, v in moved.items() if not k.endswith("k/b")),
          f"quality nrms-user: self_attn did not move {moved}")
    check(launches["nrms_user"]["bus_attention"] == 2 * nL * QUALITY_TIMED
          and launches["nrms_user"]["bus_attention_bwd"]
          == nL * QUALITY_TIMED,
          f"quality nrms-user: bus launches {launches['nrms_user']}")
    del trainer, state, watch, now

    # ------------------------------------------ (c) the tables at bench
    gc_collect(torch)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = ROOT / "chiprun_out" / "tables.jsonl"
    rows, info = tables.main(["--device", "cuda", "--out", str(out)])
    tables_s = time.perf_counter() - t0
    launches["tables"] = ops.launch_counts()
    bcfg = tables.bench_cfg()
    buckets = data.default_buckets(bcfg.plm.seg_len)
    steps = info["steps"]
    # the Algorithm-1 runs with the bus (table5's w/o bus has none): one
    # warm-up step a bucket, then the run's steps; fig9's encodes at K > 1
    sf_steps = ((len(buckets) + steps["table3"])
                + 3 * (len(buckets) + steps["table5"])
                + 4 * (len(buckets) + steps["table6"]))
    n_enc = sum(1 for k in tables.FIG9_SEGMENTS
                if k > 1 and tables.FIG9_TOTAL % k == 0) * (
        info["fig9_timer"]["warmup"] + info["fig9_timer"]["iters"])
    nb = bcfg.plm.n_layers
    expect = {"bus_attention": nb * (sf_steps + n_enc),
              "bus_attention_bwd": nb * sf_steps}
    by_name = {n: v for n, _, v in rows}
    rep["tables"] = {"rows": [list(r) for r in rows], "info": info,
                     "seconds": tables_s, "launches": launches["tables"],
                     "expected_launches": expect}
    print("quality tables: " + json.dumps({
        k: v for k, v in rep["tables"].items() if k != "rows"}), flush=True)
    check(len(rows) == 25 and all(np.isfinite(v) for v in by_name.values()),
          f"quality tables: rows {rows}")
    check(all(0 <= v <= 1 for n, v in by_name.items()
              if n.startswith(("table3/", "table5/", "table6/"))),
          f"quality tables: accuracies {by_name}")
    for name, n in expect.items():
        check(launches["tables"][name] == n,
              f"quality tables: {launches['tables'][name]} {name} "
              f"launches, expected {n}")
    for part, counts in launches.items():
        check(all(counts[n] == 0 for n in ROUTES if n.endswith("_simt")),
              f"quality {part}: a bus launch went to the SIMT kernels")
    rep["seconds"] = time.perf_counter() - t_phase
    print(f"quality: {rep['seconds']:.1f} s", flush=True)
    return rep, launches


def baseline_batch(torch, np, dev, corpus, serve_lcfg):
    """The news baselines' batch of the quality phase: one
    ``build_conventional_batch`` of CONV_BATCH's 512 users from a click
    log of their own over the slice's corpus (the slice's log holds 400
    users), their news tokenized at the baselines' vocabulary (30,522
    ids; the slice's store hashes words into PROD's 30,720), ``user_id``
    as table3 sets it. Returns (the batch on ``dev``, its shape and
    counts)."""
    import dataclasses

    from repro_torch import data
    from repro_torch.configs.speedyfeed_arch import CONV_BATCH
    from repro_torch.launch.speedup import ladder_users
    from repro_torch.models import news

    B, L, C = CONV_BATCH["users"], CONV_BATCH["hist"], CONV_BATCH["cands"]
    t0 = time.perf_counter()
    vocab = news.NewsBaselineConfig(name="nrms").vocab
    qlcfg = dataclasses.replace(serve_lcfg, vocab=vocab)
    stats = data.build_corpus_stats(
        [corpus.text(i) for i in range(corpus.n_news)])
    qstore = data.NewsStore(corpus, stats, qlcfg)
    qlog = data.make_click_log(np.random.default_rng(QUALITY_LOG_SEED),
                               corpus, n_users=B, max_hist=L)
    users = ladder_users(qlog, B)
    check(len(users) == B, f"quality: {len(users)} users of {B}")
    raw = data.build_conventional_batch(users, qstore, qlcfg, n_cands=C,
                                        rng=np.random.default_rng(0))
    raw["user_id"] = np.arange(B, dtype=np.int32)
    check(int(raw["hist_tokens"].max()) < vocab,
          "quality: a token past the baselines' vocabulary")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()
             if not k.startswith("_")}
    return batch, {
        "users": B, "hist_len": L, "cands": C, "news_per_step": B * (L + C),
        "vocab": vocab, "max_token": int(raw["hist_tokens"].max()),
        "pad_token_share": float((raw["hist_tokens"] == 0).mean()),
        "data_efficiency": raw["_stats"]["data_efficiency"],
        "host_s": time.perf_counter() - t0}


def serve_front_phase(torch, np, dev, rec, reqs, exec_p50_ms: float,
                      plain_distortion: float):
    """The serving front end on the slice's PROD Recommender: OPQ, the
    open-loop sweep with a rebuild mid-loop, chaos, backpressure and the
    autotuner, counted from 0; then the PQ scan held to plain at the
    scheduler's small buckets and on OPQ's rotated LUT. Returns (report,
    launches)."""
    from repro_torch import obs, serving
    from repro_torch.kernels import ops
    from repro_torch.kernels.pq_scoring import ROUTES as PQ_ROUTES
    from repro_torch.kernels.pq_scoring import pq_lut_scores_plain
    from repro_torch.launch import serve
    from repro_torch.launch.profile import pq_distortion
    from repro_torch.resilience import faults
    from repro_torch.serving.index import _pq_scan_inputs

    import dataclasses

    t_phase = time.perf_counter()
    svc = rec.service
    emb = svc.store.emb
    n_rows = emb.shape[0]
    probe_reqs = reqs[BATCH:]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    rep = {}

    def counter(name, **labels):
        return obs.counter(name, **labels).value

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    # (e) OPQ on the slice's embeddings, on the card and on the CPU
    bld = svc.builder
    opq_cfg = dataclasses.replace(bld.pq, opq_iters=OPQ_ITERS)
    t0 = time.perf_counter()
    opq_snap = serving.IndexBuilder(
        bld.kind, bld.dim, ivf=bld.ivf, pq=opq_cfg, seed=bld.seed,
        device=dev).build(np.arange(1, n_rows), emb[1:])
    torch.cuda.synchronize()
    opq_build_s = time.perf_counter() - t0
    cpu_opq = serving.IndexBuilder(
        bld.kind, bld.dim, ivf=bld.ivf, pq=opq_cfg, seed=bld.seed,
        device="cpu").build(np.arange(1, n_rows), emb[1:].cpu())
    plain_snap = svc.snapshot()
    recall_plain = serve.measure_recall(rec, probe_reqs, k=10, probe=16)
    svc.swap(opq_snap)
    recall_opq = serve.measure_recall(rec, probe_reqs, k=10, probe=16)
    svc.swap(plain_snap)
    rot = opq_snap.pq_rot
    rep["opq"] = {
        "opq_iters": OPQ_ITERS, "build_s": opq_build_s,
        "pq_distortion": {"opq_card": pq_distortion(opq_snap, emb),
                          "opq_cpu": pq_distortion(cpu_opq, emb.cpu()),
                          "plain_card": plain_distortion},
        "rot_orthogonality_err": float((rot.T @ rot - torch.eye(
            rot.shape[0], device=dev)).abs().max()),
        "recall_at_10": {"opq": recall_opq, "plain": recall_plain}}
    print("serve-front opq: " + json.dumps(rep["opq"]), flush=True)
    d = rep["opq"]["pq_distortion"]
    check(abs(d["opq_card"] - d["opq_cpu"]) <= TOL_DISTORTION,
          f"OPQ distortion on the card {d['opq_card']} vs the CPU build "
          f"{d['opq_cpu']}")
    check(d["opq_card"] <= d["plain_card"],
          f"OPQ distortion {d['opq_card']} worse than plain PQ's "
          f"{d['plain_card']}")

    # (b) the open-loop sweep around the closed loop's sustained rate,
    # then one point at the middle rate while a churn thread publishes and
    # fully rebuilds
    sustained = BATCH / exec_p50_ms * 1e3
    rates = [round(f * sustained, 1) for f in FRONT_RATE_SHARES]

    def harness(flags, chaos_n=0):
        args = serve.build_parser().parse_args(flags)
        try:
            return serve.open_loop_harness(args, rec, probe_reqs,
                                           chaos_n=chaos_n)
        finally:
            faults.disarm()

    swaps0 = svc.n_swaps
    t0 = time.perf_counter()
    entries, _ = harness(
        ["--open-loop", "--rebuild-mid-loop", "--batch", str(BATCH),
         "--slo-ms", str(FRONT_SLO_MS), "--duration", str(FRONT_DURATION_S),
         "--bench-out", str(out_dir / "serve_sweep.json"), "--sweep",
         *map(str, rates)])
    sweep_s = time.perf_counter() - t0
    # the harness swaps once in its warm cycle before the quiescent points
    # and at most once after the during_rebuild window, for the build in
    # flight when the churn stops: the rest swapped inside that window
    swaps = svc.n_swaps - swaps0
    swaps_in_window = swaps - 2
    for e in entries:
        for pt in e["points"]:
            print("serve-front point: " + json.dumps(
                {"scenario": e["scenario"], **pt}), flush=True)
    quiet, during = entries[0]["points"], entries[1]["points"][0]
    rep["sweep"] = {"sustained_qps": sustained, "rates": rates,
                    "swaps": swaps,
                    "swaps_in_rebuild_window_at_least": swaps_in_window,
                    "s": sweep_s}
    print("serve-front sweep: " + json.dumps(rep["sweep"]), flush=True)
    rep["sweep"]["entries"] = entries
    check([p["offered_qps"] for p in quiet] == rates,
          f"sweep points {[p['offered_qps'] for p in quiet]} != {rates}")
    low, high = quiet[0], quiet[-1]
    check(low["rejected"] == low["late_dropped"] == low["completed_late"]
          == low["errors"] == 0 and low["completed"] == low["offered"],
          f"at {FRONT_RATE_SHARES[0]}x of the sustained rate: {low}")
    check(high["rejected"] + high["late_dropped"] > 0,
          f"at {FRONT_RATE_SHARES[-1]}x nothing was rejected or late: {high}")
    for pt in quiet + [during]:
        vals = [pt[k] for k in ("goodput_qps", "e2e_ms_p50", "e2e_ms_p99",
                                "queued_ms_p50", "queued_ms_p99")]
        check(all(np.isfinite(vals)) and pt["errors"] == 0,
              f"sweep point not finite or with errors: {pt}")
    check(swaps_in_window >= 1,
          f"no swap during the during_rebuild point: {swaps} swaps in the "
          f"harness, its warm cycle's and the last build's included")

    # (c) chaos: CHAOS_FAILURES injected rebuild failures in the open
    # loop's measured window; retried, degraded, recovered, under the
    # launcher's knobs for --chaos-rebuild-failures, for this run only
    knobs = serve.chaos_service_kw(CHAOS_FAILURES)
    knobs0 = {k: getattr(svc, k) for k in knobs}
    for k, v in knobs.items():
        setattr(svc, k, v)
    tr0 = {to: counter("health_transitions_total", component="index", to=to)
           for to in ("degraded", "healthy")}
    f0 = counter("index_build_failures_total", mode="full")
    mid = rates[len(rates) // 2]
    entries_c, plan = harness(
        ["--open-loop", "--chaos-rebuild-failures", str(CHAOS_FAILURES),
         "--batch", str(BATCH), "--slo-ms", str(FRONT_SLO_MS), "--duration",
         str(CHAOS_DURATION_S), "--bench-out",
         str(out_dir / "serve_sweep_chaos.json"), "--qps", str(mid)],
        chaos_n=CHAOS_FAILURES)
    for k, v in knobs0.items():
        setattr(svc, k, v)
    health = svc.health()
    tr = {to: counter("health_transitions_total", component="index",
                      to=to) - tr0[to] for to in tr0}
    pts = [pt for e in entries_c for pt in e["points"]]
    rep["chaos"] = {
        "fired": plan.fired("index.rebuild"),
        "build_attempts": plan.calls("index.rebuild"),
        "build_failures": counter("index_build_failures_total",
                                  mode="full") - f0,
        "health": health["status"], "index_transitions": tr,
        "points": [{"scenario": e["scenario"], **pt} for e in entries_c
                   for pt in e["points"]]}
    print("serve-front chaos: " + json.dumps(rep["chaos"]), flush=True)
    check(rep["chaos"]["fired"] == CHAOS_FAILURES,
          f"the chaos plan fired {rep['chaos']['fired']} times")
    check(health["status"] == "healthy", f"health after chaos: {health}")
    check(tr["degraded"] >= 1 and tr["healthy"] >= 1,
          f"index health transitions under chaos: {tr}")
    check(all(pt["completed"] > 0 and pt["errors"] == 0 for pt in pts),
          f"queries failed under chaos: {pts}")

    # (d) backpressure: a service over the same store and snapshot with a
    # small delta hard cap
    bp = serving.RetrievalService(
        svc.builder, emb, k=10, k_prime=svc.k_prime, auto_compact=False,
        delta_hard_cap=BACKPRESSURE_CAP, device=dev)
    bp.swap(plain_snap)
    n0 = bp.store.emb.shape[0]
    fresh = (emb[1:1 + BACKPRESSURE_CAP + 1].cpu().numpy() + 0.01)
    bp.publish(np.arange(n0, n0 + BACKPRESSURE_CAP),
               fresh[:BACKPRESSURE_CAP])
    store0, view0 = bp.store.emb.clone(), bp._view
    b0 = counter("publish_backpressure_total")
    raised = False
    try:
        bp.publish(np.array([n0 + BACKPRESSURE_CAP]),
                   fresh[BACKPRESSURE_CAP:])
    except serving.BackpressureError:
        raised = True
    unchanged = (bp._view is view0 and torch.equal(bp.store.emb, store0)
                 and bp.n_pending == BACKPRESSURE_CAP)
    hist, mask = serve._pad_histories(rec, probe_reqs[:BATCH], BATCH)
    _, ids_bp = bp.query(rec.encode_users(hist, mask))
    rep["backpressure"] = {
        "hard_cap": BACKPRESSURE_CAP, "raised": raised,
        "state_unchanged": unchanged,
        "backpressure_total": counter("publish_backpressure_total") - b0,
        "health": bp.health()["status"],
        "queries_answered": int((ids_bp > 0).all(axis=1).sum())}
    print("serve-front backpressure: " + json.dumps(rep["backpressure"]),
          flush=True)
    check(raised and unchanged
          and rep["backpressure"]["queries_answered"] == BATCH,
          f"backpressure: {rep['backpressure']}")
    del bp, store0, view0

    # (f) the autotuner over nprobe {4, 8, 16, 32} x k' {40, 64, 128}
    args_f = serve.build_parser().parse_args(["--autotune", "--batch",
                                              str(BATCH)])
    best = serve.tune(rec, probe_reqs, args_f)
    rep["autotune"] = {
        "grid": [{k: v for k, v in dataclasses.asdict(t).items()
                  if k != "trials"} for t in best.trials],
        "winner": {"nprobe": best.nprobe, "k_prime": best.k_prime,
                   "recall": best.recall, "ms": best.ms,
                   "met_target": best.met_target},
        "installed": {"nprobe": svc.snapshot().nprobe,
                      "k_prime": svc.k_prime}}
    print("serve-front autotune: " + json.dumps(rep["autotune"]), flush=True)
    check(len(best.trials) == 12
          and rep["autotune"]["installed"] == {"nprobe": best.nprobe,
                                               "k_prime": best.k_prime},
          f"autotune: the winner is not the installed config "
          f"{rep['autotune']}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    rep["launches"] = launches
    check(launches["pq_lut_scores"] > 0 and
          launches["pq_lut_scores_general"] == 0,
          f"serve-front scans not all on the tiled kernel: {launches}")

    # the scan at the scheduler's small buckets, on the slice's served
    # snapshot (nprobe 16, whatever the autotuner installed since), and at
    # BATCH on OPQ's rotated LUT: held to plain
    hist, mask = serve._pad_histories(rec, probe_reqs[:BATCH], BATCH)
    user = rec.encode_users(hist, mask)
    scans = {}
    for label, snap_, rows in (
            *((f"B{b}", plain_snap, b) for b in FRONT_SCAN_BATCHES),
            ("opq_B16", opq_snap, BATCH)):
        lut, codes, valid, _, _ = _pq_scan_inputs(
            user[:rows], snap_.cent_unit, snap_.cent_raw, snap_.list_ids,
            snap_.payload, snap_.lens, snap_.pq_centers, snap_.pq_rot,
            nprobe=snap_.nprobe, metric=snap_.metric)
        got = on_route(ops, "pq_lut_scores", lambda: ops.pq_lut_scores(
            lut, codes, valid), PQ_ROUTES)
        ref = pq_lut_scores_plain(lut, codes, valid)
        fin = torch.isfinite(ref)
        check(torch.equal(torch.isfinite(got), fin),
              f"{label}: finite slots differ from plain")
        err = float((got[fin] - ref[fin]).abs().max())
        scans[label] = {"shape": [*lut.shape, codes.shape[1]],
                        "rotated": snap_.pq_rot is not None,
                        "max_abs_err": err}
        check(err <= TOL_PQ, f"{label}: the scan differs from plain by {err}")
    rep["scans"] = scans
    rep["seconds"] = time.perf_counter() - t_phase
    print("serve-front scans: " + json.dumps(scans), flush=True)
    print(f"serve-front: {rep['seconds']:.1f} s", flush=True)
    return rep, launches


def gnn_phase(torch, np, dev, ops):
    """The GNN family's training path (see the module docstring, phase
    1b). Returns the report."""
    from repro_torch import configs, optim
    from repro_torch.configs import gnn_family
    from repro_torch.models.gnn import dimenet
    from repro_torch.optim.adam import leaves

    t_phase = time.perf_counter()
    before = ops.launch_counts()

    def loss_and_grads(params, cfg, batch, ng):
        flat = [p.requires_grad_() for _, p in leaves(params)]
        loss, _ = dimenet.loss(params, cfg, batch, n_graphs=ng)
        return loss.detach(), torch.autograd.grad(loss, flat)

    rep = {}
    for shape in GNN_RUN:
        # the registry's cell: its step and FLOP count
        cell = configs.get_arch("dimenet").cells[shape]
        shp = gnn_family.GNN_SHAPES[shape]
        cfg = gnn_family.cell_config(shape)
        ng = shp.get("n_graphs", 1)
        t0 = time.perf_counter()
        batch = gnn_family.train_batch(shape, np.random.default_rng(
            GNN_SEED), device=dev)
        r = {"host_batch_s": time.perf_counter() - t0,
             "n": shp["n"], "e": shp["e"], "t": shp["t"],
             "valid_edges": int(batch["edge_mask"].sum()),
             "valid_triplets": int(batch["trip_mask"].sum())}
        params = dimenet.init(torch.Generator(device=dev).manual_seed(0),
                              cfg)
        if shape in GNN_CPU_CHECK:
            # the same parameters and batch through the port on the CPU
            l_c, g_c = loss_and_grads(tree_to(params, "cpu"), cfg,
                                      {k: v.cpu() for k, v in batch.items()},
                                      ng)
            l_g, g_g = loss_and_grads(params, cfg, batch, ng)
            names = [n for n, _ in leaves(params)]
            errs = {n: float((a.cpu() - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for n, a, b in zip(names, g_g, g_c)}
            worst = max(errs, key=errs.get)
            r["loss_cuda_vs_cpu_rel"] = abs(float(l_g) - float(l_c)) / max(
                abs(float(l_c)), 1e-30)
            r["grad_worst_rel_err"] = [worst, errs[worst]]
            check(r["loss_cuda_vs_cpu_rel"] <= TOL_GNN_LOSS,
                  f"gnn {shape}: loss on the card {float(l_g)} against the "
                  f"CPU's {float(l_c)}")
            check(errs[worst] <= TOL_GNN_GRAD,
                  f"gnn {shape}: gradient leaf {worst} differs from the "
                  f"CPU's by {errs[worst]} of its magnitude")
            del g_c, g_g
        opt = optim.adam_init(params)
        step = cell.make_fn()
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        params, opt, m = step(params, opt, batch)          # warm-up
        losses = [m["loss"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GNN_TIMED):
            params, opt, m = step(params, opt, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / GNN_TIMED
        r.update(
            s_per_step=sec, edges_per_s=r["valid_edges"] / sec,
            triplets_per_s=r["valid_triplets"] / sec,
            model_tflop_per_s=cell.meta["model_flops"] / sec / 1e12,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            losses=[float(x) for x in losses], count=int(opt["count"]))
        check(all(np.isfinite(r["losses"])), f"gnn {shape}: losses "
              f"{r['losses']}")
        check(r["count"] == 1 + GNN_TIMED, f"gnn {shape}: Adam count "
              f"{r['count']}")
        rep[shape] = r
        print(f"gnn {shape}: " + json.dumps(r), flush=True)
        del params, opt, batch, m, losses
        gc_collect(torch)
    # the refusal that stands for ogb_products
    try:
        gnn_family.train_batch("ogb_products", np.random.default_rng(0),
                               device=dev)
        fail("gnn: ogb_products was not refused")
    except ValueError as e:
        rep["ogb_products"] = str(e)
    moved = {k: n - before[k] for k, n in ops.launch_counts().items()
             if n != before[k]}
    check(not moved, f"gnn: the DimeNet path launched kernels {moved}")
    rep["seconds"] = time.perf_counter() - t_phase
    print(f"gnn: {rep['seconds']:.1f} s, no kernel launched", flush=True)
    return rep


# the kernel wrappers the reduced smokes reach, as ``kernels/ops.py``
# calls them (module, attribute); the registry phase spies on them
REGISTRY_WRAPPERS = (
    ("flash_attention", "flash_attention_cuda"),
    ("flash_attention", "flash_attention_bwd_cuda"),
    ("bus_attention", "bus_attention_cuda"),
    ("bus_attention", "bus_attention_bwd_cuda"),
    ("embedding_bag", "embedding_bag_cuda"),
    ("embedding_bag", "embedding_bag_bwd_cuda"))


def spy_wrappers(torch, captured: dict):
    """Put spies on REGISTRY_WRAPPERS: each keeps a copy of the inputs of
    its wrapper's first call at each shape, dtype and flag, in
    ``captured`` by that key, then calls the wrapper. Returns the
    function that takes the spies off."""
    import importlib
    saved = []
    for mod_name, attr in REGISTRY_WRAPPERS:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        fn = getattr(mod, attr)

        def spy(*args, _fn=fn, _attr=attr):
            key = (_attr,) + tuple(
                (tuple(a.shape), str(a.dtype))
                if isinstance(a, torch.Tensor) else a for a in args)
            if key not in captured:
                captured[key] = (_attr, [
                    a.detach().clone() if isinstance(a, torch.Tensor) else a
                    for a in args])
            return _fn(*args)
        setattr(mod, attr, spy)
        saved.append((mod, attr, fn))

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return restore


def abs_rel_err(torch, got, exp) -> tuple:
    """(max |got - exp|, that over the largest |exp|), in f64; where
    ``exp`` is NaN ``got`` must be NaN too (else both are inf)."""
    got, exp = got.double(), exp.double()
    nan = exp.isnan()
    if not torch.equal(got.isnan(), nan):
        return float("inf"), float("inf")
    got, exp = got.masked_fill(nan, 0), exp.masked_fill(nan, 0)
    err = float((got - exp).abs().max())
    return err, err / max(float(exp.abs().max()), 1e-30)


def registry_hold(torch, attr: str, args: list) -> dict:
    """One wrapper held against its plain version on ``args``, the inputs
    a reduced smoke gave it (see the module docstring, phase 1c): the
    output, or each gradient, within the wrapper's limit of the plain
    one's largest magnitude, and a control, the plain version on a
    broken copy of the inputs, over that limit: v's last quarter of keys
    zeroed (flash), the bus keys' v zeroed (bus), the first sample's
    rows zeroed in the table (EmbeddingBag) or its dout (its
    backward)."""
    from repro_torch.kernels import bus_attention as bus
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    r = {"wrapper": attr, "shapes": [list(t.shape) for t in tensors],
         "dtype": str(tensors[0].dtype).replace("torch.", "")}
    mods = {"flash_attention": fa, "bus_attention": bus,
            "embedding_bag": eb}
    got = getattr(mods[dict((a, m) for m, a in REGISTRY_WRAPPERS)[attr]],
                  attr)(*args)
    got = list(got) if isinstance(got, tuple) else [got]
    if attr == "flash_attention_cuda":
        q, k, v, causal = args
        w = max(1, k.shape[1] // 4)
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal)
        exp, got = [o], got[:1] + [got[1] - lse]
        ctl = fa.flash_attention_fwd_plain(
            q, k, dropped_tile(v, k.shape[1] - w, w), causal)[:1]
        r["lse_abs_err"] = float(got.pop().abs().max())
        check(r["lse_abs_err"] <= TOL_LSE, f"registry {attr}: lse {r}")
        tol = TOL_FLASH[r["dtype"]]
    elif attr == "flash_attention_bwd_cuda":
        q, k, v, o, lse, do, causal = args
        w = max(1, k.shape[1] // 4)
        exp = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        ctl = fa.flash_attention_bwd_plain(
            q, k, dropped_tile(v, k.shape[1] - w, w), o, lse, do, causal)
        tol = TOL_FLASH_BWD[r["dtype"]]
    elif attr == "bus_attention_cuda":
        q, k, v, kv_mask = args
        exp = [bus.bus_attention_plain(q, k, v, kv_mask)]
        ctl = [bus.bus_attention_plain(q, k, bus_zeroed(v, q.shape[2]),
                                       kv_mask)]
        tol = TOL_BUS
    elif attr == "bus_attention_bwd_cuda":
        q, k, v, kv_mask, do = args
        exp = bus.bus_attention_bwd_plain(q, k, v, kv_mask, do)
        ctl = bus.bus_attention_bwd_plain(q, k, bus_zeroed(v, q.shape[2]),
                                          kv_mask, do)
        tol = TOL_BWD
    elif attr == "embedding_bag_cuda":
        table, idx, weights = args
        exp = [eb.embedding_bag_plain(table, idx, weights)]
        broken = table.clone()
        broken[eb._wrap(idx[0], table.shape[0])[0].reshape(-1)] = 0
        ctl = [eb.embedding_bag_plain(broken, idx, weights)]
        tol = TOL_RS_BULK
    else:
        dout, idx, weights, num_rows = args
        exp = [eb.embedding_bag_bwd_plain(dout.double(), idx, weights,
                                          num_rows)]
        broken = dout.double()
        broken[0] = 0
        ctl = [eb.embedding_bag_bwd_plain(broken, idx, weights, num_rows)]
        tol = TOL_EBAG_BWD
    errs = [abs_rel_err(torch, a, b) for a, b in zip(got, exp)]
    r["max_abs_err"] = max(e[0] for e in errs)
    r["rel_err"] = max(e[1] for e in errs)
    r["control_rel_err"] = max(abs_rel_err(torch, a, b)[1]
                               for a, b in zip(got, ctl))
    r["tol"] = tol
    check(r["rel_err"] <= tol, f"registry {attr} at the smoke's shape "
          f"differs from plain: {r}")
    check(r["control_rel_err"] > tol, f"registry {attr}: the control "
          f"passes the limit: {r}")
    return r


def registry_phase(torch, dev, ops):
    """Every arch's reduced smoke on the card, then each kernel wrapper
    held to plain at every shape the smokes gave it (see the module
    docstring, phase 1c). Returns (report, launches by arch, the holds'
    launches by kernel)."""
    from repro_torch import configs
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    rep, launches, captured = {}, {}, {}
    restore = spy_wrappers(torch, captured)
    try:
        for name in configs.ASSIGNED + ["speedyfeed"]:
            arch = configs.get_arch(name)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            if name == "dimenet":     # through the launcher, as a user runs it
                metrics = train.main(["--arch", name, "--device", "cuda"])
            else:
                metrics = arch.smoke(device=dev)
            torch.cuda.synchronize()
            counts = {k: n for k, n in ops.launch_counts().items() if n}
            expected = REGISTRY_KERNELS[arch.family]
            if name == "bert4rec":
                expected = set()
            check(set(counts) == expected, f"registry {name}: launched "
                  f"{counts}, expected every one of {sorted(expected)}")
            rep[name] = {"seconds": time.perf_counter() - t0,
                         "metrics": metrics, "launches": counts}
            launches[name] = counts
    finally:
        restore()
    # each wrapper at each shape the smokes gave it, on their inputs
    ops.reset_launch_counts()
    holds = []
    for attr, args in captured.values():
        before = ops.launch_counts()
        h = registry_hold(torch, attr, args)
        h["launches"] = {n: c - before[n] for n, c in
                         ops.launch_counts().items() if c != before[n]}
        holds.append(h)
    torch.cuda.synchronize()
    held = {n for h in holds for n in h["launches"]}
    check(held == set().union(*REGISTRY_KERNELS.values()),
          f"registry: the holds launched {sorted(held)}, not the smokes' "
          f"kernels")
    rep["holds"] = holds
    rep["seconds"] = time.perf_counter() - t_phase
    print("registry: " + json.dumps(rep), flush=True)
    return rep, launches, holds


ROOFLINE_KEYS = ("flops_per_chip", "flops_by_dtype", "bytes_per_chip",
                 "quad_bytes", "peak_memory_per_chip", "fits_one_card",
                 "bottleneck", "t_compute", "t_memory", "t_memory_flash",
                 "step_time_lb", "useful_flops_fraction", "mfu_upper_bound",
                 "t_count_s", "measured_s", "achieved", "mfu",
                 "max_memory_allocated", "allocated_before", "args_build_s")


def roofline_count(name: str, shape: str, tf32: bool) -> dict:
    """The dry-run's count of the cell (``name``, ``shape``) in a worker
    process of ``roofline_phase`` (imports in here, as a spawned process
    starts bare): its record, with the kernel launches the count made
    (none may be) under ``count_launches``; or ``error``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    torch.backends.cuda.matmul.allow_tf32 = tf32
    ops.reset_launch_counts()
    try:
        rec = dryrun.run_cell(configs.get_arch(name).cells[shape],
                              verbose=False)
    except Exception as e:          # reported, then fatal in the phase
        return {"error": f"{type(e).__name__}: {e}"}
    rec["count_launches"] = {k: n for k, n in ops.launch_counts().items()
                             if n}
    return rec


def roofline_counts(torch, configs) -> dict:
    """{(arch, shape): ``roofline_count``'s record} of every non-skipped
    registry cell, counted in ROOFLINE_WORKERS spawned processes."""
    import concurrent.futures
    import multiprocessing
    keys = [(name, shape) for name in configs.list_archs()
            for shape, cell in configs.get_arch(name).cells.items()
            if not cell.skip]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    with concurrent.futures.ProcessPoolExecutor(
            ROOFLINE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(roofline_count, *k, tf32) for k in keys}
        return {k: f.result() for k, f in futures.items()}


def roofline_phase(torch, dev, ops):
    """The dry-run on the card (see the module docstring, phase 1d).
    Returns (report, launches by measured cell)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    rep, launches = {"cells": {}}, {}
    out = ROOT / "chiprun_out" / "roofline.jsonl"
    out.parent.mkdir(exist_ok=True)
    out.write_text("")
    counts = roofline_counts(torch, configs)
    rep["count_wall_s"] = time.perf_counter() - t_phase
    count_s = 0.0
    for name in configs.list_archs():
        arch = configs.get_arch(name)
        for shape, cell in arch.cells.items():
            key = f"{name}/{shape}"
            if cell.skip:
                rec = {"arch": name, "shape": shape, "status": "skip",
                       "reason": cell.skip}
                summary = {"status": "skip"}
            else:
                rec = counts[(name, shape)]
                if "error" in rec:
                    fail(f"roofline {key}: does not count on meta: "
                         f"{rec['error']}")
                count_s += rec["t_count_s"]
                went = rec.pop("count_launches")
                check(not went, f"roofline {key}: counting launched {went}")
                ops.reset_launch_counts()
                if dryrun.measures(cell, rec):
                    rec.update(dryrun.measure_cell(cell, rec, device=dev))
                    went = {k: n for k, n in ops.launch_counts().items()
                            if n}
                    rec["launches"] = launches[key] = went
                    ctr = arch.family == "recsys" and name != "bert4rec"
                    want = ({"embedding_bag"} | ({"embedding_bag_bwd"}
                                                 if cell.kind == "train"
                                                 else set())) if ctr else set()
                    check(set(went) == want, f"roofline {key}: launched "
                          f"{went}, expected {sorted(want)}")
                    # step_time_lb is the largest term, so this holds
                    # t_compute too
                    check(rec["step_time_lb"]
                          <= ROOFLINE_SLACK * rec["measured_s"],
                          f"roofline {key}: measured {rec['measured_s']} s "
                          f"beats the counted floor (step_time_lb "
                          f"{rec['step_time_lb']} s, compute "
                          f"{rec['t_compute']} s): the count is wrong")
                summary = {k: rec[k] for k in ROOFLINE_KEYS if k in rec}
                if "launches" in rec:
                    summary["launches"] = rec["launches"]
            rep["cells"][key] = summary
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"roofline {key}: " + json.dumps(summary), flush=True)
    measured = sorted(k for k, r in rep["cells"].items()
                      if "measured_s" in r)
    check(set(ROOFLINE_MUST) <= set(measured), f"roofline: measured "
          f"{measured}, not every one of {ROOFLINE_MUST}")
    went = set().union(*launches.values())
    check({"embedding_bag", "embedding_bag_bwd"} <= went,
          f"roofline: the measured cells launched {sorted(went)}")
    rep.update(measured=measured, count_s=count_s,
               tf32=torch.backends.cuda.matmul.allow_tf32,
               seconds=time.perf_counter() - t_phase)
    print(f"roofline: {len(rep['cells'])} cells, {len(measured)} measured; "
          f"counting {count_s:.1f} s; phase {rep['seconds']:.1f} s",
          flush=True)
    return rep, launches


def digest_leaves(torch, tree) -> dict:
    """{path: (sum, index-weighted sum) of the leaf's 32-bit words} of a
    tree of 4-byte tensors, on their device (int64, wrapping): equal
    leaves give equal digests, and a changed word changes both sums but
    for collisions no test relies on. By chunks of 2^24 words, so the
    int64 temporaries stay small."""
    from repro_torch.optim.adam import leaves
    out = {}
    for p, t in leaves(tree):
        words = t.detach().contiguous().view(-1).view(torch.int32)
        h1 = h2 = 0
        for start in range(0, words.numel(), 1 << 24):
            c = words[start:start + (1 << 24)].long()
            w = torch.arange(start + 1, start + 1 + c.numel(),
                             device=c.device, dtype=torch.int64)
            h1 += int(c.sum())
            h2 += int((c * w).sum())
        out[p] = (h1, h2)
    return out


def mesh_rank(mesh, batch, draws, ckpt_dir, int8_seed, go):
    """One rank of the mesh phase (``run_on_mesh``; imports in here, as a
    spawned process starts bare), once the file ``go`` exists (the parent
    writes it when the card is free): PROD's Trainer on the mesh, the state
    placed from seed 0, 1 + MESH_TIMED steps on the top-bucket batch with
    the draws injected, the state after the first for the parent's hold,
    a checkpoint gathered to rank 0, and one int8 reduction."""
    import numpy as np
    import torch
    from repro_torch import core, training
    from repro_torch.configs import PROD
    from repro_torch.distributed.collectives import barrier
    from repro_torch.kernels import ops
    from repro_torch.optim import compressed_all_reduce
    from repro_torch.optim.adam import leaves
    marks = {"entered": time.time()}      # wall clock, the parent's too
    # the parent's one-process steps hold the card until it writes ``go``
    go, waited = pathlib.Path(go), time.time()
    while not go.exists():
        if time.time() - waited > 600:
            raise TimeoutError(f"rank {mesh.rank}: no {go} in 600 s")
        time.sleep(0.05)
    marks["go"] = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    if dev.type != "cuda":
        raise RuntimeError(f"mesh rank {mesh.rank} is on {dev}, not a card")
    trainer = training.get_trainer("speedyfeed", cfg=PROD, mesh=mesh)
    state = trainer.init_state(seed=0)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    marks["placed"] = time.time()
    out = {"rank": mesh.rank, "losses": [], "step_s": [], "marks": marks,
           "cache_rows": int(state.cache.emb.shape[0])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i, (u, neg) in enumerate(draws):
        barrier(mesh)
        t0 = time.perf_counter()
        state, m = trainer.step(state, tb, None, u=u, neg_idx=torch.as_tensor(
            neg, device=dev))
        out["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        barrier(mesh)
        out["step_s"].append(time.perf_counter() - t0)
        if i == 0:           # the state after the warm-up, for the hold
            ws = state.cache.written_step
            rows = torch.nonzero(ws != core.NEVER).flatten()
            # copies: the next steps update the state in place
            out["after_1"] = {
                "written_ids": rows + mesh.rank * ws.shape[0],
                "written_rows": state.cache.emb[rows],
                "written_step": ws.to("cpu", copy=True),
                "unwritten_max": float(state.cache.emb[ws == core.NEVER]
                                       .abs().max()),
                "params": ([t.detach().to("cpu", copy=True)
                            for _, t in leaves(state.params)]
                           if mesh.rank == 0 else None),
                "params_digest": digest_leaves(torch, state.params)}
    torch.cuda.synchronize()
    marks["stepped"] = time.time()
    out["launches"] = ops.launch_counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["step"] = state.step
    # the checkpoint: rank 0 gathers the cache rows and writes
    t0 = time.perf_counter()
    training.save_state(ckpt_dir, state.step, state,
                        shardings=trainer.state_shardings)
    out["save_s"] = time.perf_counter() - t0
    out["digest"] = {"cache": digest_leaves(torch, {
        "emb": state.cache.emb, "written_step": state.cache.written_step})}
    if mesh.rank == 0:
        out["digest"]["params"] = digest_leaves(torch, state.params)
        out["digest"]["opt"] = digest_leaves(torch, state.opt)
    marks["saved"] = time.time()
    del state, tb
    # the int8 reduction of CUDA gradients, seeded by rank
    g = torch.Generator(device=dev).manual_seed(int8_seed + mesh.rank)
    grads = {k: torch.randn(shape, generator=g, device=dev)
             * 10.0 ** (-3 + mesh.rank)
             for k, shape in MESH_INT8_SHAPES.items()}
    reduced, residual = compressed_all_reduce(
        grads, mesh, {k: torch.zeros_like(v) for k, v in grads.items()})
    torch.cuda.synchronize()
    out["int8"] = {"grads": grads, "reduced": reduced,
                   "residual": residual}
    marks["returned"] = time.time()
    return out


def mesh_serve(torch, np, dev, snap, emb, user):
    """The sharded index of the mesh phase on the slice's build: IVF-PQ
    (the served snapshot) and IVF-Flat over the same embeddings, each in
    MESH_SHARDS shards on the one card, against the unsharded search of
    the serving batch ``user``. Returns (report, PQ launches of the
    sharded search)."""
    from repro_torch import serving
    from repro_torch.kernels import ops
    from repro_torch.kernels.pq_scoring import pq_lut_scores_plain
    devices = [dev] * MESH_SHARDS
    flat = serving.IndexBuilder(
        "ivf-flat", emb.shape[1], ivf=serving.IVFConfig(
            nlist=snap.cent_unit.shape[0], nprobe=snap.nprobe,
            metric=snap.metric), device=dev).build(
        np.arange(1, emb.shape[0]), emb[1:])
    rep, launches = {}, {}
    for kind, one in (("ivf-pq", snap), ("ivf-flat", flat)):
        t0 = time.perf_counter()
        sharded = serving.shard_snapshot(one, devices)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        s_ref, i_ref = one.search(user, 10)
        sharded.search(user, 10)                  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        s_got, i_got = sharded.search(user, 10)
        torch.cuda.synchronize()
        search_ms = (time.perf_counter() - t0) * 1e3
        now = ops.launch_counts()
        launches[kind] = {n: now[n] for n in ("pq_lut_scores",
                                              "pq_lut_scores_general")}
        t0 = time.perf_counter()
        one.search(user, 10)
        torch.cuda.synchronize()
        r = {"shards": sharded.n_shards,
             "rows_per_shard": sharded.rows_per_shard, "cap": sharded.cap,
             "shard_s": shard_s, "search_ms": search_ms,
             "unsharded_search_ms": (time.perf_counter() - t0) * 1e3,
             "ids_equal": bool(torch.equal(i_got, i_ref)),
             "score_max_abs_err": float((s_got - s_ref).abs().max()),
             "score_max_abs": float(s_ref[torch.isfinite(s_ref)]
                                    .abs().max()),
             "launches": launches[kind]}
        # scores within 1e-4 of the largest (at least 1): IVF-Flat sums
        # d=768 products in another order (the unsharded scan scores
        # every cell in one GEMM, a shard its gathered window)
        r["score_max_rel_err"] = r["score_max_abs_err"] / max(
            1.0, r["score_max_abs"])
        check(r["ids_equal"], f"mesh: sharded {kind} top-10 ids differ "
              "from the unsharded snapshot's")
        check(r["score_max_rel_err"] <= 1e-4,
              f"mesh: sharded {kind} scores differ by "
              f"{r['score_max_abs_err']} of {r['score_max_abs']}")
        want = MESH_SHARDS if kind == "ivf-pq" else 0
        check(launches[kind] == {"pq_lut_scores": want,
                                 "pq_lut_scores_general": 0},
              f"mesh: sharded {kind} search launched {launches[kind]}, "
              f"expected {want} tiled scans")
        if kind == "ivf-pq":
            # each shard's scan on its own window, against plain
            q = torch.as_tensor(user, dtype=torch.float32, device=dev)
            probes, lut, _ = sharded.probe(q)
            errs = []
            for s_ in range(sharded.n_shards):
                local, _, valid = sharded.window(s_, probes)
                codes = sharded.payload_s[s_][local].reshape(
                    q.shape[0], -1, sharded.dim_codes)
                got = ops.pq_lut_scores(lut, codes, valid)
                exp = pq_lut_scores_plain(lut, codes, valid)
                fin = torch.isfinite(exp)
                check(torch.equal(fin, torch.isfinite(got)),
                      f"mesh: shard {s_}'s scan masks other slots")
                errs.append(float((got[fin] - exp[fin]).abs().max())
                            if fin.any() else 0.0)
                check(errs[-1] <= TOL_PQ, f"mesh: shard {s_}'s scan "
                      f"differs from plain by {errs[-1]}")
            r["shard_scan_max_abs_err"] = errs
            r["shard_scan_shape"] = [int(q.shape[0]), int(codes.shape[1]),
                                     int(codes.shape[2])]
        unsharded = serving.unshard_snapshot(sharded)
        check(all(torch.equal(getattr(unsharded, n), getattr(one, n))
                  for n in ("list_ids", "payload", "lens")),
              f"mesh: unshard_snapshot of {kind} differs from the build")
        rep[kind] = r
        del sharded, unsharded
    del flat
    return rep, launches["ivf-pq"]


def mesh_train(torch, np, dev, cfg, card, top_np):
    """The training half of the mesh phase (module docstring, phase 7b).
    Returns (report, bus launches summed over the ranks)."""
    import shutil

    from repro_torch import core, training
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.optim.adam import leaves
    batch = {k: v for k, v in top_np.items() if not k.startswith("_")}
    g = np.random.default_rng(33)
    B, L = batch["hist_mask"].shape
    draws = [(float(g.random()), g.integers(1, cfg.merged_cap,
                                            (B, L - 1, cfg.n_neg)))
             for _ in range(1 + MESH_TIMED)]
    rep = {"ranks": MESH_RANKS, "rows_per_rank": cfg.cache.encode_budget
           // MESH_RANKS, "users": B, "bucket": int(top_np["_bucket"])}
    root = ROOT / "build" / "mesh_ckpt_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    # the ranks start now: a process takes ~10 s to import torch and reach
    # the card there, so they start (and join their group) while the
    # one-process steps below run, and wait for ``go`` before they
    # allocate; ``run_on_mesh`` blocks, so it runs on a thread
    go, ranks = root / "go", {}

    def spawn():
        try:
            ranks["out"] = run_on_mesh(
                mesh_rank, MESH_RANKS, [card0] * MESH_RANKS, "gloo",
                args=(batch, draws, str(root), 7, str(go)), timeout=600.0)
        except BaseException as e:      # raised again on the main thread
            ranks["error"] = e

    card0 = f"cuda:{torch.cuda.current_device()}"
    t0, spawned = time.perf_counter(), time.time()
    thread = threading.Thread(target=spawn, daemon=True)
    thread.start()
    try:
        # the one-process step from the same state, batch and draws
        trainer = training.get_trainer("speedyfeed", cfg=cfg, device=dev)
        state = trainer.init_state(seed=0)
        # leaves that start at 0 (the biases): after one Adam step an
        # entry is lr * g / (|g| + eps), which the gradient's summation
        # order moves by percents of lr where |g| is near eps; they are
        # read against the largest leaf, as the key biases are in
        # ``grad_agreement``
        zero_init = {n for n, t in leaves(state.params)
                     if not bool(t.any())}
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        ref_losses, ref_s = [], []
        for i, (u, neg) in enumerate(draws):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = trainer.step(state, tb, None, u=u,
                                    neg_idx=torch.as_tensor(neg, device=dev))
            ref_losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ref_s.append(time.perf_counter() - t1)
            if i == 0:
                # copies: the next steps update the state in place
                names = [n for n, _ in leaves(state.params)]
                ref_params = [t.detach().to("cpu", copy=True).numpy()
                              for _, t in leaves(state.params)]
                ref_emb = state.cache.emb.to("cpu", copy=True).numpy()
                ref_ws = state.cache.written_step.to(
                    "cpu", copy=True).numpy()
        rep["one_process"] = {"losses": ref_losses, "step_s": ref_s}
        del trainer, state, tb, m
        gc_collect(torch)
        rep["parent_resident_gb"] = {
            "allocated": torch.cuda.memory_allocated() / 1e9,
            "reserved": torch.cuda.memory_reserved() / 1e9,
            "card_used": (torch.cuda.mem_get_info()[1]
                          - torch.cuda.mem_get_info()[0]) / 1e9}
        print("mesh: before the ranks allocate, resident " + json.dumps(
            rep["parent_resident_gb"]), flush=True)
        go.touch()
        rep["go_s"] = time.time() - spawned
        thread.join()
        if "error" in ranks:
            raise ranks["error"]
        out = ranks["out"]
        rep["ranks_s"] = time.perf_counter() - t0
        # where the ranks' seconds went: the slowest rank to each mark,
        # from the spawn (wall clock), and the results' way back
        rep["ranks_timeline_s"] = {
            k: max(r["marks"][k] for r in out) - spawned
            for k in out[0]["marks"]}
        rep["ranks_timeline_s"]["joined"] = time.time() - spawned
        print("mesh: ranks " + json.dumps(
            {"losses": [r["losses"] for r in out], "one_process": ref_losses,
             "step_s": [r["step_s"] for r in out], "one_process_s": ref_s,
             "peak_gb": [r["peak_gb"] for r in out],
             "save_s": [r["save_s"] for r in out]}), flush=True)
        # losses: every rank's against the one process
        for r in out:
            err = float(np.abs(np.array(r["losses"])
                               - np.array(ref_losses)).max())
            check(err <= TOL_MESH, f"mesh: rank {r['rank']}'s losses "
                  f"{r['losses']} vs one process {ref_losses}")
        rep["losses"] = out[0]["losses"]
        rep["loss_max_abs_err"] = max(
            float(np.abs(np.array(r["losses"]) - np.array(ref_losses)).max())
            for r in out)
        # after one step: parameters on every rank the same, within
        # TOL_MESH of each leaf's largest magnitude of the one process; the
        # leaves that start at 0 (``zero_init``, the key biases among
        # them) against the largest of any leaf, their own worst read
        check(all(r["after_1"]["params_digest"] == out[0]["after_1"][
            "params_digest"] for r in out), "mesh: ranks' parameters differ")
        top_mag = max(float(np.abs(b).max()) for b in ref_params)
        err = {n: float(np.abs(a - b).max()) for n, a, b in
               zip(names, out[0]["after_1"]["params"], ref_params)}
        own = {n: err[n] / max(float(np.abs(b).max()), 1e-30)
               for n, b in zip(names, ref_params)}
        rel = {n: err[n] / top_mag if n in zero_init else own[n]
               for n in names}
        worst = max(rel, key=rel.get)
        worst_zero = max(zero_init, key=own.get)
        rep.update(param_max_rel_err=rel[worst], param_worst_leaf=worst,
                   zero_init_leaves=len(zero_init),
                   zero_init_worst_own_rel=[worst_zero, own[worst_zero]])
        check(rel[worst] <= TOL_MESH, f"mesh: parameter leaf {worst} "
              f"differs by {rel[worst]} after one step")
        # each rank's cache block: the one process's rows
        rows = cfg.cache.n_news // MESH_RANKS
        worst = 0.0
        for r in out:
            a1, lo = r["after_1"], r["rank"] * rows
            check(r["cache_rows"] == rows, f"mesh: rank {r['rank']} holds "
                  f"{r['cache_rows']} cache rows, expected {rows}")
            check(np.array_equal(a1["written_step"], ref_ws[lo:lo + rows]),
                  f"mesh: rank {r['rank']}'s written_step block differs")
            check(a1["unwritten_max"] == 0.0 and np.count_nonzero(
                ref_emb[lo:lo + rows][ref_ws[lo:lo + rows]
                                      == int(core.NEVER)]) == 0,
                  f"mesh: rank {r['rank']}'s unwritten rows are not zero")
            if len(a1["written_ids"]):
                worst = max(worst, float(np.abs(
                    a1["written_rows"] - ref_emb[a1["written_ids"]]).max()))
        rep["cache_rows_written"] = sum(len(r["after_1"]["written_ids"])
                                        for r in out)
        rep["cache_max_abs_err"] = worst
        check(worst <= TOL_MESH, f"mesh: cache rows differ by {worst}")
        # the ranks' kernels: the bus pair on every rank, 2 x L forward
        # (remat) and L backward a step, none on the SIMT pair
        L, n_steps = cfg.plm.n_layers, 1 + MESH_TIMED
        for r in out:
            c = r["launches"]
            check(c["bus_attention"] == 2 * L * n_steps
                  and c["bus_attention_bwd"] == L * n_steps
                  and c["bus_attention_simt"] == 0
                  and c["bus_attention_bwd_simt"] == 0,
                  f"mesh: rank {r['rank']} launched {c}")
        launches = {n: sum(r["launches"][n] for r in out)
                    for n in ("bus_attention", "bus_attention_bwd")}
        step_s = [max(r["step_s"][i] for r in out)
                  for i in range(1, n_steps)]
        rep.update({
            "launches_by_rank": [{n: r["launches"][n] for n in launches}
                                 for r in out],
            "peak_gb_by_rank": [r["peak_gb"] for r in out],
            "warmup_s": max(r["step_s"][0] for r in out),
            "step_s": step_s, "s_per_step": float(np.mean(step_s)),
            "one_process_s_per_step": float(np.mean(ref_s[1:])),
            "save_s": max(r["save_s"] for r in out)})
        # the checkpoint, restored on one device: leaf for leaf the mesh's
        like = training.get_trainer("speedyfeed", cfg=cfg,
                                    device=dev).init_state(seed=1)
        t0 = time.perf_counter()
        step, got = training.restore_state(str(root), like)
        torch.cuda.synchronize()
        rep["restore_s"] = time.perf_counter() - t0
        check(step == got.step == out[0]["step"],
              f"mesh: restored step {step}, saved {out[0]['step']}")
        check(digest_leaves(torch, got.params) == out[0]["digest"]["params"]
              and digest_leaves(torch, got.opt) == out[0]["digest"]["opt"],
              "mesh: restored parameters or moments differ from the mesh's")
        for r in out:
            lo = r["rank"] * rows
            check(digest_leaves(torch, {
                "emb": got.cache.emb[lo:lo + rows],
                "written_step": got.cache.written_step[lo:lo + rows]})
                == r["digest"]["cache"],
                f"mesh: restored cache rows of rank {r['rank']} differ")
        rep["ckpt_leaves_equal"] = True
        del like, got
        # the int8 reduction against numpy's evaluation of JAX's formula
        int8 = {}
        for k in MESH_INT8_SHAPES:
            gs = [r["int8"]["grads"][k].astype(np.float32) for r in out]
            scales = [np.float32(max(np.abs(x).max(), np.float32(1e-12)))
                      / np.float32(127.0) for x in gs]
            qs = [np.clip(np.round(x / s_), -127, 127).astype(np.int32)
                  for x, s_ in zip(gs, scales)]
            ss = np.float32(max(scales))
            want = (np.sum(qs, axis=0).astype(np.float32) * ss
                    / np.float32(MESH_RANKS))
            err = max(float(np.abs(r["int8"]["reduced"][k] - want).max())
                      for r in out)
            # each rank's residual within one step of its own scale (a
            # code one apart where x / scale lies on a rounding edge)
            res = max(float(np.abs(r["int8"]["residual"][k]
                                   - (x - q * s_)).max() / s_)
                      for r, x, q, s_ in zip(out, gs, qs, scales))
            int8[k] = {"max_abs_err": err, "step": float(ss),
                       "residual_max_err_in_steps": res}
            check(err <= ss and res <= 1.0 + 1e-3,
                  f"mesh: int8 reduction of {k} differs: {int8[k]}")
        rep["int8"] = int8
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep["card"] = card
    return rep, launches


def lm_mesh_sample(torch, n: int):
    """Up to LM_MESH_SAMPLE evenly spaced flat positions of a leaf of n
    elements (every one of a smaller leaf), on the host."""
    return torch.unique(torch.linspace(0, n - 1, min(n, LM_MESH_SAMPLE),
                                       dtype=torch.float64).long())


def lm_mesh_read(torch, np, tree, specs=None, mesh=None,
                 rows=None) -> dict:
    """{path: (positions, values, largest magnitude)} of every leaf of
    ``tree``: of ``lm_mesh_sample``'s flat positions in the whole leaf
    (for a path in ``rows``, {path: sorted row ids}, every element of
    those rows instead), those this rank's block holds (its spec in
    ``specs``, {path: Spec}, on ``mesh``; every one with no mesh), the
    leaf's values there, and the block's largest magnitude. No leaf is
    gathered: the parent joins the ranks' reads."""
    from repro_torch.distributed import sharding as shx
    from repro_torch.optim.adam import leaves
    out = {}
    for path, leaf in leaves(tree):
        spec = specs[path] if mesh is not None else ()
        local = list(leaf.shape)
        whole = list(shx.global_shape(tuple(local), spec, mesh)) \
            if mesh is not None else local
        if rows is not None and path in rows:
            width = int(np.prod(whole[1:]))
            pos = (rows[path][:, None] * width + np.arange(width)).ravel()
        else:
            pos = lm_mesh_sample(torch, int(np.prod(whole))).numpy()
        coords = list(np.unravel_index(pos, whole))
        own = np.ones(len(pos), bool)
        for d, entry in enumerate(spec):
            if entry is not None:      # an even cut or the head plan's
                lo, hi = shx.dim_range(entry, whole[d], mesh)
                own &= (coords[d] >= lo) & (coords[d] < hi)
                coords[d] = coords[d] - lo
        flat = np.ravel_multi_index([c[own] for c in coords], local)
        vals = leaf.detach().reshape(-1)[torch.as_tensor(
            flat, device=leaf.device)]
        out[path] = (pos[own], vals.float().cpu().numpy(),
                     float(leaf.detach().abs().max()))
    return out


def lm_mesh_joined(reads: list) -> dict:
    """The ranks' ``lm_mesh_read``s joined: {path: (values at every sample
    position, in order; the largest magnitude)}."""
    import numpy as np
    out = {}
    for path in reads[0]:
        got = {}
        for r in reads:
            pos, vals, _ = r[path]
            got.update(zip(pos.tolist(), vals.tolist()))
        order = sorted(got)
        out[path] = (np.array([got[p] for p in order], np.float64),
                     max(r[path][2] for r in reads), order)
    return out


def lm_mesh_holds():
    """The f32 holds: (name, kind, config, seed, mesh shape) for prefill
    and decode, and for train: LM_MESH_HOLD's on LM_MESH_SHAPE (DBRX's
    train hold at LM_MESH_DBRX_DFF), LM_MESH_HEADS_HOLD's on
    LM_MESH_HEADS_SHAPE."""
    import dataclasses

    from repro_torch.configs import lm_family
    out = []
    plan = [(n, d, LM_MESH_SHAPE) for n, d in LM_MESH_HOLD.items()] + \
        [(n, d, LM_MESH_HEADS_SHAPE) for n, d in LM_MESH_HEADS_HOLD.items()]
    for seed, (name, depth, shape) in enumerate(plan):
        cfg = dataclasses.replace(lm_family.CONFIGS[name], n_layers=depth,
                                  dtype="float32")
        train = dataclasses.replace(cfg, d_ff=LM_MESH_DBRX_DFF) \
            if cfg.is_moe else cfg
        out += [(name, "serve", cfg, seed, shape),
                (name, "train", train, 10 + seed, shape)]
    return out


def lm_mesh_hold_run(torch, np, dev, cfg, kind, seed, tokens, mesh=None,
                     split: bool = False):
    """One hold's run on ``mesh`` (in a rank) or in one process: ``serve``:
    prefill logits and 4 decode steps' logits; ``train``: 2 train steps
    (losses, global grad norms, the parameters after them). With no mesh
    an MoE config runs each data half alone (the mesh's routing: each
    data rank routes its own tokens, at its own capacity), the train loss
    the halves' mean; ``split`` does the same for a dense config (the
    same function, its halves' rows alike, summed in another order: one
    process's own rounding spread, ``lm_mesh_hold_check``'s ``floor``).
    The train steps start from Adam's count at LM_MESH_OPT_COUNT.
    Returns host results; leaves (the parameters before and after the
    steps, both moments after) as ``lm_mesh_read`` reads them."""
    from repro_torch import optim
    from repro_torch.configs import lm_family
    from repro_torch.distributed.collectives import barrier
    from repro_torch.models import lm
    from repro_torch.models import lm_parallel as tp
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        params = lm.init(gen, cfg, torch.float32)
    else:
        # one rank at a time: a rank draws a whole layer before it keeps
        # its blocks (12.7 GB of DBRX's experts at full width in f32)
        for turn in range(mesh.world):
            if turn == mesh.rank:
                params = lm_family.init_placed(gen, cfg, mesh, torch.float32)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            barrier(mesh)
    tok = torch.as_tensor(tokens, device=dev)
    D = LM_MESH_SHAPE[0]
    halves = ([slice(i * len(tok) // D, (i + 1) * len(tok) // D)
               for i in range(D)] if mesh is None and (cfg.is_moe or split)
              else [slice(None)])
    out = {}
    if kind == "serve":
        pre = lm_family.make_fn(cfg, "prefill", mesh)
        out["prefill"] = torch.cat([pre(params, tok[h]) for h in halves])
        dec = lm_family.make_fn(cfg, "decode", mesh)
        steps = []
        for h in halves:
            cache = lm.init_cache(cfg, len(tok[h]), LM_MESH_HOLD_SLOTS,
                                  torch.float32, device=dev, mesh=mesh)
            steps.append(torch.stack([dec(params, tok[h][:, t:t + 1],
                                          cache, t)[0] for t in range(4)]))
        out["decode"] = torch.cat(steps, dim=1)
        return {k: v.float().cpu().numpy() for k, v in out.items()}
    ignore = torch.full((len(tok), 1), -100, dtype=tok.dtype, device=dev)
    batch = {"tokens": tok, "labels": torch.cat([tok[:, 1:], ignore], 1)}

    def loss_fn(p, b):
        if mesh is not None:
            return lm.lm_loss(p, cfg, b, mesh=mesh)[0]
        return sum(lm.lm_loss(p, cfg, {k: v[h] for k, v in b.items()})[0]
                   for h in halves) / len(halves)

    step = optim.make_train_step(
        loss_fn, lm_family.TRAIN_OPT, lm_family.TRAIN_SCHEDULE, mesh=mesh,
        specs=None if mesh is None else (
            lambda p: tp.specs_by_path(p, cfg, mesh)))
    opt = optim.adam_init(params)
    opt["count"].fill_(LM_MESH_OPT_COUNT)
    specs = None if mesh is None else tp.specs_by_path(params, cfg, mesh)
    out["before"] = lm_mesh_read(torch, np, params, specs, mesh)
    out.update(losses=[], grad_norms=[])
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = lm_mesh_read(torch, np, params, specs, mesh)
    for k in "mv":
        out[k] = lm_mesh_read(torch, np, opt[k], specs, mesh)
    del opt
    return out


def spy_flash_to_host(torch, captured: dict):
    """Spies on the flash pair's wrappers as ``kernels/ops.py`` calls them
    (``flash_attention_cuda``, ``flash_attention_bwd_cuda``): each keeps
    a host copy of the inputs of its wrapper's first call in ``captured``,
    by the wrapper's name (on the host, so that a run keeps no more on
    the card), then calls the wrapper. Returns the function that takes
    the spies off."""
    from repro_torch.kernels import flash_attention as fa
    saved = {a: getattr(fa, a) for a in ("flash_attention_cuda",
                                          "flash_attention_bwd_cuda")}

    def spy_of(attr, fn):
        def spy(*args, **kw):
            if attr not in captured:
                captured[attr] = [a.detach().cpu() if isinstance(
                    a, torch.Tensor) else a for a in args]
            return fn(*args, **kw)
        return spy

    for attr, fn in saved.items():
        setattr(fa, attr, spy_of(attr, fn))
    return lambda: [setattr(fa, a, fn) for a, fn in saved.items()]


def lm_mesh_flash_holds(torch, dev, captured: dict, label: str) -> dict:
    """A bf16 run's flash calls (``spy_flash_to_host``) held to the plain
    versions at the run's own shapes (this rank's heads and batch): the
    forward launched again on its inputs, its first, a middle and the
    last FLASH_ROWS rows against plain (``flash_fwd_errors``, with its
    dropped-tile control); the backward's f32 gradients before the cast
    against plain's, with dO brought to an RMS in [0.5, 1) by a power of
    two as in the lm-train phase's layer-0 check (``bwd_hopper_errors``,
    with its controls)."""
    from repro_torch.kernels.flash_attention import (
        _bwd_cuda_as_written, _bwd_plain_f32, flash_attention_cuda)
    out = {}
    if "flash_attention_cuda" in captured:
        *qkv, causal = captured["flash_attention_cuda"]
        check(causal, f"lm-mesh {label}: a non-causal flash forward")
        q, k, v = (t.to(dev) for t in qkv)
        o, lse = flash_attention_cuda(q, k, v, True)
        S, R = q.shape[1], min(FLASH_ROWS, q.shape[1])
        out["fwd"] = {"shape": list(q.shape) + [k.shape[2]]}
        for name, r0 in (("first", 0), ("middle", S // 2), ("last", S - R)):
            out["fwd"][name] = flash_fwd_errors(
                o[:, r0:r0 + R], lse[:, :, r0:r0 + R], q[:, r0:r0 + R],
                k[:, :r0 + R], v[:, :r0 + R], q.dtype,
                f"lm-mesh {label} rows {name}")
        del q, k, v, o, lse
    if "flash_attention_bwd_cuda" in captured:
        *args, causal = captured["flash_attention_bwd_cuda"]
        check(causal, f"lm-mesh {label}: a non-causal flash backward")
        q, k, v, o, lse, do = (t.to(dev) for t in args)
        do_rms = float(do.float().square().mean().sqrt())
        do_scale = 2.0 ** -torch.frexp(torch.tensor(do_rms)).exponent.item()
        do = do * do_scale
        got = _bwd_cuda_as_written(q, k, v, o, lse, do, True)
        exp = _bwd_plain_f32(q, k, v, o, lse, do, True)
        out["bwd"] = {"shape": list(q.shape) + [k.shape[2]],
                      "do_rms": do_rms, "do_scale": do_scale,
                      **bwd_hopper_errors(q, k, v, o, lse, do, got, exp,
                                          f"lm-mesh {label}")}
        del q, k, v, o, lse, do, got, exp
    return out


def lm_mesh_rank(mesh, go, holds_tokens, bf16_plan):
    """One rank of the lm-mesh phase (``run_on_mesh``; imports in here,
    as a spawned process starts bare), once the file ``go`` exists: the
    f32 holds on the (2, 2) mesh, then the bf16 runs of ``bf16_plan``
    with the launch counts set to 0 just before and read just after, each
    run's first flash forward and backward inputs kept on the host; then,
    one rank at a time, those calls held to plain, their launches apart
    (``lm_mesh_flash_holds``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import lm_family
    from repro_torch.distributed.collectives import barrier
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import submesh
    from repro_torch.models import lm
    marks = {"entered": time.time()}
    go, waited = pathlib.Path(go), time.time()
    while not go.exists():
        if time.time() - waited > 900:
            raise TimeoutError(f"rank {mesh.rank}: no {go} in 900 s")
        time.sleep(0.05)
    marks["go"] = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    if dev.type != "cuda":
        raise RuntimeError(f"lm-mesh rank {mesh.rank} is on {dev}")
    out = {"rank": mesh.rank, "marks": marks, "holds": {},
           "index": {a: mesh.index(a) for a in ("data", "model")}}

    def note(what):
        if mesh.rank == 0:
            print(f"lm-mesh: rank 0 {what} at "
                  f"{time.time() - marks['go']:.1f} s after go, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)

    from repro_torch.models import lm_parallel as tp
    ops.reset_launch_counts()
    heads = submesh(mesh, data=LM_MESH_HEADS_SHAPE[0],
                    model=LM_MESH_HEADS_SHAPE[1])
    for (name, kind, cfg, seed, shape), tokens in zip(lm_mesh_holds(),
                                                      holds_tokens):
        m = mesh if shape == LM_MESH_SHAPE else heads
        out["holds"][f"{name}/{kind}"] = lm_mesh_hold_run(
            torch, np, dev, cfg, kind, seed, tokens, m)
        gc_collect(torch)
        note(f"held {name} {kind}")
        if m is heads and kind == "train":
            # the control: the same steps with each KV head's gradient
            # left at the rank's own query heads' part (no sum over the
            # ranks that share it)
            real = tp.kv_in_region
            tp.kv_in_region = lambda attn, mesh, R: attn
            try:
                out["holds"][f"{name}/train_no_kv_sum"] = lm_mesh_hold_run(
                    torch, np, dev, cfg, kind, seed, tokens, m)
            finally:
                tp.kv_in_region = real
            gc_collect(torch)
            note(f"ran {name}'s control (no KV sum)")
    out["hold_launches"] = ops.launch_counts()
    marks["held"] = time.time()

    def timed(fn, m):
        barrier(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        barrier(m)
        return r, time.perf_counter() - t0

    g = torch.Generator(device=dev)
    bf16 = torch.bfloat16
    # the Hopper flash pair's first launches in this process (the library
    # loads), on a small input, before the counts are set to 0
    q = torch.randn(1, 256, 2, 128, device=dev, dtype=bf16,
                    requires_grad=True)
    ops.flash_attention(q, q, q, causal=True).sum().backward()
    del q
    runs, captured, flash_calls = {}, {}, {}
    restore = spy_flash_to_host(torch, captured)
    ops.reset_launch_counts()
    for run in bf16_plan:
        name, kind, L, shape = run["name"], run["kind"], run["layers"], \
            tuple(run["mesh"])
        m = mesh if shape == LM_MESH_SHAPE else submesh(
            mesh, data=shape[0], model=shape[1])
        cfg = dataclasses.replace(lm_family.CONFIGS[name], n_layers=L)
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        # one rank at a time: a rank draws a whole layer before it keeps
        # its blocks (6.5 GB of DBRX in bf16, 4 GB more in f32 draws)
        for turn in range(mesh.world):
            if turn == mesh.rank:
                params = lm_family.init_placed(g.manual_seed(3), cfg, m,
                                               bf16)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()     # the draws' cached blocks
            barrier(mesh)
        r = {"init_s": time.perf_counter() - t0,
             "param_gb": (torch.cuda.memory_allocated() - base) / 1e9,
             "mesh": list(shape)}
        B, S = run["batch"], run["seq"]
        toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
        if kind == "prefill":
            pre = lm_family.make_fn(cfg, "prefill", m)
            logits, r["s"] = timed(lambda: pre(params, toks), m)
            r["finite"] = bool(torch.isfinite(logits).all())
            r["logits_shape"] = list(logits.shape)
        elif kind == "decode":
            dec = lm_family.make_fn(cfg, "decode", m)
            cache = lm.init_cache(cfg, B, S, bf16, device=dev, mesh=m)
            r["cache_gb"] = sum(t.numel() * t.element_size()
                                for t in cache.values()) / 1e9
            r["step_s"] = []
            for i in range(LM_MESH_DECODE_STEPS):
                (logits, cache), dt = timed(lambda: dec(
                    params, toks[:, i:i + 1], cache, S - 1 - i), m)
                r["step_s"].append(dt)
            r["finite"] = bool(torch.isfinite(logits).all())
            r["logits_shape"] = list(logits.shape)
            del cache
        else:
            step = lm_family.make_fn(cfg, "train", m)
            opt = lm_family.optim.adam_init(params)
            r["state_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
            ignore = torch.full((B, 1), -100, dtype=toks.dtype, device=dev)
            batch = {"tokens": toks, "labels": torch.cat([toks[:, 1:],
                                                          ignore], 1)}
            (params, opt, met), r["s"] = timed(
                lambda: step(params, opt, batch), m)
            r["losses"] = [float(met["loss"])]
            r["grad_norm"] = float(met["grad_norm"])
            r["finite"] = all(np.isfinite(r["losses"]))
            del opt
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        runs[f"{name}/{kind}"] = r
        flash_calls[f"{name}/{kind}"] = dict(captured)
        captured.clear()
        del params
        note(f"ran {name} {kind} ({r.get('s', r.get('step_s'))} s)")
    out["launches"] = ops.launch_counts()
    restore()
    out["bf16"] = runs
    out["flash_captured"] = {key: sorted(c) for key, c in
                             flash_calls.items()}
    gc_collect(torch)
    ops.reset_launch_counts()
    out["flash_holds"] = {}
    for turn in range(mesh.world):
        if turn == mesh.rank:
            for key, c in flash_calls.items():
                out["flash_holds"][key] = lm_mesh_flash_holds(
                    torch, dev, c, f"rank {mesh.rank} {key}")
                gc_collect(torch)
        barrier(mesh)
    torch.cuda.synchronize()
    out["flash_hold_launches"] = ops.launch_counts()
    del flash_calls
    note("held the bf16 runs' flash calls")
    import resource
    out["host_peak_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    marks["timed"] = time.time()
    return out


def lm_mesh_bf16_plan() -> list:
    """The bf16 runs at full width (module docstring, phase 10b)."""
    from repro_torch.configs import lm_family
    B_dec, slots = LM_MESH_DECODE
    dbrx = lm_family.ONE_CARD_SERVE["dbrx-132b"]
    train = lm_family.ONE_CARD_TRAIN
    S_train = lm_family.LM_SHAPES["train_4k"]["seq"]
    tp4 = (1, LM_MESH_RANKS)
    return [
        dict(name="qwen3-14b", kind="prefill",
             layers=LM_MESH_PREFILL_LAYERS, batch=2,
             seq=LM_MESH_PREFILL_SEQ, mesh=LM_MESH_SHAPE),
        dict(name="qwen3-14b", kind="decode", layers=40, batch=B_dec,
             seq=slots, mesh=tp4),
        dict(name="dbrx-132b", kind="prefill", layers=dbrx, batch=2,
             seq=LM_MESH_PREFILL_SEQ, mesh=tp4),
        dict(name="dbrx-132b", kind="decode", layers=dbrx, batch=B_dec,
             seq=slots, mesh=tp4),
        dict(name="qwen3-14b", kind="train", layers=LM_MESH_TRAIN_LAYERS,
             batch=train["batch"], seq=S_train, mesh=LM_MESH_SHAPE),
        dict(name="dbrx-132b", kind="train", layers=1,
             batch=train["batch"], seq=S_train, mesh=tp4)]


def lm_mesh_expected_launches(plan) -> dict:
    """The flash launches a rank makes over ``plan``'s bf16 runs: a
    prefill L Hopper forwards, a decode step none, a train step 2 L
    forwards (remat) and L backward pairs."""
    fwd = bwd = 0
    for run in plan:
        if run["kind"] == "prefill":
            fwd += run["layers"]
        elif run["kind"] == "train":
            fwd += 2 * run["layers"]
            bwd += run["layers"]
    want = {k: 0 for k in FLASH_KERNELS}
    want.update(flash_attention_wgmma=fwd,
                flash_attention_bwd_dq_wgmma=bwd,
                flash_attention_bwd_dkv_wgmma=bwd)
    return want


def lm_mesh_no_kv_sum(np, out, name: str, exp: dict) -> dict:
    """The head plan's control: the ranks' train hold run with each KV
    head's gradient left at the rank's own query heads' part
    (``lm_parallel.kv_in_region`` the identity), its k and v weights' and
    biases' changes against one process's (``exp``, ``lm_mesh_joined``
    reads): each must miss TOL_LM_MESH["change"] of its norm."""
    got = lm_mesh_joined([r["holds"][f"{name}/train_no_kv_sum"]["params"]
                          for r in out])
    errs = {}
    for p_, (vals, _, _) in got.items():
        if "/attn/k/" not in p_ and "/attn/v/" not in p_:
            continue
        e_vals, before = exp["params"][p_][0], exp["before"][p_][0]
        errs[p_] = float(np.linalg.norm(vals - e_vals)
                         / np.linalg.norm(e_vals - before))
    check(errs and min(errs.values()) > TOL_LM_MESH["change"],
          f"lm-mesh: {name}'s steps without the KV sum pass the change "
          f"limit: {errs}")
    return {"kv_leaves": len(errs), "min_change_rel_err": min(errs.values())}


def flash_group_holds(torch, dev) -> tuple:
    """The flash pair at the head plan's rank shapes, Hq = FLASH_GROUP_HQ
    query heads over one KV head ([FLASH_GROUP_B, FLASH_GROUP_S, Hq, 1,
    FLASH_GROUP_D], causal), each route against plain on the same inputs:
    bf16 on the Hopper pair (the forward by ``flash_fwd_errors`` with its
    dropped-tile control; the backward's f32 gradients before the cast and
    their casts by ``bwd_hopper_errors``, dO at unit RMS, with its
    controls), f32 on the 3xTF32 pair (the forward within TOL_FLASH, a
    dropped key tile's plain output over it; the backward by
    ``bwd_f32_errors`` with its controls). Returns ({label: errors},
    the launches by kernel, counted from 0: checks, apart from the main
    paths)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        _bwd_cuda_as_written, _bwd_plain_f32, flash_attention_cuda,
        flash_attention_fwd_plain)
    B, S, D = FLASH_GROUP_B, FLASH_GROUP_S, FLASH_GROUP_D
    g = torch.Generator(device=dev).manual_seed(37)
    out = {}
    ops.reset_launch_counts()
    for hq in FLASH_GROUP_HQ:
        for dtype in (torch.bfloat16, torch.float32):
            label = f"hq{hq}_hkv1_{str(dtype)[6:]}"
            q = torch.randn(B, S, hq, D, device=dev, generator=g).to(dtype)
            k, v = (torch.randn(B, S, 1, D, device=dev, generator=g)
                    .to(dtype) for _ in range(2))
            o, lse = flash_attention_cuda(q, k, v, True)
            e = {"shape": [B, S, hq, 1, D],
                 "fwd": flash_fwd_errors(o, lse, q, k, v, dtype,
                                         f"flash group {label}")}
            if dtype == torch.float32:
                o_p = flash_attention_fwd_plain(q, k, v, True)[0]
                o_c = flash_attention_fwd_plain(
                    q, k, dropped_tile(v, S - 64), True)[0]
                e["fwd"]["control_o"] = float((o_c - o_p).abs().max())
                check(e["fwd"]["control_o"] > TOL_FLASH["float32"],
                      f"flash group {label}: the f32 limit misses a "
                      f"dropped key tile: {e['fwd']}")
                del o_p, o_c
            do = torch.randn(B, S, hq, D, device=dev, generator=g).to(dtype)
            got = _bwd_cuda_as_written(q, k, v, o, lse, do, True)
            exp = _bwd_plain_f32(q, k, v, o, lse, do, True)
            errors = bwd_hopper_errors if dtype == torch.bfloat16 \
                else bwd_f32_errors
            e["bwd"] = errors(q, k, v, o, lse, do, got, exp,
                              f"flash group {label}")
            out[label] = e
            del q, k, v, o, lse, do, got, exp
            gc_collect(torch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print("flash-groups: " + json.dumps(out), flush=True)
    return out, launches


def lm_mesh_hold_check(np, key: str, kind: str, out: list, ref: dict,
                       D: int, label: str = "lm-mesh",
                       floor: dict | None = None) -> dict:
    """One f32 hold of the ranks' results ``out`` (each rank's ``holds``
    by key and its ``index``) against one process's ``ref``, on a mesh of
    D data ranks. ``serve``: every rank's prefill and decode logits (its
    data block) within TOL_LM_MESH["logits"] of the largest. ``train``:
    losses and grad norms the same on every rank and within their limits;
    the parameters before and after the steps and both moments after
    them, each leaf's sample, within the limit of the leaf's largest (a
    leaf that starts at 0, and LM_MESH_NOISE's moments, of the part's
    largest leaf); each leaf's change within TOL_LM_MESH["change"] of the
    norm of one
    process's change, a limit the state left unchanged must miss (the
    control); where the ranks also ran the steps without the KV sum, that
    control (``lm_mesh_no_kv_sum``). With ``floor`` (one process's train
    run summed in another order, ``lm_mesh_hold_run(split=True)``), a
    leaf's parameters and moments are held within LM_MESH_FLOOR_X times
    that run's own distance from ``ref`` where that is above the limit:
    the limit cannot ask the mesh to agree closer than one process agrees
    with itself."""
    h = {}
    if kind == "serve":
        for part in ("prefill", "decode"):
            big = float(np.abs(ref[part]).max())
            err = 0.0
            for r in out:
                i = r["index"]["data"] if D > 1 else 0
                n = ref[part].shape[-2] // D
                exp = ref[part][..., i * n:(i + 1) * n, :]
                got = r["holds"][key][part]
                check(got.shape == exp.shape, f"{label}: {key} {part} "
                      f"shape {got.shape}, expected {exp.shape}")
                err = max(err, float(np.abs(got - exp).max()))
            h[f"{part}_max_rel_err"] = err / big
            check(err / big <= TOL_LM_MESH["logits"], f"{label}: {key} "
                  f"{part} logits differ by {err} of {big}")
    else:
        for k in ("losses", "grad_norms"):
            tol = TOL_LM_MESH["loss" if k == "losses" else "grad_norm"]
            err = max(float(np.abs(np.array(r["holds"][key][k])
                                   - np.array(ref[k])).max())
                      for r in out)
            h[k] = out[0]["holds"][key][k]
            h[f"{k}_one_process"] = ref[k]
            h[f"{k}_max_abs_err"] = err
            check(err <= tol * max(1.0, max(abs(x) for x in ref[k])),
                  f"{label}: {key} {k} {h[k]} vs one process {ref[k]}")
            check(all(r["holds"][key][k] == h[k] for r in out),
                  f"{label}: {key} {k} differ between ranks")
        # the parameters before and after the steps and both moments
        # after them, each leaf's sample: within the limit of the
        # leaf's largest; each leaf's change within TOL_LM_MESH
        # ["change"] of the norm of one process's change, a limit the
        # state left unchanged must miss (the control)
        parts = ("before", "params", "m", "v")
        got = {part: lm_mesh_joined([r["holds"][key][part] for r in out])
               for part in parts}
        exp = {part: lm_mesh_joined([ref[part]]) for part in parts}
        spread = {part: lm_mesh_joined([floor[part]]) for part in parts} \
            if floor is not None else None
        rel, change, control, floors = {}, {}, {}, {}
        for part, tol in (("before", "param"), ("params", "param"),
                          ("m", "moment"), ("v", "moment")):
            check(set(got[part]) == set(exp[part]),
                  f"{label}: {key} {part} leaves differ")
            worst, w_err, w_over = None, -1.0, -1.0
            top = max(e_max for _, e_max, _ in exp[part].values())
            for p_, (vals, _, order) in got[part].items():
                e_vals, e_max, e_order = exp[part][p_]
                check(order == e_order, f"{label}: {key} {part} {p_}: "
                      f"the ranks' blocks do not cover the sample")
                noise = LM_MESH_NOISE in p_
                if noise and part == "params":
                    continue
                # a leaf that starts at 0 (ChatGLM3-6B's q and v biases)
                # is after the steps its own change, whose elements Adam
                # sets by sign(g) where |g| is near its rounding: held
                # against the part's largest leaf here, by its change's
                # norm below
                zero = part == "params" and exp["before"][p_][1] == 0
                scale = max(top if noise or zero else e_max, 1e-30)
                err = float(np.abs(vals - e_vals).max()) / scale
                limit = TOL_LM_MESH[tol]
                if spread is not None:
                    own = float(np.abs(spread[part][p_][0] - e_vals).max()) \
                        / scale
                    floors[(part, p_)] = own
                    limit = max(limit, LM_MESH_FLOOR_X * own)
                if err / limit > w_over:
                    worst, w_err, w_over = p_, err, err / limit
                if part == "params":
                    moved = np.linalg.norm(e_vals
                                           - exp["before"][p_][0])
                    check(moved > 0, f"{label}: {key} {p_} did not "
                          f"change in one process")
                    change[p_] = float(np.linalg.norm(vals - e_vals)
                                       / moved)
                    control[p_] = float(np.linalg.norm(
                        got["before"][p_][0] - e_vals) / moved)
            rel[part] = (worst, w_err, w_over)
            check(w_over <= 1, f"{label}: {key} {part} {worst} differs by "
                  f"{w_err} of its largest, {w_over} of its limit")
        c_worst = max(change, key=change.get)
        if floors:
            (fp, fl), fv = max(floors.items(), key=lambda kv: kv[1])
            h.update(floor_max_rel_err=fv, floor_worst=f"{fp} {fl}")
        h.update(param_max_rel_err=rel["params"][1],
                 param_worst_leaf=rel["params"][0],
                 param_over_limit=rel["params"][2],
                 param_leaves=len(change),
                 before_max_rel_err=rel["before"][1],
                 m_max_rel_err=rel["m"][1], v_max_rel_err=rel["v"][1],
                 change_max_rel_err=change[c_worst],
                 change_worst_leaf=c_worst,
                 control_min_rel_err=min(control.values()))
        check(change[c_worst] <= TOL_LM_MESH["change"], f"{label}: "
              f"{key} {c_worst}'s change differs by {change[c_worst]} "
              f"of its norm")
        check(h["control_min_rel_err"] > TOL_LM_MESH["change"],
              f"{label}: {key} the unchanged state passes the change "
              f"limit: {h['control_min_rel_err']}")
        name = key.split("/")[0]
        if f"{name}/train_no_kv_sum" in out[0]["holds"]:
            h["no_kv_sum"] = lm_mesh_no_kv_sum(np, out, name, exp)
    return h


def lm_mesh_phase(torch, np, dev, card):
    """The lm-mesh phase (module docstring, phase 10b). Returns (report,
    the flash launches of the bf16 runs by rank)."""
    import shutil

    from repro_torch.launch.mesh import run_on_mesh
    t_phase = time.perf_counter()
    rng = np.random.default_rng(34)
    holds = lm_mesh_holds()
    holds_tokens = [rng.integers(0, cfg.vocab, (LM_MESH_HOLD_B,
                                                LM_MESH_HOLD_SEQ))
                    for _, _, cfg, _, _ in holds]
    plan = lm_mesh_bf16_plan()
    root = ROOT / "build" / "lm_mesh_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    go, ranks = root / "go", {}
    card0 = f"cuda:{torch.cuda.current_device()}"

    def spawn():
        try:
            ranks["out"] = run_on_mesh(
                lm_mesh_rank, LM_MESH_RANKS, [card0] * LM_MESH_RANKS, "gloo",
                args=(str(go), holds_tokens, plan), timeout=1100.0,
                model=LM_MESH_SHAPE[1])
        except BaseException as e:      # raised again on the main thread
            ranks["error"] = e

    spawned = time.time()
    thread = threading.Thread(target=spawn, daemon=True)
    thread.start()
    rep = {"ranks": LM_MESH_RANKS, "mesh": list(LM_MESH_SHAPE),
           "hold_depths": LM_MESH_HOLD, "card": card}
    try:
        # the one-process references while the ranks start
        refs = {}
        for (name, kind, cfg, seed, shape), tokens in zip(holds,
                                                          holds_tokens):
            t0 = time.perf_counter()
            refs[f"{name}/{kind}"] = lm_mesh_hold_run(
                torch, np, dev, cfg, kind, seed, tokens)
            if shape == LM_MESH_HEADS_SHAPE and kind == "train":
                refs[f"{name}/{kind}/split"] = lm_mesh_hold_run(
                    torch, np, dev, cfg, kind, seed, tokens, split=True)
            gc_collect(torch)
            print(f"lm-mesh: one-process {name} {kind} "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        rep["parent_resident_gb"] = {
            "allocated": torch.cuda.memory_allocated() / 1e9,
            "reserved": torch.cuda.memory_reserved() / 1e9}
        go.touch()
        rep["go_s"] = time.time() - spawned
        thread.join()
        if "error" in ranks:
            raise ranks["error"]
        out = ranks["out"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep["ranks_timeline_s"] = {k: max(r["marks"][k] for r in out) - spawned
                               for k in out[0]["marks"]}
    rep["ranks_host_peak_gb"] = [r["host_peak_gb"] for r in out]
    # (a) the holds: every rank's logits block and losses, rank 0's leaves
    holds_rep = {}
    for (name, kind, cfg, _, shape), tokens in zip(holds, holds_tokens):
        key = f"{name}/{kind}"
        h = {"layers": cfg.n_layers, "d_ff": cfg.d_ff,
             "batch": list(tokens.shape), "mesh": list(shape)}
        h.update(lm_mesh_hold_check(np, key, kind, out, refs[key],
                                    shape[0], floor=refs.get(f"{key}/split")))
        holds_rep[key] = h
    rep["holds"] = holds_rep
    # (b) the bf16 runs: the slowest rank's seconds, each rank's peak
    want = lm_mesh_expected_launches(plan)
    runs = {}
    for run in plan:
        key = f"{run['name']}/{run['kind']}"
        rs = [r["bf16"][key] for r in out]
        x = {k: rs[0][k] for k in ("mesh", "init_s", "param_gb")}
        x.update(layers=run["layers"], batch=run["batch"], seq=run["seq"],
                 peak_gb_by_rank=[r["peak_gb"] for r in rs])
        check(all(r["finite"] for r in rs), f"lm-mesh: {key} not finite")
        if run["kind"] == "prefill":
            x["s"] = max(r["s"] for r in rs)
            x["tokens_per_s"] = run["batch"] * run["seq"] / x["s"]
            x["logits_shape"] = rs[0]["logits_shape"]
        elif run["kind"] == "decode":
            x["step_s"] = [max(r["step_s"][i] for r in rs)
                           for i in range(LM_MESH_DECODE_STEPS)]
            x["ms_per_step"] = 1e3 * float(np.mean(x["step_s"]))
            x["tokens_per_s"] = run["batch"] / (x["ms_per_step"] / 1e3)
            x["cache_gb_by_rank"] = rs[0]["cache_gb"]
            x["logits_shape"] = rs[0]["logits_shape"]
        else:
            x["s"] = max(r["s"] for r in rs)
            x["tokens_per_s"] = run["batch"] * run["seq"] / x["s"]
            x["losses"] = rs[0]["losses"]
            x["grad_norm"] = rs[0]["grad_norm"]
            x["state_gb_by_rank"] = rs[0]["state_gb"]
        check(max(x["peak_gb_by_rank"]) * LM_MESH_RANKS < 80.0,
              f"lm-mesh: {key} ranks' peaks {x['peak_gb_by_rank']}")
        runs[key] = x
    rep["bf16"] = runs
    # each bf16 run's first flash calls, held to plain in the ranks at the
    # run's shapes: the worst over the ranks, and their launches apart
    flash_holds, want_held = {}, {k: 0 for k in FLASH_KERNELS}
    for run in plan:
        key = f"{run['name']}/{run['kind']}"
        calls = {"prefill": ["flash_attention_cuda"], "decode": [],
                 "train": ["flash_attention_bwd_cuda",
                           "flash_attention_cuda"]}[run["kind"]]
        for r in out:
            check(r["flash_captured"][key] == calls, f"lm-mesh: {key} rank "
                  f"{r['rank']} captured {r['flash_captured'][key]}, "
                  f"expected {calls}")
        if not calls:
            continue
        hs = [r["flash_holds"][key] for r in out]
        x = {}
        if "fwd" in hs[0]:
            want_held["flash_attention_wgmma"] += 1
            wins = [h["fwd"][w] for h in hs for w in ("first", "middle",
                                                      "last")]
            x["fwd"] = {"shape": hs[0]["fwd"]["shape"],
                        "o": max(e["o"] for e in wins),
                        "lse": max(e["lse"] for e in wins),
                        "o_over_limit": max(e["o_over_limit"] for e in wins),
                        "control_o_over_limit": min(
                            e["control_o_over_limit"] for e in wins)}
        if "bwd" in hs[0]:
            for k in ("flash_attention_bwd_dq_wgmma",
                      "flash_attention_bwd_dkv_wgmma"):
                want_held[k] += 1
            x["bwd"] = {"shape": hs[0]["bwd"]["shape"],
                        "do_rms_by_rank": [h["bwd"]["do_rms"] for h in hs]}
            for g_ in ("dq", "dk", "dv"):
                for n in ("", "_f32_over_limit", "_over_limit"):
                    x["bwd"][g_ + n] = max(h["bwd"][g_ + n] for h in hs)
                for n in ("_control_f32_over_limit", "_control_over_limit"):
                    x["bwd"][g_ + n] = min(h["bwd"][g_ + n] for h in hs)
        flash_holds[key] = x
    rep["flash_holds"] = flash_holds
    held = [{k: r["flash_hold_launches"][k] for k in FLASH_KERNELS}
            for r in out]
    rep["flash_hold_launches_by_rank"] = held
    for r, c in zip(out, held):
        check(c == want_held, f"lm-mesh: rank {r['rank']}'s flash holds "
              f"launched {c}, expected {want_held}")
    launches = [{k: r["launches"][k] for k in FLASH_KERNELS} for r in out]
    rep["launches_by_rank"] = launches
    rep["hold_launches_by_rank"] = [
        {k: r["hold_launches"][k] for k in FLASH_KERNELS if
         r["hold_launches"][k]} for r in out]
    for r, c in zip(out, launches):
        check(c == want, f"lm-mesh: rank {r['rank']} launched {c}, "
              f"expected {want}")
    rep["seconds"] = time.perf_counter() - t_phase
    print("lm-mesh: " + json.dumps(rep), flush=True)
    print(f"lm-mesh: {rep['seconds']:.1f} s", flush=True)
    return rep, launches, held


def rs_mesh_batch(np, cfg, kind: str, device):
    """A recsys-mesh run's batch for ``kind``, the same in every process
    (``recsys_synth`` from a seed of its own): serve_p99's B=512, the bulk
    cut's RS_MESH_BULK_B, retrieval's one query, the train hold's
    RS_MESH_TRAIN_B (CTR) or RS_MESH_B4R_MICRO microbatches of 4,096
    (BERT4Rec); the label and BERT4Rec's Cloze keys only to train."""
    from repro_torch.configs import recsys_family as rf
    from repro_torch.data import recsys_synth
    rng = np.random.default_rng(
        [RS_MESH_SEED, ("serve", "bulk", "retrieval", "train").index(kind)])
    if isinstance(cfg, rf.ctr.CTRConfig):
        B = {"serve": rf.RS_SHAPES["serve_p99"]["batch"], "retrieval": 1,
             "train": RS_MESH_TRAIN_B}[kind]
        b = recsys_synth.ctr_batch(
            rng, batch=B, n_dense=cfg.n_dense,
            vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz,
            device=device)
        return b if kind == "train" else {k: v for k, v in b.items()
                                          if k != "label"}
    micro = rf.RS_SHAPES["train_batch"]["batch"] // rf.B4R_ONE_CARD_ACCUM
    B = {"serve": rf.RS_SHAPES["serve_p99"]["batch"], "bulk": RS_MESH_BULK_B,
         "retrieval": 1, "train": RS_MESH_B4R_MICRO * micro}[kind]
    b = recsys_synth.bert4rec_batch(
        rng, batch=B, seq_len=cfg.seq_len, n_items=cfg.n_items,
        n_mask=cfg.n_mask, n_neg=cfg.n_neg, mask_token=cfg.mask_token,
        device=device)
    return b if kind == "train" else {"tokens": b["tokens"]}


def rs_mesh_cand(torch, np, cfg, device):
    """retrieval_cand's 10^6 candidates, the same in every process: CTR
    [N, ctr_repr_dim] N(0, 1) from a generator on the card, BERT4Rec item
    ids [N] int32 over the catalogue."""
    from repro_torch.configs import recsys_family as rf
    n = rf.RS_SHAPES["retrieval_cand"]["n_cand"]
    if isinstance(cfg, rf.ctr.CTRConfig):
        return torch.randn((n, rf.ctr_repr_dim(cfg)), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(RS_MESH_SEED))
    return torch.as_tensor(rs_mesh_cand_ids(np, cfg, n), device=device)


def rs_mesh_cand_ids(np, cfg, n: int):
    """BERT4Rec's n candidate item ids, int32 over the catalogue (with
    repeats, as any id list may have them)."""
    rng = np.random.default_rng(RS_MESH_SEED)
    return rng.integers(0, cfg.n_items, n).astype(np.int32)


def rs_mesh_touched(np, cfg, batch):
    """Up to RS_MESH_ROWS of the table rows a train batch names (the CTR
    tables' rows of the offset indices, BERT4Rec's items of the tokens,
    labels and negatives), evenly spaced in the sorted set: the rows a
    train hold reads in each table leaf (the others do not move)."""
    from repro_torch.configs import recsys_family as rf
    if isinstance(cfg, rf.ctr.CTRConfig):
        off = np.concatenate([[0], np.cumsum(cfg.sparse.vocab_sizes[:-1])])
        ids = batch["sparse_idx"].cpu().numpy() + off[None, :, None]
    else:
        ids = np.concatenate([batch[k].cpu().numpy().ravel()
                              for k in ("tokens", "labels", "neg")])
    rows = np.unique(ids)
    pick = np.unique(np.linspace(0, len(rows) - 1, min(len(rows),
                                                       RS_MESH_ROWS))
                     .round().astype(np.int64))
    return rows[pick].astype(np.int64)


def rs_mesh_run(torch, np, dev, run, mesh=None):
    """One run of RS_MESH_PLAN, (name, (data, model), kinds), on ``mesh``
    (in a rank: its blocks, drawn one rank at a time) or in one process
    (the reference: the same draws, batches and candidates). Returns host
    results: serve's logits (CTR) or top-100 (BERT4Rec) of this rank's
    batch block, retrieval's top-100, the bulk cut's first
    RS_MESH_BULK_HELD rows of each data block (one process: serve on
    those rows alone) and its shape, range and order checks, the train
    hold's losses, grad norms and reads (``lm_mesh_read`` at the touched
    rows of each table leaf): the parameters before and after 2 steps,
    the first step's gradient as Adam receives it, both moments after;
    and each kind's seconds (one call or step, between barriers; serve
    and retrieval after a warm-up call, the train hold's second step) and
    peak memory."""
    from repro_torch.configs import recsys_family as rf
    from repro_torch.distributed.collectives import barrier
    from repro_torch.models.recsys import bert4rec
    name, _, kinds = run
    cfg = rf.CONFIGS[name]
    gen = torch.Generator(device=dev).manual_seed(
        RS_MESH_SEED + sorted(rf.CONFIGS).index(name))
    if mesh is None:
        params = rf._init(cfg)(gen, cfg)
    else:
        # one rank at a time: a rank draws the whole table before it keeps
        # its block (8.37 GB of DLRM-RM2's)
        for turn in range(mesh.world):
            if turn == mesh.rank:
                params = rf.init_placed(gen, cfg, mesh)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            barrier(mesh)
    out = {"s": {}, "peak_gb": {}}

    def timed(fn):
        if mesh is not None:
            barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        if mesh is not None:
            barrier(mesh)
        return r, time.perf_counter() - t0

    def host(r):
        return tuple(t.cpu().numpy() for t in r) if isinstance(r, tuple) \
            else r.cpu().numpy()

    for kind in kinds:
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        b = rs_mesh_batch(np, cfg, kind, dev)
        if kind in ("serve", "retrieval"):
            args = (b,) if kind == "serve" else (b, rs_mesh_cand(
                torch, np, cfg, dev))
            fn = rf.make_fn(cfg, kind, device=dev, mesh=mesh)
            fn(params, *args)                                  # warm-up
            r, out["s"][kind] = timed(lambda: fn(params, *args))
            out[kind] = host(r)
            del args
        elif kind == "bulk":
            D, n = run[1][0], RS_MESH_BULK_B // run[1][0]
            held = np.concatenate([np.arange(i * n, i * n + RS_MESH_BULK_HELD)
                                   for i in range(D)])
            if mesh is None:
                out[kind] = host(bert4rec.serve(params, cfg, {
                    "tokens": b["tokens"][torch.as_tensor(held, device=dev)]},
                    k=100))
            else:
                fn = rf.make_fn(cfg, "serve", device=dev, mesh=mesh)
                (v, i), out["s"][kind] = timed(lambda: fn(params, b))
                out[kind] = (v[:RS_MESH_BULK_HELD].cpu().numpy(),
                             i[:RS_MESH_BULK_HELD].cpu().numpy())
                out["bulk_check"] = {
                    "shape": list(v.shape),
                    "finite": bool(torch.isfinite(v).all()),
                    "ids_in_catalogue": bool(((i >= 0) & (i < cfg.n_items))
                                             .all()),
                    "descending": bool((v[:, 1:] <= v[:, :-1]).all())}
        else:
            out[kind] = rs_mesh_train(torch, np, dev, cfg, params, b, mesh,
                                      timed)
            out["s"][kind] = out[kind].pop("s")
            params = out[kind].pop("params_live")
        out["peak_gb"][kind] = torch.cuda.max_memory_allocated() / 1e9
        del b
    del params
    gc_collect(torch)
    return out


def rs_mesh_train(torch, np, dev, cfg, params, batch, mesh, timed):
    """The train hold of ``rs_mesh_run``: 2 steps (``make_fn(cfg,
    "train")``; BERT4Rec's through ``optim.make_train_step`` with
    ``accum_steps`` RS_MESH_B4R_MICRO), the first step's gradient read
    where Adam receives it (after ``sync_grads``, before the clip), the
    parameters and both moments after it, the parameters after the
    second step, the second step timed. Each read's values a part, the
    positions once (``pos``): every part reads a leaf at the same ones."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import recsys_family as rf
    from repro_torch.models.recsys import bert4rec
    from repro_torch.models.recsys import parallel as rp
    specs = None if mesh is None else rp.specs_by_path(params, mesh)
    rows = rs_mesh_touched(np, cfg, batch)
    tables = {p: rows for p, _ in optim.adam.leaves(params)
              if p.endswith(("fused", "item_emb/table"))}

    def read(tree):
        return lm_mesh_read(torch, np, tree, specs, mesh, tables)

    if isinstance(cfg, rf.ctr.CTRConfig):
        step = rf.make_fn(cfg, "train", device=dev, mesh=mesh)
    else:
        step = optim.make_train_step(
            lambda p, b: bert4rec.loss(p, cfg, b, mesh=mesh),
            dataclasses.replace(rf.RS_OPT, accum_steps=RS_MESH_B4R_MICRO),
            mesh=mesh, specs=None if mesh is None else (
                lambda p: rp.specs_by_path(p, mesh)))
    out = {"before": read(params), "losses": [], "grad_norms": [],
           "rows": len(rows)}
    opt = optim.adam_init(params)
    real = optim.adam.adam_update

    def spy(p, g, *a, **k):
        first = "grad" not in out
        if first:
            out["grad"] = read(g)
        r = real(p, g, *a, **k)
        if first:
            out["step1"] = read(r[0])
            out["m1"], out["v1"] = read(r[1]["m"]), read(r[1]["v"])
        return r

    optim.adam.adam_update = spy
    try:
        for i in range(2):
            r, s = timed(lambda: step(params, opt, batch))
            params, opt, m = r
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
    finally:
        optim.adam.adam_update = real
    out["s"] = s
    out["params"] = read(params)
    out["pos"] = {p: r[0] for p, r in out["before"].items()}
    for part in ("before", "step1", "grad", "m1", "v1", "params"):
        out[part] = {p: r[1:] for p, r in out[part].items()}
    out["params_live"] = params
    return out


def spy_ebag_to_host(torch, captured: dict):
    """Spies on the EmbeddingBag pair's wrappers as ``kernels/ops.py``
    calls them (``embedding_bag_cuda``, ``embedding_bag_bwd_cuda``): each
    keeps a host copy of the inputs of its wrapper's first call in
    ``captured``, by the wrapper's name. Returns the function that takes
    the spies off."""
    from repro_torch.kernels import embedding_bag as eb
    saved = {a: getattr(eb, a) for a in ("embedding_bag_cuda",
                                          "embedding_bag_bwd_cuda")}

    def spy_of(attr, fn):
        def spy(*args):
            if attr not in captured:
                captured[attr] = [a.detach().cpu() if isinstance(
                    a, torch.Tensor) else a for a in args]
            return fn(*args)
        return spy

    for attr, fn in saved.items():
        setattr(eb, attr, spy_of(attr, fn))
    return lambda: [setattr(eb, a, fn) for a, fn in saved.items()]


def rs_mesh_rank(mesh, go, plan):
    """One rank of the recsys-mesh phase (``run_on_mesh``; imports in
    here, as a spawned process starts bare), once the file ``go`` exists:
    every run of ``plan`` (RS_MESH_PLAN; ``rs_mesh_run``; a (1, 4) run on
    the world re-cut by ``submesh``) with the launch counts set to 0 just
    before and read just after, the EmbeddingBag pair's first calls kept
    on the host; then, one rank at a time, those calls held to plain at
    the rank's shapes (``registry_hold``: 1e-6 forward, 1e-5 backward,
    each beside a control that must miss), their launches apart."""
    import numpy as np
    import torch
    from repro_torch.distributed.collectives import barrier
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import submesh
    marks = {"entered": time.time()}
    go, waited = pathlib.Path(go), time.time()
    while not go.exists():
        if time.time() - waited > 900:
            raise TimeoutError(f"rank {mesh.rank}: no {go} in 900 s")
        time.sleep(0.05)
    marks["go"] = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    if dev.type != "cuda":
        raise RuntimeError(f"recsys-mesh rank {mesh.rank} is on {dev}")
    out = {"rank": mesh.rank, "marks": marks, "runs": [], "index": {}}
    meshes = {RS_MESH_SHAPE: mesh}
    captured = {}
    restore = spy_ebag_to_host(torch, captured)
    ops.reset_launch_counts()
    try:
        for run in plan:
            shape = tuple(run[1])
            if shape not in meshes:
                meshes[shape] = submesh(mesh, data=shape[0], model=shape[1])
            m = meshes[shape]
            r = rs_mesh_run(torch, np, dev, run, m)
            r["index"] = {a: m.index(a) for a in ("data", "model")}
            out["runs"].append(r)
            if mesh.rank == 0:
                print(f"recsys-mesh: rank 0 ran {run[0]} {run[1]} {run[2]} "
                      f"at {time.time() - marks['go']:.1f} s after go: "
                      f"{r['s']}", flush=True)
        torch.cuda.synchronize()
        out["launches"] = ops.launch_counts()
    finally:
        restore()
    marks["ran"] = time.time()
    ops.reset_launch_counts()
    out["ebag_holds"] = {}
    for turn in range(mesh.world):
        if turn == mesh.rank:
            for attr, args in captured.items():
                out["ebag_holds"][attr] = registry_hold(torch, attr, [
                    a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in args])
            gc_collect(torch)
        barrier(mesh)
    torch.cuda.synchronize()
    out["ebag_hold_launches"] = ops.launch_counts()
    import resource
    out["host_peak_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    marks["held"] = time.time()
    return out


def rs_mesh_expected_launches(plan) -> dict:
    """The EmbeddingBag launches a rank makes over ``plan``: a CTR
    forward one a table (Wide&Deep's two), two forwards a serve and a
    retrieval (the warm-up and the timed call; retrieval reads the fused
    table only), two steps a train hold, each one forward and one
    backward a table; BERT4Rec none."""
    from repro_torch.configs import recsys_family as rf
    want = {"embedding_bag": 0, "embedding_bag_bwd": 0}
    for name, _, kinds in plan:
        cfg = rf.CONFIGS[name]
        if not isinstance(cfg, rf.ctr.CTRConfig):
            continue
        t = 1 + cfg.wide
        want["embedding_bag"] += 2 * t * (("serve" in kinds)
                                          + ("train" in kinds)) \
            + 2 * ("retrieval" in kinds)
        want["embedding_bag_bwd"] += 2 * t * ("train" in kinds)
    return want


def rs_mesh_same_topk(np, vals, ids, e_vals, e_ids, tol) -> float:
    """The scores' error over the largest (``inf`` if an id differs):
    ids equal where the scores are apart, as sets over each run of scores
    tied within ``tol`` of the largest (``torch.topk`` orders a tie its
    own way)."""
    big = float(np.abs(e_vals).max())
    err = float(np.abs(vals - e_vals).max()) / big
    limit = tol * big
    for r in range(e_ids.shape[0]):
        start = 0
        for c in range(1, e_ids.shape[1] + 1):
            if c == e_ids.shape[1] or e_vals[r, c - 1] - e_vals[r, c] > limit:
                if set(ids[r, start:c].tolist()) != set(
                        e_ids[r, start:c].tolist()):
                    return float("inf")
                start = c
    return err


def rs_mesh_train_holds(np, key, got: list, ref: dict) -> dict:
    """A train hold's checks, each rank against one process (module
    docstring, phase 12b): the 2 steps' losses; every leaf's read at the
    first step (the parameters before and after it, its gradient as Adam
    gets it, both moments after it) at the rank's positions within
    TOL_RS_MESH["leaf"] of one process's largest (the key biases'
    gradient and moments of the largest leaf's, their parameters not
    held; the parameters of a leaf that starts at 0, whose largest is a
    step of lr, of the largest leaf's); the ranks' positions covering
    one process's; each leaf's change over the 2 steps within
    TOL_RS_MESH["change"] of the norm of one process's change over the
    rank's positions, a limit the unchanged state must miss. The
    parameters after the second step are read against one process's
    largest, not held element by element: the second step's forward runs
    on parameters whose first Adam step (lr times the gradient over its
    own RMS) differs where a gradient element is near 0, so a
    second-step gradient element that is a sum cancelling over the batch
    moves by a share of itself (``PERF.md``, the recsys model axis)."""
    h = {"losses": got[0]["losses"], "losses_one_process": ref["losses"],
         "grad_norms": got[0]["grad_norms"],
         "grad_norms_one_process": ref["grad_norms"], "rows": ref["rows"]}
    h["loss_max_abs_err"] = max(abs(a - b) for g in got for a, b in zip(
        g["losses"], ref["losses"]))
    check(h["loss_max_abs_err"] <= TOL_RS_MESH["loss"], f"recsys-mesh: "
          f"{key} losses {h['losses']} vs one process {ref['losses']}")
    worst, change, control = {}, {}, {}
    zero = [p for p, e in ref["before"].items() if e[1] == 0]
    h["params_of_the_largest_leaf"] = zero
    held = ("before", "step1", "grad", "m1", "v1")
    for part in held + ("params",):
        top = max(e[1] for e in ref[part].values())
        w_path, w_err = None, -1.0
        for path, (e_vals, e_max) in ref[part].items():
            e_pos = ref["pos"][path]
            if RS_MESH_NOISE in path and part in ("before", "step1",
                                                  "params"):
                continue
            scale = top if RS_MESH_NOISE in path or (
                part == "step1" and path in zero) else max(e_max, 1e-30)
            seen = []
            for g in got:
                pos, vals = g["pos"][path], g[part][path][0]
                at = np.searchsorted(e_pos, pos)
                check(bool((at < len(e_pos)).all()) and np.array_equal(
                    e_pos[np.minimum(at, len(e_pos) - 1)], pos),
                      f"recsys-mesh: {key} {part} {path}: a rank read a "
                      f"position one process did not")
                seen.append(at)
                err = float(np.abs(vals - e_vals[at]).max()) / scale \
                    if len(pos) else 0.0
                if err > w_err:
                    w_path, w_err = path, err
                if part == "params" and len(pos):
                    b_vals = ref["before"][path][0][at]
                    moved = float(np.linalg.norm(e_vals[at] - b_vals))
                    check(moved > 0, f"recsys-mesh: {key} {path} did not "
                          f"change in one process at a rank's positions")
                    change[path] = max(change.get(path, 0.0), float(
                        np.linalg.norm(vals - e_vals[at]) / moved))
                    control[path] = min(control.get(path, np.inf), float(
                        np.linalg.norm(g["before"][path][0] - e_vals[at])
                        / moved))
            check(np.unique(np.concatenate(seen)).size == len(e_pos),
                  f"recsys-mesh: {key} {part} {path}: the ranks' blocks do "
                  f"not cover the read")
        worst[part] = (w_path, w_err)
        check(part not in held or w_err <= TOL_RS_MESH["leaf"],
              f"recsys-mesh: {key} {part} {w_path} differs by {w_err} of "
              f"its largest")
    c_worst = max(change, key=change.get)
    h.update({f"{part}_max_rel_err": e for part, (_, e) in worst.items()})
    h.update({f"{part}_worst_leaf": w[0] for part, w in worst.items()})
    h.update(leaves=len(change),
             change_max_rel_err=change[c_worst], change_worst_leaf=c_worst,
             control_min_rel_err=min(control.values()))
    check(change[c_worst] <= TOL_RS_MESH["change"], f"recsys-mesh: {key} "
          f"{c_worst}'s change differs by {change[c_worst]} of its norm")
    check(h["control_min_rel_err"] > TOL_RS_MESH["change"], f"recsys-mesh: "
          f"{key} the unchanged state passes the change limit")
    return h


def recsys_mesh_phase(torch, np, dev, card, plan=RS_MESH_PLAN):
    """The recsys-mesh phase (module docstring, phase 12b) over ``plan``.
    Returns (report, the EmbeddingBag launches of the runs by rank, the
    holds' launches by rank)."""
    import shutil

    from repro_torch.configs import recsys_family as rf
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import run_on_mesh
    t_phase = time.perf_counter()
    root = ROOT / "build" / "recsys_mesh_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    go, ranks = root / "go", {}
    card0 = f"cuda:{torch.cuda.current_device()}"

    def spawn():
        try:
            ranks["out"] = run_on_mesh(
                rs_mesh_rank, RS_MESH_RANKS, [card0] * RS_MESH_RANKS, "gloo",
                args=(str(go), plan), timeout=1100.0,
                model=RS_MESH_SHAPE[1])
        except BaseException as e:      # raised again on the main thread
            ranks["error"] = e

    spawned = time.time()
    thread = threading.Thread(target=spawn, daemon=True)
    thread.start()
    rep = {"ranks": RS_MESH_RANKS, "card": card, "tol": TOL_RS_MESH,
           "train_batch_ctr": RS_MESH_TRAIN_B,
           "train_batch_bert4rec": [RS_MESH_B4R_MICRO, rf.RS_SHAPES[
               "train_batch"]["batch"] // rf.B4R_ONE_CARD_ACCUM],
           "bulk_batch_bert4rec": RS_MESH_BULK_B}
    try:
        # the one-process references while the ranks start
        refs = []
        for run in plan:
            t0 = time.perf_counter()
            refs.append(rs_mesh_run(torch, np, dev, run))
            print(f"recsys-mesh: one-process {run[0]} {run[2]} "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        gc_collect(torch)
        ops.reset_launch_counts()
        rep["parent_resident_gb"] = {
            "allocated": torch.cuda.memory_allocated() / 1e9,
            "reserved": torch.cuda.memory_reserved() / 1e9}
        go.touch()
        rep["go_s"] = time.time() - spawned
        thread.join()
        if "error" in ranks:
            raise ranks["error"]
        out = ranks["out"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep["ranks_timeline_s"] = {k: max(r["marks"][k] for r in out) - spawned
                               for k in out[0]["marks"]}
    rep["ranks_host_peak_gb"] = [r["host_peak_gb"] for r in out]
    runs = []
    for n, (run, ref) in enumerate(zip(plan, refs)):
        name, shape, kinds = run
        key = f"{name} {shape[0]}x{shape[1]}"
        got = [r["runs"][n] for r in out]
        x = {"config": name, "mesh": list(shape),
             "s": {k: max(g["s"][k] for g in got) for k in got[0]["s"]},
             "peak_gb_by_rank": {k: [g["peak_gb"][k] for g in got]
                                 for k in kinds}}
        for k in kinds:
            check(max(x["peak_gb_by_rank"][k]) * RS_MESH_RANKS < 80.0,
                  f"recsys-mesh: {key} {k} peaks {x['peak_gb_by_rank'][k]}")
        D = shape[0]
        if "serve" in kinds:
            err = 0.0
            for g in got:
                i = g["index"]["data"]
                if name == "bert4rec":
                    (v, ids), (ev, eids) = g["serve"], ref["serve"]
                    n_ = len(ev) // D
                    err = max(err, rs_mesh_same_topk(
                        np, v, ids, ev[i * n_:(i + 1) * n_],
                        eids[i * n_:(i + 1) * n_], TOL_RS_MESH["scores"]))
                else:
                    e = ref["serve"]
                    n_ = len(e) // D
                    exp = e[i * n_:(i + 1) * n_]
                    check(g["serve"].shape == exp.shape, f"recsys-mesh: {key}"
                          f" serve shape {g['serve'].shape}")
                    err = max(err, float(np.abs(g["serve"] - exp).max())
                              / float(np.abs(e).max()))
            tol = TOL_RS_MESH["scores" if name == "bert4rec" else "logits"]
            x["serve_max_rel_err"] = err
            check(err <= tol, f"recsys-mesh: {key} serve differs by {err} "
                  f"of the largest (ids differ where inf)")
        if "retrieval" in kinds:
            # BERT4Rec's winners as items: a repeated candidate id ties
            # with itself, and either package may return either position
            items = (rs_mesh_cand_ids(np, rf.CONFIGS[name], rf.RS_SHAPES[
                "retrieval_cand"]["n_cand"]) if name == "bert4rec" else None)

            def as_items(v, i):
                return (v, i) if items is None else (v, items[i])

            x["retrieval_max_rel_err"] = max(rs_mesh_same_topk(
                np, *as_items(*g["retrieval"]), *as_items(*ref["retrieval"]),
                TOL_RS_MESH["scores"]) for g in got)
            check(x["retrieval_max_rel_err"] <= TOL_RS_MESH["scores"],
                  f"recsys-mesh: {key} retrieval differs: "
                  f"{x['retrieval_max_rel_err']}")
        if "bulk" in kinds:
            err = 0.0
            H = RS_MESH_BULK_HELD
            for g in got:
                c = g["bulk_check"]
                check(c["shape"] == [RS_MESH_BULK_B // D, 100] and c["finite"]
                      and c["ids_in_catalogue"] and c["descending"],
                      f"recsys-mesh: {key} bulk {c}")
                i = g["index"]["data"]
                ev, eids = (a[i * H:(i + 1) * H] for a in ref["bulk"])
                err = max(err, rs_mesh_same_topk(np, *g["bulk"], ev, eids,
                                                 TOL_RS_MESH["scores"]))
            x["bulk_held_max_rel_err"] = err
            x["bulk_check"] = got[0]["bulk_check"]
            # the [B, n_items] scores a one-process serve would hold
            x["bulk_full_scores_gb"] = RS_MESH_BULK_B * rf.CONFIGS[
                name].n_items * 4 / 1e9
            check(err <= TOL_RS_MESH["scores"], f"recsys-mesh: {key} bulk's "
                  f"held rows differ from one process: {err}")
        if "train" in kinds:
            x["train"] = rs_mesh_train_holds(
                np, key, [g["train"] for g in got], ref["train"])
        runs.append(x)
    rep["runs"] = runs
    want = rs_mesh_expected_launches(plan)
    launches = [{k: r["launches"][k] for k in want} for r in out]
    rep["launches_by_rank"] = launches
    for r, c in zip(out, launches):
        check(c == want, f"recsys-mesh: rank {r['rank']} launched {c}, "
              f"expected {want}")
        other = {k: n for k, n in r["launches"].items() if n and k not in want}
        check(not other, f"recsys-mesh: rank {r['rank']} launched {other}")
    held = [{k: r["ebag_hold_launches"][k] for k in want} for r in out]
    rep["hold_launches_by_rank"] = held
    holds = {}
    for attr in ("embedding_bag_cuda", "embedding_bag_bwd_cuda"):
        hs = [r["ebag_holds"][attr] for r in out]
        holds[attr] = {"shapes_by_rank": [h["shapes"] for h in hs],
                       "tol": hs[0]["tol"],
                       "max_abs_err": max(h["max_abs_err"] for h in hs),
                       "rel_err": max(h["rel_err"] for h in hs),
                       "control_rel_err": min(h["control_rel_err"]
                                              for h in hs)}
    rep["ebag_holds"] = holds
    for r, c in zip(out, held):
        check(c == {"embedding_bag": 1, "embedding_bag_bwd": 1},
              f"recsys-mesh: rank {r['rank']}'s holds launched {c}")
    rep["seconds"] = time.perf_counter() - t_phase
    print("recsys-mesh: " + json.dumps(rep), flush=True)
    print(f"recsys-mesh: {rep['seconds']:.1f} s", flush=True)
    return rep, launches, held


def gnn_mesh_f64(torch, cfg, batch, params):
    """(the f64 config, the batch's floating arrays in f64, the
    parameters in f64)."""
    import dataclasses
    from repro_torch.optim.adam import leaves, unflatten
    return (dataclasses.replace(cfg, dtype="float64"),
            {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()},
            unflatten(params, [t.double() for _, t in leaves(params)]))


def gnn_mesh_grads(torch, cfg, ng, params, batch):
    """(the loss, each gradient leaf) of ``params`` on one process."""
    from repro_torch.models.gnn import dimenet
    from repro_torch.optim.adam import leaves, unflatten
    p = unflatten(params, [t.clone() for _, t in leaves(params)])
    flat = [t.requires_grad_() for _, t in leaves(p)]
    loss, _ = dimenet.loss(p, cfg, batch, n_graphs=ng)
    g = torch.autograd.grad(loss, flat)
    return float(loss.detach()), [t.detach() for t in g]


def gnn_mesh_steps(torch, cfg, ng, params, batch, mesh=None, sync=None,
                   grads: bool = False):
    """GNN_MESH_STEPS steps of ``gnn_family.make_fn(cfg, "train",
    mesh=)`` from a copy of ``params``: (losses, the parameters after,
    each step's seconds, timed after ``sync()`` on both sides, and with
    ``grads`` the first step's gradient leaves where Adam receives them:
    after the mesh's sum, before the clip; else None)."""
    from repro_torch import optim
    from repro_torch.configs import gnn_family as gf
    from repro_torch.optim.adam import leaves, unflatten
    p = unflatten(params, [t.clone() for _, t in leaves(params)])
    opt, step = optim.adam_init(p), gf.make_fn(cfg, "train", n_graphs=ng,
                                               mesh=mesh)
    losses, secs, first = [], [], []
    real = optim.adam.adam_update

    def spy(p_, g, *a, **k):
        if not first:
            first.append([t.detach().clone() for _, t in leaves(g)])
        return real(p_, g, *a, **k)

    if grads:
        optim.adam.adam_update = spy
    try:
        for _ in range(GNN_MESH_STEPS):
            if sync:
                sync()
            t0 = time.perf_counter()
            p, opt, m = step(p, opt, batch)
            if sync:
                sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
    finally:
        optim.adam.adam_update = real
    return (losses, [t.detach() for _, t in leaves(p)], secs,
            first[0] if first else None)


def gnn_mesh_rank(mesh, go, root):
    """One rank of the gnn-mesh phase (``run_on_mesh``; imports in here,
    as a spawned process starts bare), once the file ``go`` exists: for
    each mesh of GNN_MESH_SHAPES (the world re-cut by ``submesh``) the
    f64 hold (``gnn_mesh_hold``), then GNN_MESH_STEPS f32 steps of
    ``gnn_family.make_fn(mesh=)``, each timed between barriers; the
    launch counts set to 0 before and read after. Rank 0 returns the
    hold's arrays, every rank a digest of each."""
    import torch
    from repro_torch.configs import gnn_family as gf
    from repro_torch.distributed.collectives import barrier
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import submesh
    marks = {"entered": time.time()}
    go, root, waited = pathlib.Path(go), pathlib.Path(root), time.time()
    while not go.exists():
        if time.time() - waited > 900:
            raise TimeoutError(f"rank {mesh.rank}: no {go} in 900 s")
        time.sleep(0.05)
    marks["go"] = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    if dev.type != "cuda":
        raise RuntimeError(f"gnn-mesh rank {mesh.rank} is on {dev}")
    batch = {k: v.to(dev) for k, v in torch.load(root / "batch.pt").items()}
    params = tree_to(torch.load(root / "params.pt"), dev)
    cfg = gf.cell_config(GNN_MESH_CELL)
    ng = gf.GNN_SHAPES[GNN_MESH_CELL].get("n_graphs", 1)
    cfg64, batch64, params64 = gnn_mesh_f64(torch, cfg, batch, params)

    def host(ts):
        """(rank 0's arrays, None on the others; every rank's digests)."""
        return ([t.cpu().numpy() for t in ts] if mesh.rank == 0 else None,
                [float(t.double().sum()) for t in ts])

    out = {"rank": mesh.rank, "marks": marks, "runs": {}}
    ops.reset_launch_counts()
    for shape in GNN_MESH_SHAPES:
        m = submesh(mesh, data=shape[0], model=shape[1])
        losses, after, _, g = gnn_mesh_steps(torch, cfg64, ng, params64,
                                             batch64, m, grads=True)
        r = {"loss": losses[0], "losses": losses}
        r["grads"], r["grad_digests"] = host(g)
        r["params"], r["param_digests"] = host(after)
        del g, after
        gc_collect(torch)

        def sync():
            torch.cuda.synchronize()
            barrier(m)

        # f32, as the cell runs, each step timed between barriers
        torch.cuda.reset_peak_memory_stats(dev)
        r["f32_losses"], _, r["s"], _ = gnn_mesh_steps(
            torch, cfg, ng, params, batch, m, sync)
        r["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["runs"][f"{shape[0]}x{shape[1]}"] = r
        gc_collect(torch)
        if mesh.rank == 0:
            print(f"gnn-mesh: rank 0 ran {shape} at "
                  f"{time.time() - marks['go']:.1f} s after go: {r['s']}",
                  flush=True)
    torch.cuda.synchronize()
    out["launches"] = {k: n for k, n in ops.launch_counts().items() if n}
    marks["ran"] = time.time()
    return out


def gnn_mesh_phase(torch, np, dev, card):
    """The gnn-mesh phase (module docstring, phase 12c). Returns the
    report."""
    import shutil

    from repro_torch.configs import gnn_family as gf
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models.gnn import dimenet
    from repro_torch.optim.adam import leaves
    t_phase = time.perf_counter()
    root = ROOT / "build" / "gnn_mesh_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    go, ranks = root / "go", {}
    cfg = gf.cell_config(GNN_MESH_CELL)
    ng = gf.GNN_SHAPES[GNN_MESH_CELL].get("n_graphs", 1)
    rep = {"ranks": GNN_MESH_RANKS, "card": card, "cell": GNN_MESH_CELL,
           "tol": TOL_GNN_MESH, "steps": GNN_MESH_STEPS}
    t0 = time.perf_counter()
    batch = gf.train_batch(GNN_MESH_CELL, np.random.default_rng(GNN_SEED),
                           device="cpu")
    rep["host_batch_s"] = time.perf_counter() - t0
    params = dimenet.init(torch.Generator().manual_seed(0), cfg)
    torch.save(batch, root / "batch.pt")
    torch.save(params, root / "params.pt")
    card0 = f"cuda:{torch.cuda.current_device()}"

    def spawn():
        try:
            ranks["out"] = run_on_mesh(
                gnn_mesh_rank, GNN_MESH_RANKS, [card0] * GNN_MESH_RANKS,
                "gloo", args=(str(go), str(root)), timeout=900.0)
        except BaseException as e:      # raised again on the main thread
            ranks["error"] = e

    spawned = time.time()
    thread = threading.Thread(target=spawn, daemon=True)
    thread.start()
    names = [k for k, _ in leaves(params)]

    def worst(got, exp) -> list:
        """[the leaf, its error] whose error over its largest is worst."""
        errs = {n: float((torch.as_tensor(a).double() - b).abs().max())
                / max(float(b.abs().max()), 1e-300)
                for n, a, b in zip(names, got, exp)}
        w = max(errs, key=errs.get)
        return [w, errs[w]]

    def cpu(ts):
        return [t.double().cpu() for t in ts]

    try:
        # one process on the card while the ranks start: the f64 hold,
        # its loss and gradients held to the port on the CPU; then f32
        cfg64, b64, p64 = gnn_mesh_f64(torch, cfg, batch, params)
        gb64 = {k: v.to(dev) for k, v in b64.items()}
        losses64, after64, _, g_g = gnn_mesh_steps(
            torch, cfg64, ng, tree_to(p64, dev), gb64, grads=True)
        l_g, g_g, after64 = losses64[0], cpu(g_g), cpu(after64)
        del gb64
        gc_collect(torch)
        t0 = time.perf_counter()
        l_c, g_c = gnn_mesh_grads(torch, cfg64, ng, p64, b64)
        rep["cpu_hold_s"] = time.perf_counter() - t0
        rep["loss_cuda_vs_cpu_rel"] = abs(l_g - l_c) / abs(l_c)
        rep["grad_cuda_vs_cpu_worst"] = worst(g_g, g_c)
        del g_c, b64
        ops.reset_launch_counts()
        gb = {k: v.to(dev) for k, v in batch.items()}
        torch.cuda.reset_peak_memory_stats()
        losses32, _, secs, _ = gnn_mesh_steps(torch, cfg, ng,
                                              tree_to(params, dev), gb,
                                              sync=torch.cuda.synchronize)
        rep["one_process"] = {
            "loss_f64": l_g, "losses_f64": losses64, "losses": losses32,
            "s": secs, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        launched = [{k: n for k, n in ops.launch_counts().items() if n}]
        del gb
        gc_collect(torch)
        go.touch()
        rep["go_s"] = time.time() - spawned
        thread.join()
        if "error" in ranks:
            raise ranks["error"]
        out = ranks["out"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(rep["loss_cuda_vs_cpu_rel"] <= TOL_GNN_MESH["loss"]
          and rep["grad_cuda_vs_cpu_worst"][1] <= TOL_GNN_MESH["grad"],
          f"gnn-mesh: {GNN_MESH_CELL} on the card against the CPU (f64): "
          f"loss {l_g} / {l_c}, gradient {rep['grad_cuda_vs_cpu_worst']}")
    rep["ranks_timeline_s"] = {k: max(r["marks"][k] for r in out) - spawned
                               for k in out[0]["marks"]}
    before = [t.double() for _, t in leaves(params)]
    for key, r0 in out[0]["runs"].items():
        x = {"loss_f64": r0["loss"], "losses_f64": r0["losses"],
             "losses": r0["f32_losses"],
             "s": [max(r["runs"][key]["s"][i] for r in out)
                   for i in range(GNN_MESH_STEPS)],
             "peak_gb_by_rank": [r["runs"][key]["peak_gb"] for r in out]}
        x["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                zip(r0["losses"], losses64))
        x["grad_worst"] = worst(r0["grads"], g_g)
        change = {n: float(np.linalg.norm(a - c.numpy())
                           / max(float((c - b).norm()), 1e-300))
                  for n, a, b, c in zip(names, r0["params"], before,
                                        after64)}
        w = max(change, key=change.get)
        x["change_worst"] = [w, change[w]]
        # the control: the unchanged parameters must miss
        x["control_min"] = min(
            float((b - c).norm() / max(float((c - b).norm()), 1e-300))
            for b, c in zip(before, after64))
        x["f32_losses_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                      zip(r0["f32_losses"], losses32))
        for r in out[1:]:
            rr = r["runs"][key]
            check(all(rr[k] == r0[k] for k in ("loss", "losses",
                                               "grad_digests",
                                               "param_digests")),
                  f"gnn-mesh: {key} rank {r['rank']} differs from rank 0")
        check(x["loss_rel_err"] <= TOL_GNN_MESH["loss"],
              f"gnn-mesh: {key} f64 losses {r0['loss']} {r0['losses']} "
              f"against one process's {l_g} {losses64}")
        check(x["grad_worst"][1] <= TOL_GNN_MESH["grad"],
              f"gnn-mesh: {key} gradient {x['grad_worst']} of its largest "
              f"from one process's")
        check(change[w] <= TOL_GNN_MESH["change"]
              and x["control_min"] > TOL_GNN_MESH["change"],
              f"gnn-mesh: {key} leaf {w}'s change differs by {change[w]} "
              f"of its norm (the unchanged state {x['control_min']})")
        check(all(np.isfinite(x["losses"])), f"gnn-mesh: {key} f32 losses "
              f"{x['losses']}")
        check(max(x["peak_gb_by_rank"]) * GNN_MESH_RANKS < 80.0,
              f"gnn-mesh: {key} peaks {x['peak_gb_by_rank']}")
        rep[key] = x
    launched += [r["launches"] for r in out]
    check(not any(launched), f"gnn-mesh: the DimeNet path launched "
          f"kernels {launched}")
    rep["seconds"] = time.perf_counter() - t_phase
    print("gnn-mesh: " + json.dumps(rep), flush=True)
    print(f"gnn-mesh: {rep['seconds']:.1f} s", flush=True)
    return rep


def gc_collect(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import gc

    import numpy as np
    from repro_torch import core, data, serving, training
    from repro_torch.configs import PROD, lm_family
    from repro_torch.kernels import ops
    from repro_torch.kernels.bus_attention import bus_route
    from repro_torch.kernels.flash_attention import (
        BWD_SIMT, BWD_TF32, _bwd_cuda_as_written, _bwd_plain_f32,
        backward_route, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_fwd_plain)
    from repro_torch.kernels.pq_scoring import pq_lut_scores_plain
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import tables
    from repro_torch.launch.profile import pq_distortion
    from repro_torch import obs
    from repro_torch.launch.serve import (Recommender, _pad_histories,
                                          make_recommend_execute,
                                          measure_recall, micro_batch_loop,
                                          pq_scan_inputs)
    from repro_torch.serving.scheduler import pow2_buckets
    from repro_torch.launch.train import first_batch_of_bucket, make_loader
    from repro_torch.models import lm
    from repro_torch.optim.adam import leaves
    from repro_torch.serving.index import (_masked_topk, _pq_scan_inputs,
                                           _topk_padded)

    report = {}
    # ------------------------------------------------------------ setup
    t_smoke = time.perf_counter()

    def mark(phase):
        """The phase's start on the smoke's clock: where a cut call was."""
        print(f"smoke: {phase} from {time.perf_counter() - t_smoke:.1f} s",
              flush=True)

    mark("setup")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # a library already under build/ is loaded as it is, with the .log its
    # build left (the same source and flags, by the file name's hash)
    built_now = {name: not hopper_library(name).exists()
                 for name in HOPPER_LIBS + (BUS_LIB, TF32_LIB, TF32_BWD_LIB,
                                            PQ_LIB)}
    t0 = time.perf_counter()
    logs = ops.build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {name}: {regs}", flush=True)
    print(f"kernels built in {report['build_s']:.1f} s", flush=True)
    # the Hopper flash kernels (forward; backward dq and dk/dv): no spills
    # (ptxas -v), and tensor-core products in each instantiation's machine
    # code (wgmma is HGMMA in SASS)
    report["hopper"] = {}
    for name in HOPPER_LIBS:
        ptxas = ptxas_by_kernel(logs[name])
        check_no_spills(name, ptxas)
        hgmma = sass_count(hopper_library(name))
        report["hopper"][name] = {"ptxas": ptxas, "sass_hgmma": hgmma,
                                  "ptxas_built_this_run": built_now[name]}
        print(f"{name}: ptxas {ptxas}; HGMMA per function {hgmma}",
              flush=True)
        check(set(hgmma) == set(ptxas) and all(hgmma.values()),
              f"{name}: a wgmma kernel's SASS has no HGMMA: {hgmma}")
    # the bus attention kernels: no spills, and the products on the
    # tensor cores (mma.sync m16n8k8 tf32 is HMMA.1688.F32.TF32 in SASS)
    ptxas = ptxas_by_kernel(logs[BUS_LIB], bus_kernel)
    check_no_spills(BUS_LIB, ptxas)
    hmma = sass_count(hopper_library(BUS_LIB), bus_kernel, BUS_MMA)
    report["hopper"][BUS_LIB] = {"ptxas": ptxas, "sass_hmma_tf32": hmma,
                                 "ptxas_built_this_run": built_now[BUS_LIB]}
    print(f"{BUS_LIB}: ptxas {ptxas}; {BUS_MMA} per function {hmma}",
          flush=True)
    check(set(hmma) == set(ptxas) and len(hmma) == BUS_INSTANTIATIONS
          and all(hmma.values()),
          f"{BUS_LIB}: a kernel's SASS has no {BUS_MMA}: {hmma}")
    # the 3xTF32 flash forward (the split and the main kernel, D=64 and
    # 128): no spills, and tf32 wgmma in each main kernel's SASS
    ptxas = ptxas_by_kernel(logs[TF32_LIB], tf32_kernel)
    check_no_spills(TF32_LIB, ptxas)
    tf = sass_count(hopper_library(TF32_LIB), tf32_kernel, TF32_MMA)
    hg = sass_count(hopper_library(TF32_LIB), tf32_kernel, "HGMMA")
    report["hopper"][TF32_LIB] = {"ptxas": ptxas, "sass_tf32_mma": tf,
                                  "sass_hgmma": hg,
                                  "ptxas_built_this_run": built_now[TF32_LIB]}
    print(f"{TF32_LIB}: ptxas {ptxas}; {TF32_MMA} per function {tf}; "
          f"HGMMA {hg}", flush=True)
    check(set(tf) == set(ptxas) and len(tf) == 4 and tf == hg
          and all(n for name, n in tf.items() if name.startswith("flash")),
          f"{TF32_LIB}: a main kernel's SASS has no tf32 wgmma "
          f"({TF32_MMA} {tf}, HGMMA {hg})")
    # the 3xTF32 flash backward (the split, the dq and dk/dv kernels, D=64
    # and 128): no spills, and only tf32 wgmma, in both main kernels
    ptxas = ptxas_by_kernel(logs[TF32_BWD_LIB], tf32_bwd_kernel)
    check_no_spills(TF32_BWD_LIB, ptxas)
    tf = sass_count(hopper_library(TF32_BWD_LIB), tf32_bwd_kernel, TF32_MMA)
    hg = sass_count(hopper_library(TF32_BWD_LIB), tf32_bwd_kernel, "HGMMA")
    report["hopper"][TF32_BWD_LIB] = {
        "ptxas": ptxas, "sass_tf32_mma": tf, "sass_hgmma": hg,
        "ptxas_built_this_run": built_now[TF32_BWD_LIB]}
    print(f"{TF32_BWD_LIB}: ptxas {ptxas}; {TF32_MMA} per function {tf}; "
          f"HGMMA {hg}", flush=True)
    check(set(tf) == set(ptxas) and len(tf) == 6 and tf == hg
          and all(n for name, n in tf.items() if name.startswith("flash")),
          f"{TF32_BWD_LIB}: a main kernel's SASS has no tf32 wgmma "
          f"({TF32_MMA} {tf}, HGMMA {hg})")
    # the PQ scan (the tiled kernel's four instantiations, the general
    # kernel's three): no spills; the tiled kernel's 16-byte code loads
    # and float4 stores at W = 4
    ptxas = ptxas_by_kernel(logs[PQ_LIB], pq_kernel)
    check_no_spills(PQ_LIB, ptxas)
    pq_sass = {ins: sass_count(hopper_library(PQ_LIB), pq_kernel, ins)
               for ins in PQ_SASS}
    report["hopper"][PQ_LIB] = {"ptxas": ptxas, "sass": pq_sass,
                                "ptxas_built_this_run": built_now[PQ_LIB]}
    print(f"{PQ_LIB}: ptxas {ptxas}; SASS {pq_sass}", flush=True)
    wide = [n for n in ptxas if n.startswith("pq_tiled") and n.endswith(",4>")]
    check(len(ptxas) == 7 and len(wide) == 2
          and all(pq_sass["LDG.E.128"][n] and pq_sass["STG.E.128"][n]
                  for n in wide),
          f"{PQ_LIB}: the tiled kernel's wide loads and stores: {pq_sass}")

    # the EmbeddingBag forward and backward kernels: no spills
    ptxas = ptxas_by_kernel(logs[EBAG_LIB], ebag_kernel)
    check_no_spills(EBAG_LIB, ptxas)
    report["hopper"][EBAG_LIB] = {"ptxas": ptxas}
    print(f"{EBAG_LIB}: ptxas {ptxas}", flush=True)
    check(len(ptxas) == 13, f"{EBAG_LIB}: expected 13 kernels, ptxas "
          f"{ptxas}")

    # -------------------------------------------------------------- gnn
    mark("gnn")
    report["gnn"] = gnn_phase(torch, np, dev, ops)
    # --------------------------------------------------------- registry
    mark("registry")
    report["registry"], registry_launches, registry_holds = registry_phase(
        torch, dev, ops)
    # --------------------------------------------------------- roofline
    mark("roofline")
    report["roofline"], roofline_launches = roofline_phase(torch, dev, ops)
    gc_collect(torch)

    # ------------------------------------------------------------ slice
    mark("slice")
    cfg = PROD
    t0 = time.perf_counter()
    corpus, log, store, serve_lcfg = make_loader(cfg, n_news=N_NEWS, seed=0)
    report["corpus_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    params = core.init_speedyfeed(gen, cfg)
    # one registry for the serving phases, as the launcher starts one; a
    # delta hard cap that holds the corpus: the bootstrap publishes all of
    # it into the delta tier before the first build (the default cap, 8 x
    # the compaction threshold of 512, holds 4,096)
    obs.reset()
    rec = Recommender(cfg, params, store, k=10, index_kind="ivf-pq",
                      nprobe=16, k_prime=64, device=dev,
                      service_kw={"delta_hard_cap": N_NEWS})
    reqs = list(log.histories[:N_REQUESTS + BATCH])
    print(f"corpus: {store.tokens.shape[0]} news rows in "
          f"{report['corpus_s']:.1f} s; {len(reqs)} requests", flush=True)

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = rec._encode_corpus()
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = rec.build_index_from(emb)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    # warm-up: one batch a shape bucket, outside the scheduler's metrics
    # (RequestScheduler.warmup's calls)
    warm = make_recommend_execute(rec)
    for b in pow2_buckets(BATCH):
        warm(reqs[:b], b)
    _, n_batches = micro_batch_loop(rec, reqs[BATCH:], max_batch=BATCH)
    lat = {phase: obs.histogram("query_latency_ms", phase=phase)
           for phase in ("e2e", "execute", "queued")}
    recall = measure_recall(rec, reqs[BATCH:], k=10, probe=16)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    n_rows = emb.shape[0]
    chunks = -(-n_rows // 256)
    snap = svc.snapshot()
    report["slice"] = {
        "news": n_rows, "encode_s": encode_s,
        "encode_news_per_s": n_rows / encode_s, "index_build_s": index_s,
        "nlist": int(snap.list_ids.shape[0]), "cap": snap.cap,
        "ntotal": snap.ntotal, "requests": N_REQUESTS, "batch": BATCH,
        "n_batches": n_batches,
        "query_p50_ms": lat["e2e"].percentile(50),
        "query_p99_ms": lat["e2e"].percentile(99),
        "query_execute_p50_ms": lat["execute"].percentile(50),
        "query_execute_p99_ms": lat["execute"].percentile(99),
        "query_queued_p50_ms": lat["queued"].percentile(50),
        "query_queued_p99_ms": lat["queued"].percentile(99),
        "batch_size_mean": obs.histogram("serve_batch_size").sum
        / max(n_batches, 1),
        "recall_at_10": recall, "launches": launches,
        "expected_bus_launches": cfg.plm.n_layers * chunks}
    print("slice: " + json.dumps(report["slice"]), flush=True)
    check(tuple(emb.shape) == (N_NEWS + 1, cfg.plm.news_dim),
          f"embeddings shape {tuple(emb.shape)}")
    check(bool(torch.isfinite(emb).all()), "non-finite corpus embeddings")
    check(snap.ntotal == N_NEWS, f"index holds {snap.ntotal} of {N_NEWS}")
    check(launches["bus_attention"] == cfg.plm.n_layers * chunks,
          f"bus_attention launched {launches['bus_attention']} times, "
          f"expected {cfg.plm.n_layers * chunks}")
    check(launches["bus_attention_simt"] == 0,
          "the encode sent a bus launch to the SIMT kernel")
    check(launches["pq_lut_scores"] > 0, "pq_lut_scores never launched")
    check(launches["pq_lut_scores_general"] == 0,
          "the serve path sent a scan to the general PQ kernel")
    check(0.0 < recall <= 1.0, f"recall@10 {recall}")
    check(lat["e2e"].count == lat["execute"].count == N_REQUESTS
          and np.isfinite(report["slice"]["query_p99_ms"]),
          f"the closed loop served {lat['e2e'].count} of {N_REQUESTS}")

    # ------------------------------------------------------------ index
    mark("index")
    # the served IVF-PQ build against the same build on the CPU, where
    # sums run in a fixed order. recall@10 on 16 users moves severalfold
    # from one build to the next (the atomic adds of index_add_ reorder);
    # the share of residual energy the PQ codes lose, a mean over every
    # vector, does not
    bld = svc.builder
    t0 = time.perf_counter()
    cpu_snap = serving.IndexBuilder(
        bld.kind, bld.dim, ivf=bld.ivf, pq=bld.pq, seed=bld.seed,
        device="cpu").build(np.arange(1, n_rows), emb[1:].cpu())
    dist = {"card": pq_distortion(snap, svc.store.emb),
            "cpu": pq_distortion(cpu_snap, emb.cpu()),
            "cpu_build_s": time.perf_counter() - t0}
    report["index"] = {"pq_distortion": dist}
    print("index: " + json.dumps(report["index"]), flush=True)
    check(abs(dist["card"] - dist["cpu"]) <= TOL_DISTORTION,
          f"PQ distortion on the card {dist['card']} vs the CPU build "
          f"{dist['cpu']}")

    # ------------------------------------------------------------ plain
    mark("plain")
    with torch.inference_mode():
        toks = torch.as_tensor(store.tokens[:512], device=dev).long()
        freq = torch.as_tensor(store.freq[:512], device=dev).long()
        plain = core.buslm_encode(rec.params["plm"], cfg.plm, toks, freq,
                                  impl="plain")
        plain[0] = 0.0                       # as _encode_corpus pads row 0
    enc_err = float((plain - emb[:512]).abs().max())
    # one query batch: the served answer against RetrievalService.query's
    # two stages redone with the plain LUT scan, on the inputs the served
    # IVF-PQ search gathers off the same snapshot
    hist, mask = _pad_histories(rec, reqs[BATCH:2 * BATCH], BATCH)
    _, ids_k = rec.recommend(hist, mask)
    check(svc.n_pending == 0, "the delta tier is not empty")
    with torch.inference_mode():
        user = rec.encode_users(hist, mask)
        lut, codes, valid, cand, coarse = _pq_scan_inputs(
            user, snap.cent_unit, snap.cent_raw, snap.list_ids, snap.payload,
            snap.lens, snap.pq_centers, snap.pq_rot, nprobe=snap.nprobe,
            metric=snap.metric)
        k_eff = min(svc.k_prime, snap.nprobe * snap.cap)
        _, cand_p = _masked_topk(pq_lut_scores_plain(lut, codes, valid)
                                 + coarse, cand, valid, k_eff)
        cand_p = cand_p.long()
        exact = torch.einsum("bd,bcd->bc", user,
                             svc.store.emb[cand_p.clamp_min(0)])
        ids_p = _topk_padded(exact, cand_p, rec.k)[1].cpu().numpy()
    same = all(set(a) == set(b) for a, b in zip(ids_k, ids_p))
    report["plain"] = {"encode_max_abs_err": enc_err, "topk_sets_equal": same}
    print("plain: " + json.dumps(report["plain"]), flush=True)
    check(enc_err <= TOL_ENCODE, f"encode differs from plain by {enc_err}")
    check(same, "top-k id sets differ between kernel and plain scans")

    # ------------------------------------------------------- serve-front
    mark("serve-front")
    report["serve_front"], front_launches = serve_front_phase(
        torch, np, dev, rec, reqs, report["slice"]["query_execute_p50_ms"],
        dist["card"])

    # ------------------------------------------------------------ train
    mark("train")
    # the slice's store, read by the DynamicBatcher with the paper's token
    # budget; its first top-bucket batch (the mesh phase's too); the PROD
    # Trainer from the registry, as a user would call it
    lcfg = dataclasses.replace(serve_lcfg,
                               token_budget=data.LoaderConfig.token_budget)
    top = max(lcfg.buckets)
    top_np = first_batch_of_bucket(log, store, lcfg, top)
    del rec, svc
    torch.cuda.empty_cache()
    trainer = training.get_trainer("speedyfeed", cfg=cfg, device=dev)
    state = trainer.init_state(seed=0)
    watch = {p: t.detach().clone() for p, t in leaves(state.params)
             if p in ("plm/layers/0/attn/q/w", "plm/out_proj/w",
                      "user/proj/w", "plm/tok_emb/table")}

    def make_batcher(epoch):
        return data.DynamicBatcher(log, store, lcfg, n_threads=2,
                                   seed=1_000_003 * epoch).start()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    res = trainer.fit(make_batcher, steps=TRAIN_STEPS, state=state,
                      log_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_launches = ops.launch_counts()
    state = res.state
    L = cfg.plm.n_layers
    encoded = [int(x) for x in res.history["encoded"]]
    written_last = int((state.cache.written_step == state.step - 1).sum())
    written_any = int((state.cache.written_step >= 0).sum())
    now = dict(leaves(state.params))
    moved = {p: float((t - now[p].detach()).abs().max())
             for p, t in watch.items()}
    report["train"] = {
        "steps": res.steps_done, "losses": res.losses,
        "buckets": res.bucket_steps, "fit_s": res.wall_seconds,
        "encoded_per_step": encoded, "rows_written_last_step":
        written_last, "rows_written": written_any, "param_moved": moved,
        "launches": train_launches,
        "host_stall_fraction": res.host_stall_fraction}
    check(res.steps_done == TRAIN_STEPS, f"fit ran {res.steps_done} steps")
    check(all(np.isfinite(res.losses)) and len(res.losses) == TRAIN_STEPS,
          f"train losses {res.losses}")
    check(all(v > 0 for v in moved.values()), f"params did not move {moved}")
    check(written_last == encoded[-1],
          f"last step wrote {written_last} cache rows, encoded "
          f"{encoded[-1]}")
    check(0 < written_any <= sum(encoded),
          f"{written_any} cache rows written, {sum(encoded)} encoded")
    check(train_launches["bus_attention"] == 2 * L * TRAIN_STEPS,
          f"bus_attention launched {train_launches['bus_attention']} "
          f"times in training, expected {2 * L * TRAIN_STEPS}")
    check(train_launches["bus_attention_bwd"] == L * TRAIN_STEPS,
          f"bus_attention_bwd launched {train_launches['bus_attention_bwd']}"
          f" times, expected {L * TRAIN_STEPS}")
    check(train_launches["bus_attention_simt"] == 0
          and train_launches["bus_attention_bwd_simt"] == 0,
          "training sent a bus launch to the SIMT kernels")

    # steady state: synchronised steps on one top-bucket batch
    top_batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 top_np.items() if not k.startswith("_")}
    step_s, enc = [], []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, top_batch, top)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        enc.append(int(m["encoded"]))
        check(bool(torch.isfinite(m["loss"])), "non-finite timed step")
    E = cfg.cache.encode_budget
    report["train"].update({
        "timed_bucket": top, "step_s": step_s,
        "s_per_step": float(np.mean(step_s)),
        "encode_rows_per_s": E / float(np.mean(step_s)),
        "valid_encoded_per_step": enc,
        "valid_encoded_per_s": float(np.mean(enc)) / float(np.mean(step_s)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_tflop_per_step": 4 * core.plm_flops(cfg.plm, E) / 1e12})
    print("train: " + json.dumps(report["train"]), flush=True)

    # ------------------------------------------------------- plain (train)
    mark("plain (train)")
    # one step's loss and gradients, kernels against the plain path, on the
    # trained parameters, the top-bucket batch and fixed draws; E cut to 256
    pcfg = dataclasses.replace(cfg, cache=dataclasses.replace(
        cfg.cache, encode_budget=PLAIN_E))
    flat = [p for _, p in leaves(state.params)]
    gen = torch.Generator(device=dev).manual_seed(5)
    neg = core.sample_negatives(gen, pcfg.merged_cap,
                                top_batch["hist_mask"][:, 1:].shape,
                                pcfg.n_neg)
    grads = {}
    for impl in ("kernel", "plain"):
        cold = core.init_cache(pcfg.cache, dev)
        out = core.speedyfeed_forward(state.params, pcfg, top_batch, cold, 0,
                                      u=1.0, neg_idx=neg, impl=impl)
        g = torch.autograd.grad(out.loss, flat, allow_unused=True)
        grads[impl] = (float(out.loss.detach()), g)
        del cold, out
    (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
    report["plain_train"] = {"E": PLAIN_E, "loss_kernel": lk,
                             "loss_plain": lp, "loss_abs_err": abs(lk - lp),
                             **grad_agreement(
                                 [p for p, _ in leaves(state.params)], gk,
                                 gp)}
    print("plain (train): " + json.dumps(report["plain_train"]), flush=True)
    check(abs(lk - lp) <= TOL_LOSS, f"train loss kernel {lk} vs plain {lp}")
    check_grad_agreement("train", report["plain_train"])
    del grads, gk, gp, flat

    # ------------------------------------------------------------- ckpt
    mark("ckpt")
    report["ckpt"], state, ckpt_launches = ckpt_phase(
        torch, np, dev, cfg, card, trainer, state, top_batch, top,
        make_batcher)

    # ----------------------------------------------------- conventional
    mark("conventional")
    # the trainer's memory goes first (the top-bucket batch stays for the
    # quality phase)
    del trainer, state, res, watch, now, neg
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- mesh
    mark("mesh")
    # after the train phase, whose steps warmed this process's libraries;
    # the serving half on the slice's snapshot, embeddings and a batch
    t_mesh = time.perf_counter()
    mesh_serve_rep, mesh_pq = mesh_serve(torch, np, dev, snap, emb, user)
    gc_collect(torch)
    report["mesh"], mesh_bus = mesh_train(torch, np, dev, cfg, card, top_np)
    report["mesh"]["serve"] = mesh_serve_rep
    report["mesh"]["wall_s"] = time.perf_counter() - t_mesh
    print("mesh: " + json.dumps(report["mesh"]), flush=True)
    check(report["mesh"]["wall_s"] <= MESH_PHASE_S,
          f"mesh: the phase took {report['mesh']['wall_s']:.1f} s, over "
          f"{MESH_PHASE_S}")
    gc_collect(torch)
    report["conventional"], conv_launches = conventional_phase(
        torch, np, dev, cfg, card, log, store, lcfg)

    # --------------------------------------------------------------- lm
    mark("lm")
    # the conventional trainer's memory goes with its phase; the peak
    # counts from here
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qcfg = lm_family.QWEN3_14B
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    lm_params = lm.init(torch.Generator(device=dev).manual_seed(0), qcfg,
                        bf16)
    torch.cuda.synchronize()
    lm_rep = {"config": dataclasses.asdict(qcfg),
              "params": qcfg.param_count(),
              "params_gb": torch.cuda.memory_allocated() / 1e9,
              "init_s": time.perf_counter() - t0}
    prefill = lm_family.make_fn(qcfg, "prefill")
    decode = lm_family.make_fn(qcfg, "decode")
    gl = torch.Generator(device=dev).manual_seed(2)
    V = qcfg.vocab

    def greedy(tok, cache, steps):
        """``steps`` synchronised greedy decode steps from slot 0; returns
        (per-step ms, the flash forward launches they made by route,
        last logits)."""
        ops.reset_launch_counts()
        ms = []
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode(lm_params, tok, cache, t)
            tok = logits.argmax(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        now = ops.launch_counts()
        return ms, {n: now[n] for n in FLASH_FWD}, logits

    toks = torch.randint(0, V, (1, LM_PREFILL_SEQ), generator=gl, device=dev)
    t0 = time.perf_counter()
    prefill(lm_params, toks)                             # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    last = prefill(lm_params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.launch_counts()
    lm_rep["prefill"] = {
        "batch": 1, "seq": LM_PREFILL_SEQ, "warmup_s": warm_s,
        "s": prefill_s, "tokens_per_s": LM_PREFILL_SEQ / prefill_s,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": prefill_launches}
    print("lm prefill: " + json.dumps(lm_rep["prefill"]), flush=True)
    check(tuple(last.shape) == (1, V), f"prefill logits {tuple(last.shape)}")
    check(bool(torch.isfinite(last).all()), "non-finite prefill logits")
    want = flash_fwd_launches(bf16, qcfg.hd, qcfg.n_layers)
    check({n: prefill_launches[n] for n in FLASH_FWD} == want,
          f"flash forward launches in one bf16 prefill: "
          f"{ {n: prefill_launches[n] for n in FLASH_FWD} }, expected "
          f"{want}")
    del toks, last
    torch.cuda.empty_cache()

    for name, quant, steps in (("decode", False, LM_DECODE_STEPS),
                               ("decode_q8", True, LM_Q8_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        cache = lm.init_cache(qcfg, LM_DECODE_BATCH, LM_DECODE_SLOTS, bf16,
                              quant=quant, device=dev)
        tok = torch.randint(0, V, (LM_DECODE_BATCH, 1), generator=gl,
                            device=dev)
        ms, flash_n, logits = greedy(tok, cache, steps)
        steady = ms[1:]
        lm_rep[name] = {
            "batch": LM_DECODE_BATCH, "slots": LM_DECODE_SLOTS,
            "steps": steps, "cache_gb": sum(nbytes(t) for t in
                                            cache.values()) / 1e9,
            "first_step_ms": ms[0],
            "ms_per_step": float(np.mean(steady)),
            "ms_per_step_median": float(np.median(steady)),
            "tokens_per_s": LM_DECODE_BATCH * 1e3 / float(np.mean(steady)),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flash_launches": flash_n}
        print(f"lm {name}: " + json.dumps(lm_rep[name]), flush=True)
        check(bool(torch.isfinite(logits).all()), f"non-finite {name} logits")
        check(not any(flash_n.values()), f"{name} launched the flash "
              f"forward {flash_n} times, expected 0")
        del cache, logits
        torch.cuda.empty_cache()

    # prefill through the kernel against the T-th decode step's logits,
    # and the prefill through the kernel against its plain version; in
    # bf16 (with the layer-by-layer reading), then with the weights cast
    # to f32
    dec_toks = torch.randint(0, V, (LM_CHECK_B, LM_CHECK_T), generator=gl,
                             device=dev)
    plain_toks = torch.randint(0, V, (1, LM_PLAIN_SEQ), generator=gl,
                               device=dev)
    lm_rep["check"] = {"tol_rel_f32": TOL_LM_REL_F32,
                       "tol_attn_bf16": TOL_ATTN_BF16}
    for dt in ("bfloat16", "float32"):
        ccfg = dataclasses.replace(qcfg, dtype=dt)
        cast_(torch, lm_params, ccfg.torch_dtype)
        ops.reset_launch_counts()
        ref = lm_family.make_fn(ccfg, "prefill")(lm_params, dec_toks).float()
        step = lm_family.make_fn(ccfg, "decode")
        cache = lm.init_cache(ccfg, LM_CHECK_B, LM_CHECK_T,
                              ccfg.torch_dtype, device=dev)
        for t in range(LM_CHECK_T):
            logits, cache = step(lm_params, dec_toks[:, t:t + 1], cache, t)
        logits = logits.float()
        with torch.no_grad():
            kern = lm.prefill(lm_params, ccfg, plain_toks).float()
            plain_l = lm.prefill(lm_params, ccfg, plain_toks,
                                 impl="plain").float()
        lm_rep["check"][dt] = {
            "prefill_vs_decode": {
                "batch": LM_CHECK_B, "T": LM_CHECK_T,
                "max_rel_err": float((logits - ref).abs().max()
                                     / ref.abs().max()),
                "argmax_agree": float((logits.argmax(-1) == ref.argmax(-1))
                                      .float().mean()),
                "max_abs_logit": float(ref.abs().max())},
            "kernel_vs_plain": {
                "seq": LM_PLAIN_SEQ,
                "max_rel_err": float((kern - plain_l).abs().max()
                                     / plain_l.abs().max())}}
        check(bool(torch.isfinite(logits).all() and torch.isfinite(kern).all()),
              f"non-finite {dt} check logits")
        del ref, cache, logits, kern, plain_l
        if dt == "bfloat16":
            lm_rep["check"][dt]["by_layer"] = lm_by_layer(
                torch, lm_params, ccfg, plain_toks)
        now = ops.launch_counts()
        lm_rep["check"][dt]["flash_launches"] = {n: now[n]
                                                 for n in FLASH_FWD}
        torch.cuda.empty_cache()
    report["lm"] = lm_rep
    print("lm check: " + json.dumps(lm_rep["check"]), flush=True)
    # two kernel prefills a dtype (at T=64 and at LM_PLAIN_SEQ), and in bf16
    # the layer-by-layer reading's attention and block (two a layer), each
    # on its dtype's route: bf16 on the Hopper kernel, f32 on the SIMT one
    nl = qcfg.n_layers
    for dt, n in (("bfloat16", 4 * nl), ("float32", 2 * nl)):
        want = flash_fwd_launches(getattr(torch, dt), qcfg.hd, n)
        got = lm_rep["check"][dt]["flash_launches"]
        check(got == want, f"{dt} LM check flash launches {got}, expected "
              f"{want}")
    f32 = lm_rep["check"]["float32"]
    for name in ("prefill_vs_decode", "kernel_vs_plain"):
        check(f32[name]["max_rel_err"] <= TOL_LM_REL_F32,
              f"f32 {name} logits differ by {f32[name]['max_rel_err']} of "
              f"the largest")
    local = lm_rep["check"]["bfloat16"]["by_layer"]["attn_local_max_rel_err"]
    worst = int(np.argmax(local))
    check(local[worst] <= TOL_ATTN_BF16,
          f"bf16 attention of layer {worst}, kernel vs plain on the same "
          f"input, differs by {local[worst]} of its largest value")
    del lm_params
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- lm-moe
    mark("lm-moe")
    report["lm_moe"], moe_launches = lm_moe_phase(torch, np, dev)

    # --------------------------------------------------------- lm-train
    mark("lm-train")
    report["lm_train"], lm_train_launches = lm_train_phase(torch, np, dev)

    # ---------------------------------------------------------- lm-mesh
    mark("lm-mesh")
    gc_collect(torch)
    report["lm_mesh"], lm_mesh_launches, lm_mesh_held = lm_mesh_phase(
        torch, np, dev, card)

    # ----------------------------------------------------- flash-groups
    mark("flash-groups")
    gc_collect(torch)
    report["flash_groups"], group_launches = flash_group_holds(torch, dev)

    # ----------------------------------------------------------- recsys
    mark("recsys")
    report["recsys"], ebag_row = recsys_phase(torch, np, dev)

    # ----------------------------------------------------- recsys-train
    mark("recsys-train")
    report["recsys_train"], ebag_bwd_row, rs_train_fwd = recsys_train_phase(
        torch, np, dev, {k: v for k, v in report["hopper"][EBAG_LIB][
            "ptxas"].items() if "bwd" in k})

    # ------------------------------------------------------ recsys-mesh
    mark("recsys-mesh")
    gc_collect(torch)
    report["recsys_mesh"], rs_mesh_launches, rs_mesh_held = \
        recsys_mesh_phase(torch, np, dev, card)

    # --------------------------------------------------------- gnn-mesh
    mark("gnn-mesh")
    gc_collect(torch)
    report["gnn_mesh"] = gnn_mesh_phase(torch, np, dev, card)

    # ---------------------------------------------------------- quality
    mark("quality")
    gc.collect()
    torch.cuda.empty_cache()
    report["quality"], quality_launches = quality_phase(
        torch, np, dev, cfg, card, corpus, serve_lcfg, top_batch, top)
    del top_batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- kernels
    mark("kernels")
    def quality_by(name):
        return {part: c[name] for part, c in quality_launches.items()}

    def quality_sum(name):
        return sum(quality_by(name).values())

    kernels = []
    g = torch.Generator(device=dev).manual_seed(1)
    K, S, H, D = cfg.plm.n_segments, cfg.plm.seg_len, cfg.plm.n_heads, \
        cfg.plm.d_model // cfg.plm.n_heads
    tc_fwd, tc_bwd = bus_route(S, S + K, D)
    check((tc_fwd, tc_bwd) == ("bus_attention", "bus_attention_bwd"),
          f"the PROD bus shape is routed to {tc_fwd}, {tc_bwd}")
    # the forward at the serve chunk (M=256 news)
    q, k, v, kv_mask, _ = bus_inputs(torch, g, 256, K, S, H, D, dev)
    fwd_row = on_route(ops, tc_fwd,
                       lambda: bus_fwd_row(torch, q, k, v, kv_mask))
    kernels.append({
        "name": "bus_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bus_attention.cu",
        "replaces": "src/repro/kernels/bus_attention.py:92",
        "launches": launches["bus_attention"]
        + train_launches["bus_attention"] + ckpt_launches["bus_attention"]
        + conv_launches["bus_attention"] + quality_sum("bus_attention")
        + mesh_bus["bus_attention"],
        "launches_by_path": {"serve": launches["bus_attention"],
                             "train": train_launches["bus_attention"],
                             "ckpt": ckpt_launches["bus_attention"],
                             "conventional": conv_launches["bus_attention"],
                             "quality": quality_by("bus_attention"),
                             "mesh": mesh_bus["bus_attention"]},
        **fwd_row})
    del q, k, v, kv_mask

    # the backward at the training step's shape: E=4096 news, S=32
    qb, kb, vb, mb, dob = bus_inputs(torch, g, cfg.cache.encode_budget, K,
                                     S, H, D, dev)
    kernels.append({
        "name": "bus_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bus_attention.cu",
        "replaces": "src/repro/kernels/bus_attention.py:115",
        "launches": train_launches["bus_attention_bwd"]
        + ckpt_launches["bus_attention_bwd"]
        + conv_launches["bus_attention_bwd"]
        + quality_sum("bus_attention_bwd") + mesh_bus["bus_attention_bwd"],
        "launches_by_path": {"serve": launches["bus_attention_bwd"],
                             "train": train_launches["bus_attention_bwd"],
                             "ckpt": ckpt_launches["bus_attention_bwd"],
                             "conventional":
                             conv_launches["bus_attention_bwd"],
                             "quality": quality_by("bus_attention_bwd"),
                             "mesh": mesh_bus["bus_attention_bwd"]},
        **on_route(ops, tc_bwd, lambda: bus_bwd_row(torch, qb, kb, vb, mb,
                                                    dob))})
    # the forward at the step's shape (a step launches it 24 times with
    # remat), held and timed as at the serve chunk
    kernels[-2]["train_shape"] = on_route(
        ops, tc_fwd, lambda: bus_fwd_row(torch, qb, kb, vb, mb, iters=10))
    fwd_ms = kernels[-2]["train_shape"]["ms"]
    report["train"]["bus_kernels_ms_per_step"] = (
        2 * L * fwd_ms + L * kernels[-1]["ms"])
    report["train"]["bus_fwd_ms_at_step_shape"] = fwd_ms
    report["train"]["bus_kernels_share_of_step"] = (
        report["train"]["bus_kernels_ms_per_step"] / 1e3
        / report["train"]["s_per_step"])
    del qb, kb, vb, dob, mb

    # the forward and backward at the conventional step's shape (its
    # B*(L+C) news in one encode), held as at the buckets; a generator of
    # its own leaves the later checks' inputs as they were
    Mc = report["conventional"]["news_per_step"]
    qc, kc, vc, mc, doc = bus_inputs(
        torch, torch.Generator(device=dev).manual_seed(2), Mc, K, S, H, D,
        dev)
    for row, name, fn in (
            (kernels[-2], tc_fwd,
             lambda: bus_fwd_checks(torch, qc, kc, vc, mc)),
            (kernels[-1], tc_bwd,
             lambda: bus_bwd_checks(torch, qc, kc, vc, mc, doc))):
        row["conventional_shape"] = {**on_route(ops, name, fn),
                                     "shape": [Mc, K, S, S + K, H, D]}
    del qc, kc, vc, mc, doc

    # every bucket the trainer's fit draws (S in lcfg.buckets, each its own
    # compiled count of key tiles and row blocks), forward and backward at
    # the production widths, held as at S=32
    for Sq in lcfg.buckets:
        check(bus_route(Sq, Sq + K, D) == (tc_fwd, tc_bwd),
              f"bucket S={Sq} is not routed to the tensor-core kernels")
        qq, kq, vq, mq, doq = bus_inputs(torch, g, BUS_BUCKET_M, K, Sq, H,
                                         D, dev)
        for row, name, fn in (
                (kernels[-2], tc_fwd,
                 lambda: bus_fwd_checks(torch, qq, kq, vq, mq)),
                (kernels[-1], tc_bwd,
                 lambda: bus_bwd_checks(torch, qq, kq, vq, mq, doq))):
            row.setdefault("buckets", {})[str(Sq)] = {
                **on_route(ops, name, fn),
                "shape": [BUS_BUCKET_M, K, Sq, Sq + K, H, D]}
        del qq, kq, vq, mq, doq

    # the quality phase's shapes (launch.tables at bench: 4 heads of 16,
    # the loader's buckets at K=3 and fig9's splits of 48 tokens), forward
    # and backward, held as at the buckets over fig9's 256 news
    bcfg = tables.bench_cfg()
    Hq = bcfg.plm.n_heads
    Dq = bcfg.plm.d_model // Hq
    shapes = [(bcfg.plm.n_segments, b)
              for b in data.default_buckets(bcfg.plm.seg_len)]
    shapes += [(k, tables.FIG9_TOTAL // k) for k in tables.FIG9_SEGMENTS
               if k > 1 and (k, tables.FIG9_TOTAL // k) not in shapes]
    for Kq, Sq in shapes:
        check(bus_route(Sq, Sq + Kq, Dq) == (tc_fwd, tc_bwd),
              f"the tables' shape K={Kq}, S={Sq} is not routed to the "
              "tensor-core kernels")
        qq, kq, vq, mq, doq = bus_inputs(torch, g, tables.FIG9_NEWS, Kq, Sq,
                                         Hq, Dq, dev)
        for row, name, fn in (
                (kernels[-2], tc_fwd,
                 lambda: bus_fwd_checks(torch, qq, kq, vq, mq)),
                (kernels[-1], tc_bwd,
                 lambda: bus_bwd_checks(torch, qq, kq, vq, mq, doq))):
            row.setdefault("tables_shapes", {})[f"K{Kq}_S{Sq}"] = {
                **on_route(ops, name, fn),
                "shape": [tables.FIG9_NEWS, Kq, Sq, Sq + Kq, Hq, Dq]}
        del qq, kq, vq, mq, doq

    # the SIMT pair: the route for the shapes the tensor-core kernels do
    # not take (of the paths here only the registry's speedyfeed smoke,
    # at head dim 8, sends one; the registry phase held it there), held
    # and timed at the production widths with a longer segment
    simt_fwd, simt_bwd = bus_route(BUS_SIMT_S, BUS_SIMT_S + K, D)
    qs_, ks_, vs_, ms_, dos_ = bus_inputs(torch, g, 256, K, BUS_SIMT_S, H,
                                          D, dev)
    for name, sym, replaces, fn in (
            (simt_fwd, "bus_attention", ":92",
             lambda: bus_fwd_row(torch, qs_, ks_, vs_, ms_)),
            (simt_bwd, "bus_attention_bwd", ":115",
             lambda: bus_bwd_row(torch, qs_, ks_, vs_, ms_, dos_))):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bus_attention_simt.cu",
            "replaces": f"src/repro/kernels/bus_attention.py{replaces}",
            "launches": launches[name] + train_launches[name]
            + ckpt_launches[name] + conv_launches[name]
            + quality_sum(name),
            "launches_by_path": {"serve": launches[name],
                                 "train": train_launches[name],
                                 "ckpt": ckpt_launches[name],
                                 "conventional": conv_launches[name],
                                 "quality": quality_by(name)},
            **on_route(ops, name, fn)})
    del qs_, ks_, vs_, ms_, dos_

    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the PQ scan (kernels/pq_scoring.py:pq_route), both kernels at each
    # shape (pq_shape_row): the main path's own inputs (the query batch's
    # LUT and codes gathered off the built snapshot above, N = nprobe *
    # cap, and the same LUT against codes shared by the batch) and the
    # deployment shapes over PROD's corpus of 1,204,224 news, seeded
    # (launch.serve.pq_scan_inputs): IVF (nlist 64, nprobe 16, cap 32,768:
    # N = 524,288) and flat (codes [1, 1,204,224, 8] for 16 queries)
    n_sub, n_codes = snap.pq_centers.shape[:2]
    shared = torch.randint(0, n_codes, (1, codes.shape[1], n_sub),
                           generator=g, device=dev).to(torch.uint8)
    pq = {"main": pq_shape_row(torch, ops, lut, codes, valid, 100, 20),
          "main_shared_codes": pq_shape_row(torch, ops, lut, shared, valid,
                                            100, 20)}
    for label, nprobe in (("deploy_ivf", 16), ("deploy_flat", None)):
        x = pq_scan_inputs(cfg.cache.n_news, batch=BATCH, n_subvec=n_sub,
                           n_codes=n_codes, nprobe=nprobe, gen=g, device=dev)
        pq[label] = {**{k: x[k] for k in ("nlist", "cap", "N") if k in x},
                     **pq_shape_row(torch, ops, x["lut"], x["codes"],
                                    x["valid"], 50, 3)}
        del x
    print("pq: " + json.dumps(pq), flush=True)
    pq_launches = {n: {"serve": launches[n], "train": train_launches[n],
                       "serve_front": front_launches[n],
                       "mesh": mesh_pq[n]}
                   for n in ("pq_lut_scores", "pq_lut_scores_general")}
    main = pq["main"]
    for name, ms_key, err_key in (
            ("pq_lut_scores", "ms", "pq_lut_scores_err"),
            ("pq_lut_scores_general", "general_ms",
             "pq_lut_scores_general_err")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pq_scoring.cu",
            "replaces": "src/repro/kernels/pq_scoring.py:99",
            "launches": sum(pq_launches[name].values()),
            "launches_by_path": pq_launches[name],
            "max_abs_err": max(r[k] for r in pq.values() for k in r
                               if k.startswith(err_key)),
            "ms": main[ms_key], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"], "dtype": "float32/uint8",
            "shapes": {label: {k: v for k, v in r.items()
                               if not k.endswith("_err")}
                       for label, r in pq.items()},
            **({"ptxas": report["hopper"][PQ_LIB]["ptxas"],
                "sass": report["hopper"][PQ_LIB]["sass"]}
               if name == "pq_lut_scores" else {})})

    # flash attention at Qwen3-14B's heads, on the three routes of the
    # forward (kernels/flash_attention.py:forward_route): the Hopper kernel
    # for bf16 and the 3xTF32 kernel for f32 at head dim 128, the SIMT
    # kernel at other head dims. Each against plain at S=4,096 (f32 on
    # 3xTF32, bf16 on Hopper, and a bf16 Sq = S/4 causal shape; the SIMT
    # kernel in f32 at head dim 96 and bf16 at 80); the Hopper kernel timed
    # at the prefill shape, S=32,768, whose launch is also held to plain by
    # row windows (an unsliced plain call there would need 172 GB of
    # scores; plain's time is taken at S=4,096), and, below, at the train
    # shape; the 3xTF32 kernel timed at S=4,096 in f32, in turns against
    # the SIMT kernel named on the same call; the SIMT kernel also timed
    # at head dim 96
    Hq, Hkv, Dh = qcfg.n_heads, qcfg.n_kv, qcfg.hd
    G = Hq // Hkv

    def qkv(B, Sq, Sk, dtype, D=Dh):
        return tuple(torch.randn(B, n, h, D, generator=g, device=dev)
                     .to(dtype) for n, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))

    def hold(label, o, lse, q, k, v, dtype):
        flash_err[label] = flash_fwd_errors(o, lse, q, k, v, dtype, label)

    def launch_on(q, k, v):
        """flash_attention_cuda(q, k, v, causal), checked to have launched
        one kernel, on the route forward_route picks."""
        b0 = ops.launch_counts()
        out = flash_attention_cuda(q, k, v, True)
        now = ops.launch_counts()
        got = {n: now[n] - b0[n] for n in FLASH_FWD}
        want = flash_fwd_launches(q.dtype, q.shape[-1], 1)
        check(got == want,
              f"flash forward on {q.dtype} went {got}, expected {want}")
        return out

    def sdpa_fwd_ms(q, k, v, **kw):
        """SDPA's causal forward on the same data, kv heads repeated for
        the groups ([B, H, S, D] copies made outside the timing)."""
        qs = q.transpose(1, 2).contiguous()
        ks = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vs = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        return time_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=True),
                       **kw)

    def sdpa_bwd_ms(q, k, v, do, **kw):
        """The backward alone of SDPA's causal GQA attention on the same
        data ([B, H, S, D] copies made outside the timing)."""
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dos = do.transpose(1, 2).contiguous()
        o_sdpa = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
        return time_ms(torch, lambda: torch.autograd.grad(
            o_sdpa, (qs, ks, vs), dos, retain_graph=True), **kw)

    flash_err = {}
    for label, Sq, dtype in (("float32", FLASH_CHECK_SEQ, torch.float32),
                             ("bfloat16", FLASH_CHECK_SEQ, bf16),
                             ("bfloat16_sq_quarter", FLASH_CHECK_SEQ // 4,
                              bf16)):
        q, k, v = qkv(1, Sq, FLASH_CHECK_SEQ, dtype)
        o, lse = launch_on(q, k, v)
        hold(label, o, lse, q, k, v, dtype)
        if label == "float32":
            # the 3xTF32 row: f32 at S=4,096, in turns against the SIMT
            # kernel named on the same inputs (the route f32 took before);
            # the bound is three TF32 products a pair on the tensor cores
            # (the f32 rate of the CUDA cores beside it)
            turns = [(r, time_ms(torch, lambda: flash_attention_cuda(
                q, k, v, True, route=r), iters=n, warmup=1))
                for r, n in (("flash_attention", 3),
                             ("flash_attention_tf32", 20),
                             ("flash_attention_tf32", 20),
                             ("flash_attention", 3))]
            tf32 = {
                "ms": (turns[1][1] + turns[2][1]) / 2,
                "simt_ms": (turns[0][1] + turns[3][1]) / 2,
                "turns_ms": turns,
                "plain_ms": time_ms(
                    torch, lambda: flash_attention_fwd_plain(q, k, v, True),
                    iters=3, warmup=1),
                "library_ms": sdpa_fwd_ms(q, k, v, iters=10, warmup=2)}
            w = flash_work(q, k)
            tf32["bound_ms"], tf32["bound_by"] = bound_ms(
                w, rl.TF32_FLOP_PER_S, products=3)
            tf32["bound_f32_cuda_cores_ms"] = bound_ms(w)[0]
            tf32["tflop_per_s"] = w["flops"] / tf32["ms"] / 1e9
        if label == "bfloat16":
            plain_ms = time_ms(
                torch, lambda: flash_attention_fwd_plain(q, k, v, True),
                iters=3, warmup=1)
        del o, lse
    # the SIMT forward at shapes still on its route, counted from 0: f32 at
    # head dim 96 (timed, bound at the f32 rate) and bf16 at head dim 80
    simt_err = {}
    ops.reset_launch_counts()
    for label, dt, D in SIMT_CHECKS:
        q, k, v = qkv(1, FLASH_CHECK_SEQ, FLASH_CHECK_SEQ, getattr(torch, dt),
                      D)
        o, lse = launch_on(q, k, v)
        hold(label, o, lse, q, k, v, getattr(torch, dt))
        simt_err[label] = flash_err.pop(label)
        if dt == "float32":
            simt = {
                "ms": time_ms(torch, lambda: flash_attention_cuda(q, k, v,
                                                                  True),
                              iters=3, warmup=1),
                "plain_ms": time_ms(
                    torch, lambda: flash_attention_fwd_plain(q, k, v, True),
                    iters=3, warmup=1),
                "library_ms": sdpa_fwd_ms(q, k, v, iters=3, warmup=1),
                "shape": [1, FLASH_CHECK_SEQ, FLASH_CHECK_SEQ, Hq, Hkv, D],
                "dtype": dt}
            w = flash_work(q, k)
            simt["bound_ms"], simt["bound_by"] = bound_ms(w)
            simt["tflop_per_s"] = w["flops"] / simt["ms"] / 1e9
        del q, k, v, o, lse
    simt_check_launches = ops.launch_counts()["flash_attention"]
    S, R = LM_PREFILL_SEQ, FLASH_ROWS
    q, k, v = qkv(1, S, S, bf16)
    o, lse = launch_on(q, k, v)
    # the first, a middle and the last R rows: row i of a window starting
    # at r0 sees keys [0, r0 + i], so plain on k/v[:, :r0 + R] computes
    # exactly those rows (q_off = r0)
    for name, r0 in (("first", 0), ("middle", S // 2), ("last", S - R)):
        hold(f"prefill_shape_rows_{name}", o[:, r0:r0 + R],
             lse[:, :, r0:r0 + R], q[:, r0:r0 + R], k[:, :r0 + R],
             v[:, :r0 + R], bf16)
    flash_ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, True),
                       iters=10, warmup=2)
    sdpa_ms = sdpa_fwd_ms(q, k, v, iters=5, warmup=2)
    prefill_work = flash_work(q, k)
    b_ms, b_by = bound_ms(prefill_work, rl.BF16_FLOP_PER_S)
    del q, k, v, o, lse
    # the lm-moe prefills' own launches: DBRX's global layers at 48/8
    # heads over S=32,768, and Scout's chunked-local ones, the route's
    # one launch over its four hard chunks of 8,192 at 40/8 heads ([4,
    # 8,192] views of the [1, 32,768] projections); each held to plain on
    # the first, a middle and the last FLASH_ROWS rows (of the last
    # chunk), and timed beside SDPA's causal GQA forward on the same data
    moe_shapes = {}
    for label, mcfg_l in (("dbrx_global", lm_family.DBRX_132B),
                          ("scout_chunked", lm_family.LLAMA4_SCOUT)):
        Hm, c = mcfg_l.n_heads, mcfg_l.chunk_size or S
        q = torch.randn(1, S, Hm, Dh, generator=g, device=dev).to(bf16)
        k, v = (torch.randn(1, S, Hkv, Dh, generator=g, device=dev).to(bf16)
                for _ in range(2))
        qc, kc, vc = (t.view(S // c, c, t.shape[2], Dh) for t in (q, k, v))
        o, lse = launch_on(qc, kc, vc)
        j = S // c - 1
        for name, r0 in (("first", 0), ("middle", c // 2), ("last", c - R)):
            hold(f"{label}_rows_{name}", o[j:, r0:r0 + R],
                 lse[j:, :, r0:r0 + R], qc[j:, r0:r0 + R], kc[j:, :r0 + R],
                 vc[j:, :r0 + R], bf16)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (qc, kc, vc))
        m_ms = time_ms(torch, lambda: flash_attention_cuda(qc, kc, vc, True),
                       iters=10, warmup=2)
        w = flash_work(qc, kc)
        moe_shapes[label] = {
            "ms": m_ms, "library_ms": time_ms(
                torch, lambda: sdpa(qs, ks, vs, is_causal=True,
                                    enable_gqa=True), iters=5, warmup=2),
            "shape": [S // c, c, c, Hm, Hkv, Dh], "dtype": "bfloat16",
            "tflop_per_s": w["flops"] / m_ms / 1e9}
        moe_shapes[label]["bound_ms"], moe_shapes[label]["bound_by"] = \
            bound_ms(w, rl.BF16_FLOP_PER_S)
        del q, k, v, qc, kc, vc, o, lse, qs, ks, vs
    report["lm_moe"]["flash_shapes"] = moe_shapes
    print("lm-moe flash shapes: " + json.dumps(moe_shapes), flush=True)

    def moe_main(sym):
        """The lm-moe phase's main-path launches of ``sym``, by config and
        run (timed prefill, decode runs)."""
        return {name: {run: n[sym] for run, n in runs.items()}
                for name, runs in moe_launches.items()}

    def moe_sum(sym):
        return sum(sum(r.values()) for r in moe_main(sym).values())

    def moe_checks(sym):
        """The lm-moe phase's check launches of ``sym``, each counted from
        0: the chunked route against plain, layer by layer (bf16) and the
        f32 prefills at the reduced depth."""
        lmm = report["lm_moe"]
        out = {f"chunked_route_{dt}": n[sym] for dt, n in
               lmm["chunked_route"]["launches"].items()}
        for name in moe_launches:
            out[f"{name}_by_layer"] = \
                lmm[name]["by_layer"]["flash_launches"][sym]
            out[f"{name}_check_float32"] = \
                lmm[name]["check"]["flash_launches"][sym]
        return out

    def fwd_launches(sym):
        return {"prefill": prefill_launches[sym],
                "decode": lm_rep["decode"]["flash_launches"][sym],
                "lm_moe": moe_main(sym),
                "lm_train": lm_train_launches[sym],
                "serve": launches[sym], "train": train_launches[sym]}

    kernels.append({
        "name": "flash_attention_tf32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tf32.cu",
        "replaces": "src/repro/kernels/flash_attention.py:146",
        # the main paths run bf16 at head dim 128, the Hopper kernel's
        # route, so this is 0; the f32 checks' launches, each counted from
        # 0, are apart under check_launches
        "launches": prefill_launches["flash_attention_tf32"]
        + lm_train_launches["flash_attention_tf32"]
        + moe_sum("flash_attention_tf32"),
        "check_launches": {
            "lm_check_float32": lm_rep["check"]["float32"]["flash_launches"]
            ["flash_attention_tf32"],
            "lm_train_float32_depth2": report["lm_train"]["plain"]
            ["launches_kernel"]["flash_attention_tf32"],
            "lm_moe": moe_checks("flash_attention_tf32")},
        "launches_by_path": fwd_launches("flash_attention_tf32"),
        "max_abs_err": flash_err["float32"]["o"],
        "errors": {"float32": flash_err["float32"]},
        **tf32,
        "shape": [1, FLASH_CHECK_SEQ, FLASH_CHECK_SEQ, Hq, Hkv, Dh],
        "dtype": "float32", "causal": True,
        **report["hopper"][TF32_LIB]})
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:146",
        # of the paths here only the registry's reduced LM smokes (head
        # dim 16, f32) reach the SIMT forward, added below with their
        # holds; the full configs' head dim is 128. Its own checks'
        # launches, counted from 0, are apart under check_launches
        "launches": prefill_launches["flash_attention"]
        + lm_train_launches["flash_attention"]
        + moe_sum("flash_attention"),
        "check_launches": {"simt_checks": simt_check_launches},
        "launches_by_path": fwd_launches("flash_attention"),
        "max_abs_err": max(e["o"] for e in simt_err.values()),
        "errors": simt_err, **simt, "causal": True})
    kernels.append({
        "name": "flash_attention_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:146",
        "launches": prefill_launches["flash_attention_wgmma"]
        + lm_train_launches["flash_attention_wgmma"]
        + moe_sum("flash_attention_wgmma"),
        "launches_by_path": fwd_launches("flash_attention_wgmma"),
        "check_launches": {"lm_moe": moe_checks("flash_attention_wgmma")},
        "max_abs_err": max(e["o"] for n, e in flash_err.items()
                           if n != "float32"),
        "errors": {n: e for n, e in flash_err.items() if n != "float32"},
        "ms": flash_ms, "plain_ms": plain_ms,
        "plain_shape": [1, FLASH_CHECK_SEQ, FLASH_CHECK_SEQ, Hq, Hkv, Dh],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": sdpa_ms,
        "tflop_per_s": prefill_work["flops"] / flash_ms / 1e9,
        "shape": [1, S, S, Hq, Hkv, Dh], "dtype": "bfloat16",
        "causal": True, "lm_moe_shapes": moe_shapes,
        **report["hopper"]["flash_attention_wgmma"]})
    flash_row = kernels[-1]
    report["lm"]["flash_ms_per_prefill"] = qcfg.n_layers * flash_ms
    report["lm"]["flash_share_of_prefill"] = (
        qcfg.n_layers * flash_ms / 1e3 / report["lm"]["prefill"]["s"])

    # the flash backward at the LM training shape (B=2, S=4,096), against
    # plain on the same saved o/lse, on each route (backward_route): f32 on
    # the 3xTF32 pair, within 1e-4 of each plain gradient's largest beside
    # a dropped-key-tile control that must miss it, launched twice bit for
    # bit, and timed in turns against the SIMT pair named on the same call;
    # bf16 on the Hopper pair, its f32 gradients before the cast and their
    # casts, beside the dropped-key-tile controls (bwd_hopper_errors). Each
    # route is timed, with the wrapper's cast, beside plain and SDPA's
    # causal GQA backward in the same dtype
    Bt, St = lm_family.ONE_CARD_TRAIN["batch"], \
        lm_family.LM_SHAPES["train_4k"]["seq"]
    bwd = {}
    for dtype in (torch.float32, bf16):
        name = str(dtype)[6:]
        q, do = (torch.randn(Bt, St, Hq, Dh, generator=g, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(Bt, St, Hkv, Dh, generator=g, device=dev)
                .to(dtype) for _ in range(2))
        # o and lse from the forward's own route: bf16 from the Hopper
        # kernel, f32 from the 3xTF32 one
        o, lse = launch_on(q, k, v)
        ops.reset_launch_counts()
        got = _bwd_cuda_as_written(q, k, v, o, lse, do, True)
        went = {n: ops.launch_counts()[n] for n in FLASH_BWD}
        exp = _bwd_plain_f32(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        check(went == flash_bwd_launches(dtype, Dh, 1),
              f"flash backward on {dtype} went {went}")
        if dtype == bf16:
            e = bwd_hopper_errors(q, k, v, o, lse, do, got, exp, name)
        else:
            check(backward_route(dtype, Dh) == BWD_TF32,
                  f"f32 at head dim {Dh} is routed to "
                  f"{backward_route(dtype, Dh)}")
            e = bwd_f32_errors(q, k, v, o, lse, do, got, exp, name)
            again = _bwd_cuda_as_written(q, k, v, o, lse, do, True)
            e["bitwise_repeat"] = all(torch.equal(a, b)
                                      for a, b in zip(got, again))
            check(e["bitwise_repeat"],
                  "two 3xTF32 flash backward launches differ")
            del again
        del got, exp
        r = {"errors": e,
             "plain_ms": time_ms(torch, lambda: flash_attention_bwd_plain(
                 q, k, v, o, lse, do, True), iters=2, warmup=1),
             "library_ms": sdpa_bwd_ms(q, k, v, do, iters=5, warmup=2)}
        w = flash_work(q, k, backward=True)
        if dtype == bf16:
            # the function's five products at the bf16 tensor-core rate
            r["ms"] = time_ms(torch, lambda: flash_attention_bwd_cuda(
                q, k, v, o, lse, do, True), iters=5, warmup=1)
            r["bound_ms"], r["bound_by"] = bound_ms(w, rl.BF16_FLOP_PER_S)
        else:
            # the 3xTF32 pair in turns against the SIMT pair named on the
            # same inputs (the route f32 took before); bounded by three
            # TF32 products a pair on the tensor cores, and by the f32 rate
            # of the CUDA cores (the SIMT pair's floor)
            turns = [(r_name, time_ms(torch, lambda: flash_attention_bwd_cuda(
                q, k, v, o, lse, do, True, route=pair), iters=n, warmup=1))
                for r_name, pair, n in (("simt", BWD_SIMT, 2),
                                        ("tf32", BWD_TF32, 5),
                                        ("tf32", BWD_TF32, 5),
                                        ("simt", BWD_SIMT, 2))]
            r["ms"] = (turns[1][1] + turns[2][1]) / 2
            r["simt_ms"] = (turns[0][1] + turns[3][1]) / 2
            r["turns_ms"] = turns
            r["bound_ms"], r["bound_by"] = bound_ms(w, rl.TF32_FLOP_PER_S,
                                                    products=3)
            r["bound_f32_cuda_cores_ms"] = bound_ms(w)[0]
        r["tflop_per_s"] = w["flops"] / r["ms"] / 1e9
        bwd[name] = r
        if dtype != bf16:
            del q, k, v, o, lse, do
    # the SIMT pair on its own route (SIMT_BWD_CHECKS), counted from 0:
    # held as the 3xTF32 pair is and timed, at the train shape's batch and
    # heads
    simt_bwd, simt_bwd_launches = {}, {}
    for label, dt, D in SIMT_BWD_CHECKS:
        dtype = getattr(torch, dt)
        qd, dod = (torch.randn(Bt, St, Hq, D, generator=g, device=dev)
                   .to(dtype) for _ in range(2))
        kd, vd = (torch.randn(Bt, St, Hkv, D, generator=g, device=dev)
                  .to(dtype) for _ in range(2))
        od, lsed = launch_on(qd, kd, vd)
        ops.reset_launch_counts()
        got = _bwd_cuda_as_written(qd, kd, vd, od, lsed, dod, True)
        simt_bwd_launches[label] = {n: ops.launch_counts()[n]
                                    for n in FLASH_BWD}
        exp = _bwd_plain_f32(qd, kd, vd, od, lsed, dod, True)
        check(simt_bwd_launches[label] == flash_bwd_launches(dtype, D, 1)
              and backward_route(dtype, D) == BWD_SIMT,
              f"flash backward at {label} went {simt_bwd_launches[label]}")
        e = bwd_f32_errors(qd, kd, vd, od, lsed, dod, got, exp,
                           f"SIMT {label}")
        del got, exp
        w = flash_work(qd, kd, backward=True)
        r = {"errors": e,
             "ms": time_ms(torch, lambda: flash_attention_bwd_cuda(
                 qd, kd, vd, od, lsed, dod, True), iters=2, warmup=1),
             "plain_ms": time_ms(torch, lambda: flash_attention_bwd_plain(
                 qd, kd, vd, od, lsed, dod, True), iters=1, warmup=1),
             "library_ms": sdpa_bwd_ms(qd, kd, vd, dod, iters=3, warmup=1),
             "shape": [Bt, St, St, Hq, Hkv, D], "dtype": dt}
        r["bound_ms"], r["bound_by"] = bound_ms(w)
        r["bound_3xtf32_ms"] = bound_ms(w, rl.TF32_FLOP_PER_S, products=3)[0]
        r["tflop_per_s"] = w["flops"] / r["ms"] / 1e9
        simt_bwd[label] = r
        del qd, kd, vd, od, lsed, dod

    def by_path(sym):
        return {"lm_train": lm_train_launches[sym],
                "prefill": prefill_launches[sym], "serve": launches[sym],
                "train": train_launches[sym]}

    shape = {"shape": [Bt, St, St, Hq, Hkv, Dh], "causal": True}
    lt = report["lm_train"]
    kernels.append({
        "name": "flash_attention_bwd_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:281",
        "launches": lm_train_launches["flash_attention_bwd_dq_wgmma"]
        + lm_train_launches["flash_attention_bwd_dkv_wgmma"],
        # the layer-0 check's launches, counted from 0, are apart
        "check_launches": {"lm_train_layer0": {
            n: lt["layer0_bwd"]["launches"][n]
            for n in ("flash_attention_bwd_dq_wgmma",
                      "flash_attention_bwd_dkv_wgmma")}},
        "launches_by_path": {
            "dq": by_path("flash_attention_bwd_dq_wgmma"),
            "dkv": by_path("flash_attention_bwd_dkv_wgmma")},
        "max_abs_err": max(bwd["bfloat16"]["errors"][n]
                           for n in ("dq", "dk", "dv")),
        "layer0_errors": {n: x for n, x in lt["layer0_bwd"].items()
                          if n not in ("launches", "shape")},
        **bwd["bfloat16"], **shape, "dtype": "bfloat16",
        **report["hopper"]["flash_attention_bwd_wgmma"]})
    f32_bwd = bwd["float32"]
    kernels.append({
        "name": "flash_attention_bwd_tf32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tf32.cu",
        "replaces": "src/repro/kernels/flash_attention.py:281",
        # the main paths run bf16 at head dim 128, the Hopper pair's
        # route, so this is 0; the f32 checks' launches, each counted from
        # 0, are apart under check_launches
        "launches": sum(lm_train_launches[n] for n in BWD_TF32),
        "check_launches": {
            "lm_train_float32_depth2": {
                n: lt["plain"]["launches_kernel"][n] for n in BWD_TF32},
            "train_shape_float32": {n: 1 for n in BWD_TF32}},
        "launches_by_path": {"dq": by_path(BWD_TF32[0]),
                             "dkv": by_path(BWD_TF32[1])},
        "max_abs_err": max(f32_bwd["errors"][n] for n in ("dq", "dk", "dv")),
        **{n: x for n, x in f32_bwd.items() if n != "turns_ms"},
        "turns_ms": f32_bwd["turns_ms"], **shape, "dtype": "float32",
        **report["hopper"][TF32_BWD_LIB]})
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:281",
        # of the paths here only the registry's reduced LM smokes (head dim
        # 16, f32) reach the SIMT pair, added below with their holds; its
        # own check at head dim 96, counted from 0, is apart under
        # check_launches. Its time at the train shape is the turns' (the
        # pair named on the 3xTF32 route's call), beside the same plain,
        # SDPA and bounds; at head dim 96, on its own route, under
        # own_route
        "launches": sum(lm_train_launches[n] for n in BWD_SIMT),
        "check_launches": {"simt_bwd_checks": {
            label: {n: c[n] for n in BWD_SIMT}
            for label, c in simt_bwd_launches.items()}},
        "launches_by_path": {"dq": by_path(BWD_SIMT[0]),
                             "dkv": by_path(BWD_SIMT[1])},
        "max_abs_err": max(r["errors"][n] for r in simt_bwd.values()
                           for n in ("dq", "dk", "dv")),
        "ms": f32_bwd["simt_ms"], "plain_ms": f32_bwd["plain_ms"],
        "library_ms": f32_bwd["library_ms"],
        "bound_ms": f32_bwd["bound_f32_cuda_cores_ms"],
        "bound_by": "operations", "bound_3xtf32_ms": f32_bwd["bound_ms"],
        "tflop_per_s": f32_bwd["tflop_per_s"] * f32_bwd["ms"]
        / f32_bwd["simt_ms"],
        "own_route": simt_bwd, **shape, "dtype": "float32"})
    bwd_ms = bwd["bfloat16"]["ms"]
    layers_t = lt["layers"]
    lt["flash_bwd_ms_per_step"] = layers_t * bwd_ms
    lt["flash_bwd_share_of_step"] = (layers_t * bwd_ms / 1e3
                                     / lt["s_per_step"])
    # the Hopper forward at the train shape, on the bf16 q/k/v above; a
    # step launches it twice a layer (forward and remat recompute)
    tr = {"ms": time_ms(torch, lambda: flash_attention_cuda(q, k, v, True),
                        iters=10, warmup=2),
          "library_ms": sdpa_fwd_ms(q, k, v, iters=10, warmup=2),
          "shape": [Bt, St, St, Hq, Hkv, Dh]}
    w = flash_work(q, k)
    tr["bound_ms"], tr["bound_by"] = bound_ms(w, rl.BF16_FLOP_PER_S)
    tr["tflop_per_s"] = w["flops"] / tr["ms"] / 1e9
    flash_row["train_shape"] = tr
    lt["flash_fwd_ms_per_step"] = 2 * layers_t * tr["ms"]
    lt["flash_fwd_share_of_step"] = (2 * layers_t * tr["ms"] / 1e3
                                     / lt["s_per_step"])
    del q, k, v, o, lse, do

    # the EmbeddingBag row, timed in the recsys phase at serve_bulk's shape
    rs = report["recsys"]
    rs_launches = {f"{name} {cell}": rs[name][cell]["launches"]
                   for name in ("dlrm-rm2", "wide-deep", "dcn-v2", "bert4rec")
                   for cell in ("serve_p99", "serve_bulk", "retrieval_cand")
                   if isinstance(rs[name].get(cell), dict)
                   and "launches" in rs[name][cell]}
    ebag_row["launches"] = sum(rs_launches.values()) + sum(
        rs_train_fwd.values())
    ebag_row["launches_by_path"] = {
        "recsys": rs_launches, "recsys_train": rs_train_fwd,
        "serve": launches["embedding_bag"],
        "train": train_launches["embedding_bag"],
        "lm_prefill": prefill_launches["embedding_bag"]}
    kernels.append(ebag_row)
    # its backward, checked and timed in the recsys-train phase
    rt = report["recsys_train"]
    ebag_bwd_row["launches_by_path"] = {
        "recsys_train": {name: rt[name]["launches"]["embedding_bag_bwd"]
                         for name in ("dlrm-rm2", "wide-deep", "dcn-v2",
                                      "bert4rec")},
        "serve": launches["embedding_bag_bwd"],
        "train": train_launches["embedding_bag_bwd"],
        "lm_prefill": prefill_launches["embedding_bag_bwd"]}
    ebag_bwd_row["launches"] = sum(
        ebag_bwd_row["launches_by_path"]["recsys_train"].values())
    kernels.append(ebag_bwd_row)

    # every row gains the registry phase's launches, by arch (the flash
    # backward rows count their dq and dk/dv kernels together)
    for row in kernels:
        syms = ROW_COUNTERS.get(row["name"], (row["name"],))
        by_arch = {a: sum(c.get(sym, 0) for sym in syms)
                   for a, c in registry_launches.items()}
        by_arch = {a: n for a, n in by_arch.items() if n}
        row.setdefault("launches_by_path", {})["registry"] = by_arch
        row["launches"] += sum(by_arch.values())
        # and its holds at the smokes' shapes, their launches apart
        mine = [h for h in registry_holds if set(h["launches"]) & set(syms)]
        if mine:
            row["registry_shapes"] = mine
            row.setdefault("check_launches", {})["registry_shapes"] = sum(
                h["launches"].get(sym, 0) for h in mine for sym in syms)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     *(h["max_abs_err"] for h in mine))
        # and the roofline phase's measured cells', by cell
        by_cell = {c: sum(n.get(sym, 0) for sym in syms)
                   for c, n in roofline_launches.items()}
        by_cell = {c: n for c, n in by_cell.items() if n}
        row["launches_by_path"]["roofline"] = by_cell
        row["launches"] += sum(by_cell.values())
        # and the lm-mesh phase's bf16 runs, by rank
        by_rank = [sum(c.get(sym, 0) for sym in syms)
                   for c in lm_mesh_launches]
        if any(by_rank):
            row["launches_by_path"]["lm_mesh"] = by_rank
            row["launches"] += sum(by_rank)
        # and the recsys-mesh phase's runs, by rank, and their first
        # EmbeddingBag calls held to plain in the ranks, apart
        by_rank = [sum(c.get(sym, 0) for sym in syms)
                   for c in rs_mesh_launches]
        if any(by_rank):
            row["launches_by_path"]["recsys_mesh"] = by_rank
            row["launches"] += sum(by_rank)
            by_rank = [sum(c.get(sym, 0) for sym in syms)
                       for c in rs_mesh_held]
            row.setdefault("check_launches", {})["recsys_mesh_holds"] = \
                by_rank
            h = report["recsys_mesh"]["ebag_holds"][
                row["name"] + "_cuda"]
            row["recsys_mesh_holds"] = h
            row["max_abs_err"] = max(row["max_abs_err"], h["max_abs_err"])
        # and those runs' flash calls held to plain in the ranks, apart
        by_rank = [sum(c.get(sym, 0) for sym in syms) for c in lm_mesh_held]
        if any(by_rank):
            row.setdefault("check_launches", {})["lm_mesh_bf16_holds"] = \
                by_rank
            fb = "bwd" if row["name"] == "flash_attention_bwd_wgmma" \
                else "fwd"
            mine = {k: h[fb] for k, h in
                    report["lm_mesh"]["flash_holds"].items() if fb in h}
            row["lm_mesh_holds"] = mine
            row["max_abs_err"] = max(
                row["max_abs_err"], *(max(h[n] for n in ("dq", "dk", "dv"))
                                      if fb == "bwd" else h["o"]
                                      for h in mine.values()))

    # every flash row on the Hopper and 3xTF32 routes gains the head
    # plan's rank shapes held to plain (Hq 3 and 2 over one KV head), their
    # launches apart
    for row in kernels:
        syms = ROW_COUNTERS.get(row["name"], (row["name"],))
        n = sum(group_launches.get(sym, 0) for sym in syms)
        if not n:
            continue
        row.setdefault("check_launches", {})["flash_groups"] = n
        dt = "bfloat16" if "wgmma" in row["name"] else "float32"
        fb = "bwd" if "bwd" in row["name"] else "fwd"
        mine = {k: e[fb] for k, e in report["flash_groups"].items()
                if k.endswith(dt)}
        row["flash_groups"] = mine
        row["max_abs_err"] = max(
            row["max_abs_err"], *(max(h[n_] for n_ in ("dq", "dk", "dv"))
                                  if fb == "bwd" else h["o"]
                                  for h in mine.values()))
    want_groups = len(FLASH_GROUP_HQ)
    for dt, fwd, bwd in (("bfloat16", "flash_attention_wgmma",
                          ("flash_attention_bwd_dq_wgmma",
                           "flash_attention_bwd_dkv_wgmma")),
                         ("float32", "flash_attention_tf32",
                          ("flash_attention_bwd_dq_tf32",
                           "flash_attention_bwd_dkv_tf32"))):
        check(group_launches.get(fwd, 0) == want_groups and all(
            group_launches.get(b, 0) == want_groups for b in bwd),
            f"flash-groups: {dt} launched {group_launches}")

    mark("report")
    report["kernels"] = kernels
    report["card"] = card
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
