#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sessionsimilaritysearch_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (nvcc, first use), then:

1. device   -- a CUDA device must be visible; otherwise exit 1, no result;
2. kernel   -- K1, the fused score + bucket-max kernel, against its plain
               PyTorch version: ragged cases (q=37, n=5003; f32 at d=200 on
               the f32 wgmma variant csrc/scores_bmax_f32_sm90.cu and at
               d=202 on the tile variant csrc/scores_bmax.cu, bf16 at d=200
               on the wgmma variant csrc/scores_bmax_sm90.cu, bf16 at d=250
               and at d=1600 with the corpus 4 bytes off 16-byte alignment
               on the cp_async variant, the same kernel fed by cp.async
               (csrc/sm90_cp_async.cuh); valid_count
               mid-bucket; 10% of rows masked by the penalty) and the bench
               point (q=1024, n=2^20, d=1600, bf16, k=100, wgmma variant)
               beside one cuBLAS bf16 GEMM, timed with CUDA events;
3f. f32 index -- DenseIndex(1600, 2^20) with the default f32 storage and
               scores, filled with 2^20 seeded rows, searched with 1024
               queries at k=100: the f32 wgmma K1 launched 16 times per
               search; value-recall@10 >= 0.999 against the f64 numpy oracle
               on a 65,536-row subcorpus; the kernel against its plain
               version on one chunk; best-of-3 time and a torch.profiler
               breakdown of one search; the index is freed before phase 3;
3. index    -- DenseIndex(1600, 2^20, bf16 storage and scores) filled with
               2^20 seeded unit rows, searched with 1024 queries at k=100:
               the wgmma K1 launched 16 times per search (one per
               65,536-row chunk); value-recall@10 >= 0.999 against the f64
               numpy oracle on a 65,536-row subcorpus at two bf16 ulps; the
               kernel against its plain version on one chunk as search()
               passes it;
4. engine   -- the flagship GraphLevelEncoder at Config() width with seeded
               random weights inside SessionSearchEngine (f32 storage, the
               default): ingest 8,192 synthetic sessions, search 256 of them
               at k=100 (every top-1 score within 1e-3 of 1.0); every K1
               launch the f32 wgmma variant, against its plain version on
               the engine's own f32 queries and corpus (d=1600) beside the
               tile loop, cuBLAS SGEMM (TF32 off) and its bound, and
               search()'s scores against the plain top-100; 8 sessions
               encoded on the card and on the CPU with the same weights
               must agree;
4d. dense maintenance -- the default f32 DenseIndex (cos) at 2^20 x 1600
               with 1024 queries at k=100, each verb timed with K1's
               launches (every one the f32 wgmma variant): remove_ids of
               65,536 random rows (512 moved slots hold the rows
               compaction_plan moved, bit for bit; then a search with
               value-recall@10 1.0 against a torch f64 oracle on 64 queries
               and no removed row returned), a refill of 65,536 rows into
               the freed capacity (each its own top-1 in its new slot),
               range_search of 64 queries at query 0's 200th best score
               (each depth timed; the hit sets those of the f64 oracle up to
               rows within 1e-5 of the radius), an l2 index of the same rows
               (K1 with the penalty -|c|^2; value-recall@10 1.0 against
               |q|^2 + |c|^2 - 2q.c in f64), merge_from of two 2^19 halves
               (the single build's top-k), and save / load at 2^18 x 1600
               (capture, write and load timed; the same top-k back);
4e. engine verbs -- phase 4's encoder and 8,192 sessions in a fresh f32
               engine: add_sessions_async of 8 stamped batches of 1,024
               while this thread answers 256-query searches (the rows then
               equal phase 4's), remove_sessions by 512 ids and by the
               content of 64 sessions, expire of the first batch's stamp
               (the stored sessions are the survivors; removed content never
               returns; 256 rows re-encoded from their sessions agree),
               hybrid search overlap/stan x score/rrf against a recompute of
               the fusion on the same candidates, range_search with where=
               against the f64 oracle, save_async while searches and an
               ingest go on, and restore into a fresh engine (the capture
               point's top-k);
4b. bf16 engine -- the same encoder and sessions in an engine with
               dtype=torch.bfloat16: ingest, search 256 at k=100 (top-1
               within two bf16 ulps of 1.0), every K1 launch the wgmma
               variant, which equals its plain version on the engine's own
               bf16 queries and rows (beside a cuBLAS bf16 GEMM);
4f. flagship serving -- the JAX package's serving recipe at Config() width:
               phase 4's encoder and sessions, bf16 serving_params, the
               catalog title table over all 391,572 titles and the keyword
               table over the sessions' keywords (time and bytes of each, for
               f32 and bf16 weights); on 256 sessions with products the cached
               forwards (title-only and fully cached) against the uncached one
               on the card (f32: rtol 1e-5, atol 1e-4 of the output scale;
               bf16: every row's cosine >= 0.999 and max |diff| <= 2^-6 of
               max |ref|), the card's bf16 cached forward and 256 title rows
               against the CPU's on the same weights and tables (bf16
               tolerance); the 8,192 sessions ingested bf16 uncached, bf16
               title-only and bf16 fully cached (sessions/s beside phase 4's
               f32 uncached rate); the fully cached engine (f32 DenseIndex)
               searched with 256 queries at k=100, every K1 launch from its
               ingest to its search the f32 wgmma variant, held against its
               plain version on the engine's inputs; one 256-session batch of
               the fully cached forward stage by stage (host graph build,
               keyword lookup, upload, node gather, GNN, pooling; host clock
               and torch.profiler device time); a product_pooling='recency'
               engine of 1,024 sessions on the same tables; no batch may take
               the out-of-vocabulary path;
4g. pretrain -- the port's pretrainer (training/pretrain.py) at Config()
               width, batch 50, 391,572 asins, seeded random weights:
               the uncached step (the CLI's path: upload, step, the loss
               read on the host) 3 warm-up and 20 timed steps on fresh
               batches (median and p90 ms, sessions/s, the loss curve, every
               loss finite), then one batch repeated 10 steps with the same
               draws (the loss must fall); run_training over 10 batches as
               shipped, with its drop buffer (nan_recovery) and with a host
               read of the loss between forward and backward, in
               alternating rounds; a torch.profiler breakdown of
               make_train_step itself by its record_function spans
               (sss.encoder.text, .gnn and .pooling, head + loss,
               backward, clip, adam:
               the device time of the kernels launched inside each), with
               the device's busy share of the median step; the
               cached-tables step (title table over all titles, keyword
               table) whose loss must equal the uncached one's (rel 1e-5),
               timed the same way; one step of 8 sessions on the card and on
               the CPU from the same state and draws: the loss within rel
               1e-5, and over every parameter leaf whose rms gradient is at
               least 1e-4 of the rms of all gradients (below, the gradient
               is rounding noise) the clipped gradient within |card - CPU|
               / |CPU| <= 1e-3 and the update's cosine >= 0.9999; a
               checkpoint (size, write and read time) restored into a fresh
               state, whose next step's loss and metrics equal the
               uninterrupted run's (rel 1e-6) with the same generator
               draws; then make_encode_fn over 8,192 sessions into an f32
               DenseIndex, 256 searched at k=100, every top-1 the session
               itself (or an identical embedding), every K1 launch the f32
               wgmma variant;
4h. session trainers -- the port's session trainers
               (training/session_trainers.py) at Config() width: the
               flagship subsession trainer (the production encoder, batch 50,
               391,572 asins, 1000 sampled negatives, seeded weights) for 3
               warm-up and 12 timed steps (median and p90 ms, sessions/s, every
               loss finite), one batch repeated 8 steps with the same draws
               (the loss must fall); one step each of the scratch subsession
               (autoregressive), scratch session (mlm_electra) and joint
               trainers at batch 50 (finite losses); for all four, one step of
               8 sessions on the card and on the CPU from the same weights,
               optimizer state and draws: the loss within rel 1e-5 and each
               held leaf's clipped gradient within |card - CPU| / |CPU| <=
               1e-3 (phase 4g's bounds); then the trained encoder in an f32
               SessionSearchEngine: 8,192 sessions ingested, 256 searched at
               k=100, every top-1 the session itself (or an identical
               embedding), every K1 launch from the ingest to the search the
               f32 wgmma variant;
4i. fine-tune -- the similarity fine-tuner (training/finetune.py) over the
               trained encoder's 1600-d embeddings: 256 triplets mined
               (data.similarity.mine_triplets, 2,000 db sessions),
               FinetuneHeads at code_len 250 with shared_init, 8 epochs of
               alternating steps (ms a step, the loss); the db codes of the
               8,192 sessions and the query codes of 256 test sessions served
               through evaluate_binary in sign mode (K1's cp_async variant)
               and packed mode (K4), each launched and each search's sorted
               Hamming distances equal to the plain f64 product's; ave type
               score@10 of the dense embeddings, the untrained and the
               trained codes printed, not gated;
4j. node-level encoders -- NodeLevelEncoder (models/encoder.py) at
               Config() width: the text backbone and the asin-id embedding
               (391,572 asins) under HGT (hidden 800, 4 heads, 3 layers:
               3,200-wide nodes) and under HeteroGGNN, seeded weights; a
               batch of 256 sessions on the card (median ms over 10 calls,
               CUDA events) and on the CPU from the same weights: the largest
               |card - CPU| over the largest |CPU| per node type at most
               1e-4 (TF32 off);
4k. cli -- the port's CLI (cli.py) at Config() width, not --tiny, driven
               in-process through cli.main on the card in a temporary
               directory deleted afterwards: pretrain, train-subsession and
               train-session (512 sessions, one epoch), finetune
               --from-pretrain on that pretrain run, evaluate in modes model
               (with --save-results), knn, hybrid and SKNN, --mode load of
               the saved results (the model run's report back), etl; each
               JSON line holds the JAX CLI's keys, every loss is finite,
               steps equals the train loader's batch count (10), evaluate's
               model and knn modes launch K1, every launch the f32 wgmma
               variant (n_out = 500 f32 rows); each subcommand's wall
               seconds; then `python -m sessionsimilaritysearch_tpu_torch.cli
               evaluate --mode model` in a subprocess without --device runs
               (on the card: the default), and the same with no card visible
               fails;
4c. f32 kernel -- K1's f32 wgmma variant at q=1024, n=2^20, d=1600 f32 ->
               f32 on seeded f32 unit rows against its plain version, timed
               in the same rounds as the tile loop (through its own C entry
               point) and cuBLAS SGEMM (TF32 off); the accuracy gate: on
               1024 unit queries x a 65,536-row unit subcorpus at d=1600 and
               on standard-normal rows at d=200, K1's and K6's largest
               |score - f64| at most twice SGEMM's;

5. packed kernel -- K4 (csrc/packed_scores_bmax.cu) against its plain
               version: a ragged case (q=37, three 2048-row pack blocks,
               250 and 384 bits, valid_count 5003, 10% masked) and the bench
               point (q=1024, n=2^20, 256 bits, bf16 scores); scores and
               bucket maxes equal, top-k distances equal; CUDA-event times;
6. hamming kernel -- K5's two variants, wgmma (csrc/hamming_bucket_min_sm90.cu)
               and popc (csrc/hamming_bucket_min.cu, through its C entry
               point), each equal bit for bit (torch.equal) to the plain
               version at widths W of 1, 3, 8, 13 and 53 words, q of 1, 37
               and 200, n of 1, 127, 5003 and 6144, without and with a
               penalty (10% of rows masked, a dead tail, one bucket wholly
               dead; at n=5003 also random int32 penalties, whose add
               wraps); misaligned views (c[5:], penalty[1:]) run popc
               through the wrapper; hamming_topk on a ragged, masked
               corpus against the CPU's; at the bench point (the same codes
               packed row-major, q=1024, n=2^20, 256 bits) both variants
               equal, wgmma, popc and K4 timed in three rounds in turns,
               and ops.hamming.hamming_topk (K5's path) launching the
               wgmma variant and giving the same top-100 distances as K4;
7. binary index -- BinaryIndex(250 bits, 2^20 rows), packed (K4) and sign
               (K1's cp_async variant: 250-wide rows are no TMA stride; its
               one K1 launch a search counted) modes, 1024 queries at k=100:
               sorted distances equal a plain f32 product over the same
               codes; at sign mode's shape (bf16 scores) K1's cp_async
               variant and its tile loop (through its C entry point), each
               equal to the plain version, timed in three rounds in turns
               with a cuBLAS bf16 GEMM and the plain version; the producer
               ablation: the cp_async variant (through its C entry point)
               beside the TMA-fed wgmma variant at d=256, the same products
               and epilogue, in the same rounds, both equal to the plain
               version;
7b. binary maintenance -- BinaryIndex(256 bits, 2^20 rows), packed (K4)
               and sign (K1's wgmma variant), 1024 queries at k=100:
               remove_ids of 1% of the rows (scattered), a refill of as many,
               range_search of 64 queries at query 0's 100th distance, save /
               load (32 MB of packed words; 256 MB of int8 sign rows), and
               merge_from of two 2^19 halves across modes, each timed; after
               each verb the buffer equals that of a fresh index built from
               the surviving codes word for word (the freed packed slots
               zero), the search's sorted distances equal the fresh one's,
               and range_search's hits equal the plain distances' below the
               radius;
8. two-stage index -- every tier of TwoStageIndex at 2^20 x 1600 bf16 rows,
               one index at a time, 1024 queries planted at cosine ~0.9 to
               stored rows, k=100, pools 128 and 512: 'binary' + 'matmul' at
               256 bits (K1 wgmma), 'itq' + 'matmul' at 250 bits (K1 cp_async;
               ITQ and PCA fitted on a 32,768-row sample), 'int8x8' (K2
               wgmma, bf16 scores), 'pca' at 64 (K1 wgmma) and 'itq' +
               'packed' (K4). Per tier and pool: the pool's stage-1 scores
               hold value recall 1.0 at two bf16 ulps against the top-pool of
               the plain stage 1 on the same codes, the top-100 equals the
               exact (f64) re-rank of the pool within 1e-5, every planted row
               is the top-1; stage-1, re-rank (CUDA events) and total (host
               clock, best of 3) times and QPS; the stage-1 kernel alone
               beside its bound; the launches of one search,
               per kernel and variant; value-recall@100 against the f64 dense
               oracle printed, not gated;
9. two-stage engine -- SessionSearchEngine at Config() width with
               prefilter='itq', stage1='packed', pool=512 (projector fitted
               on phase 4's 8,192 embeddings): ingest, search 256 sessions,
               top-1 within two bf16 ulps of 1.0, K4 launched, K4 against its
               plain version on the engine's own codes;
9b. two-stage engine verbs -- phase 4's encoder and 8,192 sessions (8
               stamped batches) in 'itq' engines with stage1 'matmul' (K1's
               cp_async variant at 250 bits) and 'packed' (K4), pool 512:
               remove_sessions by 512 ids and by the content of 64 sessions,
               expire of the first batch, save_async then restore into a
               fresh engine, each timed; each search of 256 sessions at
               k=100 after a verb holds value recall >= 0.999 (two bf16 ulps)
               against a fresh engine that ingested the surviving sessions,
               and the restored engine returns the capture's top-k exactly;
9c. sharded serving -- a mesh of 4 shards on the one card
               (parallel.create_mesh): (a) SessionSearchEngine(mesh=) with
               phase 4's encoder and 8,192 sessions against the unsharded
               engine (values to 1e-5, ids where distinct, value-recall@100
               1.0; 4 f32 wgmma K1 launches per search), remove_sessions of
               512 ids (tombstones; no removed id returns; survivors keep
               their rows) and save / restore (the same top-k); (b)
               ShardedDenseIndex at 2^20 x 1600, 1024 queries k=100, in f32,
               bf16 and int8x8 against DenseIndex on the same rows, the bf16
               gate (value-recall@10 >= 0.999 at two bf16 ulps), search and
               merge times; (c) ShardedTwoStageIndex at 2^20 x 1600, pool 128
               per shard, tiers binary/matmul/256, itq/matmul/250,
               binary/packed/256, int8x8, pca/64: each shard's pool against
               its plain stage 1, the top-k against the f64 re-rank of the
               pools, planted rows top-1, stage-1 / re-rank / total times;
               (d) ShardedBinaryIndex at 2^20 x 250 bits, sign and packed:
               distances equal the plain product's and BinaryIndex's; (e) a
               world-1 process group over NCCL (TCP rendezvous on
               localhost): a bf16 2^18 x 1600 ShardedDenseIndex on
               global_mesh() whose merge all-gathers CUDA tensors equals the
               in-process mesh's; four shards on one card measure the
               sharding's overhead, not scale-out;
10. int8 kernel -- K2 against its plain version: ragged cases (q=37,
               n=5003, valid_count 4037, 10% masked; f32 and bf16 scores) on
               the tile variant csrc/scores_bmax_int8.cu at d=200 and the
               wgmma variant csrc/scores_bmax_int8_sm90.cu at d=208, and the
               bench point (q=1024, n=2^20, d=1600 int8; bf16 and f32 scores;
               wgmma variant); scores and bucket maxes equal; CUDA-event times
               beside torch._int_mm, the tile variant's at both;
11. int8 index -- DenseIndex(1600, 2^20) with quantize='int8x8' and 'int8'
               filled with the same 2^20 seeded rows, 1024 queries planted at
               cosine ~0.9 to stored rows, k=100: every planted row top-1, K2
               launched once per chunk, every launch the wgmma variant
               (int8x8; never for int8), value-recall@10 >= 0.999 against the
               f64 oracle over the dequantized rows and query codes, K2 equal
               to its plain version on one 65,536-row chunk; best-of-3 search
               times and a torch.profiler breakdown of the int8x8 search;
12. int8x8 engine -- SessionSearchEngine at Config() width with
               quantize='int8x8' (phase 4's encoder and sessions): ingest,
               search 256 sessions, top-1 within the int8 rounding bound of
               1.0, K2 launched once per chunk (the wgmma variant) and equal
               to its plain version on the engine's own codes;
13. bucket max kernel -- K3 (csrc/bucket_max.cu) against its plain version
               on a ragged case, then mips.bucketed_topk at q=8 and 64,
               n=2^20, d=1600 bf16, k=100: values within 1e-5 relative of
               mips.exact_topk's (f32 scores), value-recall@10 1.0, times
               beside exact_topk's;
14. scores matmul kernel -- K6 against its plain version on ragged cases
               (q=37, n=5003: f32 at d=200 and bf16 at d=200 on the wgmma
               variants, K1's Hopper kernels with a store-only epilogue;
               bf16 at d=250 on the cp_async variant; f32
               at d=202 on the tile loop csrc/scores_matmul.cu) and at
               q=1024, n=2^20, d=1600 bf16 -> f32 and f32 -> f32 (wgmma
               variants, max_abs_err <= 1e-5 on unit rows), beside one
               cuBLAS GEMM with f32 output and the tile loop at the same
               shape;
15. serving soak -- examples/serving_soak.py's run_soak at Config() width
               (asin_num 50,000, embed batch 1,024, the flagship encoder at
               init with bf16 serving_params and the title and keyword
               tables, a bf16 engine): 16,384 rows, 24 mixed batches of 256
               queries and 256 ingested sessions, k=100, remove_sessions by
               content every 6 batches, expire every 8, save_async at the
               midpoint while searches go on, restore after; then four
               shards on the one card at 8,192 rows and 12 batches (expire
               every 4). Each: the capture point's top-k back after restore,
               every verb ran, the rows within 16 of fill + ingested -
               removed - expired, nothing pending, kernel_path_flat (every
               search one bf16 wgmma K1 launch, one per shard sharded),
               memory_flat (torch.cuda.memory_allocated at the end within
               64 MiB of the warm-up's), K1 against its plain version on
               the engine's own queries and rows at two bf16 ulps, search()'s
               top-k against the plain one; p50/p99 search ms, QPS, ingest
               sessions/s, each verb's ms, save / restore s, the search
               latency during the save. Then dryrun.entry() at full width
               (SSS_ENTRY_FULL): 8 sessions on the card against the CPU on
               the same weights (1e-4 of the scale, phase 4's bound);
16. campaign -- two subprocesses of examples/flagship_campaign.py at
               Config() width (2,048 sessions, batch 256, 2 epochs,
               checkpoint every 4 steps, a loss logged every step): the first
               ends with os._exit(3) at step 6, the second resumes from the
               step-4 checkpoint and finishes (steps 5 and 6 replayed, their
               losses within 1e-4); the median step, sessions/s, FLOPs a step
               (FlopCounterMode) and TFLOP/s, the checkpoint's MB and its
               write and read seconds; a third subprocess with no card
               visible and no --device must fail;
17. training soak -- examples/training_soak.py's main in-process at
               Config() width with every head and the contrastive view
               (4,096 sessions, batch 256, 16 steps): the NaN drill at step
               10 reaches every loss term and is rolled back bit for bit, a
               fresh state resumes from the checkpoint to step 16, exit 0;
               step p50 / p90 ms and sessions/s;
18. flagship serving artifact -- examples/flagship_serving.py's main
               in-process at Config() width (32,768 sessions, asin_num
               50,000, 20 training steps, 1024 queries, k=100, 250 bits, 3
               timed calls a mode): all 14 modes; value-recall@10 >= 0.999 in
               exact_bf16, exact_cert_bf16, int8x8_exact and int8x8_cert,
               1.0 against the tie-aware Hamming oracle in binary_sign,
               binary_approx and binary_packed_itq; binary_approx returns
               binary_sign's ids; one search of each mode launches one
               kernel: K1's TMA wgmma variant (the exact and PCA-64 modes,
               the whole corpus as one chunk), K2's wgmma variant (int8x8),
               K1's cp_async variant (the 250-bit sign scans and the
               two-stage stage 1) or K4 (the packed modes); each kernel
               against its plain version on the script's own tensors (two
               bf16 ulps for K1 bf16 and K2, 0 for K1 on +-1 rows and K4);
               each mode's ms, QPS, value-recall and ave_type_score10;
19. flagship train -- examples/flagship_train.py's main at Config(), batch
               50, 30 steps and 10 resume steps, both phases: 31 steps (the
               loader's count), the fresh state restores step 31 and
               continues to 41, finite losses, no port kernel; the
               checkpoint directory is removed afterwards;
20. index build -- examples/index_build_100k.py's main at its own config
               (32,768 sessions, 4,096 training sessions, 1 epoch):
               every top-1 at the self-cosine, every query its own top-1
               but those that find a bit-identical row first (under
               ignore_query every search-only session embeds to one row,
               more of them than k), every K1 launch the f32 wgmma variant,
               K1 against its plain version on the index's rows and the
               queries to 1e-5 of the largest plain score;
21. maintenance bench -- examples/maintenance_bench.py's main at its full
               size (2^20 x 1600 bf16, capacity 1,572,864, 3 timed
               searches): each radius's range hits against a torch f64
               oracle on the stored rows (computed 65,536 rows at a time;
               rows within one bf16 ulp of the radius may differ), no removed
               id from the one-shard sharded index, one K1 wgmma launch a
               search after the removals on both indexes, K1 against its
               plain version; --out under the temporary directory, removed;
22. embed pipeline probe -- examples/embed_pipeline_probe.py's main at
               Config(asin_num=50,000) on 16,384 sessions: A and B agree
               bit for bit, C's two indexes hold the same rows, no port
               kernel;
23. quality protocol -- examples/quality_protocol.py's main with the
               flagship encoder at 800 / 800 / 768 / 200 (1600-d sessions,
               bf16 serving_params), 2 seeds of 8,192 corpus sessions, 1,024
               training sessions, 200 queries, 1 epoch, --alpha-sweep
               0.3,0.7: one f32 wgmma K1 launch a seed, K1 against its plain
               version on each seed's index rows and queries (1e-5 of the
               largest plain score), every system's mean and std finite,
               SKNN and STAN in [0, 1];
24. binary quality -- examples/binary_quality.py's main with --flagship
               (1600-d sessions, 250 bits), 8,192 corpus sessions, 1,024
               training sessions, 200 queries, 1 epoch, 2 fine-tune epochs:
               one f32 wgmma K1 launch (the dense row) and four cp_async
               launches (the untrained, SimHash, ITQ and trained sign rows,
               each 250 bits), each against its plain version on the
               script's rows and queries (f32: 1e-5 of the largest plain
               score; the +-1 rows: 0), every row's score in [0, 1];
25. knn pairings -- examples/knn_pairings.py's main on the clustered
               regime with joint towers at 800 / 800 / 768 / 200, 4,096
               corpus sessions, 1,024 training sessions, 200 queries, 1
               epoch: three f32 wgmma K1 launches (one a pairing), each
               against its plain version on the pairing's embeddings, every
               recall in [0, 1];
26. generalization benchmark -- examples/generalization_benchmark.py's
               main at its own config and sizes, 2 epochs: two f32 wgmma K1
               launches at d=128 (untrained, trained), each against its
               plain version, SKNN and STAN in [0, 1];
27. incatalog benchmark -- examples/incatalog_benchmark.py's main at its
               own config and sizes, 2 epochs: two f32 wgmma K1 launches at
               d=128 (evaluate_hybrid fuses on the host and launches none),
               each against its plain version, SKNN, STAN and the hybrid in
               [0, 1].

The build prints ptxas' resource lines; no kernel may spill, and ptxas
may report no "Potential Performance Loss" (such as serialized wgmma). Each kernel
time is printed with the SM clock and power draw that nvidia-smi reads
right after it. Before phase 4 the shared native graph builder must load
(built without OpenMP where the compiler has no OpenMP runtime; the build
used is printed).
The second-to-last line is a JSON object describing each of the six
kernels and K1's cp_async variant: the launches counted on its path (K1:
phase 4's f32 engine, and ``wgmma_launches`` phase 4b's bf16 engine,
``flagship_serving_launches`` phase 4f's fully cached engine; K1's times and bound are the bf16
wgmma variant's at the bench point, ``f32_wgmma`` holds the f32 wgmma
variant's (launches on phase 4's engine, times at the bench point and the
engine's shape, the accuracy gate), ``tile_f32`` the tile loop's on f32,
``tile_bf16`` the tile loop's at phase 7's sign-mode shape, timed through
its C entry point;
K4: phase 9's engine; K5: phase 6's hamming_topk (its times and bound the
wgmma variant's, ``wgmma_launches`` that variant's launches on the path,
``popc`` the popc variant's time in the same rounds and its design bound,
``k4_ms_same_rounds`` K4's, ``hamming_topk_ms`` the op's best of three,
``cases`` the cases held to the plain version); K2: phase 12's engine,
and for K1, K2 and K4 also the searches of phases 4g, 4h, 4i, 4k, 7b, 8, 9b, 9c, 15 and 18-27, counted
with the counters set to 0 just before each (``launches`` sums them, and
``launches_by_path`` holds each path's count, per variant; K4's entry
holds phase 8's times per tier under ``twostage_tiers``, K1's phase 9c's
numbers under ``sharded_serving``, phase 15's under ``serving_soak`` (the
paths ``serving_soak`` and ``sharded_serving_soak``) and phases 16 and
17's under ``training_runs``, phases 18-27's under
``operational_scripts``; the paths ``example_flagship_serving``,
``example_flagship_train``, ``example_index_build_100k``,
``example_maintenance_bench``, ``example_embed_pipeline_probe``,
``example_quality_protocol``, ``example_binary_quality``,
``example_knn_pairings``, ``example_generalization_benchmark`` and
``example_incatalog_benchmark``);
its ``wgmma_launches`` the Hopper variant's, its times the wgmma variant's
with f32 scores, ``tile`` the tile variant's; K3: phase 13's
bucketed_topk; K6: phase 14's scores_matmul, likewise with
``wgmma_launches``, ``tile``, ``f32_wgmma`` and ``cp_async``, its ragged
case on the cp_async variant; and ``scores_bmax_cp``, K1's and K6's bf16
kernel fed by cp.async for rows TMA cannot describe: its launches those of
phase 7's sign-mode search, phase 8's 'itq' + 'matmul' tier, phase 9b's
'itq' + 'matmul' engine, phase 4i's fine-tuned sign codes, phase 18's
sign and two-stage modes and phase 24's four sign rows, each path's
under ``launches_by_path``, its times
at sign mode's shape, ``producer_ablation_d256`` beside the TMA variant),
its largest error
against its plain version, its time, the plain version's, the bound (the
larger of bytes over 3.35 TB/s and operations over the published peak of
their type: an f32 product's 2*q*n*d at 495 TFLOP/s, the card's fastest
rate for f32 operands (tf32); K5's distances as 2*q*n*32W +-1 products at
the int8 rate of 1,979 TOP/s; ``design_bound_ms`` beside it is the bound
of the design that runs it: for the f32 entries three tf32 passes at 495
TFLOP/s for the wgmma variants, f32 FMAs at 67 TFLOP/s for the tile loop,
for K5's ``popc`` entry one popcount per (query, row, word) at 16 per clock
per SM at the card's maximum SM clock) and the time of one library call
computing the same product (null where there is none). The last line is
``{"ok": true, "device": {...}}``.
Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 2 * 2.0**-8  # two bf16 ulps, relative to the per-query scale
# two bf16 forwards agree when every row's cosine is >= BF16_COS and the
# largest |difference| is <= BF16_REL of the largest |reference|
BF16_COS, BF16_REL = 0.999, 2.0**-6
# the card's bf16 fully cached forward against the CPU's on the same tables:
# the largest |difference| over the largest |reference|
CARD_CPU_REL = 1e-4
# published H100 SXM peaks (dense, at the 700 W limit): bytes and operations
# per second; a kernel's bound is the larger of its bytes and its operations
# over these
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_TF32 = 495e12  # the card's fastest rate for f32 operands
TF32_PASSES = 3  # the f32 wgmma variants' design: three tf32 passes
PEAK_F32 = 67e12  # outside the tensor cores: the tile loop's exact f32 FMAs
SMS = 132
# the binary maintenance phase: rows and queries
BIN_ROWS, BIN_Q = 1 << 20, 1024


def check(cond: bool, what: str) -> None:
    if not cond:
        print(f"FAIL: {what}", file=sys.stderr)
        sys.exit(1)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, after one
    warm-up call, from CUDA events around ``iters`` back-to-back calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi() -> str:
    """The SM clock and power draw nvidia-smi reads now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return f"[{out or 'nvidia-smi read nothing'}]"


def bound_ms(n_bytes: float, ops: float, ops_rate: float) -> dict:
    """The least time the card could take: the bytes moved (each input read
    once, each output written once) over the memory rate, or the operations
    over their peak rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / ops_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout.split()
    check(bool(out), "nvidia-smi did not read the SM clock")
    return float(out[0]) * 1e6


def unit_rows(torch, g, n, d, dev):
    """n seeded unit rows [n, d] in bf16, drawn 65,536 at a time."""
    rows = torch.empty(n, d, dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 1 << 16):
        r = torch.randn(min(1 << 16, n - s), d, generator=g, device=dev)
        rows[s: s + len(r)] = (r / r.norm(dim=1, keepdim=True)).bfloat16()
    return rows


def unit_rows_f32(torch, g, n, d, dev):
    """n seeded f32 unit rows [n, d] (every mantissa bit in use, unlike
    unit_rows' bf16 values), drawn 65,536 at a time."""
    rows = torch.empty(n, d, device=dev)
    for s in range(0, n, 1 << 16):
        r = torch.randn(min(1 << 16, n - s), d, generator=g, device=dev)
        rows[s: s + len(r)] = r / r.norm(dim=1, keepdim=True)
    return rows


def tile_loop(torch, lib, mips, q, c, dev, bmax=True, out_bf16=False):
    """One launch of the f32 or bf16 tile loop straight through its C entry
    point -- K1's csrc/scores_bmax.cu (bmax=True; no penalty, every row
    valid, f32 or, with out_bf16, bf16 scores) or K6's csrc/scores_matmul.cu
    -- to time it on rows where the wrappers run a Hopper variant. Returns
    the scores (K1: and the bucket maxes)."""
    m, n, d = q.shape[0], c.shape[0], q.shape[1]
    in_bf16 = int(q.dtype == torch.bfloat16)
    s = torch.empty(m, n, device=dev,
                    dtype=torch.bfloat16 if bmax and out_bf16 else torch.float32)
    if bmax:
        bm = torch.empty(m, -(-n // 128), device=dev)
        mips._cuda_call(lib.sss_scores_bmax, "scores_bmax", dev, q.data_ptr(), c.data_ptr(),
                        None, s.data_ptr(), bm.data_ptr(), m, n, d, n, in_bf16, int(out_bf16))
        if out_bf16:
            return s, bm
    else:
        mips._cuda_call(lib.sss_scores_matmul, "scores_matmul", dev, q.data_ptr(),
                        c.data_ptr(), s.data_ptr(), m, n, d, in_bf16)
    return s


def cp_loop(torch, lib, mips, q, c, dev):
    """One launch of K1's cp_async variant straight through its C entry point
    (bf16 rows; no penalty, every row valid, bf16 scores), to time it on rows
    where the wrapper runs the TMA-fed variant. Returns (scores, bmax)."""
    m, n, d = q.shape[0], c.shape[0], q.shape[1]
    s = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    bm = torch.empty(m, -(-n // 128), device=dev)
    mips._cuda_call(lib.sss_scores_bmax_cp_sm90, "scores_bmax_cp_sm90", dev, q.data_ptr(),
                    c.data_ptr(), None, s.data_ptr(), bm.data_ptr(), m, n, d, n, 1)
    return s, bm


def f32_bound(q_n, n, d, tf32=True, bmax=True):
    """The bound of an f32 -> f32 score call: its 2*q*n*d operations at the
    card's fastest rate for f32 operands, or its bytes. ``design_bound_ms``
    is the same for the design that runs it: the f32 wgmma variants' three
    tf32 passes (tf32=True), or the tile loop's f32 FMAs."""
    n_bytes = 4 * (q_n * d + n * d + q_n * n) + (q_n * (n // 128) * 4 if bmax else 0)
    ops = 2 * q_n * n * d
    design = (bound_ms(n_bytes, TF32_PASSES * ops, PEAK_TF32) if tf32
              else bound_ms(n_bytes, ops, PEAK_F32))
    return {**bound_ms(n_bytes, ops, PEAK_TF32), "design_bound_ms": design["bound_ms"],
            "design_bound_by": design["bound_by"]}


def rounds_in_turns(torch, fns: dict, rounds: int = 3):
    """Times each of ``fns`` (name -> (fn, calls a round)) once a round, in
    turns, so that a clock that drifts hits them alike. Returns each one's
    median, each one's rounds as text, and the SM clock and power after."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, (fn, iters) in fns.items():
            times[name].append(cuda_ms(torch, fn, iters))
    state = smi()
    medians = {name: sorted(ts)[len(ts) // 2] for name, ts in times.items()}
    text = {name: " / ".join(f"{t:.3f}" for t in ts) for name, ts in times.items()}
    return medians, text, state


def run_phase(torch, name, fn, *args):
    """Run one phase and print its time from CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    print(f"phase {name}: {start.elapsed_time(end) / 1e3:.2f} s (CUDA events)")
    return out


def value_recall(torch, topk_mod, exact, ids, k, rel_tol):
    """Value-recall of ``ids`` [q, k] against the exact scores [q, n]
    (f64 or f32 on the device; -inf where a row may not rank)."""
    oracle = torch.topk(exact, k, dim=1).values
    got = torch.gather(exact, 1, ids.clamp(min=0))
    got = torch.where(ids >= 0, got, float("-inf"))
    scale = torch.where(torch.isfinite(exact), exact.abs(), 0.0).amax(dim=1)
    return topk_mod.value_recall_from_scores(
        got.cpu().numpy(), oracle.cpu().numpy(), rel_tol * scale.cpu().numpy()
    )


def phase_kernel_ragged(torch, mips, topk_mod, dev):
    errs, cp_errs = [], []
    # f32 at d=200 (the f32 wgmma variant) and d=202 (no TMA stride: the
    # tile loop), bf16 at d=200 (the bf16 wgmma variant), bf16 at d=250 and
    # at d=1600 with the corpus 2 elements (4 bytes) into its allocation (no
    # TMA stride or base: the cp_async variant)
    for dt, d, off, want in ((torch.float32, 200, 0, "wgmma"),
                             (torch.float32, 202, 0, "tile"),
                             (torch.bfloat16, 200, 0, "wgmma"),
                             (torch.bfloat16, 250, 0, "cp_async"),
                             (torch.bfloat16, 1600, 2, "cp_async")):
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(37, d, generator=g, device=dev).to(dt)
        c = torch.randn(5003 * d + off, generator=g, device=dev).to(dt)[off:].view(5003, d)
        pen = torch.where(torch.rand(5003, generator=g, device=dev) < 0.1,
                          float("-inf"), 0.0)
        vc = 4037  # mid-bucket: 4037 = 31 * 128 + 69
        variant = mips.k1_variant(dev.type, dt, d, (q.data_ptr(), c.data_ptr()))
        check(variant == want, f"ragged {dt} d={d}: the {variant} variant, not {want}")
        w0, cp0 = mips.wgmma_launch_count, mips.cp_async_launch_count
        mips.scores_with_bucket_max(q, c, vc, pen, dt)
        check((mips.wgmma_launch_count - w0, mips.cp_async_launch_count - cp0)
              == (variant == "wgmma", variant == "cp_async"),
              f"ragged {dt} d={d}: the {variant} variant was not the one launched")
        ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max(q, c, vc, pen, dt), 20)
        plain_ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max_ref(
            q, c, vc, pen, dt), 20)
        s, bm = mips.scores_with_bucket_max(q, c, vc, pen, dt)
        s_ref, bm_ref = mips.scores_with_bucket_max_ref(q, c, vc, pen, dt)
        torch.cuda.synchronize()
        check(torch.equal(torch.isneginf(s), torch.isneginf(s_ref)),
              f"ragged {dt} d={d}: -inf pattern of the scores differs")
        check(torch.equal(torch.isneginf(bm), torch.isneginf(bm_ref)),
              f"ragged {dt} d={d}: -inf pattern of bmax differs")
        fin = torch.isfinite(bm_ref)
        bm_err = (bm[fin] - bm_ref[fin]).abs().max().item()
        fin_s = torch.isfinite(s_ref)
        s_err = (s.float()[fin_s] - s_ref.float()[fin_s]).abs()
        s_rel = (s_err / s_ref.float()[fin_s].abs().clamp(min=1.0)).max().item()
        exact = q.double() @ c.double().T
        exact[:, vc:] = float("-inf")
        exact += pen.double()
        check(bm_err <= 1e-3, f"ragged {dt} d={d}: bmax max_abs_err {bm_err}")
        if dt == torch.float32:
            # f32 sums of 200 products (|s| ~ 15) in another order than the
            # plain version's cuBLAS SGEMM: each is held to the f64 product,
            # the kernel within twice SGEMM's error (phase 4c's gate)
            e_k = (s.double()[fin_s] - exact[fin_s]).abs().max().item()
            e_plain = (s_ref.double()[fin_s] - exact[fin_s]).abs().max().item()
            check(e_k <= 2 * e_plain, f"ragged {dt} d={d}: |scores - f64| max {e_k} > 2 x "
                  f"the plain version's {e_plain}")
            f64_note = f", |scores - f64| max {e_k:.4g} = {e_k / e_plain:.3f} x plain's (limit 2)"
        else:
            f64_note = ""
            # bf16: both sides round the f32 value to nearest even, one ulp
            # apart at most
            check(s_rel <= 2.0**-7, f"ragged {dt} d={d}: scores max rel err {s_rel}")
        v, i = mips.select_topk(s, bm, 10)
        v_ref, _ = mips.select_topk(s_ref, bm_ref, 10)
        v_err = (v - v_ref).abs().max().item()
        v_tol = 1e-3 if dt == torch.float32 else 2.0**-7 * v_ref.abs().max().item()
        check(v_err <= v_tol, f"ragged {dt} d={d}: top-10 values max_abs_err {v_err}")
        rec = value_recall(torch, topk_mod, exact, i, 10,
                           1e-5 if dt == torch.float32 else BF16_TOL)
        check(rec == 1.0, f"ragged {dt} d={d}: value-recall@10 {rec}")
        errs.append(bm_err)
        if variant == "cp_async":
            cp_errs.append(bm_err)
        print(f"kernel ragged q=37 n=5003 d={d} {str(dt)[6:]} ({variant} variant"
              f"{f', corpus {2 * off} bytes off' if off else ''}): "
              f"kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; bmax max_abs_err {bm_err:.3g}, scores max "
              f"rel err {s_rel:.3g}{f64_note}, top-10 max_abs_err {v_err:.3g}, "
              f"value-recall@10 {rec}")
    return max(errs), max(cp_errs)


def phase_kernel_bench(torch, mips, topk_mod, dev):
    q_n, n, d, k = 1024, 1 << 20, 1600, 100
    g = torch.Generator(device=dev).manual_seed(1)
    corpus = torch.empty(n, d, dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 1 << 16):
        rows = torch.randn(1 << 16, d, generator=g, device=dev)
        corpus[s: s + (1 << 16)] = (rows / rows.norm(dim=1, keepdim=True)).bfloat16()
    queries = torch.randn(q_n, d, generator=g, device=dev)
    queries = (queries / queries.norm(dim=1, keepdim=True)).bfloat16()
    bf = torch.bfloat16
    check(mips.k1_variant(dev.type, bf, d, (queries.data_ptr(), corpus.data_ptr()))
          == "wgmma", "bench point: not the wgmma variant")

    w0 = mips.wgmma_launch_count
    ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max(
        queries, corpus, score_dtype=bf), 5)
    check(mips.wgmma_launch_count - w0 == 6, "bench point: the wgmma variant did not run")
    plain_ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max_ref(
        queries, corpus, score_dtype=bf), 3)
    # the library yardstick: one cuBLAS bf16 GEMM of the same operands (its
    # bf16 output has no mask and no bucket max)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(queries, corpus.T), 5)
    s, bm = mips.scores_with_bucket_max(queries, corpus, score_dtype=bf)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(queries, corpus, score_dtype=bf)
    torch.cuda.synchronize()
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = max((s[r: r + 64].float() - s_ref[r: r + 64].float()).abs().max().item()
                for r in range(0, q_n, 64))
    v, i = mips.select_topk(s, bm, k)
    v_ref, _ = mips.select_topk(s_ref, bm_ref, k)
    v_err = (v - v_ref).abs().max().item()
    del s, s_ref, bm, bm_ref
    # exact scores of the bf16 rows (products exact in f32): the oracle
    exact, _ = mips.scores_with_bucket_max_ref(queries, corpus)
    rec = value_recall(torch, topk_mod, exact, i, k, BF16_TOL)
    del exact
    tflops = 2 * q_n * n * d / (ms * 1e-3) / 1e12
    # |s| < 1 for unit rows: f32 sums agree to ~1e-6; bf16 ulp at 0.5 is 2^-9
    check(bm_err <= 1e-4, f"bench point: bmax max_abs_err {bm_err}")
    check(s_err <= 2.0**-8, f"bench point: scores max_abs_err {s_err}")
    check(v_err <= 2.0**-8, f"bench point: top-{k} values max_abs_err {v_err}")
    check(rec == 1.0, f"bench point: value-recall@{k} {rec}")
    print(f"kernel bench point q={q_n} n={n} d={d} bf16->bf16 (wgmma variant, "
          f"csrc/scores_bmax_sm90.cu): kernel {ms:.3f} ms {smi()} "
          f"({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms, cuBLAS bf16 GEMM "
          f"{lib_ms:.3f} ms; bmax max_abs_err "
          f"{bm_err:.3g}, scores max_abs_err {s_err:.3g}, top-{k} max_abs_err "
          f"{v_err:.3g}, value-recall@{k} {rec}")
    del corpus, queries
    torch.cuda.empty_cache()
    bound = bound_ms(q_n * d * 2 + n * d * 2 + q_n * n * 2 + q_n * (n // 128) * 4,
                     2 * q_n * n * d, PEAK_BF16)
    return bm_err, {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **bound}


def phase_f32_index(torch, mips, topk_mod, dev):
    """The default DenseIndex: f32 rows and f32 scores, every K1 launch the
    f32 wgmma variant."""
    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex

    n, d, q_n = 1 << 20, 1600, 1024
    idx = DenseIndex(d, n, device=dev)  # f32 storage and scores: the defaults
    check(idx._buf.dtype == torch.float32, "f32 index: not f32 storage")
    g = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    for _ in range(0, n, 1 << 16):
        idx.add(torch.randn(1 << 16, d, generator=g, device=dev))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    queries = torch.randn(q_n, d, generator=g, device=dev)

    mips.launch_count = mips.wgmma_launch_count = 0
    D, I = idx.search(queries, 100)  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        D, I = idx.search(queries, 100)  # returns numpy: includes the sync
        times.append(time.perf_counter() - t0)
    launches, wgmma = mips.launch_count, mips.wgmma_launch_count
    chunks = n // idx.chunk_size
    check(launches == wgmma == 4 * chunks,
          f"f32 index: {launches} K1 launches ({wgmma} wgmma) in 4 searches of {chunks} chunks")
    check(np.isfinite(D).all() and (np.diff(D, axis=1) <= 0).all(),
          "f32 index: scores not finite and descending")
    check(((I >= 0) & (I < n)).all(), "f32 index: ids out of range")

    # correctness gate: the first 65,536 rows through row_mask, 64 queries,
    # against the f64 numpy oracle over the rows and queries as stored
    sub_n, sub_q = 65536, 64
    mask = torch.arange(n, device=dev) < sub_n
    _, Im = idx.search(queries[:sub_q], 10, row_mask=mask)
    sub = idx.reconstruct_batch(np.arange(sub_n))
    qs = topk_mod.l2_normalize(queries[:sub_q]).cpu().numpy()
    check((Im < sub_n).all(), "f32 index: row_mask let a filtered row through")
    rec = topk_mod.value_recall_at_k(Im, qs, sub, 10, rel_tol=1e-5)
    check(rec >= 0.999, f"f32 index: value-recall@10 {rec}")

    # the kernel against its plain version on one chunk as search() hands it
    # over: the 1024 queries normalized in f32 and the first chunk_size rows
    qn = topk_mod.l2_normalize(queries).contiguous()
    chunk = idx._buf[: idx.chunk_size]
    s, bm = mips.scores_with_bucket_max(qn, chunk)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(qn, chunk)
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = (s - s_ref).abs().max().item()
    # unit rows, |s| <= 1: f32-accurate sums in another order
    check(bm_err <= 1e-5 and s_err <= 1e-5,
          f"f32 index chunk: bmax max_abs_err {bm_err}, scores {s_err}")
    del s, s_ref
    best = min(times)
    print(f"f32 index 2^20 x 1600 f32/f32 (the defaults): fill {fill_s:.2f} s; search 1024 "
          f"queries k=100: {best * 1e3:.1f} ms best of 3 ({q_n / best:.0f} QPS) {smi()}, "
          f"{launches} K1 launches, all f32 wgmma ({wgmma // 4} per search); value-recall@10 "
          f"{rec} on the 65,536-row subcorpus; one {idx.chunk_size}-row chunk, kernel vs "
          f"plain: bmax max_abs_err {bm_err:.3g}, scores max_abs_err {s_err:.3g}")
    # where the f32 search's time goes; a diagnostic: a profiler that cannot
    # trace the card is reported, not fatal
    try:
        wall, busy, top = profile(torch, lambda: idx.search(queries, 100))
        print(f"f32 search profile (torch.profiler, 3 calls): {wall:.2f} ms a call on the "
              f"host clock, device busy {busy:.2f} ms ({100 * (1 - busy / wall):.1f}% idle)")
        for key, t, count in top:
            print(f"  {t:8.3f} ms  x{count:<4d} {key[:90]}")
    except Exception as e:  # noqa: BLE001 - diagnostic output only
        print(f"f32 search profile: not measured ({type(e).__name__}: {e})")
    del idx, chunk
    torch.cuda.empty_cache()
    return max(bm_err, s_err), best * 1e3


def phase_index(torch, mips, topk_mod, dev):
    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex

    n, d, q_n = 1 << 20, 1600, 1024
    idx = DenseIndex(d, n, device=dev, dtype=torch.bfloat16,
                     score_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    for _ in range(0, n, 1 << 16):
        rows = torch.randn(1 << 16, d, generator=g, device=dev)
        idx.add(rows / rows.norm(dim=1, keepdim=True))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    queries = torch.randn(q_n, d, generator=g, device=dev)
    queries = queries / queries.norm(dim=1, keepdim=True)

    mips.launch_count = mips.wgmma_launch_count = 0
    D, I = idx.search(queries, 100)  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        D, I = idx.search(queries, 100)  # returns numpy: includes the sync
        times.append(time.perf_counter() - t0)
    launches, wgmma = mips.launch_count, mips.wgmma_launch_count
    chunks = n // idx.chunk_size
    check(launches >= 4 * chunks, f"index: launch count {launches}")
    check(wgmma == 4 * chunks, f"index: {wgmma} wgmma K1 launches in 4 searches of "
          f"{chunks} chunks")
    check(np.isfinite(D).all() and (np.diff(D, axis=1) <= 0).all(),
          "index: scores not finite and descending")
    check(((I >= 0) & (I < n)).all(), "index: ids out of range")

    # correctness gate: the first 65,536 rows through row_mask, 64 queries,
    # against the f64 numpy oracle over the rows and queries as stored
    sub_n, sub_q = 65536, 64
    mask = torch.arange(n, device=dev) < sub_n
    _, Im = idx.search(queries[:sub_q], 10, row_mask=mask)
    sub = idx.reconstruct_batch(np.arange(sub_n))
    # the queries as search() scores them: cast to bf16, normalized in bf16
    qs = topk_mod.l2_normalize(queries[:sub_q].bfloat16()).float().cpu().numpy()
    check((Im < sub_n).all(), "index: row_mask let a filtered row through")
    rec = topk_mod.value_recall_at_k(Im, qs, sub, 10, rel_tol=BF16_TOL)
    _, i_or = topk_mod.oracle_topk_np(qs, sub, 10)
    set_rec = topk_mod.recall_at_k(Im, i_or)
    check(rec >= 0.999, f"index: value-recall@10 {rec}")

    # the kernel against its plain version on one chunk as search() hands
    # it over: the 1024 queries cast and normalized in bf16, and the first
    # chunk_size stored rows
    bf = torch.bfloat16
    qb = topk_mod.l2_normalize(queries.to(bf)).to(bf).contiguous()
    chunk = idx._buf[: idx.chunk_size]
    s, bm = mips.scores_with_bucket_max(qb, chunk, score_dtype=bf)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(qb, chunk, score_dtype=bf)
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = (s.float() - s_ref.float()).abs().max().item()
    v, _ = mips.select_topk(s, bm, 100)
    v_ref, _ = mips.select_topk(s_ref, bm_ref, 100)
    v_err = (v - v_ref).abs().max().item()
    # the bench point's tolerances: unit rows, bf16 ulp at 0.5 is 2^-9
    check(bm_err <= 1e-4, f"index chunk: bmax max_abs_err {bm_err}")
    check(s_err <= 2.0**-8, f"index chunk: scores max_abs_err {s_err}")
    check(v_err <= 2.0**-8, f"index chunk: top-100 values max_abs_err {v_err}")
    best = min(times)
    print(f"index 2^20 x 1600 bf16/bf16: fill {fill_s:.2f} s; search 1024 queries "
          f"k=100: {best * 1e3:.1f} ms best of 3 ({q_n / best:.0f} QPS), "
          f"{launches} kernel launches ({wgmma // 4} wgmma K1 launches per search); "
          f"value-recall@10 {rec} (set recall "
          f"{set_rec}) on the 65,536-row subcorpus; one {idx.chunk_size}-row chunk, "
          f"kernel vs plain: bmax max_abs_err {bm_err:.3g}, scores max_abs_err "
          f"{s_err:.3g}, top-100 max_abs_err {v_err:.3g}")
    del idx, s, s_ref
    torch.cuda.empty_cache()
    return bm_err


def phase_engine(torch, mips, topk_mod, dev):
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import EmbeddingPipeline

    cfg = port.Config()
    tok = port.get_tokenizer(cfg.vocab_size)
    t0 = time.perf_counter()
    enc = port.build_graph_encoder(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in enc.parameters())
    data = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(8192)
    eng = port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,
                                   capacity=65536, device=dev)
    eng.embed(data[:8])  # warm-up, counted as set-up: cuBLAS picks its kernels
    setup_s = time.perf_counter() - t0

    mips.launch_count = mips.wgmma_launch_count = 0  # the main path's launches
    t0 = time.perf_counter()
    eng.add_sessions(data)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    D, I = eng.search(data[:256], k=100)
    search_s = time.perf_counter() - t0
    launches = mips.launch_count
    check(mips.wgmma_launch_count == launches,
          f"engine: {launches - mips.wgmma_launch_count} of {launches} K1 launches of the "
          "f32 engine were not the f32 wgmma variant")

    check(eng.index.ntotal == 8192, f"engine: ntotal {eng.index.ntotal}")
    check(D.shape == (256, 100) and np.isfinite(D).all(), "engine: bad result")
    top1_err = float(np.abs(D[:, 0] - 1.0).max())
    check(top1_err <= 1e-3, f"engine: top-1 score off 1.0 by {top1_err}")
    self_hits = float((I[:, 0] == np.arange(256)).mean())
    check(launches >= 1, "engine: the search never launched the kernel")
    stats = eng.stats()

    # the kernel against its plain version on the engine's own search inputs:
    # the 256 query embeddings normalized as search() does and the stored
    # float32 corpus -- the f32 wgmma variant at d=1600, timed beside the
    # tile loop (through its own entry point) and SGEMM
    from sessionsimilaritysearch_tpu_torch.ops import _build

    lib = _build.load_library()
    qs = topk_mod.l2_normalize(eng.embed(data[:256], out="device").float()).contiguous()
    corpus = eng.index._buf[: eng.index.ntotal]
    check(mips.k1_variant(dev.type, qs.dtype, qs.shape[1], (qs.data_ptr(), corpus.data_ptr()))
          == "wgmma", "engine: its f32 rows do not take the f32 wgmma variant")
    ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max(qs, corpus), 20)
    tile_ms = cuda_ms(torch, lambda: tile_loop(torch, lib, mips, qs, corpus, dev), 20)
    plain_ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max_ref(qs, corpus), 20)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(qs, corpus.T), 20)  # SGEMM, TF32 off
    q_n, n_c, d = qs.shape[0], corpus.shape[0], qs.shape[1]
    f32_small = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 **f32_bound(q_n, n_c, d)}
    tile_small = {"ms": tile_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  **f32_bound(q_n, n_c, d, tf32=False)}
    s, bm = mips.scores_with_bucket_max(qs, corpus)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(qs, corpus)
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = (s - s_ref).abs().max().item()
    v, _ = mips.select_topk(s, bm, 100)
    v_ref, _ = mips.select_topk(s_ref, bm_ref, 100)
    v_err = (v - v_ref).abs().max().item()
    d_err = float(np.abs(D - v_ref.cpu().numpy()).max())
    # unit rows, |s| <= 1: two f32 sums over 1600 terms in another order
    check(bm_err <= 1e-5, f"engine: bmax max_abs_err {bm_err}")
    check(s_err <= 1e-5, f"engine: scores max_abs_err {s_err}")
    check(v_err <= 1e-5, f"engine: top-100 values max_abs_err {v_err}")
    check(d_err <= 1e-5, f"engine: search() scores vs plain top-100 max_abs_err {d_err}")

    # the same weights on the CPU: the card must agree in float32 (TF32 off)
    cpu_enc = port.build_graph_encoder(cfg, "cpu", torch.Generator().manual_seed(0))
    cpu_enc.load_state_dict(enc.state_dict())
    on_card = EmbeddingPipeline(cfg, tok, enc, device=dev, batch_size=8)(data[:8])
    on_cpu = EmbeddingPipeline(cfg, tok, cpu_enc, device="cpu", batch_size=8)(data[:8])
    scale = float(np.abs(on_cpu).max())
    enc_err = float(np.abs(on_card - on_cpu).max())
    check(np.isfinite(on_card).all() and enc_err <= 1e-4 * scale,
          f"engine: card vs CPU encoder max_abs_err {enc_err} (scale {scale})")
    print(f"engine Config() ({n_params / 1e6:.1f} M params, 1600-d): setup "
          f"{setup_s:.1f} s; ingest 8192 sessions {ingest_s:.2f} s "
          f"({8192 / ingest_s:.0f} sessions/s); search 256 k=100 {search_s * 1e3:.1f} ms; "
          f"top-1 |score-1| max {top1_err:.3g}, self-hit ids {self_hits:.4f}; "
          f"card vs CPU encoder max_abs_err {enc_err:.3g} of scale {scale:.3g}; "
          f"kernel launches {launches}")
    print(f"engine search shape q=256 n=8192 d=1600 f32->f32 (f32 wgmma variant, "
          f"csrc/scores_bmax_f32_sm90.cu; all {launches} K1 launches on the path), kernel "
          f"vs plain: kernel {ms:.4f} ms {smi()}, tile loop {tile_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul f32 (TF32 off) {lib_ms:.4f} ms, bound "
          f"{f32_small['bound_ms']:.4f} ms ({f32_small['bound_by']}; design bounds: three "
          f"tf32 passes {f32_small['design_bound_ms']:.4f}, the tile loop's "
          f"{tile_small['design_bound_ms']:.4f}); bmax max_abs_err "
          f"{bm_err:.3g}, scores max_abs_err {s_err:.3g}, top-100 max_abs_err "
          f"{v_err:.3g}, search() top-100 vs plain max_abs_err {d_err:.3g}")
    print(f"engine stats: {json.dumps(stats)}")
    corpus = eng.index.reconstruct_batch(np.arange(eng.index.ntotal))
    return (launches, bm_err, f32_small, tile_small, (cfg, tok, enc, data, corpus),
            8192 / ingest_s)


def verb(torch, mips, card, name, fn, searches=True):
    """Run one serving verb with K1's counters set to 0 just before it and
    read just after; print its time (host clock around work that ends in a
    synchronize) beside the card's name and power limit, and its K1
    launches. Every K1 launch on these f32 paths must be the f32 wgmma
    variant, and a verb that searches must launch K1. The clock starts
    after the device has finished the work queued before the verb."""
    torch.cuda.synchronize()
    mips.launch_count = mips.wgmma_launch_count = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches, wgmma = mips.launch_count, mips.wgmma_launch_count
    check(launches == wgmma,
          f"{name}: {launches - wgmma} of {launches} K1 launches were not the f32 wgmma variant")
    check(launches >= 1 or not searches, f"{name}: K1 was never launched")
    print(f"  {name}: {ms:.1f} ms [{card}]; K1 launches {launches} (wgmma {wgmma})")
    return out, ms, launches


def fill_rows(torch, idx, count, d, seed, dev):
    """Add ``count`` seeded standard-normal rows to ``idx``, 65,536 at a
    time: the same seed gives the same rows in the same batches."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for s in range(0, count, 1 << 16):
        idx.add(torch.randn(min(1 << 16, count - s), d, generator=g, device=dev))


def f64_scores(torch, q64, buf, n, step=1 << 16):
    """Exact f64 products [m, n] of f64 queries with the first n rows of
    ``buf``, 65,536 rows at a time."""
    return torch.cat([q64 @ buf[lo: min(lo + step, n)].double().T
                      for lo in range(0, n, step)], dim=1)


def range_vs_oracle(torch, lims, ids, exact, radius):
    """Holds a range search's CSR hits against the exact scores [q, n]
    thresholded at ``radius``: (rows in one set and not the other, the
    largest distance of such a row's exact score from the radius)."""
    rows = np.repeat(np.arange(len(lims) - 1), np.diff(lims))
    got = torch.zeros_like(exact, dtype=torch.bool)
    got[torch.from_numpy(rows).to(exact.device), torch.from_numpy(ids).to(exact.device)] = True
    differ = got ^ (exact >= radius)
    gap = (exact[differ] - radius).abs().max().item() if differ.any() else 0.0
    return int(differ.sum().item()), gap


def phase_dense_maintenance(torch, mips, topk_mod, dev, card):
    """The maintenance verbs of the default f32 DenseIndex at 2^20 x 1600:
    remove_ids, refill, range_search, an l2 index, merge_from, save/load."""
    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex, compaction_plan

    n, d, q_n, k, sub_q = 1 << 20, 1600, 1024, 100, 64
    removed_n = 1 << 16
    g = torch.Generator(device=dev).manual_seed(31)
    rng = np.random.default_rng(31)
    idx = DenseIndex(d, n, device=dev)  # cos, f32 rows and scores
    fill_rows(torch, idx, n, d, 32, dev)
    queries = torch.randn(q_n, d, generator=g, device=dev)
    qn64 = topk_mod.l2_normalize(queries[:sub_q]).double()  # as the index scores them
    chunks = n // idx.chunk_size
    total = 0
    print(f"dense maintenance: DenseIndex 2^20 x 1600 f32 (cos), {q_n} queries k={k}")
    idx.search(queries, k)  # warm-up
    _, cos_ms, launches = verb(torch, mips, card, "search", lambda: idx.search(queries, k))
    check(launches == chunks, f"maintenance search: {launches} K1 launches for {chunks} chunks")
    total += launches

    # remove 65,536 random rows: the moved slots hold the rows the plan
    # moved, bit for bit; no removed row comes back
    rm = torch.randperm(n, generator=g, device=dev)[:removed_n].cpu().numpy()
    src, dst, new_size = compaction_plan(n, rm)
    pick = rng.choice(src.size, 512, replace=False)
    moved = idx.reconstruct_batch(src[pick])
    # a row's fingerprint: its first two f32 words as one int64
    removed_fp = idx._buf[torch.from_numpy(rm).to(dev), :2].contiguous().view(torch.int64)
    removed, rm_ms, _ = verb(torch, mips, card, "remove_ids 65,536 rows",
                             lambda: idx.remove_ids(rm), searches=False)
    check(removed == removed_n and idx.ntotal == new_size == n - removed_n,
          f"remove_ids: removed {removed}, ntotal {idx.ntotal}")
    check(np.array_equal(idx.reconstruct_batch(dst[pick]), moved),
          "remove_ids: a moved slot does not hold the row compaction_plan moved there")
    (D, I), search_rm_ms, launches = verb(torch, mips, card, "search after removal",
                                          lambda: idx.search(queries, k))
    total += launches
    check(launches == -(-new_size // idx.chunk_size), f"search after removal: {launches} launches")
    hit_fp = idx._buf[torch.from_numpy(I.reshape(-1)).to(dev), :2].contiguous().view(torch.int64)
    check(not torch.isin(hit_fp, removed_fp).any().item(), "a removed row was returned")
    exact = f64_scores(torch, qn64, idx._buf, new_size)
    rec = value_recall(torch, topk_mod, exact, torch.from_numpy(I[:sub_q, :10]).to(dev), 10, 1e-5)
    check(rec == 1.0, f"search after removal: value-recall@10 {rec}")
    del exact

    # refill the freed capacity: the new rows are found in their new slots
    fresh_rows = torch.randn(removed_n, d, generator=g, device=dev)
    _, add_ms, _ = verb(torch, mips, card, "add 65,536 rows into the freed capacity",
                        lambda: idx.add(fresh_rows), searches=False)
    check(idx.ntotal == n, f"refill: ntotal {idx.ntotal}")
    (D, I), refill_ms, launches = verb(torch, mips, card, "search after refill",
                                       lambda: idx.search(fresh_rows[:q_n], k))
    total += launches
    check((I[:, 0] == new_size + np.arange(q_n)).all() and np.abs(D[:, 0] - 1).max() <= 1e-5,
          "refill: the added rows are not their own top-1 in the freed slots")

    # range search at query 0's 200th best score, each depth timed
    radius = float(idx.search(queries[:1], 200)[0][0, -1])
    depths = []
    search = idx.search

    def timed_search(q, kk, row_mask=None):
        t0 = time.perf_counter()
        out = search(q, kk, row_mask=row_mask)  # numpy out: ends in a sync
        depths.append(f"k={kk} {(time.perf_counter() - t0) * 1e3:.1f} ms")
        return out

    idx.search = timed_search
    try:
        (lims, Dr, Ir), range_ms, launches = verb(
            torch, mips, card, f"range_search {sub_q} queries, radius {radius:.5f}",
            lambda: idx.range_search(queries[:sub_q], radius))
    finally:
        del idx.search, search, timed_search
    total += launches
    hits = np.diff(lims)
    exact = f64_scores(torch, qn64, idx._buf, n)
    differ, tie_gap = range_vs_oracle(torch, lims, Ir, exact, radius)
    check(hits[0] >= 200 and tie_gap <= 1e-5,
          f"range_search: {hits[0]} hits for query 0, a set differs from the f64 oracle's "
          f"by a row {tie_gap} from the radius")
    check(all((np.diff(Dr[lims[i]: lims[i + 1]]) <= 0).all() for i in range(sub_q)),
          "range_search: a query's hits are not best-first")
    print(f"  range_search depths: {', '.join(depths)}; hits per query min {hits.min()} "
          f"median {int(np.median(hits))} max {hits.max()} (query 0: {hits[0]}); "
          f"{differ} rows differ from the f64 oracle's sets, all within {tie_gap:.3g} of the "
          f"radius")
    del exact, idx, fresh_rows
    torch.cuda.empty_cache()

    # l2 at the same size: K1 with the penalty -|c|^2
    l2 = DenseIndex(d, n, device=dev, metric="l2")
    fill_rows(torch, l2, n, d, 32, dev)
    l2.search(queries, k)  # warm-up
    (D, I), l2_ms, launches = verb(torch, mips, card, "l2 search", lambda: l2.search(queries, k))
    total += launches
    check(launches == chunks, f"l2 search: {launches} K1 launches for {chunks} chunks")
    check(np.isfinite(D).all() and (np.diff(D, axis=1) >= 0).all(),
          "l2 search: distances not finite and ascending")
    q64 = queries[:sub_q].double()
    exact = 2 * f64_scores(torch, q64, l2._buf, n) - (q64 * q64).sum(1, keepdim=True)
    exact -= torch.cat([(l2._buf[lo: lo + (1 << 16)].double() ** 2).sum(1)
                        for lo in range(0, n, 1 << 16)])
    rec = value_recall(torch, topk_mod, exact, torch.from_numpy(I[:sub_q, :10]).to(dev), 10, 1e-5)
    check(rec == 1.0, f"l2 search: value-recall@10 {rec}")
    print(f"  l2 search {l2_ms:.1f} ms vs cos search {cos_ms:.1f} ms [{card}]; value-recall@10 "
          f"{rec} against |q|^2 + |c|^2 - 2q.c in f64")
    del exact, l2
    torch.cuda.empty_cache()

    # merge two 2^19 halves: the same top-k as one build of both
    half = n // 2
    a = DenseIndex(d, n, device=dev)
    b = DenseIndex(d, half, device=dev)
    single = DenseIndex(d, n, device=dev)
    fill_rows(torch, a, half, d, 33, dev)
    fill_rows(torch, b, half, d, 34, dev)
    fill_rows(torch, single, half, d, 33, dev)
    fill_rows(torch, single, half, d, 34, dev)
    merged, merge_ms, _ = verb(torch, mips, card, "merge_from 2^19 rows",
                               lambda: a.merge_from(b), searches=False)
    check(merged == half and a.ntotal == n, f"merge_from: {merged} rows, ntotal {a.ntotal}")
    (Dm, Im), _, launches = verb(torch, mips, card, "search merged", lambda: a.search(queries, k))
    total += launches
    Ds, Is = single.search(queries, k)
    check(np.array_equal(Im, Is) and np.array_equal(Dm, Ds),
          "merge_from: the merged index's top-k differs from the single build's")
    del a, b, single
    torch.cuda.empty_cache()

    # save / load at 2^18 rows (cut from 2^20 for disk space and the run's time)
    snap_n = 1 << 18
    s_idx = DenseIndex(d, snap_n, device=dev)
    fill_rows(torch, s_idx, snap_n, d, 35, dev)
    D1, I1 = s_idx.search(queries, k)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snap")
        snap, cap_ms, _ = verb(torch, mips, card, "snapshot() of 2^18 rows",
                               s_idx.snapshot, searches=False)
        _, write_ms, _ = verb(torch, mips, card, "write_snapshot",
                              lambda: DenseIndex.write_snapshot(snap, path), searches=False)
        del snap
        size_gb = os.path.getsize(path + ".npz") / 1e9
        back, load_ms, _ = verb(torch, mips, card, "load", lambda: DenseIndex.load(path, device=dev),
                                searches=False)
    (D2, I2), _, launches = verb(torch, mips, card, "search the loaded index",
                                 lambda: back.search(queries, k))
    total += launches
    check(np.array_equal(I1, I2) and np.array_equal(D1, D2),
          "save/load: the loaded index's top-k differs")
    print(f"dense maintenance [{card}]: search {cos_ms:.1f} ms; remove_ids 65,536 {rm_ms:.1f} ms, "
          f"search after {search_rm_ms:.1f} ms (value-recall@10 1.0, no removed row); refill "
          f"{add_ms:.1f} ms, search {refill_ms:.1f} ms; range_search {range_ms:.1f} ms; l2 "
          f"search {l2_ms:.1f} ms; merge_from {merge_ms:.1f} ms; snapshot of 2^18 x 1600 "
          f"({size_gb:.2f} GB): capture {cap_ms:.1f} ms, write {write_ms:.1f} ms, load "
          f"{load_ms:.1f} ms; {total} K1 launches, all f32 wgmma")
    del back, s_idx
    torch.cuda.empty_cache()
    return total


def items_of(sess) -> list:
    """Product ids of a session's non-search actions, in order."""
    return [a[-1] for a in sess if a[1] != "s"]


def sparse_cos(kind, q, s) -> float:
    """The hybrid fusion's sparse term, straight from its definition: the
    cosine of binary item indicators ('overlap') or of STAN recency weights
    exp((i - L) / 1.04) summed per item ('stan')."""
    if kind == "overlap":
        a, b = set(items_of(q)), set(items_of(s))
        return len(a & b) / (len(a) * len(b)) ** 0.5 if a and b else 0.0

    def stan(x):
        seq = items_of(x)
        w = {}
        for i, item in enumerate(seq):
            w[item] = w.get(item, 0.0) + np.exp((i - len(seq)) / 1.04)
        norm = np.sqrt(sum(v * v for v in w.values()))
        return {key: v / norm for key, v in w.items()} if norm > 0 else {}

    wq, ws = stan(q), stan(s)
    return float(sum(v * ws.get(key, 0.0) for key, v in wq.items()))


def phase_engine_verbs(torch, mips, topk_mod, dev, parts, card):
    """The serving verbs of the default f32 engine at Config() width, on
    phase 4's encoder and 8,192 sessions."""
    import collections

    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.engine import _session_key

    cfg, tok, enc, data, corpus = parts
    n = len(data)
    rng = np.random.default_rng(41)

    def new_engine():
        return port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,
                                        capacity=65536, device=dev)

    eng = new_engine()
    where_from = {id(d[0]): i for i, d in enumerate(data)}  # stored session -> datum
    total = 0
    print(f"engine verbs: SessionSearchEngine Config() f32, {n} sessions")

    # async ingest of 8 stamped batches while this thread answers searches
    def ingest():
        for b in range(8):
            eng.add_sessions_async(data[b * 1024: (b + 1) * 1024], stamp=float(b))
        answered = 0
        while eng._ingest_q.unfinished_tasks:
            D, I = eng.search(data[:256], k=100)
            check(((I >= -1) & (I < eng.index.ntotal)).all() and np.isfinite(D[I >= 0]).all(),
                  "a search during ingest returned a bad row")
            answered += 1
        eng.flush()
        return answered

    answered, ingest_ms, launches = verb(
        torch, mips, card, "add_sessions_async 8 x 1,024 while searching 256 at k=100", ingest)
    total += launches
    check(eng.index.ntotal == n and eng.stats()["pending"] == 0,
          f"async ingest: ntotal {eng.index.ntotal}")
    stored_err = float(np.abs(eng.reconstruct(np.arange(n)) - corpus).max())
    check(stored_err <= 1e-5, f"async ingest: rows differ from phase 4's by {stored_err}")
    sample = [data[i] for i in range(0, n, 32)]
    (D, I), _, launches = verb(torch, mips, card, "search 256 after flush",
                               lambda: eng.search(sample, k=100))
    total += launches
    top1_err = float(np.abs(D[:, 0] - 1.0).max())
    self_hits = float((I[:, 0] == np.arange(0, n, 32)).mean())
    check(top1_err <= 1e-3, f"async ingest: top-1 score off 1.0 by {top1_err}")
    print(f"  async ingest: {answered} searches answered during it ({n / ingest_ms * 1e3:.0f} "
          f"sessions/s with them); rows equal phase 4's to {stored_err:.3g}; top-1 |score-1| max "
          f"{top1_err:.3g}, self-hit ids {self_hits:.4f}")

    # removal by id, by content, and by age
    keys = collections.Counter(_session_key(s) for s in eng.sessions)
    rm_ids = rng.choice(n, 512, replace=False)
    keys -= collections.Counter(_session_key(eng.sessions[i]) for i in rm_ids)
    removed, _, _ = verb(torch, mips, card, "remove_sessions(ids=) 512 rows",
                         lambda: eng.remove_sessions(ids=rm_ids), searches=False)
    check(removed == 512 and eng.index.ntotal == n - 512,
          f"remove_sessions(ids=): {removed} removed, ntotal {eng.index.ntotal}")
    check(collections.Counter(_session_key(s) for s in eng.sessions) == keys,
          "remove_sessions(ids=): the stored sessions are not the survivors")
    victims = [eng.sessions[i] for i in rng.choice(eng.index.ntotal, 64, replace=False)]
    vkeys = {_session_key(s) for s in victims}
    want = sum(c for key, c in keys.items() if key in vkeys)
    removed, _, _ = verb(torch, mips, card, "remove_sessions(data=) 64 sessions",
                         lambda: eng.remove_sessions(data=victims), searches=False)
    check(removed == want and not any(_session_key(s) in vkeys for s in eng.sessions),
          f"remove_sessions(data=): removed {removed} of {want} rows")
    (D, I), _, launches = verb(torch, mips, card, "search the 64 removed sessions",
                               lambda: eng.search(victims, k=10))
    total += launches
    check(not any(_session_key(eng.sessions[i]) in vkeys for i in I[I >= 0]),
          "removed content was returned")
    want = int((eng._stamps.view() < 1.0).sum())
    removed, _, _ = verb(torch, mips, card, "expire(before=1.0)",
                         lambda: eng.expire(before=1.0), searches=False)
    check(removed == want and (eng._stamps.view() >= 1.0).all(),
          f"expire: removed {removed} of {want} stamped rows")
    pos = rng.choice(eng.index.ntotal, 256, replace=False)
    emb = eng.embed([data[where_from[id(eng.sessions[p])]] for p in pos])
    align_err = float(np.abs(emb / np.linalg.norm(emb, axis=1, keepdims=True)
                             - eng.reconstruct(pos)).max())
    check(align_err <= 1e-5, f"removal: a stored row and its session differ by {align_err}")
    print(f"  removal: ntotal {eng.index.ntotal} after 512 by id, {want} expired and the "
          f"rows of 64 sessions by content; 256 stored rows re-encoded from their sessions "
          f"agree to {align_err:.3g}")

    # hybrid fusion against a recompute of the fusion on the same candidates
    live = [data[where_from[id(eng.sessions[p])]] for p in rng.choice(eng.index.ntotal, 64,
                                                                      replace=False)]
    D2, I2 = eng.search(live, k=40)  # the candidates: overfetch 4 x k=10
    for kind in ("overlap", "stan"):
        for fusion in ("score", "rrf"):
            (Dh, Ih), _, launches = verb(
                torch, mips, card, f"hybrid search {kind}/{fusion}, 64 queries k=10",
                lambda: eng.search(live, k=10, hybrid_alpha=0.5, hybrid_kind=kind,
                                   hybrid_fusion=fusion))
            total += launches
            D_ref = np.zeros((64, 10))
            I_ref = np.zeros((64, 10), np.int64)
            for r, (q, _) in enumerate(live):
                sp = [sparse_cos(kind, q, eng.sessions[g]) for g in I2[r]]
                if fusion == "score":
                    fused = [0.5 * D2[r, c] + 0.5 * sp[c] for c in range(40)]
                else:  # sparse ranks of the f32 sparse scores, ties in column order
                    sp32 = np.float32(sp)
                    sp_rank = {c: w for w, c in enumerate(sorted(range(40), key=lambda c: -sp32[c]))}
                    fused = [1 / (60 + c) + 1 / (60 + sp_rank[c]) for c in range(40)]
                top = sorted(range(40), key=lambda c: -fused[c])[:10]
                D_ref[r] = [fused[c] for c in top]
                I_ref[r] = I2[r, top]
            err = float(np.abs(Dh - D_ref).max())
            same = float((Ih == I_ref).mean())
            check(err <= 1e-5 and same >= 0.99,
                  f"hybrid {kind}/{fusion}: scores off the recompute by {err}, ids equal {same}")
            print(f"    {kind}/{fusion}: fused scores vs the recompute max_abs_err {err:.3g}, "
                  f"ids equal {same:.4f}")

    # range search with a filter, against the f64 oracle's thresholded sets
    def where(sess):
        return len(sess) % 2 == 0

    Dk, _ = eng.search(live, k=100, where=where)
    radius = float(Dk[0, 49])
    (lims, Dr, Ir), _, launches = verb(
        torch, mips, card, f"range_search 64 queries where=, radius {radius:.5f}",
        lambda: eng.range_search(live, radius, where=where))
    total += launches
    allowed = torch.from_numpy(eng._where_mask(where)).to(dev)
    check(bool(allowed[torch.from_numpy(Ir).to(dev)].all().item()),
          "range_search: a row the filter refuses was returned")
    qe = topk_mod.l2_normalize(eng.embed(live, out="device").float()).double()
    exact = f64_scores(torch, qe, eng.index._buf, eng.index.ntotal)
    exact[:, ~allowed] = float("-inf")
    hits = np.diff(lims)
    differ, tie_gap = range_vs_oracle(torch, lims, Ir, exact, radius)
    check(hits[0] >= 50 and tie_gap <= 1e-5,
          f"range_search where=: {hits[0]} hits for query 0, a set differs from the oracle's "
          f"by a row {tie_gap} from the radius")
    print(f"  range_search where=: hits per query min {hits.min()} median {int(np.median(hits))} "
          f"max {hits.max()}; {differ} rows differ from the f64 oracle's sets")

    # save_async while searches and ingest go on, then restore into a fresh engine
    D_cap, I_cap = eng.search(sample, k=100)
    n_cap = eng.index.ntotal
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "engine")
        handle, cap_ms, _ = verb(torch, mips, card, "save_async (capture)",
                                 lambda: eng.save_async(prefix), searches=False)
        t0 = time.perf_counter()
        eng.add_sessions_async(data[:256])  # ingest during the write
        during = 0
        while not handle.done():
            eng.search(live, k=10)
            during += 1
        handle.join()
        write_ms = (time.perf_counter() - t0) * 1e3
        eng.close()
        check(eng.index.ntotal == n_cap + 256, f"save_async: live ntotal {eng.index.ntotal}")
        del eng
        torch.cuda.empty_cache()
        fresh = new_engine()
        _, restore_ms, _ = verb(torch, mips, card, "restore into a fresh engine",
                                lambda: fresh.restore(prefix), searches=False)
    check(fresh.index.ntotal == n_cap, f"restore: ntotal {fresh.index.ntotal}, captured {n_cap}")
    (D_r, I_r), _, launches = verb(torch, mips, card, "search the restored engine",
                                   lambda: fresh.search(sample, k=100))
    total += launches
    check(np.array_equal(I_r, I_cap) and np.array_equal(D_r, D_cap),
          "restore: the restored engine's top-k differs from the capture point's")
    print(f"engine verbs [{card}]: save_async capture {cap_ms:.1f} ms, write {write_ms:.1f} ms "
          f"with {during} searches and a 256-session ingest beside it, restore {restore_ms:.1f} "
          f"ms; {total} K1 launches, all f32 wgmma")
    print(f"engine verbs stats: {json.dumps(fresh.stats())}")
    return total


def phase_bf16_engine(torch, mips, topk_mod, dev, parts):
    import sessionsimilaritysearch_tpu_torch as port

    cfg, tok, enc, data, _ = parts
    eng = port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,
                                   capacity=65536, device=dev, dtype=torch.bfloat16)
    mips.launch_count = mips.wgmma_launch_count = 0  # the path's launches from ingest on
    t0 = time.perf_counter()
    eng.add_sessions(data)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    D, I = eng.search(data[:256], k=100)
    search_s = time.perf_counter() - t0
    launches, wgmma = mips.launch_count, mips.wgmma_launch_count
    idx = eng.index
    chunks = -(-idx.ntotal // idx.chunk_size)
    check(idx.ntotal == len(data), f"bf16 engine: ntotal {idx.ntotal}")
    check(D.shape == (256, 100) and np.isfinite(D).all(), "bf16 engine: bad result")
    check(wgmma == chunks and launches == chunks,
          f"bf16 engine: {wgmma} wgmma K1 launches of {launches} for {chunks} chunk(s)")
    # a session's own bf16 row against its bf16 query: two bf16 ulps of 1.0
    top1_err = float(np.abs(D[:, 0] - 1.0).max())
    check(top1_err <= BF16_TOL, f"bf16 engine: top-1 score off 1.0 by {top1_err}")

    # the wgmma K1 against its plain version on the engine's own inputs: the
    # queries cast and normalized in bf16 as search() takes them, and the
    # stored bf16 rows
    bf = torch.bfloat16
    qb = topk_mod.l2_normalize(eng.embed(data[:256], out="device").to(bf)).to(bf).contiguous()
    corpus = idx._buf[: idx.ntotal]
    sd = idx.score_dtype
    ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max(qb, corpus, score_dtype=sd), 10)
    plain_ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max_ref(
        qb, corpus, score_dtype=sd), 10)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(qb, corpus.T), 10)
    s, bm = mips.scores_with_bucket_max(qb, corpus, score_dtype=sd)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(qb, corpus, score_dtype=sd)
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = (s.float() - s_ref.float()).abs().max().item()
    v_ref, _ = mips.select_topk(s_ref, bm_ref, 100)
    d_err = float(np.abs(D - v_ref.cpu().numpy()).max())
    # unit rows, |s| <= 1: f32 sums of exact bf16 products in another order
    check(bm_err <= 1e-5, f"bf16 engine: bmax max_abs_err {bm_err}")
    check(s_err <= 1e-5, f"bf16 engine: scores max_abs_err {s_err}")
    check(d_err <= 1e-5, f"bf16 engine: search() vs plain top-100 max_abs_err {d_err}")
    print(f"bf16 engine Config() (dtype=bfloat16, {str(sd)[6:]} scores): ingest "
          f"{len(data)} sessions {ingest_s:.2f} s ({len(data) / ingest_s:.0f} sessions/s); "
          f"search 256 k=100 {search_s * 1e3:.1f} ms; top-1 |score-1| max {top1_err:.3g}, "
          f"self-hit ids {float((I[:, 0] == np.arange(256)).mean()):.4f}; K1 launches "
          f"{launches}, all wgmma variant ({wgmma}); engine's inputs q=256 n={idx.ntotal} "
          f"d={qb.shape[1]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS bf16 GEMM "
          f"{lib_ms:.4f} ms; bmax max_abs_err {bm_err:.3g}, scores max_abs_err "
          f"{s_err:.3g}, search() top-100 vs plain {d_err:.3g}")
    print(f"bf16 engine stats: {json.dumps(eng.stats())}")
    return wgmma, bm_err


def has_product(datum) -> bool:
    return any(a[1] != "s" for a in datum[0])


def bf16_agreement(torch, got, want) -> tuple:
    """(smallest row cosine, largest |difference| over the largest |want|)
    of two [B, d] outputs; the bf16 tolerance asks >= 0.999 and <= 2^-6."""
    got, want = got.double().cpu(), want.double().cpu()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1).min().item()
    return cos, ((got - want).abs().max() / want.abs().max()).item()


def check_bf16(torch, got, want, what) -> tuple:
    cos, rel = bf16_agreement(torch, got, want)
    check(cos >= BF16_COS and rel <= BF16_REL,
          f"{what}: min row cosine {cos:.6f} (>= {BF16_COS}), max |diff| / max |ref| "
          f"{rel:.3g} (<= 2^-6)")
    return cos, rel


def staged_forward(torch, encoder, fn, sessions, tok, cfg, dev, sync):
    """One batch of the fully cached forward, stage by stage, each stage in
    its own torch.profiler span: host graph build, keyword lookup (host),
    upload, node gather (the table rows), GNN, pooling. With ``sync`` the
    card is synchronized after each stage and the host clock read."""
    from torch.profiler import record_function

    from sessionsimilaritysearch_tpu_torch.data import build_graph_batch
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import _upload, to_device

    times, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        times[name] = (t - t0) * 1e3
        t0 = t

    with torch.inference_mode():
        with record_function("graph build"):
            batch = build_graph_batch(sessions, tok, cfg.dims, ignore_query=cfg.ignore_query)
        stage("graph build")
        with record_function("keyword lookup"):
            kw = fn.prepare(batch)["query_kw"]
        stage("keyword lookup")
        with record_function("upload"):
            g, kw = to_device(batch, dev), _upload(kw, dev)
        stage("upload")
        with record_function("node gather"):
            emb = encoder.node_embeddings(g, title_table=fn.title_table,
                                          query_table=fn.query_table, query_kw=kw)
        stage("node gather")
        with record_function("gnn"):
            nodes = encoder.gnn(emb, g)
        stage("gnn")
        with record_function("pooling"):
            out = encoder.readout(nodes, g)
        stage("pooling")
    return out, g, times


def device_rows(torch, prof, calls) -> list:
    """(name, device ms per call, count per call) of every event the
    profiler put on the card's timeline, largest first: the kernels and
    copies, and each ``record_function`` span that covers device work (as
    the profiler's GPU annotation of that span)."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((e.key, t / 1e3 / calls, e.count // calls))
    return sorted(rows, key=lambda r: -r[1])


def phase_flagship_serving(torch, mips, topk_mod, dev, parts, card, f32_rate):
    """The flagship serving forward at Config() width: bf16 serving_params,
    the catalog title and keyword tables, make_cached_encode_fn inside a
    default f32 engine searched through K1 (every launch the f32 wgmma
    variant), the recency pooling; returns K1's launches on this path from
    the fully cached engine's ingest to its search, and the kernel's largest
    error against its plain version."""
    import copy

    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.data import build_graph_batch
    from sessionsimilaritysearch_tpu_torch.evalharness import harness as H
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

    cfg, tok, enc, data, _ = parts
    titles = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).titles
    keywords = [a[2] or "" for s, _ in data for a in s if a[1] == "s"]
    bf = serving_params(enc)
    n_bf16 = sum(p.numel() for p in bf.parameters() if p.dtype == torch.bfloat16)
    n_all = sum(p.numel() for p in bf.parameters())
    tables = {}
    for name, e in (("f32", enc), ("bf16", bf)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        title = H.build_title_table(cfg, tok, titles, e)
        torch.cuda.synchronize()
        title_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        qtab, lookup = H.build_keyword_table(cfg, tok, keywords, e)
        torch.cuda.synchronize()
        kw_s = time.perf_counter() - t0
        tables[name] = (title, qtab, lookup)
        print(f"flagship serving {name} tables [{card}]: title table {tuple(title.shape)} "
              f"{title.dtype} {title.numel() * title.element_size() / 1e9:.3f} GB in "
              f"{title_s:.2f} s ({len(titles) / title_s:.0f} titles/s, batches of 1024); "
              f"keyword table {tuple(qtab.shape)} {qtab.numel() * qtab.element_size()} bytes "
              f"in {kw_s * 1e3:.1f} ms ({len(set(keywords))} distinct keywords)")
    check(tables["bf16"][0].dtype == torch.bfloat16 and tables["f32"][0].dtype == torch.float32,
          "flagship serving: table dtypes do not follow the weights")
    check(tables["bf16"][2] == tables["f32"][2], "flagship serving: keyword lookups differ")
    title, qtab, lookup = tables["bf16"]
    fns = {"f32": H.make_cached_encode_fn(enc, *tables["f32"]),
           "bf16": H.make_cached_encode_fn(bf, title, qtab, lookup)}

    # 256 sessions with products: cached against uncached on the card
    sel = [d for d in data if has_product(d)][:256]
    batch = build_graph_batch(sel, tok, cfg.dims, ignore_query=cfg.ignore_query)
    g = to_device(batch, dev)
    kw = torch.from_numpy(H.keyword_ids(lookup, batch.query_input_ids)).to(dev)
    out = {}
    with torch.inference_mode():
        for name, e in (("f32", enc), ("bf16", bf)):
            t, q, _ = tables[name]
            out[name] = {"uncached": e(g), "title": e(g, title_table=t),
                         "full": e(g, title_table=t, query_table=q, query_kw=kw)}
    ref = out["f32"]["uncached"]
    scale = ref.abs().max().item()
    errs = {}
    for form in ("title", "full"):
        got = out["f32"][form]
        # the JAX package's cached-forward test (rtol 1e-5, atol 1e-4),
        # its atol taken relative to the output's scale where that exceeds 1
        excess = ((got - ref).abs() - 1e-5 * ref.abs()).max().item()
        errs[form] = (got - ref).abs().max().item()
        check(excess <= 1e-4 * max(1.0, scale),
              f"flagship serving: f32 {form}-cached vs uncached exceeds rtol 1e-5 by "
              f"{excess:.3g} (atol {1e-4 * max(1.0, scale):.3g})")
    bf_agree = {form: check_bf16(torch, out["bf16"][form], out["bf16"]["uncached"],
                                 f"flagship serving: bf16 {form}-cached vs uncached")
                for form in ("title", "full")}
    cos_f32 = bf16_agreement(torch, out["bf16"]["full"], ref)[0]
    check(cos_f32 >= 0.98, f"flagship serving: bf16 vs f32 min row cosine {cos_f32:.4f}")

    # the card's bf16 cached forward against the CPU's, the same weights and
    # tables; and the card's title table rows against the CPU's text backbone
    cpu = torch.device("cpu")
    cpu_bf = copy.deepcopy(bf).to(cpu)
    with torch.inference_mode():
        on_cpu = cpu_bf(to_device(batch, cpu), title_table=title.cpu(), query_table=qtab.cpu(),
                        query_kw=kw.cpu())
        asins = np.unique(batch.product_asin[batch.product_node_mask > 0])[:256]
        t = tok([titles[i] for i in asins], max_length=cfg.dims.token_len)
        rows_cpu = cpu_bf.embed_texts(*(torch.from_numpy(t[k]) for k in (
            "input_ids", "token_type_ids", "attention_mask")))
    # on the same tables the fully cached forward runs no text backbone, so
    # card and CPU agree far inside the bf16 tolerance: CARD_CPU_REL, which
    # the card's f32 fully cached forward must miss (the bound tells the
    # bf16 serving policy from f32)
    cpu_agree = check_bf16(torch, out["bf16"]["full"], on_cpu,
                           "flagship serving: card vs CPU bf16 cached forward")
    f32_agree = bf16_agreement(torch, out["f32"]["full"], on_cpu)
    check(cpu_agree[1] <= CARD_CPU_REL < f32_agree[1],
          f"flagship serving: card vs CPU bf16 cached forward max |diff| / max |ref| "
          f"{cpu_agree[1]:.3g}, the f32 forward's {f32_agree[1]:.3g}: the bound "
          f"{CARD_CPU_REL} must hold for bf16 and fail for f32")
    rows = torch.from_numpy(asins).to(dev)
    row_agree = check_bf16(torch, title[rows].float(), rows_cpu.float(),
                           "flagship serving: card vs CPU title rows")
    row_f32 = bf16_agreement(torch, tables["f32"][0][rows], rows_cpu.float())
    del cpu_bf
    print(f"flagship serving, 256 sessions with products [{card}]: f32 cached vs uncached "
          f"max_abs_err title {errs['title']:.3g}, full {errs['full']:.3g} (scale {scale:.3g}); "
          f"bf16 cached vs uncached (min row cosine, max |diff| / max |ref|) title "
          f"{bf_agree['title'][0]:.6f} / {bf_agree['title'][1]:.3g}, full "
          f"{bf_agree['full'][0]:.6f} / {bf_agree['full'][1]:.3g}; bf16 vs f32 min row cosine "
          f"{cos_f32:.5f}; card vs CPU bf16 full {cpu_agree[0]:.6f} / {cpu_agree[1]:.3g} "
          f"(card f32 full vs CPU bf16 {f32_agree[0]:.6f} / {f32_agree[1]:.3g}), "
          f"{len(asins)} title rows {row_agree[0]:.6f} / {row_agree[1]:.3g} (card f32 rows "
          f"vs CPU bf16 {row_f32[0]:.6f} / {row_f32[1]:.3g}); serving "
          f"parameters {n_bf16 / 1e6:.1f} M of {n_all / 1e6:.1f} M in bf16")

    # ingest the 8,192 sessions three ways; the fully cached engine is the
    # main path: K1's counts go to 0 just before its ingest, read after search
    forms = (("bf16 uncached", bf), ("bf16 title-only", H.make_cached_encode_fn(bf, title)),
             ("bf16 fully cached", fns["bf16"]))
    rates = {}
    for name, fn in forms:
        eng = port.SessionSearchEngine(cfg, tok, fn, dim=cfg.session_emb_dim,
                                       capacity=65536, device=dev)
        eng.embed(data[:8])  # warm-up, counted as set-up
        torch.cuda.synchronize()
        mips.launch_count = mips.wgmma_launch_count = 0
        t0 = time.perf_counter()
        eng.add_sessions(data)
        torch.cuda.synchronize()
        rates[name] = len(data) / (time.perf_counter() - t0)
        check(eng.index.ntotal == len(data), f"flagship serving: {name} ntotal {eng.index.ntotal}")
    t0 = time.perf_counter()
    D, I = eng.search(data[:256], k=100)
    search_s = time.perf_counter() - t0
    launches, wgmma = mips.launch_count, mips.wgmma_launch_count
    check(launches >= 1 and wgmma == launches,
          f"flagship serving: {launches - wgmma} of {launches} K1 launches were not the "
          "f32 wgmma variant")
    check(eng.index.dtype == torch.float32, "flagship serving: the index is not f32")
    check(D.shape == (256, 100) and np.isfinite(D).all(), "flagship serving: bad result")
    top1_err = float(np.abs(D[:, 0] - 1.0).max())
    check(top1_err <= 1e-3, f"flagship serving: top-1 score off 1.0 by {top1_err}")
    self_hits = float((I[:, 0] == np.arange(256)).mean())
    qs = topk_mod.l2_normalize(eng.embed(data[:256], out="device").float()).contiguous()
    corpus = eng.index._buf[: eng.index.ntotal]
    check(mips.k1_variant(dev.type, qs.dtype, qs.shape[1], (qs.data_ptr(), corpus.data_ptr()))
          == "wgmma", "flagship serving: the engine's rows do not take the f32 wgmma variant")
    s, bm = mips.scores_with_bucket_max(qs, corpus)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(qs, corpus)
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = (s - s_ref).abs().max().item()
    v_ref, _ = mips.select_topk(s_ref, bm_ref, 100)
    d_err = float(np.abs(D - v_ref.cpu().numpy()).max())
    check(bm_err <= 1e-5 and s_err <= 1e-5 and d_err <= 1e-5,
          f"flagship serving: K1 vs plain bmax {bm_err}, scores {s_err}, search() top-100 "
          f"{d_err}")
    print(f"flagship serving ingest of {len(data)} sessions [{card}]: "
          + ", ".join(f"{name} {r:.0f} sessions/s" for name, r in rates.items())
          + f"; phase 4's f32 uncached {f32_rate:.0f} sessions/s")
    print(f"flagship serving search 256 k=100 on the fully cached engine: {search_s * 1e3:.1f} "
          f"ms; top-1 |score-1| max {top1_err:.3g}, self-hit ids {self_hits:.4f}; K1 launches "
          f"{launches} from ingest to search, all f32 wgmma; kernel vs plain on the engine's "
          f"inputs: bmax max_abs_err {bm_err:.3g}, scores {s_err:.3g}, search() top-100 "
          f"{d_err:.3g}")
    print(f"flagship serving stats: {json.dumps(eng.stats())}")
    del eng

    # where one 256-session batch of the fully cached forward goes: stage
    # times on the host clock with a synchronize after each stage, then the
    # same batch under torch.profiler (device time per stage and kernel)
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn = fns["bf16"]
    staged, g256, _ = staged_forward(torch, bf, fn, data[:256], tok, cfg, dev, True)
    with torch.inference_mode():
        whole = fn(g256)  # the keyword ids read back from the graph on the card
    check((staged - whole).abs().max().item() <= 1e-5 * whole.abs().max().item(),
          "flagship serving: the staged forward is not the cached forward")
    calls = 3
    stage_ms = {}
    for _ in range(calls):
        _, _, times = staged_forward(torch, bf, fn, data[:256], tok, cfg, dev, True)
        for k, v in times.items():
            stage_ms[k] = stage_ms.get(k, 0.0) + v / calls
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            staged_forward(torch, bf, fn, data[:256], tok, cfg, dev, False)
        torch.cuda.synchronize()
    rows = device_rows(torch, prof, calls)
    spans = {name: ms for name, ms, _ in rows if name in stage_ms}
    kernels = [r for r in rows if r[0] not in stage_ms]
    busy = sum(t for _, t, _ in kernels)
    total = sum(stage_ms.values())
    print(f"flagship serving profile, one 256-session batch of the bf16 fully cached forward "
          f"[{card}]: {total:.2f} ms on the host clock ({256 / total * 1e3:.0f} sessions/s "
          f"alone), device busy {busy:.3f} ms")
    for name, ms in stage_ms.items():
        dev_ms = spans.get(name)
        print(f"  {name:15s} {ms:8.3f} ms host clock (synchronized), device span "
              + ("none (no device work)" if dev_ms is None else f"{dev_ms:.3f} ms"))
    for key, ms, count in kernels[:8]:
        print(f"  {ms:9.3f} ms  x{count:<3d} {key[:90]}")

    # the recency pooling on the card: the flagship's text backbone and asin
    # table (so the same tables), its own pooling, 1,024 sessions ingested
    rcfg = cfg.replace(product_pooling="recency")
    renc = port.build_graph_encoder(rcfg, dev, torch.Generator(device=dev).manual_seed(1))
    shared = {k: v for k, v in enc.state_dict().items() if not k.startswith("product_pooling.")}
    missing, unexpected = renc.load_state_dict(shared, strict=False)
    check(not unexpected and missing and all(k.startswith("product_pooling.") for k in missing),
          f"flagship serving: recency encoder state {missing} {unexpected}")
    rbf = serving_params(renc)
    del renc
    rfn = H.make_cached_encode_fn(rbf, title, qtab, lookup)
    reng = port.SessionSearchEngine(rcfg, tok, rfn, dim=rcfg.session_emb_dim, capacity=4096,
                                    device=dev)
    r_data = data[:1024]
    t0 = time.perf_counter()
    reng.add_sessions(r_data)
    torch.cuda.synchronize()
    r_rate = len(r_data) / (time.perf_counter() - t0)
    rD, rI = reng.search(data[:64], k=10)
    r_top1 = float(np.abs(rD[:, 0] - 1.0).max())
    check(np.isfinite(rD).all() and r_top1 <= 1e-3,
          f"flagship serving: recency engine top-1 off 1.0 by {r_top1}")
    with torch.inference_mode():
        r_agree = check_bf16(torch, rfn(g, query_kw=kw), rbf(g),
                             "flagship serving: recency cached vs uncached")
    lam = torch.nn.functional.softplus(rbf.product_pooling.raw_lambda.float()).item()
    oov = sum(f.oov_batches for f in (*fns.values(), forms[1][1], rfn))
    check(oov == 0, f"flagship serving: {oov} batches took the out-of-vocabulary path")
    print(f"flagship serving recency pooling (lambda {lam:.4f}): ingest {len(r_data)} sessions "
          f"{r_rate:.0f} sessions/s, search 64 k=10 top-1 |score-1| max {r_top1:.3g}, self-hit "
          f"ids {float((rI[:, 0] == np.arange(64)).mean()):.4f}; cached vs uncached on the "
          f"256 sessions {r_agree[0]:.6f} / {r_agree[1]:.3g}")
    print(f"flagship serving: out-of-vocabulary fallbacks {oov}")
    del reng, rbf, tables, fns, out
    torch.cuda.empty_cache()
    return launches, bm_err


# pretraining phase: the port's pretrainer at Config() width
PRE_WARM, PRE_TIMED, PRE_REPEAT = 3, 20, 10  # warm-up, timed and repeated-batch steps
PRE_PROFILED = 3  # steps in the torch.profiler breakdown
PRE_LOOP_ROUNDS, PRE_LOOP_STEPS = 4, 10  # run_training rounds (each variant), steps a round
# the cached-tables step against the uncached one (the JAX package's bound)
PRE_CACHED_RTOL = 1e-5
# the card against the CPU on one full-width step of 8 sessions: the loss's
# relative difference, each parameter leaf's clipped gradient (|card - CPU|
# / |CPU|; largest 6.21e-05 in two runs on an H100, PERF.md) and update
# cosine
PRE_CPU_LOSS_RTOL, PRE_CPU_GRAD_REL, PRE_CPU_UPDATE_COS = 1e-5, 1e-3, 0.9999
PRE_NOISE_RMS = 1e-4  # a leaf's rms gradient over all gradients' rms: below, rounding noise
PRE_SPANS = ("sss.encoder.text", "sss.encoder.gnn", "sss.encoder.pooling", "head + loss",
             "backward", "clip", "adam")


def percentile(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def pretrain_steps(torch, step, state, graphs, **kw):
    """Run one step per graph (a (device graph, extra kwargs) pair); returns
    the losses and each step's host-clock ms around a synchronized step."""
    losses, ms = [], []
    for g, extra in graphs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, g, **extra, **kw)
        loss = float(m["loss"])  # the loop's host read of the loss
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return losses, ms


def span_device_ms(torch, prof, names, calls) -> dict:
    """Device ms a call of each ``record_function`` span in ``names``: the
    kernels and copies launched, from any thread (the backward's run on
    autograd's), while the span was open on the host, each given to the
    innermost span around its launch and summed (no gaps); ``other`` the
    rest; ``host`` each span's host ms a call (under the profiler)."""
    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu if e.name in names]
    out = {n: 0.0 for n in (*names, "other")}
    host = {n: 0.0 for n in names}
    for t0, t1, name in spans:
        host[name] += (t1 - t0) / 1e3 / calls
    for e in cpu:
        t = sum(k.duration for k in e.kernels)
        if not t:
            continue
        s = e.time_range.start
        inside = [(t1 - t0, name) for t0, t1, name in spans if t0 <= s <= t1]
        out[min(inside)[1] if inside else "other"] += t / 1e3 / calls
    return {"device": out, "host": host}


def phase_pretrain(torch, mips, dev, card):
    """The port's pretrainer at Config() width (batch 50, 391,572 asins),
    seeded random weights: the uncached step (the CLI's path), a profiled
    breakdown, the cached-tables step, the card against the CPU,
    checkpoints, and the trained encoder into an f32 DenseIndex searched
    through K1. Returns K1's counts on the serving part."""
    import copy

    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.data import build_graph_batch
    from sessionsimilaritysearch_tpu_torch.evalharness import harness as H
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.training import pretrain as tp
    from sessionsimilaritysearch_tpu_torch.training.loop import run_training
    from sessionsimilaritysearch_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        state_to_tree,
        tree_to_state,
    )
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.empty_cache()
    cfg = port.Config()
    B = cfg.batch_size
    tok = port.get_tokenizer(cfg.vocab_size)
    gen = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=1)
    n_steps = PRE_WARM + PRE_TIMED
    # sessions with a product: the title table gathers asin 0's real title
    # for the no-product placeholder node (the JAX package's caveat)
    sessions = [d for d in gen.dataset(int(1.3 * B * n_steps) + 64) if has_product(d)]
    check(len(sessions) >= B * n_steps, "pretrain: too few sessions with a product")
    hosts = [build_graph_batch(sessions[i * B:(i + 1) * B], tok, cfg.dims,
                               ignore_query=cfg.ignore_query) for i in range(n_steps)]
    t0 = time.perf_counter()
    model, state = tp.create_pretrain_state(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    n_frozen = sum(p.numel() for p in model.encoder.query_node_embedder.parameters())
    step = tp.make_train_step(model)
    print(f"pretrain Config() [{card}]: {n_params / 1e6:.1f} M parameters ({n_frozen / 1e6:.1f} M "
          f"in the frozen text backbone, {cfg.asin_num * cfg.emb_len / 1e6:.1f} M in the "
          f"target asin table), batch {B}, built in {time.perf_counter() - t0:.1f} s")

    # 1. the uncached step (the CLI's path: run_training uploads each batch)
    graphs = [(to_device(h, dev), {}) for h in hosts]
    warm, _ = pretrain_steps(torch, step, state, graphs[:PRE_WARM])
    losses, ms = pretrain_steps(torch, step, state, graphs[PRE_WARM:])
    check(all(np.isfinite(warm + losses)), f"pretrain: non-finite losses {warm + losses}")
    med, p90 = percentile(ms, 50), percentile(ms, 90)
    print(f"  uncached step [{card}]: median {med:.2f} ms, p90 {p90:.2f} ms over {PRE_TIMED} "
          f"steps after {PRE_WARM} warm-up ({B / med * 1e3:.0f} sessions/s) {smi()}; "
          f"loss curve {' '.join(f'{x:.4f}' for x in warm + losses)}")
    # one batch repeated with the same draws: the objective is fixed
    g0 = graphs[0][0]
    draws = model.draw(g0, state.generator)
    rep, _ = pretrain_steps(torch, step, state, [(g0, {"draws": draws})] * (PRE_REPEAT + 1))
    check(rep[-1] < rep[0], f"pretrain: loss after {PRE_REPEAT} steps on one batch "
          f"{rep[-1]} is not below the first {rep[0]}")
    print(f"  one batch repeated: loss {rep[0]:.5f} -> {rep[-1]:.5f} after {PRE_REPEAT} steps")

    # the loop (run_training: upload, step, the host read of the loss) as
    # shipped, with its drop buffer (nan_recovery, no checkpoint of its own:
    # a copy of the state before each step), and with a host read of the
    # loss between the forward and the backward (a forward hook: what a step
    # that decided on non-finite losses itself would wait for), in
    # alternating rounds
    def sync_after_forward(module, args, out):
        bool(torch.isfinite(out[0]))

    loop_ms = {"loop": [], "loop + drop buffer": [], "loop + sync after forward": []}
    order = list(loop_ms)
    for name in (order + order[::-1]) * (PRE_LOOP_ROUNDS // 2):
        hook = model.register_forward_hook(sync_after_forward) if "sync" in name else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_training(state=state, step_fn=step, train_loader=hosts[:PRE_LOOP_STEPS], epochs=1,
                     nan_recovery="drop" in name)
        torch.cuda.synchronize()
        loop_ms[name].append((time.perf_counter() - t0) * 1e3 / PRE_LOOP_STEPS)
        if hook is not None:
            hook.remove()
    loop_med = {k: percentile(v, 50) for k, v in loop_ms.items()}
    print(f"  run_training [{card}] ({PRE_LOOP_ROUNDS} rounds of {PRE_LOOP_STEPS} steps, ms a "
          f"step, median of rounds): " + "; ".join(
              f"{k} {v:.2f} (rounds {' '.join(f'{x:.2f}' for x in loop_ms[k])})"
              for k, v in loop_med.items()))

    # 2. the breakdown: torch.profiler over the shipped step, with the
    # loop's host read of the loss; its stages are record_function spans on
    # the real path (the encoder's text backbone, gnn and pooling, the
    # model's head + loss, the step's backward, the optimizer's clip and
    # adam), each given the device time of the kernels launched inside it
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pretrain_steps(torch, step, state, graphs[:PRE_PROFILED])
    spans = span_device_ms(torch, prof, PRE_SPANS, PRE_PROFILED)
    busy = sum(spans["device"].values())
    notes = set(PRE_SPANS) | {e.name for e in prof.events()
                              if getattr(e, "is_user_annotation", False)}
    kernels = [r for r in device_rows(torch, prof, PRE_PROFILED) if r[0] not in notes]
    print(f"  uncached step breakdown [{card}] ({PRE_PROFILED} steps of make_train_step under "
          f"torch.profiler): device busy {busy:.2f} ms a step ({sum(t for _, t, _ in kernels):.2f} "
          f"by the card's own events), {busy / med:.1%} of the median step {med:.2f} ms")
    for name in (*PRE_SPANS, "other"):
        print(f"    {name:19s} device {spans['device'][name]:8.3f} ms"
              + (f", host {spans['host'][name]:8.3f} ms in the span" if name in PRE_SPANS
                 else " (outside the spans: zero_grad, the draws, the loss read)"))
    for key, t, count in kernels[:10]:
        print(f"    {t:9.3f} ms  x{count:<4d} {key[:90]}")
    breakdown = {"busy_ms": busy, "busy_share": busy / med, "spans_device_ms": spans["device"],
                 "spans_host_ms": spans["host"], "loop_ms": loop_med}

    # 3. the cached-tables step (the campaign's --cached-text recipe)
    t0 = time.perf_counter()
    title = H.build_title_table(cfg, tok, gen.titles, model.encoder)
    kws = [a[2] or "" for s, _ in sessions for a in s if a[1] == "s"]
    qtab, lookup = H.build_keyword_table(cfg, tok, kws, model.encoder)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    cached = []
    for h, (g, _) in zip(hosts, graphs):
        kw = H.keyword_ids(lookup, h.query_input_ids)
        check(kw is not None, "pretrain: the keyword table does not cover a batch")
        cached.append((g, {"tables": {"title_table": title, "query_table": qtab,
                                      "query_kw": torch.from_numpy(kw).to(dev)}}))
    saved = [b.clone() for b in model.buffers()]
    with torch.no_grad():
        d1 = model.draw(g0, state.generator)
        l_unc, _ = model(g0, draws=d1)
        l_cac, _ = model(g0, draws=d1, **cached[0][1])
        for b, s in zip(model.buffers(), saved):
            b.copy_(s)
    cache_rel = abs(float(l_cac) - float(l_unc)) / abs(float(l_unc))
    check(cache_rel <= PRE_CACHED_RTOL, f"pretrain: cached loss {float(l_cac)} vs uncached "
          f"{float(l_unc)} (rel {cache_rel:.3g} > {PRE_CACHED_RTOL})")
    c_warm, _ = pretrain_steps(torch, step, state, cached[:PRE_WARM])
    c_losses, c_ms = pretrain_steps(torch, step, state, cached[PRE_WARM:])
    check(all(np.isfinite(c_warm + c_losses)), "pretrain: non-finite cached losses")
    c_med, c_p90 = percentile(c_ms, 50), percentile(c_ms, 90)
    print(f"  cached-tables step [{card}]: tables {table_s:.2f} s ({title.shape[0]} titles, "
          f"{qtab.shape[0]} keywords); loss vs uncached rel {cache_rel:.3g} "
          f"(<= {PRE_CACHED_RTOL}); median {c_med:.2f} ms, p90 {c_p90:.2f} ms "
          f"({B / c_med * 1e3:.0f} sessions/s) {smi()}; loss curve "
          f"{' '.join(f'{x:.4f}' for x in c_warm + c_losses)}")
    del cached, title, qtab

    # 4. the card against the CPU: one full-width step on 8 sessions
    h8 = build_graph_batch(sessions[:8], tok, cfg.dims, ignore_query=cfg.ignore_query)
    t0 = time.perf_counter()
    cpu_model, cpu_state = tp.create_pretrain_state(cfg, "cpu", torch.Generator().manual_seed(0))
    cpu_model.load_state_dict(model.state_dict())
    # a copy: load_state_dict keeps tensors already on the parameters' device
    cpu_state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    g8 = to_device(h8, dev)
    d8 = model.draw(g8, state.generator)
    before = {k: v.detach().to("cpu", copy=True) for k, v in model.named_parameters()}
    _, m_card = step(state, g8, draws=d8)
    _, m_cpu = tp.make_train_step(cpu_model)(cpu_state, to_device(h8, torch.device("cpu")),
                                             draws={k: v.cpu() for k, v in d8.items()})
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    # each leaf's clipped gradient (left in .grad by the step) and update;
    # a leaf whose gradient is 0 up to rounding (the biases before a
    # BatchNorm; the GAT attention of the query -> product convs, where a
    # product's only source is the root query node) gets an update of
    # rounding noise, which Adam scales up to ~lr: its rms gradient, over the
    # rms of all gradients, is below PRE_NOISE_RMS and its gradient and
    # cosine are shown but not held to the bounds
    grads = {k: q.grad.double() for k, q in cpu_model.named_parameters()}
    rms_all = float(torch.sqrt(sum((g * g).sum() for g in grads.values())
                               / sum(g.numel() for g in grads.values())))
    rows, zero_leaves = [], 0
    for (name, p), (_, q) in zip(model.named_parameters(), cpu_model.named_parameters()):
        a = (p.detach().cpu() - before[name]).double().reshape(-1)
        b = (q.detach() - before[name]).double().reshape(-1)
        if a.norm() == 0 and b.norm() == 0:
            zero_leaves += 1
            continue
        c = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        g_cpu = grads[name]
        g_rel = float((p.grad.detach().cpu().double() - g_cpu).norm() / g_cpu.norm())
        rms = float(g_cpu.pow(2).mean().sqrt()) / rms_all
        rows.append((c, g_rel, rms, name))
    held = [r for r in rows if r[2] >= PRE_NOISE_RMS]
    cos_min, _, _, cos_leaf = min(held)
    _, grad_rel, _, grad_leaf = max(held, key=lambda r: r[1])
    cpu_s = time.perf_counter() - t0
    del cpu_model, cpu_state, before, grads
    print(f"  card vs CPU, one step on 8 sessions [{card}]: loss {float(m_card['loss']):.9g} vs "
          f"{float(m_cpu['loss']):.9g} (rel {loss_rel:.3g}, bound {PRE_CPU_LOSS_RTOL}); over "
          f"{len(held)} leaves: largest clipped-gradient |card - CPU| / |CPU| {grad_rel:.3g} "
          f"({grad_leaf}; bound {PRE_CPU_GRAD_REL}), smallest update cosine {cos_min:.6f} "
          f"({cos_leaf}; bound {PRE_CPU_UPDATE_COS}); {zero_leaves} leaves with no update on "
          f"both; {cpu_s:.1f} s")
    for c, g_rel, rms, name in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    gradient rel {g_rel:9.3g}  update cosine {c:9.6f}  rms gradient / rms of all "
              f"{rms:.3g}  {name}"
              + ("  (rounding-level gradient: not held)" if rms < PRE_NOISE_RMS else ""))
    check(loss_rel <= PRE_CPU_LOSS_RTOL and grad_rel <= PRE_CPU_GRAD_REL
          and cos_min >= PRE_CPU_UPDATE_COS,
          "pretrain: the card's step does not agree with the CPU's")

    # 5. checkpoints: save latest, restore into a fresh state, the next step
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save("latest", state_to_tree(state))
        write_s = time.perf_counter() - t0
        size_mb = os.path.getsize(os.path.join(d, "latest.pt")) / 1e6
        g1 = graphs[1][0]
        _, want = step(state, g1)
        want_draws = model.draw(g1, state.generator)  # the stream after the step
        model2, state2 = tp.create_pretrain_state(cfg, dev,
                                                  torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree_to_state(state2, ckpt.restore("latest", map_location=dev))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    _, got = tp.make_train_step(model2)(state2, g1)
    got_draws = model2.draw(g1, state2.generator)
    resume_rel = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-30)
                     for k in want)
    same_draws = all(torch.equal(got_draws[k], want_draws[k]) for k in want_draws)
    diff = max((p - q).abs().max().item() for p, q in zip(model.parameters(),
                                                           model2.parameters()))
    print(f"  checkpoint [{card}]: latest {size_mb:.1f} MB, write {write_s:.2f} s, read into a "
          f"fresh state {read_s:.2f} s; the next step's loss and metrics vs the uninterrupted "
          f"run rel {resume_rel:.3g} (bound 1e-6), the generator's next draws "
          f"{'equal' if same_draws else 'DIFFER'}, parameters after it max |diff| {diff:.3g} "
          f"(non-deterministic on the card: the backward of torch.gather in the pooling's "
          f"occurrence expansion and of nn.Embedding for positional_emb add with atomics)")
    check(resume_rel <= 1e-6 and same_draws, "pretrain: the resumed step differs")
    del model2, state2

    # 6. from training to serving: make_encode_fn -> f32 DenseIndex -> K1
    serve = [d for d in port.SyntheticSessionGenerator(asin_num=cfg.asin_num,
                                                       seed=2).dataset(8192)]
    enc_fn = tp.make_encode_fn(model)
    t0 = time.perf_counter()
    emb = H.EmbeddingPipeline(cfg, tok, lambda g: enc_fn(state, g), device=dev)(
        serve, out="device")
    idx = port.DenseIndex(cfg.session_emb_dim, 8192, device=dev)
    idx.add(emb)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    idx.search(emb[:1], 1)  # warm-up, uncounted
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    D, I = idx.search(emb[:256], 100)
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    check(counts["k1"] >= 1 and counts["k1"] == counts["k1_wgmma"],
          f"pretrain: K1 launches {counts} (all must be the f32 wgmma variant)")
    I = np.asarray(I)
    rows = np.arange(256)
    # a session whose embedding equals another's ties with it
    tie = np.array([bool(torch.equal(emb[i], emb[j])) for i, j in zip(rows, I[:, 0])])
    check(((I[:, 0] == rows) | tie).all(), "pretrain: a top-1 is not the session itself")
    print(f"  trained encoder -> f32 DenseIndex [{card}]: 8192 sessions encoded and added in "
          f"{ingest_s:.2f} s ({8192 / ingest_s:.0f} /s), 256 searches at k=100 "
          f"{search_ms:.1f} ms; top-1 the session itself {int((I[:, 0] == rows).sum())}/256 "
          f"({int(tie.sum() - (I[:, 0] == rows).sum())} exact ties); K1 launches "
          f"{counts['k1']} (wgmma {counts['k1_wgmma']})")
    summary = {"uncached_ms": {"median": med, "p90": p90}, "cached_ms": {"median": c_med,
               "p90": c_p90}, "breakdown": breakdown, "checkpoint_mb": size_mb,
               "checkpoint_write_s": write_s, "checkpoint_read_s": read_s}
    print(f"pretrain summary: {json.dumps(summary)}")
    del model, state, emb, idx
    torch.cuda.empty_cache()
    return counts


# the session trainers and the fine-tuner at Config() width
ST_WARM, ST_TIMED, ST_REPEAT = 3, 12, 8  # warm-up, timed and repeated-batch steps
ST_CPU_ROWS = 8  # sessions of the card-vs-CPU step
# the card against the CPU on one step of 8 sessions: the loss's relative
# difference and each held leaf's clipped gradient |card - CPU| / |CPU|
# (the pretrainer's bounds, phase 4g)
ST_CPU_LOSS_RTOL, ST_CPU_GRAD_REL = 1e-5, 1e-3
ST_SERVE, ST_Q = 8192, 256  # the trained encoder's engine: sessions, queries
FT_TRIPLETS, FT_MINE_DB, FT_EPOCHS, FT_K = 256, 2000, 8, 10  # the fine-tune and its score@k


def tree_to(tree, dev):
    """A dict of tensors (or of such dicts) on ``dev``."""
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def step_vs_cpu(torch, model, state, cpu_model, cpu_state, step_maker, hosts, draws, dev):
    """One train step on the card and the same step on the CPU from the same
    weights, optimizer state and draws. Returns the loss's relative
    difference and, over every parameter leaf whose rms gradient is at least
    PRE_NOISE_RMS of the rms of all gradients, the largest relative
    clipped-gradient difference and its leaf."""
    import copy

    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device

    cpu = torch.device("cpu")
    cpu_model.load_state_dict(model.state_dict())
    # a copy: load_state_dict keeps tensors already on the parameters' device
    cpu_state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    _, m_card = step_maker(model)(state, *[to_device(h, dev) for h in hosts], draws=draws)
    _, m_cpu = step_maker(cpu_model)(cpu_state, *[to_device(h, cpu) for h in hosts],
                                     draws=tree_to(draws, cpu))
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    grads = {k: q.grad.double() for k, q in cpu_model.named_parameters()}
    rms_all = float(torch.sqrt(sum((g * g).sum() for g in grads.values())
                               / sum(g.numel() for g in grads.values())))
    worst = (0.0, "none")
    for name, p in model.named_parameters():
        g_cpu = grads[name]
        if float(g_cpu.pow(2).mean().sqrt()) < PRE_NOISE_RMS * rms_all:
            continue
        rel = float((p.grad.detach().cpu().double() - g_cpu).norm() / g_cpu.norm())
        worst = max(worst, (rel, name))
    return loss_rel, worst[0], worst[1], float(m_card["loss"])


def phase_session_trainers(torch, mips, dev, card):
    """The session trainers at Config() width: the flagship subsession
    trainer (batch 50, 391,572 asins, neg_sample_count 1000) timed, its loss
    falling on a repeated batch and one 8-session step held to the CPU's;
    one step each of the scratch subsession (autoregressive), scratch
    session (mlm_electra) and joint trainers, each finite and held to the
    CPU's; then the trained encoder in an f32 SessionSearchEngine (K1
    counted from its ingest to its search). Returns (K1 counts, the model,
    its engine, the sessions)."""
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.data import build_graph_batch
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.training import session_trainers as st

    torch.cuda.empty_cache()
    cfg = port.Config()
    B = cfg.batch_size
    tok = port.get_tokenizer(cfg.vocab_size)
    gen = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=5)
    n_steps = ST_WARM + ST_TIMED
    data = gen.dataset(B * n_steps)
    # the CLI's train-{mode} batches: (prefix, future) pairs, query text kept
    hosts = [build_graph_batch(data[i * B:(i + 1) * B], tok, cfg.dims)
             for i in range(n_steps)]
    t0 = time.perf_counter()
    model, state = st.create_session_state(cfg, dev, "subsession", "flagship",
                                           torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    step = st.make_session_train_step(model)
    print(f"session trainer Config() flagship subsession [{card}]: {n_params / 1e6:.1f} M "
          f"parameters, batch {B}, {cfg.asin_num} asins, {cfg.neg_sample_count} negatives, "
          f"built in {time.perf_counter() - t0:.1f} s")
    graphs = [(to_device(h, dev), {}) for h in hosts]
    warm, _ = pretrain_steps(torch, step, state, graphs[:ST_WARM])
    losses, ms = pretrain_steps(torch, step, state, graphs[ST_WARM:])
    check(all(np.isfinite(warm + losses)), f"session trainer: non-finite losses {warm + losses}")
    med, p90 = percentile(ms, 50), percentile(ms, 90)
    print(f"  step [{card}]: median {med:.2f} ms, p90 {p90:.2f} ms over {ST_TIMED} steps after "
          f"{ST_WARM} warm-up ({B / med * 1e3:.0f} sessions/s) {smi()}; loss curve "
          f"{' '.join(f'{x:.4f}' for x in warm + losses)}")
    g0 = graphs[0][0]
    draws = model.draw(g0, state.generator)
    rep, _ = pretrain_steps(torch, step, state, [(g0, {"draws": draws})] * (ST_REPEAT + 1))
    check(rep[-1] < rep[0], f"session trainer: loss after {ST_REPEAT} steps on one batch "
          f"{rep[-1]} is not below the first {rep[0]}")
    print(f"  one batch repeated: loss {rep[0]:.5f} -> {rep[-1]:.5f} after {ST_REPEAT} steps")

    # the card against the CPU: the flagship, then one step of each other trainer
    # (the joint trainer's session view: each full session as its own target)
    h8 = build_graph_batch(data[:ST_CPU_ROWS], tok, cfg.dims)
    h8_full = build_graph_batch([(d[0] + d[1], d[0] + d[1]) for d in data[:ST_CPU_ROWS]], tok,
                                cfg.dims)
    t0 = time.perf_counter()
    cpu_model, cpu_state = st.create_session_state(cfg, "cpu", "subsession", "flagship",
                                                   torch.Generator().manual_seed(0))
    d8 = model.draw(to_device(h8, dev), state.generator)
    held = step_vs_cpu(torch, model, state, cpu_model, cpu_state, st.make_session_train_step,
                       [h8], d8, dev)
    del cpu_model, cpu_state
    rows = [("flagship subsession autoregressive", *held, med, time.perf_counter() - t0)]
    for name, kind, mode, style in (("scratch subsession autoregressive", "single",
                                     "subsession", "autoregressive"),
                                    ("scratch session mlm_electra", "single", "session",
                                     "mlm_electra"),
                                    ("joint (scratch, mlm_electra)", "joint", None, None)):
        t0 = time.perf_counter()
        gen_d, gen_c = (torch.Generator(device=dev).manual_seed(1),
                        torch.Generator().manual_seed(1))
        if kind == "joint":
            m, s = st.create_joint_state(cfg, dev, generator=gen_d)
            cm, cs = st.create_joint_state(cfg, "cpu", generator=gen_c)
            sess = build_graph_batch([(d[0] + d[1], d[0] + d[1]) for d in data[:B]], tok,
                                     cfg.dims)
            maker, full, small_hosts = st.make_joint_train_step, [sess, hosts[0]], [h8_full, h8]
            draws_fn = lambda g: m.draw(g[0], g[1], s.generator)  # noqa: E731
        else:
            m, s = st.create_session_state(cfg, dev, mode, "scratch", gen_d, style)
            cm, cs = st.create_session_state(cfg, "cpu", mode, "scratch", gen_c, style)
            maker, full, small_hosts = st.make_session_train_step, [hosts[0]], [h8]
            draws_fn = lambda g: m.draw(g[0], s.generator)  # noqa: E731
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, met = maker(m)(s, *[to_device(h, dev) for h in full])
        loss = float(met["loss"])
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t1) * 1e3
        check(np.isfinite(loss), f"session trainer {name}: loss {loss}")
        d_small = draws_fn([to_device(h, dev) for h in small_hosts])
        held = step_vs_cpu(torch, m, s, cm, cs, maker, small_hosts, d_small, dev)
        rows.append((name, *held, one_ms, time.perf_counter() - t0))
        del m, s, cm, cs
    print(f"  card vs CPU, one step on {ST_CPU_ROWS} sessions each [{card}] (loss rel bound "
          f"{ST_CPU_LOSS_RTOL}; largest clipped-gradient |card - CPU| / |CPU| over leaves "
          f"with rms gradient >= {PRE_NOISE_RMS} of all, bound {ST_CPU_GRAD_REL}):")
    for name, loss_rel, grad_rel, leaf, loss8, step_ms, secs in rows:
        print(f"    {name:36s} loss {loss8:.6g}, rel {loss_rel:.3g}; gradient rel "
              f"{grad_rel:.3g} ({leaf}); a batch-{B} step {step_ms:.1f} ms (the flagship's: "
              f"the median above; the others': their first); {secs:.1f} s")
        check(loss_rel <= ST_CPU_LOSS_RTOL and grad_rel <= ST_CPU_GRAD_REL,
              f"session trainer {name}: the card's step does not agree with the CPU's")
    torch.cuda.empty_cache()

    # the trained flagship encoder serving: an f32 SessionSearchEngine
    serve_gen = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=2)
    serve = serve_gen.dataset(ST_SERVE)
    eng = port.SessionSearchEngine(cfg, tok, model.encoder, dim=cfg.session_emb_dim,
                                   capacity=ST_SERVE, device=dev)
    eng.embed(serve[:8])  # warm-up, counted as set-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.add_sessions(serve)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    D, I = eng.search(serve[:ST_Q], k=100)
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    check(counts["k1"] >= 1 and counts["k1"] == counts["k1_wgmma"],
          f"session trainer: K1 launches {counts} (all must be the f32 wgmma variant)")
    check(D.shape == (ST_Q, 100) and np.isfinite(D).all(), "session trainer: bad search result")
    rows_ = np.arange(ST_Q)
    emb = eng.reconstruct(np.arange(ST_SERVE))
    tie = np.array([np.array_equal(emb[i], emb[j]) for i, j in zip(rows_, I[:, 0])])
    self_hits = int((I[:, 0] == rows_).sum())
    check(((I[:, 0] == rows_) | tie).all(), "session trainer: a top-1 is not the session itself")
    print(f"  trained encoder -> f32 SessionSearchEngine [{card}]: {ST_SERVE} sessions ingested "
          f"in {ingest_s:.2f} s ({ST_SERVE / ingest_s:.0f} /s), {ST_Q} searches at k=100 "
          f"{search_ms:.1f} ms; top-1 the session itself {self_hits}/{ST_Q} "
          f"({int(tie.sum()) - self_hits} exact ties); K1 launches {counts['k1']} (wgmma "
          f"{counts['k1_wgmma']})")
    summary = {"flagship_step_ms": {"median": med, "p90": p90},
               "sessions_per_s": B / med * 1e3, "serve_ingest_per_s": ST_SERVE / ingest_s}
    print(f"session trainers summary: {json.dumps(summary)}")
    return counts, model, eng, serve_gen, serve


def phase_finetune(torch, dev, card, model, eng, serve_gen, serve):
    """The similarity fine-tuner over the trained flagship encoder's 1600-d
    embeddings: triplets mined from the synthetic sessions, FinetuneHeads at
    code_len 250 with shared_init, a few epochs of alternating steps; the
    db and query codes served through evaluate_binary in sign mode (K1's
    cp_async variant) and packed mode (K4), each search's Hamming distances
    equal to the plain product's; ave type score@10 of dense, untrained and
    trained codes (reported). Returns the counts of the two searches."""
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.data.similarity import get_ave_score, mine_triplets
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import evaluate_binary
    from sessionsimilaritysearch_tpu_torch.training import finetune as ft

    cfg = port.Config()
    n_bits = cfg.code_len
    test = serve_gen.dataset(ST_Q)
    mine = serve_gen.dataset(2 * FT_TRIPLETS)
    corpus_sessions = [d[0] for d in serve]
    t0 = time.perf_counter()
    triplets = mine_triplets(mine, serve[:FT_MINE_DB], "all_product_type_score", FT_TRIPLETS,
                             pos_thresh=0.6, half_lo=0.1)
    mine_s = time.perf_counter() - t0
    check(len(triplets) >= 32, f"fine-tune: {len(triplets)} triplets mined")
    t0 = time.perf_counter()
    ce = eng.embed(serve, out="device")
    qe = eng.embed(test, out="device")
    embed_s = time.perf_counter() - t0

    heads, fs = ft.create_finetune_state(cfg, dev, emb_dim=ce.shape[1], shared_init=True,
                                         generator=torch.Generator(device=dev).manual_seed(7))
    db_fn, q_fn = ft.make_code_fns(heads)
    code_db0, code_q0 = db_fn(fs, ce), q_fn(fs, qe)
    batch = min(32, max(4, len(triplets) // 4))
    batches = ft.build_triplet_batches(triplets, lambda d: eng.embed(d),
                                       [(q[0], q[0]) for q in mine[:64]], batch,
                                       np.random.default_rng(0), device=dev)
    step = ft.make_finetune_step(heads, cfg)
    losses, ms = [], []
    for _ in range(FT_EPOCHS):
        for b in batches():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fs, m = step(fs, b)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t1) * 1e3)
    check(np.isfinite(losses).all(), "fine-tune: non-finite loss")
    print(f"fine-tune Config() [{card}]: {len(triplets)} triplets mined in {mine_s:.2f} s "
          f"({FT_MINE_DB} db sessions), {ST_SERVE + ST_Q} sessions embedded in {embed_s:.2f} s; "
          f"FinetuneHeads {ce.shape[1]} -> {n_bits} bits, shared_init, {fs.step} alternating "
          f"steps of batch {batch}: median {percentile(ms, 50):.3f} ms, p90 "
          f"{percentile(ms, 90):.3f} ms a step {smi()}; loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}")

    # serve the codes: sign mode (K1 cp_async), packed mode (K4)
    code_db, code_q = db_fn(fs, ce), q_fn(fs, qe)
    check(bool(code_db.abs().eq(1).all() & code_q.abs().eq(1).all()),
          "fine-tune: codes are not +-1")
    qb = torch.where(code_q > 0, 1.0, -1.0).double()
    dbb = torch.where(code_db > 0, 1.0, -1.0).double()
    plain = torch.topk((n_bits - qb @ dbb.T) / 2, 100, dim=1, largest=False).values
    plain = plain.cpu().numpy()
    counts, scores = {}, {}
    for mode, key in (("sign", "k1_cp"), ("packed", "k4")):
        evaluate_binary(code_db[:64], code_q[:8], corpus_sessions[:64], test[:8], k=10,
                        mode=mode, with_report=False, device=dev)  # warm-up, uncounted
        res, c = counted(torch, lambda: evaluate_binary(
            code_db, code_q, corpus_sessions, test, k=100, mode=mode, with_report=False,
            device=dev))
        check(c[key] >= 1, f"fine-tune: {mode} mode launched no {key}: {c}")
        check(np.array_equal(np.asarray(res.D, np.float64), plain),
              f"fine-tune: {mode} mode's Hamming distances differ from the plain product's")
        counts[mode] = c
        scores[mode] = get_ave_score(res.I[:, :FT_K], test, corpus_sessions,
                                     "all_product_type_score")
        print(f"  {mode} mode: {ST_Q} queries x {ST_SERVE} codes at k=100, search "
              f"{res.search_s * 1e3:.2f} ms (host clock), distances equal the plain product's; "
              f"launches {c}")
    untrained = evaluate_binary(code_db0, code_q0, corpus_sessions, test, k=FT_K, mode="sign",
                                with_report=False, device=dev)
    distinct = [int(torch.unique(c > 0, dim=0).shape[0]) for c in (code_db0, code_db)]
    untrained_score = get_ave_score(untrained.I, test, corpus_sessions, "all_product_type_score")
    idx = port.DenseIndex(cfg.session_emb_dim, ST_SERVE, device=dev)
    idx.add(ce)
    _, I_dense = idx.search(qe, FT_K)
    dense = get_ave_score(I_dense, test, corpus_sessions, "all_product_type_score")
    print(f"  ave type score@{FT_K} (reported, not gated): dense cosine {dense:.4f}, untrained "
          f"codes {untrained_score:.4f}, "
          f"trained codes {scores['sign']:.4f} (packed {scores['packed']:.4f}); distinct db "
          f"codes among {ST_SERVE}: untrained {distinct[0]}, trained {distinct[1]}")
    return counts


# the node-level encoders and the CLI at Config() width
NL_ROWS, NL_CALLS = 256, 10  # sessions a batch; timed calls of each encoder
# the card against the CPU on the same weights and batch: the largest
# |difference| over the largest |CPU output|, per node type (TF32 off)
NL_CARD_CPU_REL = 1e-4
CLI_SESSIONS = 512  # --num-sessions of every CLI run
# the keys of the JAX CLI's JSON line per subcommand
# (sessionsimilaritysearch_tpu/cli.py:123, :171, :264, :280, :323, :350, :383)
CLI_TRAIN_KEYS = {"best_valid_loss", "steps"}
CLI_FINETUNE_KEYS = {"final_loss", "triplets"}
CLI_REPORT_KEYS = {"ave_all_jaccard", "ave_cur_jaccard", "ave_all_query_score",
                   "ave_all_product_title_score", "ave_all_product_type_score",
                   "future_map", "all_map", "cur_map", "future_recall", "all_recall",
                   "frac_above_0.5"}
CLI_KNN_KEYS = {"mode", "recall_at_k", "K", "search_s", "qps"}
CLI_ETL_KEYS = {"sessions", "distinct_asins", "out"}


def phase_node_level(torch, dev, card):
    """NodeLevelEncoder at Config() width with the HGT backbone (hidden 800,
    4 heads, 3 layers: 3,200-wide nodes) and with the HeteroGGNN backbone:
    256 sessions on the card (median ms of a batch over NL_CALLS calls) and
    on the CPU from the same weights, the largest |card - CPU| over the
    largest |CPU| per node type at most NL_CARD_CPU_REL."""
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.data import build_graph_batch
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.models import (
        HGT,
        HeteroGGNN,
        NodeAsinEmbedding,
        NodeLevelEncoder,
    )
    from sessionsimilaritysearch_tpu_torch.models.encoder import build_text_backbone, init_parameters

    cfg = port.Config()
    cpu = torch.device("cpu")
    tok = port.get_tokenizer(cfg.vocab_size)
    data = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=9).dataset(NL_ROWS)
    host = build_graph_batch(data, tok, cfg.dims)
    g_card, g_cpu = to_device(host, dev), to_device(host, cpu)
    d_text, d_asin, hid, layers = cfg.text_encoder_dim, cfg.emb_len, cfg.gnn_nhid, cfg.gnn_nlayers
    backbones = {
        "HGT": (lambda d: HGT(d_text, d_asin, hid, cfg.gnn_nhead, layers, device=d),
                (layers + 1) * hid),
        "HeteroGGNN": (lambda d: HeteroGGNN(d_text, d_asin, hid, layers, device=d), None),
    }
    out = {}
    for name, (make_gnn, width) in backbones.items():
        t0 = time.perf_counter()
        enc = NodeLevelEncoder(build_text_backbone(cfg, dev),
                               NodeAsinEmbedding(cfg.asin_num, cfg.emb_len, device=dev),
                               make_gnn(dev), device=dev)
        init_parameters(enc, torch.Generator(device=dev).manual_seed(3))
        enc.eval()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in enc.parameters())
        ms = []
        with torch.no_grad():
            got = enc(g_card)  # warm-up
            for _ in range(NL_CALLS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                got = enc(g_card)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            state = smi()
            cpu_enc = NodeLevelEncoder(build_text_backbone(cfg, cpu),
                                       NodeAsinEmbedding(cfg.asin_num, cfg.emb_len, device=cpu),
                                       make_gnn(cpu), device=cpu)
            cpu_enc.load_state_dict(enc.state_dict())
            t0 = time.perf_counter()
            want = cpu_enc.eval()(g_cpu)
            cpu_s = time.perf_counter() - t0
        rel = {}
        for t in ("query", "product"):
            check(tuple(got[t].shape[:2]) == tuple(want[t].shape[:2]),
                  f"node-level {name}: {t} shape {tuple(got[t].shape)}")
            if width is not None:
                check(got[t].shape[-1] == width, f"node-level {name}: {t} width "
                      f"{got[t].shape[-1]}, expected {width}")
            check(bool(torch.isfinite(got[t]).all()), f"node-level {name}: non-finite {t}")
            rel[t] = float((got[t].cpu() - want[t]).abs().max() / want[t].abs().max())
            check(rel[t] <= NL_CARD_CPU_REL, f"node-level {name}: {t} card vs CPU {rel[t]:.3g} "
                  f"> {NL_CARD_CPU_REL}")
        med = percentile(ms, 50)
        print(f"node-level encoder {name} Config() [{card}]: {n_params / 1e6:.1f} M parameters "
              f"(built in {build_s:.1f} s), nodes {got['query'].shape[-1]} wide; a batch of "
              f"{NL_ROWS} sessions median {med:.2f} ms (p90 {percentile(ms, 90):.2f}) over "
              f"{NL_CALLS} calls (CUDA events) {state}; card vs CPU max |diff| / max |CPU| "
              f"query {rel['query']:.3g}, product {rel['product']:.3g} (bound "
              f"{NL_CARD_CPU_REL}; the CPU forward {cpu_s:.1f} s)")
        out[name] = {"median_ms": med, "card_cpu_rel": rel}
        del enc, cpu_enc, got, want
        torch.cuda.empty_cache()
    print(f"node-level summary: {json.dumps(out)}")
    return out


def cli_call(torch, cli, argv, card):
    """One in-process CLI call on the card: (its JSON line, wall seconds,
    the K1 / K2 / K4 launches counted from 0 around it)."""
    import contextlib
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cuda", *argv])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    lines = buf.getvalue().strip().splitlines()
    check(bool(lines), f"cli {' '.join(argv[:3])}: printed nothing")
    out = json.loads(lines[-1])
    print(f"  cli {' '.join(a for a in argv if not a.startswith('/'))} [{card}]: "
          f"{secs:.1f} s; {json.dumps(out)}; launches {counts}")
    return out, secs, counts


def epoch_losses(path) -> list:
    """The train losses a RunDir log wrote ('epoch i: train X ...')."""
    with open(path) as f:
        return [float(line.split("train ")[1].split()[0].rstrip(","))
                for line in f if ": train " in line]


def phase_cli(torch, dev, card):
    """The port's CLI at Config() width (not --tiny), driven in-process
    through cli.main on the card, in a temporary directory deleted
    afterwards: pretrain, train-subsession and train-session (512 sessions,
    one epoch), finetune --from-pretrain on that pretrain run, evaluate in
    modes model (with --save-results), knn, hybrid and SKNN, --mode load of
    the saved results, etl; each JSON line holds the JAX CLI's keys, every
    loss is finite, ``steps`` is the train loader's batch count, evaluate's
    model and knn modes launch K1 (each launch the f32 wgmma variant, the
    n_out = 500 f32 rows); then `python -m sessionsimilaritysearch_tpu_torch
    .cli evaluate --mode model` in a subprocess without --device runs on
    the card, and with no card visible it fails. Returns the K1 counts of
    evaluate's model and knn runs."""
    import shutil

    from sessionsimilaritysearch_tpu_torch import cli
    from sessionsimilaritysearch_tpu_torch.config import Config

    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="sss_cli_")
    common = ["--num-sessions", str(CLI_SESSIONS)]
    n_train = CLI_SESSIONS - max(CLI_SESSIONS // 10, 1)
    steps = -(-n_train // Config().batch_size)
    secs, k1 = {}, {}
    try:
        for cmd in ("pretrain", "train-subsession", "train-session"):
            run = os.path.join(root, cmd)
            out, secs[cmd], _ = cli_call(torch, cli, [cmd, *common, "--epochs", "1",
                                                      "--savedir", run], card)
            check(set(out) == CLI_TRAIN_KEYS, f"cli {cmd}: keys {sorted(out)}")
            check(out["steps"] == steps, f"cli {cmd}: {out['steps']} steps, the loader has "
                  f"{steps} batches")
            losses = epoch_losses(os.path.join(run, f"{cmd.split('-')[-1]}.log"))
            check(len(losses) == 1 and np.isfinite(losses).all()
                  and np.isfinite(out["best_valid_loss"]),
                  f"cli {cmd}: train losses {losses}, valid {out['best_valid_loss']}")
            if cmd != "pretrain":
                shutil.rmtree(run)
        out, secs["finetune"], _ = cli_call(
            torch, cli, ["finetune", *common, "--savedir", os.path.join(root, "finetune"),
                         "--from-pretrain", os.path.join(root, "pretrain")], card)
        check(set(out) == CLI_FINETUNE_KEYS and np.isfinite(out["final_loss"])
              and out["triplets"] > 0, f"cli finetune --from-pretrain: {out}")
        shutil.rmtree(os.path.join(root, "pretrain"))

        saved = os.path.join(root, "results.pkl")
        reports = {}
        for mode, extra in (("model", ["--save-results", saved]), ("knn", []),
                            ("hybrid", []), ("SKNN", [])):
            out, secs[f"evaluate {mode}"], counts = cli_call(
                torch, cli, ["evaluate", "--mode", mode, *common, *extra], card)
            keys = CLI_KNN_KEYS if mode == "knn" else {"mode", "qps", "search_s",
                                                        *CLI_REPORT_KEYS}
            check(keys <= set(out) and out["mode"] == mode,
                  f"cli evaluate {mode}: keys {sorted(out)}")
            check(all(np.isfinite(v) for k, v in out.items() if k not in ("mode", "qps")),
                  f"cli evaluate {mode}: {out}")
            if mode in ("model", "knn"):
                check(counts["k1"] >= 1 and counts["k1"] == counts["k1_wgmma"],
                      f"cli evaluate {mode}: K1 launches {counts} (all must be the f32 wgmma "
                      "variant)")
                k1[f"cli_evaluate_{mode}"] = counts
            reports[mode] = out
        out, secs["evaluate load"], _ = cli_call(
            torch, cli, ["evaluate", "--mode", "load", "--results", saved], card)
        want = {k: v for k, v in reports["model"].items() if k not in ("mode", "qps", "search_s")}
        check(out == {"mode": "load", **want},
              f"cli evaluate --mode load: {out} is not the model run's report {want}")
        out, secs["etl"], _ = cli_call(torch, cli, ["etl", *common, "--out",
                                                    os.path.join(root, "etl")], card)
        check(set(out) == CLI_ETL_KEYS and out["sessions"] == CLI_SESSIONS,
              f"cli etl: {out}")

        # the default device: a subprocess without --device, then one with no card visible
        env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
        env["PYTHONPATH"] = HERE
        argv = [sys.executable, "-m", "sessionsimilaritysearch_tpu_torch.cli", "evaluate",
                "--mode", "model", "--num-sessions", str(CLI_SESSIONS)]
        t0 = time.perf_counter()
        sub = subprocess.run(argv, cwd=root, env=env, capture_output=True, text=True,
                             timeout=600)
        secs["subprocess evaluate model"] = time.perf_counter() - t0
        check(sub.returncode == 0, f"cli subprocess without --device failed: {sub.stderr[-2000:]}")
        line = json.loads(sub.stdout.strip().splitlines()[-1])
        check(line["mode"] == "model" and CLI_REPORT_KEYS <= set(line),
              f"cli subprocess: {line}")
        blind = subprocess.run(argv, cwd=root, env={**env, "CUDA_VISIBLE_DEVICES": ""},
                               capture_output=True, text=True, timeout=600)
        check(blind.returncode != 0 and "torch.cuda.is_available() is False" in blind.stderr,
              "cli subprocess with no card visible did not refuse to run")
        print(f"  cli subprocess `python -m sessionsimilaritysearch_tpu_torch.cli evaluate --mode "
              f"model` without --device [{card}]: {secs['subprocess evaluate model']:.1f} s, "
              f"{json.dumps(line)}; with no card visible it exits {blind.returncode} "
              "(device 'cuda' requested, no CPU fallback)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"cli summary [{card}]: wall seconds {json.dumps(secs)}")
    return k1


def phase_f32_kernel(torch, mips, dev):
    """K1's f32 wgmma variant (the 3xTF32 split) at the bench point, timed in
    the same rounds as the tile loop and cuBLAS SGEMM (TF32 off), and the
    accuracy gate: K1's and K6's largest |score - f64| at most twice
    SGEMM's."""
    from sessionsimilaritysearch_tpu_torch.ops import _build

    lib = _build.load_library()
    q_n, n, d = 1024, 1 << 20, 1600
    g = torch.Generator(device=dev).manual_seed(10)
    corpus = unit_rows_f32(torch, g, n, d, dev)
    queries = unit_rows_f32(torch, g, q_n, d, dev)
    check(mips.k1_variant(dev.type, queries.dtype, d, (queries.data_ptr(), corpus.data_ptr()))
          == "wgmma", "f32 bench point: not the wgmma variant")
    check(not torch.backends.cuda.matmul.allow_tf32, "f32 bench point: TF32 is on")
    w0 = mips.wgmma_launch_count
    med, rounds, state = rounds_in_turns(torch, {
        "wgmma": (lambda: mips.scores_with_bucket_max(queries, corpus), 3),
        "tile": (lambda: tile_loop(torch, lib, mips, queries, corpus, dev), 1),
        "sgemm": (lambda: torch.matmul(queries, corpus.T), 2)})
    check(mips.wgmma_launch_count - w0 == 12, "f32 bench point: the wgmma variant did not run")
    ms, tile_ms, lib_ms = med["wgmma"], med["tile"], med["sgemm"]
    plain_ms = cuda_ms(torch, lambda: mips.scores_with_bucket_max_ref(queries, corpus), 2)
    s, bm = mips.scores_with_bucket_max(queries, corpus)
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(queries, corpus)
    bm_err = (bm - bm_ref).abs().max().item()
    s_err = max((s[r: r + 64] - s_ref[r: r + 64]).abs().max().item()
                for r in range(0, q_n, 64))
    # unit rows, |s| <= 1: f32-accurate sums in another order
    check(bm_err <= 1e-5, f"f32 bench point: bmax max_abs_err {bm_err}")
    check(s_err <= 1e-5, f"f32 bench point: scores max_abs_err {s_err}")
    del s, s_ref, bm, bm_ref

    # the accuracy gate on the bench point's first 65,536 rows and on
    # standard-normal rows at d=200, against the f64 product on the card
    gate = {}
    for d_g, q, c in ((d, queries, corpus[: 1 << 16]),
                      (200, torch.randn(q_n, 200, generator=g, device=dev),
                       torch.randn(1 << 16, 200, generator=g, device=dev))):
        exact = q.double() @ c.double().T
        e_k1 = (mips.scores_with_bucket_max(q, c)[0].double() - exact).abs().max().item()
        e_k6 = (mips.scores_matmul(q, c).double() - exact).abs().max().item()
        e_sgemm = (torch.matmul(q, c.T).double() - exact).abs().max().item()
        e_tile = (tile_loop(torch, lib, mips, q, c, dev).double() - exact).abs().max().item()
        del exact
        check(max(e_k1, e_k6) <= 2 * e_sgemm,
              f"f32 accuracy gate d={d_g}: K1 {e_k1}, K6 {e_k6} > 2 x SGEMM {e_sgemm}")
        gate[f"d{d_g}"] = {"k1": e_k1, "k6": e_k6, "sgemm": e_sgemm, "tile": e_tile}
        print(f"f32 accuracy gate, {q.shape[0]} x {c.shape[0]} at d={d_g} "
              f"({'unit' if d_g == d else 'standard-normal'} rows), largest |score - f64|: "
              f"K1 f32 wgmma {e_k1:.4g}, K6 f32 wgmma {e_k6:.4g}, cuBLAS SGEMM {e_sgemm:.4g} "
              f"(ratio {max(e_k1, e_k6) / e_sgemm:.3f}, gate 2), tile loop {e_tile:.4g}")
    del corpus, queries
    torch.cuda.empty_cache()
    flops = 2 * q_n * n * d
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **f32_bound(q_n, n, d),
           "gate": gate}
    tile = {"ms": tile_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            **f32_bound(q_n, n, d, tf32=False)}
    print(f"f32 kernel bench point q={q_n} n={n} d={d} f32->f32, three rounds in turns "
          f"{state}: f32 wgmma variant {rounds['wgmma']} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
          f"TFLOP/s of f32 products), tile loop {rounds['tile']} ms, torch.matmul f32 "
          f"(cuBLAS SGEMM, TF32 off) {rounds['sgemm']} ms; plain {plain_ms:.3f} ms; bound "
          f"{out['bound_ms']:.3f} ms ({out['bound_by']}, at 495 TFLOP/s); design bounds: "
          f"three tf32 passes {out['design_bound_ms']:.3f} ms, the tile loop's f32 FMAs "
          f"{tile['design_bound_ms']:.3f} ms at 67 TFLOP/s; bmax max_abs_err "
          f"{bm_err:.3g}, scores max_abs_err {s_err:.3g}")
    return max(bm_err, s_err), out, tile


def random_signs(torch, g, rows, bits, dev):
    return torch.where(torch.rand(rows, bits, generator=g, device=dev) < 0.5, 1.0, -1.0)


def plain_packed_topk(torch, packed, mips, q, words, k, n_bits, vc=None, pen=None):
    """K4's top-k through its plain version: the same selection and
    distance rule as ``packed.packed_topk``."""
    sd = torch.bfloat16 if n_bits <= 256 else torch.float32
    s, bm = packed.packed_scores_with_bucket_max_ref(q, words, vc, pen, sd)
    return packed.dots_to_hamming(*mips.select_topk(s, bm, k), n_bits)


def sorted_equal(torch, a, b) -> bool:
    return torch.equal(torch.sort(a, dim=1).values, torch.sort(b, dim=1).values)


def packed_case(torch, hamming, g, q_n, n, n_bits, dev):
    """Seeded sign codes: queries +-1 bf16 [q, bits_pad] with zero pad
    columns, the corpus transposed-packed, and the same signs row-major."""
    bits_pad = -(-n_bits // 128) * 128
    corpus = torch.empty(n // 32, bits_pad, dtype=torch.int32, device=dev)
    rows_major = torch.empty(n, -(-n_bits // 32), dtype=torch.int32, device=dev)
    for s in range(0, n, 1 << 16):  # n is a multiple of 2048
        signs = random_signs(torch, g, min(1 << 16, n - s), n_bits, dev)
        corpus[s // 32: (s + len(signs)) // 32] = hamming.pack_bits_t(
            torch.nn.functional.pad(signs, (0, bits_pad - n_bits), value=-1.0))
        rows_major[s: s + len(signs)] = hamming.pack_bits(signs)
    q_signs = random_signs(torch, g, q_n, n_bits, dev)
    q = torch.nn.functional.pad(q_signs, (0, bits_pad - n_bits)).bfloat16()
    return q, corpus, hamming.pack_bits(q_signs), rows_major


def phase_packed_kernel(torch, dev):
    from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, packed

    errs, out = [], {}
    g = torch.Generator(device=dev).manual_seed(3)
    # bf16 scores (the resident layout), then f32 (codes over 256 bits: the
    # streamed layout); 1,600 bits pad to 1,664
    for n_bits in (250, 384, 1600, 2048, 4096):
        q, words, _, _ = packed_case(torch, hamming, g, 37, 6144, n_bits, dev)
        pen = torch.where(torch.rand(6144, generator=g, device=dev) < 0.1,
                          float("-inf"), 0.0)
        sd = torch.bfloat16 if n_bits <= 256 else torch.float32
        ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max(
            q, words, 5003, pen, sd), 20)
        plain_ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max_ref(
            q, words, 5003, pen, sd), 20)
        s, bm = packed.packed_scores_with_bucket_max(q, words, 5003, pen, sd)
        s_ref, bm_ref = packed.packed_scores_with_bucket_max_ref(q, words, 5003, pen, sd)
        d, _ = packed.packed_topk(q, words, 10, n_bits, 5003, pen)
        d_ref, _ = plain_packed_topk(torch, packed, mips, q, words, 10, n_bits, 5003, pen)
        # +-1 products are integers: both sides exact, so equal
        check(torch.equal(s, s_ref), f"packed ragged {n_bits} bits: scores differ")
        check(torch.equal(bm, bm_ref), f"packed ragged {n_bits} bits: bmax differs")
        check(torch.equal(d, d_ref), f"packed ragged {n_bits} bits: top-10 distances differ")
        fin = torch.isfinite(s_ref)
        errs.append((s.float()[fin] - s_ref.float()[fin]).abs().max().item())
        print(f"packed kernel ragged q=37 n=6144 {n_bits} bits (padded {q.shape[1]}; "
              f"{str(sd)[6:]} scores, valid_count 5003, 10% masked): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; scores, bmax and top-10 distances equal")

    q_n, n, n_bits = 1024, 1 << 20, 256
    q, words, q_rows, c_rows = packed_case(torch, hamming, g, q_n, n, n_bits, dev)
    ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max(q, words), 5)
    plain_ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max_ref(q, words), 3)
    # the library yardstick: a cuBLAS bf16 GEMM with the unpacked +-1 rows
    rows = packed.unpack_bits_t(words)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(q, rows.T), 5)
    del rows
    s, bm = packed.packed_scores_with_bucket_max(q, words)
    s_ref, bm_ref = packed.packed_scores_with_bucket_max_ref(q, words)
    check(torch.equal(s, s_ref), "packed bench point: scores differ")
    check(torch.equal(bm, bm_ref), "packed bench point: bmax differs")
    errs.append((bm - bm_ref).abs().max().item())
    del s, s_ref, bm, bm_ref
    d, _ = packed.packed_topk(q, words, 100, n_bits)
    d_ref, _ = plain_packed_topk(torch, packed, mips, q, words, 100, n_bits)
    check(torch.equal(d, d_ref), "packed bench point: top-100 distances differ")
    tflops = 2 * q_n * n * n_bits / (ms * 1e-3) / 1e12
    print(f"packed kernel bench point q={q_n} n={n} {n_bits} bits bf16 scores: kernel "
          f"{ms:.3f} ms {smi()} ({tflops:.1f} TFLOP/s of +-1 products), plain {plain_ms:.3f} ms, "
          f"cuBLAS bf16 GEMM on the unpacked rows {lib_ms:.3f} ms; scores, bmax and "
          f"top-100 distances equal")
    torch.cuda.empty_cache()
    out.update(err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **bound_ms(q_n * n_bits * 2 + n * n_bits // 8 + q_n * n * 2
                          + q_n * (n // 128) * 4, 2 * q_n * n * n_bits, PEAK_BF16))
    return out, (q_rows, c_rows, d, q, words)


# words: every K-slice remainder, both resident query tiles (256 queries up
# to 16 words, 128 up to 32) and the streamed layout (53 and wider)
K5_WIDTHS = (1, 3, 8, 13, 17, 32, 53, 54, 64, 128)
K5_QUERIES = (1, 37, 200)
K5_ROWS = (1, 127, 5003, 6144)  # a lone row, one ragged bucket, a ragged tail, whole buckets


def popc_call(torch, lib, popcount, q, c, pen, dev):
    """One launch of K5's popc variant straight through its C entry point,
    to hold it to the plain version on codes the wrapper sends to wgmma."""
    from sessionsimilaritysearch_tpu_torch.ops import mips

    bmin = torch.empty(q.shape[0], -(-c.shape[0] // 128), dtype=torch.int32, device=dev)
    mips._cuda_call(lib.sss_hamming_bucket_min, "hamming_bucket_min (popc)", dev,
                    q.data_ptr(), c.data_ptr(), None if pen is None else pen.data_ptr(),
                    bmin.data_ptr(), q.shape[0], c.shape[0], q.shape[1])
    return bmin


def k5_penalty(torch, popcount, g, n, dev):
    """A penalty over n rows: 10% of rows masked, a dead tail past 90% of
    the rows, and bucket 1 (rows 128..255) wholly dead where n reaches it."""
    live = torch.rand(n, generator=g, device=dev) >= 0.1
    live[int(0.9 * n) + 1:] = False
    live[128:256] = False
    return torch.where(live, 0, popcount.PENALTY).to(torch.int32)


WIDE_WORDS, WIDE_BITS = 64, 2048  # K5 and K4 at the bench shape beyond PR 20's caps


def wide_points(torch, lib, g, q_n, n, dev):
    """K5 at 64 words and K4 at 2,048 bits (f32 scores) at the bench shape:
    random codes (every bit in use), each kernel held bit for bit to its
    plain version (timed once, CUDA events), the launches of one counted
    top-k each, and the calls to time in turns with the bench point."""
    from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, packed, popcount

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    w, bits, f32 = WIDE_WORDS, WIDE_BITS, torch.float32
    q5 = torch.randint(-2**31, 2**31 - 1, (q_n, w), generator=g, device=dev, dtype=torch.int32)
    c5 = torch.randint(-2**31, 2**31 - 1, (n, w), generator=g, device=dev, dtype=torch.int32)
    want, k5_plain_ms = timed(lambda: popcount.hamming_bucket_min_ref(q5, c5))
    check(torch.equal(popcount.hamming_bucket_min(q5, c5), want),
          f"hamming {w} words at the bench shape: wgmma bmin differs")
    check(torch.equal(popc_call(torch, lib, popcount, q5, c5, None, dev), want),
          f"hamming {w} words at the bench shape: popc bmin differs")
    del want
    # the path: one hamming_topk of 256 queries (its popcount re-rank of
    # 12,800 rows a query holds ~7 GB of int64 at 64 words), counted from 0
    popcount.launch_count = popcount.wgmma_launch_count = 0
    d5, _ = hamming.hamming_topk(q5[:256], c5, 100)
    torch.cuda.synchronize()
    k5_launches = (popcount.launch_count, popcount.wgmma_launch_count)
    check(k5_launches == (1, 1), f"hamming_topk at {w} words: launches {k5_launches}, not "
          "one of the wgmma variant")
    d_ref = torch.sort(popcount.hamming_distances(q5[:4, None, :], c5[None]), dim=1).values
    check(torch.equal(d5[:4], d_ref[:, :100]), f"hamming_topk at {w} words: top-100 "
          "distances differ from the plain popcount's")
    del d_ref

    q4 = torch.where(torch.rand(q_n, bits, generator=g, device=dev) < 0.5, 1.0, -1.0).bfloat16()
    w4 = torch.randint(-2**31, 2**31 - 1, (n // 32, bits), generator=g, device=dev,
                       dtype=torch.int32)
    (s_ref, bm_ref), k4_plain_ms = timed(
        lambda: packed.packed_scores_with_bucket_max_ref(q4, w4, score_dtype=f32))
    s, bm = packed.packed_scores_with_bucket_max(q4, w4, score_dtype=f32)
    check(torch.equal(s, s_ref) and torch.equal(bm, bm_ref),
          f"packed {bits} bits at the bench shape: scores or bmax differ")
    del s, bm
    d_ref, _ = packed.dots_to_hamming(*mips.select_topk(s_ref, bm_ref, 100), bits)
    del s_ref, bm_ref
    k4_0 = packed.launch_count
    d4, _ = packed.packed_topk(q4, w4, 100, bits)
    torch.cuda.synchronize()
    k4_launches = packed.launch_count - k4_0
    check(k4_launches == 1 and torch.equal(d4, d_ref),
          f"packed_topk at {bits} bits: {k4_launches} launches, or top-100 distances differ")
    del d4, d_ref
    torch.cuda.empty_cache()
    rows = packed.unpack_bits_t(w4)  # the library call's operand: 4 GiB of +-1 bf16
    fns = {"wgmma_w64": (lambda: popcount.hamming_bucket_min(q5, c5), 5),
           "popc_w64": (lambda: popc_call(torch, lib, popcount, q5, c5, None, dev), 1),
           "k4_b2048": (lambda: packed.packed_scores_with_bucket_max(q4, w4, score_dtype=f32), 5),
           "cublas_b2048": (lambda: torch.matmul(q4, rows.T), 3)}
    k5 = {"words": w, "plain_ms": k5_plain_ms, "launches": k5_launches[1],
          **bound_ms((q_n + n) * w * 4 + q_n * (n // 128) * 4, 2 * q_n * n * 32 * w, PEAK_INT8)}
    k4 = {"bits": bits, "score_dtype": "float32", "plain_ms": k4_plain_ms,
          "launches": k4_launches,
          **bound_ms(q_n * bits * 2 + n * bits // 8 + q_n * n * 4 + q_n * (n // 128) * 4,
                     2 * q_n * n * bits, PEAK_INT8)}
    return fns, k5, k4


def phase_hamming_kernel(torch, dev, bench):
    from sessionsimilaritysearch_tpu_torch.ops import _build, hamming, packed, popcount

    lib = _build.load_library()
    g = torch.Generator(device=dev).manual_seed(3)

    def words(rows, w):
        return torch.randint(-2**31, 2**31 - 1, (rows, w), generator=g, device=dev,
                             dtype=torch.int32)

    # both variants against the plain version, bit for bit, on every case
    cases = 0
    for w in K5_WIDTHS:
        q_all, c_all = words(max(K5_QUERIES), w), words(max(K5_ROWS), w)
        for n in K5_ROWS:
            c = c_all[:n]
            pens = (None, k5_penalty(torch, popcount, g, n, dev))
            if n == 5003:  # any int32 penalty: the add wraps as the plain version's does
                pens += (torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                                       dtype=torch.int32),)
            for q_n in K5_QUERIES:
                q = q_all[:q_n]
                for pen in pens:
                    what = (f"hamming W={w} q={q_n} n={n} "
                            f"{'no' if pen is None else 'a'} penalty")
                    check(popcount.k5_variant("cuda", w, True) == "wgmma", what)
                    w0 = popcount.wgmma_launch_count
                    got = popcount.hamming_bucket_min(q, c, pen)
                    check(popcount.wgmma_launch_count == w0 + 1, f"{what}: wgmma not launched")
                    want = popcount.hamming_bucket_min_ref(q, c, pen)
                    check(torch.equal(got, want), f"{what}: wgmma bmin differs")
                    check(torch.equal(popc_call(torch, lib, popcount, q, c, pen, dev), want),
                          f"{what}: popc bmin differs")
                    cases += 1
    # misaligned views run popc through the wrapper
    q, c = words(37, 3), words(5008, 3)
    pen = k5_penalty(torch, popcount, g, 5008, dev)
    for what, args in (("c[5:]", (q, c[5:], None)), ("penalty[1:]", (q, c[4:], pen[1:5005]))):
        check(popcount.k5_variant("cuda", 3, False) == "popc", what)
        n0, w0 = popcount.launch_count, popcount.wgmma_launch_count
        got = popcount.hamming_bucket_min(*args)
        check(popcount.launch_count == n0 + 1 and popcount.wgmma_launch_count == w0,
              f"hamming misaligned {what}: not the popc variant")
        check(torch.equal(got, popcount.hamming_bucket_min_ref(*args)),
              f"hamming misaligned {what}: bmin differs")
        cases += 1
    print(f"hamming kernel: {cases} cases (W {K5_WIDTHS}, q {K5_QUERIES}, n {K5_ROWS}, "
          f"with and without a penalty; misaligned views on popc), wgmma and popc bmin "
          f"equal the plain version")

    # hamming_topk on a ragged, masked corpus against the CPU's
    _, _, q, c = packed_case(torch, hamming, g, 37, 6144, 250, dev)
    live = torch.rand(6144, generator=g, device=dev) >= 0.1
    live[5003:] = False
    d, i = hamming.hamming_topk(q, c, 10, valid_count=5003, row_mask=live)
    d_ref, _ = hamming.hamming_topk(q.cpu(), c.cpu(), 10, valid_count=5003,
                                    row_mask=live.cpu())
    check(torch.equal(d.cpu(), d_ref), "hamming ragged: top-10 distances differ")
    check(bool(live[i].all()), "hamming ragged: a dead row ranked")

    q, c, d_k4, k4_q, k4_words = bench  # the bench point's codes, row-major and K4's
    q_n, n, w = q.shape[0], c.shape[0], c.shape[1]
    want = popcount.hamming_bucket_min_ref(q, c)
    check(torch.equal(popcount.hamming_bucket_min(q, c), want), "hamming bench point: "
          "wgmma bmin differs")
    check(torch.equal(popc_call(torch, lib, popcount, q, c, None, dev), want),
          "hamming bench point: popc bmin differs")
    del want
    plain_ms = cuda_ms(torch, lambda: popcount.hamming_bucket_min_ref(q, c), 1)
    wide_fns, wide_k5, wide_k4 = wide_points(torch, lib, g, q_n, n, dev)
    # the bench point and the wide shapes in the same rounds, in turns
    med, rounds, state = rounds_in_turns(torch, {
        "wgmma": (lambda: popcount.hamming_bucket_min(q, c), 20),
        "popc": (lambda: popc_call(torch, lib, popcount, q, c, None, dev), 5),
        "k4": (lambda: packed.packed_scores_with_bucket_max(k4_q, k4_words), 5),
        **wide_fns})
    del wide_fns
    torch.cuda.empty_cache()
    wide_k5.update(ms=med["wgmma_w64"], popc_ms=med["popc_w64"], library_ms=None)
    wide_k4.update(ms=med["k4_b2048"], library_ms=med["cublas_b2048"])
    print(f"wide codes at q={q_n} n={n}, in the same rounds {state}: K5 {WIDE_WORDS} words "
          f"wgmma {rounds['wgmma_w64']} ms (bound {wide_k5['bound_ms']:.3f}, "
          f"{wide_k5['bound_by']}), popc {rounds['popc_w64']} ms, plain "
          f"{wide_k5['plain_ms']:.1f} ms, hamming_topk {wide_k5['launches']} wgmma launch; "
          f"K4 {WIDE_BITS} bits f32 scores {rounds['k4_b2048']} ms (bound "
          f"{wide_k4['bound_ms']:.3f}, {wide_k4['bound_by']}), cuBLAS bf16 GEMM on the "
          f"unpacked rows {rounds['cublas_b2048']} ms, plain {wide_k4['plain_ms']:.1f} ms, "
          f"packed_topk {wide_k4['launches']} launch; each bit for bit its plain version's")
    popcount.launch_count = popcount.wgmma_launch_count = 0  # K5's path: hamming_topk
    t0 = time.perf_counter()
    d, _ = hamming.hamming_topk(q, c, 100)
    torch.cuda.synchronize()
    topk_ms = (time.perf_counter() - t0) * 1e3
    launches, wgmma_launches = popcount.launch_count, popcount.wgmma_launch_count
    check(launches >= 1, "hamming_topk never launched K5")
    check(wgmma_launches == launches, "hamming_topk did not run K5's wgmma variant")
    check(sorted_equal(torch, d, d_k4), "hamming_topk and K4 top-100 distances differ")
    topk_best = min(cuda_ms(torch, lambda: hamming.hamming_topk(q, c, 100), 1)
                    for _ in range(3))
    ops = 2 * q_n * n * 32 * w  # +-1 products
    tops = ops / (med["wgmma"] * 1e-3) / 1e12
    print(f"hamming kernel bench point q={q_n} n={n} {32 * w} bits, in turns (3 rounds): "
          f"wgmma {rounds['wgmma']} ms, popc {rounds['popc']} ms, K4 {rounds['k4']} ms "
          f"{state}; wgmma {tops:.1f} TOP/s of +-1 products; plain {plain_ms:.3f} ms; bmin "
          f"equal; hamming_topk k=100 {topk_ms:.1f} ms first call, {topk_best:.1f} ms best "
          f"of 3, {launches} launch (wgmma), distances equal K4's")
    del bench, c
    torch.cuda.empty_cache()
    n_bytes = (q_n + n) * w * 4 + q_n * -(-n // 128) * 4
    popc_rate = 16 * SMS * sm_clock_hz()  # one XOR + popcount per word pair
    design = bound_ms(n_bytes, q_n * n * w, popc_rate)
    return {"err": 0, "ms": med["wgmma"], "plain_ms": plain_ms, "launches": launches,
            "wgmma_launches": wgmma_launches, "library_ms": None, "cases": cases,
            "k4_ms_same_rounds": med["k4"], "hamming_topk_ms": topk_best,
            f"w{WIDE_WORDS}": wide_k5, f"k4_b{WIDE_BITS}": wide_k4,
            "rounds": rounds, **bound_ms(n_bytes, ops, PEAK_INT8),
            "popc": {"source": "sessionsimilaritysearch_tpu_torch/csrc/hamming_bucket_min.cu",
                     "ms": med["popc"], "design_bound_ms": design["bound_ms"],
                     "design_bound_by": design["bound_by"], "launches": 0}}


def packed_index_1600(torch, BinaryIndex, g, k, dev):
    """One ``BinaryIndex(1600, mode='packed')`` search on the card (a code as
    wide as the flagship embedding, padded to 1,664 bits), 256 queries over
    2^18 rows, counted from 0 and held to the plain version: the f32 product
    of the +-1 codes, exact for integers. Returns the search's launches."""
    n, n_bits, q_n = 1 << 18, 1600, 256
    codes = random_signs(torch, g, n, n_bits, dev)
    queries = random_signs(torch, g, q_n, n_bits, dev)
    idx = BinaryIndex(n_bits, n, "packed", device=dev)
    for s in range(0, n, 1 << 16):
        idx.add(codes[s: s + (1 << 16)])
    t0 = time.perf_counter()
    (d, i), launches = counted(torch, lambda: idx.search_device(queries, k))
    search_ms = (time.perf_counter() - t0) * 1e3
    check(launches == {**NO_LAUNCHES, "k4": 1},
          f"binary index packed {n_bits} bits: launches {launches}, not one of K4")
    want = ((n_bits - torch.topk(queries @ codes.T, k, dim=1).values) * 0.5).to(torch.int32)
    check(sorted_equal(torch, d, want), f"binary index packed {n_bits} bits: distances differ")
    true = ((n_bits - (queries[:, None, :] * codes[i[:, :5]]).sum(-1)) * 0.5).to(torch.int32)
    check(torch.equal(true, d[:, :5]), f"binary index packed {n_bits} bits: ids do not have "
          "their distances")
    print(f"binary index packed 2^18 x {n_bits} bits (padded {idx._buf.shape[1]}): search "
          f"{q_n} queries k={k} {search_ms:.1f} ms first call, launches {launches}; sorted "
          f"distances equal the plain product's")
    return launches


def phase_binary_index(torch, dev):
    from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
    from sessionsimilaritysearch_tpu_torch.ops import _build, mips

    n, n_bits, q_n, k = 1 << 20, 250, 1024, 100
    g = torch.Generator(device=dev).manual_seed(4)
    codes = random_signs(torch, g, n, n_bits, dev)
    queries = random_signs(torch, g, q_n, n_bits, dev)
    # the plain version: an f32 product of the +-1 codes, exact for integers
    dots = queries @ codes.T
    want = ((n_bits - torch.topk(dots, k, dim=1).values) * 0.5).to(torch.int32)
    del dots
    sign_path = None
    for mode in ("packed", "sign"):
        idx = BinaryIndex(n_bits, n, mode, device=dev)
        for s in range(0, n, 1 << 16):
            idx.add(codes[s: s + (1 << 16)])
        # the path: one search, its counters set to 0 just before
        (d, i), launches = counted(torch, lambda: idx.search_device(queries, k))
        variant = ""
        if mode == "sign":
            # 250-wide bf16 rows are no TMA stride: K1's cp_async variant
            check(launches == {**NO_LAUNCHES, "k1": 1, "k1_cp": 1},
                  f"binary index sign: launches {launches}, not one of K1's cp_async variant")
            sign_path = launches
            variant = f" (K1's cp_async variant, launches {launches})"
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            d, i = idx.search(queries, k)  # numpy: includes the sync
            times.append(time.perf_counter() - t0)
        got = torch.from_numpy(d).to(dev)
        check(sorted_equal(torch, got, want), f"binary index {mode}: distances differ")
        check(bool(((i >= 0) & (i < n)).all()), f"binary index {mode}: bad ids")
        ids = torch.from_numpy(i[:, :5]).to(dev)
        true = ((n_bits - (queries[:, None, :] * codes[ids]).sum(-1)) * 0.5).to(torch.int32)
        check(torch.equal(true, got[:, :5]), f"binary index {mode}: ids do not "
              "have their distances")
        best = min(times)
        print(f"binary index {mode} 2^20 x {n_bits} bits{variant}: search 1024 queries "
              f"k={k} {best * 1e3:.1f} ms best of 3 ({q_n / best:.0f} QPS); sorted "
              f"distances equal the plain product's")
        del idx
    wide_path = packed_index_1600(torch, BinaryIndex, g, k, dev)
    # K1 alone at sign mode's shape: +-1 bf16 rows of 250 bits (no TMA
    # stride), bf16 scores; the cp_async variant through the wrapper, the
    # tile loop through its C entry point, a cuBLAS bf16 GEMM and the plain
    # version in the same rounds
    lib = _build.load_library()
    qb, cb, bf = queries.bfloat16(), codes.bfloat16(), torch.bfloat16
    del codes
    check(mips.k1_variant(dev.type, bf, n_bits, (qb.data_ptr(), cb.data_ptr())) == "cp_async",
          "binary index sign: its rows do not take K1's cp_async variant")
    s_ref, bm_ref = mips.scores_with_bucket_max_ref(qb, cb, score_dtype=bf)
    # +-1 products are integers of magnitude <= 250: exact on every side
    for name, run in (("cp_async", lambda: mips.scores_with_bucket_max(qb, cb, score_dtype=bf)),
                      ("tile", lambda: tile_loop(torch, lib, mips, qb, cb, dev, out_bf16=True))):
        s, bm = run()
        check(torch.equal(s, s_ref) and torch.equal(bm, bm_ref),
              f"binary index sign: K1's {name} variant differs from its plain version")
        del s, bm
    del s_ref, bm_ref
    med, rounds, state = rounds_in_turns(torch, {
        "cp_async": (lambda: mips.scores_with_bucket_max(qb, cb, score_dtype=bf), 5),
        "tile": (lambda: tile_loop(torch, lib, mips, qb, cb, dev, out_bf16=True), 2),
        "cublas": (lambda: torch.matmul(qb, cb.T), 5),
        "plain": (lambda: mips.scores_with_bucket_max_ref(qb, cb, score_dtype=bf), 1)})
    del qb, cb
    torch.cuda.empty_cache()
    bound = bound_ms(q_n * n_bits * 2 + n * n_bits * 2 + q_n * n * 2 + q_n * (n // 128) * 4,
                     2 * q_n * n * n_bits, PEAK_BF16)
    common = {"plain_ms": med["plain"], "library_ms": med["cublas"], **bound}
    cp = {"ms": med["cp_async"], **common}
    tile = {"ms": med["tile"], **common}
    print(f"K1 at sign mode's shape q={q_n} n={n} d={n_bits} bf16 -> bf16, three rounds in "
          f"turns {state}: cp_async variant {rounds['cp_async']} ms, tile loop "
          f"{rounds['tile']} ms, cuBLAS bf16 GEMM {rounds['cublas']} ms, plain "
          f"{rounds['plain']} ms; bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}); "
          f"scores and bmax of both kernels equal the plain version's")
    cp["producer_ablation_d256"] = producer_ablation(torch, mips, lib, g, q_n, n, dev)
    return tile, cp, sign_path, wide_path


def producer_ablation(torch, mips, lib, g, q_n, n, dev, bits=256):
    """The cp_async variant (through its C entry point) beside the TMA-fed
    wgmma variant on the same +-1 rows of 256 bits, which TMA can describe:
    the same products and epilogue, only the producer differs. Both must
    equal the plain version; three rounds in turns."""
    bf = torch.bfloat16
    codes = random_signs(torch, g, n, bits, dev).to(bf)
    queries = random_signs(torch, g, q_n, bits, dev).to(bf)
    check(mips.k1_variant(dev.type, bf, bits, (queries.data_ptr(), codes.data_ptr()))
          == "wgmma", "producer ablation: 256-bit rows do not take the TMA variant")

    def cp():
        return cp_loop(torch, lib, mips, queries, codes, dev)

    def tma():
        return mips.scores_with_bucket_max(queries, codes, score_dtype=bf)

    s_ref, bm_ref = mips.scores_with_bucket_max_ref(queries, codes, score_dtype=bf)
    for name, run in (("cp_async", cp), ("wgmma", tma)):
        s, bm = run()
        check(torch.equal(s, s_ref) and torch.equal(bm, bm_ref),
              f"producer ablation: the {name} variant differs from the plain version")
        del s, bm
    del s_ref, bm_ref
    med, rounds, state = rounds_in_turns(torch, {"cp_async": (cp, 5), "wgmma": (tma, 5)})
    del codes, queries
    torch.cuda.empty_cache()
    print(f"producer ablation q={q_n} n={n} d={bits} bf16 -> bf16, three rounds in turns "
          f"{state}: cp_async variant {rounds['cp_async']} ms, TMA-fed wgmma variant "
          f"{rounds['wgmma']} ms; both equal the plain version")
    return {"cp_async_ms": med["cp_async"], "wgmma_ms": med["wgmma"]}


# the two-stage tiers at full width (phase 8): rows, width, queries, depth,
# pools, the ITQ / PCA fit sample, and (prefilter, stage1, code width) of
# each tier
TIER_ROWS, TIER_DIM, TIER_Q, TIER_K = 1 << 20, 1600, 1024, 100
TIER_POOLS = (128, 512)
TIER_FIT_ROWS = 1 << 15
TIERS = (("binary", "matmul", 256), ("itq", "matmul", 250), ("int8x8", "matmul", 0),
         ("pca", "matmul", 64), ("itq", "packed", 250))
# read_counts() of a run that launched nothing
NO_LAUNCHES = {"k1": 0, "k1_wgmma": 0, "k1_cp": 0, "k2": 0, "k2_wgmma": 0, "k4": 0}


def reset_counts():
    """Set every kernel counter of the two-stage and binary paths to 0."""
    from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed

    mips.launch_count = mips.wgmma_launch_count = mips.cp_async_launch_count = 0
    mips_int8.launch_count = mips_int8.wgmma_launch_count = 0
    packed.launch_count = 0


def read_counts() -> dict:
    """The counters as one dict: K1 (and its wgmma and cp_async variants),
    K2 (and its wgmma variant), K4."""
    from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed

    return {"k1": mips.launch_count, "k1_wgmma": mips.wgmma_launch_count,
            "k1_cp": mips.cp_async_launch_count,
            "k2": mips_int8.launch_count, "k2_wgmma": mips_int8.wgmma_launch_count,
            "k4": packed.launch_count}


def add_counts(total: dict, more: dict) -> dict:
    return {key: total.get(key, 0) + more[key] for key in more}


def counted(torch, fn):
    """``fn()`` with the counters set to 0 just before and read just after."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def stage1_plain(torch, idx, qn):
    """The stage-1 scores [q, size] f32 of ``idx`` through the kernels'
    plain versions, on the index's own codes: what its stage 1 ranks (the
    int8x8 scores times the query scale)."""
    from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed

    size, bf = idx.size, torch.bfloat16
    if idx.stage1 == "packed":
        ci = idx._codes_index
        q = torch.nn.functional.pad(idx._encode(qn)[0], (0, ci.bits_pad - ci.n_bits))
        s, _ = packed.packed_scores_with_bucket_max_ref(q, ci._buf[: ci._t_used_rows()],
                                                        size, None, bf)
        return s[:, :size].float()
    if idx.prefilter in ("binary", "itq"):
        sd = bf if idx.n_bits <= 256 else torch.float32
        s, _ = mips.scores_with_bucket_max_ref(idx._encode(qn)[0], idx._codes[:size],
                                               score_dtype=sd)
        return s.float()
    if idx.prefilter == "int8x8":
        q8, qs = mips_int8.quantize_rows_int8(qn)
        s, _ = mips_int8.scores_with_bucket_max_int8_ref(q8, idx._codes[:size],
                                                         idx._scales[:size], score_dtype=bf)
        return s.float() * qs[:, None]
    s, _ = mips.scores_with_bucket_max_ref(idx._project(qn), idx._codes[:size], score_dtype=bf)
    return s.float()


def stage1_kernel(torch, idx, qn):
    """A call that launches the tier's stage-1 kernel once, on the inputs
    the index's stage 1 gives it (to time the kernel apart from the
    selection)."""
    from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed

    size, bf = idx.size, torch.bfloat16
    if idx.stage1 == "packed":
        ci = idx._codes_index
        q = torch.nn.functional.pad(idx._encode(qn)[0], (0, ci.bits_pad - ci.n_bits))
        words = ci._buf[: ci._t_used_rows()]
        return lambda: packed.packed_scores_with_bucket_max(q, words, size, None, bf)
    if idx.prefilter == "int8x8":
        q8, _ = mips_int8.quantize_rows_int8(qn)
        return lambda: mips_int8.scores_with_bucket_max_int8(
            q8, idx._codes[:size], idx._scales[:size], score_dtype=bf)
    q = (idx._encode(qn)[0] if idx.prefilter != "pca" else idx._project(qn)).contiguous()
    return lambda: mips.scores_with_bucket_max(q, idx._codes[:size], score_dtype=bf)


def stage1_bound(prefilter, stage1, width, q_n, n) -> dict:
    """The bound of a tier's stage-1 kernel call: its code bytes, bf16
    scores and f32 bucket maxes over the memory rate, or its products over
    the peak of their type."""
    out_bytes = q_n * n * 2 + q_n * (n // 128) * 4
    if stage1 == "packed":
        bits = -(-width // 128) * 128
        return bound_ms(q_n * bits * 2 + n * bits // 8 + out_bytes, 2 * q_n * n * bits,
                        PEAK_BF16)
    if prefilter == "int8x8":
        return bound_ms(q_n * width + n * width + n * 4 + out_bytes, 2 * q_n * n * width,
                        PEAK_INT8)
    return bound_ms((q_n + n) * width * 2 + out_bytes, 2 * q_n * n * width, PEAK_BF16)


def expected_variant(prefilter, stage1, n_bits) -> dict:
    """The launches one search of a tier makes, per kernel and variant."""
    if stage1 == "packed":
        return {**NO_LAUNCHES, "k4": 1}
    if prefilter == "int8x8":
        return {**NO_LAUNCHES, "k2": 1, "k2_wgmma": 1}
    # 250-wide bf16 rows are no TMA stride: the cp_async variant
    wgmma = int(n_bits % 8 == 0)
    return {**NO_LAUNCHES, "k1": 1, "k1_wgmma": wgmma, "k1_cp": 1 - wgmma}


def phase_twostage_index(torch, dev, card):
    """Phase 8: every two-stage tier at full width, one index at a time."""
    from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex
    from sessionsimilaritysearch_tpu_torch.ops import topk
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq, fit_pca

    n, d, q_n, k = TIER_ROWS, TIER_DIM, TIER_Q, TIER_K
    g = torch.Generator(device=dev).manual_seed(5)
    rows = unit_rows(torch, g, n, d, dev)
    planted = torch.arange(q_n, device=dev) * (n // q_n) + 7
    # cosine ~0.9 to the planted row: unit row plus noise of norm 0.484
    noise = torch.randn(q_n, d, generator=g, device=dev)
    queries = rows[planted].float() + 0.4843 * noise / noise.norm(dim=1, keepdim=True)
    qn = topk.l2_normalize(queries)
    sample = rows[:TIER_FIT_ROWS].float().cpu().numpy()
    t0 = time.perf_counter()
    projectors = {"itq": fit_itq(sample, 250)}
    fit_s = {"itq": time.perf_counter() - t0}
    t0 = time.perf_counter()
    projectors["pca"] = fit_pca(sample, 64)
    fit_s["pca"] = time.perf_counter() - t0
    # the f64 dense oracle's top-k values: the pool recall printed per tier
    oracle = oracle_topk(torch, qn.double(), lambda lo, hi: rows[lo:hi].double(), n, k)
    print(f"two-stage tiers: {n} x {d} bf16 rows, {q_n} queries planted at cosine ~0.9, "
          f"k={k}, pools {TIER_POOLS}; fits on {TIER_FIT_ROWS} rows: itq 250 bits "
          f"{fit_s['itq']:.1f} s, pca 64 {fit_s['pca']:.1f} s (host) [{card}]")
    out, errs = {}, []
    for prefilter, stage1, n_bits in TIERS:
        name = f"{prefilter}/{stage1}" + (f"/{n_bits}" if n_bits else "")
        idx = TwoStageIndex(d, n, device=dev, prefilter=prefilter, stage1=stage1,
                            projector=projectors.get(prefilter), n_bits=n_bits or 256,
                            pool=TIER_POOLS[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, n, 1 << 16):
            idx.add(rows[lo: lo + (1 << 16)])
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        # the path: one search, its counters set to 0 just before
        _, launches = counted(torch, lambda: idx.search_device(queries, k))
        check(launches == expected_variant(prefilter, stage1, n_bits),
              f"two-stage {name}: launches {launches}")
        plain = stage1_plain(torch, idx, qn)
        kernel_ms = cuda_ms(torch, stage1_kernel(torch, idx, qn), 5)
        kbound = stage1_bound(prefilter, stage1, n_bits or d, q_n, n)
        tier = {"fill_s": fill_s, "launches": launches, "stage1_kernel_ms": kernel_ms,
                "stage1_kernel_bound_ms": kbound["bound_ms"],
                "stage1_kernel_bound_by": kbound["bound_by"]}
        for pool in TIER_POOLS:
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                D, I = idx.search(queries, k, pool=pool)  # numpy: includes the sync
                times.append(time.perf_counter() - t0)
            cand = idx._stage1(qn, pool)
            s1_ms = cuda_ms(torch, lambda: idx._stage1(qn, pool), 3)
            rr_ms = cuda_ms(torch, lambda: topk.rerank_topk(qn, idx._buf, cand, k), 3)
            # gate 1: the pool's stage-1 scores are the plain top-pool's
            want = torch.topk(plain, pool, dim=1).values
            got = torch.gather(plain, 1, cand)
            scale = plain.abs().amax(dim=1)
            s1_recall = topk.value_recall_from_scores(
                got.cpu().numpy(), want.cpu().numpy(), (BF16_TOL * scale).cpu().numpy())
            check(s1_recall == 1.0, f"two-stage {name} pool {pool}: stage-1 value recall "
                  f"{s1_recall} against the plain stage 1")
            # gate 2: the top-k is the exact (f64) re-rank of the pool
            best = torch.cat([  # 128 queries at a time: the gathered rows in f64
                torch.topk(torch.bmm(idx._buf[cand[lo: lo + 128]].double(),
                                     qn[lo: lo + 128].double()[..., None])[..., 0],
                           k, dim=1).values for lo in range(0, q_n, 128)])
            err = float(np.abs(D - best.cpu().numpy()).max())
            check(err <= 1e-5, f"two-stage {name} pool {pool}: top-{k} vs the exact "
                  f"re-rank of the pool {err}")
            # gate 3: every planted row is the top-1
            hits = float((I[:, 0] == planted.cpu().numpy()).mean())
            check(hits == 1.0, f"two-stage {name} pool {pool}: planted rows at top-1 {hits}")
            recall = topk.value_recall_from_scores(best.cpu().numpy(), oracle.cpu().numpy(),
                                                   1e-6)
            errs.append(err)
            total = min(times)
            tier[pool] = {"total_ms": total * 1e3, "qps": q_n / total, "stage1_ms": s1_ms,
                          "rerank_ms": rr_ms, "pool_recall_at_100": recall}
            print(f"  {name} pool {pool}: search {total * 1e3:.1f} ms best of 3 "
                  f"({q_n / total:.0f} QPS); stage 1 {s1_ms:.3f} ms, re-rank {rr_ms:.3f} ms "
                  f"(CUDA events); stage-1 value recall vs plain {s1_recall}, top-{k} vs "
                  f"exact re-rank max_abs_err {err:.3g}, planted top-1 {hits}, "
                  f"value-recall@{k} vs the f64 dense oracle {recall:.4f} (not gated)")
        print(f"  {name}: fill {fill_s:.2f} s; stage-1 kernel alone {kernel_ms:.3f} ms "
              f"{smi()} (bound {kbound['bound_ms']:.3f} ms, {kbound['bound_by']}); launches "
              f"on one search {launches} [{card}]")
        out[name] = tier
        del idx, plain
        torch.cuda.empty_cache()
    del rows
    torch.cuda.empty_cache()
    return max(errs), out


def phase_binary_maintenance(torch, dev, card):
    """BinaryIndex's verbs at 2^20 x 256 bits, packed (K4) and sign (K1's
    wgmma variant); after each verb the index is held against a fresh one
    built from the surviving codes."""
    from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
    from sessionsimilaritysearch_tpu_torch.index.dense import compaction_plan

    n, bits, q_n, k = BIN_ROWS, 256, BIN_Q, 100
    g = torch.Generator(device=dev).manual_seed(6)
    codes = random_signs(torch, g, n, bits, dev)
    extra = random_signs(torch, g, n // 100, bits, dev)
    queries = random_signs(torch, g, q_n, bits, dev)
    path = {}

    def build(mode, rows):
        idx = BinaryIndex(bits, n, mode, device=dev)
        for lo in range(0, rows.shape[0], 1 << 16):
            idx.add(rows[lo: lo + (1 << 16)])
        return idx

    def held(idx, ref, what):
        """The live index against a fresh one built from ``ref`` (the codes
        the live one should hold, slot by slot): equal buffers, and equal
        sorted distances of a search through the kernels."""
        nonlocal path
        (d, i), launches = counted(torch, lambda: idx.search_device(queries, k))
        path = add_counts(path, launches)
        check(launches["k4" if idx.mode == "packed" else "k1_wgmma"] == 1,
              f"binary {idx.mode} {what}: launches {launches}")
        fresh = build(idx.mode, ref)
        rows = idx._t_used_rows() if idx.mode == "packed" else idx.size
        same = (idx.size == fresh.size and torch.equal(idx._buf[:rows], fresh._buf[:rows])
                and (idx.mode == "sign" or not idx._buf[rows:].any()))
        check(same, f"binary {idx.mode} {what}: the buffer is not the fresh index's")
        d_f, _ = fresh.search_device(queries, k)
        check(sorted_equal(torch, d, d_f), f"binary {idx.mode} {what}: distances differ")
        true = ((bits - (queries[:, None, :] * ref[i[:, :5]]).sum(-1)) * 0.5).to(torch.int32)
        check(torch.equal(true, d[:, :5]), f"binary {idx.mode} {what}: ids do not have "
              "their distances")
        del fresh

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    print(f"binary maintenance: BinaryIndex {n} x {bits} bits, {q_n} queries k={k} [{card}]")
    for mode in ("packed", "sign"):
        idx = build(mode, codes)
        ref = codes.clone()
        rm = np.random.default_rng(7).choice(n, n // 100, replace=False)
        src, dst, new_size = compaction_plan(n, rm)
        removed, rm_ms = timed(lambda: idx.remove_ids(rm))
        check(removed == len(rm) and idx.size == new_size, f"binary {mode}: remove_ids")
        ref[torch.from_numpy(dst.astype(np.int64)).to(dev)] = ref[
            torch.from_numpy(src.astype(np.int64)).to(dev)]
        ref = ref[:new_size]
        held(idx, ref, "after remove_ids")
        _, add_ms = timed(lambda: idx.add(extra))
        ref = torch.cat([ref, extra])
        held(idx, ref, "after the refill")
        # range search at query 0's 100th distance: ~100 hits a query
        d0, _ = idx.search_device(queries[:64], 100)
        radius = int(d0[0, 99])
        ((lims, D, I), launches), rs_ms = timed(lambda: counted(
            torch, lambda: idx.range_search(queries[:64], radius)))
        path = add_counts(path, launches)
        dist = ((bits - queries[:64] @ ref.T) * 0.5).round().to(torch.int32)
        hits = (dist <= radius).sum(dim=1).cpu().numpy()
        check(np.array_equal(np.diff(lims), hits), f"binary {mode} range_search: hit counts "
              "differ from the plain distances'")
        rows_of = np.repeat(np.arange(64), np.diff(lims))
        check(np.array_equal(D, dist[rows_of, I].cpu().numpy()),
              f"binary {mode} range_search: distances differ")
        # save / load
        with tempfile.TemporaryDirectory() as tmp:
            p = os.path.join(tmp, "binary")
            _, save_ms = timed(lambda: idx.save(p))
            mb = os.path.getsize(p + ".npz") / 2**20
            back, load_ms = timed(lambda: BinaryIndex.load(p, device=dev))
        held(back, ref, "loaded")
        print(f"  {mode}: remove_ids of {len(rm)} scattered rows {rm_ms:.1f} ms; refill of "
              f"{extra.shape[0]} rows {add_ms:.1f} ms; range_search 64 queries at radius "
              f"{radius} {rs_ms:.1f} ms (hits per query min {hits.min()} median "
              f"{int(np.median(hits))} max {hits.max()}, launches {launches}); save "
              f"{mb:.1f} MB {save_ms:.1f} ms, load {load_ms:.1f} ms; each held against a "
              f"fresh index of the surviving codes: buffers and distances equal")
        del idx, back, ref, dist
        torch.cuda.empty_cache()
    # merge_from across modes: two halves, each into an index of the other mode
    half = n // 2
    for dst_mode, src_mode in (("packed", "sign"), ("sign", "packed")):
        a, b = build(dst_mode, codes[:half]), build(src_mode, codes[half:])
        merged, merge_ms = timed(lambda: a.merge_from(b))
        check(merged == n - half, f"binary merge {src_mode} -> {dst_mode}: {merged} rows")
        held(a, codes, f"merged from {src_mode}")
        print(f"  merge_from {src_mode} -> {dst_mode} of {merged} rows {merge_ms:.1f} ms; "
              f"held against a fresh index of all codes")
        del a, b
        torch.cuda.empty_cache()
    print(f"binary maintenance launches on its searches: {path}")
    del codes, extra
    torch.cuda.empty_cache()
    return path


def phase_twostage_engine_verbs(torch, dev, parts, card):
    """The two-stage engine's verbs at Config() width (phase 4's encoder and
    8,192 sessions), 'itq' 250 bits with stage1 'matmul' (K1's cp_async variant)
    and 'packed' (K4): each search after a verb held against a fresh engine
    on the surviving sessions."""
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.engine import _session_key
    from sessionsimilaritysearch_tpu_torch.ops import topk
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq

    cfg, tok, enc, data, corpus = parts
    n = len(data)
    proj = fit_itq(corpus, cfg.code_len)
    sample = [data[i] for i in range(0, n, 32)]
    path = {}
    for stage1 in ("matmul", "packed"):
        rng = np.random.default_rng(43)

        def new_engine():
            return port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,
                                            capacity=65536, device=dev, prefilter="itq",
                                            stage1=stage1, projector=proj, pool=512)

        eng = new_engine()
        per = n // 8
        for b in range(8):
            eng.add_sessions(data[b * per: (b + 1) * per], stamp=float(b))

        def held(what):
            nonlocal path
            (D, I), launches = counted(torch, lambda: eng.search(sample, k=100))
            path = add_counts(path, launches)
            check(launches == expected_variant("itq", stage1, cfg.code_len),
                  f"two-stage engine {stage1} {what}: launches {launches}")
            fresh = new_engine()
            fresh.add_sessions(list(eng.sessions))
            Df, If = fresh.search(sample, k=100)
            scale = np.abs(Df).max(axis=1)
            agree = topk.value_recall_from_scores(D, Df, BF16_TOL * scale)
            same = float((I == If).mean())
            check(agree >= 0.999, f"two-stage engine {stage1} {what}: value recall "
                  f"{agree} against a fresh engine on the surviving sessions")
            del fresh
            return D, I, agree, same

        def timed(fn):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t0) * 1e3

        lines = []
        rm_ids = rng.choice(n, n // 16, replace=False)
        removed, ms = timed(lambda: eng.remove_sessions(ids=rm_ids))
        check(removed == len(rm_ids), f"two-stage engine {stage1}: removed {removed} by id")
        _, _, agree, same = held("after remove_sessions(ids=)")
        lines.append(f"remove_sessions(ids=) {removed} {ms:.1f} ms, value recall {agree}, "
                     f"ids equal {same:.4f}")
        victims = [eng.sessions[i] for i in rng.choice(eng.index.ntotal, 64, replace=False)]
        vkeys = {_session_key(s) for s in victims}
        removed, ms = timed(lambda: eng.remove_sessions(data=victims))
        D, I, agree, same = held("after remove_sessions(data=)")
        check(not any(_session_key(eng.sessions[i]) in vkeys for i in I[I >= 0]),
              f"two-stage engine {stage1}: removed content was returned")
        lines.append(f"remove_sessions(data=) 64 sessions ({removed} rows) {ms:.1f} ms, value "
                     f"recall {agree}, ids equal {same:.4f}")
        removed, ms = timed(lambda: eng.expire(before=1.0))
        check(removed > 0 and (eng._stamps.view() >= 1.0).all(),
              f"two-stage engine {stage1}: expire removed {removed}")
        D_cap, I_cap, agree, same = held("after expire")
        lines.append(f"expire {removed} rows {ms:.1f} ms, value recall {agree}, ids equal "
                     f"{same:.4f}")
        n_cap = eng.index.ntotal
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "engine")
            handle, cap_ms = timed(lambda: eng.save_async(prefix))
            _, write_ms = timed(handle.join)
            del eng
            torch.cuda.empty_cache()
            back = new_engine()
            _, restore_ms = timed(lambda: back.restore(prefix))
        (D_r, I_r), launches = counted(torch, lambda: back.search(sample, k=100))
        path = add_counts(path, launches)
        check(back.index.ntotal == n_cap and np.array_equal(I_r, I_cap)
              and np.array_equal(D_r, D_cap),
              f"two-stage engine {stage1}: the restored engine differs from the capture")
        lines.append(f"save_async capture {cap_ms:.1f} ms + write {write_ms:.1f} ms, restore "
                     f"{restore_ms:.1f} ms, the capture's top-k back")
        print(f"two-stage engine verbs itq {cfg.code_len} bits, stage1 {stage1}, pool 512, "
              f"{len(sample)} queries k=100 [{card}]:")
        for line in lines:
            print(f"  {line}")
        del back
        torch.cuda.empty_cache()
    print(f"two-stage engine verbs launches on its searches: {path}")
    return path


def phase_twostage_engine(torch, dev, parts):
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.ops import packed
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq

    cfg, tok, enc, data, corpus = parts
    t0 = time.perf_counter()
    proj = fit_itq(corpus, cfg.code_len)
    fit_s = time.perf_counter() - t0
    eng = port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,
                                   capacity=65536, device=dev, prefilter="itq",
                                   stage1="packed", projector=proj, pool=512)
    packed.launch_count = 0  # count the path's launches from ingest on
    t0 = time.perf_counter()
    eng.add_sessions(data)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    D, I = eng.search(data[:256], k=100)
    search_s = time.perf_counter() - t0
    launches = packed.launch_count
    check(eng.index.ntotal == len(data), f"two-stage engine: ntotal {eng.index.ntotal}")
    check(D.shape == (256, 100) and np.isfinite(D).all(), "two-stage engine: bad result")
    top1_err = float(np.abs(D[:, 0] - 1.0).max())
    check(top1_err <= 2 * 2.0**-8, f"two-stage engine: top-1 score off 1.0 by {top1_err}")
    check(launches >= 1, "two-stage engine: K4 never launched")

    # K4 against its plain version on the engine's own codes
    idx = eng.index
    ci = idx._codes_index
    qn = idx._rows(eng.embed(data[:256], out="device"))  # as search() takes them
    q = torch.nn.functional.pad(idx._encode(qn)[0], (0, ci.bits_pad - ci.n_bits))
    used = ci._t_used_rows()
    words = ci._buf[:used]
    ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max(q, words, ci.size), 10)
    plain_ms = cuda_ms(torch, lambda: packed.packed_scores_with_bucket_max_ref(
        q, words, ci.size), 10)
    s, bm = packed.packed_scores_with_bucket_max(q, words, ci.size)
    s_ref, bm_ref = packed.packed_scores_with_bucket_max_ref(q, words, ci.size)
    check(torch.equal(s, s_ref) and torch.equal(bm, bm_ref),
          "two-stage engine: K4 differs from its plain version on the engine's codes")
    print(f"two-stage engine Config() itq {ci.n_bits} bits (fit {fit_s:.1f} s), pool 512: "
          f"ingest {len(data)} sessions {ingest_s:.2f} s ({len(data) / ingest_s:.0f} "
          f"sessions/s); search 256 k=100 {search_s * 1e3:.1f} ms; top-1 |score-1| max "
          f"{top1_err:.3g}, self-hit ids {float((I[:, 0] == np.arange(256)).mean()):.4f}; "
          f"K4 launches {launches}; engine's codes q=256 n={used * 32}, kernel {ms:.4f} "
          f"ms vs plain {plain_ms:.4f} ms, scores and bmax equal")
    print(f"two-stage engine stats: {json.dumps(eng.stats())}")
    return launches

# phase 9c: sharded serving, four shards on the one card
SH_SHARDS, SH_ROWS, SH_DIM, SH_Q, SH_K = 4, 1 << 20, 1600, 1024, 100
SH_ENGINE_Q, SH_REMOVE = 256, 512
SH_POOL = 128
SH_FIT_ROWS = 4096  # the sharded tiers' ITQ and PCA fits (any fit serves the checks)
SH_TIERS = (("binary", "matmul", 256), ("itq", "matmul", 250), ("binary", "packed", 256),
            ("int8x8", "matmul", 0), ("pca", "matmul", 64))
SH_BITS = 250
SH_NCCL_ROWS = 1 << 18


def same_topk(torch, got, want, tol, what) -> float:
    """A sharded (D, I) against the unsharded one's: the same missing slots,
    values within ``tol``, ids equal wherever the values are more than
    ``tol`` from their neighbours. Returns the largest |difference|."""
    (D, I), (Dw, Iw) = ([np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in r]
                        for r in (got, want))
    check(D.shape == Dw.shape, f"{what}: shapes {D.shape} vs {Dw.shape}")
    missing = Iw < 0
    check(((I < 0) == missing).all(), f"{what}: missing slots differ")
    err = float(np.abs(D[~missing] - Dw[~missing]).max()) if (~missing).any() else 0.0
    check(err <= tol, f"{what}: values max_abs_err {err} > {tol}")
    gap = np.abs(np.diff(np.where(missing, -1e30, Dw), axis=1)) > tol
    ones = np.ones((D.shape[0], 1), bool)
    sure = np.concatenate([ones, gap], 1) & np.concatenate([gap, ones], 1) & ~missing
    check((I[sure] == Iw[sure]).all(), f"{what}: ids differ where the values are distinct")
    return err


def best_of(fn, times: int = 3) -> float:
    """Best host-clock ms of ``fn`` (which must end in a synchronize)."""
    out = []
    for _ in range(times):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return min(out)


def scaled(counts: dict, times: int) -> dict:
    return {key: v * times for key, v in counts.items()}


def sharded_engine(torch, topk_mod, mesh, dev, parts, card):
    """(a) SessionSearchEngine(mesh=) at Config() width against the
    unsharded engine on the same sessions, then removal and save / restore."""
    import tempfile

    import sessionsimilaritysearch_tpu_torch as port

    cfg, tok, enc, data, _ = parts
    n, q = len(data), data[:SH_ENGINE_Q]
    kw = dict(dim=cfg.session_emb_dim, capacity=n)
    one = port.SessionSearchEngine(cfg, tok, enc, device=dev, **kw)
    eng = port.SessionSearchEngine(cfg, tok, enc, mesh=mesh, **kw)
    ingest = {}
    for name, e in (("unsharded", one), ("sharded", eng)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.add_sessions(data)
        torch.cuda.synchronize()
        ingest[name] = time.perf_counter() - t0
    check(eng.index.ntotal == n and eng.stats()["pending"] == 0, "sharded engine: ingest")
    (D, I), counts = counted(torch, lambda: eng.search(q, k=SH_K))
    check(counts == {**NO_LAUNCHES, "k1": SH_SHARDS, "k1_wgmma": SH_SHARDS},
          f"sharded engine: one search's launches {counts} (want {SH_SHARDS} f32 wgmma K1)")
    D1, I1 = one.search(q, k=SH_K)
    err = same_topk(torch, (D, I), (D1, I1), 1e-5, "sharded engine vs unsharded")
    emb = topk_mod.l2_normalize(one.embed(q, out="device").float())
    exact = emb.double() @ one.index._buf[:n].double().T
    rec = value_recall(torch, topk_mod, exact, torch.from_numpy(I).to(dev), SH_K, 1e-5)
    check(rec == 1.0, f"sharded engine: value-recall@{SH_K} {rec}")
    ms = {"sharded": best_of(lambda: eng.search(q, k=SH_K)),
          "unsharded": best_of(lambda: one.search(q, k=SH_K))}
    # removal by ids: tombstones; removed ids never return, survivors keep
    # their ids (and rows)
    gone = np.random.default_rng(0).choice(n, SH_REMOVE, replace=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(eng.remove_sessions(ids=gone) == SH_REMOVE, "sharded engine: removal count")
    remove_ms = (time.perf_counter() - t0) * 1e3
    D2, I2 = eng.search(q, k=SH_K)
    check(not np.isin(I2, gone).any(), "sharded engine: a removed id came back")
    keep = np.setdiff1d(np.arange(n), gone)
    mask = np.ones(n, bool)
    mask[gone] = False
    same_topk(torch, (D2, I2), one.index.search(emb, SH_K, row_mask=mask), 1e-5,
              "sharded engine after removal vs the unsharded one masked")
    check(np.array_equal(eng.reconstruct(keep[::16]), one.reconstruct(keep[::16])),
          "sharded engine: a survivor's row moved to another id")
    # save / restore on the same mesh: the same top-k, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "sharded")
        t0 = time.perf_counter()
        eng.save(prefix)
        save_s = time.perf_counter() - t0
        back = port.SessionSearchEngine(cfg, tok, enc, mesh=mesh, **kw)
        t0 = time.perf_counter()
        back.restore(prefix)
        restore_s = time.perf_counter() - t0
    D3, I3 = back.search(q, k=SH_K)
    check(np.array_equal(D3, D2) and np.array_equal(I3, I2) and back._removed == set(gone),
          "sharded engine: the restored engine's top-k or tombstones differ")
    print(f"  (a) engine Config() f32, {n} sessions on {SH_SHARDS} shards: ingest "
          f"{ingest['sharded']:.2f} s (unsharded {ingest['unsharded']:.2f} s); search "
          f"{SH_ENGINE_Q} k={SH_K} {ms['sharded']:.2f} ms (unsharded {ms['unsharded']:.2f} ms, "
          f"best of 3); launches {counts['k1']} f32 wgmma K1; vs unsharded max_abs_err "
          f"{err:.3g}, value-recall@{SH_K} {rec}; remove {SH_REMOVE} ids {remove_ms:.1f} ms; "
          f"save {save_s:.2f} s, restore {restore_s:.2f} s, restored top-k identical [{card}]")
    return counts, {"search_ms": ms, "ingest_s": ingest, "remove_ms": remove_ms,
                    "save_s": save_s, "restore_s": restore_s, "max_abs_err": err}


def fill_both(torch, g, a, b, n, d, dev):
    """The same n seeded unit rows into two indexes, 65,536 at a time."""
    for lo in range(0, n, 1 << 16):
        rows = torch.randn(min(1 << 16, n - lo), d, generator=g, device=dev)
        rows = rows / rows.norm(dim=1, keepdim=True)
        a.add(rows)
        b.add(rows)
    torch.cuda.synchronize()


def sharded_dense(torch, topk_mod, mesh, dev, card):
    """(b) ShardedDenseIndex at 2^20 x 1600 in f32, bf16 and int8x8 against
    DenseIndex on the same rows; the bf16 gate; search and merge times."""
    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
    from sessionsimilaritysearch_tpu_torch.index.sharded import ShardedDenseIndex
    from sessionsimilaritysearch_tpu_torch.parallel.collectives import merge_candidates

    n, d, q_n, k = SH_ROWS, SH_DIM, SH_Q, SH_K
    bf = torch.bfloat16
    total, out = dict(NO_LAUNCHES), {}
    for name, kw, tol, want in (
            ("f32", {}, 1e-5, {"k1": SH_SHARDS, "k1_wgmma": SH_SHARDS}),
            ("bf16", {"dtype": bf, "score_dtype": bf}, BF16_TOL,
             {"k1": SH_SHARDS, "k1_wgmma": SH_SHARDS}),
            ("int8x8", {"quantize": "int8x8"}, 1e-5, {"k2": SH_SHARDS, "k2_wgmma": SH_SHARDS})):
        one = DenseIndex(d, n, device=dev, **kw)
        sh = ShardedDenseIndex(d, n, mesh, **kw)
        g = torch.Generator(device=dev).manual_seed(21)
        fill_both(torch, g, one, sh, n, d, dev)
        queries = torch.randn(q_n, d, generator=g, device=dev)
        sh.search(queries, k)  # warm-up
        (D, I), counts = counted(torch, lambda: sh.search(queries, k, out="device"))
        check(counts == {**NO_LAUNCHES, **want},
              f"sharded dense {name}: one search's launches {counts}")
        total = add_counts(total, counts)
        err = same_topk(torch, (D, I), one.search(queries, k, out="device"), tol,
                        f"sharded dense {name} vs DenseIndex")
        ms = {"sharded": best_of(lambda: sh.search(queries, k)),
              "unsharded": best_of(lambda: one.search(queries, k))}
        merge_ms = cuda_ms(torch, lambda: merge_candidates(mesh, [D] * SH_SHARDS,
                                                           [I] * SH_SHARDS, k), 20)
        line = ""
        if name == "bf16":
            # bench.py's gate: value-recall@10 >= 0.999 at two bf16 ulps
            # against the f64 oracle, on the first 65,536 rows (a gid mask)
            sub_n, sub_q = min(65536, n), 64
            _, Im = sh.search(queries[:sub_q], 10, row_mask=np.arange(n) < sub_n)
            check((Im < sub_n).all(), "sharded dense bf16: the gid mask let a row through")
            sub = sh.reconstruct_batch(np.arange(sub_n))
            qs = topk_mod.l2_normalize(queries[:sub_q].to(bf)).float().cpu().numpy()
            rec = topk_mod.value_recall_at_k(Im, qs, sub, 10, rel_tol=BF16_TOL)
            check(rec >= 0.999, f"sharded dense bf16: value-recall@10 {rec}")
            line = f"; value-recall@10 {rec} vs the f64 oracle (gate 0.999)"
        out[name] = {"search_ms": ms, "merge_ms": merge_ms, "max_abs_err": err,
                     "launches": counts}
        print(f"  (b) dense {name} {n} x {d}, {q_n} queries k={k}: sharded search "
              f"{ms['sharded']:.2f} ms, DenseIndex {ms['unsharded']:.2f} ms (best of 3, host "
              f"clock); merge {merge_ms:.3f} ms (CUDA events, {SH_SHARDS} x [{q_n}, {k}]); "
              f"launches {counts}; vs DenseIndex max_abs_err {err:.3g}{line} {smi()} [{card}]")
        del one, sh
        torch.cuda.empty_cache()
    return total, out


def shard_plain_stage1(torch, idx, j, qn):
    """Shard j's stage-1 scores [q, fill] f32 through the kernels' plain
    versions, on its own codes (what its stage 1 ranks)."""
    from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed

    f, bf = int(idx._fill[idx._local[j]]), torch.bfloat16
    codes, scales = idx._encode(qn)
    if idx.stage1 == "packed":
        q = torch.nn.functional.pad(codes, (0, idx.bits_pad - idx.n_bits))
        used = -(-f // idx.block_rows) * (idx.block_rows // 32)
        s, _ = packed.packed_scores_with_bucket_max_ref(q, idx._codes[j][:used], f, None, bf)
        return s[:, :f].float()
    if idx.prefilter == "int8x8":
        s, _ = mips_int8.scores_with_bucket_max_int8_ref(codes, idx._codes[j][:f],
                                                         idx._scales[j][:f], score_dtype=bf)
        return s.float() * scales[:, None]
    s, _ = mips.scores_with_bucket_max_ref(codes, idx._codes[j][:f], score_dtype=bf)
    return s.float()


def sharded_twostage(torch, topk_mod, mesh, dev, card):
    """(c) ShardedTwoStageIndex at 2^20 x 1600 bf16, pool 128 per shard, in
    five tiers: each shard's pool against its plain stage 1, the top-k
    against the f64 re-rank of the shards' pools, planted rows top-1."""
    from sessionsimilaritysearch_tpu_torch.index.twostage import ShardedTwoStageIndex
    from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq, fit_pca
    from sessionsimilaritysearch_tpu_torch.parallel.collectives import shard_pool

    n, d, q_n, k, pool = SH_ROWS, SH_DIM, SH_Q, SH_K, SH_POOL
    g = torch.Generator(device=dev).manual_seed(23)
    rows = unit_rows(torch, g, n, d, dev)
    planted = torch.arange(q_n, device=dev) * (n // q_n) + 7
    noise = torch.randn(q_n, d, generator=g, device=dev)
    queries = rows[planted].float() + 0.4843 * noise / noise.norm(dim=1, keepdim=True)
    qn = topk_mod.l2_normalize(queries)
    qb = qn.to(torch.bfloat16).double()  # the re-rank's queries (bf16, as in JAX)
    sample = rows[:SH_FIT_ROWS].float().cpu().numpy()
    projectors = {"itq": fit_itq(sample, 250), "pca": fit_pca(sample, 64)}
    total, out, errs = dict(NO_LAUNCHES), {}, []
    for prefilter, stage1, n_bits in SH_TIERS:
        name = f"{prefilter}/{stage1}" + (f"/{n_bits}" if n_bits else "")
        idx = ShardedTwoStageIndex(d, n, mesh, prefilter=prefilter, stage1=stage1,
                                   projector=projectors.get(prefilter), n_bits=n_bits or 256,
                                   pool=pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, n, 1 << 16):
            idx.add(rows[lo: lo + (1 << 16)])
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        (D, I), counts = counted(torch, lambda: idx.search(queries, k))
        want = scaled(expected_variant(prefilter, stage1, n_bits), SH_SHARDS)
        check(counts == want, f"sharded two-stage {name}: launches {counts}, want {want}")
        total = add_counts(total, counts)
        codes, scales = idx._encode(qn)
        if stage1 == "packed":
            codes = torch.nn.functional.pad(codes, (0, idx.bits_pad - idx.n_bits))
        kw = dict(packed_bits=idx.n_bits if stage1 == "packed" else None, q_code_scales=scales)

        def pools():
            return [shard_pool(codes, idx._codes[j], pool, int(idx._fill[s]),
                               code_scales=None if idx._scales is None else idx._scales[j],
                               **kw) for j, s in enumerate(idx._local)]

        cands, best = pools(), []
        for j, cand in enumerate(cands):
            plain = shard_plain_stage1(torch, idx, j, qn)
            got = torch.gather(plain, 1, cand)
            s1 = topk_mod.value_recall_from_scores(
                got.cpu().numpy(), torch.topk(plain, pool, dim=1).values.cpu().numpy(),
                (BF16_TOL * plain.abs().amax(dim=1)).cpu().numpy())
            check(s1 == 1.0, f"sharded two-stage {name} shard {j}: stage-1 value recall {s1}")
            best.append(torch.cat([torch.topk(torch.bmm(
                idx._buf[j][cand[lo: lo + 128]].double(), qb[lo: lo + 128, :, None])[..., 0],
                k, dim=1).values for lo in range(0, q_n, 128)]))
            del plain
        best = torch.topk(torch.cat(best, dim=1), k, dim=1).values.cpu().numpy()
        err = float(np.abs(D - best).max())
        check(err <= 1e-5, f"sharded two-stage {name}: top-{k} vs the f64 re-rank of the "
              f"shards' pools {err}")
        hits = float((I[:, 0] == planted.cpu().numpy()).mean())
        check(hits == 1.0, f"sharded two-stage {name}: planted rows at top-1 {hits}")
        errs.append(err)
        s1_ms = cuda_ms(torch, pools, 3)
        rr_ms = cuda_ms(torch, lambda: [topk_mod.rerank_topk(qn.to(torch.bfloat16), idx._buf[j],
                                                              c, k)
                                        for j, c in enumerate(cands)], 3)
        total_ms = best_of(lambda: idx.search(queries, k))
        out[name] = {"fill_s": fill_s, "launches": counts, "stage1_ms": s1_ms,
                     "rerank_ms": rr_ms, "total_ms": total_ms}
        print(f"  (c) two-stage {name} {n} x {d} pool {pool}/shard: search {total_ms:.2f} ms (best of "
              f"3); stage 1 {s1_ms:.3f} ms, re-rank {rr_ms:.3f} ms over {SH_SHARDS} shards "
              f"(CUDA events); fill {fill_s:.2f} s; launches {counts}; stage-1 value recall "
              f"1.0 per shard, top-{k} vs f64 re-rank {err:.3g}, planted top-1 {hits} "
              f"{smi()} [{card}]")
        del idx
        torch.cuda.empty_cache()
    del rows
    torch.cuda.empty_cache()
    return total, out, max(errs)


def sharded_binary(torch, mesh, dev, card):
    """(d) ShardedBinaryIndex at 2^20 x 250 bits, sign and packed: the
    distances equal the plain f32 product's and BinaryIndex's."""
    from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
    from sessionsimilaritysearch_tpu_torch.index.sharded_binary import ShardedBinaryIndex

    n, bits, q_n, k = SH_ROWS, SH_BITS, SH_Q, SH_K
    g = torch.Generator(device=dev).manual_seed(29)
    codes = random_signs(torch, g, n, bits, dev)
    q = codes[torch.arange(q_n, device=dev) * (n // q_n)].clone()
    q[:, :40] = -q[:, :40]  # 40 bits from a stored code
    # the plain version: exact +-1 products in f32, 256 queries at a time
    plain = torch.cat([torch.topk(((bits - q[lo: lo + 256].float() @ codes.float().T) / 2),
                                  k, dim=1, largest=False).values
                       for lo in range(0, q_n, 256)]).to(torch.int32)
    total, out = dict(NO_LAUNCHES), {}
    for mode, want in (("sign", {"k1": SH_SHARDS, "k1_cp": SH_SHARDS}),
                       ("packed", {"k4": SH_SHARDS})):
        sh = ShardedBinaryIndex(bits, n, mesh, mode=mode)
        one = BinaryIndex(bits, n, mode, device=dev)
        for lo in range(0, n, 1 << 16):
            sh.add(codes[lo: lo + (1 << 16)])
            one.add(codes[lo: lo + (1 << 16)])
        (D, I), counts = counted(torch, lambda: sh.search(q, k, out="device"))
        check(counts == {**NO_LAUNCHES, **want}, f"sharded binary {mode}: launches {counts}")
        total = add_counts(total, counts)
        check(torch.equal(D, plain), f"sharded binary {mode}: distances differ from plain")
        check(torch.equal(D, one.search_device(q, k)[0]),
              f"sharded binary {mode}: distances differ from BinaryIndex's")
        mine = ((bits - (q.float()[:, None, :] * codes[I.clamp(min=0)].float()).sum(-1)) / 2)
        check(torch.equal(mine.to(torch.int32), D), f"sharded binary {mode}: an id's distance")
        ms = {"sharded": best_of(lambda: sh.search(q, k)),
              "unsharded": best_of(lambda: one.search(q, k))}
        out[mode] = {"search_ms": ms, "launches": counts}
        print(f"  (d) binary {mode} {n} x {bits} bits, {q_n} queries k={k}: sharded search "
              f"{ms['sharded']:.2f} ms, BinaryIndex {ms['unsharded']:.2f} ms (best of 3); "
              f"launches {counts}; distances equal the plain product's and BinaryIndex's "
              f"{smi()} [{card}]")
        del sh, one
        torch.cuda.empty_cache()
    return total, out


def sharded_nccl(torch, mesh, dev, card):
    """(e) A world-1 process group over NCCL (TCP rendezvous on localhost):
    a bf16 ShardedDenseIndex on global_mesh() whose merge all-gathers CUDA
    tensors, against the same index on the in-process mesh."""
    import socket

    import torch.distributed as dist

    from sessionsimilaritysearch_tpu_torch.index.sharded import ShardedDenseIndex
    from sessionsimilaritysearch_tpu_torch.parallel import multihost
    from sessionsimilaritysearch_tpu_torch.parallel.collectives import merge_candidates

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port_no = sock.getsockname()[1]
    sock.close()
    multihost.initialize_distributed(f"localhost:{port_no}", 1, 0)
    gathered = []
    all_gather = dist.all_gather

    def spy(out, t, *a, **kw):
        gathered.append(t.device.type)
        return all_gather(out, t, *a, **kw)

    try:
        gm = multihost.global_mesh(local_devices=[dev] * SH_SHARDS)
        check(gm.distributed and gm.world == 1, f"nccl: global mesh {gm}")
        bf, n, d, k = torch.bfloat16, SH_NCCL_ROWS, SH_DIM, SH_K
        a = ShardedDenseIndex(d, n, gm, dtype=bf, score_dtype=bf)
        b = ShardedDenseIndex(d, n, mesh, dtype=bf, score_dtype=bf)
        g = torch.Generator(device=dev).manual_seed(31)
        fill_both(torch, g, a, b, n, d, dev)
        queries = torch.randn(SH_Q, d, generator=g, device=dev)
        dist.all_gather = spy
        try:
            (D, I), counts = counted(torch, lambda: a.search(queries, k, out="device"))
        finally:
            dist.all_gather = all_gather
        check(gathered == [dev.type] * 2,
              f"nccl: the merge's all-gathers ran on {gathered}, want two on {dev.type} tensors")
        Dl, Il = b.search(queries, k, out="device")
        check(torch.equal(D, Dl) and torch.equal(I, Il),
              "nccl: the NCCL merge's top-k differs from the in-process mesh's")
        gather_ms = cuda_ms(torch, lambda: merge_candidates(gm, [D] * SH_SHARDS,
                                                            [I] * SH_SHARDS, k), 20)
        local_ms = cuda_ms(torch, lambda: merge_candidates(mesh, [D] * SH_SHARDS,
                                                           [I] * SH_SHARDS, k), 20)
        print(f"  (e) NCCL world 1 ({dist.get_backend()}): {n} x {d} bf16, {SH_Q} queries "
              f"k={k}: top-k equal to the in-process mesh's; merge with the all-gather "
              f"{gather_ms:.3f} ms, without {local_ms:.3f} ms (CUDA events); launches "
              f"{counts} [{card}]")
    finally:
        dist.destroy_process_group()
    return counts, {"merge_with_all_gather_ms": gather_ms, "merge_in_process_ms": local_ms}


def phase_sharded(torch, topk_mod, dev, parts, card):
    """Phase 9c: sharded serving as four shards on the one card."""
    from sessionsimilaritysearch_tpu_torch.parallel import create_mesh

    mesh = create_mesh(devices=[dev] * SH_SHARDS)
    print(f"sharded serving: {mesh}; four shards on one card measure the sharding's "
          f"overhead (launches per shard, the merge), not scale-out [{card}]")
    engine_counts, engine = sharded_engine(torch, topk_mod, mesh, dev, parts, card)
    dense_counts, dense = sharded_dense(torch, topk_mod, mesh, dev, card)
    tier_counts, tiers, tier_err = sharded_twostage(torch, topk_mod, mesh, dev, card)
    bin_counts, binary = sharded_binary(torch, mesh, dev, card)
    nccl_counts, nccl = sharded_nccl(torch, mesh, dev, card)
    paths = {"sharded_engine": engine_counts, "sharded_dense": dense_counts,
             "sharded_twostage": tier_counts, "sharded_binary": bin_counts,
             "sharded_nccl": nccl_counts}
    return paths, {"engine": engine, "dense": dense, "twostage": tiers, "binary": binary,
                   "nccl": nccl}, max(tier_err, engine["max_abs_err"])


# phase 8b: data-parallel training as a world-1 NCCL group at Config() width
DP_WARM, DP_TIMED = 3, 20  # warm-up and timed steps, each of the two steps
DP_BATCHES = 4  # distinct batch-50 graphs the timed steps cycle through
DP_MIN_ROWS = 8192  # shard_params: both Config() tables (391,572 and 30,522 rows) shard
DP_PROFILED = 3  # steps of each under torch.profiler
# the data-parallel step against the one-process step (tests/test_torch_
# data_parallel.py's bounds): loss and metrics, each gradient leaf after the
# clip (of the largest |gradient|), the BatchNorm statistics
DP_METRIC_RTOL, DP_GRAD_REL, DP_GRAD_RTOL, DP_BN_RTOL, DP_BN_ATOL = 1e-5, 2e-5, 1e-4, 1e-5, 1e-6
DP_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")


def dp_spy(torch):
    """Wrap the collectives the data-parallel step calls so that each call
    records (name, the device type of its tensor); returns the record and
    the function that puts the originals back."""
    import torch.distributed as dist

    seen, saved = [], {name: getattr(dist, name) for name in DP_COLLECTIVES}

    def wrap(name, fn):
        def spy(*args, **kw):
            seen.append((name, args[0].device.type))
            return fn(*args, **kw)
        return spy

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    return seen, lambda: [setattr(dist, n, f) for n, f in saved.items()]


# the dry run's kernels against their plain versions on its own tensors,
# relative to the largest plain score: K1 f32 (3xTF32) 1e-5, K2's bf16
# scores two bf16 ulps; the +-1 codes' dots (K1 bf16, K4) are exact integers
DRY_F32_TOL = 1e-5


def dryrun_kernel_pairs(torch, kept, dev):
    """Every kernel call of the dry run's searches, remade on the indexes
    and queries it kept (``dryrun_multichip(keep=)``), beside its plain
    version on the same inputs: (kernel, q x rows x d, (scores, bucket
    maxes), the plain (scores, bucket maxes), the bound on their largest
    |difference|)."""
    from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize
    from sessionsimilaritysearch_tpu_torch.parallel.collectives import _used_packed_rows

    bf, out = torch.bfloat16, []

    def pair(name, fn, ref, args, kw, rel):
        got, want = fn(*args, **kw), ref(*args, **kw)
        shape = "x".join(str(int(n)) for n in tuple(got[0].shape) + (args[0].shape[1],))
        scores = want[0].float()
        out.append((name, shape, got, want,
                    rel * float(scores[torch.isfinite(scores)].abs().max())))

    # ShardedDenseIndex (f32 rows, 'cos'): K1 per chunk of chunk_size rows
    idx, rows = kept["dense"]
    q = torch.as_tensor(rows, device=dev).to(idx.dtype)
    q = (l2_normalize(q) if idx.metric == "cos" else q).to(idx.dtype).contiguous()
    for j, s in enumerate(idx._local):
        f = int(idx._fill[s])
        for base in range(0, f, idx.chunk_size):
            chunk = idx._buf[j][base: min(base + idx.chunk_size, f)]
            pair("K1 f32", mips.scores_with_bucket_max, mips.scores_with_bucket_max_ref,
                 (q, chunk), {"score_dtype": idx.score_dtype}, DRY_F32_TOL)
    # ShardedTwoStageIndex stage 1 per shard: K1 bf16 on the binary codes,
    # K2 on the int8x8 codes, K4 on the packed codes
    for what in ("binary prefilter", "int8x8", "packed"):
        ts, rows = kept[what]
        qn = l2_normalize(torch.as_tensor(rows, device=dev, dtype=torch.float32))
        codes, scales = ts._encode(qn)
        for j, s in enumerate(ts._local):
            f = int(ts._fill[s])
            if ts.stage1 == "packed":
                qp = torch.nn.functional.pad(codes, (0, ts.bits_pad - ts.n_bits)).to(bf)
                pair("K4", packed.packed_scores_with_bucket_max,
                     packed.packed_scores_with_bucket_max_ref,
                     (qp.contiguous(), ts._codes[j][:_used_packed_rows(f)], f, None, bf), {}, 0)
            elif ts.prefilter == "int8x8":
                pair("K2", mips_int8.scores_with_bucket_max_int8,
                     mips_int8.scores_with_bucket_max_int8_ref,
                     (codes.contiguous(), ts._codes[j][:f], ts._scales[j][:f]),
                     {"score_dtype": bf}, BF16_TOL)
            else:
                pair("K1 bf16", mips.scores_with_bucket_max, mips.scores_with_bucket_max_ref,
                     (codes.to(bf).contiguous(), ts._codes[j][:f]), {"score_dtype": bf}, 0)
    # ShardedBinaryIndex (sign): K1 bf16 on the +-1 rows
    sb, signs = kept["binary"]
    qs = torch.where(torch.as_tensor(signs, device=dev) > 0, 1.0, -1.0).to(bf).contiguous()
    for j, s in enumerate(sb._local):
        pair("K1 bf16", mips.scores_with_bucket_max, mips.scores_with_bucket_max_ref,
             (qs, sb._buf[j][: int(sb._fill[s])]), {"score_dtype": bf}, 0)
    return out


def phase_data_parallel(torch, dev, card):
    """Phase 8b: the data-parallel pretrain step (item 8b) in a world-1
    process group over NCCL, at Config() width and batch 50, with both
    tables row-sharded into one range (shard_params(min_rows=8192)):
    against the one-process step on the same weights and draws, each timed;
    the sharded train state saved and restored; then
    dryrun_multichip(1, device='cuda'), whose retrieval runs K1, K2 and K4.
    Returns the dry run's launch counts and a summary."""
    import socket

    import torch.distributed as dist

    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.data import build_graph_batch
    from sessionsimilaritysearch_tpu_torch.dryrun import dryrun_multichip
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.parallel import multihost, shard_batch, shard_params
    from sessionsimilaritysearch_tpu_torch.parallel.sharding import row_shards
    from sessionsimilaritysearch_tpu_torch.training import pretrain as tp
    from sessionsimilaritysearch_tpu_torch.utils.checkpoint import (
        load_sharded_state_tree,
        restore_sharded,
        save_sharded,
        sharded_state_tree,
    )

    torch.cuda.empty_cache()
    cfg = port.Config()
    B = cfg.batch_size
    tok = port.get_tokenizer(cfg.vocab_size)
    gen = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=3)
    sessions = [d for d in gen.dataset(2 * B * DP_BATCHES) if has_product(d)]
    hosts = [build_graph_batch(sessions[i * B:(i + 1) * B], tok, cfg.dims,
                               ignore_query=cfg.ignore_query) for i in range(DP_BATCHES)]
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port_no = sock.getsockname()[1]
    sock.close()
    multihost.initialize_distributed(f"localhost:{port_no}", 1, 0)
    try:
        mesh = multihost.global_mesh(local_devices=[dev])
        check(mesh.distributed and mesh.world == 1, f"data parallel: global mesh {mesh}")

        def build():
            return tp.create_pretrain_state(cfg, dev, torch.Generator(device=dev).manual_seed(0))

        t0 = time.perf_counter()
        one_model, one = build()
        dp_model, dp = build()
        shard_params(dp, mesh, min_rows=DP_MIN_ROWS)
        build_s = time.perf_counter() - t0
        shards = {n: (s.start, s.stop, s.rows) for n, s in row_shards(dp_model).items()}
        check(shards == {"target_asin_embedding.weight": (0, cfg.asin_num, cfg.asin_num),
                         "encoder.query_node_embedder.tok_emb.weight":
                             (0, cfg.vocab_size, cfg.vocab_size)},
              f"data parallel: row shards {shards}")
        one_step = tp.make_train_step(one_model)
        dp_step = tp.make_train_step(dp_model, mesh=mesh)
        one_graphs = [to_device(h, dev) for h in hosts]
        dp_graphs = [shard_batch(h, mesh) for h in hosts]

        # 1. one step of each on the same batch and draws
        draws = one_model.draw(one_graphs[0], torch.Generator(device=dev).manual_seed(5))
        _, want = one_step(one, one_graphs[0], draws=draws)
        seen, unspy = dp_spy(torch)
        try:
            _, got = dp_step(dp, dp_graphs[0], draws=draws)
            torch.cuda.synchronize()
        finally:
            unspy()
        kinds = sorted({name for name, _ in seen})
        check(kinds == sorted(DP_COLLECTIVES) and {t for _, t in seen} == {dev.type},
              f"data parallel: the step's collectives ran as {sorted(set(seen))}, want each "
              f"of {DP_COLLECTIVES} on {dev.type} tensors")
        metric_rel = max(abs(float(got[k]) - float(want[k])) / abs(float(want[k])) for k in want)
        check(set(got) == set(want) and metric_rel <= DP_METRIC_RTOL,
              f"data parallel: metrics rel {metric_rel} (bound {DP_METRIC_RTOL})")
        named = dict(dp_model.named_parameters())
        bound = DP_GRAD_REL * max(float(p.grad.abs().max()) for p in one_model.parameters())
        grad_err = 0.0
        for n, p in one_model.named_parameters():
            err = (named[n].grad - p.grad).abs() - DP_GRAD_RTOL * p.grad.abs()
            grad_err = max(grad_err, float(err.max()))
        check(grad_err <= bound, f"data parallel: a gradient leaf off by {grad_err} "
              f"(bound {bound})")
        bufs = dict(dp_model.named_buffers())
        bn_err = max(float(((bufs[n] - b).abs() - DP_BN_RTOL * b.abs()).max())
                     for n, b in one_model.named_buffers())
        check(bn_err <= DP_BN_ATOL, f"data parallel: BatchNorm statistics off by {bn_err}")
        print(f"data parallel (8b) [{card}]: world-1 NCCL group ({dist.get_backend()}), "
              f"Config() batch {B}, both tables row-sharded into one range; two states "
              f"built in {build_s:.2f} s; one step against the one-process step on the same "
              f"weights and draws: loss {float(got['loss']):.9g} vs {float(want['loss']):.9g}, "
              f"metrics rel {metric_rel:.3g} (bound {DP_METRIC_RTOL}), gradients within "
              f"{grad_err:.3g} of the bound {bound:.3g}, BatchNorm within {bn_err:.3g}; "
              f"{len(seen)} collectives a step, all on {dev.type} tensors "
              f"({', '.join(f'{k} x{sum(1 for n, _ in seen if n == k)}' for k in kinds)})")

        # 2. the cost of the data-parallel machinery at world 1
        def run(step, state, graphs, n):
            return pretrain_steps(torch, step, state, [(graphs[i % DP_BATCHES], {})
                                                       for i in range(n)])

        run(one_step, one, one_graphs, DP_WARM)
        run(dp_step, dp, dp_graphs, DP_WARM)
        ms = {"one_process": [], "data_parallel": []}
        losses = []
        for name in ("one_process", "data_parallel", "data_parallel", "one_process"):
            step, state, graphs = ((one_step, one, one_graphs) if name == "one_process"
                                   else (dp_step, dp, dp_graphs))
            ls, t = run(step, state, graphs, DP_TIMED // 2)
            ms[name] += t
            losses += ls
        check(all(np.isfinite(losses)), "data parallel: non-finite losses")
        times = {k: {"median": percentile(v, 50), "p90": percentile(v, 90),
                     "sessions_per_s": B / percentile(v, 50) * 1e3} for k, v in ms.items()}
        print(f"  steps [{card}] ({DP_TIMED} each after {DP_WARM} warm-up, in rounds of "
              f"{DP_TIMED // 2}, host clock around a synchronized step): " + "; ".join(
                  f"{k} median {v['median']:.2f} ms, p90 {v['p90']:.2f} "
                  f"({v['sessions_per_s']:.0f} sessions/s)" for k, v in times.items())
              + f" {smi()}")
        # where the difference goes: each step's record_function spans under
        # torch.profiler (the data-parallel step adds `gradient all-reduce`)
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        names = PRE_SPANS + ("gradient all-reduce",)
        spans = {}
        for name, step, state, graphs in (("one_process", one_step, one, one_graphs),
                                          ("data_parallel", dp_step, dp, dp_graphs)):
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(step, state, graphs, DP_PROFILED)
            spans[name] = span_device_ms(torch, prof, names, DP_PROFILED)
            busy = sum(spans[name]["device"].values())
            print(f"    {name} under torch.profiler ({DP_PROFILED} steps) [{card}]: device "
                  f"busy {busy:.2f} ms a step; " + ", ".join(
                      f"{k} {v:.3f}" for k, v in spans[name]["device"].items() if v))

        # 3. the sharded train state: save, restore into a fresh state, a step
        with tempfile.TemporaryDirectory() as d:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_sharded(d, sharded_state_tree(dp))
            write_s = time.perf_counter() - t0
            n_bytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            n_files = len(os.listdir(d))
            d1 = dp_model.draw(dp_graphs[1], torch.Generator(device=dev).manual_seed(6))
            _, want = dp_step(dp, dp_graphs[1], draws=d1)
            back_model, back = build()
            shard_params(back, mesh, min_rows=DP_MIN_ROWS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            load_sharded_state_tree(back, restore_sharded(d, sharded_state_tree(back)))
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
        _, got = tp.make_train_step(back_model, mesh=mesh)(back, dp_graphs[1], draws=d1)
        resume_rel = max(abs(float(got[k]) - float(want[k])) / abs(float(want[k])) for k in want)
        check(back.step == dp.step and resume_rel <= 1e-6,
              f"data parallel: the step after restore_sharded differs (rel {resume_rel})")
        print(f"  save_sharded / restore_sharded [{card}]: {n_bytes / 1e6:.1f} MB in {n_files} "
              f"files, write {write_s:.2f} s, read into a fresh sharded state {read_s:.2f} s; "
              f"the next step's loss and metrics vs the uninterrupted run rel {resume_rel:.3g} "
              f"(bound 1e-6)")
        del one_model, one, dp_model, dp, back_model, back, one_graphs, dp_graphs
        torch.cuda.empty_cache()

        # 4. the dry run's twin in this group: its retrieval through K1, K2, K4
        kept = {}
        t0 = time.perf_counter()
        out, counts = counted(torch, lambda: dryrun_multichip(1, device="cuda", keep=kept))
        dry_s = time.perf_counter() - t0
        check(counts["k1"] > 0 and counts["k2"] > 0 and counts["k4"] > 0,
              f"data parallel: the dry run's launches {counts} (want K1, K2 and K4)")
        check(counts["k1_cp"] == 0, f"data parallel: the dry run launched cp_async {counts}")
        # each of those kernels against its plain version at the dry run's
        # shapes, on its own tensors (outside the counted run)
        dry_errs = {}
        for name, shape, got, want, bound in dryrun_kernel_pairs(torch, kept, dev):
            # slots past the fill are -inf on both sides
            err = max(float(torch.where(g == w, 0.0, (g.float() - w.float()).abs()).max())
                      for g, w in zip(got, want))
            check(err <= bound, f"data parallel: the dry run's {name} [{shape}] differs from "
                  f"its plain version by {err} (bound {bound})")
            e = dry_errs.setdefault(name, {"calls": 0, "max_abs_err": 0.0, "shapes": []})
            e["calls"] += 1
            e["max_abs_err"] = max(e["max_abs_err"], err)
            if shape not in e["shapes"]:
                e["shapes"].append(shape)
        check(set(dry_errs) == {"K1 f32", "K1 bf16", "K2", "K4"},
              f"data parallel: the dry run's kernels checked {sorted(dry_errs)}")
        del kept
        print(f"  dryrun_multichip(1, 'cuda') [{card}]: loss {out['loss']:.6f}, every "
              f"retrieval check passed in {dry_s:.2f} s; launches {counts}; its kernels "
              f"against their plain versions on its own tensors (scores and bucket maxes, "
              f"q x rows x d): " + "; ".join(
                  f"{k} {v['calls']} calls at {', '.join(v['shapes'])} max_abs_err "
                  f"{v['max_abs_err']:.3g}" for k, v in dry_errs.items()))
    finally:
        dist.destroy_process_group()
    summary = {"steps_ms": times, "spans_device_ms": {k: v["device"] for k, v in spans.items()},
               "checkpoint": {"mb": n_bytes / 1e6, "files": n_files,
                                                 "write_s": write_s, "read_s": read_s},
               "metric_rel": metric_rel, "dryrun_s": dry_s, "dryrun_kernels": dry_errs}
    print(f"data parallel summary: {json.dumps(summary)}")
    return counts, summary


def int8_case(torch, mips_int8, g, q_n, n, d, dev):
    """Seeded int8 codes and scales: unit rows quantized per row."""
    codes = torch.empty(n, d, dtype=torch.int8, device=dev)
    scales = torch.empty(n, dtype=torch.float32, device=dev)
    for s in range(0, n, 1 << 16):
        r = torch.randn(min(1 << 16, n - s), d, generator=g, device=dev)
        codes[s: s + len(r)], scales[s: s + len(r)] = mips_int8.quantize_rows_int8(
            r / r.norm(dim=1, keepdim=True))
    q = torch.randn(q_n, d, generator=g, device=dev)
    q_codes, _ = mips_int8.quantize_rows_int8(q / q.norm(dim=1, keepdim=True))
    return q_codes, codes, scales


def k2_tile(torch, lib, mips, q, c, sc, sd, dev):
    """One launch of K2's tile variant (csrc/scores_bmax_int8.cu) straight
    through its C entry point, to time it on rows where the wrapper runs the
    wgmma variant. No penalty, every row valid."""
    m, n = q.shape[0], c.shape[0]
    scores = torch.empty(m, n, dtype=sd, device=dev)
    bmax = torch.empty(m, -(-n // 128), device=dev)
    mips._cuda_call(lib.sss_scores_bmax_int8, "scores_bmax_int8", dev, q.data_ptr(),
                    c.data_ptr(), sc.data_ptr(), None, scores.data_ptr(), bmax.data_ptr(),
                    m, n, q.shape[1], n, int(sd == torch.bfloat16))
    return scores, bmax


def phase_int8_kernel(torch, dev):
    from sessionsimilaritysearch_tpu_torch.ops import _build, mips, mips_int8

    lib = _build.load_library()
    g = torch.Generator(device=dev).manual_seed(6)
    out = {"err": 0.0, "tile": {}}
    # d=200 is no TMA stride (the tile variant); d=208 ends in a zero-filled
    # half K slice (the wgmma variant)
    for d, variant in ((200, "tile"), (208, "wgmma")):
        for sd in (torch.float32, torch.bfloat16):
            q, c, sc = int8_case(torch, mips_int8, g, 37, 5003, d, dev)
            pen = torch.where(torch.rand(5003, generator=g, device=dev) < 0.1,
                              float("-inf"), 0.0)
            check(mips_int8.k2_variant(dev.type, d, (q.data_ptr(), c.data_ptr(),
                                                     sc.data_ptr())) == variant,
                  f"int8 ragged d={d}: not the {variant} variant")
            l0, w0 = mips_int8.launch_count, mips_int8.wgmma_launch_count
            s, bm = mips_int8.scores_with_bucket_max_int8(q, c, sc, 4037, pen, sd)
            check((mips_int8.launch_count - l0, mips_int8.wgmma_launch_count - w0)
                  == (1, int(variant == "wgmma")),
                  f"int8 ragged d={d}: the {variant} variant was not the one launched")
            s_ref, bm_ref = mips_int8.scores_with_bucket_max_int8_ref(q, c, sc, 4037, pen, sd)
            # exact int32 dots on both sides, then the same two f32 roundings
            check(torch.equal(s, s_ref), f"int8 ragged d={d} {sd}: scores differ")
            check(torch.equal(bm, bm_ref), f"int8 ragged d={d} {sd}: bmax differs")
            ms = cuda_ms(torch, lambda: mips_int8.scores_with_bucket_max_int8(
                q, c, sc, 4037, pen, sd), 20)
            plain_ms = cuda_ms(torch, lambda: mips_int8.scores_with_bucket_max_int8_ref(
                q, c, sc, 4037, pen, sd), 20)
            if variant == "tile":
                out["tile"][f"q37_n5003_d200_{str(sd)[6:]}"] = {"ms": ms, "plain_ms": plain_ms}
            print(f"int8 kernel ragged q=37 n=5003 d={d} {str(sd)[6:]} scores ({variant} "
                  f"variant; valid_count 4037, 10% masked): kernel {ms:.4f} ms {smi()}, "
                  f"plain {plain_ms:.4f} ms; scores and bmax equal")

    q_n, n, d = 1024, 1 << 20, 1600
    q, c, sc = int8_case(torch, mips_int8, g, q_n, n, d, dev)
    check(mips_int8.k2_variant(dev.type, d, (q.data_ptr(), c.data_ptr(), sc.data_ptr()))
          == "wgmma", "int8 bench point: not the wgmma variant")
    for sd in (torch.bfloat16, torch.float32):
        w0 = mips_int8.wgmma_launch_count
        ms = cuda_ms(torch, lambda: mips_int8.scores_with_bucket_max_int8(
            q, c, sc, score_dtype=sd), 5)
        state = smi()
        check(mips_int8.wgmma_launch_count - w0 == 6,
              "int8 bench point: the wgmma variant did not run")
        tile_ms = cuda_ms(torch, lambda: k2_tile(torch, lib, mips, q, c, sc, sd, dev), 5)
        tile_state = smi()
        plain_ms = cuda_ms(torch, lambda: mips_int8.scores_with_bucket_max_int8_ref(
            q, c, sc, score_dtype=sd), 2)
        s_ref, bm_ref = mips_int8.scores_with_bucket_max_int8_ref(q, c, sc, score_dtype=sd)
        s, bm = mips_int8.scores_with_bucket_max_int8(q, c, sc, score_dtype=sd)
        check(torch.equal(s, s_ref), f"int8 bench point {sd}: scores differ")
        check(torch.equal(bm, bm_ref), f"int8 bench point {sd}: bmax differs")
        del s, bm
        s, bm = k2_tile(torch, lib, mips, q, c, sc, sd, dev)
        check(torch.equal(s, s_ref) and torch.equal(bm, bm_ref),
              f"int8 bench point {sd}: the tile variant differs")
        del s, s_ref, bm, bm_ref
        tops = 2 * q_n * n * d / (ms * 1e-3) / 1e12
        name = str(sd)[6:]
        print(f"int8 kernel bench point q={q_n} n={n} d={d} int8 -> {name} scores: wgmma "
              f"variant {ms:.3f} ms {state} ({tops:.1f} TOP/s), tile variant "
              f"{tile_ms:.3f} ms {tile_state}, plain {plain_ms:.3f} ms; scores and bmax "
              f"equal (both variants)")
        out[name] = {"ms": ms, "plain_ms": plain_ms}
        out["tile"][f"q1024_n1048576_d1600_{name}"] = {"ms": tile_ms}
    # the library yardstick: torch._int_mm of the same codes, int32 out
    lib_ms = cuda_ms(torch, lambda: torch._int_mm(q, c.T), 5)
    print(f"int8 bench point: torch._int_mm (int32 out) {lib_ms:.3f} ms {smi()}")
    del q, c, sc
    torch.cuda.empty_cache()
    # the main path (the int8x8 engine) stores f32 scores
    out.update(out.pop("float32"), library_ms=lib_ms,
               **bound_ms(q_n * d + n * d + n * 4 + q_n * n * 4 + q_n * (n // 128) * 4,
                          2 * q_n * n * d, PEAK_INT8))
    return out


def oracle_topk(torch, q, rows_of, n, k, step=1 << 16):
    """f64 top-k values of q [m, d] against n rows, ``rows_of(lo, hi)``
    giving rows [lo, hi) in f64, 65,536 at a time."""
    best = None
    for lo in range(0, n, step):
        s = q @ rows_of(lo, min(lo + step, n)).T
        best = s if best is None else torch.cat([best, s], dim=1)
        best = torch.topk(best, k, dim=1).values
    return best


def profile(torch, fn, calls=3):
    """torch.profiler around ``calls`` synchronized calls of ``fn``: (host
    ms per call, device-busy ms per call, the largest device times per call
    by kernel). The busy time sums the device time of every kernel on the
    card's one stream; the operators that launched them are left out, so
    nothing counts twice."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    rows = device_rows(torch, prof, calls)
    return wall, sum(t for _, t, _ in rows), rows[:10]


def phase_int8_index(torch, topk_mod, dev):
    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
    from sessionsimilaritysearch_tpu_torch.ops import mips_int8
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    n, d, q_n, k = 1 << 20, 1600, 1024, 100
    g = torch.Generator(device=dev).manual_seed(7)
    idx = {m: DenseIndex(d, n, device=dev, quantize=m) for m in ("int8x8", "int8")}
    t0 = time.perf_counter()
    for s in range(0, n, 1 << 16):
        r = torch.randn(min(1 << 16, n - s), d, generator=g, device=dev)
        for i in idx.values():
            i.add(r)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    x8 = idx["int8x8"]
    planted = torch.arange(q_n, device=dev) * (n // q_n) + 7
    # cosine ~0.9 to the planted row (as stored, dequantized) plus noise
    rows = x8._buf[planted].float() * x8._scales[planted][:, None]
    noise = torch.randn(q_n, d, generator=g, device=dev)
    queries = (rows / rows.norm(dim=1, keepdim=True)
               + 0.4843 * noise / noise.norm(dim=1, keepdim=True))

    res = {}
    for name, i in idx.items():
        i.search(queries, k)  # warm-up
        mips_int8.launch_count = mips_int8.wgmma_launch_count = 0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            D, I = i.search(queries, k)  # numpy: includes the sync
            times.append(time.perf_counter() - t0)
        check(np.isfinite(D).all() and (np.diff(D, axis=1) <= 0).all(),
              f"{name} index: scores not finite and descending")
        hits = float((I[:, 0] == planted.cpu().numpy()).mean())
        check(hits == 1.0, f"{name} index: planted rows at top-1 {hits}")
        res[name] = {"best": min(times), "launches": mips_int8.launch_count,
                     "wgmma": mips_int8.wgmma_launch_count, "I": I, "hits": hits}
    chunks = -(-n // x8.chunk_size)
    r8 = res["int8x8"]
    check(r8["launches"] == r8["wgmma"] == 3 * chunks,
          f"int8x8 index: {r8['launches']} K2 launches ({r8['wgmma']} wgmma) in 3 "
          f"searches of {chunks} chunks")
    check(res["int8"]["launches"] == 0, "int8 index: the bf16 x int8 scan launched K2")

    # value-recall@10 of int8x8 against the f64 oracle over the dequantized
    # rows and the dequantized query codes (what the index ranks exactly)
    qb = l2_normalize(queries.bfloat16()).bfloat16()
    q_codes, q_scales = mips_int8.quantize_rows_int8(qb)
    q_deq = q_codes.double() * q_scales.double()[:, None]

    def deq(lo, hi):
        return x8._buf[lo:hi].double() * x8._scales[lo:hi].double()[:, None]

    oracle = oracle_topk(torch, q_deq, deq, n, 10)
    I8 = torch.from_numpy(r8["I"][:, :10]).to(dev)
    got = (q_deq[:, None, :] * (x8._buf[I8].double()
                                * x8._scales[I8].double()[..., None])).sum(-1)
    rec = topk_mod.value_recall_from_scores(
        got.cpu().numpy(), oracle.cpu().numpy(), 1e-5 * oracle[:, 0].abs().cpu().numpy())
    check(rec >= 0.999, f"int8x8 index: value-recall@10 {rec}")

    # K2 against its plain version on one chunk as search() passes it
    chunk = slice(0, x8.chunk_size)
    w0 = mips_int8.wgmma_launch_count
    s, bm = mips_int8.scores_with_bucket_max_int8(q_codes, x8._buf[chunk],
                                                  x8._scales[chunk])
    check(mips_int8.wgmma_launch_count == w0 + 1, "int8x8 index chunk: not the wgmma K2")
    s_ref, bm_ref = mips_int8.scores_with_bucket_max_int8_ref(q_codes, x8._buf[chunk],
                                                              x8._scales[chunk])
    check(torch.equal(s, s_ref) and torch.equal(bm, bm_ref),
          "int8x8 index chunk: K2 differs from its plain version")
    del s, s_ref
    for name, r in res.items():
        print(f"{name} index 2^20 x {d} (fill both {fill_s:.2f} s): search {q_n} queries "
              f"k={k} {r['best'] * 1e3:.1f} ms best of 3 ({q_n / r['best']:.0f} QPS), "
              f"{r['launches']} K2 launches ({r['wgmma']} wgmma variant) in 3 searches; "
              f"planted top-1 {r['hits']}")
    print(f"int8x8 index: value-recall@10 {rec} against the f64 oracle over the "
          f"dequantized rows; one {x8.chunk_size}-row chunk: the wgmma K2's scores and "
          f"bmax equal its plain version's")
    # where the int8x8 search's time goes; a diagnostic: a profiler that
    # cannot trace the card is reported, not fatal
    try:
        wall, busy, top = profile(torch, lambda: x8.search(queries, k))
        print(f"int8x8 search profile (torch.profiler, 3 calls): {wall:.2f} ms a call on "
              f"the host clock, device busy {busy:.2f} ms "
              f"({100 * (1 - busy / wall):.1f}% idle)")
        for key, t, count in top:
            print(f"  {t:8.3f} ms  x{count:<4d} {key[:90]}")
    except Exception as e:  # noqa: BLE001 - diagnostic output only
        print(f"int8x8 search profile: not measured ({type(e).__name__}: {e})")
    del idx, x8
    torch.cuda.empty_cache()


def phase_int8_engine(torch, dev, parts):
    import sessionsimilaritysearch_tpu_torch as port
    from sessionsimilaritysearch_tpu_torch.ops import mips_int8
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    cfg, tok, enc, data, _ = parts
    eng = port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,
                                   capacity=65536, device=dev, quantize="int8x8")
    # count the path's launches from ingest on
    mips_int8.launch_count = mips_int8.wgmma_launch_count = 0
    t0 = time.perf_counter()
    eng.add_sessions(data)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    D, I = eng.search(data[:256], k=100)
    search_s = time.perf_counter() - t0
    launches, wgmma = mips_int8.launch_count, mips_int8.wgmma_launch_count
    idx = eng.index
    check(idx.ntotal == len(data), f"int8x8 engine: ntotal {idx.ntotal}")
    check(D.shape == (256, 100) and np.isfinite(D).all(), "int8x8 engine: bad result")
    chunks = -(-idx.ntotal // idx.chunk_size)
    check(launches == wgmma == chunks,
          f"int8x8 engine: {launches} K2 launches ({wgmma} wgmma) for {chunks} chunk(s)")
    # a session's own row: its stored codes and its query codes each carry a
    # rounding error of norm <= sqrt(d) * step / 2 (step = the row's scale);
    # with unit rows the score is off 1.0 by at most their sum and product,
    # plus the bf16 rounding of the query (2^-8 relative)
    qb = l2_normalize(eng.embed(data[:256], out="device").bfloat16()).bfloat16()
    q_codes, q_scales = mips_int8.quantize_rows_int8(qb)
    e = np.sqrt(cfg.session_emb_dim) / 2 * float(
        torch.maximum(q_scales.max(), idx._scales[: idx.ntotal].max()))
    tol = 2 * e + e * e + 2.0**-8
    top1_err = float(np.abs(D[:, 0] - 1.0).max())
    check(top1_err <= tol, f"int8x8 engine: top-1 score off 1.0 by {top1_err} > {tol}")

    # K2 against its plain version on the engine's own codes
    codes, scales = idx._buf[: idx.ntotal], idx._scales[: idx.ntotal]
    check(mips_int8.k2_variant(dev.type, codes.shape[1], (
        q_codes.data_ptr(), codes.data_ptr(), scales.data_ptr())) == "wgmma",
        "int8x8 engine: its codes do not take the wgmma K2")
    ms = cuda_ms(torch, lambda: mips_int8.scores_with_bucket_max_int8(
        q_codes, codes, scales), 10)
    plain_ms = cuda_ms(torch, lambda: mips_int8.scores_with_bucket_max_int8_ref(
        q_codes, codes, scales), 10)
    s, bm = mips_int8.scores_with_bucket_max_int8(q_codes, codes, scales)
    s_ref, bm_ref = mips_int8.scores_with_bucket_max_int8_ref(q_codes, codes, scales)
    check(torch.equal(s, s_ref) and torch.equal(bm, bm_ref),
          "int8x8 engine: K2 differs from its plain version on the engine's codes")
    print(f"int8x8 engine Config(): ingest {len(data)} sessions {ingest_s:.2f} s "
          f"({len(data) / ingest_s:.0f} sessions/s); search 256 k=100 "
          f"{search_s * 1e3:.1f} ms; top-1 |score-1| max {top1_err:.3g} (tolerance "
          f"{tol:.3g}), self-hit ids {float((I[:, 0] == np.arange(256)).mean()):.4f}; "
          f"K2 launches {launches} ({wgmma} wgmma variant); engine's codes q=256 "
          f"n={idx.ntotal}, kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms, scores and "
          f"bmax equal")
    print(f"int8x8 engine stats: {json.dumps(eng.stats())}")
    return launches, wgmma


def phase_bucket_max(torch, topk_mod, dev):
    from sessionsimilaritysearch_tpu_torch.ops import mips

    g = torch.Generator(device=dev).manual_seed(8)
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(37, 200, generator=g, device=dev).to(dt)
        c = torch.randn(5003, 200, generator=g, device=dev).to(dt)
        bm = mips.scores_bucket_max(q, c, 4037)
        bm_ref = mips.scores_bucket_max_ref(q, c, 4037)
        check(torch.equal(torch.isneginf(bm), torch.isneginf(bm_ref)),
              f"bucket max ragged {dt}: -inf pattern differs")
        fin = torch.isfinite(bm_ref)
        err = (bm[fin] - bm_ref[fin]).abs().max().item()
        # f32 sums of 200 terms (|s| ~ 15) in another order
        check(err <= 1e-3, f"bucket max ragged {dt}: max_abs_err {err}")
        errs.append(err)
        print(f"bucket max kernel ragged q=37 n=5003 d=200 {str(dt)[6:]} (valid_count "
              f"4037): bmax max_abs_err {err:.3g}")

    n, d, k = 1 << 20, 1600, 100
    corpus = unit_rows(torch, g, n, d, dev)
    queries = unit_rows(torch, g, 64, d, dev)
    out = {}
    mips.bucket_max_launch_count = 0  # K3's path: bucketed_topk at q=8 and 64
    results = {q_n: mips.bucketed_topk(queries[:q_n], corpus, k) for q_n in (8, 64)}
    launches = mips.bucket_max_launch_count
    for q_n, (v, i) in results.items():
        qs = queries[:q_n]
        v_ex, _ = mips.exact_topk(qs, corpus, k, score_dtype=torch.float32)
        rel = ((v - v_ex).abs() / v_ex.abs()).max().item()
        # the two differ only in the order of f32 sums over unit rows
        check(rel <= 1e-5, f"bucketed_topk q={q_n}: values off exact_topk by {rel}")
        exact, _ = mips.scores_with_bucket_max_ref(qs, corpus)
        rec = value_recall(torch, topk_mod, exact, i[:, :10], 10, 1e-5)
        check(rec == 1.0, f"bucketed_topk q={q_n}: value-recall@10 {rec}")
        bm = mips.scores_bucket_max(qs, corpus)
        bm_err = (bm - mips.bucket_max(exact)).abs().max().item()
        check(bm_err <= 1e-5, f"bucket max q={q_n}: bmax max_abs_err {bm_err}")
        errs.append(bm_err)
        del exact
        out[q_n] = {
            "ms": cuda_ms(torch, lambda: mips.scores_bucket_max(qs, corpus), 10),
            "plain_ms": cuda_ms(torch, lambda: mips.scores_bucket_max_ref(qs, corpus), 3),
            "topk_ms": cuda_ms(torch, lambda: mips.bucketed_topk(qs, corpus, k), 5),
            "exact_ms": cuda_ms(torch, lambda: mips.exact_topk(
                qs, corpus, k, score_dtype=torch.float32), 5),
        }
        print(f"bucket max kernel q={q_n} n={n} d={d} bf16: kernel {out[q_n]['ms']:.3f} ms "
              f"{smi()}, "
              f"plain {out[q_n]['plain_ms']:.3f} ms; bucketed_topk k={k} "
              f"{out[q_n]['topk_ms']:.3f} ms vs exact_topk (K1, f32 scores) "
              f"{out[q_n]['exact_ms']:.3f} ms; values within {rel:.3g} relative, "
              f"value-recall@10 {rec}, bmax max_abs_err {bm_err:.3g}")
    check(launches == 2, f"bucketed_topk: {launches} K3 launches in 2 calls")
    del corpus, queries
    torch.cuda.empty_cache()
    q_n = 64
    return {"err": max(errs), "launches": launches, "ms": out[q_n]["ms"],
            "plain_ms": out[q_n]["plain_ms"], "library_ms": None,
            **bound_ms(q_n * d * 2 + n * d * 2 + q_n * (n // 128) * 4,
                       2 * q_n * n * d, PEAK_BF16)}


def phase_scores_matmul(torch, dev):
    from sessionsimilaritysearch_tpu_torch.ops import _build, mips

    lib = _build.load_library()
    g = torch.Generator(device=dev).manual_seed(9)
    errs, tiles, cp = [], {}, {}
    for dt, dd, variant in ((torch.float32, 200, "wgmma"), (torch.float32, 202, "tile"),
                            (torch.bfloat16, 200, "wgmma"), (torch.bfloat16, 250, "cp_async")):
        q = torch.randn(37, dd, generator=g, device=dev).to(dt)
        c = torch.randn(5003, dd, generator=g, device=dev).to(dt)
        check(mips.k6_variant(dev.type, dt, dd, (q.data_ptr(), c.data_ptr())) == variant,
              f"scores matmul ragged {dt} d={dd}: not the {variant} variant")
        counts = (mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count,
                  mips.scores_matmul_cp_async_launch_count)
        s = mips.scores_matmul(q, c)
        check((mips.scores_matmul_launch_count - counts[0],
               mips.scores_matmul_wgmma_launch_count - counts[1],
               mips.scores_matmul_cp_async_launch_count - counts[2])
              == (1, int(variant == "wgmma"), int(variant == "cp_async")),
              f"scores matmul ragged {dt} d={dd}: the {variant} variant was not the one "
              "launched")
        err = (s - mips.scores_matmul_ref(q, c)).abs().max().item()
        # f32 sums of 200 terms (|s| ~ 15) in another order
        check(err <= 1e-3, f"scores matmul ragged {dt} d={dd}: max_abs_err {err}")
        errs.append(err)
        ms = cuda_ms(torch, lambda: mips.scores_matmul(q, c), 20)
        plain_ms = cuda_ms(torch, lambda: mips.scores_matmul_ref(q, c), 20)
        if variant == "tile":
            tiles[f"q37_n5003_d{dd}_float32"] = {"ms": ms, "plain_ms": plain_ms}
        if variant == "cp_async":
            cp[f"q37_n5003_d{dd}_bfloat16"] = {"ms": ms, "plain_ms": plain_ms,
                                               "max_abs_err": err}
        print(f"scores matmul kernel ragged q=37 n=5003 d={dd} {str(dt)[6:]} ({variant} "
              f"variant): kernel {ms:.4f} ms {smi()}, plain {plain_ms:.4f} ms; "
              f"max_abs_err {err:.3g}")

    q_n, n, d = 1024, 1 << 20, 1600
    corpus = unit_rows(torch, g, n, d, dev)
    queries = unit_rows(torch, g, q_n, d, dev)
    check(mips.k6_variant(dev.type, queries.dtype, d, (queries.data_ptr(), corpus.data_ptr()))
          == "wgmma", "scores matmul bench point: not the wgmma variant")
    # K6's path: its own entry point
    mips.scores_matmul_launch_count = mips.scores_matmul_wgmma_launch_count = 0
    s = mips.scores_matmul(queries, corpus)
    launches, wgmma = mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count
    check(launches == wgmma == 1,
          f"scores matmul bench point: {launches} launches, {wgmma} wgmma")
    s_ref = mips.scores_matmul_ref(queries, corpus)
    err = max((s[r: r + 64] - s_ref[r: r + 64]).abs().max().item()
              for r in range(0, q_n, 64))
    # unit rows, |s| <= 1: f32 sums of exact bf16 products in another order
    check(err <= 1e-5, f"scores matmul bench point: max_abs_err {err}")
    del s
    s = tile_loop(torch, lib, mips, queries, corpus, dev, bmax=False)
    tile_err = max((s[r: r + 64] - s_ref[r: r + 64]).abs().max().item()
                   for r in range(0, q_n, 64))
    check(tile_err <= 1e-5, f"scores matmul bench point: tile loop max_abs_err {tile_err}")
    errs.append(err)
    del s, s_ref
    ms = cuda_ms(torch, lambda: mips.scores_matmul(queries, corpus), 5)
    state = smi()
    tile_ms = cuda_ms(torch, lambda: tile_loop(torch, lib, mips, queries, corpus, dev,
                                               bmax=False), 5)
    tile_state = smi()
    tiles["q1024_n1048576_d1600_bfloat16"] = {"ms": tile_ms}
    plain_ms = cuda_ms(torch, lambda: mips.scores_matmul_ref(queries, corpus), 3)
    # the library yardstick: one cuBLAS GEMM with f32 output where torch
    # takes out_dtype, else the bf16-output matmul
    try:
        lib_ms = cuda_ms(torch, lambda: torch.mm(queries, corpus.T,
                                                 out_dtype=torch.float32), 5)
        yardstick = "torch.mm(out_dtype=float32)"
    except (TypeError, RuntimeError):
        lib_ms = cuda_ms(torch, lambda: torch.matmul(queries, corpus.T), 5)
        yardstick = "torch.matmul, bf16 output"
    tflops = 2 * q_n * n * d / (ms * 1e-3) / 1e12
    print(f"scores matmul kernel bench point q={q_n} n={n} d={d} bf16 -> f32: wgmma "
          f"variant {ms:.3f} ms {state} ({tflops:.1f} TFLOP/s), tile loop {tile_ms:.3f} ms "
          f"{tile_state}, plain {plain_ms:.3f} ms, {yardstick} {lib_ms:.3f} ms {smi()}; "
          f"max_abs_err {err:.3g} (tile loop {tile_err:.3g}); {launches} launch, {wgmma} "
          f"wgmma")
    del corpus, queries
    torch.cuda.empty_cache()
    f32 = phase_scores_matmul_f32(torch, mips, lib, dev, g)
    tiles["q1024_n1048576_d1600_float32"] = {"ms": f32.pop("tile_ms")}
    return {"err": max(errs), "launches": launches, "wgmma_launches": wgmma, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "tile": tiles, "f32_wgmma": f32,
            "cp_async": cp,
            **bound_ms(q_n * d * 2 + n * d * 2 + q_n * n * 4, 2 * q_n * n * d, PEAK_BF16)}


def phase_scores_matmul_f32(torch, mips, lib, dev, g):
    """K6's f32 wgmma variant at q=1024, n=2^20, d=1600 f32 -> f32 on unit
    rows, on its own path (one scores_matmul call), against its plain
    version and timed in the same rounds as the tile loop and SGEMM."""
    q_n, n, d = 1024, 1 << 20, 1600
    corpus = unit_rows_f32(torch, g, n, d, dev)
    queries = unit_rows_f32(torch, g, q_n, d, dev)
    check(mips.k6_variant(dev.type, queries.dtype, d, (queries.data_ptr(), corpus.data_ptr()))
          == "wgmma", "scores matmul f32 bench point: not the wgmma variant")
    l0, w0 = mips.scores_matmul_launch_count, mips.scores_matmul_wgmma_launch_count
    s = mips.scores_matmul(queries, corpus)
    launches = mips.scores_matmul_launch_count - l0
    wgmma = mips.scores_matmul_wgmma_launch_count - w0
    check(launches == wgmma == 1,
          f"scores matmul f32 bench point: {launches} launches, {wgmma} wgmma")
    s_ref = mips.scores_matmul_ref(queries, corpus)
    err = max((s[r: r + 64] - s_ref[r: r + 64]).abs().max().item() for r in range(0, q_n, 64))
    # unit rows, |s| <= 1: f32-accurate sums in another order
    check(err <= 1e-5, f"scores matmul f32 bench point: max_abs_err {err}")
    del s
    s = tile_loop(torch, lib, mips, queries, corpus, dev, bmax=False)
    tile_err = max((s[r: r + 64] - s_ref[r: r + 64]).abs().max().item()
                   for r in range(0, q_n, 64))
    check(tile_err <= 1e-5, f"scores matmul f32 bench point: tile loop max_abs_err {tile_err}")
    del s, s_ref
    med, rounds, state = rounds_in_turns(torch, {
        "wgmma": (lambda: mips.scores_matmul(queries, corpus), 3),
        "tile": (lambda: tile_loop(torch, lib, mips, queries, corpus, dev, bmax=False), 1),
        "sgemm": (lambda: torch.matmul(queries, corpus.T), 2)})
    ms, tile_ms, lib_ms = med["wgmma"], med["tile"], med["sgemm"]
    plain_ms = cuda_ms(torch, lambda: mips.scores_matmul_ref(queries, corpus), 2)
    bound = f32_bound(q_n, n, d, bmax=False)
    print(f"scores matmul kernel bench point q={q_n} n={n} d={d} f32 -> f32, three rounds in "
          f"turns {state}: f32 wgmma variant {rounds['wgmma']} ms, tile loop "
          f"{rounds['tile']} ms, torch.matmul f32 (cuBLAS SGEMM, TF32 off) "
          f"{rounds['sgemm']} ms; plain {plain_ms:.3f} ms; bound {bound['bound_ms']:.3f} ms "
          f"({bound['bound_by']}; three tf32 passes {bound['design_bound_ms']:.3f}); "
          f"max_abs_err {err:.3g} (tile loop {tile_err:.3g}); {launches} launch, {wgmma} wgmma")
    del corpus, queries
    torch.cuda.empty_cache()
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "tile_ms": tile_ms, **bound}


# phase 15: the serving soak at Config() width (asin_num 50,000, embed batch
# 1,024), one card and four shards on it: (path, rows, mixed batches, shards,
# expire_every); the sharded run's 12 batches would reach no expiry at 8. The
# rows are cut to keep phases 15-17 near 150 s (generating a session takes
# ~0.5 ms of host time); the full-size soak is the module's own default run
SOAK_RUNS = (("serving_soak", 16384, 24, 0, 8), ("sharded_serving_soak", 8192, 12, 4, 4))
SOAK_K, SOAK_BATCH = 100, 256  # k, and the queries and sessions of a mixed batch
SOAK_REMOVE_EVERY = 6
SOAK_ROW_SLACK = 16  # content-keyed removal may sweep rows that duplicate a victim


def soak_kernel_check(torch, mips, topk_mod, keep, sharded):
    """K1 against its plain version on the soak engine's own inputs, as
    phase 4b: the last mixed batch's queries embedded, cast and normalized
    in bf16 as search() takes them, and each shard's filled bf16 rows (the
    restored corpus); then search()'s top-k against the plain top-k. The
    bound is two bf16 ulps of the unit scale (``BF16_TOL``); the f32 sums
    of exact bf16 products in another order differ by ~1e-5 over these
    millions of scores. Returns the largest error."""
    eng, queries = keep["engine"], keep["queries"]
    idx = eng.index
    bf = torch.bfloat16
    qb = topk_mod.l2_normalize(eng.embed(queries, out="device").to(bf)).to(bf).contiguous()
    bufs = ([b[: int(f)] for b, f in zip(idx._buf, idx._fill)] if sharded
            else [idx._buf[: idx.ntotal]])
    sd = idx.score_dtype
    err, vals = 0.0, []
    for corpus in bufs:
        s, bm = mips.scores_with_bucket_max(qb.to(corpus.device), corpus, score_dtype=sd)
        s_ref, bm_ref = mips.scores_with_bucket_max_ref(qb.to(corpus.device), corpus,
                                                        score_dtype=sd)
        err = max(err, (bm - bm_ref).abs().max().item(),
                  (s.float() - s_ref.float()).abs().max().item())
        vals.append(mips.select_topk(s_ref, bm_ref, SOAK_K)[0])
    v_ref = torch.cat(vals, dim=1).topk(SOAK_K, dim=1).values.cpu().numpy()
    D, _ = eng.search(queries, k=SOAK_K)
    err = max(err, float(np.abs(D - v_ref).max()))
    check(err <= BF16_TOL, f"serving soak: K1 vs plain on the engine's inputs max_abs_err {err}")
    return err


def phase_serving_soak(torch, mips, topk_mod, dev, card):
    """Phase 15: examples/serving_soak.py's run_soak at Config() width on the
    card, then over four shards on it; dryrun.entry() at full width."""
    import types

    from sessionsimilaritysearch_tpu_torch.examples import serving_soak

    paths, summary, err = {}, {}, 0.0
    for name, rows, batches, shards, expire_every in SOAK_RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            args = types.SimpleNamespace(
                rows=rows, asin_num=50_000, fill_chunk=8192, batches=batches,
                qbatch=SOAK_BATCH, ibatch=SOAK_BATCH, k=SOAK_K, embed_batch=1024,
                remove_every=SOAK_REMOVE_EVERY, expire_every=expire_every, mesh=shards,
                workdir=tmp, device="cuda", tiny=False, tiny_model=False, out=None)
            keep = {}
            t0 = time.perf_counter()
            r, counts = counted(torch, lambda: serving_soak.run_soak(args, keep))
            wall = time.perf_counter() - t0
        k1 = r["k1_launches"]
        want_rows = rows + batches * SOAK_BATCH - r["removed_rows"] - r["expired_rows"]
        snap = r["snapshot"] or {}
        check(snap.get("search_identical_after_restore") is True and snap["save_s"] is not None,
              f"{name}: snapshot {snap}")
        check(r["removed_rows"] > 0 and r["expired_rows"] > 0
              and set(r["ops_ms"]) >= {"ingest", "remove", "expire", "snapshot_capture"},
              f"{name}: verbs {r['ops_ms']} removed {r['removed_rows']} expired "
              f"{r['expired_rows']}")
        check(abs(r["ntotal_end"] - want_rows) <= SOAK_ROW_SLACK
              and r["engine_stats"]["pending"] == 0,
              f"{name}: rows {r['ntotal_end']} (want {want_rows}), {r['engine_stats']}")
        per_search = [shards or 1]
        check(r["kernel_path_flat"] and k1["wgmma"] == k1["total"] > 0
              and k1["per_search"] == per_search,
              f"{name}: K1 launches {k1} (each search {per_search}, all the bf16 wgmma "
              "variant)")
        check(counts["k1"] == counts["k1_wgmma"] >= k1["total"]
              and counts["k1_cp"] == counts["k2"] == counts["k4"] == 0,
              f"{name}: launches over the run {counts}")
        check(r["memory_flat"] is True, f"{name}: device memory {r['memory_allocated_after_warmup']}"
              f" -> {r['memory_allocated_end']}")
        e = soak_kernel_check(torch, mips, topk_mod, keep, bool(shards))
        err = max(err, e)
        del keep
        torch.cuda.empty_cache()
        s, dsave = r["search"], r["search_during_save"] or {}
        ops = {k: v["mean"] for k, v in r["ops_ms"].items()}
        print(f"  {name} ({rows} rows, {batches} mixed batches of {SOAK_BATCH}, "
              f"{shards or 1} shard(s)) [{card}]: search p50 {s['p50_ms']} ms, p99 "
              f"{s['p99_ms']} ms, {s['qps']} QPS; during the save p50 {dsave.get('p50_ms')} ms "
              f"over {dsave.get('batches')} batches; sustained mixed {r['sustained_mixed_qps']} "
              f"QPS; ingest {r['ingest_sessions_per_s']} sessions/s; ops mean ms "
              f"{json.dumps(ops)}; save {snap['save_s']} s, restore {snap['restore_s']} s; "
              f"removed {r['removed_rows']}, expired {r['expired_rows']}, rows "
              f"{r['ntotal_end']}; K1 {k1}; memory {r['memory_allocated_after_warmup']} -> "
              f"{r['memory_allocated_end']} B; K1 vs plain max_abs_err {e:.3g}; setup "
              f"{r['setup_s']} s, fill {r['fill_s']} s, run {wall:.1f} s")
        paths[name] = counts
        summary[name] = {key: r[key] for key in (
            "rows", "capacity", "ntotal_end", "setup_s", "fill_s", "ingest_sessions_per_s",
            "mixed_batches", "mixed_wall_s", "sustained_mixed_qps", "search",
            "search_during_save", "ops_ms", "removed_rows", "expired_rows", "snapshot",
            "k1_launches", "memory_allocated_after_warmup", "memory_allocated_end")}

    # dryrun.entry() at full width: the card against the CPU on the same weights
    import copy

    from sessionsimilaritysearch_tpu_torch import dryrun

    os.environ["SSS_ENTRY_FULL"] = "1"
    try:
        fn, (enc, graph) = dryrun.entry()
    finally:
        os.environ.pop("SSS_ENTRY_FULL", None)
    on_card = fn(enc, graph)
    entry_ms = cuda_ms(torch, lambda: fn(enc, graph), 10)
    cpu_enc = copy.deepcopy(enc).cpu()
    on_cpu = fn(cpu_enc, type(graph)(*(t.cpu() for t in graph))).numpy()
    on_card = on_card.cpu().numpy()
    scale = float(np.abs(on_cpu).max())
    entry_err = float(np.abs(on_card - on_cpu).max())
    check(on_card.shape[0] == 8 and np.isfinite(on_card).all() and entry_err <= 1e-4 * scale,
          f"entry(): card vs CPU max_abs_err {entry_err} (scale {scale})")
    print(f"  dryrun.entry() Config(asin_num=50,000) [{card}]: 8 sessions -> {on_card.shape}, "
          f"{entry_ms:.2f} ms a forward (CUDA events, 10 calls); card vs CPU max_abs_err "
          f"{entry_err:.3g} of scale {scale:.3g}")
    del enc, cpu_enc
    torch.cuda.empty_cache()
    summary["entry"] = {"ms": entry_ms, "card_vs_cpu": entry_err, "scale": scale}
    return paths, summary, err


# phase 16: the campaign's crash / resume drill at Config() width
CAMPAIGN_MODULE = "sessionsimilaritysearch_tpu_torch.examples.flagship_campaign"
CAMPAIGN_ARGS = ("--sessions", "2048", "--batch-size", "256", "--epochs", "2",
                 "--ckpt-every", "4", "--log-every", "1")
CAMPAIGN_CRASH, CAMPAIGN_SEAM = 6, 4
CAMPAIGN_STEPS_PER_EPOCH = 8  # 2,048 sessions in batches of 256
CAMPAIGN_REPLAY_TOL = 1e-4


def phase_campaign(torch, dev, card):
    """Phase 16: two subprocesses of the campaign, the first ended by its
    crash drill, the second resuming; then one with no card visible."""
    import shutil

    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["PYTHONPATH"] = HERE
    root = tempfile.mkdtemp(prefix="campaign_")
    torch.cuda.empty_cache()  # room for the subprocesses on the card
    try:
        run = os.path.join(root, "run")

        def campaign(crash, out):
            argv = [sys.executable, "-m", CAMPAIGN_MODULE, *CAMPAIGN_ARGS, "--savedir", run,
                    "--out", out, "--crash-at-step", str(crash)]
            t0 = time.perf_counter()
            sub = subprocess.run(argv, cwd=root, env=env, capture_output=True, text=True,
                                 timeout=600)
            return sub, time.perf_counter() - t0

        out1, out2 = os.path.join(root, "s1.json"), os.path.join(root, "s2.json")
        first, first_s = campaign(CAMPAIGN_CRASH, out1)
        check(first.returncode == 3 and not os.path.exists(out1),
              f"campaign: the crash drill exited {first.returncode}: {first.stderr[-2000:]}")
        second, second_s = campaign(-1, out2)
        check(second.returncode == 0, f"campaign: the resume failed: {second.stderr[-2000:]}")
        with open(out2) as f:
            s = json.load(f)
        seam = {"epoch": 0, "batch_idx": CAMPAIGN_SEAM, "global_step": CAMPAIGN_SEAM}
        check(s["steps_per_epoch"] == CAMPAIGN_STEPS_PER_EPOCH
              and s["steps_total"] == 2 * s["steps_per_epoch"] and s["resume_seams"] == [seam],
              f"campaign: steps {s['steps_total']}, seams {s['resume_seams']}")
        check(s["replay_loss_max_dev"] <= CAMPAIGN_REPLAY_TOL,
              f"campaign: replayed steps' losses differ by {s['replay_loss_max_dev']}")
        steps = [c[0] for c in s["loss_curve"]]
        check(steps == list(range(1, s["steps_total"] + 1))
              and all(np.isfinite(c[1]) for c in s["loss_curve"]),
              f"campaign: loss curve {s['loss_curve']}")
        with open(os.path.join(run, "campaign_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        replayed = {e["step"]: [] for e in log if e["event"] == "loss"}
        for e in log:
            if e["event"] == "loss":
                replayed[e["step"]].append(e["loss"])
        replayed = {k: v for k, v in replayed.items() if len(v) > 1}
        check(sorted(replayed) == [5, 6], f"campaign: replayed steps {sorted(replayed)}")
        saves = [e["s"] for e in log if e["event"] == "checkpoint"]
        restore_s = [e["restore_s"] for e in log if e["event"] == "start" and e["restore_s"]]
        ckpt_mb = sum(os.path.getsize(os.path.join(run, "ckpt", f"{t}.pt"))
                      for t in ("latest", "campaign_meta")) / 2**20
        blind = subprocess.run(
            [sys.executable, "-m", CAMPAIGN_MODULE, "--savedir", os.path.join(root, "blind")],
            cwd=root, env={**env, "CUDA_VISIBLE_DEVICES": ""},
            capture_output=True, text=True, timeout=600)
        check(blind.returncode != 0 and "torch.cuda.is_available() is False" in blind.stderr,
              "campaign: a subprocess with no card visible did not refuse to run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dev_of = {k: max(v) - min(v) for k, v in replayed.items()}
    print(f"  campaign Config() (2,048 sessions, batch 256, 2 epochs, checkpoint every 4 steps) "
          f"[{card}]: crash drill exit 3 at step {CAMPAIGN_CRASH} ({first_s:.1f} s), resume from "
          f"step {CAMPAIGN_SEAM} exit 0 ({second_s:.1f} s); replayed steps' |loss difference| "
          f"{json.dumps(dev_of)} (replay_loss_max_dev {s['replay_loss_max_dev']}); median step "
          f"{s['step_ms_median_timed_window']} ms (p90 {s['step_ms_p90_timed_window']}), "
          f"{s['sustained_sessions_per_s_this_run']} sessions/s over the resumed run, "
          f"{s['flops_per_step_g']} GFLOP a step (FlopCounterMode), {s['achieved_tflops']} "
          f"TFLOP/s achieved; first step {s['first_step_s']} s; checkpoint {ckpt_mb:.1f} MB, "
          f"writes {' / '.join(f'{x:.2f}' for x in saves)} s, read "
          f"{' / '.join(f'{x:.2f}' for x in restore_s)} s; with no card visible it exits "
          f"{blind.returncode}; loss {s['loss_first10_mean']} -> {s['loss_last10_mean']}")
    return {**{k: s[k] for k in ("steps_total", "replay_loss_max_dev",
                                  "step_ms_median_timed_window", "step_ms_p90_timed_window",
                                  "sustained_sessions_per_s_this_run", "flops_per_step_g",
                                  "achieved_tflops", "first_step_s")},
            "checkpoint_mb": ckpt_mb, "save_s": saves, "restore_s": restore_s}


# phase 17: the all-heads training soak at Config() width
TSOAK_ARGS = ("--sessions", "4096", "--batch-size", "256", "--nan-step", "10")
# 16 steps an epoch, the checkpoint after step 5, the crash after 10 (the
# drill's step, the last before it, dropped); the resume trains from step 5
# over the loader's first 11 batches: 5 + 16 - 10 + 5
TSOAK_STEPS = 16


def phase_training_soak(torch, dev, card):
    """Phase 17: examples/training_soak.py's main in-process on the card."""
    import contextlib
    import io
    import shutil

    from sessionsimilaritysearch_tpu_torch.examples import training_soak

    root = tempfile.mkdtemp(prefix="tsoak_")
    try:
        out = os.path.join(root, "soak.json")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = training_soak.main([*TSOAK_ARGS, "--savedir", os.path.join(root, "run"),
                                     "--out", out])
        wall = time.perf_counter() - t0
        with open(out) as f:
            r = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    ev = {e["event"]: e for e in r["events"]}
    check(rc == 0, f"training soak: exit {rc}: {buf.getvalue()[-2000:]}")
    check(ev.get("nan_caught", {}).get("step") == 10
          and ev["nan_caught"]["finite_terms"] == []
          and ev.get("rollback_checked", {}).get("bit_exact") is True,
          f"training soak: the drill {r['events']}")
    check(r["steps_total"] == TSOAK_STEPS and all(np.isfinite(r["loss_curve_every50"])),
          f"training soak: steps {r['steps_total']}, losses {r['loss_curve_every50']}")
    print(f"  training soak Config() all heads + view ({TSOAK_ARGS[1]} sessions, batch 256, "
          f"{r['params_m']} M params) [{card}]: exit {rc}; NaN drill at step 10 caught "
          f"(every loss term non-finite) and rolled back bit for bit; resumed to step "
          f"{r['steps_total']}; step p50 {r['step_ms_p50']} ms, p90 {r['step_ms_p90']} ms, "
          f"{r['sessions_per_s']} sessions/s; {r['compile_steps_excluded']} warm-up steps "
          f"excluded; loss {r['loss_first20']} -> {r['loss_last20']}; wall {wall:.1f} s")
    return {k: r[k] for k in ("steps_total", "step_ms_p50", "step_ms_p90", "sessions_per_s",
                              "wall_s", "params_m")}


# phases 18-22: the serving-side operational scripts, each run through
# its module's main() on the card, its stdout kept apart from this log
FS_ARGS = ("--sessions", "32768", "--asin-num", "50000", "--train-steps", "20",
           "--queries", "1024", "--k", "100", "--bits", "250", "--iters", "3")
FS_MODES = ("exact_bf16", "exact_cert_bf16", "int8x8_exact", "int8x8_cert", "int8x8_approx",
            "pca64_exact", "binary_sign", "binary_approx", "twostage_pool256",
            "twostage_pool512", "twostage_itq_pool128", "twostage_itq_pool256",
            "binary_packed_itq", "twostage_packeditq_pool128")
FS_GATED = ("exact_bf16", "exact_cert_bf16", "int8x8_exact", "int8x8_cert")  # >= 0.999
FS_HAMMING = ("binary_sign", "binary_approx", "binary_packed_itq")  # 1.0, tie-aware
FS_GATE = 0.999
# one search of each mode: its kernel launches by variant (read_counts keys)
FS_TMA = {**NO_LAUNCHES, "k1": 1, "k1_wgmma": 1}
FS_CP = {**NO_LAUNCHES, "k1": 1, "k1_cp": 1}
FS_K2 = {**NO_LAUNCHES, "k2": 1, "k2_wgmma": 1}
FS_K4 = {**NO_LAUNCHES, "k4": 1}
FS_PER_SEARCH = {"exact_bf16": FS_TMA, "exact_cert_bf16": FS_TMA, "pca64_exact": FS_TMA,
                 "int8x8_exact": FS_K2, "int8x8_cert": FS_K2, "int8x8_approx": FS_K2,
                 "binary_sign": FS_CP, "binary_approx": FS_CP, "twostage_pool256": FS_CP,
                 "twostage_pool512": FS_CP, "twostage_itq_pool128": FS_CP,
                 "twostage_itq_pool256": FS_CP, "binary_packed_itq": FS_K4,
                 "twostage_packeditq_pool128": FS_K4}
FT_ARGS = ("--batch-size", "50", "--steps", "30", "--resume-steps", "10")
IB_ARGS = ("--sessions", "32768", "--train-sessions", "4096", "--epochs", "1")
IB_F32_REL = 1e-5  # K1 f32 against its plain version, of the largest plain score
MB_ARGS = ("--iters", "3")
EP_ARGS = ("--sessions", "16384")


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its stdout kept in a buffer (the scripts
    print their own reports); returns (result, the buffer's text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def pair_err(torch, got, want) -> float:
    """The largest |difference| of two kernel outputs (scores, bucket maxes)
    against the plain version's, in f32; equal values (-inf past a valid
    count included) differ by 0."""
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = max(err, torch.where(g == w, 0.0, (g - w).abs()).max().item())
    return err


def phase_flagship_serving_artifact(torch, dev, card):
    """Phase 18: examples/flagship_serving.py at Config() width, then each
    mode's one search counted by variant and each kernel held against its
    plain version on the script's own tensors."""
    from sessionsimilaritysearch_tpu_torch.examples import flagship_serving
    from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed

    keep: dict = {}
    t0 = time.perf_counter()
    (r, log), counts = counted(torch, lambda: quiet(flagship_serving.main, list(FS_ARGS),
                                                    keep=keep))
    wall = time.perf_counter() - t0
    modes = r["modes"]
    check(tuple(modes) == FS_MODES, f"flagship serving: modes {list(modes)}")
    for name in FS_GATED:
        check(modes[name]["value_recall10"] >= FS_GATE,
              f"flagship serving: {name} value_recall10 {modes[name]['value_recall10']}")
    for name in FS_HAMMING:
        check(modes[name]["value_recall10"] == 1.0,
              f"flagship serving: {name} Hamming value_recall10 {modes[name]['value_recall10']}")
    check(counts["k1"] == counts["k1_wgmma"] + counts["k1_cp"] and counts["k1_wgmma"] > 0
          and counts["k1_cp"] > 0 and counts["k2"] == counts["k2_wgmma"] > 0
          and counts["k4"] > 0, f"flagship serving: launches over the run {counts}")
    per_search = {}
    for name, (fn, q0) in keep["modes"].items():
        _, c = counted(torch, lambda: fn(q0))
        per_search[name] = c
        check(c == FS_PER_SEARCH[name],
              f"flagship serving: one {name} search launched {c}, want {FS_PER_SEARCH[name]}")
    ids = keep["ids"]
    check(np.array_equal(ids["binary_approx"], ids["binary_sign"]),
          "flagship serving: binary_approx did not return binary_sign's ids")
    f = keep["forms"]
    bf = torch.bfloat16
    n, ci_packed = f["n"], f["ci_packed"]
    pairs = {
        "k1_bf16": (mips.scores_with_bucket_max(f["queries"], f["corpus"], score_dtype=bf),
                    mips.scores_with_bucket_max_ref(f["queries"], f["corpus"], score_dtype=bf)),
        "k1_pca64": (mips.scores_with_bucket_max(f["qp"], f["cp"], score_dtype=bf),
                     mips.scores_with_bucket_max_ref(f["qp"], f["cp"], score_dtype=bf)),
        "k1_cp_simhash": (mips.scores_with_bucket_max(f["q_signs"], f["c_signs"], score_dtype=bf),
                          mips.scores_with_bucket_max_ref(f["q_signs"], f["c_signs"],
                                                          score_dtype=bf)),
        "k1_cp_itq": (mips.scores_with_bucket_max(f["qi_signs"], f["ci_signs"], score_dtype=bf),
                      mips.scores_with_bucket_max_ref(f["qi_signs"], f["ci_signs"],
                                                      score_dtype=bf)),
        "k2": (mips_int8.scores_with_bucket_max_int8(f["q8"], f["c8"], f["c_scales"],
                                                     score_dtype=bf),
               mips_int8.scores_with_bucket_max_int8_ref(f["q8"], f["c8"], f["c_scales"],
                                                         score_dtype=bf)),
        "k4": (packed.packed_scores_with_bucket_max(f["qi_pad"], ci_packed, n,
                                                    score_dtype=bf),
               packed.packed_scores_with_bucket_max_ref(f["qi_pad"], ci_packed, n,
                                                        score_dtype=bf)),
    }
    errs = {key: pair_err(torch, *pair) for key, pair in pairs.items()}
    del pairs
    bounds = {"k1_bf16": BF16_TOL, "k1_pca64": BF16_TOL, "k1_cp_simhash": 0.0,
              "k1_cp_itq": 0.0, "k2": BF16_TOL, "k4": 0.0}
    for key, err in errs.items():
        check(err <= bounds[key],
              f"flagship serving: {key} against its plain version max_abs_err {err}")
    del keep, f
    torch.cuda.empty_cache()
    for name in FS_MODES:
        m = modes[name]
        vr = {k: v for k, v in m.items() if k.startswith("value_recall10")}
        print(f"  {name:>26} [{card}]: {m['ms_per_batch']} ms, {m['qps']} QPS, "
              f"{json.dumps(vr)}, type@10 {m['ave_type_score10']}; one search "
              f"{json.dumps({k: v for k, v in per_search[name].items() if v})}")
    print(f"  flagship_serving {' '.join(FS_ARGS)} [{card}]: generate {r['gen_s']} s, train "
          f"{r['train_steps']} steps {r['train_s']} s, title table {r['title_table_s']} s, "
          f"keyword table {r['kw_table_s']} s, embed {r['embed_s']} s "
          f"({r['embed_sessions_per_s']} sessions/s), ITQ fit {r['itq_fit_s']} s; launches "
          f"{counts}; against the plain versions {json.dumps(errs)}; wall {wall:.1f} s")
    return counts, errs, {"report": r, "per_search": per_search, "errs": errs, "wall_s": wall}


def phase_flagship_train(torch, dev, card):
    """Phase 19: examples/flagship_train.py at Config(), batch 50, both
    phases, each with its resume proof; no port kernel runs."""
    import shutil

    from sessionsimilaritysearch_tpu_torch.examples import flagship_train

    root = tempfile.mkdtemp(prefix="flagship_train_")
    out, total = {}, dict(NO_LAUNCHES)
    try:
        for phase in ("pretrain", "subsession"):
            t0 = time.perf_counter()
            (s, _), counts = counted(torch, lambda: quiet(
                flagship_train.main, [*FT_ARGS, "--phase", phase, "--savedir", root]))
            wall = time.perf_counter() - t0
            steps, resume = int(FT_ARGS[3]), int(FT_ARGS[5])
            # steps * batch + batch sessions in batches of 50, the last not
            # dropped: steps + 1 batches, the loader's count
            check(s["steps"] == steps + 1,
                  f"flagship train {phase}: {s['steps']} steps, the loader yields {steps + 1}")
            check(s["resume_check"] == f"restored step {steps + 1}, continued to "
                                       f"{steps + 1 + resume}",
                  f"flagship train {phase}: {s['resume_check']}")
            check(all(np.isfinite(s[k]) for k in ("loss_first10_mean", "loss_last10_mean",
                                                   "loss_resumed10_mean")),
                  f"flagship train {phase}: losses {s}")
            check(counts == NO_LAUNCHES, f"flagship train {phase}: port kernels {counts}")
            ckpt_mb = os.path.getsize(os.path.join(root, phase, "ckpt", "latest.pt")) / 2**20
            print(f"  flagship_train --phase {phase} {' '.join(FT_ARGS)} [{card}]: "
                  f"{s['params_m']} M params, first step {s['first_step_s']} s, step p50 "
                  f"{s['step_ms_median']} ms, p90 {s['step_ms_p90']}, {s['sessions_per_s']} "
                  f"sessions/s; loss {s['loss_first10_mean']} -> {s['loss_last10_mean']}, "
                  f"resumed {s['loss_resumed10_mean']}; {s['resume_check']}; checkpoint "
                  f"{ckpt_mb:.1f} MB; wall {wall:.1f} s")
            out[phase] = {**s, "checkpoint_mb": ckpt_mb, "wall_s": wall}
            total = add_counts(total, counts)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return total, out


def phase_index_build(torch, dev, card):
    """Phase 20: examples/index_build_100k.py at its own config; every K1
    launch the f32 wgmma variant, held against its plain version on the
    index's rows and the queries."""
    from sessionsimilaritysearch_tpu_torch.examples import index_build_100k
    from sessionsimilaritysearch_tpu_torch.ops import mips
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    keep: dict = {}
    t0 = time.perf_counter()
    (s, _), counts = counted(torch, lambda: quiet(index_build_100k.main, list(IB_ARGS),
                                                  keep=keep))
    wall = time.perf_counter() - t0
    check(counts["k1"] == counts["k1_wgmma"] > 0 and counts["k1_cp"] == counts["k2"]
          == counts["k4"] == 0, f"index build: launches {counts}")
    idx, ids = keep["index"], keep["ids"]
    check(idx.dtype == torch.float32, f"index build: a {idx.dtype} index")
    # with ignore_query every search-only session embeds to one row (more
    # rows than k), so such a query can find an identical row first: every
    # query whose top-1 is not itself must find a bit-identical stored row
    misses = np.nonzero(ids[:, 0] != np.arange(len(ids)))[0]
    bad = [int(i) for i in misses if not (ids[i, 0] >= 0 and torch.equal(
        idx._buf[int(ids[i, 0])], idx._buf[int(i)]))]
    check(not bad and s["top1_score_at_self_cos"] == 1.0
          and abs(s["self_recall_at_1"] - (1.0 - len(misses) / len(ids))) < 1e-9,
          f"index build: self recall {s['self_recall_at_1']}, top-1 at the self-cosine "
          f"{s['top1_score_at_self_cos']}, top-1s that are neither the query nor an identical "
          f"row: {bad[:10]}")
    q = l2_normalize(keep["queries"].float()).contiguous()
    rows = idx._buf[: min(idx.ntotal, idx.chunk_size)]
    got = mips.scores_with_bucket_max(q, rows)
    want = mips.scores_with_bucket_max_ref(q, rows)
    err = pair_err(torch, got, want)
    scale = want[0].abs().max().item()
    check(err <= IB_F32_REL * scale,
          f"index build: K1 f32 against its plain version max_abs_err {err} (scale {scale})")
    del keep, idx, rows, got, want
    torch.cuda.empty_cache()
    print(f"  index_build_100k {' '.join(IB_ARGS)} [{card}]: self recall@1 "
          f"{s['self_recall_at_1']} ({len(misses)} queries find an identical row first), "
          f"top-1 at the self-cosine {s['top1_score_at_self_cos']}; "
          f"train {s['train_s']} s, embed {s['embed_s']} s ({s['embed_sessions_per_s']} "
          f"sessions/s, first batch {s['embed_first_batch_s']} s), build {s['index_build_s']} "
          f"s, search {s['search_s']} s ({s['qps']} QPS); launches {counts}; K1 f32 against "
          f"its plain version {err:.3g} of {scale:.3g}; wall {wall:.1f} s")
    return counts, err, {**s, "self_misses_identical_row": len(misses),
                         "k1_f32_rel_err": err / scale, "wall_s": wall}


def phase_maintenance_bench(torch, dev, card):
    """Phase 21: examples/maintenance_bench.py at its full size; every
    radius's hits against a torch f64 oracle on the stored rows, no removed
    id from the sharded index, one K1 bf16 launch a search before and after
    the removals, K1 against its plain version."""
    from sessionsimilaritysearch_tpu_torch.examples import maintenance_bench
    from sessionsimilaritysearch_tpu_torch.ops import mips
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    keep: dict = {}
    out_path = os.path.join(tempfile.gettempdir(), "maintenance_bench_smoke.json")
    t0 = time.perf_counter()
    try:
        (rec, _), counts = counted(torch, lambda: quiet(
            maintenance_bench.main, [*MB_ARGS, "--out", out_path], keep=keep))
    finally:
        if os.path.exists(out_path):
            os.remove(out_path)
    wall = time.perf_counter() - t0
    check(counts["k1"] == counts["k1_wgmma"] > 0 and counts["k1_cp"] == counts["k2"]
          == counts["k4"] == 0, f"maintenance bench: launches {counts}")
    bf = torch.bfloat16
    # the range queries as search() takes them: bf16, normalized in bf16
    rq = l2_normalize(keep["range_queries"].to(bf)).to(bf).double()
    rows = keep.pop("range_rows")
    n = rows.shape[0]
    s64 = torch.empty(rq.shape[0], n, dtype=torch.float64, device=dev)
    for s in range(0, n, 1 << 16):
        s64[:, s: s + (1 << 16)] = rq @ rows[s: s + (1 << 16)].double().T
    range_check = {}
    for name, (radius, lims, _, ids) in keep["ranges"].items():
        got = torch.zeros(rq.shape[0], n, dtype=torch.bool, device=dev)
        rows_of = np.repeat(np.arange(rq.shape[0]), np.diff(lims))
        got[torch.from_numpy(rows_of).to(dev), torch.from_numpy(ids).to(dev)] = True
        differ = got ^ (s64 >= radius)
        # scores are bf16: a row within one bf16 ulp of the radius may fall
        # on either side
        tol = 2.0**-7 * abs(radius) + 1e-5
        far = differ & ((s64 - radius).abs() > tol)
        range_check[name] = {"hits": int(got.sum()), "differ_near_radius": int(differ.sum()),
                             "differ_far": int(far.sum())}
        check(not far.any(), f"maintenance bench: range {name} hits against the f64 oracle "
                             f"{range_check[name]}")
    del s64, rows, got, differ, far
    idx, sidx, victims = keep["index"], keep["sharded"], keep["victims"]
    q = keep["queries"]
    per_search = {}
    for label, ix in (("index_after_remove", idx), ("sharded_after_remove", sidx)):
        (_, I), c = counted(torch, lambda: ix.search(q, 100))
        per_search[label] = c
        check(c == {**NO_LAUNCHES, "k1": 1, "k1_wgmma": 1},
              f"maintenance bench: one {label} search launched {c}")
    _, I = sidx.search(q, 100)
    check(not np.isin(I, victims).any(), "maintenance bench: the sharded index returned a "
                                         "removed id")
    qb = l2_normalize(q.to(bf)).to(bf).contiguous()
    err = pair_err(torch, mips.scores_with_bucket_max(qb, idx._buf[: idx.ntotal], score_dtype=bf),
                   mips.scores_with_bucket_max_ref(qb, idx._buf[: idx.ntotal], score_dtype=bf))
    check(err <= BF16_TOL, f"maintenance bench: K1 against its plain version max_abs_err {err}")
    del keep, idx, sidx
    torch.cuda.empty_cache()
    print(f"  maintenance_bench {' '.join(MB_ARGS)} (N={rec['N']}, D={rec['D']}, capacity "
          f"{rec['capacity']}) [{card}]: " + "; ".join(
              f"{k} {v['ms_per_batch']} ms ({v['qps']} QPS)" for k, v in rec.items()
              if isinstance(v, dict) and "ms_per_batch" in v))
    for name in ("easy", "moderate", "hostile"):
        v = rec[f"range_{name}"]
        print(f"    range_{name}: radius {v['radius']}, {v['mean_hits_per_query']} hits a "
              f"query, depths {v['depths']}, first {v['cold_s']} s, second {v['warm_s']} s; "
              f"against the f64 oracle {range_check[name]}")
    for key in ("merge_from", "remove_ids", "sharded_remove_ids"):
        v = rec[key]
        print(f"    {key}: {v['rows']} rows, first {v['cold_s']} s, second {v['warm_s']} s")
    print(f"    launches {counts}; one search after the removals {per_search}; K1 against its "
          f"plain version {err:.3g}; wall {wall:.1f} s")
    return counts, err, {**rec, "range_check": range_check, "wall_s": wall}


def phase_embed_probe(torch, dev, card):
    """Phase 22: examples/embed_pipeline_probe.py at Config(asin_num=50,000);
    A and B agree bit for bit, C's two indexes hold the same rows; no port
    kernel runs."""
    from sessionsimilaritysearch_tpu_torch.examples import embed_pipeline_probe

    keep: dict = {}
    t0 = time.perf_counter()
    (r, _), counts = counted(torch, lambda: quiet(embed_pipeline_probe.main, list(EP_ARGS),
                                                  keep=keep))
    wall = time.perf_counter() - t0
    check(r["parity_max_abs_diff"] == 0.0,
          f"embed probe: parity_max_abs_diff {r['parity_max_abs_diff']}")
    a, b = keep["index_device"], keep["index_np"]
    check(a.ntotal == b.ntotal == r["sessions"]
          and torch.equal(a._buf[: a.ntotal], b._buf[: b.ntotal]),
          "embed probe: C's two indexes hold different rows")
    check(counts == NO_LAUNCHES, f"embed probe: port kernels {counts}")
    del keep, a, b
    torch.cuda.empty_cache()
    print(f"  embed_pipeline_probe {' '.join(EP_ARGS)} [{card}]: A (out='np') {r['A_np_s']} s "
          f"({r['A_np_sessions_per_s']} sessions/s), B (out='device') {r['B_device_s']} s "
          f"({r['B_device_sessions_per_s']} sessions/s, {r['B_speedup_vs_A']}x), parity "
          f"{r['parity_max_abs_diff']}; C add from the device {r['C_add_device_s']} s, from "
          f"the host {r['C_add_np_s']} s; wall {wall:.1f} s")
    return counts, {**r, "wall_s": wall}


# phases 23-27: the quality scripts, each run through its module's main()
# on the card at the flagship width where it has width flags
FLAGSHIP_WIDTH = ("--gnn-nout", "800", "--gnn-nhid", "800", "--text-dim", "768",
                  "--emb-len", "200")
QP_ARGS = ("--encoder", "flagship", *FLAGSHIP_WIDTH, "--seeds", "2", "--corpus", "8192",
           "--train", "1024", "--queries", "200", "--epochs", "1", "--alpha-sweep", "0.3,0.7")
BQ_ARGS = ("--flagship", "--corpus", "8192", "--train", "1024", "--queries", "200",
           "--epochs", "1", "--ft-epochs", "2")
KP_ARGS = ("--regimes", "clustered", "--towers", "joint", *FLAGSHIP_WIDTH, "--corpus", "4096",
           "--train", "1024", "--queries", "200", "--epochs", "1")
GB_ARGS = ("--epochs", "2")
IC_ARGS = ("--epochs", "2")
QUALITY_F32 = {**NO_LAUNCHES, "k1": 1, "k1_wgmma": 1}  # one f32 dense search


def f32_search_err(torch, mips, queries, rows) -> tuple:
    """K1's f32 kernel against its plain version on a dense search's rows
    and queries (normalized as the index normalizes them): (max |diff|,
    the largest |plain score|)."""
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    q = l2_normalize(torch.as_tensor(queries).to(rows.device).float()).contiguous()
    want = mips.scores_with_bucket_max_ref(q, rows)
    err = pair_err(torch, mips.scores_with_bucket_max(q, rows), want)
    return err, want[0].abs().max().item()


def check_f32_err(err, scale, what) -> None:
    check(err <= IB_F32_REL * scale,
          f"{what}: K1 f32 against its plain version max_abs_err {err} (scale {scale})")


def in_unit(values) -> bool:
    return all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values)


def phase_quality_protocol(torch, dev, card):
    """Phase 23: examples/quality_protocol.py, the flagship encoder at its
    published width; one f32 wgmma K1 launch a seed, each held against its
    plain version on the seed's index rows and queries."""
    from sessionsimilaritysearch_tpu_torch.examples import quality_protocol
    from sessionsimilaritysearch_tpu_torch.ops import mips

    keep: dict = {}
    t0 = time.perf_counter()
    (r, log), counts = counted(torch, lambda: quiet(quality_protocol.main, list(QP_ARGS),
                                                    keep=keep))
    wall = time.perf_counter() - t0
    seeds = int(QP_ARGS[QP_ARGS.index("--seeds") + 1])
    check(counts == scaled(QUALITY_F32, seeds), f"quality protocol: launches {counts}")
    errs = []
    for i, kept in enumerate(keep["seeds"]):
        idx = kept["index"]
        check(idx.dtype == torch.float32 and idx.dim == 1600,
              f"quality protocol: seed {i} searched a {idx.dtype} index of d={idx.dim}")
        err, scale = f32_search_err(torch, mips, kept["queries"], idx._buf[: idx.ntotal])
        check_f32_err(err, scale, f"quality protocol seed {i}")
        errs.append(err)
    systems = r["systems"]
    check(all(np.isfinite(s["mean"]) and np.isfinite(s["std"]) for s in systems.values()),
          f"quality protocol: non-finite scores {systems}")
    check(in_unit(systems["SKNN"]["per_seed"] + systems["STAN"]["per_seed"]),
          "quality protocol: SKNN or STAN outside [0, 1]")
    del keep
    torch.cuda.empty_cache()
    seed_lines = [line for line in log.splitlines() if line.startswith("seed ")]
    print(f"  quality_protocol {' '.join(QP_ARGS)} [{card}]: " + "; ".join(
        f"{name} {s['mean']:.4f} +- {s['std']:.4f}" for name, s in systems.items()))
    for line in seed_lines:
        print(f"    {line}")
    print(f"    launches {counts}; K1 f32 against its plain version {max(errs):.3g}; wall "
          f"{wall:.1f} s")
    return counts, max(errs), {"systems": systems, "seed_lines": seed_lines, "wall_s": wall}


def phase_binary_quality(torch, dev, card):
    """Phase 24: examples/binary_quality.py --flagship; the dense row one
    f32 wgmma K1 launch, each 250-bit sign row one cp_async launch, each
    held against its plain version on the script's rows and queries."""
    from sessionsimilaritysearch_tpu_torch.examples import binary_quality
    from sessionsimilaritysearch_tpu_torch.ops import mips

    keep: dict = {}
    t0 = time.perf_counter()
    (r, log), counts = counted(torch, lambda: quiet(binary_quality.main, list(BQ_ARGS),
                                                    keep=keep))
    wall = time.perf_counter() - t0
    rows = r["rows"]
    check(counts == {**NO_LAUNCHES, "k1": 1 + 4, "k1_wgmma": 1, "k1_cp": 4},
          f"binary quality: launches {counts}")
    idx = keep["index"]
    check(r["session_emb_dim"] == 1600 and r["bits"] == 250 and idx.dtype == torch.float32,
          f"binary quality: {r['session_emb_dim']}-d sessions, {r['bits']} bits, {idx.dtype}")
    err, scale = f32_search_err(torch, mips, keep["queries"], idx._buf[: idx.ntotal])
    check_f32_err(err, scale, "binary quality")
    bf = torch.bfloat16
    cp_errs = {}
    for tag, (db_c, q_c, _, _) in keep["codes"].items():
        c = torch.where(torch.as_tensor(db_c, device=dev) >= 0, 1.0, -1.0).to(bf)
        q = torch.where(torch.as_tensor(q_c, device=dev) >= 0, 1.0, -1.0).to(bf)
        check(c.shape[1] == 250 and mips.k1_variant(
            "cuda", bf, 250, (q.data_ptr(), c.data_ptr())) == "cp_async",
            f"binary quality: {tag} codes of width {c.shape[1]} do not take the cp_async variant")
        cp_errs[tag] = pair_err(torch, mips.scores_with_bucket_max(q, c, score_dtype=bf),
                                mips.scores_with_bucket_max_ref(q, c, score_dtype=bf))
        check(cp_errs[tag] == 0.0,
              f"binary quality: {tag} K1 cp_async against its plain version {cp_errs[tag]}")
    check(in_unit([v["score"] for v in rows.values()]),
          f"binary quality: a score outside [0, 1] {rows}")
    del keep, idx
    torch.cuda.empty_cache()
    print(f"  binary_quality {' '.join(BQ_ARGS)} [{card}]: spectrum participation ratio "
          f"{r['participation_ratio']:.1f}, var top10 {r['var_top10']:.3f}, top250 "
          f"{r['var_top250']:.4f}; {r['triplets']} triplets; encoder {r['encoder_train_s']:.1f}"
          f" s, hash heads {r['ft_train_s']:.1f} s (loss {r['ft_loss']:.4f}); " + "; ".join(
              f"{tag} {v['score']:.4f}" + (f" ({v['qps']:,.0f} QPS)" if v["qps"] else "")
              for tag, v in rows.items()))
    print(f"    launches {counts}; K1 f32 against its plain version {err:.3g}, cp_async "
          f"{json.dumps(cp_errs)}; wall {wall:.1f} s")
    return counts, err, max(cp_errs.values()), {**r, "wall_s": wall}


def phase_knn_pairings(torch, dev, card):
    """Phase 25: examples/knn_pairings.py, joint towers at the flagship
    width; one f32 wgmma K1 launch a pairing, each held against its plain
    version on the pairing's embeddings."""
    from sessionsimilaritysearch_tpu_torch.examples import knn_pairings
    from sessionsimilaritysearch_tpu_torch.ops import mips
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    keep: dict = {}
    t0 = time.perf_counter()
    (r, _), counts = counted(torch, lambda: quiet(knn_pairings.main, list(KP_ARGS), keep=keep))
    wall = time.perf_counter() - t0
    out = r["clustered"]
    check(counts == scaled(QUALITY_F32, 3), f"knn pairings: launches {counts}")
    errs = {}
    for name, kept in keep["clustered"].items():
        rows = l2_normalize(kept["db"].float()).contiguous()
        check(rows.shape[1] == 1600, f"knn pairings: {name} rows of width {rows.shape[1]}")
        err, scale = f32_search_err(torch, mips, kept["queries"], rows)
        check_f32_err(err, scale, f"knn pairings {name}")
        errs[name] = err
    recalls = {k: v for k, v in out.items() if k.startswith("recall_")}
    check(len(recalls) == 3 and in_unit(recalls.values()), f"knn pairings: recalls {recalls}")
    check(all(np.isfinite(out[k]) for k in ("final_loss_subsession", "final_ctv_loss")),
          f"knn pairings: losses {out}")
    del keep
    torch.cuda.empty_cache()
    print(f"  knn_pairings {' '.join(KP_ARGS)} [{card}]: {json.dumps(recalls)}; joint "
          f"training {out['train_s_subsession'] * 2:.1f} s, loss "
          f"{out['final_loss_subsession']}, ctv {out['final_ctv_loss']}; eval "
          f"{out['eval_s']} s; launches {counts}; K1 f32 against its plain version "
          f"{max(errs.values()):.3g}; wall {wall:.1f} s")
    return counts, max(errs.values()), {**out, "wall_s": wall}


def phase_catalog_benchmark(torch, dev, card, module, args, tags):
    """Phases 26 and 27: examples/generalization_benchmark.py and
    incatalog_benchmark.py at their own config; two f32 wgmma K1 launches
    (untrained, trained) at d=128, each held against its plain version."""
    import importlib

    from sessionsimilaritysearch_tpu_torch.ops import mips

    mod = importlib.import_module(f"sessionsimilaritysearch_tpu_torch.examples.{module}")
    keep: dict = {}
    t0 = time.perf_counter()
    (r, _), counts = counted(torch, lambda: quiet(mod.main, list(args), keep=keep))
    wall = time.perf_counter() - t0
    check(counts == scaled(QUALITY_F32, 2), f"{module}: launches {counts}")
    errs = []
    for kept in keep["dense"]:
        idx = kept["index"]
        check(idx.dtype == torch.float32 and idx.dim == 128,
              f"{module}: a {idx.dtype} index of d={idx.dim}")
        err, scale = f32_search_err(torch, mips, kept["queries"], idx._buf[: idx.ntotal])
        check_f32_err(err, scale, module)
        errs.append(err)
    check(in_unit(r[t] for t in tags), f"{module}: a score outside [0, 1] {r}")
    check(np.isfinite(r["loss"]), f"{module}: loss {r['loss']}")
    del keep
    torch.cuda.empty_cache()
    print(f"  {module} {' '.join(args)} [{card}]: " + ", ".join(
        f"{t} {r[t]:.3f}" for t in tags) + f"; train {r['epochs']} epochs {r['train_s']:.1f} s,"
        f" loss {r['loss']:.3f}; launches {counts}; K1 f32 against its plain version "
        f"{max(errs):.3g}; wall {wall:.1f} s")
    return counts, max(errs), {**r, "wall_s": wall}


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "sessionsimilaritysearch_tpu_torch")):
        print("chip_smoke: run it from the repository (package not found)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'unknown'}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    from sessionsimilaritysearch_tpu_torch.ops import _build, mips
    from sessionsimilaritysearch_tpu_torch.ops import topk as topk_mod

    print(f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn TF32 {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if info else 'reused'} {_build.library_path().name})")
    for line in (info or {}).get("ptxas", []):
        print(f"  {line}")
    spilled = {k: v for k, v in (info or {}).get("spills", {}).items() if v}
    check(not spilled, f"ptxas spilled registers: {spilled}")
    # e.g. every wgmma of a kernel serialized (a wgmma on a divergent path)
    check(not (info or {}).get("perf_notes"),
          f"ptxas reported a performance loss: {(info or {}).get('perf_notes')}")

    from sessionsimilaritysearch_tpu_torch import native, native_build

    native_kind = native_build.ensure_native_library()
    check(native.load() is not None,
          f"the native graph builder did not load ({native_kind} build)")
    print(f"native graph builder: loaded ({native_kind} build)")

    err_ragged, err_ragged_cp = run_phase(torch, "kernel ragged", phase_kernel_ragged,
                                          torch, mips, topk_mod, dev)
    err_bench, k1 = run_phase(torch, "kernel bench point", phase_kernel_bench,
                              torch, mips, topk_mod, dev)
    err_f32_index, f32_search_ms = run_phase(torch, "f32 index", phase_f32_index, torch,
                                             mips, topk_mod, dev)
    err_index = run_phase(torch, "index", phase_index, torch, mips, topk_mod, dev)
    launches, err_engine, f32_small, tile_small, parts, f32_rate = run_phase(
        torch, "engine", phase_engine, torch, mips, topk_mod, dev)
    card_line = card[0] if card else "unknown card"
    maint_launches = run_phase(torch, "dense maintenance", phase_dense_maintenance, torch, mips,
                               topk_mod, dev, card_line)
    verbs_launches = run_phase(torch, "engine verbs", phase_engine_verbs, torch, mips, topk_mod,
                               dev, parts, card_line)
    wgmma_launches, err_bf16_engine = run_phase(torch, "bf16 engine", phase_bf16_engine,
                                                torch, mips, topk_mod, dev, parts)
    serving_launches, err_serving = run_phase(torch, "flagship serving", phase_flagship_serving,
                                              torch, mips, topk_mod, dev, parts, card_line,
                                              f32_rate)
    pretrain_counts = run_phase(torch, "pretrain", phase_pretrain, torch, mips, dev, card_line)
    st_counts, st_model, st_eng, st_gen, st_serve = run_phase(
        torch, "session trainers", phase_session_trainers, torch, mips, dev, card_line)
    ft_counts = run_phase(torch, "fine-tune", phase_finetune, torch, dev, card_line, st_model,
                          st_eng, st_gen, st_serve)
    del st_model, st_eng
    torch.cuda.empty_cache()
    run_phase(torch, "node-level encoders", phase_node_level, torch, dev, card_line)
    cli_counts = run_phase(torch, "cli", phase_cli, torch, dev, card_line)
    err_f32, f32_bench, tile_bench = run_phase(torch, "f32 kernel", phase_f32_kernel, torch,
                                               mips, dev)
    k4, bench = run_phase(torch, "packed kernel", phase_packed_kernel, torch, dev)
    k5 = run_phase(torch, "hamming kernel", phase_hamming_kernel, torch, dev, bench)
    del bench
    sign_tile, sign_cp, sign_path, packed_1600_path = run_phase(
        torch, "binary index", phase_binary_index, torch, dev)
    bin_path = run_phase(torch, "binary maintenance", phase_binary_maintenance, torch, dev,
                         card_line)
    err_tiers, tiers = run_phase(torch, "two-stage index", phase_twostage_index, torch, dev,
                                 card_line)
    k4_launches = run_phase(torch, "two-stage engine", phase_twostage_engine,
                            torch, dev, parts)
    ts_verbs = run_phase(torch, "two-stage engine verbs", phase_twostage_engine_verbs, torch,
                         dev, parts, card_line)
    sharded_paths, sharded, err_sharded = run_phase(torch, "sharded serving", phase_sharded,
                                                    torch, topk_mod, dev, parts, card_line)
    dp_counts, dp_summary = run_phase(torch, "data parallel", phase_data_parallel, torch, dev,
                                      card_line)
    k2 = run_phase(torch, "int8 kernel", phase_int8_kernel, torch, dev)
    run_phase(torch, "int8 index", phase_int8_index, torch, topk_mod, dev)
    k2_launches, k2_wgmma = run_phase(torch, "int8x8 engine", phase_int8_engine, torch,
                                      dev, parts)
    k3 = run_phase(torch, "bucket max kernel", phase_bucket_max, torch, topk_mod, dev)
    k6 = run_phase(torch, "scores matmul kernel", phase_scores_matmul, torch, dev)
    soak_paths, soak, err_soak = run_phase(torch, "serving soak", phase_serving_soak, torch,
                                           mips, topk_mod, dev, card_line)
    campaign = run_phase(torch, "campaign", phase_campaign, torch, dev, card_line)
    training_soak = run_phase(torch, "training soak", phase_training_soak, torch, dev,
                              card_line)
    fs_counts, fs_errs, fs_summary = run_phase(
        torch, "flagship serving artifact", phase_flagship_serving_artifact, torch, dev, card_line)
    train_counts, train_summary = run_phase(torch, "flagship train", phase_flagship_train,
                                            torch, dev, card_line)
    ib_counts, ib_err, ib_summary = run_phase(torch, "index build", phase_index_build, torch,
                                              dev, card_line)
    mb_counts, mb_err, mb_summary = run_phase(torch, "maintenance bench",
                                              phase_maintenance_bench, torch, dev, card_line)
    ep_counts, ep_summary = run_phase(torch, "embed pipeline probe", phase_embed_probe, torch,
                                      dev, card_line)
    qp_counts, qp_err, qp_summary = run_phase(torch, "quality protocol", phase_quality_protocol,
                                              torch, dev, card_line)
    bq_counts, bq_err, bq_cp_err, bq_summary = run_phase(
        torch, "binary quality", phase_binary_quality, torch, dev, card_line)
    kp_counts, kp_err, kp_summary = run_phase(torch, "knn pairings", phase_knn_pairings, torch,
                                              dev, card_line)
    gb_counts, gb_err, gb_summary = run_phase(
        torch, "generalization benchmark", phase_catalog_benchmark, torch, dev, card_line,
        "generalization_benchmark", GB_ARGS, ("untrained", "trained", "SKNN", "STAN"))
    ic_counts, ic_err, ic_summary = run_phase(
        torch, "incatalog benchmark", phase_catalog_benchmark, torch, dev, card_line,
        "incatalog_benchmark", IC_ARGS,
        ("encoder untrained", "encoder trained", "SKNN", "STAN", "hybrid"))

    check(not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "sessionsimilaritysearch_tpu")
                  for m in sys.modules),
          "JAX or the JAX package was imported")
    src = "sessionsimilaritysearch_tpu_torch/csrc/"
    tpu = "sessionsimilaritysearch_tpu/ops/pallas_mips.py:"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(name, replaces, launches, err, m, source=None):
        return {"name": name, "route": "cuda", "source": src + (source or f"{name}.cu"),
                "replaces": tpu + replaces, "launches": launches, "max_abs_err": err,
                **{key: m[key] for key in keys},
                **{key: m[key] for key in ("design_bound_ms", "design_bound_by") if key in m}}

    # K1: the bench point's numbers are the bf16 wgmma variant's; `launches`
    # is the f32 engine's (all the f32 wgmma variant's), `wgmma_launches`
    # the bf16 engine's; `f32_wgmma` holds the f32 wgmma variant at the bench
    # point (its launches the f32 engine's, the engine's shape and the
    # accuracy gate beside), `tile_f32` the tile loop on f32 at both shapes
    k1_entry = entry("scores_bmax", "144", launches,
                     max(err_ragged, err_bench, err_f32_index, err_index, err_engine,
                         err_bf16_engine, err_f32, err_serving), k1, "scores_bmax_sm90.cu")
    f32_entry = entry("scores_bmax_f32", "144", launches,
                      max(err_f32_index, err_engine, err_f32, err_serving), f32_bench,
                      "scores_bmax_f32_sm90.cu")
    f32_entry.update(gate=f32_bench["gate"], q256_n8192_d1600=f32_small,
                     index_search_ms=f32_search_ms)
    k1_entry.update(wgmma_launches=wgmma_launches, tile_source=f"{src}scores_bmax.cu",
                    dense_maintenance_launches=maint_launches,
                    engine_verbs_launches=verbs_launches,
                    flagship_serving_launches=serving_launches,
                    f32_wgmma=f32_entry,
                    tile_f32={"q1024_n1048576_d1600": tile_bench,
                              "q256_n8192_d1600": tile_small},
                    tile_bf16={"q1024_n1048576_d250": sign_tile})
    # K2 and K6: the numbers are the wgmma variants' (K2 with f32 scores,
    # its bf16 numbers under `bfloat16`); `wgmma_launches` counts those of
    # the Hopper variant on the path; `tile` holds the tile variants' times
    k2_entry = entry("scores_bmax_int8", "428", k2_launches, k2["err"], k2,
                     "scores_bmax_int8_sm90.cu")
    k2_entry.update(wgmma_launches=k2_wgmma, tile_source=f"{src}scores_bmax_int8.cu",
                    tile=k2["tile"], bfloat16=k2["bfloat16"])
    k6_entry = entry("scores_matmul", "247", k6["launches"], k6["err"], k6,
                     "scores_bmax_sm90.cu")
    k6_f32 = k6["f32_wgmma"]
    k6_entry.update(wgmma_launches=k6["wgmma_launches"], tile_source=f"{src}scores_matmul.cu",
                    tile=k6["tile"], cp_async=k6["cp_async"],
                    f32_wgmma=entry("scores_matmul_f32", "247", k6_f32["launches"],
                                    k6_f32["err"], k6_f32, "scores_bmax_f32_sm90.cu"))
    # the binary and two-stage paths: the two-stage tiers (one search each),
    # binary maintenance and the two-stage engine verbs, per kernel; each
    # kernel's `launches` sums every path it was counted on
    tier_counts = {name: t["launches"] for name, t in tiers.items()}
    new_paths = {"twostage_tiers": {}, "binary_maintenance": bin_path,
                 "twostage_engine_verbs": ts_verbs, "pretrain_serving": pretrain_counts,
                 "session_trainer_serving": st_counts, "finetuned_sign": ft_counts["sign"],
                 "finetuned_packed": ft_counts["packed"], **cli_counts, **sharded_paths,
                 "data_parallel_dryrun": dp_counts, **soak_paths,
                 "example_flagship_serving": fs_counts, "example_flagship_train": train_counts,
                 "example_index_build_100k": ib_counts, "example_maintenance_bench": mb_counts,
                 "example_embed_pipeline_probe": ep_counts,
                 "example_quality_protocol": qp_counts, "example_binary_quality": bq_counts,
                 "example_knn_pairings": kp_counts,
                 "example_generalization_benchmark": gb_counts,
                 "example_incatalog_benchmark": ic_counts}
    for counts in tier_counts.values():
        new_paths["twostage_tiers"] = add_counts(new_paths["twostage_tiers"], counts)
    new_paths["binary_sign"] = sign_path
    new_paths["binary_packed_1600"] = packed_1600_path
    for key, entry_ in (("k1", k1_entry), ("k2", k2_entry)):
        by_path = {path: c.get(key, 0) for path, c in new_paths.items()}
        entry_["launches_by_path"] = {"earlier_paths": entry_["launches"], **by_path,
                                      "wgmma": {path: c.get(key + "_wgmma", 0)
                                                for path, c in new_paths.items()}}
        if key == "k1":
            entry_["launches_by_path"]["cp_async"] = {path: c["k1_cp"]
                                                      for path, c in new_paths.items()}
        entry_["launches"] += sum(by_path.values())
    k1_entry["max_abs_err"] = max(k1_entry["max_abs_err"], err_tiers, err_sharded, err_soak,
                                  fs_errs["k1_bf16"], fs_errs["k1_pca64"], mb_err)
    f32_entry["max_abs_err"] = max(f32_entry["max_abs_err"], ib_err, qp_err, bq_err, kp_err,
                                   gb_err, ic_err)
    k2_entry["max_abs_err"] = max(k2_entry["max_abs_err"], fs_errs["k2"])
    k1_entry["sharded_serving"] = sharded
    k1_entry["data_parallel"] = dp_summary
    k1_entry["serving_soak"] = soak
    k1_entry["training_runs"] = {"campaign": campaign, "training_soak": training_soak}
    k1_entry["operational_scripts"] = {
        "flagship_serving": fs_summary, "flagship_train": train_summary,
        "index_build_100k": ib_summary, "maintenance_bench": mb_summary,
        "embed_pipeline_probe": ep_summary, "quality_protocol": qp_summary,
        "binary_quality": bq_summary, "knn_pairings": kp_summary,
        "generalization_benchmark": gb_summary, "incatalog_benchmark": ic_summary}
    # K1's and K6's bf16 kernel fed by cp.async: its launches on the paths
    # whose rows TMA cannot describe (each counted from 0), its times at
    # sign mode's shape, the producer ablation and K6's ragged case beside
    cp_by_path = {path: new_paths[path]["k1_cp"]
                  for path in ("binary_sign", "twostage_tiers", "twostage_engine_verbs",
                               "finetuned_sign", "sharded_twostage", "sharded_binary",
                               "example_flagship_serving", "example_binary_quality")}
    check(all(cp_by_path.values()),
          f"the cp_async variant was not launched on every path of 250-bit rows: {cp_by_path}")
    check(sum(c["k1_cp"] for c in new_paths.values()) == sum(cp_by_path.values()),
          "the cp_async variant was launched on a path of TMA rows")
    cp_entry = entry("scores_bmax_cp", "144", sum(cp_by_path.values()),
                     max(err_ragged_cp, err_tiers, fs_errs["k1_cp_simhash"],
                         fs_errs["k1_cp_itq"], bq_cp_err, max(c["max_abs_err"]
                                                   for c in k6["cp_async"].values())),
                     sign_cp, "scores_bmax_sm90.cu")
    cp_entry.update(producer_source=f"{src}sm90_cp_async.cuh", launches_by_path=cp_by_path,
                    shape="q1024_n1048576_d250", also_replaces=tpu + "247",
                    producer_ablation_d256=sign_cp["producer_ablation_d256"],
                    scores_matmul=k6["cp_async"])
    k4_entry = entry("packed_scores_bmax", "863", k4_launches, max(k4["err"], fs_errs["k4"]),
                     k4)
    k4_by_path = {path: c["k4"] for path, c in new_paths.items()}
    k4_entry["launches_by_path"] = {"twostage_engine": k4_launches, **k4_by_path}
    k4_entry["launches"] += sum(k4_by_path.values())
    k4_entry["twostage_tiers"] = tiers
    # K5: the numbers are the wgmma variant's; `popc` holds the popc
    # variant's time in the same rounds and its design's bound
    k5_entry = entry("hamming_bucket_min", "619", k5["launches"], k5["err"], k5,
                     "hamming_bucket_min_sm90.cu")
    k5_entry.update({key: k5[key] for key in ("wgmma_launches", "popc", "cases",
                                              "k4_ms_same_rounds", "hamming_topk_ms",
                                              f"w{WIDE_WORDS}")},
                    also_replaces=tpu + "651")
    k4_entry[f"b{WIDE_BITS}"] = k5[f"k4_b{WIDE_BITS}"]  # timed in K5's rounds
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        k1_entry,
        cp_entry,
        k4_entry,
        k5_entry,
        k2_entry,
        entry("bucket_max", "56", k3["launches"], k3["err"], k3),
        k6_entry,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
